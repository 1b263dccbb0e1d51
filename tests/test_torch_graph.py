"""The port's ComputationGraph (``nn/conf/graph_conf.py``, ``nn/graph.py``),
its zip, the ``MultiDataSet`` iterators and graph serving, held against
the JAX package's on the CPU.

Tolerances, float32 on both sides:
* configurations, topological orders and zips: exact (equal dicts, equal
  lists, equal bytes);
* a vertex's forward: rtol = atol = 1e-6 (the same elementwise float32
  arithmetic; the L2 vertices sum a row in another order);
* the multi-input, multi-output graph under Adam: the rule of
  ``tests/test_torch_fit.py`` for Adam (scores rtol 1e-3, at least 99.5 %
  of each tensor's elements within rtol 1e-4 / atol 1e-5 and every one
  within 5e-3, half of one step of size lr = 0.01), and its first
  gradients rtol 1e-4, atol 1e-6;
* outputs of a graph from the same params: rtol = atol = 1e-5.
Where JAX drops out, its Pallas dropout kernel runs in interpret mode
(``DL4J_PALLAS_DROPOUT=1``) and the port takes JAX's seed words for each
vertex, ``_dropout_seed(fold_in(sub, vi))`` with ``vi`` the vertex's index
in the topological order.
"""

import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf.graph_conf as jax_gc
import deeplearning4j_tpu.nn.conf.layers as jax_layers
import deeplearning4j_tpu.nn.conf.preprocessors as jax_pp
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.datasets.iterators import (
    ListMultiDataSetIterator as JaxListMDS)
from deeplearning4j_tpu.models import resnet as jax_resnet
from deeplearning4j_tpu.nn import serialization as jax_ser
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.network import GlobalConf as JaxGlobalConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu.server.gateway import (
    DeepLearning4jEntryPoint as JaxEntryPoint)
from deeplearning4j_tpu_torch.datasets import (
    AsyncMultiDataSetIterator, DataSet, ListDataSetIterator,
    ListMultiDataSetIterator, MultiDataSet)
from deeplearning4j_tpu_torch.datasets.iterators import stage_batch
from deeplearning4j_tpu_torch.models import resnet18, resnet50
from deeplearning4j_tpu_torch.nn import serialization as ser
from deeplearning4j_tpu_torch.nn.conf import graph_conf as gc
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf import preprocessors as pp
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.network import GlobalConf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.server import DeepLearning4jEntryPoint

VERTEX_TOL = 1e-6
OUT_TOL = 1e-5
FIT_RTOL, FIT_ATOL = 1e-4, 1e-5
ADAM_INSIDE, ADAM_ATOL, ADAM_SCORE_RTOL = 0.995, 5e-3, 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conf_dict(conf):
    return json.loads(conf.to_json())


# ---------------------------------------------------------------------------
# Configuration and topological order
# ---------------------------------------------------------------------------

def _flatten_conf(gcm, layers, inputs_cls, global_cls):
    """A conf whose dense layers read CNN activations, so the builder
    inserts ``-cnn2ff`` flatten vertices: conv -> (dense, dense) -> merge
    -> output."""
    b = (gcm.GraphBuilder(global_cls(seed=3, weight_init="relu"))
         .add_inputs("img")
         .add_layer("conv", layers.ConvolutionLayer(
             n_out=4, kernel=(3, 3), activation="relu"), "img")
         .add_layer("zdense", layers.DenseLayer(n_out=6, activation="tanh"),
                    "conv")
         .add_layer("adense", layers.DenseLayer(n_out=5, activation="relu"),
                    "conv")
         .add_vertex("merge", gcm.MergeVertex(), "zdense", "adense")
         .add_layer("out", layers.OutputLayer(n_out=3, activation="softmax",
                                              loss="mcxent"), "merge")
         .set_outputs("out")
         .set_input_types(inputs_cls.convolutional(8, 8, 2)))
    return b.build()


@pytest.mark.parametrize("which", ["resnet50", "resnet18", "cnn2ff"])
def test_configuration_and_order_match_jax(which):
    """The port builds the JAX package's configuration dict, and reads
    JAX's back to the same dict; the topological order is JAX's, names
    of auto-inserted flatten vertices included."""
    if which == "resnet50":
        jconf, conf = jax_resnet.resnet50().conf, resnet50(device="cpu").conf
    elif which == "resnet18":
        jconf, conf = jax_resnet.resnet18().conf, resnet18(device="cpu").conf
    else:
        jconf = _flatten_conf(jax_gc, jax_layers, JaxInputType,
                              JaxGlobalConf)
        conf = _flatten_conf(gc, L, InputType, GlobalConf)
        assert {"zdense-cnn2ff", "adense-cnn2ff"} <= set(conf.vertices)
    assert _conf_dict(conf) == _conf_dict(jconf)
    back = gc.ComputationGraphConfiguration.from_json(jconf.to_json())
    assert _conf_dict(back) == _conf_dict(jconf)
    assert conf.topological_order() == jconf.topological_order()
    assert back.topological_order() == jconf.topological_order()


def test_yaml_round_trip():
    yaml = pytest.importorskip("yaml")
    conf = resnet18(device="cpu").conf
    back = gc.ComputationGraphConfiguration.from_yaml(conf.to_yaml())
    assert _conf_dict(back) == _conf_dict(conf)
    assert yaml.safe_load(conf.to_yaml()) == yaml.safe_load(
        jax_resnet.resnet18().conf.to_yaml())


def _random_dag(rng, gcm, global_cls):
    """A random DAG of Scale vertices with random names, inserted in a
    random order; each reads one to three earlier vertices or inputs."""
    names = [f"v{rng.integers(0, 10**6):06d}" for _ in range(20)]
    ins = {}
    for i, n in enumerate(names):
        pool = ["in0", "in1"] + names[:i]
        k = int(rng.integers(1, 4))
        ins[n] = [pool[j] for j in rng.choice(len(pool), size=min(k, len(pool)),
                                              replace=False)]
    order = list(rng.permutation(len(names)))
    return gcm.ComputationGraphConfiguration(
        network_inputs=["in0", "in1"], network_outputs=[names[-1]],
        vertices={names[i]: gcm.ScaleVertex(scale=1.0) for i in order},
        vertex_inputs={names[i]: ins[names[i]] for i in order},
        global_conf=global_cls())


@pytest.mark.parametrize("seed", range(6))
def test_random_dag_order_matches_jax(seed):
    conf = _random_dag(np.random.default_rng(seed), gc, GlobalConf)
    jconf = _random_dag(np.random.default_rng(seed), jax_gc, JaxGlobalConf)
    assert conf.topological_order() == jconf.topological_order()


def test_cycle_raises():
    conf = gc.ComputationGraphConfiguration(
        network_inputs=["in"], network_outputs=["a"],
        vertices={"a": gc.ScaleVertex(), "b": gc.ScaleVertex()},
        vertex_inputs={"a": ["b"], "b": ["a"]}, global_conf=GlobalConf())
    with pytest.raises(ValueError, match="Cycle"):
        conf.topological_order()


# ---------------------------------------------------------------------------
# Vertices
# ---------------------------------------------------------------------------

def _vertex_cases(rng):
    """name -> (port vertex, JAX vertex, inputs, masks, params)."""
    f32 = np.float32
    ff = [rng.normal(size=(4, 6)).astype(f32) for _ in range(3)]
    seq = [rng.normal(size=(4, 5, 6)).astype(f32) for _ in range(2)]
    cnn = [rng.normal(size=(4, 3, 5, 5)).astype(f32) for _ in range(2)]
    smask = (np.arange(5)[None] < rng.integers(1, 6, 4)[:, None]).astype(f32)
    dense_p = {"W": rng.normal(size=(6, 3)).astype(f32),
               "b": rng.normal(size=3).astype(f32)}

    def both(name, *args, **kw):
        return getattr(gc, name)(*args, **kw), getattr(jax_gc, name)(*args,
                                                                     **kw)
    cases = {}
    for op in ("add", "subtract", "product", "average", "max"):
        cases[f"ElementWise_{op}"] = (*both("ElementWiseVertex", op=op), ff,
                                      None, {})
    cases["Merge_ff"] = (*both("MergeVertex"), ff, None, {})
    cases["Merge_cnn"] = (*both("MergeVertex"), cnn, None, {})
    cases["Merge_rnn_masked"] = (*both("MergeVertex"), seq, [smask, None], {})
    cases["Stack_masked"] = (*both("StackVertex"), seq, [smask, None], {})
    cases["Stack"] = (*both("StackVertex"), ff, None, {})
    cases["Unstack_masked"] = (*both("UnstackVertex", from_idx=1,
                                     stack_size=2), seq[:1], [smask], {})
    cases["Subset_ff"] = (*both("SubsetVertex", from_idx=1, to_idx=3),
                          ff[:1], None, {})
    cases["Subset_rnn"] = (*both("SubsetVertex", from_idx=2, to_idx=4),
                           seq[:1], [smask], {})
    cases["Subset_cnn"] = (*both("SubsetVertex", from_idx=0, to_idx=1),
                           cnn[:1], None, {})
    cases["Scale"] = (*both("ScaleVertex", scale=-2.5), ff[:1], None, {})
    cases["Shift"] = (*both("ShiftVertex", shift=0.75), seq[:1], [smask], {})
    cases["L2"] = (*both("L2Vertex"), cnn, None, {})
    cases["L2Normalize"] = (*both("L2NormalizeVertex"), cnn[:1], None, {})
    cases["Preprocessor"] = (
        gc.PreprocessorVertex.of(pp.CnnToFeedForwardPreProcessor(5, 5, 3)),
        jax_gc.PreprocessorVertex.of(
            jax_pp.CnnToFeedForwardPreProcessor(5, 5, 3)), cnn[:1], None, {})
    cases["LastTimeStep"] = (*both("LastTimeStepVertex"), seq[:1], None, {})
    cases["LastTimeStep_masked"] = (*both("LastTimeStepVertex"), seq[:1],
                                    [smask], {})
    cases["DuplicateToTimeSeries"] = (*both("DuplicateToTimeSeriesVertex"),
                                      [ff[0], seq[0]], [None, smask], {})
    cases["Reshape"] = (*both("ReshapeVertex", shape=(3, 25)), cnn[:1], None,
                        {})
    cases["Reshape_cnn"] = (*both("ReshapeVertex", shape=(1, 5, 15)),
                            cnn[:1], None, {})
    cases["Layer_dense"] = (
        gc.LayerVertex.of(L.DenseLayer(n_in=6, n_out=3, activation="tanh")),
        jax_gc.LayerVertex.of(jax_layers.DenseLayer(n_in=6, n_out=3,
                                                    activation="tanh")),
        ff[:1], None, dense_p)
    return cases


_CASES = sorted(_vertex_cases(np.random.default_rng(0)))


@pytest.mark.parametrize("case", _CASES)
def test_vertex_forward_matches_jax(case):
    """Each vertex's forward (and output mask) against JAX's on the same
    seeded inputs; its output type and JSON as JAX's."""
    v, jv, xs, masks, params = _vertex_cases(np.random.default_rng(0))[case]
    y, _, m = v.forward({k: torch.from_numpy(a) for k, a in params.items()},
                        {}, [torch.from_numpy(x) for x in xs], False, None,
                        None if masks is None else
                        [None if a is None else torch.from_numpy(a)
                         for a in masks])
    jy, _, jm = jv.forward({k: jnp.asarray(a) for k, a in params.items()},
                           {}, [jnp.asarray(x) for x in xs], train=False,
                           rng=None, masks=None if masks is None else
                           [None if a is None else jnp.asarray(a)
                            for a in masks])
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=VERTEX_TOL,
                               atol=VERTEX_TOL)
    assert (m is None) == (jm is None)
    if m is not None:
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert v.to_dict() == jv.to_dict()
    types = [InputType.recurrent(x.shape[2], x.shape[1]) if x.ndim == 3
             else InputType.convolutional(x.shape[2], x.shape[3], x.shape[1])
             if x.ndim == 4 else InputType.feed_forward(x.shape[1])
             for x in xs]
    jtypes = [JaxInputType(**t.to_dict()) for t in types]
    assert v.output_type(types).to_dict() == jv.output_type(jtypes).to_dict()


def test_every_vertex_class_is_ported():
    assert set(gc.VERTEX_REGISTRY) == set(jax_gc.VERTEX_REGISTRY)
    covered = {type(c[0]).__name__ for c in
               _vertex_cases(np.random.default_rng(0)).values()}
    assert covered == set(gc.VERTEX_REGISTRY)


# ---------------------------------------------------------------------------
# A multi-input, multi-output graph: output, gradients, Adam fit
# ---------------------------------------------------------------------------

def _multi_conf(gcm, layers, global_cls):
    """Two inputs, two loss heads: Dense(a) [drops its input] and
    Dense(b) merged and added, a Subset of the merge to a softmax head
    (which drops its input) and a Scale of the sum to an MSE head."""
    g = global_cls(seed=5, learning_rate=0.01, updater="adam",
                   weight_init="xavier", pipeline_workers=0)
    return (gcm.GraphBuilder(g).add_inputs("a", "b")
            .add_layer("da", layers.DenseLayer(n_in=12, n_out=16,
                                               activation="relu",
                                               dropout=0.5), "a")
            .add_layer("db", layers.DenseLayer(n_in=8, n_out=16,
                                               activation="tanh"), "b")
            .add_vertex("merge", gcm.MergeVertex(), "da", "db")
            .add_vertex("sum", gcm.ElementWiseVertex(op="add"), "da", "db")
            .add_vertex("sub", gcm.SubsetVertex(from_idx=4, to_idx=27),
                        "merge")
            .add_vertex("half", gcm.ScaleVertex(scale=0.5), "sum")
            .add_layer("cls", layers.OutputLayer(
                n_in=24, n_out=5, activation="softmax", loss="mcxent",
                dropout=0.5), "sub")
            .add_layer("reg", layers.OutputLayer(
                n_in=16, n_out=3, activation="identity", loss="mse"), "half")
            .set_outputs("cls", "reg").build())


def _numpy_params(net, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for n in net.order:
        out[n] = {}
        for k, v in net.net_params[n].items():
            shape = tuple(v.shape)
            scale = (np.sqrt(2.0 / (np.prod(shape[1:]) if len(shape) == 4
                                    else shape[0])) if k == "W" else 0.1)
            out[n][k] = (rng.normal(size=shape) * scale).astype(np.float32)
    return out


def _pair(conf, jconf, seed=1):
    net = ComputationGraph(conf, device="cpu").init()
    params = _numpy_params(net, seed)
    net.load_jax_params(params)
    jnet = JaxGraph(jconf).init(
        params={n: {k: jnp.asarray(v) for k, v in lp.items()}
                for n, lp in params.items()})
    return net, jnet


def _multi_batch(rng, n=512):
    f32 = np.float32
    return ([rng.normal(size=(n, 12)).astype(f32),
             rng.normal(size=(n, 8)).astype(f32)],
            [np.eye(5, dtype=f32)[rng.integers(0, 5, n)],
             rng.normal(size=(n, 3)).astype(f32)])


def jax_step_seeds(jnet):
    """JAX's dropout seed words of its next step, one row per vertex in
    topological order."""
    _, sub = jax.random.split(jnet._key)
    return np.stack([np.asarray(pk._dropout_seed(jax.random.fold_in(sub, vi))
                                ).reshape(-1)
                     for vi in range(len(jnet.order))])


def test_multi_io_graph_output_matches_jax():
    net, jnet = _pair(_multi_conf(gc, L, GlobalConf),
                      _multi_conf(jax_gc, jax_layers, JaxGlobalConf))
    xs, _ = _multi_batch(np.random.default_rng(3), 16)
    outs, jouts = net.output(*xs), jnet.output(*xs)
    assert len(outs) == len(jouts) == 2
    for o, jo in zip(outs, jouts):
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=OUT_TOL,
                                   atol=OUT_TOL)


def test_multi_io_graph_adam_fit_matches_jax(monkeypatch):
    """Adam, 3 steps with JAX's dropout kernel forced and its seed words
    per vertex handed to the port: the first step's gradients, the score
    after every step and the params after the last."""
    monkeypatch.setenv("DL4J_PALLAS_DROPOUT", "1")
    net, jnet = _pair(_multi_conf(gc, L, GlobalConf),
                      _multi_conf(jax_gc, jax_layers, JaxGlobalConf))
    rng = np.random.default_rng(4)
    batches = [_multi_batch(rng) for _ in range(3)]
    seeds = jax_step_seeds(jnet)
    _, sub = jax.random.split(jnet._key)
    _, _, jgrads = jnet._build_grad_raw()(
        jnet.net_params, jnet.net_state,
        tuple(jnp.asarray(x) for x in batches[0][0]),
        tuple(jnp.asarray(y) for y in batches[0][1]), None, None, sub)
    _, grads = net._grad_step(net._inputs(batches[0][0]),
                              [torch.from_numpy(y) for y in batches[0][1]],
                              None, None, seeds.tolist())
    for n in net.order:
        assert sorted(grads[n]) == sorted(jgrads[n])
        for k in jgrads[n]:
            np.testing.assert_allclose(grads[n][k].numpy(),
                                       np.asarray(jgrads[n][k]),
                                       rtol=FIT_RTOL, atol=1e-6)
    for xs, ys in batches:
        seeds = jax_step_seeds(jnet)
        net._fit_batch(MultiDataSet(xs, ys), seeds=seeds)
        jnet.fit(JaxMDS(xs, ys))
        np.testing.assert_allclose(net.score(), float(jnet.score()),
                                   rtol=ADAM_SCORE_RTOL)
    for n in net.order:
        for k in jnet.net_params[n]:
            got = net.net_params[n][k].numpy()
            want = np.asarray(jnet.net_params[n][k])
            ok = np.abs(got - want) <= FIT_ATOL + FIT_RTOL * np.abs(want)
            assert ok.mean() >= ADAM_INSIDE, (n, k, ok.mean())
            np.testing.assert_allclose(got, want, rtol=0, atol=ADAM_ATOL)
    np.testing.assert_allclose(net.updater_state_flat().numpy(),
                               np.asarray(jnet.updater_state_flat()),
                               rtol=1e-3, atol=1e-6)
    assert net.iteration == jnet.iteration == 3


def test_score_and_score_examples_match_jax():
    net, jnet = _pair(_multi_conf(gc, L, GlobalConf),
                      _multi_conf(jax_gc, jax_layers, JaxGlobalConf))
    xs, ys = _multi_batch(np.random.default_rng(7), 32)
    np.testing.assert_allclose(net.score(MultiDataSet(xs, ys)),
                               jnet.score(JaxMDS(xs, ys)), rtol=FIT_RTOL)
    for reg in (False, True):
        np.testing.assert_allclose(
            net.score_examples(MultiDataSet(xs, ys), reg),
            np.asarray(jnet.score_examples(JaxMDS(xs, ys), reg)),
            rtol=FIT_RTOL, atol=1e-6)


def test_evaluate_matches_jax():
    net, jnet = _pair(_multi_conf(gc, L, GlobalConf),
                      _multi_conf(jax_gc, jax_layers, JaxGlobalConf))
    rng = np.random.default_rng(8)
    data = [_multi_batch(rng, 40) for _ in range(3)]
    ev = net.evaluate(ListMultiDataSetIterator(
        [MultiDataSet(x, y) for x, y in data]))
    jev = jnet.evaluate(JaxListMDS([JaxMDS(x, y) for x, y in data]))
    assert ev.accuracy() == pytest.approx(jev.accuracy())
    np.testing.assert_array_equal(ev.confusion.matrix, jev.confusion.matrix)


def test_params_flatten_in_topological_order():
    net, jnet = _pair(_multi_conf(gc, L, GlobalConf),
                      _multi_conf(jax_gc, jax_layers, JaxGlobalConf))
    flat = net.params().numpy()
    np.testing.assert_array_equal(flat, np.asarray(jnet.params()))
    assert net.num_params() == jnet.num_params() == flat.size
    net.set_params(flat[::-1].copy())
    np.testing.assert_array_equal(net.params().numpy(), flat[::-1])


def test_fit_needs_an_output_layer():
    conf = (gc.GraphBuilder(GlobalConf()).add_inputs("in")
            .add_layer("d", L.DenseLayer(n_in=3, n_out=2), "in")
            .set_outputs("d").build())
    net = ComputationGraph(conf, device="cpu").init()
    with pytest.raises(ValueError, match="output layer"):
        net.fit(np.zeros((2, 3), np.float32), np.zeros((2, 2), np.float32))


# ---------------------------------------------------------------------------
# Zips both ways
# ---------------------------------------------------------------------------

def _zip_entries(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def test_jax_written_graph_zip_restores_and_rewrites_byte_for_byte(tmp_path):
    """A zip JAX wrote after two Adam steps restores in the port (outputs
    as JAX's) and re-writing it gives the same coefficients.bin and
    updaterState.bin, and the same configuration."""
    jnet = JaxGraph(_multi_conf(jax_gc, jax_layers, JaxGlobalConf)).init()
    rng = np.random.default_rng(9)
    for _ in range(2):
        jnet.fit(JaxMDS(*_multi_batch(rng, 32)))
    jpath, path = tmp_path / "jax.zip", tmp_path / "port.zip"
    jax_ser.write_model(jnet, jpath)
    net = ser.load_model(jpath, device="cpu")
    assert isinstance(net, ComputationGraph)
    xs, _ = _multi_batch(rng, 8)
    for o, jo in zip(net.output(*xs), jnet.output(*xs)):
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=OUT_TOL,
                                   atol=OUT_TOL)
    ser.write_model(net, path)
    want, got = _zip_entries(jpath), _zip_entries(path)
    for name in (ser.COEFFICIENTS_NAME, ser.UPDATER_NAME):
        assert got[name] == want[name]
    assert json.loads(got[ser.CONFIG_NAME]) == json.loads(
        want[ser.CONFIG_NAME])


def test_port_written_graph_zip_restores_in_jax(tmp_path):
    net = ComputationGraph(_multi_conf(gc, L, GlobalConf), device="cpu").init()
    rng = np.random.default_rng(10)
    net.fit(MultiDataSet(*_multi_batch(rng, 32)))
    path = tmp_path / "port.zip"
    ser.write_model(net, path)
    jnet = jax_ser.load_model(path)
    assert isinstance(jnet, JaxGraph)
    np.testing.assert_array_equal(np.asarray(jnet.params()),
                                  net.params().numpy())
    np.testing.assert_array_equal(np.asarray(jnet.updater_state_flat()),
                                  net.updater_state_flat().numpy())
    again = ser.restore_computation_graph(path, device="cpu")
    np.testing.assert_array_equal(again.updater_state_flat().numpy(),
                                  net.updater_state_flat().numpy())


def test_java_graph_zip_raises(tmp_path):
    """A zip in the Java DL4J's graph schema goes to the migration
    (nn/dl4j_migration.py), which raises on an empty ``coefficients.bin``
    instead of reading it as this package's float32 vector."""
    p = tmp_path / "java.zip"
    with zipfile.ZipFile(p, "w") as zf:
        zf.writestr(ser.CONFIG_NAME, json.dumps(
            {"networkInputs": ["in"], "vertices": {}}))
        zf.writestr(ser.COEFFICIENTS_NAME, b"")
    with pytest.raises(ValueError, match="truncated nd4j"):
        ser.load_model(p, device="cpu")


# ---------------------------------------------------------------------------
# MultiDataSet iterators (the cases of tests/test_input_pipeline.py)
# ---------------------------------------------------------------------------

def _ds_batches(n=4, rows=6, cols=4, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        f = rng.normal(size=(rows, cols)).astype(np.float32)
        f[0, 0] = i  # batch identity marker
        out.append(DataSet(f, np.eye(3, dtype=np.float32)[
            rng.integers(0, 3, rows)]))
    return out


def _small_graph(workers, gcm=gc, layers=L, global_cls=GlobalConf):
    g = global_cls(seed=7, learning_rate=0.05, updater="adam",
                   pipeline_workers=workers, pipeline_prefetch=3)
    conf = (gcm.GraphBuilder(g).add_inputs("in")
            .add_layer("d", layers.DenseLayer(n_in=4, n_out=8,
                                              activation="relu"), "in")
            .add_layer("out", layers.OutputLayer(n_in=8, n_out=3,
                                                 activation="softmax",
                                                 loss="mcxent"), "d")
            .set_outputs("out").build())
    return conf


def test_cg_fit_parity_and_dataset_conversion():
    """``fit`` over a DataSet or MultiDataSet iterator, with 0 or 2
    pipeline workers, gives the same score, equal to JAX's."""
    batches = _ds_batches()
    mds = [MultiDataSet([d.features], [d.labels], [None], [None])
           for d in batches]
    scores = {}
    for w in (0, 2):
        net = ComputationGraph(_small_graph(w), device="cpu").init()
        net.load_jax_params(_numpy_params(net, 2))
        net.fit(ListDataSetIterator(list(batches)), epochs=2)
        scores[w] = net.score()
        net = ComputationGraph(_small_graph(w), device="cpu").init()
        net.load_jax_params(_numpy_params(net, 2))
        net.fit(ListMultiDataSetIterator(list(mds)), epochs=2)
        scores[f"m{w}"] = net.score()
        assert net.epoch == 2 and net.iteration == 8
    assert scores[0] == scores[2] == scores["m0"] == scores["m2"], scores
    jconf = _small_graph(0, jax_gc, jax_layers, JaxGlobalConf)
    jnet = JaxGraph(jconf).init(params={
        n: {k: jnp.asarray(v) for k, v in lp.items()}
        for n, lp in _numpy_params(net, 2).items()})
    jnet.fit(JaxListMDS([JaxMDS(m.features, m.labels, [None], [None])
                         for m in mds]), epochs=2)
    np.testing.assert_allclose(scores[0], float(jnet.score()),
                               rtol=ADAM_SCORE_RTOL)


def test_cg_fit_accepts_plain_iterable():
    class PlainIterable:  # only __iter__ / reset, no has_next / next
        def __init__(self, items):
            self._items = items

        def __iter__(self):
            return iter(self._items)

        def reset(self):
            pass

    mds = [MultiDataSet([d.features], [d.labels], [None], [None])
           for d in _ds_batches(n=3)]
    net = ComputationGraph(_small_graph(0), device="cpu").init()
    net.fit(PlainIterable(mds), epochs=2)
    assert np.isfinite(net.score()) and net.iteration == 6


def test_async_multi_iterator_keeps_order_and_stages():
    """The async MultiDataSet pipeline hands the batches over in order,
    every array staged onto the device and None masks kept None."""
    mds = [MultiDataSet([d.features, d.features * 2], [d.labels],
                        [None, None], None) for d in _ds_batches(n=7)]
    it = AsyncMultiDataSetIterator(ListMultiDataSetIterator(mds), workers=3,
                                   device="cpu")
    got = []
    while it.has_next():
        got.append(it.next())
    it.close()
    assert [int(m.features[0][0, 0]) for m in got] == list(range(7))
    for m, want in zip(got, mds):
        assert all(isinstance(f, torch.Tensor) for f in m.features)
        np.testing.assert_array_equal(m.features[1].numpy(),
                                      want.features[1])
        assert m.features_masks == [None, None] and m.labels_masks is None
    assert it.batch_size() == 0
    staged = stage_batch(mds[0], torch.device("cpu"))
    np.testing.assert_array_equal(staged.labels[0].numpy(), mds[0].labels[0])


def test_list_multi_iterator_protocol():
    mds = [MultiDataSet([d.features], [d.labels]) for d in _ds_batches(n=3)]
    it = ListMultiDataSetIterator(mds)
    assert [int(m.features[0][0, 0]) for m in it] == [0, 1, 2]
    assert not it.has_next()
    it.reset()
    assert it.has_next() and it.next() is mds[0]
    assert mds[0].num_examples() == 6
    wrapped = MultiDataSet.of(DataSet(mds[0].features[0], mds[0].labels[0]))
    assert wrapped.features_masks == [None] and wrapped.labels_masks == [None]


# ---------------------------------------------------------------------------
# Serving a graph zip
# ---------------------------------------------------------------------------

def test_gateway_predict_on_graph_zip_matches_jax(tmp_path):
    """``predict`` serves a graph zip's first output, as JAX's gateway
    does: probabilities and classes, coalesced and not."""
    net = resnet18(16, 16, 3, 10, device="cpu").init(
        generator=torch.Generator().manual_seed(4))
    path = str(tmp_path / "resnet18.zip")
    ser.write_model(net, path)
    x = np.random.default_rng(11).normal(size=(3, 3, 16, 16)).astype(
        np.float32)
    jax_ep = JaxEntryPoint(max_batch=4)
    try:
        want = jax_ep.predict(path, features=x.tolist())
        want_cls = jax_ep.predict(path, features=x.tolist(), argmax_only=True)
    finally:
        jax_ep.close()
    ep = DeepLearning4jEntryPoint(device="cpu", max_batch=4)
    try:
        for coalesce in (True, False):
            got = ep.predict(path, features=x.tolist(), coalesce=coalesce)
            np.testing.assert_allclose(np.asarray(got["predictions"]),
                                       np.asarray(want["predictions"]),
                                       rtol=OUT_TOL, atol=OUT_TOL)
            assert ep.predict(path, features=x.tolist(), argmax_only=True,
                              coalesce=coalesce) == want_cls
        warm = ep.model_cache.stats()["models"]
        assert [m["warmup"]["buckets"] for m in warm.values()] == [[1, 2, 4]]
    finally:
        ep.close()
