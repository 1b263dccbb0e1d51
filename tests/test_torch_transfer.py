"""The port's transfer learning (``nn/transferlearning.py``), its frozen
layers (``FrozenLayerConf``) on both engines, and the engine methods they
use (``feed_forward``, ``clone``, ``summary``, ``param_table``), held
against the JAX package on the CPU.

Every JAX builder test (``tests/test_transfer_graph.py``,
``tests/test_earlystopping_transfer.py``) is mirrored: both builders edit
the same source network, their layer lists must be equal and the weights
they keep equal to the source's.  New layers draw from each package's own
generator, so the port's network then takes the JAX network's params
(``load_jax_params``) before both train on the same batches.

Tolerances, float32 on both sides with sums in other orders:
* configurations, kept weights, frozen params and frozen batch-norm
  statistics: exact;
* outputs, features and feed-forward activations: rtol = atol = 1e-5;
* scores and params after ``fit``: the rules of ``tests/test_torch_fit.py``
  for the updater: SGD and Nesterovs rtol 1e-4 / atol 1e-5 on every
  element and the score; Adam at least 99.5 % of each tensor's elements
  within that, every one within 5e-3, the score rtol 1e-3.
Dropout stays out of the nets held against JAX (JAX's dense masks cannot
be drawn in torch); a frozen layer's forward is shown to ignore
``train`` instead.
"""

import json
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf.graph_conf as jax_gc
import deeplearning4j_tpu.nn.conf.layers as jax_layers
import deeplearning4j_tpu.nn.conf.network as jax_network
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.fetchers import load_iris as jax_load_iris
from deeplearning4j_tpu.datasets.iterators import (
    ListDataSetIterator as JaxListIterator)
from deeplearning4j_tpu.datasets.normalizers import (
    NormalizerStandardize as JaxStandardize)
from deeplearning4j_tpu.nn import serialization as jax_ser
from deeplearning4j_tpu.nn import transferlearning as jax_tl
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn import serialization as ser
from deeplearning4j_tpu_torch.nn import transferlearning as tl
from deeplearning4j_tpu_torch.nn.conf import graph_conf as gc
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf import network
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

OUT_TOL = 1e-5
FIT_RTOL, FIT_ATOL = 1e-4, 1e-5
ADAM_INSIDE, ADAM_ATOL, ADAM_SCORE_RTOL = 0.995, 5e-3, 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Shared helpers (the listener, early-stopping and checkpoint tests import
# them)
# ---------------------------------------------------------------------------

def np_tree(tree):
    """A JAX params / state tree (list or dict of dicts) as numpy."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(np_tree(v) for v in tree)
    return np.asarray(tree)


def port_of(jnet):
    """The port's network (on the CPU) of a JAX network: its
    configuration through JSON, its params and its layer state."""
    if isinstance(jnet, JaxGraph):
        conf = gc.ComputationGraphConfiguration.from_json(jnet.conf.to_json())
        net = ComputationGraph(conf, device="cpu").init()
    else:
        conf = network.MultiLayerConfiguration.from_json(jnet.conf.to_json())
        net = MultiLayerNetwork(conf, device="cpu").init()
    net.load_jax_params(np_tree(jnet.net_params))
    net.load_jax_state(np_tree(jnet.net_state))
    return net


def _entries(net, tree):
    return list(tree.items()) if isinstance(net, ComputationGraph) \
        else list(enumerate(tree))


def assert_params_close(net, jnet, adam=False, skip=()):
    """Every param of the port's ``net`` against JAX's ``jnet`` by the
    updater's rule (module docstring), except the entries in ``skip``."""
    jparams = jnet.net_params
    for key, lp in _entries(net, net.net_params):
        if key in skip:
            continue
        for k, t in lp.items():
            got, want = t.detach().cpu().numpy(), np.asarray(jparams[key][k])
            msg = f"{key} {k}"
            if not adam:
                np.testing.assert_allclose(got, want, rtol=FIT_RTOL,
                                           atol=FIT_ATOL, err_msg=msg)
                continue
            ok = np.abs(got - want) <= FIT_ATOL + FIT_RTOL * np.abs(want)
            assert ok.mean() >= ADAM_INSIDE, (msg, ok.mean())
            np.testing.assert_allclose(got, want, rtol=0, atol=ADAM_ATOL,
                                       err_msg=msg)


def iris_data():
    """The JAX tests' iris set: shuffled with seed 0 and standardized."""
    ds = jax_load_iris().shuffle(0)
    ds = JaxStandardize().fit(ds).transform(ds)
    return np.asarray(ds.features), np.asarray(ds.labels)


def iris_net(lr=0.05, updater="adam"):
    """JAX's iris net of ``tests/test_earlystopping_transfer.py``."""
    conf = (jax_network.NeuralNetConfiguration.builder()
            .seed(1).learning_rate(lr).updater(updater)
            .list()
            .layer(jax_layers.DenseLayer(n_in=4, n_out=16, activation="relu"))
            .layer(jax_layers.DenseLayer(n_in=16, n_out=8, activation="relu"))
            .layer(jax_layers.OutputLayer(n_in=8, n_out=3,
                                          activation="softmax",
                                          loss="mcxent"))
            .build())
    return JaxNet(conf).init()


def fit_both(net, jnet, x, y, batch, epochs):
    """``fit`` of both networks over the same batches."""
    jnet.fit(JaxListIterator(JaxDataSet(x, y), batch), epochs=epochs)
    net.fit(ListDataSetIterator(DataSet(x, y), batch), epochs=epochs)


def _layer_dicts(layers):
    return [json.loads(json.dumps(l.to_dict())) for l in layers]


def _graph_vertex_dicts(conf):
    return json.loads(conf.to_json())["vertices"]


# ---------------------------------------------------------------------------
# FrozenLayerConf
# ---------------------------------------------------------------------------

def test_frozen_layer_conf_json_round_trips_both_ways():
    """A FrozenLayerConf's JSON, and a configuration holding frozen
    layers, read and write the same in both packages."""
    inner = jax_layers.ConvolutionLayer(n_out=4, kernel=(3, 3),
                                        activation="relu", l2=1e-3)
    jfrozen = jax_layers.FrozenLayerConf.wrap(inner)
    port = L.Layer.from_dict(jfrozen.to_dict())
    assert isinstance(port, L.FrozenLayerConf)
    assert isinstance(port._inner(), L.ConvolutionLayer)
    assert port.to_dict() == jfrozen.to_dict()
    back = jax_layers.Layer.from_dict(
        L.FrozenLayerConf.wrap(L.Layer.from_dict(inner.to_dict())).to_dict())
    assert back.to_dict() == jfrozen.to_dict()
    jnet = _frozen_mln()
    conf = network.MultiLayerConfiguration.from_json(jnet.conf.to_json())
    assert json.loads(conf.to_json()) == json.loads(jnet.conf.to_json())


def test_frozen_layer_forward_ignores_train():
    """A frozen dense layer with dropout and a frozen batch norm: the
    forward under ``train=True`` is the one under ``train=False``, and the
    batch norm keeps its statistics."""
    dense = L.FrozenLayerConf.wrap(L.DenseLayer(n_in=64, n_out=64,
                                                activation="relu",
                                                dropout=0.5))
    bn = L.FrozenLayerConf.wrap(L.BatchNormalization(n_features=64))
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(128, 64, generator=gen)
    it = InputType.feed_forward(64)
    for layer in (dense, bn):
        params, _ = layer.initialize(gen, it, torch.device("cpu"))
        state = layer.initial_state(it, torch.device("cpu"))
        state = {k: v + 0.5 for k, v in state.items()}
        train, ns, _ = layer.forward(params, state, x, True, [1, 2])
        infer, _, _ = layer.forward(params, state, x, False)
        assert torch.equal(train, infer)
        assert all(ns[k] is state[k] for k in state)
    # unwrapped, the same dense layer drops out in training
    inner = dense._inner()
    params, _ = inner.initialize(gen, it, torch.device("cpu"))
    assert not torch.equal(inner.forward(params, {}, x, True, [1, 2])[0],
                           inner.forward(params, {}, x, False)[0])


def _frozen_mln(updater="nesterovs", freeze=True):
    """A small CNN with its conv block frozen: conv 3x3 (l2 1e-3 on the
    inner layer) and batch norm frozen, then a pool, a dense layer and a
    softmax head that train, under regularization; ``freeze`` off leaves
    every layer trainable."""
    b = (jax_network.NeuralNetConfiguration.builder().seed(3)
         .learning_rate(0.05).updater(updater).weight_init("relu")
         .regularization(True).l2(1e-3).list())
    b.layer(jax_layers.ConvolutionLayer(n_out=4, kernel=(3, 3),
                                        padding=(1, 1), activation="relu"))
    b.layer(jax_layers.BatchNormalization())
    b.layer(jax_layers.SubsamplingLayer(pooling_type="max", kernel=(2, 2),
                                        stride=(2, 2)))
    b.layer(jax_layers.DenseLayer(n_out=16, activation="tanh"))
    b.layer(jax_layers.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
    conf = b.set_input_type(JaxInputType.convolutional(6, 6, 2)).build()
    conf.layers = [jax_layers.FrozenLayerConf.wrap(l) if freeze and i < 2
                   else l for i, l in enumerate(conf.layers)]
    jnet = JaxNet(conf).init()
    rng = np.random.default_rng(4)
    # running statistics away from init, as a trained source would have
    jnet.net_state[1] = {
        "mean": jnp.asarray(0.2 * rng.normal(size=4), jnp.float32),
        "var": jnp.asarray(rng.uniform(0.5, 1.5, 4), jnp.float32)}
    return jnet


def _cnn_batches(n=4, rows=16, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(rows, 2, 6, 6)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, rows)])
            for _ in range(n)]


def test_fine_tune_mln_with_frozen_layers_matches_jax():
    """4 Nesterovs steps of a net with a frozen conv and batch norm: the
    scores and the trained params by the SGD rule, the frozen params and
    statistics untouched (exact) and equal to JAX's; the frozen inner
    layer's l2 adds nothing to the score, as in JAX."""
    jnet = _frozen_mln()
    net = port_of(jnet)
    frozen = [({k: v.clone() for k, v in net.net_params[i].items()},
               {k: v.clone() for k, v in net.net_state[i].items()})
              for i in (0, 1)]
    for x, y in _cnn_batches():
        jnet.fit(x, y)
        net.fit(x, y)
        np.testing.assert_allclose(net.score(), float(jnet.score()),
                                   rtol=FIT_RTOL)
    assert_params_close(net, jnet)
    for i, (p0, s0) in zip((0, 1), frozen):
        for k in p0:
            assert torch.equal(net.net_params[i][k], p0[k])
            np.testing.assert_array_equal(p0[k].numpy(),
                                          np.asarray(jnet.net_params[i][k]))
        for k in s0:
            assert torch.equal(net.net_state[i][k], s0[k])
            np.testing.assert_array_equal(s0[k].numpy(),
                                          np.asarray(jnet.net_state[i][k]))
    assert net.updater_state_flat().numel() == \
        np.asarray(jnet.updater_state_flat()).size
    # the penalty counts the trained dense layers' l2 only
    x, y = _cnn_batches(1, seed=9)[0]
    np.testing.assert_allclose(net.score(DataSet(x, y)),
                               float(jnet.score(JaxDataSet(x, y))),
                               rtol=FIT_RTOL)


def _frozen_graph(updater="nesterovs", freeze=True):
    """A graph: conv (l2 on the inner layer) and batch norm frozen (unless
    ``freeze`` is off), then a pool, a dense layer and a softmax head."""
    g = jax_network.GlobalConf(seed=5, learning_rate=0.05, updater=updater,
                               weight_init="relu", use_regularization=True,
                               l2=1e-3, pipeline_workers=0)
    conf = (jax_gc.GraphBuilder(g).add_inputs("in")
            .set_input_types(JaxInputType.convolutional(6, 6, 2))
            .add_layer("conv", jax_layers.ConvolutionLayer(
                n_out=4, kernel=(3, 3), padding=(1, 1), activation="relu"),
                "in")
            .add_layer("bn", jax_layers.BatchNormalization(), "conv")
            .add_layer("pool", jax_layers.SubsamplingLayer(
                pooling_type="max", kernel=(2, 2), stride=(2, 2)), "bn")
            .add_layer("dense", jax_layers.DenseLayer(n_out=12,
                                                      activation="tanh"),
                       "pool")
            .add_layer("out", jax_layers.OutputLayer(
                n_out=3, activation="softmax", loss="mcxent"), "dense")
            .set_outputs("out").build())
    for name in ("conv", "bn") if freeze else ():
        lc = conf.vertices[name].layer_conf()
        conf.vertices[name] = jax_gc.LayerVertex(
            layer=jax_layers.FrozenLayerConf.wrap(lc).to_dict())
    jnet = JaxGraph(conf).init()
    rng = np.random.default_rng(6)
    jnet.net_state["bn"] = {
        "mean": jnp.asarray(0.2 * rng.normal(size=4), jnp.float32),
        "var": jnp.asarray(rng.uniform(0.5, 1.5, 4), jnp.float32)}
    return jnet


def test_fine_tune_graph_with_frozen_vertices_matches_jax(monkeypatch):
    """The graph counterpart: 4 Nesterovs steps; frozen params and
    statistics exact; the step asks autograd for the trained vertices'
    params only."""
    jnet = _frozen_graph()
    net = port_of(jnet)
    frozen = {n: ({k: v.clone() for k, v in net.net_params[n].items()},
                  {k: v.clone() for k, v in net.net_state[n].items()})
              for n in ("conv", "bn")}
    asked = []
    grad = torch.autograd.grad

    def counting_grad(out, inputs, *a, **kw):
        asked.append(len(inputs))
        return grad(out, inputs, *a, **kw)
    monkeypatch.setattr(torch.autograd, "grad", counting_grad)
    for x, y in _cnn_batches(seed=2):
        jnet.fit(x, y)
        net.fit(x, y)
        np.testing.assert_allclose(net.score(), float(jnet.score()),
                                   rtol=FIT_RTOL)
    assert asked == [4] * 4          # dense W, b and out W, b
    assert_params_close(net, jnet)
    for n, (p0, s0) in frozen.items():
        for k in p0:
            assert torch.equal(net.net_params[n][k], p0[k])
        for k in s0:
            assert torch.equal(net.net_state[n][k], s0[k])
            np.testing.assert_array_equal(s0[k].numpy(),
                                          np.asarray(jnet.net_state[n][k]))


@pytest.mark.parametrize("engine", ["mln", "graph"])
def test_frozen_zip_restores_in_both_packages(engine, tmp_path):
    """A zip of a net with frozen layers, after two steps (so it holds
    updater state), written by either package restores in the other:
    equal params, updater state and ``output()``."""
    jnet = _frozen_mln() if engine == "mln" else _frozen_graph()
    x, y = _cnn_batches(2, seed=3)[0]
    jnet.fit(x, y)
    jnet.fit(x, y)
    jnet.conf.global_conf.pipeline_workers = 0
    jpath, ppath = tmp_path / "jax.zip", tmp_path / "port.zip"
    jax_ser.write_model(jnet, jpath)
    net = ser.load_model(jpath, device="cpu")
    assert type(net).__name__ == type(jnet).__name__
    np.testing.assert_array_equal(net.params().numpy(),
                                  np.asarray(jnet.params()))
    np.testing.assert_array_equal(net.updater_state_flat().numpy(),
                                  np.asarray(jnet.updater_state_flat()))
    net.load_jax_state(np_tree(jnet.net_state))   # a zip holds no state
    out = net.output(x)
    jout = jnet.output(x)
    if engine == "graph":
        out, jout = out[0], jout[0]
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=OUT_TOL,
                               atol=OUT_TOL)
    ser.write_model(net, ppath)
    back = jax_ser.load_model(ppath)
    np.testing.assert_array_equal(np.asarray(back.params()),
                                  np.asarray(jnet.params()))
    np.testing.assert_array_equal(np.asarray(back.updater_state_flat()),
                                  np.asarray(jnet.updater_state_flat()))
    with zipfile.ZipFile(ppath) as a, zipfile.ZipFile(jpath) as b:
        assert json.loads(a.read("configuration.json")) == \
            json.loads(b.read("configuration.json"))


# ---------------------------------------------------------------------------
# The MultiLayerNetwork builder: tests/test_earlystopping_transfer.py
# ---------------------------------------------------------------------------

def _assert_built_alike(new, jnew, src, kept):
    """Equal layer lists; the layers in ``kept`` hold the source's
    weights in both."""
    assert _layer_dicts(new.layers) == _layer_dicts(jnew.layers)
    for i in kept:
        for k, v in src.net_params[i].items():
            assert torch.equal(new.net_params[i][k], v)
            np.testing.assert_array_equal(v.numpy(),
                                          np.asarray(jnew.net_params[i][k]))
    for lp, jp in zip(new.net_params, jnew.net_params):
        assert {k: tuple(v.shape) for k, v in lp.items()} == \
            {k: tuple(v.shape) for k, v in jp.items()}


def test_freeze_and_replace_output_matches_jax():
    """TestTransferLearning.test_freeze_and_replace_output: frozen layer 0
    keeps its weights through 5 epochs; the unfrozen layers move, as
    JAX's do."""
    x, y = iris_data()
    jsrc = iris_net()
    src = port_of(jsrc)
    fit_both(src, jsrc, x, y, 50, 10)
    assert_params_close(src, jsrc, adam=True)
    src = port_of(jsrc)
    ftc = dict(learning_rate=0.01)
    jnew = (jax_tl.TransferLearning.Builder(jsrc)
            .fine_tune_configuration(jax_tl.FineTuneConfiguration(**ftc))
            .set_feature_extractor(0)
            .n_out_replace(2, 3, weight_init="xavier").build())
    new = (tl.TransferLearning.Builder(src)
           .fine_tune_configuration(tl.FineTuneConfiguration(**ftc))
           .set_feature_extractor(0)
           .n_out_replace(2, 3, weight_init="xavier").build())
    assert isinstance(new.layers[0], L.FrozenLayerConf)
    _assert_built_alike(new, jnew, src, kept=(0, 1))
    new.load_jax_params(np_tree(jnew.net_params))
    w0 = new.net_params[0]["W"].clone()
    fit_both(new, jnew, x, y, 50, 5)
    assert torch.equal(new.net_params[0]["W"], w0)
    assert not torch.allclose(new.net_params[2]["W"], src.net_params[2]["W"])
    assert_params_close(new, jnew, adam=True)


def test_helper_featurize_matches_jax():
    """TestTransferLearning.test_helper_featurize: the features of layer 0
    (within 1e-5 of JAX's), and the unfrozen top's output on them equals
    the whole net's and JAX's top's."""
    x, y = iris_data()
    # Nesterovs, so the top's training below is held to every element:
    # under Adam a relu feature that is 0 on every row gives its weights
    # gradients of rounding size, which Adam scales to whole steps
    jsrc = iris_net(updater="nesterovs")
    jsrc.fit(JaxListIterator(JaxDataSet(x, y), 50), epochs=3)
    src = port_of(jsrc)
    jfeat = jax_tl.TransferLearningHelper(jsrc, frozen_until=0).featurize(
        JaxDataSet(x, y))
    helper = tl.TransferLearningHelper(src, frozen_until=0)
    feat = helper.featurize(DataSet(x, y))
    assert tuple(feat.features.shape) == (150, 16)
    np.testing.assert_allclose(feat.features.numpy(),
                               np.asarray(jfeat.features), rtol=OUT_TOL,
                               atol=OUT_TOL)
    top = helper.unfrozen_network()
    jtop = jax_tl.TransferLearningHelper(jsrc, 0).unfrozen_network()
    out = top.output(feat.features[:4])
    assert tuple(out.shape) == (4, 3)
    np.testing.assert_allclose(out.numpy(), src.output(x[:4]).numpy(),
                               rtol=OUT_TOL, atol=OUT_TOL)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jtop.output(np.asarray(jfeat.features[:4]))),
        rtol=OUT_TOL, atol=OUT_TOL)
    # the top trains on the features as JAX's does
    top.load_jax_params(np_tree(jtop.net_params))
    ff = feat.features.numpy()
    fit_both(top, jtop, ff, y, 50, 2)
    assert_params_close(top, jtop)


@pytest.mark.parametrize("case", ["frozen_layer", "frozen_consumer"])
def test_chained_transfer_mln_matches_jax(case):
    """TestChainedTransferMLN: a second transfer over frozen layers.
    ``frozen_layer``: n_out_replace of frozen layer 1 keeps it frozen and
    rewires layer 2; ``frozen_consumer``: n_out_replace of frozen layer 0
    rewires frozen layer 1's inner n_in."""
    x, y = iris_data()
    jsrc = iris_net()
    jsrc.fit(JaxListIterator(JaxDataSet(x, y), 50),
             epochs=2 if case == "frozen_layer" else 1)
    src = port_of(jsrc)
    jt1 = jax_tl.TransferLearning.Builder(jsrc).set_feature_extractor(1)\
        .build()
    t1 = tl.TransferLearning.Builder(src).set_feature_extractor(1).build()
    _assert_built_alike(t1, jt1, src, kept=(0, 1, 2))
    idx, n_out = (1, 12) if case == "frozen_layer" else (0, 9)
    jt2 = jax_tl.TransferLearning.Builder(jt1).n_out_replace(idx, n_out)\
        .build()
    t2 = tl.TransferLearning.Builder(t1).n_out_replace(idx, n_out).build()
    _assert_built_alike(t2, jt2, t1,
                        kept=(0,) if case == "frozen_layer" else (2,))
    assert isinstance(t2.layers[1], L.FrozenLayerConf)
    if case == "frozen_layer":
        assert t2.layers[1]._inner().n_out == 12
        assert t2.layers[2].n_in == 12
    else:
        assert t2.layers[1]._inner().n_in == 9
    t2.load_jax_params(np_tree(jt2.net_params))
    fit_both(t2, jt2, x, y, 50, 1)
    assert_params_close(t2, jt2, adam=True)


# ---------------------------------------------------------------------------
# The graph builder: tests/test_transfer_graph.py
# ---------------------------------------------------------------------------

def base_graph():
    """JAX's ``base_graph`` of tests/test_transfer_graph.py."""
    g = jax_network.GlobalConf(seed=5, learning_rate=0.1, updater="sgd")
    conf = (jax_gc.GraphBuilder(g)
            .add_inputs("in")
            .add_layer("feat", jax_layers.DenseLayer(n_in=4, n_out=8,
                                                     activation="tanh"), "in")
            .add_layer("head", jax_layers.DenseLayer(n_in=8, n_out=6,
                                                     activation="relu"),
                       "feat")
            .add_layer("out", jax_layers.OutputLayer(
                n_in=6, n_out=3, activation="softmax", loss="mcxent"), "head")
            .set_outputs("out").build())
    return JaxGraph(conf).init()


def graph_data(n=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _assert_graph_built_alike(new, jnew, src, kept):
    assert _graph_vertex_dicts(new.conf) == _graph_vertex_dicts(jnew.conf)
    assert new.order == list(jnew.order)
    assert list(new.conf.network_outputs) == list(jnew.conf.network_outputs)
    for n in kept:
        for k, v in src.net_params[n].items():
            assert torch.equal(new.net_params[n][k], v)
            np.testing.assert_array_equal(v.numpy(),
                                          np.asarray(jnew.net_params[n][k]))


def _fit_graphs(net, jnet, x, y, epochs=1):
    net.load_jax_params(np_tree(jnet.net_params))
    jnet.fit(x, y, epochs=epochs)
    net.fit(x, y, epochs=epochs)
    np.testing.assert_allclose(net.score(), float(jnet.score()),
                               rtol=FIT_RTOL)
    assert_params_close(net, jnet)


def test_frozen_vertex_params_do_not_move_as_in_jax():
    """test_frozen_vertex_params_do_not_move: 'feat' wrapped in place
    keeps its params through 3 epochs; the others train as JAX's do."""
    jconf = base_graph().conf
    lc = jconf.vertices["feat"].layer_conf()
    jconf.vertices["feat"] = jax_gc.LayerVertex(
        layer=jax_layers.FrozenLayerConf.wrap(lc).to_dict())
    jnet = JaxGraph(jconf).init()
    net = port_of(jnet)
    assert net.frozen == {"feat": True, "head": False, "out": False}
    before = {k: v.clone() for k, v in net.net_params["feat"].items()}
    x, y = graph_data()
    _fit_graphs(net, jnet, x, y, epochs=3)
    for k, v in before.items():
        assert torch.equal(net.net_params["feat"][k], v)


def test_graph_builder_freeze_and_replace_output_matches_jax():
    jsrc = base_graph()
    x, y = graph_data()
    jsrc.fit(x, y)
    src = port_of(jsrc)
    out = dict(n_in=6, n_out=5, activation="softmax", loss="mcxent")
    jnew = (jax_tl.TransferLearning.GraphBuilder(jsrc)
            .fine_tune_configuration(
                jax_tl.FineTuneConfiguration(learning_rate=0.05))
            .set_feature_extractor("feat")
            .remove_vertex_and_connections("out")
            .add_layer("newout", jax_layers.OutputLayer(**out), "head")
            .set_outputs("newout").build())
    new = (tl.TransferLearning.GraphBuilder(src)
           .fine_tune_configuration(tl.FineTuneConfiguration(
               learning_rate=0.05))
           .set_feature_extractor("feat")
           .remove_vertex_and_connections("out")
           .add_layer("newout", L.OutputLayer(**out), "head")
           .set_outputs("newout").build())
    _assert_graph_built_alike(new, jnew, src, kept=("feat", "head"))
    assert new.frozen == {"feat": True, "head": False, "newout": False}
    y5 = np.eye(5, dtype=np.float32)[
        np.random.default_rng(1).integers(0, 5, 16)]
    _fit_graphs(new, jnew, x, y5, epochs=2)
    assert torch.equal(new.net_params["feat"]["W"], src.net_params["feat"]["W"])
    assert tuple(new.output(x)[0].shape) == (16, 5)


def test_graph_builder_n_out_replace_rewires_downstream_as_in_jax():
    jsrc = base_graph()
    src = port_of(jsrc)
    jnew = jax_tl.TransferLearning.GraphBuilder(jsrc).n_out_replace(
        "feat", 12).build()
    new = tl.TransferLearning.GraphBuilder(src).n_out_replace(
        "feat", 12).build()
    _assert_graph_built_alike(new, jnew, src, kept=("out",))
    assert tuple(new.net_params["feat"]["W"].shape) == (4, 12)
    assert tuple(new.net_params["head"]["W"].shape) == (12, 6)
    _fit_graphs(new, jnew, *graph_data())


def test_graph_builder_multi_removal_is_order_independent_as_in_jax():
    jsrc = base_graph()
    src = port_of(jsrc)
    out = dict(n_in=8, n_out=3, activation="softmax", loss="mcxent")

    def edit(b, layers):
        return (b.remove_vertex_and_connections("head")
                .remove_vertex_and_connections("out")
                .add_layer("out2", layers.OutputLayer(**out), "feat")
                .set_outputs("out2").build())
    jnew = edit(jax_tl.TransferLearning.GraphBuilder(jsrc), jax_layers)
    new = edit(tl.TransferLearning.GraphBuilder(src), L)
    _assert_graph_built_alike(new, jnew, src, kept=("feat",))
    _fit_graphs(new, jnew, *graph_data())


def test_graph_builder_remove_with_live_consumer_raises_as_in_jax():
    for builder, net in ((jax_tl.TransferLearning.GraphBuilder, base_graph()),
                         (tl.TransferLearning.GraphBuilder,
                          port_of(base_graph()))):
        with pytest.raises(ValueError, match="head"):
            builder(net).remove_vertex_and_connections("head").build()


@pytest.mark.parametrize("case", ["frozen_vertex", "frozen_consumer"])
def test_chained_graph_transfer_matches_jax(case):
    """test_chained_transfer_n_out_replace_on_frozen_vertex and
    test_chained_transfer_frozen_downstream_consumer_rewired."""
    jsrc = base_graph()
    x, y = graph_data()
    jsrc.fit(x, y)
    src = port_of(jsrc)
    jt1 = jax_tl.TransferLearning.GraphBuilder(jsrc)\
        .set_feature_extractor("head").build()
    t1 = tl.TransferLearning.GraphBuilder(src)\
        .set_feature_extractor("head").build()
    _assert_graph_built_alike(t1, jt1, src, kept=("feat", "head", "out"))
    name, n_out = ("head", 10) if case == "frozen_vertex" else ("feat", 12)
    jt2 = jax_tl.TransferLearning.GraphBuilder(jt1).n_out_replace(
        name, n_out).build()
    t2 = tl.TransferLearning.GraphBuilder(t1).n_out_replace(
        name, n_out).build()
    _assert_graph_built_alike(
        t2, jt2, t1, kept=("feat",) if case == "frozen_vertex" else ())
    hc = t2.conf.vertices["head"].layer_conf()
    assert isinstance(hc, L.FrozenLayerConf)
    if case == "frozen_vertex":
        assert hc._inner().n_out == 10
        assert L.unfrozen(t2.conf.vertices["out"].layer_conf()).n_in == 10
    else:
        assert hc._inner().n_in == 12
    _fit_graphs(t2, jt2, x, y)


def _assert_fine_tunes_alike(new, jnew, src, jsrc, bn, batches):
    """The port keeps the source's statistics in the kept batch norm
    ``bn``, where JAX's builder gives it its initial state (mean 0,
    variance 1).  With the source's statistics copied into JAX's network
    and the new layers' weights into the port's, the outputs agree
    (1e-5), 4 Nesterovs steps agree by the SGD rule, and the frozen
    params and statistics stay the source's."""
    for k, v in src.net_state[bn].items():
        assert torch.equal(new.net_state[bn][k], v)
    np.testing.assert_array_equal(np.asarray(jnew.net_state[bn]["mean"]), 0)
    np.testing.assert_array_equal(np.asarray(jnew.net_state[bn]["var"]), 1)
    jnew.net_state[bn] = jsrc.net_state[bn]
    new.load_jax_params(np_tree(jnew.net_params))
    x0 = batches[0][0]
    out, jout = new.output(x0), jnew.output(x0)
    if isinstance(new, ComputationGraph):
        out, jout = out[0], jout[0]
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=OUT_TOL,
                               atol=OUT_TOL)
    for x, y in batches:
        jnew.fit(x, y)
        new.fit(x, y)
        np.testing.assert_allclose(new.score(), float(jnew.score()),
                                   rtol=FIT_RTOL)
    assert_params_close(new, jnew)
    for k, v in src.net_state[bn].items():
        assert torch.equal(new.net_state[bn][k], v)
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(jnew.net_state[bn][k]))


def test_graph_transfer_keeps_batch_norm_statistics():
    """GraphBuilder, frozen through the batch norm, output replaced: the
    port keeps the source's running statistics (DL4J keeps them too: its
    batch norm holds them as params, BatchNormalizationParamInitializer's
    mean and var); apart from that state the port's builder and JAX's
    build the same network and fine-tune it alike."""
    jsrc = _frozen_graph(freeze=False)
    src = port_of(jsrc)
    out = dict(n_in=12, n_out=5, activation="softmax", loss="mcxent")

    def edit(builder, layers, ftc):
        return (builder.fine_tune_configuration(ftc(learning_rate=0.02))
                .set_feature_extractor("bn")
                .remove_vertex_and_connections("out")
                .add_layer("out5", layers.OutputLayer(**out), "dense")
                .set_outputs("out5").build())
    jnew = edit(jax_tl.TransferLearning.GraphBuilder(jsrc), jax_layers,
                jax_tl.FineTuneConfiguration)
    new = edit(tl.TransferLearning.GraphBuilder(src), L,
               tl.FineTuneConfiguration)
    _assert_graph_built_alike(new, jnew, src, kept=("conv", "bn", "dense"))
    assert {n for n, f in new.frozen.items() if f} == {"conv", "bn"}
    y5 = np.eye(5, dtype=np.float32)[
        np.random.default_rng(7).integers(0, 5, 16)]
    batches = [(x, y5) for x, _ in _cnn_batches(seed=8)]
    _assert_fine_tunes_alike(new, jnew, src, jsrc, "bn", batches)


def test_mln_transfer_keeps_batch_norm_statistics():
    """The MultiLayerNetwork counterpart: Builder, frozen through the
    batch norm (layer 1), output replaced."""
    jsrc = _frozen_mln(freeze=False)
    src = port_of(jsrc)
    out = dict(n_in=16, n_out=5, activation="softmax", loss="mcxent")

    def edit(builder, layers, ftc):
        return (builder.fine_tune_configuration(ftc(learning_rate=0.02))
                .set_feature_extractor(1).remove_output_layer()
                .add_layer(layers.OutputLayer(**out)).build())
    jnew = edit(jax_tl.TransferLearning.Builder(jsrc), jax_layers,
                jax_tl.FineTuneConfiguration)
    new = edit(tl.TransferLearning.Builder(src), L,
               tl.FineTuneConfiguration)
    _assert_built_alike(new, jnew, src, kept=(0, 1, 3))
    assert [isinstance(l, L.FrozenLayerConf) for l in new.layers] == \
        [True, True, False, False, False]
    y5 = np.eye(5, dtype=np.float32)[
        np.random.default_rng(9).integers(0, 5, 16)]
    batches = [(x, y5) for x, _ in _cnn_batches(seed=10)]
    _assert_fine_tunes_alike(new, jnew, src, jsrc, 1, batches)


def test_unfrozen_network_keeps_batch_norm_statistics():
    """TransferLearningHelper over a dense net with a batch norm above
    the frozen layer: the port's unfrozen top keeps the batch norm's
    statistics, where JAX's gives it its initial state.  With the
    source's statistics copied into JAX's top, the features (1e-5), the
    top's output on them and 3 Nesterovs steps of the top agree."""
    conf = (jax_network.NeuralNetConfiguration.builder().seed(2)
            .learning_rate(0.05).updater("nesterovs").list()
            .layer(jax_layers.DenseLayer(n_out=16, activation="relu"))
            .layer(jax_layers.DenseLayer(n_out=8, activation="tanh"))
            .layer(jax_layers.BatchNormalization())
            .layer(jax_layers.OutputLayer(n_out=3, activation="softmax",
                                          loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(4)).build())
    jsrc = JaxNet(conf).init()
    rng = np.random.default_rng(12)
    jsrc.net_state[2] = {
        "mean": jnp.asarray(0.2 * rng.normal(size=8), jnp.float32),
        "var": jnp.asarray(rng.uniform(0.5, 1.5, 8), jnp.float32)}
    src = port_of(jsrc)
    x, y = iris_data()
    jhelper = jax_tl.TransferLearningHelper(jsrc, frozen_until=0)
    helper = tl.TransferLearningHelper(src, frozen_until=0)
    jfeat = jhelper.featurize(JaxDataSet(x, y))
    feat = helper.featurize(DataSet(x, y))
    np.testing.assert_allclose(feat.features.numpy(),
                               np.asarray(jfeat.features), rtol=OUT_TOL,
                               atol=OUT_TOL)
    top, jtop = helper.unfrozen_network(), jhelper.unfrozen_network()
    for k, v in src.net_state[2].items():
        assert torch.equal(top.net_state[1][k], v)
    np.testing.assert_array_equal(np.asarray(jtop.net_state[1]["var"]), 1)
    jtop.net_state[1] = jsrc.net_state[2]
    ff = feat.features.numpy()
    np.testing.assert_allclose(top.output(ff).numpy(),
                               src.output(x).numpy(), rtol=OUT_TOL,
                               atol=OUT_TOL)
    np.testing.assert_allclose(top.output(ff).numpy(),
                               np.asarray(jtop.output(ff)), rtol=OUT_TOL,
                               atol=OUT_TOL)
    fit_both(top, jtop, ff, y, 50, 1)
    np.testing.assert_allclose(top.score(), float(jtop.score()),
                               rtol=FIT_RTOL)
    assert_params_close(top, jtop)


# ---------------------------------------------------------------------------
# Engine methods
# ---------------------------------------------------------------------------

def test_mln_engine_methods_match_jax():
    """feed_forward (every layer's activation, 1e-5), summary (the same
    text), param_table / get_param / set_param and get_layer_params, and
    clone: a copy that trains apart from its source."""
    jnet = _frozen_mln()
    net = port_of(jnet)
    x = _cnn_batches(1)[0][0]
    acts, jacts = net.feed_forward(x), jnet.feed_forward(x)
    assert len(acts) == len(jacts) == len(net.layers)
    for a, ja in zip(acts, jacts):
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=OUT_TOL,
                                   atol=OUT_TOL)
    assert net.summary() == jnet.summary()
    table, jtable = net.param_table(), jnet.param_table()
    assert list(table) == list(jtable)
    for k in jtable:
        np.testing.assert_array_equal(net.get_param(k).numpy(),
                                      np.asarray(jtable[k]))
    assert net.get_layer_params(3) is net.net_params[3]
    w = np.ones(tuple(net.get_param("3_W").shape), np.float32)
    net.set_param("3_W", w)
    assert torch.equal(net.get_param("3_W"), torch.from_numpy(w))
    with pytest.raises(ValueError):
        net.set_param("3_W", w[:1])
    clone = net.clone()
    assert torch.equal(clone.params(), net.params())
    clone.fit(*_cnn_batches(1)[0])
    assert clone.iteration == net.iteration + 1
    assert not torch.equal(clone.params(), net.params())
    assert net.net_params[3]["W"].data_ptr() != \
        clone.net_params[3]["W"].data_ptr()


def test_graph_engine_methods_match_jax():
    jnet = _frozen_graph()
    net = port_of(jnet)
    x = _cnn_batches(1)[0][0]
    acts, jacts = net.feed_forward(x), jnet.feed_forward(x)
    assert set(jacts) <= set(acts)
    assert set(net.order) <= set(acts)
    for n in jacts:
        np.testing.assert_allclose(acts[n].numpy(), np.asarray(jacts[n]),
                                   rtol=OUT_TOL, atol=OUT_TOL)
    assert net.summary() == jnet.summary()
    table, jtable = net.param_table(), jnet.param_table()
    assert list(table) == list(jtable)
    for k in jtable:
        np.testing.assert_array_equal(net.get_param(k).numpy(),
                                      np.asarray(jnet.get_param(k)))
    clone = net.clone()
    clone.fit(*_cnn_batches(1)[0])
    assert not torch.equal(clone.params(), net.params())


def test_clone_copies_the_kv_ring():
    """``attend_cached`` writes a layer's KV ring in place: a clone's ring
    is its own, so decoding on the clone leaves the source's stream as it
    was."""
    conf = (network.NeuralNetConfiguration.builder().seed(2).list()
            .layer(L.SelfAttentionLayer(n_in=8, n_out=8, n_heads=2,
                                        causal=True, cache_window=16))
            .layer(L.RnnOutputLayer(n_in=8, n_out=5, activation="softmax",
                                    loss="mcxent"))
            .build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    rng = np.random.default_rng(0)
    net.rnn_time_step(rng.normal(size=(2, 3, 8)).astype(np.float32))
    clone = net.clone()
    step = rng.normal(size=(2, 1, 8)).astype(np.float32)
    want = net.clone().rnn_time_step(step)
    clone.rnn_time_step(step)
    clone.rnn_time_step(step)
    torch.testing.assert_close(net.rnn_time_step(step), want, rtol=0, atol=0)
