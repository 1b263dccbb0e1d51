"""The layers, preprocessors and shape inference that Keras import brought
to the port (LossLayer, ActivationLayer, DropoutLayer, EmbeddingLayer,
ZeroPaddingLayer, BatchNormalization, LocalResponseNormalization,
GlobalPoolingLayer; CnnToRnn, RnnToCnn, Composable) held against the JAX
package's on the CPU.

Each layer is built with the same fields in both packages, takes the same
params and state (drawn with numpy) and the same input, in training and
in inference.  Where JAX's dropout runs its Pallas kernel
(``DL4J_PALLAS_DROPOUT=1``, interpret mode), the port gets the seed words
JAX derives from the key, so both draw the same mask.  Tolerances,
float32 on both sides: outputs and state rtol 1e-5, atol 1e-6;
gradients rtol 1e-4, atol 1e-6 (sums in another order); params after a
``fit`` step rtol 1e-4, atol 1e-5 (Nesterovs, linear in the gradient, as
``tests/test_torch_fit.py``).
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf.layers as jax_layers
import deeplearning4j_tpu.nn.conf.network as jax_network
import deeplearning4j_tpu.nn.conf.preprocessors as jax_pp
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn import serialization as jax_ser
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import serialization as ser
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf import network
from deeplearning4j_tpu_torch.nn.conf import preprocessors as pp
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL = 1e-4
FIT_RTOL, FIT_ATOL = 1e-4, 1e-5
REPO = Path(__file__).resolve().parent.parent
NEW_LAYERS = ("LossLayer", "ActivationLayer", "DropoutLayer",
              "EmbeddingLayer", "ZeroPaddingLayer", "BatchNormalization",
              "LocalResponseNormalization", "GlobalPoolingLayer")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_type(it: InputType) -> JaxInputType:
    return JaxInputType(**it.to_dict())


def _draw(shapes, seed):
    """Params and state by name: variances in [0.5, 1.5], the rest
    0.5 N(0, 1)."""
    rng = np.random.default_rng(seed)
    return {k: (rng.uniform(0.5, 1.5, s) if k == "var"
                else 0.5 * rng.normal(size=s)).astype(np.float32)
            for k, s in shapes.items()}


def _pair(name, kw, input_type, seed=0):
    """The layer in both packages with numpy-drawn params and state, after
    checking that both initialize the same shapes, state and output type."""
    layer = getattr(L, name)(**kw)
    jlayer = getattr(jax_layers, name)(**kw)
    params, out_type = layer.initialize(torch.Generator().manual_seed(0),
                                        input_type, "cpu")
    state = layer.initial_state(input_type, "cpu")
    jparams, jstate, jout = jlayer.initialize(jax.random.PRNGKey(0),
                                              _jax_type(input_type))
    assert out_type.to_dict() == jout.to_dict()
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in jparams.items()}
    assert sorted(state) == sorted(jstate)
    for k in state:
        np.testing.assert_array_equal(state[k].numpy(), np.asarray(jstate[k]))
    assert layer.has_params() == jlayer.has_params()
    drawn = _draw({k: tuple(v.shape) for k, v in {**params, **state}.items()},
                  seed)
    p = {k: drawn[k] for k in params}
    s = {k: drawn[k] for k in state}
    return layer, jlayer, p, s


def _compare(layer, jlayer, p, s, x, train, mask=None, seed=(0, 0),
             jrng=None):
    """Output, new state and output mask of both packages, then the
    gradients of sum(output * r) with respect to the params and a float
    input."""
    floating = np.issubdtype(x.dtype, np.floating)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in p.items()}
    ts = {k: torch.from_numpy(v.copy()) for k, v in s.items()}
    tx = torch.from_numpy(x.copy())
    if floating:
        tx.requires_grad_()
    tm = None if mask is None else torch.from_numpy(mask)
    y, ns, om = layer.forward(tp, ts, tx, train, seed, tm)
    jm = None if mask is None else jnp.asarray(mask)

    def jfwd(jp, jx):
        return jlayer.forward(jp, {k: jnp.asarray(v) for k, v in s.items()},
                              jx, train=train, rng=jrng, mask=jm)
    jy, jns, jom = jfwd({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=RTOL, atol=ATOL)
    assert sorted(ns) == sorted(jns)
    for k in ns:
        np.testing.assert_allclose(ns[k].detach().numpy(),
                                   np.asarray(jns[k]), rtol=RTOL, atol=ATOL)
    assert (om is None) == (jom is None)
    r = np.random.default_rng(9).normal(size=y.shape).astype(np.float32)
    leaves = list(tp.values()) + ([tx] if floating else [])
    if not leaves:
        return y
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum(), leaves)
    if floating:
        jgp, jgx = jax.grad(
            lambda jp, jx: jnp.sum(jfwd(jp, jx)[0] * r), argnums=(0, 1))(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
        want = [jgp[k] for k in tp] + [jgx]
    else:
        jgp = jax.grad(lambda jp: jnp.sum(jfwd(jp, jnp.asarray(x))[0] * r))(
            {k: jnp.asarray(v) for k, v in p.items()})
        want = [jgp[k] for k in tp]
    for got, w in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   rtol=GRAD_RTOL, atol=ATOL)
    return y


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


CNN = InputType.convolutional(5, 6, 4)

CASES = {
    "activation_relu": ("ActivationLayer", {"activation": "relu"}, CNN,
                        (3, 4, 5, 6)),
    "activation_tanh_ff": ("ActivationLayer", {"activation": "tanh"},
                           InputType.feed_forward(7), (5, 7)),
    "zero_padding": ("ZeroPaddingLayer", {"pad": (1, 2, 0, 3)}, CNN,
                     (3, 4, 5, 6)),
    "lrn": ("LocalResponseNormalization", {}, CNN, (3, 4, 5, 6)),
    "lrn_wide": ("LocalResponseNormalization",
                 {"k": 1.0, "n": 3, "alpha": 0.5, "beta": 0.5}, CNN,
                 (3, 4, 5, 6)),
    "batch_norm_cnn": ("BatchNormalization", {"decay": 0.99, "eps": 1e-3},
                       CNN, (6, 4, 5, 6)),
    "batch_norm_ff": ("BatchNormalization", {}, InputType.feed_forward(7),
                      (9, 7)),
    "batch_norm_locked": ("BatchNormalization",
                          {"lock_gamma_beta": True, "activation": "relu"},
                          CNN, (6, 4, 5, 6)),
    "embedding_one_hot": ("EmbeddingLayer",
                          {"n_in": 9, "n_out": 5, "activation": "tanh"},
                          InputType.feed_forward(9), None),
    "loss_layer": ("LossLayer", {"loss": "mcxent", "activation": "softmax"},
                   InputType.feed_forward(6), (5, 6)),
    "dropout_inference": ("DropoutLayer", {"dropout": 0.5},
                          InputType.feed_forward(6), (5, 6)),
}


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_jax(case, train):
    name, kw, it, shape = CASES[case]
    layer, jlayer, p, s = _pair(name, kw, it)
    if shape is None:      # one-hot rows for the embedding
        x = np.eye(9, dtype=np.float32)[np.random.default_rng(2).integers(
            0, 9, 8)]
    else:
        x = _x(shape)
    # DropoutLayer without seed words / a key applies no dropout
    _compare(layer, jlayer, p, s, x, train,
             seed=None if name == "DropoutLayer" else (0, 0))


@pytest.mark.parametrize("shape", [(8,), (8, 1)])
def test_embedding_gathers_integer_indices_as_jax(shape):
    layer, jlayer, p, s = _pair("EmbeddingLayer",
                                {"n_in": 9, "n_out": 5,
                                 "activation": "identity"},
                                InputType.feed_forward(9))
    idx = np.random.default_rng(3).integers(0, 9, shape)
    y = _compare(layer, jlayer, p, s, idx, train=False)
    onehot = np.eye(9, dtype=np.float32)[idx.reshape(-1)]
    y1 = layer.forward({k: torch.from_numpy(v) for k, v in p.items()}, {},
                       torch.from_numpy(onehot))[0]
    np.testing.assert_allclose(y.detach().numpy(), y1.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_dropout_layer_draws_jax_masks_in_training(monkeypatch):
    """Training: the threshold-hash mask from JAX's seed words for the
    key, on a [64, 128] input (at or above the kernel's 4,096-element
    gate in both packages)."""
    monkeypatch.setenv("DL4J_PALLAS_DROPOUT", "1")
    layer, jlayer, p, s = _pair("DropoutLayer", {"dropout": 0.6},
                                InputType.feed_forward(128))
    key = jax.random.PRNGKey(7)
    seed = np.asarray(pk._dropout_seed(key)).reshape(-1).tolist()
    y = _compare(layer, jlayer, p, s, _x((64, 128)), True, seed=seed,
                 jrng=key)
    kept = float((y != 0).float().mean())
    assert abs(kept - 0.6) < 0.03


def test_loss_layer_score_and_preoutput_match_jax():
    layer, jlayer, _, _ = _pair("LossLayer", {"loss": "mcxent",
                                              "activation": "softmax"},
                                InputType.feed_forward(6))
    x = _x((5, 6))
    y = np.eye(6, dtype=np.float32)[[0, 3, 5, 1, 1]]
    got = layer.compute_score(torch.from_numpy(y),
                              layer.preoutput({}, torch.from_numpy(x)))
    want = jlayer.compute_score(jnp.asarray(y),
                                jlayer.preoutput({}, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("kind", ["max", "avg", "sum", "pnorm"])
@pytest.mark.parametrize("source", ["cnn", "rnn", "rnn_masked"])
def test_global_pooling_matches_jax(kind, source, train):
    it = CNN if source == "cnn" else InputType.recurrent(4, 7)
    layer, jlayer, p, s = _pair("GlobalPoolingLayer",
                                {"pooling_type": kind, "pnorm": 3}, it)
    x = _x((3, 4, 5, 6) if source == "cnn" else (5, 7, 4))
    mask = None
    if source == "rnn_masked":
        lengths = np.array([7, 1, 4, 3, 6])
        mask = (np.arange(7)[None] < lengths[:, None]).astype(np.float32)
    _compare(layer, jlayer, p, s, x, train, mask=mask)


PREPROCS = {
    "cnn_to_rnn": (lambda m: m.CnnToRnnPreProcessor(timesteps=3),
                   (6, 2, 3, 4), InputType.convolutional(3, 4, 2)),
    "rnn_to_cnn": (lambda m: m.RnnToCnnPreProcessor(3, 4, 2),
                   (2, 3, 24), InputType.recurrent(24, 3)),
    "composable": (lambda m: m.ComposableInputPreProcessor.compose(
        m.CnnToRnnPreProcessor(timesteps=3), m.RnnToFeedForwardPreProcessor(),
        m.FeedForwardToCnnPreProcessor(3, 4, 2)),
        (6, 2, 3, 4), InputType.convolutional(3, 4, 2)),
}


@pytest.mark.parametrize("name", sorted(PREPROCS))
def test_preprocessor_matches_jax(name):
    make, shape, it = PREPROCS[name]
    proc, jproc = make(pp), make(jax_pp)
    assert proc.to_dict() == jproc.to_dict()
    assert pp.InputPreProcessor.from_dict(
        json.loads(json.dumps(jproc.to_dict()))) == proc
    assert proc.output_type(it).to_dict() == \
        jproc.output_type(_jax_type(it)).to_dict()
    x = _x(shape)
    mask = np.ones(shape[:2], np.float32) if name == "rnn_to_cnn" else None
    y, m = proc(torch.from_numpy(x),
                None if mask is None else torch.from_numpy(mask))
    jy, jm = jproc(jnp.asarray(x), None if mask is None else jnp.asarray(mask))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert (m is None) == (jm is None)


def test_cnn_to_rnn_without_timesteps_raises_as_jax():
    x = _x((6, 2, 3, 4))
    for mod, arr in ((pp, torch.from_numpy(x)), (jax_pp, jnp.asarray(x))):
        with pytest.raises(ValueError, match="timestep"):
            mod.CnnToRnnPreProcessor()(arr)


def _shape_confs(layers, net, input_type):
    """Stacks whose builder inserts preprocessors and fills n_in and
    BatchNormalization's n_features."""
    g = net.NeuralNetConfiguration.builder().seed(3)
    cnn = (g.list()
           .layer(layers.ZeroPaddingLayer(pad=(1, 1, 1, 1)))
           .layer(layers.ConvolutionLayer(n_out=4, kernel=(3, 3)))
           .layer(layers.LocalResponseNormalization())
           .layer(layers.BatchNormalization())
           .layer(layers.DenseLayer(n_out=5))
           .layer(layers.BatchNormalization())
           .layer(layers.OutputLayer(n_out=3, loss="mcxent",
                                     activation="softmax"))
           .set_input_type(input_type.convolutional(6, 6, 2)).build())
    flat = (g.list()
            .layer(layers.ZeroPaddingLayer(pad=(0, 1, 0, 1)))
            .layer(layers.GlobalPoolingLayer())
            .layer(layers.OutputLayer(n_out=3))
            .set_input_type(input_type.convolutional_flat(4, 4, 2)).build())
    emb = (g.list()
           .layer(layers.EmbeddingLayer(n_out=6))
           .layer(layers.OutputLayer(n_out=3))
           .set_input_type(input_type.recurrent(9, 4)).build())
    rnn = (g.list()
           .layer(layers.ConvolutionLayer(n_out=4, kernel=(3, 3)))
           .layer(layers.GravesLSTM(n_out=5))
           .layer(layers.RnnOutputLayer(n_out=3))
           .set_input_type(input_type.convolutional(6, 6, 2)).build())
    return {"cnn": cnn, "flat": flat, "embedding": emb, "cnn_to_rnn": rnn}


@pytest.mark.parametrize("name", ["cnn", "flat", "embedding", "cnn_to_rnn"])
def test_shape_inference_matches_jax(name):
    """ZeroPadding and LRN take CNN input, Embedding feed-forward input,
    BatchNormalization gets its n_features, and a CNN before an LSTM gets
    JAX's CnnToRnn (without timesteps): the two configurations' JSON is
    equal."""
    conf = _shape_confs(L, network, InputType)[name]
    jconf = _shape_confs(jax_layers, jax_network, JaxInputType)[name]
    assert json.loads(conf.to_json()) == json.loads(jconf.to_json())
    if name == "cnn":
        assert [l.n_features for l in conf.layers
                if isinstance(l, L.BatchNormalization)] == [4, 5]
    if name == "cnn_to_rnn":
        assert isinstance(conf.preprocessors[1], pp.CnnToRnnPreProcessor)


def test_rnn_to_cnn_is_not_inserted_as_jax():
    for layers, net, it in ((L, network, InputType),
                            (jax_layers, jax_network, JaxInputType)):
        b = (net.NeuralNetConfiguration.builder().list()
             .layer(layers.ConvolutionLayer(n_out=2, kernel=(1, 1)))
             .set_input_type(it.recurrent(4, 3)))
        with pytest.raises(ValueError, match="RnnToCnn"):
            b.build()


def _merged_layers(layers):
    """Each new layer class built with the same calls in either package."""
    return [layers.LossLayer(loss="mse"), layers.ActivationLayer(),
            layers.DropoutLayer(), layers.EmbeddingLayer(n_in=6, n_out=4),
            layers.ZeroPaddingLayer(pad=(1, 0, 1, 0)),
            layers.BatchNormalization(),
            layers.LocalResponseNormalization(),
            layers.GlobalPoolingLayer(pooling_type="avg")]


def _merged_conf(layers, net, input_type):
    b = (net.NeuralNetConfiguration.builder().seed(5).activation("tanh")
         .weight_init("relu").drop_out(0.7).regularization(True).l2(1e-3)
         .updater("nesterovs").learning_rate(0.02).list())
    b.layer(layers.ConvolutionLayer(n_out=3, kernel=(3, 3)))
    for layer in _merged_layers(layers)[4:]:
        b.layer(layer)
    b.layer(layers.EmbeddingLayer(n_out=4))
    b.layer(layers.DropoutLayer())
    b.layer(layers.ActivationLayer())
    b.layer(layers.LossLayer(loss="mse"))
    return b.set_input_type(input_type.convolutional(6, 6, 2)).build()


def test_merged_new_layers_equal_jax(tmp_path):
    """With a global activation, dropout and l2 set, both packages fill
    each new layer's unset fields alike (BatchNormalization keeps its own
    "identity"), and the configuration.json each writes is the same."""
    g = (network.NeuralNetConfiguration.builder().activation("tanh")
         .drop_out(0.7).regularization(True).l2(1e-3))._g
    jg = (jax_network.NeuralNetConfiguration.builder().activation("tanh")
          .drop_out(0.7).regularization(True).l2(1e-3))._g
    for layer, jlayer in zip(_merged_layers(L), _merged_layers(jax_layers)):
        assert layer.to_dict() == jlayer.to_dict()
        merged = network.merge_layer_conf(layer, g).to_dict()
        assert merged == jax_network.merge_layer_conf(jlayer, jg).to_dict()
        want_act = "identity" if type(layer).__name__ == \
            "BatchNormalization" else "tanh"
        assert merged["activation"] == want_act
        assert merged["dropout"] == 0.7 and merged["l2"] == 1e-3
    conf = _merged_conf(L, network, InputType)
    jconf = _merged_conf(jax_layers, jax_network, JaxInputType)
    assert json.loads(conf.to_json()) == json.loads(jconf.to_json())
    net = MultiLayerNetwork(conf, device="cpu").init()
    jnet = JaxNet(jconf).init()
    ser.write_model(net, tmp_path / "port.zip")
    jax_ser.write_model(jnet, tmp_path / "jax.zip")
    import zipfile
    with zipfile.ZipFile(tmp_path / "port.zip") as a, \
            zipfile.ZipFile(tmp_path / "jax.zip") as b:
        assert json.loads(a.read("configuration.json")) == \
            json.loads(b.read("configuration.json"))
    assert set(type(l).__name__ for l in conf.layers) >= set(NEW_LAYERS)


def _numpy_params_and_state(net, seed):
    rng = np.random.default_rng(seed)
    params = [{k: (rng.normal(size=tuple(v.shape)) * 0.4 +
                   (1.0 if k == "gamma" else 0.0)).astype(np.float32)
               for k, v in lp.items()} for lp in net.net_params]
    state = [{k: (rng.uniform(0.5, 1.5, tuple(v.shape)) if k == "var" else
                  rng.normal(size=tuple(v.shape)) * 0.2).astype(np.float32)
              for k, v in s.items()} for s in net.net_state]
    return params, state


@pytest.mark.parametrize("name", ["cnn", "rnn_pool", "embedding",
                                  "embedding_one_hot", "preproc"])
def test_new_layer_nets_match_jax(name):
    """The nets of chip_smoke.py's ``new_layers`` phase, built with the
    port's API, read by the JAX package from their JSON: ``output()`` and
    one Nesterovs ``fit`` step from the same params and state (score,
    params, batch norm's statistics)."""
    conf, x, y, mask = _chip_smoke().new_layer_nets()[name]
    jconf = jax_network.MultiLayerConfiguration.from_json(conf.to_json())
    net = MultiLayerNetwork(conf, device="cpu").init()
    params, state = _numpy_params_and_state(net, 4)
    net.load_jax_params(params).load_jax_state(state)
    jnet = JaxNet(jconf).init(
        params=[{k: jnp.asarray(v) for k, v in lp.items()} for lp in params])
    jnet.net_state = [{k: jnp.asarray(v) for k, v in s.items()}
                      for s in state]
    out = net.output(x, mask)
    jout = jnet.output(x, mask=mask)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=ATOL)
    jnet.fit(JaxDataSet(x, y, mask, None))
    net.fit(DataSet(x, y, mask, None))
    np.testing.assert_allclose(net.score(), float(jnet.score()),
                               rtol=FIT_RTOL)
    for lp, jp in zip(net.net_params + net.net_state,
                      jnet.net_params + jnet.net_state):
        assert sorted(lp) == sorted(jp)
        for k in jp:
            np.testing.assert_allclose(lp[k].numpy(), np.asarray(jp[k]),
                                       rtol=FIT_RTOL, atol=FIT_ATOL)


def test_batch_norm_state_from_jax_and_through_fit():
    """``load_jax_state`` carries a JAX net's running statistics across;
    ``fit`` keeps the new ones, ``rnn_clear_previous_state`` and
    ``output`` leave them, and a fresh net starts from zeros and ones."""
    conf = _chip_smoke().new_layer_nets()["cnn"][0]
    net = MultiLayerNetwork(conf, device="cpu").init()
    bn = [i for i, l in enumerate(conf.layers)
          if isinstance(l, L.BatchNormalization)][0]
    assert torch.equal(net.net_state[bn]["mean"], torch.zeros(8))
    assert torch.equal(net.net_state[bn]["var"], torch.ones(8))
    jstate = [{k: np.asarray(v) for k, v in s.items()}
              for s in JaxNet(jax_network.MultiLayerConfiguration.from_json(
                  conf.to_json())).init().net_state]
    jstate[bn] = {"mean": np.full(8, 0.5, np.float32),
                  "var": np.full(8, 2.0, np.float32)}
    net.load_jax_state(jstate)
    assert torch.equal(net.net_state[bn]["var"], torch.full((8,), 2.0))
    x = _x((4, 3, 12, 12))
    y = np.eye(5, dtype=np.float32)[[0, 1, 2, 3]]
    net.fit(x, y)
    after = {k: v.clone() for k, v in net.net_state[bn].items()}
    assert not torch.equal(after["mean"], torch.full((8,), 0.5))
    net.rnn_clear_previous_state()
    net.output(x)
    for k, v in after.items():
        assert torch.equal(net.net_state[bn][k], v)


def test_fit_accepts_a_loss_layer_head_as_jax():
    """A LossLayer head trains (its preoutput is its input) and matches
    JAX's step."""
    def conf(layers, net):
        return (net.NeuralNetConfiguration.builder().seed(2)
                .learning_rate(0.1).updater("sgd").list()
                .layer(layers.DenseLayer(n_in=5, n_out=4,
                                         activation="identity"))
                .layer(layers.LossLayer(loss="mcxent",
                                        activation="softmax")).build())
    net = MultiLayerNetwork(conf(L, network), device="cpu").init()
    rng = np.random.default_rng(0)
    params = [{"W": rng.normal(size=(5, 4)).astype(np.float32),
               "b": rng.normal(size=4).astype(np.float32)}, {}]
    net.load_jax_params(params)
    jnet = JaxNet(conf(jax_layers, jax_network)).init(
        params=[{k: jnp.asarray(v) for k, v in lp.items()} for lp in params])
    x = _x((6, 5))
    y = np.eye(4, dtype=np.float32)[[0, 1, 2, 3, 0, 1]]
    for _ in range(2):
        net.fit(x, y)
        jnet.fit(x, y)
    np.testing.assert_allclose(net.score(), float(jnet.score()), rtol=RTOL)
    np.testing.assert_allclose(net.net_params[0]["W"].numpy(),
                               np.asarray(jnet.net_params[0]["W"]),
                               rtol=FIT_RTOL, atol=FIT_ATOL)
