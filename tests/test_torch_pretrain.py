"""The port's pretrain layers, VAE distributions, centre-loss head and 1D
conv family (``nn/conf/layers_pretrain.py``, ``ops/vae_distributions.py``)
and layerwise pretraining on both engines, held against the JAX package on
the CPU.

The port's pretrain losses take their noise as an argument; these tests
hand them the noise the JAX package draws from its key:
``jax.random.bernoulli(k, p, s)`` is ``uniform(k, s) < p`` (checked
below), the RBM's Gibbs chain splits its key in three a step (hidden,
visible), and the VAE folds the sample index into its key for ε.

Tolerances, float32 on both sides, sums of at most a few dozen products:
* forward outputs, losses, distributions' log-probabilities and gradients:
  rtol 1e-5, atol 1e-6 (the rule of ``tests/test_external_gradients.py``);
* params after 3 updater steps (SGD, Nesterovs, RMSProp): rtol 1e-4,
  atol 1e-5, the rule of ``tests/test_torch_fit.py`` for updates linear
  in the gradient; under Adam that file's Adam rule (99.5 % of elements
  within it, every one within half a step of lr);
* zips: equal bytes for ``coefficients.bin``, ``updaterState.bin`` and
  ``configuration.json``.
"""

import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf.graph_conf as jax_gc
import deeplearning4j_tpu.nn.conf.layers as jax_layers
import deeplearning4j_tpu.nn.conf.layers_pretrain as jax_pre
import deeplearning4j_tpu.nn.conf.network as jax_network
from deeplearning4j_tpu.nn import serialization as jax_ser
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.ops import vae_distributions as jax_dist
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import serialization as ser
from deeplearning4j_tpu_torch.nn.conf import graph_conf as gc
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf import layers_pretrain as P
from deeplearning4j_tpu_torch.nn.conf import network
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import vae_distributions as dist

RTOL, ATOL = 1e-5, 1e-6
FIT_RTOL, FIT_ATOL = 1e-4, 1e-5
ADAM_INSIDE, ADAM_ATOL = 0.995, 5e-3

PORT = (network, L, P, InputType)
JAX = (jax_network, jax_layers, jax_pre, JaxInputType)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def params_close(got, want, rtol=FIT_RTOL, atol=FIT_ATOL, adam=False):
    """Per-layer (list) or per-vertex (dict) param dicts; ``adam`` takes
    the Adam rule of ``tests/test_torch_fit.py``."""
    keys = list(want) if isinstance(want, dict) else range(len(want))
    for e in keys:
        for k in want[e]:
            g, w = got[e][k].detach().numpy(), np.asarray(want[e][k])
            if not adam:
                close(g, w, rtol, atol, f"{e} {k}")
                continue
            ok = np.isclose(g, w, rtol=rtol, atol=atol)
            assert ok.mean() >= ADAM_INSIDE, (e, k, ok.mean())
            assert np.abs(g - w).max() <= ADAM_ATOL, (e, k)


def _np_params(jparams):
    return [{k: np.asarray(v) for k, v in lp.items()} for lp in jparams]


def mln_pair(build, updater="sgd", lr=0.1, input_type=None, **g):
    """A JAX MultiLayerNetwork and the port's (CPU) from the same
    configuration code, the port holding the JAX network's params."""
    nets = []
    for net_mod, lay, pre, itype in (JAX, PORT):
        b = (net_mod.NeuralNetConfiguration.builder().seed(42)
             .learning_rate(lr).updater(updater))
        for k, v in g.items():
            b = getattr(b, k)(v)
        b = b.list()
        for layer in build(lay, pre):
            b = b.layer(layer)
        if input_type is not None:
            b = b.set_input_type(input_type(itype))
        nets.append(b.build())
    jnet = JaxNet(nets[0]).init()
    net = MultiLayerNetwork(nets[1], device="cpu").init()
    net.load_jax_params(_np_params(jnet.net_params))
    net.load_jax_state([{k: np.asarray(v) for k, v in s.items()}
                        for s in jnet.net_state])
    return jnet, net


# ---------------------------------------------------------------------------
# The noise the JAX package draws from its key
# ---------------------------------------------------------------------------

def ae_noise(layer, key, shape):
    if layer.corruption_level <= 0.0:
        return {}
    keep = jax.random.uniform(key, shape) < 1.0 - layer.corruption_level
    return {"keep": t(keep)}


def _unit_noise(unit, key, shape):
    if unit == "binary":
        return t(jax.random.uniform(key, shape))
    if unit == "gaussian":
        return t(jax.random.normal(key, shape))
    return None


def rbm_noise(layer, key, n, n_in):
    hs, vs, r = [], [], key
    for _ in range(layer.k):
        r, rh, rv = jax.random.split(r, 3)
        hs.append(_unit_noise(layer.hidden_unit, rh, (n, layer.n_out)))
        vs.append(_unit_noise(layer.visible_unit, rv, (n, n_in)))
    return {"h": hs, "v": vs}


def vae_noise(layer, key, n, samples=None):
    s = samples or max(layer.num_samples, 1)
    return {"eps": torch.stack([t(jax.random.normal(
        jax.random.fold_in(key, i), (n, layer.n_out))) for i in range(s)])}


def jax_noise(layer, key, x):
    name = type(layer).__name__
    if name == "AutoEncoder":
        return ae_noise(layer, key, x.shape)
    if name == "RBM":
        return rbm_noise(layer, key, x.shape[0], x.shape[1])
    return vae_noise(layer, key, x.shape[0])


def test_bernoulli_is_uniform_below_p():
    key = jax.random.PRNGKey(3)
    p = jnp.asarray(np.random.default_rng(0).uniform(size=(6, 5)),
                    jnp.float32)
    assert np.array_equal(np.asarray(jax.random.bernoulli(key, p)),
                          np.asarray(jax.random.uniform(key, p.shape) < p))
    assert np.array_equal(np.asarray(jax.random.bernoulli(key, 0.7, (4, 3))),
                          np.asarray(jax.random.uniform(key, (4, 3)) < 0.7))


# ---------------------------------------------------------------------------
# VAE distributions
# ---------------------------------------------------------------------------

DISTS = [
    {"type": "gaussian", "activation": "identity"},
    {"type": "gaussian", "activation": "tanh"},
    {"type": "bernoulli"},
    {"type": "exponential", "activation": "identity"},
    {"type": "loss", "loss": "mse", "activation": "sigmoid"},
    {"type": "composite", "parts": [
        {"size": 3, "dist": {"type": "bernoulli"}},
        {"size": 2, "dist": {"type": "gaussian", "activation": "identity"}}]},
]


@pytest.mark.parametrize("spec", DISTS, ids=lambda s: s["type"] + "_" +
                         str(s.get("activation", "")))
def test_distribution_neg_log_prob_and_mean(spec):
    rng = np.random.default_rng(1)
    d, jd = dist.make(spec), jax_dist.make(spec)
    n_feat = 5
    assert d.n_dist_params(n_feat) == jd.n_dist_params(n_feat)
    pre = rng.normal(size=(7, d.n_dist_params(n_feat))).astype(np.float32)
    x = rng.uniform(size=(7, n_feat)).astype(np.float32)
    if spec["type"] == "exponential":
        x = x * 3.0
    close(d.neg_log_prob(t(x), t(pre)), jd.neg_log_prob(jnp.asarray(x),
                                                        jnp.asarray(pre)))
    close(d.mean(t(pre)), jd.mean(jnp.asarray(pre)))
    s = d.sample(t(pre), torch.Generator().manual_seed(0))
    assert s.shape == (7, n_feat) and torch.isfinite(s).all()


def test_distribution_default_is_gaussian():
    assert isinstance(dist.make(None), type(dist.make({"type": "gaussian"})))


# ---------------------------------------------------------------------------
# Pretrain losses and gradients given JAX's noise
# ---------------------------------------------------------------------------

def _layer_pair(make, n_in, seed=1):
    """The port's layer, JAX's, and JAX's initial params (as tensors too)."""
    jlayer, layer = make(jax_pre), make(P)
    jp, _, _ = jlayer.initialize(jax.random.PRNGKey(seed),
                                 JaxInputType.feed_forward(n_in))
    jp = {k: v if k.startswith(("W", "eW", "dW", "pXZW", "pZX"))
          else v + 0.1 for k, v in jp.items()}
    return layer, jlayer, jp


def _loss_and_grads(layer, params, x, noise):
    lp = {k: t(v).requires_grad_() for k, v in params.items()}
    loss = layer.pretrain_loss(lp, t(x), noise)
    grads = dict(zip(lp, torch.autograd.grad(loss, list(lp.values()))))
    return loss, grads


def _check_loss(make, x, seed=1):
    layer, jlayer, jp = _layer_pair(make, x.shape[1], seed)
    key = jax.random.PRNGKey(seed + 10)
    loss_and_grads = jax.jit(jax.value_and_grad(
        lambda p: jlayer.pretrain_loss(p, jnp.asarray(x), key)))
    want, wgrads = loss_and_grads(jp)
    loss, grads = _loss_and_grads(layer, jp, x, jax_noise(layer, key, x))
    close(loss, want)
    for k in jp:
        close(grads[k], wgrads[k], msg=k)
    return layer, jlayer, jp


@pytest.mark.parametrize("corruption,sparsity,loss", [
    (0.0, 0.0, "mse"), (0.3, 0.0, "mse"), (0.3, 0.05, "xent")])
def test_autoencoder_loss_and_gradients(corruption, sparsity, loss):
    x = np.random.default_rng(2).uniform(size=(12, 8)).astype(np.float32)
    _check_loss(lambda m: m.AutoEncoder(
        n_in=8, n_out=5, activation="sigmoid", corruption_level=corruption,
        sparsity=sparsity, loss=loss), x)


@pytest.mark.parametrize("hidden,visible,k,sparsity", [
    ("binary", "binary", 1, 0.0), ("binary", "binary", 2, 0.1),
    ("gaussian", "gaussian", 2, 0.0), ("relu", "linear", 1, 0.0),
    ("binary", "gaussian", 1, 0.0)])
def test_rbm_loss_and_gradients(hidden, visible, k, sparsity):
    rng = np.random.default_rng(3)
    x = (rng.uniform(size=(16, 10)) < 0.3).astype(np.float32)
    if visible != "binary":
        x = rng.normal(size=(16, 10)).astype(np.float32)
    _check_loss(lambda m: m.RBM(n_in=10, n_out=6, hidden_unit=hidden,
                                visible_unit=visible, k=k,
                                sparsity=sparsity), x)


@pytest.mark.parametrize("spec,samples", [
    (DISTS[0], 1), (DISTS[0], 2), (DISTS[1], 1), (DISTS[2], 2),
    (DISTS[3], 1), (DISTS[4], 1)],
    ids=lambda v: v["type"] if isinstance(v, dict) else str(v))
def test_vae_loss_and_gradients(spec, samples):
    rng = np.random.default_rng(4)
    x = rng.uniform(size=(9, 5)).astype(np.float32)
    if spec["type"] == "bernoulli":
        x = (x > 0.5).astype(np.float32)
    _check_loss(lambda m: m.VariationalAutoencoder(
        n_in=5, n_out=3, encoder_layer_sizes=(7, 6), decoder_layer_sizes=(6,),
        activation="tanh", pzx_activation="identity",
        reconstruction_distribution=spec, num_samples=samples), x)


def test_rbm_free_energy_and_reconstruction_error():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(8, 6)).astype(np.float32)
    for hidden, visible in (("binary", "binary"), ("gaussian", "gaussian")):
        layer, jlayer, jp = _layer_pair(lambda m: m.RBM(
            n_in=6, n_out=4, hidden_unit=hidden, visible_unit=visible), 6)
        tp = {k: t(v) for k, v in jp.items()}
        close(layer.free_energy(tp, t(x)),
              jlayer.free_energy(jp, jnp.asarray(x)))
        assert np.isclose(layer.reconstruction_error(tp, t(x)),
                          jlayer.reconstruction_error(jp, jnp.asarray(x)),
                          rtol=RTOL, atol=ATOL)


def test_vae_inference_surface():
    """``reconstruction_log_probability`` given JAX's ε,
    ``generate_at_mean_given_z``, ``reconstruction_error`` and the supervised
    forward, against JAX's."""
    x = np.random.default_rng(6).normal(size=(4, 8)).astype(np.float32)
    layer, jlayer, jp = _layer_pair(lambda m: m.VariationalAutoencoder(
        n_in=8, n_out=2, encoder_layer_sizes=(10,), decoder_layer_sizes=(10,),
        activation="tanh", reconstruction_distribution={"type": "gaussian"}),
        8)
    tp = {k: t(v) for k, v in jp.items()}
    key = jax.random.PRNGKey(1)
    log_prob = jax.jit(lambda p: jlayer.reconstruction_log_probability(
        p, jnp.asarray(x), key, num_samples=4))
    want = log_prob(jp)
    got = layer.reconstruction_log_probability(
        tp, t(x), noise=vae_noise(layer, key, 4, samples=4))
    close(got, want, rtol=1e-5, atol=1e-5)
    z = np.random.default_rng(7).normal(size=(3, 2)).astype(np.float32)
    close(layer.generate_at_mean_given_z(tp, z),
          jlayer.generate_at_mean_given_z(jp, z))
    close(layer.reconstruction_error(tp, t(x)),
          jlayer.reconstruction_error(jp, jnp.asarray(x)), atol=1e-5)
    y, _, _ = layer.forward(tp, {}, t(x))
    jy, _, _ = jlayer.forward(jp, {}, jnp.asarray(x), train=False, rng=None)
    close(y, jy)
    gen = layer.generate_random_given_z(tp, z,
                                        torch.Generator().manual_seed(0))
    assert gen.shape == (3, 8) and torch.isfinite(gen).all()


# ---------------------------------------------------------------------------
# pretrain_layer / pretrain on both engines
# ---------------------------------------------------------------------------

def _pretrain_stack(lay, pre):
    return [lay.DenseLayer(n_in=8, n_out=7, activation="tanh"),
            pre.AutoEncoder(n_in=7, n_out=6, activation="sigmoid",
                            corruption_level=0.3, l2=1e-3),
            pre.RBM(n_in=6, n_out=5, k=2, l1=1e-3),
            pre.VariationalAutoencoder(
                n_in=5, n_out=2, encoder_layer_sizes=(6,),
                decoder_layer_sizes=(6,), activation="tanh",
                reconstruction_distribution={"type": "bernoulli"}),
            lay.OutputLayer(n_in=2, n_out=3, activation="softmax")]


@pytest.mark.parametrize("layer_idx,updater", [
    (1, "sgd"), (2, "nesterovs"), (3, "rmsprop"), (3, "adam")])
def test_pretrain_layer_three_steps_given_jax_noise(layer_idx, updater):
    """Three pretrain steps of one layer on the features of the layers
    below: the port's steps take the noise JAX drew from its key."""
    x = np.random.default_rng(8).uniform(size=(16, 8)).astype(np.float32)
    jnet, net = mln_pair(_pretrain_stack, updater=updater, lr=0.05)
    key = jnet._key
    jnet.pretrain_layer(layer_idx, x, epochs=3)
    feats = net._layer_input(layer_idx, x)
    layer = net.layers[layer_idx]
    for _ in range(3):
        key, sub = jax.random.split(key)
        net._pretrain_step(layer_idx, x,
                           jax_noise(layer, sub, feats.numpy()))
    assert net.iteration == jnet.iteration == 3
    close(net._score, float(jnet._score), rtol=1e-4)
    params_close(net.net_params, _np_params(jnet.net_params),
                 adam=updater == "adam")


def test_pretrain_walks_every_pretrain_layer():
    """``pretrain`` trains the pretrain layers alone, in order; without
    corruption an autoencoder's step has no noise, so the two packages'
    params agree after 2 epochs of 2 batches each."""
    rng = np.random.default_rng(9)
    x = rng.uniform(size=(32, 8)).astype(np.float32)

    def build(lay, pre):
        return [pre.AutoEncoder(n_in=8, n_out=6, activation="sigmoid",
                                corruption_level=0.0),
                lay.DenseLayer(n_in=6, n_out=5, activation="tanh"),
                pre.AutoEncoder(n_in=5, n_out=4, activation="sigmoid",
                                corruption_level=0.0, loss="xent"),
                lay.OutputLayer(n_in=4, n_out=2, activation="softmax")]
    jnet, net = mln_pair(build, updater="nesterovs")
    from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
    from deeplearning4j_tpu.datasets.iterators import (
        ListDataSetIterator as JaxList)
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    jnet.pretrain(JaxList([JaxDataSet(x[:16], x[:16]),
                           JaxDataSet(x[16:], x[16:])]), epochs=2)
    before = {k: v.clone() for k, v in net.net_params[1].items()}
    net.pretrain(ListDataSetIterator([DataSet(x[:16], x[:16]),
                                      DataSet(x[16:], x[16:])]), epochs=2)
    assert net.iteration == jnet.iteration == 8
    params_close(net.net_params, _np_params(jnet.net_params))
    for k, v in before.items():
        assert torch.equal(v, net.net_params[1][k])


def _graph_confs():
    confs = []
    for mod, lay, pre, g_cls in ((jax_gc, jax_layers, jax_pre,
                                  jax_network.GlobalConf),
                                 (gc, L, P, network.GlobalConf)):
        confs.append(
            mod.GraphBuilder(g_cls(seed=3, learning_rate=0.05,
                                   updater="nesterovs"))
            .add_inputs("in")
            .add_layer("h", lay.DenseLayer(n_in=6, n_out=5,
                                           activation="tanh"), "in")
            .add_layer("side", lay.DenseLayer(n_in=6, n_out=3,
                                              activation="relu"), "in")
            .add_layer("ae", pre.AutoEncoder(n_in=5, n_out=4,
                                             activation="sigmoid",
                                             corruption_level=0.25), "h")
            .add_layer("vae", pre.VariationalAutoencoder(
                n_in=4, n_out=2, encoder_layer_sizes=(5,),
                decoder_layer_sizes=(5,), activation="tanh"), "ae")
            .add_layer("out", lay.OutputLayer(n_in=2, n_out=3,
                                              activation="softmax",
                                              loss="mcxent"), "vae")
            .add_layer("out2", lay.OutputLayer(n_in=3, n_out=2,
                                               activation="softmax",
                                               loss="mcxent"), "side")
            .set_outputs("out", "out2")
            .build())
    jnet = JaxGraph(confs[0]).init()
    net = ComputationGraph(confs[1], device="cpu").load_jax_params(
        {n: {k: np.asarray(v) for k, v in lp.items()}
         for n, lp in jnet.net_params.items()})
    return jnet, net


@pytest.mark.parametrize("vertex", ["ae", "vae"])
def test_graph_pretrain_layer_given_jax_noise(vertex):
    x = np.random.default_rng(10).uniform(size=(12, 6)).astype(np.float32)
    jnet, net = _graph_confs()
    key = jnet._key
    jnet.pretrain_layer(vertex, x, epochs=3)
    in_name = net.conf.vertex_inputs[vertex][0]
    with torch.no_grad():
        acts, _, _, _ = net._forward_all(net.net_params, net.net_state,
                                         {"in": t(x)}, {}, False,
                                         keep_all=True)
    feats = acts[in_name].numpy()
    layer = net.conf.vertices[vertex].layer_conf()
    for _ in range(3):
        key, sub = jax.random.split(key)
        net._pretrain_step(vertex, [x], jax_noise(layer, sub, feats))
    assert net.iteration == jnet.iteration == 3
    params_close(net.net_params, {n: {k: np.asarray(v) for k, v in lp.items()}
                                  for n, lp in jnet.net_params.items()})


def test_graph_pretrain_visits_pretrain_vertices_only():
    x = np.random.default_rng(11).uniform(size=(12, 6)).astype(np.float32)
    _, net = _graph_confs()
    before = {n: {k: v.clone() for k, v in lp.items()}
              for n, lp in net.net_params.items()}
    net.pretrain(x, epochs=2)
    assert net.iteration == 4
    for n in ("h", "side", "out", "out2"):
        for k, v in before[n].items():
            assert torch.equal(v, net.net_params[n][k])
    for n in ("ae", "vae"):
        assert any(not torch.equal(v, net.net_params[n][k])
                   for k, v in before[n].items())


def test_pretrain_lowers_the_loss_with_the_ports_own_noise():
    x = np.random.default_rng(12).uniform(size=(32, 8)).astype(np.float32)
    _, net = mln_pair(lambda lay, pre: [
        pre.VariationalAutoencoder(
            n_in=8, n_out=2, encoder_layer_sizes=(16,),
            decoder_layer_sizes=(16,), activation="tanh",
            reconstruction_distribution={"type": "bernoulli"}),
        lay.OutputLayer(n_in=2, n_out=2, activation="softmax")],
        updater="adam", lr=0.01)
    layer = net.layers[0]
    noise = layer.draw_noise(t(x), torch.Generator().manual_seed(0))
    before = float(layer.pretrain_loss(net.net_params[0], t(x), noise))
    net.pretrain_layer(0, x, epochs=60)
    after = float(layer.pretrain_loss(net.net_params[0], t(x), noise))
    assert after < before


# ---------------------------------------------------------------------------
# Centre loss
# ---------------------------------------------------------------------------

def _center_build(gradient_check=False):
    def build(lay, pre):
        return [lay.DenseLayer(n_in=4, n_out=6, activation="tanh"),
                pre.CenterLossOutputLayer(n_in=6, n_out=3,
                                          activation="softmax",
                                          loss="mcxent", alpha=0.3,
                                          lambda_=0.05,
                                          gradient_check=gradient_check)]
    return build


@pytest.mark.parametrize("gradient_check", [False, True])
def test_center_loss_step_and_scores(gradient_check):
    """Three SGD ``fit`` steps (features pulled at lambda, centres moved
    at alpha), then ``score`` and ``score_examples`` against JAX's."""
    rng = np.random.default_rng(13)
    x = rng.normal(size=(10, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 10)]
    jnet, net = mln_pair(_center_build(gradient_check), lr=0.1)
    for _ in range(3):
        jnet.fit(x, y)
        net.fit(x, y)
    params_close(net.net_params, _np_params(jnet.net_params))
    assert not torch.allclose(net.net_params[-1]["cL"],
                              torch.zeros_like(net.net_params[-1]["cL"]))
    ds = DataSet(x, y)
    from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
    assert np.isclose(net.score(ds), jnet.score(JaxDataSet(x, y)),
                      rtol=RTOL, atol=ATOL)
    close(net.score_examples(ds, True),
          jnet.score_examples(JaxDataSet(x, y), True))


def test_center_loss_first_gradient():
    rng = np.random.default_rng(14)
    x = rng.normal(size=(10, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 10)]
    jnet, net = mln_pair(_center_build(), lr=0.1)
    jnet.net_params[-1]["cL"] = jnp.asarray(
        rng.normal(size=(3, 6)).astype(np.float32))
    net.load_jax_params(_np_params(jnet.net_params))
    grad_fn = jax.jit(jnet._build_grad_raw())
    jscore, _, jgrads = grad_fn(jnet.net_params, jnet.net_state,
                                jnp.asarray(x), jnp.asarray(y), None, None,
                                jax.random.PRNGKey(0))
    score, grads = net._grad_step(t(x), t(y), None, None,
                                  [[0, 0]] * len(net.layers))
    close(score, jscore)
    for g, w in zip(grads, jgrads):
        for k in w:
            close(g[k], w[k], msg=k)


def test_center_loss_in_a_graph_raises_as_jax():
    g = (gc.GraphBuilder(network.GlobalConf(seed=1)).add_inputs("in")
         .add_layer("out", P.CenterLossOutputLayer(n_in=4, n_out=2), "in")
         .set_outputs("out").build())
    net = ComputationGraph(g, device="cpu").init()
    with pytest.raises(NotImplementedError, match="ComputationGraph"):
        net.fit(np.zeros((2, 4), np.float32), np.eye(2, dtype=np.float32))


# ---------------------------------------------------------------------------
# Conv1D / Subsampling1D
# ---------------------------------------------------------------------------

def _seq_mask(n, t_len, lengths):
    m = np.zeros((n, t_len), np.float32)
    for i, length in enumerate(lengths):
        m[i, :length] = 1.0
    return m


@pytest.mark.parametrize("mode,stride,pad,dilation", [
    ("same", 1, 0, 1), ("same", 2, 0, 1), ("truncate", 1, 1, 1),
    ("truncate", 2, 0, 2)])
@pytest.mark.parametrize("masked", [False, True])
def test_conv1d_forward(mode, stride, pad, dilation, masked):
    rng = np.random.default_rng(15)
    x = rng.normal(size=(3, 11, 4)).astype(np.float32)
    mask = _seq_mask(3, 11, (11, 7, 4)) if masked else None
    layer, jlayer = (m.Convolution1DLayer(
        n_in=4, n_out=5, kernel=3, stride=stride, padding=pad,
        dilation=dilation, convolution_mode=mode, activation="tanh")
        for m in (P, jax_pre))
    jp, _, jt = jlayer.initialize(jax.random.PRNGKey(0),
                                  JaxInputType.recurrent(4, 11))
    tp = {k: t(v) for k, v in jp.items()}
    y, _, m = layer.forward(tp, {}, t(x), mask=None if mask is None
                            else t(mask))
    jy, _, jm = jlayer.forward(jp, {}, jnp.asarray(x), train=False,
                               rng=None, mask=None if mask is None
                               else jnp.asarray(mask))
    close(y, jy)
    assert (m is None) == (jm is None)
    assert layer.output_type(InputType.recurrent(4, 11)).timesteps == \
        jt.timesteps == y.shape[1]


@pytest.mark.parametrize("kind", ["max", "avg", "sum", "pnorm"])
@pytest.mark.parametrize("mode,kernel,stride", [
    ("truncate", 2, 2), ("truncate", 3, 2), ("same", 3, 3)])
@pytest.mark.parametrize("masked", [False, True])
def test_subsampling1d_forward(kind, mode, kernel, stride, masked):
    rng = np.random.default_rng(16)
    x = rng.normal(size=(3, 12, 2)).astype(np.float32)
    mask = _seq_mask(3, 12, (12, 6, 1)) if masked else None
    layer, jlayer = (m.Subsampling1DLayer(
        pooling_type=kind, kernel=kernel, stride=stride,
        convolution_mode=mode, pnorm=3) for m in (P, jax_pre))
    y, _, m = layer.forward({}, {}, t(x), mask=None if mask is None
                            else t(mask))
    jy, _, jm = jlayer.forward({}, {}, jnp.asarray(x), train=False,
                               rng=None, mask=None if mask is None
                               else jnp.asarray(mask))
    close(y, jy)
    if masked:
        close(m, jm)
    else:
        assert m is None and jm is None


def test_conv1d_net_output_and_fit_step():
    rng = np.random.default_rng(17)
    x = rng.normal(size=(4, 10, 3)).astype(np.float32)
    y = np.tile(np.eye(2, dtype=np.float32)[rng.integers(0, 2, 4)][:, None],
                (1, 5, 1))
    jnet, net = mln_pair(lambda lay, pre: [
        pre.Convolution1DLayer(n_in=3, n_out=6, kernel=3,
                               convolution_mode="same", activation="relu"),
        pre.Subsampling1DLayer(kernel=2, stride=2),
        lay.RnnOutputLayer(n_in=6, n_out=2, activation="softmax")],
        input_type=lambda it: it.recurrent(3, 10))
    close(net.output(x), jnet.output(x))
    for _ in range(3):
        jnet.fit(x, y)
        net.fit(x, y)
    params_close(net.net_params, _np_params(jnet.net_params))


# ---------------------------------------------------------------------------
# JAX-written zips of each new layer
# ---------------------------------------------------------------------------

ZIP_NETS = {
    "AutoEncoder": (lambda lay, pre: [
        pre.AutoEncoder(n_in=8, n_out=4, corruption_level=0.2,
                        activation="sigmoid"),
        lay.OutputLayer(n_in=4, n_out=3, activation="softmax")], None, 8),
    "RBM": (lambda lay, pre: [
        pre.RBM(n_in=8, n_out=4, hidden_unit="binary",
                visible_unit="gaussian", k=2),
        lay.OutputLayer(n_in=4, n_out=3, activation="softmax")], None, 8),
    "VariationalAutoencoder": (lambda lay, pre: [
        pre.VariationalAutoencoder(
            n_in=8, n_out=2, encoder_layer_sizes=(5,),
            reconstruction_distribution={"type": "bernoulli"}),
        lay.OutputLayer(n_in=2, n_out=3, activation="softmax")], None, 8),
    "CenterLossOutputLayer": (lambda lay, pre: [
        lay.DenseLayer(n_in=8, n_out=5, activation="tanh"),
        pre.CenterLossOutputLayer(n_in=5, n_out=3, alpha=0.1,
                                  lambda_=0.01)], None, 8),
    "Convolution1DLayer": (lambda lay, pre: [
        pre.Convolution1DLayer(n_in=3, n_out=6, kernel=5),
        lay.RnnOutputLayer(n_in=6, n_out=3, activation="softmax")],
        (3, 10), 10),
    "Subsampling1DLayer": (lambda lay, pre: [
        pre.Subsampling1DLayer(kernel=3, stride=3),
        lay.RnnOutputLayer(n_in=3, n_out=3, activation="softmax")],
        (3, 9), 3),
}


def _zip_entries(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


@pytest.mark.parametrize("name", list(ZIP_NETS))
def test_jax_written_zip_restores_and_rewrites_byte_for_byte(name, tmp_path):
    build, seq, t_out = ZIP_NETS[name]
    rng = np.random.default_rng(18)
    jnet, _ = mln_pair(build, updater="adam", lr=0.01,
                       input_type=None if seq is None else
                       (lambda it: it.recurrent(*seq)))
    if seq is None:
        x = rng.uniform(size=(6, 8)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    else:
        x = rng.normal(size=(6, seq[1], seq[0])).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (6, t_out))]
    jnet.fit(x, y)
    jpath, path = tmp_path / "jax.zip", tmp_path / "port.zip"
    jax_ser.write_model(jnet, jpath)
    net = ser.load_model(jpath, device="cpu")
    assert type(net.layers[0]).__name__ in (name, "DenseLayer")
    assert name in {type(layer).__name__ for layer in net.layers}
    close(net.output(x), jnet.output(x), rtol=1e-5, atol=1e-5)
    ser.write_model(net, path)
    want, got = _zip_entries(jpath), _zip_entries(path)
    for entry in (ser.CONFIG_NAME, ser.COEFFICIENTS_NAME, ser.UPDATER_NAME):
        assert got[entry] == want[entry], entry
