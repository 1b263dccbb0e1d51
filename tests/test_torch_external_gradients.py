"""``backprop_gradient`` / ``apply_gradients`` of both engines against the
JAX package's (``tests/test_external_gradients.py``) on the CPU.

Tolerances, float32 on both sides from the same params: gradients and
input gradients rtol 1e-5, atol 1e-6 (the JAX test's own rule); batch
norm's running statistics and params after ``apply_gradients`` given the
same gradients rtol 1e-5, atol 1e-6 (elementwise arithmetic); the port's
external loop against its own ``fit`` step, and against JAX's external
loop, rtol 1e-4, atol 1e-5 (the JAX test's rule: ε from ``output()`` and
the loss's gradient through the softmax in another order).
"""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf.graph_conf as jax_gc
import deeplearning4j_tpu.nn.conf.layers as jax_layers
import deeplearning4j_tpu.nn.conf.network as jax_network
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import graph_conf as gc
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf import network
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

RTOL, ATOL = 1e-5, 1e-6
LOOP_RTOL, LOOP_ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _mlp_conf(mods, bn=False, reg=False, minimize=True, dropout=None,
              loss="mse", out_act="identity"):
    net_mod, lay = mods
    b = (net_mod.NeuralNetConfiguration.builder().seed(7).learning_rate(0.1)
         .updater("sgd"))
    if reg:
        b = b.regularization(True).l2(0.02).l1(0.005)
    b = b.minimize(minimize).list()
    b = b.layer(lay.DenseLayer(n_in=5, n_out=8, activation="tanh",
                               dropout=dropout))
    if bn:
        b = b.layer(lay.BatchNormalization())
    return b.layer(lay.OutputLayer(n_out=3, activation=out_act,
                                   loss=loss)).build()


def mlp_pair(**kw):
    jnet = JaxNet(_mlp_conf((jax_network, jax_layers), **kw)).init()
    net = MultiLayerNetwork(_mlp_conf((network, L), **kw), device="cpu")
    net.init().load_jax_params(
        [{k: np.asarray(v) for k, v in lp.items()} for lp in jnet.net_params])
    net.load_jax_state([{k: np.asarray(v) for k, v in s.items()}
                        for s in jnet.net_state])
    return jnet, net


def _data(n=6, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 5)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32))


def _mse_eps(out, y):
    return 2.0 * (out - y) / (y.shape[0] * y.shape[1])


@pytest.mark.parametrize("bn", [False, True])
def test_backprop_gradient_matches_jax(bn):
    jnet, net = mlp_pair(bn=bn)
    x, eps = _data(8, seed=0)
    grads, dx = net.backprop_gradient(x, eps)
    jgrads, jdx = jnet.backprop_gradient(x, eps)
    for g, w in zip(grads, jgrads):
        assert set(g) == set(w)
        for k in w:
            close(g[k], w[k], msg=k)
    close(dx, jdx)
    assert dx.shape == x.shape


def test_backprop_gradient_is_autograd_of_the_weighted_output():
    _, net = mlp_pair()
    x, eps = _data(4, seed=2)
    grads, dx = net.backprop_gradient(x, eps)
    params = [{k: v.detach().requires_grad_() for k, v in lp.items()}
              for lp in net.net_params]
    xt = torch.from_numpy(x).requires_grad_()
    out, _, _ = net._forward(params, net.net_state, xt)
    leaves = [v for lp in params for v in lp.values()] + [xt]
    want = torch.autograd.grad((out * torch.from_numpy(eps)).sum(), leaves)
    got = [v for g in grads for v in g.values()] + [dx]
    for g, w in zip(got, want):
        close(g, w.numpy())


def test_train_true_folds_batch_norm_statistics_as_jax():
    jnet, net = mlp_pair(bn=True)
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(32, 5)) * 3 + 2).astype(np.float32)
    eps = rng.normal(size=(32, 3)).astype(np.float32)
    mean0 = net.net_state[1]["mean"].clone()
    net.backprop_gradient(x, eps, train=False)
    assert torch.equal(mean0, net.net_state[1]["mean"])
    grads, dx = net.backprop_gradient(x, eps, train=True)
    jgrads, jdx = jnet.backprop_gradient(x, eps, train=True)
    assert not torch.equal(mean0, net.net_state[1]["mean"])
    for k in ("mean", "var"):
        close(net.net_state[1][k], jnet.net_state[1][k])
    for g, w in zip(grads, jgrads):
        for k in w:
            close(g[k], w[k], msg=k)
    close(dx, jdx)


@pytest.mark.parametrize("reg,minimize", [(False, True), (True, True),
                                          (True, False)])
def test_apply_gradients_matches_jax(reg, minimize):
    """The same gradients (JAX's) through both packages' apply_gradients:
    l1/l2 added, negated when maximizing."""
    jnet, net = mlp_pair(reg=reg, minimize=minimize)
    x, eps = _data(6, seed=3)
    jgrads, _ = jnet.backprop_gradient(x, eps)
    jnet.apply_gradients(jgrads)
    net.apply_gradients([{k: np.asarray(v) for k, v in g.items()}
                         for g in jgrads])
    assert net.iteration == jnet.iteration == 1
    for lp, jlp in zip(net.net_params, jnet.net_params):
        for k in jlp:
            close(lp[k], jlp[k], msg=k)


@pytest.mark.parametrize("reg,minimize", [(False, True), (True, True),
                                          (True, False)])
def test_external_loop_equals_fit(reg, minimize):
    """ε = dMSE/d(output) from ``output()``, then backprop_gradient and
    apply_gradients: one ``fit`` step of the port, and JAX's loop."""
    jnet, ext = mlp_pair(reg=reg, minimize=minimize)
    _, fit = mlp_pair(reg=reg, minimize=minimize)
    x, y = _data(6, seed=4)
    fit.fit(x, y)
    eps = _mse_eps(ext.output(x).numpy(), y)
    grads, _ = ext.backprop_gradient(x, eps)
    ext.apply_gradients(grads)
    jeps = _mse_eps(np.asarray(jnet.output(x)), y)
    jgrads, _ = jnet.backprop_gradient(x, jeps)
    jnet.apply_gradients(jgrads)
    for a, b, j in zip(fit.net_params, ext.net_params, jnet.net_params):
        for k in a:
            close(b[k], a[k].numpy(), LOOP_RTOL, LOOP_ATOL, k)
            close(b[k], j[k], LOOP_RTOL, LOOP_ATOL, k)


def test_external_loop_with_dropout_equals_fit():
    """``train=True`` with the generator where ``fit`` would read it: the
    output of the training forward (``feed_forward(train=True)``, the
    generator rewound after it) gives ε of the softmax xent, and the loop
    then takes ``fit``'s step, its dropout masks included."""
    _, fit = mlp_pair(dropout=0.6, loss="mcxent", out_act="softmax")
    _, ext = mlp_pair(dropout=0.6, loss="mcxent", out_act="softmax")
    rng = np.random.default_rng(6)
    x = rng.normal(size=(6, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    fit.fit(x, y)
    state = ext._generator.get_state()
    out = ext.feed_forward(x, train=True)[-1]
    ext._generator.set_state(state)
    eps = -torch.from_numpy(y) / (out * x.shape[0])
    grads, _ = ext.backprop_gradient(x, eps, train=True)
    ext.apply_gradients(grads)
    for a, b in zip(fit.net_params, ext.net_params):
        for k in a:
            close(b[k], a[k].numpy(), LOOP_RTOL, LOOP_ATOL, k)
    assert torch.equal(ext._generator.get_state(), fit._generator.get_state())


def test_bf16_policy_grads_are_f32():
    jnet, net = mlp_pair()
    net.conf.global_conf.precision = "bfloat16"
    x, eps = _data(4, seed=2)
    grads, dx = net.backprop_gradient(x, eps)
    assert all(v.dtype == torch.float32 for g in grads for v in g.values())
    assert dx.dtype == torch.float32
    jnet.conf.global_conf.precision = "bf16"
    jgrads, _ = jnet.backprop_gradient(x, eps)
    for g, w in zip(grads, jgrads):
        for k in w:
            close(g[k], w[k], rtol=1e-2, atol=1e-2, msg=k)


# ---------------------------------------------------------------------------
# ComputationGraph
# ---------------------------------------------------------------------------

def _graph_conf(mod, lay, g_cls, reg=False, minimize=True, bn=False):
    g = g_cls(seed=3, learning_rate=0.05, updater="sgd", minimize=minimize)
    if reg:
        g.use_regularization, g.l2, g.l1 = True, 0.03, 0.01
    b = (mod.GraphBuilder(g).add_inputs("in", "aux")
         .add_layer("h", lay.DenseLayer(n_in=4, n_out=6, activation="tanh"),
                    "in"))
    h = "h"
    if bn:
        b = b.add_layer("bn", lay.BatchNormalization(), "h")
        h = "bn"
    return (b.add_layer("a", lay.DenseLayer(n_in=2, n_out=3,
                                            activation="relu"), "aux")
            .add_layer("o1", lay.OutputLayer(n_in=6, n_out=2,
                                             activation="identity",
                                             loss="mse"), h)
            .add_layer("o2", lay.OutputLayer(n_in=3, n_out=3,
                                             activation="identity",
                                             loss="mse"), "a")
            .set_outputs("o1", "o2")
            .build())


def graph_pair(**kw):
    jnet = JaxGraph(_graph_conf(jax_gc, jax_layers, jax_network.GlobalConf,
                                **kw)).init()
    net = ComputationGraph(_graph_conf(gc, L, network.GlobalConf, **kw),
                           device="cpu").init()
    net.load_jax_params({n: {k: np.asarray(v) for k, v in lp.items()}
                         for n, lp in jnet.net_params.items()})
    net.load_jax_state({n: {k: np.asarray(v) for k, v in s.items()}
                        for n, s in jnet.net_state.items()})
    return jnet, net


def _graph_data(n=5, seed=2):
    rng = np.random.default_rng(seed)
    return ([rng.normal(size=(n, 4)).astype(np.float32),
             rng.normal(size=(n, 2)).astype(np.float32)],
            [rng.normal(size=(n, 2)).astype(np.float32),
             rng.normal(size=(n, 3)).astype(np.float32)])


@pytest.mark.parametrize("train", [False, True])
def test_graph_backprop_gradient_matches_jax(train):
    jnet, net = graph_pair(bn=True)
    xs, eps = _graph_data(8)
    grads, dxs = net.backprop_gradient(xs, eps, train=train)
    jgrads, jdxs = jnet.backprop_gradient(xs, eps, train=train)
    for n in jgrads:
        for k in jgrads[n]:
            close(grads[n][k], jgrads[n][k], msg=f"{n} {k}")
    for d, jd in zip(dxs, jdxs):
        close(d, jd)
    for k in ("mean", "var"):
        close(net.net_state["bn"][k], jnet.net_state["bn"][k])


@pytest.mark.parametrize("reg,minimize", [(False, True), (True, True),
                                          (True, False)])
def test_graph_external_loop_matches_fit_and_jax(reg, minimize):
    jnet, ext = graph_pair(reg=reg, minimize=minimize)
    _, fit = graph_pair(reg=reg, minimize=minimize)
    xs, ys = _graph_data(5, seed=13)
    from deeplearning4j_tpu_torch.datasets import MultiDataSet
    fit.fit(MultiDataSet(xs, ys))
    outs = ext.output(*xs)
    eps = [_mse_eps(o.numpy(), y) for o, y in zip(outs, ys)]
    grads, _ = ext.backprop_gradient(xs, eps)
    ext.apply_gradients(grads)
    jouts = jnet.output(*xs)
    jeps = [_mse_eps(np.asarray(o), y) for o, y in zip(jouts, ys)]
    jgrads, _ = jnet.backprop_gradient(xs, jeps)
    jnet.apply_gradients(jgrads)
    assert ext.iteration == jnet.iteration == 1
    for n in jnet.net_params:
        for k in jnet.net_params[n]:
            close(ext.net_params[n][k], fit.net_params[n][k].numpy(),
                  LOOP_RTOL, LOOP_ATOL, f"{n} {k}")
            close(ext.net_params[n][k], jnet.net_params[n][k], LOOP_RTOL,
                  LOOP_ATOL, f"{n} {k}")


def test_apply_gradients_leaves_frozen_layers():
    from deeplearning4j_tpu_torch.nn.conf.layers import FrozenLayerConf
    conf = _mlp_conf((network, L))
    conf.layers[0] = FrozenLayerConf.wrap(conf.layers[0])
    net = MultiLayerNetwork(conf, device="cpu").init()
    before = {k: v.clone() for k, v in net.net_params[0].items()}
    x, eps = _data(4)
    grads, _ = net.backprop_gradient(x, eps)
    assert all(g.abs().sum() > 0 for g in grads[0].values())
    net.apply_gradients(grads)
    for k, v in before.items():
        assert torch.equal(v, net.net_params[0][k])
    assert not torch.equal(grads[1]["W"], torch.zeros_like(grads[1]["W"]))


def test_score_is_unchanged_by_backprop_gradient():
    _, net = mlp_pair(bn=True)
    x, y = _data(6)
    s0 = net.score(DataSet(x, y))
    net.backprop_gradient(x, y)
    assert net.score(DataSet(x, y)) == s0
