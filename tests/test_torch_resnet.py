"""ResNet through the port's ComputationGraph (``models/resnet.py``), held
against the JAX package's on the CPU.

A thin bottleneck ResNet, built with each package's own ``_conv_bn`` and
``_bottleneck`` (a 3x3 stem of 8 channels, a 3x3/2 max pool padded by 1,
two stages of two bottlenecks of 4 and 8 channels, 16x16 inputs, batch
4), from the same seeded params and running statistics
(``chip_smoke.resnet_weights``):
* ``output()`` and the inference score within rtol = atol = 1e-5;
* the first training step's gradients within twice JAX's own distance
  to a float64 evaluation of the same step (plus 1e-5), in relative
  2-norm, as ``tests/test_torch_keras_import.py`` holds the thin
  VGG16-BN: JAX's float32 gradients of a deep batch-norm net sit far
  from float64;
* after 2 Nesterovs steps the score within 1e-3, each param's update
  within 5e-2 and each running statistic's within 1e-3 in relative
  2-norm (that file's DEEP_* rule).
JAX's relu vertices and max pool take the port's masks and argmax, and
where JAX's own decision differs the pre-activation (or the gap between
the window's two elements) must be within TIE_RTOL of the layer input's
largest magnitude.  A conv whose output only a batch norm reads has a
bias whose gradient is 0 in exact arithmetic: its gradient and update are
rounding noise in both packages, held below ``BN_BIAS_NOISE`` (1e-5) of
the conv weight's instead.

Full width, ``resnet50(64, 64, 3, 10)``: the parameter count equals JAX's
and ``output()`` at batch 2 from the same params agrees within rtol =
atol = 1e-5.
"""

import contextlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import deeplearning4j_tpu.nn.conf.graph_conf as jax_gc
import deeplearning4j_tpu.nn.conf.layers as jax_layers
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.models import resnet as jax_resnet
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.network import GlobalConf as JaxGlobalConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu_torch.datasets import MultiDataSet
from deeplearning4j_tpu_torch.models import resnet as port_resnet
from deeplearning4j_tpu_torch.nn.conf import graph_conf as gc
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.network import GlobalConf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.ops import convolution as conv_ops

OUT_TOL = 1e-5
TIE_RTOL = 1e-3
DEEP_UPDATE_RTOL, DEEP_STATS_RTOL, DEEP_SCORE_RTOL = 5e-2, 1e-3, 1e-3
REPO = Path(__file__).resolve().parent.parent


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


CS = _chip_smoke()


def _thin_conf(rm, gcm, layers, global_cls, inputs_cls, lr=0.01):
    g = global_cls(seed=3, learning_rate=lr, updater="nesterovs",
                   weight_init="relu")
    b = gcm.GraphBuilder(g).add_inputs("in")
    x = rm._conv_bn(b, "stem", "in", 8, (3, 3), (1, 1), padding=(1, 1))
    b.add_layer("stem_pool", layers.SubsamplingLayer(
        pooling_type="max", kernel=(3, 3), stride=(2, 2), padding=(1, 1)), x)
    x = "stem_pool"
    for si, ch in enumerate((4, 8)):
        for bi in range(2):
            stride = (2, 2) if (bi == 0 and si > 0) else (1, 1)
            x = rm._bottleneck(b, f"s{si}b{bi}", x, ch, stride,
                               project=(bi == 0))
    b.add_layer("gap", layers.GlobalPoolingLayer(pooling_type="avg"), x)
    b.add_layer("fc", layers.OutputLayer(n_out=10, activation="softmax",
                                         loss="mcxent"), "gap")
    return (b.set_outputs("fc")
            .set_input_types(inputs_cls.convolutional(16, 16, 3)).build())


def _thin_pair(seed=1):
    net = ComputationGraph(_thin_conf(port_resnet, gc, L, GlobalConf,
                                      InputType), device="cpu").init()
    params, state = CS.resnet_weights(net, seed)
    net.load_jax_params(params).load_jax_state(state)
    jnet = JaxGraph(_thin_conf(jax_resnet, jax_gc, jax_layers, JaxGlobalConf,
                               JaxInputType)).init(
        params={n: {k: jnp.asarray(v) for k, v in lp.items()}
                for n, lp in params.items()})
    jnet.net_state = {n: {k: jnp.asarray(v) for k, v in s.items()}
                      for n, s in state.items()}
    return net, jnet


def _batch(rng, n=4):
    return (rng.normal(size=(n, 3, 16, 16)).astype(np.float32),
            np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)])


def test_thin_resnet_has_the_recipe_shape():
    net, jnet = _thin_pair()
    assert net.order == jnet.order
    assert net.num_params() == jnet.num_params()
    assert CS.bn_fed_convs(net) == {n for n in net.order
                                    if n.endswith("_conv")}
    assert len(CS._pinned_vertices(net)) == 1 + 1 + 4 * 3


def test_thin_resnet_output_and_score_match_jax():
    net, jnet = _thin_pair()
    x, y = _batch(np.random.default_rng(2))
    np.testing.assert_allclose(net.output(x)[0].numpy(),
                               np.asarray(jnet.output(x)[0]),
                               rtol=OUT_TOL, atol=OUT_TOL)
    np.testing.assert_allclose(net.score(MultiDataSet([x], [y])),
                               jnet.score(JaxMDS([x], [y])), rtol=OUT_TOL)


# ---------------------------------------------------------------------------
# Pinning JAX's relu vertices and max pool to the port's decisions
# ---------------------------------------------------------------------------

def _padded(layer, t):
    """``t`` padded with -inf as the max pool pads it."""
    (pt, pb), (pl, pr) = conv_ops.explicit_pads(
        t.shape[2:], tuple(layer.kernel), tuple(layer.stride),
        tuple(layer.padding), (1, 1), layer.convolution_mode)
    return F.pad(t, (pl, pr, pt, pb), value=float("-inf"))


def _pool_index(layer, t):
    return F.max_pool2d(_padded(layer, t), tuple(layer.kernel),
                        tuple(layer.stride), return_indices=True)[1]


@contextlib.contextmanager
def _jax_pinned(net, jnet, kept):
    """JAX's relu vertices and max pools, traced inside, take the port's
    relu masks and argmax (``kept``: the port's recorded outputs)."""
    pins = CS._pinned_vertices(net)

    def relu(keep):
        def forward(params, state, inputs, *, train, rng, masks=None):
            return jnp.where(keep, inputs[0], 0.0), state, None
        return forward

    def pool(layer, idx):
        n, c = idx.shape[:2]

        def forward(params, state, inputs, *, train, rng, masks=None):
            (pt, pb), (pl, pr) = conv_ops.explicit_pads(
                inputs[0].shape[2:], tuple(layer.kernel),
                tuple(layer.stride), tuple(layer.padding), (1, 1),
                layer.convolution_mode)
            xp = jnp.pad(inputs[0], ((0, 0), (0, 0), (pt, pb), (pl, pr)),
                         constant_values=-jnp.inf)
            out = jnp.take_along_axis(xp.reshape(n, c, -1),
                                      jnp.asarray(idx.flatten(2).numpy()),
                                      axis=2)
            return out.reshape(idx.shape), state, None
        return forward
    for name, src in pins.items():
        layer = net.conf.vertices[name].layer_conf()
        jv = jnet.conf.vertices[name]
        if type(layer).__name__ == "ActivationLayer":
            jv.forward = relu(jnp.asarray(kept[src].numpy() > 0))
        else:
            jv.forward = pool(layer, _pool_index(layer, kept[src]))
    jnet._step_fn = None                       # trace with the pins
    try:
        yield
    finally:
        for name in pins:
            del jnet.conf.vertices[name].forward
        jnet._step_fn = None


def _check_near_ties(net, jnet, x, kept, sub):
    """JAX's own training forward against the port's decisions: where a
    relu mask or max-pool argmax differs, the pre-activation or the gap
    is within TIE_RTOL of the layer input's largest magnitude."""
    jouts = {}
    pins = CS._pinned_vertices(net)
    with _recorded_jax(jnet, set(net.conf.vertex_inputs[n][0]
                                 for n in pins), jouts):
        jnet._forward_all(jnet.net_params, jnet.net_state,
                          {"in": jnp.asarray(x)}, {}, True, sub,
                          preout_for=["fc"])
    for name, src in pins.items():
        layer = net.conf.vertices[name].layer_conf()
        h = torch.from_numpy(np.array(jouts[net.conf.vertex_inputs[name][0]]))
        if type(layer).__name__ == "ActivationLayer":
            flips = (kept[src] > 0) != (h > 0)
            gap = h.abs()[flips]
        else:
            idx = _pool_index(layer, kept[src])
            hp = _padded(layer, h)
            own, own_idx = F.max_pool2d(hp, tuple(layer.kernel),
                                        tuple(layer.stride),
                                        return_indices=True)
            routed = hp.flatten(2).gather(2, idx.flatten(2)).view_as(idx)
            flips = own_idx != idx
            gap = (own - routed).abs()[flips]
        if gap.numel():
            assert float(gap.max()) <= TIE_RTOL * float(h.abs().max()), \
                (name, int(flips.sum()), float(gap.max()))


@contextlib.contextmanager
def _recorded_jax(jnet, names, out):
    for name in names:
        jv = jnet.conf.vertices[name]

        def forward(*args, _fwd=jv.forward, _n=name, **kw):
            res = _fwd(*args, **kw)
            out[_n] = res[0]
            return res
        jv.forward = forward
    try:
        yield
    finally:
        for name in names:
            del jnet.conf.vertices[name].forward


def _port_step(net, x, y, kept_out):
    """One port training step; its relu outputs and pool input go into
    ``kept_out``."""
    with CS._RecordedVertexOutputs(
            net, set(CS._pinned_vertices(net).values())) as rec:
        net._fit_batch(MultiDataSet([x], [y]))
    kept_out.update(rec.outputs)


def _assert_bn_bias_noise(net, grads_or_updates, name_of_w):
    """A BN-fed conv's bias gradient (or update) below BN_BIAS_NOISE of
    its weight's, 2-norms."""
    for n in CS.bn_fed_convs(net):
        g = grads_or_updates(n)
        ratio = float(np.linalg.norm(g["b"]) / np.linalg.norm(g[name_of_w]))
        assert ratio <= CS.BN_BIAS_NOISE, (n, ratio)


def test_thin_resnet_first_step_gradients_within_jax_rounding():
    """The first step's gradients, the port's relu masks and argmax in
    the port's float64 evaluation and in JAX's step: the port's within
    twice JAX's own distance to float64 (plus 1e-5)."""
    net, jnet = _thin_pair()
    x, y = _batch(np.random.default_rng(3))
    kept = {}
    with CS._RecordedVertexOutputs(
            net, set(CS._pinned_vertices(net).values())) as rec:
        _, g32 = net._grad_step({"in": torch.from_numpy(x)},
                                [torch.from_numpy(y)], None, None, None)
    kept.update(rec.outputs)
    net64 = ComputationGraph(net.conf, device="cpu")
    p64 = {n: {k: v.double().requires_grad_() for k, v in lp.items()}
           for n, lp in net.net_params.items()}
    s64 = {n: {k: v.double() for k, v in s.items()}
           for n, s in net.net_state.items()}
    pins = CS._pinned_vertices(net)
    for name, src in pins.items():
        v = net64.conf.vertices[name]

        def forward(params, state, inputs, train=False, seed=None,
                    masks=None, _n=name, _src=src):
            layer = net.conf.vertices[_n].layer_conf()
            return (CS._pin(torch, layer, _n, inputs[0], kept[_src].double(),
                            []), state, None)
        v.forward = forward
    try:
        _, pre, _, om = net64._forward_all(
            p64, s64, {"in": torch.from_numpy(x).double()}, {}, True,
            preout_for=["fc"])
        loss = net64._score_of(p64, pre, om, [torch.from_numpy(y).double()],
                               None)
        leaves = [(n, k, v) for n, lp in p64.items() for k, v in lp.items()]
        g64 = torch.autograd.grad(loss, [v for _, _, v in leaves])
    finally:
        for name in pins:
            del net64.conf.vertices[name].forward
    _, sub = jax.random.split(jnet._key)
    _check_near_ties(net, jnet, x, kept, sub)
    with _jax_pinned(net, jnet, kept):
        _, _, jg = jnet._build_grad_raw()(
            jnet.net_params, jnet.net_state, (jnp.asarray(x),),
            (jnp.asarray(y),), None, None, sub)
    noise = CS.bn_fed_convs(net)
    for (n, k, _), b in zip(leaves, g64):
        if n in noise and k == "b":
            continue
        a = g32[n][k].double()
        j = torch.from_numpy(np.array(jg[n][k], np.float64))
        norm = float(torch.linalg.vector_norm(b))
        jax_err = float(torch.linalg.vector_norm(j - b)) / norm
        err = float(torch.linalg.vector_norm(a - j)) / norm
        assert err <= 2 * jax_err + 1e-5, (n, k, err, jax_err)
    _assert_bn_bias_noise(net, lambda n: {k: g32[n][k].numpy()
                                          for k in ("W", "b")}, "W")
    _assert_bn_bias_noise(net, lambda n: {k: np.asarray(jg[n][k])
                                          for k in ("W", "b")}, "W")


def test_thin_resnet_two_nesterovs_steps_match_jax():
    """2 Nesterovs steps (lr 0.01), JAX pinned to the port's relu masks
    and argmax: the score after each step, then every param's and
    running statistic's update by the deep batch-norm rule."""
    net, jnet = _thin_pair()
    rng = np.random.default_rng(4)
    start = {n: {k: v.clone() for k, v in {**net.net_params[n],
                                           **net.net_state[n]}.items()}
             for n in net.order}
    for _ in range(2):
        x, y = _batch(rng)
        kept = {}
        _, sub = jax.random.split(jnet._key)
        _port_step(net, x, y, kept)
        _check_near_ties(net, jnet, x, kept, sub)
        with _jax_pinned(net, jnet, kept):
            jnet.fit(JaxMDS([x], [y]))
        np.testing.assert_allclose(net.score(), float(jnet.score()),
                                   rtol=DEEP_SCORE_RTOL)
    noise = CS.bn_fed_convs(net)
    for n in net.order:
        got = {**net.net_params[n], **net.net_state[n]}
        want = {**jnet.net_params[n], **jnet.net_state[n]}
        assert sorted(got) == sorted(want)
        for k in got:
            a, a0, b = got[k].numpy(), start[n][k].numpy(), np.asarray(
                want[k])
            if n in noise and k == "b":
                continue
            err = np.linalg.norm(a - b) / np.linalg.norm(b - a0)
            rule = (DEEP_STATS_RTOL if k in ("mean", "var")
                    else DEEP_UPDATE_RTOL)
            assert err <= rule, (n, k, err)
    for tree in (lambda n: {k: (net.net_params[n][k] - start[n][k]).numpy()
                            for k in ("W", "b")},
                 lambda n: {k: np.asarray(jnet.net_params[n][k])
                            - start[n][k].numpy() for k in ("W", "b")}):
        _assert_bn_bias_noise(net, tree, "W")


def test_resnet50_full_width_matches_jax():
    """``resnet50(64, 64, 3, 10)``: JAX's parameter count and, from the
    same params and running statistics, its ``output()`` at batch 2."""
    net = port_resnet.resnet50(64, 64, 3, 10, device="cpu").init()
    params, state = CS.resnet_weights(net, 5)
    net.load_jax_params(params).load_jax_state(state)
    jnet = jax_resnet.resnet50(64, 64, 3, 10).init(
        params={n: {k: jnp.asarray(v) for k, v in lp.items()}
                for n, lp in params.items()})
    jnet.net_state = {n: {k: jnp.asarray(v) for k, v in s.items()}
                      for n, s in state.items()}
    assert net.num_params() == jnet.num_params() == 23_555_082
    x = np.random.default_rng(6).normal(size=(2, 3, 64, 64)).astype(
        np.float32)
    got, want = net.output(x)[0].numpy(), np.asarray(jnet.output(x)[0])
    assert float(got.max()) < 0.99          # not a saturated softmax
    np.testing.assert_allclose(got, want, rtol=OUT_TOL, atol=OUT_TOL)


def test_resnet50_published_size():
    """At 224x224 and 1,000 classes: 174 vertices, 53 convs and 53 batch
    norms, 25,583,592 params, 53,120 running statistics."""
    net = port_resnet.resnet50(device="cpu").init()
    assert CS._resnet_checked(net)["n_params"] == CS.RESNET_PARAMS
    assert len(CS.bn_fed_convs(net)) == 53


@pytest.mark.parametrize("batch", [1, 32, 128])
def test_chip_resnet50_conv_shapes_are_the_models(batch):
    """chip_smoke's list of ResNet-50's stride-1 convs is the model's:
    each stride-1 conv vertex's (Cin, H, W, Cout, K, pad), repeats
    included, from the configuration's shape inference; the others are
    the 7 strided convs."""
    net = port_resnet.resnet50(device="cpu")
    types = {"in": InputType.convolutional(224, 224, 3)}
    got, strided = [], 0
    for name in net.order:
        v = net.conf.vertices[name]
        ins = [types[i] for i in net.conf.vertex_inputs[name]]
        types[name] = v.output_type(ins)
        layer = v.layer_conf() if hasattr(v, "layer_conf") else None
        if isinstance(layer, L.ConvolutionLayer):
            if tuple(layer.stride) != (1, 1):
                strided += 1
                continue
            t = ins[0]
            got.append((batch, t.channels, t.height, t.width, layer.n_out,
                        layer.kernel[0], layer.padding[0], "identity"))
    want = CS.conv_shapes("resnet50", batch)
    assert sorted(got) == sorted(want)
    assert (len(want), strided) == (CS.RESNET_KERNEL_CONVS,
                                    CS.RESNET_DENSE_CONVS)
