"""The port's bf16 tier (``ops/dtypes.py`` and its cast points in both
engines) held against the JAX package's on the CPU.

The JAX side runs ``precision("bfloat16")`` with its Pallas dropout forced
in interpret mode (``DL4J_PALLAS_DROPOUT=1``), as its own tests force it,
and its Pallas conv forced (``DL4J_PALLAS_CONV=1``) where nothing is
differentiated: the JAX package's bf16 conv backward fails in its own
recompute (``_conv_vjp_bwd`` differentiates a conv whose result it widens
to f32, and lax's transpose rule then meets a bf16 operand and an f32
cotangent), so its networks train on its dense conv chain here, which is
what they run off a TPU anyway.  The port's CPU wrappers run their plain
versions, and on the CPU the port's layers take the dense conv chain, as
the JAX package's do.  Inputs and params are made with numpy from
seeds.

Rules, each with its reason:
* the plain bf16 conv against JAX's fused conv on bf16: chip_smoke.py's
  bf16 conv rule (equal, or one bf16 ulp apart, or within 1e-5 of the
  output's largest magnitude): both round one f32 sum to bf16, summed in
  other orders; the share of elements that differ is asserted below
  ``CONV_SHARE_DIFFER``;
* bf16 dropout: bit for bit (integer hash, one f32 product, one rounding);
* batch norm's bf16 branches: statistics f32 within 1e-6 relative of
  JAX's; both packages round three times (xn, as the JAX code casts it,
  gamma * xn, the sum: XLA's fused chain keeps every cast), so the
  inference output is bit for bit JAX's, and the training output lies
  within 2^-6 of |gamma xn| + |beta| of it: the batch statistics are
  summed in other orders, which moves xn by a rounding where it lies near
  a bf16 boundary, and a rounding is at most half an ulp, 2^-8 of its
  value;
* a conv -> BN -> conv -> dropout -> dense -> output net restored from a
  JAX-written zip: ``output()`` float32 within ``NET_OUT_REL`` of JAX's
  in relative 2-norm, the step's score within ``NET_SCORE_RTOL`` and its
  update's cosine with JAX's at least 0.98 (JAX's own bf16-against-f32
  rule, tests/test_precision.py:114-128); the thin ResNet's score within
  ``NET_SCORE_RTOL``.  These two are twice the largest that this file's
  cases measured on the CPU (each test's docstring gives its numbers):
  bf16 rounds each layer's output to 8 bits, and the packages round at
  other points (XLA fuses the dense, BN and add chains and rounds once
  where torch rounds each op);
* ``precision`` None or "float32": byte for byte a network without it.
"""

import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf.layers as jax_layers
import deeplearning4j_tpu.nn.conf.network as jax_network
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.models import resnet as jax_resnet
from deeplearning4j_tpu.nn import checkpoint as jax_ckpt
from deeplearning4j_tpu.nn import serialization as jax_ser
from deeplearning4j_tpu.nn.conf import graph_conf as jax_gc
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.gradientcheck import _enable_x64
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.ops import dtypes as jax_dtypes
from deeplearning4j_tpu.ops import normalization as jax_norm
from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.models import resnet as port_resnet
from deeplearning4j_tpu_torch.nn import serialization as ser
from deeplearning4j_tpu_torch.nn.checkpoint import (
    CheckpointListener, read_manifest, resume_from_checkpoint)
from deeplearning4j_tpu_torch.nn.conf import graph_conf as gc
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf import network
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.network import GlobalConf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import dtypes
from deeplearning4j_tpu_torch.ops import normalization as norm
from test_torch_fit import _jax_step_seeds, _numpy_params
from test_torch_resnet import CS, _thin_conf

BF = torch.bfloat16
CONV_SHARE_DIFFER = 0.01
NET_OUT_REL, NET_SCORE_RTOL = 1.8e-2, 2.6e-3
COSINE_MIN = 0.98

CONV_GRID = [
    ((2, 3, 10, 10), (3, 3), (0, 0), "truncate"),
    ((2, 3, 10, 10), (3, 3), (1, 1), "truncate"),
    ((1, 1, 28, 28), (5, 5), (0, 0), "truncate"),
    ((2, 4, 9, 7), (3, 3), (0, 0), "same"),
    ((2, 64, 6, 6), (3, 3), (1, 1), "truncate"),
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def _jax_dropout(monkeypatch):
    """JAX's Pallas dropout in interpret mode."""
    monkeypatch.setenv("DL4J_PALLAS_DROPOUT", "1")


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _bf16_np(t) -> np.ndarray:
    """A bf16 array of either package as float32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("name", sorted(jax_dtypes._NAMED) + [None, "auto"])
def test_policy_names_resolve_as_jax(name):
    """Every name resolves to the policy of the same dtypes; None and
    'auto' are float32 on this CPU in both (the port's auto is float32 on
    any device)."""
    p, j = dtypes.resolve(name), jax_dtypes.resolve(name)
    assert (_name(p.param_dtype), _name(p.compute_dtype),
            _name(p.accum_dtype)) == (np.dtype(j.param_dtype).name,
                                      np.dtype(j.compute_dtype).name,
                                      np.dtype(j.accum_dtype).name)
    assert p.is_mixed == j.is_mixed
    with pytest.raises(ValueError):
        dtypes.resolve("int7")


def test_cast_rules_leave_f64_and_int_leaves_alone():
    """cast_to_compute downcasts float32 leaves only (JAX :35-46), through
    nested dicts, lists and tuples; cast_to_param upcasts compute-dtype
    leaves; cast_to_accum widens floats no wider than the accumulator."""
    p = dtypes.BF16
    tree = {"w": torch.ones((2, 2)), "idx": torch.zeros(3, dtype=torch.int64),
            "check": torch.ones(2, dtype=torch.float64),
            "nested": [torch.ones(1), (torch.ones(1), None)]}
    out = p.cast_to_compute(tree)
    assert out["w"].dtype == BF and out["idx"].dtype == torch.int64
    assert out["check"].dtype == torch.float64
    assert out["nested"][0].dtype == BF and out["nested"][1][0].dtype == BF
    assert out["nested"][1][1] is None
    back = p.cast_to_param(out)
    assert back["w"].dtype == torch.float32
    assert back["check"].dtype == torch.float64
    assert p.cast_to_accum(torch.ones(1, dtype=BF)).dtype == torch.float32
    assert p.cast_to_accum(torch.ones(1, dtype=torch.float64)).dtype == \
        torch.float64
    assert p.cast_to_accum(torch.ones(1, dtype=torch.int64)).dtype == \
        torch.int64
    assert dtypes.FLOAT32.cast_to_compute(tree) is tree
    with _enable_x64():
        jt = {"w": jnp.ones((2, 2), jnp.float32),
              "idx": jnp.zeros((3,), jnp.int32),
              "check": jnp.ones((2,), jnp.float64)}
        jo = jax_dtypes.BF16.cast_to_compute(jt)
        assert {k: np.dtype(v.dtype).name for k, v in jo.items()} == {
            "w": "bfloat16", "idx": "int32", "check": "float64"}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64])
def test_accum_dtype_for_matches_jax(dtype):
    jd = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32,
          torch.float64: jnp.float64}[dtype]
    with _enable_x64():
        assert _name(dtypes.accum_dtype_for(dtype)) == \
            np.dtype(jax_dtypes.accum_dtype_for(jd)).name


@pytest.mark.parametrize("act", ["identity", "relu", "tanh", "gelu"])
@pytest.mark.parametrize("shape,kernel,pad,mode", CONV_GRID)
def test_plain_bf16_conv_against_jax_fused_conv(shape, kernel, pad, mode,
                                                act):
    """The plain bf16 conv (the wrapper's CPU path and the card kernel's
    yardstick) against JAX's Pallas conv on bf16: chip_smoke.py's bf16
    conv rule, and few elements apart."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(6, shape[1]) + kernel)
         * np.sqrt(2.0 / (shape[1] * np.prod(kernel)))).astype(np.float32)
    b = (rng.normal(size=(6,)) * 0.1).astype(np.float32)
    want = pk.fused_conv2d_bias_act(
        *(jnp.asarray(a, jnp.bfloat16) for a in (x, w, b)), pad=pad,
        border_mode=mode, activation=act)
    assert want.dtype == jnp.bfloat16
    xt, wt, bt = (torch.from_numpy(a).to(BF) for a in (x, w, b))
    got = ck.fused_conv2d_bias_act(xt, wt, bt, pad=pad, border_mode=mode,
                                   activation=act)
    assert got.dtype == BF
    rec = CS.bf16_conv_compare(torch, got,
                               torch.from_numpy(_bf16_np(want)).to(BF))
    assert rec["ok"] and rec["share_differ"] <= CONV_SHARE_DIFFER, rec


# The slices of the bf16 halo route at its edges: 7 channels of a 3x3
# (Cin 3: one short slice; Cin 64 and 130: a short last one), 2 of a 5x5
# (Cin 20), 64 of a 1x1 (Cin 96 and 130: a short last one); several
# images a tile, ragged planes.
KERNEL_ORDER_GRID = [
    ((2, 3, 10, 10), (3, 3), (1, 1)),
    ((1, 20, 12, 12), (5, 5), (0, 0)),
    ((2, 96, 7, 7), (1, 1), (0, 0)),
    ((3, 130, 6, 5), (3, 3), (1, 1)),
    ((2, 64, 9, 9), (3, 3), (1, 1)),
]


@pytest.mark.parametrize("shape,kernel,pad", KERNEL_ORDER_GRID)
def test_bf16_conv_in_the_kernels_order_against_jax_fused_conv(shape, kernel,
                                                               pad):
    """The bf16 conv with its sum over K taken as the card kernel takes it
    (``chip_smoke.reordered_conv``, the emulation tools/bf16_rule_probe.py
    sets the bf16 rules from: slices of whole input channels, at most 64 K
    each, each slice's partial apart, the partials added in f32) against
    JAX's Pallas conv on the same bf16 inputs: chip_smoke.py's bf16 conv
    rule, and few elements apart."""
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(6, shape[1]) + kernel)
         * np.sqrt(2.0 / (shape[1] * np.prod(kernel)))).astype(np.float32)
    b = (rng.normal(size=(6,)) * 0.1).astype(np.float32)
    want = pk.fused_conv2d_bias_act(
        *(jnp.asarray(a, jnp.bfloat16) for a in (x, w, b)), pad=pad,
        activation="relu")
    xt, wt, bt = (torch.from_numpy(a).to(BF) for a in (x, w, b))
    assert ck._conv_halo_supported(shape[0], shape[1], *kernel, 6,
                                   *want.shape[2:])
    got = CS.reordered_conv(ck, xt, wt, bt, pad, "truncate", "relu")
    assert got.dtype == BF
    rec = CS.bf16_conv_compare(torch, got,
                               torch.from_numpy(_bf16_np(want)).to(BF))
    assert rec["ok"] and rec["share_differ"] <= CONV_SHARE_DIFFER, rec


# The GEMM route's slices (a 1x1 conv with no padding: 64 input channels a
# slice) at each of ResNet-50's plane sizes, with as many input channels as
# its convs there take, up to 2,048 (32 slices)
KERNEL_ORDER_GEMM_GRID = [
    (1, 64, 56, 56), (1, 256, 56, 56), (1, 512, 28, 28), (2, 1024, 14, 14),
    (1, 2048, 7, 7), (3, 130, 7, 7),
]


@pytest.mark.parametrize("shape", KERNEL_ORDER_GEMM_GRID)
def test_bf16_gemm_route_in_the_kernels_order_against_jax_fused_conv(shape):
    """The GEMM route keeps the halo route's sum (slices of 64 whole input
    channels, each partial apart, the partials added in f32 in slice
    order), so ``chip_smoke.reordered_conv`` is its emulation too: held
    against JAX's Pallas conv on the same bf16 inputs at 1x1 shapes the
    route takes, by chip_smoke.py's bf16 conv rule, few elements apart."""
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(6, shape[1], 1, 1))
         * np.sqrt(2.0 / shape[1])).astype(np.float32)
    b = (rng.normal(size=(6,)) * 0.1).astype(np.float32)
    want = pk.fused_conv2d_bias_act(
        *(jnp.asarray(a, jnp.bfloat16) for a in (x, w, b)), pad=(0, 0),
        activation="relu")
    N, Cin, H, W = shape
    assert ck.conv_bf16_route(N, Cin, H, W, 6, 1, 1, 0, 0) == "gemm"
    xt, wt, bt = (torch.from_numpy(a).to(BF) for a in (x, w, b))
    got = CS.reordered_conv(ck, xt, wt, bt, (0, 0), "truncate", "relu")
    assert got.dtype == BF
    rec = CS.bf16_conv_compare(torch, got,
                               torch.from_numpy(_bf16_np(want)).to(BF))
    assert rec["ok"] and rec["share_differ"] <= CONV_SHARE_DIFFER, rec


@pytest.mark.parametrize("model", ["lenet", "vgg16_cifar10", "vgg16_224",
                                   "resnet50"])
@pytest.mark.parametrize("batch", [1, 8, 32, 128])
def test_conv_gate_takes_every_model_conv_and_routes_1x1_to_gemm(model,
                                                                  batch):
    """``conv_fused_supported`` takes every stride-1 conv of the four
    models' forwards in both dtypes, and the bf16 form routes each 1x1
    with no padding to its GEMM route and every other shape to the halo
    route, as ``gemm_route`` in csrc/conv_bias_act.cu decides."""
    for N, Cin, H, W, Cout, K, p, act in CS.conv_shapes(model, batch):
        for dtype in (torch.float32, BF):
            assert ck.conv_fused_supported((N, Cin, H, W), (Cout, Cin, K, K),
                                           dtype, activation=act,
                                           pad=(p, p))
        want = "gemm" if K == 1 and p == 0 else "halo"
        assert ck.conv_bf16_route(N, Cin, H, W, Cout, K, K, p, p) == want


def test_conv_bf16_route_edges():
    """The route at its edges: a padded 1x1 stays on the halo route, a
    filter as wide as the padded input (OW = 1) takes the full-width
    route, a shape no route takes has none."""
    assert ck.conv_bf16_route(2, 64, 14, 14, 96, 1, 1, 1, 1) == "halo"
    assert ck.conv_bf16_route(2, 64, 14, 14, 96, 1, 1, 0, 0) == "gemm"
    assert ck.conv_bf16_route(2, 300, 50, 300, 100, 3, 300, 0, 0) == \
        "full_width"
    assert ck.conv_bf16_route(2, 3, 10, 10, 8, 9, 9, 0, 0) is None


@pytest.mark.parametrize("shape,kernel,pad", KERNEL_ORDER_GRID)
def test_bf16_conv_kernel_order_sums_every_product_once(shape, kernel, pad):
    """On f32 inputs the kernel's order is only an order: the emulation
    equals the plain conv within f32 rounding (1e-5 of outputs of order 1,
    He-scaled weights), where a product summed twice or dropped would move
    an output by ~0.06 or more (each product in exactly one slice)."""
    rng = np.random.default_rng(3)
    fan_in = shape[1] * int(np.prod(kernel))
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(5, shape[1]) + kernel)
                          * np.sqrt(2.0 / fan_in)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(5,)).astype(np.float32))
    got = CS.reordered_conv(ck, x, w, b, pad, "truncate", "identity")
    want = ck.conv2d_bias_act_reference(x, w, b, pad, "truncate", "identity")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,rate", [((64, 128), 0.5), ((7, 1001), 0.8),
                                        ((3, 5, 7, 11), 0.3),
                                        ((4097,), 0.9)])
def test_plain_bf16_dropout_bit_equal_to_jax(shape, rate, _jax_dropout):
    """bf16 dropout, forward and backward, bit for bit JAX's reference and
    its Pallas kernel; its mask the f32 form's."""
    rng = np.random.default_rng(len(shape))
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(5), len(shape))
    words = np.asarray(pk._dropout_seed(key)).reshape(-1)
    jx, jg = (jnp.asarray(a, jnp.bfloat16) for a in (x, g))
    fused, vjp = jax.vjp(lambda a: pk.fused_threshold_dropout(a, rate, key),
                         jx)
    jdx, = vjp(jg)
    ref = pk.threshold_dropout_reference(jx, rate, key)
    xt = torch.from_numpy(x).to(BF).requires_grad_()
    y = ck.fused_threshold_dropout(xt, rate, words)
    y.backward(torch.from_numpy(g).to(BF))
    assert y.dtype == xt.grad.dtype == BF
    np.testing.assert_array_equal(_bf16_np(y), _bf16_np(ref))
    np.testing.assert_array_equal(_bf16_np(y), _bf16_np(fused))
    np.testing.assert_array_equal(_bf16_np(xt.grad), _bf16_np(jdx))
    f32 = ck.threshold_dropout_reference(torch.ones(shape), rate, words)
    assert torch.equal(y != 0, (f32 != 0) & (xt.detach() != 0))


def _bn_close(got, want, gamma, beta, mean, var, x, shape):
    """|got - want| <= 2^-6 (|gamma xn| + |beta|), xn from f32."""
    bshape = (1, -1) if len(shape) == 2 else (1, -1, 1, 1)
    xn = (x - mean.reshape(bshape)) / np.sqrt(var.reshape(bshape) + 1e-5)
    mag = np.abs(gamma.reshape(bshape) * xn) + np.abs(beta.reshape(bshape))
    assert np.all(np.abs(got - want) <= 2.0 ** -6 * mag)


@pytest.mark.parametrize("shape", [(64, 48), (16, 8, 12, 12)])
def test_batch_norm_bf16_branches_match_jax(shape):
    """Training and inference batch norm on bf16 x: statistics float32
    (JAX :17-38), the output bf16 (:41-54)."""
    rng = np.random.default_rng(2)
    x = (rng.normal(size=shape) * 3 + 1.5).astype(np.float32)
    n = shape[1]
    gamma = rng.uniform(0.5, 1.5, n).astype(np.float32)
    beta = rng.normal(size=n).astype(np.float32)
    mean = rng.normal(size=n).astype(np.float32)
    var = rng.uniform(0.5, 2.0, n).astype(np.float32)
    xt, gt, bt = (torch.from_numpy(a).to(BF) for a in (x, gamma, beta))
    mt, vt = torch.from_numpy(mean), torch.from_numpy(var)
    jx, jg, jb = (jnp.asarray(a, jnp.bfloat16) for a in (x, gamma, beta))
    y, m2, v2 = norm.batch_norm_train(xt, gt, bt, mt, vt, decay=0.9)
    jy, jm, jv = jax_norm.batch_norm_train(jx, jg, jb, jnp.asarray(mean),
                                           jnp.asarray(var), decay=0.9)
    assert y.dtype == BF and m2.dtype == v2.dtype == torch.float32
    np.testing.assert_allclose(m2.numpy(), np.asarray(jm), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(v2.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-7)
    bx = _bf16_np(xt)
    axes = (0,) if len(shape) == 2 else (0, 2, 3)
    _bn_close(_bf16_np(y), _bf16_np(jy), gamma, beta, bx.mean(axes),
              bx.var(axes), bx, shape)
    yi = norm.batch_norm_infer(xt, gt, bt, mt, vt)
    jyi = jax_norm.batch_norm_infer(jx, jg, jb, jnp.asarray(mean),
                                    jnp.asarray(var))
    assert yi.dtype == BF
    np.testing.assert_array_equal(_bf16_np(yi), _bf16_np(jyi))
    # f32 x: the branches change nothing
    y32, _, _ = norm.batch_norm_train(torch.from_numpy(x),
                                      torch.from_numpy(gamma),
                                      torch.from_numpy(beta), mt, vt)
    assert y32.dtype == torch.float32


def _bn_net_conf(layers, net, input_type, precision="bfloat16"):
    """conv -> BN -> conv -> dropout -> dense -> output: two 3x3 pad-1
    convs of 8 channels (the first linear, BN, relu), a 2x2 max pool, a
    dense layer of 32 that drops its [64, 128] input at retain 0.5 (the
    dropout kernel's gate), a 10-class softmax; batch 64, Nesterovs."""
    b = (net.NeuralNetConfiguration.builder().seed(11).learning_rate(0.01)
         .updater("nesterovs").weight_init("relu"))
    if precision is not None:
        b = b.precision(precision)
    b = (b.list()
         .layer(layers.ConvolutionLayer(n_out=8, kernel=(3, 3),
                                        padding=(1, 1),
                                        activation="identity"))
         .layer(layers.BatchNormalization(activation="relu"))
         .layer(layers.ConvolutionLayer(n_out=8, kernel=(3, 3),
                                        padding=(1, 1), activation="relu"))
         .layer(layers.SubsamplingLayer(pooling_type="max", kernel=(2, 2),
                                        stride=(2, 2)))
         .layer(layers.DenseLayer(n_out=32, activation="relu", dropout=0.5))
         .layer(layers.OutputLayer(n_out=10, activation="softmax",
                                   loss="mcxent")))
    return b.set_input_type(input_type.convolutional(8, 8, 3)).build()


def _batch(seed, n=64, dims=(3, 8, 8), classes=10):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n,) + dims).astype(np.float32),
            np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)])


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _cosine(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _bn_pair(tmp_path):
    """A bf16 JAX network with numpy-drawn params and running statistics
    off their init, written as a zip and restored by the port."""
    port_shape = MultiLayerNetwork(_bn_net_conf(L, network, InputType),
                                   device="cpu").init()
    params = _numpy_params(port_shape, 3)
    params[1] = {"gamma": np.linspace(0.6, 1.4, 8).astype(np.float32),
                 "beta": np.linspace(-0.2, 0.2, 8).astype(np.float32)}
    jnet = JaxNet(_bn_net_conf(jax_layers, jax_network, JaxInputType)).init(
        params=[{k: jnp.asarray(v) for k, v in lp.items()} for lp in params])
    jnet.net_state[1] = {"mean": jnp.linspace(-0.1, 0.1, 8),
                         "var": jnp.linspace(0.8, 1.2, 8)}
    path = tmp_path / "bn_bf16.zip"
    jax_ser.write_model(jnet, path)
    net = ser.restore_multi_layer_network(path, device="cpu")
    net.load_jax_state([{k: np.asarray(v) for k, v in s.items()}
                        for s in jnet.net_state])
    return net, jnet


def test_bf16_bn_net_from_a_jax_zip_serves_and_trains_as_jax(tmp_path,
                                                            _jax_dropout):
    """The zip's configuration carries precision "bfloat16"; the port's
    ``output`` is float32 within NET_OUT_REL of JAX's; one ``fit`` step
    with JAX's seed words: score within NET_SCORE_RTOL, the update's
    cosine with JAX's at least 0.98; masters, updater state and batch
    norm's statistics float32; ``score()`` after BN works.  Measured on
    the CPU: output 8.97e-3, step score 5.66e-4, cosine 0.99978, score
    after 5.41e-4."""
    net, jnet = _bn_pair(tmp_path)
    assert net.conf.global_conf.precision == "bfloat16"
    x, y = _batch(4)
    out = net.output(x)
    jout = np.asarray(jnet.output(x))
    assert out.dtype == torch.float32 and jout.dtype == np.float32
    assert _rel(out.numpy(), jout) <= NET_OUT_REL
    before = net.params().numpy().copy()
    jbefore = np.asarray(jnet.params()).copy()
    seeds = _jax_step_seeds(jnet)
    jnet.fit(x, y)
    net._fit_batch(DataSet(x, y), seeds=seeds)
    assert abs(net.score() - float(jnet.score())) <= \
        NET_SCORE_RTOL * abs(float(jnet.score()))
    assert _cosine(net.params().numpy() - before,
                   np.asarray(jnet.params()) - jbefore) >= COSINE_MIN
    for tree in (net.net_params, net.opt_states, net.net_state):
        assert all(t.dtype == torch.float32 for t in CS._tensor_leaves(tree))
    np.testing.assert_allclose(
        [s["mean"].numpy() for s in net.net_state if s][0],
        np.asarray(jnet.net_state[1]["mean"]), rtol=1e-3, atol=1e-4)
    s = net.score(DataSet(x, y))
    js = float(jnet.score(JaxDataSet(x, y)))
    assert np.isfinite(s) and abs(s - js) <= NET_SCORE_RTOL * abs(js)


def _thin_graphs(seed=1, precision="bfloat16"):
    net = ComputationGraph(_thin_conf(port_resnet, gc, L, GlobalConf,
                                      InputType), device="cpu").init()
    net.conf.global_conf.precision = precision
    params, state = CS.resnet_weights(net, seed)
    net.load_jax_params(params).load_jax_state(state)
    jconf = _thin_conf(jax_resnet, jax_gc, jax_layers,
                       jax_network.GlobalConf, JaxInputType)
    jconf.global_conf.precision = precision
    jnet = JaxGraph(jconf).init(params={
        n: {k: jnp.asarray(v) for k, v in lp.items()}
        for n, lp in params.items()})
    jnet.net_state = {n: {k: jnp.asarray(v) for k, v in s.items()}
                      for n, s in state.items()}
    return net, jnet


def test_bf16_thin_resnet_graph_scores_as_jax(_jax_dropout):
    """A thin bottleneck ResNet graph (tests/test_torch_resnet.py's) in
    bf16: the inference score within NET_SCORE_RTOL of JAX's, ``output``
    float32, and a training step's score too, running statistics f32.
    Measured on the CPU: 5.81e-4 and 1.26e-3."""
    net, jnet = _thin_graphs()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 3, 16, 16)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 4)]
    s = net.score(MultiDataSet([x], [y]))
    js = float(jnet.score(JaxDataSet(x, y)))
    assert abs(s - js) <= NET_SCORE_RTOL * abs(js), (s, js)
    assert net.output(x)[0].dtype == torch.float32
    jnet.fit(x, y)
    net.fit(x, y)
    assert abs(net.score() - float(jnet.score())) <= \
        NET_SCORE_RTOL * abs(float(jnet.score()))
    assert all(t.dtype == torch.float32
               for t in CS._tensor_leaves(net.net_state))


@pytest.mark.parametrize("precision", [None, "float32", "f32"])
def test_float32_precision_is_byte_identical_to_none(precision):
    """``precision`` None or a float32 name runs exactly the network
    without the field: outputs and a fit step torch.equal."""
    nets = []
    for p in ("absent", precision):
        conf = _bn_net_conf(L, network, InputType,
                            None if p == "absent" else p)
        if p == "absent":
            assert conf.global_conf.precision is None
        net = MultiLayerNetwork(conf, device="cpu").init()
        x, y = _batch(9)
        net._fit_batch(DataSet(x, y), seeds=np.arange(12).reshape(6, 2))
        nets.append((net.output(x), net.params(), net.score()))
    assert torch.equal(nets[0][0], nets[1][0])
    assert torch.equal(nets[0][1], nets[1][1])
    assert nets[0][2] == nets[1][2]


@pytest.mark.parametrize("kw", [
    {"compute": "bfloat16"}, {"p": "bf16"},
    {"compute": "bfloat16", "infer_quant": "int8", "grad_allreduce": "int8"},
    {"infer_quant": "fp8"}])
def test_builder_precision_writes_jax_configuration(kw):
    """``Builder.precision()`` writes the configuration.json that JAX's
    ``Builder.precision()`` writes for the same call."""
    kw = dict(kw)
    p = kw.pop("p", None)

    def conf(layers, net):
        b = net.NeuralNetConfiguration.builder().seed(3)
        b = b.precision(p, **kw) if p is not None else b.precision(**kw)
        return (b.list()
                .layer(layers.DenseLayer(n_in=4, n_out=8, activation="tanh"))
                .layer(layers.OutputLayer(n_out=3, activation="softmax",
                                          loss="mcxent"))
                .build())
    port = json.loads(conf(L, network).to_json())
    jax_conf = json.loads(conf(jax_layers, jax_network).to_json())
    assert port["global"]["precision"] == jax_conf["global"]["precision"]
    assert port == jax_conf


def test_bf16_checkpoint_round_trips_across_packages(tmp_path):
    """A bf16 net's checkpoint manifest records the tier as JAX's does
    (``_precision_meta``, :143-165; null for f32), and a checkpoint either
    package writes restores in the other with its precision and its f32
    masters."""
    conf_kw = dict(compute="bfloat16", infer_quant="int8",
                   grad_allreduce="int8")

    def conf(layers, net):
        return (net.NeuralNetConfiguration.builder().seed(7)
                .learning_rate(0.1).updater("adam").precision(**conf_kw)
                .list()
                .layer(layers.DenseLayer(n_in=8, n_out=16,
                                         activation="relu"))
                .layer(layers.OutputLayer(n_out=3, activation="softmax",
                                          loss="mcxent"))
                .build())
    x, y = _batch(5, n=32, dims=(8,), classes=3)
    net = MultiLayerNetwork(conf(L, network), device="cpu").init()
    net.set_listeners(CheckpointListener(tmp_path / "port",
                                         save_every_n_iterations=1))
    net.fit(x, y)
    meta = read_manifest(tmp_path / "port")[-1]["precision"]
    assert meta == {"compute": "bfloat16", "infer_quant": "int8",
                    "grad_quant": "int8"}
    jres = jax_ckpt.resume_from_checkpoint(tmp_path / "port")
    assert jres.conf.global_conf.precision == "bfloat16"
    np.testing.assert_array_equal(np.asarray(jres.params()),
                                  net.params().numpy())

    jnet = JaxNet(conf(jax_layers, jax_network)).init()
    jnet.add_listener(jax_ckpt.CheckpointListener(
        str(tmp_path / "jax"), save_every_n_iterations=1))
    jnet.fit(x, y)
    jmeta = jax_ckpt.read_manifest(str(tmp_path / "jax"))[-1]["precision"]
    assert jmeta == meta
    back = resume_from_checkpoint(tmp_path / "jax", device="cpu")
    assert back.conf.global_conf.precision == "bfloat16"
    assert back.net_params[0]["W"].dtype == torch.float32
    np.testing.assert_array_equal(back.params().numpy(),
                                  np.asarray(jnet.params()))
    # an f32 net's manifest keeps null
    f32 = MultiLayerNetwork(_bn_net_conf(L, network, InputType, None),
                            device="cpu").init()
    f32.set_listeners(CheckpointListener(tmp_path / "f32",
                                         save_every_n_iterations=1))
    f32.fit(*_batch(6))
    assert read_manifest(tmp_path / "f32")[-1]["precision"] is None
    with zipfile.ZipFile(CheckpointListener.last_checkpoint(
            tmp_path / "port")) as z:
        assert json.loads(z.read("configuration.json"))["global"][
            "precision"] == "bfloat16"


def _fallbacks(op: str) -> float:
    from deeplearning4j_tpu_torch import monitor
    return monitor.get_registry().counter(
        "dl4j_kernel_fallback_total", "ops that took the dense torch chain",
        labels=("op",)).labels(op=op).value


def _selected(op: str) -> float:
    from deeplearning4j_tpu_torch import monitor
    return monitor.get_registry().counter(
        "dl4j_kernel_selected_total",
        "ops routed to a hand-written CUDA kernel",
        labels=("op",)).labels(op=op).value


@pytest.mark.parametrize("model", ["char_rnn", "attention_lm"])
def test_lstm_and_attention_select_their_kernels_under_bf16(model):
    """The LSTM step's and flash attention's gates take bf16 (their bf16
    forms, on the CPU their plain versions): under precision("bfloat16")
    both ops are selected in every forward, truncated BPTT's later segments
    included, none falls back, and the network trains and samples, its
    masters and output f32.  The attention net is 64 wide with 2 heads, the
    flash gate's head dim of 32."""
    from deeplearning4j_tpu_torch import models
    V, T = 12, 128
    if model == "char_rnn":
        net = models.char_rnn(V, hidden=16, layers=2, tbptt_length=T // 4,
                              device="cpu")
        op = "lstm_step"
    else:
        net = models.attention_lm(V, width=64, n_heads=2, layers=1,
                                  seq_len=T, device="cpu")
        op = "attention"
    net.conf.global_conf.precision = "bfloat16"
    net.init()
    rng = np.random.default_rng(0)
    idx = rng.integers(0, V, (2, T + 1))
    x = np.eye(V, dtype=np.float32)[idx[:, :-1]]
    y = np.eye(V, dtype=np.float32)[idx[:, 1:]]
    before, selected = _fallbacks(op), _selected(op)
    net.fit(x, y)
    forwards = 4 * 2 if model == "char_rnn" else 1
    assert _selected(op) == selected + forwards
    assert _fallbacks(op) == before and np.isfinite(net.score())
    assert all(t.dtype == torch.float32
               for t in CS._tensor_leaves(net.net_params))
    out = net.output(x)
    assert out.dtype == torch.float32 and out.shape == (2, T, V)
    step = net.rnn_time_step(x[:, :1])
    assert step.dtype == torch.float32
    assert _fallbacks(op) == before


def _selections(tier: str) -> float:
    from deeplearning4j_tpu_torch import monitor
    return monitor.get_registry().counter(
        "dl4j_precision_selected_total",
        "precision tier selections by the engines",
        labels=("tier", "on")).labels(tier=tier, on="true").value


def test_policy_is_resolved_once_a_network():
    """The engines resolve ``precision`` once, as the JAX package resolves
    it once a trace: a bf16 network's selection is metered once over its
    fits and outputs, again only when the field changes, and a None field
    follows the ambient default."""
    net = MultiLayerNetwork(_bn_net_conf(L, network, InputType), device="cpu")
    net.init()
    x, y = _batch(3)
    before = _selections("bf16_train")
    net.fit(x, y)
    net.fit(x, y)
    net.output(x)
    net.score()
    assert _selections("bf16_train") == before + 1
    policy = net._policy()
    assert policy is dtypes.BF16 and net._policy() is policy
    net.conf.global_conf.precision = "float64"
    assert net._policy() is dtypes.FLOAT64
    net.conf.global_conf.precision = None
    assert net._policy() is dtypes.FLOAT32
    dtypes.set_default_policy(dtypes.BF16)
    try:
        assert net._policy() is dtypes.BF16
    finally:
        dtypes.set_default_policy(None)
    assert net._policy() is dtypes.FLOAT32
