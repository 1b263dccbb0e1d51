"""The port's conv path (deeplearning4j_tpu_torch.ops) held against the JAX
package on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
and its counterpart in the port.  The JAX fused conv runs the Pallas
kernel in interpret mode, as the JAX package's own tests run it here.
Tolerance: rtol = atol = 1e-5 in float32 — both sides accumulate the
same products in float32 in different orders.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import activations as jax_acts
from deeplearning4j_tpu.ops import convolution as jax_conv
from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.ops import activations as acts
from deeplearning4j_tpu_torch.ops import convolution as conv
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import helpers

RTOL = ATOL = 1e-5

# the shape / pad / mode grid of the JAX package's fused-conv parity test
CONV_GRID = [
    ((2, 3, 10, 10), (3, 3), (0, 0), "truncate"),
    ((2, 3, 10, 10), (3, 3), (1, 1), "truncate"),
    ((1, 1, 28, 28), (5, 5), (0, 0), "truncate"),
    ((2, 4, 9, 7), (3, 3), (0, 0), "same"),
    ((2, 2, 8, 8), (2, 2), (0, 0), "same"),  # even kernel: SAME pads high
]
CONV_ACTS = ["identity", "relu", "tanh", "gelu", "hardsigmoid"]


def _conv_inputs(shape, kernel, seed=11, cout=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(cout, shape[1]) + kernel) * 0.2).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    return x, w, b


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _counter(name, op):
    fam = monitor.get_registry().get(name)
    if fam is None:
        return 0.0
    return sum(s["value"] for s in fam.samples() if s["labels"]["op"] == op)


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def _jax_dense_chain(x, w, b, pad, mode, act):
    """The JAX package's dense conv → bias → activation chain (what its
    helper runs when the Pallas tier is off), compiled as one program."""
    return jax_acts.get(act)(jax_conv.conv2d(x, w, b, (1, 1), pad, (1, 1),
                                             mode))


@pytest.mark.parametrize("act", CONV_ACTS)
@pytest.mark.parametrize("shape,kernel,pad,mode", CONV_GRID)
def test_conv_bias_act_parity_with_jax(shape, kernel, pad, mode, act):
    x, w, b = _conv_inputs(shape, kernel)
    jax_fused = np.asarray(pk.fused_conv2d_bias_act(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), pad=pad,
        border_mode=mode, activation=act))
    jax_dense = np.asarray(_jax_dense_chain(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), pad, mode, act))
    ref = ck.conv2d_bias_act_reference(_t(x), _t(w), _t(b), pad, mode, act)
    via_helper = helpers.conv2d_bias_act(_t(x), _t(w), _t(b), (1, 1), pad,
                                         (1, 1), mode, act)
    wrapper = ck.fused_conv2d_bias_act(_t(x), _t(w), _t(b), pad=pad,
                                       border_mode=mode, activation=act)
    assert ref.shape == jax_fused.shape
    np.testing.assert_allclose(ref.numpy(), jax_fused, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(via_helper.numpy(), jax_dense, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(wrapper.numpy(), ref.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(pk.CONV_FUSED_ACTS) + ["softmax"])
def test_activation_parity_with_jax(name):
    # values spanning the kinks and saturation regions of every activation
    x = np.random.default_rng(3).normal(size=(4, 33)).astype(np.float32) * 4
    got = acts.get(name)(_t(x)).numpy()
    want = np.asarray(jax_acts.get(name)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_fused_activation_set_matches_jax():
    assert ck.CONV_FUSED_ACTS == pk.CONV_FUSED_ACTS


def test_kernel_activation_ids_match_source_enum():
    """The wrapper's name → id map agrees with enum Act in the .cu file."""
    src = (ck.CSRC / "conv_bias_act.cu").read_text()
    body = re.search(r"enum Act \{(.*?)\};", src, re.S).group(1)
    enum = [t.split("=")[0].strip() for t in body.split(",") if t.strip()]
    ids = {n[1:].lower(): i for i, n in enumerate(enum)}
    for name, i in ck._CONV_ACT_IDS.items():
        key = "identity" if name == "linear" else name
        assert ids[key] == i, name
    assert "dl4j_conv2d_bias_act_f32" in src


@pytest.mark.parametrize("kind,mode,kernel,stride,pad", [
    ("max", "truncate", (2, 2), (2, 2), (0, 0)),
    ("avg", "truncate", (2, 2), (2, 2), (0, 0)),
    ("max", "same", (3, 3), (2, 2), (0, 0)),
    ("avg", "same", (3, 3), (2, 2), (0, 0)),
    ("max", "truncate", (3, 3), (1, 1), (1, 1)),
    ("sum", "truncate", (2, 2), (1, 1), (0, 0)),
    ("pnorm", "same", (2, 2), (2, 2), (0, 0)),
])
def test_pool_parity_with_jax(kind, mode, kernel, stride, pad):
    x = np.random.default_rng(5).normal(size=(2, 3, 9, 7)).astype(np.float32)
    got = conv.pool2d(_t(x), kind, kernel, stride, pad, mode).numpy()
    want = np.asarray(jax_conv.pool2d(jnp.asarray(x), kind, kernel, stride,
                                      pad, mode))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_strided_conv_parity_and_output_shape():
    x, w, b = _conv_inputs((2, 3, 11, 9), (3, 3), seed=2)
    for mode, pad in (("truncate", (1, 1)), ("same", (0, 0))):
        got = conv.conv2d(_t(x), _t(w), _t(b), (2, 2), pad, (1, 1), mode)
        want = jax_conv.conv2d(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b), (2, 2), pad, (1, 1), mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
        assert tuple(got.shape[2:]) == conv.conv2d_output_shape(
            (11, 9), (3, 3), (2, 2), pad, (1, 1), mode)


# Every batch a main path runs each model at: the serving ladder (1-32) and
# batch 128 for the served models, LeNet's training batch 64, VGG16-224's
# first call, its output() batch and its training batch.
MAIN_PATH_BATCHES = {"lenet": (1, 2, 4, 8, 16, 32, 64, 128),
                     "vgg16_cifar10": (1, 2, 4, 8, 16, 32, 128),
                     "vgg16_224": (1, 8, 128)}


def _model_convs(model, batch):
    """(x_shape, w_shape, pad) of every conv of ``model`` at ``batch``."""
    if model == "lenet":
        return [((batch, 1, 28, 28), (20, 1, 5, 5), (0, 0)),
                ((batch, 20, 12, 12), (50, 20, 5, 5), (0, 0))]
    convs, cin = [], 3
    hw = 32 if model == "vgg16_cifar10" else 224
    for n_convs, ch in [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]:
        for _ in range(n_convs):
            convs.append(((batch, cin, hw, hw), (ch, cin, 3, 3), (1, 1)))
            cin = ch
        hw //= 2
    return convs


MAIN_PATH_CONVS = [(m, n, i) for m, batches in MAIN_PATH_BATCHES.items()
                   for n in batches for i in range(len(_model_convs(m, n)))]


@pytest.mark.parametrize("model,batch,index", MAIN_PATH_CONVS)
def test_gate_accepts_every_served_conv(model, batch, index):
    """Every conv of LeNet, VGG16-CIFAR10 and VGG16-224 at every batch a
    main path runs takes the kernel.  (The library's plan for each of them
    is held to the output and the card's limits on the card, in
    tests/test_torch_gpu.py.)"""
    x_shape, w_shape, pad = _model_convs(model, batch)[index]
    assert ck.conv_fused_supported(x_shape, w_shape, torch.float32,
                                   activation="relu", pad=pad)


_F32 = torch.float32


@pytest.mark.parametrize("x,w,kwargs,accepted", [
    ((2, 3, 16, 16), (4, 3, 3, 3), {}, True),
    ((2, 3, 16, 16), (4, 3, 3, 3), {"stride": (2, 2)}, False),
    ((2, 3, 16, 16), (4, 3, 3, 3), {"dilation": (2, 2)}, False),
    ((2, 3, 16, 16), (4, 3, 3, 3), {"dtype": torch.float64}, False),
    # f16: neither the JAX gate nor the kernel takes it
    ((2, 3, 16, 16), (4, 3, 3, 3), {"dtype": torch.float16}, False),
    ((2, 3, 16, 16), (4, 3, 3, 3), {"activation": "softmax"}, False),
    ((2, 3, 16, 16), (4, 3, 9, 9), {}, False),
    ((2, 3, 16, 16), (4, 3, 7, 8), {}, False),
    ((2, 3, 16, 16), (4, 3, 7, 7), {}, True),
    ((2, 3, 16, 16), (4, 3, 1, 1), {}, True),
    ((2, 3, 2, 2), (4, 3, 3, 3), {}, False),
    ((2, 3, 16, 16), (4, 5, 3, 3), {}, False),
    ((2, 3, 16), (4, 3, 3, 3), {}, False),
    # K = Cin * KH * KW at most 2^30
    ((1, 2 ** 30 // 49, 7, 7), (4, 2 ** 30 // 49, 7, 7), {}, True),
    ((1, 2 ** 30 // 49 + 1, 7, 7), (4, 2 ** 30 // 49 + 1, 7, 7), {}, False),
    # a halo offset from a tile's first image is an int: 8 images of 4x4
    # outputs share a tile at batch 64, one at batch 1
    ((1, 2 ** 23, 6, 6), (4, 2 ** 23, 3, 3), {}, True),
    ((64, 2 ** 23, 6, 6), (4, 2 ** 23, 3, 3), {}, False),
    ((1, 2 ** 21, 40, 40), (4, 2 ** 21, 3, 3), {}, False),
    # at most 2^31 - 1 blocks
    ((2 ** 16, 1, 200, 200), (64, 1, 1, 1), {}, False),
    # bf16: the JAX gate takes it, and so does the kernel's bf16 form
    ((2, 3, 16, 16), (4, 3, 3, 3), {"dtype": torch.bfloat16}, True),
])
def test_gate_rejects_what_the_kernel_does_not_take(x, w, kwargs, accepted):
    kwargs = dict(kwargs)
    dtype = kwargs.pop("dtype", _F32)
    assert ck.conv_fused_supported(x, w, dtype, **kwargs) is accepted


def test_conv_plan_mirror_matches_source_constants():
    """The gate's constants are the .cu source's, the source holds the
    same closed-form limits (supported()), and the C plan's exported
    field list is CONV_PLAN_FIELDS."""
    src = (ck.CSRC / "conv_bias_act.cu").read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert {k: consts[k] for k in ("kMaxK", "kBM", "kBK", "kWRowPad")} == {
        "kMaxK": ck.CONV_MAX_K, "kBM": ck._CONV_BM, "kBK": ck._CONV_BK,
        "kWRowPad": ck._CONV_W_ROW_PAD}
    def body(name):
        return re.search(rf"bool {name}\((.*?)\n\}}", src, re.S).group(1)
    for rule in ("KH > kMaxK", "(1LL << 30)", "pix <= kBM",
                 "(OH + KH - 1) * (OW + KW - 1) > 0x7FFFFFFFLL",
                 "cdiv(Cout, Cout <= 32 ? 32 : 64)"):
        assert rule in body("halo_supported"), rule
    for rule in ("OW != 1", "(1LL << 30)",
                 "Cin) * (OH + KH - 1) * KW > 0x7FFFFFFFLL",
                 "m <= 0x7FFFFFFFLL", "cdiv(Cout, Cout <= 32 ? 32 : 64)"):
        assert rule in body("full_width_supported"), rule
    assert "return halo_supported(N, Cin, KH, KW, Cout, OH, OW) ||\n" \
        "         full_width_supported(N, Cin, KH, KW, Cout, OH, OW);" in \
        body("supported")
    # the plan, the bf16 form's route query and both entry points (f32 and
    # bf16) guard
    assert src.count("if (!supported(N, Cin, KH, KW, Cout, OH, OW))") == 4
    prose = " ".join(re.sub(r"\s*//\s*", " ", src).split())
    fields = re.search(r"as (\d+) ints: ([\w, ]+?)(?: \(grid size\))?\.",
                       prose)
    assert int(fields.group(1)) == len(ck.CONV_PLAN_FIELDS)
    assert tuple(f.strip() for f in fields.group(2).split(",")) == \
        ck.CONV_PLAN_FIELDS
    # the PTX wrappers live in a header the source includes
    text = "".join(f.read_text() for f in ck.CONV_LIBRARY.sources())
    assert "wgmma.mma_async.sync.aligned.m64n" in text
    assert "cp.async" in text


def _tf32(t):
    """Round float32 to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` does: add half of the 13 dropped bits'
    weight to the magnitude, then clear them."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(t):
    hi = _tf32(t)
    return hi, _tf32(t - hi)


# chip_smoke.py's conv tolerance: |y - ref| <= ATOL * max|ref| + RTOL * |ref|
SMOKE_RTOL, SMOKE_ATOL = 1e-4, 1e-5


def _excess(got, ref):
    """Largest |got - ref| over its chip_smoke.py allowance (<= 1 holds)."""
    allow = SMOKE_ATOL * ref.abs().max() + SMOKE_RTOL * ref.abs()
    return float(((got - ref).abs() / allow).max())


@pytest.mark.parametrize("x_shape,w_shape,pad", [
    ((2, 1, 28, 28), (20, 1, 5, 5), 0),       # LeNet conv1: K = 25
    ((2, 20, 12, 12), (50, 20, 5, 5), 0),     # LeNet conv2
    ((2, 64, 8, 8), (64, 64, 3, 3), 1),       # a VGG block's conv
    ((1, 256, 4, 4), (32, 256, 3, 3), 1),     # K = 2,304
])
def test_three_tf32_products_hold_the_kernel_tolerance(x_shape, w_shape,
                                                       pad):
    """The kernel's arithmetic, emulated on the CPU: each operand split
    into TF32 halves, hi = rna(v), lo = rna(v - hi), and the conv summed
    as hi.w_hi + hi.w_lo + lo.w_hi.  It holds to the JAX package's
    lax.conv_general_dilated at chip_smoke.py's tolerance; one TF32
    product per product (hi.w_hi alone) does not, which is why the kernel
    takes three."""
    rng = np.random.default_rng(17)
    N, Cin, H, W = x_shape
    x = rng.normal(size=x_shape).astype(np.float32)
    w = (rng.normal(size=w_shape)
         * np.sqrt(2.0 / (Cin * w_shape[2] * w_shape[3]))).astype(np.float32)
    b = np.zeros(w_shape[0], np.float32)
    xp = np.pad(x, ((0, 0), (0, 0), (pad, pad), (pad, pad)))
    ref = np.asarray(pk._conv_ref_nhwc(
        jnp.asarray(xp.transpose(0, 2, 3, 1)),
        jnp.asarray(w.transpose(2, 3, 1, 0)), jnp.asarray(b[None]),
        "identity")).transpose(0, 3, 1, 2)
    ref = torch.from_numpy(np.ascontiguousarray(ref))
    (x_hi, x_lo), (w_hi, w_lo) = _split(_t(xp)), _split(_t(w))
    for part in (x_hi, x_lo, w_hi, w_lo):       # 10 mantissa bits or fewer
        assert not (part.view(torch.int32) & 0x1FFF).any()
    conv = torch.nn.functional.conv2d
    three = conv(x_hi, w_hi) + conv(x_hi, w_lo) + conv(x_lo, w_hi)
    one = conv(x_hi, w_hi)
    assert _excess(three, ref) <= 1.0
    assert _excess(one, ref) > 1.0


def test_cpu_tensor_takes_dense_chain_and_is_metered():
    x, w, b = _conv_inputs((2, 3, 8, 8), (3, 3), seed=0)
    before = _counter("dl4j_kernel_fallback_total", "conv2d")
    launches = ck.fused_conv2d_bias_act.launches
    helpers.conv2d_bias_act(_t(x), _t(w), _t(b), activation="relu")
    assert _counter("dl4j_kernel_fallback_total", "conv2d") == before + 1
    ck.fused_conv2d_bias_act(_t(x), _t(w), _t(b), activation="relu")
    assert ck.fused_conv2d_bias_act.launches == launches  # no kernel ran


def test_wrapper_never_falls_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on a CUDA device raises
    instead of taking the plain version."""
    x = torch.empty((1, 2, 6, 6), device="meta")
    w = torch.empty((3, 2, 3, 3), device="meta")
    b = torch.empty((3,), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ck.fused_conv2d_bias_act(x, w, b)
    with pytest.raises(ValueError, match="does not take"):
        ck.fused_conv2d_bias_act(torch.zeros(1, 2, 6, 6),
                                 torch.zeros(3, 2, 3, 3), torch.zeros(3),
                                 stride=(2, 2))
