"""The port's sequence models in bf16 — the bf16 forms of the LSTM step and
of the three flash kernels (their plain versions, which the CPU runs), and
the char-RNN and attention model under ``precision("bfloat16")`` — held
against the JAX package on the CPU.

The JAX side runs its own Pallas kernels in interpret mode, as its tests
do (``DL4J_PALLAS_LSTM=1``, ``DL4J_PALLAS_FLASH=1``): both take bf16
inputs forward and backward.  Inputs and params are drawn with numpy from
seeds and rounded to bf16 the same way on both sides.

Rules, each with its reason (the numbers measured here are in each test's
docstring):
* a kernel's bf16 outputs (the LSTM step's c' and h'; flash's out, dq, dk
  and dv): both packages compute the same f32 function of the same bf16
  inputs, summed in other orders, and round it once, so an element equals
  JAX's or lies one bf16 ulp from it, or within ``ATOL`` (1e-5) of the
  output's largest magnitude where the ulp is smaller than the f32 sums'
  difference; lse (f32) at the f32 suite's 2e-4;
* the bf16 flash kernels' arithmetic as ``tools/bf16_rule_probe.py``
  emulates it (P and dS as hi + lo pairs, sums in the kernels' steps):
  chip_smoke.py's bf16 flash rule, one ulp + 2^-12 of the output's largest
  magnitude, the room the card's truncating sums need;
* the LSTM step's gradients: both differentiate the step's formula in
  bf16, op by op, and round at other points (XLA fuses the elementwise
  chain), so they are held in relative 2-norm (``STEP_GRAD_REL``);
* the small networks (2 x GravesLSTM(16), V = 12; attention 64 wide, 2
  heads, T = 128): outputs, scores, gradients and ``rnn_time_step``
  outputs in relative 2-norm against JAX's, each rule twice the largest
  reading of this file's cases (``NET_*``), as
  ``tests/test_torch_precision.py`` holds its bf16 nets.  Training (RMSProp
  at lr 0.1 over TBPTT segments, Adam's first steps) turns bf16's
  roundings into whole-element moves, so a fit is held by its scores and by
  the cosine of its whole-network move with JAX's (JAX's own bf16 rule,
  tests/test_precision.py:114-128), each at twice the reading's distance.

Under truncated BPTT the port hands every segment its carried state in
bf16 (``MultiLayerNetwork._grad_step``), as ``rnn_time_step`` does in both
packages; the JAX TBPTT step hands later segments the carry it stored in
f32, so their recurrence promotes to f32.  The fit test casts JAX's carry
to bf16 before each segment (a wrapper around its jitted step), so both
run the same function.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import charrnn as jax_charrnn
from deeplearning4j_tpu.nn import serialization as jax_ser
from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch.models import charrnn
from deeplearning4j_tpu_torch.nn import serialization as ser
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck

import test_torch_attention as att
import test_torch_charrnn as chr_
import test_torch_flash as tf

BF = torch.bfloat16
ATOL = 1e-5
LSE_TOL = 2e-4
STEP_GRAD_REL = 0.028
NET_OUT_REL, NET_SCORE_RTOL, NET_GRAD_REL = 0.013, 1.9e-3, 0.063
NET_STEP_OUT_REL = 0.011
# layer 1's query and key gradients of the attention net (its docstring)
ATT_QK_GRAD_REL = 0.25
CHAR_FIT_SCORE_RTOL, CHAR_FIT_COSINE = 0.054, 0.96
ATT_FIT_SCORE_RTOL, ATT_FIT_COSINE = 6.8e-4, 0.89


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, as in the other parity tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_pair(a):
    """The same bf16 numbers for both packages from a float32 array."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(BF)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _ulp(x):
    """The spacing of bf16 numbers at |x| (x float64): 2^(e - 7) for |x|
    in [2^e, 2^(e+1)), the smallest normal's below it."""
    a = np.maximum(np.abs(x), 2.0 ** -126)
    return np.ldexp(1.0, np.frexp(a)[1] - 8)


def _within_one_ulp(got, want, what=""):
    """The bf16 rule: |got - want| <= ulp(want) + ATOL * max|want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    diff = np.abs(got - want)
    allowed = _ulp(want) + ATOL * np.abs(want).max()
    assert (diff <= allowed).all(), (
        f"{what}: {int((diff > allowed).sum())} of {diff.size} elements "
        f"beyond one bf16 ulp; worst {float((diff / allowed).max())}")
    return float((diff > 0).mean())


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / den) if den else \
        float(np.linalg.norm(got))


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if not \
        isinstance(a, torch.Tensor) else a.detach().float().numpy()


# ---------------------------------------------------------------------------
# the LSTM step
# ---------------------------------------------------------------------------

def _lstm_inputs(N, H, seed):
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(N, 4 * H)), rng.normal(size=(N, H)),
              rng.normal(size=(N, H)),
              rng.normal(size=(H, 4 * H)) * H ** -0.5,
              rng.normal(size=(3, H)) * 0.1)
    return [_bf16_pair(a.astype(np.float32)) for a in arrays]


@pytest.mark.parametrize("N,H", [(1, 8), (4, 8), (5, 24), (32, 200),
                                 (3, 64)])
def test_lstm_step_bf16_forward_matches_jax_kernel(N, H):
    """The port's bf16 step (on the CPU its plain version: the five inputs
    upcast, the step in f32, c' and h' rounded once) against JAX's Pallas
    ``fused_lstm_step`` on the same bf16 inputs: bf16 outputs equal or one
    ulp apart (measured: every element equal)."""
    pairs = _lstm_inputs(N, H, seed=N + H)
    got = ck.fused_lstm_step(*(t for t, _ in pairs))
    want = pk.fused_lstm_step(*(j for _, j in pairs))
    for g, w, name in zip(got, want, ("c", "h")):
        assert g.dtype == BF and w.dtype == jnp.bfloat16
        _within_one_ulp(_f32(g), _f32(w), f"{name} at {(N, H)}")


@pytest.mark.parametrize("N,H", [(5, 8), (8, 64)])
def test_lstm_step_bf16_backward_matches_jax(N, H):
    """The step's gradients in all five inputs against ``jax.vjp`` through
    JAX's bf16 Pallas step (whose backward differentiates
    ``_lstm_step_reference`` in bf16, as the port's differentiates
    ``lstm_step_formula``): relative 2-norm at most ``STEP_GRAD_REL``
    (measured at most 0.0138; bf16 rounds each op, and the packages round
    at other points), bf16 gradients on both sides."""
    pairs = _lstm_inputs(N, H, seed=7 * N + H)
    rng = np.random.default_rng(N * H)
    g_c, jg_c = _bf16_pair(rng.normal(size=(N, H)).astype(np.float32))
    g_h, jg_h = _bf16_pair(rng.normal(size=(N, H)).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t, _ in pairs]
    c, h = ck.fused_lstm_step(*leaves)
    grads = torch.autograd.grad((c, h), leaves, (g_c, g_h))
    _, vjp = jax.vjp(pk.fused_lstm_step, *(j for _, j in pairs))
    jgrads = vjp((jg_c, jg_h))
    for name, g, jg in zip(("zx", "h", "c", "rw", "p3"), grads, jgrads):
        assert g.dtype == BF and jg.dtype == jnp.bfloat16, name
        assert _rel(_f32(g), _f32(jg)) <= STEP_GRAD_REL, name


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

# causal and not, T = 128 and a ragged 200, head dims 32 and 64, masked
# keys ("holes") and a fully masked batch row
FLASH_CASES = [
    (1, 2, 128, 64, True, "none"),
    (2, 1, 200, 32, False, "holes"),
    (2, 2, 200, 32, True, "dead_row"),
    (2, 2, 128, 64, False, "dead_row"),
]


def _flash_inputs(B, H, T, D, mask, seed):
    """``tests/test_torch_flash.py``'s inputs, q, k, v, dout in bf16."""
    q, k, v, g, km = tf._inputs(B, H, T, D, mask, seed)
    return [_bf16_pair(a) for a in (q, k, v, g)], km


@pytest.mark.parametrize("B,H,T,D,causal,mask", FLASH_CASES)
def test_flash_bf16_plain_versions_match_jax(B, H, T, D, causal, mask):
    """The plain forward, dQ and dK/dV on bf16 q, k, v, dout (the CPU path
    of the three bf16 forms) against JAX's ``_flash_fwd`` and
    ``_flash_bwd`` on the same bf16 inputs, padded along T to whole
    128-row blocks with masked keys and a zero cotangent, as
    ``flash_attention`` pads them: out, dq, dk, dv bf16 on both sides and
    equal or one ulp apart (measured: up to 0.42 % of elements differ, by
    one ulp); lse f32 within 2e-4.  JAX's output on a query row with no live
    key is the mean of V over its key blocks; the port's is 0
    (``tests/test_torch_flash.py``), so out is compared on live rows."""
    pairs, km = _flash_inputs(B, H, T, D, mask, seed=5 * T + D)
    (tq, jq), (tk, jk), (tv, jv), (tg, jg) = pairs
    scale = 1.0 / D ** 0.5
    Tp = -(-T // 128) * 128

    def pad(j):
        return jnp.pad(j, [(0, 0), (0, 0), (0, Tp - T), (0, 0)])
    jkm = jnp.asarray(tf._pad_t(km, 1, Tp))
    jout, jlse = pk._flash_fwd(pad(jq), pad(jk), pad(jv), jkm,
                               causal=causal, scale=scale)
    jdq, jdk, jdv = pk._flash_bwd(pad(jq), pad(jk), pad(jv), jkm, jout, jlse,
                                  pad(jg), causal=causal, scale=scale)
    tkm = torch.from_numpy(km)
    out, lse = ck.flash_forward(tq, tk, tv, tkm, causal, scale)
    assert out.dtype == BF and lse.dtype == torch.float32
    assert jout.dtype == jnp.bfloat16
    live = np.broadcast_to(tf._live_rows(km, causal, T)[..., None],
                           out.shape)
    _within_one_ulp(_f32(out)[live], _f32(jout)[:, :, :T][live], "out")
    assert (_f32(out)[~live] == 0).all()
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(jlse).reshape(B, H, Tp)[..., :T],
                               rtol=LSE_TOL, atol=LSE_TOL)
    # delta in f32 from JAX's bf16 output, as _flash_bwd computes it
    delta = ck.flash_delta(tg, torch.from_numpy(
        _f32(jout)[:, :, :T].copy()).to(BF))
    dq = ck.flash_dq(tq, tk, tv, tkm, tg, lse, delta, causal, scale)
    dk, dv = ck.flash_dkv(tq, tk, tv, tkm, tg, lse, delta, causal, scale)
    for name, got, want in (("dq", dq, jdq), ("dk", dk, jdk),
                            ("dv", dv, jdv)):
        assert got.dtype == BF and want.dtype == jnp.bfloat16, name
        _within_one_ulp(_f32(got), _f32(want)[:, :, :T], name)


# chip_smoke.py's rule for a bf16 flash kernel against its plain version:
# the tensor cores truncate as they add, so |y - ref| <= ulp(ref) +
# BF16_FLASH_ATOL max|ref| (2^-12)
BF16_FLASH_ATOL = 2.0 ** -12

# T and D at the edges of the redesigned bf16 forward's blocks (192 query
# rows at D <= 64, in steps of 64 keys) and of dK/dV's (128 keys; tiles of
# 64 queries in steps of 32)
EMULATED_FLASH_CASES = [
    (1, 2, 128, 64, True, "none"),
    (1, 1, 193, 32, False, "holes"),
    (1, 1, 257, 128, True, "none"),
    (2, 1, 200, 64, True, "dead_row"),
]
# the edges of the dQ kernel's plan: 64-key tiles and steps, 128 query rows
# a block, D 32, 64 and 128 (DP 64 and 128), a single query, masked keys
# and a dead row
DQ_EDGE_CASES = [
    (1, 1, 1, 64, False, "none"),
    (1, 2, 63, 32, True, "none"),
    (1, 1, 65, 128, True, "holes"),
    (2, 1, 127, 64, False, "dead_row"),
    (1, 1, 129, 96, True, "holes"),
    (2, 1, 192, 64, True, "dead_row"),
]


@functools.lru_cache(maxsize=None)
def _kernel_emulation():
    """``tools/bf16_rule_probe.py``'s emulation of the bf16 flash kernels'
    arithmetic: {"flash_forward", "flash_dq", "flash_dkv"}."""
    path = Path(__file__).resolve().parent.parent / "tools" / \
        "bf16_rule_probe.py"
    spec = importlib.util.spec_from_file_location("bf16_rule_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._flash_math(split=True)


def _within_flash_rule(got, want, what):
    """|got - want| <= ulp(want) + BF16_FLASH_ATOL * max|want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    diff = np.abs(got - want)
    allowed = _ulp(want) + BF16_FLASH_ATOL * np.abs(want).max()
    assert (diff <= allowed).all(), (
        f"{what}: {int((diff > allowed).sum())} of {diff.size} elements "
        f"beyond the rule; worst {float((diff / allowed).max())}")


@pytest.mark.parametrize("B,H,T,D,causal,mask",
                         EMULATED_FLASH_CASES + DQ_EDGE_CASES)
def test_flash_bf16_kernel_emulation_matches_jax(B, H, T, D, causal, mask):
    """The bf16 kernels' arithmetic as the CPU emulates it (P and dS fed as
    bf16 hi + lo pairs; S and dP summed over 16 of D, P V over the
    forward's 64-key steps, dQ over dQ's 64-key steps, dK and dV over
    dK/dV's 32-query steps) against JAX's ``_flash_fwd`` and ``_flash_bwd`` on the same
    bf16 inputs, run as :func:`test_flash_bf16_plain_versions_match_jax`
    runs them: out, dq, dk and dv by chip_smoke.py's bf16 flash rule, lse
    within LSE_TOL, out compared on live rows."""
    emu = _kernel_emulation()
    pairs, km = _flash_inputs(B, H, T, D, mask, seed=7 * T + D)
    (tq, jq), (tk, jk), (tv, jv), (tg, jg) = pairs
    scale = 1.0 / D ** 0.5
    Tp = -(-T // 128) * 128

    def pad(j):
        return jnp.pad(j, [(0, 0), (0, 0), (0, Tp - T), (0, 0)])
    jkm = jnp.asarray(tf._pad_t(km, 1, Tp))
    jout, jlse = pk._flash_fwd(pad(jq), pad(jk), pad(jv), jkm,
                               causal=causal, scale=scale)
    jdq, jdk, jdv = pk._flash_bwd(pad(jq), pad(jk), pad(jv), jkm, jout, jlse,
                                  pad(jg), causal=causal, scale=scale)
    tkm = torch.from_numpy(km)
    out, lse = emu["flash_forward"](tq, tk, tv, tkm, causal, scale)
    live = np.broadcast_to(tf._live_rows(km, causal, T)[..., None],
                           out.shape)
    assert out.dtype == BF
    _within_flash_rule(_f32(out)[live], _f32(jout)[:, :, :T][live], "out")
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(jlse).reshape(B, H, Tp)[..., :T],
                               rtol=LSE_TOL, atol=LSE_TOL)
    delta = ck.flash_delta(tg, torch.from_numpy(
        _f32(jout)[:, :, :T].copy()).to(BF))
    dq = emu["flash_dq"](tq, tk, tv, tkm, tg, lse, delta, causal, scale)
    dk, dv = emu["flash_dkv"](tq, tk, tv, tkm, tg, lse, delta, causal, scale)
    for name, got, want in (("dq", dq, jdq), ("dk", dk, jdk),
                            ("dv", dv, jdv)):
        assert got.dtype == BF, name
        _within_flash_rule(_f32(got), _f32(want)[:, :, :T], name)


def test_flash_backward_takes_delta_in_f32(monkeypatch):
    """``_FlashAttention.backward`` forms delta = sum(dO * O) in f32 from
    the bf16 dO and O, as ``_flash_bwd`` (:333-334) does: the bf16 form of
    that product and sum would round every term and the sum, and
    ds = p (dP - delta) cancels.  The delta handed to the dQ and dK/dV
    wrappers is f32 and equal to the f32 sum, which the bf16 sum is not."""
    pairs, km = _flash_inputs(1, 2, 128, 64, "none", seed=4)
    q, k, v, g = (t.clone().requires_grad_(i < 3)
                  for i, (t, _) in enumerate(pairs))
    seen = {}
    real_dq = ck.flash_dq

    def spy(q_, k_, v_, km_, dout, lse, delta, causal, scale):
        seen["delta"], seen["dout"] = delta, dout
        return real_dq(q_, k_, v_, km_, dout, lse, delta, causal, scale)
    monkeypatch.setattr(ck, "flash_dq", spy)
    out = ck.flash_attention(q, k, v, torch.from_numpy(km), True)
    out.backward(g)
    delta = seen["delta"]
    assert delta.dtype == torch.float32
    f32 = (g.float() * out.detach().float()).sum(-1)
    assert torch.equal(delta, f32)
    assert not torch.equal((g * out.detach()).sum(-1).float(), f32)
    assert q.grad.dtype == k.grad.dtype == v.grad.dtype == BF


# ---------------------------------------------------------------------------
# the char-RNN in bf16
# ---------------------------------------------------------------------------

def _bf16_char_pair(tmp_path, seed=3):
    """A JAX char-RNN under precision("bfloat16") with numpy params, and
    the port's restored from its zip (which carries the precision)."""
    jnet = chr_._jax_char_rnn(seed)
    jnet.conf.global_conf.precision = "bfloat16"
    jax_ser.write_model(jnet, tmp_path / "jax.zip")
    net = ser.restore_multi_layer_network(tmp_path / "jax.zip",
                                          device="cpu")
    assert net.conf.global_conf.precision == "bfloat16"
    return jnet, net


def test_charrnn_bf16_output_score_and_gradients_match_jax(tmp_path,
                                                           monkeypatch):
    """``output()``, the first segment's score and every param's gradient
    (the carry zero, so both packages run bf16 throughout): relative
    2-norm within ``NET_OUT_REL`` / ``NET_GRAD_REL``, the score within
    ``NET_SCORE_RTOL`` (measured: output 2.8e-3, score 1.3e-5, gradients
    up to 0.0155); the outputs and gradients f32, the LSTM selected."""
    monkeypatch.setenv("DL4J_PALLAS_LSTM", "1")
    jnet, net = _bf16_char_pair(tmp_path)
    x, y, _ = chr_._batch(seed=2)
    sel = chr_._counter("dl4j_kernel_selected_total", "lstm_step")
    got = net.output(x)
    assert chr_._counter("dl4j_kernel_selected_total", "lstm_step") == \
        sel + chr_.LAYERS
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), np.asarray(jnet.output(x))) <= NET_OUT_REL
    xs, ys = x[:, :chr_.TBPTT], y[:, :chr_.TBPTT]
    jscore, _, jgrads = jnet._build_grad_raw()(
        jnet.net_params, jnet.net_state, jnp.asarray(xs), jnp.asarray(ys),
        None, None, jax.random.PRNGKey(0))
    score, grads = net._grad_step(torch.from_numpy(xs), torch.from_numpy(ys),
                                  None, None, None)
    np.testing.assert_allclose(float(score), float(jscore),
                               rtol=NET_SCORE_RTOL)
    for gl, jl in zip(grads, jgrads):
        for k in jl:
            assert gl[k].dtype == torch.float32
            assert _rel(gl[k].numpy(), np.asarray(jl[k])) <= NET_GRAD_REL, k


def _move_cosine(net, jnet, start, skip=()):
    """The cosine of the port's and JAX's whole-network param moves from
    ``start`` (but the params named in ``skip``)."""
    keys = [(i, k) for i, lp in enumerate(start) for k in sorted(lp)
            if k not in skip]
    a = np.concatenate([(net.net_params[i][k].numpy() - start[i][k]).ravel()
                        for i, k in keys]).astype(np.float64)
    b = np.concatenate([(np.asarray(jnet.net_params[i][k]) - start[i][k])
                        .ravel() for i, k in keys]).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _jax_bf16_carry(jnet):
    """JAX's TBPTT step with the stored carry cast to bf16 before each
    segment, as the port's ``_grad_step`` hands it."""
    build = jnet._build_step

    def cast_state(state):
        return [{k: (jax.tree_util.tree_map(
            lambda a: a.astype(jnp.bfloat16), v) if k == "rnn_state" else v)
            for k, v in s.items()} for s in state]

    def wrapped():
        step = build()

        def run(params, state, opts, *rest):
            return step(params, cast_state(state), opts, *rest)
        return run
    jnet._build_step = wrapped
    jnet._step_fn = None
    return jnet


def test_charrnn_bf16_tbptt_fit_matches_jax(tmp_path, monkeypatch):
    """Two minibatches of TBPTT ``fit`` (4 segments of 5, RMSProp at lr
    0.1) in bf16 against JAX's with its carry cast to bf16: the scores
    within ``CHAR_FIT_SCORE_RTOL`` and the whole network's move at a cosine
    of at least ``CHAR_FIT_COSINE`` with JAX's (measured: scores 6.4e-4
    and 0.027, cosine 0.9966 and 0.981 after each minibatch; per tensor the
    moves lie up to 0.25 apart in relative 2-norm: RMSProp divides each
    gradient by its running size, so the small ones' bf16 roundings move
    whole elements, as the f32 fit test's docstring says); masters f32."""
    monkeypatch.setenv("DL4J_PALLAS_LSTM", "1")
    jnet, net = _bf16_char_pair(tmp_path, seed=6)
    _jax_bf16_carry(jnet)
    start = [{k: v.numpy().copy() for k, v in lp.items()}
             for lp in net.net_params]
    jit = jax_charrnn.CharacterIterator(chr_.TEXT, chr_.SEQ, chr_.BATCH,
                                        seed=1)
    it = charrnn.CharacterIterator(chr_.TEXT, chr_.SEQ, chr_.BATCH, seed=1)
    for _ in range(2):
        jnet.fit(jit.next())
        net.fit(it.next())
        np.testing.assert_allclose(net.score(), float(jnet.score()),
                                   rtol=CHAR_FIT_SCORE_RTOL)
        assert _move_cosine(net, jnet, start) >= CHAR_FIT_COSINE
    assert net.iteration == jnet.iteration == 2 * chr_.SEQ // chr_.TBPTT
    assert all(t.dtype == torch.float32
               for lp in net.net_params for t in lp.values())


def test_tbptt_hands_the_lstm_step_bf16_in_every_segment(tmp_path,
                                                         monkeypatch):
    """The repair: a bf16 TBPTT fit over several segments runs (before, the
    second segment met the f32 carry in ``h @ RW`` and raised), and every
    LSTM step of every segment gets zx, h, c, RW and p3 in bf16, none
    falling back; the stored carry is f32."""
    _, net = _bf16_char_pair(tmp_path)
    seen = []
    real = ck._LSTMStep.apply

    def spy(*args):
        seen.append({str(a.dtype) for a in args})
        return real(*args)
    monkeypatch.setattr(ck._LSTMStep, "apply", spy)
    fb = chr_._counter("dl4j_kernel_fallback_total", "lstm_step")
    x, y, _ = chr_._batch(seed=3)
    net.fit(x, y)
    assert net.iteration == chr_.SEQ // chr_.TBPTT
    assert len(seen) == chr_.LAYERS * chr_.SEQ
    assert all(s == {"torch.bfloat16"} for s in seen)
    assert chr_._counter("dl4j_kernel_fallback_total", "lstm_step") == fb
    for s in net.net_state[:chr_.LAYERS]:
        assert all(t.dtype == torch.float32 for t in s["rnn_state"])


def test_charrnn_bf16_rnn_time_step_matches_jax(tmp_path, monkeypatch):
    """Characters fed one at a time through ``rnn_time_step`` (both
    packages cast the carry to bf16 for each call) against JAX's, and
    against the port's own ``output()`` on the same prefix: relative
    2-norm within ``NET_STEP_OUT_REL`` (measured: 2.7e-3 against JAX's;
    the port's own output() within it too)."""
    monkeypatch.setenv("DL4J_PALLAS_LSTM", "1")
    jnet, net = _bf16_char_pair(tmp_path)
    x, _, _ = chr_._batch(seed=5)
    steps = np.concatenate([net.rnn_time_step(x[:, t:t + 1]).numpy()
                            for t in range(chr_.SEQ)], axis=1)
    jsteps = np.concatenate([np.asarray(jnet.rnn_time_step(x[:, t:t + 1]))
                             for t in range(chr_.SEQ)], axis=1)
    assert _rel(steps, jsteps) <= NET_STEP_OUT_REL
    assert _rel(steps, net.output(x).numpy()) <= NET_STEP_OUT_REL


# ---------------------------------------------------------------------------
# the attention model in bf16
# ---------------------------------------------------------------------------

T_ATT = 128


def _bf16_att_pair(seed):
    jnet, net = att._pair(T_ATT, seed=seed)
    jnet.conf.global_conf.precision = "bfloat16"
    net.conf.global_conf.precision = "bfloat16"
    return jnet, net


def test_attention_bf16_output_score_and_gradients_match_jax(monkeypatch):
    """The 2-layer causal attention net at T = 128 (the flash route in
    both, JAX's Pallas flash forced): ``output()``, score and every param's
    gradient but the key bias's (its gradient is rounding noise: the
    softmax ignores a bias shared by a row's keys) in relative 2-norm
    (measured: output 6.4e-3, score 9.3e-4, gradients up to 0.031); two
    flash selections a forward and no fallback.  Layer 1's Wq, Wk and bq
    are held to ``ATT_QK_GRAD_REL`` (measured 0.124): layer 0's output
    passes a sigmoid at a few hundredths, so layer 1's values are near
    equal and its query and key gradients are differences of near-equal
    numbers (``chip_smoke._attention_step_vs_plain``'s docstring); the
    port's f32 step reads 0.096 from JAX's bf16 one there."""
    monkeypatch.setenv("DL4J_PALLAS_FLASH", "1")
    jnet, net = _bf16_att_pair(seed=5)
    x, y, _ = att._batch(T_ATT, seed=2)
    sel = att._counter("dl4j_kernel_selected_total", "attention")
    fb = att._counter("dl4j_kernel_fallback_total", "attention")
    got = net.output(x)
    assert att._counter("dl4j_kernel_selected_total", "attention") - sel == 2
    assert att._counter("dl4j_kernel_fallback_total", "attention") == fb
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), np.asarray(jnet.output(x))) <= NET_OUT_REL
    jscore, _, jgrads = jnet._build_grad_raw()(
        jnet.net_params, jnet.net_state, jnp.asarray(x), jnp.asarray(y),
        None, None, jax.random.PRNGKey(0))
    score, grads = net._grad_step(torch.from_numpy(x), torch.from_numpy(y),
                                  None, None, None)
    np.testing.assert_allclose(float(score), float(jscore),
                               rtol=NET_SCORE_RTOL)
    for gl, jl in zip(grads, jgrads):
        for k in jl:
            assert gl[k].dtype == torch.float32
            if k != "bk":
                rule = ATT_QK_GRAD_REL if gl is grads[1] and \
                    k in ("Wq", "Wk", "bq") else NET_GRAD_REL
                assert _rel(gl[k].numpy(), np.asarray(jl[k])) <= rule, k


def test_attention_bf16_adam_fit_matches_jax(monkeypatch):
    """Three Adam ``fit`` steps at T = 128 in bf16: scores within
    ``ATT_FIT_SCORE_RTOL`` and the whole network's move but bk's at a
    cosine of at least ``ATT_FIT_COSINE`` with JAX's (measured: scores
    3.4e-4, cosine 0.948; per tensor 0.32 apart in relative 2-norm: Adam's
    first steps are lr sign(g) where |g| >> eps, so gradients near 0 that
    round to other signs move whole elements); masters f32."""
    monkeypatch.setenv("DL4J_PALLAS_FLASH", "1")
    jnet, net = _bf16_att_pair(seed=6)
    start = [{k: v.numpy().copy() for k, v in lp.items()}
             for lp in net.net_params]
    for step in range(3):
        x, y, _ = att._batch(T_ATT, seed=10 + step)
        jnet.fit(x, y)
        net.fit(x, y)
        np.testing.assert_allclose(net.score(), float(jnet.score()),
                                   rtol=ATT_FIT_SCORE_RTOL)
    assert _move_cosine(net, jnet, start, skip=("bk",)) >= ATT_FIT_COSINE
    assert all(t.dtype == torch.float32
               for lp in net.net_params for t in lp.values())


def test_attention_bf16_rnn_time_step_matches_jax(monkeypatch):
    """130 characters one at a time through the KV ring in bf16 (no kernel
    in either package) against JAX's, and against the port's ``output()``
    on the whole prefix, which takes the flash route: relative 2-norm
    within ``NET_STEP_OUT_REL`` (measured: at most 5.1e-3)."""
    monkeypatch.setenv("DL4J_PALLAS_FLASH", "1")
    T = 130
    jnet, net = att._pair(T, seed=8)
    jnet.conf.global_conf.precision = "bfloat16"
    net.conf.global_conf.precision = "bfloat16"
    x, _, _ = att._batch(T, seed=3)
    steps = np.concatenate([net.rnn_time_step(x[:, t:t + 1]).numpy()
                            for t in range(T)], axis=1)
    jsteps = np.concatenate([np.asarray(jnet.rnn_time_step(x[:, t:t + 1]))
                             for t in range(T)], axis=1)
    assert _rel(steps, jsteps) <= NET_STEP_OUT_REL
    assert _rel(steps, net.output(x).numpy()) <= NET_STEP_OUT_REL

