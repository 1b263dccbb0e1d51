"""The port's flash attention (``ops/cuda_kernels.flash_attention`` and its
three kernels' plain versions) held against the JAX package's Pallas flash
attention on the CPU.

On the CPU the port's wrappers run the plain versions through the same
autograd Function that launches the kernels on the card; the JAX side runs
``pallas_kernels.flash_attention`` and its ``_flash_fwd`` / ``_flash_bwd``
in interpret mode, as ``tests/test_pallas_kernels.py`` does.  Inputs are
drawn with numpy, ``N(0, 0.3^2)`` as in that suite.

Tolerances are that suite's for its kernel: the output (and lse) at
rtol = atol = 2e-4, gradients at rtol = atol = 1e-3 — the same float32 math
with the softmax taken online in 128-key blocks on one side and over whole
rows on the other.

A query row with no live key (a fully masked batch row) is 0 in the port,
with lse = -1e30.  The JAX kernel gives the same lse there, but its output
is the mean of V over the key blocks it visits (each dead score is -1e30,
so the online softmax weighs them equally), a value that depends on its
tiling and that its own backward treats as constant.  Such rows are held
to lse, to 0 on the port's side and to the gradients, which agree; the
JAX output is compared on the rows that have a live key.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck

OUT_TOL, GRAD_TOL = 2e-4, 1e-3

# (B, H, T, D, causal, mask): causal and not, ragged T = 200 and 130, head
# dims 32, 64, 96, key masks (a tail from position 180, random holes, a
# fully masked batch row)
CASES = [
    (1, 2, 256, 64, True, "none"),
    (1, 2, 256, 64, False, "none"),
    (2, 2, 200, 64, True, "tail"),
    (2, 2, 200, 64, False, "tail"),
    (2, 1, 130, 32, False, "holes"),
    (2, 2, 130, 96, True, "none"),
    (2, 2, 200, 32, True, "dead_row"),
    (2, 1, 256, 96, False, "dead_row"),
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU side on one intra-op thread, as in the other parity
    tests: multi-threaded float32 reductions have been seen to vary from
    run to run on a loaded host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, H, T, D, mask, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, H, T, D)).astype(np.float32) * 0.3
                  for _ in range(4))
    km = np.ones((B, T), np.float32)
    if mask == "tail":
        km[:, 180:] = 0.0
    elif mask == "holes":
        km = (rng.random((B, T)) > 0.3).astype(np.float32)
        km[:, 0] = 1.0
    elif mask == "dead_row":
        km[1] = 0.0
    return q, k, v, g, km


def _live_rows(km, causal, T):
    """[B, 1, T] bool: query rows with at least one live key."""
    live = km[:, None, :] > 0
    if causal:
        live = np.tril(np.ones((T, T), bool))[None] & live
        return live.any(axis=-1)[:, None, :]
    return np.broadcast_to(live.any(axis=-1)[:, :, None], (len(km), 1, T))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("B,H,T,D,causal,mask", CASES)
def test_flash_attention_matches_jax(B, H, T, D, causal, mask):
    """``flash_attention`` output and the gradients of <out, G> in q, k, v
    against JAX's ``pallas_kernels.flash_attention`` (its custom_vjp)."""
    q, k, v, g, km = _inputs(B, H, T, D, mask, seed=T + D)
    scale = 1.0 / D ** 0.5

    def jloss(q, k, v):
        return jnp.sum(pk.flash_attention(q, k, v, jnp.asarray(km), causal)
                       * jnp.asarray(g))
    jout = np.asarray(pk.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                         jnp.asarray(km), causal))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))

    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    launches = (ck.flash_forward.launches, ck.flash_dq.launches,
                ck.flash_dkv.launches)
    out = ck.flash_attention(*leaves, _t(km), causal, scale)
    (out * _t(g)).sum().backward()
    # the CPU ran the plain versions: no kernel launch was counted
    assert (ck.flash_forward.launches, ck.flash_dq.launches,
            ck.flash_dkv.launches) == launches

    got = out.detach().numpy()
    live = np.broadcast_to(_live_rows(km, causal, T)[..., None], got.shape)
    np.testing.assert_allclose(got[live], jout[live], rtol=OUT_TOL,
                               atol=OUT_TOL)
    assert (got[~live] == 0).all()
    for a, b in zip(leaves, jgrads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


def _pad_t(a, axis, T_pad):
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, T_pad - a.shape[axis])
    return np.pad(a, widths)


@pytest.mark.parametrize("B,H,T,D,causal,mask", CASES)
def test_flash_kernels_plain_versions_match_jax(B, H, T, D, causal, mask):
    """lse, dq, dk and dv of the three plain versions against the JAX
    kernels ``_flash_fwd`` and ``_flash_bwd``.  Those take T in whole
    128-row blocks, so their inputs are padded along T with masked keys
    and a zero cotangent, as ``flash_attention`` pads them, and cut back:
    a masked key changes no real row and a zero cotangent adds nothing to
    dk or dv."""
    q, k, v, g, km = _inputs(B, H, T, D, mask, seed=3 * T + D)
    scale = 1.0 / D ** 0.5
    Tp = -(-T // 128) * 128
    jq, jk, jv, jg = (jnp.asarray(_pad_t(a, 2, Tp)) for a in (q, k, v, g))
    jkm = jnp.asarray(_pad_t(km, 1, Tp))
    jout, jlse = pk._flash_fwd(jq, jk, jv, jkm, causal=causal, scale=scale)
    jdq, jdk, jdv = pk._flash_bwd(jq, jk, jv, jkm, jout,
                                  jlse, jg, causal=causal, scale=scale)
    jlse = np.asarray(jlse).reshape(B, H, Tp)[..., :T]

    tq, tk, tv, tg, tkm = (_t(a) for a in (q, k, v, g, km))
    out, lse = ck.flash_forward(tq, tk, tv, tkm, causal, scale)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=OUT_TOL, atol=OUT_TOL)
    dead = ~_live_rows(km, causal, T)
    assert (lse.numpy()[np.broadcast_to(dead, lse.shape)] == -1e30).all()
    assert (jlse[np.broadcast_to(dead, jlse.shape)] == -1e30).all()
    # the backward's delta from the JAX output, so that dead rows carry
    # JAX's values there too (they multiply p = 0 in both)
    jo = np.asarray(jout)[:, :, :T]
    delta = _t((g * jo).sum(-1))
    dq = ck.flash_dq(tq, tk, tv, tkm, tg, lse, delta, causal, scale)
    dk, dv = ck.flash_dkv(tq, tk, tv, tkm, tg, lse, delta, causal, scale)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(want)[:, :, :T],
                                   rtol=GRAD_TOL, atol=GRAD_TOL)
    for t in (out, lse, dq, dk, dv):
        assert torch.isfinite(t).all()


def test_flash_backward_has_no_inf_on_dead_rows():
    """The exponent, not the result, is clamped on dead rows: with lse =
    -1e30 an unclamped exp(s - lse) would be inf, and p * (dp - delta)
    would put inf or NaN into dk and dv."""
    q, k, v, g, km = _inputs(2, 2, 128, 32, "dead_row", seed=5)
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    out = ck.flash_attention(*leaves, _t(km), True)
    (out * _t(g)).sum().backward()
    for t in leaves:
        assert torch.isfinite(t.grad).all()
        assert (t.grad[1] == 0).all()     # the dead batch row


@pytest.mark.parametrize("shape,dtype,kv_len,ok", [
    ((2, 2, 128, 32), torch.float32, None, True),
    ((2, 2, 8192, 64), torch.float32, 8192, True),
    ((1, 1, 200, 96), torch.float32, None, True),
    ((1, 1, 130, 128), torch.float32, None, True),
    ((2, 2, 127, 64), torch.float32, None, False),   # below one block
    ((2, 2, 256, 16), torch.float32, None, False),   # head dim < 32
    ((2, 2, 256, 160), torch.float32, None, False),  # beyond the plan
    ((2, 2, 256, 34), torch.float32, None, False),   # D % 4 != 0
    ((2, 2, 256, 64), torch.float64, None, False),
    ((2, 2, 256, 64), torch.float32, 255, False),    # keys != queries
    ((2, 2, 8192, 64), torch.bfloat16, 8192, True),  # the bf16 forms
    ((1, 1, 200, 32), torch.bfloat16, None, True),
    ((2, 2, 127, 64), torch.bfloat16, None, False),
    ((2, 2, 256, 160), torch.bfloat16, None, False),
])
def test_flash_support_predicate(shape, dtype, kv_len, ok):
    """The JAX gate (T >= 128, D >= 32, as long as the queries) and the
    kernels' own limits; JAX's gate agrees wherever the kernels take the
    shape."""
    assert ck.flash_attention_supported(shape, dtype, kv_len) is ok
    if ok:
        assert pk.flash_attention_supported(jnp.zeros(shape))


def test_flash_attention_refuses_what_it_does_not_take():
    q = torch.zeros((1, 1, 64, 32))
    with pytest.raises(ValueError, match="does not take"):
        ck.flash_attention(q, q, q)


@pytest.mark.parametrize("name", ["flash_forward", "flash_dq", "flash_dkv"])
def test_flash_wrappers_refuse_a_mix_of_dtypes(name):
    """q, k, v and dout of one dtype, f32 or bf16, on every device: the
    kernels read raw pointers, so a bf16 tensor must never reach an f32
    form, nor an f32 tensor a bf16 one."""
    q = torch.zeros((1, 1, 128, 32))
    km, lse = torch.ones((1, 128)), torch.zeros((1, 1, 128))
    bf = q.to(torch.bfloat16)
    args = {"flash_forward": (q, bf, q, km, True, 0.1),
            "flash_dq": (bf, bf, bf, km, q, lse, lse, True, 0.1),
            "flash_dkv": (q, q, bf, km, q, lse, lse, True, 0.1)}[name]
    with pytest.raises(ValueError, match="one dtype"):
        getattr(ck, name)(*args)


def _tf32(t):
    """float32 truncated to TF32, its low 13 bits cleared: the backward
    kernels' split, and what the tensor cores read of a register."""
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _three_tf32(a, b):
    """a @ b as the backward kernels multiply on the tensor cores: hi = x
    truncated to TF32, lo = x - hi in f32, which the tensor cores truncate
    to TF32, and the sum a_hi.b_hi + a_hi.b_lo + a_lo.b_hi of exact
    products (float64), rounded to float32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    d = torch.float64
    return (a_hi.to(d) @ b_hi.to(d) + a_hi.to(d) @ b_lo.to(d)
            + a_lo.to(d) @ b_hi.to(d)).to(torch.float32)


def _one_tf32(a, b):
    return (_tf32(a).double() @ _tf32(b).double()).to(torch.float32)


@pytest.mark.parametrize("T,D,causal", [(256, 64, True), (200, 96, False)])
def test_three_tf32_products_hold_the_flash_tolerance(T, D, causal):
    """The backward kernels' arithmetic, emulated on the CPU: S, then dq,
    dk and dv from p and ds formed in f32, in 3xTF32 (dP is a plain f32
    product in the kernels too) holds to the JAX package's ``_flash_bwd``
    at chip_smoke.py's FLASH_TOL (rtol = atol = 1e-5, inputs N(0, 0.5^2)
    as there); with one TF32 product per product it does not, which is why
    the kernels take three."""
    rng = np.random.default_rng(T + D)
    q, k, v, g = (rng.normal(size=(1, 1, T, D)).astype(np.float32) * 0.5
                  for _ in range(4))
    km = np.ones((1, T), np.float32)
    scale = 1.0 / D ** 0.5
    Tp = -(-T // 128) * 128
    jq, jk, jv, jg = (jnp.asarray(_pad_t(a, 2, Tp)) for a in (q, k, v, g))
    jkm = jnp.asarray(_pad_t(km, 1, Tp))
    jout, jlse = pk._flash_fwd(jq, jk, jv, jkm, causal=causal, scale=scale)
    want = [np.array(x)[0, 0, :T] for x in pk._flash_bwd(
        jq, jk, jv, jkm, jout, jlse, jg, causal=causal, scale=scale)]
    lse = _t(np.array(jlse).reshape(1, 1, Tp)[0, 0, :T])
    delta = _t((g * np.asarray(jout)[:, :, :T]).sum(-1)[0, 0])
    tq, tk, tv, tg = (_t(a[0, 0]) for a in (q, k, v, g))
    live = torch.ones((T, T), dtype=torch.bool)
    if causal:
        live = live.tril()

    def grads(mm):
        s = mm(tq, tk.T) * scale
        p = torch.exp(torch.where(live, s - lse[:, None], float("-inf")))
        ds = p * (tg @ tv.T - delta[:, None])
        return mm(ds, tk) * scale, mm(ds.T, tq) * scale, mm(p.T, tg)

    def excess(got):
        return max(float(((a - torch.from_numpy(b)).abs()
                          / (1e-5 + 1e-5 * torch.from_numpy(b).abs())).max())
                   for a, b in zip(got, want))
    assert excess(grads(_three_tf32)) <= 1.0
    assert excess(grads(_one_tf32)) > 1.0


def _tf32_rn(t):
    """float32 rounded to the nearest TF32, ties away from zero (cvt.rna):
    the forward kernel's split."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_rn(t):
    """(hi, lo) as the forward splits and the tensor cores read them: hi
    the nearest TF32, lo = t - hi (exact, either sign) truncated to TF32."""
    hi = _tf32_rn(t)
    return hi, _tf32(t - hi)


def _emulate_forward(q, k, v, scale, causal, three=True):
    """The forward kernel's arithmetic on one head, q, k, v [T, D]: key tiles
    of KT (64 at D <= 64, else 32); S = Q K^T in 3xTF32 (hi.hi and the
    cross products each summed exactly over the tile, then rounded to f32,
    as one accumulator a tile); the online softmax in f32 in the log2
    domain; P V in 3xTF32 with hi.hi summed exactly over each 8 keys and
    rounded to f32 (a fresh accumulator a k-step), added to the rescaled
    running sum in f32, the cross products over the tile.  ``three=False``
    keeps one TF32 product (hi.hi) per product.  -> (out, lse)."""
    T, D = q.shape
    kt = 64 if D <= 64 else 32
    f64 = torch.float64
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    c = torch.tensor(scale, dtype=torch.float32) * log2e
    qh, ql = _split_rn(q)
    m = torch.full((T, 1), float("-inf"))
    l = torch.zeros((T, 1))
    o = torch.zeros((T, D))
    rows = torch.arange(T)[:, None]
    for k0 in range(0, T, kt):
        kk, vv = k[k0:k0 + kt], v[k0:k0 + kt]
        kh, kl = _split_rn(kk)
        s_hh = (qh.to(f64) @ kh.T.to(f64)).float()
        s_x = (qh.to(f64) @ kl.T.to(f64) + ql.to(f64) @ kh.T.to(f64)).float()
        x = (s_hh + s_x) * c if three else s_hh * c
        if causal:
            x = x.masked_fill(torch.arange(k0, k0 + len(kk))[None] > rows,
                              float("-inf"))
        m_new = torch.maximum(m, x.amax(1, keepdim=True))
        mu = torch.where(m_new == float("-inf"), torch.zeros_like(m_new),
                         m_new)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(x - mu)
        l = l * alpha + p.sum(1, keepdim=True)
        m = m_new
        ph, pl = _split_rn(p)
        vh, vl = _split_rn(vv)
        o = o * alpha
        for j in range(0, len(kk), 8):
            o = o + (ph[:, j:j + 8].to(f64) @ vh[j:j + 8].to(f64)).float()
        if three:
            o = o + (ph.to(f64) @ vl.to(f64)
                     + pl.to(f64) @ vh.to(f64)).float()
    ln2 = torch.tensor(0.6931471805599453, dtype=torch.float32)
    return o / l, (m + torch.log2(l)).squeeze(1) * ln2


@pytest.mark.parametrize("T,D,causal", [(256, 64, True), (200, 96, False)])
def test_forward_products_in_three_tf32_hold_the_flash_tolerance(T, D,
                                                                 causal):
    """The forward kernel's arithmetic, emulated on the CPU (S and P V in
    3xTF32 from round-to-nearest splits, the online softmax in f32, P V's
    hi.hi in a fresh accumulator every 8 keys), holds out and lse to the
    JAX package's ``_flash_fwd`` at chip_smoke.py's FLASH_TOL (rtol = atol
    = 1e-5, inputs N(0, 0.5^2) as there); with one TF32 product per product
    it does not."""
    rng = np.random.default_rng(7 * T + D)
    q, k, v = (rng.normal(size=(1, 1, T, D)).astype(np.float32) * 0.5
               for _ in range(3))
    km = np.ones((1, T), np.float32)
    scale = 1.0 / D ** 0.5
    Tp = -(-T // 128) * 128
    jq, jk, jv = (jnp.asarray(_pad_t(a, 2, Tp)) for a in (q, k, v))
    jout, jlse = pk._flash_fwd(jq, jk, jv, jnp.asarray(_pad_t(km, 1, Tp)),
                               causal=causal, scale=scale)
    want = (torch.from_numpy(np.array(jout)[0, 0, :T]),
            torch.from_numpy(np.array(jlse).reshape(Tp)[:T]))
    tq, tk, tv = (_t(a[0, 0]) for a in (q, k, v))

    def excess(got):
        return max(float(((a - b).abs() / (1e-5 + 1e-5 * b.abs())).max())
                   for a, b in zip(got, want))
    assert excess(_emulate_forward(tq, tk, tv, scale, causal)) <= 1.0
    assert excess(_emulate_forward(tq, tk, tv, scale, causal,
                                   three=False)) > 1.0


def test_forward_scratch_plan_matches_the_source():
    """``flash_fwd_scratch_bytes`` mirrors ``Fwd<DPAD>`` of the source: KT
    keys a tile (64 at DPAD 64, 32 at DPAD 128), and a tile of four split
    images of KT x DPAD f32 and KT key biases; at the training shape, 32
    heads of 8,192 keys, 269,484,032 bytes."""
    src = (ck.CSRC / "flash_attention.cu").read_text()
    kt = re.search(r"int KT = DPAD == 64 \? (\d+) : (\d+);", src)
    assert kt and (int(kt.group(1)), int(kt.group(2))) == (64, 32)
    assert "int IMG = KT * DPAD * 4;" in src
    assert "int TILE = 4 * IMG + KT * 4;" in src
    for bh, T, D in ((32, 8192, 64), (4, 200, 32), (4, 130, 96),
                     (1, 256, 128)):
        dpad, tile = (64, 64) if D <= 64 else (128, 32)
        want = bh * -(-T // tile) * (4 * tile * dpad * 4 + 4 * tile)
        assert ck.flash_fwd_scratch_bytes(bh, T, D) == want
    assert ck.flash_fwd_scratch_bytes(32, 8192, 64) == 269_484_032


def _plan_of(src, struct):
    """The body of ``struct <name> { ... };`` in the source."""
    body = re.search(r"struct " + struct + r" \{(.*?)\n\};", src, re.S)
    assert body, struct
    return body.group(1)


@pytest.mark.parametrize("bh,T,D", [(32, 8192, 64), (4, 200, 32),
                                    (4, 130, 96), (1, 257, 128)])
def test_bf16_scratch_plans_match_the_source(bh, T, D):
    """``flash_bf16_plan`` and the bf16 scratch sizes mirror ``FwdB16<DP>``,
    ``DqB16<DP>`` and ``DkvB16<DP>`` of the source: the forward's tiles of
    128 keys at DP 64 (64 at 128) in steps of 64, a tile of K and V^T
    images (KT x DP bf16), KT key biases and a 16-byte flag; dQ's tiles of
    64 keys, one step a tile, a tile of K, V and K^T images, the biases
    and the flag; dK/dV's tiles of 64 queries in steps of 32, a tile of
    four QT x DP bf16 images, lse and delta."""
    src = (ck.CSRC / "flash_attention.cu").read_text()
    fwd, dkv = _plan_of(src, "FwdB16"), _plan_of(src, "DkvB16")
    dq = _plan_of(src, "DqB16")
    assert "int KT = DP == 64 ? 128 : 64;" in fwd
    assert "int NK = 64;" in fwd
    assert "int KIMG = KT * DP * 2;" in fwd
    assert "int TILE = 2 * KIMG + KT * 4 + 16;" in fwd
    assert "int KT = 64;" in dq and "int IMG = KT * DP * 2;" in dq
    assert "int TILE = 3 * IMG + KT * 4 + 16;" in dq
    assert "int QT = 64;" in dkv and "int NQ = 32;" in dkv
    assert "int IMG = QT * DP * 2;" in dkv
    assert "int TILE = 4 * IMG + 2 * QT * 4;" in dkv
    plan = ck.flash_bf16_plan(D)
    dp = 64 if D <= 64 else 128
    assert plan == {"dp": dp, "fwd_tile": 128 if dp == 64 else 64,
                    "fwd_step": 64, "dq_tile": 64, "dq_step": 64,
                    "dkv_tile": 64, "dkv_step": 32}
    kt = plan["fwd_tile"]
    assert ck.flash_fwd_scratch_bytes(bh, T, D, torch.bfloat16) == \
        bh * -(-T // kt) * (2 * kt * dp * 2 + 4 * kt + 16)
    assert ck.flash_dq_scratch_bytes(bh, T, D) == \
        bh * -(-T // 64) * (3 * 64 * dp * 2 + 4 * 64 + 16)
    assert ck.flash_dkv_scratch_bytes(bh, T, D) == \
        bh * -(-T // 64) * (4 * 64 * dp * 2 + 2 * 64 * 4)


def test_library_path_hashes_the_headers_a_source_includes(tmp_path):
    """An edited header, included directly or through another header,
    changes the library's file name, so a stale build is never loaded; the
    flash and conv sources both include the shared tf32 header."""
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// one\n")
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <math.h>\n')
    lib = ck.KernelLibrary(tmp_path / "k.cu", {})
    assert [f.name for f in lib.sources()] == ["k.cu", "a.cuh", "b.cuh"]
    before = lib.path()
    (tmp_path / "b.cuh").write_text("// two\n")
    assert lib.path() != before
    for library in (ck.FLASH_LIBRARY, ck.CONV_LIBRARY):
        assert ck.CSRC / "hopper_tf32.cuh" in library.sources()
