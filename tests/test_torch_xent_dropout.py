"""The port's softmax-xent and threshold-dropout tiers held against the JAX
package on the CPU.

On the CPU each wrapper of ``deeplearning4j_tpu_torch.ops.cuda_kernels``
runs its kernel's plain version; the JAX side runs its Pallas kernels in
interpret mode, forced per tier with ``DL4J_PALLAS_DROPOUT=1`` /
``DL4J_PALLAS_XENT=1`` as the JAX package's own tests do.

Tolerances: dropout is bit-identical (``np.array_equal``), forward and
backward — the mask is integer hash arithmetic and a kept element is one
float32 product.  The xent loss and gradient agree at rtol = atol = 1e-5,
the JAX suite's tolerance for its fused kernel
(``tests/test_pallas_kernels.py``): the same float32 math with sums in
another order.
"""

import re
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import helpers as jax_helpers
from deeplearning4j_tpu.ops import losses as jax_losses
from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import helpers
from deeplearning4j_tpu_torch.ops import losses

RTOL = ATOL = 1e-5

DROPOUT_CASES = [((64, 128), 0.5), ((7, 1001), 0.8), ((128, 257), 0.5),
                 ((3, 5, 7, 11), 0.3), ((4097,), 0.9)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU side on one intra-op thread: on a loaded host its
    multi-threaded float32 reductions have been seen to differ from run
    to run by more than these tolerances allow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key_words(seed, i):
    """A per-layer key as the JAX network derives it (``fold_in`` of the
    step key by the layer index) and its two seed words."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), i)
    return key, np.asarray(pk._dropout_seed(key)).reshape(-1)


@pytest.mark.parametrize("shape,rate", DROPOUT_CASES)
def test_dropout_bit_identical_to_jax(shape, rate, monkeypatch):
    monkeypatch.setenv("DL4J_PALLAS_DROPOUT", "1")
    rng = np.random.default_rng(len(shape))
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    key, words = _key_words(5, len(shape))
    assert words[0] != 0 and words[1] != 0
    fused, vjp = jax.vjp(lambda a: pk.fused_threshold_dropout(a, rate, key),
                         jnp.asarray(x))
    jax_dx, = vjp(jnp.asarray(g))
    ref = pk.threshold_dropout_reference(jnp.asarray(x), rate, key)
    np.testing.assert_array_equal(np.asarray(fused), np.asarray(ref))

    xt = torch.from_numpy(x).requires_grad_()
    y = ck.fused_threshold_dropout(xt, rate, words)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(fused))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jax_dx))
    plain = ck.threshold_dropout_reference(torch.from_numpy(x), rate, words)
    np.testing.assert_array_equal(plain.numpy(), np.asarray(ref))
    # above the gate the layers' entry point takes this tier in both
    if ck.dropout_fused_supported(shape, torch.float32):
        got = helpers.dropout(torch.from_numpy(x), rate, words)
        want = jax_helpers.dropout(jnp.asarray(x), rate, key)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kept = float((y.detach() != 0).float().mean())
    assert abs(kept - rate) < 0.05


def test_dropout_keeps_its_rate_and_scale():
    x = torch.ones((256, 1024))
    for rate in (0.5, 0.8):
        y = ck.fused_threshold_dropout(x, rate, (123, 456))
        assert abs(float((y != 0).float().mean()) - rate) < 0.005
        assert set(torch.unique(y).tolist()) == {0.0, ck.dropout_scale(rate)}
    assert ck.dropout_threshold(0.5) == 1 << 23
    assert ck.fused_threshold_dropout(x, 1.0, (1, 2)) is x


def test_dropout_seed_words_change_the_mask():
    x = torch.ones((64, 128))
    a = ck.fused_threshold_dropout(x, 0.5, (1, 2))
    b = ck.fused_threshold_dropout(x, 0.5, (1, 3))
    c = ck.fused_threshold_dropout(x, 0.5, (1, 2))
    assert torch.equal(a, c) and not torch.equal(a, b)


def test_dropout_gate_and_dense_fallback():
    """Under 4,096 elements the dense mask from a generator seeded with the
    layer's words; the choice is metered by op."""
    assert ck.dropout_fused_supported((64, 64), torch.float32)
    assert not ck.dropout_fused_supported((63, 64), torch.float32)
    assert ck.dropout_fused_supported((64, 64), torch.bfloat16)
    assert not ck.dropout_fused_supported((64, 64), torch.float16)
    reg = monitor.get_registry()
    fb = reg.counter("dl4j_kernel_fallback_total", "", labels=("op",)
                     ).labels(op="dropout")
    before = fb.value
    x = torch.ones((8, 100))
    a = helpers.dropout(x, 0.5, (9, 10))
    assert fb.value == before + 1
    assert torch.equal(a, helpers.dropout(x, 0.5, (9, 10)))
    assert set(torch.unique(a).tolist()) <= {0.0, 2.0}


def _xent_inputs(N, V, soft, seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(N, V)) * 3).astype(np.float32)
    if soft:
        labels = rng.random(size=(N, V)).astype(np.float32)
        labels *= rng.random(size=(N, 1)).astype(np.float32) * 2
    else:
        labels = np.eye(V, dtype=np.float32)[rng.integers(0, V, N)]
    g = rng.normal(size=(N,)).astype(np.float32)
    return logits, labels, g


@pytest.mark.parametrize("N,V", [(256, 512), (37, 130), (128, 1000)])
@pytest.mark.parametrize("soft", [False, True])
def test_xent_matches_jax_kernel(N, V, soft):
    logits, labels, g = _xent_inputs(N, V, soft)
    jl, vjp = jax.vjp(lambda a: pk.softmax_xent_rows(a, jnp.asarray(labels)),
                      jnp.asarray(logits))
    jdx, = vjp(jnp.asarray(g))

    lt = torch.from_numpy(logits).requires_grad_()
    loss = ck.softmax_xent_rows(lt, torch.from_numpy(labels))
    loss.backward(torch.from_numpy(g))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jl),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jdx),
                               rtol=RTOL, atol=ATOL)
    ploss, pgrad = ck.softmax_xent_reference(torch.from_numpy(logits),
                                             torch.from_numpy(labels))
    jloss, jgrad = pk.fused_softmax_xent(jnp.asarray(logits),
                                         jnp.asarray(labels))
    np.testing.assert_allclose(ploss.numpy(), np.asarray(jloss),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pgrad.numpy(), np.asarray(jgrad),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rows,vocab", [(512, 128), (511, 128), (1024, 127),
                                        (128, 1000), (10, 50257), (1, 10)])
def test_xent_gate_matches_jax(rows, vocab, monkeypatch):
    monkeypatch.setenv("DL4J_PALLAS_XENT", "1")
    assert helpers.softmax_xent_wanted(rows, vocab) == \
        jax_helpers.softmax_xent_wanted(rows, vocab)


def test_xent_widest_row_matches_the_kernel_source():
    """``XENT_REGISTER_ROW`` is the widest row the CUDA kernel holds in
    registers: a cluster of kMaxCluster blocks of kBlockThreads threads
    with kBlockPer floats of x and y each (constants of
    ``csrc/softmax_xent.cu``); the kernel source keeps no cap on V."""
    src = (ck.CSRC / "softmax_xent.cu").read_text()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert ck.XENT_REGISTER_ROW == (const["kMaxCluster"] *
                                    const["kBlockThreads"] *
                                    const["kBlockPer"])
    assert "kMaxV" not in src


def test_xent_beyond_the_widest_row_takes_the_dense_chain(monkeypatch):
    """Rows wider than the kernel holds in registers still take the fused
    loss, as JAX's gate sends them to its kernel: the wrapper takes them,
    and on the CPU its plain version (the dense logsumexp chain) gives
    JAX's fused loss and gradient (rtol = atol = 1e-5)."""
    monkeypatch.setenv("DL4J_PALLAS_XENT", "1")
    V = ck.XENT_REGISTER_ROW + 1
    assert helpers.softmax_xent_wanted(1, V)
    assert jax_helpers.softmax_xent_wanted(1, V)
    assert ck.softmax_xent_supported((1, V), torch.float32)
    logits, labels, g = _xent_inputs(1, V, soft=True)
    ploss, pgrad = ck.fused_softmax_xent(torch.from_numpy(logits),
                                         torch.from_numpy(labels))
    jloss, jgrad = pk.fused_softmax_xent(jnp.asarray(logits),
                                         jnp.asarray(labels))
    np.testing.assert_allclose(ploss.numpy(), np.asarray(jloss),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pgrad.numpy(), np.asarray(jgrad),
                               rtol=RTOL, atol=ATOL)
    jl, vjp = jax.vjp(lambda a: jax_losses.mcxent(jnp.asarray(labels), a),
                      jnp.asarray(logits))
    jdx, = vjp(jnp.asarray(g))
    lt = torch.from_numpy(logits).requires_grad_()
    loss = losses.mcxent(torch.from_numpy(labels), lt)
    loss.backward(torch.from_numpy(g))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jl),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jdx),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mask", [None, "rows", "rows_col", "classes"])
def test_mcxent_dispatch_matches_jax(mask, monkeypatch):
    """``losses.mcxent`` above the gate (fused, row masks applied to the
    per-row loss) and with a per-class mask (elementwise form), value and
    gradient."""
    monkeypatch.setenv("DL4J_PALLAS_XENT", "1")
    N, V = 256, 256
    logits, labels, _ = _xent_inputs(N, V, soft=False, seed=3)
    rng = np.random.default_rng(4)
    m = {None: None,
         "rows": (rng.random(N) > 0.3).astype(np.float32),
         "rows_col": (rng.random((N, 1)) > 0.3).astype(np.float32),
         "classes": (rng.random((N, V)) > 0.3).astype(np.float32)}[mask]

    def jloss(a):
        return jax_losses.mcxent(jnp.asarray(labels), a, "softmax",
                                 None if m is None else jnp.asarray(m)).sum()
    jv, jg = jax.value_and_grad(jloss)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    launches = ck.fused_softmax_xent.launches
    v = losses.mcxent(torch.from_numpy(labels), lt, "softmax",
                      None if m is None else torch.from_numpy(m)).sum()
    v.backward()
    assert ck.fused_softmax_xent.launches == launches   # no kernel on the CPU
    np.testing.assert_allclose(v.item(), float(jv), rtol=RTOL)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["mse", "l1", "l2", "mae", "xent", "mcxent",
                                  "nll", "cosine_proximity", "hinge",
                                  "squared_hinge", "kl_divergence", "mape",
                                  "msle", "poisson"])
def test_loss_registry_matches_jax(name):
    """Each loss of the registry on seeded data: the seed is the name's
    CRC-32, the same in every process (Python's ``hash`` of a string is
    not)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()) % 1000)
    N, V = 6, 9
    preout = rng.normal(size=(N, V)).astype(np.float32)
    labels = rng.random(size=(N, V)).astype(np.float32)
    act = {"xent": "sigmoid", "mcxent": "softmax", "nll": "softmax",
           "kl_divergence": "softmax", "poisson": "softplus"}.get(
        name, "tanh")
    want = jax_losses.get(name)(jnp.asarray(labels), jnp.asarray(preout), act)
    got = losses.get(name)(torch.from_numpy(labels), torch.from_numpy(preout),
                           act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert losses.names() == jax_losses.names()


# XLA's float32 tanh on the CPU is within 4.5 ulp of the exact value and
# torch's within 0.57 ulp (measured over 2e6 draws of N(0, 4)), so the two
# activations differ by at most 5 ulp.
TANH_ULPS = 5


def test_msle_conditioning_near_minus_one():
    """msle at seed 755 of the registry test's draw (tanh activation, [6,
    9]), where 1 + tanh(preout) reaches 3.1e-4 and the loss is
    ill-conditioned in the activation.

    Derivation.  Per row, msle = (1/V) sum_j (log1p(o_j) - log1p(y_j))^2
    with o = tanh(preout).  The two frameworks' tanh differ by at most
    ``TANH_ULPS`` ulp(o_j) (see above); log1p multiplies an absolute error
    of o_j by 1 / (1 + o_j), up to ~3,000x here; the square and the mean
    then multiply it by 2 |log1p(o_j) - log1p(y_j)| / V.  So, to first
    order, the rows may differ by

        sum_j 2 |log1p(o_j) - log1p(y_j)| / V * TANH_ULPS ulp(o_j) / (1 + o_j)

    on top of the registry's rtol = atol = 1e-5 for the rest of the float32
    arithmetic.  That bound is the tolerance.  The same data at rtol 1e-5
    alone fails (relative error 3.7e-5): the registry test's seeds are
    fixed so that it does not depend on such data by chance, and this case
    keeps the conditioning in view instead of hiding it."""
    rng = np.random.default_rng(755)
    N, V = 6, 9
    preout = rng.normal(size=(N, V)).astype(np.float32)
    labels = rng.random(size=(N, V)).astype(np.float32)
    out = np.tanh(preout.astype(np.float64))
    assert (1 + out).min() < 4e-4          # the ill-conditioned element
    want = np.asarray(jax_losses.msle(jnp.asarray(labels),
                                      jnp.asarray(preout), "tanh"))
    got = losses.msle(torch.from_numpy(labels), torch.from_numpy(preout),
                      "tanh").numpy()
    o32 = np.tanh(preout)
    ulp = np.spacing(np.abs(o32)).astype(np.float64)
    gap = np.abs(np.log1p(out) - np.log1p(labels.astype(np.float64)))
    bound = (2 * gap / V * TANH_ULPS * ulp / (1 + out)).sum(axis=1)
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= bound + RTOL * np.abs(want) + ATOL).all(), (err, bound)
    # the activations themselves differ by no more than the stated ulps
    jt = np.asarray(jnp.tanh(jnp.asarray(preout)), np.float64)
    tt = torch.tanh(torch.from_numpy(preout)).numpy().astype(np.float64)
    assert (np.abs(jt - tt) <= TANH_ULPS * ulp).all()
