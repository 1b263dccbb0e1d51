"""The port's LSTM tier — ``ops/cuda_kernels.fused_lstm_step`` and its plain
version, ``ops/recurrent.lstm_scan`` and ``ops/helpers.lstm_step_wanted``
— held against the JAX package on the CPU.

On the CPU the port's wrapper runs its kernel's plain version; the JAX
side runs its Pallas LSTM kernel in interpret mode, forced with
``DL4J_PALLAS_LSTM=1`` as the JAX package's own tests do
(``tests/test_pallas_kernels.py``).  Inputs are drawn with numpy and
handed to both.

Tolerance: rtol = atol = 1e-5 everywhere, the JAX suite's tolerance for
its kernel (``tests/test_pallas_kernels.py``): the same float32 math with
the [N, H] x [H, 4H] product summed in another order.  It holds for one
step (forward and all five gradients) and for ``lstm_scan`` over T <= 7
steps (outputs, final state and every param's gradient) alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu.ops import recurrent as jax_rnn
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.ops import activations as act_ops
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import recurrent as rnn

RTOL = ATOL = 1e-5
PARAM_KEYS = ("W", "RW", "b", "pI", "pF", "pO")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU side on one intra-op thread, as in the training
    parity tests: multi-threaded float32 reductions have been seen to vary
    from run to run on a loaded host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _step_inputs(N, H, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return [rng.normal(size=(N, 4 * H)).astype(f),          # zx
            rng.normal(size=(N, H)).astype(f),              # h
            rng.normal(size=(N, H)).astype(f),              # c
            (rng.normal(size=(H, 4 * H)) * 0.3).astype(f),  # RW
            (rng.normal(size=(3, H)) * 0.1).astype(f)]      # pI, pF, pO


def _lstm_params(nin, H, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return {"W": (rng.normal(size=(nin, 4 * H)) * 0.3).astype(f),
            "RW": (rng.normal(size=(H, 4 * H)) * 0.3).astype(f),
            "b": (rng.normal(size=(4 * H,)) * 0.1).astype(f),
            "pI": (rng.normal(size=(H,)) * 0.1).astype(f),
            "pF": (rng.normal(size=(H,)) * 0.1).astype(f),
            "pO": (rng.normal(size=(H,)) * 0.1).astype(f)}


def _counter(name, op):
    fam = monitor.get_registry().get(name)
    if fam is None:
        return 0.0
    return sum(s["value"] for s in fam.samples() if s["labels"]["op"] == op)


@pytest.mark.parametrize("N,H", [(1, 8), (3, 16), (5, 24)])
def test_step_matches_jax_kernel_forward_and_gradients(N, H):
    """``fused_lstm_step`` (its plain version on the CPU) against the
    Pallas kernel: (c', h') and the gradients of all five inputs for a
    random cotangent, which the JAX side takes through its custom VJP."""
    arrays = _step_inputs(N, H, seed=N * 100 + H)
    rng = np.random.default_rng(7)
    g_c, g_h = (rng.normal(size=(N, H)).astype(np.float32) for _ in range(2))

    def jax_loss(*args):
        c_new, h_new = pk.fused_lstm_step(*args)
        return jnp.sum(c_new * g_c) + jnp.sum(h_new * g_h)

    jargs = [jnp.asarray(a) for a in arrays]
    jc, jh = pk.fused_lstm_step(*jargs)
    jgrads = jax.grad(jax_loss, argnums=(0, 1, 2, 3, 4))(*jargs)

    leaves = [_t(a, grad=True) for a in arrays]
    c_new, h_new = ck.fused_lstm_step(*leaves)
    ref_c, ref_h = ck.lstm_step_reference(*[_t(a) for a in arrays])
    assert torch.equal(c_new, ref_c) and torch.equal(h_new, ref_h)
    np.testing.assert_allclose(c_new.detach().numpy(), np.asarray(jc),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(h_new.detach().numpy(), np.asarray(jh),
                               rtol=RTOL, atol=ATOL)
    grads = torch.autograd.grad(
        (c_new * _t(g_c)).sum() + (h_new * _t(g_h)).sum(), leaves)
    for name, got, want in zip(("zx", "h", "c", "RW", "p3"), grads,
                               jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    assert ck.fused_lstm_step.launches == 0       # the CPU launched nothing


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_scan_matches_jax(masked, reverse, monkeypatch):
    """``lstm_scan`` from a given (c, h) against the JAX scan with its
    Pallas step forced: outputs, final state and every param's gradient,
    with and without a mask, forward and reversed in time."""
    monkeypatch.setenv("DL4J_PALLAS_LSTM", "1")
    N, T, nin, H = 3, 7, 5, 16
    params = _lstm_params(nin, H, seed=9)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(N, T, nin)).astype(np.float32)
    c0, h0 = (rng.normal(size=(N, H)).astype(np.float32) for _ in range(2))
    g_out = rng.normal(size=(N, T, H)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((N, T), np.float32)
        mask[0, 4:] = 0.0
        mask[2, :2] = 0.0
        mask[1, 3] = 0.0

    def jax_run(p):
        hs, fin = jax_rnn.lstm_scan(
            p, jnp.asarray(x),
            jax_rnn.LSTMState(jnp.asarray(c0), jnp.asarray(h0)),
            None if mask is None else jnp.asarray(mask), reverse=reverse)
        return jnp.sum(hs * g_out) + jnp.sum(fin.c) + jnp.sum(fin.h), \
            (hs, fin)

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    (_, (jhs, jfin)), jgrads = jax.value_and_grad(jax_run, has_aux=True)(jp)

    tp = {k: _t(v, grad=True) for k, v in params.items()}
    hs, fin = rnn.lstm_scan(tp, _t(x), rnn.LSTMState(_t(c0), _t(h0)),
                            None if mask is None else _t(mask),
                            reverse=reverse)
    loss = (hs * _t(g_out)).sum() + fin.c.sum() + fin.h.sum()
    grads = dict(zip(PARAM_KEYS, torch.autograd.grad(
        loss, [tp[k] for k in PARAM_KEYS])))
    np.testing.assert_allclose(hs.detach().numpy(), np.asarray(jhs),
                               rtol=RTOL, atol=ATOL)
    for got, want in ((fin.c, jfin.c), (fin.h, jfin.h)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
    if masked:          # a masked step outputs zeros
        assert float(hs.detach()[0, 4:].abs().max()) == 0.0
    for k in PARAM_KEYS:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(jgrads[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("n,h,dtype,want", [
    (8, 64, torch.float32, True),
    (1, 200, torch.float32, True),
    (32, 200, torch.float32, True),
    (8, 63, torch.float32, False),      # ragged H
    (8, 4, torch.float32, False),       # tiny H
    (8, 64, torch.float64, False),      # the gradient check's dtype
    (8, 64, torch.bfloat16, True),      # the bf16 form, as the TPU kernel
    (0, 64, torch.float32, False),      # no rows
])
def test_lstm_fused_supported_edges(n, h, dtype, want):
    assert ck.lstm_fused_supported(n, h, dtype) is want


def test_supported_shapes_follow_the_jax_shape_rule():
    """Every H of the JAX rule (h >= 8, h % 8 == 0) and no other; unlike
    the TPU gate there is no VMEM budget, so a batch of 100,000 at
    H = 1024 is taken."""
    for h in range(0, 130):
        assert ck.lstm_fused_supported(8, h, torch.float32) == \
            pk.lstm_fused_supported(8, h, jnp.float32), h
    assert ck.lstm_fused_supported(100000, 1024, torch.float32)
    assert not pk.lstm_fused_supported(100000, 1024, jnp.float32)


@pytest.mark.parametrize("gate,cell,drop,dtype,selected", [
    ("sigmoid", "tanh", None, torch.float32, True),
    ("hardsigmoid", "tanh", None, torch.float32, False),
    ("sigmoid", "softsign", None, torch.float32, False),
    ("sigmoid", "tanh", "pO", torch.float32, False),
    ("sigmoid", "tanh", None, torch.float64, False),
    ("sigmoid", "tanh", None, torch.bfloat16, True),
    ("hardsigmoid", "tanh", None, torch.bfloat16, False),
])
def test_metered_selection(gate, cell, drop, dtype, selected, monkeypatch):
    """One decision per ``lstm_scan`` call, metered under op ``lstm_step``:
    the kernel only for the peephole cell with sigmoid gates and a tanh
    cell; otherwise the composable cell, whose output is the same
    function.  The step wrapper is not entered on the composable path."""
    params = {k: _t(v).to(dtype) for k, v in _lstm_params(4, 8, 3).items()}
    if drop:
        del params[drop]
    x = _t(np.random.default_rng(4).normal(size=(2, 3, 4)).astype(
        np.float32)).to(dtype)
    calls = []
    real = ck.fused_lstm_step
    monkeypatch.setattr(ck, "fused_lstm_step",
                        lambda *a: calls.append(1) or real(*a))
    sel = _counter("dl4j_kernel_selected_total", "lstm_step")
    fb = _counter("dl4j_kernel_fallback_total", "lstm_step")
    hs, _ = rnn.lstm_scan(params, x, gate_act=act_ops.get(gate),
                          cell_act=act_ops.get(cell),
                          peephole=drop is None)
    assert _counter("dl4j_kernel_selected_total", "lstm_step") == \
        sel + selected
    assert _counter("dl4j_kernel_fallback_total", "lstm_step") == \
        fb + (not selected)
    assert len(calls) == (3 if selected else 0)
    assert hs.shape == (2, 3, 8) and hs.dtype == dtype


def test_fused_step_refuses_a_mix_of_dtypes():
    """The kernel has an f32 and a bf16 form and takes one dtype: a call
    that mixes them raises on every device (on the card a bf16 tensor would
    otherwise reach the f32 form's pointers)."""
    params = _lstm_params(4, 8, 3)
    rw = _t(params["RW"])
    p3 = torch.stack([_t(params[k]) for k in ("pI", "pF", "pO")])
    zx, h, c = (torch.zeros(s) for s in ((2, 32), (2, 8), (2, 8)))
    ck.fused_lstm_step(zx, h, c, rw, p3)                # one dtype: runs
    for i in range(5):
        args = [zx, h, c, rw, p3]
        args[i] = args[i].to(torch.bfloat16)
        with pytest.raises(ValueError, match="one dtype"):
            ck.fused_lstm_step(*args)


def test_cell_matches_jax_with_other_activations():
    """The composable cell, which takes every cell the kernel does not:
    hardsigmoid gates and a softsign cell, against the JAX cell."""
    from deeplearning4j_tpu.ops import activations as jax_acts
    params = _lstm_params(4, 8, 5)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 4)).astype(np.float32)
    c, h = (rng.normal(size=(2, 8)).astype(np.float32) for _ in range(2))
    jst, jh = jax_rnn.lstm_cell(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        jax_rnn.LSTMState(jnp.asarray(c), jnp.asarray(h)),
        jax_acts.get("hardsigmoid"), jax_acts.get("softsign"))
    st, hh = rnn.lstm_cell({k: _t(v) for k, v in params.items()}, _t(x),
                           rnn.LSTMState(_t(c), _t(h)),
                           act_ops.get("hardsigmoid"),
                           act_ops.get("softsign"))
    np.testing.assert_allclose(st.c.numpy(), np.asarray(jst.c), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(hh.numpy(), np.asarray(jh), rtol=RTOL,
                               atol=ATOL)
