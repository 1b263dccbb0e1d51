"""Per-op kernel selection — the port of ``deeplearning4j_tpu/ops/helpers.py``.

==================  ==========================  ===========================
op                  kernel (ops/cuda_kernels)   dense chain
==================  ==========================  ===========================
``conv2d``          fused_conv2d_bias_act       ops/convolution.conv2d + act
``dropout``         fused_threshold_dropout     ops/normalization.dropout
``softmax_xent``    softmax_xent_rows           logsumexp form in ops/losses
``lstm_step``       fused_lstm_step             recurrent._lstm_cell_pre
``attention``       flash_attention             parallel/sequence dense
==================  ==========================  ===========================

``conv2d_bias_act`` launches the hand-written kernel on a CUDA tensor
whose shape the kernel's predicate accepts, and takes the dense chain
otherwise (on the CPU too), which is what the JAX package does for
strided and dilated convs.  ``dropout``, ``softmax_xent_wanted``,
``lstm_step_wanted`` and ``attention_wanted`` apply the JAX gates, which
look at shapes (and, for the LSTM, at the cell's activations) only; the
tensor's device then decides inside the wrapper between the kernel
(CUDA) and its plain version (CPU), so the CPU runs the same hash mask,
the same fused loss and the same flash arithmetic as the card.  Each
decision is metered in ``dl4j_kernel_selected_total`` /
``dl4j_kernel_fallback_total`` by op.  The conv, dropout, lstm and
attention kernels each have an f32 and a bf16 form, chosen by the
tensor's dtype inside the wrapper; the xent kernel sees f32 only (the
precision policy casts the pre-activation to f32 before the loss).

Not ported, on purpose: the JAX package's ``kernel_self_test``
disable-on-error (``_selftest_flash`` among them), ``ensure_validated``
and the ``DL4J_PALLAS*`` switches (``DL4J_PALLAS_FLASH`` among them).
A kernel that fails to build or launch on the card raises here instead of
being switched off, so a broken kernel cannot hide behind the dense
chain.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.ops import activations as act_ops
from deeplearning4j_tpu_torch.ops import convolution as conv_ops
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import normalization as norm_ops

# The JAX xent gate (helpers.py:190): wide vocabularies only, where the
# saved round trips of the [N, V] probabilities beat the launch.
XENT_MIN_VOCAB = 128
XENT_MIN_ELEMENTS = 1 << 16


def record_selection(op: str, kernel: bool) -> None:
    """Meter one selection decision."""
    reg = monitor.get_registry()
    if kernel:
        c = reg.counter("dl4j_kernel_selected_total",
                        "ops routed to a hand-written CUDA kernel",
                        labels=("op",))
    else:
        c = reg.counter("dl4j_kernel_fallback_total",
                        "ops that took the dense torch chain",
                        labels=("op",))
    c.labels(op=op).inc()


def conv2d_bias_act(x, w, b, stride=(1, 1), pad=(0, 0), dilation=(1, 1),
                    border_mode: str = "truncate",
                    activation: Optional[str] = "identity"):
    """Conv + bias + activation for ConvolutionLayer.forward."""
    act = (activation or "identity").lower()
    if x.is_cuda and ck.conv_fused_supported(
            x.shape, w.shape, x.dtype, stride, dilation, act, pad,
            border_mode):
        record_selection("conv2d", True)
        return ck.fused_conv2d_bias_act(x, w, b, stride, pad, dilation,
                                        border_mode, act)
    record_selection("conv2d", False)
    return act_ops.get(act)(conv_ops.conv2d(x, w, b, stride, pad, dilation,
                                            border_mode))


def dropout(x, rate: float, seed):
    """Inverted dropout for ``Layer._maybe_dropout``; ``rate`` is the
    RETAIN probability, ``seed`` the layer's two uint32 seed words.  The
    threshold-hash kernel (plain version on the CPU) for f32 tensors of
    at least 4,096 elements; else the dense mask of
    ``ops/normalization.dropout``, drawn from a generator seeded with the
    same words."""
    if ck.dropout_fused_supported(x.shape, x.dtype):
        record_selection("dropout", True)
        return ck.fused_threshold_dropout(x, float(rate), seed)
    record_selection("dropout", False)
    s0, s1 = ck.dropout_seed_words(seed)
    gen = torch.Generator(device=x.device).manual_seed((s0 << 32) | s1)
    return norm_ops.dropout(x, rate, gen)


# Mixed into a layer's seed words for its DropConnect mask, so the mask's
# generator is not the one the layer's dense dropout would seed.
DROP_CONNECT_SALT = 0x0D20


def drop_connect(w, rate: float, seed):
    """DropConnect on a weight tensor: each weight kept with the RETAIN
    probability ``rate`` and divided by it, the others 0 (so no gradient
    reaches them).  The mask is ``torch.bernoulli`` on a generator seeded
    from the layer's two seed words for the step, as the JAX package draws
    it from ``jax.random.bernoulli`` on a key folded with 0x0D20: the same
    distribution, other masks.  There is no kernel: the JAX package draws
    this mask densely too."""
    s0, s1 = ck.dropout_seed_words(seed)
    gen = torch.Generator(device=w.device).manual_seed(
        ((s0 << 32) | s1) ^ DROP_CONNECT_SALT)
    keep = torch.bernoulli(torch.full_like(w, float(rate)), generator=gen)
    return torch.where(keep.bool(), w / rate, torch.zeros_like(w))


def softmax_xent_wanted(n_rows: int, vocab: int,
                        dtype=torch.float32) -> bool:
    """Decision for ``ops/losses.mcxent`` (shape and mask legality are the
    caller's check): the fused loss for vocab >= 128 and
    rows * vocab >= 65,536, in a dtype the kernel takes (f32: the
    precision policy casts a bf16 pre-activation to f32 before the loss;
    the f64 policy of gradient checks takes the dense form)."""
    ok = vocab >= XENT_MIN_VOCAB and n_rows * vocab >= XENT_MIN_ELEMENTS \
        and ck.softmax_xent_supported((n_rows, vocab), dtype)
    record_selection("softmax_xent", ok)
    return ok


# The cell the lstm kernel computes: sigmoid gates, tanh cell activation.
_SIGMOIDS = (torch.sigmoid, act_ops.sigmoid)
_TANHS = (torch.tanh, act_ops.tanh)


def lstm_step_wanted(params: dict, x, gate_act, cell_act,
                     peephole: bool = True) -> bool:
    """Decision for ``ops/recurrent.lstm_scan`` (``helpers.py:157`` of the
    JAX package): the fused step for the peephole cell with sigmoid gates
    and a tanh cell, where :func:`ck.lstm_fused_supported` takes the batch,
    width and dtype (f32 or bf16, the input's, as the JAX selection passes
    ``x.dtype``; under ``precision("bfloat16")`` the step's bf16 form); the
    composable cell otherwise."""
    ok = (peephole
          and all(k in params for k in ("pI", "pF", "pO", "RW"))
          and any(gate_act is f for f in _SIGMOIDS)
          and any(cell_act is f for f in _TANHS)
          and ck.lstm_fused_supported(x.shape[0], params["RW"].shape[0],
                                      x.dtype))
    record_selection("lstm_step", ok)
    return ok


def attention_wanted(q) -> bool:
    """Decision for ``parallel/sequence.dense_attention`` (``helpers.py:196``
    of the JAX package): the flash kernels for a [B, H, T, D] core that
    :func:`ck.flash_attention_supported` takes (T >= 128, 32 <= D <= 128,
    f32 or bf16: the JAX gate has no dtype test, and under
    ``precision("bfloat16")`` the kernels' bf16 forms keep the scores and
    softmax in f32, as the TPU kernels do); the dense softmax otherwise."""
    ok = ck.flash_attention_supported(q.shape, q.dtype)
    record_selection("attention", ok)
    return ok
