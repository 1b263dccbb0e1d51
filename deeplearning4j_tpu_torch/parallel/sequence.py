"""Attention cores — the port of ``deeplearning4j_tpu/parallel/sequence.py``.

Ported: the dense core (``dense_attention``, which routes tile-friendly
shapes to the hand-written flash kernels through
``ops/helpers.attention_wanted``), the strategy dispatch ``attention``, and
the KV-ring decode path (``kv_decode_scope``, ``kv_ring_init``,
``attend_cached``) that ``MultiLayerNetwork.rnn_time_step`` runs.

Not ported yet: the device mesh and its sequence-parallel cores (ring
attention, Ulysses all-to-all), so ``attention`` is the dense core for
every strategy, as the JAX package's is with no mesh active; and the paged
KV arena (``PagedTape``, ``paged_scope``, ``attend_paged``).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import helpers

NEG_INF = ck.NEG_INF         # -1e30, the JAX package's masked score
STRATEGIES = ("auto", "ring", "ulysses", "dense")

# The KV-cache decode scope: ``rnn_time_step`` runs its forward under it,
# which switches SelfAttentionLayer from re-running the whole window to the
# incremental ring-cached path (``attend_cached``).  Training and output()
# never enter it.
_KV_DECODE = False


@contextlib.contextmanager
def kv_decode_scope(enabled: bool = True):
    """Scope under which attention layers decode incrementally against a
    per-stream KV ring carried in their ``rnn_state``."""
    global _KV_DECODE
    prev = _KV_DECODE
    _KV_DECODE = bool(enabled)
    try:
        yield
    finally:
        _KV_DECODE = prev


def kv_decode_active() -> bool:
    return _KV_DECODE


def kv_ring_init(batch: int, n_heads: int, window: int, head_dim: int,
                 dtype=torch.float32, device=None) -> dict:
    """Zero KV ring for ``batch`` streams: ``k``/``v`` are ``[B, H, W, D]``
    circular buffers, ``pos`` the per-stream count of real tokens ever
    written (write index ``pos % W``, valid length ``min(pos, W)``)."""
    return {
        "k": torch.zeros((batch, n_heads, window, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, n_heads, window, head_dim), dtype=dtype,
                         device=device),
        "pos": torch.zeros((batch,), dtype=torch.int64, device=device),
    }


def attend_cached(q, k_new, v_new, ring: dict, *, key_mask=None,
                  scale: Optional[float] = None):
    """Incremental sliding-window attention over a per-stream KV ring ->
    (out [B, H, Tc, D], new ring).  ``q, k_new, v_new`` are the new
    chunk's projections; ``key_mask`` [B, Tc] marks real tokens.  Token t
    of the chunk first writes its K/V at ``pos % W`` (a masked token writes
    nothing and advances nothing), then attends over the ``min(count, W)``
    valid entries.  One loop iteration per token of the chunk.  The ring's
    K and V are written in place (the JAX package builds new arrays): a
    ring of an 8k window is 67 MB per layer at 4 streams, which a copy per
    token would move for nothing."""
    B, H, Tc, D = q.shape
    kr, vr = ring["k"], ring["v"]
    W = kr.shape[2]
    scale = scale if scale is not None else 1.0 / D ** 0.5
    live = (torch.ones((B, Tc), dtype=torch.bool, device=q.device)
            if key_mask is None else key_mask > 0)
    slots = torch.arange(W, device=q.device)
    rows = torch.arange(B, device=q.device)
    pos = ring["pos"]
    outs = []
    for t in range(Tc):
        m_t = live[:, t]                                 # [B]
        w = pos % W
        gate = m_t[:, None, None]
        kr[rows, :, w] = torch.where(gate, k_new[:, :, t], kr[rows, :, w])
        vr[rows, :, w] = torch.where(gate, v_new[:, :, t], vr[rows, :, w])
        pos = pos + m_t.to(pos.dtype)
        valid = slots[None, :] < torch.clamp(pos, max=W)[:, None]   # [B, W]
        scores = torch.einsum("bhd,bhwd->bhw", q[:, :, t], kr) * scale
        scores = scores.masked_fill(~valid[:, None, :], NEG_INF)
        outs.append(torch.einsum("bhw,bhwd->bhd",
                                 torch.softmax(scores, dim=-1), vr))
    return torch.stack(outs, dim=2), {"k": kr, "v": vr, "pos": pos}


def dense_attention(q, k, v, *, causal: bool = False, key_mask=None,
                    scale: Optional[float] = None, allow_flash: bool = True):
    """Softmax attention, q, k, v [B, H, T, D], key_mask [B, Tk] (1 keeps
    the key).  Shapes the flash kernels take go to
    ``ops/cuda_kernels.flash_attention`` (O(T) memory both ways; the plain
    versions on the CPU), in f32 or bf16: on bf16 q, k, v the kernels' bf16
    forms keep the scores, the softmax and lse in f32 and round the output
    once, as the JAX package's kernel does; the rest take the exact dense
    formula, which materialises the [T, T] scores (in bf16 it rounds them
    before the softmax)."""
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / D ** 0.5
    if allow_flash and q.shape[2] == k.shape[2] and \
            helpers.attention_wanted(q):
        return ck.flash_attention(q, k, v, key_mask, causal, scale)
    scores = (q @ k.transpose(-1, -2)) * scale
    if causal:
        Tq, Tk = scores.shape[-2], scores.shape[-1]
        tri = torch.ones((Tq, Tk), dtype=torch.bool,
                         device=q.device).tril()
        scores = scores.masked_fill(~tri, NEG_INF)
    if key_mask is not None:
        scores = scores.masked_fill(key_mask[:, None, None, :] == 0, NEG_INF)
    return torch.softmax(scores, dim=-1) @ v


def attention(q, k, v, *, causal: bool = False, key_mask=None,
              scale: Optional[float] = None, strategy: str = "auto"):
    """The attention core of SelfAttentionLayer.  ``strategy`` is checked
    as in the JAX package ('auto' | 'ring' | 'ulysses' | 'dense'); with no
    device mesh (none is ported) every strategy is the dense core."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown attention strategy {strategy!r} "
                         "(expected auto|ring|ulysses|dense)")
    return dense_attention(q, k, v, causal=causal, key_mask=key_mask,
                           scale=scale)
