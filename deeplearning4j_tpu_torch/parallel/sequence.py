"""Attention cores — the port of ``deeplearning4j_tpu/parallel/sequence.py``.

Ported: the dense core (``dense_attention``, which routes tile-friendly
shapes to the hand-written flash kernels through
``ops/helpers.attention_wanted``), the strategy dispatch ``attention``, the
KV-ring decode path (``kv_decode_scope``, ``kv_ring_init``,
``attend_cached``) that ``rnn_time_step`` and the decode pool run, and the
paged KV arena of the decode pool (``block_geometry``, ``PagedTape``,
``paged_scope``, ``paged_tape``, ``attend_paged``).

Not ported yet: the device mesh and its sequence-parallel cores (ring
attention, Ulysses all-to-all), so ``attention`` is the dense core for
every strategy, as the JAX package's is with no mesh active.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import helpers

NEG_INF = ck.NEG_INF         # -1e30, the JAX package's masked score
STRATEGIES = ("auto", "ring", "ulysses", "dense")

# The KV-cache decode scope: ``rnn_time_step`` runs its forward under it,
# which switches SelfAttentionLayer from re-running the whole window to the
# incremental ring-cached path (``attend_cached``).  Training and output()
# never enter it.  The JAX package reads its switches once, while it traces;
# the port reads them on every eager forward, and decode pools, micro-
# batchers and ``rnn_time_step`` callers step on threads of their own, so
# the decode switch and the paged tape below are per thread.
_SCOPE = threading.local()


@contextlib.contextmanager
def kv_decode_scope(enabled: bool = True):
    """Scope under which attention layers decode incrementally against a
    per-stream KV ring carried in their ``rnn_state`` (this thread only)."""
    prev = getattr(_SCOPE, "kv_decode", False)
    _SCOPE.kv_decode = bool(enabled)
    try:
        yield
    finally:
        _SCOPE.kv_decode = prev


def kv_decode_active() -> bool:
    return getattr(_SCOPE, "kv_decode", False)


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


# ---------------------------------------------------------------------------
# Paged KV arena (vLLM-style block tables, the decode pool's shared KV
# store).  Instead of every stream owning a dense [H, W, D] ring, one
# [num_blocks, H, block_size, D] arena per attention layer holds every
# stream's K/V pages, and each stream carries only a block table that maps
# its logical ring slots to physical blocks: capacity is the tokens
# resident across streams, not ``streams x window``.  The arena is shared,
# so it cannot ride the per-stream carry: the pool step activates a
# ``PagedTape`` with ``paged_scope``, and each attention layer draws its
# arena and block table from the tape in encounter order.  The port writes
# the arena in place (the JAX package threads it through its jitted step
# as a donated argument); the pool's batcher thread is its one owner, and
# the tape it activates is seen by that thread alone.


def block_geometry(window: int, block_size: int):
    """A logical window rounded up to whole blocks -> ``(w_eff,
    n_blocks)``, ``w_eff = n_blocks * block_size >= window``.  The ring
    arithmetic runs mod ``w_eff``; validity still masks to ``window``."""
    bs = max(1, int(block_size))
    nbs = max(1, -(-int(window) // bs))
    return nbs * bs, nbs


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (the JAX package's spelling)."""
    return str(dtype).replace("torch.", "")


class PagedTape:
    """Hands the attention layers their shared paged-KV arenas.  Two
    modes:

    * **template** (``arenas is None``): active while the pool builds its
      carry template; records each layer's arena geometry in ``specs``
      (encounter order == arena id), and the layers compute nothing;
    * **run** (``arenas`` / ``tables`` given): layer ``i`` gets
      ``arenas[i]`` (``{"k", "v"}`` of ``[n_blocks + 1, H, bs, D]``, the
      last block the scratch block) and its block table ``tables[i]``
      (``[B, n_blocks_per_slot]``).  With ``record_undo`` each layer
      deposits the journal of the slots it overwrote (:meth:`put_undo`),
      which speculative verify uses to roll rejected writes back.
    """

    def __init__(self, block_size: int = 16, arenas=None, tables=None,
                 dtype=None, record_undo: bool = False):
        self.block_size = max(1, int(block_size))
        self.dtype = dtype          # storage override (e.g. a bf16 arena)
        self.arenas = None if arenas is None else tuple(arenas)
        self.tables = None if tables is None else tuple(tables)
        self.record_undo = bool(record_undo)
        self.specs = []
        self._undo = {}
        self._i = 0

    @property
    def template(self) -> bool:
        return self.arenas is None

    def next_layer(self, n_heads: int, head_dim: int, window: int,
                   ref_dtype):
        """Claim the next arena id -> ``(aid, arena, table)``; both None
        in template mode."""
        i = self._i
        self._i += 1
        if self.template:
            w_eff, nbs = block_geometry(window, self.block_size)
            dt = self.dtype if self.dtype is not None else ref_dtype
            self.specs.append({
                "heads": int(n_heads), "head_dim": int(head_dim),
                "window": int(window), "window_eff": int(w_eff),
                "blocks_per_slot": int(nbs), "dtype": dtype_name(dt)})
            return i, None, None
        return i, self.arenas[i], self.tables[i]

    def put_undo(self, aid: int, undo) -> None:
        if not self.template:
            self._undo[aid] = undo

    def collect_undo(self):
        """Per-layer undo journals in arena-id order (speculative verify)."""
        return tuple(self._undo[i] for i in range(self._i))


@contextlib.contextmanager
def paged_scope(tape: PagedTape):
    """Activate ``tape`` for the duration of one step (the paged analog of
    ``kv_decode_scope``), on this thread only."""
    prev = getattr(_SCOPE, "paged_tape", None)
    _SCOPE.paged_tape = tape
    try:
        yield tape
    finally:
        _SCOPE.paged_tape = prev


def paged_tape() -> Optional[PagedTape]:
    return getattr(_SCOPE, "paged_tape", None)


def attend_paged(q, k_new, v_new, pos, tbl, arena: dict, *, window: int,
                 key_mask=None, scale: Optional[float] = None,
                 undo: bool = False):
    """Incremental sliding-window attention through a block table, the
    paged twin of :func:`attend_cached` (JAX ``sequence.py:248-330``).

    ``pos`` [B] counts each stream's real tokens; ``tbl`` [B, nbs] holds
    physical block ids (entries past the allocated prefix point at the
    scratch block and are never valid); ``arena`` ``{"k", "v"}`` of
    ``[num_blocks, H, bs, D]`` is written IN PLACE.  Token t writes its
    K/V at ring slot ``pos % w_eff`` -> ``(tbl[slot // bs], slot % bs)``,
    as a delta ``old + (new - old) * mask`` accumulated with
    ``index_put_(accumulate=True)``: a masked pad writes nothing, and pad
    or warm-up rows that share the scratch block stay bounded (their
    order over duplicates is unspecified on CUDA, which is harmless: the
    scratch block is never valid to attend).  It then attends over the
    gathered ``[H, w_eff, D]`` window with validity masked to the logical
    ``window``, in at least float32 (a bf16 arena is widened).  Invalid
    values are zeroed before the weighted sum: they may hold anything,
    and 0 * NaN is NaN.  Returns ``(out, new_pos)``, and with ``undo`` a
    journal ``{"pb", "o": [Tc, B], "k", "v": [Tc, B, H, D]}`` of each
    token's overwritten slot contents as well."""
    B, H, Tc, D = q.shape
    ak, av = arena["k"], arena["v"]
    bs = ak.shape[2]
    nbs = tbl.shape[1]
    w_eff = nbs * bs
    W = min(int(window), w_eff)
    scale = scale if scale is not None else 1.0 / D ** 0.5
    acc_dt = torch.promote_types(q.dtype, torch.float32)
    if key_mask is None:
        key_mask = torch.ones((B, Tc), dtype=q.dtype, device=q.device)
    slots = torch.arange(w_eff, device=q.device)
    rows = torch.arange(B, device=q.device)
    # [nb, bs, H, D] views: index_put_ at (block, offset) rows
    kview, vview = ak.permute(0, 2, 1, 3), av.permute(0, 2, 1, 3)
    outs, journal = [], []
    for t in range(Tc):
        m_t = key_mask[:, t]
        w = pos % w_eff                                  # [B] ring slot
        pb = tbl[rows, w // bs]                          # [B] block
        o = w % bs                                       # [B] offset
        m = m_t.to(ak.dtype)[:, None, None]
        old_k = kview[pb, o]                             # [B, H, D]
        old_v = vview[pb, o]
        kview.index_put_((pb, o), (k_new[:, :, t].to(ak.dtype) - old_k) * m,
                         accumulate=True)
        vview.index_put_((pb, o), (v_new[:, :, t].to(av.dtype) - old_v) * m,
                         accumulate=True)
        pos = pos + m_t.to(pos.dtype)
        # gather after the write: [B, nbs, H, bs, D] -> [B, H, w_eff, D]
        kg = ak[tbl].transpose(1, 2).reshape(B, H, w_eff, D).to(acc_dt)
        vg = av[tbl].transpose(1, 2).reshape(B, H, w_eff, D).to(acc_dt)
        # slot s holds the largest position p' < pos with p' = s (mod
        # w_eff); valid iff it exists and lies in the logical window
        c1 = pos[:, None] - 1
        last = c1 - torch.remainder(c1 - slots[None, :], w_eff)
        valid = (last >= 0) & (last >= pos[:, None] - W)  # [B, w_eff]
        vg = vg.masked_fill(~valid[:, None, :, None], 0.0)
        scores = torch.einsum("bhd,bhwd->bhw", q[:, :, t].to(acc_dt),
                              kg) * scale
        scores = scores.masked_fill(~valid[:, None, :], NEG_INF)
        o_t = torch.einsum("bhw,bhwd->bhd", torch.softmax(scores, dim=-1),
                           vg)
        outs.append(o_t.to(q.dtype))
        if undo:
            journal.append((pb, o, old_k, old_v))
    out = torch.stack(outs, dim=2)
    if not undo:
        return out, pos
    pbs, os_, ks, vs = zip(*journal)
    return out, pos, {"pb": torch.stack(pbs), "o": torch.stack(os_),
                      "k": torch.stack(ks), "v": torch.stack(vs)}


def restore_paged(arena: dict, journal: dict, reject) -> None:
    """Roll rejected writes back out of a shared arena, in place: for
    every (step j, row b) with ``reject[j, b]``, the slot that step wrote
    gets back the contents the journal recorded before the write.  Steps
    run from the last to the first, so the earliest contents win where a
    slot was written twice."""
    for key in ("k", "v"):
        view = arena[key].permute(0, 2, 1, 3)
        for j in range(reject.shape[0] - 1, -1, -1):
            r = reject[j]
            if bool(r.any()):
                view.index_put_((journal["pb"][j][r], journal["o"][j][r]),
                                journal[key][j][r])


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
