"""Stateful decode serving: continuous batching over a device-resident
session-slot cache — the port of ``deeplearning4j_tpu/server/decode.py``.

``rnn_time_step`` serves one client's streams from the carry in
``net_state``.  This module serves many concurrent sessions from one model:

* **Session-slot pool** (:class:`DecodePool`): the recurrent carries of up
  to ``max_slots`` sessions live on the device as one tree of
  ``[S+1, ...]`` tensors (slot ``S`` is a scratch row for padding).  A
  session owns a slot for its lifetime; its carry stays on the device
  between tokens, and a dispatch copies only its outputs to the host.

* **One step call per dispatch**: gather the active slots' carries by
  index (``index_select``; a freshly opened session's rows are zeroed with
  ``torch.where``, so a reused slot never shows its last tenant's state),
  run the engines' carried step (``_rnn_step_raw``, the seam
  ``rnn_time_step`` runs too) and write the new carries back in place
  (``index_copy_``).  The char-RNN's step reaches the hand-written LSTM
  step kernel through ``ops/recurrent.lstm_scan`` at the ladder's batch.

* **Continuous batching**: concurrent ``decode_step`` calls enqueue with a
  future; the pool's thread takes at most one pending step per session,
  pads the joined set up to the slot ladder (and each chunk's time axis up
  to the time ladder, the pad steps masked so they carry state through
  unchanged) and dispatches.

* **Resilience**: slot or arena exhaustion raises :class:`OverloadedError`
  (the gateway's 503 + Retry-After), idle sessions expire after ``ttl_s``,
  expired deadlines are shed before compute, and a killed pool thread
  (fault site ``decode.step``) fails every in-flight session cleanly; the
  next submit restarts it.

* **Session migration**: a session's decode state is one slot slice of
  the carry tree.  :meth:`DecodePool.export_session` copies it to the host
  (on the pool's thread) into a JSON-serializable payload whose wire
  format is the JAX package's — the leaves in its flatten order (dict keys
  sorted, ``None`` layers skipped), each a base64 ``.npy`` (v2) or a JSON
  list (v1), a bf16 leaf as raw 2-byte ``V2`` records named ``bfloat16`` —
  so sessions move between the two packages both ways.  Export is
  two-phase (:meth:`finish_export`); :meth:`drain` stops admitting joins.

* **Paged KV arena** (``kv_paged``): the attention layers' K/V pages live
  in one block arena per layer shared by every slot
  (``parallel/sequence.attend_paged``), allocated by tokens resident.

Left out of the JAX module: the ``analysis.sanitizer.guard_step`` transfer
guard around the compiled call (it means nothing in eager PyTorch) and the
trace spans of ``monitor/tracing.py``, which is not ported.  Metered as the
``dl4j_decode_*`` family under the JAX package's names and labels.
"""

from __future__ import annotations

import base64
import contextlib
import hashlib
import io
import logging
import os
import threading
import time
import uuid
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.monitor import events, flight
from deeplearning4j_tpu_torch.ops import bucketing
from deeplearning4j_tpu_torch.parallel import sequence as seq_ops
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.resilience.errors import (
    DeadlineExceededError, OverloadedError, TransientError)

log = logging.getLogger(__name__)

CARRY_PAYLOAD_VERSION = 2


# ---------------------------------------------------------------------------
# Carry trees: dicts (keys sorted, as JAX flattens them), lists, tuples and
# named tuples (in order), None (no leaves), tensors (leaves).
# ---------------------------------------------------------------------------

def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a carry tree in the JAX package's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [a for t in tree for a in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``tree`` with ``fn(leaf, *matching leaves of rest)`` at each leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, t, *(r[i] for r in rest))
                 for i, t in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return fn(tree, *rest)


def _is_ring(node) -> bool:
    return (isinstance(node, dict) and set(node) == {"k", "v", "pos"}
            and getattr(node["k"], "ndim", 0) == 4)


def _is_paged(node) -> bool:
    return isinstance(node, dict) and set(node) == {"aid", "pos", "tbl"}


class DecodeMetrics:
    """Registry-backed telemetry for one decode pool (the ``dl4j_decode_*``
    family, the JAX package's names and labels) and plain counters for the
    stats RPC."""

    def __init__(self, name: str = ""):
        reg = monitor.get_registry()
        self._name = name or "default"
        lbl = {"model": self._name}
        self._f_opened = reg.counter(
            "dl4j_decode_sessions_opened_total",
            "decode sessions opened, per tenant", ("model", "tenant"))
        self._f_closed = reg.counter(
            "dl4j_decode_sessions_closed_total",
            "decode sessions closed, by reason", ("model", "reason"))
        self.g_active = reg.gauge(
            "dl4j_decode_active_sessions", "decode sessions currently open",
            ("model",)).labels(**lbl)
        self.g_capacity = reg.gauge(
            "dl4j_decode_slot_capacity", "decode slot-pool capacity",
            ("model",)).labels(**lbl)
        self._f_steps = reg.counter(
            "dl4j_decode_steps_total", "decode session-steps served",
            ("model", "tenant"))
        self._f_tokens = reg.counter(
            "dl4j_decode_tokens_total", "timesteps decoded, per tenant",
            ("model", "tenant"))
        self.c_batches = reg.counter(
            "dl4j_decode_batches_total",
            "continuous-batching decode dispatches", ("model",)).labels(**lbl)
        self.h_step = reg.histogram(
            "dl4j_decode_step_seconds",
            "one gather->step->scatter decode call",
            ("model",)).labels(**lbl)
        self.h_queue = reg.histogram(
            "dl4j_decode_queue_seconds", "decode step enqueue -> dispatch",
            ("model",)).labels(**lbl)
        self._c_shed = reg.counter(
            "dl4j_resilience_shed_total",
            "requests shed instead of served", labels=("reason",))
        self.g_kv_rings = reg.gauge(
            "dl4j_kv_rings", "KV rings in the pool's carry (attention "
            "layers x slots share one ring buffer)", ("model",)).labels(**lbl)
        self.g_kv_bytes = reg.gauge(
            "dl4j_kv_ring_bytes", "device bytes held by KV ring K/V "
            "buffers across all slots", ("model",)).labels(**lbl)
        self.g_kv_window = reg.gauge(
            "dl4j_kv_window", "widest KV ring window (tokens) in the "
            "pool's carry", ("model",)).labels(**lbl)
        self.g_arena_blocks = reg.gauge(
            "dl4j_kv_arena_blocks", "paged KV arena capacity in blocks, "
            "summed over attention layers", ("model",)).labels(**lbl)
        self.g_arena_free = reg.gauge(
            "dl4j_kv_arena_blocks_free", "paged KV arena blocks on the "
            "free lists, summed over attention layers",
            ("model",)).labels(**lbl)
        self.g_arena_tokens = reg.gauge(
            "dl4j_kv_arena_tokens_resident", "KV tokens resident across "
            "live sessions (per stream, capped at the widest effective "
            "window)", ("model",)).labels(**lbl)
        self.c_arena_failures = reg.counter(
            "dl4j_kv_arena_alloc_failures_total", "decode steps shed "
            "because the paged KV arena had no free blocks",
            ("model",)).labels(**lbl)
        self._f_spec_steps = reg.counter(
            "dl4j_spec_steps_total", "fused speculative verify dispatches",
            ("model", "tenant"))
        self._f_spec_proposed = reg.counter(
            "dl4j_spec_tokens_proposed_total",
            "draft tokens scored by verify steps", ("model", "tenant"))
        self._f_spec_accepted = reg.counter(
            "dl4j_spec_tokens_accepted_total",
            "tokens committed by verify steps (pending + accepted draft "
            "prefix)", ("model", "tenant"))
        self.h_spec_accept = reg.histogram(
            "dl4j_spec_accept_len", "tokens committed per fused verify "
            "dispatch", ("model",)).labels(**lbl)
        self._lock = threading.Lock()
        self.steps = 0
        self.tokens = 0
        self.batches = 0
        self.spec_steps = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.batch_size_hist: Dict[int, int] = {}

    def record_opened(self, tenant: Optional[str]) -> None:
        self._f_opened.labels(model=self._name, tenant=tenant or "-").inc()

    def record_step(self, tenant: Optional[str], n_tokens: int = 0) -> None:
        self._f_steps.labels(model=self._name, tenant=tenant or "-").inc()
        if n_tokens:
            self._f_tokens.labels(model=self._name,
                                  tenant=tenant or "-").inc(n_tokens)
            with self._lock:
                self.tokens += n_tokens

    def record_spec(self, tenant: Optional[str], proposed: int,
                    accepted: int) -> None:
        t = tenant or "-"
        self._f_spec_steps.labels(model=self._name, tenant=t).inc()
        if proposed:
            self._f_spec_proposed.labels(model=self._name,
                                         tenant=t).inc(proposed)
        self._f_spec_accepted.labels(model=self._name, tenant=t).inc(accepted)
        self.h_spec_accept.observe(float(accepted))
        with self._lock:
            self.spec_steps += 1
            self.spec_proposed += proposed
            self.spec_accepted += accepted

    def record_closed(self, reason: str) -> None:
        self._f_closed.labels(model=self._name, reason=reason).inc()

    def record_shed(self, reason: str) -> None:
        self._c_shed.labels(reason=reason).inc()

    def record_batch(self, n_steps: int) -> None:
        with self._lock:
            self.steps += n_steps
            self.batches += 1
            self.batch_size_hist[n_steps] = \
                self.batch_size_hist.get(n_steps, 0) + 1
        self.c_batches.inc()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "steps": self.steps,
                "tokens": self.tokens,
                "batches": self.batches,
                "steps_per_batch_mean":
                    round(self.steps / self.batches, 2) if self.batches
                    else 0.0,
                "batch_size_hist": {str(k): v for k, v in
                                    sorted(self.batch_size_hist.items())},
                "spec_steps": self.spec_steps,
                "spec_tokens_proposed": self.spec_proposed,
                "spec_tokens_accepted": self.spec_accepted,
                "spec_accept_per_dispatch":
                    round(self.spec_accepted / self.spec_steps, 2)
                    if self.spec_steps else 0.0,
                "step_ms": self.h_step.latency_snapshot(),
                "queue_ms": self.h_queue.latency_snapshot(),
            }


class DecodeSession:
    __slots__ = ("sid", "slot", "tenant", "created_at", "last_used",
                 "steps", "started", "migrating", "exported", "importing",
                 "kv_blocks", "kv_pos")

    def __init__(self, sid: str, slot: int, tenant: Optional[str]):
        self.sid = sid
        self.slot = slot
        self.tenant = tenant
        self.created_at = time.monotonic()
        self.last_used = self.created_at
        self.steps = 0
        # paged-KV bookkeeping: per-layer lists of the arena blocks this
        # session owns (allocation order == logical block order) and the
        # host mirror of the stream's write position; freed exactly once,
        # in _close_locked
        self.kv_blocks: Optional[List[List[int]]] = None
        self.kv_pos = 0
        # False until the first dispatched step: the step zeroes a fresh
        # row's gathered carry, so a reused slot's stale carry is unseen
        self.started = False
        # migration limbo: `migrating` rejects new steps (retryable) while
        # an export is prepared; `exported` means the snapshot left this
        # pool and the slot is held until finish_export()
        self.migrating = False
        self.exported = False
        # between an import's slot claim and its carry scatter landing
        self.importing = False


class _PendingStep:
    __slots__ = ("session", "xs", "masks", "future", "t_enqueue",
                 "deadline", "tenant", "ctx", "spec_tokens", "sampling")

    def __init__(self, session, xs, masks, future, deadline, tenant,
                 ctx=None, spec_tokens=None, sampling=None):
        self.session = session
        self.xs = xs          # tuple of per-input [T, ...] host arrays
        self.masks = masks    # tuple of per-input [T] masks or None
        self.future = future
        self.t_enqueue = time.perf_counter()
        self.deadline = deadline  # absolute time.monotonic(), or None
        self.tenant = tenant
        # trace context captured at enqueue; the pool thread re-attaches
        # it to this step's journal events
        self.ctx = ctx or {}
        # speculative verify: the fed token ids [T] (pending + drafts);
        # None for a normal step.  The two never share a dispatch.
        self.spec_tokens = spec_tokens
        # sampling-mode verify: {"temperature", "top_k", "seed", "pos"}
        self.sampling = sampling

    @property
    def request_id(self):
        return self.ctx.get("request_id")


# ---------------------------------------------------------------------------
# Carry payload encoding (the migration wire, the JAX package's format).
# v2 ships each leaf as base64 .npy bytes (exact binary round trip); v1 as
# a JSON list (DL4J_CARRY_PAYLOAD=json, for a mixed-version fleet).
# ---------------------------------------------------------------------------

def _encode_carry_leaf(t: torch.Tensor, binary: bool) -> dict:
    """One carry leaf on the wire.  A bf16 leaf goes as 2-byte void
    records (what the JAX package's ``np.save`` of an ``ml_dtypes``
    bfloat16 array writes) with the dtype named ``bfloat16``, so JAX's
    reader reinterprets the bits instead of casting integers.  JAX carries
    no 64-bit integers: the port's int64 positions go as int32."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        spec = {"shape": list(t.shape), "dtype": "bfloat16"}
        if binary:
            a = t.contiguous().view(torch.int16).numpy().view(np.dtype("V2"))
        else:
            spec["data"] = t.float().numpy().ravel().tolist()
            return spec
    else:
        a = t.numpy()
        if a.dtype == np.int64:
            a = a.astype(np.int32)
        spec = {"shape": list(a.shape), "dtype": str(a.dtype)}
        if not binary:
            spec["data"] = a.ravel().tolist()
            return spec
    buf = io.BytesIO()
    np.save(buf, a, allow_pickle=False)
    spec["npy_b64"] = base64.b64encode(buf.getvalue()).decode("ascii")
    return spec


def _decode_carry_leaf(spec: dict) -> torch.Tensor:
    """The wire leaf as a CPU tensor.  ``bfloat16`` leaves arrive as raw
    2-byte records from npy (or float lists from JSON): the bits are
    reinterpreted, never cast, so the hop stays bit-exact."""
    want = spec["dtype"]
    if "npy_b64" in spec:
        a = np.load(io.BytesIO(base64.b64decode(spec["npy_b64"])),
                    allow_pickle=False)
    elif want == "bfloat16":
        a = np.asarray(spec["data"], dtype=np.float32)
    else:
        a = np.asarray(spec["data"], dtype=np.dtype(want))
    a = a.reshape(tuple(spec["shape"]))
    if want == "bfloat16":
        if a.dtype.kind == "V" and a.dtype.itemsize == 2:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            torch.bfloat16)
    if str(a.dtype) != want:
        a = a.astype(np.dtype(want))
    return torch.from_numpy(np.array(a))     # a copy; a 0-d leaf stays 0-d


def _kv_ring_summary(tree) -> dict:
    """Ring count, K+V device bytes and widest window of the KV rings
    (``kv_ring_init``-shaped dicts) in a carry tree."""
    out = {"rings": 0, "bytes": 0, "window": 0}

    def walk(node):
        if _is_ring(node):
            out["rings"] += 1
            out["bytes"] += int(node["k"].nelement()
                                * node["k"].element_size()
                                + node["v"].nelement()
                                * node["v"].element_size())
            out["window"] = max(out["window"], int(node["k"].shape[2]))
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(tree)
    return out


def _cast_carry(tree, dtype):
    """Store a carry template's non-KV float32 leaves at ``dtype`` (a bf16
    carry pool halves the resident bytes; the step still computes at f32,
    see :func:`_gather_slots`).  KV rings and integer leaves stay."""
    if _is_ring(tree):
        return tree
    if isinstance(tree, dict):
        return {k: _cast_carry(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_cast_carry(t, dtype) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            type(tree)(items)
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.float32:
        return tree.to(dtype)
    return tree


def _gather_slots(pool, idx, fresh):
    """The active slots' carries, gathered out of the pool by index, with
    the rows of freshly claimed slots zeroed by ``torch.where`` (a NaN an
    earlier tenant left cannot leak, where ``g * (1 - f)`` would pass it
    on).  A sub-f32 float pool (``carry_dtype``) is widened to float32
    here, so the step computes at f32 however the carry is stored."""
    def take(a):
        g = a.index_select(0, idx)
        if g.is_floating_point() and g.element_size() < 4:
            g = g.float()
        f = fresh.view((-1,) + (1,) * (g.ndim - 1))
        return torch.where(f, torch.zeros((), dtype=g.dtype,
                                          device=g.device), g)

    return tree_map(take, pool)


def _scatter_slots(pool, idx, carries) -> None:
    """Write ``carries`` back into the pool's rows ``idx`` in place, in each
    pool leaf's dtype.  Pad rows all name the scratch slot, whose contents
    are never read as a session's state."""
    tree_map(lambda p, c: p.index_copy_(0, idx, c.to(p.dtype)), pool,
             carries)


def _gumbel(seed: int, pos: int, n: int) -> torch.Tensor:
    """Gumbel noise [n] for one stream position, from a generator keyed on
    (seed, position): the draw at a position is the same however the
    positions group into dispatches.  The key is numpy's ``SeedSequence``
    of the pair (torch's CPU generator keeps only 32 bits of its seed, too
    few to key every pair apart); the JAX package keys ``jax.random``,
    whose stream torch cannot reproduce."""
    rng = np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([int(seed) & 0xFFFFFFFF,
                                int(pos) & 0xFFFFFFFF])))
    return torch.from_numpy(rng.gumbel(size=n).astype(np.float32))


def _sample_picks(outs, seeds, pos0, temps, top_k: int):
    """Position-keyed Gumbel-argmax draws from the outputs [B, T, C]
    (softmax probabilities) at each row's temperature, over the ``top_k``
    best logits when 0 < top_k < C: ``argmax(log p + g)`` is an exact draw
    from p."""
    B, T, C = outs.shape
    logits = torch.log(outs.float().clamp(min=1e-30))
    logits = logits / temps.clamp(min=1e-6)[:, None, None]
    if 0 < top_k < C:
        kth = torch.sort(logits, dim=-1).values[..., C - top_k][..., None]
        logits = torch.where(logits >= kth, logits,
                             torch.full_like(logits, -1e30))
    logp = torch.log_softmax(logits, dim=-1)
    gum = torch.stack([torch.stack([_gumbel(seeds[b], pos0[b] + t, C)
                                    for t in range(T)])
                       for b in range(B)]).to(outs.device)
    return torch.argmax(logp + gum, dim=-1)


class DecodePool:
    """Device-resident slot-pool decode state for ONE model instance, with
    its continuous-batching thread.

    ``max_slots`` bounds concurrent sessions (exhaustion raises
    :class:`OverloadedError` after expiring idle sessions past ``ttl_s``).
    ``slot_ladder`` buckets the joined-session count of a dispatch (powers
    of two up to ``max_slots`` by default); chunk time axes bucket up to
    the configuration's time ladder (masked pad steps carry the state
    through unchanged).  The paged-arena knobs (``kv_paged``, ``kv_block``,
    ``kv_arena_tokens``, ``kv_dtype``) and ``carry_dtype`` resolve from the
    constructor, then ``DL4J_KV_PAGED``, ``DL4J_KV_BLOCK``,
    ``DL4J_KV_ARENA_TOKENS``, ``DL4J_KV_DTYPE``, ``DL4J_CARRY_DTYPE``, then
    the JAX package's defaults (dense rings, block 16, ``max_slots`` x the
    widest window, the model's dtype)."""

    def __init__(self, model, name: str = "", max_slots: int = 32,
                 ttl_s: float = 600.0,
                 slot_ladder: Optional[Sequence[int]] = None,
                 max_wait_ms: float = 2.0, min_batch: int = 1,
                 kv_paged: Optional[bool] = None,
                 kv_block: Optional[int] = None,
                 kv_arena_tokens: Optional[int] = None,
                 kv_dtype=None, carry_dtype=None):
        self.model = model
        self.name = name
        self.max_slots = max(1, int(max_slots))
        self.ttl_s = float(ttl_s)
        self._ladder = bucketing.warmup_ladder(slot_ladder, self.max_slots)
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1e3
        self.min_batch = max(1, min(int(min_batch), self.max_slots))
        if kv_paged is None:
            kv_paged = os.environ.get("DL4J_KV_PAGED", "") == "1"
        self.kv_paged = bool(kv_paged)
        if kv_block is None:
            kv_block = int(os.environ.get("DL4J_KV_BLOCK", "16") or 16)
        self.kv_block = max(1, int(kv_block))
        if kv_arena_tokens is None:
            env = os.environ.get("DL4J_KV_ARENA_TOKENS", "")
            kv_arena_tokens = int(env) if env else None
        self.kv_arena_tokens = (None if kv_arena_tokens is None
                                else max(1, int(kv_arena_tokens)))
        if kv_dtype is None:
            kv_dtype = os.environ.get("DL4J_KV_DTYPE", "") or None
        self._kv_dtype = _torch_dtype(kv_dtype)
        if carry_dtype is None:
            carry_dtype = os.environ.get("DL4J_CARRY_DTYPE", "") or None
        self._carry_dtype = _torch_dtype(carry_dtype)
        self._is_graph = hasattr(model, "_forward_all")
        self.n_inputs = (len(model.conf.network_inputs) if self._is_graph
                         else 1)
        self.device = model.device
        self.metrics = DecodeMetrics(name)
        self.metrics.g_capacity.set(self.max_slots)
        self._cond = threading.Condition()
        self._queue: List[_PendingStep] = []
        self._inflight: List[_PendingStep] = []
        # migration ops ride this queue, so only the pool thread ever
        # touches the device pool: (kind, arg, Future)
        self._control: List[Tuple] = []
        self._sessions: Dict[str, DecodeSession] = {}
        self._free: List[int] = list(range(self.max_slots))
        self._running = True
        self._dead = False
        self._draining = False
        self.deaths = 0
        self.restarts = 0
        # device state, touched only by the pool thread after init
        self._pool = None
        self._tails: Optional[Tuple] = None
        self._dtype = torch.float32
        self._kv_summary: dict = {}
        # paged arenas: device tensors owned by the pool thread; the
        # allocator's free lists and the layer specs are host state under
        # self._cond (admission runs under it)
        self._arenas = None
        self._arena_specs: Tuple[dict, ...] = ()
        self._arena_blocks: Tuple[int, ...] = ()
        self._kv_free: List[List[int]] = []
        self._thread = self._spawn_thread()

    # ------------------------------------------------------------------
    # Session lifecycle
    # ------------------------------------------------------------------
    def open_session(self, tenant: Optional[str] = None,
                     retry_after_s: float = 1.0) -> str:
        """Claim a slot; raises :class:`OverloadedError` when every slot is
        held by a live (non-expired) session."""
        with self._cond:
            if not self._running:
                raise RuntimeError("DecodePool is stopped")
            if self._draining:
                self.metrics.record_shed("decode_draining")
                events.emit("request.shed", severity="warn",
                            reason="decode_draining", model=self.name)
                raise OverloadedError(
                    "decode pool draining (rollout/migration in "
                    "progress)", retry_after_s=retry_after_s)
            self._sweep_locked()
            if not self._free:
                self.metrics.record_shed("decode_slots_full")
                events.emit("request.shed", severity="warn",
                            reason="decode_slots_full", model=self.name)
                raise OverloadedError(
                    f"decode slots exhausted ({self.max_slots} sessions "
                    "active)", retry_after_s=retry_after_s)
            slot = self._free.pop()
            sid = uuid.uuid4().hex[:16]
            self._sessions[sid] = DecodeSession(sid, slot, tenant)
            self.metrics.record_opened(tenant)
            self.metrics.g_active.set(self._active_locked())
            events.emit("decode.session_opened", model=self.name,
                        session_id=sid, slot=slot, tenant=tenant)
        return sid

    def close_session(self, sid: str, reason: str = "closed") -> bool:
        with self._cond:
            return self._close_locked(sid, reason)

    def _close_locked(self, sid: str, reason: str) -> bool:
        s = self._sessions.pop(sid, None)
        if s is None:
            return False
        self._free.append(s.slot)
        if s.kv_blocks is not None:
            # blocks return to the free lists exactly once (the session
            # was popped above); a session outliving an arena reset
            # returns nothing
            for li, blks in enumerate(s.kv_blocks):
                if li < len(self._kv_free):
                    self._kv_free[li].extend(blks)
            s.kv_blocks = None
            self._update_arena_gauges_locked()
        stranded = [p for p in self._queue if p.session.sid == sid]
        self._queue = [p for p in self._queue if p.session.sid != sid]
        for p in stranded:
            if not p.future.done():
                p.future.set_exception(
                    RuntimeError(f"decode session {sid} closed ({reason}) "
                                 "with steps still queued"))
        self.metrics.record_closed(reason)
        self.metrics.g_active.set(self._active_locked())
        self._cond.notify_all()
        events.emit("decode.session_closed", model=self.name,
                    session_id=sid, slot=s.slot, tenant=s.tenant,
                    reason=reason, steps=s.steps,
                    severity="warn" if reason in ("batcher_died", "error")
                    else "info")
        return True

    def _active_locked(self) -> int:
        """Live sessions: exported slots are held but no longer count."""
        return sum(1 for s in self._sessions.values() if not s.exported)

    def _sweep_locked(self, now: Optional[float] = None) -> int:
        if self.ttl_s <= 0:
            return 0
        now = time.monotonic() if now is None else now
        # a session in a migration window is not idle: reaping it would
        # leave a failed import nothing to reinstate
        expired = [sid for sid, s in self._sessions.items()
                   if not s.exported and not s.migrating
                   and now - s.last_used > self.ttl_s]
        for sid in expired:
            self._close_locked(sid, reason="ttl")
        return len(expired)

    def sweep(self) -> int:
        """Expire idle sessions past ``ttl_s`` (also runs on every
        ``open_session`` and while the pool thread idles)."""
        with self._cond:
            return self._sweep_locked()

    @property
    def active_sessions(self) -> int:
        with self._cond:
            return self._active_locked()

    @property
    def held_slots(self) -> int:
        """Slots claimed, exported-but-unconfirmed sessions included."""
        with self._cond:
            return len(self._sessions)

    @property
    def draining(self) -> bool:
        with self._cond:
            return self._draining

    def session_ids(self) -> List[str]:
        with self._cond:
            return list(self._sessions)

    # ------------------------------------------------------------------
    # Client side
    # ------------------------------------------------------------------
    def submit_step(self, sid: str, xs, masks=None,
                    timeout_ms: Optional[float] = None,
                    tenant: Optional[str] = None) -> Future:
        """Enqueue one decode step; the future resolves to the tuple of
        per-output ``[T, ...]`` arrays of that session's rows.  ``xs`` is
        one ``[T, ...]`` array per network input."""
        return self._submit(sid, xs, masks, timeout_ms, tenant, None)

    def submit_spec_step(self, sid: str, xs, token_ids,
                         timeout_ms: Optional[float] = None,
                         tenant: Optional[str] = None,
                         sampling: Optional[dict] = None) -> Future:
        """Enqueue one speculative-verify step: ``xs`` holds the feature
        rows of the pending token and the drafts, ``token_ids`` their [T]
        ids.  The future resolves to ``(outs [T, C], picks [T],
        accepted)``: ``accepted`` tokens (>= 1) were committed to the
        session's carry, the rest rolled back.  ``sampling`` switches the
        acceptance from greedy argmax to position-keyed sampling:
        ``temperature``, ``top_k`` (0 = the whole vocabulary), ``seed`` and
        ``pos``, the session's absolute sampling position."""
        tok = np.asarray(token_ids, np.int64).ravel()
        xs_n = self._normalize_inputs(xs)
        if any(a.ndim < 2 for a in xs_n):
            raise ValueError("speculative decode needs sequence inputs "
                             "([T, C] per network input)")
        if any(a.shape[0] != tok.shape[0] for a in xs_n):
            raise ValueError(
                f"token_ids has {tok.shape[0]} entries but the feature "
                f"chunk has {xs_n[0].shape[0]} timesteps")
        return self._submit(sid, xs, None, timeout_ms, tenant, tok,
                            sampling=sampling)

    def _submit(self, sid, xs, masks, timeout_ms, tenant,
                spec_tokens, sampling=None) -> Future:
        xs = self._normalize_inputs(xs)
        masks = self._normalize_masks(masks, xs)
        deadline = (None if timeout_ms is None
                    else time.monotonic() + float(timeout_ms) / 1e3)
        with self._cond:
            if not self._running:
                raise RuntimeError("DecodePool is stopped")
            s = self._sessions.get(sid)
            if s is None:
                raise KeyError(f"unknown or expired decode session {sid!r}")
            if s.migrating or s.exported:
                raise TransientError(
                    f"decode session {sid} is migrating; retry")
            restarted = self._restart_if_dead_locked()
            fut = Future()
            self._queue.append(_PendingStep(
                s, xs, masks, fut, deadline,
                tenant if tenant is not None else s.tenant,
                ctx=events.current_context(), spec_tokens=spec_tokens,
                sampling=sampling))
            self._cond.notify_all()
        if restarted:
            events.emit("decode.restarted", model=self.name)
        return fut

    def _restart_if_dead_locked(self) -> bool:
        if self._dead or not self._thread.is_alive():
            self._dead = False
            self.restarts += 1
            self._thread = self._spawn_thread()
            return True
        return False

    def step(self, sid: str, xs, masks=None, timeout: Optional[float] = 60.0,
             timeout_ms: Optional[float] = None,
             tenant: Optional[str] = None):
        """Blocking :meth:`submit_step`."""
        return self.submit_step(sid, xs, masks, timeout_ms=timeout_ms,
                                tenant=tenant).result(timeout)

    def spec_step(self, sid: str, xs, token_ids,
                  timeout: Optional[float] = 60.0,
                  timeout_ms: Optional[float] = None,
                  tenant: Optional[str] = None,
                  sampling: Optional[dict] = None):
        """Blocking :meth:`submit_spec_step`."""
        return self.submit_spec_step(
            sid, xs, token_ids, timeout_ms=timeout_ms,
            tenant=tenant, sampling=sampling).result(timeout)

    def _normalize_inputs(self, xs) -> Tuple[np.ndarray, ...]:
        """Per-input ``[T, C]`` float32 chunks: a single-input model takes
        the array (a 1-D vector is one timestep), a multi-input graph one
        array per input."""
        if self.n_inputs == 1:
            arrs = [xs]
        else:
            if not isinstance(xs, (list, tuple)) \
                    or len(xs) != self.n_inputs:
                raise ValueError(f"decode step needs {self.n_inputs} "
                                 "input arrays (one per network input)")
            arrs = list(xs)
        out = []
        for a in arrs:
            if isinstance(a, torch.Tensor):
                a = a.detach().cpu().numpy()
            a = np.asarray(a, np.float32)
            if a.ndim == 1:
                a = a[None]
            out.append(a)
        return tuple(out)

    def _normalize_masks(self, masks, xs):
        if masks is None:
            return tuple(None for _ in xs)
        ms = [masks] if self.n_inputs == 1 else list(masks)
        if len(ms) != len(xs):
            raise ValueError("one mask (or None) per network input")
        return tuple(None if m is None else np.asarray(m, np.float32).ravel()
                     for m in ms)

    def queue_rows(self) -> int:
        with self._cond:
            return len(self._queue)

    def queue_rows_by_tenant(self) -> Dict[str, int]:
        with self._cond:
            out: Dict[str, int] = {}
            for p in self._queue:
                t = p.tenant or "-"
                out[t] = out.get(t, 0) + 1
            return out

    @property
    def thread_alive(self) -> bool:
        return self._thread.is_alive()

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the pool thread; queued steps and control ops fail, every
        session closes (reason ``shutdown``)."""
        with self._cond:
            self._running = False
            self._cond.notify_all()
        self._thread.join(timeout)
        with self._cond:
            leftovers, self._queue = self._queue, []
            ctl, self._control = self._control, []
            for sid in list(self._sessions):
                self._close_locked(sid, reason="shutdown")
        for p in leftovers:
            if not p.future.done():
                p.future.set_exception(RuntimeError("DecodePool stopped"))
        for _, _, fut in ctl:
            if not fut.done():
                fut.set_exception(RuntimeError("DecodePool stopped"))

    def stats(self) -> dict:
        with self._cond:
            # exported slots are excluded: the session's state already left
            sessions = {sid: {"slot": s.slot, "tenant": s.tenant,
                              "steps": s.steps,
                              "idle_s": round(time.monotonic() -
                                              s.last_used, 3)}
                        for sid, s in self._sessions.items()
                        if not s.exported}
            exporting = sum(1 for s in self._sessions.values()
                            if s.exported)
            free = len(self._free)
            queued = len(self._queue)
            draining = self._draining
            arena = None
            if self.kv_paged and self._arena_specs:
                w_max = max(int(sp["window_eff"])
                            for sp in self._arena_specs)
                arena = {
                    "block_size": int(self.kv_block),
                    "blocks": int(sum(self._arena_blocks)),
                    "blocks_free": int(sum(len(f) for f in self._kv_free)),
                    "tokens_resident": int(sum(
                        min(s.kv_pos, w_max)
                        for s in self._sessions.values()
                        if s.kv_blocks is not None)),
                }
        out = {
            "slots": self.max_slots,
            "slots_free": free,
            "slot_ladder": list(self._ladder),
            "ttl_s": self.ttl_s,
            "queued_steps": queued,
            "deaths": self.deaths,
            "restarts": self.restarts,
            "draining": draining,
            "exporting": exporting,
            "sessions": sessions,
            **self.metrics.snapshot(),
        }
        tel = getattr(self.model, "compile_telemetry", None)
        if tel is not None:
            by_kind = tel.snapshot()["by_kind"]
            out["decode_programs"] = by_kind.get("decode_step", 0)
            out["spec_programs"] = by_kind.get("spec_step", 0)
        if self._kv_summary:
            out["kv_cache"] = dict(self._kv_summary)
        if arena is not None:
            out["kv_arena"] = arena
        return out

    # ------------------------------------------------------------------
    # Session migration
    # ------------------------------------------------------------------
    def export_session(self, sid: str, timeout: float = 30.0) -> dict:
        """Phase one of a migration: the session's decode state as a
        JSON-serializable payload, copied to the host on the pool thread
        after the session's queued and in-flight steps have landed.  The
        session then sits in ``exported`` limbo (slot held, steps rejected
        as retryable) until :meth:`finish_export`."""
        deadline = time.monotonic() + max(0.1, float(timeout))
        with self._cond:
            s = self._sessions.get(sid)
            if s is None:
                raise KeyError(f"unknown or expired decode session {sid!r}")
            if s.migrating or s.exported:
                raise TransientError(
                    f"decode session {sid} is already migrating")
            s.migrating = True
        try:
            self._wait_steps_drained(sid, deadline)
            fut = self._submit_control("export", sid)
            payload = fut.result(max(0.1, deadline - time.monotonic()))
        except BaseException:
            with self._cond:
                s2 = self._sessions.get(sid)
                if s2 is not None:
                    s2.migrating = False
            raise
        with self._cond:
            s2 = self._sessions.get(sid)
            if s2 is not None:
                s2.exported = True
                self.metrics.g_active.set(self._active_locked())
                events.emit("decode.session_exported", model=self.name,
                            session_id=sid, slot=s.slot, tenant=s.tenant,
                            steps=payload.get("steps"))
        return payload

    def finish_export(self, sid: str, ok: bool = True) -> bool:
        """Phase two: ``ok`` (the import landed) releases the slot;
        otherwise the session is reinstated and resumes where it stopped
        (its carry never left this pool)."""
        with self._cond:
            s = self._sessions.get(sid)
            if s is None:
                return False
            if ok:
                return self._close_locked(sid, reason="migrated")
            s.exported = False
            s.migrating = False
            s.last_used = time.monotonic()
            self.metrics.g_active.set(self._active_locked())
            events.emit("decode.session_reinstated", model=self.name,
                        session_id=sid, slot=s.slot, tenant=s.tenant,
                        steps=s.steps)
            return True

    def import_session(self, payload: dict, session_id: Optional[str] = None,
                       tenant: Optional[str] = None,
                       timeout: float = 30.0) -> str:
        """Restore an exported session (from this package's pool or the JAX
        package's) into this pool: claim a slot and write the payload's
        carry into it on the pool thread.  Keeps the source's session id
        unless given another."""
        sid = session_id or payload.get("session_id") or uuid.uuid4().hex[:16]
        tenant = tenant if tenant is not None else payload.get("tenant")
        with self._cond:
            if not self._running:
                raise RuntimeError("DecodePool is stopped")
            if self._draining:
                self.metrics.record_shed("decode_draining")
                raise OverloadedError(
                    "decode pool draining - not accepting migrated "
                    "sessions", retry_after_s=1.0)
            if sid in self._sessions:
                raise ValueError(f"decode session {sid!r} already exists "
                                 "in this pool")
            self._sweep_locked()
            if not self._free:
                self.metrics.record_shed("decode_slots_full")
                raise OverloadedError(
                    f"decode slots exhausted ({self.max_slots} sessions "
                    "active)", retry_after_s=1.0)
            slot = self._free.pop()
            s = DecodeSession(sid, slot, tenant)
            s.steps = int(payload.get("steps", 0) or 0)
            s.started = bool(payload.get("started")) \
                and payload.get("carry") is not None
            s.importing = payload.get("carry") is not None
            self._sessions[sid] = s
            self.metrics.record_opened(tenant)
            self.metrics.g_active.set(self._active_locked())
            events.emit("decode.session_imported", model=self.name,
                        session_id=sid, slot=slot, tenant=tenant,
                        steps=s.steps)
        try:
            if payload.get("carry") is not None:
                fut = self._submit_control("import", (s, payload))
                fut.result(max(0.1, float(timeout)))
        except BaseException:
            self.close_session(sid, reason="error")
            raise
        with self._cond:
            s.importing = False
        return sid

    def drain(self, deadline_s: Optional[float] = None) -> dict:
        """Stop admitting session joins (opens and imports shed 503) and
        report what remains; with a deadline, wait that long for the live
        sessions to leave.  :meth:`resume` re-admits."""
        with self._cond:
            already = self._draining
            self._draining = True
            held = len(self._sessions)
        if not already:
            events.emit("decode.drain", model=self.name, sessions=held)
        deadline = (None if deadline_s is None
                    else time.monotonic() + float(deadline_s))
        with self._cond:
            while self._sessions and deadline is not None \
                    and time.monotonic() < deadline:
                self._sweep_locked()
                self._cond.wait(min(0.05, max(
                    0.0, deadline - time.monotonic())))
            remaining = list(self._sessions)
        return {"draining": True, "remaining": remaining,
                "drained": not remaining}

    def resume(self) -> None:
        """Clear the draining flag."""
        with self._cond:
            was = self._draining
            self._draining = False
            if was:
                events.emit("decode.resumed", model=self.name)

    def _wait_steps_drained(self, sid: str, deadline: float) -> None:
        with self._cond:
            while any(p.session.sid == sid
                      for p in self._queue + self._inflight):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"session {sid} still has steps in flight")
                self._cond.wait(0.02)

    def _submit_control(self, kind: str, arg) -> Future:
        fut: Future = Future()
        with self._cond:
            if not self._running:
                raise RuntimeError("DecodePool is stopped")
            self._restart_if_dead_locked()
            self._control.append((kind, arg, fut))
            self._cond.notify_all()
        return fut

    def _handle_control(self, op) -> None:
        """One control op on the pool thread.  A ``kill`` fault at
        ``fleet.migrate`` resolves the waiter with a clean error first,
        then takes the thread down through the crash handler."""
        kind, arg, fut = op
        try:
            faults.check("fleet.migrate")
            with torch.no_grad():
                if kind == "export":
                    result = self._do_export(arg)
                elif kind == "import":
                    result = self._do_import(*arg)
                else:
                    raise ValueError(f"unknown control op {kind!r}")
        except BaseException as e:
            if not fut.done():
                if isinstance(e, Exception):
                    fut.set_exception(e)
                else:
                    fut.set_exception(RuntimeError(
                        "decode batcher killed mid-migration "
                        f"({type(e).__name__}: {e}); session state lost - "
                        "reopen the session and replay"))
            if not isinstance(e, Exception):
                raise
            return
        if not fut.done():
            fut.set_result(result)

    def _do_export(self, sid: str) -> dict:
        with self._cond:
            s = self._sessions.get(sid)
        if s is None:
            raise KeyError(f"unknown or expired decode session {sid!r}")
        binary = os.environ.get("DL4J_CARRY_PAYLOAD", "").lower() != "json"
        payload = {
            "version": CARRY_PAYLOAD_VERSION if binary else 1,
            "session_id": sid,
            "model": self.name,
            "tenant": s.tenant,
            "steps": s.steps,
            "started": bool(s.started),
            "dtype": seq_ops.dtype_name(self._dtype),
            "feature_tails": None,
            "carry": None,
        }
        if s.started and self._pool is not None:
            slot_slice = tree_map(lambda a: a[s.slot], self._pool)
            if self.kv_paged:
                # de-page into the dense wire layout, so paged and dense
                # pools (of either package) migrate both ways
                slot_slice = self._depage_carry(slot_slice)
            payload["carry"] = {"leaves": [
                _encode_carry_leaf(a, binary)
                for a in tree_leaves(slot_slice)]}
            payload["feature_tails"] = [list(t) for t in self._tails]
        return payload

    def _depage_carry(self, slot_slice):
        """Every paged node ``{"aid", "pos", "tbl"}`` of one slot's carry
        replaced by the dense ``{"k", "pos", "v"}`` ring the wire ships:
        the session's blocks gathered out of the arena and the live window
        laid out at its ring positions (token p at ``p % W``).  A bf16
        arena widens to f32 on the wire."""
        bs = int(self.kv_block)

        def walk(node):
            if _is_paged(node):
                aid = int(node["aid"].shape[-1]) - 1
                spec = self._arena_specs[aid]
                H, D = int(spec["heads"]), int(spec["head_dim"])
                W, w_eff = int(spec["window"]), int(spec["window_eff"])
                pos = int(node["pos"])
                tbl = node["tbl"].to(self.device)
                ka = self._arenas[aid]["k"][tbl].float().cpu()
                va = self._arenas[aid]["v"][tbl].float().cpu()
                dk = torch.zeros((H, W, D), dtype=torch.float32)
                dv = torch.zeros((H, W, D), dtype=torch.float32)
                for p in range(max(0, pos - W), pos):
                    sl = p % w_eff
                    dk[:, p % W] = ka[sl // bs, :, sl % bs]
                    dv[:, p % W] = va[sl // bs, :, sl % bs]
                return {"k": dk, "pos": torch.tensor(pos, dtype=torch.int32),
                        "v": dv}
            if isinstance(node, dict):
                return {k: walk(v) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                items = [walk(v) for v in node]
                return type(node)(*items) if hasattr(node, "_fields") \
                    else type(node)(items)
            return node

        return walk(slot_slice)

    def _do_import_paged(self, session: DecodeSession, carry: dict) -> dict:
        """Paged half of import: consume the dense wire leaves in the
        pool's flatten order, re-paging each ring's live window into newly
        allocated blocks (recorded on the session at once, so a failure
        part way frees them through the normal close)."""
        in_leaves = carry["leaves"]
        cursor = {"i": 0}
        bs = int(self.kv_block)
        slot = session.slot

        def take():
            if cursor["i"] >= len(in_leaves):
                raise ValueError(
                    f"migrated carry has {len(in_leaves)} leaves - "
                    "fewer than this pool's template needs (model "
                    "architectures differ)")
            a = _decode_carry_leaf(in_leaves[cursor["i"]])
            cursor["i"] += 1
            return a

        with self._cond:
            if session.kv_blocks is None:
                session.kv_blocks = [[] for _ in self._arena_specs]
        writes = []

        def walk(node):
            if node is None:
                return
            if _is_paged(node):
                dk, pos_a, dv = take(), take(), take()  # sorted: k, pos, v
                aid = int(node["aid"].shape[-1]) - 1
                spec = self._arena_specs[aid]
                H, D = int(spec["heads"]), int(spec["head_dim"])
                W, w_eff = int(spec["window"]), int(spec["window_eff"])
                nbs = w_eff // bs
                pos = int(pos_a.reshape(()))
                if tuple(dk.shape) != (H, W, D):
                    raise ValueError(
                        f"migrated KV leaf shape {tuple(dk.shape)} "
                        f"!= this pool's ring {(H, W, D)}")
                need = -(-min(pos, w_eff) // bs)
                with self._cond:
                    held = session.kv_blocks[aid]
                    while len(held) < need:
                        if not self._kv_free[aid]:
                            self.metrics.record_shed("kv_arena_exhausted")
                            self.metrics.c_arena_failures.inc()
                            raise OverloadedError(
                                "KV arena exhausted re-paging a migrated "
                                "session", retry_after_s=1.0)
                        held.append(self._kv_free[aid].pop())
                    blocks = list(held)
                    self._update_arena_gauges_locked()
                bk = torch.zeros((max(need, 1), H, bs, D))
                bv = torch.zeros((max(need, 1), H, bs, D))
                for p in range(max(0, pos - W), pos):
                    sl = p % w_eff
                    bk[sl // bs, :, sl % bs] = dk[:, p % W].float()
                    bv[sl // bs, :, sl % bs] = dv[:, p % W].float()
                row = torch.full((nbs,), self._arena_blocks[aid],
                                 dtype=torch.int64)
                row[:len(blocks)] = torch.tensor(blocks, dtype=torch.int64)
                writes.append((aid, blocks[:need], bk[:need], bv[:need],
                               node, pos, row))
                session.kv_pos = pos
                return
            if isinstance(node, dict):
                for k in sorted(node):
                    walk(node[k])
                return
            if isinstance(node, (list, tuple)):
                for v in node:
                    walk(v)
                return
            a = take()                      # a plain [S+1, ...] pool leaf
            if tuple(a.shape) != tuple(node.shape[1:]):
                raise ValueError(
                    f"migrated carry leaf shape {tuple(a.shape)} != the "
                    f"pool slot's {tuple(node.shape[1:])}")
            writes.append((None, node, a))

        walk(self._pool)
        if cursor["i"] != len(in_leaves):
            raise ValueError(
                f"migrated carry has {len(in_leaves)} leaves, this "
                f"pool consumed {cursor['i']} - model architectures differ")
        for w in writes:           # every check passed: write the slot
            if w[0] is None:
                _, node, a = w
                node[slot] = a.to(device=node.device, dtype=node.dtype)
                continue
            aid, blocks, bk, bv, node, pos, row = w
            if blocks:
                bidx = torch.tensor(blocks, dtype=torch.int64,
                                    device=self.device)
                ar = self._arenas[aid]
                ar["k"][bidx] = bk.to(device=self.device, dtype=ar["k"].dtype)
                ar["v"][bidx] = bv.to(device=self.device, dtype=ar["v"].dtype)
            node["pos"][slot] = pos
            node["tbl"][slot] = row.to(node["tbl"].device)
        return {"slot": slot, "leaves": cursor["i"]}

    def _do_import(self, session: DecodeSession, payload: dict) -> dict:
        """Pool-thread half of import: build the device state if needed,
        then write the payload's carry leaves into the claimed slot."""
        carry = payload["carry"]
        fts = payload.get("feature_tails")
        if self._pool is None:
            if not fts:
                raise ValueError("carry payload missing feature_tails")
            tails = [(1,) + tuple(int(d) for d in t) for t in fts]
            self._ensure_device_state(tails,
                                      _torch_dtype(payload.get("dtype"))
                                      or torch.float32)
        elif fts is not None:
            got = tuple(tuple(int(d) for d in t) for t in fts)
            if got != self._tails:
                raise ValueError(
                    f"migrated carry feature shape {got} != the pool's "
                    f"{self._tails} (one pool serves one input layout)")
        if self.kv_paged:
            return self._do_import_paged(session, carry)
        pool_leaves = tree_leaves(self._pool)
        in_leaves = carry["leaves"]
        if len(in_leaves) != len(pool_leaves):
            raise ValueError(
                f"migrated carry has {len(in_leaves)} leaves, this "
                f"pool's template has {len(pool_leaves)} - model "
                "architectures differ")
        decoded = [_decode_carry_leaf(spec) for spec in in_leaves]
        for a, p in zip(decoded, pool_leaves):
            if tuple(a.shape) != tuple(p.shape[1:]):
                raise ValueError(
                    f"migrated carry leaf shape {tuple(a.shape)} != the "
                    f"pool slot's {tuple(p.shape[1:])}")
        for a, p in zip(decoded, pool_leaves):
            p[session.slot] = a.to(device=p.device, dtype=p.dtype)
        return {"slot": session.slot, "leaves": len(decoded)}

    # ------------------------------------------------------------------
    # Warmup
    # ------------------------------------------------------------------
    def warmup(self, feature_tails, t_steps: int = 1,
               dtype=np.float32) -> dict:
        """Run the decode step once at every slot-ladder rung, on synthetic
        scratch-slot sessions through the normal queue (no real session
        state is touched).  ``feature_tails`` is one per-example tail per
        input (a bare tail is broadcast); ``t_steps`` sets the chunk."""
        tails = self._broadcast_tails(feature_tails, t_steps)
        xs = tuple(np.zeros(t, dtype) for t in tails)
        masks = tuple(None for _ in tails)
        t0 = time.perf_counter()
        for rung in self._ladder:
            self._warm_rung(rung, f"warmup-{rung}", xs, masks, None)
        return {"slot_ladder": list(self._ladder),
                "warmup_sec": round(time.perf_counter() - t0, 3)}

    def warmup_spec(self, feature_tails, k: int = 4,
                    dtype=np.float32) -> dict:
        """:meth:`warmup` for the speculative verify step: every slot-ladder
        rung at one chunk length per distinct time bucket of 1..1+k."""
        t_chunk = 1 + max(0, int(k))
        tails = self._broadcast_tails(feature_tails, t_chunk)
        if any(len(t) < 2 for t in tails):
            raise ValueError("speculative warmup needs sequence inputs "
                             "([T, C] per network input)")
        g = self.model.conf.global_conf
        chunks, seen = [], set()
        for t in range(1, t_chunk + 1):
            tb = bucketing.bucket_size(t, g.bucket_time_sizes)
            if tb not in seen:
                seen.add(tb)
                chunks.append(t)
        t0 = time.perf_counter()
        for t in chunks:
            xs = tuple(np.zeros((t,) + tuple(tail[1:]), dtype)
                       for tail in tails)
            masks = tuple(None for _ in tails)
            for rung in self._ladder:
                self._warm_rung(rung, f"warmup-spec-{t}-{rung}", xs, masks,
                                np.zeros((t,), np.int64))
        return {"slot_ladder": list(self._ladder), "k": max(0, int(k)),
                "chunks": chunks,
                "warmup_sec": round(time.perf_counter() - t0, 3)}

    def _warm_rung(self, rung, prefix, xs, masks, tok) -> None:
        futs = []
        with self._cond:
            if not self._running:
                return
            self._restart_if_dead_locked()
            for i in range(rung):
                fut = Future()
                s = DecodeSession(f"{prefix}-{i}", self.max_slots, None)
                s.started = True        # gather the scratch row
                self._queue.append(_PendingStep(s, xs, masks, fut, None,
                                                None, spec_tokens=tok))
                futs.append(fut)
            self._cond.notify_all()
        for fut in futs:
            fut.result(timeout=600)

    def _broadcast_tails(self, feature_tails, t_steps: int):
        dims = list(feature_tails)
        if not dims or not isinstance(dims[0], (tuple, list)):
            dims = [tuple(dims)] * self.n_inputs
        out = []
        for t in dims:
            t = tuple(int(d) for d in t)
            if len(t) == 1:
                t = (int(t_steps),) + t
            out.append(t)
        return out

    # ------------------------------------------------------------------
    # The pool thread
    # ------------------------------------------------------------------
    def _spawn_thread(self) -> threading.Thread:
        t = threading.Thread(
            target=self._loop_guarded, daemon=True,
            name=f"decode-batcher:{self.name or hex(id(self))}")
        t.start()
        return t

    def _drop_device_state_locked(self) -> None:
        self._pool = None
        self._arenas = None
        self._arena_specs = ()
        self._arena_blocks = ()
        self._kv_free = []

    def _loop_guarded(self) -> None:
        """The pool thread's body and crash handler: a ``BaseException``
        escaping the loop (a ``kill`` fault at ``decode.step``) fails every
        in-flight and queued step, closes every session (their carries may
        be half written) and reclaims the slots; the next submit restarts
        the thread."""
        death_err = None
        try:
            self._loop()
        except BaseException as e:
            death_err = e
            log.error("decode batcher %r thread died: %s: %s",
                      self.name, type(e).__name__, e)
        finally:
            with self._cond:
                died = self._running   # a stop() is not a death
                stranded = self._inflight + self._queue
                self._inflight = []
                ctl = []
                if died:
                    self._queue = []
                    ctl, self._control = self._control, []
                    self.deaths += 1
                    self._dead = True
                    # the arena goes with the pool: the block tables in
                    # the dropped pool were its only map
                    self._drop_device_state_locked()
                    for sid in list(self._sessions):
                        self._close_locked(sid, reason="batcher_died")
            for _, _, fut in ctl:
                if not fut.done():
                    fut.set_exception(RuntimeError(
                        "decode batcher thread died; migration aborted"))
            if died:
                for p in stranded:
                    if not p.future.done():
                        p.future.set_exception(RuntimeError(
                            "decode batcher thread died; session state "
                            "lost - reopen the session and replay"))
                rids = [p.request_id for p in stranded if p.request_id]
                sids = sorted({p.session.sid for p in stranded})
                events.emit(
                    "decode.died", severity="error", model=self.name,
                    error=(f"{type(death_err).__name__}: {death_err}"
                           if death_err is not None else "unknown"),
                    stranded=len(stranded), session_ids=sids or None,
                    request_ids=rids or None)
                flight.dump("decode_batcher_died", extra={
                    "pool": self.name, "stranded_request_ids": rids,
                    "stranded_session_ids": sids,
                    "error": repr(death_err)})

    def _loop(self) -> None:
        while True:
            with self._cond:
                ops, self._control = self._control, []
            for op in ops:
                self._handle_control(op)
            taken = self._take_batch()
            if not taken:
                if not self._running:
                    return
                with self._cond:
                    self._sweep_locked()
                continue
            taken = self._shed_expired(taken)
            if not taken:
                continue
            groups: Dict[Tuple, List[_PendingStep]] = {}
            for p in taken:
                # spec and normal steps (and each top_k) never share a
                # dispatch
                key = (tuple(a.shape for a in p.xs),
                       p.spec_tokens is not None,
                       None if p.sampling is None
                       else int(p.sampling.get("top_k", 0)))
                groups.setdefault(key, []).append(p)
            for group in groups.values():
                with self._cond:
                    self._inflight = list(group)
                self._dispatch(group)
                with self._cond:
                    self._inflight = []
                    self._cond.notify_all()

    def _take_batch(self) -> List[_PendingStep]:
        """At most ONE pending step per session (a session's steps are one
        sequential stream), the rest left queued in order.  With
        ``min_batch > 1`` the drain waits up to ``max_wait_s`` for more
        sessions to join."""
        with self._cond:
            while self._running and not self._queue and not self._control:
                self._cond.wait(0.1)
                self._sweep_locked()   # an idle pool still expires TTLs
            if not self._queue:
                return []
            deadline = time.perf_counter() + self.max_wait_s
            while True:
                taken: List[_PendingStep] = []
                seen = set()
                rest: List[_PendingStep] = []
                for p in self._queue:
                    sid = p.session.sid
                    if sid in seen or len(taken) >= self.max_slots:
                        rest.append(p)
                    else:
                        seen.add(sid)
                        taken.append(p)
                if len(taken) >= self.min_batch or not self._running \
                        or self._control:
                    self._queue = rest
                    return taken
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    self._queue = rest
                    return taken
                self._cond.wait(remaining)

    def _shed_expired(self, taken):
        now = time.monotonic()
        keep = []
        for p in taken:
            if p.deadline is not None and now >= p.deadline:
                self.metrics.record_shed("deadline")
                events.emit("request.shed", severity="warn",
                            reason="deadline", model=self.name,
                            session_id=p.session.sid,
                            request_id=p.request_id, tenant=p.tenant)
                if not p.future.done():
                    p.future.set_exception(DeadlineExceededError(
                        "decode step deadline expired while queued "
                        f"({(now - p.deadline) * 1e3:.1f} ms past budget)"))
            else:
                keep.append(p)
        return keep

    # ------------------------------------------------------------------
    # Device state
    # ------------------------------------------------------------------
    def _ensure_device_state(self, tails, dtype) -> None:
        if self._pool is not None:
            return
        n = self.max_slots + 1   # + the scratch row
        tape = (seq_ops.PagedTape(block_size=self.kv_block,
                                  dtype=self._kv_dtype)
                if self.kv_paged else None)
        ctx = (seq_ops.paged_scope(tape) if tape is not None
               else contextlib.nullcontext())
        with ctx:
            if self._is_graph:
                tmpl = self.model.rnn_carry_template(
                    n, feature_tails=tails, dtype=dtype)
            else:
                tmpl = self.model.rnn_carry_template(
                    n, feature_tail=tails[0], dtype=dtype)
        if self._carry_dtype is not None:
            tmpl = _cast_carry(tmpl, self._carry_dtype)
        self._pool = tmpl
        self._tails = tuple(tuple(t[1:]) for t in tails)
        self._dtype = dtype
        if self.kv_paged:
            self._materialize_arenas(tuple(tape.specs))
            return
        kv = _kv_ring_summary(self._pool)
        self._kv_summary = kv
        self.metrics.g_kv_rings.set(kv["rings"])
        self.metrics.g_kv_bytes.set(kv["bytes"])
        self.metrics.g_kv_window.set(kv["window"])

    def _materialize_arenas(self, specs: Tuple[dict, ...]) -> None:
        """Per-layer block arenas and free lists from the template's specs.
        Capacity is ``kv_arena_tokens`` in whole blocks (default
        ``max_slots x w_eff``), never less than one window; each arena has
        one more block, the scratch block, for unallocated entries."""
        arenas, free, nblocks = [], [], []
        nbytes = widest = 0
        for spec in specs:
            we, nbs = spec["window_eff"], spec["blocks_per_slot"]
            widest = max(widest, we)
            tokens = (self.kv_arena_tokens if self.kv_arena_tokens
                      else self.max_slots * we)
            nb = max(nbs, -(-int(tokens) // self.kv_block))
            shape = (nb + 1, spec["heads"], self.kv_block,
                     spec["head_dim"])
            dt = _torch_dtype(spec["dtype"])
            buf = {"k": torch.zeros(shape, dtype=dt, device=self.device),
                   "v": torch.zeros(shape, dtype=dt, device=self.device)}
            arenas.append(buf)
            free.append(list(range(nb)))
            nblocks.append(nb)
            nbytes += 2 * buf["k"].nelement() * buf["k"].element_size()
        self._arenas = tuple(arenas)
        with self._cond:
            self._arena_specs = tuple(specs)
            self._arena_blocks = tuple(nblocks)
            self._kv_free = free
            self._update_arena_gauges_locked()
        self._kv_summary = {
            "paged": True, "block_size": self.kv_block,
            "layers": len(specs), "blocks": sum(nblocks),
            "bytes": nbytes, "window": widest,
            "dtype": specs[0]["dtype"] if specs else None}
        self.metrics.g_kv_rings.set(len(specs))
        self.metrics.g_kv_bytes.set(nbytes)
        self.metrics.g_kv_window.set(widest)

    def _update_arena_gauges_locked(self) -> None:
        if not self._arena_specs:
            return
        widest = max(s["window_eff"] for s in self._arena_specs)
        self.metrics.g_arena_blocks.set(sum(self._arena_blocks))
        self.metrics.g_arena_free.set(sum(len(f) for f in self._kv_free))
        self.metrics.g_arena_tokens.set(sum(
            min(s.kv_pos, widest) for s in self._sessions.values()
            if s.kv_blocks is not None))

    def _kv_alloc_locked(self, s: DecodeSession, new_pos: int) -> bool:
        """Grow ``s``'s blocks so every layer covers ``new_pos`` resident
        tokens, all layers or none."""
        if s.kv_blocks is None:
            s.kv_blocks = [[] for _ in self._arena_specs]
        need = []
        for li, spec in enumerate(self._arena_specs):
            want = min(int(new_pos), spec["window_eff"])
            nblk = -(-want // self.kv_block) if want > 0 else 0
            need.append(max(0, min(nblk, spec["blocks_per_slot"])
                            - len(s.kv_blocks[li])))
        if any(n > len(self._kv_free[li]) for li, n in enumerate(need)):
            return False
        for li, n in enumerate(need):
            for _ in range(n):
                s.kv_blocks[li].append(self._kv_free[li].pop())
        return True

    def _kv_admit(self, group: List[_PendingStep],
                  t_tokens: int) -> List[_PendingStep]:
        """Before a paged dispatch, allocate each row's worst-case growth
        (``t_tokens`` more tokens); rows the arena cannot cover are shed
        retryable (:class:`OverloadedError`)."""
        if not self.kv_paged or not self._arena_specs:
            return group
        kept: List[_PendingStep] = []
        with self._cond:
            for p in group:
                s = p.session
                if s.slot >= self.max_slots:
                    kept.append(p)     # warm-up rows own no blocks
                    continue
                base = s.kv_pos if s.started else 0
                if self._kv_alloc_locked(s, base + int(t_tokens)):
                    kept.append(p)
                    continue
                self.metrics.record_shed("kv_arena_exhausted")
                self.metrics.c_arena_failures.inc()
                events.emit("decode.arena_alloc_failed", severity="warn",
                            model=self.name, session_id=s.sid,
                            slot=s.slot, tenant=p.tenant,
                            request_id=p.request_id,
                            tokens=base + int(t_tokens))
                if not p.future.done():
                    p.future.set_exception(OverloadedError(
                        "paged KV arena exhausted (no free blocks for "
                        f"{base + int(t_tokens)} resident tokens)",
                        retry_after_s=1.0))
            self._update_arena_gauges_locked()
        return kept

    def _kv_tables(self, group: List[_PendingStep], kb: int) -> Tuple:
        """Per-layer ``[Kb, blocks_per_slot]`` block tables for one
        dispatch, from the allocator's host-side truth (unallocated
        entries point at the scratch block)."""
        tbls = []
        with self._cond:
            for li, spec in enumerate(self._arena_specs):
                t = np.full((kb, spec["blocks_per_slot"]),
                            self._arena_blocks[li], np.int64)
                for r, p in enumerate(group):
                    blks = p.session.kv_blocks
                    if blks is not None and blks[li]:
                        t[r, :len(blks[li])] = blks[li]
                tbls.append(torch.from_numpy(t).to(self.device))
        return tuple(tbls)

    # ------------------------------------------------------------------
    # The dispatch: gather -> step -> scatter
    # ------------------------------------------------------------------
    def _run_step(self, carries, xs, fms, tape=None):
        """The engines' carried step on gathered carries, under the paged
        tape when there is one -> (outputs tuple, new carries)."""
        ctx = (seq_ops.paged_scope(tape) if tape is not None
               else contextlib.nullcontext())
        with ctx:
            if self._is_graph:
                return self.model._rnn_step_raw(
                    self.model.net_params, self.model.net_state, carries,
                    xs, fms)
            out, new_c = self.model._rnn_step_raw(
                self.model.net_params, self.model.net_state, carries,
                xs[0], fms[0])
            return (out,), new_c

    def _pool_step(self, idx, fresh, xs, fms, tbls=None):
        """One decode dispatch on the device: gather, step, scatter."""
        carries = _gather_slots(self._pool, idx, fresh)
        tape = (seq_ops.PagedTape(block_size=self.kv_block,
                                  arenas=self._arenas, tables=tbls)
                if self.kv_paged else None)
        outs, new_c = self._run_step(carries, xs, fms, tape)
        _scatter_slots(self._pool, idx, new_c)
        return outs

    def _spec_verify(self, idx, fresh, xs, tok, nv, tbls=None,
                     sampling=None):
        """The speculative verify of one dispatch (JAX ``_spec_verify_raw``
        :473 and ``_spec_verify_general`` :544): the chunk of the pending
        token and K drafts runs token by token through the carried step,
        keeping each step's carry (cloned first: the KV ring is written in
        place); the longest draft prefix the target agrees with is found on
        the device, and each row's carry at exactly that point is written
        back.  A paged arena cannot be kept per step: its rejected writes
        are rolled back from the undo journal.  ``sampling`` = (seeds,
        pos0, temperatures, top_k) switches greedy argmax to
        position-keyed sampling.  -> (outs [B, T, C], picks [B, T],
        accept [B])."""
        c = _gather_slots(self._pool, idx, fresh)
        B, T = tok.shape
        valid = torch.arange(T, device=tok.device)[None, :] < nv[:, None]
        outs, stack, journals = [], [], []
        for t in range(T):
            xts = tuple(x[:, t:t + 1] for x in xs)
            m = valid[:, t:t + 1].float()
            tape = (seq_ops.PagedTape(block_size=self.kv_block,
                                      arenas=self._arenas, tables=tbls,
                                      record_undo=True)
                    if self.kv_paged else None)
            c_in = tree_map(torch.clone, c) if t else c
            out_t, c = self._run_step(c_in, xts, tuple(m for _ in xts), tape)
            outs.append(out_t[0][:, 0])
            stack.append(c)
            if tape is not None:
                journals.append(tape.collect_undo())
        outs = torch.stack(outs, dim=1)                       # [B, T, C]
        if sampling is not None:
            picks = _sample_picks(outs, *sampling)
        else:
            picks = torch.argmax(outs, dim=-1)
        match = (picks[:, :-1] == tok[:, 1:]) & valid[:, 1:]
        lead = torch.cumprod(match.to(torch.int64), dim=1)
        accept = torch.minimum(1 + lead.sum(dim=1),
                               torch.clamp(nv, min=1))
        rows = torch.arange(B, device=tok.device)
        sel = tree_map(lambda *steps: torch.stack(steps)[accept - 1, rows],
                       *stack)
        _scatter_slots(self._pool, idx, sel)
        if journals:
            reject = torch.arange(T, device=tok.device)[:, None] \
                >= accept[None, :]                            # [T, B]
            for li, arena in enumerate(self._arenas):
                j = {k: torch.cat([steps[li][k] for steps in journals])
                     for k in ("pb", "o", "k", "v")}
                seq_ops.restore_paged(arena, j, reject)
        return outs, picks, accept

    def _dispatch(self, group: List[_PendingStep]) -> None:
        rids = [p.request_id for p in group if p.request_id]
        with events.scope(model=self.name or None,
                          request_ids=rids or None), torch.no_grad():
            if group[0].spec_tokens is not None:
                self._dispatch_spec(group)
            else:
                self._dispatch_traced(group)

    def _check_tails(self, tails) -> None:
        feat_tails = tuple(tuple(t[1:]) for t in tails)
        if self._tails is not None and feat_tails != self._tails:
            raise ValueError(
                f"decode feature shape {feat_tails} != the pool's "
                f"{self._tails} (one pool serves one input layout)")

    def _fail_closed(self) -> None:
        """A step that failed part way may have left the pool half
        written: drop the device state and every session holding carries
        in it."""
        with self._cond:
            self._drop_device_state_locked()
            for sid in list(self._sessions):
                self._close_locked(sid, reason="error")

    def _dispatch_traced(self, group: List[_PendingStep]) -> None:
        t_dispatch = time.perf_counter()
        compute_entered = False
        try:
            faults.check("decode.step")
            g = self.model.conf.global_conf
            scratch = self.max_slots
            tails = [tuple(a.shape) for a in group[0].xs]
            self._check_tails(tails)
            self._ensure_device_state(tails, torch.float32)
            # paged arenas admit by tokens: grow each row's blocks for the
            # chunk's worst case; rows that do not fit shed retryable
            group = self._kv_admit(group, int(tails[0][0]))
            if not group:
                return
            K = len(group)
            Kb = bucketing.bucket_size(K, self._ladder)
            idx = np.full((Kb,), scratch, np.int64)
            # pad rows run fresh: the scratch row never feeds a result
            fresh = np.ones((Kb,), bool)
            xs_h, fms_h, pairs = [], [], []
            for i, tail in enumerate(tails):
                seq = len(tail) >= 2
                T = int(tail[0])
                Tb = (bucketing.bucket_size(T, g.bucket_time_sizes)
                      if seq else T)
                pairs.append((T, Tb))
                x = np.zeros((Kb, Tb) + tuple(tail[1:]), np.float32)
                fm = np.zeros((Kb, Tb), np.float32) if seq else None
                for r, p in enumerate(group):
                    x[r, :T] = p.xs[i]
                    if fm is not None:
                        fm[r, :T] = (1.0 if p.masks[i] is None
                                     else p.masks[i][:T])
                xs_h.append(x)
                fms_h.append(fm)
            for r, p in enumerate(group):
                idx[r] = p.session.slot
                fresh[r] = not p.session.started
                if self.kv_paged and p.session.slot >= self.max_slots:
                    # warm-up rows own no blocks: fresh and fully masked,
                    # so they never write the shared scratch block
                    fresh[r] = True
                    for fm in fms_h:
                        if fm is not None:
                            fm[r] = 0.0
            dev = self.device
            idx_d = torch.from_numpy(idx).to(dev)
            fresh_d = torch.from_numpy(fresh).to(dev)
            xs_d = tuple(torch.from_numpy(x).to(dev) for x in xs_h)
            fms_d = tuple(None if m is None else torch.from_numpy(m).to(dev)
                          for m in fms_h)
            tbls_d = self._kv_tables(group, Kb) if self.kv_paged else None
            tel = getattr(self.model, "compile_telemetry", None)
            if tel is not None:
                tel.record("decode_step", (idx_d, fresh_d, xs_d, fms_d))
            t0 = time.perf_counter()
            compute_entered = True
            outs = self._pool_step(idx_d, fresh_d, xs_d, fms_d, tbls_d)
            outs = tuple(o.cpu().numpy() for o in outs)   # the host copy
            t1 = time.perf_counter()
            T = next((t for t, _ in pairs), 1)
            sliced = []
            for o in outs:
                o = o[:K]
                for t, tb in pairs:
                    if tb != t and o.ndim >= 3 and o.shape[1] == tb:
                        o = o[:, :t]
                        break
                sliced.append(o)
            now = time.monotonic()
            for r, p in enumerate(group):
                p.session.started = True
                p.session.steps += 1
                p.session.last_used = now
                if self.kv_paged and p.session.slot < self.max_slots:
                    m0 = p.masks[0] if p.masks else None
                    p.session.kv_pos += (T if m0 is None
                                         else int(np.sum(m0[:T] > 0)))
                p.future.set_result(tuple(o[r] for o in sliced))
                self.metrics.record_step(p.tenant, n_tokens=T)
                self.metrics.h_queue.observe(t_dispatch - p.t_enqueue)
                self.metrics.h_step.observe(t1 - t0)
                events.emit("decode.step", model=self.name,
                            session_id=p.session.sid, slot=p.session.slot,
                            tenant=p.tenant, request_id=p.request_id,
                            tokens=T, step=p.session.steps)
            self.metrics.record_batch(K)
        except Exception as e:
            for p in group:
                if not p.future.done():
                    p.future.set_exception(e)
            if compute_entered:
                self._fail_closed()

    def _dispatch_spec(self, group: List[_PendingStep]) -> None:
        t_dispatch = time.perf_counter()
        compute_entered = False
        try:
            faults.check("decode.step")
            scratch = self.max_slots
            tails = [tuple(a.shape) for a in group[0].xs]
            if any(len(t) < 2 for t in tails):
                raise ValueError("speculative decode needs sequence "
                                 "inputs ([T, C] per network input)")
            self._check_tails(tails)
            sampling = group[0].sampling is not None
            top_k = (int(group[0].sampling.get("top_k", 0))
                     if sampling else 0)
            self._ensure_device_state(tails, torch.float32)
            T = int(tails[0][0])
            # worst-case admission: the verify may commit the whole chunk;
            # kv_pos advances by the acceptance after the dispatch
            group = self._kv_admit(group, T)
            if not group:
                return
            K = len(group)
            Kb = bucketing.bucket_size(K, self._ladder)
            # the chunk runs token by token, so its time axis needs no
            # bucket (the JAX package pads it for its compiled scan)
            idx = np.full((Kb,), scratch, np.int64)
            fresh = np.ones((Kb,), bool)
            nv = np.zeros((Kb,), np.int64)
            tok = np.zeros((Kb, T), np.int64)
            seeds = [0] * Kb
            pos0 = [0] * Kb
            temp = np.ones((Kb,), np.float32)
            xs_h = []
            for i, tail in enumerate(tails):
                x = np.zeros((Kb, T) + tuple(tail[1:]), np.float32)
                for r, p in enumerate(group):
                    x[r] = p.xs[i]
                xs_h.append(x)
            for r, p in enumerate(group):
                idx[r] = p.session.slot
                fresh[r] = not p.session.started
                nv[r] = T
                tok[r, :T] = p.spec_tokens
                if sampling:
                    seeds[r] = int(p.sampling.get("seed", 0))
                    pos0[r] = int(p.sampling.get("pos", 0))
                    temp[r] = float(p.sampling.get("temperature",
                                                   1.0) or 1.0)
                if self.kv_paged and p.session.slot >= self.max_slots:
                    fresh[r] = True
                    nv[r] = 0
            dev = self.device
            idx_d = torch.from_numpy(idx).to(dev)
            fresh_d = torch.from_numpy(fresh).to(dev)
            xs_d = tuple(torch.from_numpy(x).to(dev) for x in xs_h)
            tok_d = torch.from_numpy(tok).to(dev)
            nv_d = torch.from_numpy(nv).to(dev)
            tbls_d = self._kv_tables(group, Kb) if self.kv_paged else None
            samp = ((seeds, pos0, torch.from_numpy(temp).to(dev), top_k)
                    if sampling else None)
            tel = getattr(self.model, "compile_telemetry", None)
            if tel is not None:
                tel.record("spec_step", (idx_d, fresh_d, xs_d, tok_d, nv_d))
            t0 = time.perf_counter()
            compute_entered = True
            outs, picks, accept = self._spec_verify(
                idx_d, fresh_d, xs_d, tok_d, nv_d, tbls_d, samp)
            outs = outs.cpu().numpy()
            picks = picks.cpu().numpy()
            accept = accept.cpu().numpy()
            t1 = time.perf_counter()
            now = time.monotonic()
            for r, p in enumerate(group):
                acc = int(accept[r])
                p.session.started = True
                p.session.steps += 1
                p.session.last_used = now
                if self.kv_paged and p.session.slot < self.max_slots:
                    p.session.kv_pos += acc
                p.future.set_result((outs[r], picks[r], acc))
                self.metrics.record_step(p.tenant, n_tokens=acc)
                self.metrics.record_spec(p.tenant, proposed=T - 1,
                                         accepted=acc)
                self.metrics.h_queue.observe(t_dispatch - p.t_enqueue)
                self.metrics.h_step.observe(t1 - t0)
                events.emit("decode.spec_verified", model=self.name,
                            session_id=p.session.sid, slot=p.session.slot,
                            tenant=p.tenant, request_id=p.request_id,
                            proposed=T - 1, accepted=acc,
                            step=p.session.steps)
            self.metrics.record_batch(K)
        except Exception as e:
            for p in group:
                if not p.future.done():
                    p.future.set_exception(e)
            if compute_entered:
                self._fail_closed()


def _torch_dtype(d) -> Optional[torch.dtype]:
    """``"bfloat16"`` / ``torch.bfloat16`` / None -> a torch dtype."""
    if d is None or isinstance(d, torch.dtype):
        return d
    name = str(d).replace("torch.", "")
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {d!r}")
    return dt


class DecodeManager:
    """The gateway's side: session ids -> per-model :class:`DecodePool`\\ s
    over the gateway's :class:`ModelCache`.  Pools are keyed by (model
    path, carry layout): one pool's ``[S+1, ...]`` buffers serve exactly
    one carry structure, so an attention model and an RNN, or two rollouts
    of one path whose carry changed, get separate pools.  A reloaded model
    with an unchanged layout is adopted once its pool has drained."""

    def __init__(self, model_cache, max_slots: int = 32,
                 ttl_s: float = 600.0, max_wait_ms: float = 2.0,
                 min_batch: int = 1, retry_after_s: float = 1.0,
                 kv_paged: Optional[bool] = None,
                 kv_block: Optional[int] = None,
                 kv_arena_tokens: Optional[int] = None,
                 kv_dtype=None, carry_dtype=None):
        self.model_cache = model_cache
        self.max_slots = max(1, int(max_slots))
        self.ttl_s = float(ttl_s)
        self.max_wait_ms = float(max_wait_ms)
        self.min_batch = int(min_batch)
        self.retry_after_s = float(retry_after_s)
        # forwarded to every pool (None defers to the DL4J_KV_* env)
        self.kv_paged = kv_paged
        self.kv_block = kv_block
        self.kv_arena_tokens = kv_arena_tokens
        self.kv_dtype = kv_dtype
        self.carry_dtype = carry_dtype
        self._lock = threading.Lock()
        #: model path -> carry-layout fingerprint -> pool
        self._pools: Dict[str, Dict[str, DecodePool]] = {}
        self._by_sid: Dict[str, DecodePool] = {}
        self._draining = False

    @staticmethod
    def _carry_layout(model) -> str:
        """Fingerprint of the model's decode-carry structure (the tree's
        shape and per-slot leaf shapes and dtypes of
        ``rnn_carry_template``), the pool-compatibility key; ``-`` for a
        model whose template cannot be built."""
        cached = getattr(model, "_dl4j_carry_layout", None)
        if cached is not None:
            return cached

        def desc(node):
            if node is None:
                return "None"
            if isinstance(node, dict):
                return "{" + ",".join(f"{k}:{desc(node[k])}"
                                      for k in sorted(node)) + "}"
            if isinstance(node, (list, tuple)):
                return f"{type(node).__name__}[" + ",".join(
                    desc(v) for v in node) + "]"
            return (f"{tuple(node.shape[1:])}:"
                    f"{seq_ops.dtype_name(node.dtype)}")
        try:
            layout = hashlib.blake2b(
                desc(model.rnn_carry_template(1)).encode(),
                digest_size=6).hexdigest()
        except Exception:
            layout = "-"
        try:
            model._dl4j_carry_layout = layout
        except Exception:
            pass
        return layout

    def _pool_for(self, model_path: str) -> DecodePool:
        key = os.path.abspath(str(model_path))
        model = self.model_cache.get(key)
        layout = self._carry_layout(model)
        retired = []
        with self._lock:
            by_layout = self._pools.setdefault(key, {})
            pool = by_layout.get(layout)
            if pool is not None and pool.model is not model \
                    and pool.held_slots == 0 and pool.queue_rows() == 0:
                retired.append(pool)   # a reloaded model, same layout
                pool = None
            if pool is None:
                pool = DecodePool(
                    model, name=os.path.basename(key),
                    max_slots=self.max_slots, ttl_s=self.ttl_s,
                    max_wait_ms=self.max_wait_ms, min_batch=self.min_batch,
                    kv_paged=self.kv_paged, kv_block=self.kv_block,
                    kv_arena_tokens=self.kv_arena_tokens,
                    kv_dtype=self.kv_dtype, carry_dtype=self.carry_dtype)
                by_layout[layout] = pool
            for lay, p in list(by_layout.items()):
                if lay != layout and p.model is not model \
                        and p.held_slots == 0 and p.queue_rows() == 0:
                    retired.append(by_layout.pop(lay))
        for p in retired:
            p.stop(timeout=5.0)
        return pool

    def _all_pools(self) -> List[DecodePool]:
        with self._lock:
            return [p for by_layout in self._pools.values()
                    for p in by_layout.values()]

    def _pool_items(self):
        with self._lock:
            return [(key, lay, p) for key, by_layout in self._pools.items()
                    for lay, p in by_layout.items()]

    def open_session(self, model_path: str,
                     tenant: Optional[str] = None) -> dict:
        with self._lock:
            if self._draining:
                raise OverloadedError(
                    "decode draining (rollout/migration in progress)",
                    retry_after_s=self.retry_after_s)
        pool = self._pool_for(model_path)
        sid = pool.open_session(tenant=tenant,
                                retry_after_s=self.retry_after_s)
        with self._lock:
            self._by_sid[sid] = pool
        return {"session_id": sid, "model": pool.name,
                "slots": pool.max_slots,
                "slots_free": pool.max_slots - pool.held_slots}

    def _pool_of(self, session_id: str) -> DecodePool:
        with self._lock:
            pool = self._by_sid.get(session_id)
        if pool is None:
            raise KeyError(
                f"unknown or expired decode session {session_id!r}")
        return pool

    def decode_step(self, session_id: str, x, mask=None,
                    timeout_ms: Optional[float] = None,
                    tenant: Optional[str] = None,
                    timeout: Optional[float] = 60.0):
        pool = self._pool_of(session_id)
        try:
            return pool.step(session_id, x, masks=mask, timeout=timeout,
                             timeout_ms=timeout_ms, tenant=tenant)
        except KeyError:
            with self._lock:
                self._by_sid.pop(session_id, None)
            raise

    def warmup(self, model_path: str, feature_tails,
               t_steps: int = 1) -> dict:
        """Run ``model_path``'s pool's decode step at every ladder rung."""
        return self._pool_for(model_path).warmup(feature_tails,
                                                 t_steps=t_steps)

    def warmup_spec(self, model_path: str, feature_tails,
                    k: int = 4) -> dict:
        """:meth:`DecodePool.warmup_spec` for ``model_path``'s pool."""
        return self._pool_for(model_path).warmup_spec(feature_tails, k=k)

    def spec_step(self, session_id: str, xs, token_ids,
                  timeout_ms: Optional[float] = None,
                  tenant: Optional[str] = None,
                  timeout: Optional[float] = 60.0,
                  sampling: Optional[dict] = None):
        pool = self._pool_of(session_id)
        try:
            return pool.spec_step(session_id, xs, token_ids,
                                  timeout=timeout, timeout_ms=timeout_ms,
                                  tenant=tenant, sampling=sampling)
        except KeyError:
            with self._lock:
                self._by_sid.pop(session_id, None)
            raise

    def close_session(self, session_id: str) -> bool:
        with self._lock:
            pool = self._by_sid.pop(session_id, None)
        if pool is None:
            return False
        return pool.close_session(session_id)

    def export_session(self, session_id: str) -> dict:
        """Phase one of a migration: the session's carry snapshot."""
        return self._pool_of(session_id).export_session(session_id)

    def finish_export(self, session_id: str, ok: bool = True) -> bool:
        """Phase two: confirm (release the slot) or abort (reinstate)."""
        with self._lock:
            pool = self._by_sid.get(session_id)
        if pool is None:
            return False
        done = pool.finish_export(session_id, ok=ok)
        if ok and done:
            with self._lock:
                self._by_sid.pop(session_id, None)
        return done

    def import_session(self, model_path: str, payload: dict,
                       session_id: Optional[str] = None,
                       tenant: Optional[str] = None) -> dict:
        """Restore an exported session into this manager's pool for
        ``model_path`` (keeping the source's session id by default)."""
        with self._lock:
            if self._draining:
                raise OverloadedError(
                    "decode draining - not accepting migrated sessions",
                    retry_after_s=self.retry_after_s)
        pool = self._pool_for(model_path)
        sid = pool.import_session(payload, session_id=session_id,
                                  tenant=tenant)
        with self._lock:
            self._by_sid[sid] = pool
        return {"session_id": sid, "model": pool.name,
                "slots": pool.max_slots,
                "slots_free": pool.max_slots - pool.held_slots}

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def drain(self, deadline_s: Optional[float] = None) -> dict:
        """Stop admitting session joins across every pool and report the
        remaining sessions per model; :meth:`resume` re-admits."""
        with self._lock:
            self._draining = True
        out: Dict[str, dict] = {}
        for key, lay, pool in self._pool_items():
            k = key if key not in out else f"{key}#{lay}"
            out[k] = pool.drain(deadline_s)
        return out

    def resume(self) -> None:
        with self._lock:
            self._draining = False
        for p in self._all_pools():
            p.resume()

    def queue_rows(self) -> int:
        return sum(p.queue_rows() for p in self._all_pools())

    def queue_rows_by_tenant(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for p in self._all_pools():
            for t, n in p.queue_rows_by_tenant().items():
                out[t] = out.get(t, 0) + n
        return out

    def batchers_alive(self) -> bool:
        return all(p.thread_alive for p in self._all_pools()
                   if p.held_slots > 0 or p.queue_rows() > 0)

    def sweep(self) -> int:
        n = sum(p.sweep() for p in self._all_pools())
        with self._lock:
            self._by_sid = {sid: p for sid, p in self._by_sid.items()
                            if sid in p.session_ids()}
        return n

    def stats(self) -> dict:
        out: Dict[str, dict] = {}
        for key, lay, pool in self._pool_items():
            k = key if key not in out else f"{key}#{lay}"
            out[k] = pool.stats()
        return out

    def invalidate(self, model_path: Optional[str] = None) -> int:
        """Stop pool(s): their sessions fail and their slots free."""
        with self._lock:
            if model_path is None:
                dropped = [p for by_layout in self._pools.values()
                           for p in by_layout.values()]
                self._pools.clear()
            else:
                key = os.path.abspath(str(model_path))
                dropped = list((self._pools.pop(key, None) or {}).values())
            self._by_sid = {sid: p for sid, p in self._by_sid.items()
                            if p not in dropped}
        for p in dropped:
            p.stop(timeout=5.0)
        return len(dropped)

    def close(self) -> None:
        self.invalidate(None)
