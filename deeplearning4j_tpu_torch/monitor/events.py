"""Structured event journal + request-scoped trace context — a copy of
``deeplearning4j_tpu/monitor/events.py`` (pure Python; the port's
journal publishes its per-type counts into the port's registry).

Metrics (monitor/registry.py) answer "how much / how fast"; the journal
answers "what happened, in what order, to WHICH request".  Three pieces:

* **Trace context** — a contextvars-carried dict of correlation fields
  (``request_id``, ``tenant``, ``session_id``, ``fit_id``, ...).  The
  gateway mints a request ID per RPC (:func:`new_request_id`, carried by
  :func:`scope`/:func:`request_scope`); worker threads that process
  requests on behalf of other threads (the micro-batcher, the decode
  batcher) capture :func:`current_context` at enqueue time and re-attach
  it to the events they emit, so one request ID joins gateway admission
  → batcher queue → coalesced compute → response.

* **Event journal** — a lock-cheap bounded ring of typed events
  (:class:`EventJournal`).  :func:`emit` appends one dict (type,
  severity, wall timestamp, thread, the current trace context, plus the
  caller's fields) under a single uncontended lock; the ring drops the
  oldest event past ``capacity`` so a journal can run forever.  Event
  type names are the taxonomy in :data:`EVENT_TYPES`, linted against
  the docs/OBSERVABILITY.md catalog in both directions (DL4J303/304).

* **Chrome trace export** — :func:`chrome_trace` renders journal events
  as Chrome trace-event JSON (Perfetto-loadable: open
  https://ui.perfetto.dev and drop the file): ``span.close`` events
  become complete ("X") slices with real durations, everything else
  becomes instant ("i") marks, correlation fields ride in ``args``.

``DL4J_JOURNAL=0`` is the kill switch: :func:`emit` returns immediately
— events become no-ops, not queued.  ``DL4J_JOURNAL_CAPACITY`` sizes
the ring (default 2048).  The overhead A/B lever for benchmarks is
:func:`set_enabled` (``bench_serving`` reports ``journal_overhead_pct``,
required ≤ 5%).
"""

from __future__ import annotations

import contextvars
import itertools
import os
import threading
import time
import uuid
from collections import deque
from typing import Dict, List, Optional

#: The event taxonomy — every ``emit()`` call site in the framework uses
#: one of these names, and docs/OBSERVABILITY.md catalogs each of them
#: (dl4j-lint DL4J303/304 fail on drift in either direction).
EVENT_TYPES = (
    "span.open",
    "span.close",
    "rpc.request",
    "rpc.response",
    "request.admitted",
    "request.enqueued",
    "request.done",
    "request.shed",
    "batch.dispatch",
    "batcher.died",
    "batcher.restarted",
    "decode.step",
    "decode.spec_verified",
    "decode.arena_alloc_failed",
    "decode.session_opened",
    "decode.session_closed",
    "decode.session_exported",
    "decode.session_imported",
    "decode.session_reinstated",
    "decode.drain",
    "decode.resumed",
    "decode.died",
    "decode.restarted",
    "fleet.replica_added",
    "fleet.replica_removed",
    "fleet.replica_health",
    "fleet.migrated",
    "fleet.migrate_failed",
    "fleet.rollout",
    "slo.state_changed",
    "slo.replica_parked",
    "slo.alert_delivered",
    "dist.worker_joined",
    "dist.worker_active",
    "dist.worker_suspect",
    "dist.worker_dead",
    "dist.generation_rolled",
    "dist.step_fenced",
    "dist.snapshot_transferred",
    "dist.snapshot_restored",
    "dist.heartbeat_lost",
    "cache.load",
    "cache.evicted",
    "rollout.flip",
    "rollout.failed",
    "fault.injected",
    "breaker.transition",
    "checkpoint.write",
    "checkpoint.fallback",
    "checkpoint.restored",
    "fit.start",
    "fit.end",
    "compile.retrace",
    "sanitizer.violation",
    "readyz.flip",
    "flight.dump",
    "ui.stats_posted",
)

SEVERITIES = ("info", "warn", "error")

DEFAULT_CAPACITY = 2048

_flags = {"enabled": None}

#: per-task/thread correlation fields; never mutated in place — scopes
#: push merged copies so concurrent readers see a consistent dict
_ctx: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "dl4j_trace_ctx", default=None)


# ----------------------------------------------------------------------
# Kill switch
# ----------------------------------------------------------------------
# parsed-env cache: os.environ.get is an encode/decode MutableMapping
# hop (~µs), and enabled() runs on every emit and every span — the env
# is read once and re-read only after set_enabled() resets the cache
_env_cache: Dict[str, Optional[bool]] = {"enabled": None, "verbose": None}


def set_enabled(on: Optional[bool]) -> None:
    """Force the journal on/off; ``None`` restores the env default
    (``DL4J_JOURNAL``, re-read from the environment) — the bench A/B
    lever, mirroring ``tracing.set_enabled``."""
    _flags["enabled"] = None if on is None else bool(on)
    _env_cache["enabled"] = None
    _env_cache["verbose"] = None


def enabled() -> bool:
    on = _flags["enabled"]
    if on is not None:
        return on
    on = _env_cache["enabled"]
    if on is None:
        on = _env_cache["enabled"] = \
            os.environ.get("DL4J_JOURNAL", "1") != "0"
    return on


def verbose() -> bool:
    """``DL4J_JOURNAL_VERBOSE=1`` adds the high-volume event forms
    (``span.open``, per-request ``request.enqueued``/``request.done``)
    for fine-grained debugging; off by default to hold the always-on
    journal under the serving overhead budget."""
    if not enabled():
        return False
    v = _env_cache["verbose"]
    if v is None:
        v = _env_cache["verbose"] = \
            os.environ.get("DL4J_JOURNAL_VERBOSE") == "1"
    return v


# ----------------------------------------------------------------------
# Trace context
# ----------------------------------------------------------------------
# one random process prefix + a GIL-atomic counter: minting an ID is
# ~20x cheaper than uuid4() (an os.urandom syscall per request would be
# a measurable slice of a sub-millisecond predict), still unique across
# processes and unguessable enough for correlation purposes
_RID_PREFIX = uuid.uuid4().hex[:8]
_RID_SEQ = itertools.count(1)


def new_request_id() -> str:
    """Mint a correlation ID (gateway RPCs, fit runs)."""
    return f"{_RID_PREFIX}{next(_RID_SEQ):08x}"


def current_context() -> dict:
    """The correlation fields in scope on this thread/task (a copy)."""
    cur = _ctx.get()
    return dict(cur) if cur else {}


class _Scope:
    """Hand-rolled context manager (not ``@contextmanager``): scopes sit
    on the per-request hot path, and a slotted object with plain
    ``__enter__``/``__exit__`` skips the generator machinery."""

    __slots__ = ("_fields", "_result", "_token")

    def __init__(self, fields: dict, result=None):
        self._fields = fields
        self._result = result

    def __enter__(self):
        cur = _ctx.get()
        merged = dict(cur) if cur else {}
        for k, v in self._fields.items():
            if v is not None:
                merged[k] = v
        self._token = _ctx.set(merged)
        return self._result if self._result is not None else merged

    def __exit__(self, *exc):
        _ctx.reset(self._token)
        return False


def scope(**fields) -> _Scope:
    """Push correlation fields for the duration of the block; ``None``
    values are dropped, nested scopes merge (inner wins).  Every
    :func:`emit` inside the block carries the merged fields."""
    return _Scope(fields)


def request_scope(tenant: Optional[str] = None, **fields) -> _Scope:
    """Enter (or continue) a request scope: reuses the request ID the
    HTTP server already minted for this RPC, mints one for direct
    (in-process) entry-point calls, and yields it — so bench harnesses
    and tests calling ``DeepLearning4jEntryPoint`` without a ``Server``
    still get correlated events."""
    cur = _ctx.get()
    rid = (cur.get("request_id") if cur else None) or new_request_id()
    fields["request_id"] = rid
    fields["tenant"] = tenant
    return _Scope(fields, result=rid)


# ----------------------------------------------------------------------
# The journal
# ----------------------------------------------------------------------
class Event(tuple):
    """One journal record: a 7-tuple of ``(type, severity, ts, tid,
    seq, ctx, fields)``.  The emit path stores REFERENCES — the scope's
    context dict (scopes build fresh merged dicts and never mutate them
    in place, so a captured reference is stable) and the caller's
    kwargs dict — and the flat dict form is materialized only when
    something reads the journal (tail/export/dump).  A tuple subclass
    keeps emitting a single ``BUILD_TUPLE`` + C allocation instead of
    an object construction plus seven attribute stores: this is the
    hottest line in the serving path's instrumentation."""

    __slots__ = ()

    type = property(lambda self: self[0])
    severity = property(lambda self: self[1])
    ts = property(lambda self: self[2])
    tid = property(lambda self: self[3])
    seq = property(lambda self: self[4])
    ctx = property(lambda self: self[5])
    fields = property(lambda self: self[6])

    def to_dict(self) -> dict:
        ev = {"type": self[0], "severity": self[1],
              "ts": self[2], "tid": self[3]}
        if self[5]:
            ev.update(self[5])
        for k, v in self[6].items():
            if v is not None:
                ev[k] = v
        ev["seq"] = self[4]
        return ev

    def get(self, key, default=None):
        ev = self.to_dict()
        v = ev.get(key, default)
        return v if v is not None else default


_EVENT = Event   # local alias: one global load on the emit hot path


class EventJournal:
    """Bounded lock-free ring of event dicts.  ``deque(maxlen=).append``
    and ``list(deque)`` are single C calls — atomic under the GIL — so
    the emit path takes NO lock of its own: one dict build, one atomic
    sequence bump, one atomic append, one cached per-type counter inc.
    Concurrent emitters never contend on a journal lock (the serving
    path has 8+ threads emitting against one batcher), and a snapshot
    can never observe a torn ring."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            try:
                capacity = int(os.environ.get("DL4J_JOURNAL_CAPACITY",
                                              str(DEFAULT_CAPACITY)))
            except ValueError:
                capacity = DEFAULT_CAPACITY
        self.capacity = max(16, int(capacity))
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = itertools.count(1)   # next() is GIL-atomic
        self._last_seq = 0
        # per-type counts are plain dict bumps published to the registry
        # at SCRAPE time by the collector below: a per-emit labels()+inc
        # would pay two lock rounds on every event (a rare lost bump in
        # a diagnostic counter is an acceptable trade for a lock-free
        # hot path)
        self._type_counts: Dict[str, int] = {}
        self._published: Dict[str, int] = {}
        try:
            from deeplearning4j_tpu_torch.monitor.registry import get_registry
            get_registry().register_collector(self._publish_counts)
        except Exception:
            pass  # a journal without exposition still journals

    def _publish_counts(self, reg) -> None:
        """Scrape-time collector: advance the registry counter by what
        accumulated since the last snapshot."""
        fam = reg.counter("dl4j_journal_events_total",
                          "structured journal events emitted, by type",
                          labels=("type",))
        for etype, n in list(self._type_counts.items()):
            last = self._published.get(etype, 0)
            if n > last:
                fam.labels(type=etype).inc(n - last)
                self._published[etype] = n

    def emit(self, etype: str, severity: str = "info",
             **fields) -> Optional[Event]:
        """Append one event (no-op returning None when the journal is
        disabled).  The current trace context merges in under the
        caller's explicit fields (explicit wins) when the event is
        read back."""
        # enabled() inlined: this is THE hot path, every call counts
        on = _flags["enabled"]
        if on is None:
            on = _env_cache["enabled"]
            if on is None:
                on = _env_cache["enabled"] = \
                    os.environ.get("DL4J_JOURNAL", "1") != "0"
        if not on:
            return None
        seq = self._last_seq = next(self._seq)
        e = _EVENT((etype, severity, time.time(), threading.get_ident(),
                    seq, _ctx.get(), fields))
        self._ring.append(e)
        tc = self._type_counts
        tc[etype] = tc.get(etype, 0) + 1
        return e

    def tail(self, n: Optional[int] = None, etype: Optional[str] = None,
             request_id: Optional[str] = None,
             severity: Optional[str] = None) -> List[dict]:
        """The newest events as flat dicts, oldest-first — optionally
        filtered by type, correlation ID, or minimum severity."""
        raw = list(self._ring)   # one C call: atomic vs appends
        if etype is not None:
            raw = [e for e in raw if e.type == etype]
        if severity is not None:
            floor = SEVERITIES.index(severity)
            raw = [e for e in raw
                   if SEVERITIES.index(e.severity) >= floor]
        out = [e.to_dict() for e in raw]
        if request_id is not None:
            out = [e for e in out
                   if e.get("request_id") == request_id
                   or request_id in (e.get("request_ids") or ())]
        if n is not None:
            out = out[-int(n):]
        return out

    @property
    def total_emitted(self) -> int:
        return self._last_seq

    @property
    def dropped(self) -> int:
        """Events that have already rotated out of the ring."""
        return max(0, self._last_seq - len(self._ring))

    def clear(self) -> None:
        self._ring.clear()


_JOURNAL = EventJournal()


def get_journal() -> EventJournal:
    """THE process-wide journal — serving, decode, fit, resilience and
    the flight recorder all read/write this one instance."""
    return _JOURNAL


# the module-level form every instrumented call site uses: a direct
# bound-method reference, so the hot path pays no wrapper frame and no
# kwargs re-packing
emit = _JOURNAL.emit


# ----------------------------------------------------------------------
# Chrome trace-event export (Perfetto-loadable)
# ----------------------------------------------------------------------
_META_KEYS = ("type", "severity", "ts", "tid", "seq")


def _chrome_entries(events: List[dict], pid: int) -> tuple:
    """(trace entries, tids seen) for one process lane — the shared
    conversion: ``span.close`` → complete ("X") slices placed at their
    start time, everything else → instant ("i") marks, correlation
    fields in ``args``."""
    out: List[dict] = []
    tids: dict = {}
    for e in events:
        tid = e.get("tid", 0)
        tids.setdefault(tid, None)
        args = {k: v for k, v in e.items() if k not in _META_KEYS}
        ts_us = float(e.get("ts", 0.0)) * 1e6
        if e.get("type") == "span.close" and "duration_s" in e:
            dur_us = max(0.0, float(e["duration_s"]) * 1e6)
            name = e.get("span", "span")
            if e.get("phase"):
                name = f"{name}/{e['phase']}"
            out.append({"name": name, "cat": "span", "ph": "X",
                        "ts": ts_us - dur_us, "dur": dur_us,
                        "pid": pid, "tid": tid, "args": args})
        else:
            out.append({"name": e.get("type", "event"),
                        "cat": str(e.get("type", "event")).split(".")[0],
                        "ph": "i", "s": "t", "ts": ts_us,
                        "pid": pid, "tid": tid, "args": args})
    return out, tids


def chrome_trace(events: Optional[List[dict]] = None) -> dict:
    """Render journal events as a Chrome trace-event JSON object
    (https://ui.perfetto.dev loads it directly; ``chrome://tracing``
    too).  ``span.close`` events become complete ("X") slices placed at
    their start time with their measured duration; every other event is
    an instant ("i") mark.  Correlation fields (request_id, session_id,
    tenant, ...) ride in ``args`` so a slice can be found by searching
    for its request ID."""
    if events is None:
        events = get_journal().tail()
    pid = os.getpid()
    out, tids = _chrome_entries(events, pid)
    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": "deeplearning4j_tpu_torch"}}]
    for tid in tids:
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": f"thread-{tid}"}})
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


def _match_request_id(e: dict, request_id: str) -> bool:
    return (e.get("request_id") == request_id
            or request_id in (e.get("request_ids") or ()))


def chrome_trace_fleet(events_by_process: Dict[str, List[dict]],
                       request_id: Optional[str] = None) -> dict:
    """ONE Perfetto-loadable Chrome trace over several processes'
    journal events — the fleet-trace assembly (docs/OBSERVABILITY.md
    "Fleet federation & SLOs").  Each source (the router, each replica)
    becomes its own process lane (``pid`` 1..N, named by its key), so a
    migrated decode stream reads as one timeline: its `decode.step`
    events appear in the source replica's lane, the `fleet.migrated`
    hop in the router's, and the continuation in the target's — all
    correlated by the session/request IDs in ``args``.  Wall-clock
    timestamps are emitted as-is; replicas on one host share a clock,
    cross-host skew shows as lane offset (documented caveat)."""
    meta: List[dict] = []
    out: List[dict] = []
    for pid, pname in enumerate(sorted(events_by_process), 1):
        evts = events_by_process[pname]
        if request_id is not None:
            evts = [e for e in evts if _match_request_id(e, request_id)]
        entries, tids = _chrome_entries(evts, pid)
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": pname}})
        for tid in tids:
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": f"thread-{tid}"}})
        out.extend(entries)
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}
