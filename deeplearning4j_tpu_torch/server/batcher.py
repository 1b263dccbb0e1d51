"""Dynamic micro-batching for the serving path — the port of
``deeplearning4j_tpu/server/batcher.py``.

Concurrent ``predict`` requests arrive a few rows at a time; one forward
costs nearly the same for 1 row as for 32, so answering them one at a
time leaves the card idle.  The :class:`MicroBatcher` coalesces:
requests enqueue rows with a future, a batcher thread gathers up to
``max_batch`` rows, pads the batch up to the bucket ladder
(``ops/bucketing.py``), runs ONE inference call, copies the result to the
host once (``.cpu().numpy()``) and scatters per-request slices back.

Rows are independent at inference, so zero-row padding and slicing back
is exact.  Requests whose row shape or dtype differs from their
batch-mates run as their own group.  A request whose ``timeout_ms``
expires while queued is shed before compute with
:class:`DeadlineExceededError`.

Each request carries the trace context it was submitted under, and the
batch it rides journals ``batch.dispatch`` with every joined request id
(``monitor/events.py``).  The fault site ``batcher.compute`` sits before
the batched call; a batcher thread killed there (or by anything else)
fails its in-flight and queued requests, journals ``batcher.died``, writes
a flight-recorder dump, and the next :meth:`MicroBatcher.submit` restarts
it.  The trace spans of the JAX package's batcher are not ported yet.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.monitor import events, flight
from deeplearning4j_tpu_torch.ops import bucketing
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.resilience.errors import DeadlineExceededError

log = logging.getLogger(__name__)


class _Pending:
    __slots__ = ("x", "future", "t_enqueue", "deadline", "tenant", "ctx")

    def __init__(self, x, future, t_enqueue, deadline=None, tenant=None,
                 ctx=None):
        self.x = x
        self.future = future
        self.t_enqueue = t_enqueue
        self.deadline = deadline  # absolute time.monotonic(), or None
        self.tenant = tenant
        # the submitter's trace context (request id, tenant): the batcher
        # thread journals on the request's behalf under it
        self.ctx = ctx or {}

    @property
    def request_id(self):
        return self.ctx.get("request_id")


class ServingMetrics:
    """Per-batcher serving telemetry: queue (enqueue → dispatch), compute
    (the batched call, host copy included) and total (enqueue → result)
    latency as registry histograms
    (``dl4j_serving_{queue,compute,total}_seconds{model=...}``), plus the
    batch-size histogram."""

    def __init__(self, name: str = ""):
        reg = monitor.get_registry()
        self._lock = threading.Lock()
        lbl = {"model": name or "default"}
        self.queue = reg.histogram(
            "dl4j_serving_queue_seconds",
            "request enqueue → batch dispatch", ("model",)).labels(**lbl)
        self.compute = reg.histogram(
            "dl4j_serving_compute_seconds",
            "batched inference call", ("model",)).labels(**lbl)
        self.total = reg.histogram(
            "dl4j_serving_total_seconds",
            "request enqueue → result", ("model",)).labels(**lbl)
        self._c_rows = reg.counter(
            "dl4j_serving_rows_total", "rows served", ("model",)).labels(**lbl)
        self._c_batches = reg.counter(
            "dl4j_serving_batches_total", "coalesced batches dispatched",
            ("model",)).labels(**lbl)
        self.requests = 0
        self.rows = 0
        self.batches = 0
        self.shed = {}
        self.batch_size_hist = {}

    def record_shed(self, reason: str) -> None:
        with self._lock:
            self.shed[reason] = self.shed.get(reason, 0) + 1

    def record_batch(self, n_requests: int, n_rows: int) -> None:
        with self._lock:
            self.requests += n_requests
            self.rows += n_rows
            self.batches += 1
            self.batch_size_hist[n_rows] = \
                self.batch_size_hist.get(n_rows, 0) + 1
        self._c_rows.inc(n_rows)
        self._c_batches.inc()

    def snapshot(self) -> dict:
        with self._lock:
            requests, rows, batches = self.requests, self.rows, self.batches
            hist = {str(k): v for k, v in
                    sorted(self.batch_size_hist.items())}
            shed = dict(self.shed)
        return {
            "requests": requests,
            "rows": rows,
            "batches": batches,
            "shed": shed,
            "rows_per_batch_mean": round(rows / batches, 2) if batches else 0.0,
            "requests_per_batch_mean":
                round(requests / batches, 2) if batches else 0.0,
            "batch_size_hist": hist,
            "queue_ms": self.queue.latency_snapshot(),
            "compute_ms": self.compute.latency_snapshot(),
            "total_ms": self.total.latency_snapshot(),
        }


class MicroBatcher:
    """Coalesce concurrent few-row ``predict`` calls into one inference
    call.

    ``infer_fn(x: np.ndarray[B, ...])`` returns a row-aligned
    ``[B, ...]`` tensor (or array).  ``max_batch`` bounds gathered rows
    per dispatch (a single oversized request still runs, alone).
    Dispatch is backpressure-driven: the batcher takes everything queued
    and runs it at once, and requests that arrive meanwhile form the next
    batch (the JAX package's ``min_batch`` / ``max_wait_ms`` coalescing
    window is not ported: no caller sets it).  The gathered batch is
    zero-padded up to the ``bucket_sizes`` ladder (powers of two when
    None)."""

    def __init__(self, infer_fn: Callable[[np.ndarray], object],
                 max_batch: int = 32,
                 bucket_sizes: Optional[Sequence[int]] = None,
                 name: str = ""):
        self._infer_fn = infer_fn
        self.max_batch = max(1, int(max_batch))
        self._bucket_sizes = list(bucket_sizes) if bucket_sizes else None
        self.metrics = ServingMetrics(name)
        self._queue: List[_Pending] = []
        self._inflight: List[_Pending] = []
        self._cond = threading.Condition()
        self._running = True
        self._name = name
        # set by the crash handler before the dying thread's is_alive()
        # goes False: submit() restarts off either
        self._dead = False
        self.deaths = 0
        self.restarts = 0
        reg = monitor.get_registry()
        self._c_shed = reg.counter(
            "dl4j_resilience_shed_total",
            "requests shed instead of served", labels=("reason",))
        self._c_deaths = reg.counter(
            "dl4j_resilience_batcher_deaths_total",
            "micro-batcher threads that died unexpectedly")
        self._c_restarts = reg.counter(
            "dl4j_resilience_batcher_restarts_total",
            "micro-batcher threads restarted after a death")
        self._thread = self._spawn_thread()

    def _spawn_thread(self) -> threading.Thread:
        t = threading.Thread(
            target=self._loop_guarded, daemon=True,
            name=f"micro-batcher:{self._name or hex(id(self))}")
        t.start()
        return t

    # ---- client side ----
    def submit(self, features, timeout_ms: Optional[float] = None,
               tenant: Optional[str] = None) -> Future:
        """Enqueue a ``[k, ...]`` row batch; the future resolves to the
        ``[k, ...]`` numpy output slice for exactly those rows.
        ``timeout_ms`` is the request's deadline budget: past it, a
        still-queued request is shed before compute.  A dead batcher
        thread is restarted here."""
        x = np.asarray(features)
        if x.ndim < 1 or x.shape[0] == 0:
            raise ValueError("submit() needs a non-empty [k, ...] row batch")
        deadline = (None if timeout_ms is None
                    else time.monotonic() + float(timeout_ms) / 1e3)
        ctx = events.current_context()
        restarted = False
        with self._cond:
            if not self._running:
                raise RuntimeError("MicroBatcher is stopped")
            if self._dead or not self._thread.is_alive():
                self._dead = False
                self.restarts += 1
                self._c_restarts.inc()
                self._thread = self._spawn_thread()
                restarted = True
            fut = Future()
            self._queue.append(_Pending(x, fut, time.perf_counter(),
                                        deadline, tenant, ctx=ctx))
            self._cond.notify_all()
        if restarted:
            events.emit("batcher.restarted", model=self._name)
        return fut

    def predict(self, features, timeout: Optional[float] = None,
                timeout_ms: Optional[float] = None,
                tenant: Optional[str] = None):
        """Blocking :meth:`submit`.  ``timeout`` (seconds) bounds the
        client-side wait; ``timeout_ms`` is the server-side deadline."""
        return self.submit(features, timeout_ms=timeout_ms,
                           tenant=tenant).result(timeout)

    def queue_rows(self) -> int:
        """Rows waiting for dispatch — the gateway's admission signal."""
        with self._cond:
            return sum(len(p.x) for p in self._queue)

    def queue_rows_by_tenant(self) -> dict:
        with self._cond:
            out: dict = {}
            for p in self._queue:
                t = p.tenant or "-"
                out[t] = out.get(t, 0) + len(p.x)
            return out

    @property
    def thread_alive(self) -> bool:
        return self._thread.is_alive()

    def stop(self, timeout: float = 5.0) -> None:
        """Drain in-flight work, stop the batcher thread, and fail any
        requests that could not be drained."""
        with self._cond:
            self._running = False
            self._cond.notify_all()
        self._thread.join(timeout)
        with self._cond:
            leftovers, self._queue = self._queue, []
        for p in leftovers:
            if not p.future.done():
                p.future.set_exception(RuntimeError("MicroBatcher stopped"))

    # ---- batcher thread ----
    def _take_batch(self) -> List[_Pending]:
        """Block until work exists, then drain the queue up to
        ``max_batch`` rows (a request that would overflow waits for the
        next batch unless it would be alone anyway)."""
        with self._cond:
            while self._running and not self._queue:
                self._cond.wait(0.1)
            taken: List[_Pending] = []
            rows = 0
            while self._queue:
                nxt = len(self._queue[0].x)
                if taken and rows + nxt > self.max_batch:
                    break
                taken.append(self._queue.pop(0))
                rows += nxt
            # in flight from the moment it leaves the queue: a thread that
            # dies on any group of the take fails every group's futures
            self._inflight = list(taken)
            return taken

    def _shed_expired(self, taken: List[_Pending]) -> List[_Pending]:
        now = time.monotonic()
        keep: List[_Pending] = []
        for p in taken:
            if p.deadline is not None and now >= p.deadline:
                self.metrics.record_shed("deadline")
                self._c_shed.labels(reason="deadline").inc()
                events.emit("request.shed", severity="warn",
                            reason="deadline", model=self._name,
                            request_id=p.request_id, tenant=p.tenant)
                p.future.set_exception(DeadlineExceededError(
                    "request deadline expired while queued "
                    f"({(now - p.deadline) * 1e3:.1f} ms past budget)"))
            else:
                keep.append(p)
        return keep

    def _run_group(self, group: List[_Pending]) -> None:
        t_dispatch = time.perf_counter()
        # the batch's events carry every joined request id
        rids = [p.request_id for p in group if p.request_id]
        try:
            with events.scope(model=self._name or None,
                              request_ids=rids or None):
                faults.check("batcher.compute")
                xs = [p.x for p in group]
                x = np.concatenate(xs) if len(xs) > 1 else xs[0]
                n = len(x)
                nb = bucketing.bucket_size(n, self._bucket_sizes)
                if nb != n:
                    x = np.concatenate(
                        [x, np.zeros((nb - n,) + x.shape[1:], x.dtype)])
                events.emit("batch.dispatch", requests=len(group), rows=n)
                t0 = time.perf_counter()
                out = self._infer_fn(x)
                # the one explicit device → host copy of the bucket result
                if isinstance(out, torch.Tensor):
                    out = out.cpu().numpy()
                out = np.asarray(out)[:n]
                t1 = time.perf_counter()
            # metrics before results: a client that has its answer sees
            # its batch in ``stats``
            for p in group:
                self.metrics.queue.record(t_dispatch - p.t_enqueue)
                self.metrics.compute.record(t1 - t0)
                self.metrics.total.record(t1 - p.t_enqueue)
            self.metrics.record_batch(len(group), n)
            i = 0
            for p in group:
                k = len(p.x)
                p.future.set_result(out[i:i + k])
                i += k
        except Exception as e:  # the batch fails, the batcher keeps serving
            for p in group:
                if not p.future.done():
                    p.future.set_exception(e)

    def _loop_guarded(self) -> None:
        """The batcher thread's body and crash handler: a
        ``BaseException`` escaping the loop (a ``kill`` fault) fails the
        in-flight and queued requests, journals ``batcher.died`` with
        their request ids and writes a flight-recorder dump; the next
        :meth:`submit` restarts the thread."""
        death_err = None
        try:
            self._loop()
        except BaseException as e:
            death_err = e
            log.error("micro-batcher %r thread died: %s: %s",
                      self._name, type(e).__name__, e)
        finally:
            with self._cond:
                died = self._running   # a stop() is not a death
                stranded = self._inflight + self._queue
                self._inflight = []
                if died:
                    self._queue = []
                    self.deaths += 1
                    self._dead = True
            if died:
                self._c_deaths.inc()
                for p in stranded:
                    if not p.future.done():
                        p.future.set_exception(RuntimeError(
                            "MicroBatcher thread died; request failed "
                            "(the batcher restarts on the next submit)"))
                rids = [p.request_id for p in stranded if p.request_id]
                events.emit(
                    "batcher.died", severity="error", model=self._name,
                    error=(f"{type(death_err).__name__}: {death_err}"
                           if death_err is not None else "unknown"),
                    stranded=len(stranded), request_ids=rids or None)
                flight.dump("batcher_died", extra={
                    "batcher": self._name, "stranded_request_ids": rids,
                    "error": repr(death_err)})

    def _loop(self) -> None:
        while True:
            taken = self._take_batch()
            if not taken:
                if not self._running:
                    return
                continue
            taken = self._shed_expired(taken)
            # one dispatch per (row shape, dtype) group: a client sending
            # mismatched rows must not fail its batch-mates
            groups: dict = {}
            for p in taken:
                groups.setdefault((p.x.shape[1:], str(p.x.dtype)),
                                  []).append(p)
            for group in groups.values():
                self._run_group(group)
                done = {id(p) for p in group}
                with self._cond:
                    self._inflight = [p for p in self._inflight
                                      if id(p) not in done]
            with self._cond:
                self._inflight = []     # the shed ones are answered
