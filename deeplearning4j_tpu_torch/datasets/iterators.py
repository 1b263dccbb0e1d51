"""DataSet iterators and the asynchronous input pipeline — the port of
``deeplearning4j_tpu/datasets/iterators.py``.

The reference wraps every training iterator in an
``AsyncDataSetIterator`` (ref: AsyncDataSetIterator.java:39-127); here,
as in the JAX package, that is a multi-worker pipeline:

    feeder ──▶ task queue ──▶ N workers ──▶ reorder buffer ──▶ consumer
    (serial raw pull,          (collate → normalize →          (ordered,
     order = sync iterator)     transform)                      bounded,
                                                                staged)

The feeder pulls raw batches serially, so batch order is the sync
iterator's; workers run the ETL chain in parallel and hand finished
batches to a reorder buffer that holds at most ``staging_depth`` of them,
on the host, ahead of the consumer.  With one worker (``fit``'s
default) the feeder runs the ETL itself, which spares a host-bound loop
a hand-off between threads per batch (``tools/staging_probe.py
--host-loop``).  A feeder or worker exception surfaces on the consumer at
its batch's position.

Staging onto a CUDA device (JAX's ``_device_put_batch``) happens in the
consumer's thread, when :meth:`AsyncDataSetIterator.next` hands a batch
over.  A batch of a megabyte or more is copied into pinned host memory
and from there to the device with a ``non_blocking`` copy on one side
stream per device; the consumer's stream waits on an event recorded
after the copies, so the copy overlaps the work already queued on the
card and the step never reads a half-copied batch.  A smaller batch is
copied from pageable memory on the consumer's stream, which costs less
than pinning it (``tools/staging_probe.py``).  Unlike JAX's workers, the
workers do not stage: on an H100 host, LeNet + Adam training read about
the same with staging on the worker as with staging at ``next()`` in one
of three measurements and 8-12 % lower in the other two
(``tools/staging_probe.py --fit``); a worker's staging competes for the
interpreter lock with a host-bound loop.  A batch that cannot be staged
raises at its position: there is no fallback to host arrays.

The ``MultiDataSet`` iterators (``ListMultiDataSetIterator``,
``AsyncMultiDataSetIterator``) feed the ComputationGraph through the same
pipeline; staging moves every array of the features and labels lists.
Not ported yet: ``reader_retry_from_conf`` and the ``reader.next_raw``
fault site (the port's ``resilience`` has no retry policy or fault
injection).  Everything meters into the ``dl4j_pipeline_*`` families of
the port's metrics registry.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
import weakref
from typing import Iterator, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet

log = logging.getLogger(__name__)


class DataSetIterator:
    """Iterator contract (ref: nd4j DataSetIterator)."""

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        return self.next()

    def next(self) -> DataSet:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def batch_size(self) -> int:
        raise NotImplementedError

    def async_supported(self) -> bool:
        return True


class ListDataSetIterator(DataSetIterator):
    """Iterate a list of pre-built minibatches (ref: ListDataSetIterator)."""

    def __init__(self, data, batch: Optional[int] = None):
        if isinstance(data, DataSet):
            data = data.batch_by(batch) if batch else [data]
        self._data: List[DataSet] = list(data)
        self._i = 0

    def next(self):
        d = self._data[self._i]
        self._i += 1
        return d

    def has_next(self):
        return self._i < len(self._data)

    def reset(self):
        self._i = 0

    def batch_size(self):
        return self._data[0].num_examples() if self._data else 0


class ExistingDataSetIterator(DataSetIterator):
    """Wrap any python iterable of DataSets (ref: ExistingDataSetIterator)."""

    def __init__(self, iterable_factory):
        self._factory = iterable_factory
        self._it = iter(iterable_factory())
        self._peek = None
        self._advance()

    def _advance(self):
        try:
            self._peek = next(self._it)
        except StopIteration:
            self._peek = None

    def next(self):
        d = self._peek
        self._advance()
        return d

    def has_next(self):
        return self._peek is not None

    def reset(self):
        self._it = iter(self._factory())
        self._advance()

    def batch_size(self):
        return self._peek.num_examples() if self._peek else 0


class MultipleEpochsIterator(DataSetIterator):
    """Repeat an underlying iterator N epochs (ref: MultipleEpochsIterator)."""

    def __init__(self, epochs: int, underlying: DataSetIterator):
        self.epochs = epochs
        self.underlying = underlying
        self._epoch = 0

    def next(self):
        if not self.underlying.has_next():
            self.underlying.reset()
            self._epoch += 1
        return self.underlying.next()

    def has_next(self):
        return self.underlying.has_next() or self._epoch < self.epochs - 1

    def reset(self):
        self.underlying.reset()
        self._epoch = 0

    def batch_size(self):
        return self.underlying.batch_size()


class SamplingDataSetIterator(DataSetIterator):
    """Sample minibatches with replacement from one DataSet
    (ref: SamplingDataSetIterator)."""

    def __init__(self, dataset: DataSet, batch: int, total_batches: int,
                 seed: int = 0):
        self.dataset = dataset
        self.batch = batch
        self.total = total_batches
        self._rng = np.random.default_rng(seed)
        self._count = 0

    def next(self):
        idx = self._rng.integers(0, self.dataset.num_examples(), self.batch)
        self._count += 1
        d = self.dataset
        return DataSet(d.features[idx], d.labels[idx],
                       None if d.features_mask is None
                       else d.features_mask[idx],
                       None if d.labels_mask is None else d.labels_mask[idx])

    def has_next(self):
        return self._count < self.total

    def reset(self):
        self._count = 0

    def batch_size(self):
        return self.batch


def _pipeline_metrics() -> dict:
    """The dl4j_pipeline_* instruments of the port's registry."""
    reg = monitor.get_registry()
    return {
        "batches": reg.counter(
            "dl4j_pipeline_batches_total",
            "input-pipeline batches by stage "
            "(produced=raw pull, transformed=ETL done, consumed=handed"
            " to the training loop)", labels=("stage",)),
        "queue_depth": reg.gauge(
            "dl4j_pipeline_queue_depth",
            "current depth of the pipeline queues "
            "(task=raw batches awaiting ETL, ready=transformed host "
            "batches awaiting the consumer)", labels=("queue",)),
        "busy": reg.counter(
            "dl4j_pipeline_worker_busy_seconds_total",
            "cumulative wall time ETL workers spent transforming"),
        "staged_bytes": reg.counter(
            "dl4j_pipeline_staged_bytes_total",
            "bytes of batches passed through the reorder buffer"),
        "workers": reg.gauge(
            "dl4j_pipeline_workers",
            "worker threads of the most recently started pipeline"),
    }


_ARRAYS = ("features", "labels", "features_mask", "labels_mask")


def _arrays(d) -> list:
    """The arrays of a DataSet (features, labels, masks) or of a
    MultiDataSet (every features, labels and mask entry), in a fixed
    order that :func:`_rebuild` reads back."""
    if isinstance(d, MultiDataSet):
        return [a for arrs in (d.features, d.labels, d.features_masks,
                               d.labels_masks) for a in (arrs or [])]
    return [getattr(d, k) for k in _ARRAYS]


def _rebuild(d, arrays: list):
    """``d`` with its arrays replaced, in :func:`_arrays` order."""
    if not isinstance(d, MultiDataSet):
        return DataSet(*arrays)
    it = iter(arrays)
    return MultiDataSet(*([next(it) for _ in arrs] if arrs is not None
                          else None
                          for arrs in (d.features, d.labels,
                                       d.features_masks, d.labels_masks)))


def _batch_nbytes(d) -> int:
    arrs = _arrays(d) if isinstance(d, (DataSet, MultiDataSet)) else [d]
    return sum(int(getattr(a, "nbytes", 0) or 0) for a in arrs
               if a is not None)


def _host_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


# A batch of fewer bytes is copied from pageable memory on the consumer's
# stream (non_blocking: CUDA copies the bytes into its own staging
# buffer before the call returns); a larger one goes through pinned
# memory and the side stream.  Pinning costs a host copy and ~0.1 ms of
# calls, more than a small batch's whole pageable copy, while a large
# pageable copy holds the host until the consumer's stream reaches it
# (tools/staging_probe.py measures both sides).
PINNED_STAGING_BYTES = 1 << 20

_staging_streams: dict = {}


def staging_stream(device: torch.device):
    """The side stream pinned batches are copied to ``device`` on: one
    per device for the process, because the caching allocator keeps freed
    blocks per stream, and a stream per iterator would allocate every
    staged batch anew."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    stream = _staging_streams.get(index)
    if stream is None:
        stream = _staging_streams.setdefault(
            index, torch.cuda.Stream(device=index))
    return stream


def stage_batch(d, device: torch.device):
    """A DataSet's (or MultiDataSet's) arrays on ``device``, for the
    caller's current stream.
    On the CPU: torch copies of the arrays.  On a CUDA device, a batch of
    fewer than :data:`PINNED_STAGING_BYTES` host bytes is copied on the
    current stream without blocking; a larger one is copied into pinned
    host memory and from there, without blocking, on
    :func:`staging_stream`; the current stream then waits on an event
    recorded after the copies, and the caching allocator is told that
    stream uses the tensors.  Either way, host arrays in pageable memory
    (numpy's) may change once this returns.  Raises if a copy cannot be
    made."""
    device = torch.device(device)
    arrays = [None if a is None else _host_tensor(a) for a in _arrays(d)]
    if device.type != "cuda":
        return _rebuild(d, [None if t is None else t.to(device, copy=True)
                            for t in arrays])
    host_bytes = sum(t.nbytes for t in arrays
                     if t is not None and t.device.type == "cpu")
    if host_bytes < PINNED_STAGING_BYTES:
        return _rebuild(d, [None if t is None else
                            t.to(device, non_blocking=True) for t in arrays])
    stream = staging_stream(device)
    with torch.cuda.stream(stream):
        tensors = [None if t is None else
                   (t.pin_memory() if t.device.type == "cpu" else t)
                   .to(device, non_blocking=True) for t in arrays]
        event = torch.cuda.Event()
        event.record(stream)
    consumer = torch.cuda.current_stream(device)
    consumer.wait_event(event)
    for t in tensors:
        if t is not None:
            t.record_stream(consumer)
    return _rebuild(d, tensors)


def _make_etl(collate, normalizer, transform):
    """The worker-side ETL chain as a closure over plain values — it must
    NOT capture the iterator (running threads would pin it and the
    GC-finalizer shutdown path could never fire)."""
    def etl(raw):
        d = collate(raw) if collate is not None else raw
        if normalizer is not None:
            d = normalizer.transform(d)
        if transform is not None:
            d = transform(d)
        return d
    return etl


class _PipelineRun:
    """One started generation of the pipeline: feeder + worker threads,
    the bounded task queue and the order-preserving reorder buffer.  With
    one worker, the feeder runs the ETL itself and there is no task
    queue: a batch's hand-off between two threads costs a host-bound
    training loop more than the raw prefetch gains.

    Holds no reference to the owning iterator: thread targets are bound
    methods of THIS object, so when the iterator is dropped without
    close(), its ``weakref.finalize`` can still fire and ``request_stop``
    unwinds the threads (a producer blocked on a full queue checks the
    stop event instead of leaking)."""

    def __init__(self, underlying, etl, workers: int, queue_size: int,
                 staging_depth: int):
        self.underlying = underlying
        self.next_raw, _ = _etl_split(underlying)
        self.etl = etl
        self.workers = workers
        self.inline = workers == 1
        self.staging_depth = staging_depth
        m = _pipeline_metrics()
        self.metrics = m
        # the labelled instruments each batch touches, looked up once
        self.m_stage = {k: m["batches"].labels(stage=k)
                        for k in ("produced", "transformed", "consumed")}
        self.m_depth = {k: m["queue_depth"].labels(queue=k)
                        for k in ("task", "ready")}
        self.stop = threading.Event()
        self.task_q: queue.Queue = queue.Queue(maxsize=queue_size)
        self.cond = threading.Condition()
        self.ready: dict = {}
        self.ready_high_water = 0
        self.next_seq = 0
        self.total: Optional[int] = None
        self.errors: List[tuple] = []
        self.live_workers = 0 if self.inline else workers
        self.threads = [threading.Thread(target=self._feed, daemon=True,
                                         name="dl4j-pipe-feeder")]
        if not self.inline:
            self.threads += [
                threading.Thread(target=self._work, daemon=True,
                                 name=f"dl4j-pipe-worker-{i}")
                for i in range(workers)]

    def start(self):
        self.metrics["workers"].set(self.workers)
        for t in self.threads:
            t.start()

    # -- bounded-queue helpers that never block past a stop ------------
    def _q_put(self, item) -> bool:
        while not self.stop.is_set():
            try:
                self.task_q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _q_get(self):
        while not self.stop.is_set():
            try:
                return self.task_q.get(timeout=0.05)
            except queue.Empty:
                continue
        return None

    def _feed(self):
        seq = 0
        try:
            while not self.stop.is_set() and self.underlying.has_next():
                raw = self.next_raw()
                self.m_stage["produced"].inc()
                if self.inline:
                    if not self._transform_and_buffer(seq, raw):
                        return
                elif not self._q_put((seq, raw)):
                    return
                else:
                    self.m_depth["task"].set(self.task_q.qsize())
                seq += 1
        except BaseException as e:  # surfaced on the consumer thread at
            with self.cond:         # this batch position — a dead feeder
                self.errors.append((seq, e))  # must not look like EOF
                self.cond.notify_all()
        finally:
            with self.cond:
                self.total = seq
                self.cond.notify_all()
            if not self.inline:
                for _ in range(self.workers):
                    self._q_put(AsyncDataSetIterator._SENTINEL)

    def _work(self):
        try:
            while not self.stop.is_set():
                task = self._q_get()
                if task is None or task is AsyncDataSetIterator._SENTINEL:
                    return
                self.m_depth["task"].set(self.task_q.qsize())
                if not self._transform_and_buffer(*task):
                    return
        finally:
            with self.cond:
                self.live_workers -= 1
                self.cond.notify_all()

    def _transform_and_buffer(self, seq: int, raw) -> bool:
        """Run the ETL on batch ``seq`` and put it in the reorder buffer
        (an ETL exception is recorded at ``seq`` instead); False once the
        run is stopping."""
        t0 = time.perf_counter()
        try:
            item = self.etl(raw)
        except BaseException as e:
            with self.cond:
                self.errors.append((seq, e))
                self.cond.notify_all()
            return True
        self.metrics["busy"].inc(time.perf_counter() - t0)
        self.m_stage["transformed"].inc()
        self.metrics["staged_bytes"].inc(_batch_nbytes(item))
        with self.cond:
            # staging bound: at most staging_depth finished batches
            # resident ahead of the consumer
            while (not self.stop.is_set()
                   and seq >= self.next_seq + self.staging_depth):
                self.cond.wait(0.05)
            if self.stop.is_set():
                return False
            self.ready[seq] = item
            self.ready_high_water = max(self.ready_high_water,
                                        len(self.ready))
            self.m_depth["ready"].set(len(self.ready))
            self.cond.notify_all()
        return True

    def get_next(self):
        """Block until the next in-order batch is staged.  Returns
        ``(item, True)`` or ``(None, False)`` at EOF; re-raises a
        feeder/worker exception at the failed batch's position."""
        with self.cond:
            while True:
                if self.next_seq in self.ready:
                    item = self.ready.pop(self.next_seq)
                    self.next_seq += 1
                    self.m_depth["ready"].set(len(self.ready))
                    self.m_stage["consumed"].inc()
                    self.cond.notify_all()
                    return item, True
                if self.errors:
                    err_seq = min(s for s, _ in self.errors)
                    if err_seq <= self.next_seq:
                        exc = next(e for s, e in self.errors
                                   if s == err_seq)
                        self.stop.set()
                        self.cond.notify_all()
                        raise exc
                if (self.total is not None
                        and self.next_seq >= self.total
                        and self.live_workers == 0):
                    return None, False
                if self.stop.is_set():  # close() raced us
                    return None, False
                self.cond.wait(0.05)

    def request_stop(self):
        """Signal-only shutdown — safe from a GC finalizer."""
        self.stop.set()
        with self.cond:
            self.cond.notify_all()

    def shutdown(self):
        self.request_stop()
        for t in self.threads:
            t.join(timeout=5)
        # A thread still alive here is mid-flight in user ETL or
        # next_raw (every queue wait checks `stop`).  Block until it
        # drains: callers touch the shared stateful reader right after
        # shutdown(), and a feeder still inside next_raw would mutate
        # it concurrently.
        stuck = [t for t in self.threads if t.is_alive()]
        if stuck:
            log.warning(
                "pipeline shutdown: %d thread(s) still in ETL after 5s; "
                "waiting for in-flight work to finish", len(stuck))
            for t in stuck:
                t.join()
        self.threads = []


def _etl_split(underlying):
    """(next_raw, collate) when the underlying iterator supports the
    raw-pull/assembly split, else (next, None) — the two must pair: raw
    records without the matching collate are not a batch."""
    raw = getattr(underlying, "next_raw", None)
    collate = getattr(underlying, "collate", None)
    if raw is not None and collate is not None:
        return raw, collate
    return underlying.next, None


class AsyncDataSetIterator(DataSetIterator):
    """Multi-worker, order-preserving prefetch pipeline
    (ref: AsyncDataSetIterator.java:39-127 — generalized from one
    thread + BlockingQueue to a feeder + N ETL workers + a bounded
    reorder buffer).

    The feeder pulls raw batches from ``underlying`` serially — batch
    order out of this iterator is therefore deterministic and exactly
    matches the sync iterator.  Workers run collate → normalize →
    transform concurrently; finished batches wait on the host in a
    reorder buffer holding at most ``staging_depth`` batches ahead of the
    consumer, and ``next`` stages each onto ``device`` as it hands it
    over.  A worker exception surfaces on the consumer thread at the
    failed batch's position (batches before it are still delivered, in
    order)."""

    _SENTINEL = object()

    def __init__(self, underlying: DataSetIterator, queue_size: int = 4,
                 device=None, transform=None, workers: int = 1,
                 staging_depth: Optional[int] = None, normalizer=None):
        """``device``: stage every batch's arrays onto that device as it is
        handed over (torch tensors, :func:`stage_batch`); None hands the
        batches over as they come.
        ``transform`` runs on a worker thread.
        ``normalizer`` (datasets/normalizers) is applied before
        ``transform``.  ``staging_depth`` bounds how many transformed
        batches may wait on the host, in the reorder buffer, ahead of the
        consumer (in the JAX package they wait on the device); default =
        ``queue_size``."""
        self.underlying = underlying
        self.queue_size = max(1, int(queue_size))
        self.device = None if device is None else torch.device(device)
        self.transform_fn = transform
        self.normalizer = normalizer
        self.workers = max(1, int(workers))
        self.staging_depth = (self.queue_size if staging_depth is None
                              else max(1, int(staging_depth)))
        self._peek = None
        self._exhausted = False
        self._pending_exc: Optional[BaseException] = None
        self._run: Optional[_PipelineRun] = None
        self._finalizer = None
        self._last_high_water = 0
        self._started = False  # threads start lazily on first use, so a
        # reset() right after construction doesn't drain a prefetch pass

    # -- consumer side ---------------------------------------------------
    def _start(self):
        self._exhausted = False
        self._peek = None
        self._pending_exc = None
        self._started = True
        etl = _make_etl(_etl_split(self.underlying)[1], self.normalizer,
                        self.transform_fn)
        self._run = _PipelineRun(self.underlying, etl, self.workers,
                                 self.queue_size, self.staging_depth)
        # GC safety net: a dropped-without-close() iterator must not
        # leak its threads.  The run holds no reference back to self,
        # so collection of self is possible while threads still spin —
        # the finalizer stops them.
        self._finalizer = weakref.finalize(self, _PipelineRun.request_stop,
                                           self._run)
        self._run.start()
        self._advance()

    def _ensure_started(self):
        if not self._started:
            self._start()

    def _advance(self):
        if self._exhausted:
            self._peek = None
            return
        try:
            self._peek, ok = self._run.get_next()
        except BaseException as e:
            # deferred: every batch staged BEFORE the failure is still
            # delivered in order; the exception surfaces on the consumer
            # right after the last good batch
            self._exhausted = True
            self._peek = None
            self._pending_exc = e
            return
        if not ok:
            self._exhausted = True

    def _raise_pending(self):
        e = self._pending_exc
        if e is not None:
            self._pending_exc = None
            raise e

    def next(self):
        self._ensure_started()
        if self._peek is None:
            self._raise_pending()
        d = self._peek
        if d is not None and self.device is not None:
            # staged before the wait for the next batch, so the copy runs
            # meanwhile
            d = stage_batch(d, self.device)
        self._advance()
        return d

    def has_next(self):
        self._ensure_started()
        if self._peek is not None:
            return True
        self._raise_pending()
        return False

    @property
    def staging_high_water(self) -> int:
        """Max transformed batches ever waiting on the host in the
        reorder buffer (bounded by ``staging_depth``; none of them is on
        the device yet); survives close()."""
        if self._run is not None:
            return self._run.ready_high_water
        return self._last_high_water

    def close(self):
        """Stop feeder + workers and release the queues.  Idempotent;
        safe to call mid-stream (a producer blocked on a full queue sees
        the stop event instead of leaking).  The iterator restarts
        lazily on next use from wherever ``underlying`` stands."""
        if not self._started:
            return
        if self._finalizer is not None:
            self._finalizer.detach()
            self._finalizer = None
        if self._run is not None:
            self._last_high_water = self._run.ready_high_water
            self._run.shutdown()
            self._run = None
        self._started = False
        self._peek = None
        self._exhausted = False
        self._pending_exc = None

    def reset(self):
        # Rewind the underlying iterator even when the pipeline never
        # started: threads haven't spun up, but the caller may hand us a
        # partially-consumed iterator (e.g. one a Normalizer.fit just
        # drained) and expects reset() to mean "epoch starts from 0".
        if self._started:
            self.close()
        self.underlying.reset()

    def batch_size(self):
        return self.underlying.batch_size()


class MultiDataSetIterator:
    """Iterator contract for multi-input/output batches
    (ref: nd4j MultiDataSetIterator consumed by ComputationGraph.fit)."""

    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self):
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next()


class ListMultiDataSetIterator(MultiDataSetIterator):
    """Pre-built MultiDataSet minibatches."""

    def __init__(self, batches):
        self._data = list(batches)
        self._i = 0

    def has_next(self):
        return self._i < len(self._data)

    def next(self):
        d = self._data[self._i]
        self._i += 1
        return d

    def reset(self):
        self._i = 0


class AsyncMultiDataSetIterator(AsyncDataSetIterator):
    """The pipeline of :class:`AsyncDataSetIterator` for MultiDataSet
    iterators (ref: datasets/iterator/AsyncMultiDataSetIterator.java): the
    same feeder, workers and reorder buffer; staging moves every array of
    the features and labels lists, and None masks stay None."""

    def batch_size(self):  # MultiDataSet iterators need not expose this
        fn = getattr(self.underlying, "batch_size", None)
        return fn() if fn else 0
