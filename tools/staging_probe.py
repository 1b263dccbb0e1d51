#!/usr/bin/env python3
"""Time how a training batch reaches the card, on one GPU.

    python3 tools/staging_probe.py [--reps 10]
    python3 tools/staging_probe.py --fit [--turns 4] [--epochs 4]

By default, for batches of 64 KB to 28 MB — among them LeNet's 64 MNIST
images (0.2 MB) and the attention model's 4 x 8,192 one-hot characters
(features and labels, 28 MB) — it prints the median milliseconds of two
ways to stage a batch, and of ``datasets/iterators.stage_batch``, which
picks one by ``PINNED_STAGING_BYTES``:

* ``pageable``: each array copied with ``non_blocking`` from pageable
  memory on the current stream;
* ``pinned``: each array copied into pinned memory and from there on the
  side stream, the current stream waiting on an event (``stage_batch``
  with ``PINNED_STAGING_BYTES`` set to 0).

Each is timed twice: ``idle_ms``, the call and a synchronize on an idle
card (the whole copy); ``busy_host_ms``, the host time of the call alone
while the current stream still has ~5 ms of work queued (what a training
loop that runs ahead of the card pays).

With ``--fit``, instead: LeNet + Adam ``fit`` over 50 batches of 64,
host-bound on the card, in samples/s, in turns (each variant ``--turns``
times, ``--epochs`` fit calls a turn): ``sync`` (``pipeline_workers`` 0),
``pipeline`` (the default), ``pipeline_pinned`` (the same with every batch
staged through pinned memory), ``stage_in_worker`` (pinned staging run on
the pipeline's thread instead, as JAX's workers ``device_put``) and
``host_pipeline`` (the pipeline without staging; the step copies).

With ``--host-loop``, on the CPU and with no card: the pipeline's thread
cost alone, as batches/s of a loop whose step is 200 tiny torch calls
(each releases the interpreter lock, as a host-bound training step's
launches do), fed by the plain iterator (``sync``) or through an
``AsyncDataSetIterator`` with one worker (the feeder runs the ETL) or
two (feeder, task queue, workers), in ``--turns`` turns of ``--epochs``
passes over 50 batches.

Ends with the card's name and power limit (not with ``--host-loop``).
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def _all_pinned(iterators):
    """``stage_batch`` takes the pinned route for every batch inside."""
    saved = iterators.PINNED_STAGING_BYTES
    iterators.PINNED_STAGING_BYTES = 0
    try:
        yield
    finally:
        iterators.PINNED_STAGING_BYTES = saved


def fit_turns(torch, args) -> None:
    """LeNet + Adam fit samples/s per pipeline variant, in turns."""
    from deeplearning4j_tpu_torch.datasets import (
        AsyncDataSetIterator, DataSet, ListDataSetIterator, iterators)
    from deeplearning4j_tpu_torch.models import lenet
    rng = np.random.default_rng(3)
    batches = [DataSet(rng.random((64, 1, 28, 28), np.float32),
                       np.eye(10, dtype=np.float32)[rng.integers(0, 10, 64)])
               for _ in range(50)]
    net = lenet(device="cuda").init(
        generator=torch.Generator().manual_seed(1))
    net.fit(batches[0])
    torch.cuda.synchronize()

    def run(variant):
        g = net.conf.global_conf
        g.pipeline_workers = 0 if variant == "sync" else 1
        pinned = variant in ("pipeline_pinned", "stage_in_worker")
        t0 = time.perf_counter()
        with _all_pinned(iterators) if pinned else contextlib.nullcontext():
            for _ in range(args.epochs):
                data = ListDataSetIterator(batches)
                if variant == "host_pipeline":
                    data = AsyncDataSetIterator(
                        data, queue_size=g.pipeline_prefetch)
                elif variant == "stage_in_worker":
                    data = AsyncDataSetIterator(
                        data, queue_size=g.pipeline_prefetch,
                        transform=lambda d: iterators.stage_batch(
                            d, net.device))
                net.fit(data)
            float(net.score())
        return args.epochs * 50 * 64 / (time.perf_counter() - t0)
    variants = ["sync", "pipeline", "pipeline_pinned", "stage_in_worker",
                "host_pipeline"]
    out = {v: [] for v in variants}
    for turn in range(args.turns):
        for v in (variants if turn % 2 == 0 else variants[::-1]):
            out[v].append(run(v))
    print(json.dumps({"fit_samples_per_s": out}), flush=True)


def host_loop_turns(torch, args) -> None:
    """Batches/s of a host-bound CPU loop per pipeline variant, in turns."""
    from deeplearning4j_tpu_torch.datasets import (
        AsyncDataSetIterator, DataSet, ListDataSetIterator)
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    batches = [DataSet(rng.random((64, 784), np.float32),
                       rng.random((64, 10), np.float32)) for _ in range(50)]
    acc = torch.zeros(16)

    def run(workers):
        t0 = time.perf_counter()
        for _ in range(args.epochs):
            it = ListDataSetIterator(batches)
            if workers:
                it = AsyncDataSetIterator(it, workers=workers)
            while it.has_next():
                it.next()
                for _ in range(200):
                    acc.add_(1.0)
            if workers:
                it.close()
        return args.epochs * 50 / (time.perf_counter() - t0)
    variants = {"sync": 0, "workers_1": 1, "workers_2": 2}
    out = {v: [] for v in variants}
    for turn in range(args.turns):
        for v in (list(variants) if turn % 2 == 0 else list(variants)[::-1]):
            out[v].append(run(variants[v]))
    print(json.dumps({"host_loop_batches_per_s": out,
                      "median": {v: float(np.median(r))
                                 for v, r in out.items()}}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--fit", action="store_true")
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--host-loop", action="store_true")
    args = ap.parse_args()
    import torch
    if args.host_loop:
        host_loop_turns(torch, args)
        return 0
    if not torch.cuda.is_available():
        print("staging_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    if args.fit:
        fit_turns(torch, args)
        print(cs.nvidia_smi())
        return 0
    from deeplearning4j_tpu_torch.datasets import DataSet, iterators
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    eye = np.eye(107, dtype=np.float32)
    batches = {f"{kb}KB": DataSet(rng.random(kb * 256, np.float32),
                                  np.zeros(1, np.float32))
               for kb in (64, 256, 1024, 4096, 16384)}
    batches["lenet_64x1x28x28"] = DataSet(
        rng.random((64, 1, 28, 28), np.float32),
        np.eye(10, dtype=np.float32)[rng.integers(0, 10, 64)])
    batches["attention_4x8192x107"] = DataSet(
        eye[rng.integers(0, 107, (4, 8192))],
        eye[rng.integers(0, 107, (4, 8192))])

    def pageable(ds):
        return [torch.from_numpy(a).to(dev, non_blocking=True)
                for a in (ds.features, ds.labels)]

    def pinned(ds):
        with _all_pinned(iterators):
            return iterators.stage_batch(ds, dev)

    def timed(fn, busy: bool) -> float:
        times = []
        for _ in range(args.reps + 1):
            torch.cuda.synchronize()
            if busy:
                torch.cuda._sleep(10_000_000)       # ~5 ms of the stream
            t0 = time.perf_counter()
            fn()
            if not busy:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return float(np.median(times[1:]))

    for name, ds in batches.items():
        rec = {"batch": name,
               "bytes": int(ds.features.nbytes + ds.labels.nbytes),
               "stage_batch_route": (
                   "pinned" if ds.features.nbytes + ds.labels.nbytes
                   >= iterators.PINNED_STAGING_BYTES else "pageable")}
        for label, fn in (("pageable", pageable), ("pinned", pinned),
                          ("stage_batch",
                           lambda d: iterators.stage_batch(d, dev))):
            rec[label] = {"idle_ms": timed(lambda: fn(ds), False),
                          "busy_host_ms": timed(lambda: fn(ds), True)}
        print(json.dumps(rec), flush=True)
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
