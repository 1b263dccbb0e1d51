#!/usr/bin/env python3
"""Trace where ``fit``'s input pipeline takes host time, on one GPU.

    python3 tools/pipeline_trace.py [--turns 4] [--epochs 4] [--out FILE]

``train_lenet``'s loop (``chip_smoke.py``): LeNet + Adam ``fit`` over 50
random batches of 64 MNIST-shaped rows, host-bound on the card, with
``pipeline_workers`` 1 (the default: ``fit`` wraps the iterator in an
``AsyncDataSetIterator`` whose feeder thread pulls and transforms the
batches) and 0 (``fit`` pulls them itself), in turns (1 0 0 1 ...).  Per
variant and turn:

* ``samples_per_s`` and ``host_ms_per_step``: wall clock of ``--epochs``
  ``fit`` calls, ending in a host copy of the score;
* ``cpu_ms_per_step``: CPU time (user + system) of the main thread
  (``time.thread_time``) and of every other thread of the process
  together (``time.process_time`` less the main thread's; the pipeline's
  ``dl4j-pipe-*`` threads, which end with each ``fit``, and the CUDA
  runtime's), and ``main_wait_ms_per_step``, the main thread's wall time
  not spent on a CPU (the interpreter lock, a blocked queue or a
  synchronize);

then one traced epoch a variant under ``torch.profiler`` (CPU and CUDA
activities): per thread, the self CPU ms of the operators it ran and its
top operators (threads by profiler id; ``main_thread`` is the main
thread's native id); the card's busy ms (the self device time of every
kernel and copy) and its idle share of the epoch's wall time; then one
epoch that reads the CPU time of the pipeline's feeder thread (the
operators above do not show its Python), per batch.  The JSON
lines go to standard output and, with ``--out``, to that file; the last
line is the card's name and power limit.
"""

import argparse
import json
import subprocess
import sys
import threading
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _feeder_cpu(net, batches) -> dict:
    """One ``fit`` epoch with one pipeline worker: the feeder thread's CPU
    ms a batch (``time.thread_time`` inside its body,
    ``_PipelineRun._feed``)."""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.datasets import iterators
    feed, cpu = iterators._PipelineRun._feed, []

    def timed(run):
        t0 = time.thread_time()
        try:
            return feed(run)
        finally:
            cpu.append(time.thread_time() - t0)
    net.conf.global_conf.pipeline_workers = 1
    iterators._PipelineRun._feed = timed
    try:
        net.fit(ListDataSetIterator(batches))
        float(net.score())
    finally:
        iterators._PipelineRun._feed = feed
    return {"feeder_cpu_ms_per_batch": sum(cpu) / len(batches) * 1e3}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("pipeline_trace: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.models import lenet
    lines = []

    def emit(rec):
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)

    rng = np.random.default_rng(3)
    batches = [DataSet(rng.random((64, 1, 28, 28), np.float32),
                       np.eye(10, dtype=np.float32)[rng.integers(0, 10, 64)])
               for _ in range(50)]
    steps = len(batches) * args.epochs
    net = lenet(device="cuda").init(generator=torch.Generator().manual_seed(1))
    net.fit(batches[0])
    torch.cuda.synchronize()
    main_tid = threading.main_thread().native_id

    def run(workers: int) -> dict:
        net.conf.global_conf.pipeline_workers = workers
        cpu0, main0 = time.process_time(), time.thread_time()
        t0 = time.perf_counter()
        for _ in range(args.epochs):
            net.fit(ListDataSetIterator(batches))
        float(net.score())
        wall = time.perf_counter() - t0
        main_cpu = time.thread_time() - main0
        rest_cpu = time.process_time() - cpu0 - main_cpu
        return {"workers": workers, "samples_per_s": steps * 64 / wall,
                "host_ms_per_step": wall / steps * 1e3,
                "cpu_ms_per_step": {"main": main_cpu / steps * 1e3,
                                    "other_threads": rest_cpu / steps * 1e3},
                "main_wait_ms_per_step": (wall - main_cpu) / steps * 1e3}

    for turn in range(args.turns):
        for workers in ((1, 0) if turn % 2 == 0 else (0, 1)):
            emit({"turn": turn, **run(workers)})

    for workers in (1, 0):
        net.conf.global_conf.pipeline_workers = workers
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            net.fit(ListDataSetIterator(batches))
            float(net.score())
            wall = time.perf_counter() - t0
        by_thread = defaultdict(lambda: defaultdict(float))
        device_us = 0.0
        for ev in prof.events():
            dev = getattr(ev, "self_device_time_total", None)
            if dev is None:
                dev = getattr(ev, "self_cuda_time_total", 0.0)
            device_us += dev
            if ev.device_type.name == "CPU":
                by_thread[ev.thread][ev.name] += ev.self_cpu_time_total
        threads = {}
        for tid, ops in by_thread.items():
            total = sum(ops.values())
            top = sorted(ops.items(), key=lambda kv: -kv[1])[:8]
            threads[str(tid)] = {
                "self_cpu_ms_per_step": total / len(batches) / 1e3,
                "top_ops_ms": {k: v / 1e3 for k, v in top}}
        emit({"traced": True, "workers": workers, "main_thread": main_tid,
              "host_ms_per_step": wall / len(batches) * 1e3,
              "device_busy_ms_per_step": device_us / len(batches) / 1e3,
              "device_idle_share": 1 - device_us / 1e6 / wall,
              "threads": threads})
    emit({"feeder": True, **_feeder_cpu(net, batches)})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    lines.append(smi)
    print(smi)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
