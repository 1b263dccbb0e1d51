#!/usr/bin/env python3
"""Where the time of a ResNet-50 training step goes on one GPU.

    python3 tools/resnet_step_trace.py [--batch 128] [--out FILE]

Builds ResNet-50 at its published widths with ``chip_smoke.py``'s seeded
weights (``seeded_resnet50``; cuDNN's TF32 off, as ``train_resnet50``
runs), takes two warm-up ``fit`` steps at ``--batch`` on a seeded
synthetic 224x224 batch, times three more (host clock, each ending in a
synchronize), then traces one step under ``torch.profiler`` (CPU and CUDA
activities), and likewise one ``output()`` at batch 32.  For each traced
call it prints the wall time, the card's busy time (the union of every
kernel's and copy's interval) and idle share of the wall time, and the
device time summed by kernel group: the conv kernel
(``csrc/conv_bias_act.cu``: the wgmma conv and its weight split), the
xent kernel, cuDNN's convs (the conv backward, the strided convs),
other GEMMs (the dense layer), elementwise and reduction kernels (batch
norm, relu, the residual adds, the updater), copies, and the rest; with
the ten kernels that take the most device time.  The JSON lines go to
standard output and, with ``--out``, to that file; the last line is the
card's name and power limit.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
GROUPS = (("conv_kernel", ("conv_wgmma", "split_tf32")),
          ("xent_kernel", ("softmax_xent",)),
          ("cudnn_conv", ("cudnn", "xmma", "implicit", "dgrad", "wgrad",
                          "conv2d", "convolve", "winograd", "fft")),
          ("gemm", ("gemm", "cutlass", "sm90_")),
          ("elementwise_reduce", ("elementwise", "reduce", "vectorized",
                                  "batch_norm", "unrolled", "index",
                                  "copy_kernel", "fill", "pool", "max_",
                                  "avg")),
          ("memcpy", ("memcpy", "memset")))


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def _trace(torch, fn) -> dict:
    """One call of ``fn`` under the profiler: wall ms, busy ms (union of
    device intervals), idle share and device ms by group."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_group, by_kernel, spans = defaultdict(float), defaultdict(float), []
    for ev in prof.events():
        if ev.device_type.name != "CUDA":
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        by_group[_group(ev.name)] += us / 1e3
        by_kernel[ev.name] += us / 1e3
        spans.append((ev.time_range.start, ev.time_range.end))
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall * 1e3, "busy_ms": busy / 1e3,
            "idle_share": (1 - busy / 1e6 / wall) if spans else None,
            "device_ms_by_group": dict(by_group),
            "kernels": len(spans),
            "top_kernels_ms": {k[:120]: v for k, v in top}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("resnet_step_trace: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from deeplearning4j_tpu_torch.datasets import DataSet
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    lines = []

    def emit(rec):
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)
    net = cs.seeded_resnet50("cuda")
    rng = np.random.default_rng(cs.SEED + 30)
    ds = DataSet(*cs._random_batch(rng, args.batch, (3, 224, 224), 1000))
    for _ in range(2):
        net.fit(ds)
    torch.cuda.synchronize()
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    emit({"batch": args.batch, "step_s": secs,
          "samples_per_s": args.batch / float(np.median(secs)),
          "traced_step": _trace(torch, lambda: net.fit(ds)),
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    x = torch.from_numpy(ds.features[:32]).cuda()
    net.output(x)
    emit({"output_batch": 32, "traced_output": _trace(
        torch, lambda: net.output(x))})
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
