#!/usr/bin/env python3
"""Time the conv kernel's bf16 form shape by shape against cuDNN bf16, with
ablated copies of its source, on one GPU.

    python3 tools/conv_probe.py --bf16 [--variant NAME=PATH.cu ...]
                                [--models resnet50,vgg16_224] [--batch 128]
                                [--root DIR] [--profile] [--reps N]
                                [--out FILE]

Prints one JSON line per step: the device and its power limit; the build
of the repo's conv library and of each ``--variant`` (nvcc seconds and
ptxas's registers, spills and wgmma notes for the bf16 kernels); then, for
each distinct stride-1 conv shape of the models' forwards at the batch
(ResNet-50's 46 and VGG16-224's 13 at 128 by default), the repo's kernel
against its plain version by chip_smoke.py's bf16 conv rule, and the
CUDA-event time of the repo's kernel, of every variant and of cuDNN bf16
(``F.conv2d`` on bf16 + the activation) on the same inputs, the libraries
in turns (repo, variants, variants reversed, repo), with the shape's bound
(bf16 operations or bytes) and how often the set runs it; last, each
model's set summed over its convs, repeats included, per library.
``--profile`` adds, per shape, the device time of each kernel of one
call of the repo's form under ``torch.profiler`` (the weights' reorder
pass apart from the conv).

A variant is another source with the same C interface: a copy of
``csrc/conv_bias_act.cu`` with one part cut out (its staging, its products,
its gather), kept under a git-ignored directory with the two headers beside
it.  An ablated variant computes the wrong thing by design, so variants are
timed and not checked; the repo's kernel is checked at every shape and the
exit code is 1 if a check fails.  ``--root`` imports the port, and so its
conv library, from another checkout (a git-ignored copy of another
commit), so that commits are timed on one card.
"""

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the repo's check and timing helpers)


def _inputs(torch, shape, gen):
    """bf16 x, He-scaled w and b of one conv shape, as
    chip_smoke.check_conv_bf16 makes them."""
    N, Cin, H, W, Cout, K, _, _ = shape
    KH, KW = (K, K) if isinstance(K, int) else K
    dev = torch.device("cuda")
    bf = torch.bfloat16
    x = torch.randn((N, Cin, H, W), generator=gen, device=dev).to(bf)
    w = (torch.randn((Cout, Cin, KH, KW), generator=gen, device=dev)
         * (2.0 / (Cin * KH * KW)) ** 0.5).to(bf)
    b = (torch.randn((Cout,), generator=gen, device=dev) * 0.1).to(bf)
    return x, w, b


def _bound(shape):
    """(bound ms, bound_by): FLOPs at the bf16 peak or 2-byte elements at
    the memory rate, as chip_smoke.check_conv_bf16 counts them."""
    N, Cin, H, W, Cout, K, p, _ = shape
    KH, KW = (K, K) if isinstance(K, int) else K
    OH, OW = H + 2 * p - KH + 1, W + 2 * p - KW + 1
    flops = 2 * N * Cout * Cin * cs.valid_taps(H, KH, p, OH) * \
        cs.valid_taps(W, KW, p, OW)
    nbytes = 2 * (N * Cin * H * W + Cout * Cin * KH * KW + Cout
                  + N * Cout * OH * OW)
    t_ops, t_bytes = flops / cs.PEAK_BF16_FLOPS, nbytes / cs.PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def _profile(torch, fn, calls: int = 3) -> dict:
    """{kernel name: device ms a call} of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:80]: e.device_time_total / calls / 1e3
            for e in prof.key_averages() if e.device_time_total > 0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bf16", action="store_true", required=True,
                    help="probe the bf16 form (the f32 form's shapes are "
                         "timed by chip_smoke.py's kernels and "
                         "resnet50_kernels phases)")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=PATH of another conv source to build and time")
    ap.add_argument("--models", default="resnet50,vgg16_224")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--root", help="the checkout whose port is imported")
    ap.add_argument("--profile", action="store_true",
                    help="each kernel's device time per call, repo only")
    ap.add_argument("--out", help="also write every line to this file")
    args = ap.parse_args()
    if args.root:
        sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("conv_probe: no CUDA device", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.ops import activations as act_ops
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = open(args.out, "w") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    emit({"device": torch.cuda.get_device_name(0),
          "nvidia_smi": cs.nvidia_smi()})
    libs = {"repo": ck.CONV_LIBRARY}
    for spec in args.variant:
        name, path = spec.split("=", 1)
        libs[name] = ck.KernelLibrary(Path(path), ck.CONV_LIBRARY._symbols)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:    # one nvcc each, at once
        list(pool.map(ck.KernelLibrary.get, libs.values()))
    for name, lib in libs.items():
        emit({"build": name, "source": str(lib.source),
              "wall_s": time.perf_counter() - t0,
              "nvcc_s": lib.build_seconds, "ptxas": [
                  l.strip() for l in lib.build_log.splitlines()
                  if ("bf16" in l or "Compiling" in l or "wgmma" in l
                      or "spill" in l or "registers" in l)]})
    repo, failed = ck.CONV_LIBRARY, False
    order = [n for n in libs if n != "repo"]
    turns = ["repo"] + order + order[::-1] + ["repo"]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 40)
    for model in args.models.split(","):
        shapes = cs.conv_shapes(model, args.batch)
        counts = {}
        for s in shapes:
            counts[s] = counts.get(s, 0) + 1
        total = {n: 0.0 for n in (*libs, "library", "bound")}
        for shape, n_runs in counts.items():
            x, w, b = _inputs(torch, shape, gen)
            pad, act = (shape[6], shape[6]), shape[7]
            act_fn = act_ops.get(act)
            rec = {"model": model, "shape": list(shape[:7]),
                   "activation": act, "runs": n_runs}
            ref = ck.conv2d_bias_act_reference(x, w, b, pad, "truncate", act)
            y = ck.fused_conv2d_bias_act(x, w, b, pad=pad, activation=act)
            torch.cuda.synchronize()
            rule = cs.bf16_conv_compare(torch, y, ref)
            rec["check"] = rule
            failed = failed or not rule["ok"]
            del y, ref
            times = {n: [] for n in libs}
            for name in turns:
                ck.CONV_LIBRARY = libs[name]
                times[name].append(cs.time_ms(
                    torch, lambda: ck.fused_conv2d_bias_act(
                        x, w, b, pad=pad, activation=act),
                    reps=args.reps, warmup=2))
            ck.CONV_LIBRARY = repo
            rec["ms"] = {n: min(t) for n, t in times.items()}
            rec["library_ms"] = cs.time_ms(
                torch, lambda: act_fn(F.conv2d(x, w, b, padding=pad)),
                reps=args.reps, warmup=2)
            rec["bound_ms"], rec["bound_by"] = _bound(shape)
            if args.profile:
                rec["device_ms_per_call"] = _profile(
                    torch, lambda: ck.fused_conv2d_bias_act(
                        x, w, b, pad=pad, activation=act))
            emit(rec)
            for n, t in rec["ms"].items():
                total[n] += n_runs * t
            total["library"] += n_runs * rec["library_ms"]
            total["bound"] += n_runs * rec["bound_ms"]
            del x, w, b
            torch.cuda.empty_cache()
        emit({"set": model, "batch": args.batch, "convs": len(shapes),
              "ms": total})
    emit({"ok": not failed})
    if out:
        out.close()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
