#!/usr/bin/env python3
"""Time the conv kernel's bf16 form shape by shape against cuDNN bf16, with
ablated copies of its source, on one GPU.

    python3 tools/conv_probe.py --bf16 [--variant NAME=PATH.cu ...]
                                [--models resnet50,vgg16_224] [--batch 128]
                                [--root DIR] [--profile] [--reps N]
                                [--stamps] [--out FILE]

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
pass apart from the conv).  Each shape's line names the bf16 form's route
(``gemm``, ``halo`` or ``full_width``: ``ck.conv_bf16_route``).

``--stamps`` reads time inside the kernel instead of timing the sets: it
builds a copy of each source (the repo's and every variant's) with
``DL4J_CONV_STAMPS`` defined, whose kernels record ``clock64`` at the
phases of a slice and of a tile (the source's CONV_STAMP points) on thread
0 of the first eight blocks, and runs one 1x1 and one 3x3 shape at each of
ResNet-50's plane sizes and VGG16-224's 224 and 28 planes.  Per shape and
source it prints the mean microseconds between consecutive phases over the
blocks' steady slices (the first and last slice left out), a slice's
mean, and the tile's prologue, loop and epilogue, cycles converted to time
by the block's own ``%globaltimer`` span.

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


STAMP_BLOCKS, STAMP_SLICES, STAMP_PHASES = 8, 32, 8


def _stamp_library(ck, name, source: Path):
    """A copy of ``source`` (and the headers beside it) with
    DL4J_CONV_STAMPS defined, under the git-ignored build directory, as a
    KernelLibrary that also exports ``dl4j_conv_stamps``."""
    import ctypes
    import shutil
    d = ck.BUILD_DIR / f"stamps-{name}"
    d.mkdir(parents=True, exist_ok=True)
    for h in source.parent.glob("*.cuh"):
        shutil.copy(h, d / h.name)
    (d / source.name).write_text("#define DL4J_CONV_STAMPS 1\n" +
                                 source.read_text())
    symbols = dict(ck.CONV_LIBRARY._symbols)
    symbols["dl4j_conv_stamps"] = ([ctypes.c_void_p], ctypes.c_int)
    return ck.KernelLibrary(d / source.name, symbols)


def _read_stamps(lib):
    """The stamps as [block][slot][phase] ints (zeroed after reading)."""
    import ctypes
    n = STAMP_BLOCKS * (STAMP_SLICES + 1) * STAMP_PHASES
    buf = (ctypes.c_longlong * n)()
    err = lib.get().dl4j_conv_stamps(buf)
    if err:
        raise RuntimeError(f"dl4j_conv_stamps: CUDA error {err}")
    return [[list(buf[(b * (STAMP_SLICES + 1) + s) * STAMP_PHASES:
                      (b * (STAMP_SLICES + 1) + s + 1) * STAMP_PHASES])
             for s in range(STAMP_SLICES + 1)] for b in range(STAMP_BLOCKS)]


def _stamp_summary(stamps) -> dict:
    """Mean microseconds between consecutive recorded phases of the steady
    slices (every slice but the first and the last), of a whole slice, and
    of the tile's prologue, loop and epilogue, over the blocks."""
    phases, slice_us, tile = {}, [], {"prologue": [], "loop": [],
                                       "epilogue": [], "slices": []}
    for blk in stamps:
        t = blk[STAMP_SLICES]
        if not (t[0] and t[3] and t[4] and t[5] and t[5] > t[4]):
            continue
        per_us = (t[5] - t[4]) / 1e3 / (t[3] - t[0])     # us per cycle
        tile["prologue"].append((t[1] - t[0]) * per_us)
        tile["loop"].append((t[2] - t[1]) * per_us)
        tile["epilogue"].append((t[3] - t[2]) * per_us)
        n = sum(1 for sl in blk[:STAMP_SLICES] if sl[0])
        tile["slices"].append(n)
        for i in range(1, n - 1):
            sl = blk[i]
            done = [k for k in range(STAMP_PHASES) if sl[k]]
            for a, b in zip(done, done[1:]):
                phases.setdefault(f"{a}-{b}", []).append(
                    (sl[b] - sl[a]) * per_us)
            slice_us.append((blk[i + 1][0] - sl[0]) * per_us)
            if done:
                phases.setdefault(f"{done[-1]}-next0", []).append(
                    (blk[i + 1][0] - sl[done[-1]]) * per_us)

    def mean(v):
        return sum(v) / len(v) if v else None
    return {"blocks": len(tile["slices"]),
            "phase_us": {k: mean(v) for k, v in phases.items()},
            "slice_us": mean(slice_us),
            "tile_us": {k: mean(v) for k, v in tile.items()}}


def stamp_shapes(cs):
    """One 1x1 and one 3x3 conv at each of ResNet-50's planes (56, 28, 14,
    7) at batch 128, and VGG16-224's widest convs at its 224 and 28 planes."""
    out, seen = [], set()
    for s in cs.conv_shapes("resnet50", 128):
        key = (s[2], s[5])
        if key not in seen:
            seen.add(key)
            out.append(s)
    vgg = {}
    for s in cs.conv_shapes("vgg16_224", 128):
        if s[2] in (224, 28):
            vgg[s[2]] = s              # the plane's widest conv
    return out + list(vgg.values())


def run_stamps(torch, ck, libs, emit) -> None:
    stamp_libs = {n: _stamp_library(ck, n, lib.source)
                  for n, lib in libs.items()}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(stamp_libs)) as pool:
        list(pool.map(ck.KernelLibrary.get, stamp_libs.values()))
    for name, lib in stamp_libs.items():
        emit({"stamp_build": name, "wall_s": time.perf_counter() - t0,
              "ptxas": [l.strip() for l in lib.build_log.splitlines()
                        if "bf16" in l and ("registers" in l or "spill" in l
                                            or "wgmma" in l)]})
    repo = ck.CONV_LIBRARY
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 41)
    for shape in stamp_shapes(cs):
        x, w, b = _inputs(torch, shape, gen)
        pad, act = (shape[6], shape[6]), shape[7]
        rec = {"stamps": list(shape[:7]), "route": _route(ck, shape)}
        for name, lib in stamp_libs.items():
            ck.CONV_LIBRARY = lib
            ck.fused_conv2d_bias_act(x, w, b, pad=pad, activation=act)
            torch.cuda.synchronize()
            _read_stamps(lib)
            ck.fused_conv2d_bias_act(x, w, b, pad=pad, activation=act)
            torch.cuda.synchronize()
            rec[name] = _stamp_summary(_read_stamps(lib))
        ck.CONV_LIBRARY = repo
        emit(rec)
        del x, w, b
        torch.cuda.empty_cache()


def _route(ck, shape) -> str:
    """The bf16 form's route for a probe shape (``ck.conv_bf16_route``),
    or ``halo`` where the port has no such function (an older --root)."""
    N, Cin, H, W, Cout, K, p, _ = shape
    KH, KW = (K, K) if isinstance(K, int) else K
    fn = getattr(ck, "conv_bf16_route", None)
    if fn is None:
        return "halo"
    return fn(N, Cin, H, W, Cout, KH, KW, p, p)


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
    ap.add_argument("--stamps", action="store_true",
                    help="phase stamps inside the kernels instead of times")
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
    if args.stamps:
        run_stamps(torch, ck, libs, emit)
        if out:
            out.close()
        return 0
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
                   "activation": act, "runs": n_runs,
                   "route": _route(ck, shape)}
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
