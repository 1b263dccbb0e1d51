#!/usr/bin/env python3
"""Build the flash kernels, check the forward and the backward pair against
their plain versions and time them, on one GPU.

    python3 tools/flash_probe.py [--variant NAME=PATH.cu ...] [--reps N]
                                 [--step]

Prints one JSON line per step: the build (nvcc seconds, ptxas registers,
spills and wgmma notes of every kernel), the forward, dq and dk/dv kernels
against ``flash_forward_reference``, ``flash_dq_reference`` and
``flash_dkv_reference`` on chip_smoke.py's cases (rtol = atol = FLASH_TOL),
and the CUDA-event time of each at the training shape (4, 8, 8192, 64),
causal (the forward's split pre-pass included).  Each ``--variant`` is
another source with the same C interface (a copy of
``csrc/flash_attention.cu`` with one part changed, kept under a git-ignored
directory):
it is built beside the repo's kernels, checked the same way on the small
cases, and timed in turns with them, repo / variants / variants reversed /
repo, so that designs are compared on one card in one call.  A variant
with a part cut out fails its checks by design; the last line says
whether every check passed, and the exit code is 0 unless a build or a
launch failed.

``--step`` adds chip_smoke.py's sharpest accuracy check: one attention
training step at T = 2,048 through each library's kernels against the plain
versions (``_attention_step_vs_plain``: the relative 2-norm of every
param's gradient and Adam update), and once with the plain forward and the
repo's backward kernels.  The steps run in turns, twice over: the update
errors move with the work that ran before them (not traced), so a library
is judged on both turns.

``--bf16`` probes the bf16 forms instead, through the port's wrappers:

    python3 tools/flash_probe.py --bf16 [--root DIR] [--time-only] [--reps N]

the build, the HGMMA (BF16) or HMMA count of each bf16 instance in the
SASS, each form against its plain version on chip_smoke.py's bf16 cases
(``check_flash_bf16``: one bf16 ulp + BF16_FLASH_ATOL of the scale, lse
FLASH_TOL, a dead row), then the CUDA-event time of each at the training
shape beside SDPA bf16's.  ``--root`` imports the port from another
checkout (a git-ignored copy of another commit), so two commits are timed
on one card in one call, one process each, in turns.
"""

import argparse
import ast
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the repo's check and timing helpers)


def _forward(torch, ck, lib, q, k, v, km, causal, scale):
    """(out, lse) from ``lib``'s forward kernel."""
    B, H, T, D = q.shape
    outputs = [torch.empty_like(q), q.new_empty((B, H, T)),
               torch.empty(ck.flash_fwd_scratch_bytes(B * H, T, D),
                           dtype=torch.uint8, device=q.device)]
    inputs = [t.contiguous() for t in (q, k, v, km)]
    return _launch(torch, lib, "dl4j_flash_fwd_f32", inputs, outputs, causal,
                   scale)[:2]


def _launch(torch, lib, symbol, inputs, outputs, causal, scale):
    q = inputs[0]
    B, H, T, D = q.shape
    err = getattr(lib.get(), symbol)(
        *(t.data_ptr() for t in (*inputs, *outputs)), B * H, H, T, D,
        int(causal), float(scale), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{symbol} from {lib.source}: CUDA error {err}")
    return outputs


def _pair(torch, lib, q, k, v, km, g, lse, delta, causal, scale):
    """(dq, dk, dv) from ``lib``'s two backward kernels."""
    inputs = [t.contiguous() for t in (q, k, v, km, g, lse, delta)]
    dq = _launch(torch, lib, "dl4j_flash_dq_f32", inputs,
                 (torch.empty_like(q),), causal, scale)[0]
    dk, dv = _launch(torch, lib, "dl4j_flash_dkv_f32", inputs,
                     (torch.empty_like(q), torch.empty_like(q)), causal,
                     scale)
    return dq, dk, dv


def check(torch, ck, lib, gen, B, H, T, D, causal, mask) -> dict:
    q, k, v, g, km = cs._flash_inputs(torch, gen, B, H, T, D, mask)
    s = D ** -0.5
    out, lse = ck.flash_forward_reference(q, k, v, km, causal, s)
    delta = (g * out).sum(-1)
    got = (*_forward(torch, ck, lib, q, k, v, km, causal, s),
           *_pair(torch, lib, q, k, v, km, g, lse, delta, causal, s))
    want = (out, lse,
            ck.flash_dq_reference(q, k, v, km, g, lse, delta, causal, s),
            *ck.flash_dkv_reference(q, k, v, km, g, lse, delta, causal, s))
    torch.cuda.synchronize()
    rec = {"shape": [B, H, T, D], "causal": causal, "mask": mask}
    ok = True
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        err = (a - b).abs()
        allow = cs.FLASH_TOL + cs.FLASH_TOL * b.abs()
        rec[name] = {"max_abs": float(err.max()),
                     "worst_over_tol": float((err / allow).max()),
                     "finite": bool(torch.isfinite(a).all())}
        ok = ok and rec[name]["worst_over_tol"] <= 1.0 and rec[name]["finite"]
    rec["ok"] = ok
    return rec


# the bf16 cases of chip_smoke.py's bf16_sequence_kernels but the longest
BF16_CASES = [(2, 2, 200, 64, False, "tail"), (2, 2, 200, 64, True, "tail"),
              (2, 2, 256, 32, True, "none"), (2, 2, 256, 96, True, "none"),
              (2, 2, 256, 128, False, "none"), (2, 2, 130, 64, True, "none"),
              (2, 2, 256, 64, True, "dead_row"),
              (2, 2, 200, 128, False, "dead_row"),
              (1, 2, 128, 64, True, "none"), (1, 2, 129, 128, True, "none"),
              (1, 2, 191, 64, False, "tail"), (1, 2, 257, 64, True, "none"),
              (1, 2, 257, 128, True, "tail"), (1, 2, 300, 32, True, "none"),
              (1, 2, 2048, 64, True, "none")]


def bf16_main(args) -> int:
    """The bf16 forms: build, SASS, checks, times (see the module doc)."""
    import torch
    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device", file=sys.stderr)
        return 2
    if args.root:
        sys.path.insert(0, str(Path(args.root).resolve()))
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": cs.nvidia_smi()}), flush=True)
    libs = {"repo": ck.FLASH_LIBRARY}
    for spec in args.variant:
        name, path = spec.split("=", 1)
        libs[name] = ck.KernelLibrary(Path(path), ck.FLASH_LIBRARY._symbols)
    for name, lib in libs.items():
        t0 = time.perf_counter()
        lib.get()
        print(json.dumps({"build": name, "source": str(lib.source),
                          "wall_s": time.perf_counter() - t0,
                          "nvcc_s": lib.build_seconds, "ptxas": [
                              l.strip() for l in lib.build_log.splitlines()
                              if "bf16" in l or "wgmma" in l or "spill" in l
                              or "registers" in l]}), flush=True)
    if args.sass_out:
        Path(args.sass_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.sass_out).write_text(subprocess.run(
            [ck._cuda_tool("cuobjdump"), "-sass", str(libs["repo"].path())],
            capture_output=True, text=True, check=True).stdout)
    repo, failed = ck.FLASH_LIBRARY, False
    for name, lib in libs.items():
        if args.time_only:
            break
        ck.FLASH_LIBRARY = lib
        for what, instr in (("BF16", "HGMMA"), ("BF16", "HMMA")):
            counts = {f: n for f, n in ck.sass_hgmma_counts(
                lib, what, instr).items() if "bf16" in f}
            print(json.dumps({"sass": instr, "lib": name, "operand": what,
                              "counts": counts}), flush=True)
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 50)
        # a variant is checked on a few cases
        for c in BF16_CASES if name == "repo" else BF16_CASES[-4:]:
            try:
                rec = cs.check_flash_bf16(torch, ck, gen, *c)
                rec["ok"] = True
            except AssertionError as e:
                rec, failed = {"case": list(c), "ok": False,
                               "error": str(e)[:2000]}, True
            print(json.dumps({"check": rec, "lib": name}), flush=True)
            torch.cuda.empty_cache()
    ck.FLASH_LIBRARY = repo
    B, H, T, D = cs.ATT_BATCH, cs.ATT_HEADS, cs.ATT_SEQ, \
        cs.ATT_WIDTH // cs.ATT_HEADS
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    q, k, v, g, km = cs._flash_inputs(torch, gen, B, H, T, D)
    q, k, v, g = (t.to(bf) for t in (q, k, v, g))
    s = D ** -0.5
    out, lse = ck.flash_forward(q, k, v, km, True, s)
    delta = ck.flash_delta(g, out)
    order = [n for n in libs if n != "repo"]
    turns = ["repo"] + order + order[::-1] + ["repo"] if order else ["repo"]
    for name in turns:
        ck.FLASH_LIBRARY = libs[name]
        rec = {"time": name, "shape": [B, H, T, D]}
        rec["fwd_ms"] = cs.time_ms(torch, lambda: ck.flash_forward(
            q, k, v, km, True, s), reps=args.reps, warmup=1)
        rec["dq_ms"] = cs.time_ms(torch, lambda: ck.flash_dq(
            q, k, v, km, g, lse, delta, True, s), reps=args.reps, warmup=1)
        rec["dkv_ms"] = cs.time_ms(torch, lambda: ck.flash_dkv(
            q, k, v, km, g, lse, delta, True, s), reps=args.reps, warmup=1)
        print(json.dumps(rec), flush=True)
    ck.FLASH_LIBRARY = repo
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        for name, fn in (("fwd", lambda: ck.flash_forward(
                             q, k, v, km, True, s)),
                         ("dkv", lambda: ck.flash_dkv(
                             q, k, v, km, g, lse, delta, True, s))):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
            print(json.dumps({"profile": name, "device_us_per_call": {
                e.key[:60]: e.device_time_total / 3
                for e in prof.key_averages() if e.device_time_total > 0}}),
                flush=True)
    if not args.time_only:
        import torch.nn.functional as F
        with torch.no_grad():
            print(json.dumps({"sdpa_fwd_ms": cs.time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True), reps=args.reps, warmup=1)}))
    print(json.dumps({"ok": not failed}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=PATH of another flash source to build, "
                         "check and time")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--step", action="store_true",
                    help="also the T = 2,048 training step against the "
                         "plain versions, per library")
    ap.add_argument("--bf16", action="store_true",
                    help="probe the bf16 forms through the wrappers")
    ap.add_argument("--root", help="with --bf16: the checkout whose port "
                                   "is imported")
    ap.add_argument("--time-only", action="store_true",
                    help="with --bf16: only build and time")
    ap.add_argument("--profile", action="store_true",
                    help="with --bf16: each kernel's device time under "
                         "torch.profiler")
    ap.add_argument("--sass-out", help="with --bf16: write the flash "
                                       "library's SASS to this file")
    args = ap.parse_args()
    if args.bf16:
        return bf16_main(args)
    import torch
    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": cs.nvidia_smi()}), flush=True)
    libs = {"repo": ck.FLASH_LIBRARY}
    for spec in args.variant:
        name, path = spec.split("=", 1)
        libs[name] = ck.KernelLibrary(Path(path), ck.FLASH_LIBRARY._symbols)
    for name, lib in libs.items():
        t0 = time.perf_counter()
        lib.get()
        print(json.dumps({"build": name, "wall_s": time.perf_counter() - t0,
                          "nvcc_s": lib.build_seconds, "ptxas": [
                              l.strip() for l in lib.build_log.splitlines()
                              if "registers" in l or "spill" in l
                              or "Compiling entry" in l or "wgmma" in l]}),
              flush=True)
    B, H, T, D = cs.ATT_BATCH, cs.ATT_HEADS, cs.ATT_SEQ, \
        cs.ATT_WIDTH // cs.ATT_HEADS
    cases = [(2, 2, 256, 64, True, "none"), (2, 2, 200, 64, False, "tail"),
             (2, 2, 200, 64, True, "tail"), (2, 2, 256, 32, True, "none"),
             (2, 2, 256, 96, True, "none"), (2, 2, 256, 128, False, "none"),
             (2, 2, 130, 64, True, "none"), (2, 2, 256, 64, True, "dead_row"),
             (2, 2, 200, 128, False, "dead_row"),
             (1, 2, T, 64, True, "none"), (B, H, T, D, True, "none")]
    failed = False
    for name, lib in libs.items():
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        # a variant is checked on the small cases only
        for c in cases if name == "repo" else cases[:-2]:
            rec = check(torch, ck, lib, gen, *c)
            failed = failed or not rec["ok"]
            print(json.dumps({"check": name, **rec}), flush=True)
            torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    q, k, v, g, km = cs._flash_inputs(torch, gen, B, H, T, D)
    s = D ** -0.5
    out, lse = ck.flash_forward(q, k, v, km, True, s)
    delta = (g * out).sum(-1)
    inputs = [q, k, v, km, g, lse, delta]
    order = [n for n in libs if n != "repo"]
    turns = ["repo"] + order + order[::-1] + ["repo"] if order else ["repo"]
    for name in turns:
        lib = libs[name]
        rec = {"time": name}
        rec["fwd_ms"] = cs.time_ms(torch, lambda: _forward(
            torch, ck, lib, q, k, v, km, True, s), reps=args.reps, warmup=1)
        rec["dq_ms"] = cs.time_ms(torch, lambda: _launch(
            torch, lib, "dl4j_flash_dq_f32", inputs,
            (torch.empty_like(q),), True, s), reps=args.reps, warmup=1)
        rec["dkv_ms"] = cs.time_ms(torch, lambda: _launch(
            torch, lib, "dl4j_flash_dkv_f32", inputs,
            (torch.empty_like(q), torch.empty_like(q)), True, s),
            reps=args.reps, warmup=1)
        print(json.dumps(rec), flush=True)
    if args.step:
        step_errors(torch, ck, libs)
    print(json.dumps({"ok": not failed}))
    return 0


def step_errors(torch, ck, libs) -> None:
    """One line per library and turn: the attention step at T = 2,048
    through the library's kernels against the plain versions."""
    from unittest import mock
    from deeplearning4j_tpu_torch.models import CharacterIterator, attention_lm
    it = CharacterIterator((ROOT / "SURVEY.md").read_text(),
                           seq_length=cs.ATT_SEQ, batch=cs.ATT_BATCH, seed=0)
    net = attention_lm(it.vocab_size, cs.ATT_WIDTH, cs.ATT_HEADS,
                       cs.ATT_LAYERS, cs.ATT_SEQ, device="cuda").init(
        generator=torch.Generator().manual_seed(cs.SEED))
    start = cs._clone_tree(net.net_params)
    repo = ck.FLASH_LIBRARY

    def plain_forward(*a):
        return ck.flash_forward_reference(*a)
    plain_forward.launches = 0
    runs = [(name, lib, None) for name, lib in libs.items()]
    runs.append(("plain_forward", repo, plain_forward))
    for turn in (1, 2):
        for name, lib, forward in runs:
            it.reset()
            ck.FLASH_LIBRARY = lib
            with mock.patch.object(ck, "flash_forward",
                                   forward or ck.flash_forward):
                try:
                    rec = cs._attention_step_vs_plain(torch, ck, net, it,
                                                      start)
                except AssertionError as e:   # the record is in the message
                    msg = str(e)
                    rec = ast.literal_eval(msg[msg.index("{"):])
            print(json.dumps({"step": name, "turn": turn,
                              "max_grad_rel_err": rec["max_grad_rel_err"],
                              "max_update_rel_err": rec["max_update_rel_err"],
                              "over_tolerance": rec["over_tolerance"]}),
                  flush=True)
    ck.FLASH_LIBRARY = repo


if __name__ == "__main__":
    sys.exit(main())
