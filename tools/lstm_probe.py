#!/usr/bin/env python3
"""Build the LSTM step kernel, check it against its plain version and time
it by CUDA-graph replay, on one GPU.

    python3 tools/lstm_probe.py [--bf16] [--variant NAME=PATH.cu ...]

Prints one JSON line per step: the build (nvcc seconds, ptxas registers and
spills), the kernel against ``lstm_step_reference`` (c' and h', rtol = atol
= LSTM_TOL) at chip_smoke.py's shapes with zx a row-strided view, and the
time of one step at the main paths' (N, H) = (32, 200), (4, 200) and
(1, 200), replaying a CUDA graph of 50 steps.  Each ``--variant`` is
another source with the same C interface (a copy of ``csrc/lstm_step.cu``
with one part changed, kept under a git-ignored directory): it is built
beside the repo's kernel, checked the same way and timed in turns with it,
repo / variants / variants reversed / repo.  ``--bf16`` adds the bf16
form (``dl4j_lstm_step_bf16``): it is checked on bf16 inputs by chip_smoke's
bf16 rule (one bf16 ulp + BF16_CONV_ATOL of the scale, on c' and h') and
timed in the same turns, beside the f32 form, so that the two forms of one
library are read side by side.  The last line says whether every check
passed; the exit code is 0 unless a build or a launch failed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the repo's check and timing helpers)

TIMED = ((cs.CHAR_BATCH, cs.CHAR_HIDDEN), (cs.SAMPLE_STREAMS, cs.CHAR_HIDDEN),
         (1, cs.CHAR_HIDDEN))
CHECKED = TIMED + ((3, 8), (5, 24), (64, 256), (3, 1024), (7, 264), (40, 8))
# the bf16 form's further edges: H not a multiple of 8 (2-byte staging),
# H past a staged k chunk (224), N not a multiple of a block's 8 rows
BF16_EDGES = ((9, 12), (2, 7), (17, 232), (33, 200), (8, 456), (1, 1))


def _inputs(torch, gen, N, H, dtype=None):
    """zx a time step of [N, 3, 4H] (row-strided), h, c, RW, p3, in
    ``dtype`` (f32 by default)."""
    dtype = dtype or torch.float32

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)
    return (randn(N, 3, 4 * H)[:, 1], randn(N, H), randn(N, H),
            randn(H, 4 * H, scale=H ** -0.5), randn(3, H, scale=0.1))


def _step(torch, lib, zx, h, c, rw, p3):
    """(c', h') from ``lib``'s kernel of zx's dtype."""
    N, H = c.shape
    c_new, h_new = torch.empty_like(c), torch.empty_like(c)
    fn = (lib.get().dl4j_lstm_step_bf16 if zx.dtype == torch.bfloat16
          else lib.get().dl4j_lstm_step_f32)
    err = fn(
        zx.data_ptr(), zx.stride(0), h.data_ptr(), c.data_ptr(),
        rw.data_ptr(), p3.data_ptr(), c_new.data_ptr(), h_new.data_ptr(), N,
        H, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"lstm step from {lib.source}: CUDA error {err}")
    return c_new, h_new


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bf16", action="store_true",
                    help="check and time the bf16 form beside the f32 one")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=PATH of another lstm source to build, check "
                         "and time")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("lstm_probe: no CUDA device", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": cs.nvidia_smi()}), flush=True)
    libs = {"repo": ck.LSTM_LIBRARY}
    for spec in args.variant:
        name, path = spec.split("=", 1)
        libs[name] = ck.KernelLibrary(Path(path), ck.LSTM_LIBRARY._symbols)
    for name, lib in libs.items():
        t0 = time.perf_counter()
        lib.get()
        print(json.dumps({"build": name, "wall_s": time.perf_counter() - t0,
                          "nvcc_s": lib.build_seconds, "ptxas": [
                              l.strip() for l in lib.build_log.splitlines()
                              if "registers" in l or "spill" in l]}),
              flush=True)
    dtypes = {"f32": torch.float32}
    if args.bf16:
        dtypes["bf16"] = torch.bfloat16
    failed = False
    for name, lib in libs.items():
        for form, dtype in dtypes.items():
            gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
            for N, H in CHECKED + (BF16_EDGES if form == "bf16" else ()):
                args_ = _inputs(torch, gen, N, H, dtype)
                got = _step(torch, lib, *args_)
                want = ck.lstm_step_reference(*args_)
                torch.cuda.synchronize()
                err = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(got, want))
                if form == "bf16":
                    ok = all(cs.bf16_conv_compare(torch, a, b)["ok"]
                             for a, b in zip(got, want))
                else:
                    ok = all(bool(torch.allclose(a, b, rtol=cs.LSTM_TOL,
                                                 atol=cs.LSTM_TOL))
                             for a, b in zip(got, want))
                failed = failed or not ok
                print(json.dumps({"check": name, "form": form,
                                  "shape": [N, H], "max_abs_err": err,
                                  "ok": ok}), flush=True)
    inputs = {}
    for form, dtype in dtypes.items():
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        inputs[form] = {s: _inputs(torch, gen, *s, dtype) for s in TIMED}
    order = [n for n in libs if n != "repo"]
    turns = ["repo"] + order + order[::-1] + ["repo"] if order else ["repo"]
    for name in turns:
        lib = libs[name]
        rec = {"time": name}
        for form in dtypes:
            for s, a in inputs[form].items():
                rec[form + "_" + "x".join(map(str, s)) + "_us"] = \
                    1e3 * cs.graph_ms(torch, lambda: _step(torch, lib, *a),
                                      calls=50)
        print(json.dumps(rec), flush=True)
    print(json.dumps({"ok": not failed}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
