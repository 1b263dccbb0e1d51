#!/usr/bin/env python3
"""chip_smoke.py's train_resnet50_bf16 with the compared step moved: for
each count given, that many bf16 ``fit`` steps of the zero-gamma ResNet-50
at batch 128, then the next one held to the plain bf16 step and to the
plain step with its conv summed in the kernel's order (the phase's
rules).  One JSON line a count, the phase's verdict beside the readings.

    python3 tools/bf16_resnet_steps.py 3 10 20 [--out steps.json]

Needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

KEYS = ("score_rel_diff", "max_update_rel_err", "worst_updates",
        "max_bn_stats_rel_err", "max_bn_fed_bias_update_over_w_update",
        "worst_bn_fed_biases_step_and_plain",
        "max_bn_fed_bias_update_over_plain", "max_tie_gap")


def main(argv=None) -> int:
    import torch
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("steps", type=int, nargs="+")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    ck.build_libraries()
    out, emit = {}, cs.emit
    for steps in args.steps:
        cs.RESNET_BF16_STEPS = steps
        rec = {}
        cs.emit = lambda phase, **fields: rec.update(fields)
        t0 = time.perf_counter()
        try:
            cs.phase_train_resnet50_bf16(torch, ck, {
                "samples_per_s_after_first": None,
                "max_memory_allocated": None})
            verdict = "held"
        except AssertionError as e:
            verdict = f"failed: {e}"
        finally:
            cs.emit = emit
        out[steps] = {
            "verdict": verdict, "seconds": time.perf_counter() - t0,
            "device": torch.cuda.get_device_name(0),
            "f32_cosine": rec["f32_step"]["cosine"],
            **{tag: {k: rec[key][k] for k in KEYS} for tag, key in (
                ("kernel_vs_plain", "plain_step"),
                ("reordered_vs_plain", "reordered_plain_step_vs_plain"))}}
        print(json.dumps({steps: out[steps]}), flush=True)
        torch.cuda.empty_cache()
    print(cs.nvidia_smi())
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
