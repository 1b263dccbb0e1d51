#!/usr/bin/env python3
"""Compare two trees of the repo on one GPU by running each tree's own
``chip_smoke.py`` in turns: A, B, B, A (A is the baseline, B the change).

    python3 tools/chip_ab.py A_DIR B_DIR --out RESULTS.json

Each run is ``python3 chip_smoke.py`` with the tree as its working
directory, so each tree builds and loads its own kernels.  From every run
the script keeps the end-to-end numbers both trees' scripts print: VGG16-224
training (samples/s after the first step, peak memory), VGG16-224
``output()`` ms at batch 8, serving (requests/s, p50 and p99 latency and
the batcher's mean compute ms per model), LeNet training samples/s, the
xent, dropout and LSTM kernels' times (xent and the LSTM at every timed
shape, xent beside an empty kernel on its grid where the tree's script
times one), LeNet through the input pipeline (samples/s, the reorder
buffer's high-water mark, ``evaluate``'s accuracy), the gateway's ``fit`` seconds,
char-RNN training characters/s, the
flash kernels' and SDPA's times, attention training (characters/s after the
first step, step seconds, peak memory), attention ``output()`` ms and
sampling ms per character, VGG16-BN's ``output()`` ms and training
samples/s, ResNet-50's 46-conv set (kernel and cuDNN ms), serving
(requests/s, p50, ``output()`` ms at batch 32) and training (samples/s,
peak memory), and the build's seconds.  It prints one JSON line per run, with the run's last
line of output, and writes every run's phase lines to ``--out``.  It exits non-zero if any run fails; the failed
run's last lines of output are in the file.  Comparing the two trees is
fair only within one such call: the card, its power limit and the host
are shared by all four runs.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def _phases(stdout: str) -> dict:
    out = {}
    for line in stdout.splitlines():
        line = line.strip()
        if line.startswith('{"phase": '):
            rec = json.loads(line)
            out[rec["phase"]] = rec
    return out


def _numbers(ph: dict) -> dict:
    """The end-to-end numbers of one run, where its phases printed them."""
    nums = {}
    if "build" in ph:
        nums["build_s"] = ph["build"]["seconds"]
    if "train_vgg16_224" in ph:
        t = ph["train_vgg16_224"]
        nums["vgg16_224_samples_per_s"] = t["samples_per_s_after_first"]
        nums["vgg16_224_step_s"] = [s["seconds"] for s in t["steps"]]
        nums["vgg16_224_peak_bytes"] = t["max_memory_allocated"]
    if "vgg16_224" in ph:
        nums["vgg16_224_output_ms"] = ph["vgg16_224"]["wall_ms"]
    if "serve" in ph:
        for name, m in ph["serve"]["models"].items():
            nums[f"serve_{name}"] = {
                "requests_per_s": m["requests_per_s"],
                "p50_ms": m["p50_ms"], "p99_ms": m["p99_ms"],
                "compute_mean_ms": m["batcher"]["compute_ms"]["mean_ms"]}
    if "train_lenet" in ph:
        nums["lenet_samples_per_s"] = ph["train_lenet"]["samples_per_s"]
    if "xent_dropout_kernels" in ph:
        x = ph["xent_dropout_kernels"]
        nums["xent_ms"] = x["xent"][0]["ms"]
        nums["xent_timed"] = {
            "x".join(map(str, r["shape"])): {
                k: r.get(k) for k in ("ms", "empty_kernel_ms", "plain_ms",
                                      "library_ms", "bound_ms")}
            for r in x["xent"] if "ms" in r}
        nums["dropout_ms"] = [r["ms"] for r in x["dropout"] if "ms" in r]
    if "train_lenet_pipeline" in ph:
        t = ph["train_lenet_pipeline"]
        nums["lenet_pipeline_samples_per_s"] = t["samples_per_s"]
        nums["lenet_pipeline_ready_high_water"] = t["ready_high_water"]
        nums["lenet_evaluate"] = {k: t["evaluate"][k] for k in
                                  ("accuracy", "f1", "seconds")}
    if "gateway_fit_evaluate" in ph:
        nums["gateway_fit_s"] = ph["gateway_fit_evaluate"]["fit"]["seconds"]
    if "lstm_kernel" in ph:
        nums["lstm_us_per_step"] = ph["lstm_kernel"]["us_per_step"]
        nums["lstm_us_by_shape"] = {
            "x".join(map(str, r["shape"])): r["ms"] * 1e3
            for r in ph["lstm_kernel"]["steps"] if "ms" in r}
    if "train_charrnn" in ph:
        nums["charrnn_chars_per_s"] = \
            ph["train_charrnn"]["chars_per_s_after_first"]
    if "flash_kernels" in ph:
        f = ph["flash_kernels"]
        nums["flash_ms"] = {k: r["ms"] for k, r in f["timed"].items()}
        nums["sdpa_ms"] = {k: f.get(f"library_ms_{k}") for k in
                           ("forward", "backward", "forward_backward")}
    if "keras_vgg16_bn" in ph:
        nums["vgg16_bn_output_ms"] = {
            n: b["output_ms"] for n, b in ph["keras_vgg16_bn"]["batches"].items()}
    if "train_keras_vgg16_bn" in ph:
        nums["vgg16_bn_samples_per_s"] = \
            ph["train_keras_vgg16_bn"]["samples_per_s_after_first"]
    if "resnet50_kernels" in ph:
        t = ph["resnet50_kernels"]["timed_set"]["resnet50_128"]
        nums["resnet50_conv_set_ms"] = {k: t[k] for k in (
            "ms", "library_ms", "library_tf32_ms", "bound_ms")}
    if "serve_resnet50" in ph:
        t = ph["serve_resnet50"]
        nums["resnet50_output_32_ms"] = t["output_32_ms"]
    if "train_resnet50" in ph:
        t = ph["train_resnet50"]
        nums["resnet50_samples_per_s"] = t["samples_per_s_after_first"]
        nums["resnet50_peak_bytes"] = t["max_memory_allocated"]
    if "train_attention" in ph:
        t = ph["train_attention"]
        nums["attention_chars_per_s"] = t["chars_per_s_after_first"]
        nums["attention_step_s"] = [s["seconds"] for s in t["steps"]]
        nums["attention_peak_bytes"] = t["max_memory_allocated"]
    if "output_attention" in ph:
        nums["attention_output_ms"] = ph["output_attention"]["wall_ms"]
    if "sample_attention" in ph:
        nums["attention_sample_ms_per_char"] = \
            ph["sample_attention"]["ms_per_char"]
    return nums


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a_dir", type=Path)
    ap.add_argument("b_dir", type=Path)
    ap.add_argument("--out", type=Path, required=True,
                    help="JSON file for every run's phase lines")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds allowed for each run")
    args = ap.parse_args()
    runs, failed = [], False
    for label, tree in (("A", args.a_dir), ("B", args.b_dir),
                        ("B", args.b_dir), ("A", args.a_dir)):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree,
                              capture_output=True, text=True,
                              timeout=args.timeout)
        ph = _phases(proc.stdout)
        lines = proc.stdout.strip().splitlines()
        run = {"tree": label, "dir": str(tree), "rc": proc.returncode,
               "wall_s": time.perf_counter() - t0, **_numbers(ph),
               "last_line": lines[-1] if lines else ""}
        print(json.dumps(run), flush=True)
        run["phases"], run["tail_lines"] = ph, lines[-3:]
        if proc.returncode != 0:
            failed = True
            run["stdout_tail"] = proc.stdout[-4000:]
            run["stderr_tail"] = proc.stderr[-4000:]
        runs.append(run)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(runs))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
