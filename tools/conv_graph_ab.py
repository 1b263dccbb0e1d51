#!/usr/bin/env python3
"""Device time of the conv kernel's bf16 form over chip_smoke.py's timed
bf16 sets, by CUDA-graph replay, on one GPU.

    python3 tools/conv_graph_ab.py [--root DIR]

Prints one JSON line: the device and its power limit, and for each set of
``chip_smoke.bf16_conv_sets()`` (the served models at 32 rows, VGG16-224
at 8 and 128, ResNet-50's 46 stride-1 convs at 128, the text CNN's
full-width convs) the milliseconds of one pass over the set's convs,
replayed from a CUDA graph as chip_smoke.py's ``graph_ms`` replays it, on
seeded bf16 inputs.  ``--root`` imports the port, and so its conv library,
from another checkout (a git-ignored copy of another commit), so that two
commits are timed on one card: run it once per tree, in turns (parent,
change, change, parent).  Per-call times of small convs are host-bound;
the graph's are the device's.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the repo's sets and graph timing)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", help="the checkout whose port is imported")
    args = ap.parse_args()
    if args.root:
        sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("conv_graph_ab: no CUDA device", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 42)
    bf = torch.bfloat16
    out = {"device": torch.cuda.get_device_name(0),
           "nvidia_smi": cs.nvidia_smi(), "port": str(Path(ck.__file__)
                                                       .parent.parent)}
    for name, shapes, calls in cs.bf16_conv_sets():
        inputs = []
        for N, Cin, H, W, Cout, K, p, act in shapes:
            KH, KW = (K, K) if isinstance(K, int) else K
            x = torch.randn((N, Cin, H, W), generator=gen,
                            device="cuda").to(bf)
            w = (torch.randn((Cout, Cin, KH, KW), generator=gen,
                             device="cuda")
                 * (2.0 / (Cin * KH * KW)) ** 0.5).to(bf)
            b = (torch.randn((Cout,), generator=gen, device="cuda")
                 * 0.1).to(bf)
            inputs.append((x, w, b, (p, p), act))
        out[name] = cs.graph_ms(
            torch, lambda: [ck.fused_conv2d_bias_act(x, w, b, pad=pad,
                                                     activation=act)
                            for x, w, b, pad, act in inputs],
            calls=calls, reps=3)
        del inputs
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
