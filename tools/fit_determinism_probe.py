#!/usr/bin/env python3
"""Is LeNet + Adam ``fit`` on the card reproducible, with and without
cuDNN's deterministic algorithms?  On one GPU.

    python3 tools/fit_determinism_probe.py [--trials 6]

For each setting of ``torch.backends.cudnn.deterministic`` (benchmark
off) and each pair of feeds — the async pipeline against sync fit
(``pipeline_workers`` 1 and 0), and sync against sync — it trains two nets
from the same params for the first 4 batches of ``chip_smoke.py``'s
``train_lenet_pipeline`` check and prints, per trial, whether the
parameters are bitwise equal and how they fare under the LeNet + Adam rule
of tests/test_torch_fit.py (per tensor the share of elements within rtol
1e-4 / atol 1e-5, which must be at least 0.995, and the largest
difference).  Ends with the card's name and power limit.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=6)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("fit_determinism_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator, fetchers
    from deeplearning4j_tpu_torch.models import lenet
    scaler = cs._mnist_scaler()
    train = fetchers.MnistDataSetIterator(cs.LENET_BATCH, train=True,
                                          seed=cs.SEED)
    first = [scaler.transform(d) for d in train._data[:cs.PIPE_CHECK_STEPS]]

    def run(workers):
        net = lenet(device="cuda")
        net.conf.global_conf.pipeline_workers = workers
        net.init(generator=torch.Generator().manual_seed(cs.SEED))
        net.fit(ListDataSetIterator(first))
        torch.cuda.synchronize()
        return net

    def adam_rule(a, b):
        inside, worst = 1.0, 0.0
        for lp, rp in zip(a.net_params, b.net_params):
            for k in rp:
                d = (lp[k] - rp[k]).abs()
                inside = min(inside, float(
                    (d <= 1e-5 + 1e-4 * rp[k].abs()).float().mean()))
                worst = max(worst, float(d.max()))
        return {"min_share_inside": inside, "max_abs": worst,
                "adam_rule_ok": inside >= 0.995 and worst <= 5e-3}

    torch.backends.cudnn.benchmark = False
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        for pair in ((1, 0), (0, 0)):
            for trial in range(args.trials):
                a, b = run(pair[0]), run(pair[1])
                print(json.dumps({
                    "cudnn_deterministic": det, "workers": pair,
                    "trial": trial,
                    "bitwise": bool(torch.equal(a.params(), b.params())),
                    **adam_rule(a, b)}), flush=True)
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
