#!/usr/bin/env python3
"""t-SNE's P on a trained word-vector table: the card against the CPU, with
d² formed in float32 and in float64, on one GPU.

    python3 tools/tsne_p_probe.py [--turns 2] [--windows 5] [--out FILE]

Each turn trains ``train_word2vec``'s table (``chip_smoke.py``: V = 71,290,
layer 128, the seeded 1,000,000-token corpus; the card's scatter order
makes each turn's table its own) and cuts its 2,000 x ``--windows`` most
frequent words into windows of ``TSNE_CHECK_WORDS`` = 2,000 (window 0 is
the set ``cluster_tsne`` checks).  For each window, perplexity 30, TF32
off:

* ``f32``: d² as |x|² - 2 x·y + |y|² in float32, then the bisection
  (``plot/tsne._p_from_sq_dists``), as the port formed P before;
* ``shipped``: ``plot/tsne._x2p_dense`` (d² formed in float64);

and for each, ``excess``: max |P_card - P_cpu| / (1e-5 + 1e-4 |P_cpu|),
the rule ``cluster_tsne`` holds the card to (it fails above 1), and
``excess_vs_f64``: the card's P against the CPU's float64 P by the same
rule.  The JSON lines go to standard output and, with ``--out``, to that
file; the last line is the card's name and power limit.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def _excess(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float(((got - want).abs() / (1e-5 + 1e-4 * want.abs())).max())


@chip_smoke._tf32_off
def _windows(torch, table, windows: int) -> list:
    from deeplearning4j_tpu_torch.plot import tsne
    n = chip_smoke.TSNE_CHECK_WORDS
    rows = []
    for w in range(windows):
        xs = table[w * n:(w + 1) * n].contiguous()
        ref = tsne._x2p_dense(xs.cpu().double(), 30.0)
        forms = {
            "f32": lambda x: tsne._p_from_sq_dists(tsne._sq_dists(x), 30.0),
            "shipped": lambda x: tsne._x2p_dense(x, 30.0)}
        row = {"window": w}
        for name, form in forms.items():
            card, cpu = form(xs), form(xs.cpu())
            row[name] = {"excess": _excess(card, cpu),
                         "excess_vs_f64": _excess(card, ref)}
        rows.append(row)
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tsne_p_probe: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--out")
    args = ap.parse_args()
    out = open(args.out, "w") if args.out else None
    for turn in range(args.turns):
        _, w2v, _, _ = chip_smoke.phase_train_word2vec(torch)
        table = w2v.lookup_table.syn0
        line = json.dumps({"turn": turn, "norm_mean": float(
            table[:10_000].norm(dim=1).mean()), "windows": _windows(
                torch, table, args.windows)})
        print(line, flush=True)
        if out:
            print(line, file=out, flush=True)
        del w2v, table
        torch.cuda.empty_cache()
    smi = chip_smoke.nvidia_smi()
    if out:
        print(smi, file=out)
        out.close()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
