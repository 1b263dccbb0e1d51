#!/usr/bin/env python3
"""Where a Word2Vec fit's host time goes, on one GPU.

    python3 tools/w2v_probe.py [--turns 4] [--out FILE]

``train_word2vec``'s fit (``chip_smoke.py``: V = 71,290, layer 128,
bench.py's protocol, the seeded 1,000,000-token corpus) through
``Word2Vec.Builder()...build().fit()``, in turns (threaded, sync, sync,
threaded, ...):

* ``threaded``: as shipped, ``fit`` reads its sequences through
  ``_prefetch``'s producer thread (tokenizing and resolving each sentence
  against the vocabulary);
* ``sync``: the same fit with ``_prefetch`` replaced by the plain
  iterator, so the main thread tokenizes and resolves too.

Per variant and turn: ``fit_s``, words/s, and the main thread's wall time
inside the flushes' step calls (``step_s``: the launches' enqueue),
inside the rest of the flushes (``flush_host_s``: batch assembly and
negative sampling in numpy, the two copies) and inside pair generation
(``pairs_s``); the rest of ``fit_s`` is the main thread waiting on the
producer and the Python of the training loop.  Then ``resolve_s``: one
pass of the producer's work alone (``_resolved_sequences``), with no
training.  The JSON lines go to standard output and, with ``--out``, to
that file; the last line is the card's name and power limit.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def _fit(torch, sents, vocab, threaded: bool) -> dict:
    from deeplearning4j_tpu_torch.embeddings import (
        Word2Vec, kernels, sequencevectors)
    from deeplearning4j_tpu_torch.text import CollectionSentenceIterator
    w2v = (Word2Vec.Builder().iterate(CollectionSentenceIterator(sents))
           .layer_size(chip_smoke.W2V_LAYER)
           .window_size(chip_smoke.W2V_WINDOW)
           .negative_sample(chip_smoke.W2V_NEGATIVE)
           .use_hierarchic_softmax(False).min_word_frequency(1).epochs(1)
           .batch_size(chip_smoke.W2V_BATCH).seed(7).vocab_cache(vocab)
           .device("cuda").build())
    w2v.build_vocab()
    spent = {"step_s": 0.0, "flush_s": 0.0, "pairs_s": 0.0}
    patched = []

    def timed(owner, name, key):
        fn = getattr(owner, name)

        def wrapper(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[key] += time.perf_counter() - t
        setattr(owner, name, wrapper)
        patched.append((owner, name, fn))

    timed(kernels, "skipgram_step", "step_s")
    timed(sequencevectors._BatchBuffer, "flush_sg", "flush_s")
    timed(sequencevectors, "skipgram_pairs", "pairs_s")
    if not threaded:
        patched.append((w2v, "_prefetch", None))
        w2v._prefetch = lambda source, capacity=256: source
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w2v.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    finally:
        for owner, name, fn in reversed(patched):
            if fn is None:
                delattr(owner, name)
            else:
                setattr(owner, name, fn)
    return {"variant": "threaded" if threaded else "sync", "fit_s": fit_s,
            "words_per_s": chip_smoke.W2V_TOKENS / fit_s,
            "step_s": spent["step_s"],
            "flush_host_s": spent["flush_s"] - spent["step_s"],
            "pairs_s": spent["pairs_s"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("w2v_probe: no CUDA device", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.embeddings import Word2Vec
    from deeplearning4j_tpu_torch.text import CollectionSentenceIterator
    out = open(args.out, "w") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    sents, _ = chip_smoke.text8_scale_corpus(chip_smoke.SEED)
    first = (Word2Vec.Builder().iterate(CollectionSentenceIterator(sents))
             .min_word_frequency(1).device("cuda").build())
    first.build_vocab()
    vocab = first.vocab
    for turn in range(args.turns):
        threaded = turn % 4 in (0, 3)
        emit({"turn": turn, **_fit(torch, sents, vocab, threaded)})
    t0 = time.perf_counter()
    n = sum(1 for _ in first._resolved_sequences())
    emit({"resolve_s": time.perf_counter() - t0, "sequences": n})
    smi = chip_smoke.nvidia_smi()
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
