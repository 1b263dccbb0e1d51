"""SequenceVectors — the generic embedding trainer.

Mirrors the reference engine (ref: models/sequencevectors/
SequenceVectors.java:51 — fit() at :187: vocab construction, then an
``AsyncSequencer`` producer thread (:996) feeding
``VectorCalculationsThread`` workers (:1101) that queue fused native ops).

The producer thread is kept (host-side ETL overlap), but the N CPU
worker threads collapse into ONE device stream — the host assembles
fixed-shape integer batches of training pairs, copies each flush to the
tables' device in two transfers (its index arrays, its float arrays), and
runs one chunked gather/scatter step on it (see
``deeplearning4j_tpu_torch.embeddings.kernels``).  Learning-rate decay
follows word2vec: linear from ``learning_rate`` down to
``min_learning_rate`` over the expected total word count.  Every random
draw is a numpy ``default_rng`` stream seeded as in the JAX package, so a
whole fit is a function of the seed in both.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, asdict
from typing import Iterable, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.embeddings import kernels
from deeplearning4j_tpu_torch.embeddings.lookup import InMemoryLookupTable
from deeplearning4j_tpu_torch.embeddings.word_vectors import WordVectorsMixin
from deeplearning4j_tpu_torch.native.io import skipgram_pairs
from deeplearning4j_tpu_torch.ops.platform import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.text.sequence import Sequence
from deeplearning4j_tpu_torch.text.vocab import AbstractCache, VocabConstructor


@dataclass
class VectorsConfiguration:
    """Hyperparameters (ref: models/embeddings/loader/VectorsConfiguration.java)."""

    layer_size: int = 100
    window: int = 5
    epochs: int = 1
    iterations: int = 1
    learning_rate: float = 0.025
    min_learning_rate: float = 1e-4
    negative: int = 0
    sampling: float = 0.0
    min_word_frequency: int = 1
    use_hierarchic_softmax: bool = True
    batch_size: int = 2048
    seed: int = 12345
    elements_learning_algorithm: str = "SkipGram"   # or "CBOW"
    sequence_learning_algorithm: str = "DBOW"       # or "DM"
    train_elements: bool = True
    train_sequences: bool = False
    max_labels_per_sequence: int = 1

    def to_json(self) -> dict:
        return asdict(self)


def to_device(device, *arrays):
    """numpy arrays → tensors on ``device`` in two copies: the integer
    arrays packed into one int64 buffer, the rest into one float32
    buffer; each returned tensor is a view of its buffer."""
    ints = [i for i, a in enumerate(arrays) if a.dtype.kind in "iu"]
    out = [None] * len(arrays)
    for picks, dtype in ((ints, np.int64),
                         ([i for i in range(len(arrays)) if i not in ints],
                          np.float32)):
        if not picks:
            continue
        flat = torch.from_numpy(np.concatenate(
            [arrays[i].ravel().astype(dtype, copy=False) for i in picks]))
        views = flat.to(device).split([arrays[i].size for i in picks])
        for i, v in zip(picks, views):
            out[i] = v.view(arrays[i].shape)
    return out


def step_branches(conf: VectorsConfiguration) -> dict:
    """The steps' branches that ``conf`` can reach: HS's code mask is all
    zero without hierarchical softmax, NS's mask without negatives."""
    return {"hs": bool(conf.use_hierarchic_softmax), "ns": conf.negative > 0}


class _BatchBuffer:
    """Accumulates training examples; flushes fixed-shape device batches.

    Static shapes per flush (B pairs × C codes × K negative columns ×
    W window slots), as in the JAX package, whose steps compile once per
    shape.
    """

    def __init__(self, table: InMemoryLookupTable, conf: VectorsConfiguration,
                 points_m: np.ndarray, codes_m: np.ndarray,
                 code_mask_m: np.ndarray, rng: np.random.Generator,
                 window_width: int):
        self.table = table
        self.conf = conf
        self.points_m = points_m      # (V, C) int32
        self.codes_m = codes_m        # (V, C) f32  (1 - code)
        self.code_mask_m = code_mask_m
        self.rng = rng
        self.W = window_width
        self.K = max(int(conf.negative), 0) + 1
        self.sg_ctx: List[int] = []
        self.sg_center: List[int] = []
        self.sg_alpha: List[float] = []
        # bulk intake: whole-sentence pair arrays from the native/numpy
        # windowing path (native.io.skipgram_pairs) — no per-pair Python
        self.sg_chunks: List[tuple] = []
        self._sg_bulk_n = 0
        self.cb_win: List[List[int]] = []
        self.cb_center: List[int] = []
        self.cb_alpha: List[float] = []

    # -- example intake ---------------------------------------------------
    def add_pair(self, ctx: int, center: int, alpha: float):
        self.sg_ctx.append(ctx)
        self.sg_center.append(center)
        self.sg_alpha.append(alpha)
        if len(self.sg_ctx) + self._sg_bulk_n >= self.conf.batch_size:
            self.flush_sg(final=False)

    def add_pairs_bulk(self, ctx: np.ndarray, center: np.ndarray,
                       alpha: float):
        """Whole arrays of (context, center) pairs at one learning rate —
        the sentence-at-a-time fast path."""
        if ctx.size == 0:
            return
        self.sg_chunks.append((ctx, center, float(alpha)))
        self._sg_bulk_n += int(ctx.size)
        if len(self.sg_ctx) + self._sg_bulk_n >= self.conf.batch_size:
            self.flush_sg(final=False)

    def add_window(self, window_rows: List[int], center: int, alpha: float):
        self.cb_win.append(window_rows)
        self.cb_center.append(center)
        self.cb_alpha.append(alpha)
        if len(self.cb_win) >= self.conf.batch_size:
            self.flush_cbow()

    # -- helpers ----------------------------------------------------------
    def _hs_neg_arrays(self, center: np.ndarray, pair_mask: np.ndarray):
        conf = self.conf
        points = self.points_m[center]
        codes = self.codes_m[center]
        cmask = self.code_mask_m[center] * pair_mask[:, None]
        if not conf.use_hierarchic_softmax:
            cmask = np.zeros_like(cmask)
        B = center.shape[0]
        neg_idx = np.zeros((B, self.K), np.int32)
        neg_idx[:, 0] = center
        neg_label = np.zeros((B, self.K), np.float32)
        neg_label[:, 0] = 1.0
        neg_mask = np.zeros((B, self.K), np.float32)
        if conf.negative > 0:
            negs = self.table.sample_negatives(self.rng, (B, self.K - 1))
            neg_idx[:, 1:] = negs
            neg_mask[:, :] = 1.0
            # word2vec skips a sampled negative equal to the target
            neg_mask[:, 1:] = (negs != center[:, None]).astype(np.float32)
        neg_mask *= pair_mask[:, None]
        return points, codes, cmask, neg_idx, neg_label, neg_mask

    # -- flushes ----------------------------------------------------------
    def flush_sg(self, final: bool = True):
        """Launch skip-gram kernel batches.  Auto-flushes (final=False)
        only process FULL batch_size slices and keep the tail buffered —
        a padded partial batch per sentence would double kernel launches
        for nothing; the tail rides along until the next full batch (or
        the end-of-training flush())."""
        total = len(self.sg_ctx) + self._sg_bulk_n
        if total == 0:
            return
        B = self.conf.batch_size
        if not final and total < B:
            return
        parts_ctx, parts_ctr, parts_a = [], [], []
        if self.sg_ctx:
            parts_ctx.append(np.asarray(self.sg_ctx, np.int32))
            parts_ctr.append(np.asarray(self.sg_center, np.int32))
            parts_a.append(np.asarray(self.sg_alpha, np.float32))
        for c, t_, a in self.sg_chunks:
            parts_ctx.append(np.asarray(c, np.int32))
            parts_ctr.append(np.asarray(t_, np.int32))
            parts_a.append(np.asarray(a, np.float32) if np.ndim(a)
                           else np.full(c.size, a, np.float32))
        ctx_all = np.concatenate(parts_ctx)
        ctr_all = np.concatenate(parts_ctr)
        a_all = np.concatenate(parts_a)
        self.sg_ctx, self.sg_center, self.sg_alpha = [], [], []
        self.sg_chunks, self._sg_bulk_n = [], 0

        stop = total if final else (total // B) * B
        t = self.table
        for s in range(0, stop, B):
            n = min(B, stop - s)
            ctx = np.zeros(B, np.int32)
            center = np.zeros(B, np.int32)
            alpha = np.zeros(B, np.float32)
            pair_mask = np.zeros(B, np.float32)
            ctx[:n] = ctx_all[s:s + n]
            center[:n] = ctr_all[s:s + n]
            alpha[:n] = a_all[s:s + n]
            pair_mask[:n] = 1.0
            pts, codes, cmask, nidx, nlab, nmask = self._hs_neg_arrays(
                center, pair_mask)
            t.syn0, t.syn1, t.syn1neg = kernels.skipgram_step(
                t.syn0, t.syn1, t.syn1neg,
                *to_device(t.device, ctx, pts, codes, cmask, nidx, nlab,
                           nmask, alpha), **step_branches(self.conf))
        if stop < total:  # re-buffer the tail (per-pair alphas preserved)
            self.sg_chunks.append((ctx_all[stop:], ctr_all[stop:],
                                   a_all[stop:]))
            self._sg_bulk_n = total - stop

    def flush_cbow(self):
        if not self.cb_win:
            return
        B = self.conf.batch_size
        n = len(self.cb_win)
        win = np.zeros((B, self.W), np.int32)
        wmask = np.zeros((B, self.W), np.float32)
        center = np.zeros(B, np.int32)
        alpha = np.zeros(B, np.float32)
        pair_mask = np.zeros(B, np.float32)
        for i, rows in enumerate(self.cb_win):
            rows = rows[:self.W]
            win[i, :len(rows)] = rows
            wmask[i, :len(rows)] = 1.0
        center[:n] = self.cb_center
        alpha[:n] = self.cb_alpha
        pair_mask[:n] = 1.0
        wmask *= pair_mask[:, None]
        pts, codes, cmask, nidx, nlab, nmask = self._hs_neg_arrays(
            center, pair_mask)
        t = self.table
        t.syn0, t.syn1, t.syn1neg = kernels.cbow_step(
            t.syn0, t.syn1, t.syn1neg,
            *to_device(t.device, win, wmask, pts, codes, cmask, nidx, nlab,
                       nmask, alpha), **step_branches(self.conf))
        self.cb_win, self.cb_center, self.cb_alpha = [], [], []

    def flush(self):
        self.flush_sg()
        self.flush_cbow()


class SequenceVectors(WordVectorsMixin):
    """Generic trainer over ``Sequence`` streams (ref: SequenceVectors.java)."""

    def __init__(self, conf: Optional[VectorsConfiguration] = None,
                 vocab: Optional[AbstractCache] = None,
                 lookup_table: Optional[InMemoryLookupTable] = None,
                 device: DeviceLike = None):
        self.conf = conf or VectorsConfiguration()
        self.vocab = vocab
        self.lookup_table = lookup_table
        self.device = resolve_device(device)
        self._sequence_source: Optional[Iterable[Sequence]] = None

    # -- builder ----------------------------------------------------------
    class Builder:
        _vectors_cls = None  # set below

        def __init__(self, configuration: Optional[VectorsConfiguration] = None):
            self.conf = configuration or VectorsConfiguration()
            self._source: Optional[Iterable[Sequence]] = None
            self._vocab: Optional[AbstractCache] = None
            self._device: DeviceLike = None

        def iterate(self, source: Iterable[Sequence]):
            self._source = source
            return self

        def vocab_cache(self, vocab: AbstractCache):
            self._vocab = vocab
            return self

        def device(self, device: DeviceLike):
            """Where the tables live and the steps run (default CUDA)."""
            self._device = device
            return self

        def layer_size(self, n):           self.conf.layer_size = n; return self
        def window_size(self, n):          self.conf.window = n; return self
        def epochs(self, n):               self.conf.epochs = n; return self
        def iterations(self, n):           self.conf.iterations = n; return self
        def learning_rate(self, lr):       self.conf.learning_rate = lr; return self
        def min_learning_rate(self, lr):   self.conf.min_learning_rate = lr; return self
        def negative_sample(self, k):      self.conf.negative = int(k); return self
        def sampling(self, s):             self.conf.sampling = s; return self
        def min_word_frequency(self, n):   self.conf.min_word_frequency = n; return self
        def use_hierarchic_softmax(self, b): self.conf.use_hierarchic_softmax = b; return self
        def batch_size(self, n):           self.conf.batch_size = n; return self
        def seed(self, n):                 self.conf.seed = n; return self

        def elements_learning_algorithm(self, name: str):
            self.conf.elements_learning_algorithm = name
            return self

        def sequence_learning_algorithm(self, name: str):
            self.conf.sequence_learning_algorithm = name
            return self

        def train_elements_representation(self, b: bool):
            self.conf.train_elements = b
            return self

        def train_sequences_representation(self, b: bool):
            self.conf.train_sequences = b
            return self

        def build(self) -> "SequenceVectors":
            sv = (self._vectors_cls or SequenceVectors)(
                self.conf, device=self._device)
            sv._sequence_source = self._source
            sv.vocab = self._vocab
            return sv

    # -- vocab + tables ----------------------------------------------------
    def build_vocab(self) -> None:
        if self.vocab is None:
            ctor = VocabConstructor(
                min_element_frequency=self.conf.min_word_frequency,
                build_huffman=True)
            ctor.add_source(self._sequence_source)
            self.vocab = ctor.build_joint_vocabulary()
        if self.lookup_table is None:
            self.lookup_table = InMemoryLookupTable(
                self.vocab, self.conf.layer_size, seed=self.conf.seed,
                use_hs=self.conf.use_hierarchic_softmax,
                negative=self.conf.negative, device=self.device)
        # Initialize only if absent — never wipe pretrained/deserialized
        # weights on a refit (reference resetModel(false) semantics).
        self.lookup_table.reset_weights(reset=self.lookup_table.syn0 is None)
        self._cached_code_matrices = None

    _cached_code_matrices = None

    def _code_matrices(self):
        if self._cached_code_matrices is not None:
            return self._cached_code_matrices
        words = self.vocab.vocab_words()
        V = len(words)
        C = max((w.code_length for w in words), default=1) or 1
        points = np.zeros((V, C), np.int32)
        codes = np.zeros((V, C), np.float32)
        mask = np.zeros((V, C), np.float32)
        for w in words:
            L = w.code_length
            points[w.index, :L] = w.points
            # kernel target = 1 - code (sigmoid should output 1 for code 0)
            codes[w.index, :L] = 1.0 - np.asarray(w.codes, np.float32)
            mask[w.index, :L] = 1.0
        self._cached_code_matrices = (points, codes, mask)
        return self._cached_code_matrices

    def _resolved_sequences(self):
        """Resolve raw elements/labels to the vocab's indexed instances.

        Sequence sources typically stream fresh elements with index -1
        (the vocab constructor stores its own copies); training needs the
        indexed instances, so every element is looked up by label and
        unknown/filtered elements are dropped."""
        vocab = self.vocab
        for seq in self._sequence_source:
            out = Sequence()
            for el in seq.elements:
                if el.index >= 0:
                    out.add_element(el)
                else:
                    known = vocab.word_for(el.label)
                    if known is not None:
                        out.add_element(known)
            for lbl in seq.labels:
                if lbl.index >= 0:
                    out.add_sequence_label(lbl)
                else:
                    known = vocab.word_for(lbl.label)
                    if known is not None:
                        out.add_sequence_label(known)
            if out.size() > 0 or out.labels:
                yield out

    # -- training ----------------------------------------------------------
    def fit(self) -> None:
        if self._sequence_source is None:
            raise ValueError("no sequence source set")
        self.build_vocab()
        conf = self.conf
        rng = np.random.default_rng(conf.seed)
        points_m, codes_m, cmask_m = self._code_matrices()
        window_width = 2 * conf.window + conf.max_labels_per_sequence
        buf = _BatchBuffer(self.lookup_table, conf, points_m, codes_m,
                           cmask_m, rng, window_width)

        total_words = max(self.vocab.total_word_count, 1.0)
        expected = total_words * conf.epochs * conf.iterations
        processed = 0.0

        # keep-probability per word index for subsampling
        keep = None
        if conf.sampling > 0:
            freqs = np.array([w.element_frequency
                              for w in self.vocab.vocab_words()])
            ratio = conf.sampling * total_words / np.maximum(freqs, 1.0)
            keep = np.minimum(1.0, np.sqrt(ratio) + ratio)

        for _epoch in range(conf.epochs):
            for seq in self._prefetch(self._resolved_sequences()):
                ids = np.array([e.index for e in seq.elements
                                if e.index >= 0 and not e.is_label],
                               np.int32)
                label_ids = [l.index for l in seq.labels
                             if l.index is not None and l.index >= 0]
                if ids.size == 0:
                    continue
                if keep is not None:
                    ids = ids[rng.random(ids.size) < keep[ids]]
                    if ids.size == 0:
                        continue
                for _it in range(conf.iterations):
                    alpha = max(conf.min_learning_rate,
                                conf.learning_rate *
                                (1.0 - processed / (expected + 1.0)))
                    if conf.train_elements:
                        self._learn_elements(ids, alpha, conf, rng, buf)
                    if conf.train_sequences and label_ids:
                        self._learn_sequence(ids, label_ids, alpha, conf,
                                             rng, buf)
                    processed += float(ids.size)
        buf.flush()

    def _prefetch(self, source, capacity: int = 256):
        """AsyncSequencer parity (ref: SequenceVectors.java:996) — a
        producer thread decouples sequence iteration/tokenization from
        device-batch assembly."""
        q: "queue.Queue" = queue.Queue(maxsize=capacity)
        SENTINEL = object()
        error: list = []

        def produce():
            try:
                for s in source:
                    q.put(s)
            except BaseException as exc:  # re-raised on the consumer side
                error.append(exc)
            finally:
                q.put(SENTINEL)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is SENTINEL:
                break
            yield item
        if error:
            raise error[0]

    def _learn_elements(self, ids, alpha, conf, rng, buf: _BatchBuffer):
        n = ids.size
        algo = conf.elements_learning_algorithm.lower()
        # reduced-window per center, word2vec style
        bs = rng.integers(0, conf.window, size=n)
        if algo == "skipgram":
            # whole-sentence pair generation in native code (numpy
            # fallback) — the per-pair Python loop was the throughput
            # ceiling of the fit() path
            ctx, ctr = skipgram_pairs(ids, conf.window,
                                      bs.astype(np.int32))
            buf.add_pairs_bulk(ctx, ctr, alpha)
        elif algo == "cbow":
            for i in range(n):
                lo = max(0, i - conf.window + bs[i])
                hi = min(n, i + conf.window - bs[i] + 1)
                rows = [int(ids[c]) for c in range(lo, hi) if c != i]
                if rows:
                    buf.add_window(rows, int(ids[i]), alpha)
        else:
            raise ValueError(f"unknown elements algorithm {algo!r}")

    def _learn_sequence(self, ids, label_ids, alpha, conf, rng,
                        buf: _BatchBuffer):
        algo = conf.sequence_learning_algorithm.lower()
        if algo == "dbow":
            # ref: learning/impl/sequence/DBOW.java — label vector predicts
            # every word (skip-gram with the label as the input row).
            lbl_arr = np.asarray(label_ids, np.int32)
            buf.add_pairs_bulk(np.repeat(lbl_arr, ids.size),
                               np.tile(ids.astype(np.int32), lbl_arr.size),
                               alpha)
        elif algo == "dm":
            # ref: learning/impl/sequence/DM.java — CBOW windows with the
            # label vector(s) appended to the context.
            n = ids.size
            bs = rng.integers(0, conf.window, size=n)
            for i in range(n):
                lo = max(0, i - conf.window + bs[i])
                hi = min(n, i + conf.window - bs[i] + 1)
                rows = [int(ids[c]) for c in range(lo, hi) if c != i]
                rows += [int(l) for l in label_ids]
                if rows:
                    buf.add_window(rows, int(ids[i]), alpha)
        else:
            raise ValueError(f"unknown sequence algorithm {algo!r}")


SequenceVectors.Builder._vectors_cls = SequenceVectors
