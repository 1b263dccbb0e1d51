"""GloVe — co-occurrence weighted least squares with AdaGrad.

Mirrors the reference (ref: models/glove/Glove.java:1-429 +
glove/count/* co-occurrence accumulation; GloVe objective
f(X_ij)·(w_i·w̃_j + b_i + b̃_j − log X_ij)² with per-weight AdaGrad).
The co-occurrence map is built on the host, then shuffled into
fixed-size (i, j, X_ij) batches; one step of plain torch ops per batch
does gather → residual → AdaGrad scatter-add on both vector tables, in
place, on the tables' device (CUDA unless the caller passes
``device="cpu"``).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.embeddings.lookup import InMemoryLookupTable
from deeplearning4j_tpu_torch.embeddings.sequencevectors import (
    VectorsConfiguration, to_device)
from deeplearning4j_tpu_torch.embeddings.word_vectors import WordVectorsMixin
from deeplearning4j_tpu_torch.ops.platform import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.text.sequence import Sequence, VocabWord
from deeplearning4j_tpu_torch.text.sentence_iterators import SentenceIterator
from deeplearning4j_tpu_torch.text.tokenization import (
    DefaultTokenizerFactory, TokenizerFactory)
from deeplearning4j_tpu_torch.text.vocab import VocabConstructor


def _glove_step(w, wt, b, bt, hw, hwt, hb, hbt,
                rows, cols, logx, fx, lr, valid):
    """AdaGrad step on a batch of co-occurrence cells; the eight tables
    are updated in place, every update computed from the rows gathered
    before it.

    w/wt: (V,D) main/context vectors; b/bt: (V,) biases;
    h*: AdaGrad accumulators.  Returns the batch's loss, a 0-d tensor.
    """
    wi = w.index_select(0, rows)          # (B, D)
    wj = wt.index_select(0, cols)
    diff = ((wi * wj).sum(1) + b.index_select(0, rows)
            + bt.index_select(0, cols) - logx)
    fdiff = fx * diff * valid             # (B,)

    gw = fdiff[:, None] * wj
    gwt = fdiff[:, None] * wi
    gb = fdiff
    # AdaGrad: accumulate squared grads, scale update
    hw_new = hw.index_select(0, rows) + gw * gw
    hwt_new = hwt.index_select(0, cols) + gwt * gwt
    hb_new = hb.index_select(0, rows) + gb * gb
    hbt_new = hbt.index_select(0, cols) + gb * gb

    w.index_add_(0, rows, -lr * gw / torch.sqrt(hw_new + 1e-8))
    wt.index_add_(0, cols, -lr * gwt / torch.sqrt(hwt_new + 1e-8))
    b.index_add_(0, rows, -lr * gb / torch.sqrt(hb_new + 1e-8))
    bt.index_add_(0, cols, -lr * gb / torch.sqrt(hbt_new + 1e-8))
    hw.index_add_(0, rows, gw * gw)
    hwt.index_add_(0, cols, gwt * gwt)
    hb.index_add_(0, rows, gb * gb)
    hbt.index_add_(0, cols, gb * gb)
    return 0.5 * torch.sum(fdiff * diff)


class Glove(WordVectorsMixin):

    def __init__(self, conf: Optional[VectorsConfiguration] = None,
                 x_max: float = 100.0, alpha: float = 0.75,
                 symmetric: bool = True, shuffle: bool = True,
                 device: DeviceLike = None):
        self.conf = conf or VectorsConfiguration(learning_rate=0.05)
        self.device = resolve_device(device)
        self.x_max = x_max
        self.alpha = alpha
        self.symmetric = symmetric
        self.shuffle = shuffle
        self.vocab = None
        self.lookup_table: Optional[InMemoryLookupTable] = None
        self._sentences: Optional[SentenceIterator] = None
        self._tf: TokenizerFactory = DefaultTokenizerFactory()

    class Builder:
        def __init__(self):
            self.conf = VectorsConfiguration(learning_rate=0.05)
            self._x_max = 100.0
            self._alpha = 0.75
            self._symmetric = True
            self._shuffle = True
            self._sentences = None
            self._tf = DefaultTokenizerFactory()
            self._device: DeviceLike = None

        def iterate(self, s):              self._sentences = s; return self
        def tokenizer_factory(self, tf):   self._tf = tf; return self
        def layer_size(self, n):           self.conf.layer_size = n; return self
        def learning_rate(self, lr):       self.conf.learning_rate = lr; return self
        def epochs(self, n):               self.conf.epochs = n; return self
        def window_size(self, n):          self.conf.window = n; return self
        def min_word_frequency(self, n):   self.conf.min_word_frequency = n; return self
        def batch_size(self, n):           self.conf.batch_size = n; return self
        def seed(self, n):                 self.conf.seed = n; return self
        def x_max(self, x):                self._x_max = x; return self
        def alpha(self, a):                self._alpha = a; return self
        def symmetric(self, b):            self._symmetric = b; return self
        def shuffle(self, b):              self._shuffle = b; return self
        def device(self, d):               self._device = d; return self

        def build(self) -> "Glove":
            g = Glove(self.conf, self._x_max, self._alpha, self._symmetric,
                      self._shuffle, device=self._device)
            g._sentences = self._sentences
            g._tf = self._tf
            return g

    # -- pipeline ----------------------------------------------------------
    def _token_stream(self):
        self._sentences.reset()
        for sentence in self._sentences:
            yield [t for t in self._tf.create(sentence).get_tokens() if t]

    def _build_vocab(self):
        def seqs():
            for toks in self._token_stream():
                s = Sequence()
                for t in toks:
                    s.add_element(VocabWord(t))
                yield s
        ctor = VocabConstructor(self.conf.min_word_frequency,
                                build_huffman=False)
        ctor.add_source(seqs())
        self.vocab = ctor.build_joint_vocabulary()
        self.lookup_table = InMemoryLookupTable(
            self.vocab, self.conf.layer_size, seed=self.conf.seed,
            use_hs=False, negative=0, device=self.device)
        self.lookup_table.reset_weights()

    def _cooccurrences(self) -> Dict[Tuple[int, int], float]:
        """Distance-weighted counts (ref: glove/count/* — 1/d weighting)."""
        co: Dict[Tuple[int, int], float] = defaultdict(float)
        win = self.conf.window
        for toks in self._token_stream():
            ids = [self.vocab.index_of(t) for t in toks]
            ids = [i for i in ids if i >= 0]
            for i, wi in enumerate(ids):
                for off in range(1, win + 1):
                    j = i + off
                    if j >= len(ids):
                        break
                    inc = 1.0 / off
                    co[(wi, ids[j])] += inc
                    if self.symmetric:
                        co[(ids[j], wi)] += inc
        return co

    def fit(self) -> float:
        if self._sentences is None:
            raise ValueError("no sentence iterator set")
        self._build_vocab()
        co = self._cooccurrences()
        if not co:
            return 0.0
        entries = np.array([(i, j, x) for (i, j), x in co.items()],
                           np.float64)
        rows_all = entries[:, 0].astype(np.int32)
        cols_all = entries[:, 1].astype(np.int32)
        xs_all = entries[:, 2].astype(np.float32)

        V, D = self.vocab.num_words(), self.conf.layer_size
        rng = np.random.default_rng(self.conf.seed)
        dev = self.device
        w = self.lookup_table.syn0
        wt = torch.from_numpy(
            (rng.random((V, D), dtype=np.float32) - 0.5) / D).to(dev)
        b = torch.zeros((V,), dtype=torch.float32, device=dev)
        bt = torch.zeros((V,), dtype=torch.float32, device=dev)
        hw = torch.full((V, D), 1e-8, dtype=torch.float32, device=dev)
        hwt = torch.full((V, D), 1e-8, dtype=torch.float32, device=dev)
        hb = torch.full((V,), 1e-8, dtype=torch.float32, device=dev)
        hbt = torch.full((V,), 1e-8, dtype=torch.float32, device=dev)

        B = min(self.conf.batch_size, max(len(xs_all), 1))
        lr = float(np.float32(self.conf.learning_rate))
        last_loss = 0.0
        for _epoch in range(self.conf.epochs):
            order = (rng.permutation(len(xs_all)) if self.shuffle
                     else np.arange(len(xs_all)))
            total, count = 0.0, 0
            for start in range(0, len(order), B):
                sel = order[start:start + B]
                n = len(sel)
                r = np.zeros(B, np.int32)
                c = np.zeros(B, np.int32)
                x = np.ones(B, np.float32)
                valid = np.zeros(B, np.float32)
                r[:n], c[:n], x[:n] = rows_all[sel], cols_all[sel], xs_all[sel]
                valid[:n] = 1.0
                fx = np.minimum((x / self.x_max) ** self.alpha, 1.0)
                rows, cols, logx, fxs, valids = to_device(
                    dev, r, c, np.log(x), fx.astype(np.float32), valid)
                loss = _glove_step(w, wt, b, bt, hw, hwt, hb, hbt,
                                   rows, cols, logx, fxs, lr, valids)
                # the host sum in float64, one read of the device per batch
                total += float(loss)
                count += n
            last_loss = total / max(count, 1)
        # final embedding = w + wt (GloVe convention)
        self.lookup_table.syn0 = w + wt
        return last_loss
