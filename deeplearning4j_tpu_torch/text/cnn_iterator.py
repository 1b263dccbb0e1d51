"""CNN-for-NLP sentence iterator — the port of
``deeplearning4j_tpu/text/cnn_iterator.py``.

Mirrors the reference's ``CnnSentenceDataSetIterator`` (ref:
deeplearning4j-nlp/.../iterator/CnnSentenceDataSetIterator.java +
LabeledSentenceProvider.java) — sentences become zero-padded word-vector
tensors of shape (batch, 1, max_len, vector_size), or (batch, 1,
vector_size, max_len) with ``sentences_along_height=False``, with a
[batch, max_len] features mask and one-hot labels.

Where the JAX iterator copies each token's vector on the host, this one
resolves the tokens to vocabulary indices on the host and builds the
batch's features with one index gather from ``syn0`` where the table
lives (the card, for a table the port trained there): the features are a
tensor on that device; mask and labels are host arrays.  The values are
those of the per-token copies.
"""

from __future__ import annotations

import random
from typing import List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator
from deeplearning4j_tpu_torch.text.tokenization import (
    DefaultTokenizerFactory, TokenizerFactory)


class CollectionLabeledSentenceProvider:
    """In-memory (sentence, label) source (ref: iterator/provider/
    CollectionLabeledSentenceProvider.java)."""

    def __init__(self, sentences: List[str], labels: List[str],
                 seed: Optional[int] = None):
        assert len(sentences) == len(labels)
        self._data = list(zip(sentences, labels))
        self._labels = sorted(set(labels))
        self._rng = random.Random(seed)
        if seed is not None:
            self._rng.shuffle(self._data)
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._data)

    def next_sentence(self) -> Tuple[str, str]:
        item = self._data[self._pos]
        self._pos += 1
        return item

    def reset(self):
        self._pos = 0

    def all_labels(self) -> List[str]:
        return list(self._labels)

    def total_num_sentences(self) -> int:
        return len(self._data)


class CnnSentenceDataSetIterator(DataSetIterator):

    def __init__(self, sentence_provider, word_vectors, batch_size: int = 32,
                 max_sentence_length: int = 64,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 sentences_along_height: bool = True):
        self.provider = sentence_provider
        self.word_vectors = word_vectors
        self.batch_size = batch_size
        self.max_len = max_sentence_length
        self.tf = tokenizer_factory or DefaultTokenizerFactory()
        self.sentences_along_height = sentences_along_height
        self.labels = sentence_provider.all_labels()
        self.vector_size = word_vectors.lookup_table.vector_length

    def has_next(self) -> bool:
        return self.provider.has_next()

    def next(self, num: Optional[int] = None) -> DataSet:
        num = num or self.batch_size
        sents, labels = [], []
        while self.provider.has_next() and len(sents) < num:
            s, l = self.provider.next_sentence()
            sents.append(s)
            labels.append(l)
        B, L = len(sents), self.max_len
        vocab = self.word_vectors.vocab
        idx = np.zeros((B, L), np.int64)
        fmask = np.zeros((B, L), np.float32)
        ys = np.zeros((B, len(self.labels)), np.float32)
        for b, (s, l) in enumerate(zip(sents, labels)):
            toks = [t for t in self.tf.create(s).get_tokens()
                    if self.word_vectors.has_word(t)][:L]
            idx[b, :len(toks)] = [vocab.index_of(t) for t in toks]
            fmask[b, :len(toks)] = 1.0
            ys[b, self.labels.index(l)] = 1.0
        syn0 = self.word_vectors.lookup_table.syn0
        rows = torch.from_numpy(idx).to(syn0.device, non_blocking=True)
        keep = torch.from_numpy(fmask).to(syn0.device, non_blocking=True)
        # one gather; padded positions are exact zeros, as the host copies
        feats = torch.where(keep[..., None] > 0, syn0[rows], 0.0)
        feats = feats.to(torch.float32)[:, None]          # [B, 1, L, D]
        if not self.sentences_along_height:
            feats = feats.transpose(2, 3).contiguous()    # [B, 1, D, L]
        return DataSet(feats, ys, features_mask=fmask)

    def reset(self):
        self.provider.reset()

    def total_examples(self) -> int:
        return self.provider.total_num_sentences()

    def get_labels(self) -> List[str]:
        return list(self.labels)
