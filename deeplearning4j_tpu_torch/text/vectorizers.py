"""Bag-of-words / TF-IDF vectorizers and inverted index.

Mirrors the reference (ref: bagofwords/vectorizer/
BagOfWordsVectorizer.java, TfidfVectorizer.java — RecordReader/iterator →
fixed-width count or tf-idf vectors over a built vocab;
text/invertedindex/InvertedIndex.java).
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.text.sentence_iterators import (
    LabelAwareSentenceIterator, SentenceIterator)
from deeplearning4j_tpu_torch.text.tokenization import (
    DefaultTokenizerFactory, TokenizerFactory)
from deeplearning4j_tpu_torch.text.vocab import AbstractCache
from deeplearning4j_tpu_torch.text.sequence import VocabWord


class InvertedIndex:
    """token → list of (doc id, positions) (ref: text/invertedindex/)."""

    def __init__(self):
        self._postings: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        self._num_docs = 0

    def add_doc(self, tokens: List[str]) -> int:
        doc_id = self._num_docs
        self._num_docs += 1
        for pos, tok in enumerate(tokens):
            self._postings[tok].append((doc_id, pos))
        return doc_id

    def documents(self, token: str) -> List[int]:
        return sorted({d for d, _ in self._postings.get(token, [])})

    def doc_frequency(self, token: str) -> int:
        return len(self.documents(token))

    @property
    def num_documents(self) -> int:
        return self._num_docs


class BaseTextVectorizer:

    def __init__(self, iterator: SentenceIterator,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 min_word_frequency: int = 1,
                 stop_words: Optional[set] = None,
                 labels: Optional[List[str]] = None):
        self.iterator = iterator
        self.tf = tokenizer_factory or DefaultTokenizerFactory()
        self.min_word_frequency = min_word_frequency
        self.stop_words = stop_words or set()
        self.vocab = AbstractCache()
        self.index = InvertedIndex()
        self.labels = labels or []
        self._doc_tokens: List[List[str]] = []
        self._doc_labels: List[str] = []

    def _tokens(self, sentence: str) -> List[str]:
        return [t for t in self.tf.create(sentence).get_tokens()
                if t and t not in self.stop_words]

    def fit(self) -> None:
        label_aware = isinstance(self.iterator, LabelAwareSentenceIterator)
        self.iterator.reset()
        while self.iterator.has_next():
            sentence = self.iterator.next_sentence()
            toks = self._tokens(sentence)
            self._doc_tokens.append(toks)
            if label_aware:
                lbl = self.iterator.current_label()
                self._doc_labels.append(lbl)
                if lbl not in self.labels:
                    self.labels.append(lbl)
            self.index.add_doc(toks)
            for t in toks:
                if self.vocab.contains_word(t):
                    self.vocab.increment_word_count(t)
                else:
                    self.vocab.add_token(VocabWord(t))
        if self.min_word_frequency > 1:
            for label in list(self.vocab._map):
                if (self.vocab._map[label].element_frequency
                        < self.min_word_frequency):
                    self.vocab.remove_element(label)
        self.vocab.build_index()

    # -- SPI ---------------------------------------------------------------
    def _weight(self, token: str, doc_counts: Counter, doc_len: int) -> float:
        raise NotImplementedError

    def transform(self, text_or_tokens) -> np.ndarray:
        if isinstance(text_or_tokens, str):
            toks = self._tokens(text_or_tokens)
        else:
            toks = list(text_or_tokens)
        counts = Counter(toks)
        vec = np.zeros(self.vocab.num_words(), np.float32)
        for tok, _n in counts.items():
            idx = self.vocab.index_of(tok)
            if idx >= 0:
                vec[idx] = self._weight(tok, counts, len(toks))
        return vec

    def vectorize(self, text, label: str) -> DataSet:
        features = self.transform(text)[None, :]
        n_labels = max(len(self.labels), 1)
        y = np.zeros((1, n_labels), np.float32)
        if label in self.labels:
            y[0, self.labels.index(label)] = 1.0
        return DataSet(features, y)

    def fit_transform_all(self) -> DataSet:
        xs = np.stack([self.transform(toks) for toks in self._doc_tokens])
        n_labels = max(len(self.labels), 1)
        ys = np.zeros((len(self._doc_tokens), n_labels), np.float32)
        for i, lbl in enumerate(self._doc_labels):
            ys[i, self.labels.index(lbl)] = 1.0
        return DataSet(xs, ys)


class BagOfWordsVectorizer(BaseTextVectorizer):
    """Raw term counts (ref: bagofwords/vectorizer/BagOfWordsVectorizer.java)."""

    def _weight(self, token, doc_counts, doc_len):
        return float(doc_counts[token])


class TfidfVectorizer(BaseTextVectorizer):
    """tf·idf weights (ref: bagofwords/vectorizer/TfidfVectorizer.java)."""

    def _weight(self, token, doc_counts, doc_len):
        tf = doc_counts[token] / max(doc_len, 1)
        df = max(self.index.doc_frequency(token), 1)
        idf = math.log((1 + self.index.num_documents) / (1 + df)) + 1.0
        return float(tf * idf)
