"""WordVectors query API — nearest words, similarity, arithmetic.

Mirrors the reference's ``WordVectors`` interface + ``BasicModelUtils``
(ref: models/embeddings/wordvectors/WordVectorsImpl.java,
models/embeddings/reader/impl/BasicModelUtils.java — cosine similarity
over mean-of-positive-minus-negative query vectors).  Queries run as one
numpy matmul over the normalized table, copied from the device once per
query, so results equal the JAX package's.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class WordVectorsMixin:
    """Query surface over (vocab, lookup_table)."""

    vocab = None
    lookup_table = None

    # -- basics ------------------------------------------------------------
    def has_word(self, word: str) -> bool:
        return self.vocab is not None and self.vocab.contains_word(word)

    def word_vector(self, word: str) -> Optional[np.ndarray]:
        return self.lookup_table.vector(word)

    getWordVectorMatrix = word_vector

    def vocab_size(self) -> int:
        return self.vocab.num_words()

    def _table(self) -> np.ndarray:
        return self.lookup_table.get_weights().astype(np.float32, copy=False)

    def _normed_table(self) -> np.ndarray:
        t = self._table()
        norms = np.linalg.norm(t, axis=1, keepdims=True)
        return t / np.maximum(norms, 1e-12)

    # -- similarity --------------------------------------------------------
    def similarity(self, w1: str, w2: str) -> float:
        v1, v2 = self.word_vector(w1), self.word_vector(w2)
        if v1 is None or v2 is None:
            return float("nan")
        denom = (np.linalg.norm(v1) * np.linalg.norm(v2))
        if denom == 0:
            return 0.0
        return float(np.dot(v1, v2) / denom)

    def words_nearest(self, positive, negative=(), top: int = 10) -> List[str]:
        """Analogy query: nearest to mean(positive) - mean(negative)."""
        if isinstance(positive, str):
            positive = [positive]
        query = np.zeros(self.lookup_table.vector_length, np.float32)
        exclude = set()
        for w in positive:
            v = self.word_vector(w)
            if v is not None:
                query += v / max(np.linalg.norm(v), 1e-12)
                exclude.add(w)
        for w in negative:
            v = self.word_vector(w)
            if v is not None:
                query -= v / max(np.linalg.norm(v), 1e-12)
                exclude.add(w)
        qn = np.linalg.norm(query)
        if qn == 0:
            return []
        sims = self._normed_table() @ (query / qn)
        order = np.argsort(-sims)
        out: List[str] = []
        for idx in order:
            w = self.vocab.word_at_index(int(idx))
            if w is None or w.label in exclude:
                continue
            out.append(w.label)
            if len(out) >= top:
                break
        return out

    wordsNearest = words_nearest

    def words_nearest_vector(self, vector: np.ndarray, top: int = 10) -> List[str]:
        v = np.asarray(vector, np.float32)
        v = v / max(np.linalg.norm(v), 1e-12)
        sims = self._normed_table() @ v
        order = np.argsort(-sims)[:top]
        return [self.vocab.word_at_index(int(i)).label for i in order]

    def similar_words_in_vocab_to(self, word: str, accuracy: float) -> List[str]:
        v = self.word_vector(word)
        if v is None:
            return []
        sims = self._normed_table() @ (v / max(np.linalg.norm(v), 1e-12))
        return [self.vocab.word_at_index(int(i)).label
                for i in np.nonzero(sims >= accuracy)[0]
                if self.vocab.word_at_index(int(i)).label != word]
