"""Inverted index over tokenized documents
(ref: deeplearning4j-nlp/.../text/invertedindex/InvertedIndex.java:35 —
addWordsToDoc/document/documents/docs/batchIter/sample surface; the
reference's LuceneInvertedIndex role, stdlib edition)."""

from __future__ import annotations

import random
import threading
from typing import Dict, Iterable, Iterator, List, Optional


class InMemoryInvertedIndex:
    """word-index → doc-ids; doc-id → token list.  Thread-safe adds
    (the reference indexes from multiple vectorizer threads)."""

    def __init__(self, vocab=None, sample: float = 0.0, seed: int = 0):
        self.vocab = vocab
        self._sample = sample
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._docs: Dict[int, List[str]] = {}
        self._postings: Dict[str, List[int]] = {}
        self._posting_sets: Dict[str, set] = {}
        self._next_doc = 0

    # -- write side (ref: addWordsToDoc / addWordToDoc) ---------------------
    def add_words_to_doc(self, doc_id: Optional[int],
                         words: Iterable[str]) -> int:
        words = list(words)
        with self._lock:
            if doc_id is None:
                doc_id = self._next_doc
            self._next_doc = max(self._next_doc, doc_id + 1)
            self._docs.setdefault(doc_id, []).extend(words)
            for w in words:
                seen = self._posting_sets.setdefault(w, set())
                if doc_id not in seen:  # dedup even under interleaved adds
                    seen.add(doc_id)
                    self._postings.setdefault(w, []).append(doc_id)
        return doc_id

    # -- read side ----------------------------------------------------------
    def document(self, doc_id: int) -> List[str]:
        return list(self._docs.get(doc_id, []))

    def documents(self, word: str) -> List[int]:
        """Doc ids containing the word (ref: documents(T))."""
        return list(self._postings.get(word, []))

    def num_documents(self) -> int:
        return len(self._docs)

    def total_words(self) -> int:
        return sum(len(d) for d in self._docs.values())

    def docs(self) -> Iterator[List[str]]:
        """(ref: docs() — iterate documents)"""
        for i in sorted(self._docs):
            yield list(self._docs[i])

    def batch_iter(self, batch_size: int) -> Iterator[List[List[str]]]:
        """(ref: batchIter(int))"""
        batch: List[List[str]] = []
        for doc in self.docs():
            batch.append(doc)
            if len(batch) == batch_size:
                yield batch
                batch = []
        if batch:
            yield batch

    def sample(self) -> float:
        return self._sample

    def eachDocWithLabels(self):  # pragma: no cover - compat shim
        raise NotImplementedError("label-aware indexing via documents()")
