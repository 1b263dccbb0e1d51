"""Sentence / document iterators.

Mirrors the reference's sentence-iterator SPI (ref: text/sentenceiterator/
SentenceIterator.java, BasicLineIterator.java, CollectionSentenceIterator.java,
FileSentenceIterator.java, LineSentenceIterator.java,
labelaware/LabelAwareListSentenceIterator.java) plus the ``LabelsSource``
used by ParagraphVectors (ref: text/documentiterator/LabelsSource.java).
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, List, Optional


class SentencePreProcessor:
    def pre_process(self, sentence: str) -> str:
        raise NotImplementedError


class _CallablePreProcessor(SentencePreProcessor):
    def __init__(self, fn: Callable[[str], str]):
        self._fn = fn

    def pre_process(self, sentence: str) -> str:
        return self._fn(sentence)


class SentenceIterator:
    """Stream of sentences, resettable (ref: SentenceIterator.java)."""

    def __init__(self, preprocessor: Optional[SentencePreProcessor] = None):
        if callable(preprocessor) and not isinstance(preprocessor, SentencePreProcessor):
            preprocessor = _CallablePreProcessor(preprocessor)
        self._preprocessor = preprocessor

    # -- SPI --------------------------------------------------------------
    def _raw_sentences(self) -> Iterable[str]:
        raise NotImplementedError

    def reset(self) -> None:
        self._iter = None
        self._peeked = None

    # -- driver -----------------------------------------------------------
    _iter = None

    def has_next(self) -> bool:
        if self._iter is None:
            self._iter = iter(self._raw_sentences())
        if getattr(self, "_peeked", None) is not None:
            return True
        try:
            self._peeked = next(self._iter)
            return True
        except StopIteration:
            return False

    def next_sentence(self) -> str:
        if not self.has_next():
            raise StopIteration
        s, self._peeked = self._peeked, None
        if self._preprocessor is not None:
            s = self._preprocessor.pre_process(s)
        return s

    def set_pre_processor(self, pre: SentencePreProcessor) -> None:
        if callable(pre) and not isinstance(pre, SentencePreProcessor):
            pre = _CallablePreProcessor(pre)
        self._preprocessor = pre

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next_sentence()


class CollectionSentenceIterator(SentenceIterator):
    """Over an in-memory collection (ref: CollectionSentenceIterator.java)."""

    def __init__(self, sentences: List[str],
                 preprocessor: Optional[SentencePreProcessor] = None):
        super().__init__(preprocessor)
        self._sentences = list(sentences)

    def _raw_sentences(self):
        return self._sentences


class BasicLineIterator(SentenceIterator):
    """One sentence per line of a file (ref: BasicLineIterator.java)."""

    def __init__(self, path: str,
                 preprocessor: Optional[SentencePreProcessor] = None):
        super().__init__(preprocessor)
        self._path = path

    def _raw_sentences(self):
        with open(self._path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield line


LineSentenceIterator = BasicLineIterator


class FileSentenceIterator(SentenceIterator):
    """Every line of every file under a directory (ref: FileSentenceIterator.java)."""

    def __init__(self, directory: str,
                 preprocessor: Optional[SentencePreProcessor] = None):
        super().__init__(preprocessor)
        self._dir = directory

    def _raw_sentences(self):
        for root, _dirs, files in os.walk(self._dir):
            for name in sorted(files):
                with open(os.path.join(root, name), "r", encoding="utf-8",
                          errors="replace") as f:
                    for line in f:
                        line = line.strip()
                        if line:
                            yield line


class LabelAwareSentenceIterator(SentenceIterator):
    """Sentence iterator that also exposes the current label
    (ref: labelaware/LabelAwareSentenceIterator.java)."""

    def current_label(self) -> str:
        raise NotImplementedError

    def current_labels(self) -> List[str]:
        return [self.current_label()]


class LabelAwareListSentenceIterator(LabelAwareSentenceIterator):
    """Parallel lists of sentences and labels
    (ref: labelaware/LabelAwareListSentenceIterator.java)."""

    def __init__(self, sentences: List[str], labels: List[str],
                 preprocessor: Optional[SentencePreProcessor] = None):
        assert len(sentences) == len(labels)
        super().__init__(preprocessor)
        self._sentences = list(sentences)
        self._labels = list(labels)
        self._idx = -1

    def _raw_sentences(self):
        for i, s in enumerate(self._sentences):
            self._idx = i
            yield s

    def current_label(self) -> str:
        return self._labels[self._idx]

    def reset(self):
        super().reset()
        self._idx = -1


class LabelsSource:
    """Generates/records document labels (ref: documentiterator/LabelsSource.java)."""

    def __init__(self, template: str = "DOC_%d",
                 labels: Optional[List[str]] = None):
        self._template = template
        self._labels: List[str] = list(labels or [])
        self._counter = len(self._labels)
        self._fixed = labels is not None

    def next_label(self) -> str:
        if self._fixed:
            label = self._labels[self._counter % len(self._labels)]
        else:
            label = self._template % self._counter
            self._labels.append(label)
        self._counter += 1
        return label

    def get_labels(self) -> List[str]:
        return list(self._labels)

    def store_label(self, label: str) -> None:
        if label not in self._labels:
            self._labels.append(label)

    def reset(self) -> None:
        self._counter = 0
        if not self._fixed:
            self._labels = []
