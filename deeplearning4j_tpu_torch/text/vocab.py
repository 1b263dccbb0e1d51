"""Vocabulary cache, constructor, and Huffman coding.

Mirrors the reference's word store (ref: models/word2vec/wordstore/
inmemory/AbstractCache.java — label→element map + index table;
VocabConstructor.java — min-frequency filtering + special tokens;
models/sequencevectors/serialization/ + models/word2vec/Huffman.java —
binary Huffman tree whose codes/points drive hierarchical softmax).
"""

from __future__ import annotations

import heapq
import itertools
from typing import Dict, Iterable, List, Optional

from deeplearning4j_tpu_torch.text.sequence import Sequence, SequenceElement, VocabWord


class AbstractCache:
    """In-memory vocab cache (ref: wordstore/inmemory/AbstractCache.java)."""

    def __init__(self):
        self._map: Dict[str, SequenceElement] = {}
        self._index: List[SequenceElement] = []
        self.total_word_count = 0.0

    # -- membership -------------------------------------------------------
    def contains_word(self, label: str) -> bool:
        return label in self._map

    def word_for(self, label: str) -> Optional[SequenceElement]:
        return self._map.get(label)

    has_token = contains_word
    token_for = word_for

    def add_token(self, element: SequenceElement) -> None:
        existing = self._map.get(element.label)
        if existing is not None:
            existing.increment_frequency(element.element_frequency)
            return
        self._map[element.label] = element

    def increment_word_count(self, label: str, by: float = 1.0) -> None:
        el = self._map.get(label)
        if el is not None:
            el.increment_frequency(by)
            self.total_word_count += by

    # -- indexing ---------------------------------------------------------
    def update_words_occurrences(self) -> None:
        self.total_word_count = sum(e.element_frequency for e in self._index)

    def build_index(self) -> None:
        """Assign indices by descending frequency (word2vec convention)."""
        self._index = sorted(self._map.values(),
                             key=lambda e: (-e.element_frequency, e.label))
        for i, el in enumerate(self._index):
            el.index = i
        self.update_words_occurrences()

    def word_at_index(self, index: int) -> Optional[SequenceElement]:
        if 0 <= index < len(self._index):
            return self._index[index]
        return None

    def index_of(self, label: str) -> int:
        el = self._map.get(label)
        return -1 if el is None else el.index

    def word_frequency(self, label: str) -> float:
        el = self._map.get(label)
        return 0.0 if el is None else el.element_frequency

    def num_words(self) -> int:
        return len(self._index) if self._index else len(self._map)

    def words(self) -> List[str]:
        return [e.label for e in (self._index or self._map.values())]

    def vocab_words(self) -> List[SequenceElement]:
        return list(self._index or self._map.values())

    def remove_element(self, label: str) -> None:
        self._map.pop(label, None)

    def __len__(self):
        return self.num_words()


class Huffman:
    """Binary Huffman tree over element frequencies.

    Produces per-element ``codes`` (bits, root→leaf) and ``points``
    (inner-node syn1 rows along the path) — the hierarchical-softmax
    addressing scheme (ref: models/word2vec/Huffman.java, applied by
    VocabConstructor; consumed by SkipGram.iterateSample's
    idxSyn1/codes arrays).
    """

    MAX_CODE_LENGTH = 40

    def __init__(self, elements: Iterable[SequenceElement]):
        self._elements = sorted(elements,
                                key=lambda e: (-e.element_frequency, e.label))

    def build(self) -> None:
        els = self._elements
        n = len(els)
        if n == 0:
            return
        if n == 1:
            els[0].codes = [0]
            els[0].points = [0]
            return
        counter = itertools.count()
        # heap of (freq, tiebreak, node); node = (element | [left, right])
        heap = [(e.element_frequency, next(counter), e) for e in els]
        heapq.heapify(heap)
        inner_id = itertools.count()
        parents: Dict[int, tuple] = {}  # id(node) -> (parent_inner_idx, bit)
        nodes = []
        while len(heap) > 1:
            f1, _, n1 = heapq.heappop(heap)
            f2, _, n2 = heapq.heappop(heap)
            idx = next(inner_id)
            parents[id(n1)] = (idx, 0)
            parents[id(n2)] = (idx, 1)
            merged = [n1, n2]
            nodes.append(merged)
            heapq.heappush(heap, (f1 + f2, next(counter), merged))
        n_inner = len(nodes)
        for el in els:
            codes: List[int] = []
            points: List[int] = []
            node: object = el
            while id(node) in parents:
                inner, bit = parents[id(node)]
                codes.append(bit)
                # syn1 row index: reference numbers inner nodes so the root
                # ends up addressable; we use inner index directly, root =
                # n_inner-1.  Path is stored root→leaf.
                points.append(inner)
                # climb: find the merged list containing node
                node = nodes[inner]
            codes.reverse()
            points.reverse()
            if len(codes) > self.MAX_CODE_LENGTH:
                codes = codes[:self.MAX_CODE_LENGTH]
                points = points[:self.MAX_CODE_LENGTH]
            el.codes = codes
            el.points = points


class VocabConstructor:
    """Builds a vocab cache from sequence sources with min-frequency
    filtering (ref: wordstore/VocabConstructor.java).
    """

    def __init__(self, min_element_frequency: int = 0,
                 build_huffman: bool = True,
                 cache: Optional[AbstractCache] = None):
        self.min_element_frequency = min_element_frequency
        self.build_huffman = build_huffman
        self.cache = cache or AbstractCache()
        self._sources: List[Iterable[Sequence]] = []

    def add_source(self, sequences: Iterable[Sequence]) -> "VocabConstructor":
        self._sources.append(sequences)
        return self

    def build_joint_vocabulary(self) -> AbstractCache:
        cache = self.cache
        for source in self._sources:
            for seq in source:
                for el in seq.elements:
                    if cache.contains_word(el.label):
                        cache.increment_word_count(el.label)
                    else:
                        fresh = type(el)(el.label, el.element_frequency)
                        fresh.special = el.special
                        fresh.is_label = el.is_label
                        cache.add_token(fresh)
                for lbl in seq.labels:
                    if not cache.contains_word(lbl.label):
                        mirror = type(lbl)(lbl.label, 1.0)
                        mirror.special = True
                        mirror.is_label = True
                        cache.add_token(mirror)
        if self.min_element_frequency > 1:
            for label in list(cache._map):
                el = cache._map[label]
                if (el.element_frequency < self.min_element_frequency
                        and not el.special and not el.is_label):
                    cache.remove_element(label)
        cache.build_index()
        if self.build_huffman:
            Huffman(cache.vocab_words()).build()
        return cache
