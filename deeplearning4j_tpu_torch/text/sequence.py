"""Sequence elements — the generic unit the embedding engine trains over.

Mirrors the reference's ``SequenceElement`` / ``VocabWord`` /
``Sequence<T>`` contract (ref: models/sequencevectors/sequence/
SequenceElement.java, Sequence.java; models/word2vec/VocabWord.java):
an element has a label, an element-frequency, a vocab index, and — once
the Huffman tree is built — binary ``codes`` and inner-node ``points``
used by hierarchical softmax.
"""

from __future__ import annotations

from typing import List, Optional, Sequence as TypingSequence


class SequenceElement:
    """A vocabulary element (word, node, document label...)."""

    __slots__ = ("label", "element_frequency", "index", "codes", "points",
                 "special", "is_label")

    def __init__(self, label: str, frequency: float = 1.0,
                 special: bool = False, is_label: bool = False):
        self.label = label
        self.element_frequency = float(frequency)
        self.index = -1
        self.codes: List[int] = []
        self.points: List[int] = []
        self.special = special
        # PV labels (document ids) are excluded from context windows.
        self.is_label = is_label

    def increment_frequency(self, by: float = 1.0) -> None:
        self.element_frequency += by

    @property
    def code_length(self) -> int:
        return len(self.codes)

    def __repr__(self):
        return (f"{type(self).__name__}({self.label!r}, "
                f"freq={self.element_frequency}, idx={self.index})")

    def __eq__(self, other):
        return isinstance(other, SequenceElement) and other.label == self.label

    def __hash__(self):
        return hash(self.label)


class VocabWord(SequenceElement):
    """A word element (ref: models/word2vec/VocabWord.java)."""


class Sequence:
    """An ordered run of elements, optionally tagged with labels.

    Ref: models/sequencevectors/sequence/Sequence.java — labels are how
    ParagraphVectors attaches document ids to word runs.
    """

    __slots__ = ("elements", "labels")

    def __init__(self, elements: Optional[TypingSequence[SequenceElement]] = None):
        self.elements: List[SequenceElement] = list(elements or [])
        self.labels: List[SequenceElement] = []

    def add_element(self, element: SequenceElement) -> None:
        self.elements.append(element)

    def add_sequence_label(self, label: SequenceElement) -> None:
        label.is_label = True
        self.labels.append(label)

    def set_sequence_label(self, label: SequenceElement) -> None:
        label.is_label = True
        self.labels = [label]

    @property
    def sequence_label(self) -> Optional[SequenceElement]:
        return self.labels[0] if self.labels else None

    def size(self) -> int:
        return len(self.elements)

    def __len__(self):
        return len(self.elements)

    def __iter__(self):
        return iter(self.elements)
