"""DeepWalk (ref: models/deepwalk/DeepWalk.java — random walks +
hierarchical-softmax skip-gram over vertex ids; Huffman coding by vertex
degree ref: models/deepwalk/GraphHuffman.java; lookup table ref:
InMemoryGraphLookupTable.java).

Here the HS skip-gram training reuses the SequenceVectors engine's
device steps — walks become ``Sequence``s of vertex-id elements; the
vocabulary's Huffman tree is built from walk occurrence counts, which
are proportional to vertex degree (the stationary distribution of a
random walk), matching the reference's degree-based coding in
expectation.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.embeddings.sequencevectors import (
    SequenceVectors, VectorsConfiguration)
from deeplearning4j_tpu_torch.graph.graph import Graph
from deeplearning4j_tpu_torch.graph.walkers import RandomWalkIterator
from deeplearning4j_tpu_torch.ops.platform import DeviceLike
from deeplearning4j_tpu_torch.text.sequence import Sequence, SequenceElement
from deeplearning4j_tpu_torch.text.vocab import Huffman


class GraphHuffman:
    """Huffman codes/points keyed by vertex index, built from vertex
    degrees (ref: models/deepwalk/GraphHuffman.java)."""

    def __init__(self, graph: Graph):
        elements = [SequenceElement(str(i), frequency=max(1, int(d)))
                    for i, d in enumerate(graph.degrees())]
        for i, e in enumerate(elements):
            e.index = i
        Huffman(elements).build()
        self._elements = elements

    def get_code(self, vertex: int) -> List[int]:
        return self._elements[vertex].codes

    def get_path_inner_nodes(self, vertex: int) -> List[int]:
        return self._elements[vertex].points

    def get_code_length(self, vertex: int) -> int:
        return len(self._elements[vertex].codes)


class _WalkSequenceSource:
    """Re-iterable walks→Sequence adapter."""

    def __init__(self, walker_factory):
        self.walker_factory = walker_factory

    def __iter__(self):
        for walk in self.walker_factory():
            seq = Sequence()
            for v in walk:
                seq.add_element(SequenceElement(str(v)))
            yield seq


class DeepWalk(SequenceVectors):
    """(ref: models/deepwalk/DeepWalk.java — Builder.vectorSize/windowSize/
    learningRate; fit(IGraph, walkLength) / fit(GraphWalkIterator))."""

    class Builder(SequenceVectors.Builder):
        def __init__(self, configuration: Optional[VectorsConfiguration] = None):
            super().__init__(configuration)
            self.conf.use_hierarchic_softmax = True
            self.conf.negative = 0
            self.conf.min_word_frequency = 1
            self._walks_per_vertex = 1

        def vector_size(self, n: int):
            self.conf.layer_size = n
            return self

        def walks_per_vertex(self, n: int):
            self._walks_per_vertex = n
            return self

        def build(self) -> "DeepWalk":
            dw = DeepWalk(self.conf, device=self._device)
            dw.vocab = self._vocab
            dw._sequence_source = self._source
            dw._walks_per_vertex = self._walks_per_vertex
            return dw

    def __init__(self, conf: Optional[VectorsConfiguration] = None,
                 device: DeviceLike = None):
        super().__init__(conf, device=device)
        self._walks_per_vertex = 1
        self.graph: Optional[Graph] = None

    # ---- reference fit() surface ----
    def fit_graph(self, graph: Graph, walk_length: int = 40,
                  seed: int = 0) -> "DeepWalk":
        """fit(IGraph, walkLength) (ref: DeepWalk.fit:80)."""
        def factory():
            for ep in range(self._walks_per_vertex):
                yield from RandomWalkIterator(graph, walk_length,
                                              seed=seed + ep)
        return self.fit_walker(factory, graph)

    def fit_walker(self, walker_or_factory, graph: Optional[Graph] = None
                   ) -> "DeepWalk":
        """fit(GraphWalkIterator) (ref: DeepWalk.fit:104).  Accepts a
        walker instance (re-iterated per epoch) or a zero-arg factory."""
        if callable(walker_or_factory):
            factory = walker_or_factory
        else:
            def factory():
                return iter(walker_or_factory)
        self.graph = graph
        self._sequence_source = _WalkSequenceSource(factory)
        self.fit()
        return self

    # ---- reference query surface ----
    def get_vertex_vector(self, vertex: int) -> np.ndarray:
        return self.word_vector(str(vertex))

    def vertex_similarity(self, v1: int, v2: int) -> float:
        return self.similarity(str(v1), str(v2))

    def vertices_nearest(self, vertex: int, top: int = 5) -> List[int]:
        return [int(w) for w in self.words_nearest(str(vertex), top=top)]
