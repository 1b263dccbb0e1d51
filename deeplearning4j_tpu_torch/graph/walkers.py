"""Random walk generators (ref: iterator/RandomWalkIterator.java,
WeightedRandomWalkIterator.java; node2vec biased walks ref:
models/node2vec/ + the node2vec paper's p/q second-order scheme).

Each iterator yields one walk (list of vertex indices) per vertex per
epoch — the reference's GraphWalkIterator<Integer> contract.
``no_edge_handling``: 'self_loop' (stay), 'restart' (jump to start), or
'exception' (ref: iterator/parallel edge handling enums).
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.graph.graph import Graph


class NoEdgesError(RuntimeError):
    pass


class RandomWalkIterator:
    """Uniform random walks (ref: iterator/RandomWalkIterator.java)."""

    def __init__(self, graph: Graph, walk_length: int, seed: int = 0,
                 no_edge_handling: str = "self_loop"):
        self.graph = graph
        self.walk_length = walk_length
        self.seed = seed
        self.no_edge_handling = no_edge_handling
        self._order: Optional[np.ndarray] = None

    def _start_order(self, rng) -> np.ndarray:
        order = np.arange(self.graph.num_vertices())
        rng.shuffle(order)
        return order

    def _step(self, cur: int, start: int, rng) -> int:
        nxt = self.graph.get_random_connected_vertex(cur, rng)
        if nxt is not None:
            return nxt
        if self.no_edge_handling == "self_loop":
            return cur
        if self.no_edge_handling == "restart":
            return start
        raise NoEdgesError(f"Vertex {cur} has no outgoing edges")

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.default_rng(self.seed)
        for start in self._start_order(rng):
            walk = [int(start)]
            cur = int(start)
            for _ in range(self.walk_length - 1):
                cur = self._step(cur, int(start), rng)
                walk.append(cur)
            yield walk


class WeightedRandomWalkIterator(RandomWalkIterator):
    """Edge-weight-proportional transitions
    (ref: iterator/WeightedRandomWalkIterator.java)."""

    def _step(self, cur: int, start: int, rng) -> int:
        edges = self.graph.get_edges_out(cur)
        if not edges:
            return super()._step(cur, start, rng)
        w = self.graph.get_connected_vertex_weights(cur)
        p = w / w.sum() if w.sum() > 0 else None
        return edges[int(rng.choice(len(edges), p=p))].to_idx


class Node2VecWalker(RandomWalkIterator):
    """Second-order p/q-biased walks (node2vec, Grover & Leskovec 2016;
    capability-parity extension of the reference's models/node2vec/).

    Transition weight from prev→cur→next: 1/p if next==prev,
    1 if next adjacent to prev, else 1/q, each times edge weight.
    """

    def __init__(self, graph: Graph, walk_length: int, p: float = 1.0,
                 q: float = 1.0, seed: int = 0,
                 no_edge_handling: str = "self_loop"):
        super().__init__(graph, walk_length, seed, no_edge_handling)
        self.p = p
        self.q = q
        self._nbr_sets = [set(graph.get_connected_vertices(i))
                          for i in range(graph.num_vertices())]

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.default_rng(self.seed)
        g = self.graph
        for start in self._start_order(rng):
            walk = [int(start)]
            cur = int(start)
            prev = -1
            for _ in range(self.walk_length - 1):
                edges = g.get_edges_out(cur)
                if not edges:
                    nxt = self._step(cur, int(start), rng)
                    # the p/q bias is only meaningful relative to the true
                    # predecessor; a restart jump has none, a self-loop's
                    # predecessor is the dead-end vertex itself
                    prev = -1 if nxt != cur else cur
                    cur = nxt
                    walk.append(cur)
                    continue
                w = np.array([e.weight for e in edges], np.float64)
                if prev >= 0:
                    bias = np.empty(len(edges))
                    for i, e in enumerate(edges):
                        if e.to_idx == prev:
                            bias[i] = 1.0 / self.p
                        elif e.to_idx in self._nbr_sets[prev]:
                            bias[i] = 1.0
                        else:
                            bias[i] = 1.0 / self.q
                    w = w * bias
                probs = w / w.sum()
                nxt = edges[int(rng.choice(len(edges), p=probs))].to_idx
                prev, cur = cur, nxt
                walk.append(cur)
            yield walk
