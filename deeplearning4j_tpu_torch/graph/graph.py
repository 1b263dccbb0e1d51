"""Adjacency-list graph (ref: graph/Graph.java implementing api/IGraph.java;
vertices ref: api/Vertex.java, edges api/Edge.java)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Vertex:
    idx: int
    value: Any = None


@dataclasses.dataclass
class Edge:
    from_idx: int
    to_idx: int
    weight: float = 1.0
    directed: bool = False


class Graph:
    """(ref: graph/Graph.java — addEdge, getConnectedVertices,
    getRandomConnectedVertex, getVertexDegree)"""

    def __init__(self, n_vertices: int, allow_multiple_edges: bool = False):
        self.vertices = [Vertex(i) for i in range(n_vertices)]
        self.allow_multiple_edges = allow_multiple_edges
        self._out: List[List[Edge]] = [[] for _ in range(n_vertices)]

    # ---- construction ----
    def add_edge(self, from_idx: int, to_idx: int, weight: float = 1.0,
                 directed: bool = False):
        n = len(self._out)
        if not (0 <= from_idx < n and 0 <= to_idx < n):
            raise IndexError(
                f"edge ({from_idx},{to_idx}) out of range for {n} vertices")
        e = Edge(from_idx, to_idx, weight, directed)
        if not self.allow_multiple_edges and any(
                x.to_idx == to_idx for x in self._out[from_idx]):
            return
        self._out[from_idx].append(e)
        if not directed and from_idx != to_idx:
            self._out[to_idx].append(Edge(to_idx, from_idx, weight, directed))

    # ---- queries ----
    def num_vertices(self) -> int:
        return len(self.vertices)

    def get_vertex(self, idx: int) -> Vertex:
        return self.vertices[idx]

    def get_edges_out(self, idx: int) -> List[Edge]:
        return self._out[idx]

    def get_vertex_degree(self, idx: int) -> int:
        return len(self._out[idx])

    def get_connected_vertices(self, idx: int) -> List[int]:
        return [e.to_idx for e in self._out[idx]]

    def get_random_connected_vertex(self, idx: int,
                                    rng: np.random.Generator) -> Optional[int]:
        edges = self._out[idx]
        if not edges:
            return None
        return edges[int(rng.integers(0, len(edges)))].to_idx

    def get_connected_vertex_weights(self, idx: int) -> np.ndarray:
        return np.array([e.weight for e in self._out[idx]], np.float64)

    def degrees(self) -> np.ndarray:
        return np.array([len(o) for o in self._out], np.int64)
