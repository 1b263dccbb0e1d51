"""Vantage-point tree (ref: clustering/vptree/VPTree.java — the k-NN
engine behind the NearestNeighborsServer and wordsNearest).

Host-side build with vectorized distance evaluation; search prunes by
triangle inequality.  For bulk queries on the card, prefer one dense
distance matrix (a GEMM, the formulas of
``deeplearning4j_tpu_torch.clustering.distances``) — the tree is the
serving-path structure for one-off queries.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.clustering.distances import distance_fn


class _VPNode:
    __slots__ = ("index", "radius", "inside", "outside")

    def __init__(self, index):
        self.index = index
        self.radius = 0.0
        self.inside: Optional[_VPNode] = None
        self.outside: Optional[_VPNode] = None


class VPTree:
    def __init__(self, items, distance: str = "euclidean",
                 labels: Optional[Sequence[str]] = None, seed: int = 0):
        self.items = np.asarray(items, np.float64)
        self.labels = list(labels) if labels is not None else None
        self.distance = distance
        # Triangle-inequality pruning requires a METRIC.  Cosine distance
        # is handled by searching in euclidean space over L2-normalized
        # vectors (d² = 2·(1-cos), monotone, and euclidean IS a metric);
        # non-metricizable distances ('dot') are rejected loudly rather
        # than silently returning wrong neighbors.
        self._cosine = distance.lower() in ("cosine", "cosinesimilarity")
        if self._cosine:
            norms = np.maximum(np.linalg.norm(self.items, axis=1,
                                              keepdims=True), 1e-12)
            self._search_items = self.items / norms
            self._dist = distance_fn("euclidean")
        elif distance.lower() == "dot":
            raise ValueError(
                "VPTree cannot prune with the non-metric 'dot' distance; "
                "use a dense distance matrix (clustering.distances) instead")
        else:
            self._search_items = self.items
            self._dist = distance_fn(distance)
        self._rng = np.random.default_rng(seed)
        self.root = self._build(np.arange(len(self.items)))

    def _build(self, idxs: np.ndarray) -> Optional[_VPNode]:
        if len(idxs) == 0:
            return None
        vp_pos = self._rng.integers(0, len(idxs))
        vp = int(idxs[vp_pos])
        rest = np.delete(idxs, vp_pos)
        node = _VPNode(vp)
        if len(rest) == 0:
            return node
        d = np.atleast_1d(self._dist(self._search_items[vp],
                                     self._search_items[rest]))
        node.radius = float(np.median(d))
        node.inside = self._build(rest[d < node.radius])
        node.outside = self._build(rest[d >= node.radius])
        return node

    def knn(self, query, k: int) -> Tuple[List[int], List[float]]:
        """k nearest (indices, distances), ascending
        (ref: VPTree.search)."""
        query = np.asarray(query, np.float64)
        if self._cosine:
            query = query / max(np.linalg.norm(query), 1e-12)
        heap: List[Tuple[float, int]] = []  # max-heap by -dist
        tau = [np.inf]

        def visit(node):
            if node is None:
                return
            d = float(np.atleast_1d(
                self._dist(query, self._search_items[node.index][None, :]))[0])
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
                if len(heap) == k:
                    tau[0] = -heap[0][0]
            elif d < tau[0]:
                heapq.heapreplace(heap, (-d, node.index))
                tau[0] = -heap[0][0]
            if node.inside is None and node.outside is None:
                return
            if d < node.radius:
                visit(node.inside)
                if d + tau[0] >= node.radius:
                    visit(node.outside)
            else:
                visit(node.outside)
                if d - tau[0] <= node.radius:
                    visit(node.inside)

        visit(self.root)
        out = sorted(heap, key=lambda t: -t[0])
        idxs = [i for _, i in out]
        dists = [-nd for nd, _ in out]
        if self._cosine:
            # convert search-space euclidean back to cosine distance:
            # d_euclid² = 2·(1 - cos)  ⇒  1-cos = d²/2
            dists = [d * d / 2.0 for d in dists]
        return idxs, dists

    def knn_labels(self, query, k: int) -> Tuple[List[str], List[float]]:
        idxs, dists = self.knn(query, k)
        return [self.labels[i] for i in idxs], dists
