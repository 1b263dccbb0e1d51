"""KD-tree (ref: clustering/kdtree/KDTree.java — insert/nn/knn over
axis-aligned splits).  Host-side structure: serving-path lookups, not a
device workload."""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class _Node:
    __slots__ = ("point", "index", "left", "right", "axis")

    def __init__(self, point, index, axis):
        self.point = point
        self.index = index
        self.axis = axis
        self.left: Optional[_Node] = None
        self.right: Optional[_Node] = None


class KDTree:
    def __init__(self, dims: int):
        self.dims = dims
        self.root: Optional[_Node] = None
        self.size = 0

    @staticmethod
    def build(points) -> "KDTree":
        """Balanced build by median splits (the reference builds by
        repeated insert; balanced build gives the same API with better
        worst-case depth)."""
        pts = np.asarray(points, np.float64)
        tree = KDTree(pts.shape[1])

        def rec(idxs, depth):
            if len(idxs) == 0:
                return None
            axis = depth % tree.dims
            order = idxs[np.argsort(pts[idxs, axis], kind="stable")]
            mid = len(order) // 2
            node = _Node(pts[order[mid]], int(order[mid]), axis)
            node.left = rec(order[:mid], depth + 1)
            node.right = rec(order[mid + 1:], depth + 1)
            return node

        tree.root = rec(np.arange(len(pts)), 0)
        tree.size = len(pts)
        return tree

    def insert(self, point, index: Optional[int] = None):
        """(ref: KDTree.insert)"""
        point = np.asarray(point, np.float64)
        if index is None:
            index = self.size
        if self.root is None:
            self.root = _Node(point, index, 0)
            self.size = 1
            return
        node = self.root
        depth = 0
        while True:
            axis = node.axis
            branch = "left" if point[axis] < node.point[axis] else "right"
            nxt = getattr(node, branch)
            if nxt is None:
                setattr(node, branch, _Node(point, index, (depth + 1) % self.dims))
                self.size += 1
                return
            node = nxt
            depth += 1

    def nn(self, point) -> Tuple[np.ndarray, float, int]:
        """Nearest neighbor: (point, distance, index) (ref: KDTree.nn)."""
        pts, dists, idxs = self.knn(point, 1)
        return pts[0], dists[0], idxs[0]

    def knn(self, point, k: int):
        """k nearest: ([k, D] points, [k] distances, [k] indices)."""
        point = np.asarray(point, np.float64)
        heap: List[Tuple[float, int, np.ndarray]] = []  # max-heap by -dist

        def visit(node):
            if node is None:
                return
            d = float(np.linalg.norm(node.point - point))
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index, node.point))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.index, node.point))
            diff = point[node.axis] - node.point[node.axis]
            near, far = (node.left, node.right) if diff < 0 else (node.right, node.left)
            visit(near)
            if len(heap) < k or abs(diff) < -heap[0][0]:
                visit(far)

        visit(self.root)
        out = sorted(heap, key=lambda t: -t[0])
        return (np.stack([t[2] for t in out]),
                np.array([-t[0] for t in out]),
                [t[1] for t in out])
