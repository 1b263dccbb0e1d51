"""SPTree — generalized octree for Barnes-Hut force approximation
(ref: clustering/sptree/SpTree.java, used by BarnesHutTsne).

Host-side: BH is inherently pointer-chasing.  The device path for t-SNE
is the exact O(N²) loop in plot/tsne.py (dense pairwise on the card); this
tree serves the theta-approximation mode for large N.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class SpTree:
    """A node subdivides into 2^d children on demand
    (ref: SpTree.java subdivide/insert/computeNonEdgeForces)."""

    QT_NODE_CAPACITY = 1

    def __init__(self, center: np.ndarray, width: np.ndarray,
                 parent: Optional["SpTree"] = None):
        self.d = len(center)
        self.center = np.asarray(center, np.float64)
        self.width = np.asarray(width, np.float64)
        self.parent = parent
        self.children: Optional[list] = None
        self.cum_size = 0
        self.center_of_mass = np.zeros(self.d)
        self.point: Optional[np.ndarray] = None

    @staticmethod
    def build(data) -> "SpTree":
        data = np.asarray(data, np.float64)
        mins, maxs = data.min(0), data.max(0)
        center = (mins + maxs) / 2.0
        width = (maxs - mins) / 2.0 + 1e-5
        tree = SpTree(center, width)
        for row in data:
            tree.insert(row)
        return tree

    def _contains(self, p) -> bool:
        return bool(np.all(np.abs(p - self.center) <= self.width + 1e-12))

    def insert(self, p) -> bool:
        p = np.asarray(p, np.float64)
        if not self._contains(p):
            return False
        self.cum_size += 1
        self.center_of_mass += (p - self.center_of_mass) / self.cum_size
        if self.children is None and self.point is None:
            self.point = p
            return True
        if self.children is None:
            # duplicate point: just accumulate mass, don't subdivide forever
            if np.allclose(self.point, p):
                return True
            self._subdivide()
        for c in self.children:
            if c.insert(p):
                return True
        return False  # numerically outside every child; mass already counted

    def _subdivide(self):
        self.children = []
        half = self.width / 2.0
        for mask in range(2 ** self.d):
            offs = np.array([(1 if (mask >> i) & 1 else -1) for i in range(self.d)])
            child = SpTree(self.center + offs * half, half, self)
            self.children.append(child)
        old = self.point
        self.point = None
        for c in self.children:
            if c.insert(old):
                break

    def compute_non_edge_forces(self, point, theta: float):
        """Barnes-Hut negative forces for one point: returns
        (neg_force [d], sum_Q contribution)
        (ref: SpTree.computeNonEdgeForces)."""
        neg = np.zeros(self.d)
        sum_q = 0.0
        stack = [self]
        while stack:
            node = stack.pop()
            if node.cum_size == 0:
                continue
            diff = point - node.center_of_mass
            d2 = float(diff @ diff)
            is_self = node.point is not None and d2 < 1e-18
            max_width = float(np.max(node.width)) * 2.0
            if node.children is None or (d2 > 0 and max_width / np.sqrt(d2) < theta):
                if is_self:
                    continue
                q = 1.0 / (1.0 + d2)
                mult = node.cum_size * q
                sum_q += mult
                neg += mult * q * diff
            else:
                stack.extend(node.children)
        return neg, sum_q
