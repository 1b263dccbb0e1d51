"""QuadTree — 2D special case of the Barnes-Hut tree
(ref: clustering/quadtree/QuadTree.java).  Same node logic as SpTree
with d=2; kept as its own named type for API parity."""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.clustering.sptree import SpTree


class QuadTree(SpTree):
    @staticmethod
    def build(data) -> "QuadTree":
        data = np.asarray(data, np.float64)
        assert data.shape[1] == 2, "QuadTree is 2D; use SpTree for general d"
        mins, maxs = data.min(0), data.max(0)
        tree = QuadTree((mins + maxs) / 2.0, (maxs - mins) / 2.0 + 1e-5)
        for row in data:
            tree.insert(row)
        return tree
