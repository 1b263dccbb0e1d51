"""Vectorized distance kernels shared by clustering/trees/serving.

(ref: the nd4j distance ops consumed by clustering —
EuclideanDistance/CosineSimilarity/ManhattanDistance accumulations.)
All functions take (queries [M, D], points [N, D]) → [M, N] or
([D], [N, D]) → [N]; pure NumPy so they run host-side for serving, and
the same formulas are used inside jitted kernels where it matters.
"""

from __future__ import annotations

import numpy as np


def euclidean(q, pts):
    q = np.atleast_2d(q)
    d2 = (np.sum(q * q, -1)[:, None] - 2.0 * q @ pts.T +
          np.sum(pts * pts, -1)[None, :])
    return np.sqrt(np.maximum(d2, 0.0)).squeeze(0) if q.shape[0] == 1 else \
        np.sqrt(np.maximum(d2, 0.0))


def manhattan(q, pts):
    q = np.atleast_2d(q)
    d = np.sum(np.abs(q[:, None, :] - pts[None, :, :]), -1)
    return d.squeeze(0) if q.shape[0] == 1 else d


def cosine_distance(q, pts):
    """1 - cosine_similarity (ref: VPTree 'cosinesimilarity' uses
    similarity as INVERSE distance; we expose the proper metric)."""
    q = np.atleast_2d(q)
    qn = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    pn = pts / np.maximum(np.linalg.norm(pts, axis=-1, keepdims=True), 1e-12)
    d = 1.0 - qn @ pn.T
    return d.squeeze(0) if q.shape[0] == 1 else d


def dot_distance(q, pts):
    q = np.atleast_2d(q)
    d = -(q @ pts.T)
    return d.squeeze(0) if q.shape[0] == 1 else d


_DISTANCES = {
    "euclidean": euclidean,
    "manhattan": manhattan,
    "cosine": cosine_distance,
    "cosinesimilarity": cosine_distance,
    "dot": dot_distance,
}


def distance_fn(name: str):
    return _DISTANCES[name.lower()]
