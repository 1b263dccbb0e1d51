"""K-Means (ref: clustering/kmeans/KMeansClustering.java + the iteration
machinery in clustering/algorithm/BaseClusteringAlgorithm.java).

The port of ``deeplearning4j_tpu/clustering/kmeans.py``, whose
``_kmeans_kernel`` is one jitted ``lax.while_loop``; here the same steps
run as torch on the card (CUDA unless the caller passes ``device="cpu"``):
k-means++ seeding from an explicit ``torch.Generator`` seeded with
``seed``, then Lloyd's iteration (:func:`lloyd`) — the [N, K] distances
one GEMM, the assignment an argmin, the centroid update ``one_hotᵀ @
points`` with empty clusters kept as they are — under JAX's stop rule,
``max|Δcenters| > tol`` and ``it < max_iter``.  The loop is a host loop
that reads the stop test from the card once per iteration.  No Pallas
kernel lies on this path.  ``jax.random.choice`` cannot be reproduced
here, so the seeding draws other centres than JAX's from the same seed;
:func:`lloyd` takes its initial centres so that it can be held to JAX's
loop from equal centres.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.clustering.cluster import (
    Cluster, ClusterSet, Point)
from deeplearning4j_tpu_torch.ops.platform import DeviceLike, resolve_device


@contextlib.contextmanager
def full_f32_matmul():
    """Matmuls in full f32 for the duration (TF32 off), as JAX's
    ``Precision.HIGHEST``; the previous setting is restored on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def dist2(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances [N, K] as one GEMM:
    |x|² - 2 x cᵀ + |c|²."""
    return ((x * x).sum(-1)[:, None] - 2.0 * x @ c.T
            + (c * c).sum(-1)[None, :])


def kmeans_pp(points: torch.Tensor, k: int,
              generator: torch.Generator) -> torch.Tensor:
    """k-means++ seeding: the first centre uniformly, each next one with
    probability proportional to the squared distance to the nearest
    centre chosen so far (negative rounding clamped to 0; all points on
    the centres: uniformly)."""
    n = points.shape[0]
    centers = torch.empty((k, points.shape[1]), dtype=points.dtype,
                          device=points.device)
    first = torch.randint(0, n, (1,), generator=generator,
                          device=points.device)
    centers[0] = points[first[0]]
    nearest = dist2(points, centers[:1])[:, 0].clamp_min(0.0)
    for i in range(1, k):
        weights = torch.where(nearest.sum() > 0, nearest,
                              torch.ones_like(nearest))
        idx = torch.multinomial(weights, 1, generator=generator)
        centers[i] = points[idx[0]]
        nearest = torch.minimum(
            nearest, dist2(points, centers[i:i + 1])[:, 0].clamp_min(0.0))
    return centers


def lloyd(points: torch.Tensor, centers: torch.Tensor, max_iter: int,
          tol: float):
    """Lloyd's iteration from ``centers`` -> (centers, assignments,
    iterations): while ``it < max_iter`` and the centres moved by more
    than ``tol`` (max abs), assign each point to its nearest centre and
    move each centre to its points' mean; a centre with no points stays.
    The first test passes as JAX's does (its ``prev`` starts 2 tol + 1
    away).  The distances are taken from the points and centres less the
    points' mean, which leaves them unchanged in exact arithmetic: the
    one-GEMM form cancels whatever the points share, so on vectors that
    point one way (a trained word-vector table) float32 distances from
    the raw points decide near ties by rounding and the loop leaves the
    float64 loop's path, where centred it keeps to it
    (``tests/test_torch_clustering.py``).  JAX's kernel takes them from
    the raw points."""
    k = centers.shape[0]
    it = 0
    moved = float("inf")
    mean = points.mean(0)
    centred = points - mean
    with full_f32_matmul():
        while it < max_iter and moved > tol:
            assign = torch.argmin(dist2(centred, centers - mean), dim=1)
            onehot = torch.nn.functional.one_hot(assign, k).to(points.dtype)
            counts = onehot.sum(0)
            sums = onehot.T @ points
            new = torch.where(counts[:, None] > 0,
                              sums / counts.clamp_min(1.0)[:, None], centers)
            moved = float((new - centers).abs().max())
            centers = new
            it += 1
        assign = torch.argmin(dist2(centred, centers - mean), dim=1)
    return centers, assign, it


class KMeansClustering:
    """(ref: KMeansClustering.setup(nClusters, maxIterations, distanceFn))"""

    def __init__(self, k: int, max_iter: int = 100,
                 distance: str = "euclidean", tol: float = 1e-4,
                 seed: int = 0, device: DeviceLike = None):
        if distance != "euclidean":
            # parity note: the reference accepts other distance functions;
            # Lloyd's update is only the mean-minimizer for euclidean, so
            # (like the reference in practice) we support euclidean here.
            raise ValueError("KMeansClustering supports euclidean distance")
        self.k = k
        self.max_iter = max_iter
        self.tol = tol
        self.seed = seed
        self.device = resolve_device(device)
        self.centers_: Optional[np.ndarray] = None
        self.assignments_: Optional[np.ndarray] = None
        self.iterations_: Optional[int] = None

    @staticmethod
    def setup(k: int, max_iter: int, distance: str = "euclidean",
              seed: int = 0, device: DeviceLike = None
              ) -> "KMeansClustering":
        return KMeansClustering(k, max_iter, distance, seed=seed,
                                device=device)

    def apply_to(self, points) -> ClusterSet:
        """Cluster a [N, D] matrix (numpy, or a tensor on any device) or a
        list of Points (ref: KMeansClustering.applyTo)."""
        if isinstance(points, list):
            mat = np.stack([p.array for p in points]).astype(np.float32)
            plist = points
        else:
            mat = points
            plist = None
        x = torch.as_tensor(mat, dtype=torch.float32).to(self.device)
        gen = torch.Generator(device=self.device).manual_seed(int(self.seed))
        with full_f32_matmul():
            centers0 = kmeans_pp(x, self.k, gen)
        centers, assign, iters = lloyd(x, centers0, self.max_iter, self.tol)
        self.centers_ = centers.cpu().numpy()
        self.assignments_ = assign.cpu().numpy()
        self.iterations_ = iters
        clusters = [Cluster(center=self.centers_[i], id=i)
                    for i in range(self.k)]
        if plist is None:
            host = x.cpu().numpy()
        for j, a in enumerate(self.assignments_):
            pt = plist[j] if plist is not None else Point(host[j], id=str(j))
            clusters[int(a)].points.append(pt)
        return ClusterSet(clusters=clusters)

    def predict(self, points) -> np.ndarray:
        mat = np.asarray(points, np.float32)
        d2 = (np.sum(mat * mat, -1)[:, None] - 2 * mat @ self.centers_.T +
              np.sum(self.centers_ ** 2, -1)[None, :])
        return np.argmin(d2, axis=1)
