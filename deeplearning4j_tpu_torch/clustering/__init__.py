"""Clustering + space-partitioning structures — the port of
``deeplearning4j_tpu/clustering``.

Parity with the reference's deeplearning4j-core clustering package
(ref: clustering/{kmeans,kdtree,vptree,quadtree,sptree,cluster}/).
K-Means runs as torch on the card (``kmeans.py``: the assignment's
distances one GEMM, the update ``one_hotᵀ @ points``); the
pointer-chasing trees (KD/VP/SP/Quad) stay host-side numpy, as in the JAX
package, for API parity and for host-side serving
(``server/nearestneighbors.py``).
"""

from deeplearning4j_tpu_torch.clustering.cluster import (  # noqa: F401
    Cluster, ClusterSet, Point)
from deeplearning4j_tpu_torch.clustering.kmeans import KMeansClustering  # noqa: F401
from deeplearning4j_tpu_torch.clustering.kdtree import KDTree  # noqa: F401
from deeplearning4j_tpu_torch.clustering.vptree import VPTree  # noqa: F401
from deeplearning4j_tpu_torch.clustering.quadtree import QuadTree  # noqa: F401
from deeplearning4j_tpu_torch.clustering.sptree import SpTree  # noqa: F401
