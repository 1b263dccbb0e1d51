"""Cluster model objects (ref: clustering/cluster/{Point,Cluster,ClusterSet}.java)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Point:
    """A point with optional id/label (ref: clustering/cluster/Point.java)."""

    array: np.ndarray
    id: Optional[str] = None
    label: Optional[str] = None

    @staticmethod
    def to_points(matrix) -> List["Point"]:
        return [Point(np.asarray(row)) for row in np.asarray(matrix)]


@dataclasses.dataclass
class Cluster:
    """A centroid plus its member points (ref: clustering/cluster/Cluster.java)."""

    center: np.ndarray
    points: List[Point] = dataclasses.field(default_factory=list)
    id: Optional[int] = None

    def distance_to_center(self, point: Point, distance: str = "euclidean") -> float:
        from deeplearning4j_tpu_torch.clustering.distances import distance_fn
        return float(distance_fn(distance)(point.array[None, :],
                                           self.center[None, :])[0])


@dataclasses.dataclass
class ClusterSet:
    """All clusters from one clustering run
    (ref: clustering/cluster/ClusterSet.java)."""

    clusters: List[Cluster] = dataclasses.field(default_factory=list)
    distance: str = "euclidean"

    @property
    def centers(self) -> np.ndarray:
        return np.stack([c.center for c in self.clusters])

    def nearest_cluster(self, point: Point) -> Cluster:
        from deeplearning4j_tpu_torch.clustering.distances import distance_fn
        d = distance_fn(self.distance)(point.array[None, :], self.centers)
        return self.clusters[int(np.argmin(d))]

    def classify_point(self, point: Point) -> int:
        return int(self.nearest_cluster(point).id)
