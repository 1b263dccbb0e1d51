"""DataSet and MultiDataSet — copies of ``deeplearning4j_tpu/datasets/dataset.py``.

Arrays are host numpy until the input pipeline stages a batch onto the
network's device (``datasets/iterators.stage_batch``), which leaves torch
tensors in their place; ``MultiLayerNetwork`` and ``ComputationGraph``
take either.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class DataSet:
    features: np.ndarray
    labels: np.ndarray
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def split_test_and_train(self, n_train: int):
        return (self.get_range(0, n_train),
                self.get_range(n_train, self.num_examples()))

    def shuffle(self, seed: Optional[int] = None) -> "DataSet":
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self.num_examples())
        return DataSet(self.features[idx], self.labels[idx],
                       None if self.features_mask is None
                       else self.features_mask[idx],
                       None if self.labels_mask is None
                       else self.labels_mask[idx])

    def get_range(self, start: int, end: int) -> "DataSet":
        sl = slice(start, end)
        return DataSet(
            self.features[sl], self.labels[sl],
            None if self.features_mask is None else self.features_mask[sl],
            None if self.labels_mask is None else self.labels_mask[sl])

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        n = self.num_examples()
        return [self.get_range(i, min(i + batch_size, n))
                for i in range(0, n, batch_size)]

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        return DataSet(
            np.concatenate([d.features for d in datasets]),
            np.concatenate([d.labels for d in datasets]),
            None if datasets[0].features_mask is None
            else np.concatenate([d.features_mask for d in datasets]),
            None if datasets[0].labels_mask is None
            else np.concatenate([d.labels_mask for d in datasets]))


@dataclasses.dataclass
class MultiDataSet:
    """Multi-input/multi-output container (ref: nd4j MultiDataSet, used by
    ComputationGraph.fit)."""

    features: List[np.ndarray]
    labels: List[np.ndarray]
    features_masks: Optional[List[Optional[np.ndarray]]] = None
    labels_masks: Optional[List[Optional[np.ndarray]]] = None

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])

    @staticmethod
    def of(ds: DataSet) -> "MultiDataSet":
        """A DataSet as a one-input, one-output MultiDataSet (what
        ``ComputationGraph.fit`` does with one)."""
        return MultiDataSet([ds.features], [ds.labels], [ds.features_mask],
                            [ds.labels_mask])
