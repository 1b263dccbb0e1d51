"""Data normalizers — a copy of ``deeplearning4j_tpu/datasets/normalizers.py``
(the consumed nd4j preprocessing surface: NormalizerStandardize /
NormalizerMinMaxScaler / ImagePreProcessingScaler).  ``to_dict`` writes
the JAX package's dict, so a normalizer saved by either package loads in
the other.
Statistics are numpy, on the host; ``transform`` takes host arrays, as it
runs on the input pipeline's workers before a batch is staged."""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet

NORMALIZER_REGISTRY: dict[str, type] = {}


def register_normalizer(cls):
    NORMALIZER_REGISTRY[cls.__name__] = cls
    return cls


def _iter_batches(data):
    """Yield flattened-2D float feature matrices from a DataSet or any
    DataSetIterator-shaped object, without materializing the epoch."""
    if isinstance(data, DataSet):
        yield data.features.reshape(data.features.shape[0], -1)
        return
    data.reset()
    while data.has_next():
        d = data.next()
        yield np.asarray(d.features).reshape(d.features.shape[0], -1)
    # leave the iterator rewound: fit(iterator) then fit-the-model on
    # the same iterator must not silently see an exhausted epoch
    data.reset()


class Normalizer:
    def fit(self, dataset) -> "Normalizer":
        """Accepts a DataSet or a DataSetIterator; iterator fitting is
        single-pass whole-batch accumulation (no per-row work)."""
        raise NotImplementedError

    def transform(self, dataset: DataSet) -> DataSet:
        raise NotImplementedError

    def transform_features(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def to_dict(self) -> dict:
        raise NotImplementedError

    @staticmethod
    def from_dict(d: dict) -> "Normalizer":
        d = dict(d)
        cls = NORMALIZER_REGISTRY[d.pop("@class")]
        return cls._from_dict(d)


@register_normalizer
class NormalizerStandardize(Normalizer):
    """Zero-mean unit-variance per feature column."""

    def __init__(self):
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None

    def fit(self, dataset):
        if isinstance(dataset, DataSet):
            f = dataset.features.reshape(dataset.features.shape[0], -1)
            self.mean = f.mean(axis=0)
            self.std = f.std(axis=0) + 1e-8
            return self
        # Iterator: single-pass parallel-variance merge (Chan et al.) —
        # per batch one vectorized mean/M2, merged into running stats;
        # same population mean/std as concatenating the whole epoch.
        n = 0
        mean = m2 = None
        for f in _iter_batches(dataset):
            f = f.astype(np.float64, copy=False)
            bn = f.shape[0]
            if bn == 0:
                continue
            bmean = f.mean(axis=0)
            bm2 = ((f - bmean) ** 2).sum(axis=0)
            if mean is None:
                n, mean, m2 = bn, bmean, bm2
            else:
                delta = bmean - mean
                tot = n + bn
                mean = mean + delta * (bn / tot)
                m2 = m2 + bm2 + delta * delta * (n * bn / tot)
                n = tot
        if mean is None:
            raise ValueError("fit on an empty iterator")
        self.mean = mean.astype(np.float32)
        self.std = (np.sqrt(m2 / n) + 1e-8).astype(np.float32)
        return self

    def transform_features(self, x):
        shape = x.shape
        f = x.reshape(shape[0], -1)
        return ((f - self.mean) / self.std).reshape(shape).astype(np.float32)

    def transform(self, dataset):
        return DataSet(self.transform_features(dataset.features), dataset.labels,
                       dataset.features_mask, dataset.labels_mask)

    def to_dict(self):
        return {"@class": "NormalizerStandardize",
                "mean": self.mean.tolist(), "std": self.std.tolist()}

    @classmethod
    def _from_dict(cls, d):
        n = cls()
        n.mean = np.asarray(d["mean"], np.float32)
        n.std = np.asarray(d["std"], np.float32)
        return n


@register_normalizer
class NormalizerMinMaxScaler(Normalizer):
    """Scale features into [lo, hi] per column."""

    def __init__(self, lo: float = 0.0, hi: float = 1.0):
        self.lo = lo
        self.hi = hi
        self.min: Optional[np.ndarray] = None
        self.max: Optional[np.ndarray] = None

    def fit(self, dataset):
        if isinstance(dataset, DataSet):
            f = dataset.features.reshape(dataset.features.shape[0], -1)
            self.min = f.min(axis=0)
            self.max = f.max(axis=0)
            return self
        lo = hi = None  # iterator: running elementwise min/max per batch
        for f in _iter_batches(dataset):
            if f.shape[0] == 0:
                continue
            bmin, bmax = f.min(axis=0), f.max(axis=0)
            lo = bmin if lo is None else np.minimum(lo, bmin)
            hi = bmax if hi is None else np.maximum(hi, bmax)
        if lo is None:
            raise ValueError("fit on an empty iterator")
        self.min, self.max = lo, hi
        return self

    def transform_features(self, x):
        shape = x.shape
        f = x.reshape(shape[0], -1)
        rng = np.maximum(self.max - self.min, 1e-8)
        scaled = (f - self.min) / rng * (self.hi - self.lo) + self.lo
        return scaled.reshape(shape).astype(np.float32)

    def transform(self, dataset):
        return DataSet(self.transform_features(dataset.features), dataset.labels,
                       dataset.features_mask, dataset.labels_mask)

    def to_dict(self):
        return {"@class": "NormalizerMinMaxScaler", "lo": self.lo, "hi": self.hi,
                "min": self.min.tolist(), "max": self.max.tolist()}

    @classmethod
    def _from_dict(cls, d):
        n = cls(d["lo"], d["hi"])
        n.min = np.asarray(d["min"], np.float32)
        n.max = np.asarray(d["max"], np.float32)
        return n


@register_normalizer
class ImagePreProcessingScaler(Normalizer):
    """Scale raw pixel values [0,maxval] → [lo,hi] (ref: nd4j
    ImagePreProcessingScaler, used for MNIST/CIFAR pipelines)."""

    def __init__(self, lo: float = 0.0, hi: float = 1.0, max_value: float = 255.0):
        self.lo = lo
        self.hi = hi
        self.max_value = max_value

    def fit(self, dataset):
        return self

    def transform_features(self, x):
        return (x / self.max_value * (self.hi - self.lo) + self.lo).astype(np.float32)

    def transform(self, dataset):
        return DataSet(self.transform_features(dataset.features), dataset.labels,
                       dataset.features_mask, dataset.labels_mask)

    def to_dict(self):
        return {"@class": "ImagePreProcessingScaler", "lo": self.lo,
                "hi": self.hi, "max_value": self.max_value}

    @classmethod
    def _from_dict(cls, d):
        return cls(d["lo"], d["hi"], d["max_value"])
