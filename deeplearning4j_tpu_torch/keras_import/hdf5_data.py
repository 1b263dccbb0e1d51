"""HDF5 minibatch streaming — a copy of ``deeplearning4j_tpu/keras_import/hdf5_data.py``
(ref: keras/HDF5MiniBatchDataSetIterator.java:24-90 — minibatches dumped
as ``batch_%d.h5`` files, features and labels in SEPARATE directories,
each file holding one ndarray in its ``"data"`` dataset, read by
keras/NDArrayHDF5Reader.java:33).

Two layouts are accepted:

* reference layout — ``features_dir/batch_%d.h5`` + ``labels_dir/
  batch_%d.h5``, each with a ``"data"`` dataset;
* single-directory convenience — ``dir/batch_%d.h5`` where each file
  carries ``"features"`` and ``"labels"`` datasets.

h5py is imported only when a file is read.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import List, Optional, Union

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator

_BATCH_RE = re.compile(r"^batch_(\d+)\.h5$")


def _batch_files(directory: Path) -> List[Path]:
    """``batch_%d.h5`` files in index order (the FILE_NAME_PATTERN
    contract, HDF5MiniBatchDataSetIterator.java:24)."""
    found = []
    for p in directory.iterdir():
        m = _BATCH_RE.match(p.name)
        if m:
            found.append((int(m.group(1)), p))
    return [p for _, p in sorted(found)]


def read_hdf5_ndarray(path: Union[str, Path], dataset: str = "data"):
    """One ndarray from an HDF5 file (ref: NDArrayHDF5Reader.java:33 —
    the array lives in the "data" dataset)."""
    import h5py
    with h5py.File(str(path), "r") as f:
        if dataset not in f:
            raise KeyError(f"{path}: no {dataset!r} dataset "
                           f"(has {list(f.keys())})")
        return np.asarray(f[dataset], np.float32)


class HDF5MiniBatchDataSetIterator(DataSetIterator):
    """Stream ``batch_%d.h5`` minibatches as DataSets."""

    def __init__(self, features_dir: Union[str, Path],
                 labels_dir: Optional[Union[str, Path]] = None):
        self.features_dir = Path(features_dir)
        self.labels_dir = Path(labels_dir) if labels_dir is not None else None
        self._files = _batch_files(self.features_dir)
        if not self._files:
            raise FileNotFoundError(
                f"no batch_%d.h5 files in {self.features_dir}")
        if self.labels_dir is not None:
            missing = [p.name for p in self._files
                       if not (self.labels_dir / p.name).exists()]
            if missing:
                raise FileNotFoundError(
                    f"labels dir {self.labels_dir} missing {missing}")
        self._i = 0

    def has_next(self) -> bool:
        return self._i < len(self._files)

    def next(self) -> DataSet:
        p = self._files[self._i]
        self._i += 1
        if self.labels_dir is not None:
            x = read_hdf5_ndarray(p)
            y = read_hdf5_ndarray(self.labels_dir / p.name)
        else:
            # one open for both datasets
            import h5py
            with h5py.File(str(p), "r") as f:
                for ds in ("features", "labels"):
                    if ds not in f:
                        raise KeyError(f"{p}: no {ds!r} dataset "
                                       f"(has {list(f.keys())})")
                x = np.asarray(f["features"], np.float32)
                y = np.asarray(f["labels"], np.float32)
        return DataSet(x, y)

    def reset(self) -> None:
        self._i = 0

    def __len__(self) -> int:
        return len(self._files)
