"""DataSet export and path-backed iteration — the part of
``deeplearning4j_tpu/scaleout/data.py`` the gateway's ``fit`` and
``evaluate`` read (ref: dl4j-spark/.../spark/data/DataSetExportFunction,
spark/iterator/PathSparkDataSetIterator).

DataSets export to ``.npz`` files (features, labels, masks) and stream
back through :class:`PathDataSetIterator`; the files are the JAX
package's, so either package reads what the other wrote.  Reading ahead
on the native threaded prefetcher (``prefetch=True``) waits for the port
of ``native/``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Sequence, Union

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator


def export_dataset(ds: DataSet, path: Union[str, Path]) -> None:
    """(ref: spark/data/DataSetExportFunction.java).  Write is atomic
    (temp file + rename) so streaming consumers never observe a
    half-written archive."""
    arrays = {"features": ds.features, "labels": ds.labels}
    if ds.features_mask is not None:
        arrays["features_mask"] = ds.features_mask
    if ds.labels_mask is not None:
        arrays["labels_mask"] = ds.labels_mask
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_suffix(path.suffix + ".npz")
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_dataset(path: Union[str, Path]) -> DataSet:
    with np.load(path) as z:
        return DataSet(z["features"], z["labels"],
                       z["features_mask"] if "features_mask" in z else None,
                       z["labels_mask"] if "labels_mask" in z else None)


class PathDataSetIterator(DataSetIterator):
    """Streams DataSets from exported files
    (ref: spark/iterator/PathSparkDataSetIterator.java)."""

    def __init__(self, paths: Sequence[Union[str, Path]],
                 prefetch: bool = False):
        if prefetch:
            raise NotImplementedError(
                "PathDataSetIterator(prefetch=True) reads ahead on the "
                "native threaded prefetcher (native/dl4j_io.cc), which is "
                "not ported to deeplearning4j_tpu_torch yet (ROADMAP A9)")
        self.paths = [str(p) for p in paths]
        self._i = 0

    @staticmethod
    def from_dir(directory: Union[str, Path]) -> "PathDataSetIterator":
        files = sorted(Path(directory).glob("*.npz"),
                       key=lambda p: (len(p.name), p.name))
        return PathDataSetIterator(files)

    def has_next(self) -> bool:
        return self._i < len(self.paths)

    def next(self) -> DataSet:
        ds = load_dataset(self.paths[self._i])
        self._i += 1
        return ds

    def reset(self) -> None:
        self._i = 0
