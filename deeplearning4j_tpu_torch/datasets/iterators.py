"""DataSet iterators — ``DataSetIterator`` and ``ListDataSetIterator`` of
``deeplearning4j_tpu/datasets/iterators.py``, copied.  The asynchronous
and sampling iterators are not ported yet; ``fit`` pulls batches in the
caller's thread.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


class DataSetIterator:
    """Iterator contract (ref: nd4j DataSetIterator)."""

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        return self.next()

    def next(self) -> DataSet:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def batch_size(self) -> int:
        raise NotImplementedError


class ListDataSetIterator(DataSetIterator):
    """Iterate a list of pre-built minibatches (ref: ListDataSetIterator)."""

    def __init__(self, data, batch: Optional[int] = None):
        if isinstance(data, DataSet):
            data = data.batch_by(batch) if batch else [data]
        self._data: List[DataSet] = list(data)
        self._i = 0

    def next(self):
        d = self._data[self._i]
        self._i += 1
        return d

    def has_next(self):
        return self._i < len(self._data)

    def reset(self):
        self._i = 0

    def batch_size(self):
        return self._data[0].num_examples() if self._data else 0
