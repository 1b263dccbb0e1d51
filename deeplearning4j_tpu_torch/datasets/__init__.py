"""Training data of the port: containers, iterators and the async input
pipeline, normalizers and fetchers (the ``deeplearning4j_tpu/datasets``
modules), ``MultiDataSet`` and its iterators for the ComputationGraph."""

from deeplearning4j_tpu_torch.datasets.dataset import (  # noqa: F401
    DataSet, MultiDataSet)
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: F401
    AsyncDataSetIterator,
    AsyncMultiDataSetIterator,
    DataSetIterator,
    ExistingDataSetIterator,
    ListDataSetIterator,
    ListMultiDataSetIterator,
    MultiDataSetIterator,
    MultipleEpochsIterator,
    SamplingDataSetIterator,
)
