"""Training data of the port: containers, iterators and the async input
pipeline, normalizers and fetchers (the ``deeplearning4j_tpu/datasets``
modules; ``MultiDataSet`` waits for the ComputationGraph)."""

from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: F401
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: F401
    AsyncDataSetIterator,
    DataSetIterator,
    ExistingDataSetIterator,
    ListDataSetIterator,
    MultipleEpochsIterator,
    SamplingDataSetIterator,
)
