"""Training data containers and iterators of the port (the JAX-free
``deeplearning4j_tpu/datasets`` modules, copied)."""

from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: F401
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: F401
    DataSetIterator,
    ListDataSetIterator,
)
