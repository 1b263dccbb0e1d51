"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of deeplearning4j_tpu.

The JAX package beside it stays the reference; this package mirrors its
layout (``ops/``, ``nn/``, ``nn/conf/``, ``models/``, ``server/``,
``text/``, ``embeddings/``, ``graph/``, ``clustering/``, ``plot/``) and its
public layouts (NCHW activations, OIHW conv weights, dense ``W`` as
``[n_in, n_out]``), so a model, its JSON configuration and its
``coefficients.bin`` move between the two unchanged.  Hot ops run as
kernels written by hand for NVIDIA Hopper (``csrc/``), built at first
use.  Entry points run on the CUDA device unless the caller passes
``device="cpu"``.  This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"

from deeplearning4j_tpu_torch.nn.conf.network import (  # noqa: F401
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (  # noqa: F401
    ComputationGraphConfiguration,
    GraphBuilder,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph  # noqa: F401
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: F401
