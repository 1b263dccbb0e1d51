"""Serving path of the port: model cache, dynamic micro-batcher, the
JSON-RPC gateway, and the nearest-neighbour HTTP server over a VPTree."""

from deeplearning4j_tpu_torch.server.batcher import (  # noqa: F401
    MicroBatcher, ServingMetrics)
from deeplearning4j_tpu_torch.server.gateway import (  # noqa: F401
    DeepLearning4jEntryPoint, Server)
from deeplearning4j_tpu_torch.server.model_cache import ModelCache  # noqa: F401
from deeplearning4j_tpu_torch.server.nearestneighbors import (  # noqa: F401
    NearestNeighbor, NearestNeighborsServer)
