"""Serving path of the port: model cache, dynamic micro-batcher, stateful
decode pools with speculative decode, the JSON-RPC gateway, and the
nearest-neighbour HTTP server over a VPTree."""

from deeplearning4j_tpu_torch.server.batcher import (  # noqa: F401
    MicroBatcher, ServingMetrics)
from deeplearning4j_tpu_torch.server.decode import (  # noqa: F401
    DecodeManager, DecodePool)
from deeplearning4j_tpu_torch.server.gateway import (  # noqa: F401
    DeepLearning4jEntryPoint, Server)
from deeplearning4j_tpu_torch.server.model_cache import ModelCache  # noqa: F401
from deeplearning4j_tpu_torch.server.nearestneighbors import (  # noqa: F401
    NearestNeighbor, NearestNeighborsServer)
from deeplearning4j_tpu_torch.server.speculative import (  # noqa: F401
    ModelDraft, NGramDraft, ScriptedDraft, SpeculativeDecoder)
