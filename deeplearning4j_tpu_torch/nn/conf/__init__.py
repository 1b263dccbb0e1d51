from deeplearning4j_tpu_torch.nn.conf.inputs import InputType  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf.network import (  # noqa: F401
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf import layers_pretrain  # noqa: F401,E402  (registers its layer types)
