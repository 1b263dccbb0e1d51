"""Model zoo of the port: LeNet-MNIST, VGG16 (ImageNet and CIFAR-10
recipes), ResNet-50 and ResNet-18 (ComputationGraphs), the GravesLSTM
char-RNN and the causal self-attention language model of the
long-context example, at the JAX package's widths."""

from deeplearning4j_tpu_torch.models.attention import attention_lm  # noqa: F401
from deeplearning4j_tpu_torch.models.charrnn import (  # noqa: F401
    CharacterIterator, char_rnn, sample_text)
from deeplearning4j_tpu_torch.models.lenet import lenet  # noqa: F401
from deeplearning4j_tpu_torch.models.resnet import resnet18, resnet50  # noqa: F401
from deeplearning4j_tpu_torch.models.vgg import vgg16, vgg16_cifar10  # noqa: F401
