"""ResNet-50 and ResNet-18 — the port of ``deeplearning4j_tpu/models/resnet.py``
(He et al. 2015): ComputationGraphs of residual blocks joined by
``ElementWiseVertex(add)``, with the JAX package's vertex names, strides
and paddings.  In a bottleneck the stride sits on the 1x1 ``_a`` conv and
on the projection, so 46 of ResNet-50's 53 convs are stride 1 (the conv
kernel's) and the 7x7/2 stem and six 1x1/2 convs take the dense chain."""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ElementWiseVertex, GraphBuilder)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer, BatchNormalization, ConvolutionLayer,
    GlobalPoolingLayer, OutputLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.conf.network import GlobalConf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.ops.platform import DeviceLike

# (n_blocks, bottleneck_channels) per stage; out channels = 4x bottleneck
STAGES = [(3, 64), (4, 128), (6, 256), (3, 512)]


def _conv_bn(b: GraphBuilder, name: str, inp: str, n_out: int, kernel,
             stride, padding=(0, 0), act: str = "relu") -> str:
    b.add_layer(f"{name}_conv", ConvolutionLayer(
        n_out=n_out, kernel=kernel, stride=stride, padding=padding,
        activation="identity"), inp)
    b.add_layer(f"{name}_bn", BatchNormalization(), f"{name}_conv")
    if act != "identity":
        b.add_layer(f"{name}_act", ActivationLayer(activation=act),
                    f"{name}_bn")
        return f"{name}_act"
    return f"{name}_bn"


def _bottleneck(b: GraphBuilder, name: str, inp: str, ch: int, stride,
                project: bool) -> str:
    x = _conv_bn(b, f"{name}_a", inp, ch, (1, 1), stride)
    x = _conv_bn(b, f"{name}_b", x, ch, (3, 3), (1, 1), padding=(1, 1))
    x = _conv_bn(b, f"{name}_c", x, 4 * ch, (1, 1), (1, 1), act="identity")
    shortcut = (_conv_bn(b, f"{name}_proj", inp, 4 * ch, (1, 1), stride,
                         act="identity") if project else inp)
    b.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, shortcut)
    b.add_layer(f"{name}_out", ActivationLayer(activation="relu"),
                f"{name}_add")
    return f"{name}_out"


def _head(b: GraphBuilder, x: str, height: int, width: int, channels: int,
          n_classes: int, device: DeviceLike) -> ComputationGraph:
    b.add_layer("gap", GlobalPoolingLayer(pooling_type="avg"), x)
    b.add_layer("fc", OutputLayer(n_out=n_classes, activation="softmax",
                                  loss="mcxent"), "gap")
    conf = (b.set_outputs("fc")
            .set_input_types(InputType.convolutional(height, width,
                                                     channels))
            .build())
    return ComputationGraph(conf, device=device)


def resnet50(height: int = 224, width: int = 224, channels: int = 3,
             n_classes: int = 1000, learning_rate: float = 0.1,
             updater: str = "nesterovs", seed: int = 12345,
             device: DeviceLike = None) -> ComputationGraph:
    g = GlobalConf(seed=seed, learning_rate=learning_rate, updater=updater,
                   weight_init="relu")
    b = GraphBuilder(g).add_inputs("in")
    x = _conv_bn(b, "stem", "in", 64, (7, 7), (2, 2), padding=(3, 3))
    b.add_layer("stem_pool", SubsamplingLayer(
        pooling_type="max", kernel=(3, 3), stride=(2, 2), padding=(1, 1)), x)
    x = "stem_pool"
    for si, (n_blocks, ch) in enumerate(STAGES):
        for bi in range(n_blocks):
            stride = (2, 2) if (bi == 0 and si > 0) else (1, 1)
            x = _bottleneck(b, f"s{si}b{bi}", x, ch, stride,
                            project=(bi == 0))
    return _head(b, x, height, width, channels, n_classes, device)


def resnet18(height: int = 32, width: int = 32, channels: int = 3,
             n_classes: int = 10, learning_rate: float = 0.1,
             seed: int = 12345, device: DeviceLike = None
             ) -> ComputationGraph:
    """The small basic-block variant for CIFAR-scale inputs."""
    g = GlobalConf(seed=seed, learning_rate=learning_rate,
                   updater="nesterovs", weight_init="relu")
    b = GraphBuilder(g).add_inputs("in")
    x = _conv_bn(b, "stem", "in", 64, (3, 3), (1, 1), padding=(1, 1))
    for si, ch in enumerate([64, 128, 256, 512]):
        for bi in range(2):
            name = f"s{si}b{bi}"
            stride = (2, 2) if (bi == 0 and si > 0) else (1, 1)
            y = _conv_bn(b, f"{name}_a", x, ch, (3, 3), stride,
                         padding=(1, 1))
            y = _conv_bn(b, f"{name}_b", y, ch, (3, 3), (1, 1),
                         padding=(1, 1), act="identity")
            shortcut = x
            if bi == 0 and si > 0:
                shortcut = _conv_bn(b, f"{name}_proj", x, ch, (1, 1), stride,
                                    act="identity")
            b.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), y,
                         shortcut)
            b.add_layer(f"{name}_out", ActivationLayer(activation="relu"),
                        f"{name}_add")
            x = f"{name}_out"
    return _head(b, x, height, width, channels, n_classes, device)
