"""Layer configuration types — the port of ``deeplearning4j_tpu/nn/conf/layers.py``.

As in the JAX package each config is a dataclass that is both the
JSON-serializable hyperparameter record and the layer's implementation:
``initialize`` draws the layer's params, ``forward`` applies it.  The
fields and their JSON are the JAX package's, so a configuration written
by either package builds the same layers in the other.

Ported so far: ``DenseLayer``, ``OutputLayer``, ``ConvolutionLayer`` and
``SubsamplingLayer`` (the layers of LeNet and VGG16), and the recurrent
family ``GravesLSTM``, ``GravesBidirectionalLSTM``, ``RnnOutputLayer`` and
``LastTimeStepLayer`` (sequences [N, T, C], masks [N, T]).
``forward(params, state, x, train, seed, mask)`` returns ``(output,
new_state, mask)`` as in the JAX package: ``state`` is the layer's dict
of carried state (a recurrent layer's ``rnn_state``), ``mask`` the time
mask.  It runs inference unless ``train`` is set; in training a layer
with ``dropout`` drops its INPUT, as DL4J does, from the two seed words
the network hands it for the step.  A configuration naming any other
layer type raises on load.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.ops import activations as act_ops
from deeplearning4j_tpu_torch.ops import convolution as conv_ops
from deeplearning4j_tpu_torch.ops import helpers as helper_ops
from deeplearning4j_tpu_torch.ops import initializers
from deeplearning4j_tpu_torch.ops import losses as loss_ops
from deeplearning4j_tpu_torch.ops import recurrent as rnn_ops

LAYER_REGISTRY: Dict[str, type] = {}


def register_layer(cls):
    LAYER_REGISTRY[cls.__name__] = cls
    return cls


@dataclasses.dataclass
class Layer:
    """Hyperparameters every layer config can carry.  ``None`` means
    "inherit from the global configuration".  ``dropout`` is the RETAIN
    probability, as in DL4J 0.8 (0.0 = off; ref: util/Dropout.java).
    Inference ignores the training fields, as the JAX package's
    inference path does."""

    name: Optional[str] = None
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    bias_init: Optional[float] = None
    dist: Optional[dict] = None
    learning_rate: Optional[float] = None
    bias_learning_rate: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    l1_bias: Optional[float] = None
    l2_bias: Optional[float] = None
    dropout: Optional[float] = None
    use_drop_connect: Optional[bool] = None
    updater: Optional[str] = None
    momentum: Optional[float] = None
    rho: Optional[float] = None
    rms_decay: Optional[float] = None
    adam_mean_decay: Optional[float] = None
    adam_var_decay: Optional[float] = None
    epsilon: Optional[float] = None
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: Optional[float] = None

    def initialize(self, generator: torch.Generator, input_type: InputType,
                   device: torch.device) -> Tuple[dict, InputType]:
        raise NotImplementedError

    def forward(self, params: dict, state: dict, x: torch.Tensor,
                train: bool = False, seed=None, mask=None
                ) -> Tuple[torch.Tensor, dict, Optional[torch.Tensor]]:
        """Apply the layer -> (output, new state, output mask); ``train``
        turns dropout on, with ``seed`` the layer's two uint32 seed words
        for this step."""
        raise NotImplementedError

    def output_type(self, input_type: InputType) -> InputType:
        raise NotImplementedError

    def _act(self, x):
        return act_ops.get(self.activation or "identity")(x)

    def _maybe_dropout(self, x, train: bool, seed):
        """Input dropout in training (ref: util/Dropout.java applyDropout).
        DropConnect, which reuses the probability on the weights instead,
        is not ported; ``MultiLayerNetwork.fit`` refuses it."""
        if self.use_drop_connect:
            return x
        if train and self.dropout and 0.0 < self.dropout < 1.0 \
                and seed is not None:
            return helper_ops.dropout(x, self.dropout, seed)
        return x

    def _winit(self, generator, shape, device, fan_in=None, fan_out=None):
        return initializers.init(generator, self.weight_init or "xavier",
                                 shape, fan_in=fan_in, fan_out=fan_out,
                                 device=device)

    def _binit(self, shape, device):
        return torch.full(shape, float(self.bias_init or 0.0),
                          dtype=torch.float32, device=device)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["@class"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d: dict) -> "Layer":
        d = dict(d)
        name = d.pop("@class")
        if name not in LAYER_REGISTRY:
            raise NotImplementedError(
                f"layer type {name!r} is not ported to "
                f"deeplearning4j_tpu_torch yet (ported: "
                f"{sorted(LAYER_REGISTRY)})")
        return LAYER_REGISTRY[name](**d)


@register_layer
@dataclasses.dataclass
class DenseLayer(Layer):
    """Fully connected: y = act(x @ W + b), ``W`` as [n_in, n_out]."""

    n_in: Optional[int] = None
    n_out: int = 0

    def initialize(self, generator, input_type, device):
        n_in = self.n_in or input_type.flat_size()
        params = {"W": self._winit(generator, (n_in, self.n_out), device),
                  "b": self._binit((self.n_out,), device)}
        return params, InputType.feed_forward(self.n_out)

    def forward(self, params, state, x, train=False, seed=None, mask=None):
        x = self._maybe_dropout(x, train, seed)
        return self._act(torch.addmm(params["b"], x, params["W"])), state, \
            mask

    def output_type(self, input_type):
        return InputType.feed_forward(self.n_out)


@dataclasses.dataclass
class BaseOutputLayer(DenseLayer):
    """Dense + loss head (ref: nn/layers/BaseOutputLayer computeScore)."""

    loss: str = "mcxent"

    def compute_score(self, labels, preout, mask=None):
        """Per-example loss [N] from pre-activations (stable fused path)."""
        return loss_ops.get(self.loss)(labels, preout,
                                       self.activation or "softmax", mask)

    def preoutput(self, params, x):
        return torch.addmm(params["b"], x, params["W"])


@register_layer
@dataclasses.dataclass
class OutputLayer(BaseOutputLayer):
    """Dense + loss head; at inference, activation(x @ W + b)."""


@register_layer
@dataclasses.dataclass
class ConvolutionLayer(Layer):
    """2D convolution, weights OIHW [n_out, c_in, kh, kw].  The forward
    goes through ``ops/helpers.conv2d_bias_act``: the hand-written CUDA
    kernel for stride-1 convs on the card, the dense chain otherwise."""

    n_in: Optional[int] = None
    n_out: int = 0
    kernel: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    convolution_mode: str = "truncate"  # 'truncate' | 'same'

    def initialize(self, generator, input_type, device):
        c_in = self.n_in or input_type.channels
        kh, kw = self.kernel
        params = {
            "W": self._winit(generator, (self.n_out, c_in, kh, kw), device,
                             fan_in=c_in * kh * kw,
                             fan_out=self.n_out * kh * kw),
            "b": self._binit((self.n_out,), device),
        }
        return params, self.output_type(input_type)

    def forward(self, params, state, x, train=False, seed=None, mask=None):
        x = self._maybe_dropout(x, train, seed)
        return helper_ops.conv2d_bias_act(
            x, params["W"], params["b"], tuple(self.stride),
            tuple(self.padding), tuple(self.dilation),
            self.convolution_mode, self.activation or "identity"), state, mask

    def output_type(self, input_type):
        oh, ow = conv_ops.conv2d_output_shape(
            (input_type.height, input_type.width), self.kernel, self.stride,
            self.padding, self.dilation, self.convolution_mode)
        return InputType.convolutional(oh, ow, self.n_out)


@register_layer
@dataclasses.dataclass
class SubsamplingLayer(Layer):
    """Pooling: max | avg | sum | pnorm."""

    pooling_type: str = "max"
    kernel: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: str = "truncate"
    pnorm: int = 2

    def initialize(self, generator, input_type, device):
        return {}, self.output_type(input_type)

    def forward(self, params, state, x, train=False, seed=None, mask=None):
        return conv_ops.pool2d(x, self.pooling_type, tuple(self.kernel),
                               tuple(self.stride), tuple(self.padding),
                               self.convolution_mode, self.pnorm), state, mask

    def output_type(self, input_type):
        oh, ow = conv_ops.conv2d_output_shape(
            (input_type.height, input_type.width), self.kernel, self.stride,
            self.padding, (1, 1), self.convolution_mode)
        return InputType.convolutional(oh, ow, input_type.channels)


# ---------------------------------------------------------------------------
# Recurrent family, layout [N, T, C]
# ---------------------------------------------------------------------------

@register_layer
@dataclasses.dataclass
class GravesLSTM(Layer):
    """Peephole LSTM over the whole sequence (``ops/recurrent.lstm_scan``).
    The final (c, h) goes back as ``rnn_state`` in the returned state,
    which ``rnn_time_step`` and truncated BPTT carry to the next call."""

    n_in: Optional[int] = None
    n_out: int = 0
    gate_activation: str = "sigmoid"
    forget_gate_bias_init: float = 1.0

    def initialize(self, generator, input_type, device):
        n_in = self.n_in or input_type.size
        H = self.n_out
        b = torch.zeros((4 * H,), dtype=torch.float32, device=device)
        b[H:2 * H] = self.forget_gate_bias_init      # the forget-gate block
        params = {
            "W": self._winit(generator, (n_in, 4 * H), device, fan_in=n_in,
                             fan_out=4 * H),
            "RW": self._winit(generator, (H, 4 * H), device, fan_in=H,
                              fan_out=4 * H),
            "b": b,
            "pI": torch.zeros((H,), dtype=torch.float32, device=device),
            "pF": torch.zeros((H,), dtype=torch.float32, device=device),
            "pO": torch.zeros((H,), dtype=torch.float32, device=device),
        }
        return params, InputType.recurrent(H, input_type.timesteps)

    def forward(self, params, state, x, train=False, seed=None, mask=None):
        x = self._maybe_dropout(x, train, seed)
        init = state.get("rnn_state") if state else None
        hs, final = rnn_ops.lstm_scan(
            params, x, init, mask,
            gate_act=act_ops.get(self.gate_activation),
            cell_act=act_ops.get(self.activation or "tanh"))
        return hs, {**(state or {}), "rnn_state": final}, mask

    def output_type(self, input_type):
        return InputType.recurrent(self.n_out, input_type.timesteps)


@register_layer
@dataclasses.dataclass
class GravesBidirectionalLSTM(Layer):
    """A forward and a backward peephole LSTM with their own params
    (``f_*``, ``b_*``); the two directions' outputs are SUMMED, so the
    output size is n_out (ref: GravesBidirectionalLSTM.java:204).  It
    carries no state between calls."""

    n_in: Optional[int] = None
    n_out: int = 0
    gate_activation: str = "sigmoid"
    forget_gate_bias_init: float = 1.0

    def _direction(self) -> GravesLSTM:
        return GravesLSTM(n_in=self.n_in, n_out=self.n_out,
                          activation=self.activation,
                          weight_init=self.weight_init, dist=self.dist,
                          gate_activation=self.gate_activation,
                          forget_gate_bias_init=self.forget_gate_bias_init)

    def initialize(self, generator, input_type, device):
        sub = self._direction()
        pf, out = sub.initialize(generator, input_type, device)
        pb, _ = sub.initialize(generator, input_type, device)
        params = {f"f_{k}": v for k, v in pf.items()}
        params.update({f"b_{k}": v for k, v in pb.items()})
        return params, out

    def forward(self, params, state, x, train=False, seed=None, mask=None):
        x = self._maybe_dropout(x, train, seed)
        gate = act_ops.get(self.gate_activation)
        cell = act_ops.get(self.activation or "tanh")
        pf = {k[2:]: v for k, v in params.items() if k.startswith("f_")}
        pb = {k[2:]: v for k, v in params.items() if k.startswith("b_")}
        hf, _ = rnn_ops.lstm_scan(pf, x, None, mask, gate_act=gate,
                                  cell_act=cell)
        hb, _ = rnn_ops.lstm_scan(pb, x, None, mask, reverse=True,
                                  gate_act=gate, cell_act=cell)
        return hf + hb, state, mask

    def output_type(self, input_type):
        return InputType.recurrent(self.n_out, input_type.timesteps)


@register_layer
@dataclasses.dataclass
class RnnOutputLayer(BaseOutputLayer):
    """Per-time-step dense + loss over [N, T, C]; the score of an example
    sums its (masked) steps."""

    def initialize(self, generator, input_type, device):
        n_in = self.n_in or input_type.size
        params = {"W": self._winit(generator, (n_in, self.n_out), device),
                  "b": self._binit((self.n_out,), device)}
        return params, InputType.recurrent(self.n_out, input_type.timesteps)

    def forward(self, params, state, x, train=False, seed=None, mask=None):
        x = self._maybe_dropout(x, train, seed)
        return self._act(self.preoutput(params, x)), state, mask

    def preoutput(self, params, x):
        return x @ params["W"] + params["b"]

    def compute_score(self, labels, preout, mask=None):
        m = mask[..., None] if mask is not None else None
        return loss_ops.get(self.loss)(labels, preout,
                                       self.activation or "softmax", m)

    def output_type(self, input_type):
        return InputType.recurrent(self.n_out, input_type.timesteps)


@register_layer
@dataclasses.dataclass
class LastTimeStepLayer(Layer):
    """[N, T, C] -> [N, C] at each sequence's last unmasked step (the
    sequential counterpart of DL4J's LastTimeStepVertex)."""

    def initialize(self, generator, input_type, device):
        return {}, self.output_type(input_type)

    def forward(self, params, state, x, train=False, seed=None, mask=None):
        if mask is None:
            return x[:, -1], state, None
        idx = ((mask > 0).sum(dim=1) - 1).clamp_min(0)
        return x[torch.arange(x.shape[0], device=x.device), idx], state, None

    def output_type(self, input_type):
        return InputType.feed_forward(input_type.size)
