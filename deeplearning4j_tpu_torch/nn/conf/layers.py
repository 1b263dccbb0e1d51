"""Layer configuration types — the port of ``deeplearning4j_tpu/nn/conf/layers.py``.

As in the JAX package each config is a dataclass that is both the
JSON-serializable hyperparameter record and the layer's implementation:
``initialize`` draws the layer's params, ``forward`` applies it.  The
fields and their JSON are the JAX package's, so a configuration written
by either package builds the same layers in the other.

Ported so far: ``DenseLayer``, ``OutputLayer``, ``LossLayer``,
``ActivationLayer``, ``DropoutLayer``, ``EmbeddingLayer``; the
convolutional family ``ConvolutionLayer``, ``SubsamplingLayer``,
``ZeroPaddingLayer``, ``BatchNormalization``,
``LocalResponseNormalization`` and ``GlobalPoolingLayer``; the recurrent
family ``GravesLSTM``, ``GravesBidirectionalLSTM``, ``RnnOutputLayer`` and
``LastTimeStepLayer`` (sequences [N, T, C], masks [N, T]); and
``SelfAttentionLayer``, whose core goes through ``parallel/sequence``;
and ``FrozenLayerConf``, the transfer-learning wrapper (``unfrozen``
gives the layer it wraps, for type dispatch).  ``nn/conf/layers_pretrain.py``
registers the pretrain layers (``AutoEncoder``, ``RBM``,
``VariationalAutoencoder``), ``CenterLossOutputLayer`` and the 1D conv
family.
``initialize`` returns ``(params, output type)`` and ``initial_state``
the layer's starting state (BatchNormalization's running ``mean`` and
``var``; empty for the others), which the JAX package's ``initialize``
returns as the middle of its triple.
``forward(params, state, x, train, seed, mask)`` returns ``(output,
new_state, mask)`` as in the JAX package: ``state`` is the layer's dict
of carried state (a recurrent layer's ``rnn_state``, batch norm's running
statistics), ``mask`` the time mask.  It runs inference unless ``train`` is set; in training a layer
with ``dropout`` drops its INPUT, as DL4J does, from the two seed words
the network hands it for the step, or under ``use_drop_connect`` drops
its weights ``W`` instead (DenseLayer, ConvolutionLayer and the output
layers).  A configuration naming any other layer type raises on load.
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
from deeplearning4j_tpu_torch.ops import normalization as norm_ops
from deeplearning4j_tpu_torch.ops import recurrent as rnn_ops
from deeplearning4j_tpu_torch.parallel import sequence as seq_ops

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

    def has_params(self) -> bool:
        return True

    def is_pretrain_layer(self) -> bool:
        """Whether ``pretrain`` trains this layer unsupervised (the layers
        of ``nn/conf/layers_pretrain.py``)."""
        return False

    def initialize(self, generator: torch.Generator, input_type: InputType,
                   device: torch.device) -> Tuple[dict, InputType]:
        raise NotImplementedError

    def initial_state(self, input_type: InputType,
                      device: torch.device) -> dict:
        """The layer's state before any step, given its input type."""
        return {}

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
        Under DropConnect the probability applies to the weights instead
        (:meth:`_maybe_drop_connect`)."""
        if self.use_drop_connect:
            return x
        if train and self.dropout and 0.0 < self.dropout < 1.0 \
                and seed is not None:
            return helper_ops.dropout(x, self.dropout, seed)
        return x

    def _maybe_drop_connect(self, params: dict, train: bool, seed) -> dict:
        """DropConnect (Wan et al.; ref: util/Dropout.java
        applyDropConnect): in training, each weight of ``W`` kept with the
        retain probability ``dropout`` and divided by it; biases intact."""
        if not (self.use_drop_connect and train and self.dropout
                and 0.0 < self.dropout < 1.0 and seed is not None
                and "W" in params):
            return params
        return {**params,
                "W": helper_ops.drop_connect(params["W"], self.dropout, seed)}

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
        p = self._maybe_drop_connect(params, train, seed)
        return self._act(torch.addmm(p["b"], x, p["W"])), state, mask

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
class LossLayer(Layer):
    """Loss without params: the activation on the raw input, and the loss
    on it (ref: nn/conf/layers/LossLayer.java)."""

    loss: str = "mcxent"

    def has_params(self):
        return False

    def initialize(self, generator, input_type, device):
        return {}, input_type

    def forward(self, params, state, x, train=False, seed=None, mask=None):
        return self._act(x), state, mask

    def output_type(self, input_type):
        return input_type

    def compute_score(self, labels, preout, mask=None):
        return loss_ops.get(self.loss)(labels, preout,
                                       self.activation or "identity", mask)

    def preoutput(self, params, x):
        return x


@register_layer
@dataclasses.dataclass
class ActivationLayer(Layer):
    """The activation alone (ref: nn/conf/layers/ActivationLayer.java)."""

    def has_params(self):
        return False

    def initialize(self, generator, input_type, device):
        return {}, input_type

    def forward(self, params, state, x, train=False, seed=None, mask=None):
        return self._act(x), state, mask

    def output_type(self, input_type):
        return input_type


@register_layer
@dataclasses.dataclass
class DropoutLayer(Layer):
    """Dropout alone (ref: nn/conf/layers/DropoutLayer.java), through
    ``_maybe_dropout``: the threshold-hash kernel with the layer's seed
    words at or above its gate."""

    def has_params(self):
        return False

    def initialize(self, generator, input_type, device):
        return {}, input_type

    def forward(self, params, state, x, train=False, seed=None, mask=None):
        return self._maybe_dropout(x, train, seed), state, mask

    def output_type(self, input_type):
        return input_type


@register_layer
@dataclasses.dataclass
class EmbeddingLayer(Layer):
    """Row lookup: integer indices [N] (or [N, 1]) gather rows of ``W``
    [vocab, n_out]; float input is taken as one-hot [N, vocab] and
    multiplied (ref: EmbeddingLayer.java, a dense layer on one-hot
    input).  Then + b and the activation."""

    n_in: Optional[int] = None  # vocab size
    n_out: int = 0

    def initialize(self, generator, input_type, device):
        n_in = self.n_in or input_type.flat_size()
        params = {"W": self._winit(generator, (n_in, self.n_out), device),
                  "b": self._binit((self.n_out,), device)}
        return params, InputType.feed_forward(self.n_out)

    def forward(self, params, state, x, train=False, seed=None, mask=None):
        if not torch.is_floating_point(x):
            idx = x.reshape(x.shape[0]) if x.ndim > 1 else x
            emb = params["W"][idx.long()]
        else:
            emb = x @ params["W"]
        return self._act(emb + params["b"]), state, mask

    def output_type(self, input_type):
        return InputType.feed_forward(self.n_out)


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
        p = self._maybe_drop_connect(params, train, seed)
        return helper_ops.conv2d_bias_act(
            x, p["W"], p["b"], tuple(self.stride),
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

    def has_params(self):
        return False

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


@register_layer
@dataclasses.dataclass
class ZeroPaddingLayer(Layer):
    """Zeros around NCHW's spatial dims (ref: ZeroPaddingLayer.java)."""

    pad: Tuple[int, int, int, int] = (0, 0, 0, 0)  # top, bottom, left, right

    def has_params(self):
        return False

    def initialize(self, generator, input_type, device):
        return {}, self.output_type(input_type)

    def forward(self, params, state, x, train=False, seed=None, mask=None):
        t, b, l, r = self.pad
        return conv_ops.zero_pad2d(x, t, b, l, r), state, mask

    def output_type(self, input_type):
        t, b, l, r = self.pad
        return InputType.convolutional(input_type.height + t + b,
                                       input_type.width + l + r,
                                       input_type.channels)


@register_layer
@dataclasses.dataclass
class BatchNormalization(Layer):
    """Batch norm over feature axis 1 of [N, C] or NCHW
    (ref: BatchNormalization.java:228).  It applies NO activation unless
    one is set: ``activation`` defaults to identity rather than inheriting
    the global default.  ``gamma`` / ``beta`` are params (none under
    ``lock_gamma_beta``); the running ``mean`` and ``var`` are state,
    which a training forward returns updated (``ops/normalization``) and
    inference reads."""

    activation: Optional[str] = "identity"
    decay: float = 0.9
    eps: float = 1e-5
    lock_gamma_beta: bool = False
    n_features: Optional[int] = None

    def _nfeat(self, input_type):
        return self.n_features or (
            input_type.channels if input_type.kind == "cnn"
            else input_type.flat_size())

    def initialize(self, generator, input_type, device):
        n = self._nfeat(input_type)
        params = {} if self.lock_gamma_beta else {
            "gamma": torch.ones((n,), dtype=torch.float32, device=device),
            "beta": torch.zeros((n,), dtype=torch.float32, device=device)}
        return params, input_type

    def initial_state(self, input_type, device):
        n = self._nfeat(input_type)
        return {"mean": torch.zeros((n,), dtype=torch.float32, device=device),
                "var": torch.ones((n,), dtype=torch.float32, device=device)}

    def forward(self, params, state, x, train=False, seed=None, mask=None):
        n = state["mean"].shape[0]
        gamma = params.get("gamma")
        if gamma is None:
            gamma = torch.ones((n,), dtype=x.dtype, device=x.device)
        beta = params.get("beta")
        if beta is None:
            beta = torch.zeros((n,), dtype=x.dtype, device=x.device)
        if train:
            y, m, v = norm_ops.batch_norm_train(
                x, gamma, beta, state["mean"], state["var"],
                decay=self.decay, eps=self.eps)
            return self._act(y), {"mean": m, "var": v}, mask
        y = norm_ops.batch_norm_infer(x, gamma, beta, state["mean"],
                                      state["var"], eps=self.eps)
        return self._act(y), state, mask

    def output_type(self, input_type):
        return input_type


@register_layer
@dataclasses.dataclass
class LocalResponseNormalization(Layer):
    """Across-channel LRN on NCHW (ref: LocalResponseNormalization.java:69)."""

    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75

    def has_params(self):
        return False

    def initialize(self, generator, input_type, device):
        return {}, input_type

    def forward(self, params, state, x, train=False, seed=None, mask=None):
        return norm_ops.local_response_norm(
            x, k=self.k, n=self.n, alpha=self.alpha, beta=self.beta), \
            state, mask

    def output_type(self, input_type):
        return input_type


@register_layer
@dataclasses.dataclass
class GlobalPoolingLayer(Layer):
    """Collapse the spatial dims of NCHW or the time dim of [N, T, C]
    (ref: GlobalPoolingLayer.java); over time it drops masked steps
    (MaskedReductionUtil) and consumes the mask."""

    pooling_type: str = "max"
    pnorm: int = 2
    collapse_dimensions: bool = True

    def has_params(self):
        return False

    def initialize(self, generator, input_type, device):
        return {}, self.output_type(input_type)

    def forward(self, params, state, x, train=False, seed=None, mask=None):
        if x.ndim == 4:
            y = conv_ops.global_pool(x, self.pooling_type, (2, 3), self.pnorm)
        elif x.ndim == 3:
            m = mask[..., None] if mask is not None else None
            y = conv_ops.global_pool(x, self.pooling_type, (1,), self.pnorm,
                                     m)
        else:
            y = x
        return y, state, None

    def output_type(self, input_type):
        if input_type.kind == "cnn":
            return InputType.feed_forward(input_type.channels)
        if input_type.kind == "rnn":
            return InputType.feed_forward(input_type.size)
        return input_type


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

    def has_params(self):
        return False

    def initialize(self, generator, input_type, device):
        return {}, self.output_type(input_type)

    def forward(self, params, state, x, train=False, seed=None, mask=None):
        if mask is None:
            return x[:, -1], state, None
        idx = ((mask > 0).sum(dim=1) - 1).clamp_min(0)
        return x[torch.arange(x.shape[0], device=x.device), idx], state, None

    def output_type(self, input_type):
        return InputType.feed_forward(input_type.size)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

@register_layer
@dataclasses.dataclass
class SelfAttentionLayer(Layer):
    """Multi-head self-attention over recurrent input [N, T, C]: q, k, v
    projections, the core of ``parallel/sequence.attention`` (the flash
    kernels where ``ops/helpers.attention_wanted`` takes the shape, the
    dense softmax otherwise), the output projection, the activation and
    the time mask.

    Under ``parallel/sequence.kv_decode_scope`` (entered by
    ``rnn_time_step``) the layer decodes incrementally instead: each new
    token appends its K/V to a per-stream ring of ``cache_window`` entries,
    carried as the layer's ``rnn_state``, and attends over the valid
    entries (``attend_cached``).  Decoding is causal; with ``cache_window``
    at least the stream's length it equals causal ``output()``.
    ``cache_window=None`` becomes the declared input timesteps at init (128
    when variable).  Under ``parallel/sequence.paged_scope`` (the decode
    pool's paged KV arena) the K/V pages live in a pool-shared arena
    instead, and the carry holds ``{"aid", "pos", "tbl"}``: the arena id,
    encoded in the trailing dimension of the ``aid`` leaf (a shape
    survives a carry template, values do not), the write position and the
    block table (``attend_paged``)."""

    n_in: Optional[int] = None
    n_out: int = 0
    n_heads: int = 1
    causal: bool = False
    strategy: str = "auto"      # auto | ring | ulysses | dense
    project_output: bool = True
    cache_window: Optional[int] = None   # KV-ring length for decode

    def initialize(self, generator, input_type, device):
        n_in = self.n_in or input_type.size
        if self.n_out % self.n_heads:
            raise ValueError(f"n_out={self.n_out} % n_heads={self.n_heads}")
        if self.cache_window is None:
            self.cache_window = int(input_type.timesteps or 128)
        params = {
            "Wq": self._winit(generator, (n_in, self.n_out), device),
            "Wk": self._winit(generator, (n_in, self.n_out), device),
            "Wv": self._winit(generator, (n_in, self.n_out), device),
            "bq": self._binit((self.n_out,), device),
            "bk": self._binit((self.n_out,), device),
            "bv": self._binit((self.n_out,), device),
        }
        if self.project_output:
            params["Wo"] = self._winit(generator, (self.n_out, self.n_out),
                                       device)
            params["bo"] = self._binit((self.n_out,), device)
        return params, InputType.recurrent(self.n_out, input_type.timesteps)

    def forward(self, params, state, x, train=False, seed=None, mask=None):
        x = self._maybe_dropout(x, train, seed)
        B, T, _ = x.shape
        H, Dh = self.n_heads, self.n_out // self.n_heads

        def split(a):  # [B, T, n_out] -> [B, H, T, Dh]
            return a.reshape(B, T, H, Dh).transpose(1, 2)

        q = split(x @ params["Wq"] + params["bq"])
        k = split(x @ params["Wk"] + params["bk"])
        v = split(x @ params["Wv"] + params["bv"])
        new_state = state
        if seq_ops.kv_decode_active() and not train:
            W = int(self.cache_window or 128)
            tape = seq_ops.paged_tape()
            prev = state.get("rnn_state") if state else None
            if tape is not None:
                aid, arena, tbl = tape.next_layer(H, Dh, W, x.dtype)
                pos = (prev["pos"] if isinstance(prev, dict)
                       and "pos" in prev else
                       torch.zeros((B,), dtype=torch.int64, device=x.device))
                if tape.template:
                    _, nbs = seq_ops.block_geometry(W, tape.block_size)
                    tbl = torch.zeros((B, nbs), dtype=torch.int64,
                                      device=x.device)
                    out = torch.zeros_like(q)
                elif tape.record_undo:
                    out, pos, journal = seq_ops.attend_paged(
                        q, k, v, pos, tbl, arena, window=W, key_mask=mask,
                        undo=True)
                    tape.put_undo(aid, journal)
                else:
                    out, pos = seq_ops.attend_paged(
                        q, k, v, pos, tbl, arena, window=W, key_mask=mask)
                ring = {"aid": torch.full((B, aid + 1), aid,
                                          dtype=torch.int64,
                                          device=x.device),
                        "pos": pos, "tbl": tbl}
            else:
                ring = prev if prev is not None else seq_ops.kv_ring_init(
                    B, H, W, Dh, x.dtype, x.device)
                out, ring = seq_ops.attend_cached(q, k, v, ring,
                                                  key_mask=mask)
            new_state = {**(state or {}), "rnn_state": ring}
        else:
            out = seq_ops.attention(q, k, v, causal=self.causal,
                                    key_mask=mask, strategy=self.strategy)
        out = out.transpose(1, 2).reshape(B, T, self.n_out)
        if self.project_output:
            out = out @ params["Wo"] + params["bo"]
        out = self._act(out)
        if mask is not None:
            out = out * mask[:, :, None].to(out.dtype)
        return out, new_state, mask

    def output_type(self, input_type):
        return InputType.recurrent(self.n_out, input_type.timesteps)


@register_layer
@dataclasses.dataclass
class FrozenLayerConf(Layer):
    """Wraps another layer whose params training leaves as they are
    (ref: nn/layers/FrozenLayer.java; transfer learning).  Its JSON is the
    JAX package's, ``{"@class": "FrozenLayerConf", "inner": {...}}``.  The
    forward is the inner layer's with ``train`` off, so a frozen layer
    drops nothing and a frozen batch norm reads and keeps its running
    statistics.  The engines skip the wrapper's params in the gradient
    and the update.  Its own hyperparameters (``l1``, ``l2``,
    ``updater``, ...) are the wrapper's, unset unless given, as in the
    JAX package: the inner layer's regularization does not reach the
    score, and its updater state is the wrapper's rule's."""

    inner: Optional[dict] = None  # the serialized inner layer

    def _inner(self) -> Layer:
        """The inner layer, built once from ``inner``."""
        built = self.__dict__.get("_built")
        if built is None:
            built = Layer.from_dict(self.inner)
            self.__dict__["_built"] = built
        return built

    def has_params(self):
        return self._inner().has_params()

    def initialize(self, generator, input_type, device):
        return self._inner().initialize(generator, input_type, device)

    def initial_state(self, input_type, device):
        return self._inner().initial_state(input_type, device)

    def forward(self, params, state, x, train=False, seed=None, mask=None):
        return self._inner().forward(params, state, x, False, seed, mask)

    def output_type(self, input_type):
        return self._inner().output_type(input_type)

    @staticmethod
    def wrap(layer: Layer) -> "FrozenLayerConf":
        return FrozenLayerConf(inner=layer.to_dict())


def unfrozen(layer: Layer) -> Layer:
    """The layer a :class:`FrozenLayerConf` wraps, or ``layer`` itself:
    what a dispatch on the layer's type looks at."""
    return layer._inner() if isinstance(layer, FrozenLayerConf) else layer
