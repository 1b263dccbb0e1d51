"""Network configuration — the port of ``deeplearning4j_tpu/nn/conf/network.py``.

The ``NeuralNetConfiguration.builder() … .list() … .build()`` DSL, with
the global-then-per-layer merge, nIn inference and preprocessor insertion
from ``InputType``, and ``MultiLayerConfiguration.to_json`` /
``from_json``.  The JSON is the JAX package's: a configuration written by
either package builds the same network in the other.  ``precision`` is
acted on (``ops/dtypes.py``: bf16 compute over f32 masters), and so are
``precision_infer_quant`` (the model cache's quantized serving),
``gradient_checkpointing`` and ``shape_bucketing``; the global fields this
port does not act on yet (quantized gradients, sharding, distribution)
are kept and written back, not dropped.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf import preprocessors as pp
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType


@dataclasses.dataclass
class GlobalConf:
    """Global hyperparameters, field for field the JAX package's.  The
    inference path reads ``seed`` (the init generator) and the layer
    defaults it merges (``activation``, ``weight_init``, ``bias_init``);
    the micro-batcher reads ``bucket_batch_sizes``."""

    seed: int = 12345
    iterations: int = 1
    learning_rate: float = 1e-1
    bias_learning_rate: Optional[float] = None
    updater: str = "sgd"
    momentum: float = 0.9
    rho: float = 0.95
    rms_decay: float = 0.95
    adam_mean_decay: float = 0.9
    adam_var_decay: float = 0.999
    epsilon: Optional[float] = None
    activation: str = "sigmoid"
    weight_init: str = "xavier"
    bias_init: float = 0.0
    dist: Optional[dict] = None
    l1: float = 0.0
    l2: float = 0.0
    l1_bias: float = 0.0
    l2_bias: float = 0.0
    dropout: float = 0.0
    use_regularization: bool = False
    use_drop_connect: bool = False
    minimize: bool = True
    mini_batch: bool = True
    optimization_algo: str = "stochastic_gradient_descent"
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    lr_policy: Optional[str] = None
    lr_policy_decay_rate: Optional[float] = None
    lr_policy_steps: Optional[float] = None
    lr_policy_power: Optional[float] = None
    learning_rate_schedule: Optional[dict] = None
    precision: Optional[str] = None
    precision_infer_quant: Optional[str] = None
    gradient_checkpointing: bool = False
    shape_bucketing: bool = False
    bucket_batch_sizes: Optional[List[int]] = None
    bucket_time_sizes: Optional[List[int]] = None
    pipeline_workers: int = 1
    pipeline_prefetch: int = 4
    pipeline_staging_depth: Optional[int] = None
    ft_resume: bool = False
    ft_reader_retries: int = 0
    ft_checkpoint_dir: Optional[str] = None
    sharding_enabled: bool = False
    sharding_data: int = -1
    sharding_fsdp: int = 1
    sharding_model: int = 1
    sharding_replicate_below: int = 2048
    dist_enabled: bool = False
    dist_processes: int = 0
    dist_coordinator: Optional[str] = None
    dist_heartbeat_ms: float = 250.0
    dist_lease_ms: float = 2000.0
    dist_grad_quant: Optional[str] = None


_MERGE_FIELDS = [
    "activation", "weight_init", "bias_init", "dist", "learning_rate",
    "bias_learning_rate", "l1", "l2", "l1_bias", "l2_bias", "dropout",
    "use_drop_connect", "updater", "momentum", "rho", "rms_decay",
    "adam_mean_decay", "adam_var_decay", "epsilon",
    "gradient_normalization", "gradient_normalization_threshold",
]


def merge_layer_conf(layer: L.Layer, g: GlobalConf) -> L.Layer:
    """Fill a layer's unset (None) hyperparams from the global conf."""
    updates = {}
    for f in _MERGE_FIELDS:
        if getattr(layer, f, None) is None and hasattr(g, f):
            updates[f] = getattr(g, f)
    # L1/L2 are inert unless regularization is enabled
    if not g.use_regularization:
        for f in ("l1", "l2", "l1_bias", "l2_bias"):
            updates[f] = 0.0
    return dataclasses.replace(layer, **{k: v for k, v in updates.items()
                                         if hasattr(layer, k)})


@dataclasses.dataclass
class MultiLayerConfiguration:
    layers: List[L.Layer]
    global_conf: GlobalConf
    input_type: Optional[InputType] = None
    preprocessors: Dict[int, pp.InputPreProcessor] = dataclasses.field(
        default_factory=dict)
    backprop: bool = True
    pretrain: bool = False
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20

    def to_dict(self) -> dict:
        return {
            "global": dataclasses.asdict(self.global_conf),
            "layers": [l.to_dict() for l in self.layers],
            "input_type": (self.input_type.to_dict() if self.input_type
                           else None),
            "preprocessors": {str(k): v.to_dict()
                              for k, v in self.preprocessors.items()},
            "backprop": self.backprop,
            "pretrain": self.pretrain,
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @staticmethod
    def from_dict(d: dict) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration(
            layers=[L.Layer.from_dict(ld) for ld in d["layers"]],
            global_conf=GlobalConf(**d["global"]),
            input_type=(InputType.from_dict(d["input_type"])
                        if d.get("input_type") else None),
            preprocessors={int(k): pp.InputPreProcessor.from_dict(v)
                           for k, v in d.get("preprocessors", {}).items()},
            backprop=d.get("backprop", True),
            pretrain=d.get("pretrain", False),
            backprop_type=d.get("backprop_type", "standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
        )

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(json.loads(s))


class NeuralNetConfiguration:
    """Entry point: ``NeuralNetConfiguration.builder()``."""

    @staticmethod
    def builder() -> "Builder":
        return Builder()


class Builder:
    """Fluent setters of the global hyperparameters; the names follow
    the JAX package's builder.  Of its precision tiers the compute policy
    is acted on, the quantization knobs are stored; its sharding and
    distribution knobs, and the reader retries of its fault tolerance,
    are not ported yet."""

    def __init__(self):
        self._g = GlobalConf()

    def seed(self, s):
        self._g.seed = int(s); return self

    def iterations(self, n):
        self._g.iterations = int(n); return self

    def learning_rate(self, lr):
        self._g.learning_rate = float(lr); return self

    def bias_learning_rate(self, lr):
        self._g.bias_learning_rate = float(lr); return self

    def updater(self, u: str):
        self._g.updater = u.lower(); return self

    def momentum(self, m):
        self._g.momentum = float(m); return self

    def rho(self, r):
        self._g.rho = float(r); return self

    def rms_decay(self, r):
        self._g.rms_decay = float(r); return self

    def adam_mean_decay(self, b):
        self._g.adam_mean_decay = float(b); return self

    def adam_var_decay(self, b):
        self._g.adam_var_decay = float(b); return self

    def epsilon(self, e):
        self._g.epsilon = float(e); return self

    def activation(self, a: str):
        self._g.activation = a; return self

    def weight_init(self, w: str):
        self._g.weight_init = w; return self

    def bias_init(self, b):
        self._g.bias_init = float(b); return self

    def regularization(self, on: bool = True):
        self._g.use_regularization = bool(on); return self

    def l1(self, v):
        self._g.l1 = float(v); return self

    def l2(self, v):
        self._g.l2 = float(v); return self

    def drop_out(self, v):
        self._g.dropout = float(v); return self

    def use_drop_connect(self, on: bool = True):
        self._g.use_drop_connect = bool(on); return self

    def minimize(self, on: bool = True):
        self._g.minimize = bool(on); return self

    def mini_batch(self, on: bool = True):
        self._g.mini_batch = bool(on); return self

    def optimization_algo(self, algo: str):
        self._g.optimization_algo = algo.lower(); return self

    def gradient_normalization(self, mode: str, threshold: float = 1.0):
        self._g.gradient_normalization = mode
        self._g.gradient_normalization_threshold = float(threshold)
        return self

    _UNSET = object()

    def precision(self, p=_UNSET, *, compute: Optional[str] = None,
                  infer_quant=_UNSET, grad_allreduce=_UNSET):
        """Precision tiers, as the JAX package's builder (:316-336).
        ``compute`` (or the positional ``p``): the compute policy of both
        engines (``ops/dtypes.py``) — 'bfloat16' (bf16 activations and
        conv / matmul inputs, f32 accumulation, f32 master params and
        updater state), 'float32', 'float64', or None / 'auto' (float32
        on this port's devices).  ``infer_quant`` ('int8' | 'fp8'):
        weight-only quantized serving, applied by ``server/model_cache``
        when it loads the model (``quantize_inference``).
        ``grad_allreduce`` ('int8') is stored and written to the
        configuration, not acted on yet: it waits for distributed
        training (ROADMAP A8)."""
        if compute is not None:
            self._g.precision = compute
        elif p is not Builder._UNSET:
            self._g.precision = p
        if infer_quant is not Builder._UNSET:
            self._g.precision_infer_quant = infer_quant
        if grad_allreduce is not Builder._UNSET:
            self._g.dist_grad_quant = grad_allreduce
        return self

    def gradient_checkpointing(self, on: bool = True):
        """Recompute each layer's (vertex's) forward in the backward pass
        instead of keeping its activations (``torch.utils.checkpoint``):
        more work for less activation memory (JAX :341-346)."""
        self._g.gradient_checkpointing = bool(on)
        return self

    def shape_bucketing(self, on: bool = True, batch_sizes=None,
                        time_sizes=None):
        """Pad ragged batch and time dims up to a bucket ladder (powers of
        two unless given), with exact masks (``ops/bucketing.py``; JAX
        :348-358)."""
        self._g.shape_bucketing = bool(on)
        if batch_sizes is not None:
            self._g.bucket_batch_sizes = [int(s) for s in batch_sizes]
        if time_sizes is not None:
            self._g.bucket_time_sizes = [int(s) for s in time_sizes]
        return self

    def input_pipeline(self, workers: Optional[int] = None,
                       prefetch: Optional[int] = None,
                       staging_depth: Optional[int] = None):
        """Tune the async input pipeline ``fit`` wraps iterators with:
        ``workers`` parallel ETL threads (0 disables the wrapper),
        ``prefetch`` raw batches queued ahead, ``staging_depth``
        transformed batches that may wait on the host for the step (each
        is staged onto the device as the step takes it)."""
        if workers is not None:
            self._g.pipeline_workers = int(workers)
        if prefetch is not None:
            self._g.pipeline_prefetch = int(prefetch)
        if staging_depth is not None:
            self._g.pipeline_staging_depth = int(staging_depth)
        return self

    def fault_tolerance(self, resume: Optional[bool] = None,
                        checkpoint_dir=None):
        """Crash-safe training: under ``resume=True`` a fresh network's
        ``fit`` restores the newest valid checkpoint (written by an
        attached ``CheckpointListener``, or found in ``checkpoint_dir``)
        and skips the input it had trained on (``nn/checkpoint.py``)."""
        if resume is not None:
            self._g.ft_resume = bool(resume)
        if checkpoint_dir is not None:
            self._g.ft_checkpoint_dir = str(checkpoint_dir)
        return self

    def list(self) -> "ListBuilder":
        return ListBuilder(self._g)


class ListBuilder:
    def __init__(self, g: GlobalConf):
        self._g = g
        self._layers: List[L.Layer] = []
        self._input_type: Optional[InputType] = None
        self._preprocs: Dict[int, pp.InputPreProcessor] = {}
        self._backprop = True
        self._pretrain = False
        self._bp_type = "standard"
        self._tbptt_f = 20
        self._tbptt_b = 20

    def layer(self, idx_or_layer, layer: Optional[L.Layer] = None
              ) -> "ListBuilder":
        if layer is None:
            self._layers.append(idx_or_layer)
        else:
            idx = int(idx_or_layer)
            while len(self._layers) <= idx:
                self._layers.append(None)  # type: ignore
            self._layers[idx] = layer
        return self

    def set_input_type(self, it: InputType) -> "ListBuilder":
        self._input_type = it
        return self

    def input_pre_processor(self, idx: int, proc: pp.InputPreProcessor
                            ) -> "ListBuilder":
        self._preprocs[idx] = proc
        return self

    def backprop(self, on: bool) -> "ListBuilder":
        self._backprop = on
        return self

    def pretrain(self, on: bool) -> "ListBuilder":
        self._pretrain = on
        return self

    def backprop_type(self, t: str) -> "ListBuilder":
        """'standard' or 'truncatedbptt' (TBPTT: ``fit`` steps once per
        segment of ``t_bptt_forward_length`` steps, carrying RNN state)."""
        self._bp_type = t.lower()
        return self

    def t_bptt_forward_length(self, n: int) -> "ListBuilder":
        self._tbptt_f = int(n)
        return self

    def t_bptt_backward_length(self, n: int) -> "ListBuilder":
        self._tbptt_b = int(n)
        return self

    def build(self) -> MultiLayerConfiguration:
        if any(l is None for l in self._layers):
            raise ValueError("Gap in layer indices")
        layers = [merge_layer_conf(l, self._g) for l in self._layers]
        preprocs = dict(self._preprocs)
        if self._input_type is not None:
            layers, preprocs = _infer_shapes(layers, self._input_type,
                                             preprocs)
        return MultiLayerConfiguration(
            layers=layers, global_conf=self._g, input_type=self._input_type,
            preprocessors=preprocs, backprop=self._backprop,
            pretrain=self._pretrain, backprop_type=self._bp_type,
            tbptt_fwd_length=self._tbptt_f, tbptt_back_length=self._tbptt_b)


def _needs(layer: L.Layer) -> str:
    """Which input family a layer consumes: 'ff' | 'cnn' | 'rnn' | 'any'."""
    if isinstance(layer, (L.ConvolutionLayer, L.SubsamplingLayer,
                          L.ZeroPaddingLayer, L.LocalResponseNormalization)):
        return "cnn"
    if isinstance(layer, (L.GravesLSTM, L.GravesBidirectionalLSTM,
                          L.RnnOutputLayer)):
        return "rnn"
    if isinstance(layer, (L.DenseLayer, L.EmbeddingLayer)):
        return "ff"
    return "any"


def _adapter(cur: InputType, needed: str) -> Optional[pp.InputPreProcessor]:
    if needed == "any" or cur.kind == needed or (
            needed == "ff" and cur.kind == "cnnflat"):
        return None
    if cur.kind == "cnn" and needed == "ff":
        return pp.CnnToFeedForwardPreProcessor(cur.height, cur.width,
                                               cur.channels)
    if cur.kind == "cnnflat" and needed == "cnn":
        return pp.FeedForwardToCnnPreProcessor(cur.height, cur.width,
                                               cur.channels)
    if cur.kind == "ff" and needed == "rnn":
        return pp.FeedForwardToRnnPreProcessor(cur.timesteps)
    if cur.kind == "rnn" and needed == "ff":
        return pp.RnnToFeedForwardPreProcessor()
    if cur.kind == "cnn" and needed == "rnn":
        return pp.CnnToRnnPreProcessor()
    if cur.kind == "rnn" and needed == "cnn":
        raise ValueError(
            "RnnToCnn requires explicit preprocessor with target shape")
    raise ValueError(f"No automatic preprocessor from {cur.kind} to {needed}")


def _infer_shapes(layers: List[L.Layer], input_type: InputType,
                  preprocs: Dict[int, pp.InputPreProcessor]):
    """Walk the stack inferring nIn (and BatchNormalization's
    ``n_features``) and inserting preprocessors."""
    cur = input_type
    out_layers = []
    for i, layer in enumerate(layers):
        if i not in preprocs:
            adapter = _adapter(cur, _needs(layer))
            if adapter is not None:
                preprocs[i] = adapter
        if i in preprocs:
            cur = preprocs[i].output_type(cur)
        updates = {}
        if getattr(layer, "n_in", 0) is None:
            updates["n_in"] = (cur.flat_size() if cur.kind != "cnn"
                               else cur.channels)
        if isinstance(layer, L.BatchNormalization) and \
                layer.n_features is None:
            updates["n_features"] = (cur.channels if cur.kind == "cnn"
                                     else cur.flat_size())
        if updates:
            layer = dataclasses.replace(layer, **updates)
        out_layers.append(layer)
        cur = layer.output_type(cur)
    return out_layers, preprocs
