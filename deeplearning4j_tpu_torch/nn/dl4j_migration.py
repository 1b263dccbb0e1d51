"""Migrate checkpoints written by the ORIGINAL DL4J (0.x Java) — the port of
``deeplearning4j_tpu/nn/dl4j_migration.py``, numpy, ``struct``, ``json``
and ``zipfile`` over the port's layer classes.  ``nn/serialization.py``
round-trips this framework's own zips and routes a Java-schema zip here;
the restored network's params, layer state and updater state are tensors
on its device (CUDA unless the caller asks for the CPU).  A zip either
package exports restores in the other to equal params.

The exporters store ``coefficients.bin`` and ``updaterState.bin``
uncompressed, as the port's own zips store their float arrays
(``nn/serialization.py``): deflate barely shrinks float32 weights and
costs host time in proportion to their size (the JAX package deflates
them); every zip reader, the Java DL4J's included, takes either.

One guard the JAX package lacks: DL4J's UpdaterBlock never merges a
pretrain layer's params with its neighbours' and splits blocks on a
Nesterovs ``momentumSchedule`` (UpdaterUtils.java:110-137), and a pretrain
layer's views (``vb``, the VAE's encoder and decoder) are not the dense
``W``, ``b`` pair.  Neither rule is replayed here, so a pretrain layer
(AutoEncoder, RBM, VariationalAutoencoder) or a momentum schedule raises a
``ValueError`` naming the layer, on restore and on export, instead of
slicing ``coefficients.bin`` or ``updaterState.bin`` wrongly; so does any
other layer with params whose views this module does not know.

Format (ref: util/ModelSerializer.java:79-120): a zip with
``configuration.json`` (Jackson MultiLayerConfiguration, wrapper-object
typed layers — nn/conf/layers/Layer.java:47 @JsonTypeInfo WRAPPER_OBJECT),
``coefficients.bin`` (legacy ``Nd4j.write``: shapeInfo DataBuffer then data
DataBuffer, each ``writeUTF(allocationMode) writeInt(length)
writeUTF(dtype) big-endian elements``), and optionally
``updaterState.bin``.

Parameter layout (ref: nn/params/DefaultParamInitializer.java:60-99): the
flat params row is the per-layer concatenation, each layer contributing
its views in initializer order — Dense/Output/Embedding: W [nIn,nOut]
then b, **'f' (column-major) flattened** (weights/WeightInitUtil.java:40
DEFAULT_WEIGHT_INIT_ORDER='f'); Convolution: b FIRST then W
[nOut,nIn,kH,kW] reshaped **'c'** — the one row-major exception
(nn/params/ConvolutionParamInitializer.java:76-80); BatchNorm: gamma, beta,
mean, var (nn/params/BatchNormalizationParamInitializer.java:59-80);
GravesLSTM: W [nIn,4H], RW [H,4H+3] (last 3 cols = peepholes wFF, wOO,
wGG), b [4H], gate order IFOG
(nn/params/GravesLSTMParamInitializer.java:60-148,
nn/layers/recurrent/LSTMHelpers.java:62).

LSTM gate-block mapping: DL4J's IFOG column order is [input(candidate,
LAYER activation fn), forget, output, inputMod(SIGMOID multiplier)] —
LSTMHelpers.java:180-226 applies activationFn to block 0 and
gateActivationFn to block 3, and block 3 is the multiplier on the
candidate in the cell update (``c = f*c_prev + inputMod*input``).  This
framework's cell order is [i(sigmoid multiplier), f, o, g(tanh
candidate)] (ops/recurrent.py) — blocks 0 and 3 swap ROLES.  Migration
therefore permutes column blocks 0↔3 of W, RW and b in both directions
(:func:`_swap_ifog_blocks`, an involution).  After the permutation the
peephole mapping is semantically EXACT: wFF→pF (prev cell → forget),
wOO→pO (current cell → output, LSTMHelpers.java:226-228), wGG→pI (prev
cell → sigmoid multiplier, LSTMHelpers.java:202-209) — migrated LSTMs
match DL4J forward activations with NONZERO peepholes
(tests/test_dl4j_migration.py::test_lstm_forward_matches_dl4j_semantics).
"""

from __future__ import annotations

import io
import json
import math
import struct
import zipfile
from typing import BinaryIO, Dict, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf import preprocessors as pp
from deeplearning4j_tpu_torch.nn.conf.network import (GlobalConf,
                                                MultiLayerConfiguration)

# ---------------------------------------------------------------------------
# Legacy Nd4j binary format
# ---------------------------------------------------------------------------

_DTYPES = {"FLOAT": ("f", 4, np.float32), "DOUBLE": ("d", 8, np.float64),
           "INT": ("i", 4, np.int32), "LONG": ("q", 8, np.int64),
           "HALF": ("e", 2, np.float16)}


def _read_utf(stream: BinaryIO) -> str:
    raw = stream.read(2)
    if len(raw) != 2:
        raise ValueError("truncated nd4j stream")
    (n,) = struct.unpack(">H", raw)
    return stream.read(n).decode("utf-8")


def _write_utf(stream: BinaryIO, s: str) -> None:
    b = s.encode("utf-8")
    stream.write(struct.pack(">H", len(b)))
    stream.write(b)


def read_data_buffer(stream: BinaryIO) -> np.ndarray:
    """One legacy DataBuffer: UTF allocation mode, int32 length, UTF
    element type, big-endian elements (BaseDataBuffer.write)."""
    _alloc = _read_utf(stream)  # HEAP/DIRECT/JAVACPP — irrelevant here
    (length,) = struct.unpack(">i", stream.read(4))
    dtype = _read_utf(stream)
    if dtype not in _DTYPES:
        raise ValueError(f"unknown nd4j DataBuffer element type {dtype!r}")
    _, size, np_t = _DTYPES[dtype]
    raw = stream.read(length * size)
    if len(raw) != length * size:
        raise ValueError("truncated nd4j DataBuffer")
    return np.frombuffer(raw, dtype=np.dtype(np_t).newbyteorder(">")).astype(
        np_t)


def write_data_buffer(stream: BinaryIO, arr: np.ndarray,
                      dtype: str = "FLOAT") -> None:
    _write_utf(stream, "HEAP")
    stream.write(struct.pack(">i", arr.size))
    _write_utf(stream, dtype)
    _, _, np_t = _DTYPES[dtype]
    stream.write(np.ascontiguousarray(arr, np_t).astype(
        np.dtype(np_t).newbyteorder(">")).tobytes())


def read_nd4j_array(stream: BinaryIO) -> np.ndarray:
    """Legacy ``Nd4j.write``: shapeInfo buffer then data buffer.
    shapeInfo layout: [rank, shape..., stride..., offset,
    elementWiseStride, order-char]."""
    shape_info = read_data_buffer(stream).astype(np.int64)
    rank = int(shape_info[0])
    shape = tuple(int(d) for d in shape_info[1:1 + rank])
    order = chr(int(shape_info[-1]))
    data = read_data_buffer(stream)
    n = int(np.prod(shape)) if shape else data.size
    return np.reshape(data[:n], shape,
                      order="F" if order == "f" else "C")


def write_nd4j_array(stream: BinaryIO, arr: np.ndarray,
                     order: str = "f") -> None:
    """Inverse of :func:`read_nd4j_array` — used to author DL4J-schema
    fixtures (and to export params a Java DL4J could read back)."""
    arr = np.asarray(arr)
    rank = arr.ndim
    shape = list(arr.shape)
    # strides in elements for the chosen order ('f' matches DL4J params)
    strides = [0] * rank
    acc = 1
    idx = range(rank) if order == "f" else range(rank - 1, -1, -1)
    for i in idx:
        strides[i] = acc
        acc *= shape[i]
    info = [rank] + shape + strides + [0, 1, ord(order)]
    write_data_buffer(stream, np.asarray(info, np.int32), "INT")
    flat = np.ravel(arr, order="F" if order == "f" else "C")
    write_data_buffer(stream, flat,
                      "DOUBLE" if arr.dtype == np.float64 else "FLOAT")


# ---------------------------------------------------------------------------
# configuration.json → builder-DSL confs
# ---------------------------------------------------------------------------

_ACT_NAMES = sorted(
    ["rationaltanh", "rectifiedtanh", "hardsigmoid", "hardtanh",
     "leakyrelu", "softmax", "softplus", "softsign", "sigmoid",
     "identity", "linear", "relu", "tanh", "cube", "elu", "selu",
     "gelu", "swish"],
    key=len, reverse=True)  # longest first: "selu"/"gelu" before "elu"


def _parse_activation(v, default: str = "sigmoid") -> str:
    """activationFn appears as a legacy string ("relu"), a wrapper object
    ({"ReLU": {}} / {".ActivationReLU": {}}), or an @class map."""
    if v is None:
        return default
    if isinstance(v, dict):
        if "@class" in v:
            v = v["@class"]
        else:
            v = next(iter(v), "")
    s = str(v).lower()
    for name in _ACT_NAMES:   # longest/most-specific first in list order
        if name in s:
            return "identity" if name == "linear" else name
    return default


# matched against the name lowercased with "loss"/"_" stripped, longest
# key first, so SQUARED_HINGE beats hinge and KL_DIVERGENCE resolves
_LOSS_MAP = {"negativeloglikelihood": "negativeloglikelihood",
             "squaredhinge": "squared_hinge",
             "cosineproximity": "cosine_proximity",
             "kldivergence": "kl_divergence", "kld": "kl_divergence",
             "poisson": "poisson", "hinge": "hinge",
             "mcxent": "mcxent", "msle": "msle", "mape": "mape",
             "xent": "xent", "mse": "mse", "mae": "mae",
             "l2": "l2", "l1": "l1",
             "squared": "mse", "cosine": "cosine_proximity"}
_LOSS_KEYS_BY_LEN = sorted(_LOSS_MAP, key=len, reverse=True)


def _parse_loss(layer_json: dict, default: str = "mse") -> str:
    v = layer_json.get("lossFn", layer_json.get("lossFunction"))
    if v is None:
        return default
    if isinstance(v, dict):
        v = v.get("@class") or next(iter(v), "")
    s = str(v).lower().replace("loss", "").replace("_", "")
    for k in _LOSS_KEYS_BY_LEN:
        if k in s:
            return _LOSS_MAP[k]
    return default


def _num(v, default=0.0) -> float:
    """Jackson writes unset doubles as NaN (l1/l2 default NaN in
    nn/conf/layers/Layer.java) — treat NaN/None as unset."""
    if v is None:
        return default
    try:
        f = float(v)
    except (TypeError, ValueError):
        return default
    return default if math.isnan(f) else f


def _ints(v, default=(0, 0)) -> Tuple[int, ...]:
    if v is None:
        return tuple(default)
    if isinstance(v, (int, float)):
        return (int(v), int(v))
    return tuple(int(x) for x in v)


def _num_opt(j: dict, key) -> Optional[float]:
    """Present-and-set (non-NaN) numeric field, else None.  Explicit
    zeros are KEPT: a DL4J net saved with momentum=0.0 must not migrate
    to the global default 0.9 (Jackson writes resolved values; only NaN
    means unset)."""
    if key not in j:
        return None
    try:
        f = float(j[key])
    except (TypeError, ValueError):
        return None
    return None if math.isnan(f) else f


def _common_kwargs(j: dict, default_activation: str = "sigmoid") -> dict:
    kw = {}
    if j.get("nIn"):
        kw["n_in"] = int(j["nIn"])
    if j.get("nOut"):
        kw["n_out"] = int(j["nOut"])
    kw["activation"] = _parse_activation(
        j.get("activationFn", j.get("activationFunction")),
        default_activation)
    for src, dst in (("l1", "l1"), ("l2", "l2"), ("l1Bias", "l1_bias"),
                     ("l2Bias", "l2_bias"), ("dropOut", "dropout"),
                     ("learningRate", "learning_rate"),
                     ("biasLearningRate", "bias_learning_rate"),
                     ("momentum", "momentum"), ("rho", "rho"),
                     ("rmsDecay", "rms_decay"),
                     ("adamMeanDecay", "adam_mean_decay"),
                     ("adamVarDecay", "adam_var_decay"),
                     ("epsilon", "epsilon"), ("biasInit", "bias_init")):
        x = _num_opt(j, src)
        if x is not None:
            kw[dst] = x
    wi = j.get("weightInit")
    if wi:
        kw["weight_init"] = str(wi).lower()
    upd = j.get("updater")
    if upd:
        kw["updater"] = _UPDATER_MAP.get(str(upd).lower(), "sgd")
    gn = j.get("gradientNormalization")
    if gn and str(gn) != "None":
        kw["gradient_normalization"] = str(gn).lower()
        t = _num_opt(j, "gradientNormalizationThreshold")
        if t is not None:
            kw["gradient_normalization_threshold"] = t
    return kw


# DL4J's JSON names of its pretrain layers: their params are never merged
# into a neighbour's UpdaterBlock and their views are not W, b
_PRETRAIN_TYPES = ("autoEncoder", "RBM", "variationalAutoencoder",
                   "VariationalAutoencoder")


def _momentum_schedule(j: dict) -> bool:
    """Whether a layer's JSON sets a Nesterovs momentum schedule (DL4J 0.8
    writes it as ``momentumSchedule``, earlier as ``momentumAfter``)."""
    return any(j.get(k) for k in ("momentumSchedule", "momentumAfter"))


def _build_layer(type_name: str, j: dict) -> L.Layer:
    label = j.get("layerName") or type_name
    if type_name in _PRETRAIN_TYPES:
        raise ValueError(
            f"DL4J layer {label!r} ({type_name}) is a pretrain layer: DL4J "
            f"keeps its params out of its neighbours' updater blocks and "
            f"lays out views this migration does not slice")
    if _momentum_schedule(j):
        raise ValueError(
            f"DL4J layer {label!r} ({type_name}) sets a momentum schedule, "
            f"which splits DL4J's updater blocks in a way this migration "
            f"does not replay")
    kw = _common_kwargs(
        j, default_activation="tanh"
        if type_name in ("gravesLSTM", "gravesBidirectionalLSTM")
        else "sigmoid")
    t = type_name
    if t == "dense":
        return L.DenseLayer(**kw)
    if t == "output":
        return L.OutputLayer(loss=_parse_loss(j), **kw)
    if t == "rnnoutput":
        return L.RnnOutputLayer(loss=_parse_loss(j), **kw)
    if t == "loss":
        kw.pop("n_in", None), kw.pop("n_out", None)
        return L.LossLayer(loss=_parse_loss(j), **kw)
    if t == "convolution":
        return L.ConvolutionLayer(
            kernel=_ints(j.get("kernelSize"), (3, 3)),
            stride=_ints(j.get("stride"), (1, 1)),
            padding=_ints(j.get("padding"), (0, 0)),
            dilation=_ints(j.get("dilation"), (1, 1)),
            convolution_mode=str(j.get("convolutionMode",
                                       "truncate")).lower(), **kw)
    if t == "subsampling":
        kw.pop("activation", None)
        kw.pop("n_in", None), kw.pop("n_out", None)
        return L.SubsamplingLayer(
            pooling_type=str(j.get("poolingType", "max")).lower(),
            kernel=_ints(j.get("kernelSize"), (2, 2)),
            stride=_ints(j.get("stride"), (2, 2)),
            padding=_ints(j.get("padding"), (0, 0)),
            pnorm=int(j.get("pnorm", 2) or 2),
            convolution_mode=str(j.get("convolutionMode",
                                       "truncate")).lower(), **kw)
    if t == "batchNormalization":
        kw.pop("n_in", None)
        # DL4J BN applies NO activation regardless of the recorded
        # activationFn (nn/layers/normalization/BatchNormalization.java:228)
        kw.pop("activation", None)
        n_out = kw.pop("n_out", None)
        return L.BatchNormalization(
            activation="identity",
            decay=_num(j.get("decay"), 0.9), eps=_num(j.get("eps"), 1e-5),
            lock_gamma_beta=bool(j.get("lockGammaBeta", False)),
            n_features=n_out, **kw)
    if t == "gravesBidirectionalLSTM":
        return L.GravesBidirectionalLSTM(
            forget_gate_bias_init=_num(j.get("forgetGateBiasInit"), 1.0),
            gate_activation=_parse_activation(j.get("gateActivationFn"),
                                              "sigmoid"), **kw)
    if t == "gravesLSTM":
        return L.GravesLSTM(
            forget_gate_bias_init=_num(j.get("forgetGateBiasInit"), 1.0),
            gate_activation=_parse_activation(j.get("gateActivationFn"),
                                              "sigmoid"), **kw)
    if t == "embedding":
        return L.EmbeddingLayer(**kw)
    if t == "activation":
        kw.pop("n_in", None), kw.pop("n_out", None)
        return L.ActivationLayer(**kw)
    if t == "dropout":
        kw.pop("n_in", None), kw.pop("n_out", None)
        return L.DropoutLayer(**kw)
    if t == "GlobalPooling":
        kw.pop("activation", None)
        kw.pop("n_in", None), kw.pop("n_out", None)
        return L.GlobalPoolingLayer(
            pooling_type=str(j.get("poolingType", "max")).lower(), **kw)
    if t == "zeroPadding":
        kw.pop("activation", None)
        pad = j.get("padding", [0, 0, 0, 0])
        return L.ZeroPaddingLayer(padding=tuple(int(x) for x in pad))
    raise ValueError(f"DL4J layer type {type_name!r} has no migration "
                     f"mapping yet")


_PREPROC_MAP = {
    "cnnToFeedForward": lambda j: pp.CnnToFeedForwardPreProcessor(
        height=int(j.get("inputHeight", 0)), width=int(j.get("inputWidth", 0)),
        channels=int(j.get("numChannels", 0))),
    "feedForwardToCnn": lambda j: pp.FeedForwardToCnnPreProcessor(
        height=int(j.get("inputHeight", 0)), width=int(j.get("inputWidth", 0)),
        channels=int(j.get("numChannels", 0))),
    "rnnToFeedForward": lambda j: pp.RnnToFeedForwardPreProcessor(),
    "feedForwardToRnn": lambda j: pp.FeedForwardToRnnPreProcessor(),
    "rnnToCnn": lambda j: pp.RnnToCnnPreProcessor(
        height=int(j.get("inputHeight", 0)), width=int(j.get("inputWidth", 0)),
        channels=int(j.get("numChannels", 0))),
    # DL4J's CnnToRnn derives T from the runtime minibatch; ours needs
    # it up front.  Import with timesteps=None — the preprocessor itself
    # raises with instructions at first use, so the restore succeeds and
    # the user can attach CnnToRnnPreProcessor(timesteps=T) to
    # conf.preprocessors before running the net
    "cnnToRnn": lambda j: pp.CnnToRnnPreProcessor(),
}


_UPDATER_MAP = {"nesterovs": "nesterovs", "sgd": "sgd", "adam": "adam",
                "adamax": "adamax", "adagrad": "adagrad",
                "adadelta": "adadelta", "rmsprop": "rmsprop",
                "none": "none"}


def config_from_dl4j_json(text: str) -> MultiLayerConfiguration:
    """Jackson MultiLayerConfiguration JSON → our builder-DSL conf
    (schema: nn/conf/MultiLayerConfiguration.java:59-74 — confs[],
    inputPreProcessors, backprop/pretrain, backpropType, tbptt lengths)."""
    top = json.loads(text)
    confs = top.get("confs", [])
    if not confs:
        raise ValueError("configuration.json has no 'confs' — not a "
                         "MultiLayerConfiguration (for a ComputationGraph "
                         "zip use restore_computation_graph / "
                         "config_from_dl4j_graph_json)")

    layers: List[L.Layer] = []
    g = GlobalConf()
    for i, c in enumerate(confs):
        lw = c.get("layer", {})
        if not isinstance(lw, dict) or len(lw) != 1:
            raise ValueError(f"conf {i}: expected wrapper-object layer, "
                             f"got {type(lw).__name__}")
        (tname, lj), = lw.items()
        layers.append(_build_layer(tname, lj))
        if i == 0:
            g.seed = int(c.get("seed", 0) or 0)
            g.minimize = bool(c.get("minimize", True))
            g.mini_batch = bool(c.get("miniBatch", True))
            g.use_regularization = bool(c.get("useRegularization", False))
            lr = _num(lj.get("learningRate"))
            if lr:
                g.learning_rate = lr
            upd = str(lj.get("updater", "sgd")).lower()
            g.updater = _UPDATER_MAP.get(upd, "sgd")
            mom = _num(lj.get("momentum"))
            if mom:
                g.momentum = mom

    # global-then-override merge (nn/conf/network.merge_layer_conf):
    # fills unset updater/momentum/etc from the global conf and zeroes
    # l1/l2 when useRegularization=false — without this, migrated nets
    # would fine-tune with plain SGD regardless of the saved updater
    from deeplearning4j_tpu_torch.nn.conf.network import merge_layer_conf
    layers = [merge_layer_conf(l, g) for l in layers]

    preprocs = {}
    for k, v in (top.get("inputPreProcessors") or {}).items():
        if isinstance(v, dict) and len(v) == 1:
            (pname, pj), = v.items()
            if pname in _PREPROC_MAP:
                preprocs[int(k)] = _PREPROC_MAP[pname](pj)

    return MultiLayerConfiguration(
        layers=layers, global_conf=g, preprocessors=preprocs,
        backprop=bool(top.get("backprop", True)),
        pretrain=bool(top.get("pretrain", False)),
        backprop_type=("truncatedbptt"
                       if str(top.get("backpropType", "")).lower()
                       .startswith("truncated") else "standard"),
        tbptt_fwd_length=int(top.get("tbpttFwdLength", 20)),
        tbptt_back_length=int(top.get("tbpttBackLength", 20)))


# ---------------------------------------------------------------------------
# ComputationGraph configuration.json → graph conf
# ---------------------------------------------------------------------------

def _build_vertex(wrapper: dict):
    """One Jackson GraphVertex (wrapper-object typed,
    nn/conf/graph/GraphVertex.java:38-51) → our GraphVertexConf."""
    from deeplearning4j_tpu_torch.nn.conf import graph_conf as gc
    (vtype, vj), = wrapper.items()
    if vtype == "LayerVertex":
        lconf = vj.get("layerConf") or {}
        lw = lconf.get("layer") or {}
        (tname, lj), = lw.items()
        layer = _build_layer(tname, lj)
        pre = None
        pj = vj.get("preProcessor")
        if isinstance(pj, dict) and len(pj) == 1:
            (pname, pjj), = pj.items()
            if pname in _PREPROC_MAP:
                pre = _PREPROC_MAP[pname](pjj)
        return layer, pre
    if vtype == "MergeVertex":
        return gc.MergeVertex(), None
    if vtype == "ElementWiseVertex":
        return gc.ElementWiseVertex(
            op=str(vj.get("op", "Add")).lower()), None
    if vtype == "SubsetVertex":
        return gc.SubsetVertex(from_idx=int(vj.get("from", 0)),
                               to_idx=int(vj.get("to", 0))), None
    if vtype == "ScaleVertex":
        return gc.ScaleVertex(scale=_num(vj.get("scaleFactor"), 1.0)), None
    if vtype == "ShiftVertex":
        return gc.ShiftVertex(shift=_num(vj.get("shiftFactor"), 0.0)), None
    if vtype == "StackVertex":
        return gc.StackVertex(), None
    if vtype == "UnstackVertex":
        return gc.UnstackVertex(from_idx=int(vj.get("from", 0)),
                                stack_size=int(vj.get("stackSize", 1))), None
    if vtype == "L2Vertex":
        return gc.L2Vertex(), None
    if vtype == "L2NormalizeVertex":
        return gc.L2NormalizeVertex(), None
    if vtype == "LastTimeStepVertex":
        return gc.LastTimeStepVertex(
            mask_input=vj.get("maskArrayInputName")), None
    if vtype == "DuplicateToTimeSeriesVertex":
        return gc.DuplicateToTimeSeriesVertex(
            ts_input=vj.get("inputName")), None
    if vtype == "PreprocessorVertex":
        pj = vj.get("preProcessor") or {}
        if isinstance(pj, dict) and len(pj) == 1:
            (pname, pjj), = pj.items()
            if pname in _PREPROC_MAP:
                return gc.PreprocessorVertex.of(_PREPROC_MAP[pname](pjj)), \
                    None
        raise ValueError(f"unsupported PreprocessorVertex payload: {pj}")
    raise ValueError(f"DL4J graph vertex type {vtype!r} has no migration "
                     f"mapping yet")


def config_from_dl4j_graph_json(text):
    """Jackson ComputationGraphConfiguration JSON (string or parsed
    dict) → our graph conf (schema:
    nn/conf/ComputationGraphConfiguration.java:59-87 —
    networkInputs/networkOutputs, vertices + vertexInputs maps,
    defaultConfiguration)."""
    from deeplearning4j_tpu_torch.nn.conf import graph_conf as gc
    from deeplearning4j_tpu_torch.nn.conf.network import merge_layer_conf
    top = json.loads(text) if isinstance(text, (str, bytes)) else text
    if "vertices" not in top or "networkInputs" not in top:
        raise ValueError("not a DL4J ComputationGraphConfiguration")

    g = GlobalConf()
    default = top.get("defaultConfiguration") or {}
    g.seed = int(default.get("seed", 0) or 0)
    g.minimize = bool(default.get("minimize", True))
    g.mini_batch = bool(default.get("miniBatch", True))
    g.use_regularization = bool(default.get("useRegularization", False))

    vertices = {}
    vertex_inputs = {k: list(v)
                     for k, v in (top.get("vertexInputs") or {}).items()}
    raw_vertices = top.get("vertices") or {}
    # global training hyperparams ride the TOPOLOGICALLY first layer
    # vertex (vertex-map order is builder-insertion order in DL4J and
    # may start with the output layer), matching the MLN path's confs[0]
    first_layer_name = next(
        (n for n in dl4j_graph_topological_order(
            list(top.get("networkInputs") or []), list(raw_vertices),
            vertex_inputs)
         if "LayerVertex" in raw_vertices.get(n, {})), None)
    built_map = {}
    for name, wrapper in raw_vertices.items():
        built_map[name] = _build_vertex(wrapper)
    if first_layer_name is not None:
        first = built_map[first_layer_name][0]
        if first.learning_rate:
            g.learning_rate = first.learning_rate
        if first.updater:
            g.updater = first.updater
        if first.momentum is not None:
            g.momentum = first.momentum
    for name, (built, pre) in built_map.items():
        if isinstance(built, L.Layer):
            layer = merge_layer_conf(built, g)
            vertices[name] = gc.LayerVertex(layer=layer.to_dict())
            if pre is not None:
                # our engine has no per-LayerVertex preprocessor slot;
                # splice a PreprocessorVertex in front (same math)
                pname = f"{name}__pre"
                vertices[pname] = gc.PreprocessorVertex.of(pre)
                vertex_inputs[pname] = vertex_inputs.get(name, [])
                vertex_inputs[name] = [pname]
        else:
            vertices[name] = built

    return gc.ComputationGraphConfiguration(
        network_inputs=list(top.get("networkInputs") or []),
        network_outputs=list(top.get("networkOutputs") or []),
        vertices=vertices, vertex_inputs=vertex_inputs, global_conf=g,
        backprop_type=("truncatedbptt"
                       if str(top.get("backpropType", "")).lower()
                       .startswith("truncated") else "standard"),
        tbptt_fwd_length=int(top.get("tbpttFwdLength", 20)),
        tbptt_back_length=int(top.get("tbpttBackLength", 20)))


def dl4j_graph_topological_order(network_inputs: List[str],
                                 vertex_names: List[str],
                                 vertex_inputs: Dict[str, List[str]]
                                 ) -> List[str]:
    """Replicate ComputationGraph.topologicalSortOrder (:312) exactly:
    indices are assigned inputs-first then vertex-map order; Kahn's with
    a FIFO queue whose initial fill and neighbor expansion iterate in
    ASCENDING index order (Java HashMap<Integer>/HashSet<Integer>
    iterate small non-negative ints in value order).  The flat param row
    is laid out in THIS order, so it must match bit-for-bit."""
    names = list(network_inputs) + list(vertex_names)
    idx = {n: i for i, n in enumerate(names)}
    n = len(names)
    in_edges: Dict[int, set] = {i: set() for i in range(n)}
    out_edges: Dict[int, set] = {i: set() for i in range(n)}
    for name, ins in vertex_inputs.items():
        if name not in idx:
            continue
        for src in ins:
            if src in idx:
                in_edges[idx[name]].add(idx[src])
                out_edges[idx[src]].add(idx[name])
    from collections import deque
    queue = deque(sorted(i for i in range(n) if not in_edges[i]))
    order = []
    while queue:
        nxt = queue.popleft()
        order.append(nxt)
        for v in sorted(out_edges[nxt]):
            in_edges[v].discard(nxt)
            if not in_edges[v]:
                queue.append(v)
    if len(order) != n:
        raise ValueError("cycle in DL4J graph configuration")
    return [names[i] for i in order]


def _tensor(a, device):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def _host(tree):
    """``tree`` (dicts, lists, tuples) with every tensor as a numpy array
    on the host: what the exporters slice."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(t) for t in tree)
    if hasattr(tree, "detach"):
        return tree.detach().cpu().numpy()
    return tree


def restore_computation_graph(path, load_params: bool = True,
                              load_updater: bool = True, device=None):
    """Load a ComputationGraph zip the ORIGINAL DL4J wrote (ref:
    ModelSerializer.restoreComputationGraph; param layout:
    ComputationGraph.java:336-380 — per-vertex views sliced from the
    flat row in topological order), on ``device``.  The updater state
    is made (and migrated) only under ``load_updater``."""
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import LayerVertex
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    with zipfile.ZipFile(path, "r") as zf:
        names = set(zf.namelist())
        if "configuration.json" not in names:
            raise ValueError("not a DL4J model zip: no configuration.json")
        raw = json.loads(zf.read("configuration.json").decode("utf-8"))
        conf = config_from_dl4j_graph_json(raw)
        net = ComputationGraph(conf, device=device)
        net.init()
        if load_params and "coefficients.bin" in names:
            flat = read_nd4j_array(
                io.BytesIO(zf.read("coefficients.bin"))).ravel(order="C")
            # topo order over the ORIGINAL vertex map (before any
            # PreprocessorVertex splicing, which has no params)
            topo = dl4j_graph_topological_order(
                list(raw.get("networkInputs") or []),
                list((raw.get("vertices") or {}).keys()),
                {k: list(v)
                 for k, v in (raw.get("vertexInputs") or {}).items()})
            off = 0
            for vname in topo:
                if vname not in conf.vertices:
                    continue  # a network input
                v = conf.vertices[vname]
                if not isinstance(v, LayerVertex):
                    continue
                layer = v.layer_conf()
                spec = _layer_param_spec(layer)
                if not spec:
                    continue
                total = sum(s[2] for s in spec)
                params, states = params_from_flat(
                    [layer], flat[off:off + total])
                off += total
                merged = dict(net.net_params[vname])
                for k, val in params[0].items():
                    if k in merged and merged[k].shape != val.shape:
                        raise ValueError(
                            f"vertex {vname} param {k}: DL4J shape "
                            f"{val.shape} != {merged[k].shape}")
                    merged[k] = _tensor(val, net.device)
                net.net_params[vname] = merged
                ms = dict(net.net_state[vname])
                for k, val in states[0].items():
                    ms[k] = _tensor(val, net.device)
                net.net_state[vname] = ms
            if off != flat.size:
                raise ValueError(f"coefficients.bin has {flat.size} "
                                 f"params, vertex specs consume {off}")
            if load_updater:
                net.opt_states = net._init_opt_states()
        if load_updater and "updaterState.bin" in names:
            if net.opt_states is None:
                net.opt_states = net._init_opt_states()
            # ComputationGraphUpdater flattens in the SAME topological
            # order as the params (BaseMultiLayerUpdater.getOrderedLayers)
            try:
                topo = dl4j_graph_topological_order(
                    list(raw.get("networkInputs") or []),
                    list((raw.get("vertices") or {}).keys()),
                    {k: list(v)
                     for k, v in (raw.get("vertexInputs") or {}).items()})
                indexed = [(vname, conf.vertices[vname].layer_conf())
                           for vname in topo
                           if vname in conf.vertices
                           and isinstance(conf.vertices[vname], LayerVertex)]
                ustate = read_nd4j_array(
                    io.BytesIO(zf.read("updaterState.bin"))).ravel(order="C")
                migrated = updater_state_from_flat(indexed, ustate,
                                                   conf.global_conf)
                for vname in migrated:
                    net.opt_states[vname] = _merge_updater_state(
                        net.opt_states[vname], migrated[vname])
            except Exception as e:
                import warnings
                warnings.warn(
                    f"updaterState.bin could not be migrated ({e}); "
                    "training resumes with fresh updater state",
                    UserWarning, stacklevel=2)
    return net


# ---------------------------------------------------------------------------
# coefficients.bin → per-layer param dicts
# ---------------------------------------------------------------------------

def _layer_param_spec(layer: L.Layer):
    """[(name, shape, n, order)] in DL4J view order, or [] for no-param
    layers.  Shapes are DL4J's; most views reshape 'f' (column-major,
    WeightInitUtil.java:40) — EXCEPT conv kernels, which DL4J reshapes
    'c' and stores AFTER the bias (ConvolutionParamInitializer.java:76-80
    bias at interval(0,nOut), weights reshape('c', nOut,nIn,kH,kW))."""
    if isinstance(layer, L.ConvolutionLayer):
        n_in, n_out = layer.n_in, layer.n_out
        kh, kw = layer.kernel
        return [("b", (n_out,), n_out, "C"),
                ("W", (n_out, n_in, kh, kw), n_out * n_in * kh * kw, "C")]
    if isinstance(layer, L.BatchNormalization):
        n = layer.n_features
        spec = [] if layer.lock_gamma_beta else [("gamma", (n,), n, "F"),
                                                 ("beta", (n,), n, "F")]
        return spec + [("mean", (n,), n, "F"), ("var", (n,), n, "F")]
    if isinstance(layer, L.GravesBidirectionalLSTM):
        # forward block then backward block, each (W, RW+peepholes, b)
        # (nn/params/GravesBidirectionalLSTMParamInitializer.java:92-106)
        n_in, H = layer.n_in, layer.n_out
        out = []
        for pre in ("f_", "b_"):
            out += [(pre + "W", (n_in, 4 * H), n_in * 4 * H, "F"),
                    (pre + "RW+p", (H, 4 * H + 3), H * (4 * H + 3), "F"),
                    (pre + "b", (4 * H,), 4 * H, "F")]
        return out
    if isinstance(layer, L.GravesLSTM):
        n_in, H = layer.n_in, layer.n_out
        return [("W", (n_in, 4 * H), n_in * 4 * H, "F"),
                ("RW+p", (H, 4 * H + 3), H * (4 * H + 3), "F"),
                ("b", (4 * H,), 4 * H, "F")]
    if layer.is_pretrain_layer():
        raise ValueError(
            f"layer {layer.name or type(layer).__name__!r} "
            f"({type(layer).__name__}) is a pretrain layer: DL4J keeps its "
            f"params out of its neighbours' updater blocks and its views "
            f"are not W, b")
    if type(layer) in _DENSE_FAMILY:   # dense/output/rnnoutput/embedding
        n_in, n_out = layer.n_in, layer.n_out
        return [("W", (n_in, n_out), n_in * n_out, "F"),
                ("b", (n_out,), n_out, "F")]
    if layer.has_params():
        raise ValueError(
            f"layer {layer.name or type(layer).__name__!r} "
            f"({type(layer).__name__}) has params whose DL4J views this "
            f"migration does not know")
    return []


# the layers whose params are exactly DefaultParamInitializer's W, b
_DENSE_FAMILY = (L.DenseLayer, L.OutputLayer, L.RnnOutputLayer,
                 L.EmbeddingLayer)


def _is_lstm_gated(layer: L.Layer, name: str) -> bool:
    """True for LSTM param views whose last axis is 4H gate blocks
    (W/b, incl. the f_/b_ bidirectional variants) — these need the
    IFOG block swap.  RW is handled inside the RW+p branch."""
    return (isinstance(layer, (L.GravesLSTM, L.GravesBidirectionalLSTM))
            and (name.endswith("W") or name.endswith("b")))


def _swap_ifog_blocks(a: np.ndarray, H: int) -> np.ndarray:
    """Permute LSTM gate column blocks 0↔3 along the last axis.

    DL4J's IFOG order puts the tanh candidate in block 0 and the sigmoid
    multiplier in block 3 (GravesLSTMParamInitializer.java:108 "Order:
    input, forget, output, input modulation"; LSTMHelpers.java:180-226);
    this framework's cell is [i(sigmoid), f, o, g(tanh)]
    (ops/recurrent.py).  Swapping blocks 0 and 3 converts either layout
    to the other (involution), for W [*,4H], RW [H,4H] and b [4H]."""
    out = np.array(a, copy=True)
    out[..., 0:H] = a[..., 3 * H:4 * H]
    out[..., 3 * H:4 * H] = a[..., 0:H]
    return out


def _decode_view(layer: L.Layer, name: str, shape, order: str,
                 view: np.ndarray) -> Dict[str, np.ndarray]:
    """Decode ONE flat DL4J view into this framework's param keys.
    Shared by params_from_flat and each updater-state plane — updater
    state aligns elementwise with the flat param layout
    (BaseMultiLayerUpdater.java:61-120 slices both from parallel views),
    so the same reshapes/permutations apply."""
    if name.endswith("RW+p"):
        pre = name[:-len("RW+p")]
        m = np.reshape(view, shape, order=order)
        H = shape[0]
        # peephole cols: wFF, wOO, wGG (LSTMHelpers.java:62); after the
        # IFOG block swap the mapping is exact (module docstring):
        # wFF→pF, wOO→pO, wGG→pI
        return {pre + "RW": _swap_ifog_blocks(m[:, :4 * H], H),
                pre + "pF": m[:, 4 * H],
                pre + "pO": m[:, 4 * H + 1],
                pre + "pI": m[:, 4 * H + 2]}
    if _is_lstm_gated(layer, name):
        H = shape[-1] // 4
        return {name: _swap_ifog_blocks(
            np.reshape(view, shape, order=order), H)}
    return {name: np.reshape(view, shape, order=order)}


def _encode_view(layer: L.Layer, name: str, shape, order: str,
                 values: Dict) -> np.ndarray:
    """Inverse of _decode_view: one raveled DL4J view from param keys."""
    if name.endswith("RW+p"):
        pre = name[:-len("RW+p")]
        H = shape[0]
        m = np.zeros(shape, np.float32)
        m[:, :4 * H] = _swap_ifog_blocks(np.asarray(values[pre + "RW"]), H)
        m[:, 4 * H] = np.asarray(values[pre + "pF"])
        m[:, 4 * H + 1] = np.asarray(values[pre + "pO"])
        m[:, 4 * H + 2] = np.asarray(values[pre + "pI"])
        return np.ravel(m, order=order)
    if _is_lstm_gated(layer, name):
        H = shape[-1] // 4
        return np.ravel(_swap_ifog_blocks(np.asarray(values[name]), H),
                        order=order)
    return np.ravel(np.asarray(values[name]), order=order)


def params_from_flat(layers: List[L.Layer],
                     flat: np.ndarray) -> Tuple[List[Dict], List[Dict]]:
    """Replay DefaultParamInitializer's flattening: slice the flat row
    per layer/view, 'f'-order reshape.  Returns (params, states) in this
    framework's conventions (BN mean/var live in state, not params)."""
    params, states = [], []
    off = 0
    for i, layer in enumerate(layers):
        spec = _layer_param_spec(layer)
        lp, ls = {}, {}
        for name, shape, n, order in spec:
            if off + n > flat.size:
                raise ValueError(
                    f"coefficients.bin too short at layer {i} ({name}): "
                    f"need {off + n}, have {flat.size}")
            view = flat[off:off + n]
            off += n
            if name in ("mean", "var"):
                ls[name] = view.copy()
            else:
                lp.update(_decode_view(layer, name, shape, order, view))
        params.append(lp)
        states.append(ls)
    if off != flat.size:
        raise ValueError(f"coefficients.bin has {flat.size} params, "
                         f"layer specs consume {off}")
    return params, states


# ---------------------------------------------------------------------------
# updaterState.bin — the updater's flat state view
# ---------------------------------------------------------------------------

# Plane names map nd4j's legacy per-rule buffers onto this framework's
# ops/updaters.Updater.init keys.  Per-view state sizes:
# UpdaterUtils.stateSizeForLayerVariable:42-61 — SGD/NONE 0×, NESTEROVS
# (momentum v) / ADAGRAD (historical g²) / RMSPROP (moving-avg g²) 1×,
# ADAM (m then v) / ADADELTA (msg then msdx) 2× the param length; the
# 2-plane rules split their block view in half, first plane first
# (nd4j legacy AdamUpdater/AdaDeltaUpdater.setStateViewArray).
_STATE_PLANES = {
    "sgd": (), "none": (),
    "nesterovs": ("v",),
    "adagrad": ("g2",),
    "rmsprop": ("g2",),
    "adam": ("m", "v"),
    "adamax": ("m", "v"),
    "adadelta": ("g2", "dx2"),
}


def _view_updater(layer: L.Layer, name: str, g: GlobalConf) -> str:
    """Effective updater rule for one param view.  BN mean/var are
    Updater.NONE (BatchNormalization.java:151-161)."""
    if name in ("mean", "var"):
        return "none"
    return (layer.updater or g.updater or "sgd").lower()


def _updater_sig(layer: L.Layer, name: str, g: GlobalConf):
    """UpdaterBlock merge key: contiguous param views with equal updater
    configuration share one block (UpdaterUtils
    .updaterConfigurationsEquals:64-120 — same rule, same per-param
    learning rate incl. biasLearningRate, same LR schedule, same
    rule-specific hyperparameters).  Hyperparameters are RESOLVED to
    their effective values (layer → global → rule default, the same
    resolution nn/multilayer._updater_for applies) before comparison —
    DL4J compares resolved configs, so an explicit epsilon=1e-8 on one
    layer and an unset-default 1e-8 on the next must still merge."""
    upd = _view_updater(layer, name, g)
    is_bias = name == "b" or name.endswith("_b")
    lr = layer.learning_rate if layer.learning_rate is not None \
        else g.learning_rate
    if is_bias and layer.bias_learning_rate is not None:
        lr = layer.bias_learning_rate

    def res(field, default):
        v = getattr(layer, field, None)
        if v is None:
            v = getattr(g, field, None)
        return default if v is None else v

    hyper = ()
    if upd == "nesterovs":
        hyper = (res("momentum", 0.9),)
    elif upd in ("adam", "adamax"):
        hyper = (res("adam_mean_decay", 0.9), res("adam_var_decay", 0.999),
                 res("epsilon", 1e-8))
    elif upd == "adadelta":
        hyper = (res("rho", 0.95), res("epsilon", 1e-6))
    elif upd == "rmsprop":
        hyper = (res("rms_decay", 0.95), res("epsilon", 1e-8))
    elif upd == "adagrad":
        hyper = (res("epsilon", 1e-6),)
    sched = (g.lr_policy, g.lr_policy_decay_rate, g.lr_policy_steps,
             g.lr_policy_power,
             tuple(sorted((g.learning_rate_schedule or {}).items())))
    return (upd, lr, hyper, sched)


def _updater_blocks(indexed_layers, g: GlobalConf):
    """Walk (index, layer) pairs in flat-param order and group contiguous
    views with equal updater config into UpdaterBlocks
    (BaseMultiLayerUpdater.java:55-120).  Returns
    [{"updater", "views": [(idx, layer, name, shape, n, order)]}]."""
    blocks = []
    cur_sig = object()
    for idx, layer in indexed_layers:
        for name, shape, n, order in _layer_param_spec(layer):
            sig = _updater_sig(layer, name, g)
            if blocks and sig == cur_sig:
                blocks[-1]["views"].append((idx, layer, name, shape, n,
                                            order))
            else:
                cur_sig = sig
                blocks.append({"updater": sig[0],
                               "views": [(idx, layer, name, shape, n,
                                          order)]})
    return blocks


def updater_state_from_flat(indexed_layers, flat: np.ndarray,
                            g: GlobalConf) -> Dict:
    """Distribute a DL4J ``updaterState.bin`` row onto per-layer updater
    state in this framework's ops/updaters structure.

    Layout (BaseMultiLayerUpdater.java:55-130): layers input→output
    (topological order for a ComputationGraph), param views in
    initializer order, contiguous views with equal updater config merged
    into UpdaterBlocks; each block contributes its planes back-to-back —
    a 2-plane rule stores plane 0 for ALL the block's params, then plane
    1.  State elements align 1:1 with the flat param layout, so each
    plane decodes with the same per-view reshapes (incl. the LSTM IFOG
    swap) as coefficients.bin.

    Returns {layer_index: {plane: {param_key: array}}}."""
    out: Dict = {}
    off = 0
    for block in _updater_blocks(indexed_layers, g):
        planes = _STATE_PLANES.get(block["updater"])
        if planes is None:
            raise ValueError(
                f"unknown updater {block['updater']!r} in updater state")
        block_n = sum(v[4] for v in block["views"])
        for k, plane in enumerate(planes):
            row = flat[off + k * block_n: off + (k + 1) * block_n]
            if row.size != block_n:
                raise ValueError(
                    f"updaterState.bin too short: block needs {block_n} "
                    f"per plane at offset {off}")
            vo = 0
            for idx, layer, name, shape, n, order in block["views"]:
                vals = _decode_view(layer, name, shape, order,
                                    row[vo:vo + n])
                vo += n
                out.setdefault(idx, {}).setdefault(plane, {}).update(vals)
        off += len(planes) * block_n
    if off != flat.size:
        raise ValueError(f"updaterState.bin has {flat.size} entries, "
                         f"updater blocks consume {off}")
    return out


def updater_state_to_flat(indexed_layers, states: Dict,
                          g: GlobalConf) -> np.ndarray:
    """Inverse of :func:`updater_state_from_flat`: emit the flat DL4J
    updater-state row from {layer_index: {plane: {param_key: array}}}."""
    chunks = []
    for block in _updater_blocks(indexed_layers, g):
        planes = _STATE_PLANES.get(block["updater"])
        if planes is None:
            raise ValueError(
                f"updater {block['updater']!r} has no DL4J state layout")
        for plane in planes:
            for idx, layer, name, shape, n, order in block["views"]:
                vals = states.get(idx, {}).get(plane, {})
                try:
                    chunks.append(_encode_view(layer, name, shape, order,
                                               vals))
                except KeyError:
                    # missing state (e.g. frozen layer) → zeros, matching
                    # a freshly initialized Java updater view
                    chunks.append(np.zeros(n, np.float32))
    if not chunks:
        return np.empty(0, np.float32)
    return np.concatenate(chunks).astype(np.float32)


def _merge_updater_state(opt_state, migrated: Dict):
    """Overwrite the engine-initialized opt-state leaves for one layer
    with migrated arrays, each on its leaf's device (structure comes from
    Updater.init, so the updaters see the tree they made)."""
    import torch
    if not migrated or not isinstance(opt_state, dict):
        return opt_state
    new = dict(opt_state)
    for plane, vals in migrated.items():
        if plane not in new or not isinstance(new[plane], dict):
            continue
        np_new = dict(new[plane])
        for k, v in vals.items():
            if k in np_new:
                np_new[k] = torch.from_numpy(
                    np.ascontiguousarray(v, np.float32)).to(
                    device=np_new[k].device, dtype=np_new[k].dtype)
        new[plane] = np_new
    return new


# ---------------------------------------------------------------------------
# Export TO the DL4J container format (the reverse direction)
# ---------------------------------------------------------------------------

# selu/gelu/swish post-date DL4J 0.8's IActivation set; exporting their
# names keeps OUR round-trip exact (the importer substring-matches), a
# Java 0.8 reader would reject those three
_ACT_EXPORT = {"relu": "ReLU", "tanh": "TanH", "sigmoid": "Sigmoid",
               "softmax": "Softmax", "identity": "Identity",
               "leakyrelu": "LeakyReLU", "elu": "ELU", "cube": "Cube",
               "softplus": "SoftPlus", "softsign": "SoftSign",
               "hardtanh": "HardTanh", "hardsigmoid": "HardSigmoid",
               "rationaltanh": "RationalTanh",
               "rectifiedtanh": "RectifiedTanh", "selu": "SELU",
               "gelu": "GELU", "swish": "Swish", "linear": "Identity"}

_LOSS_EXPORT = {"mcxent": "LossMCXENT", "mse": "LossMSE", "l1": "LossL1",
                "l2": "LossL2", "mae": "LossMAE", "xent": "LossBinaryXENT",
                "negativeloglikelihood": "LossNegativeLogLikelihood",
                "hinge": "LossHinge", "squared_hinge": "LossSquaredHinge",
                "poisson": "LossPoisson", "kl_divergence": "LossKLD",
                "msle": "LossMSLE", "mape": "LossMAPE",
                "cosine_proximity": "LossCosineProximity",
                "squared_loss": "LossMSE"}


_LOSS_CANON = {"nll": "negativeloglikelihood",
               "mean_absolute_error": "mae",
               "mean_absolute_percentage_error": "mape",
               "mean_squared_logarithmic_error": "msle",
               "reconstruction_crossentropy": "xent",
               "squared_loss": "mse"}


def _loss_export(name: str) -> dict:
    name = _LOSS_CANON.get(name, name)  # registry aliases (ops/losses.py)
    if name not in _LOSS_EXPORT:
        raise ValueError(f"loss {name!r} has no DL4J export name")
    return {_LOSS_EXPORT[name]: {}}


def _export_layer_json(layer: L.Layer, g: GlobalConf):
    """(wrapper_type_name, layer_json) in the Jackson shape — inverse of
    :func:`_build_layer` for the supported families."""
    if getattr(layer, "momentum_schedule", None):
        raise ValueError(
            f"layer {layer.name or type(layer).__name__!r} sets a momentum "
            f"schedule, which splits DL4J's updater blocks in a way this "
            f"export does not replay")
    _layer_param_spec(layer)   # raises for a layer it cannot slice
    act = layer.activation or g.activation
    if act not in _ACT_EXPORT:
        raise ValueError(f"activation {act!r} has no DL4J export name")

    def eff(field, gfield=None):
        v = getattr(layer, field)
        return v if v is not None else getattr(g, gfield or field)

    j = {
        "activationFn": {_ACT_EXPORT[act]: {}},
        "weightInit": str(layer.weight_init or g.weight_init).upper(),
        "learningRate": eff("learning_rate"),
        "updater": str(layer.updater or g.updater).upper(),
        "momentum": eff("momentum"),
        "rho": eff("rho"),
        "rmsDecay": eff("rms_decay"),
        "adamMeanDecay": eff("adam_mean_decay"),
        "adamVarDecay": eff("adam_var_decay"),
        "l1": layer.l1 if layer.l1 else float("nan"),
        "l2": layer.l2 if layer.l2 else float("nan"),
        "l1Bias": layer.l1_bias if layer.l1_bias else float("nan"),
        "l2Bias": layer.l2_bias if layer.l2_bias else float("nan"),
        "dropOut": layer.dropout or 0.0,
        "biasInit": layer.bias_init
        if layer.bias_init is not None else g.bias_init,
    }
    eps = layer.epsilon if layer.epsilon is not None else g.epsilon
    if eps is not None:
        j["epsilon"] = eps
    if layer.bias_learning_rate is not None:
        j["biasLearningRate"] = layer.bias_learning_rate
    gn = layer.gradient_normalization or g.gradient_normalization
    if gn:
        j["gradientNormalization"] = str(gn)
        j["gradientNormalizationThreshold"] = (
            layer.gradient_normalization_threshold
            if layer.gradient_normalization_threshold is not None
            else g.gradient_normalization_threshold)
    if getattr(layer, "n_in", None):
        j["nIn"] = int(layer.n_in)
    if getattr(layer, "n_out", None):
        j["nOut"] = int(layer.n_out)
    if isinstance(layer, L.ConvolutionLayer):
        j.update(kernelSize=list(layer.kernel), stride=list(layer.stride),
                 padding=list(layer.padding),
                 dilation=list(layer.dilation),
                 convolutionMode="Same" if layer.convolution_mode == "same"
                 else "Truncate")
        return "convolution", j
    if isinstance(layer, L.SubsamplingLayer):
        j.pop("activationFn", None)
        j.update(poolingType=layer.pooling_type.upper(),
                 kernelSize=list(layer.kernel), stride=list(layer.stride),
                 padding=list(layer.padding), pnorm=layer.pnorm,
                 convolutionMode="Same" if layer.convolution_mode == "same"
                 else "Truncate")
        return "subsampling", j
    if isinstance(layer, L.BatchNormalization):
        j.update(decay=layer.decay, eps=layer.eps,
                 lockGammaBeta=layer.lock_gamma_beta,
                 nOut=int(layer.n_features or 0),
                 nIn=int(layer.n_features or 0))
        return "batchNormalization", j
    if isinstance(layer, (L.GravesLSTM, L.GravesBidirectionalLSTM)):
        if layer.gate_activation not in _ACT_EXPORT:
            raise ValueError(f"gate activation {layer.gate_activation!r} "
                             f"has no DL4J export name")
        j.update(forgetGateBiasInit=layer.forget_gate_bias_init,
                 gateActivationFn={_ACT_EXPORT[layer.gate_activation]: {}})
        return ("gravesBidirectionalLSTM"
                if isinstance(layer, L.GravesBidirectionalLSTM)
                else "gravesLSTM"), j
    if isinstance(layer, L.RnnOutputLayer):
        j["lossFn"] = _loss_export(layer.loss)
        return "rnnoutput", j
    if isinstance(layer, L.OutputLayer):
        j["lossFn"] = _loss_export(layer.loss)
        return "output", j
    if isinstance(layer, L.LossLayer):
        j["lossFn"] = _loss_export(layer.loss)
        return "loss", j
    if isinstance(layer, L.EmbeddingLayer):
        return "embedding", j
    if isinstance(layer, L.DenseLayer):
        return "dense", j
    if isinstance(layer, L.ActivationLayer):
        return "activation", j
    if isinstance(layer, L.DropoutLayer):
        return "dropout", j
    if isinstance(layer, L.GlobalPoolingLayer):
        j.pop("activationFn", None)
        j["poolingType"] = layer.pooling_type.upper()
        return "GlobalPooling", j
    if isinstance(layer, L.ZeroPaddingLayer):
        j.pop("activationFn", None)
        j["padding"] = list(layer.padding)
        return "zeroPadding", j
    raise ValueError(f"layer {type(layer).__name__} has no DL4J export "
                     f"mapping")


def _export_preprocessor(proc) -> dict:
    """Our InputPreProcessor → the Jackson wrapper-object form (inverse
    of _PREPROC_MAP).  Raises for shapes with no DL4J mapping — a
    silently dropped preprocessor would export a zip that reshapes
    wrongly on restore."""
    hwc = lambda p: {"inputHeight": p.height, "inputWidth": p.width,  # noqa: E731
                     "numChannels": p.channels}
    if isinstance(proc, pp.CnnToFeedForwardPreProcessor):
        return {"cnnToFeedForward": hwc(proc)}
    if isinstance(proc, pp.FeedForwardToCnnPreProcessor):
        return {"feedForwardToCnn": hwc(proc)}
    if isinstance(proc, pp.RnnToFeedForwardPreProcessor):
        return {"rnnToFeedForward": {}}
    if isinstance(proc, pp.FeedForwardToRnnPreProcessor):
        return {"feedForwardToRnn": {}}
    if isinstance(proc, pp.CnnToRnnPreProcessor):
        return {"cnnToRnn": {}}
    if isinstance(proc, pp.RnnToCnnPreProcessor):
        return {"rnnToCnn": hwc(proc)}
    raise ValueError(f"preprocessor {type(proc).__name__} has no DL4J "
                     f"export mapping")


def _flatten_layer_params(layer: L.Layer, lp: Dict, ls: Dict) -> np.ndarray:
    """Inverse of the :func:`params_from_flat` slicing for one layer:
    emit views in DL4J order with the per-view ravel order."""
    spec = _layer_param_spec(layer)
    chunks = []
    for name, shape, n, order in spec:
        if name in ("mean", "var"):
            chunks.append(np.ravel(np.asarray(ls[name]), order=order))
        else:
            chunks.append(_encode_view(layer, name, shape, order, lp))
    return np.concatenate(chunks) if chunks else np.empty(0, np.float32)


def export_multi_layer_network(net, path) -> None:
    """Write ``net`` as a zip in the ORIGINAL DL4J's container format
    (configuration.json in the Jackson schema + coefficients.bin in the
    legacy Nd4j.write format, util/ModelSerializer.java:79-120) so the
    params survive a round-trip through :func:`restore_multi_layer_network`
    bit-for-bit — and follow the documented layouts a Java DL4J reader
    replays.  Non-empty updater state is written as ``updaterState.bin``
    in the UpdaterBlock layout (see :func:`updater_state_to_flat`)."""
    import dataclasses as _dc
    conf = net.conf
    g = conf.global_conf
    net_params, net_state = _host(net.net_params), _host(net.net_state)
    opt_states = _host(net.opt_states) or []
    # merge_layer_conf already zeroed per-layer l1/l2 when the flag was
    # off, so any surviving nonzero value implies regularization is live
    use_reg = bool(g.use_regularization or any(
        (lv.l1 or lv.l2 or lv.l1_bias or lv.l2_bias)
        for lv in conf.layers if not isinstance(lv, L.FrozenLayerConf)))
    confs = []
    inners = []
    for layer, lp, ls in zip(conf.layers, net_params, net_state):
        inner = layer._inner() if isinstance(layer, L.FrozenLayerConf) \
            else layer  # NOTE: DL4J 0.8 has no FrozenLayer JSON type —
        # frozen status does not survive export
        if isinstance(inner, L.BatchNormalization) and not inner.n_features:
            # conf-level n_features may be inferred at init; the running
            # stats carry the realized width
            inner = _dc.replace(inner,
                                n_features=int(ls["mean"].shape[0]))
        if getattr(inner, "n_in", None) in (None, 0) and "W" in lp:
            # n_in is usually inferred at init; the weights carry it
            W = lp["W"]
            n_in = int(W.shape[1] if isinstance(inner, L.ConvolutionLayer)
                       else W.shape[0])
            inner = _dc.replace(inner, n_in=n_in)
        inners.append(inner)
        tname, lj = _export_layer_json(inner, g)
        confs.append({
            "layer": {tname: lj},
            "miniBatch": g.mini_batch, "seed": g.seed,
            "minimize": g.minimize,
            "useRegularization": use_reg,
            "pretrain": False,
        })
    top = {
        "backprop": conf.backprop, "pretrain": conf.pretrain,
        "backpropType": ("TruncatedBPTT"
                         if conf.backprop_type == "truncatedbptt"
                         else "Standard"),
        "tbpttFwdLength": conf.tbptt_fwd_length,
        "tbpttBackLength": conf.tbptt_back_length,
        "inputPreProcessors": {
            str(i): _export_preprocessor(p)
            for i, p in (conf.preprocessors or {}).items()},
        "confs": confs,
    }
    flats = []
    for inner, lp, ls in zip(inners, net_params, net_state):
        flats.append(_flatten_layer_params(inner, lp, ls))
    flat = (np.concatenate([f for f in flats if f.size])
            if any(f.size for f in flats) else np.empty(0, np.float32))
    buf = io.BytesIO()
    write_nd4j_array(buf, flat.reshape(1, -1), order="f")
    ustates = {i: s for i, s in enumerate(opt_states)
               if isinstance(s, dict) and s}
    uflat = updater_state_to_flat(list(enumerate(inners)), ustates, g) \
        if ustates else np.empty(0, np.float32)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("configuration.json", json.dumps(top, indent=2))
        zf.writestr("coefficients.bin", buf.getvalue(), zipfile.ZIP_STORED)
        if uflat.size:
            # ModelSerializer.writeModel:106-125 appends the updater
            # state view only when present and non-empty
            ubuf = io.BytesIO()
            write_nd4j_array(ubuf, uflat.reshape(1, -1), order="f")
            zf.writestr("updaterState.bin", ubuf.getvalue(),
                        zipfile.ZIP_STORED)


def _export_vertex(v, g: GlobalConf) -> dict:
    """Our GraphVertexConf → the Jackson wrapper-object form (inverse of
    :func:`_build_vertex`)."""
    from deeplearning4j_tpu_torch.nn.conf import graph_conf as gc
    if isinstance(v, gc.MergeVertex):
        return {"MergeVertex": {}}
    if isinstance(v, gc.ElementWiseVertex):
        return {"ElementWiseVertex": {"op": v.op.capitalize()}}
    if isinstance(v, gc.SubsetVertex):
        return {"SubsetVertex": {"from": v.from_idx, "to": v.to_idx}}
    if isinstance(v, gc.ScaleVertex):
        return {"ScaleVertex": {"scaleFactor": v.scale}}
    if isinstance(v, gc.ShiftVertex):
        return {"ShiftVertex": {"shiftFactor": v.shift}}
    if isinstance(v, gc.StackVertex):
        return {"StackVertex": {}}
    if isinstance(v, gc.UnstackVertex):
        return {"UnstackVertex": {"from": v.from_idx,
                                  "stackSize": v.stack_size}}
    if isinstance(v, gc.L2Vertex):
        return {"L2Vertex": {}}
    if isinstance(v, gc.L2NormalizeVertex):
        return {"L2NormalizeVertex": {}}
    if isinstance(v, gc.LastTimeStepVertex):
        return {"LastTimeStepVertex": {"maskArrayInputName": v.mask_input}}
    if isinstance(v, gc.DuplicateToTimeSeriesVertex):
        return {"DuplicateToTimeSeriesVertex": {"inputName": v.ts_input}}
    if isinstance(v, gc.PreprocessorVertex):
        return {"PreprocessorVertex": {"preProcessor": _export_preprocessor(
            pp.InputPreProcessor.from_dict(v.preprocessor))}}
    raise ValueError(f"vertex {type(v).__name__} has no DL4J export "
                     f"mapping")


def export_computation_graph(net, path) -> None:
    """Write a ComputationGraph as a zip in the ORIGINAL DL4J's container
    format (graph schema: nn/conf/ComputationGraphConfiguration.java:
    59-87; flat params in topologicalSortOrder per
    ComputationGraph.java:336-380).  Params, outputs AND updater state
    round-trip exactly through :func:`restore_computation_graph`
    (non-empty updater state is written as ``updaterState.bin`` in the
    same topological UpdaterBlock layout the restore side decodes);
    frozen-vertex status does NOT survive (DL4J 0.8 has no FrozenLayer
    JSON type — same caveat as export_multi_layer_network)."""
    import dataclasses as _dc
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import LayerVertex
    conf = net.conf
    g = conf.global_conf
    net_params, net_state = _host(net.net_params), _host(net.net_state)
    opt_states = _host(net.opt_states) or {}

    def resolved_inner(name, v):
        """Layer conf with frozen wrapper peeled and inferred n_in / BN
        width recovered from the live params — used by BOTH the JSON
        pass and the param-flatten pass so specs stay in sync."""
        lc = v.layer_conf()
        inner = lc._inner() if isinstance(lc, L.FrozenLayerConf) else lc
        lp = net_params.get(name) or {}
        W = lp.get("W")
        if W is None:
            W = lp.get("f_W")   # bidirectional LSTM keys f_W/b_W
        if getattr(inner, "n_in", None) in (None, 0) and W is not None:
            inner = _dc.replace(inner, n_in=int(
                W.shape[1] if isinstance(inner, L.ConvolutionLayer)
                else W.shape[0]))
        if isinstance(inner, L.BatchNormalization) and not inner.n_features:
            inner = _dc.replace(inner, n_features=int(
                net_state[name]["mean"].shape[0]))
        return inner

    inners = {name: resolved_inner(name, v)
              for name, v in conf.vertices.items()
              if isinstance(v, LayerVertex)}
    vertices_json = {}
    for name, v in conf.vertices.items():
        if isinstance(v, LayerVertex):
            tname, lj = _export_layer_json(inners[name], g)
            vertices_json[name] = {"LayerVertex": {
                "layerConf": {"layer": {tname: lj}, "seed": g.seed,
                              "miniBatch": g.mini_batch,
                              "minimize": g.minimize, "pretrain": False},
                "preProcessor": None}}
        else:
            vertices_json[name] = _export_vertex(v, g)
    top = {
        "networkInputs": list(conf.network_inputs),
        "networkOutputs": list(conf.network_outputs),
        "vertices": vertices_json,
        "vertexInputs": {k: list(vv)
                         for k, vv in conf.vertex_inputs.items()},
        "defaultConfiguration": {"seed": g.seed, "minimize": g.minimize,
                                 "miniBatch": g.mini_batch,
                                 "useRegularization": bool(
                                     g.use_regularization or any(
                                         (i.l1 or i.l2 or i.l1_bias
                                          or i.l2_bias)
                                         for i in inners.values()))},
        "backprop": True, "pretrain": False,
        "backpropType": ("TruncatedBPTT"
                         if conf.backprop_type == "truncatedbptt"
                         else "Standard"),
        "tbpttFwdLength": conf.tbptt_fwd_length,
        "tbpttBackLength": conf.tbptt_back_length,
    }
    topo = dl4j_graph_topological_order(
        list(conf.network_inputs), list(conf.vertices),
        {k: list(vv) for k, vv in conf.vertex_inputs.items()})
    flats = []
    for name in topo:
        if name not in inners:
            continue
        flats.append(_flatten_layer_params(
            inners[name], net_params.get(name) or {},
            net_state.get(name) or {}))
    flat = (np.concatenate([f for f in flats if f.size])
            if any(f.size for f in flats) else np.empty(0, np.float32))
    buf = io.BytesIO()
    write_nd4j_array(buf, flat.reshape(1, -1), order="f")
    # updater state in the same topological order the restore side walks
    indexed = [(name, inners[name]) for name in topo if name in inners]
    ustates = {name: s for name, s in opt_states.items()
               if isinstance(s, dict) and s}
    uflat = updater_state_to_flat(indexed, ustates, g) \
        if ustates else np.empty(0, np.float32)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("configuration.json", json.dumps(top, indent=2))
        zf.writestr("coefficients.bin", buf.getvalue(), zipfile.ZIP_STORED)
        if uflat.size:
            ubuf = io.BytesIO()
            write_nd4j_array(ubuf, uflat.reshape(1, -1), order="f")
            zf.writestr("updaterState.bin", ubuf.getvalue(),
                        zipfile.ZIP_STORED)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def restore_multi_layer_network(path, load_params: bool = True,
                                load_updater: bool = True, device=None):
    """Load a zip the ORIGINAL DL4J's ModelSerializer wrote and return an
    initialized :class:`MultiLayerNetwork` of this framework (ref:
    ModelSerializer.restoreMultiLayerNetwork, util/ModelSerializer.java;
    regression contract: regressiontest/RegressionTest071.java).

    ``updaterState.bin`` is migrated through the UpdaterBlock layout
    (see :func:`updater_state_from_flat`; docs/MIGRATION.md documents
    the byte-level spec) so fine-tuning resumes with the Java updater's
    momentum/moment buffers instead of a cold restart.  The network is
    on ``device``; its updater state is made only under
    ``load_updater``."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    with zipfile.ZipFile(path, "r") as zf:
        names = set(zf.namelist())
        if "configuration.json" not in names:
            raise ValueError("not a DL4J model zip: no configuration.json")
        conf = config_from_dl4j_json(
            zf.read("configuration.json").decode("utf-8"))
        net = MultiLayerNetwork(conf, device=device)
        net.init()
        if load_params and "coefficients.bin" in names:
            flat = read_nd4j_array(
                io.BytesIO(zf.read("coefficients.bin"))).ravel(order="C")
            params, states = params_from_flat(conf.layers, flat)
            new_p, new_s = [], []
            for lp, ls, cur_p, cur_s in zip(params, states, net.net_params,
                                            net.net_state):
                merged_p = dict(cur_p)
                for k, v in lp.items():
                    if k in merged_p and merged_p[k].shape != v.shape:
                        raise ValueError(
                            f"param {k}: DL4J shape {v.shape} != "
                            f"{merged_p[k].shape}")
                    merged_p[k] = _tensor(v, net.device)
                merged_s = dict(cur_s)
                for k, v in ls.items():
                    merged_s[k] = _tensor(v, net.device)
                new_p.append(merged_p)
                new_s.append(merged_s)
            net.net_params = new_p
            net.net_state = new_s
            if load_updater:
                net.opt_states = net._init_opt_states()
        if load_updater and "updaterState.bin" in names:
            if net.opt_states is None:
                net.opt_states = net._init_opt_states()
            try:
                ustate = read_nd4j_array(
                    io.BytesIO(zf.read("updaterState.bin"))).ravel(order="C")
                migrated = updater_state_from_flat(
                    list(enumerate(conf.layers)), ustate, conf.global_conf)
                net.opt_states = [
                    _merge_updater_state(net.opt_states[i],
                                         migrated.get(i, {}))
                    for i in range(len(net.layers))]
            except Exception as e:  # e.g. an updater rule outside the
                # 0.8 set (NADAM/CUSTOM) whose state layout we can't
                # place — params still load, resume with fresh state
                import warnings
                warnings.warn(
                    f"updaterState.bin could not be migrated ({e}); "
                    "training resumes with fresh updater state",
                    UserWarning, stacklevel=2)
    return net
