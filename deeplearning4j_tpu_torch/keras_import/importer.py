"""Keras model import — the port of ``deeplearning4j_tpu/keras_import/importer.py``.

(ref: keras/KerasModelImport.java — importKerasSequentialModelAndWeights,
importKerasModelAndWeights, importKerasSequentialConfiguration;
KerasLayer.java:44 layer mapping; KerasModel.java:377-480 weight copying.)

A Keras ``Sequential`` configuration (the ``model_config`` JSON of an
``.h5`` file, Keras 1/2 and Keras 3 layouts) becomes a
``MultiLayerNetwork`` on the port's layers, and each Keras layer's weight
arrays become the layer's params and state:

- Dense kernel: Keras [in, out] is the port's [in, out]; a Dense right
  after a flatten of a conv output has its rows permuted from Keras's HWC
  order to the CHW order of ``CnnToFeedForwardPreProcessor``;
- Conv2D kernel: Keras HWIO [kh, kw, in, out] → OIHW;
- BatchNormalization: ``gamma`` / ``beta`` are params, ``moving_mean`` /
  ``moving_variance`` the layer's running ``mean`` / ``var`` state;
- LSTM: Keras's gate order i, f, c, o → the port's i, f, o, c in ``W``,
  ``RW`` and ``b`` of a GravesLSTM with zero peepholes (a vanilla LSTM).

``_load_weights`` takes a lookup from a Keras layer name to its dict of
arrays: a mapping, or a callable such as the ``.h5`` reader
``_find_weights``, so a configuration and weight arrays built in code
import without h5py.  h5py is imported only by the functions that read
``.h5`` files.  A functional (non-Sequential) model builds a
``ComputationGraph`` whose vertices carry the Keras layer names: Add,
Average, Maximum, Subtract and Multiply become ``ElementWiseVertex``es,
Concatenate a ``MergeVertex``, Flatten and Reshape name their input (the
graph inserts the flatten before a dense layer), and an LSTM without
``return_sequences`` is followed by a ``LastTimeStepVertex``
``"<name>-last"``.  Entry points build the network on the CUDA device
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ElementWiseVertex, GraphBuilder, LastTimeStepVertex, LayerVertex,
    MergeVertex, PreprocessorVertex)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.network import (
    GlobalConf, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops.platform import DeviceLike

_ACT_MAP = {
    "relu": "relu", "softmax": "softmax", "sigmoid": "sigmoid",
    "tanh": "tanh", "linear": "identity", "elu": "elu", "selu": "selu",
    "softplus": "softplus", "softsign": "softsign",
    "hard_sigmoid": "hardsigmoid", "swish": "swish", "silu": "swish",
    "gelu": "gelu", "leaky_relu": "leakyrelu", "relu6": "relu6",
}

_LOSS_MAP = {
    "categorical_crossentropy": "mcxent",
    "binary_crossentropy": "xent",
    "mean_squared_error": "mse", "mse": "mse",
    "mean_absolute_error": "mae", "mae": "mae",
    "mean_absolute_percentage_error": "mape",
    "mean_squared_logarithmic_error": "msle",
    "hinge": "hinge", "squared_hinge": "squared_hinge",
    "poisson": "poisson", "cosine_proximity": "cosine_proximity",
    "kullback_leibler_divergence": "kl_divergence",
}

WeightLookup = Union[Mapping[str, Dict[str, np.ndarray]],
                     Callable[[str], Dict[str, np.ndarray]]]


def _act(cfg: dict) -> str:
    a = cfg.get("activation", "linear")
    if isinstance(a, dict):  # keras 3 serialized activation
        a = a.get("config", {}).get("name", a.get("class_name", "linear"))
    return _ACT_MAP.get(str(a).lower(), "identity")


def _pair(v) -> tuple:
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


class KerasLayerMapper:
    """Maps one Keras layer config dict → the port's layer conf (or None
    for structural layers like Flatten/InputLayer)."""

    def map(self, class_name: str, cfg: dict, is_output: bool,
            loss: Optional[str]) -> Optional[L.Layer]:
        name = cfg.get("name")
        if class_name in ("InputLayer", "Flatten", "Reshape"):
            return None
        if class_name == "Dense":
            act = _act(cfg)
            if is_output:
                return L.OutputLayer(
                    name=name, n_out=cfg["units"], activation=act,
                    loss=loss or ("mcxent" if act == "softmax" else "mse"))
            return L.DenseLayer(name=name, n_out=cfg["units"], activation=act)
        if class_name in ("Conv2D", "Convolution2D"):
            pad = cfg.get("padding", cfg.get("border_mode", "valid"))
            return L.ConvolutionLayer(
                name=name,
                n_out=cfg["filters"] if "filters" in cfg else cfg["nb_filter"],
                kernel=_pair(cfg.get("kernel_size",
                                     (cfg.get("nb_row", 3),
                                      cfg.get("nb_col", 3)))),
                stride=_pair(cfg.get("strides", (1, 1))),
                convolution_mode="same" if pad == "same" else "truncate",
                activation=_act(cfg))
        if class_name in ("MaxPooling2D", "AveragePooling2D"):
            kind = "max" if class_name.startswith("Max") else "avg"
            pad = cfg.get("padding", cfg.get("border_mode", "valid"))
            pool = _pair(cfg.get("pool_size", (2, 2)))
            return L.SubsamplingLayer(
                name=name, pooling_type=kind, kernel=pool,
                stride=_pair(cfg.get("strides") or pool),
                convolution_mode="same" if pad == "same" else "truncate")
        if class_name in ("GlobalMaxPooling2D", "GlobalAveragePooling2D",
                          "GlobalMaxPooling1D", "GlobalAveragePooling1D"):
            kind = "max" if "Max" in class_name else "avg"
            return L.GlobalPoolingLayer(name=name, pooling_type=kind)
        if class_name == "Dropout":
            # keras rate = DROP probability; the port's dropout = RETAIN
            return L.DropoutLayer(name=name, dropout=1.0 - cfg.get("rate", 0.5))
        if class_name == "Activation":
            return L.ActivationLayer(name=name, activation=_act(cfg))
        if class_name == "BatchNormalization":
            return L.BatchNormalization(
                name=name, decay=cfg.get("momentum", 0.99),
                eps=cfg.get("epsilon", 1e-3))
        if class_name == "Embedding":
            return L.EmbeddingLayer(
                name=name, n_in=cfg.get("input_dim"),
                n_out=cfg.get("output_dim"), activation="identity")
        if class_name == "LSTM":
            return L.GravesLSTM(
                name=name, n_out=cfg["units"],
                activation=_ACT_MAP.get(str(cfg.get("activation", "tanh")),
                                        "tanh"),
                gate_activation=_ACT_MAP.get(
                    str(cfg.get("recurrent_activation", "sigmoid")),
                    "sigmoid"),
                forget_gate_bias_init=1.0 if cfg.get("unit_forget_bias",
                                                     True) else 0.0)
        if class_name == "ZeroPadding2D":
            p = cfg.get("padding", (1, 1))
            if isinstance(p, (list, tuple)) and isinstance(p[0],
                                                           (list, tuple)):
                return L.ZeroPaddingLayer(name=name, pad=(p[0][0], p[0][1],
                                                          p[1][0], p[1][1]))
            ph, pw = _pair(p)
            return L.ZeroPaddingLayer(name=name, pad=(ph, ph, pw, pw))
        raise ValueError(
            f"Unsupported Keras layer type '{class_name}' "
            f"(ref parity: KerasLayer.java supported set)")


def _input_type_from_shape(shape) -> Optional[InputType]:
    dims = [d for d in shape if d is not None]
    if len(dims) == 3:
        # keras channels_last [H, W, C] → NCHW InputType
        return InputType.convolutional(dims[0], dims[1], dims[2])
    if len(dims) == 2:
        return InputType.recurrent(dims[1], dims[0])
    if len(dims) == 1:
        return InputType.feed_forward(dims[0])
    return None


def _loss_of(training_config: dict) -> Optional[str]:
    """The port's loss name for a Keras training configuration's loss."""
    loss = training_config.get("loss")
    if isinstance(loss, dict):
        loss = next(iter(loss.values()), None)
    if isinstance(loss, dict):  # keras3 serialized loss object
        loss = loss.get("config", {}).get("name")
    return _LOSS_MAP.get(str(loss).lower()) if loss else None


def _read_config(path_or_json) -> dict:
    if isinstance(path_or_json, str) and \
            path_or_json.lstrip().startswith("{"):
        return json.loads(path_or_json)
    with open(path_or_json) as fh:
        return json.load(fh)


class KerasModelImport:
    """(ref: keras/KerasModelImport.java)"""

    @staticmethod
    def import_keras_sequential_model_and_weights(
            path, enforce_training_config=False,
            device: DeviceLike = None) -> MultiLayerNetwork:
        import h5py
        with h5py.File(path, "r") as f:
            model_config = json.loads(f.attrs["model_config"])
            training_config = (json.loads(f.attrs["training_config"])
                               if "training_config" in f.attrs else {})
            net = KerasModelImport._build_sequential(
                model_config, training_config, device)
            KerasModelImport._load_weights(
                net, lambda name: KerasModelImport._find_weights(f, name))
        return net

    @staticmethod
    def import_keras_model_and_weights(path, device: DeviceLike = None):
        """A Sequential model → MultiLayerNetwork; a functional one →
        ComputationGraph (ref: importKerasModelAndWeights → KerasModel)."""
        import h5py
        with h5py.File(path, "r") as f:
            model_config = json.loads(f.attrs["model_config"])
            training_config = (json.loads(f.attrs["training_config"])
                               if "training_config" in f.attrs else {})
            net = KerasModelImport._build(model_config, training_config,
                                          device)
            KerasModelImport._load_weights(
                net, lambda name: KerasModelImport._find_weights(f, name))
        return net

    @staticmethod
    def import_keras_sequential_configuration(
            path_or_json, device: DeviceLike = None) -> MultiLayerNetwork:
        """The network of a Keras ``model_config`` (a JSON string or a
        file holding it), uninitialized; ``_load_weights`` fills it."""
        return KerasModelImport._build_sequential(
            _read_config(path_or_json), {}, device)

    # ------------------------------------------------------------------
    @staticmethod
    def _build(model_config: dict, training_config: dict,
               device: DeviceLike = None):
        if model_config.get("class_name") == "Sequential":
            return KerasModelImport._build_sequential(
                model_config, training_config, device)
        return KerasModelImport._build_functional(
            model_config, training_config, device)

    @staticmethod
    def _build_sequential(model_config: dict, training_config: dict,
                          device: DeviceLike = None) -> MultiLayerNetwork:
        if model_config.get("class_name") != "Sequential":
            raise ValueError(
                "Use import_keras_model_and_weights for functional models")
        cfg = model_config["config"]
        layer_dicts = cfg["layers"] if isinstance(cfg, dict) else cfg
        loss = _loss_of(training_config)

        mapper = KerasLayerMapper()
        input_type = None
        mapped: List[L.Layer] = []
        keras_names: List[Optional[str]] = []  # per mapped layer
        for i, ld in enumerate(layer_dicts):
            cls = ld["class_name"]
            lcfg = ld.get("config", {})
            if input_type is None:
                shape = (lcfg.get("batch_input_shape")
                         or lcfg.get("batch_shape") or lcfg.get("input_shape"))
                if shape:
                    input_type = _input_type_from_shape(
                        shape[1:] if shape[0] is None else shape)
            is_output = (i == len(layer_dicts) - 1)
            layer = mapper.map(cls, lcfg, is_output, loss)
            if layer is not None:
                mapped.append(layer)
                keras_names.append(lcfg.get("name"))
                # Keras LSTM(return_sequences=False), the default, keeps
                # only the last time step (ref: KerasLstm)
                if cls == "LSTM" and not lcfg.get("return_sequences", False):
                    mapped.append(L.LastTimeStepLayer())
                    keras_names.append(None)
        if not isinstance(mapped[-1], (L.OutputLayer, L.RnnOutputLayer,
                                       L.LossLayer)):
            # a trailing loss head, so the imported network can fit()
            mapped.append(L.LossLayer(loss=loss or "mse",
                                      activation="identity"))
            keras_names.append(None)

        b = NeuralNetConfiguration.builder().list()
        for layer in mapped:
            b.layer(layer)
        if input_type is not None:
            b.set_input_type(input_type)
        net = MultiLayerNetwork(b.build(), device=device)
        net.keras_layer_names = keras_names
        return net

    @staticmethod
    def _inbound_names(layer_dict: dict) -> List[str]:
        """Upstream layer names from ``inbound_nodes`` (the Keras 2
        nested-list and the Keras 3 ``keras_history`` layouts)."""
        names: List[str] = []

        def walk(obj):
            if isinstance(obj, dict):
                hist = obj.get("config", {}).get("keras_history") \
                    if obj.get("class_name") == "__keras_tensor__" else None
                if hist:
                    names.append(hist[0])
                    return
                for val in obj.values():
                    walk(val)
            elif isinstance(obj, (list, tuple)):
                if (len(obj) >= 3 and isinstance(obj[0], str)
                        and isinstance(obj[1], int)
                        and isinstance(obj[2], int)):
                    names.append(obj[0])  # keras2 [name, node, tensor, {}]
                    return
                for val in obj:
                    walk(val)

        walk(layer_dict.get("inbound_nodes", []))
        return names

    @staticmethod
    def _build_functional(model_config: dict, training_config: dict,
                          device: DeviceLike = None) -> ComputationGraph:
        """Functional-API configuration → ComputationGraph
        (ref: KerasModel.java:59)."""
        cfg = model_config["config"]

        def spec_names(specs) -> List[str]:
            # [["a", 0, 0], ["b", 0, 0]] (several) or ["a", 0, 0] (keras3)
            if specs and isinstance(specs[0], str):
                return [specs[0]]
            return [sp[0] for sp in specs]

        input_names = spec_names(cfg.get("input_layers", []))
        output_names = spec_names(cfg.get("output_layers", []))
        loss = _loss_of(training_config)
        mapper = KerasLayerMapper()
        b = GraphBuilder(GlobalConf()).add_inputs(*input_names)
        alias: Dict[str, str] = {}  # keras name → vertex name
        input_types: Dict[str, InputType] = {}
        merges = {"Add": "add", "Average": "average", "Maximum": "max",
                  "Subtract": "subtract", "Multiply": "product"}
        for ld in cfg["layers"]:
            cls = ld["class_name"]
            lcfg = ld.get("config", {})
            name = lcfg.get("name", ld.get("name"))
            ins = [alias.get(i, i)
                   for i in KerasModelImport._inbound_names(ld)]
            if cls == "InputLayer":
                shape = (lcfg.get("batch_shape")
                         or lcfg.get("batch_input_shape"))
                it = _input_type_from_shape(shape[1:]) if shape else None
                if it:
                    input_types[name] = it
                alias[name] = name
                continue
            if cls in merges:
                b.add_vertex(name, ElementWiseVertex(op=merges[cls]), *ins)
                alias[name] = name
                continue
            if cls in ("Concatenate", "Merge"):
                b.add_vertex(name, MergeVertex(), *ins)
                alias[name] = name
                continue
            layer = (None if cls in ("Flatten", "Reshape") else
                     mapper.map(cls, lcfg, name in output_names, loss))
            if layer is None:
                # structural only: the flatten before a dense layer is
                # inserted by the graph
                alias[name] = ins[0]
                continue
            b.add_layer(name, layer, *ins)
            alias[name] = name
            if cls == "LSTM" and not lcfg.get("return_sequences", False):
                b.add_vertex(f"{name}-last", LastTimeStepVertex(), name)
                alias[name] = f"{name}-last"
        b.set_outputs(*[alias.get(n, n) for n in output_names])
        if input_types:
            b.set_input_types(*[input_types[n] for n in input_names])
        return ComputationGraph(b.build(), device=device)

    # ------------------------------------------------------------------
    @staticmethod
    def _find_weights(h5file, keras_name: str) -> Dict[str, np.ndarray]:
        """A layer's weight datasets in the keras2 or keras3 layouts."""
        import h5py
        root = h5file["model_weights"] if "model_weights" in h5file \
            else h5file
        if keras_name not in root:
            return {}
        found: Dict[str, np.ndarray] = {}

        def walk(group):
            for k in group:
                item = group[k]
                if isinstance(item, h5py.Group):
                    walk(item)
                else:
                    found.setdefault(k.split(":")[0], np.asarray(item))

        walk(root[keras_name])
        return found

    @staticmethod
    def _map_layer_weights(layer: L.Layer, w: Dict[str, np.ndarray],
                           p: dict, state: dict, device: torch.device,
                           flatten_proc=None):
        """One Keras layer's weight dict → the layer's param and state
        dicts (layouts in the module docstring)."""
        p = dict(p)
        state = dict(state)
        if isinstance(layer, L.ConvolutionLayer):
            kern = w.get("kernel", w.get("param_0"))
            p["W"] = np.transpose(kern, (3, 2, 0, 1))  # HWIO → OIHW
            if "bias" in w or "param_1" in w:
                p["b"] = w.get("bias", w.get("param_1"))
        elif isinstance(layer, L.BatchNormalization):
            if "gamma" in w:
                p["gamma"] = w["gamma"]
            if "beta" in w:
                p["beta"] = w["beta"]
            if "moving_mean" in w:
                state["mean"] = w["moving_mean"]
            if "moving_variance" in w:
                state["var"] = w["moving_variance"]
        elif isinstance(layer, L.GravesLSTM):
            kern = w.get("kernel", w.get("param_0"))
            rec = w.get("recurrent_kernel", w.get("param_1"))
            bias = w.get("bias", w.get("param_2"))
            H = layer.n_out

            def reorder(m):  # keras gate order i,f,c,o → i,f,o,c
                i, fgt, c, o = np.split(np.asarray(m), 4, axis=-1)
                return np.concatenate([i, fgt, o, c], axis=-1)

            p["W"] = reorder(kern)
            p["RW"] = reorder(rec)
            if bias is not None:
                p["b"] = reorder(np.asarray(bias).reshape(1, -1)).reshape(-1)
            for k in ("pI", "pF", "pO"):
                p[k] = np.zeros(H, np.float32)
        elif isinstance(layer, (L.DenseLayer, L.EmbeddingLayer)):
            kern = np.asarray(w.get("kernel", w.get("embeddings",
                                                    w.get("param_0"))))
            # a Dense right after a conv flatten: keras flattened HWC, the
            # port's CnnToFeedForward flattens CHW — permute the rows
            # (KerasModel.java's weight copy does the same)
            if (isinstance(layer, L.DenseLayer)
                    and isinstance(flatten_proc,
                                   CnnToFeedForwardPreProcessor)):
                H, W, C = (flatten_proc.height, flatten_proc.width,
                           flatten_proc.channels)
                if kern.shape[0] == H * W * C:
                    hwc = kern.reshape(H, W, C, -1)
                    kern = np.transpose(hwc, (2, 0, 1, 3)).reshape(
                        H * W * C, -1)
            p["W"] = kern
            if "bias" in w or "param_1" in w:
                p["b"] = w.get("bias", w.get("param_1"))

        def tensor(v):
            if isinstance(v, torch.Tensor):
                return v
            return torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
        return ({k: tensor(v) for k, v in p.items()},
                {k: tensor(v) for k, v in state.items()})

    @staticmethod
    def _load_weights(net, weights: WeightLookup) -> None:
        """``net.init()``, then each Keras-named layer's params and state
        from ``weights``: a mapping or a callable from a Keras layer name
        to its dict of arrays (a name it lacks keeps the layer's init).
        A MultiLayerNetwork's layers carry their Keras names in
        ``keras_layer_names``; a ComputationGraph's vertices are named by
        them, and a dense vertex takes the flatten of an upstream
        ``PreprocessorVertex`` (the graph's ``"-cnn2ff"``)."""
        lookup = weights if callable(weights) else \
            (lambda name: weights.get(name, {}))
        net.init()
        if isinstance(net, ComputationGraph):
            slots = []
            for name in net.order:
                v = net.conf.vertices[name]
                if not isinstance(v, LayerVertex):
                    continue
                up = net.conf.vertices.get(
                    (net.conf.vertex_inputs[name] or [None])[0])
                slots.append((name, v.layer_conf(), name,
                              up.proc() if isinstance(up, PreprocessorVertex)
                              else None))
        else:
            slots = [(li, layer, kname, net.conf.preprocessors.get(li))
                     for li, (layer, kname) in enumerate(
                         zip(net.layers, net.keras_layer_names))]
        for key, layer, kname, proc in slots:
            if kname is None or not layer.has_params():
                continue
            w = lookup(kname)
            if not w:
                continue
            p, s = KerasModelImport._map_layer_weights(
                layer, w, net.net_params[key], net.net_state[key],
                net.device, flatten_proc=proc)
            net.net_params[key] = p
            net.net_state[key] = s
