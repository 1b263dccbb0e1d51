"""ComputationGraph configuration — the port of
``deeplearning4j_tpu/nn/conf/graph_conf.py``: a DAG of vertices.

(ref: nn/conf/ComputationGraphConfiguration.java,
nn/graph/vertex/impl/{LayerVertex, MergeVertex, ElementWiseVertex,
StackVertex, UnstackVertex, SubsetVertex, ScaleVertex, ShiftVertex,
L2Vertex, L2NormalizeVertex, PreprocessorVertex}.java and
rnn/{LastTimeStepVertex, DuplicateToTimeSeriesVertex}.java)

Each vertex is a dataclass: ``initialize`` draws its params (a
``LayerVertex``'s layer's), ``initial_state`` gives its starting state and
``forward(params, state, inputs, train, seed, masks)`` maps a LIST of
input tensors to ``(output, new state, output mask)``.  The fields and the
JSON are the JAX package's, so a configuration written by either package
builds the same graph in the other.  ``topological_order`` is the JAX
package's Kahn order to the letter: the flat ``coefficients.bin`` and
``updaterState.bin`` follow it.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.conf import preprocessors as pp
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import BatchNormalization, Layer
from deeplearning4j_tpu_torch.nn.conf.network import (
    GlobalConf, _needs, merge_layer_conf)

VERTEX_REGISTRY: Dict[str, type] = {}


def register_vertex(cls):
    VERTEX_REGISTRY[cls.__name__] = cls
    return cls


@dataclasses.dataclass
class GraphVertexConf:
    def initialize(self, generator: torch.Generator,
                   input_types: List[InputType], device: torch.device
                   ) -> Tuple[dict, InputType]:
        return {}, self.output_type(input_types)

    def initial_state(self, input_types: List[InputType],
                      device: torch.device) -> dict:
        return {}

    def forward(self, params, state, inputs: List, train: bool = False,
                seed=None, masks=None):
        raise NotImplementedError

    def output_type(self, input_types: List[InputType]) -> InputType:
        raise NotImplementedError

    def output_mask(self, masks):
        return masks[0] if masks else None

    def has_params(self) -> bool:
        return False

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["@class"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d: dict) -> "GraphVertexConf":
        d = dict(d)
        name = d.pop("@class")
        if name not in VERTEX_REGISTRY:
            raise NotImplementedError(
                f"vertex type {name!r} is not ported to "
                f"deeplearning4j_tpu_torch (ported: "
                f"{sorted(VERTEX_REGISTRY)})")
        return VERTEX_REGISTRY[name](**d)


@register_vertex
@dataclasses.dataclass
class LayerVertex(GraphVertexConf):
    """Wraps a layer config (ref: nn/graph/vertex/impl/LayerVertex.java).
    The layer object is built once from its dict and kept, so every
    forward runs the same object."""

    layer: Optional[dict] = None  # serialized Layer

    def layer_conf(self) -> Layer:
        built = self.__dict__.get("_layer")
        if built is None:
            built = Layer.from_dict(self.layer)
            self.__dict__["_layer"] = built
        return built

    def has_params(self):
        return self.layer_conf().has_params()

    def initialize(self, generator, input_types, device):
        return self.layer_conf().initialize(generator, input_types[0], device)

    def initial_state(self, input_types, device):
        return self.layer_conf().initial_state(input_types[0], device)

    def forward(self, params, state, inputs, train=False, seed=None,
                masks=None):
        mask = masks[0] if masks else None
        return self.layer_conf().forward(params, state, inputs[0], train,
                                         seed, mask)

    def output_type(self, input_types):
        return self.layer_conf().output_type(input_types[0])

    @staticmethod
    def of(layer: Layer) -> "LayerVertex":
        return LayerVertex(layer=layer.to_dict())


@register_vertex
@dataclasses.dataclass
class MergeVertex(GraphVertexConf):
    """Concatenate along the feature axis (ref: MergeVertex.java): axis 1
    for FF and CNN (NCHW), axis 2 for RNN [N, T, C]."""

    def forward(self, params, state, inputs, train=False, seed=None,
                masks=None):
        axis = 2 if inputs[0].ndim == 3 else 1
        return torch.cat(inputs, dim=axis), state, self.output_mask(masks)

    def output_type(self, input_types):
        t = input_types[0]
        if t.kind == "cnn":
            return InputType.convolutional(
                t.height, t.width, sum(i.channels for i in input_types))
        if t.kind == "rnn":
            return InputType.recurrent(sum(i.size for i in input_types),
                                       t.timesteps)
        return InputType.feed_forward(sum(i.flat_size()
                                          for i in input_types))


@register_vertex
@dataclasses.dataclass
class ElementWiseVertex(GraphVertexConf):
    """(ref: ElementWiseVertex.java) op: add | subtract | product | average
    | max."""

    op: str = "add"

    def forward(self, params, state, inputs, train=False, seed=None,
                masks=None):
        op = self.op.lower()
        if op == "add":
            out = sum(inputs[1:], inputs[0])
        elif op == "subtract":
            out = inputs[0] - inputs[1]
        elif op in ("product", "mul"):
            out = inputs[0]
            for i in inputs[1:]:
                out = out * i
        elif op in ("average", "avg"):
            out = sum(inputs[1:], inputs[0]) / len(inputs)
        elif op == "max":
            out = torch.stack(inputs).amax(dim=0)
        else:
            raise ValueError(f"Unknown ElementWise op '{self.op}'")
        return out, state, self.output_mask(masks)

    def output_type(self, input_types):
        return input_types[0]


@register_vertex
@dataclasses.dataclass
class StackVertex(GraphVertexConf):
    """Stack along the batch axis (ref: StackVertex.java); an input
    without a mask counts as all valid."""

    def forward(self, params, state, inputs, train=False, seed=None,
                masks=None):
        m = None
        if masks and any(mm is not None for mm in masks):
            ref = next(mm for mm in masks if mm is not None)
            filled = [mm if mm is not None else
                      torch.ones((x.shape[0],) + tuple(ref.shape[1:]),
                                 dtype=ref.dtype, device=ref.device)
                      for mm, x in zip(masks, inputs)]
            m = torch.cat(filled, dim=0)
        return torch.cat(inputs, dim=0), state, m

    def output_type(self, input_types):
        return input_types[0]


@register_vertex
@dataclasses.dataclass
class UnstackVertex(GraphVertexConf):
    """Slice ``from_idx`` of ``stack_size`` equal batch chunks
    (ref: UnstackVertex.java)."""

    from_idx: int = 0
    stack_size: int = 1

    def forward(self, params, state, inputs, train=False, seed=None,
                masks=None):
        x = inputs[0]
        step = x.shape[0] // self.stack_size
        sl = slice(self.from_idx * step, (self.from_idx + 1) * step)
        m = masks[0][sl] if (masks and masks[0] is not None) else None
        return x[sl], state, m

    def output_type(self, input_types):
        return input_types[0]


@register_vertex
@dataclasses.dataclass
class SubsetVertex(GraphVertexConf):
    """Feature range [from, to], inclusive (ref: SubsetVertex.java)."""

    from_idx: int = 0
    to_idx: int = 0

    def forward(self, params, state, inputs, train=False, seed=None,
                masks=None):
        x = inputs[0]
        sl = slice(self.from_idx, self.to_idx + 1)
        out = x[:, :, sl] if x.ndim == 3 else x[:, sl]
        return out, state, self.output_mask(masks)

    def output_type(self, input_types):
        n = self.to_idx - self.from_idx + 1
        t = input_types[0]
        if t.kind == "rnn":
            return InputType.recurrent(n, t.timesteps)
        if t.kind == "cnn":
            return InputType.convolutional(t.height, t.width, n)
        return InputType.feed_forward(n)


@register_vertex
@dataclasses.dataclass
class ScaleVertex(GraphVertexConf):
    """(ref: ScaleVertex.java)"""

    scale: float = 1.0

    def forward(self, params, state, inputs, train=False, seed=None,
                masks=None):
        return inputs[0] * self.scale, state, self.output_mask(masks)

    def output_type(self, input_types):
        return input_types[0]


@register_vertex
@dataclasses.dataclass
class ShiftVertex(GraphVertexConf):
    """(ref: ShiftVertex.java)"""

    shift: float = 0.0

    def forward(self, params, state, inputs, train=False, seed=None,
                masks=None):
        return inputs[0] + self.shift, state, self.output_mask(masks)

    def output_type(self, input_types):
        return input_types[0]


@register_vertex
@dataclasses.dataclass
class L2Vertex(GraphVertexConf):
    """Pairwise L2 distance of two inputs -> [N, 1] (ref: L2Vertex.java)."""

    eps: float = 1e-8

    def forward(self, params, state, inputs, train=False, seed=None,
                masks=None):
        a, b = inputs[0], inputs[1]
        d = a.reshape(a.shape[0], -1) - b.reshape(b.shape[0], -1)
        out = torch.sqrt(torch.sum(d * d, dim=1, keepdim=True) + self.eps)
        return out, state, None

    def output_type(self, input_types):
        return InputType.feed_forward(1)


@register_vertex
@dataclasses.dataclass
class L2NormalizeVertex(GraphVertexConf):
    """x / ||x||_2 per example (ref: L2NormalizeVertex.java)."""

    eps: float = 1e-8

    def forward(self, params, state, inputs, train=False, seed=None,
                masks=None):
        x = inputs[0]
        flat = x.reshape(x.shape[0], -1)
        norm = torch.linalg.vector_norm(flat, dim=1, keepdim=True)
        out = (flat / (norm + self.eps)).reshape(x.shape)
        return out, state, self.output_mask(masks)

    def output_type(self, input_types):
        return input_types[0]


@register_vertex
@dataclasses.dataclass
class PreprocessorVertex(GraphVertexConf):
    """An InputPreProcessor as a vertex (ref: PreprocessorVertex.java)."""

    preprocessor: Optional[dict] = None

    def proc(self) -> pp.InputPreProcessor:
        built = self.__dict__.get("_proc")
        if built is None:
            built = pp.InputPreProcessor.from_dict(self.preprocessor)
            self.__dict__["_proc"] = built
        return built

    def forward(self, params, state, inputs, train=False, seed=None,
                masks=None):
        y, m = self.proc()(inputs[0], masks[0] if masks else None)
        return y, state, m

    def output_type(self, input_types):
        return self.proc().output_type(input_types[0])

    @staticmethod
    def of(proc: pp.InputPreProcessor) -> "PreprocessorVertex":
        return PreprocessorVertex(preprocessor=proc.to_dict())


@register_vertex
@dataclasses.dataclass
class LastTimeStepVertex(GraphVertexConf):
    """[N, T, C] -> [N, C] at the last unmasked step
    (ref: rnn/LastTimeStepVertex.java); the mask comes from the network
    input named ``mask_input``."""

    mask_input: Optional[str] = None

    def forward(self, params, state, inputs, train=False, seed=None,
                masks=None):
        x = inputs[0]
        mask = masks[0] if masks else None
        if mask is None:
            return x[:, -1], state, None
        idx = ((mask > 0).sum(dim=1) - 1).clamp_min(0)
        return x[torch.arange(x.shape[0], device=x.device), idx], state, None

    def output_type(self, input_types):
        return InputType.feed_forward(input_types[0].size)


@register_vertex
@dataclasses.dataclass
class DuplicateToTimeSeriesVertex(GraphVertexConf):
    """[N, C] -> [N, T, C] by repetition, T from a reference sequence, which
    the graph passes as ``inputs[1]``
    (ref: rnn/DuplicateToTimeSeriesVertex.java)."""

    ts_input: Optional[str] = None

    def forward(self, params, state, inputs, train=False, seed=None,
                masks=None):
        x = inputs[0]
        T = inputs[1].shape[1]
        out = x[:, None, :].expand(x.shape[0], T, x.shape[-1])
        m = masks[1] if masks and len(masks) > 1 else None
        return out, state, m

    def output_type(self, input_types):
        t = input_types[1].timesteps if len(input_types) > 1 else None
        return InputType.recurrent(input_types[0].flat_size(), t)


@register_vertex
@dataclasses.dataclass
class ReshapeVertex(GraphVertexConf):
    """Reshape the trailing dims, batch kept (ref: ReshapeVertex.java)."""

    shape: Optional[tuple] = None  # the new shape without the batch

    def forward(self, params, state, inputs, train=False, seed=None,
                masks=None):
        x = inputs[0]
        return (x.reshape((x.shape[0],) + tuple(self.shape)), state,
                self.output_mask(masks))

    def output_type(self, input_types):
        if len(self.shape) == 3:
            return InputType.convolutional(self.shape[1], self.shape[2],
                                           self.shape[0])
        return InputType.feed_forward(math.prod(self.shape))


# ==========================================================================
# Configuration + builder
# ==========================================================================

@dataclasses.dataclass
class ComputationGraphConfiguration:
    """(ref: nn/conf/ComputationGraphConfiguration.java)"""

    network_inputs: List[str]
    network_outputs: List[str]
    vertices: Dict[str, GraphVertexConf]
    vertex_inputs: Dict[str, List[str]]
    global_conf: GlobalConf
    input_types: Optional[List[InputType]] = None
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20

    def topological_order(self) -> List[str]:
        """Kahn's algorithm over the vertex dependencies, the ready list
        sorted at the start and each vertex's consumers sorted
        (ref: ComputationGraph.topologicalOrder :122)."""
        indeg = {name: 0 for name in self.vertices}
        for name, ins in self.vertex_inputs.items():
            indeg[name] = sum(1 for i in ins if i in self.vertices)
        ready = sorted([n for n, d in indeg.items() if d == 0])
        order = []
        consumers: Dict[str, List[str]] = {}
        for name, ins in self.vertex_inputs.items():
            for i in ins:
                if i in self.vertices:
                    consumers.setdefault(i, []).append(name)
        while ready:
            n = ready.pop(0)
            order.append(n)
            for c in sorted(consumers.get(n, [])):
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
        if len(order) != len(self.vertices):
            raise ValueError("Cycle detected in ComputationGraph")
        return order

    def to_dict(self) -> dict:
        return {
            "global": dataclasses.asdict(self.global_conf),
            "network_inputs": self.network_inputs,
            "network_outputs": self.network_outputs,
            "vertices": {k: v.to_dict() for k, v in self.vertices.items()},
            "vertex_inputs": self.vertex_inputs,
            "input_types": ([t.to_dict() for t in self.input_types]
                            if self.input_types else None),
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    def to_yaml(self) -> str:
        """(ref: ComputationGraphConfiguration.toYaml); needs PyYAML."""
        import yaml
        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    @staticmethod
    def from_yaml(s: str) -> "ComputationGraphConfiguration":
        import yaml
        return ComputationGraphConfiguration.from_dict(yaml.safe_load(s))

    @staticmethod
    def from_dict(d: dict) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration(
            network_inputs=list(d["network_inputs"]),
            network_outputs=list(d["network_outputs"]),
            vertices={k: GraphVertexConf.from_dict(v)
                      for k, v in d["vertices"].items()},
            vertex_inputs={k: list(v) for k, v in d["vertex_inputs"].items()},
            global_conf=GlobalConf(**d["global"]),
            input_types=([InputType.from_dict(t) for t in d["input_types"]]
                         if d.get("input_types") else None),
            backprop_type=d.get("backprop_type", "standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
        )

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration.from_dict(json.loads(s))


class GraphBuilder:
    """(ref: ComputationGraphConfiguration.GraphBuilder via
    NeuralNetConfiguration.Builder.graphBuilder())"""

    def __init__(self, g: Optional[GlobalConf] = None):
        self._g = g or GlobalConf()
        self._inputs: List[str] = []
        self._outputs: List[str] = []
        self._vertices: Dict[str, GraphVertexConf] = {}
        self._vertex_inputs: Dict[str, List[str]] = {}
        self._input_types: Optional[List[InputType]] = None
        self._bp_type = "standard"
        self._tf = 20
        self._tb = 20

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str
                  ) -> "GraphBuilder":
        self._vertices[name] = LayerVertex.of(merge_layer_conf(layer,
                                                               self._g))
        self._vertex_inputs[name] = list(inputs)
        return self

    def add_vertex(self, name: str, vertex: GraphVertexConf, *inputs: str
                   ) -> "GraphBuilder":
        self._vertices[name] = vertex
        self._vertex_inputs[name] = list(inputs)
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def set_input_types(self, *types: InputType) -> "GraphBuilder":
        self._input_types = list(types)
        return self

    def backprop_type(self, t: str) -> "GraphBuilder":
        self._bp_type = t.lower()
        return self

    def t_bptt_forward_length(self, n: int) -> "GraphBuilder":
        self._tf = n
        return self

    def t_bptt_backward_length(self, n: int) -> "GraphBuilder":
        self._tb = n
        return self

    def build(self) -> ComputationGraphConfiguration:
        if not self._inputs:
            raise ValueError("GraphBuilder needs at least one input")
        if not self._outputs:
            raise ValueError("GraphBuilder needs at least one output")
        known = set(self._inputs) | set(self._vertices)
        for name, ins in self._vertex_inputs.items():
            for i in ins:
                if i not in known:
                    raise ValueError(
                        f"Vertex '{name}' wired to unknown input '{i}' "
                        f"(known: {sorted(known)})")
        for name in self._outputs:
            if name not in self._vertices:
                raise ValueError(f"Output '{name}' is not a vertex")
        conf = ComputationGraphConfiguration(
            network_inputs=self._inputs, network_outputs=self._outputs,
            vertices=self._vertices, vertex_inputs=self._vertex_inputs,
            global_conf=self._g, input_types=self._input_types,
            backprop_type=self._bp_type, tbptt_fwd_length=self._tf,
            tbptt_back_length=self._tb)
        conf.topological_order()  # validate acyclicity early
        _infer_graph_nin(conf)
        return conf


def _infer_graph_nin(conf: ComputationGraphConfiguration) -> None:
    """Infer nIn (and BatchNormalization's ``n_features``) of each
    LayerVertex from its upstream output type, and insert a
    ``"<name>-cnn2ff"`` flatten PreprocessorVertex between a CNN
    activation and a dense layer (the reference's graph-level
    addPreProcessors pass)."""
    if conf.input_types is None:
        return
    types: Dict[str, InputType] = dict(zip(conf.network_inputs,
                                           conf.input_types))
    for name in conf.topological_order():
        v = conf.vertices[name]
        in_names = conf.vertex_inputs[name]
        in_types = [types[i] for i in in_names]
        if isinstance(v, LayerVertex):
            layer = v.layer_conf()
            if _needs(layer) == "ff" and in_types[0].kind == "cnn":
                t = in_types[0]
                proc = pp.CnnToFeedForwardPreProcessor(t.height, t.width,
                                                       t.channels)
                pv_name = f"{name}-cnn2ff"
                conf.vertices[pv_name] = PreprocessorVertex.of(proc)
                conf.vertex_inputs[pv_name] = [in_names[0]]
                conf.vertex_inputs[name] = [pv_name] + in_names[1:]
                types[pv_name] = proc.output_type(t)
                in_types[0] = types[pv_name]
            updates = {}
            if hasattr(layer, "n_in") and getattr(layer, "n_in") is None:
                t = in_types[0]
                updates["n_in"] = (t.channels if t.kind == "cnn"
                                   else t.flat_size())
            if isinstance(layer, BatchNormalization) and \
                    layer.n_features is None:
                t = in_types[0]
                updates["n_features"] = (t.channels if t.kind == "cnn"
                                         else t.flat_size())
            if updates:
                conf.vertices[name] = LayerVertex.of(
                    dataclasses.replace(layer, **updates))
        types[name] = conf.vertices[name].output_type(in_types)
