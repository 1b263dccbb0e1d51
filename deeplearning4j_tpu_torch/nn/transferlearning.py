"""Transfer learning — the port of ``deeplearning4j_tpu/nn/transferlearning.py``:
copy a trained network, freeze its bottom, replace its top, fine-tune.

(ref: nn/transferlearning/TransferLearning.java:34, the Builder with
fineTuneConfiguration / setFeatureExtractor (freeze up to layer N) /
removeOutputLayer / addLayer / nOutReplace; :425 GraphBuilder;
FineTuneConfiguration.java; TransferLearningHelper.java, featurization
by running the frozen layers once.)

The rules are the JAX package's: ``n_out_replace`` re-initializes the
layer and the ``n_in`` of the layer that reads it; an edit of a layer
that an earlier transfer froze edits its inner layer and keeps it
frozen; the source's weights are kept wherever a layer is not
re-initialized and its param shapes match; removing a vertex that a kept
vertex still reads raises.  Where a layer's weights are kept, so is its
state (batch norm's running statistics), as in DL4J, whose batch norm
holds its mean and variance among its params
(nn/params/BatchNormalizationParamInitializer.java:59-80) and whose
builders copy a kept layer's params; the JAX package's builders give a
kept layer its initial state instead, so a frozen batch norm there
normalizes with mean 0 and variance 1.  New and re-initialized layers
draw from the port's generator (seeded with the fine-tuned
configuration's seed), so their initial weights are not the JAX
package's.  The new network is on the source's device and copies its
weights; its updater state is made at its first step.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional

import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.conf.layers import (
    FrozenLayerConf, Layer, unfrozen)
from deeplearning4j_tpu_torch.nn.conf.network import (
    GlobalConf, MultiLayerConfiguration, merge_layer_conf)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork, _clone


@dataclasses.dataclass
class FineTuneConfiguration:
    """Hyperparameters set on every layer that is not frozen (ref:
    nn/transferlearning/FineTuneConfiguration.java)."""

    learning_rate: Optional[float] = None
    updater: Optional[str] = None
    momentum: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    dropout: Optional[float] = None
    seed: Optional[int] = None
    activation: Optional[str] = None
    weight_init: Optional[str] = None

    def apply_to_global(self, g: GlobalConf) -> GlobalConf:
        g = copy.deepcopy(g)
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is not None and hasattr(g, f.name):
                setattr(g, f.name, v)
        if self.l1 is not None or self.l2 is not None:
            g.use_regularization = True
        return g

    def apply_to_layer(self, layer: Layer) -> Layer:
        updates = {}
        for f in ("learning_rate", "updater", "momentum", "l1", "l2",
                  "dropout"):
            v = getattr(self, f)
            if v is not None and hasattr(layer, f):
                updates[f] = v
        return dataclasses.replace(layer, **updates) if updates else layer


def _replace_unwrapped(layer: Layer, **changes) -> Layer:
    """``layer`` with ``changes``; a FrozenLayerConf (frozen by an earlier
    transfer) has its inner layer edited and stays frozen."""
    if isinstance(layer, FrozenLayerConf):
        return FrozenLayerConf.wrap(
            dataclasses.replace(layer._inner(), **changes))
    return dataclasses.replace(layer, **changes)


def _same_shapes(state: dict, fresh: dict) -> bool:
    """Whether a layer's state has the keys and shapes of its fresh one
    (an RNN carry is left behind)."""
    return set(state) == set(fresh) and all(
        state[k].shape == t.shape for k, t in fresh.items())


class TransferLearningBuilder:
    """(ref: TransferLearning.Builder)"""

    def __init__(self, net: MultiLayerNetwork):
        self._net = net
        self._fine_tune: Optional[FineTuneConfiguration] = None
        self._freeze_until: Optional[int] = None
        self._n_out_replace: dict = {}
        self._remove_from: Optional[int] = None
        self._added: List[Layer] = []

    def fine_tune_configuration(self, ftc: FineTuneConfiguration):
        self._fine_tune = ftc
        return self

    def set_feature_extractor(self, layer_idx: int):
        """Freeze layers 0 .. ``layer_idx`` (ref: setFeatureExtractor)."""
        self._freeze_until = layer_idx
        return self

    def n_out_replace(self, layer_idx: int, n_out: int,
                      weight_init: Optional[str] = None):
        """Give the layer ``n_out`` outputs: it and the ``n_in`` of the
        next layer are re-initialized."""
        self._n_out_replace[layer_idx] = (n_out, weight_init)
        return self

    def remove_output_layer(self):
        return self.remove_layers_from_output(1)

    def remove_layers_from_output(self, n: int):
        self._remove_from = len(self._net.layers) - n
        return self

    def add_layer(self, layer: Layer):
        self._added.append(layer)
        return self

    def build(self) -> MultiLayerNetwork:
        src = self._net
        conf = copy.deepcopy(src.conf)
        layers = list(conf.layers)
        params = _clone(src.net_params) if src.net_params else None
        states = _clone(src.net_state)
        if self._remove_from is not None:
            layers = layers[:self._remove_from]
            if params:
                params = params[:self._remove_from]

        g = conf.global_conf
        if self._fine_tune:
            g = self._fine_tune.apply_to_global(g)

        reinit: set = set()
        for idx, (n_out, winit) in self._n_out_replace.items():
            layers[idx] = _replace_unwrapped(
                layers[idx], n_out=n_out,
                **({"weight_init": winit} if winit else {}))
            reinit.add(idx)
            if idx + 1 < len(layers) and \
                    hasattr(unfrozen(layers[idx + 1]), "n_in"):
                layers[idx + 1] = _replace_unwrapped(layers[idx + 1],
                                                     n_in=n_out)
                reinit.add(idx + 1)

        for layer in self._added:
            layers.append(merge_layer_conf(layer, g))
            if params is not None:
                params.append(None)          # initialized below
            reinit.add(len(layers) - 1)

        frozen_until = -1 if self._freeze_until is None \
            else self._freeze_until
        if self._fine_tune:
            layers = [l if i <= frozen_until
                      else self._fine_tune.apply_to_layer(l)
                      for i, l in enumerate(layers)]
        layers = [FrozenLayerConf.wrap(l)
                  if i <= frozen_until and not isinstance(l, FrozenLayerConf)
                  else l for i, l in enumerate(layers)]

        new_conf = MultiLayerConfiguration(
            layers=layers, global_conf=g, input_type=conf.input_type,
            preprocessors=conf.preprocessors, backprop=conf.backprop,
            pretrain=conf.pretrain, backprop_type=conf.backprop_type,
            tbptt_fwd_length=conf.tbptt_fwd_length,
            tbptt_back_length=conf.tbptt_back_length)
        net = MultiLayerNetwork(new_conf, device=src.device).init()
        if params is not None:
            # the source's weights wherever the layer is kept and its
            # shapes match
            for i, (old, fresh) in enumerate(zip(params, net.net_params)):
                if i in reinit or old is None or not all(
                        k in old and old[k].shape == t.shape
                        for k, t in fresh.items()):
                    continue
                net.net_params[i] = {k: old[k] for k in fresh}
                if _same_shapes(states[i], net.net_state[i]):
                    net.net_state[i] = states[i]
        return net


class TransferLearningGraphBuilder:
    """ComputationGraph transfer learning (ref: TransferLearning.java:425
    GraphBuilder: fineTuneConfiguration / setFeatureExtractor(vertices) /
    removeVertexAndConnections / addLayer / addVertex / nOutReplace /
    setOutputs)."""

    def __init__(self, net):
        self._net = net
        self._fine_tune: Optional[FineTuneConfiguration] = None
        self._frozen_at: List[str] = []
        self._n_out_replace: dict = {}
        self._removed: List[str] = []
        self._added: List[tuple] = []   # (name, vertex or layer, inputs)
        self._outputs: Optional[List[str]] = None

    def fine_tune_configuration(self, ftc: FineTuneConfiguration):
        self._fine_tune = ftc
        return self

    def set_feature_extractor(self, *vertex_names: str):
        """Freeze the named vertices and every vertex they read from
        (ref: GraphBuilder.setFeatureExtractor)."""
        self._frozen_at = list(vertex_names)
        return self

    def n_out_replace(self, vertex_name: str, n_out: int,
                      weight_init: Optional[str] = None):
        self._n_out_replace[vertex_name] = (n_out, weight_init)
        return self

    def remove_vertex_and_connections(self, name: str):
        self._removed.append(name)
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str):
        self._added.append((name, layer, list(inputs)))
        return self

    def add_vertex(self, name: str, vertex, *inputs: str):
        self._added.append((name, vertex, list(inputs)))
        return self

    def set_outputs(self, *names: str):
        self._outputs = list(names)
        return self

    @staticmethod
    def _ancestors(vertices, vertex_inputs, roots: List[str]) -> set:
        seen, stack = set(), list(roots)
        while stack:
            n = stack.pop()
            if n in seen or n not in vertices:
                continue
            seen.add(n)
            stack.extend(vertex_inputs.get(n, []))
        return seen

    def build(self):
        from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
            ComputationGraphConfiguration, LayerVertex)
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        src = self._net
        conf = copy.deepcopy(src.conf)
        vertices = dict(conf.vertices)
        vertex_inputs = {k: list(v) for k, v in conf.vertex_inputs.items()}
        outputs = list(conf.network_outputs)

        reinit: set = set()
        for name in self._removed:
            vertices.pop(name, None)
            vertex_inputs.pop(name, None)
            outputs = [o for o in outputs if o != name]

        g = conf.global_conf
        if self._fine_tune:
            g = self._fine_tune.apply_to_global(g)

        for name, (n_out, winit) in self._n_out_replace.items():
            lc = _replace_unwrapped(
                vertices[name].layer_conf(), n_out=n_out,
                **({"weight_init": winit} if winit else {}))
            vertices[name] = LayerVertex(layer=lc.to_dict())
            reinit.add(name)
            for k, ins in vertex_inputs.items():
                if name in ins and isinstance(vertices.get(k), LayerVertex):
                    dlc = vertices[k].layer_conf()
                    if getattr(unfrozen(dlc), "n_in", None):
                        vertices[k] = LayerVertex(layer=_replace_unwrapped(
                            dlc, n_in=n_out).to_dict())
                        reinit.add(k)

        for name, v, ins in self._added:
            if isinstance(v, Layer):
                v = LayerVertex(layer=merge_layer_conf(v, g).to_dict())
            vertices[name] = v
            vertex_inputs[name] = ins
            reinit.add(name)

        # dangling edges, checked after every edit, so the order of the
        # removals does not matter
        known = set(vertices) | set(conf.network_inputs)
        for k, ins in vertex_inputs.items():
            for i in ins:
                if i not in known:
                    raise ValueError(
                        f"vertex '{k}' consumes removed/unknown vertex "
                        f"'{i}' — remove or rewire downstream vertices too")

        frozen = self._ancestors(vertices, vertex_inputs, self._frozen_at)
        new_vertices = {}
        for name, v in vertices.items():
            if isinstance(v, LayerVertex):
                lc = v.layer_conf()
                if name in frozen:
                    if not isinstance(lc, FrozenLayerConf):
                        lc = FrozenLayerConf.wrap(lc)
                elif self._fine_tune:
                    lc = self._fine_tune.apply_to_layer(lc)
                v = LayerVertex(layer=lc.to_dict())
            new_vertices[name] = v

        new_conf = ComputationGraphConfiguration(
            network_inputs=conf.network_inputs,
            network_outputs=(self._outputs if self._outputs is not None
                             else outputs),
            vertices=new_vertices, vertex_inputs=vertex_inputs,
            global_conf=g, input_types=conf.input_types,
            backprop_type=conf.backprop_type,
            tbptt_fwd_length=conf.tbptt_fwd_length,
            tbptt_back_length=conf.tbptt_back_length)
        net = ComputationGraph(new_conf, device=src.device).init()
        if src.net_params is not None:
            for name in net.order:
                if name in reinit or name not in src.net_params:
                    continue
                old, fresh = src.net_params[name], net.net_params[name]
                if all(k in old and old[k].shape == t.shape
                       for k, t in fresh.items()):
                    net.net_params[name] = {k: old[k].detach().clone()
                                            for k in fresh}
                    state = src.net_state.get(name, {})
                    if _same_shapes(state, net.net_state[name]):
                        net.net_state[name] = _clone(state)
        return net


class TransferLearning:
    """The entry point of the reference's nested builders."""

    Builder = TransferLearningBuilder
    GraphBuilder = TransferLearningGraphBuilder


class TransferLearningHelper:
    """Featurization: run the frozen bottom once over the data, then train
    only the top on its output (ref:
    nn/transferlearning/TransferLearningHelper.java)."""

    def __init__(self, net: MultiLayerNetwork, frozen_until: int):
        self.full = net
        self.frozen_until = frozen_until

    def featurize(self, dataset: DataSet) -> DataSet:
        """The output of layers 0 .. ``frozen_until`` for the dataset's
        features (inference forward), with its labels and masks: tensors
        on the network's device.  Only the frozen layers run (the JAX
        package runs the whole network and keeps that layer's
        activation; the features are the same)."""
        net = self.full
        if net.net_params is None:
            net.init()
        policy = net._policy()
        with torch.inference_mode():
            pc, xc, mc = policy.cast_to_compute(
                (net.net_params, net._as_input(dataset.features),
                 net._as_mask(dataset.features_mask)))
            feat, _, _ = net._forward(pc, net.net_state, xc, mc,
                                      stop=self.frozen_until + 1)
            feat = policy.cast_to_param(feat)
        return DataSet(feat, dataset.labels, dataset.features_mask,
                       dataset.labels_mask)

    def unfrozen_network(self) -> MultiLayerNetwork:
        """A network of the layers above ``frozen_until`` with copies of
        their params and states (the JAX package gives them their
        initial states, which differ only for a batch norm), taking
        :meth:`featurize`'s output."""
        conf = copy.deepcopy(self.full.conf)
        top = self.frozen_until + 1
        new_conf = MultiLayerConfiguration(
            layers=conf.layers[top:], global_conf=conf.global_conf,
            input_type=None,
            preprocessors={i - top: p for i, p in conf.preprocessors.items()
                           if i >= top})
        net = MultiLayerNetwork(new_conf, device=self.full.device).init()
        net.net_params = _clone(self.full.net_params[top:])
        net.net_state = _clone(self.full.net_state[top:])
        return net
