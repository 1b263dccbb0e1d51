"""ComputationGraph — the port of ``deeplearning4j_tpu/nn/graph.py``:
networks over a DAG of vertices, with several inputs and outputs.

(ref: nn/graph/ComputationGraph.java: topologicalOrder :122, init :312,
fit(MultiDataSetIterator) :828, feedForward :1212.)  The vertices run
eagerly, one after another in the configuration's topological order, on
the graph's device (CUDA unless the caller asks for the CPU); a training
step sums the output layers' losses (the mean over the batch for
``mini_batch``, else the sum, plus l1/l2) and takes its gradient by
autograd, then updates each vertex's params with its layer's learning
rule (gradient normalization, LR schedule).

Params, layer state (batch norm's running statistics) and updater state
are dicts keyed by vertex name, the JAX package's layout; ``params()``
and ``updater_state_flat()`` flatten them in topological order (the
zip's ``coefficients.bin`` and ``updaterState.bin``, byte for byte the
JAX package's).  A step's dropout randomness is an explicit ``[n_vertices,
2]`` array of uint32 seed words, one row per vertex in topological order
(vertices without params included, as JAX folds the step's key with the
vertex's index), drawn from the graph's own generator unless the caller
passes it.  ``fit`` wraps an iterator in ``AsyncMultiDataSetIterator`` as
``MultiLayerNetwork.fit`` wraps its own, staging each batch onto the
device as the step takes it.  Updater state is made at the first
training step or restore, so a graph that only serves holds none.

The configuration's ``precision`` (``ops/dtypes.py``) is applied where the
JAX package applies it (:245-266, :819-841, :967-983, :1096-1099), as in
``MultiLayerNetwork``: params and inputs cast to the compute dtype inside
the differentiated step, the loss heads' pre-activations to the
accumulation dtype, new states and outputs back to the param dtype; the
vertices keep the dtype they are given.

Listeners, crash-safe resume and the engine methods (``feed_forward``,
``clone``, ``summary``, ``param_table`` / ``get_param`` / ``set_param``)
are ``MultiLayerNetwork``'s.  A vertex whose layer is a
``FrozenLayerConf`` (transfer learning) runs its inference forward, and
the step asks autograd for no gradient of its params and updates none,
so a frozen stack records no backward at all.

``fit(fused_steps=K)``, ``pretrain`` / ``pretrain_layer`` (a layer vertex
on the activations of its upstream subgraph) and ``backprop_gradient`` /
``apply_gradients`` are ``MultiLayerNetwork``'s over the vertex dicts.  A
``CenterLossOutputLayer`` output vertex raises, as in the JAX package.

Under ``backprop_type("truncatedbptt")`` ``fit`` of [N, T, C] inputs takes
one step per segment of ``tbptt_fwd_length`` steps, every recurrent
vertex carrying its ``rnn_state`` (detached) from segment to segment and
none from batch to batch (JAX :755-806); ``rnn_time_step`` carries the
vertices' states from call to call and ``rnn_carry_template`` makes zero
carries from shapes found on ``meta`` tensors.  ``quantize_inference``,
gradient checkpointing (per vertex) and shape bucketing (``fit``, its
pipeline's ETL, ``output``, ``score``, ``score_examples``) are
``MultiLayerNetwork``'s.

Not ported yet: sharding and distributed training.
"""

from __future__ import annotations

import copy
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    AsyncDataSetIterator, AsyncMultiDataSetIterator)
from deeplearning4j_tpu_torch.nn import checkpoint as ckpt_mod
from deeplearning4j_tpu_torch.nn import params as param_util
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration, DuplicateToTimeSeriesVertex,
    LastTimeStepVertex, LayerVertex)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BaseOutputLayer, EmbeddingLayer, FrozenLayerConf,
    GravesBidirectionalLSTM, GravesLSTM, LossLayer, RnnOutputLayer, unfrozen)
from deeplearning4j_tpu_torch.nn.evaluation import Evaluation
from deeplearning4j_tpu_torch.nn.listeners import IterationListener
from deeplearning4j_tpu_torch.nn.multilayer import (
    BIAS_KEYS, WEIGHT_KEYS, _clone, _detach, _tree_fill, _tree_leaves,
    _updater_for, _zeros_tree, as_iterator, checkpointed, fit_epochs,
    fit_group, fused_group_size, grad_like, grads_or_zeros,
    pretrain_gradients, reg_gradients, render_table, run_checkpointed,
    serving_params, set_quantized, to_meta)
from deeplearning4j_tpu_torch.ops import bucketing
from deeplearning4j_tpu_torch.ops import dtypes as dtype_ops
from deeplearning4j_tpu_torch.ops import updaters as upd_ops
from deeplearning4j_tpu_torch.ops.platform import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.parallel import sequence as seq_ops


def _strip_rnn(state: Dict[str, dict]) -> Dict[str, dict]:
    return {n: {k: v for k, v in s.items() if k != "rnn_state"}
            for n, s in state.items()}


class ComputationGraph:
    def __init__(self, conf: ComputationGraphConfiguration,
                 device: DeviceLike = None):
        self.conf = conf
        self.order = conf.topological_order()
        self.device = resolve_device(device)
        self.net_params: Optional[Dict[str, dict]] = None
        self.net_state: Dict[str, dict] = {n: {} for n in self.order}
        self.opt_states: Optional[Dict[str, object]] = None
        self._resolved = dtype_ops.Resolved()
        vertices = conf.vertices
        self.updaters = {
            n: (_updater_for(vertices[n].layer_conf())
                if isinstance(vertices[n], LayerVertex)
                else upd_ops.make("sgd")) for n in self.order}
        self.frozen = {n: isinstance(vertices[n], LayerVertex)
                       and isinstance(vertices[n].layer_conf(),
                                      FrozenLayerConf) for n in self.order}
        self.iteration = 0
        self.epoch = 0
        self.listeners: List[IterationListener] = []
        self.last_batch_size = 0
        self.last_etl_time_ms = 0.0
        self._score = float("nan")
        self._generator = torch.Generator().manual_seed(
            int(conf.global_conf.seed))
        self._noise_gen: Optional[torch.Generator] = None
        self._fused_before = False
        self.compile_telemetry = bucketing.CompileTelemetry()
        self._bucket_train_ok: Optional[bool] = None
        self._infer_quant: Optional[str] = None
        self._q_params = self._q_stats = None
        self._q_iteration = -1
        # the loss heads, by name, in the order of conf.network_outputs
        self.output_layers = {}
        for n in conf.network_outputs:
            v = vertices[n]
            if isinstance(v, LayerVertex) and isinstance(
                    v.layer_conf(), (BaseOutputLayer, LossLayer)):
                self.output_layers[n] = v.layer_conf()
        # how many vertices read each activation: the forward drops an
        # activation once its last reader has run
        self._readers: Dict[str, int] = {}
        for n in self.order:
            for i in self._reads(n):
                self._readers[i] = self._readers.get(i, 0) + 1
        self._embedding_inputs = {
            i for n in self.order for i in conf.vertex_inputs[n]
            if i in conf.network_inputs
            and isinstance(vertices[n], LayerVertex)
            and isinstance(unfrozen(vertices[n].layer_conf()),
                           EmbeddingLayer)}

    def _reads(self, name: str) -> List[str]:
        """The activations vertex ``name`` takes: its inputs, and for a
        DuplicateToTimeSeriesVertex of one input its reference sequence."""
        v = self.conf.vertices[name]
        ins = list(self.conf.vertex_inputs[name])
        if isinstance(v, DuplicateToTimeSeriesVertex) and v.ts_input \
                and len(ins) == 1:
            ins.append(v.ts_input)
        return ins

    # ------------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None
             ) -> "ComputationGraph":
        """Draw every vertex's params and set its initial state, in
        topological order.  Without a generator the draws come from a CPU
        generator seeded with the configuration's seed."""
        conf = self.conf
        if generator is None:
            generator = torch.Generator().manual_seed(
                int(conf.global_conf.seed))
        types: Dict[str, InputType] = {}
        if conf.input_types:
            types.update(zip(conf.network_inputs, conf.input_types))
        params, states = {}, {}
        for name in self.order:
            v = conf.vertices[name]
            in_types = [types.get(i) for i in conf.vertex_inputs[name]]
            if any(t is None for t in in_types):
                in_types = [self._declared_input_type(name)]
            states[name] = v.initial_state(in_types, self.device)
            params[name], types[name] = v.initialize(generator, in_types,
                                                     self.device)
        self.net_params, self.net_state = params, states
        return self

    def _declared_input_type(self, name: str) -> InputType:
        """A vertex's input type from its layer's ``n_in`` when the graph
        declares no input types (the JAX package's best effort)."""
        v = self.conf.vertices[name]
        layer = unfrozen(v.layer_conf()) if isinstance(v, LayerVertex) \
            else None
        n_in = getattr(layer, "n_in", None)
        if not n_in:
            raise ValueError(
                f"Vertex '{name}': upstream type unknown — call "
                f"set_input_types() on the GraphBuilder or set n_in")
        if isinstance(layer, (GravesLSTM, GravesBidirectionalLSTM,
                              RnnOutputLayer)):
            return InputType.recurrent(n_in)
        return InputType.feed_forward(n_in)

    def load_jax_params(self, jax_params) -> "ComputationGraph":
        """Take the params of a JAX ``ComputationGraph`` (its
        ``net_params``, a dict by vertex of numpy arrays) — same layouts."""
        from deeplearning4j_tpu_torch.nn.convert import params_from_jax
        self.net_params = params_from_jax(dict(jax_params), self.device)
        return self

    def load_jax_state(self, jax_state) -> "ComputationGraph":
        """Take the vertex states of a JAX ``ComputationGraph`` (its
        ``net_state``): batch norm's running statistics."""
        from deeplearning4j_tpu_torch.nn.convert import state_from_jax
        self.net_state = state_from_jax(dict(jax_state), self.device)
        return self

    # ------------------------------------------------------------------
    def _as_float(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32).to(self.device)

    def _as_input(self, name: str, x) -> torch.Tensor:
        """Features as float32 on the graph's device; integer indices stay
        integers when an EmbeddingLayer reads this input."""
        if name in self._embedding_inputs:
            t = torch.as_tensor(x)
            if not torch.is_floating_point(t):
                return t.to(device=self.device, dtype=torch.int64)
        return self._as_float(x)

    def _inputs(self, features: Sequence) -> Dict[str, torch.Tensor]:
        return {n: self._as_input(n, x)
                for n, x in zip(self.conf.network_inputs, features)}

    def _masks(self, masks) -> Optional[List[Optional[torch.Tensor]]]:
        if masks is None:
            return None
        return [None if m is None else self._as_float(m) for m in masks]

    def _forward_all(self, params, state, inputs: Dict[str, torch.Tensor],
                     masks: Dict[str, Optional[torch.Tensor]], train: bool,
                     seeds=None, preout_for: Sequence[str] = (),
                     keep_all: bool = False, only=None):
        """Every vertex in topological order -> (activations of the
        network outputs, pre-activations of the vertices in
        ``preout_for``, new states, output masks).  A vertex in
        ``preout_for`` (an output layer) records its PRE-activation (the
        stable fused losses work on it) and, in training, drops its
        input; in training vertex ``vi`` gets the seed words
        ``seeds[vi]``.  An activation is dropped once its last reader has
        run, so a training step holds only what autograd saves; under
        ``keep_all`` every activation is kept and returned, the inputs'
        included.  ``only`` (a set of names) runs those vertices alone."""
        acts = dict(inputs)
        out_masks = dict(masks)
        new_states: Dict[str, dict] = {}
        preouts: Dict[str, torch.Tensor] = {}
        remaining = dict(self._readers)
        keep = set(self.conf.network_outputs)
        if keep_all:
            keep |= set(acts) | set(self.order)
        remat = checkpointed(self, train)
        for vi, name in enumerate(self.order):
            if only is not None and name not in only:
                continue
            v = self.conf.vertices[name]
            reads = self._reads(name)
            ins = [acts[i] for i in reads]
            ms = [out_masks.get(i) for i in reads]
            # named-input semantics (ref: rnn/LastTimeStepVertex.java takes
            # its mask from a NAMED network input)
            if isinstance(v, LastTimeStepVertex) and v.mask_input:
                ms = [out_masks.get(v.mask_input)]
            seed = None if seeds is None else seeds[vi]
            if name in preout_for:
                lc = v.layer_conf()
                x = ins[0]
                if train:
                    x = lc._maybe_dropout(x, True, seed)
                pre = lc.preoutput(
                    lc._maybe_drop_connect(params[name], train, seed), x)
                preouts[name] = pre
                new_states[name] = state[name]
                if self._readers.get(name):
                    acts[name] = lc._act(pre)
                out_masks[name] = ms[0] if ms else None
            else:
                if remat:
                    y, ns, m = run_checkpointed(
                        lambda p, s_, ins_, ms_, v=v, seed=seed:
                        v.forward(p, s_, ins_, True, seed, ms_),
                        params[name], state[name], ins, ms)
                else:
                    y, ns, m = v.forward(params[name], state[name], ins,
                                         train, seed, ms)
                acts[name] = y
                new_states[name] = ns
                out_masks[name] = m
            for i in reads:
                remaining[i] -= 1
                if remaining[i] == 0 and i not in keep:
                    acts.pop(i, None)
        if keep_all:
            return acts, preouts, new_states, out_masks
        return ({n: acts[n] for n in self.conf.network_outputs if n in acts},
                preouts, new_states, out_masks)

    def _reg_penalty(self, params):
        """l1/l2 on the layer vertices' weights and biases (zero unless
        the configuration enables regularization)."""
        total = 0.0
        for name in self.order:
            v = self.conf.vertices[name]
            if not isinstance(v, LayerVertex):
                continue
            layer = v.layer_conf()
            l1, l2 = layer.l1 or 0.0, layer.l2 or 0.0
            l1b, l2b = layer.l1_bias or 0.0, layer.l2_bias or 0.0
            for k, val in params[name].items():
                a, b = ((l1, l2) if k in WEIGHT_KEYS
                        else (l1b, l2b) if k in BIAS_KEYS else (0.0, 0.0))
                if a:
                    total = total + a * torch.sum(torch.abs(val))
                if b:
                    total = total + 0.5 * b * torch.sum(val * val)
        return total

    @staticmethod
    def _resolve_label_mask(preout, lm, out_mask):
        """The label mask of one output: the given one, else the output's
        own mask when it is a per-step mask; an expanded [N, T, 1] time
        mask is squeezed (the JAX package's rule)."""
        if lm is None:
            lm = out_mask if (out_mask is not None
                              and out_mask.ndim == preout.ndim - 1) else None
        if lm is not None and preout.ndim == 3 and lm.ndim == 3 \
                and lm.shape[-1] == 1:
            lm = lm[..., 0]
        return lm

    def _per_example_scores(self, preouts, out_masks, ys, lmasks):
        """Per output layer, its loss of each example."""
        out = {}
        for oi, name in enumerate(self.conf.network_outputs):
            lc = self.output_layers.get(name)
            if lc is None:
                continue
            pre = preouts[name]
            lm = self._resolve_label_mask(
                pre, lmasks[oi] if lmasks is not None else None,
                out_masks.get(name))
            out[name] = lc.compute_score(ys[oi], pre, lm)
        return out

    def _score_of(self, params, preouts, out_masks, ys, lmasks):
        """The summed output losses (each the mean over the batch for
        ``mini_batch``, else the sum) plus l1/l2."""
        mean = self.conf.global_conf.mini_batch
        score = 0.0
        for per_ex in self._per_example_scores(preouts, out_masks, ys,
                                               lmasks).values():
            score = score + (per_ex.mean() if mean else per_ex.sum())
        return score + self._reg_penalty(params)

    # ------------------------------------------------------------------
    def _policy(self) -> dtype_ops.Policy:
        return self._resolved(self.conf.global_conf.precision)

    def output(self, *inputs):
        """The network outputs for a batch (one array or tensor per
        network input), as a tuple of tensors on the graph's device, one
        per network output; no stored RNN state is used.  Under a mixed
        policy they come back in the param dtype (float32)."""
        if self.net_params is None:
            self.init()
        policy = self._policy()
        g = self.conf.global_conf
        masks, unpad, bucket = {}, None, None
        if g.shape_bucketing:
            padded, pairs = [], []
            for x in inputs:
                xp, mp, n, t, b = bucketing.bucket_inference_features(
                    x, None, g)
                padded.append((xp, mp))
                pairs.append((t, b[1]))
            inputs = [xp for xp, _ in padded]
            masks = {name: self._as_float(mp) for name, (_, mp) in
                     zip(self.conf.network_inputs, padded) if mp is not None}
            bucket = (b[0], tuple(tb for _, tb in pairs))
            unpad = (n, pairs)
        with torch.inference_mode():
            xs, masks = policy.cast_to_compute((self._inputs(inputs), masks))
            self.compile_telemetry.record("output", (xs, masks),
                                          bucket=bucket)
            outs, _, _, _ = self._forward_all(
                serving_params(self, self.net_params, policy),
                _strip_rnn(self.net_state), xs, masks, False)
        outs = tuple(policy.cast_to_param(outs[n])
                     for n in self.conf.network_outputs)
        if unpad is not None:
            outs = tuple(_unpad_graph_output(o, *unpad) for o in outs)
        return outs

    def quantize_inference(self, mode: str = "int8") -> "ComputationGraph":
        """Weight-only quantized serving over the vertex params, as
        ``MultiLayerNetwork.quantize_inference`` (JAX :914-958)."""
        set_quantized(self, mode)
        return self

    def warmup_inference(self, feature_dims, max_batch: int = 32,
                         batch_sizes=None) -> dict:
        """Run ``output`` once for every batch bucket of the serving
        ladder (``ops/bucketing.warmup_ladder``), so first requests do
        not pay for the kernel build, the libraries' first calls or the
        allocator's first allocations.  ``feature_dims`` is one
        per-example shape per network input (a single shape is used for
        all of them)."""
        if self.net_params is None:
            self.init()
        dims = list(feature_dims)
        if not dims or not isinstance(dims[0], (tuple, list)):
            dims = [tuple(dims)] * len(self.conf.network_inputs)
        dims = [tuple(int(d) for d in t) for t in dims]
        ladder = bucketing.warmup_ladder(
            batch_sizes or self.conf.global_conf.bucket_batch_sizes,
            max_batch)
        t0 = time.perf_counter()
        for nb in ladder:
            self.output(*[torch.zeros((nb,) + t, device=self.device)
                          for t in dims])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {"buckets": ladder,
                "warmup_sec": round(time.perf_counter() - t0, 3)}

    # ---- training ----
    def set_listeners(self, *listeners: IterationListener
                      ) -> "ComputationGraph":
        self.listeners = list(listeners)
        return self

    def add_listener(self, listener: IterationListener
                     ) -> "ComputationGraph":
        self.listeners.append(listener)
        return self

    def fit(self, data, labels=None, epochs: int = 1, fused_steps: int = 1
            ) -> "ComputationGraph":
        """fit(MultiDataSet | DataSet | iterator | (features, labels))
        (ref: ComputationGraph.fit :828): ``epochs`` passes, one training
        step per batch.  An iterator (of DataSets or MultiDataSets) that is
        not already asynchronous is wrapped in an
        ``AsyncMultiDataSetIterator`` with ``pipeline_workers`` workers,
        ``pipeline_prefetch`` raw batches queued and at most
        ``pipeline_staging_depth`` transformed batches waiting, unless
        ``pipeline_workers`` is 0; each batch is staged onto the graph's
        device as the step takes it, and the pipeline is closed on
        return.  Listeners, ``fault_tolerance(resume=True)`` and
        ``fused_steps`` (over an iterator) as in ``MultiLayerNetwork.fit``
        (JAX :343-366)."""
        if labels is not None:
            data = MultiDataSet([np.asarray(data)], [np.asarray(labels)])
        if isinstance(data, DataSet):
            data = MultiDataSet.of(data)
        if self.net_params is None:
            self.init()
        skip = ckpt_mod.maybe_auto_resume(self)
        if isinstance(data, MultiDataSet):
            fit_epochs(self, epochs, skip, lambda: None, lambda: [data],
                       self._fit_batch)
            return self
        it = data
        g = self.conf.global_conf
        if (g.pipeline_workers > 0
                and not isinstance(it, AsyncDataSetIterator)
                and getattr(it, "async_supported", lambda: True)()):
            transform = _as_multi
            if self._bucket_train_enabled():
                # bucket on the pipeline's thread, before staging (JAX
                # :431-446)
                def transform(item):
                    return bucketing.bucket_train_multidataset(
                        _as_multi(item), g)[0]
            it = AsyncMultiDataSetIterator(
                it, queue_size=g.pipeline_prefetch,
                workers=g.pipeline_workers,
                staging_depth=g.pipeline_staging_depth, device=self.device,
                transform=transform)
        # the MultiDataSetIterator protocol where there is one; a plain
        # iterable works too
        has_protocol = (callable(getattr(it, "has_next", None))
                        and callable(getattr(it, "next", None)))

        def batches():
            if has_protocol:
                while it.has_next():
                    yield it.next()
            else:
                yield from it
        reset = getattr(it, "reset", None)
        fit_batch = self._fit_batch
        try:
            fit_epochs(self, epochs, skip,
                       reset if callable(reset) else lambda: None, batches,
                       lambda item: fit_batch(_as_multi(item)),
                       fused_group_size(self.conf, fused_steps),
                       lambda group: self._fit_group(
                           [_as_multi(m) for m in group]))
        finally:
            if isinstance(it, AsyncDataSetIterator):
                it.close()
        return self

    def _draw_seeds(self) -> torch.Tensor:
        """One step's dropout seed words, [n_vertices, 2] uint32 values
        (as int64), from the graph's generator: one draw a step."""
        return torch.randint(0, 1 << 32, (len(self.order), 2),
                             generator=self._generator, dtype=torch.int64)

    def _bucket_train_enabled(self) -> bool:
        """As ``MultiLayerNetwork._bucket_train_enabled`` (JAX :668-674)."""
        g = self.conf.global_conf
        if not g.shape_bucketing or \
                self.conf.backprop_type == "truncatedbptt":
            return False
        if self._bucket_train_ok is None:
            self._bucket_train_ok = bucketing.pad_supported(self)
        return self._bucket_train_ok

    def _maybe_bucket_train(self, mds, scale_loss: bool = True):
        if self._bucket_train_enabled():
            return bucketing.bucket_train_multidataset(
                mds, self.conf.global_conf, scale_loss=scale_loss)
        return mds, None

    def _fit_group(self, group: List[MultiDataSet]) -> None:
        def masks(ms):
            return None if ms is None else tuple(m is None for m in ms)
        rows = [m.num_examples() for m in group]
        group = [self._maybe_bucket_train(m)[0] for m in group]
        fit_group(self, group, lambda m: (
            tuple(tuple(f.shape) for f in m.features),
            tuple(tuple(y.shape) for y in m.labels),
            masks(m.features_masks), masks(m.labels_masks)), rows)

    def _fit_batch(self, mds, seeds=None, notify: bool = True) -> None:
        """One training step on ``mds`` (a MultiDataSet or DataSet), or
        under truncated BPTT one a segment; ``seeds`` gives its dropout
        seed words ([n_vertices, 2]), else they are drawn from the graph's
        generator (on the host: no device synchronisation).  ``notify``
        False leaves the listeners to the caller."""
        mds = _as_multi(mds)
        if not self.output_layers:
            raise ValueError("ComputationGraph.fit() needs >=1 output layer "
                             "vertex (OutputLayer/LossLayer)")
        if self.net_params is None:
            self.init()
        if self.opt_states is None:
            self.opt_states = self._init_opt_states()
        self.last_batch_size = mds.num_examples()
        if self.conf.backprop_type == "truncatedbptt" and \
                any(np.ndim(f) == 3 for f in mds.features):
            self._fit_tbptt(mds)
            return
        mds, bucket = self._maybe_bucket_train(mds)
        step_seeds = (self._draw_seeds() if seeds is None else
                      np.asarray(seeds, dtype=np.int64).reshape(
                          len(self.order), 2)).tolist()
        self.compile_telemetry.record(
            "train_step", (mds.features, mds.labels, mds.features_masks,
                           mds.labels_masks), bucket=bucket)
        score, grads = self._grad_step(
            self._inputs(mds.features),
            [self._as_float(y) for y in mds.labels],
            self._masks(mds.features_masks), self._masks(mds.labels_masks),
            step_seeds)
        self._apply_updates(grads, self.iteration)
        self.rnn_clear_previous_state()
        self._score = score
        self.iteration += 1
        if notify:
            for lst in self.listeners:
                lst.iteration_done(self, self.iteration)

    def _fit_tbptt(self, mds: MultiDataSet) -> None:
        """Truncated BPTT (ref: ComputationGraph.doTruncatedBPTT :1476;
        JAX :755-806): the carries are cleared, then one step and one
        update per segment of ``tbptt_fwd_length`` steps of the [N, T, C]
        inputs, every recurrent vertex starting from the state it ended
        the previous segment in (detached).  3-D labels are sliced with
        the features, and so is any mask whose time axis is the full
        length (2-D masks included)."""
        T = max(f.shape[1] for f in mds.features if np.ndim(f) == 3)
        seg_len = self.conf.tbptt_fwd_length
        self.rnn_clear_previous_state()
        xs = self._inputs(mds.features)
        ys = [self._as_float(y) for y in mds.labels]
        fms, lms = (self._masks(mds.features_masks),
                    self._masks(mds.labels_masks))

        def seg(a, sl):
            return a[:, sl] if a is not None and a.ndim == 3 else a

        def seg_mask(m, sl):
            if m is None or m.ndim < 2 or m.shape[1] != T:
                return m
            return m[:, sl]
        for t0 in range(0, T, seg_len):
            sl = slice(t0, min(t0 + seg_len, T))
            score, grads = self._grad_step(
                {n: seg(x, sl) for n, x in xs.items()},
                [seg(y, sl) for y in ys],
                None if fms is None else [seg_mask(m, sl) for m in fms],
                None if lms is None else [seg_mask(m, sl) for m in lms],
                self._draw_seeds().tolist())
            self._apply_updates(grads, self.iteration)
            self._score = score
            self.iteration += 1
            for lst in self.listeners:
                lst.iteration_done(self, self.iteration)

    def _grad_step(self, xs: Dict[str, torch.Tensor], ys, fmasks, lmasks,
                   seeds):
        """Score of the batch and its gradient per vertex and param (none
        for a frozen vertex, whose forward then records no backward); the
        vertices' new states (detached) replace ``net_state``, as the JAX
        step returns them.  A carried ``rnn_state`` (truncated BPTT)
        enters in the compute dtype, as in ``MultiLayerNetwork``."""
        policy = self._policy()
        params = {n: {k: v.detach().requires_grad_(not self.frozen[n])
                      for k, v in lp.items()}
                  for n, lp in self.net_params.items()}
        masks = (dict(zip(self.conf.network_inputs, fmasks))
                 if fmasks is not None else {})
        xs, masks = policy.cast_to_compute((xs, masks))
        state = {n: {k: policy.cast_to_compute(v) if k == "rnn_state"
                     else v for k, v in s.items()}
                 for n, s in self.net_state.items()}
        with torch.enable_grad():
            # the cast inside the differentiated function: f32 gradients
            # of the f32 masters
            _, preouts, new_states, out_masks = self._forward_all(
                policy.cast_to_compute(params), state, xs, masks,
                True, seeds, preout_for=list(self.output_layers))
            preouts = {n: policy.cast_to_accum(v)
                       for n, v in preouts.items()}
            new_states = policy.cast_to_param(new_states)
            score = self._score_of(params, preouts, out_masks, ys, lmasks)
            if not self.conf.global_conf.minimize:
                score = -score
            flat = iter(grads_or_zeros(
                score, [v for lp in params.values() for v in lp.values()
                        if v.requires_grad]))
        grads = {n: {k: next(flat) for k, v in lp.items() if v.requires_grad}
                 for n, lp in params.items()}
        self.net_state = _detach(new_states)
        return score.detach(), grads

    def _init_opt_states(self) -> Dict[str, object]:
        return {n: self.updaters[n].init(self.net_params[n])
                for n in self.order}

    @torch.no_grad()
    def _apply_updates(self, grads, it: int) -> None:
        """Per vertex with a gradient and not frozen: gradient
        normalization and the LR (its layer's, else the global one) under
        the LR schedule, the learning rule, then params -= update, in
        place."""
        g = self.conf.global_conf
        for name in self.order:
            gi = grads.get(name)
            if not gi or self.frozen[name]:
                continue
            v = self.conf.vertices[name]
            layer = v.layer_conf() if isinstance(v, LayerVertex) else None
            base = g.learning_rate
            if layer is not None:
                gi = upd_ops.normalize_gradient(
                    gi, layer.gradient_normalization,
                    layer.gradient_normalization_threshold or 1.0)
                if layer.learning_rate is not None:
                    base = layer.learning_rate
            lr = upd_ops.schedule_lr(
                base, g.lr_policy, it, decay_rate=g.lr_policy_decay_rate,
                steps=g.lr_policy_steps, power=g.lr_policy_power,
                schedule_map=g.learning_rate_schedule)
            upd, self.opt_states[name] = self.updaters[name].apply(
                gi, self.opt_states[name], lr, it)
            for k, u in upd.items():
                self.net_params[name][k].sub_(u)

    # ---- layerwise pretraining ----
    def pretrain(self, data, epochs: int = 1) -> "ComputationGraph":
        """Pretrain every layer vertex whose layer ``is_pretrain_layer()``,
        in topological order (ref: ComputationGraph.pretrain :549-561)."""
        for name in self.order:
            v = self.conf.vertices[name]
            if isinstance(v, LayerVertex) and \
                    v.layer_conf().is_pretrain_layer():
                self.pretrain_layer(name, data, epochs=epochs)
        return self

    def pretrain_layer(self, name: str, data, epochs: int = 1
                       ) -> "ComputationGraph":
        """Unsupervised fit of layer vertex ``name`` on the activation of
        its (first) input, from its upstream subgraph in inference mode
        (ref: ComputationGraph.pretrainLayer; JAX :1306-1373): one step a
        batch (an array, a DataSet, a MultiDataSet or an iterator of them;
        only the features are read), as ``MultiLayerNetwork``'s."""
        if not self.conf.vertices[name].layer_conf().is_pretrain_layer():
            return self
        if self.net_params is None:
            self.init()
        it = as_iterator(data)
        for _ in range(epochs):
            it.reset()
            while it.has_next():
                self._pretrain_step(name, _as_multi(it.next()).features)
        return self

    def _upstream(self, name: str) -> set:
        """The vertices ``name`` depends on (itself excluded)."""
        seen, todo = set(), list(self._reads(name))
        while todo:
            n = todo.pop()
            if n in seen or n in self.conf.network_inputs:
                continue
            seen.add(n)
            todo.extend(self._reads(n))
        return seen

    def _pretrain_step(self, name: str, features, noise=None) -> None:
        """One pretrain step of vertex ``name``: features from its upstream
        subgraph (no autograd), its layer's ``pretrain_loss`` on ``noise``
        (else drawn from the graph's device generator) plus its l1/l2,
        negated unless minimizing, then the vertex's update."""
        if self.opt_states is None:
            self.opt_states = self._init_opt_states()
        with torch.no_grad():
            acts, _, _, _ = self._forward_all(
                self.net_params, _strip_rnn(self.net_state),
                self._inputs(features), {}, False, keep_all=True,
                only=self._upstream(name))
        self._score, grads = pretrain_gradients(
            self, self.conf.vertices[name].layer_conf(),
            self.net_params[name], acts[self.conf.vertex_inputs[name][0]],
            noise)
        self._apply_updates({name: grads}, self.iteration)
        self.iteration += 1
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration)

    # ---- external gradients ----
    def backprop_gradient(self, inputs, epsilons, masks=None,
                          train: bool = False):
        """Vertex param gradients and dL/d(input) for external errors
        ``epsilons`` = dL/d(output i), ordered as ``network_outputs``;
        ``inputs`` as ``network_inputs`` (JAX :1375-1425) -> (grads like
        ``net_params``, a tuple of input gradients, None for integer
        inputs).  The forward is ``output()``'s under the precision
        policy; ``train`` as in ``MultiLayerNetwork.backprop_gradient``."""
        if self.net_params is None:
            self.init()
        policy = self._policy()
        params = {n: {k: v.detach().requires_grad_() for k, v in lp.items()}
                  for n, lp in self.net_params.items()}
        xs = self._inputs(inputs)
        xs = {n: (x.detach().requires_grad_() if torch.is_floating_point(x)
                  else x) for n, x in xs.items()}
        md = (dict(zip(self.conf.network_inputs, self._masks(masks)))
              if masks is not None else {})
        seeds = self._draw_seeds().tolist() if train else None
        with torch.enable_grad():
            pc, xc, mc = policy.cast_to_compute((params, xs, md))
            outs, _, new_states, _ = self._forward_all(
                pc, _strip_rnn(self.net_state), xc, mc, train, seeds)
            outs = [outs[n] for n in self.conf.network_outputs]
            eps = [torch.as_tensor(e).to(device=o.device, dtype=o.dtype)
                   for e, o in zip(epsilons, outs)]
            leaves = [v for lp in params.values() for v in lp.values()]
            x_leaves = [x for x in xs.values() if x.requires_grad]
            flat = iter(grads_or_zeros(outs, leaves + x_leaves, eps))
        grads = {n: {k: next(flat) for k in lp} for n, lp in params.items()}
        dxs = tuple(next(flat) if xs[n].requires_grad else None
                    for n in self.conf.network_inputs)
        if train:
            self.net_state = _strip_rnn(_detach(
                policy.cast_to_param(new_states)))
        return grads, dxs

    def apply_gradients(self, grads) -> "ComputationGraph":
        """External vertex gradients through the updaters (JAX
        :1427-1454): l1/l2 gradient added, negated under
        ``minimize=False``, then each vertex's normalization, LR schedule
        and learning rule, frozen vertices skipped; ``iteration``
        advances."""
        if self.net_params is None:
            self.init()
        if self.opt_states is None:
            self.opt_states = self._init_opt_states()
        reg = reg_gradients(self._reg_penalty, self.net_params)
        sign = 1.0 if self.conf.global_conf.minimize else -1.0
        total = {n: {k: sign * (grad_like(grads[n][k], r) + r)
                     for k, r in rl.items() if k in grads.get(n, {})}
                 for n, rl in reg.items()}
        self._apply_updates(total, self.iteration)
        self.iteration += 1
        return self

    # ---- scores and evaluation ----
    def _inference_preouts(self, mds: MultiDataSet):
        policy = self._policy()
        with torch.inference_mode():
            fm = self._masks(mds.features_masks)
            masks = (dict(zip(self.conf.network_inputs, fm))
                     if fm is not None else {})
            pc, xs, masks = policy.cast_to_compute(
                (self.net_params, self._inputs(mds.features), masks))
            _, preouts, _, out_masks = self._forward_all(
                pc, _strip_rnn(self.net_state), xs, masks, False,
                preout_for=list(self.output_layers))
        return ({n: policy.cast_to_accum(v) for n, v in preouts.items()},
                out_masks)

    def score(self, data=None) -> float:
        """The loss of a DataSet or MultiDataSet (inference forward, l1/l2
        included), or the score of the last training step."""
        if data is None:
            return float(self._score)
        mds, bucket = self._maybe_bucket_train(_as_multi(data))
        self.compile_telemetry.record(
            "score", (mds.features, mds.labels, mds.features_masks,
                      mds.labels_masks), bucket=bucket)
        preouts, out_masks = self._inference_preouts(mds)
        with torch.inference_mode():
            return float(self._score_of(
                self.net_params, preouts, out_masks,
                [self._as_float(y) for y in mds.labels],
                self._masks(mds.labels_masks)))

    def score_examples(self, data, add_regularization_terms: bool = False
                       ) -> np.ndarray:
        """Per-example scores without minibatch averaging, summed over the
        output layers (ref: ComputationGraph.scoreExamples);
        ``add_regularization_terms`` adds the l1/l2 penalty to every
        example's score.  Takes a DataSet, a MultiDataSet or an iterator
        of them; returns a 1-D array over all examples.  Under
        ``shape_bucketing`` a batch is padded with unscaled masks and the
        padded rows' scores dropped."""
        if self.net_params is None:
            self.init()
        batches = ([data] if isinstance(data, (DataSet, MultiDataSet))
                   else data)
        g = self.conf.global_conf
        bucket_ok = (g.shape_bucketing and
                     bucketing.pad_supported(self, require_mean=False))
        out = []
        for item in batches:
            mds = _as_multi(item)
            n, bucket = mds.num_examples(), None
            if bucket_ok:
                mds, bucket = bucketing.bucket_train_multidataset(
                    mds, g, scale_loss=False)
            self.compile_telemetry.record(
                "score_examples", (mds.features, mds.labels,
                                   mds.features_masks, mds.labels_masks),
                bucket=bucket)
            preouts, out_masks = self._inference_preouts(mds)
            with torch.inference_mode():
                per = sum(self._per_example_scores(
                    preouts, out_masks,
                    [self._as_float(y) for y in mds.labels],
                    self._masks(mds.labels_masks)).values())
                if add_regularization_terms:
                    per = per + self._reg_penalty(self.net_params)
            out.append(per.cpu().numpy()[:n])
        return np.concatenate(out)

    def evaluate(self, iterator_or_dataset, output_idx: int = 0
                 ) -> Evaluation:
        """Classification evaluation of output ``output_idx`` over every
        batch (a DataSet, a MultiDataSet or an iterator of them)."""
        ev = Evaluation()
        if isinstance(iterator_or_dataset, (DataSet, MultiDataSet)):
            batches = [iterator_or_dataset]
        else:
            iterator_or_dataset.reset()
            batches = iterator_or_dataset
        for item in batches:
            mds = _as_multi(item)
            outs = self.output(*mds.features)
            ev.eval(mds.labels[output_idx], outs[output_idx])
        return ev

    def rnn_clear_previous_state(self) -> None:
        """Drop any stored RNN carry (ref: rnnClearPreviousState :1608)."""
        self.net_state = _strip_rnn(self.net_state)

    def rnn_time_step(self, *inputs):
        """Stateful inference (ref: ComputationGraph.rnnTimeStep :1569; JAX
        :871-905): each input [N, T, C] continues every recurrent vertex
        from the state the previous call left (zeros after
        :meth:`rnn_clear_previous_state`) and the new final states are kept
        for the next call; returns the network outputs.  One call of
        :meth:`_rnn_step_raw`, the carried step the serving decode pool
        runs too."""
        if self.net_params is None:
            self.init()
        xs = self._inputs(inputs)
        self.compile_telemetry.record("rnn_time_step", xs)
        outs, carries = self._rnn_step_raw(
            self.net_params, self.net_state,
            {n: s["rnn_state"] for n, s in self.net_state.items()
             if "rnn_state" in s},
            tuple(xs[n] for n in self.conf.network_inputs))
        self._merge_rnn_state({n: {"rnn_state": c}
                               for n, c in carries.items()})
        return outs

    def _rnn_step_raw(self, params, base_state, carries, xs, masks=None):
        """The carried decode step (JAX :806-843), shared by
        :meth:`rnn_time_step` and ``server/decode.DecodePool``:
        ``(params, base_state, carries, xs, masks) -> (outs, new_carries)``
        with ``carries`` a dict keyed by the recurrent vertices' names (a
        vertex missing from it starts from zeros), ``xs`` one tensor per
        network input and ``masks`` one time mask (or None) per input.
        The carries and inputs take the compute dtype; the outputs and new
        carries come back in the param dtype.  The forward runs under
        ``kv_decode_scope``."""
        policy = self._policy()
        state = {}
        for n, s in base_state.items():
            s = {k: v for k, v in s.items() if k != "rnn_state"}
            if n in carries:
                s["rnn_state"] = policy.cast_to_compute(carries[n])
            state[n] = s
        with torch.no_grad(), seq_ops.kv_decode_scope():
            pc, xs_c = policy.cast_to_compute((params, tuple(xs)))
            ms = {n: m for n, m in zip(self.conf.network_inputs,
                                       masks or ()) if m is not None}
            acts, _, new_states, _ = self._forward_all(
                pc, state, dict(zip(self.conf.network_inputs, xs_c)), ms,
                False)
        outs = tuple(policy.cast_to_param(acts[n])
                     for n in self.conf.network_outputs)
        return outs, {n: policy.cast_to_param(ns["rnn_state"])
                      for n, ns in new_states.items()
                      if isinstance(ns, dict) and "rnn_state" in ns}

    def _merge_rnn_state(self, new_states) -> None:
        """Keep the vertices' new ``rnn_state`` and nothing else of their
        new states."""
        merged = {}
        for name, old in self.net_state.items():
            s = {k: v for k, v in old.items() if k != "rnn_state"}
            if "rnn_state" in new_states.get(name, {}):
                s["rnn_state"] = new_states[name]["rnn_state"]
            merged[name] = s
        self.net_state = merged

    def rnn_carry_template(self, n: int, feature_tails=None,
                           dtype: torch.dtype = torch.float32) -> dict:
        """Zero carries for ``n`` streams, vertex name -> carry, of the
        structure ``rnn_time_step`` stores (JAX :845-869); the shapes come
        from the step's forward over ``meta`` tensors.  ``feature_tails``
        has one per-example shape per network input (``(T, C)``); by
        default one step of each declared input type."""
        if self.net_params is None:
            self.init()
        if feature_tails is None:
            if not self.conf.input_types:
                raise ValueError("rnn_carry_template needs explicit "
                                 "feature_tails= (no set_input_types())")
            feature_tails = [(1, it.size) if it.kind == "rnn"
                             else (it.size,)
                             for it in self.conf.input_types]
        xs = tuple(torch.empty((int(n),) + tuple(int(d) for d in t),
                               dtype=dtype, device="meta")
                   for t in feature_tails)
        _, carries = self._rnn_step_raw(to_meta(self.net_params),
                                        to_meta(self.net_state), {}, xs)
        return {name: _zeros_tree(c, self.device)
                for name, c in carries.items()}

    # ---- flat views ----
    def params(self) -> torch.Tensor:
        """Flat 1-D param vector: vertices in topological order."""
        return param_util.flatten([self.net_params[n] for n in self.order])

    def set_params(self, flat) -> None:
        new = param_util.unflatten(flat, [self.net_params[n]
                                          for n in self.order])
        self.net_params = dict(zip(self.order, new))

    def num_params(self) -> int:
        return param_util.num_params([self.net_params[n]
                                      for n in self.order])

    n_params = property(num_params)

    def updater_state_flat(self) -> torch.Tensor:
        """The updater state as one flat vector, in the JAX package's
        ``tree_leaves`` order over the vertices in topological order (the
        ``updaterState.bin`` layout)."""
        leaves = _tree_leaves([self.opt_states[n] for n in self.order]
                              if self.opt_states else [])
        if not leaves:
            return torch.zeros((0,), dtype=torch.float32)
        return torch.cat([l.reshape(-1) for l in leaves])

    def set_updater_state_flat(self, flat) -> None:
        if self.opt_states is None:
            self.opt_states = self._init_opt_states()
        flat = torch.as_tensor(flat, dtype=torch.float32).reshape(-1)
        ordered = [self.opt_states[n] for n in self.order]
        leaves = _tree_leaves(ordered)
        n = sum(l.numel() for l in leaves)
        if flat.numel() != n:
            raise ValueError(f"Updater state size mismatch: model {n} vs "
                             f"flat {flat.numel()}")
        parts, off = [], 0
        for l in leaves:
            parts.append(flat[off:off + l.numel()].reshape(l.shape).to(
                device=l.device, dtype=l.dtype).clone())
            off += l.numel()
        self.opt_states = dict(zip(self.order,
                                   _tree_fill(ordered, iter(parts))))

    def param_table(self) -> Dict[str, torch.Tensor]:
        """Named params keyed ``"<vertexName>_<paramName>"`` (ref:
        Model.paramTable on ComputationGraph)."""
        if self.net_params is None:
            self.init()
        return {f"{n}_{k}": v for n in self.order
                for k, v in self.net_params[n].items()}

    def _split_param_key(self, key: str):
        # vertex names may hold '_' and so may param names (f_W, b_RW):
        # the longest vertex name that prefixes the key owns it
        for n in sorted(self.net_params, key=len, reverse=True):
            if key.startswith(n + "_"):
                return n, key[len(n) + 1:]
        raise KeyError(f"no vertex owns param key '{key}'")

    def get_param(self, key: str) -> torch.Tensor:
        name, k = self._split_param_key(key)
        return self.net_params[name][k]

    def set_param(self, key: str, value) -> None:
        """(ref: Model.setParam); the shape must be the param's."""
        name, k = self._split_param_key(key)
        cur = self.net_params[name][k]
        value = torch.as_tensor(value, dtype=cur.dtype).to(cur.device)
        if value.shape != cur.shape:
            raise ValueError(f"setParam('{key}'): shape "
                             f"{tuple(value.shape)} != {tuple(cur.shape)}")
        self.net_params[name] = {**self.net_params[name], k: value.clone()}

    # ---- inspection and copies ----
    def feed_forward(self, *inputs, train: bool = False
                     ) -> Dict[str, torch.Tensor]:
        """Every vertex's activation by name, the network inputs included
        (ref: ComputationGraph.feedForward :1143).  ``train`` runs the
        training forward (dropout with seed words drawn from the graph's
        generator) without keeping its new states."""
        if self.net_params is None:
            self.init()
        policy = self._policy()
        with torch.inference_mode():
            pc, xs = policy.cast_to_compute((self.net_params,
                                             self._inputs(inputs)))
            acts, _, _, _ = self._forward_all(
                pc, _strip_rnn(self.net_state), xs, {}, train,
                self._draw_seeds().tolist() if train else None,
                keep_all=True)
        return policy.cast_to_param(acts)

    def summary(self) -> str:
        """Printable vertex table in topological order: name, vertex type,
        inputs, param count (ref: ComputationGraph.summary)."""
        if self.net_params is None:
            self.init()
        rows = [("VertexName", "VertexType", "Inputs", "ParamCount")]
        total = 0
        for name in self.order:
            v = self.conf.vertices[name]
            n = sum(t.numel() for t in self.net_params[name].values())
            total += n
            vtype = (type(v.layer_conf()).__name__
                     if isinstance(v, LayerVertex) else type(v).__name__)
            rows.append((name, vtype,
                         ",".join(self.conf.vertex_inputs[name]) or "-",
                         f"{n:,}"))
        return render_table(rows, [
            f"Total parameters: {total:,}",
            f"Inputs: {', '.join(self.conf.network_inputs)}",
            f"Outputs: {', '.join(self.conf.network_outputs)}"])

    def clone(self) -> "ComputationGraph":
        """A graph of a copy of the configuration with copies of the
        params, vertex states and updater state, on the same device, at
        the same iteration; no listeners."""
        net = ComputationGraph(copy.deepcopy(self.conf), device=self.device)
        if self.net_params is not None:
            net.net_params = _clone(self.net_params)
            net.net_state = _clone(self.net_state)
            net.opt_states = _clone(self.opt_states)
        net.iteration = self.iteration
        return net


def _unpad_graph_output(out, n, time_pairs):
    """One padded graph output sliced back to the real rows, and to the
    real time extent when its time axis is a padded input's time bucket
    (JAX :1062-1071)."""
    out = out[:n]
    for t, tb in time_pairs:
        if t is not None and tb != t and out.ndim >= 3 \
                and out.shape[1] == tb:
            return out[:, :t]
    return out


def _as_multi(item):
    """A DataSet as a one-input, one-output MultiDataSet; a MultiDataSet
    as it is."""
    return MultiDataSet.of(item) if isinstance(item, DataSet) else item
