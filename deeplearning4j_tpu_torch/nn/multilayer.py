"""MultiLayerNetwork — the port of ``deeplearning4j_tpu/nn/multilayer.py``.

``init`` draws the params from a ``torch.Generator``; ``output`` runs the
layer loop eagerly under ``torch.inference_mode`` on the network's
device (there is no ``jit`` counterpart); ``predict`` returns argmax
classes; ``params`` / ``set_params`` use the flat view of ``nn/params.py``.
``fit`` trains on batches from the asynchronous input pipeline
(``datasets/iterators.AsyncDataSetIterator``, staging each batch onto the
network's device as the step takes it) unless ``pipeline_workers`` is 0: per
step a forward with autograd to the output layer's
pre-activation, the loss (mean or sum over the batch, plus l1/l2, negated
unless minimizing), its gradient, then per layer gradient
normalization, the LR schedule, the learning rule and the bias LR
(``ops/updaters.py``).  The step's dropout randomness is an explicit
``[n_layers, 2]`` array of uint32 seed words, drawn from the network's
own generator (seeded from the configuration) unless the caller passes
it.  The network runs on the CUDA device unless it is built with
``device="cpu"``.

Every layer has a state dict (``net_state``), filled by ``init`` from
the layers' ``initial_state`` (BatchNormalization's running ``mean`` and
``var``), and the forward threads it, with the time mask, through the
preprocessors and layers.  A training step keeps the layers' new states
(batch norm's updated statistics); ``output`` and ``rnn_time_step`` read
them.  A recurrent layer returns its final (c, h) as ``rnn_state``; a
``SelfAttentionLayer`` under ``rnn_time_step`` returns its KV ring.
Under ``backprop_type("truncatedbptt")`` ``fit`` of a [N, T, C] batch
takes one step per segment of ``tbptt_fwd_length`` steps, carrying that
state (detached) from segment to segment; ``rnn_time_step`` carries it
from call to call; a standard step drops it afterwards.

``evaluate`` fills an ``nn/evaluation.Evaluation`` from ``output``;
``score_examples`` gives the loss of every example.

The configuration's ``precision`` (``ops/dtypes.py``) is applied where the
JAX package applies it (:334-350, :430-467, :1214-1233): a training step
casts the params and inputs to the compute dtype inside the
differentiated function, so autograd through the cast gives float32
gradients of the float32 masters; the output layer's pre-activation goes
to the accumulation dtype before the loss, and the layers' new states
back to the param dtype.  ``output``, ``score``, ``score_examples``,
``rnn_time_step`` and ``feed_forward`` cast their params and inputs the
same way, and ``output`` returns float32.  Master params, updater state
and batch norm's running statistics stay float32.

Listeners (``nn/listeners.py``, ``set_listeners`` / ``add_listener``) are
called after every step and, for a ``TrainingListener``, around every
epoch of ``fit``, as the JAX package calls them; a network without
listeners adds no work to a step.  A layer wrapped in ``FrozenLayerConf``
(transfer learning, ``nn/transferlearning.py``) runs its inference
forward, takes no gradient and no update.  Under
``conf.fault_tolerance(resume=True)`` ``fit`` first restores the newest
valid checkpoint (``nn/checkpoint.py``) and skips the epochs and batches
it had trained.  ``feed_forward``, ``clone``, ``summary``,
``param_table`` / ``get_param`` / ``set_param`` and ``get_layer_params``
are the JAX package's.

Not ported yet: ``fit(fused_steps=K)``, sharding and distributed
training.
"""

from __future__ import annotations

import copy
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    AsyncDataSetIterator, DataSetIterator, ListDataSetIterator)
from deeplearning4j_tpu_torch.nn import checkpoint as ckpt_mod
from deeplearning4j_tpu_torch.nn import params as param_util
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BaseOutputLayer, EmbeddingLayer, FrozenLayerConf,
    GravesBidirectionalLSTM, GravesLSTM, Layer, LossLayer, unfrozen)
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.evaluation import Evaluation
from deeplearning4j_tpu_torch.nn.listeners import (
    IterationListener, TrainingListener)
from deeplearning4j_tpu_torch.ops import bucketing
from deeplearning4j_tpu_torch.ops import dtypes as dtype_ops
from deeplearning4j_tpu_torch.ops import updaters as upd_ops
from deeplearning4j_tpu_torch.ops.platform import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.parallel import sequence as seq_ops

WEIGHT_KEYS = {"W", "RW", "f_W", "f_RW", "b_W", "b_RW"}
BIAS_KEYS = {"b", "f_b", "b_b"}


def render_table(rows: Sequence[Tuple[str, ...]], footer: Sequence[str] = ()):
    """Fixed-width text table: rows[0] is the header; footer lines follow
    a rule.  Shared by MultiLayerNetwork.summary and
    ComputationGraph.summary."""
    ncols = len(rows[0])
    widths = [max(len(r[c]) for r in rows) for c in range(ncols)]
    lines = ["  ".join(r[c].ljust(widths[c]) for c in range(ncols))
             for r in rows]
    sep = "-" * len(lines[0])
    lines.insert(1, sep)
    lines.append(sep)
    lines.extend(footer)
    return "\n".join(lines)


def _updater_for(layer: Layer) -> upd_ops.Updater:
    """The layer's learning rule with its hyperparameters and the JAX
    package's defaults."""
    name = (layer.updater or "sgd").lower()
    hyper = {}
    if name == "nesterovs":
        hyper["momentum"] = (layer.momentum if layer.momentum is not None
                             else 0.9)
    elif name == "adadelta":
        hyper["rho"] = layer.rho if layer.rho is not None else 0.95
    elif name == "rmsprop":
        hyper["rmsdecay"] = (layer.rms_decay if layer.rms_decay is not None
                             else 0.95)
    elif name in ("adam", "adamax"):
        hyper["beta1"] = (layer.adam_mean_decay
                          if layer.adam_mean_decay is not None else 0.9)
        hyper["beta2"] = (layer.adam_var_decay
                          if layer.adam_var_decay is not None else 0.999)
    if layer.epsilon is not None and name in (
            "adadelta", "rmsprop", "adam", "adamax", "adagrad"):
        hyper["epsilon"] = layer.epsilon
    return upd_ops.make(name, **hyper)


def _tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of nested dicts / tuples / lists in ``jax.tree_util`` order
    (dict keys sorted), so a flattened updater state matches the JAX
    package's byte for byte."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for t in tree for l in _tree_leaves(t)]
    return [tree]


def _detach(tree):
    """``tree`` (dicts, lists, tuples, named tuples) with every tensor
    detached."""
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_detach(t) for t in tree]
    if isinstance(tree, tuple):
        items = [_detach(t) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            tuple(items)
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


def _clone(tree):
    """``tree`` with every tensor copied (detached)."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(t) for t in tree]
    if isinstance(tree, tuple):
        items = [_clone(t) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            tuple(items)
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def fit_epochs(model, epochs: int, skip: Tuple[int, int], reset, batches,
               fit_batch) -> None:
    """Both engines' epoch loop: ``epochs`` passes of ``fit_batch`` over
    ``batches()``, each after ``reset()``, inside the epoch hooks of the
    model's TrainingListeners.  ``skip`` (epochs, batches of the next
    epoch) were trained before a resume: those epochs are passed over and
    those batches consumed without training, so the stream stands where
    an uninterrupted fit's would.  ``model.last_etl_time_ms`` gets the
    host ms each batch took to come."""
    skip_epochs, skip_batches = skip
    training = [l for l in model.listeners if isinstance(l, TrainingListener)]
    for ep in range(epochs):
        if ep < skip_epochs:
            continue
        to_skip = skip_batches if ep == skip_epochs else 0
        # where the epoch notionally began: CheckpointListener records how
        # many batches into the epoch a save lands
        model._epoch_start_iter = model.iteration - to_skip
        for lst in training:
            lst.on_epoch_start(model)
        reset()
        t_etl = time.perf_counter()
        for item in batches():
            if to_skip > 0:
                to_skip -= 1
            else:
                model.last_etl_time_ms = (time.perf_counter() - t_etl) * 1e3
                fit_batch(item)
            t_etl = time.perf_counter()
        for lst in training:
            lst.on_epoch_end(model)
        model.epoch += 1


def _tree_fill(tree, leaves):
    """``tree`` with its leaves replaced, in :func:`_tree_leaves` order,
    by the next items of the iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _tree_fill(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_fill(t, leaves) for t in tree)
    return next(leaves)


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration,
                 device: DeviceLike = None):
        self.conf = conf
        self.layers = conf.layers
        self.device = resolve_device(device)
        self.net_params: Optional[List[dict]] = None
        # per-layer carried state (batch norm's running statistics from
        # init, a recurrent layer's rnn_state)
        self.net_state: List[dict] = [{} for _ in self.layers]
        # updater state, made at the first training step or restore, so a
        # network that only serves holds none
        self.opt_states: Optional[List] = None
        self.updaters = [_updater_for(l) for l in self.layers]
        self._resolved = dtype_ops.Resolved()
        self.frozen = [isinstance(l, FrozenLayerConf) for l in self.layers]
        self.iteration = 0
        self.epoch = 0
        self.listeners: List[IterationListener] = []
        # what PerformanceListener reads: the last step's rows and the
        # host ms its batch took to come out of the iterator
        self.last_batch_size = 0
        self.last_etl_time_ms = 0.0
        self._score = float("nan")
        # the source of each step's dropout seed words
        self._generator = torch.Generator().manual_seed(
            int(conf.global_conf.seed))

    def init(self, generator: Optional[torch.Generator] = None
             ) -> "MultiLayerNetwork":
        """Draw every layer's params and set its initial state.  Without
        a generator the draws come from a CPU generator seeded with the
        configuration's seed, so one configuration gives the same weights
        on every device."""
        if generator is None:
            generator = torch.Generator().manual_seed(
                int(self.conf.global_conf.seed))
        cur = self._input_type_chain_start()
        self.net_params, self.net_state = [], []
        for i, layer in enumerate(self.layers):
            if i in self.conf.preprocessors:
                cur = self.conf.preprocessors[i].output_type(cur)
            self.net_state.append(layer.initial_state(cur, self.device))
            p, cur = layer.initialize(generator, cur, self.device)
            self.net_params.append(p)
        return self

    def _input_type_chain_start(self) -> InputType:
        if self.conf.input_type is not None:
            return self.conf.input_type
        first = unfrozen(self.layers[0])
        n_in = getattr(first, "n_in", None)
        if n_in:
            if isinstance(first, (GravesLSTM, GravesBidirectionalLSTM)):
                return InputType.recurrent(n_in)
            return InputType.feed_forward(n_in)
        raise ValueError(
            "Network needs conf.input_type or an explicit n_in on layer 0")

    def load_jax_params(self, jax_params) -> "MultiLayerNetwork":
        """Take the params of a JAX ``MultiLayerNetwork`` (its
        ``net_params``, as numpy arrays) — same layouts, so no transpose."""
        from deeplearning4j_tpu_torch.nn.convert import params_from_jax
        self.net_params = params_from_jax(jax_params, self.device)
        return self

    def load_jax_state(self, jax_state) -> "MultiLayerNetwork":
        """Take the layer states of a JAX ``MultiLayerNetwork`` (its
        ``net_state``, as numpy arrays): batch norm's running statistics
        and any RNN carry."""
        from deeplearning4j_tpu_torch.nn.convert import state_from_jax
        self.net_state = state_from_jax(jax_state, self.device)
        return self

    def _as_input(self, x) -> torch.Tensor:
        """Features as float32 on the network's device; integer indices
        stay integers when the first layer is an EmbeddingLayer, which
        gathers rows with them (as the JAX package's does)."""
        if isinstance(unfrozen(self.layers[0]), EmbeddingLayer):
            t = torch.as_tensor(x)
            if not torch.is_floating_point(t):
                return t.to(device=self.device, dtype=torch.int64)
        return self._as_float(x)

    def _as_float(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32).to(self.device)

    def _as_mask(self, mask) -> Optional[torch.Tensor]:
        return None if mask is None else self._as_float(mask)

    def _forward(self, params, state, x: torch.Tensor, mask=None,
                 train: bool = False, seeds=None, stateful_rnn: bool = False,
                 stop: Optional[int] = None, acts: Optional[list] = None
                 ) -> Tuple[torch.Tensor, List[dict], Optional[torch.Tensor]]:
        """The per-layer forward loop (preprocessor hook, state and mask
        threading, the JAX package's ``_forward_core``) -> (output, new
        per-layer states, output mask).  Unless ``stateful_rnn``, each
        layer starts without its stored ``rnn_state``.  ``stop`` runs only
        ``layers[:stop]``; in training layer i gets the seed words
        ``seeds[i]``; ``acts``, a list, receives every layer's output."""
        layers = self.layers if stop is None else self.layers[:stop]
        new_states = []
        for i, layer in enumerate(layers):
            if i in self.conf.preprocessors:
                x, mask = self.conf.preprocessors[i](x, mask)
            s = state[i]
            if not stateful_rnn and "rnn_state" in s:
                s = {k: v for k, v in s.items() if k != "rnn_state"}
            x, ns, mask = layer.forward(params[i], s, x, train,
                                        None if seeds is None else seeds[i],
                                        mask)
            new_states.append(ns)
            if acts is not None:
                acts.append(x)
        return x, new_states, mask

    def _forward_to_preout(self, params, state, x, mask, train: bool,
                           seeds=None, stateful_rnn: bool = False):
        """Forward to the output layer's PRE-activation (the stable fused
        loss works on it) -> (preout, new states, mask)."""
        n = len(self.layers)
        x, new_states, mask = self._forward(params, state, x, mask, train,
                                            seeds, stateful_rnn, stop=n - 1)
        if (n - 1) in self.conf.preprocessors:
            x, mask = self.conf.preprocessors[n - 1](x, mask)
        last = self.layers[-1]
        seed = None if seeds is None else seeds[n - 1]
        if train:
            x = last._maybe_dropout(x, True, seed)
        new_states.append(state[-1])
        return (last.preoutput(last._maybe_drop_connect(params[-1], train,
                                                        seed), x),
                new_states, mask)

    def _policy(self) -> dtype_ops.Policy:
        return self._resolved(self.conf.global_conf.precision)

    def output(self, x, mask=None) -> torch.Tensor:
        """Network output for a batch (numpy array or tensor), as a tensor
        on the network's device; no stored RNN state is used.  Under a
        mixed policy the forward runs in the compute dtype and the output
        comes back in the param dtype (float32)."""
        if self.net_params is None:
            self.init()
        policy = self._policy()
        with torch.inference_mode():
            pc, xc, mc = policy.cast_to_compute(
                (self.net_params, self._as_input(x), self._as_mask(mask)))
            out, _, _ = self._forward(pc, self.net_state, xc, mc)
            return policy.cast_to_param(out)

    def predict(self, x) -> np.ndarray:
        """Argmax class predictions."""
        return self.output(x).argmax(dim=-1).cpu().numpy()

    def warmup_inference(self, feature_dims, max_batch: int = 32) -> dict:
        """Run ``output`` once for every batch bucket a serving frontend
        can hand the model (``ops/bucketing.warmup_ladder``), so first
        requests do not pay for the kernel build, cuDNN's and cuBLAS's
        first calls, or the caching allocator's first allocations.
        Returns the warmed ladder and its wall time."""
        if self.net_params is None:
            self.init()
        ladder = bucketing.warmup_ladder(
            self.conf.global_conf.bucket_batch_sizes, max_batch)
        dims = tuple(int(d) for d in feature_dims)
        t0 = time.perf_counter()
        for nb in ladder:
            self.output(torch.zeros((nb,) + dims, device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {"buckets": ladder,
                "warmup_sec": round(time.perf_counter() - t0, 3)}

    # ---- training ----
    def set_listeners(self, *listeners: IterationListener
                      ) -> "MultiLayerNetwork":
        self.listeners = list(listeners)
        return self

    def add_listener(self, listener: IterationListener
                     ) -> "MultiLayerNetwork":
        self.listeners.append(listener)
        return self

    def fit(self, data, labels=None, epochs: int = 1
            ) -> "MultiLayerNetwork":
        """fit(DataSetIterator) | fit(DataSet) | fit(x, y)
        (ref: MultiLayerNetwork.fit :996): ``epochs`` passes over the
        data, one training step per batch (``conf.iterations`` steps when
        that is above 1).  As in the JAX package, an iterator that is not
        already asynchronous is wrapped in an ``AsyncDataSetIterator``
        with ``pipeline_workers`` workers, ``pipeline_prefetch`` raw
        batches queued and at most ``pipeline_staging_depth`` transformed
        batches waiting on the host, unless ``pipeline_workers`` is 0;
        each batch is staged onto the network's device as the step takes
        it, and the pipeline is closed on return.  Under
        ``conf.fault_tolerance(resume=True)`` a fresh network first
        restores the newest valid checkpoint and skips, without training
        on them, the epochs and the batches of the next epoch it had
        trained (``nn/checkpoint.maybe_auto_resume``)."""
        if labels is not None:
            data = DataSet(np.asarray(data), np.asarray(labels))
        if isinstance(data, DataSet):
            data = ListDataSetIterator([data])
        if not isinstance(data, DataSetIterator):
            raise TypeError(f"fit takes a DataSetIterator, a DataSet or "
                            f"(features, labels), not {type(data).__name__}")
        if self.net_params is None:
            self.init()
        skip = ckpt_mod.maybe_auto_resume(self)
        it = data
        g = self.conf.global_conf
        if (g.pipeline_workers > 0 and it.async_supported()
                and not isinstance(it, AsyncDataSetIterator)):
            it = AsyncDataSetIterator(
                it, queue_size=g.pipeline_prefetch,
                workers=g.pipeline_workers,
                staging_depth=g.pipeline_staging_depth, device=self.device)

        def batches():
            while it.has_next():
                yield it.next()
        try:
            fit_epochs(self, epochs, skip, it.reset, batches, self._fit_batch)
        finally:
            # release the pipeline's threads, also when a step raised
            if isinstance(it, AsyncDataSetIterator):
                it.close()
        return self

    def _draw_seeds(self) -> torch.Tensor:
        """One step's dropout seed words, [n_layers, 2] uint32 values (as
        int64), from the network's generator: one draw a step, so a
        resume replays ``iteration`` draws (``nn/checkpoint``)."""
        return torch.randint(0, 1 << 32, (len(self.layers), 2),
                             generator=self._generator, dtype=torch.int64)

    def _fit_batch(self, ds: DataSet, seeds=None) -> None:
        """Train on one batch: ``conf.iterations`` steps.  ``seeds`` gives
        the steps' dropout seed words, ``[n_layers, 2]`` for one step or
        ``[iterations, n_layers, 2]``; without it each step draws its own
        from the network's generator."""
        g = self.conf.global_conf
        if not isinstance(self.layers[-1], (BaseOutputLayer, LossLayer)):
            raise ValueError(
                "Last layer must be an output/loss layer to fit()")
        if self.net_params is None:
            self.init()
        if self.opt_states is None:
            self.opt_states = self._init_opt_states()
        self.last_batch_size = ds.num_examples()
        if self.conf.backprop_type == "truncatedbptt" and \
                np.ndim(ds.features) == 3:
            self._fit_tbptt(ds)
            return
        n_steps = max(1, g.iterations)
        if seeds is not None:
            seeds = np.asarray(seeds, dtype=np.int64).reshape(
                -1, len(self.layers), 2)
            if len(seeds) != n_steps:
                raise ValueError(f"{len(seeds)} steps of seeds for "
                                 f"{n_steps} iterations")
        x = self._as_input(ds.features)
        y = self._as_float(ds.labels)
        fmask = self._as_mask(ds.features_mask)
        lmask = self._as_mask(ds.labels_mask)
        for k in range(n_steps):
            step_seeds = (self._draw_seeds() if seeds is None
                          else seeds[k]).tolist()
            score, grads = self._grad_step(x, y, fmask, lmask, step_seeds)
            self._apply_updates(grads, self.iteration)
            self.rnn_clear_previous_state()
            self._score = score
            self.iteration += 1
            for lst in self.listeners:
                lst.iteration_done(self, self.iteration)

    def _fit_tbptt(self, ds: DataSet) -> None:
        """Truncated BPTT (ref: MultiLayerNetwork.doTruncatedBPTT :1227):
        the RNN state is cleared, then one grad step and one update per
        segment of ``tbptt_fwd_length`` time steps, each segment starting
        from the state the previous one ended in (detached, so the
        gradient stops at the segment's start).  Labels and masks are
        sliced with the features."""
        T = ds.features.shape[1]
        seg_len = self.conf.tbptt_fwd_length
        self.rnn_clear_previous_state()
        x, y = self._as_input(ds.features), self._as_float(ds.labels)
        fmask = self._as_mask(ds.features_mask)
        lmask = self._as_mask(ds.labels_mask)
        for t0 in range(0, T, seg_len):
            seg = slice(t0, min(t0 + seg_len, T))
            score, grads = self._grad_step(
                x[:, seg], y[:, seg] if y.ndim == 3 else y,
                None if fmask is None else fmask[:, seg],
                None if lmask is None else lmask[:, seg],
                self._draw_seeds().tolist())
            self._apply_updates(grads, self.iteration)
            self._score = score
            self.iteration += 1
            for lst in self.listeners:
                lst.iteration_done(self, self.iteration)

    def _grad_step(self, x, y, fmask, lmask, seeds):
        """Score of the batch and its gradient per layer and param.  The
        forward starts from ``net_state`` (its ``rnn_state`` only under
        truncated BPTT) and the layers' new states, detached, replace it,
        as the JAX step returns them.

        Under a mixed policy the carried ``rnn_state`` enters the forward in
        the compute dtype, as ``rnn_time_step`` hands it (and the JAX
        package's ``_rnn_step_raw``, :1217-1233): every TBPTT segment then
        runs its recurrence in bf16, the first as the later ones.  The JAX
        TBPTT step hands its layers the carry it stored, upcast to f32, so
        there the segments after the first promote the recurrence to f32;
        in the port a bf16 segment would otherwise meet an f32 carry in
        ``h @ RW`` and raise."""
        g = self.conf.global_conf
        policy = self._policy()
        params = [{k: v.detach().requires_grad_(not self.frozen[i])
                   for k, v in lp.items()}
                  for i, lp in enumerate(self.net_params)]
        x, fmask = policy.cast_to_compute((x, fmask))
        state = [{k: policy.cast_to_compute(v) if k == "rnn_state" else v
                  for k, v in s.items()} for s in self.net_state]
        with torch.enable_grad():
            # the cast inside the differentiated function: the gradients
            # of the f32 masters come back in f32
            preout, new_states, m = self._forward_to_preout(
                policy.cast_to_compute(params), state, x, fmask,
                True, seeds,
                stateful_rnn=self.conf.backprop_type == "truncatedbptt")
            preout = policy.cast_to_accum(preout)
            new_states = policy.cast_to_param(new_states)
            lm = lmask if lmask is not None else (
                m if m is not None and m.ndim == preout.ndim - 1 else None)
            per_ex = self.layers[-1].compute_score(y, preout, lm)
            score = per_ex.mean() if g.mini_batch else per_ex.sum()
            score = score + self._reg_penalty(params)
            if not g.minimize:
                score = -score
            leaves = [v for lp in params for v in lp.values()
                      if v.requires_grad]
            flat = iter(torch.autograd.grad(score, leaves))
        grads = [{k: next(flat) for k, v in lp.items() if v.requires_grad}
                 for lp in params]
        self.net_state = _detach(new_states)
        return score.detach(), grads

    def _reg_penalty(self, params):
        """l1/l2 on weights and biases (zero unless the configuration
        enables regularization)."""
        total = 0.0
        for layer, lp in zip(self.layers, params):
            l1, l2 = layer.l1 or 0.0, layer.l2 or 0.0
            l1b, l2b = layer.l1_bias or 0.0, layer.l2_bias or 0.0
            for k, v in lp.items():
                a, b = ((l1b, l2b) if k in BIAS_KEYS
                        else (l1, l2) if k in WEIGHT_KEYS else (0.0, 0.0))
                if a:
                    total = total + a * torch.sum(torch.abs(v))
                if b:
                    total = total + 0.5 * b * torch.sum(v * v)
        return total

    def _init_opt_states(self) -> List:
        return [u.init(lp) for u, lp in zip(self.updaters, self.net_params)]

    @torch.no_grad()
    def _apply_updates(self, grads, it: int) -> None:
        """Per layer: gradient normalization, LR schedule, learning rule,
        bias-LR override, then params -= update.  The params are updated
        in place (JAX builds new arrays), which saves one copy of them."""
        g = self.conf.global_conf
        for i, layer in enumerate(self.layers):
            gi = grads[i]
            if not gi or self.frozen[i]:
                continue
            gi = upd_ops.normalize_gradient(
                gi, layer.gradient_normalization,
                layer.gradient_normalization_threshold or 1.0)
            base = (layer.learning_rate if layer.learning_rate is not None
                    else g.learning_rate)
            lr = upd_ops.schedule_lr(
                base, g.lr_policy, it, decay_rate=g.lr_policy_decay_rate,
                steps=g.lr_policy_steps, power=g.lr_policy_power,
                schedule_map=g.learning_rate_schedule)
            upd, self.opt_states[i] = self.updaters[i].apply(
                gi, self.opt_states[i], lr, it)
            blr = layer.bias_learning_rate
            if blr is not None and blr != (layer.learning_rate
                                           or g.learning_rate):
                # rescale the bias update (exact for rules linear in lr)
                scale = blr / base if base else 1.0
                upd = {k: (v * scale if k in BIAS_KEYS else v)
                       for k, v in upd.items()}
            for k, u in upd.items():
                self.net_params[i][k].sub_(u)

    def score(self, dataset: Optional[DataSet] = None) -> float:
        """The loss on a DataSet (inference forward, l1/l2 included), or
        the score of the last training step (ref: MultiLayerNetwork.score)."""
        if dataset is None:
            return float(self._score)
        g = self.conf.global_conf
        with torch.inference_mode():
            preout, _, m = self._inference_preout(
                dataset.features, dataset.features_mask)
            lm = (self._as_mask(dataset.labels_mask)
                  if dataset.labels_mask is not None else
                  m if m is not None and m.ndim == preout.ndim - 1 else None)
            per_ex = self.layers[-1].compute_score(
                self._as_float(dataset.labels), preout, lm)
            score = per_ex.mean() if g.mini_batch else per_ex.sum()
            return float(score + self._reg_penalty(self.net_params))

    def score_examples(self, data, add_regularization_terms: bool = False
                       ) -> np.ndarray:
        """Per-example scores WITHOUT minibatch averaging (ref:
        MultiLayerNetwork.scoreExamples :1884 iterator, :1901 DataSet):
        the output layer's loss of each example from an inference forward;
        ``add_regularization_terms`` adds the net's l1/l2 penalty to every
        example's score.  Takes a DataSet or an iterator; returns a 1-D
        array over all examples."""
        if self.net_params is None:
            self.init()
        batches = [data] if isinstance(data, DataSet) else data
        out = []
        with torch.inference_mode():
            for ds in batches:
                preout, _, m = self._inference_preout(ds.features,
                                                      ds.features_mask)
                lm = (self._as_mask(ds.labels_mask)
                      if ds.labels_mask is not None else
                      m if m is not None and m.ndim == preout.ndim - 1
                      else None)
                per = self.layers[-1].compute_score(
                    self._as_float(ds.labels), preout, lm)
                if add_regularization_terms:
                    per = per + self._reg_penalty(self.net_params)
                out.append(per.cpu().numpy())
        return np.concatenate(out)

    def _inference_preout(self, features, features_mask):
        """The inference forward to the output layer's pre-activation,
        under the precision policy -> (preout in the accumulation dtype,
        new states, mask)."""
        policy = self._policy()
        pc, xc, mc = policy.cast_to_compute(
            (self.net_params, self._as_input(features),
             self._as_mask(features_mask)))
        preout, states, m = self._forward_to_preout(pc, self.net_state, xc,
                                                    mc, False)
        return policy.cast_to_accum(preout), states, m

    def evaluate(self, iterator_or_dataset) -> Evaluation:
        """Classification evaluation (ref: MultiLayerNetwork.evaluate):
        ``output`` of every batch's features against its labels (and
        labels mask)."""
        ev = Evaluation()
        if isinstance(iterator_or_dataset, DataSet):
            batches = [iterator_or_dataset]
        else:
            iterator_or_dataset.reset()
            batches = iterator_or_dataset
        for ds in batches:
            ev.eval(ds.labels, self.output(ds.features),
                    mask=ds.labels_mask)
        return ev

    # ---- stateful RNN inference ----
    def rnn_time_step(self, x, mask=None) -> torch.Tensor:
        """Stateful inference (ref: MultiLayerNetwork.rnnTimeStep :2383):
        x [N, T, C] continues each recurrent layer from the state the
        previous call left (zeros after :meth:`rnn_clear_previous_state`),
        and the new final state is kept for the next call.  Fed one step
        at a time it equals :meth:`output` on the whole sequence.  The
        forward runs under ``kv_decode_scope``, so an attention layer
        decodes against its KV ring (the JAX package's ``_rnn_step_raw``)."""
        if self.net_params is None:
            self.init()
        policy = self._policy()
        # the carries take the compute dtype; batch norm's statistics stay
        state = [{k: policy.cast_to_compute(v) if k == "rnn_state" else v
                  for k, v in s.items()} for s in self.net_state]
        with torch.no_grad(), seq_ops.kv_decode_scope():
            pc, xc, mc = policy.cast_to_compute(
                (self.net_params, self._as_input(x), self._as_mask(mask)))
            out, new_states, _ = self._forward(pc, state, xc, mc,
                                               stateful_rnn=True)
        self._merge_rnn_state(policy.cast_to_param(new_states))
        return policy.cast_to_param(out)

    def _merge_rnn_state(self, new_states) -> None:
        """Keep the layers' new ``rnn_state`` and nothing else of their
        new states."""
        merged = []
        for old, new in zip(self.net_state, new_states):
            s = dict(old)
            if "rnn_state" in new:
                s["rnn_state"] = new["rnn_state"]
            merged.append(s)
        self.net_state = merged

    def rnn_clear_previous_state(self) -> None:
        """Drop the stored RNN carry: the next ``rnn_time_step`` starts
        from zeros, and a standard training step leaks no state into the
        next batch (the JAX package's ``_strip_rnn_state``)."""
        self.net_state = [{k: v for k, v in s.items() if k != "rnn_state"}
                          for s in self.net_state]

    # ---- updater state ----
    def updater_state_flat(self) -> torch.Tensor:
        """The updater state as one flat vector, in the JAX package's
        ``tree_leaves`` order (the ``updaterState.bin`` layout)."""
        leaves = _tree_leaves(self.opt_states or [])
        if not leaves:
            return torch.zeros((0,), dtype=torch.float32)
        return torch.cat([l.reshape(-1) for l in leaves])

    def set_updater_state_flat(self, flat) -> None:
        if self.opt_states is None:
            self.opt_states = self._init_opt_states()
        flat = torch.as_tensor(flat, dtype=torch.float32).reshape(-1)
        leaves = _tree_leaves(self.opt_states)
        n = sum(l.numel() for l in leaves)
        if flat.numel() != n:
            raise ValueError(f"Updater state size mismatch: model {n} vs "
                             f"flat {flat.numel()}")
        parts, off = [], 0
        for l in leaves:
            parts.append(flat[off:off + l.numel()].reshape(l.shape).to(
                device=l.device, dtype=l.dtype).clone())
            off += l.numel()
        self.opt_states = _tree_fill(self.opt_states, iter(parts))

    # ---- flat param view ----
    def params(self) -> torch.Tensor:
        """Flat 1-D param vector, on the network's device."""
        return param_util.flatten(self.net_params)

    def set_params(self, flat) -> None:
        self.net_params = param_util.unflatten(flat, self.net_params)

    def num_params(self) -> int:
        return param_util.num_params(self.net_params)

    n_params = property(num_params)

    def get_layer_params(self, i: int) -> dict:
        return self.net_params[i]

    def param_table(self) -> Dict[str, torch.Tensor]:
        """Named params keyed ``"<layerIdx>_<paramName>"``, e.g. ``"0_W"``,
        ``"1_b"`` (ref: Model.paramTable)."""
        if self.net_params is None:
            self.init()
        return {f"{i}_{k}": v for i, lp in enumerate(self.net_params)
                for k, v in lp.items()}

    def get_param(self, key: str) -> torch.Tensor:
        """(ref: Model.getParam("0_W"))"""
        i, k = key.split("_", 1)
        return self.net_params[int(i)][k]

    def set_param(self, key: str, value) -> None:
        """(ref: Model.setParam); the shape must be the param's."""
        i, k = key.split("_", 1)
        cur = self.net_params[int(i)][k]
        value = torch.as_tensor(value, dtype=cur.dtype).to(cur.device)
        if value.shape != cur.shape:
            raise ValueError(f"setParam('{key}'): shape "
                             f"{tuple(value.shape)} != {tuple(cur.shape)}")
        self.net_params[int(i)] = {**self.net_params[int(i)],
                                   k: value.clone()}

    # ---- inspection and copies ----
    def feed_forward(self, x, train: bool = False, mask=None
                     ) -> List[torch.Tensor]:
        """Every layer's activation, in layer order (ref: feedForward
        :696-788).  ``train`` runs the training forward (dropout with seed
        words drawn from the network's generator, batch statistics)
        without keeping its new states."""
        if self.net_params is None:
            self.init()
        policy = self._policy()
        acts: List[torch.Tensor] = []
        with torch.inference_mode():
            pc, xc, mc = policy.cast_to_compute(
                (self.net_params, self._as_input(x), self._as_mask(mask)))
            self._forward(pc, self.net_state, xc, mc, train,
                          self._draw_seeds().tolist() if train else None,
                          acts=acts)
        return policy.cast_to_param(acts)

    def summary(self) -> str:
        """Printable layer table: index, type, param shapes, param count
        (ref: MultiLayerNetwork.summary :2689)."""
        if self.net_params is None:
            self.init()
        rows = [("Idx", "LayerType", "ParamShapes", "ParamCount")]
        total = 0
        for i, (layer, lp) in enumerate(zip(self.layers, self.net_params)):
            n = sum(v.numel() for v in lp.values())
            total += n
            shapes = ", ".join(f"{k}{tuple(int(d) for d in v.shape)}"
                               for k, v in sorted(lp.items()))
            rows.append((str(i), type(layer).__name__, shapes or "-",
                         f"{n:,}"))
        return render_table(rows, [f"Total parameters: {total:,}"])

    def clone(self) -> "MultiLayerNetwork":
        """A network of a copy of the configuration with copies of the
        params, layer states (a KV ring included: ``attend_cached``
        writes it in place) and updater state, on the same device, at
        the same iteration; no listeners (as the JAX package's)."""
        net = MultiLayerNetwork(copy.deepcopy(self.conf), device=self.device)
        if self.net_params is not None:
            net.net_params = _clone(self.net_params)
            net.net_state = _clone(self.net_state)
            net.opt_states = _clone(self.opt_states)
        net.iteration = self.iteration
        return net
