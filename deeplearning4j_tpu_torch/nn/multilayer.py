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

``fit(fused_steps=K)`` trains K batches of one shape as a group whose
steps the device runs back to back, the listeners once a group (the JAX
package's scan fusion).  ``pretrain`` / ``pretrain_layer`` train the
layers of ``nn/conf/layers_pretrain.py`` unsupervised, layer by layer, on
the activations of the layers below; a ``CenterLossOutputLayer`` head is
scored on its input features.  ``backprop_gradient`` /
``apply_gradients`` let a caller own the loss: gradients for an external
error on the output, then the updaters.  ``nn/gradientcheck.py`` and
``nn/solvers.py`` work on these engines.

``quantize_inference("int8" | "fp8")`` serves ``output`` from weight-only
codes kept on the device (``ops/quantize.py``), expanded layer by layer as
the forward reaches them; ``mode=None`` serves dense again.  Under
``gradient_checkpointing`` a training forward runs each layer under
``torch.utils.checkpoint`` (non-reentrant): the backward recomputes the
layer from its inputs and its explicit dropout seed words, so the
recompute launches the same kernels on the same inputs, and the layer's
new state (batch norm's statistics, ``rnn_state``) is the first forward's.
``rnn_carry_template`` makes the zero carries of ``n`` streams from shapes
found on ``meta`` tensors; ``rnn_activate_using_stored_state`` runs every
layer from the stored carries.  Under ``shape_bucketing`` (``ops/
bucketing.py``) ``fit`` (the async pipeline's ETL included, on its feeder
thread), ``output``, ``score`` and ``score_examples`` pad ragged batches
up to their bucket with exact masks; ``compile_telemetry`` counts the
input signatures each entry point met.

Not ported yet: sharding and distributed training.
"""

from __future__ import annotations

import copy
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
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
from deeplearning4j_tpu_torch.ops import quantize as qz
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


def checkpointed(model, train: bool) -> bool:
    """Whether a forward of ``model`` runs each layer (vertex) under
    ``torch.utils.checkpoint``: in a training forward that records
    gradients, with ``gradient_checkpointing`` on (JAX multilayer
    :143-153, graph :167)."""
    return (train and model.conf.global_conf.gradient_checkpointing
            and torch.is_grad_enabled())


def run_checkpointed(fn, *args):
    """``fn(*args)`` under non-reentrant ``torch.utils.checkpoint``: its
    activations are not kept for the backward, which runs ``fn`` again
    on the same inputs.  The outputs, the layer's new state among them,
    are the first call's."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def _zeros_tree(tree, device):
    """Zeros of ``tree``'s structure (named tuples kept), shapes and
    dtypes, on ``device``."""
    if isinstance(tree, dict):
        return {k: _zeros_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_zeros_tree(t, device) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            type(tree)(items)
    if isinstance(tree, torch.Tensor):
        return torch.zeros(tree.shape, dtype=tree.dtype, device=device)
    return tree


def to_meta(tree):
    """``tree`` with every tensor as a ``meta`` tensor of its shape and
    dtype: a forward over it finds shapes and runs nothing."""
    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [to_meta(t) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            type(tree)(items)
    return tree.to("meta") if isinstance(tree, torch.Tensor) else tree


def serving_params(model, params, policy):
    """The params ``output`` reads: the quantized codes through a
    :class:`ops.quantize.DequantizedView` when quantized serving is on
    (re-quantized when ``iteration`` moved since; JAX ``_infer_params``),
    else the dense params, cast through the policy."""
    if model._infer_quant is None:
        return policy.cast_to_compute(params)
    if model._q_params is None or model._q_iteration != model.iteration:
        model._q_params, model._q_stats = qz.quantize_params(
            params, model._infer_quant)
        model._q_iteration = model.iteration
    return qz.DequantizedView(model._q_params, policy.cast_to_compute)


def set_quantized(model, mode) -> None:
    """``quantize_inference`` of either engine (JAX multilayer :988, graph
    :914): ``mode`` 'int8' or 'fp8' serves from weight-only codes,
    quantized at the next ``output``; None serves dense again; anything
    else, or fp8 on a torch without float8, raises."""
    if mode is not None:
        mode = qz.check_mode(mode)
        if model.net_params is None:
            model.init()
    model._infer_quant = mode
    model._q_params = model._q_stats = None
    model._q_iteration = -1


def layer_reg_penalty(layer: Layer, lp: dict):
    """One layer's l1/l2 on its weights (``WEIGHT_KEYS``) and biases
    (``BIAS_KEYS``); 0.0 when it has none (JAX ``_layer_reg_penalty``)."""
    l1, l2 = layer.l1 or 0.0, layer.l2 or 0.0
    l1b, l2b = layer.l1_bias or 0.0, layer.l2_bias or 0.0
    total = 0.0
    for k, v in lp.items():
        a, b = ((l1b, l2b) if k in BIAS_KEYS
                else (l1, l2) if k in WEIGHT_KEYS else (0.0, 0.0))
        if a:
            total = total + a * torch.sum(torch.abs(v))
        if b:
            total = total + 0.5 * b * torch.sum(v * v)
    return total


def reg_gradients(penalty_fn, params):
    """The gradient of ``penalty_fn(params)`` (l1/l2) per entry and param,
    zeros where the penalty does not reach: what ``apply_gradients`` adds
    to external gradients.  ``params`` is a list or a dict of param
    dicts, and so is the result."""
    is_dict = isinstance(params, dict)
    keys = list(params) if is_dict else list(range(len(params)))
    leaves = {i: {k: v.detach().requires_grad_() for k, v in params[i].items()}
              for i in keys}
    with torch.enable_grad():
        pen = penalty_fn(leaves if is_dict else [leaves[i] for i in keys])
    flat = [v for lp in leaves.values() for v in lp.values()]
    got = iter(grads_or_zeros(pen, flat) if isinstance(pen, torch.Tensor)
               else [torch.zeros_like(v) for v in flat])
    out = {i: {k: next(got) for k in lp} for i, lp in leaves.items()}
    return out if is_dict else [out[i] for i in keys]


def grads_or_zeros(outputs, leaves, grad_outputs=None) -> List[torch.Tensor]:
    """d outputs / d leaves (weighted by ``grad_outputs``), zeros for a
    leaf the outputs do not reach (a pretrain layer's visible bias or
    decoder in a supervised step, the centres in ``output()``), as
    ``jax.grad`` and ``jax.vjp`` give them."""
    got = torch.autograd.grad(outputs, leaves, grad_outputs=grad_outputs,
                              allow_unused=True)
    return [torch.zeros_like(v) if g is None else g
            for g, v in zip(got, leaves)]


def grad_like(g, ref: torch.Tensor) -> torch.Tensor:
    """A caller's gradient (a tensor or an array) as a tensor on
    ``ref``'s device and in its dtype."""
    if not isinstance(g, torch.Tensor):
        g = torch.from_numpy(np.array(g))
    return g.to(device=ref.device, dtype=ref.dtype)


def fused_group_size(conf, fused_steps: int) -> int:
    """K of ``fit(fused_steps=K)``: 1 (step by step) under truncated BPTT
    and when ``iterations`` is above 1, as in the JAX package (:580-583)."""
    if conf.backprop_type == "truncatedbptt" or \
            conf.global_conf.iterations > 1:
        return 1
    return max(1, int(fused_steps))


def fit_group(model, group, signature, rows=None) -> None:
    """One ``fused_steps`` group of either engine (JAX
    ``_fit_fused_group``, multilayer :673-731, graph :538-616): batches of
    one ``signature`` (shapes, mask presence) step back to back and the
    listeners fire once, after the last, with the group's rows (``rows``,
    each batch's unpadded count when the group was bucketed); a group of
    mixed signatures runs step by step.  The model's first group ever
    runs its first batch alone, as the JAX package's first launch does."""
    rows = [b.num_examples() for b in group] if rows is None else rows
    if len({signature(b) for b in group}) != 1:
        for b in group:
            model._fit_batch(b)
        return
    if not model._fused_before:
        model._fused_before = True
        model._fit_batch(group[0])
        group, rows = group[1:], rows[1:]
        if not group:
            return
    model.compile_telemetry.record(f"fused_step_k{len(group)}",
                                   signature(group[0]))
    for b in group:
        model._fit_batch(b, notify=False)
    model.last_batch_size = sum(rows)
    for lst in model.listeners:
        lst.iteration_done(model, model.iteration)


def noise_generator(model) -> torch.Generator:
    """The model's generator of pretraining noise, on its device, seeded
    from the configuration at first use."""
    if model._noise_gen is None:
        model._noise_gen = torch.Generator(device=model.device).manual_seed(
            int(model.conf.global_conf.seed))
    return model._noise_gen


def pretrain_gradients(model, layer, params: dict, feats, noise=None):
    """The pretrain step's loss and gradients (JAX multilayer :922-945):
    the layer's ``pretrain_loss`` on ``feats`` and ``noise`` (drawn from
    :func:`noise_generator` when None) plus its l1/l2, negated unless
    minimizing, differentiated for this layer's params alone."""
    if noise is None:
        noise = layer.draw_noise(feats, noise_generator(model))
    lp = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        loss = layer.pretrain_loss(lp, feats, noise) + \
            layer_reg_penalty(layer, lp)
        if not model.conf.global_conf.minimize:
            loss = -loss
        grads = dict(zip(lp, torch.autograd.grad(loss, list(lp.values()))))
    return loss.detach(), grads


def fit_epochs(model, epochs: int, skip: Tuple[int, int], reset, batches,
               fit_batch, fuse: int = 1, fit_group=None) -> None:
    """Both engines' epoch loop: ``epochs`` passes of ``fit_batch`` over
    ``batches()``, each after ``reset()``, inside the epoch hooks of the
    model's TrainingListeners.  ``skip`` (epochs, batches of the next
    epoch) were trained before a resume: those epochs are passed over and
    those batches consumed without training, so the stream stands where
    an uninterrupted fit's would (counted in batches, whatever ``fuse``).
    ``model.last_etl_time_ms`` gets the host ms each batch took to come.
    With ``fuse`` K > 1, K consecutive batches go to ``fit_group`` together
    and an epoch's ragged tail to ``fit_batch`` one by one."""
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
        pending = []
        for item in batches():
            if to_skip > 0:
                to_skip -= 1
            else:
                model.last_etl_time_ms = (time.perf_counter() - t_etl) * 1e3
                if fuse > 1:
                    pending.append(item)
                    if len(pending) == fuse:
                        fit_group(pending)
                        pending = []
                else:
                    fit_batch(item)
            t_etl = time.perf_counter()
        for item in pending:
            fit_batch(item)
        for lst in training:
            lst.on_epoch_end(model)
        model.epoch += 1


def as_iterator(data):
    """An iterator of batches from an iterator, a DataSet or MultiDataSet,
    or features alone (an array or tensor, taken as the DataSet (x, x)):
    what ``pretrain`` reads."""
    if isinstance(data, (np.ndarray, torch.Tensor)):
        data = DataSet(data, data)
    if isinstance(data, (DataSet, MultiDataSet)):
        data = ListDataSetIterator([data])
    return data


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
        # pretraining's noise, drawn on the network's device (made at the
        # first pretrain step)
        self._noise_gen: Optional[torch.Generator] = None
        # whether fit(fused_steps=K) has run a group yet
        self._fused_before = False
        # input signatures each entry point met (ops/bucketing.py)
        self.compile_telemetry = bucketing.CompileTelemetry()
        self._bucket_train_ok: Optional[bool] = None
        # weight-only quantized serving (quantize_inference)
        self._infer_quant: Optional[str] = None
        self._q_params = self._q_stats = None
        self._q_iteration = -1

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
        remat = checkpointed(self, train)
        for i, layer in enumerate(layers):
            if i in self.conf.preprocessors:
                x, mask = self.conf.preprocessors[i](x, mask)
            s = state[i]
            if not stateful_rnn and "rnn_state" in s:
                s = {k: v for k, v in s.items() if k != "rnn_state"}
            seed = None if seeds is None else seeds[i]
            if remat:
                x, ns, mask = run_checkpointed(
                    lambda p, s_, x_, m_, layer=layer, seed=seed:
                    layer.forward(p, s_, x_, True, seed, m_),
                    params[i], s, x, mask)
            else:
                x, ns, mask = layer.forward(params[i], s, x, train, seed,
                                            mask)
            new_states.append(ns)
            if acts is not None:
                acts.append(x)
        return x, new_states, mask

    def _forward_to_preout(self, params, state, x, mask, train: bool,
                           seeds=None, stateful_rnn: bool = False):
        """Forward to the output layer's PRE-activation (the stable fused
        loss works on it) -> (preout, new states, mask, features): the
        features are the output layer's input, which a
        ``CenterLossOutputLayer`` scores."""
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
                new_states, mask, x)

    def _per_example_loss(self, params, y, preout, feats, lm):
        """The output layer's loss of each example; a layer that
        ``requires_features_for_score`` (the centre-loss head) also gets
        the features and its own params (JAX :348, :443, :1153)."""
        last = self.layers[-1]
        if getattr(last, "requires_features_for_score", False):
            return last.compute_score_with_features(y, preout, feats,
                                                    params[-1], lm)
        return last.compute_score(y, preout, lm)

    def _policy(self) -> dtype_ops.Policy:
        return self._resolved(self.conf.global_conf.precision)

    def output(self, x, mask=None) -> torch.Tensor:
        """Network output for a batch (numpy array or tensor), as a tensor
        on the network's device; no stored RNN state is used.  Under a
        mixed policy the forward runs in the compute dtype and the output
        comes back in the param dtype (float32).  Under quantized serving
        (:meth:`quantize_inference`) each layer's weights are expanded from
        their codes as the forward reaches it; under ``shape_bucketing``
        the batch is zero-padded up to its bucket and the output sliced
        back (JAX :1045-1078)."""
        if self.net_params is None:
            self.init()
        policy = self._policy()
        unpad = bucket = None
        if self.conf.global_conf.shape_bucketing:
            x, mask, n, t, bucket = bucketing.bucket_inference_features(
                x, mask, self.conf.global_conf)
            unpad = (n, t, bucket[1])
        with torch.inference_mode():
            xc, mc = policy.cast_to_compute(
                (self._as_input(x), self._as_mask(mask)))
            self.compile_telemetry.record("output", (xc, mc), bucket=bucket)
            out, _, _ = self._forward(
                serving_params(self, self.net_params, policy),
                self.net_state, xc, mc)
            out = policy.cast_to_param(out)
        if unpad is not None:
            out = bucketing.unpad_outputs(out, *unpad)
        return out

    def quantize_inference(self, mode: str = "int8") -> "MultiLayerNetwork":
        """Serve ``output`` (and so ``predict``, the micro-batcher and
        ``warmup_inference``) from weight-only quantized params (JAX
        :988-1040): every float param of two or more dimensions becomes
        int8 (or fp8) codes and float32 scales per index of its last axis,
        kept on the network's device and expanded layer by layer in the
        forward; biases and 1-D params stay float32.  The codes are made
        at the next ``output`` and again whenever ``iteration`` moved
        since (training keeps the float32 masters).  ``mode=None`` serves
        dense again.  An unknown mode raises; there is no quiet fallback
        to dense serving."""
        set_quantized(self, mode)
        return self

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

    def fit(self, data, labels=None, epochs: int = 1, fused_steps: int = 1
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
        trained (``nn/checkpoint.maybe_auto_resume``).

        ``fused_steps=K`` > 1 (the JAX package's scan fusion, :489-731)
        trains K consecutive batches of identical shapes and mask presence
        as one group: their K steps are enqueued on the device with no host
        synchronisation between them, the listeners fire once a group and
        see its last score, and the network's first group ever runs its
        first batch alone, as JAX's does.  A group of mixed shapes and an
        epoch's ragged tail run step by step.  Each step draws its own
        dropout seed words, so a group is the same computation as K plain
        steps.  The flag is ignored under truncated BPTT and when
        ``iterations`` is above 1."""
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
            transform = None
            if self._bucket_train_enabled():
                # bucket on the pipeline's thread, before staging: the
                # staged batch is bucket-shaped and the step's own
                # bucketing passes it through (JAX :555-565)
                transform = (lambda d: bucketing.bucket_train_dataset(
                    d, g)[0])
            it = AsyncDataSetIterator(
                it, queue_size=g.pipeline_prefetch,
                workers=g.pipeline_workers,
                staging_depth=g.pipeline_staging_depth, device=self.device,
                transform=transform)

        def batches():
            while it.has_next():
                yield it.next()
        try:
            fit_epochs(self, epochs, skip, it.reset, batches, self._fit_batch,
                       fused_group_size(self.conf, fused_steps),
                       self._fit_group)
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

    def _bucket_train_enabled(self) -> bool:
        """Bucketing of the loss paths (fit, score): the configuration's
        ``shape_bucketing`` and the exact pad-and-mask preconditions
        (``bucketing.pad_supported``); truncated BPTT segments its own
        time axis and is left out (JAX :287-297)."""
        g = self.conf.global_conf
        if not g.shape_bucketing or \
                self.conf.backprop_type == "truncatedbptt":
            return False
        if self._bucket_train_ok is None:
            self._bucket_train_ok = bucketing.pad_supported(self)
        return self._bucket_train_ok

    def _maybe_bucket_train(self, ds: DataSet):
        """(ds padded up to its bucket, bucket) when bucketing is on, else
        (ds, None)."""
        if self._bucket_train_enabled():
            return bucketing.bucket_train_dataset(ds, self.conf.global_conf)
        return ds, None

    def _fit_group(self, group: List[DataSet]) -> None:
        # ragged groups become bucket-uniform and stay one group
        rows = [d.num_examples() for d in group]
        group = [self._maybe_bucket_train(d)[0] for d in group]
        fit_group(self, group, lambda d: (
            tuple(d.features.shape), tuple(d.labels.shape),
            d.features_mask is None, d.labels_mask is None), rows)

    def _fit_batch(self, ds: DataSet, seeds=None, notify: bool = True
                   ) -> None:
        """Train on one batch: ``conf.iterations`` steps.  ``seeds`` gives
        the steps' dropout seed words, ``[n_layers, 2]`` for one step or
        ``[iterations, n_layers, 2]``; without it each step draws its own
        from the network's generator.  ``notify`` False leaves the
        listeners to the caller (a ``fused_steps`` group).  Nothing here
        waits for the device: the seed words are drawn on the host, and
        the score stays a device tensor until a listener reads it."""
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
        ds, bucket = self._maybe_bucket_train(ds)
        x = self._as_input(ds.features)
        y = self._as_float(ds.labels)
        fmask = self._as_mask(ds.features_mask)
        lmask = self._as_mask(ds.labels_mask)
        self.compile_telemetry.record("train_step", (x, y, fmask, lmask),
                                      bucket=bucket)
        for k in range(n_steps):
            # a host tensor's tolist(): no device synchronisation
            step_seeds = (self._draw_seeds() if seeds is None
                          else seeds[k]).tolist()
            score, grads = self._grad_step(x, y, fmask, lmask, step_seeds)
            self._apply_updates(grads, self.iteration)
            self.rnn_clear_previous_state()
            self._score = score
            self.iteration += 1
            if notify:
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
            preout, new_states, m, feats = self._forward_to_preout(
                policy.cast_to_compute(params), state, x, fmask,
                True, seeds,
                stateful_rnn=self.conf.backprop_type == "truncatedbptt")
            preout = policy.cast_to_accum(preout)
            new_states = policy.cast_to_param(new_states)
            lm = lmask if lmask is not None else (
                m if m is not None and m.ndim == preout.ndim - 1 else None)
            per_ex = self._per_example_loss(params, y, preout,
                                            policy.cast_to_accum(feats), lm)
            score = per_ex.mean() if g.mini_batch else per_ex.sum()
            score = score + self._reg_penalty(params)
            if not g.minimize:
                score = -score
            leaves = [v for lp in params for v in lp.values()
                      if v.requires_grad]
            flat = iter(grads_or_zeros(score, leaves))
        grads = [{k: next(flat) for k, v in lp.items() if v.requires_grad}
                 for lp in params]
        self.net_state = _detach(new_states)
        return score.detach(), grads

    def _reg_penalty(self, params):
        """l1/l2 on weights and biases (zero unless the configuration
        enables regularization)."""
        total = 0.0
        for layer, lp in zip(self.layers, params):
            total = total + layer_reg_penalty(layer, lp)
        return total

    def _init_opt_states(self) -> List:
        return [u.init(lp) for u, lp in zip(self.updaters, self.net_params)]

    @torch.no_grad()
    def _apply_updates(self, grads, it: int) -> None:
        """Per layer: gradient normalization, LR schedule, learning rule,
        bias-LR override, then params -= update.  The params are updated
        in place (JAX builds new arrays), which saves one copy of them."""
        for i in range(len(self.layers)):
            if grads[i] and not self.frozen[i]:
                self._update_layer(i, grads[i], it)

    @torch.no_grad()
    def _update_layer(self, i: int, gi: dict, it: int,
                      bias_lr: bool = True) -> None:
        """Layer ``i``'s update from its gradients, in place: gradient
        normalization, LR schedule, learning rule and, unless ``bias_lr``
        is off (a pretrain step, as JAX's), the bias-LR override."""
        g = self.conf.global_conf
        layer = self.layers[i]
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
        if bias_lr and blr is not None and blr != (layer.learning_rate
                                                   or g.learning_rate):
            # rescale the bias update (exact for rules linear in lr)
            scale = blr / base if base else 1.0
            upd = {k: (v * scale if k in BIAS_KEYS else v)
                   for k, v in upd.items()}
        for k, u in upd.items():
            self.net_params[i][k].sub_(u)

    # ---- layerwise pretraining ----
    def pretrain(self, data, epochs: int = 1) -> "MultiLayerNetwork":
        """Pretrain every layer whose ``is_pretrain_layer()`` holds, in
        order (ref: MultiLayerNetwork.pretrain :1010-1024)."""
        for i, layer in enumerate(self.layers):
            if layer.is_pretrain_layer():
                self.pretrain_layer(i, data, epochs=epochs)
        return self

    def pretrain_layer(self, layer_idx: int, data, epochs: int = 1
                       ) -> "MultiLayerNetwork":
        """Unsupervised fit of layer ``layer_idx`` on the activations of the
        layers below (ref: MultiLayerNetwork.pretrainLayer :197; JAX
        :899-975): one step a batch (``data`` an array, a DataSet or an
        iterator; only its features are read), each advancing
        ``iteration`` and calling the listeners."""
        if not self.layers[layer_idx].is_pretrain_layer():
            return self
        if self.net_params is None:
            self.init()
        it = as_iterator(data)
        for _ in range(epochs):
            it.reset()
            while it.has_next():
                self._pretrain_step(layer_idx, it.next().features)
        return self

    def _layer_input(self, layer_idx: int, x) -> torch.Tensor:
        """The input of layer ``layer_idx``: the layers below in inference
        mode, with their preprocessors and this layer's, no autograd."""
        with torch.no_grad():
            x, m = self._as_input(x), None
            if layer_idx:
                x, _, m = self._forward(self.net_params, self.net_state, x,
                                        stop=layer_idx)
            if layer_idx in self.conf.preprocessors:
                x, m = self.conf.preprocessors[layer_idx](x, m)
        return x

    def _pretrain_step(self, layer_idx: int, x, noise=None) -> None:
        """One pretrain step of layer ``layer_idx`` on features ``x``: its
        ``pretrain_loss`` (on ``noise``, else noise drawn from the
        network's device generator) plus its l1/l2, negated unless
        minimizing; autograd of that for this layer's params alone, then
        its normalization, LR schedule and updater in place."""
        if self.opt_states is None:
            self.opt_states = self._init_opt_states()
        self._score, grads = pretrain_gradients(
            self, self.layers[layer_idx], self.net_params[layer_idx],
            self._layer_input(layer_idx, x), noise)
        self._update_layer(layer_idx, grads, self.iteration, bias_lr=False)
        self.iteration += 1
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration)

    # ---- external gradients ----
    def backprop_gradient(self, x, epsilon, mask=None, train: bool = False):
        """Param gradients and dL/dx for an external error ``epsilon`` =
        dL/d(output) (ref: MLN backpropGradient, ComputationGraph
        calcBackpropGradients :1421; JAX :1327-1377) -> (grads like
        ``net_params``, dx; None for integer inputs).  The forward is
        ``output()``'s, cast through the precision policy, so gradients
        come back float32.  ``train=True`` runs the training forward with
        fresh dropout seed words from the network's generator and keeps
        its new states (batch norm's statistics); ``train=False`` leaves
        ``net_state`` as it is."""
        if self.net_params is None:
            self.init()
        policy = self._policy()
        params = [{k: v.detach().requires_grad_() for k, v in lp.items()}
                  for lp in self.net_params]
        xin = self._as_input(x)
        if torch.is_floating_point(xin):
            xin = xin.detach().requires_grad_()
        seeds = self._draw_seeds().tolist() if train else None
        with torch.enable_grad():
            pc, xc, mc = policy.cast_to_compute(
                (params, xin, self._as_mask(mask)))
            out, new_states, _ = self._forward(pc, self.net_state, xc, mc,
                                               train, seeds)
            eps = torch.as_tensor(epsilon).to(device=out.device,
                                              dtype=out.dtype)
            leaves = [v for lp in params for v in lp.values()]
            if xin.requires_grad:
                leaves.append(xin)
            flat = iter(grads_or_zeros(out, leaves, eps))
        grads = [{k: next(flat) for k in lp} for lp in params]
        dx = next(flat, None)
        if train:
            self.net_state = _detach(policy.cast_to_param(new_states))
            self.rnn_clear_previous_state()
        return grads, dx

    def apply_gradients(self, grads) -> "MultiLayerNetwork":
        """Apply external per-layer gradients through the updaters (JAX
        :1379-1412): the l1/l2 gradient is added, the sum negated under
        ``minimize=False``, then each layer's normalization, LR schedule,
        learning rule and bias LR, frozen layers skipped; ``iteration``
        advances.  Callers pass plain dL/dparam."""
        if self.net_params is None:
            self.init()
        if self.opt_states is None:
            self.opt_states = self._init_opt_states()
        reg = reg_gradients(self._reg_penalty, self.net_params)
        sign = 1.0 if self.conf.global_conf.minimize else -1.0
        total = [{k: sign * (grad_like(gl[k], r) + r)
                  for k, r in rl.items() if k in gl}
                 for gl, rl in zip(grads, reg)]
        self._apply_updates(total, self.iteration)
        self.iteration += 1
        return self

    def score(self, dataset: Optional[DataSet] = None) -> float:
        """The loss on a DataSet (inference forward, l1/l2 included), or
        the score of the last training step (ref: MultiLayerNetwork.score)."""
        if dataset is None:
            return float(self._score)
        g = self.conf.global_conf
        dataset, bucket = self._maybe_bucket_train(dataset)
        self.compile_telemetry.record(
            "score", (dataset.features, dataset.labels,
                      dataset.features_mask, dataset.labels_mask),
            bucket=bucket)
        with torch.inference_mode():
            preout, _, m, feats = self._inference_preout(
                dataset.features, dataset.features_mask)
            lm = (self._as_mask(dataset.labels_mask)
                  if dataset.labels_mask is not None else
                  m if m is not None and m.ndim == preout.ndim - 1 else None)
            per_ex = self._per_example_loss(
                self.net_params, self._as_float(dataset.labels), preout,
                feats, lm)
            score = per_ex.mean() if g.mini_batch else per_ex.sum()
            return float(score + self._reg_penalty(self.net_params))

    def score_examples(self, data, add_regularization_terms: bool = False
                       ) -> np.ndarray:
        """Per-example scores WITHOUT minibatch averaging (ref:
        MultiLayerNetwork.scoreExamples :1884 iterator, :1901 DataSet):
        the output layer's loss of each example from an inference forward;
        ``add_regularization_terms`` adds the net's l1/l2 penalty to every
        example's score.  Takes a DataSet or an iterator; returns a 1-D
        array over all examples.  Under ``shape_bucketing`` a batch is
        padded with unscaled masks and the padded rows' scores dropped."""
        if self.net_params is None:
            self.init()
        batches = [data] if isinstance(data, DataSet) else data
        g = self.conf.global_conf
        bucket_ok = (g.shape_bucketing and
                     bucketing.pad_supported(self, require_mean=False))
        out = []
        with torch.inference_mode():
            for ds in batches:
                n, bucket = ds.num_examples(), None
                if bucket_ok:
                    ds, bucket = bucketing.bucket_train_dataset(
                        ds, g, scale_loss=False)
                self.compile_telemetry.record(
                    "score_examples", (ds.features, ds.labels,
                                       ds.features_mask, ds.labels_mask),
                    bucket=bucket)
                preout, _, m, feats = self._inference_preout(
                    ds.features, ds.features_mask)
                lm = (self._as_mask(ds.labels_mask)
                      if ds.labels_mask is not None else
                      m if m is not None and m.ndim == preout.ndim - 1
                      else None)
                per = self._per_example_loss(
                    self.net_params, self._as_float(ds.labels), preout,
                    feats, lm)
                if add_regularization_terms:
                    per = per + self._reg_penalty(self.net_params)
                out.append(per.cpu().numpy()[:n])
        return np.concatenate(out)

    def _inference_preout(self, features, features_mask):
        """The inference forward to the output layer's pre-activation,
        under the precision policy -> (preout and features in the
        accumulation dtype, new states, mask)."""
        policy = self._policy()
        pc, xc, mc = policy.cast_to_compute(
            (self.net_params, self._as_input(features),
             self._as_mask(features_mask)))
        preout, states, m, feats = self._forward_to_preout(
            pc, self.net_state, xc, mc, False)
        return (policy.cast_to_accum(preout), states, m,
                policy.cast_to_accum(feats))

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
        at a time it equals :meth:`output` on the whole sequence.  One call
        of :meth:`_rnn_step_raw`, the carried step the serving decode pool
        runs too."""
        if self.net_params is None:
            self.init()
        out, carries = self._rnn_step_raw(
            self.net_params, self.net_state,
            [s.get("rnn_state") for s in self.net_state],
            self._as_input(x), self._as_mask(mask))
        self._merge_rnn_state([{} if c is None else {"rnn_state": c}
                               for c in carries])
        return out

    def _rnn_step_raw(self, params, base_state, carries, x, mask=None):
        """The carried decode step (JAX :1198-1235), shared by
        :meth:`rnn_time_step` and ``server/decode.DecodePool``:
        ``(params, base_state, carries, x, mask) -> (out, new_carries)``,
        ``carries`` one entry per layer (None for a layer that carries
        nothing, or for a fresh stream).  The carries and inputs take the
        compute dtype; the output and the new carries come back in the
        param dtype.  The forward runs under ``kv_decode_scope``, so an
        attention layer decodes against its KV ring (or the paged arena
        under ``parallel/sequence.paged_scope``)."""
        policy = self._policy()
        state = []
        for s, c in zip(base_state, carries):
            s = {k: v for k, v in s.items() if k != "rnn_state"}
            if c is not None:
                s["rnn_state"] = policy.cast_to_compute(c)
            state.append(s)
        with torch.no_grad(), seq_ops.kv_decode_scope():
            pc, xc, mc = policy.cast_to_compute((params, x, mask))
            out, new_states, _ = self._forward(pc, state, xc, mc,
                                               stateful_rnn=True)
        new_carries = [policy.cast_to_param(ns["rnn_state"])
                       if isinstance(ns, dict) and "rnn_state" in ns
                       else None for ns in new_states]
        return policy.cast_to_param(out), new_carries

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

    def rnn_carry_template(self, n: int, feature_tail=None,
                           dtype: torch.dtype = torch.float32) -> list:
        """Zero carries for ``n`` streams, one entry per layer (None for a
        layer that carries nothing), of the structure ``rnn_time_step``
        stores (JAX :1237-1263).  The shapes come from the step's forward
        over ``meta`` tensors: nothing runs on the device, and any layer
        that returns an ``rnn_state`` takes part.  ``feature_tail`` is the
        per-example input shape (``(T, C)``), by default one step of the
        configuration's recurrent input type."""
        if self.net_params is None:
            self.init()
        if feature_tail is None:
            it = self._input_type_chain_start()
            if it.kind != "rnn":
                raise ValueError(
                    "rnn_carry_template needs a recurrent input type "
                    "(or an explicit feature_tail=)")
            feature_tail = (1, it.size)
        x = torch.empty((int(n),) + tuple(int(d) for d in feature_tail),
                        dtype=dtype, device="meta")
        _, carries = self._rnn_step_raw(
            to_meta(self.net_params), to_meta(self.net_state),
            [None] * len(self.layers), x)
        return [None if c is None else _zeros_tree(c, self.device)
                for c in carries]

    def rnn_activate_using_stored_state(self, x, training: bool = False,
                                        store_last_for_tbptt: bool = False
                                        ) -> List[torch.Tensor]:
        """Every layer's activation, computed from the stored RNN carries
        (ref: MultiLayerNetwork.rnnActivateUsingStoredState :1955; JAX
        :1303-1325); ``store_last_for_tbptt`` keeps the final carries.
        ``training`` runs the training forward with fresh dropout seed
        words from the network's generator."""
        if self.net_params is None:
            self.init()
        policy = self._policy()
        state = [{k: policy.cast_to_compute(v) if k == "rnn_state" else v
                  for k, v in s.items()} for s in self.net_state]
        acts: List[torch.Tensor] = []
        with torch.no_grad():
            pc, xc = policy.cast_to_compute((self.net_params,
                                             self._as_input(x)))
            _, new_states, _ = self._forward(
                pc, state, xc, None, training,
                self._draw_seeds().tolist() if training else None,
                stateful_rnn=True, acts=acts)
        if store_last_for_tbptt:
            self._merge_rnn_state(policy.cast_to_param(new_states))
        return policy.cast_to_param(acts)

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
