"""Weights, layer state and updater state carried across from the JAX package.

The port keeps the JAX package's layouts (OIHW conv weights, dense ``W``
as [n_in, n_out]) and its updater-state structure (per layer ``()`` or a
dict of dicts of arrays), so a JAX ``MultiLayerNetwork``'s ``net_params``
and ``opt_states`` map onto the port's one to one, and so does its
``net_state`` (batch norm's running ``mean`` / ``var``, RNN carries).  A
JAX ``ComputationGraph`` keeps the same per-layer entries in dicts keyed
by vertex name, and each function here takes that form too, returning a
dict.  The caller hands them over as numpy arrays (``np.asarray`` of each
leaf); this module imports nothing of JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops.platform import DeviceLike, resolve_device


def _per_entry(entries, fn):
    """``fn`` over each layer's (or vertex's) entry, keeping a list a
    list and a dict keyed by vertex name a dict."""
    if isinstance(entries, Mapping):
        return {name: fn(e) for name, e in entries.items()}
    return [fn(e) for e in entries]


def params_from_jax(jax_params, device: DeviceLike = None):
    """Per-layer (list) or per-vertex (dict) param dicts of numpy arrays →
    float32 tensors on ``device`` (the CUDA device unless the caller asks
    for the CPU)."""
    dev = resolve_device(device)
    return _per_entry(jax_params, lambda lp: {
        k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
        for k, v in lp.items()})


def _to_torch(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v, dev) for v in tree)
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(dev)


def opt_states_from_jax(jax_opt_states, device: DeviceLike = None):
    """Per-layer (list) or per-vertex (dict) updater states of numpy
    arrays (``()`` for SGD, else e.g. ``{"m": {"W": ..., "b": ...}, "v":
    {...}}``) → the same structure of float32 tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(jax_opt_states, Mapping):
        return _per_entry(jax_opt_states, lambda o: _to_torch(o, dev))
    return _to_torch(list(jax_opt_states), dev)


def state_from_jax(jax_state, device: DeviceLike = None):
    """Per-layer (list) or per-vertex (dict) state dicts of numpy arrays
    (a JAX ``net_state``: batch norm's ``{"mean", "var"}``, ``{}`` for
    stateless layers) → the same structure of float32 tensors on
    ``device``."""
    dev = resolve_device(device)
    return _per_entry(jax_state, lambda s: _to_torch(dict(s), dev))
