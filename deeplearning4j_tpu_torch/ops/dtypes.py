"""Precision policy — the port of ``deeplearning4j_tpu/ops/dtypes.py``.

The reference trains in float32 (and double for gradient checks, ref:
gradientcheck/GradientCheckUtil.java:87-92).  The bf16 tier runs
activations and matmul or conv inputs in bfloat16 with float32
accumulation, over float32 master params and updater state; on an H100
that is the tensor cores' 989 TFLOP/s bf16 rate.  Both engines resolve a
configuration's ``precision`` through :func:`resolve`, once per network
and again only when the configuration's field changes, and cast at the
points the JAX package casts: params and inputs to the compute dtype
inside the differentiated function (so autograd through the cast gives
float32 master gradients), the output layer's pre-activation to the
accumulation dtype before the loss, new layer states and outputs back to
the param dtype.

``None`` and ``"auto"`` resolve to :data:`FLOAT32` here: the JAX package's
auto policy is bf16 only on a TPU (:109-118), and the H100 is not one, so
a configuration that names no precision runs as it always has.  The
JAX package's ``DL4J_PRECISION*`` switches are not ported, as its
``DL4J_PALLAS*`` switches are not (``ops/helpers.py``); the selection of
a mixed tier is metered in ``dl4j_precision_selected_total{tier,on}``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """Mixed-precision policy applied by the training engines.

    ``cast_to_compute`` only casts float32 leaves: float64 (gradient
    checks) and integer leaves (embedding indices) pass through, as in the
    JAX package (:35-46).  The casts walk nested dicts, lists and tuples
    (named tuples kept) and leave ``None`` and non-tensors alone."""

    param_dtype: torch.dtype = torch.float32    # master copy of params
    compute_dtype: torch.dtype = torch.float32  # activations, matmul inputs
    accum_dtype: torch.dtype = torch.float32    # accumulation, the loss

    @property
    def is_mixed(self) -> bool:
        return self.compute_dtype != self.param_dtype

    def cast_to_compute(self, tree):
        if not self.is_mixed:
            return tree
        return _map_tensors(tree, lambda x: x.to(self.compute_dtype)
                            if x.dtype == torch.float32 else x)

    def cast_to_param(self, tree):
        """Upcast compute-dtype leaves back to the master dtype (carried
        state: BN running statistics, RNN carries; a network's output)."""
        if not self.is_mixed:
            return tree
        return _map_tensors(tree, lambda x: x.to(self.param_dtype)
                            if x.dtype == self.compute_dtype else x)

    def cast_to_accum(self, x):
        if isinstance(x, torch.Tensor) and x.dtype != self.accum_dtype \
                and x.is_floating_point() \
                and torch.finfo(x.dtype).bits <= \
                torch.finfo(self.accum_dtype).bits:
            return x.to(self.accum_dtype)
        return x


def _map_tensors(tree, fn):
    """``tree`` with ``fn`` applied to every tensor leaf."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tensors(v, fn) for v in tree]
    if isinstance(tree, tuple):
        items = [_map_tensors(v, fn) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            tuple(items)
    return tree


FLOAT32 = Policy()
# bfloat16 compute with f32 accumulation over f32 masters
BF16 = Policy(param_dtype=torch.float32, compute_dtype=torch.bfloat16,
              accum_dtype=torch.float32)
# float64 compute over f32 master storage: numeric-check precision
FLOAT64 = Policy(param_dtype=torch.float32, compute_dtype=torch.float64,
                 accum_dtype=torch.float64)

_NAMED = {
    "float32": FLOAT32, "f32": FLOAT32, "fp32": FLOAT32, "float": FLOAT32,
    "bfloat16": BF16, "bf16": BF16, "mixed_bfloat16": BF16,
    # the JAX package maps the half names to bf16 (same width, wider
    # exponent), and the port keeps its names
    "half": BF16, "float16": BF16, "f16": BF16,
    "float64": FLOAT64, "f64": FLOAT64, "double": FLOAT64,
}


def accum_dtype_for(dtype: torch.dtype) -> torch.dtype:
    """Output dtype of a matmul or conv with inputs of ``dtype`` (:86-97):
    bf16 inputs keep a bf16 result (the products accumulate in f32 inside
    the kernel or library call and are rounded once); wider floats keep
    their own width, at least f32."""
    if dtype == torch.bfloat16:
        return dtype
    return torch.promote_types(dtype, torch.float32)


# None = auto, which is FLOAT32 on this port's devices
_default_policy: Optional[Policy] = None


def set_default_policy(policy: Optional[Policy]) -> None:
    """Override the ambient policy (None restores the auto selection)."""
    global _default_policy
    _default_policy = policy


def default_policy() -> Policy:
    return _default_policy if _default_policy is not None else FLOAT32


def policy_name(policy: Policy) -> str:
    """The compute dtype's name: ``float32``, ``bfloat16``, ``float64``."""
    return str(policy.compute_dtype).replace("torch.", "")


def resolve(name: Optional[str]) -> Policy:
    """Map a configuration string ('float32' | 'bfloat16' | 'float64' |
    None or 'auto') to a Policy and meter a mixed tier's selection; the
    engines call this once per network (``Resolved``), as the JAX package
    resolves once when it builds a trace."""
    if name is None or name == "auto":
        policy = default_policy()
    else:
        try:
            policy = _NAMED[name.lower()]
        except KeyError:
            raise ValueError(f"Unknown precision '{name}'. "
                             f"Known: {sorted(_NAMED)} or 'auto'") from None
    if policy.is_mixed:
        _record_selection("bf16_train" if policy is BF16 else "f64_check")
    return policy


class Resolved:
    """A network's resolved policy: :func:`resolve` runs when the
    configuration's ``precision`` (or, for None and "auto", the ambient
    default) differs from the last one resolved, not at every call."""

    def __init__(self):
        self._key, self._policy = object(), None

    def __call__(self, name: Optional[str]) -> Policy:
        key = (name, _default_policy if name in (None, "auto") else None)
        if key != self._key:
            self._key, self._policy = key, resolve(name)
        return self._policy


def _record_selection(tier: str) -> None:
    """Meter a mixed tier's selection (the JAX package's
    ``dl4j_precision_selected_total{tier,on}``; the port has no switch
    that turns a tier off, so ``on`` is always "true")."""
    from deeplearning4j_tpu_torch import monitor
    monitor.get_registry().counter(
        "dl4j_precision_selected_total",
        "precision tier selections by the engines",
        labels=("tier", "on")).labels(tier=tier, on="true").inc()
