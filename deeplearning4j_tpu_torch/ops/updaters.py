"""Learning rules (updaters), LR schedules and gradient normalization —
the port of ``deeplearning4j_tpu/ops/updaters.py``.

Each rule works on one layer's dict of gradient tensors:
``init(params) -> state`` and ``apply(grads, state, lr, t) ->
(update, state)``, and the caller does ``params -= update``
(ref: nn/updater/UpdaterBlock.java, enum nn/conf/Updater.java: SGD,
ADAM, ADAMAX, ADADELTA, NESTEROVS, ADAGRAD, RMSPROP, NONE).  The state
has the JAX package's structure (``{"v": {...}}``, ``{"m": ..., "v":
...}``, ``()`` for SGD), so ``updaterState.bin`` flattens alike in both.
LR schedules (ref: nn/conf/LearningRatePolicy.java) are computed in
float32 as the JAX step traces them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

Grads = Dict[str, torch.Tensor]


def _f32(v) -> torch.Tensor:
    return torch.tensor(float(v), dtype=torch.float32)


def schedule_lr(base_lr, policy: Optional[str], iteration, *,
                decay_rate=None, steps=None, power=None,
                schedule_map=None) -> float:
    """The effective LR at ``iteration`` (a float32 value): None / fixed,
    Exponential (lr·γ^it), Inverse (lr/(1+γ·it)^power), Poly
    (lr·(1−it/steps)^power), Sigmoid (lr/(1+exp(−γ·(it−steps)))), Step and
    TorchStep (lr·γ^floor(it/steps)), Schedule (piecewise constant map)."""
    it = _f32(iteration)
    if policy is None or policy.lower() in ("none", "fixed"):
        return float(_f32(base_lr))
    p = policy.lower()
    lr = _f32(base_lr)
    if p == "exponential":
        out = lr * torch.pow(_f32(decay_rate), it)
    elif p == "inverse":
        out = lr / torch.pow(1.0 + _f32(decay_rate) * it, _f32(power))
    elif p == "poly":
        out = lr * torch.pow(1.0 - it / torch.clamp(_f32(steps), min=1.0),
                             _f32(power))
    elif p == "sigmoid":
        out = lr / (1.0 + torch.exp(-_f32(decay_rate) * (it - _f32(steps))))
    elif p in ("step", "torchstep"):
        out = lr * torch.pow(_f32(decay_rate), torch.floor(it / _f32(steps)))
    elif p == "schedule":
        out = lr
        for k in sorted(schedule_map or {}, key=float):
            if float(it) >= float(k):
                out = _f32(schedule_map[k])
    else:
        raise ValueError(f"Unknown learning rate policy '{policy}'")
    return float(out)


@dataclasses.dataclass(frozen=True)
class Updater:
    """A learning rule over one layer's params."""

    name: str
    hyper: dict

    def init(self, params: Grads) -> Any:
        n = self.name

        def zeros():
            return {k: torch.zeros_like(v) for k, v in params.items()}
        if n in ("sgd", "none"):
            return ()
        if n == "nesterovs":
            return {"v": zeros()}
        if n in ("adagrad", "rmsprop"):
            return {"g2": zeros()}
        if n == "adadelta":
            return {"g2": zeros(), "dx2": zeros()}
        if n in ("adam", "adamax"):
            return {"m": zeros(), "v": zeros()}
        raise ValueError(f"Unknown updater '{n}'")

    def apply(self, grads: Grads, state, lr: float, t: int):
        """Return (update, new_state); the caller does params -= update."""
        n = self.name
        h = self.hyper
        if n == "none":
            return {k: torch.zeros_like(g) for k, g in grads.items()}, state
        if n == "sgd":
            return {k: lr * g for k, g in grads.items()}, state
        if n == "nesterovs":
            # v_new = mu·v − lr·g; update = mu·v_prev − (1+mu)·v_new, applied
            # as params -= update (nd4j Nesterovs.getGradient)
            mu = h.get("momentum", 0.9)
            v = state["v"]
            v_new = {k: mu * v[k] - lr * g for k, g in grads.items()}
            upd = {k: mu * v[k] - (1 + mu) * v_new[k] for k in grads}
            return upd, {"v": v_new}
        if n == "adagrad":
            eps = h.get("epsilon", 1e-6)
            g2 = {k: state["g2"][k] + g * g for k, g in grads.items()}
            upd = {k: lr * g / (torch.sqrt(g2[k]) + eps)
                   for k, g in grads.items()}
            return upd, {"g2": g2}
        if n == "rmsprop":
            decay = h.get("rmsdecay", 0.95)
            eps = h.get("epsilon", 1e-8)
            g2 = {k: decay * state["g2"][k] + (1 - decay) * g * g
                  for k, g in grads.items()}
            upd = {k: lr * g / torch.sqrt(g2[k] + eps)
                   for k, g in grads.items()}
            return upd, {"g2": g2}
        if n == "adadelta":
            rho = h.get("rho", 0.95)
            eps = h.get("epsilon", 1e-6)
            g2 = {k: rho * state["g2"][k] + (1 - rho) * g * g
                  for k, g in grads.items()}
            upd = {k: g * torch.sqrt(state["dx2"][k] + eps) /
                   torch.sqrt(g2[k] + eps) for k, g in grads.items()}
            dx2 = {k: rho * state["dx2"][k] + (1 - rho) * u * u
                   for k, u in upd.items()}
            return upd, {"g2": g2, "dx2": dx2}
        if n in ("adam", "adamax"):
            b1 = h.get("beta1", 0.9)
            b2 = h.get("beta2", 0.999)
            eps = h.get("epsilon", 1e-8)
            tf = _f32(t) + 1.0
            m = {k: b1 * state["m"][k] + (1 - b1) * g
                 for k, g in grads.items()}
            if n == "adam":
                v = {k: b2 * state["v"][k] + (1 - b2) * g * g
                     for k, g in grads.items()}
                # the bias-corrected step size, in float32 as JAX traces it
                alpha = float(_f32(lr) * torch.sqrt(1 - torch.pow(_f32(b2), tf))
                              / (1 - torch.pow(_f32(b1), tf)))
                upd = {k: alpha * m[k] / (torch.sqrt(v[k]) + eps) for k in m}
            else:
                v = {k: torch.maximum(b2 * state["v"][k], torch.abs(g))
                     for k, g in grads.items()}
                alpha = float(_f32(lr) / (1 - torch.pow(_f32(b1), tf)))
                upd = {k: alpha * m[k] / (v[k] + eps) for k in m}
            return upd, {"m": m, "v": v}
        raise ValueError(f"Unknown updater '{n}'")


def make(name: str, **hyper) -> Updater:
    return Updater(name=name.lower(), hyper=hyper)


# --------------------------------------------------------------------------
# Gradient normalization (GradientNormalization.java)
# --------------------------------------------------------------------------

def _l2(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors)
                      + 1e-30)


def normalize_gradient(grads: Grads, mode: Optional[str],
                       threshold: float = 1.0) -> Grads:
    """The reference's gradient normalization of one layer's gradients:
    RenormalizeL2PerLayer, RenormalizeL2PerParamType,
    ClipElementWiseAbsoluteValue, ClipL2PerLayer, ClipL2PerParamType."""
    if mode is None or mode == "None":
        return grads
    m = mode.lower()
    if m == "renormalizel2perlayer":
        norm = _l2(grads.values())
        return {k: g / norm for k, g in grads.items()}
    if m == "renormalizel2perparamtype":
        return {k: g / _l2([g]) for k, g in grads.items()}
    if m == "clipelementwiseabsolutevalue":
        return {k: torch.clamp(g, -threshold, threshold)
                for k, g in grads.items()}
    if m == "clipl2perlayer":
        scale = torch.clamp(threshold / _l2(grads.values()), max=1.0)
        return {k: g * scale for k, g in grads.items()}
    if m == "clipl2perparamtype":
        return {k: g * torch.clamp(threshold / _l2([g]), max=1.0)
                for k, g in grads.items()}
    raise ValueError(f"Unknown gradient normalization '{mode}'")
