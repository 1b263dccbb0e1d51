"""Loss functions — the port of ``deeplearning4j_tpu/ops/losses.py``.

Each loss takes ``(labels, preoutput, activation_name, mask)`` and returns
per-example scores of shape [N].  Working on pre-activations lets the
softmax + cross-entropy and sigmoid + binary-cross-entropy pairs use their
numerically stable forms; the gradient comes from autograd of the whole
step.  Above the xent gate (``ops/helpers.softmax_xent_wanted``) ``mcxent``
runs the fused softmax + cross-entropy of ``ops/cuda_kernels`` instead.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from deeplearning4j_tpu_torch.ops import activations

EPS = 1e-7

LossFn = Callable[..., torch.Tensor]


def _activate(preout, activation: str):
    return activations.get(activation)(preout)


def _reduce_features(per_elem, mask: Optional[torch.Tensor]):
    """Sum per-element losses over all non-batch axes → per-example [N]."""
    if mask is not None:
        per_elem = per_elem * mask
    dims = tuple(range(1, per_elem.ndim))
    return per_elem.sum(dim=dims) if dims else per_elem


def mse(labels, preout, activation="identity", mask=None):
    out = _activate(preout, activation)
    return _reduce_features(torch.square(out - labels), mask) / \
        labels.shape[-1]


def l2(labels, preout, activation="identity", mask=None):
    out = _activate(preout, activation)
    return _reduce_features(torch.square(out - labels), mask)


def l1(labels, preout, activation="identity", mask=None):
    out = _activate(preout, activation)
    return _reduce_features(torch.abs(out - labels), mask)


def mae(labels, preout, activation="identity", mask=None):
    out = _activate(preout, activation)
    return _reduce_features(torch.abs(out - labels), mask) / labels.shape[-1]


def xent(labels, preout, activation="sigmoid", mask=None):
    """Binary cross-entropy; the stable form when activation is sigmoid."""
    if activation == "sigmoid":
        # -[y log σ(x) + (1-y) log(1-σ(x))] = max(x,0) - xy + log(1+e^-|x|)
        per = torch.clamp(preout, min=0) - preout * labels + \
            torch.log1p(torch.exp(-torch.abs(preout)))
    else:
        out = torch.clamp(_activate(preout, activation), EPS, 1.0 - EPS)
        per = -(labels * torch.log(out) + (1.0 - labels) * torch.log(1.0 - out))
    return _reduce_features(per, mask)


def _fused_xent_wanted(labels, preout, mask) -> bool:
    """Gate of the fused softmax + cross-entropy: shape and mask legality
    here (row-level masks only — a per-class mask needs the elementwise
    form); the size decision in ``ops/helpers.softmax_xent_wanted``."""
    if preout.ndim < 2 or preout.shape != labels.shape:
        return False
    if mask is not None and mask.ndim == preout.ndim \
            and mask.shape[-1] == preout.shape[-1] and preout.shape[-1] != 1:
        return False  # a genuine per-class mask
    from deeplearning4j_tpu_torch.ops import helpers
    V = preout.shape[-1]
    n_rows = 1
    for d in preout.shape[:-1]:
        n_rows *= d
    return helpers.softmax_xent_wanted(n_rows, V, preout.dtype)


def mcxent(labels, preout, activation="softmax", mask=None):
    """Multi-class cross-entropy; the stable form when activation is
    softmax, and above the size gate the fused softmax + CE + gradient."""
    if activation == "softmax":
        if _fused_xent_wanted(labels, preout, mask):
            from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
            V = preout.shape[-1]
            rows = ck.softmax_xent_rows(
                preout.reshape(-1, V), labels.reshape(-1, V)
            ).reshape(labels.shape[:-1])
            if mask is not None:
                m = mask
                if m.ndim == rows.ndim + 1 and m.shape[-1] == 1:
                    m = m[..., 0]
                rows = rows * m
            dims = tuple(range(1, rows.ndim))
            return rows.sum(dim=dims) if dims else rows
        logz = torch.logsumexp(preout, dim=-1, keepdim=True)
        per = -labels * (preout - logz)
    else:
        out = torch.clamp(_activate(preout, activation), EPS, 1.0 - EPS)
        per = -labels * torch.log(out)
    return _reduce_features(per, mask)


def negativeloglikelihood(labels, preout, activation="softmax", mask=None):
    # NLL == MCXENT when paired with a softmax output, as in the reference
    return mcxent(labels, preout, activation, mask)


def cosine_proximity(labels, preout, activation="identity", mask=None):
    out = _activate(preout, activation)
    if mask is not None:
        out = out * mask
        labels = labels * mask
    dot = (labels * out).sum(dim=-1)
    nl = torch.linalg.vector_norm(labels, dim=-1)
    no = torch.linalg.vector_norm(out, dim=-1)
    per = -dot / torch.clamp(nl * no, min=EPS)
    dims = tuple(range(1, per.ndim))
    return per.sum(dim=dims) if dims else per


def hinge(labels, preout, activation="identity", mask=None):
    # labels expected in {-1, +1}
    out = _activate(preout, activation)
    return _reduce_features(torch.clamp(1.0 - labels * out, min=0.0), mask)


def squared_hinge(labels, preout, activation="identity", mask=None):
    out = _activate(preout, activation)
    return _reduce_features(
        torch.square(torch.clamp(1.0 - labels * out, min=0.0)), mask)


def kl_divergence(labels, preout, activation="softmax", mask=None):
    out = torch.clamp(_activate(preout, activation), EPS, 1.0)
    lab = torch.clamp(labels, EPS, 1.0)
    return _reduce_features(labels * (torch.log(lab) - torch.log(out)), mask)


def mape(labels, preout, activation="identity", mask=None):
    out = _activate(preout, activation)
    per = 100.0 * torch.abs((labels - out) /
                            torch.clamp(torch.abs(labels), min=EPS))
    return _reduce_features(per, mask) / labels.shape[-1]


def msle(labels, preout, activation="identity", mask=None):
    out = _activate(preout, activation)
    per = torch.square(torch.log1p(torch.clamp(out, min=-1 + EPS))
                       - torch.log1p(torch.clamp(labels, min=-1 + EPS)))
    return _reduce_features(per, mask) / labels.shape[-1]


def poisson(labels, preout, activation="identity", mask=None):
    out = torch.clamp(_activate(preout, activation), min=EPS)
    return _reduce_features(out - labels * torch.log(out), mask)


_REGISTRY: Dict[str, LossFn] = {
    "mse": mse,
    "squared_loss": mse,
    "l1": l1,
    "l2": l2,
    "mae": mae,
    "mean_absolute_error": mae,
    "xent": xent,
    "mcxent": mcxent,
    "negativeloglikelihood": negativeloglikelihood,
    "nll": negativeloglikelihood,
    "cosine_proximity": cosine_proximity,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
    "kl_divergence": kl_divergence,
    "reconstruction_crossentropy": xent,
    "mean_absolute_percentage_error": mape,
    "mape": mape,
    "mean_squared_logarithmic_error": msle,
    "msle": msle,
    "poisson": poisson,
}


def get(name: str) -> LossFn:
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"Unknown loss '{name}'. Known: {sorted(_REGISTRY)}") from None


def register(name: str, fn: LossFn) -> None:
    _REGISTRY[name.lower()] = fn


def unregister(name: str) -> None:
    """Remove a user-registered loss (no-op when absent)."""
    _REGISTRY.pop(name.lower(), None)


def names() -> List[str]:
    return sorted(_REGISTRY)
