"""Normalization ops — the port of ``deeplearning4j_tpu/ops/normalization.py``.

``batch_norm_train`` (:17) / ``batch_norm_infer`` (:41) and
``local_response_norm`` (:57) are plain torch ops, as they are plain XLA
in the JAX package; running statistics are carried in and out, not
mutated.  Training-mode batch norm normalizes with the BIASED batch
variance and updates the running statistics with the same biased
variance, ``decay * running + (1 - decay) * batch``: ``F.batch_norm``
would update them with the unbiased variance and ``momentum = 1 -
decay``, so it is not used.  Under the bf16 policy both take the JAX
package's bf16 branches: the statistics are computed and carried in f32
(bf16 means and variances over N*H*W elements lose too many bits) and the
normalized value is cast back to the activation's dtype before gamma and
beta, so a bf16 network stays bf16 through batch norm, in training and in
inference alike, and the next conv gets bf16.

``dropout`` is the fallback of ``ops/helpers.dropout`` for tensors under
the threshold-dropout kernel's gate.  Its mask is a Bernoulli draw from
an explicit ``torch.Generator``; the JAX version draws from
``jax.random.bernoulli``, so the two give the same keep distribution but
different masks.
"""

from __future__ import annotations

import torch


def _stat_axes(x):
    """Feature axis 1: statistics over axis 0 for [N, C], over (0, 2, 3)
    for NCHW; the broadcast shape of a per-feature vector."""
    if x.ndim == 2:
        return (0,), (1, -1)
    return (0, 2, 3), (1, -1, 1, 1)


def _stat_dtype(x):
    """The dtype batch statistics are kept in: f32 for a bf16 x."""
    return torch.float32 if x.dtype == torch.bfloat16 else x.dtype


def batch_norm_train(x, gamma, beta, running_mean, running_var, *,
                     decay: float = 0.9, eps: float = 1e-5):
    """Training-mode batch norm over feature axis 1 (dense [N, C] or conv
    NCHW) -> (y, new running mean, new running var).  ``decay`` is the
    reference's BatchNormalization.decay (momentum on the running
    statistics).  A bf16 x gets f32 statistics and a bf16 y (:17-38)."""
    axes, shape = _stat_axes(x)
    xs = x.to(_stat_dtype(x))
    mean = torch.mean(xs, dim=axes)
    var = torch.var(xs, dim=axes, unbiased=False)
    xn = ((xs - mean.reshape(shape))
          / torch.sqrt(var.reshape(shape) + eps)).to(x.dtype)
    y = gamma.reshape(shape) * xn + beta.reshape(shape)
    new_mean = decay * running_mean.to(xs.dtype) + (1 - decay) * mean
    new_var = decay * running_var.to(xs.dtype) + (1 - decay) * var
    return y, new_mean, new_var


def batch_norm_infer(x, gamma, beta, running_mean, running_var, *,
                     eps: float = 1e-5):
    """Inference-mode batch norm from the carried running statistics.  A
    bf16 x is normalized in f32 (the statistics' dtype) and cast back, so
    the output keeps x's dtype (:41-54)."""
    _, shape = _stat_axes(x)
    sd = _stat_dtype(x)
    xn = ((x.to(sd) - running_mean.to(sd).reshape(shape))
          / torch.sqrt(running_var.to(sd).reshape(shape) + eps)).to(x.dtype)
    return gamma.reshape(shape) * xn + beta.reshape(shape)


def local_response_norm(x, *, k: float = 2.0, n: int = 5,
                        alpha: float = 1e-4, beta: float = 0.75):
    """Across-channel LRN on NCHW (AlexNet-style): x over (k + alpha * the
    sum of squares over a window of ``n`` channels centred on each)^beta,
    with no ``alpha / n`` scaling (ref: LocalResponseNormalization.java:69,
    defaults k=2, n=5, alpha=1e-4, beta=0.75)."""
    half = n // 2
    padded = torch.nn.functional.pad(torch.square(x),
                                     (0, 0, 0, 0, half, half))
    C = x.shape[1]
    summed = padded[:, 0:C]
    for i in range(1, n):
        summed = summed + padded[:, i:i + C]
    return x / torch.pow(k + alpha * summed, beta)


def dropout(x, rate: float, generator: torch.Generator):
    """Inverted dropout; ``rate`` is the RETAIN probability (DL4J's dropOut
    value, ref: util/Dropout.java).  Kept elements are divided by it."""
    if rate >= 1.0 or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < rate
    return torch.where(keep, x / rate, torch.zeros_like(x))
