"""Reconstruction distributions p(x|z) of the variational autoencoder — the
port of ``deeplearning4j_tpu/ops/vae_distributions.py``.

(ref: nn/conf/layers/variational/{GaussianReconstructionDistribution,
BernoulliReconstructionDistribution,ExponentialReconstructionDistribution,
CompositeReconstructionDistribution,LossFunctionWrapper}.java.)

Each distribution is described by a serializable dict ``{"type": ...,
"activation": ...}``, the JAX package's, and gives:
  - ``n_dist_params(n_features)`` — width of the decoder's output head;
  - ``neg_log_prob(x, preout)`` — per-example negative log likelihood [N];
  - ``sample(preout, generator)`` / ``mean(preout)`` — generation, the
    sample's randomness drawn from an explicit ``torch.Generator`` on the
    tensor's device.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from deeplearning4j_tpu_torch.ops import activations as act_ops
from deeplearning4j_tpu_torch.ops import losses as loss_ops

_LOG2PI = math.log(2.0 * math.pi)


def _act(name):
    return act_ops.get(name or "identity")


def _uniform(shape, like, generator: Optional[torch.Generator], low=0.0):
    u = torch.rand(shape, dtype=like.dtype, device=like.device,
                   generator=generator)
    return u if low == 0.0 else low + (1.0 - low) * u


class _Gaussian:
    """N(mean, sigma^2), the decoder emitting [mean | log(sigma^2)]
    (ref: GaussianReconstructionDistribution.java)."""

    def __init__(self, spec):
        self.activation = spec.get("activation", "identity")

    def n_dist_params(self, n):
        return 2 * n

    def neg_log_prob(self, x, preout):
        n = x.shape[-1]
        mean = _act(self.activation)(preout[..., :n])
        log_var = preout[..., n:]
        var = torch.exp(log_var)
        lp = -0.5 * (_LOG2PI + log_var + (x - mean) ** 2 / var)
        return -torch.sum(lp, dim=-1)

    def sample(self, preout, generator=None):
        n = preout.shape[-1] // 2
        mean = _act(self.activation)(preout[..., :n])
        std = torch.exp(0.5 * preout[..., n:])
        return mean + std * torch.randn(mean.shape, dtype=mean.dtype,
                                        device=mean.device,
                                        generator=generator)

    def mean(self, preout):
        n = preout.shape[-1] // 2
        return _act(self.activation)(preout[..., :n])


class _Bernoulli:
    """(ref: BernoulliReconstructionDistribution.java — sigmoid default)"""

    def __init__(self, spec):
        self.activation = spec.get("activation", "sigmoid")

    def n_dist_params(self, n):
        return n

    def neg_log_prob(self, x, preout):
        p = torch.clamp(_act(self.activation)(preout), 1e-7, 1.0 - 1e-7)
        lp = x * torch.log(p) + (1.0 - x) * torch.log1p(-p)
        return -torch.sum(lp, dim=-1)

    def sample(self, preout, generator=None):
        p = _act(self.activation)(preout)
        return (_uniform(p.shape, p, generator) < p).to(preout.dtype)

    def mean(self, preout):
        return _act(self.activation)(preout)


class _Exponential:
    """Exp(lambda) parameterized via gamma = log(lambda)
    (ref: ExponentialReconstructionDistribution.java)."""

    def __init__(self, spec):
        self.activation = spec.get("activation", "identity")

    def n_dist_params(self, n):
        return n

    def neg_log_prob(self, x, preout):
        gamma = _act(self.activation)(preout)
        lp = gamma - torch.exp(gamma) * x
        return -torch.sum(lp, dim=-1)

    def sample(self, preout, generator=None):
        lam = torch.exp(_act(self.activation)(preout))
        u = _uniform(preout.shape, preout, generator, low=1e-7)
        return -torch.log(u) / lam

    def mean(self, preout):
        return 1.0 / torch.exp(_act(self.activation)(preout))


class _LossWrapper:
    """A plain loss function as a pseudo-distribution
    (ref: LossFunctionWrapper.java — the VAE degenerates to a deep AE)."""

    def __init__(self, spec):
        self.activation = spec.get("activation", "identity")
        self.loss = spec.get("loss", "mse")

    def n_dist_params(self, n):
        return n

    def neg_log_prob(self, x, preout):
        return loss_ops.get(self.loss)(x, preout, self.activation, None)

    def sample(self, preout, generator=None):
        return _act(self.activation)(preout)

    def mean(self, preout):
        return _act(self.activation)(preout)


class _Composite:
    """Different distributions over ranges of feature columns
    (ref: CompositeReconstructionDistribution.java).  ``sample`` draws
    the parts in order from the one generator."""

    def __init__(self, spec):
        self.parts = [(int(p["size"]), make(p["dist"])) for p in spec["parts"]]

    def n_dist_params(self, n):
        return sum(d.n_dist_params(s) for s, d in self.parts)

    def neg_log_prob(self, x, preout):
        total, xo, po = 0.0, 0, 0
        for s, d in self.parts:
            w = d.n_dist_params(s)
            total = total + d.neg_log_prob(x[..., xo:xo + s],
                                           preout[..., po:po + w])
            xo, po = xo + s, po + w
        return total

    def _by_part(self, preout, fn):
        outs, po = [], 0
        for s, d in self.parts:
            w = d.n_dist_params(s)
            outs.append(fn(d, preout[..., po:po + w]))
            po += w
        return torch.cat(outs, dim=-1)

    def sample(self, preout, generator=None):
        return self._by_part(preout, lambda d, p: d.sample(p, generator))

    def mean(self, preout):
        return self._by_part(preout, lambda d, p: d.mean(p))


_TYPES = {
    "gaussian": _Gaussian,
    "bernoulli": _Bernoulli,
    "exponential": _Exponential,
    "loss": _LossWrapper,
    "composite": _Composite,
}


def make(spec: Optional[Dict]):
    """A distribution from its serializable spec dict (Gaussian when
    ``spec`` is None)."""
    if spec is None:
        spec = {"type": "gaussian"}
    return _TYPES[spec.get("type", "gaussian")](spec)
