"""Dense dropout — the part of ``deeplearning4j_tpu/ops/normalization.py``
the training slice needs (``dropout``, :71).

It is the fallback of ``ops/helpers.dropout`` for tensors under the
threshold-dropout kernel's gate.  Its mask is a Bernoulli draw from an
explicit ``torch.Generator``; the JAX version draws from
``jax.random.bernoulli``, so the two give the same keep distribution but
different masks.
"""

from __future__ import annotations

import torch


def dropout(x, rate: float, generator: torch.Generator):
    """Inverted dropout; ``rate`` is the RETAIN probability (DL4J's dropOut
    value, ref: util/Dropout.java).  Kept elements are divided by it."""
    if rate >= 1.0 or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < rate
    return torch.where(keep, x / rate, torch.zeros_like(x))
