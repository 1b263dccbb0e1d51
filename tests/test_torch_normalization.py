"""The port's batch norm and LRN (``ops/normalization.py``) held against
the JAX package's on the CPU.

Inputs are drawn with numpy and go through both functions.  Tolerances,
float32 on both sides: outputs and running statistics rtol 1e-5, atol
1e-6 (the batch mean and variance sum up to 2,048 elements in another
order); gradients rtol 1e-4, atol 1e-6 (a second such sum over the
upstream gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import normalization as jax_norm
from deeplearning4j_tpu_torch.ops import normalization as norm

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL = 1e-4

SHAPES = {"dense": (16, 12), "nchw": (8, 6, 5, 7)}


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[1]
    x = (rng.normal(size=shape) * 2.0 + 0.5).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.normal(size=c).astype(np.float32)
    mean = rng.normal(size=c).astype(np.float32)
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    return x, gamma, beta, mean, var


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


@pytest.mark.parametrize("decay,eps", [(0.9, 1e-5), (0.99, 1e-3)])
@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_batch_norm_train_matches_jax(kind, decay, eps):
    x, gamma, beta, mean, var = _inputs(SHAPES[kind], seed=1)
    y, m, v = norm.batch_norm_train(*_t(x, gamma, beta, mean, var),
                                    decay=decay, eps=eps)
    jy, jm, jv = jax_norm.batch_norm_train(
        *map(jnp.asarray, (x, gamma, beta, mean, var)), decay=decay, eps=eps)
    for got, want in ((y, jy), (m, jm), (v, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_batch_norm_infer_matches_jax(kind):
    x, gamma, beta, mean, var = _inputs(SHAPES[kind], seed=2)
    y = norm.batch_norm_infer(*_t(x, gamma, beta, mean, var), eps=1e-3)
    jy = jax_norm.batch_norm_infer(
        *map(jnp.asarray, (x, gamma, beta, mean, var)), eps=1e-3)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_batch_norm_gradients_match_jax(kind, train):
    """d(sum(y * r)) / d(x, gamma, beta) in both packages."""
    x, gamma, beta, mean, var = _inputs(SHAPES[kind], seed=3)
    r = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)

    def jloss(x, g, b):
        if train:
            y = jax_norm.batch_norm_train(x, g, b, jnp.asarray(mean),
                                          jnp.asarray(var))[0]
        else:
            y = jax_norm.batch_norm_infer(x, g, b, jnp.asarray(mean),
                                          jnp.asarray(var))
        return jnp.sum(y * jnp.asarray(r))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    leaves = [t.requires_grad_() for t in _t(x, gamma, beta)]
    tm, tv = _t(mean, var)
    if train:
        y = norm.batch_norm_train(*leaves, tm, tv)[0]
    else:
        y = norm.batch_norm_infer(*leaves, tm, tv)
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum(), leaves)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=GRAD_RTOL, atol=ATOL)


def test_running_variance_is_the_biased_batch_variance():
    """A batch of 4 rows: the unbiased variance is 4/3 of the biased one,
    so a port that updated the running variance with it (``torch.var``'s
    default, or ``F.batch_norm``'s running update) would miss JAX's by
    far more than the tolerance.  Both alternatives are computed here and
    shown to miss."""
    x, gamma, beta, mean, var = _inputs((4, 5), seed=5)
    decay = 0.9
    _, _, v = norm.batch_norm_train(*_t(x, gamma, beta, mean, var),
                                    decay=decay)
    _, _, jv = jax_norm.batch_norm_train(
        *map(jnp.asarray, (x, gamma, beta, mean, var)), decay=decay)
    want = np.asarray(jv)
    np.testing.assert_allclose(v.numpy(), want, rtol=RTOL, atol=ATOL)
    unbiased = decay * var + (1 - decay) * x.var(axis=0, ddof=1)
    assert not np.allclose(unbiased, want, rtol=1e-3, atol=1e-4)
    rm, rv = _t(mean, var)
    torch.nn.functional.batch_norm(torch.from_numpy(x), rm, rv,
                                   training=True, momentum=1 - decay)
    assert not np.allclose(rv.numpy(), want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("params", [{}, {"k": 1.0, "n": 3, "alpha": 0.5,
                                         "beta": 0.5},
                                    {"k": 2.0, "n": 7, "alpha": 1e-2,
                                     "beta": 0.75}])
def test_local_response_norm_matches_jax(params):
    """Output and input gradient; n = 7 is wider than the 6 channels."""
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(3, 6, 4, 5)) * 3).astype(np.float32)
    r = rng.normal(size=x.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    y = norm.local_response_norm(xt, **params)
    (g,) = torch.autograd.grad((y * torch.from_numpy(r)).sum(), [xt])
    jy, jvjp = jax.vjp(lambda a: jax_norm.local_response_norm(a, **params),
                       jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jvjp(jnp.asarray(r))[0]),
                               rtol=GRAD_RTOL, atol=ATOL)
