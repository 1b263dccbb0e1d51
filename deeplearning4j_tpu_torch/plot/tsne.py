"""t-SNE embedding (ref: plot/BarnesHutTsne.java:65; plot/Tsne.java) — the
port of ``deeplearning4j_tpu/plot/tsne.py``.

  - ``theta == 0`` (exact): the perplexity bisection (:func:`_x2p_dense`,
    50 steps over all rows at once), the symmetrised P and the
    momentum-and-gains loop on KL(P||Q) (:func:`_tsne_exact`) run as
    dense [N, N] torch ops on the card (CUDA unless the caller passes
    ``device="cpu"``), where JAX jits them.  Products are full f32 (TF32
    off, JAX's ``Precision.HIGHEST``) and d² is clamped at 0: a slightly
    negative d² would turn 1/(1+d²) into inf.  One [N, N] f32 is 0.4 GB at
    N = 10,000; the loop holds a few.  No Pallas kernel lies on this path.
  - ``theta > 0``: Barnes-Hut (VPTree kNN sparse affinities + SpTree force
    approximation) on the host in numpy, as in the JAX package, with its
    ``default_rng(seed)``.

Reference hyperparameter defaults preserved: learning rate 500, momentum
0.5 → 0.8 at iteration 100 (switchMomentumIteration), early exaggeration
until iteration 250 (stopLyingIteration).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.clustering.kmeans import full_f32_matmul
from deeplearning4j_tpu_torch.clustering.sptree import SpTree
from deeplearning4j_tpu_torch.clustering.vptree import VPTree
from deeplearning4j_tpu_torch.ops.platform import DeviceLike, resolve_device


# ---------------------------------------------------------------------------
# Exact path on the card
# ---------------------------------------------------------------------------

def _sq_dists(x: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances [N, N], clamped at 0, full f32."""
    s = (x * x).sum(1)
    with full_f32_matmul():
        xxt = x @ x.T
    return torch.clamp_min(s[:, None] - 2.0 * xxt + s[None, :], 0.0)


def _x2p_dense(x: torch.Tensor, perplexity: float, tol: float = 1e-5,
               iters: int = 50) -> torch.Tensor:
    """Per-point conditional gaussians with bisection on beta so every
    row hits the target perplexity (ref: Tsne x2p /
    computeGaussianPerplexity).  All N bisections advance together for
    ``iters`` steps; ``tol`` is kept for the JAX signature, which does not
    read it either.  d² is formed in float64 and rounded to ``x``'s
    dtype: the one-GEMM form cancels whatever the points share, so on
    vectors that point one way (a trained word-vector table) float32 d²
    carries rounding that exp(-beta d²) makes ~1e-4 of an entry, and the
    card and the CPU round it differently; formed in float64, P keeps to
    the float64 P on either (``tests/test_torch_clustering.py``).  JAX's
    forms d² in float32."""
    return _p_from_sq_dists(_sq_dists(x.double()).to(x.dtype), perplexity,
                            iters)


def _p_from_sq_dists(d: torch.Tensor, perplexity: float,
                     iters: int = 50) -> torch.Tensor:
    """:func:`_x2p_dense`'s bisection on the squared distances ``d``."""
    n = d.shape[0]
    log_u = float(np.log(perplexity))
    eye = torch.eye(n, dtype=torch.bool, device=d.device)

    def entropy_and_p(beta):
        p = torch.where(eye, 0.0, torch.exp(-d * beta[:, None]))
        sum_p = torch.clamp_min(p.sum(1), 1e-30)
        h = torch.log(sum_p) + beta * (d * p).sum(1) / sum_p
        return h, p / sum_p[:, None]

    beta = torch.ones((n,), dtype=d.dtype, device=d.device)
    lo = torch.full((n,), -float("inf"), dtype=d.dtype, device=d.device)
    hi = torch.full((n,), float("inf"), dtype=d.dtype, device=d.device)
    for _ in range(iters):
        h, _ = entropy_and_p(beta)
        too_high = h > log_u          # entropy too high -> beta too small
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2.0,
                           torch.where(torch.isinf(lo), beta / 2.0,
                                       (lo + hi) / 2.0))
    _, p = entropy_and_p(beta)
    return p


def _tsne_exact(p_sym: torch.Tensor, y0: torch.Tensor, n_iter: int,
                lr: float, switch_momentum_iter: int, stop_lying_iter: int,
                exaggeration: float) -> torch.Tensor:
    """Momentum+gains gradient descent on KL(P||Q) from ``y0``
    (ref: Tsne.gradient / BarnesHutTsne.gradient)."""
    n = y0.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=y0.device)
    y = y0
    inc = torch.zeros_like(y0)
    gains = torch.ones_like(y0)
    for it in range(n_iter):
        num = torch.where(eye, 0.0, 1.0 / (1.0 + _sq_dists(y)))
        q = torch.clamp_min(num / num.sum(), 1e-12)
        exag = exaggeration if it < stop_lying_iter else 1.0
        pq = (p_sym * exag - q) * num                       # [N, N]
        with full_f32_matmul():
            grad = 4.0 * ((torch.diag(pq.sum(1)) - pq) @ y)
        gains = torch.where(torch.sign(grad) != torch.sign(inc),
                            gains + 0.2, gains * 0.8)
        gains = torch.clamp_min(gains, 0.01)
        momentum = 0.5 if it < switch_momentum_iter else 0.8
        inc = momentum * inc - lr * gains * grad
        y = y + inc
        y = y - y.mean(0, keepdim=True)
    return y


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

class BarnesHutTsne:
    """(ref: plot/BarnesHutTsne.java — implements Model; here a plain
    estimator with fit/fit_transform).  ``device`` is where the exact
    path runs (CUDA unless the caller passes ``"cpu"``)."""

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 theta: float = 0.0, learning_rate: float = 500.0,
                 n_iter: int = 1000, stop_lying_iteration: int = 250,
                 switch_momentum_iteration: int = 100,
                 exaggeration: float = 12.0, seed: int = 0,
                 device: DeviceLike = None):
        self.n_components = n_components
        self.perplexity = perplexity
        self.theta = theta
        self.learning_rate = learning_rate
        self.n_iter = n_iter
        self.stop_lying_iteration = stop_lying_iteration
        self.switch_momentum_iteration = switch_momentum_iteration
        self.exaggeration = exaggeration
        self.seed = seed
        self.device = device
        self.Y_: Optional[np.ndarray] = None

    # -- exact path --------------------------------------------------------
    def _fit_exact(self, x):
        dev = resolve_device(self.device)
        xt = torch.as_tensor(x, dtype=torch.float32).to(dev)
        p = _x2p_dense(xt, float(self.perplexity))
        p = (p + p.T) / (2.0 * x.shape[0])
        p = torch.clamp_min(p, 1e-12)
        gen = torch.Generator(device=dev).manual_seed(int(self.seed))
        y0 = 1e-4 * torch.randn((x.shape[0], self.n_components),
                                generator=gen, device=dev)
        y = _tsne_exact(p, y0, self.n_iter, self.learning_rate,
                        self.switch_momentum_iteration,
                        self.stop_lying_iteration, self.exaggeration)
        return y.cpu().numpy()

    # -- Barnes-Hut path ---------------------------------------------------
    def _knn_p(self, x):
        """Sparse kNN affinities via VPTree
        (ref: BarnesHutTsne.computeGaussianPerplexity(…, k=3*perplexity))."""
        n = x.shape[0]
        k = min(n - 1, int(3 * self.perplexity))
        tree = VPTree(x, "euclidean", seed=self.seed)
        rows = np.zeros((n, k), np.int32)
        vals = np.zeros((n, k), np.float64)
        log_u = np.log(self.perplexity)
        for i in range(n):
            idxs, dists = tree.knn(x[i], k + 1)
            pairs_id = [(j, dj) for j, dj in zip(idxs, dists) if j != i][:k]
            idxs = [j for j, _ in pairs_id]
            d2 = np.array([dj for _, dj in pairs_id]) ** 2
            beta, lo, hi = 1.0, -np.inf, np.inf
            for _ in range(50):
                pr = np.exp(-d2 * beta)
                sum_p = max(pr.sum(), 1e-30)
                h = np.log(sum_p) + beta * float((d2 * pr).sum()) / sum_p
                if abs(h - log_u) < 1e-5:
                    break
                if h > log_u:
                    lo = beta
                    beta = beta * 2.0 if np.isinf(hi) else (lo + hi) / 2.0
                else:
                    hi = beta
                    beta = beta / 2.0 if np.isinf(lo) else (lo + hi) / 2.0
            pr = np.exp(-d2 * beta)
            pr /= max(pr.sum(), 1e-30)
            rows[i, :len(idxs)] = idxs
            vals[i, :len(idxs)] = pr
        return rows, vals

    def _fit_bh(self, x):
        n = x.shape[0]
        rows, vals = self._knn_p(x)
        # symmetrize into a dict-of-pairs sparse P
        p = {}
        for i in range(n):
            for j, v in zip(rows[i], vals[i]):
                if v <= 0:
                    continue
                key = (min(i, int(j)), max(i, int(j)))
                p[key] = p.get(key, 0.0) + v
        total = sum(p.values())
        pairs = np.array(list(p.keys()), np.int32)
        pvals = np.array(list(p.values())) / max(total, 1e-30)

        rng = np.random.default_rng(self.seed)
        y = 1e-4 * rng.standard_normal((n, self.n_components))
        inc = np.zeros_like(y)
        gains = np.ones_like(y)
        for it in range(self.n_iter):
            exag = self.exaggeration if it < self.stop_lying_iteration else 1.0
            # attractive forces from sparse P
            diff = y[pairs[:, 0]] - y[pairs[:, 1]]
            q_num = 1.0 / (1.0 + np.sum(diff * diff, axis=1))
            f = (exag * pvals * q_num)[:, None] * diff
            attr = np.zeros_like(y)
            np.add.at(attr, pairs[:, 0], f)
            np.add.at(attr, pairs[:, 1], -f)
            # repulsive via SpTree
            tree = SpTree.build(y)
            rep = np.zeros_like(y)
            sum_q = 0.0
            for i in range(n):
                neg, sq = tree.compute_non_edge_forces(y[i], self.theta)
                rep[i] = neg
                sum_q += sq
            grad = attr - rep / max(sum_q, 1e-30)
            gains = np.where(np.sign(grad) != np.sign(inc),
                             gains + 0.2, gains * 0.8)
            gains = np.maximum(gains, 0.01)
            momentum = 0.5 if it < self.switch_momentum_iteration else 0.8
            inc = momentum * inc - self.learning_rate * gains * grad
            y = y + inc
            y = y - y.mean(0, keepdims=True)
        return y

    # -- API ---------------------------------------------------------------
    def fit(self, x) -> "BarnesHutTsne":
        x = np.asarray(x, np.float32)
        self.Y_ = self._fit_exact(x) if self.theta == 0.0 else self._fit_bh(x)
        return self

    def fit_transform(self, x) -> np.ndarray:
        return self.fit(x).Y_

    def save_as_file(self, labels, path: str) -> None:
        """CSV "y1,y2,...,label" per point (ref: BarnesHutTsne.saveAsFile)."""
        with open(path, "w") as f:
            for row, lab in zip(self.Y_, labels):
                f.write(",".join(f"{v:.6f}" for v in row) + f",{lab}\n")


class Tsne(BarnesHutTsne):
    """Exact-only alias (ref: plot/Tsne.java)."""

    def __init__(self, **kw):
        kw["theta"] = 0.0
        super().__init__(**kw)
