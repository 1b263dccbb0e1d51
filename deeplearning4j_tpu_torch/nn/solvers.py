"""The line-search optimizers — the port of
``deeplearning4j_tpu/nn/solvers.py``.

(ref: optimize/Solver.java:43, optimize/solvers/BaseOptimizer.java,
BackTrackLineSearch.java, ConjugateGradient.java, LBFGS.java,
LineGradientDescent.java; enum nn/api/OptimizationAlgorithm.java.)

Full-batch methods over the flat parameter vector (``net.params()`` /
``set_params``, in the zip's order).  The score and its gradient are the
network's own (the inference forward to the output layer's
pre-activation, the output loss, the mean or sum over the batch, l1/l2;
what ``net.score(dataset)`` reports), computed on the network's device
with autograd.  The search's scalars (slopes, step tests) are read on the
host, one read a trial point.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn import params as param_util


def _flat_objective(net, dataset) -> Tuple[Callable, Callable]:
    """-> (value(flat) -> score, vg(flat) -> (score, gradient)), both on
    the network's device, masks respected as in ``net.score``."""
    template = net.net_params
    g = net.conf.global_conf
    x = net._as_input(dataset.features)
    y = net._as_float(dataset.labels)
    fmask = net._as_mask(dataset.features_mask)
    lmask = net._as_mask(dataset.labels_mask)

    def score_of(params):
        preout, _, m, feats = net._forward_to_preout(
            params, net.net_state, x, fmask, False)
        lm = lmask if lmask is not None else (
            m if m is not None and m.ndim == preout.ndim - 1 else None)
        per_ex = net._per_example_loss(params, y, preout, feats, lm)
        score = per_ex.mean() if g.mini_batch else per_ex.sum()
        return score + net._reg_penalty(params)

    def value(flat):
        with torch.no_grad():
            return score_of(param_util.unflatten(flat, template))

    def vg(flat):
        flat = flat.detach().requires_grad_()
        with torch.enable_grad():
            s = score_of(param_util.unflatten(flat, template))
            grad, = torch.autograd.grad(s, flat)
        return s.detach(), grad

    return value, vg


class BackTrackLineSearch:
    """Armijo backtracking along a search direction
    (ref: BackTrackLineSearch.java — step max, step shrink, sufficient
    decrease c1)."""

    def __init__(self, c1: float = 1e-4, shrink: float = 0.5,
                 max_iterations: int = 20, initial_step: float = 1.0,
                 max_step: float = 100.0):
        self.c1 = c1
        self.shrink = shrink
        self.max_iterations = max_iterations
        self.initial_step = initial_step
        self.max_step = max_step

    def optimize(self, value_fn: Callable, vg: Callable, flat, score, grad,
                 direction):
        """-> (new flat, new score, new gradient, step taken); step 0 (no
        move) when no decrease is found.  A trial point costs a forward;
        the gradient is taken once, at the accepted point."""
        slope = float(torch.dot(grad, direction))
        if slope >= 0:  # not a descent direction: steepest descent
            direction = -grad
            slope = float(torch.dot(grad, direction))
        dnorm = float(torch.linalg.norm(direction))
        step = min(self.initial_step,
                   self.max_step / dnorm if dnorm > 0 else self.initial_step)
        for _ in range(self.max_iterations):
            cand = flat + step * direction
            s = value_fn(cand)
            if float(s) <= float(score) + self.c1 * step * slope:
                s, g = vg(cand)
                return cand, float(s), g, step
            step *= self.shrink
        return flat, float(score), grad, 0.0


class _BaseLineSearchOptimizer:
    """(ref: BaseOptimizer.java gradientAndScore loop)"""

    def __init__(self, max_iterations: int = 100, tolerance: float = 1e-5,
                 line_search: Optional[BackTrackLineSearch] = None):
        self.max_iterations = max_iterations
        self.tolerance = tolerance
        self.line_search = line_search or BackTrackLineSearch()
        self.score_history: List[float] = []

    def optimize(self, net, dataset) -> float:
        if net.net_params is None:
            net.init()
        value_fn, vg = _flat_objective(net, dataset)
        flat = net.params().detach()
        score, grad = vg(flat)
        score = float(score)
        state = self._init_state(flat, grad)
        for _ in range(self.max_iterations):
            direction, state = self._direction(flat, grad, state)
            flat_new, score_new, grad_new, step = self.line_search.optimize(
                value_fn, vg, flat, score, grad, direction)
            self.score_history.append(score_new)
            if step == 0.0 or abs(score - score_new) < self.tolerance:
                flat, score, grad = flat_new, score_new, grad_new
                break
            state = self._post_step(state, flat, flat_new, grad, grad_new)
            flat, score, grad = flat_new, score_new, grad_new
        net.set_params(flat)
        net._score = score
        return score

    # -- strategy hooks --
    def _init_state(self, flat, grad):
        return None

    def _direction(self, flat, grad, state):
        raise NotImplementedError

    def _post_step(self, state, flat_old, flat_new, grad_old, grad_new):
        return state


class LineGradientDescent(_BaseLineSearchOptimizer):
    """Steepest descent and a line search (ref: LineGradientDescent.java)."""

    def _direction(self, flat, grad, state):
        return -grad, state


class ConjugateGradient(_BaseLineSearchOptimizer):
    """Polak-Ribière nonlinear conjugate gradient, restarted when beta < 0
    (ref: ConjugateGradient.java)."""

    def _init_state(self, flat, grad):
        return {"prev_grad": grad, "prev_dir": -grad, "first": True}

    def _direction(self, flat, grad, state):
        if state["first"]:
            return -grad, dict(state, first=False)
        pg = state["prev_grad"]
        beta = float(torch.dot(grad, grad - pg)
                     / torch.clamp_min(torch.dot(pg, pg), 1e-20))
        beta = max(beta, 0.0)
        return -grad + beta * state["prev_dir"], state

    def _post_step(self, state, flat_old, flat_new, grad_old, grad_new):
        d = flat_new - flat_old
        dn = float(torch.linalg.norm(d))
        return {"prev_grad": grad_new,
                "prev_dir": d / dn if dn > 0 else -grad_new,
                "first": False}


class LBFGS(_BaseLineSearchOptimizer):
    """Limited-memory BFGS, two-loop recursion (ref: LBFGS.java)."""

    def __init__(self, max_iterations: int = 100, tolerance: float = 1e-5,
                 memory: int = 10,
                 line_search: Optional[BackTrackLineSearch] = None):
        super().__init__(max_iterations, tolerance, line_search)
        self.memory = memory

    def _init_state(self, flat, grad):
        return {"s": [], "y": []}

    def _direction(self, flat, grad, state):
        s_list, y_list = state["s"], state["y"]
        q = grad
        alphas = []
        for s, y in zip(reversed(s_list), reversed(y_list)):
            rho = 1.0 / float(torch.clamp_min(torch.dot(y, s), 1e-20))
            a = rho * float(torch.dot(s, q))
            alphas.append((a, rho, s, y))
            q = q - a * y
        if y_list:
            y, s = y_list[-1], s_list[-1]
            gamma = float(torch.dot(s, y)
                          / torch.clamp_min(torch.dot(y, y), 1e-20))
            q = gamma * q
        for a, rho, s, y in reversed(alphas):
            b = rho * float(torch.dot(y, q))
            q = q + (a - b) * s
        return -q, state

    def _post_step(self, state, flat_old, flat_new, grad_old, grad_new):
        s = flat_new - flat_old
        y = grad_new - grad_old
        if float(torch.dot(s, y)) > 1e-10:  # the curvature condition
            state["s"].append(s)
            state["y"].append(y)
            if len(state["s"]) > self.memory:
                state["s"].pop(0)
                state["y"].pop(0)
        return state


class StochasticGradientDescent:
    """The normal path: ``fit`` steps
    (ref: StochasticGradientDescent.java:53-75)."""

    def __init__(self, max_iterations: int = 1):
        self.max_iterations = max_iterations

    def optimize(self, net, dataset) -> float:
        for _ in range(self.max_iterations):
            net.fit(dataset)
        return float(net.score())


class Solver:
    """(ref: optimize/Solver.java — a ConvexOptimizer from the configured
    OptimizationAlgorithm)"""

    ALGOS = {
        "STOCHASTIC_GRADIENT_DESCENT": StochasticGradientDescent,
        "LINE_GRADIENT_DESCENT": LineGradientDescent,
        "CONJUGATE_GRADIENT": ConjugateGradient,
        "LBFGS": LBFGS,
    }

    def __init__(self, algorithm: str = "STOCHASTIC_GRADIENT_DESCENT",
                 **kwargs):
        key = algorithm.upper()
        if key not in self.ALGOS:
            raise ValueError(f"unknown optimization algorithm {algorithm!r}; "
                             f"one of {sorted(self.ALGOS)}")
        self.optimizer = self.ALGOS[key](**kwargs)

    def optimize(self, net, dataset) -> float:
        return self.optimizer.optimize(net, dataset)
