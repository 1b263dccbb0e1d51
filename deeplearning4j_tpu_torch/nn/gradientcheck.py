"""Numeric against analytic gradients — the port of
``deeplearning4j_tpu/nn/gradientcheck.py``.

(ref: gradientcheck/GradientCheckUtil.java:77 — each param perturbed by
±ε in double precision, the central difference against the analytic
gradient by relative error.)  The reference forces double precision
(GradientCheckUtil.java:87-92); here each check runs on a clone of the
network on the CPU in float64, so a network whose params live on the card
is checked there too, and the caller's network is left as it was.  The
analytic side is autograd of the training score: the forward in training
mode with fixed dropout seed words, the output loss (the centre-loss head
on its features), the mean or sum over the batch and l1/l2.  ``subset``
and ``seed`` pick the same params as the JAX package's checks (numpy's
``default_rng(seed)``, layer by layer in ``nn/params.PARAM_ORDER``).
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn import params as param_util


def _to64(tree):
    if isinstance(tree, dict):
        return {k: _to64(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to64(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().to("cpu")
        return (t.to(torch.float64) if torch.is_floating_point(t)
                else t).clone()
    return tree


def _as64(a):
    if a is None:
        return None
    return torch.as_tensor(np.asarray(a, dtype=np.float64)
                           if not isinstance(a, torch.Tensor)
                           else a.detach().to("cpu", torch.float64))


def _cpu_clone(net):
    """A copy of ``net`` on the CPU with float64 params and state."""
    clone = type(net)(copy.deepcopy(net.conf), device="cpu")
    clone.net_params = _to64(net.net_params)
    clone.net_state = _to64(net.net_state)
    return clone


def _step_seeds(n: int, seed: int):
    """Fixed dropout seed words for the checked forward."""
    return torch.randint(0, 1 << 32, (n, 2), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(seed)
                         ).tolist()


def _fd_check_one(arr, analytic, eval_with, epsilon, max_rel_error,
                  min_abs_error, subset, nprng):
    """Central differences of one param tensor.  ``eval_with(new_arr)``
    gives the scalar loss with the tensor replaced by ``new_arr``.
    -> ([(flat index, analytic, numeric, relative error), ...] failures,
    params checked)."""
    shape = tuple(arr.shape)
    flat = np.array(arr, dtype=np.float64).reshape(-1).copy()
    an = np.asarray(analytic, dtype=np.float64).reshape(-1)
    n = flat.size
    idxs = (np.arange(n) if subset is None or n <= subset
            else nprng.choice(n, subset, replace=False))
    failures = []
    for i in idxs:
        orig = flat[i]
        flat[i] = orig + epsilon
        plus = eval_with(flat.reshape(shape))
        flat[i] = orig - epsilon
        minus = eval_with(flat.reshape(shape))
        flat[i] = orig
        numeric = (plus - minus) / (2 * epsilon)
        a = an[i]
        denom = max(abs(a), abs(numeric))
        rel = abs(a - numeric) / denom if denom > 0 else 0.0
        if rel > max_rel_error and abs(a - numeric) > min_abs_error:
            failures.append((int(i), float(a), numeric, rel))
    return failures, len(idxs)


def _run_checks(entries, score, params, epsilon, max_rel_error,
                min_abs_error, subset, seed, replace):
    """Autograd of ``score(params)`` against central differences for each
    float param of each entry (``entries``: (key, label) pairs in
    order).  ``replace(params, key, k, tensor)`` gives the params with one
    tensor replaced -> (params checked, failures)."""
    leaves = {(e, k): v.requires_grad_()
              for e, _ in entries for k, v in params[e].items()
              if torch.is_floating_point(v)}
    with torch.enable_grad():
        analytic = dict(zip(leaves, torch.autograd.grad(
            score(params), list(leaves.values()), allow_unused=True)))
    nprng = np.random.default_rng(seed)
    total, failures = 0, []
    for e, name in entries:
        lp = params[e]
        for k in param_util.ordered_keys(lp):
            if (e, k) not in leaves:
                continue
            a = analytic[(e, k)]
            a = torch.zeros_like(lp[k]) if a is None else a

            def eval_with(arr, e=e, k=k):
                with torch.no_grad():
                    return float(score(replace(params, e, k,
                                               torch.from_numpy(arr))))

            fails, checked = _fd_check_one(
                lp[k].detach().numpy(), a.detach().numpy(), eval_with,
                epsilon, max_rel_error, min_abs_error, subset, nprng)
            total += checked
            failures.extend((f"{name} {k}", i, an, num, rel)
                            for i, an, num, rel in fails)
    return total, failures


def _report(what, total, failures, print_results):
    if print_results or failures:
        print(f"{what}: {total} params checked, {len(failures)} failures")
        for label, i, a, num, rel in failures[:20]:
            print(f"  {label}[{i}]: analytic={a:.3e} numeric={num:.3e} "
                  f"rel={rel:.3e}")
    return not failures


def check_gradients(net, x, y, *, epsilon: float = 1e-6,
                    max_rel_error: float = 1e-3, min_abs_error: float = 1e-8,
                    fmask=None, lmask=None, subset: Optional[int] = 128,
                    seed: int = 0, print_results: bool = False) -> bool:
    """A MultiLayerNetwork's training-score gradient against central
    differences, param by param (ref: GradientCheckUtil.checkGradients).
    ``subset``: at most that many randomly chosen scalars a param tensor
    (None: every one).  True when every checked param's relative error is
    within bounds."""
    if net.net_params is None:
        net.init()
    clone = _cpu_clone(net)
    g = clone.conf.global_conf
    x64, y64 = _as64(x), _as64(y)
    fm, lm_given = _as64(fmask), _as64(lmask)
    seeds = _step_seeds(len(clone.layers), seed)

    def score(p):
        preout, _, m, feats = clone._forward_to_preout(
            p, clone.net_state, x64, fm, True, seeds)
        lm = lm_given if lm_given is not None else (
            m if m is not None and m.ndim == preout.ndim - 1 else None)
        per_ex = clone._per_example_loss(p, y64, preout, feats, lm)
        s = per_ex.mean() if g.mini_batch else per_ex.sum()
        return s + clone._reg_penalty(p)

    def replace(params, li, k, t):
        return [({**lp, k: t} if i == li else lp)
                for i, lp in enumerate(params)]

    params = [dict(lp) for lp in clone.net_params]
    total, failures = _run_checks(
        [(i, f"layer {i}") for i in range(len(params))], score, params,
        epsilon, max_rel_error, min_abs_error, subset, seed, replace)
    return _report("Gradient check", total, failures, print_results)


def check_computation_graph_gradients(
        graph, inputs, labels, *, epsilon: float = 1e-6,
        max_rel_error: float = 1e-3, min_abs_error: float = 1e-8,
        fmasks=None, lmasks=None, subset: Optional[int] = 64,
        seed: int = 0, print_results: bool = False) -> bool:
    """The ComputationGraph form of :func:`check_gradients`: the training
    score as the graph's step assembles it (the outputs' losses, masks,
    l1/l2), every vertex's params in topological order (ref:
    GradientCheckUtil.checkGradients(ComputationGraph...):238).
    ``inputs`` / ``labels`` are ordered as ``network_inputs`` /
    ``network_outputs``."""
    if graph.net_params is None:
        graph.init()
    clone = _cpu_clone(graph)
    xs = {n: _as64(x) for n, x in zip(clone.conf.network_inputs, inputs)}
    ys = [_as64(y) for y in labels]
    masks = ({n: _as64(m) for n, m in zip(clone.conf.network_inputs, fmasks)}
             if fmasks is not None else {})
    lms = None if lmasks is None else [_as64(m) for m in lmasks]
    seeds = _step_seeds(len(clone.order), seed)

    def score(p):
        _, preouts, _, out_masks = clone._forward_all(
            p, clone.net_state, xs, masks, True, seeds,
            preout_for=list(clone.output_layers))
        return clone._score_of(p, preouts, out_masks, ys, lms)

    def replace(params, name, k, t):
        return {**params, name: {**params[name], k: t}}

    params = {n: dict(lp) for n, lp in clone.net_params.items()}
    total, failures = _run_checks(
        [(n, f"vertex {n}") for n in clone.order if params[n]], score,
        params, epsilon, max_rel_error, min_abs_error, subset, seed,
        replace)
    return _report("CG gradient check", total, failures, print_results)


def check_pretrain_gradients(layer, params, x, *, epsilon: float = 1e-6,
                             max_rel_error: float = 1e-3,
                             min_abs_error: float = 1e-8,
                             subset: Optional[int] = 64,
                             seed: int = 0) -> bool:
    """A pretrain layer's unsupervised loss against central differences
    (ref: VaeGradientCheckTests.java).  The noise (corruption mask, ε,
    Gibbs draws) is drawn once from a generator seeded with ``seed`` and
    held for the analytic and the numeric side alike."""
    p64 = {"p": _to64(dict(params))}
    x64 = _as64(x)
    noise = layer.draw_noise(x64, torch.Generator().manual_seed(seed))

    def score(p):
        return layer.pretrain_loss(p["p"], x64, noise)

    def replace(params, _, k, t):
        return {"p": {**params["p"], k: t}}

    total, failures = _run_checks([("p", "")], score, p64, epsilon,
                                  max_rel_error, min_abs_error, subset, seed,
                                  replace)
    return _report("Pretrain gradient check", total, failures, False)
