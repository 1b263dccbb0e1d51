"""Shape bucketing and signature telemetry — the port of
``deeplearning4j_tpu/ops/bucketing.py``.

* **Ladders** (:func:`bucket_size`, :func:`warmup_ladder`): the batch
  sizes a ragged stream is padded up to, powers of two unless the
  configuration names a ladder (``bucket_batch_sizes``,
  ``bucket_time_sizes``).  The micro-batcher pads a coalesced batch up to
  the next rung.
* **Training batches** (:func:`bucket_train_dataset`,
  :func:`bucket_train_multidataset`): rows padded with CYCLED real
  examples, the time axis of ``[N, T, C]`` sequences zero-padded with a
  features mask, and a labels mask scaled to ``target / n`` on the real
  rows and 0 on the padded ones (:func:`scaled_mask`), so the mean loss
  over the padded batch is the unpadded one for every loss linear in the
  mask (:func:`pad_supported` says when that holds).
* **Inference** (:func:`bucket_inference_features`,
  :func:`unpad_outputs`): zero rows and masked time steps, sliced back
  off the outputs.
* **Telemetry** (:class:`CompileTelemetry`): distinct input signatures per
  entry point, under the JAX package's metric names.

The primitives take numpy arrays or torch tensors (a staged batch stays on
its device).  The JAX package's ``maybe_enable_persistent_cache``
configures XLA's on-disk compile cache; eager PyTorch compiles nothing per
shape (the kernels are built once from ``csrc/``), so it has no
counterpart here.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# Losses where the labels mask does not scale the per-example loss
# linearly (cosine_proximity normalizes the masked vectors): exact
# pad-and-mask is impossible there.
MASK_NONLINEAR_LOSSES = frozenset({"cosine_proximity"})


def next_pow2(n: int) -> int:
    """Smallest power of two >= n."""
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def bucket_size(n: int, sizes: Optional[Sequence[int]] = None) -> int:
    """Smallest configured bucket >= n; powers of two when no ladder is
    configured, and past the ladder's top rung."""
    if sizes:
        for s in sorted(int(s) for s in sizes):
            if s >= n:
                return s
    return next_pow2(n)


def pow2_ladder(max_n: int) -> List[int]:
    """``[1, 2, 4, ..., next_pow2(max_n)]``."""
    top = next_pow2(max(1, int(max_n)))
    out, n = [], 1
    while n <= top:
        out.append(n)
        n <<= 1
    return out


def warmup_ladder(sizes: Optional[Sequence[int]] = None,
                  max_batch: int = 32) -> List[int]:
    """The bucket ladder a serving path warms: the configured ladder up
    to the rung a ``max_batch``-row batch lands on, else the power-of-two
    ladder up to ``max_batch``."""
    max_batch = max(1, int(max_batch))
    if sizes:
        ladder = sorted({int(s) for s in sizes})
        top = bucket_size(max_batch, ladder)
        out = [s for s in ladder if s < top]
        out.append(top)
        return out
    return pow2_ladder(max_batch)


def bucket_key(bucket) -> str:
    """Key of a bucket tuple: ``b64``, ``b64t32``, ``b64t32/16``
    (multi-input graphs)."""
    nb, tb = bucket
    if tb is None:
        return f"b{nb}"
    if isinstance(tb, tuple):
        ts = "/".join("-" if t is None else str(t) for t in tb)
        return f"b{nb}t{ts}"
    return f"b{nb}t{tb}"


# ---------------------------------------------------------------------------
# Pad/mask primitives (numpy arrays or torch tensors)
# ---------------------------------------------------------------------------
def _zeros(like, shape):
    """Zeros of ``shape`` in ``like``'s kind, dtype and device."""
    if isinstance(like, torch.Tensor):
        return torch.zeros(shape, dtype=like.dtype, device=like.device)
    return np.zeros(shape, np.asarray(like).dtype)


def cycle_rows(a, target: int):
    """Pad rows up to ``target`` by cycling REAL examples (not zeros:
    replicated real rows keep batch statistics, e.g. BatchNorm's,
    well-conditioned; their loss contribution is removed by the mask)."""
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
    if len(a) >= target:
        return a[:target]
    reps = -(-target // len(a))
    if isinstance(a, torch.Tensor):
        return torch.cat([a] * reps)[:target]
    return np.concatenate([a] * reps)[:target]


def scaled_mask(lm, y, n: int, target: int, scale: Optional[float] = None):
    """Labels mask over the PADDED batch making the step's
    ``mean(per_ex)`` over ``target`` rows equal the unpadded mean over
    ``n`` rows: valid rows carry ``target/n`` (losses are linear in the
    mask; see MASK_NONLINEAR_LOSSES), padded rows 0.  ``scale`` overrides
    the ``target/n`` factor (``1.0`` for per-example scoring)."""
    scale = np.float32(target / n if scale is None else scale)
    if lm is None:
        m = np.zeros((target,) + (1,) * (len(y.shape) - 1), np.float32)
        m[:n] = scale
    else:
        lm = _host(lm)
        m = np.zeros((target,) + lm.shape[1:], np.float32)
        m[:n] = lm * scale
    return m


def _host(a) -> np.ndarray:
    """A mask as a float32 numpy array (a small host copy)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def _pad_time(a, tb: int):
    """Zero-pad axis 1 (time) up to ``tb``."""
    if a.shape[1] >= tb:
        return a
    out = _zeros(a, (a.shape[0], tb) + tuple(a.shape[2:]))
    out[:, :a.shape[1]] = a
    return out


def pad_supported(model, require_mean: bool = True) -> bool:
    """Exact pad-and-mask needs (a) every output loss linear in the labels
    mask (a centre-loss head adds an unmasked centre term) and, for paths
    that reduce to a minibatch mean (``require_mean``), (b) mean loss
    reduction: the ``target/n`` rescale assumes division by the padded
    row count.  BatchNorm is allowed: cycled real rows keep the batch
    statistics well-conditioned, a documented approximation preferred
    over dropping examples."""
    if require_mean and not model.conf.global_conf.mini_batch:
        return False
    if type(model).__name__ == "ComputationGraph":
        outs = list(model.output_layers.values())
    else:
        outs = [model.layers[-1]]
    for lc in outs:
        if getattr(lc, "requires_features_for_score", False):
            return False
        if (getattr(lc, "loss", None) or "") in MASK_NONLINEAR_LOSSES:
            return False
    return True


# ---------------------------------------------------------------------------
# Training-batch bucketing
# ---------------------------------------------------------------------------
def _resolve_lm_base(lm, fm, y, t):
    """Labels-mask base for the synthesized scaled mask: an existing
    labels mask wins; a features mask becomes the base only when its
    shape matches the labels' time layout (the step resolves the
    propagated time mask that way); a 3-D label with a padded time axis
    needs an all-ones time base so the padded steps are excluded.
    Returns (base, ok)."""
    if lm is not None:
        return _host(lm), True
    if fm is not None:
        if len(fm.shape) == len(y.shape) - 1 and \
                tuple(fm.shape) == tuple(y.shape[:-1]):
            return _host(fm), True
        if len(y.shape) == 2:
            # a per-example mask suffices: the step resolves a [N, T] mask
            # against a 2-D preout to None, so no time weighting to match
            return None, True
        return None, False  # mask routing ambiguous: don't guess
    if t is not None and len(y.shape) == 3:
        return np.ones(tuple(y.shape[:-1]), np.float32), True
    return None, True


def bucket_train_dataset(ds, g, min_multiple: int = 1,
                         scale_loss: bool = True):
    """Pad a DataSet up to its (batch, time) bucket: rows are cycled real
    examples, the time axis is zero-padded, a features mask is made or
    extended for sequence data and the labels mask is the scaled mask
    making the padded mean loss equal the unpadded one.  ``min_multiple``
    lifts the batch bucket to a multiple.  ``scale_loss=False`` keeps the
    real rows' mask entries as they are (per-example scoring, where
    results are sliced back instead of averaged).

    Returns ``(padded_ds, bucket)``; ``bucket`` None means the batch could
    not be bucketed (ambiguous mask routing) and ``ds`` comes back as it
    was.  A batch already of its bucket's shape, with its masks, comes
    back as it is (the pipeline buckets before staging)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    f, y = ds.features, ds.labels
    n = int(f.shape[0])
    nb = bucket_size(n, g.bucket_batch_sizes)
    if min_multiple > 1:
        nb = -(-nb // min_multiple) * min_multiple
    t = int(f.shape[1]) if len(f.shape) == 3 else None
    tb = bucket_size(t, g.bucket_time_sizes) if t is not None else None
    fm, lm = ds.features_mask, ds.labels_mask
    if nb == n and (tb is None or tb == t) and lm is not None \
            and (t is None or fm is not None):
        return ds, (nb, tb)

    lm_base, ok = _resolve_lm_base(lm, fm, y, t)
    if not ok:
        return ds, None

    f_p = cycle_rows(f, nb)
    if tb is not None and tb != t:
        f_p = _pad_time(f_p, tb)
    y_p = cycle_rows(y, nb)
    if len(y.shape) == 3 and tb is not None and y.shape[1] == t and tb != t:
        y_p = _pad_time(y_p, tb)

    if t is not None:
        # sequence features always carry a mask once bucketed: a batch
        # landing exactly on a bucket has the padded ones' signature
        fm_arr = (_host(fm) if fm is not None
                  else np.ones((n, t), np.float32))
        fm_p = cycle_rows(fm_arr, nb)
        if tb != t:
            fm_p = _pad_time(fm_p, tb)
    else:
        fm_p = None if fm is None else cycle_rows(fm, nb)

    scale = None if scale_loss else 1.0
    if lm_base is None:
        lm_p = scaled_mask(None, y, n, nb, scale)
    else:
        base = np.zeros((nb,) + tuple(
            tb if (i == 1 and t is not None and s == t and tb != t) else s
            for i, s in enumerate(lm_base.shape))[1:], np.float32)
        sl = (slice(0, n),) + tuple(slice(0, s) for s in lm_base.shape[1:])
        base[sl] = lm_base * np.float32(nb / n if scale is None else scale)
        lm_p = base
    return DataSet(f_p, y_p, fm_p, lm_p), (nb, tb)


def bucket_train_multidataset(mds, g, min_multiple: int = 1,
                              scale_loss: bool = True):
    """The MultiDataSet (ComputationGraph) form of
    :func:`bucket_train_dataset`.  A features mask without any labels
    mask makes the routing of inputs to outputs ambiguous: the batch is
    refused (bucket None), not guessed.  Every 3-D entry gets its own
    time bucket."""
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet

    def _all_none(tup):
        return tup is None or all(m is None for m in tup)

    fms = mds.features_masks
    lms = mds.labels_masks
    if not _all_none(fms) and _all_none(lms):
        return mds, None
    n = mds.num_examples()
    nb = bucket_size(n, g.bucket_batch_sizes)
    if min_multiple > 1:
        nb = -(-nb // min_multiple) * min_multiple

    def t_of(a):
        return int(a.shape[1]) if len(a.shape) == 3 else None

    f_ts = [t_of(f) for f in mds.features]
    f_tbs = [None if t is None else bucket_size(t, g.bucket_time_sizes)
             for t in f_ts]
    bucket = (nb, tuple(f_tbs))

    fm_list = list(fms) if fms is not None else [None] * len(mds.features)
    lm_list = list(lms) if lms is not None else [None] * len(mds.labels)

    if nb == n and all(tb is None or tb == t
                       for t, tb in zip(f_ts, f_tbs)) \
            and all(m is not None for m in lm_list) \
            and all(t is None or m is not None
                    for t, m in zip(f_ts, fm_list)) \
            and all(t_of(y) is None
                    or bucket_size(t_of(y), g.bucket_time_sizes) == t_of(y)
                    for y in mds.labels):
        return mds, bucket

    def pad_entry(a, tb):
        a_p = cycle_rows(a, nb)
        if tb is not None and tb != a_p.shape[1]:
            a_p = _pad_time(a_p, tb)
        return a_p

    feats, new_fms = [], []
    for f, fm, t, tb in zip(mds.features, fm_list, f_ts, f_tbs):
        feats.append(pad_entry(f, tb))
        if t is not None:
            fm_arr = (_host(fm) if fm is not None
                      else np.ones((n, t), np.float32))
            fm_p = cycle_rows(fm_arr, nb)
            if tb != t:
                fm_p = _pad_time(fm_p, tb)
            new_fms.append(fm_p)
        else:
            new_fms.append(None if fm is None else cycle_rows(fm, nb))

    labels, new_lms = [], []
    for y, lm in zip(mds.labels, lm_list):
        t = t_of(y)
        tb = bucket_size(t, g.bucket_time_sizes) if t is not None else None
        y_p = pad_entry(y, tb)
        lm_base = (_host(lm) if lm is not None
                   else (np.ones(tuple(y.shape[:-1]), np.float32)
                         if len(y.shape) == 3 else None))
        scale = np.float32(nb / n if scale_loss else 1.0)
        if lm_base is None:
            m = np.zeros((nb,) + (1,) * (len(y.shape) - 1), np.float32)
            m[:n] = scale
        else:
            tgt = [nb] + list(lm_base.shape[1:])
            if t is not None and lm_base.ndim >= 2 \
                    and lm_base.shape[1] == t and tb != t:
                tgt[1] = tb
            m = np.zeros(tuple(tgt), np.float32)
            sl = (slice(0, n),) + tuple(slice(0, s)
                                        for s in lm_base.shape[1:])
            m[sl] = lm_base * scale
        labels.append(y_p)
        new_lms.append(m)

    return MultiDataSet(feats, labels, tuple(new_fms), tuple(new_lms)), \
        bucket


# ---------------------------------------------------------------------------
# Inference bucketing
# ---------------------------------------------------------------------------
def bucket_inference_features(x, mask, g):
    """Zero-pad a feature batch up to its bucket (rows are independent at
    inference, so zeros are exact), making or extending the time mask of
    sequences so recurrent state carries through padded steps unchanged
    (exact for bidirectional RNNs too: masked steps are identity carries).
    Returns ``(x_p, mask_p, n, t, bucket)``."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    n = int(x.shape[0])
    nb = bucket_size(n, g.bucket_batch_sizes)
    t = int(x.shape[1]) if x.ndim == 3 else None
    tb = bucket_size(t, g.bucket_time_sizes) if t is not None else None

    x_p = x
    if nb != n:
        x_p = _zeros(x, (nb,) + tuple(x.shape[1:]))
        x_p[:n] = x
    if tb is not None and tb != t:
        x_p = _pad_time(x_p, tb)

    if t is not None:
        m = _host(mask) if mask is not None else np.ones((n, t), np.float32)
        m_p = np.zeros((nb, tb) + m.shape[2:], np.float32)
        m_p[:n, :t] = m
    elif mask is not None:
        m = _host(mask)
        m_p = np.zeros((nb,) + m.shape[1:], np.float32)
        m_p[:n] = m
    else:
        m_p = None
    return x_p, m_p, n, t, (nb, tb)


def unpad_outputs(out, n: int, t: Optional[int], tb: Optional[int]):
    """Slice a padded output back to the real batch (and time) extent."""
    out = out[:n]
    if t is not None and tb is not None and t != tb and out.ndim >= 3 \
            and out.shape[1] == tb:
        out = out[:, :t]
    return out


# ---------------------------------------------------------------------------
# Signature telemetry
# ---------------------------------------------------------------------------
def signature_of(tree) -> Tuple:
    """Hashable (structure, shapes, dtypes) signature of a tree (dicts,
    lists, tuples) of arrays or tensors."""
    leaves: List = []

    def walk(t):
        if isinstance(t, dict):
            return "{" + ",".join(f"{k}:{walk(t[k])}"
                                  for k in sorted(t)) + "}"
        if isinstance(t, (list, tuple)):
            return "(" + ",".join(walk(v) for v in t) + ")"
        if t is None:
            return "N"
        leaves.append((tuple(getattr(t, "shape", ())),
                       str(getattr(t, "dtype", type(t).__name__))))
        return "*"
    return walk(tree), tuple(leaves)


class CompileTelemetry:
    """Distinct input signatures per entry point of one network, and
    per-bucket hit counts, under the JAX package's names
    (``dl4j_compile_calls_total``, ``dl4j_compile_retraces_total``,
    ``dl4j_bucket_hits_total``).  In the JAX package a new signature is
    an XLA retrace.  The port's eager forward compiles nothing per shape,
    so here the count is of the shapes each entry point has met: what
    cuDNN's autotuner (a benchmark per new conv shape under
    ``cudnn.benchmark``) and any captured CUDA graph key on, and the
    number a bucketed stream holds to the buckets it hits.

    ``record(kind, args, bucket=)`` is called by the engines' entry
    points (train_step, fused_step_k*, output, score, score_examples,
    rnn_time_step) with the arrays they are about to run on."""

    def __init__(self):
        self.retraces = 0
        self.calls = 0
        self.bucket_hits: Dict[str, int] = {}
        self._seen: Dict[str, set] = {}

    def record(self, kind: str, args, bucket=None) -> bool:
        """True when this (kind, signature) is new."""
        from deeplearning4j_tpu_torch.monitor import get_registry
        sig = signature_of(args)
        self.calls += 1
        seen = self._seen.setdefault(kind, set())
        new = sig not in seen
        if new:
            seen.add(sig)
            self.retraces += 1
        if bucket is not None:
            key = f"{kind}:{bucket_key(bucket)}"
            self.bucket_hits[key] = self.bucket_hits.get(key, 0) + 1
        reg = get_registry()
        reg.counter("dl4j_compile_calls_total", "jit-entry calls",
                    labels=("kind",)).labels(kind=kind).inc()
        if new:
            reg.counter("dl4j_compile_retraces_total",
                        "new entry-point input signatures",
                        labels=("kind",)).labels(kind=kind).inc()
        if bucket is not None:
            reg.counter("dl4j_bucket_hits_total",
                        "bucketed batches dispatched",
                        labels=("kind", "bucket")).labels(
                kind=kind, bucket=bucket_key(bucket)).inc()
        return new

    def snapshot(self) -> Dict[str, Any]:
        return {"retraces": self.retraces, "calls": self.calls,
                "by_kind": {k: len(v) for k, v in self._seen.items()},
                "bucket_hits": dict(self.bucket_hits)}
