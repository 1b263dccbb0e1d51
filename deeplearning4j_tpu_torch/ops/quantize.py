"""Weight-only int8 / fp8 quantized inference and int8 gradient blocks — the
port of ``deeplearning4j_tpu/ops/quantize.py``.

``quantize_params`` turns every float param of two or more dimensions
into ``{"q": codes, "s": float32 scales}`` with symmetric scales per index
of the LAST axis (the JAX package's rule, :156-163): int8 codes in
-127..127, or ``torch.float8_e4m3fn`` codes scaled to its finite maximum
448.  The codes are the JAX package's bit for bit (the same float32
division, round-half-to-even and e4m3 rounding).  On the OIHW conv weights
both packages keep, the last axis is the kernel column, not the output
channel the JAX docstring names; the rule is copied as it is, so codes and
outputs stay equal.  Biases, 1-D and integer leaves stay as they are.

The codes stay resident on the params' device; a serving forward reads
them through :class:`DequantizedView`, which expands one layer's (or
vertex's) leaves to ``q.float() * s`` when the forward reaches it, the
counterpart of the JAX package's in-trace expand.  There is no self-test
or kill switch here (the JAX package's ``ops/helpers.py`` seam is not
ported): a mode the device cannot take raises.

``quantize_blocks``, ``dequantize_blocks`` and :class:`ErrorFeedback`
(per-block int8 codes of a flat gradient, with the error carried to the
next step) are numpy, as in the JAX package; their use on the wire waits
for distributed training.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

#: gradient-quantization block length: long enough to amortize the f32
#: scale (0.2% overhead), short enough that one outlier only inflates
#: the quantization step of its own 2048 neighbours
GRAD_BLOCK = 2048

#: int8 symmetric code range (-127..127; -128 unused keeps zero exact
#: and the code symmetric)
_INT8_MAX = 127.0
#: float8_e4m3 finite max
_FP8_MAX = 448.0

MODES = ("int8", "fp8")


def record_weight_bytes(tier: str, quantized: int, dense: int) -> None:
    """Resident-weight footprint after weight-only quantization, in the
    JAX package's gauge ``dl4j_precision_weight_bytes{tier,kind}``."""
    from deeplearning4j_tpu_torch import monitor
    g = monitor.get_registry().gauge(
        "dl4j_precision_weight_bytes",
        "device-resident weight bytes after quantization, vs the dense "
        "fp32 footprint", labels=("tier", "kind"))
    g.labels(tier=tier, kind="quantized").set(int(quantized))
    g.labels(tier=tier, kind="dense").set(int(dense))


def fp8_dtype() -> Optional[torch.dtype]:
    """torch's float8_e4m3fn, or None when this torch has none."""
    return getattr(torch, "float8_e4m3fn", None)


def check_mode(mode: str) -> str:
    mode = str(mode).lower()
    if mode not in MODES:
        raise ValueError(f"unknown weight-quantization mode '{mode}' "
                         f"(known: int8, fp8)")
    if mode == "fp8" and fp8_dtype() is None:
        raise ValueError("fp8 requested but this torch has no "
                         "float8_e4m3fn")
    return mode


def is_qleaf(x) -> bool:
    return isinstance(x, dict) and set(x.keys()) == {"q", "s"}


def quantize_weight(w: torch.Tensor, mode: str = "int8") -> dict:
    """One weight leaf -> ``{"q": codes, "s": f32 scales}``: symmetric
    scales per index of the last axis, on ``w``'s device."""
    mode = check_mode(mode)
    w = w.detach().to(torch.float32)
    if w.ndim > 1:
        amax = w.abs().amax(dim=tuple(range(w.ndim - 1)), keepdim=True)
    else:
        amax = w.abs().amax().reshape(1)
    amax = torch.clamp_min(amax, 1e-12)
    # divided by a tensor of the constant: on CUDA a division by a Python
    # scalar multiplies by its reciprocal, a rounding away from numpy's
    top = torch.full_like(amax, _INT8_MAX if mode == "int8" else _FP8_MAX)
    s = amax / top
    if mode == "int8":
        q = torch.clamp(torch.round(w / s), -_INT8_MAX, _INT8_MAX).to(
            torch.int8)
    else:
        q = (w / s).to(fp8_dtype())
    return {"q": q, "s": s}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def quantize_params(tree, mode: str = "int8") -> Tuple[object, dict]:
    """Weight-only quantization of a param tree (a list of dicts by
    layer, or a dict of dicts by vertex): float leaves of two or more
    dimensions become ``{"q", "s"}`` records, the rest pass through.
    Returns ``(qtree, stats)``, stats carrying the quantized and dense
    byte footprints (dense counts float leaves at 4 bytes, as JAX's)."""
    mode = check_mode(mode)
    stats = {"n_quantized": 0, "n_passthrough": 0,
             "quantized_bytes": 0, "dense_bytes": 0}

    def one(x: torch.Tensor):
        stats["dense_bytes"] += (x.numel() * 4 if x.is_floating_point()
                                 else _nbytes(x))
        if x.ndim >= 2 and x.is_floating_point():
            rec = quantize_weight(x, mode)
            stats["n_quantized"] += 1
            stats["quantized_bytes"] += _nbytes(rec["q"]) + _nbytes(rec["s"])
            return rec
        stats["n_passthrough"] += 1
        stats["quantized_bytes"] += _nbytes(x)
        return x

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return one(t) if isinstance(t, torch.Tensor) else t

    qtree = walk(tree)
    record_weight_bytes(f"{mode}_infer", stats["quantized_bytes"],
                        stats["dense_bytes"])
    return qtree, stats


def dequantize_leaf(x):
    """``q.float() * s`` for a ``{"q", "s"}`` record; anything else as it
    is."""
    if is_qleaf(x):
        return x["q"].to(torch.float32) * x["s"]
    return x


def dequantize_params(qtree):
    """The whole tree expanded (``{"q", "s"}`` records to ``q * s``)."""
    if is_qleaf(qtree):
        return dequantize_leaf(qtree)
    if isinstance(qtree, dict):
        return {k: dequantize_params(v) for k, v in qtree.items()}
    if isinstance(qtree, (list, tuple)):
        return type(qtree)(dequantize_params(v) for v in qtree)
    return qtree


class DequantizedView:
    """The params a serving forward reads, over a quantized tree: indexing
    it by layer (a list's index, negatives included) or by vertex name
    expands that entry's leaves and passes them through ``cast`` (the
    precision policy's ``cast_to_compute``).  Only the layer running holds
    expanded weights; the codes stay as they are."""

    def __init__(self, qtree, cast=None):
        self._q = qtree
        self._cast = cast or (lambda t: t)

    def __getitem__(self, key):
        return self._cast(dequantize_params(self._q[key]))


# ---------------------------------------------------------------------------
# Gradient block quantization + error feedback (numpy, the JAX package's)
# ---------------------------------------------------------------------------

def quantize_blocks(vec, block: int = GRAD_BLOCK
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-block int8 quantization of a flat f32 vector:
    ``(codes int8 [n], scales f32 [ceil(n/block)])``."""
    v = np.asarray(vec, np.float32).ravel()
    n = v.size
    nb = max(1, -(-n // block))
    pad = nb * block - n
    vp = np.pad(v, (0, pad)).reshape(nb, block) if pad else \
        v.reshape(nb, block)
    amax = np.abs(vp).max(axis=1)
    scales = np.where(amax > 0, amax / _INT8_MAX, 1.0).astype(np.float32)
    codes = np.clip(np.rint(vp / scales[:, None]),
                    -_INT8_MAX, _INT8_MAX).astype(np.int8)
    return codes.reshape(-1)[:n].copy(), scales


def dequantize_blocks(codes, scales, block: int = GRAD_BLOCK
                      ) -> np.ndarray:
    """Inverse of :func:`quantize_blocks` (exact: int8 code x f32 scale
    is representable, so every receiver reconstructs the same f32
    vector)."""
    c = np.asarray(codes).ravel().astype(np.float32)
    s = np.asarray(scales, np.float32).ravel()
    n = c.size
    nb = s.size
    pad = nb * block - n
    if pad < 0 or pad >= block:
        raise ValueError(f"codes length {n} inconsistent with "
                         f"{nb} scale blocks of {block}")
    cp = np.pad(c, (0, pad)).reshape(nb, block) if pad else \
        c.reshape(nb, block)
    return (cp * s[:, None]).reshape(-1)[:n].astype(np.float32)


class ErrorFeedback:
    """Persistent error-feedback residual for quantized gradient
    collectives: each contribution quantizes ``grad + residual`` and
    keeps ``(grad + residual) - dequant`` for the next step, so the
    quantization error is carried, not dropped.  ``commit`` runs only
    after the contribution was accepted; a generation roll calls
    :meth:`reset` instead."""

    def __init__(self, block: int = GRAD_BLOCK):
        self.block = int(block)
        self.residual: Optional[np.ndarray] = None

    def compensate(self, vec: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(compensated, codes, scales)`` for one contribution."""
        v = np.asarray(vec, np.float32).ravel()
        if self.residual is None or self.residual.size != v.size:
            self.residual = np.zeros_like(v)
        comp = v + self.residual
        codes, scales = quantize_blocks(comp, self.block)
        return comp, codes, scales

    def commit(self, comp: np.ndarray, codes: np.ndarray,
               scales: np.ndarray) -> None:
        """Persist the quantization error of an accepted contribution."""
        self.residual = comp - dequantize_blocks(codes, scales, self.block)

    def reset(self) -> None:
        """Drop the residual (generation roll / rejoin / resize)."""
        self.residual = None
