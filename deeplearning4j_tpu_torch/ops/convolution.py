"""Convolution and pooling — the port of ``deeplearning4j_tpu/ops/convolution.py``.

NCHW activations and OIHW weights at the API, as in the JAX package.
``border_mode='same'`` pads like XLA's SAME: the total pad is what keeps
``ceil(in/stride)`` outputs, split low = total // 2 and high = the rest,
so an odd row or column goes HIGH.  Max pooling pads with -inf.  The JAX
package's ``DL4J_CONV_LAYOUT`` NHWC switch is a TPU layout knob and has
no counterpart here.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def same_pads(in_hw: Sequence[int], kernel: Sequence[int],
              stride: Sequence[int] = (1, 1),
              dilation: Sequence[int] = (1, 1)) -> Tuple[Tuple[int, int], ...]:
    """XLA SAME padding per spatial dim as ``((lo, hi), ...)``."""
    pads = []
    for d, k, s, dl in zip(in_hw, kernel, stride, dilation):
        out = -(-d // s)
        eff_k = (k - 1) * dl + 1
        total = max((out - 1) * s + eff_k - d, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def explicit_pads(in_hw, kernel, stride, pad, dilation=(1, 1),
                  border_mode: str = "truncate"):
    """((top, bottom), (left, right)) for either border mode."""
    if border_mode == "same":
        return same_pads(in_hw, kernel, stride, dilation)
    return ((pad[0], pad[0]), (pad[1], pad[1]))


def conv2d(x, w, b=None, stride=(1, 1), pad=(0, 0), dilation=(1, 1),
           border_mode: str = "truncate"):
    """2D convolution, NCHW in / OIHW weights.  ``border_mode`` is
    'truncate' (explicit symmetric ``pad``) or 'same'."""
    (pt, pb), (pl, pr) = explicit_pads(x.shape[2:], w.shape[2:], stride,
                                       pad, dilation, border_mode)
    if (pt, pl) == (pb, pr):
        return F.conv2d(x, w, b, tuple(stride), (pt, pl), tuple(dilation))
    return F.conv2d(F.pad(x, (pl, pr, pt, pb)), w, b, tuple(stride), 0,
                    tuple(dilation))


def conv2d_output_shape(in_hw, kernel, stride, pad, dilation=(1, 1),
                        border_mode: str = "truncate"):
    if border_mode == "same":
        return tuple(-(-d // s) for d, s in zip(in_hw, stride))
    out = []
    for d, k, s, p, dl in zip(in_hw, kernel, stride, pad, dilation):
        eff_k = (k - 1) * dl + 1
        out.append((d + 2 * p - eff_k) // s + 1)
    return tuple(out)


def pool2d(x, kind: str, kernel=(2, 2), stride=(2, 2), pad=(0, 0),
           border_mode: str = "truncate", pnorm: int = 2):
    """Pooling over NCHW spatial dims: max | avg | sum | pnorm, with the
    JAX package's padding rules (max pads -inf; 'same' avg divides by the
    count of real elements in each window, 'truncate' avg by the window
    size)."""
    (pt, pb), (pl, pr) = explicit_pads(x.shape[2:], kernel, stride, pad,
                                       (1, 1), border_mode)
    kind = kind.lower()
    k, s = tuple(kernel), tuple(stride)
    padding = (pl, pr, pt, pb)

    def window_sum(v):
        v = F.pad(v, padding)
        return F.avg_pool2d(v, k, s, divisor_override=1)

    if kind == "max":
        return F.max_pool2d(F.pad(x, padding, value=float("-inf")), k, s)
    if kind in ("avg", "mean"):
        summed = window_sum(x)
        if border_mode == "same":
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            return summed / window_sum(ones)
        return summed / (k[0] * k[1])
    if kind == "sum":
        return window_sum(x)
    if kind == "pnorm":
        p = float(pnorm)
        return window_sum(torch.abs(x) ** p) ** (1.0 / p)
    raise ValueError(f"Unknown pooling type '{kind}'")


def conv1d(x, w, b=None, stride: int = 1, pad: int = 0, dilation: int = 1,
           border_mode: str = "truncate"):
    """1D convolution over sequences [N, T, C] with weights [K, C_in,
    C_out] (ref: nn/conf/layers/Convolution1DLayer.java, RNN-format data);
    'same' pads as XLA's SAME does, odd totals high."""
    (lo, hi), = (same_pads(x.shape[1:2], w.shape[:1], (stride,), (dilation,))
                 if border_mode == "same" else ((pad, pad),))
    xt = x.transpose(1, 2)
    if lo != hi:
        xt, lo = F.pad(xt, (lo, hi)), 0
    y = F.conv1d(xt, w.permute(2, 1, 0), b, stride, lo, dilation)
    return y.transpose(1, 2)


def pool1d(x, kind: str, kernel: int = 2, stride: int = 2, pad: int = 0,
           border_mode: str = "truncate", pnorm: int = 2):
    """1D pooling over [N, T, C] (ref: Subsampling1DLayer.java): ``pool2d``
    on a [N, C, T, 1] view."""
    x2 = x.transpose(1, 2)[..., None]
    y2 = pool2d(x2, kind, (kernel, 1), (stride, 1), (pad, 0), border_mode,
                pnorm)
    return y2[..., 0].transpose(1, 2)


def conv1d_output_len(t, kernel, stride, pad, dilation=1,
                      border_mode: str = "truncate"):
    if border_mode == "same":
        return -(-t // stride)
    eff_k = (kernel - 1) * dilation + 1
    return (t + 2 * pad - eff_k) // stride + 1


def zero_pad2d(x, pad_top, pad_bottom, pad_left, pad_right):
    """ZeroPaddingLayer: zeros around the spatial dims of NCHW."""
    return F.pad(x, (pad_left, pad_right, pad_top, pad_bottom))


def global_pool(x, kind: str, axes, pnorm: int = 2, mask=None):
    """GlobalPoolingLayer (ref: GlobalPoolingLayer.java): reduce ``axes``
    (``(2, 3)`` for NCHW, ``(1,)`` for [N, T, C]) by max | avg | sum |
    pnorm.  ``mask`` (broadcastable, 1 = keep) drops padded steps as
    MaskedReductionUtil does: -inf for max, zeros otherwise, and avg
    divides by the live count."""
    kind = kind.lower()
    axes = tuple(axes)
    if mask is not None:
        mask = mask.to(x.dtype)
        if kind == "max":
            x = torch.where(mask > 0, x, float("-inf"))
        else:
            x = x * mask
    if kind == "max":
        return torch.amax(x, dim=axes)
    if kind == "sum":
        return torch.sum(x, dim=axes)
    if kind in ("avg", "mean"):
        if mask is not None:
            denom = torch.sum(mask, dim=axes)
            return torch.sum(x, dim=axes) / torch.clamp_min(denom, 1e-8)
        return torch.mean(x, dim=axes)
    if kind == "pnorm":
        p = float(pnorm)
        return torch.sum(torch.abs(x) ** p, dim=axes) ** (1.0 / p)
    raise ValueError(f"Unknown global pooling type '{kind}'")
