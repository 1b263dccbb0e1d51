"""Recurrent primitives — the port of ``deeplearning4j_tpu/ops/recurrent.py``:
the peephole (Graves) LSTM cell and its time loop.

``lstm_scan`` projects the input of ALL time steps in one
``[N·T, nIn] x [nIn, 4H]`` product, outside the loop, as the JAX package
does outside its ``lax.scan``; the loop over time keeps only the
recurrent step.  That step is the hand-written kernel
(``ops/cuda_kernels.fused_lstm_step``, one launch per step) when
``ops/helpers.lstm_step_wanted`` selects it, and the composable cell
``_lstm_cell_pre`` otherwise.  Backprop through time is autograd over the
loop.

Layouts are the JAX package's: sequences [N, T, C], masks [N, T], the
fused weights' gate blocks [input, forget, output, cell] of width H, and
the peepholes pI/pF/pO as separate [H] vectors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.ops import activations as act_ops
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import helpers


class LSTMState(NamedTuple):
    c: torch.Tensor  # cell state [N, H]
    h: torch.Tensor  # hidden/output state [N, H]


def lstm_cell(params: dict, x_t: torch.Tensor, state: LSTMState,
              gate_act=act_ops.sigmoid, cell_act=act_ops.tanh,
              peephole: bool = True) -> Tuple[LSTMState, torch.Tensor]:
    """One peephole-LSTM step.  params: W [nIn, 4H], RW [H, 4H], b [4H],
    pI/pF/pO [H] (if peephole)."""
    return _lstm_cell_pre(params, x_t @ params["W"] + params["b"], state,
                          gate_act, cell_act, peephole)


def _lstm_cell_pre(params: dict, zx_t: torch.Tensor, state: LSTMState,
                   gate_act=act_ops.sigmoid, cell_act=act_ops.tanh,
                   peephole: bool = True) -> Tuple[LSTMState, torch.Tensor]:
    """LSTM step on a pre-projected input (zx_t = x_t W + b)."""
    z = zx_t + state.h @ params["RW"]
    zi, zf, zo, zc = z.chunk(4, dim=-1)
    if peephole:
        zi = zi + state.c * params["pI"]
        zf = zf + state.c * params["pF"]
    i = gate_act(zi)
    f = gate_act(zf)
    g = cell_act(zc)
    c_new = f * state.c + i * g
    if peephole:
        zo = zo + c_new * params["pO"]
    h_new = gate_act(zo) * cell_act(c_new)
    return LSTMState(c_new, h_new), h_new


def lstm_scan(params: dict, x: torch.Tensor,
              init: Optional[LSTMState] = None,
              mask: Optional[torch.Tensor] = None, reverse: bool = False,
              gate_act=act_ops.sigmoid, cell_act=act_ops.tanh,
              peephole: bool = True) -> Tuple[torch.Tensor, LSTMState]:
    """Run the LSTM over a whole sequence x [N, T, nIn].  ``mask`` [N, T]
    is 1 on valid steps: a masked step carries c and h through unchanged
    and outputs zeros.  ``reverse`` walks time from the last step to the
    first (outputs stay in input order).  Returns (outputs [N, T, H],
    final state)."""
    N, T, _ = x.shape
    H = params["RW"].shape[0]
    if init is None:
        zeros = torch.zeros((N, H), dtype=x.dtype, device=x.device)
        init = LSTMState(zeros, zeros)
    zx = torch.addmm(params["b"], x.reshape(N * T, -1),
                     params["W"]).reshape(N, T, 4 * H)
    if helpers.lstm_step_wanted(params, x, gate_act, cell_act, peephole):
        rw = params["RW"]
        p3 = torch.stack([params["pI"], params["pF"], params["pO"]])

        def cell(zx_t, carry):
            c_new, h_new = ck.fused_lstm_step(zx_t, carry.h, carry.c, rw, p3)
            return LSTMState(c_new, h_new), h_new
    else:
        def cell(zx_t, carry):
            return _lstm_cell_pre(params, zx_t, carry, gate_act, cell_act,
                                  peephole)

    # unbind: one view per step, whose gradients autograd joins with one
    # stack (indexing zx[:, t] would scatter each into a zero tensor)
    zxs = zx.unbind(1)
    ms = None if mask is None else (mask > 0).unsqueeze(-1).unbind(1)
    outs = [None] * T
    carry = init
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        new, h = cell(zxs[t], carry)
        if ms is not None:
            m = ms[t]
            new = LSTMState(torch.where(m, new.c, carry.c),
                            torch.where(m, new.h, carry.h))
            h = new.h * m
        carry = new
        outs[t] = h
    return torch.stack(outs, dim=1), carry
