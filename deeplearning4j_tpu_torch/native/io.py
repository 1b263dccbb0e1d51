"""Host-side windowing for the embedding trainers.

The port's own numpy form of the JAX package's ``native.io.skipgram_pairs``
(and of ``sg_pairs`` in ``native/dl4j_io.cc``, which that function runs
when the library loads): the same pairs in the same order.
"""

from __future__ import annotations

import numpy as np


def skipgram_pairs(ids: np.ndarray, window: int,
                   reduced: np.ndarray) -> "tuple[np.ndarray, np.ndarray]":
    """(context, center) index pairs for one sentence with per-center
    reduced windows — word2vec's windowing hot loop.  Center-major,
    context positions ascending; self-positions and equal-id pairs are
    skipped, matching the reference's skip-gram trainer."""
    ids = np.ascontiguousarray(ids, np.int32)
    reduced = np.ascontiguousarray(reduced, np.int32)
    n = ids.size
    if n == 0 or window <= 0:
        return (np.empty(0, np.int32), np.empty(0, np.int32))
    # offsets grid + validity mask
    offs = np.concatenate([np.arange(-window, 0), np.arange(1, window + 1)])
    pos = np.arange(n)[:, None] + offs[None, :]            # [n, 2w]
    w_eff = (window - reduced)[:, None]
    valid = (pos >= 0) & (pos < n) & (np.abs(offs)[None, :] <= w_eff)
    pos_c = np.clip(pos, 0, n - 1)
    ctx = ids[pos_c]
    ctr = np.broadcast_to(ids[:, None], ctx.shape)
    valid &= ctx != ctr
    return ctx[valid].astype(np.int32), ctr[valid].astype(np.int32)
