"""Word2vec update steps — chunked gather/scatter loops of plain torch ops.

The reference's inner loop queues one ``AggregateSkipGram``/``AggregateCBOW``
native op per training pair and flushes batches of 4096 into libnd4j,
where they execute sequentially (ref: models/embeddings/learning/impl/
elements/SkipGram.java:224-272, CBOW.java).  Here the host assembles
fixed-shape integer batches (context indices, Huffman points/codes,
negative samples, per-pair learning rates) and each step walks the batch
in sub-chunks of ``CHUNK`` pairs, on the tables' device:

    per chunk: gather rows → batched dot → sigmoid → weighted
    outer-product gradients → index_add_ into syn0/syn1/syn1neg

Chunking matters for fidelity: a fully-batched scatter-add would apply
every duplicate-row update from one stale snapshot (divergent on
Zipf-heavy rows); the loop re-reads fresh rows every ``CHUNK`` pairs,
approximating the reference's sequential hogwild dynamics.  Within a
chunk every update is computed from the chunk's starting tables, and
duplicate-row contributions are averaged (not summed) for stability.
The three tables are updated in place.

Indices are clamped for the gathers and an out-of-range index scatters
exactly 0: placeholder tables (the 1-row syn1neg when negative sampling
is off, the 1-row syn1 when hierarchical softmax is off) are indexed by
masked-out entries.  A branch whose masks are all zero by configuration
(``hs=False``, ``ns=False``) is skipped, which adds exactly what it
would have added: nothing.

What depends only on the batch — clamped rows, per-chunk duplicate
counts, validity — is computed once per step, not per chunk.
"""

from __future__ import annotations

import torch

# Gradient clip matching word2vec's expTable domain [-6, 6]
# (ref: InMemoryLookupTable builds expTable over MAX_EXP=6).
MAX_EXP = 6.0

# Pairs per chunk.  Small enough that duplicate-row staleness is
# negligible even for tiny vocabs.
CHUNK = 64


def _sigmoid_clipped(x):
    # Outside [-MAX_EXP, MAX_EXP] word2vec skips the update (sigmoid
    # saturates); clipping the input gives the same fixed endpoint values.
    return torch.sigmoid(x.clamp(-MAX_EXP, MAX_EXP))


def _inv_row_counts(n_rows, idx, weight):
    """1/count over rows touched in each chunk — duplicate contributions
    are averaged so a row's step never exceeds the sequential magnitude.

    ``idx`` (in range) and ``weight`` are chunk-major, ``(n_chunks,
    chunk, ...)``; counts never cross chunks."""
    n = idx.shape[0]
    base = torch.arange(n, device=idx.device).mul_(n_rows)
    flat = (idx + base.view((n,) + (1,) * (idx.dim() - 1))).reshape(-1)
    counts = torch.zeros(n * n_rows, dtype=weight.dtype, device=idx.device)
    counts.index_add_(0, flat, weight.reshape(-1))
    inv = 1.0 / counts.clamp_min(1.0)
    return inv[flat].view(idx.shape)


def _scatter_rows(n_rows, idx, weight):
    """(rows, scale): the clamped rows (JAX's gather ``mode="clip"``) and
    each entry's scatter scale — its row's 1/count in its chunk, 0 where
    the index is out of range (JAX's scatter ``mode="drop"``)."""
    keep = ((idx >= 0) & (idx < n_rows)).to(weight.dtype)
    rows = idx.clamp(0, n_rows - 1)
    return rows, _inv_row_counts(n_rows, rows, weight * keep) * keep


def _chunked(arr, chunk):
    b = arr.shape[0]
    pad = (-b) % chunk
    if pad:
        # padded tail rows carry zero masks/alpha, so they are no-ops
        arr = torch.cat(
            [arr, arr.new_zeros((pad,) + tuple(arr.shape[1:]))])
    return arr.reshape(((b + pad) // chunk, chunk) + tuple(arr.shape[1:]))


def _gather(table, rows):
    """``table[rows]`` for any shape of ``rows`` → ``rows.shape + (D,)``."""
    return table.index_select(0, rows.reshape(-1)).view(
        tuple(rows.shape) + (table.shape[1],))


def _branch(l1, table, rows, scale, targets, mask, alpha):
    """One output branch (HS over ``syn1`` or NS over ``syn1neg``): its
    share of neu1e, and the table's rows updated in place."""
    l2 = _gather(table, rows)                                   # (b, C, D)
    f = _sigmoid_clipped(torch.bmm(l2, l1.unsqueeze(2)).squeeze(2))
    g = (targets - f) * mask * alpha.unsqueeze(1)
    neu1e = torch.bmm(g.unsqueeze(1), l2).squeeze(1)
    upd = (g * scale).unsqueeze(2) * l1.unsqueeze(1)
    table.index_add_(0, rows.reshape(-1), upd.view(-1, table.shape[1]))
    return neu1e


def _hs_ns_setup(syn1, syn1neg, points, code_mask, neg_idx, neg_mask,
                 hs, ns):
    """Per-step rows and scales of the two branches (None when skipped)."""
    hs_rows = _scatter_rows(syn1.shape[0], points, code_mask) if hs else None
    ns_rows = _scatter_rows(syn1neg.shape[0], neg_idx, neg_mask) if ns \
        else None
    return hs_rows, ns_rows


def _hs_ns_grads(l1, syn1, syn1neg, k, hs_rows, ns_rows, code_targets,
                 code_mask, neg_label, neg_mask, alpha):
    """Shared HS + NS math for chunk ``k``: returns neu1e (None if both
    branches are off); syn1 and syn1neg are updated in place — HS first,
    then NS, each from its gathered pre-update rows."""
    neu1e = None
    if hs_rows is not None:
        neu1e = _branch(l1, syn1, hs_rows[0][k], hs_rows[1][k],
                        code_targets[k], code_mask[k], alpha[k])
    if ns_rows is not None:
        n = _branch(l1, syn1neg, ns_rows[0][k], ns_rows[1][k],
                    neg_label[k], neg_mask[k], alpha[k])
        neu1e = n if neu1e is None else neu1e + n
    return neu1e


def skipgram_step(syn0, syn1, syn1neg,
                  ctx_idx, points, code_targets, code_mask,
                  neg_idx, neg_label, neg_mask, alpha, *,
                  hs: bool = True, ns: bool = True):
    """One batched skip-gram update; the tables are updated in place and
    returned.

    syn0:      (V, D) input vectors
    syn1:      (Vi, D) HS inner-node table (Vi may be 1 if unused)
    syn1neg:   (Vn, D) NS output table     (Vn may be 1 if unused)
    ctx_idx:   (B,)   int — row of syn0 being trained (the "lastWord")
    points:    (B, C) int — Huffman inner-node rows of the center word
    code_targets: (B, C) f32 — 1-code (what sigmoid should produce)
    code_mask: (B, C) f32 — 1 for valid code positions, 0 padding
    neg_idx:   (B, K) int — target + negative sample rows
    neg_label: (B, K) f32 — 1 for the true target column, 0 for negatives
    neg_mask:  (B, K) f32 — validity mask (0 also kills pad pairs)
    alpha:     (B,)   f32 — per-pair learning rate
    hs / ns:   False only where code_mask / neg_mask is all zero by
               configuration; the branch is then skipped.
    """
    chunk = min(CHUNK, ctx_idx.shape[0])
    ctx, pts, ct, cm, ni, nl, nm, al = (
        _chunked(a, chunk) for a in
        (ctx_idx, points, code_targets, code_mask,
         neg_idx, neg_label, neg_mask, alpha))
    rows0, inv0 = _scatter_rows(syn0.shape[0], ctx, (al > 0).to(syn0.dtype))
    hs_rows, ns_rows = _hs_ns_setup(syn1, syn1neg, pts, cm, ni, nm, hs, ns)
    for k in range(ctx.shape[0]):
        l1 = syn0.index_select(0, rows0[k])
        neu1e = _hs_ns_grads(l1, syn1, syn1neg, k, hs_rows, ns_rows,
                             ct, cm, nl, nm, al)
        if neu1e is not None:
            syn0.index_add_(0, rows0[k], neu1e * inv0[k].unsqueeze(1))
    return syn0, syn1, syn1neg


def cbow_step(syn0, syn1, syn1neg,
              win_idx, win_mask, points, code_targets, code_mask,
              neg_idx, neg_label, neg_mask, alpha, *,
              hs: bool = True, ns: bool = True):
    """One batched CBOW update (ref: learning/impl/elements/CBOW.java);
    the tables are updated in place and returned.

    win_idx:  (B, W) int — context-window rows (incl. PV-DM labels)
    win_mask: (B, W) f32 — 1 for real context positions
    Other args as in :func:`skipgram_step`; l1 is the masked mean of the
    window vectors and the gradient is applied to every window row.
    """
    chunk = min(CHUNK, win_idx.shape[0])
    win, wm, pts, ct, cm, ni, nl, nm, al = (
        _chunked(a, chunk) for a in
        (win_idx, win_mask, points, code_targets, code_mask,
         neg_idx, neg_label, neg_mask, alpha))
    D = syn0.shape[1]
    counts = wm.sum(-1, keepdim=True).clamp_min(1.0)
    rows0, inv0 = _scatter_rows(syn0.shape[0], win, wm)
    # Apply neu1e to every context row (word2vec convention:
    # undivided), averaging duplicate rows within the chunk.
    scale0 = wm * inv0
    hs_rows, ns_rows = _hs_ns_setup(syn1, syn1neg, pts, cm, ni, nm, hs, ns)
    for k in range(win.shape[0]):
        vecs = _gather(syn0, rows0[k])                          # (b, W, D)
        l1 = (vecs * wm[k].unsqueeze(2)).sum(1) / counts[k]
        neu1e = _hs_ns_grads(l1, syn1, syn1neg, k, hs_rows, ns_rows,
                             ct, cm, nl, nm, al)
        if neu1e is not None:
            upd = neu1e.unsqueeze(1) * scale0[k].unsqueeze(2)
            syn0.index_add_(0, rows0[k].reshape(-1), upd.view(-1, D))
    return syn0, syn1, syn1neg


def infer_step(vec, syn1, syn1neg,
               points, code_targets, code_mask,
               neg_idx, neg_label, neg_mask, alpha, *,
               hs: bool = True, ns: bool = True):
    """PV inference: train ONLY a floating vector against frozen tables
    (ref: SkipGram.iterateSample isInference branch — updates the
    inferenceVector instead of syn0).

    vec: (B, D) — updated in place and returned; one inference vector
    per row.
    """
    neu1e = None
    for on, table, idx, targets, mask in (
            (hs, syn1, points, code_targets, code_mask),
            (ns, syn1neg, neg_idx, neg_label, neg_mask)):
        if not on:
            continue
        l2 = _gather(table, idx.clamp(0, table.shape[0] - 1))
        f = _sigmoid_clipped(torch.bmm(l2, vec.unsqueeze(2)).squeeze(2))
        g = (targets - f) * mask * alpha.unsqueeze(1)
        n = torch.bmm(g.unsqueeze(1), l2).squeeze(1)
        neu1e = n if neu1e is None else neu1e + n
    if neu1e is not None:
        vec.add_(neu1e)
    return vec
