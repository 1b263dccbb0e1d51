"""Speculative decode on top of the slot-pool decode path — the port of
``deeplearning4j_tpu/server/speculative.py``.

Plain autoregressive serving pays one pool dispatch per emitted token.
Speculative decode batches that loop through the pool's verify step
(``server/decode.DecodePool.spec_step``):

1. a cheap **draft proposer** guesses the next K tokens,
2. ONE dispatch feeds ``[pending] + drafts`` through the target model
   token by token, finds the longest draft prefix the target's own greedy
   argmax agrees with, and lands the session's device carry at exactly that
   acceptance point,
3. every committed token is, by construction, the token step-by-step
   greedy decode would have emitted, with up to (K+1)-fold fewer
   dispatches per accepted token.

Draft quality only affects speed (acceptance length), never output.

**Sampling mode** (``temperature=`` / ``top_k=`` / ``seed=``): the verify
step samples each position from the target distribution with a
position-keyed Gumbel-argmax draw, so the emitted trajectory is exactly
the one one-token-per-dispatch sampling emits at the same seed, whatever
the acceptance length.  The port keys its draws on (seed, position) with
numpy's ``SeedSequence`` (the JAX package's ``jax.random`` stream cannot be
reproduced in torch), so a sampled trajectory is the port's own; greedy
speculation gives the JAX package's tokens.

Proposers are pluggable (:class:`DraftProposer`): :class:`NGramDraft` is
the self-drafting default (suffix lookup over the session's own history),
:class:`ScriptedDraft` drives tests through every acceptance length, and
:class:`ModelDraft` wraps a smaller model's own greedy loop.  Token
feedback is one-hot by default (``vocab == n_out == n_in``); pass
``token_to_features=`` for embedding-fed models.  Metered as ``dl4j_spec_*``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


class DraftProposer:
    """Interface: propose up to ``k`` next tokens given the stream's
    token history (prompt ids if known, plus every committed token).
    Returning fewer than ``k`` (or none) is legal — the verify chunk
    just shrinks toward plain decode."""

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        raise NotImplementedError

    def observe(self, tokens: Sequence[int]) -> None:
        """Committed tokens, in order (drafts keep their own state —
        e.g. ModelDraft advances its carry on exactly the accepted
        prefix)."""


class NGramDraft(DraftProposer):
    """Suffix-lookup self-drafting: find the most recent earlier
    occurrence of the stream's final ``order``-gram and propose the
    tokens that followed it.  Free (no model), deterministic, and
    exact-K on streams that repeat — the common case for structured
    output.  Falls back to shorter suffixes down to 1 token; proposes
    nothing on a cold stream (the verify step degrades to plain
    decode)."""

    def __init__(self, order: int = 3):
        self.order = max(1, int(order))

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        h = list(history)
        n = len(h)
        if n < 2 or k <= 0:
            return []
        for m in range(min(self.order, n - 1), 0, -1):
            suffix = h[n - m:]
            best: List[int] = []
            # most recent earlier occurrence wins, but an older match
            # with a FULL k-token continuation beats a recent one
            # truncated by the end of history (the all-repeats case)
            for i in range(n - m - 1, -1, -1):
                cont = h[i + m:i + m + k] if h[i:i + m] == suffix else []
                if len(cont) == k:
                    return cont
                if len(cont) > len(best):
                    best = cont
            if best:
                return best
        return []


class ScriptedDraft(DraftProposer):
    """Test/bench draft: pops pre-planned proposals in order (each an
    explicit token list), then proposes nothing.  Forces any acceptance
    length deterministically."""

    def __init__(self, proposals: Sequence[Sequence[int]]):
        self._proposals = [list(p) for p in proposals]

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        if not self._proposals:
            return []
        return [int(t) for t in self._proposals.pop(0)[:k]]


class ModelDraft(DraftProposer):
    """Shortened-model drafting: a (smaller, cheaper) draft model runs
    its own greedy loop ``rnn_time_step`` by token to guess the
    target's continuation.  ``observe`` replays exactly the committed
    tokens through the draft model so its carry tracks the real stream
    (rejected guesses are rolled back by re-feeding from the accepted
    history — the draft model is cheap; the TARGET never re-runs)."""

    def __init__(self, model, vocab: int,
                 token_to_features: Optional[Callable] = None):
        self.model = model
        self.vocab = int(vocab)
        self._to_feat = token_to_features or (
            lambda toks: one_hot(toks, self.vocab))
        self._seen = 0           # committed tokens consumed by the carry

    def _feed(self, tokens: Sequence[int]) -> Optional[np.ndarray]:
        if not tokens:
            return None
        out = self.model.rnn_time_step(self._to_feat(list(tokens))[None])
        out = out[0] if isinstance(out, tuple) else out
        return out.detach().cpu().numpy()[0]

    def observe(self, tokens: Sequence[int]) -> None:
        del tokens  # propose() re-syncs from the authoritative history

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        h = list(history)
        if not h or k <= 0:
            return []
        # re-sync: feed whatever committed tokens the carry hasn't seen
        # (after a rejection the draft carry is AHEAD of the stream —
        # cheapest correct reset is replaying the whole history)
        if self._seen > len(h):
            self.model.rnn_clear_previous_state()
            self._seen = 0
        out = self._feed(h[self._seen:])
        self._seen = len(h)
        if out is None:
            return []
        drafts: List[int] = []
        nxt = int(np.argmax(out[-1]))
        for _ in range(k):
            drafts.append(nxt)
            out = self._feed([nxt])
            nxt = int(np.argmax(out[-1]))
        self._seen += len(drafts)   # carry has consumed its own guesses
        return drafts


def one_hot(tokens: Sequence[int], vocab: int) -> np.ndarray:
    a = np.zeros((len(tokens), int(vocab)), np.float32)
    a[np.arange(len(tokens)), np.asarray(tokens, np.int64)] = 1.0
    return a


def make_draft(spec) -> DraftProposer:
    """Build a proposer from the gateway's ``draft=`` knob: a
    :class:`DraftProposer`, a name (``"ngram"``), or a config dict
    (``{"kind": "ngram", "order": 3}``)."""
    if isinstance(spec, DraftProposer):
        return spec
    if spec is None:
        return NGramDraft()
    if isinstance(spec, str):
        spec = {"kind": spec}
    kind = str(spec.get("kind", "ngram")).lower()
    if kind == "ngram":
        return NGramDraft(order=int(spec.get("order", 3)))
    if kind == "none":
        return ScriptedDraft([])
    raise ValueError(f"unknown draft proposer {kind!r} "
                     "(expected ngram|none or a DraftProposer)")


class SpecSession:
    """Host-side speculative state for one decode session: the token
    history (draft context) and per-session draft proposer.  Device
    state stays entirely in the pool; losing this object (e.g. across a
    migration — it does NOT ride the carry payload) only cold-starts
    drafting, never correctness."""

    __slots__ = ("draft", "history", "dispatches", "proposed", "accepted",
                 "pos")

    def __init__(self, draft: DraftProposer):
        self.draft = draft
        self.history: List[int] = []
        self.dispatches = 0
        self.proposed = 0
        self.accepted = 0
        # absolute sampling position: keys the per-token PRNG so the
        # trajectory is independent of how tokens group into dispatches
        self.pos = 0


class SpeculativeDecoder:
    """Speculative generation against a :class:`DecodePool` (or the
    gateway's :class:`DecodeManager`: anything with ``spec_step(sid,
    feats, token_ids, ...)``), greedy unless a sampling knob is set."""

    def __init__(self, stepper, vocab: int, k: int = 4,
                 draft=None, token_to_features: Optional[Callable] = None,
                 temperature: Optional[float] = None, top_k: int = 0,
                 seed: Optional[int] = None):
        self.stepper = stepper
        self.vocab = int(vocab)
        self.k = max(0, int(k))
        self._draft_spec = draft
        self._to_feat = token_to_features or (
            lambda toks: one_hot(toks, self.vocab))
        # sampling mode: either knob switches the verify from greedy
        # argmax to the seeded rejection-sampled acceptance program
        self.temperature = temperature
        self.top_k = max(0, int(top_k))
        self.seed = seed
        self.sampling_on = temperature is not None or seed is not None
        self._lock = threading.Lock()
        self._sessions: Dict[str, SpecSession] = {}

    def _session(self, sid: str) -> SpecSession:
        with self._lock:
            s = self._sessions.get(sid)
            if s is None:
                s = SpecSession(make_draft(self._draft_spec))
                self._sessions[sid] = s
            return s

    def forget(self, sid: str) -> None:
        with self._lock:
            self._sessions.pop(sid, None)

    def generate(self, sid: str, first_token: int, n_tokens: int,
                 tenant: Optional[str] = None,
                 timeout_ms: Optional[float] = None) -> dict:
        """Emit ``n_tokens`` greedy tokens starting from ``first_token``
        (the target's known-greedy next token — the argmax of the last
        prefill output).  Byte-identical to the step-by-step greedy
        loop; dispatches collapse by the acceptance rate."""
        s = self._session(sid)
        out: List[int] = []
        pending = int(first_token)
        dispatches = proposed = 0
        while len(out) < int(n_tokens):
            budget = int(n_tokens) - len(out)
            k = min(self.k, max(0, budget - 1))
            drafts = [int(t) % self.vocab for t in
                      s.draft.propose(s.history + [pending], k)][:k]
            chunk = [pending] + drafts
            feats = self._to_feat(chunk)
            kw = {}
            if self.sampling_on:
                kw["sampling"] = {
                    "temperature": float(
                        1.0 if self.temperature is None
                        else self.temperature),
                    "top_k": self.top_k,
                    "seed": int(self.seed or 0),
                    "pos": s.pos,
                }
            _, greedy, acc = self.stepper.spec_step(
                sid, feats, chunk, timeout_ms=timeout_ms, tenant=tenant,
                **kw)
            acc = max(1, min(int(acc), budget))
            committed = chunk[:acc]
            out.extend(committed)
            s.history.extend(committed)
            s.draft.observe(committed)
            dispatches += 1
            proposed += len(drafts)
            s.pos += acc
            pending = int(greedy[acc - 1])
        s.dispatches += dispatches
        s.proposed += proposed
        s.accepted += len(out)
        return {
            "tokens": out[:int(n_tokens)],
            "next_token": pending,
            "dispatches": dispatches,
            "proposed": proposed,
            "accepted": len(out),
            "tokens_per_dispatch": round(len(out) / dispatches, 3)
            if dispatches else 0.0,
        }
