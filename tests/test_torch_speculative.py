"""The port's speculative decode (``server/speculative.py`` and the pool's
verify step) held against the JAX package's on the CPU.

* The draft proposers propose what JAX's propose on the same histories.
* Greedy: the verify step commits exactly the tokens plain greedy decode
  emits, at every acceptance length 0..K, and those are JAX's tokens
  (token ids compared for equality); ``generate`` with each proposer and
  ``ModelDraft`` likewise; on a paged pool too, where a rejected draft's
  arena writes are rolled back so the arena is bit for bit what committing
  only the accepted tokens leaves.
* Sampling: the port draws its Gumbel noise from a generator keyed on
  (seed, stream position); JAX's ``jax.random`` stream cannot be
  reproduced in torch, so the contract is held inside the port: the
  speculative trajectory equals the port's one-token-per-dispatch sampling
  at the same seed at every acceptance length, and a chi-square test
  (alpha = 0.001) holds the draws to the model's temperature-scaled
  distribution, top-k renormalised.
* The gateway's ``spec=`` knob over HTTP gives JAX's gateway's tokens.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import serialization as jax_ser
from deeplearning4j_tpu.server import speculative as jax_spec
from deeplearning4j_tpu.server.decode import DecodePool as JaxPool
from deeplearning4j_tpu.server.gateway import (
    DeepLearning4jEntryPoint as JaxEntryPoint)
from deeplearning4j_tpu_torch.server import (
    DecodePool, DeepLearning4jEntryPoint, Server)
from deeplearning4j_tpu_torch.server import speculative as spec
from deeplearning4j_tpu_torch.server.speculative import (
    ModelDraft, NGramDraft, ScriptedDraft, SpeculativeDecoder, one_hot)

from test_torch_decode import (V, WAIT, jax_attention_mln, jax_lstm_mln,
                               port_of)

K = 3


@pytest.fixture(autouse=True)
def _one_torch_thread(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_FLIGHT_DIR", str(tmp_path / "flight"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pools():
    made = []
    yield made
    for p in made:
        (p.close if hasattr(p, "close") else p.stop)()


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("spec_zips")
    out = {}
    for kind, jnet in (("lstm_mln", jax_lstm_mln(seed=13)),
                       ("attention_mln", jax_attention_mln(seed=5,
                                                           window=32))):
        path = d / f"{kind}.zip"
        jax_ser.write_model(jnet, path)
        out[kind] = (jnet, str(path))
    return out


def _pool(pools, net, cls=DecodePool, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_wait_ms", 0.5)
    p = cls(net, **kw)
    pools.append(p)
    return p


def _greedy(pool, prompt, n):
    """Plain greedy decode: the prompt, then n tokens one per dispatch."""
    sid = pool.open_session()
    (o,) = pool.step(sid, one_hot(prompt, V), timeout=WAIT)
    pending = int(np.argmax(o[-1]))
    out = []
    for _ in range(n):
        out.append(pending)
        (o,) = pool.step(sid, one_hot([pending], V), timeout=WAIT)
        pending = int(np.argmax(o[-1]))
    pool.close_session(sid)
    return out


# ---------------------------------------------------------------------------
# proposers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", [1, 2, 3, 5])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ngram_proposals_equal_jax(order, seed):
    rng = np.random.default_rng(seed)
    motif = list(rng.integers(0, 5, 4))
    for n in range(0, 30, 3):
        hist = [int(t) for t in (motif * 8)[:n]] + \
            [int(t) for t in rng.integers(0, 5, n % 4)]
        for k in (0, 1, 3, 6):
            assert NGramDraft(order).propose(hist, k) == \
                jax_spec.NGramDraft(order).propose(hist, k)


def test_scripted_drafts_make_draft_and_one_hot_equal_jax():
    props = [[1, 2, 3], [0], [], [4, 4, 4, 4]]
    a, b = ScriptedDraft(props), jax_spec.ScriptedDraft(props)
    assert [a.propose([0], 2) for _ in range(6)] == \
        [b.propose([0], 2) for _ in range(6)]
    for cfg in ("ngram", {"kind": "ngram", "order": 2}, "none", None):
        mine, theirs = spec.make_draft(cfg), jax_spec.make_draft(cfg)
        assert type(mine).__name__ == type(theirs).__name__
    with pytest.raises(ValueError):
        spec.make_draft("bogus")
    np.testing.assert_array_equal(one_hot([3, 0, 2], V),
                                  jax_spec.one_hot([3, 0, 2], V))


# ---------------------------------------------------------------------------
# greedy speculation: JAX's tokens at every acceptance length
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["lstm_mln", "attention_mln"])
def test_greedy_accept_lengths_0_to_k_give_jax_tokens(kind, models, pools):
    jnet, path = models[kind]
    pp = _pool(pools, port_of(path))
    prompt, N = [0, 3, 1], 8
    ref = _greedy(_pool(pools, jnet, JaxPool), prompt, N + K + 1)
    assert _greedy(pp, prompt, N + K + 1) == ref
    for a in range(K + 1):            # a = accepted draft tokens
        sid = pp.open_session()
        (o,) = pp.step(sid, one_hot(prompt, V), timeout=WAIT)
        pending = int(np.argmax(o[-1]))
        chunk = [pending] + ref[1:1 + a] + \
            [(t + 1) % V for t in ref[1 + a:1 + K]]
        outs, picks, acc = pp.spec_step(sid, one_hot(chunk, V), chunk,
                                        timeout=WAIT)
        assert acc == 1 + a and chunk[:acc] == ref[:acc]
        nxt = int(picks[acc - 1])
        assert nxt == ref[acc]
        (o,) = pp.step(sid, one_hot([nxt], V), timeout=WAIT)
        assert int(np.argmax(o[-1])) == ref[acc + 1]
        pp.close_session(sid)
    snap = pp.metrics.snapshot()
    assert snap["spec_steps"] == K + 1
    assert snap["spec_tokens_accepted"] == sum(range(1, K + 2))


@pytest.mark.parametrize("draft", ["ngram", "scripted", "none"])
@pytest.mark.parametrize("kind", ["lstm_mln", "attention_mln"])
def test_generate_byte_identical_to_jax_and_plain_greedy(kind, draft,
                                                         models, pools):
    jnet, path = models[kind]
    pp = _pool(pools, port_of(path))
    jp = _pool(pools, jnet, JaxPool)
    prompt, N = [2, 0, 4], 12
    ref = _greedy(pp, prompt, N)
    res = {}
    for name, pool, mod in (("port", pp, spec), ("jax", jp, jax_spec)):
        mk = {"ngram": lambda: mod.NGramDraft(order=3),
              "scripted": lambda: mod.ScriptedDraft([[1, 2], [0], [5, 5]]),
              "none": lambda: mod.ScriptedDraft([])}[draft]
        sid = pool.open_session()
        (o,) = pool.step(sid, one_hot(prompt, V), timeout=WAIT)
        res[name] = mod.SpeculativeDecoder(pool, vocab=V, k=K,
                                           draft=mk()).generate(
            sid, int(np.argmax(o[-1])), N)
        pool.close_session(sid)
    assert res["port"]["tokens"] == res["jax"]["tokens"] == ref
    assert res["port"]["next_token"] == res["jax"]["next_token"]
    assert res["port"]["dispatches"] == res["jax"]["dispatches"] <= N


def test_model_draft_stays_exact(models, pools):
    """The draft model is a copy of the target, so drafts are right and
    acceptance reaches K + 1 once warm; the tokens stay plain greedy's."""
    _, path = models["lstm_mln"]
    pp = _pool(pools, port_of(path))
    prompt, N = [1, 5, 2], 12
    ref = _greedy(pp, prompt, N)
    sid = pp.open_session()
    (o,) = pp.step(sid, one_hot(prompt, V), timeout=WAIT)
    md = ModelDraft(port_of(path), vocab=V)
    md._feed(prompt)
    md._seen = 0
    res = SpeculativeDecoder(pp, vocab=V, k=K, draft=md).generate(
        sid, int(np.argmax(o[-1])), N)
    assert res["tokens"] == ref and res["dispatches"] < N


def test_paged_greedy_and_rejected_draft_leave_arena_as_committed(models,
                                                                  pools):
    """On a paged pool the verify step gives plain greedy's tokens, and a
    verify whose drafts are all rejected leaves the arena bit for bit as a
    plain step of the pending token alone leaves its twin's."""
    _, path = models["attention_mln"]
    net = port_of(path)
    dense = _pool(pools, net)
    paged = _pool(pools, net, kv_paged=True, kv_block=4)
    prompt, N = [1], 10
    ref = _greedy(dense, prompt, N + 1)
    sid = paged.open_session()
    (o,) = paged.step(sid, one_hot(prompt, V), timeout=WAIT)
    res = SpeculativeDecoder(paged, vocab=V, k=K,
                             draft=NGramDraft(order=3)).generate(
        sid, int(np.argmax(o[-1])), N)
    assert res["tokens"] == ref[:N]
    # two fresh paged pools, so their arenas start equal
    paged = _pool(pools, net, kv_paged=True, kv_block=4)
    twin = _pool(pools, net, kv_paged=True, kv_block=4)
    a, b = paged.open_session(), twin.open_session()
    for p, s in ((paged, a), (twin, b)):
        p.step(s, one_hot([2, 7, 3, 9, 1], V), timeout=WAIT)
    pending = ref[0]
    junk = [(pending + 1) % V] * K
    _, picks, acc = paged.spec_step(a, one_hot([pending] + junk, V),
                                    [pending] + junk, timeout=WAIT)
    assert acc == 1 or int(picks[0]) == junk[0]
    twin.step(b, one_hot([pending], V), timeout=WAIT)
    if acc == 1:
        for ar_a, ar_b in zip(paged._arenas, twin._arenas):
            for n in ("k", "v"):
                assert torch.equal(ar_a[n], ar_b[n])
    pa, pb = (p.export_session(s) for p, s in ((paged, a), (twin, b)))
    assert [leaf["npy_b64"] for leaf in pa["carry"]["leaves"]] == \
        [leaf["npy_b64"] for leaf in pb["carry"]["leaves"]]


# ---------------------------------------------------------------------------
# sampling speculation: the port's own non-speculative sampling
# ---------------------------------------------------------------------------

def _sampled(pool, n, k, draft, **sampling):
    sid = pool.open_session()
    res = SpeculativeDecoder(pool, vocab=V, k=k, draft=draft,
                             **sampling).generate(sid, 1, n)
    pool.close_session(sid)
    return res


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("top_k", [0, 4])
def test_sampling_spec_equals_nonspec_sampling(top_k, paged, models, pools):
    _, path = models["attention_mln"]
    pool = _pool(pools, port_of(path), kv_paged=paged, kv_block=4)
    kw = dict(temperature=0.8, top_k=top_k)
    base = _sampled(pool, 16, 0, "none", seed=123, **kw)
    assert base["dispatches"] == 16
    fast = _sampled(pool, 16, K, NGramDraft(order=3), seed=123, **kw)
    assert fast["tokens"] == base["tokens"]
    other = _sampled(pool, 16, 0, "none", seed=124, **kw)
    assert other["tokens"] != base["tokens"]


def test_sampling_acceptance_lengths_0_to_k_keep_the_trajectory(models,
                                                                pools):
    """Drafts of the true continuation corrupted at index c pin the
    acceptance at c draft tokens; the trajectory never moves."""
    _, path = models["lstm_mln"]
    pool = _pool(pools, port_of(path))
    N = 14
    ref = _sampled(pool, N, 0, "none", temperature=0.8, seed=5)["tokens"]
    for c in range(K + 1):
        props, i = [], 1
        while i < N:
            p = list(ref[i:i + K])
            if c < len(p):
                p[c] = (p[c] + 1) % V
            props.append(p)
            i += max(1, min(c + 1, len(p) + 1))
        res = _sampled(pool, N, K, ScriptedDraft(props), temperature=0.8,
                       seed=5)
        assert res["tokens"] == ref, (c, res["tokens"])


def test_sampling_chi_square_matches_model_distribution(models, pools):
    """With the output layer's weights zeroed the head emits softmax(b) at
    every position, so sampling at temperature t draws iid from
    softmax(b / t): chi-square at alpha = 0.001 over 3,000 tokens
    (15 degrees of freedom, critical value 37.697); with top_k = 4 over
    1,500 tokens the draws renormalise over the 4 best logits (3 degrees,
    16.266) and never emit the rest."""
    _, path = models["lstm_mln"]
    net = port_of(path)
    bias = np.random.default_rng(3).normal(size=V).astype(np.float32) * 0.6
    net.net_params[-1]["W"].zero_()
    net.net_params[-1]["b"].copy_(torch.from_numpy(bias))
    pool = _pool(pools, net)
    temp = 0.7

    def chi2(toks, p):
        counts = np.bincount(toks, minlength=V).astype(np.float64)
        live = p > 0
        assert counts[~live].sum() == 0, "a token outside the support"
        exp = p[live] * len(toks)
        return float(((counts[live] - exp) ** 2 / exp).sum())
    res = _sampled(pool, 3001, 2, NGramDraft(order=3), temperature=temp,
                   seed=99)
    p = np.exp(bias / temp) / np.exp(bias / temp).sum()
    assert chi2(np.asarray(res["tokens"][1:]), p) < 37.697
    res = _sampled(pool, 1501, 2, NGramDraft(order=3), temperature=temp,
                   top_k=4, seed=7)
    keep = np.argsort(bias)[-4:]
    pk = np.zeros(V)
    pk[keep] = np.exp(bias[keep] / temp)
    pk /= pk.sum()
    assert chi2(np.asarray(res["tokens"][1:]), pk) < 16.266


# ---------------------------------------------------------------------------
# the gateway's spec= knob
# ---------------------------------------------------------------------------

def _post(url, obj):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_gateway_spec_knob_gives_jax_gateways_tokens(models, pools):
    _, path = models["attention_mln"]
    jep = JaxEntryPoint(decode_slots=4, decode_max_wait_ms=0.5)
    server = Server(DeepLearning4jEntryPoint(
        device="cpu", decode_slots=4, decode_max_wait_ms=0.5),
        port=0).start()
    pools += [jep, server]
    base = f"http://{server.host}:{server.port}"
    code, body = _post(base + "/", {"method": "warmup", "params": {
        "model_path": path, "feature_dims": [1, V], "max_batch": 2,
        "spec_k": K}})
    assert code == 200, body
    assert body["result"]["spec"]["slot_ladder"] == [1, 2, 4]
    prompt = one_hot([0, 3, 1], V).tolist()
    code, body = _post(base + "/", {"method": "open_session",
                                    "params": {"model_path": path}})
    sid = body["result"]["session_id"]
    code, body = _post(base + "/", {"method": "decode_step", "params": {
        "session_id": sid, "features": prompt,
        "spec": {"tokens": 8, "k": K}, "draft": "ngram"}})
    assert code == 200, body
    got = body["result"]["spec"]
    jsid = jep.open_session(path)["session_id"]
    want = jep.decode_step(jsid, prompt, spec={"tokens": 8, "k": K},
                           draft="ngram")["spec"]
    assert got["tokens"] == want["tokens"] and len(got["tokens"]) == 8
    assert got["accepted"] == 8 and got["dispatches"] <= 8
    code, body = _post(base + "/", {"method": "decode_stats",
                                    "params": {}})
    (st,) = body["result"].values()
    assert st["spec_steps"] >= 1 and st["kv_cache"]["rings"] == 2
    code, body = _post(base + "/", {"method": "close_session",
                                    "params": {"session_id": sid}})
    assert body["result"]["closed"] is True
