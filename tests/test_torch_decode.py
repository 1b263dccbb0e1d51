"""The port's stateful decode serving (``server/decode.py``: DecodePool,
DecodeManager, the gateway's decode RPCs) held against the JAX package's
on the CPU, on zips the JAX package writes.

Models, at small widths: the char-RNN (2 x GravesLSTM of width 32,
vocabulary 16) as a MultiLayerNetwork and as a ComputationGraph, and the
attention model (2 x causal SelfAttentionLayer(32, 4 heads), window 24).
Params are drawn with numpy (the peepholes non-zero, so the carried cell
state reaches the gates), written into a JAX zip, and the port restores
that zip.

Tolerance: outputs float32 within rtol = atol = 1e-5 of the JAX pool's
(the same products summed in another order), with torch on one thread;
the pool against the port's own ``rnn_time_step`` within 1e-6.  Every
pool a test starts is stopped in a fixture's teardown, and every wait on
a future has a timeout, so a hung pool fails its test instead of the run.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf.graph_conf as jax_gc
import deeplearning4j_tpu.nn.conf.layers as jax_layers
import deeplearning4j_tpu.nn.conf.network as jax_network
from deeplearning4j_tpu.models import charrnn as jax_charrnn
from deeplearning4j_tpu.nn import serialization as jax_ser
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.server.decode import DecodePool as JaxPool
from deeplearning4j_tpu.server.gateway import (
    DeepLearning4jEntryPoint as JaxEntryPoint)
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.monitor import events
from deeplearning4j_tpu_torch.nn import serialization as ser
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.resilience.errors import (
    DeadlineExceededError, OverloadedError)
from deeplearning4j_tpu_torch.server import (
    DecodeManager, DecodePool, DeepLearning4jEntryPoint, ModelCache, Server)

V, HID, LAYERS = 16, 32, 2
ATT_W, ATT_HEADS, WINDOW = 32, 4, 24
TOL = 1e-5
SELF_TOL = 1e-6
WAIT = 30.0


@pytest.fixture(autouse=True)
def _one_torch_thread(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_FLIGHT_DIR", str(tmp_path / "flight"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pools():
    """Pools (either package's) and entry points a test starts; all are
    stopped at teardown."""
    made = []
    yield made
    for p in made:
        (p.close if hasattr(p, "close") else p.stop)()


# ---------------------------------------------------------------------------
# models: JAX nets with numpy params, their zips, and the port's restores
# ---------------------------------------------------------------------------

def _numpy_like(template, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=np.shape(v)) * (
        0.3 if np.ndim(v) == 2 else 0.2)).astype(np.float32)
        for k, v in template.items()}


def jax_lstm_mln(seed=3):
    jnet = jax_charrnn.char_rnn(V, HID, LAYERS).init()
    return jnet.init(params=[{k: jnp.asarray(v) for k, v in
                              _numpy_like(lp, seed + i).items()}
                             for i, lp in enumerate(jnet.net_params)])


def jax_lstm_graph(seed=5):
    g = jax_network.GlobalConf(seed=seed, learning_rate=0.1,
                               weight_init="xavier")
    b = (jax_gc.GraphBuilder(g).add_inputs("in")
         .add_layer("lstm1", jax_layers.GravesLSTM(n_in=V, n_out=HID,
                                                   activation="tanh"), "in")
         .add_layer("lstm2", jax_layers.GravesLSTM(n_in=HID, n_out=HID,
                                                   activation="tanh"),
                    "lstm1")
         .add_layer("out", jax_layers.RnnOutputLayer(
             n_in=HID, n_out=V, activation="softmax", loss="mcxent"),
             "lstm2")
         .set_outputs("out"))
    jnet = JaxGraph(b.build()).init()
    jnet.net_params = {n: {k: jnp.asarray(v) for k, v in
                           _numpy_like(lp, seed + i).items()}
                       for i, (n, lp) in enumerate(
                           sorted(jnet.net_params.items()))}
    return jnet


def jax_attention_mln(seed=7, window=WINDOW, vocab=V):
    b = (jax_network.NeuralNetConfiguration.builder().seed(seed)
         .learning_rate(0.05).updater("adam").list())
    for _ in range(2):
        b.layer(jax_layers.SelfAttentionLayer(
            n_out=ATT_W, n_heads=ATT_HEADS, causal=True,
            cache_window=window))
    b.layer(jax_layers.RnnOutputLayer(n_out=vocab, activation="softmax",
                                      loss="mcxent"))
    jnet = JaxNet(b.set_input_type(JaxInputType.recurrent(vocab, 64))
                  .build()).init()
    return jnet.init(params=[{k: jnp.asarray(v) for k, v in
                              _numpy_like(lp, seed + i).items()}
                             for i, lp in enumerate(jnet.net_params)])


MAKERS = {"lstm_mln": jax_lstm_mln, "lstm_graph": jax_lstm_graph,
          "attention_mln": jax_attention_mln}


@pytest.fixture(scope="module")
def zips(tmp_path_factory):
    """kind -> (JAX net, zip path), written once per module."""
    d = tmp_path_factory.mktemp("decode_zips")
    out = {}
    for kind, make in MAKERS.items():
        jnet = make()
        path = d / f"{kind}.zip"
        jax_ser.write_model(jnet, path)
        out[kind] = (jnet, str(path))
    return out


def port_of(path):
    """The port's network restored from a JAX zip, on the CPU."""
    return ser.load_model(path, device="cpu")


def tokens(n, t, seed=0, vocab=V):
    """One-hot token chunks [n, t, vocab]."""
    idx = np.random.default_rng(seed).integers(0, vocab, (n, t))
    return np.eye(vocab, dtype=np.float32)[idx]


def both_pools(pools, jnet, net, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_wait_ms", 0.5)
    jp = JaxPool(jnet, name="jax", **kw)
    pp = DecodePool(net, name="port", **kw)
    pools += [jp, pp]
    return jp, pp


def _submit_all(pool, items):
    """Submit (sid, x, mask) steps together (so they can join one
    dispatch) and wait for every result."""
    futs = [pool.submit_step(sid, x, mask) for sid, x, mask in items]
    return [f.result(WAIT) for f in futs]


# ---------------------------------------------------------------------------
# the pool against JAX's pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_pool_matches_jax_token_by_token_while_sessions_join_and_leave(
        kind, zips, pools):
    """Stream 0 alone, stream 1 joins, stream 0 leaves and stream 2 takes
    its slot (which must show nothing of stream 0's carry): every output
    of every stream within 1e-5 of the JAX pool's."""
    jnet, path = zips[kind]
    jp, pp = both_pools(pools, jnet, port_of(path), min_batch=2,
                        max_wait_ms=20.0)
    x = tokens(3, 8, seed=1)
    sids = {p: [p.open_session()] for p in (jp, pp)}
    got = {p: [] for p in (jp, pp)}
    for p in (jp, pp):
        s = sids[p]
        for t in range(2):
            got[p] += _submit_all(p, [(s[0], x[0, t:t + 1], None)])
        s.append(p.open_session())
        for t in range(2, 5):
            got[p] += _submit_all(p, [(s[0], x[0, t:t + 1], None),
                                      (s[1], x[1, t - 2:t - 1], None)])
        p.close_session(s[0])
        s.append(p.open_session())
        for t in range(4):
            got[p] += _submit_all(p, [(s[1], x[1, t + 3:t + 4], None),
                                      (s[2], x[2, t:t + 1], None)])
    assert len(got[pp]) == len(got[jp]) == 16
    for a, b in zip(got[pp], got[jp]):
        for oa, ob in zip(a, b):
            np.testing.assert_allclose(oa, np.asarray(ob), rtol=TOL,
                                       atol=TOL)
    st = pp.stats()
    assert st["batch_size_hist"].get("2", 0) >= 5     # sessions joined
    assert st["decode_programs"] <= len(st["slot_ladder"])
    assert pp.active_sessions == 2 and st["slots_free"] == 2


@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_pool_matches_jax_in_chunks_with_masks(kind, zips, pools):
    """Prefill chunks of 3 and 5 steps (bucketed to 4 and 8: the pad
    steps are masked and carry the state through) and masked steps, two
    sessions joined: within 1e-5 of the JAX pool's outputs."""
    jnet, path = zips[kind]
    jp, pp = both_pools(pools, jnet, port_of(path), min_batch=2,
                        max_wait_ms=20.0)
    x = tokens(2, 12, seed=2)
    m = np.ones((2, 12), np.float32)
    m[0, 4] = m[1, 9:11] = 0.0
    cuts = [(0, 3), (3, 8), (8, 9), (9, 12)]
    for p in (jp, pp):
        p._outs = []
        s = [p.open_session(), p.open_session()]
        for a, b in cuts:
            p._outs += _submit_all(p, [(s[i], x[i, a:b], m[i, a:b])
                                       for i in range(2)])
    for a, b in zip(pp._outs, jp._outs):
        np.testing.assert_allclose(a[0], np.asarray(b[0]), rtol=TOL,
                                   atol=TOL)
    assert pp.stats()["tokens"] == 24


@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_pool_matches_rnn_time_step(kind, zips, pools):
    """The pool and the port's ``rnn_time_step`` run one seam
    (``_rnn_step_raw``): the same stream through both agrees to 1e-6."""
    _, path = zips[kind]
    net = port_of(path)
    pool = DecodePool(net, max_slots=2, max_wait_ms=0.5)
    pools.append(pool)
    x = tokens(1, 10, seed=3)
    sid = pool.open_session()
    got = np.concatenate([pool.step(sid, x[0, t:t + 1], timeout=WAIT)[0]
                          for t in range(10)])
    net.rnn_clear_previous_state()
    ref = []
    for t in range(10):
        out = net.rnn_time_step(x[:, t:t + 1])
        out = out[0] if isinstance(out, tuple) else out
        ref.append(out[0].numpy())
    np.testing.assert_allclose(got, np.concatenate(ref), rtol=SELF_TOL,
                               atol=SELF_TOL)


def test_bf16_pool_equals_rnn_time_step_at_every_joined_batch(zips, pools):
    """The char-RNN in bf16 served to 12 client threads that start at
    staggered times, one token a step, a third of them closing half-way
    and reopening: the joined batches range over the slot ladder, and
    every stream's outputs equal ``rnn_time_step`` of that stream alone,
    fed its tokens in one call, bit for bit.  On the CPU the arithmetic
    of a row does not depend on its batch, so this holds the pool's
    gather, fresh zeroing, casts and scatter to adding no rounding of
    their own, however sessions join."""
    _, path = zips["lstm_mln"]
    net = port_of(path)
    net.conf.global_conf.precision = "bfloat16"
    pool = DecodePool(net, max_slots=12, max_wait_ms=2.0)
    pools.append(pool)
    n, steps = 12, 12
    x = tokens(n, steps, seed=13)
    streams, errors = [], []

    def client(i):
        try:
            time.sleep(0.004 * i)
            cut = steps // 2 if i % 3 == 2 else steps
            for a, b in ((0, cut), (cut, steps)):
                if a == b:
                    continue
                sid = pool.open_session()
                out = [pool.step(sid, x[i, t:t + 1], timeout=WAIT)[0]
                       for t in range(a, b)]
                pool.close_session(sid)
                streams.append((x[i, a:b], np.concatenate(out)))
        except Exception as e:
            errors.append(repr(e))
    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert errors == [] and len(streams) == n + n // 3
    assert len(pool.stats()["batch_size_hist"]) >= 3
    f32 = port_of(path)
    for xs, got in streams:
        net.rnn_clear_previous_state()
        want = net.rnn_time_step(xs[None])[0].numpy()
        np.testing.assert_array_equal(got, want)
        f32.rnn_clear_previous_state()
        assert not np.array_equal(got, f32.rnn_time_step(xs[None])[0]
                                  .numpy())          # bf16 was in force


def test_manager_keys_pools_by_model_and_layout(zips, pools):
    """Two models of different carry layouts get two pools; a closed
    session's id is unknown afterwards; ``invalidate`` stops the pools."""
    cache = ModelCache(device="cpu")
    mgr = DecodeManager(cache, max_slots=2, max_wait_ms=0.5)
    pools.append(mgr)
    a = mgr.open_session(zips["lstm_mln"][1])
    b = mgr.open_session(zips["attention_mln"][1])
    x = tokens(1, 1, seed=4)[0]
    assert mgr.decode_step(a["session_id"], x)[0].shape == (1, V)
    assert mgr.decode_step(b["session_id"], x)[0].shape == (1, V)
    st = mgr.stats()
    assert len(st) == 2
    assert DecodeManager._carry_layout(port_of(zips["lstm_mln"][1])) != \
        DecodeManager._carry_layout(port_of(zips["attention_mln"][1]))
    assert mgr.close_session(a["session_id"])
    with pytest.raises(KeyError):
        mgr.decode_step(a["session_id"], x)
    assert mgr.invalidate() == 2
    with pytest.raises(KeyError):
        mgr.decode_step(b["session_id"], x)


# ---------------------------------------------------------------------------
# resilience: TTL, slot exhaustion, deadlines, stop, a killed thread
# ---------------------------------------------------------------------------

def _lstm_pool(zips, pools, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_wait_ms", 0.5)
    pool = DecodePool(port_of(zips["lstm_mln"][1]), **kw)
    pools.append(pool)
    return pool


def _closed(reason, model="default"):
    fam = monitor.get_registry().get("dl4j_decode_sessions_closed_total")
    return sum(s["value"] for s in fam.samples()
               if s["labels"] == {"model": model, "reason": reason}) \
        if fam else 0.0


def test_session_ttl_eviction(zips, pools):
    pool = _lstm_pool(zips, pools, ttl_s=0.15)
    before = _closed("ttl")
    sid = pool.open_session()
    pool.step(sid, tokens(1, 1)[0], timeout=WAIT)
    deadline = time.monotonic() + 5.0
    while pool.active_sessions and time.monotonic() < deadline:
        time.sleep(0.05)      # the idle pool thread sweeps on its own
    assert pool.active_sessions == 0
    assert _closed("ttl") == before + 1
    with pytest.raises(KeyError):
        pool.submit_step(sid, tokens(1, 1)[0])
    assert pool.open_session()


def test_slot_exhaustion_raises_overloaded(zips, pools):
    pool = _lstm_pool(zips, pools)
    pool.open_session()
    pool.open_session()
    with pytest.raises(OverloadedError) as ei:
        pool.open_session(retry_after_s=3.0)
    assert ei.value.retry_after_s == 3.0
    shed = [e for e in events.get_journal().tail(etype="request.shed")
            if e.get("reason") == "decode_slots_full"]
    assert shed


def test_deadline_shed_before_compute(zips, pools):
    pool = _lstm_pool(zips, pools)
    sid = pool.open_session()
    pool.step(sid, tokens(1, 1)[0], timeout=WAIT)
    faults.arm({"site": "decode.step", "mode": "latency",
                "latency_ms": 300, "probability": 1.0, "max_injections": 1})
    try:
        slow = pool.submit_step(sid, tokens(1, 1)[0])
        time.sleep(0.05)
        fut = pool.submit_step(sid, tokens(1, 1)[0], timeout_ms=1.0)
        with pytest.raises(DeadlineExceededError):
            fut.result(WAIT)
        slow.result(WAIT)
        assert pool.stats()["steps"] == 2     # the shed step never ran
    finally:
        faults.reset()


def test_stop_fails_queued_work_and_sessions(zips, pools):
    """``stop`` fails the steps still queued behind a slow dispatch (the
    one in flight lands), closes every session and refuses new work."""
    pool = _lstm_pool(zips, pools)
    sid = pool.open_session()
    pool.step(sid, tokens(1, 1)[0], timeout=WAIT)
    faults.arm({"site": "decode.step", "mode": "latency",
                "latency_ms": 400, "probability": 1.0, "max_injections": 1})
    try:
        slow = pool.submit_step(sid, tokens(1, 1)[0])
        time.sleep(0.05)
        queued = pool.submit_step(sid, tokens(1, 1)[0])  # same stream
        pool.stop(timeout=0.01)
        with pytest.raises(RuntimeError, match="stopped"):
            queued.result(WAIT)
        slow.result(WAIT)
    finally:
        faults.reset()
    with pytest.raises(RuntimeError):
        pool.submit_step(sid, tokens(1, 1)[0])
    assert pool.active_sessions == 0
    pool._thread.join(WAIT)


def test_killed_thread_fails_sessions_cleanly_and_recovers(zips, pools):
    """``decode.step`` ``kill``: the in-flight session fails with a clear
    error (no hang), every slot is reclaimed, the death is journaled and
    dumped, and the next submit restarts the thread with a fresh pool."""
    pool = _lstm_pool(zips, pools)
    sid = pool.open_session()
    other = pool.open_session()
    pool.step(sid, tokens(1, 1, seed=9)[0], timeout=WAIT)
    faults.arm({"site": "decode.step", "mode": "kill", "probability": 1.0,
                "max_injections": 1})
    try:
        with events.request_scope() as rid:
            fut = pool.submit_step(sid, tokens(1, 1, seed=10)[0])
        with pytest.raises(RuntimeError, match="batcher thread died"):
            fut.result(WAIT)
    finally:
        faults.reset()
    deadline = time.monotonic() + 10
    while pool.thread_alive and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pool.deaths == 1 and pool.active_sessions == 0
    assert pool.stats()["slots_free"] == 2
    with pytest.raises(KeyError):
        pool.submit_step(other, tokens(1, 1)[0])
    died = [e for e in events.get_journal().tail(etype="decode.died")
            if rid in (e.get("request_ids") or ())]
    assert died and sid in died[-1]["session_ids"]
    sid2 = pool.open_session()
    (o,) = pool.step(sid2, tokens(1, 1, seed=11)[0], timeout=WAIT)
    assert o.shape == (1, V) and np.isfinite(o).all()
    assert pool.restarts == 1


def test_step_events_carry_session_slot_tenant_and_request(zips, pools):
    pool = _lstm_pool(zips, pools, name="evpool")
    with events.request_scope(tenant="acme") as rid:
        sid = pool.open_session(tenant="acme")
        pool.step(sid, tokens(1, 3)[0], timeout=WAIT)
    opened = [e for e in events.get_journal().tail(
        etype="decode.session_opened") if e.get("session_id") == sid]
    steps = [e for e in events.get_journal().tail(etype="decode.step")
             if e.get("session_id") == sid]
    assert opened[-1]["tenant"] == "acme"
    assert steps[-1]["slot"] == opened[-1]["slot"]
    assert steps[-1]["request_id"] == rid and steps[-1]["tokens"] == 3
    fam = monitor.get_registry().get("dl4j_decode_tokens_total")
    assert fam.label_names == ("model", "tenant")
    assert {tuple(s["labels"].items()): s["value"] for s in fam.samples()}[
        (("model", "evpool"), ("tenant", "acme"))] >= 3


def test_export_limbo_spares_ttl_and_reinstates(zips, pools):
    pool = _lstm_pool(zips, pools, ttl_s=0.05)
    x = tokens(1, 4, seed=12)[0]
    sid = pool.open_session()
    pool.step(sid, x[:2], timeout=WAIT)
    payload = pool.export_session(sid, timeout=WAIT)
    time.sleep(0.15)
    assert pool.sweep() == 0 and pool.held_slots == 1
    assert pool.stats()["exporting"] == 1 and pool.active_sessions == 0
    from deeplearning4j_tpu_torch.resilience.errors import TransientError
    with pytest.raises(TransientError):
        pool.submit_step(sid, x[2:3])
    assert pool.finish_export(sid, ok=False)
    (a,) = pool.step(sid, x[2:3], timeout=WAIT)
    assert payload["steps"] == 1 and np.isfinite(a).all()


# ---------------------------------------------------------------------------
# the gateway's decode RPCs over HTTP, against JAX's gateway
# ---------------------------------------------------------------------------

def _post(url, obj):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


@pytest.mark.parametrize("kind", ["lstm_mln", "attention_mln"])
def test_gateway_decode_rpcs_match_jax_gateway(kind, zips, pools):
    _, path = zips[kind]
    jep = JaxEntryPoint(decode_slots=2, decode_max_wait_ms=0.5)
    ep = DeepLearning4jEntryPoint(device="cpu", decode_slots=2,
                                  decode_max_wait_ms=0.5)
    server = Server(ep, port=0).start()
    pools += [jep, server]
    base = f"http://{server.host}:{server.port}"
    x = tokens(1, 6, seed=13)[0]
    code, body, _ = _post(base + "/", {"method": "open_session",
                                       "params": {"model_path": path}})
    assert code == 200 and body["result"]["slots"] == 2, body
    sid = body["result"]["session_id"]
    jsid = jep.open_session(path)["session_id"]
    for t in range(6):
        code, body, _ = _post(base + "/", {
            "method": "decode_step",
            "params": {"session_id": sid, "features": x[t:t + 1].tolist()}})
        assert code == 200, body
        want = jep.decode_step(jsid, x[t:t + 1].tolist())
        np.testing.assert_allclose(
            np.asarray(body["result"]["predictions"], np.float32),
            np.asarray(want["predictions"], np.float32), rtol=TOL, atol=TOL)
        assert body["result"]["shape"] == want["shape"]
    code, body, _ = _post(base + "/", {
        "method": "decode_step", "params": {
            "session_id": sid, "features": x[:1].tolist(),
            "argmax_only": True}})
    want = jep.decode_step(jsid, x[:1].tolist(), argmax_only=True)
    assert body["result"]["classes"] == want["classes"]
    code, body, _ = _post(base + "/", {"method": "decode_stats",
                                       "params": {}})
    (st,) = body["result"].values()
    assert st["steps"] == 7 and st["tokens"] == 7
    code, body, _ = _post(base + "/", {"method": "close_session",
                                       "params": {"session_id": sid}})
    assert code == 200 and body["result"]["closed"] is True
    assert jep.close_session(jsid)["closed"] is True


def test_gateway_overload_503_retry_after_drain_and_invalidate(zips, pools):
    path = zips["lstm_mln"][1]
    ep = DeepLearning4jEntryPoint(device="cpu", decode_slots=1,
                                  retry_after_s=2.0)
    server = Server(ep, port=0).start()
    pools.append(server)
    base = f"http://{server.host}:{server.port}"
    code, body, _ = _post(base + "/", {"method": "open_session",
                                       "params": {"model_path": path}})
    assert code == 200
    sid = body["result"]["session_id"]
    code, body, headers = _post(base + "/", {
        "method": "open_session", "params": {"model_path": path}})
    assert code == 503 and headers.get("Retry-After") == "2"
    assert body["retry_after_s"] == 2.0
    assert "OverloadedError" in body["error"]
    code, body, _ = _post(base + "/", {"method": "drain",
                                       "params": {"deadline_ms": 1}})
    assert code == 200 and body["result"]["draining"] is True
    (pool_state,) = body["result"]["pools"].values()
    assert pool_state["remaining"] == [sid]
    code, body, headers = _post(base + "/", {
        "method": "open_session", "params": {"model_path": path}})
    assert code == 503 and headers.get("Retry-After")
    _post(base + "/", {"method": "undrain", "params": {}})
    code, body, _ = _post(base + "/", {"method": "invalidate",
                                       "params": {"model_path": path}})
    assert code == 200
    code, body, _ = _post(base + "/", {
        "method": "decode_step", "params": {
            "session_id": sid, "features": tokens(1, 1)[0].tolist()}})
    assert code == 500 and "KeyError" in body["error"]
    code, body, _ = _post(base + "/", {"method": "open_session",
                                       "params": {"model_path": path}})
    assert code == 200
