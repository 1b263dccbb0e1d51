"""The port's event journal, flight recorder and fault injection
(``monitor/events.py``, ``monitor/flight.py``, ``resilience/faults.py``,
copies of the JAX package's modules), and the micro-batcher and gateway
hooks that use them, held against the JAX package on the CPU.

* A fault plan injects on exactly the calls where the JAX package's same
  plan does (the plan's private ``random.Random(seed)``), mode for mode.
* The journal's events, scopes and Chrome export are the JAX module's:
  the same calls give the same event dicts (timestamps and thread ids
  aside) and the same trace structure.
* The micro-batcher's cases of ``tests/test_resilience.py`` and
  ``tests/test_events.py``: a killed batcher thread fails its requests
  promptly and restarts on the next submit, writing a flight dump that
  names the stranded request; deadline shedding is counted; one request id
  joins the gateway's admission, the coalesced batch and the response.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.monitor import events as jax_events
from deeplearning4j_tpu.resilience import faults as jax_faults
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.models import lenet
from deeplearning4j_tpu_torch.monitor import events, flight
from deeplearning4j_tpu_torch.nn.serialization import write_model
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.resilience.errors import (
    DeadlineExceededError, TransientError)
from deeplearning4j_tpu_torch.resilience.faults import FaultPlan, ThreadKill
from deeplearning4j_tpu_torch.server import (
    DeepLearning4jEntryPoint, MicroBatcher, Server)


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """Each test: its own flight dir without rate limiting, and no fault
    plan left armed in either package."""
    monkeypatch.setenv("DL4J_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("DL4J_FLIGHT_MIN_INTERVAL_S", "0")
    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()
    events.set_enabled(None)


def _post(url, obj, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


# ---------------------------------------------------------------------------
# fault plans: the same plan injects on the same calls in both packages
# ---------------------------------------------------------------------------

def _injections(mod, plans, n=60, site="decode.step"):
    """Arm ``plans`` in ``mod`` and record, call by call, which exception
    type ``check`` raised (or None)."""
    mod.reset()
    for p in plans:
        mod.arm(dict(p))
    seq = []
    for _ in range(n):
        try:
            mod.check(site)
            seq.append(None)
        except BaseException as e:  # ThreadKill is a BaseException
            seq.append(type(e).__name__)
    return seq, mod.call_count(site), [p["injected"] for p in mod.armed(site)]


@pytest.mark.parametrize("plans", [
    [{"site": "decode.step", "mode": "fail", "on_call": 7}],
    [{"site": "decode.step", "mode": "fail", "probability": 0.3, "seed": 9}],
    [{"site": "decode.step", "mode": "fail", "probability": 0.4, "seed": 3,
      "max_injections": 4, "exc": "RuntimeError"}],
    [{"site": "decode.step", "mode": "kill", "probability": 0.2, "seed": 11,
      "max_injections": 2}],
    [{"site": "decode.step", "mode": "latency", "latency_ms": 0,
      "probability": 0.5, "seed": 5},
     {"site": "decode.step", "mode": "fail", "probability": 0.1, "seed": 6,
      "exc": "ConnectionError"}],
], ids=["on_call", "probability", "bounded", "kill", "two_plans"])
def test_fault_plan_injects_on_the_same_calls_as_jax(plans):
    got = _injections(faults, plans)
    want = _injections(jax_faults, plans)
    assert got == want
    assert any(s is not None for s in got[0]) or plans[0]["mode"] == "latency"


def test_fault_env_plan_and_validation(monkeypatch):
    plan = [{"site": "batcher.compute", "mode": "fail", "on_call": 1,
             "exc": "TransientError"}]
    monkeypatch.setenv(faults.ENV_VAR, json.dumps(plan))
    faults.reset()             # the env is read again on the next check
    with pytest.raises(TransientError):
        faults.check("batcher.compute")
    faults.check("batcher.compute")
    assert faults.call_count("batcher.compute") == 2
    monkeypatch.delenv(faults.ENV_VAR)
    faults.reset()
    with pytest.raises(ValueError):
        FaultPlan("x", mode="explode")
    with pytest.raises(ValueError):
        FaultPlan("x", exc="SegFault")
    assert faults.SITES == jax_faults.SITES
    assert issubclass(ThreadKill, BaseException) and \
        not issubclass(ThreadKill, Exception)


def test_fault_injection_is_journaled_and_counted():
    faults.arm({"site": "gateway.predict", "mode": "fail", "on_call": 1})
    with events.scope(request_id="faultrid1"):
        with pytest.raises(TransientError):
            faults.check("gateway.predict")
    ev = events.get_journal().tail(request_id="faultrid1",
                                   etype="fault.injected")
    assert ev and ev[-1]["site"] == "gateway.predict"
    fam = monitor.get_registry().get("dl4j_resilience_faults_injected_total")
    assert any(s["labels"] == {"site": "gateway.predict", "mode": "fail"}
               and s["value"] >= 1 for s in fam.samples())


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------

def _strip(evs):
    return [{k: v for k, v in e.items() if k not in ("ts", "tid")}
            for e in evs]


def _journal_script(mod):
    """The same calls on one package's module -> its journal tail."""
    j = mod.EventJournal(capacity=16)
    with mod.scope(request_id="outer", tenant="t1"):
        for i in range(20):
            j.emit("request.done", severity="warn" if i % 3 else "info",
                   rows=i, skip=None)
        with mod.scope(request_id="inner", extra=None):
            j.emit("decode.step", session_id="s1", slot=3)
    return j, j.tail()


def test_journal_matches_jax_module():
    j, got = _journal_script(events)
    jj, want = _journal_script(jax_events)
    assert _strip(got) == _strip(want)
    assert (j.total_emitted, j.dropped) == (jj.total_emitted, jj.dropped) \
        == (21, 5)
    assert _strip(j.tail(n=3, severity="warn")) == \
        _strip(jj.tail(n=3, severity="warn"))
    assert _strip(j.tail(request_id="inner")) == \
        _strip(jj.tail(request_id="inner"))
    assert events.EVENT_TYPES == jax_events.EVENT_TYPES


def test_journal_kill_switch_scopes_and_threads(monkeypatch):
    j = events.EventJournal(capacity=16)
    events.set_enabled(False)
    assert j.emit("request.done") is None and j.total_emitted == 0
    events.set_enabled(None)
    monkeypatch.setenv("DL4J_JOURNAL", "0")
    events.set_enabled(None)
    assert not events.enabled()
    monkeypatch.delenv("DL4J_JOURNAL")
    events.set_enabled(None)
    assert j.emit("request.done").seq == 1
    seen = {}
    with events.scope(request_id="outer", tenant="t1"):
        with events.request_scope(tenant="t2") as rid:
            assert rid == "outer"            # continues, does not re-mint
            assert events.current_context()["tenant"] == "t2"

        def worker():
            seen["ctx"] = events.current_context()
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    assert seen["ctx"] == {}                 # threads inherit nothing
    assert events.current_context() == {}


def test_chrome_trace_matches_jax_structure():
    raw = [{"type": "span.close", "severity": "info", "ts": 100.5,
            "tid": 7, "span": "serve/decode", "phase": "compute",
            "duration_s": 0.25, "request_id": "r1", "seq": 1},
           {"type": "decode.step", "severity": "info", "ts": 101.0,
            "tid": 7, "session_id": "s", "seq": 2}]
    got, want = events.chrome_trace(raw), jax_events.chrome_trace(raw)
    strip = lambda tr: [{k: v for k, v in e.items() if k not in ("pid",)}
                        for e in tr["traceEvents"] if e["ph"] != "M"]
    assert strip(got) == strip(want)
    x = [e for e in got["traceEvents"] if e["ph"] == "X"][0]
    assert x["name"] == "serve/decode/compute" and x["dur"] == 250000.0
    fleet = events.chrome_trace_fleet({"a": raw, "b": raw[1:]},
                                      request_id="r1")
    assert [e["pid"] for e in fleet["traceEvents"] if e["ph"] == "X"] == [1]
    json.dumps(got)


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------

def test_flight_dump_contents_rate_limit_and_kill_switch(monkeypatch):
    with events.scope(request_id="flightrid"):
        events.emit("decode.died", severity="error", model="m")
        path = flight.dump("unit_reason", extra={"k": 1})
    assert path and flight.list_dumps()[-1] == path
    with open(path) as f:
        payload = json.load(f)
    assert payload["reason"] == "unit_reason" and payload["schema"] == 1
    assert payload["context"]["request_id"] == "flightrid"
    assert payload["extra"] == {"k": 1}
    assert "decode.died" in {e["type"] for e in payload["events"]}
    assert "dl4j_journal_events_total" in payload["registry"]
    monkeypatch.setenv("DL4J_FLIGHT_MIN_INTERVAL_S", "3600")
    assert flight.dump("limited_reason") is not None
    assert flight.dump("limited_reason") is None
    assert flight.dump("limited_reason", force=True) is not None
    monkeypatch.setenv("DL4J_FLIGHT", "0")
    assert flight.dump("limited_reason", force=True) is None


# ---------------------------------------------------------------------------
# the micro-batcher's hooks (tests/test_resilience.py, tests/test_events.py)
# ---------------------------------------------------------------------------

def test_batcher_thread_death_fails_pending_and_restarts():
    mb = MicroBatcher(lambda x: x * 2, max_batch=8, name="port-death")
    try:
        assert np.allclose(mb.predict(np.ones((2, 3)), timeout=10), 2.0)
        faults.arm({"site": "batcher.compute", "mode": "kill", "on_call": 1})
        dying = mb._thread
        with events.request_scope() as rid:
            fut = mb.submit(np.ones((1, 3)))
        with pytest.raises(RuntimeError, match="died"):
            fut.result(timeout=10)
        dying.join(10)      # its crash handler journals and dumps last
        assert not dying.is_alive() and mb.deaths == 1
        faults.reset()
        out = mb.predict(np.ones((3, 3)), timeout=10)
        assert np.allclose(out, 2.0)
        assert mb.restarts == 1 and mb.thread_alive
        died = [e for e in events.get_journal().tail(etype="batcher.died")
                if rid in (e.get("request_ids") or ())]
        assert died and died[-1]["severity"] == "error"
        injected = [e for e in events.get_journal().tail(
            etype="fault.injected") if rid in (e.get("request_ids") or ())]
        assert injected and injected[-1]["site"] == "batcher.compute"
        with open(flight.list_dumps()[-1]) as f:
            dump = json.load(f)
        assert dump["reason"] == "batcher_died"
        assert rid in dump["extra"]["stranded_request_ids"]
        assert {"fault.injected", "batcher.died"} <= \
            {e["type"] for e in dump["events"]}
        assert events.get_journal().tail(etype="batcher.restarted")
    finally:
        mb.stop()


def test_batcher_death_fails_every_shape_group_of_its_take():
    """Two row shapes taken in one batch run as two groups; a kill at the
    first group's compute fails the second group's request as well,
    which is neither queued nor running at that moment, instead of
    leaving it to hang."""
    def slow(x):
        time.sleep(0.15)
        return x
    mb = MicroBatcher(slow, max_batch=8, name="port-groups")
    try:
        faults.arm({"site": "batcher.compute", "mode": "kill", "on_call": 2})
        first = mb.submit(np.ones((1, 3)))      # call 1: holds the thread
        time.sleep(0.03)
        a = mb.submit(np.ones((1, 3)))          # one take, two groups:
        b = mb.submit(np.ones((1, 4)))          # call 2 kills on the first
        assert np.allclose(first.result(timeout=10), 1.0)
        for fut in (a, b):
            with pytest.raises(RuntimeError, match="died"):
                fut.result(timeout=10)
        faults.reset()
        assert np.allclose(mb.predict(np.ones((2, 4)), timeout=10), 1.0)
        assert mb.deaths == 1 and mb.restarts == 1
    finally:
        faults.reset()
        mb.stop()


def test_batcher_deadline_shed_before_compute_accounting():
    def slow(x):
        time.sleep(0.15)
        return x
    mb = MicroBatcher(slow, max_batch=4, name="port-shed")
    fam = monitor.get_registry().counter(
        "dl4j_resilience_shed_total", "requests shed instead of served",
        labels=("reason",))

    def shed_count():
        return {tuple(s["labels"].items()): s["value"]
                for s in fam.samples()}.get((("reason", "deadline"),), 0)
    try:
        before = shed_count()
        mb.submit(np.ones((1, 3)))           # holds the thread ~150 ms
        time.sleep(0.03)
        doomed = mb.submit(np.ones((1, 3)), timeout_ms=40)
        ok = mb.submit(np.ones((1, 3)))
        with pytest.raises(DeadlineExceededError):
            doomed.result(timeout=10)
        assert np.allclose(ok.result(timeout=10), 1.0)
        assert mb.metrics.snapshot()["shed"] == {"deadline": 1}
        assert shed_count() == before + 1
        assert events.get_journal().tail(etype="request.shed")[-1][
            "reason"] == "deadline"
    finally:
        mb.stop()


@pytest.fixture
def lenet_zip(tmp_path):
    net = lenet(device="cpu").init(generator=torch.Generator().manual_seed(4))
    path = tmp_path / "lenet.zip"
    write_model(net, path)
    return str(path)


def test_gateway_request_id_joins_admission_batch_and_response(lenet_zip):
    server = Server(DeepLearning4jEntryPoint(device="cpu", max_batch=8),
                    port=0).start()
    base = f"http://{server.host}:{server.port}"
    x = np.random.default_rng(0).normal(size=(2, 1, 28, 28)).tolist()
    try:
        code, body, headers = _post(base + "/", {
            "method": "predict", "params": {"model_path": lenet_zip,
                                            "features": x,
                                            "tenant": "acme"}})
        assert code == 200, body
        rid = body["request_id"]
        assert rid and headers.get("X-DL4J-Request-ID") == rid
        tail = events.get_journal().tail(request_id=rid)
        types = [e["type"] for e in tail]
        for want in ("rpc.request", "request.admitted", "batch.dispatch",
                     "rpc.response"):
            assert want in types, (want, types)
        assert rid in [e for e in tail if e["type"] == "batch.dispatch"][
            -1]["request_ids"]
        assert [e for e in tail if e["type"] == "rpc.request"][-1][
            "tenant"] == "acme"
        # an upstream id is adopted
        code, body, headers = _post(base + "/", {
            "method": "healthz", "params": {}},
            headers={"X-DL4J-Request-ID": "upstream-7"})
        assert code == 200 and body["request_id"] == "upstream-7"
    finally:
        server.stop()


def test_gateway_predict_fault_site_fails_one_request(lenet_zip):
    server = Server(DeepLearning4jEntryPoint(device="cpu", max_batch=8),
                    port=0).start()
    base = f"http://{server.host}:{server.port}"
    x = np.random.default_rng(1).normal(size=(1, 1, 28, 28)).tolist()
    try:
        faults.arm({"site": "gateway.predict", "mode": "fail",
                    "on_call": 1})
        code, body, _ = _post(base + "/", {
            "method": "predict", "params": {"model_path": lenet_zip,
                                            "features": x}})
        assert code == 500 and body["error"].startswith("TransientError")
        rid = body["request_id"]
        resp = [e for e in events.get_journal().tail(
            request_id=rid, etype="rpc.response")]
        assert resp and resp[-1]["code"] == 500
        code, body, _ = _post(base + "/", {
            "method": "predict", "params": {"model_path": lenet_zip,
                                            "features": x}})
        assert code == 200 and np.asarray(body["result"]["predictions"]) \
            .shape == (1, 10)
    finally:
        server.stop()
