"""Deterministic fault injection — reproducible chaos for CI.  A copy of
``deeplearning4j_tpu/resilience/faults.py`` (pure Python): the same plan
injects on the same calls in both packages; injections are counted in the
port's own metrics registry and event journal.

Production code is instrumented with named **sites**::

    reader.next_raw      input-pipeline feeder, before each raw pull
    cache.load           ModelCache, around the checkpoint load
    batcher.compute      MicroBatcher, before the jitted inference call
    checkpoint.write     CheckpointListener, before a checkpoint save
    gateway.predict      gateway entry point, on each predict request
    decode.step          DecodePool batcher, before each decode dispatch
    fleet.migrate        DecodePool batcher, before each session
                         export/import control op (a kill here is a
                         replica dying mid-migration)
    dist.worker          elastic worker, before each cluster step's
                         local gradient compute (a kill here is a
                         worker preempted mid-epoch)
    dist.heartbeat       elastic worker heartbeat loop, each tick (a
                         kill makes a zombie: the step loop lives but
                         the lease lapses and the coordinator evicts)

Each instrumented point calls :func:`check(site)`; with nothing armed
that is a single attribute read.  A :class:`FaultPlan` armed at a site
(via :func:`arm`, or the ``DL4J_FAULT_PLAN`` env var carrying one JSON
plan or a list of them) decides per call whether to inject:

* ``mode="fail"`` — raise ``exc`` (default :class:`TransientError`, so
  retry policies engage; use ``"RuntimeError"`` for a non-retryable
  crash);
* ``mode="latency"`` — sleep ``latency_ms`` (tail-latency chaos);
* ``mode="kill"`` — raise :class:`ThreadKill` (a ``BaseException`` that
  sails past ``except Exception`` handlers — how tests kill a worker
  thread deterministically).

Determinism: ``on_call=n`` fires on exactly the n-th check (1-based,
counted from arming) and ``probability=p`` draws from a
``random.Random(seed)`` private to the plan — the injection sequence is
a pure function of the plan, so a chaos test replays identically in CI.
Injections are counted in ``dl4j_resilience_faults_injected_total{site=}``.

Example ``DL4J_FAULT_PLAN``::

    [{"site": "reader.next_raw", "mode": "fail", "probability": 0.01,
      "seed": 7, "exc": "TransientError"},
     {"site": "cache.load", "mode": "latency", "latency_ms": 50,
      "probability": 0.01, "seed": 11}]
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Dict, List, Optional, Union

from deeplearning4j_tpu_torch.resilience.errors import TransientError

# The instrumented sites (docs/RESILIENCE.md keeps the prose catalog).
SITES = ("reader.next_raw", "cache.load", "batcher.compute",
         "checkpoint.write", "gateway.predict", "decode.step",
         "fleet.migrate", "dist.worker", "dist.heartbeat")

ENV_VAR = "DL4J_FAULT_PLAN"


class ThreadKill(BaseException):
    """Deliberately NOT an Exception: escapes ``except Exception``
    blocks so an armed ``mode="kill"`` plan takes down the target
    thread the way a segfaulting dependency or ``kill -9``'d helper
    would — the failure the dead-thread recovery paths exist for."""


_EXC_BY_NAME = {
    "TransientError": TransientError,
    "RuntimeError": RuntimeError,
    "ConnectionError": ConnectionError,
    "TimeoutError": TimeoutError,
    "OSError": OSError,
    "IOError": OSError,
    "ValueError": ValueError,
}


class FaultPlan:
    """One armed fault: where (``site``), what (``mode``), when
    (``on_call`` exact n-th check, and/or seeded ``probability`` per
    check), bounded by ``max_injections``."""

    def __init__(self, site: str, mode: str = "fail",
                 on_call: Optional[int] = None, probability: float = 0.0,
                 seed: int = 0, latency_ms: float = 0.0,
                 exc: str = "TransientError", message: Optional[str] = None,
                 max_injections: Optional[int] = None):
        if mode not in ("fail", "latency", "kill"):
            raise ValueError(f"unknown fault mode {mode!r}")
        if exc not in _EXC_BY_NAME:
            raise ValueError(f"unknown exc {exc!r}; one of "
                             f"{sorted(_EXC_BY_NAME)}")
        self.site = str(site)
        self.mode = mode
        self.on_call = None if on_call is None else int(on_call)
        self.probability = min(1.0, max(0.0, float(probability)))
        self.seed = int(seed)
        self.latency_ms = max(0.0, float(latency_ms))
        self.exc_name = exc
        self.message = message
        self.max_injections = (None if max_injections is None
                               else int(max_injections))
        self.injected = 0
        self._rng = random.Random(self.seed)

    @staticmethod
    def from_dict(d: dict) -> "FaultPlan":
        return FaultPlan(**d)

    def to_dict(self) -> dict:
        return {"site": self.site, "mode": self.mode,
                "on_call": self.on_call, "probability": self.probability,
                "seed": self.seed, "latency_ms": self.latency_ms,
                "exc": self.exc_name, "max_injections": self.max_injections,
                "injected": self.injected}

    def _should_inject(self, call_idx: int) -> bool:
        if (self.max_injections is not None
                and self.injected >= self.max_injections):
            return False
        if self.on_call is not None:
            return call_idx == self.on_call
        if self.probability > 0.0:
            # one deterministic draw per check, even when a prior plan
            # already injected — the sequence depends only on the seed
            # and call index, never on sibling plans
            return self._rng.random() < self.probability
        return False

    def _inject(self, site: str) -> None:
        _count_injection(site, self.mode)
        if self.mode == "latency":
            time.sleep(self.latency_ms / 1e3)
            return
        msg = self.message or (f"injected fault at {site} "
                               f"(call #{_CALLS.get(site, 0)})")
        if self.mode == "kill":
            raise ThreadKill(msg)
        raise _EXC_BY_NAME[self.exc_name](msg)


_LOCK = threading.RLock()
_PLANS: Dict[str, List[FaultPlan]] = {}
_CALLS: Dict[str, int] = {}
_ACTIVE = False          # fast-path guard: check() is one read when off
_ENV_LOADED = False


def _count_injection(site: str, mode: str) -> None:
    try:
        from deeplearning4j_tpu_torch import monitor
        monitor.get_registry().counter(
            "dl4j_resilience_faults_injected_total",
            "faults injected by armed fault plans",
            labels=("site", "mode")).labels(site=site, mode=mode).inc()
        # journaled with the trace context of the injected call — the
        # flight-recorder dump of a chaos kill names the request it hit
        monitor.events.emit("fault.injected", severity="warn",
                            site=site, mode=mode)
    except Exception:
        pass  # chaos must not die on telemetry


def _load_env_locked() -> None:
    global _ENV_LOADED
    if _ENV_LOADED:
        return
    _ENV_LOADED = True
    raw = os.environ.get(ENV_VAR)
    if not raw:
        return
    spec = json.loads(raw)
    for d in (spec if isinstance(spec, list) else [spec]):
        _arm_locked(FaultPlan.from_dict(d))


def _arm_locked(plan: FaultPlan) -> FaultPlan:
    global _ACTIVE
    _PLANS.setdefault(plan.site, []).append(plan)
    _CALLS.setdefault(plan.site, 0)
    _ACTIVE = True
    return plan


def arm(plan: Union[FaultPlan, dict, str]) -> FaultPlan:
    """Arm a plan (a :class:`FaultPlan`, a plan dict, or its JSON).
    Call counting at the plan's site starts at the first :func:`check`
    after arming."""
    if isinstance(plan, str):
        plan = json.loads(plan)
    if isinstance(plan, dict):
        plan = FaultPlan.from_dict(plan)
    with _LOCK:
        _load_env_locked()
        return _arm_locked(plan)


def disarm(site: Optional[str] = None) -> int:
    """Remove armed plans for ``site`` (or every site when None).
    Returns how many plans were dropped.  Call counters survive until
    :func:`reset`."""
    global _ACTIVE
    with _LOCK:
        if site is None:
            n = sum(len(v) for v in _PLANS.values())
            _PLANS.clear()
        else:
            n = len(_PLANS.pop(site, []))
        _ACTIVE = bool(_PLANS)
        return n


def reset() -> None:
    """Disarm everything and zero call counters (test isolation).  The
    env var is re-read on the next :func:`check`/:func:`arm`."""
    global _ACTIVE, _ENV_LOADED
    with _LOCK:
        _PLANS.clear()
        _CALLS.clear()
        _ACTIVE = False
        _ENV_LOADED = False


def call_count(site: str) -> int:
    with _LOCK:
        return _CALLS.get(site, 0)


def armed(site: Optional[str] = None) -> List[dict]:
    """Introspection: the armed plans (for ``site`` or all)."""
    with _LOCK:
        plans = (_PLANS.get(site, []) if site is not None
                 else [p for ps in _PLANS.values() for p in ps])
        return [p.to_dict() for p in plans]


def check(site: str) -> None:
    """The instrumentation hook.  Cheap when nothing is armed; with
    plans armed at ``site``, bumps the site's call counter and lets each
    plan (in arming order) inject — a latency plan delays and falls
    through, a fail/kill plan raises."""
    if not _ACTIVE and _ENV_LOADED:
        return
    with _LOCK:
        _load_env_locked()
        plans = _PLANS.get(site)
        if not plans:
            return
        _CALLS[site] = idx = _CALLS.get(site, 0) + 1
        due = []
        for p in plans:
            if p._should_inject(idx):
                p.injected += 1  # counted under the lock so
                due.append(p)    # max_injections can't over-fire
    for p in due:
        p._inject(site)
