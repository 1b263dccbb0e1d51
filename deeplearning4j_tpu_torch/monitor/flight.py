"""Black-box flight recorder — post-mortem state for crashes that
aggregate metrics can't explain.  A copy of
``deeplearning4j_tpu/monitor/flight.py`` (pure Python), over the port's
journal and registry.

When something dies (a killed micro-batcher or decode thread, a
:class:`SanitizerError`, a resume-from-checkpoint after a crash, the
gateway's ``/readyz`` flipping to not-ready), :func:`dump` writes a
timestamped JSON file capturing the last-N structured journal events
(``monitor/events.py`` — what happened in the seconds before, with
request/session correlation IDs), a full metrics-registry snapshot
(what the counters said at that instant), and the caller's extra
context.  The file is the serving analog of a core dump: small, always
writable, and readable without the process that produced it.

Files land under ``DL4J_FLIGHT_DIR`` (default ``dl4j_flight/`` in the
working directory) as ``flight_<reason>_<UTC timestamp>_<pid>_<n>.json``
written atomically (tmp + rename).  Dumps are rate-limited per reason
(``DL4J_FLIGHT_MIN_INTERVAL_S``, default 5s) so a crash loop cannot
fill the disk; ``force=True`` bypasses the limit.  ``DL4J_FLIGHT=0``
disables dumping entirely.  Every dump is itself journaled
(``flight.dump``) and counted (``dl4j_flight_dumps_total{reason=}``).

Live access without a crash: the gateway's ``GET /trace`` endpoint and
``trace_dump`` RPC serve the same journal tail (and its Chrome
trace-event export) over HTTP — docs/OBSERVABILITY.md "Tracing &
flight recorder".
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional

from deeplearning4j_tpu_torch.monitor import events

DEFAULT_DIR = "dl4j_flight"
DEFAULT_MIN_INTERVAL_S = 5.0
DEFAULT_LAST_N = 512

_lock = threading.Lock()
_last_dump = {}   # reason -> monotonic time of last dump
_dump_count = 0


def enabled() -> bool:
    return os.environ.get("DL4J_FLIGHT", "1") != "0"


def flight_dir() -> str:
    return os.environ.get("DL4J_FLIGHT_DIR", DEFAULT_DIR)


def _min_interval_s() -> float:
    try:
        return float(os.environ.get("DL4J_FLIGHT_MIN_INTERVAL_S",
                                    str(DEFAULT_MIN_INTERVAL_S)))
    except ValueError:
        return DEFAULT_MIN_INTERVAL_S


def _count_dump(reason: str) -> None:
    try:
        from deeplearning4j_tpu_torch.monitor.registry import get_registry
        get_registry().counter(
            "dl4j_flight_dumps_total",
            "flight-recorder dump files written, by trigger",
            labels=("reason",)).labels(reason=reason).inc()
    except Exception:
        pass


def dump(reason: str, extra: Optional[dict] = None,
         last_n: int = DEFAULT_LAST_N, force: bool = False,
         directory: Optional[str] = None) -> Optional[str]:
    """Write one flight-recorder file and return its path (None when
    disabled, rate-limited, or the write itself failed — a recorder
    must never take the crashing process further down).

    The payload schema (versioned, docs/OBSERVABILITY.md):

    * ``reason`` / ``time`` / ``unix_ts`` / ``pid`` — what and when;
    * ``context`` — the trace context of the dumping thread (request
      ID, session ID, tenant when the crash happened on a request);
    * ``events`` — the newest ``last_n`` journal events, oldest-first;
    * ``registry`` — the full metrics-registry snapshot;
    * ``extra`` — caller-provided detail (stranded request IDs, the
      failing check set, ...).
    """
    if not enabled():
        return None
    global _dump_count
    now = time.monotonic()
    with _lock:
        if not force:
            last = _last_dump.get(reason)
            if last is not None and now - last < _min_interval_s():
                return None
        _last_dump[reason] = now
        _dump_count += 1
        n = _dump_count
    try:
        evts = events.get_journal().tail(last_n)
        try:
            from deeplearning4j_tpu_torch.monitor.registry import get_registry
            registry = get_registry().snapshot()
        except Exception:
            registry = {}
        payload = {
            "schema": 1,
            "reason": reason,
            "time": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime()),
            "unix_ts": time.time(),
            "pid": os.getpid(),
            "context": events.current_context(),
            "n_events": len(evts),
            "events": evts,
            "registry": registry,
            "extra": extra or {},
        }
        d = directory or flight_dir()
        os.makedirs(d, exist_ok=True)
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in reason)
        path = os.path.join(
            d, f"flight_{safe}_{stamp}_{os.getpid()}_{n}.json")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1, default=str)
        os.replace(tmp, path)
    except Exception:
        return None
    _count_dump(reason)
    events.emit("flight.dump", severity="warn", reason=reason, path=path)
    return path


def list_dumps(directory: Optional[str] = None) -> List[str]:
    """Existing dump files, oldest-first (by mtime — filenames sort by
    reason, not by time)."""
    d = directory or flight_dir()
    if not os.path.isdir(d):
        return []
    paths = [os.path.join(d, f) for f in os.listdir(d)
             if f.startswith("flight_") and f.endswith(".json")]
    return sorted(paths, key=lambda p: (os.path.getmtime(p), p))
