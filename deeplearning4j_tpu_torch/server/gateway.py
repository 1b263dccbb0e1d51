"""Gateway entry point — the port of ``deeplearning4j_tpu/server/gateway.py``.

JSON-RPC over HTTP around :class:`DeepLearning4jEntryPoint`:

    POST / {"method": "predict", "params": {...}}
        → {"result": {...}} or {"error": "..."}

``predict(features=...)`` serves a saved MultiLayerNetwork or
ComputationGraph zip (a graph serves its first output, as the JAX
gateway does): the model comes from the :class:`ModelCache` (loaded and
warmed once), concurrent
requests coalesce through one :class:`MicroBatcher` per model, and
admission control rejects a request that would push the queued rows past
``max_queue_rows`` (HTTP 503 + ``Retry-After``).  A model path is a zip,
or a Keras ``.h5`` / ``.hdf5`` file loaded through Keras import.
``fit`` trains the cached model on a directory of minibatches (exported
``.npz`` files or the reference's HDF5 layouts), writes the trained zip
and drops the cache entry; ``evaluate`` scores a model on such a
directory (ref: DeepLearning4jEntryPoint.fit :21-33).  ``GET /healthz``
answers liveness.  Everything runs on the CUDA device unless the entry
point is built with ``device="cpu"``.

Stateful decode sessions (``server/decode.py``): ``open_session``,
``decode_step`` (with ``spec=`` / ``draft=`` for speculative continuation,
``server/speculative.py``), ``close_session``, the two-phase migration
``export_session`` / ``finish_export`` / ``import_session`` (payloads move
between this gateway and the JAX package's both ways), ``drain`` /
``undrain`` and ``decode_stats``; ``warmup(spec_k=)`` warms the decode
pool's verify step.  Slot or arena exhaustion answers 503 with
``Retry-After``; ``invalidate`` closes the model's decode pools.  Each RPC
runs under a request id (the caller's ``X-DL4J-Request-ID`` or a new one),
which every journal event it causes carries; the fault site
``gateway.predict`` sits at the top of ``predict``.

Not ported yet: bucketed ``fit``, ``predict(data_dir=...)``, tenants and
fair share, SLOs, readiness, the metrics and trace endpoints.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.monitor import events
from deeplearning4j_tpu_torch.keras_import.hdf5_data import (
    _BATCH_RE, HDF5MiniBatchDataSetIterator)
from deeplearning4j_tpu_torch.nn.serialization import (
    read_updater_state, write_model)
from deeplearning4j_tpu_torch.ops.platform import DeviceLike
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.resilience.errors import (
    CircuitOpenError, DeadlineExceededError, OverloadedError)
from deeplearning4j_tpu_torch.scaleout.data import PathDataSetIterator
from deeplearning4j_tpu_torch.server import speculative
from deeplearning4j_tpu_torch.server.batcher import MicroBatcher
from deeplearning4j_tpu_torch.server.decode import DecodeManager
from deeplearning4j_tpu_torch.server.model_cache import (
    ModelCache, is_keras_path)

# the RPC methods a client may call
RPC_METHODS = frozenset((
    "predict", "warmup", "invalidate", "stats", "healthz", "fit",
    "evaluate", "open_session", "decode_step", "close_session",
    "export_session", "finish_export", "import_session", "drain",
    "undrain", "decode_stats"))


class DeepLearning4jEntryPoint:
    """The object the gateway exposes; one method per remote operation.

    ``max_batch`` bounds the rows of one coalesced batch; ``coalesce``
    is the default for
    ``predict(features=...)`` (overridable per request);
    ``max_queue_rows`` bounds the rows queued across batchers and decode
    pools.  ``decode_slots``, ``decode_ttl_s`` and ``decode_max_wait_ms``
    size each model's decode pool; the paged arena and the carry dtype
    come from the ``DL4J_KV_*`` and ``DL4J_CARRY_DTYPE`` environment."""

    def __init__(self, model_cache: Optional[ModelCache] = None,
                 device: DeviceLike = None,
                 max_batch: int = 32, coalesce: bool = True,
                 max_queue_rows: int = 1024, retry_after_s: float = 1.0,
                 decode_slots: int = 32, decode_ttl_s: float = 600.0,
                 decode_max_wait_ms: float = 2.0):
        self.model_cache = model_cache or ModelCache(device=device)
        self.max_batch = max(1, int(max_batch))
        self.coalesce = bool(coalesce)
        self.max_queue_rows = max(1, int(max_queue_rows))
        self.retry_after_s = max(0.0, float(retry_after_s))
        self.decode = DecodeManager(
            self.model_cache, max_slots=decode_slots, ttl_s=decode_ttl_s,
            max_wait_ms=decode_max_wait_ms, retry_after_s=self.retry_after_s)
        self._t_start = time.time()
        self._batchers: dict = {}
        self._batcher_lock = threading.Lock()
        # speculative decoders, one per (vocab, k, draft): the per-session
        # drafting state lives inside them
        self._spec_decoders: dict = {}
        self._spec_lock = threading.Lock()
        self._c_shed = monitor.get_registry().counter(
            "dl4j_resilience_shed_total",
            "requests shed instead of served", labels=("reason",))

    # ---- inference ----
    def predict(self, model_path: str, features, top_k: Optional[int] = None,
                argmax_only: bool = False, coalesce: Optional[bool] = None,
                deadline_ms: Optional[float] = None,
                tenant: Optional[str] = None) -> dict:
        """Run the cached, warmed model on an inline ``[k, ...]`` row
        batch.  Concurrent requests coalesce through the micro-batcher
        unless ``coalesce=False``.  ``argmax_only`` returns class ids;
        ``top_k=K`` the K best class ids and their probabilities per row;
        otherwise the full output rows.  ``deadline_ms`` is the request's
        budget in the batcher's queue; ``tenant`` labels the request's
        events."""
        with events.request_scope(tenant=tenant,
                                  model=os.path.basename(str(model_path))):
            return self._predict(model_path, features, top_k, argmax_only,
                                 coalesce, deadline_ms, tenant)

    def _predict(self, model_path, features, top_k, argmax_only, coalesce,
                 deadline_ms, tenant) -> dict:
        faults.check("gateway.predict")
        x = np.asarray(features, dtype=np.float32)
        if x.ndim < 1 or x.shape[0] == 0:
            raise ValueError("features must be a non-empty [k, ...] row "
                             "batch")
        use_batcher = self.coalesce if coalesce is None else bool(coalesce)
        if use_batcher:
            self._admit(len(x))
        model = self.model_cache.get(model_path,
                                     warmup_dims=tuple(x.shape[1:]),
                                     max_batch=self.max_batch)
        if use_batcher:
            out = self._batcher_for(model_path, model).predict(
                x, timeout_ms=deadline_ms, tenant=tenant)
        else:
            out = self._infer_fn(model)(x).cpu().numpy()
        return self._format_predictions(out, top_k, argmax_only)

    # ---- training ----
    @staticmethod
    def _data_iterator(data_dir: str):
        """Minibatch source for a data directory, by layout:

        * ``features/`` + ``labels/`` subdirs of ``batch_%d.h5`` — the
          reference's HDF5 layout (HDF5MiniBatchDataSetIterator.java:24);
        * ``batch_%d.h5`` files carrying features+labels datasets;
        * ``.npz`` exports (``scaleout/data.PathDataSetIterator``).
        """
        d = Path(data_dir)
        if (d / "features").is_dir() and (d / "labels").is_dir():
            return HDF5MiniBatchDataSetIterator(d / "features", d / "labels")
        # the iterator's own strict batch_%d.h5 pattern decides: a stray
        # non-conforming .h5 does not hijack a directory of .npz exports
        if any(_BATCH_RE.match(p.name) for p in d.iterdir()):
            return HDF5MiniBatchDataSetIterator(d)
        return PathDataSetIterator.from_dir(d)

    def fit(self, model_path: str, data_dir: str, epochs: int = 1,
            save_path: Optional[str] = None) -> dict:
        """Train ``model_path`` (the cached instance, its updater state
        restored from the zip) on the minibatches of ``data_dir``, one
        ``fit`` per minibatch for ``epochs`` passes; write the trained zip
        to ``save_path`` (default: over ``model_path``) and drop the cache
        entry, which no longer matches its file.  Returns the last score
        and the written path."""
        model = self.model_cache.get(model_path)
        if model.opt_states is None and not is_keras_path(model_path):
            upd = read_updater_state(model_path)
            if upd is not None:
                model.set_updater_state_flat(upd)
        it = self._data_iterator(data_dir)
        for _ in range(int(epochs)):
            it.reset()
            while it.has_next():
                model.fit(it.next())
        out = save_path or model_path
        if not out.endswith(".zip"):
            out = str(Path(out).with_suffix(".zip"))
        write_model(model, out)
        self.invalidate(model_path)
        return {"score": float(model.score()), "model_path": out}

    def evaluate(self, model_path: str, data_dir: str) -> dict:
        """Accuracy and F1 of ``model_path`` on the minibatches of
        ``data_dir`` (the model's ``evaluate``)."""
        model = self.model_cache.get(model_path)
        ev = model.evaluate(self._data_iterator(data_dir))
        return {"accuracy": ev.accuracy(), "f1": ev.f1()}

    def warmup(self, model_path: str, feature_dims,
               max_batch: Optional[int] = None,
               spec_k: Optional[int] = None) -> dict:
        """Run the serving batch ladder for ``model_path`` now — what
        the first ``predict`` does implicitly.  The cache records it, so
        the first ``predict`` does not run the ladder again.  ``spec_k=K``
        also runs the decode pool's speculative verify step at every slot
        rung (``DecodePool.warmup_spec``)."""
        out = self.model_cache.warmup(
            model_path, tuple(feature_dims),
            max_batch=int(max_batch or self.max_batch))
        if spec_k is not None:
            out = dict(out)
            out["spec"] = self.decode.warmup_spec(
                model_path, feature_dims, k=int(spec_k))
        return out

    def invalidate(self, model_path: Optional[str] = None) -> dict:
        """Drop cached model(s), their batchers and their decode pools
        (open sessions fail), so the next request reloads from disk."""
        n = self.model_cache.invalidate(model_path)
        self.decode.invalidate(model_path)
        with self._batcher_lock:
            keys = ([os.path.abspath(str(model_path))]
                    if model_path is not None else list(self._batchers))
            dropped = [self._batchers.pop(k) for k in keys
                       if k in self._batchers]
        for _, batcher in dropped:
            batcher.stop()
        return {"invalidated": n}

    def stats(self) -> dict:
        """Model-cache counters, per-model batcher metrics (latency
        percentiles, batch-size histogram) and the metrics registry."""
        out = {"model_cache": self.model_cache.stats(), "serving": {}}
        with self._batcher_lock:
            items = list(self._batchers.items())
        for key, (_, batcher) in items:
            out["serving"][key] = batcher.metrics.snapshot()
        out["registry"] = monitor.get_registry().snapshot()
        return out

    def healthz(self) -> dict:
        """Liveness: the process is up and the RPC loop answers."""
        return {"status": "ok",
                "uptime_s": round(time.time() - self._t_start, 1)}

    # ---- stateful decode sessions ----
    def open_session(self, model_path: str,
                     tenant: Optional[str] = None) -> dict:
        """Open a decode session: the model's recurrent carry for this
        stream lives on the device in the model's slot pool, so each
        :meth:`decode_step` costs the same however long the stream is.
        503 + Retry-After when every slot is held."""
        with events.request_scope(
                tenant=tenant, model=os.path.basename(str(model_path))):
            return self.decode.open_session(model_path, tenant=tenant)

    def decode_step(self, session_id: str, features, mask=None,
                    tenant: Optional[str] = None,
                    deadline_ms: Optional[float] = None,
                    top_k: Optional[int] = None, argmax_only: bool = False,
                    spec=None, draft=None) -> dict:
        """Feed one ``[T, C]`` chunk to a session (``T = 1`` token by
        token; a longer chunk is a prefill) and return its ``[T, ...]``
        outputs.  Concurrent sessions' steps join one pool dispatch.
        ``spec=N`` (or ``{"tokens": N, "k": K}``) then generates N more
        greedy tokens by speculative decode with the ``draft=`` proposer
        (``"ngram"`` by default); the response gains ``spec``: the tokens,
        the pending next token and the dispatch and acceptance counts."""
        with events.request_scope(tenant=tenant, session_id=session_id):
            self._admit(1)
            outs = self.decode.decode_step(
                session_id, features, mask=mask, timeout_ms=deadline_ms,
                tenant=tenant)
            spec_out = None
            if spec:
                spec_out = self._spec_continue(
                    session_id, outs, spec, draft, tenant=tenant,
                    deadline_ms=deadline_ms)
        result = self._format_predictions(outs[0], top_k, argmax_only)
        if len(outs) > 1:
            result["outputs"] = [np.asarray(o).tolist() for o in outs]
        result["session_id"] = session_id
        if spec_out is not None:
            result["spec"] = spec_out
        return result

    def _spec_continue(self, session_id: str, outs, spec, draft,
                       tenant=None, deadline_ms=None) -> dict:
        cfg = {"tokens": int(spec)} if not isinstance(spec, dict) else spec
        n_tokens = int(cfg.get("tokens", 0))
        if n_tokens <= 0:
            return {"tokens": [], "dispatches": 0}
        k = int(cfg.get("k", 4))
        last = np.asarray(outs[0])[-1]
        vocab = int(last.shape[-1])
        key = (vocab, k, json.dumps(draft, sort_keys=True)
               if isinstance(draft, dict) else str(draft))
        with self._spec_lock:
            dec = self._spec_decoders.get(key)
            if dec is None:
                dec = speculative.SpeculativeDecoder(
                    self.decode, vocab=vocab, k=k, draft=draft)
                self._spec_decoders[key] = dec
        return dec.generate(session_id, int(np.argmax(last)), n_tokens,
                            tenant=tenant, timeout_ms=deadline_ms)

    def close_session(self, session_id: str) -> dict:
        """Release a decode session's slot."""
        with self._spec_lock:
            decoders = list(self._spec_decoders.values())
        for dec in decoders:
            dec.forget(session_id)
        return {"closed": self.decode.close_session(session_id)}

    def export_session(self, session_id: str) -> dict:
        """Phase one of a migration: the session's carry as a JSON payload
        (its slot held until ``finish_export``)."""
        return self.decode.export_session(session_id)

    def finish_export(self, session_id: str, ok: bool = True) -> dict:
        """Phase two: ``ok`` releases the migrated session's slot;
        otherwise the session is reinstated."""
        return {"finished": self.decode.finish_export(session_id,
                                                      ok=bool(ok))}

    def import_session(self, model_path: str, payload: dict,
                       session_id: Optional[str] = None,
                       tenant: Optional[str] = None) -> dict:
        """Restore an exported session (from this package's gateway or the
        JAX package's) on this gateway; the stream continues."""
        return self.decode.import_session(model_path, payload,
                                          session_id=session_id,
                                          tenant=tenant)

    def drain(self, deadline_ms: Optional[float] = None) -> dict:
        """Stop admitting decode session joins (opens and imports shed
        503) and report the remaining sessions per pool."""
        deadline_s = None if deadline_ms is None \
            else max(0.0, float(deadline_ms)) / 1e3
        return {"pools": self.decode.drain(deadline_s), "draining": True}

    def undrain(self) -> dict:
        """Re-admit decode session joins after a drain."""
        self.decode.resume()
        return {"draining": False}

    def decode_stats(self) -> dict:
        """Per-model decode-pool statistics: slots, sessions, steps, the
        joined-batch histogram, KV residency and speculative counts."""
        return self.decode.stats()

    def close(self) -> None:
        """Stop every batcher thread and decode pool (server shutdown)."""
        with self._batcher_lock:
            dropped = list(self._batchers.values())
            self._batchers.clear()
        for _, batcher in dropped:
            batcher.stop()
        self.decode.close()

    # ---- internals ----
    def _admit(self, n_rows: int) -> None:
        """Bounded-queue admission: reject (don't queue) when the rows
        waiting across batchers and decode pools plus this request exceed
        the limit."""
        with self._batcher_lock:
            batchers = [b for _, b in self._batchers.values()]
        depth = sum(b.queue_rows() for b in batchers) \
            + self.decode.queue_rows()
        if depth + n_rows > self.max_queue_rows:
            self._c_shed.labels(reason="queue_full").inc()
            events.emit("request.shed", severity="warn",
                        reason="queue_full", rows=n_rows, queued=depth)
            raise OverloadedError(
                f"queue full ({depth} rows waiting, limit "
                f"{self.max_queue_rows})", retry_after_s=self.retry_after_s)
        events.emit("request.admitted", rows=n_rows, queued=depth)

    def _batcher_for(self, model_path: str, model) -> MicroBatcher:
        """The micro-batcher bound to this model instance; a reloaded
        model gets a fresh batcher."""
        key = os.path.abspath(str(model_path))
        with self._batcher_lock:
            entry = self._batchers.get(key)
            if entry is not None and entry[0] is model:
                return entry[1]
            old = entry[1] if entry is not None else None
            batcher = MicroBatcher(
                self._infer_fn(model), max_batch=self.max_batch,
                bucket_sizes=model.conf.global_conf.bucket_batch_sizes,
                name=os.path.basename(key))
            self._batchers[key] = (model, batcher)
        if old is not None:
            old.stop()
        return batcher

    @staticmethod
    def _infer_fn(model):
        """The model's ``output`` on a row batch; a ComputationGraph's
        first output."""
        def infer(x):
            out = model.output(x)
            return out[0] if isinstance(out, tuple) else out
        return infer

    @staticmethod
    def _format_predictions(out, top_k=None, argmax_only=False) -> dict:
        out = np.asarray(out)
        if argmax_only:
            cls = np.argmax(out, axis=-1)
            return {"classes": cls.tolist(), "shape": list(cls.shape)}
        if top_k:
            k = max(1, min(int(top_k), out.shape[-1]))
            idx = np.argsort(out, axis=-1)[..., ::-1][..., :k]
            vals = np.take_along_axis(out, idx, axis=-1)
            return {"top_k": k, "classes": idx.tolist(),
                    "probabilities": vals.tolist(), "shape": list(idx.shape)}
        return {"predictions": out.tolist(), "shape": list(out.shape)}


class _HTTPServer(ThreadingHTTPServer):
    # socketserver listens with a backlog of 5: a sixth client connecting
    # at once waits out a SYN retransmit (1 s), which decode sessions of
    # tens of concurrent clients hit on every burst
    request_queue_size = 128


class Server:
    """JSON-RPC over a ``ThreadingHTTPServer``.  Without an entry point
    it builds one on ``device`` (CUDA unless the caller asks for the
    CPU).  Error payloads carry the exception type and message, not the
    traceback (it would leak host paths).  Each RPC runs under the
    caller's ``X-DL4J-Request-ID`` or a new id, journals ``rpc.request``
    and ``rpc.response`` and returns the id in its header and body."""

    def __init__(self, entry_point: Optional[DeepLearning4jEntryPoint] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 device: DeviceLike = None):
        ep = entry_point or DeepLearning4jEntryPoint(device=device)
        self.entry_point = ep
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _respond(self, code, payload, headers=None):
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                if self.path.partition("?")[0] == "/healthz":
                    server._count_request("GET /healthz", 200)
                    self._respond(200, json.dumps(ep.healthz()).encode())
                else:
                    self._respond(404, b'{"error": "not found"}')

            def do_POST(self):
                method = ""
                headers = {}
                rid = (self.headers.get("X-DL4J-Request-ID") or "").strip() \
                    or events.new_request_id()
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    method = req.get("method", "")
                    params = req.get("params", {})
                    if not isinstance(params, dict):
                        raise ValueError("params must be an object")
                    if method not in RPC_METHODS:
                        raise AttributeError(f"no method {method!r}")
                    with events.scope(request_id=rid, method=method,
                                      tenant=params.get("tenant")):
                        events.emit("rpc.request")
                        result = getattr(ep, method)(**params)
                        events.emit("rpc.response", code=200)
                    payload = json.dumps({"result": result,
                                          "request_id": rid},
                                         default=str).encode()
                    code = 200
                except Exception as e:  # the RPC loop must keep serving
                    err = {"error": f"{type(e).__name__}: {e}",
                           "request_id": rid}
                    if isinstance(e, (OverloadedError, CircuitOpenError)):
                        code = 503
                        headers["Retry-After"] = str(max(
                            1, int(round(e.retry_after_s or 1.0))))
                        err["retry_after_s"] = e.retry_after_s
                    elif isinstance(e, DeadlineExceededError):
                        code = 504
                    else:
                        code = 500
                    with events.scope(request_id=rid, method=method or "?"):
                        events.emit("rpc.response", severity="warn",
                                    code=code, error=type(e).__name__)
                    payload = json.dumps(err).encode()
                headers["X-DL4J-Request-ID"] = rid
                server._count_request(method or "?", code)
                self._respond(code, payload, headers)

        self._httpd = _HTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address
        self._thread: Optional[threading.Thread] = None
        self._requests_c = monitor.get_registry().counter(
            "dl4j_gateway_requests_total", "gateway RPC calls",
            labels=("method", "code"))

    def _count_request(self, method: str, code: int) -> None:
        self._requests_c.labels(method=method, code=str(code)).inc()

    def start(self) -> "Server":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(5.0)
        self.entry_point.close()
