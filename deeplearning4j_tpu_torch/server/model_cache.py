"""Serving model cache — the port of ``deeplearning4j_tpu/server/model_cache.py``.

Loaded models are keyed by ``(abspath, mtime_ns)``: a hit returns the
resident model; a changed mtime is a stale reload (the file on disk
wins); LRU eviction bounds the resident models (``capacity``);
``warmup_dims`` runs ``warmup_inference`` over the serving batch ladder
on load (or on the first hit that knows the request shape).  Models load
onto the cache's device: CUDA unless the caller asks for the CPU.  A
``.h5`` / ``.hdf5`` path is a Keras model, loaded through Keras import;
anything else is a ModelSerializer zip, of a MultiLayerNetwork or a
ComputationGraph (``load_model`` tells them apart; a zip the Java DL4J
wrote is migrated).  A model whose configuration sets
``precision_infer_quant`` ('int8' | 'fp8') is served quantized
(``quantize_inference``), as the JAX package's cache applies it
(:116-131): its codes are made on the cache's device at the first
``output``.

Blue/green rollouts, load retries and the load circuit breaker are not
ported yet.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.nn.serialization import load_model
from deeplearning4j_tpu_torch.ops.platform import DeviceLike, resolve_device


def is_keras_path(path) -> bool:
    return str(path).endswith((".h5", ".hdf5"))


def apply_quant(model) -> None:
    """Serve ``model`` quantized when its configuration's
    ``precision_infer_quant`` names a mode."""
    mode = model.conf.global_conf.precision_infer_quant
    if mode is not None:
        model.quantize_inference(mode)


def default_loader(path: str, device: DeviceLike = None,
                   load_updater: bool = True):
    """Checkpoint sniffing shared with the gateway: Keras ``.h5`` through
    keras_import, anything else through ``load_model``."""
    if is_keras_path(path):
        from deeplearning4j_tpu_torch.keras_import import KerasModelImport
        return KerasModelImport.import_keras_model_and_weights(
            str(path), device=device)
    return load_model(path, device=device, load_updater=load_updater)


class ModelCache:
    """LRU cache of loaded (and optionally warmed) models.  Thread-safe:
    concurrent requests for the same path load the checkpoint once."""

    def __init__(self, capacity: int = 4, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.capacity = max(1, int(capacity))
        self._lock = threading.RLock()
        self._entries: "OrderedDict[str, dict]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.stale_reloads = 0
        self.evictions = 0
        reg = monitor.get_registry()
        self._counters = {
            k: reg.counter(f"dl4j_model_cache_{k}_total",
                           f"model cache {k.replace('_', ' ')}")
            for k in ("hits", "misses", "stale_reloads", "evictions")}
        self._g_resident = reg.gauge("dl4j_model_cache_resident",
                                     "models resident across caches")

    def _count(self, what: str) -> None:
        setattr(self, what, getattr(self, what) + 1)
        self._counters[what].inc()

    def get(self, path, warmup_dims=None, max_batch: int = 32):
        """The cached model for ``path``, loading (and warming) it on
        first use or when the file changed on disk.  ``warmup_dims`` is
        the per-example feature shape; the ladder runs up to
        ``max_batch`` rows."""
        key = os.path.abspath(str(path))
        mtime = os.stat(key).st_mtime_ns
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e["mtime"] != mtime:
                self._count("stale_reloads")
                del self._entries[key]
                e = None
            if e is not None:
                self._count("hits")
                self._entries.move_to_end(key)
            else:
                self._count("misses")
                # serving needs no updater state on the device
                model = default_loader(key, device=self.device,
                                       load_updater=False)
                apply_quant(model)
                e = {"mtime": mtime, "model": model,
                     "warmup": None, "loaded_at": time.time()}
                self._entries[key] = e
                while len(self._entries) > self.capacity:
                    self._entries.popitem(last=False)
                    self._count("evictions")
            self._g_resident.set(len(self._entries))
            if warmup_dims is not None and e["warmup"] is None:
                e["warmup"] = e["model"].warmup_inference(
                    warmup_dims, max_batch=max_batch)
            return e["model"]

    def warmup(self, path, warmup_dims, max_batch: int = 32) -> dict:
        """Load ``path`` and run its serving batch ladder unless the
        cached entry is already warm; returns the entry's warm-up
        record, so a later ``get`` with ``warmup_dims`` does not run the
        ladder again."""
        with self._lock:
            self.get(path, warmup_dims=warmup_dims, max_batch=max_batch)
            return self._entries[os.path.abspath(str(path))]["warmup"]

    def invalidate(self, path=None) -> int:
        """Drop one cached model (``path``) or all of them (None).
        Returns how many entries were dropped."""
        with self._lock:
            if path is None:
                n = len(self._entries)
                self._entries.clear()
            else:
                key = os.path.abspath(str(path))
                n = 1 if self._entries.pop(key, None) is not None else 0
            self._g_resident.set(len(self._entries))
            return n

    def stats(self) -> dict:
        with self._lock:
            models = {k: {"mtime_ns": e["mtime"],
                          "loaded_at": e["loaded_at"],
                          "warmup": e["warmup"],
                          "infer_quant": getattr(e["model"], "_infer_quant",
                                                 None)}
                      for k, e in self._entries.items()}
            return {"capacity": self.capacity, "size": len(models),
                    "device": str(self.device),
                    "hits": self.hits, "misses": self.misses,
                    "stale_reloads": self.stale_reloads,
                    "evictions": self.evictions, "models": models}
