"""Training listeners — the port of ``deeplearning4j_tpu/nn/listeners.py``.

(ref: optimize/api/IterationListener.java, TrainingListener.java:73;
impls optimize/listeners/{ScoreIterationListener, PerformanceListener,
CollectScoresIterationListener, ParamAndGradientIterationListener}.java)

Both engines call ``iteration_done(model, iteration)`` after every step
(``iteration`` counts the steps taken, the step just finished included)
and, for a :class:`TrainingListener`, ``on_epoch_start`` /
``on_epoch_end`` around each epoch of ``fit``.  ``model.score()`` reads
the last step's score off the device, a synchronisation, so the
listeners here call it only on the iterations they print or collect.
``ProfilerListener`` writes a ``torch.profiler`` Chrome trace where the
JAX package writes a ``jax.profiler`` one.  ``LatencyHistogram`` is the
reservoir of ``monitor/registry.py``.
"""

from __future__ import annotations

import logging
import os
import time
from typing import List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.monitor.registry import (  # noqa: F401
    LatencyHistogram)

log = logging.getLogger(__name__)


class IterationListener:
    def iteration_done(self, model, iteration: int) -> None:
        pass


class TrainingListener(IterationListener):
    def on_epoch_start(self, model) -> None:
        pass

    def on_epoch_end(self, model) -> None:
        pass

    def on_forward_pass(self, model, activations) -> None:
        pass

    def on_gradient_calculation(self, model) -> None:
        pass

    def on_backward_pass(self, model) -> None:
        pass


class ScoreIterationListener(IterationListener):
    """Log the score every N iterations (ref: ScoreIterationListener)."""

    def __init__(self, print_iterations: int = 10):
        self.print_iterations = max(1, print_iterations)

    def iteration_done(self, model, iteration):
        if iteration % self.print_iterations == 0:
            log.info("Score at iteration %d is %s", iteration, model.score())


class PerformanceListener(IterationListener):
    """Samples/s, batches/s and ETL time per iteration
    (ref: PerformanceListener.java:119-122).  The time between two calls
    is the host's: a step's kernels may still run when the next call
    comes, so over several iterations it measures the steady rate."""

    def __init__(self, frequency: int = 1, report_etl: bool = True):
        self.frequency = max(1, frequency)
        self.report_etl = report_etl
        self._last_time: Optional[float] = None
        self.history: List[dict] = []

    def iteration_done(self, model, iteration):
        now = time.perf_counter()
        if self._last_time is not None and iteration % self.frequency == 0:
            dt = now - self._last_time
            batch = getattr(model, "last_batch_size", 0)
            rec = {
                "iteration": iteration,
                "batches_per_sec": 1.0 / dt if dt > 0 else float("inf"),
                "samples_per_sec": batch / dt if dt > 0 else float("inf"),
                "etl_ms": getattr(model, "last_etl_time_ms", 0.0),
            }
            self.history.append(rec)
            log.info("iteration %d: %.1f samples/sec, %.2f batches/sec, "
                     "ETL %.1f ms", iteration, rec["samples_per_sec"],
                     rec["batches_per_sec"], rec["etl_ms"])
        self._last_time = now


class CollectScoresIterationListener(IterationListener):
    """Collect (iteration, score) pairs (ref: CollectScoresIterationListener)."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores: List[Tuple[int, float]] = []

    def iteration_done(self, model, iteration):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, float(model.score())))


class ProfilerListener(IterationListener):
    """Trace ``trace_iterations`` steps with ``torch.profiler`` every
    ``frequency`` iterations (the JAX package traces with
    ``jax.profiler``; ref: PerformanceListener.java:119-122): a Chrome
    trace of the host's ops and, on a CUDA device, its kernels and
    copies, written as ``log_dir/iter<N>/trace.json`` when the window
    closes.  Open it in Perfetto or ``chrome://tracing``."""

    def __init__(self, log_dir, frequency: int = 100,
                 trace_iterations: int = 3):
        self.log_dir = str(log_dir)
        self.frequency = max(1, frequency)
        self.trace_iterations = max(1, trace_iterations)
        self._tracing_until: Optional[int] = None
        self._prof = None
        self._path: Optional[str] = None
        self.trace_dirs: List[str] = []

    def _start(self, iteration: int) -> None:
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._path = os.path.join(self.log_dir, f"iter{iteration}")
        os.makedirs(self._path, exist_ok=True)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._tracing_until = iteration + self.trace_iterations
        self.trace_dirs.append(self._path)

    def _stop(self) -> None:
        prof, self._prof, self._tracing_until = self._prof, None, None
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(self._path, "trace.json"))

    def iteration_done(self, model, iteration):
        if self._tracing_until is not None:
            if iteration >= self._tracing_until:
                self._stop()
            return
        if iteration % self.frequency == 0:
            self._start(iteration)

    def close(self) -> None:
        """Stop a trace left open mid-capture (end of training)."""
        if self._tracing_until is not None:
            self._stop()


class CompileTelemetryListener(IterationListener):
    """The engine's ``CompileTelemetry`` (``ops/bucketing.py``: the input
    signatures each entry point met) through the listener interface, as
    in the JAX package: logs the iterations that met a new signature and
    keeps periodic snapshots."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.history: List[dict] = []
        self._last_retraces = 0

    def iteration_done(self, model, iteration):
        tel = getattr(model, "compile_telemetry", None)
        if tel is None:
            return
        if tel.retraces > self._last_retraces:
            log.info("iteration %d: %d new trace(s), %d total",
                     iteration, tel.retraces - self._last_retraces,
                     tel.retraces)
            self._last_retraces = tel.retraces
        if iteration % self.frequency == 0:
            self.history.append({"iteration": iteration, **tel.snapshot()})

    def snapshot(self) -> Optional[dict]:
        return self.history[-1] if self.history else None


class ParamAndGradientIterationListener(IterationListener):
    """Per-iteration parameter and update magnitudes, optionally written
    as TSV (ref: optimize/listeners/ParamAndGradientIterationListener.java).
    Each recorded iteration copies the flat params to the host."""

    COLUMNS = ["iteration", "score", "param_mean_magnitude",
               "update_mean_magnitude"]

    def __init__(self, iterations: int = 1, file_path=None,
                 delimiter: str = "\t"):
        self.iterations = max(1, iterations)
        self.file_path = file_path
        self.delimiter = delimiter
        self.history: List[dict] = []
        self._last = None
        self._wrote_header = False

    def iteration_done(self, model, iteration):
        if iteration % self.iterations:
            return
        params = model.params().detach().cpu().numpy()
        rec = {
            "iteration": iteration,
            "score": float(model.score()),
            "param_mean_magnitude": float(np.abs(params).mean()),
        }
        if self._last is not None and self._last.shape == params.shape:
            rec["update_mean_magnitude"] = float(
                np.abs(params - self._last).mean())
        self._last = params
        self.history.append(rec)
        if self.file_path:
            with open(self.file_path, "a") as f:
                if not self._wrote_header:
                    f.write(self.delimiter.join(self.COLUMNS) + "\n")
                    self._wrote_header = True
                f.write(self.delimiter.join(
                    str(rec.get(c, "")) for c in self.COLUMNS) + "\n")
