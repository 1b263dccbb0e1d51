"""Periodic checkpoints and crash-safe resume — the port of
``deeplearning4j_tpu/nn/checkpoint.py``.

(ref: util/ModelSerializer.java and the early-stopping savers' persist
pattern, earlystopping/saver/LocalFileModelSaver.java.)

``CheckpointListener`` saves the whole training state (configuration,
params, updater state) as the ModelSerializer zip every N iterations or
every epoch and keeps the last ``keep_last``.  A save lands in a
temporary file that is fsync'd, then renamed over the final name, then
the directory is fsync'd: a crash mid-save never leaves a half-written
checkpoint under a checkpoint's name.  Each save also rewrites
``checkpoint_manifest.json`` (the same protocol) with, per checkpoint,
the iteration, the completed epochs and how many batches into the next
epoch the save landed, the keys of the JAX package's manifest; its
``sharding`` and ``dist`` are null, as the JAX package writes them for a
model that is not sharded and not distributed, and ``precision`` is the
JAX package's ``_precision_meta`` (:143-165): null for f32, else the
compute dtype and the quantization knobs of the configuration.
A checkpoint either package writes validates and restores in the other.

``resume_from_checkpoint`` loads the newest checkpoint that validates
(zip CRCs, a parsable configuration, a non-empty float32 coefficient
vector) and loads: a truncated or corrupt file is skipped with a warning
and counted in ``dl4j_resilience_checkpoint_fallbacks_total``, and the
previous checkpoint is tried.  ``restore_into`` loads it into an existing
model, which ``fit`` does under ``conf.fault_tolerance(resume=True)``
(``maybe_auto_resume``).  A restored model replays its generator's
dropout seed draws up to the restored iteration, so a resumed stochastic
fit draws the seeds an uninterrupted one would.

Not ported yet: the ``checkpoint.write`` fault site and the event journal
and flight dump of a save and a resume (ROADMAP A9).
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
import zipfile
from pathlib import Path
from typing import List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.monitor.registry import get_registry
from deeplearning4j_tpu_torch.nn.listeners import TrainingListener
from deeplearning4j_tpu_torch.nn.serialization import (
    COEFFICIENTS_NAME, CONFIG_NAME, _read_zip, is_graph_conf, load_model,
    write_model)
from deeplearning4j_tpu_torch.resilience.errors import (  # noqa: F401
    CorruptCheckpointError)

log = logging.getLogger(__name__)

_CKPT_RE = re.compile(r"checkpoint_it(\d+)\.zip$")
MANIFEST_NAME = "checkpoint_manifest.json"
INDEX_NAME = "checkpoint_index.json"
# The longest generator replay a restore makes (the JAX package's bound
# on its key replay).
MAX_RNG_REPLAY = 100_000


def _fsync_dir(directory: Path) -> None:
    try:
        fd = os.open(str(directory), os.O_RDONLY)
    except OSError:
        return  # no directory descriptors here: the rename is atomic still
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _publish(tmp: Path, final: Path) -> None:
    """fsync(tmp), rename, fsync(dir): when this returns the file is on
    disk under its final name, or not at all."""
    with open(tmp, "rb") as f:
        os.fsync(f.fileno())
    os.replace(tmp, final)
    _fsync_dir(final.parent)


def _atomic_write_text(path: Path, text: str) -> None:
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(text)
    _publish(tmp, path)


def validate_checkpoint(path) -> dict:
    """Integrity of a checkpoint zip: the archive reads, every member's
    CRC holds, ``configuration.json`` parses, the coefficients are a
    non-empty whole number of float32s.  Returns the configuration dict;
    raises :class:`CorruptCheckpointError` otherwise."""
    p = Path(path)
    try:
        with zipfile.ZipFile(p, "r") as zf:
            bad = zf.testzip()
            if bad is not None:
                raise CorruptCheckpointError(
                    f"{p.name}: CRC mismatch in member {bad!r}")
            names = zf.namelist()
            if CONFIG_NAME not in names:
                raise CorruptCheckpointError(f"{p.name}: no {CONFIG_NAME}")
            conf = json.loads(zf.read(CONFIG_NAME))
            if COEFFICIENTS_NAME not in names:
                raise CorruptCheckpointError(
                    f"{p.name}: no {COEFFICIENTS_NAME}")
            info = zf.getinfo(COEFFICIENTS_NAME)
            if info.file_size == 0 or info.file_size % 4 != 0:
                raise CorruptCheckpointError(
                    f"{p.name}: coefficients size {info.file_size} is not "
                    f"a non-empty float32 array")
    except CorruptCheckpointError:
        raise
    except Exception as e:
        # BadZipFile, OSError, a JSON or zlib error: the archive does not
        # read
        raise CorruptCheckpointError(f"{p.name}: {type(e).__name__}: {e}")
    return conf


def _count_fallback() -> None:
    get_registry().counter(
        "dl4j_resilience_checkpoint_fallbacks_total",
        "corrupt/unloadable checkpoints skipped during resume").inc()


class CheckpointListener(TrainingListener):
    """Save every ``save_every_n_iterations`` iterations (or at every
    epoch's end under ``save_every_epoch``), keeping the last
    ``keep_last`` checkpoint zips."""

    def __init__(self, directory,
                 save_every_n_iterations: Optional[int] = None,
                 save_every_epoch: bool = False, keep_last: int = 3,
                 save_updater: bool = True):
        if save_every_n_iterations is None and not save_every_epoch:
            raise ValueError("enable at least one of save_every_n_iterations "
                             "/ save_every_epoch")
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.every_n = save_every_n_iterations
        self.every_epoch = save_every_epoch
        self.keep_last = max(1, keep_last)
        self.save_updater = save_updater
        self._epoch_start_iter: Optional[int] = None

    def on_epoch_start(self, model):
        # the epoch's first iteration, for a model whose fit does not
        # publish its own ``_epoch_start_iter``
        self._epoch_start_iter = getattr(model, "iteration", 0)

    def iteration_done(self, model, iteration):
        if self.every_n and iteration % self.every_n == 0:
            self._save(model, iteration, getattr(model, "epoch", 0),
                       self._iteration_in_epoch(model, iteration))

    def on_epoch_end(self, model):
        if self.every_epoch:
            # before fit counts the epoch: it is complete here, and the
            # next one starts from its first batch
            self._save(model, model.iteration,
                       getattr(model, "epoch", 0) + 1, 0)

    def _iteration_in_epoch(self, model, iteration: int) -> Optional[int]:
        start = getattr(model, "_epoch_start_iter", self._epoch_start_iter)
        if start is None:
            return None
        return max(0, int(iteration) - int(start))

    def _save(self, model, iteration: int, epochs_completed: int,
              iteration_in_epoch: Optional[int] = None) -> Path:
        path = self.dir / f"checkpoint_it{iteration}.zip"
        tmp = path.with_suffix(".tmp")
        write_model(model, tmp, save_updater=self.save_updater)
        _publish(tmp, path)
        meta = {"file": path.name, "iteration": iteration,
                "epoch": epochs_completed,
                "iteration_in_epoch": iteration_in_epoch,
                "timestamp": int(time.time() * 1000),
                "model_class": type(model).__name__,
                # a model of the port is neither sharded nor distributed
                "sharding": None, "dist": None,
                "precision": precision_meta(model)}
        self._update_manifest(meta)
        # the single-entry index older readers take
        _atomic_write_text(self.dir / INDEX_NAME, json.dumps(meta))
        self._prune()
        return path

    def _write_manifest(self, entries: List[dict]) -> None:
        _atomic_write_text(self.dir / MANIFEST_NAME,
                           json.dumps({"version": 1, "checkpoints": entries},
                                      indent=2))

    def _update_manifest(self, meta: dict) -> None:
        entries = [e for e in read_manifest(self.dir)
                   if e.get("file") != meta["file"]]
        entries.append(meta)
        entries.sort(key=lambda e: e.get("iteration", 0))
        self._write_manifest(entries)

    def _prune(self) -> None:
        old = self.checkpoints(self.dir)[:-self.keep_last]
        for p in old:
            p.unlink(missing_ok=True)
        if old:
            dropped = {p.name for p in old}
            self._write_manifest([e for e in read_manifest(self.dir)
                                  if e.get("file") not in dropped])

    @staticmethod
    def checkpoints(directory) -> List[Path]:
        """Every checkpoint, oldest first."""
        found = [(int(m.group(1)), p)
                 for p in Path(directory).glob("checkpoint_it*.zip")
                 if (m := _CKPT_RE.search(p.name))]
        return [p for _, p in sorted(found)]

    @staticmethod
    def last_checkpoint(directory) -> Optional[Path]:
        ckpts = CheckpointListener.checkpoints(directory)
        return ckpts[-1] if ckpts else None


def precision_meta(model) -> Optional[dict]:
    """The precision tiers of the configuration at save time, as the JAX
    package's ``_precision_meta`` writes them: None when everything is
    f32, else ``{"compute": <dtype name>, "infer_quant": ..., "grad_quant":
    ...}``.  The coefficients in the zip are always the f32 masters, so a
    checkpoint restores under any tier."""
    from deeplearning4j_tpu_torch.ops import dtypes as dtype_ops
    g = model.conf.global_conf
    tiers = {"compute": dtype_ops.policy_name(model._policy()),
             "infer_quant": g.precision_infer_quant,
             "grad_quant": g.dist_grad_quant}
    if tiers["compute"] == "float32" and not tiers["infer_quant"] \
            and not tiers["grad_quant"]:
        return None
    return tiers


def read_manifest(directory) -> List[dict]:
    """The manifest's entries, oldest first, or [] when it is missing or
    corrupt: resume works from the file names then."""
    try:
        data = json.loads((Path(directory) / MANIFEST_NAME).read_text())
        entries = data.get("checkpoints", [])
        return entries if isinstance(entries, list) else []
    except (OSError, ValueError):
        return []


def _checkpoint_meta(directory, path: Path) -> dict:
    """What is known of one checkpoint: its manifest entry; else the
    legacy index's epoch where the index describes this very iteration (a
    crash between the zip's publish and the index's can leave it stale);
    else the iteration in the file name."""
    m = _CKPT_RE.search(path.name)
    meta = {"file": path.name,
            "iteration": int(m.group(1)) if m else 0,
            "epoch": None, "iteration_in_epoch": None, "sharding": None,
            "dist": None, "precision": None}
    for e in read_manifest(directory):
        if e.get("file") == path.name:
            meta.update({k: e.get(k, meta.get(k)) for k in
                         ("epoch", "iteration_in_epoch", "model_class",
                          "sharding", "dist", "precision")})
            return meta
    idx = Path(directory) / INDEX_NAME
    if idx.exists():
        try:
            legacy = json.loads(idx.read_text())
            if int(legacy.get("iteration", -1)) == meta["iteration"]:
                meta["epoch"] = legacy.get("epoch")
        except (ValueError, OSError):
            pass
    return meta


def last_valid_checkpoint(directory) -> Optional[Tuple[Path, dict]]:
    """The newest checkpoint that passes :func:`validate_checkpoint`, with
    its metadata, walking back past corrupt ones (each logged and
    counted)."""
    for path in reversed(CheckpointListener.checkpoints(directory)):
        try:
            validate_checkpoint(path)
        except CorruptCheckpointError as e:
            log.warning("skipping corrupt checkpoint %s (%s); falling back "
                        "to the previous one", path.name, e)
            _count_fallback()
            continue
        return path, _checkpoint_meta(directory, path)
    return None


def _resume(directory, load) -> Optional[Tuple[object, dict]]:
    """The first ``(load(path, configuration dict), meta)``, newest
    first, of a checkpoint that validates and loads; corrupt or
    unloadable files are skipped and counted."""
    for path in reversed(CheckpointListener.checkpoints(directory)):
        try:
            loaded = load(path, validate_checkpoint(path))
        except Exception as e:
            # a configuration can parse and still fail to load: fall back
            # to the previous checkpoint either way
            log.warning("skipping unloadable checkpoint %s (%s: %s); "
                        "falling back to the previous one",
                        path.name, type(e).__name__, e)
            _count_fallback()
            continue
        meta = _checkpoint_meta(directory, path)
        meta["path"] = str(path)
        if meta.get("epoch") is None:
            meta["epoch"] = 0
        return loaded, meta
    return None


def _set_position(model, meta: dict) -> None:
    """The restored iteration and epoch, and the generator's position."""
    model.iteration = meta["iteration"]
    model.epoch = int(meta["epoch"])
    _fast_forward_rng(model)


def resume_from_checkpoint(directory, load_updater: bool = True,
                           device=None):
    """The newest valid checkpoint in ``directory`` restored (the model
    type read from the zip, on ``device``: the CUDA device unless the
    caller asks for the CPU) at its iteration and epoch, or None when no
    checkpoint loads.  The file name is authoritative for the iteration;
    the manifest or index gives the epoch only when it describes this
    very checkpoint."""
    found = _resume(directory, lambda path, _: load_model(
        path, device=device, load_updater=load_updater))
    if found is None:
        return None
    model, meta = found
    _set_position(model, meta)
    return model


def _read_checkpoint(path, conf: dict, load_updater: bool):
    """(model class name, flat params, flat updater state or None) of a
    valid checkpoint whose configuration dict is ``conf``: the
    configuration is parsed as ``load_model`` parses it, and no network
    is built."""
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
        ComputationGraphConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.network import (
        MultiLayerConfiguration)

    graph = is_graph_conf(conf)
    conf_dict, flat, upd = _read_zip(path, load_updater)
    (ComputationGraphConfiguration if graph
     else MultiLayerConfiguration).from_dict(conf_dict)
    return ("ComputationGraph" if graph else "MultiLayerNetwork"), flat, upd


def restore_into(model, directory, load_updater: bool = True
                 ) -> Optional[dict]:
    """Load the newest valid checkpoint INTO ``model`` (initialized):
    params, updater state, iteration, epoch and the generator's position;
    returns its metadata ``{path, iteration, epoch, iteration_in_epoch,
    ...}``, or None when there is nothing to resume.  The model keeps its
    listeners and configuration.  A checkpoint of another model class
    raises: that is a configuration error, not a fault to recover from."""
    found = _resume(directory, lambda path, conf: _read_checkpoint(
        path, conf, load_updater))
    if found is None:
        return None
    (kind, flat, upd), meta = found
    if kind != type(model).__name__:
        raise ValueError(
            f"checkpoint in {directory} holds a {kind}, "
            f"cannot resume a {type(model).__name__} from it")
    model.set_params(flat.copy())
    if upd is not None:
        model.set_updater_state_flat(upd.copy())
    _set_position(model, meta)
    return meta


def maybe_auto_resume(model) -> Tuple[int, int]:
    """``fit``'s hook for ``conf.fault_tolerance(resume=True)``: a fresh
    model (iteration 0, a restarted process) takes the newest valid
    checkpoint, and the result is ``(epochs_to_skip, batches_to_skip)``:
    the completed epochs ``fit`` must not run again and the batches of
    the next epoch the checkpoint had trained.  ``(0, 0)`` when resume is
    off, the model has trained, or there is nothing to resume.  The
    directory is ``conf.ft_checkpoint_dir``, else the attached
    :class:`CheckpointListener`'s."""
    g = model.conf.global_conf
    if not g.ft_resume or int(model.iteration or 0) > 0:
        return 0, 0
    directory = g.ft_checkpoint_dir
    if directory is None:
        for lst in model.listeners:
            if isinstance(lst, CheckpointListener):
                directory = lst.dir
                break
    if directory is None or not Path(directory).is_dir():
        return 0, 0
    meta = restore_into(model, directory)
    if meta is None:
        return 0, 0
    skip_epochs = int(meta.get("epoch") or 0)
    skip_batches = int(meta.get("iteration_in_epoch") or 0)
    log.info("resumed from %s (iteration %d, epoch %d + %d batches); "
             "skipping the already-trained prefix",
             meta.get("path"), meta["iteration"], skip_epochs, skip_batches)
    return skip_epochs, skip_batches


def _fast_forward_rng(model) -> None:
    """Replay the generator's dropout seed draws, one a step, up to the
    restored iteration, so a resumed fit draws the seeds an uninterrupted
    one would (the JAX package replays its key splits)."""
    it = int(model.iteration or 0)
    if it > MAX_RNG_REPLAY:
        return
    model._generator = torch.Generator().manual_seed(
        int(model.conf.global_conf.seed))
    for _ in range(it):
        model._draw_seeds()
