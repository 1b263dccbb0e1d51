"""Early stopping — the port of ``deeplearning4j_tpu/nn/earlystopping.py``:
training driven by a configuration of termination conditions, keeping
the best model by a held-out score.

(ref: earlystopping/EarlyStoppingConfiguration.java,
trainer/BaseEarlyStoppingTrainer.java:76, saver/LocalFileModelSaver.java,
scorecalc/DataSetLossCalculator.java, termination/* — MaxEpochs, MaxTime,
ScoreImprovement, MaxScore, InvalidScore, BestScore)

The trainer calls ``net.fit(ds)`` once a batch, as the JAX package does:
each call wraps its one batch in its own input pipeline (a feeder thread
a step) and reads the step's score off the device for the iteration
conditions.  ``LocalFileModelSaver`` writes and reads the port's zip
(``nn/serialization``); it restores onto the CUDA device unless it is
given ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path
from typing import List, Optional

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn import serialization


# ---------------------------------------------------------------- terminators
class EpochTerminationCondition:
    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    def terminate(self, iteration: int, score: float) -> bool:
        raise NotImplementedError


@dataclasses.dataclass
class MaxEpochsTerminationCondition(EpochTerminationCondition):
    max_epochs: int

    def terminate(self, epoch, score):
        return epoch >= self.max_epochs - 1


@dataclasses.dataclass
class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs without score improvement."""

    max_epochs_without_improvement: int
    min_improvement: float = 0.0
    _best: float = dataclasses.field(default=math.inf, repr=False)
    _stale: int = dataclasses.field(default=0, repr=False)

    def terminate(self, epoch, score):
        if score < self._best - self.min_improvement:
            self._best = score
            self._stale = 0
        else:
            self._stale += 1
        return self._stale > self.max_epochs_without_improvement


@dataclasses.dataclass
class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    best_expected_score: float

    def terminate(self, epoch, score):
        return score <= self.best_expected_score


@dataclasses.dataclass
class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    max_seconds: float
    _start: Optional[float] = dataclasses.field(default=None, repr=False)

    def terminate(self, iteration, score):
        if self._start is None:
            self._start = time.monotonic()
        return time.monotonic() - self._start > self.max_seconds


@dataclasses.dataclass
class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    max_score: float

    def terminate(self, iteration, score):
        return score > self.max_score


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    def terminate(self, iteration, score):
        return math.isnan(score) or math.isinf(score)


# ---------------------------------------------------------------- savers
class InMemoryModelSaver:
    """(ref: saver/InMemoryModelSaver.java)"""

    def __init__(self):
        self.best = None
        self.latest = None

    def save_best(self, model):
        self.best = model.clone()

    def save_latest(self, model):
        self.latest = model.clone()

    def get_best(self):
        return self.best

    def get_latest(self):
        return self.latest


class LocalFileModelSaver:
    """(ref: saver/LocalFileModelSaver.java)"""

    def __init__(self, directory, device=None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.device = device

    def save_best(self, model):
        serialization.write_model(model, self.dir / "bestModel.zip")

    def save_latest(self, model):
        serialization.write_model(model, self.dir / "latestModel.zip")

    def get_best(self):
        return serialization.load_model(self.dir / "bestModel.zip",
                                        device=self.device)

    def get_latest(self):
        return serialization.load_model(self.dir / "latestModel.zip",
                                        device=self.device)


# ---------------------------------------------------------------- score calc
class DataSetLossCalculator:
    """(ref: scorecalc/DataSetLossCalculator.java)"""

    def __init__(self, iterator_or_dataset, average: bool = True):
        self.data = iterator_or_dataset
        self.average = average

    def calculate_score(self, model) -> float:
        if isinstance(self.data, DataSet):
            return model.score(self.data)
        self.data.reset()
        total, n = 0.0, 0
        for ds in self.data:
            total += model.score(ds) * ds.num_examples()
            n += ds.num_examples()
        return total / n if self.average and n else total


# ---------------------------------------------------------------- config+trainer
@dataclasses.dataclass
class EarlyStoppingConfiguration:
    """(ref: earlystopping/EarlyStoppingConfiguration.java)"""

    score_calculator: DataSetLossCalculator
    model_saver: object = dataclasses.field(default_factory=InMemoryModelSaver)
    epoch_termination_conditions: List[EpochTerminationCondition] = dataclasses.field(default_factory=list)
    iteration_termination_conditions: List[IterationTerminationCondition] = dataclasses.field(default_factory=list)
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False


@dataclasses.dataclass
class EarlyStoppingResult:
    """(ref: earlystopping/EarlyStoppingResult.java)"""

    termination_reason: str
    termination_details: str
    total_epochs: int
    best_model_epoch: int
    best_model_score: float
    score_vs_epoch: dict
    best_model: object


def validate_termination_conditions(cfg: EarlyStoppingConfiguration) -> None:
    """A configuration with no termination condition at all would train
    forever: reject it up front (the reference's builder documents that
    at least one condition is required)."""
    if (not cfg.epoch_termination_conditions
            and not cfg.iteration_termination_conditions):
        raise ValueError(
            "EarlyStoppingConfiguration requires at least one epoch or "
            "iteration termination condition — otherwise fit() never stops")


def check_score_free_epoch_conditions(cfg: EarlyStoppingConfiguration,
                                      epoch: int):
    """Score-independent epoch conditions (MaxEpochs) must fire on EVERY
    epoch, not only on evaluate_every_n_epochs boundaries — otherwise
    MaxEpochs(3) with evaluate_every_n_epochs=5 overshoots (or loops
    forever).  Returns the fired condition or None."""
    for cond in cfg.epoch_termination_conditions:
        if isinstance(cond, MaxEpochsTerminationCondition) \
                and cond.terminate(epoch, math.nan):
            return cond
    return None


class EarlyStoppingTrainer:
    """(ref: trainer/EarlyStoppingTrainer.java / BaseEarlyStoppingTrainer.fit :76)"""

    def __init__(self, config: EarlyStoppingConfiguration, network, train_data):
        self.config = config
        self.net = network
        self.train_data = train_data

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        validate_termination_conditions(cfg)
        best_score = math.inf
        best_epoch = -1
        score_vs_epoch = {}
        epoch = 0
        reason, details = "MaxEpochs", ""
        while True:
            # --- one epoch with iteration-level termination checks ---
            self.train_data.reset()
            terminated_iter = False
            for ds in self.train_data:
                self.net.fit(ds)
                s = self.net.score()
                for cond in cfg.iteration_termination_conditions:
                    if cond.terminate(self.net.iteration, s):
                        reason = "IterationTerminationCondition"
                        details = repr(cond)
                        terminated_iter = True
                        break
                if terminated_iter:
                    break
            if terminated_iter:
                break

            if epoch % cfg.evaluate_every_n_epochs == 0:
                score = cfg.score_calculator.calculate_score(self.net)
                score_vs_epoch[epoch] = score
                if score < best_score:
                    best_score = score
                    best_epoch = epoch
                    cfg.model_saver.save_best(self.net)
                if cfg.save_last_model:
                    cfg.model_saver.save_latest(self.net)
                stop = False
                for cond in cfg.epoch_termination_conditions:
                    if cond.terminate(epoch, score):
                        reason = "EpochTerminationCondition"
                        details = repr(cond)
                        stop = True
                        break
                if stop:
                    break
            else:
                fired = check_score_free_epoch_conditions(cfg, epoch)
                if fired is not None:
                    reason, details = "EpochTerminationCondition", repr(fired)
                    break
            epoch += 1
        best = cfg.model_saver.get_best()
        return EarlyStoppingResult(
            termination_reason=reason, termination_details=details,
            total_epochs=epoch + 1, best_model_epoch=best_epoch,
            best_model_score=best_score, score_vs_epoch=score_vs_epoch,
            best_model=best if best is not None else self.net)


class EarlyStoppingGraphTrainer(EarlyStoppingTrainer):
    """ComputationGraph early stopping (ref: trainer/EarlyStoppingGraphTrainer.java)
    — the loop is model-agnostic here (fit/score/iteration are the same
    surface on both engines); the class exists for reference API parity."""
