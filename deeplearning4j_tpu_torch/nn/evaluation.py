"""Evaluation metrics — classification, regression, ROC; a copy of
``deeplearning4j_tpu/nn/evaluation.py``
(ref: eval/Evaluation.java:47, ConfusionMatrix.java, RegressionEvaluation.java,
ROC.java, ROCBinary.java, ROCMultiClass.java, EvaluationBinary.java).

Accumulation happens on the host in numpy.  Labels, predictions and masks
may be numpy arrays or torch tensors on any device: each ``eval`` moves
its tensors to the host once.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


def _host(a, dtype=None) -> np.ndarray:
    """``a`` as a host numpy array (a tensor is copied from its device)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


class ConfusionMatrix:
    """(ref: eval/ConfusionMatrix.java)"""

    def __init__(self, n_classes: int):
        self.matrix = np.zeros((n_classes, n_classes), dtype=np.int64)

    def add(self, actual: int, predicted: int, count: int = 1):
        self.matrix[actual, predicted] += count

    def get_count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])

    def __str__(self):
        return str(self.matrix)


class Prediction:
    """One example's (actual, predicted, metadata) triple
    (ref: eval/meta/Prediction.java — per-example attribution so
    misclassified examples can be traced back to their source records)."""

    __slots__ = ("actual", "predicted", "record_meta_data")

    def __init__(self, actual: int, predicted: int, record_meta_data=None):
        self.actual = actual
        self.predicted = predicted
        self.record_meta_data = record_meta_data

    def __repr__(self):
        return (f"Prediction(actual={self.actual}, "
                f"predicted={self.predicted}, "
                f"meta={self.record_meta_data!r})")


class Evaluation:
    """Multi-class classification metrics (ref: eval/Evaluation.java)."""

    def __init__(self, n_classes: Optional[int] = None,
                 labels: Optional[List[str]] = None):
        self.n_classes = n_classes
        self.label_names = labels
        self.confusion: Optional[ConfusionMatrix] = None

    def _ensure(self, n: int):
        if self.confusion is None:
            self.n_classes = self.n_classes or n
            self.confusion = ConfusionMatrix(self.n_classes)
        if not hasattr(self, "predictions"):
            self.predictions: List["Prediction"] = []

    def eval(self, labels, predictions, mask=None, record_meta_data=None):
        """labels: one-hot [N,C] (or [N,T,C] with mask [N,T]);
        predictions: probabilities same shape.  record_meta_data: one
        metadata object per example — recorded per prediction for
        attribution (ref: eval/meta/Prediction.java,
        Evaluation.eval(..., List<RecordMetaData>))."""
        labels = _host(labels)
        predictions = _host(predictions)
        meta = record_meta_data
        if labels.ndim == 3:  # time series: flatten valid steps
            if mask is not None:
                m = _host(mask).astype(bool).reshape(-1)
            else:
                m = np.ones(labels.shape[0] * labels.shape[1], dtype=bool)
            if meta is not None:  # replicate per timestep, then mask
                T = labels.shape[1]
                meta = [md for md in meta for _ in range(T)]
                meta = [md for md, keep in zip(meta, m) if keep]
            labels = labels.reshape(-1, labels.shape[-1])[m]
            predictions = predictions.reshape(-1, predictions.shape[-1])[m]
        self._ensure(labels.shape[-1])
        a = np.argmax(labels, axis=-1)
        p = np.argmax(predictions, axis=-1)
        np.add.at(self.confusion.matrix, (a, p), 1)
        if meta is not None:
            for actual, predicted, md in zip(a, p, meta):
                self.predictions.append(
                    Prediction(int(actual), int(predicted), md))

    # -- per-example attribution (ref: eval/meta/) -------------------------
    def get_prediction_errors(self) -> List["Prediction"]:
        """(ref: Evaluation.getPredictionErrors)"""
        return [p for p in getattr(self, "predictions", [])
                if p.actual != p.predicted]

    def get_predictions_by_actual_class(self, cls: int) -> List["Prediction"]:
        return [p for p in getattr(self, "predictions", [])
                if p.actual == cls]

    def get_predictions_by_predicted_class(self, cls: int
                                           ) -> List["Prediction"]:
        return [p for p in getattr(self, "predictions", [])
                if p.predicted == cls]

    def merge(self, other: "Evaluation") -> "Evaluation":
        """Combine counts from another Evaluation (ref:
        eval/Evaluation.java merge — the distributed-eval reduce)."""
        if other.confusion is None:
            return self
        self._ensure(other.n_classes)
        if other.n_classes != self.n_classes:
            raise ValueError(
                f"class-count mismatch: {self.n_classes} vs {other.n_classes}")
        self.confusion.matrix += other.confusion.matrix
        self.predictions.extend(getattr(other, "predictions", []))
        return self

    # ---- metrics ----
    def _tp(self):
        return np.diag(self.confusion.matrix).astype(np.float64)

    def accuracy(self) -> float:
        m = self.confusion.matrix
        total = m.sum()
        return float(np.trace(m) / total) if total else 0.0

    def precision(self, cls: Optional[int] = None) -> float:
        m = self.confusion.matrix
        col = m.sum(axis=0).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.where(col > 0, self._tp() / col, np.nan)
        return float(per[cls]) if cls is not None else float(np.nanmean(per))

    def recall(self, cls: Optional[int] = None) -> float:
        m = self.confusion.matrix
        row = m.sum(axis=1).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.where(row > 0, self._tp() / row, np.nan)
        return float(per[cls]) if cls is not None else float(np.nanmean(per))

    def f1(self, cls: Optional[int] = None) -> float:
        p = self.precision(cls)
        r = self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def false_positive_rate(self, cls: int) -> float:
        m = self.confusion.matrix
        fp = m[:, cls].sum() - m[cls, cls]
        tn = m.sum() - m[cls, :].sum() - m[:, cls].sum() + m[cls, cls]
        return float(fp / (fp + tn)) if (fp + tn) else 0.0

    def stats(self) -> str:
        lines = [
            "==========================Scores========================================",
            f" Accuracy:  {self.accuracy():.4f}",
            f" Precision: {self.precision():.4f}",
            f" Recall:    {self.recall():.4f}",
            f" F1 Score:  {self.f1():.4f}",
            "========================================================================",
        ]
        return "\n".join(lines)


class EvaluationBinary:
    """Per-output independent binary metrics (ref: eval/EvaluationBinary.java)."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.tp = self.fp = self.tn = self.fn = None

    def eval(self, labels, predictions, mask=None):
        labels = _host(labels)
        pred = (_host(predictions) >= self.threshold)
        lab = labels >= 0.5
        if mask is not None:
            m = _host(mask).astype(bool)
        else:
            m = np.ones_like(lab, dtype=bool)
        if self.tp is None:
            n = labels.shape[-1]
            self.tp = np.zeros(n)
            self.fp = np.zeros(n)
            self.tn = np.zeros(n)
            self.fn = np.zeros(n)
        axes = tuple(range(labels.ndim - 1))
        self.tp += np.sum(pred & lab & m, axis=axes)
        self.fp += np.sum(pred & ~lab & m, axis=axes)
        self.tn += np.sum(~pred & ~lab & m, axis=axes)
        self.fn += np.sum(~pred & lab & m, axis=axes)

    def accuracy(self, i: int) -> float:
        tot = self.tp[i] + self.fp[i] + self.tn[i] + self.fn[i]
        return float((self.tp[i] + self.tn[i]) / tot) if tot else 0.0

    def precision(self, i: int) -> float:
        d = self.tp[i] + self.fp[i]
        return float(self.tp[i] / d) if d else 0.0

    def recall(self, i: int) -> float:
        d = self.tp[i] + self.fn[i]
        return float(self.tp[i] / d) if d else 0.0

    def f1(self, i: int) -> float:
        p, r = self.precision(i), self.recall(i)
        return 2 * p * r / (p + r) if (p + r) else 0.0


class RegressionEvaluation:
    """Column-wise regression metrics (ref: eval/RegressionEvaluation.java)."""

    def __init__(self, n_columns: Optional[int] = None):
        self.n = 0
        self.sum_abs = None
        self.sum_sq = None
        self.sum_label = None
        self.sum_label_sq = None
        self.sum_pred = None
        self.sum_pred_sq = None
        self.sum_label_pred = None

    def eval(self, labels, predictions, mask=None):
        labels = _host(labels, np.float64)
        pred = _host(predictions, np.float64)
        labels = labels.reshape(-1, labels.shape[-1])
        pred = pred.reshape(-1, pred.shape[-1])
        if self.sum_abs is None:
            c = labels.shape[-1]
            for attr in ("sum_abs", "sum_sq", "sum_label", "sum_label_sq",
                         "sum_pred", "sum_pred_sq", "sum_label_pred"):
                setattr(self, attr, np.zeros(c))
        err = pred - labels
        self.n += labels.shape[0]
        self.sum_abs += np.abs(err).sum(axis=0)
        self.sum_sq += (err ** 2).sum(axis=0)
        self.sum_label += labels.sum(axis=0)
        self.sum_label_sq += (labels ** 2).sum(axis=0)
        self.sum_pred += pred.sum(axis=0)
        self.sum_pred_sq += (pred ** 2).sum(axis=0)
        self.sum_label_pred += (labels * pred).sum(axis=0)

    def mean_squared_error(self, col: int) -> float:
        return float(self.sum_sq[col] / self.n)

    def mean_absolute_error(self, col: int) -> float:
        return float(self.sum_abs[col] / self.n)

    def root_mean_squared_error(self, col: int) -> float:
        return float(np.sqrt(self.sum_sq[col] / self.n))

    def correlation_r2(self, col: int) -> float:
        n = self.n
        num = n * self.sum_label_pred[col] - self.sum_label[col] * self.sum_pred[col]
        den = np.sqrt(n * self.sum_label_sq[col] - self.sum_label[col] ** 2) * \
            np.sqrt(n * self.sum_pred_sq[col] - self.sum_pred[col] ** 2)
        return float((num / den) ** 2) if den else 0.0


class ROC:
    """Binary ROC / AUC by threshold sweep (ref: eval/ROC.java)."""

    def __init__(self, threshold_steps: int = 100):
        self.steps = threshold_steps
        self.scores: List[np.ndarray] = []
        self.labels: List[np.ndarray] = []

    def eval(self, labels, predictions, mask=None):
        labels = _host(labels)
        pred = _host(predictions)
        if labels.ndim > 1 and labels.shape[-1] == 2:
            labels = labels[..., 1]
            pred = pred[..., 1]
        self.labels.append(labels.reshape(-1))
        self.scores.append(pred.reshape(-1))

    def roc_curve(self):
        lab = np.concatenate(self.labels)
        sc = np.concatenate(self.scores)
        thresholds = np.linspace(0, 1, self.steps + 1)
        pos = lab >= 0.5
        n_pos = pos.sum()
        n_neg = (~pos).sum()
        tpr, fpr = [], []
        for t in thresholds:
            p = sc >= t
            tpr.append((p & pos).sum() / n_pos if n_pos else 0.0)
            fpr.append((p & ~pos).sum() / n_neg if n_neg else 0.0)
        return np.array(fpr), np.array(tpr), thresholds

    def auc(self) -> float:
        fpr, tpr, _ = self.roc_curve()
        order = np.argsort(fpr)
        return float(np.trapezoid(tpr[order], fpr[order]))


class ROCMultiClass:
    """One-vs-all ROC per class (ref: eval/ROCMultiClass.java)."""

    def __init__(self, threshold_steps: int = 100):
        self.steps = threshold_steps
        self.per_class: Dict[int, ROC] = {}

    def eval(self, labels, predictions, mask=None):
        labels = _host(labels)
        labels = labels.reshape(-1, labels.shape[-1])
        pred = _host(predictions).reshape(-1, labels.shape[-1])
        for c in range(labels.shape[-1]):
            self.per_class.setdefault(c, ROC(self.steps)).eval(
                labels[:, c], pred[:, c])

    def auc(self, cls: int) -> float:
        return self.per_class[cls].auc()


class ROCBinary:
    """Per-output-column ROC for independent binary outputs (multi-label
    networks with sigmoid heads; ref: eval/ROCBinary.java — distinct from
    ROCMultiClass's one-vs-all over a softmax)."""

    def __init__(self, threshold_steps: int = 100):
        self.steps = threshold_steps
        self.per_output: Dict[int, ROC] = {}

    def eval(self, labels, predictions, mask=None):
        labels = _host(labels)
        pred = _host(predictions)
        if labels.ndim == 1:
            labels = labels[:, None]
            pred = pred[:, None]
        orig_shape = labels.shape               # pre-flatten, for mask match
        labels = labels.reshape(-1, labels.shape[-1])
        pred = pred.reshape(-1, pred.shape[-1])
        if mask is not None:
            m = _host(mask).astype(bool)
            if m.shape == orig_shape:            # per-element mask
                m = m.reshape(labels.shape)      # applied per column below
            else:                                # per-example/timestep mask
                m = m.reshape(-1)
                labels, pred = labels[m], pred[m]
                m = None
        else:
            m = None
        for c in range(labels.shape[-1]):
            if m is not None:
                keep = m[:, c]
                self.per_output.setdefault(c, ROC(self.steps)).eval(
                    labels[keep, c], pred[keep, c])
            else:
                self.per_output.setdefault(c, ROC(self.steps)).eval(
                    labels[:, c], pred[:, c])

    def num_outputs(self) -> int:
        return len(self.per_output)

    def auc(self, output: int = 0) -> float:
        return self.per_output[output].auc()

    def roc_curve(self, output: int = 0):
        return self.per_output[output].roc_curve()
