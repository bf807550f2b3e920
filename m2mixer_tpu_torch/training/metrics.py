"""Classification metrics with torchmetrics semantics (the port's copy of
``m2mixer_tpu/training/metrics.py``: Accuracy, F1Score, Precision, Recall,
macro / micro / weighted averaging, 0/0 -> 0). Host numpy accumulators: the
trainer feeds them one epoch of predictions and labels.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

__all__ = ["Accuracy", "F1Score", "Precision", "Recall", "confusion_matrix"]


def _to_numpy(x):
    return np.asarray(x)


def confusion_matrix(preds: np.ndarray, labels: np.ndarray, num_classes: int) -> np.ndarray:
    """Dense KxK confusion matrix; rows = true class, cols = predicted."""
    idx = labels.astype(np.int64) * num_classes + preds.astype(np.int64)
    return np.bincount(idx, minlength=num_classes * num_classes).reshape(num_classes, num_classes)


def _safe_div(a, b):
    return np.where(b > 0, a / np.maximum(b, 1), 0.0)


class _BaseMetric:
    """Accumulates (preds, labels) and computes at epoch end, then resets on
    ``compute()``-after-``reset()`` cycles driven by the trainer."""

    #: rank-based metrics set this; the trainer then feeds probabilities
    #: (aux['probs']) instead of thresholded predictions when available
    wants_scores = False

    def __init__(self, task: str = "multiclass", num_classes: Optional[int] = None,
                 num_labels: Optional[int] = None, average: str = "micro",
                 threshold: float = 0.5, **kwargs):
        if task not in ("multiclass", "multilabel", "binary"):
            raise ValueError(f"Unsupported task: {task}")
        self.task = task
        self.num_classes = num_classes
        self.num_labels = num_labels
        self.average = average
        self.threshold = threshold
        self._preds: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []

    def update(self, preds, labels):
        self._preds.append(_to_numpy(preds))
        self._labels.append(_to_numpy(labels))

    def __call__(self, preds, labels):
        """torchmetrics forward semantics: update state, return batch value."""
        batch = type(self)(task=self.task, num_classes=self.num_classes,
                           num_labels=self.num_labels, average=self.average,
                           threshold=self.threshold)
        batch.update(preds, labels)
        self.update(preds, labels)
        return batch.compute()

    def reset(self):
        self._preds = []
        self._labels = []

    def _gather(self):
        preds = np.concatenate(self._preds) if self._preds else np.zeros((0,))
        labels = np.concatenate(self._labels) if self._labels else np.zeros((0,))
        return preds, labels

    # -- stats ------------------------------------------------------------
    def _binarize(self, preds):
        if preds.dtype.kind == "f" and (self.task in ("binary", "multilabel")):
            # float inputs are probabilities/logits-after-sigmoid -> threshold
            return (preds >= self.threshold).astype(np.int64)
        return preds.astype(np.int64)

    def _tp_fp_fn_tn(self):
        """Per-class TP/FP/FN/TN for the configured task."""
        preds, labels = self._gather()
        if self.task == "multiclass":
            if preds.ndim == labels.ndim + 1:  # probs/logits -> class ids
                preds = preds.argmax(-1)
            cm = confusion_matrix(preds.astype(np.int64), labels.astype(np.int64), self.num_classes)
            tp = np.diag(cm).astype(np.float64)
            fp = cm.sum(axis=0) - tp
            fn = cm.sum(axis=1) - tp
            tn = cm.sum() - tp - fp - fn
            support = cm.sum(axis=1)
            return tp, fp, fn, tn, support
        if self.task == "multilabel":
            p = self._binarize(preds).reshape(-1, self.num_labels)
            t = labels.reshape(-1, self.num_labels).astype(np.int64)
            tp = (p * t).sum(axis=0).astype(np.float64)
            fp = (p * (1 - t)).sum(axis=0).astype(np.float64)
            fn = ((1 - p) * t).sum(axis=0).astype(np.float64)
            tn = ((1 - p) * (1 - t)).sum(axis=0).astype(np.float64)
            return tp, fp, fn, tn, t.sum(axis=0)
        # binary
        p = self._binarize(preds).reshape(-1)
        t = labels.reshape(-1).astype(np.int64)
        tp = np.array([float((p * t).sum())])
        fp = np.array([float((p * (1 - t)).sum())])
        fn = np.array([float(((1 - p) * t).sum())])
        tn = np.array([float(((1 - p) * (1 - t)).sum())])
        return tp, fp, fn, tn, np.array([t.sum()])

    def _average(self, per_class, tp, fp, fn, support, micro_fn):
        if self.task == "binary":
            return float(per_class[0])
        if self.average == "macro":
            return float(per_class.mean())
        if self.average == "weighted":
            total = support.sum()
            return float((per_class * support).sum() / total) if total > 0 else 0.0
        # micro
        return float(micro_fn(tp.sum(), fp.sum(), fn.sum()))


class Accuracy(_BaseMetric):
    def compute(self) -> float:
        preds, labels = self._gather()
        if preds.size == 0:
            return 0.0
        if self.task == "multiclass":
            if preds.ndim == labels.ndim + 1:
                preds = preds.argmax(-1)
            return float((preds.astype(np.int64) == labels.astype(np.int64)).mean())
        p = self._binarize(preds)
        return float((p == labels.astype(np.int64)).mean())


class Precision(_BaseMetric):
    def compute(self) -> float:
        tp, fp, fn, tn, support = self._tp_fp_fn_tn()
        per_class = _safe_div(tp, tp + fp)
        return self._average(per_class, tp, fp, fn, support,
                             lambda TP, FP, FN: _safe_div(TP, TP + FP))


class Recall(_BaseMetric):
    def compute(self) -> float:
        tp, fp, fn, tn, support = self._tp_fp_fn_tn()
        per_class = _safe_div(tp, tp + fn)
        return self._average(per_class, tp, fp, fn, support,
                             lambda TP, FP, FN: _safe_div(TP, TP + FN))


class F1Score(_BaseMetric):
    def compute(self) -> float:
        tp, fp, fn, tn, support = self._tp_fp_fn_tn()
        per_class = _safe_div(2 * tp, 2 * tp + fp + fn)
        return self._average(per_class, tp, fp, fn, support,
                             lambda TP, FP, FN: _safe_div(2 * TP, 2 * TP + FP + FN))
