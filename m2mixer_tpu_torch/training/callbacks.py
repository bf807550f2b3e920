"""Early stopping and the plateau LR (the port's copy of
``m2mixer_tpu/training/callbacks.py``): EarlyStopping(monitor val_loss,
patience 30, mode min) and torch's ReduceLROnPlateau (factor 0.1, rel
threshold 1e-4), host logic keyed on epoch-level validation metrics.
"""

from __future__ import annotations

import math
from typing import Optional

__all__ = ["EarlyStopping", "ReduceLROnPlateau"]


def _better(value: float, best: Optional[float], mode: str, min_delta: float = 0.0) -> bool:
    if best is None or math.isnan(best):
        return True
    if mode == "min":
        return value < best - min_delta
    return value > best + min_delta


class EarlyStopping:
    """Lightning-parity: stop after ``patience`` epochs without improvement
    greater than ``min_delta`` over the running best."""

    def __init__(self, monitor: str = "val_loss", patience: int = 30, mode: str = "min",
                 min_delta: float = 0.0):
        self.monitor = monitor
        self.patience = patience
        self.mode = mode
        self.min_delta = min_delta
        self.best: Optional[float] = None
        self.wait = 0
        self.should_stop = False

    def update(self, logs: dict) -> bool:
        value = logs.get(self.monitor)
        if value is None:
            return False
        if _better(value, self.best, self.mode, self.min_delta):
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.should_stop = True
        return self.should_stop


class ReduceLROnPlateau:
    """torch-parity plateau scheduler (factor 0.1, threshold 1e-4 'rel',
    cooldown 0, min_lr 0) driving the optimizer's injected learning rate."""

    def __init__(self, initial_lr: float, patience: int = 5, factor: float = 0.1,
                 threshold: float = 1e-4, mode: str = "min", min_lr: float = 0.0):
        self.lr = float(initial_lr)
        self.patience = patience
        self.factor = factor
        self.threshold = threshold
        self.mode = mode
        self.min_lr = min_lr
        self.best: Optional[float] = None
        self.num_bad = 0

    def _improved(self, value: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return value < self.best * (1 - self.threshold)
        return value > self.best * (1 + self.threshold)

    def update(self, value: float) -> float:
        """Returns the (possibly reduced) learning rate."""
        if self._improved(value):
            self.best = value
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr
