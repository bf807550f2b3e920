"""MIMIC-III data (the port's copy of ``m2mixer_tpu/datasets/mimic.py``).

Reads the ``im.pk`` pickle (``ep_tdata`` (N, 24, 12), ``adm_features_all``
(N, 5), ``adm_labels_all`` (N, 6), ``y_icd9`` (N, 20)), zeroes inf and nan,
applies the global z-normalization in float64, and derives the label: for
``task < 0`` the first positive admission column of 1-5 (in that order of
precedence), else class 0; otherwise ``y_icd9[:, task]``. The samples are
shuffled with ``random.seed(10)`` and split val = the first 10%, test = the
next 10%, train = the rest. Batches are dicts ``static`` / ``time`` /
``label``. ``python -m m2mixer_tpu_torch.datasets.surrogate mimic OUT``
writes a surrogate pickle.
"""

from __future__ import annotations

import os
import pickle
import random
from typing import Optional

import numpy as np

from .base import ArrayDataModule

__all__ = ["MIMICDataModule"]


def _split(dm: ArrayDataModule, arrays, n: int) -> None:
    dm.splits["val"] = {k: v[: n // 10] for k, v in arrays.items()}
    dm.splits["test"] = {k: v[n // 10 : n // 5] for k, v in arrays.items()}
    dm.splits["train"] = {k: v[n // 5 :] for k, v in arrays.items()}


class MIMICDataModule(ArrayDataModule):
    def __init__(self, data_dir: str, task: int = -1, batch_size: int = 32,
                 num_workers: int = 1, train_shuffle: bool = True,
                 filename: str = "im.pk", **kwargs):
        super().__init__(batch_size=batch_size, shuffle_train=train_shuffle)
        self.data_dir = data_dir
        self.task = int(task)
        self.filename = filename

    def setup(self, stage: Optional[str] = None) -> None:
        if self.splits:
            return
        with open(os.path.join(self.data_dir, self.filename), "rb") as f:
            datafile = pickle.load(f)
        X_t = np.asarray(datafile["ep_tdata"], np.float64)
        X_s = np.asarray(datafile["adm_features_all"], np.float64)
        X_t[~np.isfinite(X_t)] = 0
        X_s[~np.isfinite(X_s)] = 0
        X_s = (X_s - X_s.mean(axis=0)) / X_s.std(axis=0)
        X_t = (X_t - X_t.mean(axis=(0, 1))) / X_t.std(axis=(0, 1))
        if self.task < 0:
            adm = np.asarray(datafile["adm_labels_all"])
            y = np.select([adm[:, c] > 0 for c in range(1, 6)], [1, 2, 3, 4, 5], default=0)
        else:
            y = np.asarray(datafile["y_icd9"])[:, self.task].astype(np.int64)
        n = len(y)
        order = list(range(n))
        random.seed(10)
        random.shuffle(order)
        order = np.asarray(order)
        arrays = {"static": X_s[order].astype(np.float32), "time": X_t[order].astype(np.float32),
                  "label": y[order].astype(np.int32)}
        _split(self, arrays, n)

    @classmethod
    def synthetic(cls, n: int = 256, batch_size: int = 32, seed: int = 0):
        """MIMIC-shaped random data (no file) for tests and benchmarks."""
        rng = np.random.RandomState(seed)
        dm = cls(data_dir="unused", batch_size=batch_size)
        arrays = {"static": rng.randn(n, 5).astype(np.float32),
                  "time": rng.randn(n, 24, 12).astype(np.float32),
                  "label": rng.randint(0, 6, (n,)).astype(np.int32)}
        _split(dm, arrays, n)
        return dm
