"""Array-backed data module (the port's copy of ``m2mixer_tpu/datasets/base.py``).

In-memory splits of parallel numpy arrays, batched by slicing on the host;
the trainer moves each batch to the device.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

__all__ = ["ArrayDataModule", "Batch"]

Batch = Dict[str, np.ndarray]


class ArrayDataModule:
    """``self.splits[stage]`` is a dict of equally long arrays; batches are
    contiguous (or permuted) slices."""

    def __init__(self, batch_size: int, shuffle_train: bool = False,
                 shuffle_test: bool = False, seed: int = 0, drop_last: bool = False):
        self.batch_size = int(batch_size)
        self.shuffle_train = shuffle_train
        self.shuffle_test = shuffle_test
        self.drop_last = drop_last
        self.splits: Dict[str, Dict[str, np.ndarray]] = {}
        self._rng = np.random.RandomState(seed)

    def setup(self, stage=None) -> None:
        pass

    def split_size(self, stage: str) -> int:
        return len(next(iter(self.splits[stage].values())))

    def epoch_order(self, stage: str, shuffle: bool) -> np.ndarray:
        n = self.split_size(stage)
        return self._rng.permutation(n) if shuffle else np.arange(n)

    def _iterate(self, stage: str, shuffle: bool) -> Iterator[Batch]:
        arrays = self.splits[stage]
        n = self.split_size(stage)
        order = self.epoch_order(stage, shuffle)
        bs = self.batch_size
        end = (n // bs) * bs if self.drop_last else n
        for start in range(0, end, bs):
            idx = order[start:min(start + bs, end)]
            yield {k: v[idx] for k, v in arrays.items()}

    def train_batches(self) -> Iterator[Batch]:
        return self._iterate("train", self.shuffle_train)

    def val_batches(self) -> Iterator[Batch]:
        return self._iterate("val", False)

    def test_batches(self) -> Iterator[Batch]:
        return self._iterate("test", self.shuffle_test)
