"""AV-MNIST data (the port's copy of ``m2mixer_tpu/datasets/avmnist.py``).

The npy layout ``{audio,image}/{train,test}_data.npy`` +
``{train,test}_labels.npy``; train = the first 55000 train samples, val the
rest (the same 55/60 share for smaller files); train unshuffled, test
shuffled, as the JAX package does. ``synthetic: true`` replaces the files
with seeded arrays of the same shapes; ``synthetic_learnable: true`` plants
a class signal in them.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

from .base import ArrayDataModule, Batch

__all__ = ["AVMnistDataModule", "synthetic_avmnist_arrays"]


def synthetic_avmnist_arrays(n: int, seed: int = 0, learnable: bool = False):
    """AV-MNIST-shaped arrays. ``learnable=True`` adds a bright patch whose
    position encodes the label to both modalities."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=(n,)).astype(np.int32)
    image = rng.rand(n, 1, 28, 28).astype(np.float32)
    audio = rng.rand(n, 1, 112, 112).astype(np.float32)
    if learnable:
        for i, y in enumerate(labels):
            r, c = divmod(int(y), 5)
            image[i, 0, r * 14 : r * 14 + 14, c * 5 : c * 5 + 5] += 3.0
            audio[i, 0, r * 56 : r * 56 + 56, c * 22 : c * 22 + 22] += 3.0
    else:
        image *= 255.0
        audio *= 255.0
    return {"image": image, "audio": audio, "label": labels}


class AVMnistDataModule(ArrayDataModule):
    def __init__(self, data_dir: str, batch_size: int, num_workers: int = 0,
                 p_muting: float = 0.0, shuffle_train: bool = False,
                 synthetic: bool = False, synthetic_sizes=(512, 128, 128),
                 synthetic_learnable: bool = False, mmap: bool = False, **kwargs):
        super().__init__(batch_size=batch_size, shuffle_train=shuffle_train, shuffle_test=True)
        self.data_dir = data_dir
        self.p_muting = float(p_muting)
        self.synthetic = synthetic
        self.synthetic_sizes = synthetic_sizes
        self.synthetic_learnable = synthetic_learnable
        self.mmap = bool(mmap)
        self._mute_rng = np.random.RandomState(1234)

    def setup(self, stage: Optional[str] = None) -> None:
        if self.splits:
            return
        if self.synthetic:
            n_train, n_val, n_test = self.synthetic_sizes
            train = synthetic_avmnist_arrays(n_train + n_val, seed=0,
                                             learnable=self.synthetic_learnable)
            test = synthetic_avmnist_arrays(n_test, seed=1, learnable=self.synthetic_learnable)
            self.splits["train"] = {k: v[:n_train] for k, v in train.items()}
            self.splits["val"] = {k: v[n_train:] for k, v in train.items()}
            self.splits["test"] = test
            return

        def load(stage_name):
            mm = "r" if self.mmap else None
            img = np.load(os.path.join(self.data_dir, "image", f"{stage_name}_data.npy"),
                          mmap_mode=mm)
            aud = np.load(os.path.join(self.data_dir, "audio", f"{stage_name}_data.npy"),
                          mmap_mode=mm)
            lab = np.load(os.path.join(self.data_dir, f"{stage_name}_labels.npy"))
            as32 = lambda a: a if a.dtype == np.float32 else np.asarray(a, np.float32)
            return {"image": as32(img.reshape(img.shape[0], 1, 28, 28)),
                    "audio": as32(aud[:, None, :, :]), "label": lab.astype(np.int32)}

        train = load("train")
        n = len(train["label"])
        n_val_start = 55000 if n >= 60000 else max(1, (n * 55) // 60)
        self.splits["train"] = {k: v[:n_val_start] for k, v in train.items()}
        self.splits["val"] = {k: v[n_val_start:] for k, v in train.items()}
        self.splits["test"] = load("test")

    def train_batches(self) -> Iterator[Batch]:
        for batch in super().train_batches():
            if self.p_muting > 0:
                batch = dict(batch)
                # batch-level random modality muting (JAX avmnist.py:124-136)
                r = self._mute_rng.rand(len(batch["label"]))
                which = self._mute_rng.rand(len(batch["label"])) <= 0.5
                mute = r <= self.p_muting
                img_mask = np.where(mute & which, 0.0, 1.0).astype(np.float32)
                aud_mask = np.where(mute & ~which, 0.0, 1.0).astype(np.float32)
                batch["image"] = batch["image"] * img_mask[:, None, None, None]
                batch["audio"] = batch["audio"] * aud_mask[:, None, None, None]
            yield batch
