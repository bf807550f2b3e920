"""GradBlend loss-weight estimation (Wang et al., CVPR 2020); counterpart of
``m2mixer_tpu/modules/gradblend.py``.

Per modality, a copy of its encoder and head trains for ``epochs`` sweeps of
a 90% cut of the training split with a fresh Adam; the summed batch losses
on that cut and on the other 10%, before and after, give the overfitting
``O = dO_Nn - dO_N`` and the generalization ``G = L_val_after -
L_val_before``, and the branch weight ``w = |O / G^2|``. The fused branch
does the same with frozen copies of the encoders (run in train mode, as the
reference keeps them) under trainable copies of the fusion mixer and the
classifier. The weights are normalized to a sum of 1.

The copies never touch the live network: they are deep copies whose dropout
and stochastic-depth streams are fresh ones seeded from ``trainer.seed +
17``, so the live network's parameters, gradients, mode and random streams
are the same before and after an estimate. Kernel-backed blocks stay kernel
backed in their copies: on the GPU every sub-training step runs K2f/K2b (or
K1f/K1b), the frozen encoders forward only.
"""

from __future__ import annotations

import copy
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

from .common import DepthRNG, DropoutRNG

__all__ = ["GradBlend", "estimate_gradblend_weights"]


class GradBlend:
    """Generic estimator: ``get_weights`` takes one ``(module, loss_fn)`` per
    branch, ``loss_fn(module, batch) -> scalar`` evaluated in the module's
    current mode; the module's parameters that require a gradient train."""

    def __init__(self, epochs: int = 20, learning_rate: float = 1e-3):
        self.epochs = int(epochs)
        self.learning_rate = float(learning_rate)

    @staticmethod
    def _sum_loss(module, loss_fn, batches: Iterable) -> float:
        # the reference sums the batch losses over the loader, as floats
        module.eval()
        with torch.no_grad():
            losses = [loss_fn(module, b).detach() for b in batches]
        return float(torch.stack(losses).double().sum())

    def get_weights(self, branches: Iterable, train_batches: Callable[[], Iterable],
                    val_batches: Callable[[], Iterable]) -> np.ndarray:
        weights = []
        for module, loss_fn in branches:
            params = [p for p in module.parameters() if p.requires_grad]
            # optax.adam's defaults: betas 0.9 / 0.999, eps 1e-8
            opt = torch.optim.Adam(params, lr=self.learning_rate, betas=(0.9, 0.999), eps=1e-8)
            l_n_train = self._sum_loss(module, loss_fn, train_batches())
            l_n_val = self._sum_loss(module, loss_fn, val_batches())
            module.train()
            for _ in range(self.epochs):
                for batch in train_batches():
                    opt.zero_grad(set_to_none=True)
                    loss_fn(module, batch).backward()
                    opt.step()
            l_nn_train = self._sum_loss(module, loss_fn, train_batches())
            l_nn_val = self._sum_loss(module, loss_fn, val_batches())
            o = (l_nn_val - l_nn_train) - (l_n_val - l_n_train)
            g = l_nn_val - l_n_val
            weights.append(abs(o / (g * g + 1e-12)))
        w = np.asarray(weights, np.float64)
        return (w / w.sum()).astype(np.float32)


def _pool(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1, x.shape[-1]).mean(dim=1) if x.dim() > 2 else x


class _ModalityBranch(nn.Module):
    def __init__(self, encoder, head, key: str):
        super().__init__()
        self.encoder, self.head, self.key = encoder, head, key

    def forward(self, batch):
        return self.head(_pool(self.encoder(batch[self.key])))


class _FusedBranch(nn.Module):
    """Frozen encoders, their outputs rank-harmonized (unsqueezed at axis 1)
    and concatenated on axis 1, as the reference's MultiModalEncoder does
    (not through the task's ``fusion``); then the trainable mixer and
    classifier."""

    def __init__(self, encoders, keys, mixer, classifier):
        super().__init__()
        self.encoders, self.keys = nn.ModuleList(encoders), tuple(keys)
        self.mixer, self.classifier = mixer, classifier
        for p in self.encoders.parameters():
            p.requires_grad_(False)

    def forward(self, batch):
        encs = [enc(batch[k]) for enc, k in zip(self.encoders, self.keys)]
        rank = max(e.dim() for e in encs)
        encs = [e[:, None] if e.dim() < rank else e for e in encs]
        return self.classifier(_pool(self.mixer(torch.cat(encs, dim=1))))


def _batches(arrays, lo: int, hi: int, bs: int, device) -> list:
    """Full batches of rows [lo, hi) (drop-last), or the one short batch
    when the cut is smaller than a batch; on ``device``."""
    n_full = (hi - lo) // bs
    bounds = [(lo, hi)] if n_full == 0 else [(lo + i * bs, lo + (i + 1) * bs)
                                             for i in range(n_full)]
    return [{k: torch.from_numpy(np.ascontiguousarray(v[a:b])).to(device)
             for k, v in arrays.items()} for a, b in bounds]


def estimate_gradblend_weights(task, trainer) -> Optional[np.ndarray]:
    """GradBlend weights ordered like ``task.loss_names`` for a
    ``MultiLossTask`` and its trainer (``trainer.datamodule.splits['train']``,
    ``.batch_size``, ``trainer.seed``); None without a data module or with
    paired encoders. The train split is cut 10% (validation, first) / 90%
    (training); an empty 10% cut raises."""
    datamodule = getattr(trainer, "datamodule", None)
    if datamodule is None:
        return None
    net = task.network
    if getattr(net, "paired_encoder", None) is not None:
        print("[gradblend] paired_encoders is enabled; per-modality weight "
              "estimation is unavailable — keeping previous weights")
        return None
    arrays = datamodule.splits["train"]
    n = len(next(iter(arrays.values())))
    cut = int(n * 0.1)
    if cut == 0:
        raise ValueError(f"GradBlend needs at least 10 training samples for its 10% "
                         f"validation cut (got {n})")
    bs = int(datamodule.batch_size)
    train = _batches(arrays, cut, n, bs, task.device)
    val = _batches(arrays, 0, cut, bs, task.device)

    keys = task.gradblend_modality_keys()
    mixer_field = "fusion_mixer" if hasattr(net, "fusion_mixer") else "fusion_encoder"
    seed = int(trainer.seed) + 17

    def copies(*modules):
        # fresh random streams in place of the live network's: the copies'
        # dropout and stochastic depth draw from their own
        memo = {id(task.dropout_rng): DropoutRNG(seed, task.device),
                id(task.depth_rng): DepthRNG(seed)}
        return copy.deepcopy(nn.ModuleList(modules), memo)

    def loss_fn(module, batch):
        return task.gradblend_loss(module(batch), batch)

    def branch(i):
        if i < len(keys):
            enc, head = copies(net.encoders[i], net.heads[i])
            return _ModalityBranch(enc, head, keys[i]), loss_fn
        *encs, mixer, classifier = copies(*net.encoders, getattr(net, mixer_field),
                                          net.classifier)
        return _FusedBranch(encs, keys, mixer, classifier), loss_fn

    gb = GradBlend(epochs=task.gb_epochs)
    # a generator: each branch is copied as its sub-training starts
    w = gb.get_weights((branch(i) for i in range(len(keys) + 1)), lambda: train, lambda: val)
    print(f"[gradblend] weights (order {task.loss_names}): {w}")
    return w
