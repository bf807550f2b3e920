"""Classifier heads (the slice's part of
``m2mixer_tpu/modules/classification.py``)."""

from __future__ import annotations

from typing import Sequence

from torch import nn

from .common import Linear

__all__ = ["StandardClassifier"]


class StandardClassifier(nn.Module):
    """Reshape to ``(B, -1, D)``, mean over tokens, one Linear."""

    def __init__(self, input_shape: Sequence[int], num_classes: int, *, dtype=None,
                 generator=None):
        super().__init__()
        self.cls = Linear(input_shape[-1], num_classes, dtype=dtype, generator=generator)

    def forward(self, inputs):
        x = inputs.reshape(inputs.shape[0], -1, inputs.shape[-1]).mean(dim=1)
        return self.cls(x)
