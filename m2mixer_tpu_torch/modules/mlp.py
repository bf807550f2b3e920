"""Generic MLP encoder (counterpart of ``m2mixer_tpu/modules/mlp.py``).

``num_blocks`` x (Linear + ReLU + Dropout) named ``fc_{i}``, then an
optional output Linear ``fc_out``: the MIMIC static-tabular encoder and the
recurrent baseline's fusion encoder. The names are the JAX module's, so its
parameter tree maps leaf for leaf (``utils/weights.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .common import Dropout, Linear

__all__ = ["MLP"]


class MLP(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, num_blocks: int,
                 output_dim: Optional[int] = None, dropout: float = 0.0, *, dtype=None,
                 bits_dropout: bool = False, generator=None):
        super().__init__()
        self.num_blocks = int(num_blocks)
        for i in range(self.num_blocks):
            in_dim = int(input_dim) if i == 0 else int(hidden_dim)
            self.add_module(f"fc_{i}", Linear(in_dim, hidden_dim, dtype=dtype,
                                              generator=generator))
        self.fc_out = (Linear(hidden_dim, output_dim, dtype=dtype, generator=generator)
                       if output_dim is not None else None)
        self.drop = Dropout(dropout, bits_dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_blocks):
            x = self.drop(torch.relu(getattr(self, f"fc_{i}")(x)))
        return x if self.fc_out is None else self.fc_out(x)
