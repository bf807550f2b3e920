"""GRU encoder (counterpart of ``m2mixer_tpu/modules/recurrent.py:82-130``).

It runs on ``torch.nn.GRU``, whose gates are the JAX package's
``TorchGRUCell`` (``:34-80``): r = sigmoid(W_ir x + b_ir + W_hr h + b_hr),
z likewise, n = tanh(W_in x + b_in + r (W_hn h + b_hn)), h' = (1 - z) n +
z h, each side with its own bias. torch stacks the three gates' rows in the
order (r, z, n) in ``weight_ih_l0`` / ``weight_hh_l0`` / ``bias_*_l0``;
``utils/weights.py`` maps the JAX cell's six Dense layers (``GRUCell_0/
{ir,iz,in,hr,hz,hn}``) onto them.

- ``last_only``: the final hidden state ``(B, hidden_dim)`` (no dropout or
  flattening on this path);
- otherwise the output sequence ``(B, T, hidden_dim)`` with dropout,
  flattened to ``(B, T * hidden_dim)`` with ``flatten``;
- ``has_padding``: the input is ``(x, lengths)`` and each sample's state at
  its true length is returned.

It computes in float32 at any ``model.precision``, as the JAX package's
MIMIC tasks build it (without a compute dtype).
"""

from __future__ import annotations

import torch
from torch import nn

from .common import Dropout, _bound, uniform_

__all__ = ["GRU", "GRU_GATES"]

#: the JAX cell's Dense layers in torch's row order of the stacked weights
GRU_GATES = (("ir", "iz", "in"), ("hr", "hz", "hn"))


class GRU(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, dropout: float = 0.1,
                 flatten: bool = False, has_padding: bool = False, last_only: bool = False,
                 batch_first: bool = True, *, bits_dropout: bool = False, generator=None):
        super().__init__()
        if not batch_first:
            raise NotImplementedError("not yet ported: GRU batch_first=False")
        self.hidden_dim = int(hidden_dim)
        self.flatten, self.has_padding, self.last_only = flatten, has_padding, last_only
        self.gru = nn.GRU(int(input_dim), self.hidden_dim, batch_first=True)
        bound = _bound(self.hidden_dim)  # torch's GRU init: U(+-1/sqrt(hidden))
        for p in self.gru.parameters():
            uniform_(p, bound, generator)
        self.drop = Dropout(dropout, bits_dropout)

    def forward(self, x):
        if self.has_padding:
            seq, lengths = x
            out = self.gru(seq.float())[0]
            idx = (lengths.long() - 1).clamp(0, seq.shape[1] - 1)
            return out[torch.arange(out.shape[0], device=out.device), idx]
        out = self.gru(x.float())[0]
        if self.last_only:
            return out[:, -1, :]
        out = self.drop(out)
        return out.reshape(out.shape[0], -1) if self.flatten else out
