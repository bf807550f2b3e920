"""Shared layers: torch-default init, the compute-dtype policy, GELU flavors.

Counterpart of ``m2mixer_tpu/modules/common.py``. Parameters are always
float32; a module built with ``dtype=torch.bfloat16`` computes in bf16, as
flax's ``dtype=`` does (inputs and parameters cast before the op, the output
in the compute dtype). The GELU flavor and the compute dtype are explicit
constructor arguments, never process-wide switches.

Initialization takes an explicit CPU ``torch.Generator``: parameters are
drawn on the CPU, so one seed gives the same weights whatever device the
network is moved to afterwards.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Linear", "LayerNorm", "Dropout", "PatchEmbed", "gelu", "uniform_"]


def uniform_(t: torch.Tensor, bound: float, generator: Optional[torch.Generator]):
    """In-place U(-bound, bound) from ``generator`` (torch's default Linear
    init: kaiming_uniform(a=sqrt(5)) == U(+-1/sqrt(fan_in)), bias likewise)."""
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def _bound(fan_in: int) -> float:
    return 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0


def gelu(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    """GELU: exact erf (torch ``nn.GELU()`` default) or the tanh form."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


class Linear(nn.Module):
    """Affine map with torch-default init; ``weight (out, in)``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features, self.out_features = int(in_features), int(out_features)
        self.dtype = dtype
        bound = _bound(self.in_features)
        self.weight = nn.Parameter(uniform_(torch.empty(out_features, in_features),
                                            bound, generator))
        self.bias = (nn.Parameter(uniform_(torch.empty(out_features), bound, generator))
                     if bias else None)

    def forward(self, x):
        if self.dtype is None:
            return F.linear(x, self.weight, self.bias)
        cd = self.dtype
        return F.linear(x.to(cd), self.weight.to(cd),
                        None if self.bias is None else self.bias.to(cd))


class LayerNorm(nn.Module):
    """LayerNorm over the trailing dim (eps 1e-5, learned scale and bias);
    float32 statistics, output in the compute dtype when one is set."""

    def __init__(self, dim: int, *, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dim = int(dim)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(self.dim))
        self.bias = nn.Parameter(torch.zeros(self.dim))

    def forward(self, x):
        out_dtype = self.dtype or torch.promote_types(x.dtype, torch.float32)
        y = F.layer_norm(x.float(), (self.dim,), self.weight, self.bias, 1e-5)
        return y.to(out_dtype)


class Dropout(nn.Module):
    """Dropout; the identity in eval mode. Training comes with the training
    slice, so a training-mode call with a non-zero rate raises."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x):
        if self.training and self.rate > 0.0:
            raise NotImplementedError("dropout in training mode comes with the "
                                      "training slice of the port")
        return x


class PatchEmbed(nn.Module):
    """Conv2d(kernel=stride=patch) patch embedding as reshape + GEMM.

    NCHW in; the flattening order ``(b, c, gh, p, gw, p) -> (b, gh, gw,
    c*p*p)`` is the JAX package's, so its ``proj`` kernel carries over
    unchanged (transposed once into ``weight``). Output ``(b, gh*gw, hidden)``,
    or the grid ``(b, gh, gw, hidden)`` with ``keep_grid``."""

    def __init__(self, in_channels: int, hidden_dim: int, patch_size: int,
                 keep_grid: bool = False, *, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.patch_size = int(patch_size)
        self.hidden_dim = int(hidden_dim)
        self.keep_grid = keep_grid
        p = self.patch_size
        self.proj = Linear(in_channels * p * p, hidden_dim, dtype=dtype, generator=generator)

    def forward(self, x):
        b, c, h, w = x.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        x = x.reshape(b, c, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5).reshape(b, gh, gw, c * p * p)
        x = self.proj(x)
        if self.keep_grid:
            return x
        return x.reshape(b, gh * gw, self.hidden_dim)
