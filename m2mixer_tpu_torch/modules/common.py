"""Shared layers: torch-default init, the compute-dtype policy, GELU flavors.

Counterpart of ``m2mixer_tpu/modules/common.py``. Parameters are always
float32; a module built with ``dtype=torch.bfloat16`` computes in bf16, as
flax's ``dtype=`` does (inputs and parameters cast before the op, the output
in the compute dtype). The GELU flavor and the compute dtype are explicit
constructor arguments, never process-wide switches.

Initialization takes an explicit CPU ``torch.Generator``: parameters are
drawn on the CPU, so one seed gives the same weights whatever device the
network is moved to afterwards. Dropout in training mode draws from the
network's ``DropoutRNG`` (the counterpart of flax's ``dropout`` rng stream),
which the task installs with ``set_dropout_rng``; stochastic depth draws from
its ``DepthRNG`` (flax's ``stochastic`` stream), installed with
``set_depth_rng``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Linear", "LayerNorm", "Dropout", "DropoutRNG", "DepthRNG", "PatchEmbed", "gelu",
           "set_depth_rng", "set_dropout_rng", "survives", "uniform_"]


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


class DropoutRNG:
    """A network's dropout randomness (flax's ``make_rng("dropout")``): masks
    of the plain ``Dropout`` layers come from a generator on the network's
    device, the per-call seeds of the kernel-backed blocks from a CPU
    generator (drawing them needs no device sync)."""

    def __init__(self, seed: int, device="cpu"):
        device = torch.device(device)
        self.host = torch.Generator().manual_seed(int(seed) + 1)
        self.device = (torch.Generator(device=device).manual_seed(int(seed) + 2)
                       if device.type != "cpu" else self.host)

    def next_seed(self) -> int:
        """A fresh kernel seed in [0, 2**31 - 1), as the JAX blocks draw it."""
        return int(torch.randint(0, 2**31 - 1, (1,), generator=self.host))


def set_dropout_rng(module: nn.Module, rng: Optional[DropoutRNG]) -> None:
    """Point every dropout-drawing submodule of ``module`` at ``rng``."""
    for m in module.modules():
        if hasattr(m, "dropout_rng"):
            m.dropout_rng = rng


def next_kernel_seed(rng: Optional[DropoutRNG]) -> int:
    """The seed of one kernel call: from ``rng``, or torch's global generator."""
    if rng is not None:
        return rng.next_seed()
    return int(torch.randint(0, 2**31 - 1, (1,)))


class DepthRNG:
    """A network's stochastic-depth randomness (flax's ``make_rng("stochastic")``):
    one Bernoulli(survival) draw per block per training forward, from a CPU
    generator of its own, so that switching stochastic depth on or off does
    not shift the dropout streams. The draws are not ``jax.random``'s."""

    def __init__(self, seed: int):
        self.host = torch.Generator().manual_seed(int(seed) + 3)

    def keep(self, survival_prob: float) -> bool:
        return bool(torch.rand((), generator=self.host) < survival_prob)


def set_depth_rng(module: nn.Module, rng: Optional[DepthRNG]) -> None:
    """Point every stochastic-depth block of ``module`` at ``rng``."""
    for m in module.modules():
        if hasattr(m, "depth_rng"):
            m.depth_rng = rng


def survives(block: nn.Module, survival_prob: float) -> bool:
    """Whether ``block`` runs in this forward: always in eval mode or at
    survival 1; in training one draw from its ``depth_rng`` (torch's global
    generator when none is set). A dropped block is the identity."""
    if not block.training or survival_prob >= 1.0:
        return True
    rng = block.depth_rng
    if rng is not None:
        return rng.keep(survival_prob)
    return bool(torch.rand(()) < survival_prob)


class Dropout(nn.Module):
    """Dropout, the identity in eval mode (flax ``nn.Dropout`` semantics:
    keep with probability 1 - rate, scale kept values by 1 / (1 - rate)).
    ``bits`` is the JAX package's ``model.bits_dropout`` flavor: one uint8 per
    element, drop probability quantized to ``thresh / 256`` with
    ``thresh = clamp(round(rate * 256), 1, 255)``, kept values scaled by
    ``1 / (1 - thresh / 256)``. Masks come from ``dropout_rng`` (see
    ``set_dropout_rng``), or torch's global generator when none is set."""

    def __init__(self, rate: float, bits: bool = False):
        super().__init__()
        self.rate = float(rate)
        self.bits = bool(bits)
        self.dropout_rng: Optional[DropoutRNG] = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        gen = None if self.dropout_rng is None else self.dropout_rng.device
        if self.bits:
            if self.rate >= 255.5 / 256:
                return torch.zeros_like(x)
            thresh = min(max(int(round(self.rate * 256)), 1), 255)
            bits = torch.randint(0, 256, x.shape, generator=gen, device=x.device,
                                 dtype=torch.uint8)
            return x * (bits >= thresh).to(x.dtype) / (1.0 - thresh / 256.0)
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


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
