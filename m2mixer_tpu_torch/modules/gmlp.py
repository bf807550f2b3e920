"""The gMLP family as plain PyTorch modules (the XLA path's counterpart).

Counterpart of ``m2mixer_tpu/modules/gmlp.py:25-214``: ``SpatialGatingUnit``,
``GatingMlpBlock``, ``gMLP``, ``VisiongMLP`` and ``FusiongMLP`` with the same
config keys and submodule names (``norm``, ``proj_1``, ``sgu.norm``,
``sgu.proj``, ``proj_2``, ``patch_embedding``, ``gmlp.blocks.j``,
``cls_token``), so the JAX parameter tree maps onto them leaf for leaf
(``utils/weights.py``; the Dense layers there are bare flax ``nn.Dense``).
Initializers are the JAX ones: U(+-1/sqrt(fan_in)) for the Dense layers,
N(0, 0.02) weights and bias 1 for the token projection, zeros for the cls
token, all drawn from the explicit generator.

Stochastic depth: in training, block j of a stack of n survives with
probability ``linspace(prob_0_L[0], prob_0_L[1], n)[j]``, one draw per block
per forward from the network's ``DepthRNG``; a dropped block is the identity
(no rescaling) and computes nothing. In eval mode every block runs.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from .common import Dropout, LayerNorm, Linear, gelu, survives
from .mixer import image_tokens

__all__ = ["SpatialGatingUnit", "GatingMlpBlock", "gMLP", "VisiongMLP", "FusiongMLP",
           "patchify"]


def patchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """NCHW -> ``(b, (h w), (c p1 p2))`` (``gmlp.py:160-163``)."""
    b, c, h, w = x.shape
    p = patch_size
    gh, gw = h // p, w // p
    x = x.reshape(b, c, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, gh * gw, c * p * p)


def survival_probs(prob_0_L: Sequence[float], n_blocks: int):
    return [float(p) for p in np.linspace(prob_0_L[0], prob_0_L[1], int(n_blocks))]


class SpatialGatingUnit(nn.Module):
    """Split channels into u | v; LN and a token-axis Linear on v; ``u * v``."""

    def __init__(self, d_ffn: int, seq_len: int, dropout: float = 0.0, *, dtype=None,
                 bits_dropout: bool = False, generator=None):
        super().__init__()
        self.norm = LayerNorm(d_ffn // 2, dtype=dtype)
        self.proj = Linear(seq_len, seq_len, dtype=dtype, generator=generator)
        with torch.no_grad():
            self.proj.weight.normal_(0.0, 0.02, generator=generator)
            self.proj.bias.fill_(1.0)
        self.drop = Dropout(dropout, bits_dropout)

    def forward(self, x):
        u, v = x.chunk(2, dim=-1)
        v = self.drop(self.proj(self.norm(v).transpose(-1, -2)))
        return u * v.transpose(-1, -2)


class GatingMlpBlock(nn.Module):
    """Pre-LN -> proj to d_ffn -> dropout -> GELU -> SGU -> proj back ->
    dropout, with residual and stochastic depth."""

    def __init__(self, d_model: int, d_ffn: int, seq_len: int, survival_prob: float = 1.0,
                 dropout: float = 0.0, *, dtype=None, approximate_gelu: bool = False,
                 bits_dropout: bool = False, generator=None):
        super().__init__()
        self.survival_prob = float(survival_prob)
        self.approximate_gelu = approximate_gelu
        self.depth_rng = None
        self.norm = LayerNorm(d_model, dtype=dtype)
        self.proj_1 = Linear(d_model, d_ffn, dtype=dtype, generator=generator)
        self.sgu = SpatialGatingUnit(d_ffn, seq_len, dropout, dtype=dtype,
                                     bits_dropout=bits_dropout, generator=generator)
        self.proj_2 = Linear(d_ffn // 2, d_model, dtype=dtype, generator=generator)
        self.drop = Dropout(dropout, bits_dropout)

    def forward(self, x):
        if not survives(self, self.survival_prob):
            return x
        y = self.drop(self.proj_1(self.norm(x)))
        y = self.sgu(gelu(y, self.approximate_gelu))
        return x + self.drop(self.proj_2(y))


class gMLP(nn.Module):
    """``n_blocks`` GatingMlpBlocks (or ``block``s of the same signature) with
    linearly spaced survival probabilities."""

    def __init__(self, d_model: int, d_ffn: int, seq_len: int, n_blocks: int,
                 prob_0_L: Sequence[float] = (1.0, 0.5), dropout: float = 0.0, *, dtype=None,
                 approximate_gelu: bool = False, bits_dropout: bool = False, generator=None,
                 block=GatingMlpBlock):
        super().__init__()
        self.blocks = nn.ModuleList(
            block(d_model, d_ffn, seq_len, p, dropout, dtype=dtype,
                  approximate_gelu=approximate_gelu, bits_dropout=bits_dropout,
                  generator=generator)
            for p in survival_probs(prob_0_L, n_blocks))

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return x


class VisiongMLP(nn.Module):
    """Patchify + linear embed + gMLP stack; NCHW input. A subclass swaps the
    stack's blocks by setting ``block``."""

    block = GatingMlpBlock

    def __init__(self, image_size: Sequence[int], in_channels: int, patch_size: int,
                 d_model: int, d_ffn: int, n_blocks: int, prob_0_L: Sequence[float] = (1.0, 0.0),
                 dropout: float = 0.0, *, dtype=None, approximate_gelu: bool = False,
                 bits_dropout: bool = False, generator=None):
        super().__init__()
        self.patch_size = int(patch_size)
        self.num_patch = image_tokens(image_size, patch_size)
        self.patch_embedding = Linear(in_channels * patch_size ** 2, d_model, dtype=dtype,
                                      generator=generator)
        self.gmlp = gMLP(d_model, d_ffn, self.num_patch, n_blocks, prob_0_L, dropout,
                         dtype=dtype, approximate_gelu=approximate_gelu,
                         bits_dropout=bits_dropout, generator=generator, block=self.block)

    def forward(self, x):
        return self.gmlp(self.patch_embedding(patchify(x, self.patch_size)))


class FusiongMLP(nn.Module):
    """A learnable cls token prepended to the fused sequence + gMLP stack
    (``num_patches + 1`` tokens). A subclass swaps the stack's blocks by
    setting ``block``."""

    block = GatingMlpBlock

    def __init__(self, d_model: int, d_ffn: int, n_blocks: int, num_patches: int,
                 prob_0_L: Sequence[float] = (1.0, 0.0), dropout: float = 0.0, *, dtype=None,
                 approximate_gelu: bool = False, bits_dropout: bool = False, generator=None):
        super().__init__()
        self.num_patch = int(num_patches)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d_model))
        self.gmlp = gMLP(d_model, d_ffn, self.num_patch + 1, n_blocks, prob_0_L, dropout,
                         dtype=dtype, approximate_gelu=approximate_gelu,
                         bits_dropout=bits_dropout, generator=generator, block=self.block)

    def forward(self, x):
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], 1, -1)
        return self.gmlp(torch.cat([cls, x], dim=1))
