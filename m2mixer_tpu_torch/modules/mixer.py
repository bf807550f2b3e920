"""MLP-Mixer blocks as plain PyTorch modules (the XLA path's counterpart).

Counterpart of ``m2mixer_tpu/modules/mixer.py:36-260``: ``FeedForward``,
``MixerBlock``, ``MLPMixer`` and ``FusionMixer`` with the same config keys
and submodule names, so the JAX parameter tree maps onto them leaf for leaf
(``utils/weights.py``). Every module exposes ``num_patch``: the fusion
shape inference sizes the fusion mixer from it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .common import Dropout, LayerNorm, Linear, PatchEmbed, gelu

__all__ = ["FeedForward", "MixerBlock", "MLPMixer", "FusionMixer"]


class FeedForward(nn.Module):
    """Linear -> GELU -> Dropout -> Linear -> Dropout over the last axis."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0,
                 out_dim: Optional[int] = None, *, dtype=None,
                 approximate_gelu: bool = False, bits_dropout: bool = False, generator=None):
        super().__init__()
        self.approximate_gelu = approximate_gelu
        self.fc1 = Linear(dim, hidden_dim, dtype=dtype, generator=generator)
        self.fc2 = Linear(hidden_dim, out_dim or dim, dtype=dtype, generator=generator)
        self.drop = Dropout(dropout, bits_dropout)

    def forward(self, x):
        x = self.drop(gelu(self.fc1(x), self.approximate_gelu))
        return self.drop(self.fc2(x))


class MixerBlock(nn.Module):
    """Pre-LN token mix + residual, then pre-LN channel mix + residual."""

    def __init__(self, hidden_dim: int, num_patch: int, token_dim: int, channel_dim: int,
                 dropout: float = 0.0, *, dtype=None, approximate_gelu: bool = False,
                 bits_dropout: bool = False, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, approximate_gelu=approximate_gelu, bits_dropout=bits_dropout,
                  generator=generator)
        self.norm_token = LayerNorm(hidden_dim, dtype=dtype)
        self.token_mix = FeedForward(num_patch, token_dim, dropout, **kw)
        self.norm_channel = LayerNorm(hidden_dim, dtype=dtype)
        self.channel_mix = FeedForward(hidden_dim, channel_dim, dropout, **kw)

    def forward(self, x):
        y = self.token_mix(self.norm_token(x).transpose(-1, -2)).transpose(-1, -2)
        x = x + y
        return x + self.channel_mix(self.norm_channel(x))


def _blocks(num_mixers, hidden_dim, num_patch, token_dim, channel_dim, dropout, **kw):
    return nn.ModuleList(MixerBlock(hidden_dim, num_patch, token_dim, channel_dim, dropout, **kw)
                         for _ in range(int(num_mixers)))


class FusionMixer(nn.Module):
    """MixerBlocks + final LN over an already-fused token sequence."""

    def __init__(self, hidden_dim: int, num_patches: int, num_mixers: int, token_dim: int,
                 channel_dim: int, dropout: float = 0.0, *, dtype=None,
                 approximate_gelu: bool = False, bits_dropout: bool = False, generator=None):
        super().__init__()
        self.num_patch = int(num_patches)
        self.blocks = _blocks(num_mixers, hidden_dim, num_patches, token_dim, channel_dim,
                              dropout, dtype=dtype, approximate_gelu=approximate_gelu,
                              bits_dropout=bits_dropout, generator=generator)
        self.norm_out = LayerNorm(hidden_dim, dtype=dtype)

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return self.norm_out(x)


def image_tokens(image_size: Sequence[int], patch_size: int) -> int:
    ih, iw = image_size
    if ih % patch_size or iw % patch_size:
        raise ValueError("Image dimensions must be divisible by the patch size.")
    return (ih // patch_size) * (iw // patch_size)


class MLPMixer(nn.Module):
    """Patch embed (reshape + GEMM) -> MixerBlocks -> LN; NCHW input."""

    def __init__(self, in_channels: int, hidden_dim: int, patch_size: int,
                 image_size: Sequence[int], num_mixers: int, token_dim: int,
                 channel_dim: int, dropout: float = 0.0, *, dtype=None,
                 approximate_gelu: bool = False, bits_dropout: bool = False, generator=None):
        super().__init__()
        self.num_patch = image_tokens(image_size, patch_size)
        self.patch_embed = PatchEmbed(in_channels, hidden_dim, patch_size, dtype=dtype,
                                      generator=generator)
        self.blocks = _blocks(num_mixers, hidden_dim, self.num_patch, token_dim, channel_dim,
                              dropout, dtype=dtype, approximate_gelu=approximate_gelu,
                              bits_dropout=bits_dropout, generator=generator)
        self.norm_out = LayerNorm(hidden_dim, dtype=dtype)

    def forward(self, x: torch.Tensor):
        x = self.patch_embed(x)
        for block in self.blocks:
            x = block(x)
        return self.norm_out(x)
