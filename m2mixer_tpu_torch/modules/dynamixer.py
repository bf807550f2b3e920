"""The DynaMixer family as PyTorch modules.

Counterpart of ``m2mixer_tpu/modules/dynamixer.py``: ``DynaMixerOp``,
``DynaMixerBlock``, ``DynaMixer`` and ``FusionDynaMixer`` with the same
config keys and submodule names (``patch_embed``, ``block_i``, ``mix_h``,
``mix_w``, ``compress``, ``generate``, ``out``, ``mlp_c``, ``reweight/fc1``,
``reweight/fc2``, ``proj``, ``norm_out``), so the JAX parameter tree maps onto
them leaf for leaf (``utils/weights.py``).

``DynaMixerOp`` has one path: its forward hands its three ``Linear`` layers'
float32 weights, as they are (output-major), to ``fused_dynamixer_op``, which
launches K4f (and K4b for the gradient) on a CUDA tensor and runs the
plain version on a CPU tensor, in the module's compute dtype. The JAX module
computes the same function with flax einsums (the TPU kernel cannot lower the
7-token grid's reshapes). In bf16 the two round at different places: flax
rounds every Linear output, the softmax and the mix to bf16, the kernel keeps
those in float32 (``_op_math``'s casts), and its output is rounded to bf16
once, where flax's op hands bf16 to the block (``ROADMAP.md`` §3 records the
measured gap).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..ops.dynamixer_kernel import fused_dynamixer_op
from .common import Dropout, LayerNorm, Linear, PatchEmbed
from .mixer import FeedForward, image_tokens

__all__ = ["DynaMixerOp", "DynaMixerBlock", "DynaMixer", "FusionDynaMixer"]


class DynaMixerOp(nn.Module):
    """Dynamic token mixing over a length-``seq_len`` axis: compress ``dim ->
    num_head*reduced_dim``, generate per-head ``L x L`` weights, softmax over
    the source token, mix tokens per head, output projection."""

    def __init__(self, dim: int, seq_len: int, num_head: int, reduced_dim: int = 2, *,
                 dtype=None, generator=None):
        super().__init__()
        self.num_head, self.reduced_dim = int(num_head), int(reduced_dim)
        self.compute_dtype = dtype or torch.float32
        kw = dict(dtype=dtype, generator=generator)
        self.compress = Linear(dim, num_head * reduced_dim, **kw)
        self.generate = Linear(seq_len * reduced_dim, seq_len * seq_len, **kw)
        self.out = Linear(dim, dim, **kw)

    def forward(self, x):
        params = [t for lin in (self.compress, self.generate, self.out)
                  for t in (lin.weight, lin.bias)]
        out = fused_dynamixer_op(x.float(), params, self.num_head, self.reduced_dim,
                                 compute_dtype=self.compute_dtype)
        return out.to(self.compute_dtype)


class DynaMixerBlock(nn.Module):
    """Column mix + row mix over the 2-D patch grid + a channel Linear,
    combined by a learned 3-way softmax reweighting, then ``proj`` and
    dropout. No residual and no LayerNorm (as the JAX block). Input ``(b, h,
    w, c)`` with ``h == w == num_patch``."""

    def __init__(self, hidden_dim: int, num_patch: int = 7, num_head: int = 8,
                 reduced_dim: int = 2, qkv_bias: bool = False, dropout: float = 0.0, *,
                 dtype=None, approximate_gelu: bool = False, bits_dropout: bool = False,
                 generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.mix_h = DynaMixerOp(hidden_dim, num_patch, num_head, reduced_dim, **kw)
        self.mix_w = DynaMixerOp(hidden_dim, num_patch, num_head, reduced_dim, **kw)
        self.mlp_c = Linear(hidden_dim, hidden_dim, bias=qkv_bias, **kw)
        self.reweight = FeedForward(hidden_dim, hidden_dim // 4, out_dim=hidden_dim * 3,
                                    approximate_gelu=approximate_gelu, **kw)
        self.proj = Linear(hidden_dim, hidden_dim, **kw)
        self.drop = Dropout(dropout, bits_dropout)

    def forward(self, x):
        B, H, W, C = x.shape
        xh = x.transpose(1, 2).contiguous().reshape(B * W, H, C)
        h = self.mix_h(xh).reshape(B, W, H, C).transpose(1, 2)
        w = self.mix_w(x.contiguous().reshape(B * H, W, C)).reshape(B, H, W, C)
        c = self.mlp_c(x)
        a = self.reweight((h + w + c).mean(dim=(1, 2)))  # (B, 3C)
        a = torch.softmax(a.reshape(B, C, 3).permute(2, 0, 1), dim=0)[:, :, None, None, :]
        return self.drop(self.proj(h * a[0] + w * a[1] + c * a[2]))


def _blocks(num_mixers, hidden_dim, grid, num_head, reduced_dim, qkv_bias, dropout, **kw):
    return nn.ModuleList(DynaMixerBlock(hidden_dim, grid, num_head, reduced_dim, qkv_bias,
                                        dropout, **kw) for _ in range(int(num_mixers)))


class DynaMixer(nn.Module):
    """Patch embed keeping the 2-D grid -> DynaMixerBlocks -> LN; NCHW input."""

    def __init__(self, in_channels: int, hidden_dim: int, patch_size: int,
                 image_size: Sequence[int], num_mixers: int, num_head: int = 8,
                 reduced_dim: int = 2, qkv_bias: bool = False, dropout: float = 0.0, *,
                 dtype=None, approximate_gelu: bool = False, bits_dropout: bool = False,
                 generator=None):
        super().__init__()
        self.num_patch = image_tokens(image_size, patch_size)
        self.patch_embed = PatchEmbed(in_channels, hidden_dim, patch_size, keep_grid=True,
                                      dtype=dtype, generator=generator)
        self.blocks = _blocks(num_mixers, hidden_dim, image_size[0] // patch_size, num_head,
                              reduced_dim, qkv_bias, dropout, dtype=dtype,
                              approximate_gelu=approximate_gelu, bits_dropout=bits_dropout,
                              generator=generator)
        self.norm_out = LayerNorm(hidden_dim, dtype=dtype)

    def forward(self, x):
        x = self.patch_embed(x)
        for block in self.blocks:
            x = block(x)
        return self.norm_out(x)


class FusionDynaMixer(nn.Module):
    """DynaMixerBlocks over a fused square token grid (side
    ``sqrt(num_patches)``) -> LN."""

    def __init__(self, hidden_dim: int, num_patches: int, num_mixers: int, num_head: int = 8,
                 reduced_dim: int = 2, qkv_bias: bool = False, dropout: float = 0.0, *,
                 dtype=None, approximate_gelu: bool = False, bits_dropout: bool = False,
                 generator=None):
        super().__init__()
        self.num_patch = int(num_patches)
        self.blocks = _blocks(num_mixers, hidden_dim, int(math.sqrt(num_patches)), num_head,
                              reduced_dim, qkv_bias, dropout, dtype=dtype,
                              approximate_gelu=approximate_gelu, bits_dropout=bits_dropout,
                              generator=generator)
        self.norm_out = LayerNorm(hidden_dim, dtype=dtype)

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return self.norm_out(x)
