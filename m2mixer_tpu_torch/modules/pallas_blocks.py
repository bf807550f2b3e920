"""Kernel-backed mixer blocks under the JAX package's block-type strings.

Counterpart of ``m2mixer_tpu/modules/pallas_blocks.py``: the same
``block_type`` names resolve to modules whose MixerBlocks run on the
hand-written CUDA kernels of ``ops/mixer_kernel.py`` (the plain PyTorch
version on CPU tensors):

- ``PallasMLPMixer`` / ``PallasFusionMixer``: one K1f launch per block
  (``fused_mixer_block``), then a LayerNorm module;
- ``PallasStackedMLPMixer`` / ``PallasStackedFusionMixer``: the whole block
  stack and its final LN as one K2f launch (``fused_mixer_stack``), or
  ceil(K/G) launches with ``stack_group_size=G``;
- ``PallasVisiongMLP`` / ``PallasFusiongMLP``: ``VisiongMLP`` / ``FusiongMLP``
  whose GatingMlpBlocks are ``PallasGatingMlpBlock``s, one K3f launch each
  (``ops/gmlp_kernel.py``, float32 only); stochastic depth stays outside the
  kernel, and a dropped block launches nothing. Their blocks sit under
  ``gmlp.blocks.j`` as the plain modules' do (JAX's kernel tree has
  ``block_j`` directly; ``utils/weights.py`` maps the two).

Parameters keep the JAX kernels' layout and names (``w1 (N, T)``,
``b{i}_w3 (D, C)``, ...), so the JAX trees map onto them without a transpose.
They are float32 at any compute dtype, as the JAX modules' are: in bf16 the
kernels read w3/w4 rounded to bf16 on each call and the gradients
come back in float32, so Adam updates float32 master weights. The mixer
blocks take any token count, as the JAX kernels do (above 32 tokens the
CUDA kernels run their token FF as products on the tensor cores). In training mode
every kernel call draws a fresh dropout seed from the module's
``dropout_rng``, as the JAX blocks draw one from the ``dropout`` rng.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.gmlp_kernel import GmlpBlockParams, fused_gmlp_block
from ..ops.mixer_kernel import MixerBlockParams, fused_mixer_block, fused_mixer_stack_grouped
from .common import LayerNorm, PatchEmbed, _bound, next_kernel_seed, survives, uniform_
from .gmlp import FusiongMLP, VisiongMLP
from .mixer import image_tokens

__all__ = [
    "PallasMixerBlock",
    "PallasMLPMixer",
    "PallasFusionMixer",
    "PallasStackedMLPMixer",
    "PallasStackedFusionMixer",
    "PallasGatingMlpBlock",
    "PallasVisiongMLP",
    "PallasFusiongMLP",
]


def _block_params(D: int, N: int, T: int, C: int, generator) -> dict:
    """One block's 12 parameters in ``MixerBlockParams`` order, JAX layout,
    float32, torch-default init (kernel (in, out) ~ U(+-1/sqrt(in)), bias
    likewise)."""

    def w(i, o):
        return uniform_(torch.empty(i, o), _bound(i), generator)

    def b(fan_in, n):
        return uniform_(torch.empty(n), _bound(fan_in), generator)

    return {
        "ln1_scale": torch.ones(D), "ln1_bias": torch.zeros(D),
        "w1": w(N, T), "b1": b(N, T), "w2": w(T, N), "b2": b(T, N),
        "ln2_scale": torch.ones(D), "ln2_bias": torch.zeros(D),
        "w3": w(D, C), "b3": b(D, C), "w4": w(C, D), "b4": b(C, D),
    }


class PallasMixerBlock(nn.Module):
    """One MixerBlock as one K1f launch."""

    def __init__(self, hidden_dim: int, num_patch: int, token_dim: int, channel_dim: int,
                 dropout: float = 0.0, *, dtype=None, approximate_gelu: bool = False,
                 generator=None):
        super().__init__()
        self.dropout = float(dropout)
        self.dtype = dtype
        self.approximate_gelu = approximate_gelu
        self.dropout_rng = None
        for name, t in _block_params(hidden_dim, num_patch, token_dim, channel_dim,
                                     generator).items():
            self.register_parameter(name, nn.Parameter(t))

    def forward(self, x):
        params = MixerBlockParams(*(getattr(self, f) for f in MixerBlockParams._fields))
        rate = self.dropout if self.training else 0.0
        seed = next_kernel_seed(self.dropout_rng) if rate > 0.0 else None
        return fused_mixer_block(x.float(), params, seed, rate, self.dtype or torch.float32,
                                 self.approximate_gelu)


class _PerBlockMixer(nn.Module):
    def __init__(self, hidden_dim, num_patch, num_mixers, token_dim, channel_dim, dropout,
                 dtype, approximate_gelu, generator):
        super().__init__()
        self.num_patch = int(num_patch)
        self.blocks = nn.ModuleList(
            PallasMixerBlock(hidden_dim, num_patch, token_dim, channel_dim, dropout,
                             dtype=dtype, approximate_gelu=approximate_gelu,
                             generator=generator)
            for _ in range(int(num_mixers)))
        self.norm_out = LayerNorm(hidden_dim, dtype=dtype)

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return self.norm_out(x)


class PallasMLPMixer(_PerBlockMixer):
    """``MLPMixer`` with one fused kernel per block (same config keys)."""

    def __init__(self, in_channels: int, hidden_dim: int, patch_size: int,
                 image_size: Sequence[int], num_mixers: int, token_dim: int,
                 channel_dim: int, dropout: float = 0.0, *, dtype=None,
                 approximate_gelu: bool = False, generator=None):
        n = image_tokens(image_size, patch_size)
        patch_embed = PatchEmbed(in_channels, hidden_dim, patch_size, dtype=dtype,
                                 generator=generator)
        super().__init__(hidden_dim, n, num_mixers, token_dim, channel_dim, dropout, dtype,
                         approximate_gelu, generator)
        self.patch_embed = patch_embed

    def forward(self, x):
        return super().forward(self.patch_embed(x))


class PallasFusionMixer(_PerBlockMixer):
    """``FusionMixer`` with one fused kernel per block (same config keys)."""

    def __init__(self, hidden_dim: int, num_patches: int, num_mixers: int, token_dim: int,
                 channel_dim: int, dropout: float = 0.0, *, dtype=None,
                 approximate_gelu: bool = False, generator=None):
        super().__init__(hidden_dim, num_patches, num_mixers, token_dim, channel_dim, dropout,
                         dtype, approximate_gelu, generator)


class _StackedMixerCore(nn.Module):
    """K MixerBlocks + final LN as one K2f launch (``group_size=0``) or as
    launches of G blocks each (``group_size=G``, final LN in the last)."""

    def __init__(self, hidden_dim: int, num_patch: int, token_dim: int, channel_dim: int,
                 num_mixers: int, dropout: float = 0.0, group_size: int = 0, *, dtype=None,
                 approximate_gelu: bool = False, generator=None):
        super().__init__()
        self.num_mixers = int(num_mixers)
        self.dropout = float(dropout)
        self.group_size = int(group_size)
        self.dtype = dtype
        self.approximate_gelu = approximate_gelu
        self.dropout_rng = None
        for i in range(self.num_mixers):
            for name, t in _block_params(hidden_dim, num_patch, token_dim, channel_dim,
                                         generator).items():
                self.register_parameter(f"b{i}_{name}", nn.Parameter(t))
        self.ln_out_scale = nn.Parameter(torch.ones(hidden_dim))
        self.ln_out_bias = nn.Parameter(torch.zeros(hidden_dim))

    def forward(self, x):
        blocks = [MixerBlockParams(*(getattr(self, f"b{i}_{f}") for f in MixerBlockParams._fields))
                  for i in range(self.num_mixers)]
        rate = self.dropout if self.training else 0.0
        seed = next_kernel_seed(self.dropout_rng) if rate > 0.0 else None
        return fused_mixer_stack_grouped(
            x.float(), blocks, self.ln_out_scale, self.ln_out_bias, seed, rate,
            self.dtype or torch.float32, group_size=self.group_size,
            approximate_gelu=self.approximate_gelu)


class PallasStackedMLPMixer(nn.Module):
    """``MLPMixer`` whose block stack runs as one kernel (same config keys,
    plus ``stack_group_size``)."""

    def __init__(self, in_channels: int, hidden_dim: int, patch_size: int,
                 image_size: Sequence[int], num_mixers: int, token_dim: int,
                 channel_dim: int, dropout: float = 0.0, stack_group_size: int = 0, *,
                 dtype=None, approximate_gelu: bool = False, generator=None):
        super().__init__()
        self.num_patch = image_tokens(image_size, patch_size)
        self.patch_embed = PatchEmbed(in_channels, hidden_dim, patch_size, dtype=dtype,
                                      generator=generator)
        self.stack = _StackedMixerCore(hidden_dim, self.num_patch, token_dim, channel_dim,
                                       num_mixers, dropout, stack_group_size, dtype=dtype,
                                       approximate_gelu=approximate_gelu, generator=generator)

    def forward(self, x):
        return self.stack(self.patch_embed(x))


class PallasStackedFusionMixer(nn.Module):
    """``FusionMixer`` as one kernel (same config keys, plus
    ``stack_group_size``)."""

    def __init__(self, hidden_dim: int, num_patches: int, num_mixers: int, token_dim: int,
                 channel_dim: int, dropout: float = 0.0, stack_group_size: int = 0, *,
                 dtype=None, approximate_gelu: bool = False, generator=None):
        super().__init__()
        self.num_patch = int(num_patches)
        self.stack = _StackedMixerCore(hidden_dim, self.num_patch, token_dim, channel_dim,
                                       num_mixers, dropout, stack_group_size, dtype=dtype,
                                       approximate_gelu=approximate_gelu, generator=generator)

    def forward(self, x):
        return self.stack(x)


class PallasGatingMlpBlock(nn.Module):
    """One GatingMlpBlock as one K3f launch (``fused_gmlp_block``), with its
    parameters flat in the kernel's layout and the JAX names."""

    def __init__(self, d_model: int, d_ffn: int, seq_len: int, survival_prob: float = 1.0,
                 dropout: float = 0.0, *, dtype=None, approximate_gelu: bool = False,
                 bits_dropout: bool = False, generator=None):
        # bits_dropout is accepted and ignored: the kernel's masks keep a 32-bit
        # threshold, as the JAX kernel's do
        super().__init__()
        self.survival_prob = float(survival_prob)
        self.dropout = float(dropout)
        self.dtype = dtype
        self.approximate_gelu = approximate_gelu
        self.dropout_rng = None
        self.depth_rng = None
        D, F, N, H = d_model, d_ffn, seq_len, d_ffn // 2
        u = lambda fan, *shape: uniform_(torch.empty(*shape), _bound(fan), generator)
        params = {
            "ln_scale": torch.ones(D), "ln_bias": torch.zeros(D),
            "w_in": u(D, D, F), "b_in": u(D, F),
            "sgu_ln_scale": torch.ones(H), "sgu_ln_bias": torch.zeros(H),
            "sgu_w": torch.empty(N, N).normal_(0.0, 0.02, generator=generator),
            "sgu_b": torch.ones(N),
            "w_out": u(H, H, D), "b_out": u(H, D),
        }
        for name, t in params.items():
            self.register_parameter(name, nn.Parameter(t))

    def forward(self, x):
        rate = self.dropout if self.training else 0.0
        # the kernel seed first, so a dropped block does not shift the stream
        seed = next_kernel_seed(self.dropout_rng) if rate > 0.0 else None
        if not survives(self, self.survival_prob):
            return x
        params = GmlpBlockParams(*(getattr(self, f) for f in GmlpBlockParams._fields))
        return fused_gmlp_block(x.float(), params, seed, rate, self.dtype or torch.float32,
                                self.approximate_gelu)


class PallasVisiongMLP(VisiongMLP):
    """``VisiongMLP`` with one fused kernel per block (same config keys)."""

    block = PallasGatingMlpBlock


class PallasFusiongMLP(FusiongMLP):
    """``FusiongMLP`` with one fused kernel per block (same config keys)."""

    block = PallasGatingMlpBlock
