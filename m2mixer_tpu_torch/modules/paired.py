"""Paired dual-modality MLP-Mixer (counterpart of ``m2mixer_tpu/modules/paired.py``).

``model.paired_encoders: true`` runs the image and audio encoders, when both
are ``MLPMixer``s of one block geometry (``can_pair``), as one chain of
modality-batched products: each output equals the modular ``MLPMixer``
applied with that modality's weights, in float32. The parameters keep the
JAX module's names and layouts, all float32: a ``PatchEmbed`` per modality
(``patch_embed_0`` / ``patch_embed_1``, ``proj``), then one layer-stacked
leaf per role, ``(L, 2, in, out)`` kernels (input-major, as the JAX leaves
are), ``(L, 2, out)`` biases, ``(L, 2, D)`` LayerNorm vectors and the
``(2, D)`` output LN, so ``utils/weights.py`` maps them without a transpose.
``pair_mlp_mixer_params`` and its inverse ``unpair_mlp_mixer_params`` move
weights between two modular ``MLPMixer`` trees and the paired one, in the
JAX tree layout (what ``to_jax_params`` gives).

The dtypes follow the JAX module op for op, not the modular blocks': the
residual stream is carried in the compute dtype, the LayerNorm (``_pln``)
computes its statistics in the compute dtype (the modular ``LayerNorm``
takes them in float32), and each product sums in float32 and returns the
compute dtype (``_pdot``). In bf16 the paired encoders therefore round at
other points than two ``MLPMixer``s would.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .common import Dropout, PatchEmbed, _bound, gelu, uniform_
from .mixer import image_tokens

__all__ = ["PairedMLPMixer", "can_pair", "pair_mlp_mixer_params", "unpair_mlp_mixer_params"]

#: the layer-stacked leaves: (name, input width, output width) by the block's sizes
_FF_LEAVES = (("token_fc1", "N", "T"), ("token_fc2", "T", "N"),
              ("channel_fc1", "D", "C"), ("channel_fc2", "C", "D"))


def can_pair(cfg0, cfg1) -> bool:
    """Two modality block configs run paired iff both are ``MLPMixer`` with
    the same block geometry (their patch-embed input widths may differ)."""
    if cfg0.get("block_type") != "MLPMixer" or cfg1.get("block_type") != "MLPMixer":
        return False
    keys = ("hidden_dim", "token_dim", "channel_dim", "num_mixers")

    def patches(c):
        ih, iw = c["image_size"]
        return (ih // c["patch_size"]) * (iw // c["patch_size"])

    return all(cfg0.get(k) == cfg1.get(k) for k in keys) and patches(cfg0) == patches(cfg1)


class PairedMLPMixer(nn.Module):
    """Two same-geometry ``MLPMixer`` encoders as one modality-batched chain:
    ``forward(x0, x1) -> (tokens0, tokens1)``."""

    def __init__(self, in_channels: Tuple[int, int], hidden_dim: int,
                 patch_sizes: Tuple[int, int], image_sizes: Sequence[Sequence[int]],
                 num_mixers: int, token_dim: int, channel_dim: int, dropout: float = 0.0, *,
                 dtype=None, approximate_gelu: bool = False, bits_dropout: bool = False,
                 generator=None):
        super().__init__()
        D, T, C, L = int(hidden_dim), int(token_dim), int(channel_dim), int(num_mixers)
        self.num_patch = image_tokens(image_sizes[0], patch_sizes[0])
        if image_tokens(image_sizes[1], patch_sizes[1]) != self.num_patch:
            raise ValueError("paired encoders need the same number of patches per modality")
        self.dtype = dtype
        self.approximate_gelu = approximate_gelu
        self.num_mixers = L
        for m in (0, 1):
            self.add_module(f"patch_embed_{m}",
                            PatchEmbed(in_channels[m], D, patch_sizes[m], dtype=dtype,
                                       generator=generator))
        sizes = {"N": self.num_patch, "T": T, "D": D, "C": C}
        for name, fan_in, fan_out in _FF_LEAVES:
            i, o = sizes[fan_in], sizes[fan_out]
            bound = _bound(i)
            self.register_parameter(f"{name}_kernel", nn.Parameter(
                uniform_(torch.empty(L, 2, i, o), bound, generator)))
            self.register_parameter(f"{name}_bias", nn.Parameter(
                uniform_(torch.empty(L, 2, o), bound, generator)))
        for name, lead in (("norm_token", (L, 2)), ("norm_channel", (L, 2)), ("norm_out", (2,))):
            self.register_parameter(f"{name}_scale", nn.Parameter(torch.ones(*lead, D)))
            self.register_parameter(f"{name}_bias", nn.Parameter(torch.zeros(*lead, D)))
        self.drop = Dropout(dropout, bits_dropout)

    def _pln(self, y, s, b):
        """LayerNorm per modality over the last axis, in ``y``'s dtype
        (``pln``: the statistics too)."""
        m = y.mean(dim=-1, keepdim=True)
        v = ((y - m) ** 2).mean(dim=-1, keepdim=True)
        sh = (2, 1, 1, y.shape[-1])
        return (y - m) * torch.rsqrt(v + 1e-5) * s.reshape(sh).to(y.dtype) + \
            b.reshape(sh).to(y.dtype)

    def _pdot(self, y, k, dt):
        """(2, B, a, in) @ (2, in, out) per modality: operands in ``dt``,
        float32 sums, the result in ``dt``; one batched product over the two
        modalities (a broadcast over B would copy the kernel B times)."""
        *lead, n = y.shape
        out = torch.bmm(y.reshape(2, -1, n).to(dt).float(), k.to(dt).float())
        return out.reshape(*lead, k.shape[-1]).to(dt)

    def _ff(self, y, i, prefix, dt):
        k1, b1 = getattr(self, f"{prefix}_fc1_kernel")[i], getattr(self, f"{prefix}_fc1_bias")[i]
        k2, b2 = getattr(self, f"{prefix}_fc2_kernel")[i], getattr(self, f"{prefix}_fc2_bias")[i]
        y = self._pdot(y, k1, dt) + b1[:, None, None, :].to(dt)
        y = self.drop(gelu(y, self.approximate_gelu))
        y = self._pdot(y, k2, dt) + b2[:, None, None, :].to(dt)
        return self.drop(y)

    def forward(self, x0, x1):
        x = torch.stack([self.patch_embed_0(x0), self.patch_embed_1(x1)])  # (2, B, N, D)
        dt = self.dtype or x.dtype
        for i in range(self.num_mixers):
            y = self._pln(x, self.norm_token_scale[i], self.norm_token_bias[i])
            y = self._ff(y.transpose(-1, -2), i, "token", dt)
            x = x + y.transpose(-1, -2)
            y = self._pln(x, self.norm_channel_scale[i], self.norm_channel_bias[i])
            x = x + self._ff(y, i, "channel", dt)
        x = self._pln(x, self.norm_out_scale, self.norm_out_bias)
        return x[0], x[1]



# (paired leaf prefix, modular block submodule, its FeedForward layer)
_PAIRED_FF = (("token_fc1", "token_mix", "fc1"), ("token_fc2", "token_mix", "fc2"),
              ("channel_fc1", "channel_mix", "fc1"), ("channel_fc2", "channel_mix", "fc2"))
_PAIRED_LN = ("norm_token", "norm_channel")


def pair_mlp_mixer_params(params0: dict, params1: dict) -> dict:
    """Two modular ``MLPMixer`` trees of one geometry (JAX layout, numpy
    leaves) -> the ``PairedMLPMixer`` tree: the patch embeds apart, the block
    leaves stacked ``(L, 2, ...)``, the output LN ``(2, D)`` (JAX
    ``pair_mlp_mixer_params``)."""
    layers, i = [], 0
    while f"block_{i}" in params0:
        layers.append((params0[f"block_{i}"], params1[f"block_{i}"]))
        i += 1
    stack = lambda get: np.stack([np.stack([np.asarray(get(b0)), np.asarray(get(b1))])
                                  for b0, b1 in layers])
    out = {f"patch_embed_{m}": {"proj": p["patch_embed"]["proj"]}
           for m, p in enumerate((params0, params1))}
    for name in _PAIRED_LN:
        for part in ("scale", "bias"):
            out[f"{name}_{part}"] = stack(lambda b: b[name]["LayerNorm_0"][part])
    for name, ff, fc in _PAIRED_FF:
        for part in ("kernel", "bias"):
            out[f"{name}_{part}"] = stack(lambda b: b[ff][fc]["linear"][part])
    for part in ("scale", "bias"):
        out[f"norm_out_{part}"] = np.stack([np.asarray(p["norm_out"]["LayerNorm_0"][part])
                                            for p in (params0, params1)])
    return out


def unpair_mlp_mixer_params(paired: dict) -> Tuple[dict, dict]:
    """The inverse of ``pair_mlp_mixer_params``: the two modular ``MLPMixer``
    trees, modality m's slice of every leaf (what JAX's ``to_pallas_serving``
    takes apart with ``_stack_from_paired``)."""
    L = int(np.shape(paired["token_fc1_kernel"])[0])
    ln = lambda name, i, m: {"LayerNorm_0": {
        part: np.asarray(paired[f"{name}_{part}"])[(i, m) if i is not None else m]
        for part in ("scale", "bias")}}
    trees = []
    for m in (0, 1):
        tree = {"patch_embed": paired[f"patch_embed_{m}"]}
        for i in range(L):
            block = {name: ln(name, i, m) for name in _PAIRED_LN}
            for name, ff, fc in _PAIRED_FF:
                block.setdefault(ff, {})[fc] = {"linear": {
                    part: np.asarray(paired[f"{name}_{part}"])[i, m]
                    for part in ("kernel", "bias")}}
            tree[f"block_{i}"] = block
        tree["norm_out"] = ln("norm_out", None, m)
        trees.append(tree)
    return trees[0], trees[1]
