"""The generic multimodal network (counterpart of ``m2mixer_tpu/models/nets.py``).

Per-modality encoder -> fusion -> fusion mixer -> per-modality heads on
mean-pooled tokens + the fusion classifier. Muting zeroes one modality's
input: code ``i`` mutes modality ``i``, ``-1`` mutes nothing. With
``model.paired_encoders`` and two encoders that ``can_pair``, one
``PairedMLPMixer`` (``paired_encoder``) replaces them, as in the JAX
package (``m2mixer_tpu/models/nets.py:60-70``); otherwise the flag is a
no-op, as it is there.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..config import DictConfig
from ..modules import get_block_by_name, get_classifier_by_name, get_fusion_by_name
from ..modules.common import Linear
from ..modules.paired import PairedMLPMixer, can_pair
from .base import resolve_dtype

__all__ = ["MultimodalNet", "build_multimodal_net", "pool_tokens"]


def pool_tokens(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1, x.shape[-1]).mean(dim=1)


def build_multimodal_net(model_cfg, modality_keys: Sequence[str], head_pool: bool = True, *,
                         generator=None) -> "MultimodalNet":
    """Registry-driven constructor for the standard N-modality topology:
    encoders from ``block_type``, fusion from ``fusion_function`` with shape
    inference (``get_output_shape(..., dim=1)``), Linear heads, and the
    classifier (StandardClassifier when the config omits it)."""
    mc = model_cfg.modalities
    dtype = resolve_dtype(model_cfg.get("precision"))
    common = dict(dropout=model_cfg.get("dropout", 0.0), dtype=dtype,
                  approximate_gelu=bool(model_cfg.get("approximate_gelu", False)),
                  bits_dropout=bool(model_cfg.get("bits_dropout", False)), generator=generator)

    def feat_dim(block_cfg):
        return block_cfg.get("hidden_dim", block_cfg.get("d_model"))

    paired = None
    if model_cfg.get("paired_encoders", False) and len(modality_keys) == 2:
        c0, c1 = (mc[k] for k in modality_keys)
        if can_pair(c0, c1):
            paired = PairedMLPMixer(
                (int(c0.in_channels), int(c1.in_channels)), int(c0.hidden_dim),
                (int(c0.patch_size), int(c1.patch_size)),
                (tuple(c0.image_size), tuple(c1.image_size)), int(c0.num_mixers),
                int(c0.token_dim), int(c0.channel_dim), **common)
    if paired is not None:  # the paired chain stands in for both encoders
        encoders, patches = [], [paired.num_patch] * 2
    else:
        encoders = [get_block_by_name(**{**mc[k], **common}) for k in modality_keys]
        patches = [e.num_patch for e in encoders]
    fusion = get_fusion_by_name(**mc.multimodal, dtype=dtype)
    num_patches = fusion.get_output_shape(*patches, dim=1)
    fusion_mixer = get_block_by_name(**{**mc.multimodal, "num_patches": num_patches, **common})
    num_classes = mc.classification.num_classes
    heads = [Linear(feat_dim(mc[k]), num_classes, dtype=dtype, generator=generator)
             for k in modality_keys]
    cls_cfg = DictConfig(mc.classification)
    cls_cfg.setdefault("classifier", "StandardClassifier")
    cls_cfg.setdefault("input_shape", [feat_dim(mc.multimodal)])
    classifier = get_classifier_by_name(**cls_cfg, dtype=dtype, generator=generator)
    return MultimodalNet(encoders, heads, fusion, fusion_mixer, classifier, head_pool,
                         paired_encoder=paired)


class MultimodalNet(nn.Module):
    """N-modality encoder/fusion/heads network; ``fusion`` is a
    parameter-free callable (ConcatFusion, ConcatDynaFusion, MaxFusion).
    With ``paired_encoder`` there are no per-modality encoders."""

    def __init__(self, encoders, heads, fusion, fusion_mixer, classifier,
                 head_pool: bool = True, paired_encoder=None):
        super().__init__()
        self.encoders = nn.ModuleList(encoders)
        self.paired_encoder = paired_encoder
        self.heads = nn.ModuleList(heads)
        self.fusion = fusion
        self.fusion_mixer = fusion_mixer
        self.classifier = classifier
        self.head_pool = head_pool

    def forward(self, inputs, mute_code: int = -1):
        xs = [x * 0.0 if mute_code == i else x for i, x in enumerate(inputs)]
        if self.paired_encoder is not None:
            encs = list(self.paired_encoder(*xs))
        else:
            encs = [enc(x) for enc, x in zip(self.encoders, xs)]
        fusion_tokens = self.fusion_mixer(self.fusion(*encs))
        branch_logits = tuple(head(pool_tokens(e) if self.head_pool else e)
                              for head, e in zip(self.heads, encs))
        return {
            "logits": self.classifier(fusion_tokens),
            "branch_logits": branch_logits,
            "encodings": tuple(encs),
            "fusion_tokens": fusion_tokens,
        }
