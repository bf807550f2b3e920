"""MIMIC-III tasks (counterpart of ``m2mixer_tpu/models/mimic.py``): static
tabular features (5) and a clinical time series (24 x 12), 6 classes.

- ``MimicMixerNet``: the static MLP gives one token, concatenated ahead of
  the time mixer's 24 tokens; a fusion mixer runs over the 25; the static
  head reads the raw static embedding, the time head the mean-pooled time
  tokens, the classifier the fusion tokens.
- ``MimicRecurrentNet``: the static MLP and the flattened GRU outputs,
  concatenated into an MLP fusion encoder.
- ``MimicMixerMultiLoss``: a cross-entropy per branch under the ``fixed``
  weighting (no x3 scale); its predictions are softmax probabilities, and
  its metrics micro F1/accuracy/precision/recall and macro average
  precision, logged under ``auroc`` as the reference logs it.
- ``MimicRecurrent``: the GRU baseline; its predictions are argmax classes
  (the probabilities go to average precision).

The JAX tasks build their blocks without a compute dtype, so there
``model.precision`` leaves MIMIC in float32. The port honours it as its
AV-MNIST network does: ``model.precision: bf16`` runs every block in bf16
(the fusion mixer's kernel blocks on the bf16 kernels), parameters float32.
``approximate_gelu`` and ``bits_dropout`` apply as in JAX.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..config import DictConfig
from ..modules import get_block_by_name, get_classifier_by_name, get_fusion_by_name
from ..modules.common import Linear
from ..training import metrics as tm
from .base import MultiLossTask, resolve_dtype

__all__ = ["MimicMixerMultiLoss", "MimicRecurrent", "MimicMixerNet", "MimicRecurrentNet"]

#: time steps of a MIMIC stay (the data module's ``time`` is (B, 24, 12))
TIME_STEPS = 24


def _mimic_scores(num_classes: int) -> Dict[str, tm._BaseMetric]:
    return dict(
        f1_micro=tm.F1Score(task="multiclass", num_classes=num_classes, average="micro"),
        acc=tm.Accuracy(task="multiclass", num_classes=num_classes),
        precision_micro=tm.Precision(task="multiclass", num_classes=num_classes,
                                     average="micro"),
        recall_micro=tm.Recall(task="multiclass", num_classes=num_classes, average="micro"),
        auroc=tm.AveragePrecision(task="multiclass", num_classes=num_classes, average="macro"),
    )


def _mute(static, time, mute_code: int):
    return (static * 0.0 if mute_code == 0 else static,
            time * 0.0 if mute_code == 1 else time)


class MimicMixerNet(nn.Module):
    def __init__(self, encoders, heads, fusion, fusion_mixer, classifier):
        super().__init__()
        self.encoders = nn.ModuleList(encoders)  # (static MLP, time mixer)
        self.heads = nn.ModuleList(heads)
        self.fusion = fusion
        self.fusion_mixer = fusion_mixer
        self.classifier = classifier

    def forward(self, inputs, mute_code: int = -1):
        static, time = _mute(*inputs, mute_code)
        static_feats = self.encoders[0](static)  # (B, H)
        time_tokens = self.encoders[1](time)  # (B, T, H)
        fusion_tokens = self.fusion_mixer(self.fusion(static_feats[:, None, :], time_tokens))
        return {
            "logits": self.classifier(fusion_tokens),
            "branch_logits": (self.heads[0](static_feats), self.heads[1](time_tokens.mean(dim=1))),
            "encodings": (static_feats, time_tokens),
            "fusion_tokens": fusion_tokens,
        }


class MimicRecurrentNet(nn.Module):
    def __init__(self, encoders, heads, fusion, fusion_encoder, classifier):
        super().__init__()
        self.encoders = nn.ModuleList(encoders)  # (static MLP, GRU)
        self.heads = nn.ModuleList(heads)
        self.fusion = fusion
        self.fusion_encoder = fusion_encoder
        self.classifier = classifier

    def forward(self, inputs, mute_code: int = -1):
        static, time = _mute(*inputs, mute_code)
        static_feats = self.encoders[0](static)  # (B, S)
        time_feats = self.encoders[1](time)  # (B, T*H), flattened
        fusion_feats = self.fusion_encoder(self.fusion(static_feats, time_feats))
        return {
            "logits": self.classifier(fusion_feats),
            "branch_logits": (self.heads[0](static_feats), self.heads[1](time_feats)),
            "encodings": (static_feats, time_feats),
            "fusion_tokens": fusion_feats,
        }


class MimicMixerMultiLoss(MultiLossTask):
    modalities = ("static", "time")
    weighting = "fixed"
    default_classes = 3

    def __init__(self, model_cfg, optimizer_cfg=None, *, device=None, seed: int = 0):
        self.num_classes = int(model_cfg.modalities.classification.get("num_classes",
                                                                       self.default_classes))
        super().__init__(model_cfg, optimizer_cfg, device=device, seed=seed)
        self.log_confusion_matrix = False

    def _common(self, generator):
        m = self.model_cfg
        return dict(dropout=m.get("dropout", 0.0), dtype=resolve_dtype(m.get("precision")),
                    approximate_gelu=bool(m.get("approximate_gelu", False)),
                    bits_dropout=bool(m.get("bits_dropout", False)), generator=generator)

    def _classifier(self, generator):
        mc = self.model_cfg.modalities
        cls_cfg = DictConfig(mc.classification)
        cls_cfg.setdefault("classifier", "StandardClassifier")
        cls_cfg.setdefault("input_shape", [mc.multimodal.hidden_dim])
        return get_classifier_by_name(**cls_cfg, dtype=resolve_dtype(
            self.model_cfg.get("precision")), generator=generator)

    def build_network(self, generator):
        mc, common = self.model_cfg.modalities, self._common(generator)
        time_mixer = get_block_by_name(**{**mc.time, **common})
        static = get_block_by_name(**{**mc.static, **common})
        fusion = get_fusion_by_name(**mc.multimodal)
        # the static embedding is one token (mimic.py:42-43, 102)
        num_patches = fusion.get_output_shape(1, time_mixer.num_patch, dim=1)
        fusion_mixer = get_block_by_name(**{**mc.multimodal, "num_patches": num_patches,
                                            **common})
        heads = [Linear(mc.static.output_dim, self.num_classes, dtype=common["dtype"],
                        generator=generator),
                 Linear(mc.time.hidden_dim, self.num_classes, dtype=common["dtype"],
                        generator=generator)]
        return MimicMixerNet((static, time_mixer), heads, fusion, fusion_mixer,
                             self._classifier(generator))

    def network_inputs(self, batch):
        return {"inputs": (batch["static"], batch["time"])}

    def feature_spec(self):
        mc = self.model_cfg.modalities
        steps = int(mc.time.get("num_patch", TIME_STEPS))
        width = int(mc.time.get("embedding_dim", mc.time.get("input_dim", 12)))
        return {"static": ((int(mc.static.input_dim),), "float32"),
                "time": ((steps, width), "float32")}

    def branch_losses(self, outputs, batch, ctx):
        labels = batch["label"]
        static_logits, time_logits = outputs["branch_logits"]
        return {"static": self.ce(static_logits, labels), "time": self.ce(time_logits, labels),
                "fusion": self.ce(outputs["logits"], labels)}

    def _classes(self, logits):
        """What the metrics read as predictions: the probabilities (the
        reference feeds them to its metrics, mimic.py:126-133)."""
        return torch.softmax(logits, dim=1)

    def predictions(self, outputs, batch):
        static_logits, time_logits = outputs["branch_logits"]
        out = {
            "preds": self._classes(outputs["logits"]),
            "probs": torch.softmax(outputs["logits"], dim=1),
            "preds_static": self._classes(static_logits),
            "preds_time": self._classes(time_logits),
            "logits": outputs["logits"],
            "logits_static": static_logits,
            "logits_time": time_logits,
        }
        if "label" in batch:
            out["labels"] = batch["label"]
        return out

    def setup_scores(self):
        return [_mimic_scores(self.num_classes) for _ in range(3)]

    def test_artifact_keys(self):
        return ("preds", "labels", "logits", "logits_static", "logits_time")


class MimicRecurrent(MimicMixerMultiLoss):
    default_classes = 6

    def __init__(self, model_cfg, optimizer_cfg=None, *, device=None, seed: int = 0):
        super().__init__(model_cfg, optimizer_cfg, device=device, seed=seed)
        self.log_confusion_matrix = True

    def build_network(self, generator):
        mc, common = self.model_cfg.modalities, self._common(generator)
        time_encoder = get_block_by_name(**{**mc.time, **common})
        static = get_block_by_name(**{**mc.static, **common})
        fusion = get_fusion_by_name(**mc.multimodal)
        fusion_encoder = get_block_by_name(**{**mc.multimodal, **common})
        # the flattened GRU features (mimic.py:226-228)
        time_out = int(mc.time.input_dim) * int(mc.time.hidden_dim) * 2
        heads = [Linear(mc.static.output_dim, self.num_classes, dtype=common["dtype"],
                        generator=generator),
                 Linear(time_out, self.num_classes, dtype=common["dtype"], generator=generator)]
        return MimicRecurrentNet((static, time_encoder), heads, fusion, fusion_encoder,
                                 self._classifier(generator))

    def feature_spec(self):
        mc = self.model_cfg.modalities
        return {"static": ((int(mc.static.input_dim),), "float32"),
                "time": ((TIME_STEPS, int(mc.time.input_dim)), "float32")}

    def _classes(self, logits):
        return torch.argmax(torch.softmax(logits, dim=1), dim=1)
