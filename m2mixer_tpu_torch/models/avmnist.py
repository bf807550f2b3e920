"""AV-MNIST tasks (the slice's part of ``m2mixer_tpu/models/avmnist.py``).

``AVMnistMixerMultiLoss`` is the flagship: image and audio encoders, concat
fusion, a fusion mixer, and three heads (fusion, image, audio) trained with
three cross-entropy losses weighted by ``MultiLossTask``.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..training import metrics as tm
from .base import MultiLossTask
from .nets import build_multimodal_net

__all__ = ["AVMnistMixerMultiLoss"]


def _multiclass_scores(num_classes: int) -> Dict[str, tm._BaseMetric]:
    """The MultiLoss models' four macro metrics (JAX ``_multiclass_scores``
    with ``extended=False``)."""
    return dict(
        acc=tm.Accuracy(task="multiclass", num_classes=num_classes),
        f1m=tm.F1Score(task="multiclass", num_classes=num_classes, average="macro"),
        prec_m=tm.Precision(task="multiclass", num_classes=num_classes, average="macro"),
        rec_m=tm.Recall(task="multiclass", num_classes=num_classes, average="macro"),
    )


class AVMnistMixerMultiLoss(MultiLossTask):
    modalities = ("image", "audio")

    def build_network(self, generator):
        return build_multimodal_net(self.model_cfg, self.modalities, generator=generator)

    def network_inputs(self, batch):
        return {"inputs": (batch["image"], batch["audio"])}

    def feature_spec(self):
        mc = self.model_cfg.modalities
        return {k: ((int(mc[k].in_channels), *map(int, mc[k].image_size)), "float32")
                for k in self.modalities}

    @property
    def num_classes(self) -> int:
        return self.model_cfg.modalities.classification.num_classes

    def branch_losses(self, outputs, batch, ctx):
        labels = batch["label"]
        img_logits, aud_logits = outputs["branch_logits"]
        return {
            "image": self.ce(img_logits, labels),
            "audio": self.ce(aud_logits, labels),
            "fusion": self.ce(outputs["logits"], labels),
        }

    def predictions(self, outputs, batch):
        """Argmax class per head, plus the raw logits of each head."""
        img_logits, aud_logits = outputs["branch_logits"]
        am = lambda z: torch.argmax(torch.softmax(z, dim=1), dim=1)
        out = {
            "preds": am(outputs["logits"]),
            "preds_image": am(img_logits),
            "preds_audio": am(aud_logits),
            "logits": outputs["logits"],
            "image_logits": img_logits,
            "audio_logits": aud_logits,
        }
        if "label" in batch:
            out["labels"] = batch["label"]
        return out

    def setup_scores(self):
        return [_multiclass_scores(self.num_classes) for _ in range(3)]

    def test_artifact_keys(self):
        return ("preds", "preds_image", "preds_audio", "labels",
                "image_logits", "audio_logits", "logits")
