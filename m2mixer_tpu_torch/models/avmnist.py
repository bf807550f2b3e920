"""AV-MNIST tasks (the slice's part of ``m2mixer_tpu/models/avmnist.py``).

``AVMnistMixerMultiLoss`` is the flagship: image and audio encoders, concat
fusion, a fusion mixer, and three heads (fusion, image, audio). This slice
serves its eval-mode forward; the three CE losses and their weighting come
with the training slice.
"""

from __future__ import annotations

import torch

from .base import Task
from .nets import build_multimodal_net

__all__ = ["AVMnistMixerMultiLoss"]


class AVMnistMixerMultiLoss(Task):
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
