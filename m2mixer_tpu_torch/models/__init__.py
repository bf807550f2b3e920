"""Task-model registry: ``get_model(model.type)``.

Only the ported tasks resolve; a name the JAX package knows but the port
does not yet raise ``NotImplementedError("not yet ported: <name>")``.
"""

from __future__ import annotations

from .avmnist import AVMnistMixerMultiLoss
from .base import MultiLossTask, TrainTask, resolve_device, resolve_dtype
from .mimic import MimicMixerMultiLoss, MimicRecurrent

__all__ = ["AVMnistMixerMultiLoss", "MimicMixerMultiLoss", "MimicRecurrent", "MultiLossTask",
           "TrainTask", "get_model", "resolve_device", "resolve_dtype"]

MODELS = {c.__name__: c for c in (AVMnistMixerMultiLoss, MimicMixerMultiLoss, MimicRecurrent)}


def get_model(model_type: str):
    try:
        return MODELS[model_type]
    except KeyError:
        raise NotImplementedError(f"not yet ported: {model_type}") from None
