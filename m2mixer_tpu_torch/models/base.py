"""The minimum of the task base that serving needs.

Counterpart of the network-building half of ``m2mixer_tpu/models/base.py``:
``resolve_dtype`` (``:62-70``) and a task that builds its network from the
model config and maps a batch to the network's inputs. Losses, metrics, the
optimizer and the loss-weight schedules come with the training slice.

A task owns its device. It defaults to ``cuda``; without a visible GPU the
caller has to ask for ``device="cpu"`` (the plain PyTorch versions of the
kernels), and anything else raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import abc
from typing import Dict, Optional

import torch

__all__ = ["resolve_dtype", "resolve_device", "Task"]

#: model-config keys that change the served forward and are not ported yet
_UNPORTED_OPTIONS = ("qat", "prune", "lora")


def resolve_dtype(precision) -> Optional[torch.dtype]:
    """``model.precision`` -> compute dtype (parameters stay float32):
    'bf16'/'bfloat16' selects bfloat16; None/'f32' keeps float32 (None)."""
    if precision in ("bf16", "bfloat16"):
        return torch.bfloat16
    if precision in (None, "f32", "float32", "fp32"):
        return None
    raise ValueError(f"Unknown precision: {precision}")


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. Without one, the caller must pass ``"cpu"``."""
    if device is None or str(device) == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible: the port serves on the GPU. Pass "
                "device='cpu' (CLI: --device cpu) to run the plain PyTorch "
                "versions of the kernels on the CPU instead.")
        return torch.device("cuda")
    return torch.device(device)


class Task(abc.ABC):
    """Builds ``self.network`` (eval mode, on ``device``) from the model config.

    ``seed`` drives a CPU ``torch.Generator`` for the initial weights, so one
    seed gives the same weights on every device."""

    def __init__(self, model_cfg, optimizer_cfg=None, *, device=None, seed: int = 0):
        for key in _UNPORTED_OPTIONS:
            if model_cfg.get(key):
                raise NotImplementedError(f"not yet ported: model.{key}")
        self.model_cfg = model_cfg
        self.device = resolve_device(device)
        generator = torch.Generator().manual_seed(int(seed))
        self.network = self.build_network(generator).to(self.device).eval()

    @abc.abstractmethod
    def build_network(self, generator: torch.Generator) -> torch.nn.Module:
        """Return the ``nn.Module`` implementing the forward pass."""

    @abc.abstractmethod
    def network_inputs(self, batch) -> Dict:
        """Map a batch dict to the network's call kwargs."""

    @abc.abstractmethod
    def feature_spec(self) -> Dict:
        """Per-sample ``{feature: (shape, dtype name)}`` the network takes."""
