"""Loss functions (counterpart of ``m2mixer_tpu/modules/losses.py``).

Only the criterion the ported tasks use: cross-entropy over integer labels
with the JAX package's optional class weights, label smoothing and focal
modulation. The BCE and evidential losses come with the tasks that use them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["cross_entropy_loss"]


def cross_entropy_loss(logits, labels, weight: Optional[torch.Tensor] = None,
                       label_smoothing: float = 0.0, focal_gamma: float = 0.0):
    """Mean cross-entropy over integer labels (torch ``CrossEntropyLoss``),
    logits upcast to float32. ``label_smoothing``: ``(1-eps)*nll +
    eps*mean(-logp)``. ``focal_gamma``: each sample's loss times
    ``(1-p_t)**gamma``, ``p_t`` the true class's probability. ``weight``: a
    per-class weight, the weighted mean over the batch."""
    logp = F.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    nll = -logp.gather(-1, labels[..., None])[..., 0]
    if focal_gamma:
        p_t = torch.exp(-nll)
        nll = (1.0 - p_t) ** float(focal_gamma) * nll
    if label_smoothing:
        eps = float(label_smoothing)
        nll = (1.0 - eps) * nll + eps * (-logp).mean(dim=-1)
    if weight is not None:
        w = weight[labels]
        return (nll * w).sum() / w.sum()
    return nll.mean()
