"""GradNorm adaptive loss-weight balancing (Chen et al., ICML 2018);
counterpart of ``m2mixer_tpu/modules/gradnorm.py``.

A host-side per-epoch refit feeding ``ctx['loss_weights']``, as SoftAdapt
and GradBlend are. Each refit:

1. measures ``G_i = ||grad of the i-th weighted branch loss||`` on one probe
   batch: one training forward through ``MultiLossTask.step_components`` and
   one ``torch.autograd.grad`` per branch over the parameters the optimizer
   updates, the graph retained between them (through kernel-backed blocks,
   each backward launches K2b / K1b for the stacks its branch loss reaches,
   all on the one forward's saved K2f / K1f graph);
2. computes the relative inverse training rates ``r_i = (l_i / l_i(0)) /
   mean_j(l_j / l_j(0))`` against the unweighted branch losses of the first
   measurement;
3. solves the weights that put every branch at its target norm ``mean(G) *
   r_i**alpha``: ``G_i`` is linear in ``w_i``, so ``w_i' = w_i * target_i /
   G_i``;
4. renormalizes to ``sum w = n``.

The probe's dropout and muting draw from streams of their own (seeded from
``trainer.seed + 23`` and the epoch), so a measurement leaves the live
network's random streams where they were.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .common import DepthRNG, DropoutRNG, set_depth_rng, set_dropout_rng

__all__ = ["measure_gradnorm_weights", "branch_gradients"]


def branch_gradients(task, batch, ctx):
    """``(per-branch gradients, unweighted losses, total)``: for each branch
    ``i`` of ``task.loss_names`` the gradients of ``w_i * l_i`` with respect
    to every parameter that requires one (zeros where the branch does not
    reach it), from one training forward."""
    net = task.network
    params = [p for p in net.parameters() if p.requires_grad]
    comps, (total, aux) = task.step_components(batch, ctx, train=True)
    n = len(task.loss_names)
    grads = []
    for i in range(n):
        g = (torch.autograd.grad(comps[i], params, retain_graph=i < n - 1, allow_unused=True)
             if comps[i].requires_grad else [None] * len(params))
        grads.append([torch.zeros_like(p) if gi is None else gi for gi, p in zip(g, params)])
    losses = torch.stack([aux["losses"][k].detach() for k in task.loss_names])
    return grads, losses, total.detach()


def _probe_batch(task, datamodule):
    """The first ``min(batch_size, n)`` training samples, on the task's device."""
    arrays = datamodule.splits["train"]
    bs = min(int(datamodule.batch_size), len(next(iter(arrays.values()))))
    return {k: torch.from_numpy(np.ascontiguousarray(v[:bs])).to(task.device)
            for k, v in arrays.items()}


def measure_gradnorm_weights(task, trainer, epoch: int) -> Optional[np.ndarray]:
    """One GradNorm refit (steps 1-4 above): the new weight vector in
    ``task.loss_names`` order, or None without a data module, past the
    modality-freeze epoch (only the fusion loss trains then), or when the
    solve gives a non-finite or non-positive sum."""
    datamodule = getattr(trainer, "datamodule", None)
    if datamodule is None:
        return None
    ctx = task.make_ctx(epoch, "train")
    if float(ctx["frozen"]) > 0:
        return None
    batch = _probe_batch(task, datamodule)
    net = task.network
    was_training = net.training
    probe_seed = (int(trainer.seed) + 23) * 1_000_003 + int(epoch)
    live = task.dropout_rng, task.depth_rng
    task.dropout_rng = DropoutRNG(probe_seed, task.device)
    set_dropout_rng(net, task.dropout_rng)
    set_depth_rng(net, DepthRNG(probe_seed))
    try:
        net.train()
        grads, losses, _ = branch_gradients(task, batch, ctx)
    finally:
        task.dropout_rng = live[0]
        set_dropout_rng(net, live[0])
        set_depth_rng(net, live[1])
        net.train(was_training)
    g = np.asarray([float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t) for t in gi]))) for gi in grads], np.float64)
    l = losses.double().cpu().numpy()
    if task.gn_initial_losses is None:
        task.gn_initial_losses = np.maximum(l, 1e-12)
    r = l / task.gn_initial_losses
    r = r / max(r.mean(), 1e-12)
    target = g.mean() * r ** task.gn_alpha
    w = np.asarray(ctx["loss_weights"], np.float64)
    w_new = w * target / (g + 1e-12)
    s = w_new.sum()
    if not np.isfinite(s) or s <= 0:
        return None
    w_new = w_new * (len(w_new) / s)
    print(f"[gradnorm] epoch {epoch} weights (order {task.loss_names}): "
          f"{np.round(w_new, 4)}")
    return w_new.astype(np.float32)
