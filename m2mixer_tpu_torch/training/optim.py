"""Adam and AdamW with a bf16 first moment (``train.optimizer.moment_dtype: bf16``).

Counterpart of optax's ``scale_by_adam(mu_dtype=bfloat16)``, which the JAX
trainer builds for ``moment_dtype`` (``m2mixer_tpu/training/trainer.py:283-350``),
followed by ``add_decayed_weights`` (before the moments for ``adam``, after
them for ``adamw``) and the learning rate. One step, operation for operation
as optax computes it on float32 parameters and gradients:

- ``mu = (1 - b1) g + b1 mu_bf16``: the decay multiplies the stored bf16 moment
  in bf16 (JAX converts the Python scalar to the moment's dtype), and the sum
  is float32;
- ``nu = (1 - b2) g^2 + b2 nu`` in float32;
- the update ``mu / (1 - b1^t) / (sqrt(nu / (1 - b2^t)) + eps)`` uses this
  step's float32 ``mu``; only then is ``mu`` stored, rounded to bf16.

``torch.optim.Adam`` keeps its moments in the parameters' dtype and cannot
do this. Here a parameter group's moments are two flat buffers (each
parameter's ``state`` holds views of them), and a step is a fixed handful of
elementwise operations over all of the group's parameters at once, so its
host cost does not grow with the number of parameters. A parameter without a
gradient counts as a zero gradient, as JAX differentiates every leaf.
"""

from __future__ import annotations

import torch

__all__ = ["BF16MomentAdam"]


class BF16MomentAdam(torch.optim.Optimizer):
    """Adam (coupled L2, ``decoupled=False``) or AdamW (decoupled decay) whose
    first moment is stored in bf16; the second moment stays float32."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, decoupled: bool = False):
        defaults = dict(lr=lr, betas=tuple(float(b) for b in betas), eps=float(eps),
                        weight_decay=float(weight_decay), decoupled=bool(decoupled))
        super().__init__(params, defaults)
        self._flat = {}  # group index -> (step count, mu (bf16), nu (float32))

    def _moments(self, i: int, params):
        if i not in self._flat:
            n = sum(p.numel() for p in params)
            dev = params[0].device
            mu = torch.zeros(n, dtype=torch.bfloat16, device=dev)
            nu = torch.zeros(n, dtype=torch.float32, device=dev)
            o = 0
            for p in params:
                self.state[p] = {"mu": mu[o:o + p.numel()].view_as(p),
                                 "nu": nu[o:o + p.numel()].view_as(p)}
                o += p.numel()
            self._flat[i] = [0, mu, nu]
        return self._flat[i]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for i, group in enumerate(self.param_groups):
            params = group["params"]
            if not params:
                continue
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            flat = self._moments(i, params)
            flat[0] += 1
            _, mu, nu = flat
            g = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                           .float() for p in params])
            w = torch.cat([p.reshape(-1) for p in params])
            if wd and not group["decoupled"]:
                g = g + wd * w
            # b1 * mu in bf16: b1 rounded to bf16 (JAX's weak-typed scalar), one
            # rounding of the exact product
            b1_bf16 = float(torch.tensor(b1, dtype=torch.bfloat16))
            m = (1 - b1) * g + (mu * b1_bf16).float()
            nu.mul_(b2).add_((1 - b2) * (g * g))
            t = torch.tensor(float(flat[0]), dtype=torch.float32)
            bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** t)
            bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** t)
            update = (m / bc1) / (torch.sqrt(nu / bc2) + eps)
            if wd and group["decoupled"]:
                update = update + wd * w
            w = w + update * -lr
            mu.copy_(m)
            torch._foreach_copy_(list(params), [a.view_as(p) for a, p in
                                                zip(w.split([p.numel() for p in params]),
                                                    params)])
        return loss
