"""The bf16-moment Adam and AdamW (``train.optimizer.moment_dtype: bf16``)
against optax's ``adam`` / ``adamw`` with ``mu_dtype=bfloat16``.

Five steps on seeded float32 parameters and gradients: the parameters within
1e-6 relative, the first moment bit-equal on the bf16 grid (both compute it
as ``(1 - b1) g + b1 mu`` with ``b1 mu`` in bf16 and round the float32 sum),
the second moment within 1e-6 relative. Then the trainer's ``make_optimizer``
builds it from the config keys the JAX trainer's ``_make_optimizer`` reads.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from m2mixer_tpu import config as jcfg
from m2mixer_tpu.training.trainer import _make_optimizer as j_make_optimizer
from m2mixer_tpu_torch import config as pcfg
from m2mixer_tpu_torch.training.optim import BF16MomentAdam
from m2mixer_tpu_torch.training.trainer import make_optimizer

STEPS = 5
REL = 1e-6
SHAPES = [(6, 7), (13,), (2, 3, 5)]


def seeded(seed):
    rng = np.random.RandomState(seed)
    params = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    # gradients over four decades, some elements exactly zero
    grads = [[(rng.randn(*s) * 10.0 ** rng.randint(-3, 1, s) * (rng.rand(*s) > 0.1))
              .astype(np.float32) for s in SHAPES] for _ in range(STEPS)]
    return params, grads


def close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want), 1e-30)
    assert np.all(np.abs(got - want) <= REL * scale), float(np.max(np.abs(got - want) / scale))


def adam_state(state):
    """optax's ScaleByAdamState inside a chain (or an inject_hyperparams one)."""
    state = getattr(state, "inner_state", state)
    return next(s for s in state if isinstance(s, optax.ScaleByAdamState))


@pytest.mark.parametrize("opt_type", ["adam", "adamw"])
def test_bf16_moment_adam_matches_optax(opt_type):
    params, grads = seeded(0 if opt_type == "adam" else 1)
    lr, b1, b2, eps, wd = 0.01, 0.9, 0.999, 1e-8, 0.05
    if opt_type == "adam":
        tx = optax.adam(lr, b1, b2, eps, mu_dtype=jnp.bfloat16)
    else:
        tx = optax.adamw(lr, b1, b2, eps, mu_dtype=jnp.bfloat16, weight_decay=wd)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = BF16MomentAdam(tp, lr=lr, betas=(b1, b2), eps=eps,
                         weight_decay=wd if opt_type == "adamw" else 0.0,
                         decoupled=opt_type == "adamw")
    for g in grads:
        upd, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a.copy())
        opt.step()
    s = adam_state(state)
    for p, jw, mu, nu in zip(tp, jp, s.mu, s.nu):
        close(p.detach().numpy(), np.asarray(jw))
        st = opt.state[p]
        assert st["mu"].dtype == torch.bfloat16 and np.asarray(mu).dtype == jnp.bfloat16
        np.testing.assert_array_equal(st["mu"].float().numpy(), np.asarray(mu, np.float32))
        assert st["nu"].dtype == torch.float32
        close(st["nu"].numpy(), np.asarray(nu))


@pytest.mark.parametrize("moment_dtype", ["bf16", "bfloat16"])
@pytest.mark.parametrize("opt_type", ["adam", "adamw"])
def test_make_optimizer_builds_the_jax_trainers_chain(opt_type, moment_dtype):
    """``make_optimizer`` on the config the JAX trainer reads (coupled L2
    for adam, decoupled decay for adamw, the injected learning rate)."""
    cfg = {"type": opt_type, "lr": 0.003, "betas": [0.8, 0.99], "eps": 1e-6,
           "weight_decay": 0.1, "moment_dtype": moment_dtype}
    params, grads = seeded(2)
    jopt, _ = j_make_optimizer(jcfg.DictConfig(cfg))
    jp = [jnp.asarray(p) for p in params]
    state = jopt.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt, lr = make_optimizer(pcfg.DictConfig(cfg), tp)
    assert isinstance(opt, BF16MomentAdam) and lr == 0.003
    for g in grads:
        upd, state = jopt.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a.copy())
        opt.step()
    for p, jw, mu in zip(tp, jp, adam_state(state).mu):
        close(p.detach().numpy(), np.asarray(jw))
        np.testing.assert_array_equal(opt.state[p]["mu"].float().numpy(),
                                      np.asarray(mu, np.float32))


def test_unknown_moment_dtype_raises():
    with pytest.raises(ValueError, match="moment_dtype"):
        make_optimizer(pcfg.DictConfig({"moment_dtype": "fp8"}),
                       [torch.nn.Parameter(torch.zeros(2))])
