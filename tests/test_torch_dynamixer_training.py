"""The port's DynaMixer train step against the JAX train step, on the CPU.

Lockstep: a narrow ``avmnist_3loss_dyna.yml`` (hidden 16, 4 heads, R = 2, one
block a stack, the config's 7 x 7 grids and MaxFusion) at dropout 0 starts
from the same weights (``utils/weights.py``) and takes the same three seeded
batches. The JAX side is ``task.step`` + ``jax.value_and_grad`` + the
trainer's ``_make_optimizer``; the port side is ``Trainer.train_step``, whose
``DynaMixerOp``s run ``fused_dynamixer_op`` (the plain version and its
autograd on the CPU). Per step the total and branch losses, and after the
last step every parameter, agree within 1e-5 x max(1, |JAX|). The optimizer
is the config's own Adam (lr 1e-4, eps 1e-8): no DynaMixer parameter has a
gradient that is exactly zero in the math, so no float noise turns into
lr-sized steps. ``python -m m2mixer_tpu_torch.run`` then trains the same
narrow config on the CPU for one epoch.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from m2mixer_tpu import config as jcfg
from m2mixer_tpu.models import get_model as j_get_model
from m2mixer_tpu.training.trainer import _make_optimizer as j_make_optimizer
from m2mixer_tpu_torch import config as pcfg
from m2mixer_tpu_torch import run
from m2mixer_tpu_torch.datasets import synthetic_avmnist_arrays
from m2mixer_tpu_torch.models import get_model
from m2mixer_tpu_torch.training.trainer import Trainer
from m2mixer_tpu_torch.utils.weights import from_jax_params, to_jax_params

REPO = Path(__file__).resolve().parents[1]
DYNA_CFG = str(REPO / "cfg" / "avmnist" / "avmnist_3loss_dyna.yml")
CFG = """
dataset:
  type: AVMnistDataModule
  params: {batch_size: 8, data_dir: unused, synthetic: true, synthetic_learnable: true}
model:
  type: AVMnistMixerMultiLoss
  dropout: 0.0
  modalities:
    classification: {num_classes: 10}
    image: {block_type: DynaMixer, in_channels: 1, hidden_dim: 16, patch_size: 4,
            image_size: [28, 28], num_head: 4, reduced_dim: 2, num_mixers: 1}
    audio: {block_type: DynaMixer, in_channels: 1, hidden_dim: 16, patch_size: 16,
            image_size: [112, 112], num_head: 4, reduced_dim: 2, num_mixers: 1}
    multimodal: {block_type: FusionDynaMixer, fusion_function: MaxFusion, hidden_dim: 16,
                 num_head: 4, reduced_dim: 2, num_mixers: 1}
train:
  epochs: 1
  seed: 0
  log_interval_steps: 0
  optimizer: {lr: 0.0001, betas: [0.9, 0.999], eps: 1.0e-08, weight_decay: 0.0,
              scheduler_patience: 2}
"""
TOL = 1e-5
STEPS = 3


def batches(n):
    data = synthetic_avmnist_arrays(8 * n, seed=7, learnable=True)
    return [{k: v[i * 8:(i + 1) * 8] for k, v in data.items()} for i in range(n)]


@pytest.fixture(scope="module")
def lockstep():
    """The JAX trajectory from the port's seeded weights carried to the JAX
    layout: initial parameters, per-step losses, final parameters."""
    jc = jcfg.loads(CFG)
    jtask = j_get_model(jc.model.type)(jc.model, jc.train.optimizer)
    pc = pcfg.loads(CFG)
    net = get_model(pc.model.type)(pc.model, pc.train.optimizer, device="cpu", seed=1).network
    params = jax.tree.map(np.array, to_jax_params(net.state_dict()))
    opt, _ = j_make_optimizer(jtask.optimizer_cfg)

    @jax.jit
    def step(params, opt_state, batch, ctx):
        (loss, aux), grads = jax.value_and_grad(
            lambda p: jtask.step(p, batch, ctx, {}, train=True), has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, aux["losses"]

    ctx = {k: jnp.asarray(v) for k, v in jtask.make_ctx(0, "train").items()}
    p, opt_state, history = params, opt.init(params), []
    for b in batches(STEPS):
        p, opt_state, loss, losses = step(p, opt_state, b, ctx)
        history.append((float(loss), {k: float(v) for k, v in losses.items()}))
    return params, history, jax.tree.map(np.asarray, p)


def close(got, want):
    return abs(got - want) <= TOL * max(1.0, abs(want))


def test_dynamixer_train_steps_match_jax(lockstep, tmp_path):
    init, history, final = lockstep
    cfg = pcfg.loads(CFG)
    task = get_model(cfg.model.type)(cfg.model, cfg.train.optimizer, device="cpu")
    task.network.load_state_dict(from_jax_params(init, task.network))
    assert type(task.network.encoders[0]).__name__ == "DynaMixer"
    trainer = Trainer(cfg.train, work_dir=str(tmp_path))
    trainer.setup(task)
    ctx = task.make_ctx(0, "train")
    for b, (j_loss, j_losses) in zip(batches(STEPS), history):
        loss, aux = trainer.train_step(task, trainer._to_device(task, b), ctx)
        assert close(float(loss), j_loss), (float(loss), j_loss)
        for k, v in j_losses.items():
            assert close(aux["losses"][k].item(), v), (k, aux["losses"][k].item(), v)
    want = from_jax_params(final, task.network)
    got = task.network.state_dict()
    assert set(got) == set(want)
    for k in got:
        scale = max(1.0, want[k].abs().max().item())
        err = (got[k] - want[k]).abs().max().item()
        assert err <= TOL * scale, (k, err)


def test_cli_trains_the_dyna_config_on_cpu(tmp_path):
    """``run.main`` on the shipped config with the depth cut to one block a
    stack and the widths narrowed: an epoch of learnable synthetic data, with
    the config's dropout 0.5, ends in finite metrics and a test pass."""
    argv = ["-c", DYNA_CFG, "-n", "dyna", "--device", "cpu", f"train.tensorboard_path={tmp_path}",
            "train.epochs=1", "dataset.params.synthetic=true",
            "dataset.params.synthetic_learnable=true", "dataset.params.synthetic_sizes=[32, 16, 16]",
            "dataset.params.num_workers=0"]
    argv += [f"model.modalities.{k}.{n}={v}" for k in ("image", "audio", "multimodal")
             for n, v in (("num_mixers", 1), ("hidden_dim", 16), ("num_head", 4))]
    trainer = run.main(argv)
    with open(Path(trainer.logger.log_dir) / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert any("val_loss" in ln for ln in lines) and any("test_acc" in ln for ln in lines)
    assert all(np.isfinite(v) for ln in lines for v in ln.values() if isinstance(v, float))
