"""The port's gMLP train step against the JAX train step, on the CPU.

Lockstep: a narrow ``avmnist_gmlp.yml`` (d_model 32, d_ffn 64, 2/2/1
blocks) at dropout 0 with stochastic depth pinned off (``prob_0_L [1, 1]``
on all three stacks, as the JAX package's own gMLP lockstep pins it) starts
from the same weights (``utils/weights.py``) and takes the same three seeded
batches. The JAX side is ``task.step`` + ``jax.value_and_grad`` + the
trainer's ``_make_optimizer``; the port side is ``Trainer.train_step`` with
the plain modules and with ``PallasVisiongMLP``/``PallasFusiongMLP`` (whose
backward is the plain version's autograd on the CPU). Per step the total
and branch losses, and after the last step every parameter, agree within
1e-5 x max(1, |JAX|), relative as everywhere on the gMLP path (the token
projection starts at bias 1, so magnitudes grow with width and depth). The
optimizer is the config's own Adam (lr 5e-4, eps 1e-8): no gMLP parameter
has a gradient that is exactly zero in the math, so no float noise turns
into lr-sized steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from m2mixer_tpu import config as jcfg
from m2mixer_tpu.models import get_model as j_get_model
from m2mixer_tpu.training.trainer import _make_optimizer as j_make_optimizer
from m2mixer_tpu_torch import config as pcfg
from m2mixer_tpu_torch.datasets import synthetic_avmnist_arrays
from m2mixer_tpu_torch.models import get_model
from m2mixer_tpu_torch.serving import to_torch_kernel_serving
from m2mixer_tpu_torch.training.trainer import Trainer
from m2mixer_tpu_torch.utils.weights import from_jax_params

CFG = """
dataset:
  type: AVMnistDataModule
  params: {batch_size: 8, data_dir: unused, synthetic: true, synthetic_learnable: true}
model:
  type: AVMnistMixerMultiLoss
  dropout: 0.0
  modalities:
    classification: {num_classes: 10}
    image: {block_type: VisiongMLP, in_channels: 1, d_model: 32, d_ffn: 64, patch_size: 4,
            image_size: [28, 28], n_blocks: 2, prob_0_L: [1.0, 1.0]}
    audio: {block_type: VisiongMLP, in_channels: 1, d_model: 32, d_ffn: 64, patch_size: 16,
            image_size: [112, 112], n_blocks: 2, prob_0_L: [1.0, 1.0]}
    multimodal: {block_type: FusiongMLP, fusion_function: ConcatFusion, d_model: 32, d_ffn: 64,
                 hidden_dim: 32, n_blocks: 1, prob_0_L: [1.0, 1.0]}
train:
  epochs: 1
  seed: 0
  log_interval_steps: 0
  optimizer: {lr: 0.0005, betas: [0.9, 0.999], eps: 1.0e-08, weight_decay: 0.0,
              scheduler_patience: 2}
"""
TOL = 1e-5
STEPS = 3


def batches(n):
    data = synthetic_avmnist_arrays(8 * n, seed=7, learnable=True)
    return [{k: v[i * 8:(i + 1) * 8] for k, v in data.items()} for i in range(n)]


@pytest.fixture(scope="module")
def lockstep():
    """The JAX trajectory: initial parameters, per-step losses, final parameters."""
    jc = jcfg.loads(CFG)
    jtask = j_get_model(jc.model.type)(jc.model, jc.train.optimizer)
    params = jax.tree.map(np.asarray, jtask.init_params(jax.random.PRNGKey(0), batches(1)[0]))
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


@pytest.mark.parametrize("flavor", ["plain", "kernel"])
def test_gmlp_train_steps_match_jax(lockstep, tmp_path, flavor):
    init, history, final = lockstep
    cfg = pcfg.loads(CFG)
    plain = get_model(cfg.model.type)(cfg.model, cfg.train.optimizer, device="cpu")
    state = from_jax_params(init, plain.network)
    plain.network.load_state_dict(state)
    task = plain
    if flavor == "kernel":
        task, _ = to_torch_kernel_serving(cfg, state, device="cpu")
        assert type(task.network.encoders[0]).__name__ == "PallasVisiongMLP"
    trainer = Trainer(cfg.train, work_dir=str(tmp_path))
    trainer.setup(task)
    ctx = task.make_ctx(0, "train")
    for b, (j_loss, j_losses) in zip(batches(STEPS), history):
        loss, aux = trainer.train_step(task, trainer._to_device(task, b), ctx)
        assert close(float(loss), j_loss), (float(loss), j_loss)
        for k, v in j_losses.items():
            assert close(aux["losses"][k].item(), v), (k, aux["losses"][k].item(), v)
    want = from_jax_params(final, plain.network)
    if flavor == "kernel":
        want = to_torch_kernel_serving(cfg, want, device="cpu")[1]
    got = task.network.state_dict()
    assert set(got) == set(want)
    for k in got:
        scale = max(1.0, want[k].abs().max().item())
        err = (got[k] - want[k]).abs().max().item()
        assert err <= TOL * scale, (k, err)
