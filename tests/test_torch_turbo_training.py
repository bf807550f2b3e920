"""bf16 training of the flagship mixer (``avmnist_m2-mixer_B_turbo.yml``)
against the JAX package, on the CPU.

Lockstep as ``tests/test_torch_training.py`` runs it, on the B_turbo recipe
narrowed the same way (hidden 16, token 8, channel 32/38, 2 + 2 + 1 blocks,
batch 8) at dropout 0: bf16 compute, tanh GELU, uint8-bits dropout masks,
paired encoders and Adam with a bf16 first moment, at lr 1e-3 and eps 1.
Adam's eps is the lockstep's choice, as eps 1e-3 is the float32 lockstep's:
Adam turns a gradient far above eps into a step of about lr whatever its
size, and the two sides' bf16 gradients differ by a few bf16 ulps, which for
the gradients that are exactly zero in the math (the token FF's output
biases) or near zero is a difference in sign; at eps 1 every step is about
lr times the gradient, so those differences stay as small as they are. Three
flavours: the config as shipped (``PairedMLPMixer`` + the plain
``FusionMixer``), and both kernel block types (``PallasStacked*`` and
``Pallas*``; they cannot pair, so their encoders run per modality), each
against the JAX task built from the same config (its Pallas kernels in
interpret mode) from the same weights. The JAX side is ``task.step`` +
``jax.value_and_grad`` + the JAX trainer's ``_make_optimizer`` with XLA's
defaults; the port's is ``Trainer.train_step`` (the kernels' plain versions
and their autograd on the CPU).

Tolerance (bf16): per step the total and branch losses within 2e-3 relative
(measured at most 1.1e-3), and after three steps every parameter within
3e-5 absolute (measured at most 7.3e-6); every parameter has moved.

The L config (``avmnist_m2-mixer_L.yml``: 16 + 64 tokens, 80 fused) resolves
and takes a step on the plain modules, narrowed in width and depth, and on
both kernel block types (``PallasStacked*``, ``Pallas*``; above 32 tokens the
CUDA kernels run their token FF on the tensor cores, and on the CPU the plain
versions take any token count, as the JAX kernels do): seeded port weights
carried to the JAX task with the same block types, its served logits (the
Pallas kernels in interpret mode) against the port's within 2e-2 of their
largest magnitude (bf16; measured 0.6%), then a finite train step that moves
every parameter.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from m2mixer_tpu import config as jcfg
from m2mixer_tpu.models import get_model as j_get_model
from m2mixer_tpu.training.compiled import make_grad_masker
from m2mixer_tpu.training.trainer import _make_optimizer as j_make_optimizer
from m2mixer_tpu_torch import config as pcfg
from m2mixer_tpu_torch.datasets import synthetic_avmnist_arrays
from m2mixer_tpu_torch.models import get_model
from m2mixer_tpu_torch.training.optim import BF16MomentAdam
from m2mixer_tpu_torch.training.trainer import Trainer
from m2mixer_tpu_torch.utils.weights import from_jax_params, to_jax_params
from test_torch_hygiene import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURBO = os.path.join(REPO, "cfg", "avmnist", "avmnist_m2-mixer_B_turbo.yml")
L_CFG = os.path.join(REPO, "cfg", "avmnist", "avmnist_m2-mixer_L.yml")
MODS = ("image", "audio", "multimodal")
NARROW = [*(f"model.modalities.{m}.{k}={v}" for m in MODS
            for k, v in (("hidden_dim", 16), ("token_dim", 8))),
          "model.modalities.image.channel_dim=32", "model.modalities.audio.channel_dim=32",
          "model.modalities.multimodal.channel_dim=38",
          "model.modalities.image.num_mixers=2", "model.modalities.audio.num_mixers=2",
          "model.modalities.multimodal.num_mixers=1",
          "model.modalities.classification.input_shape=[16]", "model.dropout=0.0",
          "train.optimizer.lr=0.001", "train.optimizer.eps=1.0", "dataset.params.batch_size=8"]
FLAVORS = {
    "paired": [],
    "stacked": ["model.modalities.image.block_type=PallasStackedMLPMixer",
                "model.modalities.audio.block_type=PallasStackedMLPMixer",
                "model.modalities.multimodal.block_type=PallasStackedFusionMixer"],
    "per_block": ["model.modalities.image.block_type=PallasMLPMixer",
                  "model.modalities.audio.block_type=PallasMLPMixer",
                  "model.modalities.multimodal.block_type=PallasFusionMixer"],
}
STEPS = 3
LOSS_REL = 2e-3
PARAM_ATOL = 3e-5


def configs(flavor):
    over = [*NARROW, *FLAVORS[flavor]]
    jc, pc = jcfg.load(TURBO), pcfg.load(TURBO)
    jcfg.apply_cli_overrides(jc, over)
    pcfg.apply_cli_overrides(pc, over, warn=False)
    return jc, pc


def batches(n):
    data = synthetic_avmnist_arrays(8 * n, seed=5, learnable=True)
    return [{k: v[i * 8:(i + 1) * 8] for k, v in data.items()} for i in range(n)]


def jax_run(jtask, params, n):
    opt, _ = j_make_optimizer(jtask.optimizer_cfg)
    masker = make_grad_masker(jtask.frozen_mask(params))

    @jax.jit
    def step(params, opt_state, batch, ctx):
        (loss, aux), grads = jax.value_and_grad(
            lambda p: jtask.step(p, batch, ctx, {}, train=True), has_aux=True)(params)
        grads = masker(grads, ctx["frozen"])
        updates, opt_state = opt.update(grads, opt_state, params)
        updates = masker(updates, ctx["frozen"])
        return optax.apply_updates(params, updates), opt_state, loss, aux["losses"]

    ctx = {k: jnp.asarray(v) for k, v in jtask.make_ctx(0, "train").items()}
    opt_state, history = opt.init(params), []
    for b in batches(n):
        params, opt_state, loss, losses = step(params, opt_state, b, ctx)
        history.append((float(loss), {k: float(v) for k, v in losses.items()}))
    return params, history


@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_turbo_train_steps_match_jax(tmp_path, flavor):
    """Both sides start from the port's seeded weights carried to the JAX
    layout (``to_jax_params``; JAX's own init would run its Pallas kernels in
    interpret mode for nothing but the values)."""
    jc, pc = configs(flavor)
    jtask = j_get_model(jc.model.type)(jc.model, jc.train.optimizer)
    task = get_model(pc.model.type)(pc.model, pc.train.optimizer, device="cpu", seed=1)
    init = jax.tree.map(np.array, to_jax_params(task.network.state_dict()))  # copies
    final, history = jax_run(jtask, init, STEPS)

    task.network.load_state_dict(from_jax_params(init, task.network))
    assert (task.network.paired_encoder is not None) == (flavor == "paired")
    assert all(p.dtype == torch.float32 for p in task.network.parameters())
    trainer = Trainer(pc.train, work_dir=str(tmp_path))
    trainer.setup(task)
    assert isinstance(trainer.optimizer, BF16MomentAdam)
    ctx = task.make_ctx(0, "train")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # many tiny ops: one intra-op thread a test worker
    try:
        port = [trainer.train_step(task, trainer._to_device(task, b), ctx)
                for b in batches(STEPS)]
    finally:
        torch.set_num_threads(threads)
    for (loss, aux), (j_loss, j_losses) in zip(port, history):
        assert abs(float(loss) - j_loss) <= LOSS_REL * abs(j_loss), (float(loss), j_loss)
        for k, v in j_losses.items():
            assert abs(aux["losses"][k].item() - v) <= LOSS_REL * abs(v), k
    want = from_jax_params(final, task.network)
    got = task.network.state_dict()
    assert set(got) == set(want)
    moved = 0
    for k in got:
        err = (got[k] - want[k]).abs().max().item()
        assert err <= PARAM_ATOL, (k, err)
        moved += int(not torch.equal(got[k], from_jax_params(init, task.network)[k]))
    assert moved == len(got)


L_NARROW = [*(f"model.modalities.{m}.{k}={v}" for m in MODS
              for k, v in (("hidden_dim", 16), ("token_dim", 8), ("channel_dim", 32),
                           ("num_mixers", 1))),
            "model.modalities.classification.input_shape=[16]"]


def l_config(extra=()):
    """The L config narrowed in width and depth; its token counts (16 image,
    64 audio, 80 fused) and every lever as shipped."""
    c = pcfg.load(L_CFG)
    pcfg.apply_cli_overrides(c, [*L_NARROW, *extra], warn=False)
    return c


def test_l_config_resolves_and_steps_on_the_plain_modules(tmp_path):
    c = l_config()
    task = get_model(c.model.type)(c.model, c.train.optimizer, device="cpu")
    assert task.network.paired_encoder is None  # 16 vs 64 tokens cannot pair
    assert task.network.fusion_mixer.num_patch == 80
    trainer = Trainer(c.train, work_dir=str(tmp_path))
    trainer.setup(task)
    assert isinstance(trainer.optimizer, BF16MomentAdam)
    before = {k: v.clone() for k, v in task.network.state_dict().items()}
    data = synthetic_avmnist_arrays(4, seed=1, learnable=True)
    loss, _ = trainer.train_step(task, trainer._to_device(task, data),
                                 task.make_ctx(0, "train"))
    assert np.isfinite(float(loss))
    after = task.network.state_dict()
    assert any(not torch.equal(after[k], before[k]) for k in after)


@pytest.mark.parametrize("block", ["PallasStackedMLPMixer", "PallasMLPMixer"])
def test_l_config_kernel_blocks_raise_the_token_cap(tmp_path, block):
    """No token cap: the narrowed L config builds on the kernel block types
    (64 audio and 80 fused tokens), serves as the JAX task with the same
    block types does, and trains (the module docstring)."""
    from m2mixer_tpu.serving import _serve_fn
    from m2mixer_tpu_torch.serving import serve_fn
    from m2mixer_tpu_torch.utils.weights import to_jax_params

    fusion = block.replace("MLPMixer", "FusionMixer")
    extra = [f"model.modalities.image.block_type={block}",
             f"model.modalities.audio.block_type={block}",
             f"model.modalities.multimodal.block_type={fusion}"]
    c = l_config(extra)
    task = get_model(c.model.type)(c.model, c.train.optimizer, device="cpu", seed=2)
    assert type(task.network.fusion_mixer).__name__ == fusion
    assert task.network.fusion_mixer.num_patch == 80
    jc = jcfg.load(L_CFG)
    jcfg.apply_cli_overrides(jc, [*L_NARROW, *extra])
    jtask = j_get_model(jc.model.type)(jc.model, jc.train.optimizer)
    data = synthetic_avmnist_arrays(2, seed=1, learnable=True)
    feats = {k: v for k, v in data.items() if k != "label"}
    want = np.asarray(_serve_fn(jtask)(to_jax_params(task.network.state_dict()), feats)["logits"],
                      np.float32)
    got = serve_fn(task)({k: torch.from_numpy(v) for k, v in feats.items()})["logits"]
    got = got.float().numpy()
    assert np.isfinite(got).all() and got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 2e-2 * np.max(np.abs(want))
    trainer = Trainer(c.train, work_dir=str(tmp_path))
    trainer.setup(task)
    before = {k: v.clone() for k, v in task.network.state_dict().items()}
    loss, _ = trainer.train_step(task, trainer._to_device(task, data), task.make_ctx(0, "train"))
    assert np.isfinite(float(loss))
    after = task.network.state_dict()
    assert all(not torch.equal(after[k], before[k]) for k in after)


def test_cli_trains_turbo_on_cpu_and_serves_its_weights_unpaired(tmp_path):
    """``run.main`` on the narrowed B_turbo recipe (paired encoders, bf16,
    bf16 Adam moment; ``train.prng_impl`` is accepted and ignored), its bf16
    test predictions written as float32, then ``serving export --pallas`` of
    its best weights: per-modality K2f stacks in bf16 (their plain versions
    here), answering within bf16 rounding of the paired network."""
    from m2mixer_tpu_torch import run
    from m2mixer_tpu_torch.serving import load_serving, main

    over = [o for o in NARROW if not o.startswith("dataset.")]
    data = ["dataset.params.synthetic=true", "dataset.params.synthetic_learnable=true",
            "dataset.params.synthetic_sizes=[32, 16, 16]"]
    trainer = run.main(["-c", TURBO, "-n", "turbo", "--device", "cpu", "train.epochs=1",
                        f"train.tensorboard_path={tmp_path / 'logs'}", *data, *over])
    ckpts = os.path.join(trainer.logger.log_dir, "checkpoints")
    with np.load(os.path.join(ckpts, "test_preds.npz")) as z:
        assert z["logits"].dtype == np.float32 and z["logits"].shape == (16, 10)
    main(["export", "-c", TURBO, "-p", os.path.join(ckpts, "best.npz"), "-o",
          str(tmp_path / "art"), "--pallas", "--device", "cpu", *over])
    served = load_serving(str(tmp_path / "art"), device="cpu")
    kinds = {type(m).__name__ for m in served.task.network.modules()}
    assert "PallasStackedMLPMixer" in kinds and "PairedMLPMixer" not in kinds
    feats = {k: v[:5] for k, v in synthetic_avmnist_arrays(5, seed=2).items() if k != "label"}
    got = served.predict(feats)["logits"]
    with torch.no_grad():
        want = trainer_network_logits(trainer, feats, os.path.join(ckpts, "best.npz"))
    assert np.max(np.abs(got - want)) <= 5e-2 * np.max(np.abs(want))


def trainer_network_logits(trainer, feats, weights):
    """Logits of the paired network of the run's config with ``weights``."""
    import json

    from m2mixer_tpu_torch.serving import _build_task
    from m2mixer_tpu_torch.utils.weights import load_npz

    with open(os.path.join(trainer.logger.log_dir, "config.json")) as f:
        cfg = pcfg.DictConfig(json.load(f))
    task = _build_task(cfg, device="cpu")
    task.network.load_state_dict(load_npz(weights, task.network))
    out = task.network(inputs=tuple(torch.from_numpy(feats[k]) for k in ("image", "audio")))
    return out["logits"].float().numpy()
