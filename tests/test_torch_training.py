"""The port's training slice against the JAX package, on the CPU.

Lockstep: a narrow AV-MNIST MultiLoss config at dropout 0 starts from the
same weights (``utils/weights.py``) and takes the same seeded batches. The
JAX side is ``task.step`` + ``jax.value_and_grad`` + the trainer's own
``_make_optimizer`` and gradient/update masking; the port side is
``Trainer.train_step`` with plain modules and with both kernel block types
(whose backward is the plain version's autograd on the CPU). Per step the
total and branch losses, and after the last step every parameter, agree
within 1e-5 absolute. The config's Adam has lr 1e-3 and eps 1e-3: the
token FF's output biases have an exactly-zero gradient (every consumer of
the residual stream is a LayerNorm, which removes a per-row constant), so
their gradients are float32 noise of up to ~1e-6 on each side, and Adam's
ratio of moments turns noise far above eps into steps of lr whatever its
sign; with eps 1e-3 those steps stay below ~1e-6, while the other
parameters still move by ~1e-3 a step.
The rest holds the pieces (losses, weights, context, metrics, callbacks,
optimizer, data, CLI) to their JAX counterparts.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from m2mixer_tpu import config as jcfg
from m2mixer_tpu.datasets.avmnist import synthetic_avmnist_arrays as j_synthetic
from m2mixer_tpu.models import get_model as j_get_model
from m2mixer_tpu.modules.losses import cross_entropy_loss as j_ce
from m2mixer_tpu.training import callbacks as jcb
from m2mixer_tpu.training import metrics as jm
from m2mixer_tpu.training.compiled import make_grad_masker
from m2mixer_tpu.training.trainer import _make_optimizer as j_make_optimizer
from m2mixer_tpu_torch import config as pcfg
from m2mixer_tpu_torch import run
from m2mixer_tpu_torch.datasets import synthetic_avmnist_arrays
from m2mixer_tpu_torch.models import get_model
from m2mixer_tpu_torch.modules.losses import cross_entropy_loss
from m2mixer_tpu_torch.serving import to_torch_kernel_serving
from m2mixer_tpu_torch.training import callbacks as pc
from m2mixer_tpu_torch.training import metrics as pm
from m2mixer_tpu_torch.training.trainer import Trainer, make_optimizer
from m2mixer_tpu_torch.utils.weights import flatten_tree, from_jax_params, to_jax_params
from test_torch_hygiene import one_torch_thread  # noqa: F401  (autouse)

CFG = """
dataset:
  type: AVMnistDataModule
  params: {batch_size: 8, data_dir: unused, synthetic: true, synthetic_learnable: true,
           synthetic_sizes: [24, 8, 8]}
model:
  type: AVMnistMixerMultiLoss
  dropout: 0.0
  freeze_modalities_on_epoch: 1
  modalities:
    classification: {classifier: StandardClassifier, input_shape: [16], num_classes: 10}
    image: {block_type: MLPMixer, in_channels: 1, hidden_dim: 16, patch_size: 14,
            image_size: [28, 28], token_dim: 8, channel_dim: 32, num_mixers: 2}
    audio: {block_type: MLPMixer, in_channels: 1, hidden_dim: 16, patch_size: 56,
            image_size: [112, 112], token_dim: 8, channel_dim: 32, num_mixers: 2}
    multimodal: {block_type: FusionMixer, fusion_function: ConcatFusion, hidden_dim: 16,
                 token_dim: 8, channel_dim: 32, num_mixers: 1}
train:
  epochs: 1
  seed: 0
  log_interval_steps: 0
  optimizer: {lr: 0.001, betas: [0.9, 0.999], eps: 1.0e-3, weight_decay: 0.0,
              scheduler_patience: 2}
"""
TOL = 1e-5
STEPS = {"unfrozen": (0, 3), "frozen": (1, 2)}  # (epoch of the ctx, steps)


def batches(n):
    data = synthetic_avmnist_arrays(8 * n, seed=5, learnable=True)
    return [{k: v[i * 8:(i + 1) * 8] for k, v in data.items()} for i in range(n)]


def jax_step(jtask, params):
    """(the optimizer, the jitted JAX train step): value_and_grad of the task's
    step, the trainer's gradient and update masking; the context is an
    argument, so both phases share one compile."""
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

    return opt, step


def jax_run(jtask, opt, step, params, epoch, n):
    ctx = {k: jnp.asarray(v) for k, v in jtask.make_ctx(epoch, "train").items()}
    opt_state, history = opt.init(params), []
    for b in batches(n):
        params, opt_state, loss, losses = step(params, opt_state, b, ctx)
        history.append((float(loss), {k: float(v) for k, v in losses.items()}))
    return params, history


@pytest.fixture(scope="module")
def lockstep():
    """The JAX trajectories of both phases from one initialization."""
    jc = jcfg.loads(CFG)
    jtask = j_get_model(jc.model.type)(jc.model, jc.train.optimizer)
    params = jtask.init_params(jax.random.PRNGKey(0), batches(1)[0])
    params = jax.tree.map(np.asarray, params)
    opt, step = jax_step(jtask, params)
    runs = {phase: jax_run(jtask, opt, step, params, epoch, n)
            for phase, (epoch, n) in STEPS.items()}
    return params, runs


def port_task(init_params, flavor):
    cfg = pcfg.loads(CFG)
    task = get_model(cfg.model.type)(cfg.model, cfg.train.optimizer, device="cpu")
    state = from_jax_params(init_params, task.network)
    if flavor == "plain":
        task.network.load_state_dict(state)
        return task, cfg, task
    kernel, _ = to_torch_kernel_serving(cfg, state, device="cpu",
                                        per_block=flavor == "per_block")
    task.network.load_state_dict(state)
    return kernel, cfg, task


@pytest.mark.parametrize("phase", sorted(STEPS))
@pytest.mark.parametrize("flavor", ["plain", "stacked", "per_block"])
def test_train_steps_match_jax(lockstep, tmp_path, flavor, phase):
    init, runs = lockstep
    final, history = runs[phase]
    epoch, n = STEPS[phase]
    task, cfg, plain = port_task(init, flavor)
    trainer = Trainer(cfg.train, work_dir=str(tmp_path))
    trainer.setup(task)
    ctx = task.make_ctx(epoch, "train")
    before = {k: v.clone() for k, v in task.network.state_dict().items()}
    for b, (j_loss, j_losses) in zip(batches(n), history):
        loss, aux = trainer.train_step(task, trainer._to_device(task, b), ctx)
        assert abs(float(loss) - j_loss) <= TOL
        for k, v in j_losses.items():
            assert abs(aux["losses"][k].item() - v) <= TOL, k
    # the JAX parameters after the last step, in this network's layout
    want = from_jax_params(final, plain.network)
    if flavor != "plain":
        want = to_torch_kernel_serving(cfg, want, device="cpu",
                                       per_block=flavor == "per_block")[1]
    got = task.network.state_dict()
    assert set(got) == set(want)
    for k in got:
        err = (got[k] - want[k]).abs().max().item()
        assert err <= TOL, (k, err)
    frozen = set(task.frozen_param_names())
    assert frozen and all(k.startswith(("encoders.", "heads.")) for k in frozen)
    moved = {k for k in frozen if not torch.equal(got[k], before[k])}
    if phase == "frozen":
        assert not moved
    else:
        assert {"heads.0.weight", "encoders.1.patch_embed.proj.weight"} <= moved


def test_jax_and_port_start_from_the_same_forward(lockstep):
    """The lockstep's weights map leaf by leaf, both ways."""
    init, _ = lockstep
    task, _, _ = port_task(init, "plain")
    back = flatten_tree(to_jax_params(task.network.state_dict())["params"])
    for path, leaf in flatten_tree(init["params"]).items():
        np.testing.assert_array_equal(back[path], leaf)


@pytest.mark.parametrize("fusion_weight", [None, 0.5, 0.8])
def test_loss_weights_and_annealing_match_jax(fusion_weight):
    """fixed_scaled: (w_f, (1-w_f)/2, ...) x 3; annealed after validation
    from loss_change_epoch on."""
    extra = {"fusion_loss_change": 0.1, "loss_change_epoch": 1}
    if fusion_weight is not None:
        extra["fusion_loss_weight"] = fusion_weight
    jc, c = jcfg.loads(CFG), pcfg.loads(CFG)
    jc.model.update(extra)
    c.model.update(extra)
    jtask = j_get_model(jc.model.type)(jc.model, jc.train.optimizer)
    task = get_model(c.model.type)(c.model, c.train.optimizer, device="cpu")
    for epoch in range(4):
        np.testing.assert_allclose(task.current_loss_weights(), jtask.current_loss_weights(),
                                   rtol=0, atol=1e-7)
        for mode in ("train", "val"):
            a, b = task.make_ctx(epoch, mode), jtask.make_ctx(epoch, mode)
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
        task.on_validation_epoch_end(None, epoch, {})
        jtask.on_validation_epoch_end(None, epoch, {})
    assert np.isclose(task.current_loss_weights().sum(), 3.0)


@pytest.mark.parametrize("kind", ["plain", "weight", "smoothing", "focal"])
def test_cross_entropy_matches_jax(kind):
    rng = np.random.RandomState(0)
    logits = rng.randn(16, 10).astype(np.float32) * 3
    labels = rng.randint(0, 10, 16).astype(np.int32)
    weight = rng.rand(10).astype(np.float32) + 0.5
    kw = {"plain": {}, "weight": {"weight": weight}, "smoothing": {"label_smoothing": 0.1},
          "focal": {"focal_gamma": 2.0}}[kind]
    want = float(j_ce(jnp.asarray(logits), jnp.asarray(labels),
                      **{k: jnp.asarray(v) if k == "weight" else v for k, v in kw.items()}))
    got = float(cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                   **{k: torch.from_numpy(v) if k == "weight" else v
                                      for k, v in kw.items()}))
    assert abs(got - want) <= 1e-6


@pytest.mark.parametrize("average", ["macro", "micro", "weighted"])
@pytest.mark.parametrize("metric", ["Accuracy", "F1Score", "Precision", "Recall"])
def test_metrics_match_jax(metric, average):
    rng = np.random.RandomState(1)
    preds, labels = rng.randint(0, 10, 300), rng.randint(0, 10, 300)
    preds[:20] = labels[:20]
    got = getattr(pm, metric)(task="multiclass", num_classes=10, average=average)
    want = getattr(jm, metric)(task="multiclass", num_classes=10, average=average)
    for m in (got, want):
        m.update(preds[:150], labels[:150])
        m.update(preds[150:], labels[150:])
    assert got.compute() == want.compute()


def test_callbacks_match_jax():
    vals = [3.0, 2.5, 2.6, 2.5, 2.49999, 2.7, 2.8, 2.9, 2.0, 2.1, 2.2, 2.3, 2.4]
    es, jes = pc.EarlyStopping(patience=3), jcb.EarlyStopping(patience=3)
    pl, jpl = pc.ReduceLROnPlateau(0.01, patience=2), jcb.ReduceLROnPlateau(0.01, patience=2)
    for v in vals:
        assert es.update({"val_loss": v}) == jes.update({"val_loss": v})
        assert pl.update(v) == jpl.update(v)
    assert pl.lr < 0.01


@pytest.mark.parametrize("opt_type", ["adam", "adamw"])
def test_optimizer_matches_optax(opt_type):
    """Coupled L2 for adam, decoupled decay for adamw, three steps."""
    rng = np.random.RandomState(2)
    w0 = rng.randn(5, 7).astype(np.float32)
    grads = [rng.randn(5, 7).astype(np.float32) for _ in range(3)]
    cfg = {"type": opt_type, "lr": 0.01, "betas": [0.8, 0.99], "eps": 1e-6,
           "weight_decay": 0.1}
    jopt, _ = j_make_optimizer(jcfg.DictConfig(cfg))
    jw, state = jnp.asarray(w0), None
    state = jopt.init(jw)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt, lr = make_optimizer(pcfg.DictConfig(cfg), [p])
    assert lr == 0.01
    for g in grads:
        upd, state = jopt.update(jnp.asarray(g), state, jw)
        jw = optax.apply_updates(jw, upd)
        p.grad = torch.from_numpy(g.copy())
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jw), rtol=0, atol=1e-6)


def test_synthetic_data_matches_jax():
    a, b = synthetic_avmnist_arrays(12, seed=3, learnable=True), j_synthetic(12, seed=3,
                                                                            learnable=True)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("key,value", [("train.optimizer.type", "sgd"),
                                       ("model.cutmix_alpha", 0.2),
                                       ("model.mixup_alpha", 0.2),
                                       ("train.auto_resume", True)])
def test_unported_options_raise(tmp_path, key, value):
    cfg = pcfg.loads(CFG)
    section, *path = key.split(".")
    node = cfg[section]
    for p in path[:-1]:
        node = node[p]
    node[path[-1]] = value
    with pytest.raises(NotImplementedError, match="not yet ported"):
        task = get_model(cfg.model.type)(cfg.model, cfg.train.optimizer, device="cpu")
        Trainer(cfg.train, work_dir=str(tmp_path)).setup(task)


# the JAX trainer's metrics.jsonl keys (training/trainer.py:1453-1478, 1243-1258,
# 1623-1654) for a MultiLoss task with its four macro metrics
_SPLIT_KEYS = {"loss", "loss_image", "loss_audio", "loss_fusion", "acc", "f1m", "prec_m",
               "rec_m"}
EXPECTED_KEYS = [
    {"step", "t", "epoch", "train_samples_per_sec"} | {f"train_{k}" for k in _SPLIT_KEYS},
    {"step", "t", "lr"} | {f"val_{k}" for k in _SPLIT_KEYS},
    {"step", "t"} | {f"test_{k}" for k in _SPLIT_KEYS},
]


def test_cli_trains_on_cpu_and_serves_its_weights(tmp_path):
    from m2mixer_tpu_torch import serving

    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text(CFG)
    overrides = ["model.modalities.image.block_type=PallasStackedMLPMixer",
                 "model.modalities.audio.block_type=PallasMLPMixer",
                 "model.modalities.multimodal.block_type=PallasStackedFusionMixer"]
    trainer = run.main(["-c", str(cfg_path), "-n", "cli", "--device", "cpu",
                        f"train.tensorboard_path={tmp_path / 'logs'}", *overrides])
    with open(os.path.join(trainer.logger.log_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [set(line) for line in lines] == EXPECTED_KEYS
    assert all(np.isfinite(v) for line in lines for v in line.values())
    ckpts = os.path.join(trainer.logger.log_dir, "checkpoints")
    assert {"best.npz", "last.npz", "test_preds.npz"} <= set(os.listdir(ckpts))
    serving.main(["export", "-c", str(cfg_path), "-p", os.path.join(ckpts, "best.npz"),
                  "-o", str(tmp_path / "art"), "--device", "cpu", *overrides])
    assert (tmp_path / "art" / "weights.npz").exists()


def test_cli_without_gpu_or_device_fails_clearly(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the CLI runs there by default")
    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text(CFG)
    with pytest.raises(SystemExit, match="no CUDA device is visible.*--device cpu"):
        run.main(["-c", str(cfg_path), "-n", "x", f"train.tensorboard_path={tmp_path}"])
