"""``train.grad_accum_steps`` in the port's trainer against the JAX trainer's,
on the CPU.

The MIMIC H config at dropout 0 (Adam eps 1e-3, as in
``tests/test_torch_training.py``: the token FFs' output biases have an
exactly-zero gradient, float noise that Adam at eps 1e-8 would turn into
steps of lr either way), from one initial parameter tree, trains one epoch
of 80 synthetic samples in batches of 16 in order: five micro-batches, so at
K = 2 two updates and a partial group of one, flushed at the epoch's end
and averaged over the micro-batch it holds. The JAX side is its
``Trainer.fit`` (``m2mixer_tpu/training/trainer.py:1316-1347``); the port's is
``Trainer.fit``. Held within 1e-5: the per-update ``train_loss_step`` lines
(logged at group ends only, under ``global_step`` = updates), the epoch's
train loss (a mean over micro-batches) and val loss, and every weight after
the epoch. Then the port alone: K = 2 micro-batches of 16 give the weights of
K = 1 batches of 32 within 1e-6 (the mean of two 16-sample mean losses is the
32-sample mean).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from m2mixer_tpu.config import apply_cli_overrides as j_apply_overrides
from m2mixer_tpu.config import load as jload
from m2mixer_tpu.datasets.mimic import MIMICDataModule as JMIMIC
from m2mixer_tpu.models import get_model as jget_model
from m2mixer_tpu.parallel import MeshConfig
from m2mixer_tpu.training import Trainer as JTrainer
from m2mixer_tpu_torch.config import apply_cli_overrides, load
from m2mixer_tpu_torch.datasets import MIMICDataModule
from m2mixer_tpu_torch.models import get_model
from m2mixer_tpu_torch.training.trainer import Trainer
from m2mixer_tpu_torch.utils.weights import flatten_tree, from_jax_params, to_jax_params
from test_torch_hygiene import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H_CFG = os.path.join(REPO, "cfg", "mimic", "mimic_m2-mixer_H.yml")
TOL = 1e-5
SAMPLES = 100  # 80 train (5 batches of 16), 10 val, 10 test


def overrides(tmp, K, batch):
    return ["model.dropout=0.0", "train.optimizer.eps=0.001", "train.epochs=1",
            f"train.grad_accum_steps={K}", f"dataset.params.batch_size={batch}",
            "train.log_interval_steps=1", "train.seed=0", f"train.tensorboard_path={tmp}",
            "train.compiled_epochs=false"]


def datamodule(cls, batch):
    dm = cls.synthetic(n=SAMPLES, batch_size=batch, seed=4)
    dm.shuffle_train = False  # the files' order on both sides
    return dm


def metrics(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def port_fit(tmp, K, batch, init):
    cfg = load(H_CFG)
    apply_cli_overrides(cfg, overrides(tmp, K, batch), warn=False)
    task = get_model(cfg.model.type)(cfg.model, cfg.train.optimizer, device="cpu")
    task.network.load_state_dict(from_jax_params(init, task.network))
    trainer = Trainer(cfg.train, name=f"port_k{K}_b{batch}", work_dir=str(tmp))
    trainer.fit(task, datamodule(MIMICDataModule, batch))
    trainer.logger.close()
    return trainer, task, metrics(trainer.logger.log_dir)


@pytest.fixture(scope="module")
def init():
    """The port's seeded initial weights in the JAX layout (both sides start
    from them; JAX's own init would compile for nothing but the values)."""
    cfg = load(H_CFG)
    task = get_model(cfg.model.type)(cfg.model, cfg.train.optimizer, device="cpu", seed=3)
    return to_jax_params(task.network.state_dict())


@pytest.fixture(scope="module")
def jax_run(init, tmp_path_factory):
    """The JAX trainer's epoch at K = 2: its final weights and metrics lines."""
    tmp = tmp_path_factory.mktemp("accum_jax")
    cfg = jload(H_CFG)
    j_apply_overrides(cfg, ["model.gradblend=false", *overrides(tmp, 2, 16)], warn=False)
    task = jget_model(cfg.model.type)(cfg.model, cfg.train.optimizer)
    dm = datamodule(JMIMIC, 16)
    trainer = JTrainer(cfg.train, name="jax_k2", mesh_config=MeshConfig(data=1, model=1),
                       use_wandb=False)
    trainer.params = jax.tree.map(np.copy, init)  # the trainer donates its buffers
    trainer.fit(task, dm)
    final = jax.tree.map(np.asarray, trainer.params)
    return final, metrics(trainer.logger.log_dir), trainer.global_step


def test_accumulation_matches_the_jax_trainer(init, jax_run, tmp_path):
    final, j_rows, j_steps = jax_run
    trainer, task, rows = port_fit(tmp_path, 2, 16, init)
    assert trainer.global_step == j_steps == 3  # two full groups and the partial one
    steps = [(r["step"], r["train_loss_step"]) for r in rows if "train_loss_step" in r]
    j_steps_logged = [(r["step"], r["train_loss_step"]) for r in j_rows if "train_loss_step" in r]
    assert [s for s, _ in steps] == [s for s, _ in j_steps_logged] == [1, 2]
    for (_, a), (_, b) in zip(steps, j_steps_logged):
        assert abs(a - b) <= TOL
    for key in ("train_loss", "train_loss_static", "train_loss_time", "train_loss_fusion",
                "val_loss"):
        got = [r[key] for r in rows if key in r]
        want = [r[key] for r in j_rows if key in r]
        assert len(got) == len(want) == 1, key
        assert abs(got[0] - want[0]) <= TOL * max(1.0, abs(want[0])), key
    got = flatten_tree(to_jax_params(task.network.state_dict())["params"])
    moved = 0
    for path, leaf in flatten_tree(final["params"]).items():
        assert np.abs(got[path] - leaf).max() <= TOL, path
        moved += not np.array_equal(leaf, flatten_tree(init["params"])[path])
    assert moved > 20


def test_two_micro_batches_equal_one_batch(init, tmp_path):
    states = []
    for K, batch in ((2, 16), (1, 32)):
        trainer, task, rows = port_fit(tmp_path / f"k{K}", K, batch, init)
        assert trainer.global_step == 3  # 80 samples: 2.5 updates of 32, the last one partial
        states.append(task.network.state_dict())
    for k in states[0]:
        err = (states[0][k] - states[1][k]).abs().max().item()
        assert err <= 1e-6, (k, err)
    assert any(not torch.equal(states[0][k], v) for k, v in
               from_jax_params(init, task.network).items())
