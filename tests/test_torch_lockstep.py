"""Epoch-level lockstep of the port's trainer against the JAX package's, on the CPU.

The S mixer config (``cfg/avmnist/avmnist_m2-mixer_S.yml``) at dropout 0,
trained for 3 epochs on 384 surrogate AV-MNIST samples (the JAX package's
``datasets/surrogate.py``: train 352 = 11 batches of 32, val one batch, test
64) in the files' order (``shuffle=False`` for training on both sides), from
one initial parameter tree: JAX's ``parity._shared_init``, carried into the
port by ``utils/weights.py::from_jax_params``. The JAX side is
``parity.native_protocol`` (its ``Trainer.fit`` and a best-checkpoint test);
the port's is ``Trainer.fit`` and ``Trainer.test(ckpt="best")`` with the
plain modules. Held: per-epoch train and val loss, the best epoch, and the
test loss, accuracy and F1m.

Tolerances from the measured gap (ROADMAP.md §3): the two sides sum the
same float32 math in other orders, and Adam at the config's lr 0.01 carries
the differences through 33 steps. Measured on the CPU: train loss within
4.8e-7, val loss 9.5e-7, test loss 9.5e-7, the same best epoch, test
accuracy and F1m equal. ``LOSS_TOL`` 1e-5 leaves a factor of 10. A weight
drift that small can still flip the argmax of one borderline test sample, so
accuracy may differ by one sample in 64 (as the JAX package's own lockstep
allows); F1m is held within 1e-6, as there.

Marked ``slow`` (about 45 s on the CPU, both trainers): it is not part of the
tier-1 run.
"""

import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
from test_torch_hygiene import one_torch_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.slow

REPO = Path(__file__).resolve().parents[1]
S_CFG = str(REPO / "cfg" / "avmnist" / "avmnist_m2-mixer_S.yml")
EPOCHS = 3
N_SAMPLES = 384
LOSS_TOL = 1e-5
N_TEST = N_SAMPLES // 6


def port_protocol(data_dir: str, work_dir: str, init_params) -> dict:
    """The port's ``Trainer.fit`` + best-checkpoint test on the S config as
    ``parity._load_s_cfg`` sets it up (dropout 0, seed 0, no workers)."""
    from m2mixer_tpu_torch import config as pcfg
    from m2mixer_tpu_torch.datasets import get_data_module
    from m2mixer_tpu_torch.models import get_model
    from m2mixer_tpu_torch.training.trainer import Trainer
    from m2mixer_tpu_torch.utils.weights import from_jax_params

    cfg = pcfg.load(S_CFG)
    cfg.dataset.params.data_dir = data_dir
    cfg.dataset.params.num_workers = 0
    cfg.train.epochs = EPOCHS
    cfg.train.seed = 0
    cfg.model.dropout = 0.0
    task = get_model(cfg.model.type)(cfg.model, cfg.train.optimizer, device="cpu", seed=0)
    task.network.load_state_dict(from_jax_params(init_params, task.network))
    dm = get_data_module(cfg.dataset.type)(**cfg.dataset.params)
    trainer = Trainer(cfg.train, name="lockstep", work_dir=work_dir)
    trainer.fit(task, dm)
    logs = trainer.test(task, dm, ckpt="best")
    trainer.logger.close()
    with open(os.path.join(trainer.logger.log_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {"history": {k: [r[k] for r in rows if k in r] for k in ("train_loss", "val_loss")},
            "best_epoch": int(trainer.logger.summary["best_val_loss_epoch"]),
            **{k: float(logs[k]) for k in ("test_loss", "test_acc", "test_f1m")}}


def test_mixer_s_trains_in_lockstep_with_jax(tmp_path):
    from m2mixer_tpu.datasets import get_data_module
    from m2mixer_tpu.datasets.surrogate import generate
    from m2mixer_tpu.parity import _load_s_cfg, _shared_init, native_protocol

    data = str(tmp_path / "avmnist")
    generate("avmnist", data, n=N_SAMPLES)
    cfg = _load_s_cfg(data, str(tmp_path / "jax"), EPOCHS, seed=0, dropout=0.0)
    params, _ = _shared_init(cfg, get_data_module(cfg.dataset.type)(**cfg.dataset.params))
    init = jax.tree.map(np.array, params)  # the JAX trainer donates its input arrays
    want = native_protocol(cfg, str(tmp_path / "jax"), init_params=params)
    got = port_protocol(data, str(tmp_path / "port"), init)

    for key in ("train_loss", "val_loss"):
        a, b = np.asarray(got["history"][key]), np.asarray(want["history"][key])
        assert a.shape == b.shape and len(b) >= EPOCHS, (key, a, b)
        assert np.abs(a - b).max() <= LOSS_TOL, (key, a, b)
    assert got["best_epoch"] == want["best_epoch"]
    assert abs(got["test_loss"] - want["test_loss"]) <= LOSS_TOL
    assert abs(got["test_acc"] - want["test_acc"]) <= 1 / N_TEST + 1e-9
    assert abs(got["test_f1m"] - want["test_f1m"]) <= 1e-6
