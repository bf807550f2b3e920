"""The port's GradBlend (``modules/gradblend.py``) against the JAX package's,
on the CPU.

``estimate_gradblend_weights`` of the port and of JAX from the same weights
(the port's seeded network carried across by ``to_jax_params``) on the same
training split, at dropout 0, ``gb_epochs`` 2, 160 training samples, batch
16: the three weights within rtol 1e-3 / atol 1e-6 (the tolerance of JAX's
own parity test against the reference, ``tests/training/test_recipes.py``).
Cases: the AV-MNIST mixer of ``avmnist_gradblend.yml`` on plain blocks and
on ``PallasStacked*`` (the kernels' plain version on the CPU, the JAX side
the plain network: the same function), ``MimicMixerMultiLoss``
(``mimic_m2-mixer_H.yml``) and ``MimicRecurrent`` (``mimic_gru.yml``). Each
JAX estimate is made once, in a module fixture.

The edges: paired encoders give None; fewer than 10 training samples (an
empty 10% cut) raise; an estimate leaves the live network's parameters,
gradients, train/eval mode and dropout streams as they were; and the epoch
hook re-estimates at ``epoch % gb_update_freq == 0`` only.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from m2mixer_tpu.config import apply_cli_overrides as j_apply_overrides
from m2mixer_tpu.config import load as jload
from m2mixer_tpu.models import get_model as jget_model
from m2mixer_tpu.modules.gradblend import estimate_gradblend_weights as j_estimate
from m2mixer_tpu_torch.config import apply_cli_overrides, load
from m2mixer_tpu_torch.datasets import MIMICDataModule, synthetic_avmnist_arrays
from m2mixer_tpu_torch.datasets.surrogate import gen_mimic
from m2mixer_tpu_torch.models import get_model
from m2mixer_tpu_torch.modules.gradblend import estimate_gradblend_weights
from m2mixer_tpu_torch.serving import to_torch_kernel_serving
from m2mixer_tpu_torch.utils.weights import to_jax_params
from test_torch_hygiene import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = {"avmnist": os.path.join(REPO, "cfg", "avmnist", "avmnist_gradblend.yml"),
        "mimic_mixer": os.path.join(REPO, "cfg", "mimic", "mimic_m2-mixer_H.yml"),
        "mimic_gru": os.path.join(REPO, "cfg", "mimic", "mimic_gru.yml")}
OVERRIDES = ["model.dropout=0.0", "model.gradblend=true", "model.gb_epochs=2",
             "dataset.params.batch_size=16", "train.seed=3"]
RTOL, ATOL = 1e-3, 1e-6
N_TRAIN, BATCH = 160, 16


def configs(name, *extra):
    pair = jload(CFGS[name]), load(CFGS[name])
    for cfg, apply in zip(pair, (j_apply_overrides, apply_cli_overrides)):
        apply(cfg, [*OVERRIDES, *extra], warn=False)
    return pair


def avmnist_train(n=N_TRAIN):
    return synthetic_avmnist_arrays(n, seed=4, learnable=True)


@pytest.fixture(scope="module")
def mimic_train(tmp_path_factory):
    """The train split of a ``gen_mimic`` surrogate of 200 stays (160 train)."""
    data = str(tmp_path_factory.mktemp("mimic"))
    gen_mimic(data, n=200, seed=2)
    dm = MIMICDataModule(data_dir=data, batch_size=BATCH)
    dm.setup("fit")
    return dm.splits["train"]


def fake_trainer(arrays, seed=3, params=None):
    """What both adapters read of a trainer: its data module's train split
    and batch size, its seed (and JAX's its parameters)."""
    dm = SimpleNamespace(splits={"train": arrays}, batch_size=BATCH)
    return SimpleNamespace(datamodule=dm, seed=seed, params=params)


def port_task(cfg):
    return get_model(cfg.model.type)(cfg.model, cfg.train.optimizer, device="cpu",
                                     seed=int(cfg.train.seed))


@pytest.fixture(scope="module")
def cases(mimic_train):
    """{case: (the port's task and its estimate's inputs, JAX's weights)}."""
    out = {}
    for name in ("avmnist", "mimic_mixer", "mimic_gru"):
        jc, c = configs(name)
        task = port_task(c)
        arrays = avmnist_train() if name == "avmnist" else mimic_train
        jtask = jget_model(jc.model.type)(jc.model, jc.train.optimizer)
        params = to_jax_params(task.network.state_dict())
        out[name] = (c, task, arrays, j_estimate(jtask, fake_trainer(arrays, params=params)))
    return out


@pytest.mark.parametrize("case", ["avmnist/plain", "avmnist/stacked", "mimic_mixer/plain",
                                  "mimic_gru/plain"])
def test_gradblend_weights_match_jax(cases, case):
    name, flavor = case.split("/")
    cfg, task, arrays, want = cases[name]
    if flavor == "stacked":
        task, _ = to_torch_kernel_serving(cfg, task.network.state_dict(), device="cpu")
        assert type(task.network.fusion_mixer).__name__ == "PallasStackedFusionMixer"
    got = estimate_gradblend_weights(task, fake_trainer(arrays))
    assert got.dtype == np.float32 and got.shape == (3,)
    assert np.isfinite(got).all() and (got > 0).all() and abs(got.sum() - 1) < 1e-6
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_paired_encoders_give_none():
    _, c = configs("avmnist", "model.paired_encoders=true")
    task = port_task(c)
    assert task.network.paired_encoder is not None
    assert estimate_gradblend_weights(task, fake_trainer(avmnist_train(40))) is None
    assert estimate_gradblend_weights(task, SimpleNamespace(datamodule=None, seed=0)) is None


def test_an_empty_validation_cut_raises():
    _, c = configs("avmnist")
    with pytest.raises(ValueError, match="at least 10 training samples"):
        estimate_gradblend_weights(port_task(c), fake_trainer(avmnist_train(9)))


def streams(task):
    rng = task.dropout_rng
    return [rng.host.get_state(), rng.device.get_state(), task.depth_rng.host.get_state()]


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_an_estimate_leaves_the_live_network_as_it_was(mode):
    """Dropout 0.1 (the config's), so the copies draw; the live network's
    weights, gradients, mode and random streams are untouched."""
    _, c = configs("avmnist", "model.dropout=0.1", "model.gb_epochs=1")
    task = port_task(c)
    net = task.network
    net.train()
    arrays = avmnist_train(48)
    batch = {k: torch.from_numpy(v[:8]) for k, v in arrays.items()}
    task.step(batch, task.make_ctx(0, "train"), train=True)[0].backward()
    net.train(mode == "train")
    state = {k: v.clone() for k, v in net.state_dict().items()}
    grads = {n: p.grad.clone() for n, p in net.named_parameters() if p.grad is not None}
    before = streams(task)
    w = estimate_gradblend_weights(task, fake_trainer(arrays))
    assert np.isfinite(w).all()
    assert all(torch.equal(v, net.state_dict()[k]) for k, v in state.items())
    assert grads and {n: p.grad for n, p in net.named_parameters()
                      if p.grad is not None}.keys() == grads.keys()
    assert all(torch.equal(p.grad, grads[n]) for n, p in net.named_parameters() if n in grads)
    assert all(m.training == (mode == "train") for m in net.modules())
    assert all(torch.equal(a, b) for a, b in zip(before, streams(task)))
    assert all(p.requires_grad for p in net.parameters())


def test_the_hook_re_estimates_every_gb_update_freq_epochs(monkeypatch):
    import m2mixer_tpu_torch.modules.gradblend as gb

    _, c = configs("avmnist", "model.gb_update_freq=3")
    task = port_task(c)
    calls = []
    monkeypatch.setattr(gb, "estimate_gradblend_weights",
                        lambda t, tr: calls.append(1) or np.array([0.2, 0.3, 0.5], np.float32))
    fixed = task.current_loss_weights()
    for epoch in range(7):
        task.on_train_epoch_start(None, epoch)
        if epoch == 0:
            np.testing.assert_array_equal(task.current_loss_weights(),
                                          np.float32([0.2, 0.3, 0.5]))
    assert len(calls) == 3  # epochs 0, 3 and 6
    task.gb_weights = None
    np.testing.assert_array_equal(task.current_loss_weights(), fixed)
