"""The port's SoftAdapt (``modules/softadapt.py``) and the estimator options
of ``MultiLossTask`` against the JAX package's, on the CPU.

- Fornberg's backward coefficients and ``LossWeightedSoftAdapt``'s weights
  on seeded loss histories of 2 to 8 epochs (the accuracy order shortened
  for the short ones): equal to JAX's within 1e-12.
- The epoch hooks fed the same ``val_loss_<branch>`` sequence apply the same
  weights, epoch by epoch, refitting at every ``update_loss_weights_per_epoch``
  epochs but the first.
- The option checks: the combinations JAX refuses raise its ``ValueError``
  on both sides; SoftAdapt, GradBlend and GradNorm build; mixup, CutMix and
  the calibration log still raise "not yet ported".
"""

import os

import numpy as np
import pytest

from m2mixer_tpu.config import apply_cli_overrides as j_apply_overrides
from m2mixer_tpu.config import load as jload
from m2mixer_tpu.models import get_model as jget_model
from m2mixer_tpu.modules import softadapt as jsa
from m2mixer_tpu_torch.config import apply_cli_overrides, load
from m2mixer_tpu_torch.models import get_model
from m2mixer_tpu_torch.modules import softadapt as psa
from test_torch_hygiene import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "cfg", "avmnist", "avmnist_softadapt.yml")
TOL = 1e-12


def configs(*overrides):
    pair = jload(CFG), load(CFG)
    for cfg, apply in zip(pair, (j_apply_overrides, apply_cli_overrides)):
        apply(cfg, list(overrides), warn=False)
    return pair


@pytest.mark.parametrize("accuracy", range(1, 8))
def test_finite_difference_coefficients_match_jax(accuracy):
    got = psa.finite_difference_coefficients(order=1, accuracy=accuracy)
    want = jsa.finite_difference_coefficients(order=1, accuracy=accuracy)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert abs(got.sum()) < 1e-9  # a derivative's stencil annihilates constants


@pytest.mark.parametrize("length", range(2, 9))
def test_softadapt_weights_match_jax(length):
    rng = np.random.RandomState(length)
    histories = [np.cumsum(rng.rand(length) * -0.2) + 2.0 + rng.rand() for _ in range(3)]
    for order in (1, 5):
        got = psa.LossWeightedSoftAdapt(beta=-0.1, accuracy_order=order)
        want = jsa.LossWeightedSoftAdapt(beta=-0.1, accuracy_order=order)
        w = got.get_component_weights(*histories)
        np.testing.assert_allclose(w, want.get_component_weights(*histories), rtol=0, atol=TOL)
        assert abs(w.sum() - 1.0) < 1e-7


@pytest.mark.parametrize("every", [2, 3])
def test_hooks_apply_the_same_weights_as_jax(every):
    jc, c = configs(f"model.update_loss_weights_per_epoch={every}", "model.dropout=0.0")
    jtask = jget_model(jc.model.type)(jc.model, jc.train.optimizer)
    task = get_model(c.model.type)(c.model, c.train.optimizer, device="cpu")
    rng = np.random.RandomState(every)
    seen = set()
    for epoch in range(8):
        logs = {f"val_loss_{n}": float(2.0 - 0.1 * epoch * (i + 1) + 0.05 * rng.rand())
                for i, n in enumerate(task.loss_names)}
        for t in (task, jtask):
            t.on_train_epoch_start(None, epoch)
            t.on_validation_epoch_end(None, epoch, dict(logs))
        got = task.make_ctx(epoch + 1, "train")["loss_weights"]
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, jtask.make_ctx(epoch + 1, "train")["loss_weights"],
                                   rtol=0, atol=TOL)
        seen.add(tuple(got))
    assert len(seen) == 1 + 7 // every  # the initial 1/3s, then one vector a refit


@pytest.mark.parametrize("overrides,match", [
    (["model.use_softadapt=true", "model.gradnorm=true"], "gradnorm and model.use_softadapt"),
    (["model.use_softadapt=false", "model.gradblend=true", "model.gradnorm=true"],
     "gradnorm and model.gradblend"),
    (["model.use_softadapt=false", "model.gradnorm={update_every: 0}"], "update_every"),
])
def test_refused_combinations_raise_as_in_jax(overrides, match):
    jc, c = configs(*overrides)
    with pytest.raises(ValueError, match=match):
        jget_model(jc.model.type)(jc.model, jc.train.optimizer)
    with pytest.raises(ValueError, match=match):
        get_model(c.model.type)(c.model, c.train.optimizer, device="cpu")


@pytest.mark.parametrize("overrides,attrs", [
    ([], {"use_softadapt": True, "update_loss_weights_per_epoch": 6}),
    (["model.use_softadapt=false", "model.gradblend=true"],
     {"use_gradblend": True, "gb_update_freq": 20, "gb_epochs": 20}),
    (["model.use_softadapt=false", "model.gradnorm=true"],
     {"use_gradnorm": True, "gn_alpha": 1.5, "gn_update_every": 1}),
])
def test_estimator_options_build_with_jax_defaults(overrides, attrs):
    jc, c = configs(*overrides)
    jtask = jget_model(jc.model.type)(jc.model, jc.train.optimizer)
    task = get_model(c.model.type)(c.model, c.train.optimizer, device="cpu")
    for name, value in attrs.items():
        assert getattr(task, name) == getattr(jtask, name) == value, name
    np.testing.assert_array_equal(task.current_loss_weights(), jtask.current_loss_weights())


@pytest.mark.parametrize("key", ["mixup_alpha", "cutmix_alpha", "log_calibration"])
def test_other_recipe_options_stay_unported(key):
    _, c = configs(f"model.{key}=0.2")
    with pytest.raises(NotImplementedError, match=f"not yet ported: model.{key}"):
        get_model(c.model.type)(c.model, c.train.optimizer, device="cpu")
