"""The port's GradNorm (``modules/gradnorm.py``) and
``MultiLossTask.step_components`` against the JAX package's, on the CPU.

The AV-MNIST mixer at the estimator configs' widths (``avmnist_softadapt.yml``
with SoftAdapt off and ``model.gradnorm: {alpha: 1.5}``), dropout 0, its
probe batch the first 16 training samples:

- ``measure_gradnorm_weights`` of the port (plain blocks, ``PallasStacked*``
  and ``Pallas*``, the kernels' plain versions here) and of JAX within 1e-5
  relative, over two successive calls: epoch 0 on the initial weights, then
  epoch 1 on the weights after one port train step under the new weights
  (carried to JAX by ``to_jax_params``), the second call reading the first's
  losses;
- ``step_components``: its sum is ``step()``'s total (and the fusion loss
  alone after the freeze epoch), and each branch's gradient matches JAX's
  ``vjp`` of its ``step_components`` within 5e-5 x max(1, max|JAX|);
- past the freeze epoch, or without a data module, no measurement; a
  measurement leaves the live network's random streams and mode as they
  were.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2mixer_tpu.config import apply_cli_overrides as j_apply_overrides
from m2mixer_tpu.config import load as jload
from m2mixer_tpu.models import get_model as jget_model
from m2mixer_tpu.modules.gradnorm import measure_gradnorm_weights as j_measure
from m2mixer_tpu_torch.config import apply_cli_overrides, load
from m2mixer_tpu_torch.datasets import synthetic_avmnist_arrays
from m2mixer_tpu_torch.models import get_model
from m2mixer_tpu_torch.modules.gradnorm import branch_gradients, measure_gradnorm_weights
from m2mixer_tpu_torch.serving import to_torch_kernel_serving
from m2mixer_tpu_torch.training.trainer import Trainer
from m2mixer_tpu_torch.utils.weights import from_jax_params, to_jax_params
from test_torch_hygiene import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "cfg", "avmnist", "avmnist_softadapt.yml")
OVERRIDES = ["model.use_softadapt=false", "model.gradnorm={alpha: 1.5}", "model.dropout=0.0",
             "dataset.params.batch_size=16", "train.seed=5"]
REL, GRAD = 1e-5, 5e-5
BATCH = 16


def configs(*extra):
    pair = jload(CFG), load(CFG)
    for cfg, apply in zip(pair, (j_apply_overrides, apply_cli_overrides)):
        apply(cfg, [*OVERRIDES, *extra], warn=False)
    return pair


def fake_trainer(arrays, params=None, seed=5):
    dm = SimpleNamespace(splits={"train": arrays}, batch_size=BATCH)
    return SimpleNamespace(datamodule=dm, seed=seed, params=params)


def port_task(cfg, state=None, flavor="plain"):
    task = get_model(cfg.model.type)(cfg.model, cfg.train.optimizer, device="cpu",
                                     seed=int(cfg.train.seed))
    if state is not None:
        task.network.load_state_dict(state)
    if flavor != "plain":
        task, _ = to_torch_kernel_serving(cfg, task.network.state_dict(), device="cpu",
                                          per_block=flavor == "per_block")
    return task


def kernel_layout(cfg, state, flavor):
    if flavor == "plain":
        return state
    return to_torch_kernel_serving(cfg, state, device="cpu", per_block=flavor == "per_block")[1]


def probe(arrays):
    return {k: v[:BATCH] for k, v in arrays.items()}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """Both measurements and the per-branch gradients of JAX, the port's
    second weights (one plain train step), one compile each."""
    jc, c = configs()
    arrays = synthetic_avmnist_arrays(64, seed=6, learnable=True)
    task = port_task(c)
    w0 = {k: v.clone() for k, v in task.network.state_dict().items()}
    jtask = jget_model(jc.model.type)(jc.model, jc.train.optimizer)
    ctx = {k: jnp.asarray(v) for k, v in jtask.make_ctx(0, "train").items()}
    first = j_measure(jtask, fake_trainer(arrays, to_jax_params(w0)), 0)
    jtask.gn_weights = first
    # the port's weights after one step under the first weights
    task.gn_weights = first
    trainer = Trainer(c.train, work_dir=str(tmp_path_factory.mktemp("logs")))
    trainer.setup(task)
    batch = {k: torch.from_numpy(v) for k, v in probe(arrays).items()}
    trainer.train_step(task, batch, task.make_ctx(1, "train"))
    trainer.logger.close()
    w1 = {k: v.detach().clone() for k, v in task.network.state_dict().items()}
    second = j_measure(jtask, fake_trainer(arrays, to_jax_params(w1)), 1)

    params = to_jax_params(w0)
    jbatch = {k: jnp.asarray(v) for k, v in probe(arrays).items()}

    @jax.jit
    def per_branch(p):
        comps, vjp_fn, (total, _) = jax.vjp(
            lambda q: jtask.step_components(q, jbatch, ctx, {}, train=True), p, has_aux=True)
        eye = jnp.eye(comps.shape[0], dtype=comps.dtype)
        return comps, total, jax.vmap(lambda e: vjp_fn(e)[0])(eye)

    comps, total, grads = jax.tree.map(np.asarray, per_branch(params))
    branch_grads = [jax.tree.map(lambda g, i=i: g[i], grads) for i in range(len(comps))]
    return dict(cfg=c, arrays=arrays, w0=w0, w1=w1, first=first, second=second,
                initial=jtask.gn_initial_losses, comps=comps, total=float(total),
                branch_grads=branch_grads)


@pytest.mark.parametrize("flavor", ["plain", "stacked", "per_block"])
def test_two_measurements_match_jax(jax_side, flavor):
    c, arrays = jax_side["cfg"], jax_side["arrays"]
    task = port_task(c, jax_side["w0"], flavor)
    first = measure_gradnorm_weights(task, fake_trainer(arrays), 0)
    assert first.dtype == np.float32 and abs(first.sum() - 3) < 1e-5
    np.testing.assert_allclose(first, jax_side["first"], rtol=REL, atol=0)
    np.testing.assert_allclose(task.gn_initial_losses, jax_side["initial"], rtol=REL, atol=0)
    task.gn_weights = first  # what the epoch hook does with it
    task.network.load_state_dict(kernel_layout(c, jax_side["w1"], flavor))
    second = measure_gradnorm_weights(task, fake_trainer(arrays), 1)
    np.testing.assert_allclose(second, jax_side["second"], rtol=REL, atol=0)
    assert not np.allclose(second, first, rtol=1e-3)


@pytest.mark.parametrize("flavor", ["plain", "stacked"])
def test_step_components_and_their_gradients_match_jax(jax_side, flavor):
    c = jax_side["cfg"]
    task = port_task(c, jax_side["w0"], flavor)
    batch = {k: torch.from_numpy(v) for k, v in probe(jax_side["arrays"]).items()}
    ctx = task.make_ctx(0, "train")
    task.network.train()
    grads, losses, total = branch_gradients(task, batch, ctx)
    step_total, _ = task.step(batch, ctx, train=True)
    comps, (total2, _) = task.step_components(batch, ctx, train=True)
    step_total, total2 = float(step_total.detach()), float(total2.detach())
    assert float(total) == step_total == total2
    comps = torch.stack(comps).detach()
    assert abs(float(comps.sum()) - step_total) <= 1e-6
    np.testing.assert_allclose(comps.numpy(), jax_side["comps"], rtol=REL, atol=0)
    assert abs(float(total) - jax_side["total"]) <= REL * abs(jax_side["total"])
    names = [n for n, p in task.network.named_parameters() if p.requires_grad]
    for i, want_tree in enumerate(jax_side["branch_grads"]):
        want = kernel_layout(c, from_jax_params(want_tree, port_task(c).network),
                             flavor)
        for name, got in zip(names, grads[i]):
            w = want[name]
            tol = GRAD * max(1.0, float(w.abs().max()))
            err = float((got - w).abs().max())
            assert err <= tol, (i, name, err, tol)


def test_frozen_step_components_are_the_fusion_loss():
    _, c = configs("model.freeze_modalities_on_epoch=1")
    task = port_task(c)
    arrays = synthetic_avmnist_arrays(16, seed=6, learnable=True)
    batch = {k: torch.from_numpy(v) for k, v in arrays.items()}
    ctx = task.make_ctx(1, "train")
    comps, (total, aux) = task.step_components(batch, ctx, train=True)
    comps, total = torch.stack(comps).detach(), float(total.detach())
    assert comps[:-1].abs().max() == 0 and float(comps[-1]) == total
    assert total == float(aux["losses"]["fusion"].detach())
    assert measure_gradnorm_weights(task, fake_trainer(arrays), 1) is None
    assert measure_gradnorm_weights(task, SimpleNamespace(datamodule=None, seed=0), 0) is None


def test_a_measurement_leaves_the_live_streams_and_mode():
    _, c = configs("model.dropout=0.1")
    task = port_task(c)
    arrays = synthetic_avmnist_arrays(32, seed=6, learnable=True)
    rng = task.dropout_rng
    before = [rng.host.get_state(), task.depth_rng.host.get_state()]
    task.network.eval()
    w = measure_gradnorm_weights(task, fake_trainer(arrays), 0)
    assert np.isfinite(w).all() and abs(w.sum() - 3) < 1e-5
    assert task.dropout_rng is rng and not task.network.training
    assert all(m.dropout_rng is rng for m in task.network.modules() if hasattr(m, "dropout_rng"))
    assert all(torch.equal(a, b) for a, b in
               zip(before, [rng.host.get_state(), task.depth_rng.host.get_state()]))
    assert all(p.grad is None for p in task.network.parameters())
