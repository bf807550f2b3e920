"""The port's DynaMixerOp in bf16 compute against the JAX package, on the CPU.

Two references, as ``ROADMAP.md`` §3 records:

- the kernel math. ``dynamixer_op_reference(..., compute_dtype=bfloat16)``
  (what ``fused_dynamixer_op`` runs on the CPU, and what bf16 K4f/K4b are held
  to on the card) against JAX's ``dynamixer_op_reference`` with
  ``compute_dtype=bfloat16`` (``_op_math``, whose VJP is the Pallas backward),
  forward and ``jax.vjp``. Both round at the same points: the output (float32)
  within 1e-5 x max(1, max|JAX|); every gradient within 2e-2 x max(1,
  max|JAX|), and of the three rounded weight gradients' elements at most
  ``MISMATCH`` not bit-equal (a float32 sum in another order can land on the
  other side of a rounding boundary). The float32-math control, rounded where
  the bf16 one rounds, differs in more than that.
- the modules. The port's bf16 ``DynaMixerOp`` runs that kernel math, where
  flax's bf16 ``DynaMixerOp`` rounds every Linear output, the softmax and the
  mix to bf16: the two differ at the bf16 plain-module level. The modules
  (flax's init, every leaf jittered) within ``MODULE_FWD`` x max(1, max|flax|)
  forward and ``MODULE_GRAD`` per gradient (flax's backward sums in bf16); a
  narrowed ``avmnist_3loss_dyna.yml`` at ``model.precision=bf16`` takes one
  train step from the same weights and batch as the JAX task: the losses
  within ``LOSS_REL`` relative. Its gradients are held to the float32
  gradients of the same network (the port's float32 step, which
  ``tests/test_torch_dynamixer_training.py`` holds to JAX's at 1e-5): each
  within ``STEP_GRAD`` x max(1, max|float32|), and the worst of them no
  further off than JAX's own bf16 gradients are (flax's bf16 backward sums
  the biases' gradients in bf16: 0.155 off at a magnitude of 0.98, where the
  port's are within 0.009).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2mixer_tpu import config as jcfg
from m2mixer_tpu.models import get_model as j_get_model
from m2mixer_tpu.modules import dynamixer as jdm
from m2mixer_tpu.ops import dynamixer_kernel as jd
from m2mixer_tpu_torch import config as pcfg
from m2mixer_tpu_torch.models import get_model
from m2mixer_tpu_torch.modules import dynamixer as tdm
from m2mixer_tpu_torch.ops import dynamixer_kernel as td
from m2mixer_tpu_torch.training.trainer import Trainer
from m2mixer_tpu_torch.utils.weights import from_jax_params
from test_torch_dynamixer_kernel import case, transposed
from test_torch_dynamixer_training import CFG, batches

BF16 = torch.bfloat16
FWD_TOL = 1e-5
REL = 2e-2
MISMATCH = 0.01
ROUNDED = (False, True, False, True, False, True, False)  # dx, then DynaMixerOpParams
SHAPES = {"small": dict(S=4, L=4, C=16, H=4, R=3), "grid": dict(S=12, L=7, C=64, H=4, R=2)}
MODULE_FWD = 2e-2
MODULE_GRAD = 5e-2
LOSS_REL = 1e-3
STEP_GRAD = 2e-2


def rel_err(got, want):
    return float(np.max(np.abs(got - want))) / max(1.0, float(np.max(np.abs(want))))


def port_op(x, g, params, H, R, cd):
    """The port's op on JAX-layout ``params`` (handed over output-major), its
    weight gradients transposed back to the JAX layout."""
    xt = torch.from_numpy(x).requires_grad_()
    pt = [torch.from_numpy(a).requires_grad_() for a in transposed(params)]
    out = td.fused_dynamixer_op(xt, td.DynaMixerOpParams(*pt), H, R, compute_dtype=cd)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), [xt.grad.numpy()] + transposed([p.grad.numpy() for p in pt])


def differing(got, want):
    diff = sum(int(np.sum(a != b)) for a, b, r in zip(got, want, ROUNDED) if r)
    return diff / sum(a.size for a, r in zip(got, ROUNDED) if r)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bf16_op_math_matches_jax(shape):
    geom = SHAPES[shape]
    H, R = geom["H"], geom["R"]
    x, g, params = case(2, **geom)
    p = jd.DynaMixerOpParams(*map(jnp.asarray, params))
    def fwd_vjp(x, p):
        out, vjp = jax.vjp(lambda x, p: jd.dynamixer_op_reference(x, p, H, R, jnp.bfloat16),
                           x, p)
        return out, vjp(jnp.asarray(g))

    out, (gx, gp) = jax.jit(fwd_vjp)(jnp.asarray(x), p)
    want = [np.asarray(gx)] + [np.asarray(a) for a in gp]
    got_out, got = port_op(x, g, params, H, R, BF16)
    assert got_out.dtype == np.float32 and rel_err(got_out, np.asarray(out)) <= FWD_TOL
    for a, b, r in zip(got, want, ROUNDED):
        assert a.dtype == np.float32 and rel_err(a, b) <= REL
        if r:
            assert np.array_equal(a, torch.from_numpy(a).to(BF16).float().numpy())
    assert differing(got, want) <= MISMATCH
    _, f32 = port_op(x, g, params, H, R, torch.float32)
    control = [torch.from_numpy(a).to(BF16).float().numpy() if r else a
               for a, r in zip(f32, ROUNDED)]
    assert differing(control, want) > MISMATCH


def jittered(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.randn(*np.shape(a))).astype(np.float32), tree)


MODULES = {
    "DynaMixerOp": (lambda: jdm.DynaMixerOp(16, 5, 4, 3, dtype=jnp.bfloat16),
                    lambda: tdm.DynaMixerOp(16, 5, 4, 3, dtype=BF16), (3, 5, 16)),
    "DynaMixerBlock": (lambda: jdm.DynaMixerBlock(16, 5, 4, 2, dtype=jnp.bfloat16),
                       lambda: tdm.DynaMixerBlock(16, 5, 4, 2, dtype=BF16), (2, 5, 5, 16)),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_bf16_module_matches_flax(name):
    """bf16 in and out as flax's module, float32 parameters and gradients."""
    jmod_fn, tmod_fn, shape = MODULES[name]
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    jmod = jmod_fn()
    init = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = {"params": jittered(init["params"], 1)}
    def fwd_vjp(v, x):
        out, vjp = jax.vjp(lambda v, x: jmod.apply(v, x).astype(jnp.float32), v, x)
        return out, vjp(jnp.asarray(g))

    out, (jgrads, jgx) = jax.jit(fwd_vjp)(variables, jnp.asarray(x))
    tmod = tmod_fn().eval()
    tmod.load_state_dict(from_jax_params(variables, tmod))
    assert all(p.dtype == torch.float32 for p in tmod.parameters())
    xt = torch.from_numpy(x).requires_grad_()
    tout = tmod(xt.to(BF16))
    assert tout.dtype == BF16
    assert rel_err(tout.detach().float().numpy(), np.asarray(out)) <= MODULE_FWD
    tout.float().backward(torch.from_numpy(g))
    assert rel_err(xt.grad.numpy(), np.asarray(jgx)) <= MODULE_GRAD
    want = from_jax_params(jgrads, tmod)
    for n, p in tmod.named_parameters():
        assert p.grad.dtype == torch.float32
        assert rel_err(p.grad.numpy(), want[n].numpy()) <= MODULE_GRAD, n


BF16_CFG = CFG.replace("  dropout: 0.0\n", "  dropout: 0.0\n  precision: bf16\n")


def test_bf16_dyna_config_step_matches_jax(tmp_path):
    """One train step of the narrowed config at model.precision=bf16 (the
    training test's geometry, dropout 0), the JAX task's and the port's from
    the same weights and batch: the losses, and the gradients against the
    float32 ones."""
    jc = jcfg.loads(BF16_CFG)
    jtask = j_get_model(jc.model.type)(jc.model, jc.train.optimizer)
    batch = batches(1)[0]
    params = jax.tree.map(np.asarray, jtask.init_params(jax.random.PRNGKey(0), batch))
    ctx = {k: jnp.asarray(v) for k, v in jtask.make_ctx(0, "train").items()}
    (jloss, aux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtask.step(p, batch, ctx, {}, train=True), has_aux=True))(params)

    def port_task(text):
        c = pcfg.loads(text)
        task = get_model(c.model.type)(c.model, c.train.optimizer, device="cpu")
        task.network.load_state_dict(from_jax_params(params, task.network))
        return c, task

    c, task = port_task(BF16_CFG)
    op = task.network.encoders[0].blocks[0].mix_h
    assert type(op).__name__ == "DynaMixerOp" and op.compute_dtype == BF16
    trainer = Trainer(c.train, work_dir=str(tmp_path))
    trainer.setup(task)
    loss, paux = trainer.train_step(task, trainer._to_device(task, batch),
                                    task.make_ctx(0, "train"))
    assert abs(float(loss) - float(jloss)) <= LOSS_REL * abs(float(jloss))
    for k, v in aux["losses"].items():
        assert abs(paux["losses"][k].item() - float(v)) <= LOSS_REL * abs(float(v)), k
    _, task32 = port_task(CFG)
    loss32, _ = task32.step(trainer._to_device(task32, batch), task32.make_ctx(0, "train"),
                            train=True)
    loss32.backward()
    f32 = dict(task32.network.named_parameters())
    jbf16 = from_jax_params(jax.tree.map(np.asarray, jgrads), task.network)
    worst_port = worst_jax = 0.0
    for n, p in task.network.named_parameters():
        ref = f32[n].grad.numpy()
        err = rel_err(p.grad.numpy(), ref)
        assert err <= STEP_GRAD, (n, err)
        worst_port = max(worst_port, err)
        worst_jax = max(worst_jax, rel_err(jbf16[n].numpy(), ref))
    assert worst_port <= worst_jax, (worst_port, worst_jax)
