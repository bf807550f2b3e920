"""The port's bf16 gMLP block and network against the JAX package's, on the CPU.

On the CPU ``fused_gmlp_block`` at ``compute_dtype=bfloat16`` runs the plain
bf16 version (``_block_math`` with JAX's casts) forward and its autograd
backward inside the ``torch.autograd.Function`` whose CUDA side is bf16
K3f/K3b (``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py`` hold the
kernels to it on the card). The JAX side:

- the block forward is ``gmlp_block_reference(..., bfloat16)`` (rate 0) or
  ``_block_math`` with explicit masks (rate 0.1, the port's hash masks fed to
  both sides), jitted; the port's plain version equals it bit for bit once
  the JAX kernel's erf approximation is swapped in (``jax_kernel_gelu``), and
  within one bf16 ulp on at most 1% of the elements as shipped;
- the block gradients are the VJP of ``fused_gmlp_block`` at bf16 (the Pallas
  kernel's in-kernel ``jax.vjp``, interpret mode), or of ``_block_math`` with
  the masks: every tensor within 2e-2 x max(1, max|JAX|), and (JAX's erf
  swapped in) at most 1% of the elements of the gradients that a bf16 cast
  rounds (dx and all but the three biases') differing at all. The port's
  float32 backward, rounded where the bf16 one rounds, fails that share (the
  control). At these sizes the kernel's batch tile is the whole batch, so
  JAX's per-tile rounding of the weight gradients is the port's one rounding
  after the batch sum.

All of that runs in one subprocess with XLA's ``--xla_allow_excess_precision``
off: with it on (the default) XLA on the CPU skips rounding points inside its
fusions, and the bf16 kernel's output differs from ``gmlp_block_reference``
by 7.8e-3 at B=4 N=9 D=16 F=24. The subprocess starts with the module's first
test and runs beside the in-process ones below, which come first. The cases
include two above 128 tokens (129 and 196), where the CUDA kernels take their
large-N route.

Then the narrowed ``avmnist_gmlp.yml`` (depth 1/1/1, the config's widths) at
``model.precision=bf16`` through ``PallasVisiongMLP``/``PallasFusiongMLP``:
served logits within 2e-2 x max(1, max|JAX|) of JAX's network of the same
block types (Pallas in interpret mode, XLA's default flags: the network's
bf16 patch embedding and classifier round in both frameworks at points the
block test does not pin), and the losses of two train steps of the narrow
lockstep config (``tests/test_torch_gmlp_training.py``) at bf16 through the
kernel blocks within 1e-3 relative of JAX's (Adam's first update moves each
weight by about lr whatever the gradient's size, so step 2's losses carry
step 1's bf16 gradients).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from m2mixer_tpu.ops import gmlp_kernel as jg
from m2mixer_tpu_torch.ops import gmlp_kernel as tg
from test_torch_gmlp import (GMLP_CFG, batch, cut_depth, gelu_flavor, jget_model, jittered,
                             jload, _serve_fn)
from test_torch_gmlp_kernel import case
from test_torch_gmlp_training import CFG as LOCKSTEP_CFG
from test_torch_gmlp_training import batches
from test_torch_hygiene import one_torch_thread  # noqa: F401  (autouse)

BF16 = torch.bfloat16
REL = 2e-2
MISMATCH = 0.01
LOSS_REL = 1e-3
RATE = 0.1
# dx and the 10 gradients in GmlpBlockParams order: which a bf16 cast rounds
# (all but b_in, sgu_b and b_out, which add in float32)
ROUNDED = (True, True, True, True, False, True, True, True, False, True, False)
# narrow widths: N <= 16, D <= 32, F <= 48; "odd" has widths that are no
# multiple of 8 (D = 20, F/2 = 22) and N = 13
SHAPES = {"narrow": dict(B=4, N=12, D=32, F=48), "odd": dict(B=3, N=13, D=20, F=44)}
CASES = {f"{shape}-{gelu}-{kind}": (shape, gelu == "tanh", kind) for shape in sorted(SHAPES)
         for gelu in ("erf", "tanh") for kind in ("kernel", "masked")}
# above 128 tokens (the CUDA kernels' large-N route): one case of each kind
SHAPES.update({"n129": dict(B=2, N=129, D=16, F=32), "n196": dict(B=2, N=196, D=16, F=32)})
CASES.update({"n129-tanh-masked": ("n129", True, "masked"),
              "n196-erf-kernel": ("n196", False, "kernel")})
KERNEL_BLOCKS = {"image": "PallasVisiongMLP", "audio": "PallasVisiongMLP",
                 "multimodal": "PallasFusiongMLP"}

_JAX_NO_EXCESS_PRECISION = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")
from m2mixer_tpu.modules.common import set_gelu_approximate
from m2mixer_tpu.ops import gmlp_kernel as jg
bf = jnp.bfloat16
z = dict(np.load(sys.argv[1]))
out = {}
for name in sorted({k.split("/")[0] for k in z}):
    set_gelu_approximate(bool(z[name + "/approx"]))
    p = jg.GmlpBlockParams(*(jnp.asarray(z[f"{name}/p{i}"]) for i in range(10)))
    x, g = jnp.asarray(z[name + "/x"]), jnp.asarray(z[name + "/g"])
    if name + "/m0" in z:  # rate 0.1: the same explicit masks on both sides
        masks = tuple(jnp.asarray(z[f"{name}/m{i}"]) for i in range(3))
        fn = jax.jit(lambda x, p: jg._block_math(x, p, masks, bf))
        out[name + "/fwd"] = np.asarray(fn(x, p))
    else:  # rate 0: the reference forward, the Pallas kernel's VJP (interpret mode)
        out[name + "/fwd"] = np.asarray(jax.jit(lambda x, p: jg.gmlp_block_reference(x, p, bf))(x, p))
        fn = lambda x, p: jg.fused_gmlp_block(x, p, None, 0.0, bf)
    y, vjp = jax.vjp(fn, x, p)
    out[name + "/kernel_fwd"] = np.asarray(y)
    gx, gp = vjp(g)
    for i, a in enumerate([gx, *gp]):
        out[f"{name}/g{i}"] = np.asarray(a)
np.savez(sys.argv[2], **out)
"""


def case_inputs(name):
    """x, g, the parameters (numpy float32), the GELU flavor and, for the
    masked cases, the port's three hash masks at rate 0.1."""
    shape, approx, kind = CASES[name]
    geom = SHAPES[shape]
    x, g, params = case(20 + sorted(CASES).index(name), **geom)
    masks = None
    if kind == "masked":
        masks = [m.numpy() for m in tg.gmlp_masks(17, geom["B"], geom["N"], geom["D"],
                                                   geom["F"], RATE)]
    return x, g, params, approx, masks


@pytest.fixture(scope="module", autouse=True)
def jax_job(tmp_path_factory):
    """Start the JAX subprocess (XLA's excess precision off) for every case
    as the module's first test begins, so that it runs beside the module's
    in-process tests (the served network and the train steps, which come
    first); ``jax_refs`` waits for it."""
    tmp = tmp_path_factory.mktemp("gmlp_bf16")
    arrays = {}
    for name in CASES:
        x, g, params, approx, masks = case_inputs(name)
        arrays.update({f"{name}/x": x, f"{name}/g": g, f"{name}/approx": np.int64(approx)})
        arrays.update({f"{name}/p{i}": a for i, a in enumerate(params)})
        if masks is not None:
            arrays.update({f"{name}/m{i}": m for i, m in enumerate(masks)})
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false", JAX_PLATFORMS="cpu")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, "-c", _JAX_NO_EXCESS_PRECISION, str(tmp / "in.npz"),
                             str(tmp / "out.npz")], env=env, cwd=repo)
    yield proc, tmp
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jax_refs(jax_job):
    """Every case's JAX forward and gradients, from the subprocess."""
    proc, tmp = jax_job
    assert proc.wait(timeout=600) == 0
    with np.load(tmp / "out.npz") as z:
        return {k: z[k] for k in z.files}


def port_fwd_grads(x, g, params, approx, masks, dtype=BF16):
    """The port's forward and (dx, 10 gradients): at rate 0 through the
    wrapper's autograd.Function (its backward: fused_gmlp_block_bwd), with
    masks through autograd of ``_block_math`` with those masks."""
    xt = torch.from_numpy(x).requires_grad_()
    pt = tg.GmlpBlockParams(*(torch.from_numpy(a).requires_grad_() for a in params))
    if masks is None:
        out = tg.fused_gmlp_block(xt, pt, compute_dtype=dtype, approximate_gelu=approx)
        assert type(out.grad_fn).__name__ == "_GmlpFnBackward"
    else:
        out = tg._block_math(xt, pt, approx, tuple(map(torch.from_numpy, masks)), dtype)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), [xt.grad.numpy()] + [p.grad.numpy() for p in pt]


def differing_share(got, want):
    """Share of the rounded tensors' elements that are not bit-equal."""
    diff = sum(int(np.sum(a != b)) for a, b, r in zip(got, want, ROUNDED) if r)
    return diff / sum(a.size for a, r in zip(got, ROUNDED) if r)


def jax_kernel_gelu(x, approximate: bool):
    """The GELU as the JAX kernel computes it: its erf is Abramowitz & Stegun
    7.1.26 (``m2mixer_tpu/ops/mixer_kernel.py::_erf``, within 1.5e-7 of the
    exact erf the port takes). Swapped into the port's plain version, it
    leaves the cast points as the only difference between the two sides."""
    if approximate:
        return torch.nn.functional.gelu(x, approximate="tanh")
    z = x * 0.7071067811865476
    az = z.abs()
    t = 1.0 / (1.0 + 0.3275911 * az)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
                + t * (-1.453152027 + t * 1.061405429))))
    return 0.5 * x * (1.0 + torch.sign(z) * (1.0 - poly * torch.exp(-az * az)))


def with_kernel_blocks(cfg):
    cfg.model.precision = "bf16"
    for key, block in KERNEL_BLOCKS.items():
        cfg.model.modalities[key].block_type = block
    return cfg


def test_bf16_served_network_matches_jax():
    """The narrowed config at bf16 through the kernel block types: the
    port's serve function against JAX's on the same weights (LN leaves
    jittered), batch 3."""
    from m2mixer_tpu_torch.config import load
    from m2mixer_tpu_torch.serving import _build_task, serve_fn
    from m2mixer_tpu_torch.utils.weights import from_jax_params, to_jax_params

    cfg = with_kernel_blocks(cut_depth(load(GMLP_CFG)))
    task = _build_task(cfg, device="cpu", seed=3)
    assert type(task.network.fusion_mixer).__name__ == "PallasFusiongMLP"
    params = {"params": jittered(to_jax_params(task.network.state_dict())["params"], 4)}
    task.network.load_state_dict(from_jax_params(params, task.network))
    assert all(p.dtype == torch.float32 for p in task.network.parameters())
    feats = batch(3, seed=5)
    jcfg = with_kernel_blocks(cut_depth(jload(GMLP_CFG)))
    with gelu_flavor(False):
        jtask = jget_model(jcfg.model.type)(jcfg.model, jcfg.train.optimizer)
        jout = _serve_fn(jtask)(params, feats)
    out = serve_fn(task)({k: torch.from_numpy(v) for k, v in feats.items()})
    got = [out["logits"]] + list(out["branch_logits"])
    want = [jout["logits"]] + list(jout["branch_logits"])
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        assert a.shape == b.shape and np.isfinite(a).all()
        err = float(np.max(np.abs(a - b)))
        assert err <= REL * max(1.0, float(np.max(np.abs(b)))), err


def test_bf16_train_steps_match_jax(tmp_path):
    """Two train steps of the narrow lockstep config at bf16 through the
    kernel block types, from the same initial weights and batches: the total
    and branch losses within LOSS_REL of JAX's."""
    from m2mixer_tpu import config as jcfg
    from m2mixer_tpu.training.trainer import _make_optimizer
    from m2mixer_tpu_torch import config as pcfg
    from m2mixer_tpu_torch.models import get_model
    from m2mixer_tpu_torch.training.trainer import Trainer
    from m2mixer_tpu_torch.utils.weights import from_jax_params

    jc = with_kernel_blocks(jcfg.loads(LOCKSTEP_CFG))
    jtask = jget_model(jc.model.type)(jc.model, jc.train.optimizer)
    steps = batches(2)
    params = jax.tree.map(np.asarray, jtask.init_params(jax.random.PRNGKey(0), steps[0]))
    opt, _ = _make_optimizer(jtask.optimizer_cfg)

    @jax.jit
    def step(params, opt_state, b, ctx):
        (loss, aux), grads = jax.value_and_grad(
            lambda p: jtask.step(p, b, ctx, {}, train=True), has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, aux["losses"]

    jctx = {k: jnp.asarray(v) for k, v in jtask.make_ctx(0, "train").items()}
    p, opt_state, history = params, opt.init(params), []
    for b in steps:
        p, opt_state, loss, losses = step(p, opt_state, b, jctx)
        history.append((float(loss), {k: float(v) for k, v in losses.items()}))

    cfg = with_kernel_blocks(pcfg.loads(LOCKSTEP_CFG))
    task = get_model(cfg.model.type)(cfg.model, cfg.train.optimizer, device="cpu")
    assert type(task.network.encoders[0]).__name__ == "PallasVisiongMLP"
    task.network.load_state_dict(from_jax_params(params, task.network))
    trainer = Trainer(cfg.train, work_dir=str(tmp_path))
    trainer.setup(task)
    ctx = task.make_ctx(0, "train")
    close = lambda a, b: abs(a - b) <= LOSS_REL * max(1.0, abs(b))
    for b, (j_loss, j_losses) in zip(steps, history):
        loss, aux = trainer.train_step(task, trainer._to_device(task, b), ctx)
        assert close(float(loss), j_loss), (float(loss), j_loss)
        for k, v in j_losses.items():
            assert close(aux["losses"][k].item(), v), (k, aux["losses"][k].item(), v)
    assert all(prm.dtype == torch.float32 for prm in task.network.parameters())


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_forward_matches_jax_bit_for_bit(jax_refs, name, monkeypatch):
    """The plain bf16 forward against JAX's (the reference at rate 0, which is
    also the Pallas kernel's output; ``_block_math`` with the same masks at
    rate 0.1), on the bf16 grid: with JAX's erf swapped in, bit for bit; as
    shipped (exact erf), at most MISMATCH of the elements differ, by one bf16
    ulp (measured: 1 of 780 in one case, none in the others); the float32
    forward rounded to bf16 differs in more."""
    x, g, params, approx, masks = case_inputs(name)
    want = jax_refs[name + "/fwd"]
    assert np.array_equal(jax_refs[name + "/kernel_fwd"], want)
    got, _ = port_fwd_grads(x, g, params, approx, masks)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, torch.from_numpy(got).to(BF16).float().numpy())
    assert float(np.mean(got != want)) <= MISMATCH
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp)
    monkeypatch.setattr(tg, "_gelu", jax_kernel_gelu)
    got, _ = port_fwd_grads(x, g, params, approx, masks)
    assert np.array_equal(got, want)
    f32, _ = port_fwd_grads(x, g, params, approx, masks, torch.float32)
    control = torch.from_numpy(f32).to(BF16).float().numpy()
    assert float(np.mean(control != want)) > MISMATCH


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_grads_match_jax(jax_refs, name, monkeypatch):
    """dx and the 10 gradients, float32: each within 2e-2 x max(1, max|JAX|),
    the rounded ones on the bf16 grid. With JAX's erf swapped in, at most
    MISMATCH of the rounded elements differ from JAX's (measured: at most
    0.05%; as shipped, up to 0.8%); the float32 backward, rounded where the
    bf16 one rounds, differs in more."""
    x, g, params, approx, masks = case_inputs(name)
    want = [jax_refs[f"{name}/g{i}"] for i in range(11)]
    _, got = port_fwd_grads(x, g, params, approx, masks)
    assert len(got) == len(want) == len(ROUNDED)
    for i, (a, b, r) in enumerate(zip(got, want, ROUNDED)):
        assert a.dtype == np.float32 and a.shape == b.shape, i
        err = float(np.max(np.abs(a - b)))
        assert err <= REL * max(1.0, float(np.max(np.abs(b)))), (i, err)
        if r:
            assert np.array_equal(a, torch.from_numpy(a).to(BF16).float().numpy()), i
    monkeypatch.setattr(tg, "_gelu", jax_kernel_gelu)
    _, got = port_fwd_grads(x, g, params, approx, masks)
    share = differing_share(got, want)
    assert share <= MISMATCH, share
    _, f32 = port_fwd_grads(x, g, params, approx, masks, torch.float32)
    control = [torch.from_numpy(a).to(BF16).float().numpy() if r else a
               for a, r in zip(f32, ROUNDED)]
    assert differing_share(control, want) > MISMATCH
