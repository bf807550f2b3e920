"""The port's gMLP family against the JAX package's, on the CPU.

- ``GatingMlpBlock``, ``VisiongMLP`` and ``FusiongMLP`` against their flax
  modules, with the weights carried by ``from_jax_params`` (bare flax
  ``nn.Dense`` layers), and the weight mapping both ways for a plain gMLP
  tree and a flat kernel-block tree;
- the whole slice at the config's widths (``cfg/avmnist/avmnist_gmlp.yml``:
  D = 128, F = 768, N = 49/49/99) with the depth cut to 1/1/1 blocks, at
  batch 2: the JAX task's serve function against the port's, with plain
  modules and with ``PallasVisiongMLP``/``PallasFusiongMLP`` from
  ``to_torch_kernel_serving`` (the same function; the JAX Pallas kernel in
  interpret mode is held to the port's block in
  ``tests/test_torch_gmlp_kernel.py``), and ``serving export --pallas``
  against the plain artifact;
- stochastic depth and the float32-only kernel blocks.

Tolerances are relative to the reference's magnitude, ``TOL x max(1,
max|JAX|)``: the token projection starts at bias 1, so activations grow
with depth and width (float32 math summed in another order).
"""

import contextlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2mixer_tpu.config import load as jload
from m2mixer_tpu.models import get_model as jget_model
from m2mixer_tpu.modules import gmlp as jgm
from m2mixer_tpu.modules import pallas_blocks as jpb
from m2mixer_tpu.modules.common import set_gelu_approximate
from m2mixer_tpu.serving import _serve_fn
from m2mixer_tpu_torch.config import load
from m2mixer_tpu_torch.modules import gmlp as tgm
from m2mixer_tpu_torch.modules import pallas_blocks as tpb
from m2mixer_tpu_torch.modules.common import DepthRNG, set_depth_rng
from m2mixer_tpu_torch.serving import _build_task, load_serving, main, serve_fn, \
    to_torch_kernel_serving
from m2mixer_tpu_torch.utils.weights import (flatten_tree, from_jax_params, to_jax_params,
                                             unflatten_tree)

REPO = Path(__file__).resolve().parents[1]
GMLP_CFG = str(REPO / "cfg" / "avmnist" / "avmnist_gmlp.yml")
TOL = 2e-5


@contextlib.contextmanager
def gelu_flavor(approx):
    prev = set_gelu_approximate(approx)
    try:
        yield
    finally:
        set_gelu_approximate(prev)


def assert_rel_close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * scale, (err, tol * scale)


def jittered(tree, seed):
    """Every LayerNorm scale and bias moved away from 1 and 0, so a swapped
    or misplaced LN leaf shows."""
    rng = np.random.RandomState(seed)
    flat = flatten_tree(jax.tree.map(np.asarray, tree))
    out = {}
    for path, v in flat.items():
        if path[-2:-1] == ("LayerNorm_0",) or path[-1] in ("ln_scale", "ln_bias", "sgu_ln_scale",
                                                           "sgu_ln_bias", "cls_token"):
            v = (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
        out[path] = v
    return unflatten_tree(out)


MODULES = {
    "GatingMlpBlock": (lambda: jgm.GatingMlpBlock(16, 32, 6, 1.0),
                       lambda: tgm.GatingMlpBlock(16, 32, 6, 1.0), (3, 6, 16)),
    "VisiongMLP": (lambda: jgm.VisiongMLP((28, 28), 1, 7, 16, 32, 2),
                   lambda: tgm.VisiongMLP((28, 28), 1, 7, 16, 32, 2), (3, 1, 28, 28)),
    "FusiongMLP": (lambda: jgm.FusiongMLP(16, 32, 2, 8),
                   lambda: tgm.FusiongMLP(16, 32, 2, 8), (3, 8, 16)),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_flax(name):
    """Eval forward and the gradient of the input and of every parameter,
    weights carried by ``from_jax_params`` (LN leaves jittered); erf GELU
    here, the tanh flavor in tests/test_torch_gmlp_kernel.py and
    tests/test_torch_modules.py."""
    jmod_fn, tmod_fn, shape = MODULES[name]
    rng = np.random.RandomState(0)
    x = rng.rand(*shape).astype(np.float32)
    jmod = jmod_fn()
    with gelu_flavor(False):
        variables = {"params": jittered(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"],
                                        2)}
        out = jax.eval_shape(jmod.apply, variables, jnp.asarray(x))
        g = rng.randn(*out.shape).astype(np.float32)

        def fwd_vjp(v, x):
            out, vjp = jax.vjp(jmod.apply, v, x)
            return out, vjp(jnp.asarray(g))

        out, (jgrads, jgx) = jax.jit(fwd_vjp)(variables, jnp.asarray(x))
    tmod = tmod_fn().eval()
    tmod.load_state_dict(from_jax_params(variables, tmod))
    xt = torch.from_numpy(x).requires_grad_()
    tout = tmod(xt)
    assert_rel_close(tout.detach().numpy(), out)
    (tout * torch.from_numpy(g)).sum().backward()
    assert_rel_close(xt.grad.numpy(), jgx)
    want = from_jax_params(jgrads, tmod)
    for n, p in tmod.named_parameters():
        assert_rel_close(p.grad.numpy(), want[n].numpy())


@pytest.mark.parametrize("kind", ["plain", "kernel"])
def test_weights_round_trip_both_ways(kind):
    """``to_jax_params(from_jax_params(tree)) == tree`` for the flax tree of
    a plain ``VisiongMLP`` and of the flat-kernel ``PallasVisiongMLP``."""
    if kind == "plain":
        jmod = jgm.VisiongMLP((28, 28), 1, 7, 16, 32, 2)
        tmod = tgm.VisiongMLP((28, 28), 1, 7, 16, 32, 2)
    else:
        jmod = jpb.PallasVisiongMLP((28, 28), 1, 7, 16, 32, 2)
        tmod = tpb.PallasVisiongMLP((28, 28), 1, 7, 16, 32, 2)
    tree = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(1), jnp.zeros((1, 1, 28, 28)))
                        ["params"])
    back = flatten_tree(to_jax_params(from_jax_params({"params": tree}, tmod))["params"])
    want = flatten_tree(tree)
    assert set(back) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(back[path], leaf)


def test_weights_raise_on_leftover_missing_or_misshaped_leaf():
    jmod, tmod = jgm.GatingMlpBlock(16, 32, 6, 1.0), tgm.GatingMlpBlock(16, 32, 6, 1.0)
    tree = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 6, 16)))
                        ["params"])
    bad = dict(tree, extra={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="leftover"):
        from_jax_params(bad, tmod)
    bad = {k: v for k, v in tree.items() if k != "proj_2"}
    with pytest.raises(ValueError, match="missing"):
        from_jax_params(bad, tmod)
    bad = dict(tree, proj_1={"kernel": np.zeros((32, 16), np.float32),
                             "bias": tree["proj_1"]["bias"]})
    with pytest.raises(ValueError, match="mismatched"):
        from_jax_params(bad, tmod)


def cut_depth(cfg):
    for key in ("image", "audio", "multimodal"):
        cfg.model.modalities[key].n_blocks = 1
    return cfg


def batch(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(n, 1, 28, 28).astype(np.float32),
            "audio": rng.rand(n, 1, 112, 112).astype(np.float32)}


@pytest.fixture(scope="module")
def config_case():
    """The config's widths at depth 1/1/1: seeded port weights (LN leaves
    jittered), carried to the JAX layout, and the JAX task's serve outputs."""
    cfg = cut_depth(load(GMLP_CFG))
    task = _build_task(cfg, device="cpu", seed=3)
    params = {"params": jittered(to_jax_params(task.network.state_dict())["params"], 4)}
    feats = batch(2, seed=5)
    jcfg = cut_depth(jload(GMLP_CFG))
    with gelu_flavor(False):
        jtask = jget_model(jcfg.model.type)(jcfg.model, jcfg.train.optimizer)
        out = _serve_fn(jtask)(params, feats)
    return cfg, params, feats, [np.asarray(out["logits"])] + [np.asarray(b) for b in
                                                               out["branch_logits"]]


def port_outputs(task, feats):
    out = serve_fn(task)({k: torch.from_numpy(v) for k, v in feats.items()})
    return [out["logits"].numpy()] + [b.numpy() for b in out["branch_logits"]]


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_config_widths_match_jax_at_batch_2(config_case, kernel):
    cfg, params, feats, want = config_case
    task = _build_task(cfg, device="cpu")
    task.network.load_state_dict(from_jax_params(params, task.network))
    if kernel:
        task, _ = to_torch_kernel_serving(cfg, task.network.state_dict(), device="cpu")
        assert type(task.network.encoders[0]).__name__ == "PallasVisiongMLP"
        assert type(task.network.fusion_mixer).__name__ == "PallasFusiongMLP"
    got = port_outputs(task, feats)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert_rel_close(a, b)


def test_export_pallas_serves_the_plain_artifacts_logits(config_case, tmp_path):
    """``serving export --pallas`` of the gMLP config rebuilds the kernel
    blocks from the stored config and answers as the plain artifact does."""
    cfg, params, feats, _ = config_case
    weights = tmp_path / "w.npz"
    np.savez(weights, **{"/".join(p): v for p, v in flatten_tree(params["params"]).items()})
    over = [f"model.modalities.{k}.n_blocks=1" for k in ("image", "audio", "multimodal")]
    for name, extra in (("plain", []), ("kernel", ["--pallas"])):
        main(["export", "-c", GMLP_CFG, "-p", str(weights), "-o", str(tmp_path / name),
              "--device", "cpu", *extra, *over])
    meta = json.loads((tmp_path / "kernel" / "serving.json").read_text())
    assert meta["block_flavor"] == "kernel"
    assert meta["config"]["model"]["modalities"]["multimodal"]["block_type"] == "PallasFusiongMLP"
    plain, kern = (load_serving(str(tmp_path / n), device="cpu") for n in ("plain", "kernel"))
    assert type(kern.task.network.encoders[1]).__name__ == "PallasVisiongMLP"
    many = batch(11, seed=6)
    a, b = plain.predict(many), kern.predict(many)
    assert_rel_close(b["logits"], a["logits"])
    for x, y in zip(b["branch_logits"], a["branch_logits"]):
        assert_rel_close(x, y)


class Spy:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **k):
        self.calls += 1
        return self.fn(*a, **k)


def test_dropped_block_is_the_identity_and_launches_nothing(monkeypatch):
    spy = Spy(tpb.fused_gmlp_block)
    monkeypatch.setattr(tpb, "fused_gmlp_block", spy)
    x = torch.randn(2, 6, 16)
    for block in (tpb.PallasGatingMlpBlock(16, 32, 6, survival_prob=0.0),
                  tgm.GatingMlpBlock(16, 32, 6, survival_prob=0.0)):
        set_depth_rng(block, DepthRNG(0))
        block.train()
        assert block(x) is x
        block.eval()
        assert not torch.equal(block(x), x)  # eval runs every block
    assert spy.calls == 1


@pytest.mark.parametrize("prob", [(1.0, 0.0), (1.0, 0.5), (0.9, 0.6)])
def test_survival_follows_linspace(prob):
    jmod = jgm.gMLP(8, 16, 4, 5, prob)
    want = [float(p) for p in np.linspace(*prob, 5)]
    for blocks in (tgm.gMLP(8, 16, 4, 5, prob).blocks,
                   tpb.PallasVisiongMLP((8, 8), 1, 4, 8, 16, 5, prob).gmlp.blocks):
        assert [b.survival_prob for b in blocks] == want
    assert len(want) == jmod.n_blocks


def test_depth_draws_keep_the_survival_share_on_their_own_stream():
    """One Bernoulli(survival) per block per training forward, from the
    task's ``DepthRNG``, which leaves the dropout stream where it was."""
    cfg = cut_depth(load(GMLP_CFG))
    for key in ("image", "audio", "multimodal"):
        cfg.model.modalities[key].update(d_model=8, d_ffn=16, n_blocks=2,
                                         prob_0_L=[1.0, 0.3])
    cfg.model.modalities.multimodal.hidden_dim = 8
    task = _build_task(cfg, device="cpu")
    seeds = task.dropout_rng.host.get_state()
    blocks = [b for b in task.network.modules() if isinstance(b, tgm.GatingMlpBlock)]
    assert {b.depth_rng for b in blocks} == {task.depth_rng}
    ran = []
    for b in blocks:
        b.register_forward_hook(lambda m, i, o: ran.append((m.survival_prob, o is not i[0])))
    task.network.train()
    feats = {k: torch.from_numpy(v) for k, v in batch(2).items()}
    # 300 forwards of tiny tensors: one intra-op thread, since the workers of
    # a parallel test run would otherwise oversubscribe the cores and spin
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for _ in range(300):
            task.network(**task.network_inputs(feats))
    finally:
        torch.set_num_threads(threads)
    kept = [r for p, r in ran if p == pytest.approx(0.3)]
    assert len(kept) == 900 and abs(np.mean(kept) - 0.3) <= 0.05
    assert all(r for p, r in ran if p == 1.0)
    assert torch.equal(task.dropout_rng.host.get_state(), seeds)


def test_bf16_kernel_blocks_raise_on_the_cpu_route():
    cfg = cut_depth(load(GMLP_CFG))
    cfg.model.precision = "bf16"
    for key in ("image", "audio"):
        cfg.model.modalities[key].block_type = "PallasVisiongMLP"
    cfg.model.modalities.multimodal.block_type = "PallasFusiongMLP"
    task = _build_task(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        task.network(**task.network_inputs({k: torch.from_numpy(v) for k, v in batch(1).items()}))
