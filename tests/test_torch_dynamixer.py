"""The port's DynaMixer family against the JAX package's, on the CPU.

- ``DynaMixerOp``, ``DynaMixerBlock``, ``DynaMixer`` and ``FusionDynaMixer``
  against their flax modules, with the weights carried by
  ``from_jax_params`` (every leaf jittered): the eval forward and the
  gradients of the input and of every parameter;
- ``MaxFusion`` and ``ConcatDynaFusion``, with ``get_output_shape``;
- the whole ``AVMnistMixerMultiLoss`` served forward of the DynaMixer topology
  (``cfg/avmnist/avmnist_3loss_dyna.yml``) at narrow width (hidden 32, 4
  heads, 1 block a stack), with ``MaxFusion`` and with ``ConcatDynaFusion``;
- the weights both ways, and ``serving export`` (plain) / ``--pallas``
  (raises: no convertible blocks) of the dyna config.

Tolerances are relative to the JAX side's magnitude, ``TOL x max(1,
max|JAX|)`` per tensor (float32, the same math summed in another order).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2mixer_tpu.config import load as jload
from m2mixer_tpu.models import get_model as jget_model
from m2mixer_tpu.modules import common as jcommon
from m2mixer_tpu.modules import dynamixer as jdm
from m2mixer_tpu.modules import fusion as jfusion
from m2mixer_tpu.serving import _serve_fn
from m2mixer_tpu_torch import modules as tmodules
from m2mixer_tpu_torch.config import load
from m2mixer_tpu_torch.modules import dynamixer as tdm
from m2mixer_tpu_torch.modules import fusion as tfusion
from m2mixer_tpu_torch.serving import _build_task, load_serving, main, serve_fn
from m2mixer_tpu_torch.utils.weights import flatten_tree, from_jax_params, to_jax_params
from test_torch_hygiene import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
DYNA_CFG = str(REPO / "cfg" / "avmnist" / "avmnist_3loss_dyna.yml")
TOL = 2e-5
NARROW = dict(num_mixers=1, hidden_dim=32, num_head=4)
NARROW_OVERRIDES = [f"model.modalities.{k}.{n}={v}" for k in ("image", "audio", "multimodal")
                    for n, v in NARROW.items()]


def assert_rel_close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * scale, (err, tol * scale)


def jittered(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.randn(*np.shape(a))).astype(np.float32), tree)


MODULES = {
    "DynaMixerOp": (lambda: jdm.DynaMixerOp(16, 5, 4, 3), lambda: tdm.DynaMixerOp(16, 5, 4, 3),
                    (3, 5, 16), False),
    "DynaMixerBlock": (lambda: jdm.DynaMixerBlock(16, 5, 4, 2),
                       lambda: tdm.DynaMixerBlock(16, 5, 4, 2), (2, 5, 5, 16), False),
    "DynaMixerBlock-tanh": (lambda: jdm.DynaMixerBlock(16, 5, 4, 2, qkv_bias=True),
                            lambda: tdm.DynaMixerBlock(16, 5, 4, 2, qkv_bias=True,
                                                       approximate_gelu=True), (2, 5, 5, 16),
                            True),
    "DynaMixer": (lambda: jdm.DynaMixer(1, 16, 7, (28, 28), 1, 4),
                  lambda: tdm.DynaMixer(1, 16, 7, (28, 28), 1, 4), (2, 1, 28, 28), False),
    "FusionDynaMixer": (lambda: jdm.FusionDynaMixer(16, 16, 1, 4),
                        lambda: tdm.FusionDynaMixer(16, 16, 1, 4), (2, 4, 4, 16), False),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_flax(name):
    """Eval forward and the gradient of the input and of every parameter."""
    jmod_fn, tmod_fn, shape, approx = MODULES[name]
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    jmod = jmod_fn()
    prev = jcommon.set_gelu_approximate(approx)
    try:
        variables = {"params": jittered(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
                                        ["params"], 1)}
        g = rng.randn(*jax.eval_shape(jmod.apply, variables, jnp.asarray(x)).shape)

        def fwd_vjp(v, x):
            out, vjp = jax.vjp(jmod.apply, v, x)
            return out, vjp(jnp.asarray(g, jnp.float32))

        out, (jgrads, jgx) = jax.jit(fwd_vjp)(variables, jnp.asarray(x))
    finally:
        jcommon.set_gelu_approximate(prev)
    tmod = tmod_fn().eval()
    tmod.load_state_dict(from_jax_params(variables, tmod))
    xt = torch.from_numpy(x).requires_grad_()
    tout = tmod(xt)
    assert_rel_close(tout.detach().numpy(), out)
    (tout * torch.from_numpy(g.astype(np.float32))).sum().backward()
    assert_rel_close(xt.grad.numpy(), jgx)
    want = from_jax_params(jgrads, tmod)
    for n, p in tmod.named_parameters():
        assert_rel_close(p.grad.numpy(), want[n].numpy())


@pytest.mark.parametrize("name", ["MaxFusion", "ConcatDynaFusion"])
def test_fusion_matches_jax_with_its_output_shape(name):
    rng = np.random.RandomState(1)
    a, b = rng.randn(2, 7, 7, 8).astype(np.float32), rng.randn(2, 7, 7, 8).astype(np.float32)
    jf = getattr(jfusion, name)()
    tf = tmodules.get_fusion_by_name(fusion_function=name, dim=1, unknown_key=0)
    assert isinstance(tf, getattr(tfusion, name))
    got = tf(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jf(jnp.asarray(a), jnp.asarray(b))))
    for args, kw in [((49, 49), {"dim": 1}), ((16, 16), {"dim": 2}),
                     (((2, 7, 7, 8), (2, 7, 7, 8)), {})]:
        assert tf.get_output_shape(*args, **kw) == jf.get_output_shape(*args, **kw)
    if name == "MaxFusion":
        with pytest.raises(ValueError, match="equal"):
            tf.get_output_shape(49, 36, dim=1)


def narrow_cfg(cfg, fusion):
    for key in ("image", "audio", "multimodal"):
        cfg.model.modalities[key].update(NARROW)
    cfg.model.modalities.multimodal.fusion_function = fusion
    return cfg


def batch(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(n, 1, 28, 28).astype(np.float32),
            "audio": rng.rand(n, 1, 112, 112).astype(np.float32)}


@pytest.mark.parametrize("fusion", ["MaxFusion", "ConcatDynaFusion"])
def test_served_forward_matches_jax_at_narrow_width(fusion):
    """Seeded port weights (every leaf jittered) carried to the JAX layout;
    the JAX task's serve function against the port's, logits and the two
    branch logits. ConcatDynaFusion makes the fusion grid 14 x 14."""
    cfg = narrow_cfg(load(DYNA_CFG), fusion)
    task = _build_task(cfg, device="cpu", seed=3)
    assert type(task.network.fusion_mixer.blocks[0].mix_h).__name__ == "DynaMixerOp"
    params = {"params": jittered(to_jax_params(task.network.state_dict())["params"], 4)}
    task.network.load_state_dict(from_jax_params(params, task.network))
    jcfg = narrow_cfg(jload(DYNA_CFG), fusion)
    jtask = jget_model(jcfg.model.type)(jcfg.model, jcfg.train.optimizer)
    feats = batch(2, seed=5)
    want = _serve_fn(jtask)(params, feats)
    got = serve_fn(task)({k: torch.from_numpy(v) for k, v in feats.items()})
    assert_rel_close(got["logits"].numpy(), want["logits"])
    assert len(got["branch_logits"]) == len(want["branch_logits"]) == 2
    for a, b in zip(got["branch_logits"], want["branch_logits"]):
        assert_rel_close(a.numpy(), b)


def test_weights_round_trip_and_raise():
    """``to_jax_params(from_jax_params(tree)) == tree`` for a flax
    ``DynaMixer`` (``mlp_c`` without bias, the unnamed ``Dropout_0`` without
    leaves); a leftover, missing or misshaped leaf raises."""
    jmod, tmod = jdm.DynaMixer(1, 16, 7, (28, 28), 2, 4), tdm.DynaMixer(1, 16, 7, (28, 28), 2, 4)
    tree = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(1), jnp.zeros((1, 1, 28, 28)))
                        ["params"])
    assert "bias" not in tree["block_0"]["mlp_c"]["linear"]
    back = flatten_tree(to_jax_params(from_jax_params({"params": tree}, tmod))["params"])
    want = flatten_tree(tree)
    assert set(back) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(back[path], leaf)
    bad = dict(tree, extra={"linear": {"kernel": np.zeros((2, 2), np.float32)}})
    with pytest.raises(ValueError, match="leftover"):
        from_jax_params(bad, tmod)
    bad = {k: v for k, v in tree.items() if k != "block_1"}
    with pytest.raises(ValueError, match="missing"):
        from_jax_params(bad, tmod)
    gen = dict(tree["block_0"]["mix_h"]["generate"]["linear"])
    gen["kernel"] = gen["kernel"].T
    bad = {**tree, "block_0": {**tree["block_0"], "mix_h": {**tree["block_0"]["mix_h"],
                                                           "generate": {"linear": gen}}}}
    with pytest.raises(ValueError, match="mismatched"):
        from_jax_params(bad, tmod)


def test_serving_export_predicts_and_pallas_export_raises(tmp_path):
    """``serving export`` of the dyna config (depth and width cut) rebuilds
    the same network: ``load_serving`` answers as the task does; ``--pallas``
    has nothing to swap (DynaMixerOp runs through its kernel by itself)."""
    out = tmp_path / "plain"
    main(["export", "-c", DYNA_CFG, "-o", str(out), "--device", "cpu", *NARROW_OVERRIDES])
    meta = json.loads((out / "serving.json").read_text())
    assert meta["config"]["model"]["modalities"]["image"]["block_type"] == "DynaMixer"
    served = load_serving(str(out), device="cpu")
    feats = batch(9, seed=2)
    got = served.predict(feats)
    want = serve_fn(served.task)({k: torch.from_numpy(v) for k, v in feats.items()})
    assert got["logits"].shape == (9, 10)
    np.testing.assert_allclose(got["logits"], want["logits"].numpy(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="no convertible blocks"):
        main(["export", "-c", DYNA_CFG, "-o", str(tmp_path / "k"), "--device", "cpu",
              "--pallas", *NARROW_OVERRIDES])


def test_bf16_raises_on_the_cpu_route():
    """At model.precision=bf16 the CPU route raises nothing: every
    DynaMixerOp runs the bf16 plain version of the fused op, and the served
    logits of the narrowed config agree with the JAX task's bf16 ones (flax's
    einsums) within 2e-2 of their largest magnitude (measured 0.9%; the two
    round at different places, ``tests/test_torch_dynamixer_bf16.py``)."""
    cfg = narrow_cfg(load(DYNA_CFG), "MaxFusion")
    cfg.model.precision = "bf16"
    task = _build_task(cfg, device="cpu", seed=3)
    assert task.network.encoders[0].blocks[0].mix_h.compute_dtype == torch.bfloat16
    params = to_jax_params(task.network.state_dict())
    jcfg = narrow_cfg(jload(DYNA_CFG), "MaxFusion")
    jcfg.model.precision = "bf16"
    jtask = jget_model(jcfg.model.type)(jcfg.model, jcfg.train.optimizer)
    feats = batch(2, seed=5)
    want = np.asarray(_serve_fn(jtask)(params, feats)["logits"], np.float32)
    got = serve_fn(task)({k: torch.from_numpy(v) for k, v in feats.items()})["logits"]
    got = got.float().numpy()
    assert np.isfinite(got).all() and got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 2e-2 * np.max(np.abs(want))
