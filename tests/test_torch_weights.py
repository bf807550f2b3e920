"""Weights across the packages: every JAX leaf maps onto the port, none is
left over, the round trip is exact, and the port's stacked layout equals the
JAX package's ``_stack_from_blocks`` re-lay (``to_pallas_serving``)."""

import jax
import numpy as np
import pytest
import torch

from m2mixer_tpu.config import loads as jloads
from m2mixer_tpu.models import get_model as jget_model
from m2mixer_tpu.serving import to_pallas_serving
from m2mixer_tpu_torch.config import loads
from m2mixer_tpu_torch.serving import _build_task, to_torch_kernel_serving
from m2mixer_tpu_torch.utils.weights import flatten_tree, from_jax_params, to_jax_params

NARROW = """
train: {seed: 0, optimizer: {lr: 1.0e-3}}
model:
  type: AVMnistMixerMultiLoss
  dropout: 0.0
  modalities:
    classification: {num_classes: 10, classifier: StandardClassifier, input_shape: [16, 8, 32]}
    image: {block_type: IMG, in_channels: 1, hidden_dim: 32, patch_size: 14,
            image_size: [28, 28], token_dim: 16, channel_dim: 64, num_mixers: 2}
    audio: {block_type: IMG, in_channels: 1, hidden_dim: 32, patch_size: 56,
            image_size: [112, 112], token_dim: 16, channel_dim: 64, num_mixers: 2}
    multimodal: {block_type: FUS, fusion_function: ConcatFusion, hidden_dim: 32,
                 token_dim: 16, channel_dim: 64, num_mixers: 2}
"""


def narrow_text(img="MLPMixer", fus="FusionMixer"):
    return NARROW.replace("IMG", img).replace("FUS", fus)


def batch(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(n, 1, 28, 28).astype(np.float32),
            "audio": rng.rand(n, 1, 112, 112).astype(np.float32)}


@pytest.fixture(scope="module")
def jax_modular():
    cfg = jloads(narrow_text())
    task = jget_model(cfg.model.type)(cfg.model, cfg.train.optimizer)
    params = jax.tree.map(np.asarray, task.init_params(jax.random.PRNGKey(1), batch(2)))
    return cfg, params


def port_task(text, **kw):
    return _build_task(loads(text), device="cpu", **kw)


def test_every_jax_leaf_maps_and_none_is_left_over(jax_modular):
    _, params = jax_modular
    task = port_task(narrow_text())
    sd = from_jax_params(params, task.network)
    assert len(sd) == len(flatten_tree(params["params"])) == len(task.network.state_dict())
    task.network.load_state_dict(sd, strict=True)


def test_linear_kernels_transpose_exactly_once(jax_modular):
    _, params = jax_modular
    sd = from_jax_params(params, port_task(narrow_text()).network)
    p = params["params"]
    np.testing.assert_array_equal(sd["encoders.0.patch_embed.proj.weight"].numpy(),
                                  p["encoders_0"]["patch_embed"]["proj"]["linear"]["kernel"].T)
    np.testing.assert_array_equal(sd["fusion_mixer.blocks.1.token_mix.fc2.weight"].numpy(),
                                  p["fusion_mixer"]["block_1"]["token_mix"]["fc2"]["linear"]["kernel"].T)
    np.testing.assert_array_equal(sd["classifier.cls.bias"].numpy(),
                                  p["classifier"]["cls"]["linear"]["bias"])
    np.testing.assert_array_equal(sd["encoders.1.norm_out.weight"].numpy(),
                                  p["encoders_1"]["norm_out"]["LayerNorm_0"]["scale"])


def assert_trees_equal(a, b):
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]), err_msg=str(k))


def test_round_trip_is_exact(jax_modular):
    _, params = jax_modular
    sd = from_jax_params(params, port_task(narrow_text()).network)
    assert_trees_equal(to_jax_params(sd), params)


def test_stacked_layout_equals_jax_stack_from_blocks(jax_modular):
    jcfg, params = jax_modular
    _, jax_stacked = to_pallas_serving(jcfg, params, batch(2))
    jax_stacked = jax.tree.map(np.asarray, jax_stacked)
    plain = port_task(narrow_text())
    plain.network.load_state_dict(from_jax_params(params, plain.network))
    ktask, converted = to_torch_kernel_serving(loads(narrow_text()),
                                               plain.network.state_dict(), device="cpu")
    want = from_jax_params(jax_stacked, ktask.network)
    assert list(converted) == list(want)
    for k in want:
        torch.testing.assert_close(converted[k], want[k], rtol=0, atol=0, msg=k)
    assert_trees_equal(to_jax_params(converted), jax_stacked)


def test_per_block_kernel_tree_maps():
    """The per-block kernel blocks (PallasMLPMixer/PallasFusionMixer) keep
    the JAX kernels' leaf names and layout."""
    text = narrow_text("PallasMLPMixer", "PallasFusionMixer")
    cfg = jloads(text)
    jtask = jget_model(cfg.model.type)(cfg.model, cfg.train.optimizer)
    params = jax.tree.map(np.asarray, jtask.init_params(jax.random.PRNGKey(2), batch(2)))
    sd = from_jax_params(params, port_task(text).network)
    np.testing.assert_array_equal(sd["encoders.0.blocks.1.w3"].numpy(),
                                  params["params"]["encoders_0"]["block_1"]["w3"])
    assert_trees_equal(to_jax_params(sd), params)


@pytest.mark.parametrize("fault", ["leftover", "missing", "shape"])
def test_mismatches_raise_leaf_by_leaf(jax_modular, fault):
    _, params = jax_modular
    tree = jax.tree.map(np.copy, params["params"])
    if fault == "leftover":
        tree["heads_2"] = {"linear": {"kernel": np.zeros((32, 10), np.float32)}}
        match = "heads_2"
    elif fault == "missing":
        del tree["classifier"]
        match = "classifier.cls"
    else:
        lin = tree["heads_0"]["linear"]
        lin["kernel"] = np.zeros((10, 32), np.float32)
        match = "heads_0/linear/kernel"
    with pytest.raises(ValueError, match=match):
        from_jax_params({"params": tree}, port_task(narrow_text()).network)


def test_same_seed_same_weights_on_every_device():
    a = port_task(narrow_text(), seed=3).network.state_dict()
    b = port_task(narrow_text(), seed=3).network.state_dict()
    c = port_task(narrow_text(), seed=4).network.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["heads.0.weight"], c["heads.0.weight"])
