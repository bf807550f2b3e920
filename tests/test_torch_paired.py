"""The port's paired encoders (``model.paired_encoders``) against the JAX package.

``PairedMLPMixer`` against ``m2mixer_tpu/modules/paired.py``'s with the
weights carried by ``from_jax_params``: float32 within 1e-5 absolute (the
same math, other summation order), bf16 within 2e-2 of the output's max
magnitude (both run their LayerNorm statistics and residual stream in bf16,
but XLA may keep excess precision inside its fusions and torch's CPU GELU
rounds once where ``jax.nn.gelu`` rounds per operation). Then
``pair_mlp_mixer_params`` against JAX's, the weight round trip, the freeze
prefixes, and ``serving export --pallas`` of a paired model (un-paired into
per-modality kernel stacks) against its plain network.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2mixer_tpu.config import loads as jloads
from m2mixer_tpu.models import get_model as jget_model
from m2mixer_tpu.modules.common import set_gelu_approximate
from m2mixer_tpu.modules.mixer import MLPMixer as JMLPMixer
from m2mixer_tpu.modules.paired import PairedMLPMixer as JPaired
from m2mixer_tpu.modules.paired import pair_mlp_mixer_params as j_pair
from m2mixer_tpu_torch.config import loads
from m2mixer_tpu_torch.models import get_model
from m2mixer_tpu_torch.modules.paired import (PairedMLPMixer, can_pair, pair_mlp_mixer_params,
                                              unpair_mlp_mixer_params)
from m2mixer_tpu_torch.serving import load_serving, main
from m2mixer_tpu_torch.utils.weights import (_port_name, flatten_tree, from_jax_params,
                                             to_jax_params)

GEOM = dict(hidden_dim=16, num_mixers=2, token_dim=8, channel_dim=32)
CFG = """
train: {seed: 0, optimizer: {lr: 1.0e-3}}
model:
  type: AVMnistMixerMultiLoss
  dropout: 0.0
  paired_encoders: true
  approximate_gelu: true
  modalities:
    classification: {num_classes: 10, classifier: StandardClassifier, input_shape: [16]}
    image: {block_type: MLPMixer, in_channels: 1, hidden_dim: 16, patch_size: 14,
            image_size: [28, 28], token_dim: 8, channel_dim: 32, num_mixers: 2}
    audio: {block_type: MLPMixer, in_channels: 1, hidden_dim: 16, patch_size: 56,
            image_size: [112, 112], token_dim: 8, channel_dim: 32, num_mixers: 2}
    multimodal: {block_type: FusionMixer, fusion_function: ConcatFusion, hidden_dim: 16,
                 token_dim: 8, channel_dim: 38, num_mixers: 1}
"""


def inputs(n=3, seed=0):
    rng = np.random.RandomState(seed)
    return rng.rand(n, 1, 28, 28).astype(np.float32), rng.rand(n, 1, 112, 112).astype(np.float32)


def jitter(tree, seed):
    """The tree with every leaf moved off its init (LN scales away from 1,
    biases away from 0), so each leaf's place matters."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.randn(*np.shape(a)).astype(np.float32),
                        tree)


def jax_paired(dtype):
    return JPaired(in_channels=(1, 1), patch_sizes=(14, 56), image_sizes=((28, 28), (112, 112)),
                   dtype=dtype, **GEOM)


@pytest.mark.parametrize("gelu", ["erf", "tanh"])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_paired_mixer_matches_jax(precision, gelu):
    approx = gelu == "tanh"
    jdt, tdt = (None, None) if precision == "f32" else (jnp.bfloat16, torch.bfloat16)
    x0, x1 = inputs()
    jm = jax_paired(jdt)
    params = jitter(jm.init(jax.random.PRNGKey(0), x0, x1), 1)
    prev = set_gelu_approximate(approx)
    try:
        want = [np.asarray(t, np.float32) for t in jm.apply(params, x0, x1)]
    finally:
        set_gelu_approximate(prev)
    tm = PairedMLPMixer((1, 1), patch_sizes=(14, 56), image_sizes=((28, 28), (112, 112)),
                        dtype=tdt, approximate_gelu=approx, **GEOM).eval()
    tm.load_state_dict(from_jax_params(params, tm))
    with torch.no_grad():
        got = [t.float().numpy() for t in tm(torch.from_numpy(x0), torch.from_numpy(x1))]
    for a, b in zip(got, want):
        assert a.shape == b.shape == (3, 4, 16)
        err = float(np.max(np.abs(a - b)))
        tol = 1e-5 if precision == "f32" else 2e-2 * float(np.max(np.abs(b)))
        assert err <= tol, err


def test_pair_params_match_jax_and_unpair_inverts_them():
    """Two modular MLPMixer trees -> the paired tree, leaf for leaf as JAX's
    ``pair_mlp_mixer_params``; ``unpair_mlp_mixer_params`` gives them back."""
    x0, x1 = inputs()
    trees = []
    for seed, (x, p) in enumerate(((x0, 14), (x1, 56))):
        m = JMLPMixer(in_channels=1, patch_size=p, image_size=x.shape[2:], **GEOM)
        trees.append(jitter(m.init(jax.random.PRNGKey(seed), x)["params"], seed))
    want = flatten_tree(jax.tree.map(np.asarray, j_pair(*trees)))
    got = flatten_tree(pair_mlp_mixer_params(*trees))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg="/".join(k))
    for tree, back in zip(trees, unpair_mlp_mixer_params(pair_mlp_mixer_params(*trees))):
        a, b = flatten_tree(tree), flatten_tree(back)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), b[k], err_msg="/".join(k))


@pytest.fixture(scope="module")
def jax_task():
    jc = jloads(CFG)
    jtask = jget_model(jc.model.type)(jc.model, jc.train.optimizer)
    x0, x1 = inputs(2)
    params = jtask.init_params(jax.random.PRNGKey(0), {"image": x0, "audio": x1,
                                                       "label": np.zeros(2, np.int32)})
    return jtask, jax.tree.map(np.asarray, params)


def port_task(device="cpu"):
    c = loads(CFG)
    return get_model(c.model.type)(c.model, c.train.optimizer, device=device), c


def test_paired_weights_round_trip_exactly(jax_task):
    """The JAX task's tree (``paired_encoder`` with its stacked leaves, no
    ``encoders_i``) maps onto the port's network leaf for leaf, no transpose
    of the stacked leaves, and back bit for bit; a mis-shaped leaf raises."""
    _, params = jax_task
    task, _ = port_task()
    assert task.network.paired_encoder is not None and len(task.network.encoders) == 0
    state = from_jax_params(params, task.network)
    jflat = flatten_tree(params["params"])
    np.testing.assert_array_equal(
        state["paired_encoder.channel_fc1_kernel"].numpy(),
        jflat[("paired_encoder", "channel_fc1_kernel")])
    back = flatten_tree(to_jax_params(state)["params"])
    assert set(back) == set(jflat)
    for k, v in jflat.items():
        np.testing.assert_array_equal(back[k], v, err_msg="/".join(k))
    bad = jax.tree.map(lambda a: a, params)
    bad["params"]["paired_encoder"]["norm_token_scale"] = np.ones((2, 16), np.float32)
    with pytest.raises(ValueError, match="mismatched"):
        from_jax_params(bad, task.network)


def test_freeze_prefixes_match_jax(jax_task):
    """Paired: the ``paired_encoder`` subtree first, then the heads; the
    frozen parameters are those JAX's ``frozen_mask`` zeroes."""
    jtask, params = jax_task
    task, _ = port_task()
    assert task.frozen_param_prefixes() == ("paired_encoder.", "heads.0.", "heads.1.")
    assert jtask.frozen_param_prefixes() == ("paired_encoder", "heads_0", "heads_1")
    mask = flatten_tree(jtask.frozen_mask(params)["params"])
    want = {_port_name(k)[0] for k, v in mask.items() if float(np.max(v)) == 0.0}
    assert any(n.startswith("paired_encoder.") for n in want)
    assert set(task.frozen_param_names()) == want


@pytest.mark.parametrize("per_block", [False, True], ids=["stacked", "per_block"])
def test_export_pallas_unpairs_and_answers_as_the_plain_network(tmp_path, per_block):
    """``serving export --pallas`` of a paired model: per-modality kernel
    stacks (``PallasStackedMLPMixer``), or per-block kernels, with the
    paired weights split by modality; the same answers as the paired
    network in float32 (the kernels' plain versions on the CPU)."""
    from m2mixer_tpu_torch.serving import export_serving, to_torch_kernel_serving

    task, cfg = port_task()
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in task.network.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text(CFG)
    weights = tmp_path / "w.npz"
    np.savez(weights, **{k: v.numpy() for k, v in task.network.state_dict().items()})
    if per_block:
        kernel, _ = to_torch_kernel_serving(cfg, task.network.state_dict(), device="cpu",
                                            per_block=True)
        export_serving(kernel, cfg, str(tmp_path / "art"))
    else:
        main(["export", "-c", str(cfg_path), "-p", str(weights), "-o", str(tmp_path / "art"),
              "--pallas", "--device", "cpu"])
    served = load_serving(str(tmp_path / "art"), device="cpu")
    kinds = {type(m).__name__ for m in served.task.network.modules()}
    assert ("PallasMLPMixer" if per_block else "PallasStackedMLPMixer") in kinds
    assert "PairedMLPMixer" not in kinds
    assert served.meta["config"]["model"]["paired_encoders"] is False
    x0, x1 = inputs(5, seed=4)
    out = served.predict({"image": x0, "audio": x1})
    with torch.no_grad():
        want = task.network(inputs=(torch.from_numpy(x0), torch.from_numpy(x1)))
    np.testing.assert_allclose(out["logits"], want["logits"].numpy(), rtol=0, atol=1e-5)
    for a, b in zip(out["branch_logits"], want["branch_logits"]):
        np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=1e-5)


def test_can_pair_matches_jax():
    from m2mixer_tpu.modules.paired import can_pair as j_can_pair

    c = loads(CFG).model.modalities
    jc = jloads(CFG).model.modalities
    assert can_pair(c.image, c.audio) and j_can_pair(jc.image, jc.audio)
    for key, value in (("block_type", "PallasStackedMLPMixer"), ("channel_dim", 64),
                       ("patch_size", 7)):
        a, ja = dict(c.audio), dict(jc.audio)
        a[key] = ja[key] = value
        assert can_pair(c.image, a) == j_can_pair(jc.image, type(jc.audio)(ja)) is False
