"""The port's plain modules against the JAX package's flax modules.

Weights come from a flax init and reach the port through
``utils.weights.from_jax_params``; inputs come from numpy. float32 holds
to 2e-5 absolute (same math, different summation order). In bf16 the two
frameworks round at different points (flax rounds each Dense output and
bias add, torch fuses the bias into the GEMM), so bf16 holds to 3e-2 of the
output's max magnitude.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2mixer_tpu.modules import common as jcommon
from m2mixer_tpu.modules import classification as jcls
from m2mixer_tpu.modules import fusion as jfusion
from m2mixer_tpu.modules import mixer as jmixer
from m2mixer_tpu_torch import modules as tmodules
from m2mixer_tpu_torch.config import DictConfig
from m2mixer_tpu_torch.modules import common as tcommon
from m2mixer_tpu_torch.modules import classification as tcls
from m2mixer_tpu_torch.modules import fusion as tfusion
from m2mixer_tpu_torch.modules import mixer as tmixer
from m2mixer_tpu_torch.utils.weights import from_jax_params

F32_ATOL = 2e-5
BF16_REL = 3e-2


@contextlib.contextmanager
def jax_gelu(approximate: bool):
    prev = jcommon.set_gelu_approximate(approximate)
    try:
        yield
    finally:
        jcommon.set_gelu_approximate(prev)


def compare(jmod, tmod, x, bf16=False, approx=False, seed=0):
    """Init ``jmod`` with flax, jitter every leaf (so LN affine params are
    not the identity), carry the weights into ``tmod``, run both on x."""
    rng = np.random.RandomState(seed)
    with jax_gelu(approx):
        variables = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x))
        variables = jax.tree.map(
            lambda a: (np.asarray(a) + 0.1 * rng.randn(*np.shape(a))).astype(np.float32),
            variables)
        want = np.asarray(jmod.apply(variables, jnp.asarray(x)), np.float32)
    tmod.load_state_dict(from_jax_params(variables, tmod))
    with torch.no_grad():
        got = tmod.eval()(torch.from_numpy(np.asarray(x))).float().numpy()
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    bound = BF16_REL * float(np.max(np.abs(want))) if bf16 else F32_ATOL
    assert err <= bound, (err, bound)


def rnd(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_linear(bf16):
    dt = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    compare(jcommon.Linear(12, 7, dtype=dt[0]), tcommon.Linear(12, 7, dtype=dt[1]),
            rnd(3, 5, 12), bf16)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_layer_norm(bf16):
    dt = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    compare(jcommon.LayerNorm(dtype=dt[0]), tcommon.LayerNorm(16, dtype=dt[1]),
            rnd(4, 3, 16) * 3 + 1, bf16)


def test_patch_embed_flattening_order():
    compare(jcommon.PatchEmbed(2, 16, 4), tcommon.PatchEmbed(2, 16, 4), rnd(2, 2, 8, 12))


def test_patch_embed_keep_grid():
    compare(jcommon.PatchEmbed(1, 8, 7, keep_grid=True),
            tcommon.PatchEmbed(1, 8, 7, keep_grid=True), rnd(3, 1, 28, 28))


@pytest.mark.parametrize("approx", [False, True], ids=["erf", "tanh"])
def test_feed_forward(approx):
    compare(jmixer.FeedForward(8, 24), tmixer.FeedForward(8, 24, approximate_gelu=approx),
            rnd(2, 5, 8), approx=approx)


@pytest.mark.parametrize("approx", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_mixer_block(bf16, approx):
    dt = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    compare(jmixer.MixerBlock(32, 4, 16, 64, dtype=dt[0]),
            tmixer.MixerBlock(32, 4, 16, 64, dtype=dt[1], approximate_gelu=approx),
            rnd(6, 4, 32), bf16, approx)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_mlp_mixer(bf16):
    dt = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    kw = dict(in_channels=1, hidden_dim=32, patch_size=14, image_size=(28, 28),
              num_mixers=2, token_dim=16, channel_dim=64)
    compare(jmixer.MLPMixer(**kw, dtype=dt[0]), tmixer.MLPMixer(**kw, dtype=dt[1]),
            rnd(3, 1, 28, 28), bf16)


def test_fusion_mixer():
    kw = dict(hidden_dim=32, num_patches=8, num_mixers=2, token_dim=16, channel_dim=64)
    compare(jmixer.FusionMixer(**kw), tmixer.FusionMixer(**kw), rnd(3, 8, 32))


def test_standard_classifier():
    compare(jcls.StandardClassifier(input_shape=(16, 8, 32), num_classes=10),
            tcls.StandardClassifier(input_shape=(16, 8, 32), num_classes=10), rnd(5, 8, 32))


def test_concat_fusion_matches_jax():
    a, b = rnd(2, 4, 16, seed=1), rnd(2, 4, 16, seed=2)
    want = np.asarray(jfusion.ConcatFusion()(jnp.asarray(a), jnp.asarray(b)))
    got = tfusion.ConcatFusion()(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 8, 16)


@pytest.mark.parametrize("args,kw", [((4, 4), {"dim": 1}), ((4, 4), {"dim": 2}),
                                     (((2, 4, 16), (2, 4, 16)), {})])
def test_concat_fusion_output_shape(args, kw):
    assert (tfusion.ConcatFusion().get_output_shape(*args, **kw)
            == jfusion.ConcatFusion().get_output_shape(*args, **kw))


def test_registries_accept_extras_and_reject_unported():
    blk = tmodules.get_block_by_name(block_type="FusionMixer", hidden_dim=8, num_patches=4,
                                     num_mixers=1, token_dim=4, channel_dim=16,
                                     fusion_function="ConcatFusion", unknown_key=3)
    assert blk.num_patch == 4
    assert isinstance(tmodules.get_fusion_by_name(fusion_function="ConcatFusion", dim=1),
                      tfusion.ConcatFusion)
    for getter, key, name in [(tmodules.get_block_by_name, "block_type", "MLPMixerNoPatching"),
                              (tmodules.get_fusion_by_name, "fusion_function", "SumFusion"),
                              (tmodules.get_classifier_by_name, "classifier", "MLPClassifier")]:
        with pytest.raises(NotImplementedError, match=f"not yet ported: {name}"):
            getter(**{key: name})


def test_dropout_is_identity_in_eval_and_unported_in_training():
    """Identity in eval mode; in training (ported with the training slice)
    each element is either dropped or scaled by 1 / (1 - rate)."""
    d = tcommon.Dropout(0.5).eval()
    x = torch.randn(3, 4)
    assert torch.equal(d(x), x)
    y = d.train()(x)
    assert torch.all((y == 0) | torch.isclose(y, 2 * x))


def test_multimodal_net_sizes_fusion_and_mutes():
    from m2mixer_tpu_torch.models.nets import build_multimodal_net

    cfg = DictConfig({"dropout": 0.0, "modalities": {
        "classification": {"num_classes": 3},
        "image": {"block_type": "MLPMixer", "in_channels": 1, "hidden_dim": 8,
                  "patch_size": 14, "image_size": [28, 28], "token_dim": 4,
                  "channel_dim": 16, "num_mixers": 1},
        "audio": {"block_type": "MLPMixer", "in_channels": 1, "hidden_dim": 8,
                  "patch_size": 28, "image_size": [56, 56], "token_dim": 4,
                  "channel_dim": 16, "num_mixers": 1},
        "multimodal": {"block_type": "FusionMixer", "fusion_function": "ConcatFusion",
                       "hidden_dim": 8, "token_dim": 4, "channel_dim": 16, "num_mixers": 1}}})
    net = build_multimodal_net(cfg, ("image", "audio"),
                               generator=torch.Generator().manual_seed(0)).eval()
    assert net.fusion_mixer.num_patch == 8
    img, aud = torch.randn(2, 1, 28, 28), torch.randn(2, 1, 56, 56)
    with torch.no_grad():
        muted = net((img, aud), mute_code=0)
        zeroed = net((torch.zeros_like(img), aud))
    torch.testing.assert_close(muted["logits"], zeroed["logits"], rtol=0, atol=0)
    cfg.paired_encoders = True  # same block geometry and patch count: one paired chain
    paired = build_multimodal_net(cfg, ("image", "audio"),
                                  generator=torch.Generator().manual_seed(0)).eval()
    assert paired.paired_encoder is not None and len(paired.encoders) == 0
    assert paired.fusion_mixer.num_patch == 8
    with torch.no_grad():
        muted = paired((img, aud), mute_code=0)
        zeroed = paired((torch.zeros_like(img), aud))
    torch.testing.assert_close(muted["logits"], zeroed["logits"], rtol=0, atol=0)
