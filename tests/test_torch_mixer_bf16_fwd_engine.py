"""The bf16 K1f/K2f products' arithmetic against JAX's bf16 ``_block_math``.

On the card the bf16 mixer forward runs its products on the wgmma engine
(``csrc/wgmma_bf16.cuh``): the channel FF's up and down products always, and
above 32 tokens the token FF's two as well (the token pipeline,
``csrc/token_ff.cuh``; at most 32 tokens the token FF runs in registers with
float32 sums). Each has bf16 operands and float32 sums, where a float32
product of the same values would differ in one way: each 64-deep stage's
products are summed apart (``wgmma`` into zeroed registers) and added to a
float32 accumulator, and the down product's slices of C (``wg_slices``, the
plan of ``tests/test_torch_mixer_fwd_plan.py``'s mirror) are added in slice
order by the finish. Here that arithmetic is modelled in plain PyTorch
(``engine_mm`` in ``model_block``: the plain bf16 block with its products
summed the way the card sums them, every cast where ``_block_math`` casts)
and held to JAX's ``_block_math`` at ``compute_dtype=bfloat16`` (XLA keeping
no excess precision, in one subprocess) at N = 8 (the B config's fused
tokens) and 16 (the L image mixer's; both the register route's token FF) and
at N = 33 and 80 (the token pipeline; 33 pads the token rows to 40), narrow
D and C, dropout 0 and 0.5: at most ``MISMATCH`` (1%) of the rounded outputs
differ. The control, float32 math with only the output rounded to bf16,
differs in more than that: the check sees the inner casts.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from m2mixer_tpu_torch.ops import mixer_kernel as mk
from test_torch_mixer_bf16_grad import MISMATCH
from test_torch_mixer_bf16_split import engine_mm, rd
from test_torch_mixer_fwd_plan import down_slices

BF = torch.bfloat16
B = 6
REG_TOKENS = 32  # at most this many tokens the card runs the token FF in registers
# name -> (N, D, T, C): C = 150 pads h2's rows to 152
GEOMS = {"b_n8": (8, 16, 8, 150), "n16": (16, 16, 24, 64), "n33": (33, 16, 16, 64),
         "n80": (80, 16, 32, 96)}
RATES = (0.0, 0.5)
CASES = [(g, r) for g in sorted(GEOMS) for r in RATES]


def model_block(x, p, masks, approx, kslice):
    """mk._block_math in bf16 with every product summed as the card sums it:
    on the engine one slice of the depth for the up product and, above 32
    tokens, the token products (at most 32: float32 sums), slices of kslice
    for the down product (its partials added in slice order, then b4, as the
    finish adds them)."""
    Bx, N, D = x.shape

    def mm(a, w, ks=None):
        a, w = rd(a.float()), rd(w.float())
        return engine_mm([a], [w], ks or a.shape[1])

    def mm_token(a, w):
        return mm(a, w) if N > REG_TOKENS else torch.matmul(rd(a.float()), rd(w.float()))

    x2 = x.to(BF).reshape(Bx * N, D)
    y = mk._layer_norm(x2, p.ln1_scale.to(BF), p.ln1_bias.to(BF))
    y_t = y.reshape(Bx, N, D).transpose(1, 2).reshape(Bx * D, N)
    h = mk._gelu(mm_token(y_t, p.w1) + p.b1, approx)
    t = mm_token(h * masks[0] if masks else h, p.w2) + p.b2
    t = t * masks[1] if masks else t
    x1 = x2 + t.reshape(Bx, D, N).transpose(1, 2).reshape(Bx * N, D).to(BF)
    z = mk._layer_norm(x1, p.ln2_scale.to(BF), p.ln2_bias.to(BF))
    h2 = mk._gelu(mm(z, p.w3) + p.b3, approx)
    c = mm(h2 * masks[2] if masks else h2, p.w4, kslice) + p.b4
    c = c * masks[3] if masks else c
    return (x1 + c.to(BF)).float().reshape(Bx, N, D)


def make_case(name, rate, seed=11):
    N, D, T, C = GEOMS[name]
    rng = np.random.RandomState(seed + N)
    u = lambda fan, *shape: rng.uniform(-1, 1, shape) / np.sqrt(fan)  # noqa: E731
    ln = lambda: [1 + 0.1 * rng.randn(D), 0.1 * rng.randn(D)]  # noqa: E731
    flat = [*ln(), u(N, N, T), u(N, T), u(T, T, N), u(T, N), *ln(), u(D, D, C), u(D, C),
            u(C, C, D), u(C, D)]
    x = (3 * rng.randn(B, N, D)).astype(np.float32)
    masks = mk.block_masks(5, 0, B, N, D, T, C, rate)
    return x, [a.astype(np.float32) for a in flat], masks and [m.numpy() for m in masks]


_JAX = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")
from m2mixer_tpu.modules.common import set_gelu_approximate
from m2mixer_tpu.ops import mixer_kernel as jk
set_gelu_approximate(True)
z = dict(np.load(sys.argv[1]))
out = {}
for case in z["cases"]:
    flat = tuple(jnp.asarray(z[f"{case}/p{i}"]) for i in range(12))
    masks = tuple(jnp.asarray(z[f"{case}/m{i}"]) for i in range(4)) if f"{case}/m0" in z \\
        else None
    p = jk.MixerBlockParams(*jk._cast_params(flat, jnp.bfloat16))
    f = jax.jit(lambda x, p: jk._block_math(x, p, masks, jnp.bfloat16))
    out[case] = np.asarray(f(jnp.asarray(z[f"{case}/x"]), p))
np.savez(sys.argv[2], **out)
"""


def tag(name, rate):
    return f"{name}@{rate}"


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    """Every case's JAX output (one subprocess, XLA's excess precision off, as
    tests/test_torch_mixer_bf16_grad.py runs it)."""
    tmp = tmp_path_factory.mktemp("bf16_fwd_engine")
    arrays = {"cases": np.array([tag(*c) for c in CASES])}
    for name, rate in CASES:
        x, flat, masks = make_case(name, rate)
        arrays[f"{tag(name, rate)}/x"] = x
        arrays.update({f"{tag(name, rate)}/p{i}": a for i, a in enumerate(flat)})
        if masks:
            arrays.update({f"{tag(name, rate)}/m{i}": m for i, m in enumerate(masks)})
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false", JAX_PLATFORMS="cpu")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", _JAX, str(tmp / "in.npz"), str(tmp / "out.npz")],
                   check=True, env=env, cwd=repo, timeout=300)
    with np.load(tmp / "out.npz") as z:
        return {k: z[k] for k in z.files}


def share_differing(got, want):
    return float(np.mean(got != want))


@pytest.mark.parametrize("name,rate", CASES)
def test_engine_forward_matches_jax(jax_out, name, rate):
    """The engine's sums inside the bf16 block: on the bf16 grid, within 2e-2
    of JAX's max magnitude, at most MISMATCH of the outputs differing."""
    x, flat, masks = make_case(name, rate)
    N, D, _, C = GEOMS[name]
    kslice, _ = down_slices(B, N, D, C, True)
    p = mk.MixerBlockParams(*map(torch.from_numpy, flat))
    got = model_block(torch.from_numpy(x), p, masks and [torch.from_numpy(m) for m in masks],
                      True, kslice).numpy()
    want = jax_out[tag(name, rate)]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.array_equal(got, rd(torch.from_numpy(got)).numpy())
    assert np.max(np.abs(got - want)) <= 2e-2 * np.max(np.abs(want))
    share = share_differing(got, want)
    assert share <= MISMATCH, share


@pytest.mark.parametrize("name,rate", CASES)
def test_float32_math_is_not_enough(jax_out, name, rate):
    """The control: the plain block in float32 with only its output rounded
    to bf16 differs from JAX's bf16 block in more than MISMATCH of the
    outputs."""
    x, flat, masks = make_case(name, rate)
    p = mk.MixerBlockParams(*map(torch.from_numpy, flat))
    f32 = mk._block_math(torch.from_numpy(x), p, torch.float32, True,
                         masks and [torch.from_numpy(m) for m in masks])
    share = share_differing(rd(f32).numpy(), jax_out[tag(name, rate)])
    assert share > MISMATCH, share
