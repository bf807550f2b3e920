"""The bf16 K1b/K2b channel products' arithmetic against JAX's bf16 gradients.

On the card the bf16 mixer backward runs its channel FF's five products on
the wgmma engine (``csrc/wgmma_bf16.cuh``), with three departures from a
float32 product of the same values:
- da4 = bf16(g) m3 enters as bf16(g) times m3's keep bit, and the dropout
  scale 1/(1-p) multiplies the float32 sums (dh2, dW4, db4);
- da3, a float32 value, enters as three bf16 planes, hi = bf16(x), mid =
  bf16(x - hi), lo = bf16(x - hi - mid), each a pass of its own (dz, dW3),
  smallest first;
- each 64-deep stage's products are summed apart and added to the float32
  accumulator, slices of the depth summed in slice order.
Here that arithmetic is modelled in plain PyTorch (``engine_mm``) inside the
block's backward (``ChannelEngine``: the channel FF of the plain bf16 block,
every other part autograd of the plain version, cast for cast), and the
model's gradients are held to JAX's VJP of ``_block_math`` in bf16 at a
narrowed shape with dropout 0.5, as ``tests/test_torch_mixer_bf16_grad.py``
holds the plain version: every tensor within 2e-2 x max(1, max|JAX|), and at
most that file's ``MISMATCH`` (1%) of the rounded gradients' elements
differing. The same model with da3 as one bf16 term (no split) differs in
more than that: the split is what keeps the float32 cotangent.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from m2mixer_tpu_torch.ops import mixer_kernel as mk
from test_torch_mixer_bf16_grad import MISMATCH, REL, ROUNDED
from test_torch_hygiene import one_torch_thread  # noqa: F401  (autouse)

BF = torch.bfloat16
RATE = 0.5
GEOM = dict(B=16, N=8, D=16, T=8, C=150)  # R = 128 rows: two stages of the weight gradients
STAGE = 64  # kWgBK: the depth of one stage
KSLICE, WSLICE = 64, 64  # slices of C (dz) and of the rows (dW3, dW4): two or more of each


def rd(t):
    return t.to(BF).float()


def split(x, terms):
    """x as `terms` bf16 planes, largest first."""
    out, rest = [], x
    for _ in range(terms):
        out.append(rd(rest))
        rest = rest - out[-1]
    return out


def engine_mm(a_planes, b_planes, kslice):
    """sum over the planes of A_t B_t (float32 tensors holding bf16 values)
    as the engine sums it: per slice of kslice, per 64-deep stage the planes'
    products smallest first, added to a float32 accumulator; the slices
    added in slice order."""
    terms = max(len(a_planes), len(b_planes))
    a_of = lambda t: a_planes[t if len(a_planes) > 1 else 0]  # noqa: E731
    b_of = lambda t: b_planes[t if len(b_planes) > 1 else 0]  # noqa: E731
    K = a_planes[0].shape[1]
    total = torch.zeros(a_planes[0].shape[0], b_planes[0].shape[1])
    for s0 in range(0, K, kslice):
        acc = torch.zeros_like(total)
        for k0 in range(s0, min(K, s0 + kslice), STAGE):
            k1 = min(K, k0 + STAGE, s0 + kslice)
            tmp = torch.zeros_like(total)
            for t in reversed(range(terms)):
                tmp = tmp + a_of(t)[:, k0:k1] @ b_of(t)[k0:k1]
            acc = acc + tmp
        total = total + acc
    return total


def gelu_and_grad(a, approx):
    with torch.enable_grad():
        aa = a.detach().requires_grad_()
        out = mk._gelu(aa, approx)
        (grad,) = torch.autograd.grad(out.sum(), aa)
    return out.detach(), grad


class ChannelEngine(torch.autograd.Function):
    """The channel FF of the plain bf16 block (z -> bf16(c)); its backward is
    the engine's arithmetic, returning the roundings JAX's AD makes."""

    @staticmethod
    def forward(ctx, z, w3, b3, w4, b4, m2, m3, approx, terms):
        ctx.save_for_backward(z, w3, b3, w4, m2, m3)
        ctx.cfg = (approx, terms)
        h2 = mk._gelu(z.float() @ rd(w3) + b3, approx) * m2
        return ((rd(h2) @ rd(w4) + b4) * m3).to(BF)

    @staticmethod
    def backward(ctx, gc):
        z, w3, b3, w4, m2, m3 = ctx.saved_tensors
        approx, terms = ctx.cfg
        scale = float(m3.max())
        da4 = gc.float() * (m3 != 0)  # rd(g) times the keep bit
        zf, w3b, w4b = z.float(), rd(w3), rd(w4)
        gl, gd = gelu_and_grad(engine_mm([zf], [w3b], zf.shape[1]) + b3, approx)
        dh2 = scale * engine_mm([da4], [w4b.t()], da4.shape[1])
        h2 = rd(gl * m2)
        da3 = split(rd(dh2) * m2 * gd, terms)
        dz = engine_mm(da3, [w3b.t()], KSLICE)
        dw3 = engine_mm([zf.t()], da3, WSLICE)
        dw4 = scale * engine_mm([da4.t()], [h2], WSLICE).t()
        db3 = sum(da3).sum(0)
        db4 = scale * da4.sum(0)
        return dz.to(BF), rd(dw3), db3, rd(dw4), db4, None, None, None, None


def model_block(x, p, masks, approx, terms=3):
    """mk._block_math in bf16 with the channel FF through ChannelEngine."""
    B, N, D = x.shape

    def mm(a, w):
        return torch.matmul(a.to(BF).float(), w.to(BF).float())

    x2 = x.to(BF).reshape(B * N, D)
    y = mk._layer_norm(x2, p.ln1_scale.to(BF), p.ln1_bias.to(BF))
    y_t = y.reshape(B, N, D).transpose(1, 2).reshape(B * D, N)
    h = mk._gelu(mm(y_t, p.w1) + p.b1, approx) * masks[0]
    t = (mm(h, p.w2) + p.b2) * masks[1]
    x1 = x2 + t.reshape(B, D, N).transpose(1, 2).reshape(B * N, D).to(BF)
    z = mk._layer_norm(x1, p.ln2_scale.to(BF), p.ln2_bias.to(BF))
    c = ChannelEngine.apply(z, p.w3, p.b3, p.w4, p.b4, masks[2], masks[3], approx, terms)
    return (x1 + c).float().reshape(B, N, D)


def make_case(seed=7):
    g = GEOM
    rng = np.random.RandomState(seed)
    u = lambda fan, *shape: rng.uniform(-1, 1, shape) / np.sqrt(fan)  # noqa: E731
    ln = lambda: [1 + 0.1 * rng.randn(g["D"]), 0.1 * rng.randn(g["D"])]  # noqa: E731
    N, D, T, C = g["N"], g["D"], g["T"], g["C"]
    flat = [*ln(), u(N, N, T), u(N, T), u(T, T, N), u(T, N), *ln(), u(D, D, C), u(D, C),
            u(C, C, D), u(C, D)]
    x, gout = rng.randn(g["B"], N, D), rng.randn(g["B"], N, D)
    masks = mk.block_masks(3, 0, g["B"], N, D, T, C, RATE)
    return ([a.astype(np.float32) for a in (x, gout)], [a.astype(np.float32) for a in flat],
            [m.numpy() for m in masks])


_JAX = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")
from m2mixer_tpu.modules.common import set_gelu_approximate
from m2mixer_tpu.ops import mixer_kernel as jk
z = dict(np.load(sys.argv[1]))
set_gelu_approximate(True)
bf = jnp.bfloat16
masks = tuple(jnp.asarray(z[f"m{i}"]) for i in range(4))
flat = tuple(jnp.asarray(z[f"p{i}"]) for i in range(12))
g = jnp.asarray(z["g"])


def f(x, p):
    out = jk._block_math(x, jk.MixerBlockParams(*jk._cast_params(p, bf)), masks, bf)
    return jnp.vdot(out, g)


gx, gp = jax.jit(jax.grad(f, argnums=(0, 1)))(jnp.asarray(z["x"]), flat)
np.savez(sys.argv[2], *[np.asarray(a) for a in (gx, *gp)])
"""


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs and JAX's gradients (one subprocess, XLA's excess precision
    off, as tests/test_torch_mixer_bf16_grad.py runs it)."""
    (x, g), flat, masks = make_case()
    tmp = tmp_path_factory.mktemp("bf16_split")
    np.savez(tmp / "in.npz", x=x, g=g, **{f"p{i}": a for i, a in enumerate(flat)},
             **{f"m{i}": m for i, m in enumerate(masks)})
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false", JAX_PLATFORMS="cpu")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", _JAX, str(tmp / "in.npz"), str(tmp / "out.npz")],
                   check=True, env=env, cwd=repo, timeout=300)
    with np.load(tmp / "out.npz") as z:
        want = [z[f"arr_{i}"] for i in range(13)]
    return x, g, flat, masks, want


def model_grads(x, g, flat, masks, terms):
    xt = torch.from_numpy(x).requires_grad_()
    pt = [torch.from_numpy(a).requires_grad_() for a in flat]
    out = model_block(xt, mk.MixerBlockParams(*pt), [torch.from_numpy(m) for m in masks], True,
                      terms)
    (out * torch.from_numpy(g)).sum().backward()
    return [xt.grad.numpy()] + [p.grad.numpy() for p in pt]


def differing_share(got, want):
    mask = (True, *ROUNDED)
    diff = sum(int(np.sum(a != b)) for a, b, r in zip(got, want, mask) if r)
    return diff / sum(a.size for a, r in zip(got, mask) if r)


def test_engine_arithmetic_matches_jax(case):
    """Three planes of da3, da4's scale on the sums, float32 adds a stage:
    within REL of JAX's gradients and at most MISMATCH of the rounded
    elements differing."""
    x, g, flat, masks, want = case
    got = model_grads(x, g, flat, masks, 3)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == np.float32 and a.shape == b.shape, i
        err = float(np.max(np.abs(a - b)))
        assert err <= REL * max(1.0, float(np.max(np.abs(b)))), (i, err)
    share = differing_share(got, want)
    assert share <= MISMATCH, share


def test_one_term_of_da3_is_not_enough(case):
    """The control: da3 rounded to one bf16 term (dz and dW3 from bf16(da3))
    differs from JAX in more than MISMATCH of the rounded elements."""
    x, g, flat, masks, want = case
    share = differing_share(model_grads(x, g, flat, masks, 1), want)
    assert share > MISMATCH, share
