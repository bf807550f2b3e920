"""The bf16 gMLP block's engine arithmetic (bf16 K3f/K3b) against JAX's bf16 math.

On the card bf16 K3f and K3b run the block's D x F and F/2 x D products on
the wgmma engine (``csrc/wgmma_bf16.cuh``, ``csrc/gmlp.cu``'s header), with
these departures from a float32 product of the same values:
- dout = bf16(g) m2 enters as bf16(g) times m2's keep bit, and the dropout
  scale 1/(1-p) multiplies the float32 sums (dgated, dW_out, db_out);
- dpre, a float32 value, enters dxn and dW_in as three bf16 planes, hi =
  bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each a pass of its
  own, smallest first;
- each 64-deep stage's products are summed apart and added to the float32
  accumulator, and a product sliced over its depth (the out-projection's F/2
  where its tiles are few, dxn's F, the weight gradients' rows) adds its
  slices in slice order;
- db_in and db_out are float32 sums of the terms their producers write;
- the SGU's token projection (``mma.sync`` on bf16 operands, float32 sums)
  takes its cotangent dt = bf16(dgated u) m1 as the bf16 value times m1's
  keep bit, the dropout scale on the sums of dv', d sgu_w and d sgu_b.
Here that arithmetic is modelled in plain PyTorch: ``InProj`` (xn W_in and
its backward: dxn, dW_in, db_in), ``TokenProj`` (v' sgu_w and its backward:
dv', d sgu_w, d sgu_b) and ``OutProj`` (gated W_out and its backward:
dgated, dW_out, db_out) inside the plain bf16 block
(``ops/gmlp_kernel.py::_block_math``, every other step autograd of it, cast
for cast), and held to JAX's bf16 ``_block_math`` and its ``jax.vjp`` (one
subprocess, XLA's excess precision off) at N = 6 and 49, narrow widths whose
depths take several stages and slices, dropout 0 and 0.1, tanh GELU: the
forward and every gradient within 2e-2 x max(1, max|JAX|), and at most 1%
of the rounded elements (the output, dx and all gradients but the three
biases') differing. Two controls differ in more: the block in float32 math
rounded where the bf16 one rounds, and dpre as its hi plane alone.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from m2mixer_tpu_torch.ops import gmlp_kernel as tg
from test_torch_mixer_bf16_split import engine_mm, rd, split
from test_torch_mixer_bf16_grad import MISMATCH, REL
from test_torch_hygiene import one_torch_thread  # noqa: F401  (autouse)

BF = torch.bfloat16
# dx and the 10 gradients in GmlpBlockParams order: which a bf16 cast rounds
ROUNDED = (True, True, True, True, False, True, True, True, False, True, False)
# narrow widths with depths of several 64-deep stages: F/2 (the out-projection)
# 80 and 68, F (dxn) 160 and 136, the rows (the weight gradients) 144 and 147
SHAPES = {"n6": dict(B=24, N=6, D=16, F=160), "n49": dict(B=3, N=49, D=24, F=136)}
RATES = (0.0, 0.1)
CASES = sorted(f"{s}-rate{r}" for s in SHAPES for r in RATES)
SLICE = 64  # every sliced depth in slices of one stage: several slices each


class InProj(torch.autograd.Function):
    """pm = (xn W_in + b_in) m0 on the engine; its backward takes dpm, forms
    dpre = dpm m0 and returns bf16(dxn), bf16(dW_in) and db_in."""

    @staticmethod
    def forward(ctx, xn, w_in, b_in, m0, terms):
        ctx.save_for_backward(xn, w_in, m0)
        ctx.terms = terms
        pm = engine_mm([xn.float()], [rd(w_in)], SLICE) + b_in
        return pm * m0 if m0 is not None else pm

    @staticmethod
    def backward(ctx, dpm):
        xn, w_in, m0 = ctx.saved_tensors
        dpre = dpm * m0 if m0 is not None else dpm
        planes = split(dpre, ctx.terms)
        dxn = engine_mm(planes, [rd(w_in).t()], SLICE)
        dw_in = engine_mm([xn.float().t()], planes, SLICE)
        return dxn.to(BF), rd(dw_in), dpre.sum(0), None, None


class OutProj(torch.autograd.Function):
    """out = (gated W_out + b_out) m2 on the engine, F/2 in slices; its
    backward takes bf16(g) and returns bf16(dgated), bf16(dW_out), db_out,
    the dropout scale on the sums of bf16(g) times the keep bit."""

    @staticmethod
    def forward(ctx, gated, w_out, b_out, m2):
        ctx.save_for_backward(gated, w_out, m2)
        out = engine_mm([gated.float()], [rd(w_out)], SLICE) + b_out
        return out * m2 if m2 is not None else out

    @staticmethod
    def backward(ctx, g):
        gated, w_out, m2 = ctx.saved_tensors
        scale = float(m2.max()) if m2 is not None else 1.0
        dout = g * (m2 != 0) if m2 is not None else g
        dgated = scale * engine_mm([dout], [rd(w_out).t()], SLICE)
        dw_out = scale * engine_mm([gated.float().t()], [dout], SLICE)
        return dgated.to(BF), rd(dw_out), scale * dout.sum(0), None


class TokenProj(torch.autograd.Function):
    """t' = (bf16(v') sgu_w + sgu_b) m1 over (B*F/2, N) rows, v' = LN(v) in
    float32; its backward takes bf16(dgated u) and returns bf16(dv'),
    bf16(d sgu_w), d sgu_b, the dropout scale on the sums of that value times
    the keep bit."""

    @staticmethod
    def forward(ctx, vn, w, b, m1):
        ctx.save_for_backward(vn, w, m1)
        t = rd(vn) @ rd(w) + b
        return t * m1 if m1 is not None else t

    @staticmethod
    def backward(ctx, dt):
        vn, w, m1 = ctx.saved_tensors
        scale = float(m1.max()) if m1 is not None else 1.0
        bits = dt * (m1 != 0) if m1 is not None else dt
        dvn = rd(scale * (bits @ rd(w).t()))
        return dvn, rd(scale * (rd(vn).t() @ bits)), scale * bits.sum(0), None


def model_block(x, p, masks, terms=3, dtype=BF):
    """tg._block_math with its products through InProj, TokenProj and
    OutProj (dtype float32: the plain float32 block, the control)."""
    if dtype != BF:
        return tg._block_math(x, p, True, masks, dtype)
    B, N, D = x.shape
    H = p.w_in.shape[1] // 2
    m0, m1, m2 = masks if masks is not None else (None, None, None)
    x2 = x.to(BF).reshape(B * N, D)
    y = tg._layer_norm(x2, p.ln_scale.to(BF), p.ln_bias.to(BF))
    y = tg._gelu(InProj.apply(y, p.w_in, p.b_in, m0, terms), True)
    u, v = y[:, :H], y[:, H:]
    v = tg._layer_norm(v, p.sgu_ln_scale.to(BF), p.sgu_ln_bias.to(BF))
    v = v.reshape(B, N, H).transpose(1, 2).reshape(B * H, N)
    v = TokenProj.apply(v, p.sgu_w, p.sgu_b, m1)
    v = v.reshape(B, H, N).transpose(1, 2).reshape(B * N, H)
    gated = u.to(BF) * v.to(BF)
    out = OutProj.apply(gated, p.w_out, p.b_out, m2)
    return (x2 + out.to(BF)).float().reshape(B, N, D)


def case_inputs(name):
    """x, g, the parameters (numpy float32, the modules' init scales, LN
    parameters jittered) and the port's three hash masks at the rate."""
    shape, rate = name.split("-rate")
    geom = SHAPES[shape]
    B, N, D, F = geom["B"], geom["N"], geom["D"], geom["F"]
    rng = np.random.RandomState(CASES.index(name) + 40)
    H = F // 2
    u = lambda fan, *s: (rng.uniform(-1, 1, s) / np.sqrt(fan)).astype(np.float32)  # noqa: E731
    jit = lambda n, base: (base + 0.1 * rng.randn(n)).astype(np.float32)  # noqa: E731
    params = [jit(D, 1.0), jit(D, 0.0), u(D, D, F), u(D, F), jit(H, 1.0), jit(H, 0.0),
              (0.02 * rng.randn(N, N)).astype(np.float32), np.ones(N, np.float32), u(H, H, D),
              u(H, D)]
    x, g = (rng.randn(B, N, D).astype(np.float32) for _ in range(2))
    masks = tg.gmlp_masks(23, B, N, D, F, float(rate))
    return x, g, params, None if masks is None else [m.numpy() for m in masks]


_JAX = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")
from m2mixer_tpu.modules.common import set_gelu_approximate
from m2mixer_tpu.ops import gmlp_kernel as jg
set_gelu_approximate(True)
bf = jnp.bfloat16
z = dict(np.load(sys.argv[1]))
out = {}
for name in sorted({k.split("/")[0] for k in z}):
    p = jg.GmlpBlockParams(*(jnp.asarray(z[f"{name}/p{i}"]) for i in range(10)))
    masks = None
    if name + "/m0" in z:
        masks = tuple(jnp.asarray(z[f"{name}/m{i}"]) for i in range(3))
    fn = jax.jit(lambda x, p: jg._block_math(x, p, masks, bf))
    y, vjp = jax.vjp(fn, jnp.asarray(z[name + "/x"]), p)
    out[name + "/y"] = np.asarray(y)
    for i, a in enumerate(jax.tree_util.tree_leaves(vjp(jnp.asarray(z[name + "/g"])))):
        out[f"{name}/g{i}"] = np.asarray(a)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """JAX's forward and VJP of every case, from one subprocess with XLA's
    excess precision off (as tests/test_torch_mixer_bf16_split.py runs it)."""
    tmp = tmp_path_factory.mktemp("gmlp_bf16_engine")
    arrays = {}
    for name in CASES:
        x, g, params, masks = case_inputs(name)
        arrays.update({f"{name}/x": x, f"{name}/g": g})
        arrays.update({f"{name}/p{i}": a for i, a in enumerate(params)})
        if masks is not None:
            arrays.update({f"{name}/m{i}": m for i, m in enumerate(masks)})
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false", JAX_PLATFORMS="cpu")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", _JAX, str(tmp / "in.npz"), str(tmp / "out.npz")],
                   check=True, env=env, cwd=repo, timeout=300)
    with np.load(tmp / "out.npz") as z:
        return {k: z[k] for k in z.files}


def model_run(name, terms=3, dtype=BF):
    """The model's output and (dx, 10 gradients), numpy float32."""
    x, g, params, masks = case_inputs(name)
    xt = torch.from_numpy(x).requires_grad_()
    pt = tg.GmlpBlockParams(*(torch.from_numpy(a).requires_grad_() for a in params))
    mt = None if masks is None else tuple(map(torch.from_numpy, masks))
    out = model_block(xt, pt, mt, terms, dtype)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), [xt.grad.numpy()] + [q.grad.numpy() for q in pt]


def differing_share(y, grads, want_y, want):
    """Share of the rounded elements (the output, and the gradients a bf16
    cast rounds) that are not bit-equal to JAX's."""
    pairs = [(y, want_y)] + [(a, b) for a, b, r in zip(grads, want, ROUNDED) if r]
    return sum(int(np.sum(a != b)) for a, b in pairs) / sum(a.size for a, _ in pairs)


def refs(jax_refs, name):
    return jax_refs[name + "/y"], [jax_refs[f"{name}/g{i}"] for i in range(11)]


@pytest.mark.parametrize("name", CASES)
def test_engine_arithmetic_matches_jax(jax_refs, name):
    """Three planes of dpre, dout's scale on the sums, a float32 add a stage,
    slices in order: the output and every gradient within REL x max(1,
    max|JAX|), the rounded ones on the bf16 grid, and at most MISMATCH of the
    rounded elements differing from JAX's."""
    want_y, want = refs(jax_refs, name)
    y, grads = model_run(name)
    for i, (a, b) in enumerate(zip([y] + grads, [want_y] + want)):
        assert a.dtype == np.float32 and a.shape == b.shape, i
        err = float(np.max(np.abs(a - b)))
        assert err <= REL * max(1.0, float(np.max(np.abs(b)))), (i, err)
    for a, r in zip([y] + grads, (True, *ROUNDED)):
        if r:
            assert np.array_equal(a, torch.from_numpy(a).to(BF).float().numpy())
    share = differing_share(y, grads, want_y, want)
    assert share <= MISMATCH, share


@pytest.mark.parametrize("name", CASES)
def test_float32_math_is_not_enough(jax_refs, name):
    """The control: the block in float32 math, rounded where the bf16 one
    rounds, differs from JAX in more than MISMATCH of the rounded elements."""
    want_y, want = refs(jax_refs, name)
    y, grads = model_run(name, dtype=torch.float32)
    y = torch.from_numpy(y).to(BF).float().numpy()
    grads = [torch.from_numpy(a).to(BF).float().numpy() if r else a
             for a, r in zip(grads, ROUNDED)]
    assert differing_share(y, grads, want_y, want) > MISMATCH


@pytest.mark.parametrize("name", CASES)
def test_one_plane_of_dpre_is_not_enough(jax_refs, name):
    """The control: dpre as its hi plane alone (dxn and dW_in from
    bf16(dpre)) differs from JAX in more than MISMATCH of the rounded
    elements."""
    want_y, want = refs(jax_refs, name)
    y, grads = model_run(name, terms=1)
    assert differing_share(y, grads, want_y, want) > MISMATCH
