"""The bf16 DynaMixerOp's engine arithmetic (bf16 K4f/K4b) against JAX's bf16 math.

On the card bf16 K4f and K4b take the rows route of ``csrc/dynamixer.cu``:
every product over all rows on the wgmma engine (``csrc/wgmma_bf16.cuh``),
with these departures from a float32 product of the same values:
- the operands lie in bf16 (x, W_c, W_g and W_o rounded; gin = bf16(comp +
  b_c), mixed, d_mixed and d_comp rounded where ``_op_math``'s casts and
  their cotangents round);
- each 64-deep stage's products are summed apart and added to the float32
  accumulator, and a weight gradient sliced over its rows adds its slices
  in slice order;
- the float32 cotangents g (d_mixed = g W_o, dW_o = g^T mixed) and d_logit
  (d_gin = d_logit W_g, dW_g = d_logit^T gin) enter as three bf16 planes,
  hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid), each a pass of
  its own, smallest first.
dP = d_mixed x^T per head runs on bf16 mma.sync (both operands hold bf16
values, float32 sums, modelled here as one float32 product); the softmax,
the per-head mix and the softmax's backward stay float32 on the CUDA cores.
Here that arithmetic is modelled in plain PyTorch
(``model``) and held to JAX's bf16 ``_op_math`` and its ``jax.vjp`` (one
subprocess, XLA's excess precision off) at the DynaMixer config's op (L 7,
C 256, H 8, R 2) with S = 14 sequences and at L 33, C 1280 with S = 2: the
output and every gradient within 2e-2 x max(1, max|JAX|), and at most 1% of
the rounded elements (dW_c, dW_g, dW_o) differing. Two controls differ in
more: the op in float32 math rounded where the bf16 one rounds, and g as its
hi plane alone.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from m2mixer_tpu_torch.ops import dynamixer_kernel as dk
from test_torch_mixer_bf16_grad import MISMATCH, REL
from test_torch_mixer_bf16_split import engine_mm, rd, split
from test_torch_hygiene import one_torch_thread  # noqa: F401  (autouse)

# dx, then DynaMixerOpParams: which a bf16 cast rounds
ROUNDED = (False, True, False, True, False, True, False)
SHAPES = {"config": dict(S=14, L=7, C=256, H=8, R=2), "l33": dict(S=2, L=33, C=1280, H=8, R=2)}
WSLICE = 64  # the weight gradients' rows in slices of one stage: several slices each


def case_inputs(name):
    """x, g and the op's parameters (output-major), float32, from a seed."""
    S, L, C, H, R = (SHAPES[name][k] for k in "SLCHR")
    rng = np.random.RandomState(len(name) + C)

    def u(fan, *shape):
        return (rng.uniform(-1, 1, shape) / np.sqrt(fan)).astype(np.float32)

    params = [u(C, H * R, C), u(C, H * R), u(L * R, L * L, L * R), u(L * R, L * L), u(C, C, C),
              u(C, C)]
    x, g = (rng.randn(S, L, C).astype(np.float32) for _ in range(2))
    return x, g, params


def model(x, g, p, H, R, g_terms=3):
    """The rows route's output and (dx, 6 gradients) as the engine sums them."""
    S, L, C = x.shape
    HR, LR, LL, Ch = H * R, L * R, L * L, C // H
    xb = rd(x.reshape(S * L, C))
    wc, wg, wo = rd(p.w_compress), rd(p.w_generate), rd(p.w_out)
    comp = engine_mm([xb], [wc.t()], C) + p.b_compress
    gin = rd(comp).reshape(S, L, H, R).transpose(1, 2).reshape(S * H, LR)
    logits = engine_mm([gin], [wg.t()], LR) + p.b_generate
    P = torch.softmax(logits.reshape(S * H, L, L), dim=1)  # over m, the source token
    heads = lambda t: t.reshape(S, L, H, Ch).transpose(1, 2).reshape(S * H, L, Ch)  # noqa: E731
    rows = lambda t: t.reshape(S, H, L, Ch).transpose(1, 2).reshape(S * L, C)  # noqa: E731
    xh = heads(xb)
    mixed = rd(rows(torch.bmm(P.transpose(1, 2), xh)))
    y = (engine_mm([mixed], [wo.t()], C) + p.b_out).reshape(S, L, C)
    g2 = g.reshape(S * L, C)
    gp = split(g2, g_terms)
    dm = rd(engine_mm(gp, [wo], C))
    dmh = heads(dm)
    dP = torch.bmm(xh, dmh.transpose(1, 2))  # dP[m, l] = sum_c x[m, c] d_mixed[l, c]
    dlog = (P * (dP - (P * dP).sum(1, keepdim=True))).reshape(S * H, LL)
    dl = split(dlog, 3)
    dcomp = rd(engine_mm(dl, [wg], LL)).reshape(S, H, L, R).transpose(1, 2).reshape(S * L, HR)
    dx = rd(rows(torch.bmm(P, dmh))) + rd(engine_mm([dcomp], [wc], HR))
    dwc = rd(engine_mm([xb.t()], [dcomp], WSLICE).t())
    dwg = rd(engine_mm([t.t() for t in dl], [gin], WSLICE))
    dwo = rd(engine_mm([t.t() for t in gp], [mixed], WSLICE))
    grads = (dx.reshape(S, L, C), dwc, dcomp.sum(0), dwg, dlog.sum(0), dwo, g2.sum(0))
    return y, grads


_JAX = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")
from m2mixer_tpu.ops import dynamixer_kernel as jd
z = dict(np.load(sys.argv[1]))
out = {}
for name in sorted({k.split("/")[0] for k in z}):
    H, R = (int(v) for v in z[name + "/hr"])
    # the JAX kernel's weights are input-major: the port's transposed
    p = jd.DynaMixerOpParams(*(jnp.asarray(z[f"{name}/p{i}"]) for i in range(6)))
    fn = jax.jit(lambda x, p, H=H, R=R: jd._op_math(x, p, H, R, jnp.bfloat16))
    y, vjp = jax.vjp(fn, jnp.asarray(z[name + "/x"]), p)
    out[name + "/y"] = np.asarray(y)
    for i, a in enumerate(jax.tree_util.tree_leaves(vjp(jnp.asarray(z[name + "/g"])))):
        out[f"{name}/g{i}"] = np.asarray(a)
np.savez(sys.argv[2], **out)
"""


def to_jax(params):
    return [a.T.copy() if a.ndim == 2 else a for a in params]


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """JAX's forward and VJP of every case in the port's layout (the weight
    gradients transposed back), from one subprocess with XLA's excess
    precision off (as tests/test_torch_mixer_bf16_split.py runs it)."""
    tmp = tmp_path_factory.mktemp("dyna_bf16_engine")
    arrays = {}
    for name, geom in SHAPES.items():
        x, g, params = case_inputs(name)
        arrays.update({f"{name}/x": x, f"{name}/g": g,
                       f"{name}/hr": np.array([geom["H"], geom["R"]])})
        arrays.update({f"{name}/p{i}": a for i, a in enumerate(to_jax(params))})
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false", JAX_PLATFORMS="cpu")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", _JAX, str(tmp / "in.npz"), str(tmp / "out.npz")],
                   check=True, env=env, cwd=repo, timeout=300)
    with np.load(tmp / "out.npz") as z:
        out = {}
        for name in SHAPES:
            grads = [z[f"{name}/g{i}"] for i in range(7)]
            out[name] = (z[name + "/y"], [grads[0]] + to_jax(grads[1:]))
        return out


def model_run(name, g_terms=3):
    x, g, params = case_inputs(name)
    p = dk.DynaMixerOpParams(*map(torch.from_numpy, params))
    geom = SHAPES[name]
    with torch.no_grad():
        y, grads = model(torch.from_numpy(x), torch.from_numpy(g), p, geom["H"], geom["R"],
                         g_terms)
    return y.numpy(), [t.numpy() for t in grads]


def differing_share(grads, want):
    """Share of the rounded gradients' elements not bit-equal to JAX's."""
    pairs = [(a, b) for a, b, r in zip(grads, want, ROUNDED) if r]
    return sum(int(np.sum(a != b)) for a, b in pairs) / sum(a.size for a, _ in pairs)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_engine_arithmetic_matches_jax(jax_refs, name):
    """bf16 operands, a float32 add a stage, g and d_logit as three planes,
    slices in order: the output and every gradient within REL x max(1,
    max|JAX|), the rounded ones on the bf16 grid, and at most MISMATCH of
    their elements differing from JAX's."""
    want_y, want = jax_refs[name]
    y, grads = model_run(name)
    for i, (a, b) in enumerate(zip([y] + grads, [want_y] + want)):
        assert a.dtype == np.float32 and a.shape == b.shape, i
        err = float(np.max(np.abs(a - b)))
        assert err <= REL * max(1.0, float(np.max(np.abs(b)))), (i, err)
    for a, r in zip(grads, ROUNDED):
        if r:
            assert np.array_equal(a, torch.from_numpy(a).to(torch.bfloat16).float().numpy())
    share = differing_share(grads, want)
    assert share <= MISMATCH, share


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_float32_math_is_not_enough(jax_refs, name):
    """The control: the op in float32 math (the plain float32 version's
    gradients), rounded where the bf16 one rounds, differs from JAX in more
    than MISMATCH of the rounded elements."""
    _, want = jax_refs[name]
    x, g, params = case_inputs(name)
    geom = SHAPES[name]
    dx, grads = dk.dynamixer_op_bwd_reference(torch.from_numpy(x), torch.from_numpy(g),
                                              [torch.from_numpy(a) for a in params], geom["H"],
                                              geom["R"])
    got = [rd(t).numpy() if r else t.numpy() for t, r in zip((dx, *grads), ROUNDED)]
    assert differing_share(got, want) > MISMATCH


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_one_plane_of_g_is_not_enough(jax_refs, name):
    """The control: g as its hi plane alone (d_mixed and dW_o from bf16(g))
    differs from JAX in more than MISMATCH of the rounded elements."""
    _, want = jax_refs[name]
    _, grads = model_run(name, g_terms=1)
    assert differing_share(grads, want) > MISMATCH
