"""The port's fused gMLP block (``ops/gmlp_kernel.py``) against the JAX
package's, on the CPU.

On the CPU ``fused_gmlp_block`` runs the plain version forward and its
autograd backward inside the ``torch.autograd.Function`` whose CUDA side is
K3f/K3b (``tests/test_torch_cuda_kernels.py`` holds the kernels to it on the
card). The JAX side is ``gmlp_block_reference`` and ``fused_gmlp_block`` in
interpret mode, as ``tests/modules/test_gmlp_kernel.py`` runs them.

Tolerances are relative to the reference's magnitude, ``TOL x max(1,
max|JAX|)`` per tensor: the token projection starts at bias 1, so outputs
and gradients grow with the widths (the same float32 math summed in another
order, and the TPU kernel's A&S erf within 1.5e-7 of exact erf).

The dropout masks cannot match the JAX kernel's (the TPU's PRNG), so they
are held to what they promise: they depend only on (seed, block, mask,
element), keep 1 - rate of the elements, and a dropped element passes no
gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2mixer_tpu.modules.common import set_gelu_approximate
from m2mixer_tpu.ops import gmlp_kernel as jg
from m2mixer_tpu_torch.ops import gmlp_kernel as tg
from test_torch_hygiene import one_torch_thread  # noqa: F401  (autouse)

TOL = 2e-5
# "odd_widths" is the card tests' odd shape (tests/test_torch_cuda_kernels.py:
# GMLP_TC_SHAPES), so the plain version the kernels are held to there is held
# to JAX here: widths that are no multiple of 8 or 16 (D = 20, F/2 = 22), N = 13
SHAPES = {"narrow": dict(B=4, N=6, D=16, F=32), "config": dict(B=2, N=49, D=128, F=768),
          "odd_widths": dict(B=5, N=13, D=20, F=44)}
# above 128 tokens the CUDA kernels take the large-N route: the plain version
# they are held to there is held here to the Pallas kernel (interpret mode)
LARGE_N = {"n129-erf": (dict(B=2, N=129, D=16, F=32), False),
           "n196-tanh": (dict(B=2, N=196, D=16, F=32), True)}


def case(seed, B, N, D, F):
    """Inputs, output gradient and parameters (JAX layout) at the modules'
    init scales, LN parameters jittered away from the identity."""
    rng = np.random.RandomState(seed)
    H = F // 2
    u = lambda fan, *shape: (rng.uniform(-1, 1, shape) / np.sqrt(fan)).astype(np.float32)
    jit = lambda n, base: (base + 0.1 * rng.randn(n)).astype(np.float32)
    params = [jit(D, 1.0), jit(D, 0.0), u(D, D, F), u(D, F), jit(H, 1.0), jit(H, 0.0),
              (0.02 * rng.randn(N, N)).astype(np.float32), np.ones(N, np.float32),
              u(H, H, D), u(H, D)]
    x = rng.randn(B, N, D).astype(np.float32)
    g = rng.randn(B, N, D).astype(np.float32)
    return x, g, params


def assert_rel_close(got, want, tol=TOL):
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * scale, (err, tol * scale)


def jax_fwd_grads(fn, x, g, params, approx):
    prev = set_gelu_approximate(approx)
    try:
        p = jg.GmlpBlockParams(*map(jnp.asarray, params))

        def fwd_vjp(x, p):
            out, vjp = jax.vjp(fn, x, p)
            return out, vjp(jnp.asarray(g))

        # a fresh jit per call: the GELU flavor is a trace-time switch
        out, (gx, gp) = jax.jit(fwd_vjp)(jnp.asarray(x), p)
    finally:
        set_gelu_approximate(prev)
    return np.asarray(out), [np.asarray(gx)] + [np.asarray(a) for a in gp]


def port_fwd_grads(x, g, params, approx, rate=0.0, seed=None):
    xt = torch.from_numpy(x).requires_grad_()
    pt = [torch.from_numpy(a).requires_grad_() for a in params]
    out = tg.fused_gmlp_block(xt, tg.GmlpBlockParams(*pt), seed, rate, approximate_gelu=approx)
    assert type(out.grad_fn).__name__ == "_GmlpFnBackward"
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), [xt.grad.numpy()] + [p.grad.numpy() for p in pt]


@pytest.mark.parametrize("jax_fn", ["reference", "interpret"])
@pytest.mark.parametrize("gelu", ["erf", "tanh"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_version_matches_jax_forward_and_grad(shape, gelu, jax_fn):
    approx = gelu == "tanh"
    x, g, params = case(1, **SHAPES[shape])
    fn = jg.gmlp_block_reference if jax_fn == "reference" else jg.fused_gmlp_block
    want_out, want_grads = jax_fwd_grads(fn, x, g, params, approx)
    got_out, got_grads = port_fwd_grads(x, g, params, approx)
    assert_rel_close(got_out, want_out)
    assert len(got_grads) == len(want_grads) == 11
    for a, b in zip(got_grads, want_grads):
        assert_rel_close(a, b)


@pytest.mark.parametrize("name", sorted(LARGE_N))
def test_plain_version_matches_jax_above_128_tokens(name):
    geom, approx = LARGE_N[name]
    x, g, params = case(2, **geom)
    want_out, want_grads = jax_fwd_grads(jg.fused_gmlp_block, x, g, params, approx)
    got_out, got_grads = port_fwd_grads(x, g, params, approx)
    assert_rel_close(got_out, want_out)
    for a, b in zip(got_grads, want_grads):
        assert_rel_close(a, b)


@pytest.mark.parametrize("mask", [0, 1, 2])
def test_masks_depend_only_on_seed_mask_and_element(mask):
    """A batch-4 mask is the prefix of the batch-8 one; the seed and the mask
    id each change it; the layouts are JAX's."""
    N, D, F = 6, 16, 32
    small = tg.gmlp_masks(7, 4, N, D, F, 0.5)[mask]
    big = tg.gmlp_masks(7, 8, N, D, F, 0.5)[mask]
    assert small.shape == [(4 * N, F), (4 * F // 2, N), (4 * N, D)][mask]
    assert torch.equal(big[:small.shape[0]], small)
    other = tg.gmlp_masks(8, 4, N, D, F, 0.5)[mask]
    assert not torch.equal(other, small)
    for m in range(3):
        if m != mask:
            o = tg.gmlp_masks(7, 4, N, D, F, 0.5)[m]
            assert o.shape != small.shape or not torch.equal(o, small)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_share_and_scale(rate):
    for m in tg.gmlp_masks(3, 8, 49, 128, 768, rate):
        assert abs((m > 0).float().mean().item() - (1 - rate)) <= 0.02
        assert set(m.unique().tolist()) == {0.0, float(np.float32(1 / (1 - rate)))}


def test_dropped_elements_pass_no_gradient():
    """At rate 0.97 most columns of each mask are dropped whole: the bias fed
    by that column (b_in by mask 0, sgu_b by mask 1, b_out by mask 2) gets
    exactly zero gradient there. (A kept column of masks 0 and 1 may pass zero
    too, when the later masks drop all it feeds; b_out's kept columns cannot.)"""
    B, N, D, F = 2, 6, 8, 16
    x, g, params = case(2, B, N, D, F)
    rate, seed = 0.97, 5
    _, grads = port_fwd_grads(x, g, params, False, rate, seed)
    masks = tg.gmlp_masks(seed, B, N, D, F, rate)
    for mask, grad in zip(masks, (grads[4], grads[8], grads[10])):
        kept = (mask > 0).any(dim=0).numpy()
        assert 0 < kept.sum() < kept.size
        assert np.all(grad[~kept] == 0.0)
    assert np.all(grad[kept] != 0.0)  # b_out: g summed over the kept rows


def test_forward_with_dropout_is_the_masked_plain_math():
    """The wrapper's rate-0.5 forward applies the three masks of its seed
    where ``_block_math`` puts them: it equals the plain math with the masks
    given explicitly, and differs from the rate-0 output."""
    x, _, params = case(3, **SHAPES["narrow"])
    xt, p = torch.from_numpy(x), tg.GmlpBlockParams(*map(torch.from_numpy, params))
    got = tg.fused_gmlp_block(xt, p, seed=11, dropout_rate=0.5)
    masks = tg.gmlp_masks(11, *x.shape, params[2].shape[1], 0.5)
    want = tg._block_math(xt, p, False, masks)
    assert torch.equal(got, want)
    assert not torch.allclose(got, tg.fused_gmlp_block(xt, p))


def test_bf16_raises_on_the_cpu_route():
    """bf16 compute no longer raises on the CPU route: the forward and the
    backward are the plain bf16 version and its autograd (the output on the
    bf16 grid, apart from the float32 one; the gradients float32); a compute
    dtype the kernels do not take still raises."""
    x, g, params = case(4, **SHAPES["narrow"])
    xt, p = torch.from_numpy(x), tg.GmlpBlockParams(*map(torch.from_numpy, params))
    bf16 = torch.bfloat16
    out = tg.fused_gmlp_block(xt, p, compute_dtype=bf16)
    assert out.dtype == torch.float32
    assert torch.equal(out, tg.gmlp_block_reference(xt, p, compute_dtype=bf16))
    assert torch.equal(out, out.to(bf16).float())
    assert not torch.equal(out, tg.fused_gmlp_block(xt, p))
    gt = torch.from_numpy(g)
    dx, grads = tg.fused_gmlp_block_bwd(xt, gt, p, compute_dtype=bf16)
    want_dx, want = tg.gmlp_block_bwd_reference(xt, gt, p, compute_dtype=bf16)
    assert torch.equal(dx, want_dx) and all(torch.equal(a, b) for a, b in zip(grads, want))
    assert all(t.dtype == torch.float32 for t in (dx, *grads))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tg.fused_gmlp_block(xt, p, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tg.fused_gmlp_block_bwd(xt, gt, p, compute_dtype=torch.float16)
