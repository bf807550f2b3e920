"""The port's fused DynaMixerOp (``ops/dynamixer_kernel.py``) against the JAX
package's, on the CPU.

On the CPU ``fused_dynamixer_op`` runs the plain version forward and its
autograd backward inside the ``torch.autograd.Function`` whose CUDA side is
K4f/K4b (``tests/test_torch_cuda_kernels.py`` holds the kernels to it on the
card). The JAX side is ``fused_dynamixer_op`` in interpret mode (its
``custom_vjp`` backward) and ``dynamixer_op_reference``, as
``tests/modules/test_dynamixer_kernel.py`` runs them. The port takes the
three weights output-major (the ``Linear`` layout), JAX input-major: the
port's side gets JAX's weights transposed, and its weight gradients are
transposed back before they are compared.

Tolerances are relative to the JAX side's magnitude: the forward within
1e-5 x max(1, max|JAX|), the input and the 6 parameter gradients within
5e-5 x max(1, max|JAX|) per tensor (the same float32 math summed in another
order; the gradients of the compress weights sum over S*L rows and every
head's softmax backward). Inputs are unequal and non-symmetric (R = 3 in the
small case, biases nonzero), so a swapped axis cannot pass by accident.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2mixer_tpu.ops import dynamixer_kernel as jd
from m2mixer_tpu_torch.ops import dynamixer_kernel as td
from test_torch_hygiene import one_torch_thread  # noqa: F401  (autouse)

FWD_TOL = 1e-5
GRAD_TOL = 5e-5
# "odd" is the card tests' odd shape (tests/test_torch_cuda_kernels.py:
# DYNA_SHAPES), so the plain version the kernels are held to there is held to
# JAX here: C = 36 and H*R = 18, no multiple of 8 or 16
SHAPES = {"small": dict(S=4, L=4, C=16, H=4, R=3), "config": dict(S=14, L=7, C=256, H=8, R=2),
          "odd": dict(S=9, L=5, C=36, H=6, R=3)}


def case(seed, S, L, C, H, R):
    """Input, output gradient and parameters (JAX layout, input-major) at
    the Linear layers' init scales, U(+-1/sqrt(fan_in))."""
    rng = np.random.RandomState(seed)
    u = lambda fan, *shape: (rng.uniform(-1, 1, shape) / np.sqrt(fan)).astype(np.float32)
    params = [u(C, C, H * R), u(C, H * R), u(L * R, L * R, L * L), u(L * R, L * L), u(C, C, C),
              u(C, C)]
    x = rng.randn(S, L, C).astype(np.float32)
    g = rng.randn(S, L, C).astype(np.float32)
    return x, g, params


def transposed(params):
    """The 2-D leaves transposed: JAX's input-major weights to the port's
    output-major ones, and the port's weight gradients back."""
    return [np.ascontiguousarray(a.T) if a.ndim == 2 else a for a in params]


def assert_rel_close(got, want, tol):
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * scale, (err, tol * scale)


def jax_fwd_grads(fn, x, g, params, H, R):
    p = jd.DynaMixerOpParams(*map(jnp.asarray, params))

    def fwd_vjp(x, p):
        out, vjp = jax.vjp(lambda x, p: fn(x, p, H, R), x, p)
        return out, vjp(jnp.asarray(g))

    out, (gx, gp) = jax.jit(fwd_vjp)(jnp.asarray(x), p)
    return np.asarray(out), [np.asarray(gx)] + [np.asarray(a) for a in gp]


def port_fwd_grads(x, g, params, H, R):
    """The port's output and gradients for JAX-layout ``params`` (its weight
    gradients transposed back to that layout)."""
    xt = torch.from_numpy(x).requires_grad_()
    pt = [torch.from_numpy(a).requires_grad_() for a in transposed(params)]
    out = td.fused_dynamixer_op(xt, td.DynaMixerOpParams(*pt), H, R)
    assert type(out.grad_fn).__name__ == "_DynaFnBackward"
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), [xt.grad.numpy()] + transposed([p.grad.numpy() for p in pt])


@pytest.mark.parametrize("jax_fn", ["reference", "interpret"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_version_matches_jax_forward_and_grad(shape, jax_fn):
    geom = SHAPES[shape]
    x, g, params = case(1, **geom)
    fn = jd.dynamixer_op_reference if jax_fn == "reference" else jd.fused_dynamixer_op
    want_out, want_grads = jax_fwd_grads(fn, x, g, params, geom["H"], geom["R"])
    got_out, got_grads = port_fwd_grads(x, g, params, geom["H"], geom["R"])
    assert_rel_close(got_out, want_out, FWD_TOL)
    assert len(got_grads) == len(want_grads) == 7
    for a, b in zip(got_grads, want_grads):
        assert_rel_close(a, b, GRAD_TOL)


def test_softmax_runs_over_the_source_token():
    """With W_generate zero, the logits are b_generate alone; one large entry
    at (m, l) = (2, 0) gives output token 0 the input token 2's values (the
    softmax normalises over m), every other output token the mean of the
    input tokens."""
    S, L, C, H, R = 2, 4, 8, 2, 2
    x, _, params = case(3, S, L, C, H, R)
    b_gen = np.zeros(L * L, np.float32)
    b_gen[2 * L + 0] = 60.0
    params[2] = np.zeros_like(params[2])
    params[3] = b_gen
    params[4] = np.eye(C, dtype=np.float32)
    params[5] = np.zeros(C, np.float32)
    out = td.fused_dynamixer_op(torch.from_numpy(x), list(map(torch.from_numpy,
                                                              transposed(params))), H, R)
    np.testing.assert_allclose(out[:, 0].numpy(), x[:, 2], atol=1e-5)
    np.testing.assert_allclose(out[:, 1:].numpy(), np.repeat(x.mean(1, keepdims=True), L - 1, 1),
                               atol=1e-5)


def test_backward_wrapper_is_autograd_of_the_plain_version():
    x, g, params = case(4, **SHAPES["small"])
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    pt = list(map(torch.from_numpy, transposed(params)))
    dx, grads = td.fused_dynamixer_op_bwd(xt, gt, pt, 4, 3)
    want_dx, want = td.dynamixer_op_bwd_reference(xt, gt, pt, 4, 3)
    assert torch.equal(dx, want_dx) and all(torch.equal(a, b) for a, b in zip(grads, want))
    assert td.fused_dynamixer_op.launches == td.fused_dynamixer_op_bwd.launches == 0


def test_bf16_and_bad_shapes_raise_on_the_cpu_route():
    """bf16 compute raises nothing on the CPU route: the wrappers run the bf16
    plain version and its autograd, bit for bit, and launch no kernel (the
    plain version is held to JAX in tests/test_torch_dynamixer_bf16.py). A
    compute dtype the kernels do not take and bad shapes raise."""
    x, g, params = case(5, **SHAPES["small"])
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    pt = list(map(torch.from_numpy, transposed(params)))
    bf16 = torch.bfloat16
    out = td.fused_dynamixer_op(xt, pt, 4, 3, compute_dtype=bf16)
    assert out.dtype == torch.float32
    assert torch.equal(out, td.dynamixer_op_reference(xt, pt, 4, 3, bf16))
    dx, grads = td.fused_dynamixer_op_bwd(xt, gt, pt, 4, 3, compute_dtype=bf16)
    want_dx, want = td.dynamixer_op_bwd_reference(xt, gt, pt, 4, 3, bf16)
    assert torch.equal(dx, want_dx) and all(torch.equal(a, b) for a, b in zip(grads, want))
    assert td.fused_dynamixer_op.bf16_launches == td.fused_dynamixer_op_bwd.bf16_launches == 0
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        td.fused_dynamixer_op(xt, pt, 4, 3, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="must split into"):
        td.fused_dynamixer_op(xt, pt, 5, 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_output_major_weights_match_the_jax_layout(dtype):
    """A ``DynaMixerOp`` module hands its ``Linear`` weights to the op as they
    are (output-major): its output equals JAX's op on the same weights
    transposed, and its weights' gradients are JAX's transposed (float32:
    the tolerances above; bf16: the module rounds the op's float32 output
    to bf16, so 1e-2 x max(1, max|JAX|), gradients 2e-2 x, as
    tests/test_torch_dynamixer_bf16.py holds the op math)."""
    from m2mixer_tpu_torch.modules.dynamixer import DynaMixerOp

    S, L, C, H, R = (SHAPES["odd"][k] for k in "SLCHR")
    x, g, _ = case(6, **SHAPES["odd"])
    op = DynaMixerOp(C, L, H, R, dtype=dtype, generator=torch.Generator().manual_seed(6))
    xt = torch.from_numpy(x).requires_grad_()
    out = op(xt)
    (out.float() * torch.from_numpy(g)).sum().backward()
    lins = (op.compress, op.generate, op.out)
    assert all(lin.weight.dtype == torch.float32 for lin in lins)
    got = [p.grad.numpy() for lin in lins for p in (lin.weight, lin.bias)]
    params = transposed([p.detach().numpy() for lin in lins for p in (lin.weight, lin.bias)])
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want_out, want = jax_fwd_grads(lambda x, p, H, R: jd.dynamixer_op_reference(x, p, H, R, jdt),
                                   x, g, params, H, R)
    bf = dtype == torch.bfloat16
    assert_rel_close(out.detach().float().numpy(), want_out, 1e-2 if bf else FWD_TOL)
    for a, b in zip([xt.grad.numpy()] + transposed(got), want):
        assert_rel_close(a, b, 2e-2 if bf else GRAD_TOL)
