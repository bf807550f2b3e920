"""The port's fused DynaMixerOp (``ops/dynamixer_kernel.py``) against the JAX
package's, on the CPU.

On the CPU ``fused_dynamixer_op`` runs the plain version forward and its
autograd backward inside the ``torch.autograd.Function`` whose CUDA side is
K4f/K4b (``tests/test_torch_cuda_kernels.py`` holds the kernels to it on the
card). The JAX side is ``fused_dynamixer_op`` in interpret mode (its
``custom_vjp`` backward) and ``dynamixer_op_reference``, as
``tests/modules/test_dynamixer_kernel.py`` runs them.

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

FWD_TOL = 1e-5
GRAD_TOL = 5e-5
# "odd" is the card tests' odd shape (tests/test_torch_cuda_kernels.py:
# DYNA_SHAPES), so the plain version the kernels are held to there is held to
# JAX here: C = 36 and H*R = 18, no multiple of 8 or 16
SHAPES = {"small": dict(S=4, L=4, C=16, H=4, R=3), "config": dict(S=14, L=7, C=256, H=8, R=2),
          "odd": dict(S=9, L=5, C=36, H=6, R=3)}


def case(seed, S, L, C, H, R):
    """Input, output gradient and parameters (JAX layout) at the Linear
    layers' init scales, U(+-1/sqrt(fan_in))."""
    rng = np.random.RandomState(seed)
    u = lambda fan, *shape: (rng.uniform(-1, 1, shape) / np.sqrt(fan)).astype(np.float32)
    params = [u(C, C, H * R), u(C, H * R), u(L * R, L * R, L * L), u(L * R, L * L), u(C, C, C),
              u(C, C)]
    x = rng.randn(S, L, C).astype(np.float32)
    g = rng.randn(S, L, C).astype(np.float32)
    return x, g, params


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
    xt = torch.from_numpy(x).requires_grad_()
    pt = [torch.from_numpy(a).requires_grad_() for a in params]
    out = td.fused_dynamixer_op(xt, td.DynaMixerOpParams(*pt), H, R)
    assert type(out.grad_fn).__name__ == "_DynaFnBackward"
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), [xt.grad.numpy()] + [p.grad.numpy() for p in pt]


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
    out = td.fused_dynamixer_op(torch.from_numpy(x), list(map(torch.from_numpy, params)), H, R)
    np.testing.assert_allclose(out[:, 0].numpy(), x[:, 2], atol=1e-5)
    np.testing.assert_allclose(out[:, 1:].numpy(), np.repeat(x.mean(1, keepdims=True), L - 1, 1),
                               atol=1e-5)


def test_backward_wrapper_is_autograd_of_the_plain_version():
    x, g, params = case(4, **SHAPES["small"])
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    pt = list(map(torch.from_numpy, params))
    dx, grads = td.fused_dynamixer_op_bwd(xt, gt, pt, 4, 3)
    want_dx, want = td.dynamixer_op_bwd_reference(xt, gt, pt, 4, 3)
    assert torch.equal(dx, want_dx) and all(torch.equal(a, b) for a, b in zip(grads, want))
    assert td.fused_dynamixer_op.launches == td.fused_dynamixer_op_bwd.launches == 0


def test_bf16_and_bad_shapes_raise_on_the_cpu_route():
    x, g, params = case(5, **SHAPES["small"])
    xt, pt = torch.from_numpy(x), list(map(torch.from_numpy, params))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        td.fused_dynamixer_op(xt, pt, 4, 3, compute_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        td.fused_dynamixer_op_bwd(xt, torch.from_numpy(g), pt, 4, 3,
                                  compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="must split into"):
        td.fused_dynamixer_op(xt, pt, 5, 3)
