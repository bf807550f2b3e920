"""The port's bf16 K1b/K2b (their CPU route) against JAX's bf16 gradients.

On the CPU the port's bf16 backward is autograd of the plain bf16 version
(``mixer_block_reference`` / ``mixer_stack_reference``, cast for cast the JAX
kernels' ``_block_math``); the CUDA kernels of ``csrc/mixer_bwd.cu`` are held
to that on the card (tests/test_torch_cuda_kernels.py, chip_smoke.py). The
JAX side is what the Pallas kernels' in-kernel ``jax.vjp`` differentiates:
``jax.grad`` of the JAX package's own ``_block_math`` / ``_stack_apply`` on
the ``_cast_params`` copies with ``compute_dtype=bfloat16``, jitted. At these
sizes the kernels' batch tile is the whole batch, so their gradients are
those same numbers, bit for bit (``test_block_math_gradients_equal_the_kernels``
checks one case against ``fused_mixer_block``'s Pallas backward in interpret
mode, as ``tests/modules/test_pallas_kernel.py`` runs it). Every case runs in
one subprocess with XLA's ``--xla_allow_excess_precision`` off: with it on (the default) XLA on the CPU skips rounding points inside
its fusions, and its gradients drift from its own program's casts (in a
3-block stack up to 4 bf16 ulps: block 1's LN1 scale gradient, 0.0625 at a
magnitude of 2.47, where the port's float32 backward is within 0.022). The
parameters are float32 on both sides; the gradients come back in float32.

Tolerance: dx and every parameter gradient within 2e-2 x max(1, max|JAX|):
both sides round to bf16 at the same points, but a float32 sum taken in
another order can land a value on the other side of a rounding boundary
(one bf16 ulp, 2**-8 relative), and the backward carries it. One gradient is
exactly zero in the math: the token FF's output bias b2 of a block whose
every consumer is a LayerNorm (each block of a stack with its final LN). In
bf16 it is rounding noise on both sides, so it is held, as the JAX package's
own bf16 gradient test holds its dead leaves, to the global gradient scale:
both sides within 2e-2 x the largest JAX gradient anywhere. A max-error
limit cannot tell a skipped rounding point, so one test holds the share of
the rounded gradients' elements (dx and every gradient but the float32
biases') that differ from JAX's at all to ``MISMATCH``; the port's float32
backward, rounded to bf16 where the bf16 one rounds, fails that limit.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from m2mixer_tpu_torch.ops import mixer_kernel as tk
from test_torch_hygiene import one_torch_thread  # noqa: F401  (autouse)

GEOM = dict(D=16, T=8, C=64)
REL = 2e-2
MISMATCH = 0.01
# which of a block's 12 gradients a bf16 cast rounds: all but b1..b4
ROUNDED = (True, True, True, False, True, False, True, True, True, False, True, False)
KINDS = {"block": 1, "stack1": 1, "stack3": 3}


def make_case(seed, B, K, N, D, T, C):
    """x, the cotangent g and K blocks (+ the final LN) as numpy float32, LN
    parameters jittered away from the identity so their casts matter."""
    rng = np.random.RandomState(seed)
    u = lambda fan, *shape: rng.uniform(-1, 1, shape) / np.sqrt(fan)
    ln = lambda: [1 + 0.1 * rng.randn(D), 0.1 * rng.randn(D)]
    flat = []
    for _ in range(K):
        flat += [*ln(), u(N, N, T), u(N, T), u(T, T, N), u(T, N), *ln(), u(D, D, C), u(D, C),
                 u(C, C, D), u(C, D)]
    flat += ln()
    x, g = rng.randn(B, N, D), rng.randn(B, N, D)
    return [a.astype(np.float32) for a in (x, g)] + [[a.astype(np.float32) for a in flat]]


def dead_mask(kind):
    """The gradients that are exactly zero in the math: b2 under a LayerNorm."""
    if kind == "block":
        return (False,) * 13
    block = tuple(i == 5 for i in range(12))
    return (False, *(block * KINDS[kind]), False, False)


def rounded_mask(kind):
    if kind == "block":
        return (True, *ROUNDED)
    return (True, *(ROUNDED * KINDS[kind]), True, True)


def port_grads(kind, x, g, flat, approx, dtype=torch.bfloat16):
    """dx and the parameter gradients through the wrappers' autograd.Functions
    (their backward: fused_mixer_block_bwd / fused_mixer_stack_bwd)."""
    xt = torch.from_numpy(x).requires_grad_()
    pt = [torch.from_numpy(a).requires_grad_() for a in (flat[:12] if kind == "block" else flat)]
    if kind == "block":
        out = tk.fused_mixer_block(xt, tk.MixerBlockParams(*pt), compute_dtype=dtype,
                                   approximate_gelu=approx)
    else:
        out = tk.fused_mixer_stack(xt, pt, compute_dtype=dtype, approximate_gelu=approx)
    assert "Fn" in type(out.grad_fn).__name__
    (out * torch.from_numpy(g)).sum().backward()
    return [xt.grad.numpy()] + [p.grad.numpy() for p in pt]


_JAX_NO_EXCESS_PRECISION = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")
from m2mixer_tpu.modules.common import set_gelu_approximate
from m2mixer_tpu.ops import mixer_kernel as jk
bf = jnp.bfloat16
z = dict(np.load(sys.argv[1]))
out = {}


def block(x, p):
    return jk._block_math(x, jk.MixerBlockParams(*jk._cast_params(p, bf)), None, bf)


def stack(x, p):
    return jk._stack_apply(x, jk._cast_params(p, bf), [None] * (len(p) // 12), bf, True)


def kernel(x, p):  # the Pallas kernel's backward, interpret mode
    return jk.fused_mixer_block(x, jk.MixerBlockParams(*p), compute_dtype=bf)


for case in sorted({k.split("/")[0] for k in z}):
    set_gelu_approximate(bool(z[case + "/approx"]))
    flat = tuple(jnp.asarray(z[f"{case}/p{i}"]) for i in range(int(z[case + "/n"])))
    g = jnp.asarray(z[case + "/g"])
    fns = {"": block if case.startswith("block") else stack}
    if case == sys.argv[3]:
        fns["kernel/"] = kernel
    for tag, fn in fns.items():
        grad = jax.grad(lambda x, p: jnp.vdot(fn(x, p), g), argnums=(0, 1))
        gx, gp = (grad if tag else jax.jit(grad))(jnp.asarray(z[case + "/x"]), flat)
        for i, a in enumerate([gx, *gp]):
            out[f"{tag}{case}/{i}"] = np.asarray(a)
np.savez(sys.argv[2], **out)
"""

GELUS = ("erf", "tanh")
CASES = {f"{kind}-{n}-{gelu}": (kind, n, gelu) for kind in sorted(KINDS) for n in (4, 8)
         for gelu in GELUS}
# above 32 tokens (the CUDA kernels' token pipeline), erf
CASES.update({f"{kind}-{n}-erf": (kind, n, "erf") for kind in ("block", "stack3")
              for n in (33, 40)})
KERNEL_CASE = "block-4-erf"  # also through the Pallas kernel's backward
BIT_CASE = "stack3-bits"  # the cast-point case: 3 blocks + LN, N=4, erf


def case_inputs(name):
    if name == BIT_CASE:
        return ("stack3", False, *make_case(77, 4, 3, 4, **GEOM))
    kind, n, gelu = CASES[name]
    return (kind, gelu == "tanh", *make_case(n * 10 + KINDS[kind], 4, KINDS[kind], n, **GEOM))


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """Every case's JAX gradients, from one subprocess with XLA's excess
    precision off."""
    tmp = tmp_path_factory.mktemp("bf16_grad")
    arrays = {}
    for name in [*CASES, BIT_CASE]:
        kind, approx, x, g, flat = case_inputs(name)
        flat = flat[:12] if kind == "block" else flat
        arrays.update({f"{name}/x": x, f"{name}/g": g, f"{name}/n": np.int64(len(flat)),
                       f"{name}/approx": np.int64(approx)})
        arrays.update({f"{name}/p{i}": a for i, a in enumerate(flat)})
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false", JAX_PLATFORMS="cpu")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", _JAX_NO_EXCESS_PRECISION, str(tmp / "in.npz"),
                    str(tmp / "out.npz"), KERNEL_CASE], check=True, env=env, cwd=repo,
                   timeout=600)
    with np.load(tmp / "out.npz") as z:
        out = {k: z[k] for k in z.files}
    names = [*CASES, BIT_CASE, f"kernel/{KERNEL_CASE}"]
    return {name: [out[f"{name}/{i}"]
                   for i in range(len(rounded_mask(case_inputs(name.split("/")[-1])[0])))]
            for name in names}


def test_block_math_gradients_equal_the_kernels(jax_refs):
    """The JAX references above are the Pallas kernel's own gradients: jitted
    ``jax.grad`` of ``_block_math`` and the kernel's backward in interpret
    mode agree bit for bit."""
    for a, b in zip(jax_refs[KERNEL_CASE], jax_refs[f"kernel/{KERNEL_CASE}"]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_grads_match_jax(jax_refs, name):
    kind, approx, x, g, flat = case_inputs(name)
    got = port_grads(kind, x, g, flat, approx)
    want = jax_refs[name]
    assert len(got) == len(want) == len(rounded_mask(kind))
    scale = max(float(np.max(np.abs(b))) for b in want)
    for i, (a, b, dead) in enumerate(zip(got, want, dead_mask(kind))):
        assert a.dtype == np.float32 and a.shape == b.shape, i
        if dead:
            assert max(float(np.max(np.abs(a))), float(np.max(np.abs(b)))) <= REL * scale, i
            continue
        err = float(np.max(np.abs(a - b)))
        assert err <= REL * max(1.0, float(np.max(np.abs(b)))), (i, err)


def differing_share(got, want, mask):
    """Share of the rounded tensors' elements that are not bit-equal."""
    diff = sum(int(np.sum(a != b)) for a, b, r in zip(got, want, mask) if r)
    total = sum(a.size for a, r in zip(got, mask) if r)
    return diff / total


def test_bf16_grad_cast_points_match_jax_bit_for_bit(jax_refs):
    """JAX's bf16 stack gradients (3 blocks + LN) and the port's round at
    the same points: at most MISMATCH of the rounded gradients' elements
    differ at all (measured: 0.03%). The port's float32 backward, rounded to
    bf16 where the bf16 backward rounds, differs in more than that
    (measured: 78%)."""
    kind, approx, x, g, flat = case_inputs(BIT_CASE)
    want, mask = jax_refs[BIT_CASE], rounded_mask(kind)
    share = differing_share(port_grads(kind, x, g, flat, approx), want, mask)
    assert share <= MISMATCH, share
    f32 = port_grads(kind, x, g, flat, approx, torch.float32)
    control = [torch.from_numpy(a).to(torch.bfloat16).float().numpy() if r else a
               for a, r in zip(f32, mask)]
    c_share = differing_share(control, want, mask)
    assert c_share > MISMATCH, c_share
