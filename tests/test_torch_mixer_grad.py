"""Gradients and dropout of the port's fused-mixer wrappers, on the CPU.

On the CPU the wrappers' ``torch.autograd.Function``s run the plain version
forward and differentiate it backward (the CUDA kernels K1b/K2b run only on
the card; tests/test_torch_cuda_kernels.py holds them there). The JAX side
runs the Pallas kernels and their backward kernels in interpret mode, as its
own tests do. Tolerance: float32 5e-5 absolute (same math, other summation
order, and the TPU kernel's A&S erf within 1.5e-7 of exact erf).

The dropout masks cannot match the JAX kernels' (those come from the TPU's
PRNG), so they are checked for what they promise: they depend only on
(seed, block, mask, element), the forward and the backward apply the same
one, and the keep share is 1 - rate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2mixer_tpu.modules.common import set_gelu_approximate
from m2mixer_tpu.ops import mixer_kernel as jk
from m2mixer_tpu_torch.modules import pallas_blocks as pb
from m2mixer_tpu_torch.modules.common import Dropout, DropoutRNG, set_dropout_rng
from m2mixer_tpu_torch.ops import mixer_kernel as tk

SMALL = dict(N=4, D=32, T=16, C=64)
# widths that are no multiple of 4 (C: the CUDA kernel pads its rows of C to
# whole 16-byte groups) nor of the TPU's tiles
ODD_WIDTHS = dict(N=3, D=20, T=7, C=46)
ATOL = 5e-5


def case(seed, B, K, N, D, T, C):
    rng = np.random.RandomState(seed)
    u = lambda fan, *shape: (rng.uniform(-1, 1, shape) / np.sqrt(fan)).astype(np.float32)
    ln = lambda: [(1 + 0.1 * rng.randn(D)).astype(np.float32),
                  (0.1 * rng.randn(D)).astype(np.float32)]
    blocks = [[*ln(), u(N, N, T), u(N, T), u(T, T, N), u(T, N), *ln(), u(D, D, C), u(D, C),
               u(C, C, D), u(C, D)] for _ in range(K)]
    x = rng.randn(B, N, D).astype(np.float32)
    g = rng.randn(B, N, D).astype(np.float32)
    return x, g, blocks, ln()


def jax_grads(fn, x, g, flat, approx):
    prev = set_gelu_approximate(approx)
    try:
        gx, gp = jax.grad(lambda x, p: jnp.sum(fn(x, p) * jnp.asarray(g)), argnums=(0, 1))(
            jnp.asarray(x), tuple(map(jnp.asarray, flat)))
    finally:
        set_gelu_approximate(prev)
    return [np.asarray(gx)] + [np.asarray(a) for a in gp]


def torch_grads(fn, x, g, flat):
    xt = torch.from_numpy(x).requires_grad_()
    pt = [torch.from_numpy(a).requires_grad_() for a in flat]
    out = fn(xt, pt)
    assert out.grad_fn is not None and "Fn" in type(out.grad_fn).__name__
    (out * torch.from_numpy(g)).sum().backward()
    return [xt.grad.numpy()] + [p.grad.numpy() for p in pt]


def assert_grads_close(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        err = float(np.max(np.abs(a - b)))
        assert err <= ATOL, (i, err)


@pytest.mark.parametrize("shape", ["small", "odd_widths"])
@pytest.mark.parametrize("gelu", ["erf", "tanh"])
@pytest.mark.parametrize("fn", ["block", "stack", "grouped"])
def test_grads_match_jax(fn, gelu, shape):
    approx = gelu == "tanh"
    geom = SMALL if shape == "small" else ODD_WIDTHS
    x, g, blocks, ln = case(1, 4, 3 if fn == "grouped" else 2, **geom)
    if fn == "block":
        flat = blocks[0]
        jf = lambda x, p: jk.fused_mixer_block(x, jk.MixerBlockParams(*p))
        tf = lambda x, p: tk.fused_mixer_block(x, tk.MixerBlockParams(*p), approximate_gelu=approx)
    elif fn == "stack":
        flat = [a for b in blocks for a in b] + ln
        jf = lambda x, p: jk.fused_mixer_stack(x, p)
        tf = lambda x, p: tk.fused_mixer_stack(x, p, approximate_gelu=approx)
    else:
        flat = [a for b in blocks for a in b] + ln

        def split(p, mod):
            return [mod.MixerBlockParams(*p[i:i + 12]) for i in range(0, 36, 12)], p[36], p[37]

        jf = lambda x, p: jk.fused_mixer_stack_grouped(x, *split(p, jk), group_size=2)
        tf = lambda x, p: tk.fused_mixer_stack_grouped(x, *split(p, tk), group_size=2,
                                                       approximate_gelu=approx)
    assert_grads_close(torch_grads(tf, x, g, flat), jax_grads(jf, x, g, flat, approx))


@pytest.mark.parametrize("mask", [0, 1, 2, 3])
def test_masks_depend_only_on_seed_block_mask_and_element(mask):
    """A batch-4 mask is the prefix of the batch-8 one; block, mask id and
    seed each change it."""
    small = tk.block_masks(7, 1, 4, 4, 32, 16, 64, 0.5)[mask]
    big = tk.block_masks(7, 1, 8, 4, 32, 16, 64, 0.5)[mask]
    assert torch.equal(big[:small.shape[0]], small)
    for other in (tk.block_masks(8, 1, 4, 4, 32, 16, 64, 0.5)[mask],
                  tk.block_masks(7, 2, 4, 4, 32, 16, 64, 0.5)[mask],
                  tk.block_masks(7, 1, 4, 4, 32, 16, 64, 0.5)[(mask + 1) % 4]):
        assert other.shape != small.shape or not torch.equal(other, small)


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
def test_keep_share_and_scale(rate):
    m = tk.dropout_mask(11, 0, 2, 256, 640, rate)
    assert abs((m > 0).float().mean().item() - (1 - rate)) <= 0.02
    assert set(m.unique().tolist()) == {0.0, float(np.float32(1 / (1 - rate)))}


def test_hash_matches_its_integer_definition():
    """The tensor hash (16-bit limbs, no int64 overflow) equals the uint32
    arithmetic the CUDA kernels do, including keys and indices near 2**32."""
    e = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], dtype=torch.int64)
    key = tk.mask_key(2**31 - 2, 31, 3)
    got = tk._fmix32(tk._mul32(e, tk._GOLDEN) ^ key).tolist()
    want = [tk._fmix32_int(((int(i) * tk._GOLDEN) & tk._M32) ^ key) for i in e.tolist()]
    assert got == want


def test_forward_and_backward_apply_the_same_mask():
    """One token of one sample: where mask 2 drops hidden unit c, W4's row c
    and b3[c] get exactly zero gradient, and the forward equals the plain
    version with the same seed."""
    x, g, blocks, _ = case(2, 1, 1, N=1, D=32, T=16, C=256)
    p = tk.MixerBlockParams(*(torch.from_numpy(a).requires_grad_() for a in blocks[0]))
    out = tk.fused_mixer_block(torch.from_numpy(x), p, seed=5, dropout_rate=0.5)
    with torch.no_grad():
        torch.testing.assert_close(out, tk.mixer_block_reference(torch.from_numpy(x), p, 0.5,
                                                                 seed=5), rtol=0, atol=0)
    (out * torch.from_numpy(g)).sum().backward()
    m2 = tk.dropout_mask(5, 0, 2, 1, 256, 0.5)[0] > 0
    assert 0 < int(m2.sum()) < 256
    assert torch.all(p.w4.grad[~m2] == 0) and torch.all(p.b3.grad[~m2] == 0)
    assert torch.all(p.w4.grad[m2].abs().sum(dim=1) > 0)


def test_stack_blocks_draw_their_own_masks():
    """Block k of a stack draws the masks of block k: the stack equals the
    plain blocks chained with block indices 0, 1."""
    x, _, blocks, ln = case(3, 2, 2, **SMALL)
    tb = [tk.MixerBlockParams(*map(torch.from_numpy, b)) for b in blocks]
    flat = tk.stack_flat_params(tb)
    got = tk.fused_mixer_stack(torch.from_numpy(x), flat, seed=9, dropout_rate=0.3,
                               final_ln=False)
    y = torch.from_numpy(x)
    for k, p in enumerate(tb):
        y = tk._block_math(y, p, torch.float32, False, tk._masks_for(y, p, 9, k, 0.3))
    torch.testing.assert_close(got, y, rtol=0, atol=0)


def test_bf16_backward_raises_on_cpu():
    """The bf16 backward no longer raises: on the CPU it is autograd of the
    plain bf16 version, float32 gradients for float32 parameters, with w3's
    and w4's rounded to bf16 (the transpose of their cast) and the biases'
    not (tests/test_torch_mixer_bf16_grad.py holds it to JAX)."""
    x, g, blocks, _ = case(4, 2, 1, **SMALL)
    p = tk.MixerBlockParams(*map(torch.from_numpy, blocks[0]))
    dx, grads = tk.fused_mixer_block_bwd(torch.from_numpy(x), torch.from_numpy(g), p,
                                         compute_dtype=torch.bfloat16)
    assert all(t.dtype == torch.float32 for t in (dx, *grads))
    on_grid = lambda t: torch.equal(t, t.to(torch.bfloat16).float())
    assert on_grid(dx) and on_grid(grads[8]) and on_grid(grads[10])
    assert not on_grid(grads[9])
    want = tk.fused_mixer_block_bwd(torch.from_numpy(x), torch.from_numpy(g), p)[1][8]
    assert 0 < (grads[8] - want).abs().max().item() <= 2e-2 * want.abs().max().item()


def kernel_module(kind, dropout=0.0):
    gen = torch.Generator().manual_seed(0)
    if kind == "PallasMixerBlock":
        return pb.PallasMixerBlock(32, 4, 16, 64, dropout, generator=gen), torch.randn(5, 4, 32)
    if kind == "PallasStackedFusionMixer":
        return (pb.PallasStackedFusionMixer(32, 8, 2, 16, 64, dropout, generator=gen),
                torch.randn(5, 8, 32))
    return (getattr(pb, kind)(1, 32, 14, (28, 28), 2, 16, 64, dropout, generator=gen),
            torch.randn(5, 1, 28, 28))


@pytest.mark.parametrize("kind", ["PallasMixerBlock", "PallasMLPMixer", "PallasStackedMLPMixer",
                                  "PallasStackedFusionMixer"])
def test_kernel_modules_train(kind):
    """In training mode every parameter of a kernel-backed module gets a
    non-zero gradient through the wrappers' autograd.Function."""
    m, x = kernel_module(kind)
    m.train()
    m(x).square().sum().backward()
    for name, prm in m.named_parameters():
        assert prm.grad is not None and prm.grad.abs().sum().item() > 0, name


@pytest.mark.parametrize("kind", ["PallasMixerBlock", "PallasStackedMLPMixer"])
def test_kernel_modules_draw_a_seed_per_call(kind):
    """Training mode: a fresh kernel seed per call from the module's
    DropoutRNG (two calls differ), reproducible from the RNG's seed; eval
    mode drops nothing."""
    m, x = kernel_module(kind, dropout=0.5)
    m.train()
    set_dropout_rng(m, DropoutRNG(3))
    with torch.no_grad():
        a, b = m(x), m(x)
        set_dropout_rng(m, DropoutRNG(3))
        assert not torch.equal(a, b) and torch.equal(m(x), a)
        m.eval()
        assert torch.equal(m(x), m(x))


@pytest.mark.parametrize("bits", [False, True], ids=["bernoulli", "bits"])
@pytest.mark.parametrize("rate", [0.001, 0.5, 0.999])
def test_dropout_flavors(bits, rate):
    """The bernoulli flavor keeps 1 - rate at scale 1/(1 - rate); the bits
    flavor quantizes the drop probability to thresh/256 with thresh =
    clamp(round(rate * 256), 1, 255), zeros at rate >= 255.5/256 (JAX
    common.py:135-177)."""
    d = Dropout(rate, bits=bits).train()
    d.dropout_rng = DropoutRNG(0)
    y = d(torch.ones(400_000))
    if bits and rate >= 255.5 / 256:
        assert torch.all(y == 0)
        return
    p_drop = min(max(round(rate * 256), 1), 255) / 256 if bits else rate
    kept = y[y != 0]
    assert abs(kept.numel() / y.numel() - (1 - p_drop)) <= 0.005
    torch.testing.assert_close(kept, torch.full_like(kept, 1 / (1 - p_drop)))
    assert torch.equal(d.eval()(torch.ones(8)), torch.ones(8))
