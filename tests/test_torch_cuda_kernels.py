"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they skip without a CUDA device (this file imports no JAX,
so it runs on a machine with only PyTorch):

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerances as in chip_smoke.py: float32 1e-4 absolute (same float32
products summed in another order; TF32 off); bf16 outputs on the bf16 grid,
at most 10% of them differing from the plain version (same rounding points:
only a sum on the other side of a rounding boundary differs, by one ulp,
and later blocks carry it), none by more than 2e-2 of the output's max
magnitude.
"""

import numpy as np
import pytest
import torch

from m2mixer_tpu_torch.config import loads
from m2mixer_tpu_torch.ops import _build
from m2mixer_tpu_torch.ops import dynamixer_kernel as dk
from m2mixer_tpu_torch.ops import gmlp_kernel as gk
from m2mixer_tpu_torch.ops import mixer_kernel as mk

pytestmark = pytest.mark.gpu

SHAPES = {"small": dict(N=4, D=32, T=16, C=64), "encoder": dict(N=4, D=128, T=32, C=3072),
          "fusion": dict(N=8, D=128, T=32, C=3078)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def blocks_on(device, K, N, D, T, C, seed=0):
    g = torch.Generator().manual_seed(seed)
    u = lambda fan, *shape: (torch.rand(*shape, generator=g) * 2 - 1) / fan ** 0.5
    out = []
    for _ in range(K):
        p = (1 + 0.1 * torch.randn(D, generator=g), 0.1 * torch.randn(D, generator=g),
             u(N, N, T), u(N, T), u(T, T, N), u(T, N),
             1 + 0.1 * torch.randn(D, generator=g), 0.1 * torch.randn(D, generator=g),
             u(D, D, C), u(D, C), u(C, C, D), u(C, D))
        out.append(mk.MixerBlockParams(*(t.to(device) for t in p)))
    return out, torch.ones(D, device=device), torch.zeros(D, device=device)


def assert_close(got, want, bf16):
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= (2e-2 * want.abs().max().item() if bf16 else 1e-4), err
    if bf16:
        assert torch.equal(got, got.to(torch.bfloat16).float())
        share = (got != want).float().mean().item()
        assert share <= 0.10, share


@pytest.mark.parametrize("approx", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("B", [3, 64])
def test_block_kernel_matches_plain(cuda, B, shape, dtype, approx):
    geom = SHAPES[shape]
    blocks, _, _ = blocks_on(cuda, 1, **geom)
    x = torch.randn(B, geom["N"], geom["D"], device=cuda)
    before = mk.fused_mixer_block.launches
    got = mk.fused_mixer_block(x, blocks[0], compute_dtype=dtype, approximate_gelu=approx)
    assert mk.fused_mixer_block.launches == before + 1
    want = mk.mixer_block_reference(x, blocks[0], compute_dtype=dtype, approximate_gelu=approx)
    assert_close(got, want, dtype == torch.bfloat16)


@pytest.mark.parametrize("group_size", [0, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_stack_kernel_matches_plain(cuda, shape, dtype, group_size):
    geom = SHAPES[shape]
    blocks, s, b = blocks_on(cuda, 3, **geom)
    x = torch.randn(37, geom["N"], geom["D"], device=cuda)
    before = mk.fused_mixer_stack.launches
    got = mk.fused_mixer_stack_grouped(x, blocks, s, b, compute_dtype=dtype,
                                       group_size=group_size)
    assert mk.fused_mixer_stack.launches == before + (1 if group_size == 0 else 2)
    want = mk.mixer_stack_reference(x, mk.stack_flat_params(blocks, s, b), compute_dtype=dtype)
    assert_close(got, want, dtype == torch.bfloat16)


def test_unsupported_shapes_raise_on_cuda(cuda):
    """No token cap (40 tokens launch) and no hidden-width rule (D = 30, no
    multiple of 4, runs padded); a stack of more than 32 blocks raises."""
    blocks, s, b = blocks_on(cuda, 1, N=40, D=32, T=8, C=64)
    x = torch.randn(2, 40, 32, device=cuda)
    assert_close(mk.fused_mixer_block(x, blocks[0]), mk.mixer_block_reference(x, blocks[0]),
                 False)
    with pytest.raises(ValueError, match="runs 1..32 blocks"):
        mk.fused_mixer_stack(x, mk.stack_flat_params(blocks * 33, s, b))
    odd, _, _ = blocks_on(cuda, 1, N=4, D=30, T=8, C=64)
    x = torch.randn(2, 4, 30, device=cuda)
    assert_close(mk.fused_mixer_block(x, odd[0]), mk.mixer_block_reference(x, odd[0]), False)


# hidden widths that are no multiple of 8 (bf16) or of 4 (float32, D = 30):
# the wrappers pad D, and the kernels take the true width for the LN
# statistics and the masks; "tok" runs the token FF as products (40 tokens)
WIDTH_SHAPES = {"d20": dict(N=4, D=20, T=8, C=64), "d30": dict(N=8, D=30, T=16, C=70),
                "d30_tok": dict(N=40, D=30, T=16, C=64)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", sorted(WIDTH_SHAPES))
def test_any_hidden_width_matches_plain(cuda, shape, dtype):
    """K1f, K2f (2 blocks + LN), K1b and K2b at a hidden width the kernels
    pad, dropout 0.5, against the plain versions and their autograd (float32:
    assert_close and rel_close; bf16: assert_close and bf16_grads_close, the
    stack's 40% share); two runs bit-identical."""
    geom = WIDTH_SHAPES[shape]
    blocks, s, b = blocks_on(cuda, 2, **geom)
    flat = mk.stack_flat_params(blocks, s, b)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(5, geom["N"], geom["D"], generator=gen).to(cuda)
    g = torch.randn(5, geom["N"], geom["D"], generator=gen).to(cuda)
    bf16 = dtype == torch.bfloat16
    got1 = mk.fused_mixer_block(x, blocks[0], 3, 0.5, dtype)
    got2 = mk.fused_mixer_stack(x, flat, 4, 0.5, dtype)
    assert_close(got1, mk.mixer_block_reference(x, blocks[0], 0.5, dtype, seed=3), bf16)
    assert_close(got2, mk.mixer_stack_reference(x, flat, dtype, dropout_rate=0.5, seed=4), bf16)
    assert torch.equal(got1, mk.fused_mixer_block(x, blocks[0], 3, 0.5, dtype))
    bwd1 = lambda: mk.fused_mixer_block_bwd(x, g, blocks[0], 3, 0.5, dtype)
    bwd2 = lambda: mk.fused_mixer_stack_bwd(x, g, flat, 4, 0.5, dtype)
    for run, want, share in ((bwd1, mk.mixer_block_bwd_reference(x, g, blocks[0], 0.5, dtype,
                                                                  seed=3), 0.10),
                             (bwd2, mk.mixer_stack_bwd_reference(x, g, flat, 0.5, dtype,
                                                                  seed=4), 0.40)):
        dx, grads = run()
        assert dx.shape == x.shape and [t.shape for t in grads] == [t.shape for t in want[1]]
        if bf16:
            rounded = BF16_ROUNDED * (len(grads) // 12) + (True,) * (len(grads) % 12)
            bf16_grads_close((dx, *grads), (want[0], *want[1]), (True, *rounded), share)
        else:
            rel_close(dx, want[0])
            for a, w in zip(grads, want[1]):
                rel_close(a, w)
        dx2, grads2 = run()
        assert torch.equal(dx, dx2) and all(torch.equal(a, c) for a, c in zip(grads, grads2))


def test_served_kernel_model_matches_plain_on_cuda(cuda):
    from m2mixer_tpu_torch.serving import _build_task, serve_fn, to_torch_kernel_serving

    cfg = loads("""
model:
  type: AVMnistMixerMultiLoss
  modalities:
    classification: {num_classes: 10}
    image: {block_type: MLPMixer, in_channels: 1, hidden_dim: 32, patch_size: 14,
            image_size: [28, 28], token_dim: 16, channel_dim: 64, num_mixers: 2}
    audio: {block_type: MLPMixer, in_channels: 1, hidden_dim: 32, patch_size: 56,
            image_size: [112, 112], token_dim: 16, channel_dim: 64, num_mixers: 2}
    multimodal: {block_type: FusionMixer, fusion_function: ConcatFusion, hidden_dim: 32,
                 token_dim: 16, channel_dim: 64, num_mixers: 2}
""")
    plain = _build_task(cfg, device=cuda)
    rng = np.random.RandomState(0)
    feats = {"image": torch.from_numpy(rng.rand(9, 1, 28, 28).astype(np.float32)).to(cuda),
             "audio": torch.from_numpy(rng.rand(9, 1, 112, 112).astype(np.float32)).to(cuda)}
    want = serve_fn(plain)(feats)["logits"]
    for per_block in (False, True):
        kernel, _ = to_torch_kernel_serving(cfg, plain.network.state_dict(), device=cuda,
                                            per_block=per_block)
        counts = (mk.fused_mixer_block.launches, mk.fused_mixer_stack.launches)
        got = serve_fn(kernel)(feats)["logits"]
        assert (mk.fused_mixer_block.launches, mk.fused_mixer_stack.launches) != counts
        assert (got - want).abs().max().item() <= 1e-4


# ------------------------------------------------------------------ training
def rel_close(got, want):
    """1e-4 x max(1, max|plain|) per tensor: float32 sums of the same products
    in another order (K up to C = 3078 or B*N rows)."""
    assert torch.isfinite(got).all()
    tol = 1e-4 * max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    assert err <= tol, (err, tol)


def plain_grouped(x, blocks, s, b, seed, rate, group_size):
    """The plain version of fused_mixer_stack_grouped, group seeds folded."""
    k = len(blocks)
    if group_size <= 0 or group_size >= k:
        return mk.mixer_stack_reference(x, mk.stack_flat_params(blocks, s, b),
                                        dropout_rate=rate, seed=seed)
    for gi, start in enumerate(range(0, k, group_size)):
        group = blocks[start:start + group_size]
        last = start + len(group) >= k
        flat = mk.stack_flat_params(group, s, b) if last else mk.stack_flat_params(group)
        x = mk.mixer_stack_reference(x, flat, final_ln=last, dropout_rate=rate,
                                     seed=seed + 7919 * gi)
    return x


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("approx", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("B", [3, 64])
def test_block_backward_matches_plain(cuda, B, shape, approx, rate):
    geom = SHAPES[shape]
    blocks, _, _ = blocks_on(cuda, 1, **geom)
    x = torch.randn(B, geom["N"], geom["D"], device=cuda)
    g = torch.randn_like(x)
    before = mk.fused_mixer_block_bwd.launches
    dx, grads = mk.fused_mixer_block_bwd(x, g, blocks[0], seed=5, dropout_rate=rate,
                                         approximate_gelu=approx)
    assert mk.fused_mixer_block_bwd.launches == before + 1
    want_dx, want = mk.mixer_block_bwd_reference(x, g, blocks[0], rate, approximate_gelu=approx,
                                                 seed=5)
    rel_close(dx, want_dx)
    for a, b in zip(grads, want):
        rel_close(a, b)
    dx2, grads2 = mk.fused_mixer_block_bwd(x, g, blocks[0], seed=5, dropout_rate=rate,
                                           approximate_gelu=approx)
    assert torch.equal(dx, dx2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("group_size", [0, 2])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_stack_backward_matches_plain(cuda, shape, group_size, rate):
    geom = SHAPES[shape]
    blocks, s, b = blocks_on(cuda, 3, **geom)
    leaves = [t.requires_grad_() for blk in blocks for t in blk] + [s.requires_grad_(),
                                                                    b.requires_grad_()]
    x = torch.randn(37, geom["N"], geom["D"], device=cuda, requires_grad=True)
    g = torch.randn(37, geom["N"], geom["D"], device=cuda)
    before = (mk.fused_mixer_stack.launches, mk.fused_mixer_stack_bwd.launches)
    out = mk.fused_mixer_stack_grouped(x, blocks, s, b, seed=9, dropout_rate=rate,
                                       group_size=group_size)
    got = torch.autograd.grad(out, [x, *leaves], g)
    n = 1 if group_size == 0 else 2
    assert (mk.fused_mixer_stack.launches, mk.fused_mixer_stack_bwd.launches) == \
        (before[0] + n, before[1] + n)
    want_out = plain_grouped(x, blocks, s, b, 9, rate, group_size)
    rel_close(out.detach(), want_out.detach())
    want = torch.autograd.grad(want_out, [x, *leaves], g)
    for a, w in zip(got, want):
        rel_close(a, w)


# (batch, shape) at the edges of K1b/K2b's tensor-core products: rows that
# fill no whole tile, C that is no multiple of 4 (rows of h2, da3 and W3
# padded to 16-byte groups), the fusion shape in one row tile, the most
# tokens the kernels take, and more rows than one weight-gradient slice
MIXER_TC_CASES = {
    "ragged_rows": (37, SHAPES["encoder"]),
    "odd_widths": (5, dict(N=3, D=20, T=7, C=46)),
    "fusion_one_tile": (3, SHAPES["fusion"]),
    "max_tokens": (9, dict(N=32, D=32, T=16, C=64)),
    "row_slices": (600, dict(N=8, D=32, T=16, C=64)),
}


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("case", sorted(MIXER_TC_CASES))
def test_mixer_backward_tensor_core_edges(cuda, case, rate):
    """K1b, and K2b as 2 blocks + LN, against autograd of the plain versions;
    every tensor within 1e-4 x max(1, max|plain|), two runs bit-identical."""
    from m2mixer_tpu_torch.ops._build import load_library

    B, geom = MIXER_TC_CASES[case]
    blocks, s, b = blocks_on(cuda, 2, **geom)
    x = torch.randn(B, geom["N"], geom["D"], device=cuda)
    g = torch.randn_like(x)
    rows = B * geom["N"]
    rslice = load_library().m2m_mixer_row_slice(B, geom["N"], geom["T"], geom["D"], geom["C"], 0)
    assert 0 < rslice <= 2304
    if case == "row_slices":
        assert rslice < rows, (rslice, rows)
    k1b = lambda: mk.fused_mixer_block_bwd(x, g, blocks[0], seed=5, dropout_rate=rate)
    flat = mk.stack_flat_params(blocks, s, b)
    k2b = lambda: mk.fused_mixer_stack_bwd(x, g, flat, seed=6, dropout_rate=rate)
    for run, want in ((k1b, mk.mixer_block_bwd_reference(x, g, blocks[0], rate, seed=5)),
                      (k2b, mk.mixer_stack_bwd_reference(x, g, flat, rate, seed=6))):
        dx, grads = run()
        for a, w in zip((dx, *grads), (want[0], *want[1])):
            rel_close(a, w)
        dx2, grads2 = run()
        assert torch.equal(dx, dx2) and all(torch.equal(a, c) for a, c in zip(grads, grads2))


FWD_SHAPES = {"odd_widths": dict(N=3, D=20, T=7, C=46), "encoder": SHAPES["encoder"],
              "fusion": SHAPES["fusion"]}


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("B", [1, 7, 600])
@pytest.mark.parametrize("shape", sorted(FWD_SHAPES))
def test_forward_tensor_core_edges(cuda, shape, B, rate):
    """K1f, and K2f as 2 blocks + LN, in float32 (the channel FF on the
    3xTF32 tile) against the plain versions where the tiles have ragged
    edges: odd widths (C = 46 padded to 48), one sample, 600 samples (more
    rows than the batch-512 plans); two runs bit-identical."""
    geom = FWD_SHAPES[shape]
    blocks, s, b = blocks_on(cuda, 2, **geom)
    x = torch.randn(B, geom["N"], geom["D"], device=cuda)
    flat = mk.stack_flat_params(blocks, s, b)
    check = (lambda got, want: assert_close(got, want, False)) if rate == 0 else rel_close
    before = (mk.fused_mixer_block.launches, mk.fused_mixer_stack.launches)
    k1f = lambda: mk.fused_mixer_block(x, blocks[0], seed=3, dropout_rate=rate)
    k2f = lambda: mk.fused_mixer_stack(x, flat, seed=4, dropout_rate=rate)
    for run, want in ((k1f, mk.mixer_block_reference(x, blocks[0], rate, seed=3)),
                      (k2f, mk.mixer_stack_reference(x, flat, dropout_rate=rate, seed=4))):
        out = run()
        check(out, want)
        assert torch.equal(out, run())
    assert (mk.fused_mixer_block.launches, mk.fused_mixer_stack.launches) == \
        (before[0] + 2, before[1] + 2)


@pytest.mark.parametrize("shape", sorted(FWD_SHAPES))
def test_stack_saved_slots_chain_block_outputs(cuda, shape):
    """K2f's saved slots (what K2b reads) are x and then, bit for bit, the
    outputs of K1f called block after block; its output is the plain final LN
    of the last one."""
    geom = FWD_SHAPES[shape]
    blocks, s, b = blocks_on(cuda, 3, **geom)
    x = torch.randn(7, geom["N"], geom["D"], device=cuda)
    flat = mk.stack_flat_params(blocks, s, b)
    out, saved = mk._stack_forward(x, flat, None, 0.0, torch.float32, True, False, save=True)
    chain = [x]
    for blk in blocks:
        chain.append(mk.fused_mixer_block(chain[-1], blk))
    assert saved.shape == (4, *x.shape)
    for k, want in enumerate(chain):
        assert torch.equal(saved[k], want), k
    rows = chain[-1].reshape(-1, geom["D"])
    want = torch.nn.functional.layer_norm(rows, (geom["D"],), s, b, 1e-5).reshape(x.shape)
    assert_close(out, want, False)


def test_forward_workspace_matches_the_mirror(cuda):
    """m2m_mixer_fwd_workspace_bytes against tests/test_torch_mixer_fwd_plan.py's
    Python mirror of its plan, on this card's SM count."""
    from m2mixer_tpu_torch.ops._build import load_library
    from test_torch_mixer_fwd_plan import (B_BF16_PLANS, PLANS, TOKEN_BF16_PLANS,
                                           fwd_workspace_floats)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = load_library()
    shapes = [shape for shape, _, _ in PLANS.values()] + [
        (b, n, 32, 128, 3072 if n == 4 else 3078, 1) for n, b in B_BF16_PLANS] + [
        (*shape, 2) for shape in TOKEN_BF16_PLANS] + [(7, 4, 16, 20, 64, 1), (7, 40, 16, 36, 64, 1)]
    for shape in shapes:
        for bf16 in (0, 1):
            assert lib.m2m_mixer_fwd_workspace_bytes(*shape, bf16, 0) == \
                4 * fwd_workspace_floats(*shape, bf16, sms=sms), (shape, bf16)


@pytest.mark.parametrize("shape", ["encoder", "fusion"])
def test_dropout_forward_matches_plain_and_keeps_half(cuda, shape):
    geom = SHAPES[shape]
    blocks, s, b = blocks_on(cuda, 2, **geom)
    x = torch.randn(64, geom["N"], geom["D"], device=cuda)
    rel_close(mk.fused_mixer_block(x, blocks[0], seed=3, dropout_rate=0.5),
              mk.mixer_block_reference(x, blocks[0], 0.5, seed=3))
    flat = mk.stack_flat_params(blocks, s, b)
    rel_close(mk.fused_mixer_stack(x, flat, seed=4, dropout_rate=0.5),
              mk.mixer_stack_reference(x, flat, dropout_rate=0.5, seed=4))
    m = mk.dropout_mask(3, 0, 2, 64 * geom["N"], geom["C"], 0.5, cuda)
    assert abs((m > 0).float().mean().item() - 0.5) <= 0.01


# which of a block's 12 gradients bf16 compute rounds to bf16 (a cast's
# transpose): all but the biases b1..b4, which add in float32
BF16_ROUNDED = (True, True, True, False, True, False, True, True, True, False, True, False)


def bf16_grads_close(got, want, rounded, share_limit, dead=()):
    """bf16-compute gradients: each within 2e-2 x max(1, max|plain|); those a
    cast rounds on the bf16 grid, and of all their elements at most
    ``share_limit`` differing from the plain version's. The limits are
    chip_smoke.py's (``BF16_GRAD_SHARE``, with the measurements behind them):
    a reduction over upstream values that each may sit one ulp off rounds to
    the other neighbour now and then, the tile's float32 accumulation is
    less exact than cuBLAS's, and through a stack of blocks that compounds.
    A gradient exactly zero in the math (``dead``) is bf16 rounding noise on
    both sides: both within 2e-2 x the largest gradient (chip_smoke.py)."""
    diff = total = 0
    dead = tuple(dead) or (False,) * len(want)
    scale = max(w.abs().max().item() for w in want)
    for a, w, r, d in zip(got, want, rounded, dead):
        assert torch.isfinite(a).all() and a.dtype == torch.float32
        if d:
            assert max(a.abs().max().item(), w.abs().max().item()) <= 2e-2 * scale
            continue
        err = (a - w).abs().max().item()
        assert err <= 2e-2 * max(1.0, w.abs().max().item()), err
        if r:
            assert torch.equal(a, a.to(torch.bfloat16).float())
            diff += int((a != w).sum())
            total += a.numel()
    assert diff / total <= share_limit, diff / total


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("approx", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("B", [3, 64])
def test_bf16_block_backward_matches_plain(cuda, B, shape, approx, rate):
    """K1b in bf16 compute (float32 parameters, w3/w4 read rounded to bf16)
    against autograd of the plain bf16 version; float32 gradients, rounded
    where JAX's AD rounds them; two runs bit-identical."""
    geom = SHAPES[shape]
    blocks, _, _ = blocks_on(cuda, 1, **geom)
    gen = torch.Generator().manual_seed(B)
    x = torch.randn(B, geom["N"], geom["D"], generator=gen).to(cuda)
    g = torch.randn(B, geom["N"], geom["D"], generator=gen).to(cuda)
    run = lambda: mk.fused_mixer_block_bwd(x, g, blocks[0], seed=5, dropout_rate=rate,
                                           compute_dtype=torch.bfloat16, approximate_gelu=approx)
    before = (mk.fused_mixer_block_bwd.launches, mk.fused_mixer_block_bwd.bf16_launches)
    dx, grads = run()
    assert (mk.fused_mixer_block_bwd.launches, mk.fused_mixer_block_bwd.bf16_launches) == \
        (before[0] + 1, before[1] + 1)
    want_dx, want = mk.mixer_block_bwd_reference(x, g, blocks[0], rate, torch.bfloat16, approx,
                                                 seed=5)
    bf16_grads_close((dx, *grads), (want_dx, *want), (True, *BF16_ROUNDED), 0.10)
    dx2, grads2 = run()
    assert torch.equal(dx, dx2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("group_size", [0, 2])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bf16_stack_backward_matches_plain(cuda, shape, group_size, rate):
    """K2f/K2b in bf16 compute through autograd, 3 blocks + LN, against
    autograd of the plain bf16 version."""
    geom = SHAPES[shape]
    blocks, s, b = blocks_on(cuda, 3, **geom)
    leaves = [t.requires_grad_() for blk in blocks for t in blk] + [s.requires_grad_(),
                                                                    b.requires_grad_()]
    gen = torch.Generator().manual_seed(37)
    x = torch.randn(37, geom["N"], geom["D"], generator=gen).to(cuda).requires_grad_()
    g = torch.randn(37, geom["N"], geom["D"], generator=gen).to(cuda)
    before = mk.fused_mixer_stack_bwd.launches
    out = mk.fused_mixer_stack_grouped(x, blocks, s, b, seed=9, dropout_rate=rate,
                                       compute_dtype=torch.bfloat16, group_size=group_size)
    got = torch.autograd.grad(out, [x, *leaves], g)
    assert mk.fused_mixer_stack_bwd.launches == before + (1 if group_size == 0 else 2)
    flat = mk.stack_flat_params(blocks, s, b)
    want_out = mk.mixer_stack_reference(x, flat, torch.bfloat16, dropout_rate=rate, seed=9) \
        if group_size == 0 else None
    if want_out is None:  # the grouped launches' seeds, as plain_grouped folds them
        y = x
        for gi, start in enumerate(range(0, 3, group_size)):
            group = blocks[start:start + group_size]
            last = start + len(group) >= 3
            gflat = mk.stack_flat_params(group, s, b) if last else mk.stack_flat_params(group)
            y = mk.mixer_stack_reference(y, gflat, torch.bfloat16, final_ln=last,
                                         dropout_rate=rate, seed=9 + 7919 * gi)
        want_out = y
    want = torch.autograd.grad(want_out, [x, *leaves], g)
    b2 = tuple(i == 5 and rate == 0.0 for i in range(12))  # zero in the math at rate 0
    bf16_grads_close(got, want, (True, *(BF16_ROUNDED * 3), True, True), 0.40,
                     dead=(False, *(b2 * 3), False, False))


def test_backward_workspace_matches_the_mirror(cuda):
    """m2m_mixer_bwd_workspace_bytes against tests/test_torch_mixer_bwd_plan.py's
    Python mirror of its plan, float32 and bf16, on this card's SM count."""
    from m2mixer_tpu_torch.ops._build import load_library
    from test_torch_mixer_bwd_plan import GEOMS, PLANS, bwd_workspace_floats

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = load_library()
    for geom, B, K, ln in PLANS:
        g = GEOMS[geom]
        dims = (B, g["N"], g["T"], g["D"], g["C"], K, ln)
        for bf16 in (0, 1):
            assert lib.m2m_mixer_bwd_workspace_bytes(*dims, bf16, 0) == \
                4 * bwd_workspace_floats(*dims, bf16, sms=sms), (dims, bf16)


# bf16 K1b and K2b (one block + LN) with their channel products on the wgmma
# engine: the L config's fusion shape, and ragged batches at the B fusion
# shape (C = 3078: Cp = 3080; one sample; more rows than the batch-512 plans)
BF16_WG_CASES = {"l_fusion_B32": (32, dict(N=80, D=512, T=256, C=4096)),
                 "fusion_B1": (1, SHAPES["fusion"]), "fusion_B7": (7, SHAPES["fusion"]),
                 "fusion_B600": (600, SHAPES["fusion"])}


@pytest.mark.parametrize("case", sorted(BF16_WG_CASES))
def test_bf16_backward_on_the_wgmma_engine(cuda, case):
    """bf16 K1b and K2b against autograd of the plain bf16 versions at dropout
    0.5 and tanh GELU (bf16_grads_close: 10% / 40% of the rounded elements),
    each counted as a bf16 launch; two runs give bit-identical gradients."""
    B, geom = BF16_WG_CASES[case]
    blocks, s, b = blocks_on(cuda, 1, **geom)
    gen = torch.Generator().manual_seed(B)
    x = torch.randn(B, geom["N"], geom["D"], generator=gen).to(cuda)
    g = torch.randn(B, geom["N"], geom["D"], generator=gen).to(cuda)
    flat = mk.stack_flat_params(blocks, s, b)
    bf = torch.bfloat16
    k1b = lambda: mk.fused_mixer_block_bwd(x, g, blocks[0], 5, 0.5, bf, True)
    k2b = lambda: mk.fused_mixer_stack_bwd(x, g, flat, 6, 0.5, bf, True, True)
    runs = ((k1b, mk.mixer_block_bwd_reference(x, g, blocks[0], 0.5, bf, True, seed=5),
             (True, *BF16_ROUNDED), 0.10, mk.fused_mixer_block_bwd),
            (k2b, mk.mixer_stack_bwd_reference(x, g, flat, 0.5, bf, True, True, seed=6),
             (True, *BF16_ROUNDED, True, True), 0.40, mk.fused_mixer_stack_bwd))
    for run, want, rounded, share, wrapper in runs:
        before = wrapper.bf16_launches
        dx, grads = run()
        assert wrapper.bf16_launches == before + 1
        bf16_grads_close((dx, *grads), (want[0], *want[1]), rounded, share)
        dx2, grads2 = run()
        assert torch.equal(dx, dx2) and all(torch.equal(a, c) for a, c in zip(grads, grads2))


# (A K-major, B K-major, A's planes, B's planes): the layouts the bf16 route
# runs (a3 and dh2; dz; dW3 and dW4^T), at ragged M, N and K
WG_LAYOUTS = {"a3_dh2": (1, 0, 1, 1), "dz": (1, 1, 3, 1), "dW3": (0, 0, 1, 3),
              "dW4": (0, 0, 1, 1)}


@pytest.mark.parametrize("mnk", [(128, 128, 64), (300, 200, 333), (1000, 3080, 512),
                                 (2048, 80, 16)],
                         ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("layout", sorted(WG_LAYOUTS))
def test_wgmma_engine_products_match_float64(cuda, layout, mnk):
    """The wgmma engine alone (m2m_wg_product): the sum over the planes of
    A_t B_t against the float64 product of the same bf16 values, within 1e-5
    of the largest output (float32 sums of exact bf16 products)."""
    from m2mixer_tpu_torch.ops._build import load_library
    import ctypes

    a_k, b_k, ta, tb = WG_LAYOUTS[layout]
    M, N, K = mnk
    gen = torch.Generator().manual_seed(M + N + K)

    def planes(x, t):  # a float32 value as t bf16 planes, largest first
        out, rest = [], x
        for _ in range(t):
            out.append(rest.to(torch.bfloat16))
            rest = rest - out[-1].float()
        return out

    def stored(p, transpose):  # row-major, rows padded to 16-byte groups
        p = (p.t() if transpose else p).contiguous()
        out = torch.zeros(p.shape[0], -(-p.shape[1] // 8) * 8, dtype=p.dtype)
        out[:, :p.shape[1]] = p
        return out.to(cuda)

    ap = planes(torch.randn(M, K, generator=gen), ta)
    bp = planes(torch.randn(K, N, generator=gen), tb)
    want = sum(p.double() for p in ap) @ sum(p.double() for p in bp)
    a = [stored(p, not a_k) for p in ap]
    b = [stored(p, bool(b_k)) for p in bp]
    out = torch.full((M, N), float("nan"), device=cuda)
    lib = load_library()
    code = lib.m2m_wg_product(a_k, b_k, ta, tb, M, N, K, 128,
                              (ctypes.c_void_p * 3)(*[t.data_ptr() for t in a]), a[0].shape[1],
                              (ctypes.c_void_p * 3)(*[t.data_ptr() for t in b]), b[0].shape[1],
                              out.data_ptr(), 0, torch.cuda.current_stream().cuda_stream)
    assert code == 0, lib.m2m_error_string(code)
    torch.cuda.synchronize()
    err = (out.cpu().double() - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


def test_bf16_kernel_modules_keep_float32_weights_on_cuda(cuda):
    """A bf16 kernel-backed stack trains float32 parameters on the card:
    every gradient float32 and non-zero, K2b launched."""
    from m2mixer_tpu_torch.modules import pallas_blocks as pb

    m = pb.PallasStackedFusionMixer(32, 8, 2, 16, 64, dtype=torch.bfloat16,
                                    generator=torch.Generator().manual_seed(0)).to(cuda).train()
    before = mk.fused_mixer_stack_bwd.launches
    m(torch.randn(5, 8, 32, device=cuda)).square().sum().backward()
    assert mk.fused_mixer_stack_bwd.launches == before + 1
    for name, prm in m.named_parameters():
        assert prm.dtype == torch.float32 and prm.grad.dtype == torch.float32, name
        assert prm.grad.abs().sum().item() > 0, name


@pytest.mark.parametrize("kind", ["PallasMixerBlock", "PallasMLPMixer", "PallasStackedMLPMixer",
                                  "PallasStackedFusionMixer"])
def test_kernel_modules_train_on_cuda(cuda, kind):
    """Every parameter of a kernel-backed module gets a non-zero gradient on
    the card, and the backward kernel ran."""
    from m2mixer_tpu_torch.modules import pallas_blocks as pb

    gen = torch.Generator().manual_seed(0)
    if kind == "PallasMixerBlock":
        m, x = pb.PallasMixerBlock(32, 4, 16, 64, generator=gen), torch.randn(5, 4, 32)
    elif kind == "PallasStackedFusionMixer":
        m, x = pb.PallasStackedFusionMixer(32, 8, 2, 16, 64, generator=gen), torch.randn(5, 8, 32)
    else:
        m = getattr(pb, kind)(1, 32, 14, (28, 28), 2, 16, 64, generator=gen)
        x = torch.randn(5, 1, 28, 28)
    m = m.to(cuda).train()
    before = mk.fused_mixer_block_bwd.launches + mk.fused_mixer_stack_bwd.launches
    m(x.to(cuda)).square().sum().backward()
    assert mk.fused_mixer_block_bwd.launches + mk.fused_mixer_stack_bwd.launches > before
    for name, prm in m.named_parameters():
        assert prm.grad is not None and prm.grad.abs().sum().item() > 0, name


# ---------------------------------------------------------------------- gMLP
# "narrow" is the CPU lockstep's width at the encoders' 49 tokens: there d sgu_w
# and d sgu_b (N^2 + N = 2450 floats) outnumber dW_in (D*F = 2048)
GMLP_SHAPES = {"small": dict(N=6, D=16, F=32), "narrow": dict(N=49, D=32, F=64),
               "fusion": dict(N=99, D=128, F=768)}


def gmlp_params_on(device, N, D, F, seed=0):
    """One gMLP block's parameters (JAX layout) at the modules' init scales,
    LN parameters jittered away from the identity."""
    g = torch.Generator().manual_seed(seed)
    H = F // 2
    u = lambda fan, *shape: (torch.rand(*shape, generator=g) * 2 - 1) / fan ** 0.5
    jit = lambda n, base: base + 0.1 * torch.randn(n, generator=g)
    p = (jit(D, 1.0), jit(D, 0.0), u(D, D, F), u(D, F), jit(H, 1.0), jit(H, 0.0),
         0.02 * torch.randn(N, N, generator=g), torch.ones(N), u(H, H, D), u(H, D))
    return gk.GmlpBlockParams(*(t.to(device) for t in p))


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("approx", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("shape", sorted(GMLP_SHAPES))
@pytest.mark.parametrize("B", [3, 33])
def test_gmlp_kernels_match_plain(cuda, B, shape, approx, rate):
    """K3f and K3b against the plain version and its autograd (the same
    masks), every tensor within 1e-4 x max(1, max|plain|); two backward runs
    bit-identical."""
    geom = GMLP_SHAPES[shape]
    p = gmlp_params_on(cuda, **geom)
    x = torch.randn(B, geom["N"], geom["D"], device=cuda)
    g = torch.randn_like(x)
    before = (gk.fused_gmlp_block.launches, gk.fused_gmlp_block_bwd.launches)
    out = gk.fused_gmlp_block(x, p, seed=5, dropout_rate=rate, approximate_gelu=approx)
    rel_close(out, gk.gmlp_block_reference(x, p, rate, approx, seed=5))
    dx, grads = gk.fused_gmlp_block_bwd(x, g, p, seed=5, dropout_rate=rate,
                                        approximate_gelu=approx)
    assert (gk.fused_gmlp_block.launches, gk.fused_gmlp_block_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    want_dx, want = gk.gmlp_block_bwd_reference(x, g, p, rate, approx, seed=5)
    rel_close(dx, want_dx)
    assert len(grads) == len(want) == 10
    for a, b in zip(grads, want):
        rel_close(a, b)
    dx2, grads2 = gk.fused_gmlp_block_bwd(x, g, p, seed=5, dropout_rate=rate,
                                          approximate_gelu=approx)
    assert torch.equal(dx, dx2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))


# K3b's tensor-core shapes: rows that are no multiple of the 128-row tile
# (37 x 49), widths that are no multiple of 8 or 16 (D = 20, F/2 = 22; F/2 =
# 20), and token counts padded to whole m16 tiles: 13 -> 16, 65 -> 80 (the
# 8-tile SGU kernel with 5 in use), 128 (no padding, the largest N of the
# shared-memory SGU); above it the large-N route: 129 tokens (ragged against
# every tile, rows of vt no whole 16 bytes) and 196 (the audio gMLP at patch 8)
GMLP_TC_SHAPES = {"encoder_ragged": dict(B=37, N=49, D=128, F=768),
                  "odd_widths": dict(B=5, N=13, D=20, F=44),
                  "n65": dict(B=3, N=65, D=24, F=40),
                  "n128": dict(B=2, N=128, D=16, F=48),
                  "n129": dict(B=3, N=129, D=24, F=40),
                  "n196": dict(B=2, N=196, D=32, F=64)}


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("shape", sorted(GMLP_TC_SHAPES))
def test_gmlp_backward_tensor_core_edges(cuda, shape, rate):
    """K3b against autograd of the plain version where the tensor-core tiles
    and the padded SGU have ragged edges, every tensor within 1e-4 x max(1,
    max|plain|); two runs bit-identical."""
    geom = dict(GMLP_TC_SHAPES[shape])
    B = geom.pop("B")
    p = gmlp_params_on(cuda, seed=1, **geom)
    x = torch.randn(B, geom["N"], geom["D"], device=cuda)
    g = torch.randn_like(x)
    run = lambda: gk.fused_gmlp_block_bwd(x, g, p, seed=11, dropout_rate=rate)
    dx, grads = run()
    want_dx, want = gk.gmlp_block_bwd_reference(x, g, p, rate, seed=11)
    for a, b in zip((dx, *grads), (want_dx, *want)):
        rel_close(a, b)
    dx2, grads2 = run()
    assert torch.equal(dx, dx2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("shape", sorted(GMLP_TC_SHAPES))
def test_gmlp_forward_tensor_core_edges(cuda, shape, rate):
    """K3f against the plain version where its tensor-core tiles and the padded
    SGU have ragged edges, within 1e-4 x max(1, max|plain|); two runs
    bit-identical."""
    geom = dict(GMLP_TC_SHAPES[shape])
    B = geom.pop("B")
    p = gmlp_params_on(cuda, seed=2, **geom)
    x = torch.randn(B, geom["N"], geom["D"], device=cuda)
    before = gk.fused_gmlp_block.launches
    out = gk.fused_gmlp_block(x, p, seed=13, dropout_rate=rate)
    assert gk.fused_gmlp_block.launches == before + 1
    rel_close(out, gk.gmlp_block_reference(x, p, rate, seed=13))
    assert torch.equal(out, gk.fused_gmlp_block(x, p, seed=13, dropout_rate=rate))


def tile_rows(M, N):
    """The tensor-core tile's rows that the C side's rule takes for an M x N
    product (one slice), and the rule's answer computed here: the 64x64 tile
    where the 128x64 one would give fewer CTAs than the card has SMs."""
    from m2mixer_tpu_torch.ops._build import load_library

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want = 64 if -(-M // 128) * -(-N // 64) < sms else 128
    return load_library().m2m_tc_tile_rows(M, N, 1, 0), want


# the forwards' products at the shapes that take each tile on an H100 (132 SMs):
# K3f at the encoder shape, B = 3 (both products on the 64x64 tile) and 512
# (both on the wide one); K4f at batch 32 (S = 224: 52 wide CTAs) and 512
FWD_TILE_CASES = {"gmlp_B3": ("gmlp", 3, 64), "gmlp_B512": ("gmlp", 512, 128),
                  "dyna_S224": ("dyna", 224, 64), "dyna_S3584": ("dyna", 3584, 128)}


@pytest.mark.parametrize("case", sorted(FWD_TILE_CASES))
def test_forward_tile_choice(cuda, case):
    """Each tile of the forwards' products runs, as the rule says, and the
    kernel agrees with its plain version there within 1e-4 x max(1,
    max|plain|)."""
    kind, n, rows = FWD_TILE_CASES[case]
    if kind == "gmlp":
        N, D, F = 49, 128, 768
        for M, cols in ((n * N, F), (n * N, D)):  # the in- and out-projection
            assert tile_rows(M, cols) == (rows, rows)
        p = gmlp_params_on(cuda, N, D, F, seed=3)
        x = torch.randn(n, N, D, device=cuda)
        rel_close(gk.fused_gmlp_block(x, p), gk.gmlp_block_reference(x, p))
    else:
        L, C, H, R = 7, 256, 8, 2
        assert tile_rows(n * L, C) == (rows, rows)
        p = dyna_params_on(cuda, L, C, H, R, seed=3)
        x = torch.randn(n, L, C, device=cuda)
        rel_close(dk.fused_dynamixer_op(x, p, H, R), dk.dynamixer_op_reference(x, p, H, R))


def test_gmlp_block_module_trains_on_cuda(cuda):
    """Every parameter of a PallasGatingMlpBlock gets a non-zero gradient on
    the card, through K3f and K3b."""
    from m2mixer_tpu_torch.modules import pallas_blocks as pb

    m = pb.PallasGatingMlpBlock(32, 64, 7, generator=torch.Generator().manual_seed(0))
    m = m.to(cuda).train()
    before = (gk.fused_gmlp_block.launches, gk.fused_gmlp_block_bwd.launches)
    m(torch.randn(5, 7, 32, device=cuda)).square().sum().backward()
    assert (gk.fused_gmlp_block.launches, gk.fused_gmlp_block_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    for name, prm in m.named_parameters():
        assert prm.grad is not None and prm.grad.abs().sum().item() > 0, name


def test_gmlp_kernels_raise_on_cuda(cuda):
    """What the kernels do not take raises: a compute dtype other than float32
    and bf16 (bf16 launches, counted apart), more tokens than sgu_w's N x N
    elements count in int (46340)."""
    p = gmlp_params_on(cuda, **GMLP_SHAPES["small"])
    x = torch.randn(2, 6, 16, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        gk.fused_gmlp_block(x, p, compute_dtype=torch.float16)
    before = gk.fused_gmlp_block.bf16_launches
    gk.fused_gmlp_block(x, p, compute_dtype=torch.bfloat16)
    assert gk.fused_gmlp_block.bf16_launches == before + 1
    with pytest.raises(ValueError, match="at most 46340 tokens"):
        gk.fused_gmlp_block(torch.randn(1, 46341, 16, device=cuda), p)


# the gMLP block in bf16 compute: which of dx and the 10 gradients a bf16 cast
# rounds (all but b_in, sgu_b and b_out, which add in float32)
GMLP_ROUNDED = (True, True, True, True, False, True, True, True, False, True, False)


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("approx", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("shape", sorted(GMLP_SHAPES) + sorted(GMLP_TC_SHAPES))
def test_gmlp_bf16_kernels_match_plain(cuda, shape, approx, rate):
    """bf16 K3f against the plain bf16 version (assert_close's bf16 check)
    and bf16 K3b against its autograd (bf16_grads_close, at most 10% of the
    rounded elements differing), float32 parameters rounded where JAX casts
    them; bf16 launches counted apart; two backward runs bit-identical."""
    geom = dict(GMLP_SHAPES.get(shape) or GMLP_TC_SHAPES[shape])
    B = geom.pop("B", 33)
    p = gmlp_params_on(cuda, seed=4, **geom)
    x = torch.randn(B, geom["N"], geom["D"], device=cuda)
    g = torch.randn_like(x)
    bf16 = torch.bfloat16
    before = (gk.fused_gmlp_block.bf16_launches, gk.fused_gmlp_block_bwd.bf16_launches)
    out = gk.fused_gmlp_block(x, p, seed=5, dropout_rate=rate, compute_dtype=bf16,
                              approximate_gelu=approx)
    assert_close(out, gk.gmlp_block_reference(x, p, rate, approx, seed=5, compute_dtype=bf16),
                 True)
    run = lambda: gk.fused_gmlp_block_bwd(x, g, p, seed=5, dropout_rate=rate,
                                          compute_dtype=bf16, approximate_gelu=approx)
    dx, grads = run()
    assert (gk.fused_gmlp_block.bf16_launches, gk.fused_gmlp_block_bwd.bf16_launches) == \
        (before[0] + 1, before[1] + 1)
    want_dx, want = gk.gmlp_block_bwd_reference(x, g, p, rate, approx, seed=5,
                                                 compute_dtype=bf16)
    bf16_grads_close((dx, *grads), (want_dx, *want), GMLP_ROUNDED, 0.10)
    dx2, grads2 = run()
    assert torch.equal(dx, dx2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))


def test_gmlp_bf16_block_module_trains_on_cuda(cuda):
    """A bf16 PallasGatingMlpBlock keeps float32 parameters on the card and
    gets a non-zero float32 gradient for each, through bf16 K3f and K3b."""
    from m2mixer_tpu_torch.modules import pallas_blocks as pb

    m = pb.PallasGatingMlpBlock(32, 64, 7, dtype=torch.bfloat16,
                                generator=torch.Generator().manual_seed(0))
    m = m.to(cuda).train()
    before = (gk.fused_gmlp_block.bf16_launches, gk.fused_gmlp_block_bwd.bf16_launches)
    m(torch.randn(5, 7, 32, device=cuda)).square().sum().backward()
    assert (gk.fused_gmlp_block.bf16_launches, gk.fused_gmlp_block_bwd.bf16_launches) == \
        (before[0] + 1, before[1] + 1)
    for name, prm in m.named_parameters():
        assert prm.dtype == torch.float32 and prm.grad.dtype == torch.float32, name
        assert prm.grad.abs().sum().item() > 0, name


# bf16 K3f/K3b on the wgmma engine: the config's two shapes (D 128, F 768) at
# one sample, a ragged batch, and more rows than the batch-512 plans
GMLP_WG_SHAPES = {"encoder": dict(N=49, D=128, F=768), "fusion": dict(N=99, D=128, F=768)}


def tally_delta(fn):
    """fn()'s result and its launches of the tallied kernels (_build.launch_tally)."""
    before = _build.launch_tally()
    out = fn()
    after = _build.launch_tally()
    return out, {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("B", [1, 7, 600])
@pytest.mark.parametrize("shape", sorted(GMLP_WG_SHAPES))
def test_gmlp_bf16_on_the_wgmma_engine(cuda, shape, B):
    """bf16 K3f against the plain bf16 version (assert_close) and bf16 K3b
    against its autograd (bf16_grads_close, 10% of the rounded elements) at
    dropout 0.1, erf; by the library's tallies K3f's two products and K3b's
    five run as wgmma-engine launches and no tc_gemm_kernel is launched; two
    runs of each bit-identical."""
    geom = GMLP_WG_SHAPES[shape]
    p = gmlp_params_on(cuda, seed=6, **geom)
    gen = torch.Generator().manual_seed(B)
    x = torch.randn(B, geom["N"], geom["D"], generator=gen).to(cuda)
    g = torch.randn(B, geom["N"], geom["D"], generator=gen).to(cuda)
    bf16 = torch.bfloat16
    fwd = lambda: gk.fused_gmlp_block(x, p, seed=8, dropout_rate=0.1, compute_dtype=bf16)
    bwd = lambda: gk.fused_gmlp_block_bwd(x, g, p, seed=8, dropout_rate=0.1, compute_dtype=bf16)
    out, launched = tally_delta(fwd)
    assert (launched["wg_gemm_kernel"], launched["tc_gemm_kernel"]) == (2, 0), launched
    assert_close(out, gk.gmlp_block_reference(x, p, 0.1, seed=8, compute_dtype=bf16), True)
    (dx, grads), launched = tally_delta(bwd)
    assert (launched["wg_gemm_kernel"], launched["tc_gemm_kernel"]) == (5, 0), launched
    want_dx, want = gk.gmlp_block_bwd_reference(x, g, p, 0.1, seed=8, compute_dtype=bf16)
    bf16_grads_close((dx, *grads), (want_dx, *want), GMLP_ROUNDED, 0.10)
    assert torch.equal(out, fwd())
    dx2, grads2 = bwd()
    assert torch.equal(dx, dx2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))


@pytest.mark.parametrize("N", [128, 129, 196])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gmlp_large_n_route_by_the_tallies(cuda, dtype, N):
    """Above 128 tokens K3f and K3b take the large-N route (one
    gmlp_vt_kernel a call) with the token products as launches of the
    dtype's product (float32: three tc_gemm a K3f, eight a K3b; bf16: the
    same on the wgmma engine, no tc_gemm); at 128 the shared-memory SGU (no
    gmlp_vt_kernel, two and five products). Both match the plain version."""
    p = gmlp_params_on(cuda, seed=3, N=N, D=32, F=64)
    x = torch.randn(4, N, 32, device=cuda)
    g = torch.randn_like(x)
    cd = torch.bfloat16 if dtype == "bf16" else torch.float32
    engine = "wg_gemm_kernel" if dtype == "bf16" else "tc_gemm_kernel"
    other = "tc_gemm_kernel" if dtype == "bf16" else "wg_gemm_kernel"
    large = N > 128
    out, launched = tally_delta(lambda: gk.fused_gmlp_block(x, p, seed=2, dropout_rate=0.1,
                                                            compute_dtype=cd))
    assert (launched["gmlp_vt_kernel"], launched[engine], launched[other]) == \
        ((1, 3, 0) if large else (0, 2, 0)), launched
    (dx, grads), launched = tally_delta(lambda: gk.fused_gmlp_block_bwd(
        x, g, p, seed=2, dropout_rate=0.1, compute_dtype=cd))
    assert (launched["gmlp_vt_kernel"], launched[engine], launched[other]) == \
        ((1, 8, 0) if large else (0, 5, 0)), launched
    want = gk.gmlp_block_reference(x, p, 0.1, seed=2, compute_dtype=cd)
    want_dx, want_g = gk.gmlp_block_bwd_reference(x, g, p, 0.1, seed=2, compute_dtype=cd)
    if dtype == "bf16":
        assert_close(out, want, True)
        bf16_grads_close((dx, *grads), (want_dx, *want_g), GMLP_ROUNDED, 0.10)
    else:
        rel_close(out, want)
        for a, w in zip((dx, *grads), (want_dx, *want_g)):
            rel_close(a, w)


def test_gmlp_workspace_matches_the_mirror(cuda):
    """m2m_gmlp_workspace_bytes against tests/test_torch_gmlp_plan.py's
    Python mirror of its plan, forward and backward, float32 and bf16, on
    this card's SM count."""
    from m2mixer_tpu_torch.ops._build import load_library
    from test_torch_gmlp_plan import CASES, workspace_floats

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = load_library()
    for dims in CASES:
        for backward in (0, 1):
            for bf16 in (0, 1):
                assert lib.m2m_gmlp_workspace_bytes(*dims, backward, bf16, 0) == \
                    4 * workspace_floats(*dims, backward, bf16, sms=sms), (dims, backward, bf16)


@pytest.mark.parametrize("N", [6, 196])
def test_gmlp_bf16_raises_where_the_kernels_do_not_take_it(cuda, N):
    """F/2 = 2048 v-channels, whose LN(v) rows overflowed the fixed row tile,
    run on a tile sized from the shared memory (fewer rows, or in bf16 fewer
    warps) and match the plain version in both dtypes, on the shared-memory
    SGU (6 tokens) and on the large-N route (196); no fallback where the
    kernels still cannot take a shape: B*F/2 rows past the large-N route's
    product grid (65535 tiles of 128) raise with the shape in the message."""
    p = gmlp_params_on(cuda, N=N, D=16, F=4096)
    x = torch.randn(2, N, 16, device=cuda)
    g = torch.randn_like(x)
    for dtype in (torch.bfloat16, torch.float32):
        out = gk.fused_gmlp_block(x, p, compute_dtype=dtype)
        want = gk.gmlp_block_reference(x, p, compute_dtype=dtype)
        dx, grads = gk.fused_gmlp_block_bwd(x, g, p, compute_dtype=dtype)
        want_dx, want_g = gk.gmlp_block_bwd_reference(x, g, p, compute_dtype=dtype)
        if dtype == torch.bfloat16:
            assert_close(out, want, True)
            bf16_grads_close((dx, *grads), (want_dx, *want_g), GMLP_ROUNDED, 0.10)
        else:
            rel_close(out, want)
            for a, w in zip((dx, *grads), (want_dx, *want_g)):
                rel_close(a, w)
    p = gmlp_params_on(cuda, N=129, D=1, F=258)  # B*F/2 = 65535 x 129 rows: past 65535 x 128
    x = torch.randn(65535, 129, 1, device=cuda)
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="B=65535 N=129 D=1 F=258"):
            gk.fused_gmlp_block_bwd(x, torch.randn_like(x), p, compute_dtype=dtype)


# the gMLP block's engine products (A K-major, B K-major, A's planes, B's
# planes, the tile's columns) at the fusion shape's widths with ragged rows:
# the in-projection and dgated (and the out-projection), dxn, dW_in, dW_out
GMLP_WG_LAYOUTS = {"in": (1, 0, 1, 1, 64, 1000, 768, 128),
                   "out": (1, 0, 1, 1, 64, 1000, 128, 384),
                   "dgated": (1, 0, 1, 1, 64, 1000, 384, 128),
                   "dxn": (1, 1, 3, 1, 128, 1000, 128, 768),
                   "dW_in": (0, 0, 1, 3, 128, 128, 768, 1000),
                   "dW_out": (0, 0, 1, 1, 128, 384, 128, 1000),
                   "odd_in": (1, 0, 1, 1, 64, 65, 44, 20),
                   "odd_dW_in": (0, 0, 1, 3, 128, 20, 44, 65)}


@pytest.mark.parametrize("layout", sorted(GMLP_WG_LAYOUTS))
def test_wgmma_engine_gmlp_layouts_match_float64(cuda, layout):
    """The engine alone (m2m_wg_product) in the layouts and tiles of bf16
    K3f/K3b, rows padded to 8 (odd: D 20, F 44): against the float64 product
    of the same bf16 values (dpre's three planes for dxn and dW_in), within
    1e-5 of the largest output."""
    from m2mixer_tpu_torch.ops._build import load_library
    import ctypes

    a_k, b_k, ta, tb, tile, M, N, K = GMLP_WG_LAYOUTS[layout]
    gen = torch.Generator().manual_seed(M + N + K)

    def planes(x, t):
        out, rest = [], x
        for _ in range(t):
            out.append(rest.to(torch.bfloat16))
            rest = rest - out[-1].float()
        return out

    def stored(p, transpose):
        p = (p.t() if transpose else p).contiguous()
        out = torch.zeros(p.shape[0], -(-p.shape[1] // 8) * 8, dtype=p.dtype)
        out[:, :p.shape[1]] = p
        return out.to(cuda)

    ap = planes(torch.randn(M, K, generator=gen), ta)
    bp = planes(torch.randn(K, N, generator=gen), tb)
    want = sum(p.double() for p in ap) @ sum(p.double() for p in bp)
    a = [stored(p, not a_k) for p in ap]
    b = [stored(p, bool(b_k)) for p in bp]
    out = torch.full((M, N), float("nan"), device=cuda)
    lib = load_library()
    code = lib.m2m_wg_product(a_k, b_k, ta, tb, M, N, K, tile,
                              (ctypes.c_void_p * 3)(*[t.data_ptr() for t in a]), a[0].shape[1],
                              (ctypes.c_void_p * 3)(*[t.data_ptr() for t in b]), b[0].shape[1],
                              out.data_ptr(), 0, torch.cuda.current_stream().cuda_stream)
    assert code == 0, lib.m2m_error_string(code)
    torch.cuda.synchronize()
    err = (out.cpu().double() - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


# ----------------------------------------------------------------- DynaMixer
# "config" is avmnist_3loss_dyna.yml's op at batch 32 (S = 7 x 32 rows or
# columns of the 7 x 7 grid); "ragged" has an S*L that is no multiple of the
# tiles' rows nor of the sequences a CTA owns; "odd" has C = 36 and H*R = 18,
# no multiple of 8 or 16 (dW_c's narrow tile and the wide tiles' ragged
# columns); "l33" and "l64" are the lifted shapes, whose sequence (x, W_g)
# would outgrow a CTA's shared memory
DYNA_SHAPES = {"small": dict(S=5, L=4, C=16, H=4, R=3),
               "config": dict(S=224, L=7, C=256, H=8, R=2),
               "ragged": dict(S=37, L=7, C=256, H=8, R=2),
               "odd": dict(S=9, L=5, C=36, H=6, R=3),
               "l33": dict(S=6, L=33, C=1280, H=8, R=2),
               "l64": dict(S=5, L=64, C=512, H=4, R=3)}
# the products of a call (bf16 on the wgmma engine, float32 on tc_gemm): the
# forward's compress, generate and output products; the backward's two
# recomputed, d_mixed, d_gin, dx's compress part, dW_c, dW_g and dW_o
DYNA_WG_FWD, DYNA_WG_BWD = 3, 8


def dyna_params_on(device, L, C, H, R, seed=0):
    """One DynaMixerOp's parameters at the Linear layers' init scales,
    U(+-1/sqrt(fan_in)), the weights output-major (the Linear layout the
    kernels read)."""
    g = torch.Generator().manual_seed(seed)
    u = lambda fan, *shape: (torch.rand(*shape, generator=g) * 2 - 1) / fan ** 0.5
    p = (u(C, H * R, C), u(C, H * R), u(L * R, L * L, L * R), u(L * R, L * L), u(C, C, C),
         u(C, C))
    return dk.DynaMixerOpParams(*(t.to(device) for t in p))


@pytest.mark.parametrize("scale", [1.0, 30.0], ids=["x1", "x30"])
@pytest.mark.parametrize("shape", sorted(DYNA_SHAPES))
def test_dynamixer_kernels_match_plain(cuda, shape, scale):
    """K4f and K4b against the plain version and its autograd, every tensor
    within 1e-4 x max(1, max|plain|); x30 drives the generate logits to tens
    (the softmax's maximum must be subtracted); every product on tc_gemm (by
    the library's tallies: three a K4f call, eight a K4b call); two forward
    and two backward runs bit-identical."""
    geom = DYNA_SHAPES[shape]
    S, L, C, H, R = (geom[k] for k in "SLCHR")
    p = dyna_params_on(cuda, L, C, H, R)
    x = scale * torch.randn(S, L, C, device=cuda)
    g = torch.randn_like(x)
    before = (dk.fused_dynamixer_op.launches, dk.fused_dynamixer_op_bwd.launches)
    out, tally = tally_delta(lambda: dk.fused_dynamixer_op(x, p, H, R))
    assert tally == {"wg_gemm_kernel": 0, "tc_gemm_kernel": DYNA_WG_FWD, "tok_in_kernel": 0,
                     "gmlp_vt_kernel": 0}
    rel_close(out, dk.dynamixer_op_reference(x, p, H, R))
    assert torch.equal(out, dk.fused_dynamixer_op(x, p, H, R))
    (dx, grads), tally = tally_delta(lambda: dk.fused_dynamixer_op_bwd(x, g, p, H, R))
    assert tally == {"wg_gemm_kernel": 0, "tc_gemm_kernel": DYNA_WG_BWD, "tok_in_kernel": 0,
                     "gmlp_vt_kernel": 0}
    assert (dk.fused_dynamixer_op.launches, dk.fused_dynamixer_op_bwd.launches) == \
        (before[0] + 2, before[1] + 1)
    want_dx, want = dk.dynamixer_op_bwd_reference(x, g, p, H, R)
    rel_close(dx, want_dx)
    assert len(grads) == len(want) == 6
    for a, b in zip(grads, want):
        rel_close(a, b)
    dx2, grads2 = dk.fused_dynamixer_op_bwd(x, g, p, H, R)
    assert torch.equal(dx, dx2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))


def test_dyna_workspace_matches_the_mirror(cuda):
    """m2m_dyna_workspace_bytes against tests/test_torch_dynamixer_plan.py's
    Python mirror of its plan, forward and backward, float32 and bf16, on
    this card's SM count."""
    from m2mixer_tpu_torch.ops._build import load_library
    from test_torch_dynamixer_plan import CASES, workspace_bytes

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = load_library()
    for dims in CASES:
        for backward in (0, 1):
            for bf16 in (0, 1):
                assert lib.m2m_dyna_workspace_bytes(*dims, backward, bf16, 0) == \
                    workspace_bytes(*dims, backward, bf16, sms=sms), (dims, backward, bf16)


def test_dynamixer_block_trains_on_cuda(cuda):
    """Every parameter of a DynaMixerBlock gets a non-zero gradient on the
    card; its two DynaMixerOps launch K4f and K4b once each."""
    from m2mixer_tpu_torch.modules.dynamixer import DynaMixerBlock

    m = DynaMixerBlock(32, 5, 4, generator=torch.Generator().manual_seed(0)).to(cuda).train()
    before = (dk.fused_dynamixer_op.launches, dk.fused_dynamixer_op_bwd.launches)
    m(torch.randn(3, 5, 5, 32, device=cuda)).square().sum().backward()
    assert (dk.fused_dynamixer_op.launches, dk.fused_dynamixer_op_bwd.launches) == \
        (before[0] + 2, before[1] + 2)
    for name, prm in m.named_parameters():
        assert prm.grad is not None and prm.grad.abs().sum().item() > 0, name


def test_dynamixer_kernels_raise_on_cuda(cuda):
    p = dyna_params_on(cuda, **{k: DYNA_SHAPES["small"][k] for k in "LCHR"})
    x = torch.randn(5, 4, 16, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        dk.fused_dynamixer_op(x, p, 4, 3, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        dk.fused_dynamixer_op(x.transpose(0, 1).contiguous().transpose(0, 1), p, 4, 3)
    with pytest.raises(ValueError, match="shape"):
        dk.fused_dynamixer_op(x, p, 4, 2)
    # no L or C cap (L = 33 runs); S*L rows beyond the products' grid raise
    long = dyna_params_on(cuda, L=33, C=16, H=4, R=2)
    x = torch.randn(2, 33, 16, device=cuda)
    rel_close(dk.fused_dynamixer_op(x, long, 4, 2), dk.dynamixer_op_reference(x, long, 4, 2))
    huge = dyna_params_on(cuda, L=65, C=4, H=1, R=1)
    with pytest.raises(ValueError, match="do not take S=65536 L=65"):
        dk.fused_dynamixer_op(torch.zeros(65536, 65, 4, device=cuda), huge, 1, 1)


# DynaMixerOp in bf16 compute. The forward's output is float32 (sums of
# products of bf16 values, biases added in float32), so it is held within
# DYNA_BF16_FWD of max(1, max|plain|): the kernel and the plain version round
# at the same points, and a float32 sum taken in another order moves a
# rounded intermediate by one ulp now and then (on the CPU, float64 sums with
# the same casts sit 5.8e-4 from the float32 ones at the config shape), while
# the float32-math control (the op without its casts) sits 3.2e-3 away and
# must fail. The gradients: bf16_grads_close, dW_c, dW_g and dW_o rounded.
DYNA_BF16_FWD = 1.5e-3
# x and g drawn from a generator of their own, not from torch's global one
# (whose state follows the tests run before); chip_smoke.py's
# dyna_bf16_seed_spread measures the forward's error over this seed and others
DYNA_BF16_SEED = 0
DYNA_ROUNDED = (False, True, False, True, False, True, False)  # dx, then DynaMixerOpParams


@pytest.mark.parametrize("scale", [1.0, 30.0], ids=["x1", "x30"])
@pytest.mark.parametrize("shape", sorted(DYNA_SHAPES))
def test_dynamixer_bf16_kernels_match_plain(cuda, shape, scale):
    geom = DYNA_SHAPES[shape]
    S, L, C, H, R = (geom[k] for k in "SLCHR")
    p = dyna_params_on(cuda, L, C, H, R)
    gen = torch.Generator().manual_seed(DYNA_BF16_SEED)
    x = (scale * torch.randn(S, L, C, generator=gen)).to(cuda)
    g = torch.randn(S, L, C, generator=gen).to(cuda)
    bf16 = torch.bfloat16
    before = (dk.fused_dynamixer_op.bf16_launches, dk.fused_dynamixer_op_bwd.bf16_launches)
    fwd = lambda: dk.fused_dynamixer_op(x, p, H, R, compute_dtype=bf16)
    got, launched = tally_delta(fwd)
    assert (launched["wg_gemm_kernel"], launched["tc_gemm_kernel"]) == (DYNA_WG_FWD, 0), launched
    assert torch.equal(got, fwd())
    want = dk.dynamixer_op_reference(x, p, H, R, bf16)
    tol = DYNA_BF16_FWD * max(1.0, want.abs().max().item())
    assert torch.isfinite(got).all() and (got - want).abs().max().item() <= tol
    # the control separates at the served shape, and at the lifted shapes at
    # x30 (at x1 their outputs sit below 1, where the limit's max(1, .) lets
    # float32 math pass; at x30 the control sits about ten times the limit
    # away, on the CPU)
    if shape == "config" or (shape in ("l33", "l64") and scale == 30.0):
        control = dk.dynamixer_op_reference(x, p, H, R)
        assert (control - want).abs().max().item() > tol
    (dx, grads), launched = tally_delta(
        lambda: dk.fused_dynamixer_op_bwd(x, g, p, H, R, compute_dtype=bf16))
    assert (launched["wg_gemm_kernel"], launched["tc_gemm_kernel"]) == (DYNA_WG_BWD, 0), launched
    assert (dk.fused_dynamixer_op.bf16_launches, dk.fused_dynamixer_op_bwd.bf16_launches) == \
        (before[0] + 2, before[1] + 1)
    want_dx, want_g = dk.dynamixer_op_bwd_reference(x, g, p, H, R, bf16)
    bf16_grads_close((dx, *grads), (want_dx, *want_g), DYNA_ROUNDED, 0.10)
    dx2, grads2 = dk.fused_dynamixer_op_bwd(x, g, p, H, R, compute_dtype=bf16)
    assert torch.equal(dx, dx2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))


@pytest.mark.slow
def test_dynamixer_bf16_reruns_are_bit_identical(cuda):
    """The config shape at x30 in bf16, 300 forward and backward runs against
    the first, bit for bit: no float atomics, every partial reduced in one
    order."""
    geom = DYNA_SHAPES["config"]
    S, L, C, H, R = (geom[k] for k in "SLCHR")
    p = dyna_params_on(cuda, L, C, H, R)
    x = 30.0 * torch.randn(S, L, C, device=cuda)
    g = torch.randn_like(x)
    bf16 = torch.bfloat16
    out = dk.fused_dynamixer_op(x, p, H, R, compute_dtype=bf16)
    dx, grads = dk.fused_dynamixer_op_bwd(x, g, p, H, R, compute_dtype=bf16)
    for i in range(300):
        assert torch.equal(out, dk.fused_dynamixer_op(x, p, H, R, compute_dtype=bf16)), i
        dx2, grads2 = dk.fused_dynamixer_op_bwd(x, g, p, H, R, compute_dtype=bf16)
        assert torch.equal(dx, dx2) and all(torch.equal(a, b) for a, b in zip(grads, grads2)), i


# Above 32 tokens the mixer kernels run the token FF as products
# (csrc/token_ff.cuh); "l_like" has the L config's token and hidden ratios at
# a narrow width
TOKEN_SHAPES = {"n33": dict(N=33, D=32, T=16, C=64), "l_like": dict(N=80, D=64, T=48, C=96)}


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", sorted(TOKEN_SHAPES))
def test_token_pipeline_forward_matches_plain(cuda, shape, dtype, rate):
    """K1f and K2f (2 blocks + LN) above 32 tokens against the plain versions,
    the same masks; two runs bit-identical."""
    geom = TOKEN_SHAPES[shape]
    blocks, s, b = blocks_on(cuda, 2, **geom)
    x = torch.randn(19, geom["N"], geom["D"], device=cuda)
    flat = mk.stack_flat_params(blocks, s, b)
    bf = dtype == torch.bfloat16
    check = (lambda got, want: assert_close(got, want, bf)) if rate == 0 or bf else rel_close
    k1f = lambda: mk.fused_mixer_block(x, blocks[0], seed=3, dropout_rate=rate,
                                       compute_dtype=dtype)
    k2f = lambda: mk.fused_mixer_stack(x, flat, seed=4, dropout_rate=rate, compute_dtype=dtype)
    before = (mk.fused_mixer_block.launches, mk.fused_mixer_stack.launches)
    for run, want in ((k1f, mk.mixer_block_reference(x, blocks[0], rate, dtype, seed=3)),
                      (k2f, mk.mixer_stack_reference(x, flat, dtype, dropout_rate=rate,
                                                     seed=4))):
        out = run()
        check(out, want)
        assert torch.equal(out, run())
    assert (mk.fused_mixer_block.launches, mk.fused_mixer_stack.launches) == \
        (before[0] + 2, before[1] + 2)


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("shape", sorted(TOKEN_SHAPES))
def test_token_pipeline_backward_matches_plain(cuda, shape, rate):
    """K1b, and K2b as 2 blocks + LN, above 32 tokens against autograd of the
    plain versions; every tensor within 1e-4 x max(1, max|plain|), two runs
    bit-identical."""
    geom = TOKEN_SHAPES[shape]
    blocks, s, b = blocks_on(cuda, 2, **geom)
    x = torch.randn(19, geom["N"], geom["D"], device=cuda)
    g = torch.randn_like(x)
    flat = mk.stack_flat_params(blocks, s, b)
    k1b = lambda: mk.fused_mixer_block_bwd(x, g, blocks[0], seed=5, dropout_rate=rate)
    k2b = lambda: mk.fused_mixer_stack_bwd(x, g, flat, seed=6, dropout_rate=rate)
    for run, want in ((k1b, mk.mixer_block_bwd_reference(x, g, blocks[0], rate, seed=5)),
                      (k2b, mk.mixer_stack_bwd_reference(x, g, flat, rate, seed=6))):
        dx, grads = run()
        for i, (a, w) in enumerate(zip((dx, *grads), (want[0], *want[1]))):
            if i % 12 == 6 and rate == 0.0 and w.abs().max().item() <= 1e-3:
                assert a.abs().max().item() <= 1e-3  # b2: zero in the math under an LN
                continue
            rel_close(a, w)
        dx2, grads2 = run()
        assert torch.equal(dx, dx2) and all(torch.equal(a, c) for a, c in zip(grads, grads2))


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("shape", sorted(TOKEN_SHAPES))
def test_bf16_token_pipeline_backward_matches_plain(cuda, shape, rate):
    """K1b and K2b (3 blocks + LN) in bf16 compute above 32 tokens against
    autograd of the plain bf16 versions (bf16_grads_close)."""
    geom = TOKEN_SHAPES[shape]
    blocks, s, b = blocks_on(cuda, 3, **geom)
    gen = torch.Generator().manual_seed(19)
    x = torch.randn(19, geom["N"], geom["D"], generator=gen).to(cuda)
    g = torch.randn(19, geom["N"], geom["D"], generator=gen).to(cuda)
    bf16 = torch.bfloat16
    dx, grads = mk.fused_mixer_block_bwd(x, g, blocks[0], seed=5, dropout_rate=rate,
                                         compute_dtype=bf16)
    want_dx, want = mk.mixer_block_bwd_reference(x, g, blocks[0], rate, bf16, seed=5)
    bf16_grads_close((dx, *grads), (want_dx, *want), (True, *BF16_ROUNDED), 0.10)
    flat = mk.stack_flat_params(blocks, s, b)
    dx, grads = mk.fused_mixer_stack_bwd(x, g, flat, seed=6, dropout_rate=rate,
                                         compute_dtype=bf16)
    want_dx, want = mk.mixer_stack_bwd_reference(x, g, flat, rate, bf16, seed=6)
    b2 = tuple(i == 5 and rate == 0.0 for i in range(12))
    bf16_grads_close((dx, *grads), (want_dx, *want), (True, *(BF16_ROUNDED * 3), True, True),
                     0.40, dead=(False, *(b2 * 3), False, False))


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bf16_forward_at_the_b_shapes(cuda, shape):
    """The bf16 forward (one route at either precision) at the B shapes: K1f
    and K2f (3 blocks + LN) against the plain bf16 versions, the token FF in
    registers, two runs bit-identical."""
    geom = SHAPES[shape]
    blocks, s, b = blocks_on(cuda, 3, **geom)
    x = torch.randn(37, geom["N"], geom["D"], device=cuda)
    flat = mk.stack_flat_params(blocks, s, b)
    bf16 = torch.bfloat16
    before = (mk.fused_mixer_block.token_ff_launches, mk.fused_mixer_stack.token_ff_launches)
    for run, want in ((lambda: mk.fused_mixer_block(x, blocks[0], compute_dtype=bf16),
                       mk.mixer_block_reference(x, blocks[0], compute_dtype=bf16)),
                      (lambda: mk.fused_mixer_stack(x, flat, compute_dtype=bf16),
                       mk.mixer_stack_reference(x, flat, bf16))):
        got = run()
        assert_close(got, want, True)
        assert torch.equal(got, run())
    assert (mk.fused_mixer_block.token_ff_launches,
            mk.fused_mixer_stack.token_ff_launches) == before


# bf16 K1f and K2f with every product on the wgmma engine: the B shapes (the
# token FF in registers), the L shapes, and 33 and 40 tokens (the token
# pipeline; 33 pads yt's rows to 40)
L_SHAPE = dict(D=512, T=256, C=4096)
BF16_FWD_CASES = {"encoder": SHAPES["encoder"], "fusion": SHAPES["fusion"],
                  "l_image": dict(N=16, **L_SHAPE), "l_audio": dict(N=64, **L_SHAPE),
                  "l_fusion": dict(N=80, **L_SHAPE), "n33": dict(N=33, D=32, T=16, C=64),
                  "n40": dict(N=40, D=32, T=16, C=64)}
L_STACK_EXCESS = 0.05  # chip_smoke.py's: the L stacks' share over the float64-sum floor


def float64_sums_reference(fn):
    """``fn()`` with every torch.matmul summed in float64 and rounded to its
    operands' type (chip_smoke.py's float64_sums): a second implementation of
    the plain version's casts."""
    matmul = torch.matmul
    torch.matmul = lambda a, b: matmul(a.double(), b.double()).to(
        torch.promote_types(a.dtype, b.dtype))
    try:
        return fn()
    finally:
        torch.matmul = matmul


@pytest.mark.parametrize("B", [1, 7, 600])
@pytest.mark.parametrize("case", sorted(BF16_FWD_CASES))
def test_bf16_forward_on_the_wgmma_engine(cuda, case, B):
    """bf16 K1f, and K2f as 2 blocks + LN, on the wgmma engine against the
    plain bf16 versions (dropout 0.5, tanh GELU): K1f by assert_close (at
    most 10% of the outputs differing); K2f the same, or at the L shapes
    within the share of the plain version with float64 sums + 0.05; each call
    counted, its products tallied as wgmma-engine launches (two a block, four
    on the token pipeline) and none as tc_gemm; two runs bit-identical."""
    geom = BF16_FWD_CASES[case]
    blocks, s, b = blocks_on(cuda, 2, **geom)
    gen = torch.Generator().manual_seed(B)
    x = torch.randn(B, geom["N"], geom["D"], generator=gen).to(cuda)
    flat = mk.stack_flat_params(blocks, s, b)
    bf = torch.bfloat16
    k1f = lambda: mk.fused_mixer_block(x, blocks[0], 3, 0.5, bf, True)
    k2f = lambda: mk.fused_mixer_stack(x, flat, 4, 0.5, bf, True, True)
    plain1 = lambda: mk.mixer_block_reference(x, blocks[0], 0.5, bf, True, seed=3)
    plain2 = lambda: mk.mixer_stack_reference(x, flat, bf, True, True, 0.5, seed=4)
    before = (mk.fused_mixer_block.launches, mk.fused_mixer_stack.launches)
    tallies = [_build.launch_tally()]
    got1 = k1f()
    tallies.append(_build.launch_tally())
    got2 = k2f()
    tallies.append(_build.launch_tally())
    assert (mk.fused_mixer_block.launches, mk.fused_mixer_stack.launches) == \
        (before[0] + 1, before[1] + 1)
    for n_blocks, (t0, t1) in zip((1, 2), zip(tallies, tallies[1:])):
        tok = t1["tok_in_kernel"] - t0["tok_in_kernel"]
        assert tok in (0, n_blocks)
        assert t1["wg_gemm_kernel"] - t0["wg_gemm_kernel"] == (4 if tok else 2) * n_blocks
        assert t1["tc_gemm_kernel"] == t0["tc_gemm_kernel"]
    assert_close(got1, plain1(), True)
    want2 = plain2()
    if case.startswith("l_"):
        floor = (float64_sums_reference(plain2) != want2).float().mean().item()
        assert torch.isfinite(got2).all() and torch.equal(got2, got2.to(bf).float())
        assert (got2 - want2).abs().max().item() <= 2e-2 * want2.abs().max().item()
        share = (got2 != want2).float().mean().item()
        assert share <= floor + L_STACK_EXCESS, (share, floor)
    else:
        assert_close(got2, want2, True)
    assert torch.equal(got1, k1f()) and torch.equal(got2, k2f())


def test_bf16_forward_raises_below_a_hidden_width_of_8(cuda):
    """A hidden width the engine's TMA rows cannot take as it is (hidden_dim
    % 8) runs padded in bf16, on the engine (two wg_gemm_kernel a block, no
    tc_gemm_kernel), and matches the plain version, as float32 does; no
    fallback where the kernels still refuse: 33 blocks in one stack raise."""
    blocks, s, b = blocks_on(cuda, 1, N=4, D=20, T=8, C=64)
    x = torch.randn(3, 4, 20, device=cuda)
    bf = torch.bfloat16
    got, launched = tally_delta(lambda: mk.fused_mixer_block(x, blocks[0], compute_dtype=bf))
    assert (launched["wg_gemm_kernel"], launched["tc_gemm_kernel"]) == (2, 0), launched
    assert_close(got, mk.mixer_block_reference(x, blocks[0], compute_dtype=bf), True)
    flat = mk.stack_flat_params(blocks, s, b)
    assert_close(mk.fused_mixer_stack(x, flat, compute_dtype=bf),
                 mk.mixer_stack_reference(x, flat, compute_dtype=bf), True)
    with pytest.raises(ValueError, match="runs 1..32 blocks"):
        mk.fused_mixer_stack(x, mk.stack_flat_params(blocks * 33, s, b), compute_dtype=bf)
    assert_close(mk.fused_mixer_block(x, blocks[0]), mk.mixer_block_reference(x, blocks[0]), False)
