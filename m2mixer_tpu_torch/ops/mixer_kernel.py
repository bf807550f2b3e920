"""Fused MixerBlock and mixer stack: CUDA kernels, plain versions, gradients.

Counterpart of ``m2mixer_tpu/ops/mixer_kernel.py`` with the same public
layout: ``x (B, N, D)`` float32 in and out, ``w1 (N, T)``, ``w2 (T, N)``,
``w3 (D, C)``, ``w4 (C, D)`` (input-major, as the JAX kernels take them).

- ``mixer_block_reference`` / ``mixer_stack_reference`` are the plain
  PyTorch versions of ``_block_math`` / ``_stack_math``, cast for cast and
  mask for mask; ``mixer_block_bwd_reference`` / ``mixer_stack_bwd_reference``
  are autograd of them.
- ``fused_mixer_block`` (K1f) and ``fused_mixer_stack`` (K2f) launch the
  hand-written kernels of ``csrc/mixer_fwd.cu`` on CUDA tensors (in bf16
  compute every product on the wgmma engine, ``csrc/wgmma_bf16.cuh``;
  hidden_dim a multiple of 8). When a
  gradient is wanted they run inside a ``torch.autograd.Function`` whose
  backward is ``fused_mixer_block_bwd`` (K1b) / ``fused_mixer_stack_bwd``
  (K2b), the kernels of ``csrc/mixer_bwd.cu``, float32 or bf16 compute, at
  any token count (up to 32 tokens the token FF runs in registers where a
  sample fits the tiles, else as products on the tensor cores,
  ``csrc/token_ff.cuh``). Each wrapper counts its launches in its
  ``launches`` attribute (K1b and K2b also their bf16 ones alone, in
  ``bf16_launches``; all four those that ran the token FF as products, in
  ``token_ff_launches``). A CPU tensor gets
  the plain version (the backward: autograd of it); a CUDA tensor gets the
  kernel or an error, never the plain version.
- Parameters are float32 at any compute dtype (the JAX modules' layout): in
  bf16 compute the kernels read w3/w4 rounded to bf16 as they lay them out,
  as the JAX kernels cast theirs on each call, and every gradient comes back
  in float32, rounded where JAX's AD rounds it (``csrc/mixer_bwd.cu``).
- ``fused_mixer_stack_grouped`` splits K blocks into ceil(K/G) stack
  launches with the JAX package's ``group_size`` semantics and
  ``seed + 7919*g`` seed folding.

Dropout masks are a hash of (seed, block index in the launch, mask id,
element index in the JAX layout of the mask), computed the same way by the
kernels (``csrc/mixer_common.cuh``) and here (``dropout_mask``), so kernel
and plain version agree element by element. The JAX kernels' masks come from
the TPU's PRNG and cannot be reproduced; JAX's keep rule and scale are kept.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "MixerBlockParams",
    "cast_params",
    "dropout_mask",
    "fused_mixer_block",
    "fused_mixer_block_bwd",
    "fused_mixer_stack",
    "fused_mixer_stack_bwd",
    "fused_mixer_stack_grouped",
    "mask_key",
    "mixer_block_bwd_reference",
    "mixer_block_reference",
    "mixer_stack_bwd_reference",
    "mixer_stack_reference",
    "stack_flat_params",
]

_N_BLOCK_PARAMS = 12
_REG_TOKENS = 32  # kMaxTokens: at most this many tokens, the token FF runs in registers
_MAX_BLOCKS = 32  # kMaxBlocks
_MASKS = 4  # kMasks: dropout masks per block
_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B1  # kGolden


class MixerBlockParams(NamedTuple):
    ln1_scale: torch.Tensor  # (D,)
    ln1_bias: torch.Tensor
    w1: torch.Tensor  # (N, T)
    b1: torch.Tensor  # (T,)
    w2: torch.Tensor  # (T, N)
    b2: torch.Tensor  # (N,)
    ln2_scale: torch.Tensor  # (D,)
    ln2_bias: torch.Tensor
    w3: torch.Tensor  # (D, C)
    b3: torch.Tensor  # (C,)
    w4: torch.Tensor  # (C, D)
    b4: torch.Tensor  # (D,)


# ------------------------------------------------------------ plain version
def _layer_norm(x, scale, bias, eps=1e-5):
    # float32 statistics whatever the compute dtype (as the JAX kernel)
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _gelu(x, approximate: bool):
    if approximate:
        return F.gelu(x, approximate="tanh")
    return 0.5 * x * (1.0 + torch.erf(x * 0.7071067811865476))


# ------------------------------------------------------------ dropout masks
def _fmix32_int(h: int) -> int:
    """murmur3's 32-bit finalizer on a Python int (``fmix32`` in the kernels)."""
    h &= _M32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def mask_key(seed: int, block: int, mask: int) -> int:
    """The stream key of dropout mask ``mask`` (0-3) of block ``block`` of a
    launch seeded with ``seed``."""
    mixed = _fmix32_int(int(seed)) ^ (((block * _MASKS + mask + 1) * _GOLDEN) & _M32)
    return _fmix32_int(mixed)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32): ``c`` in 16-bit limbs,
    so no product leaves the signed 64-bit range."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _thresh(rate: float) -> int:
    return int(rate * (2**32 - 1))  # JAX's jnp.uint32(int(rate * (2**32 - 1)))


def _scale(rate: float) -> float:
    return float(np.float32(1.0 / (1.0 - rate)))


def dropout_mask(seed: int, block: int, mask: int, rows: int, cols: int, rate: float,
                 device=None) -> torch.Tensor:
    """Mask ``mask`` of block ``block`` as a float32 (rows, cols) tensor of 0
    and 1/(1-rate): element e (row-major) is kept iff
    ``fmix32(e * golden ^ key) >= uint32(rate * (2**32 - 1))``."""
    e = torch.arange(rows * cols, dtype=torch.int64, device=device)
    bits = _fmix32(_mul32(e, _GOLDEN) ^ mask_key(seed, block, mask))
    return ((bits >= _thresh(rate)).float() * _scale(rate)).reshape(rows, cols)


def block_masks(seed, block: int, B: int, N: int, D: int, T: int, C: int, rate: float,
                device=None):
    """The four masks of one block in the JAX layouts: (B*D, T), (B*D, N),
    (B*N, C), (B*N, D); None at rate 0."""
    if rate == 0.0:
        return None
    s = 0 if seed is None else int(seed)
    shapes = [(B * D, T), (B * D, N), (B * N, C), (B * N, D)]
    return tuple(dropout_mask(s, block, m, r, c, rate, device) for m, (r, c) in enumerate(shapes))


def _check_rate(dropout_rate) -> float:
    rate = float(dropout_rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    return rate


# ------------------------------------------------------------ plain version
def _block_math(x, p: MixerBlockParams, compute_dtype, approximate_gelu: bool, masks=None):
    cd = compute_dtype
    B, N, D = x.shape

    def mm(a, w):  # operands in the compute dtype, float32 sums
        return torch.matmul(a.to(cd).float(), w.to(cd).float())

    x2 = x.to(cd).reshape(B * N, D)
    y = _layer_norm(x2, p.ln1_scale.to(cd), p.ln1_bias.to(cd))
    y_t = y.reshape(B, N, D).transpose(1, 2).reshape(B * D, N)
    h = _gelu(mm(y_t, p.w1) + p.b1, approximate_gelu)  # (B*D, T)
    if masks is not None:
        h = h * masks[0]
    t = mm(h, p.w2) + p.b2  # (B*D, N)
    if masks is not None:
        t = t * masks[1]
    t = t.reshape(B, D, N).transpose(1, 2).reshape(B * N, D)
    x1 = x2 + t.to(cd)

    z = _layer_norm(x1, p.ln2_scale.to(cd), p.ln2_bias.to(cd))
    h2 = _gelu(mm(z, p.w3) + p.b3, approximate_gelu)  # (B*N, C)
    if masks is not None:
        h2 = h2 * masks[2]
    c = mm(h2, p.w4) + p.b4  # (B*N, D)
    if masks is not None:
        c = c * masks[3]
    return (x1 + c.to(cd)).float().reshape(B, N, D)


def _masks_for(x, p, seed, block: int, rate: float):
    B, N, D = x.shape
    return block_masks(seed, block, B, N, D, p.w1.shape[1], p.w3.shape[1], rate, x.device)


def mixer_block_reference(x, params: MixerBlockParams, dropout_rate: float = 0.0,
                          compute_dtype=torch.float32, approximate_gelu: bool = False,
                          seed=None):
    """Plain PyTorch version of one fused MixerBlock (``_block_math``), with
    the kernel's dropout masks of block 0 of a launch seeded with ``seed``."""
    rate = _check_rate(dropout_rate)
    p = MixerBlockParams(*cast_params(tuple(params), compute_dtype))
    return _block_math(x, p, compute_dtype, approximate_gelu, _masks_for(x, p, seed, 0, rate))


def _unflatten_params(flat, has_ln: bool = True):
    end = len(flat) - 2 if has_ln else len(flat)
    blocks = [MixerBlockParams(*flat[i:i + _N_BLOCK_PARAMS])
              for i in range(0, end, _N_BLOCK_PARAMS)]
    if has_ln:
        return blocks, flat[-2], flat[-1]
    return blocks, None, None


def mixer_stack_reference(x, flat_params, compute_dtype=torch.float32,
                          final_ln: bool = True, approximate_gelu: bool = False,
                          dropout_rate: float = 0.0, seed=None):
    """Plain PyTorch version of K blocks + optional final LN
    (``_stack_apply``); ``flat_params`` as built by ``stack_flat_params``.
    Block k draws the masks of block k of a launch seeded with ``seed``."""
    rate = _check_rate(dropout_rate)
    flat = cast_params(tuple(flat_params), compute_dtype)
    blocks, ln_s, ln_b = _unflatten_params(flat, has_ln=final_ln)
    for k, p in enumerate(blocks):
        x = _block_math(x, p, compute_dtype, approximate_gelu, _masks_for(x, p, seed, k, rate))
    if not final_ln:
        return x
    B, N, D = x.shape
    out = _layer_norm(x.reshape(B * N, D).to(compute_dtype), ln_s.to(compute_dtype),
                      ln_b.to(compute_dtype))
    return out.float().reshape(B, N, D)


def stack_flat_params(blocks, ln_scale=None, ln_bias=None):
    flat = []
    for b in blocks:
        flat.extend(tuple(b))
    if ln_scale is not None:
        flat.extend([ln_scale, ln_bias])
    return tuple(flat)


def _castable(p) -> bool:
    """The JAX package's rule for the copies its kernels read: only the large
    channel-FF matrices (first dim >= 16, second >= 128) enter in the compute
    dtype; token weights, biases and LN vectors enter in float32. Every GEMM
    operand is rounded to the compute dtype either way, so the rule changes
    what is read, not what is computed."""
    return p.dim() == 2 and p.shape[0] >= 16 and p.shape[1] >= 128


def cast_params(flat_params, compute_dtype):
    """``flat_params`` with the castable ones cast to ``compute_dtype``, as
    JAX's ``_cast_params`` casts them on each call (the parameters themselves
    stay float32; autograd of the cast returns their gradients in float32)."""
    if compute_dtype == torch.float32:
        return tuple(flat_params)
    return tuple(p.to(compute_dtype) if _castable(p) else p for p in flat_params)


# ------------------------------------------------------------------ kernels
def _check_compute_dtype(compute_dtype) -> bool:
    if compute_dtype == torch.float32:
        return False
    if compute_dtype == torch.bfloat16:
        return True
    raise ValueError(f"compute_dtype {compute_dtype}: the CUDA kernels take "
                     "float32 or bfloat16")


def _fwd_workspace_bytes(lib, b: int, n: int, t: int, d: int, c: int, n_blocks: int,
                         bf16: bool, dev: int) -> int:
    """Bytes of device workspace the pipeline route (``m2m_mixer_fwd``)
    needs: the activations between its launches (x1, z, h2, the down
    product's slices of C and, above 32 tokens, the token FF's), the padded
    W3 copies where C is no multiple of 4, and in bf16 the rounded weights;
    in bf16 compute the products' operands (z, h2, the weight copies and the
    token FF's yt and ht) are stored in bf16, rows padded to 8 elements."""
    nbytes = lib.m2m_mixer_fwd_workspace_bytes(b, n, t, d, c, n_blocks, int(bf16), dev)
    if nbytes == 0:
        raise ValueError(f"the CUDA mixer forward does not take B={b} N={n} T={t} D={d} "
                         f"C={c} ({n_blocks} blocks{', bf16: hidden_dim % 8' if bf16 else ''})")
    return nbytes


def _bwd_workspace_bytes(lib, b: int, n: int, t: int, d: int, c: int, n_blocks: int,
                         final_ln: bool, bf16: bool, dev: int) -> int:
    """Bytes of device workspace ``m2m_mixer_bwd`` needs: the channel FF's
    operands (W3 and W4^T padded to Cp columns, z, da4, h2 and da3; in bf16
    compute stored in bf16, da3 as three planes), the slices' partials of dz,
    dW3, dW4, db3 and db4, the small gradients' partials, a stack's ping-pong
    buffers and, where the token FF runs as products, its buffers."""
    nbytes = lib.m2m_mixer_bwd_workspace_bytes(b, n, t, d, c, n_blocks, int(final_ln), int(bf16),
                                               dev)
    if nbytes == 0:
        raise ValueError(f"the CUDA mixer backward does not take B={b} N={n} T={t} D={d} "
                         f"C={c} ({n_blocks} blocks{', bf16' if bf16 else ''})")
    return nbytes


def _kernel_args(x, flat, n_blocks: int):
    """Validate shapes and devices; return (T, C, kernel-ready params, every
    one float32: in bf16 compute the kernels round them where JAX casts)."""
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"x must be float32 (B, N, D), got {x.dtype} {tuple(x.shape)}")
    B, N, D = x.shape
    T, C = flat[2].shape[1], flat[8].shape[1]
    if D % 4:
        raise ValueError(f"the CUDA mixer kernel needs hidden_dim % 4 == 0, got {D}")
    if not 1 <= n_blocks <= _MAX_BLOCKS:
        raise ValueError(f"the CUDA stack kernel runs 1..{_MAX_BLOCKS} blocks, got {n_blocks}")
    out = []
    for i, p in enumerate(flat):
        if p.device != x.device:
            raise ValueError(f"parameter {i} is on {p.device}, x on {x.device}")
        q = p.float().contiguous()
        if q.data_ptr() % 16:
            q = q.clone()
        out.append(q)
    expect = {0: (D,), 1: (D,), 2: (N, T), 3: (T,), 4: (T, N), 5: (N,), 6: (D,), 7: (D,),
              8: (D, C), 9: (C,), 10: (C, D), 11: (D,)}
    for k in range(n_blocks):
        for j, shp in expect.items():
            got = tuple(out[k * _N_BLOCK_PARAMS + j].shape)
            if got != shp:
                raise ValueError(f"block {k} param {MixerBlockParams._fields[j]}: "
                                 f"shape {got}, expected {shp}")
    return T, C, out


def _dropout_args(seed, rate: float, n_blocks: int):
    """(keys, thresh, scale) for a launch: 4 stream keys per block as a ctypes
    array, or None at rate 0."""
    if rate == 0.0:
        return None, 0, 1.0
    s = 0 if seed is None else int(seed)
    keys = [mask_key(s, k, m) for k in range(n_blocks) for m in range(_MASKS)]
    return (ctypes.c_uint * len(keys))(*keys), _thresh(rate), _scale(rate)


def _device_index(x) -> int:
    return x.device.index if x.device.index is not None else torch.cuda.current_device()


def _launch(entry: str, x, flat, n_blocks: int, final_ln: bool, compute_dtype,
            approximate_gelu: bool, seed=None, rate: float = 0.0, saved=None):
    """K1f (``entry`` "block") or K2f ("stack"): ``m2m_mixer_fwd``, float32
    or bf16 compute."""
    from ._build import check, load_library

    lib = load_library()
    bf16 = _check_compute_dtype(compute_dtype)
    x = x.contiguous()
    B, N, D = x.shape
    dev = _device_index(x)
    T, C, params = _kernel_args(x, flat, n_blocks)
    out = torch.empty_like(x)
    ptrs = (ctypes.c_void_p * len(params))(*[p.data_ptr() for p in params])
    keys, thresh, scale = _dropout_args(seed, rate, n_blocks)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    saved_ptr = None if saved is None else saved.data_ptr()
    nbytes = _fwd_workspace_bytes(lib, B, N, T, D, C, n_blocks, bf16, dev)
    workspace = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    code = lib.m2m_mixer_fwd(x.data_ptr(), out.data_ptr(), saved_ptr, B, N, T, D, C, n_blocks,
                             int(final_ln), int(approximate_gelu), keys, thresh, scale, int(bf16),
                             dev, ptrs, workspace.data_ptr(), stream)
    check(lib, code, f"mixer {entry} kernel launch")
    return out


def _launch_bwd(saved, g, flat, n_blocks: int, final_ln: bool, compute_dtype,
                approximate_gelu: bool, seed, rate: float):
    """dx and the float32 gradients of ``flat`` from ``csrc/mixer_bwd.cu``;
    ``saved``: the block inputs (+ the pre-LN output), (n_blocks + 1, B, N, D),
    or for one block without a final LN its input (B, N, D). In bf16 compute
    the channel FF's products run on the wgmma engine (``csrc/wgmma_bf16.cuh``;
    hidden_dim a multiple of 8)."""
    from ._build import check, load_library

    lib = load_library()
    bf16 = _check_compute_dtype(compute_dtype)
    g = g.float().contiguous()
    # float32 parameters in either dtype: in bf16 the kernel rounds w3/w4 as it
    # lays them out, the copies the JAX kernels read
    T, C, params = _kernel_args(g, flat, n_blocks)
    B, N, D = g.shape
    saved = saved.contiguous()
    if saved.dtype != torch.float32 or saved.device != g.device or \
            saved.numel() < (n_blocks + int(final_ln)) * g.numel():
        raise ValueError(f"saved block inputs {saved.dtype} {tuple(saved.shape)} on "
                         f"{saved.device} do not fit {n_blocks} blocks of {tuple(g.shape)}")
    dev = _device_index(g)
    nbytes = _bwd_workspace_bytes(lib, B, N, T, D, C, n_blocks, final_ln, bf16, dev)
    workspace = torch.empty(nbytes, dtype=torch.uint8, device=g.device)
    dx = torch.empty_like(g)
    grads = [torch.empty(p.shape, dtype=torch.float32, device=g.device) for p in params]
    ptrs = (ctypes.c_void_p * len(params))(*[p.data_ptr() for p in params])
    gptrs = (ctypes.c_void_p * len(grads))(*[q.data_ptr() for q in grads])
    keys, thresh, scale = _dropout_args(seed, rate, n_blocks)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    code = lib.m2m_mixer_bwd(saved.data_ptr(), g.data_ptr(), dx.data_ptr(), B, N, T, D, C,
                             n_blocks, int(final_ln), int(approximate_gelu), keys, thresh, scale,
                             int(bf16), dev, ptrs, gptrs, workspace.data_ptr(), stream)
    check(lib, code, "mixer backward kernel launch")
    return dx, tuple(grads)


def _token_ff(entry: str, x, flat) -> int:
    """1 if the kernel just launched for ``x`` ran its token FF as products
    (``csrc/token_ff.cuh``: above 32 tokens, or where a sample does not fit
    the register route's tiles), else 0; ``entry``: "fwd" or "bwd"."""
    B, N, D = x.shape
    return _token_ff_route(entry, B, N, flat[2].shape[1], D, flat[8].shape[1], _device_index(x))


@functools.lru_cache(maxsize=None)
def _token_ff_route(entry: str, B: int, N: int, T: int, D: int, C: int, dev: int) -> int:
    """``_token_ff`` for one shape (asked of the library once; a launch at
    batch 32 costs tens of µs on the host)."""
    from ._build import load_library

    lib = load_library()
    query = lib.m2m_mixer_fwd_token_ff if entry == "fwd" else lib.m2m_mixer_bwd_token_ff
    return int(query(B, N, T, D, C, dev) == 1)


def _route(x) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version (CPU
    tensor); anything else raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"the port's kernels run on CUDA (plain version on CPU), got {x.device}")


def _needs_grad(x, params) -> bool:
    return torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params))


def _n_blocks(flat, final_ln: bool) -> int:
    return (len(flat) - (2 if final_ln else 0)) // _N_BLOCK_PARAMS


def _autograd_of(fn, x, g, params):
    """(dx, parameter grads) of ``fn(x, params)`` against ``g``, by autograd."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_()
        pp = [p.detach().requires_grad_() for p in params]
        out = fn(xx, pp)
        grads = torch.autograd.grad(out, [xx, *pp], g)
    return grads[0], tuple(grads[1:])


def mixer_block_bwd_reference(x, g, params, dropout_rate: float = 0.0,
                              compute_dtype=torch.float32, approximate_gelu: bool = False,
                              seed=None):
    """Plain version of K1b: autograd of ``mixer_block_reference``."""
    return _autograd_of(lambda xx, pp: mixer_block_reference(
        xx, MixerBlockParams(*pp), dropout_rate, compute_dtype, approximate_gelu, seed),
        x, g, tuple(params))


def mixer_stack_bwd_reference(x, g, flat_params, dropout_rate: float = 0.0,
                              compute_dtype=torch.float32, final_ln: bool = True,
                              approximate_gelu: bool = False, seed=None):
    """Plain version of K2b: autograd of ``mixer_stack_reference``."""
    return _autograd_of(lambda xx, pp: mixer_stack_reference(
        xx, pp, compute_dtype, final_ln, approximate_gelu, dropout_rate, seed),
        x, g, tuple(flat_params))


def _block_forward(x, params, seed, rate, compute_dtype, approximate_gelu):
    if not _route(x):
        return mixer_block_reference(x, params, rate, compute_dtype, approximate_gelu, seed)
    out = _launch("block", x, tuple(params), 1, False, compute_dtype, approximate_gelu, seed,
                  rate)
    fused_mixer_block.launches += 1
    fused_mixer_block.token_ff_launches += _token_ff("fwd", x, params)
    return out


def _stack_forward(x, flat, seed, rate, compute_dtype, final_ln, approximate_gelu, save):
    """(output, saved block inputs or None)."""
    if not _route(x):
        return mixer_stack_reference(x, flat, compute_dtype, final_ln, approximate_gelu, rate,
                                     seed), None
    n = _n_blocks(flat, final_ln)
    saved = x.new_empty((n + 1, *x.shape), dtype=torch.float32) if save else None
    out = _launch("stack", x, flat, n, final_ln, compute_dtype, approximate_gelu, seed, rate,
                  saved)
    fused_mixer_stack.launches += 1
    fused_mixer_stack.token_ff_launches += _token_ff("fwd", x, flat)
    return out, saved


class _BlockFn(torch.autograd.Function):
    """K1f forward, K1b backward (plain version and its autograd on CPU)."""

    @staticmethod
    def forward(ctx, x, seed, rate, compute_dtype, approximate_gelu, *params):
        ctx.cfg = (seed, rate, compute_dtype, approximate_gelu)
        ctx.save_for_backward(x, *params)
        return _block_forward(x, params, seed, rate, compute_dtype, approximate_gelu)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        dx, grads = fused_mixer_block_bwd(x, g, params, *ctx.cfg)
        return (dx, None, None, None, None, *grads)


class _StackFn(torch.autograd.Function):
    """K2f forward (saving every block's input on CUDA), K2b backward."""

    @staticmethod
    def forward(ctx, x, seed, rate, compute_dtype, final_ln, approximate_gelu, *flat):
        out, saved = _stack_forward(x, flat, seed, rate, compute_dtype, final_ln,
                                    approximate_gelu, save=x.device.type == "cuda")
        ctx.cfg = (seed, rate, compute_dtype, final_ln, approximate_gelu)
        ctx.save_for_backward(x if saved is None else saved, *flat)
        return out

    @staticmethod
    def backward(ctx, g):
        xs, *flat = ctx.saved_tensors
        x, saved = (xs[0], xs) if xs.dim() == 4 else (xs, None)
        dx, grads = fused_mixer_stack_bwd(x, g, flat, *ctx.cfg, saved=saved)
        return (dx, None, None, None, None, None, *grads)


def fused_mixer_block(x, params: MixerBlockParams, seed=None, dropout_rate: float = 0.0,
                      compute_dtype=torch.float32, approximate_gelu: bool = False):
    """One fused MixerBlock, ``x (B, N, D) -> (B, N, D)`` (float32 in/out).

    ``seed`` keys the dropout masks (ignored at rate 0; None means 0). When
    ``x`` or a parameter requires a gradient, the call is differentiable and
    its backward is ``fused_mixer_block_bwd``."""
    rate = _check_rate(dropout_rate)
    params = tuple(params)
    if _needs_grad(x, params):
        return _BlockFn.apply(x, seed, rate, compute_dtype, approximate_gelu, *params)
    return _block_forward(x, params, seed, rate, compute_dtype, approximate_gelu)


fused_mixer_block.launches = 0
fused_mixer_block.token_ff_launches = 0


def fused_mixer_block_bwd(x, g, params, seed=None, dropout_rate: float = 0.0,
                          compute_dtype=torch.float32, approximate_gelu: bool = False):
    """K1b: ``(dx, 12 parameter gradients)`` of one fused MixerBlock at input
    ``x`` for output gradient ``g``, float32, the forward's masks regenerated;
    in bf16 compute rounded where JAX's AD of the block rounds them."""
    _check_compute_dtype(compute_dtype)
    rate = _check_rate(dropout_rate)
    params = tuple(params)
    if not _route(x):
        return mixer_block_bwd_reference(x, g, params, rate, compute_dtype, approximate_gelu,
                                         seed)
    out = _launch_bwd(x.float(), g, params, 1, False, compute_dtype, approximate_gelu, seed,
                      rate)
    fused_mixer_block_bwd.launches += 1
    fused_mixer_block_bwd.bf16_launches += int(compute_dtype == torch.bfloat16)
    fused_mixer_block_bwd.token_ff_launches += _token_ff("bwd", x, params)
    return out


fused_mixer_block_bwd.launches = 0
fused_mixer_block_bwd.bf16_launches = 0
fused_mixer_block_bwd.token_ff_launches = 0


def fused_mixer_stack(x, flat_params, seed=None, dropout_rate: float = 0.0,
                      compute_dtype=torch.float32, final_ln: bool = True,
                      approximate_gelu: bool = False):
    """K MixerBlocks (+ optionally the final LN) in one kernel launch.

    ``flat_params``: ``(*block0 12-tuple, *block1 12-tuple, ...[, ln_scale,
    ln_bias])`` as built by ``stack_flat_params``. Block k of the launch
    draws the dropout masks of block k. Differentiable as
    ``fused_mixer_block`` is, with ``fused_mixer_stack_bwd`` as backward."""
    rate = _check_rate(dropout_rate)
    flat = tuple(flat_params)
    if _needs_grad(x, flat):
        return _StackFn.apply(x, seed, rate, compute_dtype, final_ln, approximate_gelu, *flat)
    return _stack_forward(x, flat, seed, rate, compute_dtype, final_ln, approximate_gelu,
                          save=False)[0]


fused_mixer_stack.launches = 0
fused_mixer_stack.token_ff_launches = 0


def fused_mixer_stack_bwd(x, g, flat_params, seed=None, dropout_rate: float = 0.0,
                          compute_dtype=torch.float32, final_ln: bool = True,
                          approximate_gelu: bool = False, saved=None):
    """K2b: ``(dx, gradients of flat_params)`` of ``fused_mixer_stack``,
    float32, including the final LN's. ``saved``: the block inputs the
    differentiable forward kept on the card; without it (a direct call) one
    K2f launch recomputes them."""
    _check_compute_dtype(compute_dtype)
    rate = _check_rate(dropout_rate)
    flat = tuple(flat_params)
    if not _route(x):
        return mixer_stack_bwd_reference(x, g, flat, rate, compute_dtype, final_ln,
                                         approximate_gelu, seed)
    if saved is None:
        with torch.no_grad():
            _, saved = _stack_forward(x.float(), flat, seed, rate, compute_dtype, final_ln,
                                      approximate_gelu, save=True)
    out = _launch_bwd(saved, g, flat, _n_blocks(flat, final_ln), final_ln, compute_dtype,
                      approximate_gelu, seed, rate)
    fused_mixer_stack_bwd.launches += 1
    fused_mixer_stack_bwd.bf16_launches += int(compute_dtype == torch.bfloat16)
    fused_mixer_stack_bwd.token_ff_launches += _token_ff("bwd", x, flat)
    return out


fused_mixer_stack_bwd.launches = 0
fused_mixer_stack_bwd.bf16_launches = 0
fused_mixer_stack_bwd.token_ff_launches = 0


def fused_mixer_stack_grouped(x, blocks: Sequence[MixerBlockParams], ln_scale, ln_bias,
                              seed: Optional[int] = None, dropout_rate: float = 0.0,
                              compute_dtype=torch.float32, group_size: int = 0,
                              approximate_gelu: bool = False):
    """K MixerBlocks + final LN as ceil(K/group_size) stack launches.

    ``group_size=0`` (or >= K) is the single whole-stack launch. Group ``g``
    gets the seed ``seed + 7919*g``, as in the JAX package, so the dropout
    streams stay decorrelated per group."""
    k = len(blocks)
    if group_size <= 0 or group_size >= k:
        return fused_mixer_stack(x, stack_flat_params(blocks, ln_scale, ln_bias), seed,
                                 dropout_rate, compute_dtype, True, approximate_gelu)
    start, gi = 0, 0
    while start < k:
        group = blocks[start:start + group_size]
        last = start + len(group) >= k
        gseed = None if seed is None else int(seed) + 7919 * gi
        flat = stack_flat_params(group, ln_scale, ln_bias) if last else stack_flat_params(group)
        x = fused_mixer_stack(x, flat, gseed, dropout_rate, compute_dtype, last,
                              approximate_gelu)
        start += len(group)
        gi += 1
    return x
