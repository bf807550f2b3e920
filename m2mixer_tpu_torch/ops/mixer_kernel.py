"""Fused MixerBlock and mixer-stack forward: CUDA kernels and plain versions.

Counterpart of ``m2mixer_tpu/ops/mixer_kernel.py`` with the same public
layout: ``x (B, N, D)`` float32 in and out, ``w1 (N, T)``, ``w2 (T, N)``,
``w3 (D, C)``, ``w4 (C, D)`` (input-major, as the JAX kernels take them).

- ``mixer_block_reference`` / ``mixer_stack_reference`` are the plain
  PyTorch versions of ``_block_math`` / ``_stack_math``, cast for cast.
- ``fused_mixer_block`` (K1f) and ``fused_mixer_stack`` (K2f) launch the
  hand-written kernels of ``csrc/mixer_fwd.cu`` on CUDA tensors and count
  each launch in their ``launches`` attribute. A CPU tensor gets the plain
  version; a CUDA tensor gets the kernel or an error, never the plain
  version.
- ``fused_mixer_stack_grouped`` splits K blocks into ceil(K/G) stack
  launches with the JAX package's ``group_size`` semantics and
  ``seed + 7919*g`` seed folding.

Forward only, dropout rate 0: dropout (and the backward kernels) come with
the training slice.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

__all__ = [
    "MixerBlockParams",
    "cast_params",
    "fused_mixer_block",
    "fused_mixer_stack",
    "fused_mixer_stack_grouped",
    "mixer_block_reference",
    "mixer_stack_reference",
    "stack_flat_params",
]

_N_BLOCK_PARAMS = 12
_ROWS_MAX = 64  # kRowsMax in csrc/mixer_fwd.cu
_MAX_TOKENS = 32  # kMaxTokens
_MAX_BLOCKS = 32  # kMaxBlocks
_DROPOUT_MSG = "dropout in the CUDA kernel comes with the training slice"


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


def _block_math(x, p: MixerBlockParams, compute_dtype, approximate_gelu: bool):
    cd = compute_dtype
    B, N, D = x.shape

    def mm(a, w):  # operands in the compute dtype, float32 sums
        return torch.matmul(a.to(cd).float(), w.to(cd).float())

    x2 = x.to(cd).reshape(B * N, D)
    y = _layer_norm(x2, p.ln1_scale.to(cd), p.ln1_bias.to(cd))
    y_t = y.reshape(B, N, D).transpose(1, 2).reshape(B * D, N)
    h = _gelu(mm(y_t, p.w1) + p.b1, approximate_gelu)  # (B*D, T)
    t = mm(h, p.w2) + p.b2  # (B*D, N)
    t = t.reshape(B, D, N).transpose(1, 2).reshape(B * N, D)
    x1 = x2 + t.to(cd)

    z = _layer_norm(x1, p.ln2_scale.to(cd), p.ln2_bias.to(cd))
    h2 = _gelu(mm(z, p.w3) + p.b3, approximate_gelu)  # (B*N, C)
    c = mm(h2, p.w4) + p.b4  # (B*N, D)
    return (x1 + c.to(cd)).float().reshape(B, N, D)


def _check_dropout(dropout_rate: float) -> None:
    if float(dropout_rate) != 0.0:
        raise NotImplementedError(_DROPOUT_MSG)


def mixer_block_reference(x, params: MixerBlockParams, dropout_rate: float = 0.0,
                          compute_dtype=torch.float32, approximate_gelu: bool = False):
    """Plain PyTorch version of one fused MixerBlock (``_block_math``)."""
    _check_dropout(dropout_rate)
    return _block_math(x, MixerBlockParams(*cast_params(tuple(params), compute_dtype)),
                       compute_dtype, approximate_gelu)


def _unflatten_params(flat, has_ln: bool = True):
    end = len(flat) - 2 if has_ln else len(flat)
    blocks = [MixerBlockParams(*flat[i:i + _N_BLOCK_PARAMS])
              for i in range(0, end, _N_BLOCK_PARAMS)]
    if has_ln:
        return blocks, flat[-2], flat[-1]
    return blocks, None, None


def mixer_stack_reference(x, flat_params, compute_dtype=torch.float32,
                          final_ln: bool = True, approximate_gelu: bool = False):
    """Plain PyTorch version of K blocks + optional final LN
    (``_stack_apply``); ``flat_params`` as built by ``stack_flat_params``."""
    flat = cast_params(tuple(flat_params), compute_dtype)
    blocks, ln_s, ln_b = _unflatten_params(flat, has_ln=final_ln)
    for p in blocks:
        x = _block_math(x, p, compute_dtype, approximate_gelu)
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
    """The JAX package's storage rule: only the large channel-FF matrices
    (first dim >= 16, second >= 128) are stored in the compute dtype; token
    weights, biases and LN vectors stay float32. Storage only: every GEMM
    operand is rounded to the compute dtype either way, so a bf16 module
    holds w3/w4 in bf16 and no launch re-casts them."""
    return p.dim() == 2 and p.shape[0] >= 16 and p.shape[1] >= 128


def cast_params(flat_params, compute_dtype):
    """``flat_params`` with the castable ones in ``compute_dtype``: how the
    kernel-backed modules store their weights, and what the kernels read."""
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


@functools.lru_cache(maxsize=None)
def _device_limits(index: int):
    """(SM count, opt-in shared memory per CTA) of CUDA device ``index``."""
    props = torch.cuda.get_device_properties(index)
    return (props.multi_processor_count,
            getattr(props, "shared_memory_per_block_optin", 227 * 1024))


def _tile_plan(lib, b: int, n: int, d: int, t: int, bf16: bool, sms: int, limit: int):
    """(samples per row tile, CTAs per cluster) on a card of ``sms`` SMs
    offering ``limit`` bytes of shared memory per CTA. Tiles of two samples,
    grown (up to 64 rows) until the tiles fit on the SMs in one wave; then
    the largest cluster of 1, 2 or 4 CTAs that still fits splits each
    tile's hidden units. The tile shrinks when shared memory demands it."""
    tb = 2
    while tb * 2 * n <= _ROWS_MAX and -(-b // tb) > sms:
        tb *= 2
    tb = min(tb, max(1, _ROWS_MAX // n))
    while tb > 1 and lib.m2m_mixer_smem_bytes(tb, n, d, t, int(bf16)) > limit:
        tb -= 1
    if lib.m2m_mixer_smem_bytes(tb, n, d, t, int(bf16)) > limit:
        raise ValueError(f"the CUDA mixer kernel needs more shared memory than the card "
                         f"offers at hidden_dim {d}, {n} tokens, token_dim {t}")
    tiles = -(-b // tb)
    cluster = next((s for s in (4, 2) if tiles * s <= sms), 1)
    return tb, cluster


def _kernel_args(x, flat, n_blocks: int, bf16: bool):
    """Validate shapes and devices; return (T, C, kernel-ready params)."""
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"x must be float32 (B, N, D), got {x.dtype} {tuple(x.shape)}")
    B, N, D = x.shape
    T, C = flat[2].shape[1], flat[8].shape[1]
    if N > _MAX_TOKENS:
        raise ValueError(f"the CUDA mixer kernel takes at most {_MAX_TOKENS} tokens, got {N}")
    if D % 4:
        raise ValueError(f"the CUDA mixer kernel needs hidden_dim % 4 == 0, got {D}")
    if bf16 and C % 2:
        raise ValueError(f"the bf16 CUDA mixer kernel needs an even channel_dim, got {C}")
    if not 1 <= n_blocks <= _MAX_BLOCKS:
        raise ValueError(f"the CUDA stack kernel runs 1..{_MAX_BLOCKS} blocks, got {n_blocks}")
    wdt = torch.bfloat16 if bf16 else torch.float32
    out = []
    for i, p in enumerate(flat):
        if p.device != x.device:
            raise ValueError(f"parameter {i} is on {p.device}, x on {x.device}")
        # w3/w4 enter in the kernel's weight dtype (the castable ones already
        # are); everything else is float32 and rounded inside the kernel
        big = i < n_blocks * _N_BLOCK_PARAMS and i % _N_BLOCK_PARAMS in (8, 10)
        q = p.to(wdt if big else torch.float32).contiguous()
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


def _launch(entry: str, x, flat, n_blocks: int, final_ln: bool, compute_dtype,
            approximate_gelu: bool):
    from ._build import check, load_library

    lib = load_library()
    bf16 = _check_compute_dtype(compute_dtype)
    x = x.contiguous()
    T, C, params = _kernel_args(x, flat, n_blocks, bf16)
    B, N, D = x.shape
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    tb, cluster = _tile_plan(lib, B, N, D, T, bf16, *_device_limits(dev))
    out = torch.empty_like(x)
    ptrs = (ctypes.c_void_p * len(params))(*[p.data_ptr() for p in params])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if entry == "block":
        code = lib.m2m_mixer_block_fwd(x.data_ptr(), out.data_ptr(), B, N, T, D, C, tb,
                                       cluster, int(bf16), int(approximate_gelu), dev, ptrs,
                                       stream)
    else:
        code = lib.m2m_mixer_stack_fwd(x.data_ptr(), out.data_ptr(), B, N, T, D, C, tb,
                                       cluster, n_blocks, int(final_ln), int(bf16),
                                       int(approximate_gelu), dev, ptrs, stream)
    check(lib, code, f"mixer {entry} kernel launch")
    return out


def _route(x) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version (CPU
    tensor); anything else raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"the mixer kernels run on CUDA (plain version on CPU), got {x.device}")


def fused_mixer_block(x, params: MixerBlockParams, seed=None, dropout_rate: float = 0.0,
                      compute_dtype=torch.float32, approximate_gelu: bool = False):
    """One fused MixerBlock, ``x (B, N, D) -> (B, N, D)`` (float32 in/out).

    ``seed`` is accepted for signature parity with the JAX kernel and unused
    at dropout rate 0, the only rate this slice supports."""
    _check_dropout(dropout_rate)
    if not _route(x):
        return mixer_block_reference(x, params, 0.0, compute_dtype, approximate_gelu)
    out = _launch("block", x, tuple(params), 1, False, compute_dtype, approximate_gelu)
    fused_mixer_block.launches += 1
    return out


fused_mixer_block.launches = 0


def fused_mixer_stack(x, flat_params, seed=None, dropout_rate: float = 0.0,
                      compute_dtype=torch.float32, final_ln: bool = True,
                      approximate_gelu: bool = False):
    """K MixerBlocks (+ optionally the final LN) in one kernel launch.

    ``flat_params``: ``(*block0 12-tuple, *block1 12-tuple, ...[, ln_scale,
    ln_bias])`` as built by ``stack_flat_params``."""
    _check_dropout(dropout_rate)
    flat = tuple(flat_params)
    if not _route(x):
        return mixer_stack_reference(x, flat, compute_dtype, final_ln, approximate_gelu)
    n_blocks = (len(flat) - (2 if final_ln else 0)) // _N_BLOCK_PARAMS
    out = _launch("stack", x, flat, n_blocks, final_ln, compute_dtype, approximate_gelu)
    fused_mixer_stack.launches += 1
    return out


fused_mixer_stack.launches = 0


def fused_mixer_stack_grouped(x, blocks: Sequence[MixerBlockParams], ln_scale, ln_bias,
                              seed: Optional[int] = None, dropout_rate: float = 0.0,
                              compute_dtype=torch.float32, group_size: int = 0,
                              approximate_gelu: bool = False):
    """K MixerBlocks + final LN as ceil(K/group_size) stack launches.

    ``group_size=0`` (or >= K) is the single whole-stack launch. Group ``g``
    gets the seed ``seed + 7919*g``, as in the JAX package, so the dropout
    streams of the training slice stay decorrelated per group."""
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
