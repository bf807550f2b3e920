"""Fused gMLP block: CUDA kernels, plain version, gradient.

Counterpart of ``m2mixer_tpu/ops/gmlp_kernel.py`` with the same public
layout: ``x (B, N, D)`` float32 in and out, ``w_in (D, F)``, ``sgu_w (N, N)``
(the token projection, ``t[n] = sum_m v[m] sgu_w[m, n] + sgu_b[n]``) and
``w_out (F/2, D)``, input-major as the JAX kernel takes them.

- ``gmlp_block_reference`` is the plain PyTorch version of ``_block_math``,
  step for step (mask 0 before the GELU, the token projection in the
  transposed ``(B*F/2, N)`` layout); ``gmlp_block_bwd_reference`` is autograd
  of it.
- ``fused_gmlp_block`` (K3f) launches the hand-written kernels of
  ``csrc/gmlp.cu`` on CUDA tensors. When a gradient is wanted it runs inside
  a ``torch.autograd.Function`` that saves only the block input and whose
  backward is ``fused_gmlp_block_bwd`` (K3b), which recomputes the block.
  Each wrapper counts its launches in its ``launches`` attribute. A CPU
  tensor gets the plain version (the backward: autograd of it); a CUDA tensor
  gets the kernel or an error, never the plain version.
- Float32 only: ``compute_dtype=torch.bfloat16`` raises ``NotImplementedError``
  on both routes.

Dropout masks are the hash masks of ``ops/mixer_kernel.py`` for block 0 of a
launch seeded with ``seed``, mask ids 0-2, counted in the JAX layouts:
mask 0 ``(B*N, F)``, mask 1 ``(B*F/2, N)``, mask 2 ``(B*N, D)``. Stochastic
depth stays outside the kernel (``modules/gmlp.py``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .mixer_kernel import (_autograd_of, _check_rate, _device_index, _dropout_args, _gelu,
                           _layer_norm, _needs_grad, _route, dropout_mask)

__all__ = ["GmlpBlockParams", "fused_gmlp_block", "fused_gmlp_block_bwd",
           "gmlp_block_bwd_reference", "gmlp_block_reference", "gmlp_masks"]

_MAX_TOKENS = 128  # kMaxSeq in csrc/gmlp.cu
_BF16_MSG = ("not yet ported: the fused gMLP kernels run in float32 only (model.precision: "
             "bf16 with the PallasVisiongMLP/PallasFusiongMLP block types)")


class GmlpBlockParams(NamedTuple):
    ln_scale: torch.Tensor  # (D,)
    ln_bias: torch.Tensor
    w_in: torch.Tensor  # (D, F)
    b_in: torch.Tensor  # (F,)
    sgu_ln_scale: torch.Tensor  # (F/2,)
    sgu_ln_bias: torch.Tensor
    sgu_w: torch.Tensor  # (N, N) token projection
    sgu_b: torch.Tensor  # (N,)
    w_out: torch.Tensor  # (F/2, D)
    b_out: torch.Tensor  # (D,)


def gmlp_masks(seed, B: int, N: int, D: int, F: int, rate: float, device=None):
    """The three masks of one block in the JAX layouts: (B*N, F), (B*F/2, N),
    (B*N, D); None at rate 0."""
    if rate == 0.0:
        return None
    s = 0 if seed is None else int(seed)
    shapes = [(B * N, F), (B * (F // 2), N), (B * N, D)]
    return tuple(dropout_mask(s, 0, m, r, c, rate, device) for m, (r, c) in enumerate(shapes))


def _block_math(x, p: GmlpBlockParams, approximate_gelu: bool, masks=None):
    B, N, D = x.shape
    half = p.w_in.shape[1] // 2
    x2 = x.reshape(B * N, D)
    y = _layer_norm(x2, p.ln_scale, p.ln_bias)
    y = y @ p.w_in + p.b_in  # (B*N, F)
    if masks is not None:
        y = y * masks[0]
    y = _gelu(y, approximate_gelu)
    u, v = y[:, :half], y[:, half:]
    v = _layer_norm(v, p.sgu_ln_scale, p.sgu_ln_bias)
    # token projection across N: rows become (B*half, N)
    v = v.reshape(B, N, half).transpose(1, 2).reshape(B * half, N)
    v = v @ p.sgu_w + p.sgu_b
    if masks is not None:
        v = v * masks[1]
    v = v.reshape(B, half, N).transpose(1, 2).reshape(B * N, half)
    out = (u * v) @ p.w_out + p.b_out  # (B*N, D)
    if masks is not None:
        out = out * masks[2]
    return (x2 + out).reshape(B, N, D)


def _check_dtype(x, compute_dtype) -> None:
    if compute_dtype != torch.float32:
        raise NotImplementedError(_BF16_MSG)
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"x must be float32 (B, N, D), got {x.dtype} {tuple(x.shape)}")


def gmlp_block_reference(x, params: GmlpBlockParams, dropout_rate: float = 0.0,
                         approximate_gelu: bool = False, seed=None):
    """Plain PyTorch version of one fused gMLP block (``_block_math``), with
    the kernel's dropout masks of a launch seeded with ``seed``."""
    rate = _check_rate(dropout_rate)
    p = GmlpBlockParams(*params)
    B, N, D = x.shape
    masks = gmlp_masks(seed, B, N, D, p.w_in.shape[1], rate, x.device)
    return _block_math(x, p, approximate_gelu, masks)


def gmlp_block_bwd_reference(x, g, params, dropout_rate: float = 0.0,
                             approximate_gelu: bool = False, seed=None):
    """Plain version of K3b: autograd of ``gmlp_block_reference``."""
    return _autograd_of(lambda xx, pp: gmlp_block_reference(
        xx, GmlpBlockParams(*pp), dropout_rate, approximate_gelu, seed), x, g, tuple(params))


# ------------------------------------------------------------------ kernels
def _kernel_params(x, params):
    """Validate shapes and devices; return the parameters as contiguous
    float32 tensors on x's device."""
    B, N, D = x.shape
    F = params[2].shape[-1]
    if N > _MAX_TOKENS:
        raise ValueError(f"the CUDA gMLP kernel takes at most {_MAX_TOKENS} tokens, got {N}")
    if F < 2 or F % 2:
        raise ValueError(f"the CUDA gMLP kernel needs an even d_ffn, got {F}")
    expect = [(D,), (D,), (D, F), (F,), (F // 2,), (F // 2,), (N, N), (N,), (F // 2, D), (D,)]
    out = []
    for name, p, shape in zip(GmlpBlockParams._fields, params, expect):
        if p.device != x.device:
            raise ValueError(f"parameter {name} is on {p.device}, x on {x.device}")
        if tuple(p.shape) != shape:
            raise ValueError(f"parameter {name}: shape {tuple(p.shape)}, expected {shape}")
        out.append(p.float().contiguous())
    return out


def _launch(x, params, approximate_gelu: bool, seed, rate: float, g=None):
    """K3f (``g`` None): the block's output; K3b: (dx, the 10 float32
    parameter gradients)."""
    from ._build import check, load_library

    lib = load_library()
    x = x.contiguous()
    params = _kernel_params(x, params)
    B, N, D = x.shape
    F = params[2].shape[1]
    dev = _device_index(x)
    backward = g is not None
    nbytes = lib.m2m_gmlp_workspace_bytes(B, N, D, F, int(backward), dev)
    if nbytes == 0:
        raise ValueError(f"the CUDA gMLP kernel does not take B={B} N={N} D={D} F={F}")
    workspace = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    ptrs = (ctypes.c_void_p * len(params))(*[p.data_ptr() for p in params])
    keys, thresh, scale = _dropout_args(seed, rate, 1)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if not backward:
        out = torch.empty_like(x)
        code = lib.m2m_gmlp_fwd(x.data_ptr(), out.data_ptr(), B, N, D, F, int(approximate_gelu),
                                keys, thresh, scale, dev, ptrs, workspace.data_ptr(), stream)
        check(lib, code, "gMLP forward kernel launch")
        return out
    g = g.float().contiguous()
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"gradient {tuple(g.shape)} on {g.device} does not match x "
                         f"{tuple(x.shape)} on {x.device}")
    dx = torch.empty_like(x)
    grads = [torch.empty(p.shape, dtype=torch.float32, device=x.device) for p in params]
    gptrs = (ctypes.c_void_p * len(grads))(*[q.data_ptr() for q in grads])
    code = lib.m2m_gmlp_bwd(x.data_ptr(), g.data_ptr(), dx.data_ptr(), B, N, D, F,
                            int(approximate_gelu), keys, thresh, scale, dev, ptrs, gptrs,
                            workspace.data_ptr(), stream)
    check(lib, code, "gMLP backward kernel launch")
    return dx, tuple(grads)


def _forward(x, params, seed, rate, approximate_gelu):
    if not _route(x):
        return gmlp_block_reference(x, params, rate, approximate_gelu, seed)
    out = _launch(x, params, approximate_gelu, seed, rate)
    fused_gmlp_block.launches += 1
    return out


class _GmlpFn(torch.autograd.Function):
    """K3f forward, K3b backward (plain version and its autograd on CPU);
    saves only the block input, as the JAX kernel's backward recomputes."""

    @staticmethod
    def forward(ctx, x, seed, rate, approximate_gelu, *params):
        ctx.cfg = (seed, rate, approximate_gelu)
        ctx.save_for_backward(x, *params)
        return _forward(x, params, seed, rate, approximate_gelu)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        seed, rate, approx = ctx.cfg
        dx, grads = fused_gmlp_block_bwd(x, g, params, seed, rate, approximate_gelu=approx)
        return (dx, None, None, None, *grads)


def fused_gmlp_block(x, params: GmlpBlockParams, seed=None, dropout_rate: float = 0.0,
                     compute_dtype=torch.float32, approximate_gelu: bool = False):
    """One fused gMLP block, ``x (B, N, D) -> (B, N, D)`` (float32).

    ``seed`` keys the dropout masks (ignored at rate 0; None means 0). When
    ``x`` or a parameter requires a gradient, the call is differentiable and
    its backward is ``fused_gmlp_block_bwd``."""
    _check_dtype(x, compute_dtype)
    rate = _check_rate(dropout_rate)
    params = tuple(params)
    if _needs_grad(x, params):
        return _GmlpFn.apply(x, seed, rate, approximate_gelu, *params)
    return _forward(x, params, seed, rate, approximate_gelu)


fused_gmlp_block.launches = 0


def fused_gmlp_block_bwd(x, g, params, seed=None, dropout_rate: float = 0.0,
                         compute_dtype=torch.float32, approximate_gelu: bool = False):
    """K3b: ``(dx, 10 parameter gradients)`` of one fused gMLP block at input
    ``x`` for output gradient ``g``, float32, the forward's masks regenerated."""
    _check_dtype(x, compute_dtype)
    rate = _check_rate(dropout_rate)
    params = tuple(params)
    if not _route(x):
        return gmlp_block_bwd_reference(x, g, params, rate, approximate_gelu, seed)
    out = _launch(x, params, approximate_gelu, seed, rate, g=g)
    fused_gmlp_block_bwd.launches += 1
    return out


fused_gmlp_block_bwd.launches = 0
