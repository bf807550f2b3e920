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
- ``compute_dtype`` is float32 or bfloat16. In bf16 both routes follow the
  casts of JAX's ``_block_math``: x rounded to bf16; LN1 with float32
  statistics of the bf16 values, its scale and bias read rounded, its output
  rounded; the D->F, token and F/2->D products on bf16 operands (the weights
  arrive in float32 and are rounded where JAX casts them) with float32 sums
  and float32 biases; mask 0, the GELU and LN(v) in float32 (LN(v)'s scale
  and bias read rounded, its output not); the gate ``bf16(u) * bf16(t')`` and
  the residual ``bf16(x) + bf16(out)`` as bf16 operations; the output widened
  to float32. The backward (autograd of the plain version on the CPU, K3b on
  the card) rounds the cotangent of each of those casts to bf16: g, both
  sides of the gate, each product operand's (so dW_in, d sgu_w and dW_out,
  each summed over the whole batch first), LN1's input gradient and the LN
  scale and bias gradients; the bias gradients stay float32. On the card the
  bf16 kernels run their D x F and F/2 x D products on the wgmma engine
  (``csrc/wgmma_bf16.cuh``), their operands bf16 in the workspace. Each
  wrapper counts its bf16 launches alone too, in ``bf16_launches``.

Any token count up to ``_MAX_TOKENS`` runs: up to 128 the SGU keeps a
sample's token projection in shared memory; above it the large-N route runs
the token projection and its gradients as products over the ``(B*F/2, N)``
rows of ``_block_math``'s own layout (``csrc/gmlp.cu``), which the library
tallies as ``gmlp_vt_kernel``.

Dropout masks are the hash masks of ``ops/mixer_kernel.py`` for block 0 of a
launch seeded with ``seed``, mask ids 0-2, counted in the JAX layouts:
mask 0 ``(B*N, F)``, mask 1 ``(B*F/2, N)``, mask 2 ``(B*N, D)``. Stochastic
depth stays outside the kernel (``modules/gmlp.py``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .mixer_kernel import (_autograd_of, _check_compute_dtype, _check_rate, _device_index,
                           _dropout_args, _gelu, _layer_norm, _needs_grad, _route, dropout_mask)

__all__ = ["GmlpBlockParams", "fused_gmlp_block", "fused_gmlp_block_bwd",
           "gmlp_block_bwd_reference", "gmlp_block_reference", "gmlp_masks"]

_MAX_TOKENS = 46340  # kMaxSeq in csrc/gmlp.cu: sgu_w's N x N elements counted in int


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


def _block_math(x, p: GmlpBlockParams, approximate_gelu: bool, masks=None,
                compute_dtype=torch.float32):
    cd = compute_dtype
    B, N, D = x.shape
    half = p.w_in.shape[1] // 2

    def mm(a, w):  # operands in the compute dtype, float32 sums
        return torch.matmul(a.to(cd).float(), w.to(cd).float())

    x2 = x.to(cd).reshape(B * N, D)
    y = _layer_norm(x2, p.ln_scale.to(cd), p.ln_bias.to(cd))
    y = mm(y, p.w_in) + p.b_in  # (B*N, F)
    if masks is not None:
        y = y * masks[0]
    y = _gelu(y, approximate_gelu)
    u, v = y[:, :half], y[:, half:]
    v = _layer_norm(v, p.sgu_ln_scale.to(cd), p.sgu_ln_bias.to(cd))
    # token projection across N: rows become (B*half, N)
    v = v.reshape(B, N, half).transpose(1, 2).reshape(B * half, N)
    v = mm(v, p.sgu_w) + p.sgu_b
    if masks is not None:
        v = v * masks[1]
    v = v.reshape(B, half, N).transpose(1, 2).reshape(B * N, half)
    gated = u.to(cd) * v.to(cd)
    out = mm(gated, p.w_out) + p.b_out  # (B*N, D)
    if masks is not None:
        out = out * masks[2]
    return (x2 + out.to(cd)).float().reshape(B, N, D)


def _check_dtype(x, compute_dtype) -> bool:
    """True for bf16 compute, False for float32; anything else raises."""
    bf16 = _check_compute_dtype(compute_dtype)
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"x must be float32 (B, N, D), got {x.dtype} {tuple(x.shape)}")
    return bf16


def gmlp_block_reference(x, params: GmlpBlockParams, dropout_rate: float = 0.0,
                         approximate_gelu: bool = False, seed=None, compute_dtype=torch.float32):
    """Plain PyTorch version of one fused gMLP block (``_block_math``), with
    the kernel's dropout masks of a launch seeded with ``seed``."""
    rate = _check_rate(dropout_rate)
    p = GmlpBlockParams(*params)
    B, N, D = x.shape
    masks = gmlp_masks(seed, B, N, D, p.w_in.shape[1], rate, x.device)
    return _block_math(x, p, approximate_gelu, masks, compute_dtype)


def gmlp_block_bwd_reference(x, g, params, dropout_rate: float = 0.0,
                             approximate_gelu: bool = False, seed=None,
                             compute_dtype=torch.float32):
    """Plain version of K3b: autograd of ``gmlp_block_reference``."""
    return _autograd_of(lambda xx, pp: gmlp_block_reference(
        xx, GmlpBlockParams(*pp), dropout_rate, approximate_gelu, seed, compute_dtype),
        x, g, tuple(params))


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


def _workspace_bytes(lib, B: int, N: int, D: int, F: int, backward: bool, bf16: bool,
                     dev: int) -> int:
    """Bytes of device workspace K3f (``backward`` False) or K3b needs: the
    activations between their launches (xn, h or pm, gated, LN(v)'s
    statistics; the backward's dout, dgated, dpre, dxn's slices) and the
    partials of the gradients. In bf16 compute the products' operands (xn,
    gated, dout, dgated and the rounded weights) lie in bf16, rows padded to
    8 elements, and dpre as three bf16 planes."""
    nbytes = lib.m2m_gmlp_workspace_bytes(B, N, D, F, int(backward), int(bf16), dev)
    if nbytes == 0:
        raise ValueError(f"the CUDA gMLP kernel does not take B={B} N={N} D={D} F={F}"
                         f"{' (bf16)' if bf16 else ''}")
    return nbytes


def _launch(x, params, approximate_gelu: bool, seed, rate: float, bf16: bool, g=None):
    """K3f (``g`` None): the block's output; K3b: (dx, the 10 float32
    parameter gradients); ``bf16``: bf16 compute (``csrc/gmlp.cu``'s casts;
    the parameters stay float32, the kernels round them where JAX casts)."""
    from ._build import check, load_library

    lib = load_library()
    x = x.contiguous()
    params = _kernel_params(x, params)
    B, N, D = x.shape
    F = params[2].shape[1]
    dev = _device_index(x)
    backward = g is not None
    nbytes = _workspace_bytes(lib, B, N, D, F, backward, bf16, dev)
    workspace = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    ptrs = (ctypes.c_void_p * len(params))(*[p.data_ptr() for p in params])
    keys, thresh, scale = _dropout_args(seed, rate, 1)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if not backward:
        out = torch.empty_like(x)
        code = lib.m2m_gmlp_fwd(x.data_ptr(), out.data_ptr(), B, N, D, F, int(approximate_gelu),
                                keys, thresh, scale, int(bf16), dev, ptrs, workspace.data_ptr(),
                                stream)
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
                            int(approximate_gelu), keys, thresh, scale, int(bf16), dev, ptrs,
                            gptrs, workspace.data_ptr(), stream)
    check(lib, code, "gMLP backward kernel launch")
    return dx, tuple(grads)


def _forward(x, params, seed, rate, compute_dtype, approximate_gelu):
    if not _route(x):
        return gmlp_block_reference(x, params, rate, approximate_gelu, seed, compute_dtype)
    bf16 = compute_dtype == torch.bfloat16
    out = _launch(x, params, approximate_gelu, seed, rate, bf16)
    fused_gmlp_block.launches += 1
    fused_gmlp_block.bf16_launches += int(bf16)
    return out


class _GmlpFn(torch.autograd.Function):
    """K3f forward, K3b backward (plain version and its autograd on CPU);
    saves only the block input, as the JAX kernel's backward recomputes."""

    @staticmethod
    def forward(ctx, x, seed, rate, compute_dtype, approximate_gelu, *params):
        ctx.cfg = (seed, rate, compute_dtype, approximate_gelu)
        ctx.save_for_backward(x, *params)
        return _forward(x, params, seed, rate, compute_dtype, approximate_gelu)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        seed, rate, cd, approx = ctx.cfg
        dx, grads = fused_gmlp_block_bwd(x, g, params, seed, rate, cd, approx)
        return (dx, None, None, None, None, *grads)


def fused_gmlp_block(x, params: GmlpBlockParams, seed=None, dropout_rate: float = 0.0,
                     compute_dtype=torch.float32, approximate_gelu: bool = False):
    """One fused gMLP block, ``x (B, N, D) -> (B, N, D)`` (float32 in and out,
    float32 or bf16 compute).

    ``seed`` keys the dropout masks (ignored at rate 0; None means 0). When
    ``x`` or a parameter requires a gradient, the call is differentiable and
    its backward is ``fused_gmlp_block_bwd``."""
    _check_dtype(x, compute_dtype)
    rate = _check_rate(dropout_rate)
    params = tuple(params)
    if _needs_grad(x, params):
        return _GmlpFn.apply(x, seed, rate, compute_dtype, approximate_gelu, *params)
    return _forward(x, params, seed, rate, compute_dtype, approximate_gelu)


fused_gmlp_block.launches = 0
fused_gmlp_block.bf16_launches = 0


def fused_gmlp_block_bwd(x, g, params, seed=None, dropout_rate: float = 0.0,
                         compute_dtype=torch.float32, approximate_gelu: bool = False):
    """K3b: ``(dx, 10 parameter gradients)`` of one fused gMLP block at input
    ``x`` for output gradient ``g``, float32 (in bf16 compute rounded where
    JAX's AD of the block rounds them), the forward's masks regenerated."""
    bf16 = _check_dtype(x, compute_dtype)
    rate = _check_rate(dropout_rate)
    params = tuple(params)
    if not _route(x):
        return gmlp_block_bwd_reference(x, g, params, rate, approximate_gelu, seed,
                                        compute_dtype)
    out = _launch(x, params, approximate_gelu, seed, rate, bf16, g=g)
    fused_gmlp_block_bwd.launches += 1
    fused_gmlp_block_bwd.bf16_launches += int(bf16)
    return out


fused_gmlp_block_bwd.launches = 0
fused_gmlp_block_bwd.bf16_launches = 0
