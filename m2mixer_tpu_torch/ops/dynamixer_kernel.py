"""Fused DynaMixerOp: CUDA kernels, plain version, gradient.

Counterpart of ``m2mixer_tpu/ops/dynamixer_kernel.py``: ``x (S, L, C)``
float32 in and out (S sequences of L tokens). The three weights are
output-major, as the port's ``Linear`` layers store them and the kernels
read them: ``w_compress (H*R, C)``, ``w_generate (L*L, L*R)``, ``w_out (C,
C)``, the JAX kernel's input-major matrices transposed; their gradients come
back in the same layout.

- ``dynamixer_op_reference`` is the plain PyTorch version of ``_op_math``,
  step for step: compress ``C -> H*R``; the compressed features ``(S, L, H,
  R)`` transposed to ``(S, H, L*R)`` (row index ``l*R + r``); generate
  ``L*R -> L*L`` per head, read as ``w[m, l]`` at ``m*L + l``; softmax over
  ``m``, the source token (axis -2); the per-head token mix ``mixed[l, c] =
  sum_m w_h[m, l] x[m, c]`` with ``h = c // (C/H)``; the output projection.
  ``dynamixer_op_bwd_reference`` is autograd of it.
- ``fused_dynamixer_op`` (K4f) launches the hand-written kernels of
  ``csrc/dynamixer.cu`` on CUDA tensors, at any L and C: every product runs
  over all rows through device memory (float32 on 3xTF32 tensor cores, bf16
  on the wgmma engine) and the softmax and the mix a warp per (sequence,
  head). When a
  gradient is wanted it runs inside a ``torch.autograd.Function`` that
  saves only ``x`` (and the parameters it was given) and whose backward is
  ``fused_dynamixer_op_bwd`` (K4b), which recomputes the forward's small
  intermediates. Each wrapper counts its launches in its ``launches``
  attribute. A CPU tensor gets the plain version (the backward: autograd of
  it); a CUDA tensor gets the kernel or an error, never the plain version.
- ``compute_dtype`` is float32 or bfloat16. In bf16 the kernels follow
  ``_op_math``'s casts: x rounded to bf16; the compress, generate and output
  products on bf16 operands (the parameters arrive in float32 and are
  rounded where JAX casts ``w.astype(cd)``) with float32 sums and float32
  biases; the softmax in float32; the token mix of float32 weights and bf16
  x in float32; the output float32. The backward is the VJP of that
  (autograd of the plain version on the CPU): the cotangent of each bf16
  operand is rounded to bf16, so dx and the three weight gradients are
  rounded where JAX's AD rounds them, the bias gradients are not. Each
  wrapper counts its bf16 launches alone too, in ``bf16_launches``. The op
  has no dropout.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .mixer_kernel import _autograd_of, _device_index, _needs_grad, _route

__all__ = ["DynaMixerOpParams", "dynamixer_op_reference", "dynamixer_op_bwd_reference",
           "fused_dynamixer_op", "fused_dynamixer_op_bwd"]


class DynaMixerOpParams(NamedTuple):
    w_compress: torch.Tensor  # (H*R, C)
    b_compress: torch.Tensor  # (H*R,)
    w_generate: torch.Tensor  # (L*L, L*R)
    b_generate: torch.Tensor  # (L*L,)
    w_out: torch.Tensor  # (C, C), output-major
    b_out: torch.Tensor  # (C,)


def _op_math(x, p: DynaMixerOpParams, num_head: int, reduced_dim: int, compute_dtype):
    cd = compute_dtype
    S, L, C = x.shape
    H, R = num_head, reduced_dim

    def mm(a, w):  # a @ w.T, operands in the compute dtype, float32 sums
        return torch.matmul(a.to(cd).float(), w.to(cd).float().t())

    w = mm(x.reshape(S * L, C), p.w_compress) + p.b_compress  # (S*L, H*R)
    w = w.reshape(S, L, H, R).transpose(1, 2).reshape(S * H, L * R)
    w = mm(w, p.w_generate) + p.b_generate  # (S*H, L*L)
    w = torch.softmax(w.reshape(S * H, L, L), dim=-2)  # over the source token m, float32
    xh = x.to(cd).float().reshape(S, L, H, C // H).transpose(1, 2).reshape(S * H, L, C // H)
    mixed = torch.bmm(w.transpose(1, 2), xh)  # (S*H, L, C/H): sum_m w[m, l] x[m, c]
    mixed = mixed.reshape(S, H, L, C // H).transpose(1, 2).reshape(S * L, C)
    return (mm(mixed, p.w_out) + p.b_out).reshape(S, L, C)


def _check_dtype(compute_dtype) -> bool:
    """True for bf16 compute, False for float32; anything else raises."""
    if compute_dtype == torch.float32:
        return False
    if compute_dtype == torch.bfloat16:
        return True
    raise ValueError(f"compute_dtype {compute_dtype}: the DynaMixerOp kernels take float32 "
                     "or bfloat16")


def _check(x, num_head: int, reduced_dim: int, compute_dtype) -> None:
    _check_dtype(compute_dtype)
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"x must be float32 (S, L, C), got {x.dtype} {tuple(x.shape)}")
    if num_head < 1 or reduced_dim < 1 or x.shape[2] % num_head:
        raise ValueError(f"C = {x.shape[2]} must split into num_head = {num_head} heads "
                         f"(reduced_dim {reduced_dim})")


def dynamixer_op_reference(x, params: DynaMixerOpParams, num_head: int, reduced_dim: int = 2,
                           compute_dtype=torch.float32):
    """Plain PyTorch version of one fused DynaMixerOp (``_op_math``, cast for
    cast in bf16 compute)."""
    return _op_math(x, DynaMixerOpParams(*params), num_head, reduced_dim, compute_dtype)


def dynamixer_op_bwd_reference(x, g, params, num_head: int, reduced_dim: int = 2,
                               compute_dtype=torch.float32):
    """Plain version of K4b: autograd of ``dynamixer_op_reference``."""
    return _autograd_of(lambda xx, pp: dynamixer_op_reference(
        xx, DynaMixerOpParams(*pp), num_head, reduced_dim, compute_dtype), x, g, tuple(params))


# ------------------------------------------------------------------ kernels
def _check_kernel_args(x, params, num_head: int, reduced_dim: int) -> None:
    """Check x and the parameters for the kernels: device, dtype, shape and
    contiguity. Raises on anything else."""
    S, L, C = x.shape
    if len(params) != len(DynaMixerOpParams._fields):
        raise ValueError(f"expected {len(DynaMixerOpParams._fields)} parameters, got {len(params)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    HR, LR, LL = num_head * reduced_dim, L * reduced_dim, L * L
    expect = [(HR, C), (HR,), (LL, LR), (LL,), (C, C), (C,)]
    for name, p, shape in zip(DynaMixerOpParams._fields, params, expect):
        if p.device != x.device or p.dtype != torch.float32:
            raise ValueError(f"parameter {name} is {p.dtype} on {p.device}, x float32 on "
                             f"{x.device}")
        if tuple(p.shape) != shape:
            raise ValueError(f"parameter {name}: shape {tuple(p.shape)}, expected {shape}")
        if not p.is_contiguous():
            raise ValueError(f"parameter {name} must be contiguous")


def _workspace_bytes(lib, S: int, L: int, C: int, H: int, R: int, backward: bool, bf16: bool,
                     dev: int) -> int:
    """Bytes of device workspace K4f (``backward`` False) or K4b needs: the
    products' operands (bf16: x, the weights, gin, mixed, d_mixed, d_comp and
    g's and d_logit's three planes, rows padded to 8; float32: comp, gin,
    mixed, d_mixed, d_gin and d_comp), the logits and d_logit, and the
    gradients' slices; raises for a shape the kernels do not take."""
    nbytes = lib.m2m_dyna_workspace_bytes(S, L, C, H, R, int(backward), int(bf16), dev)
    if nbytes == 0:
        raise ValueError(f"the CUDA DynaMixerOp kernels do not take S={S} L={L} C={C} "
                         f"H={H} R={R}: the rows of a product pass the card's grid (S*L or "
                         "S*H above 64 x 65535)")
    return nbytes


def _launch(x, params, num_head: int, reduced_dim: int, bf16: bool, g=None):
    """K4f (``g`` None): the op's output; K4b: (dx, the 6 float32 parameter
    gradients); ``bf16``: bf16 compute (``csrc/dynamixer.cu``'s casts)."""
    from ._build import check, load_library

    lib = load_library()
    _check_kernel_args(x, params, num_head, reduced_dim)
    S, L, C = x.shape
    dev = _device_index(x)
    backward = g is not None
    dims = (S, L, C, num_head, reduced_dim)
    nbytes = _workspace_bytes(lib, *dims, backward, bf16, dev)
    workspace = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    ptrs = (ctypes.c_void_p * len(params))(*[p.data_ptr() for p in params])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if not backward:
        out = torch.empty_like(x)
        code = lib.m2m_dyna_fwd(x.data_ptr(), out.data_ptr(), *dims, int(bf16), dev, ptrs,
                                workspace.data_ptr(), stream)
        check(lib, code, "DynaMixerOp forward kernel launch")
        return out
    if g.shape != x.shape or g.device != x.device or g.dtype != torch.float32:
        raise ValueError(f"gradient {g.dtype} {tuple(g.shape)} on {g.device} does not match x "
                         f"{tuple(x.shape)} on {x.device}")
    g = g.contiguous()
    dx = torch.empty_like(x)
    grads = [torch.empty(p.shape, dtype=torch.float32, device=x.device) for p in params]
    gptrs = (ctypes.c_void_p * len(grads))(*[q.data_ptr() for q in grads])
    code = lib.m2m_dyna_bwd(x.data_ptr(), g.data_ptr(), dx.data_ptr(), *dims, int(bf16), dev,
                            ptrs, gptrs, workspace.data_ptr(), stream)
    check(lib, code, "DynaMixerOp backward kernel launch")
    return dx, tuple(grads)


def _forward(x, params, num_head, reduced_dim, compute_dtype):
    if not _route(x):
        return dynamixer_op_reference(x, params, num_head, reduced_dim, compute_dtype)
    bf16 = _check_dtype(compute_dtype)
    out = _launch(x, params, num_head, reduced_dim, bf16)
    fused_dynamixer_op.launches += 1
    fused_dynamixer_op.bf16_launches += int(bf16)
    return out


class _DynaFn(torch.autograd.Function):
    """K4f forward, K4b backward (plain version and its autograd on CPU);
    saves only x and the parameters, as the JAX kernel's backward recomputes."""

    @staticmethod
    def forward(ctx, x, num_head, reduced_dim, compute_dtype, *params):
        ctx.cfg = (num_head, reduced_dim, compute_dtype)
        ctx.save_for_backward(x, *params)
        return _forward(x, params, num_head, reduced_dim, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        dx, grads = fused_dynamixer_op_bwd(x, g, params, *ctx.cfg)
        return (dx, None, None, None, *grads)


def fused_dynamixer_op(x, params: DynaMixerOpParams, num_head: int, reduced_dim: int = 2,
                       compute_dtype=torch.float32):
    """One fused DynaMixerOp, ``x (S, L, C) -> (S, L, C)`` (float32 in and out,
    float32 or bf16 compute, the weights output-major). When ``x`` or a
    parameter requires a gradient, the call is differentiable and its backward
    is ``fused_dynamixer_op_bwd``."""
    _check(x, num_head, reduced_dim, compute_dtype)
    params = tuple(params)
    if _needs_grad(x, params):
        return _DynaFn.apply(x, num_head, reduced_dim, compute_dtype, *params)
    return _forward(x, params, num_head, reduced_dim, compute_dtype)


fused_dynamixer_op.launches = 0
fused_dynamixer_op.bf16_launches = 0


def fused_dynamixer_op_bwd(x, g, params, num_head: int, reduced_dim: int = 2,
                           compute_dtype=torch.float32):
    """K4b: ``(dx, 6 parameter gradients)`` of one fused DynaMixerOp at input
    ``x`` for output gradient ``g``, float32 (in bf16 compute rounded where
    JAX's AD of ``_op_math`` rounds them), the weights' output-major."""
    _check(x, num_head, reduced_dim, compute_dtype)
    params = tuple(params)
    if not _route(x):
        return dynamixer_op_bwd_reference(x, g, params, num_head, reduced_dim, compute_dtype)
    bf16 = _check_dtype(compute_dtype)
    out = _launch(x, params, num_head, reduced_dim, bf16, g=g)
    fused_dynamixer_op_bwd.launches += 1
    fused_dynamixer_op_bwd.bf16_launches += int(bf16)
    return out


fused_dynamixer_op_bwd.launches = 0
fused_dynamixer_op_bwd.bf16_launches = 0
