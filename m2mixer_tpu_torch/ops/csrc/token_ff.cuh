// The token FF of a MixerBlock above kMaxTokens tokens, as a pipeline through
// device memory: the kernels and epilogues shared by the forward (mixer_fwd.cu,
// K1f/K2f) and the backward (mixer_bwd.cu, K1b/K2b, which recomputes the
// forward with them).
//
// Why. At most kMaxTokens tokens, the token FF runs per (sample, channel)
// column with a sample's tokens in registers (mixer_common.cuh::token_mix)
// over row tiles of whole samples in shared memory. The L config's 80 fused
// tokens at D = 512 make one sample 160 KB, and the backward's row tile holds
// five such buffers: neither fits the 227 KB a CTA may use. So above the cap
// the token FF becomes products on the tensor cores, in the layout of the JAX
// kernel's token FF (and of dropout masks 0 and 1): rows s*D + d, one per
// (sample, channel) column.
//   forward, on the block input u (B, N, D):
//     tok_in_kernel:  yt (B*D, N) = LN1(u), written transposed;
//     up product:     ht (B*D, T) = gelu(yt W1 + b1) m0        (EpiTokenUp);
//     down product:   tt (B*D, N) = (ht W2 + b2) m1            (EpiTokenDown);
//     tok_out_kernel: x1 = u + tt^T, z = LN2(x1)  (B, N, D), and in the
//                     backward's recompute also da4 = g m3.
//   The float32 forward and the backward's recompute run the two products on
//   tc_gemm over float32 buffers (token_forward). The bf16 forward runs them
//   on the wgmma engine (mixer_fwd.cu's token_forward_wg) between the same
//   two row kernels, yt and ht in bf16.
//   backward (mixer_bwd.cu): the transposes of these products, with
//   transpose_kernel between the (B, N, D) and (B*D, N) layouts.
// Both row kernels own a tile of nc tokens of one sample, every channel, in
// shared memory (row stride D + 1, so the transposed accesses are free of bank
// conflicts): LN needs whole rows, the transposed side wants the tile's
// tokens of each channel together (nc = 32 of them are one 128-byte line).
// kBF16: the casts of _block_math (m2mixer_tpu/ops/mixer_kernel.py:85-121):
// the block input, the LN outputs, h and the residual stream rounded to bf16;
// LN statistics, sums, biases and GELU in float32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mixer_common.cuh"
#include "tile_common.cuh"

namespace {

constexpr int kTokTile = 32;  // tokens of one sample a row-tile CTA owns, at most

// stage 4 of block blk's forward at element e of the (B*N) x D stream, x1 + (h2 W4
// + b4) m3, the down product's ksplit partials (`total` floats apart) added in
// slice order. Both roundings of _block_math are kept (no FMA contraction), so
// every kernel that finishes a block computes it alike.
template <bool kBF16>
__device__ __forceinline__ float finish(const float* x1, const float* part, int ksplit,
                                        size_t total, size_t e, float b4, const Dropout& dp,
                                        int blk) {
  float s = 0.f;
  for (int k = 0; k < ksplit; ++k) s += part[k * total + e];
  return rd<kBF16>(x1[e] + rd<kBF16>(__fmul_rn(s + b4, keep_padded(dp, blk, 3, (uint32_t)e))));
}

// rows r < R of the tile (row stride ld) <- rd(LN(row) * rd(s) + rd(b)), a warp per row,
// the statistics over the first `width` of its D columns
template <bool kBF16>
__device__ void ln_tile(float* t, int R, int D, int ld, const float* __restrict__ s,
                        const float* __restrict__ b, int width) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += kThreads / 32) {
    float* xr = t + r * ld;
    float mean, inv;
    row_stats(xr, width, mean, inv);
    for (int d = lane; d < D; d += 32)
      xr[d] = rd<kBF16>((xr[d] - mean) * inv * rd<kBF16>(__ldg(s + d)) + rd<kBF16>(__ldg(b + d)));
  }
}

// shared-memory bytes of a row tile of nc tokens of D channels
inline size_t tok_tile_bytes(int nc, int D) { return (size_t)nc * (D + 1) * 4; }

// the tokens a row tile takes: kTokTile, fewer where N is smaller or shared
// memory demands it; 0 if not even one row fits
inline int tok_tile_tokens(int N, int D, int smem_optin) {
  int nc = N < kTokTile ? N : kTokTile;
  while (nc > 0 && tok_tile_bytes(nc, D) > (size_t)smem_optin) --nc;
  return nc;
}

// A value stored as a product's operand: float32 (tc_gemm reads it) or bf16
// (OT = __nv_bfloat16, the wgmma engine's); ChanT<kBF16>: the operand type of
// the compute dtype
template <class OT>
__device__ __forceinline__ OT to_operand(float v) {
  if constexpr (std::is_same_v<OT, float>) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}
template <bool kBF16>
using ChanT = std::conditional_t<kBF16, __nv_bfloat16, float>;

// The block input u of tokens [n0, n0 + nc) of sample blockIdx.y: x (rounded to
// the compute dtype), or for a later block the finish of block blk - 1 from x1
// and its down product's `part`; u to x1 (the residual's base) and to `save`
// when given; then yt[(s*D + d)*ldy + n] = LN1(u)[n, d], stored as YT.
template <bool kBF16, class YT = float>
__global__ void __launch_bounds__(kThreads)
    tok_in_kernel(const float* __restrict__ x, const float* __restrict__ part, int ksplit,
                  const float* __restrict__ b4_prev, float* x1, YT* __restrict__ yt, int ldy,
                  float* __restrict__ save, int B, int N, int D, int nc,
                  const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                  const __grid_constant__ Dropout dp, int blk) {
  extern __shared__ __align__(16) float sm[];
  const int s = blockIdx.y, n0 = blockIdx.x * nc, R = min(nc, N - n0), ld = D + 1;
  const size_t off = ((size_t)s * N + n0) * D, total = (size_t)B * N * D;
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    const size_t g = off + e;
    const float u = x ? rd<kBF16>(x[g])
                      : finish<kBF16>(x1, part, ksplit, total, g, __ldg(b4_prev + e % D), dp,
                                      blk - 1);
    sm[(e / D) * ld + e % D] = u;
    x1[g] = u;
    if (save) save[g] = u;
  }
  __syncthreads();
  ln_tile<kBF16>(sm, R, D, ld, ln_s, ln_b, dp.width);
  __syncthreads();
  YT* dst = yt + (size_t)s * D * ldy + n0;
  for (int i = threadIdx.x; i < R * D; i += kThreads) {  // neighbouring threads: neighbouring n
    const int r = i % R, d = i / R;
    dst[(size_t)d * ldy + r] = to_operand<YT>(sm[r * ld + d]);
  }
}

// The backward's channel operands z and da4 as stored: float32 (tc_gemm's
// operands), or bf16 (ZT = __nv_bfloat16, wgmma_bf16.cuh's), where da4 is
// rd(g) times the keep bit of m3 and the products' sums take the dropout scale.
template <bool kBF16, class ZT>
__device__ __forceinline__ ZT da4_operand(float g, float m3) {
  if constexpr (std::is_same_v<ZT, float>) {
    return rd<kBF16>(g) * m3;
  } else {
    return __float2bfloat16_rn(m3 != 0.f ? rd<true>(g) : 0.f);
  }
}

// x1[n, d] = rd(x1[n, d] + rd(tt[(s*D + d)*N + n])) for tokens [n0, n0 + nc) of
// sample blockIdx.y, then z = LN2(x1); with g, also da4 = rd(g) m3 there (the
// backward's stage 1; ZT: how z and da4 are stored, above)
template <bool kBF16, class ZT = float>
__global__ void __launch_bounds__(kThreads)
    tok_out_kernel(const float* __restrict__ tt, float* x1, ZT* __restrict__ z, int N, int D,
                   int nc, const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                   const float* __restrict__ g, ZT* __restrict__ da4,
                   const __grid_constant__ Dropout dp, int blk) {
  extern __shared__ __align__(16) float sm[];
  const int s = blockIdx.y, n0 = blockIdx.x * nc, R = min(nc, N - n0), ld = D + 1;
  const size_t off = ((size_t)s * N + n0) * D;
  const float* src = tt + (size_t)s * D * N + n0;
  for (int i = threadIdx.x; i < R * D; i += kThreads) {  // neighbouring threads: neighbouring n
    const int r = i % R, d = i / R;
    sm[r * ld + d] = src[(size_t)d * N + r];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    float* t = sm + (e / D) * ld + e % D;
    const float v = rd<kBF16>(x1[off + e] + rd<kBF16>(*t));
    *t = v;
    x1[off + e] = v;
    if (g)
      da4[off + e] =
          da4_operand<kBF16, ZT>(g[off + e], keep_padded(dp, blk, 3, (uint32_t)(off + e)));
  }
  __syncthreads();
  ln_tile<kBF16>(sm, R, D, ld, ln_s, ln_b, dp.width);
  __syncthreads();
  for (int e = threadIdx.x; e < R * D; e += kThreads)
    z[off + e] = to_operand<ZT>(sm[(e / D) * ld + e % D]);
}

// the up product's epilogue over (B*D) x T: h = rd(gelu(v + b1) m0); the
// backward also keeps a1 = v + b1 (for gelu')
template <bool kBF16>
struct EpiTokenUp {
  const float* b1;
  float* a1;  // or nullptr
  int T, tanh_flavor, blk;
  Dropout dp;
  __device__ __forceinline__ float operator()(int r, int c, float v) const {
    const float a = v + __ldg(b1 + c);
    if (a1) a1[(size_t)r * T + c] = a;
    return rd<kBF16>(gelu(a, tanh_flavor) * keep_padded(dp, blk, 0, (uint32_t)r * T + c));
  }
};

// the down product's epilogue over (B*D) x N: (v + b2) m1
struct EpiTokenDown {
  const float* b2;
  int N, blk;
  Dropout dp;
  __device__ __forceinline__ float operator()(int r, int c, float v) const {
    return (v + __ldg(b2 + c)) * keep_padded(dp, blk, 1, (uint32_t)r * N + c);
  }
};

// dh = da2 W2^T over (B*D) x T -> da1 = rd(dh) m0 gelu'(a1)
template <bool kBF16>
struct EpiTokenBwd {
  const float* a1;
  int T, tanh_flavor, blk;
  Dropout dp;
  __device__ __forceinline__ float operator()(int r, int c, float v) const {
    const size_t e = (size_t)r * T + c;
    return rd<kBF16>(v) * keep_padded(dp, blk, 0, (uint32_t)e) * gelu_grad(a1[e], tanh_flavor);
  }
};

constexpr int kTr32 = 32;  // transpose_kernel's tile

// out (B, Q, P) from in (B, P, Q), sample blockIdx.z, a 32 x 32 tile through
// shared memory: out[s][q][p] = in[s][p][q] times mask 1 of block blk at
// out's index (mask1 = 1; the backward's da2 = dx1^T m1), or rounded to the
// compute dtype (mask1 = 0; its dy = dyt^T)
template <bool kBF16>
__global__ void __launch_bounds__(kTr32 * 8)
    transpose_kernel(const float* __restrict__ in, float* __restrict__ out, int P, int Q,
                     int mask1, const __grid_constant__ Dropout dp, int blk) {
  __shared__ float tile[kTr32][kTr32 + 1];
  const size_t base = (size_t)blockIdx.z * P * Q;
  const int q0 = blockIdx.x * kTr32, p0 = blockIdx.y * kTr32;
  const int tx = threadIdx.x % kTr32, ty = threadIdx.x / kTr32;
  for (int i = ty; i < kTr32; i += 8) {  // rows p0 + i of in, columns q0 + tx
    const int p = p0 + i, q = q0 + tx;
    if (p < P && q < Q) tile[i][tx] = in[base + (size_t)p * Q + q];
  }
  __syncthreads();
  for (int i = ty; i < kTr32; i += 8) {  // rows q0 + i of out, columns p0 + tx
    const int q = q0 + i, p = p0 + tx;
    if (p >= P || q >= Q) continue;
    const size_t e = base + (size_t)q * P + p;
    const float v = tile[tx][i];
    out[e] = mask1 ? v * keep_padded(dp, blk, 1, (uint32_t)e) : rd<kBF16>(v);
  }
}

template <bool kBF16>
cudaError_t launch_transpose(const float* in, float* out, int B, int P, int Q, int mask1,
                             const Dropout& dp, int blk, cudaStream_t st) {
  transpose_kernel<kBF16><<<dim3(ceil_div(Q, kTr32), ceil_div(P, kTr32), B), kTr32 * 8, 0, st>>>(
      in, out, P, Q, mask1, dp, blk);
  return cudaGetLastError();
}

// w1 and w2 rounded to bf16 into dst (N*T floats each), the token weights the
// bf16 products read
inline cudaError_t round_token_weights(const float* w1, const float* w2, float* dst, int NT,
                                       cudaStream_t st) {
  const cudaError_t err = round_copy(w1, dst, NT, st);
  return err != cudaSuccess ? err : round_copy(w2, dst + NT, NT, st);
}

// The forward of block blk's token half above kMaxTokens tokens: u (x, or the
// finish of block blk - 1) -> x1 = u + token FF, z = LN2(x1). w1, w2: the
// weights the products read (in bf16 rounded copies); with g, also da4 = rd(g)
// m3, and a1 kept (the backward's recompute); ZT: how z and da4 are stored
// (tok_out_kernel). Buffers: yt, tt (B*D*N), ht (B*D*T); sms: the products'
// tile rule.
struct TokenBufs {
  float* yt;
  float* ht;
  float* tt;
  float* a1;  // or nullptr
};

// da4's type follows z's (the forward passes nullptr for it)
template <class T>
struct NoDeduce {
  using type = T;
};

template <bool kBF16, class ZT = float>
int token_forward(const float* x, const float* part, int ksplit, const float* b4_prev, float* x1,
                  ZT* z, float* save, const TokenBufs& tb, const float* ln1_s,
                  const float* ln1_b, const float* w1, const float* b1, const float* w2,
                  const float* b2, const float* ln2_s, const float* ln2_b, const float* g,
                  typename NoDeduce<ZT>::type* da4, int B, int N, int T, int D, int nc, int sms,
                  int tanh_flavor, const Dropout& dp, int blk, cudaStream_t st) {
  constexpr int kBoth = kBF16 ? kExactA | kExactB : 0;
  const size_t smem = tok_tile_bytes(nc, D);
  const dim3 grid(ceil_div(N, nc), B);
  tok_in_kernel<kBF16><<<grid, kThreads, smem, st>>>(x, part, ksplit, b4_prev, x1, tb.yt, N, save,
                                                     B, N, D, nc, ln1_s, ln1_b, dp, blk);
  m2m_count(kTallyTokIn);
  M2M_TRY(cudaGetLastError());
  const int rows = B * D;
  M2M_TRY(tc_gemm_auto<kBoth>(View{tb.yt, N, 1}, View{w1, T, 1}, tb.ht, rows, T, N, sms, st,
                              EpiTokenUp<kBF16>{b1, tb.a1, T, tanh_flavor, blk, dp}));
  M2M_TRY(tc_gemm_auto<kBoth>(View{tb.ht, T, 1}, View{w2, N, 1}, tb.tt, rows, N, T, sms, st,
                              EpiTokenDown{b2, N, blk, dp}));
  tok_out_kernel<kBF16, ZT><<<grid, kThreads, smem, st>>>(tb.tt, x1, z, N, D, nc, ln2_s, ln2_b,
                                                          g, da4, dp, blk);
  return (int)cudaGetLastError();
}

// both row kernels may take tok_tile_bytes(nc, D) of dynamic shared memory (YT:
// how tok_in_kernel stores yt, ZT: how tok_out_kernel stores z)
template <bool kBF16, class ZT = float, class YT = float>
cudaError_t prepare_token_kernels(int nc, int D, int device) {
  const cudaError_t err = prepare(tok_in_kernel<kBF16, YT>, tok_tile_bytes(nc, D), device);
  if (err != cudaSuccess) return err;
  return prepare(tok_out_kernel<kBF16, ZT>, tok_tile_bytes(nc, D), device);
}

}  // namespace
