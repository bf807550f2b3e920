// Fused gMLP block forward (K3f) and backward (K3b) kernels for Hopper (sm_90a), float32
// and bf16 compute.
//
// Replaces the TPU Pallas kernels of m2mixer_tpu/ops/gmlp_kernel.py:
//   m2m_gmlp_fwd  <- fused_gmlp_block's forward (_fwd_call: _fwd_kernel over _block_math)
//   m2m_gmlp_bwd  <- fused_gmlp_block's _bwd_rule (_bwd_kernel: jax.vjp of _block_math)
//
// One GatingMlpBlock on x (B, N, D), in _block_math's order (rows r = b*N + n):
//   pre = LN(x) W_in + b_in (B*N, F); pm = pre * m0; h = gelu(pm); u | v = h;
//   v' = LN(v) over the F/2 v-channels; t = v'(B*F/2, N) sgu_w + sgu_b (the token
//   projection, sgu_b per output token); t' = t * m1; gated = u * t';
//   out = gated W_out + b_out; y = x + out * m2.
// The dropout masks m0 (B*N, F), m1 (B*F/2, N) and m2 (B*N, D) are the hash masks
// of mixer_common.cuh (block 0, mask ids 0-2), keyed on the element's index in
// those JAX layouts, so the forward, the backward and the plain PyTorch version
// (ops/gmlp_kernel.py) agree element by element. Stochastic depth stays outside.
//
// bf16 compute (compute_dtype=bfloat16) follows the casts of JAX's _block_math
// (the parameters arrive in float32 and are rounded where it casts them; x
// and y stay float32 in memory): x rounded; LN1's statistics in float32 of the
// rounded x, its scale, bias and output rounded; W_in, sgu_w and W_out rounded
// (prep_weights_kernel for the two products' weights, sgu_setup_bf16 for sgu_w),
// b_in, sgu_b and b_out added in float32; mask 0, the GELU and LN(v) in
// float32, LN(v)'s scale and bias read rounded and its output v' rounded as
// the token projection's operand; gated = bf16(u) * bf16(t') a bf16 product;
// y = bf16(x) + bf16(out) a bf16 sum. Every product then has two bf16
// operands. The backward computes what JAX's AD of that _block_math
// computes: each cast of the forward becomes a rounding of a cotangent to bf16
// (jax.make_jaxpr of the VJP lists them):
//   - g, the output's cotangent (the output is bf16 widened to float32), so
//     dout = bf16(g) m2 and the residual's cotangent is bf16(g);
//   - the cotangents of the products' bf16 operands: dgated = bf16(dout
//     W_out^T), dv' = bf16(dt sgu_w^T) and dxn = bf16(dpre W_in^T), and the
//     weight gradients dW_out, d sgu_w and dW_in;
//   - both sides of the bf16 gate: du = bf16(dgated bf16(t')), dt' =
//     bf16(dgated bf16(u));
//   - LN1: its input gradient (the LN reads its bf16 input in float32), its
//     scale read rounded, and the bf16 sum of that gradient with bf16(g);
//   - the LN scale and bias gradients of both LNs (the forward reads them as
//     bf16); LN(v)'s backward itself runs in float32 with its scale rounded.
// The bias gradients (b_in, sgu_b, b_out) are not rounded, nor are the float32
// cotangents dout, dt and dpre. JAX rounds each weight gradient per grid tile
// and sums the tiles; these kernels round once, after their own sum over the
// whole batch.
//
// Design. The TPU kernel keeps a batch tile's (tile_b*N, F) intermediates in
// VMEM. The spatial gating unit couples a sample's N tokens (the token
// projection) and a token's F/2 v-channels (LN(v)), and one sample's float32
// (N, F) intermediate is 304 KB at N = 99, above the 227 KB of shared memory a
// CTA may use. So the block is a short pipeline of kernels through device
// memory, each parallel over what it owns (float32 compute; bf16 below):
//   forward, 5 launches:
//     1. rows: xn = LN(x), a warp per row;
//     2. in:   h = gelu((xn W_in + b_in) m0), bias, mask 0 and the GELU in the
//              tensor-core tile's epilogue;
//     3. vstats: every row's LN(v) mean and 1/std, a warp per row;
//     4. sgu:  per (sample, share of the v-channels), in chunks of 64: v' =
//              LN(v), t = v'-by-token sgu_w on the tensor cores, then t' and
//              gated = u t' element by element;
//     5. out:  y = x + (gated W_out + b_out) m2, the residual, bias and mask 2
//              in the tensor-core tile's epilogue.
//   backward, 12 launches; it recomputes the forward from x (the autograd
//   Function saves only x), and follows the chain of jax.vjp(_block_math):
//     1. rows: xn = LN(x) again; dout = g m2 (mask 2 before the F/2 -> D product);
//     2. in:   pm = (xn W_in + b_in) m0, the masked pre-activation;
//     3. dgated = dout W_out^T;
//     4. sgu:  a. every row's LN(v) mean and 1/std, a warp per row;
//              b. per (sample, share of the v-channels), in chunks of 64:
//              recompute v', t' and gated (for dW_out); the gate: du = dgated
//              t', dt = dgated u m1 (mask 1 before the token projection); du's
//              GELU derivative at pm and mask 0 give the u half of dpre; dv' =
//              dt-by-token sgu_w^T to the v half of dpre (raw); the CTA's
//              partials of d sgu_w = sum v' dt and d sgu_b = sum dt;
//     5. vln:  the LN(v) backward over F/2, in place in dpre's v half, times
//              gelu'(pm) m0; the row tile's partials of d sgu_ln_scale, d sgu_ln_bias;
//     6. dxn = dpre W_in^T, the F sum split into slices;
//     7. dW_in = xn^T dpre, 8. dW_out = gated^T dout: tiles of the weight,
//        the B*N rows split into a fixed number of slices;
//     9. db_in, db_out: column sums over the same row slices;
//    10. ln:   the slices of dxn summed in order, the LN backward over D plus the
//              residual g -> dx; the tile's partials of d ln_scale, d ln_bias;
//    11. every partial reduced in a fixed order (compensated).
//   No float atomics: two runs give bit-identical gradients. The weight
//   gradients never take per-sample partials (dW_in and dW_out would be 590 KB
//   a sample); d sgu_w and d sgu_b (N^2 + N floats) take one per SGU CTA.
//
// What bounds it on the H100. The forward does B*N*F*(3D + N) flops against a
// few MB of parameters and activations, the backward twice that plus the
// recomputed forward: operations bound both. In float32 both run their
// products on the tensor cores in 3xTF32 (tile_common.cuh says why that split
// and why mma.sync rather than wgmma): the forward's two GEMMs (steps 2 and 5)
// and the backward's five (steps 2, 3, 6, 7, 8) on tc_gemm, the forward's by
// the tile rule of tc_gemm_auto (the 64x64 tile where the wide one would leave
// SMs idle, at batch 32). The two SGU kernels share their staging, LN(v) and
// token projection (sgu_setup, sgu_stage, sgu_normalize, sgu_token_proj):
// sgu_w in shared memory, a chunk's v columns staged by cp.async and
// normalized in place, t = v' sgu_w as mma.sync from shared memory; the
// backward adds its two other products (dv' = dt sgu_w^T, d sgu_w += v'^T
// dt), d sgu_w's partial in registers across the chunks and written once.
// Tokens are padded to whole m16 tiles (49 -> 64, 99 -> 112) with zeros. The
// rest (the gate, LN(v) and its backward, column sums, reductions) is
// CUDA-core work on memory (PERF.md). The forward stores h = gelu(pm), not
// pm: each GELU is then taken once, where reading pm would take it in the
// statistics, the normalization and the gate (PERF.md).
//
// bf16 compute runs the same pipeline with the casts above and every D x F
// and F/2 x D product on the wgmma engine (wgmma_bf16.cuh): bf16 operands in
// the workspace, TMA into a swizzled ring, float32 sums, each 64-deep stage's
// sums added to the float32 accumulator. At the fusion shape, batch 512 (R =
// B*N = 50688 rows, D 128, F 768), tc_gemm's mma.sync ran these products at
// about 39 TFLOP/s against the card's 989, and the workspace held float32
// copies of values that are bf16 in the math. So, with the same launches and
// fewer (K3f: 6, or 7 where the out-projection is sliced; K3b: 12):
//   - prep_weights_kernel lays out W_in (D x Fp) and W_out (F/2 x Dp), and in
//     the backward W_out^T (D x Hp), rounded; every operand row is padded to
//     whole 16-byte groups (Dp, Hp, Fp: D, F/2, F rounded up to 8), so bf16
//     takes every width float32 takes, TMA's out-of-bounds zeros filling the
//     edges;
//   - xn, gated, dgated and the dout operand lie in bf16 (ln_rows_bf16_kernel,
//     the SGU kernels, dgated's epilogue); h (forward) and pm (backward) stay
//     float32, since LN(v), the GELU and its derivative read them so;
//   - the in-projection (xn W_in, depth D = 128: two stages) and dgated (dout
//     W_out^T) run on 128 x 64 tiles, three CTAs an SM, so one CTA's epilogue
//     runs beside the others' products: in and pm store float32 pairs, dgated
//     is staged and written in whole bf16 rows; the out-projection (gated
//     W_out) on the same tile with bias, mask 2 and the bf16 residual in its
//     epilogue, or, where its tiles are fewer than the SMs, in slices of F/2
//     whose partials out_finish_kernel adds in slice order before the same
//     residual;
//   - dout = bf16(g) m2 enters the engine as bf16(g) times m2's keep bit
//     (exact in bf16), and the dropout scale multiplies the float32 sums of
//     dgated and dW_out (wgmma_bf16.cuh: da4);
//   - dpre, a float32 value, is written as three bf16 planes (hi, mid, lo,
//     together 24 bits) by the kernels that produce it: sgu_bwd_bf16_kernel (u
//     half) and vln_bwd_bf16_kernel (v half, after sgu_bwd_bf16_kernel leaves
//     dv', a bf16 value, in the hi plane); dxn = dpre W_in^T (K-major by K-major, 128 x 128
//     tiles, F sliced where the tiles are few) and dW_in = xn^T dpre
//     (MN-major by MN-major over the rows) take three passes a stage, smallest
//     first; dW_out = gated^T dout one. The weight gradients' row slices
//     (wg_slices) are summed in order by reduce_jobs_kernel;
//   - the SGU kernels (sgu_fwd_bf16_kernel, sgu_bwd_bf16_kernel) hold sgu_w,
//     v' and dt's bits as bf16 rows in shared memory and run the token
//     projection, dv' and d sgu_w as bf16 mma.sync m16n8k16 fed by ldmatrix
//     (the float32 kernels' TF32 fragments take a load an element); dt =
//     bf16(dgated u) m1 enters dv' and d sgu_w as its bf16 value times m1's
//     keep bit, the scale on their sums as dout's is; the forward's SGU
//     needs 108,864 bytes at N = 99, so two CTAs share an SM;
//   - the column sums fold into the kernels that produce their terms: db_in's
//     per-sample (u half, sgu_bwd_bf16_kernel) and per-row-tile (v half,
//     vln_bwd_bf16_kernel) partials of the float32 dpre, db_out's row-tile
//     partials of the dout operand (ln_rows_bf16_kernel), all reduced by
//     reduce_jobs_kernel in a fixed order; no column-sum launch reads dpre or
//     dout again.
// Above kSguSeq (128) tokens a sample's N x N projection outgrows the SGU's
// shared memory: both dtypes then take the large-N route (its section below),
// the token projection and its gradients as products over all rows.
// There is no fallback: a bf16 call the engine cannot take, or a failed TMA
// encode or launch, returns an error and the wrapper raises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mixer_common.cuh"
#include "tile_common.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int kSguSeq = 128;   // tokens the shared-memory SGU takes; the large-N route above
constexpr int kMaxSeq = 46340; // tokens a sample may have: sgu_w's N x N elements counted in int
constexpr int kChunk = 64;     // v-channels per SGU chunk, 8 a warp
constexpr int kRowTile = 32;   // rows per CTA of the LN backward and the bf16 row kernels
constexpr int kWarps = kThreads / 32;
constexpr int kMaskIn = 0, kMaskSgu = 1, kMaskOut = 2;
constexpr int kRedJobs = 7;  // the block's reductions of partials (reduce_jobs_kernel)
constexpr int kRedJobsBf16 = 8;  // the same in bf16: db_in in two halves, no column slices

using bf16_t = __nv_bfloat16;
// x as three bf16 planes at p, p + plane, p + 2 plane: hi = bf16(x), mid =
// bf16(x - hi), lo = bf16(x - hi - mid), smallest term last (wgmma_bf16.cuh)
__device__ __forceinline__ void put_planes(bf16_t* p, size_t plane, float x) {
  const bf16_t hi = __float2bfloat16_rn(x);
  const float rest = x - __bfloat162float(hi);
  const bf16_t mid = __float2bfloat16_rn(rest);
  p[0] = hi;
  p[plane] = mid;
  p[2 * plane] = __float2bfloat16_rn(rest - __bfloat162float(mid));
}

// rows of n bf16 padded to whole 16-byte groups, as TMA reads them
inline int pad8(int n) { return (n + 7) / 8 * 8; }

struct SguParams {
  const float* ln_s;  // (F/2,)
  const float* ln_b;
  const float* w;  // (N, N): t[n] = sum_m v'[m] w[m, n]
  const float* b;  // (N,)
};

// the bf16 route's dpre: three bf16 planes of R x ld, `plane` elements apart,
// and the kernel's partials of db_in (sgu_bwd_bf16_kernel: the u half, B x F/2;
// vln_bwd_bf16_kernel: the v half, a row tile's F/2 at a time)
struct DpreOut {
  bf16_t* p;
  size_t plane;
  int ld;
  float* bin;
};

// xn = LN(x) s + b, a warp per row; with g, also dout = g m2 (float32 compute)
__global__ void __launch_bounds__(kThreads)
    ln_rows_kernel(const float* __restrict__ x, const float* __restrict__ s,
                   const float* __restrict__ b, float* __restrict__ xn,
                   const float* __restrict__ g, float* __restrict__ dout, int R, int D,
                   const __grid_constant__ Dropout dp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= R) return;  // whole warps leave together
  const float* xr = x + (size_t)r * D;
  float mean, inv;
  row_stats(xr, D, mean, inv);
  for (int d = lane; d < D; d += 32) {
    const size_t e = (size_t)r * D + d;
    xn[e] = (xr[d] - mean) * inv * __ldg(s + d) + __ldg(b + d);
    if (g) dout[e] = g[e] * keep(dp, 0, kMaskOut, (uint32_t)e);
  }
}

// The bf16 route's step 1 on `tile` rows (a warp a row): xn = bf16(LN(bf16(x))
// bf16(s) + bf16(b)) (the statistics of the rounded x in float32) in bf16 rows
// of ld; with g, the dout operand bf16(g) times mask 2's keep bit (rows of ld)
// and the tile's partial of db_out = scale x its column sums (part[blockIdx.x],
// D), each warp's sums in shared memory (its lanes' columns), added in warp order
__global__ void __launch_bounds__(kThreads)
    ln_rows_bf16_kernel(const float* __restrict__ x, const float* __restrict__ s,
                        const float* __restrict__ b, bf16_t* __restrict__ xn, int ld,
                        const float* __restrict__ g, bf16_t* __restrict__ dout,
                        float* __restrict__ part, int R, int D, int tile,
                        const __grid_constant__ Dropout dp) {
  extern __shared__ __align__(16) float colsum[];  // kWarps x D, with g
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * tile, nr = min(tile, R - r0);
  float* mine = colsum + warp * D;
  if (g)
    for (int d = lane; d < D; d += 32) mine[d] = 0.f;
  for (int i = warp; i < nr; i += kWarps) {
    const int r = r0 + i;
    const float* xr = x + (size_t)r * D;
    float mean, inv;
    row_stats<true>(xr, D, mean, inv);
    for (int d = lane; d < D; d += 32) {
      const size_t e = (size_t)r * D + d, o = (size_t)r * ld + d;
      xn[o] = __float2bfloat16_rn((rd<true>(xr[d]) - mean) * inv * rd<true>(__ldg(s + d)) +
                                  rd<true>(__ldg(b + d)));
      if (g) {
        const float v = keep(dp, 0, kMaskOut, (uint32_t)e) != 0.f ? rd<true>(g[e]) : 0.f;
        dout[o] = __float2bfloat16_rn(v);
        mine[d] += v;
      }
    }
  }
  if (!g) return;
  __syncthreads();
  const float scale = dp.on ? dp.scale : 1.f;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    Kahan v;
    for (int w = 0; w < kWarps; ++w) v.add(colsum[w * D + d]);
    part[(size_t)blockIdx.x * D + d] = scale * v.s;
  }
}

// the shared-memory layout (floats) of the SGU kernels for N tokens: the
// tokens padded to nm (whole m16 tiles) and np (whole k8 steps); sgu_w (nm x
// ldw, zero beyond N); the chunk's v' (staged raw, then normalized in place),
// t (the backward: then dt), and the u columns (nm x ldc each); the backward
// also dgated (nm x ldc) and d sgu_b; sgu_b, LN(v)'s mean and 1/std. Offsets
// the forward does not use are 0.
struct SguLayout {
  int nm, np, ldw, ldc;
  size_t w, vn, dt, u, dg, sb, db, mean, inv, floats;
};

__host__ __device__ inline SguLayout sgu_layout(int N, bool bwd) {
  SguLayout s = {};
  s.nm = (N + 15) / 16 * 16;
  s.np = (N + 7) / 8 * 8;
  // row strides of 8 or 24 (mod 32): the fragment loads that step down the
  // rows (t's token projection, the dt operand) fall in 32 banks, the others in 16
  s.ldw = s.nm + 8;
  s.ldc = kChunk + 8;
  size_t o = 0;
  s.w = o, o += (size_t)s.nm * s.ldw;
  s.vn = o, o += (size_t)s.nm * s.ldc;
  s.dt = o, o += (size_t)s.nm * s.ldc;
  s.u = o, o += (size_t)s.nm * s.ldc;
  if (bwd) s.dg = o, o += (size_t)s.nm * s.ldc;
  s.sb = o, o += s.nm;
  if (bwd) s.db = o, o += s.nm;
  s.mean = o, o += s.nm;
  s.inv = o, o += s.nm;
  s.floats = o;
  return s;
}

// sgu_w (zero-padded to nm x ldw), sgu_b and sample b's LN(v) mean and 1/std
// (vstats_kernel's stats[r] and stats[R + r]) into shared memory
template <int kT>
__device__ void sgu_setup(float* sm, const SguLayout& L, const SguParams& p,
                          const float* __restrict__ vstats, int N, int R, int b) {
  float* ws = sm + L.w;
  for (int i = threadIdx.x; i < L.nm * L.ldw; i += kT) {
    const int m = i / L.ldw, n = i - m * L.ldw;
    ws[i] = m < N && n < N ? __ldg(p.w + m * N + n) : 0.f;
  }
  for (int i = threadIdx.x; i < L.nm; i += kT) {
    sm[L.sb + i] = i < N ? __ldg(p.b + i) : 0.f;
    sm[L.mean + i] = i < N ? vstats[b * N + i] : 0.f;
    sm[L.inv + i] = i < N ? vstats[R + b * N + i] : 0.f;
  }
}

// dst[m * ldc + cc] = src[m * ld + cc] for m < N, cc < min(kChunk, cols)
// (zeros elsewhere in the nm x kChunk block): asynchronous copies, 16 bytes
// each when `vec` (src and ld 16-byte aligned), else 4
template <int kT>
__device__ __forceinline__ void sgu_stage(float* dst, const float* src, long long ld, int N,
                                          int nm, int cols, int ldc, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < nm * (kChunk / 4); i += kT) {
      const int m = i / (kChunk / 4), cc = i % (kChunk / 4) * 4;
      int n4 = m < N ? cols - cc : 0;
      n4 = n4 < 0 ? 0 : (n4 > 4 ? 4 : n4);
      cp_async16(dst + m * ldc + cc, n4 ? src + m * ld + cc : src, 4 * n4);
    }
  } else {
    for (int i = threadIdx.x; i < nm * kChunk; i += kT) {
      const int m = i / kChunk, cc = i % kChunk;
      const bool ok = m < N && cc < cols;
      cp_async4(dst + m * ldc + cc, ok ? src + m * ld + cc : src, ok);
    }
  }
}

// the same for rows of bf16 (the bf16 route's dgated) into rows of kChunk + 8
// bf16: 16-byte copies (src's rows whole 16-byte groups), zeros elsewhere
template <int kT>
__device__ __forceinline__ void sgu_stage_bf16(bf16_t* dst, const bf16_t* src, long long ld,
                                               int N, int nm, int cols) {
  constexpr int kLd = kChunk + 8;
  for (int i = threadIdx.x; i < nm * (kChunk / 8); i += kT) {
    const int m = i / (kChunk / 8), cc = i % (kChunk / 8) * 8;
    int n8 = m < N ? cols - cc : 0;
    n8 = n8 < 0 ? 0 : (n8 > 8 ? 8 : n8);
    cp_async16(reinterpret_cast<float*>(dst + m * kLd + cc),
               reinterpret_cast<const float*>(n8 ? src + m * ld + cc : src), 2 * n8);
  }
}

// v' = LN(v) of the chunk at c0, in place in vn, zero beyond N tokens and
// F/2 channels; vn holds v (kFromPre = false) or the pre-activation whose
// GELU v is
template <int kT, bool kFromPre>
__device__ void sgu_normalize(float* sm, const SguLayout& L, const SguParams& p, int N, int H,
                              int c0, int tanh_flavor) {
  float* vn = sm + L.vn;
  const float* mean = sm + L.mean;
  const float* inv = sm + L.inv;
  for (int i = threadIdx.x; i < L.nm * kChunk; i += kT) {
    const int m = i / kChunk, cc = i % kChunk, c = c0 + cc;
    float* v = vn + m * L.ldc + cc;
    const float a = kFromPre ? gelu(*v, tanh_flavor) : *v;
    *v = m < N && c < H ? (a - mean[m]) * inv[m] * __ldg(p.ln_s + c) + __ldg(p.ln_b + c) : 0.f;
  }
}

// the token projection of the chunk, t(n, cc) = sum over m of sgu_w[m, n]
// v'(m, cc), 3xTF32 mma.sync from shared memory, into dt. The warps stand 4 x
// kWC: warp (wm, wc)
// owns the token tiles wm + 4i (m16, kMT of them in all) and the kCB
// v-channel blocks kCB wc + j (8 wide).
template <int kMT, int kWC>
__device__ void sgu_token_proj(float* sm, const SguLayout& L) {
  constexpr int kMI = kMT / 4, kCB = kChunk / 8 / kWC;
  const float* ws = sm + L.w;
  const float* vn = sm + L.vn;
  float* dts = sm + L.dt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mt = L.nm / 16, wm = warp & 3, wc = warp >> 2;
  float acc[kMI][kCB][4] = {};
  for (int k = 0; k < L.np; k += 8) {
    uint32_t bb[kCB][2], bs[kCB][2];
#pragma unroll
    for (int j = 0; j < kCB; ++j) frag_b(vn + k * L.ldc + 8 * (kCB * wc + j), L.ldc, 1, bb[j], bs[j]);
#pragma unroll
    for (int i = 0; i < kMI; ++i) {
      const int tile = wm + 4 * i;
      if (tile < mt) {
        uint32_t ab[4], as[4];  // A(n, m) = sgu_w[m, n]
        frag_a(ws + k * L.ldw + 16 * tile, 1, L.ldw, ab, as);
#pragma unroll
        for (int j = 0; j < kCB; ++j) mma_3xtf32(acc[i][j], ab, as, bb[j], bs[j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMI; ++i) {
    const int tile = wm + 4 * i;
    if (tile < mt) {
#pragma unroll
      for (int j = 0; j < kCB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dts[(16 * tile + g + 8 * (e >> 1)) * L.ldc + 8 * (kCB * wc + j) + 2 * t + (e & 1)] =
              acc[i][j][e];
    }
  }
}

// every row's LN(v) mean and 1/std over its F/2 v-channels, a warp per row:
// stats[r] and stats[R + r]; `a` holds h (kFromPre = false: forward step 3) or
// the pre-activation pm, whose GELU is taken (backward step 4a)
template <bool kFromPre>
__global__ void __launch_bounds__(kThreads)
    vstats_kernel(const float* __restrict__ a, float* __restrict__ stats, int R, int F,
                  int tanh_flavor) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kThreads / 32) + warp;
  if (r >= R) return;  // whole warps leave together
  const int H = F / 2;
  const float* v = a + (size_t)r * F + H;
  float sum = 0.f;
#pragma unroll 4
  for (int c = lane; c < H; c += 32) sum += kFromPre ? gelu(v[c], tanh_flavor) : v[c];
  const float mu = warp_sum(sum) / H;
  float sq = 0.f;
#pragma unroll 4
  for (int c = lane; c < H; c += 32) {
    const float d = (kFromPre ? gelu(v[c], tanh_flavor) : v[c]) - mu;
    sq += d * d;
  }
  const float var = warp_sum(sq) / H;
  if (lane == 0) {
    stats[r] = mu;
    stats[R + r] = rsqrtf(var + 1e-5f);
  }
}

// forward step 4 for sample blockIdx.y and every gridDim.x-th chunk of kChunk
// v-channels from chunk blockIdx.x: gated = u * (LN(v) sgu_w + sgu_b) m1, the
// token projection on the tensor cores (sgu_token_proj; the warps stand as
// there). A chunk's v and u columns of h reach shared memory by cp.async, the
// u columns while the token projection runs; the gate then runs element by
// element on t in shared memory, neighbouring threads on neighbouring
// channels (coalesced stores).
template <int kMT, int kWC>
__global__ void __launch_bounds__(128 * kWC)
    sgu_fwd_kernel(const float* __restrict__ h, const float* __restrict__ vstats,
                   float* __restrict__ gated, SguParams p, int N, int F,
                   const __grid_constant__ Dropout dp) {
  constexpr int kT = 128 * kWC;  // threads: 4 x kWC warps
  extern __shared__ __align__(16) float sm[];
  const SguLayout L = sgu_layout(N, false);
  const int H = F / 2, b = blockIdx.y, R = gridDim.y * N;
  const float* dts = sm + L.dt;
  const float* us = sm + L.u;
  const float* sb = sm + L.sb;
  const float* hb = h + (size_t)b * N * F;
  const bool vec = F % 8 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  sgu_setup<kT>(sm, L, p, vstats, N, R, b);
  for (int c0 = blockIdx.x * kChunk; c0 < H; c0 += gridDim.x * kChunk) {
    sgu_stage<kT>(sm + L.vn, hb + H + c0, F, N, L.nm, H - c0, L.ldc, vec);
    cp_async_commit();
    sgu_stage<kT>(sm + L.u, hb + c0, F, N, L.nm, H - c0, L.ldc, vec);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    sgu_normalize<kT, false>(sm, L, p, N, H, c0, 0);
    __syncthreads();
    sgu_token_proj<kMT, kWC>(sm, L);
    cp_async_wait<0>();
    __syncthreads();  // t and the u columns in shared memory
    for (int q = threadIdx.x; q < N * kChunk; q += kT) {
      const int n = q / kChunk, cc = q % kChunk, c = c0 + cc;
      if (c < H) {
        const float m1 = keep(dp, 0, kMaskSgu, ((uint32_t)b * H + c) * N + n);
        const int at = n * L.ldc + cc;
        gated[((size_t)b * N + n) * H + c] =
            us[at] * ((dts[at] + sb[n]) * m1);
      }
    }
    __syncthreads();
  }
}

// backward step 4b (see the top of the file) for sample blockIdx.y and every
// gridDim.x-th chunk of kChunk v-channels from chunk blockIdx.x, its three
// products on the tensor cores (3xTF32, tile_common.cuh) from shared memory.
// A chunk's operands (pm's v and u columns, dgated) reach shared memory by
// cp.async, the u and dgated columns while the token projection runs; the
// gate then runs element by element on t in shared memory (coalesced stores).
// The warps stand as in sgu_token_proj; in d sgu_w warp (wm, wc) owns the
// column tiles wc + kWC j (8 wide), so a fragment it loads serves several
// products. The CTA's partials of d sgu_w (N x N, in registers across the
// chunks) and d sgu_b (N) go to part[blockIdx.y * gridDim.x + blockIdx.x].
template <int kMT, int kWC>
__global__ void __launch_bounds__(128 * kWC, 1)
    sgu_bwd_kernel(const float* __restrict__ pm, const float* __restrict__ dg,
                   const float* __restrict__ vstats, float* __restrict__ gated,
                   float* __restrict__ dpre, float* __restrict__ part, SguParams p, int N, int F,
                   int tanh_flavor, const __grid_constant__ Dropout dp) {
  constexpr int kT = 128 * kWC;          // threads: 4 x kWC warps
  constexpr int kMI = kMT / 4;           // token tiles a warp owns
  constexpr int kCB = kChunk / 8 / kWC;  // v-channel blocks a warp owns (of kChunk / 8)
  constexpr int kNT = 2 * kMT / kWC;     // d sgu_w column tiles a warp owns (of 2 kMT)
  extern __shared__ __align__(16) float sm[];
  const SguLayout L = sgu_layout(N, true);
  const int H = F / 2, b = blockIdx.y, R = gridDim.y * N;
  const float* ws = sm + L.w;
  float* vn = sm + L.vn;
  float* dts = sm + L.dt;
  float* us = sm + L.u;
  float* gs = sm + L.dg;
  const float* sb = sm + L.sb;
  float* dbs = sm + L.db;
  const float* pb = pm + (size_t)b * N * F;
  const float* gb = dg + (size_t)b * N * H;
  const bool vec = F % 8 == 0 && reinterpret_cast<uintptr_t>(pm) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dg) % 16 == 0;
  sgu_setup<kT>(sm, L, p, vstats, N, R, b);
  for (int i = threadIdx.x; i < L.nm; i += kT) dbs[i] = 0.f;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mt = L.nm / 16, wm = warp & 3, wc = warp >> 2;
  float dw[kMI][kNT][4] = {};
  for (int c0 = blockIdx.x * kChunk; c0 < H; c0 += gridDim.x * kChunk) {
    sgu_stage<kT>(vn, pb + H + c0, F, N, L.nm, H - c0, L.ldc, vec);
    cp_async_commit();
    sgu_stage<kT>(us, pb + c0, F, N, L.nm, H - c0, L.ldc, vec);
    sgu_stage<kT>(gs, gb + c0, H, N, L.nm, H - c0, L.ldc, vec);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    sgu_normalize<kT, true>(sm, L, p, N, H, c0, tanh_flavor);
    __syncthreads();
    // the token projection, recomputed, to dts
    sgu_token_proj<kMT, kWC>(sm, L);
    cp_async_wait<0>();
    __syncthreads();  // t, and the u and dgated columns, in shared memory
    // the gate, element by element (token n, v-channel c; neighbouring threads
    // on neighbouring channels); dt replaces t in shared memory
    for (int q = threadIdx.x; q < L.nm * kChunk; q += kT) {
      const int n = q / kChunk, cc = q % kChunk, c = c0 + cc;
      float* tq = dts + n * L.ldc + cc;
      float dtv = 0.f;
      if (n < N && c < H) {
        const size_t r = (size_t)b * N + n;
        const float m1 = keep(dp, 0, kMaskSgu, ((uint32_t)b * H + c) * N + n);
        const float tm = (*tq + sb[n]) * m1;  // t'
        const float pu = us[n * L.ldc + cc];
        const float u = gelu(pu, tanh_flavor);
        const float d = gs[n * L.ldc + cc];
        gated[r * H + c] = u * tm;
        // the gate (gmlp_kernel.py:75): du = dgated t'; then the GELU at the
        // masked pre-activation (:65) and mask 0 (:63-64)
        const size_t el = r * F + c;
        dpre[el] = d * tm * gelu_grad(pu, tanh_flavor) *
                   keep(dp, 0, kMaskIn, (uint32_t)el);
        dtv = d * u * m1;  // dt' = dgated u, then mask 1 (:72-73)
      }
      *tq = dtv;
    }
    __syncthreads();
    // the token projection's input gradient (:71): dv'(m, cc) = sum over n of
    // sgu_w[m, n] dt(n, cc), to the v half of dpre (raw)
    float dv[kMI][kCB][4] = {};
    for (int k = 0; k < L.np; k += 8) {
      uint32_t bb[kCB][2], bs[kCB][2];
#pragma unroll
      for (int j = 0; j < kCB; ++j) frag_b(dts + k * L.ldc + 8 * (kCB * wc + j), L.ldc, 1, bb[j], bs[j]);
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        const int tile = wm + 4 * i;
        if (tile < mt) {
          uint32_t ab[4], as[4];  // A(m, n) = sgu_w[m, n]
          frag_a(ws + 16 * tile * L.ldw + k, L.ldw, 1, ab, as);
#pragma unroll
          for (int j = 0; j < kCB; ++j) mma_3xtf32(dv[i][j], ab, as, bb[j], bs[j]);
        }
      }
    }
    // d sgu_w(m, n) += sum over the chunk of v'(m, cc) dt(n, cc)
#pragma unroll
    for (int k = 0; k < kChunk; k += 8) {
      uint32_t bb[kNT][2], bs[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        if (8 * (wc + kWC * j) < L.np) frag_b(dts + 8 * (wc + kWC * j) * L.ldc + k, 1, L.ldc, bb[j], bs[j]);
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        const int tile = wm + 4 * i;
        if (tile < mt) {
          uint32_t ab[4], as[4];
          frag_a(vn + 16 * tile * L.ldc + k, L.ldc, 1, ab, as);
#pragma unroll
          for (int j = 0; j < kNT; ++j)
            if (8 * (wc + kWC * j) < L.np) mma_3xtf32(dw[i][j], ab, as, bb[j], bs[j]);
        }
      }
    }
    // dv' to shared memory (over the u columns, read by the gate only)
#pragma unroll
    for (int i = 0; i < kMI; ++i) {
      const int tile = wm + 4 * i;
      if (tile < mt) {
#pragma unroll
        for (int j = 0; j < kCB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            us[(16 * tile + g + 8 * (e >> 1)) * L.ldc + 8 * (kCB * wc + j) + 2 * t + (e & 1)] =
                dv[i][j][e];
      }
    }
    // d sgu_b(n) += sum over the chunk of dt(n, cc)
    for (int n = threadIdx.x; n < N; n += kT) {
      float sum = 0.f;
      for (int cc = 0; cc < kChunk; ++cc) sum += dts[n * L.ldc + cc];
      dbs[n] += sum;
    }
    __syncthreads();
    // dv' to the v half of dpre (raw), neighbouring threads on neighbouring channels
    for (int q = threadIdx.x; q < N * kChunk; q += kT) {
      const int m = q / kChunk, cc = q % kChunk, c = c0 + cc;
      if (c < H) dpre[((size_t)b * N + m) * F + H + c] = us[m * L.ldc + cc];
    }
    __syncthreads();
  }
  float* mine = part + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * ((size_t)N * N + N);
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 16 * (wm + 4 * i) + g + 8 * (e >> 1), n = 8 * (wc + kWC * j) + 2 * t + (e & 1);
        if (m < N && n < N) mine[m * N + n] = dw[i][j][e];
      }
  for (int i = threadIdx.x; i < N; i += kT) mine[N * N + i] = dbs[i];
}

// ------------------------------------------------------------------ bf16 SGU
// The bf16 route's SGU kernels: the float32 kernels' steps with _block_math's
// casts, their products (the token projection; the backward's dv' and d
// sgu_w) as bf16 mma.sync m16n8k16 with float32 sums, the fragments loaded by
// ldmatrix from bf16 rows in shared memory (sgu_w, v', dt's bits: bf16 values
// in the math). Each mma goes into zeroed registers, then is added to the
// float32 sum (tile_common.cuh's 1xTF32 rule). Tokens padded to whole m16
// tiles; the depth of the token products (the tokens) in k16 steps over them.

// four (A) or two (B) 8 x 8 bf16 matrices from the rows each lane points at;
// kTrans: each matrix transposed (rows in memory are the fragment's columns)
template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16_t* p) {
  if constexpr (kTrans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p))
                 : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p))
                 : "memory");
}
template <bool kTrans>
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16_t* p) {
  if constexpr (kTrans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_u32(p))
                 : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_u32(p))
                 : "memory");
}

// The A fragment of rows m0.. (16) and depth k0.. (16) of a row-major bf16
// matrix (ld elements a row): x[m][k]; kTrans: of its transpose, A(m, k) =
// x[k][m] (the rows of x are the depth)
template <bool kTrans>
__device__ __forceinline__ void frag_a_bf16(uint32_t (&a)[4], const bf16_t* x, int ld, int m0,
                                            int k0) {
  const int lane = threadIdx.x & 31, q = lane >> 3, r = lane & 7;
  if constexpr (kTrans)
    ldsm_x4<true>(a, x + (size_t)(k0 + r + 8 * (q >> 1)) * ld + m0 + 8 * (q & 1));
  else
    ldsm_x4<false>(a, x + (size_t)(m0 + (lane & 15)) * ld + k0 + 8 * (lane >> 4));
}

// The B fragment of depth k0.. (16) and columns n0.. (8): B(k, n) = x[k][n]
// (kTrans: the rows of x are the depth) or x[n][k]
template <bool kTrans>
__device__ __forceinline__ void frag_b_bf16(uint32_t (&b)[2], const bf16_t* x, int ld, int k0,
                                            int n0) {
  const int lane = threadIdx.x & 31;
  if constexpr (kTrans)
    ldsm_x2<true>(b, x + (size_t)(k0 + (lane & 15)) * ld + n0);
  else
    ldsm_x2<false>(b, x + (size_t)(n0 + (lane & 7)) * ld + k0 + 8 * ((lane >> 3) & 1));
}

// the shared memory of the bf16 SGU kernels for N tokens (offsets in floats,
// each region whole 16-byte groups): sgu_w rounded (nm x ldw bf16, zero
// beyond N), the chunk's v' and (backward) dt's bits (nm x ldb bf16); the
// chunk's raw v, then t (nm x ldc floats); the u columns (h's or pm's,
// then (backward) dv', nm x ldc floats); the backward's
// dgated (nm x ldb bf16, then the threads' db_in terms); sgu_b, (d sgu_b),
// LN(v)'s mean and 1/std. The bf16 rows (ldw, ldb = 8 mod 16 elements) put
// ldmatrix's 8 rows in distinct banks.
struct SguLayoutBf16 {
  int nm, np, ldw, ldb, ldc;
  size_t w, vn, dtb, t, u, dg, sb, db, mean, inv, floats;
};

__host__ __device__ inline SguLayoutBf16 sgu_layout_bf16(int N, bool bwd) {
  SguLayoutBf16 s = {};
  s.nm = (N + 15) / 16 * 16;
  s.np = (N + 7) / 8 * 8;
  s.ldw = s.nm + 8;
  s.ldb = kChunk + 8;
  s.ldc = kChunk + 8;
  size_t o = 0;
  auto take = [&o](size_t& at, size_t floats) { at = o, o += (floats + 3) / 4 * 4; };
  const size_t rows_b = (size_t)s.nm * s.ldb / 2, rows_f = (size_t)s.nm * s.ldc;
  take(s.w, (size_t)s.nm * s.ldw / 2);
  take(s.vn, rows_b);
  if (bwd) take(s.dtb, rows_b);
  take(s.t, rows_f);
  take(s.u, rows_f);
  if (bwd) take(s.dg, rows_b > 512 ? rows_b : 512);  // then up to 512 threads' db_in terms
  take(s.sb, s.nm);
  if (bwd) take(s.db, s.nm);
  take(s.mean, s.nm);
  take(s.inv, s.nm);
  s.floats = o;
  return s;
}

// bf16(sgu_w) (zero-padded to nm x ldw), sgu_b and sample b's LN(v) mean and
// 1/std into shared memory
template <int kT>
__device__ void sgu_setup_bf16(float* sm, const SguLayoutBf16& L, const SguParams& p,
                               const float* __restrict__ vstats, int N, int R, int b) {
  bf16_t* ws = reinterpret_cast<bf16_t*>(sm + L.w);
  for (int i = threadIdx.x; i < L.nm * L.ldw; i += kT) {
    const int m = i / L.ldw, n = i - m * L.ldw;
    ws[i] = __float2bfloat16_rn(m < N && n < N ? __ldg(p.w + m * N + n) : 0.f);
  }
  for (int i = threadIdx.x; i < L.nm; i += kT) {
    sm[L.sb + i] = i < N ? __ldg(p.b + i) : 0.f;
    sm[L.mean + i] = i < N ? vstats[b * N + i] : 0.f;
    sm[L.inv + i] = i < N ? vstats[R + b * N + i] : 0.f;
  }
}

// v' = bf16(LN(v)) of the chunk at c0 (LN(v)'s scale and bias read rounded,
// its statistics float32) from the raw v (kFromPre: the pre-activation whose
// GELU v is) staged in t, into vn's bf16 rows; zero beyond N tokens and F/2
// channels
template <int kT, bool kFromPre>
__device__ void sgu_normalize_bf16(float* sm, const SguLayoutBf16& L, const SguParams& p, int N,
                                   int H, int c0, int tanh_flavor) {
  const float* raw = sm + L.t;
  bf16_t* vn = reinterpret_cast<bf16_t*>(sm + L.vn);
  const float* mean = sm + L.mean;
  const float* inv = sm + L.inv;
  for (int i = threadIdx.x; i < L.nm * kChunk; i += kT) {
    const int m = i / kChunk, cc = i % kChunk, c = c0 + cc;
    float v = 0.f;
    if (m < N && c < H) {
      const float a = raw[m * L.ldc + cc];
      v = ((kFromPre ? gelu(a, tanh_flavor) : a) - mean[m]) * inv[m] *
              rd<true>(__ldg(p.ln_s + c)) +
          rd<true>(__ldg(p.ln_b + c));
    }
    vn[m * L.ldb + cc] = __float2bfloat16_rn(v);
  }
}

// the token projection of the chunk, t(n, cc) = sum over m of sgu_w[m, n]
// v'(m, cc), bf16 mma from shared memory, into t; the warps stand as in
// sgu_token_proj (4 x kWC: warp (wm, wc) owns the token tiles wm + 4i and
// the v-channel blocks kCB wc + j, 8 wide)
template <int kMT, int kWC>
__device__ void sgu_token_proj_bf16(float* sm, const SguLayoutBf16& L) {
  constexpr int kMI = kMT / 4, kCB = kChunk / 8 / kWC;
  const bf16_t* ws = reinterpret_cast<const bf16_t*>(sm + L.w);
  const bf16_t* vn = reinterpret_cast<const bf16_t*>(sm + L.vn);
  float* ts = sm + L.t;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mt = L.nm / 16, wm = warp & 3, wc = warp >> 2;
  float acc[kMI][kCB][4] = {};
  for (int k = 0; k < L.nm; k += 16) {
    uint32_t bb[kCB][2];
#pragma unroll
    for (int j = 0; j < kCB; ++j) frag_b_bf16<true>(bb[j], vn, L.ldb, k, 8 * (kCB * wc + j));
#pragma unroll
    for (int i = 0; i < kMI; ++i) {
      const int tile = wm + 4 * i;
      if (tile < mt) {
        uint32_t ab[4];  // A(n, m) = sgu_w[m, n]
        frag_a_bf16<true>(ab, ws, L.ldw, 16 * tile, k);
#pragma unroll
        for (int j = 0; j < kCB; ++j) mma_bf16(acc[i][j], ab, bb[j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMI; ++i) {
    const int tile = wm + 4 * i;
    if (tile < mt) {
#pragma unroll
      for (int j = 0; j < kCB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ts[(16 * tile + g + 8 * (e >> 1)) * L.ldc + 8 * (kCB * wc + j) + 2 * t + (e & 1)] =
              acc[i][j][e];
    }
  }
}

// The bf16 route's forward step 4 (sgu_fwd_kernel's, with _block_math's
// casts) for sample blockIdx.y and every gridDim.x-th chunk of kChunk
// v-channels from chunk blockIdx.x: gated = bf16(bf16(u) bf16(t')), t' =
// (bf16(LN(v)) bf16(sgu_w) + sgu_b) m1 on the bf16 mma, gated in bf16 rows
// of ldg (the out-projection's engine operand). Two CTAs an SM (108,864 bytes of
// shared memory at N = 99).
template <int kMT, int kWC>
__global__ void __launch_bounds__(128 * kWC, 2)
    sgu_fwd_bf16_kernel(const float* __restrict__ h, const float* __restrict__ vstats,
                        bf16_t* __restrict__ gated, int ldg, SguParams p, int N, int F,
                        const __grid_constant__ Dropout dp) {
  constexpr int kT = 128 * kWC;
  extern __shared__ __align__(16) float sm[];
  const SguLayoutBf16 L = sgu_layout_bf16(N, false);
  const int H = F / 2, b = blockIdx.y, R = gridDim.y * N;
  const float* ts = sm + L.t;
  const float* us = sm + L.u;
  const float* sb = sm + L.sb;
  const float* hb = h + (size_t)b * N * F;
  bf16_t* gb = gated + (size_t)b * N * ldg;
  const bool vec = F % 8 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  sgu_setup_bf16<kT>(sm, L, p, vstats, N, R, b);
  for (int c0 = blockIdx.x * kChunk; c0 < H; c0 += gridDim.x * kChunk) {
    sgu_stage<kT>(sm + L.t, hb + H + c0, F, N, L.nm, H - c0, L.ldc, vec);
    cp_async_commit();
    sgu_stage<kT>(sm + L.u, hb + c0, F, N, L.nm, H - c0, L.ldc, vec);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    sgu_normalize_bf16<kT, false>(sm, L, p, N, H, c0, 0);
    __syncthreads();
    sgu_token_proj_bf16<kMT, kWC>(sm, L);
    cp_async_wait<0>();
    __syncthreads();  // t and the u columns in shared memory
    for (int q = threadIdx.x; q < N * kChunk; q += kT) {
      const int n = q / kChunk, cc = q % kChunk, c = c0 + cc;
      if (c < H) {
        const float m1 = keep(dp, 0, kMaskSgu, ((uint32_t)b * H + c) * N + n);
        const int at = n * L.ldc + cc;
        gb[(size_t)n * ldg + c] =
            __float2bfloat16_rn(rd<true>(us[at]) * rd<true>((ts[at] + sb[n]) * m1));
      }
    }
    __syncthreads();
  }
}

// The bf16 route's backward step 4b (sgu_bwd_kernel's, with the VJP's
// roundings) for sample blockIdx.y and every gridDim.x-th chunk from chunk
// blockIdx.x: the token projection recomputed on the bf16 mma; the gate
// (gated = bf16(bf16(u) bf16(t')), du = bf16(dgated bf16(t')), dt' =
// bf16(dgated bf16(u)), u's GELU and derivative from one erf); dpre's u half
// to dq's three planes and its column sums to dq.bin[blockIdx.y * F/2 + c]
// (db_in's per-sample partial, each channel's kT / kChunk threads' terms in
// thread order); dt entering dv' and d sgu_w as dt' times mask 1's keep bit
// (bf16: both products one bf16 mma pass), the dropout scale multiplying
// their float32 sums (dv', d sgu_w, d sgu_b); dv' = bf16 of its sum, to the
// hi plane's v half. dgated arrives in bf16 (rows of ldd), gated leaves in
// bf16 (rows of ldg). The CTA's partials of d sgu_w (N x N) and d sgu_b (N)
// go to part[blockIdx.y * gridDim.x + blockIdx.x]; in d sgu_w warp (wm, wc)
// owns the column tiles wc + kWC j (8 wide).
template <int kMT, int kWC>
__global__ void __launch_bounds__(128 * kWC, 1)
    sgu_bwd_bf16_kernel(const float* __restrict__ pm, const bf16_t* __restrict__ dg, int ldd,
                        const float* __restrict__ vstats, bf16_t* __restrict__ gated, int ldg,
                        const DpreOut dq, float* __restrict__ part, SguParams p, int N, int F,
                        int tanh_flavor, const __grid_constant__ Dropout dp) {
  constexpr int kT = 128 * kWC;
  constexpr int kMI = kMT / 4, kCB = kChunk / 8 / kWC, kNT = 2 * kMT / kWC;
  extern __shared__ __align__(16) float sm[];
  const SguLayoutBf16 L = sgu_layout_bf16(N, true);
  const int H = F / 2, b = blockIdx.y, R = gridDim.y * N;
  const bf16_t* ws = reinterpret_cast<const bf16_t*>(sm + L.w);
  const bf16_t* vn = reinterpret_cast<const bf16_t*>(sm + L.vn);
  bf16_t* dtb = reinterpret_cast<bf16_t*>(sm + L.dtb);
  const float* ts = sm + L.t;
  float* us = sm + L.u;
  bf16_t* gs = reinterpret_cast<bf16_t*>(sm + L.dg);
  float* terms = sm + L.dg;  // the threads' db_in terms, once dgated is spent
  const float* sb = sm + L.sb;
  float* dbs = sm + L.db;
  const float* pb = pm + (size_t)b * N * F;
  const bf16_t* gb = dg + (size_t)b * N * ldd;
  const bool vec = F % 8 == 0 && reinterpret_cast<uintptr_t>(pm) % 16 == 0;
  const float dsc = dp.on ? dp.scale : 1.f;  // dt's scale, on the sums
  sgu_setup_bf16<kT>(sm, L, p, vstats, N, R, b);
  for (int i = threadIdx.x; i < L.nm; i += kT) dbs[i] = 0.f;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mt = L.nm / 16, wm = warp & 3, wc = warp >> 2;
  float dw[kMI][kNT][4] = {};
  for (int c0 = blockIdx.x * kChunk; c0 < H; c0 += gridDim.x * kChunk) {
    sgu_stage<kT>(sm + L.t, pb + H + c0, F, N, L.nm, H - c0, L.ldc, vec);
    cp_async_commit();
    sgu_stage<kT>(us, pb + c0, F, N, L.nm, H - c0, L.ldc, vec);
    sgu_stage_bf16<kT>(gs, gb + c0, ldd, N, L.nm, H - c0);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    sgu_normalize_bf16<kT, true>(sm, L, p, N, H, c0, tanh_flavor);
    __syncthreads();
    sgu_token_proj_bf16<kMT, kWC>(sm, L);  // t, recomputed
    cp_async_wait<0>();
    __syncthreads();  // t, and the u and dgated columns, in shared memory
    // the gate, element by element (token n, v-channel c; neighbouring threads
    // on neighbouring channels); dt's bits to dtb
    float bsum = 0.f;  // this thread's terms of db_in at channel threadIdx.x % kChunk
    for (int q = threadIdx.x; q < L.nm * kChunk; q += kT) {
      const int n = q / kChunk, cc = q % kChunk, c = c0 + cc;
      float dtv = 0.f;
      if (n < N && c < H) {
        const size_t r = (size_t)b * N + n;
        const float m1 = keep(dp, 0, kMaskSgu, ((uint32_t)b * H + c) * N + n);
        const float tm = rd<true>((ts[n * L.ldc + cc] + sb[n]) * m1);  // bf16(t')
        float u, gp;  // gelu and its derivative at pm's u
        gelu_both(us[n * L.ldc + cc], tanh_flavor, u, gp);
        u = rd<true>(u);
        const float d = __bfloat162float(gs[n * L.ldb + cc]);
        gated[r * ldg + c] = __float2bfloat16_rn(u * tm);
        // du = dgated t' (gmlp_kernel.py:75), the GELU at pm (:65), mask 0 (:63-64)
        const size_t el = r * F + c;
        const float du = rd<true>(d * tm) * gp * keep(dp, 0, kMaskIn, (uint32_t)el);
        put_planes(dq.p + r * dq.ld + c, dq.plane, du);
        bsum += du;
        dtv = m1 != 0.f ? rd<true>(d * u) : 0.f;  // dt' = dgated u (:72-73), its keep bit
      }
      dtb[n * L.ldb + cc] = __float2bfloat16_rn(dtv);
    }
    __syncthreads();
    terms[threadIdx.x] = bsum;
    // dv'(m, cc) = sum over n of sgu_w[m, n] dt(n, cc) (:71)
    float dv[kMI][kCB][4] = {};
    for (int k = 0; k < L.nm; k += 16) {
      uint32_t bb[kCB][2];
#pragma unroll
      for (int j = 0; j < kCB; ++j) frag_b_bf16<true>(bb[j], dtb, L.ldb, k, 8 * (kCB * wc + j));
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        const int tile = wm + 4 * i;
        if (tile < mt) {
          uint32_t ab[4];  // A(m, n) = sgu_w[m, n]
          frag_a_bf16<false>(ab, ws, L.ldw, 16 * tile, k);
#pragma unroll
          for (int j = 0; j < kCB; ++j) mma_bf16(dv[i][j], ab, bb[j]);
        }
      }
    }
    // d sgu_w(m, n) += sum over the chunk of v'(m, cc) dt(n, cc)
#pragma unroll
    for (int k = 0; k < kChunk; k += 16) {
      uint32_t bb[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        if (8 * (wc + kWC * j) < L.np) frag_b_bf16<false>(bb[j], dtb, L.ldb, k, 8 * (wc + kWC * j));
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        const int tile = wm + 4 * i;
        if (tile < mt) {
          uint32_t ab[4];
          frag_a_bf16<false>(ab, vn, L.ldb, 16 * tile, k);
#pragma unroll
          for (int j = 0; j < kNT; ++j)
            if (8 * (wc + kWC * j) < L.np) mma_bf16(dw[i][j], ab, bb[j]);
        }
      }
    }
    // dv' = bf16(scale x its sum) to shared memory (over the u columns)
#pragma unroll
    for (int i = 0; i < kMI; ++i) {
      const int tile = wm + 4 * i;
      if (tile < mt) {
#pragma unroll
        for (int j = 0; j < kCB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            us[(16 * tile + g + 8 * (e >> 1)) * L.ldc + 8 * (kCB * wc + j) + 2 * t + (e & 1)] =
                rd<true>(dsc * dv[i][j][e]);
      }
    }
    // d sgu_b(n) += scale x the sum over the chunk of dt's bits (n, cc)
    for (int n = threadIdx.x; n < N; n += kT) {
      float sum = 0.f;
      for (int cc = 0; cc < kChunk; ++cc) sum += __bfloat162float(dtb[n * L.ldb + cc]);
      dbs[n] += dsc * sum;
    }
    __syncthreads();
    // dv' to the hi plane's v half, neighbouring threads on neighbouring channels
    for (int q = threadIdx.x; q < N * kChunk; q += kT) {
      const int m = q / kChunk, cc = q % kChunk, c = c0 + cc;
      if (c < H)
        dq.p[((size_t)b * N + m) * dq.ld + H + c] = __float2bfloat16_rn(us[m * L.ldc + cc]);
    }
    // the chunk's db_in partial, each channel's kT / kChunk terms in order
    const int c = c0 + threadIdx.x;
    if (threadIdx.x < kChunk && c < H) {
      float sum = 0.f;
      for (int j = threadIdx.x; j < kT; j += kChunk) sum += terms[j];
      dq.bin[(size_t)b * H + c] = sum;
    }
    __syncthreads();
  }
  float* mine = part + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * ((size_t)N * N + N);
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 16 * (wm + 4 * i) + g + 8 * (e >> 1);
        const int n = 8 * (wc + kWC * j) + 2 * t + (e & 1);
        if (m < N && n < N) mine[m * N + n] = dsc * dw[i][j][e];
      }
  for (int i = threadIdx.x; i < N; i += kT) mine[N * N + i] = dbs[i];
}

// backward step 5 on `tile` rows (the plan's row tile): dpre's v half holds
// dv' (sgu_bwd_kernel); the LN(v) backward (gmlp_kernel.py:68) turns it into
// dv, then gelu'(pm) and mask 0 into d pre, in place. The tile's partials of
// d sgu_ln_scale and d sgu_ln_bias (2 x F/2) go to part[blockIdx.x] (float32
// compute).
__global__ void __launch_bounds__(kThreads)
    vln_bwd_kernel(const float* __restrict__ pm, float* __restrict__ dpre,
                   const float* __restrict__ s, float* __restrict__ part, int R, int F,
                   int tile, int tanh_flavor, const __grid_constant__ Dropout dp) {
  extern __shared__ __align__(16) float sm[];
  const int H = F / 2;
  const int r0 = blockIdx.x * tile, nr = min(tile, R - r0);
  float* xh = sm;           // v, then its normalized value
  float* as = xh + tile * H;  // dv'
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < nr; i += kThreads / 32) {
    const size_t row = (size_t)(r0 + i) * F + H;
    float* x = xh + i * H;
    float* a = as + i * H;
    float sum = 0.f;
    for (int c = lane; c < H; c += 32) {
      x[c] = gelu(pm[row + c], tanh_flavor);
      a[c] = dpre[row + c];
      sum += x[c];
    }
    const float mu = warp_sum(sum) / H;
    float sq = 0.f;
    for (int c = lane; c < H; c += 32) {
      const float t = x[c] - mu;
      sq += t * t;
    }
    const float iv = rsqrtf(warp_sum(sq) / H + 1e-5f);
    float su = 0.f, sux = 0.f;
    for (int c = lane; c < H; c += 32) {
      x[c] = (x[c] - mu) * iv;
      const float u = a[c] * __ldg(s + c);
      su += u;
      sux += u * x[c];
    }
    su = warp_sum(su) / H;
    sux = warp_sum(sux) / H;
    for (int c = lane; c < H; c += 32) {
      const float dv = iv * (a[c] * __ldg(s + c) - su - x[c] * sux);
      dpre[row + c] = dv * gelu_grad(pm[row + c], tanh_flavor) *
                      keep(dp, 0, kMaskIn, (uint32_t)(row + c));
    }
  }
  __syncthreads();
  float* mine = part + (size_t)blockIdx.x * 2 * H;
  for (int c = threadIdx.x; c < H; c += kThreads) {
    Kahan ds, db;
    for (int i = 0; i < nr; ++i) {
      ds.add(as[i * H + c] * xh[i * H + c]);
      db.add(as[i * H + c]);
    }
    mine[c] = ds.s;
    mine[H + c] = db.s;
  }
}

// The bf16 route's step 5 on `tile` rows, a warp a row (kW warps, kWarps or
// fewer where the plan fits fewer in shared memory): dpre's hi plane
// holds dv' in its v half (sgu_bwd_bf16_kernel); the LN(v) backward (its scale
// read rounded to bf16, the LN in float32) and gelu'(pm) m0 turn it into the
// v half of dpre, written as its three planes in place. A warp reads its row
// of pm and dv' once into shared memory (v = gelu(pm) and gelu'(pm) from one
// erf) and sums its rows' column terms (dv' x, dv', dpre) there, a lane its
// columns; the tile's partials of d sgu_ln_scale and d sgu_ln_bias go to
// part[blockIdx.x] (2 x F/2) and of db_in's v half to dq.bin[blockIdx.x]
// (F/2), the warps' sums added in warp order.
template <int kW>
__global__ void __launch_bounds__(32 * kW)
    vln_bwd_bf16_kernel(const float* __restrict__ pm, const DpreOut dq,
                        const float* __restrict__ s, float* __restrict__ part, int R, int F,
                        int tile, int tanh_flavor, const __grid_constant__ Dropout dp) {
  extern __shared__ __align__(16) float sm[];  // kW x 6 x F/2
  const int H = F / 2;
  const int r0 = blockIdx.x * tile, nr = min(tile, R - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* x = sm + (size_t)warp * 6 * H;  // the row's v, then its normalized value
  float* gp = x + H;                     // gelu'(pm)
  float* a = gp + H;                     // the row's dv'
  float* acc = a + H;                    // the warp's sums of dv' x, dv', dpre
  for (int c = lane; c < 3 * H; c += 32) acc[c] = 0.f;
  for (int i = warp; i < nr; i += kW) {
    const size_t r = (size_t)(r0 + i);
    const float* pr = pm + r * F + H;
    bf16_t* dr = dq.p + r * dq.ld + H;
    float sum = 0.f;
    for (int c = lane; c < H; c += 32) {
      float v, d;
      gelu_both(pr[c], tanh_flavor, v, d);
      x[c] = v;
      gp[c] = d;
      a[c] = __bfloat162float(dr[c]);
      sum += v;
    }
    const float mu = warp_sum(sum) / H;
    float sq = 0.f;
    for (int c = lane; c < H; c += 32) {
      const float t = x[c] - mu;
      sq += t * t;
    }
    const float iv = rsqrtf(warp_sum(sq) / H + 1e-5f);
    float su = 0.f, sux = 0.f;
    for (int c = lane; c < H; c += 32) {
      x[c] = (x[c] - mu) * iv;
      const float u = a[c] * rd<true>(__ldg(s + c));
      su += u;
      sux += u * x[c];
    }
    su = warp_sum(su) / H;
    sux = warp_sum(sux) / H;
    for (int c = lane; c < H; c += 32) {
      const float v = iv * (a[c] * rd<true>(__ldg(s + c)) - su - x[c] * sux) * gp[c] *
                      keep(dp, 0, kMaskIn, (uint32_t)(r * F + H + c));
      put_planes(dr + c, dq.plane, v);
      acc[c] += a[c] * x[c];
      acc[H + c] += a[c];
      acc[2 * H + c] += v;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < H; c += 32 * kW) {
    Kahan ds, db, dbin;
    for (int w = 0; w < kW; ++w) {
      const float* wacc = sm + (size_t)w * 6 * H + 3 * H;
      ds.add(wacc[c]);
      db.add(wacc[H + c]);
      dbin.add(wacc[2 * H + c]);
    }
    part[(size_t)blockIdx.x * 2 * H + c] = ds.s;
    part[(size_t)blockIdx.x * 2 * H + H + c] = db.s;
    dq.bin[(size_t)blockIdx.x * H + c] = dbin.s;
  }
}

// The bf16 route's step 0: the rounded weights the engine reads, rows padded
// to whole 16-byte groups with zeros: w_in_b (D x Fp) = bf16(W_in), w_out_b
// (F/2 x Dp) = bf16(W_out) and, where given, w_out_t (D x Hp) = bf16(W_out)^T
// (the backward's dgated reads W_out^T MN-major)
__global__ void __launch_bounds__(kThreads)
    prep_weights_kernel(const float* __restrict__ w_in, const float* __restrict__ w_out,
                        bf16_t* __restrict__ w_in_b, bf16_t* __restrict__ w_out_b,
                        bf16_t* __restrict__ w_out_t, int D, int F, int Dp, int Fp, int Hp) {
  const int H = F / 2;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < D * Fp) {
    const int d = i / Fp, f = i - d * Fp;
    w_in_b[i] = __float2bfloat16_rn(f < F ? __ldg(w_in + (size_t)d * F + f) : 0.f);
  }
  if (i < H * Dp) {
    const int h = i / Dp, d = i - h * Dp;
    w_out_b[i] = __float2bfloat16_rn(d < D ? __ldg(w_out + (size_t)h * D + d) : 0.f);
  }
  if (w_out_t && i < D * Hp) {
    const int d = i / Hp, h = i - d * Hp;
    w_out_t[i] = __float2bfloat16_rn(h < H ? __ldg(w_out + (size_t)h * D + d) : 0.f);
  }
}

// the bf16 route's in-projection on the wgmma engine (plain stores): columns
// c, c + 1 of row r -> (v + b_in) m0, its GELU where `act` (the forward's h;
// the backward keeps the masked pre-activation pm), float32 rows of F (even,
// so the pair is one aligned float2)
struct EpiInWg {
  static constexpr int kOuts = 0;
  const float* b_in;
  float* out;
  int F, act, tanh_flavor;
  Dropout dp;
  __device__ __forceinline__ void operator()(const WgJob&, const WgArgs&, int, int r, int c,
                                             float v0, float v1) const {
    const size_t e = (size_t)r * F + c;
    float v[2] = {v0, v1};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      v[k] = (v[k] + __ldg(b_in + c + k)) * keep(dp, 0, kMaskIn, (uint32_t)(e + k));
      if (act) v[k] = gelu(v[k], tanh_flavor);
    }
    *reinterpret_cast<float2*>(out + e) = make_float2(v[0], v[1]);
  }
};

// y = bf16(bf16(x) + bf16((v + b_out) m2)) at element e of column d (the bf16
// route's out-projection with _block_math's bf16 residual sum)
__device__ __forceinline__ float out_value(const float* __restrict__ x,
                                           const float* __restrict__ b_out, float v, size_t e,
                                           int d, const Dropout& dp) {
  return rd<true>(rd<true>(__ldg(x + e)) +
                  rd<true>((v + __ldg(b_out + d)) * keep(dp, 0, kMaskOut, (uint32_t)e)));
}

// the bf16 route's out-projection in one slice (plain stores): columns c, c +
// 1 of row r -> y (rows of D)
struct EpiOutWg {
  static constexpr int kOuts = 0;
  const float* b_out;
  const float* x;
  float* y;
  int D;
  Dropout dp;
  __device__ __forceinline__ void operator()(const WgJob&, const WgArgs&, int, int r, int c,
                                             float v0, float v1) const {
    const size_t e = (size_t)r * D + c;
    const float y0 = out_value(x, b_out, v0, e, c, dp);
    if (c + 1 >= D) {
      y[e] = y0;
    } else if (D % 2 == 0) {  // e even: one aligned pair
      *reinterpret_cast<float2*>(y + e) =
          make_float2(y0, out_value(x, b_out, v1, e + 1, c + 1, dp));
    } else {
      y[e] = y0;
      y[e + 1] = out_value(x, b_out, v1, e + 1, c + 1, dp);
    }
  }
};

// the out-projection's slices (part, ksplit x R x D, added in slice order)
// finished as EpiOutWg finishes one
__global__ void __launch_bounds__(kThreads)
    out_finish_kernel(const float* __restrict__ part, int ksplit, const float* __restrict__ x,
                      const float* __restrict__ b_out, float* __restrict__ y, int R, int D,
                      const __grid_constant__ Dropout dp) {
  const size_t total = (size_t)R * D;
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  float v = 0.f;
  for (int k = 0; k < ksplit; ++k) v += part[k * total + e];
  y[e] = out_value(x, b_out, v, e, (int)(e % D), dp);
}

// the bf16 route's dgated = bf16(scale x dout W_out^T) (the dropout scale of
// dout's keep bits on the float32 sums), zeros in the pad columns H <= c < Hp;
// the engine stages and writes its whole bf16 rows
struct EpiDgWg {
  static constexpr int kOuts = 1;
  bf16_t* dg;  // R x Hp
  int H;
  float scale;
  __device__ __forceinline__ bf16_t* dst(int) const { return dg; }
  __device__ __forceinline__ void operator()(int, int c, float v0, float v1,
                                             __nv_bfloat162 (&out)[kOuts]) const {
    out[0] = __floats2bfloat162_rn(c < H ? v0 * scale : 0.f, c + 1 < H ? v1 * scale : 0.f);
  }
};

// ------------------------------------------------------------ large-N route
// Above kSguSeq tokens a sample's N x N token projection no longer fits the
// SGU's shared memory. There the SGU runs as the mixer's token pipeline runs
// its token FF (token_ff.cuh): products over all rows of the token
// projection's own layout, (B*F/2, N) rows r = b*F/2 + c, as _block_math
// writes it (gmlp_kernel.py:70-73):
//   vt_kernel:   vt = LN(v) in that layout (a 32 x 32 tile of tokens x
//                v-channels a CTA, transposed through shared memory);
//   forward:     t = vt sgu_w, its epilogue t' = (t + sgu_b) m1 (mask 1 counts
//                in this layout: r * N + n) and gated = u t' into gated's
//                (B*N, F/2) rows;
//   backward:    the same product recomputes t', its epilogue the gate: gated,
//                dpre's u half and dt (in vt's layout); dv' = dt sgu_w^T, its
//                epilogue dv' into dpre's v half; d sgu_w = vt^T dt over row
//                slices of the B*F/2 rows, summed in slice order; d sgu_b the
//                column sums of dt over the same slices.
// float32 runs the products on tc_gemm (3xTF32), bf16 on the wgmma engine with
// the casts above (vt = bf16(LN(v)), sgu_w rounded, dt's bits times mask 1's
// keep bit, the dropout scale on the sums), each with its own kernels and
// epilogues: the SGU kernels of the route below kSguSeq are untouched. The
// epilogues write gated, dpre and dv' a warp's 8 tokens x 8 v-channels at a
// time (32-byte runs), which is where this route spends bytes the
// shared-memory SGU does not. The products' grids bound it: B*F/2 rows in at
// most 65535 tiles of 128.

// vt[(b F/2 + c) ld + n] = LN(v)[b N + n, c] (kFromPre: v = gelu(a)), the
// statistics from vstats_kernel; bf16: LN's scale and bias read rounded, vt
// rounded (the token projection's operand). A 32 x 32 tile a CTA (32 x 8
// threads), tokens n0.. and v-channels c0.. of sample blockIdx.z.
template <bool kFromPre, bool kBf16>
__global__ void __launch_bounds__(256)
    vt_kernel(const float* __restrict__ a, const float* __restrict__ vstats,
              const float* __restrict__ s, const float* __restrict__ bias, void* __restrict__ vt,
              int ld, int N, int F, int R, int tanh_flavor) {
  __shared__ float tile[32][33];
  const int H = F / 2, b = blockIdx.z, n0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int i = ty; i < 32; i += 8) {
    const int n = n0 + i, c = c0 + tx;
    float v = 0.f;
    if (n < N && c < H) {
      const int r = b * N + n;
      const float x = a[(size_t)r * F + H + c];
      v = ((kFromPre ? gelu(x, tanh_flavor) : x) - vstats[r]) * vstats[R + r] *
              rd<kBf16>(__ldg(s + c)) +
          rd<kBf16>(__ldg(bias + c));
    }
    tile[i][tx] = v;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int c = c0 + i, n = n0 + tx;
    if (c < H && n < N) {
      const size_t o = ((size_t)b * H + c) * ld + n;
      if constexpr (kBf16)
        static_cast<bf16_t*>(vt)[o] = __float2bfloat16_rn(tile[tx][i]);
      else
        static_cast<float*>(vt)[o] = tile[tx][i];
    }
  }
}

// out (rows x ld bf16) = bf16(w) (rows x cols float32), zeros in the pad columns
__global__ void __launch_bounds__(kThreads)
    round_rows_kernel(const float* __restrict__ w, bf16_t* __restrict__ out, int rows, int cols,
                      int ld) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= rows * ld) return;
  const int r = i / ld, c = i - r * ld;
  out[i] = __float2bfloat16_rn(c < cols ? __ldg(w + (size_t)r * cols + c) : 0.f);
}

// part[y C + c] = scale x the sum over rows [y rslice, (y + 1) rslice) of a's
// column c, each element the sum of its kPlanes bf16 planes (`plane` apart;
// dpre's three); rows ld apart, in order
template <int kPlanes>
__global__ void __launch_bounds__(kThreads)
    col_bf16_kernel(const bf16_t* __restrict__ a, size_t plane, int C, int ld,
                    float* __restrict__ part, int R, int rslice, float scale) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const int r0 = blockIdx.y * rslice, r1 = min(R, r0 + rslice);
  Kahan v;
  for (int r = r0; r < r1; ++r) {
    const bf16_t* p = a + (size_t)r * ld + c;
    float x = __bfloat162float(p[0]);
    if constexpr (kPlanes == 3)
      x += __bfloat162float(p[plane]) + __bfloat162float(p[2 * plane]);
    v.add(x);
  }
  part[(size_t)blockIdx.y * C + c] = scale * v.s;
}

// the rows of the large-N route: row r of the token projection's layout is
// v-channel c of sample b; token n of that sample is row b N + n of gated's
struct TokRow {
  int N, H;
  __device__ __forceinline__ void at(int r, int n, int& c, size_t& row) const {
    const int b = r / H;
    c = r - b * H;
    row = (size_t)b * N + n;
  }
};

// float32 forward: t' = (t + sgu_b) m1; gated = u t' (u from h)
struct EpiGateTc {
  static constexpr bool kNoStore = true;
  TokRow tr;
  const float* sgu_b;
  const float* h;
  float* gated;
  int F;
  Dropout dp;
  __device__ __forceinline__ float operator()(int r, int n, float v) const {
    int c;
    size_t row;
    tr.at(r, n, c, row);
    const float tm = (v + __ldg(sgu_b + n)) *
                     keep(dp, 0, kMaskSgu, (uint32_t)((size_t)r * tr.N + n));
    gated[row * tr.H + c] = h[row * F + c] * tm;
    return 0.f;
  }
};

// float32 backward, the gate (sgu_bwd_kernel's, element by element): gated,
// dpre's u half = dgated t' gelu'(pm) m0; stores dt = dgated u m1
struct EpiGateBwdTc {
  TokRow tr;
  const float* sgu_b;
  const float* pm;
  const float* dg;
  float* gated;
  float* dpre;
  int F, tanh_flavor;
  Dropout dp;
  __device__ __forceinline__ float operator()(int r, int n, float v) const {
    int c;
    size_t row;
    tr.at(r, n, c, row);
    const float m1 = keep(dp, 0, kMaskSgu, (uint32_t)((size_t)r * tr.N + n));
    const float tm = (v + __ldg(sgu_b + n)) * m1;
    const float pu = pm[row * F + c];
    const float u = gelu(pu, tanh_flavor);
    const float d = dg[row * tr.H + c];
    gated[row * tr.H + c] = u * tm;
    const size_t el = row * F + c;
    dpre[el] = d * tm * gelu_grad(pu, tanh_flavor) * keep(dp, 0, kMaskIn, (uint32_t)el);
    return d * u * m1;
  }
};

// float32 backward: dv' (row r, token m) to dpre's v half (raw, as
// sgu_bwd_kernel leaves it for vln_bwd_kernel)
struct EpiDvTc {
  static constexpr bool kNoStore = true;
  TokRow tr;
  float* dpre;
  int F;
  __device__ __forceinline__ float operator()(int r, int m, float v) const {
    int c;
    size_t row;
    tr.at(r, m, c, row);
    dpre[row * F + tr.H + c] = v;
    return 0.f;
  }
};

// bf16 forward: gated = bf16(bf16(u) bf16((t + sgu_b) m1)) in rows of ldg
struct EpiGateWg {
  static constexpr int kOuts = 0;
  TokRow tr;
  const float* sgu_b;
  const float* h;
  bf16_t* gated;
  int F, ldg;
  Dropout dp;
  __device__ __forceinline__ void operator()(const WgJob&, const WgArgs&, int, int r, int c,
                                             float v0, float v1) const {
    const float v[2] = {v0, v1};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int n = c + k;
      if (n >= tr.N) break;
      int ch;
      size_t row;
      tr.at(r, n, ch, row);
      const float tm = rd<true>((v[k] + __ldg(sgu_b + n)) *
                                keep(dp, 0, kMaskSgu, (uint32_t)((size_t)r * tr.N + n)));
      gated[row * ldg + ch] = __float2bfloat16_rn(rd<true>(h[row * F + ch]) * tm);
    }
  }
};

// bf16 backward, the gate (sgu_bwd_bf16_kernel's): gated (bf16), dpre's u
// half as three planes, dt's bits (bf16(dgated bf16(u)) or 0 where mask 1
// drops) in vt's layout (rows of ldt)
struct EpiGateBwdWg {
  static constexpr int kOuts = 0;
  TokRow tr;
  const float* sgu_b;
  const float* pm;
  const bf16_t* dg;  // rows of ldg
  bf16_t* gated;     // rows of ldg
  bf16_t* dt;        // rows of ldt
  DpreOut dq;
  int F, ldg, ldt, tanh_flavor;
  Dropout dp;
  __device__ __forceinline__ void operator()(const WgJob&, const WgArgs&, int, int r, int c,
                                             float v0, float v1) const {
    const float v[2] = {v0, v1};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int n = c + k;
      if (n >= tr.N) break;
      int ch;
      size_t row;
      tr.at(r, n, ch, row);
      const float m1 = keep(dp, 0, kMaskSgu, (uint32_t)((size_t)r * tr.N + n));
      const float tm = rd<true>((v[k] + __ldg(sgu_b + n)) * m1);
      float u, gp;
      gelu_both(pm[row * F + ch], tanh_flavor, u, gp);
      u = rd<true>(u);
      const float d = __bfloat162float(dg[row * ldg + ch]);
      gated[row * ldg + ch] = __float2bfloat16_rn(u * tm);
      const size_t el = row * F + ch;
      put_planes(dq.p + row * dq.ld + ch, dq.plane,
                 rd<true>(d * tm) * gp * keep(dp, 0, kMaskIn, (uint32_t)el));
      dt[(size_t)r * ldt + n] = __float2bfloat16_rn(m1 != 0.f ? rd<true>(d * u) : 0.f);
    }
  }
};

// bf16 backward: dv' = bf16(scale x its sum) to dpre's hi plane, v half
struct EpiDvWg {
  static constexpr int kOuts = 0;
  TokRow tr;
  bf16_t* hi;
  int ld;
  float scale;
  __device__ __forceinline__ void operator()(const WgJob&, const WgArgs&, int, int r, int c,
                                             float v0, float v1) const {
    const float v[2] = {v0, v1};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int m = c + k;
      if (m >= tr.N) break;
      int ch;
      size_t row;
      tr.at(r, m, ch, row);
      hi[row * ld + tr.H + ch] = __float2bfloat16_rn(rd<true>(scale * v[k]));
    }
  }
};

struct Plan {
  int sms;              // the card's SMs (the tile rule of the forward's products)
  int nsplit;           // SGU CTAs per sample
  int xsplit, xslice;   // dxn: slices of F
  int wsplit, wslice;   // dW_in (and in float32 dW_out, db_in, db_out): slices of the rows
  int tiles;            // row tiles of the LN backward and bf16 row kernels
  int rt;               // their rows: kRowTile, or as many as fit the shared memory
  int vwarps;           // warps of the bf16 LN(v) backward: kWarps, or the most of 4, 2, 1 that fit
  bool wide_sgu;        // the SGU kernels on 16 warps (8 m16 token tiles), else 8 (4)
  bool tok;             // the large-N route (above kSguSeq tokens): the SGU as products
  int Np;               // its vt and dt rows: N, or in bf16 N rounded up to 8
  int tslice, tsplit;   // its d sgu_w and d sgu_b: slices of the B*F/2 rows
  size_t sgu_fwd_smem, sgu_bwd_smem, vln_smem, ln_smem;
  // bf16: the operands' padded rows (D, F/2 and F rounded up to 8); the
  // out-projection's slices of F/2 (ysplit 1: its epilogue finishes y); dW_out's
  // slices of the rows; ln_rows_bf16_kernel's shared memory
  int Dp, Hp, Fp, ysplit, yslice, vsplit, vslice;
  size_t rows_smem;
  // workspace offsets (floats). float32: w_in_r, w_out_r, w_out_t, p_bin and
  // p_bout unused. bf16: xn, gated, the weight copies, dout, dg and dpre's
  // three planes hold bf16; act holds the forward's h, or its out-projection's
  // slices once the SGU is done with h, or the backward's pm; p_col unused
  size_t xn, act, gated, vstats, w_in_r, w_out_r, w_out_t, dout, dg, dpre, dxnp, p_ln, p_vln,
      p_sgu, p_win, p_wout, p_col, p_bin, p_bout;
  // the large-N route: vt, dt (B*F/2 x Np), bf16's rounded sgu_w (N x Np), d
  // sgu_b's slices; p_sgu then holds d sgu_w's slices (tsplit x N x N)
  size_t vt, dtt, w_sgu_r, p_sgb;
  size_t fwd_floats, bwd_floats;
};

int check_args(int B, int N, int D, int F) {
  if (B < 1 || B > 65535 || N < 1 || N > kMaxSeq || D < 1 || F < 2 || F % 2) return -1;
  // the large-N route's products over B*F/2 rows: at most 65535 tiles of 128
  if (N > kSguSeq && (long long)B * (F / 2) > 65535LL * 128) return -1;
  const unsigned long long big = (unsigned long long)B * N * (F > D ? F : D);
  if (big >= (1ull << 32)) return -1;  // the dropout masks count their elements in 32 bits
  return 0;
}

// the float32 workspace: float32 operands, tc_gemm's slices (unchanged since
// PR 5's redesign)
void plan_f32(int B, int N, int D, int F, Plan& pl) {
  const int H = F / 2, sms = pl.sms;
  const long long R = (long long)B * N;
  // dxn = dpre W_in^T: (rows x D) tiles x slices of F
  fill_slices(F, ceil_div(R, kTcBM) * ceil_div(D, kTcBN), sms, pl.xslice, pl.xsplit);
  // the weight gradients: dW_in's few tiles x slices of the rows
  row_slices(R, ceil_div(D, kTcBM) * ceil_div(F, kTcBN), sms, pl.wslice, pl.wsplit);
  const size_t rows = (size_t)R;
  size_t o = 0;
  pl.xn = o, o += rows * D;
  pl.act = o, o += rows * F;
  pl.gated = o, o += rows * H;
  pl.vstats = o, o += 2 * rows;
  const size_t tok_rows = (size_t)B * H * pl.Np;  // vt, dt (the large-N route)
  if (pl.tok) o = (o + 3) / 4 * 4, pl.vt = o, o += tok_rows;
  o = (o + 3) / 4 * 4;
  pl.w_in_r = pl.w_out_r = pl.w_out_t = o;
  pl.fwd_floats = o;
  pl.dout = o, o += rows * D;
  pl.dg = o, o += rows * H;
  pl.dpre = o, o += rows * F;
  pl.dxnp = o, o += (size_t)pl.xsplit * rows * D;
  pl.p_ln = o, o += (size_t)pl.tiles * 2 * D;
  pl.p_vln = o, o += (size_t)pl.tiles * 2 * H;
  pl.p_sgu = o, o += pl.tok ? (size_t)pl.tsplit * N * N : (size_t)B * pl.nsplit * ((size_t)N * N + N);
  pl.p_win = o, o += (size_t)pl.wsplit * D * F;
  pl.p_wout = o, o += (size_t)pl.wsplit * H * D;
  pl.p_col = o, o += (size_t)pl.wsplit * (F + D);
  if (pl.tok) {
    o = (o + 3) / 4 * 4;
    pl.dtt = o, o += tok_rows;
    pl.p_sgb = o, o += (size_t)pl.tsplit * N;
  }
  pl.p_bin = pl.p_bout = o;
  pl.bwd_floats = o;
}

// the bf16 workspace: bf16 operands in padded rows, the engine's slices
void plan_bf16(int B, int N, int D, int F, Plan& pl) {
  const int H = F / 2, sms = pl.sms;
  const long long R = (long long)B * N;
  pl.Dp = pad8(D), pl.Hp = pad8(H), pl.Fp = pad8(F);
  // the out-projection (rows x D) in 128 x 64 tiles x slices of F/2, where
  // its tiles are fewer than the SMs
  wg_slices(H, (long long)ceil_div(R, kWgBM) * ceil_div(D, 64), sms, 1, pl.yslice, pl.ysplit);
  // dxn = dpre W_in^T: 128 x 128 tiles x slices of F
  wg_slices(F, (long long)ceil_div(R, kWgBM) * ceil_div(D, kWgBN), sms, 1, pl.xslice, pl.xsplit);
  // dW_in (D x F) and dW_out (F/2 x D): slices of the rows, about a CTA an SM
  wg_slices(R, (long long)ceil_div(D, kWgBM) * ceil_div(F, kWgBN), sms, 1, pl.wslice, pl.wsplit);
  wg_slices(R, (long long)ceil_div(H, kWgBM) * ceil_div(D, kWgBN), sms, 1, pl.vslice, pl.vsplit);
  const size_t rows = (size_t)R;
  size_t o = 0;
  auto take = [&o](size_t& at, size_t floats) { at = o, o += (floats + 3) / 4 * 4; };
  auto op = [](size_t n) { return (n + 1) / 2; };  // n bf16 in floats
  const size_t yparts = pl.ysplit > 1 ? (size_t)pl.ysplit * rows * D : 0;
  take(pl.xn, op(rows * pl.Dp));
  take(pl.act, rows * F > yparts ? rows * F : yparts);
  take(pl.gated, op(rows * pl.Hp));
  take(pl.vstats, 2 * rows);
  take(pl.w_in_r, op((size_t)D * pl.Fp));
  take(pl.w_out_r, op((size_t)H * pl.Dp));
  const size_t tok_rows = op((size_t)B * H * pl.Np);  // vt, dt (the large-N route)
  if (pl.tok) take(pl.vt, tok_rows), take(pl.w_sgu_r, op((size_t)N * pl.Np));
  pl.fwd_floats = o;
  take(pl.w_out_t, op((size_t)D * pl.Hp));
  take(pl.dout, op(rows * pl.Dp));
  take(pl.dg, op(rows * pl.Hp));
  take(pl.dpre, 3 * op(rows * pl.Fp));
  take(pl.dxnp, (size_t)pl.xsplit * rows * D);
  take(pl.p_ln, (size_t)pl.tiles * 2 * D);
  take(pl.p_vln, (size_t)pl.tiles * 2 * H);
  take(pl.p_sgu, pl.tok ? (size_t)pl.tsplit * N * N : (size_t)B * pl.nsplit * ((size_t)N * N + N));
  take(pl.p_win, (size_t)pl.wsplit * D * F);
  take(pl.p_wout, (size_t)pl.vsplit * H * D);
  take(pl.p_bin, ((size_t)B + pl.tiles) * H);
  take(pl.p_bout, (size_t)pl.tiles * D);
  if (pl.tok) take(pl.dtt, tok_rows), take(pl.p_sgb, (size_t)pl.tsplit * N);
  pl.p_col = o;
  pl.bwd_floats = o;
}

int make_plan(int B, int N, int D, int F, bool bf16, int device, Plan& pl) {
  pl = Plan{};
  DeviceInfo dev;
  const cudaError_t err = device_info(device, dev);
  if (err != cudaSuccess) return err;
  pl.sms = dev.sms;
  const int H = F / 2;
  const long long R = (long long)B * N;
  const int chunks = ceil_div(H, kChunk);
  const int ns = ceil_div(2 * pl.sms, B);
  pl.nsplit = ns < 1 ? 1 : (ns > chunks ? chunks : ns);
  pl.tok = N > kSguSeq;
  if (pl.tok) {
    // d sgu_w (N x N) over the B*F/2 rows: the engine's or tc_gemm's row slices
    pl.Np = bf16 ? pad8(N) : N;
    if (bf16)
      wg_slices((long long)B * H, (long long)ceil_div(N, kWgBM) * ceil_div(N, kWgBN), pl.sms, 1,
                pl.tslice, pl.tsplit);
    else
      row_slices((long long)B * H, ceil_div(N, kTcBM) * ceil_div(N, kTcBN), pl.sms, pl.tslice,
                 pl.tsplit);
  } else {
    pl.wide_sgu = sgu_layout(N, false).nm > 64;
    pl.sgu_fwd_smem = (bf16 ? sgu_layout_bf16(N, false).floats : sgu_layout(N, false).floats) * 4;
    pl.sgu_bwd_smem = (bf16 ? sgu_layout_bf16(N, true).floats : sgu_layout(N, true).floats) * 4;
  }
  const size_t most = (size_t)dev.smem_optin;
  // the row tile of the LN backwards and the bf16 row kernels: kRowTile rows,
  // or as many as fit a CTA's shared memory (LN1's backward: 3 floats a
  // column and 2 a row; the float32 LN(v) backward: 2 floats a column of F/2)
  int rt = kRowTile;
  while (rt > 1 && (ln_bwd_smem_bytes(rt, D) > most || (!bf16 && (size_t)2 * rt * H * 4 > most)))
    --rt;
  // the bf16 LN(v) backward: a warp a row, 6 floats a column of F/2 a warp
  int vw = kWarps;
  while (vw > 1 && (size_t)vw * 6 * H * 4 > most) vw /= 2;
  pl.rt = rt, pl.vwarps = vw;
  pl.vln_smem = bf16 ? (size_t)vw * 6 * H * 4 : (size_t)2 * rt * H * 4;
  pl.ln_smem = ln_bwd_smem_bytes(rt, D);
  pl.rows_smem = bf16 ? (size_t)kWarps * D * 4 : 0;
  if (pl.sgu_bwd_smem > most || pl.vln_smem > most || pl.ln_smem > most || pl.rows_smem > most)
    return -1;
  pl.tiles = ceil_div(R, rt);
  if (bf16)
    plan_bf16(B, N, D, F, pl);
  else
    plan_f32(B, N, D, F, pl);
  return 0;
}

SguParams sgu_params(const void* const* q) {
  return SguParams{static_cast<const float*>(q[4]), static_cast<const float*>(q[5]),
                   static_cast<const float*>(q[6]), static_cast<const float*>(q[7])};
}

// the large-N route's vt = LN(v) (kFromPre: of gelu(pm)) in the token
// projection's layout, rows of ld
template <bool kFromPre, bool kBf16>
cudaError_t launch_vt(const float* a, const float* vstats, const void* const* ptrs, void* vt,
                      int ld, int B, int N, int F, int tanh_flavor, cudaStream_t st) {
  const dim3 grid(ceil_div(F / 2, 32), ceil_div(N, 32), B);
  vt_kernel<kFromPre, kBf16><<<grid, 256, 0, st>>>(a, vstats, static_cast<const float*>(ptrs[4]),
                                                   static_cast<const float*>(ptrs[5]), vt, ld, N,
                                                   F, B * N, tanh_flavor);
  m2m_count(kTallyGmlpVt);
  return cudaGetLastError();
}

// the large-N route's bf16(sgu_w), rows of Np
cudaError_t round_sgu_w(const Plan& pl, const void* const* ptrs, bf16_t* out, int N,
                        cudaStream_t st) {
  round_rows_kernel<<<ceil_div((long long)N * pl.Np, kThreads), kThreads, 0, st>>>(
      static_cast<const float*>(ptrs[6]), out, N, N, pl.Np);
  return cudaGetLastError();
}

// K3f in float32 compute (see m2m_gmlp_fwd)
int gmlp_fwd_f32(const Plan& pl, const float* x, float* y, int B, int N, int D, int F,
                 int tanh_flavor, const Dropout& dp, int device, const void* const* ptrs,
                 float* ws, cudaStream_t st) {
  // m16 token tiles: 8 on 16 warps, else 4 on 8 warps
  auto sgu_fwd = pl.wide_sgu ? sgu_fwd_kernel<8, 4> : sgu_fwd_kernel<4, 2>;
  if (!pl.tok) M2M_TRY(prepare(sgu_fwd, pl.sgu_fwd_smem, device));
  const int R = B * N, H = F / 2;
  auto q = [ptrs](int i) { return static_cast<const float*>(ptrs[i]); };
  // 1. xn = LN(x)
  ln_rows_kernel<<<ceil_div(R, kWarps), kThreads, 0, st>>>(x, q(0), q(1), ws + pl.xn, nullptr,
                                                           nullptr, R, D, dp);
  M2M_TRY(cudaGetLastError());
  // 2. h = gelu((xn W_in + b_in) m0) (gmlp_kernel.py:62-65)
  M2M_TRY(tc_gemm_auto(View{ws + pl.xn, D, 1}, View{q(2), F, 1}, ws + pl.act, R, F, D, pl.sms,
                       st, EpiBiasMaskGelu{EpiBiasMask{q(3), kMaskIn, F, dp}, tanh_flavor}));
  // 3. LN(v)'s statistics (:68)
  vstats_kernel<false><<<ceil_div(R, kWarps), kThreads, 0, st>>>(ws + pl.act, ws + pl.vstats, R,
                                                                 F, 0);
  M2M_TRY(cudaGetLastError());
  // 4. gated = u (LN(v) sgu_w + sgu_b) m1 (:67-75)
  if (pl.tok) {  // the large-N route: vt, then the token projection over all rows
    M2M_TRY((launch_vt<false, false>(ws + pl.act, ws + pl.vstats, ptrs, ws + pl.vt, N, B, N, F,
                                     0, st)));
    M2M_TRY((tc_gemm_auto<0, false>(View{ws + pl.vt, N, 1}, View{q(6), N, 1}, nullptr, B * H, N,
                                    N, pl.sms, st,
                                    EpiGateTc{TokRow{N, H}, q(7), ws + pl.act, ws + pl.gated, F,
                                              dp})));
  } else {
    sgu_fwd<<<dim3(pl.nsplit, B), pl.wide_sgu ? 512 : 256, pl.sgu_fwd_smem, st>>>(
        ws + pl.act, ws + pl.vstats, ws + pl.gated, sgu_params(ptrs), N, F, dp);
    M2M_TRY(cudaGetLastError());
  }
  // 5. y = x + (gated W_out + b_out) m2 (:77-80)
  return tc_gemm_auto(View{ws + pl.gated, H, 1}, View{q(8), D, 1}, y, R, D, H, pl.sms, st,
                      EpiResidual{EpiBiasMask{q(9), kMaskOut, D, dp}, x});
}

// K3f in bf16 compute: the same steps, the two products on the wgmma engine
int gmlp_fwd_bf16(const Plan& pl, const float* x, float* y, int B, int N, int D, int F,
                  int tanh_flavor, const Dropout& dp, int device, const void* const* ptrs,
                  float* ws, cudaStream_t st) {
  auto sgu_fwd = pl.wide_sgu ? sgu_fwd_bf16_kernel<8, 4> : sgu_fwd_bf16_kernel<4, 2>;
  if (!pl.tok) M2M_TRY(prepare(sgu_fwd, pl.sgu_fwd_smem, device));
  const int R = B * N, H = F / 2;
  auto q = [ptrs](int i) { return static_cast<const float*>(ptrs[i]); };
  auto bf = [ws](size_t at) { return reinterpret_cast<bf16_t*>(ws + at); };
  // 0. W_in and W_out rounded where _block_math casts them, rows padded
  const int most = D * pl.Fp > H * pl.Dp ? D * pl.Fp : H * pl.Dp;
  prep_weights_kernel<<<ceil_div(most, kThreads), kThreads, 0, st>>>(
      q(2), q(8), bf(pl.w_in_r), bf(pl.w_out_r), nullptr, D, F, pl.Dp, pl.Fp, pl.Hp);
  M2M_TRY(cudaGetLastError());
  // 1. xn = LN(x) in bf16
  ln_rows_bf16_kernel<<<ceil_div(R, kWarps), kThreads, 0, st>>>(
      x, q(0), q(1), bf(pl.xn), pl.Dp, nullptr, nullptr, nullptr, R, D, kWarps, dp);
  M2M_TRY(cudaGetLastError());
  // 2. h = gelu((xn W_in + b_in) m0) (gmlp_kernel.py:62-65), float32
  M2M_TRY(wg_product<64>(bf(pl.xn), pl.Dp, bf(pl.w_in_r), pl.Fp, nullptr, R, F, D, D, 1,
                         EpiInWg{q(3), ws + pl.act, F, 1, tanh_flavor, dp}, device, st));
  // 3. LN(v)'s statistics (:68)
  vstats_kernel<false><<<ceil_div(R, kWarps), kThreads, 0, st>>>(ws + pl.act, ws + pl.vstats, R,
                                                                 F, 0);
  M2M_TRY(cudaGetLastError());
  // 4. gated = bf16(u) bf16((LN(v) sgu_w + sgu_b) m1) (:67-75), in bf16
  if (pl.tok) {  // the large-N route: vt, then the token projection on the engine
    M2M_TRY((launch_vt<false, true>(ws + pl.act, ws + pl.vstats, ptrs, bf(pl.vt), pl.Np, B, N, F,
                                    0, st)));
    M2M_TRY(round_sgu_w(pl, ptrs, bf(pl.w_sgu_r), N, st));
    M2M_TRY(wg_product<64>(bf(pl.vt), pl.Np, bf(pl.w_sgu_r), pl.Np, nullptr, (long long)B * H, N,
                           N, N, 1,
                           EpiGateWg{TokRow{N, H}, q(7), ws + pl.act, bf(pl.gated), F, pl.Hp, dp},
                           device, st));
  } else {
    sgu_fwd<<<dim3(pl.nsplit, B), pl.wide_sgu ? 512 : 256, pl.sgu_fwd_smem, st>>>(
        ws + pl.act, ws + pl.vstats, bf(pl.gated), pl.Hp, sgu_params(ptrs), N, F, dp);
    M2M_TRY(cudaGetLastError());
  }
  // 5. y = bf16(x) + bf16((gated W_out + b_out) m2) (:77-80): in the epilogue, or
  // over slices of F/2 (their partials over h, which the SGU is done with)
  if (pl.ysplit == 1)
    return wg_product<64>(bf(pl.gated), pl.Hp, bf(pl.w_out_r), pl.Dp, nullptr, R, D, H, H, 1,
                          EpiOutWg{q(9), x, y, D, dp}, device, st);
  M2M_TRY(wg_product<64>(bf(pl.gated), pl.Hp, bf(pl.w_out_r), pl.Dp, ws + pl.act, R, D, H,
                         pl.yslice, pl.ysplit, EpiWgStore{}, device, st));
  out_finish_kernel<<<ceil_div((long long)R * D, kThreads), kThreads, 0, st>>>(
      ws + pl.act, pl.ysplit, x, q(9), y, R, D, dp);
  return (int)cudaGetLastError();
}

// K3b in float32 compute (see m2m_gmlp_bwd)
int gmlp_bwd_f32(const Plan& pl, const float* x, const float* g, float* dx, int B, int N, int D,
                 int F, int tanh_flavor, const Dropout& dp, int device, const void* const* ptrs,
                 void* const* grads, float* ws, cudaStream_t st) {
  auto sgu_bwd = pl.wide_sgu ? sgu_bwd_kernel<8, 4> : sgu_bwd_kernel<4, 2>;
  if (!pl.tok) M2M_TRY(prepare(sgu_bwd, pl.sgu_bwd_smem, device));
  M2M_TRY(prepare(vln_bwd_kernel, pl.vln_smem, device));
  M2M_TRY(prepare(ln_bwd_kernel<false>, pl.ln_smem, device));
  const int R = B * N, H = F / 2;
  auto q = [ptrs](int i) { return static_cast<const float*>(ptrs[i]); };
  const float* w_in = q(2);
  const float* w_out = q(8);
  float* const* gq = reinterpret_cast<float* const*>(grads);
  // xn = LN(x), dout = g m2; then pm = (xn W_in + b_in) m0 on the tensor cores
  ln_rows_kernel<<<ceil_div(R, kWarps), kThreads, 0, st>>>(x, q(0), q(1), ws + pl.xn, g,
                                                           ws + pl.dout, R, D, dp);
  M2M_TRY(cudaGetLastError());
  M2M_TRY(tc_gemm_wide(View{ws + pl.xn, D, 1}, View{w_in, F, 1}, ws + pl.act, R, F, D, D, 1, st,
                       EpiBiasMask{q(3), kMaskIn, F, dp}));
  // dgated = dout W_out^T (gmlp_kernel.py:77)
  M2M_TRY(tc_gemm_wide(View{ws + pl.dout, D, 1}, View{w_out, 1, D}, ws + pl.dg, R, H, D, D, 1,
                       st));
  vstats_kernel<true><<<ceil_div(R, kWarps), kThreads, 0, st>>>(ws + pl.act, ws + pl.vstats, R, F,
                                                                tanh_flavor);
  M2M_TRY(cudaGetLastError());
  if (pl.tok) {  // the large-N route
    const TokRow tr{N, H};
    const int T = B * H;  // rows of the token projection's layout
    M2M_TRY((launch_vt<true, false>(ws + pl.act, ws + pl.vstats, ptrs, ws + pl.vt, N, B, N, F,
                                    tanh_flavor, st)));
    // t' recomputed; the gate: gated, dpre's u half, dt
    const View vt{ws + pl.vt, N, 1}, dt{ws + pl.dtt, N, 1};
    M2M_TRY((tc_gemm_layout<4, 2, 2, 4, true, false, 0>(
        vt, View{q(6), N, 1}, ws + pl.dtt, T, N, N, N, 1, st,
        EpiGateBwdTc{tr, q(7), ws + pl.act, ws + pl.dg, ws + pl.gated, ws + pl.dpre, F,
                     tanh_flavor, dp},
        vec_ok(vt, true) && vec_ok(View{q(6), N, 1}, true))));
    // dv' = dt sgu_w^T (:71) to dpre's v half
    M2M_TRY((tc_gemm_layout<4, 2, 2, 4, true, true, 0>(
        dt, View{q(6), 1, N}, nullptr, T, N, N, N, 1, st, EpiDvTc{tr, ws + pl.dpre, F},
        vec_ok(dt, true) && vec_ok(View{q(6), 1, N}, false))));
    // d sgu_w = vt^T dt and d sgu_b = dt's column sums, slices of the rows
    M2M_TRY(tc_gemm_wide(View{ws + pl.vt, 1, N}, dt, ws + pl.p_sgu, N, N, T, pl.tslice,
                         pl.tsplit, st));
    ColJobs<1> tj = {};
    tj.job[0] = ColJob{ws + pl.dtt, N, N, ws + pl.p_sgb};
    col_slices_kernel<1><<<dim3(ceil_div(N, kThreads), pl.tsplit, 1), kThreads, 0, st>>>(
        tj, T, pl.tslice);
  } else {
    sgu_bwd<<<dim3(pl.nsplit, B), pl.wide_sgu ? 512 : 256, pl.sgu_bwd_smem, st>>>(
        ws + pl.act, ws + pl.dg, ws + pl.vstats, ws + pl.gated, ws + pl.dpre, ws + pl.p_sgu,
        sgu_params(ptrs), N, F, tanh_flavor, dp);
  }
  M2M_TRY(cudaGetLastError());
  vln_bwd_kernel<<<pl.tiles, kThreads, pl.vln_smem, st>>>(ws + pl.act, ws + pl.dpre, q(4),
                                                          ws + pl.p_vln, R, F, pl.rt, tanh_flavor,
                                                          dp);
  M2M_TRY(cudaGetLastError());
  // dxn = dpre W_in^T (:62), slices of F (summed by ln_bwd_kernel)
  M2M_TRY(tc_gemm_wide(View{ws + pl.dpre, F, 1}, View{w_in, 1, F}, ws + pl.dxnp, R, D, F,
                       pl.xslice, pl.xsplit, st));
  // dW_in = xn^T dpre, dW_out = gated^T dout: slices of the rows
  M2M_TRY(tc_gemm_wide(View{ws + pl.xn, 1, D}, View{ws + pl.dpre, F, 1}, ws + pl.p_win, D, F, R,
                       pl.wslice, pl.wsplit, st));
  M2M_TRY(tc_gemm_wide(View{ws + pl.gated, 1, H}, View{ws + pl.dout, D, 1}, ws + pl.p_wout, H, D,
                       R, pl.wslice, pl.wsplit, st));
  ColJobs<2> cj = {};
  cj.job[0] = ColJob{ws + pl.dpre, F, F, ws + pl.p_col};
  cj.job[1] = ColJob{ws + pl.dout, D, D, ws + pl.p_col + (size_t)pl.wsplit * F};
  col_slices_kernel<2><<<dim3(ceil_div(F > D ? F : D, kThreads), pl.wsplit, 2), kThreads, 0, st>>>(
      cj, R, pl.wslice);
  M2M_TRY(cudaGetLastError());
  // the LN backward over D plus the residual g (:61, :80), dxn's slices in order
  ln_bwd_kernel<false><<<pl.tiles, kThreads, pl.ln_smem, st>>>(
      x, ws + pl.dxnp, pl.xsplit, g, q(0), dx, ws + pl.p_ln, R, D, pl.rt, D);
  M2M_TRY(cudaGetLastError());
  const int NN = N * N;
  // the jobs but d sgu_w's and d sgu_b's, and the launch: the grid covers the
  // longest job (dW_in, or d sgu_w where N^2 > D*F)
  auto reduce = [&](auto& rj) {
    constexpr int kJobs = std::extent<decltype(rj.job)>::value;
    rj.job[0] = RedJob{ws + pl.p_ln, pl.tiles, 2 * D, gq[0], D, gq[1]};
    rj.job[1] = RedJob{ws + pl.p_vln, pl.tiles, 2 * H, gq[4], H, gq[5]};
    rj.job[3] = RedJob{ws + pl.p_win, pl.wsplit, D * F, gq[2], D * F, nullptr};
    rj.job[4] = RedJob{ws + pl.p_wout, pl.wsplit, H * D, gq[8], H * D, nullptr};
    rj.job[5] = RedJob{ws + pl.p_col, pl.wsplit, F, gq[3], F, nullptr};
    rj.job[6] = RedJob{ws + pl.p_col + (size_t)pl.wsplit * F, pl.wsplit, D, gq[9], D, nullptr};
    int longest = 0;
    for (const RedJob& j : rj.job) longest = j.P > longest ? j.P : longest;
    reduce_jobs_kernel<kJobs><<<dim3(ceil_div(longest, kThreads), kJobs), kThreads, 0, st>>>(rj);
    return (int)cudaGetLastError();
  };
  if (pl.tok) {  // d sgu_w's and d sgu_b's slices apart
    RedJobs<kRedJobs + 1> rj = {};
    rj.job[2] = RedJob{ws + pl.p_sgu, pl.tsplit, NN, gq[6], NN, nullptr};
    rj.job[kRedJobs] = RedJob{ws + pl.p_sgb, pl.tsplit, N, gq[7], N, nullptr};
    return reduce(rj);
  }
  RedJobs<kRedJobs> rj = {};
  rj.job[2] = RedJob{ws + pl.p_sgu, B * pl.nsplit, NN + N, gq[6], NN, gq[7]};
  return reduce(rj);
}

// K3b in bf16 compute: the same steps, its five products on the wgmma engine,
// dpre as three bf16 planes, the column sums folded into their producers
int gmlp_bwd_bf16(const Plan& pl, const float* x, const float* g, float* dx, int B, int N, int D,
                  int F, int tanh_flavor, const Dropout& dp, int device, const void* const* ptrs,
                  void* const* grads, float* ws, cudaStream_t st) {
  const int R = B * N, H = F / 2;
  auto sgu_bwd = pl.wide_sgu ? sgu_bwd_bf16_kernel<8, 4> : sgu_bwd_bf16_kernel<4, 2>;
  if (!pl.tok) M2M_TRY(prepare(sgu_bwd, pl.sgu_bwd_smem, device));
  auto vln_bwd = pl.vwarps == 8   ? vln_bwd_bf16_kernel<8>
                 : pl.vwarps == 4 ? vln_bwd_bf16_kernel<4>
                 : pl.vwarps == 2 ? vln_bwd_bf16_kernel<2>
                                  : vln_bwd_bf16_kernel<1>;
  M2M_TRY(prepare(vln_bwd, pl.vln_smem, device));
  M2M_TRY(prepare(ln_bwd_kernel<true>, pl.ln_smem, device));
  M2M_TRY(prepare(ln_rows_bf16_kernel, pl.rows_smem, device));
  auto q = [ptrs](int i) { return static_cast<const float*>(ptrs[i]); };
  auto bf = [ws](size_t at) { return reinterpret_cast<bf16_t*>(ws + at); };
  float* const* gq = reinterpret_cast<float* const*>(grads);
  const float scale = dp.on ? dp.scale : 1.f;  // dout's keep bits' scale, on the sums
  const size_t plane = (size_t)R * pl.Fp;
  bf16_t* dpre = bf(pl.dpre);
  bf16_t* const planes[kWgMaxTerms] = {dpre, dpre + plane, dpre + 2 * plane};
  // W_in, W_out and W_out^T rounded, rows padded
  int most = D * pl.Fp > H * pl.Dp ? D * pl.Fp : H * pl.Dp;
  most = most > D * pl.Hp ? most : D * pl.Hp;
  prep_weights_kernel<<<ceil_div(most, kThreads), kThreads, 0, st>>>(
      q(2), q(8), bf(pl.w_in_r), bf(pl.w_out_r), bf(pl.w_out_t), D, F, pl.Dp, pl.Fp, pl.Hp);
  M2M_TRY(cudaGetLastError());
  // xn = LN(x) and the dout operand, bf16; db_out's row-tile partials
  ln_rows_bf16_kernel<<<pl.tiles, kThreads, pl.rows_smem, st>>>(
      x, q(0), q(1), bf(pl.xn), pl.Dp, g, bf(pl.dout), ws + pl.p_bout, R, D, pl.rt, dp);
  M2M_TRY(cudaGetLastError());
  // pm = (xn W_in + b_in) m0, float32
  M2M_TRY(wg_product<64>(bf(pl.xn), pl.Dp, bf(pl.w_in_r), pl.Fp, nullptr, R, F, D, D, 1,
                         EpiInWg{q(3), ws + pl.act, F, 0, tanh_flavor, dp}, device, st));
  // dgated = bf16(dout W_out^T) (gmlp_kernel.py:77), in bf16
  M2M_TRY(wg_product<64>(bf(pl.dout), pl.Dp, bf(pl.w_out_t), pl.Hp, nullptr, R, pl.Hp, D, D, 1,
                         EpiDgWg{bf(pl.dg), H, scale}, device, st));
  vstats_kernel<true><<<ceil_div(R, kWarps), kThreads, 0, st>>>(ws + pl.act, ws + pl.vstats, R, F,
                                                                tanh_flavor);
  M2M_TRY(cudaGetLastError());
  if (pl.tok) {  // the large-N route
    const TokRow tr{N, H};
    const long long T = (long long)B * H;  // rows of the token projection's layout
    M2M_TRY((launch_vt<true, true>(ws + pl.act, ws + pl.vstats, ptrs, bf(pl.vt), pl.Np, B, N, F,
                                   tanh_flavor, st)));
    M2M_TRY(round_sgu_w(pl, ptrs, bf(pl.w_sgu_r), N, st));
    // t' recomputed; the gate: gated, dpre's u half, dt's bits
    M2M_TRY(wg_product<64>(bf(pl.vt), pl.Np, bf(pl.w_sgu_r), pl.Np, nullptr, T, N, N, N, 1,
                           EpiGateBwdWg{tr, q(7), ws + pl.act, bf(pl.dg), bf(pl.gated),
                                        bf(pl.dtt), DpreOut{dpre, plane, pl.Fp, nullptr}, F,
                                        pl.Hp, pl.Np, tanh_flavor, dp},
                           device, st));
    // db_in's u half: each sample's column sums of dpre's planes
    col_bf16_kernel<3><<<dim3(ceil_div(H, kThreads), B), kThreads, 0, st>>>(
        dpre, plane, H, pl.Fp, ws + pl.p_bin, R, N, 1.f);
    M2M_TRY(cudaGetLastError());
    const WgOperand dt_rows{{bf(pl.dtt)}, 1, T, N, pl.Np};
    {  // dv' = bf16(scale x dt sgu_w^T) (:71) to the hi plane's v half
      WgArgs a = {};
      M2M_TRY((make_job<true, true>(a.job[0], dt_rows,
                                    WgOperand{{bf(pl.w_sgu_r)}, 1, N, N, pl.Np}, nullptr, 1.f)));
      a.M = (int)T, a.N = N, a.K = N, a.kslice = N, a.slices = 1;
      M2M_TRY((wg_gemm<true, true, 1, 1, 1, kWgBN>(a, 1, EpiDvWg{tr, dpre, pl.Fp, scale}, device,
                                                    st)));
    }
    {  // d sgu_w = scale x vt^T dt, slices of the rows
      WgArgs a = {};
      M2M_TRY((make_job<false, false>(a.job[0], WgOperand{{bf(pl.vt)}, 1, T, N, pl.Np}, dt_rows,
                                      ws + pl.p_sgu, scale)));
      a.M = N, a.N = N, a.K = (int)T, a.kslice = pl.tslice, a.slices = pl.tsplit;
      M2M_TRY((wg_gemm<false, false, 1, 1, 1, kWgBN>(a, 1, EpiWgStore{}, device, st)));
    }
    // d sgu_b = scale x dt's column sums over the same slices
    col_bf16_kernel<1><<<dim3(ceil_div(N, kThreads), pl.tsplit), kThreads, 0, st>>>(
        bf(pl.dtt), 0, N, pl.Np, ws + pl.p_sgb, (int)T, pl.tslice, scale);
  } else {
    sgu_bwd<<<dim3(pl.nsplit, B), pl.wide_sgu ? 512 : 256, pl.sgu_bwd_smem, st>>>(
        ws + pl.act, bf(pl.dg), pl.Hp, ws + pl.vstats, bf(pl.gated), pl.Hp,
        DpreOut{dpre, plane, pl.Fp, ws + pl.p_bin}, ws + pl.p_sgu, sgu_params(ptrs), N, F,
        tanh_flavor, dp);
  }
  M2M_TRY(cudaGetLastError());
  vln_bwd<<<pl.tiles, 32 * pl.vwarps, pl.vln_smem, st>>>(
      ws + pl.act, DpreOut{dpre, plane, pl.Fp, ws + pl.p_bin + (size_t)B * H}, q(4),
      ws + pl.p_vln, R, F, pl.rt, tanh_flavor, dp);
  M2M_TRY(cudaGetLastError());
  const WgOperand dpre_rows{{planes[0], planes[1], planes[2]}, 3, R, F, pl.Fp};
  {  // dxn = dpre W_in^T (:62), three passes a stage, slices of F (summed by ln_bwd_kernel)
    WgArgs a = {};
    M2M_TRY((make_job<true, true>(a.job[0], dpre_rows, WgOperand{{bf(pl.w_in_r)}, 1, D, F, pl.Fp},
                                  ws + pl.dxnp, 1.f)));
    a.M = R, a.N = D, a.K = F, a.kslice = pl.xslice, a.slices = pl.xsplit;
    M2M_TRY((wg_gemm<true, true, 3, 1, 1, kWgBN>(a, 1, EpiWgStore{}, device, st)));
  }
  {  // dW_in = xn^T dpre, three passes a stage, slices of the rows
    WgArgs a = {};
    M2M_TRY((make_job<false, false>(a.job[0], WgOperand{{bf(pl.xn)}, 1, R, D, pl.Dp}, dpre_rows,
                                    ws + pl.p_win, 1.f)));
    a.M = D, a.N = F, a.K = R, a.kslice = pl.wslice, a.slices = pl.wsplit;
    M2M_TRY((wg_gemm<false, false, 1, 3, 1, kWgBN>(a, 1, EpiWgStore{}, device, st)));
  }
  {  // dW_out = gated^T dout x dout's scale, slices of the rows
    WgArgs a = {};
    M2M_TRY((make_job<false, false>(a.job[0], WgOperand{{bf(pl.gated)}, 1, R, H, pl.Hp},
                                    WgOperand{{bf(pl.dout)}, 1, R, D, pl.Dp}, ws + pl.p_wout,
                                    scale)));
    a.M = H, a.N = D, a.K = R, a.kslice = pl.vslice, a.slices = pl.vsplit;
    M2M_TRY((wg_gemm<false, false, 1, 1, 1, kWgBN>(a, 1, EpiWgStore{}, device, st)));
  }
  // the LN backward over D plus the residual g (:61, :80), dxn's slices in
  // order and rounded (the cotangent of LN1's bf16 output)
  ln_bwd_kernel<true><<<pl.tiles, kThreads, pl.ln_smem, st>>>(
      x, ws + pl.dxnp, pl.xsplit, g, q(0), dx, ws + pl.p_ln, R, D, pl.rt, D);
  M2M_TRY(cudaGetLastError());
  // every gradient but the biases' is rounded once its sum is complete
  constexpr int kBoth = kRnd0 | kRnd1;
  const int NN = N * N;
  // the jobs but d sgu_w's and d sgu_b's, and the launch; the row tiles'
  // partials are many (1584 at the fusion shape, batch 512): in runs
  auto reduce = [&](auto& rj) {
    constexpr int kJobs = std::extent<decltype(rj.job)>::value, kSplit = 8;
    rj.job[0] = RedJob{ws + pl.p_ln, pl.tiles, 2 * D, gq[0], D, gq[1], kBoth};
    rj.job[1] = RedJob{ws + pl.p_vln, pl.tiles, 2 * H, gq[4], H, gq[5], kBoth};
    rj.job[3] = RedJob{ws + pl.p_win, pl.wsplit, D * F, gq[2], D * F, nullptr, kRnd0};
    rj.job[4] = RedJob{ws + pl.p_wout, pl.vsplit, H * D, gq[8], H * D, nullptr, kRnd0};
    rj.job[5] = RedJob{ws + pl.p_bin, B, H, gq[3], H, nullptr};  // db_in, u half
    rj.job[6] = RedJob{ws + pl.p_bin + (size_t)B * H, pl.tiles, H, gq[3] + H, H, nullptr};  // v half
    rj.job[7] = RedJob{ws + pl.p_bout, pl.tiles, D, gq[9], D, nullptr};
    reduce_jobs_kernel<kJobs, kSplit><<<flat_grid(rj, kSplit), kThreads, 0, st>>>(rj);
    return (int)cudaGetLastError();
  };
  if (pl.tok) {  // d sgu_w's and d sgu_b's slices apart
    RedJobs<kRedJobsBf16 + 1> rj = {};
    rj.job[2] = RedJob{ws + pl.p_sgu, pl.tsplit, NN, gq[6], NN, nullptr, kRnd0};
    rj.job[kRedJobsBf16] = RedJob{ws + pl.p_sgb, pl.tsplit, N, gq[7], N, nullptr};
    return reduce(rj);
  }
  RedJobs<kRedJobsBf16> rj = {};
  rj.job[2] = RedJob{ws + pl.p_sgu, B * pl.nsplit, NN + N, gq[6], NN, gq[7], kRnd0};
  return reduce(rj);
}

}  // namespace

extern "C" {

// Workspace bytes of the gMLP forward (backward = 0) or backward in float32 or
// (bf16 = 1) bf16 compute (the wrapper allocates it); 0 for shapes the kernels
// do not take.
size_t m2m_gmlp_workspace_bytes(int B, int N, int D, int F, int backward, int bf16, int device) {
  Plan pl;
  if (check_args(B, N, D, F) || make_plan(B, N, D, F, bf16 != 0, device, pl)) return 0;
  return (backward ? pl.bwd_floats : pl.fwd_floats) * 4;
}

// Rows of the slices K3b sums its weight gradients over (dW_in, dW_out), 0
// for shapes the kernels do not take: what the 3xTF32 error is measured against.
int m2m_gmlp_row_slice(int B, int N, int D, int F, int device) {
  Plan pl;
  if (check_args(B, N, D, F) || make_plan(B, N, D, F, false, device, pl)) return 0;
  return pl.wslice;
}

// Rows of the tensor-core tile that tc_gemm_auto takes for an M x N output over
// ksplit slices on `device`: 128 (the wide tile) or 64; 0 on error.
int m2m_tc_tile_rows(int M, int N, int ksplit, int device) {
  DeviceInfo dev;
  if (M < 1 || N < 1 || ksplit < 1 || device_info(device, dev) != cudaSuccess) return 0;
  return tc_small_tile(M, N, ksplit, dev.sms) ? 64 : kTcBM;
}

// K3f: y = GatingMlpBlock(x), x and y (B, N, D) float32. ptrs: the 10
// parameters in GmlpBlockParams order (float32, JAX layout); keys/thresh/scale:
// dropout (4 stream keys of block 0, or keys == nullptr for none); bf16: bf16
// compute (the casts at the top of the file, the products on the wgmma
// engine); workspace: m2m_gmlp_workspace_bytes(..., 0, bf16, ...) bytes.
int m2m_gmlp_fwd(const float* x, float* y, int B, int N, int D, int F, int tanh_flavor,
                 const unsigned* keys, unsigned thresh, float scale, int bf16, int device,
                 const void* const* ptrs, void* workspace, void* stream) {
  if (check_args(B, N, D, F)) return -1;
  M2M_TRY(cudaSetDevice(device));
  Plan pl;
  const int code = make_plan(B, N, D, F, bf16 != 0, device, pl);
  if (code) return code;
  return (bf16 ? gmlp_fwd_bf16 : gmlp_fwd_f32)(
      pl, x, y, B, N, D, F, tanh_flavor, make_dropout(keys, 1, thresh, scale), device, ptrs,
      static_cast<float*>(workspace), static_cast<cudaStream_t>(stream));
}

// K3b: dx and the 10 parameter gradients (float32, GmlpBlockParams order) of
// one GatingMlpBlock at input x for output gradient g, the forward's masks
// regenerated from the same keys; bf16: bf16 compute; workspace:
// m2m_gmlp_workspace_bytes(..., 1, bf16, ...).
int m2m_gmlp_bwd(const float* x, const float* g, float* dx, int B, int N, int D, int F,
                 int tanh_flavor, const unsigned* keys, unsigned thresh, float scale, int bf16,
                 int device, const void* const* ptrs, void* const* grads, void* workspace,
                 void* stream) {
  if (check_args(B, N, D, F)) return -1;
  M2M_TRY(cudaSetDevice(device));
  Plan pl;
  const int code = make_plan(B, N, D, F, bf16 != 0, device, pl);
  if (code) return code;
  return (bf16 ? gmlp_bwd_bf16 : gmlp_bwd_f32)(
      pl, x, g, dx, B, N, D, F, tanh_flavor, make_dropout(keys, 1, thresh, scale), device, ptrs,
      grads, static_cast<float*>(workspace), static_cast<cudaStream_t>(stream));
}

}  // extern "C"
