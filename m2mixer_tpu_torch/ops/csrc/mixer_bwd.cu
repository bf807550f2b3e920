// Fused MixerBlock / mixer-stack backward kernels for Hopper (sm_90a), float32
// and bf16 compute.
//
// Replaces the TPU Pallas kernels of m2mixer_tpu/ops/mixer_kernel.py:
//   mixer_block_bwd  <- fused_mixer_block's _bwd_rule (_bwd_kernel: jax.vjp of _block_math)
//   mixer_stack_bwd  <- fused_mixer_stack's _stack_bwd_rule (_stack_bwd_kernel)
// Both return dx and every parameter gradient in float32, with the forward's
// dropout masks regenerated from the same keys (mixer_common.cuh).
//
// bf16 compute (compute_dtype=bfloat16) computes what JAX's AD of _block_math
// computes: the forward recomputed at its casts (x, w1..w4 and the LN
// parameters, the LN outputs, the GEMM operand h and h2, the residual stream x1
// and the block output rounded to bf16; the parameters arrive in float32, and
// stage 0 rounds w3 and w4 as it lays them out), and the transposes of those
// casts in the backward,
// each a rounding of a cotangent to bf16 (jax.make_jaxpr of the VJP lists them):
//   - g, the output's cotangent (the output is bf16 widened to float32);
//   - every product whose operand was cast to bf16 in the forward: dh2 =
//     da4 W4^T, dz = da3 W3^T, dh = da2 W2^T and dy = da1 W1^T, and the weight
//     gradients dW1, dW2, dW3 and dW4 (each summed over the whole batch first);
//   - each LN: its input gradient (the LN reads its bf16 input in float32),
//     its scale and bias gradients (summed first; the forward reads them as
//     bf16), and its scale is read rounded;
//   - the residual stream's sums, dx1 = g + LN2's input gradient and dx = dx1
//     + LN1's, are bf16 additions.
// The biases b1..b4 add in float32 and their gradients are not rounded; the
// float32 cotangents (da1, da2, da3, da4) are never rounded. JAX sums per-tile
// bf16-rounded weight gradients over its grid; these kernels round once, after
// their own sum over the batch. The products keep float32 sums, one operand of
// each a bf16 value. The channel FF's five run on the wgmma engine
// (wgmma_bf16.cuh: bf16 operands in the workspace, da4's dropout scale on the
// sums, da3 as three bf16 planes); the token FF's, at the L shapes, on
// tc_gemm, which drops the products with a bf16 operand's zero small half
// (2xTF32; both operands bf16: 1xTF32).
//
// Design. The TPU kernel differentiates one batch tile in VMEM and sums the
// parameter gradients over a sequential grid. Here the tiles run in parallel,
// and per-sample partials of the channel-FF weight gradients would not fit
// (dW3 and dW4 are 3 MiB per block in float32). So one block's backward is a
// short pipeline of kernels, each parallel over what it owns, none using
// float atomics (two runs give bit-identical gradients):
//   0. the channel FF's weights into the workspace, W3 as it is and W4
//      transposed, both D x Cp with Cp = C rounded up to whole 16-byte groups
//      and zeros in the pad columns (the fusion mixer's C = 3078 is not a
//      multiple of 4);
//   1. prefix (row tiles of whole samples): LN1, token FF, LN2 again from the
//      block input -> z, and da4 = g * m3, to device memory;
//   2. channel: a3 = z W3 + b3 into h2's buffer, then dh2 = da4 W4^T whose
//      epilogue reads a3 there and writes h2 = gelu(a3) m2 in place and
//      da3 = dh2 m2 gelu'(a3); both (B*N) x Cp, pad columns zero;
//   3. dz = da3 W3^T (the C sum split into slices whose partials are added in
//      slice order by stage 4);
//   4. rows (row tiles of whole samples; the token mix couples a sample's N
//      tokens): LN2 backward, token FF backward, LN1 backward -> dx, and each
//      tile's partial sums of the small gradients (LN, w1, b1, w2, b2);
//   5. dW3 = z^T da3 and dW4 = h2^T da4 over slices of the rows (at most
//      kMaxSliceRows a slice), the slices' partials summed in slice order;
//   6. db3, db4 (column sums over slices of the rows, the slices' partials
//      summed in slice order, as stage 5's) and the small gradients (the
//      tiles' partials, summed in tile order); these sums are compensated
//      (Kahan), since some of them are exactly zero.
// Above kMaxTokens tokens (the L config's 64 and 80) a sample no longer fits
// stages 1 and 4's row tiles, so the token half runs on token_ff.cuh's
// layouts: stage 1 is the forward's token pipeline again (keeping a1 for
// gelu'), and stage 4 becomes LN2's backward (ln_bwd_kernel) -> dx1, da2 =
// dx1^T m1 (a transpose), dh = da2 W2^T with da1 = dh m0 gelu'(a1) in its
// epilogue, dW2 = h^T da2 and dW1 = y^T da1 over slices of the B*D rows (at
// most kMaxSliceRows a slice), dy = (da1 W1^T)^T, and LN1's backward -> dx;
// the four products on the tensor cores, the partials summed in slice or
// tile order as the rest.
// The stack runs the final LN's backward and then this pipeline block by
// block, last block first, on the block inputs the forward saved.
//
// What bounds it on the H100. Per block the channel FF's products are
// 8*B*N*D*C flops (dh2, dz, dW3, dW4) plus 2*B*N*D*C for the recomputed a3,
// against a few MB of weights and activations: operations bound it at batch
// 512, launch latency at batch 32. The five products (stages 2, 3 and 5) run
// on the tensor cores in 3xTF32 (tile_common.cuh's tc_gemm: float32-accurate
// at a third of the TF32 rate); the two of stage 2 take the 64x64 tile where
// the wide one would leave SMs idle (batch 32). The rest is CUDA-core work on
// memory. In bf16 the same pipeline runs with the header's roundings, and its
// channel products on wgmma_bf16.cuh's engine (its header has their bound):
// stage 0 lays W3 and W4^T out in bf16 (Cp: C rounded up to 8), stage 1
// writes z and da4 in bf16, stage 2 is one launch (a3, then dh2 over the same
// tile; its epilogue writes h2 in bf16 and da3 as three bf16 planes), stages 3
// and 5 read those, and stage 5 computes dW4^T (the reduction transposes it).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mixer_common.cuh"
#include "tile_common.cuh"
#include "token_ff.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int kLnRows = 16;  // rows per CTA of the final LN's backward
constexpr int kTr = 32;      // stage 0's transpose tile

// the channel FF's operands (w3p, w4t, z, da4, h2) lie in the workspace as
// token_ff.cuh's ChanT: float32 for tc_gemm, bf16 for the wgmma engine

// stage 0: w3p[d, c] = w3[d, c], w4t[d, c] = w4[c, d] for c < C, zeros for
// C <= c < Cp; a kTr x kTr tile a CTA, W4 transposed through shared memory.
// kBF16: both in bf16, the copies JAX's kernels read
template <bool kBF16>
__global__ void __launch_bounds__(kTr * 8)
    pad_weights_kernel(const float* __restrict__ w3, const float* __restrict__ w4,
                       ChanT<kBF16>* __restrict__ w3p, ChanT<kBF16>* __restrict__ w4t, int D,
                       int C, int Cp) {
  __shared__ float tile[kTr][kTr + 1];
  const int c0 = blockIdx.x * kTr, d0 = blockIdx.y * kTr;
  const int tx = threadIdx.x % kTr, ty = threadIdx.x / kTr;
  for (int i = ty; i < kTr; i += 8) {  // W4 rows c0 + i, columns d0 + tx
    const int c = c0 + i, d = d0 + tx;
    tile[i][tx] = c < C && d < D ? rd<kBF16>(__ldg(w4 + (size_t)c * D + d)) : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < kTr; i += 8) {  // rows d0 + i, columns c0 + tx of both
    const int d = d0 + i, c = c0 + tx;
    if (d >= D || c >= Cp) continue;
    w3p[(size_t)d * Cp + c] = to_operand<ChanT<kBF16>>(c < C ? __ldg(w3 + (size_t)d * C + c) : 0.f);
    w4t[(size_t)d * Cp + c] = to_operand<ChanT<kBF16>>(tile[tx][i]);
  }
}

// stage 2's epilogues over (rows) x Cp: a3 = v + b3[c], zero in the pad
struct EpiA3 {
  const float* b3;
  int C;
  __device__ __forceinline__ float operator()(int, int c, float v) const {
    return c < C ? v + __ldg(b3 + c) : 0.f;
  }
};
// v = dh2: reads a3 from h2[r, c] (ld Cp) and writes h2 = gelu(a3) m2 there;
// returns da3 = dh2 m2 gelu'(a3), zero in the pad. Each (r, c) is one
// thread's, in this launch and in the a3 launch before it (float32 compute;
// bf16's is EpiChannelWg).
struct EpiChannelBwd {
  float* h2;
  int C, Cp, tanh_flavor, blk;
  Dropout dp;
  __device__ __forceinline__ float operator()(int r, int c, float v) const {
    if (c >= C) return 0.f;
    float* h = h2 + (size_t)r * Cp + c;
    const float a3 = *h;
    const float m2 = keep(dp, blk, 2, (uint32_t)r * C + c);
    *h = gelu(a3, tanh_flavor) * m2;
    return v * m2 * gelu_grad(a3, tanh_flavor);
  }
};

// The bf16 route's stage 2 epilogue (wgmma_bf16.cuh, two products in
// sequence): columns c and c + 1 of row r with a3's sums (before b3) and
// dh2's (before da4's dropout scale) -> h2 = rd(gelu(a3) m2) and da3 =
// rd(dh2) m2 gelu'(a3) as its three bf16 planes (hi, mid, lo); zeros in the
// pad columns C <= c < Cp. The engine writes them to h2 and the planes.
struct EpiChannelWg {
  static constexpr int kOuts = 4;  // h2, then da3's planes
  const float* b3;
  __nv_bfloat16* h2;   // (B*N) x Cp
  __nv_bfloat16* da3;  // three planes of (B*N) x Cp
  size_t plane;
  int C, tanh_flavor, blk;
  float scale;
  Dropout dp;
  __device__ __forceinline__ __nv_bfloat16* dst(int k) const {
    return k ? da3 + (k - 1) * plane : h2;
  }
  __device__ __forceinline__ void operator()(int r, int c, float a0, float a1, float d0,
                                             float d1, __nv_bfloat162 (&out)[kOuts]) const {
    float h[2], t[3][2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cc = c + e;
      float hv = 0.f, x = 0.f;
      if (cc < C) {
        const float a3 = (e ? a1 : a0) + __ldg(b3 + cc);
        const float m2 = keep(dp, blk, 2, (uint32_t)r * C + cc);
        hv = rd<true>(gelu(a3, tanh_flavor) * m2);
        x = rd<true>((e ? d1 : d0) * scale) * m2 * gelu_grad(a3, tanh_flavor);
      }
      h[e] = hv;
      t[0][e] = rd<true>(x);
      t[1][e] = rd<true>(x - t[0][e]);
      t[2][e] = rd<true>(x - t[0][e] - t[1][e]);
    }
    out[0] = __floats2bfloat162_rn(h[0], h[1]);
#pragma unroll
    for (int k = 0; k < 3; ++k) out[k + 1] = __floats2bfloat162_rn(t[k][0], t[k][1]);
  }
};

// The bf16 route's stage 6: job blockIdx.z 0 writes p3[y * C + c] = the sum
// over rows [y * rslice, (y + 1) * rslice) of da3[r, c] = hi + mid + lo (its
// planes, row stride Cp), job 1 p4[y * D + d] = scale x the sum of da4[r, d]
// (rd(g) times the keep bit); rows in order (db3, db4's slices).
__global__ void __launch_bounds__(kThreads)
    col_bf16_kernel(const __nv_bfloat16* __restrict__ da3, size_t plane,
                    const __nv_bfloat16* __restrict__ da4, float scale, float* __restrict__ p3,
                    float* __restrict__ p4, int R, int C, int Cp, int D, int rslice) {
  const int job = blockIdx.z, width = job ? D : C;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= width) return;
  const int r0 = blockIdx.y * rslice, r1 = min(R, r0 + rslice);
  Kahan v;
  if (job == 0) {
    for (int r = r0; r < r1; ++r) {
      const size_t e = (size_t)r * Cp + c;
      v.add(__bfloat162float(da3[e]) + __bfloat162float(da3[plane + e]) +
            __bfloat162float(da3[2 * plane + e]));
    }
    p3[(size_t)blockIdx.y * C + c] = v.s;
  } else {
    for (int r = r0; r < r1; ++r) v.add(__bfloat162float(da4[(size_t)r * D + c]));
    p4[(size_t)blockIdx.y * D + c] = scale * v.s;
  }
}

// the 8 small parameters of a block (everything but w3, b3, w4, b4)
struct Small {
  const float* ln1_s;
  const float* ln1_b;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  const float* ln2_s;
  const float* ln2_b;
};

// stage 1: LN1 -> token FF -> LN2 of the tile's rows again: z and da4 = g m3
// (kBF16: at the forward's casts, and g rounded to bf16; both stored in bf16,
// da4 as rd(g) times m3's keep bit, token_ff.cuh's da4_operand)
template <bool kBF16>
__global__ void __launch_bounds__(kThreads)
    prefix_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  ChanT<kBF16>* __restrict__ z, ChanT<kBF16>* __restrict__ da4, int B, int N,
                  int T, int D, int tb, int tanh_flavor,
                  Small p, const __grid_constant__ Dropout dp, int blk) {
  extern __shared__ __align__(16) float sm[];
  const int s0 = blockIdx.x * tb, nb = min(tb, B - s0), R = nb * N;
  float* xs = sm;
  float* ys = xs + tb * N * D;
  float* tw = ys + tb * N * D;
  const size_t off = (size_t)s0 * N * D;
  for (int e = threadIdx.x; e < R * D; e += kThreads) xs[e] = rd<kBF16>(x[off + e]);
  load_token_weights<kBF16>(tw, TokenPtrs{p.w1, p.b1, p.w2, p.b2}, N, T);
  __syncthreads();
  layer_norm_rows<kBF16>(xs, ys, R, D, p.ln1_s, p.ln1_b);
  __syncthreads();
  token_mix<kBF16>(ys, xs, nb, N, T, D, tw, tanh_flavor, dp, blk, s0);
  __syncthreads();
  layer_norm_rows<kBF16>(xs, ys, R, D, p.ln2_s, p.ln2_b);
  __syncthreads();
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    z[off + e] = to_operand<ChanT<kBF16>>(ys[e]);
    da4[off + e] =
        da4_operand<kBF16, ChanT<kBF16>>(g[off + e], keep(dp, blk, 3, (uint32_t)(off + e)));
  }
}

// floats of stage 4's shared memory for tiles of tb samples
size_t rows_smem_floats(int tb, int N, int T, int D) {
  const size_t R = (size_t)tb * N;
  return 5 * R * D + 4 * R + 2 * (size_t)N * T + T + N + (size_t)tb * D * (2 * T + N);
}

// floats of one tile's small-gradient partials: ln1 (2D), w1, b1, w2, b2, ln2 (2D)
__host__ __device__ int small_floats(int N, int T, int D) { return 4 * D + 2 * N * T + T + N; }

// stage 4: the rest of the block's backward on a tile of tb whole samples.
// dz (the sum of stage 3's slices) -> LN2 backward (+ g) = dx1 -> token FF
// backward -> dy -> LN1 backward (+ dx1) = dx; the tile's small-gradient
// partials to part[blockIdx.x]. kBF16: the forward again at its casts, and
// dz, dh, dy, the LN input gradients and the residual sums rounded to bf16.
template <bool kBF16>
__global__ void __launch_bounds__(kThreads)
    rows_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ dzp, int ksplit, float* __restrict__ dx,
                    float* __restrict__ part, int B, int N, int T, int D, int tb, int tanh_flavor,
                    Small p, const __grid_constant__ Dropout dp, int blk) {
  extern __shared__ __align__(16) float sm[];
  const int s0 = blockIdx.x * tb, nb = min(tb, B - s0), R = nb * N;
  const int cap = tb * N * D;
  float* xs = sm;          // x
  float* ys = xs + cap;    // LN1 output y
  float* x1s = ys + cap;   // x1 = x + token FF
  float* gs = x1s + cap;   // dz, then dx1
  float* dys = gs + cap;   // dy
  float* st = dys + cap;   // mean1, inv1, mean2, inv2 (tb * N each)
  float* mean1 = st;
  float* inv1 = st + tb * N;
  float* mean2 = st + 2 * tb * N;
  float* inv2 = st + 3 * tb * N;
  float* tw = st + 4 * tb * N;  // w1, b1, w2, b2
  float* cb = tw + 2 * N * T + T + N;  // per (sample, d) column: a1 -> da1 (T), h (T), da2 (N)
  const int cw = 2 * T + N;
  const float* w1 = tw;
  const float* b1 = w1 + N * T;
  const float* w2 = b1 + T;
  const float* b2 = w2 + T * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t off = (size_t)s0 * N * D;
  const size_t rows_total = (size_t)B * N * D;
  float* my_part = part + (size_t)blockIdx.x * small_floats(N, T, D);

  for (int e = threadIdx.x; e < R * D; e += kThreads) xs[e] = rd<kBF16>(x[off + e]);
  load_token_weights<kBF16>(tw, TokenPtrs{p.w1, p.b1, p.w2, p.b2}, N, T);
  __syncthreads();
  for (int r = warp; r < R; r += kThreads / 32) {  // LN1
    float mean, inv;
    row_stats(xs + r * D, D, mean, inv);
    if (lane == 0) {
      mean1[r] = mean;
      inv1[r] = inv;
    }
    for (int d = lane; d < D; d += 32)
      ys[r * D + d] = rd<kBF16>((xs[r * D + d] - mean) * inv * rd<kBF16>(__ldg(p.ln1_s + d)) +
                                rd<kBF16>(__ldg(p.ln1_b + d)));
  }
  __syncthreads();
  // token FF forward again, keeping a1 and h per column
  for (int item = threadIdx.x; item < nb * D; item += kThreads) {
    const int s = item / D, d = item - s * D;
    const int base = s * N * D + d;
    const uint32_t col = (uint32_t)(s0 + s) * D + d;
    float* c = cb + (size_t)item * cw;
    float in[kMaxTokens], acc[kMaxTokens];
#pragma unroll
    for (int n = 0; n < kMaxTokens; ++n) {
      in[n] = n < N ? ys[base + n * D] : 0.f;
      acc[n] = 0.f;
    }
    for (int j = 0; j < T; ++j) {
      float a1 = b1[j];
#pragma unroll
      for (int n = 0; n < kMaxTokens; ++n)
        if (n < N) a1 += in[n] * w1[n * T + j];
      const float h = rd<kBF16>(gelu(a1, tanh_flavor) * keep(dp, blk, 0, col * T + j));
      c[j] = a1;
      c[T + j] = h;
#pragma unroll
      for (int n = 0; n < kMaxTokens; ++n)
        if (n < N) acc[n] += h * w2[j * N + n];
    }
#pragma unroll
    for (int n = 0; n < kMaxTokens; ++n)
      if (n < N)
        x1s[base + n * D] = rd<kBF16>(
            xs[base + n * D] + rd<kBF16>((acc[n] + b2[n]) * keep(dp, blk, 1, col * N + n)));
  }
  // dz: stage 3's slices summed in slice order
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    float v = 0.f;
    for (int k = 0; k < ksplit; ++k) v += dzp[k * rows_total + off + e];
    gs[e] = rd<kBF16>(v);
  }
  __syncthreads();
  for (int r = warp; r < R; r += kThreads / 32) {  // LN2 statistics
    float mean, inv;
    row_stats(x1s + r * D, D, mean, inv);
    if (lane == 0) {
      mean2[r] = mean;
      inv2[r] = inv;
    }
  }
  __syncthreads();
  // LN2's parameter gradients from dz, then dx1 = g + LN2 backward (in place in gs)
  ln_param_grads(gs, x1s, mean2, inv2, R, D, my_part + 2 * D + 2 * N * T + T + N);
  for (int e = threadIdx.x; e < R * D; e += kThreads)
    dys[e] = rd<kBF16>(g[off + e]);  // g, for a moment
  __syncthreads();
  ln_backward_rows<kBF16>(gs, dys, x1s, mean2, inv2, p.ln2_s, R, D);
  __syncthreads();
  // token FF backward per column: da2 = dt m1, da1 = (da2 w2^T) m0 gelu'(a1), dy = da1 w1^T
  for (int item = threadIdx.x; item < nb * D; item += kThreads) {
    const int s = item / D, d = item - s * D;
    const int base = s * N * D + d;
    const uint32_t col = (uint32_t)(s0 + s) * D + d;
    float* c = cb + (size_t)item * cw;
    float da2[kMaxTokens], dy[kMaxTokens];
#pragma unroll
    for (int n = 0; n < kMaxTokens; ++n) {
      da2[n] = n < N ? gs[base + n * D] * keep(dp, blk, 1, col * N + n) : 0.f;
      dy[n] = 0.f;
      if (n < N) c[2 * T + n] = da2[n];
    }
    for (int j = 0; j < T; ++j) {
      float dh = 0.f;
#pragma unroll
      for (int n = 0; n < kMaxTokens; ++n)
        if (n < N) dh += da2[n] * w2[j * N + n];
      const float da1 =
          rd<kBF16>(dh) * keep(dp, blk, 0, col * T + j) * gelu_grad(c[j], tanh_flavor);
      c[j] = da1;
#pragma unroll
      for (int n = 0; n < kMaxTokens; ++n)
        if (n < N) dy[n] += da1 * w1[n * T + j];
    }
#pragma unroll
    for (int n = 0; n < kMaxTokens; ++n)
      if (n < N) dys[base + n * D] = rd<kBF16>(dy[n]);
  }
  __syncthreads();
  // the token FF's weight gradients over the tile's columns, in column order
  const int cols = nb * D;
  float* pw1 = my_part + 2 * D;
  float* pb1 = pw1 + N * T;
  float* pw2 = pb1 + T;
  float* pb2 = pw2 + T * N;
  for (int o = threadIdx.x; o < N * T; o += kThreads) {
    const int n = o / T, j = o - n * T;  // dW1[n, j] = sum y[n] da1[j]
    Kahan v;
    for (int it = 0; it < cols; ++it) {
      const int s = it / D, d = it - s * D;
      v.add(ys[s * N * D + n * D + d] * cb[(size_t)it * cw + j]);
    }
    pw1[o] = v.s;
  }
  for (int j = threadIdx.x; j < T; j += kThreads) {
    Kahan v;
    for (int it = 0; it < cols; ++it) v.add(cb[(size_t)it * cw + j]);
    pb1[j] = v.s;
  }
  for (int o = threadIdx.x; o < T * N; o += kThreads) {
    const int j = o / N, n = o - j * N;  // dW2[j, n] = sum h[j] da2[n]
    Kahan v;
    for (int it = 0; it < cols; ++it)
      v.add(cb[(size_t)it * cw + T + j] * cb[(size_t)it * cw + 2 * T + n]);
    pw2[o] = v.s;
  }
  for (int n = threadIdx.x; n < N; n += kThreads) {
    Kahan v;
    for (int it = 0; it < cols; ++it) v.add(cb[(size_t)it * cw + 2 * T + n]);
    pb2[n] = v.s;
  }
  // LN1's parameter gradients from dy, then dx = dx1 + LN1 backward
  ln_param_grads(dys, xs, mean1, inv1, R, D, my_part);
  __syncthreads();
  ln_backward_rows<kBF16>(dys, gs, xs, mean1, inv1, p.ln1_s, R, D);
  __syncthreads();
  for (int e = threadIdx.x; e < R * D; e += kThreads) dx[off + e] = dys[e];
}

constexpr int kMaxSegs = 8;
struct Segs {
  float* out[kMaxSegs];
  int len[kMaxSegs];
  int rnd[kMaxSegs];  // round the segment's sums to bf16 (a bf16 cast's transpose)
  int n;
};

// sum the tiles' partials (tiles x P, in tile order) and scatter them to the outputs
__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const float* __restrict__ part, int tiles, int P, Segs segs) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  Kahan v;
  for (int t = 0; t < tiles; ++t) v.add(part[(size_t)t * P + p]);
  int base = 0;
  for (int i = 0; i < segs.n; ++i) {
    if (p < base + segs.len[i]) {
      segs.out[i][p - base] = segs.rnd[i] ? rd<true>(v.s) : v.s;
      return;
    }
    base += segs.len[i];
  }
}

struct Plan {
  int bf16;        // bf16 compute: the channel products on the wgmma engine, their
                   // operands in bf16
  int device;
  int sms;         // the card's SMs (the tile rule of stage 2's products)
  int reg;         // 1: stages 1 and 4 on row tiles of whole samples (N <= kMaxTokens,
                   // and one sample's rows fit them); 0: token_ff.cuh's pipeline and its
                   // transposes
  int tb;          // samples per row tile (stages 1 and 4, register route)
  int tiles;       // row tiles
  int nc;          // tokens per row tile (token pipeline)
  int ln_tiles;    // CTAs of kLnRows rows of an LN backward (token pipeline)
  int Cp;          // C rounded up to whole 16-byte groups (of float32, or of bf16 in
                   // bf16 compute): the row stride of h2, da3, W3 and W4^T
  int ksplit;      // slices of C in stage 3
  int kslice;      // hidden units per slice
  int wsplit;      // slices of the rows in stage 5's products
  int wslice;      // rows per slice
  int csplit;      // slices of the rows in stage 6's column sums
  int cslice;      // rows per slice
  int tsplit, tslice;    // the token weight gradients' slices of the B*D rows
  int tcsplit, tcslice;  // db1 and db2's column sums: slices of the B*D rows
  size_t prefix_smem, rows_smem;
  size_t ws_floats;  // workspace
  // workspace offsets (floats, each a multiple of 4: 16-byte aligned); in bf16
  // compute w3p, w4t, z, da4 and h2 hold bf16, da3 its three bf16 planes
  size_t w3p, w4t, z, da4, h2, da3, dzp, p_w3, p_w4, p_col, part, ping;
  // the token pipeline's: rounded w1 and w2 (bf16), x1, LN1 out transposed, h,
  // a1, da1, the down product's output then dy transposed, da2, dx1, dy, and
  // the partials of both LNs' parameters, dW1, dW2, db1 and db2
  size_t twr, x1, yt, ht, a1, da1, tt, da2, dx1, dy, p_ln1, p_ln2, p_w1, p_w2, p_tcol;
};

// column sums over R rows: slices for two CTAs an SM of the widest job (cols
// columns), at least 16 rows a slice, at most kMaxRowSplit slices
void col_plan(long long R, int cols, int sms, int& slice, int& split) {
  int cs = ceil_div(2 * sms, ceil_div(cols, kThreads));
  const int max_cs = ceil_div(R, 16);
  cs = cs > kMaxRowSplit ? kMaxRowSplit : cs;
  cs = cs > max_cs ? max_cs : cs;
  slice = ceil_div(R, cs);
  split = ceil_div(R, slice);
}

int make_plan(int B, int N, int T, int D, int C, int n_blocks, int final_ln, int bf16,
              int device, Plan& pl) {
  DeviceInfo dev;
  const cudaError_t err = device_info(device, dev);
  if (err != cudaSuccess) return err;
  const int sms = dev.sms;
  pl.bf16 = bf16;
  pl.device = device;
  pl.sms = sms;
  auto prefix_bytes = [=](int tb) {
    return (2 * (size_t)tb * N * D + 2 * (size_t)N * T + T + N) * 4;
  };
  pl.reg = N <= kMaxTokens && rows_smem_floats(1, N, T, D) * 4 <= (size_t)dev.smem_optin &&
           prefix_bytes(1) <= (size_t)dev.smem_optin;
  const long long R = (long long)B * N;
  const size_t rows = (size_t)R, cols = (size_t)B * D;
  pl.ln_tiles = ceil_div(R, kLnRows);
  if ((!pl.reg || final_ln) && ln_bwd_smem_bytes(kLnRows, D) > (size_t)dev.smem_optin) return -1;
  if (pl.reg) {
    int tb = kThreads / D > 1 ? kThreads / D : 1;
    if (tb > B) tb = B;
    while (tb > 1 && rows_smem_floats(tb, N, T, D) * 4 > (size_t)dev.smem_optin) --tb;
    if (rows_smem_floats(tb, N, T, D) * 4 > (size_t)dev.smem_optin) return -1;
    pl.tb = tb;
    pl.tiles = ceil_div(B, tb);
    pl.rows_smem = rows_smem_floats(tb, N, T, D) * 4;
    pl.prefix_smem = prefix_bytes(tb);
    pl.nc = 0;
    pl.tsplit = pl.tslice = pl.tcsplit = pl.tcslice = 0;
  } else {
    if (cols > (size_t)kTcBM * 65535 || B > 65535)
      return -1;  // the token products' row tiles, the row kernels' grid y
    pl.tb = pl.tiles = 0;
    pl.rows_smem = pl.prefix_smem = 0;
    pl.nc = tok_tile_tokens(N, D, dev.smem_optin);
    if (!pl.nc) return -1;
    // dW1 (N x T) and dW2 (T x N): the larger tile count of the two, slices of the B*D rows
    const int t1 = ceil_div(N, kTcBM) * ceil_div(T, kTcBN), t2 = ceil_div(T, kTcBM) * ceil_div(N, kTcBN);
    row_slices((long long)cols, t1 > t2 ? t1 : t2, sms, pl.tslice, pl.tsplit);
    col_plan((long long)cols, T > N ? T : N, sms, pl.tcslice, pl.tcsplit);
  }
  if (bf16) {
    if (D % 8) return -1;  // z and da4's bf16 rows: whole 16-byte groups for TMA
    pl.Cp = (C + 7) / 8 * 8;
    // dz = da3 W3^T: 128 x 128 tiles x slices of C, about a CTA an SM
    wg_slices(C, (long long)ceil_div(R, kWgBM) * ceil_div(D, kWgBN), sms, 1, pl.kslice,
              pl.ksplit);
    // dW3 and dW4^T (D x C each): slices of the rows, about two CTAs an SM
    wg_slices(R, 2LL * ceil_div(D, kWgBM) * ceil_div(C, kWgBN), sms, 2, pl.wslice, pl.wsplit);
  } else {
    pl.Cp = (C + 3) / 4 * 4;
    // dz = da3 W3^T: (rows x D) tiles x slices of C
    fill_slices(C, ceil_div(R, kTcBM) * ceil_div(D, kTcBN), sms, pl.kslice, pl.ksplit);
    // dW3, dW4: dW3's few tiles x slices of the rows
    row_slices(R, ceil_div(D, kTcBM) * ceil_div(C, kTcBN), sms, pl.wslice, pl.wsplit);
  }
  // db3, db4: a slice is one thread's serial sum
  col_plan(R, C, sms, pl.cslice, pl.csplit);
  size_t part = pl.reg ? (size_t)pl.tiles * small_floats(N, T, D) : 0;
  if (final_ln && (size_t)pl.ln_tiles * 2 * D > part) part = (size_t)pl.ln_tiles * 2 * D;
  const size_t tok = pl.reg ? 0 : 1;  // the token pipeline's buffers, or none
  size_t o = 0;
  auto take = [&o](size_t& at, size_t floats) { at = o, o += (floats + 3) / 4 * 4; };
  // the channel operands: bf16 ones take half a float each
  auto chan = [bf16](size_t n) { return bf16 ? (n + 1) / 2 : n; };
  take(pl.w3p, chan((size_t)D * pl.Cp));
  take(pl.w4t, chan((size_t)D * pl.Cp));
  take(pl.z, chan(rows * D));
  take(pl.da4, chan(rows * D));
  take(pl.h2, chan(rows * pl.Cp));
  take(pl.da3, (bf16 ? 3 : 1) * chan(rows * pl.Cp));
  take(pl.dzp, (size_t)pl.ksplit * rows * D);
  take(pl.p_w3, (size_t)pl.wsplit * D * C);
  take(pl.p_w4, (size_t)pl.wsplit * C * D);
  take(pl.p_col, (size_t)pl.csplit * (C + D));
  take(pl.part, part);
  take(pl.ping, (n_blocks > 1 || final_ln) ? 2 * rows * D : 0);
  take(pl.twr, tok * 2 * N * T);
  take(pl.x1, tok * rows * D);
  take(pl.yt, tok * cols * N);
  take(pl.ht, tok * cols * T);
  take(pl.a1, tok * cols * T);
  take(pl.da1, tok * cols * T);
  take(pl.tt, tok * cols * N);
  take(pl.da2, tok * cols * N);
  take(pl.dx1, tok * rows * D);
  take(pl.dy, tok * rows * D);
  take(pl.p_ln1, tok * pl.ln_tiles * 2 * D);
  take(pl.p_ln2, tok * pl.ln_tiles * 2 * D);
  take(pl.p_w1, tok * pl.tsplit * N * T);
  take(pl.p_w2, tok * pl.tsplit * T * N);
  take(pl.p_tcol, tok * pl.tcsplit * (T + N));
  pl.ws_floats = o;
  return 0;
}

int check_args(int B, int N, int T, int D, int C, int n_blocks) {
  if (B < 1 || N < 1 || T < 1 || D < 1 || C < 1) return -1;
  if (n_blocks < 1 || n_blocks > kMaxBlocks) return -1;
  if ((size_t)B * N * (C > D ? C : D) >= (1ull << 32) ||
      (size_t)B * D * (T > N ? T : N) >= (1ull << 32))
    return -1;  // the dropout masks count their elements in 32 bits
  if ((size_t)B * N > (size_t)kTcBM * 65535 || C > kTcBM * 65535)
    return -1;  // the products' row tiles (grid y)
  return 0;
}

constexpr int kTokJobs = 6;  // the token pipeline's reductions: LN1, LN2, dW1, dW2, db1, db2

// Stage 4 above kMaxTokens tokens, on token_ff.cuh's layouts (stage 1 left x1,
// a1 and h there): LN2 backward -> dx1; da2 = dx1^T m1 (B*D, N); da1 = (da2
// W2^T) m0 gelu'(a1); dW2 = h^T da2, dW1 = y^T da1 (slices of the B*D rows);
// dy = (da1 W1^T)^T; LN1 backward -> dx; the partials of db1, db2 and both
// LNs' parameters. kBF16: the roundings of rows_bwd_kernel, at the same points.
template <bool kBF16>
int token_backward(const Plan& pl, float* ws, const float* x, const float* g, float* dx,
                   const Small& sp, const float* w1, const float* w2, int B, int N, int T, int D,
                   int tanh_flavor, const Dropout& dp, int blk, cudaStream_t st) {
  constexpr int kA = kBF16 ? kExactA : 0, kB = kBF16 ? kExactB : 0;
  const int R = B * N, cols = B * D;
  const size_t lsm = ln_bwd_smem_bytes(kLnRows, D);
  float* dx1 = ws + pl.dx1;
  float* da2 = ws + pl.da2;
  float* da1 = ws + pl.da1;
  float* dyt = ws + pl.tt;  // the forward's tt is spent
  float* dy = ws + pl.dy;
  // dx1 = g + LN2's backward of dz (stage 3's slices, summed in slice order)
  ln_bwd_kernel<kBF16><<<pl.ln_tiles, kThreads, lsm, st>>>(
      ws + pl.x1, ws + pl.dzp, pl.ksplit, g, sp.ln2_s, dx1, ws + pl.p_ln2, R, D, kLnRows);
  M2M_TRY(cudaGetLastError());
  M2M_TRY(launch_transpose<kBF16>(dx1, da2, B, N, D, 1, dp, blk, st));
  M2M_TRY(tc_gemm_wide<kB>(View{da2, N, 1}, View{w2, 1, N}, da1, cols, T, N, N, 1, st,
                           EpiTokenBwd<kBF16>{ws + pl.a1, T, tanh_flavor, blk, dp}));
  M2M_TRY(tc_gemm_wide<kA>(View{ws + pl.ht, 1, T}, View{da2, N, 1}, ws + pl.p_w2, T, N, cols,
                           pl.tslice, pl.tsplit, st));
  M2M_TRY(tc_gemm_wide<kA>(View{ws + pl.yt, 1, N}, View{da1, T, 1}, ws + pl.p_w1, N, T, cols,
                           pl.tslice, pl.tsplit, st));
  M2M_TRY(tc_gemm_wide<kB>(View{da1, T, 1}, View{w1, 1, T}, dyt, cols, N, T, T, 1, st));
  M2M_TRY(launch_transpose<kBF16>(dyt, dy, B, D, N, 0, dp, blk, st));
  // dx = dx1 + LN1's backward of dy, on the block input
  ln_bwd_kernel<kBF16><<<pl.ln_tiles, kThreads, lsm, st>>>(x, dy, 1, dx1, sp.ln1_s, dx,
                                                           ws + pl.p_ln1, R, D, kLnRows);
  M2M_TRY(cudaGetLastError());
  ColJobs<2> cj = {};
  cj.job[0] = ColJob{da1, T, T, ws + pl.p_tcol};
  cj.job[1] = ColJob{da2, N, N, ws + pl.p_tcol + (size_t)pl.tcsplit * T};
  col_slices_kernel<2><<<dim3(ceil_div(T > N ? T : N, kThreads), pl.tcsplit, 2), kThreads, 0,
                          st>>>(cj, cols, pl.tcslice);
  return (int)cudaGetLastError();
}

// The bf16 route's channel products on the wgmma engine (wgmma_bf16.cuh):
// stage 2, a3 = z W3 and dh2 = da4 W4^T in one launch whose epilogue writes h2
// and da3's planes; stage 3, dz = da3 W3^T (three passes a stage, slices of C)
cudaError_t channel_bf16(const Plan& pl, float* ws, const float* b3, int B, int N, int D, int C,
                         int tanh_flavor, const Dropout& dp, int blk, cudaStream_t st) {
  const long long R = (long long)B * N, Cp = pl.Cp;
  const size_t plane = (size_t)R * Cp;
  const auto* z = reinterpret_cast<const __nv_bfloat16*>(ws + pl.z);
  const auto* da4 = reinterpret_cast<const __nv_bfloat16*>(ws + pl.da4);
  const auto* w3p = reinterpret_cast<const __nv_bfloat16*>(ws + pl.w3p);
  const auto* w4t = reinterpret_cast<const __nv_bfloat16*>(ws + pl.w4t);
  auto* h2 = reinterpret_cast<__nv_bfloat16*>(ws + pl.h2);
  auto* da3 = reinterpret_cast<__nv_bfloat16*>(ws + pl.da3);
  const float scale = dp.on ? dp.scale : 1.f;
  cudaError_t e;
  {  // a3 then dh2 over each 128 x 128 tile of (B*N) x Cp, depth D
    WgArgs a = {};
    const WgOperand rows_z{{z}, 1, R, D, D}, rows_da4{{da4}, 1, R, D, D};
    if ((e = make_job<true, false>(a.job[0], rows_z, WgOperand{{w3p}, 1, D, Cp, Cp}, nullptr,
                                   1.f)) != cudaSuccess ||
        (e = make_job<true, false>(a.job[1], rows_da4, WgOperand{{w4t}, 1, D, Cp, Cp}, nullptr,
                                   1.f)) != cudaSuccess)
      return e;
    a.M = (int)R, a.N = (int)Cp, a.K = D, a.kslice = D, a.slices = 1;
    e = wg_gemm<true, false, 1, 1, 2, 64>(
        a, 1, EpiChannelWg{b3, h2, da3, plane, C, tanh_flavor, blk, scale, dp},
        pl.device, st);
    if (e != cudaSuccess) return e;
  }
  // dz (B*N x D) = sum over the planes of da3_t W3^T, into stage 3's slices
  WgArgs a = {};
  const WgOperand planes{{da3, da3 + plane, da3 + 2 * plane}, 3, R, C, Cp};
  if ((e = make_job<true, true>(a.job[0], planes, WgOperand{{w3p}, 1, D, C, Cp}, ws + pl.dzp,
                                1.f)) != cudaSuccess)
    return e;
  a.M = (int)R, a.N = D, a.K = C, a.kslice = pl.kslice, a.slices = pl.ksplit;
  return wg_gemm<true, true, 3, 1, 1, kWgBN>(a, 1, EpiWgStore{}, pl.device, st);
}

// The bf16 route's stage 5 and stage 6's column sums: dW3 = z^T da3 (three
// passes) and dW4^T = da4^T h2 (x da4's dropout scale), D x C each, over
// slices of the rows in one launch; db3 and db4's slices
cudaError_t weight_grads_bf16(const Plan& pl, float* ws, int B, int N, int D, int C,
                              const Dropout& dp, cudaStream_t st) {
  const long long R = (long long)B * N, Cp = pl.Cp;
  const size_t plane = (size_t)R * Cp;
  const auto* z = reinterpret_cast<const __nv_bfloat16*>(ws + pl.z);
  const auto* da4 = reinterpret_cast<const __nv_bfloat16*>(ws + pl.da4);
  const auto* h2 = reinterpret_cast<const __nv_bfloat16*>(ws + pl.h2);
  const auto* da3 = reinterpret_cast<const __nv_bfloat16*>(ws + pl.da3);
  const float scale = dp.on ? dp.scale : 1.f;
  WgArgs a = {};
  cudaError_t e;
  if ((e = make_job<false, false>(a.job[0], WgOperand{{z}, 1, R, D, D},
                                  WgOperand{{da3, da3 + plane, da3 + 2 * plane}, 3, R, C, Cp},
                                  ws + pl.p_w3, 1.f)) != cudaSuccess ||
      (e = make_job<false, false>(a.job[1], WgOperand{{da4}, 1, R, D, D},
                                  WgOperand{{h2}, 1, R, C, Cp}, ws + pl.p_w4, scale)) !=
          cudaSuccess)
    return e;
  a.M = D, a.N = C, a.K = (int)R, a.kslice = pl.wslice, a.slices = pl.wsplit;
  if ((e = wg_gemm<false, false, 1, 3, 1, kWgBN>(a, 2, EpiWgStore{}, pl.device, st)) != cudaSuccess)
    return e;
  col_bf16_kernel<<<dim3(ceil_div(C > D ? C : D, kThreads), pl.csplit, 2), kThreads, 0, st>>>(
      da3, plane, da4, scale, ws + pl.p_col, ws + pl.p_col + (size_t)pl.csplit * C, (int)R, C,
      (int)Cp, D, pl.cslice);
  return cudaGetLastError();
}

// one block's backward: x its input, g the gradient of its output; dx and the
// 12 parameter gradients (float32, MixerBlockParams order) out; kBF16: bf16
// compute (the header's cast points), the channel products on the wgmma engine
template <bool kBF16>
int block_bwd(const Plan& pl, float* ws, const float* x, const float* g, float* dx,
              const void* const* q, void* const* gq, int B, int N, int T, int D, int C,
              int tanh_flavor, const Dropout& dp, int blk, cudaStream_t st) {
  const int R = B * N, Cp = pl.Cp;
  const Small sp{static_cast<const float*>(q[0]), static_cast<const float*>(q[1]),
                 static_cast<const float*>(q[2]), static_cast<const float*>(q[3]),
                 static_cast<const float*>(q[4]), static_cast<const float*>(q[5]),
                 static_cast<const float*>(q[6]), static_cast<const float*>(q[7])};
  const float* w3 = static_cast<const float*>(q[8]);
  const float* b3 = static_cast<const float*>(q[9]);
  const float* w4 = static_cast<const float*>(q[10]);
  float* const* gf = reinterpret_cast<float* const*>(gq);
  using CT = ChanT<kBF16>;
  CT* w3p = reinterpret_cast<CT*>(ws + pl.w3p);
  CT* w4t = reinterpret_cast<CT*>(ws + pl.w4t);
  CT* z = reinterpret_cast<CT*>(ws + pl.z);
  CT* da4 = reinterpret_cast<CT*>(ws + pl.da4);
  float* dzp = ws + pl.dzp;
  float* part = ws + pl.part;

  pad_weights_kernel<kBF16><<<dim3(ceil_div(Cp, kTr), ceil_div(D, kTr)), kTr * 8, 0, st>>>(
      w3, w4, w3p, w4t, D, C, Cp);
  M2M_TRY(cudaGetLastError());
  // the token weights the token pipeline's products read (rounded copies in bf16)
  const float* w1 = sp.w1;
  const float* w2 = sp.w2;
  if (pl.reg) {
    prefix_kernel<kBF16><<<pl.tiles, kThreads, pl.prefix_smem, st>>>(
        x, g, z, da4, B, N, T, D, pl.tb, tanh_flavor, sp, dp, blk);
    M2M_TRY(cudaGetLastError());
  } else {
    if (kBF16) {
      M2M_TRY(round_token_weights(sp.w1, sp.w2, ws + pl.twr, N * T, st));
      w1 = ws + pl.twr;
      w2 = ws + pl.twr + N * T;
    }
    // stage 1 on the token pipeline: the forward again from the block input,
    // keeping a1, with da4 = g m3
    const TokenBufs tb{ws + pl.yt, ws + pl.ht, ws + pl.tt, ws + pl.a1};
    M2M_TRY_INT(token_forward<kBF16>(x, nullptr, 0, nullptr, ws + pl.x1, z, nullptr, tb, sp.ln1_s,
                                     sp.ln1_b, w1, sp.b1, w2, sp.b2, sp.ln2_s, sp.ln2_b, g, da4, B,
                                     N, T, D, pl.nc, pl.sms, tanh_flavor, dp, blk, st));
  }
  if constexpr (kBF16) {
    M2M_TRY(channel_bf16(pl, ws, b3, B, N, D, C, tanh_flavor, dp, blk, st));
  } else {
    float* h2 = ws + pl.h2;
    float* da3 = ws + pl.da3;
    // stage 2: a3 into h2's buffer, then dh2 with the epilogue that finishes h2 and da3
    M2M_TRY(tc_gemm_auto(View{z, D, 1}, View{w3p, Cp, 1}, h2, R, Cp, D, pl.sms, st,
                         EpiA3{b3, C}));
    M2M_TRY(tc_gemm_auto(View{da4, D, 1}, View{w4t, Cp, 1}, da3, R, Cp, D, pl.sms, st,
                         EpiChannelBwd{h2, C, Cp, tanh_flavor, blk, dp}));
    // stage 3: dz = da3 W3^T, slices of C
    M2M_TRY(tc_gemm_wide(View{da3, Cp, 1}, View{w3p, 1, Cp}, dzp, R, D, C, pl.kslice, pl.ksplit,
                         st));
  }
  if (pl.reg) {
    rows_bwd_kernel<kBF16><<<pl.tiles, kThreads, pl.rows_smem, st>>>(
        x, g, dzp, pl.ksplit, dx, part, B, N, T, D, pl.tb, tanh_flavor, sp, dp, blk);
    M2M_TRY(cudaGetLastError());
  } else {
    M2M_TRY_INT(token_backward<kBF16>(pl, ws, x, g, dx, sp, w1, w2, B, N, T, D, tanh_flavor, dp, blk,
                                  st));
  }
  if constexpr (kBF16) {
    M2M_TRY(weight_grads_bf16(pl, ws, B, N, D, C, dp, st));
  } else {
    float* h2 = ws + pl.h2;
    float* da3 = ws + pl.da3;
    // stage 5: dW3 (D x C) = z^T da3, dW4 (C x D) = h2^T da4, slices of the rows
    M2M_TRY(tc_gemm_wide(View{z, 1, D}, View{da3, Cp, 1}, ws + pl.p_w3, D, C, R, pl.wslice,
                         pl.wsplit, st));
    M2M_TRY(tc_gemm_wide(View{h2, 1, Cp}, View{da4, D, 1}, ws + pl.p_w4, C, D, R, pl.wslice,
                         pl.wsplit, st));
    // stage 6: db3, db4 over slices of the rows
    ColJobs<2> cj = {};
    cj.job[0] = ColJob{da3, C, Cp, ws + pl.p_col};
    cj.job[1] = ColJob{da4, D, D, ws + pl.p_col + (size_t)pl.csplit * C};
    col_slices_kernel<2><<<dim3(ceil_div(C > D ? C : D, kThreads), pl.csplit, 2), kThreads, 0,
                            st>>>(cj, R, pl.cslice);
    M2M_TRY(cudaGetLastError());
  }
  // dW3, dW4, db3, db4: the row slices' partials in slice order (bf16: dW4's
  // partials are dW4^T, transposed as they are summed)
  constexpr int kRnd = kBF16 ? kRnd0 | kRnd1 : 0;
  RedJobs<kTokJobs + 4> rj = {};
  rj.job[0] = RedJob{ws + pl.p_w3, pl.wsplit, D * C, gf[8], D * C, nullptr, kRnd};
  rj.job[1] = RedJob{ws + pl.p_w4, pl.wsplit, C * D, gf[10], C * D, nullptr, kRnd, kBF16 ? D : 0};
  rj.job[2] = RedJob{ws + pl.p_col, pl.csplit, C, gf[9], C, nullptr, 0};
  rj.job[3] = RedJob{ws + pl.p_col + (size_t)pl.csplit * C, pl.csplit, D, gf[11], D, nullptr, 0};
  int jobs = 4;
  if (pl.reg) {
    // the tiles' partials: ln1 (2D), w1, b1, w2, b2, ln2 (2D); in bf16 all but the
    // biases b1 and b2 are rounded
    Segs segs = {};
    const int lens[8] = {D, D, N * T, T, T * N, N, D, D};
    for (int i = 0; i < 8; ++i) {
      segs.out[i] = gf[i];
      segs.len[i] = lens[i];
      segs.rnd[i] = kBF16 && i != 3 && i != 5;
    }
    segs.n = 8;
    const int P = small_floats(N, T, D);
    reduce_kernel<<<ceil_div(P, kThreads), kThreads, 0, st>>>(part, pl.tiles, P, segs);
    M2M_TRY(cudaGetLastError());
  } else {
    // the token pipeline's partials: both LNs' (scale and bias, rounded in bf16),
    // dW1 and dW2 (rounded in bf16), db1 and db2
    rj.job[4] = RedJob{ws + pl.p_ln1, pl.ln_tiles, 2 * D, gf[0], D, gf[1], kRnd};
    rj.job[5] = RedJob{ws + pl.p_ln2, pl.ln_tiles, 2 * D, gf[6], D, gf[7], kRnd};
    rj.job[6] = RedJob{ws + pl.p_w1, pl.tsplit, N * T, gf[2], N * T, nullptr, kRnd};
    rj.job[7] = RedJob{ws + pl.p_w2, pl.tsplit, T * N, gf[4], T * N, nullptr, kRnd};
    rj.job[8] = RedJob{ws + pl.p_tcol, pl.tcsplit, T, gf[3], T, nullptr, 0};
    rj.job[9] = RedJob{ws + pl.p_tcol + (size_t)pl.tcsplit * T, pl.tcsplit, N, gf[5], N, nullptr,
                       0};
    jobs += kTokJobs;
  }
  reduce_jobs_kernel<kTokJobs + 4><<<dim3(ceil_div(D * C > N * T ? D * C : N * T, kThreads), jobs),
                                     kThreads, 0, st>>>(rj);
  return (int)cudaGetLastError();
}

template <bool kBF16>
int mixer_bwd(const float* saved, const float* g, float* dx, int B, int N, int T, int D, int C,
              int n_blocks, int final_ln, int tanh_flavor, const unsigned* keys, unsigned thresh,
              float scale, int device, const void* const* ptrs, void* const* grads,
              void* workspace, void* stream) {
  if (check_args(B, N, T, D, C, n_blocks)) return -1;
  M2M_TRY(cudaSetDevice(device));
  Plan pl;
  int code = make_plan(B, N, T, D, C, n_blocks, final_ln, kBF16, device, pl);
  if (code) return code;
  if (pl.reg) {
    M2M_TRY(prepare(prefix_kernel<kBF16>, pl.prefix_smem, device));
    M2M_TRY(prepare(rows_bwd_kernel<kBF16>, pl.rows_smem, device));
  } else {
    M2M_TRY((prepare_token_kernels<kBF16, ChanT<kBF16>>(pl.nc, D, device)));
  }
  if (!pl.reg || final_ln) M2M_TRY(prepare(ln_bwd_kernel<kBF16>, ln_bwd_smem_bytes(kLnRows, D), device));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout dp = make_dropout(keys, n_blocks, thresh, scale);
  float* ws = static_cast<float*>(workspace);
  const size_t slot = (size_t)B * N * D;
  float* ping[2] = {ws + pl.ping, ws + pl.ping + slot};
  const float* cur = g;
  if (final_ln) {
    const int rows = B * N, blocks = (rows + kLnRows - 1) / kLnRows;
    float* out = n_blocks > 0 ? ping[n_blocks % 2] : dx;
    // the stack's final LN (no residual): kLnRows rows per CTA
    ln_bwd_kernel<kBF16><<<blocks, kThreads, ln_bwd_smem_bytes(kLnRows, D), st>>>(
        saved + n_blocks * slot, g, 1, nullptr,
        static_cast<const float*>(ptrs[n_blocks * kParamsPerBlock]), out, ws + pl.part, rows, D,
        kLnRows);
    M2M_TRY(cudaGetLastError());
    Segs segs = {};
    segs.out[0] = static_cast<float*>(grads[n_blocks * kParamsPerBlock]);
    segs.out[1] = static_cast<float*>(grads[n_blocks * kParamsPerBlock + 1]);
    segs.len[0] = segs.len[1] = D;
    segs.rnd[0] = segs.rnd[1] = kBF16;
    segs.n = 2;
    reduce_kernel<<<(2 * D + kThreads - 1) / kThreads, kThreads, 0, st>>>(ws + pl.part, blocks,
                                                                         2 * D, segs);
    M2M_TRY(cudaGetLastError());
    cur = out;
  }
  for (int k = n_blocks - 1; k >= 0; --k) {
    float* out = k == 0 ? dx : ping[k % 2];
    code = block_bwd<kBF16>(pl, ws, saved + k * slot, cur, out, ptrs + k * kParamsPerBlock,
                            grads + k * kParamsPerBlock, B, N, T, D, C, tanh_flavor, dp, k, st);
    if (code) return code;
    cur = out;
  }
  return 0;
}

}  // namespace

extern "C" {

// Workspace bytes mixer backward needs (the wrapper allocates it); bf16: the
// compute dtype is bfloat16 (the channel operands stored in bf16).
size_t m2m_mixer_bwd_workspace_bytes(int B, int N, int T, int D, int C, int n_blocks, int final_ln,
                                     int bf16, int device) {
  Plan pl;
  if (check_args(B, N, T, D, C, n_blocks) ||
      make_plan(B, N, T, D, C, n_blocks, final_ln, bf16 != 0, device, pl))
    return 0;
  return pl.ws_floats * 4;
}

// 1 if the backward runs the token FF on token_ff.cuh's pipeline (above
// kMaxTokens tokens, or where a sample's rows do not fit stages 1 and 4's
// tiles), 0 if on row tiles in registers, -1 for shapes the kernels do not take.
int m2m_mixer_bwd_token_ff(int B, int N, int T, int D, int C, int device) {
  Plan pl;
  if (check_args(B, N, T, D, C, 1) || make_plan(B, N, T, D, C, 1, 0, 0, device, pl)) return -1;
  return !pl.reg;
}

// Rows of the slices K1b/K2b sum dW1 and dW2 over on the token pipeline (slices
// of the B*D rows), 0 on the register route or for shapes the kernels do not
// take: what the 3xTF32 error of the token weight gradients is measured against.
int m2m_mixer_token_row_slice(int B, int N, int T, int D, int C, int device) {
  Plan pl;
  if (check_args(B, N, T, D, C, 1) || make_plan(B, N, T, D, C, 1, 0, 0, device, pl)) return 0;
  return pl.reg ? 0 : pl.tslice;
}

// Rows of the slices K1b/K2b sum dW3 and dW4 over, 0 for shapes the kernels
// do not take: what the 3xTF32 error is measured against.
int m2m_mixer_row_slice(int B, int N, int T, int D, int C, int device) {
  Plan pl;
  if (check_args(B, N, T, D, C, 1) || make_plan(B, N, T, D, C, 1, 0, 0, device, pl)) return 0;
  return pl.wslice;
}

// Backward of n_blocks MixerBlocks (+ the final LN when final_ln): saved holds the
// input of every block, (n_blocks + 1) slots of (B, N, D) float32 (the last: the
// output before the final LN), as mixer_stack_fwd writes them; for one block
// without a final LN, saved is just its input. g: the gradient of the output.
// ptrs: the parameters, float32 (12 per block, then ln scale and bias), grads:
// float32 outputs of the same shapes; keys/thresh/scale: the forward's dropout
// (keys nullptr for none); bf16: the compute dtype is bfloat16 (the header's
// cast points; w3 and w4 are rounded as stage 0 lays them out); workspace:
// m2m_mixer_bwd_workspace_bytes bytes.
int m2m_mixer_bwd(const float* saved, const float* g, float* dx, int B, int N, int T, int D,
                  int C, int n_blocks, int final_ln, int tanh_flavor, const unsigned* keys,
                  unsigned thresh, float scale, int bf16, int device, const void* const* ptrs,
                  void* const* grads, void* workspace, void* stream) {
  return (bf16 ? mixer_bwd<true> : mixer_bwd<false>)(saved, g, dx, B, N, T, D, C, n_blocks,
                                                      final_ln, tanh_flavor, keys, thresh, scale,
                                                      device, ptrs, grads, workspace, stream);
}

// The bf16 routes' product engine alone (wgmma_bf16.cuh), for the tests and
// chip_smoke.py's error record: out (M x N float32, row-major) = the sum over
// the planes of A_t B_t, the whole depth K in one slice. a[t] and b[t] are bf16
// row-major matrices (row strides lda, ldb: multiples of 8): A is M x K
// (a_k = 1: K-major, the layout of a3's, dh2's and dz's A) or K x M (a_k = 0:
// MN-major, the weight gradients'); B is N x K (b_k = 1: dz's W3) or K x N
// (b_k = 0: a3's and dh2's weights, the weight gradients' B). terms_a or
// terms_b (1-3) planes of the split operand, the other 1; the layouts the
// routes run: (a_k, b_k) = (1, 0), (1, 1) and (0, 0). tile_n: the output
// tile's columns, 128, or 64 for (1, 0) with one plane each (the forwards'
// products, K3b's in-projection and dgated: three CTAs an SM).
int m2m_wg_product(int a_k, int b_k, int terms_a, int terms_b, int M, int N, int K, int tile_n,
                   const void* const* a, long long lda, const void* const* b, long long ldb,
                   float* out, int device, void* stream) {
  if (M < 1 || N < 1 || K < 1 || terms_a < 1 || terms_b < 1 || (terms_a > 1 && terms_b > 1) ||
      terms_a > (a_k && b_k ? kWgMaxTerms : 1) || terms_b > (a_k || b_k ? 1 : kWgMaxTerms) ||
      (a_k == 0 && b_k == 1) || (tile_n != kWgBN && tile_n != 64) ||
      (tile_n == 64 && !(a_k && !b_k)))
    return -1;
  M2M_TRY(cudaSetDevice(device));
  WgOperand oa{{}, terms_a, a_k ? M : K, a_k ? K : M, lda};
  WgOperand ob{{}, terms_b, b_k ? N : K, b_k ? K : N, ldb};
  for (int t = 0; t < terms_a; ++t) oa.p[t] = static_cast<const __nv_bfloat16*>(a[t]);
  for (int t = 0; t < terms_b; ++t) ob.p[t] = static_cast<const __nv_bfloat16*>(b[t]);
  WgArgs args = {};
  args.M = M, args.N = N, args.K = K, args.kslice = K, args.slices = 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_k && !b_k) {
    M2M_TRY((make_job<true, false>(args.job[0], oa, ob, out, 1.f)));
    if (tile_n == 64) return wg_gemm<true, false, 1, 1, 1, 64>(args, 1, EpiWgStore{}, device, st);
    return wg_gemm<true, false, 1, 1, 1, kWgBN>(args, 1, EpiWgStore{}, device, st);
  }
  if (a_k) {
    M2M_TRY((make_job<true, true>(args.job[0], oa, ob, out, 1.f)));
    return wg_gemm<true, true, 3, 1, 1, kWgBN>(args, 1, EpiWgStore{}, device, st);
  }
  M2M_TRY((make_job<false, false>(args.job[0], oa, ob, out, 1.f)));
  return wg_gemm<false, false, 1, 3, 1, kWgBN>(args, 1, EpiWgStore{}, device, st);
}

}  // extern "C"
