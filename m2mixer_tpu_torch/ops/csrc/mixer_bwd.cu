// Fused MixerBlock / mixer-stack backward kernels for Hopper (sm_90a), float32.
//
// Replaces the TPU Pallas kernels of m2mixer_tpu/ops/mixer_kernel.py:
//   mixer_block_bwd  <- fused_mixer_block's _bwd_rule (_bwd_kernel: jax.vjp of _block_math)
//   mixer_stack_bwd  <- fused_mixer_stack's _stack_bwd_rule (_stack_bwd_kernel)
// Both return dx and every parameter gradient in float32, with the forward's
// dropout masks regenerated from the same keys (mixer_common.cuh).
//
// Design. The TPU kernel differentiates one batch tile in VMEM and sums the
// parameter gradients over a sequential grid. Here the tiles run in parallel,
// and per-tile partials of the channel-FF weight gradients would not fit
// (dW3 and dW4 are 3 MiB per block in float32, ~16 tiles at batch 32). So one
// block's backward is a short pipeline of kernels, each parallel over what it
// owns, none using float atomics (two runs give bit-identical gradients):
//   1. prefix (row tiles of whole samples): LN1, token FF, LN2 again from the
//      block input -> z, and da4 = g * m3, to device memory;
//   2. channel (64x64 tiles of rows x hidden units): a3 = z W3 + b3 and
//      dh2 = da4 W4^T -> h2 = gelu(a3) m2 and da3 = dh2 m2 gelu'(a3), both
//      (B*N) x C, to device memory;
//   3. dz = da3 W3^T (tiles of rows x D, the C sum split into slices whose
//      partials are added in slice order);
//   4. rows (row tiles of whole samples; the token mix couples a sample's N
//      tokens): LN2 backward, token FF backward, LN1 backward -> dx, and each
//      tile's partial sums of the small gradients (LN, w1, b1, w2, b2);
//   5. dW3 = z^T da3 and dW4 = h2^T da4: each CTA owns a 64x64 tile of the
//      weight and sweeps all B*N rows in order;
//   6. db3, db4 (column sums over the rows, in order) and the small gradients
//      (the tiles' partials, summed in tile order); these sums are
//      compensated (Kahan), since some of them are exactly zero.
// The stack runs the final LN's backward and then this pipeline block by
// block, last block first, on the block inputs the forward saved.
//
// What bounds it on the H100. Per block the channel FF's products are
// 8*B*N*D*C flops (dh2, dz, dW3, dW4) plus 2*B*N*D*C for the recomputed a3,
// all float32 on the CUDA cores (67 TFLOP/s), against a few MB of weights and
// activations: operations bound it at batch 512, launch latency at batch 32.
// The products here are simple shared-memory tiled SIMT loops (4x4 outputs per
// thread, no tensor cores, no TMA), several times off that bound (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mixer_common.cuh"
#include "tile_common.cuh"

namespace {

constexpr int kLnRows = 16;  // rows per CTA of the final LN's backward
constexpr int kMaxKSplit = 32;

// stage 2: over one 64x64 tile of (rows, hidden units), a3 = z W3 + b3 and
// dh2 = da4 W4^T, then h2 = gelu(a3) m2 and da3 = dh2 m2 gelu'(a3)
__global__ void __launch_bounds__(kThreads)
    channel_bwd_kernel(const float* __restrict__ z, const float* __restrict__ da4,
                       const float* __restrict__ w3, const float* __restrict__ b3,
                       const float* __restrict__ w4, float* __restrict__ h2,
                       float* __restrict__ da3, int R, int D, int C, int tanh_flavor,
                       const __grid_constant__ Dropout dp, int blk) {
  __shared__ float As[kTileK][kTile + kPad], Bs[kTileK][kTile + kPad];
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  float a[4][4] = {}, q[4][4] = {};
  gemm_tile(View{z, D, 1}, View{w3, C, 1}, R, C, 0, D, m0, n0, As, Bs, a);
  gemm_tile(View{da4, D, 1}, View{w4, 1, D}, R, C, 0, D, m0, n0, As, Bs, q);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + ty * 4 + i, c = n0 + tx * 4 + j;
      if (r < R && c < C) {
        const float v = a[i][j] + __ldg(b3 + c);
        const float m2 = keep(dp, blk, 2, (uint32_t)r * C + c);
        const size_t e = (size_t)r * C + c;
        h2[e] = gelu(v, tanh_flavor) * m2;
        da3[e] = q[i][j] * m2 * gelu_grad(v, tanh_flavor);
      }
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
__global__ void __launch_bounds__(kThreads)
    prefix_kernel(const float* __restrict__ x, const float* __restrict__ g, float* __restrict__ z,
                  float* __restrict__ da4, int B, int N, int T, int D, int tb, int tanh_flavor,
                  Small p, const __grid_constant__ Dropout dp, int blk) {
  extern __shared__ __align__(16) float sm[];
  const int s0 = blockIdx.x * tb, nb = min(tb, B - s0), R = nb * N;
  float* xs = sm;
  float* ys = xs + tb * N * D;
  float* tw = ys + tb * N * D;
  const size_t off = (size_t)s0 * N * D;
  for (int e = threadIdx.x; e < R * D; e += kThreads) xs[e] = x[off + e];
  load_token_weights<false>(tw, TokenPtrs{p.w1, p.b1, p.w2, p.b2}, N, T);
  __syncthreads();
  layer_norm_rows<false>(xs, ys, R, D, p.ln1_s, p.ln1_b);
  __syncthreads();
  token_mix<false>(ys, xs, nb, N, T, D, tw, tanh_flavor, dp, blk, s0);
  __syncthreads();
  layer_norm_rows<false>(xs, ys, R, D, p.ln2_s, p.ln2_b);
  __syncthreads();
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    z[off + e] = ys[e];
    da4[off + e] = g[off + e] * keep(dp, blk, 3, (uint32_t)(off + e));
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
// partials to part[blockIdx.x].
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

  for (int e = threadIdx.x; e < R * D; e += kThreads) xs[e] = x[off + e];
  load_token_weights<false>(tw, TokenPtrs{p.w1, p.b1, p.w2, p.b2}, N, T);
  __syncthreads();
  for (int r = warp; r < R; r += kThreads / 32) {  // LN1
    float mean, inv;
    row_stats(xs + r * D, D, mean, inv);
    if (lane == 0) {
      mean1[r] = mean;
      inv1[r] = inv;
    }
    for (int d = lane; d < D; d += 32)
      ys[r * D + d] = (xs[r * D + d] - mean) * inv * __ldg(p.ln1_s + d) + __ldg(p.ln1_b + d);
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
      const float h = gelu(a1, tanh_flavor) * keep(dp, blk, 0, col * T + j);
      c[j] = a1;
      c[T + j] = h;
#pragma unroll
      for (int n = 0; n < kMaxTokens; ++n)
        if (n < N) acc[n] += h * w2[j * N + n];
    }
#pragma unroll
    for (int n = 0; n < kMaxTokens; ++n)
      if (n < N)
        x1s[base + n * D] =
            xs[base + n * D] + (acc[n] + b2[n]) * keep(dp, blk, 1, col * N + n);
  }
  // dz: stage 3's slices summed in slice order
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    float v = 0.f;
    for (int k = 0; k < ksplit; ++k) v += dzp[k * rows_total + off + e];
    gs[e] = v;
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
  for (int e = threadIdx.x; e < R * D; e += kThreads) dys[e] = g[off + e];  // g, for a moment
  __syncthreads();
  ln_backward_rows(gs, dys, x1s, mean2, inv2, p.ln2_s, R, D);
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
      const float da1 = dh * keep(dp, blk, 0, col * T + j) * gelu_grad(c[j], tanh_flavor);
      c[j] = da1;
#pragma unroll
      for (int n = 0; n < kMaxTokens; ++n)
        if (n < N) dy[n] += da1 * w1[n * T + j];
    }
#pragma unroll
    for (int n = 0; n < kMaxTokens; ++n)
      if (n < N) dys[base + n * D] = dy[n];
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
  ln_backward_rows(dys, gs, xs, mean1, inv1, p.ln1_s, R, D);
  __syncthreads();
  for (int e = threadIdx.x; e < R * D; e += kThreads) dx[off + e] = dys[e];
}

// out[c] = sum over rows r (in order) of a[r, c]
__global__ void __launch_bounds__(kThreads)
    col_sum_kernel(const float* __restrict__ a, int R, int C, float* __restrict__ out) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  Kahan v;
  for (int r = 0; r < R; ++r) v.add(a[(size_t)r * C + c]);
  out[c] = v.s;
}

constexpr int kMaxSegs = 8;
struct Segs {
  float* out[kMaxSegs];
  int len[kMaxSegs];
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
      segs.out[i][p - base] = v.s;
      return;
    }
    base += segs.len[i];
  }
}

struct Plan {
  int tb;          // samples per row tile (stages 1 and 4)
  int tiles;       // row tiles
  int ksplit;      // slices of C in stage 3
  int kslice;      // hidden units per slice
  size_t prefix_smem, rows_smem;
  size_t ws_floats;  // workspace
  // workspace offsets (floats)
  size_t z, da4, h2, da3, dzp, part, ping;
};

int make_plan(int B, int N, int T, int D, int C, int n_blocks, int final_ln, int device,
              Plan& pl) {
  int limit = 0, sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  int tb = kThreads / D > 1 ? kThreads / D : 1;
  if (tb > B) tb = B;
  while (tb > 1 && rows_smem_floats(tb, N, T, D) * 4 > (size_t)limit) --tb;
  if (rows_smem_floats(tb, N, T, D) * 4 > (size_t)limit) return -1;
  pl.tb = tb;
  pl.tiles = (B + tb - 1) / tb;
  pl.rows_smem = rows_smem_floats(tb, N, T, D) * 4;
  pl.prefix_smem = (2 * (size_t)tb * N * D + 2 * (size_t)N * T + T + N) * 4;
  const size_t rows = (size_t)B * N;
  const int out_tiles = (int)((rows + kTile - 1) / kTile) * ((D + kTile - 1) / kTile);
  int ks = sms / out_tiles;
  ks = ks < 1 ? 1 : (ks > kMaxKSplit ? kMaxKSplit : ks);
  int kslice = (C + ks - 1) / ks;
  kslice = (kslice + kTileK - 1) / kTileK * kTileK;
  pl.kslice = kslice;
  pl.ksplit = (C + kslice - 1) / kslice;
  const size_t small = small_floats(N, T, D);
  const size_t ln_tiles = (rows + kLnRows - 1) / kLnRows;
  size_t part = pl.tiles * small;
  if (final_ln && ln_tiles * 2 * D > part) part = ln_tiles * 2 * D;
  size_t o = 0;
  pl.z = o, o += rows * D;
  pl.da4 = o, o += rows * D;
  pl.h2 = o, o += rows * C;
  pl.da3 = o, o += rows * C;
  pl.dzp = o, o += (size_t)pl.ksplit * rows * D;
  pl.part = o, o += part;
  pl.ping = o, o += (n_blocks > 1 || final_ln) ? 2 * rows * D : 0;
  pl.ws_floats = o;
  return 0;
}

int check_args(int B, int N, int T, int D, int C, int n_blocks) {
  if (B < 1 || N < 1 || N > kMaxTokens || T < 1 || D < 1 || C < 1) return -1;
  if (n_blocks < 1 || n_blocks > kMaxBlocks) return -1;
  if ((size_t)B * N * (C > D ? C : D) >= (1ull << 32) ||
      (size_t)B * D * (T > N ? T : N) >= (1ull << 32))
    return -1;  // the dropout masks count their elements in 32 bits
  return 0;
}

// one block's backward: x its input, g the gradient of its output; dx and the
// 12 parameter gradients (float32, MixerBlockParams order) out
int block_bwd(const Plan& pl, float* ws, const float* x, const float* g, float* dx,
              const void* const* q, void* const* gq, int B, int N, int T, int D, int C,
              int tanh_flavor, const Dropout& dp, int blk, cudaStream_t st) {
  const int R = B * N;
  const Small sp{static_cast<const float*>(q[0]), static_cast<const float*>(q[1]),
                 static_cast<const float*>(q[2]), static_cast<const float*>(q[3]),
                 static_cast<const float*>(q[4]), static_cast<const float*>(q[5]),
                 static_cast<const float*>(q[6]), static_cast<const float*>(q[7])};
  const float* w3 = static_cast<const float*>(q[8]);
  const float* b3 = static_cast<const float*>(q[9]);
  const float* w4 = static_cast<const float*>(q[10]);
  float* z = ws + pl.z;
  float* da4 = ws + pl.da4;
  float* h2 = ws + pl.h2;
  float* da3 = ws + pl.da3;
  float* dzp = ws + pl.dzp;
  float* part = ws + pl.part;
  const int rt = (R + kTile - 1) / kTile;

  prefix_kernel<<<pl.tiles, kThreads, pl.prefix_smem, st>>>(x, g, z, da4, B, N, T, D, pl.tb,
                                                            tanh_flavor, sp, dp, blk);
  M2M_TRY(cudaGetLastError());
  channel_bwd_kernel<<<dim3((C + kTile - 1) / kTile, rt), kThreads, 0, st>>>(
      z, da4, w3, b3, w4, h2, da3, R, D, C, tanh_flavor, dp, blk);
  M2M_TRY(cudaGetLastError());
  gemm_kernel<<<dim3((D + kTile - 1) / kTile, rt, pl.ksplit), kThreads, 0, st>>>(
      View{da3, C, 1}, View{w3, 1, C}, dzp, R, D, C, pl.kslice);
  M2M_TRY(cudaGetLastError());
  rows_bwd_kernel<<<pl.tiles, kThreads, pl.rows_smem, st>>>(x, g, dzp, pl.ksplit, dx, part, B, N,
                                                            T, D, pl.tb, tanh_flavor, sp, dp, blk);
  M2M_TRY(cudaGetLastError());
  // dW3 (D x C) = z^T da3, dW4 (C x D) = h2^T da4, over all rows in order
  gemm_kernel<<<dim3((C + kTile - 1) / kTile, (D + kTile - 1) / kTile, 1), kThreads, 0, st>>>(
      View{z, 1, D}, View{da3, C, 1}, static_cast<float*>(gq[8]), D, C, R, R);
  M2M_TRY(cudaGetLastError());
  gemm_kernel<<<dim3((D + kTile - 1) / kTile, (C + kTile - 1) / kTile, 1), kThreads, 0, st>>>(
      View{h2, 1, C}, View{da4, D, 1}, static_cast<float*>(gq[10]), C, D, R, R);
  M2M_TRY(cudaGetLastError());
  col_sum_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0, st>>>(da3, R, C,
                                                                     static_cast<float*>(gq[9]));
  M2M_TRY(cudaGetLastError());
  col_sum_kernel<<<(D + kThreads - 1) / kThreads, kThreads, 0, st>>>(da4, R, D,
                                                                     static_cast<float*>(gq[11]));
  M2M_TRY(cudaGetLastError());
  // the tiles' partials: ln1 (2D), w1, b1, w2, b2, ln2 (2D)
  Segs segs = {};
  const int lens[8] = {D, D, N * T, T, T * N, N, D, D};
  const int idx[8] = {0, 1, 2, 3, 4, 5, 6, 7};
  for (int i = 0; i < 8; ++i) {
    segs.out[i] = static_cast<float*>(gq[idx[i]]);
    segs.len[i] = lens[i];
  }
  segs.n = 8;
  const int P = small_floats(N, T, D);
  reduce_kernel<<<(P + kThreads - 1) / kThreads, kThreads, 0, st>>>(part, pl.tiles, P, segs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Workspace bytes mixer backward needs (the wrapper allocates it).
size_t m2m_mixer_bwd_workspace_bytes(int B, int N, int T, int D, int C, int n_blocks, int final_ln,
                                     int device) {
  Plan pl;
  if (check_args(B, N, T, D, C, n_blocks) || make_plan(B, N, T, D, C, n_blocks, final_ln, device, pl))
    return 0;
  return pl.ws_floats * 4;
}

// Backward of n_blocks MixerBlocks (+ the final LN when final_ln): saved holds the
// input of every block, (n_blocks + 1) slots of (B, N, D) float32 (the last: the
// output before the final LN), as mixer_stack_fwd writes them; for one block
// without a final LN, saved is just its input. g: the gradient of the output.
// ptrs: the parameters (12 per block, then ln scale and bias), grads: float32
// outputs of the same shapes; keys/thresh/scale: the forward's dropout (keys
// nullptr for none); workspace: m2m_mixer_bwd_workspace_bytes bytes.
int m2m_mixer_bwd(const float* saved, const float* g, float* dx, int B, int N, int T, int D,
                  int C, int n_blocks, int final_ln, int tanh_flavor, const unsigned* keys,
                  unsigned thresh, float scale, int device, const void* const* ptrs,
                  void* const* grads, void* workspace, void* stream) {
  if (check_args(B, N, T, D, C, n_blocks)) return -1;
  M2M_TRY(cudaSetDevice(device));
  Plan pl;
  int code = make_plan(B, N, T, D, C, n_blocks, final_ln, device, pl);
  if (code) return code;
  M2M_TRY(prepare(prefix_kernel, pl.prefix_smem));
  M2M_TRY(prepare(rows_bwd_kernel, pl.rows_smem));
  M2M_TRY(prepare(ln_bwd_kernel, ln_bwd_smem_bytes(kLnRows, D)));
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
    ln_bwd_kernel<<<blocks, kThreads, ln_bwd_smem_bytes(kLnRows, D), st>>>(
        saved + n_blocks * slot, g, 1, nullptr,
        static_cast<const float*>(ptrs[n_blocks * kParamsPerBlock]), out, ws + pl.part, rows, D,
        kLnRows);
    M2M_TRY(cudaGetLastError());
    Segs segs = {};
    segs.out[0] = static_cast<float*>(grads[n_blocks * kParamsPerBlock]);
    segs.out[1] = static_cast<float*>(grads[n_blocks * kParamsPerBlock + 1]);
    segs.len[0] = segs.len[1] = D;
    segs.n = 2;
    reduce_kernel<<<(2 * D + kThreads - 1) / kThreads, kThreads, 0, st>>>(ws + pl.part, blocks,
                                                                         2 * D, segs);
    M2M_TRY(cudaGetLastError());
    cur = out;
  }
  for (int k = n_blocks - 1; k >= 0; --k) {
    float* out = k == 0 ? dx : ping[k % 2];
    code = block_bwd(pl, ws, saved + k * slot, cur, out, ptrs + k * kParamsPerBlock,
                     grads + k * kParamsPerBlock, B, N, T, D, C, tanh_flavor, dp, k, st);
    if (code) return code;
    cur = out;
  }
  return 0;
}

}  // extern "C"
