// Fused gMLP block forward (K3f) and backward (K3b) kernels for Hopper (sm_90a), float32.
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
// Design. The TPU kernel keeps a batch tile's (tile_b*N, F) intermediates in
// VMEM. The spatial gating unit couples a sample's N tokens (the token
// projection) and a token's F/2 v-channels (LN(v)), and one sample's float32
// (N, F) intermediate is 304 KB at N = 99, above the 227 KB of shared memory a
// CTA may use. So the block is a short pipeline of kernels through device
// memory, each parallel over what it owns:
//   forward, 4 launches:
//     1. rows: xn = LN(x), a warp per row;
//     2. in:   h = gelu((xn W_in + b_in) m0), 64x64 tiles of (rows, F);
//     3. sgu:  per (sample, share of the v-channels): the LN(v) statistics of the
//              sample's N rows, then, in chunks of 32 v-channels with sgu_w in
//              shared memory, t' and gated = u t';
//     4. out:  y = x + (gated W_out + b_out) m2, 64x64 tiles of (rows, D).
//   backward, 11 launches; it recomputes the forward from x (the autograd
//   Function saves only x), and follows the chain of jax.vjp(_block_math):
//     1. rows: xn = LN(x) again; dout = g m2 (mask 2 before the F/2 -> D product);
//     2. in:   pm, the masked pre-activation;
//     3. dgated = dout W_out^T;
//     4. sgu:  recompute v', t' and gated (for dW_out); the gate: du = dgated t',
//              dt = dgated u m1 (mask 1 before the token projection); du's GELU
//              derivative at pm and mask 0 give the u half of dpre; dv' =
//              dt-by-token sgu_w^T to the v half of dpre (raw); the CTA's
//              partials of d sgu_w = sum v' dt and d sgu_b = sum dt;
//     5. vln:  the LN(v) backward over F/2, in place in dpre's v half, times
//              gelu'(pm) m0; the row tile's partials of d sgu_ln_scale, d sgu_ln_bias;
//     6. dxn = dpre W_in^T, the F sum split into slices;
//     7. dW_in = xn^T dpre, 8. dW_out = gated^T dout: 64x64 tiles of the weight,
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
// recomputed forward: operations bound both, float32 on the CUDA cores (67
// TFLOP/s). The products are the simple SIMT tiles of tile_common.cuh (no
// tensor cores, no TMA), several times off that bound (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mixer_common.cuh"
#include "tile_common.cuh"

namespace {

constexpr int kMaxSeq = 128;                   // tokens a sample may have
constexpr int kCw = 32;                        // v-channels per SGU chunk
constexpr int kGroups = kThreads / kCw;        // token groups of an SGU CTA
constexpr int kPerThread = kMaxSeq / kGroups;  // tokens a thread owns in a chunk
constexpr int kRowTile = 32;                   // rows per CTA of the LN backward kernels
constexpr int kMaxSplit = 32;
constexpr int kMaskIn = 0, kMaskSgu = 1, kMaskOut = 2;
constexpr int kRedJobs = 7;  // the block's reductions of partials (reduce_jobs_kernel)

struct SguParams {
  const float* ln_s;  // (F/2,)
  const float* ln_b;
  const float* w;  // (N, N): t[n] = sum_m v'[m] w[m, n]
  const float* b;  // (N,)
};

// xn = LN(x) s + b, a warp per row; with g, also dout = g m2
__global__ void __launch_bounds__(kThreads)
    ln_rows_kernel(const float* __restrict__ x, const float* __restrict__ s,
                   const float* __restrict__ b, float* __restrict__ xn,
                   const float* __restrict__ g, float* __restrict__ dout, int R, int D,
                   const __grid_constant__ Dropout dp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kThreads / 32) + warp;
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

// over one 64x64 tile of (rows, F): pm = (xn W_in + b_in) m0, stored as gelu(pm)
// (the forward's h) or as pm (the backward's masked pre-activation)
template <bool kGeluOut>
__global__ void __launch_bounds__(kThreads)
    in_proj_kernel(const float* __restrict__ xn, const float* __restrict__ w_in,
                   const float* __restrict__ b_in, float* __restrict__ out, int R, int D, int F,
                   int tanh_flavor, const __grid_constant__ Dropout dp) {
  __shared__ float As[kTileK][kTile + kPad], Bs[kTileK][kTile + kPad];
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  float acc[4][4] = {};
  gemm_tile(View{xn, D, 1}, View{w_in, F, 1}, R, F, 0, D, m0, n0, As, Bs, acc);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + ty * 4 + i, c = n0 + tx * 4 + j;
      if (r < R && c < F) {
        const size_t e = (size_t)r * F + c;
        const float v = (acc[i][j] + __ldg(b_in + c)) * keep(dp, 0, kMaskIn, (uint32_t)e);
        out[e] = kGeluOut ? gelu(v, tanh_flavor) : v;
      }
    }
}

// over one 64x64 tile of (rows, D): y = x + (gated W_out + b_out) m2
__global__ void __launch_bounds__(kThreads)
    out_proj_kernel(const float* __restrict__ gated, const float* __restrict__ w_out,
                    const float* __restrict__ b_out, const float* __restrict__ x,
                    float* __restrict__ y, int R, int H, int D,
                    const __grid_constant__ Dropout dp) {
  __shared__ float As[kTileK][kTile + kPad], Bs[kTileK][kTile + kPad];
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  float acc[4][4] = {};
  gemm_tile(View{gated, H, 1}, View{w_out, D, 1}, R, D, 0, H, m0, n0, As, Bs, acc);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + ty * 4 + i, c = n0 + tx * 4 + j;
      if (r < R && c < D) {
        const size_t e = (size_t)r * D + c;
        y[e] = x[e] + (acc[i][j] + __ldg(b_out + c)) * keep(dp, 0, kMaskOut, (uint32_t)e);
      }
    }
}

// element i of the block's activation h: stored as it is (forward), or as the
// masked pre-activation pm whose GELU it is (backward)
template <bool kFromPre>
__device__ __forceinline__ float act_at(const float* a, size_t i, int tanh_flavor) {
  const float v = a[i];
  return kFromPre ? gelu(v, tanh_flavor) : v;
}

// shared memory (floats) of the SGU kernels for N tokens
__host__ __device__ inline size_t sgu_smem_floats(int N, bool bwd) {
  const size_t chunk = (size_t)N * (kCw + 1);
  return bwd ? 2 * (size_t)N * N + 4 * (size_t)N + 2 * chunk
             : (size_t)N * N + 3 * (size_t)N + chunk;
}

// the SGU's set-up for sample ab (its N rows of F activations): sgu_w and
// sgu_b into shared memory, and each row's LN(v) mean and 1/std over its F/2
// v-channels (a warp per row)
template <bool kFromPre>
__device__ void sgu_prologue(const float* ab, const SguParams& p, int N, int F, int tanh_flavor,
                             float* ws, float* sb, float* mean, float* inv) {
  const int H = F / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < N * N; i += kThreads) ws[i] = __ldg(p.w + i);
  for (int i = threadIdx.x; i < N; i += kThreads) sb[i] = __ldg(p.b + i);
  for (int m = warp; m < N; m += kThreads / 32) {
    const size_t row = (size_t)m * F + H;
    float sum = 0.f;
    for (int c = lane; c < H; c += 32) sum += act_at<kFromPre>(ab, row + c, tanh_flavor);
    const float mu = warp_sum(sum) / H;
    float sq = 0.f;
    for (int c = lane; c < H; c += 32) {
      const float t = act_at<kFromPre>(ab, row + c, tanh_flavor) - mu;
      sq += t * t;
    }
    const float var = warp_sum(sq) / H;
    if (lane == 0) {
      mean[m] = mu;
      inv[m] = rsqrtf(var + 1e-5f);
    }
  }
}

// vn[m][cc] = LN(v)[m, c0 + cc] (0 beyond F/2) for the chunk of kCw v-channels at c0
template <bool kFromPre>
__device__ void load_chunk(const float* ab, const SguParams& p, int N, int F, int c0,
                           int tanh_flavor, const float* mean, const float* inv, float* vn) {
  const int H = F / 2;
  for (int i = threadIdx.x; i < N * kCw; i += kThreads) {
    const int m = i / kCw, cc = i - m * kCw, c = c0 + cc;
    vn[m * (kCw + 1) + cc] =
        c < H ? (act_at<kFromPre>(ab, (size_t)m * F + H + c, tanh_flavor) - mean[m]) * inv[m] *
                        __ldg(p.ln_s + c) +
                    __ldg(p.ln_b + c)
              : 0.f;
  }
}

// acc[j] = sum over m (in order) of a[m][cc] * w[m][grp + kGroups * j] with a the
// (N, kCw + 1) chunk in shared memory: output token n = grp + kGroups * j
__device__ __forceinline__ void token_proj(const float* a, const float* w, int N, int cc, int grp,
                                           float (&acc)[kPerThread]) {
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) acc[j] = 0.f;
  for (int m = 0; m < N; ++m) {
    const float v = a[m * (kCw + 1) + cc];
    const float* wr = w + m * N;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int n = grp + kGroups * j;
      if (n < N) acc[j] = fmaf(v, wr[n], acc[j]);
    }
  }
}

// forward step 3 for sample blockIdx.y and every gridDim.x-th chunk of kCw
// v-channels from chunk blockIdx.x: gated = u * (LN(v) sgu_w + sgu_b) m1
__global__ void __launch_bounds__(kThreads)
    sgu_fwd_kernel(const float* __restrict__ h, float* __restrict__ gated, SguParams p, int N,
                   int F, const __grid_constant__ Dropout dp) {
  extern __shared__ __align__(16) float sm[];
  const int H = F / 2, b = blockIdx.y;
  float* ws = sm;
  float* sb = ws + N * N;
  float* mean = sb + N;
  float* inv = mean + N;
  float* vn = inv + N;
  const float* hb = h + (size_t)b * N * F;
  sgu_prologue<false>(hb, p, N, F, 0, ws, sb, mean, inv);
  __syncthreads();
  const int cc = threadIdx.x % kCw, grp = threadIdx.x / kCw;
  for (int c0 = blockIdx.x * kCw; c0 < H; c0 += gridDim.x * kCw) {
    load_chunk<false>(hb, p, N, F, c0, 0, mean, inv, vn);
    __syncthreads();
    float acc[kPerThread];
    token_proj(vn, ws, N, cc, grp, acc);
    const int c = c0 + cc;
    if (c < H) {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int n = grp + kGroups * j;
        if (n < N) {
          const float m1 = keep(dp, 0, kMaskSgu, ((uint32_t)b * H + c) * N + n);
          gated[((size_t)b * N + n) * H + c] = hb[(size_t)n * F + c] * ((acc[j] + sb[n]) * m1);
        }
      }
    }
    __syncthreads();
  }
}

// backward step 4 (see the top of the file), over the same (sample, chunks)
// as sgu_fwd_kernel; the CTA's partials of d sgu_w (N x N) and d sgu_b (N)
// go to part[blockIdx.y * gridDim.x + blockIdx.x]
__global__ void __launch_bounds__(kThreads)
    sgu_bwd_kernel(const float* __restrict__ pm, const float* __restrict__ dg,
                   float* __restrict__ gated, float* __restrict__ dpre, float* __restrict__ part,
                   SguParams p, int N, int F, int tanh_flavor, const __grid_constant__ Dropout dp) {
  extern __shared__ __align__(16) float sm[];
  const int H = F / 2, b = blockIdx.y;
  float* ws = sm;
  float* dws = ws + N * N;
  float* sb = dws + N * N;
  float* dbs = sb + N;
  float* mean = dbs + N;
  float* inv = mean + N;
  float* vn = inv + N;
  float* dt = vn + N * (kCw + 1);
  const float* pb = pm + (size_t)b * N * F;
  sgu_prologue<true>(pb, p, N, F, tanh_flavor, ws, sb, mean, inv);
  for (int i = threadIdx.x; i < N * N; i += kThreads) dws[i] = 0.f;
  for (int i = threadIdx.x; i < N; i += kThreads) dbs[i] = 0.f;
  __syncthreads();
  const int cc = threadIdx.x % kCw, grp = threadIdx.x / kCw;
  for (int c0 = blockIdx.x * kCw; c0 < H; c0 += gridDim.x * kCw) {
    load_chunk<true>(pb, p, N, F, c0, tanh_flavor, mean, inv, vn);
    __syncthreads();
    float acc[kPerThread];
    token_proj(vn, ws, N, cc, grp, acc);
    const int c = c0 + cc;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int n = grp + kGroups * j;
      if (n < N) {
        float dtv = 0.f;
        if (c < H) {
          const size_t r = (size_t)b * N + n;
          const float m1 = keep(dp, 0, kMaskSgu, ((uint32_t)b * H + c) * N + n);
          const float tm = (acc[j] + sb[n]) * m1;  // t'
          const float pu = pb[(size_t)n * F + c];
          const float u = gelu(pu, tanh_flavor);
          const float d = dg[r * H + c];
          gated[r * H + c] = u * tm;
          // the gate (gmlp_kernel.py:75): du = dgated t'; then the GELU at the
          // masked pre-activation (:65) and mask 0 (:63-64)
          const size_t e = r * F + c;
          dpre[e] = d * tm * gelu_grad(pu, tanh_flavor) * keep(dp, 0, kMaskIn, (uint32_t)e);
          dtv = d * u * m1;  // dt' = dgated u, then mask 1 (:72-73)
        }
        dt[n * (kCw + 1) + cc] = dtv;
      }
    }
    __syncthreads();
    // the token projection (:71): dv'[m] = sum over n of sgu_w[m, n] dt[n]
    float dv[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) dv[j] = 0.f;
    for (int n = 0; n < N; ++n) {
      const float d = dt[n * (kCw + 1) + cc];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int m = grp + kGroups * j;
        if (m < N) dv[j] = fmaf(ws[m * N + n], d, dv[j]);
      }
    }
    if (c < H) {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int m = grp + kGroups * j;
        if (m < N) dpre[((size_t)b * N + m) * F + H + c] = dv[j];
      }
    }
    // d sgu_w[m, n] += sum over the chunk of v'[m] dt[n]; d sgu_b[n] += sum of dt[n]
    for (int q = threadIdx.x; q < N * N; q += kThreads) {
      const int m = q / N, n = q - m * N;
      float s = 0.f;
#pragma unroll 8
      for (int k = 0; k < kCw; ++k) s = fmaf(vn[m * (kCw + 1) + k], dt[n * (kCw + 1) + k], s);
      dws[q] += s;
    }
    for (int n = threadIdx.x; n < N; n += kThreads) {
      float s = 0.f;
      for (int k = 0; k < kCw; ++k) s += dt[n * (kCw + 1) + k];
      dbs[n] += s;
    }
    __syncthreads();
  }
  float* mine = part + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * ((size_t)N * N + N);
  for (int i = threadIdx.x; i < N * N; i += kThreads) mine[i] = dws[i];
  for (int i = threadIdx.x; i < N; i += kThreads) mine[N * N + i] = dbs[i];
}

// backward step 5 on kRowTile rows: dpre's v half holds dv' (sgu_bwd_kernel);
// the LN(v) backward (gmlp_kernel.py:68) turns it into dv, then gelu'(pm) and
// mask 0 into d pre, in place. The tile's partials of d sgu_ln_scale and
// d sgu_ln_bias (2 x F/2) go to part[blockIdx.x].
__global__ void __launch_bounds__(kThreads)
    vln_bwd_kernel(const float* __restrict__ pm, float* __restrict__ dpre,
                   const float* __restrict__ s, float* __restrict__ part, int R, int F,
                   int tanh_flavor, const __grid_constant__ Dropout dp) {
  extern __shared__ __align__(16) float sm[];
  const int H = F / 2;
  const int r0 = blockIdx.x * kRowTile, nr = min(kRowTile, R - r0);
  float* xh = sm;               // v, then its normalized value
  float* as = xh + kRowTile * H;  // dv'
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

struct Plan {
  int nsplit;           // SGU CTAs per sample
  int xsplit, xslice;   // dxn: slices of F
  int wsplit, wslice;   // dW_in, dW_out, db_in, db_out: slices of the rows
  int tiles;            // row tiles of the LN backward kernels
  size_t sgu_fwd_smem, sgu_bwd_smem, vln_smem, ln_smem;
  // workspace offsets (floats)
  size_t xn, act, gated, dout, dg, dpre, dxnp, p_ln, p_vln, p_sgu, p_win, p_wout, p_col;
  size_t fwd_floats, bwd_floats;
};

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

int check_args(int B, int N, int D, int F) {
  if (B < 1 || B > 65535 || N < 1 || N > kMaxSeq || D < 1 || F < 2 || F % 2) return -1;
  const unsigned long long big = (unsigned long long)B * N * (F > D ? F : D);
  if (big >= (1ull << 32)) return -1;  // the dropout masks count their elements in 32 bits
  return 0;
}

int make_plan(int B, int N, int D, int F, int device, Plan& pl) {
  int limit = 0, sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int H = F / 2;
  const long long R = (long long)B * N;
  const int chunks = ceil_div(H, kCw);
  int ns = ceil_div(2 * sms, B);
  pl.nsplit = ns < 1 ? 1 : (ns > chunks ? chunks : ns);
  pl.sgu_fwd_smem = sgu_smem_floats(N, false) * 4;
  pl.sgu_bwd_smem = sgu_smem_floats(N, true) * 4;
  pl.vln_smem = (size_t)2 * kRowTile * H * 4;
  pl.ln_smem = ln_bwd_smem_bytes(kRowTile, D);
  if (pl.sgu_bwd_smem > (size_t)limit || pl.vln_smem > (size_t)limit ||
      pl.ln_smem > (size_t)limit)
    return -1;
  // dxn = dpre W_in^T: enough (rows x D) tiles x slices of F for one wave
  const int out_tiles = ceil_div(R, kTile) * ceil_div(D, kTile);
  int ks = sms / out_tiles;
  ks = ks < 1 ? 1 : (ks > kMaxSplit ? kMaxSplit : ks);
  pl.xslice = ceil_div(ceil_div(F, ks), kTileK) * kTileK;
  pl.xsplit = ceil_div(F, pl.xslice);
  // the weight gradients: their few 64x64 tiles x slices of the rows for two waves
  const int w_tiles = ceil_div(H, kTile) * ceil_div(D, kTile);
  int ws = ceil_div(2 * sms, w_tiles);
  const int max_ws = ceil_div(R, kTile);  // at least 64 rows a slice
  ws = ws > kMaxSplit ? kMaxSplit : ws;
  ws = ws > max_ws ? max_ws : ws;
  ws = ws < 1 ? 1 : ws;
  pl.wslice = ceil_div(ceil_div(R, ws), kTileK) * kTileK;
  pl.wsplit = ceil_div(R, pl.wslice);
  pl.tiles = ceil_div(R, kRowTile);
  const size_t rows = (size_t)R;
  size_t o = 0;
  pl.xn = o, o += rows * D;
  pl.act = o, o += rows * F;
  pl.gated = o, o += rows * H;
  pl.fwd_floats = o;
  pl.dout = o, o += rows * D;
  pl.dg = o, o += rows * H;
  pl.dpre = o, o += rows * F;
  pl.dxnp = o, o += (size_t)pl.xsplit * rows * D;
  pl.p_ln = o, o += (size_t)pl.tiles * 2 * D;
  pl.p_vln = o, o += (size_t)pl.tiles * 2 * H;
  pl.p_sgu = o, o += (size_t)B * pl.nsplit * ((size_t)N * N + N);
  pl.p_win = o, o += (size_t)pl.wsplit * D * F;
  pl.p_wout = o, o += (size_t)pl.wsplit * H * D;
  pl.p_col = o, o += (size_t)pl.wsplit * (F + D);
  pl.bwd_floats = o;
  return 0;
}

SguParams sgu_params(const void* const* q) {
  return SguParams{static_cast<const float*>(q[4]), static_cast<const float*>(q[5]),
                   static_cast<const float*>(q[6]), static_cast<const float*>(q[7])};
}

// steps 1 and 2 of both directions: xn (and dout), then h (forward) or pm (backward)
int in_half(const Plan& pl, float* ws, const float* x, const float* g, const void* const* q,
            int B, int N, int D, int F, int tanh_flavor, const Dropout& dp, cudaStream_t st) {
  const int R = B * N;
  const float* p0 = static_cast<const float*>(q[0]);
  const float* p1 = static_cast<const float*>(q[1]);
  ln_rows_kernel<<<ceil_div(R, kThreads / 32), kThreads, 0, st>>>(
      x, p0, p1, ws + pl.xn, g, g ? ws + pl.dout : nullptr, R, D, dp);
  M2M_TRY(cudaGetLastError());
  const dim3 grid(ceil_div(F, kTile), ceil_div(R, kTile));
  const float* w_in = static_cast<const float*>(q[2]);
  const float* b_in = static_cast<const float*>(q[3]);
  if (g)
    in_proj_kernel<false><<<grid, kThreads, 0, st>>>(ws + pl.xn, w_in, b_in, ws + pl.act, R, D,
                                                      F, tanh_flavor, dp);
  else
    in_proj_kernel<true><<<grid, kThreads, 0, st>>>(ws + pl.xn, w_in, b_in, ws + pl.act, R, D, F,
                                                     tanh_flavor, dp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Workspace bytes of the gMLP forward (backward = 0) or backward (the wrapper
// allocates it); 0 for shapes the kernels do not take.
size_t m2m_gmlp_workspace_bytes(int B, int N, int D, int F, int backward, int device) {
  Plan pl;
  if (check_args(B, N, D, F) || make_plan(B, N, D, F, device, pl)) return 0;
  return (backward ? pl.bwd_floats : pl.fwd_floats) * 4;
}

// K3f: y = GatingMlpBlock(x), x and y (B, N, D) float32. ptrs: the 10
// parameters in GmlpBlockParams order (float32, JAX layout); keys/thresh/scale:
// dropout (4 stream keys of block 0, or keys == nullptr for none); workspace:
// m2m_gmlp_workspace_bytes(..., 0, ...) bytes.
int m2m_gmlp_fwd(const float* x, float* y, int B, int N, int D, int F, int tanh_flavor,
                 const unsigned* keys, unsigned thresh, float scale, int device,
                 const void* const* ptrs, void* workspace, void* stream) {
  if (check_args(B, N, D, F)) return -1;
  M2M_TRY(cudaSetDevice(device));
  Plan pl;
  int code = make_plan(B, N, D, F, device, pl);
  if (code) return code;
  M2M_TRY(prepare(sgu_fwd_kernel, pl.sgu_fwd_smem));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout dp = make_dropout(keys, 1, thresh, scale);
  float* ws = static_cast<float*>(workspace);
  code = in_half(pl, ws, x, nullptr, ptrs, B, N, D, F, tanh_flavor, dp, st);
  if (code) return code;
  sgu_fwd_kernel<<<dim3(pl.nsplit, B), kThreads, pl.sgu_fwd_smem, st>>>(
      ws + pl.act, ws + pl.gated, sgu_params(ptrs), N, F, dp);
  M2M_TRY(cudaGetLastError());
  const int R = B * N;
  out_proj_kernel<<<dim3(ceil_div(D, kTile), ceil_div(R, kTile)), kThreads, 0, st>>>(
      ws + pl.gated, static_cast<const float*>(ptrs[8]), static_cast<const float*>(ptrs[9]), x, y,
      R, F / 2, D, dp);
  return (int)cudaGetLastError();
}

// K3b: dx and the 10 parameter gradients (float32, GmlpBlockParams order) of
// one GatingMlpBlock at input x for output gradient g, the forward's masks
// regenerated from the same keys; workspace: m2m_gmlp_workspace_bytes(..., 1, ...).
int m2m_gmlp_bwd(const float* x, const float* g, float* dx, int B, int N, int D, int F,
                 int tanh_flavor, const unsigned* keys, unsigned thresh, float scale, int device,
                 const void* const* ptrs, void* const* grads, void* workspace, void* stream) {
  if (check_args(B, N, D, F)) return -1;
  M2M_TRY(cudaSetDevice(device));
  Plan pl;
  int code = make_plan(B, N, D, F, device, pl);
  if (code) return code;
  M2M_TRY(prepare(sgu_bwd_kernel, pl.sgu_bwd_smem));
  M2M_TRY(prepare(vln_bwd_kernel, pl.vln_smem));
  M2M_TRY(prepare(ln_bwd_kernel, pl.ln_smem));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout dp = make_dropout(keys, 1, thresh, scale);
  float* ws = static_cast<float*>(workspace);
  const int R = B * N, H = F / 2;
  const float* w_in = static_cast<const float*>(ptrs[2]);
  const float* w_out = static_cast<const float*>(ptrs[8]);
  float* const* gq = reinterpret_cast<float* const*>(grads);
  code = in_half(pl, ws, x, g, ptrs, B, N, D, F, tanh_flavor, dp, st);
  if (code) return code;
  // dgated = dout W_out^T (gmlp_kernel.py:77)
  gemm_kernel<<<dim3(ceil_div(H, kTile), ceil_div(R, kTile), 1), kThreads, 0, st>>>(
      View{ws + pl.dout, D, 1}, View{w_out, 1, D}, ws + pl.dg, R, H, D, D);
  M2M_TRY(cudaGetLastError());
  sgu_bwd_kernel<<<dim3(pl.nsplit, B), kThreads, pl.sgu_bwd_smem, st>>>(
      ws + pl.act, ws + pl.dg, ws + pl.gated, ws + pl.dpre, ws + pl.p_sgu, sgu_params(ptrs), N, F,
      tanh_flavor, dp);
  M2M_TRY(cudaGetLastError());
  vln_bwd_kernel<<<pl.tiles, kThreads, pl.vln_smem, st>>>(
      ws + pl.act, ws + pl.dpre, static_cast<const float*>(ptrs[4]), ws + pl.p_vln, R, F,
      tanh_flavor, dp);
  M2M_TRY(cudaGetLastError());
  // dxn = dpre W_in^T (:62), slices of F
  gemm_kernel<<<dim3(ceil_div(D, kTile), ceil_div(R, kTile), pl.xsplit), kThreads, 0, st>>>(
      View{ws + pl.dpre, F, 1}, View{w_in, 1, F}, ws + pl.dxnp, R, D, F, pl.xslice);
  M2M_TRY(cudaGetLastError());
  // dW_in = xn^T dpre, dW_out = gated^T dout: slices of the rows
  gemm_kernel<<<dim3(ceil_div(F, kTile), ceil_div(D, kTile), pl.wsplit), kThreads, 0, st>>>(
      View{ws + pl.xn, 1, D}, View{ws + pl.dpre, F, 1}, ws + pl.p_win, D, F, R, pl.wslice);
  M2M_TRY(cudaGetLastError());
  gemm_kernel<<<dim3(ceil_div(D, kTile), ceil_div(H, kTile), pl.wsplit), kThreads, 0, st>>>(
      View{ws + pl.gated, 1, H}, View{ws + pl.dout, D, 1}, ws + pl.p_wout, H, D, R, pl.wslice);
  M2M_TRY(cudaGetLastError());
  ColJobs<2> cj = {};
  cj.job[0] = ColJob{ws + pl.dpre, F, ws + pl.p_col};
  cj.job[1] = ColJob{ws + pl.dout, D, ws + pl.p_col + (size_t)pl.wsplit * F};
  col_slices_kernel<2><<<dim3(ceil_div(F > D ? F : D, kThreads), pl.wsplit, 2), kThreads, 0, st>>>(
      cj, R, pl.wslice);
  M2M_TRY(cudaGetLastError());
  // the LN backward over D plus the residual g (:61, :80), dxn's slices in order
  ln_bwd_kernel<<<pl.tiles, kThreads, pl.ln_smem, st>>>(
      x, ws + pl.dxnp, pl.xsplit, g, static_cast<const float*>(ptrs[0]), dx, ws + pl.p_ln, R, D,
      kRowTile);
  M2M_TRY(cudaGetLastError());
  const int NN = N * N;
  RedJobs<kRedJobs> rj = {};
  rj.job[0] = RedJob{ws + pl.p_ln, pl.tiles, 2 * D, gq[0], D, gq[1]};
  rj.job[1] = RedJob{ws + pl.p_vln, pl.tiles, 2 * H, gq[4], H, gq[5]};
  rj.job[2] = RedJob{ws + pl.p_sgu, B * pl.nsplit, NN + N, gq[6], NN, gq[7]};
  rj.job[3] = RedJob{ws + pl.p_win, pl.wsplit, D * F, gq[2], D * F, nullptr};
  rj.job[4] = RedJob{ws + pl.p_wout, pl.wsplit, H * D, gq[8], H * D, nullptr};
  rj.job[5] = RedJob{ws + pl.p_col, pl.wsplit, F, gq[3], F, nullptr};
  rj.job[6] = RedJob{ws + pl.p_col + (size_t)pl.wsplit * F, pl.wsplit, D, gq[9], D, nullptr};
  // the grid covers the longest job: dW_in, or d sgu_w + d sgu_b where N^2 + N > D*F
  int longest = 0;
  for (const RedJob& j : rj.job) longest = j.P > longest ? j.P : longest;
  reduce_jobs_kernel<kRedJobs><<<dim3(ceil_div(longest, kThreads), kRedJobs), kThreads, 0, st>>>(rj);
  return (int)cudaGetLastError();
}

}  // extern "C"
