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
// recomputed forward: operations bound both. The forward's products are the
// simple SIMT tiles of tile_common.cuh (float32 on the CUDA cores, 67 TFLOP/s
// at best). The backward's run on the tensor cores in 3xTF32 (tile_common.cuh
// says why that split and why mma.sync rather than wgmma): its five GEMMs
// (steps 2, 3, 6, 7, 8) on tc_gemm, with the bias and mask 0 in step 2's
// epilogue; its SGU kernel keeps sgu_w in shared memory and runs the chunk's
// three token products (t = v' sgu_w, dv' = dt sgu_w^T, d sgu_w += v'^T dt) as
// mma.sync from shared memory, d sgu_w's partial in registers across the
// chunks and written once. Tokens are padded to whole m16 tiles (49 -> 64,
// 99 -> 112) with zeros. The rest (the gate, LN(v) and its backward, column
// sums, reductions) is CUDA-core work on memory (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mixer_common.cuh"
#include "tile_common.cuh"

namespace {

constexpr int kMaxSeq = 128;                   // tokens a sample may have
constexpr int kCw = 32;                        // v-channels per SGU chunk (forward)
constexpr int kCwBwd = 64;                     // v-channels per SGU chunk (backward), 8 a warp
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

// the shared-memory layout (floats) of sgu_bwd_kernel for N tokens: the
// tokens padded to nm (whole m16 tiles) and np (whole k8 steps); sgu_w (nm x
// ldw, zero beyond N); the chunk's v' (staged raw, then normalized in place),
// dt, u's pre-activation and dgated (nm x ldc each); sgu_b, d sgu_b, LN(v)'s
// mean and 1/std
struct SguBwdLayout {
  int nm, np, ldw, ldc;
  size_t w, vn, dt, u, dg, sb, db, mean, inv, floats;
};

__host__ __device__ inline SguBwdLayout sgu_bwd_layout(int N) {
  SguBwdLayout s;
  s.nm = (N + 15) / 16 * 16;
  s.np = (N + 7) / 8 * 8;
  // row strides of 8 or 24 (mod 32): the fragment loads that step down the
  // rows (t's token projection, the dt operand) fall in 32 banks, the others in 16
  s.ldw = s.nm + 8;
  s.ldc = kCwBwd + 8;
  size_t o = 0;
  s.w = o, o += (size_t)s.nm * s.ldw;
  s.vn = o, o += (size_t)s.nm * s.ldc;
  s.dt = o, o += (size_t)s.nm * s.ldc;
  s.u = o, o += (size_t)s.nm * s.ldc;
  s.dg = o, o += (size_t)s.nm * s.ldc;
  s.sb = o, o += s.nm;
  s.db = o, o += s.nm;
  s.mean = o, o += s.nm;
  s.inv = o, o += s.nm;
  s.floats = o;
  return s;
}

// dst[m * ldc + cc] = src[m * ld + cc] for m < N, cc < min(kCwBwd, cols)
// (zeros elsewhere in the nm x kCwBwd block): asynchronous copies, 16 bytes
// each when `vec` (src and ld 16-byte aligned), else 4
template <int kT>
__device__ __forceinline__ void sgu_stage(float* dst, const float* src, long long ld, int N,
                                          int nm, int cols, int ldc, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < nm * (kCwBwd / 4); i += kT) {
      const int m = i / (kCwBwd / 4), cc = i % (kCwBwd / 4) * 4;
      int n4 = m < N ? cols - cc : 0;
      n4 = n4 < 0 ? 0 : (n4 > 4 ? 4 : n4);
      cp_async16(dst + m * ldc + cc, n4 ? src + m * ld + cc : src, 4 * n4);
    }
  } else {
    for (int i = threadIdx.x; i < nm * kCwBwd; i += kT) {
      const int m = i / kCwBwd, cc = i % kCwBwd;
      const bool ok = m < N && cc < cols;
      cp_async4(dst + m * ldc + cc, ok ? src + m * ld + cc : src, ok);
    }
  }
}

// backward step 4a: every row's LN(v) mean and 1/std over its F/2
// v-channels, gelu(pm) recomputed, a warp per row: stats[r] and stats[R + r]
__global__ void __launch_bounds__(kThreads)
    vstats_kernel(const float* __restrict__ pm, float* __restrict__ stats, int R, int F,
                  int tanh_flavor) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kThreads / 32) + warp;
  if (r >= R) return;  // whole warps leave together
  const int H = F / 2;
  const float* v = pm + (size_t)r * F + H;
  float sum = 0.f;
#pragma unroll 4
  for (int c = lane; c < H; c += 32) sum += gelu(v[c], tanh_flavor);
  const float mu = warp_sum(sum) / H;
  float sq = 0.f;
#pragma unroll 4
  for (int c = lane; c < H; c += 32) {
    const float d = gelu(v[c], tanh_flavor) - mu;
    sq += d * d;
  }
  const float var = warp_sum(sq) / H;
  if (lane == 0) {
    stats[r] = mu;
    stats[R + r] = rsqrtf(var + 1e-5f);
  }
}

// backward step 4b (see the top of the file) for sample blockIdx.y and every
// gridDim.x-th chunk of kCwBwd v-channels from chunk blockIdx.x, its three
// products on the tensor cores (3xTF32, tile_common.cuh) from shared memory.
// A chunk's operands (pm's v and u columns, dgated) reach shared memory by
// cp.async, the u and dgated columns while the token projection runs; the
// gate then runs element by element on t in shared memory (coalesced stores).
// The warps stand 4 x kWC: warp (wm, wc) owns the token tiles wm + 4i (m16,
// kMT of them in all) and, in the two products over the chunk's v-channels,
// the kCB v-channel blocks kCB wc + j (8 wide), in d sgu_w the column tiles
// wc + kWC j (8 wide), so a fragment it loads serves several products. The
// CTA's partials of d sgu_w (N x N, in registers across the chunks) and
// d sgu_b (N) go to part[blockIdx.y * gridDim.x + blockIdx.x].
template <int kMT, int kWC>
__global__ void __launch_bounds__(128 * kWC, 1)
    sgu_bwd_kernel(const float* __restrict__ pm, const float* __restrict__ dg,
                   const float* __restrict__ vstats, float* __restrict__ gated,
                   float* __restrict__ dpre, float* __restrict__ part, SguParams p, int N, int F,
                   int tanh_flavor, const __grid_constant__ Dropout dp) {
  constexpr int kT = 128 * kWC;          // threads: 4 x kWC warps
  constexpr int kMI = kMT / 4;           // token tiles a warp owns
  constexpr int kCB = kCwBwd / 8 / kWC;  // v-channel blocks a warp owns (of kCwBwd / 8)
  constexpr int kNT = 2 * kMT / kWC;     // d sgu_w column tiles a warp owns (of 2 kMT)
  extern __shared__ __align__(16) float sm[];
  const SguBwdLayout L = sgu_bwd_layout(N);
  const int H = F / 2, b = blockIdx.y, R = gridDim.y * N;
  float* ws = sm + L.w;
  float* vn = sm + L.vn;
  float* dts = sm + L.dt;
  float* us = sm + L.u;
  float* gs = sm + L.dg;
  float* sb = sm + L.sb;
  float* dbs = sm + L.db;
  float* mean = sm + L.mean;
  float* inv = sm + L.inv;
  const float* pb = pm + (size_t)b * N * F;
  const float* gb = dg + (size_t)b * N * H;
  const bool vec = F % 8 == 0 && reinterpret_cast<uintptr_t>(pm) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dg) % 16 == 0;
  for (int i = threadIdx.x; i < L.nm * L.ldw; i += kT) {
    const int m = i / L.ldw, n = i - m * L.ldw;
    ws[i] = m < N && n < N ? __ldg(p.w + m * N + n) : 0.f;
  }
  for (int i = threadIdx.x; i < L.nm; i += kT) {
    sb[i] = i < N ? __ldg(p.b + i) : 0.f;
    dbs[i] = 0.f;
    mean[i] = i < N ? vstats[b * N + i] : 0.f;
    inv[i] = i < N ? vstats[R + b * N + i] : 0.f;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mt = L.nm / 16, wm = warp & 3, wc = warp >> 2;
  float dw[kMI][kNT][4] = {};
  for (int c0 = blockIdx.x * kCwBwd; c0 < H; c0 += gridDim.x * kCwBwd) {
    sgu_stage<kT>(vn, pb + H + c0, F, N, L.nm, H - c0, L.ldc, vec);
    cp_async_commit();
    sgu_stage<kT>(us, pb + c0, F, N, L.nm, H - c0, L.ldc, vec);
    sgu_stage<kT>(gs, gb + c0, H, N, L.nm, H - c0, L.ldc, vec);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    // v' = LN(v) of the chunk in place, zero beyond N tokens and F/2 channels
    for (int i = threadIdx.x; i < L.nm * kCwBwd; i += kT) {
      const int m = i / kCwBwd, cc = i % kCwBwd, c = c0 + cc;
      float* v = vn + m * L.ldc + cc;
      *v = m < N && c < H ? (gelu(*v, tanh_flavor) - mean[m]) * inv[m] * __ldg(p.ln_s + c) +
                                __ldg(p.ln_b + c)
                          : 0.f;
    }
    __syncthreads();
    // the token projection, recomputed: t(n, cc) = sum over m of sgu_w[m, n] v'(m, cc)
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
    // t to shared memory (dts) for the element-wise gate
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
    cp_async_wait<0>();
    __syncthreads();  // t, and the u and dgated columns, in shared memory
    // the gate, element by element (token n, v-channel c; neighbouring threads
    // on neighbouring channels); dt replaces t in shared memory
    for (int q = threadIdx.x; q < L.nm * kCwBwd; q += kT) {
      const int n = q / kCwBwd, cc = q % kCwBwd, c = c0 + cc;
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
        dpre[el] = d * tm * gelu_grad(pu, tanh_flavor) * keep(dp, 0, kMaskIn, (uint32_t)el);
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
    for (int k = 0; k < kCwBwd; k += 8) {
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
      for (int cc = 0; cc < kCwBwd; ++cc) sum += dts[n * L.ldc + cc];
      dbs[n] += sum;
    }
    __syncthreads();
    // dv' to the v half of dpre (raw), neighbouring threads on neighbouring channels
    for (int q = threadIdx.x; q < N * kCwBwd; q += kT) {
      const int m = q / kCwBwd, cc = q % kCwBwd, c = c0 + cc;
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
  int nsplit, nsplit_bwd;  // SGU CTAs per sample (forward, backward)
  int xsplit, xslice;   // dxn: slices of F
  int wsplit, wslice;   // dW_in, dW_out, db_in, db_out: slices of the rows
  int tiles;            // row tiles of the LN backward kernels
  size_t sgu_fwd_smem, sgu_bwd_smem, vln_smem, ln_smem;
  // workspace offsets (floats)
  size_t xn, act, gated, dout, dg, dpre, dxnp, vstats, p_ln, p_vln, p_sgu, p_win, p_wout, p_col;
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
  const int chunks = ceil_div(H, kCw), chunks_bwd = ceil_div(H, kCwBwd);
  int ns = ceil_div(2 * sms, B);
  pl.nsplit = ns < 1 ? 1 : (ns > chunks ? chunks : ns);
  pl.nsplit_bwd = ns < 1 ? 1 : (ns > chunks_bwd ? chunks_bwd : ns);
  pl.sgu_fwd_smem = sgu_smem_floats(N, false) * 4;
  pl.sgu_bwd_smem = sgu_bwd_layout(N).floats * 4;
  pl.vln_smem = (size_t)2 * kRowTile * H * 4;
  pl.ln_smem = ln_bwd_smem_bytes(kRowTile, D);
  if (pl.sgu_bwd_smem > (size_t)limit || pl.vln_smem > (size_t)limit ||
      pl.ln_smem > (size_t)limit)
    return -1;
  // dxn = dpre W_in^T: enough (rows x D) tiles x slices of F for two CTAs an SM
  const int out_tiles = ceil_div(R, kTcBM) * ceil_div(D, kTcBN);
  int ks = 2 * sms / out_tiles;
  ks = ks < 1 ? 1 : (ks > kMaxSplit ? kMaxSplit : ks);
  pl.xslice = ceil_div(ceil_div(F, ks), kTcK) * kTcK;
  pl.xsplit = ceil_div(F, pl.xslice);
  // the weight gradients: dW_in's few tiles x slices of the rows for two CTAs an SM
  const int w_tiles = ceil_div(D, kTcBM) * ceil_div(F, kTcBN);
  int ws = ceil_div(2 * sms, w_tiles);
  const int max_ws = ceil_div(R, 64);  // at least 64 rows a slice
  ws = ws > kMaxSplit ? kMaxSplit : ws;
  ws = ws > max_ws ? max_ws : ws;
  ws = ws < 1 ? 1 : ws;
  pl.wslice = ceil_div(ceil_div(R, ws), kTcK) * kTcK;
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
  pl.vstats = o, o += 2 * rows;
  pl.p_ln = o, o += (size_t)pl.tiles * 2 * D;
  pl.p_vln = o, o += (size_t)pl.tiles * 2 * H;
  pl.p_sgu = o, o += (size_t)B * pl.nsplit_bwd * ((size_t)N * N + N);
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
  // m16 token tiles: 8 on 16 warps, else 4 on 8 warps
  const bool wide = sgu_bwd_layout(N).nm > 64;
  auto sgu_bwd = wide ? sgu_bwd_kernel<8, 4> : sgu_bwd_kernel<4, 2>;
  M2M_TRY(prepare(sgu_bwd, pl.sgu_bwd_smem));
  M2M_TRY(prepare(vln_bwd_kernel, pl.vln_smem));
  M2M_TRY(prepare(ln_bwd_kernel, pl.ln_smem));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout dp = make_dropout(keys, 1, thresh, scale);
  float* ws = static_cast<float*>(workspace);
  const int R = B * N, H = F / 2;
  const float* w_in = static_cast<const float*>(ptrs[2]);
  const float* w_out = static_cast<const float*>(ptrs[8]);
  float* const* gq = reinterpret_cast<float* const*>(grads);
  // xn = LN(x), dout = g m2; then pm = (xn W_in + b_in) m0 on the tensor cores
  ln_rows_kernel<<<ceil_div(R, kThreads / 32), kThreads, 0, st>>>(
      x, static_cast<const float*>(ptrs[0]), static_cast<const float*>(ptrs[1]), ws + pl.xn, g,
      ws + pl.dout, R, D, dp);
  M2M_TRY(cudaGetLastError());
  M2M_TRY(tc_gemm_wide(View{ws + pl.xn, D, 1}, View{w_in, F, 1}, ws + pl.act, R, F, D, D, 1, st,
                       EpiBiasMask{static_cast<const float*>(ptrs[3]), kMaskIn, F, dp}));
  // dgated = dout W_out^T (gmlp_kernel.py:77)
  M2M_TRY(tc_gemm_wide(View{ws + pl.dout, D, 1}, View{w_out, 1, D}, ws + pl.dg, R, H, D, D, 1,
                       st));
  vstats_kernel<<<ceil_div(R, kThreads / 32), kThreads, 0, st>>>(ws + pl.act, ws + pl.vstats, R,
                                                                 F, tanh_flavor);
  M2M_TRY(cudaGetLastError());
  sgu_bwd<<<dim3(pl.nsplit_bwd, B), wide ? 512 : 256, pl.sgu_bwd_smem, st>>>(
      ws + pl.act, ws + pl.dg, ws + pl.vstats, ws + pl.gated, ws + pl.dpre, ws + pl.p_sgu,
      sgu_params(ptrs), N, F, tanh_flavor, dp);
  M2M_TRY(cudaGetLastError());
  vln_bwd_kernel<<<pl.tiles, kThreads, pl.vln_smem, st>>>(
      ws + pl.act, ws + pl.dpre, static_cast<const float*>(ptrs[4]), ws + pl.p_vln, R, F,
      tanh_flavor, dp);
  M2M_TRY(cudaGetLastError());
  // dxn = dpre W_in^T (:62), slices of F
  M2M_TRY(tc_gemm_wide(View{ws + pl.dpre, F, 1}, View{w_in, 1, F}, ws + pl.dxnp, R, D, F,
                       pl.xslice, pl.xsplit, st));
  // dW_in = xn^T dpre, dW_out = gated^T dout: slices of the rows
  M2M_TRY(tc_gemm_wide(View{ws + pl.xn, 1, D}, View{ws + pl.dpre, F, 1}, ws + pl.p_win, D, F, R,
                       pl.wslice, pl.wsplit, st));
  M2M_TRY(tc_gemm_wide(View{ws + pl.gated, 1, H}, View{ws + pl.dout, D, 1}, ws + pl.p_wout, H, D,
                       R, pl.wslice, pl.wsplit, st));
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
  rj.job[2] = RedJob{ws + pl.p_sgu, B * pl.nsplit_bwd, NN + N, gq[6], NN, gq[7]};
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
