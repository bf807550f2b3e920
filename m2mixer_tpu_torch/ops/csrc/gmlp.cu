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
// recomputed forward: operations bound both. Both run their products on the
// tensor cores in 3xTF32 (tile_common.cuh says why that split and why
// mma.sync rather than wgmma): the forward's two GEMMs (steps 2 and 5) and the
// backward's five (steps 2, 3, 6, 7, 8) on tc_gemm, the forward's by the tile
// rule of tc_gemm_auto (the 64x64 tile where the wide one would leave SMs
// idle, at batch 32). The two SGU kernels share their staging, LN(v) and token
// projection (sgu_setup, sgu_stage, sgu_normalize, sgu_token_proj): sgu_w in
// shared memory, a chunk's v columns staged by cp.async and normalized in
// place, t = v' sgu_w as mma.sync from shared memory; the backward adds its
// two other products (dv' = dt sgu_w^T, d sgu_w += v'^T dt), d sgu_w's partial
// in registers across the chunks and written once. Tokens are padded to whole
// m16 tiles (49 -> 64, 99 -> 112) with zeros. The rest (the gate, LN(v) and
// its backward, column sums, reductions) is CUDA-core work on memory
// (PERF.md). The forward stores h = gelu(pm), not pm: each GELU is then taken
// once, where reading pm would take it in the statistics, the normalization
// and the gate (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mixer_common.cuh"
#include "tile_common.cuh"

namespace {

constexpr int kMaxSeq = 128;   // tokens a sample may have
constexpr int kChunk = 64;     // v-channels per SGU chunk, 8 a warp
constexpr int kRowTile = 32;   // rows per CTA of the LN backward kernels
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
// kWC: warp (wm, wc) owns the token tiles wm + 4i (m16, kMT of them in all)
// and the kCB v-channel blocks kCB wc + j (8 wide).
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
        gated[((size_t)b * N + n) * H + c] = us[at] * ((dts[at] + sb[n]) * m1);
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
  int sms;              // the card's SMs (the tile rule of the forward's products)
  int nsplit;           // SGU CTAs per sample
  int xsplit, xslice;   // dxn: slices of F
  int wsplit, wslice;   // dW_in, dW_out, db_in, db_out: slices of the rows
  int tiles;            // row tiles of the LN backward kernels
  bool wide_sgu;        // the SGU kernels on 16 warps (8 m16 token tiles), else 8 (4)
  size_t sgu_fwd_smem, sgu_bwd_smem, vln_smem, ln_smem;
  // workspace offsets (floats)
  size_t xn, act, gated, vstats, dout, dg, dpre, dxnp, p_ln, p_vln, p_sgu, p_win, p_wout, p_col;
  size_t fwd_floats, bwd_floats;
};

int check_args(int B, int N, int D, int F) {
  if (B < 1 || B > 65535 || N < 1 || N > kMaxSeq || D < 1 || F < 2 || F % 2) return -1;
  const unsigned long long big = (unsigned long long)B * N * (F > D ? F : D);
  if (big >= (1ull << 32)) return -1;  // the dropout masks count their elements in 32 bits
  return 0;
}

int make_plan(int B, int N, int D, int F, int device, Plan& pl) {
  DeviceInfo dev;
  const cudaError_t err = device_info(device, dev);
  if (err != cudaSuccess) return err;
  const int sms = dev.sms;
  pl.sms = sms;
  const int H = F / 2;
  const long long R = (long long)B * N;
  const int chunks = ceil_div(H, kChunk);
  const int ns = ceil_div(2 * sms, B);
  pl.nsplit = ns < 1 ? 1 : (ns > chunks ? chunks : ns);
  pl.wide_sgu = sgu_layout(N, false).nm > 64;
  pl.sgu_fwd_smem = sgu_layout(N, false).floats * 4;
  pl.sgu_bwd_smem = sgu_layout(N, true).floats * 4;
  pl.vln_smem = (size_t)2 * kRowTile * H * 4;
  pl.ln_smem = ln_bwd_smem_bytes(kRowTile, D);
  if (pl.sgu_bwd_smem > (size_t)dev.smem_optin || pl.vln_smem > (size_t)dev.smem_optin ||
      pl.ln_smem > (size_t)dev.smem_optin)
    return -1;
  // dxn = dpre W_in^T: (rows x D) tiles x slices of F
  fill_slices(F, ceil_div(R, kTcBM) * ceil_div(D, kTcBN), sms, pl.xslice, pl.xsplit);
  // the weight gradients: dW_in's few tiles x slices of the rows
  row_slices(R, ceil_div(D, kTcBM) * ceil_div(F, kTcBN), sms, pl.wslice, pl.wsplit);
  pl.tiles = ceil_div(R, kRowTile);
  const size_t rows = (size_t)R;
  size_t o = 0;
  pl.xn = o, o += rows * D;
  pl.act = o, o += rows * F;
  pl.gated = o, o += rows * H;
  pl.vstats = o, o += 2 * rows;
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

}  // namespace

extern "C" {

// Workspace bytes of the gMLP forward (backward = 0) or backward (the wrapper
// allocates it); 0 for shapes the kernels do not take.
size_t m2m_gmlp_workspace_bytes(int B, int N, int D, int F, int backward, int device) {
  Plan pl;
  if (check_args(B, N, D, F) || make_plan(B, N, D, F, device, pl)) return 0;
  return (backward ? pl.bwd_floats : pl.fwd_floats) * 4;
}

// Rows of the slices K3b sums its weight gradients over (dW_in, dW_out), 0
// for shapes the kernels do not take: what the 3xTF32 error is measured against.
int m2m_gmlp_row_slice(int B, int N, int D, int F, int device) {
  Plan pl;
  if (check_args(B, N, D, F) || make_plan(B, N, D, F, device, pl)) return 0;
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
// dropout (4 stream keys of block 0, or keys == nullptr for none); workspace:
// m2m_gmlp_workspace_bytes(..., 0, ...) bytes.
int m2m_gmlp_fwd(const float* x, float* y, int B, int N, int D, int F, int tanh_flavor,
                 const unsigned* keys, unsigned thresh, float scale, int device,
                 const void* const* ptrs, void* workspace, void* stream) {
  if (check_args(B, N, D, F)) return -1;
  M2M_TRY(cudaSetDevice(device));
  Plan pl;
  const int code = make_plan(B, N, D, F, device, pl);
  if (code) return code;
  // m16 token tiles: 8 on 16 warps, else 4 on 8 warps
  auto sgu_fwd = pl.wide_sgu ? sgu_fwd_kernel<8, 4> : sgu_fwd_kernel<4, 2>;
  M2M_TRY(prepare(sgu_fwd, pl.sgu_fwd_smem, device));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout dp = make_dropout(keys, 1, thresh, scale);
  float* ws = static_cast<float*>(workspace);
  const int R = B * N, H = F / 2;
  auto q = [ptrs](int i) { return static_cast<const float*>(ptrs[i]); };
  // 1. xn = LN(x)
  ln_rows_kernel<<<ceil_div(R, kThreads / 32), kThreads, 0, st>>>(x, q(0), q(1), ws + pl.xn,
                                                                  nullptr, nullptr, R, D, dp);
  M2M_TRY(cudaGetLastError());
  // 2. h = gelu((xn W_in + b_in) m0) (gmlp_kernel.py:62-65)
  M2M_TRY(tc_gemm_auto(View{ws + pl.xn, D, 1}, View{q(2), F, 1}, ws + pl.act, R, F, D, pl.sms,
                       st, EpiBiasMaskGelu{EpiBiasMask{q(3), kMaskIn, F, dp}, tanh_flavor}));
  // 3. LN(v)'s statistics (:68)
  vstats_kernel<false><<<ceil_div(R, kThreads / 32), kThreads, 0, st>>>(ws + pl.act,
                                                                        ws + pl.vstats, R, F, 0);
  M2M_TRY(cudaGetLastError());
  // 4. gated = u (LN(v) sgu_w + sgu_b) m1 (:67-75)
  sgu_fwd<<<dim3(pl.nsplit, B), pl.wide_sgu ? 512 : 256, pl.sgu_fwd_smem, st>>>(
      ws + pl.act, ws + pl.vstats, ws + pl.gated, sgu_params(ptrs), N, F, dp);
  M2M_TRY(cudaGetLastError());
  // 5. y = x + (gated W_out + b_out) m2 (:77-80)
  return tc_gemm_auto(View{ws + pl.gated, H, 1}, View{q(8), D, 1}, y, R, D, H, pl.sms, st,
                      EpiResidual{EpiBiasMask{q(9), kMaskOut, D, dp}, x});
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
  const int code = make_plan(B, N, D, F, device, pl);
  if (code) return code;
  auto sgu_bwd = pl.wide_sgu ? sgu_bwd_kernel<8, 4> : sgu_bwd_kernel<4, 2>;
  M2M_TRY(prepare(sgu_bwd, pl.sgu_bwd_smem, device));
  M2M_TRY(prepare(vln_bwd_kernel, pl.vln_smem, device));
  M2M_TRY(prepare(ln_bwd_kernel<false>, pl.ln_smem, device));
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
  vstats_kernel<true><<<ceil_div(R, kThreads / 32), kThreads, 0, st>>>(ws + pl.act,
                                                                       ws + pl.vstats, R, F,
                                                                       tanh_flavor);
  M2M_TRY(cudaGetLastError());
  sgu_bwd<<<dim3(pl.nsplit, B), pl.wide_sgu ? 512 : 256, pl.sgu_bwd_smem, st>>>(
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
  cj.job[0] = ColJob{ws + pl.dpre, F, F, ws + pl.p_col};
  cj.job[1] = ColJob{ws + pl.dout, D, D, ws + pl.p_col + (size_t)pl.wsplit * F};
  col_slices_kernel<2><<<dim3(ceil_div(F > D ? F : D, kThreads), pl.wsplit, 2), kThreads, 0, st>>>(
      cj, R, pl.wslice);
  M2M_TRY(cudaGetLastError());
  // the LN backward over D plus the residual g (:61, :80), dxn's slices in order
  ln_bwd_kernel<false><<<pl.tiles, kThreads, pl.ln_smem, st>>>(
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
