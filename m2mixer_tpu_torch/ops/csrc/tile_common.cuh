// Device code shared by the backward kernels (mixer_bwd.cu, gmlp.cu,
// dynamixer.cu) and the gMLP and DynaMixerOp forwards: a simple shared-memory
// tiled SIMT GEMM (64x64 output tiles, 4x4 outputs a thread, the depth summed
// in increasing order), the compensated (Kahan) sum, the LayerNorm backward
// over rows with its parameter gradients' per-tile partials, and row-sliced
// column sums and reductions of partials over several jobs a launch. No float atomics anywhere: every
// sum has one order, so two runs give bit-identical results.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mixer_common.cuh"

namespace {

constexpr int kTile = 64;   // GEMM output tile, rows and columns
constexpr int kTileK = 16;  // GEMM depth per shared-memory step
constexpr int kPad = 4;

// Compensated (Kahan) sum in a fixed order: the small gradients are sums over
// up to B*D terms (65536 at batch 512) whose value can be exactly zero (the
// token FF's output bias under a following LayerNorm), where a plain float32
// running sum would leave noise of ~1e-4.
struct Kahan {
  float s = 0.f, c = 0.f;
  __device__ __forceinline__ void add(float v) {
    const float y = v - c;
    const float t = s + y;
    c = (t - s) - y;
    s = t;
  }
};

// element (i, j) of a strided float32 matrix: p[i * rs + j * cs]
struct View {
  const float* p;
  long long rs, cs;
};

__device__ __forceinline__ float at(const View& v, int i, int j) {
  return v.p[(long long)i * v.rs + (long long)j * v.cs];
}

// acc (this thread's 4x4 of the 64x64 output tile at (m0, n0)) += sum over k in
// [k0, k1) of A(m, k) B(k, n), k in increasing order (deterministic)
__device__ void gemm_tile(const View& A, const View& Bv, int M, int Nn, int k0, int k1, int m0,
                          int n0, float (*As)[kTile + kPad], float (*Bs)[kTile + kPad],
                          float acc[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int kb = k0; kb < k1; kb += kTileK) {
    for (int i = threadIdx.x; i < kTileK * kTile; i += kThreads) {
      int kk, mm;  // neighbouring threads on neighbouring addresses
      if (A.cs == 1) {
        kk = i % kTileK;
        mm = i / kTileK;
      } else {
        mm = i % kTile;
        kk = i / kTile;
      }
      const int m = m0 + mm, k = kb + kk;
      As[kk][mm] = (m < M && k < k1) ? at(A, m, k) : 0.f;
    }
    for (int i = threadIdx.x; i < kTileK * kTile; i += kThreads) {
      int kk, nn;
      if (Bv.rs == 1) {
        kk = i % kTileK;
        nn = i / kTileK;
      } else {
        nn = i % kTile;
        kk = i / kTile;
      }
      const int n = n0 + nn, k = kb + kk;
      Bs[kk][nn] = (n < Nn && k < k1) ? at(Bv, k, n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// out[z] (M x Nn, row-major) = A B over k-slice z ([z*kslice, (z+1)*kslice) of K)
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(View A, View Bv, float* __restrict__ out, int M, int Nn, int K, int kslice) {
  __shared__ float As[kTileK][kTile + kPad], Bs[kTileK][kTile + kPad];
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int k0 = blockIdx.z * kslice, k1 = min(K, k0 + kslice);
  float acc[4][4] = {};
  gemm_tile(A, Bv, M, Nn, k0, k1, m0, n0, As, Bs, acc);
  float* o = out + (size_t)blockIdx.z * M * Nn;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (m < M && n < Nn) o[(size_t)m * Nn + n] = acc[i][j];
    }
}

// dst[d] = sum over the rows of a[r, d] * (xs[r, d] - mean[r]) * inv[r], and
// dst[D + d] = sum of a[r, d] (an LN's scale and bias gradients), rows in order
__device__ void ln_param_grads(const float* a, const float* xs, const float* mean,
                               const float* inv, int R, int D, float* dst) {
  for (int d = threadIdx.x; d < D; d += kThreads) {
    Kahan ds, db;
    for (int r = 0; r < R; ++r) {
      const float v = a[r * D + d];
      ds.add(v * (xs[r * D + d] - mean[r]) * inv[r]);
      db.add(v);
    }
    dst[d] = ds.s;
    dst[D + d] = db.s;
  }
}

// in place: a[r, :] <- base[r, :] + inv * (u - mean(u) - xhat * mean(u * xhat)) with
// u = a[r, :] * s, xhat = (xs[r, :] - mean[r]) * inv[r]: the LN backward, a warp per row
__device__ void ln_backward_rows(float* a, const float* base, const float* xs, const float* mean,
                                 const float* inv, const float* __restrict__ s, int R, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += kThreads / 32) {
    float su = 0.f, sux = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float u = a[r * D + d] * __ldg(s + d);
      su += u;
      sux += u * (xs[r * D + d] - mean[r]) * inv[r];
    }
    su = warp_sum(su) / D;
    sux = warp_sum(sux) / D;
    for (int d = lane; d < D; d += 32) {
      const float u = a[r * D + d] * __ldg(s + d);
      const float xh = (xs[r * D + d] - mean[r]) * inv[r];
      a[r * D + d] = base[r * D + d] + inv[r] * (u - su - xh * sux);
    }
  }
}

// LN backward on `tile` rows per CTA (dynamic shared memory: ln_bwd_smem_bytes):
// dx = base + the LN's backward of a, with a the sum of `ksplit` slices
// (a + k * rows * D, added in slice order) and base the residual's gradient,
// or zeros (nullptr); the CTA's partials of the LN's scale and bias gradients
// (2 x D) go to part[blockIdx.x]
__global__ void __launch_bounds__(kThreads)
    ln_bwd_kernel(const float* __restrict__ x, const float* __restrict__ a, int ksplit,
                  const float* __restrict__ base, const float* __restrict__ s,
                  float* __restrict__ dx, float* __restrict__ part, int rows, int D, int tile) {
  extern __shared__ __align__(16) float sm[];
  const int r0 = blockIdx.x * tile, R = min(tile, rows - r0);
  float* xs = sm;
  float* as = xs + tile * D;
  float* bs = as + tile * D;
  float* mean = bs + tile * D;
  float* inv = mean + tile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t off = (size_t)r0 * D, total = (size_t)rows * D;
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    xs[e] = x[off + e];
    bs[e] = base ? base[off + e] : 0.f;
    float v = 0.f;
    for (int k = 0; k < ksplit; ++k) v += a[k * total + off + e];
    as[e] = v;
  }
  __syncthreads();
  for (int r = warp; r < R; r += kThreads / 32) {
    float m, v;
    row_stats(xs + r * D, D, m, v);
    if (lane == 0) {
      mean[r] = m;
      inv[r] = v;
    }
  }
  __syncthreads();
  ln_param_grads(as, xs, mean, inv, R, D, part + (size_t)blockIdx.x * 2 * D);
  __syncthreads();
  ln_backward_rows(as, bs, xs, mean, inv, s, R, D);
  __syncthreads();
  for (int e = threadIdx.x; e < R * D; e += kThreads) dx[off + e] = as[e];
}

inline size_t ln_bwd_smem_bytes(int tile, int D) { return ((size_t)3 * tile * D + 2 * tile) * 4; }

// column sums over slices of the rows (the rows reach 50688 at batch 512, too
// many for one serial sum a column): job blockIdx.z writes part[y * C + c] =
// the sum over rows [y * rslice, (y + 1) * rslice) of a[r, c], rows in order.
// Used by gmlp.cu and dynamixer.cu (the mixer backward keeps its own one-array
// column sum: sharing this one made K1b/K2b 5-19% slower, PERF.md).
struct ColJob {
  const float* a;
  int C;
  float* part;
};
template <int kJobs>
struct ColJobs {
  ColJob job[kJobs];
};

template <int kJobs>
__global__ void __launch_bounds__(kThreads)
    col_slices_kernel(const __grid_constant__ ColJobs<kJobs> jobs, int R, int rslice) {
  const ColJob& jb = jobs.job[blockIdx.z];
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= jb.C) return;
  const int r0 = blockIdx.y * rslice, r1 = min(R, r0 + rslice);
  Kahan v;
  for (int r = r0; r < r1; ++r) v.add(jb.a[(size_t)r * jb.C + c]);
  jb.part[(size_t)blockIdx.y * jb.C + c] = v.s;
}

// a kernel's reductions of partials in one launch: job blockIdx.y sums its
// tiles x P partials in tile order, element p < len0 to out0[p], the rest to
// out1[p - len0]; the grid covers the longest job
struct RedJob {
  const float* part;
  int tiles, P;
  float* out0;
  int len0;
  float* out1;
};
template <int kJobs>
struct RedJobs {
  RedJob job[kJobs];
};

template <int kJobs>
__global__ void __launch_bounds__(kThreads)
    reduce_jobs_kernel(const __grid_constant__ RedJobs<kJobs> jobs) {
  const RedJob& jb = jobs.job[blockIdx.y];
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= jb.P) return;
  Kahan v;
  for (int t = 0; t < jb.tiles; ++t) v.add(jb.part[(size_t)t * jb.P + p]);
  if (p < jb.len0)
    jb.out0[p] = v.s;
  else
    jb.out1[p - jb.len0] = v.s;
}

#define M2M_TRY(expr)                          \
  do {                                         \
    cudaError_t e_ = (expr);                   \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)

}  // namespace
