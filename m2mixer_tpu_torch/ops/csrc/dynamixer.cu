// Fused DynaMixerOp forward (K4f) and backward (K4b) kernels for Hopper (sm_90a), float32
// and bf16 compute.
//
// Replaces the TPU Pallas kernels of m2mixer_tpu/ops/dynamixer_kernel.py:
//   m2m_dyna_fwd  <- fused_dynamixer_op's forward (_fwd_call: _fwd_kernel over _op_math)
//   m2m_dyna_bwd  <- fused_dynamixer_op's _bwd_rule (_bwd_kernel: jax.vjp of _op_math)
//
// One DynaMixerOp on x (S, L, C), S sequences of L tokens, H heads of C/H
// channels, R reduced features a head, in _op_math's order:
//   comp = x W_c + b_c (S*L, H*R), read as (S, L, H, R);
//   gin[s, h, l*R + r] = comp[s, l, h*R + r]; logit = gin W_g + b_g (S*H, L*L),
//   read as w[m, l] at m*L + l; P = softmax over m, the source token (axis -2);
//   mixed[s, l, c] = sum_m P[s, h(c), m, l] x[s, m, c], h(c) = c / (C/H);
//   y = mixed W_o^T + b_o.
// The weights come output-major, as a torch Linear stores them: W_c (H*R, C),
// W_g (L*L, L*R), W_o (C, C) with W_o[o][i] (the JAX kernel's input-major
// matrices transposed); the gradients come back in that layout.
//
// What bounds it on the H100. Per sequence the op does 2*L*C*(H*R + C) +
// 2*H*L*L*(L*R + C/H) flops; at the shipped shape (L = 7, C = 256, H = 8,
// R = 2) that is 1.01 MFLOP, 91% of it the C -> C output projection. At batch
// 512 (S = 3584 sequences) K4f is 3.62 GFLOP against 51 MB of x in and y out:
// in float32 54 us on the CUDA cores (67 TFLOP/s) against 15 us of HBM, so
// operations bound it; in bf16 the products take 4 us at the tensor cores'
// 989 TFLOP/s, so bytes do. K4b does about twice the work.
//
// One route at every shape, in both dtypes: every product runs over all rows
// through device memory, and what couples a sequence's tokens runs per
// (sequence, head) on one warp, with nothing of a sequence held in shared
// memory, so no L or C is too large (only rows beyond the products' grid are
// refused). The autograd Function saves only x, so the backward recomputes
// what it needs of the forward.
//   forward, 5 launches: (bf16) x and the three weights rounded to bf16 in
//   one launch, rows padded to 8 (x's copy xb, (S*L, Cp); the weights
//   transposed: the MN-major B operands of the engine's 64-wide tile, three
//   CTAs an SM, which the compress, generate and output products take, their
//   depths one to four 64-deep stages and their epilogues the larger part);
//   (float32) comp, then its relayout to gin; the compress product comp = x
//   W_c^T + b_c (bf16: its epilogue writes bf16(comp) straight into gin's
//   (S*H, L*R) layout); the generate product logit = gin W_g^T + b_g (S*H,
//   L*L) float32; dyna_mix_rows_kernel, a warp per (sequence, head): the
//   softmax over m in place (each lane a column l; the maximum over m
//   subtracted first), then mixed[l, c] = sum_m P[m, l] x[m, c] with the
//   lanes over the head's channels (bf16: stored rounded, the output
//   product's operand); the output projection, the bias in its epilogue.
//   backward, 13 launches in bf16 (float32: 14, the same on tc_gemm with the
//   relayout of d_gin to d_comp its own launch): x, g and the weights
//   rounded (the weights also as they lie), g split into three bf16 planes;
//   compress and generate recomputed; d_mixed = bf16(g W_o);
//   dyna_seq_rows_bwd_kernel per (sequence, head): the softmax, mixed (for
//   dW_o), the mix's part of dx, dP = d_mixed x^T (bf16: on mma.sync
//   m16n8k16, both operands bf16 values; float32: warp sums over the
//   channels), d_logit = P (dP - sum_m P dP) in float32 and as three bf16
//   planes; a unit whose L x L fits (L <= 22) keeps its weights and dP in
//   shared memory; d_gin = d_logit W_g (its epilogue lays bf16(d_gin) back into
//   d_comp's (S*L, H*R) layout); dx += bf16(d_comp W_c) (the 64-wide tile);
//   dW_c^T = x^T d_comp, dW_g = d_logit^T gin and dW_o = g^T mixed over
//   slices of their rows; the bias gradients' column sums (db_o and db_c,
//   then db_g; slices for eight CTAs an SM); one reduction of every partial
//   in slice order (each of a CTA's warp groups summing a run of slices).
//   float32: every product on the tensor cores in 3xTF32 through tc_gemm
//   (tile_common.cuh says why that split and why mma.sync rather than wgmma).
//   bf16: on the wgmma engine (wgmma_bf16.cuh: TMA into a swizzled ring, a
//   float32 add per 64-deep stage), all nine products. A float32 operand
//   (g for d_mixed and dW_o, d_logit for d_gin and dW_g) enters as three
//   bf16 planes, hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid),
//   summed smallest term first: each term times a bf16 operand is exact in
//   the float32 sum, so the product keeps float32 math where _op_math has a
//   float32 operand. Workspace operands are bf16 (x, the weights, gin,
//   mixed, d_mixed, d_comp, the planes), rows padded to 8 for TMA.
// No float atomics: partials are reduced in slice order, so two runs give
// bit-identical results.
//
// bf16 compute (kBF16; compute_dtype=bfloat16) computes what _op_math computes
// in bf16 (dynamixer_kernel.py:35-59) and what JAX's AD of it computes: x rounded
// to bf16; W_c, W_g and W_o rounded; comp + b_c rounded where the generate
// product casts it; the logits, the softmax and the mix in float32; mixed
// rounded where the output product casts it; biases added in float32. The
// backward rounds each cotangent of a bf16 operand: d_mixed = g W_o, d_gin =
// d_logit W_g^T, the mix's and the compress product's parts of dx (each,
// before their float32 sum), and dW_o, dW_c and dW_g (after the sum over the
// batch; JAX rounds per batch tile, which is the whole batch at its tile
// sizes); the bias gradients stay float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mixer_common.cuh"
#include "tile_common.cuh"
#include "wgmma_bf16.cuh"

namespace {

using bf16_t = __nv_bfloat16;

constexpr int kColSplit = 1024;  // row slices of the bias gradients' column sums, at most
constexpr int kRedSplit = 8;     // warp groups a CTA of the partials' reduction
constexpr int kWarps = kThreads / 32;

struct Weights {  // output-major (torch Linear's layout)
  const float* wc;  // (H*R, C)
  const float* bc;  // (H*R,)
  const float* wg;  // (L*L, L*R)
  const float* bg;  // (L*L,)
  const float* wo;  // (C, C)
  const float* bo;  // (C,)
};

// ------------------------------------------------------- the kernels
template <bool kBF16>
using Elem = std::conditional_t<kBF16, bf16_t, float>;

__device__ __forceinline__ float ld_f(const float* p) { return *p; }
__device__ __forceinline__ float ld_f(const bf16_t* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void st_f(bf16_t* p, float v) { *p = __float2bfloat16_rn(v); }

// bf16 copies of float32 matrices in one launch: job j rounds src (rows x
// cols, contiguous), or with `tr` its transpose (cols x rows), into `planes`
// bf16 planes of (its rows) x pitch (pitch a multiple of 8, zeros in the
// pad): one plane is bf16(v); three are hi = bf16(v), mid = bf16(v - hi), lo
// = bf16(v - hi - mid). A thread writes 8 neighbouring elements of a row (one
// 16-byte store a plane), reading them as two float4 where the source rows
// allow; the grid is flat, job j from CTA first[j].
constexpr int kRoundJobs = 8;
struct RoundJob {
  const float* src;
  bf16_t* dst;
  long long rows;  // the copy's rows (src's columns with tr)
  int cols, pitch, planes, tr;
  size_t plane;  // elements between planes
};
struct RoundJobs {
  RoundJob job[kRoundJobs];
  int first[kRoundJobs + 1];
  int n;
};

__global__ void __launch_bounds__(kThreads)
    round_rows_kernel(const __grid_constant__ RoundJobs rj) {
  int j = 0;
  while (j + 1 < rj.n && (int)blockIdx.x >= rj.first[j + 1]) ++j;
  const RoundJob& jb = rj.job[j];
  const long long q = (long long)(blockIdx.x - rj.first[j]) * kThreads + threadIdx.x;
  const int groups = jb.pitch / 8;
  if (q >= jb.rows * groups) return;
  const long long r = q / groups;
  const int c0 = (int)(q % groups) * 8;
  float in[8];
  if (!jb.tr && jb.cols % 4 == 0 && c0 + 8 <= jb.cols) {
    const float4* s4 = reinterpret_cast<const float4*>(jb.src + r * jb.cols + c0);
    const float4 a = __ldg(s4), b = __ldg(s4 + 1);
    in[0] = a.x, in[1] = a.y, in[2] = a.z, in[3] = a.w;
    in[4] = b.x, in[5] = b.y, in[6] = b.z, in[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = c0 + k;
      in[k] = c >= jb.cols ? 0.f
              : jb.tr      ? __ldg(jb.src + (long long)c * jb.rows + r)
                           : __ldg(jb.src + r * jb.cols + c);
    }
  }
  __align__(16) bf16_t out[3][8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float v = in[k];
    const bf16_t hi = __float2bfloat16_rn(v);
    out[0][k] = hi;
    if (jb.planes == 3) {
      const float rest = v - __bfloat162float(hi);
      const bf16_t mid = __float2bfloat16_rn(rest);
      out[1][k] = mid;
      out[2][k] = __float2bfloat16_rn(rest - __bfloat162float(mid));
    }
  }
  for (int t = 0; t < jb.planes; ++t)
    *reinterpret_cast<uint4*>(jb.dst + t * jb.plane + r * jb.pitch + c0) =
        *reinterpret_cast<const uint4*>(out[t]);
}

// float32 comp (S*L, H*R) <-> gin (S*H, L*R): to_gin, gin[(s H + h) L R + l R
// + r] = comp[(s L + l) H R + h R + r]; else the other way
__global__ void __launch_bounds__(kThreads)
    relayout_kernel(const float* __restrict__ src, float* __restrict__ dst, int S, int L, int H,
                    int R, int to_gin) {
  const int HR = H * R;
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (long long)S * L * HR) return;
  const long long s = e / ((long long)L * HR);
  const int l = (int)(e / HR % L), j = (int)(e % HR), h = j / R, r = j % R;
  const long long gi = ((s * H + h) * L + l) * R + r;
  if (to_gin)
    dst[gi] = src[e];
  else
    dst[e] = src[gi];
}

// P = softmax over m of a unit's logits (L x L, w[m, l] at m L + l), in
// place, a lane per column l
__device__ __forceinline__ void softmax_cols(float* p, int L, int lane) {
  for (int l = lane; l < L; l += 32) {
    float* col = p + l;
    float mx = -INFINITY;
    for (int m = 0; m < L; ++m) mx = fmaxf(mx, col[m * L]);
    float sum = 0.f;
    for (int m = 0; m < L; ++m) {
      const float e = expf(col[m * L] - mx);
      col[m * L] = e;
      sum += e;
    }
    for (int m = 0; m < L; ++m) col[m * L] = col[m * L] / sum;
  }
}

constexpr int kLB = 8;  // outputs a lane keeps in registers at once (a block of l or m)
// a unit's L x L weights (and in the backward their cotangents) are staged in
// its warp's shared memory where L*L <= kStageLL (L <= 22; the shipped 7 x 7
// grid), and read from device memory otherwise
constexpr int kStageLL = 512;

// n floats of a unit from src into its warp's shared memory at dst
__device__ __forceinline__ float* stage(const float* src, float* dst, int n, int lane) {
  for (int i = lane; i < n; i += 32) dst[i] = src[i];
  __syncwarp();
  return dst;
}

inline size_t stage_smem(int L, int per_unit) {
  return L * L <= kStageLL ? (size_t)kWarps * per_unit * L * L * 4 : 0;
}


// mixed[l, c] = sum_m P[m, l] x[m, c] for the lane's channel `col` of the
// unit's sequence (rows from `base`), ld elements a row; `ok` false: no store
template <class T>
__device__ __forceinline__ void mix_column(const float* p, const T* x, T* mixed, size_t base,
                                           int ld, int col, int L, bool ok) {
  if (!ok) return;
  for (int l0 = 0; l0 < L; l0 += kLB) {
    float acc[kLB] = {};
    for (int m = 0; m < L; ++m) {
      const float xv = ld_f(x + (base + m) * ld + col);
#pragma unroll
      for (int k = 0; k < kLB; ++k)
        if (l0 + k < L) acc[k] = fmaf(p[m * L + l0 + k], xv, acc[k]);
    }
#pragma unroll
    for (int k = 0; k < kLB; ++k)
      if (l0 + k < L) st_f(mixed + (base + l0 + k) * ld + col, acc[k]);
  }
}

// K4f's sequence step, a warp per unit (sequence s, head
// h): the softmax of the unit's logits (staged, or in place), then its
// channels of mixed (kBF16: x and mixed bf16, rows ld = Cp; else float32, ld
// = C)
template <bool kBF16>
__global__ void __launch_bounds__(kThreads)
    dyna_mix_rows_kernel(float* __restrict__ logits, const Elem<kBF16>* __restrict__ x,
                         Elem<kBF16>* __restrict__ mixed, int ld, int S, int L, int C, int H) {
  extern __shared__ __align__(16) float wsm[];  // stage_smem(L, 1)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, LL = L * L;
  const long long unit = (long long)blockIdx.x * kWarps + warp;
  if (unit >= (long long)S * H) return;
  const int h = (int)(unit % H), Ch = C / H;
  const size_t base = (size_t)(unit / H) * L;
  float* p = logits + unit * LL;
  if (LL <= kStageLL) p = stage(p, wsm + warp * LL, LL, lane);
  softmax_cols(p, L, lane);
  __syncwarp();
  for (int c0 = 0; c0 < Ch; c0 += 32)
    mix_column(p, x, mixed, base, ld, h * Ch + c0 + lane, L, c0 + lane < Ch);
}

// dP[m, l] = sum over the head's Ch channels (from c0) of x[m, c] d_mixed[l,
// c] for the unit's L x L (to dp), on the tensor cores: mma.sync m16n8k16
// with x as A (the tokens m its rows, the channels its depth) and d_mixed as
// B (the channels its depth, the tokens l its columns), both bf16 read from
// device memory (rows ld apart, from row base), each 16-deep step's sums
// added in float32; fragments past L or Ch are zeros
__device__ void dp_mma(const bf16_t* x, const bf16_t* dm, size_t base, int ld, int c0, int Ch,
                       int L, float* dp, int lane) {
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  auto pair = [&](const bf16_t* src, int row, int k) -> uint32_t {  // elements k, k + 1
    if (row >= L) return 0u;
    const bf16_t* p = src + (base + row) * ld + c0 + k;
    if (k + 1 < Ch && !((c0 + k) & 1)) return *reinterpret_cast<const uint32_t*>(p);
    const uint32_t lo = k < Ch ? __bfloat16_as_ushort(p[0]) : 0u;
    const uint32_t hi = k + 1 < Ch ? __bfloat16_as_ushort(p[1]) : 0u;
    return lo | hi << 16;
  };
  for (int m0 = 0; m0 < L; m0 += 16)
    for (int l0 = 0; l0 < L; l0 += 8) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < Ch; k0 += 16) {
        const uint32_t a[4] = {pair(x, m0 + g, k0 + t2), pair(x, m0 + g + 8, k0 + t2),
                               pair(x, m0 + g, k0 + t2 + 8), pair(x, m0 + g + 8, k0 + t2 + 8)};
        const uint32_t b[2] = {pair(dm, l0 + g, k0 + t2), pair(dm, l0 + g, k0 + t2 + 8)};
        mma_bf16(c, a, b);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + g + 8 * (e >> 1), l = l0 + t2 + (e & 1);
        if (m < L && l < L) dp[m * L + l] = c[e];
      }
    }
}

// K4b's sequence step, a warp per unit (s, h): the softmax
// (staged with dP, or in place in device memory); mixed (for dW_o); dx's mix
// part rd(sum_l P[m, l] d_mixed[l, c]) (dx float32, rows of C); dP[m, l] =
// sum over the head's channels of d_mixed[l, c] x[m, c] (kBF16: dp_mma; else
// warp sums over each 32 channels, the runs added in order), then d_logit =
// P (dP - sum_m P dP) into dlog and, kBF16, as three bf16 planes (rows lp
// apart, planes `plane` apart)
template <bool kBF16>
__global__ void __launch_bounds__(kThreads)
    dyna_seq_rows_bwd_kernel(float* __restrict__ logits, const Elem<kBF16>* __restrict__ x,
                             const Elem<kBF16>* __restrict__ dm, Elem<kBF16>* __restrict__ mixed,
                             int ld, float* __restrict__ dlog, bf16_t* __restrict__ planes, int lp,
                             size_t plane, float* __restrict__ dx, int S, int L, int C, int H) {
  extern __shared__ __align__(16) float wsm[];  // stage_smem(L, 2)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long unit = (long long)blockIdx.x * kWarps + warp;
  if (unit >= (long long)S * H) return;
  const int h = (int)(unit % H), Ch = C / H, LL = L * L;
  const size_t base = (size_t)(unit / H) * L;
  float* p = logits + unit * LL;
  float* dl = dlog + unit * LL;  // d_logit out
  float* dp = dl;                // dP's sums
  if (LL <= kStageLL) {
    p = stage(p, wsm + warp * 2 * LL, LL, lane);
    dp = p + LL;
  }
  softmax_cols(p, L, lane);
  if constexpr (kBF16) dp_mma(x, dm, base, ld, h * Ch, Ch, L, dp, lane);
  __syncwarp();
  for (int c0 = 0; c0 < Ch; c0 += 32) {
    const bool ok = c0 + lane < Ch;
    const int col = h * Ch + c0 + (ok ? lane : 0);
    mix_column(p, x, mixed, base, ld, col, L, ok);
    if (ok) {
      for (int m0 = 0; m0 < L; m0 += kLB) {
        float acc[kLB] = {};
        for (int l = 0; l < L; ++l) {
          const float dv = ld_f(dm + (base + l) * ld + col);
#pragma unroll
          for (int k = 0; k < kLB; ++k)
            if (m0 + k < L) acc[k] = fmaf(p[(m0 + k) * L + l], dv, acc[k]);
        }
#pragma unroll
        for (int k = 0; k < kLB; ++k)
          if (m0 + k < L) dx[(base + m0 + k) * C + col] = rd<kBF16>(acc[k]);
      }
    }
    if constexpr (!kBF16) {
      for (int m = 0; m < L; ++m) {
        const float xv = ok ? ld_f(x + (base + m) * ld + col) : 0.f;
        for (int l = 0; l < L; ++l) {
          const float v = warp_sum(ok ? xv * ld_f(dm + (base + l) * ld + col) : 0.f);
          if (lane == 0) dp[m * L + l] = c0 ? dp[m * L + l] + v : v;
        }
      }
    }
  }
  __syncwarp();
  for (int l = lane; l < L; l += 32) {
    float s = 0.f;
    for (int m = 0; m < L; ++m) s = fmaf(p[m * L + l], dp[m * L + l], s);
    for (int m = 0; m < L; ++m) {
      const float d = p[m * L + l] * (dp[m * L + l] - s);
      dl[m * L + l] = d;
      if constexpr (kBF16) {
        bf16_t* o = planes + unit * lp + m * L + l;
        const bf16_t hi = __float2bfloat16_rn(d);
        const float rest = d - __bfloat162float(hi);
        const bf16_t mid = __float2bfloat16_rn(rest);
        o[0] = hi;
        o[plane] = mid;
        o[2 * plane] = __float2bfloat16_rn(rest - __bfloat162float(mid));
      }
    }
  }
}

// the engine's epilogues (plain stores, a pair of columns c, c + 1 of row r)
// out[r * ld + c] = v + bias[c] (float32; the logits, y)
struct EpiBiasWg {
  static constexpr int kOuts = 0;
  const float* bias;
  float* out;
  int ld, N;
  __device__ __forceinline__ void operator()(const WgJob&, const WgArgs&, int, int r, int c,
                                             float v0, float v1) const {
    float* o = out + (size_t)r * ld + c;
    if (c + 1 < N && !(ld & 1)) {  // c even: one aligned pair
      *reinterpret_cast<float2*>(o) = make_float2(v0 + __ldg(bias + c), v1 + __ldg(bias + c + 1));
    } else {
      o[0] = v0 + __ldg(bias + c);
      if (c + 1 < N) o[1] = v1 + __ldg(bias + c + 1);
    }
  }
};

// comp row r = s L + l, columns j = h R + r' -> gin[(s H + h) lp + l R + r'] =
// bf16(v + b_c[j]) (the generate product's cast)
struct EpiGinWg {
  static constexpr int kOuts = 0;
  const float* bc;
  bf16_t* gin;
  int L, H, R, lp;
  __device__ __forceinline__ void operator()(const WgJob&, const WgArgs& a, int, int r, int c,
                                             float v0, float v1) const {
    const int s = r / L, l = r % L;
    const float v[2] = {v0, v1};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int j = c + k;
      if (j < a.N)
        gin[(size_t)(s * H + j / R) * lp + l * R + j % R] =
            __float2bfloat16_rn(v[k] + __ldg(bc + j));
    }
  }
};

// d_gin row r = s H + h, columns i = l R + r' -> d_comp[(s L + l) ld + h R +
// r'] = bf16(v) (the cotangent of gin's cast), also as float32 (rows of H R)
// for db_c
struct EpiDcompWg {
  static constexpr int kOuts = 0;
  bf16_t* dcb;
  float* dcf;
  int L, H, R, ld;
  __device__ __forceinline__ void operator()(const WgJob&, const WgArgs& a, int, int r, int c,
                                             float v0, float v1) const {
    const int s = r / H, h = r % H, HR = H * R;
    const float v[2] = {v0, v1};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = c + k;
      if (i < a.N) {
        const size_t row = (size_t)s * L + i / R;
        const int j = h * R + i % R;
        const bf16_t d = __float2bfloat16_rn(v[k]);
        dcb[row * ld + j] = d;
        dcf[row * HR + j] = __bfloat162float(d);
      }
    }
  }
};

// dx[r * N + c] += bf16(v): the compress product's part of dx beside the
// mix's (already in dx, rounded)
struct EpiDxWg {
  static constexpr int kOuts = 0;
  float* dx;
  __device__ __forceinline__ void operator()(const WgJob&, const WgArgs& a, int, int r, int c,
                                             float v0, float v1) const {
    float* o = dx + (size_t)r * a.N + c;
    if (c + 1 < a.N && !(a.N & 1)) {  // c even: one aligned pair
      const float2 d = *reinterpret_cast<const float2*>(o);
      *reinterpret_cast<float2*>(o) = make_float2(d.x + rd<true>(v0), d.y + rd<true>(v1));
    } else {
      o[0] += rd<true>(v0);
      if (c + 1 < a.N) o[1] += rd<true>(v1);
    }
  }
};

// d_mixed = bf16(g W_o), whole bf16 rows of Cp (W_o's pad columns are zeros)
struct EpiRoundWg {
  static constexpr int kOuts = 1;
  bf16_t* out;
  __device__ __forceinline__ bf16_t* dst(int) const { return out; }
  __device__ __forceinline__ void operator()(int, int, float v0, float v1,
                                             __nv_bfloat162 (&o)[kOuts]) const {
    o[0] = __floats2bfloat162_rn(v0, v1);
  }
};

// tc_gemm's epilogue of the float32 dx: dx[r * C + c] + v (the compress
// product's part beside the mix's)
struct EpiAddTo {
  const float* base;
  int ld;
  __device__ __forceinline__ float operator()(int r, int c, float v) const {
    return base[(size_t)r * ld + c] + v;
  }
};

// ------------------------------------------------------------------- plans
struct Plan {
  int sms;
  int Cp, LRp, LLp, HRp;  // bf16 rows: C, L*R, L*L and H*R rounded up to 8
  int wsplit, wslice;     // dW_o (float32: and dW_c): slices of the S*L rows
  int vsplit, vslice;     // bf16 dW_c: slices of the S*L rows
  int gsplit, gslice;     // dW_g: slices of the S*H rows
  int csplit, cslice;     // db_o, db_c: slices of the S*L rows
  int hsplit, hslice;     // db_g: slices of the S*H rows
  // workspace offsets in bytes (the bf16 operands, the float32
  // intermediates, the partials); fwd_bytes: what the forward needs
  size_t xb, wct, wgt, wot, comp, gin, logits, mixed, fwd_bytes;
  size_t wcb, wgb, wob;  // the backward's untransposed copies (bf16)
  size_t gp, dm, dlog, dlp, dgin, dcb, dcomp, p_wo, p_wc, p_wg, p_col, p_colg, bwd_bytes;
};

int check_args(int S, int L, int C, int H, int R) {
  if (S < 1 || L < 1 || C < 1 || H < 1 || R < 1 || C % H) return -1;
  if ((long long)S * L > 64LL * 65535 || (long long)S * H > 64LL * 65535) return -1;  // row tiles
  return 0;
}

inline int pad8(int n) { return (n + 7) / 8 * 8; }

// column-sum slices of R rows for `cols` columns: a slice is one thread's
// serial sum, so enough slices for eight CTAs an SM (summed by the split
// reduction), at least kTileK rows a slice, at most kColSplit slices
void col_plan(long long R, int cols, int sms, int& slice, int& split) {
  int cs = ceil_div(8 * sms, ceil_div(cols, kThreads));
  const int max_cs = ceil_div(R, kTileK);
  cs = cs > kColSplit ? kColSplit : cs;
  cs = cs > max_cs ? max_cs : cs;
  slice = ceil_div(R, cs);
  split = ceil_div(R, slice);
}

int make_plan(int S, int L, int C, int H, int R, int bf16, int device, Plan& pl) {
  DeviceInfo dev;
  const cudaError_t err = device_info(device, dev);
  if (err != cudaSuccess) return err;
  const int sms = dev.sms;
  pl = Plan{};
  pl.sms = sms;
  const long long rows = (long long)S * L, units = (long long)S * H;
  const int HR = H * R, LR = L * R, LL = L * L;
  pl.Cp = pad8(C), pl.LRp = pad8(LR), pl.LLp = pad8(LL), pl.HRp = pad8(HR);
  if (bf16) {
    wg_slices(rows, (long long)ceil_div(C, kWgBM) * ceil_div(C, kWgBN), sms, 1, pl.wslice,
              pl.wsplit);
    wg_slices(rows, (long long)ceil_div(C, kWgBM) * ceil_div(HR, 64), sms, 1, pl.vslice,
              pl.vsplit);
    wg_slices(units, (long long)ceil_div(LL, kWgBM) * ceil_div(LR, kWgBN), sms, 1, pl.gslice,
              pl.gsplit);
  } else {
    row_slices(rows, ceil_div(C, kTcBM) * ceil_div(C, kTcBN), sms, pl.wslice, pl.wsplit);
    row_slices(units, ceil_div(LL, kTcBM) * ceil_div(LR, kTcBN), sms, pl.gslice, pl.gsplit);
  }
  col_plan(rows, C > HR ? C : HR, sms, pl.cslice, pl.csplit);
  col_plan(units, LL, sms, pl.hslice, pl.hsplit);
  size_t o = 0;
  auto take = [&o](size_t bytes) {
    const size_t at = o;
    o += (bytes + 255) / 256 * 256;
    return at;
  };
  const size_t f = 4, b = 2;  // bytes of a float32, of a bf16
  if (bf16) {
    pl.xb = take(rows * pl.Cp * b);
    pl.wct = take((size_t)C * pl.HRp * b);
    pl.wgt = take((size_t)LR * pl.LLp * b);
    pl.wot = take((size_t)C * pl.Cp * b);
    pl.gin = take(units * pl.LRp * b);
    pl.logits = take(units * LL * f);
    pl.mixed = take(rows * pl.Cp * b);
    pl.fwd_bytes = o;
    pl.wcb = take((size_t)HR * pl.Cp * b);
    pl.wgb = take((size_t)LL * pl.LRp * b);
    pl.wob = take((size_t)C * pl.Cp * b);
    pl.gp = take(3 * rows * pl.Cp * b);
    pl.dm = take(rows * pl.Cp * b);
    pl.dlog = take(units * LL * f);
    pl.dlp = take(3 * units * pl.LLp * b);
    pl.dcb = take(rows * pl.HRp * b);
    pl.dcomp = take(rows * HR * f);
    pl.p_wc = take((size_t)pl.vsplit * C * HR * f);
  } else {
    pl.comp = take(rows * HR * f);
    pl.gin = take(units * LR * f);
    pl.logits = take(units * LL * f);
    pl.mixed = take(rows * C * f);
    pl.fwd_bytes = o;
    pl.dm = take(rows * C * f);
    pl.dlog = take(units * LL * f);
    pl.dgin = take(units * LR * f);
    pl.dcomp = take(rows * HR * f);
  }
  pl.p_wo = take((size_t)pl.wsplit * C * C * f);
  if (!bf16) pl.p_wc = take((size_t)pl.wsplit * C * HR * f);
  pl.p_wg = take((size_t)pl.gsplit * LL * LR * f);
  pl.p_colg = take((size_t)pl.hsplit * LL * f);
  pl.p_col = take((size_t)pl.csplit * (C + HR) * f);
  pl.bwd_bytes = o;
  return 0;
}

Weights weights(const void* const* q) {
  auto f = [q](int i) { return static_cast<const float*>(q[i]); };
  return Weights{f(0), f(1), f(2), f(3), f(4), f(5)};
}

// the bf16 rounding launch: x and the three weights transposed
// (the MN-major B operands of the 64-wide tiles: W_c^T, W_g^T, W_o^T); with g
// (the backward) also g as three planes and the weights as they lie (d_mixed's,
// d_gin's and dx's B operands)
cudaError_t round_inputs(const float* x, const float* g, const Weights& w, const Plan& pl,
                         uint8_t* ws, int S, int L, int C, int H, int R, cudaStream_t st) {
  const long long rows = (long long)S * L;
  const int HR = H * R, LR = L * R, LL = L * L;
  auto bf = [ws](size_t off) { return reinterpret_cast<bf16_t*>(ws + off); };
  RoundJobs rj = {};
  rj.job[0] = RoundJob{x, bf(pl.xb), rows, C, pl.Cp, 1, 0, 0};
  rj.job[1] = RoundJob{w.wc, bf(pl.wct), C, HR, pl.HRp, 1, 1, 0};
  rj.job[2] = RoundJob{w.wg, bf(pl.wgt), LR, LL, pl.LLp, 1, 1, 0};
  rj.job[3] = RoundJob{w.wo, bf(pl.wot), C, C, pl.Cp, 1, 1, 0};
  rj.n = 4;
  if (g) {
    rj.job[rj.n++] = RoundJob{g, bf(pl.gp), rows, C, pl.Cp, 3, 0, (size_t)rows * pl.Cp};
    rj.job[rj.n++] = RoundJob{w.wc, bf(pl.wcb), HR, C, pl.Cp, 1, 0, 0};
    rj.job[rj.n++] = RoundJob{w.wg, bf(pl.wgb), LL, LR, pl.LRp, 1, 0, 0};
    rj.job[rj.n++] = RoundJob{w.wo, bf(pl.wob), C, C, pl.Cp, 1, 0, 0};
  }
  rj.first[0] = 0;
  for (int j = 0; j < rj.n; ++j)
    rj.first[j + 1] = rj.first[j] + ceil_div(rj.job[j].rows * (rj.job[j].pitch / 8), kThreads);
  round_rows_kernel<<<rj.first[rj.n], kThreads, 0, st>>>(rj);
  return cudaGetLastError();
}

// one bf16 product on the engine: out = epi(A B) over the
// whole depth (one slice), A and B as make_job takes them, on the kBN-wide
// tile (64: three CTAs an SM, B MN-major; the products of one 64-deep stage
// or few, whose epilogues take as long as their sums)
template <bool kAK, bool kBK, int kTermsA, int kBN, class Epi>
cudaError_t wg_one(const WgOperand& a, const WgOperand& b, int M, int N, int K, const Epi& epi,
                   int device, cudaStream_t st) {
  WgArgs args = {};
  const cudaError_t e = make_job<kAK, kBK>(args.job[0], a, b, nullptr, 1.f);
  if (e != cudaSuccess) return e;
  args.M = M, args.N = N, args.K = K, args.kslice = ceil_div(K, kWgBK) * kWgBK, args.slices = 1;
  return wg_gemm<kAK, kBK, kTermsA, 1, 1, kBN>(args, 1, epi, device, st);
}

// a weight gradient's slices on the engine (MN-major operands, the rows the
// depth): out[z] = A^T B over slice z
template <int kTermsA, int kBN>
cudaError_t wg_grad(const WgOperand& a, const WgOperand& b, float* out, int M, int N, long long K,
                    int slice, int split, int device, cudaStream_t st) {
  WgArgs args = {};
  const cudaError_t e = make_job<false, false>(args.job[0], a, b, out, 1.f);
  if (e != cudaSuccess) return e;
  args.M = M, args.N = N, args.K = (int)K, args.kslice = slice, args.slices = split;
  return wg_gemm<false, false, kTermsA, 1, 1, kBN>(args, 1, EpiWgStore{}, device, st);
}

// the forward's products up to the logits (comp and gin; on the
// engine in bf16, tc_gemm in float32); the logits at ws + pl.logits
template <bool kBF16>
int rows_logits(const float* x, const Weights& w, const Plan& pl, uint8_t* ws, int S, int L,
                int C, int H, int R, int device, cudaStream_t st) {
  const long long rows = (long long)S * L, units = (long long)S * H;
  const int HR = H * R, LR = L * R, LL = L * L;
  float* logits = reinterpret_cast<float*>(ws + pl.logits);
  if constexpr (kBF16) {
    auto bf = [ws](size_t off) { return reinterpret_cast<const bf16_t*>(ws + off); };
    bf16_t* gin = reinterpret_cast<bf16_t*>(ws + pl.gin);
    // gin = bf16(x W_c^T + b_c) in gin's layout (dynamixer_kernel.py:45-47)
    M2M_TRY((wg_one<true, false, 1, 64>(WgOperand{{bf(pl.xb)}, 1, rows, C, pl.Cp},
                                        WgOperand{{bf(pl.wct)}, 1, C, HR, pl.HRp}, (int)rows, HR,
                                        C, EpiGinWg{w.bc, gin, L, H, R, pl.LRp}, device, st)));
    // logit = gin W_g^T + b_g (:47)
    return wg_one<true, false, 1, 64>(WgOperand{{gin}, 1, units, LR, pl.LRp},
                                      WgOperand{{bf(pl.wgt)}, 1, LR, LL, pl.LLp}, (int)units, LL,
                                      LR, EpiBiasWg{w.bg, logits, LL, LL}, device, st);
  } else {
    float* comp = reinterpret_cast<float*>(ws + pl.comp);
    float* gin = reinterpret_cast<float*>(ws + pl.gin);
    M2M_TRY((tc_gemm_auto<0, true>(View{x, C, 1}, View{w.wc, 1, C}, comp, (int)rows, HR, C, pl.sms,
                                  st, EpiBias{w.bc})));
    relayout_kernel<<<ceil_div(rows * HR, kThreads), kThreads, 0, st>>>(comp, gin, S, L, H, R, 1);
    M2M_TRY(cudaGetLastError());
    return tc_gemm_auto<0, true>(View{gin, LR, 1}, View{w.wg, 1, LR}, logits, (int)units, LL, LR,
                                 pl.sms, st, EpiBias{w.bg});
  }
}

template <bool kBF16>
int rows_fwd(const float* x, float* y, const Plan& pl, const Weights& w, uint8_t* ws, int S,
             int L, int C, int H, int R, int device, cudaStream_t st) {
  const long long rows = (long long)S * L, units = (long long)S * H;
  if (kBF16) M2M_TRY(round_inputs(x, nullptr, w, pl, ws, S, L, C, H, R, st));
  M2M_TRY_INT(rows_logits<kBF16>(x, w, pl, ws, S, L, C, H, R, device, st));
  Elem<kBF16>* mixed = reinterpret_cast<Elem<kBF16>*>(ws + pl.mixed);
  const Elem<kBF16>* xs = kBF16 ? reinterpret_cast<const Elem<kBF16>*>(ws + pl.xb)
                                : reinterpret_cast<const Elem<kBF16>*>(x);
  const int ld = kBF16 ? pl.Cp : C;
  dyna_mix_rows_kernel<kBF16><<<ceil_div(units, kWarps), kThreads, stage_smem(L, 1), st>>>(
      reinterpret_cast<float*>(ws + pl.logits), xs, mixed, ld, S, L, C, H);
  M2M_TRY(cudaGetLastError());
  // y = mixed W_o^T + b_o (dynamixer_kernel.py:58), W_o output-major
  if constexpr (kBF16) {
    return wg_one<true, false, 1, 64>(
        WgOperand{{mixed}, 1, rows, C, pl.Cp},
        WgOperand{{reinterpret_cast<const bf16_t*>(ws + pl.wot)}, 1, C, C, pl.Cp}, (int)rows, C,
        C, EpiBiasWg{w.bo, y, C, C}, device, st);
  } else {
    return tc_gemm_auto<0, true>(View{mixed, C, 1}, View{w.wo, 1, C}, y, (int)rows, C, C, pl.sms,
                                 st, EpiBias{w.bo});
  }
}

// the partials' reduction: dW_o, dW_c (transposed), db_o, db_c, dW_g and
// db_g, each CTA's warp groups summing runs of slices (a flat grid); in bf16
// the weight gradients rounded
int reduce_grads(const Plan& pl, uint8_t* ws, float* const* gq, int C, int H, int R, int L,
                 bool bf16, cudaStream_t st) {
  const int HR = H * R, LR = L * R, LL = L * L;
  const int rnd = bf16 ? kRnd0 : 0;
  auto fl = [ws](size_t off) { return reinterpret_cast<float*>(ws + off); };
  RedJobs<6> rj = {};
  rj.job[0] = RedJob{fl(pl.p_wo), pl.wsplit, C * C, gq[4], C * C, nullptr, rnd};
  rj.job[1] = RedJob{fl(pl.p_wc), bf16 ? pl.vsplit : pl.wsplit, C * HR, gq[0], C * HR, nullptr,
                     rnd, C};
  rj.job[2] = RedJob{fl(pl.p_col), pl.csplit, C, gq[5], C, nullptr, 0};
  rj.job[3] = RedJob{fl(pl.p_col) + (size_t)pl.csplit * C, pl.csplit, HR, gq[1], HR, nullptr, 0};
  rj.job[4] = RedJob{fl(pl.p_wg), pl.gsplit, LL * LR, gq[2], LL * LR, nullptr, rnd};
  rj.job[5] = RedJob{fl(pl.p_colg), pl.hsplit, LL, gq[3], LL, nullptr, 0};
  reduce_jobs_kernel<6, kRedSplit><<<flat_grid(rj, kRedSplit), kThreads, 0, st>>>(rj);
  return (int)cudaGetLastError();
}

template <bool kBF16>
int rows_bwd(const float* x, const float* g, float* dx, const Plan& pl, const Weights& w,
             float* const* gq, uint8_t* ws, int S, int L, int C, int H, int R, int device,
             cudaStream_t st) {
  const long long rows = (long long)S * L, units = (long long)S * H;
  const int HR = H * R, LR = L * R, LL = L * L;
  auto fl = [ws](size_t off) { return reinterpret_cast<float*>(ws + off); };
  auto bf = [ws](size_t off) { return reinterpret_cast<bf16_t*>(ws + off); };
  using T = Elem<kBF16>;
  T* dm = reinterpret_cast<T*>(ws + pl.dm);
  T* mixed = reinterpret_cast<T*>(ws + pl.mixed);
  const T* xs = kBF16 ? reinterpret_cast<const T*>(ws + pl.xb) : reinterpret_cast<const T*>(x);
  const int ld = kBF16 ? pl.Cp : C;
  const size_t gplane = (size_t)rows * pl.Cp, lplane = (size_t)units * pl.LLp;
  const bf16_t* gp = bf(pl.gp);  // bf16: g's three planes
  const WgOperand g_planes{{gp, gp + gplane, gp + 2 * gplane}, 3, rows, C, pl.Cp};
  if (kBF16) M2M_TRY(round_inputs(x, g, w, pl, ws, S, L, C, H, R, st));
  // comp, gin and the logits recomputed (dynamixer_kernel.py:45-47)
  M2M_TRY_INT(rows_logits<kBF16>(x, w, pl, ws, S, L, C, H, R, device, st));
  // d_mixed = g W_o (:58), g as three planes, rounded in bf16
  if constexpr (kBF16) {
    M2M_TRY((wg_one<true, false, 3, kWgBN>(g_planes, WgOperand{{bf(pl.wob)}, 1, C, pl.Cp, pl.Cp},
                                           (int)rows, pl.Cp, C, EpiRoundWg{dm}, device, st)));
  } else {
    M2M_TRY(tc_gemm_wide(View{g, C, 1}, View{w.wo, C, 1}, dm, (int)rows, C, C, C, 1, st));
  }
  // the sequence step (:48-57): mixed, dx's mix part, d_logit
  dyna_seq_rows_bwd_kernel<kBF16><<<ceil_div(units, kWarps), kThreads, stage_smem(L, 2), st>>>(
      fl(pl.logits), xs, dm, mixed, ld, fl(pl.dlog), kBF16 ? bf(pl.dlp) : nullptr, pl.LLp, lplane,
      dx, S, L, C, H);
  M2M_TRY(cudaGetLastError());
  if constexpr (kBF16) {
    const bf16_t* dl = bf(pl.dlp);
    const WgOperand dlog{{dl, dl + lplane, dl + 2 * lplane}, 3, units, LL, pl.LLp};
    // d_gin = d_logit W_g (:47), laid back as d_comp
    M2M_TRY((wg_one<true, false, 3, kWgBN>(dlog, WgOperand{{bf(pl.wgb)}, 1, LL, LR, pl.LRp},
                                           (int)units, LR, LL,
                                           EpiDcompWg{bf(pl.dcb), fl(pl.dcomp), L, H, R, pl.HRp},
                                           device, st)));
    // dx += bf16(d_comp W_c) (:45)
    M2M_TRY((wg_one<true, false, 1, 64>(WgOperand{{bf(pl.dcb)}, 1, rows, HR, pl.HRp},
                                        WgOperand{{bf(pl.wcb)}, 1, HR, C, pl.Cp}, (int)rows, C,
                                        HR, EpiDxWg{dx}, device, st)));
    // dW_c^T = x^T d_comp, dW_g = d_logit^T gin, dW_o = g^T mixed: slices of the rows
    M2M_TRY((wg_grad<1, 64>(WgOperand{{bf(pl.xb)}, 1, rows, C, pl.Cp},
                            WgOperand{{bf(pl.dcb)}, 1, rows, HR, pl.HRp}, fl(pl.p_wc), C, HR, rows,
                            pl.vslice, pl.vsplit, device, st)));
    M2M_TRY((wg_grad<3, kWgBN>(dlog, WgOperand{{bf(pl.gin)}, 1, units, LR, pl.LRp}, fl(pl.p_wg),
                               LL, LR, units, pl.gslice, pl.gsplit, device, st)));
    M2M_TRY((wg_grad<3, kWgBN>(g_planes, WgOperand{{bf(pl.mixed)}, 1, rows, C, pl.Cp},
                               fl(pl.p_wo), C, C, rows, pl.wslice, pl.wsplit, device, st)));
  } else {
    float* dgin = fl(pl.dgin);
    float* dcomp = fl(pl.dcomp);
    M2M_TRY(tc_gemm_wide(View{fl(pl.dlog), LL, 1}, View{w.wg, LR, 1}, dgin, (int)units, LR, LL,
                         LL, 1, st));
    relayout_kernel<<<ceil_div(rows * HR, kThreads), kThreads, 0, st>>>(dgin, dcomp, S, L, H, R,
                                                                       0);
    M2M_TRY(cudaGetLastError());
    M2M_TRY(tc_gemm_wide(View{dcomp, HR, 1}, View{w.wc, C, 1}, dx, (int)rows, C, HR, HR, 1, st,
                         EpiAddTo{dx, C}));
    M2M_TRY(tc_gemm_narrow(View{x, 1, C}, View{dcomp, HR, 1}, fl(pl.p_wc), C, HR, (int)rows,
                           pl.wslice, pl.wsplit, st));
    M2M_TRY(tc_gemm_wide(View{fl(pl.dlog), 1, LL}, View{fl(pl.gin), LR, 1}, fl(pl.p_wg), LL, LR,
                         (int)units, pl.gslice, pl.gsplit, st));
    M2M_TRY(tc_gemm_wide(View{g, 1, C}, View{mixed, C, 1}, fl(pl.p_wo), C, C, (int)rows,
                         pl.wslice, pl.wsplit, st));
  }
  // db_o, db_c, db_g: column sums over slices of the rows
  ColJobs<2> cj = {};
  cj.job[0] = ColJob{g, C, C, fl(pl.p_col)};
  cj.job[1] = ColJob{fl(pl.dcomp), HR, HR, fl(pl.p_col) + (size_t)pl.csplit * C};
  col_slices_kernel<2><<<dim3(ceil_div(C > HR ? C : HR, kThreads), pl.csplit, 2), kThreads, 0,
                         st>>>(cj, (int)rows, pl.cslice);
  M2M_TRY(cudaGetLastError());
  ColJobs<1> hj = {};
  hj.job[0] = ColJob{fl(pl.dlog), LL, LL, fl(pl.p_colg)};
  col_slices_kernel<1><<<dim3(ceil_div(LL, kThreads), pl.hsplit, 1), kThreads, 0, st>>>(
      hj, (int)units, pl.hslice);
  M2M_TRY(cudaGetLastError());
  return reduce_grads(pl, ws, gq, C, H, R, L, kBF16, st);
}

int dyna_fwd(const float* x, float* y, int S, int L, int C, int H, int R, int bf16, int device,
             const void* const* ptrs, void* workspace, void* stream) {
  if (check_args(S, L, C, H, R)) return -1;
  M2M_TRY(cudaSetDevice(device));
  Plan pl;
  const int code = make_plan(S, L, C, H, R, bf16, device, pl);
  if (code) return code;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* ws = static_cast<uint8_t*>(workspace);
  const Weights w = weights(ptrs);
  return (bf16 ? rows_fwd<true> : rows_fwd<false>)(x, y, pl, w, ws, S, L, C, H, R, device, st);
}

int dyna_bwd(const float* x, const float* g, float* dx, int S, int L, int C, int H, int R,
             int bf16, int device, const void* const* ptrs, void* const* grads, void* workspace,
             void* stream) {
  if (check_args(S, L, C, H, R)) return -1;
  M2M_TRY(cudaSetDevice(device));
  Plan pl;
  const int code = make_plan(S, L, C, H, R, bf16, device, pl);
  if (code) return code;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* ws = static_cast<uint8_t*>(workspace);
  const Weights w = weights(ptrs);
  float* const* gq = reinterpret_cast<float* const*>(grads);
  return (bf16 ? rows_bwd<true> : rows_bwd<false>)(x, g, dx, pl, w, gq, ws, S, L, C, H, R, device,
                                                   st);
}

}  // namespace

extern "C" {

// Workspace bytes of the DynaMixerOp forward (backward = 0) or backward in
// float32 or (bf16) bf16 compute (the wrapper allocates it); 0 for shapes the
// kernels do not take.
size_t m2m_dyna_workspace_bytes(int S, int L, int C, int H, int R, int backward, int bf16,
                                int device) {
  Plan pl;
  if (check_args(S, L, C, H, R) || make_plan(S, L, C, H, R, bf16, device, pl)) return 0;
  return backward ? pl.bwd_bytes : pl.fwd_bytes;
}

// Rows of the slices K4b sums dW_o and dW_c over, 0 for shapes the kernels do
// not take: what the 3xTF32 error is measured against.
int m2m_dyna_row_slice(int S, int L, int C, int H, int R, int device) {
  Plan pl;
  if (check_args(S, L, C, H, R) || make_plan(S, L, C, H, R, 0, device, pl)) return 0;
  return pl.wslice;
}

// K4f: y = DynaMixerOp(x), x and y (S, L, C) float32. ptrs: the 6 parameters
// in DynaMixerOpParams order (float32, the weights output-major); bf16: bf16
// compute; workspace: m2m_dyna_workspace_bytes(..., 0, ...) bytes.
int m2m_dyna_fwd(const float* x, float* y, int S, int L, int C, int H, int R, int bf16,
                 int device, const void* const* ptrs, void* workspace, void* stream) {
  return dyna_fwd(x, y, S, L, C, H, R, bf16, device, ptrs, workspace, stream);
}

// K4b: dx and the 6 parameter gradients (float32, DynaMixerOpParams order) of
// one DynaMixerOp at input x for output gradient g (the weight gradients
// output-major, as the weights); bf16: bf16 compute (the gradients rounded
// where JAX's AD rounds them); workspace: m2m_dyna_workspace_bytes(..., 1, ...)
// bytes.
int m2m_dyna_bwd(const float* x, const float* g, float* dx, int S, int L, int C, int H, int R,
                 int bf16, int device, const void* const* ptrs, void* const* grads,
                 void* workspace, void* stream) {
  return dyna_bwd(x, g, dx, S, L, C, H, R, bf16, device, ptrs, grads, workspace, stream);
}

}  // extern "C"
