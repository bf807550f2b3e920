// Device code shared by the backward kernels (mixer_bwd.cu, gmlp.cu,
// dynamixer.cu) and the float32 forwards, mixer_fwd.cu's too: the tensor-core GEMM
// tile, the compensated (Kahan) sum, the LayerNorm backward over rows with
// its parameter gradients' per-tile partials, and row-sliced column sums and
// reductions of partials over several jobs a launch. No float atomics
// anywhere: every sum has one order, so two runs give bit-identical results.
//
// The GEMM, tc_gemm: out[z] = epi(A B) over k-slice z on strided Views, the
// tile of every float32 product (K1f, K2f, K1b, K2b, K3f, K3b, K4f, K4b). Their
// bound is the rate of float32 multiply-adds: the CUDA cores give 67
// TFLOP/s, the tensor cores 495 in TF32, but a single TF32 product keeps
// about three decimal digits, too few for the 1e-4 relative gates the
// kernels are held to. So every product is 3xTF32: with x_big = tf32(x) and
// x_small = tf32(x - x_big) (cvt.rna.tf32.f32, in registers after the
// fragment loads), a b = a_small b_big + a_big b_small + a_big b_big, each an
// mma.sync.m16n8k8 TF32 product with float32 accumulation; the dropped
// a_small b_small is 2^-22 of the product, so the result is float32-accurate
// at a third of the TF32 rate. Operands reach shared memory through a 3-stage
// cp.async ring (dynamic shared memory, set by prepare()), 16 bytes a copy
// where both Views allow it (unit stride, rows of whole 16-byte groups,
// aligned), else 4; each stored with its View's unit-stride axis contiguous
// and padded so that the fragment loads hit 32 distinct banks.
// Tiles: 128x64 outputs on 8 warps (32x32 a warp); 64x64 on 4 warps, which
// tc_gemm_auto takes where the wide tile would leave SMs idle (the forwards'
// products and K1b's channel products at batch 32); 64x16 on 4 warps for
// narrow outputs (DynaMixerOp's 16-wide dW_c). The depth is summed in one
// order; k-slices are summed later by the reductions below, in slice order.
// Why mma.sync and not wgmma, for float32: wgmma takes tf32 operands only
// K-major in shared memory, and most backward products have an operand whose
// depth is not its contiguous axis (both operands of every weight gradient,
// whose depth is the rows); the big/small split would also have to be stored
// twice. That holds for tf32 and not for bf16, which wgmma also takes
// MN-major: the bf16 mixer backward's channel products run on wgmma
// (wgmma_bf16.cuh). mma.sync loads its fragments from shared memory in whatever layout
// the View gives and splits them in registers, so one loader serves every
// product. The forwards' weights (W_in, W_out, W_o) are small enough to be laid
// K-major once per call, which would lift that obstacle for their products;
// that is left to the work on the tile's own rate (ROADMAP.md).
// The bf16 kernels that are not on the wgmma engine (the token products of
// the mixer's backward, the DynaMixerOp's) run their products on this tile
// too: an operand that holds bf16 values is
// exact in TF32, so its small half is zero and the products with it go
// (kExact): two of the three remain where one operand is bf16 (2xTF32), one
// where both are (1xTF32, each mma's sum added to the accumulator in float32,
// see mma_3xtf32). Their operands stay float32 in memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mixer_common.cuh"

namespace {

constexpr int kTileK = 16;  // rows of a column-sum slice, at least (dynamixer.cu)

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

// ------------------------------------------------ tensor-core tile (3xTF32)
// x = big + small + O(2^-22 x), each part a TF32 bit pattern
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(rest));
}

// c (16x8, float32) += a (16x8, row) b (8x8, col), TF32 operands
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Operands exact in TF32 (kExact, a bit mask): a bf16 value is, so its small
// half is zero and the products with it can go. kExactA: A holds bf16 values,
// kExactB: B does.
constexpr int kExactA = 1, kExactB = 2;

// c += a b in 3xTF32: the small cross terms first (those of a non-exact
// operand), then the big one. Both operands inexact: 3 mma; one exact
// (2xTF32): 2; both: 1, into a zeroed accumulator that is then added to c in
// float32: the tensor core aligns its products to the accumulator's exponent
// and truncates, which against a running sum far above each product drops
// their low bits toward zero, where one float32 add per output rounds to
// nearest.
template <int kExact = 0>
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  if constexpr (kExact == (kExactA | kExactB)) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(t, a_big, b_big);
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] += t[i];
  } else {
    if constexpr (!(kExact & kExactA)) mma_tf32(c, a_small, b_big);
    if constexpr (!(kExact & kExactB)) mma_tf32(c, a_big, b_small);
    mma_tf32(c, a_big, b_big);
  }
}

// Fragments of mma.m16n8k8 (lane = 4 g + t). A (16x8): a[j] is element
// (g + 8 (j & 1), t + 4 (j >> 1)); B (8x8): b[j] is element (t + 4 j, g);
// C (16x8): c[j] is element (g + 8 (j >> 1), 2 t + (j & 1)). Element (r, k)
// of a shared-memory operand lies at p[r * rs + k * ks].
__device__ __forceinline__ void frag_a(const float* p, int rs, int ks, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    split_tf32(p[(g + 8 * (j & 1)) * rs + (t + 4 * (j >> 1)) * ks], big[j], small[j]);
}

// element (k, n) of the B operand at p[k * ks + n * ns]
__device__ __forceinline__ void frag_b(const float* p, int ks, int ns, uint32_t (&big)[2],
                                       uint32_t (&small)[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) split_tf32(p[(t + 4 * j) * ks + g * ns], big[j], small[j]);
}

// 4-byte asynchronous copy global -> shared; zero-fills when !ok (src unread)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}
// 16-byte asynchronous copy of the first `bytes` (0-16) at src, the rest zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

constexpr int kTcK = 32;      // depth of a stage
constexpr int kTcStages = 3;  // the cp.async ring

inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// Slicing a product's depth into k-slices (summed later in slice order).
constexpr int kMaxSplit = 32;  // slices for two CTAs an SM, at most
// The weight gradients' row slices: the 3xTF32 error of a slice's sum grows
// with its rows (PERF.md: K3b's dW_in 3.5e-5 of max(1, max|plain|) at 4576
// rows, 6.4e-5 at 9152), so no slice is longer than kMaxSliceRows, the
// longest the batch-512 plans take, in at most kMaxRowSplit slices
constexpr int kMaxSliceRows = 2304;
constexpr int kMaxRowSplit = 128;

// n slices (at least 1) of a depth K, each whole kTcK stages
inline void split_depth(long long K, int n, int& slice, int& split) {
  slice = ceil_div(ceil_div(K, n < 1 ? 1 : n), kTcK) * kTcK;
  split = ceil_div(K, slice);
}

// the depth K of a product with `tiles` wide-tile outputs: slices for two
// CTAs an SM, at most kMaxSplit
inline void fill_slices(long long K, int tiles, int sms, int& slice, int& split) {
  const int n = 2 * sms / tiles;
  split_depth(K, n > kMaxSplit ? kMaxSplit : n, slice, split);
}

// the R rows that a weight gradient with `tiles` wide-tile outputs sums:
// slices for two CTAs an SM, a whole multiple of that where a slice would
// pass kMaxSliceRows rows (the CTAs fill whole waves), at most kMaxRowSplit
// and at least 64 rows a slice
inline void row_slices(long long R, int tiles, int sms, int& slice, int& split) {
  int n = ceil_div(2 * sms, tiles);
  n = n > kMaxSplit ? kMaxSplit : n;
  n *= ceil_div(ceil_div(R, n), kMaxSliceRows);
  const int most = ceil_div(R, 64);
  n = n > kMaxRowSplit ? kMaxRowSplit : n;
  split_depth(R, n > most ? most : n, slice, split);
}

// a tile of kWM x kWN warps, each kMI x kNI mma tiles (16x8 outputs); kAK:
// A's depth axis contiguous in shared memory (else its rows), kBK the same for
// B; kVec: both operands copied 16 bytes at a time along their unit-stride
// axis (tc_gemm checks the strides and alignment), else 4 bytes
template <int kWM, int kWN, int kMI, int kNI, bool kAK, bool kBK, bool kVec>
struct TcTile {
  static constexpr int WM = kWM, MI = kMI, NI = kNI;
  static constexpr bool A_K = kAK, B_K = kBK;
  static constexpr int kThreadsT = 32 * kWM * kWN;
  static constexpr int BM = kWM * kMI * 16, BN = kWN * kNI * 8;
  // row strides in shared memory: = 4 (mod 32) along the depth, = 8 or 24
  // (mod 32) across it, so that a fragment's 32 loads fall in 32 banks
  static constexpr int lda = kAK ? kTcK + 4 : BM + 8;
  static constexpr int ldb = kBK ? kTcK + 4 : BN + 8;
  static constexpr int a_stage = kAK ? BM * lda : kTcK * lda;
  static constexpr int b_stage = kBK ? BN * ldb : kTcK * ldb;
  static constexpr size_t smem_bytes = (size_t)kTcStages * (a_stage + b_stage) * 4;
  static_assert(BM * kTcK % (4 * kThreadsT) == 0 && BN * kTcK % (4 * kThreadsT) == 0,
                "whole loads");
  static_assert(kBK || BN % 16 == 0, "row stride of B across the depth: BN + 8 = 8 or 24 mod 32");

  // the stage of depth [kb, kb + kTcK) (zeros past k1, M or N) into As, Bs;
  // neighbouring threads copy along each View's unit-stride axis
  static __device__ __forceinline__ void load(float* As, float* Bs, const View& A,
                                              const View& B, int M, int N, int kb, int k1,
                                              int m0, int n0) {
    if constexpr (kVec) {
#pragma unroll
      for (int s = 0; s < BM * kTcK / 4 / kThreadsT; ++s) {
        const int i = threadIdx.x + s * kThreadsT;
        const int kk = kAK ? i % (kTcK / 4) * 4 : i / (BM / 4);
        const int mm = kAK ? i / (kTcK / 4) : i % (BM / 4) * 4;
        const int m = m0 + mm, k = kb + kk;
        int n4 = kAK ? (m < M ? k1 - k : 0) : (k < k1 ? M - m : 0);
        n4 = n4 < 0 ? 0 : (n4 > 4 ? 4 : n4);
        cp_async16(As + (kAK ? mm * lda + kk : kk * lda + mm),
                   n4 ? A.p + (long long)m * A.rs + (long long)k * A.cs : A.p, 4 * n4);
      }
#pragma unroll
      for (int s = 0; s < BN * kTcK / 4 / kThreadsT; ++s) {
        const int i = threadIdx.x + s * kThreadsT;
        const int kk = kBK ? i % (kTcK / 4) * 4 : i / (BN / 4);
        const int nn = kBK ? i / (kTcK / 4) : i % (BN / 4) * 4;
        const int n = n0 + nn, k = kb + kk;
        int n4 = kBK ? (n < N ? k1 - k : 0) : (k < k1 ? N - n : 0);
        n4 = n4 < 0 ? 0 : (n4 > 4 ? 4 : n4);
        cp_async16(Bs + (kBK ? nn * ldb + kk : kk * ldb + nn),
                   n4 ? B.p + (long long)k * B.rs + (long long)n * B.cs : B.p, 4 * n4);
      }
    } else {
#pragma unroll
      for (int s = 0; s < BM * kTcK / kThreadsT; ++s) {
        const int i = threadIdx.x + s * kThreadsT;
        const int kk = kAK ? i % kTcK : i / BM, mm = kAK ? i / kTcK : i % BM;
        const int m = m0 + mm, k = kb + kk;
        const bool ok = m < M && k < k1;
        cp_async4(As + (kAK ? mm * lda + kk : kk * lda + mm),
                  ok ? A.p + (long long)m * A.rs + (long long)k * A.cs : A.p, ok);
      }
#pragma unroll
      for (int s = 0; s < BN * kTcK / kThreadsT; ++s) {
        const int i = threadIdx.x + s * kThreadsT;
        const int kk = kBK ? i % kTcK : i / BN, nn = kBK ? i / kTcK : i % BN;
        const int n = n0 + nn, k = kb + kk;
        const bool ok = n < N && k < k1;
        cp_async4(Bs + (kBK ? nn * ldb + kk : kk * ldb + nn),
                  ok ? B.p + (long long)k * B.rs + (long long)n * B.cs : B.p, ok);
      }
    }
  }
};

// epilogues: the stored value of output (r, c) with sum v
struct EpiNone {
  __device__ __forceinline__ float operator()(int, int, float v) const { return v; }
};
// dst = src rounded to bf16 (n floats): a weight's copy that the bf16 products
// read (bf16 values are exact in TF32: tc_gemm's kExact)
__global__ void __launch_bounds__(kThreads)
    round_copy_kernel(const float* __restrict__ src, float* __restrict__ dst, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) dst[i] = rd<true>(__ldg(src + i));
}

inline cudaError_t round_copy(const float* src, float* dst, int n, cudaStream_t st) {
  round_copy_kernel<<<ceil_div(n, kThreads), kThreads, 0, st>>>(src, dst, n);
  return cudaGetLastError();
}

// v rounded to the compute dtype (a product whose cotangent a bf16 cast rounds)
template <bool kBF16>
struct EpiRound {
  __device__ __forceinline__ float operator()(int, int, float v) const { return rd<kBF16>(v); }
};
// v + bias[c]
struct EpiBias {
  const float* bias;
  __device__ __forceinline__ float operator()(int, int c, float v) const {
    return v + __ldg(bias + c);
  }
};
// (v + bias[c]) times the keep-mask `mask` of block 0 at element r * ld + c
struct EpiBiasMask {
  const float* bias;
  int mask, ld;
  Dropout dp;
  __device__ __forceinline__ float operator()(int r, int c, float v) const {
    return (v + __ldg(bias + c)) * keep(dp, 0, mask, (uint32_t)((size_t)r * ld + c));
  }
};
// gelu of EpiBiasMask's value
struct EpiBiasMaskGelu {
  EpiBiasMask pre;
  int tanh_flavor;
  __device__ __forceinline__ float operator()(int r, int c, float v) const {
    return gelu(pre(r, c, v), tanh_flavor);
  }
};
// res[r * ld + c] + EpiBiasMask's value (a residual branch's output)
struct EpiResidual {
  EpiBiasMask branch;
  const float* res;
  __device__ __forceinline__ float operator()(int r, int c, float v) const {
    return __ldg(res + (size_t)r * branch.ld + c) + branch(r, c, v);
  }
};

// out[z] (M x N, row-major) = epi(A B) over k-slice z ([z*kslice, (z+1)*kslice)
// of K): one BM x BN tile a CTA, the depth in kTcK stages through the ring;
// kExact: the operands that hold bf16 values (mma_3xtf32)
template <class T, class Epi, int kExact>
__global__ void __launch_bounds__(T::kThreadsT, 512 / T::kThreadsT)  // <= 128 registers
    tc_gemm_kernel(View A, View B, float* __restrict__ out, int M, int N, int K, int kslice,
                   const __grid_constant__ Epi epi) {
  extern __shared__ __align__(16) float tsm[];
  float* As = tsm;
  float* Bs = tsm + kTcStages * T::a_stage;
  constexpr int MI = T::MI, NI = T::NI;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int k0 = blockIdx.z * kslice, k1 = min(K, k0 + kslice);
  const int nk = k1 > k0 ? (k1 - k0 + kTcK - 1) / kTcK : 0;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp % T::WM) * MI * 16, wn = (warp / T::WM) * NI * 8;
  float acc[MI][NI][4] = {};
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < nk)
      T::load(As + s * T::a_stage, Bs + s * T::b_stage, A, B, M, N, k0 + s * kTcK, k1, m0, n0);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();  // stage kt landed for every thread; stage kt - 1 is free
    const int next = kt + kTcStages - 1;
    if (next < nk) {
      const int slot = next % kTcStages;
      T::load(As + slot * T::a_stage, Bs + slot * T::b_stage, A, B, M, N, k0 + next * kTcK, k1,
              m0, n0);
    }
    cp_async_commit();
    const float* as = As + (kt % kTcStages) * T::a_stage;
    const float* bs = Bs + (kt % kTcStages) * T::b_stage;
#pragma unroll
    for (int ks = 0; ks < kTcK; ks += 8) {
      uint32_t ab[MI][4], asm_[MI][4], bb[NI][2], bsm[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int r = wm + i * 16;
        if constexpr (T::A_K)
          frag_a(as + r * T::lda + ks, T::lda, 1, ab[i], asm_[i]);
        else
          frag_a(as + ks * T::lda + r, 1, T::lda, ab[i], asm_[i]);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int c = wn + j * 8;
        if constexpr (T::B_K)
          frag_b(bs + c * T::ldb + ks, 1, T::ldb, bb[j], bsm[j]);
        else
          frag_b(bs + ks * T::ldb + c, T::ldb, 1, bb[j], bsm[j]);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
          mma_3xtf32<kExact>(acc[i][j], ab[i], asm_[i], bb[j], bsm[j]);
    }
  }
  cp_async_wait<0>();
  float* o = out + (size_t)blockIdx.z * M * N;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wm + i * 16 + g + 8 * (e >> 1), c = n0 + wn + j * 8 + 2 * t + (e & 1);
        if (r < M && c < N) o[(size_t)r * N + c] = epi(r, c, acc[i][j][e]);
      }
}

template <class T, int kExact, class Epi>
cudaError_t tc_gemm_launch(const View& A, const View& B, float* out, int M, int N, int K,
                           int kslice, int ksplit, cudaStream_t st, const Epi& epi) {
  const cudaError_t e = prepare(tc_gemm_kernel<T, Epi, kExact>, T::smem_bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, ksplit);
  tc_gemm_kernel<T, Epi, kExact><<<grid, T::kThreadsT, T::smem_bytes, st>>>(A, B, out, M, N, K,
                                                                              kslice, epi);
  m2m_count(kTallyTcGemm);
  return cudaGetLastError();
}

template <int kWM, int kWN, int kMI, int kNI, bool kAK, bool kBK, int kExact, class Epi>
cudaError_t tc_gemm_layout(const View& A, const View& B, float* out, int M, int N, int K,
                           int kslice, int ksplit, cudaStream_t st, const Epi& epi, bool vec) {
  if (vec)
    return tc_gemm_launch<TcTile<kWM, kWN, kMI, kNI, kAK, kBK, true>, kExact>(
        A, B, out, M, N, K, kslice, ksplit, st, epi);
  return tc_gemm_launch<TcTile<kWM, kWN, kMI, kNI, kAK, kBK, false>, kExact>(
      A, B, out, M, N, K, kslice, ksplit, st, epi);
}

// can `v` be copied 16 bytes at a time along its unit-stride axis (rows if
// `unit_cols`, else columns), from a 16-byte-aligned start every 4 elements?
inline bool vec_ok(const View& v, bool unit_cols) {
  const long long unit = unit_cols ? v.cs : v.rs, other = unit_cols ? v.rs : v.cs;
  return unit == 1 && other % 4 == 0 && reinterpret_cast<uintptr_t>(v.p) % 16 == 0;
}

// out[z] (M x N) = epi(A B) over k-slice z < ksplit of kslice rows of the depth
// K, on the tile of kWM x kWN warps of kMI x kNI mma tiles; each operand lies
// in shared memory with its View's unit-stride axis contiguous; kExact: the
// operands that hold bf16 values (mma_3xtf32)
template <int kWM, int kWN, int kMI, int kNI, int kExact = 0, class Epi = EpiNone>
cudaError_t tc_gemm(const View& A, const View& B, float* out, int M, int N, int K, int kslice,
                    int ksplit, cudaStream_t st, const Epi& epi = Epi()) {
  const bool ak = A.cs == 1, bk = B.rs == 1;
  // 16-byte copies: unit strides, 16-byte rows and slices starting at multiples of 4
  const bool vec = vec_ok(A, ak) && vec_ok(B, !bk) && (ksplit == 1 || kslice % 4 == 0);
  if (ak && bk)
    return tc_gemm_layout<kWM, kWN, kMI, kNI, true, true, kExact>(A, B, out, M, N, K, kslice,
                                                                  ksplit, st, epi, vec);
  if (ak)
    return tc_gemm_layout<kWM, kWN, kMI, kNI, true, false, kExact>(A, B, out, M, N, K, kslice,
                                                                   ksplit, st, epi, vec);
  if (bk)
    return tc_gemm_layout<kWM, kWN, kMI, kNI, false, true, kExact>(A, B, out, M, N, K, kslice,
                                                                   ksplit, st, epi, vec);
  return tc_gemm_layout<kWM, kWN, kMI, kNI, false, false, kExact>(A, B, out, M, N, K, kslice,
                                                                  ksplit, st, epi, vec);
}

// the tiles: 128x64 outputs on 8 warps, 64x64 on 4, and 64x16 for narrow outputs
constexpr int kTcBM = 128, kTcBN = 64;  // the wide tile's outputs
template <int kExact = 0, class Epi = EpiNone>
cudaError_t tc_gemm_wide(const View& A, const View& B, float* out, int M, int N, int K,
                         int kslice, int ksplit, cudaStream_t st, const Epi& epi = Epi()) {
  return tc_gemm<4, 2, 2, 4, kExact>(A, B, out, M, N, K, kslice, ksplit, st, epi);
}
template <int kExact = 0, class Epi = EpiNone>
cudaError_t tc_gemm_narrow(const View& A, const View& B, float* out, int M, int N, int K,
                           int kslice, int ksplit, cudaStream_t st, const Epi& epi = Epi()) {
  return tc_gemm<4, 1, 1, 2, kExact>(A, B, out, M, N, K, kslice, ksplit, st, epi);
}

// The tile rule: the wide tile, unless its CTAs (over ksplit slices) would be
// fewer than the card's `sms`; then the 64x64 one, which gives twice as many.
inline bool tc_small_tile(int M, int N, int ksplit, int sms) {
  const long long wide = (long long)((M + kTcBM - 1) / kTcBM) * ((N + kTcBN - 1) / kTcBN) * ksplit;
  return wide < sms;
}

// out = epi(A B) over the whole depth K on the layout of the forwards'
// products, A (M x K) with unit column stride (rows in memory) and B (K x N)
// with unit column stride, or (kBK) unit row stride (a weight stored output-
// major, as a torch Linear's), and the tile by the rule above: one layout
// instantiated per tile (tc_gemm instantiates four). Any strides are right;
// other layouts are only copied 4 bytes at a time.
template <int kExact = 0, bool kBK = false, class Epi>
cudaError_t tc_gemm_auto(const View& A, const View& B, float* out, int M, int N, int K, int sms,
                         cudaStream_t st, const Epi& epi) {
  const bool vec = vec_ok(A, true) && vec_ok(B, !kBK);
  if (tc_small_tile(M, N, 1, sms))
    return tc_gemm_layout<2, 2, 2, 4, true, kBK, kExact>(A, B, out, M, N, K, K, 1, st, epi, vec);
  return tc_gemm_layout<4, 2, 2, 4, true, kBK, kExact>(A, B, out, M, N, K, K, 1, st, epi, vec);
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
// u = a[r, :] * s, xhat = (xs[r, :] - mean[r]) * inv[r]: the LN backward, a warp per row.
// kBF16: s rounded to bf16 as the forward reads it, the LN's own gradient rounded
// to bf16 (the transpose of the cast of its input), and so is the sum with base.
template <bool kBF16 = false>
__device__ void ln_backward_rows(float* a, const float* base, const float* xs, const float* mean,
                                 const float* inv, const float* __restrict__ s, int R, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += kThreads / 32) {
    float su = 0.f, sux = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float u = a[r * D + d] * rd<kBF16>(__ldg(s + d));
      su += u;
      sux += u * (xs[r * D + d] - mean[r]) * inv[r];
    }
    su = warp_sum(su) / D;
    sux = warp_sum(sux) / D;
    for (int d = lane; d < D; d += 32) {
      const float u = a[r * D + d] * rd<kBF16>(__ldg(s + d));
      const float xh = (xs[r * D + d] - mean[r]) * inv[r];
      a[r * D + d] = rd<kBF16>(base[r * D + d] + rd<kBF16>(inv[r] * (u - su - xh * sux)));
    }
  }
}

// LN backward on `tile` rows per CTA (dynamic shared memory: ln_bwd_smem_bytes):
// dx = base + the LN's backward of a, with a the sum of `ksplit` slices
// (a + k * rows * D, added in slice order) and base the residual's gradient,
// or zeros (nullptr); the CTA's partials of the LN's scale and bias gradients
// (2 x D) go to part[blockIdx.x]. kBF16: an LN of bf16 compute (its output
// cast back to float32), so a is rounded to bf16 first (the transpose of that
// cast), then as ln_backward_rows<true>; the LN's input x and base are read
// rounded to bf16 (the forward's rounded input, the cotangent of a bf16 value).
template <bool kBF16>
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
    xs[e] = rd<kBF16>(x[off + e]);
    bs[e] = base ? rd<kBF16>(base[off + e]) : 0.f;
    float v = 0.f;
    for (int k = 0; k < ksplit; ++k) v += a[k * total + off + e];
    as[e] = rd<kBF16>(v);
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
  ln_backward_rows<kBF16>(as, bs, xs, mean, inv, s, R, D);
  __syncthreads();
  for (int e = threadIdx.x; e < R * D; e += kThreads) dx[off + e] = as[e];
}

inline size_t ln_bwd_smem_bytes(int tile, int D) { return ((size_t)3 * tile * D + 2 * tile) * 4; }

// column sums over slices of the rows (the rows reach 50688 at batch 512, too
// many for one serial sum a column): job blockIdx.z writes part[y * C + c] =
// the sum over rows [y * rslice, (y + 1) * rslice) of a[r, c] (rows ld floats
// apart), rows in order
struct ColJob {
  const float* a;
  int C, ld;
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
  for (int r = r0; r < r1; ++r) v.add(jb.a[(size_t)r * jb.ld + c]);
  jb.part[(size_t)blockIdx.y * jb.C + c] = v.s;
}

// a kernel's reductions of partials in one launch: job blockIdx.y sums its
// tiles x P partials in tile order, element p < len0 to out0[p], the rest to
// out1[p - len0]; rnd rounds to bf16 (a gradient that a bf16 cast transposes)
// the out0 elements (bit kRnd0) and the out1 ones (kRnd1); tr: 0, or the rows
// of out0's partials read as a tr x (len0 / tr) matrix, which out0 receives
// transposed; the grid covers the longest job. kSplit > 1 (2, 4 or 8): each
// of a CTA's kSplit warp groups sums one run of the tiles of the same
// kThreads / kSplit elements (neighbouring threads on neighbouring elements)
// and the first group adds the runs in order, for jobs of many tiles (the
// bf16 gMLP's 32-row tiles), whose one chain of loads would set the launch's
// time; the same order every run. Its grid is flat: job j takes the CTAs
// from first[j] (flat_grid), so no job pays for the longest one's CTAs.
constexpr int kRnd0 = 1, kRnd1 = 2;
struct RedJob {
  const float* part;
  int tiles, P;
  float* out0;
  int len0;
  float* out1;
  int rnd;
  int tr;
};
template <int kJobs>
struct RedJobs {
  RedJob job[kJobs];
  int first[kJobs + 1];  // kSplit > 1: each job's first CTA, then the grid's size
};

// the flat grid of reduce_jobs_kernel<kJobs, kSplit> (kSplit > 1): CTAs of
// kThreads / kSplit elements, job after job; returns its size
template <int kJobs>
int flat_grid(RedJobs<kJobs>& rj, int kSplit) {
  const int elems = kThreads / kSplit;
  rj.first[0] = 0;
  for (int j = 0; j < kJobs; ++j)
    rj.first[j + 1] = rj.first[j] + (rj.job[j].P + elems - 1) / elems;
  return rj.first[kJobs];
}

template <int kJobs, int kSplit = 1>
__global__ void __launch_bounds__(kThreads)
    reduce_jobs_kernel(const __grid_constant__ RedJobs<kJobs> jobs) {
  static_assert(kSplit == 1 || kSplit == 2 || kSplit == 4 || kSplit == 8, "warp groups");
  constexpr int kElems = kThreads / kSplit;  // elements a CTA
  int j = blockIdx.y, block = blockIdx.x;
  if constexpr (kSplit > 1) {  // the flat grid
    j = 0;
    while (j + 1 < kJobs && (int)blockIdx.x >= jobs.first[j + 1]) ++j;
    block -= jobs.first[j];
  }
  const RedJob& jb = jobs.job[j];
  const int sub = threadIdx.x / kElems;
  const int p = block * kElems + threadIdx.x % kElems;
  Kahan v;
  if constexpr (kSplit == 1) {
    if (p >= jb.P) return;
    for (int t = 0; t < jb.tiles; ++t) v.add(jb.part[(size_t)t * jb.P + p]);
  } else {
    __shared__ float runs[kSplit][kElems];
    const int run = (jb.tiles + kSplit - 1) / kSplit;
    const int t1 = min(jb.tiles, (sub + 1) * run);
    if (p < jb.P)
      for (int t = sub * run; t < t1; ++t) v.add(jb.part[(size_t)t * jb.P + p]);
    runs[sub][threadIdx.x % kElems] = v.s;
    __syncthreads();
    if (sub || p >= jb.P) return;
    v = Kahan{};
    for (int k = 0; k < kSplit; ++k) v.add(runs[k][threadIdx.x]);
  }
  if (p < jb.len0) {
    const int cols = jb.tr ? jb.len0 / jb.tr : 0;
    jb.out0[jb.tr ? (p % cols) * jb.tr + p / cols : p] = jb.rnd & kRnd0 ? rd<true>(v.s) : v.s;
  } else {
    jb.out1[p - jb.len0] = jb.rnd & kRnd1 ? rd<true>(v.s) : v.s;
  }
}

#define M2M_TRY(expr)                          \
  do {                                         \
    cudaError_t e_ = (expr);                   \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)
// the same for a step that returns an int code (0: success)
#define M2M_TRY_INT(expr)                      \
  do {                                         \
    const int c_ = (expr);                     \
    if (c_) return c_;                         \
  } while (0)

}  // namespace
