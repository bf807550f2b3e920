// Fused MixerBlock / mixer-stack forward kernels for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels of m2mixer_tpu/ops/mixer_kernel.py:
//   mixer_block_fwd  <- fused_mixer_block forward (_fwd_kernel over _block_math)
//   mixer_stack_fwd  <- fused_mixer_stack forward (_stack_fwd_kernel over _stack_math)
//
// One block computes, on x (B, N, D) in float32:
//   LN1 -> token FF over N (N->T, GELU, T->N) -> +residual
//   -> LN2 -> channel FF over D (D->C, GELU, C->D) -> +residual
// and the stack runs K such blocks, optionally followed by a final LN, in ONE
// launch. Casts follow _block_math exactly: in bf16 the residual stream, the
// LN outputs and every GEMM operand are rounded to bf16, LN statistics, GEMM
// sums, biases and GELU stay float32.
//
// Design. A row tile of `tb` whole samples (R = tb * N rows; the token mix
// couples a sample's N tokens) runs on a cluster of S CTAs (S = 1, 2 or 4,
// chosen at launch with tb so that the grid fills the SMs in one wave). The
// activation tile stays in each CTA's shared memory for the whole stack: x/x1
// (R x D), the LN output z (R x D) and a channel-FF accumulator (R x D). All
// CTAs of a cluster compute LN1, the token mix and LN2 on the same rows (a few
// percent of the work); the channel FF is split over the hidden units: CTA
// `rank` takes chunks rank, rank + S, ... of kChunk units each, computes
// h = gelu(z W3[:, c:c+kChunk] + b3) into shared memory (R x kChunk) and folds
// it into its partial acc += h W4[c:c+kChunk, :], so the R x C hidden activation
// never reaches device memory. The partials meet through distributed shared
// memory: each CTA sums an S-th of the tile over the S partials in rank order
// (deterministic) and writes the finished residual into every CTA's tile.
// Weight chunks stream from L2 (one encoder's float32 weights are ~12.6 MB, L2
// holds 50 MB) with cp.async (16-byte copies where rows are 16-byte aligned)
// into two buffers, so the next W3 chunk loads while the current W4 product
// runs and the next W4 chunk loads while the next W3 product runs. A block's
// first chunks are requested before its LN1, and the token FF reads its small
// weights from shared memory, so neither waits on the weight stream. The rows
// each thread carries through the channel FF are a template parameter (1..16),
// so a small tile costs less than a large one.
//
// What bounds it on the H100. Per block the channel FF does 4*R*D*C flops
// against ~D*C*8 bytes of float32 weights (D*C*4 in bf16), so at the served
// batch sizes the float32 work is arithmetic on the CUDA cores (67 TFLOP/s
// peak); at the tensor cores' bf16 rate the weight bytes bound batch 32. This
// kernel runs bf16 on the CUDA cores too (products of bf16 values are exact in
// float32, sums are float32) rather than the tensor cores. The products are
// plain FMA with no TF32. At the served batches a tile has few rows, and a CTA
// that walked all 48 chunks of C alone would be latency-bound on its shared-
// memory loads and on the weight stream; splitting C over a cluster of 4 gives
// each CTA 12 chunks and 4x the CTAs for the same rows. The loops stay latency-
// bound per chunk, several times off the bound (PERF.md). Tensor-core mma/wgmma
// for bf16 and TMA are left for a later change.
//
// Limits checked by the wrapper and again here: N <= kMaxTokens, D % 4 == 0,
// C even for bf16 weights, K <= kMaxBlocks, shared memory <= the opt-in limit.
//
// Training. Dropout multiplies by the four masks of mixer_common.cuh where
// _block_math does, and with `saved` the stack writes every block's input (and
// the output before its final LN) to device memory: the backward kernels
// (mixer_bwd.cu) read those instead of running the stack again. Dropout is a
// template flag: the rate-0 kernels (serving) contain no mask code at all.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mixer_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 64;                           // hidden units per channel-FF step
constexpr int kRowGroups = kThreads / kChunk;        // 4 rows in flight per column
constexpr int kRowsMax = 64;                         // rows (tb * N) one CTA may own
constexpr int kRowsPerThread = kRowsMax / kRowGroups;
constexpr int kMaxCluster = 4;  // CTAs that may split one row tile's hidden units C

struct BlockPtrs {
  const float* ln1_s;
  const float* ln1_b;
  const float* w1;  // (N, T)
  const float* b1;  // (T,)
  const float* w2;  // (T, N)
  const float* b2;  // (N,)
  const float* ln2_s;
  const float* ln2_b;
  const void* w3;   // (D, C), float or bf16
  const float* b3;  // (C,)
  const void* w4;   // (C, D), float or bf16
  const float* b4;  // (D,)
};

struct StackArgs {
  BlockPtrs blocks[kMaxBlocks];
  const float* lnf_s;
  const float* lnf_b;
  float* saved;  // training: the input of every block and the pre-LN output, or nullptr
  Dropout dp;
};

// cp.async of W3[:, c0:c0+kChunk] (D x kChunk, zero past C) into dst, in BYTES-wide
// copies; a copy never straddles C (C is a multiple of its width)
template <int BYTES, typename WT>
__device__ void copy_w3(WT* dst, const WT* w3, int D, int C, int c0) {
  constexpr int per = BYTES / sizeof(WT);
  constexpr int units_per_row = kChunk / per;
  for (int u = threadIdx.x; u < D * units_per_row; u += kThreads) {
    const int d = u / units_per_row, j = (u - d * units_per_row) * per;
    const int c = c0 + j;
    const bool ok = c < C;
    __pipeline_memcpy_async(dst + d * kChunk + j, ok ? w3 + (size_t)d * C + c : w3, BYTES,
                            ok ? 0 : BYTES);
  }
}

// cp.async of W4[c0:c0+kChunk, :] (kChunk x D, zero past C) into dst
template <int BYTES, typename WT>
__device__ void copy_w4(WT* dst, const WT* w4, int D, int C, int c0) {
  constexpr int per = BYTES / sizeof(WT);
  const int units_per_row = D / per;
  for (int u = threadIdx.x; u < kChunk * units_per_row; u += kThreads) {
    const int j = u / units_per_row, d = (u - j * units_per_row) * per;
    const int c = c0 + j;
    const bool ok = c < C;
    __pipeline_memcpy_async(dst + j * D + d, ok ? w4 + (size_t)c * D + d : w4, BYTES,
                            ok ? 0 : BYTES);
  }
}

// 16-byte copies where the rows allow them (C = 3072), 4-byte ones otherwise (C = 3078)
template <typename WT>
__device__ void fetch_w3(WT* dst, const WT* w3, int D, int C, int c0) {
  if ((C * sizeof(WT)) % 16 == 0)
    copy_w3<16>(dst, w3, D, C, c0);
  else
    copy_w3<4>(dst, w3, D, C, c0);
}

template <typename WT>
__device__ void fetch_w4(WT* dst, const WT* w4, int D, int C, int c0) {
  if ((D * sizeof(WT)) % 16 == 0)
    copy_w4<16>(dst, w4, D, C, c0);
  else
    copy_w4<4>(dst, w4, D, C, c0);
}

// hs (R x kChunk) = rd(gelu(zs W3chunk + b3) * m2), zero for hidden units past C; the
// tile's rows are rows row0g.. of the batch (they key mask 2 of block `blk`)
template <bool kBF16, bool kDrop, int RPT, typename WT>
__device__ void channel_up(const float* zs, const WT* w3s, float* hs, int R, int D, int C, int c0,
                           const float* __restrict__ b3, int tanh_flavor, const Dropout& dp,
                           int blk, uint32_t row0g) {
  const int col = threadIdx.x & (kChunk - 1), row0 = threadIdx.x / kChunk;
  float a[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) a[i] = 0.f;
  for (int k = 0; k < D; k += 4) {
    const float w0 = tof(w3s[(k + 0) * kChunk + col]);
    const float w1 = tof(w3s[(k + 1) * kChunk + col]);
    const float w2 = tof(w3s[(k + 2) * kChunk + col]);
    const float w3 = tof(w3s[(k + 3) * kChunk + col]);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = row0 + i * kRowGroups;
      if (r < R) {
        const float4 z = *reinterpret_cast<const float4*>(zs + r * D + k);
        a[i] = fmaf(z.x, w0, a[i]);
        a[i] = fmaf(z.y, w1, a[i]);
        a[i] = fmaf(z.z, w2, a[i]);
        a[i] = fmaf(z.w, w3, a[i]);
      }
    }
  }
  const int c = c0 + col;
  const bool ok = c < C;
  const float bias = ok ? __ldg(b3 + c) : 0.f;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = row0 + i * kRowGroups;
    if (r < R)
      hs[r * kChunk + col] =
          ok ? rd<kBF16>(gelu(a[i] + bias, tanh_flavor) *
                         keep<kDrop>(dp, blk, 2, (row0g + r) * (uint32_t)C + c))
             : 0.f;
  }
}

// accs (R x D) += hs (R x kChunk) W4chunk (kChunk x D)
template <int RPT, typename WT>
__device__ void channel_down(const float* hs, const WT* w4s, float* accs, int R, int D) {
  const int col = threadIdx.x & (kChunk - 1), row0 = threadIdx.x / kChunk;
  for (int d0 = 0; d0 < D; d0 += kChunk) {
    const int d = d0 + col;
    if (d >= D) continue;
    float a[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = row0 + i * kRowGroups;
      a[i] = r < R ? accs[r * D + d] : 0.f;
    }
    for (int k = 0; k < kChunk; k += 4) {
      const float w0 = tof(w4s[(k + 0) * D + d]);
      const float w1 = tof(w4s[(k + 1) * D + d]);
      const float w2 = tof(w4s[(k + 2) * D + d]);
      const float w3 = tof(w4s[(k + 3) * D + d]);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = row0 + i * kRowGroups;
        if (r < R) {
          const float4 h = *reinterpret_cast<const float4*>(hs + r * kChunk + k);
          a[i] = fmaf(h.x, w0, a[i]);
          a[i] = fmaf(h.y, w1, a[i]);
          a[i] = fmaf(h.z, w2, a[i]);
          a[i] = fmaf(h.w, w3, a[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = row0 + i * kRowGroups;
      if (r < R) accs[r * D + d] = a[i];
    }
  }
}

struct Tile {
  float* xs;    // residual stream (R x D)
  float* zs;    // LN output (R x D)
  float* accs;  // channel-FF accumulator (R x D)
  float* hs;    // hidden chunk (R x kChunk)
  void* w3s;    // W3 chunk (D x kChunk)
  void* w4s;    // W4 chunk (kChunk x D)
  float* tw;    // token-FF weights (w1, b1, w2, b2)
};

// one MixerBlock on the tile held in shared memory (xs in, xs out). The S CTAs
// of a cluster hold the same rows and compute LN1, the token mix and LN2
// redundantly; CTA `rank` runs the channel FF over hidden chunks rank, rank + S,
// ... into its own partial accumulator. The partials are summed through
// distributed shared memory in rank order (deterministic), each CTA summing an
// S-th of the tile and writing the finished residual into every CTA's xs.
// RPT: rows per thread in the channel FF (rows of the tile / 4, a compile-time
// bound so that no predicated-off row costs an instruction).
template <bool kBF16, bool kDrop, int RPT>
__device__ void block_forward(const Tile& t, const BlockPtrs& p, int R, int nb, int N, int T, int D,
                              int C, int tanh_flavor, const Dropout& dp, int blk, int s0) {
  using WT = typename std::conditional<kBF16, __nv_bfloat16, float>::type;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), S = (int)cluster.num_blocks();
  WT* w3s = static_cast<WT*>(t.w3s);
  WT* w4s = static_cast<WT*>(t.w4s);
  const WT* w3 = static_cast<const WT*>(p.w3);
  const WT* w4 = static_cast<const WT*>(p.w4);
  const int nchunks = (C + kChunk - 1) / kChunk;

  // this CTA's first weight chunks load under LN1 and the token mix
  if (rank < nchunks) fetch_w3(w3s, w3, D, C, rank * kChunk);
  __pipeline_commit();
  if (rank < nchunks) fetch_w4(w4s, w4, D, C, rank * kChunk);
  __pipeline_commit();

  load_token_weights<kBF16>(t.tw, TokenPtrs{p.w1, p.b1, p.w2, p.b2}, N, T);
  layer_norm_rows<kBF16>(t.xs, t.zs, R, D, p.ln1_s, p.ln1_b);
  __syncthreads();
  token_mix<kBF16, kDrop>(t.zs, t.xs, nb, N, T, D, t.tw, tanh_flavor, dp, blk, s0);
  __syncthreads();
  layer_norm_rows<kBF16>(t.xs, t.zs, R, D, p.ln2_s, p.ln2_b);
  for (int e = threadIdx.x; e < R * D; e += kThreads) t.accs[e] = 0.f;

  for (int ci = rank; ci < nchunks; ci += S) {
    const int c0 = ci * kChunk;
    const int next = ci + S;
    __pipeline_wait_prior(1);  // this thread's part of W3 chunk ci has landed
    __syncthreads();
    channel_up<kBF16, kDrop, RPT, WT>(t.zs, w3s, t.hs, R, D, C, c0, p.b3, tanh_flavor, dp, blk,
                               (uint32_t)s0 * N);
    __syncthreads();
    if (next < nchunks) fetch_w3(w3s, w3, D, C, next * kChunk);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // W4 chunk ci has landed
    __syncthreads();
    channel_down<RPT, WT>(t.hs, w4s, t.accs, R, D);
    __syncthreads();
    if (next < nchunks) fetch_w4(w4s, w4, D, C, next * kChunk);
    __pipeline_commit();
  }
  __pipeline_wait_prior(0);

  cluster.sync();  // every partial accumulator of the cluster is complete
  const int per = (R * D + S - 1) / S;
  const int lo = rank * per, hi = min(R * D, lo + per);
  for (int e = lo + threadIdx.x; e < hi; e += kThreads) {
    float sum = 0.f;
    for (int r = 0; r < S; ++r) sum += cluster.map_shared_rank(t.accs, r)[e];
    const float m3 = keep<kDrop>(dp, blk, 3, (uint32_t)s0 * N * D + e);
    const float v = rd<kBF16>(t.xs[e] + rd<kBF16>((sum + __ldg(p.b4 + e % D)) * m3));
    for (int r = 0; r < S; ++r) cluster.map_shared_rank(t.xs, r)[e] = v;
  }
  cluster.sync();  // every CTA holds the block's output
}

// this CTA's share [lo, hi) of the tile's R*D elements: each CTA of a cluster
// writes one share to device memory
__device__ __forceinline__ void tile_share(int R, int D, int& lo, int& hi) {
  const int rank = (int)cg::this_cluster().block_rank();
  const int S = (int)cg::this_cluster().num_blocks();
  const int per = (R * D + S - 1) / S;
  lo = rank * per;
  hi = min(R * D, lo + per);
}

__device__ __forceinline__ void save_share(const float* xs, float* dst, int R, int D) {
  int lo, hi;
  tile_share(R, D, lo, hi);
  for (int e = lo + threadIdx.x; e < hi; e += kThreads) dst[e] = xs[e];
}

// kSave: the stack may save its block inputs (args.saved); the one-block kernel
// never does, and is compiled without that code
template <bool kBF16, bool kDrop, bool kSave, int RPT>
__device__ void tile_forward(const float* __restrict__ x, float* __restrict__ out, int B, int N,
                             int T, int D, int C, int tb, int n_blocks, int final_ln,
                             int tanh_flavor, const StackArgs& args) {
  using WT = typename std::conditional<kBF16, __nv_bfloat16, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows_cap = tb * N;
  Tile t;
  t.xs = reinterpret_cast<float*>(smem);
  t.zs = t.xs + rows_cap * D;
  t.accs = t.zs + rows_cap * D;
  t.hs = t.accs + rows_cap * D;
  t.w3s = t.hs + rows_cap * kChunk;
  t.w4s = static_cast<WT*>(t.w3s) + D * kChunk;
  t.tw = reinterpret_cast<float*>(static_cast<WT*>(t.w4s) + D * kChunk);

  const int s0 = (blockIdx.x / (int)cg::this_cluster().num_blocks()) * tb;
  const int nb = min(tb, B - s0);
  const int R = nb * N;
  const float* xg = x + (size_t)s0 * N * D;
  float* og = out + (size_t)s0 * N * D;

  for (int e = threadIdx.x; e < R * D; e += kThreads) t.xs[e] = rd<kBF16>(xg[e]);
  __syncthreads();
  const size_t slot = (size_t)B * N * D;  // one saved block input
#pragma unroll 1
  for (int k = 0; k < n_blocks; ++k) {
    if constexpr (kSave) {  // training: keep the block's input for the backward kernels
      if (args.saved) save_share(t.xs, args.saved + k * slot + (size_t)s0 * N * D, R, D);
    }
    block_forward<kBF16, kDrop, RPT>(t, args.blocks[k], R, nb, N, T, D, C, tanh_flavor, args.dp,
                                     k, s0);
  }
  if constexpr (kSave) {  // and the stack's output before its final LN
    if (args.saved) save_share(t.xs, args.saved + n_blocks * slot + (size_t)s0 * N * D, R, D);
  }
  // each CTA of the cluster writes its share of the tile
  int lo, hi;
  tile_share(R, D, lo, hi);
  if (final_ln) {
    layer_norm_rows<kBF16>(t.xs, t.zs, R, D, args.lnf_s, args.lnf_b);
    __syncthreads();
    for (int e = lo + threadIdx.x; e < hi; e += kThreads) og[e] = t.zs[e];
  } else {
    for (int e = lo + threadIdx.x; e < hi; e += kThreads) og[e] = t.xs[e];
  }
}

// K1f: one MixerBlock (kDrop: with dropout masks; without, none are computed)
template <bool kBF16, bool kDrop, int RPT>
__global__ void __launch_bounds__(kThreads, 1)
    mixer_block_fwd(const float* __restrict__ x, float* __restrict__ out, int B, int N, int T, int D,
                    int C, int tb, int tanh_flavor, const __grid_constant__ StackArgs args) {
  tile_forward<kBF16, kDrop, false, RPT>(x, out, B, N, T, D, C, tb, 1, 0, tanh_flavor, args);
}

// K2f: K MixerBlocks (+ final LN) with the activation tile resident in shared memory
template <bool kBF16, bool kDrop, int RPT>
__global__ void __launch_bounds__(kThreads, 1)
    mixer_stack_fwd(const float* __restrict__ x, float* __restrict__ out, int B, int N, int T, int D,
                    int C, int tb, int n_blocks, int final_ln, int tanh_flavor,
                    const __grid_constant__ StackArgs args) {
  tile_forward<kBF16, kDrop, true, RPT>(x, out, B, N, T, D, C, tb, n_blocks, final_ln,
                                         tanh_flavor, args);
}

struct Launch {
  const float* x;
  float* out;
  int B, N, T, D, C, tb, cluster, n_blocks, final_ln, tanh_flavor;
  size_t smem;
  cudaStream_t stream;
};

size_t smem_bytes(int tb, int N, int D, int T, int bf16) {
  const size_t rows = (size_t)tb * N;
  const size_t wbytes = bf16 ? 2 : 4;
  const size_t token = 2 * (size_t)N * T + T + N;
  return rows * D * 4 * 3 + rows * kChunk * 4 + 2 * (size_t)D * kChunk * wbytes + token * 4;
}

int check_args(int B, int N, int T, int D, int C, int tb, int cluster, int n_blocks, int bf16) {
  if (B < 1 || N < 1 || N > kMaxTokens || T < 1 || D < 4 || D % 4 != 0 || C < 1) return 1;
  if (cluster != 1 && cluster != 2 && cluster != kMaxCluster) return 1;
  if (bf16 && C % 2 != 0) return 1;
  if (tb < 1 || tb * N > kRowsMax) return 1;
  if (n_blocks < 1 || n_blocks > kMaxBlocks) return 1;
  return 0;
}

StackArgs pack(const void* const* ptrs, int n_blocks, int final_ln, float* saved,
               const Dropout& dp) {
  StackArgs a = {};
  a.saved = saved;
  a.dp = dp;
  for (int k = 0; k < n_blocks; ++k) {
    const void* const* q = ptrs + k * kParamsPerBlock;
    BlockPtrs& b = a.blocks[k];
    b.ln1_s = static_cast<const float*>(q[0]);
    b.ln1_b = static_cast<const float*>(q[1]);
    b.w1 = static_cast<const float*>(q[2]);
    b.b1 = static_cast<const float*>(q[3]);
    b.w2 = static_cast<const float*>(q[4]);
    b.b2 = static_cast<const float*>(q[5]);
    b.ln2_s = static_cast<const float*>(q[6]);
    b.ln2_b = static_cast<const float*>(q[7]);
    b.w3 = q[8];
    b.b3 = static_cast<const float*>(q[9]);
    b.w4 = q[10];
    b.b4 = static_cast<const float*>(q[11]);
  }
  if (final_ln) {
    a.lnf_s = static_cast<const float*>(ptrs[n_blocks * kParamsPerBlock]);
    a.lnf_b = static_cast<const float*>(ptrs[n_blocks * kParamsPerBlock + 1]);
  }
  return a;
}

template <bool kBF16, bool kDrop, int RPT>
cudaError_t launch(const Launch& l, const StackArgs& args, bool stack) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((l.B + l.tb - 1) / l.tb * l.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = l.stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = l.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  if (stack) {
    err = prepare(mixer_stack_fwd<kBF16, kDrop, RPT>, l.smem);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, mixer_stack_fwd<kBF16, kDrop, RPT>, l.x, l.out, l.B, l.N, l.T, l.D,
                             l.C, l.tb, l.n_blocks, l.final_ln, l.tanh_flavor, args);
  } else {
    err = prepare(mixer_block_fwd<kBF16, kDrop, RPT>, l.smem);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, mixer_block_fwd<kBF16, kDrop, RPT>, l.x, l.out, l.B, l.N, l.T, l.D,
                             l.C, l.tb, l.tanh_flavor, args);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// rows per thread = ceil(tile rows / 4), rounded up to a power of two
template <bool kBF16, bool kDrop>
cudaError_t dispatch(const Launch& l, const StackArgs& args, bool stack) {
  const int rpt = (l.tb * l.N + kRowGroups - 1) / kRowGroups;
  if (rpt <= 1) return launch<kBF16, kDrop, 1>(l, args, stack);
  if (rpt <= 2) return launch<kBF16, kDrop, 2>(l, args, stack);
  if (rpt <= 4) return launch<kBF16, kDrop, 4>(l, args, stack);
  if (rpt <= 8) return launch<kBF16, kDrop, 8>(l, args, stack);
  return launch<kBF16, kDrop, kRowsPerThread>(l, args, stack);
}

int run(const Launch& l, int bf16, int device, const void* const* ptrs, bool stack, float* saved,
        const Dropout& dp) {
  if (check_args(l.B, l.N, l.T, l.D, l.C, l.tb, l.cluster, l.n_blocks, bf16)) return -1;
  if ((size_t)l.B * l.N * (l.C > l.D ? l.C : l.D) >= (1ull << 32) ||
      (size_t)l.B * l.D * (l.T > l.N ? l.T : l.N) >= (1ull << 32))
    return -1;  // the dropout masks count their elements in 32 bits
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const StackArgs args = pack(ptrs, l.n_blocks, l.final_ln, saved, dp);
  if (dp.on)
    return bf16 ? dispatch<true, true>(l, args, stack) : dispatch<false, true>(l, args, stack);
  return bf16 ? dispatch<true, false>(l, args, stack) : dispatch<false, false>(l, args, stack);
}

}  // namespace

extern "C" {

// Shared memory one CTA needs for `tb` samples per CTA (the wrapper sizes tb with it).
size_t m2m_mixer_smem_bytes(int tb, int N, int D, int T, int bf16) {
  return smem_bytes(tb, N, D, T, bf16);
}

const char* m2m_error_string(int code) {
  if (code == -1) return "invalid shape or tile arguments for the mixer kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// tb samples per row tile, each tile on a cluster of `cluster` CTAs (1, 2 or 4);
// ptrs: 12 parameter pointers of one block, in MixerBlockParams order; device: the
// CUDA device the tensors and the stream live on (this library has its own runtime).
// keys: 4 dropout stream keys per block (host array), or nullptr for no dropout;
// thresh and scale: keep iff bits >= thresh, kept values times scale.
int m2m_mixer_block_fwd(const float* x, float* out, int B, int N, int T, int D, int C, int tb,
                        int cluster, int bf16, int tanh_flavor, const unsigned* keys,
                        unsigned thresh, float scale, int device, const void* const* ptrs,
                        void* stream) {
  const Launch l{x, out, B, N, T, D, C, tb, cluster, 1, 0, tanh_flavor,
                 smem_bytes(tb, N, D, T, bf16), static_cast<cudaStream_t>(stream)};
  return run(l, bf16, device, ptrs, false, nullptr, make_dropout(keys, 1, thresh, scale));
}

// ptrs: 12 pointers per block for n_blocks blocks, then (ln_scale, ln_bias) if final_ln.
// saved: nullptr, or room for n_blocks + 1 (B, N, D) float32 slots that receive every
// block's input and the output before the final LN (what mixer_stack_bwd reads).
int m2m_mixer_stack_fwd(const float* x, float* out, int B, int N, int T, int D, int C, int tb,
                        int cluster, int n_blocks, int final_ln, int bf16, int tanh_flavor,
                        const unsigned* keys, unsigned thresh, float scale, float* saved,
                        int device, const void* const* ptrs, void* stream) {
  const Launch l{x, out, B, N, T, D, C, tb, cluster, n_blocks, final_ln, tanh_flavor,
                 smem_bytes(tb, N, D, T, bf16), static_cast<cudaStream_t>(stream)};
  return run(l, bf16, device, ptrs, true, saved, make_dropout(keys, n_blocks, thresh, scale));
}

}  // extern "C"
