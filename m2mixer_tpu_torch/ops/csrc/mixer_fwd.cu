// Fused MixerBlock / mixer-stack forward kernels for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels of m2mixer_tpu/ops/mixer_kernel.py:
//   m2m_mixer_fwd (float32), mixer_block_fwd (bf16)
//       <- fused_mixer_block forward (_fwd_kernel over _block_math)
//   m2m_mixer_fwd (float32), mixer_stack_fwd (bf16)
//       <- fused_mixer_stack forward (_stack_fwd_kernel over _stack_math)
//
// One block computes, on x (B, N, D):
//   LN1 -> token FF over N (N->T, GELU, T->N) -> +residual = x1
//   -> LN2 = z -> channel FF over D (D->C, GELU, C->D) -> +residual
// and the stack runs K such blocks, optionally followed by a final LN. Dropout
// multiplies by the four masks of mixer_common.cuh where _block_math does,
// keyed on the element's index in the JAX layouts, so the backward kernels
// (mixer_bwd.cu) regenerate the same masks.
//
// float32 design (K1f and K2f). Per block the channel FF does 4*B*N*D*C flops
// against 2*D*C weights, the token FF 4*B*D*N*T: operations bound the block at
// the served batches, and float32 FMA on the CUDA cores (67 TFLOP/s) was the
// old kernel's ceiling. Both channel products now run on the tensor cores in
// 3xTF32 (tile_common.cuh's tc_gemm, float32-accurate at a third of TF32's
// 495 TFLOP/s), so the block becomes a short pipeline through device memory,
// the forward half of K1b's:
//   0. once per call, where C is no multiple of 4 (the fusion mixer's 3078):
//      every block's W3 copied into D x Cp rows, Cp = C rounded up to whole
//      16-byte groups, zeros in the pad columns (exact: gelu(0) = 0);
//   1. prefix, row tiles of whole samples (the token mix couples a sample's N
//      tokens): the block input -- x, or for a later block the finish of the
//      one before (below) -- saved to K2f's slot when training, then LN1,
//      token FF (masks 0, 1), x1, LN2 -> x1 and z to device memory;
//   2. up: h2 = gelu(z W3 + b3) m2 on the tile (bias, GELU and mask 2 in its
//      epilogue), (B*N) x Cp with zero pad columns;
//   3. down: h2 W4 over slices of C (partials summed later in slice order);
//   4. finish: x1 + (the slices' sum + b4) m3, in the next block's prefix as
//      it loads its input, and after the last block in finish_kernel, which
//      also writes the pre-LN output to the last saved slot and applies the
//      stack's final LN.
// No float atomics and one order for every sum: two runs give bit-identical
// outputs, and a stack's saved slots equal a chain of one-block calls. The
// prefix keeps a sample's tokens in registers, sized by a template bound (8
// for the B config's 4 and 8 tokens, else kMaxTokens) so that it keeps
// several CTAs an SM.
//
// bf16 (serving only; the backward runs in float32). One launch keeps a row
// tile of `tb` whole samples in shared memory for the whole stack: x/x1, z and
// a channel-FF accumulator (R x D each, R = tb * N rows). A cluster of S CTAs
// (1, 2 or 4, chosen at launch with tb so that the grid fills the SMs in one
// wave) shares the tile: all compute LN1, the token mix and LN2 on the same
// rows; CTA `rank` runs the channel FF over hidden chunks rank, rank + S, ...
// of kChunk units: h = gelu(z W3[:, c:c+kChunk] + b3) into shared memory, then
// its partial acc += h W4[c:c+kChunk, :], so the R x C hidden activation never
// reaches device memory. The partials meet through distributed shared memory,
// summed in rank order. Weight chunks stream from L2 with cp.async into two
// buffers. Casts follow _block_math exactly: the residual stream, the LN
// outputs and every GEMM operand are rounded to bf16; LN statistics, GEMM sums,
// biases and GELU stay float32. Products run as float32 FMA on the CUDA cores
// (products of bf16 values are exact in float32), latency-bound per chunk,
// several times off the bound (PERF.md); wgmma with TMA is ROADMAP.md's item.
//
// Limits checked by the wrappers and again here: N <= kMaxTokens, D % 4 == 0,
// K <= kMaxBlocks; bf16: C even, shared memory <= the opt-in limit.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mixer_common.cuh"
#include "tile_common.cuh"

namespace cg = cooperative_groups;

namespace {

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

// ============================================ float32: the tensor-core pipeline

constexpr int kFewTokens = 8;  // the prefix's narrow token bound (the B config: N = 4, 8)

// stage 0: w3p[k] (D x Cp) = block k's W3 (D x C), zeros in columns C..Cp-1
struct W3Srcs {
  const float* w3[kMaxBlocks];
};
__global__ void __launch_bounds__(kThreads)
    pad_w3_kernel(const __grid_constant__ W3Srcs src, float* __restrict__ w3p, int D, int C,
                  int Cp) {
  const float* w3 = src.w3[blockIdx.y];
  float* dst = w3p + (size_t)blockIdx.y * D * Cp;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= D * Cp) return;
  const int d = e / Cp, c = e - d * Cp;
  dst[e] = c < C ? __ldg(w3 + (size_t)d * C + c) : 0.f;
}

// stage 4: block blk's output at element e of the (B*N) x D stream, x1 + (h2 W4 +
// b4) m3, the down product's ksplit partials (`total` floats apart) added in
// slice order. Both roundings of _block_math are kept (no FMA contraction), so
// the prefix and finish_kernel compute it alike.
__device__ __forceinline__ float finish(const float* x1, const float* part, int ksplit,
                                        size_t total, size_t e, float b4, const Dropout& dp,
                                        int blk) {
  float s = 0.f;
  for (int k = 0; k < ksplit; ++k) s += part[k * total + e];
  return x1[e] + __fmul_rn(s + b4, keep(dp, blk, 3, (uint32_t)e));
}

// stage 1 of block `blk` on a tile of tb whole samples: the block input u (x for
// the first block, else the finish of block blk - 1 from x1 and `part`), saved
// to `save` when given, then LN1 -> token FF -> x1 = u + token FF -> LN2 = z;
// x1 and z to device memory. x1 is read and rewritten in place: a tile's rows
// are its own.
template <int kMaxN>
__global__ void __launch_bounds__(kThreads)
    fwd_prefix_kernel(const float* __restrict__ x, const float* __restrict__ part, int ksplit,
                      const float* __restrict__ b4_prev, float* x1, float* __restrict__ z,
                      float* __restrict__ save, int B, int N, int T, int D, int tb,
                      int tanh_flavor, BlockPtrs p, const __grid_constant__ Dropout dp, int blk) {
  extern __shared__ __align__(16) float sm[];
  const int s0 = blockIdx.x * tb, nb = min(tb, B - s0), R = nb * N;
  float* xs = sm;
  float* ys = xs + tb * N * D;
  float* tw = ys + tb * N * D;
  const size_t off = (size_t)s0 * N * D, total = (size_t)B * N * D;
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    const size_t g = off + e;
    const float u = x ? x[g] : finish(x1, part, ksplit, total, g, __ldg(b4_prev + e % D), dp,
                                      blk - 1);
    xs[e] = u;
    if (save) save[g] = u;
  }
  load_token_weights<false>(tw, TokenPtrs{p.w1, p.b1, p.w2, p.b2}, N, T);
  __syncthreads();
  layer_norm_rows<false>(xs, ys, R, D, p.ln1_s, p.ln1_b);
  __syncthreads();
  token_mix<false, true, kMaxN>(ys, xs, nb, N, T, D, tw, tanh_flavor, dp, blk, s0);
  __syncthreads();
  layer_norm_rows<false>(xs, ys, R, D, p.ln2_s, p.ln2_b);
  __syncthreads();
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    x1[off + e] = xs[e];
    z[off + e] = ys[e];
  }
}

// stage 2's epilogue over (rows) x Cp: h2 = gelu(v + b3) m2, zero in the pad
// columns (K1b's EpiA3 and then EpiChannelBwd compute the same h2)
struct EpiUp {
  const float* b3;
  int C, tanh_flavor, blk;
  Dropout dp;
  __device__ __forceinline__ float operator()(int r, int c, float v) const {
    if (c >= C) return 0.f;
    return gelu(v + __ldg(b3 + c), tanh_flavor) * keep(dp, blk, 2, (uint32_t)r * C + c);
  }
};

// stage 4 after the last block (`blk`): its output v (the finish), to `save`
// when given (the stack's output before its final LN), then out = LN(v) with
// the final LN's scale and bias, or v without one; a warp per row
__global__ void __launch_bounds__(kThreads)
    finish_kernel(const float* __restrict__ x1, const float* __restrict__ part, int ksplit,
                  const float* __restrict__ b4, float* __restrict__ save, float* __restrict__ out,
                  const float* __restrict__ lnf_s, const float* __restrict__ lnf_b, int rows,
                  int D, const __grid_constant__ Dropout dp, int blk) {
  extern __shared__ __align__(16) float sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kThreads / 32) + warp;
  if (r >= rows) return;  // the whole warp: no block-wide barrier follows
  float* v = sm + warp * D;
  const size_t row = (size_t)r * D, total = (size_t)rows * D;
  for (int d = lane; d < D; d += 32) {
    v[d] = finish(x1, part, ksplit, total, row + d, __ldg(b4 + d), dp, blk);
    if (save) save[row + d] = v[d];
  }
  __syncwarp();
  if (!lnf_s) {
    for (int d = lane; d < D; d += 32) out[row + d] = v[d];
    return;
  }
  float mean, inv;
  row_stats(v, D, mean, inv);
  for (int d = lane; d < D; d += 32)
    out[row + d] = (v[d] - mean) * inv * __ldg(lnf_s + d) + __ldg(lnf_b + d);
}

struct FwdPlan {
  int sms;            // the card's SMs (the up product's tile rule, the down product's slices)
  int tb, tiles;      // samples per prefix tile, prefix tiles
  int Cp;             // C rounded up to whole 16-byte groups: h2's row stride
  int kslice, ksplit; // the down product's slices of C
  size_t prefix_smem, finish_smem;
  // workspace offsets (floats, each a multiple of 4: 16-byte aligned)
  size_t w3p, x1, z, h2, part, ws_floats;
};

int check_f32(int B, int N, int T, int D, int C, int n_blocks) {
  if (B < 1 || N < 1 || N > kMaxTokens || T < 1 || D < 4 || D % 4 != 0 || C < 1) return -1;
  if (n_blocks < 1 || n_blocks > kMaxBlocks) return -1;
  if ((size_t)B * N * (C > D ? C : D) >= (1ull << 32) ||
      (size_t)B * D * (T > N ? T : N) >= (1ull << 32))
    return -1;  // the dropout masks count their elements in 32 bits
  if ((size_t)B * N > (size_t)kTcBM * 65535) return -1;  // the products' row tiles (grid y)
  return 0;
}

int make_fwd_plan(int B, int N, int T, int D, int C, int n_blocks, int device, FwdPlan& pl) {
  DeviceInfo dev;
  const cudaError_t err = device_info(device, dev);
  if (err != cudaSuccess) return err;
  pl.sms = dev.sms;
  auto prefix_bytes = [=](int tb) {
    return (2 * (size_t)tb * N * D + 2 * (size_t)N * T + T + N) * 4;
  };
  int tb = kThreads / D > 1 ? kThreads / D : 1;  // a token-mix column per thread
  if (tb > B) tb = B;
  while (tb > 1 && prefix_bytes(tb) > (size_t)dev.smem_optin) --tb;
  pl.tb = tb;
  pl.tiles = ceil_div(B, tb);
  pl.prefix_smem = prefix_bytes(tb);
  pl.finish_smem = (size_t)(kThreads / 32) * D * 4;
  if (pl.prefix_smem > (size_t)dev.smem_optin || pl.finish_smem > (size_t)dev.smem_optin)
    return -1;
  const long long R = (long long)B * N;
  const size_t rows = (size_t)R;
  pl.Cp = (C + 3) / 4 * 4;
  // the down product (rows x D) in wide tiles x slices of C, as K1b's dz
  fill_slices(C, ceil_div(R, kTcBM) * ceil_div(D, kTcBN), pl.sms, pl.kslice, pl.ksplit);
  size_t o = 0;
  auto take = [&o](size_t& at, size_t floats) { at = o, o += (floats + 3) / 4 * 4; };
  take(pl.w3p, pl.Cp != C ? (size_t)n_blocks * D * pl.Cp : 0);
  take(pl.x1, rows * D);
  take(pl.z, rows * D);
  take(pl.h2, rows * pl.Cp);
  take(pl.part, (size_t)pl.ksplit * rows * D);
  pl.ws_floats = o;
  return 0;
}

// K1f (n_blocks 1, no final LN, no saved slots) and K2f in float32
int run_f32(const float* x, float* out, int B, int N, int T, int D, int C, int n_blocks,
            int final_ln, int tanh_flavor, const StackArgs& a, float* ws, int device,
            cudaStream_t st) {
  FwdPlan pl;
  const int code = make_fwd_plan(B, N, T, D, C, n_blocks, device, pl);
  if (code) return code;
  auto prefix = N <= kFewTokens ? fwd_prefix_kernel<kFewTokens> : fwd_prefix_kernel<kMaxTokens>;
  M2M_TRY(prepare(prefix, pl.prefix_smem, device));
  M2M_TRY(prepare(finish_kernel, pl.finish_smem, device));
  const int R = B * N, Cp = pl.Cp;
  const size_t slot = (size_t)R * D;  // one saved block input
  float* w3p = ws + pl.w3p;
  float* x1 = ws + pl.x1;
  float* z = ws + pl.z;
  float* h2 = ws + pl.h2;
  float* part = ws + pl.part;
  if (Cp != C) {
    W3Srcs src = {};
    for (int k = 0; k < n_blocks; ++k) src.w3[k] = static_cast<const float*>(a.blocks[k].w3);
    pad_w3_kernel<<<dim3(ceil_div((long long)D * Cp, kThreads), n_blocks), kThreads, 0, st>>>(
        src, w3p, D, C, Cp);
    M2M_TRY(cudaGetLastError());
  }
  for (int k = 0; k < n_blocks; ++k) {
    const BlockPtrs& p = a.blocks[k];
    prefix<<<pl.tiles, kThreads, pl.prefix_smem, st>>>(
        k ? nullptr : x, part, pl.ksplit, k ? a.blocks[k - 1].b4 : nullptr, x1, z,
        a.saved ? a.saved + k * slot : nullptr, B, N, T, D, pl.tb, tanh_flavor, p, a.dp, k);
    M2M_TRY(cudaGetLastError());
    const float* w3 = Cp != C ? w3p + (size_t)k * D * Cp : static_cast<const float*>(p.w3);
    M2M_TRY(tc_gemm_auto(View{z, D, 1}, View{w3, Cp, 1}, h2, R, Cp, D, pl.sms, st,
                         EpiUp{p.b3, C, tanh_flavor, k, a.dp}));
    M2M_TRY(tc_gemm_wide(View{h2, Cp, 1}, View{static_cast<const float*>(p.w4), D, 1}, part, R,
                         D, C, pl.kslice, pl.ksplit, st));
  }
  finish_kernel<<<ceil_div(R, kThreads / 32), kThreads, pl.finish_smem, st>>>(
      x1, part, pl.ksplit, a.blocks[n_blocks - 1].b4, a.saved ? a.saved + n_blocks * slot : nullptr,
      out, final_ln ? a.lnf_s : nullptr, a.lnf_b, R, D, a.dp, n_blocks - 1);
  return (int)cudaGetLastError();
}

// ============================================ bf16: the resident-tile kernel

constexpr int kChunk = 64;                           // hidden units per channel-FF step
constexpr int kRowGroups = kThreads / kChunk;        // 4 rows in flight per column
constexpr int kRowsMax = 64;                         // rows (tb * N) one CTA may own
constexpr int kRowsPerThread = kRowsMax / kRowGroups;
constexpr int kMaxCluster = 4;  // CTAs that may split one row tile's hidden units C

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

// K1f in bf16: one MixerBlock (kDrop: with dropout masks; without, none are computed)
template <bool kBF16, bool kDrop, int RPT>
__global__ void __launch_bounds__(kThreads, 1)
    mixer_block_fwd(const float* __restrict__ x, float* __restrict__ out, int B, int N, int T, int D,
                    int C, int tb, int tanh_flavor, const __grid_constant__ StackArgs args) {
  tile_forward<kBF16, kDrop, false, RPT>(x, out, B, N, T, D, C, tb, 1, 0, tanh_flavor, args);
}

// K2f in bf16: K MixerBlocks (+ final LN) with the activation tile resident in shared memory
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

int check_args(int B, int N, int T, int D, int C, int tb, int cluster, int n_blocks) {
  if (B < 1 || N < 1 || N > kMaxTokens || T < 1 || D < 4 || D % 4 != 0 || C < 1) return 1;
  if (cluster != 1 && cluster != 2 && cluster != kMaxCluster) return 1;
  if (C % 2 != 0) return 1;  // bf16 weight rows of whole 4-byte copies
  if (tb < 1 || tb * N > kRowsMax) return 1;
  if (n_blocks < 1 || n_blocks > kMaxBlocks) return 1;
  return 0;
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

// the bf16 route: kBF16 is instantiated true only (float32 runs run_f32)
int run_bf16(const Launch& l, int device, const void* const* ptrs, bool stack, float* saved,
             const Dropout& dp) {
  if (check_args(l.B, l.N, l.T, l.D, l.C, l.tb, l.cluster, l.n_blocks)) return -1;
  if ((size_t)l.B * l.N * (l.C > l.D ? l.C : l.D) >= (1ull << 32) ||
      (size_t)l.B * l.D * (l.T > l.N ? l.T : l.N) >= (1ull << 32))
    return -1;  // the dropout masks count their elements in 32 bits
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const StackArgs args = pack(ptrs, l.n_blocks, l.final_ln, saved, dp);
  return dp.on ? dispatch<true, true>(l, args, stack) : dispatch<true, false>(l, args, stack);
}

}  // namespace

extern "C" {

// Shared memory one CTA of the bf16 kernel needs for `tb` samples per CTA, its
// weight chunks `bf16 ? 2 : 4` bytes an element (the wrapper sizes tb with it).
size_t m2m_mixer_smem_bytes(int tb, int N, int D, int T, int bf16) {
  return smem_bytes(tb, N, D, T, bf16);
}

const char* m2m_error_string(int code) {
  if (code == -1) return "invalid shape or tile arguments for the mixer kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Workspace bytes of the float32 forward of n_blocks blocks (the wrapper
// allocates it); 0 for shapes the kernels do not take.
size_t m2m_mixer_fwd_workspace_bytes(int B, int N, int T, int D, int C, int n_blocks, int device) {
  FwdPlan pl;
  if (check_f32(B, N, T, D, C, n_blocks) || make_fwd_plan(B, N, T, D, C, n_blocks, device, pl))
    return 0;
  return pl.ws_floats * 4;
}

// K1f / K2f in float32: n_blocks MixerBlocks (+ the final LN when final_ln), x and
// out (B, N, D). ptrs: 12 parameter pointers per block in MixerBlockParams order,
// then (ln_scale, ln_bias) if final_ln; saved: nullptr, or room for n_blocks + 1
// (B, N, D) float32 slots that receive every block's input and the output before
// the final LN (what m2m_mixer_bwd reads). keys: 4 dropout stream keys per block
// (host array), or nullptr for no dropout; thresh and scale: keep iff bits >=
// thresh, kept values times scale. device: the CUDA device the tensors and the
// stream live on (this library has its own runtime); workspace:
// m2m_mixer_fwd_workspace_bytes bytes.
int m2m_mixer_fwd(const float* x, float* out, float* saved, int B, int N, int T, int D, int C,
                  int n_blocks, int final_ln, int tanh_flavor, const unsigned* keys,
                  unsigned thresh, float scale, int device, const void* const* ptrs,
                  void* workspace, void* stream) {
  if (check_f32(B, N, T, D, C, n_blocks)) return -1;
  M2M_TRY(cudaSetDevice(device));
  const StackArgs a = pack(ptrs, n_blocks, final_ln, saved,
                           make_dropout(keys, n_blocks, thresh, scale));
  return run_f32(x, out, B, N, T, D, C, n_blocks, final_ln, tanh_flavor, a,
                 static_cast<float*>(workspace), device, static_cast<cudaStream_t>(stream));
}

// K1f in bf16: tb samples per row tile, each tile on a cluster of `cluster` CTAs
// (1, 2 or 4); ptrs: the 12 parameters of the block (w3 and w4 in bf16);
// keys/thresh/scale as m2m_mixer_fwd's.
int m2m_mixer_block_fwd(const float* x, float* out, int B, int N, int T, int D, int C, int tb,
                        int cluster, int tanh_flavor, const unsigned* keys, unsigned thresh,
                        float scale, int device, const void* const* ptrs, void* stream) {
  const Launch l{x, out, B, N, T, D, C, tb, cluster, 1, 0, tanh_flavor,
                 smem_bytes(tb, N, D, T, 1), static_cast<cudaStream_t>(stream)};
  return run_bf16(l, device, ptrs, false, nullptr, make_dropout(keys, 1, thresh, scale));
}

// K2f in bf16: ptrs and saved as m2m_mixer_fwd's, w3 and w4 in bf16.
int m2m_mixer_stack_fwd(const float* x, float* out, int B, int N, int T, int D, int C, int tb,
                        int cluster, int n_blocks, int final_ln, int tanh_flavor,
                        const unsigned* keys, unsigned thresh, float scale, float* saved,
                        int device, const void* const* ptrs, void* stream) {
  const Launch l{x, out, B, N, T, D, C, tb, cluster, n_blocks, final_ln, tanh_flavor,
                 smem_bytes(tb, N, D, T, 1), static_cast<cudaStream_t>(stream)};
  return run_bf16(l, device, ptrs, true, saved, make_dropout(keys, n_blocks, thresh, scale));
}

}  // extern "C"
