// Fused MixerBlock / mixer-stack forward kernels for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels of m2mixer_tpu/ops/mixer_kernel.py:
//   m2m_mixer_fwd (1 block, float32 and bf16)
//       <- fused_mixer_block forward (_fwd_kernel over _block_math)
//   m2m_mixer_fwd (K blocks + final LN, float32 and bf16)
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
// The pipeline (K1f and K2f, m2m_mixer_fwd). Per block the channel FF does
// 4*B*N*D*C flops against 2*D*C weights, the token FF 4*B*D*N*T: operations
// bound the block at the served batches, and float32 FMA on the CUDA cores (67
// TFLOP/s) was the old kernel's ceiling. Both channel products run on the
// tensor cores in 3xTF32 (tile_common.cuh's tc_gemm, float32-accurate at a
// third of TF32's 495 TFLOP/s), so the block is a short pipeline through
// device memory, the forward half of K1b's:
//   0. once per call, where C is no multiple of 4 (the fusion mixer's 3078) or
//      in bf16: every block's W3 copied into D x Cp rows, Cp = C rounded up to
//      whole 16-byte groups, zeros in the pad columns (exact: gelu(0) = 0),
//      and in bf16 W4 too, both rounded;
//   1. the token half, on the block input -- x, or for a later block the
//      finish of the one before (below) -- saved to K2f's slot when training:
//      LN1, token FF (masks 0, 1), x1, LN2 -> x1 and z to device memory. At
//      most kMaxTokens tokens one prefix launch on row tiles of whole samples
//      (the token mix couples a sample's N tokens) keeps a sample's tokens in
//      registers, sized by a template bound (8 for the B config's 4 and 8
//      tokens, else kMaxTokens) so that it keeps several CTAs an SM. Above
//      that, token_ff.cuh's pipeline: LN1 written transposed, the token FF's
//      two products on the tile (GELU, masks and bias in their epilogues),
//      the residual and LN2 (the L config's 64 and 80 tokens);
//   2. up: h2 = gelu(z W3 + b3) m2 on the tile (bias, GELU and mask 2 in its
//      epilogue), (B*N) x Cp with zero pad columns;
//   3. down: h2 W4 over slices of C (partials summed later in slice order);
//   4. finish: x1 + (the slices' sum + b4) m3, in the next block's first
//      launch as it loads its input, and after the last block in
//      finish_kernel, which also writes the pre-LN output to the last saved
//      slot and applies the stack's final LN.
// No float atomics and one order for every sum: two runs give bit-identical
// outputs, and a stack's saved slots equal a chain of one-block calls.
// bf16 compute runs the same pipeline with _block_math's casts (rd<true> at
// each: the block input, the LN outputs, h, h2 and the residual stream rounded
// to bf16; LN statistics, sums, biases and GELU float32), its products on the
// wgmma engine (wgmma_bf16.cuh): bf16 operands in the workspace, float32 sums,
// each 64-deep stage's sums added to the float32 accumulator (the tensor
// core's own accumulation truncates). What bounds it: at the L config's
// fusion mixer (B 512, N 80, D 512, C 4096) each channel product is 2*B*N*D*C
// = 171.8 GFLOP, 0.17 ms at the dense bf16 peak of 989 TFLOP/s, against
// 1xTF32 mma.sync on tc_gemm at about 64 TFLOP/s; the token FF's two products
// are 11 GFLOP each against 176 and 218 MB of operands and outputs, bound
// by bytes. So:
//   0. w3p (D x Cp, Cp = C rounded up to 8: TMA's whole 16-byte rows) and
//      w4r (C x D) in bf16, rounded;
//   1. the prefix (register route) or tok_out_kernel (token pipeline) writes
//      z in bf16; x1 stays float32. The token pipeline's products run on the
//      engine too (token_forward_wg below: yt and ht in bf16);
//   2. up: z (K-major) times w3p (MN-major) on a 128 x 64 tile, three CTAs
//      an SM (an epilogue of GELU and the hash per element, which takes about
//      as long as the products: one CTA's epilogue beside the others'
//      products), h2 in bf16 staged through shared memory and written in
//      whole rows, zeros in the pad columns;
//   3. down: h2 (K-major) times w4r (MN-major) on a 128 x 128 tile, the depth
//      C sliced where the tiles are few (wg_slices), float32 partials;
//   4. the finish as in float32, its two roundings unchanged.
// The parameters arrive in float32 at either precision; stage 0 lays out the
// rounded W3/W4 copies the products read, as the JAX kernels cast theirs on
// each call. No fallback: a bf16 call the engine cannot take raises.
//
// Limits checked by the wrappers and again here: D % 4 == 0 (bf16: D % 8 ==
// 0), K <= kMaxBlocks, the masks' 32-bit element counts and the products' grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mixer_common.cuh"
#include "tile_common.cuh"
#include "token_ff.cuh"
#include "wgmma_bf16.cuh"

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
  const float* w3;  // (D, C)
  const float* b3;  // (C,)
  const float* w4;  // (C, D)
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
    b.w3 = static_cast<const float*>(q[8]);
    b.b3 = static_cast<const float*>(q[9]);
    b.w4 = static_cast<const float*>(q[10]);
    b.b4 = static_cast<const float*>(q[11]);
  }
  if (final_ln) {
    a.lnf_s = static_cast<const float*>(ptrs[n_blocks * kParamsPerBlock]);
    a.lnf_b = static_cast<const float*>(ptrs[n_blocks * kParamsPerBlock + 1]);
  }
  return a;
}

constexpr int kFewTokens = 8;  // the prefix's narrow token bound (the B config: N = 4, 8)
constexpr int kSomeTokens = 16;  // the next (the L config's image mixer: N = 16)

// stage 0: for block blockIdx.y, w3p (D x Cp) = its W3 (D x C), zeros in
// columns C..Cp-1, and in bf16 w4r (C x D) = its W4; both in the compute
// dtype (ChanT: the copies the products read)
struct W34Srcs {
  const float* w3[kMaxBlocks];
  const float* w4[kMaxBlocks];
};
template <bool kBF16>
__global__ void __launch_bounds__(kThreads)
    prep_w34_kernel(const __grid_constant__ W34Srcs src, ChanT<kBF16>* __restrict__ w3p,
                    ChanT<kBF16>* __restrict__ w4r, int D, int C, int Cp) {
  const int k = blockIdx.y;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e < D * Cp) {
    const int d = e / Cp, c = e - d * Cp;
    w3p[(size_t)k * D * Cp + e] =
        to_operand<ChanT<kBF16>>(c < C ? __ldg(src.w3[k] + (size_t)d * C + c) : 0.f);
  }
  if (kBF16 && e < C * D)
    w4r[(size_t)k * C * D + e] = to_operand<ChanT<kBF16>>(__ldg(src.w4[k] + e));
}

// stage 1 of block `blk` on a tile of tb whole samples, at most kMaxTokens
// tokens: the block input u (x rounded to the compute dtype for the first
// block, else the finish of block blk - 1 from x1 and `part`), saved to `save`
// when given, then LN1 -> token FF -> x1 = u + token FF -> LN2 = z; x1 and z
// to device memory (z in the compute dtype, ChanT). x1 is read and rewritten in
// place: a tile's rows are its own.
template <int kMaxN, bool kBF16>
__global__ void __launch_bounds__(kThreads)
    fwd_prefix_kernel(const float* __restrict__ x, const float* __restrict__ part, int ksplit,
                      const float* __restrict__ b4_prev, float* x1, ChanT<kBF16>* __restrict__ z,
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
    const float u = x ? rd<kBF16>(x[g])
                      : finish<kBF16>(x1, part, ksplit, total, g, __ldg(b4_prev + e % D), dp,
                                      blk - 1);
    xs[e] = u;
    if (save) save[g] = u;
  }
  load_token_weights<kBF16>(tw, TokenPtrs{p.w1, p.b1, p.w2, p.b2}, N, T);
  __syncthreads();
  layer_norm_rows<kBF16>(xs, ys, R, D, p.ln1_s, p.ln1_b);
  __syncthreads();
  token_mix<kBF16, kMaxN>(ys, xs, nb, N, T, D, tw, tanh_flavor, dp, blk, s0);
  __syncthreads();
  layer_norm_rows<kBF16>(xs, ys, R, D, p.ln2_s, p.ln2_b);
  __syncthreads();
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    x1[off + e] = xs[e];
    z[off + e] = to_operand<ChanT<kBF16>>(ys[e]);
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
// the same on the wgmma engine (bf16): columns c, c + 1 of row r -> h2 =
// rd(gelu(v + b3) m2) in bf16, which the engine stages and writes
struct EpiUpWg {
  static constexpr int kOuts = 1;
  const float* b3;
  __nv_bfloat16* h2;  // (B*N) x Cp
  int C, tanh_flavor, blk;
  Dropout dp;
  __device__ __forceinline__ __nv_bfloat16* dst(int) const { return h2; }
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1,
                                             __nv_bfloat162 (&out)[kOuts]) const {
    float v[2] = {v0, v1};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cc = c + e;
      v[e] = cc < C ? gelu(v[e] + __ldg(b3 + cc), tanh_flavor) *
                          keep(dp, blk, 2, (uint32_t)r * C + cc)
                    : 0.f;
    }
    out[0] = __floats2bfloat162_rn(v[0], v[1]);
  }
};

// stage 4 after the last block (`blk`): its output v (the finish), to `save`
// when given (the stack's output before its final LN), then out = LN(v) with
// the final LN's scale and bias (rounded as the block LNs), or v without one;
// a warp per row
template <bool kBF16>
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
    v[d] = finish<kBF16>(x1, part, ksplit, total, row + d, __ldg(b4 + d), dp, blk);
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
    out[row + d] = rd<kBF16>((v[d] - mean) * inv * rd<kBF16>(__ldg(lnf_s + d)) +
                             rd<kBF16>(__ldg(lnf_b + d)));
}

// token_ff.cuh's EpiTokenUp and EpiTokenDown on the wgmma engine (the bf16
// forward's token pipeline): the up product's columns c, c + 1 of row r -> h
// = rd(gelu(v + b1) m0) in bf16, zeros in the pad columns T <= c < Tp (the
// engine stages and writes them)
struct EpiTokenUpWg {
  static constexpr int kOuts = 1;
  const float* b1;
  __nv_bfloat16* h;  // (B*D) x Tp
  int T, tanh_flavor, blk;
  Dropout dp;
  __device__ __forceinline__ __nv_bfloat16* dst(int) const { return h; }
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1,
                                             __nv_bfloat162 (&out)[kOuts]) const {
    float v[2] = {v0, v1};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cc = c + e;
      v[e] = cc < T ? gelu(v[e] + __ldg(b1 + cc), tanh_flavor) *
                          keep(dp, blk, 0, (uint32_t)r * T + cc)
                    : 0.f;
    }
    out[0] = __floats2bfloat162_rn(v[0], v[1]);
  }
};
// and the down product's: tt[r, c] = (v + b2) m1 in float32 (args.N = N columns)
struct EpiTokenDownWg {
  static constexpr int kOuts = 0;
  const float* b2;
  int blk;
  Dropout dp;
  __device__ __forceinline__ void operator()(const WgJob& jb, const WgArgs& a, int, int r, int c,
                                             float v0, float v1) const {
    const float v[2] = {v0, v1};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cc = c + e;
      if (cc >= a.N) break;
      const uint32_t i = (uint32_t)r * a.N + cc;
      jb.out[i] = (v[e] + __ldg(b2 + cc)) * keep(dp, blk, 1, i);
    }
  }
};

// The bf16 forward's token products' weights, rounded and padded as the
// engine reads them: w1p (N x Tp) = rd(w1), w2p (T x Np) = rd(w2), zeros in
// the pad columns
__global__ void __launch_bounds__(kThreads)
    pad_token_weights_kernel(const float* __restrict__ w1, const float* __restrict__ w2,
                             __nv_bfloat16* __restrict__ w1p, __nv_bfloat16* __restrict__ w2p,
                             int N, int T, int Np, int Tp) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < N * Tp) {
    const int n = i / Tp, j = i - n * Tp;
    w1p[i] = __float2bfloat16_rn(j < T ? __ldg(w1 + (size_t)n * T + j) : 0.f);
  }
  if (i < T * Np) {
    const int j = i / Np, n = i - j * Np;
    w2p[i] = __float2bfloat16_rn(n < N ? __ldg(w2 + (size_t)j * N + n) : 0.f);
  }
}

// The bf16 forward's token half above kMaxTokens tokens on the wgmma engine,
// as token_ff.cuh's token_forward (without the backward's extras): u -> x1 =
// u + token FF, z = LN2(x1) in bf16. yt and ht are bf16, rows padded to
// whole 16-byte groups (Np = N, Tp = T rounded up to 8; the pad columns are
// read as TMA's out-of-bounds zeros or written as zeros), the rounded token
// weights laid out padded the same way, tt float32: at the L config's
// fusion shape, batch 512, ht's round trip through device memory halves
// (268 MB written and read in float32). w1 and w2 are the float32
// parameters; both products in one slice of their depth on the 64-wide tile.
struct TokenWgBufs {
  __nv_bfloat16* w1p;  // N x Tp
  __nv_bfloat16* w2p;  // T x Np
  __nv_bfloat16* yt;   // (B*D) x Np
  __nv_bfloat16* ht;   // (B*D) x Tp
  float* tt;           // (B*D) x N
  int Np, Tp;
};

inline int token_forward_wg(const float* x, const float* part, int ksplit, const float* b4_prev,
                            float* x1, __nv_bfloat16* z, float* save, const TokenWgBufs& tb,
                            const float* ln1_s, const float* ln1_b, const float* w1,
                            const float* b1, const float* w2, const float* b2,
                            const float* ln2_s, const float* ln2_b, int B, int N, int T, int D,
                            int nc, int tanh_flavor, const Dropout& dp, int blk, int device,
                            cudaStream_t st) {
  const int most = N * tb.Tp > T * tb.Np ? N * tb.Tp : T * tb.Np;
  pad_token_weights_kernel<<<ceil_div(most, kThreads), kThreads, 0, st>>>(w1, w2, tb.w1p, tb.w2p,
                                                                         N, T, tb.Np, tb.Tp);
  M2M_TRY(cudaGetLastError());
  const size_t smem = tok_tile_bytes(nc, D);
  const dim3 grid(ceil_div(N, nc), B);
  tok_in_kernel<true, __nv_bfloat16><<<grid, kThreads, smem, st>>>(
      x, part, ksplit, b4_prev, x1, tb.yt, tb.Np, save, B, N, D, nc, ln1_s, ln1_b, dp, blk);
  m2m_count(kTallyTokIn);
  M2M_TRY(cudaGetLastError());
  const long long rows = (long long)B * D;
  M2M_TRY(wg_product<64>(tb.yt, tb.Np, tb.w1p, tb.Tp, nullptr, rows, tb.Tp, N, N, 1,
                         EpiTokenUpWg{b1, tb.ht, T, tanh_flavor, blk, dp}, device, st));
  M2M_TRY(wg_product<64>(tb.ht, tb.Tp, tb.w2p, tb.Np, tb.tt, rows, N, T, T, 1,
                         EpiTokenDownWg{b2, blk, dp}, device, st));
  tok_out_kernel<true, __nv_bfloat16><<<grid, kThreads, smem, st>>>(
      tb.tt, x1, z, N, D, nc, ln2_s, ln2_b, nullptr, nullptr, dp, blk);
  return (int)cudaGetLastError();
}

struct FwdPlan {
  int sms;            // the card's SMs (the products' tile rule, the down product's slices)
  int reg;            // 1: the token FF in registers (N <= kMaxTokens and a sample's
                      // rows fit the prefix tile); 0: token_ff.cuh's pipeline
  int tb, tiles;      // register route: samples per prefix tile, prefix tiles
  int nc;             // token pipeline: tokens per row tile
  int Cp;             // C rounded up to whole 16-byte groups (of float32, or of bf16 in
                      // bf16 compute): h2's and w3p's row stride
  int Np, Tp;         // bf16 token pipeline: N and T rounded up to 8 (yt's, ht's rows)
  int kslice, ksplit; // the down product's slices of C
  size_t prefix_smem, finish_smem;
  // workspace offsets (floats, each a multiple of 4: 16-byte aligned); in bf16
  // compute w3p, w4r, z, h2, the token weights (twr: w1p then w2p), yt and ht
  // hold bf16
  size_t w3p, w4r, twr, x1, z, h2, part, yt, ht, tt, ws_floats;
};

int check_args(int B, int N, int T, int D, int C, int n_blocks) {
  if (B < 1 || N < 1 || T < 1 || D < 4 || D % 4 != 0 || C < 1) return -1;
  if (n_blocks < 1 || n_blocks > kMaxBlocks) return -1;
  if ((size_t)B * N * (C > D ? C : D) >= (1ull << 32) ||
      (size_t)B * D * (T > N ? T : N) >= (1ull << 32))
    return -1;  // the dropout masks count their elements in 32 bits
  if ((size_t)B * N > (size_t)kTcBM * 65535) return -1;  // the products' row tiles (grid y)
  return 0;
}

int make_fwd_plan(int B, int N, int T, int D, int C, int n_blocks, int bf16, int device,
                  FwdPlan& pl) {
  DeviceInfo dev;
  const cudaError_t err = device_info(device, dev);
  if (err != cudaSuccess) return err;
  pl.sms = dev.sms;
  if (bf16 && D % 8) return -1;  // z's bf16 rows: whole 16-byte groups for TMA
  auto prefix_bytes = [=](int tb) {
    return (2 * (size_t)tb * N * D + 2 * (size_t)N * T + T + N) * 4;
  };
  pl.reg = N <= kMaxTokens && prefix_bytes(1) <= (size_t)dev.smem_optin;
  pl.finish_smem = (size_t)(kThreads / 32) * D * 4;
  if (pl.finish_smem > (size_t)dev.smem_optin) return -1;
  if (pl.reg) {
    int tb = kThreads / D > 1 ? kThreads / D : 1;  // a token-mix column per thread
    if (tb > B) tb = B;
    while (tb > 1 && prefix_bytes(tb) > (size_t)dev.smem_optin) --tb;
    pl.tb = tb;
    pl.tiles = ceil_div(B, tb);
    pl.prefix_smem = prefix_bytes(tb);
    if (pl.prefix_smem > (size_t)dev.smem_optin) return -1;
    pl.nc = 0;
  } else {
    if ((size_t)B * D > (size_t)kTcBM * 65535 || B > 65535)
      return -1;  // the token products' row tiles, the row kernels' grid y
    pl.tb = pl.tiles = 0;
    pl.prefix_smem = 0;
    pl.nc = tok_tile_tokens(N, D, dev.smem_optin);
    if (!pl.nc) return -1;
  }
  const long long R = (long long)B * N;
  const size_t rows = (size_t)R, cols = (size_t)B * D;
  if (bf16) {
    pl.Cp = (C + 7) / 8 * 8;
    pl.Np = (N + 7) / 8 * 8;
    pl.Tp = (T + 7) / 8 * 8;
    // the down product (rows x D) in 128 x 128 tiles x slices of C, about a CTA an SM
    wg_slices(C, (long long)ceil_div(R, kWgBM) * ceil_div(D, kWgBN), pl.sms, 1, pl.kslice,
              pl.ksplit);
  } else {
    pl.Cp = (C + 3) / 4 * 4;
    pl.Np = N;
    pl.Tp = T;
    // the down product (rows x D) in wide tiles x slices of C, as K1b's dz
    fill_slices(C, ceil_div(R, kTcBM) * ceil_div(D, kTcBN), pl.sms, pl.kslice, pl.ksplit);
  }
  size_t o = 0;
  auto take = [&o](size_t& at, size_t floats) { at = o, o += (floats + 3) / 4 * 4; };
  // a product operand: bf16 ones take half a float each
  auto op = [bf16](size_t n) { return bf16 ? (n + 1) / 2 : n; };
  const size_t tok = pl.reg ? 0 : 1;  // the token pipeline's buffers, or none
  take(pl.w3p, pl.Cp != C || bf16 ? op((size_t)n_blocks * D * pl.Cp) : 0);
  take(pl.w4r, bf16 ? op((size_t)n_blocks * C * D) : 0);
  take(pl.twr, bf16 ? tok * op((size_t)N * pl.Tp + (size_t)T * pl.Np) : 0);
  take(pl.x1, rows * D);
  take(pl.z, op(rows * D));
  take(pl.h2, op(rows * pl.Cp));
  take(pl.part, (size_t)pl.ksplit * rows * D);
  take(pl.yt, tok * op(cols * pl.Np));
  take(pl.ht, tok * op(cols * pl.Tp));
  take(pl.tt, tok * cols * N);
  pl.ws_floats = o;
  return 0;
}

// K1f (n_blocks 1, no final LN, no saved slots) and K2f on the pipeline,
// float32 or (kBF16) bf16 compute
template <bool kBF16>
int run_pipeline(const float* x, float* out, int B, int N, int T, int D, int C, int n_blocks,
                 int final_ln, int tanh_flavor, const StackArgs& a, float* ws, int device,
                 cudaStream_t st) {
  FwdPlan pl;
  const int code = make_fwd_plan(B, N, T, D, C, n_blocks, kBF16, device, pl);
  if (code) return code;
  using CT = ChanT<kBF16>;
  auto prefix = N <= kFewTokens    ? fwd_prefix_kernel<kFewTokens, kBF16>
                : N <= kSomeTokens ? fwd_prefix_kernel<kSomeTokens, kBF16>
                                   : fwd_prefix_kernel<kMaxTokens, kBF16>;
  if (pl.reg)
    M2M_TRY(prepare(prefix, pl.prefix_smem, device));
  else
    M2M_TRY((prepare_token_kernels<kBF16, CT, CT>(pl.nc, D, device)));
  M2M_TRY(prepare(finish_kernel<kBF16>, pl.finish_smem, device));
  const int R = B * N, Cp = pl.Cp;
  const size_t slot = (size_t)R * D;  // one saved block input
  CT* w3p = reinterpret_cast<CT*>(ws + pl.w3p);
  CT* w4r = reinterpret_cast<CT*>(ws + pl.w4r);
  CT* z = reinterpret_cast<CT*>(ws + pl.z);
  CT* h2 = reinterpret_cast<CT*>(ws + pl.h2);
  float* x1 = ws + pl.x1;
  float* part = ws + pl.part;
  const bool copy_w3 = Cp != C || kBF16;
  if (copy_w3) {
    W34Srcs src = {};
    for (int k = 0; k < n_blocks; ++k) {
      src.w3[k] = a.blocks[k].w3;
      src.w4[k] = a.blocks[k].w4;
    }
    const long long most = (long long)D * (Cp > C ? Cp : C);
    prep_w34_kernel<kBF16><<<dim3(ceil_div(most, kThreads), n_blocks), kThreads, 0, st>>>(
        src, w3p, w4r, D, C, Cp);
    M2M_TRY(cudaGetLastError());
  }
  auto* twr = reinterpret_cast<__nv_bfloat16*>(ws + pl.twr);
  for (int k = 0; k < n_blocks; ++k) {
    const BlockPtrs& p = a.blocks[k];
    const float* in = k ? nullptr : x;
    const float* b4_prev = k ? a.blocks[k - 1].b4 : nullptr;
    float* save = a.saved ? a.saved + k * slot : nullptr;
    if (pl.reg) {
      prefix<<<pl.tiles, kThreads, pl.prefix_smem, st>>>(in, part, pl.ksplit, b4_prev, x1, z,
                                                         save, B, N, T, D, pl.tb, tanh_flavor, p,
                                                         a.dp, k);
      M2M_TRY(cudaGetLastError());
    } else if constexpr (kBF16) {
      const TokenWgBufs tbufs{twr, twr + (size_t)N * pl.Tp,
                              reinterpret_cast<__nv_bfloat16*>(ws + pl.yt),
                              reinterpret_cast<__nv_bfloat16*>(ws + pl.ht), ws + pl.tt, pl.Np,
                              pl.Tp};
      M2M_TRY_INT(token_forward_wg(in, part, pl.ksplit, b4_prev, x1, z, save, tbufs, p.ln1_s,
                                   p.ln1_b, p.w1, p.b1, p.w2, p.b2, p.ln2_s, p.ln2_b, B, N, T, D,
                                   pl.nc, tanh_flavor, a.dp, k, device, st));
    } else {
      const TokenBufs tbufs{ws + pl.yt, ws + pl.ht, ws + pl.tt, nullptr};
      M2M_TRY_INT(token_forward<false>(in, part, pl.ksplit, b4_prev, x1, z, save, tbufs, p.ln1_s,
                                       p.ln1_b, p.w1, p.b1, p.w2, p.b2, p.ln2_s, p.ln2_b, nullptr,
                                       nullptr, B, N, T, D, pl.nc, pl.sms, tanh_flavor, a.dp, k,
                                       st));
    }
    if constexpr (kBF16) {  // the channel products on the wgmma engine
      M2M_TRY(wg_product<64>(z, D, w3p + (size_t)k * D * Cp, Cp, nullptr, R, Cp, D, D, 1,
                             EpiUpWg{p.b3, h2, C, tanh_flavor, k, a.dp}, device, st));
      M2M_TRY(wg_product<kWgBN>(h2, Cp, w4r + (size_t)k * C * D, D, part, R, D, C, pl.kslice,
                                pl.ksplit, EpiWgStore{}, device, st));
    } else {
      const float* w3 = copy_w3 ? w3p + (size_t)k * D * Cp : p.w3;
      M2M_TRY(tc_gemm_auto(View{z, D, 1}, View{w3, Cp, 1}, h2, R, Cp, D, pl.sms, st,
                           EpiUp{p.b3, C, tanh_flavor, k, a.dp}));
      M2M_TRY(tc_gemm_wide(View{h2, Cp, 1}, View{p.w4, D, 1}, part, R, D, C, pl.kslice,
                           pl.ksplit, st));
    }
  }
  finish_kernel<kBF16><<<ceil_div(R, kThreads / 32), kThreads, pl.finish_smem, st>>>(
      x1, part, pl.ksplit, a.blocks[n_blocks - 1].b4, a.saved ? a.saved + n_blocks * slot : nullptr,
      out, final_ln ? a.lnf_s : nullptr, a.lnf_b, R, D, a.dp, n_blocks - 1);
  return (int)cudaGetLastError();
}

}  // namespace

std::atomic<unsigned long long> m2m_tally[kTallies];

extern "C" {

const char* m2m_error_string(int code) {
  if (code == -1) return "invalid shape arguments for the mixer kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out[kTallies]: the launches of each tallied kernel (M2mTally order: the
// wgmma engine, tc_gemm, the token pipeline's tok_in_kernel) since the
// library was loaded.
void m2m_launch_tally(unsigned long long* out) {
  for (int i = 0; i < kTallies; ++i) out[i] = m2m_tally[i].load(std::memory_order_relaxed);
}

// 1 if the pipeline forward runs the token FF as products (token_ff.cuh: above
// kMaxTokens tokens, or where a sample's rows do not fit the prefix tile), 0 if
// in registers, -1 for shapes the kernels do not take.
int m2m_mixer_fwd_token_ff(int B, int N, int T, int D, int C, int device) {
  FwdPlan pl;
  if (check_args(B, N, T, D, C, 1) || make_fwd_plan(B, N, T, D, C, 1, 0, device, pl)) return -1;
  return !pl.reg;
}

// Workspace bytes of the pipeline forward of n_blocks blocks (float32, or bf16
// compute; the wrapper allocates it); 0 for shapes the kernels do not take.
size_t m2m_mixer_fwd_workspace_bytes(int B, int N, int T, int D, int C, int n_blocks, int bf16,
                                     int device) {
  FwdPlan pl;
  if (check_args(B, N, T, D, C, n_blocks) ||
      make_fwd_plan(B, N, T, D, C, n_blocks, bf16, device, pl))
    return 0;
  return pl.ws_floats * 4;
}

// K1f / K2f on the pipeline: n_blocks MixerBlocks (+ the final LN when final_ln), x and
// out (B, N, D). ptrs: 12 parameter pointers per block in MixerBlockParams order,
// then (ln_scale, ln_bias) if final_ln; saved: nullptr, or room for n_blocks + 1
// (B, N, D) float32 slots that receive every block's input and the output before
// the final LN (what m2m_mixer_bwd reads). keys: 4 dropout stream keys per block
// (host array), or nullptr for no dropout; thresh and scale: keep iff bits >=
// thresh, kept values times scale. bf16: bf16 compute (_block_math's casts; every
// parameter float32, rounded where JAX casts it). device: the CUDA device the
// tensors and the stream live on (this library has its own runtime); workspace:
// m2m_mixer_fwd_workspace_bytes bytes.
int m2m_mixer_fwd(const float* x, float* out, float* saved, int B, int N, int T, int D, int C,
                  int n_blocks, int final_ln, int tanh_flavor, const unsigned* keys,
                  unsigned thresh, float scale, int bf16, int device, const void* const* ptrs,
                  void* workspace, void* stream) {
  if (check_args(B, N, T, D, C, n_blocks)) return -1;
  M2M_TRY(cudaSetDevice(device));
  const StackArgs a = pack(ptrs, n_blocks, final_ln, saved,
                           make_dropout(keys, n_blocks, thresh, scale));
  return (bf16 ? run_pipeline<true> : run_pipeline<false>)(
      x, out, B, N, T, D, C, n_blocks, final_ln, tanh_flavor, a, static_cast<float*>(workspace),
      device, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
