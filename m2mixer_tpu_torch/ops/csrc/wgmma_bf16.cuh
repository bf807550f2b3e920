// The bf16 product engine of the mixer and gMLP kernels on Hopper's warpgroup
// tensor-core instruction (wgmma) with operand tiles brought in by TMA: the
// channel FF's five products of bf16 K1b and K2b (mixer_bwd.cu,
// block_bwd<true>), every product of bf16 K1f and K2f (mixer_fwd.cu: the
// channel FF's up and down products and, on the token pipeline, the token
// FF's two; the header there has their bound and tiles), and the D x F and
// F/2 x D products of bf16 K3f and K3b (gmlp.cu: the in- and out-projections,
// dgated, dxn and the two weight gradients, dpre split as da3 is below), and
// the nine products of bf16 K4f and K4b (dynamixer.cu).
//
// Replaces, with the rest of mixer_bwd.cu's bf16 route, the products of the TPU
// kernels m2mixer_tpu/ops/mixer_kernel.py::_bwd_rule (:267) and
// _stack_bwd_rule (:506) at compute_dtype=bfloat16: jax.vjp of _block_math
// (:85-124), whose every product has float32 sums and one operand that holds
// bf16 values:
//   a3  = z W3          both operands bf16;
//   dh2 = da4 W4^T      da4 = bf16(g) m3;
//   dW4 = h2^T da4      (computed as dW4^T = da4^T h2, transposed by the reduction);
//   dz  = da3 W3^T      da3 = bf16(dh2) m2 gelu'(a3), a true float32 value;
//   dW3 = z^T da3.
//
// What bounds it. At the L config's fusion mixer (B 512, N 80, D 512, C 4096;
// R = B*N = 40960 rows) each product is 2*R*D*C = 171.8 GFLOP. The design
// runs nine bf16 passes (a3, dh2 and dW4 once each, dz and dW3 three times
// each, below): 1.55 TFLOP, 1.56 ms at the dense bf16 peak of 989 TFLOP/s,
// against a few hundred MB of operands (3.35 TB/s: about 0.3 ms). Operations
// bound it at batch 512; at batch 32 the launches do.
//
// What the design does about it:
// - Operands are bf16 in device memory (w3p, w4t, z, da4, h2 and da3's planes,
//   rows padded to Cp = C rounded up to 8, whole 16-byte groups as TMA needs),
//   and every product runs as wgmma.mma_async m64n128k16 .f32.bf16.bf16 from
//   shared memory: the only instruction that reaches the card's bf16 rate
//   (mma.sync, tile_common.cuh's tc_gemm, ran these at about cuBLAS's float32
//   SIMT time).
// - A CTA owns a 128 x 128 output tile (dz, the weight gradients; one CTA an
//   SM): two consumer warpgroups of 64 rows, each with a 64 x 128 float32
//   accumulator. The depth runs in stages of 64 (one 128-byte swizzled row of
//   bf16) through a ring of 3-4 stages in shared memory that one thread keeps
//   filled with TMA loads (cp.async.bulk.tensor, 128-byte swizzle, completion
//   on an mbarrier per stage); ragged edges come in as TMA's out-of-bounds
//   zeros. The ring refills a stage when both warpgroups are done with it
//   (one CTA barrier a stage); there is no producer warp and no persistent
//   scheduler. a3 and dh2 (depth D only, and an epilogue of GELU, its
//   derivative, the dropout hash and the split for every element) take a
//   128 x 64 tile, two CTAs an SM, so one CTA's epilogue runs beside the
//   other's products.
// - Both layouts a bf16 wgmma operand may take in shared memory: K-major
//   (the depth contiguous: z, da4 and da3 as the rows' operand, W3 as dz's
//   second) and MN-major (the rows or columns contiguous: the weight
//   gradients, whose depth is the rows, read z, da4, h2 and da3 as they lie,
//   and a3 and dh2 read W3 and W4^T the same way), so no operand is ever
//   transposed in device memory. The instruction's transpose bits pick the
//   layout.
// - Accumulation: each stage's products go into zeroed registers (the first
//   wgmma of a stage with scale-d 0), which are then added to the float32
//   accumulator: the tensor core aligns its products to the accumulator's
//   exponent and truncates, and against a running sum over thousands of
//   rows that biases low bits toward zero (enough to push the B bf16 K2b
//   gate past its limit on tc_gemm); one float32 add a stage rounds to
//   nearest. Hence two
//   accumulator sets a thread, 64 + 64 registers at a 128-wide tile.
// - The float32 cotangents keep their precision by splitting, not by a
//   float32 product:
//   * da4 = bf16(g) x keep x 1/(1-p): the engine reads da4's bf16(g) x keep
//     bit (exact in bf16), and the dropout scale multiplies the float32 sums
//     in the epilogue. One pass each for dh2 and dW4, equal to JAX's
//     sum fl(g s) w to float32 rounding.
//   * da3 is split into three bf16 planes, hi = bf16(x), mid = bf16(x - hi),
//     lo = bf16(x - hi - mid), together 24 bits of x; each term times a bf16
//     operand is exact in the float32 accumulator, so dz and dW3 are three
//     passes each, smallest term first (at least as precise as the 2xTF32
//     of tc_gemm, about 22 bits). The planes are written by the a3/dh2
//     epilogue (EpiChannelWg in mixer_bwd.cu), 3 x 2 bytes an element of
//     R x Cp, against the 4 of a float32 da3: 6 * R * Cp bytes, 1.01 GB at L
//     fusion batch 512, where h2 and the operands the float32 layout held
//     as float32 shrink by more (mixer_bwd.cu's plan). The planes are read
//     by TMA like any operand; a split in registers would need wgmma's
//     register-A operand, which K-major fragments of da3 would feed only for
//     dz and not for dW3 (da3 is dW3's MN-major B).
//   * a3 and dh2 run in one CTA, one after the other over the same tile (the
//     first's sums parked in shared memory), so the epilogue has a3 and dh2
//     at once and a3 never goes to device memory.
// - No float atomics: a product sliced over its depth writes each slice's
//   partial apart, and the reductions add them in slice order, so two runs
//   give bit-identical results.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mixer_common.cuh"
#include "tile_common.cuh"

namespace {

constexpr int kWgBM = 128;           // output rows of a CTA: two warpgroups of 64
constexpr int kWgBN = 128;           // output columns of a CTA (the wgmma's N); a3/dh2: 64
constexpr int kWgBK = 64;            // depth of a stage: 64 bf16, one 128-byte row
constexpr int kWgThreads = 256;      // the two consumer warpgroups
constexpr int kWgTile = 128 * kWgBK * 2;  // bytes of one operand plane a stage (16 KB)
constexpr int kWgHalf = kWgTile / 2;      // 64 rows of 128 bytes (one TMA box of 64 x 64)
constexpr int kWgMaxTerms = 3;       // planes of a split operand (hi, mid, lo)

// One product of the engine: out = sum over the planes of A_t B_t. The
// unsplit operand has one plane; the split one (A or B) terms_a or terms_b.
struct WgJob {
  CUtensorMap a[kWgMaxTerms];
  CUtensorMap b[kWgMaxTerms];
  int terms_a, terms_b;
  float* out;   // the plain store's (M x N row-major, a slice's partial apart)
  float scale;  // multiplies the sums (the dropout scale of da4)
};

// out[z] (M x N) over depth slice z of kslice (a multiple of kWgBK) of K.
// kSeq 1: job blockIdx.z / slices, slice blockIdx.z % slices; kSeq 2: every
// CTA runs job 0 then job 1 over the whole depth (a3, then dh2).
struct WgArgs {
  WgJob job[2];
  int M, N, K, kslice, slices;
};

// ------------------------------------------------------------ device helpers
// c += a b, a 16 x 16 (row), b 16 x 8 (col), bf16; the mma's sum added in
// float32: the warp-level bf16 tensor-core product beside the engine (the
// gMLP's SGU, the DynaMixerOp's dP)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  float t[4];
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(t[0]), "=f"(t[1]), "=f"(t[2]), "=f"(t[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += t[i];
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// the box of `map` at (c0 inner, c1 outer) into shared memory at dst,
// completion (its bytes) on the mbarrier at bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// a wgmma shared-memory operand descriptor, 128-byte swizzle (layout type 1):
// start address, leading and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads of an accumulator across the wait
template <int kN>
__device__ __forceinline__ void wg_fence_regs(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 float32, the warpgroup's) = A B + (acc ? d : 0), A 64 x 16 and
// B 16 x 128 bf16 in shared memory; kTA / kTB: the operand is MN-major
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc), "n"(kTA), "n"(kTB));
}

// the same with B 16 x 64 and d 64 x 64
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(kTA), "n"(kTB));
}

template <int kBN, int kTA, int kTB>
__device__ __forceinline__ void wgmma_tile(float (&d)[kBN / 2], uint64_t da, uint64_t db,
                                           int acc) {
  if constexpr (kBN == 128) {
    wgmma_m64n128k16<kTA, kTB>(d, da, db, acc);
  } else {
    wgmma_m64n64k16<kTA, kTB>(d, da, db, acc);
  }
}

// Operand tiles in shared memory, one plane a stage (kWgTile bytes; B's
// kBN * 128 bytes):
//   K-major (depth contiguous): one TMA box of 64 deep x 128 rows, row i at
//     i * 128 bytes (8-row swizzle atoms of 1024 bytes); a warpgroup's 64
//     rows start 64 rows in; the k16 step kk starts 32 * kk bytes in.
//   MN-major (rows/columns contiguous): two TMA boxes of 64 wide x 64 deep,
//     columns 0-63 then 64-127, depth row k at k * 128 bytes; the k16 step
//     starts 16 rows (2048 bytes) further; the next 64 columns (an N of
//     128, B's) are one box (kWgHalf bytes) on: the leading byte offset; the
//     next 8 rows of the depth are an atom (1024 bytes) on: the stride offset.
//     An N of 64 is one box.
template <bool kK>
__device__ __forceinline__ uint64_t operand_desc(uint32_t tile, int kk) {
  if constexpr (kK) return wg_desc(tile + 32 * kk, 16, 1024);
  return wg_desc(tile + 2048 * kk, kWgHalf, 1024);
}

// the plane's box(es) of the stage: rows/columns [o0, o0 + kW) at depth k
template <bool kK, int kW = 128>
__device__ __forceinline__ void load_operand(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                             int k, int o0) {
  static_assert(kW == 128 || !kK, "a K-major operand is 128 rows");
  if constexpr (kK) {
    tma_load(dst, map, bar, k, o0);
  } else {
    tma_load(dst, map, bar, o0, k);
    if constexpr (kW == 128) tma_load(dst + kWgHalf, map, bar, o0 + 64, k);
  }
}

// A kernel's shared memory: the ring (and, two products in sequence, the
// first's sums). A 128-wide tile takes one CTA an SM (192 KB); a 64-wide one
// two (at most 104 KB each; two products in sequence) or three (72 KB, a ring
// of three stages; one product, the bf16 forward's, whose up products' GELU
// epilogue takes about as long as their products), so one CTA's epilogue runs
// beside the others' products.
template <int kTermsA, int kTermsB, int kSeq, int kBN>
struct WgShape {
  static constexpr int ctas = kBN == 128 ? 1 : (kSeq == 2 ? 2 : 3);  // CTAs an SM
  static constexpr int b_tile = kBN * kWgBK * 2;
  static constexpr int stage = kTermsA * kWgTile + kTermsB * b_tile;
  static constexpr int stash = kSeq == 2 ? kWgBM * kBN * 4 : 0;
  static constexpr int stages = ((ctas == 3 ? 72 : ctas == 2 ? 104 : 192) * 1024 - stash) / stage;
  // + 1024: the base aligned to the swizzle atom; + the stages' mbarriers
  static constexpr size_t smem = (size_t)stages * stage + stash + 1024 + 8 * stages;
  static_assert(stages >= 2, "a ring of at least two stages");
  static_assert(kBN == 64 || kBN == 128, "tiles 128 or 64 wide");
};

// The plain store of a product's sums: jb.out[slice] (M x N) = scale x sum.
// An epilogue with kOuts 0 stores float32 sums itself; one with kOuts > 0
// fills kOuts bf16 outputs that the kernel stages and writes (below).
struct EpiWgStore {
  static constexpr int kOuts = 0;
  __device__ __forceinline__ void operator()(const WgJob& jb, const WgArgs& a, int slice, int r,
                                             int c, float v0, float v1) const {
    float* o = jb.out + (size_t)slice * a.M * a.N + (size_t)r * a.N + c;
    if (c + 1 < a.N && !(a.N & 1)) {
      *reinterpret_cast<float2*>(o) = make_float2(v0 * jb.scale, v1 * jb.scale);
    } else {
      o[0] = v0 * jb.scale;
      if (c + 1 < a.N) o[1] = v1 * jb.scale;
    }
  }
};

// out = epi(sum over the planes of A_t B_t) over a 128 x kBN tile; the split
// operand's planes (A's with kTermsA > 1, B's with kTermsB > 1) run smallest
// first into the stage's zeroed registers. kAK / kBK: the operand is K-major
// (else MN-major; a 64-wide tile's B is). The sums of a pair of neighbouring
// columns (c, c + 1) go to the epilogue together: with Epi::kOuts 0,
// epi(job, args, slice, r, c, v0, v1) stores them; else epi(r, c, v0, v1,
// out), or with kSeq 2 epi(r, c, first0, first1, second0, second1, out),
// fills the pair of each of its Epi::kOuts bf16 outputs, which the kernel
// writes to epi.dst(k) (rows N apart; N a multiple of 8) in whole rows.
template <bool kAK, bool kBK, int kTermsA, int kTermsB, int kSeq, int kBN, class Epi>
__global__ void __launch_bounds__(kWgThreads, WgShape<kTermsA, kTermsB, kSeq, kBN>::ctas)
    wg_gemm_kernel(const __grid_constant__ WgArgs args, const __grid_constant__ Epi epi) {
  using S = WgShape<kTermsA, kTermsB, kSeq, kBN>;
  static_assert(kBN == 128 || !kBK, "a 64-wide tile's B is MN-major");
  constexpr int kAcc = kBN / 2;  // accumulator floats a thread
  extern __shared__ uint8_t wg_smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) &
                                           ~uintptr_t(1023));
  float* stash = reinterpret_cast<float*>(sm + S::stages * S::stage);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S::stages * S::stage + S::stash);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.y * kWgBM, n0 = blockIdx.x * kBN;
  const int job0 = kSeq == 2 ? 0 : blockIdx.z / args.slices;
  const int slice = kSeq == 2 ? 0 : blockIdx.z % args.slices;
  const int k0 = slice * args.kslice, k1 = min(args.K, k0 + args.kslice);
  const int nk = k1 > k0 ? (k1 - k0 + kWgBK - 1) / kWgBK : 0;
  const int total = nk * kSeq;
  const uint32_t base = smem_u32(sm);

  auto issue = [&](int it) {  // thread 0: stage it % stages <- depth tile it
    const int s = it % S::stages;
    const WgJob& jb = args.job[kSeq == 2 ? it / nk : job0];
    const int k = k0 + (kSeq == 2 ? it % nk : it) * kWgBK;
    const uint32_t bar = smem_u32(full + s), st = base + s * S::stage;
    mbar_expect_tx(bar, (uint32_t)(jb.terms_a * kWgTile + jb.terms_b * S::b_tile));
    for (int p = 0; p < jb.terms_a; ++p) load_operand<kAK>(st + p * kWgTile, &jb.a[p], bar, k, m0);
    for (int p = 0; p < jb.terms_b; ++p)
      load_operand<kBK, kBN>(st + kTermsA * kWgTile + p * S::b_tile, &jb.b[p], bar, k, n0);
  };

  if (tid == 0) {
    for (int s = 0; s < S::stages; ++s) mbar_init(smem_u32(full + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int it = 0; it < total && it < S::stages; ++it) issue(it);

  float acc[kAcc], tmp[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = tmp[i] = 0.f;
  for (int it = 0; it < total; ++it) {
    const int s = it % S::stages;
    mbar_wait(smem_u32(full + s), (uint32_t)(it / S::stages) & 1);
    const WgJob& jb = args.job[kSeq == 2 ? it / nk : job0];
    const int terms = jb.terms_a > jb.terms_b ? jb.terms_a : jb.terms_b;
    const uint32_t st = base + s * S::stage;
    wg_fence_regs(tmp);
    wg_fence();
    for (int t = terms - 1; t >= 0; --t) {  // lo, mid, hi
      const uint32_t ta = st + (jb.terms_a > 1 ? t : 0) * kWgTile + wg * kWgHalf;
      const uint32_t tb = st + kTermsA * kWgTile + (jb.terms_b > 1 ? t : 0) * S::b_tile;
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk)
        wgmma_tile<kBN, kAK ? 0 : 1, kBK ? 0 : 1>(tmp, operand_desc<kAK>(ta, kk),
                                                  operand_desc<kBK>(tb, kk),
                                                  t != terms - 1 || kk != 0);
    }
    wg_commit();
    wg_wait_all();
    wg_fence_regs(tmp);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] += tmp[i];
    if (kSeq == 2 && it == nk - 1) {  // the first product's sums to the stash
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        stash[i * kWgThreads + tid] = acc[i];
        acc[i] = 0.f;
      }
    }
    __syncthreads();  // every warpgroup is done with stage s
    if (tid == 0 && it + S::stages < total) issue(it + S::stages);
  }

  // element (row, column) of the 64 x kBN warpgroup tile held in acc[4 i + e]:
  // row 16 warp + lane / 4 + 8 (e / 2), column 8 i + 2 (lane % 4) + e % 2
  const int lane = tid & 31, warp = (tid & 127) >> 5;
  const int rloc = wg * 64 + warp * 16 + (lane >> 2), cloc = 2 * (lane & 3);
  static_assert(kSeq == 1 || Epi::kOuts > 0, "two products in sequence stage their outputs");
  if constexpr (Epi::kOuts > 0) {
    // the tile's Epi::kOuts bf16 outputs, staged in the ring (all its loads are
    // consumed) as rows of kBN bf16 whose 16-byte chunks are swizzled by the
    // row (chunk j of row i at j ^ (i % 8): the fragment stores of a warp's 8
    // rows hit 32 banks), then written out a whole row at a time
    constexpr int kRow = kBN * 2, kChunks = kRow / 16, kOut = kWgBM * kRow;
    static_assert(Epi::kOuts * kOut <= S::stages * S::stage, "the staging fits the ring");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = rloc + 8 * h, cl = cloc + 8 * i, e = 4 * i + 2 * h;
        __nv_bfloat162 v[Epi::kOuts];
        if constexpr (kSeq == 2)
          epi(m0 + rl, n0 + cl, stash[e * kWgThreads + tid], stash[(e + 1) * kWgThreads + tid],
              acc[e], acc[e + 1], v);
        else
          epi(m0 + rl, n0 + cl, acc[e], acc[e + 1], v);
        const int at = rl * kRow + (((cl >> 3) ^ (rl & 7)) << 4) + (cl & 7) * 2;
#pragma unroll
        for (int k = 0; k < Epi::kOuts; ++k)
          *reinterpret_cast<__nv_bfloat162*>(sm + k * kOut + at) = v[k];
      }
    }
    __syncthreads();
    for (int q = tid; q < Epi::kOuts * kWgBM * kChunks; q += kWgThreads) {
      const int k = q / (kWgBM * kChunks), rl = q / kChunks % kWgBM, j = q % kChunks;
      const int r = m0 + rl, c = n0 + 8 * j;
      if (r < args.M && c < args.N)
        *reinterpret_cast<uint4*>(epi.dst(k) + (size_t)r * args.N + c) =
            *reinterpret_cast<const uint4*>(sm + k * kOut + rl * kRow + ((j ^ (rl & 7)) << 4));
    }
  } else {
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + rloc + 8 * h, c = n0 + cloc + 8 * i, e = 4 * i + 2 * h;
        if (r < args.M && c < args.N)
          epi(args.job[job0], args, slice, r, c, acc[e], acc[e + 1]);
      }
    }
  }
}

// ------------------------------------------------------------------ host side
// cuTensorMapEncodeTiled, the entry point the runtime resolves in the loaded
// libcuda (no link against it)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p)
                                                                : nullptr;
  }();
  return fn;
}

// The TMA map of a bf16 row-major matrix (rows x cols, ld elements a row, a
// multiple of 8) as the engine reads it: k_major, boxes of 64 columns x 128
// rows (the depth is the columns); else boxes of 64 x 64 (the depth is the
// rows). Out-of-bounds elements read as zeros.
//
// A map is a function of these arguments alone, and a call's operands (the
// wrappers' workspace, from PyTorch's caching allocator) lie at the same
// addresses call after call, so the encoded maps are kept, direct-mapped in
// kMapSlots slots: a hit copies 128 bytes in place of the driver's encode,
// host time a call pays for each operand plane (at batch 32 the host paces
// the calls).
struct MapKey {
  const void* p;
  long long rows, cols, ld;
  bool k_major;
  bool operator==(const MapKey& o) const {
    return p == o.p && rows == o.rows && cols == o.cols && ld == o.ld && k_major == o.k_major;
  }
};
constexpr int kMapSlots = 256;

inline cudaError_t make_operand_map(CUtensorMap* map, const void* p, long long rows,
                                    long long cols, long long ld, bool k_major) {
  struct Slot {
    MapKey key;
    CUtensorMap map;
    bool used;
  };
  static std::mutex mu;  // the wrappers' ctypes calls release the GIL
  static Slot slots[kMapSlots];
  if (ld % 8 || reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorInvalidValue;
  const MapKey key{p, rows, cols, ld, k_major};
  const uint64_t h = (reinterpret_cast<uintptr_t>(p) >> 8) * 0x9E3779B97F4A7C15ull ^
                     (uint64_t)rows * 0xC2B2AE3D27D4EB4Full ^ (uint64_t)cols * 0x165667B19E3779F9ull ^
                     (uint64_t)ld * 31 ^ (uint64_t)k_major;
  Slot& slot = slots[(h ^ h >> 29) % kMapSlots];
  std::lock_guard<std::mutex> lock(mu);
  if (slot.used && slot.key == key) {
    *map = slot.map;
    return cudaSuccess;
  }
  const EncodeTiledFn encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, k_major ? 128u : 64u};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  slot = Slot{key, *map, true};
  return cudaSuccess;
}

// a job's planes: the operand matrices (bf16, rows x cols, ld), A's then B's
struct WgOperand {
  const __nv_bfloat16* p[kWgMaxTerms];
  int terms;
  long long rows, cols, ld;
};

template <bool kAK, bool kBK>
cudaError_t make_job(WgJob& jb, const WgOperand& a, const WgOperand& b, float* out, float scale) {
  for (int t = 0; t < a.terms + b.terms; ++t) {
    const bool is_a = t < a.terms;
    const WgOperand& o = is_a ? a : b;
    const cudaError_t e = make_operand_map(is_a ? &jb.a[t] : &jb.b[t - a.terms],
                                           o.p[is_a ? t : t - a.terms], o.rows, o.cols, o.ld,
                                           is_a ? kAK : kBK);
    if (e != cudaSuccess) return e;
  }
  jb.terms_a = a.terms;
  jb.terms_b = b.terms;
  jb.out = out;
  jb.scale = scale;
  return cudaSuccess;
}

// grid: N in kBN-column tiles, M in 128-row tiles, `jobs` x slices (kSeq 1)
template <bool kAK, bool kBK, int kTermsA, int kTermsB, int kSeq, int kBN, class Epi>
cudaError_t wg_gemm(const WgArgs& args, int jobs, const Epi& epi, int device, cudaStream_t st) {
  using S = WgShape<kTermsA, kTermsB, kSeq, kBN>;
  auto kernel = wg_gemm_kernel<kAK, kBK, kTermsA, kTermsB, kSeq, kBN, Epi>;
  const cudaError_t e = prepare(kernel, S::smem, device);
  if (e != cudaSuccess) return e;
  const dim3 grid(ceil_div(args.N, kBN), ceil_div(args.M, kWgBM),
                  kSeq == 2 ? 1 : jobs * args.slices);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidConfiguration;
  kernel<<<grid, kWgThreads, S::smem, st>>>(args, epi);
  m2m_count(kTallyWgGemm);
  return cudaGetLastError();
}

// out = epi(A B) for one product on the engine: A (M x K) K-major, B (K x N)
// MN-major, bf16 row-major matrices with row strides lda and ldb (multiples
// of 8; B's N columns are the output's, pad columns included); the depth in
// `split` slices of kslice (a multiple of kWgBK), the kBN-wide tile
template <int kBN, class Epi>
cudaError_t wg_product(const __nv_bfloat16* a, long long lda, const __nv_bfloat16* b,
                       long long ldb, float* out, long long M, int N, int K, int kslice,
                       int split, const Epi& epi, int device, cudaStream_t st) {
  WgArgs args = {};
  const cudaError_t e = make_job<true, false>(args.job[0], WgOperand{{a}, 1, M, K, lda},
                                              WgOperand{{b}, 1, K, N, ldb}, out, 1.f);
  if (e != cudaSuccess) return e;
  args.M = (int)M, args.N = N, args.K = K, args.kslice = kslice, args.slices = split;
  return wg_gemm<true, false, 1, 1, 1, kBN>(args, 1, epi, device, st);
}

// slices of a depth K (each whole stages) for `tiles` output tiles: about
// `waves` CTAs an SM (one CTA fits an SM), at most kMaxRowSplit slices
inline void wg_slices(long long K, long long tiles, int sms, int waves, int& slice, int& split) {
  long long n = (waves * (long long)sms + tiles - 1) / tiles;
  n = n < 1 ? 1 : (n > kMaxRowSplit ? kMaxRowSplit : n);
  slice = ceil_div(ceil_div(K, n), kWgBK) * kWgBK;
  split = ceil_div(K, slice);
}

}  // namespace
