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
// 54 us of float32 on the CUDA cores (67 TFLOP/s) against 15 us of HBM, so
// operations bound it; K4b does about twice the work.
//
// Design. A sequence is small (L x C float32, 7 KB), and everything but the
// output projection couples only a sequence's own tokens; the projection is a
// plain GEMM over all S*L rows with a 256 KB weight, above the 227 KB of
// shared memory a CTA may use. So:
//   forward, 2 launches:
//     1. mix: a CTA owns `spc` whole sequences (1-4, enough CTAs for two
//        waves), with W_c and W_g in shared memory; it computes comp, the
//        logits, the softmax (the maximum over m subtracted first) and the mix
//        there, and writes mixed (S*L, C);
//     2. out: y = mixed W_o^T + b_o on the tensor cores (tc_gemm_auto, the bias in
//        its epilogue; the 64x64 tile where the wide one would leave SMs idle).
//   backward, 6 launches; the autograd Function saves only x, so the
//   per-sequence intermediates are recomputed:
//     1. d_mixed = g W_o (the tensor-core tile GEMM);
//     2. seq: per CTA of whole sequences, W_c (and its transpose) and W_g in
//        shared memory: recompute comp, P and mixed (written for dW_o); dP =
//        d_mixed-by-head x^T; the softmax backward over m; d_comp = d_logit
//        W_g^T, laid back to (S*L, H*R); dx = the mix's backward (sum_l P
//        d_mixed) + d_comp W_c^T; the CTA's partials of dW_g and db_g;
//     3. dW_o = g^T mixed and 4. dW_c = x^T d_comp (transposed to output-major
//        as its partials are reduced): tensor-core tiles of the weight (128x64,
//        and 64x16 for dW_c's H*R = 16 columns), the S*L rows split into a
//        fixed number of slices;
//     5. db_o, db_c: column sums over row slices (enough for two waves: a
//        slice is one thread's serial sum);
//     6. every partial reduced in a fixed order (compensated), one launch.
//   No float atomics: two runs give bit-identical gradients. dW_c never takes
//   per-CTA partials (4096 floats a CTA); dW_g and db_g (L*R*L*L + L*L = 735
//   floats) take one per sequence CTA.
// Products: K4f's output projection and K4b's three GEMMs (steps 1, 3, 4) run
// on the tensor cores in 3xTF32 through tc_gemm (tile_common.cuh says why that
// split and why mma.sync rather than wgmma); the sequence kernels' small
// per-head products are SIMT (float32 on the CUDA cores), and are the next
// part to redesign (PERF.md).
//
// bf16 compute (kBF16; compute_dtype=bfloat16) computes what _op_math computes
// in bf16 (dynamixer_kernel.py:35-59) and what JAX's AD of it computes: x rounded
// to bf16; W_c, W_g and W_o read rounded (in shared memory, and W_o as a
// rounded copy in the workspace; the parameters arrive in float32); comp + b_c
// rounded where the generate product casts it; the logits, the softmax and the
// mix in float32; mixed rounded where the output product casts it; biases
// added in float32. The backward rounds each cotangent of a bf16 operand:
// d_mixed = g W_o, d_gin = d_logit W_g^T, the mix's and the compress
// product's parts of dx (each, before their float32 sum), and dW_o, dW_c and
// dW_g (after the sum over the batch; JAX rounds per batch tile, which is the
// whole batch at its tile sizes); the bias gradients stay float32. Products
// of two bf16 operands take one mma of the tile, of one bf16 operand two
// (tc_gemm's kExact).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mixer_common.cuh"
#include "tile_common.cuh"

namespace {

constexpr int kMaxL = 32;          // tokens a sequence may have (the wrapper's _MAX_TOKENS)
constexpr int kMaxC = 1024;        // channels (the wrapper's _MAX_CHANNELS)
constexpr int kMaxSeqPerCta = 4;   // sequences a per-sequence CTA owns
constexpr int kMaxColSplit = 256;  // row slices of the bias gradients' column sums
constexpr int kRedJobs = 5;        // dW_o, dW_c, db_o, db_c, dW_g + db_g

struct Weights {  // output-major (torch Linear's layout)
  const float* wc;  // (H*R, C)
  const float* bc;  // (H*R,)
  const float* wg;  // (L*L, L*R)
  const float* bg;  // (L*L,)
  const float* wo;  // (C, C)
  const float* bo;  // (C,)
};

// the op's sizes and the shared-memory layout of a per-sequence CTA (offsets
// in floats; -1 where the forward has no such array)
struct Geo {
  int S, L, C, H, R, spc;
  int wc, wct, bc, wg, bg, x, dm, comp, p, dp, dcomp, total;
};

Geo make_geo(int S, int L, int C, int H, int R, int spc, bool bwd) {
  Geo g = {S, L, C, H, R, spc};
  const int HR = H * R, LR = L * R, LL = L * L;
  int o = 0;
  auto take = [&o](int n) {
    const int at = o;
    o += n;
    return at;
  };
  g.wc = take(C * HR);
  g.wct = bwd ? take(C * HR) : -1;
  g.bc = take(HR);
  g.wg = take(LR * LL);
  g.bg = take(LL);
  g.x = take(spc * L * C);
  g.dm = bwd ? take(spc * L * C) : -1;
  g.comp = take(spc * L * HR);
  g.p = take(spc * H * LL);
  g.dp = bwd ? take(spc * H * LL) : -1;
  g.dcomp = bwd ? take(spc * L * HR) : -1;
  g.total = o;
  return g;
}

// W_c, b_c, W_g and b_g into shared memory input-major (the weights rounded to
// the compute dtype); the backward also keeps W_c output-major (C fastest), so
// that dx's d_comp W_c^T reads without conflicts
template <bool kBF16>
__device__ void load_weights(float* sm, const Weights& w, const Geo& g) {
  const int HR = g.H * g.R, LR = g.L * g.R, LL = g.L * g.L;
  for (int i = threadIdx.x; i < g.C * HR; i += kThreads) {  // source element i: (j, c)
    const float v = rd<kBF16>(__ldg(w.wc + i));
    const int c = i % g.C, j = i / g.C;
    sm[g.wc + c * HR + j] = v;
    if (g.wct >= 0) sm[g.wct + j * g.C + c] = v;
  }
  for (int i = threadIdx.x; i < HR; i += kThreads) sm[g.bc + i] = __ldg(w.bc + i);
  for (int i = threadIdx.x; i < LR * LL; i += kThreads) {  // source element i: (n, k)
    const int k = i % LR, n = i / LR;
    sm[g.wg + k * LL + n] = rd<kBF16>(__ldg(w.wg + i));
  }
  for (int i = threadIdx.x; i < LL; i += kThreads) sm[g.bg + i] = __ldg(w.bg + i);
}

// comp, the logits and P = softmax over m of the CTA's nq sequences (x in
// shared memory): comp[q][l][j] (rounded to the compute dtype: the generate
// product's operand), p[q][h][m][l]; ends synchronised
template <bool kBF16>
__device__ void mixing_weights(float* sm, const Geo& g, int nq) {
  const int L = g.L, C = g.C, H = g.H, R = g.R, HR = H * R, LR = L * R, LL = L * L;
  const float* xs = sm + g.x;
  const float* wc = sm + g.wc;
  const float* wg = sm + g.wg;
  float* comp = sm + g.comp;
  float* p = sm + g.p;
  for (int o = threadIdx.x; o < nq * L * HR; o += kThreads) {
    const int j = o % HR;
    const float* xr = xs + (o / HR) * C;
    float acc = 0.f;
    for (int c = 0; c < C; ++c) acc = fmaf(xr[c], wc[c * HR + j], acc);
    comp[o] = rd<kBF16>(acc + sm[g.bc + j]);
  }
  __syncthreads();
  for (int o = threadIdx.x; o < nq * H * LL; o += kThreads) {
    const int n = o % LL, qh = o / LL, h = qh % H, q = qh / H;
    const float* cq = comp + q * L * HR + h * R;  // gin[q, h, i] = cq[(i / R) * HR + i % R]
    float acc = 0.f;
    for (int i = 0; i < LR; ++i) acc = fmaf(cq[(i / R) * HR + i % R], wg[i * LL + n], acc);
    p[o] = acc + sm[g.bg + n];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < nq * H * L; o += kThreads) {  // column (q, h, l), over m
    float* col = p + (o / L) * LL + o % L;
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
  __syncthreads();
}

// mixed[q][l][c] = sum_m P[q][h(c)][m][l] x[q][m][c] -> out (the CTA's rows),
// rounded to the compute dtype (the output product's operand)
template <bool kBF16>
__device__ void mix(const float* sm, const Geo& g, int nq, float* __restrict__ out) {
  const int L = g.L, C = g.C, Ch = C / g.H, LL = L * L;
  const float* xs = sm + g.x;
  const float* p = sm + g.p;
  for (int o = threadIdx.x; o < nq * L * C; o += kThreads) {
    const int c = o % C, row = o / C, l = row % L, q = row / L;
    const float* pp = p + (q * g.H + c / Ch) * LL + l;
    const float* xq = xs + q * L * C + c;
    float acc = 0.f;
    for (int m = 0; m < L; ++m) acc = fmaf(pp[m * L], xq[m * C], acc);
    out[o] = rd<kBF16>(acc);
  }
}

// n floats of src into dst, rounded to the compute dtype; also to `copy` when given
template <bool kBF16>
__device__ void load_rows(float* dst, const float* __restrict__ src, int n,
                          float* __restrict__ copy = nullptr) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float v = rd<kBF16>(src[i]);
    dst[i] = v;
    if (copy) copy[i] = v;
  }
}

// K4f step 1: mixed (S*L, C) of the CTA's sequences
template <bool kBF16>
__global__ void __launch_bounds__(kThreads)
    dyna_mix_kernel(const float* __restrict__ x, const Weights w, const Geo g,
                    float* __restrict__ mixed) {
  extern __shared__ __align__(16) float sm[];
  const int s0 = blockIdx.x * g.spc, nq = min(g.spc, g.S - s0);
  const size_t off = (size_t)s0 * g.L * g.C;
  load_weights<kBF16>(sm, w, g);
  load_rows<kBF16>(sm + g.x, x + off, nq * g.L * g.C);
  __syncthreads();
  mixing_weights<kBF16>(sm, g, nq);
  mix<kBF16>(sm, g, nq, mixed + off);
}

// K4b step 2, per CTA of whole sequences: mixed (for dW_o), d_comp, dx, and
// the CTA's partials of dW_g (L*R x L*L) then db_g (L*L) at part[blockIdx.x];
// kBF16: also x rounded to xr (dW_c's operand)
template <bool kBF16>
__global__ void __launch_bounds__(kThreads)
    dyna_seq_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dmixed,
                        const Weights w, const Geo g, float* __restrict__ mixed,
                        float* __restrict__ dcomp_out, float* __restrict__ dx,
                        float* __restrict__ part, float* __restrict__ xr) {
  extern __shared__ __align__(16) float sm[];
  const int L = g.L, C = g.C, H = g.H, R = g.R, HR = H * R, LR = L * R, LL = L * L;
  const int Ch = C / H;
  const int s0 = blockIdx.x * g.spc, nq = min(g.spc, g.S - s0);
  const size_t off = (size_t)s0 * L * C;
  const float* xs = sm + g.x;
  const float* dm = sm + g.dm;
  const float* comp = sm + g.comp;
  const float* p = sm + g.p;
  float* dp = sm + g.dp;
  float* dcomp = sm + g.dcomp;
  load_weights<kBF16>(sm, w, g);
  load_rows<kBF16>(sm + g.x, x + off, nq * L * C, kBF16 ? xr + off : nullptr);
  load_rows<false>(sm + g.dm, dmixed + off, nq * L * C);
  __syncthreads();
  mixing_weights<kBF16>(sm, g, nq);
  mix<kBF16>(sm, g, nq, mixed + off);
  // dP[q][h][m][l] = sum over the head's channels of d_mixed[q][l][c] x[q][m][c]
  for (int o = threadIdx.x; o < nq * H * LL; o += kThreads) {
    const int n = o % LL, qh = o / LL, h = qh % H, q = qh / H;
    const float* a = dm + (q * L + n % L) * C + h * Ch;
    const float* b = xs + (q * L + n / L) * C + h * Ch;
    float acc = 0.f;
    for (int c = 0; c < Ch; ++c) acc = fmaf(a[c], b[c], acc);
    dp[o] = acc;
  }
  __syncthreads();
  // the softmax backward over m, in place: d_logit = P (dP - sum_m P dP)
  for (int o = threadIdx.x; o < nq * H * L; o += kThreads) {
    const int at = (o / L) * LL + o % L;
    float s = 0.f;
    for (int m = 0; m < L; ++m) s = fmaf(p[at + m * L], dp[at + m * L], s);
    for (int m = 0; m < L; ++m) dp[at + m * L] = p[at + m * L] * (dp[at + m * L] - s);
  }
  __syncthreads();
  // d_gin[q][h][i] = sum_n d_logit[q][h][n] W_g[i][n], laid back as d_comp[q][l][h*R + r]
  const float* wg = sm + g.wg;
  for (int o = threadIdx.x; o < nq * H * LR; o += kThreads) {
    const int i = o % LR, qh = o / LR, h = qh % H, q = qh / H;
    const float* d = dp + qh * LL;
    float acc = 0.f;
    for (int n = 0; n < LL; ++n) acc = fmaf(d[n], wg[i * LL + n], acc);
    const int at = (q * L + i / R) * HR + h * R + i % R;
    dcomp[at] = rd<kBF16>(acc);
    dcomp_out[(size_t)s0 * L * HR + at] = rd<kBF16>(acc);
  }
  __syncthreads();
  // dx[q][m][c] = sum_l P[q][h(c)][m][l] d_mixed[q][l][c] + sum_j d_comp[q][m][j] W_c[c][j]
  const float* wct = sm + g.wct;
  for (int o = threadIdx.x; o < nq * L * C; o += kThreads) {
    const int c = o % C, row = o / C, q = row / L;
    const float* pp = p + (q * H + c / Ch) * LL + (row % L) * L;
    const float* dq = dm + q * L * C + c;
    float acc = 0.f;
    for (int l = 0; l < L; ++l) acc = fmaf(pp[l], dq[l * C], acc);
    const float* dr = dcomp + row * HR;
    float acc2 = 0.f;
    for (int j = 0; j < HR; ++j) acc2 = fmaf(dr[j], wct[j * C + c], acc2);
    dx[off + o] = rd<kBF16>(acc) + rd<kBF16>(acc2);
  }
  // the CTA's partials: dW_g[n][i] = sum_q sum_h gin[q][h][i] d_logit[q][h][n], db_g[n]
  float* mine = part + (size_t)blockIdx.x * (LR * LL + LL);
  for (int o = threadIdx.x; o < LR * LL + LL; o += kThreads) {
    float acc = 0.f;
    if (o < LR * LL) {
      const int i = o % LR, n = o / LR;
      for (int q = 0; q < nq; ++q)
        for (int h = 0; h < H; ++h)
          acc = fmaf(comp[(q * L + i / R) * HR + h * R + i % R], dp[(q * H + h) * LL + n], acc);
    } else {
      for (int qh = 0; qh < nq * H; ++qh) acc += dp[qh * LL + o - LR * LL];
    }
    mine[o] = acc;
  }
}

struct Plan {
  int sms;  // the card's SMs (the tile rule of the output projection)
  Geo fwd, bwd;
  int ctas_fwd, ctas_bwd;
  int wsplit, wslice;  // the weight gradients: slices of the rows
  int csplit, cslice;  // the column sums (db_o, db_c): slices of the rows
  // workspace offsets (floats): wor, xr only in bf16 (W_o and x rounded)
  size_t mixed, wor, dm, dcomp, p_gen, p_wo, p_wc, p_col, xr;
  size_t fwd_floats, bwd_floats;
};

int check_args(int S, int L, int C, int H, int R) {
  if (S < 1 || L < 1 || L > kMaxL || C < 1 || C > kMaxC || H < 1 || R < 1 || C % H) return -1;
  if ((long long)S * L > 64LL * 65535) return -1;  // the row tiles of one grid column
  return 0;
}

// the largest count of sequences a CTA (<= want) whose layout fits `limit`
// bytes of shared memory; 0 if none
int fit_spc(int S, int L, int C, int H, int R, int want, bool bwd, int limit) {
  for (int spc = want; spc >= 1; --spc)
    if ((size_t)make_geo(S, L, C, H, R, spc, bwd).total * 4 <= (size_t)limit) return spc;
  return 0;
}

int make_plan(int S, int L, int C, int H, int R, int bf16, int device, Plan& pl) {
  DeviceInfo dev;
  const cudaError_t err = device_info(device, dev);
  if (err != cudaSuccess) return err;
  const int limit = dev.smem_optin, sms = dev.sms;
  pl.sms = sms;
  // enough sequence CTAs for two waves before a CTA takes more than one sequence
  int want = S / (2 * sms);
  want = want < 1 ? 1 : (want > kMaxSeqPerCta ? kMaxSeqPerCta : want);
  const int spc_f = fit_spc(S, L, C, H, R, want, false, limit);
  const int spc_b = fit_spc(S, L, C, H, R, want, true, limit);
  if (!spc_f || !spc_b) return -1;
  pl.fwd = make_geo(S, L, C, H, R, spc_f, false);
  pl.bwd = make_geo(S, L, C, H, R, spc_b, true);
  pl.ctas_fwd = ceil_div(S, spc_f);
  pl.ctas_bwd = ceil_div(S, spc_b);
  const long long rows = (long long)S * L;
  const int HR = H * R, LR = L * R, LL = L * L;
  // dW_o's few tiles x slices of the rows
  row_slices(rows, ceil_div(C, kTcBM) * ceil_div(C, kTcBN), sms, pl.wslice, pl.wsplit);
  // the column sums: a slice is one thread's serial sum, so take enough slices
  // for two waves of CTAs (C = 256 is a single CTA of columns a slice)
  int cs = ceil_div(sms, ceil_div(C > HR ? C : HR, kThreads));
  const int max_cs = ceil_div(rows, kTileK);  // at least 16 rows a slice
  cs = cs > kMaxColSplit ? kMaxColSplit : cs;
  cs = cs > max_cs ? max_cs : cs;
  pl.cslice = ceil_div(rows, cs);
  pl.csplit = ceil_div(rows, pl.cslice);
  size_t o = 0;
  pl.mixed = o, o += (size_t)rows * C;
  pl.wor = o, o += bf16 ? (size_t)C * C : 0;
  pl.fwd_floats = o;
  pl.dm = o, o += (size_t)rows * C;
  pl.dcomp = o, o += (size_t)rows * HR;
  pl.p_gen = o, o += (size_t)pl.ctas_bwd * (LR * LL + LL);
  pl.p_wo = o, o += (size_t)pl.wsplit * C * C;
  pl.p_wc = o, o += (size_t)pl.wsplit * C * HR;
  pl.p_col = o, o += (size_t)pl.csplit * (C + HR);
  pl.xr = o, o += bf16 ? (size_t)rows * C : 0;
  pl.bwd_floats = o;
  return 0;
}

Weights weights(const void* const* q) {
  auto f = [q](int i) { return static_cast<const float*>(q[i]); };
  return Weights{f(0), f(1), f(2), f(3), f(4), f(5)};
}

template <bool kBF16>
int dyna_fwd(const float* x, float* y, int S, int L, int C, int H, int R, int device,
             const void* const* ptrs, void* workspace, void* stream) {
  if (check_args(S, L, C, H, R)) return -1;
  M2M_TRY(cudaSetDevice(device));
  Plan pl;
  const int code = make_plan(S, L, C, H, R, kBF16, device, pl);
  if (code) return code;
  const size_t smem = (size_t)pl.fwd.total * 4;
  M2M_TRY(prepare(dyna_mix_kernel<kBF16>, smem, device));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Weights w = weights(ptrs);
  float* ws = static_cast<float*>(workspace);
  float* mixed = ws + pl.mixed;
  const float* wo = w.wo;
  if (kBF16) {
    M2M_TRY(round_copy(w.wo, ws + pl.wor, C * C, st));
    wo = ws + pl.wor;
  }
  dyna_mix_kernel<kBF16><<<pl.ctas_fwd, kThreads, smem, st>>>(x, w, pl.fwd, mixed);
  M2M_TRY(cudaGetLastError());
  // y = mixed W_o^T + b_o (dynamixer_kernel.py:58), W_o output-major
  constexpr int kBoth = kBF16 ? kExactA | kExactB : 0;
  return tc_gemm_auto<kBoth, true>(View{mixed, C, 1}, View{wo, 1, C}, y, S * L, C, C, pl.sms, st,
                                   EpiBias{w.bo});
}

template <bool kBF16>
int dyna_bwd(const float* x, const float* g, float* dx, int S, int L, int C, int H, int R,
             int device, const void* const* ptrs, void* const* grads, void* workspace,
             void* stream) {
  if (check_args(S, L, C, H, R)) return -1;
  M2M_TRY(cudaSetDevice(device));
  Plan pl;
  const int code = make_plan(S, L, C, H, R, kBF16, device, pl);
  if (code) return code;
  const size_t smem = (size_t)pl.bwd.total * 4;
  M2M_TRY(prepare(dyna_seq_bwd_kernel<kBF16>, smem, device));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Weights w = weights(ptrs);
  float* ws = static_cast<float*>(workspace);
  float* const* gq = reinterpret_cast<float* const*>(grads);
  const int rows = S * L, HR = H * R, LL = L * L, LR = L * R;
  // the operands that hold bf16 values, product by product (tc_gemm's kExact)
  constexpr int kA = kBF16 ? kExactA : 0, kB = kBF16 ? kExactB : 0;
  constexpr int kRnd = kBF16 ? kRnd0 : 0;
  const float* wo = w.wo;
  if (kBF16) {
    M2M_TRY(round_copy(w.wo, ws + pl.wor, C * C, st));
    wo = ws + pl.wor;
  }
  // 1. d_mixed = g W_o (dynamixer_kernel.py:58), rounded in bf16
  M2M_TRY(tc_gemm_wide<kB>(View{g, C, 1}, View{wo, C, 1}, ws + pl.dm,
                           rows, C, C, C, 1, st, EpiRound<kBF16>{}));
  // 2. the per-sequence backward (:44-57)
  dyna_seq_bwd_kernel<kBF16><<<pl.ctas_bwd, kThreads, smem, st>>>(
      x, ws + pl.dm, w, pl.bwd, ws + pl.mixed, ws + pl.dcomp, dx, ws + pl.p_gen, ws + pl.xr);
  M2M_TRY(cudaGetLastError());
  // 3. dW_o = g^T mixed (output-major), 4. dW_c = x^T d_comp (H*R wide: the
  // narrow tile; in bf16 x rounded; transposed to output-major as its partials
  // are reduced): slices of the rows
  M2M_TRY(tc_gemm_wide<kB>(View{g, 1, C}, View{ws + pl.mixed, C, 1}, ws + pl.p_wo, C, C, rows,
                           pl.wslice, pl.wsplit, st));
  M2M_TRY(tc_gemm_narrow<kA | kB>(View{kBF16 ? ws + pl.xr : x, 1, C}, View{ws + pl.dcomp, HR, 1},
                                  ws + pl.p_wc, C, HR, rows, pl.wslice, pl.wsplit, st));
  // 5. db_o, db_c: column sums over slices of the rows
  ColJobs<2> cj = {};
  cj.job[0] = ColJob{g, C, C, ws + pl.p_col};
  cj.job[1] = ColJob{ws + pl.dcomp, HR, HR, ws + pl.p_col + (size_t)pl.csplit * C};
  col_slices_kernel<2><<<dim3(ceil_div(C > HR ? C : HR, kThreads), pl.csplit, 2), kThreads, 0,
                         st>>>(cj, rows, pl.cslice);
  M2M_TRY(cudaGetLastError());
  // 6. every partial reduced in slice / CTA order (compensated); in bf16 the
  // weight gradients rounded, the bias gradients not
  RedJobs<kRedJobs> rj = {};
  rj.job[0] = RedJob{ws + pl.p_wo, pl.wsplit, C * C, gq[4], C * C, nullptr, kRnd};
  rj.job[1] = RedJob{ws + pl.p_wc, pl.wsplit, C * HR, gq[0], C * HR, nullptr, kRnd, C};
  rj.job[2] = RedJob{ws + pl.p_col, pl.csplit, C, gq[5], C, nullptr, 0};
  rj.job[3] = RedJob{ws + pl.p_col + (size_t)pl.csplit * C, pl.csplit, HR, gq[1], HR, nullptr, 0};
  rj.job[4] = RedJob{ws + pl.p_gen, pl.ctas_bwd, LR * LL + LL, gq[2], LR * LL, gq[3], kRnd};
  int longest = 0;
  for (const RedJob& j : rj.job) longest = j.P > longest ? j.P : longest;
  reduce_jobs_kernel<kRedJobs><<<dim3(ceil_div(longest, kThreads), kRedJobs), kThreads, 0, st>>>(
      rj);
  return (int)cudaGetLastError();
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
  return (backward ? pl.bwd_floats : pl.fwd_floats) * 4;
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
  return (bf16 ? dyna_fwd<true> : dyna_fwd<false>)(x, y, S, L, C, H, R, device, ptrs, workspace,
                                                    stream);
}

// K4b: dx and the 6 parameter gradients (float32, DynaMixerOpParams order) of
// one DynaMixerOp at input x for output gradient g (the weight gradients
// output-major, as the weights); bf16: bf16 compute (the gradients rounded
// where JAX's AD rounds them); workspace: m2m_dyna_workspace_bytes(..., 1, ...)
// bytes.
int m2m_dyna_bwd(const float* x, const float* g, float* dx, int S, int L, int C, int H, int R,
                 int bf16, int device, const void* const* ptrs, void* const* grads,
                 void* workspace, void* stream) {
  return (bf16 ? dyna_bwd<true> : dyna_bwd<false>)(x, g, dx, S, L, C, H, R, device, ptrs, grads,
                                                    workspace, stream);
}

}  // extern "C"
