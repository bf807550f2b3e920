// Device code shared by the fused-mixer forward (mixer_fwd.cu) and backward
// (mixer_bwd.cu) kernels: GELU and its derivative, LayerNorm rows, the token
// FF of one MixerBlock, and the counter-based dropout masks.
//
// Dropout. The TPU kernels draw their masks from the TPU's PRNG seeded by
// (seed + grid tile); neither those bits nor that tile plan exist here. The
// masks here are a hash of (stream key, global element index): the key is
// derived on the host from (seed, block index in the stack, mask id 0-3), the
// element index counts in the JAX layouts of the four masks:
//   mask 0 (B*D, T) after the token FF's GELU,   mask 1 (B*D, N) after its output,
//   mask 2 (B*N, C) after the channel FF's GELU, mask 3 (B*N, D) after its output.
// A mask therefore never depends on how the batch is tiled, so the forward,
// the backward and the plain PyTorch version (ops/mixer_kernel.py, the same
// hash in 64-bit integer arithmetic) agree element by element. JAX's rules
// are kept: keep an element iff bits >= uint32(rate * (2^32 - 1)), and scale
// the kept ones by 1 / (1 - rate).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>
#include <vector>

// Host-side launch tallies, read through m2m_launch_tally (mixer_fwd.cu): the
// wgmma engine's kernel, tc_gemm's and the token pipeline's first kernel,
// counted where they are enqueued, so that a check of the route a call took
// does not rest on a profiler trace, which may drop events.
enum M2mTally { kTallyWgGemm, kTallyTcGemm, kTallyTokIn, kTallies };
extern std::atomic<unsigned long long> m2m_tally[kTallies];
inline void m2m_count(M2mTally t) { m2m_tally[t].fetch_add(1, std::memory_order_relaxed); }

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTokens = 32;  // tokens the register token FF takes (token_ff.cuh above)
constexpr int kMaxBlocks = 32;
constexpr int kParamsPerBlock = 12;
constexpr int kMasks = 4;
constexpr uint32_t kGolden = 0x9E3779B1u;

// murmur3's 32-bit finalizer
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// The four masks of every block of a launch: key[k * 4 + m] for block k, mask m.
struct Dropout {
  int on;
  uint32_t thresh;  // keep iff bits >= thresh
  float scale;      // 1 / (1 - rate), as float32
  uint32_t key[kMaxBlocks * kMasks];
};

// mask value (scale or 0) of element e of mask `m` of block `k`; 1 when off
__device__ __forceinline__ float keep(const Dropout& dp, int k, int m, uint32_t e) {
  if (!dp.on) return 1.f;
  return fmix32(e * kGolden ^ dp.key[k * kMasks + m]) >= dp.thresh ? dp.scale : 0.f;
}

template <bool kBF16>
__device__ __forceinline__ float rd(float v) {
  if constexpr (kBF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

__device__ __forceinline__ float gelu(float v, int tanh_flavor) {
  if (tanh_flavor) return 0.5f * v * (1.0f + tanhf(kSqrt2OverPi * (v + 0.044715f * v * v * v)));
  return 0.5f * v * (1.0f + erff(v * kInvSqrt2));
}

// d gelu / dv: Phi(v) + v * phi(v) for erf; the tanh form's own derivative
__device__ __forceinline__ float gelu_grad(float v, int tanh_flavor) {
  if (tanh_flavor) {
    const float th = tanhf(kSqrt2OverPi * (v + 0.044715f * v * v * v));
    return 0.5f * (1.0f + th) +
           0.5f * v * (1.0f - th * th) * kSqrt2OverPi * (1.0f + 3.0f * 0.044715f * v * v);
  }
  return 0.5f * (1.0f + erff(v * kInvSqrt2)) + v * kInvSqrt2Pi * expf(-0.5f * v * v);
}

// gelu(v) and gelu_grad(v) at once, their one erf (tanh) taken once: the
// same values as the two calls
__device__ __forceinline__ void gelu_both(float v, int tanh_flavor, float& y, float& dy) {
  if (tanh_flavor) {
    const float th = tanhf(kSqrt2OverPi * (v + 0.044715f * v * v * v));
    y = 0.5f * v * (1.0f + th);
    dy = 0.5f * (1.0f + th) +
         0.5f * v * (1.0f - th * th) * kSqrt2OverPi * (1.0f + 3.0f * 0.044715f * v * v);
    return;
  }
  const float e = erff(v * kInvSqrt2);
  y = 0.5f * v * (1.0f + e);
  dy = 0.5f * (1.0f + e) + v * kInvSqrt2Pi * expf(-0.5f * v * v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// mean and 1/sqrt(var + eps) of one row, by one warp (float32 statistics;
// kBF16: of the row's values rounded to bf16)
template <bool kBF16 = false>
__device__ __forceinline__ void row_stats(const float* xr, int D, float& mean, float& inv) {
  const int lane = threadIdx.x & 31;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32) sum += rd<kBF16>(xr[d]);
  mean = warp_sum(sum) / D;
  float sq = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float t = rd<kBF16>(xr[d]) - mean;
    sq += t * t;
  }
  inv = rsqrtf(warp_sum(sq) / D + 1e-5f);
}

// dst[r, :] = rd(LN(src[r, :]) * rd(s) + rd(b)), one warp per row, float32 statistics
template <bool kBF16>
__device__ void layer_norm_rows(const float* src, float* dst, int rows, int D,
                                const float* __restrict__ s, const float* __restrict__ b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kThreads / 32) {
    const float* xr = src + r * D;
    float mean, inv;
    row_stats(xr, D, mean, inv);
    for (int d = lane; d < D; d += 32)
      dst[r * D + d] = rd<kBF16>((xr[d] - mean) * inv * rd<kBF16>(s[d]) + rd<kBF16>(b[d]));
  }
}

struct TokenPtrs {
  const float* w1;  // (N, T)
  const float* b1;  // (T,)
  const float* w2;  // (T, N)
  const float* b2;  // (N,)
};

// the token FF's weights into shared memory (w1 and w2 rounded to the compute
// dtype): read from there, they stay out of the L2 traffic of the weight stream
template <bool kBF16>
__device__ void load_token_weights(float* tw, const TokenPtrs& p, int N, int T) {
  float* w1 = tw;
  float* b1 = w1 + N * T;
  float* w2 = b1 + T;
  float* b2 = w2 + T * N;
  for (int i = threadIdx.x; i < N * T; i += kThreads) {
    w1[i] = rd<kBF16>(__ldg(p.w1 + i));
    w2[i] = rd<kBF16>(__ldg(p.w2 + i));
  }
  for (int i = threadIdx.x; i < T; i += kThreads) b1[i] = __ldg(p.b1 + i);
  for (int i = threadIdx.x; i < N; i += kThreads) b2[i] = __ldg(p.b2 + i);
}

// token FF per (sample, d) column: xs += rd(gelu(y w1 + b1) * m0 w2 + b2) * m1, all
// of a sample's N tokens in registers, weights in shared memory
// (load_token_weights). Sample s of the tile is sample s0 + s of the batch, and
// `blk` the block's index in the launch (both key the dropout masks). kMaxN >= N
// sizes the per-thread token arrays (a smaller bound costs fewer registers).
template <bool kBF16, int kMaxN = kMaxTokens>
__device__ void token_mix(const float* ys, float* xs, int nb, int N, int T, int D,
                          const float* tw, int tanh_flavor, const Dropout& dp, int blk, int s0) {
  const float* w1 = tw;
  const float* b1 = w1 + N * T;
  const float* w2 = b1 + T;
  const float* b2 = w2 + T * N;
  for (int item = threadIdx.x; item < nb * D; item += kThreads) {
    const int s = item / D, d = item - s * D;
    const int base = s * N * D + d;
    const uint32_t col = (uint32_t)(s0 + s) * D + d;  // row of masks 0 and 1
    float in[kMaxN], acc[kMaxN];
#pragma unroll
    for (int n = 0; n < kMaxN; ++n) {
      in[n] = n < N ? ys[base + n * D] : 0.f;
      acc[n] = 0.f;
    }
    for (int j = 0; j < T; ++j) {
      float h = 0.f;
#pragma unroll
      for (int n = 0; n < kMaxN; ++n)
        if (n < N) h += in[n] * w1[n * T + j];
      h = rd<kBF16>(gelu(h + b1[j], tanh_flavor) * keep(dp, blk, 0, col * T + j));
#pragma unroll
      for (int n = 0; n < kMaxN; ++n)
        if (n < N) acc[n] += h * w2[j * N + n];
    }
#pragma unroll
    for (int n = 0; n < kMaxN; ++n) {
      if (n < N) {
        float* xp = xs + base + n * D;
        const float m1 = keep(dp, blk, 1, col * N + n);
        *xp = rd<kBF16>(*xp + rd<kBF16>((acc[n] + b2[n]) * m1));
      }
    }
  }
}

// The device attributes the launch plans read, queried once per device: each
// query is a driver call, and at batch 32 the host's time is the step's.
struct DeviceInfo {
  int smem_optin = 0;  // dynamic shared memory a block may opt into (bytes)
  int sms = 0;         // streaming multiprocessors
};
constexpr int kMaxDevices = 64;

inline cudaError_t device_info(int device, DeviceInfo& out) {
  static std::mutex mu;  // the wrappers' ctypes calls release the GIL
  static DeviceInfo cache[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  DeviceInfo& d = cache[device];
  if (!d.sms) {
    DeviceInfo q;
    cudaError_t err =
        cudaDeviceGetAttribute(&q.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&q.sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    d = q;
  }
  out = d;
  return cudaSuccess;
}

// Lets `kernel` take `smem` bytes of dynamic shared memory on `device`. The
// attribute is set once per (kernel, device) and again only for a larger size
// (a larger maximum serves every smaller launch), so a launch pays a table
// lookup and not three driver calls.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem, int device) {
  struct Prepared {
    const void* fn;
    int device;
    size_t smem;
  };
  static std::mutex mu;
  static std::vector<Prepared> done;
  const void* fn = (const void*)kernel;
  std::lock_guard<std::mutex> lock(mu);
  Prepared* hit = nullptr;
  for (Prepared& p : done)
    if (p.fn == fn && p.device == device) hit = &p;
  if (hit && hit->smem >= smem) return cudaSuccess;
  DeviceInfo info;
  cudaError_t err = device_info(device, info);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)info.smem_optin) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (hit)
    hit->smem = smem;
  else
    done.push_back(Prepared{fn, device, smem});
  return cudaSuccess;
}

// the same on the current device
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return prepare(kernel, smem, dev);
}

// the dropout arguments of a launch: keys[k * 4 + m] per block and mask (host
// array), or keys == nullptr for no dropout
inline Dropout make_dropout(const unsigned* keys, int n_blocks, unsigned thresh, float scale) {
  Dropout dp = {};
  dp.on = keys != nullptr;
  dp.thresh = thresh;
  dp.scale = scale;
  if (keys)
    for (int i = 0; i < n_blocks * kMasks; ++i) dp.key[i] = keys[i];
  return dp;
}

}  // namespace
