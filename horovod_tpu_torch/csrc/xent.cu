// K5: the two passes of the chunked softmax cross-entropy over one fp32
// logits chunk, written by hand for Hopper (sm_90a).
//
// Replaces the elementwise and reduction work of the two lax.scan bodies of
// horovod_tpu/ops/xent.py (forward :65-78, backward :106-113), which XLA
// fuses around each chunk's product there. The products themselves
// (x @ w_c.T, dlogits @ w_c, dlogits.T @ x) stay torch.matmul in fp32 in
// ops/xent.py, as XLA computed them outside any Pallas kernel. Per chunk of
// C classes starting at class `base`, on logits [N, C] fp32 (row-major):
//
//   forward:  m' = max(m, max_c x[n, c])
//             l' = l * exp(m - m') + sum_c exp(x[n, c] - m')
//             tgt' = x[n, t_n - base] if base <= t_n < base + C, else tgt
//             (m, l, tgt updated in place: the online logsumexp)
//   backward: x[n, c] = (exp(x[n, c] - lse[n]) - [c == t_n - base]) * scale
//             (in place: the chunk becomes its dlogits)
//
// with scale = ct / N read from the device (no host sync for the loss's
// cotangent). The plain PyTorch version in ops/xent.py computes the same op
// for op; sums are taken in another order here (a block reduction), and
// expf is the accurate one (no fast math).
//
// What bounds it: bytes. Each logit is read once by the forward (the second
// pass over a row hits the cache) and read and written once by the backward,
// with one exp an element: at N = 8192 and C = 8192 a chunk is 256 MiB, so
// 0.080 ms forward and 0.160 ms backward at 3.35 TB/s. The design is the
// simple one: a block of 256 threads a row, 16-byte loads where the row
// allows them, warp shuffles and one shared-memory step for the block's max
// and sum. Fusing the product into the kernel (3xTF32 wgmma, keeping the
// logits out of device memory) is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's max (kMax) or sum of v, returned to every thread. `red` holds
// kWarps floats; the trailing barrier lets the caller reuse it.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  v = kMax ? warp_max(v) : warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

// One block a row: the chunk's max, then the sum of exp(x - m') over the
// row, then thread 0 updates the row's (m, l, tgt).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    xent_fwd_chunk(const float* __restrict__ logits,
                   const long long* __restrict__ targets, long long base,
                   int C, float* __restrict__ m, float* __restrict__ l,
                   float* __restrict__ tgt) {
  __shared__ float red[kWarps];
  const size_t row = blockIdx.x;
  const float* x = logits + row * (size_t)C;
  float mx = -INFINITY;
  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int i = threadIdx.x; i < C / 4; i += kThreads) {
      const float4 v = x4[i];
      mx = fmaxf(fmaxf(mx, v.x), fmaxf(v.y, fmaxf(v.z, v.w)));
    }
  } else {
    for (int i = threadIdx.x; i < C; i += kThreads) mx = fmaxf(mx, x[i]);
  }
  const float m_old = m[row];
  const float m_new = fmaxf(m_old, block_reduce<true>(mx, red));
  float s = 0.f;
  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int i = threadIdx.x; i < C / 4; i += kThreads) {
      const float4 v = x4[i];
      s += expf(v.x - m_new) + expf(v.y - m_new) + expf(v.z - m_new) +
           expf(v.w - m_new);
    }
  } else {
    for (int i = threadIdx.x; i < C; i += kThreads) s += expf(x[i] - m_new);
  }
  s = block_reduce<false>(s, red);
  if (threadIdx.x == 0) {
    l[row] = l[row] * expf(m_old - m_new) + s;
    m[row] = m_new;
    const long long local = targets[row] - base;
    if (local >= 0 && local < C) tgt[row] = x[local];
  }
}

// One block a row: the row of logits becomes its dlogits in place.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    xent_bwd_chunk(float* __restrict__ logits,
                   const long long* __restrict__ targets, long long base,
                   int C, const float* __restrict__ lse,
                   const float* __restrict__ scale) {
  const size_t row = blockIdx.x;
  float* x = logits + row * (size_t)C;
  const float ls = lse[row], sc = *scale;
  const long long local = targets[row] - base;  // outside [0, C): no onehot
  if (kVec) {
    float4* x4 = reinterpret_cast<float4*>(x);
    for (int i = threadIdx.x; i < C / 4; i += kThreads) {
      float4 v = x4[i];
      const long long c = 4ll * i;
      v.x = (expf(v.x - ls) - (c == local ? 1.f : 0.f)) * sc;
      v.y = (expf(v.y - ls) - (c + 1 == local ? 1.f : 0.f)) * sc;
      v.z = (expf(v.z - ls) - (c + 2 == local ? 1.f : 0.f)) * sc;
      v.w = (expf(v.w - ls) - (c + 3 == local ? 1.f : 0.f)) * sc;
      x4[i] = v;
    }
  } else {
    for (int i = threadIdx.x; i < C; i += kThreads)
      x[i] = (expf(x[i] - ls) - (i == local ? 1.f : 0.f)) * sc;
  }
}

bool vec_ok(const void* p, int C) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && C % 4 == 0;
}

}  // namespace

// logits [N, C] fp32 contiguous, targets [N] int64 (already clipped to the
// vocabulary), m, l, tgt [N] fp32 updated in place. Returns the cudaError_t
// of the launch (0 on success).
extern "C" int hvd_xent_fwd_chunk(const void* logits, const void* targets,
                                  long long base, int N, int C, void* m,
                                  void* l, void* tgt, int device,
                                  void* stream) {
  if (N < 0 || C < 1) return -1;
  int err = (int)cudaSetDevice(device);
  if (err != 0) return err;
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(logits);
  const long long* t = static_cast<const long long*>(targets);
  float *mm = static_cast<float*>(m), *ll = static_cast<float*>(l),
        *tt = static_cast<float*>(tgt);
  if (vec_ok(logits, C))
    xent_fwd_chunk<true><<<N, kThreads, 0, s>>>(x, t, base, C, mm, ll, tt);
  else
    xent_fwd_chunk<false><<<N, kThreads, 0, s>>>(x, t, base, C, mm, ll, tt);
  return (int)cudaGetLastError();
}

// logits [N, C] fp32 contiguous, overwritten with dlogits; lse [N] fp32;
// scale: one fp32 on the device (ct / N).
extern "C" int hvd_xent_bwd_chunk(void* logits, const void* targets,
                                  long long base, int N, int C,
                                  const void* lse, const void* scale,
                                  int device, void* stream) {
  if (N < 0 || C < 1) return -1;
  int err = (int)cudaSetDevice(device);
  if (err != 0) return err;
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* x = static_cast<float*>(logits);
  const long long* t = static_cast<const long long*>(targets);
  const float* ls = static_cast<const float*>(lse);
  const float* sc = static_cast<const float*>(scale);
  if (vec_ok(logits, C))
    xent_bwd_chunk<true><<<N, kThreads, 0, s>>>(x, t, base, C, ls, sc);
  else
    xent_bwd_chunk<false><<<N, kThreads, 0, s>>>(x, t, base, C, ls, sc);
  return (int)cudaGetLastError();
}
