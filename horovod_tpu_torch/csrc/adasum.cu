// K4: the Adasum pair combine, written by hand for Hopper (sm_90a), as two
// kernels.
//
// Replaces horovod_tpu/ops/adasum.py::adasum_combine (:26-50), which XLA
// compiles inside adasum_tree_reduce (:107-120) and the hypercube of
// adasum_allreduce (:53-78); the JAX package has no Pallas source for it.
// For two same-shaped rows a and b (fp32, bf16 or fp16):
//
//   K4a, dot_norms:  sums = (a.b, |a|^2, |b|^2), three fp32 sums
//   K4b, scaled_add: acoef = |a|^2 > 0 ? 1 - a.b / (2 |a|^2) : 0
//                    bcoef = |b|^2 > 0 ? 1 - a.b / (2 |b|^2) : 0
//                    out = acoef * a + bcoef * b, in fp32, rounded once to
//                    the rows' dtype
//
// K4b reads the three sums from device memory, so the two-level path can
// sum each rank's partial sums over its host's ranks (one allreduce of the
// fp32[3]) between the two launches without a host read.
//
// Determinism. Every rank runs the same tree on the same gathered rows and
// must come out bitwise equal, step after step, so K4a takes no
// floating-point atomic: each thread sums a fixed set of elements in a fixed
// order, each block reduces its threads in a fixed order into one partial
// (a, b, c) of a [blocks, 3] buffer, and the last block to finish (an
// integer counter) reduces the partials in block order. The grid is a
// function of the length alone. K4b rounds acoef * a and bcoef * b before
// their sum (no FMA contraction), so combine(a, b) and combine(b, a) are the
// same bits and a rank and its hypercube partner agree.
//
// What bounds it: bytes. K4a reads 2N elements, K4b reads 2N and writes N,
// with a few flops an element. Loads and stores are 16 bytes a thread where
// both rows are 16-byte aligned (4 fp32 or 8 half-precision elements), with
// the tail element by element; accumulation is fp32 FMA, reduction a warp
// shuffle and one shared-memory step.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1024;  // the partials buffer's rows
constexpr int kVecsPerThread = 4;  // K4a: 16-byte loads a thread, at least

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's sums of (x, y, z) to thread 0, in a fixed order. `red` holds
// 3 * kWarps floats.
__device__ __forceinline__ void block_sum3(float& x, float& y, float& z,
                                           float* red) {
  x = warp_sum(x);
  y = warp_sum(y);
  z = warp_sum(z);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[warp] = x;
    red[kWarps + warp] = y;
    red[2 * kWarps + warp] = z;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    x = red[0];
    y = red[kWarps];
    z = red[2 * kWarps];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      x += red[w];
      y += red[kWarps + w];
      z += red[2 * kWarps + w];
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void accumulate(float av, float bv, float& d,
                                           float& na, float& nb) {
  d = fmaf(av, bv, d);
  na = fmaf(av, av, na);
  nb = fmaf(bv, bv, nb);
}

// K4a. partials: [gridDim.x, 3] fp32; counter: one unsigned, 0 at launch;
// out: fp32[3].
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    adasum_dot_norms(const T* __restrict__ a, const T* __restrict__ b,
                     long long n, float* __restrict__ partials,
                     unsigned* __restrict__ counter, float* __restrict__ out) {
  __shared__ float red[3 * kWarps];
  __shared__ bool last;
  constexpr int V = 16 / sizeof(T);
  float d = 0.f, na = 0.f, nb = 0.f;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  long long done = 0;
  if (kVec) {
    const long long nvec = n / V;
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
    for (long long i = tid; i < nvec; i += stride) {
      const uint4 ua = a4[i], ub = b4[i];
      const T* va = reinterpret_cast<const T*>(&ua);
      const T* vb = reinterpret_cast<const T*>(&ub);
#pragma unroll
      for (int j = 0; j < V; ++j)
        accumulate(to_f(va[j]), to_f(vb[j]), d, na, nb);
    }
    done = nvec * V;
  }
  for (long long i = done + tid; i < n; i += stride)
    accumulate(to_f(a[i]), to_f(b[i]), d, na, nb);
  block_sum3(d, na, nb, red);
  if (threadIdx.x == 0) {
    float* p = partials + 3 * (size_t)blockIdx.x;
    p[0] = d;
    p[1] = na;
    p[2] = nb;
    __threadfence();  // the partial is visible before the count says so
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: the partials in block order, a fixed tree over threads
  d = na = nb = 0.f;
  for (int blk = threadIdx.x; blk < (int)gridDim.x; blk += kThreads) {
    d += __ldcg(partials + 3 * blk);
    na += __ldcg(partials + 3 * blk + 1);
    nb += __ldcg(partials + 3 * blk + 2);
  }
  block_sum3(d, na, nb, red);
  if (threadIdx.x == 0) {
    out[0] = d;
    out[1] = na;
    out[2] = nb;
    *counter = 0u;
  }
}

__device__ __forceinline__ float coefficient(float dot, float nsq) {
  return nsq > 0.f ? 1.f - __fdiv_rn(dot, 2.f * nsq) : 0.f;
}

template <typename T>
__device__ __forceinline__ T combine(float ac, float av, float bc, float bv) {
  return from_f<T>(__fadd_rn(__fmul_rn(ac, av), __fmul_rn(bc, bv)));
}

// K4b. out may be a or b (each element is read before it is written).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    adasum_scaled_add(const T* a, const T* b, const float* __restrict__ sums,
                      T* out, long long n) {
  constexpr int V = 16 / sizeof(T);
  const float dot = sums[0];
  const float ac = coefficient(dot, sums[1]);
  const float bc = coefficient(dot, sums[2]);
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  long long done = 0;
  if (kVec) {
    const long long nvec = n / V;
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    for (long long i = tid; i < nvec; i += stride) {
      const uint4 ua = a4[i], ub = b4[i];
      const T* va = reinterpret_cast<const T*>(&ua);
      const T* vb = reinterpret_cast<const T*>(&ub);
      uint4 uo;
      T* vo = reinterpret_cast<T*>(&uo);
#pragma unroll
      for (int j = 0; j < V; ++j)
        vo[j] = combine<T>(ac, to_f(va[j]), bc, to_f(vb[j]));
      o4[i] = uo;
    }
    done = nvec * V;
  }
  for (long long i = done + tid; i < n; i += stride)
    out[i] = combine<T>(ac, to_f(a[i]), bc, to_f(b[i]));
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// K4a's grid: enough blocks that each thread takes kVecsPerThread 16-byte
// loads, at most kMaxBlocks; a function of n alone.
int dot_blocks(long long n, int item) {
  const long long per_block = (long long)kThreads * kVecsPerThread * (16 / item);
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

int add_blocks(long long n, int item) {
  const long long per_block = (long long)kThreads * (16 / item);
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  const long long cap = 132 * 16;  // grid-stride beyond 16 blocks an SM
  return (int)(blocks < cap ? blocks : cap);
}

template <typename T>
int launch_dot(const void* a, const void* b, long long n, void* scratch,
               void* out, cudaStream_t s) {
  const int blocks = dot_blocks(n, sizeof(T));
  float* partials = static_cast<float*>(scratch);
  unsigned* counter = reinterpret_cast<unsigned*>(partials + 3 * kMaxBlocks);
  int err = (int)cudaMemsetAsync(counter, 0, sizeof(unsigned), s);
  if (err != 0) return err;
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  float* o = static_cast<float*>(out);
  if (aligned16(a) && aligned16(b))
    adasum_dot_norms<T, true><<<blocks, kThreads, 0, s>>>(ta, tb, n, partials,
                                                          counter, o);
  else
    adasum_dot_norms<T, false><<<blocks, kThreads, 0, s>>>(ta, tb, n,
                                                           partials, counter,
                                                           o);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_add(const void* a, const void* b, const void* sums, void* out,
               long long n, cudaStream_t s) {
  const int blocks = add_blocks(n, sizeof(T));
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  const float* su = static_cast<const float*>(sums);
  T* o = static_cast<T*>(out);
  if (aligned16(a) && aligned16(b) && aligned16(out))
    adasum_scaled_add<T, true><<<blocks, kThreads, 0, s>>>(ta, tb, su, o, n);
  else
    adasum_scaled_add<T, false><<<blocks, kThreads, 0, s>>>(ta, tb, su, o, n);
  return (int)cudaGetLastError();
}

}  // namespace

// The scratch K4a needs, in bytes: the partials of kMaxBlocks blocks and the
// counter.
extern "C" long long hvd_adasum_scratch_bytes() {
  return 3LL * kMaxBlocks * sizeof(float) + sizeof(unsigned);
}

// dtype: 0 fp32, 1 bf16, 2 fp16. a, b: n elements each; scratch: device
// memory of hvd_adasum_scratch_bytes(), 4-byte aligned; out: fp32[3].
// Returns the cudaError_t of the launch (0 on success), -1 for arguments the
// kernel refuses.
extern "C" int hvd_adasum_dot_norms(int dtype, const void* a, const void* b,
                                    long long n, void* scratch, void* out,
                                    int device, void* stream) {
  if (n < 0) return -1;
  int err = (int)cudaSetDevice(device);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_dot<float>(a, b, n, scratch, out, s);
    case 1: return launch_dot<__nv_bfloat16>(a, b, n, scratch, out, s);
    case 2: return launch_dot<__half>(a, b, n, scratch, out, s);
    default: return -1;
  }
}

// out = acoef * a + bcoef * b from sums (fp32[3] on the device, K4a's);
// out may be a or b.
extern "C" int hvd_adasum_scaled_add(int dtype, const void* a, const void* b,
                                     const void* sums, void* out, long long n,
                                     int device, void* stream) {
  if (n < 0) return -1;
  int err = (int)cudaSetDevice(device);
  if (err != 0) return err;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_add<float>(a, b, sums, out, n, s);
    case 1: return launch_add<__nv_bfloat16>(a, b, sums, out, n, s);
    case 2: return launch_add<__half>(a, b, sums, out, n, s);
    default: return -1;
  }
}
