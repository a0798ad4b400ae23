// K4: the Adasum pair combine, written by hand for Hopper (sm_90a), as two
// kernels over a table of items.
//
// Replaces horovod_tpu/ops/adasum.py::adasum_combine (:26-50), which XLA
// compiles inside adasum_tree_reduce (:107-120) and the hypercube of
// adasum_allreduce (:53-78); the JAX package has no Pallas source for it.
// An item is one pair of equal-length rows a and b (fp32, bf16 or fp16, one
// dtype a launch) and the row of its three sums. For every item of a table:
//
//   K4a, dot_norms:  sums[slot] = (a.b, |a|^2, |b|^2), three fp32 sums
//   K4b, scaled_add: acoef = |a|^2 > 0 ? 1 - a.b / (2 |a|^2) : 0
//                    bcoef = |b|^2 > 0 ? 1 - a.b / (2 |b|^2) : 0
//                    out = acoef * a + bcoef * b, in fp32, rounded once to
//                    the rows' dtype, the sums read from sums[slot]
//
// One launch of each covers a whole round of the Adasum tree over a packed
// chunk: every (pair of ranks, tensor) is an item, so each tensor keeps its
// own coefficients, as the reference's fused buffer does
// (adasum.h:101 DispatchComputeDotAndNormSqrds, :124 DispatchScaledAdd).
// K4b reads the sums from device memory, so the two-level path sums each
// rank's partial sums over its host's ranks (one allreduce of fp32[T, 3])
// between the two launches without a host read.
//
// The table rides by value in the parameter space (__grid_constant__):
// kMaxItems items take 16 KB (K4a) and 18 KB (K4b), under the 32,764 bytes
// a kernel's parameters may hold from CUDA 12.1 on, so a launch costs no
// host-to-device copy and a four-rank ResNet-50 round (2 x 161 items) is
// one launch. A table past kMaxItems is split into launches by the caller.
//
// Determinism. Every rank runs the same tree on the same gathered rows and
// must come out bitwise equal, step after step, so K4a takes no
// floating-point atomic. An item of n elements gets dot_blocks(n) blocks
// (a function of n alone); a block finds its item by a binary search over
// the prefix of the items' block counts; each thread sums a fixed set of
// the item's elements in a fixed order, each block reduces its threads in a
// fixed order into one partial (a, b, c) of a [blocks, 3] buffer, and the
// item's last block to finish (the item's own integer counter) reduces the
// item's partials in block order, then resets the counter to 0 for the next
// launch. So an item's sums are bitwise those of a table of that item alone.
// K4b rounds acoef * a and bcoef * b before their sum (no FMA contraction),
// so combine(a, b) and combine(b, a) are the same bits and a rank and its
// hypercube partner agree.
//
// What bounds it: bytes. K4a reads 2N elements, K4b reads 2N and writes N,
// with a few flops an element. K4a's loads are 16 bytes a thread where both
// rows of the item are 16-byte aligned (4 fp32 or 8 half-precision
// elements), element by element otherwise. K4b walks the table's elements
// in tiles that run across item boundaries (K1's walk, tensor_table.cuh),
// one block a tile, so one SM takes many small items; within an item a tile
// is a scalar head, 16-byte loads and stores where a, b and out line up,
// and a scalar tail. Accumulation is fp32 FMA, reduction a warp shuffle and
// one shared-memory step.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1024;  // K4a: blocks an item, at most
constexpr int kVecsPerThread = 4;  // 16-byte loads a thread, at least
constexpr int kMaxItems = 512;     // items a launch

struct DotTable {
  unsigned long long a[kMaxItems], b[kMaxItems];
  long long n[kMaxItems];
  int blk[kMaxItems + 1];  // the prefix of the items' block counts
  int slot[kMaxItems];     // each item's row of sums
  int count;
};

struct AddTable {
  unsigned long long a[kMaxItems], b[kMaxItems], o[kMaxItems];
  long long off[kMaxItems + 1];  // each item's first element in the walk
  int slot[kMaxItems];
  int count;
};

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

// The last entry of the non-decreasing p[0..count] that is <= e.
__device__ __forceinline__ int find_item(const int* p, int count, int e) {
  int lo = 0, hi = count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (p[mid] <= e) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ int find_item(const long long* p, int count,
                                         long long e) {
  int lo = 0, hi = count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (p[mid] <= e) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// K4a. partials: [gridDim.x, 3] fp32; counters: one unsigned an item, 0 at
// launch and left 0; sums: fp32[rows, 3].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    adasum_dot_norms(const __grid_constant__ DotTable t,
                     float* __restrict__ partials,
                     unsigned* __restrict__ counters,
                     float* __restrict__ sums) {
  __shared__ float red[3 * kWarps];
  __shared__ bool last;
  constexpr int V = 16 / sizeof(T);
  const int item = find_item(t.blk, t.count, (int)blockIdx.x);
  const int first = t.blk[item];
  const int nblk = t.blk[item + 1] - first;
  const T* a = reinterpret_cast<const T*>(t.a[item]);
  const T* b = reinterpret_cast<const T*>(t.b[item]);
  const long long n = t.n[item];
  float d = 0.f, na = 0.f, nb = 0.f;
  const long long tid = (long long)(blockIdx.x - first) * kThreads +
                        threadIdx.x;
  const long long stride = (long long)nblk * kThreads;
  long long done = 0;
  if (((t.a[item] | t.b[item]) & 15) == 0) {
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
    last = atomicAdd(counters + item, 1u) == (unsigned)(nblk - 1);
  }
  __syncthreads();
  if (!last) return;
  // the item's last block: its partials in block order, a fixed tree over
  // threads
  d = na = nb = 0.f;
  const float* ip = partials + 3 * (size_t)first;
  for (int j = threadIdx.x; j < nblk; j += kThreads) {
    d += __ldcg(ip + 3 * j);
    na += __ldcg(ip + 3 * j + 1);
    nb += __ldcg(ip + 3 * j + 2);
  }
  block_sum3(d, na, nb, red);
  if (threadIdx.x == 0) {
    float* o = sums + 3 * (size_t)t.slot[item];
    o[0] = d;
    o[1] = na;
    o[2] = nb;
    counters[item] = 0u;
  }
}

__device__ __forceinline__ float coefficient(float dot, float nsq) {
  return nsq > 0.f ? 1.f - __fdiv_rn(dot, 2.f * nsq) : 0.f;
}

template <typename T>
__device__ __forceinline__ T combine(float ac, float av, float bc, float bv) {
  return from_f<T>(__fadd_rn(__fmul_rn(ac, av), __fmul_rn(bc, bv)));
}

// n elements of out = ac * a + bc * b, by the whole block; out may be a or
// b (each element is read before it is written, by the same thread).
template <typename T>
__device__ __forceinline__ void combine_range(const T* a, const T* b, T* out,
                                              long long n, float ac,
                                              float bc) {
  constexpr int V = 16 / sizeof(T);
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a);
  long long head = n;  // scalar elements before the vector body
  if (((pa ^ reinterpret_cast<uintptr_t>(b)) & 15) == 0 &&
      ((pa ^ reinterpret_cast<uintptr_t>(out)) & 15) == 0 &&
      pa % sizeof(T) == 0) {
    const long long h = (long long)(((16 - (pa & 15)) & 15) / sizeof(T));
    head = h < n ? h : n;
  }
  for (long long i = threadIdx.x; i < head; i += kThreads)
    out[i] = combine<T>(ac, to_f(a[i]), bc, to_f(b[i]));
  if (head == n) return;
  const long long nvec = (n - head) / V;
  const uint4* a4 = reinterpret_cast<const uint4*>(a + head);
  const uint4* b4 = reinterpret_cast<const uint4*>(b + head);
  uint4* o4 = reinterpret_cast<uint4*>(out + head);
  long long v = threadIdx.x;
  for (; v + (kVecsPerThread - 1) * kThreads < nvec;
       v += kVecsPerThread * kThreads) {
    uint4 ua[kVecsPerThread], ub[kVecsPerThread];
#pragma unroll
    for (int k = 0; k < kVecsPerThread; ++k) {
      ua[k] = a4[v + k * kThreads];
      ub[k] = b4[v + k * kThreads];
    }
#pragma unroll
    for (int k = 0; k < kVecsPerThread; ++k) {
      uint4 uo;
      const T* va = reinterpret_cast<const T*>(&ua[k]);
      const T* vb = reinterpret_cast<const T*>(&ub[k]);
      T* vo = reinterpret_cast<T*>(&uo);
#pragma unroll
      for (int j = 0; j < V; ++j)
        vo[j] = combine<T>(ac, to_f(va[j]), bc, to_f(vb[j]));
      o4[v + k * kThreads] = uo;
    }
  }
  for (; v < nvec; v += kThreads) {
    const uint4 ua = a4[v], ub = b4[v];
    uint4 uo;
    const T* va = reinterpret_cast<const T*>(&ua);
    const T* vb = reinterpret_cast<const T*>(&ub);
    T* vo = reinterpret_cast<T*>(&uo);
#pragma unroll
    for (int j = 0; j < V; ++j)
      vo[j] = combine<T>(ac, to_f(va[j]), bc, to_f(vb[j]));
    o4[v] = uo;
  }
  for (long long i = head + nvec * V + threadIdx.x; i < n; i += kThreads)
    out[i] = combine<T>(ac, to_f(a[i]), bc, to_f(b[i]));
}

// K4b's tile: kVecsPerThread 16-byte vectors a thread.
template <typename T>
__host__ __device__ constexpr long long add_tile() {
  return (long long)kThreads * kVecsPerThread * (16 / sizeof(T));
}

// K4b. One block a tile of the table's walk [0, off[count]).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    adasum_scaled_add(const __grid_constant__ AddTable t,
                      const float* __restrict__ sums) {
  const long long e0 = (long long)blockIdx.x * add_tile<T>();
  const long long e1 = min(t.off[t.count], e0 + add_tile<T>());
  for (int i = find_item(t.off, t.count, e0); i < t.count && t.off[i] < e1;
       ++i) {
    const long long lo = max(e0, t.off[i]), hi = min(e1, t.off[i + 1]);
    if (lo >= hi) continue;
    const float* s = sums + 3 * (size_t)t.slot[i];
    const float dot = s[0];
    const float ac = coefficient(dot, s[1]);
    const float bc = coefficient(dot, s[2]);
    const long long k = lo - t.off[i];
    combine_range(reinterpret_cast<const T*>(t.a[i]) + k,
                  reinterpret_cast<const T*>(t.b[i]) + k,
                  reinterpret_cast<T*>(t.o[i]) + k, hi - lo, ac, bc);
  }
}

// K4a's blocks for an item of n elements: enough that each thread takes
// kVecsPerThread 16-byte loads, at most kMaxBlocks; a function of n alone.
int dot_blocks(long long n, int item) {
  const long long per_block = (long long)kThreads * kVecsPerThread * (16 / item);
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

int item_size(int dtype) { return dtype == 0 ? 4 : 2; }

int set_device(int device) {
  int cur = -1;
  int err = (int)cudaGetDevice(&cur);
  if (err != 0) return err;
  return cur == device ? 0 : (int)cudaSetDevice(device);
}

template <typename T>
int launch_dot(const DotTable& t, void* scratch, void* sums,
               cudaStream_t s) {
  float* partials = static_cast<float*>(scratch);
  unsigned* counters = reinterpret_cast<unsigned*>(
      partials + 3LL * kMaxItems * kMaxBlocks);
  adasum_dot_norms<T><<<t.blk[t.count], kThreads, 0, s>>>(
      t, partials, counters, static_cast<float*>(sums));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_add(const AddTable& t, const void* sums, cudaStream_t s) {
  const long long tiles = (t.off[t.count] + add_tile<T>() - 1) / add_tile<T>();
  if (tiles == 0) return 0;
  adasum_scaled_add<T><<<(unsigned)tiles, kThreads, 0, s>>>(
      t, static_cast<const float*>(sums));
  return (int)cudaGetLastError();
}

}  // namespace

// Items a launch, at most.
extern "C" int hvd_adasum_max_items() { return kMaxItems; }

// The scratch K4a needs, in bytes: the partials of every block a launch may
// have, then one counter an item. The caller zeroes it once, when it is
// made; every launch leaves the counters 0.
extern "C" long long hvd_adasum_scratch_bytes() {
  return 3LL * kMaxItems * kMaxBlocks * sizeof(float) +
         (long long)kMaxItems * sizeof(unsigned);
}

// K4a over count items (1..hvd_adasum_max_items()): a[i], b[i] the rows'
// pointers, n[i] their length, slot[i] the row of sums (fp32[rows, 3], on
// the device) the item's three sums go to. dtype: 0 fp32, 1 bf16, 2 fp16.
// scratch: device memory of hvd_adasum_scratch_bytes(), zeroed once. Returns
// the cudaError_t of the launch (0 on success), -1 for arguments the kernel
// refuses.
extern "C" int hvd_adasum_dot_norms(int dtype, int count,
                                    const unsigned long long* a,
                                    const unsigned long long* b,
                                    const long long* n, const int* slot,
                                    void* scratch, void* sums, int device,
                                    void* stream) {
  if (count < 1 || count > kMaxItems || dtype < 0 || dtype > 2) return -1;
  DotTable t;
  t.count = count;
  t.blk[0] = 0;
  for (int i = 0; i < count; ++i) {
    if (n[i] < 0 || slot[i] < 0) return -1;
    t.a[i] = a[i];
    t.b[i] = b[i];
    t.n[i] = n[i];
    t.slot[i] = slot[i];
    t.blk[i + 1] = t.blk[i] + dot_blocks(n[i], item_size(dtype));
  }
  int err = set_device(device);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_dot<float>(t, scratch, sums, s);
    case 1: return launch_dot<__nv_bfloat16>(t, scratch, sums, s);
    default: return launch_dot<__half>(t, scratch, sums, s);
  }
}

// K4b over count items: out[i] = acoef * a[i] + bcoef * b[i] over n[i]
// elements, the coefficients from sums[slot[i]] (K4a's, on the device);
// out[i] may be a[i] or b[i].
extern "C" int hvd_adasum_scaled_add(int dtype, int count,
                                     const unsigned long long* a,
                                     const unsigned long long* b,
                                     const unsigned long long* out,
                                     const long long* n, const int* slot,
                                     const void* sums, int device,
                                     void* stream) {
  if (count < 1 || count > kMaxItems || dtype < 0 || dtype > 2) return -1;
  AddTable t;
  t.count = count;
  t.off[0] = 0;
  for (int i = 0; i < count; ++i) {
    if (n[i] < 0 || slot[i] < 0) return -1;
    t.a[i] = a[i];
    t.b[i] = b[i];
    t.o[i] = out[i];
    t.slot[i] = slot[i];
    t.off[i + 1] = t.off[i] + n[i];
  }
  int err = set_device(device);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_add<float>(t, sums, s);
    case 1: return launch_add<__nv_bfloat16>(t, sums, s);
    default: return launch_add<__half>(t, sums, s);
  }
}
