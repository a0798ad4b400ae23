// The multi-tensor table that K1 (fused_pack.cu) and K2/K3 (quant_wire.cu)
// share, with the element types and the tile walk built on it.
//
// A chunk is a list of tensors that a kernel treats as one flat range of
// elements. The table holds each tensor's own pointer and its first element
// in the chunk; it rides by value in the kernel's parameter space
// (__grid_constant__), so a launch costs no host-to-device copy, and a chunk
// with more tensors than HVD_TABLE_MAX_SEGS takes several launches (the
// Python wrappers split it).
//
// table_copy_kernel is K1's design, used by K1's pack and unpack and by K2's
// cast pack: the range is cut into kTileBytes tiles of source bytes that run
// across tensor boundaries, one block a tile, so the block scheduler hands
// each SM a new tile as soon as one of its blocks is done and a launch's last
// round is short; a block finds the tensor where its tile starts by one
// binary search and walks on tensor by tensor. Within a tensor each thread
// issues kUnroll independent 16-byte loads (read-only path,
// restrict-qualified pointers) before it stores any of them, where source
// and destination line up (a scalar head and tail around them), scalar
// accesses otherwise. An element op maps each source element (Op::S) to a
// destination element (Op::D); a 16-byte load of sources becomes one store
// of 16 * sizeof(D) / sizeof(S) bytes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define HVD_TABLE_MAX_SEGS 128
#define HVD_TABLE_THREADS 256
constexpr int kUnroll = 4;               // 16-byte loads in flight per thread
constexpr long long kTileBytes = 16384;  // one block's share of the source

struct TensorTable {
  unsigned long long ptr[HVD_TABLE_MAX_SEGS];  // each tensor's own pointer
  long long off[HVD_TABLE_MAX_SEGS + 1];       // its first element in the
                                               // chunk; [count] = its end
  int count;
};

// One more pointer per tensor of a table (K3's residuals), 0 for none.
struct PtrList {
  unsigned long long p[HVD_TABLE_MAX_SEGS];
};

// The table from the host's arrays: ptrs[count], offs[count + 1]. Returns
// -1 for a count out of range or offsets that decrease.
static inline int make_table(TensorTable& t, const unsigned long long* ptrs,
                             const long long* offs, int count) {
  if (count < 1 || count > HVD_TABLE_MAX_SEGS) return -1;
  t.count = count;
  for (int i = 0; i < count; ++i) {
    if (offs[i + 1] < offs[i]) return -1;
    t.ptr[i] = ptrs[i];
    t.off[i] = offs[i];
  }
  t.off[count] = offs[count];
  return 0;
}

// The last tensor that starts at or before e (an empty tensor starts where
// the next one does, and the walks pass over it).
__device__ __forceinline__ int find_seg(const TensorTable& t, long long e) {
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.off[mid] <= e) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Element types: load() widens to fp32, store() rounds from fp32 (RNE).
struct F32 {
  typedef float S;
  static __device__ float load(S x) { return x; }
  static __device__ S store(float x) { return x; }
};
struct BF16 {
  typedef uint16_t S;
  static __device__ float load(S x) {
    return __uint_as_float(((unsigned)x) << 16);
  }
  static __device__ S store(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};
struct F16 {
  typedef uint16_t S;
  static __device__ float load(S x) {
    return __half2float(__ushort_as_half(x));
  }
  static __device__ S store(float x) {
    return __half_as_ushort(__float2half_rn(x));
  }
};
struct F64 {
  typedef double S;
  static __device__ float load(S x) { return __double2float_rn(x); }
  static __device__ S store(float x) { return (double)x; }
};

// A register type of B bytes, for the vector store.
template <int B> struct VecOf;
template <> struct VecOf<16> { typedef uint4 T; };
template <> struct VecOf<8> { typedef uint2 T; };
template <> struct VecOf<4> { typedef unsigned T; };
template <> struct VecOf<2> { typedef unsigned short T; };

template <class Op>
struct OpVec {
  static const int V = 16 / sizeof(typename Op::S);  // elements a load
  typedef typename VecOf<V * sizeof(typename Op::D)>::T T;
};

// The op on the V source elements of one 16-byte load.
template <class Op>
__device__ __forceinline__ typename OpVec<Op>::T apply_vec(const uint4& u,
                                                           const Op& op) {
  typedef typename OpVec<Op>::T DV;
  if (Op::kIdentity) return *reinterpret_cast<const DV*>(&u);
  const int V = OpVec<Op>::V;
  union {
    uint4 v;
    typename Op::S e[V];
  } in;
  union {
    DV v;
    typename Op::D e[V];
  } out;
  in.v = u;
#pragma unroll
  for (int j = 0; j < V; ++j) out.e[j] = op(in.e[j]);
  return out.v;
}

// n elements from src to dst, by the whole block.
template <class Op>
__device__ __forceinline__ void copy_range(
    const typename Op::S* __restrict__ src, typename Op::D* __restrict__ dst,
    long long n, const Op& op) {
  typedef typename Op::S S;
  typedef typename Op::D D;
  typedef typename OpVec<Op>::T DV;
  const int V = OpVec<Op>::V;
  const int T = HVD_TABLE_THREADS;
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  long long head = n;  // scalar elements before the vector body
  if (s % sizeof(S) == 0) {
    const long long h = (long long)(((16 - (s & 15)) & 15) / sizeof(S));
    if ((d + h * sizeof(D)) % sizeof(DV) == 0) head = h < n ? h : n;
  }
  for (long long i = threadIdx.x; i < head; i += T) dst[i] = op(src[i]);
  if (head == n) return;
  const long long nvec = (n - head) / V;
  const uint4* __restrict__ sv = reinterpret_cast<const uint4*>(src + head);
  DV* __restrict__ dv = reinterpret_cast<DV*>(dst + head);
  long long v = threadIdx.x;
  for (; v + (kUnroll - 1) * T < nvec; v += kUnroll * T) {
    uint4 u[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) u[k] = __ldg(sv + v + k * T);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) dv[v + k * T] = apply_vec(u[k], op);
  }
  for (; v < nvec; v += T) dv[v] = apply_vec(__ldg(sv + v), op);
  for (long long i = head + nvec * V + threadIdx.x; i < n; i += T)
    dst[i] = op(src[i]);
}

// One block a kTileBytes tile of the table's range [off[0], off[count]).
// kPack: the tensors (Op::S) into flat (Op::D) at their offsets; else flat
// (Op::S) into the tensors (Op::D).
template <class Op, bool kPack>
__global__ void __launch_bounds__(HVD_TABLE_THREADS)
    table_copy_kernel(const __grid_constant__ TensorTable t, void* flat,
                      const Op op) {
  typedef typename Op::S S;
  typedef typename Op::D D;
  const long long tile = kTileBytes / (long long)sizeof(S);
  const long long e0 = t.off[0] + (long long)blockIdx.x * tile;
  const long long e1 = min(t.off[t.count], e0 + tile);
  for (int i = find_seg(t, e0); i < t.count && t.off[i] < e1; ++i) {
    const long long a = max(e0, t.off[i]), b = min(e1, t.off[i + 1]);
    if (a >= b) continue;
    if (kPack)
      copy_range(reinterpret_cast<const S*>(t.ptr[i]) + (a - t.off[i]),
                 static_cast<D*>(flat) + a, b - a, op);
    else
      copy_range(static_cast<const S*>(flat) + a,
                 reinterpret_cast<D*>(t.ptr[i]) + (a - t.off[i]), b - a, op);
  }
}

template <class Op>
static int launch_table_copy(int pack, const TensorTable& t, void* flat,
                             const Op& op, cudaStream_t stream) {
  const long long bytes =
      (t.off[t.count] - t.off[0]) * (long long)sizeof(typename Op::S);
  if (bytes == 0) return 0;
  const unsigned grid = (unsigned)((bytes + kTileBytes - 1) / kTileBytes);
  if (pack)
    table_copy_kernel<Op, true><<<grid, HVD_TABLE_THREADS, 0, stream>>>(
        t, flat, op);
  else
    table_copy_kernel<Op, false><<<grid, HVD_TABLE_THREADS, 0, stream>>>(
        t, flat, op);
  return (int)cudaGetLastError();
}
