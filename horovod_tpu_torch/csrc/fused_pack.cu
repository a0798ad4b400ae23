// K1: the fused-chunk pack and unpack of the background runtime's
// allreduce, written by hand for Hopper (sm_90a).
//
// Replaces the device work of horovod_tpu/ops/collectives.py
// _build_fused_plan (:738-783): there XLA fuses ravel + concat (+ the
// prescale of _allreduce_body, :576-577) into the program that feeds the
// reduction, and the postscale (:597) + static-slice unpack into the one
// that follows it; the host path packs in _native/core.cc (:46-96). Eager
// PyTorch has no such fuser, so the runtime calls this kernel on its comm
// stream, one launch per direction and chunk:
//
//   pack:   flat[off_i + j] = scale(src_i[j], factor)   for every tensor i
//   unpack: dst_i[j]        = scale(flat[off_i + j], factor)
//
// scale() is the JAX package's multi-rank rule (_allreduce_body, :576-597,
// a product with a weakly typed Python float): for bf16 and fp16 the factor
// is first rounded to the dtype (round to nearest even, in the functor's
// constructor), then the element is multiplied by it in fp32 and the
// product rounded once; fp32 elements take the factor in fp32, fp64
// elements in fp64. The plain PyTorch version in ops/fused_pack.py computes
// the same. With a factor of 1 the wrapper passes dtype 0: a byte copy,
// valid for any dtype.
//
// What bounds it: bytes. Each element is read once and written once, with
// no arithmetic to speak of, so the floor is (bytes read + bytes written)
// over device-memory bandwidth, and what reaches it is bytes in flight:
// - the table of (pointer, offset) per tensor rides by value in the
//   kernel's parameter space (__grid_constant__), so a chunk costs no
//   host-to-device copy; a chunk with more tensors than HVD_PACK_MAX_SEGS
//   takes several launches (the wrapper splits it);
// - the chunk is cut into 16 KB tiles that run across tensor boundaries,
//   one block a tile, so the hardware's block scheduler hands each SM a
//   new tile as soon as one of its blocks is done and the launch's last
//   round is short; a block finds the tensor where its tile starts by one
//   binary search and walks on tensor by tensor;
// - within a tensor, each thread issues kUnroll independent 16-byte loads
//   (read-only path, restrict-qualified pointers) before it stores any of
//   them, where source and destination share their alignment (a scalar
//   head and tail around them), scalar accesses otherwise.
// The tile size and the unroll were chosen by a sweep on the card against
// torch.cat and split + copy_ (PERF.md, K1).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define HVD_PACK_MAX_SEGS 128
#define HVD_PACK_THREADS 256
constexpr int kUnroll = 4;               // 16-byte loads in flight per thread
constexpr long long kTileBytes = 16384;  // one block's share of the chunk

struct PackTable {
  unsigned long long ptr[HVD_PACK_MAX_SEGS];  // each tensor's own pointer
  long long off[HVD_PACK_MAX_SEGS + 1];       // elements before it in flat;
                                              // [count] = the chunk's length
  int count;
};

// Scale functors on the storage type S (bf16 and fp16 as raw 16 bits).
struct CopyOp {
  typedef uint8_t S;
  static const bool kIdentity = true;
  __device__ S operator()(S x) const { return x; }
};
struct F32Op {
  typedef float S;
  static const bool kIdentity = false;
  float f;
  __device__ S operator()(S x) const { return x * f; }
};
struct F64Op {
  typedef double S;
  static const bool kIdentity = false;
  double f;
  __device__ S operator()(S x) const { return x * f; }
};
struct BF16Op {
  typedef uint16_t S;
  static const bool kIdentity = false;
  float f;  // the factor in bf16
  explicit BF16Op(float factor)
      : f(__bfloat162float(__float2bfloat16_rn(factor))) {}
  __device__ S operator()(S x) const {
    float v = __uint_as_float(((unsigned)x) << 16) * f;
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
struct F16Op {
  typedef uint16_t S;
  static const bool kIdentity = false;
  float f;  // the factor in fp16
  explicit F16Op(float factor) : f(__half2float(__float2half_rn(factor))) {}
  __device__ S operator()(S x) const {
    float v = __half2float(__ushort_as_half(x)) * f;
    return __half_as_ushort(__float2half_rn(v));
  }
};

template <class Op>
__device__ __forceinline__ void scale_vec(uint4& u, const Op& op) {
  if (Op::kIdentity) return;
  typedef typename Op::S S;
  S* e = reinterpret_cast<S*>(&u);
#pragma unroll
  for (int j = 0; j < (int)(16 / sizeof(S)); ++j) e[j] = op(e[j]);
}

// n elements from src to dst, by the whole block.
template <class Op>
__device__ __forceinline__ void copy_range(
    const typename Op::S* __restrict__ src, typename Op::S* __restrict__ dst,
    long long n, const Op& op) {
  typedef typename Op::S S;
  const int V = 16 / sizeof(S);
  const int T = HVD_PACK_THREADS;
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  long long head = n;  // scalar elements before the vector body
  if (((s ^ d) & 15) == 0 && (s % sizeof(S)) == 0) {
    head = (long long)(((16 - (s & 15)) & 15) / sizeof(S));
    if (head > n) head = n;
  }
  for (long long i = threadIdx.x; i < head; i += T) dst[i] = op(src[i]);
  if (head == n) return;
  const long long nvec = (n - head) / V;
  const uint4* __restrict__ sv = reinterpret_cast<const uint4*>(src + head);
  uint4* __restrict__ dv = reinterpret_cast<uint4*>(dst + head);
  long long v = threadIdx.x;
  for (; v + (kUnroll - 1) * T < nvec; v += kUnroll * T) {
    uint4 u[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) u[k] = __ldg(sv + v + k * T);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      scale_vec(u[k], op);
      dv[v + k * T] = u[k];
    }
  }
  for (; v < nvec; v += T) {
    uint4 u = __ldg(sv + v);
    scale_vec(u, op);
    dv[v] = u;
  }
  for (long long i = head + nvec * V + threadIdx.x; i < n; i += T)
    dst[i] = op(src[i]);
}

// Elements [e0, e1) of the chunk, by the whole block: from the last tensor
// that starts at or before e0 (empty tensors start where the next one does,
// and the walk passes over them) on, tensor by tensor.
template <class Op, bool kPack>
__device__ __forceinline__ void move(const PackTable& t,
                                     typename Op::S* __restrict__ flat,
                                     const Op& op, long long e0,
                                     long long e1) {
  typedef typename Op::S S;
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.off[mid] <= e0) lo = mid; else hi = mid - 1;
  }
  for (int i = lo; i < t.count && t.off[i] < e1; ++i) {
    const long long a = max(e0, t.off[i]), b = min(e1, t.off[i + 1]);
    if (a >= b) continue;
    S* own = reinterpret_cast<S*>(t.ptr[i]) + (a - t.off[i]);
    if (kPack)
      copy_range(own, flat + a, b - a, op);
    else
      copy_range(flat + a, own, b - a, op);
  }
}

// One block a kTileBytes tile of the chunk.
template <class Op, bool kPack>
__global__ void __launch_bounds__(HVD_PACK_THREADS)
    fused_pack_kernel(const __grid_constant__ PackTable t,
                      typename Op::S* __restrict__ flat, const Op op) {
  typedef typename Op::S S;
  const long long total = t.off[t.count];
  const long long tile = kTileBytes / (long long)sizeof(S);
  const long long e0 = blockIdx.x * tile;
  move<Op, kPack>(t, flat, op, e0, min(total, e0 + tile));
}

template <class Op>
static int launch(int pack, const PackTable& t, void* flat, const Op& op,
                  cudaStream_t stream) {
  typedef typename Op::S S;
  const long long bytes = t.off[t.count] * (long long)sizeof(S);
  if (bytes == 0) return 0;
  const long long grid = (bytes + kTileBytes - 1) / kTileBytes;
  if (pack)
    fused_pack_kernel<Op, true><<<(unsigned)grid, HVD_PACK_THREADS, 0,
                                  stream>>>(t, static_cast<S*>(flat), op);
  else
    fused_pack_kernel<Op, false><<<(unsigned)grid, HVD_PACK_THREADS, 0,
                                   stream>>>(t, static_cast<S*>(flat), op);
  return (int)cudaGetLastError();
}

// pack != 0: tensors -> flat; pack == 0: flat -> tensors. dtype: 0 byte copy
// (lengths and offsets in bytes), 1 fp32, 2 bf16, 3 fp16, 4 fp64 (in
// elements). ptrs[count], offs[count + 1] (offs[count] = the chunk's
// length); count <= HVD_PACK_MAX_SEGS. The factor is f32 for fp32, bf16 and
// fp16 (their functors round it to bf16 or fp16), f64 for fp64. Makes
// `device` current and launches on `stream`. Returns 0, a cudaError_t, or
// -1 for bad arguments.
extern "C" int hvd_fused_pack(int pack, int dtype,
                              const unsigned long long* ptrs,
                              const long long* offs, int count, void* flat,
                              float f32, double f64, int device,
                              void* stream) {
  if (count < 1 || count > HVD_PACK_MAX_SEGS) return -1;
  if (dtype < 0 || dtype > 4) return -1;
  int err = (int)cudaSetDevice(device);
  if (err != 0) return err;
  PackTable t;
  t.count = count;
  for (int i = 0; i < count; ++i) {
    if (offs[i + 1] < offs[i]) return -1;
    t.ptr[i] = ptrs[i];
    t.off[i] = offs[i];
  }
  t.off[count] = offs[count];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch(pack, t, flat, CopyOp(), s);
    case 1: {
      F32Op op;
      op.f = f32;
      return launch(pack, t, flat, op, s);
    }
    case 2: return launch(pack, t, flat, BF16Op(f32), s);
    case 3: return launch(pack, t, flat, F16Op(f32), s);
    default: {
      F64Op op;
      op.f = f64;
      return launch(pack, t, flat, op, s);
    }
  }
}
