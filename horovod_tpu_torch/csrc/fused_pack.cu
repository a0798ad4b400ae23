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
// scale() applies the factor in fp32 (fp64 for fp64) and rounds once to
// the chunk's dtype (round to nearest even), which is also what the plain
// PyTorch version in ops/fused_pack.py computes. With a factor of 1 the
// wrapper passes dtype 0: a byte copy, valid for any dtype.
//
// What bounds it: bytes. Each element is read once and written once, with
// no arithmetic to speak of, so the floor is (bytes read + bytes written)
// over device-memory bandwidth. The design does that simply:
// - the table of (pointer, offset) per tensor rides by value in the
//   kernel's parameter space (__grid_constant__), so a chunk costs no
//   host-to-device copy; a chunk with more tensors than HVD_PACK_MAX_SEGS
//   takes several launches (the wrapper splits it);
// - the element range of each tensor is cut into fixed tiles, numbered
//   across the whole chunk; a block takes a tile, finds its tensor by a
//   binary search over the tiles' prefix sums, and walks it with 16-byte
//   loads and stores where source and destination share their alignment
//   (a scalar head and tail around them), scalar accesses otherwise;
// - a grid of a few blocks per SM strides over the tiles.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define HVD_PACK_MAX_SEGS 128
#define HVD_PACK_TILE_BYTES 16384
#define HVD_PACK_THREADS 256

struct PackTable {
  unsigned long long ptr[HVD_PACK_MAX_SEGS];  // each tensor's own pointer
  long long off[HVD_PACK_MAX_SEGS + 1];       // elements before it in flat
  long long tile0[HVD_PACK_MAX_SEGS + 1];     // its first tile; [count] = all
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
  float f;
  __device__ S operator()(S x) const {
    float v = __uint_as_float(((unsigned)x) << 16) * f;
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
struct F16Op {
  typedef uint16_t S;
  static const bool kIdentity = false;
  float f;
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

// One block-sized piece: n elements from src to dst.
template <class Op>
__device__ __forceinline__ void copy_range(const typename Op::S* src,
                                           typename Op::S* dst, long long n,
                                           const Op& op) {
  typedef typename Op::S S;
  const int V = 16 / sizeof(S);
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  long long head = n;  // scalar elements before the vector body
  if (((s ^ d) & 15) == 0 && (s % sizeof(S)) == 0) {
    head = (long long)(((16 - (s & 15)) & 15) / sizeof(S));
    if (head > n) head = n;
  }
  for (long long i = threadIdx.x; i < head; i += blockDim.x)
    dst[i] = op(src[i]);
  if (head == n) return;
  const long long nvec = (n - head) / V;
  const uint4* sv = reinterpret_cast<const uint4*>(src + head);
  uint4* dv = reinterpret_cast<uint4*>(dst + head);
  for (long long v = threadIdx.x; v < nvec; v += blockDim.x) {
    uint4 u = sv[v];
    scale_vec(u, op);
    dv[v] = u;
  }
  for (long long i = head + nvec * V + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = op(src[i]);
}

template <class Op, bool kPack>
__global__ void __launch_bounds__(HVD_PACK_THREADS)
    fused_pack_kernel(const __grid_constant__ PackTable t,
                      typename Op::S* flat, const Op op) {
  typedef typename Op::S S;
  const long long tile_elems = HVD_PACK_TILE_BYTES / sizeof(S);
  const long long tiles = t.tile0[t.count];
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    // the last tensor whose first tile is <= tile (empty tensors own no
    // tile, so the search passes over them)
    int lo = 0, hi = t.count - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (t.tile0[mid] <= tile) lo = mid; else hi = mid - 1;
    }
    const long long e0 = (tile - t.tile0[lo]) * tile_elems;
    const long long len = t.off[lo + 1] - t.off[lo];
    const long long n = (len - e0 < tile_elems) ? len - e0 : tile_elems;
    S* own = reinterpret_cast<S*>(t.ptr[lo]) + e0;
    S* packed = flat + t.off[lo] + e0;
    if (kPack)
      copy_range(own, packed, n, op);
    else
      copy_range(packed, own, n, op);
  }
}

static int sm_count(int device) {
  static int cached[64] = {0};
  if (device < 0 || device >= 64) return 132;
  if (cached[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess || n <= 0)
      n = 132;
    cached[device] = n;
  }
  return cached[device];
}

template <class Op>
static int launch(int pack, const PackTable& t, void* flat, const Op& op,
                  int device, cudaStream_t stream) {
  const long long tiles = t.tile0[t.count];
  if (tiles == 0) return 0;
  long long grid = 8LL * sm_count(device);
  if (grid > tiles) grid = tiles;
  typedef typename Op::S S;
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
// fp16, f64 for fp64. Makes `device` current and launches on `stream`.
// Returns 0, a cudaError_t, or -1 for bad arguments.
extern "C" int hvd_fused_pack(int pack, int dtype,
                              const unsigned long long* ptrs,
                              const long long* offs, int count, void* flat,
                              float f32, double f64, int device,
                              void* stream) {
  if (count < 1 || count > HVD_PACK_MAX_SEGS) return -1;
  static const int kItem[5] = {1, 4, 2, 2, 8};
  if (dtype < 0 || dtype > 4) return -1;
  int err = (int)cudaSetDevice(device);
  if (err != 0) return err;
  PackTable t;
  const long long tile_elems = HVD_PACK_TILE_BYTES / kItem[dtype];
  t.count = count;
  t.tile0[0] = 0;
  for (int i = 0; i < count; ++i) {
    const long long n = offs[i + 1] - offs[i];
    if (n < 0) return -1;
    t.ptr[i] = ptrs[i];
    t.off[i] = offs[i];
    t.tile0[i + 1] = t.tile0[i] + (n + tile_elems - 1) / tile_elems;
  }
  t.off[count] = offs[count];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch(pack, t, flat, CopyOp(), device, s);
    case 1: { F32Op op; op.f = f32; return launch(pack, t, flat, op, device, s); }
    case 2: { BF16Op op; op.f = f32; return launch(pack, t, flat, op, device, s); }
    case 3: { F16Op op; op.f = f32; return launch(pack, t, flat, op, device, s); }
    default: { F64Op op; op.f = f64; return launch(pack, t, flat, op, device, s); }
  }
}
