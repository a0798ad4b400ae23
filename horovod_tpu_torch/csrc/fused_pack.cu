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
// over device-memory bandwidth, and what reaches it is bytes in flight. The
// table, the 16 KB tiles across tensor boundaries and the unrolled 16-byte
// loads are in tensor_table.cuh, which K2's cast pack (quant_wire.cu) shares;
// the tile size and the unroll were chosen by a sweep on the card against
// torch.cat and split + copy_ (PERF.md, K1).

#include "tensor_table.cuh"

// Scale functors on the storage type S (bf16 and fp16 as raw 16 bits); the
// destination type D is S.
struct CopyOp {
  typedef uint8_t S;
  typedef S D;
  static const bool kIdentity = true;
  __device__ S operator()(S x) const { return x; }
};
struct F32Op {
  typedef float S;
  typedef S D;
  static const bool kIdentity = false;
  float f;
  __device__ S operator()(S x) const { return x * f; }
};
struct F64Op {
  typedef double S;
  typedef S D;
  static const bool kIdentity = false;
  double f;
  __device__ S operator()(S x) const { return x * f; }
};
struct BF16Op {
  typedef uint16_t S;
  typedef S D;
  static const bool kIdentity = false;
  float f;  // the factor in bf16
  explicit BF16Op(float factor)
      : f(__bfloat162float(__float2bfloat16_rn(factor))) {}
  __device__ S operator()(S x) const {
    return BF16::store(BF16::load(x) * f);
  }
};
struct F16Op {
  typedef uint16_t S;
  typedef S D;
  static const bool kIdentity = false;
  float f;  // the factor in fp16
  explicit F16Op(float factor) : f(__half2float(__float2half_rn(factor))) {}
  __device__ S operator()(S x) const { return F16::store(F16::load(x) * f); }
};

// pack != 0: tensors -> flat; pack == 0: flat -> tensors. dtype: 0 byte copy
// (lengths and offsets in bytes), 1 fp32, 2 bf16, 3 fp16, 4 fp64 (in
// elements). ptrs[count], offs[count + 1] (offs[count] = the end of the
// table's range); count <= HVD_TABLE_MAX_SEGS. The factor is f32 for fp32,
// bf16 and fp16 (their functors round it to bf16 or fp16), f64 for fp64.
// Makes `device` current and launches on `stream`. Returns 0, a
// cudaError_t, or -1 for bad arguments.
extern "C" int hvd_fused_pack(int pack, int dtype,
                              const unsigned long long* ptrs,
                              const long long* offs, int count, void* flat,
                              float f32, double f64, int device,
                              void* stream) {
  TensorTable t;
  if (make_table(t, ptrs, offs, count) || dtype < 0 || dtype > 4) return -1;
  int err = (int)cudaSetDevice(device);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_table_copy(pack, t, flat, CopyOp(), s);
    case 1: {
      F32Op op;
      op.f = f32;
      return launch_table_copy(pack, t, flat, op, s);
    }
    case 2: return launch_table_copy(pack, t, flat, BF16Op(f32), s);
    case 3: return launch_table_copy(pack, t, flat, F16Op(f32), s);
    default: {
      F64Op op;
      op.f = f64;
      return launch_table_copy(pack, t, flat, op, s);
    }
  }
}
