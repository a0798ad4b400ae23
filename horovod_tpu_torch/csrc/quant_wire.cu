// K2 and K3: the compressed gradient wire of the background runtime's
// fused allreduce, written by hand for Hopper (sm_90a).
//
// Replaces the device programs of horovod_tpu/ops/collectives.py that XLA
// compiles for a compressed chunk: the bf16 cast plan
// (_build_cast_fused_plan, :1060-1090: ravel + concat + prescale + cast,
// then widen + reduce + postscale + cast back + unpack) and the blockwise
// int8/int4 plan (_build_quant_fused_plan, :971-1016, over
// ops/compression.py quantize_blockwise / dequantize_blockwise, :299-343).
// Eager PyTorch cannot fuse those chains, so a chunk runs as
//
//   K2 cast pack or K3 quantize pack -> one NCCL allgather of the byte
//   rows [payload | scales] -> reduce-unpack
//
// with three kernels, each one launch per chunk (more when a chunk has
// more tensors than one table holds):
//
// - hvd_cast_pack (K2): wire[e] = bf16_rn(fp32(src_i[j]) * pre), the
//   multiply skipped when pre == 1: two roundings, as the JAX program. It is
//   K1's pack (tensor_table.cuh's table_copy_kernel) with a bf16 destination
//   and an fp32 factor that is not rounded to the chunk's dtype.
// - hvd_quantize_pack (K3): one warp an absmax block. Pass 1 forms
//   x = fp32(src) folded with the prescale and the error-feedback residual
//   (fmaf(x, pre, res) with both, one rounding, as XLA contracts
//   `cat * pre + res`; x * pre, x + res or x alone otherwise) and reduces
//   max|x| over the block (the tail padding reads as 0); scale =
//   absmax > 0 ? absmax * fp32(1/qmax) : 1 (XLA rewrites the JAX code's
//   division by the constant qmax into that product), rounded to bf16. Pass
//   2 forms x again (the block's bytes are in L1) and stores
//   q = clamp(rint(x / scale), -qmax, qmax) as int8, or as int4 nibbles,
//   low first, in two's complement (the odd lane's value comes by a
//   shuffle), and with error feedback the new residual x - q * scale (an
//   exact product). Each tensor's residual is read through a second pointer
//   table (a tensor with none reads zeros), so a residual follows its tensor
//   whatever chunk the tensor lands in; the new residual is written flat, in
//   chunk order.
// - hvd_reduce_unpack (K2's and K3's far side, templated on the wire):
//   acc = deq(row 0) + deq(row 1) + ... in rank order in fp32; AVERAGE
//   multiplies by fp32(fp32(1/N) * fp32(post)), the one constant XLA folds
//   the mean and the postscale into; SUM by post when post != 1; then the
//   cast to the chunk dtype, written through the table into the outputs.
//
// The plain PyTorch versions in ops/quant_wire.py compute the same, bit for
// bit. Every rounding is spelled out (__fmaf_rn, __fmul_rn, __fdiv_rn,
// __fadd_rn) so that nvcc's contraction cannot change a bit; x / scale is
// an IEEE division (no --use_fast_math), as XLA keeps it for a divisor that
// is not a constant.
//
// What bounds them: bytes. Each reads its inputs once and writes its
// outputs once with a few operations an element (the reduce-unpack reads N
// rows), so the floor is bytes over device-memory bandwidth. The table of
// (pointer, offset) per tensor, the element types and the tile walk are
// K1's (tensor_table.cuh). The reduce-unpack cuts its element range into
// 4096-element tiles that run across tensor boundaries, one block a tile,
// and walks a tile tensor by tensor after one binary search; the quantize
// walks a block's elements with a segment hint per lane. Their accesses are
// scalar and coalesced: a first, simple version (PERF.md holds its times
// against its bounds).

#include "tensor_table.cuh"

constexpr long long kTile = 4096;  // elements a block of the reduce-unpack

// --- K2: the cast pack ------------------------------------------------------

template <class In>
struct CastOp {
  typedef typename In::S S;
  typedef uint16_t D;  // bf16
  static const bool kIdentity = false;
  float pre;
  int use_pre;
  __device__ D operator()(S x) const {
    float v = In::load(x);
    if (use_pre) v = __fmul_rn(v, pre);
    return BF16::store(v);
  }
};

// --- K3: the blockwise quantize pack ---------------------------------------

// Element e of the chunk as K3 quantizes it, from the hint `seg` on (e only
// grows along a lane's walk); 0 for the tail padding. mode bit 0: multiply
// by the prescale; bit 1: error feedback (a tensor without a residual
// pointer reads zeros, added as the JAX program adds its zeros).
template <class In>
__device__ __forceinline__ float quant_x(const TensorTable& t,
                                         const PtrList& res, long long e,
                                         int& seg, long long total, int mode,
                                         float pre) {
  if (e >= total) return 0.f;
  while (seg < t.count && t.off[seg + 1] <= e) ++seg;
  if (seg >= t.count) return 0.f;
  const long long j = e - t.off[seg];
  const float v =
      In::load(reinterpret_cast<const typename In::S*>(t.ptr[seg])[j]);
  if (mode & 2) {
    const float* r = reinterpret_cast<const float*>(res.p[seg]);
    const float rv = r ? r[j] : 0.f;
    return (mode & 1) ? __fmaf_rn(v, pre, rv) : __fadd_rn(v, rv);
  }
  return (mode & 1) ? __fmul_rn(v, pre) : v;
}

template <class In, int kBits>
__global__ void __launch_bounds__(HVD_TABLE_THREADS)
    quantize_pack_kernel(const __grid_constant__ TensorTable t,
                         const __grid_constant__ PtrList res, long long b0,
                         long long b1, int block, long long total,
                         float* __restrict__ res_out, int mode, float pre,
                         uint8_t* __restrict__ payload,
                         uint8_t* __restrict__ scales) {
  const int lane = threadIdx.x & 31;
  const long long b = b0 + (long long)blockIdx.x * (HVD_TABLE_THREADS / 32) +
                      (threadIdx.x >> 5);
  if (b >= b1) return;  // the whole warp
  const float qmax = kBits == 8 ? 127.f : 7.f;
  const float inv_qmax = kBits == 8 ? 1.f / 127.f : 1.f / 7.f;
  const long long base = b * (long long)block;
  const int seg0 = find_seg(t, base);
  // pass 1: the block's absmax
  float amax = 0.f;
  int seg = seg0;
  for (int k = lane; k < block; k += 32)
    amax = fmaxf(amax, fabsf(quant_x<In>(t, res, base + k, seg, total, mode,
                                         pre)));
#pragma unroll
  for (int o = 16; o; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float scale = amax > 0.f ? __fmul_rn(amax, inv_qmax) : 1.f;
  const uint16_t sbits = BF16::store(scale);
  const float eff = BF16::load(sbits);
  if (lane == 0) {
    scales[2 * b] = (uint8_t)(sbits & 0xff);
    scales[2 * b + 1] = (uint8_t)(sbits >> 8);
  }
  // pass 2: quantize, store, and the new residual
  seg = seg0;
  const int iters = (block + 31) / 32;
  for (int it = 0; it < iters; ++it) {
    const int k = lane + 32 * it;
    const bool valid = k < block;
    const long long e = base + k;
    const float x =
        valid ? quant_x<In>(t, res, e, seg, total, mode, pre) : 0.f;
    const float q = fminf(fmaxf(rintf(__fdiv_rn(x, eff)), -qmax), qmax);
    if (valid && res_out != nullptr && e < total)
      res_out[e] = __fsub_rn(x, __fmul_rn(q, eff));
    const int qi = (int)q;
    if (kBits == 8) {
      if (valid) payload[e] = (uint8_t)(int8_t)qi;
    } else {
      // blocks are even, so a lane's parity is its element's
      const int hi = __shfl_down_sync(0xffffffffu, qi, 1);
      if (valid && !(lane & 1))
        payload[e >> 1] = (uint8_t)((qi & 0xF) | ((hi & 0xF) << 4));
    }
  }
}

// --- K2/K3: the reduce-unpack ----------------------------------------------

template <int kWire>
__device__ __forceinline__ float deq(const uint8_t* __restrict__ row,
                                     long long e, int block,
                                     long long payload_bytes) {
  if (kWire == 16)
    return BF16::load(reinterpret_cast<const uint16_t*>(row)[e]);
  const long long s = payload_bytes + 2 * (e / block);
  const float eff = BF16::load((uint16_t)(row[s] | (row[s + 1] << 8)));
  int q;
  if (kWire == 8) {
    q = (int8_t)row[e];
  } else {
    const int byte = row[e >> 1];
    q = ((((e & 1) ? (byte >> 4) : byte) & 0xF) ^ 8) - 8;
  }
  return __fmul_rn((float)q, eff);
}

template <class Out, int kWire>
__global__ void __launch_bounds__(HVD_TABLE_THREADS)
    reduce_unpack_kernel(const __grid_constant__ TensorTable t, long long e0,
                         long long e1, const uint8_t* __restrict__ gathered,
                         long long row_bytes, long long payload_bytes,
                         int nrows, int block, float factor, int use_factor) {
  const long long a0 = e0 + (long long)blockIdx.x * kTile;
  const long long a1 = min(e1, a0 + kTile);
  for (int i = find_seg(t, a0); i < t.count && t.off[i] < a1; ++i) {
    const long long a = max(a0, t.off[i]), b = min(a1, t.off[i + 1]);
    typename Out::S* __restrict__ dst =
        reinterpret_cast<typename Out::S*>(t.ptr[i]);
    for (long long e = a + threadIdx.x; e < b; e += HVD_TABLE_THREADS) {
      float acc = deq<kWire>(gathered, e, block, payload_bytes);
      for (int r = 1; r < nrows; ++r)
        acc = __fadd_rn(acc, deq<kWire>(gathered + r * row_bytes, e, block,
                                        payload_bytes));
      if (use_factor) acc = __fmul_rn(acc, factor);
      dst[e - t.off[i]] = Out::store(acc);
    }
  }
}

// --- entry points -------------------------------------------------------------

static unsigned grid_of(long long n, long long per) {
  return (unsigned)((n + per - 1) / per);
}

// dtype codes (ops/quant_wire.py): 1 fp32, 2 bf16, 3 fp16, 4 fp64. The
// table: ptrs[count], offs[count + 1] in elements of the chunk. Each entry
// makes `device` current, launches on `stream` and returns 0, a
// cudaError_t, or -1 for bad arguments.

// The table's range [offs[0], offs[count]) into the bf16 wire at the same
// offsets.
extern "C" int hvd_cast_pack(int dtype, const unsigned long long* ptrs,
                             const long long* offs, int count, void* wire,
                             float pre, int use_pre, int device,
                             void* stream) {
  TensorTable t;
  if (make_table(t, ptrs, offs, count)) return -1;
  int err = (int)cudaSetDevice(device);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return launch_table_copy(1, t, wire, CastOp<F32>{pre, use_pre}, s);
    case 2: return launch_table_copy(1, t, wire, CastOp<BF16>{pre, use_pre}, s);
    case 3: return launch_table_copy(1, t, wire, CastOp<F16>{pre, use_pre}, s);
    case 4: return launch_table_copy(1, t, wire, CastOp<F64>{pre, use_pre}, s);
    default: return -1;
  }
}

template <class In>
static void launch_quantize(int bits, unsigned g, cudaStream_t s,
                            const TensorTable& t, const PtrList& res,
                            long long b0, long long b1, int block,
                            long long total, float* res_out, int mode,
                            float pre, uint8_t* payload, uint8_t* scales) {
  if (bits == 8)
    quantize_pack_kernel<In, 8><<<g, HVD_TABLE_THREADS, 0, s>>>(
        t, res, b0, b1, block, total, res_out, mode, pre, payload, scales);
  else
    quantize_pack_kernel<In, 4><<<g, HVD_TABLE_THREADS, 0, s>>>(
        t, res, b0, b1, block, total, res_out, mode, pre, payload, scales);
}

// Blocks [b0, b1) of `block` elements; `total` is the chunk's unpadded
// length. payload and scales point at the start of the wire row's two
// parts. mode: bit 0 prescale, bit 1 error feedback: res_ptrs[count] holds
// each tensor's residual (0: zeros; res_ptrs null: zeros for all) and
// res_out receives the new residual, flat in chunk order.
extern "C" int hvd_quantize_pack(int dtype, int bits, int block,
                                 const unsigned long long* ptrs,
                                 const long long* offs, int count,
                                 const unsigned long long* res_ptrs,
                                 long long b0, long long b1, long long total,
                                 float* res_out, int mode, float pre,
                                 void* payload, void* scales, int device,
                                 void* stream) {
  TensorTable t;
  if (make_table(t, ptrs, offs, count) || b1 < b0) return -1;
  if ((bits != 8 && bits != 4) || block < 8 || (bits == 4 && block % 2))
    return -1;
  if ((mode & 2) && res_out == nullptr) return -1;
  PtrList res;
  for (int i = 0; i < count; ++i) res.p[i] = res_ptrs ? res_ptrs[i] : 0ull;
  int err = (int)cudaSetDevice(device);
  if (err != 0) return err;
  if (b1 == b0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned g = grid_of(b1 - b0, HVD_TABLE_THREADS / 32);
  uint8_t* p = static_cast<uint8_t*>(payload);
  uint8_t* sc = static_cast<uint8_t*>(scales);
  switch (dtype) {
    case 1: launch_quantize<F32>(bits, g, s, t, res, b0, b1, block, total, res_out, mode, pre, p, sc); break;
    case 2: launch_quantize<BF16>(bits, g, s, t, res, b0, b1, block, total, res_out, mode, pre, p, sc); break;
    case 3: launch_quantize<F16>(bits, g, s, t, res, b0, b1, block, total, res_out, mode, pre, p, sc); break;
    case 4: launch_quantize<F64>(bits, g, s, t, res, b0, b1, block, total, res_out, mode, pre, p, sc); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

template <class Out>
static int launch_reduce(int wire, unsigned g, cudaStream_t s,
                         const TensorTable& t, long long e0, long long e1,
                         const uint8_t* gathered, long long row_bytes,
                         long long payload_bytes, int nrows, int block,
                         float factor, int use_factor) {
  switch (wire) {
    case 16: reduce_unpack_kernel<Out, 16><<<g, HVD_TABLE_THREADS, 0, s>>>(t, e0, e1, gathered, row_bytes, payload_bytes, nrows, block, factor, use_factor); break;
    case 8: reduce_unpack_kernel<Out, 8><<<g, HVD_TABLE_THREADS, 0, s>>>(t, e0, e1, gathered, row_bytes, payload_bytes, nrows, block, factor, use_factor); break;
    case 4: reduce_unpack_kernel<Out, 4><<<g, HVD_TABLE_THREADS, 0, s>>>(t, e0, e1, gathered, row_bytes, payload_bytes, nrows, block, factor, use_factor); break;
    default: return -1;
  }
  return 0;
}

// gathered: nrows rows of row_bytes each, rank order; wire 16 (bf16 rows),
// 8 or 4 (payload_bytes of payload, then the bf16 scales). The launch
// covers elements [e0, e1) of the chunk.
extern "C" int hvd_reduce_unpack(int dtype, int wire, int block,
                                 const void* gathered, long long row_bytes,
                                 long long payload_bytes, int nrows,
                                 const unsigned long long* ptrs,
                                 const long long* offs, int count,
                                 long long e0, long long e1, float factor,
                                 int use_factor, int device, void* stream) {
  TensorTable t;
  if (make_table(t, ptrs, offs, count) || e1 < e0 || nrows < 1) return -1;
  if (wire != 16 && block < 1) return -1;
  int err = (int)cudaSetDevice(device);
  if (err != 0) return err;
  if (e1 == e0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned g = grid_of(e1 - e0, kTile);
  const uint8_t* gp = static_cast<const uint8_t*>(gathered);
  int bad;
  switch (dtype) {
    case 1: bad = launch_reduce<F32>(wire, g, s, t, e0, e1, gp, row_bytes, payload_bytes, nrows, block, factor, use_factor); break;
    case 2: bad = launch_reduce<BF16>(wire, g, s, t, e0, e1, gp, row_bytes, payload_bytes, nrows, block, factor, use_factor); break;
    case 3: bad = launch_reduce<F16>(wire, g, s, t, e0, e1, gp, row_bytes, payload_bytes, nrows, block, factor, use_factor); break;
    case 4: bad = launch_reduce<F64>(wire, g, s, t, e0, e1, gp, row_bytes, payload_bytes, nrows, block, factor, use_factor); break;
    default: return -1;
  }
  if (bad) return -1;
  return (int)cudaGetLastError();
}
