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
// - hvd_quantize_pack (K3): one warp an absmax block. It forms
//   x = fp32(src) folded with the prescale and the error-feedback residual
//   (fmaf(x, pre, res) with both, one rounding, as XLA contracts
//   `cat * pre + res`; x * pre, x + res or x alone otherwise) and reduces
//   max|x| over the block (the tail padding reads as 0); scale =
//   absmax > 0 ? absmax * fp32(1/qmax) : 1 (XLA rewrites the JAX code's
//   division by the constant qmax into that product), rounded to bf16; it
//   stores q = clamp(rint(x / scale), -qmax, qmax) as int8, or as int4
//   nibbles, low first, in two's complement, and with error feedback the
//   new residual x - q * scale (an exact product; q = -0 counts as +0, as
//   the integer does). Each tensor's residual is read through a second pointer
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
// (pointer, offset) per tensor, the element types and K2's tile walk are
// K1's (tensor_table.cuh). The other two keep many bytes in flight a thread
// and spend few instructions a byte:
//
// - K3 takes a block of 256 elements that lies in one tensor, before the
//   padding, with source and residual 16-byte aligned, from registers: a
//   lane loads its 8 consecutive elements (and 8 residuals) with 16-byte
//   loads, the warp's absmax comes by shuffles, the lane quantizes from its
//   registers and stores its payload as one 8-byte (int8) or 4-byte (int4,
//   nibbles packed within the lane) store, the new residual as two 16-byte
//   stores, lane 0 the scale as one 2-byte store (narrower stores where the
//   row's start allows no wider). Every other block (other block sizes, a
//   block across a tensor boundary or in the padding, a misaligned start)
//   takes the two-pass walk of one element a lane, in the same kernel.
//   q's two's-complement bits come from q + 1.5 * 2^23 (q sits in the low
//   mantissa bits), so no float-to-int conversion is needed.
// - The reduce-unpack gives each thread a run of kRun consecutive elements
//   of the chunk. For up to kRowSlots rows at a time it issues every load
//   of the run first (the run's payload bytes as wide as the row's start
//   allows, 16-byte loads where it is aligned; the scales the run touches,
//   its block found by a shift when the block size is a power of two, else
//   one 32-bit division a run), then dequantizes and adds in rank order,
//   q * scale + acc as one fused multiply-add (q * scale is exact). A warp
//   whose runs lie in one tensor stores them through shared memory, 16
//   consecutive bytes a lane and instruction: stores kRun * 4 bytes apart
//   ran at half the rate (PERF.md). A run that the launch's range cuts, or
//   a chunk whose blocks are shorter than a run, is reduced element by
//   element. An int8 or int4 value becomes a float without a conversion:
//   its bits, offset to unsigned, are placed in the mantissa of
//   1.5 * 2^23 by one byte permute and the offset subtracted, exactly.

#include "tensor_table.cuh"

constexpr int kRun = 16;       // elements a thread of the reduce-unpack
constexpr int kRowSlots = 4;   // rows whose loads a thread issues at once
// Blocks of the reduce-unpack an SM holds at least: 64 registers a thread
// (48 for the int4 wire, whose loads are narrowest), measured fastest at
// the LM's chunks on an H100 (PERF.md).
constexpr int reduce_min_blocks(int wire) { return wire == 4 ? 5 : 4; }
constexpr int kRegBlock = 256; // the block size K3 takes from registers
constexpr float kMagic = 12582912.f;  // 1.5 * 2^23

// --- bytes at an address whose alignment every thread of a row shares ----

// NB bytes (a multiple of 4) at p into NB / 4 little-endian words, each
// load as wide as p's alignment allows, at most 16 bytes.
template <int NB>
__device__ __forceinline__ void load_bytes(const uint8_t* __restrict__ p,
                                           unsigned (&w)[NB / 4]) {
  const unsigned a = (unsigned)reinterpret_cast<uintptr_t>(p);
  if (NB % 16 == 0 && (a & 15) == 0) {
#pragma unroll
    for (int k = 0; k < NB / 16; ++k) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + k);
      w[4 * k] = v.x, w[4 * k + 1] = v.y, w[4 * k + 2] = v.z,
      w[4 * k + 3] = v.w;
    }
  } else if (NB % 8 == 0 && (a & 7) == 0) {
#pragma unroll
    for (int k = 0; k < NB / 8; ++k) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p) + k);
      w[2 * k] = v.x, w[2 * k + 1] = v.y;
    }
  } else if ((a & 3) == 0) {
#pragma unroll
    for (int k = 0; k < NB / 4; ++k)
      w[k] = __ldg(reinterpret_cast<const unsigned*>(p) + k);
  } else if ((a & 1) == 0) {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int k = 0; k < NB / 4; ++k)
      w[k] = (unsigned)__ldg(h + 2 * k) | ((unsigned)__ldg(h + 2 * k + 1) << 16);
  } else {
#pragma unroll
    for (int k = 0; k < NB / 4; ++k)
      w[k] = (unsigned)__ldg(p + 4 * k) | ((unsigned)__ldg(p + 4 * k + 1) << 8) |
             ((unsigned)__ldg(p + 4 * k + 2) << 16) |
             ((unsigned)__ldg(p + 4 * k + 3) << 24);
  }
}

// The words back to NB bytes at p, each store as wide as p allows.
template <int NB>
__device__ __forceinline__ void store_bytes(uint8_t* __restrict__ p,
                                            const unsigned (&w)[NB / 4]) {
  const unsigned a = (unsigned)reinterpret_cast<uintptr_t>(p);
  if (NB % 16 == 0 && (a & 15) == 0) {
#pragma unroll
    for (int k = 0; k < NB / 16; ++k)
      reinterpret_cast<uint4*>(p)[k] =
          make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
  } else if (NB % 8 == 0 && (a & 7) == 0) {
#pragma unroll
    for (int k = 0; k < NB / 8; ++k)
      reinterpret_cast<uint2*>(p)[k] = make_uint2(w[2 * k], w[2 * k + 1]);
  } else if ((a & 3) == 0) {
#pragma unroll
    for (int k = 0; k < NB / 4; ++k) reinterpret_cast<unsigned*>(p)[k] = w[k];
  } else if ((a & 1) == 0) {
    unsigned short* h = reinterpret_cast<unsigned short*>(p);
#pragma unroll
    for (int k = 0; k < NB / 4; ++k) {
      h[2 * k] = (unsigned short)w[k];
      h[2 * k + 1] = (unsigned short)(w[k] >> 16);
    }
  } else {
#pragma unroll
    for (int k = 0; k < NB; ++k) p[k] = (uint8_t)(w[k / 4] >> (8 * (k % 4)));
  }
}

// A bf16 scale's bits at p, which may be odd.
__device__ __forceinline__ uint16_t load_u16(const uint8_t* __restrict__ p) {
  if (reinterpret_cast<uintptr_t>(p) & 1)
    return (uint16_t)(__ldg(p) | (__ldg(p + 1) << 8));
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

__device__ __forceinline__ void store_u16(uint8_t* __restrict__ p,
                                          uint16_t v) {
  if (reinterpret_cast<uintptr_t>(p) & 1) {
    p[0] = (uint8_t)(v & 0xff);
    p[1] = (uint8_t)(v >> 8);
  } else {
    *reinterpret_cast<uint16_t*>(p) = v;
  }
}


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

// Whether the block at `base` (in tensor `seg`, the last that starts at or
// before it) takes the register path: the block size is kRegBlock, the block
// lies in the tensor and before the padding, and the lane's 8 sources and
// residuals are 16-byte aligned (the same for every block of a tensor).
// ops/quant_wire.py quantize_block_paths counts the blocks by this rule.
template <class In>
__device__ __forceinline__ bool register_path(const TensorTable& t,
                                              const PtrList& res, int seg,
                                              long long base, int block,
                                              long long total, int mode,
                                              const float* res_out) {
  if (block != kRegBlock ||
      base + kRegBlock > min(total, t.off[seg + 1]))
    return false;
  const long long j = base - t.off[seg];
  if ((t.ptr[seg] + j * sizeof(typename In::S)) & 15) return false;
  if (mode & 2) {
    if (reinterpret_cast<uintptr_t>(res_out) & 15) return false;
    if (res.p[seg] && ((res.p[seg] + j * 4) & 15)) return false;
  }
  return true;
}

// 8 consecutive elements at a 16-byte aligned p, widened to fp32.
template <class In>
__device__ __forceinline__ void load8(const typename In::S* __restrict__ p,
                                      float (&x)[8]) {
  constexpr int kVecs = 8 * sizeof(typename In::S) / 16;
  union {
    uint4 v[kVecs];
    typename In::S e[8];
  } u;
#pragma unroll
  for (int k = 0; k < kVecs; ++k)
    u.v[k] = __ldg(reinterpret_cast<const uint4*>(p) + k);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = In::load(u.e[i]);
}

// One block of kRegBlock elements from registers, lane `lane` holding
// elements 8 * lane .. 8 * lane + 7. src, r (null: zeros) and rout (null
// without error feedback) point at the block's first element, pay at its
// first payload byte, sc at its scale.
template <class In, int kBits>
__device__ __forceinline__ void quantize_regs(
    const typename In::S* __restrict__ src, const float* __restrict__ r,
    int mode, float pre, float* __restrict__ rout,
    uint8_t* __restrict__ pay, uint8_t* __restrict__ sc, int lane) {
  const float qmax = kBits == 8 ? 127.f : 7.f;
  const float inv_qmax = kBits == 8 ? 1.f / 127.f : 1.f / 7.f;
  float x[8];
  load8<In>(src + 8 * lane, x);
  if (mode & 2) {
    float rv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r != nullptr) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(r + 8 * lane));
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(r + 8 * lane) + 1);
      rv[0] = u.x, rv[1] = u.y, rv[2] = u.z, rv[3] = u.w;
      rv[4] = v.x, rv[5] = v.y, rv[6] = v.z, rv[7] = v.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      x[i] = (mode & 1) ? __fmaf_rn(x[i], pre, rv[i]) : __fadd_rn(x[i], rv[i]);
  } else if (mode & 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = __fmul_rn(x[i], pre);
  }
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(x[i]));
#pragma unroll
  for (int o = 16; o; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float scale = amax > 0.f ? __fmul_rn(amax, inv_qmax) : 1.f;
  const uint16_t sbits = BF16::store(scale);
  const float eff = BF16::load(sbits);
  if (lane == 0) store_u16(sc, sbits);
  constexpr int NB = kBits;  // payload bytes a lane: 8 values of kBits
  unsigned w[NB / 4];
#pragma unroll
  for (int k = 0; k < NB / 4; ++k) w[k] = 0u;
  float nr[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(x[i], eff)), -qmax), qmax);
    // q + 1.5 * 2^23 is exact and holds q's two's complement in its low
    // bits; subtracting it back gives q with -0 as +0, the integer's value
    const float m = __fadd_rn(q, kMagic);
    const unsigned bits = __float_as_uint(m);
    nr[i] = __fsub_rn(x[i], __fmul_rn(__fsub_rn(m, kMagic), eff));
    if constexpr (kBits == 8)
      w[i / 4] |= (bits & 0xffu) << (8 * (i % 4));
    else
      w[0] |= (bits & 0xfu) << (4 * i);
  }
  store_bytes<NB>(pay + NB * lane, w);
  if (rout != nullptr) {
    float4* o = reinterpret_cast<float4*>(rout + 8 * lane);
    o[0] = make_float4(nr[0], nr[1], nr[2], nr[3]);
    o[1] = make_float4(nr[4], nr[5], nr[6], nr[7]);
  }
}

// One warp a block. reg_blocks, when not null, counts the blocks that took
// the register path (a check of quantize_block_paths on the card).
template <class In, int kBits>
__global__ void __launch_bounds__(HVD_TABLE_THREADS)
    quantize_pack_kernel(const __grid_constant__ TensorTable t,
                         const __grid_constant__ PtrList res, long long b0,
                         long long b1, int block, long long total,
                         float* __restrict__ res_out, int mode, float pre,
                         uint8_t* __restrict__ payload,
                         uint8_t* __restrict__ scales,
                         unsigned long long* __restrict__ reg_blocks) {
  const int lane = threadIdx.x & 31;
  const long long b = b0 + (long long)blockIdx.x * (HVD_TABLE_THREADS / 32) +
                      (threadIdx.x >> 5);
  if (b >= b1) return;  // the whole warp
  const long long base = b * (long long)block;
  const int seg0 = find_seg(t, base);
  if (register_path<In>(t, res, seg0, base, block, total, mode, res_out)) {
    if (reg_blocks != nullptr && lane == 0) atomicAdd(reg_blocks, 1ull);
    const long long j = base - t.off[seg0];
    const float* r = reinterpret_cast<const float*>(res.p[seg0]);
    quantize_regs<In, kBits>(
        reinterpret_cast<const typename In::S*>(t.ptr[seg0]) + j,
        (mode & 2) && r != nullptr ? r + j : nullptr, mode, pre,
        (mode & 2) ? res_out + base : nullptr,
        payload + base * kBits / 8, scales + 2 * b, lane);
    return;
  }
  // the general path: two passes of one element a lane
  const float qmax = kBits == 8 ? 127.f : 7.f;
  const float inv_qmax = kBits == 8 ? 1.f / 127.f : 1.f / 7.f;
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
  if (lane == 0) store_u16(scales + 2 * b, sbits);
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
      res_out[e] = __fsub_rn(x, __fmul_rn(__fadd_rn(q, 0.f), eff));
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

// Element e of one row, dequantized (the general path).
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

// A run's int8 or int4 values as bytes, each the value's two's
// complement bits xor the sign bit (so value + 128, or value + 8): int8
// words as they are; an int4 word's 8 nibbles (elements low nibble first)
// split into the even elements' bytes and the odd elements'.
template <int kWire>
__device__ __forceinline__ void run_bytes(const unsigned* w, unsigned* u) {
  if constexpr (kWire == 8) {
#pragma unroll
    for (int k = 0; k < kRun / 4; ++k) u[k] = w[k] ^ 0x80808080u;
  } else {
#pragma unroll
    for (int k = 0; k < kRun / 8; ++k) {
      const unsigned x = w[k] ^ 0x88888888u;
      u[2 * k] = x & 0x0f0f0f0fu;
      u[2 * k + 1] = (x >> 4) & 0x0f0f0f0fu;
    }
  }
}

// Element i's byte from run_bytes, or'ed into the mantissa of 1.5 * 2^23:
// the float 1.5 * 2^23 + value + offset, exactly (offset 128 or 8).
template <int kWire>
__device__ __forceinline__ float run_offset_value(const unsigned* u, int i) {
  const unsigned word =
      kWire == 8 ? u[i / 4] : u[2 * (i / 8) + (i & 1)];
  const int byte = kWire == 8 ? i % 4 : (i % 8) / 2;
  return __uint_as_float(__byte_perm(word, 0x4B400000u, 0x7640 | byte));
}

// The rank-order sum of the run [e, e + kRun) over every row: for up to
// kRowSlots rows at a time, every load first, then the adds. An int8/int4
// value q times its scale is exact (at most 8 and 8 significant bits, on
// fp32's grid) unless it overflows, so acc + q * scale rounds once as one
// fused multiply-add; a scale above 2^120, where 127 * scale could
// overflow, makes it return false (the caller then takes the run element
// by element). kOneBlock: the run lies in one block (block % kRun == 0).
template <int kWire, bool kOneBlock>
__device__ __forceinline__ bool reduce_run(const uint8_t* __restrict__ gathered,
                                           long long row_bytes,
                                           long long payload_bytes,
                                           int nrows, int block, long long e,
                                           float (&acc)[kRun]) {
  constexpr int NB = kRun * kWire / 8;  // a row's bytes of the run
  constexpr float kOffset = kMagic + (kWire == 8 ? 128.f : 8.f);
  // the run's elements below `split` lie in block b0, the rest in b0 + 1
  // (which exists when split < kRun: the run ends before the padding does)
  long long b0 = 0;
  int split = kRun;
  if constexpr (kWire != 16) {
    if (!(block & (block - 1)))
      b0 = e >> (__ffs(block) - 1);
    else
      b0 = e < (1ll << 32) ? (long long)((unsigned)e / (unsigned)block)
                           : e / block;
    if constexpr (!kOneBlock)
      split = (int)min((b0 + 1) * block - e, (long long)kRun);
  }
  bool exact = true;
#pragma unroll
  for (int i = 0; i < kRun; ++i) acc[i] = 0.f;
  for (int g = 0; g < nrows; g += kRowSlots) {
    unsigned w[kRowSlots][NB / 4];
    float s0[kRowSlots], s1[kRowSlots];
#pragma unroll
    for (int j = 0; j < kRowSlots; ++j) {
      if (g + j < nrows) {
        const uint8_t* row = gathered + (g + j) * row_bytes;
        load_bytes<NB>(row + e * kWire / 8, w[j]);
        if constexpr (kWire != 16) {
          const uint8_t* sc = row + payload_bytes + 2 * b0;
          s0[j] = BF16::load(load_u16(sc));
          if constexpr (!kOneBlock)
            s1[j] = split < kRun ? BF16::load(load_u16(sc + 2)) : s0[j];
          exact = exact && s0[j] <= 0x1p120f &&
                  (kOneBlock || s1[j] <= 0x1p120f);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRowSlots; ++j) {
      if (g + j < nrows) {
        const bool first = g == 0 && j == 0;
        if constexpr (kWire == 16) {
#pragma unroll
          for (int i = 0; i < kRun; ++i) {
            const unsigned v = w[j][i / 2];
            const float x = __uint_as_float((i & 1) ? (v & 0xffff0000u)
                                                    : (v << 16));
            acc[i] = first ? x : __fadd_rn(acc[i], x);
          }
        } else {
          unsigned u[kRun / 4];
          run_bytes<kWire>(w[j], u);
#pragma unroll
          for (int i = 0; i < kRun; ++i) {
            const float q = __fsub_rn(run_offset_value<kWire>(u, i), kOffset);
            const float sc = (kOneBlock || i < split) ? s0[j] : s1[j];
            acc[i] = first ? __fmul_rn(q, sc) : __fmaf_rn(q, sc, acc[i]);
          }
        }
      }
    }
  }
  return exact;
}

// Where lane `lane`'s 16-byte piece k of a warp's runs sits in the staging
// area: xor-swizzled so that the 8 lanes of a quarter-warp writing their
// piece k, and reading 8 consecutive pieces, meet 8 different bank groups.
template <int kVecs>
__device__ __forceinline__ int stage_slot(int lane, int k) {
  return lane * kVecs + (k ^ ((lane / (8 / kVecs)) & (kVecs - 1)));
}

// One thread a run of kRun elements of [e0, e1); runs are counted from the
// chunk's element 0, so a run's bytes start at the same alignment in every
// run of a row. A warp whose 32 runs are whole and lie in one tensor at a
// 16-byte aligned start stores them through shared memory, each store
// instruction 16 consecutive bytes a lane (a run's own stores would leave
// every instruction's lanes kRun * sizeof(Out) bytes apart, which halves
// the rate at which the memory system takes them); other whole runs store
// their bytes as wide as the tensor allows, or one by one across a tensor
// boundary.
template <class Out, int kWire>
__global__ void __launch_bounds__(HVD_TABLE_THREADS, reduce_min_blocks(kWire))
    reduce_unpack_kernel(const __grid_constant__ TensorTable t, long long e0,
                         long long e1, const uint8_t* __restrict__ gathered,
                         long long row_bytes, long long payload_bytes,
                         int nrows, int block, float factor, int use_factor) {
  typedef typename Out::S S;
  constexpr int kVecs = kRun * sizeof(S) / 16;  // 16-byte pieces a run
  __shared__ uint4 stage[HVD_TABLE_THREADS / 32][32 * kVecs];
  const int lane = threadIdx.x & 31;
  const long long run = e0 / kRun + (long long)blockIdx.x * HVD_TABLE_THREADS +
                        threadIdx.x;
  const long long a = max(e0, run * kRun), b = min(e1, run * kRun + kRun);
  // every thread of the warp reaches the vote below
  float acc[kRun] = {};
  const bool whole =
      b - a == kRun && (kWire == 16 || block >= kRun) &&
      ((kWire == 16 || block % kRun == 0)
           ? reduce_run<kWire, true>(gathered, row_bytes, payload_bytes,
                                     nrows, block, a, acc)
           : reduce_run<kWire, false>(gathered, row_bytes, payload_bytes,
                                      nrows, block, a, acc));
  union {
    S e[kRun];
    unsigned w[kVecs * 4];
    uint4 v[kVecs];
  } out;
#pragma unroll
  for (int i = 0; i < kRun; ++i)
    out.e[i] = Out::store(use_factor ? __fmul_rn(acc[i], factor) : acc[i]);
  // the table lookup waits for nothing the loads need
  int seg = a < b ? find_seg(t, a) : 0;
  const bool inside = whole && t.off[seg + 1] >= b;
  const unsigned long long dst =
      inside ? t.ptr[seg] + (a - t.off[seg]) * sizeof(S) : 0ull;
  const int seg0 = __shfl_sync(0xffffffffu, seg, 0);
  const unsigned long long d0 = __shfl_sync(0xffffffffu, dst, 0);
  if (__all_sync(0xffffffffu, inside && seg == seg0) && !(d0 & 15)) {
    uint4* st = stage[threadIdx.x >> 5];
#pragma unroll
    for (int k = 0; k < kVecs; ++k) st[stage_slot<kVecs>(lane, k)] = out.v[k];
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int c = k * 32 + lane;  // the warp's piece c: lane c / kVecs's
      reinterpret_cast<uint4*>(d0)[c] =
          st[stage_slot<kVecs>(c / kVecs, c % kVecs)];
    }
    return;
  }
  if (inside) {
    store_bytes<kVecs * 16>(reinterpret_cast<uint8_t*>(dst), out.w);
    return;
  }
  if (whole) {
    // a run across tensor boundaries: its values one by one
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      while (t.off[seg + 1] <= a + i) ++seg;
      reinterpret_cast<S*>(t.ptr[seg])[a + i - t.off[seg]] = out.e[i];
    }
    return;
  }
  // a run cut by the launch's range, blocks shorter than a run, or a scale
  // too large for the fused multiply-add: element by element
  for (long long e = a; e < b; ++e) {
    while (t.off[seg + 1] <= e) ++seg;
    float x = deq<kWire>(gathered, e, block, payload_bytes);
    for (int r = 1; r < nrows; ++r)
      x = __fadd_rn(x, deq<kWire>(gathered + r * row_bytes, e, block,
                                  payload_bytes));
    if (use_factor) x = __fmul_rn(x, factor);
    reinterpret_cast<S*>(t.ptr[seg])[e - t.off[seg]] = Out::store(x);
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
                            float pre, uint8_t* payload, uint8_t* scales,
                            unsigned long long* reg_blocks) {
  if (bits == 8)
    quantize_pack_kernel<In, 8><<<g, HVD_TABLE_THREADS, 0, s>>>(
        t, res, b0, b1, block, total, res_out, mode, pre, payload, scales,
        reg_blocks);
  else
    quantize_pack_kernel<In, 4><<<g, HVD_TABLE_THREADS, 0, s>>>(
        t, res, b0, b1, block, total, res_out, mode, pre, payload, scales,
        reg_blocks);
}

// Blocks [b0, b1) of `block` elements; `total` is the chunk's unpadded
// length. payload and scales point at the start of the wire row's two
// parts. mode: bit 0 prescale, bit 1 error feedback: res_ptrs[count] holds
// each tensor's residual (0: zeros; res_ptrs null: zeros for all) and
// res_out receives the new residual, flat in chunk order. reg_blocks: a
// device counter the blocks that take the register path add to, or null.
extern "C" int hvd_quantize_pack(int dtype, int bits, int block,
                                 const unsigned long long* ptrs,
                                 const long long* offs, int count,
                                 const unsigned long long* res_ptrs,
                                 long long b0, long long b1, long long total,
                                 float* res_out, int mode, float pre,
                                 void* payload, void* scales,
                                 unsigned long long* reg_blocks, int device,
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
    case 1: launch_quantize<F32>(bits, g, s, t, res, b0, b1, block, total, res_out, mode, pre, p, sc, reg_blocks); break;
    case 2: launch_quantize<BF16>(bits, g, s, t, res, b0, b1, block, total, res_out, mode, pre, p, sc, reg_blocks); break;
    case 3: launch_quantize<F16>(bits, g, s, t, res, b0, b1, block, total, res_out, mode, pre, p, sc, reg_blocks); break;
    case 4: launch_quantize<F64>(bits, g, s, t, res, b0, b1, block, total, res_out, mode, pre, p, sc, reg_blocks); break;
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
  // one thread a run of the runs that overlap [e0, e1)
  const unsigned g =
      grid_of((e1 - 1) / kRun - e0 / kRun + 1, HVD_TABLE_THREADS);
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
