// Building blocks of the Hopper (sm_90a) flash-attention forward kernels,
// shared by flash_attention_sm90.cu (bf16) and flash_attention_tf32.cu
// (fp32): mbarriers, TMA, wgmma descriptors and fences, the online softmax
// on a wgmma accumulator fragment, the causal work order of a persistent
// grid, tensor-map encoding, and the host side of the C entry points. Each
// kernel source is its own library, so everything here has internal
// linkage.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the
                   // runtime's driver entry point, so no -lcuda
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // NEG_INF of the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Returns once the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Barrier `id` (1..15; 0 is __syncthreads) over `n` threads.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// One TMA box of a 3-D tensor map at (column c0, row c1, batch c2).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Shared memory to one box of a 3-D tensor map, in the current bulk group;
// rows past the map's s are clipped.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle layout in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>  // until at most N committed groups are pending
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pins the accumulator registers in place around the asynchronous wgmma, so
// the compiler moves no read or write of them across the fence or the wait.
template <int N>
__device__ __forceinline__ void reg_fence(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// 2^x on the special-function unit alone; results below 2^-126 (p under
// 1e-38) flush to 0 rather than taking exp2f's denormal fix-up
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax over one warpgroup's 64 x BK score fragment. Fragment
// index i of a thread holds row r0 + 8 * ((i >> 1) & 1) and column
// 8 * (i / 4) + cq + (i & 1) of the tile (the wgmma accumulator layout), so
// the thread owns two rows, each shared with the 3 other lanes of its quad.
template <int BK>
struct Softmax {
  float m[2] = {kNegInf, kNegInf};  // running max, natural-log units
  float l[2] = {0.f, 0.f};          // this lane's part of the running sum
  int r0, row0, cq, sk, causal, offset;
  float scale, sl2;

  __device__ Softmax(int r0_, int row0_, int cq_, int sk_, int causal_,
                     int offset_, float scale_)
      : r0(r0_), row0(row0_), cq(cq_), sk(sk_), causal(causal_),
        offset(offset_), scale(scale_), sl2(scale_ * kLog2e) {}

  // Raw scores of the K tile at key k0 in, p out; alpha = exp(m_old - m).
  __device__ __forceinline__ void tile(float (&s)[BK / 2], int k0,
                                       float (&alpha)[2]) {
    // the mask only on tiles that cross the diagonal or the ragged end
    const bool masked =
        k0 + BK > sk || (causal && k0 + BK - 1 + offset > row0);
    // column k0 + cq + 8 * (i / 4) + (i & 1) is kept in row r where the
    // compile-time part 8 * (i / 4) + (i & 1) is at most lim[r]
    const int in_sk = sk - 1 - (k0 + cq);
    int lim[2] = {in_sk, in_sk};
    if (masked) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (causal) lim[r] = min(in_sk, r0 + 8 * r - offset - (k0 + cq));
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        if (8 * (i / 4) + (i & 1) > lim[(i >> 1) & 1]) s[i] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY}, ml[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // scale > 0 commutes with the max: this is max(s * scale), exactly
      const float m_new = fmaxf(m[r], mx[r] * scale);
      alpha[r] = exp2_ftz((m[r] - m_new) * kLog2e);
      m[r] = m_new;
      ml[r] = m_new * kLog2e;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      s[i] = exp2_ftz(fmaf(s[i], sl2, -ml[(i >> 1) & 1]));
    if (masked && causal && (m[0] == kNegInf || m[1] == kNegInf)) {
      // a causally masked score is NEG_INF, not -inf: its p is
      // exp(NEG_INF - m), 1 on a row the mask has emptied so far (every
      // key < sk of this tile is masked there)
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        if (m[(i >> 1) & 1] == kNegInf)
          s[i] = 8 * (i / 4) + (i & 1) <= in_sk ? 1.f : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) ps[(i >> 1) & 1] += s[i];
    // the quad's partial sums add up once, at the end
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ps[r];
  }
};

// The work of a block, in order. Q tiles are listed batch row by batch row,
// each row's tiles alternating heaviest and lightest (nq-1, 0, nq-2, 1, ...),
// and cut into units of two consecutive tiles: under the causal mask a unit
// (t, nq-1-t) always holds nq + 1 K tiles, so the grid's blocks, each taking
// every gridDim.x-th unit, finish together; and the units in flight at once
// cover consecutive batch rows, whose K and V stay in L2 while their Q tiles
// read them.
struct Work {
  int b, q0, n_k;
};

template <int BQ, int BK>
__device__ __forceinline__ bool work_tile(int w, int B, int sq, int sk,
                                          int causal, int causal_offset,
                                          Work& out) {
  const int nq = (sq + BQ - 1) / BQ;
  const int f = 2 * (blockIdx.x + (w / 2) * gridDim.x) + (w & 1);
  if (f >= B * nq) return false;
  const int i = f % nq;
  out.b = f / nq;
  out.q0 = (i % 2 == 0 ? nq - 1 - i / 2 : i / 2) * BQ;
  // keys past q_last - causal_offset are masked for every row of the tile
  const int q_last = min(out.q0 + BQ, sq) - 1;
  const int k_end = causal ? min(sk, q_last - causal_offset + 1) : sk;
  out.n_k = k_end > 0 ? (k_end + BK - 1) / BK : 0;
  return true;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// 3-D map {d, s, B} of a contiguous [B, s, d] tensor of `elem`-byte
// elements, boxes of `box_cols` columns (one swizzle row) by `rows` rows of
// one batch row; out-of-range rows read 0.
CUresult make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                  CUtensorMapDataType dtype, int elem, int d, int s, int B,
                  int box_cols, int rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)d * elem,
                                 (cuuint64_t)s * d * elem};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)rows, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  return enc(map, dtype, 3, const_cast<void*>(ptr), dims, strides, box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// How a kernel's tensor maps lay out its tiles: the element type and size,
// the box's columns (one swizzle row) and the swizzle.
struct MapLayout {
  CUtensorMapDataType dtype;
  int elem;
  int box_cols;
  CUtensorMapSwizzle swizzle;
};

constexpr int kMaxDevices = 64;

// Launches `kernel`, the persistent kernel of head dim D, at most one block
// per SM over the causal pairs of its bq-row Q tiles, with `threads` threads
// and `smem` bytes of dynamic shared memory, on `stream`. The shared-memory
// opt-in and the SM count are set up once per device and D: at the slice
// shape the kernel takes about as long as the host's work per call, so the
// launch path does no more than it must.
template <int D, class Kernel, class... Args>
cudaError_t launch_persistent(Kernel kernel, int smem, int bq, int threads,
                              int device, cudaStream_t stream, int B, int sq,
                              Args... args) {
  static std::atomic<int> sms_of[kMaxDevices];  // 0: not set up yet
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int sms = sms_of[device].load(std::memory_order_acquire);
  if (sms == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return err;
    sms_of[device].store(sms, std::memory_order_release);
  }
  const long units = ((long)B * ((sq + bq - 1) / bq) + 1) / 2;
  const int grid = (int)(units < sms ? units : sms);
  kernel<<<dim3(grid), dim3(threads), smem, stream>>>(args...);
  return cudaGetLastError();
}

// The body of a flash kernel's C entry point. Checks the sizes, encodes the
// maps of q, k and v (boxes of bq, bk and bk rows) and, where o_rows > 0,
// of o (boxes of o_rows rows), makes `device` current, calls
// launch(std::integral_constant<int, D>, maps) for the head dim d and
// restores the device. Returns the cudaError_t of the launch (0 on
// success), or 10000 + the CUresult of a failed tensor-map encode (10000
// alone: no encoder).
template <class Launch>
int flash_entry(const MapLayout& lay, int bq, int bk, int o_rows,
                const void* q, const void* k, const void* v, void* o, int B,
                int sq, int sk, int d, int device, Launch&& launch) {
  if (B <= 0 || sq <= 0 || sk <= 0) return (int)cudaErrorInvalidValue;
  if (d != 32 && d != 64 && d != 128) return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return 10000;
  CUtensorMap tm[4];  // q, k, v, o
  auto map = [&](CUtensorMap* m, const void* p, int s, int rows) {
    return make_map(enc, m, p, lay.dtype, lay.elem, d, s, B, lay.box_cols,
                    rows, lay.swizzle);
  };
  CUresult res = map(&tm[0], q, sq, bq);
  if (res == CUDA_SUCCESS) res = map(&tm[1], k, sk, bk);
  if (res == CUDA_SUCCESS) res = map(&tm[2], v, sk, bk);
  if (res == CUDA_SUCCESS && o_rows > 0) res = map(&tm[3], o, sq, o_rows);
  if (res != CUDA_SUCCESS) return 10000 + (int)res;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch (d) {
    case 32: err = launch(std::integral_constant<int, 32>(), tm); break;
    case 64: err = launch(std::integral_constant<int, 64>(), tm); break;
    default: err = launch(std::integral_constant<int, 128>(), tm); break;
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // namespace
