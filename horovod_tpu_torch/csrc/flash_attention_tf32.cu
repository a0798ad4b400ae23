// Flash-attention forward for fp32 inputs on Hopper (sm_90a), on the tensor
// cores in 3xTF32: wgmma, TMA and an mbarrier pipeline. CUDA C++ with a
// plain C ABI.
//
// Replaces, for fp32 inputs, the Pallas TPU kernel `_flash_fwd_kernel`
// (horovod_tpu/ops/pallas/flash_attention.py:35-87, pallas_call at :122);
// bf16 inputs take flash_attention_sm90.cu. Contract: q [B, sq, D], k/v
// [B, sk, D] fp32, D in {32, 64, 128} -> normalized o [B, sq, D] fp32 plus
// the fp32 running max m and running sum l [B, sq]. Scale D^-0.5. The
// causal mask keeps row >= col + causal_offset, and masked scores take the
// finite NEG_INF = -1e30, so a row the mask empties (row 0 under offset 1)
// ends with m = NEG_INF and a finite o and l; o = acc / l, dividing by 1
// where l == 0. Ragged sq and sk, and sq != sk, are served. Unlike the bf16
// kernel, p is not rounded: P V multiplies the fp32 p.
//
// Precision. One TF32 product keeps 10 mantissa bits, which misses the
// contract's 1e-4 on o and 1e-5 on m. So each operand is split as x = hi +
// lo, and every product sums hi*lo and lo*hi, then hi*hi, into one fp32
// accumulator: CUTLASS's OpMultiplyAddFastF32 scheme, about fp32's accuracy
// (the dropped lo*lo is near 2^-21 of each product). wgmma ignores the low
// 13 mantissa bits of a .tf32 operand, so the split needs no conversion:
// hi is x as loaded (read as trunc(x)) and lo = x - trunc(x), exact in
// fp32 and read truncated in turn (tf32_hi, tf32_lo). The rounded split
// (cvt.rna for hi and lo, hi written back) was measured slower on the card
// (PERF.md).
//
// Bound at the slice shape (B = b*h = 128, s = 1024, D = 128, causal): the
// kept pairs need 3 x 34.4 GFLOP of TF32 at 495 TFLOP/s = 0.2085 ms; q, k,
// v, o, m and l are 270 MB at 3.35 TB/s = 0.081 ms. So operations bound it
// (0.5133 ms on the fp32 FMA pipes, where the SIMT kernel this one replaced
// ran). The design follows the bf16 kernel's skeleton:
//   - persistent: at most one block per SM, 512 threads in four
//     warpgroups. Warpgroups 0 and 1 are the producers (setmaxnreg 40):
//     thread 0 issues the TMA loads, warps 1-7 split and transpose each
//     K/V tile. Warpgroups 2 and 3 (setmaxnreg 216) each own 64 query rows
//     of a 128-row Q tile; blocks walk pairs of Q tiles (t, nq-1-t) of one
//     batch row (work_tile, flash_sm90_common.cuh);
//   - TF32 wgmma has no transpose bit, so both shared-memory operands are
//     K-major. S = Q K^T fits as it is (Q [rows, D], K [keys, D]). For
//     O += P V the B operand is V with K = keys, which TMA lands MN-major
//     and cannot transpose for 4-byte elements: the split warps write V^T
//     into swizzled shared memory;
//   - P is the A operand, from registers. An S accumulator thread holds
//     columns {2t, 2t+1} of each 8-column group, a k8 A fragment columns
//     {t, t+4}; V^T therefore stores the keys of each group of 8 in the
//     order [0,2,4,6,1,3,5,7]. P V sums over keys, so the result is the
//     same, and S's fragment is P's with no shuffle. P's hi and lo are split
//     in registers;
//   - Q: one TMA load per work tile, which is Q hi; each consumer
//     warpgroup keeps the lo of its 64 rows in registers, the A operand
//     of lo*hi (shared memory has no room for a Q lo tile);
//   - 32-key K/V tiles in a ring of two stages. TMA lands K in the stage's
//     K slot (K hi) and V in its V slot; the split warps write K lo, then,
//     once P V has released the stage's V^T, write V^T hi and V^T lo (four
//     keys of one column per 16-byte store). K and V^T have barriers of
//     their own: K of tile j frees when QK^T of tile j is done, V^T when
//     its P V is, so the loads and splits of tile j+1 run under the
//     products of tile j;
//   - each consumer issues tile j's QK^T (m64n32k8) together with tile
//     j-1's P V (m64nDk8) and runs tile j's softmax (the bf16 kernel's, on
//     the same fragment layout) while P V is still on the tensor cores;
//   - epilogue: o = acc * (1 / l) stored straight from the fragment (each
//     quad of lanes writes one whole 32-byte sector of a row), m and l row
//     by row; rows past sq are not written.
// Shared memory at D = 128 (bytes): Q 65536; a stage holds K 16384, K lo
// 16384, V^T hi 16384, V^T lo 16384 and V 16384 = 81920, two stages
// 163840; 1024 to align the base to the swizzle atom and 12 mbarriers (96):
// 230496 of the 232448 a block may have. Registers of a consumer thread
// (216 of them): O 64, S 16, P hi 16, P lo 16, Q lo 64; ptxas spills about
// 100 bytes of a consumer thread and 76 of a producer's (40) at D = 128.
// What holds it back, measured on an H100 (flash_probe.py --ablate): V's
// transpose, which can start on tile j only once P V of tile j - 2 has
// freed its stage; seven split warps instead of three (one producer
// warpgroup, 56 and 224 registers, no consumer spill) took it from about
// 0.46 to 0.41 ms, spills and all. A deeper V^T ring is left.

#include "flash_sm90_common.cuh"

namespace {

constexpr int BQ = 128;  // query rows per block: two consumer warpgroups
constexpr int BK = 32;   // keys per K/V tile: one 128-byte row of V^T
constexpr int STAGES = 2;
constexpr int kProducers = 256;  // two producer warpgroups
constexpr int NT = kProducers + 256;  // + two consumer warpgroups
constexpr int kSplitThreads = kProducers - 32;  // producer warps 1-7
constexpr int kProducerRegs = 40;
// the rest of the SM's 65536 registers, a multiple of 8
constexpr int kConsumerRegs =
    (65536 - kProducers * kProducerRegs) / 256 / 8 * 8;

// Shared-memory geometry for head dim D. Every tile is made of boxes of 32
// fp32 columns (one 128-byte swizzle row) by its rows, swizzled in 8-row
// atoms of 1024 bytes; V^T is D rows of the BK = 32 keys, one box.
template <int D>
struct Geo {
  static constexpr int NBOX = D / 32;
  static constexpr int Q_BYTES = BQ * D * 4;
  static constexpr int T_BYTES = BK * D * 4;  // one K/V-sized tile
  // a stage: K (hi once split), K lo, V^T hi, V^T lo, V as loaded
  static constexpr int K_LO = T_BYTES;
  static constexpr int VT_HI = 2 * T_BYTES;
  static constexpr int VT_LO = 3 * T_BYTES;
  static constexpr int V_RAW = 4 * T_BYTES;
  static constexpr int STAGE_BYTES = 5 * T_BYTES;
  // q, q_empty; per stage raw, k_full, v_full, k_empty, v_empty
  static constexpr int BARS = 2 + 5 * STAGES;
  static constexpr int SMEM =
      1024 + Q_BYTES + STAGES * STAGE_BYTES + 8 * BARS;
  static_assert(D == 32 || D == 64 || D == 128, "D must be 32, 64 or 128");
  static_assert(SMEM <= 232448, "over the shared memory of a block");
};

// A byte offset in a tile of 128-byte rows, swizzled as TMA's 128-byte
// swizzle lays it out: the 16-byte chunk XOR the row's place in its atom.
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & 7) << 4);
}

// Makes this thread's shared-memory writes visible to the async proxy
// (wgmma, TMA) before a barrier hands them on.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The split x = hi + lo, as the tensor cores read the two parts. wgmma
// reads a .tf32 operand's fp32 bit pattern and ignores its low 13 mantissa
// bits, so hi is x itself, read as trunc(x), and lo = x - trunc(x), exact
// in fp32 and read truncated in turn: no conversion, and K and Q keep
// their loaded tiles as their hi.
__device__ __forceinline__ uint32_t tf32_hi(float x) {
  return __float_as_uint(x);
}

__device__ __forceinline__ uint32_t tf32_lo(float x) {
  return __float_as_uint(x - __uint_as_float(__float_as_uint(x) &
                                             0xFFFFE000u));
}

// wgmma m64nNk8 tf32 -> fp32, B K-major in shared memory; A K-major in
// shared memory (ss) or in registers (rs: the 4 TF32 values of a k8 A
// fragment, rows r, r + 8 and columns t, t + 4). acc = 0 overwrites D.
template <int N>
struct Tf32;

template <>
struct Tf32<32> {
  static __device__ __forceinline__ void ss(float* d, uint64_t da,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15}, "
        "%16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(acc));
  }
};

template <>
struct Tf32<64> {
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
        "%25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(acc));
  }
};

template <>
struct Tf32<128> {
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
        "%25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
        "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "
        "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
        "%61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(acc));
  }
};

// Persistent: gridDim.x blocks (at most one per SM) walk the work tiles.
template <int D>
__global__ void __launch_bounds__(NT, 1) flash_fwd_tf32_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o,
    float* __restrict__ m_out, float* __restrict__ l_out, int B, int sq,
    int sk, float scale, int causal, int causal_offset) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sS = sQ + G::Q_BYTES;  // stage s at sS + s * STAGE_BYTES
  const uint32_t bar_q = sS + STAGES * G::STAGE_BYTES;  // Q loaded
  const uint32_t bar_q_empty = bar_q + 8;  // Q read by the last QK^T
  // per stage, + 8 * stage:
  const uint32_t bar_raw = bar_q_empty + 8;  // K and V landed
  const uint32_t bar_kfull = bar_raw + 8 * STAGES;     // K hi, lo written
  const uint32_t bar_vfull = bar_kfull + 8 * STAGES;   // V^T hi, lo written
  const uint32_t bar_kempty = bar_vfull + 8 * STAGES;  // QK^T done with K
  const uint32_t bar_vempty = bar_kempty + 8 * STAGES;  // P V done with V^T

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_q_empty, 8);  // one arrival per consumer warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_raw + 8 * s, 1);
      mbar_init(bar_kfull + 8 * s, kSplitThreads);
      mbar_init(bar_vfull + 8 * s, kSplitThreads);
      mbar_init(bar_kempty + 8 * s, 8);
      mbar_init(bar_vempty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  Work wt;
  if (threadIdx.x < kProducers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      // ---- TMA: K/V tile `it` into stage it % STAGES once QK^T of tile
      // it - STAGES is done with the K slot and the split of that tile
      // with the V slot
      int it = 0;  // K/V tiles loaded so far
      int nt = 0;  // work tiles with a Q load so far
      for (int w = 0;
           work_tile<BQ, BK>(w, B, sq, sk, causal, causal_offset, wt);
           ++w) {
        if (wt.n_k == 0) continue;
        for (int j = 0; j < wt.n_k; ++j, ++it) {
          const int st = it % STAGES;
          const uint32_t stage = sS + st * G::STAGE_BYTES;
          if (it >= STAGES) {
            const uint32_t parity = (it / STAGES - 1) & 1;
            mbar_wait(bar_kempty + 8 * st, parity);
            mbar_wait(bar_vfull + 8 * st, parity);
          }
          mbar_expect_tx(bar_raw + 8 * st, 2 * G::T_BYTES);
          for (int i = 0; i < G::NBOX; ++i) {
            const uint32_t off = i * BK * 128;
            tma_load(stage + off, &tm_k, bar_raw + 8 * st, i * 32, j * BK,
                     wt.b);
            tma_load(stage + G::V_RAW + off, &tm_v, bar_raw + 8 * st,
                     i * 32, j * BK, wt.b);
          }
          if (j == 0) {
            // Q after the first K/V tile: the Q buffer frees only with the
            // last QK^T of the previous work tile
            if (nt > 0) mbar_wait(bar_q_empty, (nt - 1) & 1);
            mbar_expect_tx(bar_q, G::Q_BYTES);
            for (int i = 0; i < G::NBOX; ++i)
              tma_load(sQ + i * BQ * 128, &tm_q, bar_q, i * 32, wt.q0, wt.b);
            ++nt;
          }
        }
      }
    } else if (threadIdx.x >= 32) {
      // ---- split warps: K lo, then V to V^T hi and lo. Plain C++ accesses through `smem`, so
      // each thread's loads of a batch are in flight together; the
      // barriers' memory clobbers keep them on their side.
      const int tid = threadIdx.x - 32;
      uint8_t* const smem = smem_raw + (sS - smem_u32(smem_raw));
      int it = 0;
      for (int w = 0;
           work_tile<BQ, BK>(w, B, sq, sk, causal, causal_offset, wt);
           ++w) {
        for (int j = 0; j < wt.n_k; ++j, ++it) {
          const int st = it % STAGES;
          uint8_t* const stage = smem + st * G::STAGE_BYTES;
          mbar_wait(bar_raw + 8 * st, (it / STAGES) & 1);
          // K: 16-byte chunks at the same swizzled offsets in K and K lo
          constexpr int kChunks = G::T_BYTES / 16;
          float4* const k4 = reinterpret_cast<float4*>(stage);
          float4* const klo4 = reinterpret_cast<float4*>(stage + G::K_LO);
          for (int i0 = tid; i0 < kChunks; i0 += 4 * kSplitThreads) {
            float4 x[4];
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (i0 + u * kSplitThreads < kChunks)
                x[u] = k4[i0 + u * kSplitThreads];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int i = i0 + u * kSplitThreads;
              if (i >= kChunks) continue;
              klo4[i] = make_float4(__uint_as_float(tf32_lo(x[u].x)),
                                    __uint_as_float(tf32_lo(x[u].y)),
                                    __uint_as_float(tf32_lo(x[u].z)),
                                    __uint_as_float(tf32_lo(x[u].w)));
            }
          }
          fence_async_smem();
          mbar_arrive(bar_kfull + 8 * st);
          if (it >= STAGES)
            mbar_wait(bar_vempty + 8 * st, (it / STAGES - 1) & 1);
          // V^T row n, places 8 g + 4 h .. + 3 (16 bytes) hold keys
          // 8 g + h + {0, 2, 4, 6} of column n (the [0,2,4,6,1,3,5,7]
          // order). A warp takes gh = 2 g + h and 32 columns nb * 32 +
          // lane at a time: it reads 32 columns of four rows and writes a
          // chunk of 32 rows, both free of bank conflicts under the
          // swizzle, with each lane's part of the swizzled addresses fixed
          constexpr int kSplitWarps = kSplitThreads / 32;
          constexpr int kWarpItems = (BK / 8) * 2 * (D / 32);
          const int sw = tid / 32, sl = tid % 32;
          for (int w0 = sw; w0 < kWarpItems; w0 += 2 * kSplitWarps) {
            float x[2][4];
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              const int wi = w0 + b * kSplitWarps;
              if (wi >= kWarpItems) continue;
              const int gh = wi % 8, nb = wi / 8;
              const uint8_t* const col =
                  stage + G::V_RAW + nb * BK * 128 + (sl % 4) * 4;
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const int r = 8 * (gh / 2) + gh % 2 + 2 * u;  // key
                x[b][u] = *reinterpret_cast<const float*>(
                    col + r * 128 + (((sl / 4) ^ (r % 8)) << 4));
              }
            }
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              const int wi = w0 + b * kSplitWarps;
              if (wi >= kWarpItems) continue;
              const int gh = wi % 8, nb = wi / 8;
              const uint32_t off =
                  (nb * 32 + sl) * 128 + ((gh ^ (sl % 8)) << 4);
              uint32_t h[4], l[4];
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                h[u] = tf32_hi(x[b][u]);
                l[u] = tf32_lo(x[b][u]);
              }
              *reinterpret_cast<uint4*>(stage + G::VT_HI + off) =
                  make_uint4(h[0], h[1], h[2], h[3]);
              *reinterpret_cast<uint4*>(stage + G::VT_LO + off) =
                  make_uint4(l[0], l[1], l[2], l[3]);
            }
          }
          fence_async_smem();
          mbar_arrive(bar_vfull + 8 * st);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int cw = (threadIdx.x - kProducers) / 128;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int cq = 2 * (lane % 4);  // first column in each 8-column chunk
    const uint32_t sQw = sQ + 64 * cw * 128;  // the group's rows of a box

    float acc[D / 2], sc[BK / 2];  // O and S fragments (see Softmax)
    uint32_t qlo[D / 2];           // Q lo, A fragments of the D / 8 steps
    uint32_t ph[BK / 2], pl[BK / 2];  // P hi, lo, A fragments
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;

    // Descriptors at the start of Q, K and V^T (128-byte swizzle, 8-row
    // atoms 1024 bytes apart); the address field is the byte address / 16,
    // so it advances by offset / 16. A k8 step is 32 bytes into a row, or
    // the next box after four.
    const uint64_t dq = make_desc(sQw, 16, 1024, 1);
    const uint64_t dk = make_desc(sS, 16, 1024, 1);
    const uint64_t dvt = make_desc(sS + G::VT_HI, 16, 1024, 1);
    auto issue_s = [&](int st) {
      const uint64_t kh = dk + st * (G::STAGE_BYTES / 16);
      const uint64_t kl = kh + G::K_LO / 16;
      // the two small products first, then hi * hi
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        Tf32<BK>::ss(sc, dq + ((kk / 4) * BQ * 128 + (kk % 4) * 32) / 16,
                     kl + ((kk / 4) * BK * 128 + (kk % 4) * 32) / 16, kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        Tf32<BK>::rs(sc, &qlo[4 * kk],
                     kh + ((kk / 4) * BK * 128 + (kk % 4) * 32) / 16, 1);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        Tf32<BK>::ss(sc, dq + ((kk / 4) * BQ * 128 + (kk % 4) * 32) / 16,
                     kh + ((kk / 4) * BK * 128 + (kk % 4) * 32) / 16, 1);
      wg_commit();
    };
    // O += P V of the V^T in stage st: a k8 step is 32 bytes into its rows
    auto issue_pv = [&](int st) {
      const uint64_t vh = dvt + st * (G::STAGE_BYTES / 16);
      const uint64_t vl = vh + (G::VT_LO - G::VT_HI) / 16;
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk)
        Tf32<D>::rs(acc, &ph[4 * kk], vl + 2 * kk, 1);
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk)
        Tf32<D>::rs(acc, &pl[4 * kk], vh + 2 * kk, 1);
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk)
        Tf32<D>::rs(acc, &ph[4 * kk], vh + 2 * kk, 1);
      wg_commit();
    };
    // P's A fragment of k8 step c, keys permuted as in V^T: rows r, r + 8
    // at keys 2t (place t) and 2t + 1 (place t + 4)
    auto split_p = [&] {
#pragma unroll
      for (int c = 0; c < BK / 8; ++c) {
        const float p[4] = {sc[4 * c], sc[4 * c + 2], sc[4 * c + 1],
                            sc[4 * c + 3]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ph[4 * c + e] = tf32_hi(p[e]);
          pl[4 * c + e] = tf32_lo(p[e]);
        }
      }
    };
    // Q lo of the group's rows to registers: the A fragment of step kk
    // holds rows rl, rl + 8, columns 8 kk + t, + 4
    const float* const q = reinterpret_cast<const float*>(
        smem_raw + (sQw - smem_u32(smem_raw)));
    auto split_q = [&] {
      const int rl = 16 * warp + lane / 4;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int r = rl + 8 * (v & 1);
          const int c = 8 * kk + lane % 4 + 4 * (v >> 1);
          qlo[4 * kk + v] = tf32_lo(
              q[((c / 32) * BQ * 128 + swz(r * 128 + (c % 32) * 4)) / 4]);
        }
    };

    int it = 0;  // K/V tiles consumed so far: stage it % STAGES
    int nt = 0;  // work tiles with a Q load so far
    for (int w = 0;
         work_tile<BQ, BK>(w, B, sq, sk, causal, causal_offset, wt); ++w) {
      const int row0 = wt.q0 + 64 * cw;            // first row of the group
      const int r0 = row0 + 16 * warp + lane / 4;  // rows r0 and r0 + 8
      const int n_k = wt.n_k;
      Softmax<BK> sm(r0, row0, cq, sk, causal, causal_offset, scale);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

      if (n_k > 0) {
        mbar_wait(bar_q, nt & 1);
        split_q();
        const int st0 = it % STAGES;
        mbar_wait(bar_kfull + 8 * st0, (it / STAGES) & 1);
        reg_fence<BK / 2>(sc);
        reg_fence<D / 2>(acc);
        reg_fence<D / 2>(qlo);
        wg_fence();
        issue_s(st0);
        wg_wait<0>();
        reg_fence<BK / 2>(sc);
        if (lane == 0) {
          mbar_arrive(bar_kempty + 8 * st0);
          if (n_k == 1) mbar_arrive(bar_q_empty);
        }
        float alpha[2];
        sm.tile(sc, 0, alpha);  // O is still 0: nothing to rescale
        split_p();
        // Tile j's QK^T and tile j-1's P V are issued together; the softmax
        // of tile j runs while P V is still on the tensor cores.
        for (int j = 1; j < n_k; ++j) {
          const int g = it + j;
          const int st = g % STAGES, prev = (g - 1) % STAGES;
          mbar_wait(bar_kfull + 8 * st, (g / STAGES) & 1);
          mbar_wait(bar_vfull + 8 * prev, ((g - 1) / STAGES) & 1);
          reg_fence<BK / 2>(sc);
          reg_fence<D / 2>(acc);
          reg_fence<BK / 2>(ph);
          reg_fence<BK / 2>(pl);
          reg_fence<D / 2>(qlo);
          wg_fence();
          issue_s(st);
          issue_pv(prev);
          wg_wait<1>();  // QK^T done, P V may still run
          reg_fence<BK / 2>(sc);
          if (lane == 0) {
            mbar_arrive(bar_kempty + 8 * st);
            if (j == n_k - 1) mbar_arrive(bar_q_empty);
          }
          sm.tile(sc, j * BK, alpha);
          wg_wait<0>();
          reg_fence<D / 2>(acc);
          reg_fence<BK / 2>(ph);
          reg_fence<BK / 2>(pl);
          if (lane == 0) mbar_arrive(bar_vempty + 8 * prev);
          // alpha is exactly 1 unless the row maximum moved
          if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
            for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
          }
          split_p();
        }
        const int g = it + n_k - 1, last = g % STAGES;
        mbar_wait(bar_vfull + 8 * last, (g / STAGES) & 1);
        reg_fence<D / 2>(acc);
        reg_fence<BK / 2>(ph);
        reg_fence<BK / 2>(pl);
        wg_fence();
        issue_pv(last);
        wg_wait<0>();
        reg_fence<D / 2>(acc);
        reg_fence<BK / 2>(ph);
        reg_fence<BK / 2>(pl);
        reg_fence<D / 2>(qlo);
        if (lane == 0) mbar_arrive(bar_vempty + 8 * last);
        it += n_k;
        ++nt;

        // epilogue: o = acc / l straight to global memory, each quad of
        // lanes one 32-byte sector of a row per store
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float l = sm.l[r];
          l += __shfl_xor_sync(0xffffffffu, l, 1);
          l += __shfl_xor_sync(0xffffffffu, l, 2);
          const float inv = 1.f / (l == 0.f ? 1.f : l);
          const int row = r0 + 8 * r;
          if (row < sq) {
            float* orow = o + ((size_t)wt.b * sq + row) * D + cq;
#pragma unroll
            for (int c = 0; c < D / 8; ++c)
              *reinterpret_cast<float2*>(orow + 8 * c) = make_float2(
                  acc[4 * c + 2 * r] * inv, acc[4 * c + 2 * r + 1] * inv);
            if (lane % 4 == 0) {
              m_out[(size_t)wt.b * sq + row] = sm.m[r];
              l_out[(size_t)wt.b * sq + row] = l;
            }
          }
        }
      } else {
        // no key for any row of the tile (sq = 1 under causal_offset 1):
        // m = NEG_INF, l = 0, o = 0
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + 8 * r;
          if (row >= sq) continue;
          float* orow = o + ((size_t)wt.b * sq + row) * D + cq;
#pragma unroll
          for (int c = 0; c < D / 8; ++c)
            *reinterpret_cast<float2*>(orow + 8 * c) = make_float2(0.f, 0.f);
          if (lane % 4 == 0) {
            m_out[(size_t)wt.b * sq + row] = kNegInf;
            l_out[(size_t)wt.b * sq + row] = 0.f;
          }
        }
      }
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success), or 10000 + the
// CUresult of a failed tensor-map encode (10000 alone: no encoder). The
// kernel launches on `device`, made current for the call and then restored.
// The caller checks devices, dtypes (fp32), shapes, contiguity and 16-byte
// alignment, and allocates o, m and l (fp32).
extern "C" int hvd_flash_fwd_tf32(const void* q, const void* k, const void* v,
                                  void* o, void* m, void* l, int B, int sq,
                                  int sk, int d, int causal,
                                  int causal_offset, float scale, int device,
                                  void* stream) {
  // boxes of 32 columns (128 bytes, the 128-byte swizzle); o is stored
  // from registers, so it needs no map
  const MapLayout lay = {CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 32,
                         CU_TENSOR_MAP_SWIZZLE_128B};
  return flash_entry(
      lay, BQ, BK, 0, q, k, v, o, B, sq, sk, d, device,
      [&](auto dim, const CUtensorMap* tm) {
        constexpr int D = decltype(dim)::value;
        return launch_persistent<D>(
            flash_fwd_tf32_kernel<D>, Geo<D>::SMEM, BQ, NT, device,
            static_cast<cudaStream_t>(stream), B, sq, tm[0], tm[1], tm[2],
            static_cast<float*>(o), static_cast<float*>(m),
            static_cast<float*>(l), B, sq, sk, scale, causal, causal_offset);
      });
}
