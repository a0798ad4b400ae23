// Flash-attention forward for Hopper (sm_90a) on the bf16 tensor cores:
// wgmma, TMA and an mbarrier pipeline. CUDA C++ with a plain C ABI.
//
// Replaces, for bf16 inputs, the Pallas TPU kernel `_flash_fwd_kernel`
// (horovod_tpu/ops/pallas/flash_attention.py:35-87, pallas_call at :122).
// fp32 inputs take flash_attention_tf32.cu. Contract: q
// [B, sq, D], k/v [B, sk, D] bf16, D in {32, 64, 128} -> normalized o
// [B, sq, D] bf16 plus the fp32 running max m and running sum l [B, sq].
// Scale D^-0.5. S = Q K^T accumulates in fp32; p is rounded to bf16 before
// P V (the TPU kernel's p.astype(v.dtype)); l sums the unrounded fp32 p;
// o = acc / l, dividing by 1 where l == 0. The causal mask keeps
// row >= col + causal_offset, and masked scores take the finite
// NEG_INF = -1e30, so a row the mask empties (row 0 under offset 1) ends
// with m = NEG_INF and a finite o and l. Keys past a ragged sk score -inf
// and add exactly 0. K tiles that the mask empties for every row of the Q
// tile are never loaded.
//
// Bound at the slice shape (B = b*h = 128, s = 1024, D = 128, causal):
// 135 MB of q, k, v, o, m and l at 3.35 TB/s = 40 us; 34.4 GFLOP of the two
// products over the kept pairs at 989 TFLOP/s = 35 us. So bytes bound it,
// with the products just below. In practice neither does: measured on an
// H100, the consumers' chain of products, softmax and bookkeeping is the
// limit (a variant that loads everything and computes nothing takes 60 % of
// the kernel's time; one that loads half the K/V bytes is no faster). The
// design therefore keeps the tensor cores fed and the consumers' instruction
// count low:
//   - persistent: at most one block per SM (230 KB of shared memory at
//     D = 128), 384 threads in three warpgroups. Warpgroup 0 is the
//     producer: one thread issues the TMA loads, and the warpgroup gives its
//     registers to the consumers (setmaxnreg 24 / 240). Warpgroups 1 and 2
//     each own 64 query rows of a 128-row Q tile. Blocks walk pairs of Q
//     tiles (t, nq-1-t) of one batch row (see work_tile), which weigh the
//     same under the causal mask and keep a few batch rows' K/V in L2;
//   - Q is loaded by TMA per work tile; 128-key K and V tiles stream through
//     a ring of three shared-memory stages, each with a "full" mbarrier (TMA
//     complete_tx) and an "empty" one (one arrival per consumer warp) that
//     the producer waits on before it reuses the stage, so the next work
//     tile's Q and K/V load while the consumers finish the current one. The
//     tensor maps are 3-D {D, s, B}: a box past row s of a batch row reads
//     zeros, never the next batch row. Rows of 128 bytes use the 128-byte
//     swizzle (D = 128 loads as two 64-column boxes), D = 32 the 64-byte one;
//   - S = Q K^T: wgmma m64n128k16, both operands K-major in shared memory;
//   - O += P V: wgmma m64nDk16 with P as the A operand straight from
//     registers (the fp32 S fragment packs to the bf16 A fragment in place)
//     and V as an MN-major B operand (transposed descriptor);
//   - each consumer issues tile j's QK^T together with tile j-1's P V and
//     runs tile j's softmax while P V is still on the tensor cores;
//   - online softmax on the fragment: exp2 on the special-function unit with
//     scale * log2 e folded into one FMA, rows reduced over the 4 lanes that
//     share them, the mask (one compare per score) only on tiles that cross
//     the diagonal or the ragged end, the O rescale skipped when no row
//     maximum of the warp moved (alpha is then exactly 1);
//   - epilogue: o = acc * (1 / l) goes through a swizzled shared-memory tile
//     to a TMA store, which clips rows past sq, so a ragged last Q tile never
//     writes into the next batch row; m and l are stored row by row.
// Left on the table: the two consumer warpgroups are not ordered against
// each other (FA3's ping-pong), and on a diagonal tile the first warpgroup
// computes the key half that the mask empties for all its rows.

#include "flash_sm90_common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int BQ = 128;     // query rows per block: two consumer warpgroups
constexpr int BK = 128;     // keys per K/V tile
constexpr int STAGES = 3;   // K/V ring depth
constexpr int NT = 384;     // producer warpgroup + two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Shared-memory geometry for head dim D. A TMA box is at most one swizzle
// row wide (128 bytes, or 64 for D = 32), so a tile is NBOX boxes side by
// side, each [rows][ROWB bytes], swizzled in 8-row atoms.
template <int D>
struct Geo {
  static constexpr int BOXC = D >= 64 ? 64 : 32;  // columns per box
  static constexpr int ROWB = BOXC * 2;           // bytes per box row
  static constexpr int NBOX = D / BOXC;
  static constexpr uint64_t LAYOUT = D >= 64 ? 1 : 2;  // wgmma: 128B, 64B
  // the swizzle XORs the 16-byte chunk with these bits of (offset >> 7)
  static constexpr uint32_t SWZ = D >= 64 ? 7 : 3;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;     // one K or V tile
  static constexpr int BARS = 2 + 2 * STAGES;  // q, q_empty, full, empty
  // +1024: the dynamic base is re-aligned to the swizzle atom
  static constexpr int SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARS;
  static_assert(D == 32 || D == 64 || D == 128, "D must be 32, 64 or 128");
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma m64nNk16 bf16 -> fp32; ss only at N = BK, rs at N = D
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  // D[64 x 32] (+)= A[64 x 16] B[16 x 32]: A in registers (bf16
  // pairs), B MN-major in shared memory (transposed-B descriptor)
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(acc));
  }
};

template <>
struct Wgmma<64> {
  // D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A in registers (bf16
  // pairs), B MN-major in shared memory (transposed-B descriptor)
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
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
struct Wgmma<128> {
  // D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A and B K-major in shared
  // memory; acc = 0 overwrites D
  static __device__ __forceinline__ void ss(float* d, uint64_t da,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
        : "l"(da), "l"(db), "r"(acc));
  }
  // D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A in registers (bf16
  // pairs), B MN-major in shared memory (transposed-B descriptor)
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
// While the consumers finish a tile, the producer already loads the next
// tile's Q (once the consumers' last QK^T released it) and K/V.
template <int D>
__global__ void __launch_bounds__(NT, 1) flash_fwd_sm90_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_o, __nv_bfloat16* __restrict__ o,
    float* __restrict__ m_out, float* __restrict__ l_out, int B, int sq,
    int sk, float scale, int causal, int causal_offset) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + G::Q_BYTES;
  const uint32_t sV = sK + STAGES * G::KV_BYTES;
  const uint32_t bar_q = sV + STAGES * G::KV_BYTES;  // Q loaded
  const uint32_t bar_q_empty = bar_q + 8;             // Q read by the last QK^T
  const uint32_t bar_full = bar_q_empty + 8;          // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * STAGES;   // + 8 * stage

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_q_empty, 8);  // one arrival per consumer warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  Work wt;
  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the TMA loads in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int it = 0;  // K/V tiles loaded so far: stage it % STAGES
      int nt = 0;  // work tiles with a Q load so far
      for (int w = 0;
           work_tile<BQ, BK>(w, B, sq, sk, causal, causal_offset, wt);
           ++w) {
        if (wt.n_k == 0) continue;
        for (int j = 0; j < wt.n_k; ++j, ++it) {
          const int st = it % STAGES;
          // wait until both consumer warpgroups released the stage
          if (it >= STAGES)
            mbar_wait(bar_empty + 8 * st, (it / STAGES - 1) & 1);
          mbar_expect_tx(bar_full + 8 * st, 2 * G::KV_BYTES);
          for (int i = 0; i < G::NBOX; ++i) {
            const uint32_t off = st * G::KV_BYTES + i * BK * G::ROWB;
            tma_load(sK + off, &tm_k, bar_full + 8 * st, i * G::BOXC, j * BK,
                     wt.b);
            tma_load(sV + off, &tm_v, bar_full + 8 * st, i * G::BOXC, j * BK,
                     wt.b);
          }
          if (j == 0) {
            // Q after the first K/V tile: the Q buffer frees only with the
            // last QK^T of the previous work tile, after a stage does
            if (nt > 0) mbar_wait(bar_q_empty, (nt - 1) & 1);
            mbar_expect_tx(bar_q, G::Q_BYTES);
            for (int i = 0; i < G::NBOX; ++i)
              tma_load(sQ + i * BQ * G::ROWB, &tm_q, bar_q, i * G::BOXC,
                       wt.q0, wt.b);
            ++nt;
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int cw = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int cq = 2 * (lane % 4);  // first column in each 8-column chunk
    const uint32_t sQw = sQ + 64 * cw * G::ROWB;

    float acc[D / 2], sc[BK / 2];  // O and S fragments (see Softmax)
    uint32_t pa[BK / 4];            // P, bf16 pairs in A-fragment order
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;

    // Descriptors at the start of Q, K and V; a descriptor's address field
    // is the byte address / 16, so it advances by offset / 16 (smem is
    // below 2^18 bytes: no carry leaves the field).
    const uint64_t dq = make_desc(sQw, 16, 8 * G::ROWB, G::LAYOUT);
    const uint64_t dk = make_desc(sK, 16, 8 * G::ROWB, G::LAYOUT);
    const uint64_t dv = make_desc(sV, BK * G::ROWB, 8 * G::ROWB, G::LAYOUT);
    // S = Q K^T of the K tile in stage st: D / 16 k16 steps, both operands
    // K-major; a step is 32 bytes into a swizzled row, or the next box
    auto issue_s = [&](int st) {
      const uint64_t dks = dk + st * (G::KV_BYTES / 16);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t box = kk * 16 / G::BOXC, col = kk * 16 % G::BOXC;
        Wgmma<BK>::ss(sc, dq + (box * BQ * G::ROWB + col * 2) / 16,
                      dks + (box * BK * G::ROWB + col * 2) / 16, kk > 0);
      }
      wg_commit();
    };
    // O += P V of the V tile in stage st, V MN-major: a k16 step is 16 rows
    // of the tile; the second 64-column box (D = 128) lies BK rows on
    auto issue_pv = [&](int st) {
      const uint64_t dvs = dv + st * (G::KV_BYTES / 16);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<D>::rs(acc, &pa[4 * kk], dvs + kk * 16 * G::ROWB / 16, 1);
      wg_commit();
    };
    // the fp32 fragment of two 8-column chunks of P is the bf16 A fragment
    // of one k16 step, so P never leaves the registers
    auto pack_p = [&] {
#pragma unroll
      for (int i = 0; i < BK / 4; ++i)
        pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
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
        mbar_wait(bar_full + 8 * (it % STAGES), (it / STAGES) & 1);
        reg_fence<BK / 2>(sc);
        reg_fence<D / 2>(acc);
        wg_fence();
        issue_s(it % STAGES);
        wg_wait<0>();
        reg_fence<BK / 2>(sc);
        if (n_k == 1 && lane == 0) mbar_arrive(bar_q_empty);
        float alpha[2];
        sm.tile(sc, 0, alpha);  // O is still 0: nothing to rescale
        pack_p();
        // Tile j's QK^T and tile j-1's P V are issued together; the softmax
        // of tile j runs while P V is still on the tensor cores.
        for (int j = 1; j < n_k; ++j) {
          const int st = (it + j) % STAGES, prev = (it + j - 1) % STAGES;
          mbar_wait(bar_full + 8 * st, ((it + j) / STAGES) & 1);
          reg_fence<BK / 2>(sc);
          reg_fence<D / 2>(acc);
          reg_fence<BK / 4>(pa);
          wg_fence();
          issue_s(st);
          issue_pv(prev);
          wg_wait<1>();  // QK^T done, P V may still run
          reg_fence<BK / 2>(sc);
          if (j == n_k - 1 && lane == 0) mbar_arrive(bar_q_empty);
          sm.tile(sc, j * BK, alpha);
          wg_wait<0>();
          reg_fence<D / 2>(acc);
          if (lane == 0) mbar_arrive(bar_empty + 8 * prev);
          // alpha is exactly 1 unless the row maximum moved
          if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
            for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
          }
          pack_p();
        }
        const int last = (it + n_k - 1) % STAGES;
        reg_fence<D / 2>(acc);
        reg_fence<BK / 4>(pa);
        wg_fence();
        issue_pv(last);
        wg_wait<0>();
        reg_fence<D / 2>(acc);
        it += n_k;
        ++nt;

        // Epilogue through shared memory: once both warpgroups are past
        // their last P V, the last stage's K tile is free; each warpgroup
        // writes its 64 rows of o there in the TMA box layout (swizzled, so
        // the 8 rows of a store hit 8 different bank groups) and one thread
        // stores them with TMA, which clips rows past sq, then releases the
        // stage for both warpgroups' 4 warps.
        named_sync(1, 256);
        const uint32_t so = sK + last * G::KV_BYTES + 64 * cw * G::ROWB;
        const float* l_part = sm.l;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float l = l_part[r];
          l += __shfl_xor_sync(0xffffffffu, l, 1);
          l += __shfl_xor_sync(0xffffffffu, l, 2);
          const float inv = 1.f / (l == 0.f ? 1.f : l);
          const int rl = 16 * warp + lane / 4 + 8 * r;  // row in the group
#pragma unroll
          for (int c = 0; c < D / 8; ++c) {
            const int col = 8 * c + cq;
            const uint32_t off = (col / G::BOXC) * BK * G::ROWB +
                                 rl * G::ROWB + (col % G::BOXC) * 2;
            const int i = 4 * c + 2 * r;
            const uint32_t v = pack_bf16(acc[i] * inv, acc[i + 1] * inv);
            asm volatile("st.shared.b32 [%0], %1;" ::"r"(
                             so + (off ^ (((off >> 7) & G::SWZ) << 4))),
                         "r"(v)
                         : "memory");
          }
          const int row = row0 + rl;
          if (lane % 4 == 0 && row < sq) {
            m_out[(size_t)wt.b * sq + row] = sm.m[r];
            l_out[(size_t)wt.b * sq + row] = l;
          }
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        named_sync(2 + cw, 128);
        if (t == 0) {
          for (int i = 0; i < G::NBOX; ++i)
            tma_store(&tm_o, so + i * BK * G::ROWB, i * G::BOXC, row0, wt.b);
          asm volatile("cp.async.bulk.commit_group;" ::: "memory");
          asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
          mbar_arrive(bar_empty + 8 * last, 4);
        }
      } else {
        // no key for any row of the tile (sq = 1 under causal_offset 1):
        // m = NEG_INF, l = 0, o = 0
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + 8 * r;
          if (row >= sq) continue;
          __nv_bfloat16* orow = o + ((size_t)wt.b * sq + row) * D + cq;
#pragma unroll
          for (int c = 0; c < D / 8; ++c)
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
                __floats2bfloat162_rn(0.f, 0.f);
          if (lane % 4 == 0) {
            m_out[(size_t)wt.b * sq + row] = kNegInf;
            l_out[(size_t)wt.b * sq + row] = 0.f;
          }
        }
      }
    }
    // the last o stores must land before the block exits
    if (t == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success), or 10000 + the
// CUresult of a failed tensor-map encode (10000 alone: no encoder). The
// kernel launches on `device`, made current for the call and then restored.
// The caller checks devices, dtypes (bf16), shapes, contiguity and 16-byte
// alignment, and allocates o (bf16) and the fp32 m, l.
extern "C" int hvd_flash_fwd_sm90(const void* q, const void* k, const void* v,
                                  void* o, void* m, void* l, int B, int sq,
                                  int sk, int d, int causal,
                                  int causal_offset, float scale, int device,
                                  void* stream) {
  // boxes of one swizzle row; o is stored by TMA, 64 rows per warpgroup
  const MapLayout lay = {
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, d >= 64 ? 64 : 32,
      d >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B};
  return flash_entry(
      lay, BQ, BK, BQ / 2, q, k, v, o, B, sq, sk, d, device,
      [&](auto dim, const CUtensorMap* tm) {
        constexpr int D = decltype(dim)::value;
        return launch_persistent<D>(
            flash_fwd_sm90_kernel<D>, Geo<D>::SMEM, BQ, NT, device,
            static_cast<cudaStream_t>(stream), B, sq, tm[0], tm[1], tm[2],
            tm[3], static_cast<__nv_bfloat16*>(o), static_cast<float*>(m),
            static_cast<float*>(l), B, sq, sk, scale, causal, causal_offset);
      });
}
