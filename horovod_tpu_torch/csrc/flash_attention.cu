// Flash-attention forward for fp32 inputs on Hopper (sm_90a): the SIMT
// kernel, CUDA C++ with a plain C ABI. bf16 inputs, the main path's, take
// the tensor-core kernel in flash_attention_sm90.cu.
//
// Replaces, for fp32 inputs, the Pallas TPU kernel `_flash_fwd_kernel`
// (horovod_tpu/ops/pallas/flash_attention.py:35-87, pallas_call at :122).
// Same contract: q [B, sq, D], k/v [B, sk, D] fp32 -> normalized o
// [B, sq, D] fp32, plus the fp32 online-softmax stats m (running max) and
// l (running sum) [B, sq], which ring attention uses to combine partial
// results exactly. Scale D^-0.5. The causal mask keeps
// row >= col + causal_offset (top-left aligned; offset 1 is the strict mask
// of striped ring rounds). A row with l == 0 divides by 1.
//
// Why fp32 stays off the tensor cores: their fp32 path is TF32, which keeps
// about three decimal digits, and the contract's fp32 o holds to 1e-4 of
// the fp32 reference. So the products run on the fp32 FMA pipes.
//
// Design. The TPU kernel walks a sequential grid axis over K blocks and
// carries m, l and the accumulator in VMEM scratch across grid steps. On
// Hopper nothing carries between thread blocks, so one block of 256 threads
// owns a (batch row, 64-query tile) and loops over 64-key tiles itself:
//   - the Q tile and each K/V tile are staged in shared memory;
//   - a 16x16 thread grid computes S = Q K^T as 4x4 register micro-tiles
//     (rows ty+16i, keys tx+16j, so the float4 shared loads are free of
//     bank conflicts);
//   - running m, l and the output accumulator (4 rows x D/16 columns per
//     thread) stay in fp32 registers; row max and row sum reduce over the
//     16 lanes that share a row with warp shuffles;
//   - K tiles that the causal mask empties for every row of the Q tile are
//     never loaded, and the heaviest (last) causal Q tiles launch first.
// A fully masked row (row 0 under offset 1) ends with m = NEG_INF and a
// finite o and l, since the ring combine multiplies them by beta = 0.
// Keys past sk (a ragged last tile) score -inf, so they add exactly 0.
//
// Bound at the slice shape in fp32 (B = b*h = 128, s = 1024, D = 128,
// causal): operations, 34.4 GFLOP at the 67 TFLOP/s of fp32 FMA = 0.51 ms;
// bytes, 270 MB at 3.35 TB/s = 0.08 ms. So the FMA pipes bound it. What
// this design leaves on the table: shared-memory traffic (every product
// reads both operands from shared memory), tiles staged with plain loads
// and __syncthreads, and no overlap of the next tile's loads with this
// tile's products.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // NEG_INF of the TPU kernel
constexpr int BQ = 64;             // query rows per block
constexpr int BK = 64;             // keys per tile
constexpr int NT = 256;            // 16 x 16 threads
constexpr int PAD = 4;             // keeps rows 16-byte aligned, spreads banks

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* dst, const float* x) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *reinterpret_cast<float2*>(dst) = make_float2(x[0], x[1]);
  }
}

template <int D>
constexpr size_t smem_bytes() {
  // Qs[BQ][D+PAD], Ks[BK][D+PAD], Vs[BK][D+PAD], Ps[BQ][BK+PAD], fp32
  return sizeof(float) *
         (size_t(BQ + 2 * BK) * (D + PAD) + size_t(BQ) * (BK + PAD));
}

template <int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     int B, int sq, int sk, float scale, int causal,
                     int causal_offset) {
  constexpr int RS = D + PAD;            // row stride of Qs, Ks, Vs
  constexpr int PS = BK + PAD;           // row stride of Ps
  constexpr int VEC = D >= 64 ? 4 : 2;   // output columns per vector
  constexpr int NJ = D / (16 * VEC);     // vectors per thread and row
  static_assert(D % 32 == 0 && NJ >= 1, "D must be 32, 64 or 128");

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * RS;
  float* Vs = Ks + BK * RS;
  float* Ps = Vs + BK * RS;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int nq = (sq + BQ - 1) / BQ;
  const int b = blockIdx.x % B;
  const int q0 = (nq - 1 - blockIdx.x / B) * BQ;  // last Q tiles first
  const float* qb = q + (size_t)b * sq * D;
  const float* kb = k + (size_t)b * sk * D;
  const float* vb = v + (size_t)b * sk * D;

  for (int e = tid * 4; e < BQ * D; e += NT * 4) {
    const int r = e / D, c = e % D;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < sq) x = load4(qb + (size_t)(q0 + r) * D + c);
    *reinterpret_cast<float4*>(&Qs[r * RS + c]) = x;
  }

  float m[4], l[4], acc[4][NJ][VEC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int c = 0; c < VEC; ++c) acc[i][jj][c] = 0.f;
  }

  // keys past q_last - causal_offset are masked for every row of the tile
  const int q_last = min(q0 + BQ, sq) - 1;
  const int k_end = causal ? min(sk, q_last - causal_offset + 1) : sk;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // Qs staged; last tile's readers of Ks, Vs, Ps done
    for (int e = tid * 4; e < BK * D; e += NT * 4) {
      const int r = e / D, c = e % D;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < sk) {
        kx = load4(kb + (size_t)(k0 + r) * D + c);
        vx = load4(vb + (size_t)(k0 + r) * D + c);
      }
      *reinterpret_cast<float4*>(&Ks[r * RS + c]) = kx;
      *reinterpret_cast<float4*>(&Vs[r * RS + c]) = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * RS + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * RS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (col >= sk)
          x = -INFINITY;  // ragged last tile: contributes exactly 0
        else if (causal && row < col + causal_offset)
          x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps += p;
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int c = 0; c < VEC; ++c) acc[i][jj][c] *= alpha;
    }
    __syncthreads();  // Ps complete

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * PS + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = Vs + (kk + u) * RS + tx * VEC;
        float vv[NJ][VEC];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          if constexpr (VEC == 4) {
            const float4 t =
                *reinterpret_cast<const float4*>(vrow + 16 * VEC * jj);
            vv[jj][0] = t.x;
            vv[jj][1] = t.y;
            vv[jj][2] = t.z;
            vv[jj][3] = t.w;
          } else {
            const float2 t =
                *reinterpret_cast<const float2*>(vrow + 16 * VEC * jj);
            vv[jj][0] = t.x;
            vv[jj][1] = t.y;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pv[i].x
                          : u == 1 ? pv[i].y
                          : u == 2 ? pv[i].z
                                   : pv[i].w;
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
            for (int c = 0; c < VEC; ++c)
              acc[i][jj][c] = fmaf(p, vv[jj][c], acc[i][jj][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    float* orow = o + ((size_t)b * sq + row) * D + tx * VEC;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      float x[VEC];
#pragma unroll
      for (int c = 0; c < VEC; ++c) x[c] = acc[i][jj][c] / denom;
      store_vec<VEC>(orow + 16 * VEC * jj, x);
    }
    if (tx == 0) {
      m_out[(size_t)b * sq + row] = m[i];
      l_out[(size_t)b * sq + row] = l[i];
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* m, void* l, int B, int sq, int sk, float scale,
                   int causal, int causal_offset, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int nq = (sq + BQ - 1) / BQ;
  flash_fwd_kernel<D><<<dim3(nq * B), dim3(NT), smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(l), B, sq, sk, scale,
      causal, causal_offset);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). The kernel launches
// on `device`, made current for the call and then restored. The caller
// checks devices, dtypes (fp32), shapes, contiguity and 16-byte alignment,
// and allocates o and the fp32 m, l.
extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* m, void* l, int B, int sq, int sk,
                             int d, int causal, int causal_offset,
                             float scale, int device, void* stream) {
  if (B <= 0 || sq <= 0 || sk <= 0) return (int)cudaErrorInvalidValue;
  if (d != 32 && d != 64 && d != 128) return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      err = launch<32>(q, k, v, o, m, l, B, sq, sk, scale, causal,
                       causal_offset, st);
      break;
    case 64:
      err = launch<64>(q, k, v, o, m, l, B, sq, sk, scale, causal,
                       causal_offset, st);
      break;
    default:
      err = launch<128>(q, k, v, o, m, l, B, sq, sk, scale, causal,
                        causal_offset, st);
      break;
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}
