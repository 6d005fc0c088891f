// Device code shared by kernels G (window_attention.cu) and H
// (fused_msa.cu): a wmma bf16 GEMM with a bias epilogue, and the
// window-attention core.  This was kernel B's first design (wmma 64 x 64
// tiles from plain loads, S staged through f32 shared memory); B and C
// now run the pipelined core of mma_common.cuh and a register-resident
// attention (swin_block.cu), which H's products and attention can take
// next.  Everything is in an anonymous namespace, so each source that
// includes it gets its own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {
constexpr int BM = 64, BN = 64, BK = 32;
constexpr int GEMM_THREADS = 128;  // 4 warps, 2x2 warp tiles of 32x32
constexpr int A_PAD = 8, B_PAD = 8, C_PAD = 4;

constexpr int HD = 32;      // head_dim of every Swin-T stage
constexpr int TMAX = 64;    // tokens per window held in shared memory
constexpr int ATT_THREADS = 128;

// out = bf16(a @ w + bias): a [M, K] bf16, w [K, N] bf16 row-major,
// bias [N] f32; K % 32 == 0, N % 8 == 0.
struct GemmArgs {
  const bf16* a;
  const bf16* w;
  const float* bias;
  bf16* out;
  int m, n, k;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__host__ __device__ constexpr size_t align128(size_t b) {
  return (b + 127) / 128 * 128;
}

constexpr size_t GEMM_SMEM_BYTES =
    align128((size_t)BM * (BK + A_PAD) * sizeof(bf16)) +
    align128((size_t)BK * (BN + B_PAD) * sizeof(bf16)) +
    (size_t)BM * (BN + C_PAD) * sizeof(float);

__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(GemmArgs g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int M = g.m, N = g.n, K = g.k;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  constexpr int lda = BK + A_PAD, ldb = BN + B_PAD, ldc = BN + C_PAD;
  bf16* As = reinterpret_cast<bf16*>(smem);
  const size_t a_bytes = align128((size_t)BM * lda * sizeof(bf16));
  bf16* Bs = reinterpret_cast<bf16*>(smem + a_bytes);
  float* Cs = reinterpret_cast<float*>(
      smem + a_bytes + align128((size_t)BK * ldb * sizeof(bf16)));
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK / 8; i += GEMM_THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int gm = m0 + r;
      const uint4 v = gm < M ? *reinterpret_cast<const uint4*>(
                                   g.a + (size_t)gm * K + k0 + c)
                             : zero;
      *reinterpret_cast<uint4*>(As + r * lda + c) = v;
    }
    for (int i = tid; i < BK * BN / 8; i += GEMM_THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const int gn = n0 + c;
      const uint4 v = gn < N ? *reinterpret_cast<const uint4*>(
                                   g.w + (size_t)(k0 + r) * N + gn)
                             : zero;
      *reinterpret_cast<uint4*>(Bs + r * ldb + c) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], As + (wm + i * 16) * lda + kk, lda);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], Bs + kk * ldb + wn + j * 16, ldb);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * ldc + wn + j * 16,
                              acc[i][j], ldc, wmma::mem_row_major);
  __syncthreads();

  // epilogue: 8 consecutive columns per thread and step
  for (int i = tid; i < BM * BN / 8; i += GEMM_THREADS) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    alignas(16) bf16 packed[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      packed[e] = __float2bfloat16(Cs[r * ldc + c + e] + g.bias[gn + e]);
    *reinterpret_cast<uint4*>(g.out + (size_t)gm * N + gn) =
        *reinterpret_cast<const uint4*>(packed);
  }
}


// One (window, head) of the attention core, run by a 128-thread block:
// q, k, v rows t at q + t * ld_in (HD values each), output row t at
// out + t * ld_out; bias [T, T] of this head, mask [T, T] of this window
// (or null).  4 warps, tokens padded to 64 in shared memory.  Warp w owns
// query rows [16w, 16w + 16): it computes their scores S = Q K^T with wmma
// (f32), the scaled, biased, masked softmax in f32 over the T real keys,
// rounds P to bf16, and computes P V with wmma.  Pad keys get probability
// 0; pad query rows are never written out.
__device__ __forceinline__ void attention_tile(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, int ld_in, const float* __restrict__ bias,
    const float* __restrict__ msk, bf16* __restrict__ out, int ld_out, int T,
    float scale) {
  constexpr int LDQ = HD + 8, LDS = TMAX + 4, LDP = TMAX + 8;
  __shared__ __align__(128) bf16 qs[TMAX * LDQ];
  __shared__ __align__(128) bf16 ks[TMAX * LDQ];
  __shared__ __align__(128) bf16 vs[TMAX * LDQ];
  __shared__ __align__(128) float ss[TMAX * LDS];
  __shared__ __align__(128) bf16 ps[TMAX * LDP];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < TMAX * HD / 8; i += ATT_THREADS) {
    const int t = i / (HD / 8), c = (i % (HD / 8)) * 8;
    const size_t o = (size_t)t * ld_in + c;
    const bool real = t < T;
    *reinterpret_cast<uint4*>(qs + t * LDQ + c) =
        real ? *reinterpret_cast<const uint4*>(q + o) : zero;
    *reinterpret_cast<uint4*>(ks + t * LDQ + c) =
        real ? *reinterpret_cast<const uint4*>(k + o) : zero;
    *reinterpret_cast<uint4*>(vs + t * LDQ + c) =
        real ? *reinterpret_cast<const uint4*>(v + o) : zero;
  }
  __syncthreads();

  const int r0 = warp * 16;
  {  // S rows [r0, r0 + 16) = Q K^T
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[TMAX / 16];
#pragma unroll
    for (int j = 0; j < TMAX / 16; ++j) wmma::fill_fragment(sacc[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa;
      wmma::load_matrix_sync(qa, qs + r0 * LDQ + kk, LDQ);
#pragma unroll
      for (int j = 0; j < TMAX / 16; ++j) {
        // K^T as a column-major B operand: element (k, n) = K[n][k]
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, ks + j * 16 * LDQ + kk, LDQ);
        wmma::mma_sync(sacc[j], qa, kb, sacc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < TMAX / 16; ++j)
      wmma::store_matrix_sync(ss + r0 * LDS + j * 16, sacc[j], LDS,
                              wmma::mem_row_major);
  }
  __syncwarp();

  for (int r = r0; r < r0 + 16; ++r) {
    float* srow = ss + r * LDS;
    bf16* prow = ps + r * LDP;
    if (r >= T) {
      for (int c = lane; c < TMAX; c += 32) prow[c] = __float2bfloat16(0.f);
      continue;
    }
    float m = -INFINITY;
    for (int c = lane; c < T; c += 32) {
      float v = srow[c] * scale + bias[r * T + c];
      if (msk) v += msk[r * T + c];
      srow[c] = v;
      m = fmaxf(m, v);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int c = lane; c < T; c += 32) {
      const float e = expf(srow[c] - m);
      srow[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int c = lane; c < TMAX; c += 32)
      prow[c] = __float2bfloat16(c < T ? srow[c] / sum : 0.f);
  }
  __syncwarp();

  {  // ctx rows [r0, r0 + 16) = P V, staged in this warp's rows of ss
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> cacc[HD / 16];
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) wmma::fill_fragment(cacc[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < TMAX; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, ps + r0 * LDP + kk, LDP);
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, vs + kk * LDQ + j * 16, LDQ);
        wmma::mma_sync(cacc[j], pa, vb, cacc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      wmma::store_matrix_sync(ss + r0 * LDS + j * 16, cacc[j], LDS,
                              wmma::mem_row_major);
  }
  __syncwarp();
  for (int i = lane; i < 16 * HD / 8; i += 32) {
    const int r = r0 + i / (HD / 8), c = (i % (HD / 8)) * 8;
    if (r >= T) continue;
    alignas(16) bf16 packed[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) packed[e] = __float2bfloat16(ss[r * LDS + c + e]);
    *reinterpret_cast<uint4*>(out + (size_t)r * ld_out + c) =
        *reinterpret_cast<const uint4*>(packed);
  }
}

// The attention core on the packed qkv [nW * T, 3C] of a block call, one
// block per (window, head): ctx [nW * T, C]; the mask of window w is
// mask[w % nw_img] (windows image-major).
__global__ void __launch_bounds__(ATT_THREADS)
    attention_kernel(const bf16* __restrict__ qkv,
                     const float* __restrict__ rel_bias,
                     const float* __restrict__ mask, int nw_img,
                     bf16* __restrict__ ctx, int T, int C, float scale) {
  const int w = blockIdx.x, h = blockIdx.y;
  const bf16* base = qkv + (size_t)w * T * 3 * C + h * HD;
  attention_tile(base, base + C, base + 2 * C, 3 * C,
                 rel_bias + (size_t)h * T * T,
                 mask ? mask + (size_t)(w % nw_img) * T * T : nullptr,
                 ctx + (size_t)w * T * C + h * HD, C, T, scale);
}

int launch_gemm(const GemmArgs& g, cudaStream_t stream) {
  const dim3 grid((g.n + BN - 1) / BN, (g.m + BM - 1) / BM);
  gemm_kernel<<<grid, GEMM_THREADS, GEMM_SMEM_BYTES, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace
