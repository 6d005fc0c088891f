// Training Swin block backward (kernel D).
//
// Replaces the TPU kernel swinvox_tpu/ops/pallas_swin_block.py:
// _swin_block_train_bwd_kernel (through `fused_swin_block_train`).  Given
// dout [nW*T, C] and what kernel C (swin_block.cu) saved — the bf16 LN1
// and LN2 outputs h1, h2 with their row mean and 1/std, qkv, ctx, f32 x2,
// the f32 pre-GELU values `pre` and the bf16 GELU output `hidden` — it
// computes, with per-window drop-path factors dp1, dp2 (T rows a window):
//
//   dmlp  = bf16(dout * dp2)               db2 = sum(dout * dp2)
//   dW2   = hidden^T dmlp
//   dm1   = bf16((dmlp W2^T) * gelu'(pre))  db1 = sum(dm1)
//   dW1   = h2^T dm1
//   dh2   = dm1 W1^T                        (f32)
//   dx2   = dout + LN2'(dh2)                dln2 scale/bias = sums
//   dattn = bf16(dx2 * dp1)                 dbproj = sum(dx2 * dp1)
//   dWproj = ctx^T dattn
//   dctx  = bf16(dattn Wproj^T)
//   per (window, head): recompute P = softmax(q k^T * s + bias (+mask)),
//     dP = dctx v^T, dV = bf16(P)^T dctx, dS = P * (dP - rowsum(dP * P)),
//     drel_bias += dS, dQ = bf16(dS * s) k, dK = bf16(dS * s)^T q
//   dbqkv = sum(dqkv)                       dWqkv = h1^T dqkv
//   dh1   = dqkv Wqkv^T                     (f32)
//   dx    = bf16(dx2 + LN1'(dh1))           dln1 scale/bias = sums
//
// with the TPU kernel's rounding points (bf16 GEMM operands, f32
// accumulation, f32 LayerNorm and softmax backward, exact erf GELU').
// A factor of 0 zeroes a branch's gradient, never the residual path's.
//
// Launches (about 25 per block call, one stream, no atomics):
//   gemm_nt      input grads dY W^T: wmma bf16 16x16x16, f32 accumulate,
//                64x64 tiles (the W operand read as a column-major B);
//                epilogues: f32 out, bf16 out, or x gelu'(pre) -> bf16
//   gemm_tn      weight grads A^T dY: the M = nW*T rows split over blocks,
//                each writing a 64x64 f32 partial; reduce_partials sums
//                them in a fixed order and rounds to the weight's bf16
//   colsum       per-block column sums (bias grads), reduced the same way
//   ln_bwd       one warp per row: LayerNorm backward plus the residual,
//                column partials for dscale and dbias
//   attn_bwd     one block per (window group, head): 4 warps, tokens
//                padded to 64 in shared memory (pad rows and columns zero,
//                pad keys probability 0), wmma products, dS accumulated
//                over the group's windows into a dbias partial
//
// Work at batch 32: the 12 calls of a training step do ~555 GFLOP (twice
// the forward's) and read and write ~2.2 GB (tokens x C halves from stage
// to stage, 9.63 M at stage 0).  Like kernel B this simple version is
// bound by its own issue rate (no copy pipeline, one 64x64 tile per
// 128-thread block), not by the card's 989 TFLOP/s or 3.35 TB/s.
//
// The C entry point returns the first nonzero cudaGetLastError() of its
// launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int THREADS = 128;  // 4 warps, 2x2 warp tiles of 32x32
constexpr int PADH = 8, PADF = 4;

constexpr int HD = 32;
constexpr int TMAX = 64;
constexpr int ATT_THREADS = 128;

constexpr int LN_WARPS = 8;
constexpr int LN_ROWS = 64;  // rows per ln_bwd block
constexpr int LN_MAXCPL = 24;  // C / 32 up to 768
constexpr int COLSUM_ROWS = 256;

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

__device__ __forceinline__ float dgelu(float m) {
  // d/dm [m * Phi(m)] = Phi(m) + m * phi(m)
  const float cdf = 0.5f * (1.f + erff(m * 0.7071067811865476f));
  return cdf + m * 0.3989422804014327f * expf(-0.5f * m * m);
}

__device__ __forceinline__ void store8_bf16(bf16* dst, const float* v) {
  alignas(16) bf16 p[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) p[e] = __float2bfloat16(v[e]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(p);
}

// ------------------------------------------------------------- gemm_nt
// C[M,N] = A[M,K] W^T, W stored [N, K] row-major (the forward weight
// [in = N, out = K]).  K % 32 == 0, N % 8 == 0.
enum NtEpi { NT_F32 = 0, NT_BF16 = 1, NT_DGELU = 2 };

struct NtArgs {
  const bf16* a;
  const bf16* w;
  const float* pre;  // NT_DGELU: [M, N]
  void* out;
  int m, n, k;
};

constexpr int NT_LDA = BK + PADH, NT_LDB = BK + PADH, NT_LDC = BN + PADF;

template <int EPI>
__global__ void __launch_bounds__(THREADS) swin_bwd_gemm_nt_kernel(NtArgs g) {
  __shared__ __align__(128) bf16 As[BM * NT_LDA];
  __shared__ __align__(128) bf16 Bs[BN * NT_LDB];
  __shared__ __align__(128) float Cs[BM * NT_LDC];
  const int M = g.m, N = g.n, K = g.k;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK / 8; i += THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int gm = m0 + r;
      *reinterpret_cast<uint4*>(As + r * NT_LDA + c) =
          gm < M ? *reinterpret_cast<const uint4*>(g.a + (size_t)gm * K + k0 +
                                                   c)
                 : zero;
    }
    for (int i = tid; i < BN * BK / 8; i += THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int gn = n0 + r;
      *reinterpret_cast<uint4*>(Bs + r * NT_LDB + c) =
          gn < N ? *reinterpret_cast<const uint4*>(g.w + (size_t)gn * K + k0 +
                                                   c)
                 : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], As + (wm + i * 16) * NT_LDA + kk,
                               NT_LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)  // element (k, n) at Bs[n * ld + k]
        wmma::load_matrix_sync(bfr[j], Bs + (wn + j * 16) * NT_LDB + kk,
                               NT_LDB);
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
      wmma::store_matrix_sync(Cs + (wm + i * 16) * NT_LDC + wn + j * 16,
                              acc[i][j], NT_LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN / 8; i += THREADS) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    const size_t o = (size_t)gm * N + gn;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = Cs[r * NT_LDC + c + e];
    if (EPI == NT_F32) {
      float4* dst = reinterpret_cast<float4*>(static_cast<float*>(g.out) + o);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      if (EPI == NT_DGELU) {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] *= dgelu(g.pre[o + e]);
      }
      store8_bf16(static_cast<bf16*>(g.out) + o, v);
    }
  }
}

// ------------------------------------------------------------- gemm_tn
// partial[s][i][j] = sum over rows m of split s of A[m][i] * D[m][j];
// A [M, KA], D [M, N] bf16 row-major, KA % 8 == 0, N % 8 == 0.
struct TnArgs {
  const bf16* a;
  const bf16* d;
  float* partial;  // [splits, KA, N]
  int m, ka, n, split_rows;
};

constexpr int TN_LDA = BM + PADH, TN_LDB = BN + PADH, TN_LDC = BN + PADF;

__global__ void __launch_bounds__(THREADS) swin_bwd_gemm_tn_kernel(TnArgs g) {
  __shared__ __align__(128) bf16 As[BK * TN_LDA];  // [m][i]
  __shared__ __align__(128) bf16 Bs[BK * TN_LDB];  // [m][j]
  __shared__ __align__(128) float Cs[BM * TN_LDC];
  const int KA = g.ka, N = g.n;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const int mb = blockIdx.z * g.split_rows;
  const int me = min(g.m, mb + g.split_rows);
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int m0 = mb; m0 < me; m0 += BK) {
    for (int i = tid; i < BK * BM / 8; i += THREADS) {
      const int r = i / (BM / 8), c = (i % (BM / 8)) * 8;
      const int gm = m0 + r, gi = i0 + c;
      *reinterpret_cast<uint4*>(As + r * TN_LDA + c) =
          (gm < me && gi < KA)
              ? *reinterpret_cast<const uint4*>(g.a + (size_t)gm * KA + gi)
              : zero;
    }
    for (int i = tid; i < BK * BN / 8; i += THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const int gm = m0 + r, gj = j0 + c;
      *reinterpret_cast<uint4*>(Bs + r * TN_LDB + c) =
          (gm < me && gj < N)
              ? *reinterpret_cast<const uint4*>(g.d + (size_t)gm * N + gj)
              : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)  // element (i, m) at As[m * ld + i]
        wmma::load_matrix_sync(af[i], As + kk * TN_LDA + wm + i * 16, TN_LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], Bs + kk * TN_LDB + wn + j * 16, TN_LDB);
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
      wmma::store_matrix_sync(Cs + (wm + i * 16) * TN_LDC + wn + j * 16,
                              acc[i][j], TN_LDC, wmma::mem_row_major);
  __syncthreads();
  float* part = g.partial + (size_t)blockIdx.z * KA * N;
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int gi = i0 + r, gj = j0 + c;
    if (gi < KA && gj < N) part[(size_t)gi * N + gj] = Cs[r * TN_LDC + c];
  }
}

// out[i] = sum_s partial[s * stride + i] for i < n, in order, as f32 or
// rounded to bf16.
__global__ void swin_bwd_reduce_partials_kernel(
    const float* __restrict__ partial,
                                       int splits, long long stride,
                                       long long n, void* out, int to_bf16) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += partial[(size_t)k * stride + i];
    if (to_bf16)
      static_cast<bf16*>(out)[i] = __float2bfloat16(s);
    else
      static_cast<float*>(out)[i] = s;
  }
}

// partial[blk][c] = sum over the block's rows of src[r][c] (x dp[r / T]).
__global__ void swin_bwd_colsum_kernel(const bf16* __restrict__ src, int M,
                                       int N,
                              const float* __restrict__ dp, int tokens,
                              float* __restrict__ partial) {
  const int r0 = blockIdx.x * COLSUM_ROWS;
  const int r1 = min(M, r0 + COLSUM_ROWS);
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    float s = 0.f;
    for (int r = r0; r < r1; ++r) {
      const float v = __bfloat162float(src[(size_t)r * N + c]);
      s += dp ? v * dp[r / tokens] : v;
    }
    partial[(size_t)blockIdx.x * N + c] = s;
  }
}

// out = bf16(in * dp[row / T]), 8 values a thread.
__global__ void swin_bwd_scale_rows_kernel(const bf16* __restrict__ in,
                                  const float* __restrict__ dp, int tokens,
                                  int C, long long n8,
                                  bf16* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n8;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e0 = i * 8;
    const float f = dp[(e0 / C) / tokens];
    const uint4 raw = *reinterpret_cast<const uint4*>(in + e0);
    const bf16* h = reinterpret_cast<const bf16*>(&raw);
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(h[e]) * f;
    store8_bf16(out + e0, v);
  }
}

// ------------------------------------------------------------- ln_bwd
// One warp per row r: xhat = (x - mean) * rstd, g = dh * scale,
// d = rstd * (g - mean(g) - xhat * mean(g * xhat)), total = res + d.
// LN2 mode (dp != null): writes total to out_f32 (dx2) and
// bf16(total * dp) to out_bf16 (dattn); partial 2 sums total * dp.
// LN1 mode: writes bf16(total) to out_bf16 (dx).
// Partials [blocks][3][C]: sum dh * xhat, sum dh, (LN2) sum total * dp.
template <typename TX, typename TR>
__global__ void __launch_bounds__(LN_WARPS * 32)
    swin_bwd_ln_bwd_kernel(const float* __restrict__ dh,
                           const TX* __restrict__ x,
                  const float* __restrict__ stats,
                  const float* __restrict__ scale, const TR* __restrict__ res,
                  const float* __restrict__ dp, int tokens, int M, int C,
                  float* __restrict__ out_f32, bf16* __restrict__ out_bf16,
                  float* __restrict__ partial) {
  __shared__ float red[3][LN_MAXCPL * 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cpl = C / 32;
  for (int i = threadIdx.x; i < 3 * C; i += blockDim.x)
    red[i / C][i % C] = 0.f;
  float a0[LN_MAXCPL], a1[LN_MAXCPL], a2[LN_MAXCPL];
#pragma unroll
  for (int j = 0; j < LN_MAXCPL; ++j) a0[j] = a1[j] = a2[j] = 0.f;

  const int rb = blockIdx.x * LN_ROWS;
  for (int r = rb + warp; r < min(M, rb + LN_ROWS); r += LN_WARPS) {
    const float mu = stats[2 * (size_t)r], rs = stats[2 * (size_t)r + 1];
    float xh[LN_MAXCPL], gg[LN_MAXCPL];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < LN_MAXCPL; ++j) {
      if (j < cpl) {
        const int c = lane + 32 * j;
        const size_t o = (size_t)r * C + c;
        const float d = dh[o];
        float xv;
        if constexpr (sizeof(TX) == 2) xv = __bfloat162float(x[o]);
        else xv = x[o];
        xh[j] = (xv - mu) * rs;
        gg[j] = d * scale[c];
        s1 += gg[j];
        s2 += gg[j] * xh[j];
        a0[j] += d * xh[j];
        a1[j] += d;
      }
    }
    const float m1 = warp_sum(s1) / (float)C, m2 = warp_sum(s2) / (float)C;
    const float f = dp ? dp[r / tokens] : 1.f;
#pragma unroll
    for (int j = 0; j < LN_MAXCPL; ++j) {
      if (j < cpl) {
        const int c = lane + 32 * j;
        const size_t o = (size_t)r * C + c;
        float rv;
        if constexpr (sizeof(TR) == 2) rv = __bfloat162float(res[o]);
        else rv = res[o];
        const float t = rv + rs * (gg[j] - m1 - xh[j] * m2);
        if (dp) {
          out_f32[o] = t;
          out_bf16[o] = __float2bfloat16(t * f);
          a2[j] += t * f;
        } else {
          out_bf16[o] = __float2bfloat16(t);
        }
      }
    }
  }
  __syncthreads();
  for (int w = 0; w < LN_WARPS; ++w) {  // fixed order: deterministic
    if (warp == w) {
#pragma unroll
      for (int j = 0; j < LN_MAXCPL; ++j) {
        if (j < cpl) {
          const int c = lane + 32 * j;
          red[0][c] += a0[j];
          red[1][c] += a1[j];
          red[2][c] += a2[j];
        }
      }
    }
    __syncthreads();
  }
  float* part = partial + (size_t)blockIdx.x * 3 * C;
  for (int i = threadIdx.x; i < 3 * C; i += blockDim.x)
    part[i] = red[i / C][i % C];
}

// ------------------------------------------------------------ attn_bwd
constexpr int LDQ = HD + 8, LDS = TMAX + 4, LDP = TMAX + 8;
constexpr size_t ATT_SMEM =
    4 * sizeof(bf16) * TMAX * LDQ +      // q, k, v, dctx
    2 * sizeof(float) * TMAX * LDS +     // P (f32), dP / staging
    2 * sizeof(bf16) * TMAX * LDP +      // P (bf16), dS (bf16)
    sizeof(float) * TMAX * TMAX;         // dbias accumulator

// Stages rows [r0, r0 + 16) of a [64 x 32] wmma product (acc) through
// this warp's rows of `stage` and writes the real rows as bf16 to dqkv
// at column `col` (row stride 3C).
__device__ __forceinline__ void emit_rows(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[HD / 16],
    float* stage, int r0, int lane, int T, bf16* dqkv, size_t row0,
    int C3, int col) {
#pragma unroll
  for (int j = 0; j < HD / 16; ++j)
    wmma::store_matrix_sync(stage + r0 * LDS + j * 16, acc[j], LDS,
                            wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * HD / 8; i += 32) {
    const int r = r0 + i / (HD / 8), c = (i % (HD / 8)) * 8;
    if (r >= T) continue;
    store8_bf16(dqkv + (row0 + r) * C3 + col + c, stage + r * LDS + c);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(ATT_THREADS)
    swin_bwd_attn_bwd_kernel(const bf16* __restrict__ qkv,
                    const bf16* __restrict__ dctx,
                    const float* __restrict__ rel_bias,
                    const float* __restrict__ mask, int nw_img, int n_windows,
                    int T, int C, float scale, bf16* __restrict__ dqkv,
                    float* __restrict__ dbias_part) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + TMAX * LDQ;
  bf16* vs = ks + TMAX * LDQ;
  bf16* ds_ = vs + TMAX * LDQ;  // dctx
  float* ps = reinterpret_cast<float*>(ds_ + TMAX * LDQ);  // P f32
  float* dps = ps + TMAX * LDS;                            // dP, staging
  bf16* pb = reinterpret_cast<bf16*>(dps + TMAX * LDS);    // P bf16
  bf16* sb = pb + TMAX * LDP;                              // dS*scale bf16
  float* dbacc = reinterpret_cast<float*>(sb + TMAX * LDP);  // [T][T]

  const int h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, r0 = warp * 16;
  const int C3 = 3 * C;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const float* bias = rel_bias + (size_t)h * T * T;
  for (int i = tid; i < T * T; i += ATT_THREADS) dbacc[i] = 0.f;

  for (int w = blockIdx.x; w < n_windows; w += gridDim.x) {
    __syncthreads();  // the previous window's reads of the tiles are done
    const size_t row0 = (size_t)w * T;
    for (int i = tid; i < TMAX * HD / 8; i += ATT_THREADS) {
      const int t = i / (HD / 8), c = (i % (HD / 8)) * 8;
      const bool real = t < T;
      const bf16* row = qkv + (row0 + t) * C3 + h * HD + c;
      *reinterpret_cast<uint4*>(qs + t * LDQ + c) =
          real ? *reinterpret_cast<const uint4*>(row) : zero;
      *reinterpret_cast<uint4*>(ks + t * LDQ + c) =
          real ? *reinterpret_cast<const uint4*>(row + C) : zero;
      *reinterpret_cast<uint4*>(vs + t * LDQ + c) =
          real ? *reinterpret_cast<const uint4*>(row + 2 * C) : zero;
      *reinterpret_cast<uint4*>(ds_ + t * LDQ + c) =
          real ? *reinterpret_cast<const uint4*>(dctx + (row0 + t) * C +
                                                 h * HD + c)
               : zero;
    }
    __syncthreads();

    {  // S = Q K^T -> ps, dP = dctx V^T -> dps (rows [r0, r0 + 16))
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sa[TMAX / 16];
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> da[TMAX / 16];
#pragma unroll
      for (int j = 0; j < TMAX / 16; ++j) {
        wmma::fill_fragment(sa[j], 0.f);
        wmma::fill_fragment(da[j], 0.f);
      }
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ga;
        wmma::load_matrix_sync(qa, qs + r0 * LDQ + kk, LDQ);
        wmma::load_matrix_sync(ga, ds_ + r0 * LDQ + kk, LDQ);
#pragma unroll
        for (int j = 0; j < TMAX / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> vb;
          wmma::load_matrix_sync(kb, ks + j * 16 * LDQ + kk, LDQ);
          wmma::load_matrix_sync(vb, vs + j * 16 * LDQ + kk, LDQ);
          wmma::mma_sync(sa[j], qa, kb, sa[j]);
          wmma::mma_sync(da[j], ga, vb, da[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < TMAX / 16; ++j) {
        wmma::store_matrix_sync(ps + r0 * LDS + j * 16, sa[j], LDS,
                                wmma::mem_row_major);
        wmma::store_matrix_sync(dps + r0 * LDS + j * 16, da[j], LDS,
                                wmma::mem_row_major);
      }
    }
    __syncwarp();

    // softmax, then dS, per row of this warp (f32)
    const float* msk = mask ? mask + (size_t)(w % nw_img) * T * T : nullptr;
    for (int r = r0; r < r0 + 16; ++r) {
      float* srow = ps + r * LDS;
      float* drow = dps + r * LDS;
      if (r >= T) {
        for (int c = lane; c < TMAX; c += 32) {
          pb[r * LDP + c] = __float2bfloat16(0.f);
          sb[r * LDP + c] = __float2bfloat16(0.f);
        }
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
      float pd = 0.f;
      for (int c = lane; c < T; c += 32) {
        const float p = srow[c] / sum;
        srow[c] = p;
        pd += p * drow[c];
      }
      pd = warp_sum(pd);
      for (int c = lane; c < TMAX; c += 32) {
        if (c < T) {
          const float p = srow[c];
          const float ds = p * (drow[c] - pd);
          dbacc[r * T + c] += ds;
          pb[r * LDP + c] = __float2bfloat16(p);
          sb[r * LDP + c] = __float2bfloat16(ds * scale);
        } else {
          pb[r * LDP + c] = __float2bfloat16(0.f);
          sb[r * LDP + c] = __float2bfloat16(0.f);
        }
      }
    }
    __syncthreads();  // every row of pb and sb is written

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> oa[HD / 16];
    // dV rows [r0, r0 + 16) = P^T dctx: A element (j, i) = P[i][j]
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) wmma::fill_fragment(oa[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < TMAX; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> pa;
      wmma::load_matrix_sync(pa, pb + kk * LDP + r0, LDP);
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> gb;
        wmma::load_matrix_sync(gb, ds_ + kk * LDQ + j * 16, LDQ);
        wmma::mma_sync(oa[j], pa, gb, oa[j]);
      }
    }
    emit_rows(oa, dps, r0, lane, T, dqkv, row0, C3, 2 * C + h * HD);

    // dQ rows = dS_s K
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) wmma::fill_fragment(oa[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < TMAX; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> sa;
      wmma::load_matrix_sync(sa, sb + r0 * LDP + kk, LDP);
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> kb;
        wmma::load_matrix_sync(kb, ks + kk * LDQ + j * 16, LDQ);
        wmma::mma_sync(oa[j], sa, kb, oa[j]);
      }
    }
    emit_rows(oa, dps, r0, lane, T, dqkv, row0, C3, h * HD);

    // dK rows = dS_s^T Q: A element (j, i) = dS_s[i][j]
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) wmma::fill_fragment(oa[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < TMAX; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> sa;
      wmma::load_matrix_sync(sa, sb + kk * LDP + r0, LDP);
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> qb;
        wmma::load_matrix_sync(qb, qs + kk * LDQ + j * 16, LDQ);
        wmma::mma_sync(oa[j], sa, qb, oa[j]);
      }
    }
    emit_rows(oa, dps, r0, lane, T, dqkv, row0, C3, C + h * HD);
  }
  __syncthreads();
  float* part = dbias_part + ((size_t)blockIdx.x * gridDim.y + h) * T * T;
  for (int i = tid; i < T * T; i += ATT_THREADS) part[i] = dbacc[i];
}

// ------------------------------------------------------------- planning
struct Plan {
  int M, C, T, H, nw;
  int att_groups;
  size_t off[8];  // byte offsets of the scratch buffers
  size_t bytes;
};

constexpr int TARGET_BLOCKS = 528;  // 4 blocks on each of 132 SMs

int tn_splits(int M, int ka, int n, int* rows) {
  const int tiles = ((ka + BM - 1) / BM) * ((n + BN - 1) / BN);
  int splits = (TARGET_BLOCKS + tiles - 1) / tiles;
  const int most = (M + 127) / 128;
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  int r = (M + splits - 1) / splits;
  r = (r + BK - 1) / BK * BK;
  *rows = r;
  return (M + r - 1) / r;
}

size_t align256(size_t b) { return (b + 255) / 256 * 256; }

Plan plan(long long n_windows, int T, int C, int H) {
  Plan p;
  p.M = (int)(n_windows * T);
  p.C = C;
  p.T = T;
  p.H = H;
  p.nw = (int)n_windows;
  int g = TARGET_BLOCKS / H;
  if (g < 1) g = 1;
  if (g > p.nw) g = p.nw;
  p.att_groups = g;
  // the largest partial any reduction needs, in floats
  size_t part = 0;
  auto need = [&](size_t v) { part = v > part ? v : part; };
  const int shapes[4][2] = {{4 * C, C}, {C, 4 * C}, {C, C}, {C, 3 * C}};
  for (auto& s : shapes) {
    int rows;
    const int sp = tn_splits(p.M, s[0], s[1], &rows);
    need((size_t)sp * s[0] * s[1]);
  }
  need((size_t)((p.M + COLSUM_ROWS - 1) / COLSUM_ROWS) * 4 * C);
  need((size_t)((p.M + LN_ROWS - 1) / LN_ROWS) * 3 * C);
  need((size_t)g * H * T * T);
  const size_t M = p.M;
  const size_t sizes[8] = {
      M * C * 2,      // 0 dmlp bf16
      M * 4 * C * 2,  // 1 dm1 bf16
      M * C * 4,      // 2 dh f32 (dh2, then dh1)
      M * C * 4,      // 3 dx2 f32
      M * C * 2,      // 4 dattn bf16
      M * C * 2,      // 5 dctx bf16
      M * 3 * C * 2,  // 6 dqkv bf16
      part * 4,       // 7 partials f32
  };
  size_t off = 0;
  for (int i = 0; i < 8; ++i) {
    p.off[i] = off;
    off += align256(sizes[i]);
  }
  p.bytes = off;
  return p;
}

int blocks_for(long long n, int threads) {
  long long b = (n + threads - 1) / threads;
  if (b > 65535LL * 16) b = 65535LL * 16;
  return (int)(b < 1 ? 1 : b);
}

int reduce(const float* partial, int splits, long long stride, long long n,
           void* out, bool to_bf16, cudaStream_t s) {
  swin_bwd_reduce_partials_kernel<<<blocks_for(n, 256), 256, 0, s>>>(
      partial, splits, stride, n, out, to_bf16 ? 1 : 0);
  return (int)cudaGetLastError();
}

int weight_grad(const bf16* a, const bf16* d, int M, int ka, int n,
                float* partial, void* out, cudaStream_t s) {
  int rows;
  const int splits = tn_splits(M, ka, n, &rows);
  TnArgs g{a, d, partial, M, ka, n, rows};
  swin_bwd_gemm_tn_kernel<<<dim3((n + BN - 1) / BN, (ka + BM - 1) / BM,
                                 splits),
                   THREADS, 0, s>>>(g);
  int err = (int)cudaGetLastError();
  if (err) return err;
  return reduce(partial, splits, (long long)ka * n, (long long)ka * n, out,
                true, s);
}

template <int EPI>
int input_grad(const bf16* a, const bf16* w, const float* pre, void* out,
               int M, int n, int k, cudaStream_t s) {
  NtArgs g{a, w, pre, out, M, n, k};
  swin_bwd_gemm_nt_kernel<EPI>
      <<<dim3((n + BN - 1) / BN, (M + BM - 1) / BM), THREADS,
                        0, s>>>(g);
  return (int)cudaGetLastError();
}

int bias_grad(const bf16* src, int M, int n, const float* dp, int T,
              float* partial, float* out, cudaStream_t s) {
  const int blocks = (M + COLSUM_ROWS - 1) / COLSUM_ROWS;
  swin_bwd_colsum_kernel<<<blocks, 256, 0, s>>>(src, M, n, dp, T, partial);
  int err = (int)cudaGetLastError();
  if (err) return err;
  return reduce(partial, blocks, n, n, out, false, s);
}

// the column partials [blocks][3][C] of ln_bwd -> up to three outputs
int ln_partials(const float* partial, int blocks, int C, float* o0,
                float* o1, float* o2, cudaStream_t s) {
  float* outs[3] = {o0, o1, o2};
  for (int k = 0; k < 3; ++k) {
    if (!outs[k]) continue;
    const int err = reduce(partial + (size_t)k * C, blocks, 3LL * C, C,
                           outs[k], false, s);
    if (err) return err;
  }
  return 0;
}

}  // namespace

extern "C" long long swinvox_swin_block_train_bwd_workspace(
    long long n_windows, int tokens, int channels, int heads) {
  return (long long)plan(n_windows, tokens, channels, heads).bytes;
}

// Shapes as in swinvox_swin_block_train_fwd; gradients out: dx [., C]
// bf16; dln1s, dln1b, dbqkv, dbproj, dln2s, dln2b, db1, db2 and drel_bias
// [H, T, T] f32; dwqkv [C, 3C], dwproj [C, C], dw1 [C, 4C], dw2 [4C, C]
// bf16.  `work` holds swinvox_swin_block_train_bwd_workspace() bytes.
extern "C" int swinvox_swin_block_train_bwd(
    const void* dout, const void* x, const void* dp1, const void* dp2,
    const void* h1, const void* stats1, const void* qkv, const void* ctx,
    const void* x2, const void* h2, const void* stats2, const void* pre,
    const void* hidden, const void* ln1s, const void* wqkv,
    const void* wproj, const void* rel_bias, const void* mask, int nw_img,
    const void* ln2s, const void* w1, const void* w2, void* dx, void* dln1s,
    void* dln1b, void* dwqkv, void* dbqkv, void* dwproj, void* dbproj,
    void* drel_bias, void* dln2s, void* dln2b, void* dw1, void* db1,
    void* dw2, void* db2, void* work, long long work_bytes,
    long long n_windows, int tokens, int channels, int heads, float scale,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = plan(n_windows, tokens, channels, heads);
  if (p.M == 0) return 0;
  if ((long long)p.bytes > work_bytes) return (int)cudaErrorInvalidValue;
  if (channels % 32 || channels / 32 > LN_MAXCPL || tokens > TMAX)
    return (int)cudaErrorInvalidValue;
  const int M = p.M, C = channels, T = tokens;
  auto F = [](const void* q) { return static_cast<const float*>(q); };
  auto B = [](const void* q) { return static_cast<const bf16*>(q); };
  unsigned char* wb = static_cast<unsigned char*>(work);
  bf16* dmlp = reinterpret_cast<bf16*>(wb + p.off[0]);
  bf16* dm1 = reinterpret_cast<bf16*>(wb + p.off[1]);
  float* dh = reinterpret_cast<float*>(wb + p.off[2]);
  float* dx2 = reinterpret_cast<float*>(wb + p.off[3]);
  bf16* dattn = reinterpret_cast<bf16*>(wb + p.off[4]);
  bf16* dctx = reinterpret_cast<bf16*>(wb + p.off[5]);
  bf16* dqkv = reinterpret_cast<bf16*>(wb + p.off[6]);
  float* part = reinterpret_cast<float*>(wb + p.off[7]);
  int err;

  // ---- MLP branch
  const long long n8 = (long long)M * C / 8;
  swin_bwd_scale_rows_kernel<<<blocks_for(n8, 256), 256, 0, s>>>(
      B(dout), F(dp2), T, C,
                                                        n8, dmlp);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = bias_grad(B(dout), M, C, F(dp2), T, part,
                       static_cast<float*>(db2), s)))
    return err;
  if ((err = weight_grad(B(hidden), dmlp, M, 4 * C, C, part, dw2, s)))
    return err;
  if ((err = input_grad<NT_DGELU>(dmlp, B(w2), F(pre), dm1, M, 4 * C, C, s)))
    return err;
  if ((err = bias_grad(dm1, M, 4 * C, nullptr, T, part,
                       static_cast<float*>(db1), s)))
    return err;
  if ((err = weight_grad(B(h2), dm1, M, C, 4 * C, part, dw1, s))) return err;
  if ((err = input_grad<NT_F32>(dm1, B(w1), nullptr, dh, M, C, 4 * C, s)))
    return err;

  // ---- LN2 backward + residual: dx2, dattn
  const int ln_blocks = (M + LN_ROWS - 1) / LN_ROWS;
  swin_bwd_ln_bwd_kernel<float, bf16><<<ln_blocks, LN_WARPS * 32, 0, s>>>(
      dh, F(x2), F(stats2), F(ln2s), B(dout), F(dp1), T, M, C, dx2, dattn,
      part);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = ln_partials(part, ln_blocks, C, static_cast<float*>(dln2s),
                         static_cast<float*>(dln2b),
                         static_cast<float*>(dbproj), s)))
    return err;

  // ---- attention branch
  if ((err = weight_grad(B(ctx), dattn, M, C, C, part, dwproj, s)))
    return err;
  if ((err = input_grad<NT_BF16>(dattn, B(wproj), nullptr, dctx, M, C, C, s)))
    return err;
  if ((err = (int)cudaFuncSetAttribute(
           swin_bwd_attn_bwd_kernel,
           cudaFuncAttributeMaxDynamicSharedMemorySize,
           (int)ATT_SMEM)))
    return err;
  swin_bwd_attn_bwd_kernel<<<dim3(p.att_groups, heads), ATT_THREADS,
                             ATT_SMEM, s>>>(
      B(qkv), dctx, F(rel_bias), F(mask), nw_img, p.nw, T, C, scale, dqkv,
      part);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = reduce(part, p.att_groups, (long long)heads * T * T,
                    (long long)heads * T * T, drel_bias, false, s)))
    return err;
  if ((err = bias_grad(dqkv, M, 3 * C, nullptr, T, part,
                       static_cast<float*>(dbqkv), s)))
    return err;
  if ((err = weight_grad(B(h1), dqkv, M, C, 3 * C, part, dwqkv, s)))
    return err;
  if ((err = input_grad<NT_F32>(dqkv, B(wqkv), nullptr, dh, M, C, 3 * C, s)))
    return err;

  // ---- LN1 backward + residual: dx
  swin_bwd_ln_bwd_kernel<bf16, float><<<ln_blocks, LN_WARPS * 32, 0, s>>>(
      dh, B(x), F(stats1), F(ln1s), dx2, nullptr, T, M, C, nullptr,
      static_cast<bf16*>(dx), part);
  if ((err = (int)cudaGetLastError())) return err;
  return ln_partials(part, ln_blocks, C, static_cast<float*>(dln1s),
                     static_cast<float*>(dln1b), nullptr, s);
}
