// The window-attention core on head-major q/k/v (kernel G).
//
// Replaces the TPU kernels swinvox_tpu/ops/pallas_window_attention.py:
// _attn_kernel and _attn_kernel_masked (through
// `window_attention_pallas`).  For q, k, v [nW, heads, T, 32] bf16
// (T <= 64 tokens, 49 for a 7x7 window):
//
//   s   = (q k^T) * scale + rel_bias[head] (+ mask[window % nW_img])   f32
//   out = bf16(bf16(softmax_f32(s)) @ v)                               f32 sums
//
// with the TPU kernel's rounding points (probabilities cast to v's dtype,
// the product accumulated in f32).  One 128-thread block per (window,
// head) runs attention_tile below (kernel B's first design, which kernel
// H also ran until it moved onto B's register-resident attention in
// swin_block.cu): wmma QK^T and PV with tokens padded to 64 in shared
// memory only (pad keys get probability 0, pad query rows are never
// written), so the [T, T] scores never reach device memory.
//
// Work at the 12 Swin blocks of a 24-image forward: 4 * T^2 * 32 FLOP per
// (window, head), 6.7 GFLOP in all, against 275 MB of q, k, v and out
// (14.5 MB each in a stage-0 block, half that per later stage): bound by
// bytes (0.082 ms at 3.35 TB/s; the FLOPs take 0.007 ms at the bf16
// peak).  This first
// version moves each byte once but is built for neither bound: one block
// per (window, head) holds 42 KB of shared memory and runs its softmax a
// row per warp step.
//
// The C entry point returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int HD = 32;      // head_dim of every Swin-T stage
constexpr int TMAX = 64;    // tokens per window held in shared memory
constexpr int ATT_THREADS = 128;

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

__global__ void __launch_bounds__(ATT_THREADS)
    head_major_attention_kernel(const bf16* __restrict__ q,
                                const bf16* __restrict__ k,
                                const bf16* __restrict__ v,
                                const float* __restrict__ rel_bias,
                                const float* __restrict__ mask, int nw_img,
                                bf16* __restrict__ out, int heads, int T,
                                float scale) {
  const int w = blockIdx.x, h = blockIdx.y;
  const size_t off = ((size_t)w * heads + h) * T * HD;
  attention_tile(q + off, k + off, v + off, HD,
                 rel_bias + (size_t)h * T * T,
                 mask ? mask + (size_t)(w % nw_img) * T * T : nullptr,
                 out + off, HD, T, scale);
}

}  // namespace

// q, k, v, out [n_windows, heads, T, 32] bf16; rel_bias [heads, T, T] and
// mask [nw_img, T, T] (or null) f32.  The wrapper checks head_dim 32,
// T <= 64 and 16-byte alignment.
extern "C" int swinvox_window_attention(const void* q, const void* k,
                                        const void* v, const void* rel_bias,
                                        const void* mask, int nw_img,
                                        void* out, long long n_windows,
                                        int heads, int tokens, float scale,
                                        void* stream) {
  if (n_windows == 0) return 0;
  head_major_attention_kernel<<<dim3((unsigned)n_windows, heads),
                                ATT_THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(rel_bias),
      static_cast<const float*>(mask), nw_img, static_cast<bf16*>(out), heads,
      tokens, scale);
  return (int)cudaGetLastError();
}
