// The merger's constants and its float32 CUDA-core bodies: the direct
// 3x3x3 conv over 32^3 channels-last volumes (kernel J's f32 route) and
// the weight gradient (kernel K's f32 route), both in merger_conv.cu.
// Every bf16 merger conv (kernels E, F, I, J and K's bf16 route) runs on
// the tensor cores (merger_mma.cuh, which includes this header).  Only the
// f32 configurations send f32 volumes.  Everything is in an anonymous
// namespace, so each source that includes it gets its own copy.
//
// The conv: one block per (volume, d plane, half plane of 16 rows), 256
// threads, two output voxels per thread.  The block loads the 3 x 18 x 34
// input halo of each source into shared memory, loads the 27 x C_in x
// C_out weights, and accumulates every output channel with f32 FMAs.  A
// source holds CIN channels at a channel stride of `stride` (0: CIN), so
// a 36-channel input is four 9-channel sources at offsets 0, 9, 18, 27.
// What bounds it on an H100: f32 FMAs, 2 x 27 x C_in x C_out a voxel
// against 4 x (C_in + C_out) bytes (a 9 -> 9 call at 24 volumes: 3.4
// GFLOP, 51 us at 67 TFLOP/s, against 17 us of bytes).
//
// The weight gradient: one block per (volume, 4 d planes, half plane);
// thread (tap, ci) sums x[v + tap][ci] * dy[v][co] over the block's
// voxels into a per-block partial; mstack_reduce_kernel then sums the
// partials in a fixed order (no atomics: the same inputs give the same
// bits on every run).  What bounds it on an H100: f32 FMAs with one
// shared load of dy each (shared-load issue, not the card), and one
// thread per output summing every partial serially in the reduce.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int S = 32;                // volume side
constexpr int V3 = S * S * S;        // voxels per volume
constexpr int TH = 16;               // output rows (h) per block
constexpr int TD = 3, TR = TH + 2, TW = S + 2;  // halo tile
constexpr int TILE = TD * TR * TW;   // positions in a halo tile
constexpr int THREADS = 256;
constexpr int WG_PLANES = 4;         // d planes per weight-grad block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Loads the halo tile of one CIN-channel source around plane d, rows
// [h0 - 1, h0 + TH + 1); padding stays 0.
template <int CIN>
__device__ void load_tile(const float* __restrict__ src, int stride, int n,
                          int d, int h0, float* tile) {
  for (int i = threadIdx.x; i < TILE * CIN; i += blockDim.x) {
    const int ci = i % CIN, p = i / CIN;
    const int ww = p % TW, hh = (p / TW) % TR, dd = p / (TW * TR);
    const int gd = d + dd - 1, gh = h0 + hh - 1, gw = ww - 1;
    float v = 0.f;
    if (gd >= 0 && gd < S && gh >= 0 && gh < S && gw >= 0 && gw < S) {
      const size_t vox = (((size_t)n * S + gd) * S + gh) * S + gw;
      v = src[vox * stride + ci];
    }
    tile[i] = v;
  }
}

struct ConvArgs {
  const float* src[4];    // sources, CIN channels each, channels-last
  int stride;             // channel stride of the sources (0: CIN)
  const float* w;         // the DHWIO kernel [27][Cin][Cout]
  float* dst;             // [V][COUT]
};

// Direct 3x3x3 conv of NSRC sources with CIN channels each into COUT
// channels, no bias (kernel J's f32 route), one block per (volume, d,
// half plane), two output voxels per thread.
template <int CIN, int NSRC, int COUT>
__global__ void __launch_bounds__(THREADS)
    mstack_conv_kernel(ConvArgs a) {
  constexpr int CT = CIN * NSRC;  // input channels of this conv
  extern __shared__ __align__(16) float sm[];
  float* ws = sm;                     // [27][CT][COUT]
  float* tile = sm + 27 * CT * COUT;  // [TILE][CIN]
  const int blk = blockIdx.x;
  const int n = blk / (2 * S), d = (blk / 2) % S, h0 = (blk % 2) * TH;
  const int tid = threadIdx.x;
  const int stride = a.stride ? a.stride : CIN;

  for (int i = tid; i < 27 * CT * COUT; i += THREADS) ws[i] = a.w[i];
  const int w = tid % 32, r0 = tid / 32;  // rows r0 and r0 + 8
  float acc0[COUT], acc1[COUT];
#pragma unroll
  for (int co = 0; co < COUT; ++co) acc0[co] = acc1[co] = 0.f;

  for (int s = 0; s < NSRC; ++s) {
    __syncthreads();
    load_tile<CIN>(a.src[s], stride, n, d, h0, tile);
    __syncthreads();
    for (int t = 0; t < 27; ++t) {
      const int kd = t / 9, kh = (t / 3) % 3, kw = t % 3;
      const float* p0 = tile + ((kd * TR + r0 + kh) * TW + w + kw) * CIN;
      const float* p1 = p0 + 8 * TW * CIN;
      const float* wt = ws + (t * CT + s * CIN) * COUT;
#pragma unroll
      for (int ci = 0; ci < CIN; ++ci) {
        const float x0 = p0[ci], x1 = p1[ci];
#pragma unroll
        for (int co = 0; co < COUT; ++co) {
          const float wv = wt[ci * COUT + co];
          acc0[co] = fmaf(x0, wv, acc0[co]);
          acc1[co] = fmaf(x1, wv, acc1[co]);
        }
      }
    }
  }

  const size_t v0 = (((size_t)n * S + d) * S + h0 + r0) * S + w;
  const size_t v1 = v0 + 8 * S;
#pragma unroll
  for (int co = 0; co < COUT; ++co) {
    a.dst[v0 * COUT + co] = acc0[co];
    a.dst[v1 * COUT + co] = acc1[co];
  }
}

// out[i] = sum_b partial[b * n + i], in order.
__global__ void mstack_reduce_kernel(const float* __restrict__ partial,
                                     int blocks,
                              int n, float* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += partial[(size_t)b * n + i];
    out[i] = s;
  }
}

struct WgradArgs {
  const float* src[4];  // the layer's input sources
  int stride;           // channel stride of the sources (0: CIN)
  const float* dr;      // [V][COUT]
  float* partial;       // [blocks][27][CIN * NSRC][COUT]
};

// dW partial of one block (a volume's WG_PLANES d planes, one half plane
// of rows): thread (tap, ci) sums a[v + tap][ci] * dr[v][co] over the
// block's voxels for every co and source.
template <int CIN, int NSRC, int COUT>
__global__ void __launch_bounds__(THREADS)
    mstack_wgrad_kernel(WgradArgs a) {
  constexpr int CT = CIN * NSRC;
  extern __shared__ __align__(16) float sm[];
  float* drt = sm;                     // [TH * S][COUT]
  float* tile = sm + TH * S * COUT;    // [TILE][CIN]
  const int planes = S / WG_PLANES;
  const int blk = blockIdx.x;
  const int n = blk / (2 * planes), d0 = ((blk / 2) % planes) * WG_PLANES;
  const int h0 = (blk % 2) * TH;
  const int tid = threadIdx.x;
  const int stride = a.stride ? a.stride : CIN;
  const bool active = tid < 27 * CIN;
  const int t = tid / CIN, ci = tid % CIN;
  const int kd = t / 9, kh = (t / 3) % 3, kw = t % 3;
  float acc[NSRC][COUT];
#pragma unroll
  for (int s = 0; s < NSRC; ++s)
#pragma unroll
    for (int co = 0; co < COUT; ++co) acc[s][co] = 0.f;

  for (int d = d0; d < d0 + WG_PLANES; ++d) {
    __syncthreads();
    for (int i = tid; i < TH * S * COUT; i += THREADS) {
      const int co = i % COUT, p = i / COUT;
      const size_t vox = (((size_t)n * S + d) * S + h0 + p / S) * S + p % S;
      drt[i] = a.dr[vox * COUT + co];
    }
#pragma unroll
    for (int s = 0; s < NSRC; ++s) {
      __syncthreads();
      load_tile<CIN>(a.src[s], stride, n, d, h0, tile);
      __syncthreads();
      if (active) {
        for (int hh = 0; hh < TH; ++hh) {
          const float* row = tile + ((kd * TR + hh + kh) * TW + kw) * CIN + ci;
          const float* g = drt + hh * S * COUT;
          for (int ww = 0; ww < S; ++ww) {
            const float x = row[ww * CIN];
#pragma unroll
            for (int co = 0; co < COUT; ++co)
              acc[s][co] = fmaf(x, g[ww * COUT + co], acc[s][co]);
          }
        }
      }
    }
  }
  if (active) {
    float* part = a.partial + (size_t)blk * 27 * CT * COUT;
#pragma unroll
    for (int s = 0; s < NSRC; ++s)
#pragma unroll
      for (int co = 0; co < COUT; ++co)
        part[(t * CT + s * CIN + ci) * COUT + co] = acc[s][co];
  }
}

// ---------------------------------------------------------------- launch

size_t conv_smem(int cin, int nsrc, int cout) {
  return sizeof(float) * (27 * cin * nsrc * cout + TILE * cin);
}

size_t wgrad_smem(int cin, int cout) {
  return sizeof(float) * (TH * S * cout + TILE * cin);
}

int wgrad_blocks(long long n) { return (int)(n * 2 * (S / WG_PLANES)); }

template <int CIN, int NSRC, int COUT>
int conv(const ConvArgs& a, int n, cudaStream_t s) {
  const size_t smem = conv_smem(CIN, NSRC, COUT);
  int err = (int)cudaFuncSetAttribute(
      mstack_conv_kernel<CIN, NSRC, COUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  mstack_conv_kernel<CIN, NSRC, COUT><<<n * 2 * S, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The weight gradient into `out` [27][CIN * NSRC][COUT] f32: the partials
// launch, then the fixed-order reduce.  a.partial holds
// wgrad_blocks(n) * 27 * CIN * NSRC * COUT floats.
template <int CIN, int NSRC, int COUT>
int wgrad(const WgradArgs& a, int n, float* out, cudaStream_t s) {
  const size_t smem = wgrad_smem(CIN, COUT);
  int err = (int)cudaFuncSetAttribute(
      mstack_wgrad_kernel<CIN, NSRC, COUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const int blocks = wgrad_blocks(n);
  mstack_wgrad_kernel<CIN, NSRC, COUT><<<blocks, THREADS, smem, s>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  const int total = 27 * CIN * NSRC * COUT;
  mstack_reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(a.partial, blocks,
                                                           total,
                                                    out);
  return (int)cudaGetLastError();
}

size_t align256(size_t b) { return (b + 255) / 256 * 256; }

}  // namespace
