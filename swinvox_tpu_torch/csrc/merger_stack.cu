// The merger's six-layer conv stack in training mode: forward (kernel E)
// and backward (kernel F); and at inference (kernel I, at the end of the
// file).
//
// Replaces the TPU kernels swinvox_tpu/ops/pallas_merger_stack.py:
// _fwd_kernel and _bwd_kernel (through `merger_stack`).  On N
// channels-last bf16 volumes x [N, 32, 32, 32, 9]:
//
//   r_l = conv3x3x3_l(a_{l-1}) + bias_l, rounded to bf16   (zero pad 1)
//   a_l = bf16(leaky(r_l * A_l + B_l)),  l = 0..4,  a_{-1} = x
//   A_l = gamma_l / sqrt(var_l + eps),  B_l = beta_l - mean_l * A_l
//   mean_l, var_l: per channel over the N*32^3 voxels of the bf16 r_l,
//   f32 sums, var = E[r^2] - mean^2 (biased)
//   layer 4 reads concat(a_0..a_3) (36 channels); layer 5 (9 -> 1) reads
//   a_4 and its raw output is the stack's result raw5.
//
// Kernel E is 12 launches: per layer one direct-conv launch and one
// single-block statistics launch.  A conv block owns one volume's (d,
// 16-row half plane): it loads the 3 x 18 x 34 input halo of its source
// into shared memory as f32, normalizing on read (the previous layer's
// affine from the statistics buffer, LeakyReLU, bf16 rounding — the
// activation a_l is never stored), loads the 27 x C_in x C_out weights,
// and each thread computes all output channels of two voxels with f32
// FMAs (of bf16 values, so every product is exact, as in a bf16
// tensor-core product).  The
// block's per-channel sum and sum of squares of its bf16 outputs go to a
// partial that the statistics launch sums in a fixed order.  Layer 4
// accumulates its four 9-channel sources in registers, one halo load at a
// time.
//
// Kernel F walks layers 5 to 0.  For a BatchNorm layer l, with dA_l the
// gradient arriving at a_l (f32, accumulated from every consumer):
//   e = dA_l * leaky'(r_l * A_l + B_l),  xhat = (r_l - mean_l) * inv_l
//   dbeta_l = S1 = sum e,  dgamma_l = S2 = sum e * xhat
//   dr_l = gamma_l * inv_l * (e - S1 / n - xhat * S2 / n)   (bf16)
// (a partial-sum launch, a single-block finalize, an apply launch), then
// db_l = sum dr_l, dW_l[tap][ci][co] = sum_v a_{l-1}[v + tap][ci] dr_l[v][co]
// (one thread per (tap, ci) over a block's voxels, per-block partials,
// then a fixed-order reduce), and the input gradient as the same direct
// conv with the flipped, channel-swapped kernel, added into dA_{l-1} (or,
// for layer 4, split over its four sources; for layer 0, dx in bf16).
//
// Kernel I (inference, replaces swinvox_tpu/ops/pallas_merger.py:
// _merger_kernel) runs the same direct conv with BatchNorm folded from
// the running statistics into a per-channel affine: each layer's
// activation bf16(leaky(conv * s + t)) is written once (the four that
// conv5 concatenates take 2.4 MB per volume, more than shared memory
// holds), six launches in all, f32 logits out.  At 24 volumes it is 27.9
// GFLOP of f32 FMAs (0.42 ms at 67 TFLOP/s) against 17 MB of input and
// output.
//
// Work at N = 48 volumes (3 views, batch 16): 1.57 M voxels, 35.5 k FLOP
// per voxel over the six layers (2.2 k multiply-adds for a 9->9 layer),
// so 56 GFLOP forward and twice that backward, in f32 FMAs against the
// card's 67 TFLOP/s of f32 (bf16 tensor cores are not used: 9 channels
// fill no tile), and about 0.2 GB moved each way.  So the stack is bound
// by operations; this first version is a plain direct convolution.
//
// The C entry points return the first nonzero cudaGetLastError() of their
// launches.

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
constexpr int STAT_THREADS = 256;

// packed bf16 DHWIO weights of the six layers
constexpr int W_OFF[7] = {0, 2187, 4374, 6561, 8748, 17496, 17739};

enum Mode { FWD = 0, ADJ_INIT = 1, ADJ_ACC = 2, ADJ_DX = 3, INFER = 4 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Loads the halo tile of one 9- or 1-channel source around plane d, rows
// [h0 - 1, h0 + TH + 1), as f32; `aff` (null: raw) holds the previous
// layer's normalize scale [9] and shift [9]; padding stays 0.
template <int CIN>
__device__ void load_tile(const bf16* __restrict__ src,
                          const float* __restrict__ aff, float leaky, int n,
                          int d, int h0, float* tile) {
  for (int i = threadIdx.x; i < TILE * CIN; i += blockDim.x) {
    const int ci = i % CIN, p = i / CIN;
    const int ww = p % TW, hh = (p / TW) % TR, dd = p / (TW * TR);
    const int gd = d + dd - 1, gh = h0 + hh - 1, gw = ww - 1;
    float v = 0.f;
    if (gd >= 0 && gd < S && gh >= 0 && gh < S && gw >= 0 && gw < S) {
      const size_t vox = (((size_t)n * S + gd) * S + gh) * S + gw;
      v = __bfloat162float(src[vox * CIN + ci]);
      if (aff) {
        float z = v * aff[ci] + aff[9 + ci];
        z = z > 0.f ? z : z * leaky;
        v = __bfloat162float(__float2bfloat16(z));
      }
    }
    tile[i] = v;
  }
}

struct ConvArgs {
  const bf16* src[4];     // sources, CIN channels each, channels-last
  const float* aff[4];    // their normalize affine, or null
  const bf16* w;          // this layer's DHWIO kernel [27][Cin][Cout]
  const float* bias;      // FWD: [COUT]
  const float* fold;      // INFER: folded BatchNorm scale [9], shift [9]
  void* dst[4];           // FWD: bf16 [V][COUT]; ADJ_*: f32 [V][9] x COUT/9;
                          // ADJ_DX: bf16 [V][9]; INFER: bf16 [V][9], or
                          // f32 [V] for the 1-channel last layer
  float* partial;         // FWD: [blocks][2][COUT] sums of r and r^2
  float leaky;
};

// Direct 3x3x3 conv, one block per (volume, d, half plane), two output
// voxels per thread.  FWD: the layer's conv of NSRC sources with CIN
// channels each into COUT channels.  INFER: the same conv followed by the
// folded inference BatchNorm and LeakyReLU (kernel I).  ADJ_*: the input gradient of a layer
// whose forward maps COUT channels to CIN: the conv of dr (CIN channels)
// with the flipped, channel-swapped kernel into COUT channels.
template <int CIN, int NSRC, int COUT, int MODE>
__global__ void __launch_bounds__(THREADS) mstack_conv_kernel(ConvArgs a) {
  constexpr int CT = CIN * NSRC;  // input channels of this conv
  extern __shared__ __align__(16) float sm[];
  float* ws = sm;                     // [27][CT][COUT]
  float* tile = sm + 27 * CT * COUT;  // [TILE][CIN]
  const int blk = blockIdx.x;
  const int n = blk / (2 * S), d = (blk / 2) % S, h0 = (blk % 2) * TH;
  const int tid = threadIdx.x;

  for (int i = tid; i < 27 * CT * COUT; i += THREADS) {
    if (MODE == FWD || MODE == INFER) {
      ws[i] = __bfloat162float(a.w[i]);
    } else {  // forward kernel [27][COUT][CT] -> flipped, swapped
      const int t = i / (CT * COUT), ci = (i / COUT) % CT, co = i % COUT;
      ws[i] = __bfloat162float(a.w[((26 - t) * COUT + co) * CT + ci]);
    }
  }
  const int w = tid % 32, r0 = tid / 32;  // rows r0 and r0 + 8
  float acc0[COUT], acc1[COUT];
#pragma unroll
  for (int co = 0; co < COUT; ++co) acc0[co] = acc1[co] = 0.f;

  for (int s = 0; s < NSRC; ++s) {
    __syncthreads();
    load_tile<CIN>(a.src[s], a.aff[s], a.leaky, n, d, h0, tile);
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
  if (MODE == FWD) {
    __shared__ float red[THREADS / 32][2 * 9];
    bf16* dst = static_cast<bf16*>(a.dst[0]);
    const int warp = tid / 32, lane = tid % 32;
#pragma unroll
    for (int co = 0; co < COUT; ++co) {
      const bf16 q0 = __float2bfloat16(acc0[co] + a.bias[co]);
      const bf16 q1 = __float2bfloat16(acc1[co] + a.bias[co]);
      dst[v0 * COUT + co] = q0;
      dst[v1 * COUT + co] = q1;
      const float f0 = __bfloat162float(q0), f1 = __bfloat162float(q1);
      const float s1 = warp_sum(f0 + f1);
      const float s2 = warp_sum(f0 * f0 + f1 * f1);
      if (lane == 0) {
        red[warp][co] = s1;
        red[warp][9 + co] = s2;
      }
    }
    __syncthreads();
    if (tid < 2 * COUT) {
      const int k = tid / COUT, co = tid % COUT;
      float sum = 0.f;
      for (int i = 0; i < THREADS / 32; ++i) sum += red[i][9 * k + co];
      a.partial[((size_t)blk * 2 + k) * COUT + co] = sum;
    }
  } else if (MODE == INFER) {
#pragma unroll
    for (int co = 0; co < COUT; ++co) {
      float z0 = acc0[co] * a.fold[co] + a.fold[9 + co];
      float z1 = acc1[co] * a.fold[co] + a.fold[9 + co];
      z0 = z0 >= 0.f ? z0 : z0 * a.leaky;
      z1 = z1 >= 0.f ? z1 : z1 * a.leaky;
      if (COUT == 1) {
        static_cast<float*>(a.dst[0])[v0] = z0;
        static_cast<float*>(a.dst[0])[v1] = z1;
      } else {
        static_cast<bf16*>(a.dst[0])[v0 * COUT + co] = __float2bfloat16(z0);
        static_cast<bf16*>(a.dst[0])[v1 * COUT + co] = __float2bfloat16(z1);
      }
    }
  } else if (MODE == ADJ_DX) {
    bf16* dst = static_cast<bf16*>(a.dst[0]);
#pragma unroll
    for (int co = 0; co < COUT; ++co) {
      dst[v0 * COUT + co] = __float2bfloat16(acc0[co]);
      dst[v1 * COUT + co] = __float2bfloat16(acc1[co]);
    }
  } else {
#pragma unroll
    for (int co = 0; co < COUT; ++co) {
      float* dst = static_cast<float*>(a.dst[co / 9]);
      const int c = co % 9;
      if (MODE == ADJ_INIT) {
        dst[v0 * 9 + c] = acc0[co];
        dst[v1 * 9 + c] = acc1[co];
      } else {
        dst[v0 * 9 + c] += acc0[co];
        dst[v1 * 9 + c] += acc1[co];
      }
    }
  }
}

// Per-layer statistics from the conv blocks' partials (one block):
// stats[0] mean, [1] biased variance, and for a BatchNorm layer [2] the
// normalize scale and [3] shift, 9 floats each.
__global__ void mstack_stats_kernel(const float* __restrict__ partial,
                                 int blocks, int cout, float count,
                                 const float* __restrict__ gamma,
                                 const float* __restrict__ beta, float eps,
                                 float* __restrict__ stats) {
  const int co = threadIdx.x;
  if (co >= cout) return;
  float s1 = 0.f, s2 = 0.f;
  for (int b = 0; b < blocks; ++b) {
    s1 += partial[((size_t)b * 2) * cout + co];
    s2 += partial[((size_t)b * 2 + 1) * cout + co];
  }
  const float mean = s1 / count;
  const float var = s2 / count - mean * mean;
  stats[co] = mean;
  stats[9 + co] = var;
  if (gamma) {
    const float sc = gamma[co] * rsqrtf(var + eps);
    stats[18 + co] = sc;
    stats[27 + co] = beta[co] - mean * sc;
  }
}

// ---------------------------------------------------------------- backward

// Partial sums of e and e * xhat for BatchNorm layer l (9 channels):
// e = dA * leaky'(r * A + B).  One block of 256 threads per 2048 voxels.
constexpr int BN_VOX = 2048;

__global__ void __launch_bounds__(THREADS)
    mstack_bn_sums_kernel(const bf16* __restrict__ r,
                          const float* __restrict__ da,
                   const float* __restrict__ st, float leaky, float eps,
                   long long nvox, float* __restrict__ partial) {
  __shared__ float red[THREADS / 32][18];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float s1[9], s2[9];
#pragma unroll
  for (int c = 0; c < 9; ++c) s1[c] = s2[c] = 0.f;
  const long long v0 = (long long)blockIdx.x * BN_VOX;
  for (long long v = v0 + tid; v < min(nvox, v0 + BN_VOX); v += THREADS) {
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      const float x = __bfloat162float(r[v * 9 + c]);
      const float bn = x * st[18 + c] + st[27 + c];
      const float e = da[v * 9 + c] * (bn > 0.f ? 1.f : leaky);
      const float xh = (x - st[c]) * rsqrtf(st[9 + c] + eps);
      s1[c] += e;
      s2[c] += e * xh;
    }
  }
#pragma unroll
  for (int c = 0; c < 9; ++c) {
    const float a = warp_sum(s1[c]), b = warp_sum(s2[c]);
    if (lane == 0) {
      red[warp][c] = a;
      red[warp][9 + c] = b;
    }
  }
  __syncthreads();
  if (tid < 18) {
    float sum = 0.f;
    for (int i = 0; i < THREADS / 32; ++i) sum += red[i][tid];
    partial[(size_t)blockIdx.x * 18 + tid] = sum;
  }
}

// S1 = dbeta, S2 = dgamma (one block; also kept in s12 for the apply).
__global__ void mstack_bn_finalize_kernel(const float* __restrict__ partial,
                                        int blocks, float* __restrict__ dgamma,
                                        float* __restrict__ dbeta,
                                        float* __restrict__ s12) {
  const int i = threadIdx.x;
  if (i >= 18) return;
  float sum = 0.f;
  for (int b = 0; b < blocks; ++b) sum += partial[(size_t)b * 18 + i];
  s12[i] = sum;
  if (i < 9) dbeta[i] = sum;
  else dgamma[i - 9] = sum;
}

// dr = gamma * inv * (e - S1 / n - xhat * S2 / n) in bf16, and partial
// sums of the bf16 dr (the conv bias gradient).
__global__ void __launch_bounds__(THREADS)
    mstack_bn_apply_kernel(const bf16* __restrict__ r,
                           const float* __restrict__ da,
                    const float* __restrict__ st,
                    const float* __restrict__ gamma,
                    const float* __restrict__ s12, float leaky, float eps,
                    float count, long long nvox, bf16* __restrict__ dr,
                    float* __restrict__ partial) {
  __shared__ float red[THREADS / 32][9];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float sb[9];
#pragma unroll
  for (int c = 0; c < 9; ++c) sb[c] = 0.f;
  const long long v0 = (long long)blockIdx.x * BN_VOX;
  for (long long v = v0 + tid; v < min(nvox, v0 + BN_VOX); v += THREADS) {
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      const float inv = rsqrtf(st[9 + c] + eps);
      const float x = __bfloat162float(r[v * 9 + c]);
      const float bn = x * st[18 + c] + st[27 + c];
      const float e = da[v * 9 + c] * (bn > 0.f ? 1.f : leaky);
      const float xh = (x - st[c]) * inv;
      const float g = gamma[c] * inv *
                      (e - s12[c] / count - xh * s12[9 + c] / count);
      const bf16 q = __float2bfloat16(g);
      dr[v * 9 + c] = q;
      sb[c] += __bfloat162float(q);
    }
  }
#pragma unroll
  for (int c = 0; c < 9; ++c) {
    const float a = warp_sum(sb[c]);
    if (lane == 0) red[warp][c] = a;
  }
  __syncthreads();
  if (tid < 9) {
    float sum = 0.f;
    for (int i = 0; i < THREADS / 32; ++i) sum += red[i][tid];
    partial[(size_t)blockIdx.x * 9 + tid] = sum;
  }
}

// Partial sums of a 1-channel bf16 volume (layer 5's bias gradient).
__global__ void __launch_bounds__(THREADS)
    mstack_sum1_kernel(const bf16* __restrict__ src, long long nvox,
                float* __restrict__ partial) {
  __shared__ float red[THREADS / 32];
  const int tid = threadIdx.x;
  float s = 0.f;
  const long long v0 = (long long)blockIdx.x * BN_VOX;
  for (long long v = v0 + tid; v < min(nvox, v0 + BN_VOX); v += THREADS)
    s += __bfloat162float(src[v]);
  s = warp_sum(s);
  if (tid % 32 == 0) red[tid / 32] = s;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int i = 0; i < THREADS / 32; ++i) sum += red[i];
    partial[blockIdx.x] = sum;
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
  const bf16* src[4];   // the layer's input sources (pre-normalization)
  const float* aff[4];  // their normalize affine, or null
  const bf16* dr;       // [V][COUT] bf16
  float* partial;       // [blocks][27][CIN * NSRC][COUT]
  float leaky;
};

// dW partial of one block (a volume's WG_PLANES d planes, one half plane
// of rows): thread (tap, ci) sums a[v + tap][ci] * dr[v][co] over the
// block's voxels for every co and source.
template <int CIN, int NSRC, int COUT>
__global__ void __launch_bounds__(THREADS) mstack_wgrad_kernel(WgradArgs a) {
  constexpr int CT = CIN * NSRC;
  extern __shared__ __align__(16) float sm[];
  float* drt = sm;                     // [TH * S][COUT]
  float* tile = sm + TH * S * COUT;    // [TILE][CIN]
  const int planes = S / WG_PLANES;
  const int blk = blockIdx.x;
  const int n = blk / (2 * planes), d0 = ((blk / 2) % planes) * WG_PLANES;
  const int h0 = (blk % 2) * TH;
  const int tid = threadIdx.x;
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
      drt[i] = __bfloat162float(a.dr[vox * COUT + co]);
    }
#pragma unroll
    for (int s = 0; s < NSRC; ++s) {
      __syncthreads();
      load_tile<CIN>(a.src[s], a.aff[s], a.leaky, n, d, h0, tile);
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

template <int CIN, int NSRC, int COUT, int MODE>
int conv(const ConvArgs& a, int n, cudaStream_t s) {
  const size_t smem = conv_smem(CIN, NSRC, COUT);
  int err = (int)cudaFuncSetAttribute(
      mstack_conv_kernel<CIN, NSRC, COUT, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  mstack_conv_kernel<CIN, NSRC, COUT, MODE>
      <<<n * 2 * S, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <int CIN, int NSRC, int COUT>
int wgrad(const WgradArgs& a, int n, float* out, cudaStream_t s) {
  const size_t smem = wgrad_smem(CIN, COUT);
  int err = (int)cudaFuncSetAttribute(
      mstack_wgrad_kernel<CIN, NSRC, COUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const int blocks = n * 2 * (S / WG_PLANES);
  mstack_wgrad_kernel<CIN, NSRC, COUT><<<blocks, THREADS, smem, s>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  const int total = 27 * CIN * NSRC * COUT;
  mstack_reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(a.partial, blocks,
                                                           total,
                                                    out);
  return (int)cudaGetLastError();
}

size_t align256(size_t b) { return (b + 255) / 256 * 256; }

long long fwd_partial_floats(long long n) { return n * 2 * S * 2 * 9; }

long long bwd_partial_floats(long long n) {
  const long long wg = n * 2 * (S / WG_PLANES) * 27 * 36 * 9;
  const long long bn = (n * V3 + BN_VOX - 1) / BN_VOX * 18;
  return wg > bn ? wg : bn;
}

}  // namespace

extern "C" long long swinvox_merger_stack_fwd_workspace(long long n) {
  return (long long)align256(sizeof(float) * fwd_partial_floats(n));
}

// x [n, 32^3, 9] bf16; w the six DHWIO kernels packed in bf16 (offsets
// W_OFF); bias [6][9], gamma, beta [5][9] f32.  Out: raws [5][n*32^3][9]
// bf16 (r_0..r_4), raw5 [n*32^3] bf16, stats [6][4][9] f32.
extern "C" int swinvox_merger_stack_fwd(
    const void* x, const void* w, const void* bias, const void* gamma,
    const void* beta, void* raws, void* raw5, void* stats, void* work,
    long long work_bytes, long long n, float leaky, float eps,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (work_bytes < swinvox_merger_stack_fwd_workspace(n))
    return (int)cudaErrorInvalidValue;
  const bf16* W = static_cast<const bf16*>(w);
  const float* bs = static_cast<const float*>(bias);
  const float* gm = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  bf16* R = static_cast<bf16*>(raws);
  float* st = static_cast<float*>(stats);
  float* part = static_cast<float*>(work);
  const size_t nv9 = (size_t)n * V3 * 9;
  const int blocks = (int)(n * 2 * S);
  const float count = (float)(n * V3);
  int err;
  auto finish = [&](int layer, int cout) {
    mstack_stats_kernel<<<1, STAT_THREADS, 0, s>>>(
        part, blocks, cout, count, layer < 5 ? gm + layer * 9 : nullptr,
        layer < 5 ? bt + layer * 9 : nullptr, eps, st + layer * 36);
    return (int)cudaGetLastError();
  };
  for (int l = 0; l < 4; ++l) {
    ConvArgs a{};
    a.src[0] = l == 0 ? static_cast<const bf16*>(x) : R + (l - 1) * nv9;
    a.aff[0] = l == 0 ? nullptr : st + (l - 1) * 36 + 18;
    a.w = W + W_OFF[l];
    a.bias = bs + l * 9;
    a.dst[0] = R + l * nv9;
    a.partial = part;
    a.leaky = leaky;
    if ((err = conv<9, 1, 9, FWD>(a, (int)n, s))) return err;
    if ((err = finish(l, 9))) return err;
  }
  {
    ConvArgs a{};
    for (int k = 0; k < 4; ++k) {
      a.src[k] = R + k * nv9;
      a.aff[k] = st + k * 36 + 18;
    }
    a.w = W + W_OFF[4];
    a.bias = bs + 4 * 9;
    a.dst[0] = R + 4 * nv9;
    a.partial = part;
    a.leaky = leaky;
    if ((err = conv<9, 4, 9, FWD>(a, (int)n, s))) return err;
    if ((err = finish(4, 9))) return err;
  }
  ConvArgs a{};
  a.src[0] = R + 4 * nv9;
  a.aff[0] = st + 4 * 36 + 18;
  a.w = W + W_OFF[5];
  a.bias = bs + 5 * 9;
  a.dst[0] = raw5;
  a.partial = part;
  a.leaky = leaky;
  if ((err = conv<9, 1, 1, FWD>(a, (int)n, s))) return err;
  return finish(5, 1);
}

extern "C" long long swinvox_merger_stack_bwd_workspace(long long n) {
  const size_t nv9 = (size_t)n * V3 * 9;
  return (long long)(4 * align256(nv9 * 4) + align256(nv9 * 2) +
                     align256(sizeof(float) * bwd_partial_floats(n)) + 256);
}

// x, raws, stats, w as above, gamma [5][9]; d_raw5 [n*32^3] bf16.  Out:
// dx [n*32^3][9] bf16; dw packed like w in f32; dbias [6][9] (layer 5:
// [5][0]), dgamma, dbeta [5][9] f32.
extern "C" int swinvox_merger_stack_bwd(
    const void* x, const void* raws, const void* stats, const void* w,
    const void* gamma, const void* d_raw5, void* dx, void* dw, void* dbias,
    void* dgamma, void* dbeta, void* work, long long work_bytes,
    long long n, float leaky, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (work_bytes < swinvox_merger_stack_bwd_workspace(n))
    return (int)cudaErrorInvalidValue;
  const bf16* W = static_cast<const bf16*>(w);
  const bf16* R = static_cast<const bf16*>(raws);
  const float* st = static_cast<const float*>(stats);
  const float* gm = static_cast<const float*>(gamma);
  float* DW = static_cast<float*>(dw);
  float* DB = static_cast<float*>(dbias);
  const size_t nv9 = (size_t)n * V3 * 9;
  const long long nvox = n * V3;
  const float count = (float)nvox;
  unsigned char* wb = static_cast<unsigned char*>(work);
  float* dA[4];
  for (int k = 0; k < 4; ++k) dA[k] = reinterpret_cast<float*>(
      wb + k * align256(nv9 * 4));
  bf16* dr = reinterpret_cast<bf16*>(wb + 4 * align256(nv9 * 4));
  float* part = reinterpret_cast<float*>(wb + 4 * align256(nv9 * 4) +
                                         align256(nv9 * 2));
  float* s12 = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(part) +
      align256(sizeof(float) * bwd_partial_floats(n)));
  const int bn_blocks = (int)((nvox + BN_VOX - 1) / BN_VOX);
  int err;
  if ((err = (int)cudaMemsetAsync(DB, 0, 6 * 9 * sizeof(float), s)))
    return err;

  // ---- layer 5: dr5 is given
  const bf16* dr5 = static_cast<const bf16*>(d_raw5);
  mstack_sum1_kernel<<<bn_blocks, THREADS, 0, s>>>(dr5, nvox, part);
  if ((err = (int)cudaGetLastError())) return err;
  mstack_reduce_kernel<<<1, 32, 0, s>>>(part, bn_blocks, 1, DB + 5 * 9);
  if ((err = (int)cudaGetLastError())) return err;
  {
    WgradArgs g{};
    g.src[0] = R + 4 * nv9;
    g.aff[0] = st + 4 * 36 + 18;
    g.dr = dr5;
    g.partial = part;
    g.leaky = leaky;
    if ((err = wgrad<9, 1, 1>(g, (int)n, DW + W_OFF[5], s))) return err;
    ConvArgs a{};
    a.src[0] = dr5;
    a.w = W + W_OFF[5];
    a.dst[0] = dA[0];  // dA_4 (dA_0..3 are written after it is read)
    if ((err = conv<1, 1, 9, ADJ_INIT>(a, (int)n, s))) return err;
  }

  for (int l = 4; l >= 0; --l) {
    // ---- BatchNorm l backward: dA_l -> dr_l (bf16), dgamma, dbeta, db
    const float* da = l == 4 ? dA[0] : dA[l];
    const bf16* r = R + l * nv9;
    const float* sl = st + l * 36;
    mstack_bn_sums_kernel<<<bn_blocks, THREADS, 0, s>>>(r, da, sl, leaky, eps,
                                                        nvox,
                                                 part);
    if ((err = (int)cudaGetLastError())) return err;
    mstack_bn_finalize_kernel<<<1, 32, 0, s>>>(
        part, bn_blocks, static_cast<float*>(dgamma) + l * 9,
        static_cast<float*>(dbeta) + l * 9, s12);
    if ((err = (int)cudaGetLastError())) return err;
    mstack_bn_apply_kernel<<<bn_blocks, THREADS, 0, s>>>(r, da, sl, gm + l * 9,
                                                         s12,
                                                  leaky, eps, count, nvox, dr,
                                                  part);
    if ((err = (int)cudaGetLastError())) return err;
    mstack_reduce_kernel<<<1, 32, 0, s>>>(part, bn_blocks, 9, DB + l * 9);
    if ((err = (int)cudaGetLastError())) return err;

    // ---- conv l backward: dW_l, then the input gradient
    WgradArgs g{};
    g.dr = dr;
    g.partial = part;
    g.leaky = leaky;
    ConvArgs a{};
    a.src[0] = dr;
    a.w = W + W_OFF[l];
    if (l == 4) {
      for (int k = 0; k < 4; ++k) {
        g.src[k] = R + k * nv9;
        g.aff[k] = st + k * 36 + 18;
        a.dst[k] = dA[k];
      }
      if ((err = wgrad<9, 4, 9>(g, (int)n, DW + W_OFF[4], s))) return err;
      if ((err = conv<9, 1, 36, ADJ_INIT>(a, (int)n, s))) return err;
    } else if (l > 0) {
      g.src[0] = R + (l - 1) * nv9;
      g.aff[0] = st + (l - 1) * 36 + 18;
      a.dst[0] = dA[l - 1];
      if ((err = wgrad<9, 1, 9>(g, (int)n, DW + W_OFF[l], s))) return err;
      if ((err = conv<9, 1, 9, ADJ_ACC>(a, (int)n, s))) return err;
    } else {
      g.src[0] = static_cast<const bf16*>(x);
      g.aff[0] = nullptr;
      a.dst[0] = dx;
      if ((err = wgrad<9, 1, 9>(g, (int)n, DW + W_OFF[0], s))) return err;
      if ((err = conv<9, 1, 9, ADJ_DX>(a, (int)n, s))) return err;
    }
  }
  return 0;
}

// Kernel I: the merger's six layers at inference (replaces
// swinvox_tpu/ops/pallas_merger.py:_merger_kernel through
// `merger_view_weights`).  x [n, 32^3, 9] bf16; w the six DHWIO kernels
// packed in bf16 (offsets W_OFF); fold [6][2][9] f32, per layer the
// BatchNorm folded from its running statistics with the conv bias,
// z * s + t (layer 5: element 0).  Each layer is one INFER launch of the
// direct conv: a_l = bf16(leaky(conv_l(a_{l-1}) * s_l + t_l)) into the
// scratch acts [5][n*32^3][9] bf16 (conv5 reads a_0..a_3 as its four
// sources), and the last layer's f32 logits into out [n*32^3].
extern "C" int swinvox_merger_infer(const void* x, const void* w,
                                    const void* fold, void* acts, void* out,
                                    long long n, float leaky, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  const bf16* W = static_cast<const bf16*>(w);
  const float* F = static_cast<const float*>(fold);
  bf16* A = static_cast<bf16*>(acts);
  const size_t nv9 = (size_t)n * V3 * 9;
  int err;
  for (int l = 0; l < 4; ++l) {
    ConvArgs a{};
    a.src[0] = l == 0 ? static_cast<const bf16*>(x) : A + (l - 1) * nv9;
    a.w = W + W_OFF[l];
    a.fold = F + l * 18;
    a.dst[0] = A + l * nv9;
    a.leaky = leaky;
    if ((err = conv<9, 1, 9, INFER>(a, (int)n, s))) return err;
  }
  {
    ConvArgs a{};
    for (int k = 0; k < 4; ++k) a.src[k] = A + k * nv9;
    a.w = W + W_OFF[4];
    a.fold = F + 4 * 18;
    a.dst[0] = A + 4 * nv9;
    a.leaky = leaky;
    if ((err = conv<9, 4, 9, INFER>(a, (int)n, s))) return err;
  }
  ConvArgs a{};
  a.src[0] = A + 4 * nv9;
  a.w = W + W_OFF[5];
  a.fold = F + 5 * 18;
  a.dst[0] = out;
  a.leaky = leaky;
  return conv<9, 1, 1, INFER>(a, (int)n, s);
}
