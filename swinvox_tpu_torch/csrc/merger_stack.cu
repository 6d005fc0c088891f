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
// single-block statistics launch.  The direct conv and the weight-grad
// body live in merger_common.cuh (shared with kernels J and K).  A conv
// block owns one volume's (d, 16-row half plane): it loads the 3 x 18 x
// 34 input halo of its source into shared memory as f32, normalizing on
// read (the previous layer's affine from the statistics buffer,
// LeakyReLU, bf16 rounding — the activation a_l is never stored), loads
// the 27 x C_in x C_out weights, and each thread computes all output
// channels of two voxels with f32 FMAs (of bf16 values, so every product
// is exact, as in a bf16 tensor-core product).  The block's per-channel
// sum and sum of squares of its bf16 outputs go to a partial that the
// statistics launch sums in a fixed order.  Layer 4 accumulates its four
// 9-channel sources in registers, one halo load at a time.
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

#include "merger_common.cuh"

namespace {

constexpr int STAT_THREADS = 256;

// packed bf16 DHWIO weights of the six layers
constexpr int W_OFF[7] = {0, 2187, 4374, 6561, 8748, 17496, 17739};

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
