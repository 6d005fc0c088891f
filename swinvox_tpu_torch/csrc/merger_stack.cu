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
// Kernel E is 12 launches: per layer one tensor-core conv
// (mstack_tc_conv_kernel, merger_mma.cuh) and one statistics launch.  A
// conv block walks a run of (volume, 2 planes, 8 rows) tiles: it stages
// the input halo in shared memory with 16 channels a position,
// normalizing on read (the previous layer's affine from the statistics
// buffer, LeakyReLU, bf16 rounding: the activation a_l is never stored;
// zero padding and padded channels stay zero in activation space), and
// runs each tap as a 16-deep slice of an implicit GEMM on mma.sync
// m16n8k16 (bf16 in, f32 accumulate); layer 4's four sources are four
// such slices, staged one after another.  The epilogue adds the bias,
// rounds to bf16 and sums each channel's rounded outputs and their
// squares into one partial a block; mstack_stats_kernel reduces the
// partials in parallel and in a fixed order (fixed_order_reduce) into
// the mean, variance and normalize affine.
//
// Kernel F walks layers 5 to 0.  For a BatchNorm layer l, with dA_l the
// gradient arriving at a_l (f32, accumulated from every consumer):
//   e = dA_l * leaky'(r_l * A_l + B_l),  xhat = (r_l - mean_l) * inv_l
//   dbeta_l = S1 = sum e,  dgamma_l = S2 = sum e * xhat
//   dr_l = gamma_l * inv_l * (e - S1 / n - xhat * S2 / n)   (bf16)
// A partial-sum launch and a finalize give S1, S2 and the layer's
// dr-on-read table; dr_l is never stored: its two consumers compute it
// where they stage it.  dW_l[tap][ci][co] = sum_v a_{l-1}[v + tap][ci]
// dr_l[v][co] runs on kernel K's tensor-core body
// (merger_wgrad_mma_kernel: a_{l-1} normalized on read from r_{l-1},
// layer 4's four sources, dr on read and db_l = sum dr_l beside it), and
// the input gradient on E's conv body with the flipped, channel-swapped
// kernel and dr on read, added into dA_{l-1} (layer 4: 9 -> 36, written
// into its four sources' dA; layer 0: dx in bf16).  Layer 5's input
// gradient (1 -> 9) gathers the 27 taps into the depth
// (mstack_tc_conv1_kernel).  Every sum is a per-block partial reduced in a
// fixed order: no atomics, the same bits on every launch.
//
// Kernel I (inference, replaces swinvox_tpu/ops/pallas_merger.py:
// _merger_kernel) runs E's six convs on the same tensor-core body
// (mstack_tc_conv_kernel, TC_INFER mode) with BatchNorm folded from the
// running statistics and the conv bias into a per-channel affine, applied
// in the epilogue to the unrounded f32 sum: a_l = bf16(leaky(z_l * s_l +
// t_l)), written once (the four that conv5 concatenates take 2.4 MB per
// volume, more than shared memory holds), six launches in all, f32 logits
// out.  The next layer reads the stored activations raw (layer 4: a_0..a_3
// as four sources, E's layer-4 path), the halo's out-of-volume positions
// and padded channels zero, never through an affine; E's normalize on
// read would round z to bf16 before the affine, which is E's function,
// not I's.  Bound: at 24 volumes the six convs are 27.9 GFLOP of their
// own (0.028 ms at 989 TFLOP/s; 92 GFLOP of padded tensor-core work)
// against 17 MB of input and output (5 us); like E's convs it is bound by
// the staging, the epilogues and mma.sync's operand traffic in shared
// memory.
//
// What bounds E and F on an H100: at N = 48 volumes (3 views, batch 16)
// the six convs are 1.57 M voxels x 35.5 k FLOP (56 GFLOP; 117.5 k FLOP
// a voxel, 184 GFLOP, once channels are padded for the tensor cores:
// 0.19 ms at 989 TFLOP/s), against about 0.2 GB moved each way (60 us at
// 3.35 TB/s); F is twice the products and reads the f32 dA where it
// computes dr.  The padding costs tensor-core work that is cheap next to
// the staging: phase 9 of chip_smoke.py reads the convs far under the
// tensor cores' rate, bound by staging, epilogues and the shared-memory
// traffic of mma.sync's operands.
//
// The C entry points return the first nonzero cudaGetLastError() of their
// launches.

#include "merger_mma.cuh"

namespace {

// packed bf16 DHWIO weights of the six layers
constexpr int W_OFF[7] = {0, 2187, 4374, 6561, 8748, 17496, 17739};

// Per-layer statistics from the conv blocks' partials [parts][2][cout]
// (one block, fixed-order reduce): stats[0] mean, [1] biased variance,
// and for a BatchNorm layer [2] the normalize scale and [3] shift, 9
// floats each.
__global__ void __launch_bounds__(RED_THREADS)
    mstack_stats_kernel(const float* __restrict__ partial, int parts,
                        int cout, float count,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta, float eps,
                        float* __restrict__ stats) {
  __shared__ float sums[18];
  fixed_order_reduce(partial, parts, 2 * cout, 2 * cout, sums, false, 0);
  __syncthreads();
  const int co = threadIdx.x;
  if (co >= cout) return;
  const float mean = sums[co] / count;
  const float var = sums[cout + co] / count - mean * mean;
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
                          const float* __restrict__ st, float leaky,
                          float eps, long long nvox,
                          float* __restrict__ partial) {
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

// S1 = dbeta, S2 = dgamma (one block, fixed-order reduce), and the layer's
// dr-on-read table (DR_TAB, merger_mma.cuh) for its two consumers.
__global__ void __launch_bounds__(RED_THREADS)
    mstack_bn_finalize_kernel(const float* __restrict__ partial, int parts,
                              const float* __restrict__ st,
                              const float* __restrict__ gamma, float eps,
                              float count, float* __restrict__ dgamma,
                              float* __restrict__ dbeta,
                              float* __restrict__ tab) {
  __shared__ float sums[18];
  fixed_order_reduce(partial, parts, 18, 18, sums, false, 0);
  __syncthreads();
  const int c = threadIdx.x;
  if (c >= 9) return;
  dbeta[c] = sums[c];
  dgamma[c] = sums[9 + c];
  const float inv = rsqrtf(st[9 + c] + eps);
  const float gi = gamma[c] * inv;
  tab[c] = st[18 + c];
  tab[9 + c] = st[27 + c];
  tab[18 + c] = gi;
  tab[27 + c] = gi * (inv * st[c] * sums[9 + c] - sums[c]) / count;
  tab[36 + c] = -gi * inv * sums[9 + c] / count;
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

// A bias gradient out[i] = sum_p part[p][i], i < n (n <= 32: one block),
// in a fixed order.
__global__ void __launch_bounds__(RED_THREADS)
    mstack_bias_sum_kernel(const float* __restrict__ part, int parts, int n,
                           float* __restrict__ out) {
  fixed_order_reduce(part, parts, n, n, out, false, 0);
}

long long max3(long long a, long long b, long long c) {
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

long long fwd_partial_floats(long long n) {
  return max3((long long)tc_grid<9, 1, 9, TC_FWD>(n) * 18,
              (long long)tc_grid<9, 4, 9, TC_FWD>(n) * 18,
              (long long)tc_grid<9, 1, 1, TC_FWD>(n) * 2);
}

long long bwd_partial_floats(long long n) {
  const long long wg = max3((long long)wgrad_grid<9, 9>(n) * 27 * 81,
                            (long long)wgrad_grid<36, 9>(n) * 27 * 324,
                            (long long)wgrad_grid<9, 1>(n) * 27 * 9);
  const long long bn = (n * V3 + BN_VOX - 1) / BN_VOX * 18;
  return wg > bn ? wg : bn;
}

// The bias-gradient partials: one per weight-gradient block, or per
// 2048 voxels of dr5.
long long db_partial_floats(long long n) {
  return max3((long long)wgrad_grid<9, 9>(n) * 9,
              (long long)wgrad_grid<36, 9>(n) * 9,
              (n * V3 + BN_VOX - 1) / BN_VOX);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" long long swinvox_merger_stack_fwd_workspace(long long n) {
  return (long long)align256(sizeof(float) * fwd_partial_floats(n));
}

// x [n, 32^3, 9] bf16 (16-byte aligned); w the six DHWIO kernels packed
// in bf16 (offsets W_OFF); bias [6][9], gamma, beta [5][9] f32.  Out:
// raws [5][n*32^3][9] bf16 (r_0..r_4), raw5 [n*32^3] bf16, stats [6][4][9]
// f32.
extern "C" int swinvox_merger_stack_fwd(
    const void* x, const void* w, const void* bias, const void* gamma,
    const void* beta, void* raws, void* raw5, void* stats, void* work,
    long long work_bytes, long long n, float leaky, float eps,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (work_bytes < swinvox_merger_stack_fwd_workspace(n))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(raws) || !aligned16(raw5))
    return (int)cudaErrorMisalignedAddress;
  const bf16* W = static_cast<const bf16*>(w);
  const float* bs = static_cast<const float*>(bias);
  const float* gm = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  bf16* R = static_cast<bf16*>(raws);
  float* st = static_cast<float*>(stats);
  float* part = static_cast<float*>(work);
  const size_t nv9 = (size_t)n * V3 * 9;
  const float count = (float)(n * V3);
  int err;
  auto finish = [&](int layer, int cout, int parts) {
    mstack_stats_kernel<<<1, RED_THREADS, 0, s>>>(
        part, parts, cout, count, layer < 5 ? gm + layer * 9 : nullptr,
        layer < 5 ? bt + layer * 9 : nullptr, eps, st + layer * 36);
    return (int)cudaGetLastError();
  };
  auto args = [&](int layer) {
    TcArgs a{};
    a.w = W + W_OFF[layer];
    a.bias = bs + layer * 9;
    a.partial = part;
    a.leaky = leaky;
    return a;
  };
  for (int l = 0; l < 4; ++l) {
    TcArgs a = args(l);
    a.src.p[0] = l == 0 ? static_cast<const bf16*>(x) : R + (l - 1) * nv9;
    a.src.aff[0] = l == 0 ? nullptr : st + (l - 1) * 36 + 18;
    a.dst[0] = R + l * nv9;
    if ((err = tc_conv<9, 1, 9, TC_FWD>(a, n, s))) return err;
    if ((err = finish(l, 9, tc_grid<9, 1, 9, TC_FWD>(n)))) return err;
  }
  {
    TcArgs a = args(4);
    for (int k = 0; k < 4; ++k) {
      a.src.p[k] = R + k * nv9;
      a.src.aff[k] = st + k * 36 + 18;
    }
    a.dst[0] = R + 4 * nv9;
    if ((err = tc_conv<9, 4, 9, TC_FWD>(a, n, s))) return err;
    if ((err = finish(4, 9, tc_grid<9, 4, 9, TC_FWD>(n)))) return err;
  }
  TcArgs a = args(5);
  a.src.p[0] = R + 4 * nv9;
  a.src.aff[0] = st + 4 * 36 + 18;
  a.dst[0] = raw5;
  if ((err = tc_conv<9, 1, 1, TC_FWD>(a, n, s))) return err;
  return finish(5, 1, tc_grid<9, 1, 1, TC_FWD>(n));
}

extern "C" long long swinvox_merger_stack_bwd_workspace(long long n) {
  const size_t nv9 = (size_t)n * V3 * 9;
  return (long long)(5 * align256(nv9 * 4) +
                     align256(sizeof(float) * bwd_partial_floats(n)) +
                     align256(sizeof(float) * db_partial_floats(n)) +
                     align256(sizeof(float) * DR_TAB));
}

// x, raws, stats, w as above, gamma [5][9]; d_raw5 [n*32^3] bf16; x,
// raws, d_raw5 and dx 16-byte aligned.  Out: dx [n*32^3][9] bf16; dw
// packed like w in f32; dbias [6][9] (layer 5: [5][0]), dgamma, dbeta
// [5][9] f32.
extern "C" int swinvox_merger_stack_bwd(
    const void* x, const void* raws, const void* stats, const void* w,
    const void* gamma, const void* d_raw5, void* dx, void* dw, void* dbias,
    void* dgamma, void* dbeta, void* work, long long work_bytes,
    long long n, float leaky, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (work_bytes < swinvox_merger_stack_bwd_workspace(n))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(raws) || !aligned16(d_raw5) ||
      !aligned16(dx) || !aligned16(work))
    return (int)cudaErrorMisalignedAddress;
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
  // dA_0..dA_3, then dA_4 (layer 4's adjoint writes the first four while
  // it reads dA_4)
  float* dA[5];
  for (int k = 0; k < 5; ++k) {
    dA[k] = reinterpret_cast<float*>(wb);
    wb += align256(nv9 * 4);
  }
  float* part = reinterpret_cast<float*>(wb);
  wb += align256(sizeof(float) * bwd_partial_floats(n));
  float* dbpart = reinterpret_cast<float*>(wb);
  wb += align256(sizeof(float) * db_partial_floats(n));
  float* tab = reinterpret_cast<float*>(wb);
  const int bn_blocks = (int)((nvox + BN_VOX - 1) / BN_VOX);
  int err;
  if ((err = (int)cudaMemsetAsync(DB, 0, 6 * 9 * sizeof(float), s)))
    return err;

  // ---- layer 5: dr5 is given
  const bf16* dr5 = static_cast<const bf16*>(d_raw5);
  mstack_sum1_kernel<<<bn_blocks, THREADS, 0, s>>>(dr5, nvox, dbpart);
  if ((err = (int)cudaGetLastError())) return err;
  mstack_bias_sum_kernel<<<1, RED_THREADS, 0, s>>>(dbpart, bn_blocks, 1,
                                                   DB + 5 * 9);
  if ((err = (int)cudaGetLastError())) return err;
  {
    Src g{};
    g.p[0] = R + 4 * nv9;
    g.aff[0] = st + 4 * 36 + 18;
    if ((err = wgrad_mma<9, 1, 1, false>(g, dr5, Src{}, n, leaky,
                                         DW + W_OFF[5], part, nullptr, s)))
      return err;
    if ((err = tc_conv1<TC_ADJ_INIT>(dr5, W + W_OFF[5], dA[4], n, s)))
      return err;
  }

  for (int l = 4; l >= 0; --l) {
    // ---- BatchNorm l backward: dgamma, dbeta and the dr-on-read table;
    // dr_l = f(r_l, dA_l) is computed where it is read
    const float* da = dA[l];
    const bf16* r = R + l * nv9;
    const float* sl = st + l * 36;
    mstack_bn_sums_kernel<<<bn_blocks, THREADS, 0, s>>>(r, da, sl, leaky,
                                                        eps, nvox, part);
    if ((err = (int)cudaGetLastError())) return err;
    mstack_bn_finalize_kernel<<<1, RED_THREADS, 0, s>>>(
        part, bn_blocks, sl, gm + l * 9, eps, count,
        static_cast<float*>(dgamma) + l * 9,
        static_cast<float*>(dbeta) + l * 9, tab);
    if ((err = (int)cudaGetLastError())) return err;

    // ---- conv l backward: dW_l and db_l, then the input gradient
    Src d{};  // dr_l on read
    d.p[0] = r;
    d.da = da;
    d.aff[0] = tab;
    Src g{};
    TcArgs a{};
    a.src = d;
    a.w = W + W_OFF[l];
    a.leaky = leaky;
    int grid;
    if (l == 4) {
      for (int k = 0; k < 4; ++k) {
        g.p[k] = R + k * nv9;
        g.aff[k] = st + k * 36 + 18;
        a.dst[k] = dA[k];
      }
      if ((err = wgrad_mma<36, 9, 4, true>(g, nullptr, d, n, leaky,
                                           DW + W_OFF[4], part, dbpart, s)))
        return err;
      grid = wgrad_grid<36, 9>(n);
    } else {
      g.p[0] = l > 0 ? R + (l - 1) * nv9 : static_cast<const bf16*>(x);
      g.aff[0] = l > 0 ? st + (l - 1) * 36 + 18 : nullptr;
      a.dst[0] = l > 0 ? static_cast<void*>(dA[l - 1]) : dx;
      if ((err = wgrad_mma<9, 9, 1, true>(g, nullptr, d, n, leaky,
                                          DW + W_OFF[l], part, dbpart, s)))
        return err;
      grid = wgrad_grid<9, 9>(n);
    }
    mstack_bias_sum_kernel<<<1, RED_THREADS, 0, s>>>(dbpart, grid, 9,
                                                     DB + l * 9);
    if ((err = (int)cudaGetLastError())) return err;
    if (l == 4)
      err = tc_conv<9, 1, 36, TC_ADJ_INIT>(a, n, s);
    else if (l > 0)
      err = tc_conv<9, 1, 9, TC_ADJ_ACC>(a, n, s);
    else
      err = tc_conv<9, 1, 9, TC_ADJ_DX>(a, n, s);
    if (err) return err;
  }
  return 0;
}

// Kernel I: the merger's six layers at inference (replaces
// swinvox_tpu/ops/pallas_merger.py:_merger_kernel through
// `merger_view_weights`).  x [n, 32^3, 9] bf16; w the six DHWIO kernels
// packed in bf16 (offsets W_OFF); fold [6][2][9] f32, per layer the
// BatchNorm folded from its running statistics with the conv bias,
// z * s + t (layer 5: element 0).  Each layer is one TC_INFER launch of
// the tensor-core conv: a_l = bf16(leaky(conv_l(a_{l-1}) * s_l + t_l))
// into the scratch acts [5][n*32^3][9] bf16 (conv5 reads a_0..a_3 as its
// four sources), and the last layer's f32 logits into out [n*32^3]; x,
// acts and out 16-byte aligned.
extern "C" int swinvox_merger_infer(const void* x, const void* w,
                                    const void* fold, void* acts, void* out,
                                    long long n, float leaky, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (!aligned16(x) || !aligned16(acts) || !aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  const bf16* W = static_cast<const bf16*>(w);
  const float* F = static_cast<const float*>(fold);
  bf16* A = static_cast<bf16*>(acts);
  const size_t nv9 = (size_t)n * V3 * 9;
  auto args = [&](int layer, void* dst) {
    TcArgs a{};
    a.w = W + W_OFF[layer];
    a.fold = F + layer * 18;
    a.dst[0] = dst;
    a.leaky = leaky;
    return a;
  };
  int err;
  for (int l = 0; l < 4; ++l) {
    TcArgs a = args(l, A + l * nv9);
    a.src.p[0] = l == 0 ? static_cast<const bf16*>(x) : A + (l - 1) * nv9;
    if ((err = tc_conv<9, 1, 9, TC_INFER>(a, n, s))) return err;
  }
  TcArgs a = args(4, A + 4 * nv9);
  for (int k = 0; k < 4; ++k) a.src.p[k] = A + k * nv9;
  if ((err = tc_conv<9, 4, 9, TC_INFER>(a, n, s))) return err;
  a = args(5, out);
  a.src.p[0] = A + 4 * nv9;
  return tc_conv<9, 1, 1, TC_INFER>(a, n, s);
}
