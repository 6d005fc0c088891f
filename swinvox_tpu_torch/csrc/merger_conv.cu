// One SAME 3x3x3 Conv3d of the merger, bias-free, for the training
// routes that run the merger layer by layer: the forward (kernel J) and
// the weight gradient (kernel K).
//
// Replaces the TPU kernels swinvox_tpu/ops/pallas_band_conv.py
// _conv_kernel and _wgrad_kernel (through `band_conv3d`, flag
// USE_PALLAS_MERGER_TRAIN) and swinvox_tpu/ops/pallas_slab_conv.py
// _fwd_kernel and _wgrad_kernel (through `slab_conv3d`, flag
// USE_SLAB_MERGER): both compute the same function on other TPU layouts.
// On V channels-last volumes x [V, 32, 32, 32, ci] (bf16 or f32):
//
//   J: y[v, p, co] = sum_tap sum_ci x[v, p + tap, ci] * W[tap, ci, co]
//      (zero padding 1), f32 sums of exact products, rounded once to the
//      element type; (ci, co) in {(9, 9), (36, 9), (9, 1)} and, for the
//      input gradients, the adjoint shapes (9, 36) and (1, 9): the input
//      gradient is J on dy with the flipped, channel-swapped kernel, as
//      both TPU kernels do it;
//   K: dW[tap, ci, co] = sum_v sum_p x[v, p + tap, ci] * dy[v, p, co] in
//      f32, for the three forward shapes: per-block partials, then a
//      fixed-order reduce (no atomics, so a resumed run and an
//      uninterrupted one get the same bits).
//
// J is the direct conv body of merger_common.cuh (kernels E, F and I run
// the same code), with no normalization on read, the 36-channel input as
// four 9-channel sources at a channel stride of 36, in one launch (the
// TPU slab kernel's split into 9-channel chunks is a lane budget, not the
// function).  Bound: at 24 volumes a 9 -> 9 layer is 3.4 GFLOP against
// 28 MB of input and output, so at the bf16 tensor-core rate it is bound
// by bytes (8.5 us); J runs f32 FMAs on the CUDA cores, which makes it
// bound by operations (51 us at 67 TFLOP/s).
//
// K in bf16 (mconv_wgrad_mma_kernel) is an implicit GEMM on the tensor
// cores: M = 27 x ci rows (tap, ci), N = co, and the depth K = every
// voxel of every volume.  What bounds it: the padded tensor-core work
// (ci to 16 or 48, co to 16 or 8) is about 11 us per 9 -> 9 call and its
// bytes 8.4 us, but the first version ran f32 FMAs on the CUDA cores with
// one shared load of dy per FMA (bound by shared-load issue, 45x its
// bound), reloaded each halo three times, and summed 384 partials per
// output serially.  Now:
//   * a block stages a (2 + 2) x (HT + 2) x 34 halo of x once per tile in
//     shared memory, channels padded with zeros to 16-channel groups of 32
//     bytes a voxel (the two 16-byte halves swizzled by bit 2 of the
//     position, so ldmatrix rows never share a bank), from 16-byte global
//     loads of whole w-rows (a row of 32 voxels is 64 x ci bytes, always
//     16-byte aligned), and the tile's dy beside it (co padded to 16 or 8);
//   * each tap's A fragment is a shifted window of that tile (ldmatrix
//     .trans of 16 consecutive positions), no im2col in device memory;
//   * nine warps, one per (kh, kw), each owning the three kd taps: per 16
//     voxels a warp loads dy's B fragment once and runs 3 x groups x n8
//     mma.sync m16n8k16 (bf16 products are exact in f32, so only the
//     order of the sums differs from the plain version);
//   * a fixed grid of about 132 x (blocks per SM) blocks walks contiguous
//     runs of tiles, accumulating in registers, and writes one 27 x ci x co
//     partial; mconv_wgrad_reduce_kernel sums the partials in parallel and
//     in a fixed order (fixed_order_reduce, mma_common.cuh): the same
//     inputs give the same bits on every launch.
// f32 inputs (only the f32 configurations send them) keep the CUDA-core
// body mstack_wgrad_kernel of merger_common.cuh, whose products and sums
// stay f32-exact.
//
// The C entry points return the first nonzero cudaGetLastError() of their
// launches.

#include "merger_common.cuh"
#include "mma_common.cuh"

namespace {

// ------------------------------------------------ kernel K, tensor cores
constexpr int KW_WARPS = 9;  // one per (kh, kw); each owns kd = 0, 1, 2
constexpr int KW_THREADS = 32 * KW_WARPS;
constexpr int KW_SMS = 132;  // H100 SXM

template <int CI, int CO>
struct Kw {
  static constexpr int NG = (CI + 15) / 16;  // 16-channel groups of x
  static constexpr int COP = CO > 8 ? 16 : 8;  // dy channels, padded
  static constexpr int NT = COP / 8;           // n8 tiles
  static constexpr int DT = 2, HT = NG == 1 ? 8 : 4;  // output tile
  static constexpr int DR = DT + 2, HR = HT + 2;      // halo rows
  static constexpr int NPOS = DR * HR * TW;           // halo positions
  static constexpr int VOX = DT * HT * S;             // output voxels
  static constexpr int X_ELEMS = NG * NPOS * 16;
  static constexpr size_t SMEM = sizeof(bf16) * (X_ELEMS + VOX * COP);
  static constexpr int TILES = (S / DT) * (S / HT);   // per volume
  static constexpr int PER_SM = NG == 1 ? 3 : 2;      // by shared memory
};

// Element offset of channel half `h` (0, 1) of halo position `pos` in
// group `g`: 16 channels a position, halves swapped by bit 2 of pos.
__device__ __forceinline__ int kw_x_off(int g, int npos, int pos, int h) {
  return (g * npos + pos) * 16 + ((h ^ ((pos >> 2) & 1)) << 3);
}

template <int COP>
__device__ __forceinline__ int kw_dy_off(int q, int h) {
  return COP == 16 ? q * 16 + ((h ^ ((q >> 2) & 1)) << 3) : q * 8;
}

// One block walks tiles [blockIdx.x * per, + per) of (volume, DT planes,
// HT rows) and writes its partial dW [27][CI][CO] to part[blockIdx.x].
template <int CI, int CO>
__global__ void __launch_bounds__(KW_THREADS, Kw<CI, CO>::PER_SM)
    mconv_wgrad_mma_kernel(const bf16* __restrict__ x,
                           const bf16* __restrict__ dy, int tiles, int per,
                           float* __restrict__ part) {
  using K = Kw<CI, CO>;
  extern __shared__ __align__(16) unsigned char kw_smem[];
  bf16* ksm = reinterpret_cast<bf16*>(kw_smem);
  bf16* xt = ksm;
  bf16* dyt = ksm + K::X_ELEMS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kh = warp / 3, kw = warp % 3;
  {  // zero once: padding channels and the w = -1, 32 columns stay zero
    uint4* z = reinterpret_cast<uint4*>(ksm);
    const int n16 = (int)(K::SMEM / 16);
    for (int i = tid; i < n16; i += KW_THREADS) z[i] = make_uint4(0, 0, 0, 0);
  }
  float acc[3][K::NG][K::NT][4];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int g = 0; g < K::NG; ++g)
#pragma unroll
      for (int t = 0; t < K::NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][g][t][e] = 0.f;

  const int t_end = min(tiles, ((int)blockIdx.x + 1) * per);
  for (int tile = (int)blockIdx.x * per; tile < t_end; ++tile) {
    const int v = tile / K::TILES, r = tile % K::TILES;
    const int d0 = (r / (S / K::HT)) * K::DT, h0 = (r % (S / K::HT)) * K::HT;
    __syncthreads();  // the previous tile's fragments are read
    // x halo rows: 16-byte loads of whole w-rows, scattered to 16-channel
    // groups (rows outside the volume write zeros)
    constexpr int XU = 4 * CI;  // uint4 per row of 32 voxels
    for (int i = tid; i < K::DR * K::HR * XU; i += KW_THREADS) {
      const int row = i / XU, u = i % XU;
      const int dd = row / K::HR, hh = row % K::HR;
      const int gd = d0 + dd - 1, gh = h0 + hh - 1;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (gd >= 0 && gd < S && gh >= 0 && gh < S)
        raw = reinterpret_cast<const uint4*>(
            x + ((((size_t)v * S + gd) * S + gh) * S) * CI)[u];
      const bf16* h8 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int el = u * 8 + e, w = el / CI, c = el % CI;
        const int pos = row * TW + w + 1;
        xt[kw_x_off(c >> 4, K::NPOS, pos, (c >> 3) & 1) + (c & 7)] = h8[e];
      }
    }
    constexpr int DU = 4 * CO;  // uint4 per output row of dy
    for (int i = tid; i < K::DT * K::HT * DU; i += KW_THREADS) {
      const int row = i / DU, u = i % DU;
      const int gd = d0 + row / K::HT, gh = h0 + row % K::HT;
      const uint4 raw = reinterpret_cast<const uint4*>(
          dy + ((((size_t)v * S + gd) * S + gh) * S) * CO)[u];
      const bf16* h8 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int el = u * 8 + e, w = el / CO, c = el % CO;
        dyt[kw_dy_off<K::COP>(row * S + w, c >> 3) + (c & 7)] = h8[e];
      }
    }
    __syncthreads();

    for (int step = 0; step < K::DT * K::HT * 2; ++step) {
      const int row = step >> 1, w0 = (step & 1) * 16;
      const int dd = row / K::HT, hh = row % K::HT;
      uint32_t b[K::NT][2];
      {
        const int j = lane >> 3, rr = lane & 7;
        if (K::COP == 16) {  // matrix j: k half j & 1, n half j >> 1
          const int q = row * S + w0 + rr + ((j & 1) << 3);
          uint32_t f[4];
          ldsm_x4_t(f, smem_u32(dyt + kw_dy_off<K::COP>(q, j >> 1)));
          b[0][0] = f[0];
          b[0][1] = f[1];
          b[K::NT - 1][0] = f[2];
          b[K::NT - 1][1] = f[3];
        } else {  // lanes 0-15: k half (lane >> 3) & 1
          const int q = row * S + w0 + rr + ((j & 1) << 3);
          ldsm_x2_t(b[0][0], b[0][1], smem_u32(dyt + kw_dy_off<K::COP>(q, 0)));
        }
      }
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
        const int pos0 = ((dd + kd) * K::HR + hh + kh) * TW + w0 + kw;
        // matrix j: k (voxel) half j >> 1, channel half j & 1
        const int pos = pos0 + (lane & 7) + ((lane >> 4) << 3);
        const int half = (lane >> 3) & 1;
#pragma unroll
        for (int g = 0; g < K::NG; ++g) {
          uint32_t a[4];
          ldsm_x4_t(a, smem_u32(xt + kw_x_off(g, K::NPOS, pos, half)));
#pragma unroll
          for (int t = 0; t < K::NT; ++t)
            mma_bf16(acc[kd][g][t], a, b[t][0], b[t][1]);
        }
      }
    }
  }
  // acc[kd][g][t][e]: ci = g*16 + lane/4 (+8 for e >= 2), co = t*8 +
  // (lane%4)*2 + (e&1); every (tap, ci, co) has one owner in the block
  float* out = part + (size_t)blockIdx.x * 27 * CI * CO;
#pragma unroll
  for (int kd = 0; kd < 3; ++kd) {
    const int tap = kd * 9 + kh * 3 + kw;
#pragma unroll
    for (int g = 0; g < K::NG; ++g)
#pragma unroll
      for (int t = 0; t < K::NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ci = g * 16 + (lane >> 2) + (e >> 1) * 8;
          const int co = t * 8 + (lane & 3) * 2 + (e & 1);
          if (ci < CI && co < CO)
            out[(tap * CI + ci) * CO + co] = acc[kd][g][t][e];
        }
  }
}

__global__ void __launch_bounds__(RED_THREADS)
    mconv_wgrad_reduce_kernel(const float* __restrict__ part, int parts,
                              int n, float* __restrict__ out) {
  fixed_order_reduce(part, parts, n, n, out, false, blockIdx.x);
}

// The grid of the tensor-core route: about KW_SMS x PER_SM blocks, each
// walking `per` contiguous tiles.
template <int CI, int CO>
void kw_plan(long long n, int* per, int* grid) {
  using K = Kw<CI, CO>;
  const long long tiles = n * K::TILES;
  const long long target = (long long)KW_SMS * K::PER_SM;
  const long long p = (tiles + target - 1) / target;
  *per = (int)p;
  *grid = (int)((tiles + p - 1) / p);
}

template <int CI, int CO>
int wgrad_mma(const bf16* x, const bf16* dy, long long n, float* dw,
              float* part, cudaStream_t s) {
  using K = Kw<CI, CO>;
  int per, grid;
  kw_plan<CI, CO>(n, &per, &grid);
  static const int attr = (int)cudaFuncSetAttribute(  // once per kernel
      mconv_wgrad_mma_kernel<CI, CO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::SMEM);
  if (attr) return attr;
  int err;
  mconv_wgrad_mma_kernel<CI, CO><<<grid, KW_THREADS, K::SMEM, s>>>(
      x, dy, (int)(n * K::TILES), per, part);
  if ((err = (int)cudaGetLastError())) return err;
  const int total = 27 * CI * CO;
  mconv_wgrad_reduce_kernel<<<reduce_blocks(total, grid), RED_THREADS, 0,
                              s>>>(
      part, grid, total, dw);
  return (int)cudaGetLastError();
}

long long wgrad_mma_partials(long long n, int cin, int cout) {
  int per, grid;
  if (cin == 36)
    kw_plan<36, 9>(n, &per, &grid);
  else if (cout == 1)
    kw_plan<9, 1>(n, &per, &grid);
  else
    kw_plan<9, 9>(n, &per, &grid);
  return (long long)grid * 27 * cin * cout;
}

template <typename T>
int merger_conv(const void* x, const void* w, void* y, long long n, int cin,
                int cout, cudaStream_t s) {
  ConvArgsT<T> a{};
  const T* X = static_cast<const T*>(x);
  a.w = static_cast<const T*>(w);
  a.dst[0] = y;
  const int nn = (int)n;
  if (cin == 36) {
    for (int k = 0; k < 4; ++k) a.src[k] = X + 9 * k;
    a.stride = 36;
    if (cout == 9) return conv<9, 4, 9, CONV, T>(a, nn, s);
    return (int)cudaErrorInvalidValue;
  }
  a.src[0] = X;
  if (cin == 9 && cout == 9) return conv<9, 1, 9, CONV, T>(a, nn, s);
  if (cin == 9 && cout == 1) return conv<9, 1, 1, CONV, T>(a, nn, s);
  if (cin == 9 && cout == 36) return conv<9, 1, 36, CONV, T>(a, nn, s);
  if (cin == 1 && cout == 9) return conv<1, 1, 9, CONV, T>(a, nn, s);
  return (int)cudaErrorInvalidValue;
}

// The f32 route: the CUDA-core body of merger_common.cuh.
template <typename T>
int merger_conv_wgrad(const void* x, const void* dy, float* dw, float* part,
                      long long n, int cin, int cout, cudaStream_t s) {
  WgradArgsT<T> g{};
  const T* X = static_cast<const T*>(x);
  g.dr = static_cast<const T*>(dy);
  g.partial = part;
  const int nn = (int)n;
  if (cin == 36 && cout == 9) {
    for (int k = 0; k < 4; ++k) g.src[k] = X + 9 * k;
    g.stride = 36;
    return wgrad<9, 4, 9, T>(g, nn, dw, s);
  }
  g.src[0] = X;
  if (cin == 9 && cout == 9) return wgrad<9, 1, 9, T>(g, nn, dw, s);
  if (cin == 9 && cout == 1) return wgrad<9, 1, 1, T>(g, nn, dw, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Kernel J.  x [n, 32^3, cin], w [27][cin][cout] (DHWIO), y [n, 32^3,
// cout], all of one element type: bf16 (is_bf16 = 1) or f32.
extern "C" int swinvox_merger_conv(const void* x, const void* w, void* y,
                                   long long n, int cin, int cout,
                                   int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  return is_bf16 ? merger_conv<bf16>(x, w, y, n, cin, cout, s)
                 : merger_conv<float>(x, w, y, n, cin, cout, s);
}

// The partials of kernel K: one 27 x cin x cout f32 block per grid block
// of the tensor-core route (bf16) or of the CUDA-core route (f32).
extern "C" long long swinvox_merger_conv_wgrad_workspace(long long n,
                                                         int cin, int cout,
                                                         int is_bf16) {
  const long long floats = is_bf16 ? wgrad_mma_partials(n, cin, cout)
                                   : (long long)wgrad_blocks(n) * 27 * cin *
                                         cout;
  return (long long)align256(sizeof(float) * floats);
}

// Kernel K.  x [n, 32^3, cin], dy [n, 32^3, cout] (bf16 or f32, x and dy
// 16-byte aligned); dw [27][cin][cout] f32; work:
// swinvox_merger_conv_wgrad_workspace bytes.
extern "C" int swinvox_merger_conv_wgrad(const void* x, const void* dy,
                                         void* dw, void* work,
                                         long long work_bytes, long long n,
                                         int cin, int cout, int is_bf16,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return (int)cudaMemsetAsync(dw, 0, sizeof(float) * 27 * cin *
                                                     cout, s);
  if (work_bytes < swinvox_merger_conv_wgrad_workspace(n, cin, cout,
                                                       is_bf16))
    return (int)cudaErrorInvalidValue;
  float* DW = static_cast<float*>(dw);
  float* part = static_cast<float*>(work);
  if (!is_bf16)
    return merger_conv_wgrad<float>(x, dy, DW, part, n, cin, cout, s);
  if (((uintptr_t)x | (uintptr_t)dy) & 15)
    return (int)cudaErrorMisalignedAddress;
  const bf16* X = static_cast<const bf16*>(x);
  const bf16* D = static_cast<const bf16*>(dy);
  if (cin == 9 && cout == 9) return wgrad_mma<9, 9>(X, D, n, DW, part, s);
  if (cin == 36 && cout == 9) return wgrad_mma<36, 9>(X, D, n, DW, part, s);
  if (cin == 9 && cout == 1) return wgrad_mma<9, 1>(X, D, n, DW, part, s);
  return (int)cudaErrorInvalidValue;
}
