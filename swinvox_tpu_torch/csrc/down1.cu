// The backward of the refiner's first conv, Conv3d(1 -> 32, k4, p2),
// bias-free (kernel L): the weight gradient and the input gradient from
// one cotangent.
//
// Replaces the TPU kernel swinvox_tpu/ops/pallas_down1.py _bwd_kernel
// (through `conv3d_down1`, flag REFINER_DOWN1_PALLAS); its forward stays
// the stock conv there and here.  From x [N, 32^3] (one channel), the
// kernel W [4, 4, 4, 32] (DHWIO with I = 1) and dy [N, 33^3, 32]
// (channels-last), all bf16 or all f32:
//
//   dW[kd, kh, kw, c] = sum_n sum_o x_pad[n, o + k] * dy[n, o, c]
//   dx[n, i] = sum_k sum_c dy[n, i + 2 - k, c] * W[k, c]   (0 <= o < 33)
//
// with x_pad the input padded by 2 on each side.  Two kernels and a
// reduce, one C call:
//
//   * the weight gradient: one block per (volume, output plane od, third
//     of the plane's 33 rows) reads its dy rows once into shared memory
//     (f32) with the 4 x 14 x 36 input window they meet; thread (c, warp)
//     sums 8 taps of channel c over the block's 11 x 33 outputs into a
//     per-block partial of the 64 x 32 gradient, which a fixed-order
//     reduce sums (no atomics: the same inputs give the same bits);
//   * the input gradient: one block per (volume, input plane, 8 rows),
//     one thread per input voxel, 2048 FMAs each: for each of the four
//     output planes the voxel reaches, the block stages 11 dy rows (all
//     33 columns, 32 channels, f32, column-padded so a tap's reads stay
//     in range) in shared memory.  The rows the blocks share come again
//     from L2, not from device memory (dy is 18 MB at 8 volumes).
//
// Both gradients sum exact products in f32; dx is rounded once to the
// element type, dW stays f32 (the caller rounds it to the kernel's
// dtype).  Any N works: the TPU kernel's padding to 16 volumes is its
// sublane layout.
//
// Bound: at N = 8 the backward is 1.1 G multiply-adds (2.2 GFLOP) against
// 18.4 MB of dy (bf16) and 1 MB of x and dx, so at the bf16 tensor-core
// rate it is bound by bytes (5.8 us); these f32 FMAs on the CUDA cores
// make it bound by operations (34 us at 67 TFLOP/s).
//
// The C entry point returns the first nonzero cudaGetLastError() of its
// launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int S = 32;             // input side
constexpr int SO = S + 1;         // output side (k4, p2)
constexpr int K = 4;              // kernel side
constexpr int C = 32;             // output channels
constexpr int NW = K * K * K * C; // 2048 weight-gradient entries
constexpr int THREADS = 256;
// weight gradient: 11 output rows per block, 3 blocks per plane
constexpr int WR = 11;
constexpr int WBLK = SO / WR;     // 3
constexpr int XR = WR + K - 1;    // 14 input rows
constexpr int XW = SO + K - 1;    // 36 input columns (-2 .. 33)
// input gradient: 8 input rows per block, 4 blocks per plane
constexpr int DR = 8;
constexpr int DBLK = S / DR;      // 4
constexpr int YR = DR + K - 1;    // 11 dy rows
constexpr int YW = SO + 2;        // 35 dy columns (-1 .. 33)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

size_t wgrad_smem() { return sizeof(float) * (WR * SO * C + K * XR * XW); }
size_t dx_smem() { return sizeof(float) * (YR * C * YW + NW); }
long long wgrad_blocks(long long n) { return n * SO * WBLK; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
    down1_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       float* __restrict__ partial) {
  extern __shared__ __align__(16) float sm[];
  float* dys = sm;                  // [WR][SO][C]
  float* xs = sm + WR * SO * C;     // [K][XR][XW]
  const int blk = blockIdx.x;
  const int n = blk / (SO * WBLK), od = (blk / WBLK) % SO;
  const int oh0 = (blk % WBLK) * WR;
  const int tid = threadIdx.x;

  // the block's dy rows are contiguous: [oh0, oh0 + WR) x 33 x 32
  const T* src = dy + (((size_t)n * SO + od) * SO + oh0) * SO * C;
  for (int i = tid; i < WR * SO * C; i += THREADS) dys[i] = to_f32(src[i]);
  for (int i = tid; i < K * XR * XW; i += THREADS) {
    const int kd = i / (XR * XW), r = (i / XW) % XR, col = i % XW;
    const int id = od + kd - 2, ih = oh0 + r - 2, iw = col - 2;
    float v = 0.f;
    if (id >= 0 && id < S && ih >= 0 && ih < S && iw >= 0 && iw < S)
      v = to_f32(x[(((size_t)n * S + id) * S + ih) * S + iw]);
    xs[i] = v;
  }
  __syncthreads();

  // thread: channel c, taps kd = warp / 2, kh in {kh0, kh0 + 1}, kw 0..3
  const int c = tid % 32, warp = tid / 32;
  const int kd = warp / 2, kh0 = (warp % 2) * 2;
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  for (int r = 0; r < WR; ++r) {
    const float* x0 = xs + (kd * XR + r + kh0) * XW;
    const float* x1 = x0 + XW;
    const float* g = dys + r * SO * C + c;
    for (int ow = 0; ow < SO; ++ow) {
      const float gv = g[ow * C];
#pragma unroll
      for (int kw = 0; kw < K; ++kw) {
        acc[kw] = fmaf(x0[ow + kw], gv, acc[kw]);
        acc[4 + kw] = fmaf(x1[ow + kw], gv, acc[4 + kw]);
      }
    }
  }
  float* part = partial + (size_t)blk * NW;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int kh = kh0 + j / 4, kw = j % 4;
    part[((kd * K + kh) * K + kw) * C + c] = acc[j];
  }
}

// out[i] = sum_b partial[b * NW + i], in order.
__global__ void down1_reduce_kernel(const float* __restrict__ partial,
                                    long long blocks,
                                    float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NW) return;
  float s = 0.f;
  for (long long b = 0; b < blocks; ++b) s += partial[b * NW + i];
  out[i] = s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    down1_dx_kernel(const T* __restrict__ w, const T* __restrict__ dy,
                    T* __restrict__ dx) {
  extern __shared__ __align__(16) float sm[];
  float* dys = sm;                  // [YR][C][YW]: row oh0 - 1 + ph,
                                    // column ow = j - 1
  float* ws = sm + YR * C * YW;     // [64][32]
  const int blk = blockIdx.x;
  const int n = blk / (S * DBLK), id = (blk / DBLK) % S;
  const int ih0 = (blk % DBLK) * DR;
  const int tid = threadIdx.x;
  const int r = tid / 32, col = tid % 32;  // the voxel (id, ih0 + r, col)

  for (int i = tid; i < NW; i += THREADS) ws[i] = to_f32(w[i]);
  float acc = 0.f;
  for (int kd = 0; kd < K; ++kd) {
    const int od = id + 2 - kd;
    if (od < 0 || od >= SO) continue;  // the same for the whole block
    __syncthreads();
    // global reads with c fastest (coalesced); shared writes at stride
    // YW = 35, coprime with the 32 banks
    for (int i = tid; i < YR * YW * C; i += THREADS) {
      const int c = i % C, j = (i / C) % YW, ph = i / (C * YW);
      const int oh = ih0 - 1 + ph, ow = j - 1;
      float v = 0.f;
      if (oh >= 0 && oh < SO && ow >= 0 && ow < SO)
        v = to_f32(dy[((((size_t)n * SO + od) * SO + oh) * SO + ow) * C + c]);
      dys[(ph * C + c) * YW + j] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kh = 0; kh < K; ++kh) {
      // oh = ih + 2 - kh, i.e. ph = r + 3 - kh in [0, YR)
      const float* row = dys + (r + 3 - kh) * C * YW;
#pragma unroll
      for (int kw = 0; kw < K; ++kw) {
        // ow = col + 2 - kw, i.e. j = col + 3 - kw in [0, YW)
        const float* y = row + col + 3 - kw;
        const float* wt = ws + ((kd * K + kh) * K + kw) * C;
#pragma unroll 8
        for (int c = 0; c < C; ++c) acc = fmaf(y[c * YW], wt[c], acc);
      }
    }
  }
  store(dx + (((size_t)n * S + id) * S + ih0 + r) * S + col, acc);
}

size_t align256(size_t b) { return (b + 255) / 256 * 256; }

template <typename T>
int down1_bwd(const void* x, const void* w, const void* dy, void* dx,
              float* dw, float* part, long long n, cudaStream_t s) {
  const T* X = static_cast<const T*>(x);
  const T* W = static_cast<const T*>(w);
  const T* DY = static_cast<const T*>(dy);
  int err = (int)cudaFuncSetAttribute(
      down1_wgrad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)wgrad_smem());
  if (err) return err;
  err = (int)cudaFuncSetAttribute(
      down1_dx_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dx_smem());
  if (err) return err;
  const long long wb = wgrad_blocks(n);
  down1_wgrad_kernel<T><<<(unsigned)wb, THREADS, wgrad_smem(), s>>>(X, DY,
                                                                     part);
  if ((err = (int)cudaGetLastError())) return err;
  down1_reduce_kernel<<<NW / 256, 256, 0, s>>>(part, wb, dw);
  if ((err = (int)cudaGetLastError())) return err;
  down1_dx_kernel<T><<<(unsigned)(n * S * DBLK), THREADS, dx_smem(), s>>>(
      W, DY, static_cast<T*>(dx));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long swinvox_down1_bwd_workspace(long long n) {
  return (long long)align256(sizeof(float) * wgrad_blocks(n) * NW);
}

// Kernel L.  x [n, 32^3], w [64][32], dy [n, 33^3, 32], dx [n, 32^3]: bf16
// (is_bf16 = 1) or f32; dw [64][32] f32; work:
// swinvox_down1_bwd_workspace bytes.
extern "C" int swinvox_down1_bwd(const void* x, const void* w, const void* dy,
                                 void* dx, void* dw, void* work,
                                 long long work_bytes, long long n,
                                 int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return (int)cudaMemsetAsync(dw, 0, sizeof(float) * NW, s);
  if (work_bytes < swinvox_down1_bwd_workspace(n))
    return (int)cudaErrorInvalidValue;
  float* DW = static_cast<float*>(dw);
  float* part = static_cast<float*>(work);
  return is_bf16 ? down1_bwd<bf16>(x, w, dy, dx, DW, part, n, s)
                 : down1_bwd<float>(x, w, dy, dx, DW, part, n, s);
}
