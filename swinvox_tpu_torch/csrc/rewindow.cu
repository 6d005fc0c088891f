// Window-major relayout between Swin blocks in one pass (kernel A).
//
// Replaces the TPU kernel swinvox_tpu/ops/rewindow.py:_rewindow_kernel
// (through `rewindow`).  Given window-major tokens x [B*nWh*nWw, 49, C]
// of an image grid of nWh x nWw 7x7 windows, it computes
//
//   out = window_partition(roll(window_unpartition(x), sign*shift))
//
// i.e. sign = -1 maps the aligned layout to the one of the image rolled by
// -shift (what a shifted-window block wants), sign = +1 is the inverse.
//
// The TPU kernel did the token gather as four 0/1 selection-matrix
// matmuls because Mosaic cannot slice tokens at arbitrary sublane offsets.
// On Hopper it is a row permutation: every byte is read once and written
// once, so the kernel is bound by device memory (3.35 TB/s on an H100
// SXM: the JAX chain's 7 calls of a batch-32 serving forward move 2 x 53
// MB, 0.0316 ms at that rate).  The design keeps enough bytes in flight
// and spends few instructions a byte:
//
//   * four lanes (a quad) own one output row (window, token): they find
//     its source row once, with the window (7) a compile-time constant so
//     that the divisions by 7 and 49 are multiplies, and the two
//     divisions by the grid's runtime sizes (nWw, nWh) precomputed
//     multiply-shifts (fast_div.cuh);
//   * each lane then issues all of its row's loads (C*2/64 of 16 bytes:
//     3, 6 or 12 at C = 96, 192, 384, the channel count a template
//     constant) before its stores, so a row's loads are in flight
//     together; a warp's loads cover 8 rows of 64 contiguous bytes each;
//   * the grid is sized to the card (SMs x resident blocks, by the
//     occupancy API), each block walking the same number of 64-row groups.
//
// Rows and pointers must be 16-byte aligned (the wrapper checks; every
// stage of the model has C*2 bytes divisible by 16 in bf16).  Row
// indices are 32-bit (a call holds at most 2^31 - 1 rows).
//
// No model path of the port launches it: the port's Swin chain stays in
// the aligned layout and the shifted blocks' kernels (B, C, D) read their
// windows through this same map in their attention's loads
// (swin_tc.cuh, win_row).  It remains the counterpart of the JAX kernel,
// held against its plain version on the card.
//
// The C entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fast_div.cuh"

namespace {

constexpr int W = 7;          // the window: Swin-T's, the only one taken
constexpr int T = W * W;      // tokens a window
constexpr int THREADS = 256;  // 64 rows of a group, a quad each

// VPR: 16-byte vectors a token row (C * 2 / 16); 0 reads it at runtime.
template <int VPR>
__global__ void __launch_bounds__(THREADS)
    rewindow_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                    int rows, int vpr_rt, int nwh, int nww, FastDiv by_nww,
                    FastDiv by_nwh, int offset) {
  const int vpr = VPR ? VPR : vpr_rt;
  const int lane4 = threadIdx.x & 3;
  const int height = nwh * W, width = nww * W;
  const int step = gridDim.x * (THREADS / 4);
  for (int row = blockIdx.x * (THREADS / 4) + (threadIdx.x >> 2); row < rows;
       row += step) {
    // this output token's pixel (y, x) in its image ...
    const int win = row / T, t = row - win * T;
    const int strip = by_nww.div(win), wx = win - strip * nww;
    const int img = by_nwh.div(strip), wy = strip - img * nwh;
    const int ty = t / W, tx = t - ty * W;
    // ... reads pixel ((y + offset) mod H, (x + offset) mod W), with
    // |offset| < 7 <= H, W
    int ys = wy * W + ty + offset, xs = wx * W + tx + offset;
    ys += ys < 0 ? height : (ys >= height ? -height : 0);
    xs += xs < 0 ? width : (xs >= width ? -width : 0);
    const int yw = ys / W, xw = xs / W;
    const int src = ((img * nwh + yw) * nww + xw) * T + (ys - yw * W) * W +
                    (xs - xw * W);
    const uint4* s = x + (size_t)src * vpr + lane4;
    uint4* d = out + (size_t)row * vpr + lane4;
    if constexpr (VPR > 0) {
      constexpr int N = VPR / 4;
      uint4 v[N];
#pragma unroll
      for (int u = 0; u < N; ++u) v[u] = __ldg(s + 4 * u);
#pragma unroll
      for (int u = 0; u < N; ++u) d[4 * u] = v[u];
    } else {
      for (int u = 0; u < vpr - lane4; u += 4) d[u] = __ldg(s + u);
    }
  }
}

template <int VPR>
int launch(const void* x, void* out, int rows, int vpr, int nwh, int nww,
           int offset, cudaStream_t stream) {
  static int slots = 0;  // resident blocks on the card
  if (slots == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rewindow_kernel<VPR>, THREADS, 0);
    slots = sms * (per_sm > 0 ? per_sm : 1);
  }
  // groups of 64 rows; as few passes as the card allows, and the same
  // number of groups (to one) in every block
  const long long groups = (rows + THREADS / 4 - 1) / (THREADS / 4);
  const long long passes = (groups + slots - 1) / slots;
  const int blocks = (int)((groups + passes - 1) / passes);
  rewindow_kernel<VPR><<<blocks, THREADS, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), rows, vpr, nwh,
      nww, fast_div(nww), fast_div(nwh), offset);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* swinvox_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x, out: [n_windows, 49, row_bytes] bytes, 16-byte aligned, with
// row_bytes % 16 == 0; window 7, 0 < shift < 7, sign in {-1, +1}.
extern "C" int swinvox_rewindow(const void* x, void* out, long long n_windows,
                                int nwh, int nww, int window, int shift,
                                int sign, long long row_bytes, void* stream) {
  const long long rows = n_windows * T;
  if (rows == 0) return 0;
  if (window != W || nwh < 1 || nww < 1 || rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)out | (uintptr_t)row_bytes) % 16)
    return (int)cudaErrorMisalignedAddress;
  const int vpr = (int)(row_bytes / 16);
  const int offset = -sign * shift;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vpr) {
    case 12: return launch<12>(x, out, (int)rows, vpr, nwh, nww, offset, s);
    case 24: return launch<24>(x, out, (int)rows, vpr, nwh, nww, offset, s);
    case 48: return launch<48>(x, out, (int)rows, vpr, nwh, nww, offset, s);
    default: return launch<0>(x, out, (int)rows, vpr, nwh, nww, offset, s);
  }
}
