// Window-major relayout between Swin blocks in one pass (kernel A).
//
// Replaces the TPU kernel swinvox_tpu/ops/rewindow.py:_rewindow_kernel
// (through `rewindow`).  Given window-major tokens x [B*nWh*nWw, T, C]
// (T = window^2) of an image grid of nWh x nWw windows, it computes
//
//   out = window_partition(roll(window_unpartition(x), sign*shift))
//
// i.e. sign = -1 maps the aligned layout to the one of the image rolled by
// -shift (what a shifted-window block wants), sign = +1 is the inverse.
//
// The TPU kernel did the token gather as four 0/1 selection-matrix
// matmuls because Mosaic cannot slice tokens at arbitrary sublane offsets.
// On Hopper it is a plain gather: each thread owns one 16-byte vector of
// one output row (window, token), computes the source row from (nWh, nWw,
// window, shift, sign) and copies it.  Rows and pointers must be 16-byte
// aligned (the wrapper checks; every stage of the model has C*2 bytes
// divisible by 16 in bf16).  Every
// byte is read once and written once, so the kernel is bound by device
// memory bandwidth (3.35 TB/s on an H100 SXM): at batch 32 each call moves
// 2 x 19.3 MB, about 12 us at that roofline.  Rows stay contiguous along
// C, so a warp reads and writes whole 128-byte lines.  The index math is
// 32-bit (a call holds at most 2^30 vectors).
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

namespace {

__global__ void rewindow_kernel(const uint4* __restrict__ x,
                                uint4* __restrict__ out, int n_vec,
                                int vec_per_row, int nwh, int nww,
                                int window, int offset) {
  const int tokens = window * window;
  const int per_img = nwh * nww;
  const int height = nwh * window, width = nww * window;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
       i += gridDim.x * blockDim.x) {
    const int row = i / vec_per_row, vec = i - row * vec_per_row;
    const int win = row / tokens, t = row - win * tokens;
    const int img = win / per_img, w_in_img = win - img * per_img;
    const int wy = w_in_img / nww, ty = t / window;
    // global pixel of this output token in the output layout's image
    const int y = wy * window + ty;
    const int xx = (w_in_img - wy * nww) * window + (t - ty * window);
    // the pixel it reads: out(y, x) = in((y + offset) mod H, ...), with
    // |offset| < window <= H
    const int ys = (y + offset + height) % height;
    const int xs = (xx + offset + width) % width;
    const int yw = ys / window, xw = xs / window;
    const int src_row = (img * per_img + yw * nww + xw) * tokens +
                        (ys - yw * window) * window + (xs - xw * window);
    out[i] = x[(size_t)src_row * vec_per_row + vec];
  }
}

}  // namespace

extern "C" const char* swinvox_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x, out: [n_windows, window^2, row_bytes] bytes, 16-byte aligned, with
// row_bytes % 16 == 0; sign in {-1, +1}.
extern "C" int swinvox_rewindow(const void* x, void* out, long long n_windows,
                                int nwh, int nww, int window, int shift,
                                int sign, long long row_bytes, void* stream) {
  const long long rows = n_windows * window * window;
  if (rows == 0) return 0;
  if (((uintptr_t)x | (uintptr_t)out | (uintptr_t)row_bytes) % 16)
    return (int)cudaErrorMisalignedAddress;
  const int vec_per_row = (int)(row_bytes / sizeof(uint4));
  const long long n_vec = rows * vec_per_row;
  if (n_vec > (1LL << 30)) return (int)cudaErrorInvalidValue;  // 32-bit
  const int threads = 256;
  long long blocks = (n_vec + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  rewindow_kernel<<<(unsigned)blocks, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), (int)n_vec,
      vec_per_row, nwh, nww, window, -sign * shift);
  return (int)cudaGetLastError();
}
