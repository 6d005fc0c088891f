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
// C, so a warp reads and writes whole 128-byte lines.
//
// The C entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void rewindow_kernel(const uint4* __restrict__ x,
                                uint4* __restrict__ out,
                                long long n_vec, int vec_per_row, int nwh,
                                int nww, int window, int offset) {
  const int tokens = window * window;
  const int per_img = nwh * nww;
  const int height = nwh * window, width = nww * window;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n_vec; i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / vec_per_row;
    const int vec = (int)(i - row * vec_per_row);
    const long long win = row / tokens;
    const int t = (int)(row - win * tokens);
    const long long img = win / per_img;
    const int w_in_img = (int)(win - img * per_img);
    // global pixel of this output token in the output layout's image
    const int y = (w_in_img / nww) * window + t / window;
    const int xx = (w_in_img % nww) * window + t % window;
    // the pixel it reads: out(y, x) = in((y + offset) mod H, ...)
    const int ys = ((y + offset) % height + height) % height;
    const int xs = ((xx + offset) % width + width) % width;
    const long long src_row =
        (img * per_img + (ys / window) * nww + xs / window) * tokens +
        (ys % window) * window + xs % window;
    out[i] = x[src_row * vec_per_row + vec];
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
  const int threads = 256;
  long long blocks = (n_vec + threads - 1) / threads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  rewindow_kernel<<<(unsigned)blocks, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), n_vec,
      vec_per_row, nwh, nww, window, -sign * shift);
  return (int)cudaGetLastError();
}
