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
// head) runs swin_common.cuh's attention_tile, the device code kernel H's
// attention launch runs on its packed qkv: wmma QK^T and PV with tokens
// padded to 64 in shared memory only (pad keys get probability 0, pad
// query rows are never written), so the [T, T] scores never reach device
// memory.
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

#include "swin_common.cuh"

namespace {

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
