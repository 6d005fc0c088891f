// Fused W-MSA: qkv projection, window attention and output projection
// (kernel H).
//
// Replaces the TPU kernel swinvox_tpu/ops/pallas_fused_msa.py:
// _fused_kernel (through `fused_window_msa`).  For x [nW, T, C] bf16
// (T <= 64 logical tokens, unpadded; head_dim 32):
//
//   qkv = bf16(x @ Wqkv + bqkv)                       [nW*T, 3C], f32 sums
//   per (window, head):
//     s   = (q k^T) * scale + rel_bias[head] (+ mask[window % nW_img])
//     ctx = bf16(bf16(softmax_f32(s)) @ v)            [nW*T, C]
//   out = bf16(ctx @ Wproj + bproj)
//
// with the TPU kernel's rounding points (its lines 31-89).  The TPU
// kernel pads T to 64 with a -1e9 bias on the pad keys; here tokens stay
// unpadded in device memory and the attention core pads them to 64 in
// shared memory only, with pad keys at probability 0 and pad query rows
// dropped, which is the unpadded function.  The mask of window w is
// mask[w % nW_img]: windows are image-major, as the TPU kernel's mask
// index map j % blocks_per_image assumes.
//
// Three launches, all in swin_common.cuh's device code (kernel B's first
// design, without its LayerNorm prologue and residual epilogues):
//
//   gemm         x @ Wqkv + bqkv -> bf16 qkv (wmma 64x64 tiles)
//   attention    one block per (window, head); the [T, T] scores stay in
//                shared memory
//   gemm         ctx @ Wproj + bproj -> bf16 out
//
// Work at the 12 Swin blocks of a 24-image forward: 8 * tokens * C^2 FLOP
// in the projections (5.55 GFLOP per block at every stage, tokens * C
// halving as C doubles) and 6.7 GFLOP of attention, 73.3 GFLOP in all
// (0.074 ms at the bf16 peak), against ~154 MB of x, out, weights and
// masks (0.046 ms at 3.35 TB/s): bound by operations.  qkv and ctx make a
// round trip through device memory between the launches (8 bytes per
// token-channel); one launch keeping them on chip is later work.
//
// The C entry point returns the first nonzero cudaGetLastError() of its
// launches.

#include "swin_common.cuh"

// x/out [n_windows*tokens, C] bf16; wqkv [C, 3C] and wproj [C, C] bf16
// row-major [in, out]; bqkv, bproj, rel_bias [heads, T, T] and mask
// [nw_img, T, T] (or null) f32.  Scratch from the caller: qkv [., 3C]
// and ctx [., C] bf16.  The wrapper checks C % 32 == 0, C / heads == 32
// and tokens <= 64.
extern "C" int swinvox_fused_msa(const void* x, const void* wqkv,
                                 const void* bqkv, const void* wproj,
                                 const void* bproj, const void* rel_bias,
                                 const void* mask, int nw_img, void* out,
                                 void* qkv, void* ctx, long long n_windows,
                                 int tokens, int channels, int heads,
                                 float scale, void* stream) {
  const int M = (int)(n_windows * tokens), C = channels;
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto b = [](const void* p) { return static_cast<const bf16*>(p); };
  int err;

  GemmArgs g{b(x), b(wqkv), f(bqkv), static_cast<bf16*>(qkv), M, 3 * C, C};
  if ((err = launch_gemm(g, s))) return err;

  attention_kernel<<<dim3((unsigned)n_windows, heads), ATT_THREADS, 0, s>>>(
      b(qkv), f(rel_bias), f(mask), nw_img, static_cast<bf16*>(ctx), tokens,
      C, scale);
  if ((err = (int)cudaGetLastError())) return err;

  g = GemmArgs{b(ctx), b(wproj), f(bproj), static_cast<bf16*>(out), M, C, C};
  return launch_gemm(g, s);
}
