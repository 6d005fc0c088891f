// Whole inference Swin block on window-major tokens (kernel B).
//
// Replaces the TPU kernel swinvox_tpu/ops/pallas_swin_block.py:
// _swin_block_kernel (through `fused_swin_block`).  For x [nW, T, C] bf16
// (T = 49 logical tokens, no padding; head_dim 32):
//
//   h   = bf16(LN1(x))                      f32 stats, biased variance
//   qkv = bf16(h @ Wqkv + bqkv)             [nW*T, 3C]
//   per (window, head):
//     s   = (q k^T) * 32^-0.5 + rel_bias[head] (+ mask[window % nW_img])
//     p   = bf16(softmax_f32(s))
//     ctx = bf16(p @ v)                     [nW*T, C]
//   x2  = f32(x) + (ctx @ Wproj + bproj)    f32
//   hid = bf16(gelu_erf(LN2(x2)_bf16 @ W1 + b1))   [nW*T, 4C]
//   out = bf16(x2 + (hid @ W2 + b2))
//
// with the TPU kernel's rounding points (its lines 74-149).  This first
// Hopper version is five launches per block call:
//
//   gemm<QKV>   LN1 prologue -> tensor-core GEMM -> +bias, bf16
//   attention   one block per (window, head): wmma QK^T and PV, tokens
//               padded to 64 in shared memory, f32 softmax
//   gemm<PROJ>  GEMM -> +bias +x residual, f32 x2
//   gemm<FC1>   LN2 prologue (from f32 x2) -> GEMM -> +bias, erf-GELU, bf16
//   gemm<FC2>   GEMM -> +bias +x2 residual, bf16 out
//
// The LN prologue takes each block's row statistics first and normalizes
// every A tile as it loads, so the normalized panel never sits whole in
// shared memory (27 KB per block, several blocks per SM).
//
// All five products run in this repository's own kernels (wmma bf16
// 16x16x16 tensor-core tiles with f32 accumulation; the GEMM and the
// attention core live in swin_common.cuh, shared with kernels G and H),
// none in cuBLAS.
//
// Work at serving batch 32 (224^2 input): every stage has tokens*C =
// 9.63M (stage 0: 100,352 tokens x 96), and a block is ~24*C^2 FLOP per
// token in its four GEMMs plus 4*49*C in attention: about 22 GFLOP per
// block call, ~270 GFLOP for the 12 block calls of a forward.  Its
// intermediates are large — the stage-0 4C hidden alone is 77 MB bf16 —
// and here they make a round trip through device memory between launches
// (qkv, ctx, x2, hidden: ~15 bytes/token/channel ~ 0.15 GB per block call
// at batch 32, ~45 us at 3.35 TB/s), while the GEMMs at the bf16 tensor
// core peak (989 TFLOP/s) would need ~22 us.  So the fused form is about
// balanced between bandwidth and compute; this simple version is bound
// by neither and by its own issue rate (wmma without a cp.async pipeline,
// one 64x64 tile per 128-thread block).  Fusing into one launch, wgmma
// and TMA are later work.
//
// Kernel C, the training forward (replaces
// pallas_swin_block.py:_swin_block_train_fwd_kernel through
// `fused_swin_block_train`), is the same five launches with two
// additions: per-window stochastic-depth factors dp1/dp2 [nW] f32 scale
// the two residual branches in the PROJ and FC2 epilogues
// (x2 = x + dp1 * attn, out = x2 + dp2 * mlp), and the launches save what
// kernel D (swin_block_train.cu) reads: the bf16 LN1/LN2 outputs and
// their row mean and 1/std (written by the column-0 blocks of the QKV and
// FC1 launches, which load every column of their rows), qkv, ctx, f32 x2,
// the f32 pre-GELU values and the bf16 GELU output.  Saving instead of
// recomputing costs 40 bytes per token-channel (~1.8 GB for the 12
// block calls of a batch-32 step) and no FLOPs.
//
// The C entry points return the first nonzero cudaGetLastError() of their
// launches.

#include "swin_common.cuh"

namespace {

// The five launches of one block call; the training pointers (dp1, dp2
// and the saves) are null at inference.
struct Train {
  const float *dp1, *dp2;
  bf16 *h1, *h2;
  float *stats1, *stats2, *pre;
};

int run_block(const void* x, const void* ln1s, const void* ln1b,
              const void* wqkv, const void* bqkv, const void* wproj,
              const void* bproj, const void* rel_bias, const void* mask,
              int nw_img, const void* ln2s, const void* ln2b, const void* w1,
              const void* b1, const void* w2, const void* b2, void* out,
              void* qkv, void* ctx, void* x2, void* hidden,
              long long n_windows, int tokens, int channels, int heads,
              float scale, float eps, const Train& tr, cudaStream_t s) {
  const int M = (int)(n_windows * tokens), C = channels;
  if (M == 0) return 0;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto b = [](const void* p) { return static_cast<const bf16*>(p); };
  int err;

  GemmArgs g{x, f(ln1s), f(ln1b), b(wqkv), f(bqkv), nullptr, qkv,
             M, 3 * C, C, eps, nullptr, tokens, tr.h1, tr.stats1, nullptr};
  if ((err = launch_gemm<QKV>(g, s))) return err;

  attention_kernel<<<dim3((unsigned)n_windows, heads), ATT_THREADS, 0, s>>>(
      b(qkv), f(rel_bias), f(mask), nw_img, static_cast<bf16*>(ctx), tokens,
      C, scale);
  if ((err = (int)cudaGetLastError())) return err;

  g = GemmArgs{ctx, nullptr, nullptr, b(wproj), f(bproj), x, x2,
               M, C, C, eps, tr.dp1, tokens, nullptr, nullptr, nullptr};
  if ((err = launch_gemm<PROJ>(g, s))) return err;

  g = GemmArgs{x2, f(ln2s), f(ln2b), b(w1), f(b1), nullptr, hidden,
               M, 4 * C, C, eps, nullptr, tokens, tr.h2, tr.stats2, tr.pre};
  if ((err = launch_gemm<FC1>(g, s))) return err;

  g = GemmArgs{hidden, nullptr, nullptr, b(w2), f(b2), x2, out,
               M, C, 4 * C, eps, tr.dp2, tokens, nullptr, nullptr, nullptr};
  return launch_gemm<FC2>(g, s);
}

}  // namespace

// Shapes: x/out [n_windows*tokens, C] bf16; weights bf16 row-major
// [in, out]; LN affines, biases, rel_bias [heads, T, T] and mask
// [nw_img, T, T] (or null) f32.  Scratch from the caller: qkv [., 3C] bf16,
// ctx [., C] bf16, x2 [., C] f32, hidden [., 4C] bf16.  The wrapper checks
// C % 32 == 0, C / heads == 32 and tokens <= 64.
extern "C" int swinvox_swin_block(
    const void* x, const void* ln1s, const void* ln1b, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj,
    const void* rel_bias, const void* mask, int nw_img, const void* ln2s,
    const void* ln2b, const void* w1, const void* b1, const void* w2,
    const void* b2, void* out, void* qkv, void* ctx, void* x2, void* hidden,
    long long n_windows, int tokens, int channels, int heads, float scale,
    float eps, void* stream) {
  const Train none{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                   nullptr};
  return run_block(x, ln1s, ln1b, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                   nw_img, ln2s, ln2b, w1, b1, w2, b2, out, qkv, ctx, x2,
                   hidden, n_windows, tokens, channels, heads, scale, eps,
                   none, static_cast<cudaStream_t>(stream));
}

// Kernel C.  As above plus dp1, dp2 [n_windows] f32, and the saved
// intermediates kernel D reads: h1, h2 [., C] bf16, stats1, stats2 [., 2]
// f32 (row mean, 1/std), qkv, ctx, x2, pre [., 4C] f32, hidden [., 4C] bf16.
extern "C" int swinvox_swin_block_train_fwd(
    const void* x, const void* dp1, const void* dp2, const void* ln1s,
    const void* ln1b, const void* wqkv, const void* bqkv, const void* wproj,
    const void* bproj, const void* rel_bias, const void* mask, int nw_img,
    const void* ln2s, const void* ln2b, const void* w1, const void* b1,
    const void* w2, const void* b2, void* out, void* h1, void* stats1,
    void* qkv, void* ctx, void* x2, void* h2, void* stats2, void* pre,
    void* hidden, long long n_windows, int tokens, int channels, int heads,
    float scale, float eps, void* stream) {
  const Train tr{static_cast<const float*>(dp1),
                 static_cast<const float*>(dp2), static_cast<bf16*>(h1),
                 static_cast<bf16*>(h2), static_cast<float*>(stats1),
                 static_cast<float*>(stats2), static_cast<float*>(pre)};
  return run_block(x, ln1s, ln1b, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                   nw_img, ln2s, ln2b, w1, b1, w2, b2, out, qkv, ctx, x2,
                   hidden, n_windows, tokens, channels, heads, scale, eps, tr,
                   static_cast<cudaStream_t>(stream));
}
