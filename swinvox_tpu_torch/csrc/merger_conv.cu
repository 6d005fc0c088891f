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
// J in bf16 runs on merger_mma.cuh's tensor-core conv body, the one
// kernels E, F and I run: an implicit GEMM, M = 16 consecutive w positions
// of one (volume, d, h) row, N = co padded to 8 or 16 (40 for 9 -> 36),
// the depth one 16-channel group of a tap, mma.sync m16n8k16 (bf16 in,
// f32 accumulate), the halo staged in shared memory with 16 channels a
// position; TC_CONV mode: raw rows, no bias, no statistics, the f32 sum
// rounded once to bf16.  9 -> 9, 9 -> 1 and 9 -> 36 copy a tile's input
// rows with cp.async while the previous tile multiplies.  The 36-channel
// input is one interleaved tensor [V][32^3][36] (the merger's concat of
// four activations), staged as three 16-channel groups over the
// concatenated channels (36 -> 48, one after another in the halo): a
// position's group is 32 contiguous bytes, read with 8-byte loads, and
// the depth pads to 48 where four 9-channel slices would pad to 64 and
// need 2-byte loads at a channel stride of 36 (E's four separate sources
// at a stride of 9 read another tensor).  9 -> 36 writes one interleaved
// bf16 output, n padded to 40; 1 -> 9 gathers the 27 taps into the depth
// (27 -> 32) on the kernel as the host passed it.  Each output voxel is
// written by one block (no split of the depth, no atomics): two launches
// on the same inputs give the same bits.  Bound: at 24 volumes a 9 -> 9
// call is 3.4 GFLOP against 28 MB of input and output, bound by bytes at
// the bf16 tensor-core rate (8.5 us); the body runs the padded work (16 x
// 16 a tap and voxel, 3.2x the conv's own) and is bound by the staging,
// the epilogue and mma.sync's operand traffic in shared memory, far
// above that (chip_smoke.py --merger-conv reads it).  f32 inputs (only
// the f32 configurations send them) keep the CUDA-core direct conv of
// merger_common.cuh, whose sums stay f32-exact.
//
// K in bf16 is merger_wgrad_mma_kernel of merger_mma.cuh (kernel F runs
// the same body), an implicit GEMM on the tensor cores: M = 27 x ci rows
// (tap, ci), N = co, and the depth K = every voxel of every volume.
// What bounds it: the padded tensor-core work (ci to 16 or 48, co to 16
// or 8) is about 11 us per 9 -> 9 call and its bytes 8.4 us; a block
// stages a (2 + 2) x (HT + 2) x 34 halo of x once per tile in shared
// memory (16 channels a position, swizzled), each tap's A fragment is a
// shifted window of it (ldmatrix .trans), nine warps, one per (kh, kw),
// each own the three kd taps, and a fixed grid of about 132 x (blocks per
// SM) blocks writes one partial a block, summed in parallel and in a
// fixed order (fixed_order_reduce, mma_common.cuh): the same inputs give
// the same bits on every launch.  f32 inputs (only the f32 configurations
// send them) keep the CUDA-core body mstack_wgrad_kernel of
// merger_common.cuh, whose products and sums stay f32-exact.
//
// The C entry points return the first nonzero cudaGetLastError() of their
// launches.

#include "merger_mma.cuh"

namespace {

// The partials of kernel K's tensor-core route: one 27 x cin x cout block
// per grid block.
long long wgrad_mma_partials(long long n, int cin, int cout) {
  int grid;
  if (cin == 36)
    grid = wgrad_grid<36, 9>(n);
  else if (cout == 1)
    grid = wgrad_grid<9, 1>(n);
  else
    grid = wgrad_grid<9, 9>(n);
  return (long long)grid * 27 * cin * cout;
}

// Kernel J's bf16 route: the tensor-core body (TC_CONV).
int merger_conv_tc(const bf16* x, const bf16* w, bf16* y, long long n,
                   int cin, int cout, cudaStream_t s) {
  if (cin == 1 && cout == 9) return tc_conv1<TC_CONV>(x, w, y, n, s);
  TcArgs a{};
  a.src.p[0] = x;
  a.w = w;
  a.dst[0] = y;
  if (cin == 9 && cout == 9) return tc_conv<9, 1, 9, TC_CONV>(a, n, s);
  if (cin == 36 && cout == 9) return tc_conv<36, 1, 9, TC_CONV>(a, n, s);
  if (cin == 9 && cout == 1) return tc_conv<9, 1, 1, TC_CONV>(a, n, s);
  if (cin == 9 && cout == 36) return tc_conv<9, 1, 36, TC_CONV>(a, n, s);
  return (int)cudaErrorInvalidValue;
}

// Kernel J's f32 route: the CUDA-core direct conv of merger_common.cuh,
// the 36-channel input as four 9-channel sources at a channel stride of
// 36.
int merger_conv_f32(const float* x, const float* w, float* y, long long n,
                    int cin, int cout, cudaStream_t s) {
  ConvArgs a{};
  a.w = w;
  a.dst = y;
  const int nn = (int)n;
  if (cin == 36) {
    for (int k = 0; k < 4; ++k) a.src[k] = x + 9 * k;
    a.stride = 36;
    if (cout == 9) return conv<9, 4, 9>(a, nn, s);
    return (int)cudaErrorInvalidValue;
  }
  a.src[0] = x;
  if (cin == 9 && cout == 9) return conv<9, 1, 9>(a, nn, s);
  if (cin == 9 && cout == 1) return conv<9, 1, 1>(a, nn, s);
  if (cin == 9 && cout == 36) return conv<9, 1, 36>(a, nn, s);
  if (cin == 1 && cout == 9) return conv<1, 1, 9>(a, nn, s);
  return (int)cudaErrorInvalidValue;
}

// Kernel K's f32 route: the CUDA-core body of merger_common.cuh.
int merger_conv_wgrad_f32(const float* x, const float* dy, float* dw,
                          float* part, long long n, int cin, int cout,
                          cudaStream_t s) {
  WgradArgs g{};
  const float* X = x;
  g.dr = dy;
  g.partial = part;
  const int nn = (int)n;
  if (cin == 36 && cout == 9) {
    for (int k = 0; k < 4; ++k) g.src[k] = X + 9 * k;
    g.stride = 36;
    return wgrad<9, 4, 9>(g, nn, dw, s);
  }
  g.src[0] = X;
  if (cin == 9 && cout == 9) return wgrad<9, 1, 9>(g, nn, dw, s);
  if (cin == 9 && cout == 1) return wgrad<9, 1, 1>(g, nn, dw, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Kernel J.  x [n, 32^3, cin], w [27][cin][cout] (DHWIO), y [n, 32^3,
// cout], all of one element type: bf16 (is_bf16 = 1; x and y 16-byte
// aligned) or f32.
extern "C" int swinvox_merger_conv(const void* x, const void* w, void* y,
                                   long long n, int cin, int cout,
                                   int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (!is_bf16)
    return merger_conv_f32(static_cast<const float*>(x),
                           static_cast<const float*>(w),
                           static_cast<float*>(y), n, cin, cout, s);
  if (((uintptr_t)x | (uintptr_t)y) & 15)
    return (int)cudaErrorMisalignedAddress;
  return merger_conv_tc(static_cast<const bf16*>(x),
                        static_cast<const bf16*>(w), static_cast<bf16*>(y),
                        n, cin, cout, s);
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
    return merger_conv_wgrad_f32(static_cast<const float*>(x),
                                 static_cast<const float*>(dy), DW, part, n,
                                 cin, cout, s);
  if (((uintptr_t)x | (uintptr_t)dy) & 15)
    return (int)cudaErrorMisalignedAddress;
  Src src{};  // one source of cin channels, raw
  src.p[0] = static_cast<const bf16*>(x);
  const bf16* D = static_cast<const bf16*>(dy);
  if (cin == 9 && cout == 9)
    return wgrad_mma<9, 9, 1, false>(src, D, Src{}, n, 0.f, DW, part,
                                       nullptr, s);
  if (cin == 36 && cout == 9)
    return wgrad_mma<36, 9, 1, false>(src, D, Src{}, n, 0.f, DW, part,
                                       nullptr, s);
  if (cin == 9 && cout == 1)
    return wgrad_mma<9, 1, 1, false>(src, D, Src{}, n, 0.f, DW, part,
                                       nullptr, s);
  return (int)cudaErrorInvalidValue;
}
