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
// J is the direct conv body of merger_common.cuh (kernel I runs the
// same code), the 36-channel input as four 9-channel sources at a channel
// stride of 36, in one launch (the TPU slab kernel's split into 9-channel
// chunks is a lane budget, not the function).  Bound: at 24 volumes a
// 9 -> 9 layer is 3.4 GFLOP against 28 MB of input and output, so at the
// bf16 tensor-core rate it is bound by bytes (8.5 us); J runs f32 FMAs on
// the CUDA cores, which makes it bound by operations (51 us at 67
// TFLOP/s).
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

template <typename T>
int merger_conv(const void* x, const void* w, void* y, long long n, int cin,
                int cout, cudaStream_t s) {
  ConvArgsT<T> a{};
  const T* X = static_cast<const T*>(x);
  a.w = static_cast<const T*>(w);
  a.dst = y;
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
