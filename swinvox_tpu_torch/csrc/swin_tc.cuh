// Device code shared by the Swin block's forward (kernels B and C, and
// the fused W-MSA, kernel H, swin_block.cu) and backward (kernel D,
// swin_block_train.cu), both on the tensor-core blocks of mma_common.cuh:
//
//   * the shifted-window map: a stage's tokens stay in the aligned
//     window-major layout, and a shifted block's attention reads q, k, v
//     of shifted window w, token t from the aligned row that the cyclic
//     roll by -shift maps it to (and writes its results back there).
//     This is kernel A's gather (rewindow.cu, sign -1) folded into the
//     attention's own cp.async loads: no relayout pass, no extra byte;
//   * quad shuffles and bf16 packing for mma.sync accumulator fragments;
//   * vector loads and stores of 1, 2 or 4 values for row passes.
//
// Everything is in an anonymous namespace: each source that includes it
// gets its own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int HD = 32;          // head_dim of every Swin-T stage
constexpr int TMAX = 64;        // tokens of a window, padded, on chip
constexpr int ATT_THREADS = 128;
constexpr int ALD = HD + 8;     // bf16 row of a q, k, v (or dctx) tile

// The window grid of one image and the shift; shift 0 is the aligned
// layout (the identity map).
struct WinMap {
  int nwh, nww, win, shift;
};

// The map in two parts, so a thread pays the divisions once: a token's
// offsets (fixed for a thread over the windows it visits) and a window's
// origin.  The aligned row holding token t of shifted window w: pixel
// (y, x) of the image rolled by -shift is pixel ((y + shift) mod H,
// (x + shift) mod W) of the image.  32-bit index math: a call holds fewer
// than 2^31 rows.
struct TokOff {
  int t, y, x;  // token, its row and column in the window + shift
};

struct WinOrg {
  int w, img0, wy, wx;  // window, its image's first window, its position
};

__device__ __forceinline__ TokOff tok_off(const WinMap& m, int t) {
  if (m.shift == 0) return TokOff{t, 0, 0};
  const int ty = t / m.win;
  return TokOff{t, ty + m.shift, t - ty * m.win + m.shift};
}

__device__ __forceinline__ WinOrg win_org(const WinMap& m, int w) {
  if (m.shift == 0) return WinOrg{w, 0, 0, 0};
  const int per = m.nwh * m.nww;
  const int img = w / per, wi = w - img * per;
  const int wy = wi / m.nww;
  return WinOrg{w, img * per, wy, wi - wy * m.nww};
}

__device__ __forceinline__ int win_row(const WinMap& m, const WinOrg& o,
                                       const TokOff& k, int T) {
  if (m.shift == 0) return o.w * T + k.t;
  int wy = o.wy, wx = o.wx, y = k.y, x = k.x;
  if (y >= m.win) {  // the next window row, wrapping at the image's edge
    y -= m.win;
    if (++wy == m.nwh) wy = 0;
  }
  if (x >= m.win) {
    x -= m.win;
    if (++wx == m.nww) wx = 0;
  }
  return (o.img0 + wy * m.nww + wx) * T + y * m.win + x;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// An mma.sync accumulator row lies in one quad (4 lanes).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int V>
__device__ __forceinline__ void ld_vec(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void ld_vec(const bf16* p, float* v) {
  if constexpr (V == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const bf16* h = reinterpret_cast<const bf16*>(&t);
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = __bfloat162float(h[e]);
  } else if constexpr (V == 2) {
    const float2 t = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int V>
__device__ __forceinline__ void st_vec(float* p, const float* v) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (V == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *p = v[0];
}

template <int V>
__device__ __forceinline__ void st_vec(bf16* p, const float* v) {
  if constexpr (V == 4) {
    alignas(8) bf16 h[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = __float2bfloat16(v[e]);
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
  } else if constexpr (V == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    *p = __float2bfloat16(v[0]);
  }
}

// A row of C values split over a warp: lane holds C/32, VEC consecutive
// at a time (columns v * 32 * VEC + lane * VEC + e).
template <int C>
struct RowSplit {
  static constexpr int CPL = C / 32;
  static constexpr int VEC = CPL % 4 == 0 ? 4 : (CPL % 2 == 0 ? 2 : 1);
  static constexpr int NV = CPL / VEC;
  __device__ __forceinline__ static int col(int v, int lane) {
    return v * 32 * VEC + lane * VEC;
  }
};

}  // namespace
