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
// with the TPU kernel's rounding points (scores and softmax in f32,
// probabilities cast to v's dtype, the product accumulated in f32).
//
// What bounds it on an H100: at the 12 Swin blocks of a 24-image forward
// it runs 6.7 GFLOP against 275 MB of q, k, v and out (each (window,
// head) item is four 3136-byte tiles): bound by bytes (0.082 ms at 3.35
// TB/s; the FLOPs take 0.007 ms at the bf16 tensor-core peak).  So the
// design moves each item's bytes once, keeps them in flight, and spends
// no other traffic:
//
//   * items are taken in the order (head h, window slot j = w mod nW_img,
//     image), and each block walks one contiguous run of them, so the
//     f32 rel_bias[h] and mask[j] (9.6 KB each) are staged once per run
//     of items that share them (a block meets one or two such runs), not
//     once per item: into shared memory by cp.async, then each thread
//     keeps its own entries, (bias + mask) log2 e, in registers for the
//     run's items (they are the same for every item); without a mask a
//     run shares h;
//   * q, k, v arrive by cp.async into shared memory (16-byte chunks of
//     each 64-byte token row swizzled by (row / 2) mod 4, so ldmatrix
//     reads 8 rows without bank conflicts), double-buffered: the next
//     item's loads are in flight while the tensor cores work on this
//     one; pad rows T..63 are zero;
//   * 4 warps, each owning 16 query rows, run S = Q K^T on mma.sync
//     m16n8k16 (7 key tiles of 8 for T <= 56, else 8; T = 49 a template
//     constant); the scores stay in registers: one FMA a score adds the
//     run's bias and mask in base 2, the softmax's max and sum by quad
//     shuffles, exp2 of the difference, one reciprocal a row (96
//     registers: 5 blocks an SM); P is rounded to bf16 and reused in
//     registers as the A operand of P V (an accumulator pair of key tiles
//     is an A fragment), V read by ldmatrix.trans; the output is written
//     from the accumulator fragments as bf16 pairs, rows < T only;
//   * the grid is sized to the card (SMs x resident blocks, by the
//     occupancy API), each block taking the same number of items to one.
//
// The backward stays the plain recompute (ops/pallas_window_attention.py),
// as the JAX VJP is an XLA recompute with no Pallas kernel.
//
// The C entry point returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fast_div.cuh"
#include "mma_common.cuh"

namespace {

constexpr int HD = 32;           // head_dim of every Swin-T stage
constexpr int TP = 64;           // token rows a tile holds
constexpr int ROW = HD * 2;      // bytes of one token row
constexpr int TILE = TP * ROW;   // bytes of one q, k or v tile
constexpr int G_THREADS = 128;   // 4 warps of 16 query rows
constexpr int STAGES = 2;        // q, k, v tiles of this item and the next
constexpr float LOG2E = 1.4426950408889634f;

// byte offset of 16-byte chunk c (0..3) of token row r in a tile
__device__ __forceinline__ int swz(int r, int c) {
  return r * ROW + ((c ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}

// an mma.sync accumulator row lies in one quad (4 lanes)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// shared memory: STAGES items' q, k, v tiles, then rel_bias[h] and
// mask[j] of the current run ([T, T] f32 each; the mask's only when
// there is one)
inline size_t smem_bytes(int tokens, bool masked) {
  return (size_t)STAGES * 3 * TILE +
         (masked ? 2 : 1) * (size_t)tokens * tokens * 4;
}

// The items: e < n_items = nW * heads in the order (head h, window slot
// j, image); run g = e / per_run is (h, j) = (g / slots, g mod slots)
// with slots = nW_img (1 without a mask), per_run = nW / slots images.
struct Items {
  int n, heads, slots;
  FastDiv by_run, by_slots;
  // element offset of item e's [T, 32] tile in q, k, v and out
  __device__ __forceinline__ int run(int e) const { return by_run.div(e); }
  __device__ __forceinline__ long long offset(int e, int per_run,
                                              int tokens) const {
    const int g = run(e), img = e - g * per_run;
    const int h = by_slots.div(g), j = g - h * slots;
    return ((long long)(img * slots + j) * heads + h) * tokens * HD;
  }
};

// NT: key tiles of 8 columns (7 for T <= 56, else 8); TT: the tokens a
// window as a constant (49), or 0 to read them at runtime (T <= 64)
template <int NT, int TT, bool MASKED>
__global__ void __launch_bounds__(G_THREADS, 5)
    head_major_attention_kernel(const bf16* __restrict__ q,
                                const bf16* __restrict__ k,
                                const bf16* __restrict__ v,
                                const float* __restrict__ rel_bias,
                                const float* __restrict__ mask,
                                bf16* __restrict__ out, Items items,
                                int per_run, int t_rt, float scale) {
  const int T = TT ? TT : t_rt;
  extern __shared__ __align__(128) unsigned char smem[];
  float* const bias_s = reinterpret_cast<float*>(smem + STAGES * 3 * TILE);
  float* const mask_s = bias_s + T * T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // this block's items [e0, e1)
  const int e0 = (int)((long long)blockIdx.x * items.n / gridDim.x);
  const int e1 = (int)((long long)(blockIdx.x + 1) * items.n / gridDim.x);

  // pad rows T..63 of every stage read as zero (cp.async writes rows < T)
  for (int i = tid; i < STAGES * 3 * (TP - T) * 4; i += G_THREADS) {
    const int c = i & 3, r = T + (i >> 2) % (TP - T), t = (i >> 2) / (TP - T);
    *reinterpret_cast<uint4*>(smem + t * TILE + swz(r, c)) =
        make_uint4(0, 0, 0, 0);
  }

  auto load_item = [&](int e) {
    const int st = (e - e0) % STAGES;
    const long long off = items.offset(e, per_run, T);
    const bf16* src[3] = {q + off, k + off, v + off};
#pragma unroll
    for (int a = 0; a < 3; ++a)
      for (int i = tid; i < T * 4; i += G_THREADS)
        cp_async16(smem_u32(smem + (st * 3 + a) * TILE + swz(i >> 2, i & 3)),
                   src[a] + (i >> 2) * HD + (i & 3) * 8, true);
  };
  // the run's bias and mask by cp.async (4 bytes a copy: a head's [T, T]
  // f32 block starts at any 4-byte boundary), all in flight together
  auto load_run = [&](int g) {
    const int h = items.by_slots.div(g), j = g - h * items.slots;
    const float* b = rel_bias + (long long)h * T * T;
    for (int i = tid; i < T * T; i += G_THREADS)
      cp_async4(smem_u32(bias_s + i), b + i);
    if (MASKED) {
      const float* m = mask + (long long)j * T * T;
      for (int i = tid; i < T * T; i += G_THREADS)
        cp_async4(smem_u32(mask_s + i), m + i);
    }
  };

  // prologue: the first STAGES - 1 items in flight
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (e0 + p < e1) load_item(e0 + p);
    cp_async_commit();
  }
  const float scale2 = scale * LOG2E;  // exp(x) = 2^(x log2 e)
  float bm[NT][4];  // the run's bias (+ mask) at this thread's entries
  int run = -1;
  for (int e = e0; e < e1; ++e) {
    const bool new_run = items.run(e) != run;
    if (new_run) {  // a new run: its bias (and mask), a group of its own
      run = items.run(e);
      load_run(run);
      cp_async_commit();
    }
    if (e + STAGES - 1 < e1) load_item(e + STAGES - 1);
    cp_async_commit();  // (an empty group past the end keeps the count)
    // item e's tiles (and the run's) have landed; later items may fly
    if (new_run)
      cp_async_wait<1>();
    else
      cp_async_wait<STAGES - 1>();
    __syncthreads();

    const int r0 = warp * 16, st = (e - e0) % STAGES;
    const int g = lane >> 2, t4 = lane & 3, mi = lane >> 3;
    if (new_run && r0 < T) {
      // this thread's (bias + mask) log2 e, rows r0 + g and r0 + g + 8,
      // columns 8n + 2 t4 (+1), held in registers for the run's items:
      // the same entries for every item of the run (-inf past T keys)
      const int ra = min(r0 + g, T - 1) * T, rb = min(r0 + g + 8, T - 1) * T;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int c = 8 * n + 2 * t4 + e2;
          float xa = -INFINITY, xb = -INFINITY;
          if (c < T) {
            xa = bias_s[ra + c];
            xb = bias_s[rb + c];
            if (MASKED) {
              xa += mask_s[ra + c];
              xb += mask_s[rb + c];
            }
            xa *= LOG2E;
            xb *= LOG2E;
          }
          bm[n][e2] = xa;
          bm[n][2 + e2] = xb;
        }
      }
    }
    if (r0 < T) {
      const uint32_t qs = smem_u32(smem + (st * 3 + 0) * TILE);
      const uint32_t ks = smem_u32(smem + (st * 3 + 1) * TILE);
      const uint32_t vs = smem_u32(smem + (st * 3 + 2) * TILE);

      // S = Q K^T: rows r0 + g and r0 + g + 8, columns 8n + 2 t4 (+1)
      uint32_t qa[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        ldsm_x4(qa[kk], qs + swz(r0 + (lane & 7) + (mi & 1) * 8,
                                 kk * 2 + (mi >> 1)));
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t kb[4];
        ldsm_x4(kb, ks + swz(8 * n + (lane & 7), mi));
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        mma_bf16(s[n], qa[0], kb[0], kb[1]);
        mma_bf16(s[n], qa[1], kb[2], kb[3]);
      }

      // softmax over the T real keys in f32, per row, in base 2: x = (s
      // scale + bias + mask) log2 e, p = 2^(x - max x) / sum
      float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = fmaf(s[n][i], scale2, bm[n][i]);
        ma = fmaxf(ma, fmaxf(s[n][0], s[n][1]));
        mb = fmaxf(mb, fmaxf(s[n][2], s[n][3]));
      }
      ma = quad_max(ma);
      mb = quad_max(mb);
      float suma = 0.f, sumb = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[n][0] = ex2(s[n][0] - ma);
        s[n][1] = ex2(s[n][1] - ma);
        s[n][2] = ex2(s[n][2] - mb);
        s[n][3] = ex2(s[n][3] - mb);
        suma += s[n][0] + s[n][1];
        sumb += s[n][2] + s[n][3];
      }
      const float ia = 1.f / quad_sum(suma), ib = 1.f / quad_sum(sumb);

      // O = P V, P from the score registers as bf16 A fragments
      float o[4][4] = {};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0] * ia, s[2 * kk][1] * ia);
        pa[1] = pack_bf16(s[2 * kk][2] * ib, s[2 * kk][3] * ib);
        if (2 * kk + 1 < NT) {
          pa[2] = pack_bf16(s[2 * kk + 1][0] * ia, s[2 * kk + 1][1] * ia);
          pa[3] = pack_bf16(s[2 * kk + 1][2] * ib, s[2 * kk + 1][3] * ib);
        } else {
          pa[2] = pa[3] = 0u;
        }
#pragma unroll
        for (int dt = 0; dt < 2; ++dt) {
          uint32_t vb[4];
          ldsm_x4_t(vb, vs + swz(16 * kk + (lane & 7) + (mi & 1) * 8,
                                 2 * dt + (mi >> 1)));
          mma_bf16(o[2 * dt], pa, vb[0], vb[1]);
          mma_bf16(o[2 * dt + 1], pa, vb[2], vb[3]);
        }
      }
      bf16* dst = out + items.offset(e, per_run, T);
#pragma unroll
      for (int nd = 0; nd < 4; ++nd) {
        const int c = 8 * nd + 2 * t4;
        if (r0 + g < T)
          *reinterpret_cast<uint32_t*>(dst + (r0 + g) * HD + c) =
              pack_bf16(o[nd][0], o[nd][1]);
        if (r0 + g + 8 < T)
          *reinterpret_cast<uint32_t*>(dst + (r0 + g + 8) * HD + c) =
              pack_bf16(o[nd][2], o[nd][3]);
      }
    }
    __syncthreads();  // this stage and the run's bias are free again
  }
  cp_async_wait<0>();
}

template <int NT, int TT, bool MASKED>
int launch(const void* q, const void* k, const void* v, const void* rel_bias,
           const void* mask, int nw_img, void* out, int n_windows, int heads,
           int tokens, float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes(tokens, MASKED);
  auto kernel = head_major_attention_kernel<NT, TT, MASKED>;
  // resident blocks on the card for this shared-memory size (an
  // instance's calls take one size, 49 tokens)
  static size_t cached_bytes = 0;
  static int slots = 0;
  if (cached_bytes != bytes) {
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return (int)err;
    }
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, G_THREADS,
                                                  bytes);
    slots = sms * (per_sm > 0 ? per_sm : 1);
    cached_bytes = bytes;
  }
  const int slot_count = MASKED ? nw_img : 1;
  const Items items{n_windows * heads, heads, slot_count,
                    fast_div(n_windows / slot_count), fast_div(slot_count)};
  const int blocks = slots < items.n ? slots : items.n;
  kernel<<<blocks, G_THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(rel_bias),
      static_cast<const float*>(mask), static_cast<bf16*>(out), items,
      n_windows / slot_count, tokens, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out [n_windows, heads, T, 32] bf16; rel_bias [heads, T, T] and
// mask [nw_img, T, T] (or null) f32, with n_windows a multiple of nw_img.
// The wrapper checks head_dim 32, T <= 64 and 16-byte alignment; item
// indices are 32-bit (n_windows * heads < 2^31).
extern "C" int swinvox_window_attention(const void* q, const void* k,
                                        const void* v, const void* rel_bias,
                                        const void* mask, int nw_img,
                                        void* out, long long n_windows,
                                        int heads, int tokens, float scale,
                                        void* stream) {
  if (n_windows == 0) return 0;
  if (tokens < 1 || tokens > TP || heads < 1 ||
      n_windows * heads > 0x7fffffffLL ||
      (mask && (nw_img < 1 || n_windows % nw_img)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nw = (int)n_windows;
  if (tokens == 49)
    return mask ? launch<7, 49, true>(q, k, v, rel_bias, mask, nw_img, out,
                                      nw, heads, tokens, scale, s)
                : launch<7, 49, false>(q, k, v, rel_bias, mask, nw_img, out,
                                       nw, heads, tokens, scale, s);
  return mask ? launch<8, 0, true>(q, k, v, rel_bias, mask, nw_img, out, nw,
                                   heads, tokens, scale, s)
              : launch<8, 0, false>(q, k, v, rel_bias, mask, nw_img, out, nw,
                                    heads, tokens, scale, s);
}
