// Whole Swin block on aligned window-major tokens: inference (kernel B)
// and the training forward (kernel C); and, on three of B's launches, the
// fused W-MSA (kernel H, at the end of this note).
//
// Kernel B replaces the TPU kernel swinvox_tpu/ops/pallas_swin_block.py:
// _swin_block_kernel (through `fused_swin_block`).  For x [nW, T, C] bf16
// (T = 49 logical tokens, no padding; head_dim 32):
//
//   h   = bf16(LN1(x))                      f32 stats, biased variance
//   qkv = bf16(h @ Wqkv + bqkv)             [nW*T, 3C]
//   per (shifted window, head):
//     s   = (q k^T) * 32^-0.5 + rel_bias[head] (+ mask[window % nW_img])
//     p   = bf16(softmax_f32(s))
//     ctx = bf16(p @ v)                     [nW*T, C]
//   x2  = f32(x) + (ctx @ Wproj + bproj)    f32
//   hid = bf16(gelu_erf(LN2(x2)_bf16 @ W1 + b1))   [nW*T, 4C]
//   out = bf16(x2 + (hid @ W2 + b2))
//
// with the TPU kernel's rounding points (its lines 74-149).  Kernel C
// (replaces pallas_swin_block.py:_swin_block_train_fwd_kernel through
// `fused_swin_block_train`) is the same launches with two additions:
// per-window stochastic-depth factors dp1/dp2 [nW] f32 scale the two
// residual branches (x2 = x + dp1 * attn, out = x2 + dp2 * mlp), and the
// launches save what kernel D (swin_block_train.cu) reads: h1, h2 with
// their row mean and 1/std, qkv, ctx, f32 x2, the f32 pre-GELU values and
// the bf16 GELU output (40 bytes per token-channel, ~1.8 GB for the 12
// block calls of a batch-32 step, and no FLOPs).
//
// Tokens stay in the aligned layout: a shifted block's attention fetches
// q, k, v of shifted window w, token t from the aligned row the roll maps
// it to and writes ctx back there (swin_tc.cuh, win_row), so the JAX
// chain's relayout (kernel A) costs nothing here.  Everything else is per
// token.
//
// Work at batch 32 (224^2 input): every stage has tokens * C^2 = 0.92 G;
// a block is 24 C^2 FLOP a token in its four GEMMs plus 4 * 49 C in the
// attention, ~22 GFLOP a call, ~275 GFLOP (0.278 ms at the bf16 peak)
// for the 12 calls of a forward: bound by operations, since what the
// block must move (x in, out, weights) is ~0.12 ms at 3.35 TB/s.  Six
// launches a call, one stream:
//
//   swin_fwd_ln       LN1, one warp a row: bf16 h1 (and its stats)
//   swin_fwd_gemm<QKV>   h1 Wqkv + b -> bf16 qkv
//   swin_fwd_attn     the attention, register-resident (below)
//   swin_fwd_proj_ln  ctx Wproj + b, x + dp1 * . -> f32 x2, and LN2 of
//                     x2 in the epilogue -> bf16 h2 (and its stats): a
//                     thread block cluster of C / 96 blocks holds whole
//                     rows, and the row sums meet in distributed shared
//                     memory (two passes, mean then centred squares)
//   swin_fwd_gemm<FC1>   h2 W1 + b -> (f32 pre) erf-GELU -> bf16 hidden
//   swin_fwd_gemm<FC2>   hidden W2 + b, x2 + dp2 * . -> bf16 out
//
// The GEMMs run on mma_common.cuh's pipelined core: 128 x 96 x 64 tiles,
// 8 warps, a 3-stage cp.async ring, ldmatrix and mma.sync m16n8k16 bf16
// with f32 accumulation, two blocks an SM; each LayerNorm is taken once
// per row, so QKV and FC1 are plain GEMMs on bf16 operands.  The
// attention: one block per (window group, head), 4 warps, tokens padded
// to 64; each warp keeps S = q k^T of its 16 query rows in mma.sync
// accumulators, runs the scaled, biased, masked softmax in f32 registers
// with quad shuffles, rounds P to bf16 straight into the A fragments of
// P V, and the next window's q, k, v arrive by cp.async while one
// computes.  Neither wgmma nor TMA yet.
//
// Kernel H (replaces swinvox_tpu/ops/pallas_fused_msa.py:_fused_kernel
// through `fused_window_msa`; the eval-wmsa configuration's W-MSA,
// USE_PALLAS_WINDOW_ATTENTION with USE_PALLAS_SWIN_BLOCK off) is B's first
// three stages without LN1 and the residual, with H's rounding points:
//
//   swin_fwd_gemm<QKV>   x Wqkv + bqkv -> bf16 qkv
//   swin_fwd_attn        the map at shift 0 (the identity), mask[w %
//                        nW_img]: softmax_f32(q k^T * scale + rel_bias
//                        (+ mask)) rounded to bf16 before @ v -> bf16 ctx
//   swin_fwd_gemm<QKV>   ctx Wproj + bproj -> bf16 out (the QKV epilogue)
//
// It is defined here, beside B, so the three launches are B's own
// instances and B's and C's code is untouched.  Work at the 12 calls of a
// 24-image forward: 8 * tokens * C^2 FLOP in the projections (66.6
// GFLOP) and 6.7 GFLOP of attention (0.074 ms at the bf16 peak) against
// ~154 MB of x, out, weights and masks (0.046 ms at 3.35 TB/s): bound by
// operations, which B's pipelined GEMM core is built for; its first
// design (wmma on 64 x 64 tiles from plain loads, the scores staged
// through shared memory) ran at 2-4% of that bound.  qkv and ctx still
// make a round trip through device memory (~0.55 GB for the 12 calls,
// ~0.16 ms at 3.35 TB/s); keeping them on chip is later work.
//
// The C entry points return the first nonzero cudaGetLastError() of their
// launches.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "swin_tc.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int GEMM_BN = 96;  // every width of the block is a multiple
using FwdTile = GemmTile<GEMM_BN, true, false>;  // A [m][k], W [k][n]

constexpr int LN_WARPS = 8;  // rows a swin_fwd_ln block

// ------------------------------------------------------------- LN rows
// h = bf16((x - mean) * rstd * s + b) of row r, one warp a row, f32 two
// pass statistics; stats (or null) takes the row's mean and 1/std.
template <int C>
__global__ void __launch_bounds__(LN_WARPS * 32)
    swin_fwd_ln_kernel(const bf16* __restrict__ x, const float* __restrict__ s,
                       const float* __restrict__ b, int M, float eps,
                       bf16* __restrict__ h, float* __restrict__ stats) {
  using R = RowSplit<C>;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  if (r >= M) return;
  const size_t base = (size_t)r * C;
  float v[R::CPL];
#pragma unroll
  for (int k = 0; k < R::NV; ++k)
    ld_vec<R::VEC>(x + base + R::col(k, lane), v + k * R::VEC);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < R::CPL; ++j) sum += v[j];
  const float mu = warp_sum(sum) / (float)C;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < R::CPL; ++j) {
    const float d = v[j] - mu;
    sq += d * d;
  }
  const float rs = rsqrtf(warp_sum(sq) / (float)C + eps);
#pragma unroll
  for (int k = 0; k < R::NV; ++k) {
    float sc[R::VEC], bi[R::VEC];
    ld_vec<R::VEC>(s + R::col(k, lane), sc);
    ld_vec<R::VEC>(b + R::col(k, lane), bi);
#pragma unroll
    for (int e = 0; e < R::VEC; ++e) {
      float& o = v[k * R::VEC + e];
      o = (o - mu) * rs * sc[e] + bi[e];
    }
    st_vec<R::VEC>(h + base + R::col(k, lane), v + k * R::VEC);
  }
  if (stats && lane == 0) {
    stats[2 * (size_t)r] = mu;
    stats[2 * (size_t)r + 1] = rs;
  }
}

// ---------------------------------------------------------------- GEMMs
enum Epi { QKV = 0, FC1 = 1, FC2 = 2 };

struct FwdGemm {
  const bf16* a;      // [m, k]
  const bf16* w;      // [k, n], the forward weight
  const float* bias;  // [n]
  int m, n, k;
  const float* resid; // FC2: x2 f32 [m, n]
  const float* dp;    // FC2: branch factor per window of `tokens` rows
  int tokens;
  bf16* out;          // [m, n]
  float* pre;         // FC1 (training): the f32 pre-GELU values
};

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
}

template <int EPI>
__global__ void __launch_bounds__(256, 2) swin_fwd_gemm_kernel(FwdGemm g) {
  using G = FwdTile;
  extern __shared__ __align__(128) unsigned char gsm[];
  const int n0 = blockIdx.x * G::BN, m0 = blockIdx.y * G::BM;
  const Operand a{g.a, g.k, m0, g.m, 0, g.k};
  const Operand b{g.w, g.n, 0, g.k, n0, g.n};
  float acc[G::MT][G::NT][4], csa[G::A_CPT][8], csb[G::B_CPT][8];
  gemm_mainloop<G, true, false, XF_NONE, XF_NONE>(
      a, b, (g.k + G::BK - 1) / G::BK, nullptr, 1, false,
      reinterpret_cast<bf16*>(gsm), acc, csa, csb);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm0 = (warp / G::WN) * G::WTM, wn0 = (warp % G::WN) * G::WTN;
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = m0 + wm0 + mt * 16 + (lane >> 2) + hf * 8;
      if (r >= g.m) continue;
      const float dpw = EPI == FC2 && g.dp ? g.dp[r / g.tokens] : 1.f;
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
        const int c = n0 + wn0 + nt * 8 + (lane & 3) * 2;
        const size_t o = (size_t)r * g.n + c;
        float v0 = acc[mt][nt][2 * hf] + g.bias[c];
        float v1 = acc[mt][nt][2 * hf + 1] + g.bias[c + 1];
        if (EPI == FC1) {
          if (g.pre)
            *reinterpret_cast<float2*>(g.pre + o) = make_float2(v0, v1);
          v0 = gelu_erf(v0);
          v1 = gelu_erf(v1);
        } else if (EPI == FC2) {
          const float2 x2 = *reinterpret_cast<const float2*>(g.resid + o);
          v0 = x2.x + dpw * v0;
          v1 = x2.y + dpw * v1;
        }
        *reinterpret_cast<__nv_bfloat162*>(g.out + o) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
}

// ctx Wproj + bproj, x2 = x + dp1 * that (f32), then LN2 of x2: the
// cluster's C / 96 blocks share one 128-row block and each holds 96 of
// its columns; a row's sum, then its sum of squared deviations from the
// mean, go from the quads through shared memory to every block of the
// cluster (read in rank order: every block gets the same bits).
struct ProjLn {
  const bf16* ctx;     // [m, C]
  const bf16* w;       // [C, C]
  const float* bias;
  const bf16* x;       // the block's input, [m, C]
  const float* dp;     // dp1 or null
  int tokens, m, c;
  const float *ln_s, *ln_b;
  float eps;
  float* x2;           // [m, C] f32
  bf16* h2;            // [m, C]
  float* stats;        // [m, 2] or null
};

__global__ void __launch_bounds__(256, 2) swin_fwd_proj_ln_kernel(ProjLn p) {
  using G = FwdTile;
  extern __shared__ __align__(128) unsigned char gsm[];
  __shared__ float part[G::WN][G::BM];  // per warp column: row partials
  __shared__ float red[2][G::BM];       // this block's row sums, squares
  __shared__ float row_mu[G::BM], row_rs[G::BM];
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = (int)gridDim.x;  // the cluster spans the row
  const int n0 = blockIdx.x * G::BN, m0 = blockIdx.y * G::BM;
  const Operand a{p.ctx, p.c, m0, p.m, 0, p.c};
  const Operand b{p.w, p.c, 0, p.c, n0, p.c};
  float acc[G::MT][G::NT][4], csa[G::A_CPT][8], csb[G::B_CPT][8];
  gemm_mainloop<G, true, false, XF_NONE, XF_NONE>(
      a, b, (p.c + G::BK - 1) / G::BK, nullptr, 1, false,
      reinterpret_cast<bf16*>(gsm), acc, csa, csb);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wn = warp % G::WN;
  const int wm0 = (warp / G::WN) * G::WTM, wn0 = wn * G::WTN;

  // x2 in the accumulators (rows past m: 0), written out
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = m0 + wm0 + mt * 16 + (lane >> 2) + hf * 8;
      const float dpw = r < p.m && p.dp ? p.dp[r / p.tokens] : 1.f;
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
        const int c = n0 + wn0 + nt * 8 + (lane & 3) * 2;
        float& v0 = acc[mt][nt][2 * hf];
        float& v1 = acc[mt][nt][2 * hf + 1];
        if (r >= p.m) {
          v0 = v1 = 0.f;
          continue;
        }
        const size_t o = (size_t)r * p.c + c;
        const float2 xr = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(p.x + o));
        v0 = xr.x + dpw * (v0 + p.bias[c]);
        v1 = xr.y + dpw * (v1 + p.bias[c + 1]);
        *reinterpret_cast<float2*>(p.x2 + o) = make_float2(v0, v1);
      }
    }

  // pass k = 0: sum of x2; k = 1: sum of (x2 - mean)^2; over the row
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int lr = wm0 + mt * 16 + (lane >> 2) + hf * 8;
        const float mu = k ? row_mu[lr] : 0.f;
        float s = 0.f;
#pragma unroll
        for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float d = acc[mt][nt][2 * hf + j] - mu;
            s += k ? d * d : d;
          }
        s = quad_sum(s);
        if ((lane & 3) == 0) part[wn][lr] = s;
      }
    __syncthreads();
    if (threadIdx.x < G::BM) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < G::WN; ++w) s += part[w][threadIdx.x];
      red[k][threadIdx.x] = s;
    }
    cluster.sync();  // every block's red[k] is written
    if (threadIdx.x < G::BM) {
      float s = 0.f;
      for (int q = 0; q < ranks; ++q)
        s += cluster.map_shared_rank(&red[k][0], q)[threadIdx.x];
      if (k == 0) {
        row_mu[threadIdx.x] = s / (float)p.c;
      } else {
        row_rs[threadIdx.x] = rsqrtf(s / (float)p.c + p.eps);
        const int r = m0 + threadIdx.x;
        if (p.stats && cluster.block_rank() == 0 && r < p.m) {
          p.stats[2 * (size_t)r] = row_mu[threadIdx.x];
          p.stats[2 * (size_t)r + 1] = row_rs[threadIdx.x];
        }
      }
    }
    __syncthreads();  // row_mu / row_rs visible; `part` free again
  }

#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int lr = wm0 + mt * 16 + (lane >> 2) + hf * 8;
      const int r = m0 + lr;
      if (r >= p.m) continue;
      const float mu = row_mu[lr], rs = row_rs[lr];
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
        const int c = n0 + wn0 + nt * 8 + (lane & 3) * 2;
        const float h0 =
            (acc[mt][nt][2 * hf] - mu) * rs * p.ln_s[c] + p.ln_b[c];
        const float h1 = (acc[mt][nt][2 * hf + 1] - mu) * rs *
                             p.ln_s[c + 1] + p.ln_b[c + 1];
        *reinterpret_cast<__nv_bfloat162*>(p.h2 + (size_t)r * p.c + c) =
            __floats2bfloat162_rn(h0, h1);
      }
    }
  cluster.sync();  // no block leaves while another reads its red[1]
}

// ------------------------------------------------------------ attention
// One block per (window group, head), 4 warps; warp w owns query rows
// [16w, 16w + 16) of each window.  The per-thread (row, key) slots of the
// relative bias are the same for every window: held in registers.
constexpr int FWD_TILES = 3 * TMAX * ALD;  // q, k, v of one window

__global__ void __launch_bounds__(ATT_THREADS)
    swin_fwd_attn_kernel(const bf16* __restrict__ qkv,
                         const float* __restrict__ rel_bias,
                         const float* __restrict__ mask, int nw_img,
                         int n_windows, int T, int C, float scale,
                         WinMap map, bf16* __restrict__ ctx) {
  __shared__ __align__(128) bf16 tiles[2 * FWD_TILES];  // two windows
  const int h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, r0 = warp * 16;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int C3 = 3 * C;
  // this thread's two 16-byte chunks of a tile (tokens tid / 4 and
  // tid / 4 + 32) and its two query rows, through the window map
  static_assert(TMAX * HD / 8 == 2 * ATT_THREADS, "two chunks a thread");
  const int cc = (tid % (HD / 8)) * 8;
  const TokOff fk[2] = {tok_off(map, tid / (HD / 8)),
                        tok_off(map, tid / (HD / 8) + TMAX / 2)};
  const TokOff qk[2] = {tok_off(map, r0 + g), tok_off(map, r0 + g + 8)};
  auto fetch = [&](int w, int buf) {
    bf16* dst = tiles + buf * FWD_TILES;
    const WinOrg o = win_org(map, w);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool real = fk[j].t < T;
      const size_t row = real ? win_row(map, o, fk[j], T) : 0;
      const bf16* src = qkv + row * C3 + h * HD + cc;
      bf16* d = dst + fk[j].t * ALD + cc;
      cp_async16(smem_u32(d), src, real);
      cp_async16(smem_u32(d + TMAX * ALD), src + C, real);
      cp_async16(smem_u32(d + 2 * TMAX * ALD), src + 2 * C, real);
    }
  };
  if ((int)blockIdx.x < n_windows) fetch(blockIdx.x, 0);
  cp_async_commit();

  float bs[TMAX / 8][4];  // rel_bias of this thread's slots; pads -inf
  const float* bias = rel_bias + (size_t)h * T * T;
#pragma unroll
  for (int nt = 0; nt < TMAX / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + (e >> 1) * 8, c = nt * 8 + t2 + (e & 1);
      bs[nt][e] = r < T && c < T ? bias[r * T + c] : -INFINITY;
    }

  int buf = 0;
  for (int w = blockIdx.x; w < n_windows; w += gridDim.x, buf ^= 1) {
    __syncthreads();  // every warp is done with the other buffer
    if (w + (int)gridDim.x < n_windows) fetch(w + gridDim.x, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this window's copies landed (the next may fly)
    __syncthreads();
    const bf16* qs = tiles + buf * FWD_TILES;
    const bf16* ks = qs + TMAX * ALD;
    const bf16* vs = ks + TMAX * ALD;

    // S = q k^T for query rows [r0, r0 + 16)
    float sa[TMAX / 8][4];
#pragma unroll
    for (int nt = 0; nt < TMAX / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t qa[4];
      ldsm_x4(qa, smem_u32(qs + (r0 + (lane & 15)) * ALD + kk +
                           (lane >> 4) * 8));
#pragma unroll
      for (int np = 0; np < TMAX / 16; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, smem_u32(ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                      ALD + kk + ((lane >> 3) & 1) * 8));
        mma_bf16(sa[2 * np], qa, kb[0], kb[1]);
        mma_bf16(sa[2 * np + 1], qa, kb[2], kb[3]);
      }
    }

    // softmax in f32, rows r0 + g (e < 2) and r0 + g + 8 (e >= 2)
    const float* msk = mask ? mask + (size_t)(w % nw_img) * T * T : nullptr;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < TMAX / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + (e >> 1) * 8, c = nt * 8 + t2 + (e & 1);
        float v = sa[nt][e] * scale + bs[nt][e];
        if (msk && r < T && c < T) v += msk[r * T + c];
        sa[nt][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < TMAX / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float m = mx[e >> 1];
        const float p = m == -INFINITY ? 0.f : expf(sa[nt][e] - m);
        sa[nt][e] = p;
        sum[e >> 1] += p;
      }
    sum[0] = quad_sum(sum[0]);
    sum[1] = quad_sum(sum[1]);
    // P = bf16(e / sum) as the A fragments of P v (16 keys a fragment)
    uint32_t pa[TMAX / 16][4];
#pragma unroll
    for (int nt = 0; nt < TMAX / 8; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float sm = sum[hf];
        const float p0 = sm > 0.f ? sa[nt][2 * hf] / sm : 0.f;
        const float p1 = sm > 0.f ? sa[nt][2 * hf + 1] / sm : 0.f;
        pa[nt / 2][(nt & 1) * 2 + hf] = pack_bf16(p0, p1);
      }

    // ctx rows [r0, r0 + 16) = P v
    float oa[HD / 8][4];
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) oa[nt][e] = 0.f;
#pragma unroll
    for (int kj = 0; kj < TMAX / 16; ++kj)
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t vb[4];
        ldsm_x4_t(vb, smem_u32(vs + (kj * 16 + (lane & 7) +
                                     (((lane >> 3) & 1) << 3)) * ALD +
                               np * 16 + (lane >> 4) * 8));
        mma_bf16(oa[2 * np], pa[kj], vb[0], vb[1]);
        mma_bf16(oa[2 * np + 1], pa[kj], vb[2], vb[3]);
      }
    const WinOrg o = win_org(map, w);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (qk[hf].t >= T) continue;
      bf16* dst =
          ctx + (size_t)win_row(map, o, qk[hf], T) * C + h * HD + t2;
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(dst + nt * 8) =
            __floats2bfloat162_rn(oa[nt][2 * hf], oa[nt][2 * hf + 1]);
    }
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------------- launches
constexpr int ATT_TARGET_BLOCKS = 1056;  // 8 blocks on each of 132 SMs

template <int C>
int ln_rows(const bf16* x, const float* s, const float* b, int M, float eps,
            bf16* h, float* stats, cudaStream_t st) {
  swin_fwd_ln_kernel<C><<<(M + LN_WARPS - 1) / LN_WARPS, LN_WARPS * 32, 0,
                          st>>>(x, s, b, M, eps, h, stats);
  return (int)cudaGetLastError();
}

template <int EPI>
int gemm(const FwdGemm& g, cudaStream_t s) {
  using G = FwdTile;
  auto kern = swin_fwd_gemm_kernel<EPI>;
  static const int attr = (int)cudaFuncSetAttribute(  // once per kernel
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  if (attr) return attr;
  kern<<<dim3(g.n / G::BN, (g.m + G::BM - 1) / G::BM), G::THREADS, G::SMEM,
         s>>>(g);
  return (int)cudaGetLastError();
}

int proj_ln(const ProjLn& p, cudaStream_t s) {
  using G = FwdTile;
  static const int attr = (int)cudaFuncSetAttribute(
      swin_fwd_proj_ln_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)G::SMEM);
  if (attr) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.c / G::BN, (p.m + G::BM - 1) / G::BM);
  cfg.blockDim = dim3(G::THREADS);
  cfg.dynamicSmemBytes = G::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = p.c / G::BN;  // 1, 2, 4 or 8: a whole row
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const int err = (int)cudaLaunchKernelEx(&cfg, swin_fwd_proj_ln_kernel, p);
  return err ? err : (int)cudaGetLastError();
}

// What kernel C saves (null at inference).
struct Train {
  const float *dp1, *dp2;
  float *stats1, *stats2, *pre;
};

template <int C>
int run_block(const void* x, const void* ln1s, const void* ln1b,
              const void* wqkv, const void* bqkv, const void* wproj,
              const void* bproj, const void* rel_bias, const void* mask,
              int nw_img, const void* ln2s, const void* ln2b, const void* w1,
              const void* b1, const void* w2, const void* b2, void* out,
              void* h1, void* qkv, void* ctx, void* x2, void* h2,
              void* hidden, int n_windows, int T, int heads, WinMap map,
              float scale, float eps, const Train& tr, cudaStream_t s) {
  const int M = n_windows * T;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto b = [](const void* p) { return static_cast<const bf16*>(p); };
  auto o = [](void* p) { return static_cast<bf16*>(p); };
  int err;
  if ((err = ln_rows<C>(b(x), f(ln1s), f(ln1b), M, eps, o(h1), tr.stats1,
                        s)))
    return err;
  FwdGemm g{b(h1), b(wqkv), f(bqkv), M, 3 * C, C, nullptr, nullptr, T,
            o(qkv), nullptr};
  if ((err = gemm<QKV>(g, s))) return err;

  int groups = ATT_TARGET_BLOCKS / heads;
  if (groups < 1) groups = 1;
  if (groups > n_windows) groups = n_windows;
  swin_fwd_attn_kernel<<<dim3(groups, heads), ATT_THREADS, 0, s>>>(
      b(qkv), f(rel_bias), f(mask), nw_img, n_windows, T, C, scale, map,
      o(ctx));
  if ((err = (int)cudaGetLastError())) return err;

  const ProjLn p{b(ctx), b(wproj), f(bproj), b(x), tr.dp1, T, M, C,
                 f(ln2s), f(ln2b), eps, static_cast<float*>(x2), o(h2),
                 tr.stats2};
  if ((err = proj_ln(p, s))) return err;

  g = FwdGemm{b(h2), b(w1), f(b1), M, 4 * C, C, nullptr, nullptr, T,
              o(hidden), tr.pre};
  if ((err = gemm<FC1>(g, s))) return err;
  g = FwdGemm{b(hidden), b(w2), f(b2), M, C, 4 * C, f(x2), tr.dp2, T,
              o(out), nullptr};
  return gemm<FC2>(g, s);
}

int run_block_c(int C, const void* x, const void* ln1s, const void* ln1b,
                const void* wqkv, const void* bqkv, const void* wproj,
                const void* bproj, const void* rel_bias, const void* mask,
                int nw_img, const void* ln2s, const void* ln2b,
                const void* w1, const void* b1, const void* w2,
                const void* b2, void* out, void* h1, void* qkv, void* ctx,
                void* x2, void* h2, void* hidden, long long n_windows, int T,
                int heads, WinMap map, float scale, float eps,
                const Train& tr, cudaStream_t s) {
  if (n_windows * T == 0) return 0;
  if (T > TMAX || n_windows * T >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
#define SWIN_BLOCK_ARGS                                                     \
  x, ln1s, ln1b, wqkv, bqkv, wproj, bproj, rel_bias, mask, nw_img, ln2s,   \
      ln2b, w1, b1, w2, b2, out, h1, qkv, ctx, x2, h2, hidden,             \
      (int)n_windows, T, heads, map, scale, eps, tr, s
  switch (C) {
    case 96:
      return run_block<96>(SWIN_BLOCK_ARGS);
    case 192:
      return run_block<192>(SWIN_BLOCK_ARGS);
    case 384:
      return run_block<384>(SWIN_BLOCK_ARGS);
    case 768:
      return run_block<768>(SWIN_BLOCK_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SWIN_BLOCK_ARGS
}

// Kernel H, the fused W-MSA: B's QKV product, B's attention over aligned
// windows (the identity map) and the output projection through the QKV
// epilogue, bf16(ctx Wproj + bproj).
int run_msa(const bf16* x, const bf16* wqkv, const float* bqkv,
            const bf16* wproj, const float* bproj, const float* rel_bias,
            const float* mask, int nw_img, bf16* out, bf16* qkv, bf16* ctx,
            int n_windows, int T, int C, int heads, float scale,
            cudaStream_t s) {
  const int M = n_windows * T;
  FwdGemm g{x, wqkv, bqkv, M, 3 * C, C, nullptr, nullptr, T, qkv, nullptr};
  int err;
  if ((err = gemm<QKV>(g, s))) return err;
  int groups = ATT_TARGET_BLOCKS / heads;
  if (groups < 1) groups = 1;
  if (groups > n_windows) groups = n_windows;
  swin_fwd_attn_kernel<<<dim3(groups, heads), ATT_THREADS, 0, s>>>(
      qkv, rel_bias, mask, nw_img, n_windows, T, C, scale,
      WinMap{1, 1, 0, 0}, ctx);
  if ((err = (int)cudaGetLastError())) return err;
  g = FwdGemm{ctx, wproj, bproj, M, C, C, nullptr, nullptr, T, out, nullptr};
  return gemm<QKV>(g, s);
}

}  // namespace

// Kernel B.  x/out [n_windows*tokens, C] bf16, aligned windows of an
// nwh x nww grid per image (window^2 = tokens), the attention over the
// windows shifted by `shift` (0: aligned, nwh/nww unused); weights bf16
// row-major [in, out]; LN affines, biases, rel_bias [heads, T, T] and
// mask [nw_img, T, T] of the shifted windows (or null) f32.  Scratch from
// the caller: h1, ctx, h2 [., C] bf16, qkv [., 3C] bf16, x2 [., C] f32,
// hidden [., 4C] bf16, each 16-byte aligned.  C is 96, 192, 384 or 768,
// C / heads == 32, tokens <= 64.
extern "C" int swinvox_swin_block(
    const void* x, const void* ln1s, const void* ln1b, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj,
    const void* rel_bias, const void* mask, int nw_img, const void* ln2s,
    const void* ln2b, const void* w1, const void* b1, const void* w2,
    const void* b2, void* out, void* h1, void* qkv, void* ctx, void* x2,
    void* h2, void* hidden, long long n_windows, int tokens, int channels,
    int heads, int nwh, int nww, int window, int shift, float scale,
    float eps, void* stream) {
  const Train none{nullptr, nullptr, nullptr, nullptr, nullptr};
  return run_block_c(channels, x, ln1s, ln1b, wqkv, bqkv, wproj, bproj,
                     rel_bias, mask, nw_img, ln2s, ln2b, w1, b1, w2, b2, out,
                     h1, qkv, ctx, x2, h2, hidden, n_windows, tokens, heads,
                     WinMap{nwh, nww, window, shift}, scale, eps, none,
                     static_cast<cudaStream_t>(stream));
}

// Kernel C.  As above plus dp1, dp2 [n_windows] f32, and the saved
// intermediates kernel D reads, all aligned: h1, h2 [., C] bf16, stats1,
// stats2 [., 2] f32 (row mean, 1/std), qkv, ctx, x2, pre [., 4C] f32,
// hidden [., 4C] bf16.
extern "C" int swinvox_swin_block_train_fwd(
    const void* x, const void* dp1, const void* dp2, const void* ln1s,
    const void* ln1b, const void* wqkv, const void* bqkv, const void* wproj,
    const void* bproj, const void* rel_bias, const void* mask, int nw_img,
    const void* ln2s, const void* ln2b, const void* w1, const void* b1,
    const void* w2, const void* b2, void* out, void* h1, void* stats1,
    void* qkv, void* ctx, void* x2, void* h2, void* stats2, void* pre,
    void* hidden, long long n_windows, int tokens, int channels, int heads,
    int nwh, int nww, int window, int shift, float scale, float eps,
    void* stream) {
  const Train tr{static_cast<const float*>(dp1),
                 static_cast<const float*>(dp2), static_cast<float*>(stats1),
                 static_cast<float*>(stats2), static_cast<float*>(pre)};
  return run_block_c(channels, x, ln1s, ln1b, wqkv, bqkv, wproj, bproj,
                     rel_bias, mask, nw_img, ln2s, ln2b, w1, b1, w2, b2, out,
                     h1, qkv, ctx, x2, h2, hidden, n_windows, tokens, heads,
                     WinMap{nwh, nww, window, shift}, scale, eps, tr,
                     static_cast<cudaStream_t>(stream));
}

// Kernel H.  x/out [n_windows*tokens, C] bf16, windows image-major;
// wqkv [C, 3C] and wproj [C, C] bf16 row-major [in, out]; bqkv, bproj,
// rel_bias [heads, T, T] and mask [nw_img, T, T] (or null) f32 (the mask
// of window w is mask[w % nw_img]).  Scratch from the caller: qkv [., 3C]
// and ctx [., C] bf16.  Every pointer 16-byte aligned; C is 96, 192, 384
// or 768, C / heads == 32, tokens <= 64.
extern "C" int swinvox_fused_msa(const void* x, const void* wqkv,
                                 const void* bqkv, const void* wproj,
                                 const void* bproj, const void* rel_bias,
                                 const void* mask, int nw_img, void* out,
                                 void* qkv, void* ctx, long long n_windows,
                                 int tokens, int channels, int heads,
                                 float scale, void* stream) {
  if (n_windows * tokens == 0) return 0;
  if (tokens > TMAX || n_windows * tokens >= (1LL << 31) ||
      channels != heads * HD ||
      (channels != 96 && channels != 192 && channels != 384 &&
       channels != 768))
    return (int)cudaErrorInvalidValue;
  return run_msa(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const bf16*>(wproj),
      static_cast<const float*>(bproj), static_cast<const float*>(rel_bias),
      static_cast<const float*>(mask), nw_img, static_cast<bf16*>(out),
      static_cast<bf16*>(qkv), static_cast<bf16*>(ctx), (int)n_windows,
      tokens, channels, heads, scale, static_cast<cudaStream_t>(stream));
}
