// Training Swin block backward (kernel D).
//
// Replaces the TPU kernel swinvox_tpu/ops/pallas_swin_block.py:
// _swin_block_train_bwd_kernel (through `fused_swin_block_train`).  Given
// dout [nW*T, C] and what kernel C (swin_block.cu) saved — the bf16 LN1
// and LN2 outputs h1, h2 with their row mean and 1/std, qkv, ctx, f32 x2,
// the f32 pre-GELU values `pre` and the bf16 GELU output `hidden` — it
// computes, with per-window drop-path factors dp1, dp2 (T rows a window):
//
//   dmlp  = bf16(dout * dp2)               db2 = sum(dout * dp2)
//   dW2   = hidden^T dmlp
//   dm1   = bf16((dmlp W2^T) * gelu'(pre))  db1 = sum(dm1)
//   dW1   = h2^T dm1
//   dh2   = dm1 W1^T                        (f32)
//   dx2   = dout + LN2'(dh2)                dln2 scale/bias = sums
//   dattn = bf16(dx2 * dp1)                 dbproj = sum(dx2 * dp1)
//   dWproj = ctx^T dattn
//   dctx  = bf16(dattn Wproj^T)
//   per (window, head): recompute P = softmax(q k^T * s + bias (+mask)),
//     dP = dctx v^T, dV = bf16(P)^T dctx, dS = P * (dP - rowsum(dP * P)),
//     drel_bias += dS, dQ = bf16(dS * s) k, dK = bf16(dS * s)^T q
//   dbqkv = sum(dqkv)                       dWqkv = h1^T dqkv
//   dh1   = dqkv Wqkv^T                     (f32)
//   dx    = bf16(dx2 + LN1'(dh1))           dln1 scale/bias = sums
//
// with the TPU kernel's rounding points (bf16 GEMM operands, f32
// accumulation, f32 LayerNorm and softmax backward, exact erf GELU').
// A factor of 0 zeroes a branch's gradient, never the residual path's.
//
// Work at batch 32: the 12 calls of a training step do ~555 GFLOP (twice
// the forward's) and must read and write ~2.2 GB (tokens x C halves from
// stage to stage, 9.63 M at stage 0).  Per stage shape (M = nW * 49
// tokens, C): (100352, 96), (25088, 192), (6272, 384), (1568, 768).  The
// products of stages 2 and 3 (8 of the 12 calls, two thirds of the FLOPs)
// sit above the card's ~295 FLOP/byte and are bound by operations; those
// of stages 0 and 1 (64-128 FLOP/byte) by bytes, where what counts is the
// bytes not moved.  The first version ran 64x64 wmma tiles with
// synchronous loads (about 61 TFLOP/s), an extra pass to scale dout, one
// thread per column for the bias sums and a serial reduce of every
// partial; together those passes cost a third of D's time.
//
// Launches (16 per block call at C <= 192, 18 above; one stream, no
// atomics):
//   swin_bwd_gemm    the products on the pipelined tensor-core core of
//                    mma_common.cuh (128-row tiles, 3 cp.async stages,
//                    ldmatrix + mma.sync m16n8k16).  Input gradients X W^T
//                    (epilogues: f32, bf16, or x gelu'(pre) -> bf16) and
//                    weight gradients X^T dY split over the token rows into
//                    f32 partials.  dmlp = bf16(dout * dp2) is never
//                    written: the dW2 and dm1 products scale dout's rows
//                    in shared memory as they land.  db2, db1 and dbqkv
//                    are column sums of the dY tiles the weight-gradient
//                    blocks already hold (one row of blocks per split);
//   swin_bwd_gemm_ln at C = 96, 192 (stages 0 and 1, bound by bytes): the
//                    input-gradient product dh = dY W^T with a whole row
//                    in one 128 x C tile, staged in shared memory, and the
//                    LayerNorm backward of LN2 (or LN1) run on it there:
//                    the f32 dh (M x C x 4 bytes, written and read twice a
//                    call) never goes to device memory;
//   swin_bwd_ln      at C = 384, 768: the LayerNorm backward alone on an
//                    f32 dh, one warp per row, templated on C (C/32 values
//                    a lane, loaded as float4 where C allows); both LN
//                    paths run LnRows and leave column partials for
//                    dscale, dbias (and dbproj);
//   swin_bwd_reduce  the partials of each weight, bias, LayerNorm and
//                    rel-bias gradient summed in parallel in a fixed order
//                    (fixed_order_reduce), the weights rounded to bf16; one
//                    launch per producer (a weight with its bias, a
//                    LayerNorm's two or three sums);
//   swin_bwd_attn    one block per (window group, head), 4 warps, tokens
//                    padded to 64 in shared memory, the next window's
//                    tiles copied in while one computes; a shifted block's
//                    windows read qkv, dctx and write dqkv at the aligned
//                    rows of the roll's map (swin_tc.cuh): mma.sync products,
//                    the softmax backward in registers (the first version
//                    staged S, dP and P through f32 shared memory with
//                    wmma and reduced each row with a whole warp), dS
//                    accumulated over the group's windows in registers
//                    into a drel_bias partial.
//
// The C entry point returns the first nonzero cudaGetLastError() of its
// launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "swin_tc.cuh"

namespace {

constexpr int LN_WARPS = 8;
constexpr int LN_ROWS = 64;  // rows per swin_bwd_ln block

__device__ __forceinline__ float dgelu(float m) {
  // d/dm [m * Phi(m)] = Phi(m) + m * phi(m)
  const float cdf = 0.5f * (1.f + erff(m * 0.7071067811865476f));
  return cdf + m * 0.3989422804014327f * expf(-0.5f * m * m);
}

// ---------------------------------------------------------------- GEMMs
// NT (input gradients): out[m][n] = sum_k a[m][k] * b[n][k], a [m, k]
//   (the token rows), b the forward weight [n = in, k = out]; k % 32 == 0.
// TN (weight gradients): part[z][i][j] = sum over the token rows t of
//   split z of a[t][i] * b[t][j]; k = the token count.
// n % BN == 0 in both.
enum Epi { EPI_F32 = 0, EPI_BF16 = 1, EPI_DGELU = 2, EPI_PARTIAL = 3 };

struct GemmArgs {
  const bf16* a;
  const bf16* b;
  int lda, ldb;
  int m, n, k;
  int split_rows;       // TN: token rows per split (a multiple of 32)
  const float* dp;      // XF_SCALE: per-window factors, `tokens` rows each
  int tokens;
  const float* pre;     // EPI_DGELU: [m, n]
  void* out;            // NT: [m, n]; TN: f32 partials [splits][m][n]
  float* bias_part;     // TN with XF_COLSUM on b: [splits][n]
};

template <int BN, bool TN, int XA, int XB, int EPI>
__global__ void __launch_bounds__(256, 2) swin_bwd_gemm_kernel(GemmArgs g) {
  using G = GemmTile<BN, !TN, !TN>;
  extern __shared__ __align__(128) unsigned char gsm[];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * G::BM;
  Operand a, b;
  int ktiles;
  if (!TN) {
    a = Operand{g.a, g.lda, m0, g.m, 0, g.k};
    b = Operand{g.b, g.ldb, n0, g.n, 0, g.k};
    ktiles = (g.k + G::BK - 1) / G::BK;  // past k: zero-filled
  } else {
    const int t0 = blockIdx.z * g.split_rows;
    const int t1 = min(g.k, t0 + g.split_rows);
    a = Operand{g.a, g.lda, t0, t1, m0, g.m};
    b = Operand{g.b, g.ldb, t0, t1, n0, g.n};
    ktiles = t1 > t0 ? (t1 - t0 + G::BK - 1) / G::BK : 0;
  }
  const bool colsum = TN && blockIdx.y == 0;  // one row of blocks a split
  float acc[G::MT][G::NT][4], csa[G::A_CPT][8], csb[G::B_CPT][8];
  gemm_mainloop<G, !TN, !TN, XA, XB>(a, b, ktiles, g.dp, g.tokens, colsum,
                                     reinterpret_cast<bf16*>(gsm), acc, csa,
                                     csb);
  if (TN && (XB & XF_COLSUM) && colsum)
    colsum_flush<G::B_ROWS, G::B_COLS, G::THREADS, G::B_CPT>(
        csb, reinterpret_cast<float*>(gsm),
        g.bias_part + (size_t)blockIdx.z * g.n + n0, g.n - n0);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm0 = (warp / G::WN) * G::WTM, wn0 = (warp % G::WN) * G::WTN;
  // the pre-GELU values first, all loads in flight before any store
  float2 pre[EPI == EPI_DGELU ? G::MT : 1][EPI == EPI_DGELU ? G::NT : 1][2];
  if (EPI == EPI_DGELU) {
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = m0 + wm0 + mt * 16 + (lane >> 2) + hf * 8;
          const int c = n0 + wn0 + nt * 8 + (lane & 3) * 2;
          pre[mt][nt][hf] =
              r < g.m ? *reinterpret_cast<const float2*>(
                            g.pre + (size_t)r * g.n + c)
                      : make_float2(0.f, 0.f);
        }
  }
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = m0 + wm0 + mt * 16 + (lane >> 2) + hf * 8;
        const int c = n0 + wn0 + nt * 8 + (lane & 3) * 2;
        if (r >= g.m || c >= g.n) continue;
        float v0 = acc[mt][nt][2 * hf], v1 = acc[mt][nt][2 * hf + 1];
        size_t o = (size_t)r * g.n + c;
        if (EPI == EPI_PARTIAL) o += (size_t)blockIdx.z * g.m * g.n;
        if (EPI == EPI_F32 || EPI == EPI_PARTIAL) {
          *reinterpret_cast<float2*>(static_cast<float*>(g.out) + o) =
              make_float2(v0, v1);
        } else {
          if (EPI == EPI_DGELU) {
            const float2 p = pre[EPI == EPI_DGELU ? mt : 0]
                                [EPI == EPI_DGELU ? nt : 0][hf];
            v0 *= dgelu(p.x);
            v1 *= dgelu(p.y);
          }
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(g.out) + o) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
}

__global__ void __launch_bounds__(RED_THREADS)
    swin_bwd_reduce_kernel(ReduceJobs jobs) {
  fixed_order_reduce_jobs(jobs);
}

// ------------------------------------------------------------- LN backward
// LayerNorm backward plus the residual, one warp per row r:
// xhat = (x - mean) * rstd, g = dh * scale,
// d = rstd * (g - mean(g) - xhat * mean(g * xhat)), total = res + d.
// LN2 (x = x2 f32, res = dout bf16): writes total to out_f32 (dx2) and
// bf16(total * dp) to out_bf16 (dattn); partial 2 sums total * dp.
// LN1 (x bf16, res = dx2 f32): writes bf16(total) to out_bf16 (dx).
// Partials [blocks][NP][C]: sum dh * xhat, sum dh, (LN2) sum total * dp.
struct LnArgs {
  const void* x;
  const float* stats;  // [M][2]: mean, 1/std
  const float* scale;  // [C]
  const void* res;
  const float* dp;     // LN2: dp1, `tokens` rows a window
  int tokens, M;
  float* out_f32;
  bf16* out_bf16;
  float* partial;
};

// A lane holds C/32 columns, VEC consecutive at a time, and its column
// partials over the rows it has seen.
template <int C, bool LN2>
struct LnRows {
  static constexpr int CPL = C / 32;
  static constexpr int VEC = CPL % 4 == 0 ? 4 : (CPL % 2 == 0 ? 2 : 1);
  static constexpr int NV = CPL / VEC;
  static constexpr int NP = LN2 ? 3 : 2;
  using TX = typename std::conditional<LN2, float, bf16>::type;
  using TR = typename std::conditional<LN2, bf16, float>::type;
  float sc[CPL], a0[CPL], a1[CPL], a2[CPL];

  __device__ __forceinline__ static int col(int v, int lane) {
    return v * 32 * VEC + lane * VEC;
  }

  __device__ __forceinline__ void init(const LnArgs& a, int lane) {
#pragma unroll
    for (int v = 0; v < NV; ++v)
      ld_vec<VEC>(a.scale + col(v, lane), sc + v * VEC);
#pragma unroll
    for (int j = 0; j < CPL; ++j) a0[j] = a1[j] = a2[j] = 0.f;
  }

  // global row r, whose dh (f32, 16-byte aligned) is at `dh`
  __device__ __forceinline__ void row(const LnArgs& a, int r,
                                      const float* dh, int lane) {
    const float mu = a.stats[2 * (size_t)r], rs = a.stats[2 * (size_t)r + 1];
    const size_t base = (size_t)r * C;
    const TX* x = static_cast<const TX*>(a.x) + base;
    const TR* res = static_cast<const TR*>(a.res) + base;
    float d[CPL], xh[CPL], gg[CPL];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      ld_vec<VEC>(dh + col(v, lane), d + v * VEC);
      ld_vec<VEC>(x + col(v, lane), xh + v * VEC);
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      xh[j] = (xh[j] - mu) * rs;
      gg[j] = d[j] * sc[j];
      s1 += gg[j];
      s2 += gg[j] * xh[j];
      a0[j] += d[j] * xh[j];
      a1[j] += d[j];
    }
    float t[CPL];  // the residual, loaded before any store
#pragma unroll
    for (int v = 0; v < NV; ++v) ld_vec<VEC>(res + col(v, lane), t + v * VEC);
    const float m1 = warp_sum(s1) / (float)C, m2 = warp_sum(s2) / (float)C;
    const float f = LN2 ? a.dp[r / a.tokens] : 1.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float q[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int j = v * VEC + e;
        t[j] += rs * (gg[j] - m1 - xh[j] * m2);
        q[e] = t[j] * f;
        a2[j] += q[e];
      }
      if (LN2) {
        st_vec<VEC>(a.out_f32 + base + col(v, lane), t + v * VEC);
        st_vec<VEC>(a.out_bf16 + base + col(v, lane), q);
      } else {
        st_vec<VEC>(a.out_bf16 + base + col(v, lane), t + v * VEC);
      }
    }
  }

  // The warps' column partials summed in warp order into
  // a.partial[block][NP][C]; `red` is NP * C floats of shared memory.
  // Every thread of the block calls it.
  __device__ __forceinline__ void flush(const LnArgs& a, float* red,
                                        int warps, int block) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int i = threadIdx.x; i < NP * C; i += blockDim.x) red[i] = 0.f;
    __syncthreads();
    for (int w = 0; w < warps; ++w) {  // fixed order: deterministic
      if (warp == w) {
#pragma unroll
        for (int v = 0; v < NV; ++v)
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const int j = v * VEC + e, c = col(v, lane) + e;
            red[c] += a0[j];
            red[C + c] += a1[j];
            if (LN2) red[(NP - 1) * C + c] += a2[j];
          }
      }
      __syncthreads();
    }
    float* part = a.partial + (size_t)block * NP * C;
    for (int i = threadIdx.x; i < NP * C; i += blockDim.x) part[i] = red[i];
  }
};

// The LayerNorm backward alone (C = 384, 768), LN_ROWS rows a block.
template <int C, bool LN2>
__global__ void __launch_bounds__(LN_WARPS * 32)
    swin_bwd_ln_kernel(const float* __restrict__ dh, LnArgs a) {
  __shared__ __align__(16) float red[LnRows<C, LN2>::NP * C];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  LnRows<C, LN2> ln;
  ln.init(a, lane);
  const int rb = blockIdx.x * LN_ROWS;
  for (int r = rb + warp; r < min(a.M, rb + LN_ROWS); r += LN_WARPS)
    ln.row(a, r, dh + (size_t)r * C, lane);
  ln.flush(a, red, LN_WARPS, blockIdx.x);
}

// C = 96, 192: dh = a [M, k] w^T (w [C, k]) on the tensor cores with the
// whole row in one 128 x C tile, staged in shared memory as f32, then the
// LayerNorm backward of the tile's rows from there: dh never goes to
// device memory.  Partials [M / 128 blocks][NP][C].
template <int C>
constexpr size_t gemm_ln_smem() {
  using G = GemmTile<C, true, true>;
  constexpr size_t tile = sizeof(float) * G::BM * (C + 4);
  return G::SMEM > tile ? G::SMEM : tile;
}

template <int C, bool LN2>
__global__ void __launch_bounds__(256, C == 96 ? 2 : 1)
    swin_bwd_gemm_ln_kernel(GemmArgs g, LnArgs l) {
  using G = GemmTile<C, true, true>;
  constexpr int LDD = C + 4;  // f32 row of the staged tile, 16-byte rows
  extern __shared__ __align__(128) unsigned char lnsm[];
  const int m0 = blockIdx.y * G::BM;
  const Operand a{g.a, g.lda, m0, g.m, 0, g.k};
  const Operand b{g.b, g.ldb, 0, C, 0, g.k};
  float acc[G::MT][G::NT][4], csa[G::A_CPT][8], csb[G::B_CPT][8];
  gemm_mainloop<G, true, true, XF_NONE, XF_NONE>(
      a, b, (g.k + G::BK - 1) / G::BK, nullptr, 1, false,
      reinterpret_cast<bf16*>(lnsm),
      acc, csa, csb);
  float* dhs = reinterpret_cast<float*>(lnsm);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm0 = (warp / G::WN) * G::WTM, wn0 = (warp % G::WN) * G::WTN;
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = wm0 + mt * 16 + (lane >> 2) + hf * 8;
        const int c = wn0 + nt * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(dhs + r * LDD + c) =
            make_float2(acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
      }
  __syncthreads();
  LnRows<C, LN2> ln;
  ln.init(l, lane);
  for (int i = warp; i < G::BM && m0 + i < l.M; i += G::THREADS / 32)
    ln.row(l, m0 + i, dhs + i * LDD, lane);
  __syncthreads();  // every row of dhs is read before `red` reuses it
  ln.flush(l, dhs, G::THREADS / 32, blockIdx.y);
}

// ------------------------------------------------------------ attn_bwd
// One block per (window group, head), 4 warps; tokens padded to 64 in
// shared memory (pad rows zero, pad keys probability 0), the next
// window's tiles copied in with cp.async while this one computes.  A
// shifted block's window w reads and writes its tokens at the aligned
// rows of the map (win_row): qkv, dctx and dqkv stay aligned.  Per
// window:
// warp w computes S = q k^T and dP = dctx v^T for query rows [16w, +16)
// with mma.sync, and the softmax, P, dP . P, dS and dQ = bf16(dS * s) k in
// its registers (the accumulators of two n8 tiles are the A fragment of
// the next product); P and bf16(dS * s) go to shared memory as bf16 once,
// for dV = bf16(P)^T dctx and dK = bf16(dS * s)^T q of key rows [16w,
// +16).  drel_bias accumulates in each thread's registers over the
// group's windows (every (r, c) has one owner) and is written once as the
// group's partial.
constexpr int PLD = TMAX + 8;  // bf16 row of the P and dS tiles
constexpr int ATT_TILES = 4 * TMAX * ALD;  // q, k, v, dctx of one window
constexpr size_t ATT_SMEM = sizeof(bf16) * (2 * ATT_TILES + 2 * TMAX * PLD);

// out rows [r0, r0 + 16) x HD of a product kept in acc[HD / 8][4], as
// bf16 to dqkv (row stride 3C) at column `col`; rows >= T are padding.
// Token r of window w goes to aligned row rows[hf] (r = r0 + lane / 4 +
// 8 hf).
__device__ __forceinline__ void attn_store(const float (&acc)[HD / 8][4],
                                           const int (&rows)[2], int r0,
                                           int lane, int T, bf16* dqkv,
                                           int C3, int col) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (r0 + (lane >> 2) + hf * 8 >= T) continue;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(
          dqkv + (size_t)rows[hf] * C3 + col + nt * 8 + (lane & 3) * 2) =
          __floats2bfloat162_rn(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
  }
}

// acc += A^T B over the 64 padded tokens, A^T and B read transposed from
// [token][*] tiles: rows [m0, m0 + 16) of A^T (columns of `a`), all HD
// columns of `b`.
__device__ __forceinline__ void attn_tn(const bf16* a, int lda,
                                        const bf16* b, int m0, int lane,
                                        float (&acc)[HD / 8][4]) {
#pragma unroll
  for (int kq = 0; kq < TMAX; kq += 16) {
    uint32_t af[4];
    ldsm_x4_t(af, smem_u32(a + (kq + (lane & 7) + ((lane >> 4) << 3)) * lda +
                           m0 + ((lane >> 3) & 1) * 8));
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t bf[4];
      ldsm_x4_t(bf, smem_u32(b + (kq + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                                     ALD + np * 16 + (lane >> 4) * 8));
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

__global__ void __launch_bounds__(ATT_THREADS)
    swin_bwd_attn_bwd_kernel(const bf16* __restrict__ qkv,
                             const bf16* __restrict__ dctx,
                             const float* __restrict__ rel_bias,
                             const float* __restrict__ mask, int nw_img,
                             int n_windows, int T, int C, float scale,
                             WinMap map, bf16* __restrict__ dqkv,
                             float* __restrict__ dbias_part) {
  extern __shared__ __align__(128) unsigned char att_smem[];
  bf16* tiles = reinterpret_cast<bf16*>(att_smem);  // two windows' tiles
  bf16* ps = tiles + 2 * ATT_TILES;  // bf16(P) [query][key]
  bf16* ss = ps + TMAX * PLD;        // bf16(dS * scale) [query][key]
  const int h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, r0 = warp * 16;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int C3 = 3 * C;
  const float* bias = rel_bias + (size_t)h * T * T;
  // this thread's two 16-byte chunks of a tile (tokens tid / 4 and
  // tid / 4 + 32) and its two query rows, through the window map
  static_assert(TMAX * HD / 8 == 2 * ATT_THREADS, "two chunks a thread");
  const int cc = (tid % (HD / 8)) * 8;
  const TokOff fk[2] = {tok_off(map, tid / (HD / 8)),
                        tok_off(map, tid / (HD / 8) + TMAX / 2)};
  const TokOff qk[2] = {tok_off(map, r0 + g), tok_off(map, r0 + g + 8)};
  // q, k, v and dctx of window w into tile buffer `buf` with cp.async
  // (pad rows zero-filled)
  auto fetch = [&](int w, int buf) {
    bf16* dst = tiles + buf * ATT_TILES;
    const WinOrg o = win_org(map, w);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int tk = fk[j].t;
      const bool real = tk < T;
      const size_t row = real ? win_row(map, o, fk[j], T) : 0;
      const bf16* src = qkv + row * C3 + h * HD + cc;
      bf16* d = dst + tk * ALD + cc;
      cp_async16(smem_u32(d), src, real);
      cp_async16(smem_u32(d + TMAX * ALD), src + C, real);
      cp_async16(smem_u32(d + 2 * TMAX * ALD), src + 2 * C, real);
      cp_async16(smem_u32(d + 3 * TMAX * ALD),
                 dctx + row * C + h * HD + cc, real);
    }
  };
  float db[TMAX / 8][4];  // drel_bias of this thread's (row, key) slots
#pragma unroll
  for (int nt = 0; nt < TMAX / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) db[nt][e] = 0.f;

  if ((int)blockIdx.x < n_windows) fetch(blockIdx.x, 0);
  cp_async_commit();
  int buf = 0;
  for (int w = blockIdx.x; w < n_windows; w += gridDim.x, buf ^= 1) {
    __syncthreads();  // every warp is done with the other buffer, P, dS
    if (w + (int)gridDim.x < n_windows) fetch(w + gridDim.x, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this window's copies landed (the next may fly)
    __syncthreads();
    int rows[2];  // the aligned rows of this thread's query rows
    const WinOrg o = win_org(map, w);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      rows[hf] = qk[hf].t < T ? win_row(map, o, qk[hf], T) : 0;
    const bf16* qs = tiles + buf * ATT_TILES;
    const bf16* ks = qs + TMAX * ALD;
    const bf16* vs = ks + TMAX * ALD;
    const bf16* gs = vs + TMAX * ALD;  // dctx

    // S = q k^T, dP = dctx v^T for query rows [r0, r0 + 16)
    float sa[TMAX / 8][4], da[TMAX / 8][4];
#pragma unroll
    for (int nt = 0; nt < TMAX / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[nt][e] = da[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t qa[4], ga[4];
      ldsm_x4(qa, smem_u32(qs + (r0 + (lane & 15)) * ALD + kk +
                           (lane >> 4) * 8));
      ldsm_x4(ga, smem_u32(gs + (r0 + (lane & 15)) * ALD + kk +
                           (lane >> 4) * 8));
#pragma unroll
      for (int np = 0; np < TMAX / 16; ++np) {
        const int n = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int k = kk + ((lane >> 3) & 1) * 8;
        uint32_t kb[4], vb[4];
        ldsm_x4(kb, smem_u32(ks + n * ALD + k));
        ldsm_x4(vb, smem_u32(vs + n * ALD + k));
        mma_bf16(sa[2 * np], qa, kb[0], kb[1]);
        mma_bf16(sa[2 * np + 1], qa, kb[2], kb[3]);
        mma_bf16(da[2 * np], ga, vb[0], vb[1]);
        mma_bf16(da[2 * np + 1], ga, vb[2], vb[3]);
      }
    }

    // softmax, P . dP and dS, in f32, for rows r0 + g (e < 2), + 8 (e >= 2)
    const float* msk = mask ? mask + (size_t)(w % nw_img) * T * T : nullptr;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < TMAX / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + (e >> 1) * 8, c = nt * 8 + t2 + (e & 1);
        float v = -INFINITY;
        if (r < T && c < T) {
          v = sa[nt][e] * scale + bias[r * T + c];
          if (msk) v += msk[r * T + c];
        }
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
        const int r = r0 + g + (e >> 1) * 8, c = nt * 8 + t2 + (e & 1);
        const float p = (r < T && c < T) ? expf(sa[nt][e] - mx[e >> 1]) : 0.f;
        sa[nt][e] = p;
        sum[e >> 1] += p;
      }
    sum[0] = quad_sum(sum[0]);
    sum[1] = quad_sum(sum[1]);
    float pd[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < TMAX / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sm = sum[e >> 1];
        const float p = sm > 0.f ? sa[nt][e] / sm : 0.f;
        sa[nt][e] = p;
        pd[e >> 1] += p * da[nt][e];
      }
    pd[0] = quad_sum(pd[0]);
    pd[1] = quad_sum(pd[1]);
    uint32_t dsa[TMAX / 16][4];  // bf16(dS * scale) as A fragments
#pragma unroll
    for (int nt = 0; nt < TMAX / 8; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ds[e] = sa[nt][e] * (da[nt][e] - pd[e >> 1]);  // 0 off the window
        db[nt][e] += ds[e];
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = r0 + g + hf * 8, c = nt * 8 + t2;
        *reinterpret_cast<uint32_t*>(ps + r * PLD + c) =
            pack_bf16(sa[nt][2 * hf], sa[nt][2 * hf + 1]);
        const uint32_t sv =
            pack_bf16(ds[2 * hf] * scale, ds[2 * hf + 1] * scale);
        *reinterpret_cast<uint32_t*>(ss + r * PLD + c) = sv;
        dsa[nt / 2][(nt & 1) * 2 + hf] = sv;
      }
    }

    // dQ rows [r0, r0 + 16) = bf16(dS * scale) k
    float oa[HD / 8][4];
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) oa[nt][e] = 0.f;
#pragma unroll
    for (int kj = 0; kj < TMAX / 16; ++kj)
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t kb[4];
        ldsm_x4_t(kb, smem_u32(ks + (kj * 16 + (lane & 7) +
                                     (((lane >> 3) & 1) << 3)) * ALD +
                               np * 16 + (lane >> 4) * 8));
        mma_bf16(oa[2 * np], dsa[kj], kb[0], kb[1]);
        mma_bf16(oa[2 * np + 1], dsa[kj], kb[2], kb[3]);
      }
    attn_store(oa, rows, r0, lane, T, dqkv, C3, h * HD);
    __syncthreads();  // every row of P and dS is in shared memory

    // dV rows (keys) [r0, r0 + 16) = bf16(P)^T dctx
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) oa[nt][e] = 0.f;
    attn_tn(ps, PLD, gs, r0, lane, oa);
    attn_store(oa, rows, r0, lane, T, dqkv, C3, 2 * C + h * HD);
    // dK rows (keys) [r0, r0 + 16) = bf16(dS * scale)^T q
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) oa[nt][e] = 0.f;
    attn_tn(ss, PLD, qs, r0, lane, oa);
    attn_store(oa, rows, r0, lane, T, dqkv, C3, C + h * HD);
  }
  cp_async_wait<0>();
  float* part = dbias_part + ((size_t)blockIdx.x * gridDim.y + h) * T * T;
#pragma unroll
  for (int nt = 0; nt < TMAX / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + (e >> 1) * 8, c = nt * 8 + t2 + (e & 1);
      if (r < T && c < T) part[r * T + c] = db[nt][e];
    }
}

// ------------------------------------------------------------- planning
struct Plan {
  int M, C, T, H, nw;
  int att_groups;
  size_t off[7];  // byte offsets of the scratch buffers
  size_t bytes;
};

constexpr int GEMM_TARGET_BLOCKS = 264;  // 2 blocks on each of 132 SMs
constexpr int ATT_TARGET_BLOCKS = 528;   // 4 blocks on each of 132 SMs

constexpr int GEMM_BN = 96;  // every width of D is a multiple of 96

// Splits of the token rows for a weight gradient [ka, n]: enough blocks
// to fill the card, at least 256 rows each, rows a multiple of 32.
int tn_splits(int M, int ka, int n, int* rows) {
  const int tiles = ((ka + 127) / 128) * (n / GEMM_BN);
  int splits = (GEMM_TARGET_BLOCKS + tiles - 1) / tiles;
  const int most = (M + 255) / 256;
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  int r = (M + splits - 1) / splits;
  r = (r + 31) / 32 * 32;
  *rows = r;
  return (M + r - 1) / r;
}

size_t align256(size_t b) { return (b + 255) / 256 * 256; }

Plan plan(long long n_windows, int T, int C, int H) {
  Plan p;
  p.M = (int)(n_windows * T);
  p.C = C;
  p.T = T;
  p.H = H;
  p.nw = (int)n_windows;
  int g = ATT_TARGET_BLOCKS / H;
  if (g < 1) g = 1;
  if (g > p.nw) g = p.nw;
  p.att_groups = g;
  // the largest partial any reduction needs, in floats
  size_t part = 0;
  auto need = [&](size_t v) { part = v > part ? v : part; };
  const int shapes[4][2] = {{4 * C, C}, {C, 4 * C}, {C, C}, {C, 3 * C}};
  for (auto& s : shapes) {
    int rows;
    const int sp = tn_splits(p.M, s[0], s[1], &rows);
    need((size_t)sp * s[0] * s[1] + (size_t)sp * s[1]);  // + bias sums
  }
  need((size_t)((p.M + LN_ROWS - 1) / LN_ROWS) * 3 * C);  // LN_ROWS <= 128
  need((size_t)g * H * T * T);
  const size_t M = p.M;
  const size_t sizes[7] = {
      M * 4 * C * 2,  // 0 dm1 bf16
      C > 192 ? M * C * 4 : 0,  // 1 dh f32 (dh2, then dh1)
      M * C * 4,      // 2 dx2 f32
      M * C * 2,      // 3 dattn bf16
      M * C * 2,      // 4 dctx bf16
      M * 3 * C * 2,  // 5 dqkv bf16
      part * 4,       // 6 partials f32
  };
  size_t off = 0;
  for (int i = 0; i < 7; ++i) {
    p.off[i] = off;
    off += align256(sizes[i]);
  }
  p.bytes = off;
  return p;
}

int reduce(const ReduceJobs& jobs, cudaStream_t s) {
  swin_bwd_reduce_kernel<<<jobs.first[jobs.count], RED_THREADS, 0, s>>>(jobs);
  return (int)cudaGetLastError();
}

// A 128 x 96 tile a block, two blocks an SM (their epilogues' loads and
// stores overlap the other's products; 128 x 192 tiles, one block an SM,
// measured the same or slower at every stage shape).
template <bool TN, int XA, int XB, int EPI>
int gemm(const GemmArgs& g, int splits, cudaStream_t s) {
  constexpr int BN = GEMM_BN;
  using G = GemmTile<BN, !TN, !TN>;
  if (g.n % BN) return (int)cudaErrorInvalidValue;
  auto kern = swin_bwd_gemm_kernel<BN, TN, XA, XB, EPI>;
  static const int attr = (int)cudaFuncSetAttribute(  // once per kernel
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  if (attr) return attr;
  kern<<<dim3(g.n / BN, (g.m + G::BM - 1) / G::BM, splits), G::THREADS,
         G::SMEM, s>>>(g);
  return (int)cudaGetLastError();
}

// dw [ka, n] bf16 = a^T d over the M token rows (a [M, ka], d [M, n]);
// with XB's column sums, db [n] f32 = sum over rows of d (scaled by dp).
template <int XB>
int weight_grad(const bf16* a, const bf16* d, int M, int ka, int n,
                const float* dp, int T, float* partial, void* dw, float* db,
                cudaStream_t s) {
  int rows;
  const int splits = tn_splits(M, ka, n, &rows);
  GemmArgs g{};
  g.a = a;
  g.b = d;
  g.lda = ka;
  g.ldb = n;
  g.m = ka;
  g.n = n;
  g.k = M;
  g.split_rows = rows;
  g.dp = dp;
  g.tokens = T;
  g.out = partial;
  g.bias_part = partial + (size_t)splits * ka * n;
  const int err = gemm<true, XF_NONE, XB, EPI_PARTIAL>(g, splits, s);
  if (err) return err;
  ReduceJobs jobs{};
  jobs.add(partial, splits, (long long)ka * n, (long long)ka * n, dw, true);
  if (XB & XF_COLSUM) jobs.add(g.bias_part, splits, n, n, db, false);
  return reduce(jobs, s);
}

// out [M, n] = a [M, k] w^T, w [n, k] (the forward weight).
template <int XA, int EPI>
int input_grad(const bf16* a, const bf16* w, int M, int n, int k,
               const float* dp, int T, const float* pre, void* out,
               cudaStream_t s) {
  GemmArgs g{};
  g.a = a;
  g.b = w;
  g.lda = k;
  g.ldb = k;
  g.m = M;
  g.n = n;
  g.k = k;
  g.dp = dp;
  g.tokens = T;
  g.pre = pre;
  g.out = out;
  return gemm<false, XA, XF_NONE, EPI>(g, 1, s);
}

int ln_reduce(const float* partial, int blocks, int C, int np, float* o0,
              float* o1, float* o2, cudaStream_t s) {
  float* outs[3] = {o0, o1, o2};
  ReduceJobs jobs{};
  for (int k = 0; k < np; ++k)
    jobs.add(partial + (size_t)k * C, blocks, (long long)np * C, C, outs[k],
             false);
  return reduce(jobs, s);
}

// dh = a [M, k] w^T (w [C, k]) and the LayerNorm backward on it: fused at
// C = 96, 192 (dh stays on chip), an f32 dh and a separate pass above.
template <int C, bool LN2>
int dh_ln(const bf16* a, const bf16* w, int k, float* dh, const LnArgs& l,
          float* o0, float* o1, float* o2, cudaStream_t s) {
  constexpr int NP = LN2 ? 3 : 2;
  int err, blocks;
  GemmArgs g{};
  g.a = a;
  g.b = w;
  g.lda = k;
  g.ldb = k;
  g.m = l.M;
  g.n = C;
  g.k = k;
  if constexpr (C <= 192) {
    constexpr size_t smem = gemm_ln_smem<C>();
    auto kern = swin_bwd_gemm_ln_kernel<C, LN2>;
    static const int attr = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr) return attr;
    blocks = (l.M + 127) / 128;
    kern<<<dim3(1, blocks), 256, smem, s>>>(g, l);
  } else {
    g.out = dh;
    if ((err = gemm<false, XF_NONE, XF_NONE, EPI_F32>(g, 1, s))) return err;
    blocks = (l.M + LN_ROWS - 1) / LN_ROWS;
    swin_bwd_ln_kernel<C, LN2><<<blocks, LN_WARPS * 32, 0, s>>>(dh, l);
  }
  if ((err = (int)cudaGetLastError())) return err;
  return ln_reduce(l.partial, blocks, C, NP, o0, o1, o2, s);
}

template <bool LN2>
int dh_ln_c(int C, const bf16* a, const bf16* w, int k, float* dh,
            const LnArgs& l, float* o0, float* o1, float* o2,
            cudaStream_t s) {
  switch (C) {
    case 96:
      return dh_ln<96, LN2>(a, w, k, dh, l, o0, o1, o2, s);
    case 192:
      return dh_ln<192, LN2>(a, w, k, dh, l, o0, o1, o2, s);
    case 384:
      return dh_ln<384, LN2>(a, w, k, dh, l, o0, o1, o2, s);
    case 768:
      return dh_ln<768, LN2>(a, w, k, dh, l, o0, o1, o2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" long long swinvox_swin_block_train_bwd_workspace(
    long long n_windows, int tokens, int channels, int heads) {
  return (long long)plan(n_windows, tokens, channels, heads).bytes;
}

// Shapes and the window map (nwh, nww, window, shift) as in
// swinvox_swin_block_train_fwd; gradients out: dx [., C]
// bf16; dln1s, dln1b, dbqkv, dbproj, dln2s, dln2b, db1, db2 and drel_bias
// [H, T, T] f32; dwqkv [C, 3C], dwproj [C, C], dw1 [C, 4C], dw2 [4C, C]
// bf16.  `work` holds swinvox_swin_block_train_bwd_workspace() bytes.
// C is 96, 192, 384 or 768 (Swin-T's stages); every bf16 operand is
// 16-byte aligned.
extern "C" int swinvox_swin_block_train_bwd(
    const void* dout, const void* x, const void* dp1, const void* dp2,
    const void* h1, const void* stats1, const void* qkv, const void* ctx,
    const void* x2, const void* h2, const void* stats2, const void* pre,
    const void* hidden, const void* ln1s, const void* wqkv,
    const void* wproj, const void* rel_bias, const void* mask, int nw_img,
    const void* ln2s, const void* w1, const void* w2, void* dx, void* dln1s,
    void* dln1b, void* dwqkv, void* dbqkv, void* dwproj, void* dbproj,
    void* drel_bias, void* dln2s, void* dln2b, void* dw1, void* db1,
    void* dw2, void* db2, void* work, long long work_bytes,
    long long n_windows, int tokens, int channels, int heads, int nwh,
    int nww, int window, int shift, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = plan(n_windows, tokens, channels, heads);
  if (p.M == 0) return 0;
  if ((long long)p.bytes > work_bytes) return (int)cudaErrorInvalidValue;
  if (channels % 96 || tokens > TMAX) return (int)cudaErrorInvalidValue;
  const int M = p.M, C = channels, T = tokens;
  auto F = [](const void* q) { return static_cast<const float*>(q); };
  auto B = [](const void* q) { return static_cast<const bf16*>(q); };
  auto O = [](void* q) { return static_cast<float*>(q); };
  unsigned char* wb = static_cast<unsigned char*>(work);
  bf16* dm1 = reinterpret_cast<bf16*>(wb + p.off[0]);
  float* dh = reinterpret_cast<float*>(wb + p.off[1]);
  float* dx2 = reinterpret_cast<float*>(wb + p.off[2]);
  bf16* dattn = reinterpret_cast<bf16*>(wb + p.off[3]);
  bf16* dctx = reinterpret_cast<bf16*>(wb + p.off[4]);
  bf16* dqkv = reinterpret_cast<bf16*>(wb + p.off[5]);
  float* part = reinterpret_cast<float*>(wb + p.off[6]);
  int err;

  // ---- MLP branch (dmlp = bf16(dout * dp2) formed in shared memory)
  if ((err = weight_grad<XF_SCALE_COLSUM>(B(hidden), B(dout), M, 4 * C, C,
                                          F(dp2), T, part, dw2, O(db2), s)))
    return err;
  if ((err = input_grad<XF_SCALE, EPI_DGELU>(B(dout), B(w2), M, 4 * C, C,
                                             F(dp2), T, F(pre), dm1, s)))
    return err;
  if ((err = weight_grad<XF_COLSUM>(B(h2), dm1, M, C, 4 * C, nullptr, T,
                                    part, dw1, O(db1), s)))
    return err;

  // ---- dh2 = dm1 W1^T, LN2 backward + residual: dx2, dattn
  const LnArgs ln2{x2, F(stats2), F(ln2s), dout, F(dp1), T, M, dx2, dattn,
                   part};
  if ((err = dh_ln_c<true>(C, dm1, B(w1), 4 * C, dh, ln2, O(dln2s),
                           O(dln2b), O(dbproj), s)))
    return err;

  // ---- attention branch
  if ((err = weight_grad<XF_NONE>(B(ctx), dattn, M, C, C, nullptr, T, part,
                                  dwproj, nullptr, s)))
    return err;
  if ((err = input_grad<XF_NONE, EPI_BF16>(dattn, B(wproj), M, C, C, nullptr,
                                           T, nullptr, dctx, s)))
    return err;
  static const int attn_attr = (int)cudaFuncSetAttribute(
      swin_bwd_attn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ATT_SMEM);
  if (attn_attr) return attn_attr;
  swin_bwd_attn_bwd_kernel<<<dim3(p.att_groups, heads), ATT_THREADS,
                             ATT_SMEM, s>>>(
      B(qkv), dctx, F(rel_bias), F(mask), nw_img, p.nw, T, C, scale,
      WinMap{nwh, nww, window, shift}, dqkv, part);
  if ((err = (int)cudaGetLastError())) return err;
  ReduceJobs rel{};
  rel.add(part, p.att_groups, (long long)heads * T * T,
          (long long)heads * T * T, drel_bias, false);
  if ((err = reduce(rel, s))) return err;
  if ((err = weight_grad<XF_COLSUM>(B(h1), dqkv, M, C, 3 * C, nullptr, T,
                                    part, dwqkv, O(dbqkv), s)))
    return err;

  // ---- dh1 = dqkv Wqkv^T, LN1 backward + residual: dx
  const LnArgs ln1{x, F(stats1), F(ln1s), dx2, nullptr, T, M, nullptr,
                   static_cast<bf16*>(dx), part};
  return dh_ln_c<false>(C, dqkv, B(wqkv), 3 * C, dh, ln1, O(dln1s),
                        O(dln1b), nullptr, s);
}
