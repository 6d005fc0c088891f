// Tensor-core building blocks shared by kernels B, C and H
// (swin_block.cu), D (swin_block_train.cu), K (merger_conv.cu), L
// (down1.cu) and the merger convs (merger_mma.cuh):
//
//   * PTX wrappers: cp.async (16 bytes, zero-fill past the edge),
//     ldmatrix (x2/x4, plain and transposed) and mma.sync m16n8k16 bf16
//     with f32 accumulation;
//   * fixed_order_reduce: out[i] = sum_p part[p][i] over per-block
//     partials, 32 outputs a block, warp w summing parts w, w + 8, ... in
//     order and the 8 warp sums added in order: parallel, no atomics, the
//     same bits on every run; ReduceJobs runs up to four in one launch;
//   * the pipelined GEMM core (GemmTile, gemm_mainloop): a 128 x BN x 64
//     block tile, 8 warps of 32 x BN/2, a ring of 3 stages filled by
//     cp.async while the tensor cores work on the oldest, ldmatrix and
//     mma.sync from padded (conflict-free) shared rows.  Each operand is
//     either k-contiguous ([rows][k]) or row-contiguous ([k][rows]), so
//     one core runs X W^T (input gradients) and X^T dY (weight gradients,
//     split over the k = token rows); an operand can be transformed in
//     shared memory after it lands (each row scaled by a per-window
//     factor and rounded again to bf16), and its column sums taken there
//     (per thread, for the bias gradients) at no extra read.
//
// Why this shape on an H100: mma.sync is fed from shared memory, so the
// tile sets how many ldmatrix a product costs: with a 128 x 96 tile a
// warp issues 5 ldmatrix.x4 per 12 mma (128 x 192: 8 per 24), and two
// 128 x 96 blocks fit an SM, so one block's epilogue overlaps the other's
// products; the 3-stage ring hides the global latency that the
// synchronous loads of kernel D's first version exposed, and 64-deep
// k-tiles halve its barriers (32-deep tiles in 4 stages measured slower
// at every stage shape of kernel D).  wgmma (operands
// straight from shared memory, no ldmatrix) and TMA are the next step
// for this core.
//
// Everything is in an anonymous namespace: each source that includes it
// gets its own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1,
                                          uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------------- reduce
constexpr int RED_THREADS = 256;  // 8 warps, 32 outputs a block

constexpr int SERIAL_PARTS = 16;  // up to this many: one thread an output

__device__ __forceinline__ void store_out(void* out, long long i, float v,
                                          bool to_bf16) {
  if (to_bf16)
    static_cast<bf16*>(out)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(out)[i] = v;
}

// out[i] = sum_{p < parts} part[p * stride + i] for i < n, as f32 or
// rounded to bf16, for the outputs of block `blk`: with few parts each
// thread sums one output's parts in order (RED_THREADS outputs a block),
// else 32 outputs a block, warp w summing parts w, w + 8, ... in order
// and the 8 warp sums added in order.
__device__ __forceinline__ void fixed_order_reduce(
    const float* __restrict__ part, int parts, long long stride,
    long long n, void* out, bool to_bf16, int blk) {
  if (parts <= SERIAL_PARTS) {
    const long long i = (long long)blk * RED_THREADS + threadIdx.x;
    if (i < n) {
      float s = 0.f;
      for (int p = 0; p < parts; ++p) s += part[(long long)p * stride + i];
      store_out(out, i, s, to_bf16);
    }
    return;
  }
  __shared__ float red[RED_THREADS / 32][33];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long i = (long long)blk * 32 + lane;
  float s = 0.f;
  if (i < n) {
#pragma unroll 4
    for (int p = w; p < parts; p += RED_THREADS / 32)
      s += part[(long long)p * stride + i];
  }
  red[w][lane] = s;
  __syncthreads();
  if (w == 0 && i < n) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < RED_THREADS / 32; ++k) t += red[k][lane];
    store_out(out, i, t, to_bf16);
  }
}

inline int reduce_blocks(long long n, int parts) {
  const int per = parts <= SERIAL_PARTS ? RED_THREADS : 32;
  return (int)((n + per - 1) / per);
}

// Up to four reductions in one launch (each as fixed_order_reduce): block
// b serves the job whose block range holds it.
struct ReduceJob {
  const float* part;
  long long stride, n;
  void* out;
  int parts, to_bf16;
};

struct ReduceJobs {
  ReduceJob job[4];
  int count, first[5];  // first[k]: job k's first block; first[count]: all

  void add(const float* part, int parts, long long stride, long long n,
           void* out, bool to_bf16) {
    if (count == 0) first[0] = 0;
    job[count] = ReduceJob{part, stride, n, out, parts, to_bf16 ? 1 : 0};
    first[count + 1] = first[count] + reduce_blocks(n, parts);
    ++count;
  }
};

__device__ __forceinline__ void fixed_order_reduce_jobs(
    const ReduceJobs& j) {
  int k = 0;
  while (k + 1 < j.count && (int)blockIdx.x >= j.first[k + 1]) ++k;
  const ReduceJob& r = j.job[k];
  fixed_order_reduce(r.part, r.parts, r.stride, r.n, r.out, r.to_bf16 != 0,
                     (int)blockIdx.x - j.first[k]);
}

// ------------------------------------------------------------- GEMM core
// One operand tile source: element (row, col) of the global matrix is at
// p[row * ld + col]; rows >= row_end or cols >= col_end read as zero.
// The block's tile starts at (row0, col0) for k-tile 0; k advances along
// the columns (k-contiguous operand) or along the rows.
struct Operand {
  const bf16* p;
  int ld, row0, row_end, col0, col_end;
};

// Transforms of one operand in shared memory once it has landed.
enum Xf { XF_NONE = 0, XF_SCALE = 1, XF_COLSUM = 2, XF_SCALE_COLSUM = 3 };

// A_K: A stored [m][k] (else [k][m]); B_K: B stored [n][k] (else [k][n]).
template <int BN_, bool A_K, bool B_K>
struct GemmTile {
  static constexpr int BM = 128, BN = BN_, BK = 64, STAGES = 3;
  static constexpr int THREADS = 256, WM = 4, WN = 2;
  static constexpr int WTM = BM / WM, WTN = BN / WN;
  static constexpr int MT = WTM / 16, NT = WTN / 8;
  static constexpr int A_ROWS = A_K ? BM : BK, A_COLS = A_K ? BK : BM;
  static constexpr int B_ROWS = B_K ? BN : BK, B_COLS = B_K ? BK : BN;
  static constexpr int A_LD = A_COLS + 8, B_LD = B_COLS + 8;  // +16 bytes
  static constexpr int A_ELEMS = A_ROWS * A_LD, B_ELEMS = B_ROWS * B_LD;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE * sizeof(bf16);
  static constexpr int A_CPT = (A_ROWS * A_COLS / 8 + THREADS - 1) / THREADS;
  static constexpr int B_CPT = (B_ROWS * B_COLS / 8 + THREADS - 1) / THREADS;
  static_assert(NT % 2 == 0, "B fragments load two n8 tiles at once");
};

// Issues the cp.async copies of k-tile kt of one operand (ROWS x COLS
// elements) into shared rows of `ld` elements.  A thread's chunks are
// c = tid, tid + THREADS, ...: the same (row, column) slots every k-tile.
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void load_operand(const Operand& op, bool k_cols,
                                             int kt, bf16* s, int ld) {
  constexpr int CPR = COLS / 8;
  for (int c = threadIdx.x; c < ROWS * CPR; c += THREADS) {
    const int r = c / CPR, cc = c % CPR;
    int grow = op.row0 + r, gcol = op.col0 + cc * 8;
    if (k_cols)
      gcol += kt * COLS;
    else
      grow += kt * ROWS;
    const bool ok = grow < op.row_end && gcol < op.col_end;
    const bf16* src = ok ? op.p + (size_t)grow * op.ld + gcol : op.p;
    cp_async16(smem_u32(s + r * ld + cc * 8), src, ok);
  }
}

// The transform of this thread's own chunks of a landed k-tile: with
// XF_SCALE each row's values become bf16(v * dp[row / tokens]) (rows past
// the edge: 0); with XF_COLSUM the (scaled, unrounded) values are added to
// cs[slot][e], the column sums of this thread's fixed chunks.
template <int ROWS, int COLS, int THREADS, int XF, int CPT>
__device__ __forceinline__ void transform_operand(
    const Operand& op, bool k_cols, int kt, bf16* s, int ld,
    const float* __restrict__ dp, int tokens, bool colsum,
    float (&cs)[CPT][8]) {
  constexpr int CPR = COLS / 8;
  int slot = 0;
  for (int c = threadIdx.x; c < ROWS * CPR; c += THREADS, ++slot) {
    const int r = c / CPR, cc = c % CPR;
    const int grow = op.row0 + r + (k_cols ? 0 : kt * ROWS);
    uint4* q = reinterpret_cast<uint4*>(s + r * ld + cc * 8);
    uint4 raw = *q;
    bf16* h = reinterpret_cast<bf16*>(&raw);
    float f = 1.f;
    if (XF & XF_SCALE) f = grow < op.row_end ? dp[grow / tokens] : 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float v = __bfloat162float(h[e]) * f;
      if ((XF & XF_COLSUM) && colsum) cs[slot][e] += v;
      if (XF & XF_SCALE) h[e] = __float2bfloat16(v);
    }
    if (XF & XF_SCALE) *q = raw;
  }
}

// The fragments of one 16-deep slice kk of a stage and their products.
template <class G>
__device__ __forceinline__ void mma_stage(const bf16* As, const bf16* Bs,
                                          int kk, int wm0, int wn0, int lane,
                                          float (&acc)[G::MT][G::NT][4],
                                          bool a_k, bool b_k) {
  uint32_t af[G::MT][4], bfr[G::NT][2];
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt) {
    const int m = wm0 + mt * 16;
    if (a_k)  // [m][k]: lanes 0-15 rows m.., k 0; lanes 16-31 k 8
      ldsm_x4(af[mt], smem_u32(As + (m + (lane & 15)) * G::A_LD + kk +
                               (lane >> 4) * 8));
    else {  // [k][m], transposed: matrix j = (k half j >> 1, m half j & 1)
      const int k = kk + (lane & 7) + ((lane >> 4) << 3);
      ldsm_x4_t(af[mt],
                smem_u32(As + k * G::A_LD + m + ((lane >> 3) & 1) * 8));
    }
  }
#pragma unroll
  for (int np = 0; np < G::NT / 2; ++np) {
    const int n = wn0 + np * 16;
    uint32_t r[4];
    if (b_k)  // [n][k]: matrix j = (n half j >> 1, k half j & 1)
      ldsm_x4(r, smem_u32(Bs + (n + (lane & 7) + ((lane >> 4) << 3)) *
                                   G::B_LD + kk + ((lane >> 3) & 1) * 8));
    else  // [k][n], transposed: matrix j = (k half j & 1, n half j >> 1)
      ldsm_x4_t(r, smem_u32(Bs + (kk + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                                     G::B_LD + n + (lane >> 4) * 8));
    bfr[2 * np][0] = r[0];
    bfr[2 * np][1] = r[1];
    bfr[2 * np + 1][0] = r[2];
    bfr[2 * np + 1][1] = r[3];
  }
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
      mma_bf16(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
}

// The block's accumulators over `ktiles` k-tiles of 32:
// acc[mt][nt][e] holds the product at row wm0 + mt*16 + lane/4 (+8 for
// e >= 2), column wn0 + nt*8 + (lane%4)*2 + (e&1) of the block tile, with
// wm0 = (warp / 2) * 32, wn0 = (warp % 2) * BN/2.  XA / XB transform A / B
// after they land (Xf); their column sums go to csa / csb when `colsum`.
// Ends with every copy drained and a __syncthreads, so the caller may
// reuse `smem`.
template <class G, bool A_K, bool B_K, int XA, int XB>
__device__ __forceinline__ void gemm_mainloop(
    const Operand& a, const Operand& b, int ktiles, const float* dp,
    int tokens, bool colsum, bf16* smem, float (&acc)[G::MT][G::NT][4],
    float (&csa)[G::A_CPT][8], float (&csb)[G::B_CPT][8]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm0 = (warp / G::WN) * G::WTM, wn0 = (warp % G::WN) * G::WTN;
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
  for (int s = 0; s < G::A_CPT; ++s)
#pragma unroll
    for (int e = 0; e < 8; ++e) csa[s][e] = 0.f;
#pragma unroll
  for (int s = 0; s < G::B_CPT; ++s)
#pragma unroll
    for (int e = 0; e < 8; ++e) csb[s][e] = 0.f;

  auto load = [&](int kt) {
    bf16* st = smem + (kt % G::STAGES) * G::STAGE;
    load_operand<G::A_ROWS, G::A_COLS, G::THREADS>(a, A_K, kt, st, G::A_LD);
    load_operand<G::B_ROWS, G::B_COLS, G::THREADS>(b, B_K, kt,
                                                   st + G::A_ELEMS, G::B_LD);
  };
#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) {
    if (s < ktiles) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<G::STAGES - 2>();  // this thread's copies of kt landed
    bf16* st = smem + (kt % G::STAGES) * G::STAGE;
    if (XA != XF_NONE)
      transform_operand<G::A_ROWS, G::A_COLS, G::THREADS, XA, G::A_CPT>(
          a, A_K, kt, st, G::A_LD, dp, tokens, colsum, csa);
    if (XB != XF_NONE)
      transform_operand<G::B_ROWS, G::B_COLS, G::THREADS, XB, G::B_CPT>(
          b, B_K, kt, st + G::A_ELEMS, G::B_LD, dp, tokens, colsum, csb);
    __syncthreads();  // every copy of kt visible; kt - 1's slot is free
    if (kt + G::STAGES - 1 < ktiles) load(kt + G::STAGES - 1);
    cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < G::BK; kk += 16)
      mma_stage<G>(st, st + G::A_ELEMS, kk, wm0, wn0, lane, acc, A_K, B_K);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Column sums of an operand's [ROWS][COLS] tile slots, from each thread's
// cs[slot][8], summed over the rows in order into out[col] (col < ncols):
// uses `scratch` (ROWS * COLS floats of shared memory).
template <int ROWS, int COLS, int THREADS, int CPT>
__device__ __forceinline__ void colsum_flush(const float (&cs)[CPT][8],
                                             float* scratch, float* out,
                                             int ncols) {
  constexpr int CPR = COLS / 8;
  int slot = 0;
  for (int c = threadIdx.x; c < ROWS * CPR; c += THREADS, ++slot)
#pragma unroll
    for (int e = 0; e < 8; ++e) scratch[c * 8 + e] = cs[slot][e];
  __syncthreads();
  for (int j = threadIdx.x; j < COLS && j < ncols; j += THREADS) {
    float s = 0.f;
    for (int r = 0; r < ROWS; ++r) s += scratch[(r * CPR + j / 8) * 8 + j % 8];
    out[j] = s;
  }
}

}  // namespace
