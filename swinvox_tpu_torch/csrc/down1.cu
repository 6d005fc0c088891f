// The backward of the refiner's first conv, Conv3d(1 -> 32, k4, p2),
// bias-free (kernel L): the weight gradient and the input gradient from
// one cotangent.
//
// Replaces the TPU kernel swinvox_tpu/ops/pallas_down1.py _bwd_kernel
// (through `conv3d_down1`, flag REFINER_DOWN1_PALLAS); its forward stays
// the stock conv there and here.  From x [N, 32^3] (one channel), the
// kernel W [4, 4, 4, 32] (DHWIO with I = 1) and dy [N, 33^3, 32]
// (channels-last), all bf16 or all f32:
//
//   dW[kd, kh, kw, c] = sum_n sum_o x_pad[n, o + k] * dy[n, o, c]
//   dx[n, i] = sum_k sum_c dy[n, i + 2 - k, c] * W[k, c]   (0 <= o < 33)
//
// with x_pad the input padded by 2 on each side.  Both gradients sum
// exact products in f32; dx is rounded once to the element type, dW
// stays f32 (the caller rounds it to the kernel's dtype).  Any N works:
// the TPU kernel's padding to 16 volumes is its sublane layout.
//
// Bound: at N = 8 the backward is 1.1 G multiply-adds (2.2 GFLOP) against
// 18.4 MB of dy (bf16) and 1 MB of x and dx: at the bf16 tensor-core rate
// it is bound by bytes (5.8 us).  The TPU kernel's design point is one
// streaming read of dy for both gradients, and so is the bf16 route's
// here, on the tensor cores (mma.sync m16n8k16, bf16 in, f32 sums):
//
//   * a block owns an input tile of 4 planes x 8 rows x 32 columns of one
//     volume (256 blocks at N = 8: two an SM on 132 SMs) and streams the
//     dy rows the tile reads, 7 planes of 11 rows (od in [id0 - 1,
//     id0 + 6), oh in [ih0 - 1, ih0 + 10)), one plane at a time through a
//     two-stage cp.async ring: each dy byte comes from device memory once
//     and again from L2 for the halo rows the neighbouring tiles share.
//     Tiling by input voxels, not by output rows, keeps every dx voxel in
//     one block, so dx needs no second pass and no atomics; the price is
//     the recomputed halo below;
//   * the input gradient, per staged row: R[iw, (kd, kh)] = sum over
//     (kw, c) of dy[od, oh, iw + 2 - kw, c] W[kd, kh, kw, c], an M = 32
//     columns, N = 16 taps, K = 128 product whose A rows are overlapping
//     128-wide windows of the staged row (ldmatrix straight from it) and
//     whose B is W, held in registers for the whole block; R goes to
//     shared memory and each thread adds, in a fixed order, the 16 R
//     entries that reach its 4 voxels (kd = id + 2 - od, kh = ih + 2 -
//     oh).  The halo rows' R is computed again by the neighbouring tiles
//     (77 rows for 32: 2.4x the products, which are not what binds);
//   * the weight gradient, per staged row the block owns (od in [id0,
//     id0 + 4), oh in [ih0, ih0 + 8), plus o = 32 in the last tiles):
//     dW[64 taps, 32 c] += Xpatch[64 taps, 48 positions] dy[48, 32], the
//     A fragments gathered from a halo of x pairs in shared memory
//     (x_pad[o + k]) and the B fragments from the staged dy row
//     (ldmatrix.trans; positions 33..47 read a zero chunk); a warp holds
//     one kd's 16 x 32 slice over half the rows, the two halves are added
//     in a fixed order, and the per-block partials go to a parallel
//     fixed-order reduce (mma_common.cuh): no atomics, the same inputs
//     give the same bits.
//
// Two launches: down1_tc_kernel and down1_dw_reduce_kernel.  The f32
// route keeps the CUDA cores (the tensor cores would round f32 inputs):
// down1_wgrad_kernel (one block per (volume, output plane, third of its
// rows) reads its dy rows once into shared memory and sums 8 taps of one
// channel a thread into a per-block partial), the same fixed-order
// reduce, and down1_dx_kernel (one thread per input voxel, 2048 FMAs,
// dy rows staged in shared memory), 34 us at 67 TFLOP/s by operations.
//
// The C entry point returns the first nonzero cudaGetLastError() of its
// launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int S = 32;             // input side
constexpr int SO = S + 1;         // output side (k4, p2)
constexpr int K = 4;              // kernel side
constexpr int C = 32;             // output channels
constexpr int NW = K * K * K * C; // 2048 weight-gradient entries
constexpr int THREADS = 256;

// ------------------------------------------------ bf16: tensor cores
constexpr int TD = 4, TH = 8;       // input planes and rows a block
constexpr int DT = S / TD, HT = S / TH;
constexpr int YROWS = TH + 3;       // dy rows of a plane a block stages
constexpr int YLD = C + 8;          // bf16 a staged position (80 bytes:
                                    // ldmatrix rows conflict-free)
constexpr int YSTAGE = YROWS * SO * YLD;
constexpr int RLD = 32 + 4;         // f32 a row of R [row][tap pair][iw]
constexpr int XPL = TD + 4, XRW = TH + 4;  // x halo planes and rows
constexpr int XCL = 52;             // x pairs a row: (x[p - 2], x[p - 1])
constexpr size_t Y_BYTES = 2 * (size_t)YSTAGE * sizeof(bf16);
constexpr size_t R_BYTES = (size_t)YROWS * 16 * RLD * sizeof(float);
constexpr size_t X_BYTES = (size_t)XPL * XRW * XCL * sizeof(uint32_t);
constexpr size_t TC_SMEM = Y_BYTES + R_BYTES + X_BYTES + 16;
static_assert(Y_BYTES % 16 == 0 && R_BYTES % 16 == 0 && X_BYTES % 16 == 0,
              "16-byte aligned regions");
static_assert(TH * 32 == THREADS, "a warp an input row, a lane a column");

long long tc_blocks(long long n) { return n * DT * HT; }

__global__ void __launch_bounds__(THREADS, 2)
    down1_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const bf16* __restrict__ dy, bf16* __restrict__ dx,
                    float* __restrict__ partial) {
  extern __shared__ __align__(128) unsigned char sm[];
  bf16* ys = reinterpret_cast<bf16*>(sm);          // [2][YROWS][SO][YLD]
  float* rs = reinterpret_cast<float*>(sm + Y_BYTES);  // [YROWS][16][RLD]
  uint32_t* xp = reinterpret_cast<uint32_t*>(sm + Y_BYTES + R_BYTES);
  bf16* zero = reinterpret_cast<bf16*>(sm + Y_BYTES + R_BYTES + X_BYTES);
  const int blk = blockIdx.x;
  const int n = blk / (DT * HT);
  const int id0 = (blk / HT) % DT * TD, ih0 = blk % HT * TH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const bf16* yv = dy + (size_t)n * SO * SO * SO * C;
  const bf16* xv = x + (size_t)n * S * S * S;

  // staged row r of a plane is oh = ih0 - 1 + r; rows outside the volume
  // are neither fetched nor read
  auto fetch = [&](int od, int slot) {
    bf16* dst = ys + slot * YSTAGE;
    for (int i = tid; i < YROWS * SO * 4; i += THREADS) {
      const int r = i / (SO * 4), ow = (i >> 2) % SO, cc = (i & 3) * 8;
      const int oh = ih0 - 1 + r;
      if (oh < 0 || oh >= SO) continue;
      cp_async16(smem_u32(dst + (r * SO + ow) * YLD + cc),
                 yv + (((size_t)od * SO + oh) * SO + ow) * C + cc, true);
    }
  };
  const int od_lo = max(id0 - 1, 0), od_hi = min(id0 + TD + 2, SO);
  fetch(od_lo, 0);
  cp_async_commit();

  // x pairs (x[d][h][p - 2], x[d][h][p - 1]) of planes id0 - 2 + pd, rows
  // ih0 - 2 + pr, zero outside the volume
  for (int i = tid; i < XPL * XRW * XCL; i += THREADS) {
    const int pd = i / (XRW * XCL), pr = (i / XCL) % XRW, pc = i % XCL;
    const int d = id0 - 2 + pd, h = ih0 - 2 + pr;
    uint32_t lo = 0, hi = 0;
    if (d >= 0 && d < S && h >= 0 && h < S) {
      const bf16* row = xv + ((size_t)d * S + h) * S;
      if (pc >= 2 && pc - 2 < S) lo = __bfloat16_as_ushort(row[pc - 2]);
      if (pc >= 1 && pc - 1 < S) hi = __bfloat16_as_ushort(row[pc - 1]);
    }
    xp[i] = lo | (hi << 16);
  }
  if (tid < 8) zero[tid] = __float2bfloat16(0.f);

  // W as the B operand of R: k = (kw', c) with kw = 3 - kw', n = kd * 4 +
  // kh; b0 holds k = 2q, 2q + 1 of column g, b1 k + 8
  uint32_t wb[8][2][2];
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int nn = nt * 8 + g;
      const int t = nn * K + 3 - (ks >> 1);  // (kd * 4 + kh) * 4 + kw
      const bf16* wt = w + t * C + (ks & 1) * 16 + 2 * q;
      wb[ks][nt][0] = *reinterpret_cast<const uint32_t*>(wt);
      wb[ks][nt][1] = *reinterpret_cast<const uint32_t*>(wt + 8);
    }

  // the weight gradient: this warp's kd and half of the owned rows (the
  // half with the extra row of a last tile goes to warps 4-7, which
  // compute one R row a plane where warps 0-2 compute two)
  const int mkd = warp & 3, half = (warp >> 2) ^ 1;
  const int nown = TH + (ih0 + TH == S ? 1 : 0);  // oh = 32: last tiles
  float dwa[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dwa[nt][e] = 0.f;
  float dxa[TD] = {0.f, 0.f, 0.f, 0.f};  // voxels (id0 + l, ih0 + warp, lane)
  const uint32_t zaddr = smem_u32(zero);

  int slot = 0;
  for (int od = od_lo; od < od_hi; ++od, slot ^= 1) {
    if (od + 1 < od_hi) fetch(od + 1, slot ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // plane od landed (od + 1 may fly)
    __syncthreads();     // ... for every thread; R is free again
    const bf16* yst = ys + slot * YSTAGE;

    // R of the staged rows, rows warp and warp + 8
    for (int r = warp; r < YROWS; r += 8) {
      const int oh = ih0 - 1 + r;
      if (oh < 0 || oh >= SO) continue;
      float ra[2][2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) ra[mt][nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          // A row iw: the 16 channels (ks & 1) * 16 of position
          // ow = iw - 1 + kw' (zero outside 0..32)
          const int ow = mt * 16 + (lane & 15) - 1 + (ks >> 1);
          const uint32_t addr =
              ow >= 0 && ow < SO
                  ? smem_u32(yst + (r * SO + ow) * YLD + (ks & 1) * 16 +
                             (lane >> 4) * 8)
                  : zaddr;
          uint32_t a[4];
          ldsm_x4(a, addr);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            mma_bf16(ra[mt][nt], a, wb[ks][nt][0], wb[ks][nt][1]);
        }
      float* rr = rs + r * 16 * RLD;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            rr[(nt * 8 + 2 * q + (e & 1)) * RLD + mt * 16 + g + (e >> 1) * 8] =
                ra[mt][nt][e];
    }

    // the weight gradient of the owned rows of an owned plane
    if ((od >= id0 && od < id0 + TD) || (od == S && id0 + TD == S)) {
      const int pd = od - id0 + mkd;  // x plane od + kd - 2
      for (int j = half; j < nown; j += 2) {
        const int r = j + 1;  // oh = ih0 + j
        // A rows g: (kh, kw) = (g / 4, g % 4); g + 8: kh + 2.  Element
        // (row, o) = x[od + kd - 2][oh + kh - 2][o + kw - 2], the low half
        // of pair o + kw
        const uint32_t* x0 = xp + (pd * XRW + j + (g >> 2)) * XCL + (g & 3) +
                             2 * q;
        const uint32_t* x1 = x0 + 2 * XCL;
#pragma unroll
        for (int ks = 0; ks < 3; ++ks) {
          const uint32_t a[4] = {x0[ks * 16], x1[ks * 16], x0[ks * 16 + 8],
                                 x1[ks * 16 + 8]};
          const int ow = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            const uint32_t addr =
                ow < SO ? smem_u32(yst + (r * SO + ow) * YLD + np * 16 +
                                   (lane >> 4) * 8)
                        : zaddr;
            uint32_t b[4];
            ldsm_x4_t(b, addr);
            mma_bf16(dwa[2 * np], a, b[0], b[1]);
            mma_bf16(dwa[2 * np + 1], a, b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // R of the plane is complete

    // dx: kd = id + 2 - od, row r = oh - ih0 + 1 with oh = ih + 2 - kh
#pragma unroll
    for (int l = 0; l < TD; ++l) {
      const int kd = id0 + l + 2 - od;
      if (kd < 0 || kd >= K) continue;
#pragma unroll
      for (int kh = 0; kh < K; ++kh) {
        const int oh = ih0 + warp + 2 - kh;
        if (oh < 0 || oh >= SO) continue;
        dxa[l] += rs[((warp + 3 - kh) * 16 + kd * 4 + kh) * RLD + lane];
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int l = 0; l < TD; ++l)
    dx[(size_t)n * S * S * S + ((size_t)(id0 + l) * S + ih0 + warp) * S +
       lane] = __float2bfloat16(dxa[l]);

  // the block's partial: warps 4-7 add warps 0-3's half, in that order
  __syncthreads();  // every thread is done reading R
  float* red = rs;  // [4 kd][4 nt][4 e][32 lanes]
  if (half == 1)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[((mkd * 4 + nt) * 4 + e) * 32 + lane] = dwa[nt][e];
  __syncthreads();
  if (half == 0) {
    float* part = partial + (size_t)blk * NW;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = mkd * 16 + g + (e >> 1) * 8;
        const int c = nt * 8 + 2 * q + (e & 1);
        part[t * C + c] =
            dwa[nt][e] + red[((mkd * 4 + nt) * 4 + e) * 32 + lane];
      }
  }
}

// ------------------------------------------------- f32: CUDA cores
// weight gradient: 11 output rows per block, 3 blocks per plane
constexpr int WR = 11;
constexpr int WBLK = SO / WR;     // 3
constexpr int XR = WR + K - 1;    // 14 input rows
constexpr int XW = SO + K - 1;    // 36 input columns (-2 .. 33)
// input gradient: 8 input rows per block, 4 blocks per plane
constexpr int DR = 8;
constexpr int DBLK = S / DR;      // 4
constexpr int YR = DR + K - 1;    // 11 dy rows
constexpr int YW = SO + 2;        // 35 dy columns (-1 .. 33)

size_t wgrad_smem() { return sizeof(float) * (WR * SO * C + K * XR * XW); }
size_t dx_smem() { return sizeof(float) * (YR * C * YW + NW); }
long long wgrad_blocks(long long n) { return n * SO * WBLK; }

__global__ void __launch_bounds__(THREADS)
    down1_wgrad_kernel(const float* __restrict__ x,
                       const float* __restrict__ dy,
                       float* __restrict__ partial) {
  extern __shared__ __align__(16) float fsm[];
  float* dys = fsm;                  // [WR][SO][C]
  float* xs = fsm + WR * SO * C;     // [K][XR][XW]
  const int blk = blockIdx.x;
  const int n = blk / (SO * WBLK), od = (blk / WBLK) % SO;
  const int oh0 = (blk % WBLK) * WR;
  const int tid = threadIdx.x;

  // the block's dy rows are contiguous: [oh0, oh0 + WR) x 33 x 32
  const float* src = dy + (((size_t)n * SO + od) * SO + oh0) * SO * C;
  for (int i = tid; i < WR * SO * C; i += THREADS) dys[i] = src[i];
  for (int i = tid; i < K * XR * XW; i += THREADS) {
    const int kd = i / (XR * XW), r = (i / XW) % XR, col = i % XW;
    const int id = od + kd - 2, ih = oh0 + r - 2, iw = col - 2;
    float v = 0.f;
    if (id >= 0 && id < S && ih >= 0 && ih < S && iw >= 0 && iw < S)
      v = x[(((size_t)n * S + id) * S + ih) * S + iw];
    xs[i] = v;
  }
  __syncthreads();

  // thread: channel c, taps kd = warp / 2, kh in {kh0, kh0 + 1}, kw 0..3
  const int c = tid % 32, warp = tid / 32;
  const int kd = warp / 2, kh0 = (warp % 2) * 2;
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  for (int r = 0; r < WR; ++r) {
    const float* x0 = xs + (kd * XR + r + kh0) * XW;
    const float* x1 = x0 + XW;
    const float* gr = dys + r * SO * C + c;
    for (int ow = 0; ow < SO; ++ow) {
      const float gv = gr[ow * C];
#pragma unroll
      for (int kw = 0; kw < K; ++kw) {
        acc[kw] = fmaf(x0[ow + kw], gv, acc[kw]);
        acc[4 + kw] = fmaf(x1[ow + kw], gv, acc[4 + kw]);
      }
    }
  }
  float* part = partial + (size_t)blk * NW;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int kh = kh0 + j / 4, kw = j % 4;
    part[((kd * K + kh) * K + kw) * C + c] = acc[j];
  }
}

__global__ void __launch_bounds__(THREADS)
    down1_dx_kernel(const float* __restrict__ w, const float* __restrict__ dy,
                    float* __restrict__ dx) {
  extern __shared__ __align__(16) float fsm[];
  float* dys = fsm;                  // [YR][C][YW]: row oh0 - 1 + ph,
                                     // column ow = j - 1
  float* ws = fsm + YR * C * YW;     // [64][32]
  const int blk = blockIdx.x;
  const int n = blk / (S * DBLK), id = (blk / DBLK) % S;
  const int ih0 = (blk % DBLK) * DR;
  const int tid = threadIdx.x;
  const int r = tid / 32, col = tid % 32;  // the voxel (id, ih0 + r, col)

  for (int i = tid; i < NW; i += THREADS) ws[i] = w[i];
  float acc = 0.f;
  for (int kd = 0; kd < K; ++kd) {
    const int od = id + 2 - kd;
    if (od < 0 || od >= SO) continue;  // the same for the whole block
    __syncthreads();
    // global reads with c fastest (coalesced); shared writes at stride
    // YW = 35, coprime with the 32 banks
    for (int i = tid; i < YR * YW * C; i += THREADS) {
      const int c = i % C, j = (i / C) % YW, ph = i / (C * YW);
      const int oh = ih0 - 1 + ph, ow = j - 1;
      float v = 0.f;
      if (oh >= 0 && oh < SO && ow >= 0 && ow < SO)
        v = dy[((((size_t)n * SO + od) * SO + oh) * SO + ow) * C + c];
      dys[(ph * C + c) * YW + j] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kh = 0; kh < K; ++kh) {
      // oh = ih + 2 - kh, i.e. ph = r + 3 - kh in [0, YR)
      const float* row = dys + (r + 3 - kh) * C * YW;
#pragma unroll
      for (int kw = 0; kw < K; ++kw) {
        // ow = col + 2 - kw, i.e. j = col + 3 - kw in [0, YW)
        const float* y = row + col + 3 - kw;
        const float* wt = ws + ((kd * K + kh) * K + kw) * C;
#pragma unroll 8
        for (int c = 0; c < C; ++c) acc = fmaf(y[c * YW], wt[c], acc);
      }
    }
  }
  dx[(((size_t)n * S + id) * S + ih0 + r) * S + col] = acc;
}

// ------------------------------------------------------------ reduce
// dw[i] = sum_b partial[b * NW + i] in a fixed order, in parallel.
__global__ void __launch_bounds__(RED_THREADS)
    down1_dw_reduce_kernel(const float* __restrict__ partial, int parts,
                           float* __restrict__ dw) {
  fixed_order_reduce(partial, parts, NW, NW, dw, false, blockIdx.x);
}

size_t align256(size_t b) { return (b + 255) / 256 * 256; }

int reduce_dw(const float* part, long long parts, float* dw, cudaStream_t s) {
  down1_dw_reduce_kernel<<<reduce_blocks(NW, (int)parts), RED_THREADS, 0,
                           s>>>(part, (int)parts, dw);
  return (int)cudaGetLastError();
}

int down1_bwd_bf16(const bf16* x, const bf16* w, const bf16* dy, bf16* dx,
                   float* dw, float* part, long long n, cudaStream_t s) {
  static const int attr = [] {  // once
    const int e = (int)cudaFuncSetAttribute(
        down1_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)TC_SMEM);
    return e ? e
             : (int)cudaFuncSetAttribute(
                   down1_tc_kernel,
                   cudaFuncAttributePreferredSharedMemoryCarveout,
                   (int)cudaSharedmemCarveoutMaxShared);
  }();
  if (attr) return attr;
  const long long blocks = tc_blocks(n);
  down1_tc_kernel<<<(unsigned)blocks, THREADS, TC_SMEM, s>>>(x, w, dy, dx,
                                                             part);
  int err = (int)cudaGetLastError();
  return err ? err : reduce_dw(part, blocks, dw, s);
}

int down1_bwd_f32(const float* x, const float* w, const float* dy, float* dx,
                  float* dw, float* part, long long n, cudaStream_t s) {
  int err = (int)cudaFuncSetAttribute(
      down1_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)wgrad_smem());
  if (err) return err;
  err = (int)cudaFuncSetAttribute(
      down1_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dx_smem());
  if (err) return err;
  const long long wb = wgrad_blocks(n);
  down1_wgrad_kernel<<<(unsigned)wb, THREADS, wgrad_smem(), s>>>(x, dy, part);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = reduce_dw(part, wb, dw, s))) return err;
  down1_dx_kernel<<<(unsigned)(n * S * DBLK), THREADS, dx_smem(), s>>>(w, dy,
                                                                       dx);
  return (int)cudaGetLastError();
}

}  // namespace

// The larger of the two routes' partials (the f32 route's 99 blocks a
// volume against the bf16 route's 32).
extern "C" long long swinvox_down1_bwd_workspace(long long n) {
  return (long long)align256(sizeof(float) * wgrad_blocks(n) * NW);
}

// Kernel L.  x [n, 32^3], w [64][32], dy [n, 33^3, 32], dx [n, 32^3]: bf16
// (is_bf16 = 1; dy 16-byte aligned, read by cp.async) or f32; dw [64][32]
// f32; work: swinvox_down1_bwd_workspace bytes.
extern "C" int swinvox_down1_bwd(const void* x, const void* w, const void* dy,
                                 void* dx, void* dw, void* work,
                                 long long work_bytes, long long n,
                                 int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return (int)cudaMemsetAsync(dw, 0, sizeof(float) * NW, s);
  if (work_bytes < swinvox_down1_bwd_workspace(n))
    return (int)cudaErrorInvalidValue;
  float* DW = static_cast<float*>(dw);
  float* part = static_cast<float*>(work);
  if (is_bf16)
    return down1_bwd_bf16(static_cast<const bf16*>(x),
                          static_cast<const bf16*>(w),
                          static_cast<const bf16*>(dy), static_cast<bf16*>(dx),
                          DW, part, n, s);
  return down1_bwd_f32(static_cast<const float*>(x),
                       static_cast<const float*>(w),
                       static_cast<const float*>(dy), static_cast<float*>(dx),
                       DW, part, n, s);
}
