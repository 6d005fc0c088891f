// The merger's 3x3x3 conv on the tensor cores, shared by kernels E, F and
// I (merger_stack.cu) and kernels J and K (merger_conv.cu): every bf16
// merger conv of the port.  Volumes are 32^3, channels-last, bf16; bf16 x
// bf16 products are exact in f32, so only the order of the f32 sums
// differs from the plain version.  No atomics: every output voxel has one
// writer and every sum is a per-block partial reduced in a fixed order.
//
//   * The halo: a block stages its input rows in shared memory with 16
//     channels (32 bytes) a position, the two 16-byte halves swizzled by
//     bit 2 of the position so the 8 rows of an ldmatrix never share a
//     bank (kw_x_off).  A BatchNorm layer's raw output is normalized on
//     read, bf16(leaky(r * scale + shift)); kernel F's input gradients
//     read dr on read from r and the f32 gradient dA reaching the layer's
//     activation (dr_on_read, the layer's DR_TAB table).  The conv's zero
//     padding, the w = -1 and 32 columns and the padded channels are zero
//     in activation space: they never pass through the affine, whose
//     leaky(shift) is not zero.  tc_convert stages whole voxels, a pair of
//     positions a thread (36 bytes of r are 4-byte aligned), from rows
//     that cp.async copied into shared memory or straight from device
//     memory; stage_group one position a thread (36-channel inputs);
//     tc_convert_wide one position a thread with 8-byte loads (kernel J's
//     interleaved 36-channel input, a 16-channel group at a time).
//   * mstack_tc_conv_kernel (E's six convs, F's input gradients, I's six
//     convs, J's 9 -> 9, 36 -> 9, 9 -> 1 and 9 -> 36): an implicit GEMM,
//     M = 16 consecutive w positions of one (volume, d, h) row, N = C_out
//     padded to 8 or 16 (40 for a 9 -> 36 input gradient), depth = one
//     16-channel group of one tap.  A warp owns RW
//     output rows of a w-half: per (kd, kw) its three kh taps' B
//     fragments (the weights, in shared memory in fragment order) go to
//     registers and each A fragment (an ldmatrix of 16 positions of one
//     halo row) serves the up to three output rows that read that row.
//     A one-source conv of raw or normalized rows copies the next tile's
//     rows while the current one multiplies.  Epilogues: + bias, bf16, the
//     per-block sums of the rounded outputs and their squares (E); the
//     flipped, channel-swapped kernel's products into f32, written or
//     added, or into bf16 dx (F); the sum rounded once to bf16 (J); the
//     folded BatchNorm z * s + t on the f32 sum, LeakyReLU, then bf16 (f32
//     for the last layer's logits) (I).
//   * mstack_tc_conv1_kernel: a 1 -> 9 conv (F's layer-5 input gradient,
//     J's 1 -> 9 adjoint): one input channel, so the 27 taps are gathered
//     into the depth (27 -> 32, two k16 steps) instead of padding one
//     channel to 16 per tap.
//   * merger_wgrad_mma_kernel (kernel K's body; F's weight gradients): the
//     weight gradient as an implicit GEMM, M = 27 taps x C_in, N = C_out,
//     depth = every voxel: nine warps, one per (kh, kw), each owning the
//     three kd taps; per 16 voxels a warp loads dy's B fragment once and
//     runs 3 x groups x n8 mma.sync m16n8k16.  F's sources are normalized
//     on read and its dy is dr on read (the bias gradient summed beside
//     it); a fixed grid walks contiguous runs of tiles and writes one
//     27 x C_in x C_out partial a block, summed by
//     merger_wgrad_reduce_kernel in parallel and in a fixed order.
//
// What bounds them on an H100: the staging of the halo, the epilogues and
// the shared-memory traffic of mma.sync's operands more than the products;
// phase 9 of chip_smoke.py reads the convs' rate, per launch and in
// TFLOP/s of the padded work, far under the tensor cores'.
//
// Everything is in an anonymous namespace: each source that includes it
// gets its own copy.
#pragma once

#include "merger_common.cuh"
#include "mma_common.cuh"

namespace {

constexpr int TC_SMS = 132;  // H100 SXM
constexpr int SMEM_PER_SM = 232448 - 8 * 1024;  // less the blocks' reserve

// The sources of a staged halo: channel s * C + c of the conv's input is
// channel c of p[s]; aff[s] (null: raw) holds its BatchNorm affine,
// scale [C] then shift [C].  For dr on read (kernel F's BatchNorm
// backward folded into the staging), p[0] is a layer's raw output r
// (bf16, 9 channels), da the gradient reaching its activation (f32) and
// aff[0] the layer's table (DR_TAB floats).
struct Src {
  const bf16* p[4];
  const float* aff[4];
  const float* da;
};

// The per-channel table of dr on read, [5][9]: the normalize scale A and
// shift B, gi = gamma * inv, K0 = gi * (inv * mean * S2 - S1) / n and
// K1 = -gi * inv * S2 / n, with inv = 1 / sqrt(var + eps), S1 = sum e
// (dbeta) and S2 = sum e * xhat (dgamma), so that
//   e = dA * leaky'(r * A + B),  xhat = (r - mean) * inv,
//   dr = gi * (e - S1 / n - xhat * S2 / n) = gi * e + K0 + K1 * r,
// rounded to bf16.
constexpr int DR_TAB = 45;

__device__ __forceinline__ bf16 dr_on_read(float x, float da,
                                           const float* t, int c,
                                           float leaky) {
  const float e = da * (fmaf(x, t[c], t[9 + c]) > 0.f ? 1.f : leaky);
  return __float2bfloat16(fmaf(t[36 + c], x, fmaf(t[18 + c], e, t[27 + c])));
}

// Element offset of channel half `h` (0, 1) of halo position `pos` in
// group `g`: 16 channels a position, halves swapped by bit 2 of pos.
__device__ __forceinline__ int kw_x_off(int g, int npos, int pos, int h) {
  return (g * npos + pos) * 16 + ((h ^ ((pos >> 2) & 1)) << 3);
}

// The affines of the sources into shared memory, affs[s][2][C]; with
// DRR the dr-on-read table, affs[DR_TAB].
template <int C, int NSRC, bool DRR>
__device__ __forceinline__ void load_affines(const Src& src, float* affs) {
  if (DRR) {
    for (int i = threadIdx.x; i < DR_TAB; i += blockDim.x)
      affs[i] = src.aff[0][i];
    return;
  }
#pragma unroll
  for (int s = 0; s < NSRC; ++s) {  // constant indices: src stays a param
    const float* aff = src.aff[s];
    for (int i = threadIdx.x; i < 2 * C; i += blockDim.x)
      affs[s * 2 * C + i] = aff ? aff[i] : 0.f;
  }
}

template <int C, int NSRC, bool DRR>
constexpr int tab_floats() {
  return DRR ? DR_TAB : NSRC * 2 * C;
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Stages 16-channel group G of the weight gradient's x (channels 16 G ..
// 16 G + 15 of the concatenated sources) for halo rows [d0 - 1, d0 + DR -
// 1) x [h0 - 1, h0 + HR - 1) of volume v into xt (position row * TW + w +
// 1): one thread a position, every channel of it (padding and positions
// outside the volume as zeros, never through the affine), two 16-byte
// stores.  Overwrites the whole group.
template <int G, int C, int NSRC, int DR, int HR>
__device__ __forceinline__ void stage_group(const Src& src,
                                            const float* affs, float leaky,
                                            int v, int d0, int h0,
                                            bf16* xt) {
  constexpr int NPOS = DR * HR * TW;
#pragma unroll 2
  for (int i = threadIdx.x; i < NPOS; i += blockDim.x) {
    const int row = i / TW, gw = i % TW - 1;
    const int gd = d0 + row / HR - 1, gh = h0 + row % HR - 1;
    const bool in = gd >= 0 && gd < S && gh >= 0 && gh < S && gw >= 0 &&
                    gw < S;
    const size_t vox = in ? (((size_t)v * S + gd) * S + gh) * S + gw : 0;
    uint32_t pk[8];
#pragma unroll
    for (int j = 0; j < 16; j += 2) {
      bf16 e[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        constexpr int CIN = C * NSRC;
        const int ch = 16 * G + j + q;  // constant: s and c are too
        e[q] = __float2bfloat16(0.f);
        if (ch < CIN && in) {
          const int s = ch / C, c = ch % C;
          e[q] = src.p[s][vox * C + c];
          if (src.aff[s]) {
            const float* a = affs + s * 2 * C;
            float z = __bfloat162float(e[q]) * a[c] + a[C + c];
            z = z > 0.f ? z : z * leaky;
            e[q] = __float2bfloat16(z);
          }
        }
      }
      pk[j / 2] = pack_bf16(e[0], e[1]);
    }
    *reinterpret_cast<uint4*>(xt + kw_x_off(0, NPOS, i, 0)) =
        make_uint4(pk[0], pk[1], pk[2], pk[3]);
    *reinterpret_cast<uint4*>(xt + kw_x_off(0, NPOS, i, 1)) =
        make_uint4(pk[4], pk[5], pk[6], pk[7]);
  }
}

// Converts a tile's input rows into the halo (group 0, C = 9 channels),
// from the raw rows in shared memory (RAW_ROW bytes apart) or (GLOBAL)
// from src's rows in device memory: one thread a pair of positions (w =
// 2k, 2k + 1: 36 bytes of r, 4-byte aligned), normalized on read
// (has_aff) or dr on read (DRR, with 72 bytes of dA from device memory),
// the w = -1 and 32 columns and rows outside the volume zero; four 16-byte
// stores.
template <int DR, int HR, int RAW_ROW, bool DRR, bool GLOBAL>
__device__ __forceinline__ void tc_convert(const unsigned char* raw,
                                           const Src& src, int v,
                                           const float* tab, bool has_aff,
                                           float leaky, int d0, int h0,
                                           bf16* xt) {
  static_assert(GLOBAL || !DRR, "dA is read from device memory");
  constexpr int ITEMS = S / 2 + 1;  // 16 pairs and the two border columns
  constexpr int NPOS = DR * HR * TW;
  for (int i = threadIdx.x; i < DR * HR * ITEMS; i += blockDim.x) {
    const int row = i / ITEMS, k = i % ITEMS;
    const int gd = d0 + row / HR - 1, gh = h0 + row % HR - 1;
    const bool in = gd >= 0 && gd < S && gh >= 0 && gh < S && k < S / 2;
    const int p = row * TW + (k < S / 2 ? 2 * k + 1 : 0);
    const int p1 = k < S / 2 ? p + 1 : row * TW + TW - 1;
    uint32_t pk[2][8];
#pragma unroll
    for (int j = 0; j < 8; ++j) pk[0][j] = pk[1][j] = 0u;
    if (in) {
      const size_t vrow = (((size_t)v * S + gd) * S + gh) * S * 9;
      const uint32_t* rw =
          (GLOBAL ? reinterpret_cast<const uint32_t*>(src.p[0] + vrow)
                  : reinterpret_cast<const uint32_t*>(raw + row * RAW_ROW)) +
          9 * k;
      bf16 q[18];
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        const uint32_t wv = rw[j];
        q[2 * j] = __ushort_as_bfloat16((unsigned short)(wv & 0xffffu));
        q[2 * j + 1] = __ushort_as_bfloat16((unsigned short)(wv >> 16));
      }
      if (DRR) {
        const float2* dw = reinterpret_cast<const float2*>(src.da + vrow) +
                           9 * k;
#pragma unroll
        for (int j = 0; j < 9; ++j) {
          const float2 d = dw[j];
          q[2 * j] = dr_on_read(__bfloat162float(q[2 * j]), d.x, tab,
                                (2 * j) % 9, leaky);
          q[2 * j + 1] = dr_on_read(__bfloat162float(q[2 * j + 1]), d.y,
                                    tab, (2 * j + 1) % 9, leaky);
        }
      } else if (has_aff) {
#pragma unroll
        for (int j = 0; j < 18; ++j) {
          const int c = j % 9;
          float z = __bfloat162float(q[j]) * tab[c] + tab[9 + c];
          z = z > 0.f ? z : z * leaky;
          q[j] = __float2bfloat16(z);
        }
      }
#pragma unroll
      for (int v = 0; v < 2; ++v) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pk[v][j] = pack_bf16(q[9 * v + 2 * j], q[9 * v + 2 * j + 1]);
        pk[v][4] = pack_bf16(q[9 * v + 8], __float2bfloat16(0.f));
      }
    }
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int pos = v ? p1 : p;
      *reinterpret_cast<uint4*>(xt + kw_x_off(0, NPOS, pos, 0)) =
          make_uint4(pk[v][0], pk[v][1], pk[v][2], pk[v][3]);
      *reinterpret_cast<uint4*>(xt + kw_x_off(0, NPOS, pos, 1)) =
          make_uint4(pk[v][4], pk[v][5], pk[v][6], pk[v][7]);
    }
  }
}

// Stages 16-channel group `grp` (channels 16 grp .. 16 grp + 15, zeros
// past C) of one raw source of C interleaved channels (kernel J's 36: the
// merger's concatenated activations) for halo rows [d0 - 1, d0 + DR - 1)
// x [h0 - 1, h0 + HR - 1) of volume v: one thread a position, 8-byte loads
// (a position is 2 C bytes, 8-byte aligned for C % 4 == 0), two 16-byte
// stores; positions outside the volume and the w = -1, 32 columns zero.
template <int DR, int HR, int C>
__device__ __forceinline__ void tc_convert_wide(const bf16* __restrict__ src,
                                                int grp, int v, int d0,
                                                int h0, bf16* xt) {
  static_assert(C % 4 == 0, "8-byte loads of whole positions");
  constexpr int NPOS = DR * HR * TW;
  for (int i = threadIdx.x; i < NPOS; i += blockDim.x) {
    const int row = i / TW, gw = i % TW - 1;
    const int gd = d0 + row / HR - 1, gh = h0 + row % HR - 1;
    uint2 q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) q[j] = make_uint2(0u, 0u);
    if (gd >= 0 && gd < S && gh >= 0 && gh < S && gw >= 0 && gw < S) {
      const uint2* p = reinterpret_cast<const uint2*>(
          src + ((((size_t)v * S + gd) * S + gh) * S + gw) * C + 16 * grp);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (16 * grp + 4 * j < C) q[j] = p[j];
    }
    *reinterpret_cast<uint4*>(xt + kw_x_off(0, NPOS, i, 0)) =
        make_uint4(q[0].x, q[0].y, q[1].x, q[1].y);
    *reinterpret_cast<uint4*>(xt + kw_x_off(0, NPOS, i, 1)) =
        make_uint4(q[2].x, q[2].y, q[3].x, q[3].y);
  }
}

// ------------------------------------------------ weight gradient (F, K)
constexpr int KW_WARPS = 9;  // one per (kh, kw); each owns kd = 0, 1, 2
constexpr int KW_THREADS = 32 * KW_WARPS;

template <int CI, int CO>
struct Kw {
  static constexpr int NG = (CI + 15) / 16;  // 16-channel groups of x
  static constexpr int COP = CO > 8 ? 16 : 8;  // dy channels, padded
  static constexpr int NT = COP / 8;           // n8 tiles
  static constexpr int DT = 2, HT = NG == 1 ? 8 : 4;  // output tile
  static constexpr int DR = DT + 2, HR = HT + 2;      // halo rows
  static constexpr int NPOS = DR * HR * TW;           // halo positions
  static constexpr int VOX = DT * HT * S;             // output voxels
  static constexpr int X_ELEMS = NG * NPOS * 16;
  static constexpr size_t XD_BYTES = sizeof(bf16) * (X_ELEMS + VOX * COP);
  // the sources' affines, then the dr-on-read table of dy
  static constexpr size_t SMEM = XD_BYTES + sizeof(float) * (2 * CI + DR_TAB);
  static constexpr int TILES = (S / DT) * (S / HT);   // per volume
  static constexpr int PER_SM = NG == 1 ? 3 : 2;      // by shared memory
};

template <int COP>
__device__ __forceinline__ int kw_dy_off(int q, int h) {
  return COP == 16 ? q * 16 + ((h ^ ((q >> 2) & 1)) << 3) : q * 8;
}

// One block walks tiles [blockIdx.x * per, + per) of (volume, DT planes,
// HT rows) and writes its partial dW [27][CI][CO] to part[blockIdx.x].
// x: NSRC sources of CI / NSRC channels (normalized on read where the
// source has an affine).  dy: [V][CO] bf16, or with DRR (kernel F's
// layers 0..4, CO = 9) dr on read from dsrc, whose per-channel sums of
// the rounded dr (the conv's bias gradient) go to dbpart[blockIdx.x].
template <int CI, int CO, int NSRC, bool DRR>
__global__ void __launch_bounds__(KW_THREADS, Kw<CI, CO>::PER_SM)
    merger_wgrad_mma_kernel(Src src, const bf16* __restrict__ dy, Src dsrc,
                            int tiles, int per, float leaky,
                            float* __restrict__ part,
                            float* __restrict__ dbpart) {
  using K = Kw<CI, CO>;
  constexpr int C = CI / NSRC;
  extern __shared__ __align__(16) unsigned char kw_smem[];
  bf16* ksm = reinterpret_cast<bf16*>(kw_smem);
  bf16* xt = ksm;
  bf16* dyt = ksm + K::X_ELEMS;
  float* affs = reinterpret_cast<float*>(kw_smem + K::XD_BYTES);
  float* tab = affs + 2 * CI;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kh = warp / 3, kw = warp % 3;
  {  // zero once: dy's padding channels stay zero
    uint4* z = reinterpret_cast<uint4*>(ksm);
    const int n16 = (int)(K::XD_BYTES / 16);
    for (int i = tid; i < n16; i += KW_THREADS) z[i] = make_uint4(0, 0, 0, 0);
  }
  load_affines<C, NSRC, false>(src, affs);
  if (DRR) load_affines<9, 1, true>(dsrc, tab);
  float acc[3][K::NG][K::NT][4];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int g = 0; g < K::NG; ++g)
#pragma unroll
      for (int t = 0; t < K::NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][g][t][e] = 0.f;
  float sb[9];  // DRR: this thread's sums of dr, in order
#pragma unroll
  for (int c = 0; c < 9; ++c) sb[c] = 0.f;

  const int t_end = min(tiles, ((int)blockIdx.x + 1) * per);
  for (int tile = (int)blockIdx.x * per; tile < t_end; ++tile) {
    const int v = tile / K::TILES, r = tile % K::TILES;
    const int d0 = (r / (S / K::HT)) * K::DT, h0 = (r % (S / K::HT)) * K::HT;
    __syncthreads();  // the previous tile's fragments are read
    if (K::NG == 1 && C == 9) {  // whole voxels, 4-byte loads
      tc_convert<K::DR, K::HR, 0, false, true>(nullptr, src, v, affs,
                                               src.aff[0] != nullptr, leaky,
                                               d0, h0, xt);
    } else {
      stage_group<0, C, NSRC, K::DR, K::HR>(src, affs, leaky, v, d0, h0,
                                            xt);
      if (K::NG > 1)
        stage_group<1, C, NSRC, K::DR, K::HR>(src, affs, leaky, v, d0, h0,
                                              xt + K::NPOS * 16);
      if (K::NG > 2)
        stage_group<2, C, NSRC, K::DR, K::HR>(src, affs, leaky, v, d0, h0,
                                              xt + 2 * K::NPOS * 16);
    }
    if (DRR) {  // one voxel a thread: dr from r and dA, 16 channels
      for (int q = tid; q < K::VOX; q += KW_THREADS) {
        const int gd = d0 + q / (K::HT * S), gh = h0 + (q / S) % K::HT;
        const size_t vox = (((size_t)v * S + gd) * S + gh) * S + q % S;
        uint32_t pk[8];
#pragma unroll
        for (int j = 0; j < 16; j += 2) {
          bf16 e[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int c = j + u;
            e[u] = __float2bfloat16(0.f);
            if (c < 9) {
              e[u] = dr_on_read(__bfloat162float(dsrc.p[0][vox * 9 + c]),
                                dsrc.da[vox * 9 + c], tab, c, leaky);
              sb[c] += __bfloat162float(e[u]);
            }
          }
          pk[j / 2] = pack_bf16(e[0], e[1]);
        }
        *reinterpret_cast<uint4*>(dyt + kw_dy_off<16>(q, 0)) =
            make_uint4(pk[0], pk[1], pk[2], pk[3]);
        *reinterpret_cast<uint4*>(dyt + kw_dy_off<16>(q, 1)) =
            make_uint4(pk[4], pk[5], pk[6], pk[7]);
      }
    } else {
      constexpr int DU = 4 * CO;  // uint4 per output row of dy
      for (int i = tid; i < K::DT * K::HT * DU; i += KW_THREADS) {
        const int row = i / DU, u = i % DU;
        const int gd = d0 + row / K::HT, gh = h0 + row % K::HT;
        const uint4 raw = reinterpret_cast<const uint4*>(
            dy + ((((size_t)v * S + gd) * S + gh) * S) * CO)[u];
        const bf16* h8 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int el = u * 8 + e, w = el / CO, c = el % CO;
          dyt[kw_dy_off<K::COP>(row * S + w, c >> 3) + (c & 7)] = h8[e];
        }
      }
    }
    __syncthreads();

    for (int step = 0; step < K::DT * K::HT * 2; ++step) {
      const int row = step >> 1, w0 = (step & 1) * 16;
      const int dd = row / K::HT, hh = row % K::HT;
      uint32_t b[K::NT][2];
      {
        const int j = lane >> 3, rr = lane & 7;
        if (K::COP == 16) {  // matrix j: k half j & 1, n half j >> 1
          const int q = row * S + w0 + rr + ((j & 1) << 3);
          uint32_t f[4];
          ldsm_x4_t(f, smem_u32(dyt + kw_dy_off<K::COP>(q, j >> 1)));
          b[0][0] = f[0];
          b[0][1] = f[1];
          b[K::NT - 1][0] = f[2];
          b[K::NT - 1][1] = f[3];
        } else {  // lanes 0-15: k half (lane >> 3) & 1
          const int q = row * S + w0 + rr + ((j & 1) << 3);
          ldsm_x2_t(b[0][0], b[0][1], smem_u32(dyt + kw_dy_off<K::COP>(q, 0)));
        }
      }
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
        const int pos0 = ((dd + kd) * K::HR + hh + kh) * TW + w0 + kw;
        // matrix j: k (voxel) half j >> 1, channel half j & 1
        const int pos = pos0 + (lane & 7) + ((lane >> 4) << 3);
        const int half = (lane >> 3) & 1;
#pragma unroll
        for (int g = 0; g < K::NG; ++g) {
          uint32_t a[4];
          ldsm_x4_t(a, smem_u32(xt + kw_x_off(g, K::NPOS, pos, half)));
#pragma unroll
          for (int t = 0; t < K::NT; ++t)
            mma_bf16(acc[kd][g][t], a, b[t][0], b[t][1]);
        }
      }
    }
  }
  // acc[kd][g][t][e]: ci = g*16 + lane/4 (+8 for e >= 2), co = t*8 +
  // (lane%4)*2 + (e&1); every (tap, ci, co) has one owner in the block
  float* out = part + (size_t)blockIdx.x * 27 * CI * CO;
#pragma unroll
  for (int kd = 0; kd < 3; ++kd) {
    const int tap = kd * 9 + kh * 3 + kw;
#pragma unroll
    for (int g = 0; g < K::NG; ++g)
#pragma unroll
      for (int t = 0; t < K::NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ci = g * 16 + (lane >> 2) + (e >> 1) * 8;
          const int co = t * 8 + (lane & 3) * 2 + (e & 1);
          if (ci < CI && co < CO)
            out[(tap * CI + ci) * CO + co] = acc[kd][g][t][e];
        }
  }
  if (DRR) {  // the block's sums of dr, in a fixed order
    __shared__ float red[KW_WARPS][9];
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      const float x = warp_sum(sb[c]);
      if (lane == 0) red[warp][c] = x;
    }
    __syncthreads();
    if (tid < 9) {
      float sum = 0.f;
      for (int w = 0; w < KW_WARPS; ++w) sum += red[w][tid];
      dbpart[(size_t)blockIdx.x * 9 + tid] = sum;
    }
  }
}

__global__ void __launch_bounds__(RED_THREADS)
    merger_wgrad_reduce_kernel(const float* __restrict__ part, int parts,
                               int n, float* __restrict__ out) {
  fixed_order_reduce(part, parts, n, n, out, false, blockIdx.x);
}

// A fixed grid of about TC_SMS x per_sm blocks, each walking `per`
// contiguous tiles of the `tiles` in all.
inline void tile_plan(long long tiles, int per_sm, int* per, int* grid) {
  const long long target = (long long)TC_SMS * per_sm;
  const long long p = (tiles + target - 1) / target;
  *per = (int)p;
  *grid = (int)((tiles + p - 1) / p);
}

template <int CI, int CO>
int wgrad_grid(long long n) {
  int per, grid;
  tile_plan(n * Kw<CI, CO>::TILES, Kw<CI, CO>::PER_SM, &per, &grid);
  return grid;
}

// dW [27][CI][CO] f32 of NSRC sources (src) against dy [V][CO] bf16, or
// with DRR against dr on read from dsrc (its bias-gradient partials into
// dbpart, wgrad_grid<CI, CO>(n) x 9 floats): the partials launch, then
// the fixed-order reduce.  `part` holds wgrad_grid<CI, CO>(n) * 27 * CI *
// CO floats.
template <int CI, int CO, int NSRC, bool DRR>
int wgrad_mma(const Src& src, const bf16* dy, const Src& dsrc, long long n,
              float leaky, float* dw, float* part, float* dbpart,
              cudaStream_t s) {
  using K = Kw<CI, CO>;
  static_assert(!DRR || CO == 9, "dr on read has 9 channels");
  int per, grid;
  tile_plan(n * K::TILES, K::PER_SM, &per, &grid);
  static const int attr = (int)cudaFuncSetAttribute(  // once per kernel
      merger_wgrad_mma_kernel<CI, CO, NSRC, DRR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::SMEM);
  if (attr) return attr;
  int err;
  merger_wgrad_mma_kernel<CI, CO, NSRC, DRR>
      <<<grid, KW_THREADS, K::SMEM, s>>>(src, dy, dsrc, (int)(n * K::TILES),
                                         per, leaky, part, dbpart);
  if ((err = (int)cudaGetLastError())) return err;
  const int total = 27 * CI * CO;
  merger_wgrad_reduce_kernel<<<reduce_blocks(total, grid), RED_THREADS, 0,
                               s>>>(part, grid, total, dw);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ the conv (E, F, I, J)
// TC_FWD (E): + bias, bf16 out, per-block sums of the rounded outputs and
// their squares; TC_ADJ_* (F): the input gradient with the flipped,
// channel-swapped kernel and dr on read, into f32 (written or added) or
// bf16 (dx); TC_CONV (J): raw sources, the kernel as given, the f32 sum
// rounded once to bf16; TC_INFER (I): raw sources (stored activations),
// z * s + t (the folded BatchNorm) on the f32 sum, LeakyReLU, bf16 out
// (f32 for the one-channel last layer).
enum TcMode {
  TC_FWD = 0,
  TC_ADJ_INIT = 1,
  TC_ADJ_ACC = 2,
  TC_ADJ_DX = 3,
  TC_CONV = 4,
  TC_INFER = 5
};
constexpr int TC_THREADS = 256;  // 8 warps

__host__ __device__ constexpr bool tc_adjoint(int mode) {
  return mode == TC_ADJ_INIT || mode == TC_ADJ_ACC || mode == TC_ADJ_DX;
}

// A conv of NSRC sources of C = 9 channels, or (WIDE, kernel J's 36 -> 9)
// of one source of C interleaved channels, into COUT channels.  A block
// tile is DT planes x HT rows x 32 w; warp w owns plane w / (2 WR), rows
// RW * ((w / 2) % WR) .. + RW and the w-half w % 2: RW M-tiles of 16 x
// COP.  Each 16-channel group of the depth is staged into the halo after
// the previous one's products.  Four 9-channel sources (E's and I's layer
// 4) are four groups, one per source: three over the concatenated
// channels would save a quarter of the products, but the staging, not
// the tensor cores, bounds these kernels, and a group per source converts
// whole voxels with 4- and 8-byte loads.  J's interleaved [V][36] input
// is three groups over the concatenated channels (36 -> 48): one group of
// a position is 32 contiguous bytes there, read with 8-byte loads, and
// the depth pads 36 to 48, not 64.
template <int C, int NSRC, int COUT, int MODE>
struct Tc {
  static constexpr int CIN = C * NSRC;
  static constexpr bool WIDE = C != 9;
  static constexpr int GC = WIDE ? 16 : 9;       // channels a group
  static constexpr int NG = WIDE ? (C + 15) / 16 : NSRC;  // 16-deep groups
  static constexpr int NT = (COUT + 7) / 8;      // n8 tiles
  static constexpr int COP = NT * 8;
  // input gradients read dr on read (from r and dA, the layer's table)
  static constexpr bool DRR = tc_adjoint(MODE);
  // one 9-channel source read raw or normalized on read: the tile's input
  // rows are copied to shared memory with cp.async (the next tile's while
  // this one multiplies) and converted there; else each group is
  // converted from device memory
  static constexpr bool PIPE = NG == 1 && !DRR && !WIDE;
  // output tile and warp rows: 2 x 8 rows, 1 x 8 for the five n-tiles of
  // layer 4's 9 -> 36 adjoint (they take the registers)
  static constexpr int DT = NT > 2 ? 1 : 2, HT = 8;
  static constexpr int RW = NT > 2 ? 2 : 4;
  static constexpr int WR = HT / RW;             // warps a plane and half
  static constexpr int DR = DT + 2, HR = HT + 2;
  static constexpr int NPOS = DR * HR * TW;
  static constexpr int VOX = DT * HT * S;
  // output buffers: F's 9 -> 36 writes its four sources' f32 dA, J's one
  // interleaved bf16 tensor
  static constexpr bool F32_OUT = MODE == TC_ADJ_INIT || MODE == TC_ADJ_ACC;
  static constexpr int NB = COUT == 36 && F32_OUT ? 4 : 1;
  static constexpr int CB = COUT / NB;           // channels a buffer
  static constexpr int OUT_ES =
      F32_OUT || (MODE == TC_INFER && COUT == 1) ? 4 : 2;
  static constexpr int X_BYTES = NPOS * 32;
  static constexpr int O_BYTES = VOX * COUT * OUT_ES;
  // the halo, then (after the products) the output tile in its place
  static constexpr int U_BYTES = X_BYTES > O_BYTES ? X_BYTES : O_BYTES;
  static constexpr int W_BYTES = 27 * NG * NT * 32 * 8;
  static constexpr int RAW_ROW = S * C * 2;        // 32 voxels of bf16 r
  static constexpr int RAW_BYTES = PIPE ? DR * HR * RAW_ROW : 0;
  static constexpr size_t SMEM =
      (size_t)U_BYTES + RAW_BYTES + W_BYTES +
      sizeof(float) * tab_floats<C, NSRC, DRR>();
  static constexpr int FIT = (int)(SMEM_PER_SM / SMEM);
  static constexpr int MAX_SM = RW * NT > 8 ? 2 : 3;  // by registers
  static constexpr int PER_SM = FIT > MAX_SM ? MAX_SM : FIT;
  static constexpr int TILES = (S / DT) * (S / HT);  // per volume
  static_assert(DT * WR * 2 == TC_THREADS / 32, "8 warps");
  static_assert(!WIDE || (NSRC == 1 && MODE == TC_CONV),
                "one interleaved source: kernel J");
  static_assert(PER_SM >= 1, "shared memory");
};

struct TcArgs {
  Src src;
  const bf16* w;       // the forward layer's DHWIO kernel
  const float* bias;   // TC_FWD: [COUT]
  const float* fold;   // TC_INFER: scale [9], then shift [9]
  void* dst[4];        // TC_FWD, TC_CONV: bf16 [V][COUT]; TC_ADJ_INIT /
                       // ACC: f32 [V][9] (COUT 36: four of them);
                       // TC_ADJ_DX: bf16; TC_INFER: bf16 [V][9] or f32 [V]
  float* partial;      // TC_FWD: [grid][2][COUT]
  float leaky;
};

// Weight (depth row kk of group grp, output channel n) of tap `tap` of
// this conv: input channel GC grp + kk (kk < GC) of the kernel
// [27][CIN][COUT] as given, or for an input gradient (F) of the flipped,
// channel-swapped forward kernel [27][COUT][CIN]; 0 outside.
template <int CIN, int COUT, int GC, int MODE>
__device__ __forceinline__ bf16 tc_weight(const bf16* __restrict__ w,
                                          int tap, int grp, int kk, int n) {
  const int k = GC * grp + kk;
  if (kk >= GC || k >= CIN || n >= COUT) return __float2bfloat16(0.f);
  return tc_adjoint(MODE) ? w[((26 - tap) * COUT + n) * CIN + k]
                          : w[(tap * CIN + k) * COUT + n];
}

// Writes the block's output tile (staged in shared memory as [NB][VOX][CB]
// elements of OUT_ES bytes) to its DT planes of HT rows, 16 bytes a
// thread; TC_ADJ_ACC adds it to what is there.
template <class T, int MODE>
__device__ __forceinline__ void tc_store_tile(const unsigned char* so,
                                              void* const* dst, int v,
                                              int d0, int h0) {
  constexpr int PLANE = T::HT * S * T::CB * T::OUT_ES / 16;  // uint4
  for (int i = threadIdx.x; i < T::NB * T::DT * PLANE; i += blockDim.x) {
    const int b = i / (T::DT * PLANE), dd = (i / PLANE) % T::DT;
    const int u = i % PLANE;
    const size_t base = ((((size_t)v * S + d0 + dd) * S + h0) * S) * T::CB *
                        T::OUT_ES / 16;
    // constant indices into dst: it stays a kernel parameter
    void* d = dst[0];
#pragma unroll
    for (int k = 1; k < T::NB; ++k)
      if (b == k) d = dst[k];
    uint4* g = reinterpret_cast<uint4*>(d) + base + u;
    const uint4 val = reinterpret_cast<const uint4*>(
        so)[(b * T::DT + dd) * PLANE + u];
    if (MODE == TC_ADJ_ACC) {
      float4 o = *reinterpret_cast<const float4*>(g);
      const float4 a = *reinterpret_cast<const float4*>(&val);
      o.x += a.x;
      o.y += a.y;
      o.z += a.z;
      o.w += a.w;
      *reinterpret_cast<float4*>(g) = o;
    } else {
      *g = val;
    }
  }
}

// The products of one staged group `grp` into the warp's accumulators:
// for each (kd, kw) the three kh taps' B fragments go to registers, and
// each A fragment (an ldmatrix of 16 positions of one halo row) serves
// the up to three output rows that read that row.
template <class T>
__device__ __forceinline__ void tc_products(const bf16* xt, const uint2* wf,
                                            int grp, int dd, int r0, int w0,
                                            int lane,
                                            float (&acc)[T::RW][T::NT][4]) {
  for (int kd = 0; kd < 3; ++kd) {
    for (int kw = 0; kw < 3; ++kw) {
      uint2 b[3][T::NT];
#pragma unroll
      for (int kh = 0; kh < 3; ++kh)
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt)
          b[kh][nt] = wf[(((kd * 9 + kh * 3 + kw) * T::NG + grp) * T::NT +
                          nt) * 32 + lane];
      const int base =
          ((dd + kd) * T::HR + r0) * TW + w0 + kw + (lane & 15);
#pragma unroll
      for (int hr = 0; hr < T::RW + 2; ++hr) {
        uint32_t af[4];
        ldsm_x4(af, smem_u32(xt + kw_x_off(0, T::NPOS, base + hr * TW,
                                           lane >> 4)));
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          const int r = hr - kh;  // output row of this tap
          if (r < 0 || r >= T::RW) continue;
#pragma unroll
          for (int nt = 0; nt < T::NT; ++nt)
            mma_bf16(acc[r][nt], af, b[kh][nt].x, b[kh][nt].y);
        }
      }
    }
  }
}

// Issues the cp.async copies of a tile's raw input rows (the halo rows
// inside the volume; rows outside are never read): 16-byte chunks of
// whole w-rows of 64 x C bytes.
template <class T, int C>
__device__ __forceinline__ void tc_issue_raw(const Src& src, int v, int d0,
                                             int h0, unsigned char* raw) {
  constexpr int PER_ROW = T::RAW_ROW / 16;
  for (int i = threadIdx.x; i < T::DR * T::HR * PER_ROW; i += blockDim.x) {
    const int row = i / PER_ROW, u = i % PER_ROW;
    const int gd = d0 + row / T::HR - 1, gh = h0 + row % T::HR - 1;
    if (gd < 0 || gd >= S || gh < 0 || gh >= S) continue;
    const size_t vrow = (((size_t)v * S + gd) * S + gh) * S * C;
    cp_async16(smem_u32(raw + row * T::RAW_ROW + u * 16),
               src.p[0] + vrow + u * 8, true);
  }
}

// One block walks tiles [blockIdx.x * per, + per) of (volume, DT planes,
// HT rows).
template <int C, int NSRC, int COUT, int MODE>
__global__ void __launch_bounds__(TC_THREADS, Tc<C, NSRC, COUT, MODE>::PER_SM)
    mstack_tc_conv_kernel(TcArgs a, int tiles, int per) {
  using T = Tc<C, NSRC, COUT, MODE>;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* xt = reinterpret_cast<bf16*>(tc_smem);
  unsigned char* raw = tc_smem + T::U_BYTES;
  const uint2* wf =
      reinterpret_cast<const uint2*>(tc_smem + T::U_BYTES + T::RAW_BYTES);
  float* affs = reinterpret_cast<float*>(tc_smem + T::U_BYTES +
                                         T::RAW_BYTES + T::W_BYTES);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t_begin = (int)blockIdx.x * per;
  const int t_end = min(tiles, t_begin + per);
  if constexpr (T::PIPE) {
    if (t_begin < t_end) {  // the first tile's rows, in flight
      const int r = t_begin % T::TILES;
      tc_issue_raw<T, C>(a.src, t_begin / T::TILES,
                         (r / (S / T::HT)) * T::DT, (r % (S / T::HT)) * T::HT,
                         raw);
    }
  }
  cp_async_commit();
  const int g = lane >> 2, t4 = lane & 3;
  const int dd = warp / (2 * T::WR), r0 = ((warp >> 1) % T::WR) * T::RW;
  const int w0 = (warp & 1) * 16;

  // B fragments [27][NG][NT][lane]: b0 = (k 2t, 2t + 1; n g), b1 = (k
  // 2t + 8, 2t + 9; n g) of the 16 x 8 slice (group, n-tile) of a tap
  for (int i = tid; i < 27 * T::NG * T::NT * 32; i += TC_THREADS) {
    const int l = i % 32, nt = (i / 32) % T::NT;
    const int grp = (i / (32 * T::NT)) % T::NG;
    const int tap = i / (32 * T::NT * T::NG);
    const int n = nt * 8 + l / 4, k = (l % 4) * 2;
    uint2 f;
    constexpr int CIN = T::CIN, GC = T::GC;
    f.x = pack_bf16(tc_weight<CIN, COUT, GC, MODE>(a.w, tap, grp, k, n),
                    tc_weight<CIN, COUT, GC, MODE>(a.w, tap, grp, k + 1, n));
    f.y = pack_bf16(tc_weight<CIN, COUT, GC, MODE>(a.w, tap, grp, k + 8, n),
                    tc_weight<CIN, COUT, GC, MODE>(a.w, tap, grp, k + 9, n));
    const_cast<uint2*>(wf)[i] = f;
  }
  load_affines<C, NSRC, T::DRR>(a.src, affs);
  // this thread's output channels' bias (E) or fold (I: scale, shift)
  float bias[T::NT][2], scale[T::NT][2], s1[T::NT][2], s2[T::NT][2];
#pragma unroll
  for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int co = nt * 8 + t4 * 2 + b;
      bias[nt][b] = (MODE == TC_FWD && co < COUT)     ? a.bias[co]
                    : (MODE == TC_INFER && co < COUT) ? a.fold[9 + co]
                                                      : 0.f;
      scale[nt][b] = (MODE == TC_INFER && co < COUT) ? a.fold[co] : 0.f;
      s1[nt][b] = s2[nt][b] = 0.f;
    }

  const bool has_aff = a.src.aff[0] != nullptr;
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int v = tile / T::TILES, r = tile % T::TILES;
    const int d0 = (r / (S / T::HT)) * T::DT, h0 = (r % (S / T::HT)) * T::HT;
    float acc[T::RW][T::NT][4];
#pragma unroll
    for (int j = 0; j < T::RW; ++j)
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][nt][e] = 0.f;
    if constexpr (T::PIPE) {
      cp_async_wait<0>();
      __syncthreads();  // this tile's rows landed; the previous is stored
      tc_convert<T::DR, T::HR, T::RAW_ROW, false, false>(  // PIPE: no DRR
          raw, a.src, v, affs, has_aff, a.leaky, d0, h0, xt);
      __syncthreads();  // the halo is staged and the raw rows are free
      if (tile + 1 < t_end) {
        const int rn = (tile + 1) % T::TILES;
        tc_issue_raw<T, C>(a.src, (tile + 1) / T::TILES,
                           (rn / (S / T::HT)) * T::DT,
                           (rn % (S / T::HT)) * T::HT, raw);
      }
      cp_async_commit();
      tc_products<T>(xt, wf, 0, dd, r0, w0, lane, acc);
    }
#pragma unroll
    for (int grp = 0; grp < (T::PIPE ? 0 : T::NG); ++grp) {
      __syncthreads();  // the halo is free (the previous tile is stored)
      if constexpr (T::WIDE) {
        tc_convert_wide<T::DR, T::HR, C>(a.src.p[0], grp, v, d0, h0, xt);
      } else {
        Src one{};  // source grp (a constant index: a stays a param)
        one.p[0] = a.src.p[grp];
        one.da = a.src.da;
        tc_convert<T::DR, T::HR, 0, T::DRR, true>(
            nullptr, one, v, affs + (T::DRR ? 0 : grp * 2 * C),
            a.src.aff[grp] != nullptr, a.leaky, d0, h0, xt);
      }
      __syncthreads();
      tc_products<T>(xt, wf, grp, dd, r0, w0, lane, acc);
    }
    __syncthreads();  // every fragment is read: the output tile replaces it

    // acc[j][nt][e]: tile row dd * HT + r0 + j, w = w0 + g (+8 for e >= 2),
    // channel nt*8 + 2t + (e&1)
#pragma unroll
    for (int j = 0; j < T::RW; ++j) {
      const int row = dd * T::HT + r0 + j;
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int co = nt * 8 + t4 * 2 + (e & 1);
          if (co >= COUT) continue;
          const int lv = row * S + w0 + g + (e >> 1) * 8;
          float val;
          if (MODE == TC_INFER) {  // the fold on the unrounded f32 sum
            val = acc[j][nt][e] * scale[nt][e & 1] + bias[nt][e & 1];
            val = val >= 0.f ? val : val * a.leaky;
          } else {
            val = acc[j][nt][e] + bias[nt][e & 1];
          }
          if (T::OUT_ES == 2) {
            const bf16 q = __float2bfloat16(val);
            reinterpret_cast<bf16*>(tc_smem)[lv * COUT + co] = q;
            if (MODE == TC_FWD) {
              const float f = __bfloat162float(q);
              s1[nt][e & 1] += f;
              s2[nt][e & 1] += f * f;
            }
          } else {
            reinterpret_cast<float*>(tc_smem)[(co / T::CB) * T::VOX * T::CB +
                                              lv * T::CB + co % T::CB] = val;
          }
        }
    }
    __syncthreads();
    tc_store_tile<T, MODE>(tc_smem, a.dst, v, d0, h0);
  }

  if (MODE == TC_FWD) {  // the block's sums, in a fixed order
    __shared__ float red[TC_THREADS / 32][2][T::COP];
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        float x1 = s1[nt][b], x2 = s2[nt][b];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {  // over g: lanes of one t
          x1 += __shfl_xor_sync(0xffffffffu, x1, o);
          x2 += __shfl_xor_sync(0xffffffffu, x2, o);
        }
        if (g == 0) {
          red[warp][0][nt * 8 + t4 * 2 + b] = x1;
          red[warp][1][nt * 8 + t4 * 2 + b] = x2;
        }
      }
    __syncthreads();
    if (tid < 2 * COUT) {
      const int k = tid / COUT, co = tid % COUT;
      float sum = 0.f;
      for (int i = 0; i < TC_THREADS / 32; ++i) sum += red[i][k][co];
      a.partial[((size_t)blockIdx.x * 2 + k) * COUT + co] = sum;
    }
  }
}

template <int C, int NSRC, int COUT, int MODE>
int tc_grid(long long n) {
  using T = Tc<C, NSRC, COUT, MODE>;
  int per, grid;
  tile_plan(n * T::TILES, T::PER_SM, &per, &grid);
  return grid;
}

template <int C, int NSRC, int COUT, int MODE>
int tc_conv(const TcArgs& a, long long n, cudaStream_t s) {
  using T = Tc<C, NSRC, COUT, MODE>;
  int per, grid;
  tile_plan(n * T::TILES, T::PER_SM, &per, &grid);
  static const int attr = (int)cudaFuncSetAttribute(  // once per kernel
      mstack_tc_conv_kernel<C, NSRC, COUT, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (attr) return attr;
  mstack_tc_conv_kernel<C, NSRC, COUT, MODE>
      <<<grid, TC_THREADS, T::SMEM, s>>>(a, (int)(n * T::TILES), per);
  return (int)cudaGetLastError();
}

// --------------------------------------------- the 1 -> 9 convs (F, J)
// A[voxel][tap] = x[voxel + tap] of a one-channel volume (depth: 27 taps
// padded to 32).  TC_ADJ_INIT (F's layer-5 input gradient): x = dr5,
// B[tap][ci] = W5[26 - tap][ci][0] (the forward kernel, flipped here),
// into dA_4 f32 [V][9].  TC_CONV (J's 1 -> 9): B[tap][co] = w[tap][0][co]
// (a kernel the host flipped), into bf16 [V][9].
template <int MODE>
struct Tc1 {
  static constexpr int DT = 2, HT = 8, DR = DT + 2, HR = HT + 2;
  static constexpr int NPOS = DR * HR * TW;
  static constexpr int VOX = DT * HT * S;
  static constexpr int MPW = DT * HT * 2 / 8;
  static constexpr int NB = 1, CB = 9, OUT_ES = MODE == TC_CONV ? 2 : 4;
  static constexpr int X_BYTES = (NPOS * 2 + 15) / 16 * 16;
  static constexpr size_t SMEM = (size_t)X_BYTES + VOX * 9 * OUT_ES;
  static constexpr int PER_SM = 4;
  static constexpr int TILES = (S / DT) * (S / HT);
  static_assert(MODE == TC_ADJ_INIT || MODE == TC_CONV, "F or J");
};

template <int MODE>
__global__ void __launch_bounds__(TC_THREADS, Tc1<MODE>::PER_SM)
    mstack_tc_conv1_kernel(const bf16* __restrict__ dr5,
                           const bf16* __restrict__ w5, void* dst,
                           int tiles, int per) {
  using T = Tc1<MODE>;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* xt = reinterpret_cast<bf16*>(tc_smem);
  unsigned char* so = tc_smem + T::X_BYTES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  {  // zero once: the w = -1, 32 columns stay zero
    uint4* z = reinterpret_cast<uint4*>(tc_smem);
    for (int i = tid; i < T::X_BYTES / 16; i += TC_THREADS)
      z[i] = make_uint4(0, 0, 0, 0);
  }
  // this lane's taps: k = ks*16 + {2t, 2t+1, 2t+8, 2t+9}, their offsets
  // in the halo (-1: past tap 26) and their B fragments
  int off[2][4];
  uint32_t b[2][2][2];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int tap = ks * 16 + t4 * 2 + (q & 1) + (q >> 1) * 8;
      off[ks][q] = tap < 27 ? ((tap / 9) * T::HR + (tap / 3) % 3) * TW +
                                  tap % 3
                            : -1;
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int ci = nt * 8 + g;
      bf16 e[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int tap = ks * 16 + t4 * 2 + (q & 1) + (q >> 1) * 8;
        const int wt = MODE == TC_CONV ? tap : 26 - tap;
        e[q] = (tap < 27 && ci < 9) ? w5[wt * 9 + ci]
                                    : __float2bfloat16(0.f);
      }
      b[ks][nt][0] = pack_bf16(e[0], e[1]);
      b[ks][nt][1] = pack_bf16(e[2], e[3]);
    }
  }

  const int t_end = min(tiles, ((int)blockIdx.x + 1) * per);
  for (int tile = (int)blockIdx.x * per; tile < t_end; ++tile) {
    const int v = tile / T::TILES, r = tile % T::TILES;
    const int d0 = (r / (S / T::HT)) * T::DT, h0 = (r % (S / T::HT)) * T::HT;
    __syncthreads();  // the previous tile is stored
    for (int i = tid; i < T::DR * T::HR * 4; i += TC_THREADS) {
      const int row = i / 4, u = i % 4;
      const int gd = d0 + row / T::HR - 1, gh = h0 + row % T::HR - 1;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (gd >= 0 && gd < S && gh >= 0 && gh < S)
        raw = reinterpret_cast<const uint4*>(
            dr5 + (((size_t)v * S + gd) * S + gh) * S)[u];
      const bf16* h8 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) xt[row * TW + u * 8 + e + 1] = h8[e];
    }
    __syncthreads();
    const bf16 zero = __float2bfloat16(0.f);
#pragma unroll
    for (int j = 0; j < T::MPW; ++j) {
      const int m = warp + 8 * j, row = m >> 1, w0 = (m & 1) * 16;
      const int p0 = ((row / T::HT) * T::HR + row % T::HT) * TW + w0 + g;
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        bf16 x[2][4];  // rows g, g + 8
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            x[hr][q] = off[ks][q] < 0 ? zero
                                      : xt[p0 + hr * 8 + off[ks][q]];
        uint32_t af[4] = {pack_bf16(x[0][0], x[0][1]),
                          pack_bf16(x[1][0], x[1][1]),
                          pack_bf16(x[0][2], x[0][3]),
                          pack_bf16(x[1][2], x[1][3])};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          mma_bf16(acc[nt], af, b[ks][nt][0], b[ks][nt][1]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ci = nt * 8 + t4 * 2 + (e & 1);
          const int lv = (row * S + w0 + g + (e >> 1) * 8) * 9 + ci;
          if (ci >= 9) continue;
          if (T::OUT_ES == 4)
            reinterpret_cast<float*>(so)[lv] = acc[nt][e];
          else
            reinterpret_cast<bf16*>(so)[lv] = __float2bfloat16(acc[nt][e]);
        }
    }
    __syncthreads();
    void* d[1] = {dst};
    tc_store_tile<T, TC_ADJ_INIT>(so, d, v, d0, h0);
  }
}

// x [V][1] and dst 16-byte aligned.
template <int MODE>
int tc_conv1(const bf16* x, const bf16* w, void* dst, long long n,
             cudaStream_t s) {
  using T = Tc1<MODE>;
  int per, grid;
  tile_plan(n * T::TILES, T::PER_SM, &per, &grid);
  static const int attr = (int)cudaFuncSetAttribute(
      mstack_tc_conv1_kernel<MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (attr) return attr;
  mstack_tc_conv1_kernel<MODE><<<grid, TC_THREADS, T::SMEM, s>>>(
      x, w, dst, (int)(n * T::TILES), per);
  return (int)cudaGetLastError();
}

}  // namespace
