// The bf16 tensor-core tile helpers of the attention kernels
// (flash_attention.cu's flash_tc_* kernels, packed_attention.cu's
// packed_tc_bwd_kernel; the bf16 libraries only): mma.sync m16n8k16 on
// mma_tiles.cuh's primitives, f32 accumulators, one warp a 16-row tile.
// Staged rows are padded by 16 bytes, so the eight rows an ldmatrix reads
// fall on distinct banks. A probability (or dS) tile enters its second
// product as a hi/lo bf16 pair, hi = bf16(x), lo = bf16(x - hi), two
// products on the same fragments, which keeps the reference's f32 value
// to 2^-16 where one rounding puts 2^-9 on it; each tile's products start
// from 0 and are added into the f32 accumulators with round-to-nearest
// adds (the tensor cores' own sums truncate). A source includes
// attention_tiles.cuh and mma_tiles.cuh before it.

#pragma once

#include <cuda_bf16.h>

namespace attn {

using bf16 = __nv_bfloat16;

// Design checks, edited by scripts/torch_flash_bwd_ab.py --design: P and
// dS enter their products as a hi/lo bf16 pair (false: rounded to bf16
// once), and each streamed tile's products start from 0 and are added
// into the f32 accumulators with round-to-nearest adds (false: the tensor
// cores sum into them directly).
constexpr bool kTcSplit = true;
constexpr bool kTcTwoLevel = true;

// rows [r0, r0 + ROWS) of a [n][DH] bf16 matrix into dst[ROWS][DH + 8]
// by 16-byte cp.async, NT threads; rows at or past n read nothing and
// are zero-filled
template <int ROWS, int DH, int NT = kThreads>
__device__ __forceinline__ void tc_stage_rows(const bf16* __restrict__ src,
                                              int r0, int n, bf16* dst) {
  constexpr int C = DH / 8;
  for (int i = threadIdx.x; i < ROWS * C; i += NT) {
    const int r = i / C, c = (i % C) * 8;
    const bool in = r0 + r < n;
    cp_async16(reinterpret_cast<float*>(dst + r * (DH + 8) + c),
               src + (size_t)(in ? r0 + r : 0) * DH + c, in);
  }
}

// src[i0 .. i0 + N) into dst by threads t0 .. t0 + N - 1 (4-byte
// cp.async), zero at and past `end`
template <int N>
__device__ __forceinline__ void tc_stage_vec(const float* __restrict__ src,
                                             int i0, int end, float* dst,
                                             int t0) {
  const int j = (int)threadIdx.x - t0;
  if (j >= 0 && j < N) {
    const bool in = i0 + j < end;
    cp_async4(dst + j, src + (in ? i0 + j : 0), in);
  }
}

// two f32 values (the lower column first) as one bf16x2 operand register
__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// ... and as a hi/lo pair: hi = bf16(x), lo = bf16(x - hi), so that
// |x - hi - lo| <= 2^-16 |x| (bf16 has f32's exponent range)
__device__ __forceinline__ void split_bf16(float a, float b, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(a - f.x, b - f.y);
}

// s[j] = A . B^T over Dh: the warp's 16 rows of a staged [.][DH] tile a
// from row0 against the 8 NJ rows of a staged [8 NJ][DH] tile b, in
// m16n8 fragments (C layout: s[j][h] at row lane / 4 + 8 (h / 2), column
// 8 j + 2 (lane % 4) + h % 2). A's fragments are read one k16 step at a
// time (ldmatrix x4: lane l gives row l % 8 of matrix l / 8), which
// keeps registers for the accumulators; with kRolled the steps are a
// rolled loop (dkv at Dh 128: unrolled, the loads ptxas hoists across
// the steps spilled its registers). A product of two bf16 values is
// exact; the sums are the tensor cores' f32 sums over Dh.
template <int NJ, int DH>
__device__ __forceinline__ void score_step(const bf16* a, int row0,
                                           const bf16* b, int kk,
                                           float (&s)[NJ][4]) {
  const int l = threadIdx.x & 31, lr = l & 7, lm = l >> 3;
  unsigned af[4];
  mma::ldmatrix_x4(af, mma::smem_addr(
      a + (row0 + (lm & 1) * 8 + lr) * (DH + 8) + kk * 16 + (lm >> 1) * 8));
#pragma unroll
  for (int p = 0; p < NJ / 2; ++p) {
    unsigned r[4];
    mma::ldmatrix_x4(r, mma::smem_addr(
        b + (p * 16 + (lm >> 1) * 8 + lr) * (DH + 8) + kk * 16
        + (lm & 1) * 8));
    mma::mma_bf16(s[2 * p], af, r[0], r[1]);
    mma::mma_bf16(s[2 * p + 1], af, r[2], r[3]);
  }
}

template <int NJ, int DH, bool kRolled = false>
__device__ __forceinline__ void score_product(const bf16* a, int row0,
                                              const bf16* b,
                                              float (&s)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 4; ++h) s[j][h] = 0.f;
  if constexpr (kRolled) {
#pragma unroll 1
    for (int kk = 0; kk < DH / 16; ++kk) score_step<NJ, DH>(a, row0, b, kk, s);
  } else {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) score_step<NJ, DH>(a, row0, b, kk, s);
  }
}

// acc += X . M: X the warp's [16][16 KS] f32 tile in C fragments (k16
// step kk is fragments 2 kk and 2 kk + 1, repacked into A fragments in
// registers), M a staged [16 KS][DH] tile m read through ldmatrix .trans.
// X goes in as a hi/lo bf16 pair, two products on the same M fragments,
// so the product keeps X's f32 value to 2^-16 (kTcSplit); the tile's
// products start from 0 and are added into acc rounded to nearest, as
// the tensor cores' own f32 sums truncate (kTcTwoLevel).
template <int KS, int DH>
__device__ __forceinline__ void tile_product(const float (&x)[2 * KS][4],
                                             const bf16* m,
                                             float (&acc)[DH / 8][4]) {
  const int l = threadIdx.x & 31, lr = l & 7, lm = l >> 3;
  unsigned hi[KS][4], lo[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      // a0: row lane / 4 of fragment 2 kk; a1: eight rows below; a2, a3
      // the same of fragment 2 kk + 1 (the step's upper eight columns)
      const float c0 = x[2 * kk + (u >> 1)][2 * (u & 1)];
      const float c1 = x[2 * kk + (u >> 1)][2 * (u & 1) + 1];
      if (kTcSplit)
        split_bf16(c0, c1, hi[kk][u], lo[kk][u]);
      else
        hi[kk][u] = pack_bf16(c0, c1);
    }
#pragma unroll
  for (int dp = 0; dp < DH / 16; ++dp) {
    float part[2][4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      part[0][h] = kTcTwoLevel ? 0.f : acc[2 * dp][h];
      part[1][h] = kTcTwoLevel ? 0.f : acc[2 * dp + 1][h];
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned r[4];
      mma::ldmatrix_x4_trans(r, mma::smem_addr(
          m + (kk * 16 + (lm & 1) * 8 + lr) * (DH + 8) + dp * 16
          + (lm >> 1) * 8));
      mma::mma_bf16(part[0], hi[kk], r[0], r[1]);
      if (kTcSplit) mma::mma_bf16(part[0], lo[kk], r[0], r[1]);
      mma::mma_bf16(part[1], hi[kk], r[2], r[3]);
      if (kTcSplit) mma::mma_bf16(part[1], lo[kk], r[2], r[3]);
    }
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      acc[2 * dp][h] = kTcTwoLevel ? acc[2 * dp][h] + part[0][h] : part[0][h];
      acc[2 * dp + 1][h] =
          kTcTwoLevel ? acc[2 * dp + 1][h] + part[1][h] : part[1][h];
    }
  }
}

// acc += X^T . M: X a staged [16 KS][pitch] f32 tile kept as its hi/lo
// bf16 pair (xhi, xlo: rows are the product's depth), of which the warp
// takes columns col0 .. col0 + 15 as the rows of A = X^T (ldmatrix
// .trans); M a staged [16 KS][DH] tile read through ldmatrix .trans, as in
// tile_product. The A fragments are read once for every n8 pair over Dh;
// the products start from 0 and are added into acc rounded to nearest.
template <int KS, int DH>
__device__ __forceinline__ void tile_product_t(const bf16* xhi,
                                               const bf16* xlo, int pitch,
                                               int col0, const bf16* m,
                                               float (&acc)[DH / 8][4]) {
  const int l = threadIdx.x & 31, lr = l & 7, lm = l >> 3;
  unsigned hi[KS][4], lo[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    // matrix lm: depths kk 16 + 8 (lm / 2) .., rows col0 + 8 (lm % 2) ..
    const int at = (kk * 16 + (lm >> 1) * 8 + lr) * pitch + col0 + (lm & 1) * 8;
    mma::ldmatrix_x4_trans(hi[kk], mma::smem_addr(xhi + at));
    mma::ldmatrix_x4_trans(lo[kk], mma::smem_addr(xlo + at));
  }
#pragma unroll
  for (int dp = 0; dp < DH / 16; ++dp) {
    float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned r[4];
      mma::ldmatrix_x4_trans(r, mma::smem_addr(
          m + (kk * 16 + (lm & 1) * 8 + lr) * (DH + 8) + dp * 16
          + (lm >> 1) * 8));
      mma::mma_bf16(part[0], hi[kk], r[0], r[1]);
      mma::mma_bf16(part[0], lo[kk], r[0], r[1]);
      mma::mma_bf16(part[1], hi[kk], r[2], r[3]);
      mma::mma_bf16(part[1], lo[kk], r[2], r[3]);
    }
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      acc[2 * dp][h] += part[0][h];
      acc[2 * dp + 1][h] += part[1][h];
    }
  }
}

}  // namespace attn
