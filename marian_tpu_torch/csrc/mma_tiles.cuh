// One bf16 tensor-core product template for Hopper (sm_90a), with f32
// accumulators: C[m][n] = sum_k A(m, k) * B(n, k) over one 128 x 128
// output tile, from bf16 operands in device memory.
//
// The instruction is mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32:
// a product of two bf16 values is exact, the sums are f32. A block of 256
// threads is 8 warps in a 2 x 4 grid, each warp a 64 x 32 part of the tile
// (4 x 4 fragments of m16n8, 64 f32 accumulators a thread), two blocks an
// SM (at most 128 registers a thread; one block takes 48% longer,
// scripts/torch_fused_ce_tc_check.py --variants). The tensor cores' f32
// sums truncate, so a long reduction whose running sum cancels drifts:
// summed on the tensor cores alone, the bf16 backward's dw failed its
// one-spacing gate on 2 of 6 inputs (up to 3.2x). So each k-step's two
// products start from 0 and are added into the accumulators with f32
// adds that round to nearest (two-level accumulation: 9-12% slower, every
// input under 0.54 of the gate). The operands
// are staged in k-steps of 32 through a ring of kStages slots in dynamic
// shared memory, filled by 16-byte cp.async copies that are kStages - 1
// steps ahead of the products; a copy past a ragged row or depth edge
// reads only the real bytes and zero-fills the rest (cp.async's src-size),
// so nothing outside an operand is read and the edge adds nothing.
// Fragments are read with ldmatrix: as they lie for an operand whose
// global layout is k-contiguous (k innermost), transposed (.trans) for one
// that is k-major (m or n innermost). Staged rows are padded by 16 bytes,
// so the eight 16-byte rows an ldmatrix reads fall on distinct banks.
//
// Operand layouts, as the template of fused_ce.cu's f32 kernels names
// them: A(m, k) at p[m * ld + k] (k-contiguous) or at p[k * ld + m]
// (kAMajor), the same for B(n, k) with kBMajor. Every row starts 16-byte
// aligned: p aligned to 16 bytes and ld a multiple of 8.
//
// Not here yet: wgmma, TMA and warp specialisation (the Hopper-only
// paths to the card's full tensor-core rate).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;             // output tile rows
constexpr int kBN = 128;             // output tile columns
constexpr int kBK = 32;              // depth of a k-step
constexpr int kStages = 4;           // slots of the staging ring
constexpr int kWarpM = 64;           // rows of a warp's part
constexpr int kWarpN = 32;           // columns of a warp's part
constexpr int kFragN = kWarpN / 8;   // its m16n8 fragments along a row
constexpr int kWarpsN = kBN / kWarpN;
constexpr int kThreads = 32 * (kBM / kWarpM) * kWarpsN;
constexpr int kCopies = kBM * kBK / 8 / kThreads;  // 16-byte copies a thread
// blocks an SM: 128 registers a thread at most (__launch_bounds__), two
// blocks' staging rings in shared memory
constexpr int kBlocksPerSM = 2;
// staged row pitches in bf16 values: a k-contiguous tile is [128][kBK + 8],
// a k-major one [kBK][128 + 8]
constexpr int kRowPitch = kBK + 8;
constexpr int kMajorPitch = kBM + 8;
// one operand's slot (the larger of the two layouts) and one stage
constexpr int kSlot = kBM * kRowPitch;
constexpr int kStage = 2 * kSlot;
constexpr int kSmemBytes = kStages * kStage * (int)sizeof(bf16);
static_assert(kBM == kBN, "one slot size serves both operands");
static_assert(kBK * kMajorPitch <= kSlot, "a k-major tile fits the slot");
static_assert(kCopies * kThreads == kBM * kBK / 8, "whole copies");
static_assert(kFragN % 2 == 0, "ldmatrix x4 reads two n8 fragments");

// element (r, k) of an operand: p[r * ld + k], or p[k * ld + r] when
// k-major; rows at or past `rows` and depths at or past `ks` read as 0
struct Operand {
  const bf16* p;
  int ld, rows, ks;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes from src to shared dst, of which the first `bytes` (0..16) are
// read and the rest zero-filled
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a . b on one m16n8k16 fragment
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the operand's [128 x kBK] tile at rows r0, depths k0 into slot s: 512
// 16-byte vectors, kCopies a thread
template <bool kMajor>
__device__ __forceinline__ void load_stage(bf16* s, const Operand& o, int r0,
                                           int k0) {
#pragma unroll
  for (int u = 0; u < kCopies; ++u) {
    const int c = threadIdx.x + u * kThreads;
    int r, k, bytes;
    unsigned dst;
    if (kMajor) {                      // 16 vectors of 8 rows a depth
      k = c >> 4;
      r = (c & 15) << 3;
      dst = smem_addr(s + k * kMajorPitch + r);
      bytes = k0 + k < o.ks ? 2 * min(8, max(0, o.rows - r0 - r)) : 0;
    } else {                           // 4 vectors of 8 depths a row
      r = c >> 2;
      k = (c & 3) << 3;
      dst = smem_addr(s + r * kRowPitch + k);
      bytes = r0 + r < o.rows ? 2 * min(8, max(0, o.ks - k0 - k)) : 0;
    }
    const bf16* src =
        bytes == 0 ? o.p
                   : o.p + (kMajor ? (size_t)(k0 + k) * o.ld + r0 + r
                                   : (size_t)(r0 + r) * o.ld + k0 + k);
    cp_async16(dst, src, bytes);
  }
}

// this thread's warp and its place in the 2 x 4 grid of warps
__device__ __forceinline__ int warp_m() { return (threadIdx.x >> 5) / kWarpsN; }
__device__ __forceinline__ int warp_n() { return (threadIdx.x >> 5) % kWarpsN; }
__device__ __forceinline__ int lane() { return threadIdx.x & 31; }

// Row and column, within the tile, of accumulator acc[i][j][h]: fragment
// (i, j) of the warp's part, h = 0, 1 on one row (two neighbouring
// columns), h = 2, 3 eight rows below.
__device__ __forceinline__ int frag_row(int i, int h) {
  return warp_m() * kWarpM + i * 16 + (lane() >> 2) + (h >> 1) * 8;
}
__device__ __forceinline__ int frag_col(int j, int h) {
  return warp_n() * kWarpN + j * 8 + (lane() & 3) * 2 + (h & 1);
}

// acc = sum over k in [k_begin, k_end) of A(m0 + row, k) * B(n0 + col, k)
// for the tile's 128 x 128 outputs (frag_row, frag_col); k_begin a
// multiple of 8. smem: kSmemBytes of dynamic shared memory, free again
// (every copy landed, every thread past its last read) on return.
template <bool kAMajor, bool kBMajor>
__device__ __forceinline__ void product(const Operand& A, const Operand& B,
                                        int m0, int n0, int k_begin,
                                        int k_end, bf16* smem,
                                        float (&acc)[4][kFragN][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kFragN; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[i][j][h] = 0.f;
  const int steps = (k_end - k_begin + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) {
      load_stage<kAMajor>(smem + s * kStage, A, m0, k_begin + s * kBK);
      load_stage<kBMajor>(smem + s * kStage + kSlot, B, n0,
                          k_begin + s * kBK);
    }
    cp_async_commit();
  }
  const int l = lane(), wm = warp_m() * kWarpM, wn = warp_n() * kWarpN;
  // ldmatrix x4: lane l gives the address of row l % 8 of matrix l / 8
  const int lr = l & 7, lm = l >> 3;
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 2>();      // step t's copies have landed
    __syncthreads();                   // ... all of them; slot t - 1 is free
    const int next = t + kStages - 1;
    if (next < steps) {
      bf16* s = smem + (next % kStages) * kStage;
      load_stage<kAMajor>(s, A, m0, k_begin + next * kBK);
      load_stage<kBMajor>(s + kSlot, B, n0, k_begin + next * kBK);
    }
    cp_async_commit();
    const bf16* as = smem + (t % kStages) * kStage;
    const bf16* bs = as + kSlot;
    // both k16 halves' B fragments, then per m16 row of fragments its A
    // fragments and, for each fragment, the k-step's two products from 0
    // added into the f32 accumulators (rounded to nearest)
    unsigned b[2][kFragN][2];
#pragma unroll
    for (int kh = 0; kh < 2; ++kh)
#pragma unroll
      for (int p = 0; p < kFragN / 2; ++p) {
        const int n = wn + p * 16 + (lm >> 1) * 8, k = kh * 16 + (lm & 1) * 8;
        unsigned r[4];
        if (kBMajor)
          ldmatrix_x4_trans(r, smem_addr(bs + (k + lr) * kMajorPitch + n));
        else
          ldmatrix_x4(r, smem_addr(bs + (n + lr) * kRowPitch + k));
        b[kh][2 * p][0] = r[0];
        b[kh][2 * p][1] = r[1];
        b[kh][2 * p + 1][0] = r[2];
        b[kh][2 * p + 1][1] = r[3];
      }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      unsigned a[2][4];
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        const int m = wm + i * 16 + (lm & 1) * 8, k = kh * 16 + (lm >> 1) * 8;
        if (kAMajor)
          ldmatrix_x4_trans(a[kh],
                            smem_addr(as + (k + lr) * kMajorPitch + m));
        else
          ldmatrix_x4(a[kh], smem_addr(as + (m + lr) * kRowPitch + k));
      }
#pragma unroll
      for (int j = 0; j < kFragN; ++j) {
        float step[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(step, a[0], b[0][j][0], b[0][j][1]);
        mma_bf16(step, a[1], b[1][j][0], b[1][j][1]);
#pragma unroll
        for (int h = 0; h < 4; ++h) acc[i][j][h] += step[h];
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// the depths [k_begin, k_end) of split z of K: equal kBK-aligned slices
__device__ __forceinline__ int2 k_slice(int K, int splits, int z) {
  const int per = ((K + splits - 1) / splits + kBK - 1) / kBK * kBK;
  return make_int2(min(K, z * per), min(K, (z + 1) * per));
}

// two neighbouring values as one 4-byte bf16x2 (q 4-byte aligned)
__device__ __forceinline__ void store2(bf16* q, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(q) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* q, float a, float b) {
  *reinterpret_cast<float2*>(q) = make_float2(a, b);
}

}  // namespace mma
