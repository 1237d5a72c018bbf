// Fused output projection + label-smoothed cross-entropy statistics, and
// their gradients.
//
// Replaces the TPU kernels of marian_tpu/ops/pallas/fused_ce.py:
//   fused_ce_fwd     <- _fwd_kernel (from _fwd_call): per token
//                       lse = logsumexp_v(l), lab = l[label], tot = sum_v l
//                       of l = x . w^T + b, without writing [N, V];
//   fused_ce_bwd_*   <- _dx_kernel and _dw_kernel (from _bwd_call):
//                       dx = d . w, dw = d^T . x, db = sum_n d
// with d = g_lse * exp(l - lse) + g_lab * onehot(label) + g_tot on the V
// real vocabulary columns (the kernels mask the ragged edges themselves:
// the table is never padded).
//
// What bounds them on an H100: operations. Each is a product of N*V*E
// multiply-adds, 403 GFLOP at N = 12,288, V = 32,000, E = 512, against
// 25 MB of x and 65 MB of w. The f32 kernels run on the CUDA cores,
// outside the tensor cores (TF32 stays off).
//
// Two instantiations of every kernel, each in a library of its own
// (KERNEL_DTYPE, at the entry points): x and w float32, or x and w bfloat16
// (mixed-precision training, --precision bfloat16). The f32 one loads its
// operands as float4s. The bf16 one reads them from memory as bf16 (8
// bytes for 4 values, half the f32 bytes), widens them in registers and
// accumulates in f32 on the same template; b, lse, the cotangents, d and
// db stay f32. As the reference's backward does (d.astype(w.dtype)
// before dx, d.astype(x.dtype) before dw), the bf16 dx and dw products
// round each d value to bf16 as they read it from shared memory, while db
// sums the unrounded d. dx is accumulated over the vocabulary chunks in
// an f32 buffer and written as bf16 by the last chunk; dw is written as
// bf16 once a chunk. The bf16 forward and backward run so only at the
// shapes the tensor-core kernels below do not take.
//
// The bf16 forward on the tensor cores (fce_tc_fwd_kernel, entry point
// fused_ce_fwd_tc; the bf16 library only) takes the same calls as the
// tensor-core backward (tc_path: E % 8 == 0, x and w 16-byte aligned). It
// forms each 128 x 128 logit tile with the backward's NT product on the
// template below and reduces it in the epilogue to the same per-tile
// partials as fce_fwd_kernel (128 columns a tile instead of 256), merged
// by the same fce_fwd_combine_kernel. What bounds it: operations at the
// bf16 tensor-core peak (0.41 ms at the base shape), so in practice the
// mma.sync template's rate, as in the backward; its partials (4 floats a
// token and tile, 49 MB at the base shape) are written once and read
// once. The blocks walk the tiles in a grouped order (kFwdGroup token
// tiles down each vocabulary tile, band by band), so that a band of w is
// read from device memory once for the group even where w (65.5 MB at
// the doc shape) does not fit the 50 MB L2.
//
// The bf16 backward on the tensor cores (the bf16 library only; the
// fce_tc_* kernels and the fused_ce_bwd_tc_* entry points) takes every
// call with E % 8 == 0 and x, w, dx, dw 16-byte aligned (the wrapper's
// tc_path); other bf16 shapes keep the CUDA-core kernels above. Its three
// products per chunk are one template (mma_tiles.cuh: mma.sync m16n8k16,
// bf16 operands, f32 accumulators, 128 x 128 tiles, a 4-stage cp.async
// ring, two blocks an SM): the d kernel stores d into a bf16 scratch
// already rounded (the one value both of the reference's products read;
// half the scratch bytes, so chunks twice as wide) and sums the
// unrounded f32 d of its 128 token rows per column, which
// fce_tc_db_kernel adds over the token tiles in order, compensated, into
// db; dx and dw read the stored d. What bounds it: operations at the bf16
// tensor-core peak (989 TFLOP/s: 1.22 ms for the three products at the
// base shape), then the bf16 d traffic, about 2.4 GB a base backward
// (written once, read twice: 0.7 ms at 3.35 TB/s). mma.sync reaches
// 170-255 TFLOP/s a product here (wgmma and TMA are the next step).
//
// Forward (f32, and bf16 where the tensor cores do not take it): one
// block of 256 threads per (vocabulary tile of 256 columns,
// token tile of 128 rows) forms that logit tile with the NT product of the
// template described below (product_tile, as the backward's d product
// runs it: x rows against w rows, the full E reduction). Its epilogue adds
// the bias and reduces each row over the tile's real columns: the exact
// tile maximum first (a thread's 16 columns, then across the 16 lanes that
// hold the row), then sum exp(l - max), the label logit and the sum of the
// logits relative to it, so no statistics are carried across tiles. One
// lane a row writes the tile's partial (max, sum-exp, label logit, sum)
// into part [4][tiles][N]; fce_fwd_combine_kernel, one thread a token, adds
// the partials up in vocabulary order: deterministic, no atomics. The
// blocks run in the d product's order, one token tile across the whole
// vocabulary at a time (walking a few token tiles together, so that a
// wave reads each w tile from device memory once for all of them, measured
// no faster on the card).
//
// Backward: the TPU keeps each d tile in VMEM between its two products.
// Here the wrapper (ops/kernels/fused_ce.py) walks the vocabulary in
// chunks [v0, v0 + Vc) in a fixed order and makes three launches a chunk:
//   fce_bwd_dlogit_kernel  d_c [N, Vc] = dlogit(x . w_c^T + b_c), an NT
//                          product with the d epilogue, into one scratch
//                          of at most 256 MiB that every chunk reuses;
//   fce_bwd_dx_kernel      dx (+)= d_c . w_c, an NN product: the first
//                          chunk stores, later ones load, add and store in
//                          chunk order (no atomics);
//   fce_bwd_dw_kernel      dw[v0 : v0 + Vc] = d_c^T . x, a TN product; its
//                          blocks of the first column tile also sum d_c's
//                          columns into db, in token order, compensated.
// So the logits are recomputed once a backward and shared by dx and dw:
// three N*V*E products in all, the least a backward that does not keep
// [N, V] can do. All three, and the forward's product, are one template
// (product_tile): 128 x 256 output tiles, one block of 256 threads an SM,
// each thread with an 8 x 16 register tile (2 x 4 sub-tiles of 4 x 4, so
// each k step reads six float4 from shared memory for 128 FMAs; 128 x 128
// tiles of 8 x 8, two blocks an SM, measured slower on the card), depth-8
// operand tiles staged k-major in shared memory and double-buffered, the
// next tile's global loads in flight in registers. An operand whose global layout is
// k-contiguous (x and w rows in the NT product, d in the NN one) is
// transposed on its way into shared memory; staged rows are padded by 4
// floats so those stores do not collide on a bank.
// The accumulator is the register tile of an output tile, so no hidden
// size E limits a block or splits the work into column ranges. The dx
// and dw products have few output tiles (N x E and Vc x E) and a long
// reduction: when that leaves much of the last wave of blocks idle, the
// wrapper splits the reduction into 2-4 slices (k_splits), each written
// to scratch, and fce_bwd_sum_kernel adds them in order: deterministic.
// Ragged N, V and E edges are predicated; float4 global access needs
// E % 4 == 0 and 16-byte aligned operands (the wrapper says so in `vec`),
// else scalar loads run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_tiles.cuh"
#if KERNEL_DTYPE == 1
#include "mma_tiles.cuh"
#endif

namespace {

using bf16 = __nv_bfloat16;
using attn::from_f32;

// x rounded to bf16 and widened back (the reference's d.astype(bf16))
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Four consecutive values of T as loaded, raw: a float4 of f32, a uint2
// of bf16 bits. An operand tile waits in registers in this form while
// the block computes on the staged one, and is widened to f32 only when
// it is staged, so no conversion waits on a load in flight.
template <typename T> struct Raw4;
template <> struct Raw4<float> { using type = float4; };
template <> struct Raw4<bf16> { using type = uint2; };

// the four bf16 values at q, raw: one 8-byte load (q aligned to 8 bytes)
__device__ __forceinline__ uint2 load_raw(const bf16* q) {
  return __ldg(reinterpret_cast<const uint2*>(q));
}

// the bf16 values q[i] for the i < 4 that `ok` allows, 0 elsewhere, raw
__device__ __forceinline__ uint2 load_raw_masked(const bf16* q, int ok) {
  const unsigned short* h = reinterpret_cast<const unsigned short*>(q);
  unsigned v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < ok) v[i] = h[i];
  return make_uint2(v[0] | (v[1] << 16), v[2] | (v[3] << 16));
}

__device__ __forceinline__ float4 widen(float4 v) { return v; }
__device__ __forceinline__ float4 widen(uint2 u) {
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// four values to q (16-byte aligned for f32, 8-byte for bf16), in T
__device__ __forceinline__ void store4(float* q, float4 v) {
  *reinterpret_cast<float4*>(q) = v;
}
__device__ __forceinline__ void store4(bf16* q, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(q) = u;
}

constexpr float kStatsInit = -1e30f;

__device__ __forceinline__ void merge_stats(float& m, float& s, float m2,
                                            float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

__device__ __forceinline__ float dlogit(float l, float lse, float gl,
                                        float gg, float gt, bool is_label) {
  return gl * expf(l - lse) + (is_label ? gg : 0.f) + gt;
}

// ---------------------------------------------------------------------------
// one register-blocked f32 product template, three layouts
// ---------------------------------------------------------------------------

constexpr int kGM = 128;             // output tile rows
constexpr int kGN = 256;             // output tile columns
constexpr int kGK = 8;               // depth of a staged operand tile
constexpr int kGThreads = 256;       // 16 x 16 threads, 8 x 16 outputs each
constexpr int kRT = kGN / 16;        // outputs of a thread along a row
// staged row pitch (floats) and floats of one staged tile of R rows
__host__ __device__ constexpr int pitch(int rows) { return rows + 4; }
__host__ __device__ constexpr int stage(int rows) { return kGK * pitch(rows); }
static_assert(kGM * kGK % (4 * kGThreads) == 0, "float4s");

// An operand of C[m][n] = sum_k A(m, k) B(n, k): element (r, k) lies at
// p[k * ld + r] when k-major, else at p[r * ld + k]; rows at or past
// `rows` and depths at or past `ks` read as 0. T is float or bf16.
template <typename T>
struct Operand {
  const T* p;
  int ld, rows, ks;
};

// This thread's four-value vectors of the operand's [ROWS x kGK] tile at
// (r0, k0): vector u is element idx = tid + 256 u; k-major, depth k0 +
// idx / (ROWS / 4) of rows r0 + 4 (idx % (ROWS / 4)) .. + 3; else row r0 +
// idx / 2 at depths k0 + 4 (idx % 2) .. + 3. In f32, float4s as loaded.
template <int ROWS, bool kMajor>
__device__ __forceinline__ void load_tile(const Operand<float>& o, int r0,
                                          int k0, bool vec,
                                          float4 (&out)[ROWS / 128]) {
  constexpr int kQ = ROWS / 4;
#pragma unroll
  for (int u = 0; u < ROWS / 128; ++u) {
    const int t = threadIdx.x + u * kGThreads;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    bool done = false;
    if (kMajor) {
      const int k = k0 + t / kQ, r = r0 + ((t % kQ) << 2);
      if (k < o.ks) {
        const float* q = o.p + (size_t)k * o.ld + r;
        if (vec && r + 3 < o.rows) {
          out[u] = __ldg(reinterpret_cast<const float4*>(q));
          done = true;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (r + i < o.rows) v[i] = q[i];
        }
      }
    } else {
      const int r = r0 + (t >> 1), k = k0 + ((t & 1) << 2);
      if (r < o.rows) {
        const float* q = o.p + (size_t)r * o.ld + k;
        if (vec && k + 3 < o.ks) {
          out[u] = __ldg(reinterpret_cast<const float4*>(q));
          done = true;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (k + i < o.ks) v[i] = q[i];
        }
      }
    }
    if (!done) out[u] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// The same vectors of a bf16 operand, as raw bits (uint2).
template <int ROWS, bool kMajor>
__device__ __forceinline__ void load_tile(const Operand<bf16>& o, int r0,
                                          int k0, bool vec,
                                          uint2 (&out)[ROWS / 128]) {
  constexpr int kQ = ROWS / 4;
#pragma unroll
  for (int u = 0; u < ROWS / 128; ++u) {
    const int t = threadIdx.x + u * kGThreads;
    // the vector's first element, and how many of its 4 are real
    const bf16* q = o.p;
    int ok = 0;
    if (kMajor) {
      const int k = k0 + t / kQ, r = r0 + ((t % kQ) << 2);
      if (k < o.ks) {
        q += (size_t)k * o.ld + r;
        ok = min(4, o.rows - r);
      }
    } else {
      const int r = r0 + (t >> 1), k = k0 + ((t & 1) << 2);
      if (r < o.rows) {
        q += (size_t)r * o.ld + k;
        ok = min(4, o.ks - k);
      }
    }
    out[u] = vec && ok == 4 ? load_raw(q) : load_raw_masked(q, ok);
  }
}

// load_tile's vectors, widened to f32, into the k-major staged tile
// s[kGK][pitch(ROWS)]
template <int ROWS, bool kMajor, typename R>
__device__ __forceinline__ void stage_tile(float* s,
                                           const R (&in)[ROWS / 128]) {
  constexpr int kQ = ROWS / 4, kLd = pitch(ROWS);
#pragma unroll
  for (int u = 0; u < ROWS / 128; ++u) {
    const int t = threadIdx.x + u * kGThreads;
    const float4 v = widen(in[u]);
    if (kMajor) {
      *reinterpret_cast<float4*>(s + (t / kQ) * kLd + ((t % kQ) << 2)) = v;
    } else {
      const int r = t >> 1, k = (t & 1) << 2;
      s[k * kLd + r] = v.x;
      s[(k + 1) * kLd + r] = v.y;
      s[(k + 2) * kLd + r] = v.z;
      s[(k + 3) * kLd + r] = v.w;
    }
  }
}

// this thread's place (ty, tx) in the 16 x 16 grid of register tiles
__device__ __forceinline__ int thread_ty() { return threadIdx.x >> 4; }
__device__ __forceinline__ int thread_tx() { return threadIdx.x & 15; }

// output row i < 8 and column j < kRT of this thread's register tile,
// within the tile
__device__ __forceinline__ int tile_row(int i) {
  return 4 * thread_ty() + (i & 3) + 64 * (i >> 2);
}
__device__ __forceinline__ int tile_col(int j) {
  return 4 * thread_tx() + (j & 3) + 64 * (j >> 2);
}

// acc[i][j] = sum over k in [k_begin, k_end) of A(m0 + tile_row(i), k) *
// B(n0 + tile_col(j), k), k_begin a multiple of kGK. With kRoundA each A
// value is rounded to bf16 as the product reads it (the bf16 backward's
// d). With colsum on (the dw product's blocks of the first column tile),
// threads 0 .. 127 also sum A(m0 + tid, k) over k, unrounded, in order,
// into colsum[0], compensated (Kahan; colsum[1] carries the lost low
// bits): one thread's sequential sum over thousands of tokens otherwise
// drifts past 1e-5 of db. smem holds 2 * (stage(kGM) + stage(kGN)) floats.
template <bool kAMajor, bool kBMajor, bool kRoundA, typename TA, typename TB>
__device__ __forceinline__ void product_tile(const Operand<TA>& A,
                                             const Operand<TB>& B, int m0,
                                             int n0, int k_begin, int k_end,
                                             bool vec_a, bool vec_b,
                                             bool colsum_on, float* smem,
                                             float (&acc)[8][kRT],
                                             float (&colsum)[2]) {
  constexpr int kLdA = pitch(kGM), kLdB = pitch(kGN);
  float* As = smem;                     // [2][kGK][kLdA]
  float* Bs = smem + 2 * stage(kGM);    // [2][kGK][kLdB]
  const int tid = threadIdx.x, tx = thread_tx(), ty = thread_ty();
  const bool sums = colsum_on && tid < kGM;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kRT; ++j) acc[i][j] = 0.f;
  typename Raw4<TA>::type ra[kGM / 128];
  typename Raw4<TB>::type rb[kGN / 128];
  load_tile<kGM, kAMajor>(A, m0, k_begin, vec_a, ra);
  load_tile<kGN, kBMajor>(B, n0, k_begin, vec_b, rb);
  stage_tile<kGM, kAMajor>(As, ra);
  stage_tile<kGN, kBMajor>(Bs, rb);
  __syncthreads();
  int buf = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += kGK) {
    const bool more = k0 + kGK < k_end;
    if (more) {
      load_tile<kGM, kAMajor>(A, m0, k0 + kGK, vec_a, ra);
      load_tile<kGN, kBMajor>(B, n0, k0 + kGK, vec_b, rb);
    }
    const float* as = As + buf * stage(kGM);
    const float* bs = Bs + buf * stage(kGN);
#pragma unroll
    for (int kk = 0; kk < kGK; ++kk) {
      float a[8], bb[kRT];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float4 f =
            *reinterpret_cast<const float4*>(as + kk * kLdA + 64 * q + 4 * ty);
        if (kRoundA)
          f = make_float4(round_bf16(f.x), round_bf16(f.y), round_bf16(f.z),
                          round_bf16(f.w));
        a[4 * q] = f.x; a[4 * q + 1] = f.y; a[4 * q + 2] = f.z;
        a[4 * q + 3] = f.w;
      }
#pragma unroll
      for (int q = 0; q < kRT / 4; ++q) {
        const float4 f =
            *reinterpret_cast<const float4*>(bs + kk * kLdB + 64 * q + 4 * tx);
        bb[4 * q] = f.x; bb[4 * q + 1] = f.y; bb[4 * q + 2] = f.z;
        bb[4 * q + 3] = f.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < kRT; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    if (sums) {
#pragma unroll
      for (int kk = 0; kk < kGK; ++kk) {
        const float y = as[kk * kLdA + tid] - colsum[1];
        const float t = colsum[0] + y;
        colsum[1] = (t - colsum[0]) - y;
        colsum[0] = t;
      }
    }
    if (more) {
      stage_tile<kGM, kAMajor>(As + (buf ^ 1) * stage(kGM), ra);
      stage_tile<kGN, kBMajor>(Bs + (buf ^ 1) * stage(kGN), rb);
    }
    __syncthreads();
    buf ^= 1;
  }
}

// ---------------------------------------------------------------------------
// forward: the NT product with a statistics epilogue, and the merge
// ---------------------------------------------------------------------------

// part[k][t][n], k = max, sum exp(l - max), label logit (0 when the label
// lies in another tile), sum of l, over the real columns of vocabulary
// tile t (columns 256 t .. 256 t + 255, those < V) of token n's logits
// l = x[n] . w^T + b. grid (ceil(V / 256), ceil(N / 128)): block (t, u)
// forms vocabulary tile t of token tile u. T: the type of x and w.
template <typename T>
__global__ void __launch_bounds__(kGThreads, 1) fce_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ b, const int* __restrict__ labels, int N,
    int V, int E, int vec, float* __restrict__ part) {
  __shared__ __align__(16) float smem[2 * (stage(kGM) + stage(kGN))];
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  float acc[8][kRT], unused[2];
  product_tile<false, false, false>(Operand<T>{x, E, N, E},
                                    Operand<T>{w, E, V, E}, m0, n0, 0, E,
                                    vec, vec, false, smem, acc, unused);
#pragma unroll
  for (int j = 0; j < kRT; ++j) {
    const int c = n0 + tile_col(j);
    const float bias = c < V ? b[c] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][j] += bias;
  }
  const size_t plane = (size_t)gridDim.x * N;
  float* out = part + (size_t)blockIdx.x * N;
  // every lane runs every row (the shuffles need the whole warp); rows at
  // or past N read x as 0 and are not written
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + tile_row(i);
    const int lbl = r < N ? labels[r] : -1;
    // the row's maximum over the tile; a lane with no real column keeps
    // kStatsInit, and every tile has a real column
    float mx = kStatsInit;
#pragma unroll
    for (int j = 0; j < kRT; ++j)
      if (n0 + tile_col(j) < V) mx = fmaxf(mx, acc[i][j]);
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float se = 0.f, lab = 0.f, tot = 0.f;
#pragma unroll
    for (int j = 0; j < kRT; ++j) {
      const int c = n0 + tile_col(j);
      if (c < V) {
        se += expf(acc[i][j] - mx);
        tot += acc[i][j];
        if (c == lbl) lab = acc[i][j];
      }
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      se += __shfl_xor_sync(0xffffffffu, se, o);
      lab += __shfl_xor_sync(0xffffffffu, lab, o);
      tot += __shfl_xor_sync(0xffffffffu, tot, o);
    }
    if (thread_tx() == 0 && r < N) {
      out[r] = mx;
      out[plane + r] = se;
      out[2 * plane + r] = lab;
      out[3 * plane + r] = tot;
    }
  }
}

// one thread per token: merge the vocabulary tiles' partials in order
__global__ void fce_fwd_combine_kernel(const float* __restrict__ part, int N,
                                       int tiles, float* __restrict__ lse,
                                       float* __restrict__ lab,
                                       float* __restrict__ tot) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const size_t plane = (size_t)tiles * N;
  float m = kStatsInit, s = 0.f, g = 0.f, t = 0.f;
  for (int k = 0; k < tiles; ++k) {
    const size_t o = (size_t)k * N + row;
    merge_stats(m, s, part[o], part[plane + o]);
    g += part[2 * plane + o];
    t += part[3 * plane + o];
  }
  lse[row] = m + logf(s == 0.f ? 1.f : s);
  lab[row] = g;
  tot[row] = t;
}

// ---------------------------------------------------------------------------
// backward: the NT d product, the NN dx product, the TN dw product
// ---------------------------------------------------------------------------

// d[N][ldd], columns [0, width): d of vocabulary columns v0 .. v0 + width
// (NT: x rows against w_c rows). grid (ceil(width / 128), ceil(N / 128)).
// d stays f32 in both instantiations: db sums it unrounded.
template <typename T>
__global__ void __launch_bounds__(kGThreads, 1) fce_bwd_dlogit_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ b, const int* __restrict__ labels,
    const float* __restrict__ lse, const float* __restrict__ g_lse,
    const float* __restrict__ g_lab, const float* __restrict__ g_tot,
    float* __restrict__ d, int N, int E, int v0, int width, int ldd,
    int vec) {
  __shared__ __align__(16) float smem[2 * (stage(kGM) + stage(kGN))];
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  float acc[8][kRT], unused[2];
  product_tile<false, false, false>(
      Operand<T>{x, E, N, E}, Operand<T>{w + (size_t)v0 * E, E, width, E},
      m0, n0, 0, E, vec, vec, false, smem, acc, unused);
  float bias[kRT];
#pragma unroll
  for (int j = 0; j < kRT; ++j) {
    const int c = n0 + tile_col(j);
    bias[j] = c < width ? b[v0 + c] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + tile_row(i);
    if (r >= N) continue;
    const float r_lse = lse[r], gl = g_lse[r], gg = g_lab[r], gt = g_tot[r];
    const int lbl = labels[r] - v0;
    float* out = d + (size_t)r * ldd;
#pragma unroll
    for (int jj = 0; jj < kRT / 4; ++jj) {
      const int c0 = n0 + tile_col(4 * jj);
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = c0 + j < width
                   ? dlogit(acc[i][4 * jj + j] + bias[4 * jj + j], r_lse, gl,
                            gg, gt, c0 + j == lbl)
                   : 0.f;
      if (c0 + 3 < width) {
        *reinterpret_cast<float4*>(out + c0) =
            make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + j < width) out[c0 + j] = o[j];
      }
    }
  }
}

// the depths [k_begin, k_end) of split z of K: equal kGK-aligned slices
__device__ __forceinline__ int2 k_slice(int K, int splits, int z) {
  const int per = ((K + splits - 1) / splits + kGK - 1) / kGK * kGK;
  return make_int2(min(K, z * per), min(K, (z + 1) * per));
}

// row a = acc[i] of this thread's register tile into row `out` of width
// E, in T: out[n0 + tile_col(j)] = (prev ? prev[...] : 0) + a[j], prev
// the f32 row the sum so far lies in (it may be out itself)
template <typename T>
__device__ __forceinline__ void store_tile_row(T* out, const float* prev,
                                               int n0, const float* a, int E,
                                               bool vec) {
#pragma unroll
  for (int jj = 0; jj < kRT / 4; ++jj) {
    const int c0 = n0 + tile_col(4 * jj);
    const float* p = a + 4 * jj;
    if (vec && c0 + 3 < E) {
      float4 o = make_float4(p[0], p[1], p[2], p[3]);
      if (prev) {
        const float4 q = *reinterpret_cast<const float4*>(prev + c0);
        o = make_float4(q.x + o.x, q.y + o.y, q.z + o.z, q.w + o.w);
      }
      store4(out + c0, o);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + j < E)
          out[c0 + j] = from_f32<T>(prev ? prev[c0 + j] + p[j] : p[j]);
    }
  }
}

// sum = (accumulate ? dxf : 0) + d[:, :width] . w[v0 : v0 + width] (NN),
// into OUT: the f32 running sum dxf, or on the last chunk dx in T (for
// f32, dxf and dx are one buffer). grid (ceil(E / 128), ceil(N / 128),
// splits): with splits > 1 each z-block sums one slice of the chunk's
// columns into part[z] [N][E] and fce_bwd_sum_kernel adds the slices in
// order and writes the sum.
template <typename T, typename OUT>
__global__ void __launch_bounds__(kGThreads, 1) fce_bwd_dx_kernel(
    const float* __restrict__ d, const T* __restrict__ w,
    const float* dxf, OUT* out, float* __restrict__ part, int N, int E,
    int v0, int width, int ldd, int accumulate, int vec) {
  __shared__ __align__(16) float smem[2 * (stage(kGM) + stage(kGN))];
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  const int2 ks = k_slice(width, gridDim.z, blockIdx.z);
  float acc[8][kRT], unused[2];
  constexpr bool kRound = sizeof(T) == 2;
  product_tile<false, true, kRound>(
      Operand<float>{d, ldd, N, width},
      Operand<T>{w + (size_t)v0 * E, E, E, width}, m0, n0, ks.x, ks.y, true,
      vec, false, smem, acc, unused);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + tile_row(i);
    if (r >= N) continue;
    if (gridDim.z == 1)
      store_tile_row(out + (size_t)r * E,
                     accumulate ? dxf + (size_t)r * E : nullptr, n0, acc[i],
                     E, vec);
    else
      store_tile_row(part + ((size_t)blockIdx.z * N + r) * E, nullptr, n0,
                     acc[i], E, vec);
  }
}

// dw[v0 + m][E] = sum_n d[n][m] x[n] for m < width (TN), in T, and
// db[v0 + m] = sum_n d[n][m] (f32, d unrounded) from the blocks of the
// first column tile.
// grid (ceil(E / 128), ceil(width / 128), splits): with splits > 1 each
// z-block sums one slice of the tokens into part[z] [width][E] (and its
// db into part[splits * width * E + z * width + m]), and
// fce_bwd_sum_kernel adds the slices in order.
template <typename T>
__global__ void __launch_bounds__(kGThreads, 1) fce_bwd_dw_kernel(
    const float* __restrict__ d, const T* __restrict__ x,
    T* __restrict__ dw, float* __restrict__ db, float* __restrict__ part,
    int N, int E, int v0, int width, int ldd, int vec) {
  __shared__ __align__(16) float smem[2 * (stage(kGM) + stage(kGN))];
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  const int2 ks = k_slice(N, gridDim.z, blockIdx.z);
  float acc[8][kRT], colsum[2] = {0.f, 0.f};
  constexpr bool kRound = sizeof(T) == 2;
  product_tile<true, true, kRound>(
      Operand<float>{d, ldd, width, N}, Operand<T>{x, E, E, N}, m0, n0, ks.x,
      ks.y, true, vec, blockIdx.x == 0, smem, acc, colsum);
  const bool direct = gridDim.z == 1;
  float* col = direct ? db + v0
                      : part + (size_t)gridDim.z * width * E +
                            (size_t)blockIdx.z * width;
  const int t = threadIdx.x;
  if (blockIdx.x == 0 && t < kGM && m0 + t < width) col[m0 + t] = colsum[0];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + tile_row(i);
    if (r >= width) continue;
    if (direct)
      store_tile_row(dw + (size_t)(v0 + r) * E, nullptr, n0, acc[i], E, vec);
    else
      store_tile_row(part + ((size_t)blockIdx.z * width + r) * E, nullptr,
                     n0, acc[i], E, vec);
  }
}

// out[i] = (prev ? prev[i] : 0) + sum over s < splits of
// part[s * count + i], the slices in order, in OUT (prev may be out)
template <typename OUT>
__global__ void fce_bwd_sum_kernel(const float* __restrict__ part,
                                   const float* prev, OUT* out,
                                   size_t count, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float acc = part[i];
  for (int s = 1; s < splits; ++s) acc += part[(size_t)s * count + i];
  out[i] = from_f32<OUT>(prev ? prev[i] + acc : acc);
}

// the launches of one call in the operands' type T
template <typename T>
int fwd(const void* x, const void* w, const void* b, const void* labels,
        void* lse, void* lab, void* tot, void* part, int N, int V, int E,
        int vec, cudaStream_t s) {
  const int vtiles = (V + kGN - 1) / kGN;
  const dim3 grid(vtiles, (N + kGM - 1) / kGM);
  fce_fwd_kernel<T><<<grid, kGThreads, 0, s>>>(
      (const T*)x, (const T*)w, (const float*)b, (const int*)labels, N, V,
      E, vec, (float*)part);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  fce_fwd_combine_kernel<<<(N + 255) / 256, 256, 0, s>>>(
      (const float*)part, N, vtiles, (float*)lse, (float*)lab, (float*)tot);
  return (int)cudaGetLastError();
}

template <typename T>
int dlogit(const void* x, const void* w, const void* b, const void* labels,
           const void* lse, const void* g_lse, const void* g_lab,
           const void* g_tot, void* d, int N, int E, int v0, int width,
           int ldd, int vec, cudaStream_t s) {
  const dim3 grid((width + kGN - 1) / kGN, (N + kGM - 1) / kGM);
  fce_bwd_dlogit_kernel<T><<<grid, kGThreads, 0, s>>>(
      (const T*)x, (const T*)w, (const float*)b, (const int*)labels,
      (const float*)lse, (const float*)g_lse, (const float*)g_lab,
      (const float*)g_tot, (float*)d, N, E, v0, width, ldd, vec);
  return (int)cudaGetLastError();
}

template <typename OUT>
int sum_slices(const float* part, const float* prev, OUT* out, size_t count,
               int splits, cudaStream_t s) {
  fce_bwd_sum_kernel<OUT><<<(unsigned)((count + 255) / 256), 256, 0, s>>>(
      part, prev, out, count, splits);
  return (int)cudaGetLastError();
}

// OUT: float while the sum runs on in dxf, T on the last chunk
template <typename T, typename OUT>
int dx_chunk(const void* d, const void* w, const void* dxf, void* out,
             void* part, int N, int E, int v0, int width, int ldd,
             int accumulate, int vec, int splits, cudaStream_t s) {
  const dim3 grid((E + kGN - 1) / kGN, (N + kGM - 1) / kGM, splits);
  fce_bwd_dx_kernel<T, OUT><<<grid, kGThreads, 0, s>>>(
      (const float*)d, (const T*)w, (const float*)dxf, (OUT*)out,
      (float*)part, N, E, v0, width, ldd, accumulate, vec);
  int err = (int)cudaGetLastError();
  if (err != 0 || splits == 1) return err;
  return sum_slices((const float*)part,
                    accumulate ? (const float*)dxf : nullptr, (OUT*)out,
                    (size_t)N * E, splits, s);
}

template <typename T>
int dw_chunk(const void* d, const void* x, void* dw, void* db, void* part,
             int N, int E, int v0, int width, int ldd, int vec, int splits,
             cudaStream_t s) {
  const dim3 grid((E + kGN - 1) / kGN, (width + kGM - 1) / kGM, splits);
  fce_bwd_dw_kernel<T><<<grid, kGThreads, 0, s>>>(
      (const float*)d, (const T*)x, (T*)dw, (float*)db, (float*)part, N, E,
      v0, width, ldd, vec);
  int err = (int)cudaGetLastError();
  if (err != 0 || splits == 1) return err;
  const size_t count = (size_t)width * E;
  err = sum_slices((const float*)part, nullptr, (T*)dw + (size_t)v0 * E,
                   count, splits, s);
  if (err != 0) return err;
  return sum_slices((const float*)part + splits * count, nullptr,
                    (float*)db + v0, width, splits, s);
}

}  // namespace

#if KERNEL_DTYPE == 1
// ---------------------------------------------------------------------------
// the bf16 forward and backward on the tensor cores (mma_tiles.cuh)
// ---------------------------------------------------------------------------

namespace {

// token tiles that walk one band of vocabulary tiles together
// (fwd_tile): G = 1, 4 and 8 timed by scripts/torch_fused_ce_fwd_ab.py
// --fwd-group
constexpr int kFwdGroup = 8;

// (vocabulary tile, token tile) of this block of a 1-D grid of vtiles x
// ntiles blocks. In launch order the blocks take `group` token tiles at a
// time and walk them down every vocabulary tile (token tile fastest), so
// the blocks in flight share a band of w tiles and a few x tiles; the last
// group may hold fewer token tiles. group 1: one token tile across the
// whole vocabulary at a time.
__device__ __forceinline__ int2 fwd_tile(int vtiles, int ntiles, int group) {
  const int per = group * vtiles;
  const int first = blockIdx.x / per * group;
  const int rows = min(group, ntiles - first);
  const int r = blockIdx.x % per;
  return make_int2(r / rows, first + r % rows);
}

// fce_fwd_kernel's partials on the tensor cores: part[k][t][n], k = max,
// sum exp(l - max), label logit (0 when the label lies in another tile),
// sum of l over the real columns of vocabulary tile t (columns 128 t ..
// 128 t + 127, those < V) of token n's logits l = x[n] . w^T + b (NT:
// x rows against w rows, reduction over E). A row's 128 columns lie in the
// 4 warps of a warp_n column (32 each), 4 lanes a warp (lane & 3), 8
// values a lane: each statistic is reduced in the lane, across the quad
// (shuffles) and then across the 4 warps through the free staging ring
// in a fixed order, the exact maximum first, then the three sums relative
// to it. One thread a row writes the tile's partial; no atomics.
__global__ void __launch_bounds__(mma::kThreads, mma::kBlocksPerSM)
    fce_tc_fwd_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    const float* __restrict__ b, const int* __restrict__ labels, int N,
    int V, int E, int vtiles, int ntiles, int group,
    float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int2 tile = fwd_tile(vtiles, ntiles, group);
  const int m0 = tile.y * mma::kBM, n0 = tile.x * mma::kBN;
  float acc[4][mma::kFragN][4];
  mma::product<false, false>(mma::Operand{x, E, N, E},
                             mma::Operand{w, E, V, E}, m0, n0, 0, E,
                             reinterpret_cast<bf16*>(tc_smem), acc);
  // the bias on real columns; columns at or past V (0 from the product's
  // zero-filled rows of w) enter no statistic
#pragma unroll
  for (int j = 0; j < mma::kFragN; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + mma::frag_col(j, h);
      const float bias = c < V ? b[c] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][j][h] += bias;
        acc[i][j][h + 2] += bias;
      }
    }
  // red[s][warp_n][row]: s 0 the warps' maxima, 1-3 their sum-exp, label
  // logit and sum; the ring is free once product returns
  float* red = reinterpret_cast<float*>(tc_smem);
  constexpr int kPlane = mma::kWarpsN * mma::kBM;
  const int wn = mma::warp_n();
  const bool quad_lead = (mma::lane() & 3) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hr = 0; hr < 4; hr += 2) {
      // a lane with no real column keeps kStatsInit; every tile has one
      float mx = kStatsInit;
#pragma unroll
      for (int j = 0; j < mma::kFragN; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (n0 + mma::frag_col(j, h) < V) mx = fmaxf(mx, acc[i][j][hr + h]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      if (quad_lead) red[wn * mma::kBM + mma::frag_row(i, hr)] = mx;
    }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hr = 0; hr < 4; hr += 2) {
      const int row = mma::frag_row(i, hr), r = m0 + row;
      const float mx = fmaxf(fmaxf(red[row], red[mma::kBM + row]),
                             fmaxf(red[2 * mma::kBM + row],
                                   red[3 * mma::kBM + row]));
      const int lbl = r < N ? labels[r] : -1;
      float se = 0.f, lab = 0.f, tot = 0.f;
#pragma unroll
      for (int j = 0; j < mma::kFragN; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = n0 + mma::frag_col(j, h);
          const float l = acc[i][j][hr + h];
          if (c < V) {
            se += expf(l - mx);
            tot += l;
            if (c == lbl) lab = l;
          }
        }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        se += __shfl_xor_sync(0xffffffffu, se, o);
        lab += __shfl_xor_sync(0xffffffffu, lab, o);
        tot += __shfl_xor_sync(0xffffffffu, tot, o);
      }
      if (quad_lead) {
        float* s = red + kPlane + wn * mma::kBM + row;
        s[0] = se;
        s[kPlane] = lab;
        s[2 * kPlane] = tot;
      }
    }
  __syncthreads();
  // thread t < 128: row t of the tile, its 4 warps in order
  const int t = threadIdx.x, r = m0 + t;
  if (t >= mma::kBM || r >= N) return;
  float out[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float* p = red + s * kPlane + t;
    out[s] = s == 0 ? fmaxf(fmaxf(p[0], p[mma::kBM]),
                            fmaxf(p[2 * mma::kBM], p[3 * mma::kBM]))
                    : ((p[0] + p[mma::kBM]) + p[2 * mma::kBM])
                          + p[3 * mma::kBM];
  }
  const size_t plane = (size_t)vtiles * N;
  float* o = part + (size_t)tile.x * N + r;
#pragma unroll
  for (int s = 0; s < 4; ++s) o[s * plane] = out[s];
}

// d[N][ldd] in bf16, columns [0, width) and on to the tile's edge (0 past
// width): d of vocabulary columns v0 .. v0 + width, rounded once as it is
// stored (NT: x rows against w_c rows, reduction over E). The tensor
// cores sum the logit in another order than the plain version (cuBLAS;
// the CUDA-core kernels' d matched its rounding everywhere on 10 inputs),
// so where the two f32 d straddle a bf16 midpoint the stored d rounds the
// other way: 2-14 of 3.9-5.2e8 values an input at the training shapes
// (scripts/torch_fused_ce_tc_check.py). With part_db, each
// block also sums its 128 token rows of the unrounded f32 d per column
// into part_db[blockIdx.y][width]. grid (ceil(width / 128),
// ceil(N / 128)).
__global__ void __launch_bounds__(mma::kThreads, mma::kBlocksPerSM)
    fce_tc_dlogit_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    const float* __restrict__ b, const int* __restrict__ labels,
    const float* __restrict__ lse, const float* __restrict__ g_lse,
    const float* __restrict__ g_lab, const float* __restrict__ g_tot,
    bf16* __restrict__ d, float* __restrict__ part_db, int N, int E, int v0,
    int width, int ldd) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* smem = reinterpret_cast<bf16*>(tc_smem);
  const int m0 = blockIdx.y * mma::kBM, n0 = blockIdx.x * mma::kBN;
  float acc[4][mma::kFragN][4];
  mma::product<false, false>(mma::Operand{x, E, N, E},
                             mma::Operand{w + (size_t)v0 * E, E, width, E},
                             m0, n0, 0, E, smem, acc);
  // this thread's 8 columns: bias, and the sums of d over its rows
  float bias[mma::kFragN][2], colsum[mma::kFragN][2];
#pragma unroll
  for (int j = 0; j < mma::kFragN; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + mma::frag_col(j, h);
      bias[j][h] = c < width ? b[v0 + c] : 0.f;
      colsum[j][h] = 0.f;
    }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hr = 0; hr < 4; hr += 2) {
      const int r = m0 + mma::frag_row(i, hr);
      if (r >= N) continue;
      const float r_lse = lse[r], gl = g_lse[r], gg = g_lab[r], gt = g_tot[r];
      const int lbl = labels[r] - v0;
      bf16* out = d + (size_t)r * ldd;
#pragma unroll
      for (int j = 0; j < mma::kFragN; ++j) {
        const int c = n0 + mma::frag_col(j, 0);
        float o[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          o[h] = c + h < width ? dlogit(acc[i][j][hr + h] + bias[j][h], r_lse,
                                        gl, gg, gt, c + h == lbl)
                               : 0.f;
          colsum[j][h] += o[h];
        }
        mma::store2(out + c, o[0], o[1]);
      }
    }
  if (part_db == nullptr) return;
  // the 8 lanes that share columns, then the two warps of a column range
#pragma unroll
  for (int j = 0; j < mma::kFragN; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        colsum[j][h] += __shfl_xor_sync(0xffffffffu, colsum[j][h], o);
  float* red = reinterpret_cast<float*>(tc_smem);     // [2][kBN]
  if (mma::lane() < 4)
#pragma unroll
    for (int j = 0; j < mma::kFragN; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        red[mma::warp_m() * mma::kBN + mma::frag_col(j, h)] = colsum[j][h];
  __syncthreads();
  const int t = threadIdx.x;
  if (t < mma::kBN && n0 + t < width)
    part_db[(size_t)blockIdx.y * width + n0 + t] = red[t] + red[mma::kBN + t];
}

// sum = (accumulate ? dxf : 0) + d[:, :width] . w[v0 : v0 + width] (NN,
// reduction over the chunk's columns), into OUT: the f32 running sum dxf,
// or on the last chunk dx in bf16. grid (ceil(E / 128), ceil(N / 128),
// splits): with splits > 1 each z-block sums one slice of the columns into
// part[z] [N][E], added in order by fce_bwd_sum_kernel.
template <typename OUT>
__global__ void __launch_bounds__(mma::kThreads, mma::kBlocksPerSM)
    fce_tc_dx_kernel(
    const bf16* __restrict__ d, const bf16* __restrict__ w, const float* dxf,
    OUT* out, float* __restrict__ part, int N, int E, int v0, int width,
    int ldd, int accumulate) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int m0 = blockIdx.y * mma::kBM, n0 = blockIdx.x * mma::kBN;
  const int2 ks = mma::k_slice(width, gridDim.z, blockIdx.z);
  float acc[4][mma::kFragN][4];
  mma::product<false, true>(mma::Operand{d, ldd, N, width},
                            mma::Operand{w + (size_t)v0 * E, E, E, width}, m0,
                            n0, ks.x, ks.y, reinterpret_cast<bf16*>(tc_smem),
                            acc);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hr = 0; hr < 4; hr += 2) {
      const int r = m0 + mma::frag_row(i, hr);
      if (r >= N) continue;
#pragma unroll
      for (int j = 0; j < mma::kFragN; ++j) {
        const int c = n0 + mma::frag_col(j, 0);
        if (c >= E) continue;
        float a0 = acc[i][j][hr], a1 = acc[i][j][hr + 1];
        const size_t o = (size_t)r * E + c;
        if (gridDim.z > 1) {
          mma::store2(part + (size_t)blockIdx.z * N * E + o, a0, a1);
          continue;
        }
        if (accumulate) {
          const float2 p = *reinterpret_cast<const float2*>(dxf + o);
          a0 += p.x;
          a1 += p.y;
        }
        mma::store2(out + o, a0, a1);
      }
    }
}

// dw[v0 + m][E] = sum_n d[n][m] x[n] for m < width (TN, reduction over the
// tokens), in bf16. grid (ceil(E / 128), ceil(width / 128), splits): with
// splits > 1 each z-block sums one slice of the tokens into part[z]
// [width][E], added in order by fce_bwd_sum_kernel.
__global__ void __launch_bounds__(mma::kThreads, mma::kBlocksPerSM)
    fce_tc_dw_kernel(
    const bf16* __restrict__ d, const bf16* __restrict__ x,
    bf16* __restrict__ dw, float* __restrict__ part, int N, int E, int v0,
    int width, int ldd) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int m0 = blockIdx.y * mma::kBM, n0 = blockIdx.x * mma::kBN;
  const int2 ks = mma::k_slice(N, gridDim.z, blockIdx.z);
  float acc[4][mma::kFragN][4];
  mma::product<true, true>(mma::Operand{d, ldd, width, N},
                           mma::Operand{x, E, E, N}, m0, n0, ks.x, ks.y,
                           reinterpret_cast<bf16*>(tc_smem), acc);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hr = 0; hr < 4; hr += 2) {
      const int r = m0 + mma::frag_row(i, hr);
      if (r >= width) continue;
#pragma unroll
      for (int j = 0; j < mma::kFragN; ++j) {
        const int c = n0 + mma::frag_col(j, 0);
        if (c >= E) continue;
        if (gridDim.z > 1)
          mma::store2(part + ((size_t)blockIdx.z * width + r) * E + c,
                      acc[i][j][hr], acc[i][j][hr + 1]);
        else
          mma::store2(dw + (size_t)(v0 + r) * E + c, acc[i][j][hr],
                      acc[i][j][hr + 1]);
      }
    }
}

// db[i] = sum over the token tiles t, in order, of part[t * count + i],
// compensated (Kahan): the tile sums are of order sqrt(128) while the
// running sum may reach some 100 before it cancels, and a plain f32 sum
// over 96-128 tiles came close to the 1e-5 check against the plain
// version on the card.
__global__ void fce_tc_db_kernel(const float* __restrict__ part,
                                 float* __restrict__ db, int count,
                                 int tiles) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float sum = 0.f, lost = 0.f;
  for (int t = 0; t < tiles; ++t) {
    const float y = part[(size_t)t * count + i] - lost;
    const float u = sum + y;
    lost = (u - sum) - y;
    sum = u;
  }
  db[i] = sum;
}

// a kernel's dynamic shared memory above the default 48 KB, set once
template <typename Kernel>
int allow_tc_smem(Kernel kernel) {
  return (int)cudaFuncSetAttribute(kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   mma::kSmemBytes);
}

int tc_fwd(const void* x, const void* w, const void* b, const void* labels,
           void* lse, void* lab, void* tot, void* part, int N, int V, int E,
           cudaStream_t s) {
  static const int attr = allow_tc_smem(fce_tc_fwd_kernel);
  if (attr != 0) return attr;
  const int vtiles = (V + mma::kBN - 1) / mma::kBN;
  const int ntiles = (N + mma::kBM - 1) / mma::kBM;
  fce_tc_fwd_kernel<<<vtiles * ntiles, mma::kThreads, mma::kSmemBytes, s>>>(
      (const bf16*)x, (const bf16*)w, (const float*)b, (const int*)labels, N,
      V, E, vtiles, ntiles, kFwdGroup, (float*)part);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  fce_fwd_combine_kernel<<<(N + 255) / 256, 256, 0, s>>>(
      (const float*)part, N, vtiles, (float*)lse, (float*)lab, (float*)tot);
  return (int)cudaGetLastError();
}

int tc_dlogit(const void* x, const void* w, const void* b, const void* labels,
              const void* lse, const void* g_lse, const void* g_lab,
              const void* g_tot, void* d, void* db, void* part, int N, int E,
              int v0, int width, int ldd, cudaStream_t s) {
  static const int attr = allow_tc_smem(fce_tc_dlogit_kernel);
  if (attr != 0) return attr;
  const int tiles = (N + mma::kBM - 1) / mma::kBM;
  const dim3 grid((width + mma::kBN - 1) / mma::kBN, tiles);
  fce_tc_dlogit_kernel<<<grid, mma::kThreads, mma::kSmemBytes, s>>>(
      (const bf16*)x, (const bf16*)w, (const float*)b, (const int*)labels,
      (const float*)lse, (const float*)g_lse, (const float*)g_lab,
      (const float*)g_tot, (bf16*)d, db ? (float*)part : nullptr, N, E, v0,
      width, ldd);
  int err = (int)cudaGetLastError();
  if (err != 0 || db == nullptr) return err;
  // the token tiles' column sums, in order
  fce_tc_db_kernel<<<(width + 255) / 256, 256, 0, s>>>(
      (const float*)part, (float*)db + v0, width, tiles);
  return (int)cudaGetLastError();
}

template <typename OUT>
int tc_dx(const void* d, const void* w, const void* dxf, void* out,
          void* part, int N, int E, int v0, int width, int ldd,
          int accumulate, int splits, cudaStream_t s) {
  static const int attr = allow_tc_smem(fce_tc_dx_kernel<OUT>);
  if (attr != 0) return attr;
  const dim3 grid((E + mma::kBN - 1) / mma::kBN, (N + mma::kBM - 1) / mma::kBM,
                  splits);
  fce_tc_dx_kernel<OUT><<<grid, mma::kThreads, mma::kSmemBytes, s>>>(
      (const bf16*)d, (const bf16*)w, (const float*)dxf, (OUT*)out,
      (float*)part, N, E, v0, width, ldd, accumulate);
  int err = (int)cudaGetLastError();
  if (err != 0 || splits == 1) return err;
  return sum_slices((const float*)part,
                    accumulate ? (const float*)dxf : nullptr, (OUT*)out,
                    (size_t)N * E, splits, s);
}

int tc_dw(const void* d, const void* x, void* dw, void* part, int N, int E,
          int v0, int width, int ldd, int splits, cudaStream_t s) {
  static const int attr = allow_tc_smem(fce_tc_dw_kernel);
  if (attr != 0) return attr;
  const dim3 grid((E + mma::kBN - 1) / mma::kBN,
                  (width + mma::kBM - 1) / mma::kBM, splits);
  fce_tc_dw_kernel<<<grid, mma::kThreads, mma::kSmemBytes, s>>>(
      (const bf16*)d, (const bf16*)x, (bf16*)dw, (float*)part, N, E, v0,
      width, ldd);
  int err = (int)cudaGetLastError();
  if (err != 0 || splits == 1) return err;
  return sum_slices((const float*)part, nullptr, (bf16*)dw + (size_t)v0 * E,
                    (size_t)width * E, splits, s);
}

}  // namespace
#endif

// This library's operand type (KERNEL_DTYPE, attention_tiles.cuh). Every
// entry point takes the type its caller expects (bf16) and returns
// cudaErrorInvalidValue for the other.
#if KERNEL_DTYPE == 1
using Op = __nv_bfloat16;
#else
using Op = float;
#endif

// x, w float32 (bf16 0) or bfloat16 (bf16 1), of one type; b, lse, lab,
// tot and part float32; labels int32; all contiguous. part is scratch of
// 4 * ceil(V / 256) * N floats; vec: E % 4 == 0 and x, w 16-byte
// aligned. Launches the partial-stats kernel and its fixed-order merge.
// Returns cudaGetLastError().
extern "C" int fused_ce_fwd(const void* x, const void* w, const void* b,
                            const void* labels, void* lse, void* lab,
                            void* tot, void* part, int N, int V, int E,
                            int vec, int bf16, void* stream) {
  if (bf16 != KERNEL_DTYPE) return (int)cudaErrorInvalidValue;
  return fwd<Op>(x, w, b, labels, lse, lab, tot, part, N, V, E, vec,
                 (cudaStream_t)stream);
}

// The backward of one vocabulary chunk [v0, v0 + width), in three calls
// the wrapper makes in this order. x, w (and dx, dw) float32 or bfloat16
// as bf16 says; b, lse, the cotangents, d, db and the scratch float32;
// labels int32; all contiguous. d is the [N, ldd] scratch (ldd a multiple
// of 128, at least width); vec: E % 4 == 0 and x, w, dx, dw 16-byte
// aligned. Each returns cudaGetLastError().
extern "C" int fused_ce_bwd_dlogit(const void* x, const void* w,
                                   const void* b, const void* labels,
                                   const void* lse, const void* g_lse,
                                   const void* g_lab, const void* g_tot,
                                   void* d, int N, int E, int v0, int width,
                                   int ldd, int vec, int bf16, void* stream) {
  if (bf16 != KERNEL_DTYPE) return (int)cudaErrorInvalidValue;
  return dlogit<Op>(x, w, b, labels, lse, g_lse, g_lab, g_tot, d, N, E, v0,
                    width, ldd, vec, (cudaStream_t)stream);
}

// dxf: the f32 running sum [N][E] (accumulate 0 for the first chunk, 1
// for the later ones); dx: where the last chunk (last 1) writes the total,
// in the operands' type. For float32 dxf and dx may be one buffer. With
// splits > 1, part is scratch of splits * N * E floats.
extern "C" int fused_ce_bwd_dx(const void* d, const void* w, void* dxf,
                               void* dx, void* part, int N, int E, int v0,
                               int width, int ldd, int accumulate, int last,
                               int vec, int splits, int bf16, void* stream) {
  if (bf16 != KERNEL_DTYPE) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!last)
    return dx_chunk<Op, float>(d, w, dxf, dxf, part, N, E, v0, width, ldd,
                               accumulate, vec, splits, s);
  return dx_chunk<Op, Op>(d, w, dxf, dx, part, N, E, v0, width, ldd,
                          accumulate, vec, splits, s);
}

// dw in the operands' type, db float32; with splits > 1, part is scratch
// of splits * width * (E + 1) floats
extern "C" int fused_ce_bwd_dw(const void* d, const void* x, void* dw,
                               void* db, void* part, int N, int E, int v0,
                               int width, int ldd, int vec, int splits,
                               int bf16, void* stream) {
  if (bf16 != KERNEL_DTYPE) return (int)cudaErrorInvalidValue;
  return dw_chunk<Op>(d, x, dw, db, part, N, E, v0, width, ldd, vec, splits,
                      (cudaStream_t)stream);
}

#if KERNEL_DTYPE == 1
// The bf16 forward on the tensor cores, for E % 8 == 0 and x, w 16-byte
// aligned (the wrapper's tc_path): as fused_ce_fwd, with part scratch of
// 4 * ceil(V / 128) * N floats.
extern "C" int fused_ce_fwd_tc(const void* x, const void* w, const void* b,
                               const void* labels, void* lse, void* lab,
                               void* tot, void* part, int N, int V, int E,
                               void* stream) {
  return tc_fwd(x, w, b, labels, lse, lab, tot, part, N, V, E,
                (cudaStream_t)stream);
}

// The bf16 backward on the tensor cores, for E % 8 == 0 and x, w, dx, dw
// 16-byte aligned (the wrapper's tc_path), in the same three calls a
// chunk. d is the [N, ldd] bf16 scratch (ldd a multiple of 128, at least
// width): fused_ce_bwd_tc_dlogit stores it rounded and, given db, sums
// the unrounded d into db[v0 : v0 + width] through part (ceil(N / 128) *
// width floats), token tile by token tile in order. dx and dw as
// fused_ce_bwd_dx and fused_ce_bwd_dw take them, part their scratch for
// splits > 1 (splits * N * E, splits * width * E floats).
extern "C" int fused_ce_bwd_tc_dlogit(
    const void* x, const void* w, const void* b, const void* labels,
    const void* lse, const void* g_lse, const void* g_lab, const void* g_tot,
    void* d, void* db, void* part, int N, int E, int v0, int width, int ldd,
    void* stream) {
  return tc_dlogit(x, w, b, labels, lse, g_lse, g_lab, g_tot, d, db, part, N,
                   E, v0, width, ldd, (cudaStream_t)stream);
}

extern "C" int fused_ce_bwd_tc_dx(const void* d, const void* w, void* dxf,
                                  void* dx, void* part, int N, int E, int v0,
                                  int width, int ldd, int accumulate, int last,
                                  int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!last)
    return tc_dx<float>(d, w, dxf, dxf, part, N, E, v0, width, ldd,
                        accumulate, splits, s);
  return tc_dx<bf16>(d, w, dxf, dx, part, N, E, v0, width, ldd, accumulate,
                     splits, s);
}

extern "C" int fused_ce_bwd_tc_dw(const void* d, const void* x, void* dw,
                                  void* part, int N, int E, int v0, int width,
                                  int ldd, int splits, void* stream) {
  return tc_dw(d, x, dw, part, N, E, v0, width, ldd, splits,
               (cudaStream_t)stream);
}
#endif
