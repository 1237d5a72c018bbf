// Fused output projection + label-smoothed cross-entropy statistics, and
// their two gradients, without materialising the [N, V] logits.
//
// Replaces the TPU kernels of marian_tpu/ops/pallas/fused_ce.py:
//   fused_ce_fwd  <- _fwd_kernel (from _fwd_call): per token
//                    lse = logsumexp_v(l), lab = l[label], tot = sum_v l
//                    of l = x . w^T + b;
//   fused_ce_dx   <- _dx_kernel (from _bwd_call):  dx = d . w;
//   fused_ce_dw   <- _dw_kernel (from _bwd_call):  dw = d^T . x, db = sum_n d;
// with d = g_lse * exp(l - lse) + g_lab * onehot(label) + g_tot on the V
// real vocabulary columns (0 past the ragged edge V, which the kernels
// mask themselves: the table is never padded).
//
// What bounds them on an H100: operations. Each is a product of
// N*V*E multiply-adds (the forward one, dx and dw two: the logits are
// recomputed, as on the TPU), 403 GFLOP per product at N = 12,288,
// V = 32,000, E = 512, against 25 MB of x and 65 MB of w. They run in f32
// on the CUDA cores, outside the tensor cores (TF32 stays off).
//
// Design, simple first (no wgmma, no TMA; later PRs):
// - logits are formed in 64 x 64 tiles (tokens x vocabulary) by 256
//   threads, each holding a 4 x 4 register tile (rows ty + 16i, columns
//   tx + 16j, so shared-memory reads are broadcasts or consecutive words);
//   the E reduction streams x and w through shared memory 32 columns at a
//   time, stored k-major with a +1 pad so the transposing stores do not
//   collide on a bank. Each chunk's global loads are issued into
//   registers before the previous chunk is multiplied, so their latency
//   hides behind arithmetic even with one block on an SM;
// - the TPU carries running stats across a sequential vocabulary grid axis.
//   Here a forward block owns a token tile and walks one slice of the
//   vocabulary, keeping online (max, sum-exp, label logit, sum) per thread;
//   the 16 threads of a row merge by warp shuffles, and a second, fixed-
//   order pass merges the slices: deterministic, no atomics;
// - dx: a block owns a token tile and walks one slice of the vocabulary;
//   its [64, ecw] accumulator lives in shared memory (128 KB at ecw =
//   E = 512). Per vocabulary tile: logits, then d into shared memory,
//   then d . w in 64-column chunks. The slices (enough of them for two
//   blocks per SM over the launch) write partial dx that a second,
//   fixed-order pass sums;
// - dw/db: the mirror image: a block owns a vocabulary tile, walks all
//   tokens, and accumulates [64, ecw] of dw in shared memory and db per
//   column in a register, in a fixed order;
// - an E too wide for one accumulator (past 704 columns, e.g. 1024) is
//   split into ceil(E / ecw) column ranges of ecw each, one per z-block
//   of the grid (ops/kernels/fused_ce.py :: accumulator_width): each
//   range recomputes the logits, so dx and dw cost one more product per
//   extra range, and every E runs the kernels.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTM = 64;        // tokens per tile
constexpr int kTN = 64;        // vocabulary rows per tile
constexpr int kBK = 32;        // E columns per staged chunk
constexpr int kEC = 64;        // E columns per accumulator chunk (dx, dw)
constexpr int kThreads = 256;  // 16 x 16, 4 x 4 outputs each
constexpr float kStatsInit = -1e30f;

constexpr int kPerThread = kTM * kBK / kThreads;   // staged floats a thread
static_assert(kTM == kTN && kTM * kBK % kThreads == 0, "tile shape");

// one E chunk of the x and w tiles into registers (0 outside [N, V, E])
__device__ __forceinline__ void load_chunk(
    const float* __restrict__ x, const float* __restrict__ w, int N, int V,
    int E, int n0, int v0, int e0, float xr[kPerThread],
    float wr[kPerThread]) {
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int idx = threadIdx.x + u * kThreads;
    const int r = idx / kBK, e = e0 + idx - r * kBK;
    const int n = n0 + r, v = v0 + r;
    xr[u] = (n < N && e < E) ? x[(size_t)n * E + e] : 0.f;
    wr[u] = (v < V && e < E) ? w[(size_t)v * E + e] : 0.f;
  }
}

// acc[i][j] = x[n0 + ty + 16i] . w[v0 + tx + 16j] over E, zero outside
// [N, V]. xs and ws hold kBK x (64 + 1) floats each, k-major.
__device__ __forceinline__ void logits_tile(
    const float* __restrict__ x, const float* __restrict__ w, int N, int V,
    int E, int n0, int v0, float* xs, float* ws, float acc[4][4]) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float xr[kPerThread], wr[kPerThread];
  load_chunk(x, w, N, V, E, n0, v0, 0, xr, wr);
  for (int e0 = 0; e0 < E; e0 += kBK) {
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int idx = tid + u * kThreads;
      const int r = idx / kBK, kk = idx - r * kBK;
      xs[kk * (kTM + 1) + r] = xr[u];
      ws[kk * (kTN + 1) + r] = wr[u];
    }
    __syncthreads();
    if (e0 + kBK < E) load_chunk(x, w, N, V, E, n0, v0, e0 + kBK, xr, wr);
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk * (kTM + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = ws[kk * (kTN + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
  }
}

constexpr int kOpPerThread = kTM * kEC / kThreads;  // operand chunk floats

// rows [r0, r0 + 64) x columns [c0, c0 + 64) of src [rows, E] into
// registers (0 outside [rows, E])
__device__ __forceinline__ void load_operand(const float* __restrict__ src,
                                             int rows, int E, int r0, int c0,
                                             float reg[kOpPerThread]) {
#pragma unroll
  for (int u = 0; u < kOpPerThread; ++u) {
    const int idx = threadIdx.x + u * kThreads;
    const int rr = idx / kEC, r = r0 + rr, c = c0 + idx - rr * kEC;
    reg[u] = (r < rows && c < E) ? src[(size_t)r * E + c] : 0.f;
  }
}

// acc_s[i][c0 - c_begin + j] += sum_k d(i, k) * op[k][c0 + j] over each
// 64-column chunk c0 of [c_begin, c_end): d(i, k) is ds[i][k] (dx: i
// token, k vocab) or ds[k][i] (dw: i vocab, k token); op is the operand
// src rows [r0, r0+64) staged chunk by chunk in opc, the next chunk's
// loads in flight while this one is multiplied. acc_s rows are ecw wide.
template <bool kTransposed>
__device__ __forceinline__ void accumulate_chunks(
    const float* __restrict__ src, int rows, int E, int r0, int c_begin,
    int c_end, int ecw, const float* ds, float* opc, float* acc_s) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float reg[kOpPerThread];
  load_operand(src, rows, E, r0, c_begin, reg);
  for (int c0 = c_begin; c0 < c_end; c0 += kEC) {
    __syncthreads();  // ds written / previous chunk consumed
#pragma unroll
    for (int u = 0; u < kOpPerThread; ++u) {
      const int idx = tid + u * kThreads;
      const int rr = idx / kEC;
      opc[rr * (kEC + 1) + idx - rr * kEC] = reg[u];
    }
    __syncthreads();
    if (c0 + kEC < c_end) load_operand(src, rows, E, r0, c0 + kEC, reg);
    float r[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) r[i][j] = 0.f;
#pragma unroll 8
    for (int k = 0; k < kTM; ++k) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = kTransposed ? ds[k * (kTN + 1) + ty + 16 * i]
                           : ds[(ty + 16 * i) * (kTN + 1) + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = opc[k * (kEC + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) r[i][j] = fmaf(a[i], bb[j], r[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 16 * j;
        if (c < c_end) acc_s[(ty + 16 * i) * ecw + c - c_begin] += r[i][j];
      }
  }
}

__device__ __forceinline__ void merge_stats(float& m, float& s, float m2,
                                            float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

// grid (ceil(N/64), splits): block (bx, by) walks vocabulary tiles
// [by * tiles_per_split, ...) and writes partial stats [by][N] x 4.
__global__ void __launch_bounds__(kThreads) fce_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ b, const int* __restrict__ labels, int N,
    int V, int E, int tiles_per_split, float* __restrict__ part) {
  __shared__ float xs[kBK * (kTM + 1)];
  __shared__ float ws[kBK * (kTN + 1)];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * kTM;
  const int ntiles = (V + kTN - 1) / kTN;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(ntiles, t_begin + tiles_per_split);
  float m[4], s[4], lab[4], tot[4];
  int lbl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = n0 + ty + 16 * i;
    m[i] = kStatsInit;
    s[i] = lab[i] = tot[i] = 0.f;
    lbl[i] = row < N ? labels[row] : -1;
  }
  float acc[4][4];
  for (int t = t_begin; t < t_end; ++t) {
    const int v0 = t * kTN;
    logits_tile(x, w, N, V, E, n0, v0, xs, ws, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float l[4];
      bool ok[4];
      float lmax = kStatsInit;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = v0 + tx + 16 * j;
        ok[j] = col < V;
        l[j] = ok[j] ? acc[i][j] + b[col] : 0.f;
        if (ok[j]) {
          lmax = fmaxf(lmax, l[j]);
          tot[i] += l[j];
          if (col == lbl[i]) lab[i] += l[j];
        }
      }
      if (ok[0]) {  // column tx < V: this thread has a real column here
        const float mn = fmaxf(m[i], lmax);
        float acc_s = s[i] * expf(m[i] - mn);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (ok[j]) acc_s += expf(l[j] - mn);
        s[i] = acc_s;
        m[i] = mn;
      }
    }
  }
  // merge the 16 threads of each row (lanes tx = 0..15 of a half warp)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    for (int o = 8; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[i], o);
      const float s2 = __shfl_xor_sync(0xffffffffu, s[i], o);
      merge_stats(m[i], s[i], m2, s2);
      lab[i] += __shfl_xor_sync(0xffffffffu, lab[i], o);
      tot[i] += __shfl_xor_sync(0xffffffffu, tot[i], o);
    }
    const int row = n0 + ty + 16 * i;
    if (tx == 0 && row < N) {
      const size_t o = (size_t)blockIdx.y * N + row;
      const size_t plane = (size_t)gridDim.y * N;
      part[o] = m[i];
      part[plane + o] = s[i];
      part[2 * plane + o] = lab[i];
      part[3 * plane + o] = tot[i];
    }
  }
}

// one thread per token: merge the vocabulary slices in order
__global__ void fce_fwd_combine_kernel(const float* __restrict__ part, int N,
                                       int splits, float* __restrict__ lse,
                                       float* __restrict__ lab,
                                       float* __restrict__ tot) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const size_t plane = (size_t)splits * N;
  float m = kStatsInit, s = 0.f, g = 0.f, t = 0.f;
  for (int k = 0; k < splits; ++k) {
    const size_t o = (size_t)k * N + row;
    merge_stats(m, s, part[o], part[plane + o]);
    g += part[2 * plane + o];
    t += part[3 * plane + o];
  }
  lse[row] = m + logf(s == 0.f ? 1.f : s);
  lab[row] = g;
  tot[row] = t;
}

__device__ __forceinline__ float dlogit(float l, float lse, float gl,
                                        float gg, float gt, bool is_label) {
  return gl * expf(l - lse) + (is_label ? gg : 0.f) + gt;
}

// smem floats of the dx / dw kernels: two staging chunks, the d tile, a
// 64 x 64 operand chunk, and the [64, ecw] accumulator
__host__ __device__ constexpr size_t bwd_fixed_floats() {
  return 2 * (size_t)kBK * (kTM + 1) + 2 * (size_t)kTM * (kTN + 1);
}

// grid (ceil(N/64), splits, ceil(E/ecw)): block (bx, by, bz) owns tokens
// [n0, n0+64) and columns [bz * ecw, ...) and walks vocab tiles
// [by * tiles_per_split, ...); writes its partial dx to part[by].
__global__ void __launch_bounds__(kThreads) fce_dx_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ b, const int* __restrict__ labels,
    const float* __restrict__ lse, const float* __restrict__ g_lse,
    const float* __restrict__ g_lab, const float* __restrict__ g_tot,
    float* __restrict__ part, int N, int V, int E, int tiles_per_split,
    int ecw) {
  extern __shared__ float smem[];
  float* xs = smem;                        // [kBK][kTM+1]
  float* ws = xs + kBK * (kTM + 1);        // [kBK][kTN+1]
  float* ds = ws + kBK * (kTN + 1);        // [kTM][kTN+1] d tile
  float* wc = ds + kTM * (kTN + 1);        // [kTN][kEC+1] w chunk
  float* acc_s = wc + kTN * (kEC + 1);     // [kTM][ecw] dx accumulator
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * kTM;
  const int c_begin = blockIdx.z * ecw, c_end = min(E, c_begin + ecw);
  for (int i = tid; i < kTM * ecw; i += kThreads) acc_s[i] = 0.f;
  float r_lse[4], r_gl[4], r_gg[4], r_gt[4];
  int lbl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = n0 + ty + 16 * i;
    const bool in = row < N;
    r_lse[i] = in ? lse[row] : 0.f;
    r_gl[i] = in ? g_lse[row] : 0.f;
    r_gg[i] = in ? g_lab[row] : 0.f;
    r_gt[i] = in ? g_tot[row] : 0.f;
    lbl[i] = in ? labels[row] : -1;
  }
  const int ntiles = (V + kTN - 1) / kTN;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(ntiles, t_begin + tiles_per_split);
  float acc[4][4];
  for (int t = t_begin; t < t_end; ++t) {
    const int v0 = t * kTN;
    logits_tile(x, w, N, V, E, n0, v0, xs, ws, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = n0 + ty + 16 * i, col = v0 + tx + 16 * j;
        ds[(ty + 16 * i) * (kTN + 1) + tx + 16 * j] =
            (row < N && col < V)
                ? dlogit(acc[i][j] + b[col], r_lse[i], r_gl[i], r_gg[i],
                         r_gt[i], col == lbl[i])
                : 0.f;
      }
    accumulate_chunks<false>(w, V, E, v0, c_begin, c_end, ecw, ds, wc,
                             acc_s);
  }
  __syncthreads();
  float* out = part + (size_t)blockIdx.y * N * E;
  for (int i = tid; i < kTM * ecw; i += kThreads) {
    const int rr = i / ecw, row = n0 + rr, c = c_begin + i - rr * ecw;
    if (row < N && c < c_end) out[(size_t)row * E + c] = acc_s[i];
  }
}

// dx = sum of the slices' partial dx, in slice order
__global__ void fce_dx_combine_kernel(const float* __restrict__ part,
                                      size_t count, int splits,
                                      float* __restrict__ dx) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float acc = part[i];
  for (int k = 1; k < splits; ++k) acc += part[(size_t)k * count + i];
  dx[i] = acc;
}

// grid (ceil(V/64), ceil(E/ecw)): block (bx, bz) owns vocabulary rows
// [v0, v0+64) and columns [bz * ecw, ...), walks every token tile; the
// bz = 0 blocks write db.
__global__ void __launch_bounds__(kThreads) fce_dw_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ b, const int* __restrict__ labels,
    const float* __restrict__ lse, const float* __restrict__ g_lse,
    const float* __restrict__ g_lab, const float* __restrict__ g_tot,
    float* __restrict__ dw, float* __restrict__ db, int N, int V, int E,
    int ecw) {
  extern __shared__ float smem[];
  float* xs = smem;                        // [kBK][kTM+1]
  float* ws = xs + kBK * (kTM + 1);        // [kBK][kTN+1]
  float* ds = ws + kBK * (kTN + 1);        // [kTM][kTN+1] d tile
  float* xc = ds + kTM * (kTN + 1);        // [kTM][kEC+1] x chunk
  float* acc_s = xc + kTM * (kEC + 1);     // [kTN][ecw] dw accumulator
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int v0 = blockIdx.x * kTN;
  const int c_begin = blockIdx.z * ecw, c_end = min(E, c_begin + ecw);
  for (int i = tid; i < kTN * ecw; i += kThreads) acc_s[i] = 0.f;
  float db_acc = 0.f;                      // column tid of the tile
  float bias[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = v0 + tx + 16 * j;
    bias[j] = col < V ? b[col] : 0.f;
  }
  float acc[4][4];
  for (int n0 = 0; n0 < N; n0 += kTM) {
    logits_tile(x, w, N, V, E, n0, v0, xs, ws, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = n0 + ty + 16 * i;
      const bool in = row < N;
      const float r_lse = in ? lse[row] : 0.f;
      const float r_gl = in ? g_lse[row] : 0.f;
      const float r_gg = in ? g_lab[row] : 0.f;
      const float r_gt = in ? g_tot[row] : 0.f;
      const int lbl = in ? labels[row] : -1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = v0 + tx + 16 * j;
        ds[(ty + 16 * i) * (kTN + 1) + tx + 16 * j] =
            (in && col < V) ? dlogit(acc[i][j] + bias[j], r_lse, r_gl, r_gg,
                                     r_gt, col == lbl)
                            : 0.f;
      }
    }
    __syncthreads();
    if (tid < kTN)
      for (int rr = 0; rr < kTM; ++rr) db_acc += ds[rr * (kTN + 1) + tid];
    accumulate_chunks<true>(x, N, E, n0, c_begin, c_end, ecw, ds, xc,
                            acc_s);
  }
  __syncthreads();
  for (int i = tid; i < kTN * ecw; i += kThreads) {
    const int vv = i / ecw, v = v0 + vv, c = c_begin + i - vv * ecw;
    if (v < V && c < c_end) dw[(size_t)v * E + c] = acc_s[i];
  }
  if (blockIdx.z == 0 && tid < kTN && v0 + tid < V) db[v0 + tid] = db_acc;
}

int set_smem(const void* kern, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// All tensors float32 and contiguous; labels int32. part is scratch of
// 4 * splits * N floats. Launches the partial-stats kernel and its
// fixed-order merge. Returns cudaGetLastError().
extern "C" int fused_ce_fwd(const void* x, const void* w, const void* b,
                            const void* labels, void* lse, void* lab,
                            void* tot, void* part, int N, int V, int E,
                            int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int ntiles = (V + kTN - 1) / kTN;
  const int tps = (ntiles + splits - 1) / splits;
  const dim3 grid((N + kTM - 1) / kTM, splits);
  fce_fwd_kernel<<<grid, kThreads, 0, s>>>(
      (const float*)x, (const float*)w, (const float*)b, (const int*)labels,
      N, V, E, tps, (float*)part);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  fce_fwd_combine_kernel<<<(N + 255) / 256, 256, 0, s>>>(
      (const float*)part, N, splits, (float*)lse, (float*)lab, (float*)tot);
  return (int)cudaGetLastError();
}

// part is scratch of splits * N * E floats (unused when splits is 1);
// ecw is the accumulator's width in columns, a multiple of 64.
extern "C" int fused_ce_dx(const void* x, const void* w, const void* b,
                           const void* labels, const void* lse,
                           const void* g_lse, const void* g_lab,
                           const void* g_tot, void* dx, void* part, int N,
                           int V, int E, int splits, int ecw, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem =
      (bwd_fixed_floats() + (size_t)kTM * ecw) * sizeof(float);
  int err = set_smem((const void*)fce_dx_kernel, smem);
  if (err != 0) return err;
  const int ntiles = (V + kTN - 1) / kTN;
  const int tps = (ntiles + splits - 1) / splits;
  const dim3 grid((N + kTM - 1) / kTM, splits, (E + ecw - 1) / ecw);
  fce_dx_kernel<<<grid, kThreads, smem, s>>>(
      (const float*)x, (const float*)w, (const float*)b, (const int*)labels,
      (const float*)lse, (const float*)g_lse, (const float*)g_lab,
      (const float*)g_tot, splits == 1 ? (float*)dx : (float*)part, N, V, E,
      tps, ecw);
  err = (int)cudaGetLastError();
  if (err != 0 || splits == 1) return err;
  const size_t count = (size_t)N * E;
  fce_dx_combine_kernel<<<(unsigned)((count + 255) / 256), 256, 0, s>>>(
      (const float*)part, count, splits, (float*)dx);
  return (int)cudaGetLastError();
}

extern "C" int fused_ce_dw(const void* x, const void* w, const void* b,
                           const void* labels, const void* lse,
                           const void* g_lse, const void* g_lab,
                           const void* g_tot, void* dw, void* db, int N,
                           int V, int E, int ecw, void* stream) {
  const size_t smem =
      (bwd_fixed_floats() + (size_t)kTN * ecw) * sizeof(float);
  int err = set_smem((const void*)fce_dw_kernel, smem);
  if (err != 0) return err;
  const dim3 grid((V + kTN - 1) / kTN, 1, (E + ecw - 1) / ecw);
  fce_dw_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)b, (const int*)labels,
      (const float*)lse, (const float*)g_lse, (const float*)g_lab,
      (const float*)g_tot, (float*)dw, (float*)db, N, V, E, ecw);
  return (int)cudaGetLastError();
}
