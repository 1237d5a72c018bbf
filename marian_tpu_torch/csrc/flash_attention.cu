// Long-sequence (flash) attention: forward, dq and dkv kernels.
//
// Replaces the TPU kernels of marian_tpu/ops/pallas/flash_attention.py:
//   flash_attention_fwd  <- _fwd_kernel (called from _fwd_call)
//   flash_attention_dq   <- _dq_kernel  (called from _bwd_call)
//   flash_attention_dkv  <- _dkv_kernel (called from _bwd_call)
// Semantics kept exactly:
//   s = (q.k) * scale + (1 - kv_mask[k]) * -1e9       (scale AFTER the dot)
//   causal: positions q < k (absolute) are REPLACED by -1e9
//   forward: online softmax over key tiles from a running max of -1e30,
//            out = acc / l and lse = m + log(l), l == 0 guarded to 1
//   backward: p = exp(s - lse), ds = p * (dO.V^T - delta) * scale,
//            dq = sum ds.K, dv = sum p^T.dO, dk = sum ds^T.Q,
//            delta = rowsum(dO * out) computed outside (the wrapper)
// Compute is f32 whatever the input dtype; outputs take the input dtype.
//
// The TPU grids become the block grids: the forward runs one block per
// (batch, head, 64-query tile) looping over 64-key tiles, dq one block per
// (batch, head, 128-query tile) looping over 64-key tiles, dkv one block
// per (batch, head, 128-key tile) looping over 64-query tiles (64-row
// own tiles at Dh 128), so every output element has one writer: no
// atomics, a fixed summation order, and the result does not depend on the
// order in which blocks run (two calls give the same bits). The TPU's
// padding of Tq and Tk to block multiples is not carried over: keys past
// Tk are left out of the softmax and query rows past Tq are neither
// written nor summed into dk/dv, so a fully masked row averages V over
// the Tk real keys (the dense path's answer). Causal: a (query tile, key
// tile) pair is skipped only when every key of the key tile lies after
// every query of the query tile and every row of the query tile sees a
// live key (the batch row's first live key lies at or before the tile's
// first query); those keys then weigh exp(-1e9 - max) = 0 exactly, so
// the three kernels need not skip the same pairs to agree.
//
// What bounds it on an H100: operations. Per (batch, head) the forward
// does 4*Tq*Tk*Dh flops (the scores and the V product) on 4*T*Dh elements,
// dq 6*Tq*Tk*Dh (scores, dO.V^T, ds.K) and dkv 8*Tq*Tk*Dh (scores, dO.V^T,
// p^T.dO, ds^T.Q): at T = 2048, Dh = 64 that is some 500 flops a byte, far
// past the f32 balance point of the CUDA cores (~20), and causal halves
// it. Everything runs on the f32 CUDA cores (no tensor cores: the port
// trains in f32 with TF32 off).
//
// The forward keeps every product in shared memory: the block stages Q
// once and streams K and V tile by tile, each [64][Dh+1] f32, through a
// 64 x 64 or 64 x Dh register-tiled loop: 256 threads as 16 x 16, each
// owning rows ty + 16i and columns tx + 16j, so the sixteen threads of a
// half-warp share a row and reduce the softmax statistics with four
// shuffles. Its inner loops read one float per FMA pair from shared
// memory, so they run at no more than half the FMA rate.
//
// The backward kernels are built so that the FMA units, not shared
// memory, set their pace. A thread holds an R x 4 fragment of the score
// tile (R = 8 own rows ty + 16i, 4 streamed rows tx + 16j) and R x Dh/16
// accumulators; operand rows are stored with a stride of Dh + 4 floats,
// so the s and dO.V^T products read both operands as float4 along Dh (the
// two own rows a warp reads are broadcast, its sixteen streamed rows fall
// on distinct banks), and the score-tile products read p^T or ds as
// float4 along the tile (stride 64 + 16: the two rows a warp stores land
// 16 banks apart) against the streamed tile's float4 columns. At Dh 64
// that is 8 FMAs for every float4 read in each product, twice what the
// FMA rate needs. The streamed tile is staged with 16-byte cp.async into
// one of two buffers while the block computes on the other, so one
// __syncthreads a tile publishes the next stage (bf16 tiles convert
// through registers; dkv at Dh 128 has room for one stage). dq recomputes
// s and dO.V^T and dkv does again: 14*Tq*Tk*Dh flops where dq, dk and dv
// need 10, the price of one writer per output (a fused pass would sum dq
// across key tiles, through atomics or a partial per key tile).
//
// Shared memory per block (floats; SD = Dh + 1 forward, Dh + 4 backward;
// own rows O = 128, or 64 at Dh 128):
//   forward 3*64*SD + 64*65 + 64          (66.8 KB at Dh 64, 116 KB at 128)
//   dq      2*O*SD + O*80 + 2*O + 2*(2*64*SD + 64)
//                                         (182 KB at Dh 64, 224 KB at 128)
//   dkv     2*O*SD + 2*O*80 + O + stages*(2*64*SD + 128)
//                                         (223 KB at Dh 64, 177 KB at 128)
// each above 48 KB, so every launch raises the dynamic limit first; one
// backward block fits an SM (__launch_bounds__(256, 1)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kTile = 64;       // query and key tile
constexpr int kPS = kTile + 1;  // stride of a [64][64] score tile
constexpr float kMask = -1e9f;
constexpr float kStatsInit = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// reductions over the sixteen threads that share a row (lanes tx = 0..15
// of one half-warp)
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [row0, row0 + 64) of a [rows][DH] matrix into dst[64][DH+1] as
// f32; rows past `rows` are zero
template <typename T, int DH>
__device__ __forceinline__ void stage(const T* __restrict__ src, int row0,
                                      int rows, float* dst) {
  for (int i = threadIdx.x; i < kTile * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    dst[r * (DH + 1) + d] =
        row0 + r < rows ? to_f32(src[(size_t)(row0 + r) * DH + d]) : 0.f;
  }
}

// additive key mask of keys [k0, k0 + 64): (1 - kv_mask) * -1e9
__device__ __forceinline__ void stage_bias(const float* __restrict__ kvm,
                                           int k0, int Tk, float* bias) {
  for (int j = threadIdx.x; j < kTile; j += kThreads)
    bias[j] = k0 + j < Tk ? (1.f - kvm[k0 + j]) * kMask : 0.f;
}

// the batch row's first live key (Tk if none), for the causal tile skip
__device__ __forceinline__ int first_live_key(const float* __restrict__ kvm,
                                              int Tk, int causal, int* slot) {
  if (threadIdx.x == 0) *slot = Tk;
  __syncthreads();
  if (causal)
    for (int j = threadIdx.x; j < Tk; j += kThreads)
      if (kvm[j] != 0.f) {
        atomicMin(slot, j);
        break;
      }
  __syncthreads();
  return *slot;
}

// acc[i][j] = sum_d A[(ty + 16i)][d] * B[(tx + 16j)][d] over [64][DH+1]
// tiles, d = 0, 1, ... in order (the order of a plain dot product)
template <int DH>
__device__ __forceinline__ void dot_tile(const float* A, const float* B,
                                         float acc[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (DH + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * (DH + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][f] += sum_c P[(ty + 16i)][c] * M[c][tx + 16f], P a [64][65]
// score tile and M a [64][DH+1] operand tile, c = 0, 1, ... in order
template <int DH>
__device__ __forceinline__ void apply_tile(const float* P, const float* M,
                                           float acc[4][DH / 16]) {
  constexpr int NF = DH / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int c = 0; c < kTile; ++c) {
    float a[4], b[NF];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = P[(ty + 16 * i) * kPS + c];
#pragma unroll
    for (int f = 0; f < NF; ++f) b[f] = M[c * (DH + 1) + tx + 16 * f];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int f = 0; f < NF; ++f) acc[i][f] = fmaf(a[i], b[f], acc[i][f]);
  }
}

// ---------------------------------------------------------------------------
// forward: grid (query tiles, B*H)

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ kv_mask, T* __restrict__ out,
    float* __restrict__ lse, int H, int Tq, int Tk, float scale, int causal) {
  constexpr int SD = DH + 1, NF = DH / 16;
  extern __shared__ float smem[];
  float* qs = smem;                 // [64][SD]
  float* ks = qs + kTile * SD;      // [64][SD]
  float* vs = ks + kTile * SD;      // [64][SD]
  float* ps = vs + kTile * SD;      // [64][65] probabilities of the tile
  float* bias = ps + kTile * kPS;   // [64]
  __shared__ int first_slot;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, b = bh / H, q0 = blockIdx.x * kTile;
  const float* kvm = kv_mask + (size_t)b * Tk;
  const int first = first_live_key(kvm, Tk, causal, &first_slot);
  stage<T, DH>(q + (size_t)bh * Tq * DH, q0, Tq, qs);

  float m[4], l[4], acc[4][NF];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kStatsInit;
    l[i] = 0.f;
#pragma unroll
    for (int f = 0; f < NF; ++f) acc[i][f] = 0.f;
  }
  int n_k = (Tk + kTile - 1) / kTile;
  if (causal && q0 >= first) n_k = min(n_k, q0 / kTile + 1);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done
    stage<T, DH>(k + (size_t)bh * Tk * DH, k0, Tk, ks);
    stage<T, DH>(v + (size_t)bh * Tk * DH, k0, Tk, vs);
    stage_bias(kvm, k0, Tk, bias);
    __syncthreads();
    float s[4][4];
    dot_tile<DH>(qs, ks, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale + bias[tx + 16 * j];
        if (causal && row < col) x = kMask;
        s[i][j] = col < Tk ? x : -INFINITY;  // past Tk: not a key
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * kPS + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int f = 0; f < NF; ++f) acc[i][f] *= alpha;
    }
    __syncthreads();
    apply_tile<DH>(ps, vs, acc);
  }
  const size_t obase = (size_t)bh * Tq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int f = 0; f < NF; ++f)
      out[(obase + row) * DH + tx + 16 * f] = from_f32<T>(acc[i][f] / ls);
    if (tx == 0) lse[obase + row] = m[i] + logf(ls);
  }
}

template <typename Kernel>
int prepare(Kernel kern, size_t smem, int B, int H) {
  if ((size_t)B * H > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return (int)e;
}

template <typename T, int DH>
int launch_fwd(const void* q, const void* k, const void* v, const void* kvm,
               void* out, void* lse, int B, int H, int Tq, int Tk,
               float scale, int causal, cudaStream_t stream) {
  const size_t smem =
      (3 * kTile * (DH + 1) + kTile * kPS + kTile) * sizeof(float);
  auto kern = flash_fwd_kernel<T, DH>;
  if (int e = prepare(kern, smem, B, H)) return e;
  const dim3 grid((Tq + kTile - 1) / kTile, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)kvm, (T*)out,
      (float*)lse, H, Tq, Tk, scale, causal);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// backward: register-blocked f32 products on asynchronously staged tiles
// (the header note's second part). A block owns kOwn rows (queries for
// dq, keys for dkv) and streams kSTile-row tiles of the other side;
// thread (ty, tx) of the 16 x 16 grid holds own rows ty + 16i (i < R) of
// the score tile against streamed rows tx + 16j (j < 4), and output
// columns out_col(f) (f < NF) of its own rows' gradients.

constexpr int kSTile = 64;         // rows of a streamed tile
constexpr int kBPS = kSTile + 16;  // stride of a [kOwn][64] score tile

template <int DH>
struct Bwd {
  static constexpr int kOwn = DH <= 64 ? 128 : 64;  // rows a block owns
  static constexpr int R = kOwn / 16;               // own rows a thread
  static constexpr int SD = DH + 4;                 // operand row stride
  static constexpr int NF = DH / 16;                // output columns a thread
  // stages of the streamed tile: two (prefetch the next while computing
  // this one) where they fit the 227 KB a block may take, which dkv's
  // do not at Dh 128
  static constexpr int kDkvStages = DH == 128 ? 1 : 2;
  // floats of one streamed stage: dq K, V and the key mask; dkv Q, dO,
  // lse and delta
  static constexpr int kDqStage = 2 * kSTile * SD + kSTile;
  static constexpr int kDkvStage = 2 * kSTile * SD + 2 * kSTile;
  static constexpr int kDqFloats =
      2 * kOwn * SD + kOwn * kBPS + 2 * kOwn + 2 * kDqStage;
  static constexpr int kDkvFloats =
      2 * kOwn * SD + 2 * kOwn * kBPS + kDkvStages * kDkvStage + kOwn;
  static_assert(kDqFloats * 4 <= 232448 && kDkvFloats * 4 <= 232448,
                "shared memory of a block");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16 (4) bytes global -> shared in flight; with valid false nothing is
// read and the destination is zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// commits what is pending and waits for every copy of this thread
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows [row0, row0 + ROWS) of a [rows][DH] matrix into dst[ROWS][DH + 4]
// as f32, rows past `rows` zero: f32 by 16-byte cp.async (landed after
// the next cp_async_wait_all), bf16 converted through registers
template <int ROWS, int DH>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           int row0, int rows, float* dst) {
  constexpr int C = DH / 4;
  for (int i = threadIdx.x; i < ROWS * C; i += kThreads) {
    const int r = i / C, c = (i % C) * 4;
    const bool in = row0 + r < rows;
    cp_async16(dst + r * (DH + 4) + c,
               src + (size_t)(in ? row0 + r : 0) * DH + c, in);
  }
}
template <int ROWS, int DH>
__device__ __forceinline__ void stage_rows(
    const __nv_bfloat16* __restrict__ src, int row0, int rows, float* dst) {
  constexpr int C = DH / 4;
  for (int i = threadIdx.x; i < ROWS * C; i += kThreads) {
    const int r = i / C, c = (i % C) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) {
      const uint2 u = *reinterpret_cast<const uint2*>(
          src + (size_t)(row0 + r) * DH + c);
      const float2 lo =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      f = make_float4(lo.x, lo.y, hi.x, hi.y);
    }
    *reinterpret_cast<float4*>(dst + r * (DH + 4) + c) = f;
  }
}

// src[i0 .. i0 + 64) into dst by threads t0 .. t0 + 63, 4-byte cp.async,
// zero at and past `end`
__device__ __forceinline__ void stage_vec(const float* __restrict__ src,
                                          int i0, int end, float* dst,
                                          int t0) {
  const int j = (int)threadIdx.x - t0;
  if (j >= 0 && j < kSTile) {
    const bool in = i0 + j < end;
    cp_async4(dst + j, src + (in ? i0 + j : 0), in);
  }
}

__device__ __forceinline__ float lane(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// output column f < NF of this thread: groups of up to 4 contiguous
// columns (one float4 at Dh 64), 64 apart
template <int DH>
__device__ __forceinline__ int out_col(int f) {
  constexpr int NF = DH / 16, W = NF < 4 ? NF : 4;
  return (f / W) * 64 + (int)(threadIdx.x & 15) * W + f % W;
}

// this thread's NF output columns of one staged row
template <int DH>
__device__ __forceinline__ void load_cols(const float* row,
                                          float (&v)[DH / 16]) {
  constexpr int NF = DH / 16;
  const int tx = threadIdx.x & 15;
  if constexpr (NF >= 4) {
#pragma unroll
    for (int g = 0; g < NF / 4; ++g) {
      const float4 x = *reinterpret_cast<const float4*>(row + 64 * g + 4 * tx);
      v[4 * g] = x.x;
      v[4 * g + 1] = x.y;
      v[4 * g + 2] = x.z;
      v[4 * g + 3] = x.w;
    }
  } else if constexpr (NF == 2) {
    const float2 x = *reinterpret_cast<const float2*>(row + 2 * tx);
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = row[tx];
  }
}

// acc[i][j] = sum_d A[ty + 16i][d] * B[tx + 16j][d], d = 0, 1, ... in
// order (a plain dot product's order): A the block's own [16R][DH + 4]
// tile, B a streamed [64][DH + 4] tile, both read as float4 along d
// (the two rows of A a warp reads are broadcast, B's sixteen rows fill
// the banks twice over)
template <int R, int DH>
__device__ __forceinline__ void dot_rows(const float* A, const float* B,
                                         float (&acc)[R][4]) {
  constexpr int SD = DH + 4;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int d = 0; d < DH; d += 4) {
    float4 b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * SD + d);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 a =
          *reinterpret_cast<const float4*>(A + (ty + 16 * i) * SD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(a.x, b[j].x, s);
        s = fmaf(a.y, b[j].y, s);
        s = fmaf(a.z, b[j].z, s);
        acc[i][j] = fmaf(a.w, b[j].w, s);
      }
    }
  }
}

// acc[i][f] += sum_c P[ty + 16i][c] * M[c][out_col(f)] and acc2 the same
// of P2 and M2, c = 0 .. 63 in order: P, P2 [16R][kBPS] score tiles read
// as float4 along c, M, M2 streamed [64][DH + 4] tiles read along their
// columns (with kTwo false, dq's one product)
template <int R, int DH, bool kTwo = false>
__device__ __forceinline__ void apply_rows(const float* P, const float* M,
                                           float (&acc)[R][DH / 16],
                                           const float* P2 = nullptr,
                                           const float* M2 = nullptr,
                                           float (*acc2)[DH / 16] = nullptr) {
  constexpr int SD = DH + 4, NF = DH / 16;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int c = 0; c < kSTile; c += 4) {
    float4 p[R], p2[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * kBPS + c);
      if (kTwo)
        p2[i] =
            *reinterpret_cast<const float4*>(P2 + (ty + 16 * i) * kBPS + c);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float m[NF], m2[NF];
      load_cols<DH>(M + (c + u) * SD, m);
      if (kTwo) load_cols<DH>(M2 + (c + u) * SD, m2);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          acc[i][f] = fmaf(lane(p[i], u), m[f], acc[i][f]);
          if (kTwo) acc2[i][f] = fmaf(lane(p2[i], u), m2[f], acc2[i][f]);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// dq: grid (query tiles of kOwn, B*H); causal calls take the last (heavy)
// query tiles first

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ kv_mask, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int H, int Tq, int Tk, float scale, int causal) {
  using G = Bwd<DH>;
  constexpr int BQ = G::kOwn, R = G::R, SD = G::SD, NF = G::NF;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [BQ][SD]
  float* dos = qs + BQ * SD;                     // [BQ][SD]
  float* dss = dos + BQ * SD;                    // [BQ][kBPS] ds of the tile
  float* lse_s = dss + BQ * kBPS;                // [BQ]
  float* dl_s = lse_s + BQ;                      // [BQ]
  float* stream = dl_s + BQ;                     // 2 x {K, V, key mask}
  __shared__ int first_slot;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, b = bh / H;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  const float* kvm = kv_mask + (size_t)b * Tk;
  const T* kh = k + (size_t)bh * Tk * DH;
  const T* vh = v + (size_t)bh * Tk * DH;
  const int first = first_live_key(kvm, Tk, causal, &first_slot);
  stage_rows<BQ, DH>(q + (size_t)bh * Tq * DH, q0, Tq, qs);
  stage_rows<BQ, DH>(dout + (size_t)bh * Tq * DH, q0, Tq, dos);
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const bool in = q0 + r < Tq;
    lse_s[r] = in ? lse[(size_t)bh * Tq + q0 + r] : 0.f;
    dl_s[r] = in ? delta[(size_t)bh * Tq + q0 + r] : 0.f;
  }
  auto stage_keys = [&](int kt, int buf) {
    float* s = stream + buf * G::kDqStage;
    stage_rows<kSTile, DH>(kh, kt * kSTile, Tk, s);
    stage_rows<kSTile, DH>(vh, kt * kSTile, Tk, s + kSTile * SD);
    stage_vec(kvm, kt * kSTile, Tk, s + 2 * kSTile * SD, 0);
    cp_async_commit();
  };

  float acc[R][NF];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int f = 0; f < NF; ++f) acc[i][f] = 0.f;
  // key tiles wholly in the future of every row, rows that all see a
  // live key: their p is exp(-1e9 - lse) = 0
  int n_k = (Tk + kSTile - 1) / kSTile;
  if (causal && q0 >= first) n_k = min(n_k, (q0 + BQ - 1) / kSTile + 1);
  stage_keys(0, 0);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kSTile, buf = kt & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kt landed; the previous tile's readers are done
    if (kt + 1 < n_k) stage_keys(kt + 1, buf ^ 1);
    const float* ks = stream + buf * G::kDqStage;
    const float* vs = ks + kSTile * SD;
    const float* mk = vs + kSTile * SD;
    float s[R][4], dp[R][4];
    dot_rows<R, DH>(qs, ks, s);
    dot_rows<R, DH>(dos, vs, dp);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, col = k0 + c;
        const float bias = (1.f - mk[c]) * kMask;
        float x = s[i][j] * scale + bias;
        if (causal && row < col) x = kMask;
        const float p = row < Tq && col < Tk ? expf(x - lse_s[r]) : 0.f;
        dss[r * kBPS + c] = p * (dp[i][j] - dl_s[r]) * scale;
      }
    }
    __syncthreads();
    apply_rows<R, DH>(dss, ks, acc);
  }
  cp_async_wait_all();
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
#pragma unroll
    for (int f = 0; f < NF; ++f)
      dq[((size_t)bh * Tq + row) * DH + out_col<DH>(f)] =
          from_f32<T>(acc[i][f]);
  }
}

// ---------------------------------------------------------------------------
// dkv: grid (key tiles of kOwn, B*H); the score tile is held transposed,
// keys in the rows, so that p^T and ds^T feed the two products directly

template <typename T, int DH, int ST>
__global__ void __launch_bounds__(kThreads, 1) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ kv_mask, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int H, int Tq, int Tk,
    float scale, int causal) {
  using G = Bwd<DH>;
  constexpr int BK = G::kOwn, R = G::R, SD = G::SD, NF = G::NF;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [BK][SD]
  float* vs = ks + BK * SD;                      // [BK][SD]
  float* pt = vs + BK * SD;                      // [BK][kBPS] p^T
  float* dst = pt + BK * kBPS;                   // [BK][kBPS] ds^T
  float* stream = dst + BK * kBPS;               // ST x {Q, dO, lse, delta}
  float* bias = stream + ST * G::kDkvStage;      // [BK]
  __shared__ int first_slot;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, b = bh / H, k0 = blockIdx.x * BK;
  const float* kvm = kv_mask + (size_t)b * Tk;
  const T* qh = q + (size_t)bh * Tq * DH;
  const T* doh = dout + (size_t)bh * Tq * DH;
  const float* lseh = lse + (size_t)bh * Tq;
  const float* dlh = delta + (size_t)bh * Tq;
  const int first = first_live_key(kvm, Tk, causal, &first_slot);
  stage_rows<BK, DH>(k + (size_t)bh * Tk * DH, k0, Tk, ks);
  stage_rows<BK, DH>(v + (size_t)bh * Tk * DH, k0, Tk, vs);
  for (int r = threadIdx.x; r < BK; r += kThreads)
    bias[r] = k0 + r < Tk ? (1.f - kvm[k0 + r]) * kMask : 0.f;
  auto stage_queries = [&](int qt, int buf) {
    float* s = stream + buf * G::kDkvStage;
    const int q0 = qt * kSTile;
    stage_rows<kSTile, DH>(qh, q0, Tq, s);
    stage_rows<kSTile, DH>(doh, q0, Tq, s + kSTile * SD);
    stage_vec(lseh, q0, Tq, s + 2 * kSTile * SD, 0);
    stage_vec(dlh, q0, Tq, s + 2 * kSTile * SD + kSTile, kSTile);
    cp_async_commit();
  };
  // the next query tile at or after qt that is not skipped: one wholly
  // before this key tile whose rows all see a live key is (p = 0 there)
  const int n_q = (Tq + kSTile - 1) / kSTile;
  auto next_tile = [&](int qt) {
    while (qt < n_q && causal && qt * kSTile >= first &&
           qt * kSTile + kSTile - 1 < k0)
      ++qt;
    return qt;
  };

  float dk_acc[R][NF], dv_acc[R][NF];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int f = 0; f < NF; ++f) dk_acc[i][f] = dv_acc[i][f] = 0.f;
  int qt = next_tile(0), buf = 0;
  if (qt < n_q) stage_queries(qt, 0);
  while (qt < n_q) {
    const int q0 = qt * kSTile, nxt = next_tile(qt + 1);
    cp_async_wait_all();
    __syncthreads();  // tile qt landed; the previous tile's readers are done
    if (ST == 2 && nxt < n_q) stage_queries(nxt, buf ^ 1);
    const float* qs = stream + buf * G::kDkvStage;
    const float* dos = qs + kSTile * SD;
    const float* lse_s = dos + kSTile * SD;
    const float* dl_s = lse_s + kSTile;
    float s[R][4], dp[R][4];
    dot_rows<R, DH>(ks, qs, s);   // s[key][query] = k.q, the forward's sum
    dot_rows<R, DH>(vs, dos, dp); // dp[key][query] = v.dO
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + 16 * i, key = k0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, row = q0 + c;
        float x = s[i][j] * scale + bias[r];
        if (causal && row < key) x = kMask;
        const float p = row < Tq && key < Tk ? expf(x - lse_s[c]) : 0.f;
        pt[r * kBPS + c] = p;
        dst[r * kBPS + c] = p * (dp[i][j] - dl_s[c]) * scale;
      }
    }
    __syncthreads();
    apply_rows<R, DH, true>(pt, dos, dv_acc, dst, qs, dk_acc);
    if (ST == 1 && nxt < n_q) {
      __syncthreads();  // one stage: its readers are done before it refills
      stage_queries(nxt, 0);
    }
    qt = nxt;
    buf ^= ST - 1;
  }
  cp_async_wait_all();  // K and V, when no query tile was left
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Tk) continue;
    const size_t at = ((size_t)bh * Tk + key) * DH;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      dk[at + out_col<DH>(f)] = from_f32<T>(dk_acc[i][f]);
      dv[at + out_col<DH>(f)] = from_f32<T>(dv_acc[i][f]);
    }
  }
}

template <typename T, int DH>
int launch_dq(const void* q, const void* k, const void* v, const void* kvm,
              const void* dout, const void* lse, const void* delta, void* dq,
              int B, int H, int Tq, int Tk, float scale, int causal,
              cudaStream_t stream) {
  using G = Bwd<DH>;
  const size_t smem = G::kDqFloats * sizeof(float);
  auto kern = flash_dq_kernel<T, DH>;
  if (int e = prepare(kern, smem, B, H)) return e;
  const dim3 grid((Tq + G::kOwn - 1) / G::kOwn, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)kvm,
      (const T*)dout, (const float*)lse, (const float*)delta, (T*)dq, H, Tq,
      Tk, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_dkv(const void* q, const void* k, const void* v, const void* kvm,
               const void* dout, const void* lse, const void* delta,
               void* dk, void* dv, int B, int H, int Tq, int Tk, float scale,
               int causal, cudaStream_t stream) {
  using G = Bwd<DH>;
  const size_t smem = G::kDkvFloats * sizeof(float);
  auto kern = flash_dkv_kernel<T, DH, G::kDkvStages>;
  if (int e = prepare(kern, smem, B, H)) return e;
  const dim3 grid((Tk + G::kOwn - 1) / G::kOwn, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)kvm,
      (const T*)dout, (const float*)lse, (const float*)delta, (T*)dk,
      (T*)dv, H, Tq, Tk, scale, causal);
  return (int)cudaGetLastError();
}

// one instance per (dtype, head size): 0 = float32, 1 = bfloat16
#define FLASH_DISPATCH(CALL)                                     \
  switch (dtype * 1000 + Dh) {                                   \
    case 16: return CALL(float, 16);                             \
    case 32: return CALL(float, 32);                             \
    case 64: return CALL(float, 64);                             \
    case 128: return CALL(float, 128);                           \
    case 1016: return CALL(__nv_bfloat16, 16);                   \
    case 1032: return CALL(__nv_bfloat16, 32);                   \
    case 1064: return CALL(__nv_bfloat16, 64);                   \
    case 1128: return CALL(__nv_bfloat16, 128);                  \
    default: return (int)cudaErrorInvalidValue;                  \
  }

}  // namespace

// kv_mask is float32 [B, Tk]; lse and delta float32 [B, H, Tq]. Every
// entry point returns cudaGetLastError() (or the error of raising the
// shared-memory limit).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* kv_mask,
                                   void* out, void* lse, int B, int H, int Tq,
                                   int Tk, int Dh, float scale, int causal,
                                   int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define CALL(T, D) \
  launch_fwd<T, D>(q, k, v, kv_mask, out, lse, B, H, Tq, Tk, scale, causal, s)
  FLASH_DISPATCH(CALL)
#undef CALL
}

extern "C" int flash_attention_dq(const void* q, const void* k,
                                  const void* v, const void* kv_mask,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dq, int B, int H,
                                  int Tq, int Tk, int Dh, float scale,
                                  int causal, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define CALL(T, D)                                                        \
  launch_dq<T, D>(q, k, v, kv_mask, dout, lse, delta, dq, B, H, Tq, Tk, \
                  scale, causal, s)
  FLASH_DISPATCH(CALL)
#undef CALL
}

extern "C" int flash_attention_dkv(const void* q, const void* k,
                                   const void* v, const void* kv_mask,
                                   const void* dout, const void* lse,
                                   const void* delta, void* dk, void* dv,
                                   int B, int H, int Tq, int Tk, int Dh,
                                   float scale, int causal, int dtype,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define CALL(T, D)                                                            \
  launch_dkv<T, D>(q, k, v, kv_mask, dout, lse, delta, dk, dv, B, H, Tq, Tk, \
                   scale, causal, s)
  FLASH_DISPATCH(CALL)
#undef CALL
}
