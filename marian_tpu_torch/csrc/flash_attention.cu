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
// The TPU grids become the block grids: the forward and dq run one block
// per (batch, head, 64-query tile) looping over 64-key tiles, dkv one
// block per (batch, head, 64-key tile) looping over 64-query tiles, so
// every output element has one writer: no atomics, and the result does
// not depend on the order in which blocks run. The TPU's padding of Tq
// and Tk to block multiples is not carried over: keys past Tk are left
// out of the softmax and query rows past Tq are neither written nor
// summed into dk/dv, so a fully masked row averages V over the Tk real
// keys (the dense path's answer). Causal: a query tile skips the key
// tiles wholly in its future only when every row of the tile sees a live
// key (the batch row's first live key lies at or before the tile's first
// query); those keys then weigh exp(-1e9 - max) = 0 exactly, and all
// three kernels skip the same (query tile, key tile) pairs.
//
// What bounds it on an H100: operations. Per (batch, head) the forward
// does 4*Tq*Tk*Dh flops (the scores and the V product) on 4*T*Dh elements,
// dq 6*Tq*Tk*Dh (scores, dO.V^T, ds.K) and dkv 8*Tq*Tk*Dh (scores, dO.V^T,
// p^T.dO, ds^T.Q): at T = 2048, Dh = 64 that is some 500 flops a byte, far
// past the f32 balance point of the CUDA cores (~20), and causal halves
// it. This first version runs on the f32 CUDA cores (no tensor cores: the
// port trains in f32 with TF32 off). The design keeps every product in
// shared memory: the block stages its fixed tile (Q, or K and V) once and
// streams the other operand tile by tile, each [64][Dh+1] f32 (the +1
// keeps the sixteen rows a warp reads on distinct banks), the score tile
// never leaves the block, and every product is a 64 x 64 or 64 x Dh
// register-tiled loop: 256 threads as 16 x 16, each owning rows
// ty + 16i and columns tx + 16j, so the sixteen threads of a half-warp
// share a row and reduce the softmax statistics with four shuffles.
//
// Shared memory per block (floats, SD = Dh + 1):
//   forward 3*64*SD + 64*65 + 64        (66.8 KB at Dh 64, 116 KB at 128)
//   dq      4*64*SD + 64*65 + 3*64      (84 KB at Dh 64, 149 KB at 128)
//   dkv     4*64*SD + 2*64*65 + 3*64    (101 KB at Dh 64, 166 KB at 128)
// each above 48 KB, so every launch raises the dynamic limit first.

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

// ---------------------------------------------------------------------------
// dq: grid (query tiles, B*H)

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ kv_mask, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int H, int Tq, int Tk, float scale, int causal) {
  constexpr int SD = DH + 1, NF = DH / 16;
  extern __shared__ float smem[];
  float* qs = smem;                 // [64][SD]
  float* dos = qs + kTile * SD;     // [64][SD]
  float* ks = dos + kTile * SD;     // [64][SD]
  float* vs = ks + kTile * SD;      // [64][SD]
  float* ds_t = vs + kTile * SD;    // [64][65] ds of the tile
  float* bias = ds_t + kTile * kPS; // [64]
  float* lse_s = bias + kTile;      // [64]
  float* dl_s = lse_s + kTile;      // [64]
  __shared__ int first_slot;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, b = bh / H, q0 = blockIdx.x * kTile;
  const float* kvm = kv_mask + (size_t)b * Tk;
  const int first = first_live_key(kvm, Tk, causal, &first_slot);
  stage<T, DH>(q + (size_t)bh * Tq * DH, q0, Tq, qs);
  stage<T, DH>(dout + (size_t)bh * Tq * DH, q0, Tq, dos);
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const bool in = q0 + r < Tq;
    lse_s[r] = in ? lse[(size_t)bh * Tq + q0 + r] : 0.f;
    dl_s[r] = in ? delta[(size_t)bh * Tq + q0 + r] : 0.f;
  }

  float acc[4][NF];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int f = 0; f < NF; ++f) acc[i][f] = 0.f;
  int n_k = (Tk + kTile - 1) / kTile;
  if (causal && q0 >= first) n_k = min(n_k, q0 / kTile + 1);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    stage<T, DH>(k + (size_t)bh * Tk * DH, k0, Tk, ks);
    stage<T, DH>(v + (size_t)bh * Tk * DH, k0, Tk, vs);
    stage_bias(kvm, k0, Tk, bias);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<DH>(qs, ks, s);
    dot_tile<DH>(dos, vs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, col = k0 + c;
        float x = s[i][j] * scale + bias[c];
        if (causal && row < col) x = kMask;
        const float p =
            row < Tq && col < Tk ? expf(x - lse_s[r]) : 0.f;
        ds_t[r * kPS + c] = p * (dp[i][j] - dl_s[r]) * scale;
      }
    }
    __syncthreads();
    apply_tile<DH>(ds_t, ks, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
#pragma unroll
    for (int f = 0; f < NF; ++f)
      dq[((size_t)bh * Tq + row) * DH + tx + 16 * f] = from_f32<T>(acc[i][f]);
  }
}

// ---------------------------------------------------------------------------
// dkv: grid (key tiles, B*H); the score tile is held transposed, keys in
// the rows, so that p^T and ds^T feed the two products directly

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ kv_mask, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int H, int Tq, int Tk,
    float scale, int causal) {
  constexpr int SD = DH + 1, NF = DH / 16;
  extern __shared__ float smem[];
  float* ks = smem;                 // [64][SD]
  float* vs = ks + kTile * SD;      // [64][SD]
  float* qs = vs + kTile * SD;      // [64][SD]
  float* dos = qs + kTile * SD;     // [64][SD]
  float* pt = dos + kTile * SD;     // [64 keys][65] p^T
  float* dst = pt + kTile * kPS;    // [64 keys][65] ds^T
  float* bias = dst + kTile * kPS;  // [64]
  float* lse_s = bias + kTile;      // [64]
  float* dl_s = lse_s + kTile;      // [64]
  __shared__ int first_slot;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, b = bh / H, kt = blockIdx.x, k0 = kt * kTile;
  const float* kvm = kv_mask + (size_t)b * Tk;
  const int first = first_live_key(kvm, Tk, causal, &first_slot);
  stage<T, DH>(k + (size_t)bh * Tk * DH, k0, Tk, ks);
  stage<T, DH>(v + (size_t)bh * Tk * DH, k0, Tk, vs);
  stage_bias(kvm, k0, Tk, bias);

  float dk_acc[4][NF], dv_acc[4][NF];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int f = 0; f < NF; ++f) dk_acc[i][f] = dv_acc[i][f] = 0.f;
  const int n_q = (Tq + kTile - 1) / kTile;
  for (int qt = 0; qt < n_q; ++qt) {
    const int q0 = qt * kTile;
    // the forward's skip: this key tile lies wholly in the future of a
    // query tile whose rows all see a live key
    if (causal && qt < kt && q0 >= first) continue;
    __syncthreads();
    stage<T, DH>(q + (size_t)bh * Tq * DH, q0, Tq, qs);
    stage<T, DH>(dout + (size_t)bh * Tq * DH, q0, Tq, dos);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const bool in = q0 + r < Tq;
      lse_s[r] = in ? lse[(size_t)bh * Tq + q0 + r] : 0.f;
      dl_s[r] = in ? delta[(size_t)bh * Tq + q0 + r] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<DH>(ks, qs, s);     // s[key][query] = k.q, the forward's sum
    dot_tile<DH>(vs, dos, dp);   // dp[key][query] = v.dO
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, key = k0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, row = q0 + c;
        float x = s[i][j] * scale + bias[r];
        if (causal && row < key) x = kMask;
        const float p = row < Tq && key < Tk ? expf(x - lse_s[c]) : 0.f;
        pt[r * kPS + c] = p;
        dst[r * kPS + c] = p * (dp[i][j] - dl_s[c]) * scale;
      }
    }
    __syncthreads();
    apply_tile<DH>(pt, dos, dv_acc);
    apply_tile<DH>(dst, qs, dk_acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Tk) continue;
    const size_t at = ((size_t)bh * Tk + key) * DH;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      dk[at + tx + 16 * f] = from_f32<T>(dk_acc[i][f]);
      dv[at + tx + 16 * f] = from_f32<T>(dv_acc[i][f]);
    }
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

template <typename T, int DH>
int launch_dq(const void* q, const void* k, const void* v, const void* kvm,
              const void* dout, const void* lse, const void* delta, void* dq,
              int B, int H, int Tq, int Tk, float scale, int causal,
              cudaStream_t stream) {
  const size_t smem =
      (4 * kTile * (DH + 1) + kTile * kPS + 3 * kTile) * sizeof(float);
  auto kern = flash_dq_kernel<T, DH>;
  if (int e = prepare(kern, smem, B, H)) return e;
  const dim3 grid((Tq + kTile - 1) / kTile, B * H);
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
  const size_t smem =
      (4 * kTile * (DH + 1) + 2 * kTile * kPS + 3 * kTile) * sizeof(float);
  auto kern = flash_dkv_kernel<T, DH>;
  if (int e = prepare(kern, smem, B, H)) return e;
  const dim3 grid((Tk + kTile - 1) / kTile, B * H);
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
