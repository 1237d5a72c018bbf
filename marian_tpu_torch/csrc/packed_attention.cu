// Short-sequence attention, softmax(scale*Q.K^T + mask) V: the forward
// here, its backward further down.
//
// The forward replaces the TPU kernel marian_tpu/ops/pallas/packed_attention.py ::
// packed_attention (forward body _fwd_kernel, called from _fwd_call).
// The TPU kernel packs 128//Dh heads block-diagonally and pads sequences
// to 64 only to fill its 128x128 matrix unit; neither carries over.
// Semantics kept exactly:
//   s = (q.k) * scale + (1 - kv_mask[k]) * -1e9      (scale AFTER the dot)
//   causal: positions k > q are REPLACED by -1e9
//   p = exp(s - max) / sum                            (no zero guard)
// so a fully-masked row comes out uniform, here over the Tk real keys
// (the TPU kernel's padding to 64 adds zero keys to that average; rows
// that are not fully masked are unaffected by the padding).
//
// What bounds it on an H100: bytes. It moves 4*B*H*T*Dh elements (q, k,
// v, out) for 4*B*H*T*T*Dh flops, so at NMT sentence lengths (T of a few
// dozen) the bytes take longer than the arithmetic at the f32 rate
// (chip_smoke.py computes both bounds per run; PERF.md has them). The
// design reads each input once: a block owns one (batch, head) and a
// tile of query rows, stages that head's K and V in shared memory (rows
// padded to Dh+1 floats, so lanes walking different keys hit different
// banks), and each warp takes one query row at a time: lanes split the
// keys for the scores and the softmax (warp shuffles for max and sum),
// then split the features for the V product. Scores never leave shared
// memory.
//
// Shared memory is (2*Tk*(Dh+1) + Tk + warps*(Dh+Tk)) floats per block,
// which sets the port's length cap (ops/kernels/packed_attention.py ::
// max_t, from the 227 KB a Hopper block may use).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 16;
constexpr float kMask = -1e9f;

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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) packed_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ kv_mask,
    T* __restrict__ out, int H, int Tq, int Tk, int Dh, float scale,
    int causal) {
  extern __shared__ float smem[];
  const int stride = Dh + 1;
  float* ks = smem;               // [Tk][Dh+1]
  float* vs = ks + Tk * stride;   // [Tk][Dh+1]
  float* bias = vs + Tk * stride; // [Tk] additive key mask
  float* qw = bias + Tk;          // [kWarps][Dh] one query row per warp
  float* pw = qw + kWarps * Dh;   // [kWarps][Tk] its scores/probabilities

  const int bh = blockIdx.x, b = bh / H;
  const size_t kbase = (size_t)bh * Tk * Dh;
  const size_t qbase = (size_t)bh * Tq * Dh;
  for (int i = threadIdx.x; i < Tk * Dh; i += blockDim.x) {
    const int j = i / Dh, d = i - j * Dh;
    ks[j * stride + d] = to_f32(k[kbase + i]);
    vs[j * stride + d] = to_f32(v[kbase + i]);
  }
  for (int j = threadIdx.x; j < Tk; j += blockDim.x)
    bias[j] = (1.f - kv_mask[(size_t)b * Tk + j]) * kMask;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* qr = qw + warp * Dh;
  float* pr = pw + warp * Tk;
  const int row_end = min(Tq, (int)(blockIdx.y + 1) * kRowsPerBlock);
  for (int i = blockIdx.y * kRowsPerBlock + warp; i < row_end; i += kWarps) {
    for (int d = lane; d < Dh; d += 32) qr[d] = to_f32(q[qbase + (size_t)i * Dh + d]);
    __syncwarp();
    float m = -INFINITY;
    for (int j = lane; j < Tk; j += 32) {
      float s = 0.f;
      const float* kr = ks + j * stride;
      for (int d = 0; d < Dh; ++d) s = fmaf(qr[d], kr[d], s);
      s = s * scale + bias[j];
      if (causal && j > i) s = kMask;
      pr[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < Tk; j += 32) {
      const float e = expf(pr[j] - m);
      pr[j] = e;
      l += e;
    }
    l = warp_sum(l);  // >= 1: the row max contributes exp(0)
    for (int j = lane; j < Tk; j += 32) pr[j] = pr[j] / l;
    __syncwarp();
    for (int d = lane; d < Dh; d += 32) {
      float o = 0.f;
      for (int j = 0; j < Tk; ++j) o = fmaf(pr[j], vs[j * stride + d], o);
      out[qbase + (size_t)i * Dh + d] = from_f32<T>(o);
    }
    __syncwarp();
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* kv_mask,
           void* out, int B, int H, int Tq, int Tk, int Dh, float scale,
           int causal, cudaStream_t stream) {
  const size_t smem =
      (2 * (size_t)Tk * (Dh + 1) + Tk + kWarps * (size_t)(Dh + Tk)) *
      sizeof(float);
  auto kern = packed_attention_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B * H, (Tq + kRowsPerBlock - 1) / kRowsPerBlock);
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)kv_mask, (T*)out,
      H, Tq, Tk, Dh, scale, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward: dq, dk, dv from the recomputed probabilities.
//
// Replaces marian_tpu/ops/pallas/packed_attention.py :: _bwd_kernel (called
// from _bwd_call). As there, the probabilities are recomputed, not saved,
// and delta = rowsum(dO * out) arrives from outside the kernel:
//   dP = dO V^T,  dS = P * (dP - delta) * scale,
//   dQ = dS K,    dK = dS^T Q,    dV = P^T dO.
// A block owns one (batch, head) and produces its dq, dk and dv together,
// so no two blocks write the same output and no atomics are needed (the
// TPU grid (b, h//g) did the same per head group). Q, dO, K, V are staged
// as [T][Dh+1] f32 tiles and P (then dS, in place) as [Tq][Tk+1]; the
// five products read shared memory only, each thread computing a 4 x 4
// register tile (tile_product), and the +1 rows keep the threads of a
// warp on distinct banks.
//
// What bounds it on an H100: close to the balance point. It moves
// 7*B*H*T*Dh elements (q, k, v, dO in; dq, dk, dv out) for
// 10*B*H*Tq*Tk*Dh flops (the recomputed scores and four products): at
// T = 64, Dh = 64 the f32 flops just outweigh the bytes (chip_smoke.py
// computes both bounds per run). Shared memory is
//   (2*Tq*(Dh+1) + 2*Tk*(Dh+1) + Tq*(Tk+1) + Tk + Tq) floats,
// 83 KB at T=64, Dh=64: the backward's length cap (max_t_bwd) is lower
// than the forward's.

constexpr int kBwdThreads = 256;   // 16 x 16, a 4 x 4 micro-tile each

// C(m, n) = sum_k A(m, k) B(k, n) over shared-memory operands
// A(m, k) = A[m*am + k*ak], B(k, n) = B[k*bk + n*bn], for m < M, n < N;
// epi(m, n, value) consumes each result. The output is walked in 64 x 64
// tiles; thread (ty, tx) owns rows ty + 16i and columns tx + 16j of a
// tile, so per k it reads 4 + 4 operands (two distinct rows of A per warp,
// sixteen consecutive words of B) for 16 FMAs. Sums run k = 0, 1, ...,
// the order of a plain dot product.
template <typename Epi>
__device__ __forceinline__ void tile_product(const float* A, int am, int ak,
                                             const float* B, int bk, int bn,
                                             int M, int N, int K, Epi epi) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int m0 = 0; m0 < M; m0 += 64)
    for (int n0 = 0; n0 < N; n0 += 64) {
      int ma[4], nb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ma[i] = min(m0 + ty + 16 * i, M - 1) * am;   // clamped, discarded
        nb[i] = min(n0 + tx + 16 * i, N - 1) * bn;
      }
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = A[ma[i] + k * ak];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = B[k * bk + nb[j]];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
          if (m < M && n < N) epi(m, n, acc[i][j]);
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads) packed_attention_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ kv_mask,
    const T* __restrict__ dout, const float* __restrict__ delta,
    T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int H,
    int Tq, int Tk, int Dh, float scale, int causal) {
  extern __shared__ float smem[];
  const int stride = Dh + 1, pstride = Tk + 1;
  float* qs = smem;                  // [Tq][Dh+1]
  float* dos = qs + Tq * stride;     // [Tq][Dh+1]
  float* ks = dos + Tq * stride;     // [Tk][Dh+1]
  float* vs = ks + Tk * stride;      // [Tk][Dh+1]
  float* ps = vs + Tk * stride;      // [Tq][Tk+1] P, then dS
  float* bias = ps + Tq * pstride;   // [Tk]
  float* dl = bias + Tk;             // [Tq] delta

  const int bh = blockIdx.x, b = bh / H;
  const size_t qbase = (size_t)bh * Tq * Dh;
  const size_t kbase = (size_t)bh * Tk * Dh;
  for (int i = threadIdx.x; i < Tq * Dh; i += blockDim.x) {
    const int r = i / Dh, d = i - r * Dh;
    qs[r * stride + d] = to_f32(q[qbase + i]);
    dos[r * stride + d] = to_f32(dout[qbase + i]);
  }
  for (int i = threadIdx.x; i < Tk * Dh; i += blockDim.x) {
    const int r = i / Dh, d = i - r * Dh;
    ks[r * stride + d] = to_f32(k[kbase + i]);
    vs[r * stride + d] = to_f32(v[kbase + i]);
  }
  for (int j = threadIdx.x; j < Tk; j += blockDim.x)
    bias[j] = (1.f - kv_mask[(size_t)b * Tk + j]) * kMask;
  for (int i = threadIdx.x; i < Tq; i += blockDim.x)
    dl[i] = delta[(size_t)bh * Tq + i];
  __syncthreads();

  // scores S = Q K^T, in the forward's op order
  tile_product(qs, stride, 1, ks, 1, stride, Tq, Tk, Dh,
               [&](int i, int j, float s) {
                 s = s * scale + bias[j];
                 if (causal && j > i) s = kMask;
                 ps[i * pstride + j] = s;
               });
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = warp; i < Tq; i += nwarps) {
    float* pr = ps + i * pstride;
    float m = -INFINITY;
    for (int j = lane; j < Tk; j += 32) m = fmaxf(m, pr[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < Tk; j += 32) {
      const float e = expf(pr[j] - m);
      pr[j] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int j = lane; j < Tk; j += 32) pr[j] = pr[j] / l;
  }
  __syncthreads();
  // dV = P^T dO
  tile_product(ps, 1, pstride, dos, stride, 1, Tk, Dh, Tq,
               [&](int j, int d, float x) {
                 dv[kbase + (size_t)j * Dh + d] = from_f32<T>(x);
               });
  __syncthreads();
  // dS = P * (dO V^T - delta) * scale, in place of P (each element read
  // and written by the thread that owns it)
  tile_product(dos, stride, 1, vs, 1, stride, Tq, Tk, Dh,
               [&](int i, int j, float dp) {
                 float* p = ps + i * pstride + j;
                 *p = *p * (dp - dl[i]) * scale;
               });
  __syncthreads();
  // dQ = dS K, dK = dS^T Q
  tile_product(ps, pstride, 1, ks, stride, 1, Tq, Dh, Tk,
               [&](int i, int d, float x) {
                 dq[qbase + (size_t)i * Dh + d] = from_f32<T>(x);
               });
  tile_product(ps, 1, pstride, qs, stride, 1, Tk, Dh, Tq,
               [&](int j, int d, float x) {
                 dk[kbase + (size_t)j * Dh + d] = from_f32<T>(x);
               });
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v,
               const void* kv_mask, const void* dout, const void* delta,
               void* dq, void* dk, void* dv, int B, int H, int Tq, int Tk,
               int Dh, float scale, int causal, cudaStream_t stream) {
  const size_t smem = (2 * (size_t)Tq * (Dh + 1) + 2 * (size_t)Tk * (Dh + 1) +
                       (size_t)Tq * (Tk + 1) + Tk + Tq) *
                      sizeof(float);
  auto kern = packed_attention_bwd_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<B * H, kBwdThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)kv_mask,
      (const T*)dout, (const float*)delta, (T*)dq, (T*)dk, (T*)dv, H, Tq,
      Tk, Dh, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. kv_mask and delta are float32
// ([B, Tk] and [B, H, Tq]). Returns cudaGetLastError().
extern "C" int packed_attention_bwd(const void* q, const void* k,
                                    const void* v, const void* kv_mask,
                                    const void* dout, const void* delta,
                                    void* dq, void* dk, void* dv, int B,
                                    int H, int Tq, int Tk, int Dh,
                                    float scale, int causal, int dtype,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_bwd<float>(q, k, v, kv_mask, dout, delta, dq, dk, dv, B, H,
                             Tq, Tk, Dh, scale, causal, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(q, k, v, kv_mask, dout, delta, dq, dk,
                                     dv, B, H, Tq, Tk, Dh, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

// dtype codes: 0 = float32, 1 = bfloat16. kv_mask is float32 [B, Tk].
// Returns cudaGetLastError().
extern "C" int packed_attention(const void* q, const void* k, const void* v,
                                const void* kv_mask, void* out, int B, int H,
                                int Tq, int Tk, int Dh, float scale,
                                int causal, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, kv_mask, out, B, H, Tq, Tk, Dh, scale,
                         causal, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, kv_mask, out, B, H, Tq, Tk, Dh,
                                 scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
