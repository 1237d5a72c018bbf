// Fused beam-gather + cache-update + attention read for one decode step.
//
// Replaces the TPU kernel marian_tpu/ops/pallas/decode_attention.py ::
// decode_attention (body _kernel). Per (row r, head h):
//   - read the [L, Dh] cache tile of the SOURCE row src_rows[r] (the beam
//     backpointer gather, folded into the read),
//   - insert this step's k/v at pos[r] (cast to the cache dtype),
//   - write the reordered, updated tile once to the OUTPUT caches,
//   - return softmax(scale * q.K^T) V over positions <= pos[r]; later
//     positions are REPLACED by -1e9. Compute is f32.
//
// What bounds it on an H100: bytes. Per call it reads the source rows of
// both caches and writes both caches whole, 4*R*H*L*Dh elements at most,
// against 4*L*Dh flops per (r, h): at the decoder's shapes the bytes take
// tens of times longer than the arithmetic at the f32 rate (chip_smoke.py
// computes both bounds per run; PERF.md has them). The design answers
// that with one pass over the cache bytes: each block streams its tile
// from device memory once, coalesced, in chunks of kChunk positions,
// writes each chunk straight back out, and does all further work (scores,
// softmax, the V product) on the copy it staged in shared memory. The
// softmax is online across chunks (running max and sum per (row, head),
// the output rescaled when the max moves), so no cache is too long for
// the block: its shared memory is (2*kChunk*(Dh+1) + Dh + kChunk + 32)
// floats whatever L is (34 KB at Dh 64; above 48 KB, at Dh > 88, the
// launch raises the dynamic limit with cudaFuncSetAttribute). The chunk
// rows are padded to Dh+1 floats so the per-key dot products read shared
// memory without bank conflicts.
//
// The output caches must be other buffers than the input caches:
// src_rows is an arbitrary map with repeats, so writing in place would
// let one block overwrite a row another block has yet to read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 64;   // cache positions staged per pass (<= kThreads)
constexpr int kFeat = 2;     // output features per thread: Dh <= 256
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

// block-wide reductions through `red` (one float per warp)
__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : -INFINITY;
    v = warp_max(v);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  v = red[0];
  __syncthreads();
  return v;
}

__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  v = red[0];
  __syncthreads();
  return v;
}

template <typename TQ, typename TC>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const TQ* __restrict__ q, const TQ* __restrict__ k_new,
    const TQ* __restrict__ v_new, const TC* __restrict__ cache_k,
    const TC* __restrict__ cache_v, const int* __restrict__ pos,
    const int* __restrict__ src_rows, TQ* __restrict__ out,
    TC* __restrict__ new_k, TC* __restrict__ new_v, int H, int L, int Dh,
    float scale) {
  extern __shared__ float smem[];
  const int stride = Dh + 1;
  float* ks = smem;                   // [kChunk][Dh+1] keys of this chunk
  float* vs = ks + kChunk * stride;   // [kChunk][Dh+1] values
  float* qs = vs + kChunk * stride;   // [Dh]
  float* ps = qs + Dh;                // [kChunk] scores, then exp(s - m)
  float* red = ps + kChunk;           // [32] reduction scratch

  const int r = blockIdx.x, h = blockIdx.y;
  const int p = pos[r];
  // the insert index clamps like dynamic_update_slice; the mask uses p
  const int ins = min(max(p, 0), L - 1);
  const size_t tile = (size_t)L * Dh;
  const size_t in_tile = ((size_t)src_rows[r] * H + h) * tile;
  const size_t out_tile = ((size_t)r * H + h) * tile;
  const size_t vec = ((size_t)r * H + h) * Dh;

  for (int d = threadIdx.x; d < Dh; d += blockDim.x) qs[d] = to_f32(q[vec + d]);
  // online softmax over the chunks: running max m and sum l (the same in
  // every thread), and thread t's output features t and t + kThreads
  float m = -INFINITY, l = 0.f, acc[kFeat];
#pragma unroll
  for (int f = 0; f < kFeat; ++f) acc[f] = 0.f;

  for (int c0 = 0; c0 < L; c0 += kChunk) {
    const int n = min(kChunk, L - c0);
    __syncthreads();  // the previous chunk's readers are done
    // one coalesced pass over the chunk: gather, insert, write out, stage
    for (int i = threadIdx.x; i < n * Dh; i += blockDim.x) {
      const int jj = i / Dh, d = i - jj * Dh, j = c0 + jj;
      const size_t at = (size_t)c0 * Dh + i;
      TC kc, vc;
      if (j == ins) {
        kc = from_f32<TC>(to_f32(k_new[vec + d]));
        vc = from_f32<TC>(to_f32(v_new[vec + d]));
      } else {
        kc = cache_k[in_tile + at];
        vc = cache_v[in_tile + at];
      }
      new_k[out_tile + at] = kc;
      new_v[out_tile + at] = vc;
      ks[jj * stride + d] = to_f32(kc);
      vs[jj * stride + d] = to_f32(vc);
    }
    __syncthreads();

    // scores: one key per thread
    float cm = -INFINITY, s = 0.f;
    if (threadIdx.x < n) {
      const float* kr = ks + threadIdx.x * stride;
      for (int d = 0; d < Dh; ++d) s = fmaf(qs[d], kr[d], s);
      s = c0 + (int)threadIdx.x <= p ? s * scale : kMask;
      cm = s;
    }
    const float m_new = fmaxf(m, block_max(cm, red));
    const float alpha = expf(m - m_new);  // 0 on the first chunk
    float e = 0.f;
    if (threadIdx.x < n) {
      e = expf(s - m_new);
      ps[threadIdx.x] = e;
    }
    l = l * alpha + block_sum(e, red);  // its barrier publishes ps
    m = m_new;

    // context: output features per thread, this chunk's keys in order
#pragma unroll
    for (int f = 0; f < kFeat; ++f) {
      const int d = threadIdx.x + f * kThreads;
      if (d < Dh) {
        float o = acc[f] * alpha;
        for (int j = 0; j < n; ++j) o = fmaf(ps[j], vs[j * stride + d], o);
        acc[f] = o;
      }
    }
  }
  // l >= 1: the row max contributes exp(0)
#pragma unroll
  for (int f = 0; f < kFeat; ++f) {
    const int d = threadIdx.x + f * kThreads;
    if (d < Dh) out[vec + d] = from_f32<TQ>(acc[f] / l);
  }
}

template <typename TQ, typename TC>
int launch(const void* q, const void* k_new, const void* v_new,
           const void* cache_k, const void* cache_v, const void* pos,
           const void* src_rows, void* out, void* new_k, void* new_v, int R,
           int H, int L, int Dh, float scale, cudaStream_t stream) {
  if (Dh > kFeat * kThreads) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (2 * (size_t)kChunk * (Dh + 1) + Dh + kChunk + 32) * sizeof(float);
  auto kern = decode_attention_kernel<TQ, TC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(R, H), kThreads, smem, stream>>>(
      (const TQ*)q, (const TQ*)k_new, (const TQ*)v_new, (const TC*)cache_k,
      (const TC*)cache_v, (const int*)pos, (const int*)src_rows, (TQ*)out,
      (TC*)new_k, (TC*)new_v, H, L, Dh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int decode_attention(const void* q, const void* k_new,
                                const void* v_new, const void* cache_k,
                                const void* cache_v, const void* pos,
                                const void* src_rows, void* out, void* new_k,
                                void* new_v, int R, int H, int L, int Dh,
                                float scale, int q_dtype, int cache_dtype,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == 0 && cache_dtype == 0)
    return launch<float, float>(q, k_new, v_new, cache_k, cache_v, pos,
                                src_rows, out, new_k, new_v, R, H, L, Dh,
                                scale, s);
  if (q_dtype == 0 && cache_dtype == 1)
    return launch<float, __nv_bfloat16>(q, k_new, v_new, cache_k, cache_v,
                                        pos, src_rows, out, new_k, new_v, R,
                                        H, L, Dh, scale, s);
  if (q_dtype == 1 && cache_dtype == 0)
    return launch<__nv_bfloat16, float>(q, k_new, v_new, cache_k, cache_v,
                                        pos, src_rows, out, new_k, new_v, R,
                                        H, L, Dh, scale, s);
  if (q_dtype == 1 && cache_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_new, v_new, cache_k, cache_v, pos, src_rows, out, new_k, new_v,
        R, H, L, Dh, scale, s);
  return (int)cudaErrorInvalidValue;
}
