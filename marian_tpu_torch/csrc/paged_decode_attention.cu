// Paged decode attention: the attention read of one decode step over a
// paged KV pool.
//
// Replaces the TPU kernel marian_tpu/ops/pallas/kv_pool.py ::
// paged_decode_attention (body _kernel). Per (row r, head h): the row's
// positions 0 .. MP*page_len-1 live in the pages page_table[r, p]; return
// softmax(scale * q.K^T) V with every position past row_pos[r] REPLACED
// by -1e9, computed in f32, written in q's dtype. The new token's K/V
// were inserted into the pools by the wrapper (pool_insert, same stream)
// before this launch; the kernel only reads the pools.
//
// What bounds it on an H100: bytes. Per (row, head) it reads the live
// positions' K and V once, 2*n*Dh elements, against 4*n*Dh flops: one
// flop per byte in f32, far below the card's ratio (chip_smoke.py
// computes both bounds per run; PERF.md has them). The design streams
// each row's positions once, in chunks of kChunk positions through
// shared memory, with online softmax stats (running max and sum, the
// output rescaled when the max moves), as decode_attention.cu does: no
// length cap, (2*kChunk*(Dh+1) + Dh + kChunk + 32) floats of shared
// memory plus kChunk 8-byte offsets whatever MP*page_len is (34 KB at
// Dh 64; above 48 KB, at Dh > 92, the launch raises the dynamic
// limit). Pages are not
// contiguous and not in order, so before each chunk the block resolves
// every position's pool offset once through the page table; within a
// page the (page, head) tile of page_len*Dh elements is contiguous, so
// the loads are coalesced.
//
// An active row (row_pos >= 0) stops after position min(row_pos,
// MP*page_len-1): every later position would get exp(-1e9 - m) = 0
// exactly in f32, so skipping them changes nothing but the work. An
// idle row (row_pos < 0) has every position masked; the reference then
// averages V over all MP*page_len positions (the dense answer), and so
// does this kernel: it reads the whole table, no early exit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 64;   // positions staged per pass (<= kThreads)
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
__global__ void __launch_bounds__(kThreads) paged_decode_attention_kernel(
    const TQ* __restrict__ q, const TC* __restrict__ pool_k,
    const TC* __restrict__ pool_v, const int* __restrict__ page_table,
    const int* __restrict__ row_pos, TQ* __restrict__ out, int H,
    int page_len, int Dh, int MP, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = Dh + 1;
  // [kChunk] element offset of each staged position's (page, head) row
  size_t* base = reinterpret_cast<size_t*>(smem);
  float* ks = reinterpret_cast<float*>(base + kChunk);  // [kChunk][Dh+1]
  float* vs = ks + kChunk * stride;   // [kChunk][Dh+1] values
  float* qs = vs + kChunk * stride;   // [Dh]
  float* ps = qs + Dh;                // [kChunk] scores, then exp(s - m)
  float* red = ps + kChunk;           // [32] reduction scratch

  const int r = blockIdx.x, h = blockIdx.y;
  const int p = row_pos[r];
  const int span = MP * page_len;
  const int n_pos = p < 0 ? span : min(p + 1, span);
  const int* table = page_table + (size_t)r * MP;
  const size_t vec = ((size_t)r * H + h) * Dh;

  for (int d = threadIdx.x; d < Dh; d += blockDim.x) qs[d] = to_f32(q[vec + d]);
  // online softmax over the chunks: running max m and sum l (the same in
  // every thread), and thread t's output features t and t + kThreads
  float m = -INFINITY, l = 0.f, acc[kFeat];
#pragma unroll
  for (int f = 0; f < kFeat; ++f) acc[f] = 0.f;

  for (int c0 = 0; c0 < n_pos; c0 += kChunk) {
    const int n = min(kChunk, n_pos - c0);
    __syncthreads();  // the previous chunk's readers are done
    if (threadIdx.x < n) {
      const int j = c0 + threadIdx.x;
      const int page = table[j / page_len];
      base[threadIdx.x] =
          (((size_t)page * H + h) * page_len + j % page_len) * Dh;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n * Dh; i += blockDim.x) {
      const int jj = i / Dh, d = i - jj * Dh;
      const size_t at = base[jj] + d;
      ks[jj * stride + d] = to_f32(pool_k[at]);
      vs[jj * stride + d] = to_f32(pool_v[at]);
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
int launch(const void* q, const void* pool_k, const void* pool_v,
           const void* page_table, const void* row_pos, void* out, int R,
           int H, int page_len, int Dh, int MP, float scale,
           cudaStream_t stream) {
  if (Dh > kFeat * kThreads || page_len < 1 || MP < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (2 * (size_t)kChunk * (Dh + 1) + Dh + kChunk + 32) * sizeof(float) +
      kChunk * sizeof(size_t);
  auto kern = paged_decode_attention_kernel<TQ, TC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(R, H), kThreads, smem, stream>>>(
      (const TQ*)q, (const TC*)pool_k, (const TC*)pool_v,
      (const int*)page_table, (const int*)row_pos, (TQ*)out, H, page_len,
      Dh, MP, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int paged_decode_attention(const void* q, const void* pool_k,
                                      const void* pool_v,
                                      const void* page_table,
                                      const void* row_pos, void* out, int R,
                                      int H, int page_len, int Dh, int MP,
                                      float scale, int q_dtype,
                                      int pool_dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == 0 && pool_dtype == 0)
    return launch<float, float>(q, pool_k, pool_v, page_table, row_pos, out,
                                R, H, page_len, Dh, MP, scale, s);
  if (q_dtype == 0 && pool_dtype == 1)
    return launch<float, __nv_bfloat16>(q, pool_k, pool_v, page_table,
                                        row_pos, out, R, H, page_len, Dh, MP,
                                        scale, s);
  if (q_dtype == 1 && pool_dtype == 0)
    return launch<__nv_bfloat16, float>(q, pool_k, pool_v, page_table,
                                        row_pos, out, R, H, page_len, Dh, MP,
                                        scale, s);
  if (q_dtype == 1 && pool_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, pool_k, pool_v, page_table, row_pos, out, R, H, page_len, Dh, MP,
        scale, s);
  return (int)cudaErrorInvalidValue;
}
