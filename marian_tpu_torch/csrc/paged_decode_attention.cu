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
// computes both bounds per run; PERF.md has them). At the serve path's
// shape a block reads about 64 live positions, so the fixed cost of a
// block (the position, the table, q, the final merge) is most of its
// time: the design overlaps it with the first copies.
//
// paged_decode_attention_kernel streams a row's positions as 16-byte
// vectors (4 f32 or 8 bf16 values), the layout of decode_attention.cu:
// one block of 128 threads a (row, head), KG key groups of G lanes, F
// vectors a lane, chunks of C = (4/F)*KG positions (at most 8 KB of each
// pool; 32 positions at Dh 64 f32). A (page, head) tile of page_len*Dh
// elements is contiguous in [n_pages, H, page_len, Dh], and page_len
// divides C or C divides page_len, so a chunk is whole pages or a whole
// part of one page: each run of min(C, page_len) positions is one
// contiguous copy addressed by one table lookup. The copies are cp.async
// into S chunk buffers a pool (S = 2, or 4 where the launcher sees fewer
// than two blocks an SM), S - 1 chunks in flight while one is scored.
// The block reads the row's position and chunk 0's pages from device
// memory and issues chunk 0's copies, with the table's copy into shared
// memory, before it loads q; later chunks look their pages up in shared
// memory. One __syncthreads a chunk. Every lane computes: group g takes
// keys g, g + KG, ... of a chunk, its lanes dot their vectors with q, a
// G-lane butterfly sums the parts, and the group keeps its own running
// max, sum and accumulator, rescaled once a chunk; the groups are merged
// once at the end, in group order. Every sum runs in a fixed order, so
// two calls give the same bits.
//
// An active row (row_pos >= 0) stops after position min(row_pos,
// MP*page_len-1): every later position would get exp(-1e9 - m) = 0
// exactly in f32, so skipping them changes nothing but the work. An
// idle row (row_pos < 0) has every position masked; the reference then
// averages V over all MP*page_len positions (the dense answer), and so
// does this kernel: it scores every key -1e9 without reading K and reads
// V over the whole table.
//
// A row that is not a whole number of 16-byte vectors (Dh % 4 in f32,
// Dh % 8 in bf16), pools that are not 16-byte aligned, or a page_len
// that neither divides nor is divided by C go to
// paged_decode_attention_scalar_kernel instead, by the launcher's choice
// on the shapes (ops/kernels/kv_pool.py :: paged_route): the former
// design, 4-byte loads through a 64-position shared-memory chunk whose
// pool offsets are resolved through the table before each pass, with an
// online softmax over the block.

#include "attention_tiles.cuh"

namespace {

using attn::cp_async16;
using attn::cp_async4;
using attn::cp_async_commit;
using attn::cp_async_wait;
using attn::cp_async_wait_all;
using attn::from_f32;
using attn::group_sum;
using attn::kMask;
using attn::to_f32;
using attn::Vec16;

constexpr int kVecThreads = 128;

// grid (R, H): one block streams the live positions of a (row, head)
template <typename TQ, typename TC, int G, int F, int S>
__global__ void __launch_bounds__(kVecThreads) paged_decode_attention_kernel(
    const TQ* __restrict__ q, const TC* __restrict__ pool_k,
    const TC* __restrict__ pool_v, const int* __restrict__ page_table,
    const int* __restrict__ row_pos, TQ* __restrict__ out, int H,
    int page_len, int Dh, int MP, float scale) {
  using V = Vec16<TC>;
  constexpr int E = V::E;                  // values of a vector
  constexpr int KG = kVecThreads / G;      // key groups
  constexpr int U = 4 / F;                 // keys a group takes a chunk
  constexpr int C = U * KG;                // positions of a chunk
  const int NV = Dh / E;                   // vectors of a row
  const int CV = C * NV;                   // vectors of a chunk of a pool
  extern __shared__ uint4 smem[];          // S x {K, V} chunks, the table
  int* tbl = reinterpret_cast<int*>(smem + 2 * S * CV);

  const int r = blockIdx.x, h = blockIdx.y;
  const int* table = page_table + (size_t)r * MP;
  const int p = row_pos[r];
  const int span = MP * page_len;
  const bool none_live = p < 0;
  const int live_end = none_live ? span : min(p, span - 1) + 1;  // keys read
  const int n_chunks = (live_end + C - 1) / C;
  const int run = min(C, page_len);        // positions of a chunk on a page
  const int run_v = run * NV;
  const size_t page_elems = (size_t)H * page_len * Dh;
  const size_t head_at = (size_t)h * page_len * Dh;
  const size_t vec = ((size_t)r * H + h) * Dh;

  // the table into shared memory, landed with chunk 0
  for (int i = threadIdx.x; i < MP; i += kVecThreads)
    cp_async4(reinterpret_cast<float*>(tbl + i),
              reinterpret_cast<const float*>(table + i), true);
  // chunk c into buffer c % S, 16 bytes a copy, each run's page looked up
  // in `pages` (the table in device memory until its copy has landed);
  // positions past the live ones are zero-filled, not read, and K is not
  // read for an idle row. The caller commits.
  auto load = [&](int c, const int* pages) {
    uint4* dk = smem + 2 * (c % S) * CV;
    uint4* dv = dk + CV;
    for (int j0 = 0, at = c * C; j0 < C && at < span; j0 += run, at += run) {
      const int pi = at / page_len;
      const size_t src = (size_t)pages[pi] * page_elems + head_at +
                         (size_t)(at - pi * page_len) * Dh;
      const uint4* sk = reinterpret_cast<const uint4*>(pool_k + src);
      const uint4* sv = reinterpret_cast<const uint4*>(pool_v + src);
      const bool live = at < live_end;
      for (int i = threadIdx.x; i < run_v; i += kVecThreads) {
        cp_async16(reinterpret_cast<float*>(dk + j0 * NV + i), sk + i,
                   live && !none_live);
        cp_async16(reinterpret_cast<float*>(dv + j0 * NV + i), sv + i, live);
      }
    }
  };
  load(0, table);  // every row reads position 0
  cp_async_commit();
#pragma unroll
  for (int c = 1; c < S - 1; ++c) {
    if (c < n_chunks) load(c, table);
    cp_async_commit();
  }

  const int g = threadIdx.x / G, t = threadIdx.x % G;
  // this lane's vectors t + G*f of q, and of the accumulator
  float qf[F][E], acc[F][E];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int vi = t + G * f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qf[f][e] = vi < NV ? to_f32(q[vec + vi * E + e]) : 0.f;
      acc[f][e] = 0.f;
    }
  }
  float m = -INFINITY, l = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<S - 2>();
    __syncthreads();  // chunk c (with chunk 0, the table) landed; chunk
                      // c - 1's readers are done with its buffer
    if (c + S - 1 < n_chunks) load(c + S - 1, tbl);
    cp_async_commit();
    const uint4* ks = smem + 2 * (c % S) * CV;
    const uint4* vs = ks + CV;
    const int c0 = c * C;
    const int keys = min(C, live_end - c0);  // the same in every thread
    float s[U], mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = g + u * KG;
      const bool in = j < keys;
      float x = kMask;
      if (!none_live) {
        x = 0.f;
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const int vi = t + G * f;
          if (in && vi < NV) {
            float kv[E];
            V::unpack(ks[j * NV + vi], kv);
#pragma unroll
            for (int e = 0; e < E; ++e) x = fmaf(qf[f][e], kv[e], x);
          }
        }
        x = group_sum<G>(x) * scale;
      }
      s[u] = in ? x : -INFINITY;
      mx = fmaxf(mx, s[u]);
    }
    if (mx == -INFINITY) continue;  // no key of this chunk is the group's
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);  // 0 on the group's first keys
    float w[U], sum = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      w[u] = expf(s[u] - m_new);
      sum += w[u];
    }
    l = l * alpha + sum;
#pragma unroll
    for (int f = 0; f < F; ++f)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[f][e] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = g + u * KG;
      if (j >= keys) continue;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const int vi = t + G * f;
        if (vi < NV) {
          float vv[E];
          V::unpack(vs[j * NV + vi], vv);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[f][e] = fmaf(w[u], vv[e], acc[f][e]);
        }
      }
    }
    m = m_new;
  }

  // the groups, merged in group order through the (now idle) buffers
  cp_async_wait_all();
  __syncthreads();
  float* gm = reinterpret_cast<float*>(smem);  // [KG] max
  float* gl = gm + KG;                          // [KG] sum
  float* ga = gl + KG;                          // [KG][Dh] accumulator
  if (t == 0) {
    gm[g] = m;
    gl[g] = l;
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int vi = t + G * f;
    if (vi < NV)
#pragma unroll
      for (int e = 0; e < E; ++e) ga[g * Dh + vi * E + e] = acc[f][e];
  }
  __syncthreads();
  float mm = -INFINITY;
#pragma unroll
  for (int i = 0; i < KG; ++i) mm = fmaxf(mm, gm[i]);
  // position 0 is always scored, so mm is finite; a group with no scored
  // key has gm = -inf and weighs 0
  float w[KG], sum = 0.f;
#pragma unroll
  for (int i = 0; i < KG; ++i) {
    w[i] = expf(gm[i] - mm);
    sum = fmaf(w[i], gl[i], sum);
  }
  for (int d = threadIdx.x; d < Dh; d += kVecThreads) {
    float o = 0.f;
#pragma unroll
    for (int i = 0; i < KG; ++i) o = fmaf(w[i], ga[i * Dh + d], o);
    // sum >= 1: the group holding the max contributes exp(0) * (l >= 1)
    out[vec + d] = from_f32<TQ>(o / sum);
  }
}

template <typename TQ, typename TC, int G, int F, int S>
int launch_vec(const void* q, const void* pool_k, const void* pool_v,
               const void* page_table, const void* row_pos, void* out, int R,
               int H, int page_len, int Dh, int MP, float scale,
               cudaStream_t stream) {
  constexpr int C = (4 / F) * (kVecThreads / G);
  if (C % page_len != 0 && page_len % C != 0)
    return (int)cudaErrorInvalidValue;
  const int NV = Dh / Vec16<TC>::E;
  const size_t smem =
      2 * S * (size_t)C * NV * sizeof(uint4) + (size_t)MP * sizeof(int);
  if (smem > attn::kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = paged_decode_attention_kernel<TQ, TC, G, F, S>;
  if (smem > 48 * 1024) {
    static const int raised = attn::set_smem(kern, attn::kMaxSmem);
    if (raised) return raised;
  }
  kern<<<dim3(R, H), kVecThreads, smem, stream>>>(
      (const TQ*)q, (const TC*)pool_k, (const TC*)pool_v,
      (const int*)page_table, (const int*)row_pos, (TQ*)out, H, page_len,
      Dh, MP, scale);
  return (int)cudaGetLastError();
}

// the (lanes, vectors a lane) pairs and the stage counts the vector
// kernel is built for; a layout must hold the row's vectors (G * F >= NV)
template <typename TQ, typename TC>
int launch_vector(const void* q, const void* pool_k, const void* pool_v,
                  const void* page_table, const void* row_pos, void* out,
                  int R, int H, int page_len, int Dh, int MP, float scale,
                  int lanes, int per_lane, int stages, cudaStream_t stream) {
  const int NV = Dh / Vec16<TC>::E;
  if (Dh % Vec16<TC>::E != 0 || NV < 1 || lanes * per_lane < NV)
    return (int)cudaErrorInvalidValue;
#define CALL(G, F, S)                                                      \
  if (lanes == G && per_lane == F && stages == S)                          \
    return launch_vec<TQ, TC, G, F, S>(q, pool_k, pool_v, page_table,      \
                                       row_pos, out, R, H, page_len, Dh,   \
                                       MP, scale, stream)
  CALL(4, 1, 2);
  CALL(8, 1, 2);
  CALL(16, 1, 2);
  CALL(32, 1, 2);
  CALL(32, 2, 2);
  CALL(4, 1, 4);
  CALL(8, 1, 4);
  CALL(16, 1, 4);
  CALL(32, 1, 4);
  CALL(32, 2, 4);
#undef CALL
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// paged_decode_attention_scalar_kernel: any Dh <= 256 and page_len,
// 4-byte (2-byte) loads

constexpr int kThreads = 128;
constexpr int kChunk = 64;   // positions staged per pass (<= kThreads)
constexpr int kFeat = 2;     // output features per thread: Dh <= 256

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
__global__ void __launch_bounds__(kThreads)
    paged_decode_attention_scalar_kernel(
    const TQ* __restrict__ q, const TC* __restrict__ pool_k,
    const TC* __restrict__ pool_v, const int* __restrict__ page_table,
    const int* __restrict__ row_pos, TQ* __restrict__ out, int H,
    int page_len, int Dh, int MP, float scale) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int stride = Dh + 1;
  // [kChunk] element offset of each staged position's (page, head) row
  size_t* base = reinterpret_cast<size_t*>(smem_b);
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
int launch_scalar(const void* q, const void* pool_k, const void* pool_v,
                  const void* page_table, const void* row_pos, void* out,
                  int R, int H, int page_len, int Dh, int MP, float scale,
                  cudaStream_t stream) {
  if (Dh > kFeat * kThreads) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (2 * (size_t)kChunk * (Dh + 1) + Dh + kChunk + 32) * sizeof(float) +
      kChunk * sizeof(size_t);
  auto kern = paged_decode_attention_scalar_kernel<TQ, TC>;
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

template <typename TQ, typename TC>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const void* page_table, const void* row_pos, void* out, int R,
           int H, int page_len, int Dh, int MP, float scale, int lanes,
           int per_lane, int stages, cudaStream_t stream) {
  if (Dh > 256 || page_len < 1 || MP < 1) return (int)cudaErrorInvalidValue;
  if (lanes)
    return launch_vector<TQ, TC>(q, pool_k, pool_v, page_table, row_pos, out,
                                 R, H, page_len, Dh, MP, scale, lanes,
                                 per_lane, stages, stream);
  return launch_scalar<TQ, TC>(q, pool_k, pool_v, page_table, row_pos, out,
                               R, H, page_len, Dh, MP, scale, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. lanes > 0 takes
// paged_decode_attention_kernel (Dh a whole number of 16-byte vectors of
// the pool dtype, pools 16-byte aligned, page_len dividing or divided by
// the chunk) at that layout: `lanes` a key, `per_lane` vectors a lane,
// `stages` chunk buffers (2 or 4); lanes 0 the scalar kernel. Returns
// cudaGetLastError(), cudaErrorInvalidValue for what it does not take.
extern "C" int paged_decode_attention(const void* q, const void* pool_k,
                                      const void* pool_v,
                                      const void* page_table,
                                      const void* row_pos, void* out, int R,
                                      int H, int page_len, int Dh, int MP,
                                      float scale, int q_dtype,
                                      int pool_dtype, int lanes, int per_lane,
                                      int stages, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define CALL(TQ, TC)                                                        \
  launch<TQ, TC>(q, pool_k, pool_v, page_table, row_pos, out, R, H,        \
                 page_len, Dh, MP, scale, lanes, per_lane, stages, s)
  if (q_dtype == 0 && pool_dtype == 0) return CALL(float, float);
  if (q_dtype == 0 && pool_dtype == 1) return CALL(float, __nv_bfloat16);
  if (q_dtype == 1 && pool_dtype == 0) return CALL(__nv_bfloat16, float);
  if (q_dtype == 1 && pool_dtype == 1)
    return CALL(__nv_bfloat16, __nv_bfloat16);
#undef CALL
  return (int)cudaErrorInvalidValue;
}
