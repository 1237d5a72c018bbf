// Fused beam-gather + cache-update + attention read for one decode step.
//
// Replaces the TPU kernel marian_tpu/ops/pallas/decode_attention.py ::
// decode_attention (body _kernel). Per (row r, head h):
//   - read the [L, Dh] cache tile of the SOURCE row src_rows[r] (the beam
//     backpointer gather, folded into the read),
//   - insert this step's k/v where dynamic_update_slice puts it (a
//     negative pos[r] counts from the end, then the index clamps into
//     [0, L-1]), cast to the cache dtype,
//   - write the reordered, updated tile whole to the OUTPUT caches,
//   - return softmax(scale * q.K^T) V over positions <= pos[r]; later
//     positions are REPLACED by -1e9 (every position when pos[r] < 0, so
//     the result is the plain average of V). Compute is f32.
//
// What bounds it on an H100: bytes. Per call it reads the source rows of
// both caches and writes both caches whole, 4*R*H*L*Dh elements, against
// 4*L*Dh flops per (r, h): at the decoder's shapes the bytes take tens of
// times longer than the arithmetic at the f32 rate (chip_smoke.py computes
// both bounds per run; PERF.md has them). So the kernel is a copy at the
// card's memory rate with the attention read done on the way.
//
// decode_attention_kernel. A (row, head) tile is one contiguous region of
// L*Dh elements in the input and in the output, so a block of 128 threads
// streams it as 16-byte vectors (4 f32 or 8 bf16 values), neighbouring
// threads on neighbouring addresses, in chunks of C positions (at most
// 8 KB of each cache) staged by cp.async into two buffers: the next chunk
// is in flight while the block writes the current one out (16-byte stores,
// the inserted row taken from shared memory where it falls) and computes
// on it. One __syncthreads a chunk. Every thread computes: the block is
// KG key groups of G lanes (at Dh 64 f32, 8 groups of 16: a lane holds
// one 16-byte vector of a row); group g takes keys g, g + KG, ... of a
// chunk (U = C / KG of them), its lanes dot their vectors with q and a
// G-lane butterfly sums the parts, and the group keeps its own running
// max, sum and accumulator over its keys, rescaled once a chunk. The
// groups are merged once at the end, in group order, through shared
// memory. Keys after pos[r] are not scored (they weigh exp(-1e9 - max) =
// 0 exactly); with pos[r] < 0 every key is scored -1e9 without its dot
// product. Shared memory is four chunks and the two insert rows (33 KB at
// most), so six blocks share an SM, two chunks each in flight. Every sum
// runs in a fixed order, so two calls give the same bits. The layout (G
// lanes a key, F vectors a lane) is the caller's choice
// (ops/kernels/decode_attention.py :: vector_layout); the entry takes the
// pairs instantiated below.
//
// A row that is not a whole number of 16-byte vectors (Dh % 4 in f32,
// Dh % 8 in bf16), or a cache that is not 16-byte aligned, goes to
// decode_attention_scalar_kernel instead, by the launcher's choice on the
// shapes (ops/kernels/decode_attention.py :: vector_path): the former
// design, 4-byte accesses through a 64-position shared-memory chunk with
// an online softmax over the block.
//
// The output caches must be other buffers than the input caches:
// src_rows is an arbitrary map with repeats, so writing in place would
// let one block overwrite a row another block has yet to read.

#include "attention_tiles.cuh"

namespace {

using attn::cp_async16;
using attn::cp_async_commit;
using attn::cp_async_wait_all;
using attn::from_f32;
using attn::group_sum;
using attn::kMask;
using attn::to_f32;
using attn::Vec16;

constexpr int kVecThreads = 128;

// grid (R, H): one block streams a whole (row, head) tile
template <typename TQ, typename TC, int G, int F>
__global__ void __launch_bounds__(kVecThreads) decode_attention_kernel(
    const TQ* __restrict__ q, const TQ* __restrict__ k_new,
    const TQ* __restrict__ v_new, const TC* __restrict__ cache_k,
    const TC* __restrict__ cache_v, const int* __restrict__ pos,
    const int* __restrict__ src_rows, TQ* __restrict__ out,
    TC* __restrict__ new_k, TC* __restrict__ new_v, int H, int L, int Dh,
    float scale) {
  using V = Vec16<TC>;
  constexpr int E = V::E;                  // values of a vector
  constexpr int KG = kVecThreads / G;      // key groups
  constexpr int U = 4 / F;                 // keys a group takes a chunk
  constexpr int C = U * KG;                // positions of a chunk
  const int NV = Dh / E;                   // vectors of a row
  const int CV = C * NV;                   // vectors of a chunk of a cache
  extern __shared__ uint4 smem[];          // 2 x {K, V} chunks, the rows
  uint4* ins = smem + 4 * CV;              // [2][NV] K and V to insert

  const int r = blockIdx.x, h = blockIdx.y;
  const int p = pos[r];
  // the insert index as dynamic_update_slice has it (a negative p counts
  // from the end, then clamps); the mask uses p
  const int at = min(max(p < 0 ? p + L : p, 0), L - 1);
  const bool none_live = p < 0;
  const int live_end = none_live ? L : min(p, L - 1) + 1;  // keys scored
  const size_t tile = (size_t)L * Dh;
  const TC* ik = cache_k + ((size_t)src_rows[r] * H + h) * tile;
  const TC* iv = cache_v + ((size_t)src_rows[r] * H + h) * tile;
  TC* ok = new_k + ((size_t)r * H + h) * tile;
  TC* ov = new_v + ((size_t)r * H + h) * tile;
  const size_t vec = ((size_t)r * H + h) * Dh;

  TC* ins_k = reinterpret_cast<TC*>(ins);
  TC* ins_v = reinterpret_cast<TC*>(ins + NV);
  for (int d = threadIdx.x; d < Dh; d += kVecThreads) {
    ins_k[d] = from_f32<TC>(to_f32(k_new[vec + d]));
    ins_v[d] = from_f32<TC>(to_f32(v_new[vec + d]));
  }
  // chunk c of the tile into buffer buf, 16 bytes a copy
  auto load = [&](int c, int buf) {
    const int c0 = c * C, n = min(C, L - c0) * NV;
    uint4* dk = smem + 2 * buf * CV;
    uint4* dv = dk + CV;
    const uint4* sk = reinterpret_cast<const uint4*>(ik + (size_t)c0 * Dh);
    const uint4* sv = reinterpret_cast<const uint4*>(iv + (size_t)c0 * Dh);
    for (int i = threadIdx.x; i < n; i += kVecThreads) {
      cp_async16(reinterpret_cast<float*>(dk + i), sk + i, true);
      cp_async16(reinterpret_cast<float*>(dv + i), sv + i, true);
    }
    cp_async_commit();
  };

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

  const int n_chunks = (L + C - 1) / C;
  load(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    cp_async_wait_all();
    __syncthreads();  // chunk c and the insert rows landed; chunk c - 1's
                      // readers are done with the other buffer
    if (c + 1 < n_chunks) load(c + 1, buf ^ 1);
    const uint4* ks = smem + 2 * buf * CV;
    const uint4* vs = ks + CV;
    const int c0 = c * C, rows = min(C, L - c0);
    {  // the chunk out, the insert row where it falls
      uint4* dk = reinterpret_cast<uint4*>(ok + (size_t)c0 * Dh);
      uint4* dv = reinterpret_cast<uint4*>(ov + (size_t)c0 * Dh);
      const int n = rows * NV, ins_at = (at - c0) * NV;
      for (int i = threadIdx.x; i < n; i += kVecThreads) {
        const unsigned j = (unsigned)(i - ins_at);
        const bool hit = j < (unsigned)NV;
        dk[i] = hit ? ins[j] : ks[i];
        dv[i] = hit ? ins[NV + j] : vs[i];
      }
    }
    const int keys = min(rows, live_end - c0);  // the same in every thread
    if (keys <= 0) continue;
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
            V::unpack(c0 + j == at ? ins[vi] : ks[j * NV + vi], kv);
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
          V::unpack(c0 + j == at ? ins[NV + vi] : vs[j * NV + vi], vv);
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

template <typename TQ, typename TC, int G, int F>
int launch_vec(const void* q, const void* k_new, const void* v_new,
               const void* cache_k, const void* cache_v, const void* pos,
               const void* src_rows, void* out, void* new_k, void* new_v,
               int R, int H, int L, int Dh, float scale,
               cudaStream_t stream) {
  constexpr int C = (4 / F) * (kVecThreads / G);
  const int NV = Dh / Vec16<TC>::E;
  const size_t smem = (4 * (size_t)C * NV + 2 * NV) * sizeof(uint4);
  auto kern = decode_attention_kernel<TQ, TC, G, F>;
  kern<<<dim3(R, H), kVecThreads, smem, stream>>>(
      (const TQ*)q, (const TQ*)k_new, (const TQ*)v_new, (const TC*)cache_k,
      (const TC*)cache_v, (const int*)pos, (const int*)src_rows, (TQ*)out,
      (TC*)new_k, (TC*)new_v, H, L, Dh, scale);
  return (int)cudaGetLastError();
}

// the (lanes, vectors a lane) pairs the vector kernel is built for; a
// layout must hold the row's vectors (G * F >= NV)
template <typename TQ, typename TC>
int launch_vector(const void* q, const void* k_new, const void* v_new,
                  const void* cache_k, const void* cache_v, const void* pos,
                  const void* src_rows, void* out, void* new_k, void* new_v,
                  int R, int H, int L, int Dh, float scale, int lanes,
                  int per_lane, cudaStream_t stream) {
  const int NV = Dh / Vec16<TC>::E;
  if (Dh % Vec16<TC>::E != 0 || NV < 1 || lanes * per_lane < NV)
    return (int)cudaErrorInvalidValue;
#define CALL(G, F)                                                         \
  if (lanes == G && per_lane == F)                                         \
    return launch_vec<TQ, TC, G, F>(q, k_new, v_new, cache_k, cache_v, pos, \
                                    src_rows, out, new_k, new_v, R, H, L,  \
                                    Dh, scale, stream)
  CALL(4, 1);
  CALL(8, 1);
  CALL(16, 1);
  CALL(32, 1);
  CALL(32, 2);
#undef CALL
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// decode_attention_scalar_kernel: any Dh <= 256, 4-byte (2-byte) accesses

constexpr int kThreads = 128;
constexpr int kChunk = 64;   // cache positions staged per pass (<= kThreads)
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

// one block per (row, head): each chunk of kChunk positions is gathered,
// patched, written out and staged in shared memory (rows padded to Dh+1
// floats) by one pass, then scored one key a thread with an online
// softmax over the block
template <typename TQ, typename TC>
__global__ void __launch_bounds__(kThreads) decode_attention_scalar_kernel(
    const TQ* __restrict__ q, const TQ* __restrict__ k_new,
    const TQ* __restrict__ v_new, const TC* __restrict__ cache_k,
    const TC* __restrict__ cache_v, const int* __restrict__ pos,
    const int* __restrict__ src_rows, TQ* __restrict__ out,
    TC* __restrict__ new_k, TC* __restrict__ new_v, int H, int L, int Dh,
    float scale) {
  extern __shared__ float smem_f[];
  const int stride = Dh + 1;
  float* ks = smem_f;                 // [kChunk][Dh+1] keys of this chunk
  float* vs = ks + kChunk * stride;   // [kChunk][Dh+1] values
  float* qs = vs + kChunk * stride;   // [Dh]
  float* ps = qs + Dh;                // [kChunk] scores, then exp(s - m)
  float* red = ps + kChunk;           // [32] reduction scratch

  const int r = blockIdx.x, h = blockIdx.y;
  const int p = pos[r];
  const int ins = min(max(p < 0 ? p + L : p, 0), L - 1);
  const size_t tile = (size_t)L * Dh;
  const size_t in_tile = ((size_t)src_rows[r] * H + h) * tile;
  const size_t out_tile = ((size_t)r * H + h) * tile;
  const size_t vec = ((size_t)r * H + h) * Dh;

  for (int d = threadIdx.x; d < Dh; d += blockDim.x) qs[d] = to_f32(q[vec + d]);
  float m = -INFINITY, l = 0.f, acc[kFeat];
#pragma unroll
  for (int f = 0; f < kFeat; ++f) acc[f] = 0.f;

  for (int c0 = 0; c0 < L; c0 += kChunk) {
    const int n = min(kChunk, L - c0);
    __syncthreads();  // the previous chunk's readers are done
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
int launch_scalar(const void* q, const void* k_new, const void* v_new,
                  const void* cache_k, const void* cache_v, const void* pos,
                  const void* src_rows, void* out, void* new_k, void* new_v,
                  int R, int H, int L, int Dh, float scale,
                  cudaStream_t stream) {
  if (Dh > kFeat * kThreads) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (2 * (size_t)kChunk * (Dh + 1) + Dh + kChunk + 32) * sizeof(float);
  auto kern = decode_attention_scalar_kernel<TQ, TC>;
  if (smem > 48 * 1024) {
    if (int e = attn::set_smem(kern, smem)) return e;
  }
  kern<<<dim3(R, H), kThreads, smem, stream>>>(
      (const TQ*)q, (const TQ*)k_new, (const TQ*)v_new, (const TC*)cache_k,
      (const TC*)cache_v, (const int*)pos, (const int*)src_rows, (TQ*)out,
      (TC*)new_k, (TC*)new_v, H, L, Dh, scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TC>
int launch(const void* q, const void* k_new, const void* v_new,
           const void* cache_k, const void* cache_v, const void* pos,
           const void* src_rows, void* out, void* new_k, void* new_v,
           int R, int H, int L, int Dh, float scale, int lanes,
           int per_lane, cudaStream_t stream) {
  if (Dh > 256) return (int)cudaErrorInvalidValue;
  if (lanes)
    return launch_vector<TQ, TC>(q, k_new, v_new, cache_k, cache_v, pos,
                                 src_rows, out, new_k, new_v, R, H, L, Dh,
                                 scale, lanes, per_lane, stream);
  return launch_scalar<TQ, TC>(q, k_new, v_new, cache_k, cache_v, pos,
                               src_rows, out, new_k, new_v, R, H, L, Dh,
                               scale, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. lanes > 0 takes
// decode_attention_kernel (Dh a whole number of 16-byte vectors of the
// cache dtype, caches 16-byte aligned) at that layout: `lanes` a key,
// `per_lane` vectors a lane; lanes 0 the scalar kernel. Returns
// cudaGetLastError(), cudaErrorInvalidValue for what it does not take.
extern "C" int decode_attention(const void* q, const void* k_new,
                                const void* v_new, const void* cache_k,
                                const void* cache_v, const void* pos,
                                const void* src_rows, void* out, void* new_k,
                                void* new_v, int R, int H, int L, int Dh,
                                float scale, int q_dtype, int cache_dtype,
                                int lanes, int per_lane, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define CALL(TQ, TC)                                                        \
  launch<TQ, TC>(q, k_new, v_new, cache_k, cache_v, pos, src_rows, out,    \
                 new_k, new_v, R, H, L, Dh, scale, lanes, per_lane, s)
  if (q_dtype == 0 && cache_dtype == 0) return CALL(float, float);
  if (q_dtype == 0 && cache_dtype == 1) return CALL(float, __nv_bfloat16);
  if (q_dtype == 1 && cache_dtype == 0) return CALL(__nv_bfloat16, float);
  if (q_dtype == 1 && cache_dtype == 1)
    return CALL(__nv_bfloat16, __nv_bfloat16);
#undef CALL
  return (int)cudaErrorInvalidValue;
}
