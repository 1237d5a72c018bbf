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
// What bounds it on an H100: bytes, at sentence lengths. It moves
// 4*B*H*T*Dh elements (q, k, v, out) for 4*B*H*Tq*Tk*Dh flops: at T = 64,
// Dh = 64 the f32 bytes just outweigh the flops (chip_smoke.py computes
// both bounds per run; PERF.md has them), so the kernel has to read each
// input once and keep the arithmetic near the CUDA cores' rate.
//
// In float32, packed_attention_fwd_kernel (Dh 16, 32, 64, 128) runs on the
// register-blocked tiles of attention_tiles.cuh, as the backward's one-tile
// kernel does: a block of 128 threads (8 x 16) owns one (batch, head) and 64
// query rows, a thread an 8 x 4 fragment of the score tile (up to 32
// queries, as in the decode encoder, 64 threads own 32 rows, so no block
// computes a half-empty tile). The query
// tile, and the head's K, V and key mask 64 keys at a time, are staged by
// 16-byte cp.async; S = Q.K^T is
// computed once a key tile from float4 reads (8 FMAs each), its row max
// and sum reduced over the sixteen lanes of a row, P written once to
// shared memory at the template's stride of 80 and multiplied into the
// accumulators by apply_rows. Up to 64 keys (every training sentence at
// --max-length 63, the decode and serving encoders) that is one tile pair
// and one pass; past 64 the block walks the key tiles with the flash
// forward's online softmax (from a running max of -1e30, whose first
// rescale exp(-1e30 - m) is 0), the next tile in flight in a second
// stage, and past 64 queries the grid has more query tiles, each staging
// the head's K and V once. Causal: key tiles wholly after every query of
// the tile are skipped when every row of the tile sees a live key (one at
// or before its first query): they weigh exp(-1e9 - max) = 0. Every
// output has one writer and every sum a fixed order: two calls give the
// same bits. Shared memory (floats; SD = Dh + 4; QT query rows): QT*SD +
// QT*80 + stages * (2*64*SD + 64), one stage up to 64 keys: 73 KB at Dh
// 64 (54 KB with 32 rows).
//
// In bf16 at those head sizes packed_tc_fwd_kernel (the bf16 library
// only; entry packed_attention_fwd_tc, the wrapper's packed_tc_fwd_path)
// takes every call on the tensor cores: mma.sync m16n8k16 on bf16
// operands with f32 sums (attention_mma.cuh's tiles), a block of 4 warps
// and 64 query rows, 16 a warp (2 warps and 32 rows up to 32 queries),
// the same grid, key tiles, online softmax and causal skip as above. S =
// Q.K^T and its softmax stay in the registers; P enters O += P.V as a
// hi/lo bf16 pair (hi = bf16(x), lo = bf16(x - hi): the reference's f32 P
// to 2^-16). A tile's K and key mask land as one cp.async group and its V
// as the next, so S is formed while V lands; past 64 keys the next
// tile's groups fly in a second slot. O / l leaves through the warp's own
// rows of the query tile as 16-byte stores. What bounds it on an H100:
// bytes (4 B.H.T.Dh bf16 elements for 4 B.H.Tq.Tk.Dh flops, of which the
// hi/lo pair makes 6 on the tensor cores), so several blocks share an
// SM, one's copies under another's products. Shared memory (bytes; P =
// Dh + 8): QT*P*2 + stages * (4*64*P + 256): 28 KB at Dh 64 up to 64
// keys. The wrapper copies operands that are not 16-byte aligned.
//
// At any other head size, or in float32 where q, k or v is not 16-byte
// aligned (the tiles stage by 16-byte copies),
// packed_attention_generic_kernel, the former design, runs (the
// launcher's choice by shape: ops/kernels/packed_attention.py ::
// fwd_query_tile): a block owns one (batch, head) and
// 16 query rows, stages the head's K and V in shared memory (rows padded
// to Dh+1 floats) and walks one query row a warp. Its shared memory,
// (2*Tk*(Dh+1) + Tk + warps*(Dh+Tk)) floats, set the port's length cap
// (ops/kernels/packed_attention.py :: max_t), which stays the routing cap
// at every head size.

#include "attention_tiles.cuh"
#if KERNEL_DTYPE == 1
#include "mma_tiles.cuh"
#include "attention_mma.cuh"
#endif

namespace {

using namespace attn;

constexpr int kTile = kSTile;   // queries and keys of a tile

// QT query rows a block (64, or 32 where Tq <= 32) by 2*QT threads, 8
// rows a thread
template <typename T, int DH, int QT>
__global__ void __launch_bounds__(2 * QT) packed_attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ kv_mask,
    T* __restrict__ out, int H, int Tq, int Tk, float scale, int causal) {
  constexpr int NT = 2 * QT, RS = NT / 16, R = QT / RS;
  constexpr int SD = DH + 4, NF = DH / 16, OT = kTile * SD;
  constexpr int kStage = 2 * OT + kTile;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [QT][SD] the query tile
  float* ps = qs + QT * SD;                      // [QT][kBPS] p of a tile
  float* stream = ps + QT * kBPS;                // stages x {K, V, mask}

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.x, b = bh / H, q0 = blockIdx.y * QT;
  const float* kvm = kv_mask + (size_t)b * Tk;
  const T* kh = k + (size_t)bh * Tk * DH;
  const T* vh = v + (size_t)bh * Tk * DH;
  int n_k = (Tk + kTile - 1) / kTile;
  if (causal) {
    bool seen = false;  // a live key at or before q0
    for (int j = threadIdx.x; j <= q0 && j < Tk; j += NT)
      seen |= kvm[j] != 0.f;
    if (__syncthreads_or(seen)) n_k = min(n_k, (q0 + QT - 1) / kTile + 1);
  }
  stage_rows<QT, DH, NT>(q + (size_t)bh * Tq * DH, q0, Tq, qs);
  auto stage_keys = [&](int kt, int buf) {
    float* s = stream + buf * kStage;
    stage_rows<kTile, DH, NT>(kh, kt * kTile, Tk, s);
    stage_rows<kTile, DH, NT>(vh, kt * kTile, Tk, s + OT);
    stage_vec(kvm, kt * kTile, Tk, s + 2 * OT, 0);
    cp_async_commit();
  };

  float m[R], l[R], acc[R][NF];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kStatsInit;
    l[i] = 0.f;
#pragma unroll
    for (int f = 0; f < NF; ++f) acc[i][f] = 0.f;
  }
  stage_keys(0, 0);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kTile, buf = kt & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kt landed; the previous tile's readers are done
    if (kt + 1 < n_k) stage_keys(kt + 1, buf ^ 1);
    const float* ks = stream + buf * kStage;
    const float* vs = ks + OT;
    const float* mk = vs + OT;
    float s[R][4];
    dot_rows<R, DH, NT>(qs, ks, s);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + RS * i, row = q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, col = k0 + c;
        float x = s[i][j] * scale + (1.f - mk[c]) * kMask;
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
        ps[r * kBPS + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int f = 0; f < NF; ++f) acc[i][f] *= alpha;
    }
    __syncthreads();  // the probabilities of the tile are written
    apply_rows<R, DH, false, kBPS, NT>(ps, vs, acc);
  }
  // l >= 1: the row max contributes exp(0)
  const size_t obase = (size_t)bh * Tq;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + RS * i;
    if (row >= Tq) continue;
#pragma unroll
    for (int f = 0; f < NF; ++f)
      out[(obase + row) * DH + out_col<DH>(f)] = from_f32<T>(acc[i][f] / l[i]);
  }
}

template <typename T, int DH, int QT>
int launch_fwd(const void* q, const void* k, const void* v,
               const void* kv_mask, void* out, int B, int H, int Tq, int Tk,
               float scale, int causal, cudaStream_t stream) {
  constexpr int OT = kTile * (DH + 4);
  const int stages = Tk > kTile ? 2 : 1;
  const size_t smem =
      (QT * (DH + 4) + QT * kBPS + stages * (2 * OT + kTile)) *
      sizeof(float);
  auto kern = packed_attention_fwd_kernel<T, DH, QT>;
  if (int e = set_smem(kern, smem)) return e;
  const dim3 grid(B * H, (Tq + QT - 1) / QT);
  kern<<<grid, 2 * QT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)kv_mask, (T*)out,
      H, Tq, Tk, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_fwd(const void* q, const void* k, const void* v,
               const void* kv_mask, void* out, int B, int H, int Tq, int Tk,
               float scale, int causal, int tile, cudaStream_t stream) {
  if (tile == 32)
    return launch_fwd<T, DH, 32>(q, k, v, kv_mask, out, B, H, Tq, Tk, scale,
                                 causal, stream);
  if (tile == 64)
    return launch_fwd<T, DH, 64>(q, k, v, kv_mask, out, B, H, Tq, Tk, scale,
                                 causal, stream);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// packed_attention_generic_kernel: any head size

constexpr int kGenThreads = 128;
constexpr int kGenWarps = kGenThreads / 32;
constexpr int kRowsPerBlock = 16;

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
__global__ void __launch_bounds__(kGenThreads) packed_attention_generic_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ kv_mask,
    T* __restrict__ out, int H, int Tq, int Tk, int Dh, float scale,
    int causal) {
  extern __shared__ float smem[];
  const int stride = Dh + 1;
  float* ks = smem;               // [Tk][Dh+1]
  float* vs = ks + Tk * stride;   // [Tk][Dh+1]
  float* bias = vs + Tk * stride; // [Tk] additive key mask
  float* qw = bias + Tk;            // [kGenWarps][Dh] a query row a warp
  float* pw = qw + kGenWarps * Dh;  // [kGenWarps][Tk] its scores, then p

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
  for (int i = blockIdx.y * kRowsPerBlock + warp; i < row_end;
       i += kGenWarps) {
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
int launch_generic(const void* q, const void* k, const void* v,
                   const void* kv_mask, void* out, int B, int H, int Tq,
                   int Tk, int Dh, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem =
      (2 * (size_t)Tk * (Dh + 1) + Tk + kGenWarps * (size_t)(Dh + Tk)) *
      sizeof(float);
  auto kern = packed_attention_generic_kernel<T>;
  if (smem > 48 * 1024) {
    if (int e = set_smem(kern, smem)) return e;
  }
  const dim3 grid(B * H, (Tq + kRowsPerBlock - 1) / kRowsPerBlock);
  kern<<<grid, kGenThreads, smem, stream>>>(
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
//   P = exp(S - max) / sum over every real key (S as the forward's),
//   dP = dO V^T,  dS = P * (dP - delta) * scale,
//   dQ = dS K,    dK = dS^T Q,    dV = P^T dO.
// One block produces the dq, dk and dv of a (batch, head), so no two
// blocks write the same output and no atomics are needed (the TPU grid
// (b, h//g) did the same per head group); every sum runs in a fixed
// order, so two calls give the same bits.
//
// Both kernels below are built from the flash kernels' register-blocked
// products (attention_tiles.cuh) on 64 x 64 tiles of queries and keys: a
// thread holds a 4 x 4 fragment of a tile's S and dO.V^T (own rows:
// queries), the row max and sum reduce over the sixteen lanes of a row,
// and P^T, dS^T and dS are written to shared memory once (stride 68: the
// transposed stores fall two to a bank) for the three products, which
// read them as float4: dV and dK of the key tile in one pass
// (apply_rows' two-product form, own rows: keys), then dQ of the query
// tile.
//
// Up to 64 queries and keys (the training path's sentences) a head is one
// tile pair: in f32 (bf16: packed_tc_bwd_kernel, below)
// packed_attention_bwd_kernel stages its Q, dO, K, V, key mask
// and delta once, computes S once and takes the statistics from it; from
// Dh 64 dS overwrites V, which no product reads after dO.V^T. Its block
// has 128 threads (8 x 16), so a thread holds 8 x 4 fragments, as the
// flash kernels do, with 8 float4 reads for every 128 FMAs of a product
// where 4 x 4 fragments take 8 for 64; two blocks (105 KB each at Dh 64)
// share an SM, one's loads under the other's products.
//
// Past 64, packed_attention_bwd_tiled_kernel walks the tiles of one head.
// Pass 1 takes each query tile across the key tiles it sees for every
// row's max and sum (online, from -1e30) into shared memory. Pass 2 takes
// the key tiles in order: dK and dV of the tile stay in registers while
// the query tiles stream through two cp.async stages (one at Dh 128), and
// each query tile's dQ adds ds.K of the key tile to its sum over the
// earlier key tiles, held in shared memory (at Dh 128 in the block's
// slice of a global f32 scratch), each element by the one thread that
// owns it. One key tile's statistics are the same in both kernels, bit
// for bit. Causal pairs are skipped by flash_attention.cu's rule: every
// key after every query and every row sees a live key (such keys weigh
// exp(-1e9 - max) = 0 exactly).
//
// What bounds it on an H100: close to the balance point at T = 64. It
// moves 7*B*H*T*Dh elements (q, k, v, dO in; dq, dk, dv out) for
// 10*B*H*Tq*Tk*Dh flops (the recomputed scores and four products),
// 12*B*H*Tq*Tk*Dh past 64 (pass 1 computes S again): at T = 64, Dh = 64
// the f32 flops just outweigh the bytes (chip_smoke.py computes both
// bounds per run). Shared memory (floats; OT = 64*(Dh + 4); ST = 64*68):
//   short   4*OT + 128 + 2*ST (3*ST below Dh 64, where V's tile cannot
//           take dS)                               (105 KB at Dh 64)
//   tiled   (2 + 2*stages)*OT + 3*ST + stats + Tq*Dh (Dh <= 64)
// with stats = 3*Tq + Tk (max, sum, delta, key mask) rounded up to a
// float4. The longest T = Tq = Tk within the 227 KB a block may take is
// the backward's cap (max_t_bwd): 1,868 / 867 / 278 / 2,816 at Dh 16 /
// 32 / 64 / 128.
//
// In bf16, up to 64 queries and keys (every sentence of the bf16 base
// update), packed_tc_bwd_kernel (the bf16 library only; entry
// packed_attention_bwd_tc, the wrapper's packed_tc_path) replaces the
// same _bwd_kernel on the tensor cores: mma.sync m16n8k16 on bf16
// operands with f32 sums (attention_mma.cuh's tiles), a block of 4 warps
// a (batch, head). It takes delta = rowsum(dO * out) itself, in f32 from
// the staged dO and out: outside the kernel, as the reference takes it,
// delta's elementwise launches cost more than the kernel at the base
// update's shape. Step 1 owns 16 query rows a warp: S = Q.K^T and dO.V^T
// from the staged tiles, P and dS in the registers in the op order above,
// dQ = dS.K with dS entering as a hi/lo bf16 pair (hi = bf16(x), lo =
// bf16(x - hi): the reference's f32 dS to 2^-16). P and dS go to shared
// memory as hi/lo pairs (four 64 x 72 bf16 tiles, where out's tile lies
// first); step 2 owns 16 keys a warp and reads P^T and dS^T through
// ldmatrix .trans for dV = P^T.dO and dK = dS^T.Q. What bounds it on an
// H100: bytes (8 B.H.T.Dh bf16 elements in and out for 10 B.H.Tq.Tk.Dh
// flops, of which the hi/lo pairs make 16 on the tensor cores); shared
// memory 4 x 64 x (Dh + 8) + 4 x 64 x 72 bf16 and 128 floats (74 KB at
// Dh 64, 107 KB at 128). It takes every bf16 call within one tile pair
// (the wrapper copies unaligned operands);
// past 64 tokens and in f32 the kernels above run.

constexpr int kPS = kTile + 4;  // stride of the score tiles

template <int DH>
struct Packed {
  static constexpr int R = kTile / 16;             // rows a thread (tiled)
  static constexpr int SD = DH + 4;                // operand row stride
  static constexpr int NF = DH / 16;               // output columns a thread
  static constexpr int kOperand = kTile * SD;      // floats of an operand tile
  static constexpr int kScore = kTile * kPS;       // floats of a score tile
  // short: 128 threads, 8 rows a thread; a head's Q, dO, K, V, key mask
  // and delta, and the score tiles
  static constexpr int kShortThreads = 128;
  static constexpr int kShortR = kTile / (kShortThreads / 16);
  static constexpr bool kDsOverV = SD >= kPS;      // V's tile holds dS
  static constexpr int kShortFloats =
      4 * kOperand + 2 * kTile + (kDsOverV ? 2 : 3) * kScore;
  // tiled: Q/dO stages, and where the dq sums live
  static constexpr int kStages = DH > 64 ? 1 : 2;
  static constexpr bool kDqGlobal = DH > 64;
  static_assert(kShortFloats * 4 <= kMaxSmem, "shared memory of a block");
};

// floats of shared memory for Tq x Tk (the layout in the header note)
template <int DH>
size_t bwd_floats(int Tq, int Tk) {
  using G = Packed<DH>;
  if (Tq <= kTile && Tk <= kTile) return G::kShortFloats;
  const size_t stats = (3 * (size_t)Tq + Tk + 3) / 4 * 4;
  return (2 + 2 * G::kStages) * G::kOperand + 3 * G::kScore + stats +
         (G::kDqGlobal ? 0 : (size_t)Tq * DH);
}

// S of the query tile at q0 against the key tile at k0 in the forward's
// op order: (q.k) * scale + (1 - mask) * -1e9, causal positions -1e9,
// keys past Tk -inf; mk is the key tile's mask
template <int R, int NT>
__device__ __forceinline__ void mask_scores(float (&s)[R][4], const float* mk,
                                            int q0, int k0, int Tk,
                                            float scale, int causal) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int ii = 0; ii < R; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int row = q0 + ty + NT / 16 * ii, c = tx + 16 * jj;
      float x = -INFINITY;
      if (k0 + c < Tk) {
        x = s[ii][jj] * scale + (1.f - mk[c]) * kMask;
        if (causal && row < k0 + c) x = kMask;
      }
      s[ii][jj] = x;
    }
}

// the running max and sum of each own row after one more key tile
template <int R>
__device__ __forceinline__ void online(const float (&s)[R][4],
                                       float (&m)[R], float (&l)[R]) {
#pragma unroll
  for (int ii = 0; ii < R; ++ii) {
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) mx = fmaxf(mx, s[ii][jj]);
    const float m_new = fmaxf(m[ii], row_max(mx));
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) sum += expf(s[ii][jj] - m_new);
    l[ii] = expf(m[ii] - m_new) * l[ii] + row_sum(sum);
    m[ii] = m_new;
  }
}

// p = exp(s - m) / l and ds = p * (dp - delta) * scale of the pair, 0 for
// rows past Tq and keys past Tk, into P^T, dS^T and dS; dl is the query
// tile's delta
template <int R, int NT>
__device__ __forceinline__ void write_scores(
    const float (&s)[R][4], const float (&dp)[R][4], const float (&m)[R],
    const float (&l)[R], const float* dl, int q0, int k0, int Tq, int Tk,
    float scale, float* pt, float* dst, float* ds) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int ii = 0; ii < R; ++ii) {
    const int r = ty + NT / 16 * ii;
    const bool in = q0 + r < Tq;
    const float d = in ? dl[r] : 0.f;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = tx + 16 * jj;
      const float p =
          in && k0 + c < Tk ? expf(s[ii][jj] - m[ii]) / l[ii] : 0.f;
      const float g = p * (dp[ii][jj] - d) * scale;
      pt[c * kPS + r] = p;
      dst[c * kPS + r] = g;
      ds[r * kPS + c] = g;
    }
  }
}

// rows row0 + ty + (NT/16)i (those before `rows`) of a [rows][DH] output
template <typename T, int DH, int NT, int R>
__device__ __forceinline__ void store_rows(T* out, int row0, int rows,
                                           const float (&acc)[R][DH / 16]) {
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int ii = 0; ii < R; ++ii) {
    const int row = row0 + ty + NT / 16 * ii;
    if (row >= rows) continue;
#pragma unroll
    for (int f = 0; f < DH / 16; ++f)
      out[(size_t)row * DH + out_col<DH>(f)] = from_f32<T>(acc[ii][f]);
  }
}

template <int R, int NF>
__device__ __forceinline__ void zero(float (&a)[R][NF]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int f = 0; f < NF; ++f) a[i][f] = 0.f;
}

// ---------------------------------------------------------------------------
// short: Tq, Tk <= 64; a block of 128 threads per (batch, head)

template <typename T, int DH>
__global__ void __launch_bounds__(Packed<DH>::kShortThreads)
    packed_attention_bwd_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const float* __restrict__ kv_mask,
        const T* __restrict__ dout, const float* __restrict__ delta,
        T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int H,
        int Tq, int Tk, float scale, int causal) {
  using G = Packed<DH>;
  constexpr int NT = G::kShortThreads, R = G::kShortR, NF = G::NF;
  constexpr int OT = G::kOperand, ST = G::kScore;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [64][SD] Q
  float* dos = qs + OT;                          // [64][SD] dO
  float* ks = dos + OT;                          // [64][SD] K
  float* vs = ks + OT;                           // [64][SD] V, then dS
  float* mk = vs + OT;                           // [64] key mask
  float* dl = mk + kTile;                        // [64] delta
  float* pt = dl + kTile;                        // [64][kPS] P^T
  float* dst = pt + ST;                          // [64][kPS] dS^T
  float* ds = G::kDsOverV ? vs : dst + ST;       // [64][kPS] dS

  const int bh = blockIdx.x;
  stage_rows<kTile, DH, NT>(q + (size_t)bh * Tq * DH, 0, Tq, qs);
  stage_rows<kTile, DH, NT>(dout + (size_t)bh * Tq * DH, 0, Tq, dos);
  stage_rows<kTile, DH, NT>(k + (size_t)bh * Tk * DH, 0, Tk, ks);
  stage_rows<kTile, DH, NT>(v + (size_t)bh * Tk * DH, 0, Tk, vs);
  stage_vec(kv_mask + (size_t)(bh / H) * Tk, 0, Tk, mk, 0);
  stage_vec(delta + (size_t)bh * Tq, 0, Tq, dl, kTile);
  cp_async_wait_all();
  __syncthreads();  // the head's tiles landed
  float s[R][4], dp[R][4], m[R], l[R];
  dot_rows<R, DH, NT>(qs, ks, s);
  dot_rows<R, DH, NT>(dos, vs, dp);
  mask_scores<R, NT>(s, mk, 0, 0, Tk, scale, causal);
#pragma unroll
  for (int ii = 0; ii < R; ++ii) {
    m[ii] = kStatsInit;
    l[ii] = 0.f;
  }
  online<R>(s, m, l);
  if (G::kDsOverV) __syncthreads();  // every dO.V^T has read V
  write_scores<R, NT>(s, dp, m, l, dl, 0, 0, Tq, Tk, scale, pt, dst, ds);
  __syncthreads();  // P^T, dS^T and dS are written
  float dk_acc[R][NF], dv_acc[R][NF], dq_acc[R][NF];
  zero(dk_acc);
  zero(dv_acc);
  zero(dq_acc);
  apply_rows<R, DH, true, kPS, NT>(pt, dos, dv_acc, dst, qs, dk_acc);
  store_rows<T, DH, NT>(dk + (size_t)bh * Tk * DH, 0, Tk, dk_acc);
  store_rows<T, DH, NT>(dv + (size_t)bh * Tk * DH, 0, Tk, dv_acc);
  apply_rows<R, DH, false, kPS, NT>(ds, ks, dq_acc);
  store_rows<T, DH, NT>(dq + (size_t)bh * Tq * DH, 0, Tq, dq_acc);
}

// ---------------------------------------------------------------------------
// tiled: past 64 queries or keys; one block per (batch, head)

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1)
    packed_attention_bwd_tiled_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const float* __restrict__ kv_mask,
        const T* __restrict__ dout, const float* __restrict__ delta,
        T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
        float* __restrict__ dq_sum, int H, int Tq, int Tk, float scale,
        int causal) {
  using G = Packed<DH>;
  constexpr int R = G::R, NF = G::NF, OT = G::kOperand, ST = G::kScore;
  constexpr int kStages = G::kStages;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [64][SD] K of the key tile
  float* vs = ks + OT;                           // [64][SD] V
  float* stage = vs + OT;                        // stages x {Q, dO} [64][SD]
  float* pt = stage + kStages * 2 * OT;          // [64][kPS] P^T (key rows)
  float* dst = pt + ST;                          // [64][kPS] dS^T
  float* ds = dst + ST;                          // [64][kPS] dS (query rows)
  float* m_s = ds + ST;                          // [Tq] row max
  float* l_s = m_s + Tq;                         // [Tq] row sum
  float* dl_s = l_s + Tq;                        // [Tq] delta
  float* mask = dl_s + Tq;                       // [Tk] key mask
  __shared__ int first_slot;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.x, b = bh / H;
  const float* kvm = kv_mask + (size_t)b * Tk;
  const T* qh = q + (size_t)bh * Tq * DH;
  const T* doh = dout + (size_t)bh * Tq * DH;
  const T* kh = k + (size_t)bh * Tk * DH;
  const T* vh = v + (size_t)bh * Tk * DH;
  // [Tq][DH] dq summed over the key tiles so far
  float* dq_acc = G::kDqGlobal ? dq_sum + (size_t)bh * Tq * DH
                               : m_s + (3 * Tq + Tk + 3) / 4 * 4;
  const int first = first_live_key(kvm, Tk, causal, &first_slot);
  for (int r = threadIdx.x; r < Tq; r += kThreads)
    dl_s[r] = delta[(size_t)bh * Tq + r];
  for (int c = threadIdx.x; c < Tk; c += kThreads) mask[c] = kvm[c];
  const int nq = (Tq + kTile - 1) / kTile, nk = (Tk + kTile - 1) / kTile;
  // the key tiles query tile i sees: all but those wholly in its future
  // when every row of it sees a live key
  auto live_k = [&](int i) {
    return causal && i * kTile >= first ? min(nk, i + 1) : nk;
  };

  // pass 1: query tiles in order, each across the key tiles it sees; Q
  // tiles in stage 0's two slots (by tile parity), K tiles in the K and V
  // slots (by pair parity), the next pair's in flight
  float* qb = stage;
  float* kb = ks;
  stage_rows<kTile, DH>(qh, 0, Tq, qb);
  stage_rows<kTile, DH>(kh, 0, Tk, kb);
  cp_async_commit();
  int n = 0;
  for (int i = 0; i < nq; ++i) {
    float m[R], l[R];
#pragma unroll
    for (int ii = 0; ii < R; ++ii) {
      m[ii] = kStatsInit;
      l[ii] = 0.f;
    }
    const int nki = live_k(i);
    for (int j = 0; j < nki; ++j, ++n) {
      cp_async_wait_all();
      __syncthreads();  // pair n landed; pair n - 1's readers are done
      float* kn = kb + ((n + 1) & 1) * OT;
      if (j + 1 < nki) {
        stage_rows<kTile, DH>(kh, (j + 1) * kTile, Tk, kn);
      } else if (i + 1 < nq) {
        stage_rows<kTile, DH>(qh, (i + 1) * kTile, Tq,
                              qb + ((i + 1) & 1) * OT);
        stage_rows<kTile, DH>(kh, 0, Tk, kn);
      }
      cp_async_commit();
      float s[R][4];
      dot_rows<R, DH>(qb + (i & 1) * OT, kb + (n & 1) * OT, s);
      mask_scores<R, kThreads>(s, mask + j * kTile, i * kTile, j * kTile,
                               Tk, scale, causal);
      online<R>(s, m, l);
    }
    if (tx == 0)
#pragma unroll
      for (int ii = 0; ii < R; ++ii) {
        const int row = i * kTile + ty + 16 * ii;
        if (row < Tq) {
          m_s[row] = m[ii];
          l_s[row] = l[ii];
        }
      }
  }

  // pass 2: key tiles in order, each against the query tiles that see it
  auto stage_q = [&](int i, int buf) {
    float* s = stage + buf * 2 * OT;
    stage_rows<kTile, DH>(qh, i * kTile, Tq, s);
    stage_rows<kTile, DH>(doh, i * kTile, Tq, s + OT);
    cp_async_commit();
  };
  for (int j = 0; j < nk; ++j) {
    auto next_q = [&](int i) {
      while (i < nq && causal && i * kTile >= first && j > i) ++i;
      return i;
    };
    int i = next_q(0), buf = 0;
    __syncthreads();  // pass 1's or the previous key tile's readers are done
    stage_rows<kTile, DH>(kh, j * kTile, Tk, ks);
    stage_rows<kTile, DH>(vh, j * kTile, Tk, vs);
    if (i < nq) stage_q(i, 0);
    cp_async_commit();
    float dk_acc[R][NF], dv_acc[R][NF];
    zero(dk_acc);
    zero(dv_acc);
    while (i < nq) {
      const int nxt = next_q(i + 1);
      cp_async_wait_all();
      __syncthreads();  // the pair's tiles landed; the last pair's readers
                        // are done
      if (kStages == 2 && nxt < nq) stage_q(nxt, buf ^ 1);
      const float* qs = stage + buf * 2 * OT;
      const float* dos = qs + OT;
      float s[R][4], dp[R][4], m[R], l[R];
      dot_rows<R, DH>(qs, ks, s);
      dot_rows<R, DH>(dos, vs, dp);
      mask_scores<R, kThreads>(s, mask + j * kTile, i * kTile, j * kTile,
                               Tk, scale, causal);
#pragma unroll
      for (int ii = 0; ii < R; ++ii) {
        const int row = i * kTile + ty + 16 * ii;
        m[ii] = row < Tq ? m_s[row] : 0.f;
        l[ii] = row < Tq ? l_s[row] : 1.f;
      }
      write_scores<R, kThreads>(s, dp, m, l, dl_s + i * kTile, i * kTile,
                                j * kTile, Tq, Tk, scale, pt, dst, ds);
      __syncthreads();  // P^T, dS^T and dS of the pair are written
      apply_rows<R, DH, true, kPS>(pt, dos, dv_acc, dst, qs, dk_acc);
      // dq of query tile i: its sum over the key tiles, in their order
      const bool first_j = j == 0, last_j = j == live_k(i) - 1;
      float acc[R][NF];
#pragma unroll
      for (int ii = 0; ii < R; ++ii) {
        const int row = i * kTile + ty + 16 * ii;
#pragma unroll
        for (int f = 0; f < NF; ++f)
          acc[ii][f] = first_j || row >= Tq
                           ? 0.f
                           : dq_acc[(size_t)row * DH + out_col<DH>(f)];
      }
      apply_rows<R, DH, false, kPS>(ds, ks, acc);
      if (last_j) {
        store_rows<T, DH, kThreads>(dq + (size_t)bh * Tq * DH, i * kTile, Tq,
                                    acc);
      } else {
        store_rows<float, DH, kThreads>(dq_acc, i * kTile, Tq, acc);
      }
      if (kStages == 1 && nxt < nq) {
        __syncthreads();  // one stage: its readers are done before it refills
        stage_q(nxt, 0);
      }
      i = nxt;
      buf ^= kStages - 1;
    }
    store_rows<T, DH, kThreads>(dk + (size_t)bh * Tk * DH, j * kTile, Tk,
                                dk_acc);
    store_rows<T, DH, kThreads>(dv + (size_t)bh * Tk * DH, j * kTile, Tk,
                                dv_acc);
  }
  cp_async_wait_all();
}

template <typename T, int DH>
int launch_bwd(const void* q, const void* k, const void* v,
               const void* kv_mask, const void* dout, const void* delta,
               void* dq, void* dk, void* dv, void* dq_sum, int B, int H,
               int Tq, int Tk, float scale, int causal, cudaStream_t stream) {
  const size_t smem = bwd_floats<DH>(Tq, Tk) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (Tq <= kTile && Tk <= kTile) {
#if KERNEL_DTYPE == 1
    // in bf16 one tile pair is packed_tc_bwd_kernel's (the entry
    // packed_attention_bwd_tc)
    return (int)cudaErrorInvalidValue;
#else
    auto kern = packed_attention_bwd_kernel<T, DH>;
    if (int e = set_smem(kern, smem)) return e;
    kern<<<B * H, Packed<DH>::kShortThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)kv_mask,
        (const T*)dout, (const float*)delta, (T*)dq, (T*)dk, (T*)dv, H, Tq,
        Tk, scale, causal);
    return (int)cudaGetLastError();
#endif
  }
  if (Packed<DH>::kDqGlobal && !dq_sum) return (int)cudaErrorInvalidValue;
  auto kern = packed_attention_bwd_tiled_kernel<T, DH>;
  if (int e = set_smem(kern, smem)) return e;
  kern<<<B * H, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)kv_mask,
      (const T*)dout, (const float*)delta, (T*)dq, (T*)dk, (T*)dv,
      (float*)dq_sum, H, Tq, Tk, scale, causal);
  return (int)cudaGetLastError();
}

#if KERNEL_DTYPE == 1
// ---------------------------------------------------------------------------
// the bf16 one-tile backward on the tensor cores: Tq, Tk <= 64, a block of
// 4 warps per (batch, head), the bf16 library only

constexpr int kTcThreads = 128;
constexpr int kTcPitch = kTile + 8;  // P and dS tiles' row pitch, bf16

template <int DH>
struct PackedTc {
  static constexpr int P = DH + 8;    // Q, dO, K, V row pitch, bf16
  // Q, dO, K, V; P and dS as hi/lo pairs [64 queries][64 keys] (out's
  // tile [64][P] before them); the key mask and delta (bytes)
  static constexpr int kSmem =
      4 * kTile * P * 2 + 4 * kTile * kTcPitch * 2 + 2 * kTile * 4;
  static_assert(kSmem <= (int)kMaxSmem, "shared memory of a block");
  static_assert(P <= 2 * kTcPitch, "out's tile fits P's hi and lo tiles");
};

// rows r0 and r0 + 8 (those before `rows`) of a warp's [16][DH] tile in
// C fragments into out[rows][DH], as bf16
template <int DH>
__device__ __forceinline__ void tc_store_rows(bf16* out, int r0, int rows,
                                              const float (&acc)[DH / 8][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= rows) continue;
#pragma unroll
    for (int d = 0; d < DH / 8; ++d)
      mma::store2(out + (size_t)row * DH + 2 * t + 8 * d, acc[d][2 * i],
                  acc[d][2 * i + 1]);
  }
}

// First delta = rowsum(dO * out) in f32, from the staged dO and out (two
// threads a row), as the reference takes it outside its kernel. Step 1,
// rows are queries (warp w: queries 16 w .. + 15; this thread rows r0
// and r0 + 8): S = Q K^T and dP = dO V^T on the tensor cores, P =
// exp(S scale + mask - rowmax) / rowsum in the reference's op order (no
// zero guard: a fully masked row comes out uniform over the Tk keys), dS =
// P (dP - delta) scale, dQ = dS K with dS as a hi/lo pair from the
// registers. P and dS go to shared memory as hi/lo pairs. Step 2, rows
// are keys (warp w: keys 16 w .. + 15): dV = P^T dO and dK = dS^T Q, P^T
// and dS^T read through ldmatrix .trans. One block writes every output
// of its head, every sum in a fixed order: two calls give the same bits.
template <int DH>
__global__ void __launch_bounds__(kTcThreads) packed_tc_bwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ kv_mask,
    const bf16* __restrict__ dout, const bf16* __restrict__ out,
    bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
    int H, int Tq, int Tk, float scale, int causal) {
  using G = PackedTc<DH>;
  constexpr int P = G::P, PS = kTcPitch, ND = DH / 8, NJ = kTile / 8;
  constexpr int NT = kTcThreads;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);  // [64][P] Q
  bf16* dos = qs + kTile * P;                    // [64][P] dO
  bf16* ks = dos + kTile * P;                    // [64][P] K
  bf16* vs = ks + kTile * P;                     // [64][P] V
  bf16* p_hi = vs + kTile * P;                   // [64][PS] P, hi and lo
  bf16* p_lo = p_hi + kTile * PS;
  bf16* outs = p_hi;                             // [64][P] out, at first
  bf16* ds_hi = p_lo + kTile * PS;               // [64][PS] dS, hi and lo
  bf16* ds_lo = ds_hi + kTile * PS;
  float* mk = reinterpret_cast<float*>(ds_lo + kTile * PS);  // [64]
  float* dl = mk + kTile;                                    // [64]

  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int bh = blockIdx.x, r0 = warp * 16 + g;
  tc_stage_rows<kTile, DH, NT>(q + (size_t)bh * Tq * DH, 0, Tq, qs);
  tc_stage_rows<kTile, DH, NT>(dout + (size_t)bh * Tq * DH, 0, Tq, dos);
  tc_stage_rows<kTile, DH, NT>(k + (size_t)bh * Tk * DH, 0, Tk, ks);
  tc_stage_rows<kTile, DH, NT>(v + (size_t)bh * Tk * DH, 0, Tk, vs);
  tc_stage_rows<kTile, DH, NT>(out + (size_t)bh * Tq * DH, 0, Tq, outs);
  tc_stage_vec<kTile>(kv_mask + (size_t)(bh / H) * Tk, 0, Tk, mk, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // the head's tiles landed
  {
    const int row = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * (DH / 2);
    float d = 0.f;
#pragma unroll 8
    for (int c = c0; c < c0 + DH / 2; ++c)
      d += __bfloat162float(dos[row * P + c]) *
           __bfloat162float(outs[row * P + c]);
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (c0 == 0) dl[row] = d;  // rows past Tq: 0 (dO, out zero-filled)
  }
  __syncthreads();  // delta is written; out's tile is free for P

  // step 1: S, its row max over the quad that holds a row (keys past Tk
  // are no keys), P
  float p[NJ][4], mx[2] = {-INFINITY, -INFINITY};
  score_product<NJ, DH>(qs, warp * 16, ks, p);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int c = 8 * j + 2 * t + (h & 1), row = r0 + 8 * (h >> 1);
      float x = -INFINITY;
      if (c < Tk) {
        x = p[j][h] * scale + (1.f - mk[c]) * kMask;
        if (causal && row < c) x = kMask;
      }
      p[j][h] = x;
      mx[h >> 1] = fmaxf(mx[h >> 1], x);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      p[j][h] = expf(p[j][h] - mx[h >> 1]);
      sum[h >> 1] += p[j][h];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
  }
  // dP[query][key] = dO . v, then dS; rows past Tq weigh nothing
  float ds[NJ][4];
  score_product<NJ, DH>(dos, warp * 16, vs, ds);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i, c = 8 * j + 2 * t;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int h = 2 * i + u;
        p[j][h] = row < Tq ? p[j][h] / sum[i] : 0.f;
        ds[j][h] = p[j][h] * (ds[j][h] - dl[row]) * scale;
      }
      unsigned hi, lo;
      split_bf16(p[j][2 * i], p[j][2 * i + 1], hi, lo);
      *reinterpret_cast<unsigned*>(p_hi + row * PS + c) = hi;
      *reinterpret_cast<unsigned*>(p_lo + row * PS + c) = lo;
      split_bf16(ds[j][2 * i], ds[j][2 * i + 1], hi, lo);
      *reinterpret_cast<unsigned*>(ds_hi + row * PS + c) = hi;
      *reinterpret_cast<unsigned*>(ds_lo + row * PS + c) = lo;
    }
  float acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int h = 0; h < 4; ++h) acc[d][h] = 0.f;
  tile_product<NJ / 2, DH>(ds, ks, acc);  // dQ = dS K
  tc_store_rows<DH>(dq + (size_t)bh * Tq * DH, r0, Tq, acc);
  __syncthreads();  // every warp's P and dS are written

  // step 2: this warp's keys r0 - g .. + 15
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int h = 0; h < 4; ++h) acc[d][h] = 0.f;
  tile_product_t<kTile / 16, DH>(p_hi, p_lo, PS, warp * 16, dos, acc);
  tc_store_rows<DH>(dv + (size_t)bh * Tk * DH, r0, Tk, acc);  // dV = P^T dO
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int h = 0; h < 4; ++h) acc[d][h] = 0.f;
  tile_product_t<kTile / 16, DH>(ds_hi, ds_lo, PS, warp * 16, qs, acc);
  tc_store_rows<DH>(dk + (size_t)bh * Tk * DH, r0, Tk, acc);  // dK = dS^T Q
}

template <int DH>
int launch_tc_bwd(const void* q, const void* k, const void* v,
                  const void* kv_mask, const void* dout, const void* out,
                  void* dq, void* dk, void* dv, int B, int H, int Tq, int Tk,
                  float scale, int causal, cudaStream_t stream) {
  if (Tq > kTile || Tk > kTile) return (int)cudaErrorInvalidValue;
  auto kern = packed_tc_bwd_kernel<DH>;
  if (int e = set_smem(kern, PackedTc<DH>::kSmem)) return e;
  kern<<<B * H, kTcThreads, PackedTc<DH>::kSmem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)kv_mask,
      (const bf16*)dout, (const bf16*)out, (bf16*)dq, (bf16*)dk,
      (bf16*)dv, H, Tq, Tk, scale, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the bf16 forward on the tensor cores: QT query rows a block (64: 4
// warps; 32 up to 32 queries: 2 warps), 64-key tiles, the bf16 library
// only

template <int DH>
struct PackedTcFwd {
  static constexpr int P = DH + 8;  // staged row pitch, bf16
  // one key tile: K and V [64][P], the key mask [64] (bytes)
  static constexpr int kStage = 2 * kTile * P * 2 + kTile * 4;
  // blocks of 128 threads an SM the registers are capped for (twice as
  // many of 64): 80, 96, 166 and 249 registers at Dh 16, 32, 64, 128, no
  // spill; one block more spilled at Dh 32, 64 (12 bytes) and 128
  static constexpr int kBlocks =
      DH == 16 ? 6 : DH == 32 ? 5 : DH == 64 ? 3 : 2;
  // the query tile and one key tile, two past 64 keys (bytes)
  static constexpr size_t smem(int qt, int tk) {
    return (size_t)qt * P * 2 + (tk > kTile ? 2 : 1) * kStage;
  }
  static_assert(kTile * P * 2 + 2 * kStage <= (int)kMaxSmem,
                "shared memory of a block");
};

// Warp w owns query rows q0 + 16 w .. + 15 (this thread r0 and r0 + 8,
// its C fragments' two rows). Each key tile: S = Q K^T on the tensor
// cores, scale, key mask and causal replacement in the reference's
// order (keys past Tk are no keys), the online softmax from -1e30 in
// the registers (a row lies on a quad), O += P V with P as a hi/lo bf16
// pair from the registers. A tile's K and key mask are one cp.async
// group and its V the next, so S is formed while V lands; past 64 keys
// the next tile's two groups fly in the ring's other slot. At the end
// O / l (l >= 1: the row max contributes exp(0)) goes through the warp's
// own rows of Q's tile to 16-byte stores; rows past Tq are not stored.
template <int DH, int QT>
__global__ void __launch_bounds__(2 * QT, PackedTcFwd<DH>::kBlocks * 64 / QT)
    packed_tc_fwd_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const float* __restrict__ kv_mask,
                         bf16* __restrict__ out, int H, int Tq, int Tk,
                         float scale, int causal) {
  using G = PackedTcFwd<DH>;
  constexpr int P = G::P, NT = 2 * QT, ND = DH / 8, NJ = kTile / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);  // [QT][P] Q, then out
  unsigned char* ring = tc_smem + QT * P * 2;   // 2 x {K, V, key mask}

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, q0 = blockIdx.y * QT;
  const int r0 = q0 + warp * 16 + g;
  const float* kvm = kv_mask + (size_t)b * Tk;
  const bf16* kh = k + (size_t)bh * Tk * DH;
  const bf16* vh = v + (size_t)bh * Tk * DH;
  int n_k = (Tk + kTile - 1) / kTile;
  auto slot = [&](int kt) {
    return reinterpret_cast<bf16*>(ring + (kt & 1) * G::kStage);
  };
  // tile kt's K and key mask, then its V: two groups (empty past n_k)
  auto stage_keys = [&](int kt) {
    bf16* s = slot(kt);
    if (kt < n_k) {
      tc_stage_rows<kTile, DH, NT>(kh, kt * kTile, Tk, s);
      tc_stage_vec<kTile>(kvm, kt * kTile, Tk,
                          reinterpret_cast<float*>(s + 2 * kTile * P), 0);
    }
    cp_async_commit();
    if (kt < n_k)
      tc_stage_rows<kTile, DH, NT>(vh, kt * kTile, Tk, s + kTile * P);
    cp_async_commit();
  };
  tc_stage_rows<QT, DH, NT>(q + (size_t)bh * Tq * DH, q0, Tq, qs);
  stage_keys(0);  // Q lands with tile 0's K
  if (causal) {
    // key tiles wholly after every query of the tile weigh exp(-1e9 -
    // max) = 0 when every row sees a live key: one at or before q0
    bool seen = false;
    for (int j = threadIdx.x; j <= q0 && j < Tk; j += NT)
      seen |= kvm[j] != 0.f;
    if (__syncthreads_or(seen)) n_k = min(n_k, (q0 + QT - 1) / kTile + 1);
  }

  float o[ND][4], m[2] = {kStatsInit, kStatsInit}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int h = 0; h < 4; ++h) o[d][h] = 0.f;
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<1>();  // Q, tile kt's K and key mask (its V may fly)
    __syncthreads();     // ... of every thread; tile kt - 1's readers are done
    stage_keys(kt + 1);
    const bf16* ks = slot(kt);
    const bf16* vs = ks + kTile * P;
    const float* mk = reinterpret_cast<const float*>(vs + kTile * P);
    const int k0 = kt * kTile;
    float s[NJ][4];
    score_product<NJ, DH>(qs, warp * 16, ks, s);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int c = 8 * j + 2 * t + (h & 1), col = k0 + c;
        float x = s[j][h] * scale + (1.f - mk[c]) * kMask;
        if (causal && r0 + 8 * (h >> 1) < col) x = kMask;
        s[j][h] = col < Tk ? x : -INFINITY;
        mx[h >> 1] = fmaxf(mx[h >> 1], s[j][h]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        s[j][h] = expf(s[j][h] - m[h >> 1]);
        sum[h >> 1] += s[j][h];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = alpha[i] * l[i] + sum[i];  // the f32 p, not the rounded pair
    }
#pragma unroll
    for (int d = 0; d < ND; ++d)
#pragma unroll
      for (int h = 0; h < 4; ++h) o[d][h] *= alpha[h >> 1];
    cp_async_wait<2>();  // tile kt's V (the next tile's two groups may fly)
    __syncthreads();
    tile_product<NJ / 2, DH>(s, vs, o);  // O += P V, P as a hi/lo pair
  }
  cp_async_wait<0>();
  // every warp read its Q rows before the last tile's barrier
  bf16* os = qs + warp * 16 * P;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int d = 0; d < ND; ++d)
      mma::store2(os + (g + 8 * i) * P + 8 * d + 2 * t, o[d][2 * i] / l[i],
                  o[d][2 * i + 1] / l[i]);
  __syncwarp();
  constexpr int C = DH / 8;  // 16-byte vectors a row
  bf16* oh = out + ((size_t)bh * Tq + q0 + warp * 16) * DH;
#pragma unroll
  for (int i = 0; i < C / 2; ++i) {
    const int u = lane + 32 * i, r = u / C, c = (u % C) * 8;
    if (q0 + warp * 16 + r < Tq)
      *reinterpret_cast<uint4*>(oh + r * DH + c) =
          *reinterpret_cast<const uint4*>(os + r * P + c);
  }
}

template <int DH, int QT>
int launch_tc_fwd(const void* q, const void* k, const void* v,
                  const void* kv_mask, void* out, int B, int H, int Tq,
                  int Tk, float scale, int causal, cudaStream_t stream) {
  const size_t smem = PackedTcFwd<DH>::smem(QT, Tk);
  auto kern = packed_tc_fwd_kernel<DH, QT>;
  if (smem > 48 * 1024) {
    if (int e = set_smem(kern, smem)) return e;
  }
  const dim3 grid(B * H, (Tq + QT - 1) / QT);
  kern<<<grid, 2 * QT, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)kv_mask,
      (bf16*)out, H, Tq, Tk, scale, causal);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_tc_fwd(const void* q, const void* k, const void* v,
                  const void* kv_mask, void* out, int B, int H, int Tq,
                  int Tk, float scale, int causal, int tile,
                  cudaStream_t stream) {
  if (tile == 32)
    return launch_tc_fwd<DH, 32>(q, k, v, kv_mask, out, B, H, Tq, Tk, scale,
                                 causal, stream);
  if (tile == 64)
    return launch_tc_fwd<DH, 64>(q, k, v, kv_mask, out, B, H, Tq, Tk, scale,
                                 causal, stream);
  return (int)cudaErrorInvalidValue;
}
#endif

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, the library's own
// (KERNEL_DTYPE); Dh 16, 32, 64 or 128. kv_mask
// and delta are float32 ([B, Tk] and [B, H, Tq]); dq_sum is float32
// [B, H, Tq, Dh] scratch, needed at Dh 128 past 64 queries or keys (else
// it may be null). bf16 up to 64 queries and keys is the entry
// packed_attention_bwd_tc's. Returns cudaGetLastError() (or the error of
// raising the shared-memory limit; cudaErrorInvalidValue for what it does
// not take).
extern "C" int packed_attention_bwd(const void* q, const void* k,
                                    const void* v, const void* kv_mask,
                                    const void* dout, const void* delta,
                                    void* dq, void* dk, void* dv,
                                    void* dq_sum, int B, int H, int Tq,
                                    int Tk, int Dh, float scale, int causal,
                                    int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define CALL(T, D)                                                        \
  launch_bwd<T, D>(q, k, v, kv_mask, dout, delta, dq, dk, dv, dq_sum, B, \
                   H, Tq, Tk, scale, causal, s)
  switch (dtype * 1000 + Dh) {
#if KERNEL_DTYPE == 0
    case 16: return CALL(float, 16);
    case 32: return CALL(float, 32);
    case 64: return CALL(float, 64);
    case 128: return CALL(float, 128);
#else
    case 1016: return CALL(__nv_bfloat16, 16);
    case 1032: return CALL(__nv_bfloat16, 32);
    case 1064: return CALL(__nv_bfloat16, 64);
    case 1128: return CALL(__nv_bfloat16, 128);
#endif
    default: return (int)cudaErrorInvalidValue;
  }
#undef CALL
}

#if KERNEL_DTYPE == 1
// The bf16 backward on the tensor cores (packed_tc_bwd_kernel), Tq and Tk
// <= 64, Dh 16, 32, 64 or 128, every operand 16-byte aligned: as
// packed_attention_bwd, with the forward's bf16 out [B, H, Tq, Dh] in
// place of delta (the kernel takes delta itself), without the scratch and
// the type flag.
extern "C" int packed_attention_bwd_tc(const void* q, const void* k,
                                       const void* v, const void* kv_mask,
                                       const void* dout, const void* out,
                                       void* dq, void* dk, void* dv, int B,
                                       int H, int Tq, int Tk, int Dh,
                                       float scale, int causal,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define CALL(D)                                                          \
  launch_tc_bwd<D>(q, k, v, kv_mask, dout, out, dq, dk, dv, B, H, Tq, \
                   Tk, scale, causal, s)
  switch (Dh) {
    case 16: return CALL(16);
    case 32: return CALL(32);
    case 64: return CALL(64);
    case 128: return CALL(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CALL
}
#endif

// dtype codes: 0 = float32, 1 = bfloat16, the library's own
// (KERNEL_DTYPE). kv_mask is float32 [B, Tk].
// tile 32 or 64 takes packed_attention_fwd_kernel (float32, Dh 16, 32, 64
// or 128) with that many query rows a block, tile 0
// packed_attention_generic_kernel (any Dh); bf16 at those head sizes is
// the entry packed_attention_fwd_tc's. Returns cudaGetLastError() (or the
// error of raising the shared-memory limit; cudaErrorInvalidValue for
// what it does not take).
extern "C" int packed_attention(const void* q, const void* k, const void* v,
                                const void* kv_mask, void* out, int B, int H,
                                int Tq, int Tk, int Dh, float scale,
                                int causal, int dtype, int tile,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (tile == 0) {
#if KERNEL_DTYPE == 0
    if (dtype == 0)
      return launch_generic<float>(q, k, v, kv_mask, out, B, H, Tq, Tk, Dh,
                                   scale, causal, s);
#else
    if (dtype == 1)
      return launch_generic<__nv_bfloat16>(q, k, v, kv_mask, out, B, H, Tq,
                                           Tk, Dh, scale, causal, s);
#endif
    return (int)cudaErrorInvalidValue;
  }
#if KERNEL_DTYPE == 0
#define CALL(D)                                                            \
  launch_fwd<float, D>(q, k, v, kv_mask, out, B, H, Tq, Tk, scale, causal, \
                       tile, s)
  switch (dtype * 1000 + Dh) {
    case 16: return CALL(16);
    case 32: return CALL(32);
    case 64: return CALL(64);
    case 128: return CALL(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CALL
#else
  return (int)cudaErrorInvalidValue;
#endif
}

#if KERNEL_DTYPE == 1
// The bf16 forward on the tensor cores (packed_tc_fwd_kernel), Dh 16, 32,
// 64 or 128, any Tq and Tk up to the routing cap, q, k, v and out 16-byte
// aligned: as packed_attention, without the type flag; tile 32 or 64
// query rows a block. kv_mask is float32 [B, Tk].
extern "C" int packed_attention_fwd_tc(const void* q, const void* k,
                                       const void* v, const void* kv_mask,
                                       void* out, int B, int H, int Tq,
                                       int Tk, int Dh, float scale,
                                       int causal, int tile, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define CALL(D)                                                          \
  launch_tc_fwd<D>(q, k, v, kv_mask, out, B, H, Tq, Tk, scale, causal, \
                   tile, s)
  switch (Dh) {
    case 16: return CALL(16);
    case 32: return CALL(32);
    case 64: return CALL(64);
    case 128: return CALL(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CALL
}
#endif
