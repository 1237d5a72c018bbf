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
// per (batch, head, 128-query tile) looping over 64-key tiles, dkv one
// block per (batch, head, 128-key tile) looping over 64-query tiles (64-row
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
// the three kernels need not skip the same pairs to agree. Causal grids
// take the heavy (last) query tiles first.
//
// What bounds it on an H100: operations. Per (batch, head) the forward
// does 4*Tq*Tk*Dh flops (the scores and the V product) on 4*T*Dh elements,
// dq 6*Tq*Tk*Dh (scores, dO.V^T, ds.K) and dkv 8*Tq*Tk*Dh (scores, dO.V^T,
// p^T.dO, ds^T.Q): at T = 2048, Dh = 64 that is some 500 flops a byte, far
// past the f32 balance point of the CUDA cores (~20), and causal halves
// it. Everything runs on the f32 CUDA cores (no tensor cores: the port
// trains in f32 with TF32 off).
//
// All three kernels are built so that the FMA units, not shared memory,
// set their pace, from the register-blocked products of
// attention_tiles.cuh: a thread holds an R x 4 fragment of the score tile
// (R = 8 own rows ty + 16i, 4 streamed rows tx + 16j) and R x Dh/16
// accumulators; operand rows are stored with a stride of Dh + 4 floats,
// so the s and dO.V^T products read both operands as float4 along Dh, and
// the score-tile products read p, p^T or ds as float4 along the tile
// (stride 64 + 16: the two rows a warp stores land 16 banks apart)
// against the streamed tile's float4 columns. At Dh 64 that is 8 FMAs for
// every float4 read in each product, twice what the FMA rate needs. The
// streamed tile is staged with 16-byte cp.async into one of two buffers
// while the block computes on the other, so one __syncthreads a tile
// publishes the next stage (bf16 tiles convert through registers; dkv at
// Dh 128 has room for one stage). The forward holds the running max and
// sum of its R rows in registers, reduced over the sixteen lanes of a
// row with four shuffles, rescales its accumulators by exp(m_old - m_new)
// and writes the tile's probabilities to shared memory once for the V
// product (a second __syncthreads). dq recomputes s and dO.V^T and dkv
// does again: 14*Tq*Tk*Dh flops where dq, dk and dv need 10, the price
// of one writer per output (a fused pass would sum dq across key tiles,
// through atomics or a partial per key tile).
//
// Shared memory per block (floats; SD = Dh + 4; own rows O = 128, or 64
// at Dh 128):
//   forward O*SD + O*80 + 2*(2*64*SD + 64)
//                                         (146 KB at Dh 64, 190 KB at 128)
//   dq      2*O*SD + O*80 + 2*O + 2*(2*64*SD + 64)
//                                         (182 KB at Dh 64, 224 KB at 128)
//   dkv     2*O*SD + 2*O*80 + O + stages*(2*64*SD + 128)
//                                         (223 KB at Dh 64, 177 KB at 128)
// each above 48 KB, so every launch raises the dynamic limit first; one
// block fits an SM (__launch_bounds__(256, 1)).
//
// The bf16 forward, dq and dkv on the tensor cores (the bf16 library
// only: flash_tc_fwd_kernel, flash_tc_dq_kernel and flash_tc_dkv_kernel,
// entries flash_attention_fwd_tc, flash_attention_dq_tc and
// flash_attention_dkv_tc) take every bf16 call with q, k, v (and dO, dq,
// dk, dv) 16-byte aligned at Dh 16-128 (the wrapper's flash_tc_path);
// other bf16 calls and every f32 call keep the kernels above. They
// replace the same _fwd_kernel, _dq_kernel and _dkv_kernel and keep the
// semantics listed at the top, with the reference's f32 P: the scores
// come out of mma.sync m16n8k16 (mma_tiles.cuh, through the tiles of
// attention_mma.cuh) as exact bf16 products summed in f32, and P (dq: dS;
// dkv: P^T and dS^T) enters the second product from the score
// accumulators' registers as a hi/lo bf16 pair, hi = bf16(p), lo = bf16(p
// - hi), two products on the same operand fragments, so it keeps p to
// 2^-16 where one rounding (SDPA's) puts 2^-9 on every weight; the
// running sum l adds the f32 p. Each streamed tile's products start from
// 0 and are added into the f32 accumulators with round-to-nearest adds
// (the tensor cores' own sums truncate: the two-level accumulation of
// mma_tiles.cuh). What bounds them on an H100: operations at the bf16
// tensor-core peak, 4 B.H.Tq.Tk.Dh flops for the forward, 6 for dq and 8
// for dkv, of which the hi/lo split makes 6, 8 and 12 on the tensor
// cores; in practice mma.sync's rate, with the softmax's exp on the CUDA
// cores beside it. A block is 8 warps of 16 own rows (128 query rows in
// the forward and dq; 128 keys in dkv, held transposed so P^T and dS^T
// are A operands); the streamed tiles (64 keys; dkv 64 queries, 16 at Dh
// 128) cycle through a three-slot cp.async ring with rows padded by 16
// bytes for conflict-free ldmatrix, V (forward), K (dq), Q and dO (dkv)
// read through ldmatrix .trans where they are the B operand of the
// second product. One block writes each output row: no atomics, two
// calls give the same bits. The forward runs two blocks an SM up to Dh
// 32 and one at Dh 64 and 128 (two spilled at Dh 64 under 128
// registers); dq, which holds dP beside P, one at every head size.

#include "attention_tiles.cuh"
#if KERNEL_DTYPE == 1
#include "mma_tiles.cuh"
#include "attention_mma.cuh"
#endif

namespace {

using namespace attn;

template <int DH>
struct Flash {
  static constexpr int kOwn = DH <= 64 ? 128 : 64;  // rows a block owns
  static constexpr int R = kOwn / 16;               // own rows a thread
  static constexpr int SD = DH + 4;                 // operand row stride
  static constexpr int NF = DH / 16;                // output columns a thread
  // stages of the streamed tile: two (prefetch the next while computing
  // this one) where they fit the 227 KB a block may take, which dkv's
  // do not at Dh 128
  static constexpr int kDkvStages = DH == 128 ? 1 : 2;
  // floats of one streamed stage: forward and dq K, V and the key mask;
  // dkv Q, dO, lse and delta
  static constexpr int kKeyStage = 2 * kSTile * SD + kSTile;
  static constexpr int kDkvStage = 2 * kSTile * SD + 2 * kSTile;
  static constexpr int kFwdFloats = kOwn * SD + kOwn * kBPS + 2 * kKeyStage;
  static constexpr int kDqFloats =
      2 * kOwn * SD + kOwn * kBPS + 2 * kOwn + 2 * kKeyStage;
  static constexpr int kDkvFloats =
      2 * kOwn * SD + 2 * kOwn * kBPS + kDkvStages * kDkvStage + kOwn;
  static_assert(kFwdFloats * 4 <= kMaxSmem && kDqFloats * 4 <= kMaxSmem &&
                    kDkvFloats * 4 <= kMaxSmem,
                "shared memory of a block");
};

// ---------------------------------------------------------------------------
// forward: grid (query tiles of kOwn, B*H); causal calls take the last
// (heavy) query tiles first

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ kv_mask, T* __restrict__ out,
    float* __restrict__ lse, int H, int Tq, int Tk, float scale, int causal) {
  using G = Flash<DH>;
  constexpr int BQ = G::kOwn, R = G::R, SD = G::SD, NF = G::NF;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [BQ][SD]
  float* ps = qs + BQ * SD;                      // [BQ][kBPS] p of the tile
  float* stream = ps + BQ * kBPS;                // 2 x {K, V, key mask}
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
  auto stage_keys = [&](int kt, int buf) {
    float* s = stream + buf * G::kKeyStage;
    stage_rows<kSTile, DH>(kh, kt * kSTile, Tk, s);
    stage_rows<kSTile, DH>(vh, kt * kSTile, Tk, s + kSTile * SD);
    stage_vec(kvm, kt * kSTile, Tk, s + 2 * kSTile * SD, 0);
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
  // key tiles wholly in the future of every row, rows that all see a
  // live key: they would weigh exp(-1e9 - m) = 0
  int n_k = (Tk + kSTile - 1) / kSTile;
  if (causal && q0 >= first) n_k = min(n_k, (q0 + BQ - 1) / kSTile + 1);
  stage_keys(0, 0);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kSTile, buf = kt & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kt landed; the previous tile's readers are done
    if (kt + 1 < n_k) stage_keys(kt + 1, buf ^ 1);
    const float* ks = stream + buf * G::kKeyStage;
    const float* vs = ks + kSTile * SD;
    const float* mk = vs + kSTile * SD;
    float s[R][4];
    dot_rows<R, DH>(qs, ks, s);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
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
    apply_rows<R, DH>(ps, vs, acc);
  }
  cp_async_wait_all();
  const size_t obase = (size_t)bh * Tq;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int f = 0; f < NF; ++f)
      out[(obase + row) * DH + out_col<DH>(f)] = from_f32<T>(acc[i][f] / ls);
    if (tx == 0) lse[obase + row] = m[i] + logf(ls);
  }
}

template <typename Kernel>
int prepare(Kernel kern, size_t smem, int B, int H) {
  if ((size_t)B * H > 65535) return (int)cudaErrorInvalidValue;
  return set_smem(kern, smem);
}

template <typename T, int DH>
int launch_fwd(const void* q, const void* k, const void* v, const void* kvm,
               void* out, void* lse, int B, int H, int Tq, int Tk,
               float scale, int causal, cudaStream_t stream) {
  using G = Flash<DH>;
  const size_t smem = G::kFwdFloats * sizeof(float);
  auto kern = flash_fwd_kernel<T, DH>;
  if (int e = prepare(kern, smem, B, H)) return e;
  const dim3 grid((Tq + G::kOwn - 1) / G::kOwn, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)kvm, (T*)out,
      (float*)lse, H, Tq, Tk, scale, causal);
  return (int)cudaGetLastError();
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
  using G = Flash<DH>;
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
    float* s = stream + buf * G::kKeyStage;
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
    const float* ks = stream + buf * G::kKeyStage;
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
  using G = Flash<DH>;
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
  using G = Flash<DH>;
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
  using G = Flash<DH>;
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

// one instance per head size of the library's dtype (KERNEL_DTYPE): 0 =
// float32, 1 = bfloat16
#if KERNEL_DTYPE == 0
#define FLASH_T float
#else
#define FLASH_T __nv_bfloat16
#endif
#define FLASH_DISPATCH(CALL)                                     \
  if (dtype != KERNEL_DTYPE) return (int)cudaErrorInvalidValue;  \
  switch (Dh) {                                                  \
    case 16: return CALL(FLASH_T, 16);                           \
    case 32: return CALL(FLASH_T, 32);                           \
    case 64: return CALL(FLASH_T, 64);                           \
    case 128: return CALL(FLASH_T, 128);                         \
    default: return (int)cudaErrorInvalidValue;                  \
  }

}  // namespace

#if KERNEL_DTYPE == 1
// ---------------------------------------------------------------------------
// the bf16 forward, dq and dkv on the tensor cores (attention_mma.cuh's
// tiles on mma_tiles.cuh's mma.sync m16n8k16 primitives; the bf16 library
// only)

namespace {

// A block is 8 warps of 16 own rows (query rows in the forward, keys in
// dkv); staged rows are padded by 16 bytes, so the eight rows an ldmatrix
// reads fall on distinct banks. Shared memory in bytes.
template <int DH>
struct FlashTc {
  static constexpr int P = DH + 8;       // staged row pitch, bf16 values
  static constexpr int NK = DH / 16;     // k16 steps over Dh
  static constexpr int ND = DH / 8;      // n8 fragments over Dh
  static constexpr int kStages = 3;      // slots of the cp.async ring
  static constexpr int kRows = 128;      // own rows a block
  // forward: 64-key tiles of K, V and the key mask
  static constexpr int kKeys = 64;
  static constexpr int kFwdStage = 2 * kKeys * P * 2 + kKeys * 4;
  static constexpr int kFwdSmem = kRows * P * 2 + kStages * kFwdStage;
  // two blocks an SM (128 registers a thread) up to Dh 32; at Dh 64 the
  // cap spilled (4 bytes), so one block of up to 255
  static constexpr int kFwdBlocks = DH <= 32 ? 2 : 1;
  // dkv: query tiles of Q, dO, lse and delta (16 rows at Dh 128, where
  // the dk and dv accumulators take 128 registers: 32 rows spilled)
  static constexpr int kQT = DH == 128 ? 16 : 64;
  static constexpr int kDkvStage = 2 * kQT * P * 2 + 2 * kQT * 4;
  static constexpr int kDkvSmem = 2 * kRows * P * 2 + kStages * kDkvStage;
  // dq: Q and dO staged once, the forward's 64-key stages of K, V and the
  // key mask
  static constexpr int kDqSmem = 2 * kRows * P * 2 + kStages * kFwdStage;
  static_assert(kFwdSmem <= (int)kMaxSmem && kDkvSmem <= (int)kMaxSmem &&
                    kDqSmem <= (int)kMaxSmem,
                "shared memory of a block");
};

// forward: grid (query tiles of 128, B*H); causal calls take the last
// (heavy) query tiles first. Warp w owns query rows q0 + 16 w .. + 15;
// this thread rows r0 and r0 + 8 (its C fragments' two rows).
template <int DH>
__global__ void __launch_bounds__(kThreads, FlashTc<DH>::kFwdBlocks)
    flash_tc_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const float* __restrict__ kv_mask,
                        bf16* __restrict__ out, float* __restrict__ lse,
                        int H, int Tq, int Tk, float scale, int causal) {
  using G = FlashTc<DH>;
  constexpr int BQ = G::kRows, BK = G::kKeys, P = G::P, S = G::kStages;
  constexpr int ND = G::ND, NJ = BK / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);  // [BQ][P]
  unsigned char* ring = tc_smem + BQ * P * 2;   // S x {K, V, key mask}
  __shared__ int first_slot;

  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int bh = blockIdx.y, b = bh / H;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ, r0 = q0 + warp * 16 + g;
  const float* kvm = kv_mask + (size_t)b * Tk;
  const bf16* kh = k + (size_t)bh * Tk * DH;
  const bf16* vh = v + (size_t)bh * Tk * DH;
  const int first = first_live_key(kvm, Tk, causal, &first_slot);
  // key tiles wholly in the future of every row, rows that all see a
  // live key: they would weigh exp(-1e9 - m) = 0
  int n_k = (Tk + BK - 1) / BK;
  if (causal && q0 >= first) n_k = min(n_k, (q0 + BQ - 1) / BK + 1);
  auto slot = [&](int kt) {
    return reinterpret_cast<bf16*>(ring + (kt % S) * G::kFwdStage);
  };
  auto stage_keys = [&](int kt) {
    bf16* s = slot(kt);
    tc_stage_rows<BK, DH>(kh, kt * BK, Tk, s);
    tc_stage_rows<BK, DH>(vh, kt * BK, Tk, s + BK * P);
    tc_stage_vec<BK>(kvm, kt * BK, Tk, reinterpret_cast<float*>(s + 2 * BK * P),
                     0);
  };
  tc_stage_rows<BQ, DH>(q + (size_t)bh * Tq * DH, q0, Tq, qs);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < n_k) stage_keys(st);
    cp_async_commit();
  }

  float o[ND][4], m[2] = {kStatsInit, kStatsInit}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int h = 0; h < 4; ++h) o[d][h] = 0.f;
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<S - 2>();
    __syncthreads();  // tile kt landed; tile kt - 1's readers are done
    if (kt + S - 1 < n_k) stage_keys(kt + S - 1);
    cp_async_commit();
    const bf16* ks = slot(kt);
    const bf16* vs = ks + BK * P;
    const float* mk = reinterpret_cast<const float*>(vs + BK * P);
    const int k0 = kt * BK;
    float s[NJ][4];
    score_product<NJ, DH>(qs, warp * 16, ks, s);
    // scale, then the key mask and the causal replacement, in the
    // reference's order; keys past Tk are no keys
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
    // a row lies on a quad (lane % 4): two shuffles
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
    tile_product<NJ / 2, DH>(s, vs, o);  // O += P V, P as a hi/lo pair
  }
  cp_async_wait<0>();
  const size_t obase = (size_t)bh * Tq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= Tq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
    bf16* orow = out + (obase + row) * DH + 2 * t;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      mma::store2(orow + 8 * d, o[d][2 * i] / ls, o[d][2 * i + 1] / ls);
    if (t == 0) lse[obase + row] = m[i] + logf(ls);
  }
}

// dkv: grid (key tiles of 128, B*H). The tiles are held transposed, keys
// in the rows: S^T = K Q^T, P^T = exp(S^T scale + mask - lse), dP^T = V
// dO^T, dS^T = P^T (dP^T - delta) scale, so P^T and dS^T feed dV += P^T dO
// and dK += dS^T Q from registers (Q and dO through ldmatrix .trans).
// Warp w owns keys k0 + 16 w .. + 15; this thread keys key0 and key0 + 8.
template <int DH>
__global__ void __launch_bounds__(kThreads, 1) flash_tc_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ kv_mask,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int H, int Tq, int Tk, float scale, int causal) {
  using G = FlashTc<DH>;
  constexpr int BK = G::kRows, QT = G::kQT, P = G::P, S = G::kStages;
  constexpr int ND = G::ND, NJ = QT / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* ks = reinterpret_cast<bf16*>(tc_smem);  // [BK][P]
  bf16* vs = ks + BK * P;                        // [BK][P]
  // S x {Q [QT][P], dO [QT][P], lse [QT], delta [QT]}
  unsigned char* ring = reinterpret_cast<unsigned char*>(vs + BK * P);
  __shared__ int first_slot;

  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int bh = blockIdx.y, b = bh / H, k0 = blockIdx.x * BK;
  const int key0 = k0 + warp * 16 + g;
  const float* kvm = kv_mask + (size_t)b * Tk;
  const bf16* qh = q + (size_t)bh * Tq * DH;
  const bf16* doh = dout + (size_t)bh * Tq * DH;
  const float* lseh = lse + (size_t)bh * Tq;
  const float* dlh = delta + (size_t)bh * Tq;
  const int first = first_live_key(kvm, Tk, causal, &first_slot);
  tc_stage_rows<BK, DH>(k + (size_t)bh * Tk * DH, k0, Tk, ks);
  tc_stage_rows<BK, DH>(v + (size_t)bh * Tk * DH, k0, Tk, vs);
  cp_async_commit();
  // query tiles [skip0, skip1) lie wholly before this key tile and their
  // rows all see a live key (at or after the batch row's first live key):
  // p = 0 there, so they are skipped
  const int n_q = (Tq + QT - 1) / QT;
  int skip0 = n_q, skip1 = n_q;
  if (causal) {
    skip0 = min(n_q, (first + QT - 1) / QT);
    skip1 = max(skip0, min(n_q, k0 / QT));
  }
  const int n_it = n_q - (skip1 - skip0);
  auto tile = [&](int i) { return i < skip0 ? i : i + skip1 - skip0; };
  auto slot = [&](int i) {
    return reinterpret_cast<bf16*>(ring + (i % S) * G::kDkvStage);
  };
  auto stage_queries = [&](int i) {
    bf16* s = slot(i);
    const int q0 = tile(i) * QT;
    tc_stage_rows<QT, DH>(qh, q0, Tq, s);
    tc_stage_rows<QT, DH>(doh, q0, Tq, s + QT * P);
    float* f = reinterpret_cast<float*>(s + 2 * QT * P);
    tc_stage_vec<QT>(lseh, q0, Tq, f, 0);
    tc_stage_vec<QT>(dlh, q0, Tq, f + QT, QT);
  };
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < n_it) stage_queries(st);
    cp_async_commit();
  }
  float bias[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    bias[i] = key < Tk ? (1.f - kvm[key]) * kMask : 0.f;
  }
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int h = 0; h < 4; ++h) dka[d][h] = dva[d][h] = 0.f;
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<S - 2>();
    __syncthreads();  // tile it (and K, V) landed; it - 1's readers done
    if (it + S - 1 < n_it) stage_queries(it + S - 1);
    cp_async_commit();
    const int q0 = tile(it) * QT;
    const bf16* qs = slot(it);
    const bf16* dos = qs + QT * P;
    const float* lse_s = reinterpret_cast<const float*>(dos + QT * P);
    const float* dl_s = lse_s + QT;
    float pt[NJ][4];
    // S^T[key][query] = k . q
    score_product<NJ, DH, DH == 128>(ks, warp * 16, qs, pt);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int c = 8 * j + 2 * t + (h & 1), row = q0 + c;
        const int key = key0 + 8 * (h >> 1);
        float x = pt[j][h] * scale + bias[h >> 1];
        if (causal && row < key) x = kMask;
        pt[j][h] = row < Tq && key < Tk ? expf(x - lse_s[c]) : 0.f;
      }
    tile_product<NJ / 2, DH>(pt, dos, dva);  // dV += P^T dO
    float ds[NJ][4];
    // dP^T[key][query] = v . dO
    score_product<NJ, DH, DH == 128>(vs, warp * 16, dos, ds);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int c = 8 * j + 2 * t + (h & 1);
        ds[j][h] = pt[j][h] * (ds[j][h] - dl_s[c]) * scale;
      }
    tile_product<NJ / 2, DH>(ds, qs, dka);  // dK += dS^T Q
  }
  cp_async_wait<0>();  // K and V, when no query tile was left
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= Tk) continue;
    const size_t at = ((size_t)bh * Tk + key) * DH + 2 * t;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      mma::store2(dk + at + 8 * d, dka[d][2 * i], dka[d][2 * i + 1]);
      mma::store2(dv + at + 8 * d, dva[d][2 * i], dva[d][2 * i + 1]);
    }
  }
}

// dq: grid (query tiles of 128, B*H); causal calls take the last (heavy)
// query tiles first. The forward's geometry: Q and dO are staged once,
// the 64-key tiles of K, V and the key mask stream through the ring; per
// tile S = Q K^T, P = exp(S scale + mask - lse), dP = dO V^T, dS = P (dP
// - delta) scale, and dQ += dS K with dS as a hi/lo pair from the
// registers (K through ldmatrix .trans). Warp w owns query rows q0 + 16 w
// .. + 15; this thread rows r0 and r0 + 8.
template <int DH>
__global__ void __launch_bounds__(kThreads, 1) flash_tc_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ kv_mask,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int H, int Tq,
    int Tk, float scale, int causal) {
  using G = FlashTc<DH>;
  constexpr int BQ = G::kRows, BK = G::kKeys, P = G::P, S = G::kStages;
  constexpr int ND = G::ND, NJ = BK / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);  // [BQ][P]
  bf16* dos = qs + BQ * P;                       // [BQ][P]
  // S x {K, V, key mask}
  unsigned char* ring = reinterpret_cast<unsigned char*>(dos + BQ * P);
  __shared__ int first_slot;

  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int bh = blockIdx.y, b = bh / H;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ, r0 = q0 + warp * 16 + g;
  const float* kvm = kv_mask + (size_t)b * Tk;
  const bf16* kh = k + (size_t)bh * Tk * DH;
  const bf16* vh = v + (size_t)bh * Tk * DH;
  const int first = first_live_key(kvm, Tk, causal, &first_slot);
  // key tiles wholly in the future of every row, rows that all see a
  // live key: their p is exp(-1e9 - lse) = 0
  int n_k = (Tk + BK - 1) / BK;
  if (causal && q0 >= first) n_k = min(n_k, (q0 + BQ - 1) / BK + 1);
  auto slot = [&](int kt) {
    return reinterpret_cast<bf16*>(ring + (kt % S) * G::kFwdStage);
  };
  auto stage_keys = [&](int kt) {
    bf16* s = slot(kt);
    tc_stage_rows<BK, DH>(kh, kt * BK, Tk, s);
    tc_stage_rows<BK, DH>(vh, kt * BK, Tk, s + BK * P);
    tc_stage_vec<BK>(kvm, kt * BK, Tk, reinterpret_cast<float*>(s + 2 * BK * P),
                     0);
  };
  tc_stage_rows<BQ, DH>(q + (size_t)bh * Tq * DH, q0, Tq, qs);
  tc_stage_rows<BQ, DH>(dout + (size_t)bh * Tq * DH, q0, Tq, dos);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < n_k) stage_keys(st);
    cp_async_commit();
  }
  float ls[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    ls[i] = row < Tq ? lse[(size_t)bh * Tq + row] : 0.f;
    dl[i] = row < Tq ? delta[(size_t)bh * Tq + row] : 0.f;
  }
  float dqa[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int h = 0; h < 4; ++h) dqa[d][h] = 0.f;
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<S - 2>();
    __syncthreads();  // tile kt (and Q, dO) landed; kt - 1's readers done
    if (kt + S - 1 < n_k) stage_keys(kt + S - 1);
    cp_async_commit();
    const bf16* ks = slot(kt);
    const bf16* vs = ks + BK * P;
    const float* mk = reinterpret_cast<const float*>(vs + BK * P);
    const int k0 = kt * BK;
    float p[NJ][4];
    score_product<NJ, DH, DH == 128>(qs, warp * 16, ks, p);
    // scale, then the key mask and the causal replacement, in the
    // reference's order; rows past Tq and keys past Tk weigh nothing
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int c = 8 * j + 2 * t + (h & 1), col = k0 + c;
        const int row = r0 + 8 * (h >> 1);
        float x = p[j][h] * scale + (1.f - mk[c]) * kMask;
        if (causal && row < col) x = kMask;
        p[j][h] = row < Tq && col < Tk ? expf(x - ls[h >> 1]) : 0.f;
      }
    float ds[NJ][4];
    // dP[query][key] = dO . v
    score_product<NJ, DH, DH == 128>(dos, warp * 16, vs, ds);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h)
        ds[j][h] = p[j][h] * (ds[j][h] - dl[h >> 1]) * scale;
    tile_product<NJ / 2, DH>(ds, ks, dqa);  // dQ += dS K, dS as a hi/lo pair
  }
  cp_async_wait<0>();  // Q and dO, when no key tile was left
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= Tq) continue;
    bf16* drow = dq + ((size_t)bh * Tq + row) * DH + 2 * t;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      mma::store2(drow + 8 * d, dqa[d][2 * i], dqa[d][2 * i + 1]);
  }
}

template <int DH>
int launch_tc_fwd(const void* q, const void* k, const void* v,
                  const void* kvm, void* out, void* lse, int B, int H, int Tq,
                  int Tk, float scale, int causal, cudaStream_t stream) {
  using G = FlashTc<DH>;
  auto kern = flash_tc_fwd_kernel<DH>;
  if (int e = prepare(kern, G::kFwdSmem, B, H)) return e;
  const dim3 grid((Tq + G::kRows - 1) / G::kRows, B * H);
  kern<<<grid, kThreads, G::kFwdSmem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)kvm,
      (bf16*)out, (float*)lse, H, Tq, Tk, scale, causal);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_tc_dkv(const void* q, const void* k, const void* v,
                  const void* kvm, const void* dout, const void* lse,
                  const void* delta, void* dk, void* dv, int B, int H, int Tq,
                  int Tk, float scale, int causal, cudaStream_t stream) {
  using G = FlashTc<DH>;
  auto kern = flash_tc_dkv_kernel<DH>;
  if (int e = prepare(kern, G::kDkvSmem, B, H)) return e;
  const dim3 grid((Tk + G::kRows - 1) / G::kRows, B * H);
  kern<<<grid, kThreads, G::kDkvSmem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)kvm,
      (const bf16*)dout, (const float*)lse, (const float*)delta, (bf16*)dk,
      (bf16*)dv, H, Tq, Tk, scale, causal);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_tc_dq(const void* q, const void* k, const void* v,
                 const void* kvm, const void* dout, const void* lse,
                 const void* delta, void* dq, int B, int H, int Tq, int Tk,
                 float scale, int causal, cudaStream_t stream) {
  using G = FlashTc<DH>;
  auto kern = flash_tc_dq_kernel<DH>;
  if (int e = prepare(kern, G::kDqSmem, B, H)) return e;
  const dim3 grid((Tq + G::kRows - 1) / G::kRows, B * H);
  kern<<<grid, kThreads, G::kDqSmem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)kvm,
      (const bf16*)dout, (const float*)lse, (const float*)delta, (bf16*)dq,
      H, Tq, Tk, scale, causal);
  return (int)cudaGetLastError();
}

#define FLASH_TC_DISPATCH(CALL)                  \
  switch (Dh) {                                  \
    case 16: return CALL(16);                    \
    case 32: return CALL(32);                    \
    case 64: return CALL(64);                    \
    case 128: return CALL(128);                  \
    default: return (int)cudaErrorInvalidValue;  \
  }

}  // namespace
#endif

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

#if KERNEL_DTYPE == 1
// The bf16 forward, dq and dkv on the tensor cores, for q, k, v (and dO,
// dq, dk, dv) 16-byte aligned (the wrapper's flash_tc_path): as
// flash_attention_fwd, flash_attention_dq and flash_attention_dkv, without
// the type flag.
extern "C" int flash_attention_fwd_tc(const void* q, const void* k,
                                      const void* v, const void* kv_mask,
                                      void* out, void* lse, int B, int H,
                                      int Tq, int Tk, int Dh, float scale,
                                      int causal, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define CALL(D) \
  launch_tc_fwd<D>(q, k, v, kv_mask, out, lse, B, H, Tq, Tk, scale, causal, s)
  FLASH_TC_DISPATCH(CALL)
#undef CALL
}

extern "C" int flash_attention_dq_tc(const void* q, const void* k,
                                     const void* v, const void* kv_mask,
                                     const void* dout, const void* lse,
                                     const void* delta, void* dq, int B,
                                     int H, int Tq, int Tk, int Dh,
                                     float scale, int causal, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define CALL(D)                                                         \
  launch_tc_dq<D>(q, k, v, kv_mask, dout, lse, delta, dq, B, H, Tq, Tk, \
                  scale, causal, s)
  FLASH_TC_DISPATCH(CALL)
#undef CALL
}

extern "C" int flash_attention_dkv_tc(const void* q, const void* k,
                                      const void* v, const void* kv_mask,
                                      const void* dout, const void* lse,
                                      const void* delta, void* dk, void* dv,
                                      int B, int H, int Tq, int Tk, int Dh,
                                      float scale, int causal, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define CALL(D)                                                           \
  launch_tc_dkv<D>(q, k, v, kv_mask, dout, lse, delta, dk, dv, B, H, Tq, \
                   Tk, scale, causal, s)
  FLASH_TC_DISPATCH(CALL)
#undef CALL
}
#endif
