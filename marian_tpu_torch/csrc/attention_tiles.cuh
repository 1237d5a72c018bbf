// Register-blocked f32 tile products shared by the attention kernels
// (flash_attention.cu and packed_attention.cu; decode_attention.cu and
// paged_decode_attention.cu take its cp.async and conversion helpers and
// the 16-byte vector stream's Vec16 and group_sum).
//
// A block of NT threads (256 unless a kernel says otherwise) is a
// NT/16 x 16 grid: thread (ty, tx) holds own rows ty + (NT/16)i (i < R)
// of a score tile against streamed rows tx + 16j (j < 4), and output
// columns out_col(f) (f < Dh/16) of its own rows' products. Operand rows
// are stored with a stride of Dh + 4 floats, so dot_rows reads both
// operands as float4 along Dh (the two own rows a warp reads are
// broadcast, its sixteen streamed rows fall on distinct banks) and
// apply_rows reads a score tile as float4 along its 64 columns against
// the streamed tile's float4 columns: at Dh 64 and R = 8 that is 8 FMAs
// for every float4 read. Operand tiles are staged with 16-byte
// cp.async (bf16 converts through registers). Every sum runs in a fixed
// order, so two calls give the same bits.
//
// The kernels' libraries are hashed with this header (ops/kernels/
// _build.py), so an edit here rebuilds them all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

// The operand type of a library built from a source whose entry points
// each take one (packed_attention.cu, flash_attention.cu, fused_ce.cu):
// the build compiles such a source twice, in parallel, with KERNEL_DTYPE
// 0 (float32) and 1 (bfloat16); a library returns cudaErrorInvalidValue
// for the other type.
#ifndef KERNEL_DTYPE
#define KERNEL_DTYPE 0
#endif

namespace attn {

constexpr int kThreads = 256;      // 16 x 16
constexpr int kSTile = 64;         // rows of a streamed tile
constexpr int kBPS = kSTile + 16;  // stride of a [own][64] score tile
constexpr float kMask = -1e9f;
constexpr float kStatsInit = -1e30f;
constexpr size_t kMaxSmem = 232448;  // bytes a Hopper block may take

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
// waits until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the values of one 16-byte vector of T (the decode kernels' streams)
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int E = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* x) {
    x[0] = __uint_as_float(u.x);
    x[1] = __uint_as_float(u.y);
    x[2] = __uint_as_float(u.z);
    x[3] = __uint_as_float(u.w);
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* x) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    const float2 c =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.z));
    const float2 d =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.w));
    x[0] = a.x, x[1] = a.y, x[2] = b.x, x[3] = b.y;
    x[4] = c.x, x[5] = c.y, x[6] = d.x, x[7] = d.y;
  }
};

// the sum over the G lanes of an aligned group (every lane of the warp
// takes part; each gets the same bits)
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [row0, row0 + ROWS) of a [rows][DH] matrix into dst[ROWS][DH + 4]
// as f32 by the block's NT threads, rows past `rows` zero: f32 by 16-byte
// cp.async (landed after the next cp_async_wait_all), bf16 converted
// through registers
template <int ROWS, int DH, int NT = kThreads>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           int row0, int rows, float* dst) {
  constexpr int C = DH / 4;
  for (int i = threadIdx.x; i < ROWS * C; i += NT) {
    const int r = i / C, c = (i % C) * 4;
    const bool in = row0 + r < rows;
    cp_async16(dst + r * (DH + 4) + c,
               src + (size_t)(in ? row0 + r : 0) * DH + c, in);
  }
}
template <int ROWS, int DH, int NT = kThreads>
__device__ __forceinline__ void stage_rows(
    const __nv_bfloat16* __restrict__ src, int row0, int rows, float* dst) {
  constexpr int C = DH / 4;
  for (int i = threadIdx.x; i < ROWS * C; i += NT) {
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

// acc[i][j] = sum_d A[ty + RS i][d] * B[tx + 16j][d] (RS = NT / 16),
// d = 0, 1, ... in order (a plain dot product's order): A the block's
// own [RS R][DH + 4] tile, B a streamed [64][DH + 4] tile, both read as
// float4 along d (the two rows of A a warp reads are broadcast, B's
// sixteen rows fill the banks twice over)
template <int R, int DH, int NT = kThreads>
__device__ __forceinline__ void dot_rows(const float* A, const float* B,
                                         float (&acc)[R][4]) {
  constexpr int SD = DH + 4, RS = NT / 16;
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
          *reinterpret_cast<const float4*>(A + (ty + RS * i) * SD + d);
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

// acc[i][f] += sum_c P[ty + RS i][c] * M[c][out_col(f)] (RS = NT / 16)
// and acc2 the same of P2 and M2, c = 0 .. 63 in order: P, P2 [RS R][PS]
// score tiles read as float4 along c, M, M2 streamed [64][DH + 4] tiles
// read along their columns (with kTwo false, one product)
template <int R, int DH, bool kTwo = false, int PS = kBPS,
          int NT = kThreads>
__device__ __forceinline__ void apply_rows(const float* P, const float* M,
                                           float (&acc)[R][DH / 16],
                                           const float* P2 = nullptr,
                                           const float* M2 = nullptr,
                                           float (*acc2)[DH / 16] = nullptr) {
  constexpr int SD = DH + 4, NF = DH / 16, RS = NT / 16;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int c = 0; c < kSTile; c += 4) {
    float4 p[R], p2[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      p[i] = *reinterpret_cast<const float4*>(P + (ty + RS * i) * PS + c);
      if (kTwo)
        p2[i] =
            *reinterpret_cast<const float4*>(P2 + (ty + RS * i) * PS + c);
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

// raise a kernel's dynamic shared-memory limit to `smem` bytes
template <typename Kernel>
int set_smem(Kernel kern, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace attn
