// The f32 SGEMM core shared by the pooling kernels (mil_pool_fwd.cu,
// mil_pool_bwd.cu) for Hopper (sm_90a).
//
// A CTA of 256 threads accumulates a 128 x 128 output tile, C[m][n] +=
// sum_k A[k][m] B[k][n], over GK-deep chunks staged in shared memory as
// A [GK][S_LD] and B [GK][S_LD] (f32).  Thread (ty, tx) = (tid / 16,
// tid % 16) holds the 8 x 8 block of rows m(i) = 4 ty + (i & 3) + 64 (i >> 2)
// and columns n(j) = 4 tx + (j & 3) + 64 (j >> 2): four 4 x 4 quadrants 64
// apart, so that a warp's float4 reads of a staged row are two broadcasts
// (A) and 16 consecutive float4s (B), free of bank conflicts.  Each output
// element is summed over k in increasing order with fmaf, so a result does
// not depend on how the depth is chunked.  bf16 operands are converted to
// f32 as they are staged (exact).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace sgemm {

constexpr int THREADS = 256;          // 16 x 16 threads, 8 x 8 outputs each
constexpr int GT = 128;               // output tile rows and columns
constexpr int GK = 8;                 // depth of a staged chunk
constexpr int S_LD = GT + 4;          // row stride of a staged chunk
constexpr int STAGE = 2 * GK * S_LD;  // floats of one buffer (A, then B)

// 4 consecutive values as f32: one 16-byte load (f32) or 8-byte load (bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  return make_float4(__bfloat162float(lo.x), __bfloat162float(lo.y),
                     __bfloat162float(hi.x), __bfloat162float(hi.y));
}

// 4 consecutive values to f32 (16-byte store) or bf16 (8-byte store).
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v[0], v[1]);
  q[1] = __floats2bfloat162_rn(v[2], v[3]);
}

// The output row of this thread's i-th row of results (0 <= i < 8).
__device__ __forceinline__ int row_of(int i) {
  return 4 * (threadIdx.x >> 4) + (i & 3) + 64 * (i >> 2);
}

__device__ __forceinline__ void mac_chunk(const float* As, const float* Bs,
                                          float (&acc)[8][8]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int k = 0; k < GK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + k * S_LD + 4 * ty);
    const float4 a1 =
        *reinterpret_cast<const float4*>(As + k * S_LD + 64 + 4 * ty);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * S_LD + 4 * tx);
    const float4 b1 =
        *reinterpret_cast<const float4*>(Bs + k * S_LD + 64 + 4 * tx);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// The core's main loop over chunks 0 .. nk - 1, double-buffered through
// registers: while the CTA multiplies chunk c from one shared buffer, each
// thread holds its share of chunk c + 1 (loaded by `fetch`) in registers,
// then `put` stores it into the other buffer; one barrier per chunk.
// `fetch(c, ra, rb)` returns whether its rows of chunk c are live; a chunk
// that no thread calls live holds only exact zeros in B and is skipped.
// The last barrier leaves both buffers free for the next call.
template <typename Fetch, typename Put>
__device__ __forceinline__ void sgemm_loop(int nk, float* smem, Fetch fetch,
                                           Put put, float (&acc)[8][8]) {
  float4 ra, rb;
  bool live = fetch(0, ra, rb);
  put(smem, ra, rb);
  live = __syncthreads_or(live);
  for (int c = 0; c < nk; ++c) {
    float* cur = smem + (c & 1) * STAGE;
    bool next = false;
    if (c + 1 < nk) next = fetch(c + 1, ra, rb);
    if (live) mac_chunk(cur, cur + GK * S_LD, acc);
    if (c + 1 < nk) put(smem + ((c + 1) & 1) * STAGE, ra, rb);
    live = __syncthreads_or(next);
  }
}

// Staging of an operand that lies as [rows][depth] (A = rows of a 128-row
// tile, transposed into As[k][m]): thread tid loads depth 4 (tid & 1) .. + 3
// of tile row tid / 2.  The two depth halves land 16 banks apart (S_LD % 32
// == 4), so the scalar stores are free of bank conflicts.
__device__ __forceinline__ void put_transposed(float* As, const float4& v) {
  const int r = threadIdx.x >> 1, k = 4 * (threadIdx.x & 1);
  As[(k + 0) * S_LD + r] = v.x;
  As[(k + 1) * S_LD + r] = v.y;
  As[(k + 2) * S_LD + r] = v.z;
  As[(k + 3) * S_LD + r] = v.w;
}

// Staging of an operand that lies as [depth][columns]: thread tid stores
// columns 4 (tid & 31) .. + 3 of depth row tid / 32.
__device__ __forceinline__ void put_rows(float* Xs, const float4& v) {
  *reinterpret_cast<float4*>(Xs + (threadIdx.x >> 5) * S_LD +
                             4 * (threadIdx.x & 31)) = v;
}

// The attention-branch keep factors of row `row` at 4 columns from col0:
// keep bit * inv_keep of the uint8 masks da, db [rows, Da] (1 without
// dropout; 0 for a row that is not `in` the tile).
template <bool GATED, bool DROPOUT>
__device__ __forceinline__ void keep_factors(const uint8_t* da,
                                             const uint8_t* db, size_t row,
                                             bool in, int col0, int Da,
                                             float inv_keep, float (&fa)[4],
                                             float (&fb)[4]) {
  uchar4 ka = make_uchar4(1, 1, 1, 1), kb = ka;
  float scale = 1.f;
  if (DROPOUT) {
    scale = inv_keep;
    ka = kb = make_uchar4(0, 0, 0, 0);
    if (in) {
      ka = *reinterpret_cast<const uchar4*>(da + row * Da + col0);
      if (GATED) kb = *reinterpret_cast<const uchar4*>(db + row * Da + col0);
    }
  }
  fa[0] = ka.x * scale; fa[1] = ka.y * scale;
  fa[2] = ka.z * scale; fa[3] = ka.w * scale;
  fb[0] = kb.x * scale; fb[1] = kb.y * scale;
  fb[2] = kb.z * scale; fb[3] = kb.w * scale;
}

}  // namespace sgemm
