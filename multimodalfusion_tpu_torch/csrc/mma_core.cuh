// The bf16 tensor-core core of the pooling kernels (mil_pool_bwd.cu and
// the bf16 forward of mil_pool_fwd.cu) for Hopper (sm_90a): bf16 x bf16 ->
// f32 products on mma.sync.m16n8k16.
//
// A CTA of 256 threads (8 warps) accumulates a 128 x 128 output tile,
// C[m][n] += sum_k A[m][k] B[k][n], over BK = 32 deep chunks that cp.async
// stages into STAGES = 3 shared-memory buffers (two chunks in flight while
// the third is multiplied).  Each operand of a chunk lies in shared memory
// either k-contiguous, as [128][LDK] (row m or n holds its 32 k values), or
// m- (n-) contiguous, as [BK][LDM] (row k holds 128 m or n values); rows
// are padded by 8 elements so that ldmatrix's eight 16-byte rows fall in
// distinct banks.  Fragments are read with ldmatrix.x4, .trans for an
// operand that lies m- or n-contiguous.  Warp w owns rows 64 (w / 4) ..
// + 63 and columns 32 (w % 4) .. + 31 of the tile: acc[mi][ni][e] holds
// row 64 (w / 4) + 16 mi + g + 8 (e / 2) and column 32 (w % 4) + 8 ni +
// 2 t + (e % 2), lane = 4 g + t.  The tensor cores' f32 sums of a chunk are
// added to acc in a fixed order, so a result is the same on every call.
// mma_loop stages both operands of every chunk; mma_loop_resident takes A
// from a k-contiguous tile that stays in shared memory for the whole loop
// and stages B only.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

constexpr int THREADS = 256;
constexpr int BM = 128;                    // output tile rows and columns
constexpr int BK = 32;                     // depth of a staged chunk
constexpr int STAGES = 3;
constexpr int LDK = BK + 8;                // row stride of a [128][BK] tile
constexpr int LDM = BM + 8;                // row stride of a [BK][128] tile
constexpr int TILE = BM * LDK;             // elements of one operand buffer
constexpr int STAGE_ELEMS = 2 * TILE;      // A, then B
constexpr int SMEM_BYTES = STAGES * STAGE_ELEMS * 2;

static_assert(BK * LDM <= TILE, "a [BK][LDM] tile fits an operand buffer");

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; the bytes past `bytes` (0 .. 16)
// are filled with zeros and not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void zero(float (&acc)[4][4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// The output row and column of acc[mi][ni][e] in the CTA's tile.
__device__ __forceinline__ int row_of(int mi, int e) {
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  return 64 * (warp >> 2) + 16 * mi + g + 8 * (e >> 1);
}
__device__ __forceinline__ int col_of(int ni, int e) {
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 3;
  return 32 * (warp & 3) + 8 * ni + 2 * t + (e & 1);
}

// acc += the chunk's A (As) times B (Bs).  A_K: As is [128 m][lda]
// (k-contiguous; lda = LDK for a staged chunk), else [BK][LDM]
// (m-contiguous); B_K: Bs is [128 n][LDK], else [BK][LDM].
template <bool A_K, bool B_K>
__device__ __forceinline__ void mma_chunk(const bf16* As, const bf16* Bs,
                                          float (&acc)[4][4][4],
                                          int lda = LDK) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m_w = 64 * (warp >> 2), n_w = 32 * (warp & 3);
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t b[4][2];
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      // matrices (n, k): (0, 0), (0, 8), (8, 0), (8, 8) -> b0, b1 of the
      // n8 tile 2 nj, then of 2 nj + 1
      const int n0 = n_w + 16 * nj;
      uint32_t r[4];
      if (B_K) {
        ldmatrix_x4(r, Bs + (n0 + (lane & 7) + 8 * (lane >> 4)) * LDK + kk +
                           8 * ((lane >> 3) & 1));
      } else {
        ldmatrix_x4_trans(r, Bs + (kk + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                      LDM +
                                 n0 + 8 * (lane >> 4));
      }
      b[2 * nj][0] = r[0];
      b[2 * nj][1] = r[1];
      b[2 * nj + 1][0] = r[2];
      b[2 * nj + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      // matrices (m, k): (0, 0), (8, 0), (0, 8), (8, 8) -> a0 .. a3
      const int m0 = m_w + 16 * mi;
      uint32_t a[4];
      if (A_K) {
        ldmatrix_x4(a, As + (m0 + (lane & 15)) * lda + kk + 8 * (lane >> 4));
      } else {
        ldmatrix_x4_trans(a, As + (kk + (lane & 7) + 8 * (lane >> 4)) * LDM +
                                 m0 + 8 * ((lane >> 3) & 1));
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_bf16(acc[mi][ni], a, b[ni][0], b[ni][1]);
    }
  }
}

// The core's pipeline over chunks 0 .. nk - 1 with STAGES buffers of
// `stage` elements each from `smem`: `load(c, buf, s)` issues the cp.async
// copies of chunk c into buffer buf (= smem + s stage); `mul(c, buf)`
// multiplies chunk c once it has landed; `after(c)` runs after chunk c on
// every thread (an epilogue between chunks may use acc and global memory,
// not the buffers).  The last barrier leaves every buffer free for the
// caller.
template <typename Load, typename Mul, typename After>
__device__ __forceinline__ void pipeline(int nk, bf16* smem, int stage,
                                         Load load, Mul mul, After after) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, smem + s * stage, s);
    cp_async_commit();
  }
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c has landed; chunk c - 1's buffer is free
    const int next = c + STAGES - 1;
    if (next < nk) {
      const int s = next % STAGES;
      load(next, smem + s * stage, s);
    }
    cp_async_commit();
    mul(c, smem + (c % STAGES) * stage);
    after(c);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The core's main loop: each buffer holds chunk c's A, then its B
// (STAGE_ELEMS elements); `live(c, s)`, the same on every thread, says
// whether chunk c adds anything (a chunk that is not live is skipped).
template <bool A_K, bool B_K, typename Load, typename Live, typename After>
__device__ __forceinline__ void mma_loop(int nk, bf16* smem, Load load,
                                         Live live, After after,
                                         float (&acc)[4][4][4]) {
  pipeline(nk, smem, STAGE_ELEMS, load,
           [&](int c, const bf16* buf) {
             if (live(c, c % STAGES)) mma_chunk<A_K, B_K>(buf, buf + TILE,
                                                          acc);
           },
           after);
}

// The main loop with A resident: A is [128 m][lda] k-contiguous in shared
// memory (the caller stages it, if at all, through `load`), and chunk c
// multiplies its columns a_k(c) .. + BK - 1; each buffer holds chunk c's
// B only, [128 n][LDK] (TILE elements).
template <typename Load, typename AK, typename After>
__device__ __forceinline__ void mma_loop_resident(int nk, bf16* smem,
                                                  const bf16* A, int lda,
                                                  AK a_k, Load load,
                                                  After after,
                                                  float (&acc)[4][4][4]) {
  pipeline(nk, smem, TILE, load,
           [&](int c, const bf16* buf) {
             mma_chunk<true, true>(A + a_k(c), buf, acc, lda);
           },
           after);
}

// Staging of a [128][BK] k-contiguous operand: row i of the tile is
// src_row(i) (null: zeros), from which the chunk's 32 values at k0 are
// copied to dst + i ld; each thread copies two of the tile's 512 16-byte
// pieces.  A zero-filled piece reads nothing; it names `any`, a valid
// address.
template <typename Row>
__device__ __forceinline__ void stage_k(bf16* dst, Row src_row, int k0,
                                        const bf16* any, int ld = LDK) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int idx = threadIdx.x + THREADS * p;
    const int i = idx >> 2, q = idx & 3;
    const bf16* src = src_row(i);
    cp_async16(dst + i * ld + 8 * q, src ? src + k0 + 8 * q : any,
               src ? 16 : 0);
  }
}

// Staging of a [BK][128] m- (n-) contiguous operand: row kk of the tile
// holds the 128 values from src_row(kk) (null: zeros) at column c0, of
// which those at or past `width` are zeros (`any` as in stage_k).
template <typename Row>
__device__ __forceinline__ void stage_m(bf16* dst, Row src_row, int c0,
                                        int width, const bf16* any) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int idx = threadIdx.x + THREADS * p;
    const int kk = idx >> 4, q = idx & 15;
    const bf16* src = src_row(kk);
    const bool in = src != nullptr && c0 + 8 * q < width;
    cp_async16(dst + kk * LDM + 8 * q, in ? src + c0 + 8 * q : any,
               in ? 16 : 0);
  }
}

}  // namespace mma
