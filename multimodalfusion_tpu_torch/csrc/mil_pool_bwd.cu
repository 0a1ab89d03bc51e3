// Fused masked attention-MIL pooling, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_pool_bwd_kernel`, launched by
// `_fused_pool_bwd_pallas` in multimodalfusion_tpu/ops/mil_attention.py.
// Given the forward's residuals out [B, D] and ml [B, 2] = (max, normalizer)
// and the cotangent g [B, D] of out, per row i of bag b:
//
//   t = tanh(h_i Wa + ba), u = sigmoid(h_i Wb + bb)        (gated)
//   ta = t * daf, ub = u * dbf, z = ta * ub               (daf, dbf: dropout
//                                                          keep * inv_keep,
//                                                          1 without it)
//   s_i = z . wc + cc, a_i = exp(s_i - m) / l, 0 on masked rows
//   ds_i = a_i (g . h_i - g . out)
//   dpa = ds_i wc * ub * (1 - t^2) * daf, dpb = ds_i wc * ta * u (1 - u) * dbf
//   dh_i = a_i g + dpa Wa^T + dpb Wb^T                     -> dh [B, N, D]
//   dWa = sum h_i^T dpa, dba = sum dpa, dWb, dbb alike, dwc = sum ds_i z
//
// summed over every row of every bag; ungated attention has no u, dpb or
// Wb.  dcc = sum ds_i is analytically 0 (softmax is invariant to a logit
// shift): the wrapper writes an exact 0 and nothing sums it.  A masked row
// gets a = 0 and hence dh = 0 exactly; a fully masked bag (ml = (NEG_INF,
// 0)) gets a = 0 everywhere and adds nothing to any parameter gradient.
//
// Design.  The TPU kernel walks the bags' row tiles in one sequential grid
// and keeps dWa/dWb (256 KiB each at D = Da = 256) resident across it.  On
// the H100 that neither fits one SM's shared memory nor runs in parallel,
// so the work is five kernels over the M = B N flattened rows (row r
// belongs to bag r / N), all deterministic (no float atomics):
//   1. rows: one CTA per 128-row tile.  Pass 1 scores the tile once: the
//      products h [Wa | Wb], 64 columns of Wa and the same 64 of Wb per
//      128-wide chunk, and the epilogue keeps t and u of every row in f32
//      scratch (dp itself for f32 bags) while it sums the scores.  Then
//      s, a and ds per row.  Pass 2 reads t and u back and writes
//      [dpa | dpb] per row in the bag's dtype (as the TPU kernel casts
//      them before its products; for f32 bags in place over t and u), and
//      the tile's column sums of dpa, dpb and z * ds.  Tiles whose rows
//      are all padding write zeros and return.
//   2. dh: dh = a g + [dpa | dpb] [Wa^T; Wb^T], masked rows written as
//      exact zeros.
//   3. dW: split-K over the rows, h^T [dpa | dpb], one partial per split
//      (the splits fill one wave of the card); chunks whose rows are all
//      padding are skipped.
//   4. and 5. reduce: the tiles' column sums in fixed groups of VG tiles
//      (a shared-memory tree per group), then the groups and the dW
//      partials, each added in index order.
// The products of kernels 1-3 run on one of two cores by the bag's dtype.
// f32 bags: the classic f32 SGEMM core (sgemm_core.cuh, shared with the
// forward), a 128 x 128 output tile per CTA of 256 threads, 8 x 8 results
// per thread, GK = 8 deep chunks double-buffered through registers.
// bf16 bags: the tensor cores (mma_core.cuh), bf16 x bf16 -> f32 on
// mma.sync.m16n8k16 over 128 x 128 tiles, BK = 32 deep chunks staged by
// cp.async into three padded shared-memory buffers and read by ldmatrix
// (.trans where an operand lies m- or n-contiguous: Wcat in dh, h and dp
// in dW), as the TPU kernel feeds its MXU bf16 and sums in f32.  Its
// scoring chunk interleaves Wa's and Wb's columns by 8 so that a thread
// holds t and u of the same column, and the chunks of kernel 1 run as one
// pipeline with each chunk's f32 epilogue between.  Every epilogue (t, u,
// a, ds, dp, dh, the sums) is f32 in both.
//
// Bound.  At the training shape (B = 32, N = 4096, D = Da = 256, gated,
// 90% of rows valid) the valid rows need 6 n D 2 Da = 92.8 GFLOP of matrix
// products (the scoring, dh and dW products, 30.9 GFLOP each) and 4 n D
// more for g . h and a g: 1.385 ms at the 67 TFLOP/s f32 CUDA-core peak,
// 93.8 us at the 989 TFLOP/s bf16 tensor-core peak, against about 0.3 GB
// of bytes (0.1 ms at 3.35 TB/s): both are bound by operations
// (chip_smoke.py _bound).  On an H100 80GB HBM3 at 700 W f32 takes about
// 2.9 ms (the SGEMM core runs at about half of the f32 peak) and bf16
// about 0.83 ms (0.94 with dropout; rows 481 us, dh 182, dW 126).  What
// separates bf16 from its bound: the design moves about 1 GB through
// device memory (the f32 t/u scratch of [M, 2 Da] written and read, dp
// written and read twice, h read three times, dh written), a floor of
// about 0.3 ms; padded rows inside partly padded tiles are computed; and
// mma.sync issues from 8 warps at under half the tensor cores' rate
// (cuBLAS's bf16 products of these shapes take 75-83 us each).  Keeping
// t and u on chip, fusing dh into kernel 1, and wgmma on TMA-staged tiles
// are the routes there.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "mma_core.cuh"
#include "sgemm_core.cuh"

namespace {

using namespace sgemm;

constexpr int VG = 64;                // row tiles per column-sum group
constexpr int MAX_D = 512;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The rows kernel after the scores (both dtypes): s_s holds the raw
// scores (without cc) of the tile's rows m0 .. m0 + rows - 1.  Per row the
// softmax weight a, then pass 2: dpa, dpb per element from t and u in tut
// (in place over them for f32 bags, where tut aliases dpt), written to dpt
// in the bag's dtype, and the tile's column sums of dpa, dpb and z * ds
// into pv.
template <typename T, bool GATED, bool DROPOUT>
__device__ __forceinline__ void rows_tail(
    const T* __restrict__ h, const float* __restrict__ mask,
    const float* __restrict__ wc, const float* __restrict__ cc,
    const uint8_t* __restrict__ da, const uint8_t* __restrict__ db,
    const float* __restrict__ out, const float* __restrict__ ml,
    const float* __restrict__ g, T* dpt, float* tut,
    float* __restrict__ a_out, float* __restrict__ pv, const float* s_s,
    float* ds_s, float (*red)[16][64], float inv_keep, size_t m0, int rows,
    int N, int D, int Da) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int Kc = GATED ? 2 * Da : Da;
  // per row: a = softmax weight, alpha = g . h_r, ds = a (alpha - g . out);
  // warp w owns rows 16 w .. 16 w + 15
  const float c = cc[0];
  for (int r = 16 * warp; r < 16 * warp + 16; ++r) {
    if (r >= rows) {
      if (lane == 0) ds_s[r] = 0.f;
      continue;
    }
    const size_t row = m0 + r;
    const size_t b = row / N;
    const float* gb = g + b * D;
    const float* ob = out + b * D;
    const T* hr = h + row * D;
    float al = 0.f, go = 0.f;
    for (int d = 4 * lane; d < D; d += 128) {
      const float4 hv = load4(hr + d), gv = load4(gb + d), ov = load4(ob + d);
      al = fmaf(gv.x, hv.x, fmaf(gv.y, hv.y, fmaf(gv.z, hv.z,
                                                  fmaf(gv.w, hv.w, al))));
      go = fmaf(gv.x, ov.x, fmaf(gv.y, ov.y, fmaf(gv.z, ov.z,
                                                  fmaf(gv.w, ov.w, go))));
    }
    al = warp_sum(al);
    go = warp_sum(go);
    const float m = ml[2 * b], l = fmaxf(ml[2 * b + 1], 1e-30f);
    // masked before the exp: an all-masked bag has m = NEG_INF
    const float a = mask[row] > 0.f ? expf((s_s[r] + c) - m) / l : 0.f;
    if (lane == 0) {
      ds_s[r] = a * (al - go);
      a_out[row] = a;
    }
  }

  // pass 2: dpa, dpb per element from the kept t and u (in place over them
  // for f32 bags: each element is read and written by one thread); column
  // sums of dpa, dpb and z * ds.  Thread (ty, tx) owns rows ty + 16 i and
  // columns c0 + 4 tx .. + 3.
  for (int c0 = 0; c0 < Da; c0 += 64) {
    __syncthreads();  // ds_s is complete; the previous chunk's red was read
    const int col0 = c0 + 4 * tx;
    float sa[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f},
          sw[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 16 * i;
      if (r >= rows) continue;
      const float ds = ds_s[r];
      float fa[4], fb[4], pa4[4], pb4[4];
      keep_factors<GATED, DROPOUT>(da, db, m0 + r, true, col0, Da, inv_keep,
                                   fa, fb);
      float* tr = tut + (size_t)r * Kc;
      const float4 t4 = *reinterpret_cast<const float4*>(tr + col0);
      float4 u4 = t4;
      if (GATED) u4 = *reinterpret_cast<const float4*>(tr + Da + col0);
      const float tv[4] = {t4.x, t4.y, t4.z, t4.w};
      const float uv[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float t = tv[j];
        const float dz = ds * wc[col0 + j];
        float z, dpa, dpb = 0.f;
        if (GATED) {
          const float u = uv[j];
          const float ta = DROPOUT ? t * fa[j] : t;
          const float ub = DROPOUT ? u * fb[j] : u;
          z = ta * ub;
          dpa = dz * ub * (1.f - t * t);
          dpb = dz * ta * u * (1.f - u);
          if (DROPOUT) {
            dpa *= fa[j];
            dpb *= fb[j];
          }
        } else {
          z = DROPOUT ? t * fa[j] : t;
          dpa = dz * (1.f - t * t);
          if (DROPOUT) dpa *= fa[j];
        }
        pa4[j] = dpa;
        pb4[j] = dpb;
        sa[j] += dpa;
        sb[j] += dpb;
        sw[j] = fmaf(z, ds, sw[j]);
      }
      store4(dpt + (size_t)r * Kc + col0, pa4);
      if (GATED) store4(dpt + (size_t)r * Kc + Da + col0, pb4);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[0][ty][4 * tx + j] = sa[j];
      red[1][ty][4 * tx + j] = sb[j];
      red[2][ty][4 * tx + j] = sw[j];
    }
    __syncthreads();
    if (tid < 3 * 64) {  // fixed order over the 16 row groups
      const int q = tid >> 6, cq = tid & 63;
      float v = 0.f;
      for (int y = 0; y < 16; ++y) v += red[q][y][cq];
      pv[q * Da + c0 + cq] = v;
    }
  }
}

// Kernel 1.  Rows m0 .. m0 + 127 of the M flattened rows.
template <bool GATED, bool DROPOUT>
__global__ void __launch_bounds__(THREADS, 2)
bwd_rows_kernel(const float* __restrict__ h, const float* __restrict__ mask,
                const float* __restrict__ wa, const float* __restrict__ ba,
                const float* __restrict__ wb, const float* __restrict__ bb,
                const float* __restrict__ wc, const float* __restrict__ cc,
                const uint8_t* __restrict__ da,
                const uint8_t* __restrict__ db,
                const float* __restrict__ out, const float* __restrict__ ml,
                const float* __restrict__ g,
                float* dp,                     // [M, Kc]
                float* tu,                     // == dp: t, u in place
                float* __restrict__ a_out,     // [M]
                float* __restrict__ part_vec,  // [tiles, 3, Da]
                float inv_keep, int M, int N, int D, int Da) {
  __shared__ __align__(16) float smem[2 * STAGE];
  __shared__ float s_s[GT], ds_s[GT];
  __shared__ float red[3][16][64];

  const int tid = threadIdx.x, tx = tid & 15;
  const size_t m0 = (size_t)blockIdx.x * GT;
  const int rows = (int)min((size_t)GT, (size_t)M - m0);
  const int Kc = GATED ? 2 * Da : Da;
  float* dpt = dp + m0 * Kc;
  float* tut = tu + m0 * Kc;
  float* pv = part_vec + (size_t)blockIdx.x * 3 * Da;

  if (!__syncthreads_or(tid < rows && mask[m0 + tid] > 0.f)) {
    // all padding: a = 0, so dp, the column sums (and later dh) are 0
    for (int i = tid; i < rows * Kc; i += THREADS) dpt[i] = 0.f;
    for (int i = tid; i < rows; i += THREADS) a_out[m0 + i] = 0.f;
    for (int i = tid; i < 3 * Da; i += THREADS) pv[i] = 0.f;
    return;
  }

  // pass 1: the products h [Wa | Wb] in 128-wide chunks of columns (gated:
  // Wa's c0 .. c0 + 63, then Wb's; ungated: Wa's c0 .. c0 + 127), each
  // followed by t, u into tu and the scores' partial sums
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const bool a_in = (tid >> 1) < rows;
  const float* pa = h + (m0 + (tid >> 1)) * D + 4 * (tid & 1);
  const int bk = tid >> 5, bn = 4 * (tid & 31);
  auto put = [&](float* st, const float4& ra, const float4& rb) {
    put_transposed(st, ra);
    put_rows(st + GK * S_LD, rb);
  };
  float part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int n_chunks = GATED ? Da / 64 : (Da + GT - 1) / GT;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = GATED ? 64 * ch : GT * ch;
    const float* pb = (GATED && bn >= 64 ? wb + c0 + bn - 64 : wa + c0 + bn) +
                  (size_t)bk * Da;
    const bool b_in = GATED || c0 + bn < Da;
    auto fetch = [&](int c, float4& ra, float4& rb) {
      ra = a_in ? load4(pa + c * GK) : zero4;
      rb = b_in ? load4(pb + (size_t)c * GK * Da) : zero4;
      return true;
    };
    float acc[8][8];
    zero(acc);
    sgemm_loop(D / GK, smem, fetch, put, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row_of(i);
      const size_t row = m0 + r;
#pragma unroll
      for (int q = 0; q < (GATED ? 1 : 2); ++q) {
        const int col0 = c0 + 64 * q + 4 * tx;
        if (!GATED && col0 >= Da) continue;
        float fa[4], fb[4], t[4], u[4];
        keep_factors<GATED, DROPOUT>(da, db, row, r < rows, col0, Da,
                                     inv_keep, fa, fb);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          t[j] = tanhf(acc[i][4 * q + j] + ba[col0 + j]);
          float z = t[j];
          if (DROPOUT) z *= fa[j];
          if (GATED) {
            u[j] = 1.f / (1.f + expf(-(acc[i][4 + j] + bb[col0 + j])));
            z *= DROPOUT ? u[j] * fb[j] : u[j];
          }
          part[i] = fmaf(z, wc[col0 + j], part[i]);
        }
        if (r < rows) {
          store4(tut + (size_t)r * Kc + col0, t);
          if (GATED) store4(tut + (size_t)r * Kc + Da + col0, u);
        }
      }
    }
  }
  // the 16 threads of a half-warp share their rows
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float v = part[i];
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (tx == 0) s_s[row_of(i)] = v;
  }
  __syncthreads();

  rows_tail<float, GATED, DROPOUT>(h, mask, wc, cc, da, db, out, ml, g,
                                   dpt, tut, a_out, pv, s_s, ds_s, red,
                                   inv_keep, m0, rows, N, D, Da);
}

// Kernel 2.  dh = a g + [dpa | dpb] Wcat over the flattened rows: the CTA
// owns rows m0 .. m0 + 127 and columns n0 .. n0 + 127 of D (the upper 64
// are masked off when D % 128 == 64).  A = dp rows, transposed as they
// are staged; B = Wcat [Kc, D].  Masked rows are written as exact zeros.
__global__ void __launch_bounds__(THREADS, 2)
bwd_dh_kernel(const float* __restrict__ dp, const float* __restrict__ wcat,
              const float* __restrict__ a, const float* __restrict__ g,
              const float* __restrict__ mask, float* __restrict__ dh, int M,
              int N, int D, int Kc) {
  __shared__ __align__(16) float smem[2 * STAGE];
  const int n_col = (D + GT - 1) / GT;
  const int n0 = (blockIdx.x % n_col) * GT;
  const size_t m0 = (size_t)(blockIdx.x / n_col) * GT;
  const int tid = threadIdx.x, tx = tid & 15;
  const int rows = (int)min((size_t)GT, (size_t)M - m0);

  float acc[8][8];
  zero(acc);
  if (__syncthreads_or(tid < rows && mask[m0 + tid] > 0.f)) {
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
    const bool a_in = (tid >> 1) < rows;
    const float* pa = dp + (m0 + (tid >> 1)) * Kc + 4 * (tid & 1);
    const int bn = 4 * (tid & 31);
    const bool b_in = n0 + bn < D;
    const float* pb = wcat + (size_t)(tid >> 5) * D + n0 + bn;
    auto fetch = [&](int c, float4& ra, float4& rb) {
      ra = a_in ? load4(pa + c * GK) : zero4;
      rb = b_in ? load4(pb + (size_t)c * GK * D) : zero4;
      return true;
    };
    auto put = [&](float* st, const float4& ra, const float4& rb) {
      put_transposed(st, ra);
      put_rows(st + GK * S_LD, rb);
    };
    sgemm_loop(Kc / GK, smem, fetch, put, acc);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row_of(i);
    if (r >= rows) continue;
    const size_t row = m0 + r;
    const bool valid = mask[row] > 0.f;
    const float ar = a[row];
    const float* gb = g + (row / N) * D;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = n0 + 64 * q + 4 * tx;
      if (col >= D) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = valid ? fmaf(ar, gb[col + j], acc[i][4 * q + j]) : 0.f;
      store4(dh + row * D + col, v);
    }
  }
}

// Kernel 3.  part[s] = h^T [dpa | dpb] over the flattened rows of split
// s: the CTA owns rows d0 .. d0 + 127 of D and columns k0 .. k0 + 127 of Kc
// (upper halves masked off at a 64-wide edge) and walks the split's rows
// GK at a time; A = h rows, B = dp rows, both staged as they lie.  Chunks
// whose rows are all masked are skipped: their dp rows are exact zeros.
__global__ void __launch_bounds__(THREADS, 2)
bwd_dw_partial_kernel(const float* __restrict__ h,
                      const float* __restrict__ dp,
                      const float* __restrict__ mask,
                      float* __restrict__ part,  // [S, D, Kc]
                      int M, int D, int Kc, int rows_per_split) {
  __shared__ __align__(16) float smem[2 * STAGE];
  const int k0 = blockIdx.x * GT, d0 = blockIdx.y * GT, s = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15;
  const int row_begin = s * rows_per_split;
  const int row_end = min(M, row_begin + rows_per_split);

  float acc[8][8];
  zero(acc);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const int kr = tid >> 5, cn = 4 * (tid & 31);
  const bool a_in = d0 + cn < D, b_in = k0 + cn < Kc;
  const float* pa = h + (size_t)(row_begin + kr) * D + d0 + cn;
  const float* pb = dp + (size_t)(row_begin + kr) * Kc + k0 + cn;
  auto fetch = [&](int c, float4& ra, float4& rb) {
    const int r = row_begin + c * GK + kr;
    const bool in = r < row_end;
    ra = in && a_in ? load4(pa + (size_t)c * GK * D) : zero4;
    rb = in && b_in ? load4(pb + (size_t)c * GK * Kc) : zero4;
    return in && (tid & 31) == 0 && mask[r] > 0.f;
  };
  auto put = [&](float* st, const float4& ra, const float4& rb) {
    put_rows(st, ra);
    put_rows(st + GK * S_LD, rb);
  };
  sgemm_loop((row_end - row_begin + GK - 1) / GK, smem, fetch, put, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int d = d0 + row_of(i);
    if (d >= D) continue;
    float* ps = part + ((size_t)s * D + d) * Kc;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = k0 + 64 * q + 4 * tx;
      if (col < Kc)
        store4(ps + col, {acc[i][4 * q], acc[i][4 * q + 1],
                          acc[i][4 * q + 2], acc[i][4 * q + 3]});
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 bags: kernels 1, 2 and 3 with their products on the tensor cores
// (mma_core.cuh): bf16 operands, f32 sums and f32 epilogues.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// Dynamic shared memory of the bf16 kernels: the core's STAGES buffers,
// and for the dW kernel the mask of each staged chunk's rows after them.
constexpr int MMA_SMEM = mma::SMEM_BYTES;
constexpr int DW_SMEM = mma::SMEM_BYTES + mma::STAGES * mma::BK * 4;
static_assert(mma::BM == GT, "the bf16 kernels tile the rows as f32 does");

// The keep factors of `row` at columns col, col + 1 (keep_factors for 2).
template <bool GATED, bool DROPOUT>
__device__ __forceinline__ void keep2(const uint8_t* da, const uint8_t* db,
                                      size_t row, bool in, int col, int Da,
                                      float inv_keep, float (&fa)[2],
                                      float (&fb)[2]) {
  uchar2 ka = make_uchar2(1, 1), kb = ka;
  float scale = 1.f;
  if (DROPOUT) {
    scale = inv_keep;
    ka = kb = make_uchar2(0, 0);
    if (in) {
      ka = *reinterpret_cast<const uchar2*>(da + row * Da + col);
      if (GATED) kb = *reinterpret_cast<const uchar2*>(db + row * Da + col);
    }
  }
  fa[0] = ka.x * scale; fa[1] = ka.y * scale;
  fb[0] = kb.x * scale; fb[1] = kb.y * scale;
}

__device__ __forceinline__ void store2(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

// Kernel 1, bf16.  Rows m0 .. m0 + 127; pass 1 runs the scoring products
// h [Wa | Wb] on the core in 128-wide chunks of columns, staged from Wcat
// [Kc, D] (k-contiguous, as h is).  Gated, chunk ch holds Wa's columns
// 64 ch .. + 63 and Wb's alike, interleaved by 8 (tile columns 16 j .. +
// 7 are Wa's 64 ch + 8 j .. + 7, the next 8 Wb's), so that a thread holds
// t and u of the same columns; ungated, Wa's 128 ch .. + 127.  The whole
// chunk sequence is one pipeline: each chunk's epilogue (t, u into tu, the
// scores' partial sums) runs while the next chunk's first pieces load.
// Then rows_tail, as for f32.
template <bool GATED, bool DROPOUT>
__global__ void __launch_bounds__(mma::THREADS, 2)
bwd_rows_bf16_kernel(const bf16* __restrict__ h,
                     const float* __restrict__ mask,
                     const bf16* __restrict__ wcat,
                     const float* __restrict__ ba,
                     const float* __restrict__ bb,
                     const float* __restrict__ wc,
                     const float* __restrict__ cc,
                     const uint8_t* __restrict__ da,
                     const uint8_t* __restrict__ db,
                     const float* __restrict__ out,
                     const float* __restrict__ ml,
                     const float* __restrict__ g,
                     bf16* dp,                      // [M, Kc]
                     float* tu,                     // [M, Kc] f32
                     float* __restrict__ a_out,     // [M]
                     float* __restrict__ part_vec,  // [tiles, 3, Da]
                     float inv_keep, int M, int N, int D, int Da) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  bf16* smem = reinterpret_cast<bf16*>(dyn_smem);
  __shared__ float s_s[GT], ds_s[GT];
  __shared__ float red[3][16][64];
  __shared__ float red_s[4][GT];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t m0 = (size_t)blockIdx.x * GT;
  const int rows = (int)min((size_t)GT, (size_t)M - m0);
  const int Kc = GATED ? 2 * Da : Da;
  bf16* dpt = dp + m0 * Kc;
  float* tut = tu + m0 * Kc;
  float* pv = part_vec + (size_t)blockIdx.x * 3 * Da;

  if (!__syncthreads_or(tid < rows && mask[m0 + tid] > 0.f)) {
    // all padding: a = 0, so dp, the column sums (and later dh) are 0
    for (int i = tid; i < rows * Kc; i += mma::THREADS) dpt[i] = bf16(0.f);
    for (int i = tid; i < rows; i += mma::THREADS) a_out[m0 + i] = 0.f;
    for (int i = tid; i < 3 * Da; i += mma::THREADS) pv[i] = 0.f;
    return;
  }

  const int kd = D / mma::BK;  // chunks of depth per chunk of columns
  const int n_chunks = GATED ? Da / 64 : (Da + GT - 1) / GT;
  const bf16* h_tile = h + m0 * D;
  auto h_row = [&](int i) -> const bf16* {
    return i < rows ? h_tile + (size_t)i * D : nullptr;
  };
  auto load = [&](int c, bf16* buf, int) {
    const int ch = c / kd, k0 = (c - ch * kd) * mma::BK;
    auto w_row = [&](int j) -> const bf16* {
      if (GATED) {
        const int col = 64 * ch + 8 * (j >> 4) + (j & 7);
        return wcat + (size_t)(((j >> 3) & 1) ? Da + col : col) * D;
      }
      const int col = GT * ch + j;
      return col < Da ? wcat + (size_t)col * D : nullptr;
    };
    mma::stage_k(buf, h_row, k0, h);
    mma::stage_k(buf + mma::TILE, w_row, k0, h);
  };
  float acc[4][4][4];
  mma::zero(acc);
  // part[mi][j]: this thread's share of the score of tile row
  // mma::row_of(mi, 2 j)
  float part[4][2] = {};
  const int t2 = 2 * (lane & 3);
  auto epilogue = [&](int c) {
    if ((c + 1) % kd) return;
    const int ch = c / kd;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = mma::row_of(mi, 2 * j);
        const size_t row = m0 + r;
#pragma unroll
        for (int q = 0; q < (GATED ? 2 : 4); ++q) {
          // gated: t's pre-activations in n8 tile 2 q, u's in 2 q + 1
          const int ni = GATED ? 2 * q : q;
          const int col = GATED ? 64 * ch + 16 * (warp & 3) + 8 * q + t2
                                : GT * ch + 32 * (warp & 3) + 8 * q + t2;
          if (!GATED && col >= Da) continue;
          float fa[2], fb[2], t[2], u[2];
          keep2<GATED, DROPOUT>(da, db, row, r < rows, col, Da, inv_keep,
                                fa, fb);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            t[e] = tanhf(acc[mi][ni][2 * j + e] + ba[col + e]);
            float z = t[e];
            if (DROPOUT) z *= fa[e];
            if constexpr (GATED) {
              u[e] = 1.f / (1.f + expf(-(acc[mi][ni + 1][2 * j + e] +
                                         bb[col + e])));
              z *= DROPOUT ? u[e] * fb[e] : u[e];
            }
            part[mi][j] = fmaf(z, wc[col + e], part[mi][j]);
          }
          if (r < rows) {
            store2(tut + (size_t)r * Kc + col, t);
            if constexpr (GATED) store2(tut + (size_t)r * Kc + Da + col, u);
          }
        }
      }
    mma::zero(acc);
  };
  mma::mma_loop<true, true>(n_chunks * kd, smem, load,
                            [](int, int) { return true; }, epilogue, acc);

  // a row's score: the 4 lanes of a row group, then the 4 column warps,
  // each in a fixed order
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v = part[mi][j];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if ((lane & 3) == 0) red_s[warp & 3][mma::row_of(mi, 2 * j)] = v;
    }
  __syncthreads();
  if (tid < GT)
    s_s[tid] = (red_s[0][tid] + red_s[1][tid]) + (red_s[2][tid] +
                                                  red_s[3][tid]);
  __syncthreads();

  rows_tail<bf16, GATED, DROPOUT>(h, mask, wc, cc, da, db, out, ml, g, dpt,
                                  tut, a_out, pv, s_s, ds_s, red, inv_keep,
                                  m0, rows, N, D, Da);
}

// Kernel 2, bf16.  dh = a g + [dpa | dpb] Wcat on the core: the CTA owns
// rows m0 .. m0 + 127 and columns n0 .. n0 + 127 of D (the upper 64 masked
// off when D % 128 == 64); A = dp rows (k-contiguous), B = Wcat [Kc, D]
// (n-contiguous, read with ldmatrix.trans).  Masked rows are written as
// exact zeros.
__global__ void __launch_bounds__(mma::THREADS, 2)
bwd_dh_bf16_kernel(const bf16* __restrict__ dp, const bf16* __restrict__ wcat,
                   const float* __restrict__ a, const float* __restrict__ g,
                   const float* __restrict__ mask, bf16* __restrict__ dh,
                   int M, int N, int D, int Kc) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  bf16* smem = reinterpret_cast<bf16*>(dyn_smem);
  const int n_col = (D + GT - 1) / GT;
  const int n0 = (blockIdx.x % n_col) * GT;
  const size_t m0 = (size_t)(blockIdx.x / n_col) * GT;
  const int tid = threadIdx.x;
  const int rows = (int)min((size_t)GT, (size_t)M - m0);

  float acc[4][4][4];
  mma::zero(acc);
  if (__syncthreads_or(tid < rows && mask[m0 + tid] > 0.f)) {
    const bf16* dp_tile = dp + m0 * Kc;
    auto dp_row = [&](int i) -> const bf16* {
      return i < rows ? dp_tile + (size_t)i * Kc : nullptr;
    };
    auto load = [&](int c, bf16* buf, int) {
      const int k0 = c * mma::BK;
      mma::stage_k(buf, dp_row, k0, dp);
      mma::stage_m(buf + mma::TILE, [&](int kk) -> const bf16* {
        return wcat + (size_t)(k0 + kk) * D;
      }, n0, D, dp);
    };
    mma::mma_loop<true, false>(Kc / mma::BK, smem, load,
                               [](int, int) { return true; },
                               [](int) {}, acc);
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = mma::row_of(mi, 2 * j);
      if (r >= rows) continue;
      const size_t row = m0 + r;
      const bool valid = mask[row] > 0.f;
      const float ar = a[row];
      const float* gb = g + (row / N) * D;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + mma::col_of(ni, 0);
        if (col >= D) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = valid ? fmaf(ar, gb[col + e], acc[mi][ni][2 * j + e]) : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(dh + row * D + col) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
    }
}

// Kernel 3, bf16.  part[s] = h^T [dpa | dpb] over the rows of split s on
// the core: the CTA owns rows d0 .. d0 + 127 of D and columns k0 .. k0 +
// 127 of Kc (edges past D or Kc zero-filled) and walks the split's rows BK
// at a time; A = h rows and B = dp rows, both staged as they lie (m- and
// n-contiguous, read with ldmatrix.trans).  Each chunk's mask is staged
// with it, and a chunk whose rows are all masked is skipped: its dp rows
// are exact zeros.
__global__ void __launch_bounds__(mma::THREADS, 2)
bwd_dw_bf16_kernel(const bf16* __restrict__ h, const bf16* __restrict__ dp,
                   const float* __restrict__ mask,
                   float* __restrict__ part,  // [S, D, Kc]
                   int M, int D, int Kc, int rows_per_split) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  bf16* smem = reinterpret_cast<bf16*>(dyn_smem);
  float* mask_s = reinterpret_cast<float*>(dyn_smem + mma::SMEM_BYTES);
  const int k0 = blockIdx.x * GT, d0 = blockIdx.y * GT, s = blockIdx.z;
  const int row_begin = s * rows_per_split;
  const int row_end = min(M, row_begin + rows_per_split);

  float acc[4][4][4];
  mma::zero(acc);
  auto load = [&](int c, bf16* buf, int st) {
    const int r0 = row_begin + c * mma::BK;
    mma::stage_m(buf, [&](int kk) -> const bf16* {
      return r0 + kk < row_end ? h + (size_t)(r0 + kk) * D : nullptr;
    }, d0, D, h);
    mma::stage_m(buf + mma::TILE, [&](int kk) -> const bf16* {
      return r0 + kk < row_end ? dp + (size_t)(r0 + kk) * Kc : nullptr;
    }, k0, Kc, h);
    if (threadIdx.x < mma::BK / 4) {  // rows past the split read as 0
      const int r = r0 + 4 * threadIdx.x;
      const int bytes = max(0, min(16, 4 * (row_end - r)));
      mma::cp_async16(mask_s + st * mma::BK + 4 * threadIdx.x,
                      bytes ? mask + r : mask, bytes);
    }
  };
  auto live = [&](int, int st) {
    return __any_sync(0xffffffffu,
                      mask_s[st * mma::BK + (threadIdx.x & 31)] > 0.f) != 0;
  };
  mma::mma_loop<false, false>((row_end - row_begin + mma::BK - 1) / mma::BK,
                              smem, load, live, [](int) {}, acc);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int d = d0 + mma::row_of(mi, 2 * j);
      if (d >= D) continue;
      float* ps = part + ((size_t)s * D + d) * Kc;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = k0 + mma::col_of(ni, 0);
        if (col < Kc)
          store2(ps + col, {acc[mi][ni][2 * j], acc[mi][ni][2 * j + 1]});
      }
    }
}

// Kernel 4, the first level of the column sums: grp[q] = the sum of the
// tiles' rows part_vec[VG q .. VG q + VG - 1] (fewer in the last group) for
// a band of 64 of the n_vec columns.  Four lanes of 64 threads each add a
// quarter of the group's rows in index order; a shared-memory tree adds
// the lanes as (0 + 1) + (2 + 3).
__global__ void __launch_bounds__(THREADS)
bwd_vec_partial_kernel(const float* __restrict__ part_vec,
                       float* __restrict__ grp, int tiles, int n_vec) {
  __shared__ float red[4][64];
  const int x = threadIdx.x & 63, lane = threadIdx.x >> 6;
  const int c = blockIdx.x * 64 + x, q = blockIdx.y;
  const int t0 = q * VG + lane * (VG / 4);
  const int t1 = min(tiles, t0 + VG / 4);
  float v = 0.f;
  for (int t = t0; t < t1; ++t) v += part_vec[(size_t)t * n_vec + c];
  red[lane][x] = v;
  __syncthreads();
  if (lane == 0)
    grp[(size_t)q * n_vec + c] = (red[0][x] + red[1][x]) +
                                 (red[2][x] + red[3][x]);
}

// Kernel 5, the last level: dW = the sum over the S splits of part[s] and
// dvec = the sum over the G groups of grp[q], each in index order.
__global__ void __launch_bounds__(THREADS)
bwd_reduce_kernel(const float* __restrict__ part,
                  const float* __restrict__ grp, float* __restrict__ dW,
                  float* __restrict__ dvec, int S, int n_dw, int G,
                  int n_vec) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.f;
  if (i < n_dw) {
    for (int s = 0; s < S; ++s) v += part[(size_t)s * n_dw + i];
    dW[i] = v;
  } else if (i < n_dw + n_vec) {
    const int j = i - n_dw;
    for (int q = 0; q < G; ++q) v += grp[(size_t)q * n_vec + j];
    dvec[j] = v;
  }
}

template <typename T, bool GATED, bool DROPOUT>
cudaError_t launch(const void* h, const float* mask, const void* wa,
                   const float* ba, const void* wb, const float* bb,
                   const float* wc, const float* cc, const void* wcat,
                   const uint8_t* da, const uint8_t* db, const float* out,
                   const float* ml, const float* g, void* dp, float* tu,
                   float* a, float* part_vec, float* part_grp, float* part_dw,
                   void* dh, float* dW, float* dvec, float inv_keep, int B,
                   int N, int D, int Da, int splits, int rows_per_split,
                   cudaStream_t stream) {
  const T* ht = static_cast<const T*>(h);
  const T* wct = static_cast<const T*>(wcat);
  T* dpt = static_cast<T*>(dp);
  const int Kc = GATED ? 2 * Da : Da;
  const int M = B * N;
  const int tiles = (M + GT - 1) / GT;
  const int n_col = (D + GT - 1) / GT;
  const dim3 dw_grid((Kc + GT - 1) / GT, n_col, splits);
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value) {
    bwd_rows_kernel<GATED, DROPOUT><<<tiles, THREADS, 0, stream>>>(
        ht, mask, static_cast<const T*>(wa), ba, static_cast<const T*>(wb),
        bb, wc, cc, da, db, out, ml, g, dpt, tu, a, part_vec, inv_keep, M, N,
        D, Da);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    bwd_dh_kernel<<<n_col * tiles, THREADS, 0, stream>>>(
        dpt, wct, a, g, mask, static_cast<T*>(dh), M, N, D, Kc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    bwd_dw_partial_kernel<<<dw_grid, THREADS, 0, stream>>>(
        ht, dpt, mask, part_dw, M, D, Kc, rows_per_split);
  } else {
    // wa and wb are not read: Wcat holds both for the scoring products
    auto rows = bwd_rows_bf16_kernel<GATED, DROPOUT>;
    if ((err = cudaFuncSetAttribute(
             rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
             MMA_SMEM)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             bwd_dh_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             MMA_SMEM)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             bwd_dw_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             DW_SMEM)) != cudaSuccess)
      return err;
    rows<<<tiles, mma::THREADS, MMA_SMEM, stream>>>(
        ht, mask, wct, ba, bb, wc, cc, da, db, out, ml, g, dpt, tu, a,
        part_vec, inv_keep, M, N, D, Da);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    bwd_dh_bf16_kernel<<<n_col * tiles, mma::THREADS, MMA_SMEM, stream>>>(
        dpt, wct, a, g, mask, static_cast<T*>(dh), M, N, D, Kc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    bwd_dw_bf16_kernel<<<dw_grid, mma::THREADS, DW_SMEM, stream>>>(
        ht, dpt, mask, part_dw, M, D, Kc, rows_per_split);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n_dw = D * Kc, n_vec = 3 * Da;
  const int groups = (tiles + VG - 1) / VG;
  bwd_vec_partial_kernel<<<dim3(n_vec / 64, groups), THREADS, 0, stream>>>(
      part_vec, part_grp, tiles, n_vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int blocks = (n_dw + n_vec + THREADS - 1) / THREADS;
  bwd_reduce_kernel<<<blocks, THREADS, 0, stream>>>(
      part_dw, part_grp, dW, dvec, splits, n_dw, groups, n_vec);
  return cudaGetLastError();
}

int dw_ctas_per_sm(bool bf16) {
  int n = 0;
  cudaError_t err =
      bf16 ? cudaFuncSetAttribute(bwd_dw_bf16_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  DW_SMEM)
           : cudaSuccess;
  if (err == cudaSuccess)
    err = bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &n, bwd_dw_bf16_kernel, mma::THREADS, DW_SMEM)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &n, bwd_dw_partial_kernel, THREADS, 0);
  return err == cudaSuccess ? n : 0;
}

}  // namespace

extern "C" {

int mil_pool_bwd_tile() { return GT; }
int mil_pool_bwd_depth(int bf16) { return bf16 ? mma::BK : GK; }
int mil_pool_bwd_vec_group() { return VG; }

// CTAs of the dW partial kernel of the dtype that one SM of the current
// device runs at once (0 on error).
int mil_pool_bwd_dw_ctas_per_sm(int bf16) { return dw_ctas_per_sm(bf16); }

// h [B, N, D] f32 or bf16; mask [B, N] f32; wa/wb [D, Da] and wcat
// [Kc, D] = [Wa^T; Wb^T] (Kc = 2 Da gated, Da ungated) in h's dtype;
// ba/bb/wc [Da], cc [1], out/g [B, D], ml [B, 2] f32; da/db uint8 keep
// masks [B, N, Da] scaled by inv_keep, or both null.  With M = B N and
// tiles = ceil(M / GT), the scratch is: dp [M, Kc] in h's dtype; tu
// [M, Kc] f32, which is dp itself when h is f32; a [M]; part_vec
// [tiles, 3, Da]; part_grp [ceil(tiles / VG), 3, Da]; part_dw [splits, D,
// Kc] f32.  Outputs: dh [B, N, D] in h's dtype, dW [D, Kc] = [dWa | dWb]
// and dvec [3, Da] = (dba, dbb, dwc) f32.  All contiguous on one device
// and 16-byte aligned; D and Da multiples of 64, D <= MAX_D; 1 <= M <
// 2^31; rows_per_split a multiple of the dW kernel's depth
// (mil_pool_bwd_depth: GK for f32, mma::BK for bf16), splits *
// rows_per_split >= M and every split non-empty.  Returns the CUDA error
// code of the launches (0 = success).
int mil_pool_bwd(const void* h, const void* mask, const void* wa,
                 const void* ba, const void* wb, const void* bb,
                 const void* wc, const void* cc, const void* wcat,
                 const void* da, const void* db, const void* out,
                 const void* ml, const void* g, void* dp, void* tu, void* a,
                 void* part_vec, void* part_grp, void* part_dw, void* dh,
                 void* dW, void* dvec, float inv_keep, int B, int N, int D,
                 int Da, int splits, int rows_per_split, int gated, int bf16,
                 void* stream) {
  const long long M = (long long)B * N;
  const int depth = mil_pool_bwd_depth(bf16);
  if (D > MAX_D || D % 64 != 0 || Da % 64 != 0 || M < 1 || M > INT32_MAX ||
      rows_per_split < depth || rows_per_split % depth != 0 || splits < 1 ||
      (long long)splits * rows_per_split < M ||
      (long long)(splits - 1) * rows_per_split >= M ||
      (da != nullptr && db == nullptr))
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  auto u8 = [](const void* p) { return static_cast<const uint8_t*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool dropout = da != nullptr;
#define MIL_LAUNCH(T, G, DR)                                                 \
  launch<T, G, DR>(h, f(mask), wa, f(ba), wb, f(bb), f(wc), f(cc), wcat,    \
                   u8(da), u8(db), f(out), f(ml), f(g), dp, w(tu), w(a),    \
                   w(part_vec), w(part_grp), w(part_dw), dh, w(dW), w(dvec), \
                   inv_keep, B, N, D, Da, splits, rows_per_split, st)
#define MIL_LAUNCH_G(T, G) \
  (dropout ? MIL_LAUNCH(T, G, true) : MIL_LAUNCH(T, G, false))
  cudaError_t err;
  if (bf16)
    err = gated ? MIL_LAUNCH_G(__nv_bfloat16, true)
                : MIL_LAUNCH_G(__nv_bfloat16, false);
  else
    err = gated ? MIL_LAUNCH_G(float, true) : MIL_LAUNCH_G(float, false);
#undef MIL_LAUNCH_G
#undef MIL_LAUNCH
  return (int)err;
}

}  // extern "C"
