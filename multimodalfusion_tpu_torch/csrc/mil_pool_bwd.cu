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
// so the work is four kernels, all deterministic (no float atomics):
//   1. rows: one CTA per (64-row tile, bag).  It keeps the tile (as f32,
//      transposed) in shared memory, recomputes the scoring products in
//      64-column chunks (an SGEMM-style 4 x 4 register block per thread),
//      forms s, a and ds per row, then recomputes the chunks to write
//      [dpa | dpb] per row (in the bag's dtype, as the TPU kernel casts
//      them before its products) and per-tile column sums of dpa, dpb and
//      z * ds.  Tiles whose rows are all padding write zeros and return.
//   2. dh: dh = a g + [dpa | dpb] [Wa^T; Wb^T], an SGEMM over 64 x 64
//      output tiles with masked rows written as exact zeros.
//   3. dW: split-K over the rows of all bags, hᵀ [dpa | dpb] per 64 x 64
//      output tile and row chunk, into per-CTA partials; chunks whose rows
//      are all padding are skipped.
//   4. reduce: the partials of dW and the per-tile column sums, each added
//      in a fixed order.
// Every product runs on the CUDA cores in f32; bf16 bags and weights are
// converted to f32 as they are staged (exact), so bf16 runs no faster.
//
// Bound.  At the training shape (B = 32, N = 4096, D = Da = 256, gated) the
// backward does about 6 B N D 2Da = 103 GFLOP of matrix products (the TPU
// kernel's CostEstimate), about 1.5 ms at the 67 TFLOP/s f32 CUDA-core
// peak, against about 0.3 GB of bytes (0.1 ms at 3.35 TB/s): it is bound
// by operations.  This first version spends a third more operations than
// that (kernel 1 computes the scoring products twice instead of keeping
// t, u on chip) and round-trips [dpa | dpb] through device memory.  For
// bf16 bags the bound is the tensor cores' (about 0.1 ms); wgmma on tiles
// staged by TMA is the route to it, in a later version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;           // rows per tile (kernels 1 and 2)
constexpr int THREADS = 256;     // 16 x 16 threads, 4 x 4 outputs each
constexpr int CN = 64;           // output columns per chunk / tile
constexpr int KC = 32;           // depth of a staged chunk
constexpr int HT_LD = TM + 4;    // row stride of a transposed tile
constexpr int MAX_D = 512;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 4 consecutive values from f32 (16-byte store) or bf16 (8-byte store).
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v[0], v[1]);
  q[1] = __floats2bfloat162_rn(v[2], v[3]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[i][j] += x[k][4 ty + i] * w[k][4 tx + j] over k < KC, both operands
// in shared memory with row strides ldx and ldw.
__device__ __forceinline__ void mac_block(const float* x, int ldx,
                                          const float* w, int ldw,
                                          float (&acc)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 8
  for (int k = 0; k < KC; ++k) {
    const float4 x4 = *reinterpret_cast<const float4*>(x + k * ldx + 4 * ty);
    const float4 w4 = *reinterpret_cast<const float4*>(w + k * ldw + 4 * tx);
    const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
    const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
  }
}

// Tile rows [0, rows) of hb [., D] into ht[d][r] as f32, zeros beyond.
template <typename T>
__device__ __forceinline__ void load_tile(const T* hb, float* ht, int rows,
                                          int D) {
  for (int i = threadIdx.x; i < TM * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    ht[d * HT_LD + r] = (r < rows) ? to_f32(hb[(size_t)r * D + d]) : 0.f;
  }
}

// The scoring pre-activations of the tile's rows 4 ty + i at columns
// c0 + 4 tx + j: za = h Wa, zb = h Wb (without the biases).  W [D, Da] is
// staged through ws (2 x [KC][CN] f32) in KC-deep chunks.
template <typename T, bool GATED>
__device__ __forceinline__ void chunk_products(const float* ht, float* ws,
                                               const T* wa, const T* wb,
                                               int c0, int D, int Da,
                                               float (&za)[4][4],
                                               float (&zb)[4][4]) {
  float* wsa = ws;
  float* wsb = ws + KC * CN;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) za[i][j] = zb[i][j] = 0.f;
  for (int k0 = 0; k0 < D; k0 += KC) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = threadIdx.x; i < KC * CN; i += THREADS) {
      const int kk = i / CN, c = i - kk * CN;
      const size_t src = (size_t)(k0 + kk) * Da + c0 + c;
      wsa[i] = to_f32(wa[src]);
      if (GATED) wsb[i] = to_f32(wb[src]);
    }
    __syncthreads();
    mac_block(ht + k0 * HT_LD, HT_LD, wsa, CN, za);
    if (GATED) mac_block(ht + k0 * HT_LD, HT_LD, wsb, CN, zb);
  }
}

// The keep factors of rows r < rows at 4 columns (1 without dropout).
template <bool GATED, bool DROPOUT>
__device__ __forceinline__ void keep_factors(const uint8_t* da,
                                             const uint8_t* db, int r,
                                             int rows, int col0, int Da,
                                             float inv_keep, float (&fa)[4],
                                             float (&fb)[4]) {
  uchar4 ka = make_uchar4(1, 1, 1, 1), kb = ka;
  float scale = 1.f;
  if (DROPOUT) {
    scale = inv_keep;
    ka = kb = make_uchar4(0, 0, 0, 0);
    if (r < rows) {
      ka = *reinterpret_cast<const uchar4*>(da + (size_t)r * Da + col0);
      if (GATED)
        kb = *reinterpret_cast<const uchar4*>(db + (size_t)r * Da + col0);
    }
  }
  fa[0] = ka.x * scale; fa[1] = ka.y * scale;
  fa[2] = ka.z * scale; fa[3] = ka.w * scale;
  fb[0] = kb.x * scale; fb[1] = kb.y * scale;
  fb[2] = kb.z * scale; fb[3] = kb.w * scale;
}

// Kernel 1.  Dynamic shared memory: the transposed tile ht [D][HT_LD],
// the weight staging ws [2][KC][CN] and the column-sum scratch
// red [3][16][CN], all f32.
template <typename T, bool GATED, bool DROPOUT>
__global__ void __launch_bounds__(THREADS)
bwd_rows_kernel(const T* __restrict__ h, const float* __restrict__ mask,
                const T* __restrict__ wa, const float* __restrict__ ba,
                const T* __restrict__ wb, const float* __restrict__ bb,
                const float* __restrict__ wc, const float* __restrict__ cc,
                const uint8_t* __restrict__ da,
                const uint8_t* __restrict__ db,
                const float* __restrict__ out, const float* __restrict__ ml,
                const float* __restrict__ g,
                T* __restrict__ dp,            // [B * N, Kc]
                float* __restrict__ a_out,     // [B, N]
                float* __restrict__ part_vec,  // [B * tiles, 3, Da]
                float inv_keep, int N, int D, int Da) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ht = reinterpret_cast<float*>(smem);
  float* ws = ht + (size_t)D * HT_LD;
  float* red = ws + 2 * KC * CN;
  __shared__ float s_s[TM], ds_s[TM];

  const int tile = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int r0 = tile * TM, rows = min(TM, N - r0);
  const int Kc = GATED ? 2 * Da : Da;
  const float* mb = mask + (size_t)b * N + r0;
  const size_t row0 = (size_t)b * N + r0;
  T* dpt = dp + row0 * Kc;
  float* pv = part_vec + ((size_t)b * gridDim.x + tile) * 3 * Da;
  const uint8_t* dat = DROPOUT ? da + row0 * Da : da;
  const uint8_t* dbt = DROPOUT ? db + row0 * Da : db;

  if (!__syncthreads_or(tid < rows && mb[tid] > 0.f)) {
    // all padding: a = 0, so dp, the column sums (and later dh) are 0
    for (int i = tid; i < rows * Kc; i += THREADS) dpt[i] = T(0.f);
    for (int i = tid; i < rows; i += THREADS) a_out[row0 + i] = 0.f;
    for (int i = tid; i < 3 * Da; i += THREADS) pv[i] = 0.f;
    return;
  }
  load_tile(h + row0 * D, ht, rows, D);

  // pass 1: the tile's scores
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  float za[4][4], zb[4][4];
  for (int c0 = 0; c0 < Da; c0 += CN) {
    chunk_products<T, GATED>(ht, ws, wa, wb, c0, D, Da, za, zb);
    const int col0 = c0 + 4 * tx;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float fa[4], fb[4];
      keep_factors<GATED, DROPOUT>(dat, dbt, 4 * ty + i, rows, col0, Da,
                                   inv_keep, fa, fb);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float z = tanhf(za[i][j] + ba[col0 + j]);
        if (DROPOUT) z *= fa[j];
        if (GATED) {
          float u = 1.f / (1.f + expf(-(zb[i][j] + bb[col0 + j])));
          if (DROPOUT) u *= fb[j];
          z *= u;
        }
        part[i] = fmaf(z, wc[col0 + j], part[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v = part[i];
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (tx == 0) s_s[4 * ty + i] = v;
  }
  __syncthreads();

  // per row: a = softmax weight, alpha = g . h_r, ds = a (alpha - g . out);
  // warp w owns rows 8 w .. 8 w + 7
  {
    const float* gb = g + (size_t)b * D;
    const float* ob = out + (size_t)b * D;
    float go = 0.f;
    for (int d = lane; d < D; d += 32) go = fmaf(gb[d], ob[d], go);
    go = warp_sum(go);
    const float m = ml[2 * b], l = fmaxf(ml[2 * b + 1], 1e-30f);
    const float c = cc[0];
    for (int r = 8 * warp; r < 8 * warp + 8; ++r) {
      float al = 0.f;
      for (int d = lane; d < D; d += 32) al = fmaf(gb[d], ht[d * HT_LD + r], al);
      al = warp_sum(al);
      const bool valid = r < rows && mb[r] > 0.f;
      // masked before the exp: an all-masked bag has m = NEG_INF
      const float a = valid ? expf((s_s[r] + c) - m) / l : 0.f;
      if (lane == 0) {
        ds_s[r] = a * (al - go);
        if (r < rows) a_out[row0 + r] = a;
      }
    }
  }
  __syncthreads();

  // pass 2: dpa, dpb per element; column sums of dpa, dpb and z * ds
  for (int c0 = 0; c0 < Da; c0 += CN) {
    chunk_products<T, GATED>(ht, ws, wa, wb, c0, D, Da, za, zb);
    const int col0 = c0 + 4 * tx;
    float sa[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f},
          sw[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const float ds = ds_s[r];
      float fa[4], fb[4], pa[4], pb[4];
      keep_factors<GATED, DROPOUT>(dat, dbt, r, rows, col0, Da, inv_keep,
                                   fa, fb);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = col0 + j;
        const float t = tanhf(za[i][j] + ba[k]);
        const float dz = ds * wc[k];
        float z, dpa, dpb = 0.f;
        if (GATED) {
          const float u = 1.f / (1.f + expf(-(zb[i][j] + bb[k])));
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
        pa[j] = dpa;
        pb[j] = dpb;
        sa[j] += dpa;
        sb[j] += dpb;
        sw[j] = fmaf(z, ds, sw[j]);
      }
      if (r < rows) {
        store4(dpt + (size_t)r * Kc + col0, pa);
        if (GATED) store4(dpt + (size_t)r * Kc + Da + col0, pb);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[(0 * 16 + ty) * CN + 4 * tx + j] = sa[j];
      red[(1 * 16 + ty) * CN + 4 * tx + j] = sb[j];
      red[(2 * 16 + ty) * CN + 4 * tx + j] = sw[j];
    }
    __syncthreads();
    if (tid < 3 * CN) {  // fixed order over the 16 row groups
      const int q = tid / CN, c = tid - q * CN;
      float v = 0.f;
      for (int y = 0; y < 16; ++y) v += red[(q * 16 + y) * CN + c];
      pv[q * Da + c0 + c] = v;
    }
    // the next chunk's first barrier keeps red until it has been read
  }
}

// Kernel 2.  dh rows r0 .. r0 + 63 of bag b, columns d0 .. d0 + 63.
template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_dh_kernel(const T* __restrict__ dp, const T* __restrict__ wcat,
              const float* __restrict__ a, const float* __restrict__ g,
              const float* __restrict__ mask, T* __restrict__ dh, int N,
              int D, int Kc) {
  __shared__ __align__(16) float As[KC * HT_LD];  // dp tile, transposed
  __shared__ __align__(16) float Bs[KC * CN];     // Wcat rows
  const int d0 = blockIdx.x * CN, r0 = blockIdx.y * TM, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int rows = min(TM, N - r0);
  const size_t row0 = (size_t)b * N + r0;
  const float* mb = mask + row0;

  float acc[4][4] = {};
  if (__syncthreads_or(tid < rows && mb[tid] > 0.f)) {
    for (int k0 = 0; k0 < Kc; k0 += KC) {
      __syncthreads();
      for (int i = tid; i < TM * KC; i += THREADS) {
        const int r = i / KC, kk = i - r * KC;
        As[kk * HT_LD + r] =
            r < rows ? to_f32(dp[(row0 + r) * Kc + k0 + kk]) : 0.f;
      }
      for (int i = tid; i < KC * CN; i += THREADS) {
        const int kk = i / CN, c = i - kk * CN;
        Bs[i] = to_f32(wcat[(size_t)(k0 + kk) * D + d0 + c]);
      }
      __syncthreads();
      mac_block(As, HT_LD, Bs, CN, acc);
    }
  }
  const float* gb = g + (size_t)b * D + d0 + 4 * tx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= rows) continue;
    const bool valid = mb[r] > 0.f;
    const float ar = a[row0 + r];
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = valid ? fmaf(ar, gb[j], acc[i][j]) : 0.f;
    store4(dh + (row0 + r) * D + d0 + 4 * tx, v);
  }
}

// Kernel 3.  part[s] rows d0 .. d0 + 63, columns k0 .. k0 + 63 of
// h^T [dpa | dpb] over the flattened rows of split s.
template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_dw_partial_kernel(const T* __restrict__ h, const T* __restrict__ dp,
                      const float* __restrict__ mask,
                      float* __restrict__ part,  // [S, D, Kc]
                      int M, int D, int Kc, int rows_per_split) {
  __shared__ __align__(16) float Hs[KC * CN];
  __shared__ __align__(16) float Ps[KC * CN];
  const int k0 = blockIdx.x * CN, d0 = blockIdx.y * CN, s = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row_begin = s * rows_per_split;
  const int row_end = min(M, row_begin + rows_per_split);

  float acc[4][4] = {};
  for (int r0 = row_begin; r0 < row_end; r0 += KC) {
    const int n = min(KC, row_end - r0);
    // also the barrier that lets the previous chunk's readers finish
    if (!__syncthreads_or(tid < n && mask[r0 + tid] > 0.f)) continue;
    for (int i = tid; i < KC * CN; i += THREADS) {
      const int rr = i / CN, c = i - rr * CN;
      const bool in = rr < n;
      Hs[i] = in ? to_f32(h[(size_t)(r0 + rr) * D + d0 + c]) : 0.f;
      Ps[i] = in ? to_f32(dp[(size_t)(r0 + rr) * Kc + k0 + c]) : 0.f;
    }
    __syncthreads();
    mac_block(Hs, CN, Ps, CN, acc);
  }
  float* ps = part + ((size_t)s * D + d0 + 4 * ty) * Kc + k0 + 4 * tx;
#pragma unroll
  for (int i = 0; i < 4; ++i) store4(ps + (size_t)i * Kc, acc[i]);
}

// Kernel 4.  dW = sum over s of part[s]; dvec[q] = sum over tiles of
// part_vec[tile][q], each in index order.
__global__ void __launch_bounds__(THREADS)
bwd_reduce_kernel(const float* __restrict__ part,
                  const float* __restrict__ part_vec,
                  float* __restrict__ dW, float* __restrict__ dvec, int S,
                  int n_dw, int T, int n_vec) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_dw + n_vec;
       i += gridDim.x * blockDim.x) {
    float v = 0.f;
    if (i < n_dw) {
      for (int s = 0; s < S; ++s) v += part[(size_t)s * n_dw + i];
      dW[i] = v;
    } else {
      const int j = i - n_dw;
      for (int t = 0; t < T; ++t) v += part_vec[(size_t)t * n_vec + j];
      dvec[j] = v;
    }
  }
}

template <typename T>
size_t rows_smem_bytes(int D) {
  return ((size_t)D * HT_LD + 2 * KC * CN + 3 * 16 * CN) * sizeof(float);
}

template <typename T, bool GATED, bool DROPOUT>
cudaError_t launch(const void* h, const float* mask, const void* wa,
                   const float* ba, const void* wb, const float* bb,
                   const float* wc, const float* cc, const void* wcat,
                   const uint8_t* da, const uint8_t* db, const float* out,
                   const float* ml, const float* g, void* dp, float* a,
                   float* part_vec, float* part_dw, void* dh, float* dW,
                   float* dvec, float inv_keep, int B, int N, int D, int Da,
                   int splits, int rows_per_split, cudaStream_t stream) {
  const T* ht = static_cast<const T*>(h);
  T* dpt = static_cast<T*>(dp);
  const int Kc = GATED ? 2 * Da : Da;
  const int tiles = (N + TM - 1) / TM;
  auto rows = bwd_rows_kernel<T, GATED, DROPOUT>;
  const size_t smem = rows_smem_bytes<T>(D);
  cudaError_t err = cudaFuncSetAttribute(
      rows, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  rows<<<dim3(tiles, B), THREADS, smem, stream>>>(
      ht, mask, static_cast<const T*>(wa), ba, static_cast<const T*>(wb), bb,
      wc, cc, da, db, out, ml, g, dpt, a, part_vec, inv_keep, N, D, Da);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dh_kernel<T><<<dim3(D / CN, tiles, B), THREADS, 0, stream>>>(
      dpt, static_cast<const T*>(wcat), a, g, mask, static_cast<T*>(dh), N,
      D, Kc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dw_partial_kernel<T><<<dim3(Kc / CN, D / CN, splits), THREADS, 0,
                             stream>>>(ht, dpt, mask, part_dw, B * N, D, Kc,
                                       rows_per_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n_dw = D * Kc, n_vec = 3 * Da;
  const int blocks = (n_dw + n_vec + THREADS - 1) / THREADS;
  bwd_reduce_kernel<<<blocks, THREADS, 0, stream>>>(
      part_dw, part_vec, dW, dvec, splits, n_dw, B * tiles, n_vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int mil_pool_bwd_tile_rows() { return TM; }

// h [B, N, D] f32 or bf16; mask [B, N] f32; wa/wb [D, Da] and wcat
// [Kc, D] = [Wa^T; Wb^T] (Kc = 2 Da gated, Da ungated) in h's dtype;
// ba/bb/wc [Da], cc [1], out/g [B, D], ml [B, 2] f32; da/db uint8 keep
// masks [B, N, Da] scaled by inv_keep, or both null.  Scratch: dp
// [B * N, Kc] in h's dtype, a [B, N], part_vec [B * ceil(N / TM), 3, Da],
// part_dw [splits, D, Kc] f32.  Outputs: dh [B, N, D] in h's dtype, dW
// [D, Kc] = [dWa | dWb] and dvec [3, Da] = (dba, dbb, dwc) f32.  All
// contiguous on one device and 16-byte aligned; D and Da multiples of 64,
// D <= MAX_D; rows_per_split a multiple of 32 with splits * rows_per_split
// >= B * N.  Returns the CUDA error code of the launches (0 = success).
int mil_pool_bwd(const void* h, const void* mask, const void* wa,
                 const void* ba, const void* wb, const void* bb,
                 const void* wc, const void* cc, const void* wcat,
                 const void* da, const void* db, const void* out,
                 const void* ml, const void* g, void* dp, void* a,
                 void* part_vec, void* part_dw, void* dh, void* dW,
                 void* dvec, float inv_keep, int B, int N, int D, int Da,
                 int splits, int rows_per_split, int gated, int bf16,
                 void* stream) {
  if (D > MAX_D || D % CN != 0 || Da % CN != 0 || rows_per_split % KC != 0 ||
      (long long)splits * rows_per_split < (long long)B * N ||
      (da != nullptr && db == nullptr))
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  auto u8 = [](const void* p) { return static_cast<const uint8_t*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool dropout = da != nullptr;
#define MIL_LAUNCH(T, G, DR)                                                  \
  launch<T, G, DR>(h, f(mask), wa, f(ba), wb, f(bb), f(wc), f(cc), wcat,     \
                   u8(da), u8(db), f(out), f(ml), f(g), dp, w(a),            \
                   w(part_vec), w(part_dw), dh, w(dW), w(dvec), inv_keep, B, \
                   N, D, Da, splits, rows_per_split, st)
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
