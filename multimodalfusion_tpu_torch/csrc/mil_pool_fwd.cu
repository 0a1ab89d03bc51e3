// Fused masked attention-MIL pooling, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_pool_kernel`, launched by
// `_fused_pool_pallas` in multimodalfusion_tpu/ops/mil_attention.py.
// Per bag b of a padded batch h [B, N, D] with mask [B, N]:
//
//   s_i    = (tanh(h_i Wa + ba) [* sigmoid(h_i Wb + bb)]) . wc + cc
//   s_i    = NEG_INF where mask_i == 0
//   pooled = sum_i softmax(s)_i h_i            -> out [B, D] f32
//   ml     = (max_i s_i, sum_i exp(s_i - max)) -> ml  [B, 2] f32
//
// A bag with no valid row pools to 0 with ml = (NEG_INF, 0), as on the TPU.
//
// Attention-branch dropout (the DROPOUT variants): uint8 keep masks da, db
// [B, N, Da] scale tanh(.) by da * inv_keep and sigmoid(.) by db * inv_keep
// before their product, where the TPU kernel applies them
// (mil_attention.py:220-229).  The variants without dropout compile to the
// same code as before the masks were added.
//
// Design.  The TPU kernel walks a bag's row tiles one after another in a
// sequential grid and carries (m, l, acc) in scratch.  Here a bag's rows
// are split across `splits` CTAs (grid = splits x B, enough CTAs to fill
// the 132 SMs at B = 16-32).  Each CTA loops over its row tiles, keeps the
// tile in shared memory, scores it, and folds it into a running
// (m, l, acc[D]) flash-style; tiles whose rows are all padding are
// skipped.  The partials go to a scratch buffer and a second kernel merges
// them per bag in a fixed split order with the algebra of
// ops/sharded_pool.py::_combine_local, so results repeat bit for bit (no
// float atomics).
// Both variants work on 64-row tiles:
//   f32 bags: plain f32 on the CUDA cores (no TF32), register-tiled like an
//     SGEMM: the tile is kept transposed in shared memory, the weights
//     W [D, Da] are staged through shared memory in 32 x 64 chunks, and each
//     thread computes a 4 x 4 block of each branch's products.
//   bf16 bags: the scoring products run on the tensor cores (mma.sync
//     m16n8k16, bf16 in, f32 accumulate); each warp owns a strided set of
//     8-column blocks of Da and reads Wt [Da, D] (the nn.Linear layout) as
//     32-bit fragments through L1/L2.
// tanh, sigmoid, the softmax and the pooling run in f32 on the CUDA cores.

// Bound.  At the serving shape (B=32, N=4096, D=Da=256, bf16, gated) the
// kernel must read 64 MiB (about 20 us at 3.35 TB/s) and do 34.4 GFLOP of
// matrix products (about 35 us at the 989 TFLOP/s bf16 tensor-core peak),
// plus 67 M transcendentals: it is bound by tensor-core operations.  The
// bf16 variant uses mma.sync on the tensor cores but stages nothing
// asynchronously and re-reads the weight fragments from L2 for every tile,
// so it stays well above that bound; wgmma fed by TMA, with the weights
// held in shared memory across tiles, is the route to it.  f32 bags do the
// same products on the CUDA cores, bound by their 67 TFLOP/s (about 460 us
// at that shape).  PERF.md records the gaps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TM = 64;          // rows per tile
constexpr int THREADS = 256;    // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 512;      // acc[] registers: MAX_D / THREADS per thread
constexpr int D_PER_THREAD = MAX_D / THREADS;
constexpr int CN = 64;          // f32: attention columns per pass
constexpr int KC = 32;          // f32: depth of a staged weight chunk
constexpr int HT_LD = TM + 4;   // f32: row stride of the transposed tile
constexpr int PAD = 8;          // bf16: tile row padding, conflict-free frags
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <bool GATED>
__device__ __forceinline__ float gate(float za, float zb, float bak,
                                      float bbk) {
  float z = tanhf(za + bak);
  if (GATED) z *= 1.f / (1.f + expf(-(zb + bbk)));
  return z;
}

// gate() with inverted dropout: daf, dbf = keep bit * inv_keep.
template <bool GATED>
__device__ __forceinline__ float gate_drop(float za, float zb, float bak,
                                           float bbk, float daf, float dbf) {
  float z = tanhf(za + bak) * daf;
  if (GATED) z *= (1.f / (1.f + expf(-(zb + bbk)))) * dbf;
  return z;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A[16x16] * B[16x8], bf16 in, f32 accumulate (PTX fragment layouts:
// lane = 4 * g + t; A regs hold rows g / g+8 at columns 2t, 2t+1 (+8);
// B regs hold column g at k = 2t, 2t+1 (+8); D holds rows g / g+8 at
// columns 2t, 2t+1).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// f32: tile rows [0, rows) of hb into ht[d][r] (transposed), zeros beyond.
__device__ __forceinline__ void load_tile(const float* hb, float* ht,
                                          int rows, int D) {
  for (int i = threadIdx.x; i < TM * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    ht[d * HT_LD + r] = (r < rows) ? hb[(size_t)r * D + d] : 0.f;
  }
}

// bf16: tile rows [0, rows) of hb into hs[r][d] (row stride D + PAD).
__device__ __forceinline__ void load_tile(const __nv_bfloat16* hb,
                                          __nv_bfloat16* hs, int rows,
                                          int D) {
  const int chunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < TM * chunks; i += THREADS) {
    const int r = i / chunks, c = i - r * chunks;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows)
      v = *reinterpret_cast<const uint4*>(hb + (size_t)r * D + c * 8);
    *reinterpret_cast<uint4*>(hs + r * (D + PAD) + c * 8) = v;
  }
}

// f32: raw scores of the tile's rows, without cc.  Thread (ty, tx) owns rows
// 4 ty .. 4 ty + 3 and, in each pass, columns c0 + 4 tx .. + 3; the column
// sum is reduced over the 16 lanes of a half-warp.  ws: 2 x [KC][CN].
// DROPOUT: da/db point at the tile's first row of the keep masks; rows at
// or past `rows` are padding of the tile and read no mask.
template <bool GATED, bool DROPOUT>
__device__ __forceinline__ void score_tile(const float* ht, float* ws,
                                           const float* wa, const float* ba,
                                           const float* wb, const float* bb,
                                           const float* wc, float* s_out,
                                           int D, int Da,
                                           const uint8_t* da,
                                           const uint8_t* db, float inv_keep,
                                           int rows) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float* wsa = ws;
  float* wsb = ws + KC * CN;
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < Da; c0 += CN) {
    float za[4][4] = {}, zb[4][4] = {};
    for (int k0 = 0; k0 < D; k0 += KC) {
      __syncthreads();  // the previous chunk's readers are done
      for (int i = tid; i < KC * CN / 4; i += THREADS) {
        const int kk = i / (CN / 4), c4 = (i % (CN / 4)) * 4;
        float4 va = make_float4(0.f, 0.f, 0.f, 0.f), vb = va;
        if (c0 + c4 < Da) {  // Da % 8 == 0: a float4 never straddles Da
          va = *reinterpret_cast<const float4*>(
              wa + (size_t)(k0 + kk) * Da + c0 + c4);
          if (GATED)
            vb = *reinterpret_cast<const float4*>(
                wb + (size_t)(k0 + kk) * Da + c0 + c4);
        }
        *reinterpret_cast<float4*>(wsa + kk * CN + c4) = va;
        if (GATED) *reinterpret_cast<float4*>(wsb + kk * CN + c4) = vb;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < KC; ++k) {
        const float4 x4 =
            *reinterpret_cast<const float4*>(ht + (k0 + k) * HT_LD + 4 * ty);
        const float4 a4 = *reinterpret_cast<const float4*>(wsa + k * CN + 4 * tx);
        const float x[4] = {x4.x, x4.y, x4.z, x4.w};
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) za[i][j] = fmaf(x[i], a[j], za[i][j]);
        if (GATED) {
          const float4 b4 =
              *reinterpret_cast<const float4*>(wsb + k * CN + 4 * tx);
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) zb[i][j] = fmaf(x[i], bv[j], zb[i][j]);
        }
      }
    }
    if constexpr (DROPOUT) {
      const int col0 = c0 + 4 * tx;  // Da % 8 == 0: all 4 columns or none
      if (col0 < Da) {
        float bak[4], bbk[4], wck[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bak[j] = ba[col0 + j];
          bbk[j] = GATED ? bb[col0 + j] : 0.f;
          wck[j] = wc[col0 + j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 4 * ty + i;
          uchar4 ka = make_uchar4(0, 0, 0, 0), kb = ka;
          if (r < rows) {
            ka = *reinterpret_cast<const uchar4*>(da + (size_t)r * Da + col0);
            if (GATED)
              kb = *reinterpret_cast<const uchar4*>(db + (size_t)r * Da +
                                                    col0);
          }
          const float fa[4] = {ka.x * inv_keep, ka.y * inv_keep,
                               ka.z * inv_keep, ka.w * inv_keep};
          const float fb[4] = {kb.x * inv_keep, kb.y * inv_keep,
                               kb.z * inv_keep, kb.w * inv_keep};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            part[i] = fmaf(gate_drop<GATED>(za[i][j], zb[i][j], bak[j],
                                            bbk[j], fa[j], fb[j]),
                           wck[j], part[i]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + 4 * tx + j;
        if (col < Da) {
          const float bak = ba[col], wck = wc[col];
          const float bbk = GATED ? bb[col] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            part[i] = fmaf(gate<GATED>(za[i][j], zb[i][j], bak, bbk), wck,
                           part[i]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v = part[i];
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (tx == 0) s_out[4 * ty + i] = v;
  }
}

// bf16: raw scores of the tile's rows, without cc, on the tensor cores.
// ws: [WARPS][TM] per-warp column sums.  DROPOUT as in the f32 variant.
template <bool GATED, bool DROPOUT>
__device__ __forceinline__ void score_tile(const __nv_bfloat16* hs, float* ws,
                                           const __nv_bfloat16* wat,
                                           const float* ba,
                                           const __nv_bfloat16* wbt,
                                           const float* bb, const float* wc,
                                           float* s_out, int D, int Da,
                                           const uint8_t* da,
                                           const uint8_t* db, float inv_keep,
                                           int rows) {
  constexpr int MB = TM / 16;  // 16-row blocks per tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, ld = D + PAD;
  // part[m][j]: this lane's share of the score of row 16 m + g + 8 j
  float part[MB][2];
#pragma unroll
  for (int m = 0; m < MB; ++m) part[m][0] = part[m][1] = 0.f;
  for (int nb = warp; nb < Da / 8; nb += WARPS) {
    const __nv_bfloat16* wa_g = wat + (size_t)(nb * 8 + g) * D + 2 * t;
    const __nv_bfloat16* wb_g = wbt + (size_t)(nb * 8 + g) * D + 2 * t;
    float za[MB][4], zb[MB][4];
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) za[m][q] = zb[m][q] = 0.f;
#pragma unroll 4  // measured: loads of 4 steps in flight
    for (int k0 = 0; k0 < D; k0 += 16) {
      const uint32_t a0 = ld32(wa_g + k0), a1 = ld32(wa_g + k0 + 8);
      uint32_t b0 = 0u, b1 = 0u;
      if (GATED) { b0 = ld32(wb_g + k0); b1 = ld32(wb_g + k0 + 8); }
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        const __nv_bfloat16* x = hs + (16 * m + g) * ld + k0 + 2 * t;
        const uint32_t frag[4] = {ld32(x), ld32(x + 8 * ld), ld32(x + 8),
                                  ld32(x + 8 * ld + 8)};
        mma_bf16(za[m], frag, a0, a1);
        if (GATED) mma_bf16(zb[m], frag, b0, b1);
      }
    }
    const int col = nb * 8 + 2 * t;
    const float ba0 = ba[col], ba1 = ba[col + 1];
    const float wc0 = wc[col], wc1 = wc[col + 1];
    const float bb0 = GATED ? bb[col] : 0.f, bb1 = GATED ? bb[col + 1] : 0.f;
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      if constexpr (DROPOUT) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {  // rows 16 m + g and 16 m + g + 8
          const int r = 16 * m + g + 8 * j;
          uchar2 ka = make_uchar2(0, 0), kb = ka;
          if (r < rows) {
            ka = *reinterpret_cast<const uchar2*>(da + (size_t)r * Da + col);
            if (GATED)
              kb = *reinterpret_cast<const uchar2*>(db + (size_t)r * Da +
                                                    col);
          }
          part[m][j] +=
              gate_drop<GATED>(za[m][2 * j], zb[m][2 * j], ba0, bb0,
                               ka.x * inv_keep, kb.x * inv_keep) * wc0 +
              gate_drop<GATED>(za[m][2 * j + 1], zb[m][2 * j + 1], ba1, bb1,
                               ka.y * inv_keep, kb.y * inv_keep) * wc1;
        }
      } else {
        part[m][0] += gate<GATED>(za[m][0], zb[m][0], ba0, bb0) * wc0 +
                      gate<GATED>(za[m][1], zb[m][1], ba1, bb1) * wc1;
        part[m][1] += gate<GATED>(za[m][2], zb[m][2], ba0, bb0) * wc0 +
                      gate<GATED>(za[m][3], zb[m][3], ba1, bb1) * wc1;
      }
    }
  }
  // sum the columns: over the 4 lanes of a row group, then across warps
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v = part[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (t == 0) ws[warp * TM + 16 * m + g + 8 * j] = v;
    }
  __syncthreads();
  if (tid < TM) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += ws[w * TM + tid];
    s_out[tid] = v;
  }
}

// x + sum over the tile's rows r < rows of p[r] * tile[r][d], in row order.
// p[r] is 0 for the rows past `rows`, whose tile entries are zero.
__device__ __forceinline__ float pool_rows(const float* ht, const float* p,
                                           int rows, int d, int D, float x) {
  const float* col = ht + d * HT_LD;  // conflict-free float4s along r
  for (int r = 0; r < rows; r += 4) {
    const float4 v = *reinterpret_cast<const float4*>(col + r);
    x = fmaf(p[r], v.x, x);
    x = fmaf(p[r + 1], v.y, x);
    x = fmaf(p[r + 2], v.z, x);
    x = fmaf(p[r + 3], v.w, x);
  }
  return x;
}
__device__ __forceinline__ float pool_rows(const __nv_bfloat16* hs,
                                           const float* p, int rows, int d,
                                           int D, float x) {
  for (int r = 0; r < rows; ++r)
    x = fmaf(p[r], __bfloat162float(hs[r * (D + PAD) + d]), x);
  return x;
}

// One CTA = (split, bag): the running (m, l, acc[D]) over the CTA's rows.
// Dynamic shared memory: the tile, then the scoring scratch.
template <typename T, bool GATED, bool DROPOUT>
__global__ void __launch_bounds__(THREADS)
pool_partial_kernel(const T* __restrict__ h, const float* __restrict__ mask,
                    const T* __restrict__ wa, const float* __restrict__ ba,
                    const T* __restrict__ wb, const float* __restrict__ bb,
                    const float* __restrict__ wc, const float* __restrict__ cc,
                    const uint8_t* __restrict__ da,  // [B, N, Da] or null
                    const uint8_t* __restrict__ db,
                    float* __restrict__ part_acc,  // [B, S, D]
                    float* __restrict__ part_ml,   // [B, S, 2]
                    float inv_keep, int N, int D, int Da,
                    int rows_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool F32 = std::is_same<T, float>::value;
  T* tile = reinterpret_cast<T*>(smem);
  float* ws = reinterpret_cast<float*>(
      smem + (F32 ? (size_t)D * HT_LD * sizeof(float)
                  : (size_t)TM * (D + PAD) * sizeof(T)));
  __shared__ float s_s[TM];    // the tile's scores
  __shared__ float p_s[TM];    // softmax numerators
  __shared__ float stat_s[3];  // m_new, corr, tile sum

  const int split = blockIdx.x, S = gridDim.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row_begin = split * rows_per_split;
  const int row_end = min(N, row_begin + rows_per_split);
  const float* mb = mask + (size_t)b * N;
  const float c0 = cc[0];

  float m_run = NEG_INF, l_run = 0.f;
  float acc[D_PER_THREAD];
#pragma unroll
  for (int j = 0; j < D_PER_THREAD; ++j) acc[j] = 0.f;

  for (int r0 = row_begin; r0 < row_end; r0 += TM) {
    const int rows = min(TM, row_end - r0);
    const bool valid = tid < rows && mb[r0 + tid] > 0.f;
    // also the barrier that lets the previous tile's readers finish
    if (!__syncthreads_or(valid)) continue;  // all padding: contributes 0

    load_tile(h + ((size_t)b * N + r0) * D, tile, rows, D);
    __syncthreads();
    const size_t m0 = DROPOUT ? ((size_t)b * N + r0) * Da : 0;
    score_tile<GATED, DROPOUT>(tile, ws, wa, ba, wb, bb, wc, s_s, D, Da,
                               da + m0, db + m0, inv_keep, rows);
    __syncthreads();

    if (warp == 0) {  // lane owns rows lane and lane + 32
      float s[2], p[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = lane + 32 * j;
        s[j] = (r < rows && mb[r0 + r] > 0.f) ? s_s[r] + c0 : NEG_INF;
      }
      const float m_new = fmaxf(m_run, warp_max(fmaxf(s[0], s[1])));
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        p[j] = s[j] == NEG_INF ? 0.f : expf(s[j] - m_new);
        p_s[lane + 32 * j] = p[j];
      }
      const float psum = warp_sum(p[0] + p[1]);
      if (lane == 0) {
        stat_s[0] = m_new;
        stat_s[1] = expf(m_run - m_new);
        stat_s[2] = psum;
      }
    }
    __syncthreads();

    const float corr = stat_s[1];
    m_run = stat_s[0];
    l_run = l_run * corr + stat_s[2];
#pragma unroll
    for (int j = 0; j < D_PER_THREAD; ++j) {
      const int d = tid + j * THREADS;
      if (d < D) {
        acc[j] = pool_rows(tile, p_s, rows, d, D, acc[j] * corr);
      }
    }
  }

  float* pa = part_acc + ((size_t)b * S + split) * D;
#pragma unroll
  for (int j = 0; j < D_PER_THREAD; ++j) {
    const int d = tid + j * THREADS;
    if (d < D) pa[d] = acc[j];
  }
  if (tid == 0) {
    part_ml[((size_t)b * S + split) * 2 + 0] = m_run;
    part_ml[((size_t)b * S + split) * 2 + 1] = l_run;
  }
}

// One CTA per bag: merge the S partials in split order.
__global__ void __launch_bounds__(THREADS)
pool_merge_kernel(const float* __restrict__ part_acc,
                  const float* __restrict__ part_ml, float* __restrict__ out,
                  float* __restrict__ ml, int S, int D) {
  const int b = blockIdx.x;
  const float* pm = part_ml + (size_t)b * S * 2;
  float m = NEG_INF;
  for (int s = 0; s < S; ++s) m = fmaxf(m, pm[2 * s]);
  float l = 0.f;
  for (int s = 0; s < S; ++s) l += pm[2 * s + 1] * expf(pm[2 * s] - m);
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < S; ++s)
      a += part_acc[((size_t)b * S + s) * D + d] * expf(pm[2 * s] - m);
    out[(size_t)b * D + d] = a * inv;
  }
  if (threadIdx.x == 0) {
    ml[2 * b + 0] = m;
    ml[2 * b + 1] = l;
  }
}

template <typename T>
size_t smem_bytes(int D) {
  return std::is_same<T, float>::value
             ? ((size_t)D * HT_LD + 2 * KC * CN) * sizeof(float)
             : (size_t)TM * (D + PAD) * sizeof(T) + WARPS * TM * sizeof(float);
}

// The partial kernel of a variant, with its dynamic shared memory allowed.
template <typename T, bool GATED, bool DROPOUT>
cudaError_t partial_kernel(
    int D, decltype(&pool_partial_kernel<T, GATED, DROPOUT>)* k) {
  *k = pool_partial_kernel<T, GATED, DROPOUT>;
  return cudaFuncSetAttribute(*k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes<T>(D));
}

template <typename T, bool GATED, bool DROPOUT>
cudaError_t launch(const T* h, const float* mask, const T* wa,
                   const float* ba, const T* wb, const float* bb,
                   const float* wc, const float* cc, const uint8_t* da,
                   const uint8_t* db, float* part_acc, float* part_ml,
                   float* out, float* ml, float inv_keep, int B, int N, int D,
                   int Da, int splits, int rows_per_split,
                   cudaStream_t stream) {
  decltype(&pool_partial_kernel<T, GATED, DROPOUT>) kern;
  cudaError_t err = partial_kernel<T, GATED, DROPOUT>(D, &kern);
  if (err != cudaSuccess) return err;
  kern<<<dim3(splits, B), THREADS, smem_bytes<T>(D), stream>>>(
      h, mask, wa, ba, wb, bb, wc, cc, da, db, part_acc, part_ml, inv_keep,
      N, D, Da, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pool_merge_kernel<<<B, THREADS, 0, stream>>>(part_acc, part_ml, out, ml,
                                               splits, D);
  return cudaGetLastError();
}

template <typename T, bool GATED, bool DROPOUT>
int ctas_per_sm(int D) {
  decltype(&pool_partial_kernel<T, GATED, DROPOUT>) kern;
  int n = 0;
  if (partial_kernel<T, GATED, DROPOUT>(D, &kern) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kern, THREADS, smem_bytes<T>(D)) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

extern "C" {

int mil_pool_fwd_max_d() { return MAX_D; }
int mil_pool_fwd_tile_rows() { return TM; }

// CTAs of the partial kernel that fit on one SM of the current device at
// width D (-1 on error): the wrapper sizes the grid to one full wave.
int mil_pool_fwd_ctas_per_sm(int D, int gated, int bf16, int dropout) {
#define MIL_CTAS(T, G)                                                  \
  (dropout ? ctas_per_sm<T, G, true>(D) : ctas_per_sm<T, G, false>(D))
  if (bf16)
    return gated ? MIL_CTAS(__nv_bfloat16, true)
                 : MIL_CTAS(__nv_bfloat16, false);
  return gated ? MIL_CTAS(float, true) : MIL_CTAS(float, false);
#undef MIL_CTAS
}

// h [B, N, D] f32 or bf16, mask [B, N] f32, ba/bb/wc [Da] f32, cc [1] f32;
// the weights in h's dtype: wa/wb [D, Da] for f32 bags, their transposes
// [Da, D] for bf16 bags.  da/db: uint8 keep masks [B, N, Da] scaled by
// inv_keep, or both null for no dropout (db is read only when gated).
// Scratch part_acc [B, splits, D] and part_ml [B, splits, 2] f32; out
// [B, D] and ml [B, 2] f32.  All contiguous on one device and 16-byte
// aligned; D a multiple of 32 up to MAX_D, Da of 8.  rows_per_split is a
// multiple of TM.  Returns the CUDA error code of the launches (0 =
// success).
int mil_pool_fwd(const void* h, const void* mask, const void* wa,
                 const void* ba, const void* wb, const void* bb,
                 const void* wc, const void* cc, const void* da,
                 const void* db, void* part_acc, void* part_ml, void* out,
                 void* ml, float inv_keep, int B, int N, int D, int Da,
                 int splits, int rows_per_split, int gated, int bf16,
                 void* stream) {
  if (D > MAX_D || D % KC != 0 || Da % 8 != 0 || rows_per_split % TM != 0 ||
      (da != nullptr && db == nullptr))
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  auto u8 = [](const void* p) { return static_cast<const uint8_t*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool dropout = da != nullptr;
#define MIL_LAUNCH(T, G, DR)                                                 \
  launch<T, G, DR>(static_cast<const T*>(h), f(mask),                       \
                   static_cast<const T*>(wa), f(ba),                        \
                   static_cast<const T*>(wb), f(bb), f(wc), f(cc), u8(da),  \
                   u8(db), w(part_acc), w(part_ml), w(out), w(ml), inv_keep, \
                   B, N, D, Da, splits, rows_per_split, st)
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
