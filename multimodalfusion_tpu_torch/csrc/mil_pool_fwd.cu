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
// (mil_attention.py:220-229).
//
// Design.  The TPU kernel walks a bag's row tiles one after another in a
// sequential grid and carries (m, l, acc) in scratch.  Here a bag's rows
// are split across `splits` CTAs (grid = splits x B, at most one wave of
// the card, from the occupancy query).  Each CTA loops over its row tiles,
// scores each tile, and folds it into a running (m, l, acc[D]) flash-style;
// tiles whose rows are all padding are skipped.  The partials go to a
// scratch buffer and a second kernel merges them per bag in a fixed split
// order with the algebra of ops/sharded_pool.py::_combine_local, so results
// repeat bit for bit (no float atomics).  The tile height depends on the
// bag's dtype:
//   f32 bags: 128-row tiles whose products h [Wa | Wb] run on the SGEMM
//     core of sgemm_core.cuh, which the backward shares (plain f32 on the
//     CUDA cores, no TF32).  Per 128-wide chunk of columns (gated: 64
//     columns of Wa beside the same 64 of Wb; ungated: 128 of Wa), A = the
//     tile's h rows, transposed as they are staged, and B = the weight
//     rows, staged as they lie; rows past the bag's or the split's end and
//     columns past Da load zeros.  The epilogue applies tanh, sigmoid, the
//     keep factors and wc (staged in shared memory per chunk) and adds into
//     a per-row partial score, which the 16 lanes of a half-warp sum in a
//     fixed order.  Once the tile's softmax numerators are known, its rows
//     of h are read again (from L2, coalesced along d, in row order) into
//     acc[D].  The tile is not kept in shared memory: 21 KB a CTA (40 KB
//     with the staged keep masks), two CTAs on an SM at every D.
//   bf16 bags: 64-row tiles kept in shared memory; the scoring products
//     run on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//     accumulate); each warp owns a strided set of 8-column blocks of Da
//     and reads Wt [Da, D] (the nn.Linear layout) as 32-bit fragments
//     through L1/L2.
// tanh, sigmoid, the softmax and the pooling run in f32 on the CUDA cores.
//
// Bound.  At B=32, N=4096, D=Da=256, gated, 90% of rows valid, the valid
// rows need 2 n D 2 Da = 30.9 GFLOP of scoring products (plus 2 n D for the
// pooling) against about 0.12 GB of bytes: f32 bags are bound by the CUDA
// cores' 67 TFLOP/s (461.9 us), bf16 bags by the tensor cores' 989 TFLOP/s
// (31.3 us; 36.3 us of bytes with dropout's keep masks).  What still
// separates the f32 kernel from its bound: the core runs at about 58% of
// the f32 peak (the backward's dh on the same core), it scores every row of
// a tile that holds any valid row (34.4 GFLOP at 90% valid rows), the
// epilogue's tanhf, expf and division per element of h [Wa | Wb] do not
// overlap the products, and under the 128-register cap the dropout and
// ungated variants spill a little (PERF.md).  The bf16 kernel stages nothing asynchronously and
// re-reads the weight fragments from L2 for every tile: wgmma fed by TMA,
// with the weights held in shared memory across tiles, is the route to its
// bound.  PERF.md records the gaps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sgemm_core.cuh"

namespace {

using namespace sgemm;

constexpr int TM = 64;          // bf16: rows per tile (f32 tiles: GT)
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 512;      // acc[]: MAX_D / THREADS per thread
constexpr int D_PER_THREAD = MAX_D / THREADS;
constexpr int PAD = 8;          // bf16: tile row padding, conflict-free frags
constexpr int KEEP_LD = 144;    // f32: bytes per row of the staged keep
                                // masks; rows 4 apart land 16 banks apart
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

// ---------------------------------------------------------------------------
// f32 bags: 128-row tiles on the SGEMM core.
// ---------------------------------------------------------------------------

// x + sum over the rows r < rows of p[r] * hr[r][d], in row order (hr: the
// tile's first row of h, row stride D).  Each group of 8 rows is loaded
// before its products, so the loads' L2 latencies overlap (measured: 8 left
// the gated variant's registers without a spill, 16 did not).
__device__ __forceinline__ float pool_rows_f32(const float* hr,
                                               const float* p, int rows,
                                               int d, int D, float x) {
  const float* col = hr + d;
  int r = 0;
  for (; r + 8 <= rows; r += 8) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = col[(size_t)(r + k) * D];
#pragma unroll
    for (int k = 0; k < 8; ++k) x = fmaf(p[r + k], v[k], x);
  }
  for (; r < rows; ++r) x = fmaf(p[r], col[(size_t)r * D], x);
  return x;
}

// One CTA = (split, bag): the running (m, l, acc[D]) over the CTA's rows.
// acc[D] lives in shared memory (each element read and written by one
// thread) and (m, l) in stat_s, so that the core keeps its registers.
// Each chunk's epilogue reads ba, bb, wc and the keep masks da/db [B, N,
// Da] of its columns from shared memory, staged at the chunk's start
// while the accumulators are not yet live (measured: read from global
// memory in the epilogue, under the 128-register cap of two CTAs per SM,
// the dropout variant ran about 6% slower).
template <bool GATED, bool DROPOUT>
__global__ void __launch_bounds__(THREADS, 2)
pool_partial_f32_kernel(const float* __restrict__ h,
                        const float* __restrict__ mask,
                        const float* __restrict__ wa,
                        const float* __restrict__ ba,
                        const float* __restrict__ wb,
                        const float* __restrict__ bb,
                        const float* __restrict__ wc,
                        const float* __restrict__ cc,
                        const uint8_t* __restrict__ da,  // or null
                        const uint8_t* __restrict__ db,
                        float* __restrict__ part_acc,  // [B, S, D]
                        float* __restrict__ part_ml,   // [B, S, 2]
                        float inv_keep, int N, int D, int Da,
                        int rows_per_split) {
  __shared__ __align__(16) float smem[2 * STAGE];
  __shared__ float s_s[GT];        // the tile's scores
  __shared__ float p_s[GT];        // softmax numerators
  __shared__ float acc_s[MAX_D];
  __shared__ float stat_s[3];      // m, l, the tile's rescale factor
  __shared__ __align__(16) float vec_s[3][GT];  // ba, bb, wc of a chunk
  __shared__ __align__(16) uint8_t keep_s[DROPOUT ? GT * KEEP_LD : 16];

  const int split = blockIdx.x, S = gridDim.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, lane = tid & 31;
  const int row_begin = split * rows_per_split;
  const int row_end = min(N, row_begin + rows_per_split);
  const size_t bag = (size_t)b * N;  // flattened index of the bag's row 0
  const float* mb = mask + bag;

  for (int d = tid; d < D; d += THREADS) acc_s[d] = 0.f;
  if (tid == 0) {
    stat_s[0] = NEG_INF;
    stat_s[1] = 0.f;
  }

  // staging of a chunk: thread tid loads depth 4 (tid & 1) .. + 3 of tile
  // row tid / 2 (A) and columns bn .. bn + 3 of weight row bk (B)
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const int bk = tid >> 5, bn = 4 * (tid & 31);
  auto put = [&](float* st, const float4& ra, const float4& rb) {
    put_transposed(st, ra);
    put_rows(st + GK * S_LD, rb);
  };
  const int n_chunks = GATED ? (Da + 63) / 64 : (Da + GT - 1) / GT;

  for (int r0 = row_begin; r0 < row_end; r0 += GT) {
    const int rows = min(GT, row_end - r0);
    // also the barrier that lets the previous tile's readers finish
    if (!__syncthreads_or(tid < rows && mb[r0 + tid] > 0.f))
      continue;  // all padding: contributes 0

    // the products h [Wa | Wb] in 128-wide chunks of columns (gated: Wa's
    // c0 .. c0 + 63 beside Wb's; ungated: Wa's c0 .. c0 + 127), each
    // followed by the epilogue into the rows' partial scores
    const float* ht = h + (bag + r0) * D;
    const bool a_in = (tid >> 1) < rows;
    const float* pa = ht + (size_t)(tid >> 1) * D + 4 * (tid & 1);
    float part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int c0 = GATED ? 64 * ch : GT * ch;
      // the epilogue's operands of the chunk's columns lc (gated: lc < 64,
      // da then db; ungated: lc < 128), zeros past Da and past the tile,
      // once the previous chunk's epilogue is done; the core's first
      // barrier publishes them
      __syncthreads();
      if (tid < GT) {
        const bool in = (!GATED || tid < 64) && c0 + tid < Da;
        vec_s[0][tid] = in ? ba[c0 + tid] : 0.f;
        vec_s[1][tid] = in && GATED ? bb[c0 + tid] : 0.f;
        vec_s[2][tid] = in ? wc[c0 + tid] : 0.f;
      }
      if (DROPOUT) {
#pragma unroll 4
        for (int k = tid; k < GT * 32; k += THREADS) {  // 32 x 4 bytes a row
          const int r = k >> 5, c4 = 4 * (k & 31);
          const int lc = GATED ? (c4 & 63) : c4;
          uchar4 v = make_uchar4(0, 0, 0, 0);
          if (r < rows && c0 + lc < Da)
            v = *reinterpret_cast<const uchar4*>(
                (GATED && c4 >= 64 ? db : da) + (bag + r0 + r) * Da + c0 +
                lc);
          *reinterpret_cast<uchar4*>(keep_s + r * KEEP_LD + c4) = v;
        }
      }
      const int col = c0 + (GATED ? (bn & 63) : bn);
      const bool b_in = col < Da;  // Da % 8 == 0: all 4 columns or none
      const float* pb =
          (GATED && bn >= 64 ? wb : wa) + (size_t)bk * Da + col;
      auto fetch = [&](int c, float4& ra, float4& rb) {
        ra = a_in ? load4(pa + c * GK) : zero4;
        rb = b_in ? load4(pb + (size_t)c * GK * Da) : zero4;
        return true;
      };
      float acc[8][8];
      zero(acc);
      sgemm_loop(D / GK, smem, fetch, put, acc);

#pragma unroll
      for (int q = 0; q < (GATED ? 1 : 2); ++q) {
        const int lc = 64 * q + 4 * tx;
        if (c0 + lc >= Da) continue;  // Da % 8 == 0: all 4 columns or none
        const float4 ba4 = *reinterpret_cast<const float4*>(&vec_s[0][lc]);
        const float4 bb4 = *reinterpret_cast<const float4*>(&vec_s[1][lc]);
        const float4 wc4 = *reinterpret_cast<const float4*>(&vec_s[2][lc]);
        const float bak[4] = {ba4.x, ba4.y, ba4.z, ba4.w};
        const float bbk[4] = {bb4.x, bb4.y, bb4.z, bb4.w};
        const float wck[4] = {wc4.x, wc4.y, wc4.z, wc4.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = row_of(i);
          float fa[4] = {1.f, 1.f, 1.f, 1.f}, fb[4] = {1.f, 1.f, 1.f, 1.f};
          if (DROPOUT) {
            const uint8_t* kr = keep_s + r * KEEP_LD;
            const uchar4 ka = *reinterpret_cast<const uchar4*>(kr + lc);
            const uchar4 kb = *reinterpret_cast<const uchar4*>(
                kr + (GATED ? 64 + 4 * tx : lc));
            fa[0] = ka.x * inv_keep; fa[1] = ka.y * inv_keep;
            fa[2] = ka.z * inv_keep; fa[3] = ka.w * inv_keep;
            fb[0] = kb.x * inv_keep; fb[1] = kb.y * inv_keep;
            fb[2] = kb.z * inv_keep; fb[3] = kb.w * inv_keep;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float z = tanhf(acc[i][4 * q + j] + bak[j]);
            if (DROPOUT) z *= fa[j];
            if (GATED) {
              const float u = 1.f / (1.f + expf(-(acc[i][4 + j] + bbk[j])));
              z *= DROPOUT ? u * fb[j] : u;
            }
            part[i] = fmaf(z, wck[j], part[i]);
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

    if (tid < 32) {  // lane owns rows lane + 32 j
      float s[4], p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = lane + 32 * j;
        s[j] = (r < rows && mb[r0 + r] > 0.f) ? s_s[r] + cc[0] : NEG_INF;
      }
      const float m_run = stat_s[0];
      const float m_new = fmaxf(
          m_run, warp_max(fmaxf(fmaxf(s[0], s[1]), fmaxf(s[2], s[3]))));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = s[j] == NEG_INF ? 0.f : expf(s[j] - m_new);
        p_s[lane + 32 * j] = p[j];
      }
      const float psum = warp_sum((p[0] + p[1]) + (p[2] + p[3]));
      if (lane == 0) {
        const float corr = expf(m_run - m_new);
        stat_s[0] = m_new;
        stat_s[1] = stat_s[1] * corr + psum;
        stat_s[2] = corr;
      }
    }
    __syncthreads();

    const float corr = stat_s[2];
    for (int d = tid; d < D; d += THREADS)
      acc_s[d] = pool_rows_f32(ht, p_s, rows, d, D, acc_s[d] * corr);
  }

  float* out_acc = part_acc + ((size_t)b * S + split) * D;
  for (int d = tid; d < D; d += THREADS) out_acc[d] = acc_s[d];
  if (tid == 0) {  // stat_s was last written by this thread
    part_ml[((size_t)b * S + split) * 2 + 0] = stat_s[0];
    part_ml[((size_t)b * S + split) * 2 + 1] = stat_s[1];
  }
}

// ---------------------------------------------------------------------------
// bf16 bags: 64-row tiles on the tensor cores.
// ---------------------------------------------------------------------------

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

// Tile rows [0, rows) of hb into hs[r][d] (row stride D + PAD).
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

// Raw scores of the tile's rows, without cc, on the tensor cores.
// ws: [WARPS][TM] per-warp column sums.  DROPOUT: da/db point at the
// tile's first row of the keep masks; rows at or past `rows` are padding
// of the tile and read no mask.
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
__device__ __forceinline__ float pool_rows(const __nv_bfloat16* hs,
                                           const float* p, int rows, int d,
                                           int D, float x) {
  for (int r = 0; r < rows; ++r)
    x = fmaf(p[r], __bfloat162float(hs[r * (D + PAD) + d]), x);
  return x;
}

size_t bf16_smem_bytes(int D) {
  return (size_t)TM * (D + PAD) * sizeof(__nv_bfloat16) +
         WARPS * TM * sizeof(float);
}

// One CTA = (split, bag): the running (m, l, acc[D]) over the CTA's rows.
// Dynamic shared memory: the tile, then the scoring scratch.
template <bool GATED, bool DROPOUT>
__global__ void __launch_bounds__(THREADS)
pool_partial_bf16_kernel(const __nv_bfloat16* __restrict__ h,
                         const float* __restrict__ mask,
                         const __nv_bfloat16* __restrict__ wa,
                         const float* __restrict__ ba,
                         const __nv_bfloat16* __restrict__ wb,
                         const float* __restrict__ bb,
                         const float* __restrict__ wc,
                         const float* __restrict__ cc,
                         const uint8_t* __restrict__ da,  // or null
                         const uint8_t* __restrict__ db,
                         float* __restrict__ part_acc,  // [B, S, D]
                         float* __restrict__ part_ml,   // [B, S, 2]
                         float inv_keep, int N, int D, int Da,
                         int rows_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);
  float* ws = reinterpret_cast<float*>(
      smem + (size_t)TM * (D + PAD) * sizeof(__nv_bfloat16));
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

// ---------------------------------------------------------------------------
// The merge and the launches.
// ---------------------------------------------------------------------------

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
using PartialFn = void (*)(const T*, const float*, const T*, const float*,
                           const T*, const float*, const float*,
                           const float*, const uint8_t*, const uint8_t*,
                           float*, float*, float, int, int, int, int);

// The partial kernel of a variant and its dynamic shared memory, allowed
// (the f32 kernel's shared memory is all static).
template <bool GATED, bool DROPOUT>
cudaError_t partial_kernel(int, PartialFn<float>* k, size_t* smem) {
  *k = pool_partial_f32_kernel<GATED, DROPOUT>;
  *smem = 0;
  return cudaSuccess;
}
template <bool GATED, bool DROPOUT>
cudaError_t partial_kernel(int D, PartialFn<__nv_bfloat16>* k,
                           size_t* smem) {
  *k = pool_partial_bf16_kernel<GATED, DROPOUT>;
  *smem = bf16_smem_bytes(D);
  return cudaFuncSetAttribute(*k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

template <typename T, bool GATED, bool DROPOUT>
cudaError_t launch(const T* h, const float* mask, const T* wa,
                   const float* ba, const T* wb, const float* bb,
                   const float* wc, const float* cc, const uint8_t* da,
                   const uint8_t* db, float* part_acc, float* part_ml,
                   float* out, float* ml, float inv_keep, int B, int N, int D,
                   int Da, int splits, int rows_per_split,
                   cudaStream_t stream) {
  PartialFn<T> kern;
  size_t smem;
  cudaError_t err = partial_kernel<GATED, DROPOUT>(D, &kern, &smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(splits, B), THREADS, smem, stream>>>(
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
  PartialFn<T> kern;
  size_t smem;
  int n = 0;
  if (partial_kernel<GATED, DROPOUT>(D, &kern, &smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, THREADS,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

extern "C" {

int mil_pool_fwd_max_d() { return MAX_D; }

// Rows per tile of the partial kernel for f32 (bf16 = 0) or bf16 bags:
// rows_per_split must be a multiple of it.
int mil_pool_fwd_tile_rows(int bf16) { return bf16 ? TM : GT; }

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
// multiple of mil_pool_fwd_tile_rows(bf16).  Returns the CUDA error code
// of the launches (0 = success).
int mil_pool_fwd(const void* h, const void* mask, const void* wa,
                 const void* ba, const void* wb, const void* bb,
                 const void* wc, const void* cc, const void* da,
                 const void* db, void* part_acc, void* part_ml, void* out,
                 void* ml, float inv_keep, int B, int N, int D, int Da,
                 int splits, int rows_per_split, int gated, int bf16,
                 void* stream) {
  if (D > MAX_D || D % 32 != 0 || Da % 8 != 0 || rows_per_split < 1 ||
      rows_per_split % mil_pool_fwd_tile_rows(bf16) != 0 ||
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
