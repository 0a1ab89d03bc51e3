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
// repeat bit for bit (no float atomics).  Both dtypes tile the rows by
// 128; their products run on different cores:
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
//   bf16 bags: 128-row tiles resident in shared memory ([128][D + 8]
//     bf16, 67.6 KB at D = 256), scored on the tensor-core core of
//     mma_core.cuh that the backward shares (mma.sync m16n8k16, bf16 in,
//     f32 accumulate, ldmatrix fragments).  One cp.async pipeline per tile
//     streams the weights (Wt [Da, D] rows, gated: Wa's and Wb's columns
//     interleaved by 8 so that a thread holds both pre-activations of a
//     column) in BK = 32 deep chunks of 128 columns through the core's 3
//     stages; the tile's own columns arrive with the first chunk of
//     columns, so h leaves device memory once and the pooling reads the
//     same staged rows.  The dropout variants stage each chunk's keep
//     bytes by cp.async beside its weights (16 KB, swizzled so that the
//     epilogue's reads are conflict-free).  Each chunk's epilogue works on
//     the accumulators in registers; a row's score is summed over its 4
//     lanes, then over the 4 column warps, in a fixed order; 4 warps take
//     the tile's softmax; every thread pools a column pair over a group of
//     rows.  Two CTAs share an SM up to D = 256 (98 KB each; 115 KB with
//     the keep bytes), so one CTA's copies and epilogue overlap the
//     other's products; wider bags run one.  Its tanh and sigmoid run on
//     tanh.approx.f32 (relative error 2^-11, under the bf16 operands'
//     rounding); bf16 bags need Da % 16 == 0 (16-byte keep pieces), which
//     the wrapper pads to.
// The softmax and the pooling run in f32 on the CUDA cores, and so do the
// f32 kernel's tanhf and expf.
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
// ungated variants spill a little (PERF.md).  The bf16 kernel (0.16 ms of
// partial kernel on an H100 at 700 W, 5.7 times its bound) is held by
// shared memory and the copies: its 64 x 32 warp tiles read about 1.5 MB
// of ldmatrix fragments per 128-row tile (A again for every 128 columns),
// and 20,480 16-byte cp.async pieces a tile bring 256 KB of weights from
// L2 and 64 KB of h; wgmma, whose warpgroup reads its operands from shared
// memory once, fed by TMA, is the route further (PERF.md records the
// measurements).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_core.cuh"
#include "sgemm_core.cuh"

namespace {

using namespace sgemm;

constexpr int MAX_D = 512;      // f32: acc_s[]; bf16: D / 2 <= THREADS
constexpr int KEEP_LD = 144;    // f32: bytes per row of the staged keep
                                // masks; rows 4 apart land 16 banks apart
constexpr float NEG_INF = -1e30f;

static_assert(MAX_D / 2 <= mma::THREADS, "bf16: a column pair per thread");

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
// bf16 bags: 128-row tiles resident in shared memory, scored on the
// tensor-core core of mma_core.cuh.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int KEEP_BYTES = mma::BM * mma::BM;  // keep bytes of one chunk

// Keep-byte buffers of the dropout variants at width D: one when a chunk
// of columns is at least STAGES chunks deep (its keep bytes are staged
// with its chunk STAGES - 1, issued after the previous chunk of columns'
// epilogue), else one per stage (staged with its first chunk).
__host__ __device__ constexpr int keep_bufs(int D) {
  return D / mma::BK >= mma::STAGES ? 1 : mma::STAGES;
}

// Dynamic shared memory of the bf16 partial kernel: the resident tile
// [BM][D + 8] bf16, the weight ring (STAGES x [BM][LDK] bf16), for dropout
// the keep buffers, then the running (m, l).  After a tile's products the
// ring holds its score and softmax scratch (RING_FLOATS); between tiles
// the 8 padding elements of the tile's rows (16 bytes a row) hold the
// running pooled sums, a float2 for each thread.
size_t bf16_smem_bytes(int D, bool dropout) {
  return (size_t)mma::BM * (D + 8) * sizeof(bf16) +
         mma::STAGES * mma::TILE * sizeof(bf16) +
         (dropout ? (size_t)keep_bufs(D) * KEEP_BYTES : 0) + 4 * sizeof(float);
}

// red [4][BM] (the rows' partial scores of each column warp), p [BM]
// (softmax numerators), stat [8] (each row warp's max, then its sum).
constexpr int RING_FLOATS = 4 * mma::BM + mma::BM + 8;
static_assert(RING_FLOATS * 4 <= mma::STAGES * mma::TILE * 2,
              "the tile's scratch fits the ring");
static_assert(mma::BM * 8 * sizeof(bf16) >= mma::THREADS * sizeof(float2),
              "a float2 for each thread fits the tile's row padding");

// tanh on one SFU instruction, tanh.approx.f32: relative error at most
// 2^-10.99, under the rounding of the bf16 operands (2^-9); the epilogue
// takes the sigmoid as 0.5 tanh(x / 2) + 0.5: two SFU instructions a
// column where tanhf and expf with a division take four.
__device__ __forceinline__ float fast_tanh(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Byte offset of column jj of row r in a keep buffer [BM][BM] u8: the
// 16-byte units of a row are XOR-swizzled by (r % 8) so that the
// epilogue's reads (8 rows, 2 words each per warp) fall in distinct banks.
__device__ __forceinline__ int keep_off(int r, int jj) {
  return r * mma::BM + 16 * ((jj >> 4) ^ (r & 7)) + (jj & 15);
}

// One CTA = (split, bag): the running (m, l, acc[D]) over the CTA's rows,
// in 128-row tiles.  Per live tile, one pipeline on the core runs the
// scoring products h [Wa | Wb] in 128-wide chunks of columns, BK deep
// each: A is the tile itself, resident in shared memory, whose columns
// k0 .. k0 + 31 arrive by cp.async with the first chunk of columns; B is
// the chunk's weight rows (Wt [Da, D], k-contiguous), streamed through the
// ring.  Gated, chunk ch holds Wa's columns 64 ch .. + 63 and Wb's alike,
// interleaved by 8 (tile columns 16 j .. + 7 are Wa's 64 ch + 8 j .. + 7,
// the next 8 Wb's) so that a thread holds both pre-activations of its
// columns; ungated, Wa's 128 ch .. + 127; columns past Da load zeros and
// are skipped.  After each chunk of columns its epilogue adds tanh,
// sigmoid, the keep factors (staged by cp.async beside the weights) and wc
// into the rows' partial scores, which the 4 lanes of a row group reduce
// and scatter (lane t keeps rows mma::row_of(t, 0) and (t, 2)).  Then the
// 4 column warps of a row sum its score in a fixed order, 4 warps take the
// softmax of the 128 rows, and every thread pools p h over the resident
// tile: column pair q of D by row group gi (rows gi, gi + G, ..), bf16x2
// reads of consecutive words; the groups are added in order at the end.
// What lives across tiles (m, l, the pooled sums) stays in shared memory,
// so that the products keep the registers.
template <bool GATED, bool DROPOUT>
__global__ void __launch_bounds__(mma::THREADS, 2)
pool_partial_bf16_kernel(const bf16* __restrict__ h,
                         const float* __restrict__ mask,
                         const bf16* __restrict__ wa,
                         const float* __restrict__ ba,
                         const bf16* __restrict__ wb,
                         const float* __restrict__ bb,
                         const float* __restrict__ wc,
                         const float* __restrict__ cc,
                         const uint8_t* __restrict__ da,  // or null
                         const uint8_t* __restrict__ db,
                         float* __restrict__ part_acc,  // [B, S, D]
                         float* __restrict__ part_ml,   // [B, S, 2]
                         float inv_keep, int N, int D, int Da,
                         int rows_per_split) {
  constexpr int BM = mma::BM;
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const int lda = D + 8;
  const int kbufs = keep_bufs(D);
  bf16* tile = reinterpret_cast<bf16*>(dyn_smem);
  bf16* ring = tile + BM * lda;
  uint8_t* keep = reinterpret_cast<uint8_t*>(ring + mma::STAGES * mma::TILE);
  float* ml_s = reinterpret_cast<float*>(keep + (DROPOUT ? kbufs : 0) *
                                                    KEEP_BYTES);
  float* red = reinterpret_cast<float*>(ring);
  float* p_s = red + 4 * BM;
  float* stat = p_s + BM;
  // thread t's pooled sums: the padding of tile row t / 2
  auto pooled = [&](int t) {
    return reinterpret_cast<float2*>(tile + (t >> 1) * lda + D) + (t & 1);
  };

  const int split = blockIdx.x, S = gridDim.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row_begin = split * rows_per_split;
  const int row_end = min(N, row_begin + rows_per_split);
  const size_t bag = (size_t)b * N;  // flattened index of the bag's row 0
  const float* mb = mask + bag;
  const int kd = D / mma::BK;  // chunks of depth per chunk of columns
  // c / kd as (c * kd_magic) >> 20, exact for c < 2^16 (kd <= 16): the
  // chunk counters take no integer division
  const uint32_t kd_magic = ((1u << 20) + kd - 1) / kd;
  auto col_chunk = [&](int c) { return (int)((c * kd_magic) >> 20); };
  const int n_chunks = GATED ? (Da + 63) / 64 : (Da + BM - 1) / BM;
  const int kload = kbufs == 1 ? mma::STAGES - 1 : 0;
  const int P = D / 2, G = max(1, mma::THREADS / P);  // pooling layout
  const int q = tid % P, gi = tid / P;

  // the thread's two pieces of a chunk's weights: tile columns jw and
  // jw + 64 at k values 8 (tid % 4) .. + 7
  const int jw = tid >> 2;
  int wcol[2];
  const bf16* wrow[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int j = jw + 64 * p;
    wcol[p] = GATED ? 8 * (j >> 4) + (j & 7) : j;
    wrow[p] = (GATED && ((j >> 3) & 1) ? wb : wa) + (size_t)wcol[p] * D +
              8 * (tid & 3);
  }

  *pooled(tid) = make_float2(0.f, 0.f);
  if (tid == 0) {
    ml_s[0] = NEG_INF;
    ml_s[1] = 0.f;
  }

  for (int r0 = row_begin; r0 < row_end; r0 += BM) {
    const int rows = min(BM, row_end - r0);
    const bool valid = tid < rows && mb[r0 + tid] > 0.f;  // row tid
    // also the barrier that lets the previous tile's readers finish
    if (!__syncthreads_or(valid)) continue;  // all padding: contributes 0

    const bf16* ht = h + (bag + r0) * D;
    auto h_row = [&](int i) -> const bf16* {
      return i < rows ? ht + (size_t)i * D : nullptr;
    };
    auto load = [&](int c, bf16* buf, int) {
      const int ch = col_chunk(c), kc = c - ch * kd, k0 = kc * mma::BK;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int col = wcol[p] + (GATED ? 64 : BM) * ch;
        const bool in = col < Da;
        mma::cp_async16(buf + (jw + 64 * p) * mma::LDK + 8 * (tid & 3),
                        in ? wrow[p] + (size_t)(GATED ? 64 : BM) * ch * D + k0
                           : wa,
                        in ? 16 : 0);
      }
      if (ch == 0) mma::stage_k(tile + k0, h_row, k0, h, lda);
      if (DROPOUT && kc == kload) {
        // the chunk's keep bytes [BM rows][da | db or da] in 16-byte units
        // (thread: unit u = tid % 8 of rows tid / 8 + 32 p)
        uint8_t* kt = keep + (ch % kbufs) * KEEP_BYTES;
        const int u = tid & 7;
        const int col = GATED ? 64 * ch + 16 * (u & 3) : BM * ch + 16 * u;
        const uint8_t* src =
            (GATED && u >= 4 ? db : da) + (bag + r0) * Da + col;
#pragma unroll
        for (int p = 0; p < KEEP_BYTES / 16 / mma::THREADS; ++p) {
          const int i = (tid >> 3) + 32 * p;
          const bool in = i < rows && col < Da;
          mma::cp_async16(kt + keep_off(i, 16 * u),
                          in ? src + (size_t)i * Da : da, in ? 16 : 0);
        }
      }
    };
    float acc[4][4][4];
    mma::zero(acc);
    // part[j]: the 4 lanes' share of the score of tile row
    // mma::row_of(lane % 4, 2 j) so far
    float part[2] = {0.f, 0.f};
    auto epilogue = [&](int c) {
      const int ch = col_chunk(c);
      if (c + 1 - ch * kd != kd) return;
      const uint8_t* kt = keep + (ch % kbufs) * KEEP_BYTES;
      // v[k]: this chunk's share of row mma::row_of(k / 2, 2 (k % 2))
      float v[8] = {};
#pragma unroll
      for (int qq = 0; qq < (GATED ? 2 : 4); ++qq) {
        // gated: the pre-activations of Wa in n8 tile 2 qq, of Wb in
        // 2 qq + 1; jj: the column within the chunk's keep bytes
        const int ni = GATED ? 2 * qq : qq;
        const int jj =
            (GATED ? 16 : 32) * (warp & 3) + 8 * qq + 2 * (lane & 3);
        const int col = (GATED ? 64 : BM) * ch + jj;
        if (col >= Da) continue;  // Da % 8 == 0: both columns or neither
        // gated, z wc = tanh(a + ba) sigmoid(b + bb) wc with
        // sigmoid(x) wc = hw tanh(x / 2) + hw, hw = wc / 2
        const float bak[2] = {ba[col], ba[col + 1]};
        const float wck[2] = {(GATED ? 0.5f : 1.f) * wc[col],
                              (GATED ? 0.5f : 1.f) * wc[col + 1]};
        const float hbb[2] = {GATED ? 0.5f * bb[col] : 0.f,
                              GATED ? 0.5f * bb[col + 1] : 0.f};
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int mi = k >> 1, j = k & 1;
          const int r = mma::row_of(mi, 2 * j);
          // the keep factors: da (gated: da db) as a float, exactly, by
          // the exponent trick (an OR and a subtraction at the full rate,
          // where a conversion runs at a quarter of it), times inv_keep
          // (squared when gated)
          float keepf[2] = {1.f, 1.f};
          if (DROPOUT) {
            const uchar2 ka =
                *reinterpret_cast<const uchar2*>(kt + keep_off(r, jj));
            uint32_t kk[2] = {ka.x, ka.y};
            if (GATED) {
              const uchar2 kb = *reinterpret_cast<const uchar2*>(
                  kt + keep_off(r, 64 + jj));
              kk[0] *= kb.x;
              kk[1] *= kb.y;
            }
#pragma unroll
            for (int e = 0; e < 2; ++e)
              keepf[e] = (__uint_as_float(0x4b000000u | kk[e]) - 8388608.f) *
                         (GATED ? inv_keep * inv_keep : inv_keep);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float t = fast_tanh(acc[mi][ni][2 * j + e] + bak[e]);
            if (DROPOUT) t *= keepf[e];
            const float uw =
                GATED ? fmaf(wck[e],
                             fast_tanh(fmaf(0.5f, acc[mi][ni + 1][2 * j + e],
                                            hbb[e])),
                             wck[e])
                      : wck[e];
            v[k] = fmaf(t, uw, v[k]);
          }
        }
      }
      // reduce over the 4 lanes of the row group and scatter: after the
      // exchange with lane ^ 2, lane t holds rows k = 4 (t / 2) .. + 3;
      // after lane ^ 1, rows k = 2 t, 2 t + 1
      const bool hi2 = lane & 2, hi1 = lane & 1;
      float w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = (hi2 ? v[k + 4] : v[k]) +
               __shfl_xor_sync(0xffffffffu, hi2 ? v[k] : v[k + 4], 2);
#pragma unroll
      for (int k = 0; k < 2; ++k)
        part[k] += (hi1 ? w[k + 2] : w[k]) +
                   __shfl_xor_sync(0xffffffffu, hi1 ? w[k] : w[k + 2], 1);
      mma::zero(acc);
    };
    mma::mma_loop_resident(
        n_chunks * kd, ring, tile, lda,
        [&](int c) { return (c - col_chunk(c) * kd) * mma::BK; }, load,
        epilogue, acc);

    // a row's score: the 4 column warps in a fixed order (the ring is free
    // now); the softmax of the tile's rows on warps 0-3, thread tid = row
    // tid
#pragma unroll
    for (int j = 0; j < 2; ++j)
      red[(warp & 3) * BM + mma::row_of(lane & 3, 2 * j)] = part[j];
    __syncthreads();
    float s = NEG_INF;
    if (tid < BM) {
      const float v = (red[tid] + red[BM + tid]) +
                      (red[2 * BM + tid] + red[3 * BM + tid]);
      if (valid) s = v + cc[0];
      const float wm = warp_max(s);
      if (lane == 0) stat[warp] = wm;
    }
    __syncthreads();
    const float m_old = ml_s[0];
    const float m_new =
        fmaxf(m_old, fmaxf(fmaxf(stat[0], stat[1]), fmaxf(stat[2], stat[3])));
    if (tid < BM) {
      const float p = s == NEG_INF ? 0.f : expf(s - m_new);
      p_s[tid] = p;
      const float ws = warp_sum(p);
      if (lane == 0) stat[4 + warp] = ws;
    }
    __syncthreads();  // every thread has read m_old
    const float corr = expf(m_old - m_new);
    if (tid == 0) {
      ml_s[0] = m_new;
      ml_s[1] = ml_s[1] * corr + ((stat[4] + stat[5]) + (stat[6] + stat[7]));
    }
    if (gi < G) {
      float2 x = *pooled(tid);
      x.x *= corr;
      x.y *= corr;
      const bf16* hc = tile + 2 * q;
#pragma unroll 4
      for (int r = gi; r < rows; r += G) {
        const float p = p_s[r];
        const float2 hv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(hc + r * lda));
        x.x = fmaf(p, hv.x, x.x);
        x.y = fmaf(p, hv.y, x.y);
      }
      *pooled(tid) = x;
    }
  }

  // the row groups' pooled sums, added in group order
  __syncthreads();
  if (tid < P) {
    float2 x = *pooled(q);
    for (int g = 1; g < G; ++g) {
      const float2 y = *pooled(g * P + q);
      x.x += y.x;
      x.y += y.y;
    }
    *reinterpret_cast<float2*>(part_acc + ((size_t)b * S + split) * D +
                               2 * q) = x;
  }
  if (tid == 0) {  // ml_s was last written by this thread
    part_ml[((size_t)b * S + split) * 2 + 0] = ml_s[0];
    part_ml[((size_t)b * S + split) * 2 + 1] = ml_s[1];
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
cudaError_t partial_kernel(int D, PartialFn<bf16>* k, size_t* smem) {
  *k = pool_partial_bf16_kernel<GATED, DROPOUT>;
  *smem = bf16_smem_bytes(D, DROPOUT);
  // all of the SM's shared memory for it, so that two CTAs of 115 KB fit
  cudaError_t err = cudaFuncSetAttribute(
      *k, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
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
int mil_pool_fwd_tile_rows(int bf16) { return bf16 ? mma::BM : GT; }

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
// aligned; D a multiple of 32 up to MAX_D, Da of 8 (bf16 bags: of 16, up
// to 65536).  rows_per_split is a
// multiple of mil_pool_fwd_tile_rows(bf16).  Returns the CUDA error code
// of the launches (0 = success).
int mil_pool_fwd(const void* h, const void* mask, const void* wa,
                 const void* ba, const void* wb, const void* bb,
                 const void* wc, const void* cc, const void* da,
                 const void* db, void* part_acc, void* part_ml, void* out,
                 void* ml, float inv_keep, int B, int N, int D, int Da,
                 int splits, int rows_per_split, int gated, int bf16,
                 void* stream) {
  if (D > MAX_D || D % 32 != 0 || Da % 8 != 0 ||
      (bf16 && (Da % 16 != 0 || Da > 1 << 16)) || rows_per_split < 1 ||
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
