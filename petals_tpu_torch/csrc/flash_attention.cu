// Causal flash attention over a dense, preallocated KV buffer for Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces the Pallas kernel of petals_tpu/ops/flash_attention.py (_kernel,
// reached from flash_attend): attention of q [batch, q_len, hq, d] over
// k, v [batch, kv_buf_len, hkv, d], of which the first kv_length positions
// are valid. Query row i sits at absolute position q_offset + i and sees kv
// position j when j <= q_offset + i, j < kv_length and, with a sliding
// window, j > q_offset + i - window. q_offset and kv_length are scalars
// shared by the batch, read by the kernel from two int32s on the card (as
// K2 reads its chunk's position), so one launch, and one CUDA graph that
// captures it, serves a padded chunk at any position and real length: the
// grid depends only on the shapes. kv_length is clamped to [0, the buffer's
// length], since no host checks a value held on the card. GQA
// (query head h reads kv head h / group), optional ALiBi (slopes[h] * j
// added to the scaled scores), online softmax in float32, probabilities
// rounded to the storage type for the PV product (as the TPU kernel feeds
// its matrix unit), float32 accumulator, one rounding to the output type at
// the end. Same contract as the plain PyTorch version
// beside the wrapper (petals_tpu_torch/ops/flash_attention.py
// flash_attend_reference).
//
// Where the TPU kernel makes the KV axis the last, sequential grid dimension
// and carries m / l / acc in scratch memory from one grid step to the next,
// here a block owns a query tile of one batch row and loops over the KV
// tiles itself; nothing carries between blocks. The TPU kernel's
// tile-needed predicate becomes the loop's bounds: the loop starts at the
// first tile the window lets the tile's first row see and stops at
// min(kv_length, last row + 1), so tiles past the causal frontier, past
// kv_length or before the window are never read. The bf16 kernel masks
// only the tiles some row sees in part (the TPU kernel's interior / edge
// split); the float32 kernel masks every tile.
//
// q, k and v are read through the strides they are given (elements; the head
// dim itself is contiguous): a session's per-block cache is a view of the
// span-stacked buffer, and a lane of the dense pool a view of the pool, so
// nothing is copied or transposed per step. Nothing is padded: ragged q_len
// and any kv_buf_len are masked here.
//
// What bounds it on this card. At a 512-row chunk of Mistral-7B's heads the
// work is ~130 operations per byte of K/V read (each K/V row is read once per
// KV head by the bound's count), under the card's ridge of ~295, so the bound
// is bytes for short chunks and operations for long ones; either way it is a
// few microseconds. The first version computed both products with CUDA-core
// FMAs (68x that bound) and read each K/V tile once per query head. bf16 now
// runs on wgmma with the GQA group packed into the 64 rows of a block, so a
// tile is read once per kv head (the section before launch_wgmma). float32
// keeps the CUDA-core kernel below: 4 rows x 8 columns a thread from
// register tiles, K/V tiles staged with cp.async into padded shared rows, the
// KV range between the window's and the causal frontier, every tile masked.
//
// Head widths 64, 96, 128 and 256: the wgmma kernel pads a 96-wide tile to
// 128 columns in shared memory (S = Q K^T over the real columns, V's padded
// columns zeros written once, the padded outputs dropped; the cache is read
// as it is). Gemma-2's attention logit softcap is a launch argument (0:
// off): cap * tanhf(s / cap) on the scaled score, before ALiBi and the mask.
//
// Masked probabilities are selected to exactly 0, never left to
// exp(NEG_INF - m): while every score so far was masked, m itself is NEG_INF
// and that exponential is 1. A row that sees nothing (kv_length 0, or a
// window and length that leave it no position) keeps l == 0 and writes exact
// zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

namespace {

using namespace hopper;  // the wgmma layout, descriptors and products; group_tiles

constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;  // DEFAULT_MASK_VALUE

constexpr int BQ = 64;   // query rows per block
constexpr int BKV = 64;  // kv positions per tile
constexpr int NT = 128;  // threads per block
constexpr int RPT = BQ / (NT / 8);  // rows per thread = 4
constexpr int CPT = BKV / 8;        // score columns per thread = 8

// the CUDA-core kernel is instantiated for float32 only (bf16 runs on wgmma)
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <typename T, int D>
__host__ __device__ constexpr int kv_pitch() {
  return D + 16 / (int)sizeof(T);  // +16 bytes per row: row r starts 4 banks after row r-1
}

// Start copying `rows` rows of `row_bytes` bytes (a multiple of 16) from
// global memory (row pitch src_pitch bytes) into shared memory (row pitch
// dst_pitch bytes) with asynchronous 16-byte copies: each thread starts all
// of its copies before any completes, so a whole tile is in flight at once.
__device__ __forceinline__ void copy_rows(char* dst, int dst_pitch, const char* src,
                                          long src_pitch, int rows, int row_bytes) {
  const int vec_per_row = row_bytes / 16;
  const int total = rows * vec_per_row;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / vec_per_row, c = i - r * vec_per_row;
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + r * dst_pitch + c * 16));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src + r * src_pitch + c * 16));
  }
}

// Wait for this thread's cp.async copies; a __syncthreads() after it makes
// every thread's copies visible to the block.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// grid (ceil(q_len / BQ), hq, batch), NT threads. Thread (ty, tx) =
// (tid / 8, tid % 8) owns query rows ty + 16 i (i < 4); in the score tile it
// owns kv columns tx + 8 j (j < 8), in the output tile dims tx + 8 k.
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_attention_kernel(
    const T* __restrict__ q,          // [batch, q_len, hq, D] through q_s*
    const T* __restrict__ k,          // [batch, kv_buf_len, hkv, D] through k_s*
    const T* __restrict__ v,          // [batch, kv_buf_len, hkv, D] through v_s*
    const float* __restrict__ slopes, // [hq] ALiBi slopes or nullptr
    T* __restrict__ out,              // [batch, q_len, hq, D], contiguous
    int q_len, int hq, int hkv,
    long q_sb, long q_ss, long q_sh,  // strides of q in elements: batch, row, head
    long k_sb, long k_ss, long k_sh,
    long v_sb, long v_ss, long v_sh,
    const int* __restrict__ q_offset_p, const int* __restrict__ kv_length_p, int kv_buf_len,
    int window, float scale, float softcap) {
  const int q_offset = *q_offset_p;
  const int kv_length = min(max(*kv_length_p, 0), kv_buf_len);
  constexpr int RB = D * (int)sizeof(T);  // bytes of one K/V row of one head
  constexpr int KP = kv_pitch<T, D>();
  constexpr int QP = D + 4;
  constexpr int PP = BKV + 1;
  constexpr int DPT = D / 8;  // output dims per thread
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;

  extern __shared__ __align__(16) char smem[];
  T* k_s = reinterpret_cast<T*>(smem);                     // [BKV][KP]
  T* v_s = k_s + BKV * KP;                                 // [BKV][KP]
  float* q_s = reinterpret_cast<float*>(v_s + BKV * KP);   // [BQ][QP]
  float* p_s = q_s + BQ * QP;                              // [BQ][PP]

  const T* q_base = q + b * q_sb + h * q_sh;
  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i - r * D;
    const int row = qb * BQ + r;
    q_s[r * QP + d] = row < q_len ? to_f32(q_base[row * q_ss + d]) : 0.f;
  }
  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DPT; ++kk) acc[i][kk] = 0.f;
  }
  const float slope = slopes != nullptr ? slopes[h] : 0.f;

  // the KV range any real row of this tile sees: from the first position the
  // window leaves the FIRST row, to the causal frontier of the LAST real row
  const int q_block_start = q_offset + qb * BQ;
  const int last_row = min(q_len, (qb + 1) * BQ) - 1;
  const int kv_hi = min(kv_length, q_offset + last_row + 1);
  int kv_lo = window > 0 ? max(0, q_block_start - window + 1) : 0;
  kv_lo -= kv_lo % BKV;

  const char* k_base = reinterpret_cast<const char*>(k + b * k_sb + kvh * k_sh);
  const char* v_base = reinterpret_cast<const char*>(v + b * v_sb + kvh * v_sh);
  const long k_pitch = k_ss * (long)sizeof(T), v_pitch = v_ss * (long)sizeof(T);

  for (int t0 = kv_lo; t0 < kv_hi; t0 += BKV) {
    const int tile = min(BKV, kv_hi - t0);
    __syncthreads();  // the previous tile's readers are done (and q_s is written)
    copy_rows(reinterpret_cast<char*>(k_s), KP * sizeof(T), k_base + t0 * k_pitch, k_pitch, tile, RB);
    copy_rows(reinterpret_cast<char*>(v_s), KP * sizeof(T), v_base + t0 * v_pitch, v_pitch, tile, RB);
    cp_async_wait_all();
    __syncthreads();

    // columns past `tile` read stale shared memory; they are masked below
    // and their scores never reach the max, the sum or the PV product
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = q_s[(ty + 16 * i) * QP + d];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = to_f32(k_s[(tx + 8 * c) * KP + d]);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) s[i][c] += qv[i] * kv[c];
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + 16 * i;
      const int q_pos = q_block_start + r;
      bool ok[CPT];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = tx + 8 * c;
        const int kv_pos = t0 + col;
        ok[c] = col < tile && kv_pos <= q_pos && kv_pos < kv_length &&
                (window <= 0 || kv_pos > q_pos - window);
        s[i][c] = softcapped(s[i][c] * scale, softcap) + slope * (float)kv_pos;
        if (ok[c]) mx = fmaxf(mx, s[i][c]);
      }
      // the 8 threads of a row are 8 neighbouring lanes of one warp
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float e = ok[c] ? expf(s[i][c] - m_new) : 0.f;
        // the PV product takes the probability in the storage type; the
        // softmax's denominator sums it unrounded
        p_s[r * PP + tx + 8 * c] = to_f32(from_f32<T>(e));
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int kk = 0; kk < DPT; ++kk) acc[i][kk] *= alpha;
    }
    __syncthreads();

    // rows past `tile` hold stale shared memory: never multiply them, even by 0
    for (int c = 0; c < tile; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = p_s[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int kk = 0; kk < DPT; ++kk) {
        const float vv = to_f32(v_s[c * KP + tx + 8 * kk]);
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][kk] += pv[i] * vv;
      }
    }
  }

  // a row that saw no visible position keeps l == 0 and writes exact zeros
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = qb * BQ + ty + 16 * i;
    if (row < q_len) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      T* o = out + (((long)b * q_len + row) * hq + h) * D;
#pragma unroll
      for (int kk = 0; kk < DPT; ++kk) o[tx + 8 * kk] = from_f32<T>(acc[i][kk] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma. One warpgroup (128 threads) owns a block of 64 "rows": QP =
// 64 / tile query positions x the query heads of one group tile of one kv
// head (row m = position * tile + head; 64 - QP * tile rows idle when the
// tile does not divide 64), so each K/V tile is loaded once into shared
// memory and read by the whole group tile. A group of at most 16 is one tile;
// a wider one (Falcon-7B's 71) is cut by group_tiles (hopper_wgmma.cuh) into
// tiles of at most 16 heads, one grid index each over the same kv head, the
// ragged last tile's idle heads masked like idle rows. Grid (hkv * group
// tiles, batch, n_q_tiles), the query tile taken in reverse (the tiles with
// the most KV under the causal frontier start first).
//
// Shared memory, 1024-byte aligned: Q [64 rows x D], then STAGES stages of
// K and V tiles [64 kv rows x D]. Every tile is stored as D / 64 column
// atoms of [64 rows x 128 bytes] (8 KB each) in wgmma's 128-byte swizzle
// (16-byte chunk c of row r at chunk c ^ (r % 8)), filled by cp.async with
// rows past the end zero-filled:
//   - S = Q K^T: wgmma m64n64k16, A = Q and B = K both K-major (a K tile
//     [kv, d] is K-major for B as it is stored), D / 16 steps;
//   - the online softmax runs on the accumulator registers (thread: rows
//     lane / 4 and lane / 4 + 8 of its warp's 16, 16 columns each; quad
//     shuffles for the row max; each thread keeps a partial row sum that the
//     quad adds once at the end);
//   - P is rounded to bf16 in registers, where the accumulator of two n8
//     column blocks is exactly the A fragment of a k16 step, and O += P V is
//     wgmma m64nDk16 with A from registers and V read as an MN-major
//     (transposed) B straight from its [kv, d] tile: atoms of 64 d-columns
//     8 KB apart (the descriptor's leading offset), 8-row groups 1 KB apart
//     (its stride offset), a k16 step 2 KB further.
// A K/V tile is masked only where some row of the block sees part of it (the
// causal diagonal, kv_length, the window's edge): the TPU kernel's
// _compute_interior / _compute_edge split. Every wgmma is issued outside any
// branch that differs between threads (ptxas serializes wgmma behind a
// divergent path).
// ---------------------------------------------------------------------------

constexpr int WARP = 32;
constexpr int WG_ROWS = 64;      // rows of a block (query positions x heads)
constexpr int WG_KV = 64;        // kv rows per tile
constexpr int WG_STAGES = 2;     // K/V tiles in the ring

template <int D>
struct WgmmaSmem {
  static constexpr int DP = padded_dim(D);          // the tiles' width: head_dim 96 pads to 128
  static constexpr int TILE = DP / 64 * ATOM_BYTES;  // Q, K or V
  static constexpr int K_OFFSET = TILE;              // Q first
  static constexpr int STAGE = 2 * TILE;             // K then V
  static constexpr int BYTES = TILE + WG_STAGES * STAGE + 1024;  // + slack to align the base
};

// The online softmax of one tile on the S accumulator (log2 domain; scores
// already scaled): row j in {0, 1} of this thread is rows lane / 4 + 8 j of
// its warp's 16. Masked scores become probability 0 by a select.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             const int (&q_pos)[2], int t0, int col0, int kv_length,
                                             int window) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (((i >> 1) & 1) != j) continue;
      if (MASK) {
        const int kv = t0 + col0 + 8 * (i / 4) + (i & 1);
        const bool ok = kv <= q_pos[j] && kv < kv_length && (window <= 0 || kv > q_pos[j] - window);
        if (!ok) s[i] = NEG_INF;
      }
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[j], mx);
    alpha[j] = exp2f(m[j] - m_new);
    m[j] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (((i >> 1) & 1) != j) continue;
      const float e = (MASK && s[i] == NEG_INF) ? 0.f : exp2f(s[i] - m_new);
      s[i] = e;
      sum += e;
    }
    l[j] = l[j] * alpha[j] + sum;
  }
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 2) flash_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q,  // [batch, q_len, hq, D] through q_s*
    const __nv_bfloat16* __restrict__ k,  // [batch, kv_buf_len, hkv, D] through k_s*
    const __nv_bfloat16* __restrict__ v,
    const float* __restrict__ slopes,     // [hq] ALiBi slopes or nullptr
    __nv_bfloat16* __restrict__ out,      // [batch, q_len, hq, D], contiguous
    int q_len, int hq, int hkv, long q_sb, long q_ss, long q_sh, long k_sb, long k_ss, long k_sh,
    long v_sb, long v_ss, long v_sh, const int* __restrict__ q_offset_p, const int* __restrict__ kv_length_p,
    int kv_buf_len, int window, float scale, float softcap) {
  using S = WgmmaSmem<D>;
  constexpr int DP = S::DP;
  const int q_offset = *q_offset_p;
  const int kv_length = min(max(*kv_length_p, 0), kv_buf_len);
  constexpr int CH = D / 8;  // 16-byte chunks of a row
  extern __shared__ unsigned char wg_smem_raw[];
  const uint32_t raw_base = smem_u32(wg_smem_raw);
  const uint32_t base = (raw_base + 1023) & ~1023u;

  const GroupTiles gt_of = group_tiles(hq / hkv);
  const int group = gt_of.size;    // heads of a (full) group tile: the row packing's stride
  const int qp = WG_ROWS / group;  // query positions of a block
  const int kvh = blockIdx.x / gt_of.n, b = blockIdx.y;
  const int h0 = kvh * (hq / hkv) + blockIdx.x % gt_of.n * group;  // this tile's first query head
  const int heads = min(group, hq / hkv - blockIdx.x % gt_of.n * group);  // the ragged last tile's real heads
  const int tile = gridDim.z - 1 - blockIdx.z;  // heaviest first
  const int pos0 = tile * qp;                   // the block's first position in the chunk
  const int tid = threadIdx.x, warp = tid / WARP, lane = tid % WARP;

  // the KV range any real row sees: from the window's start for the first
  // position to the causal frontier of the last real one
  const int p_first = q_offset + pos0;
  const int p_last = q_offset + min(q_len, pos0 + qp) - 1;
  const int kv_hi = min(kv_length, p_last + 1);
  const int kv_lo = window > 0 ? max(0, p_first - window + 1) : 0;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + WG_KV - 1) / WG_KV : 0;

  // Q: row m = position * group + head; idle rows, a ragged tile's idle
  // heads and rows past q_len zero-fill
  for (int e = tid; e < WG_ROWS * CH; e += WG_THREADS) {
    const int m = e / CH, c = e % CH;
    const int pos = m / group, h = m % group;
    const bool ok = pos < qp && pos0 + pos < q_len && h < heads;
    const __nv_bfloat16* src = ok ? q + b * q_sb + (long)(pos0 + pos) * q_ss + (long)(h0 + h) * q_sh + c * 8 : q;
    cp_async16(base + (c / 8) * ATOM_BYTES + m * 128 + (((c % 8) ^ (m % 8)) * 16), src, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // a padded width (head_dim 96): the V tiles' columns past D are zeros, so
  // the PV product's padded output columns (dropped) stay finite; the
  // copies below fill columns < D only
  if constexpr (DP != D) {
    constexpr int PAD = (DP - D) / 8;
    unsigned char* aligned = wg_smem_raw + (base - raw_base);
    for (int e = tid; e < WG_STAGES * WG_KV * PAD; e += WG_THREADS) {
      const int st = e / (WG_KV * PAD), r = e / PAD % WG_KV, c = CH + e % PAD;
      *reinterpret_cast<uint4*>(aligned + S::K_OFFSET + st * S::STAGE + S::TILE + sw128(r, c)) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }

  const __nv_bfloat16* k_base = k + b * k_sb + kvh * k_sh;
  const __nv_bfloat16* v_base = v + b * v_sb + kvh * v_sh;
  auto load_tile = [&](int j) {
    if (j < n_tiles) {
      const int t0 = kv_lo + j * WG_KV;
      const uint32_t ks = base + S::K_OFFSET + (j % WG_STAGES) * S::STAGE;
      for (int e = tid; e < WG_KV * CH; e += WG_THREADS) {
        const int r = e / CH, c = e % CH;
        const bool ok = t0 + r < kv_hi;
        const uint32_t off = (c / 8) * ATOM_BYTES + r * 128 + (((c % 8) ^ (r % 8)) * 16);
        cp_async16(ks + off, ok ? k_base + (long)(t0 + r) * k_ss + c * 8 : k, ok);
        cp_async16(ks + S::TILE + off, ok ? v_base + (long)(t0 + r) * v_ss + c * 8 : v, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  load_tile(0);

  // this thread's two rows: (position, head) and their scales in log2 units
  int q_pos[2], head[2];
  bool real[2];
  float slope[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int m = 16 * warp + lane / 4 + 8 * j;
    const int pos = m / group;
    head[j] = m % group;
    real[j] = pos < qp && pos0 + pos < q_len && head[j] < heads;
    q_pos[j] = p_first + pos;
    slope[j] = slopes != nullptr && head[j] < heads ? slopes[h0 + head[j]] * LOG2E : 0.f;
  }
  // scores in the log2 domain; with a softcap the cap takes the natural
  // score and the log2e factor comes after it
  const float qk_scale = softcap > 0.f ? scale : scale * LOG2E;
  const float post_cap = softcap > 0.f ? LOG2E : 1.f;
  const int col0 = 2 * (lane % 4);

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    load_tile(j + 1);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // Q and tile j landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int t0 = kv_lo + j * WG_KV;
    const uint32_t ks = base + S::K_OFFSET + (j % WG_STAGES) * S::STAGE;
    const uint32_t vs = ks + S::TILE;

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * ATOM_BYTES + (kk % 4) * 32;
      wgmma_m64n64k16_ss(s, desc_k_major(base + off), desc_k_major(ks + off), kk > 0);
    }
    wgmma_commit();
    fence_regs(s);
    wgmma_wait0();
    fence_regs(s);

#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int kv = t0 + col0 + 8 * (i / 4) + (i & 1);
      s[i] = softcapped(s[i] * qk_scale, softcap) * post_cap + slope[(i >> 1) & 1] * (float)kv;
    }
    // interior: every row of the block sees every column of the tile
    const bool interior = t0 + WG_KV - 1 <= p_first && t0 + WG_KV <= kv_length &&
                          (window <= 0 || t0 > p_last - window);
    float alpha[2];
    if (interior) {
      softmax_tile<false>(s, m_run, l_run, alpha, q_pos, t0, col0, kv_length, window);
    } else {
      softmax_tile<true>(s, m_run, l_run, alpha, q_pos, t0, col0, kv_length, window);
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // P as the A fragments of the four k16 steps; the PV products
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_pv<DP>(o, a[kk], desc_mn_major(vs + kk * 2048));
    wgmma_commit();
    fence_regs(o);
    wgmma_wait0();
    fence_regs(o);
    __syncthreads();  // this stage is refilled next
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // a row that saw nothing keeps l == 0 and writes exact zeros
  float inv[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float l = l_run[j];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[j] = 1.f / fmaxf(l, 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (!real[j]) continue;
    __nv_bfloat16* row = out + (((long)b * q_len + (q_pos[j] - q_offset)) * hq + h0 + head[j]) * D;
#pragma unroll
    for (int i = 2 * j; i < DP / 2; i += 4) {
      if (8 * (i / 4) >= D) continue;  // a padded column (head_dim 96)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * (i / 4) + col0) =
          __floats2bfloat162_rn(o[i] * inv[j], o[i + 1] * inv[j]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* slopes, void* out, int batch,
           int q_len, int hq, int hkv, long q_sb, long q_ss, long q_sh, long k_sb, long k_ss,
           long k_sh, long v_sb, long v_ss, long v_sh, const int* q_offset, const int* kv_length,
           int kv_buf_len, int window, float scale, float softcap, cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  static bool configured[kMaxDevices] = {};  // the shared-memory attribute, per device
  const size_t smem = 2 * (size_t)BKV * kv_pitch<T, D>() * sizeof(T) +
                      (size_t)BQ * (D + 4) * sizeof(float) + (size_t)BQ * (BKV + 1) * sizeof(float);
  auto kernel = flash_attention_kernel<T, D>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && (dev >= kMaxDevices || !configured[dev])) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) configured[dev] = true;
  }
  kernel<<<dim3((q_len + BQ - 1) / BQ, hq, batch), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), slopes,
      static_cast<T*>(out), q_len, hq, hkv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
      q_offset, kv_length, kv_buf_len, window, scale, softcap);
  return (int)cudaGetLastError();
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const float* slopes, void* out, int batch,
                 int q_len, int hq, int hkv, long q_sb, long q_ss, long q_sh, long k_sb, long k_ss,
                 long k_sh, long v_sb, long v_ss, long v_sh, const int* q_offset, const int* kv_length,
                 int kv_buf_len, int window, float scale, float softcap, cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  static bool configured[kMaxDevices] = {};  // the shared-memory attribute, per device
  const GroupTiles gt = group_tiles(hq / hkv);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !configured[dev]) {
    err = cudaFuncSetAttribute(flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WgmmaSmem<D>::BYTES);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) configured[dev] = true;
  }
  const int qp = WG_ROWS / gt.size;
  flash_wgmma_kernel<D><<<dim3(hkv * gt.n, batch, (q_len + qp - 1) / qp), WG_THREADS, WgmmaSmem<D>::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), slopes, static_cast<__nv_bfloat16*>(out), q_len, hq, hkv, q_sb,
      q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, q_offset, kv_length, kv_buf_len, window, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes (q, k, v and the output share one type): 0 = float32, 1 =
// bfloat16 (the wgmma kernel; float32 keeps the CUDA-core kernel, since TF32
// tensor cores would change float32 results). Strides are in elements. The
// wrapper in petals_tpu_torch/ops/flash_attention.py validates every
// argument it holds on the host; q_offset and kv_length point to int32s on
// the card (0-dim tensors), which the kernels read and clamp. An
// unsupported (dtype, head_dim) pair returns cudaErrorInvalidValue.
int ptt_flash_attention(const void* q, const void* k, const void* v, const void* slopes, void* out,
                        int dtype, int batch, int q_len, int hq, int hkv, int head_dim,
                        long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                        long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                        long long v_sh, const void* q_offset, const void* kv_length, int kv_buf_len,
                        int window, float scale, float softcap, void* stream) {
  const float* sl = static_cast<const float*>(slopes);
  const int* qo = static_cast<const int*>(q_offset);
  const int* kl = static_cast<const int*>(kv_length);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_FLASH(LAUNCH)                                                                   \
  return LAUNCH(q, k, v, sl, out, batch, q_len, hq, hkv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, \
                v_sb, v_ss, v_sh, qo, kl, kv_buf_len, window, scale, softcap, s)
  if (dtype == 0 && head_dim == 64) PTT_FLASH((launch<float, 64>));
  if (dtype == 0 && head_dim == 96) PTT_FLASH((launch<float, 96>));
  if (dtype == 0 && head_dim == 128) PTT_FLASH((launch<float, 128>));
  if (dtype == 0 && head_dim == 256) PTT_FLASH((launch<float, 256>));
  if (dtype == 1 && head_dim == 64) PTT_FLASH(launch_wgmma<64>);
  if (dtype == 1 && head_dim == 96) PTT_FLASH(launch_wgmma<96>);
  if (dtype == 1 && head_dim == 128) PTT_FLASH(launch_wgmma<128>);
  if (dtype == 1 && head_dim == 256) PTT_FLASH(launch_wgmma<256>);
#undef PTT_FLASH
  return (int)cudaErrorInvalidValue;
}

const char* ptt_flash_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
