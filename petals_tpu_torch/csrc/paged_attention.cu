// Ragged paged attention for Hopper (sm_90a): the decode kernel and its
// chunked-prefill twin, bound to Python through a plain C interface (ctypes).
//
// Replaces the Pallas kernels of petals_tpu/ops/paged_flash_attention.py:
//   - paged_decode_kernel  <- _decode_kernel  (paged_flash_attend)
//   - paged_prefill_wgmma_kernel (bf16) and paged_prefill_kernel (float32)
//     <- _prefill_kernel, with its page predicate _prefill_page_needed
//     (paged_flash_prefill_attend)
// Each is templated on the pool's storage (KV): floating point (K1, K2) or a
// quantized pool, int8 or nf4a (K3: the TPU kernels' quantized arms
// _quant_k_scores / _quant_pv / _nf4a_poly).
// Same contract as the plain PyTorch versions beside the wrappers
// (petals_tpu_torch/ops/paged_attention.py paged_attend /
// paged_prefill_attend): pages are read through the block table, a slot of
// -1 is a hole that no query sees (as the TPU kernels skip its page), and
// pages past the causal/ragged frontier or outside the sliding window are
// never read at all.
//
// What bounds them on this card. Decode reads every needed K/V page once and
// does ~1 FLOP per byte: it is bound by HBM bytes (3.35 TB/s). Each page is
// read once per (lane, kv head): one block computes all `group` query rows of
// a kv head from the same shared-memory copy of its tiles (GQA sharing), so
// pool bytes are read once, not once per query head. The first version gave
// each (lane, kv head) one block that loaded a page, waited for it and then
// computed: 32-64 blocks on 132 SMs at the served batch, each bound by
// memory latency, 72x the byte bound. This one (a) cuts the slots each lane
// needs into runs, one block each (ops/paged_flash_attention.py
// decode_split_plan picks the count so the grid covers the card, two blocks
// an SM; the kernel cuts each lane's own range, which only the card knows,
// so a short lane on a wide table is spread as a long one is), and merges
// the float32 partials in the last block to finish, so a step gains no launch; (b) keeps the next tiles' copies in flight
// (a cp.async ring of 64-slot tiles, any page size) while a tile computes;
// (c) computes on CUDA cores with each token row split over four
// neighbouring threads (eight for float32), so a score costs two (three)
// shuffles, not a warp-wide sum per query row. Tensor cores
// would not pay here: at a group of 4 query rows a 64-slot tile is ~66K
// FMAs, ~500 cycles of one SM's CUDA cores, against ~1.3 us for its 32 KB to
// arrive at an SM's share of the card's bandwidth; and the float32 and
// quantized arms keep one code path. Chunked prefill does ~130 FLOP per byte
// of K/V at a 512-token chunk at position 0 (bound by bytes) and ~1000 at a
// 512-token chunk deep into a long prompt (bound by operations): only the
// tensor cores reach that rate. The first version computed both products
// with CUDA-core FMAs from register tiles (~12 TFLOP/s) and read each K/V
// tile once per query head; bf16 queries now run the wgmma kernel
// (paged_prefill_wgmma_kernel: the GQA group packed into a warpgroup's 64
// rows, so a tile is read once per kv head; the section before it), and
// float32 queries keep the CUDA-core kernel.
//
// Masked probabilities are multiplied to exactly 0 with a select, never left
// to exp(NEG_INF - m): while every score so far was masked, m itself is
// NEG_INF and that exponential is 1.
//
// Quantized pools (K3). A page row of one kv head is d int8 codes, or d/2
// nf4a bytes (byte j: dim j in the low nibble, dim j + d/2 in the high), plus
// one float32 absmax scale. K3 reads 0.52x (int8) or 0.27x (nf4a) of K1's
// pool bytes at head_dim 128, so it is bound by bytes as K1 is. It keeps the
// TPU kernel's factoring: scores are dotted against the raw code values
// (int8 as a float, nf4a as the unscaled cubic dl*(A/B + dl^2), dl = c - 7.5),
// then the score row is multiplied by the row's K scale (times NF4A_B for
// nf4a) and the attention scale; on the V side the scale (times NF4A_B)
// folds into the probabilities before the PV product (after their sum is
// taken for the softmax's denominator), and the probabilities are not
// rounded to a narrower type first. The split-half nf4a layout makes
// each half of q and of the output a separate half-width dot: no
// interleave. Codes are staged like fp rows (16-byte cp.async: a code row is
// a multiple of 16 bytes); the scales, one float per row strided by hkv, with
// 4-byte cp.async (decode, bf16 prefill) or plain loads (float32 prefill).
// Decode decodes each code in registers where it is used (a K chunk once for
// the whole group, a V code once per tile row) and shares the fp arm's split,
// ring and loops; bf16 prefill decodes each staged tile once into bf16
// swizzled tiles for wgmma, float32 prefill into float32 shared memory, and
// each then runs its fp arm's products unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_wgmma.cuh"

namespace {

constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;  // DEFAULT_MASK_VALUE
constexpr int WARP = 32;
constexpr int MAX_GROUP = 16;  // query heads per kv head

// pool storage: floating point (the query's type), int8 codes, nf4a bytes
constexpr int KV_FP = 0;
constexpr int KV_INT8 = 1;
constexpr int KV_NF4A = 2;

// the NF4A cubic v(c) = A*dl + B*dl^3 (ops/quant.py), factored as
// B * dl*(A/B + dl^2): kernels decode the unscaled part and fold B into the scale
constexpr float NF4A_B = 0.0010216002528025852f;
constexpr float NF4A_K = (float)(0.071834915950145642 / 0.0010216002528025852);

// dl = c - 7.5 without an int-to-float conversion (a quarter-rate
// instruction): the float 2^22 + c (its mantissa's last bit is 0.5) minus
// 2^22 + 7.5, both exact
__device__ __forceinline__ float nf4a_poly(unsigned c) {
  const float dl = __uint_as_float(0x4A800000u | (c << 1)) - 4194311.5f;
  return dl * (NF4A_K + dl * dl);
}

// bytes of one stored row of one kv head
template <typename T, int D, int KV>
__host__ __device__ constexpr int row_bytes() {
  return KV == KV_FP ? D * (int)sizeof(T) : KV == KV_INT8 ? D : D / 2;
}

// what a stored scale multiplies: the raw int8 code, or the unscaled cubic
template <int KV>
__host__ __device__ constexpr float scale_factor() {
  return KV == KV_NF4A ? NF4A_B : 1.f;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Start copying `rows` rows of `row_bytes` bytes (a multiple of 16) from
// global memory (row pitch src_pitch bytes) into shared memory (row pitch
// dst_pitch bytes) with asynchronous 16-byte copies (cp.async): each thread
// issues all of its copies before any completes, so a whole page is in
// flight at once. All threads of the block take part; cp_async_wait_all()
// and a barrier make the rows visible.
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

// 16-byte asynchronous copy into shared memory; a false `valid` reads no
// byte and zero-fills the 16 (a row that is not read must still be finite)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// decode: grid (n_lanes, hkv, n_splits), DEC_THREADS threads. The slots a
// lane needs, [max(0, kv_len - window), kv_len) within its table, are cut
// into n_splits contiguous runs of the same length, rounded up to
// SPLIT_ROWS (the last run shorter, trailing runs empty on a short lane):
// block (lane, kvh, split) takes run `split`, so a short lane on a wide
// table is spread over every split as a long one is. It walks them in tiles of
// TR token rows through a ring of STAGES shared-memory stages filled by
// cp.async, so tile i + STAGES - 1 is in flight while tile i is computed.
// Each tile runs three phases with a barrier between them:
//   scores  : TPR neighbouring threads own one token row, each a share of
//             its 16-byte chunks, and dot it with every query row of the
//             group (q in float32 shared memory); one or two shuffles add
//             the shares: no warp-wide reduction per (position, row).
//   softmax : one warp per query row: the tile's max, the rescale of the
//             running (m, l), the probabilities (a quantized pool's V scale
//             folded in after l has summed them).
//   PV      : thread (set, pair) owns two output dims (a pair of a fp / int8
//             row, or one nf4a byte: dims j and j + D/2) over the tile rows
//             r = set (mod NSET); the sets add up once, at the end.
// With one split the block writes its output rows. With several it writes
// a float32 partial (m, l, acc) per query row; the last block of the (lane,
// kvh) to finish, found by an atomic ticket that it then resets to 0, merges
// every split's partial in split order (deterministic whichever block is
// last) and writes the output. A split that needs no slot writes l = 0, and
// a lane that needs none writes exact zeros.
// ---------------------------------------------------------------------------

constexpr int DEC_THREADS = 256;
constexpr int SPLIT_ROWS = 64;  // a split's slots are a multiple of this (of every tile)

template <typename T, int D, int KV>
struct DecodeShape {
  static constexpr int RB = row_bytes<T, D, KV>();
  static constexpr int TR = (KV == KV_FP && sizeof(T) == 4) ? 32 : 64;  // token rows per tile
  static constexpr int TPR = DEC_THREADS / TR;  // threads per token row (scores)
  static_assert(SPLIT_ROWS % TR == 0, "a split is whole tiles");
  // staged row pitch: a multiple of 128 bytes plus 4 * TPR banks, so the
  // threads of a quarter-warp (8 / TPR rows x TPR chunks) hit distinct banks
  static constexpr int PITCH = (RB + 127) / 128 * 128 + 16 * TPR;
  static constexpr int NCH = RB / 16;  // 16-byte chunks of a row
  static constexpr int TILE_BYTES = TR * PITCH;
  static constexpr int SCALE_BYTES = KV == KV_FP ? 0 : TR * 4;
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES + 2 * SCALE_BYTES + TR;  // + a valid flag per row
  // three stages where they fit in 80 KB (quantized pools), else two (bf16
  // at head_dim 128: 80 KB), so that two blocks share an SM
  static constexpr int STAGES = 3 * STAGE_BYTES <= 80 * 1024 ? 3 : 2;
  static constexpr int RING_BYTES = (STAGES * STAGE_BYTES + 15) / 16 * 16;
  static constexpr int PAIRS = D / 2;               // output dim pairs
  static constexpr int NSET = DEC_THREADS / PAIRS;  // PV token sets
};

// Values per staged 16-byte chunk as the score product takes them.
template <typename T, int KV>
__host__ __device__ constexpr int chunk_values() {
  return KV == KV_FP ? 16 / (int)sizeof(T) : KV == KV_INT8 ? 16 : 32;
}

// One staged 16-byte chunk's values: fp elements, raw int8 codes, or the
// unscaled nf4a cubic of its 16 bytes' low nibbles (vals[0..15]: dims 16c +
// i) and high nibbles (vals[16..31]: dims 16c + i + D/2).
template <typename T, int KV>
__device__ __forceinline__ void decode_chunk(const char* p, float (&vals)[chunk_values<T, KV>()]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const unsigned words[4] = {w.x, w.y, w.z, w.w};
  if constexpr (KV == KV_FP && sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) vals[i] = __uint_as_float(words[i]);
  } else if constexpr (KV == KV_FP) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      vals[2 * i] = __uint_as_float(words[i] << 16);
      vals[2 * i + 1] = __uint_as_float(words[i] & 0xFFFF0000u);
    }
  } else if constexpr (KV == KV_INT8) {
#pragma unroll
    for (int i = 0; i < 16; ++i) vals[i] = (float)(int8_t)((words[i / 4] >> (8 * (i % 4))) & 0xFFu);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const unsigned byte = (words[i / 4] >> (8 * (i % 4))) & 0xFFu;
      vals[i] = nf4a_poly(byte & 0xFu);
      vals[16 + i] = nf4a_poly(byte >> 4);
    }
  }
}

// The two output dims that PV thread `pair` owns.
template <int D, int KV>
__device__ __forceinline__ int2 pv_dims(int pair) {
  return KV == KV_NF4A ? make_int2(pair, pair + D / 2) : make_int2(2 * pair, 2 * pair + 1);
}

// Staged V row `r`'s values at pv_dims(pair).
template <typename T, int KV>
__device__ __forceinline__ float2 v_pair(const char* row, int pair) {
  if constexpr (KV == KV_FP && sizeof(T) == 4) {
    return *reinterpret_cast<const float2*>(row + pair * 8);
  } else if constexpr (KV == KV_FP) {
    const unsigned w = *reinterpret_cast<const unsigned*>(row + pair * 4);
    return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xFFFF0000u));
  } else if constexpr (KV == KV_INT8) {
    const char2 c = *reinterpret_cast<const char2*>(row + pair * 2);
    return make_float2((float)c.x, (float)c.y);
  } else {
    const unsigned c = reinterpret_cast<const uint8_t*>(row)[pair];
    return make_float2(nf4a_poly(c & 0xFu), nf4a_poly(c >> 4));
  }
}

template <typename T, int D, int KV, int GMAX>
__global__ void __launch_bounds__(DEC_THREADS) paged_decode_kernel(
    const T* __restrict__ q,             // [n_lanes, hq, D]
    const char* __restrict__ k_pool,     // [n_pages, page_size, hkv, row_bytes]
    const char* __restrict__ v_pool,     // [n_pages, page_size, hkv, row_bytes]
    const float* __restrict__ k_scales,  // [n_pages, page_size, hkv] (quantized pools)
    const float* __restrict__ v_scales,
    const int* __restrict__ tables,      // [n_lanes, max_pages], -1 = hole
    const int* __restrict__ positions,   // [n_lanes]; kv_len = position + 1
    const float* __restrict__ slopes,    // [hq] ALiBi slopes or nullptr
    T* __restrict__ out,                 // [n_lanes, hq, D]
    float2* __restrict__ part_ml,        // [n_lanes, hkv, n_splits, group] (m, l); n_splits > 1
    float* __restrict__ part_acc,        // [n_lanes, hkv, n_splits, group, D]
    unsigned* __restrict__ tickets,      // [n_lanes * hkv], all 0 between launches
    int hq, int hkv, int n_pages, int page_size, int max_pages, int window, float scale) {
  using S = DecodeShape<T, D, KV>;
  constexpr int TR = S::TR, TPR = S::TPR, PITCH = S::PITCH, NCH = S::NCH, STAGES = S::STAGES;
  constexpr int CN = chunk_values<T, KV>();
  constexpr int RUN = KV == KV_NF4A ? CN / 2 : CN;  // contiguous dims of a chunk's first run
  const int lane_idx = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z, n_splits = gridDim.z;
  const int group = hq / hkv;
  const int tid = threadIdx.x, warp = tid / WARP, wl = tid % WARP;

  extern __shared__ __align__(16) char smem[];
  float* q_s = reinterpret_cast<float*>(smem + S::RING_BYTES);  // [group][D]
  float* p_s = q_s + group * D;                                 // [group][TR]
  float* m_s = p_s + group * TR;                                // [GMAX] running max
  float* l_s = m_s + GMAX;                                      // [GMAX] running sum
  float* a_s = l_s + GMAX;                                      // [GMAX] this tile's rescale
  float* sl_s = a_s + GMAX;                                     // [GMAX] ALiBi slopes
  __shared__ unsigned last;
  // stage st: [K tile | V tile | K scales | V scales | valid flags]
  auto stage = [&](int st) { return smem + st * S::STAGE_BYTES; };
  auto stage_scales = [&](int st) { return reinterpret_cast<float*>(stage(st) + 2 * S::TILE_BYTES); };
  auto stage_ok = [&](int st) {
    return reinterpret_cast<uint8_t*>(stage(st) + 2 * S::TILE_BYTES + 2 * S::SCALE_BYTES);
  };

  // the slots this lane needs, [lane_lo, lane_hi), cut into n_splits runs of
  // `per` slots (a multiple of SPLIT_ROWS), run `split` this block's
  const int kv_len = positions[lane_idx] + 1;
  const int lane_hi = min(kv_len, max_pages * page_size);
  const int lane_lo = window > 0 ? max(0, kv_len - window) : 0;
  const int per = (max(0, lane_hi - lane_lo) + n_splits * SPLIT_ROWS - 1) / (n_splits * SPLIT_ROWS) * SPLIT_ROWS;
  const int lo = lane_lo + split * per;
  const int hi = min(lane_hi, lo + per);
  const int n_tiles = hi > lo ? (hi - lo + TR - 1) / TR : 0;
  const int* table = tables + (long)lane_idx * max_pages;

  for (int i = tid; i < group * D; i += DEC_THREADS) {
    const int g = i / D, d = i - g * D;
    q_s[i] = to_f32(q[((long)lane_idx * hq + kvh * group + g) * D + d]);
  }
  if (tid < group) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
    sl_s[tid] = slopes != nullptr ? slopes[kvh * group + tid] : 0.f;
  }

  // issue tile i's copies into its stage: rows past `hi` or on a hole
  // zero-fill and are flagged not valid; always commit a group
  auto load_tile = [&](int i) {
    if (i < n_tiles) {
      const int st = i % STAGES;
      char* ks = stage(st);
      char* vs = ks + S::TILE_BYTES;
      for (int e = tid; e < TR * NCH; e += DEC_THREADS) {
        const int r = e / NCH, c = e - r * NCH;
        const int slot = lo + i * TR + r;
        const int page = slot < hi ? table[slot / page_size] : -1;
        const bool ok = page >= 0 && page < n_pages;
        const long row = ok ? ((long)page * page_size + slot % page_size) * hkv + kvh : 0;  // in rows
        cp_async16(ks + r * PITCH + c * 16, k_pool + row * S::RB + c * 16, ok);
        cp_async16(vs + r * PITCH + c * 16, v_pool + row * S::RB + c * 16, ok);
        if (c == 0) {
          stage_ok(st)[r] = ok;
          if constexpr (KV != KV_FP) {
            cp_async4(stage_scales(st) + r, k_scales + row, ok);
            cp_async4(stage_scales(st) + TR + r, v_scales + row, ok);
          }
        }
      }
    }
    cp_async_commit();
  };

  float acc[GMAX][2];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) acc[g][0] = acc[g][1] = 0.f;
  const int pair = tid % S::PAIRS, set = tid / S::PAIRS;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) load_tile(i);

  for (int i = 0; i < n_tiles; ++i) {
    load_tile(i + STAGES - 1);  // into the stage of tile i - 1, whose readers passed the last barrier
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const int st = i % STAGES;
    const float* ks_s = stage_scales(st);
    const float* vs_s = ks_s + TR;
    const uint8_t* ok_s = stage_ok(st);

    // ---- scores
    {
      const int r = tid / TPR, sub = tid % TPR;
      const char* krow = stage(st) + r * PITCH;
      float part[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) part[g] = 0.f;
#pragma unroll
      for (int c = sub; c < NCH; c += TPR) {
        float vals[CN];
        decode_chunk<T, KV>(krow + c * 16, vals);
        const int d0 = c * RUN;
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g < group) {
            const float* qg = q_s + g * D + d0;
            float s = part[g];
#pragma unroll
            for (int j = 0; j < RUN; j += 4) {
              const float4 qa = *reinterpret_cast<const float4*>(qg + j);
              s += qa.x * vals[j] + qa.y * vals[j + 1] + qa.z * vals[j + 2] + qa.w * vals[j + 3];
              if constexpr (KV == KV_NF4A) {
                const float4 qb = *reinterpret_cast<const float4*>(qg + j + D / 2);
                s += qb.x * vals[RUN + j] + qb.y * vals[RUN + j + 1] + qb.z * vals[RUN + j + 2] +
                     qb.w * vals[RUN + j + 3];
              }
            }
            part[g] = s;
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
#pragma unroll
        for (int o = 1; o < TPR; o <<= 1) part[g] += __shfl_xor_sync(0xffffffffu, part[g], o);
      }
      if (sub == 0) {
        const float row_scale = KV == KV_FP ? scale : scale * (ks_s[r] * scale_factor<KV>());
        const float kv_pos = (float)(lo + i * TR + r);
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          if (g < group) p_s[g * TR + r] = part[g] * row_scale + sl_s[g] * kv_pos;
      }
    }
    __syncthreads();

    // ---- online softmax: one warp per query row
    for (int g = warp; g < group; g += DEC_THREADS / WARP) {
      float mx = NEG_INF;
      for (int r = wl; r < TR; r += WARP)
        if (ok_s[r]) mx = fmaxf(mx, p_s[g * TR + r]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int r = wl; r < TR; r += WARP) {
        const float e = ok_s[r] ? expf(p_s[g * TR + r] - m_new) : 0.f;
        // a quantized pool's V scale folds into the probability (not into l)
        p_s[g * TR + r] = KV == KV_FP ? e : e * (vs_s[r] * scale_factor<KV>());
        sum += e;
      }
      sum = warp_sum(sum);
      if (wl == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // ---- weighted values; rows that are not valid were zero-filled and
    // have probability 0
    {
      const char* vs = stage(st) + S::TILE_BYTES;
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < group) {
          acc[g][0] *= a_s[g];
          acc[g][1] *= a_s[g];
        }
      }
      for (int r = set; r < TR; r += S::NSET) {
        const float2 vv = v_pair<T, KV>(vs + r * PITCH, pair);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g < group) {
            const float p = p_s[g * TR + r];
            acc[g][0] += p * vv.x;
            acc[g][1] += p * vv.y;
          }
        }
      }
    }
    __syncthreads();  // this stage and p_s are rewritten next
  }
  cp_async_wait<0>();  // the trailing (empty) groups
  __syncthreads();

  // the token sets add up in set order, through the (idle) ring memory
  float* red = reinterpret_cast<float*>(smem);  // [NSET - 1][GMAX][PAIRS][2]
  if (set > 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < group) {
        float* dst = red + (((set - 1) * GMAX + g) * S::PAIRS + pair) * 2;
        dst[0] = acc[g][0];
        dst[1] = acc[g][1];
      }
    }
  }
  __syncthreads();
  const int2 dims = pv_dims<D, KV>(pair);
  if (set == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < group) {
        for (int s = 1; s < S::NSET; ++s) {
          const float* src = red + (((s - 1) * GMAX + g) * S::PAIRS + pair) * 2;
          acc[g][0] += src[0];
          acc[g][1] += src[1];
        }
        if (n_splits == 1) {
          // a lane with no needed slot keeps l == 0 and writes exact zeros
          const float inv = 1.f / fmaxf(l_s[g], 1e-30f);
          T* o = out + ((long)lane_idx * hq + kvh * group + g) * D;
          o[dims.x] = from_f32<T>(acc[g][0] * inv);
          o[dims.y] = from_f32<T>(acc[g][1] * inv);
        } else {
          float* pa = part_acc + ((((long)lane_idx * hkv + kvh) * n_splits + split) * group + g) * D;
          pa[dims.x] = acc[g][0];
          pa[dims.y] = acc[g][1];
        }
      }
    }
  }
  if (n_splits == 1) return;
  const long ml0 = ((long)lane_idx * hkv + kvh) * n_splits * group;  // this (lane, kvh)'s first partial
  if (tid < group) part_ml[ml0 + (long)split * group + tid] = make_float2(m_s[tid], l_s[tid]);

  // the last block of this (lane, kvh) to arrive merges every split
  __threadfence();  // this thread's partial is visible device-wide before the ticket
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + (long)lane_idx * hkv + kvh, 1u) == (unsigned)n_splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // every split's (m, l) staged in shared memory by the whole block, then
  // per query row the weights w[s] = exp(m_s - M) of the splits that saw
  // something (written over m_s) and the merged denominator L; then every
  // output element, in split order, its loads independent of each other
  float2* ml_s = reinterpret_cast<float2*>(smem);  // [n_splits][group], inside the ring
  float* big_l = p_s;                              // [group]
  for (int e = tid; e < n_splits * group; e += DEC_THREADS) ml_s[e] = __ldcg(part_ml + ml0 + e);
  __syncthreads();
  if (tid < group) {
    float mx = NEG_INF;
    for (int s = 0; s < n_splits; ++s)
      if (ml_s[s * group + tid].y > 0.f) mx = fmaxf(mx, ml_s[s * group + tid].x);
    float l = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float2 ml = ml_s[s * group + tid];
      const float w = ml.y > 0.f ? expf(ml.x - mx) : 0.f;
      ml_s[s * group + tid].x = w;
      l += w * ml.y;
    }
    big_l[tid] = l;
  }
  __syncthreads();
  const float* pa0 = part_acc + ml0 * D;  // every split wrote its acc (zeros if it saw nothing)
  for (int e = tid; e < group * D; e += DEC_THREADS) {
    const int g = e / D, d = e - g * D;
    float o = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_splits; ++s) o += ml_s[s * group + g].x * __ldcg(pa0 + ((long)s * group + g) * D + d);
    out[((long)lane_idx * hq + kvh * group + g) * D + d] = from_f32<T>(o / fmaxf(big_l[g], 1e-30f));
  }
  if (tid == 0) tickets[(long)lane_idx * hkv + kvh] = 0u;  // ready for the next launch
}

// ---------------------------------------------------------------------------
// chunked prefill, float32 queries (CUDA cores; bf16 runs the wgmma kernel
// below): grid (ceil(q_len / BQ), hq), NT threads. Thread (ty, tx) = (tid / 8,
// tid % 8) owns query rows ty + 16 i (i < 4); in the score tile it owns kv
// columns tx + 8 j (j < 8), in the output tile dims tx + 8 k.
// ---------------------------------------------------------------------------

constexpr int BQ = 64;   // query rows per block
constexpr int BKV = 64;  // kv positions per tile
constexpr int NT = 128;  // threads per block
constexpr int RPT = BQ / (NT / 8);  // rows per thread = 4
constexpr int CPT = BKV / 8;        // score columns per thread = 8

template <typename T, int D>
__host__ __device__ constexpr int kv_pitch() {
  return D + 16 / (int)sizeof(T);  // +16 bytes per row: row r starts 4 banks after row r-1
}

// Decode `rows` quantized code rows (row pitch src_pitch bytes) into float32
// shared memory (row pitch dst_pitch floats): raw int8 values, or the
// unscaled nf4a cubic of both nibbles (byte j -> dims j and j + D/2). Each
// thread loads 16 bytes at a time; a code row is a multiple of 16 bytes.
template <int KV, int D>
__device__ __forceinline__ void decode_rows(float* dst, int dst_pitch, const char* src,
                                            long src_pitch, int rows) {
  constexpr int VPR = row_bytes<float, D, KV>() / 16;
  for (int i = threadIdx.x; i < rows * VPR; i += blockDim.x) {
    const int r = i / VPR, c = i - r * VPR;
    const uint4 w = *reinterpret_cast<const uint4*>(src + r * src_pitch + c * 16);
    const unsigned words[4] = {w.x, w.y, w.z, w.w};
    float* row = dst + r * dst_pitch;
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const unsigned byte = (words[b / 4] >> (8 * (b % 4))) & 0xFFu;
      const int jb = c * 16 + b;
      if constexpr (KV == KV_INT8) {
        row[jb] = (float)(int8_t)byte;
      } else {
        row[jb] = nf4a_poly(byte & 0xFu);
        row[jb + D / 2] = nf4a_poly(byte >> 4);
      }
    }
  }
}

template <typename T, int D, int KV>
__global__ void __launch_bounds__(NT) paged_prefill_kernel(
    const T* __restrict__ q,           // [q_len, hq, D] (one lane's chunk)
    const char* __restrict__ k_pool,   // [n_pages, page_size, hkv, row_bytes]
    const char* __restrict__ v_pool,
    const float* __restrict__ k_scales,  // [n_pages, page_size, hkv] (quantized pools)
    const float* __restrict__ v_scales,
    const int* __restrict__ table_row, // [max_pages], -1 = hole
    const int* __restrict__ chunk_pos_p,  // device scalars: the chunk's first position
    const int* __restrict__ n_valid_p,    // and its real rows (kv_len = chunk_pos + n_valid)
    const float* __restrict__ slopes,  // [hq] or nullptr
    T* __restrict__ out,               // [q_len, hq, D]
    int q_len, int hq, int hkv, int n_pages, int page_size, int max_pages, int window, float scale) {
  // a quantized tile is decoded once into float32 shared memory; the loops
  // below then read it exactly as they read a floating-point tile
  using KT = typename std::conditional<KV == KV_FP, T, float>::type;
  constexpr int RB = row_bytes<T, D, KV>();
  constexpr int KP = kv_pitch<KT, D>();
  constexpr int QP = D + 4;
  constexpr int PP = BKV + 1;
  constexpr int DPT = D / 8;  // output dims per thread
  const int qb = blockIdx.x, h = blockIdx.y;
  const int kvh = h / (hq / hkv);
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  const int chunk_pos = *chunk_pos_p, kv_len = chunk_pos + *n_valid_p;

  extern __shared__ __align__(16) char smem[];
  KT* k_s = reinterpret_cast<KT*>(smem);                   // [BKV][KP]
  KT* v_s = k_s + BKV * KP;                                // [BKV][KP]
  float* q_s = reinterpret_cast<float*>(v_s + BKV * KP);   // [BQ][QP]
  float* p_s = q_s + BQ * QP;                              // [BQ][PP]
  float* ks_s = p_s + BQ * PP;                             // [BKV] (quantized)
  float* vs_s = ks_s + BKV;                                // [BKV] (quantized)

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i - r * D;
    const int row = qb * BQ + r;
    q_s[r * QP + d] = row < q_len ? to_f32(q[((long)row * hq + h) * D + d]) : 0.f;
  }
  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int k = 0; k < DPT; ++k) acc[i][k] = 0.f;
  }
  const float slope = slopes != nullptr ? slopes[h] : 0.f;
  const int q_block_start = chunk_pos + qb * BQ;
  const long pitch = (long)hkv * RB;

  for (int j = 0; j < max_pages; ++j) {
    const int page = table_row[j];
    const int slot_start = j * page_size;
    // _prefill_page_needed, plus a guard that never reads outside the pool
    bool needed = page >= 0 && page < n_pages && slot_start <= q_block_start + BQ - 1 &&
                  slot_start < kv_len;
    if (window > 0) needed = needed && (slot_start + page_size - 1 > q_block_start - window);
    if (!needed) continue;  // uniform across the block

    for (int off = 0; off < page_size; off += BKV) {
      const int tile = min(BKV, page_size - off);
      const long row0 = ((long)page * page_size + off) * hkv + kvh;  // first row, in rows
      __syncthreads();  // the previous tile's readers are done
      if constexpr (KV == KV_FP) {
        copy_rows(reinterpret_cast<char*>(k_s), KP * sizeof(T), k_pool + row0 * RB, pitch, tile, RB);
        copy_rows(reinterpret_cast<char*>(v_s), KP * sizeof(T), v_pool + row0 * RB, pitch, tile, RB);
        cp_async_wait_all();
      } else {
        decode_rows<KV, D>(k_s, KP, k_pool + row0 * RB, pitch, tile);
        decode_rows<KV, D>(v_s, KP, v_pool + row0 * RB, pitch, tile);
        for (int r = tid; r < tile; r += NT) {
          ks_s[r] = k_scales[row0 + (long)r * hkv];
          vs_s[r] = v_scales[row0 + (long)r * hkv];
        }
      }
      __syncthreads();

      // the K scale of each of this thread's score columns (times the
      // attention scale's factor), and the V scale its probability takes;
      // columns past `tile` are masked below and take neither
      float k_row[CPT], v_row[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = tx + 8 * c;
        k_row[c] = KV == KV_FP ? 1.f : col < tile ? ks_s[col] * scale_factor<KV>() : 0.f;
        v_row[c] = KV == KV_FP ? 1.f : col < tile ? vs_s[col] * scale_factor<KV>() : 0.f;
      }

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
          const int kv_pos = slot_start + off + col;
          ok[c] = col < tile && kv_pos <= q_pos && kv_pos < kv_len &&
                  (window <= 0 || kv_pos > q_pos - window);
          if constexpr (KV != KV_FP) s[i][c] *= k_row[c];
          s[i][c] = s[i][c] * scale + slope * (float)kv_pos;
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
          p_s[r * PP + tx + 8 * c] = KV == KV_FP ? e : e * v_row[c];  // V scale folded in
          sum += e;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        sum += __shfl_xor_sync(0xffffffffu, sum, 4);
        l[i] = alpha * l[i] + sum;
        m[i] = m_new;
#pragma unroll
        for (int k = 0; k < DPT; ++k) acc[i][k] *= alpha;
      }
      __syncthreads();

      // rows past `tile` hold stale shared memory: never multiply them, even by 0
      for (int c = 0; c < tile; ++c) {
        float pv[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) pv[i] = p_s[(ty + 16 * i) * PP + c];
#pragma unroll
        for (int k = 0; k < DPT; ++k) {
          const float vv = to_f32(v_s[c * KP + tx + 8 * k]);
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][k] += pv[i] * vv;
        }
      }
    }
  }

  // rows >= n_valid are computed but never read by the caller; a row that
  // saw no visible position keeps l == 0 and writes exact zeros
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = qb * BQ + ty + 16 * i;
    if (row < q_len) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int k = 0; k < DPT; ++k)
        out[((long)row * hq + h) * D + tx + 8 * k] = from_f32<T>(acc[i][k] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// chunked prefill, bf16 queries: wgmma (K2, and K3's prefill arms on int8 /
// nf4a pools). K4's design (flash_attention.cu flash_wgmma_kernel) over one
// lane's pages. A block has PF_WARPGROUPS (two) consumer warpgroups; each
// owns 64 "rows": qp = 64 / group query positions x the group's query heads
// of one kv head (row m = position * group + head; 64 - qp * group rows idle
// when the group does not divide 64), so each K/V tile is loaded (and, from a
// quantized pool, decoded) once into shared memory and read by every query
// head of the kv head in both warpgroups. Grid (hkv, query tiles of 2 * qp
// positions), the query tiles taken in reverse: the tiles with the most KV
// under the causal frontier start first.
//
// A block reads the slots [kv_lo, kv_hi): from the first one the window
// leaves its first position (rounded down to a tile) to the causal frontier
// of its last real position, capped by kv_len and the table. It walks them in
// 64-slot tiles whatever the page size: each slot's row is fetched through
// its own page (table_row[slot / page_size]), so a page of 8 slots does not
// shrink the tile. A row past kv_hi, on a hole (-1) or on a page outside the
// pool zero-fills and is flagged not valid. A zero K row is not a skipped
// one: it would score 0 and add exp(0 - m) to the softmax's sum. So rows that
// are not valid are masked out of the max and the sum like any position no
// row sees (the TPU kernel skips a hole's page). The tiles come through a
// ring of 4 stages of 16-byte cp.async copies: tiles j + 1 to j + 3 are in
// flight while tile j computes. The first version issued
// each row's copies after its page's load, one after the other, and spent
// most of its time there (PERF.md §6); a thread now reads all its rows'
// pages before its first copy.
//
// Per tile, as in K4:
//   - S = Q K^T on wgmma m64n64k16, A = Q and B = K, both K-major in the
//     128-byte swizzle (hopper_wgmma.cuh);
//   - the online softmax on the accumulator registers (log2 domain), masked
//     only on an edge tile: one that holds a slot some row of the warpgroup
//     does not see (the causal diagonal, kv_len, the window's edge) or a row
//     that is not valid. This is the TPU kernel's _compute_interior /
//     _compute_edge split. Every wgmma is issued outside any branch that
//     differs between threads;
//   - P rounded to bf16 in registers as the A fragments of O += P V (wgmma
//     m64nDk16, V read as an MN-major B straight from its tile).
// Quantized pools (K3): a stage holds the raw code rows and their float32
// scales; all threads decode it once into a bf16 K tile and a bf16 V tile in
// the swizzle (int8 codes are exact in bf16; nf4a's unscaled cubic
// dl*(A/B + dl^2) rounds to bf16) and the products run on those. The decoded
// tiles come in two pairs, by tile parity: tile j + 1's K is decoded while
// tile j's scores run on the tensor cores, its V while tile j's PV product
// runs. The TPU kernel's factoring stays: the score row is multiplied by the
// row's K scale (times scale_factor<KV>()), and the V scale (times the same)
// folds into P after l has summed it, before P is rounded for the PV product.
// ---------------------------------------------------------------------------

using hopper::ATOM_BYTES;
using hopper::desc_k_major;
using hopper::desc_mn_major;
using hopper::fence_regs;
using hopper::LOG2E;
using hopper::pack_bf16;
using hopper::smem_u32;
using hopper::sw128;
using hopper::WG_THREADS;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_m64n64k16_ss;
using hopper::wgmma_pv;
using hopper::wgmma_wait0;

constexpr int PF_ROWS = 64;  // packed rows of a warpgroup (query positions x heads)
constexpr int PF_KV = 64;    // kv slots of a tile

// consumer warpgroups of a block, one block an SM: both read each K/V tile
// (and share its decode), so a tile is loaded once per 128 packed rows; one
// warpgroup a block, two blocks an SM, was slower for every pool at a long
// chunk (PERF.md §6)
constexpr int PF_WARPGROUPS = 2;
constexpr int PF_THREADS = PF_WARPGROUPS * WG_THREADS;

template <int D, int KV>
struct PrefillSmem {
  static constexpr int NWG = PF_WARPGROUPS;
  static constexpr int THREADS = PF_THREADS;
  static constexpr int TILE = D / 64 * ATOM_BYTES;  // a swizzled [64 x D] bf16 tile
  static constexpr int RB = row_bytes<__nv_bfloat16, D, KV>();
  static constexpr int SIDE = KV == KV_FP ? TILE : PF_KV * RB;  // K (or V) of a stage
  // Q, then (quantized) a pair of decoded K and V tiles for each parity of j
  static constexpr int FIXED = NWG * TILE + (KV == KV_FP ? 0 : 4 * TILE);
  // per stage: the K and V scales (quantized), then a valid flag per row
  static constexpr int SCALES = KV == KV_FP ? 0 : 2 * PF_KV * 4;
  static constexpr int META = SCALES + PF_KV;
  // as many stages as a block's 227 KB hold, at most 4 (tiles j + 1 to j + 3
  // in flight while tile j computes); a quantized pool's loop needs three
  static constexpr int FIT = (227 * 1024 - 1024 - FIXED) / (2 * SIDE + META);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static_assert(STAGES >= (KV == KV_FP ? 2 : 3), "too few stages for the ring");
  static constexpr int Q_OFF = 0;
  static constexpr int RING_OFF = FIXED;  // stage s: K at RING_OFF + 2 s SIDE, V SIDE further
  static constexpr int META_OFF = RING_OFF + STAGES * 2 * SIDE;
  static constexpr int BYTES = META_OFF + STAGES * META + 1024;  // + slack to align the base
};

// Decode one side (K or V) of a stage, its raw code rows [64 x RB], into a
// bf16 tile at dst in the 128-byte swizzle: int8 codes as they are; nf4a
// bytes as the unscaled cubic of each nibble (byte j: dim j low, dim j + D/2
// high), rounded to bf16. Rows that are not valid decode from their zero
// bytes and are masked.
template <int D, int KV, int NT>
__device__ __forceinline__ void decode_side(unsigned char* tile, const unsigned char* src) {
  constexpr int RB = row_bytes<__nv_bfloat16, D, KV>(), RCH = RB / 16;
  for (int e = threadIdx.x; e < PF_KV * RCH; e += NT) {
    const int r = e / RCH, c = e % RCH;
    const uint4 w = *reinterpret_cast<const uint4*>(src + r * RB + c * 16);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
    if constexpr (KV == KV_INT8) {
      // bytes 16c .. 16c + 15 are dims 16c .. 16c + 15: chunks 2c and 2c + 1.
      // A code x is the float (2^23 + (x ^ 0x80)) - (2^23 + 128), exact,
      // with no (quarter-rate) int-to-float conversion
      uint32_t p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t pair = (words[i / 2] ^ 0x80808080u) >> (16 * (i % 2));  // bytes 2i, 2i + 1
        p[i] = pack_bf16(__uint_as_float(0x4B000000u | (pair & 0xFFu)) - 8388736.f,
                         __uint_as_float(0x4B000000u | ((pair >> 8) & 0xFFu)) - 8388736.f);
      }
      *reinterpret_cast<uint4*>(tile + sw128(r, 2 * c)) = make_uint4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<uint4*>(tile + sw128(r, 2 * c + 1)) = make_uint4(p[4], p[5], p[6], p[7]);
    } else {
      // low nibbles: dims 16c .. (chunks 2c, 2c + 1); high: dims D/2 + 16c ..
      uint32_t lo[8], hi[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t pair = words[i / 2] >> (16 * (i % 2));
        lo[i] = pack_bf16(nf4a_poly(pair & 0xFu), nf4a_poly((pair >> 8) & 0xFu));
        hi[i] = pack_bf16(nf4a_poly((pair >> 4) & 0xFu), nf4a_poly((pair >> 12) & 0xFu));
      }
      *reinterpret_cast<uint4*>(tile + sw128(r, 2 * c)) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<uint4*>(tile + sw128(r, 2 * c + 1)) = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      *reinterpret_cast<uint4*>(tile + sw128(r, D / 16 + 2 * c)) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(tile + sw128(r, D / 16 + 2 * c + 1)) = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
  }
}

// The online softmax of one tile on the S accumulator (log2 domain; scores
// already scaled): row j in {0, 1} of this thread is rows lane / 4 + 8 j of
// its warp's 16, columns col0 + 8 n + {0, 1}. On an edge tile (MASK) a score
// that its row does not see, or whose slot's row is not valid (ok_col),
// becomes probability 0 by a select.
template <bool MASK>
__device__ __forceinline__ void prefill_softmax(float (&s)[32], float (&m)[2], float (&l)[2], float (&alpha)[2],
                                                const int (&q_pos)[2], int t0, int col0, int kv_len, int window,
                                                const uint8_t* ok_col) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (((i >> 1) & 1) != j) continue;
      if (MASK) {
        const int col = col0 + 8 * (i / 4) + (i & 1), kv = t0 + col;
        const bool ok = ok_col[col] && kv <= q_pos[j] && kv < kv_len && (window <= 0 || kv > q_pos[j] - window);
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

template <int D, int KV>
__global__ void __launch_bounds__(PF_THREADS, 1)
    paged_prefill_wgmma_kernel(const __nv_bfloat16* __restrict__ q,  // [q_len, hq, D] (one lane's chunk)
                               const char* __restrict__ k_pool,      // [n_pages, page_size, hkv, row_bytes]
                               const char* __restrict__ v_pool,
                               const float* __restrict__ k_scales,  // [n_pages, page_size, hkv] (quantized)
                               const float* __restrict__ v_scales,
                               const int* __restrict__ table_row,  // [max_pages], -1 = hole
                               const int* __restrict__ chunk_pos_p,  // device scalars: the chunk's first
                               const int* __restrict__ n_valid_p,    // position and its real rows
                               const float* __restrict__ slopes,   // [hq] or nullptr
                               __nv_bfloat16* __restrict__ out,    // [q_len, hq, D]
                               int q_len, int hq, int hkv, int n_pages, int page_size, int max_pages,
                               int window, float scale) {
  using S = PrefillSmem<D, KV>;
  constexpr int NWG = S::NWG, NT = S::THREADS, STAGES = S::STAGES, RB = S::RB;
  constexpr int CH = D / 8;     // 16-byte chunks of a bf16 row
  constexpr int RCH = RB / 16;  // 16-byte chunks of a stored row
  extern __shared__ __align__(16) unsigned char pf_smem_raw[];
  const uint32_t raw_base = smem_u32(pf_smem_raw);
  const uint32_t base = (raw_base + 1023) & ~1023u;
  unsigned char* const smem = pf_smem_raw + (base - raw_base);  // the aligned base, generic

  const int group = hq / hkv;
  const int qp = PF_ROWS / group;  // query positions of a warpgroup
  const int kvh = blockIdx.x;
  // read from the device, so one captured launch serves every chunk position
  const int chunk_pos = *chunk_pos_p, kv_len = chunk_pos + *n_valid_p;
  const int pos0 = (gridDim.y - 1 - blockIdx.y) * NWG * qp;  // the block's first position; heaviest first
  const int tid = threadIdx.x, wg = tid / WG_THREADS;
  const int warp = (tid % WG_THREADS) / WARP, lane = tid % WARP;

  // the slots any real row of the block sees: from the window's start for
  // its first position to the causal frontier of its last real one
  const int p_first = chunk_pos + pos0;
  const int p_last = chunk_pos + min(q_len, pos0 + NWG * qp) - 1;
  const int kv_hi = min(min(kv_len, p_last + 1), max_pages * page_size);
  int kv_lo = window > 0 ? max(0, p_first - window + 1) : 0;
  kv_lo -= kv_lo % PF_KV;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + PF_KV - 1) / PF_KV : 0;

  // Q of each warpgroup w: row m = (position w * qp + m / group, head m %
  // group); idle rows and rows past q_len zero-fill
  for (int e = tid; e < NWG * PF_ROWS * CH; e += NT) {
    const int w = e / (PF_ROWS * CH), m = e / CH % PF_ROWS, c = e % CH;
    const int pos = m / group, row = pos0 + w * qp + pos;
    const bool ok = pos < qp && row < q_len;
    const __nv_bfloat16* src = ok ? q + ((long)row * hq + kvh * group + m % group) * D + c * 8 : q;
    hopper::cp_async16(base + S::Q_OFF + w * S::TILE + sw128(m, c), src, ok);
  }
  cp_async_commit();

  // stage st: K and V (swizzled bf16 tiles, or raw code rows), and its meta:
  // [K scales | V scales] (quantized), then a valid flag per row
  auto side_addr = [&](int st, int side) { return base + S::RING_OFF + (2 * st + side) * S::SIDE; };
  auto scales_of = [&](int st) { return reinterpret_cast<float*>(smem + S::META_OFF + st * S::META); };
  auto flags_of = [&](int st) { return smem + S::META_OFF + st * S::META + S::SCALES; };

  // issue tile j's copies into its stage; always commit a group. Each
  // thread reads the pages of all its rows first, so those loads are in
  // flight together (each cp.async is a compiler barrier); a page size that
  // is a power of two takes a shift, not a division.
  constexpr int PER = (PF_KV * RCH + NT - 1) / NT;  // copies of each side a thread issues
  const bool pow2 = (page_size & (page_size - 1)) == 0;
  const int page_shift = __ffs(page_size) - 1;
  auto load_tile = [&](int j) {
    if (j < n_tiles) {
      const int st = j % STAGES, t0 = kv_lo + j * PF_KV;
      long row[PER];  // this thread's rows in the pool, in rows of one kv head
      bool ok[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int slot = t0 + (tid + i * NT) / RCH;
        const int idx = pow2 ? slot >> page_shift : slot / page_size;
        const int page = tid + i * NT < PF_KV * RCH && slot < kv_hi ? table_row[idx] : -1;
        const int in_page = pow2 ? slot & (page_size - 1) : slot - idx * page_size;
        ok[i] = page >= 0 && page < n_pages;
        row[i] = ok[i] ? ((long)page * page_size + in_page) * hkv + kvh : 0;
      }
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int e = tid + i * NT, r = e / RCH, c = e % RCH;
        if (e >= PF_KV * RCH) break;
        const uint32_t off = KV == KV_FP ? sw128(r, c) : r * RB + c * 16;
        hopper::cp_async16(side_addr(st, 0) + off, k_pool + row[i] * RB + c * 16, ok[i]);
        hopper::cp_async16(side_addr(st, 1) + off, v_pool + row[i] * RB + c * 16, ok[i]);
        if (c == 0) {
          flags_of(st)[r] = ok[i];
          if constexpr (KV != KV_FP) {
            cp_async4(scales_of(st) + r, k_scales + row[i], ok[i]);
            cp_async4(scales_of(st) + PF_KV + r, v_scales + row[i], ok[i]);
          }
        }
      }
    }
    cp_async_commit();
  };

  // this thread's two rows: (position, head), and their slopes in log2 units
  int q_pos[2], head[2];
  bool real[2];
  float slope[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int m = 16 * warp + lane / 4 + 8 * j;
    const int pos = m / group, row = pos0 + wg * qp + pos;
    head[j] = m % group;
    real[j] = pos < qp && row < q_len;
    q_pos[j] = chunk_pos + row;
    slope[j] = slopes != nullptr ? slopes[kvh * group + head[j]] * LOG2E : 0.f;
  }
  // the warpgroup's first and last real positions, for the interior test
  const int wg_first = p_first + wg * qp;
  const int wg_last = chunk_pos + min(q_len, pos0 + (wg + 1) * qp) - 1;
  const float qk_scale = scale * LOG2E;
  const int col0 = 2 * (lane % 4);
  const uint32_t q_tile = base + S::Q_OFF + wg * S::TILE;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  // tile j's scores S = Q K^T, issued (not waited) from the K tile at ks
  auto issue_scores = [&](float(&acc)[32], uint32_t ks) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * ATOM_BYTES + (kk % 4) * 32;
      wgmma_m64n64k16_ss(acc, desc_k_major(q_tile + off), desc_k_major(ks + off), kk > 0);
    }
    wgmma_commit();
    fence_regs(acc);
  };
  // tile j's softmax on its (waited) scores, o rescaled, and P (a quantized
  // pool's V scale folded in) as the A fragments of the PV product's four
  // k16 steps
  auto softmax_to_p = [&](float(&scores)[32], uint32_t (&a)[4][4], int j) {
    const int st = j % STAGES, t0 = kv_lo + j * PF_KV;
    const uint8_t* ok_col = flags_of(st);
    const float* k_scale = scales_of(st);
    const float* v_scale = k_scale + PF_KV;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float sc = qk_scale;
      if constexpr (KV != KV_FP) sc *= k_scale[col0 + 8 * (i / 4) + (i & 1)] * scale_factor<KV>();
      scores[i] *= sc;
    }
    if (slopes != nullptr) {
#pragma unroll
      for (int i = 0; i < 32; ++i) scores[i] += slope[(i >> 1) & 1] * (float)(t0 + col0 + 8 * (i / 4) + (i & 1));
    }
    // interior: every row of the tile is valid and every row of the
    // warpgroup sees every slot of it
    bool full = true;
#pragma unroll
    for (int w4 = 0; w4 < PF_KV / 16; ++w4) {
      const uint4 f = reinterpret_cast<const uint4*>(ok_col)[w4];
      full = full && (f.x & f.y & f.z & f.w) == 0x01010101u;
    }
    const bool interior = full && t0 + PF_KV - 1 <= wg_first && t0 + PF_KV <= kv_len &&
                          (window <= 0 || t0 > wg_last - window);
    float alpha[2];
    if (interior) {
      prefill_softmax<false>(scores, m_run, l_run, alpha, q_pos, t0, col0, kv_len, window, ok_col);
    } else {
      prefill_softmax<true>(scores, m_run, l_run, alpha, q_pos, t0, col0, kv_len, window, ok_col);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float p0 = scores[8 * kk + 2 * r], p1 = scores[8 * kk + 2 * r + 1];
        if constexpr (KV != KV_FP) {
          const int col = col0 + 8 * (2 * kk + r / 2);
          p0 *= v_scale[col] * scale_factor<KV>();
          p1 *= v_scale[col + 1] * scale_factor<KV>();
        }
        a[kk][r] = pack_bf16(p0, p1);
      }
    }
  };
  auto issue_pv = [&](const uint32_t (&a)[4][4], uint32_t vs) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_pv<D>(o, a[kk], desc_mn_major(vs + kk * 2048));
    wgmma_commit();
    fence_regs(o);
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) load_tile(i);
  float s[32];
  uint32_t a[4][4];

  if constexpr (KV == KV_FP) {
    for (int j = 0; j < n_tiles; ++j) {
      cp_async_wait<STAGES - 2>();  // Q and tile j landed
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // tile j visible to all; every thread is done with tile j - 1
      load_tile(j + STAGES - 1);  // into tile j - 1's stage
      issue_scores(s, side_addr(j % STAGES, 0));
      wgmma_wait0();
      fence_regs(s);
      softmax_to_p(s, a, j);
      issue_pv(a, side_addr(j % STAGES, 1));
      wgmma_wait0();
      fence_regs(o);
    }
  } else {
    // decoded tiles: a K and V pair for each parity of j. Tile j + 1 is
    // decoded while tile j's products run: its K under the scores, its V
    // under the PV product.
    constexpr int DEC = S::Q_OFF + NWG * S::TILE;
    auto dec_k = [&](int j) { return DEC + (j & 1) * 2 * S::TILE; };  // byte offsets from the base
    auto raw = [&](int j, int side) { return smem + (side_addr(j % STAGES, side) - base); };
    if (n_tiles > 0) {
      cp_async_wait<STAGES - 2>();  // Q and tile 0 landed
      __syncthreads();
      decode_side<D, KV, NT>(smem + dec_k(0), raw(0, 0));
      decode_side<D, KV, NT>(smem + dec_k(0) + S::TILE, raw(0, 1));
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
    for (int j = 0; j < n_tiles; ++j) {
      const bool next = j + 1 < n_tiles;  // uniform
      issue_scores(s, base + dec_k(j));
      if (next) {
        cp_async_wait<STAGES - 3>();  // tile j + 1 landed
        __syncthreads();  // ... for all; every thread is done with tile j - 1
        load_tile(j + STAGES - 1);  // into tile j - 1's stage
        decode_side<D, KV, NT>(smem + dec_k(j + 1), raw(j + 1, 0));
      }
      wgmma_wait0();
      fence_regs(s);
      softmax_to_p(s, a, j);
      issue_pv(a, base + dec_k(j) + S::TILE);
      if (next) decode_side<D, KV, NT>(smem + dec_k(j + 1) + S::TILE, raw(j + 1, 1));
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wgmma_wait0();
      fence_regs(o);
      // P, the product's A operand, stays in its registers until it is done
      // (the decode above must not reuse them)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[kk][r])::"memory");
      }
      __syncthreads();  // tile j + 1's decoded tiles visible to all
    }
  }
  cp_async_wait<0>();  // the trailing (empty) groups

  // rows past n_valid are computed but never read; a row that saw nothing
  // keeps l == 0 and writes exact zeros
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
    __nv_bfloat16* row = out + ((long)(q_pos[j] - chunk_pos) * hq + kvh * group + head[j]) * D;
#pragma unroll
    for (int i = 2 * j; i < D / 2; i += 4) {
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * (i / 4) + col0) =
          __floats2bfloat162_rn(o[i] * inv[j], o[i + 1] * inv[j]);
    }
  }
}

constexpr int kMaxDevices = 64;

// Raise the kernel's dynamic shared-memory limit to `smem` once per device;
// `configured` is the caller's own record (one per kernel instantiation:
// instantiations share a function type, so it cannot live here).
template <typename Kernel>
cudaError_t allow_smem_once(Kernel kernel, size_t smem, size_t (&configured)[kMaxDevices]) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && configured[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && dev < kMaxDevices) configured[dev] = smem;
  return err;
}

template <typename T, int D, int KV, int GMAX>
int launch_decode(const void* q, const void* k_pool, const void* v_pool, const float* k_scales,
                  const float* v_scales, const int* tables, const int* positions,
                  const float* slopes, void* out, void* part_ml, void* part_acc, void* tickets,
                  int n_lanes, int hq, int hkv, int n_pages, int page_size, int max_pages,
                  int n_splits, int window, float scale, cudaStream_t stream) {
  using S = DecodeShape<T, D, KV>;
  const int group = hq / hkv;
  // the merge stages (m, l) per (query row, split) inside the ring
  if (n_splits > 1 && ((size_t)group * n_splits * 2 * sizeof(float) > (size_t)S::RING_BYTES ||
                       part_ml == nullptr || part_acc == nullptr || tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  auto smem_for = [](int g) {
    return (size_t)S::RING_BYTES + ((size_t)g * D + (size_t)g * S::TR + 4 * GMAX) * sizeof(float);
  };
  auto kernel = paged_decode_kernel<T, D, KV, GMAX>;
  static size_t configured[kMaxDevices] = {};
  cudaError_t err = allow_smem_once(kernel, smem_for(GMAX), configured);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n_lanes, hkv, n_splits), DEC_THREADS, smem_for(group), stream>>>(
      static_cast<const T*>(q), static_cast<const char*>(k_pool), static_cast<const char*>(v_pool),
      k_scales, v_scales, tables, positions, slopes, static_cast<T*>(out),
      static_cast<float2*>(part_ml), static_cast<float*>(part_acc), static_cast<unsigned*>(tickets),
      hq, hkv, n_pages, page_size, max_pages, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D, int KV>
int launch_prefill(const void* q, const void* k_pool, const void* v_pool, const float* k_scales,
                   const float* v_scales, const int* table_row, const int* chunk_pos, const int* n_valid,
                   const float* slopes, void* out, int q_len, int hq, int hkv, int n_pages, int page_size,
                   int max_pages, int window, float scale, cudaStream_t stream) {
  using KT = typename std::conditional<KV == KV_FP, T, float>::type;
  const size_t smem = 2 * (size_t)BKV * kv_pitch<KT, D>() * sizeof(KT) +
                      (size_t)BQ * (D + 4) * sizeof(float) + (size_t)BQ * (BKV + 1) * sizeof(float) +
                      (KV == KV_FP ? 0 : 2 * (size_t)BKV * sizeof(float));
  auto kernel = paged_prefill_kernel<T, D, KV>;
  static size_t configured[kMaxDevices] = {};
  cudaError_t err = allow_smem_once(kernel, smem, configured);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((q_len + BQ - 1) / BQ, hq), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const char*>(k_pool), static_cast<const char*>(v_pool),
      k_scales, v_scales, table_row, chunk_pos, n_valid, slopes, static_cast<T*>(out), q_len, hq, hkv,
      n_pages, page_size, max_pages, window, scale);
  return (int)cudaGetLastError();
}

template <int D, int KV>
int launch_prefill_wgmma(const void* q, const void* k_pool, const void* v_pool, const float* k_scales,
                         const float* v_scales, const int* table_row, const int* chunk_pos, const int* n_valid,
                         const float* slopes, void* out, int q_len, int hq, int hkv, int n_pages, int page_size,
                         int max_pages, int window, float scale, cudaStream_t stream) {
  using S = PrefillSmem<D, KV>;
  auto kernel = paged_prefill_wgmma_kernel<D, KV>;
  static size_t configured[kMaxDevices] = {};
  cudaError_t err = allow_smem_once(kernel, S::BYTES, configured);
  if (err != cudaSuccess) return (int)err;
  const int per_block = S::NWG * (PF_ROWS / (hq / hkv));  // query positions of a block
  kernel<<<dim3(hkv, (q_len + per_block - 1) / per_block), S::THREADS, S::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const char*>(k_pool), static_cast<const char*>(v_pool),
      k_scales, v_scales, table_row, chunk_pos, n_valid, slopes, static_cast<__nv_bfloat16*>(out), q_len, hq,
      hkv, n_pages, page_size, max_pages, window, scale);
  return (int)cudaGetLastError();
}

// bf16 queries take the wgmma kernel; float32 keeps the CUDA-core kernel
// (TF32 tensor cores would change float32 results)
template <int D>
int launch_prefill_any(int dtype, int kv, const void* q, const void* k_pool, const void* v_pool,
                       const float* k_scales, const float* v_scales, const int* table_row, const int* chunk_pos,
                       const int* n_valid, const float* slopes, void* out, int q_len, int hq, int hkv,
                       int n_pages, int page_size, int max_pages, int window, float scale, cudaStream_t stream) {
#define PTT_PREFILL_ARGS                                                                                  \
  q, k_pool, v_pool, k_scales, v_scales, table_row, chunk_pos, n_valid, slopes, out, q_len, hq, hkv, n_pages, \
      page_size, max_pages, window, scale, stream
  if (dtype == 1 && kv == KV_FP) return launch_prefill_wgmma<D, KV_FP>(PTT_PREFILL_ARGS);
  if (dtype == 1 && kv == KV_INT8) return launch_prefill_wgmma<D, KV_INT8>(PTT_PREFILL_ARGS);
  if (dtype == 1 && kv == KV_NF4A) return launch_prefill_wgmma<D, KV_NF4A>(PTT_PREFILL_ARGS);
  if (dtype == 0 && kv == KV_FP) return launch_prefill<float, D, KV_FP>(PTT_PREFILL_ARGS);
  if (dtype == 0 && kv == KV_INT8) return launch_prefill<float, D, KV_INT8>(PTT_PREFILL_ARGS);
  if (dtype == 0 && kv == KV_NF4A) return launch_prefill<float, D, KV_NF4A>(PTT_PREFILL_ARGS);
#undef PTT_PREFILL_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes (of q and the output, and of a floating-point pool): 0 =
// float32, 1 = bfloat16. kv codes (the pool's storage): 0 = the dtype's
// floating point, 1 = int8 codes, 2 = nf4a bytes; a quantized pool passes
// its float32 scales, a floating-point pool null. The wrappers in
// petals_tpu_torch/ops/paged_flash_attention.py validate every argument; an
// unsupported (dtype, kv, head_dim) triple returns cudaErrorInvalidValue.
#define PTT_DISPATCH(LAUNCH)                              \
  if (dtype == 0 && head_dim == 64) LAUNCH(float, 64);    \
  if (dtype == 0 && head_dim == 128) LAUNCH(float, 128);  \
  if (dtype == 1 && head_dim == 64) LAUNCH(__nv_bfloat16, 64); \
  if (dtype == 1 && head_dim == 128) LAUNCH(__nv_bfloat16, 128);

extern "C" {

// Decode with each lane's needed slots cut into n_splits runs: with
// n_splits > 1, part_ml is float32 scratch of [n_lanes, hkv, n_splits,
// group, 2], part_acc of [n_lanes, hkv, n_splits, group, head_dim], and
// tickets [n_lanes * hkv] uint32 zeros that the kernel leaves at zero.
int ptt_paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                               const void* k_scales, const void* v_scales, const void* tables,
                               const void* positions, const void* slopes, void* out, void* part_ml,
                               void* part_acc, void* tickets, int dtype, int kv, int n_lanes, int hq,
                               int hkv, int head_dim, int n_pages, int page_size, int max_pages,
                               int n_splits, int window, float scale,
                               void* stream) {
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* t = static_cast<const int*>(tables);
  const int* p = static_cast<const int*>(positions);
  const float* sl = static_cast<const float*>(slopes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_splits < 1 || (long)(n_splits - 1) * SPLIT_ROWS >= (long)max_pages * page_size ||
      hkv < 1 || hq % hkv || hq / hkv > MAX_GROUP)
    return (int)cudaErrorInvalidValue;
  const int gmax = hq / hkv <= 4 ? 4 : MAX_GROUP;
#define PTT_DECODE_KV(T, D, KV, G)                                                              \
  return launch_decode<T, D, KV, G>(q, k_pool, v_pool, ks, vs, t, p, sl, out, part_ml, part_acc, \
                                    tickets, n_lanes, hq, hkv, n_pages, page_size, max_pages,    \
                                    n_splits, window, scale, s)
#define PTT_DECODE(T, D)                                    \
  {                                                         \
    if (kv == KV_FP && gmax == 4) PTT_DECODE_KV(T, D, KV_FP, 4);           \
    if (kv == KV_FP) PTT_DECODE_KV(T, D, KV_FP, MAX_GROUP);                \
    if (kv == KV_INT8 && gmax == 4) PTT_DECODE_KV(T, D, KV_INT8, 4);       \
    if (kv == KV_INT8) PTT_DECODE_KV(T, D, KV_INT8, MAX_GROUP);            \
    if (kv == KV_NF4A && gmax == 4) PTT_DECODE_KV(T, D, KV_NF4A, 4);       \
    if (kv == KV_NF4A) PTT_DECODE_KV(T, D, KV_NF4A, MAX_GROUP);            \
  }
  PTT_DISPATCH(PTT_DECODE)
#undef PTT_DECODE
#undef PTT_DECODE_KV
  return (int)cudaErrorInvalidValue;
}

// chunk_pos and n_valid point at int32 scalars on the device, read by the
// kernel: the launch's arguments do not change with the chunk's position,
// so a captured launch (a CUDA graph) serves every chunk of its length.
int ptt_paged_prefill_attention(const void* q, const void* k_pool, const void* v_pool,
                                const void* k_scales, const void* v_scales, const void* table_row,
                                const void* chunk_pos, const void* n_valid, const void* slopes, void* out,
                                int dtype, int kv, int q_len, int hq, int hkv, int head_dim, int n_pages,
                                int page_size, int max_pages, int window, float scale, void* stream) {
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* t = static_cast<const int*>(table_row);
  const int* cp = static_cast<const int*>(chunk_pos);
  const int* nv = static_cast<const int*>(n_valid);
  const float* sl = static_cast<const float*>(slopes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hkv < 1 || hq % hkv || hq / hkv > MAX_GROUP) return (int)cudaErrorInvalidValue;
  if (head_dim == 64)
    return launch_prefill_any<64>(dtype, kv, q, k_pool, v_pool, ks, vs, t, cp, nv, sl, out, q_len, hq, hkv,
                                  n_pages, page_size, max_pages, window, scale, s);
  if (head_dim == 128)
    return launch_prefill_any<128>(dtype, kv, q, k_pool, v_pool, ks, vs, t, cp, nv, sl, out, q_len, hq, hkv,
                                   n_pages, page_size, max_pages, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* ptt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
