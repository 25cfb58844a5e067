// Ragged paged attention for Hopper (sm_90a): the decode kernel and its
// chunked-prefill twin, bound to Python through a plain C interface (ctypes).
//
// Replaces the Pallas kernels of petals_tpu/ops/paged_flash_attention.py:
//   - paged_decode_kernel  <- _decode_kernel  (paged_flash_attend)
//   - paged_prefill_kernel <- _prefill_kernel (paged_flash_prefill_attend)
// Each is templated on the pool's storage (KV): floating point (K1, K2) or a
// quantized pool, int8 or nf4a (K3: the TPU kernels' quantized arms
// _quant_k_scores / _quant_pv / _nf4a_poly).
// Same contract as the plain PyTorch versions beside the wrappers
// (petals_tpu_torch/ops/paged_attention.py paged_attend /
// paged_prefill_attend): pages are read through the block table, a slot of
// -1 is a hole, and pages past the causal/ragged frontier or outside the
// sliding window are never read at all.
//
// What bounds them on this card. Decode reads every needed K/V page once and
// does ~1 FLOP per byte: it is bound by HBM bytes (3.35 TB/s). The design
// keeps each page read to exactly one pass per (lane, kv head): one block
// owns a lane's kv head and computes all `group` query rows of that head from
// the same shared-memory copy of the page (GQA sharing), so pool bytes are
// read once, not once per query head. Pages are staged with cp.async, the
// whole page in flight at once, because one block per (lane, kv head) leaves
// most SMs idle at small batch and each block's page reads are then bound by
// memory latency, not bandwidth. Chunked prefill at a 512-token chunk
// does ~200 FLOP per byte, close to the card's ridge point; this first
// version keeps the 64-row query tile resident in shared memory and computes
// with CUDA-core FMAs from register tiles (no tensor cores yet), so it is
// bound by FMA issue rate, far from the bf16 tensor-core peak. wgmma, TMA and
// split-KV are later work.
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
// 4-byte cp.async (decode) or plain loads (prefill). Decode decodes each code
// where it is used (a V code once for each query row of the group) and runs
// the fp arm's loops; prefill decodes each staged tile once into float32
// shared memory and then runs the fp arm's register-tiled loops unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;  // DEFAULT_MASK_VALUE
constexpr int WARP = 32;
constexpr int MAX_GROUP = 16;  // query heads per kv head (decode)

// pool storage: floating point (the query's type), int8 codes, nf4a bytes
constexpr int KV_FP = 0;
constexpr int KV_INT8 = 1;
constexpr int KV_NF4A = 2;

// the NF4A cubic v(c) = A*dl + B*dl^3 (ops/quant.py), factored as
// B * dl*(A/B + dl^2): kernels decode the unscaled part and fold B into the scale
constexpr float NF4A_B = 0.0010216002528025852f;
constexpr float NF4A_K = (float)(0.071834915950145642 / 0.0010216002528025852);

__device__ __forceinline__ float nf4a_poly(unsigned c) {
  const float dl = (float)c - 7.5f;
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

// Start copying `rows` float32 scales, one every `src_stride` floats, into a
// dense shared array, with 4-byte cp.async (16-byte copies need 16 contiguous
// bytes; the scales of one kv head are strided by hkv).
__device__ __forceinline__ void copy_scales(float* dst, const float* src, long src_stride, int rows) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + r));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src + r * src_stride));
  }
}

// Wait for this thread's cp.async copies; a __syncthreads() after it makes
// every thread's copies visible to the block.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Dim `d` of staged V row `p` (row pitch row_bytes) as the PV product takes
// it: the value of a floating-point pool, the raw int8 code, or the unscaled
// nf4a cubic of the nibble holding it (byte d of the row for d < D/2, byte
// d - D/2 otherwise).
template <typename T, int D, int KV>
__device__ __forceinline__ float v_value(const char* v_s, int p, int d) {
  constexpr int RB = row_bytes<T, D, KV>();
  if constexpr (KV == KV_FP) {
    return to_f32(reinterpret_cast<const T*>(v_s)[p * D + d]);
  } else if constexpr (KV == KV_INT8) {
    return (float)reinterpret_cast<const int8_t*>(v_s)[p * RB + d];
  } else {
    const unsigned c = reinterpret_cast<const uint8_t*>(v_s)[p * RB + (d < D / 2 ? d : d - D / 2)];
    return nf4a_poly(d < D / 2 ? (c & 0xFu) : (c >> 4));
  }
}

// ---------------------------------------------------------------------------
// decode: grid (n_lanes, hkv), D threads; thread t owns output dim t of every
// query row in the kv head's group.
// ---------------------------------------------------------------------------

template <typename T, int D, int KV>
__global__ void __launch_bounds__(D) paged_decode_kernel(
    const T* __restrict__ q,           // [n_lanes, hq, D]
    const char* __restrict__ k_pool,   // [n_pages, page_size, hkv, row_bytes]
    const char* __restrict__ v_pool,   // [n_pages, page_size, hkv, row_bytes]
    const float* __restrict__ k_scales,  // [n_pages, page_size, hkv] (quantized pools)
    const float* __restrict__ v_scales,
    const int* __restrict__ tables,    // [n_lanes, max_pages], -1 = hole
    const int* __restrict__ positions, // [n_lanes]; kv_len = position + 1
    const float* __restrict__ slopes,  // [hq] ALiBi slopes or nullptr
    T* __restrict__ out,               // [n_lanes, hq, D]
    int hq, int hkv, int n_pages, int page_size, int max_pages, int window, float scale) {
  constexpr int NW = D / WARP;
  constexpr int PER_LANE = D / WARP;
  constexpr int RB = row_bytes<T, D, KV>();
  const int lane_idx = blockIdx.x;
  const int kvh = blockIdx.y;
  const int group = hq / hkv;
  const int tid = threadIdx.x, warp = tid / WARP, wl = tid % WARP;

  extern __shared__ __align__(16) char smem[];
  char* k_s = smem;                                            // [page_size][RB]
  char* v_s = k_s + page_size * RB;                            // [page_size][RB]
  float* ks_s = reinterpret_cast<float*>(v_s + page_size * RB);  // [page_size] (quantized)
  float* vs_s = ks_s + (KV == KV_FP ? 0 : page_size);          // [page_size] (quantized)
  float* q_s = vs_s + (KV == KV_FP ? 0 : page_size);           // [group][D]
  float* p_s = q_s + group * D;                                // [group][page_size]
  float* m_s = p_s + group * page_size;                        // [group] running max
  float* l_s = m_s + group;                                    // [group] running sum
  float* a_s = l_s + group;                                    // [group] this page's rescale
  const T* k_t = reinterpret_cast<const T*>(k_s);
  const int8_t* k_i8 = reinterpret_cast<const int8_t*>(k_s);
  const uint8_t* k_u8 = reinterpret_cast<const uint8_t*>(k_s);

  const int kv_len = positions[lane_idx] + 1;
  for (int i = tid; i < group * D; i += blockDim.x) {
    const int g = i / D, d = i - g * D;
    q_s[i] = to_f32(q[((long)lane_idx * hq + kvh * group + g) * D + d]);
  }
  if (tid < group) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[MAX_GROUP];
#pragma unroll
  for (int g = 0; g < MAX_GROUP; ++g) acc[g] = 0.f;
  __syncthreads();

  const long pitch = (long)hkv * RB;  // bytes between token rows of one kv head
  for (int j = 0; j < max_pages; ++j) {
    const int page = tables[(long)lane_idx * max_pages + j];
    const int slot_start = j * page_size;
    // _decode_page_needed, plus a guard that never reads outside the pool
    bool needed = page >= 0 && page < n_pages && slot_start < kv_len;
    if (window > 0) needed = needed && (slot_start + page_size > kv_len - window);
    if (!needed) continue;  // uniform across the block

    const long row0 = (long)page * page_size * hkv + kvh;  // (page, slot 0, kvh) in rows
    copy_rows(k_s, RB, k_pool + row0 * RB, pitch, page_size, RB);
    copy_rows(v_s, RB, v_pool + row0 * RB, pitch, page_size, RB);
    if constexpr (KV != KV_FP) {
      copy_scales(ks_s, k_scales + row0, hkv, page_size);
      copy_scales(vs_s, v_scales + row0, hkv, page_size);
    }
    cp_async_wait_all();
    __syncthreads();

    // scores: one warp per kv position, all group rows from one read of k
    for (int p = warp; p < page_size; p += NW) {
      float part[MAX_GROUP];
#pragma unroll
      for (int g = 0; g < MAX_GROUP; ++g) part[g] = 0.f;
      if constexpr (KV == KV_NF4A) {
        // byte j: dim j (low nibble) and dim j + D/2 (high nibble)
#pragma unroll
        for (int i = 0; i < PER_LANE / 2; ++i) {
          const int jb = wl + i * WARP;
          const unsigned c = k_u8[p * RB + jb];
          const float lo = nf4a_poly(c & 0xFu), hi = nf4a_poly(c >> 4);
#pragma unroll
          for (int g = 0; g < MAX_GROUP; ++g)
            if (g < group) part[g] += q_s[g * D + jb] * lo + q_s[g * D + jb + D / 2] * hi;
        }
      } else {
#pragma unroll
        for (int i = 0; i < PER_LANE; ++i) {
          const int d = wl + i * WARP;
          const float kd = KV == KV_FP ? to_f32(k_t[p * D + d]) : (float)k_i8[p * D + d];
#pragma unroll
          for (int g = 0; g < MAX_GROUP; ++g)
            if (g < group) part[g] += q_s[g * D + d] * kd;
        }
      }
      const int kv_pos = slot_start + p;
      const float row_scale = KV == KV_FP ? 1.f : ks_s[p] * scale_factor<KV>();
#pragma unroll
      for (int g = 0; g < MAX_GROUP; ++g) {
        if (g < group) {
          float s = warp_sum(part[g]);
          if constexpr (KV != KV_FP) s *= row_scale;
          s *= scale;
          if (slopes != nullptr) s += slopes[kvh * group + g] * (float)kv_pos;
          if (wl == 0) p_s[g * page_size + p] = s;
        }
      }
    }
    __syncthreads();

    // online softmax: one warp per query row
    for (int g = warp; g < group; g += NW) {
      float mx = NEG_INF;
      for (int p = wl; p < page_size; p += WARP) {
        const int kv_pos = slot_start + p;
        const bool ok = kv_pos < kv_len && (window <= 0 || kv_pos > kv_len - 1 - window);
        if (ok) mx = fmaxf(mx, p_s[g * page_size + p]);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int p = wl; p < page_size; p += WARP) {
        const int kv_pos = slot_start + p;
        const bool ok = kv_pos < kv_len && (window <= 0 || kv_pos > kv_len - 1 - window);
        const float e = ok ? expf(p_s[g * page_size + p] - m_new) : 0.f;
        // a quantized pool's V scale folds into the probability (not into l)
        p_s[g * page_size + p] = KV == KV_FP ? e : e * (vs_s[p] * scale_factor<KV>());
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

    // weighted values: thread tid owns dim tid (a quantized pool's V scale
    // is already folded into p_s)
#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g) {
      if (g < group) {
        float a = acc[g] * a_s[g];
        for (int p = 0; p < page_size; ++p) a += p_s[g * page_size + p] * v_value<T, D, KV>(v_s, p, tid);
        acc[g] = a;
      }
    }
    __syncthreads();  // k_s / v_s / p_s are overwritten by the next page
  }

  // a lane with no needed page keeps l == 0 and writes exact zeros
#pragma unroll
  for (int g = 0; g < MAX_GROUP; ++g) {
    if (g < group) {
      out[((long)lane_idx * hq + kvh * group + g) * D + tid] =
          from_f32<T>(acc[g] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

// ---------------------------------------------------------------------------
// chunked prefill: grid (ceil(q_len / BQ), hq), NT threads. Thread (ty, tx) =
// (tid / 8, tid % 8) owns query rows ty + 16 i (i < 4); in the score tile it
// owns kv columns tx + 8 j (j < 8), in the output tile dims tx + 8 k.
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
    const float* __restrict__ slopes,  // [hq] or nullptr
    T* __restrict__ out,               // [q_len, hq, D]
    int q_len, int hq, int hkv, int n_pages, int page_size, int max_pages,
    int chunk_pos, int kv_len, int window, float scale) {
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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D, int KV>
int launch_decode(const void* q, const void* k_pool, const void* v_pool, const float* k_scales,
                  const float* v_scales, const int* tables, const int* positions,
                  const float* slopes, void* out, int n_lanes, int hq, int hkv, int n_pages,
                  int page_size, int max_pages, int window, float scale, cudaStream_t stream) {
  const int group = hq / hkv;
  const size_t smem = 2 * (size_t)page_size * row_bytes<T, D, KV>() +
                      (KV == KV_FP ? 0 : 2 * (size_t)page_size * sizeof(float)) +
                      (size_t)group * D * sizeof(float) + (size_t)group * page_size * sizeof(float) +
                      3 * (size_t)group * sizeof(float);
  auto kernel = paged_decode_kernel<T, D, KV>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n_lanes, hkv), D, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const char*>(k_pool), static_cast<const char*>(v_pool),
      k_scales, v_scales, tables, positions, slopes, static_cast<T*>(out), hq, hkv, n_pages,
      page_size, max_pages, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D, int KV>
int launch_prefill(const void* q, const void* k_pool, const void* v_pool, const float* k_scales,
                   const float* v_scales, const int* table_row, const float* slopes, void* out,
                   int q_len, int hq, int hkv, int n_pages, int page_size, int max_pages,
                   int chunk_pos, int kv_len, int window, float scale, cudaStream_t stream) {
  using KT = typename std::conditional<KV == KV_FP, T, float>::type;
  const size_t smem = 2 * (size_t)BKV * kv_pitch<KT, D>() * sizeof(KT) +
                      (size_t)BQ * (D + 4) * sizeof(float) + (size_t)BQ * (BKV + 1) * sizeof(float) +
                      (KV == KV_FP ? 0 : 2 * (size_t)BKV * sizeof(float));
  auto kernel = paged_prefill_kernel<T, D, KV>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((q_len + BQ - 1) / BQ, hq), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const char*>(k_pool), static_cast<const char*>(v_pool),
      k_scales, v_scales, table_row, slopes, static_cast<T*>(out), q_len, hq, hkv, n_pages,
      page_size, max_pages, chunk_pos, kv_len, window, scale);
  return (int)cudaGetLastError();
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

int ptt_paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                               const void* k_scales, const void* v_scales, const void* tables,
                               const void* positions, const void* slopes, void* out, int dtype,
                               int kv, int n_lanes, int hq, int hkv, int head_dim, int n_pages,
                               int page_size, int max_pages, int window, float scale,
                               void* stream) {
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* t = static_cast<const int*>(tables);
  const int* p = static_cast<const int*>(positions);
  const float* sl = static_cast<const float*>(slopes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_DECODE(T, D)                                                                    \
  {                                                                                         \
    if (kv == KV_FP)                                                                        \
      return launch_decode<T, D, KV_FP>(q, k_pool, v_pool, ks, vs, t, p, sl, out, n_lanes,  \
                                        hq, hkv, n_pages, page_size, max_pages, window,     \
                                        scale, s);                                          \
    if (kv == KV_INT8)                                                                      \
      return launch_decode<T, D, KV_INT8>(q, k_pool, v_pool, ks, vs, t, p, sl, out,         \
                                          n_lanes, hq, hkv, n_pages, page_size, max_pages,  \
                                          window, scale, s);                                \
    if (kv == KV_NF4A)                                                                      \
      return launch_decode<T, D, KV_NF4A>(q, k_pool, v_pool, ks, vs, t, p, sl, out,         \
                                          n_lanes, hq, hkv, n_pages, page_size, max_pages,  \
                                          window, scale, s);                                \
  }
  PTT_DISPATCH(PTT_DECODE)
#undef PTT_DECODE
  return (int)cudaErrorInvalidValue;
}

int ptt_paged_prefill_attention(const void* q, const void* k_pool, const void* v_pool,
                                const void* k_scales, const void* v_scales, const void* table_row,
                                const void* slopes, void* out, int dtype, int kv, int q_len,
                                int hq, int hkv, int head_dim, int n_pages, int page_size,
                                int max_pages, int chunk_pos, int kv_len, int window, float scale,
                                void* stream) {
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* t = static_cast<const int*>(table_row);
  const float* sl = static_cast<const float*>(slopes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_PREFILL(T, D)                                                                    \
  {                                                                                          \
    if (kv == KV_FP)                                                                         \
      return launch_prefill<T, D, KV_FP>(q, k_pool, v_pool, ks, vs, t, sl, out, q_len, hq,   \
                                         hkv, n_pages, page_size, max_pages, chunk_pos,      \
                                         kv_len, window, scale, s);                          \
    if (kv == KV_INT8)                                                                       \
      return launch_prefill<T, D, KV_INT8>(q, k_pool, v_pool, ks, vs, t, sl, out, q_len, hq, \
                                           hkv, n_pages, page_size, max_pages, chunk_pos,    \
                                           kv_len, window, scale, s);                        \
    if (kv == KV_NF4A)                                                                       \
      return launch_prefill<T, D, KV_NF4A>(q, k_pool, v_pool, ks, vs, t, sl, out, q_len, hq, \
                                           hkv, n_pages, page_size, max_pages, chunk_pos,    \
                                           kv_len, window, scale, s);                        \
  }
  PTT_DISPATCH(PTT_PREFILL)
#undef PTT_PREFILL
  return (int)cudaErrorInvalidValue;
}

const char* ptt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
