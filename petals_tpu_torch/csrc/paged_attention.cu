// Ragged paged attention for Hopper (sm_90a): the decode kernel and its
// chunked-prefill twin, bound to Python through a plain C interface (ctypes).
//
// Replaces the two Pallas kernels of petals_tpu/ops/paged_flash_attention.py:
//   - paged_decode_kernel  <- _decode_kernel  (paged_flash_attend)
//   - paged_prefill_kernel <- _prefill_kernel (paged_flash_prefill_attend)
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;  // DEFAULT_MASK_VALUE
constexpr int WARP = 32;
constexpr int MAX_GROUP = 16;  // query heads per kv head (decode)

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

// ---------------------------------------------------------------------------
// decode: grid (n_lanes, hkv), D threads; thread t owns output dim t of every
// query row in the kv head's group.
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(D) paged_decode_kernel(
    const T* __restrict__ q,           // [n_lanes, hq, D]
    const T* __restrict__ k_pool,      // [n_pages, page_size, hkv, D]
    const T* __restrict__ v_pool,      // [n_pages, page_size, hkv, D]
    const int* __restrict__ tables,    // [n_lanes, max_pages], -1 = hole
    const int* __restrict__ positions, // [n_lanes]; kv_len = position + 1
    const float* __restrict__ slopes,  // [hq] ALiBi slopes or nullptr
    T* __restrict__ out,               // [n_lanes, hq, D]
    int hq, int hkv, int n_pages, int page_size, int max_pages, int window, float scale) {
  constexpr int NW = D / WARP;
  constexpr int PER_LANE = D / WARP;
  const int lane_idx = blockIdx.x;
  const int kvh = blockIdx.y;
  const int group = hq / hkv;
  const int tid = threadIdx.x, warp = tid / WARP, wl = tid % WARP;

  extern __shared__ __align__(16) char smem[];
  T* k_s = reinterpret_cast<T*>(smem);                        // [page_size][D]
  T* v_s = k_s + page_size * D;                               // [page_size][D]
  float* q_s = reinterpret_cast<float*>(v_s + page_size * D); // [group][D]
  float* p_s = q_s + group * D;                               // [group][page_size]
  float* m_s = p_s + group * page_size;                       // [group] running max
  float* l_s = m_s + group;                                   // [group] running sum
  float* a_s = l_s + group;                                   // [group] this page's rescale

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

  const long pitch = (long)hkv * D * sizeof(T);  // bytes between token rows of one kv head
  for (int j = 0; j < max_pages; ++j) {
    const int page = tables[(long)lane_idx * max_pages + j];
    const int slot_start = j * page_size;
    // _decode_page_needed, plus a guard that never reads outside the pool
    bool needed = page >= 0 && page < n_pages && slot_start < kv_len;
    if (window > 0) needed = needed && (slot_start + page_size > kv_len - window);
    if (!needed) continue;  // uniform across the block

    const long base = ((long)page * page_size * hkv + kvh) * D;
    copy_rows(reinterpret_cast<char*>(k_s), D * sizeof(T),
              reinterpret_cast<const char*>(k_pool + base), pitch, page_size, D * sizeof(T));
    copy_rows(reinterpret_cast<char*>(v_s), D * sizeof(T),
              reinterpret_cast<const char*>(v_pool + base), pitch, page_size, D * sizeof(T));
    cp_async_wait_all();
    __syncthreads();

    // scores: one warp per kv position, all group rows from one read of k
    for (int p = warp; p < page_size; p += NW) {
      float part[MAX_GROUP];
#pragma unroll
      for (int g = 0; g < MAX_GROUP; ++g) part[g] = 0.f;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        const int d = wl + i * WARP;
        const float kd = to_f32(k_s[p * D + d]);
#pragma unroll
        for (int g = 0; g < MAX_GROUP; ++g)
          if (g < group) part[g] += q_s[g * D + d] * kd;
      }
      const int kv_pos = slot_start + p;
#pragma unroll
      for (int g = 0; g < MAX_GROUP; ++g) {
        if (g < group) {
          float s = warp_sum(part[g]) * scale;
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
        p_s[g * page_size + p] = e;
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

    // weighted values: thread tid owns dim tid
#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g) {
      if (g < group) {
        float a = acc[g] * a_s[g];
        for (int p = 0; p < page_size; ++p) a += p_s[g * page_size + p] * to_f32(v_s[p * D + tid]);
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

template <typename T, int D>
__global__ void __launch_bounds__(NT) paged_prefill_kernel(
    const T* __restrict__ q,           // [q_len, hq, D] (one lane's chunk)
    const T* __restrict__ k_pool,      // [n_pages, page_size, hkv, D]
    const T* __restrict__ v_pool,
    const int* __restrict__ table_row, // [max_pages], -1 = hole
    const float* __restrict__ slopes,  // [hq] or nullptr
    T* __restrict__ out,               // [q_len, hq, D]
    int q_len, int hq, int hkv, int n_pages, int page_size, int max_pages,
    int chunk_pos, int kv_len, int window, float scale) {
  constexpr int KP = kv_pitch<T, D>();
  constexpr int QP = D + 4;
  constexpr int PP = BKV + 1;
  constexpr int DPT = D / 8;  // output dims per thread
  const int qb = blockIdx.x, h = blockIdx.y;
  const int kvh = h / (hq / hkv);
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;

  extern __shared__ __align__(16) char smem[];
  T* k_s = reinterpret_cast<T*>(smem);                     // [BKV][KP]
  T* v_s = k_s + BKV * KP;                                 // [BKV][KP]
  float* q_s = reinterpret_cast<float*>(v_s + BKV * KP);   // [BQ][QP]
  float* p_s = q_s + BQ * QP;                              // [BQ][PP]

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
  const long pitch = (long)hkv * D * sizeof(T);

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
      const long base = (((long)page * page_size + off) * hkv + kvh) * D;
      __syncthreads();  // the previous tile's readers are done
      copy_rows(reinterpret_cast<char*>(k_s), KP * sizeof(T),
                reinterpret_cast<const char*>(k_pool + base), pitch, tile, D * sizeof(T));
      copy_rows(reinterpret_cast<char*>(v_s), KP * sizeof(T),
                reinterpret_cast<const char*>(v_pool + base), pitch, tile, D * sizeof(T));
      cp_async_wait_all();
      __syncthreads();

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
          p_s[r * PP + tx + 8 * c] = e;
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

template <typename T, int D>
int launch_decode(const void* q, const void* k_pool, const void* v_pool, const int* tables,
                  const int* positions, const float* slopes, void* out, int n_lanes, int hq,
                  int hkv, int n_pages, int page_size, int max_pages, int window, float scale,
                  cudaStream_t stream) {
  const int group = hq / hkv;
  const size_t smem = 2 * (size_t)page_size * D * sizeof(T) + (size_t)group * D * sizeof(float) +
                      (size_t)group * page_size * sizeof(float) + 3 * (size_t)group * sizeof(float);
  auto kernel = paged_decode_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n_lanes, hkv), D, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      tables, positions, slopes, static_cast<T*>(out), hq, hkv, n_pages, page_size, max_pages,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_prefill(const void* q, const void* k_pool, const void* v_pool, const int* table_row,
                   const float* slopes, void* out, int q_len, int hq, int hkv, int n_pages,
                   int page_size, int max_pages, int chunk_pos, int kv_len, int window,
                   float scale, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)BKV * kv_pitch<T, D>() * sizeof(T) +
                      (size_t)BQ * (D + 4) * sizeof(float) + (size_t)BQ * (BKV + 1) * sizeof(float);
  auto kernel = paged_prefill_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((q_len + BQ - 1) / BQ, hq), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      table_row, slopes, static_cast<T*>(out), q_len, hq, hkv, n_pages, page_size, max_pages,
      chunk_pos, kv_len, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. The wrappers in
// petals_tpu_torch/ops/paged_flash_attention.py validate every argument;
// an unsupported (dtype, head_dim) pair returns cudaErrorInvalidValue.
extern "C" {

int ptt_paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                               const void* tables, const void* positions, const void* slopes,
                               void* out, int dtype, int n_lanes, int hq, int hkv, int head_dim,
                               int n_pages, int page_size, int max_pages, int window, float scale,
                               void* stream) {
  const int* t = static_cast<const int*>(tables);
  const int* p = static_cast<const int*>(positions);
  const float* sl = static_cast<const float*>(slopes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_DECODE(T, D)                                                                      \
  return launch_decode<T, D>(q, k_pool, v_pool, t, p, sl, out, n_lanes, hq, hkv, n_pages,    \
                             page_size, max_pages, window, scale, s)
  if (dtype == 0 && head_dim == 64) PTT_DECODE(float, 64);
  if (dtype == 0 && head_dim == 128) PTT_DECODE(float, 128);
  if (dtype == 1 && head_dim == 64) PTT_DECODE(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) PTT_DECODE(__nv_bfloat16, 128);
#undef PTT_DECODE
  return (int)cudaErrorInvalidValue;
}

int ptt_paged_prefill_attention(const void* q, const void* k_pool, const void* v_pool,
                                const void* table_row, const void* slopes, void* out, int dtype,
                                int q_len, int hq, int hkv, int head_dim, int n_pages,
                                int page_size, int max_pages, int chunk_pos, int kv_len,
                                int window, float scale, void* stream) {
  const int* t = static_cast<const int*>(table_row);
  const float* sl = static_cast<const float*>(slopes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_PREFILL(T, D)                                                                      \
  return launch_prefill<T, D>(q, k_pool, v_pool, t, sl, out, q_len, hq, hkv, n_pages,         \
                              page_size, max_pages, chunk_pos, kv_len, window, scale, s)
  if (dtype == 0 && head_dim == 64) PTT_PREFILL(float, 64);
  if (dtype == 0 && head_dim == 128) PTT_PREFILL(float, 128);
  if (dtype == 1 && head_dim == 64) PTT_PREFILL(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) PTT_PREFILL(__nv_bfloat16, 128);
#undef PTT_PREFILL
  return (int)cudaErrorInvalidValue;
}

const char* ptt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
