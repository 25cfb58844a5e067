// Causal flash attention over a dense, preallocated KV buffer for Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces the Pallas kernel of petals_tpu/ops/flash_attention.py (_kernel,
// reached from flash_attend): attention of q [batch, q_len, hq, d] over
// k, v [batch, kv_buf_len, hkv, d], of which the first kv_length positions
// are valid. Query row i sits at absolute position q_offset + i and sees kv
// position j when j <= q_offset + i, j < kv_length and, with a sliding
// window, j > q_offset + i - window. q_offset and kv_length are scalars
// shared by the batch. GQA (query head h reads kv head h / group), optional
// ALiBi (slopes[h] * j added to the scaled scores), online softmax in
// float32, probabilities rounded to the storage type for the PV product (as
// the TPU kernel feeds its matrix unit), float32 accumulator, one rounding to
// the output type at the end. Same contract as the plain PyTorch version
// beside the wrapper (petals_tpu_torch/ops/flash_attention.py
// flash_attend_reference).
//
// Where the TPU kernel makes the KV axis the last, sequential grid dimension
// and carries m / l / acc in scratch memory from one grid step to the next,
// here one block owns (batch row, query head, 64-row query tile) and loops
// over the KV tiles itself; nothing carries between blocks. The TPU kernel's
// tile-needed predicate becomes the loop's bounds: the loop starts at the
// first tile the window lets the tile's first row see and stops at
// min(kv_length, last row + 1), so tiles past the causal frontier, past
// kv_length or before the window are never read. Every tile is masked (the
// TPU kernel's unmasked interior tiles are an optimisation left out).
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
// few microseconds. This first version computes both products with CUDA-core
// FMAs from register tiles (4 rows x 8 columns a thread, the loops of the
// paged prefill kernel in csrc/paged_attention.cu), no tensor cores, so it is
// bound by the FMA rate, tens of times above that bound. K/V tiles are
// staged with cp.async (the whole tile in flight at once) into padded shared
// rows; each query head of a GQA group reads its kv head's tiles again, from
// L2. wgmma, TMA and sharing a tile across the group are later work.
//
// Masked probabilities are selected to exactly 0, never left to
// exp(NEG_INF - m): while every score so far was masked, m itself is NEG_INF
// and that exponential is 1. A row that sees nothing (kv_length 0, or a
// window and length that leave it no position) keeps l == 0 and writes exact
// zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;  // DEFAULT_MASK_VALUE

constexpr int BQ = 64;   // query rows per block
constexpr int BKV = 64;  // kv positions per tile
constexpr int NT = 128;  // threads per block
constexpr int RPT = BQ / (NT / 8);  // rows per thread = 4
constexpr int CPT = BKV / 8;        // score columns per thread = 8

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
    int q_offset, int kv_length, int window, float scale) {
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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* slopes, void* out, int batch,
           int q_len, int hq, int hkv, long q_sb, long q_ss, long q_sh, long k_sb, long k_ss,
           long k_sh, long v_sb, long v_ss, long v_sh, int q_offset, int kv_length, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)BKV * kv_pitch<T, D>() * sizeof(T) +
                      (size_t)BQ * (D + 4) * sizeof(float) + (size_t)BQ * (BKV + 1) * sizeof(float);
  auto kernel = flash_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3((q_len + BQ - 1) / BQ, hq, batch), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), slopes,
      static_cast<T*>(out), q_len, hq, hkv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
      q_offset, kv_length, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes (q, k, v and the output share one type): 0 = float32, 1 =
// bfloat16. Strides are in elements. The wrapper in
// petals_tpu_torch/ops/flash_attention.py validates every argument; an
// unsupported (dtype, head_dim) pair returns cudaErrorInvalidValue.
int ptt_flash_attention(const void* q, const void* k, const void* v, const void* slopes, void* out,
                        int dtype, int batch, int q_len, int hq, int hkv, int head_dim,
                        long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                        long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                        long long v_sh, int q_offset, int kv_length, int window, float scale,
                        void* stream) {
  const float* sl = static_cast<const float*>(slopes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_FLASH(T, D)                                                                          \
  return launch<T, D>(q, k, v, sl, out, batch, q_len, hq, hkv, q_sb, q_ss, q_sh, k_sb, k_ss,     \
                      k_sh, v_sb, v_ss, v_sh, q_offset, kv_length, window, scale, s)
  if (dtype == 0 && head_dim == 64) PTT_FLASH(float, 64);
  if (dtype == 0 && head_dim == 128) PTT_FLASH(float, 128);
  if (dtype == 1 && head_dim == 64) PTT_FLASH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) PTT_FLASH(__nv_bfloat16, 128);
#undef PTT_FLASH
  return (int)cudaErrorInvalidValue;
}

const char* ptt_flash_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
