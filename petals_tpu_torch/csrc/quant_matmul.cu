// Dequant-matmul for Hopper (sm_90a): out = x @ dequant(w) for the port's
// quantized weights, bound to Python through a plain C interface (ctypes).
//
// Replaces the Pallas kernels of petals_tpu/ops/quant.py:
//   - quant_decode_kernel  <- _packed4_decode_kernel (M <= 32) for nf4, nf4a
//                             and int4 (K5), and _int8_kernel at M <= 32 (K6)
//   - quant_prefill_kernel <- _packed4_kernel (M > 32) for nf4, nf4a and int4
//                             (K5), and _int8_kernel at M > 32 (K6)
// Same contract as the plain version (petals_tpu_torch/ops/quant.py
// dequant_matmul_reference): x is bf16 [M, K] (K = in_features, a multiple
// of 64), the weight is [in_stored, N] with stored rows past K ignored, the
// sums are float32 and the output is rounded once to bf16.
//
// Formats. Packed 4-bit: data uint8 [in_stored / 2, N], the low nibble of
// byte (r, n) is row 2r and the high nibble row 2r + 1; scales bf16
// [in_stored / 64, N], one per 64-row block per column. nf4 decodes through
// its 16-entry codebook (a table in shared memory), nf4a through the cubic
// A*d + B*d^3 with d = c - 7.5, int4 as c - 8. Each value is multiplied by
// its block scale and rounded to bf16 before the product, as the plain
// version rounds dequantize(w, bf16). int8: data int8 [in_stored, N], scales
// f32 [N]; int8 -> bf16 is exact and the column scale multiplies the float32
// sum once, at the store (as _int8_kernel does).
//
// What bounds them on this card. At decode (M <= 32) a call reads the
// weight once and does ~2M FLOP per weight: it is bound by HBM bytes
// (3.35 TB/s), and a 4-bit weight is a quarter of the bf16 bytes only if the
// kernel keeps the per-element decode off the critical path and keeps every
// SM streaming. The decode kernel (a) loads packed bytes straight from
// global memory into registers as 16-byte vectors along N (the contiguous
// axis) and builds tensor-core B fragments from them without a shared-memory
// round trip: the mma's 8 columns are mapped onto weight columns so that one
// thread's 16 contiguous bytes feed 16 n8 tiles; (b) computes with
// mma.sync m16n8k16 bf16 (M padded to 16 or 32), so the FMAs cost nothing
// next to the decode; (c) splits K across blocks when N alone gives too few
// blocks to fill the 132 SMs (wo and wd at Mistral-7B have only 4096
// columns), with float32 partial sums reduced in a fixed order by a second
// kernel. At prefill (M = a chunk of hundreds of rows) the work is ~2M FLOP
// per weight on tensor cores: the prefill kernel decodes a 64 x 128 weight
// tile to bf16 in shared memory once per 128 rows of x and runs mma.sync
// from there (the TPU kernel's structure: decode the tile, then a dot).
// wgmma, TMA and a persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QBLOCK = 64;  // rows per scale block (NF4_BLOCK)
constexpr int WARP = 32;

enum Format { NF4 = 0, NF4A = 1, INT4 = 2, INT8 = 3 };

__constant__ float NF4_CODE[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.33791524171829224f, 0.44070982933044434f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f,
};
constexpr float NF4A_A = 0.071834915950145642f;
constexpr float NF4A_B = 0.0010216002528025852f;

// The level of 4-bit code c (0..15).
template <int F>
__device__ __forceinline__ float decode4(uint32_t c, const float* lut) {
  if (F == NF4) return lut[c];
  if (F == NF4A) {
    const float d = static_cast<float>(c) - 7.5f;
    return d * (NF4A_A + NF4A_B * d * d);
  }
  return static_cast<float>(static_cast<int>(c) - 8);  // INT4
}

// Two bf16 values in one register, `lo` in the low half (the lower k index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One packed byte (rows 2r, 2r + 1 of one column) -> its two bf16 weights.
template <int F>
__device__ __forceinline__ uint32_t packed_pair(uint32_t byte, float scale, const float* lut) {
  return pack_bf16(decode4<F>(byte & 0xFu, lut) * scale, decode4<F>(byte >> 4, lut) * scale);
}

// Two int8 bytes (rows k, k + 1 of one column) -> their two bf16 weights.
__device__ __forceinline__ uint32_t int8_pair(uint32_t lo, uint32_t hi) {
  return pack_bf16(static_cast<float>(static_cast<int8_t>(lo)), static_cast<float>(static_cast<int8_t>(hi)));
}

__device__ __forceinline__ uint32_t byte_of(const uint4& v, int j) {
  const uint32_t w = j < 4 ? v.x : j < 8 ? v.y : j < 12 ? v.z : v.w;
  return (w >> (8 * (j & 3))) & 0xFFu;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 load_stream(const void* p) {
  // read-once weight bytes: bypass L1
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void unpack_scales(const __nv_bfloat16* p, float (&s)[16]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint4 b = *reinterpret_cast<const uint4*>(p + 8);
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    s[2 * i] = __uint_as_float(w[i] << 16);
    s[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// ---------------------------------------------------------------- decode (M <= 32)
//
// Grid (ceil(N / 128), k_splits); 4 warps. A block owns 128 columns and the
// scale blocks [split * kb_per_split, ...) of K; its warps take those blocks
// in turn and add up through shared memory at the end. Within a warp, lane
// (g = lane / 4, q = lane % 4) owns weight columns 16g .. 16g + 15 of the
// slab, and the mma's column g of n8 tile j stands for weight column
// 16g + j. The B fragment of a k16 step wants rows 2q, 2q + 1 (one packed
// byte) and 2q + 8, 2q + 9 (the byte 4 packed rows further) of its column:
// so each lane reads whole 16-byte vectors of the rows it needs.

constexpr int DEC_THREADS = 128;
constexpr int DEC_KC = 512;  // columns of x staged in shared memory per round

template <int F, int MT>
__global__ void __launch_bounds__(DEC_THREADS) quant_decode_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ data, const void* __restrict__ scales,
    __nv_bfloat16* __restrict__ out, float* __restrict__ partial, int M, int K, int N, int kb_per_split) {
  constexpr int ROWS = 16 * MT;
  constexpr int XP = DEC_KC + 8;  // padded pitch: conflict-free A fragment loads
  constexpr int XBYTES = ROWS * XP * 2;
  constexpr int RBYTES = 3 * 64 * WARP * 4;  // three warps' sums of one m16 tile
  constexpr int SBYTES = XBYTES > RBYTES ? XBYTES : RBYTES;
  __shared__ __align__(16) unsigned char smem[SBYTES];
  __shared__ float lut[16];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);

  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int g = lane / 4, q = lane % 4;
  const int n_slab = blockIdx.x * 128;
  const int col0 = n_slab + 16 * g;
  const bool col_ok = col0 < N;  // N is a multiple of 16
  const int n_kb = K / QBLOCK;
  const int kb_begin = blockIdx.y * kb_per_split;
  const int kb_end = min(n_kb, kb_begin + kb_per_split);
  if (threadIdx.x < 16) lut[threadIdx.x] = NF4_CODE[threadIdx.x];

  float acc[MT][16][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;

  for (int k0 = kb_begin * QBLOCK; k0 < kb_end * QBLOCK; k0 += DEC_KC) {
    const int width = min(DEC_KC, kb_end * QBLOCK - k0);
    __syncthreads();  // the previous round's readers are done
    const int vecs = width / 8;
    for (int i = threadIdx.x; i < ROWS * vecs; i += DEC_THREADS) {
      const int r = i / vecs, c = (i - r * vecs) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < M) v = *reinterpret_cast<const uint4*>(x + static_cast<long>(r) * K + k0 + c);
      *reinterpret_cast<uint4*>(xs + r * XP + c) = v;
    }
    __syncthreads();
    for (int kb = k0 / QBLOCK + warp; kb < (k0 + width) / QBLOCK; kb += DEC_THREADS / WARP) {
      const int kl = kb * QBLOCK - k0;  // the scale block's first column in xs
      if (F == INT8) {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          uint4 rows[4] = {};
          if (col_ok) {
            const int kr = kb * QBLOCK + 16 * s + 2 * q;  // rows kr, kr+1, kr+8, kr+9
            rows[0] = load_stream(data + static_cast<long>(kr) * N + col0);
            rows[1] = load_stream(data + static_cast<long>(kr + 1) * N + col0);
            rows[2] = load_stream(data + static_cast<long>(kr + 8) * N + col0);
            rows[3] = load_stream(data + static_cast<long>(kr + 9) * N + col0);
          }
          uint32_t a[MT][4];
#pragma unroll
          for (int t = 0; t < MT; ++t) {
            const __nv_bfloat16* base = xs + (t * 16 + g) * XP + kl + 16 * s + 2 * q;
            a[t][0] = *reinterpret_cast<const uint32_t*>(base);
            a[t][1] = *reinterpret_cast<const uint32_t*>(base + 8 * XP);
            a[t][2] = *reinterpret_cast<const uint32_t*>(base + 8);
            a[t][3] = *reinterpret_cast<const uint32_t*>(base + 8 * XP + 8);
          }
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const uint32_t b0 = int8_pair(byte_of(rows[0], j), byte_of(rows[1], j));
            const uint32_t b1 = int8_pair(byte_of(rows[2], j), byte_of(rows[3], j));
#pragma unroll
            for (int t = 0; t < MT; ++t) mma_bf16(acc[t][j], a[t], b0, b1);
          }
        }
      } else {
        uint4 raw[8] = {};
        float sc[16];
        if (col_ok) {
#pragma unroll
          for (int s = 0; s < 8; ++s)  // packed rows q, q+4, ..., q+28 of the block
            raw[s] = load_stream(data + static_cast<long>(kb * (QBLOCK / 2) + q + 4 * s) * N + col0);
          unpack_scales(static_cast<const __nv_bfloat16*>(scales) + static_cast<long>(kb) * N + col0, sc);
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j) sc[j] = 0.f;
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) {  // k16 step: packed rows 8s + q and 8s + q + 4
          uint32_t a[MT][4];
#pragma unroll
          for (int t = 0; t < MT; ++t) {
            const __nv_bfloat16* base = xs + (t * 16 + g) * XP + kl + 16 * s + 2 * q;
            a[t][0] = *reinterpret_cast<const uint32_t*>(base);
            a[t][1] = *reinterpret_cast<const uint32_t*>(base + 8 * XP);
            a[t][2] = *reinterpret_cast<const uint32_t*>(base + 8);
            a[t][3] = *reinterpret_cast<const uint32_t*>(base + 8 * XP + 8);
          }
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const uint32_t b0 = packed_pair<F>(byte_of(raw[2 * s], j), sc[j], lut);
            const uint32_t b1 = packed_pair<F>(byte_of(raw[2 * s + 1], j), sc[j], lut);
#pragma unroll
            for (int t = 0; t < MT; ++t) mma_bf16(acc[t][j], a[t], b0, b1);
          }
        }
      }
    }
  }

  // add the four warps' sums (one m16 tile at a time) into warp 0's registers
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    __syncthreads();
    if (warp > 0) {
#pragma unroll
      for (int i = 0; i < 64; ++i) red[((warp - 1) * 64 + i) * WARP + lane] = acc[t][i / 4][i % 4];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        acc[t][i / 4][i % 4] += red[i * WARP + lane] + red[(64 + i) * WARP + lane] + red[(128 + i) * WARP + lane];
    }
  }
  if (warp != 0) return;
  const float* col_scale = F == INT8 ? static_cast<const float*>(scales) : nullptr;
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = t * 16 + g + (e >= 2 ? 8 : 0);
        const int n = n_slab + 16 * (2 * q + (e & 1)) + j;  // mma column 2q + (e & 1) of tile j
        if (m >= M || n >= N) continue;
        const float v = acc[t][j][e];
        if (partial != nullptr) {
          partial[(static_cast<long>(blockIdx.y) * M + m) * N + n] = v;
        } else {
          out[static_cast<long>(m) * N + n] = __float2bfloat16(col_scale != nullptr ? v * col_scale[n] : v);
        }
      }
}

// Sums the k splits' float32 partials in split order, applies int8's column
// scale, and rounds once to bf16.
__global__ void split_reduce_kernel(const float* __restrict__ partial, int k_splits, const float* __restrict__ col_scale,
                                    __nv_bfloat16* __restrict__ out, int M, int N) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long total = static_cast<long>(M) * N;
  if (i >= total) return;
  float s = 0.f;
  for (int k = 0; k < k_splits; ++k) s += partial[k * total + i];
  if (col_scale != nullptr) s *= col_scale[i % N];
  out[i] = __float2bfloat16(s);
}

// ---------------------------------------------------------------- prefill (M > 32)
//
// Block tile 128 x 128, one 64-row scale block of K per step; 8 warps as
// 2 (rows) x 4 (columns), each 64 x 32 = 4 x 4 mma tiles. Per step: x's tile
// arrives by cp.async (double-buffered, rows past M zero-filled), each
// thread decodes one 16-byte vector of the weight tile (packed: 2 rows x 16
// columns; int8: 1 row x 16 columns, twice) into bf16 in shared memory, and
// the warps run ldmatrix + mma.sync over it. The next step's weight bytes
// are loaded into registers while this step computes.

constexpr int PF_THREADS = 256;
constexpr int PF_BM = 128, PF_BN = 128;
constexpr int PF_XP = QBLOCK + 8;  // padded pitches: conflict-free ldmatrix
constexpr int PF_WP = PF_BN + 8;
constexpr int PF_SMEM = (2 * PF_BM * PF_XP + QBLOCK * PF_WP) * 2;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;  // 0: zero-fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

template <int F>
__global__ void __launch_bounds__(PF_THREADS) quant_prefill_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ data, const void* __restrict__ scales,
    __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(16) unsigned char pf_smem[];
  __shared__ float lut[16];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(pf_smem);  // [2][BM][XP]
  __nv_bfloat16* ws = xs + 2 * PF_BM * PF_XP;                        // [64][WP]

  const int tid = threadIdx.x, warp = tid / WARP, lane = tid % WARP;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * PF_BM, n0 = blockIdx.x * PF_BN;
  const int n_kb = K / QBLOCK;
  if (tid < 16) lut[tid] = NF4_CODE[tid];

  // this thread's share of the weight tile: 16 columns of packed row wr
  // (rows 2wr, 2wr + 1), or of int8 rows wr and wr + 32
  const int wr = tid / 8, wc = (tid % 8) * 16;
  const bool wcol_ok = n0 + wc < N;

  auto load_x = [&](int stage, int kb) {
#pragma unroll
    for (int v = 0; v < (PF_BM * QBLOCK / 8) / PF_THREADS; ++v) {
      const int i = tid + v * PF_THREADS;
      const int r = i / 8, c = (i % 8) * 8;
      const bool ok = m0 + r < M;
      const __nv_bfloat16* src = ok ? x + static_cast<long>(m0 + r) * K + kb * QBLOCK + c : x;
      cp_async16(xs + (stage * PF_BM + r) * PF_XP + c, src, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  uint4 wraw[2] = {};
  float sc[16];
  auto load_w = [&](int kb) {
    if (!wcol_ok) return;
    if (F == INT8) {
      wraw[0] = load_stream(data + static_cast<long>(kb * QBLOCK + wr) * N + n0 + wc);
      wraw[1] = load_stream(data + static_cast<long>(kb * QBLOCK + wr + 32) * N + n0 + wc);
    } else {
      wraw[0] = load_stream(data + static_cast<long>(kb * (QBLOCK / 2) + wr) * N + n0 + wc);
      unpack_scales(static_cast<const __nv_bfloat16*>(scales) + static_cast<long>(kb) * N + n0 + wc, sc);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;

  load_x(0, 0);
  load_w(0);
  __syncthreads();  // lut
  for (int kb = 0; kb < n_kb; ++kb) {
    const int stage = kb & 1;
    // decode this step's weight tile into ws (the previous step's readers are done)
    uint32_t r0[8], r1[8];
    if (!wcol_ok) {
#pragma unroll
      for (int i = 0; i < 8; ++i) r0[i] = r1[i] = 0u;
    } else if (F == INT8) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        r0[i] = int8_pair(byte_of(wraw[0], 2 * i), byte_of(wraw[0], 2 * i + 1));
        r1[i] = int8_pair(byte_of(wraw[1], 2 * i), byte_of(wraw[1], 2 * i + 1));
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t b0 = byte_of(wraw[0], 2 * i), b1 = byte_of(wraw[0], 2 * i + 1);
        r0[i] = pack_bf16(decode4<F>(b0 & 0xFu, lut) * sc[2 * i], decode4<F>(b1 & 0xFu, lut) * sc[2 * i + 1]);
        r1[i] = pack_bf16(decode4<F>(b0 >> 4, lut) * sc[2 * i], decode4<F>(b1 >> 4, lut) * sc[2 * i + 1]);
      }
    }
    const int row0 = F == INT8 ? wr : 2 * wr, row1 = F == INT8 ? wr + 32 : 2 * wr + 1;
    uint4* d0 = reinterpret_cast<uint4*>(ws + row0 * PF_WP + wc);
    uint4* d1 = reinterpret_cast<uint4*>(ws + row1 * PF_WP + wc);
    d0[0] = make_uint4(r0[0], r0[1], r0[2], r0[3]);
    d0[1] = make_uint4(r0[4], r0[5], r0[6], r0[7]);
    d1[0] = make_uint4(r1[0], r1[1], r1[2], r1[3]);
    d1[1] = make_uint4(r1[4], r1[5], r1[6], r1[7]);
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    if (kb + 1 < n_kb) {
      load_x(stage ^ 1, kb + 1);
      load_w(kb + 1);
    }
    const __nv_bfloat16* xt = xs + stage * PF_BM * PF_XP;
#pragma unroll
    for (int s = 0; s < QBLOCK / 16; ++s) {
      uint32_t a[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        ldmatrix_x4(a[t], xt + (wm * 64 + t * 16 + lane % 16) * PF_XP + 16 * s + (lane / 16) * 8);
      uint32_t b[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)  // n8 tiles 2h and 2h + 1 of the warp's 32 columns
        ldmatrix_x4_trans(b[h], ws + (16 * s + lane % 16) * PF_WP + wn * 32 + h * 16 + (lane / 16) * 8);
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[t][j], a[t], b[j / 2][(j % 2) * 2], b[j / 2][(j % 2) * 2 + 1]);
    }
    __syncthreads();
  }

  const float* col_scale = F == INT8 ? static_cast<const float*>(scales) : nullptr;
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn * 32 + j * 8 + 2 * q;
      if (n >= N) continue;
      float s0 = 1.f, s1 = 1.f;
      if (col_scale != nullptr) s0 = col_scale[n], s1 = col_scale[n + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 64 + t * 16 + g + 8 * h;
        if (m >= M) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long>(m) * N + n) =
            __floats2bfloat162_rn(acc[t][j][2 * h] * s0, acc[t][j][2 * h + 1] * s1);
      }
    }
}

template <int F, int MT>
int launch_decode(const void* x, const void* data, const void* scales, void* out, void* partial, int M, int K,
                  int N, int k_splits, int kb_per_split, cudaStream_t stream) {
  const dim3 grid((N + 127) / 128, k_splits);
  quant_decode_kernel<F, MT><<<grid, DEC_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(data), scales,
      static_cast<__nv_bfloat16*>(out), k_splits > 1 ? static_cast<float*>(partial) : nullptr, M, K, N,
      kb_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || k_splits == 1) return static_cast<int>(err);
  const long total = static_cast<long>(M) * N;
  split_reduce_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(partial), k_splits, F == INT8 ? static_cast<const float*>(scales) : nullptr,
      static_cast<__nv_bfloat16*>(out), M, N);
  return static_cast<int>(cudaGetLastError());
}

template <int F>
int launch_prefill(const void* x, const void* data, const void* scales, void* out, int M, int K, int N,
                   cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(quant_prefill_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           PF_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((N + PF_BN - 1) / PF_BN, (M + PF_BM - 1) / PF_BM);
  quant_prefill_kernel<F><<<grid, PF_THREADS, PF_SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(data), scales,
      static_cast<__nv_bfloat16*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out [M, N] bf16 = x [M, K] bf16 @ dequant(w), M <= 32. With k_splits > 1,
// `partial` is float32 scratch of [k_splits, M, N].
int ptt_quant_matmul_decode(int format, const void* x, const void* data, const void* scales, void* out,
                            void* partial, int M, int K, int N, int k_splits, int kb_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || M > 32 || K % QBLOCK || N % 16 || k_splits < 1) return static_cast<int>(cudaErrorInvalidValue);
#define PTT_DECODE(F)                                                                                      \
  return M <= 16 ? launch_decode<F, 1>(x, data, scales, out, partial, M, K, N, k_splits, kb_per_split, s) \
                 : launch_decode<F, 2>(x, data, scales, out, partial, M, K, N, k_splits, kb_per_split, s)
  if (format == NF4) PTT_DECODE(NF4);
  if (format == NF4A) PTT_DECODE(NF4A);
  if (format == INT4) PTT_DECODE(INT4);
  if (format == INT8) PTT_DECODE(INT8);
#undef PTT_DECODE
  return static_cast<int>(cudaErrorInvalidValue);
}

// out [M, N] bf16 = x [M, K] bf16 @ dequant(w), any M >= 1.
int ptt_quant_matmul_prefill(int format, const void* x, const void* data, const void* scales, void* out, int M,
                             int K, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || K % QBLOCK || N % 16) return static_cast<int>(cudaErrorInvalidValue);
  if (format == NF4) return launch_prefill<NF4>(x, data, scales, out, M, K, N, s);
  if (format == NF4A) return launch_prefill<NF4A>(x, data, scales, out, M, K, N, s);
  if (format == INT4) return launch_prefill<INT4>(x, data, scales, out, M, K, N, s);
  if (format == INT8) return launch_prefill<INT8>(x, data, scales, out, M, K, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ptt_quant_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
