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
// kernel.
//
// At prefill (M = a chunk of hundreds of rows) a call does 2*M*K*N
// operations on bytes it reads once: it is bound by operations, 2*M*K*N over
// the 989 TFLOP/s of bf16 tensor cores, and only wgmma reaches that rate. The
// prefill kernel (a) runs wgmma.mma_async m64n128k16 from shared memory, x
// arriving through a 4-stage cp.async ring in wgmma's 128-byte swizzle; (b)
// decodes each 64 x 128 weight tile (one scale block) to bf16 in shared
// memory, K-major and swizzled, into one of two buffers while the tensor
// cores multiply the other, so the decode hides behind the products; (c)
// shares each decoded tile across 128 or 256 rows of x (two warpgroups of
// one or two 64-row sub-tiles; a sub-tile past M issues no product, so a
// chunk wastes at most part of one 64-row tile) and decodes with cheap
// instructions (nibbles to floats by a byte permute, no conversion); (d)
// splits K into whole scale blocks when the tiles alone cannot fill the card
// (ops/quant_matmul.py prefill_plan chooses the tile height and the split),
// reduced in split order as at decode, so results are deterministic.

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
// One block of two warpgroups (256 threads) owns a tile of 128 * MW rows of
// x by 128 columns of the weight and a range of whole scale blocks of K (all
// of K unless the host split K). Warpgroup g owns rows [64 * MW * g, 64 * MW *
// (g + 1)) of the tile as MW sub-tiles of 64 rows; a sub-tile that lies past
// M issues no product. A k step is one scale block (64 rows of K):
//
//   - x's 128 * MW x 64 tile and the step's raw weight bytes (and 4-bit
//     scales) arrive by cp.async into a ring of PF_STAGES stages, issued
//     PF_STAGES - 1 steps ahead; rows past M and columns past N zero-fill.
//     x is stored K-major in wgmma's 128-byte swizzle (16-byte chunk c of row
//     r at c ^ (r % 8)); the raw bytes with the same kind of swizzle keyed by
//     the k chunk, so the decode's reads are free of bank conflicts.
//   - The decoded tile B is bf16, K-major (row n = weight column, 64 k values
//     = 128 bytes), in the same swizzle, and double-buffered. Step s issues
//     wgmma.mma_async m64n128k16 on x[s] and B[s & 1], then, while the tensor
//     cores run, all 256 threads decode step s + 1's bytes into B[(s + 1) & 1],
//     then wait for the products and meet at one barrier.
//   - Each thread decodes 4 weight columns x 8 k values a step: a packed byte
//     holds k rows 2r and 2r + 1 of one column, a bf16 pair of B's row, so 4
//     words of raw bytes become 4 16-byte stores. 4-bit levels come from the
//     nibble through a byte permute into a float's mantissa (c exactly, with
//     no int-to-float conversion), then int4's c - 8 or nf4a's f32 cubic, or
//     nf4's table in shared memory; times the column's scale, rounded to
//     bf16. int8 widens exactly; its column scale is applied to the sum.
//
// Epilogue: with one K split each thread rounds its sums (times int8's
// column scale) to bf16 and stores them; with several it stores float32
// partials that split_reduce_kernel adds in split order.

constexpr int PF_THREADS = 256;
constexpr int PF_BN = 128;
constexpr int PF_STAGES = 4;
constexpr int PF_ROW_BYTES = QBLOCK * 2;  // one bf16 row of a k step: 128 bytes

// Shared memory of one block: PF_STAGES stages of [x | raw | scales], then
// the two decoded B buffers, then nf4's table; every tile 1024-byte aligned
// (the period of the 128-byte swizzle).
template <int F, int MW>
struct PrefillSmem {
  static constexpr int X_BYTES = 128 * MW * PF_ROW_BYTES;
  static constexpr int RAW_BYTES = F == INT8 ? QBLOCK * PF_BN : QBLOCK / 2 * PF_BN;
  static constexpr int SCALE_BYTES = 1024;  // PF_BN bf16 scales, padded to the alignment
  static constexpr int STAGE_BYTES = X_BYTES + RAW_BYTES + SCALE_BYTES;
  static constexpr int B_BYTES = PF_BN * PF_ROW_BYTES;
  static constexpr int B_OFFSET = PF_STAGES * STAGE_BYTES;
  static constexpr int LUT_OFFSET = B_OFFSET + 2 * B_BYTES;
  static constexpr int BYTES = LUT_OFFSET + 64 + 1024;  // + slack to align the base
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;  // 0: zero-fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// 8-row groups 1024 bytes apart (SBO); the k16 step advances the start
// address by 32 bytes inside the swizzled row.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// keeps the compiler from moving accumulator registers across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] * B[16 x 128], both K-major in shared memory;
// bf16 inputs, float32 sums
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));  // scale-d: accumulate into d
}

// The 4-bit code in byte `sel` of `nibbles` (each byte 0..15) as a float,
// exactly: the byte lands in the mantissa of 2**23, which is then subtracted.
__device__ __forceinline__ float nibble_float(uint32_t nibbles, uint32_t sel) {
  return __uint_as_float(__byte_perm(nibbles, 0x4B000000u, sel)) - 8388608.f;
}

// A 4-bit code's level (float32), as decode4 computes it.
template <int F>
__device__ __forceinline__ float level4(uint32_t nibbles, uint32_t sel, const float* lut) {
  if (F == NF4) return lut[__byte_perm(nibbles, 0u, sel)];
  const float c = nibble_float(nibbles, sel);
  if (F == INT4) return c - 8.f;
  const float d = c - 7.5f;
  return d * (NF4A_A + NF4A_B * d * d);
}

// __byte_perm selectors that move byte j of the first operand to byte 0 and
// bytes 7, 6, 5 (of the second operand) above it
__device__ __forceinline__ uint32_t low_byte_sel(int j) { return 0x7650u | static_cast<uint32_t>(j); }

template <int F, int MW>
__global__ void __launch_bounds__(PF_THREADS, 1) quant_prefill_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ data, const void* __restrict__ scales,
    __nv_bfloat16* __restrict__ out, float* __restrict__ partial, int M, int K, int N, int kb_per_split) {
  using S = PrefillSmem<F, MW>;
  constexpr int BM = 128 * MW;
  constexpr int RAW_ROWS = F == INT8 ? QBLOCK : QBLOCK / 2;  // raw rows per k step
  constexpr int RAW_GROUP = F == INT8 ? 8 : 4;               // raw rows per decoded 16-byte k chunk
  extern __shared__ unsigned char pf_smem_raw[];
  const uint32_t raw_base = smem_u32(pf_smem_raw);
  unsigned char* smem = pf_smem_raw + (((raw_base + 1023) & ~1023u) - raw_base);
  const uint32_t base = smem_u32(smem);
  float* lut = reinterpret_cast<float*>(smem + S::LUT_OFFSET);

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % WARP, warp = tid / WARP;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * PF_BN;
  const int kb_begin = blockIdx.z * kb_per_split;
  const int n_steps = min(K / QBLOCK, kb_begin + kb_per_split) - kb_begin;
  if (F == NF4 && tid < 16) lut[tid] = NF4_CODE[tid];

  // issue the cp.async copies of local step s into its ring stage (an empty
  // group past the last step keeps the group count uniform)
  auto load_step = [&](int s) {
    if (s < n_steps) {
      const int kb = kb_begin + s;
      const uint32_t stage = base + (s % PF_STAGES) * S::STAGE_BYTES;
#pragma unroll
      for (int v = 0; v < BM * 8 / PF_THREADS; ++v) {
        const int e = tid + v * PF_THREADS, r = e / 8, c = e % 8;
        const bool ok = m0 + r < M;
        const __nv_bfloat16* src = ok ? x + static_cast<long>(m0 + r) * K + kb * QBLOCK + c * 8 : x;
        cp_async16(stage + r * PF_ROW_BYTES + ((c ^ (r % 8)) * 16), src, ok);
      }
#pragma unroll
      for (int v = 0; v < RAW_ROWS * 8 / PF_THREADS; ++v) {
        const int e = tid + v * PF_THREADS, r = e / 8, j = e % 8;
        const bool ok = n0 + 16 * j < N;
        const uint8_t* src = ok ? data + static_cast<long>(kb * RAW_ROWS + r) * N + n0 + 16 * j : data;
        cp_async16(stage + S::X_BYTES + r * PF_BN + ((j ^ ((r / RAW_GROUP) % 8)) * 16), src, ok);
      }
      if (F != INT8 && tid < PF_BN / 8) {
        const bool ok = n0 + 8 * tid < N;
        const __nv_bfloat16* s_src = static_cast<const __nv_bfloat16*>(scales) + static_cast<long>(kb) * N + n0;
        cp_async16(stage + S::X_BYTES + S::RAW_BYTES + tid * 16, ok ? s_src + 8 * tid : s_src, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // this thread's share of the decode: weight columns 4q .. 4q + 3 of the
  // tile, decoded k chunk c (k rows 8c .. 8c + 7 of the step)
  const int c = lane % 8, q = 4 * warp + lane / 8;
  auto decode_step = [&](int s) {
    const unsigned char* stage = smem + (s % PF_STAGES) * S::STAGE_BYTES;
    const unsigned char* raw = stage + S::X_BYTES + ((warp ^ c) * 16) + (lane / 8) * 4;
    unsigned char* bt = smem + S::B_OFFSET + (s & 1) * S::B_BYTES;
    uint32_t o[4][4];  // [column j][word]: bf16 pairs of k rows 8c + 2i, 8c + 2i + 1
    if (F == INT8) {
      uint32_t w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) w[i] = *reinterpret_cast<const uint32_t*>(raw + (8 * c + i) * PF_BN);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          o[j][i] = pack_bf16(static_cast<float>(static_cast<int8_t>(w[2 * i] >> (8 * j))),
                              static_cast<float>(static_cast<int8_t>(w[2 * i + 1] >> (8 * j))));
    } else {
      const uint2 sv = *reinterpret_cast<const uint2*>(stage + S::X_BYTES + S::RAW_BYTES + q * 8);
      const float sc[4] = {__uint_as_float(sv.x << 16), __uint_as_float(sv.x & 0xFFFF0000u),
                           __uint_as_float(sv.y << 16), __uint_as_float(sv.y & 0xFFFF0000u)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(raw + (4 * c + i) * PF_BN);
        const uint32_t lo = w & 0x0F0F0F0Fu, hi = (w >> 4) & 0x0F0F0F0Fu;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          o[j][i] = pack_bf16(level4<F>(lo, low_byte_sel(j), lut) * sc[j], level4<F>(hi, low_byte_sel(j), lut) * sc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 4 * q + j;
      *reinterpret_cast<uint4*>(bt + n * PF_ROW_BYTES + ((c ^ (n % 8)) * 16)) =
          make_uint4(o[j][0], o[j][1], o[j][2], o[j][3]);
    }
  };

  float acc[MW][64];
#pragma unroll
  for (int t = 0; t < MW; ++t)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[t][i] = 0.f;
  // sub-tile t of this warpgroup covers rows m0 + 64 (MW g + t) ...: it
  // issues products only if one of its rows lies below M
  bool live[MW];
#pragma unroll
  for (int t = 0; t < MW; ++t) live[t] = m0 + 64 * (MW * wg + t) < M;

  // prologue: steps 0 .. STAGES - 2 in flight; steps 0 and 1 landed; B[0]
#pragma unroll
  for (int s = 0; s < PF_STAGES - 1; ++s) load_step(s);
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PF_STAGES - 3) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  decode_step(0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  for (int s = 0; s < n_steps; ++s) {
    // the stage step s - 1 used: its x was read by the products waited for
    // at the end of step s - 1, its bytes decoded during step s - 2
    load_step(s + PF_STAGES - 1);
    const uint32_t xa = base + (s % PF_STAGES) * S::STAGE_BYTES + wg * MW * 64 * PF_ROW_BYTES;
    const uint32_t bb = base + S::B_OFFSET + (s & 1) * S::B_BYTES;
#pragma unroll
    for (int t = 0; t < MW; ++t) {
      if (!live[t]) continue;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < QBLOCK / 16; ++k)
        wgmma_m64n128k16(acc[t], sw128_desc(xa + t * 64 * PF_ROW_BYTES + 32 * k), sw128_desc(bb + 32 * k));
    }
    wgmma_commit();
#pragma unroll
    for (int t = 0; t < MW; ++t) fence_acc(acc[t]);
    // while the tensor cores run: the next step's weight tile
    if (s + 1 < n_steps) decode_step(s + 1);
    // steps <= s + 2 landed (the next step's x, the one after's bytes)
    asm volatile("cp.async.wait_group %0;\n" ::"n"(PF_STAGES - 3) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wgmma_wait0();
#pragma unroll
    for (int t = 0; t < MW; ++t) fence_acc(acc[t]);
    __syncthreads();
  }

  // accumulator element i of a warpgroup's m64n128 product: row 16 * (warp
  // in the group) + lane / 4 + 8 * bit 1 of i, column 8 * (i / 4) + 2 * (lane
  // % 4) + bit 0 of i
  const float* col_scale = F == INT8 ? static_cast<const float*>(scales) : nullptr;
#pragma unroll
  for (int t = 0; t < MW; ++t) {
    if (!live[t]) continue;
    const int row0 = m0 + 64 * (MW * wg + t) + 16 * (warp % 4) + lane / 4;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int m = row0 + 8 * ((i >> 1) & 1);
      const int n = n0 + 8 * (i / 4) + 2 * (lane % 4);
      if (m >= M || n >= N) continue;
      if (partial != nullptr) {
        *reinterpret_cast<float2*>(partial + (static_cast<long>(blockIdx.z) * M + m) * N + n) =
            make_float2(acc[t][i], acc[t][i + 1]);
      } else {
        float s0 = 1.f, s1 = 1.f;
        if (col_scale != nullptr) s0 = col_scale[n], s1 = col_scale[n + 1];
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long>(m) * N + n) =
            __floats2bfloat162_rn(acc[t][i] * s0, acc[t][i + 1] * s1);
      }
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

template <int F, int MW>
int launch_prefill(const void* x, const void* data, const void* scales, void* out, void* partial, int M, int K,
                   int N, int k_splits, int kb_per_split, cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  static bool configured[kMaxDevices] = {};  // the shared-memory attribute, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !configured[dev]) {
    err = cudaFuncSetAttribute(quant_prefill_kernel<F, MW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               PrefillSmem<F, MW>::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) configured[dev] = true;
  }
  const dim3 grid((M + 128 * MW - 1) / (128 * MW), (N + PF_BN - 1) / PF_BN, k_splits);
  quant_prefill_kernel<F, MW><<<grid, PF_THREADS, PrefillSmem<F, MW>::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(data), scales,
      static_cast<__nv_bfloat16*>(out), k_splits > 1 ? static_cast<float*>(partial) : nullptr, M, K, N,
      kb_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || k_splits == 1) return static_cast<int>(err);
  const long total = static_cast<long>(M) * N;
  split_reduce_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(partial), k_splits, F == INT8 ? static_cast<const float*>(scales) : nullptr,
      static_cast<__nv_bfloat16*>(out), M, N);
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

// out [M, N] bf16 = x [M, K] bf16 @ dequant(w), any M >= 1, in tiles of
// 128 * mw rows (mw 1 or 2) by 128 columns, K split into k_splits ranges of
// kb_per_split scale blocks. With k_splits > 1, `partial` is float32
// scratch of [k_splits, M, N].
int ptt_quant_matmul_prefill(int format, const void* x, const void* data, const void* scales, void* out,
                             void* partial, int M, int K, int N, int mw, int k_splits, int kb_per_split,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || K % QBLOCK || N % 16 || (mw != 1 && mw != 2) || k_splits < 1 || kb_per_split < 1 ||
      (k_splits - 1) * kb_per_split >= K / QBLOCK || (k_splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
#define PTT_PREFILL(F)                                                                                     \
  return mw == 1 ? launch_prefill<F, 1>(x, data, scales, out, partial, M, K, N, k_splits, kb_per_split, s) \
                 : launch_prefill<F, 2>(x, data, scales, out, partial, M, K, N, k_splits, kb_per_split, s)
  if (format == NF4) PTT_PREFILL(NF4);
  if (format == NF4A) PTT_PREFILL(NF4A);
  if (format == INT4) PTT_PREFILL(INT4);
  if (format == INT8) PTT_PREFILL(INT8);
#undef PTT_PREFILL
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ptt_quant_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
