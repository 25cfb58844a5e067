// Dequant-matmul for Hopper (sm_90a): out = x @ dequant(w) for the port's
// quantized weights, bound to Python through a plain C interface (ctypes).
//
// Replaces the Pallas kernels of petals_tpu/ops/quant.py:
//   - quant_decode_ring_kernel <- _packed4_decode_kernel (M <= 32) for nf4,
//                                 nf4a and int4 (K5), and _int8_kernel at
//                                 M <= 32 (K6)
//   - quant_prefill_kernel     <- _packed4_kernel (M > 32) for nf4, nf4a and
//                                 int4 (K5), and _int8_kernel at M > 32 (K6)
// Same contract as the plain version (petals_tpu_torch/ops/quant.py
// dequant_matmul_reference): x is bf16 [M, K] (K = in_features, a multiple
// of 64), the weight is [in_stored, N] with stored rows past K ignored, the
// sums are float32 and the output is rounded once to bf16.
//
// Formats. Packed 4-bit: data uint8 [in_stored / 2, N], the low nibble of
// byte (r, n) is row 2r and the high nibble row 2r + 1; scales bf16
// [in_stored / 64, N], one per 64-row block per column. nf4 decodes through
// its 16-entry codebook, nf4a through its cubic levels (the plain version's
// float32 table), int4 as c - 8. Each level times its block scale is rounded
// to bf16 before the product, as the plain version rounds dequantize(w,
// bf16). int8: data int8 [in_stored, N], scales f32 [N]; int8 -> bf16 is
// exact and the column scale multiplies the float32 sum once, at the store
// (as _int8_kernel does).
//
// What bounds them on this card. At decode (M <= 32) a call reads the
// weight once and does ~2M FLOP per weight: it is bound by HBM bytes
// (3.35 TB/s), and a 4-bit weight is a quarter of the bf16 bytes only if
// (1) enough weight bytes are in flight on every SM to cover the memory
// latency, (2) the per-weight decode costs fewer instructions than the SM
// can issue while its bytes arrive, and (3) every SM streams to the end.
// The decode kernel answers each:
//   (1) one producer thread per block keeps two rings of 2-4 stages (64 KB
//       of weight bytes) in flight with the TMA engine, four copies a
//       stage (two 4 KB boxes of weight bytes, x's rows, the scales), that
//       complete on an mbarrier per stage; four consumer warps decode and
//       multiply the stages that have landed and release them through a
//       second mbarrier;
//   (2) a packed byte (two weights of one column) becomes its scaled bf16
//       pair in five instructions: a byte permute that turns it into an
//       address, two loads from a 256-entry table in shared memory (each
//       level split into a bf16 head and a bf16 tail; one copy per lane, so
//       the loads never conflict), and two bf16x2 fmas, head x scale + tail
//       x scale, rounded once; int8 pairs in four (a permute, two masks into
//       bf16 bit patterns and one exact bf16x2 subtract). No int-to-float
//       conversion and no float32 rounding per weight. Products run on
//       mma.sync m16n8k16 with the weights as the 16-row A operand and x as
//       the 8-column B operand, so 8 rows of x fill an mma without padding;
//   (3) the (256-column slab, scale block) units are dealt out in equal
//       contiguous runs to at most one block per SM, so every SM streams
//       the same bytes at every shape (ops/quant_matmul.py decode_plan
//       takes a multiple of the slab count when that fills the card, so no
//       run cuts two slabs; else one block per SM, stream-K); a slab cut
//       between blocks is merged inside the kernel: each block writes its
//       float32 partial, and the last to take the slab's atomic ticket adds
//       the partials in K order, rounds once and resets the ticket, so the
//       result is bit-equal on repeats and no second kernel is launched.
// A weight's rounding: the fma rounds head x scale + round(tail x scale)
// once to bf16, so a 4-bit weight is the plain version's round(level x
// scale) but where the product lies within ~2**-17 of a rounding boundary
// (nf4a: about one weight in 800, one bf16 ulp apart; nf4, int4 and int8:
// bit-equal on the card check's weights).
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
// reduced in split order by split_reduce_kernel, so results are
// deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

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
// nf4a's levels A*d + B*d**3, d = c - 7.5, as the plain version's float32
// table holds them (petals_tpu_torch/ops/quant.py NF4A_CODE)
__constant__ float NF4A_CODE[16] = {
    -0.9697494506835938f, -0.7474839091300964f, -0.5650607943534851f, -0.41635045409202576f,
    -0.29522332549095154f, -0.19554980099201202f, -0.11120027303695679f, -0.03604515641927719f,
    0.03604515641927719f, 0.11120027303695679f, 0.19554980099201202f, 0.29522332549095154f,
    0.41635045409202576f, 0.5650607943534851f, 0.7474839091300964f, 0.9697494506835938f,
};
constexpr float NF4A_A = 0.071834915950145642f;
constexpr float NF4A_B = 0.0010216002528025852f;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------- mbarriers and TMA

using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::tma_load_2d;

// `bytes` (a multiple of 16) of contiguous memory by the TMA engine
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 128;\n" ::: "memory"); }

// atomic add with release and acquire semantics at device scope: writes
// ordered before it (this warp's, through __syncwarp) are visible to whoever
// reads its result, and it sees theirs
__device__ __forceinline__ unsigned ticket_add(unsigned* p) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n" : "=r"(old) : "l"(p) : "memory");
  return old;
}

// ---------------------------------------------------------------- decode (M <= 32)
//
// Work: the weight's columns in slabs of DEC_SLAB = 256, K in scale blocks of
// 64 rows; a unit is one (slab, scale block), units numbered slab-major.
// Block b of G (at most one per SM) takes units [U * b / G, U * (b + 1) / G):
// a run of scale blocks of one slab, whole slabs, then the start of another
// (when G is a multiple of the slab count, a run lies in one slab). Each
// run of one slab is a segment; a segment that is not a whole slab leaves a
// float32 partial, merged by the slab's last contributor (see the epilogue).
//
// A block is 5 warps. Lane 0 of warp 4, the producer, loads unit l of its
// range into stage (l / 2) % stages of ring l % 2 with four TMA copies: the
// unit's packed rows as two boxes of [32 rows x 128 bytes] (int8: 64 rows),
// one per column half, and x's M rows of 64 k values as one box, all three
// in the 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)),
// so the consumers' loads never conflict; and the 256 bf16 scales as one
// bulk copy. The stage's `full` mbarrier counts the bytes. Consumer warp w
// takes column half w & 1 (128 columns) of the units of parity w >> 1, from
// ring w >> 1: two units are decoded at once, and the two parities' sums are
// added through shared memory at the end of each segment. A consumer
// releases a stage by arriving on its `empty` mbarrier (two arrivals: both
// column halves). A ring per parity keeps each stage's waiters in step with
// its fills: with one shared ring, a fast parity could wait on a stage two
// fills ahead of the slow one and take the older fill's phase for its own.
//
// Within a consumer warp, lane (g = lane / 4, q = lane % 4) owns columns
// 16g .. 16g + 15 of its half. The mma's A operand is 16 weight columns x 16
// k slots: tile t maps mma row g to column 16g + 2t and row g + 8 to column
// 16g + 2t + 1, so one 16-byte row segment feeds 8 tiles. The k slots may
// stand for any k rows the B operand (x^T, 16 k x 8 rows of x; n8 tile nt
// holds x rows 8nt .. 8nt + 7) repeats: 4-bit slots 2q, 2q + 1 are packed row
// 2q of the k16 step's 8 and slots 2q + 8, 2q + 9 packed row 2q + 1 (k rows
// 4q .. 4q + 3 of the step, one 8-byte load of x); int8's are k rows 2q, 2q +
// 1, 2q + 8, 2q + 9. x rows past M hold whatever the stage held and only
// reach output columns of D that are never stored.

constexpr int DEC_SLAB = 256;                       // columns of a unit
constexpr int DEC_CONSUMERS = 4;                    // warps: column half x unit parity
constexpr int DEC_THREADS = (DEC_CONSUMERS + 1) * WARP;
constexpr int DEC_LUT_STRIDE = 256;                 // bytes between table entries: 32 lanes' heads, tails
constexpr int DEC_LUT_BYTES = 256 * DEC_LUT_STRIDE;  // entry e of lane l: head at e * 256 + 4 * l, tail + 128

template <int F, int NT>
struct DecodeSmem {  // every tile 1024-byte aligned (the swizzle's period)
  static constexpr int RAW_ROWS = F == INT8 ? QBLOCK : QBLOCK / 2;  // stored rows of a scale block
  static constexpr int HALF_BYTES = RAW_ROWS * 128;                 // one column half's box
  static constexpr int X_OFFSET = 2 * HALF_BYTES;
  static constexpr int X_BYTES = NT * 1024;  // 8 rows of 128 bytes per n8 tile
  static constexpr int SCALE_OFFSET = X_OFFSET + X_BYTES;
  static constexpr int STAGE_BYTES = SCALE_OFFSET + (F == INT8 ? 0 : 1024);  // 512 bytes of scales, padded
  static constexpr int LUT_BYTES = F == INT8 ? 0 : DEC_LUT_BYTES;
  static constexpr int RED_BYTES = 2 * NT * 32 * WARP * 4;  // parity 1's sums, both halves
  static constexpr int bytes(int stages) {  // two rings, + barriers, merge flags, alignment slack
    return LUT_BYTES + 2 * stages * STAGE_BYTES + RED_BYTES + 32 * stages + 16 + 1024;
  }
};

template <int F>
__device__ __forceinline__ float level(int c) {
  return F == NF4 ? NF4_CODE[c] : F == NF4A ? NF4A_CODE[c] : static_cast<float>(c - 8);
}

// The two weights of byte j of `w` (rows 2r, 2r + 1 of one column), scaled:
// the byte becomes the table address e * 256 + 4 * lane by one permute
// (byte 0 from `lane4`, byte 1 from `w`), then the head and the tail loads
// and two bf16x2 fmas: round(head x scale + round(tail x scale))
template <int J>
__device__ __forceinline__ uint32_t lookup4(const unsigned char* lut, uint32_t w, uint32_t lane4, uint32_t scale2) {
  const unsigned char* entry = lut + __byte_perm(w, lane4, 0x5504u | (J << 4));
  const uint32_t head = *reinterpret_cast<const uint32_t*>(entry);
  const uint32_t tail = *reinterpret_cast<const uint32_t*>(entry + 128);
  uint32_t t, out;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(t) : "r"(tail), "r"(scale2), "r"(0x80008000u));  // + -0: a product
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(out) : "r"(head), "r"(scale2), "r"(t));
  return out;
}

// The two int8 weights in byte j of `lo` (row k) and of `hi` (row k + 1) as
// bf16x2, exactly: with c's low 7 bits under 0x4300 the bf16 is 128 + (c &
// 0x7F), with its sign bit under 0x4300 it is 128 or 256, and their
// difference is c
template <int J>
__device__ __forceinline__ uint32_t int8_pair(uint32_t lo, uint32_t hi) {
  const uint32_t p = __byte_perm(lo, hi, J | ((4 + J) << 8));
  const uint32_t a = (p & 0x007F007Fu) | 0x43004300u, b = (p & 0x00800080u) | 0x43004300u;
  uint32_t out;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(out) : "r"(b), "r"(0xBF80BF80u), "r"(a));  // a - b
  return out;
}

// 16 bytes of row r of a swizzled box: chunk c at c ^ (r % 8)
__device__ __forceinline__ uint4 box_chunk(const unsigned char* box, int r, int c) {
  return *reinterpret_cast<const uint4*>(box + r * 128 + ((c ^ (r % 8)) * 16));
}

// One unit's share of a consumer warp: 128 columns x 64 k rows into acc.
template <int F, int NT>
__device__ __forceinline__ void decode_unit(const unsigned char* stage, const unsigned char* lut, int half, int lane,
                                            float (&acc)[NT][8][4]) {
  using S = DecodeSmem<F, NT>;
  const int g = lane / 4, q = lane % 4;
  const unsigned char* raw = stage + half * S::HALF_BYTES;
  const unsigned char* xs = stage + S::X_OFFSET;
  const uint32_t lane4 = 4u * static_cast<uint32_t>(lane);
  uint32_t sa[8], sb[8];  // {s, s} of columns 16g + 2t and 16g + 2t + 1
  if (F != INT8) {
    const unsigned char* sc = stage + S::SCALE_OFFSET + (half * 128 + 16 * g) * 2;
    const uint4 s0 = *reinterpret_cast<const uint4*>(sc), s1 = *reinterpret_cast<const uint4*>(sc + 16);
    const uint32_t sw[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
    for (int t = 0; t < 8; ++t) sa[t] = __byte_perm(sw[t], 0u, 0x1010u), sb[t] = __byte_perm(sw[t], 0u, 0x3232u);
  }
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {  // k16 steps of the scale block
    uint32_t bx[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const unsigned char* xr = xs + (8 * nt + g) * 128;  // x row 8nt + g: its row in the box is 8nt + g, % 8 = g
      if (F == INT8) {  // k 16ks + 2q, + 1 (chunk 2ks) and 16ks + 2q + 8, + 9 (chunk 2ks + 1)
        bx[nt][0] = *reinterpret_cast<const uint32_t*>(xr + (((2 * ks) ^ g) * 16) + 4 * q);
        bx[nt][1] = *reinterpret_cast<const uint32_t*>(xr + (((2 * ks + 1) ^ g) * 16) + 4 * q);
      } else {  // k 16ks + 4q .. 4q + 3: chunk 2ks + q / 2, bytes 8 (q % 2)
        const uint2 v = *reinterpret_cast<const uint2*>(xr + (((2 * ks + q / 2) ^ g) * 16) + 8 * (q % 2));
        bx[nt][0] = v.x, bx[nt][1] = v.y;
      }
    }
    uint32_t va[4], vb[4], vc[4], vd[4];
    if (F == INT8) {  // k rows 2q, 2q + 1, 2q + 8, 2q + 9 of the step
      const int r0 = 16 * ks + 2 * q;
      const uint4 a = box_chunk(raw, r0, g), b = box_chunk(raw, r0 + 1, g);
      const uint4 c = box_chunk(raw, r0 + 8, g), d = box_chunk(raw, r0 + 9, g);
      va[0] = a.x, va[1] = a.y, va[2] = a.z, va[3] = a.w, vb[0] = b.x, vb[1] = b.y, vb[2] = b.z, vb[3] = b.w;
      vc[0] = c.x, vc[1] = c.y, vc[2] = c.z, vc[3] = c.w, vd[0] = d.x, vd[1] = d.y, vd[2] = d.z, vd[3] = d.w;
    } else {  // packed rows 2q and 2q + 1 of the step
      const uint4 a = box_chunk(raw, 8 * ks + 2 * q, g), c = box_chunk(raw, 8 * ks + 2 * q + 1, g);
      va[0] = a.x, va[1] = a.y, va[2] = a.z, va[3] = a.w, vc[0] = c.x, vc[1] = c.y, vc[2] = c.z, vc[3] = c.w;
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {  // bytes 2t, 2t + 1 of the segment: word t / 2, bytes 2 (t % 2), + 1
      uint32_t a[4];
      if (F == INT8) {
        a[0] = (t & 1) ? int8_pair<2>(va[t / 2], vb[t / 2]) : int8_pair<0>(va[t / 2], vb[t / 2]);
        a[1] = (t & 1) ? int8_pair<3>(va[t / 2], vb[t / 2]) : int8_pair<1>(va[t / 2], vb[t / 2]);
        a[2] = (t & 1) ? int8_pair<2>(vc[t / 2], vd[t / 2]) : int8_pair<0>(vc[t / 2], vd[t / 2]);
        a[3] = (t & 1) ? int8_pair<3>(vc[t / 2], vd[t / 2]) : int8_pair<1>(vc[t / 2], vd[t / 2]);
      } else {
        a[0] = (t & 1) ? lookup4<2>(lut, va[t / 2], lane4, sa[t]) : lookup4<0>(lut, va[t / 2], lane4, sa[t]);
        a[1] = (t & 1) ? lookup4<3>(lut, va[t / 2], lane4, sb[t]) : lookup4<1>(lut, va[t / 2], lane4, sb[t]);
        a[2] = (t & 1) ? lookup4<2>(lut, vc[t / 2], lane4, sa[t]) : lookup4<0>(lut, vc[t / 2], lane4, sa[t]);
        a[3] = (t & 1) ? lookup4<3>(lut, vc[t / 2], lane4, sb[t]) : lookup4<1>(lut, vc[t / 2], lane4, sb[t]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt][t], a, bx[nt][0], bx[nt][1]);
    }
  }
}

// The first unit of block b of G over U units (the stream-K deal)
__device__ __forceinline__ long unit_begin(long units, int b, int G) { return units * b / G; }

// The block whose range holds unit v: the largest b with unit_begin(b) <= v
__device__ __forceinline__ int unit_owner(long units, long v, int G) {
  return static_cast<int>(((v + 1) * G + units - 1) / units) - 1;
}

template <int F, int NT>
__global__ void __launch_bounds__(DEC_THREADS, 1) quant_decode_ring_kernel(
    const __grid_constant__ CUtensorMap data_map, const __grid_constant__ CUtensorMap x_map,
    const void* __restrict__ scales, __nv_bfloat16* __restrict__ out, float* __restrict__ partial,
    unsigned* __restrict__ tickets, int M, int K, int N, int stages) {
  using S = DecodeSmem<F, NT>;
  extern __shared__ unsigned char dec_smem_raw[];
  const uint32_t raw_base = hopper::smem_u32(dec_smem_raw);
  unsigned char* smem = dec_smem_raw + (((raw_base + 1023) & ~1023u) - raw_base);
  const unsigned char* lut = smem;
  unsigned char* ring = smem + S::LUT_BYTES;
  float* red = reinterpret_cast<float*>(ring + 2 * stages * S::STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::LUT_BYTES + 2 * stages * S::STAGE_BYTES + S::RED_BYTES);
  uint64_t* empty = full + 2 * stages;
  int* merge_half = reinterpret_cast<int*>(empty + 2 * stages);  // [2]: this block merges column half h

  const int n_kb = K / QBLOCK, n_slabs = (N + DEC_SLAB - 1) / DEC_SLAB, G = gridDim.x;
  const long units = static_cast<long>(n_slabs) * n_kb;
  const long u_begin = unit_begin(units, blockIdx.x, G), u_end = unit_begin(units, blockIdx.x + 1, G);
  const int n_local = static_cast<int>(u_end - u_begin);
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * stages; ++s) {
      mbar_init(hopper::smem_u32(full + s), 1);
      mbar_init(hopper::smem_u32(empty + s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == DEC_CONSUMERS) {  // the producer: no division in its loop, which paces the copies
    if (lane != 0) return;
    int slab = static_cast<int>(u_begin / n_kb), kb = static_cast<int>(u_begin - static_cast<long>(slab) * n_kb);
    int js = 0;            // (l / 2) % stages: the stage in ring l % 2
    uint32_t jphase = 0;   // ((l / 2) / stages) & 1: the parity of its use
    for (int l = 0; l < n_local; ++l) {
      const int s = (l & 1) * stages + js;
      mbar_wait(hopper::smem_u32(empty + s), jphase ^ 1);
      const int col0 = slab * DEC_SLAB, cols = min(DEC_SLAB, N - col0);
      const uint32_t bar = hopper::smem_u32(full + s), st = hopper::smem_u32(ring + s * S::STAGE_BYTES);
      // out-of-range box columns (a last slab narrower than 256) arrive as zeros and count in full
      mbar_expect_tx(bar, 2 * S::HALF_BYTES + M * QBLOCK * 2 + (F == INT8 ? 0 : 2 * cols));
      tma_load_2d(st, &data_map, col0, kb * S::RAW_ROWS, bar);
      tma_load_2d(st + S::HALF_BYTES, &data_map, col0 + 128, kb * S::RAW_ROWS, bar);
      tma_load_2d(st + S::X_OFFSET, &x_map, kb * QBLOCK, 0, bar);
      if (F != INT8)
        bulk_load(st + S::SCALE_OFFSET, static_cast<const __nv_bfloat16*>(scales) + static_cast<long>(kb) * N + col0,
                  2 * cols, bar);
      if (++kb == n_kb) kb = 0, ++slab;
      if ((l & 1) && ++js == stages) js = 0, jphase ^= 1;
    }
    return;
  }

  // consumers: the level table first (4-bit). Entry e holds the head bf16x2
  // {h(e & 15), h(e >> 4)} with h(c) = level(c) rounded to bf16, and the
  // tail with t(c) = level(c) - h(c) rounded (0 for int4's exact levels),
  // each once per lane; the 16 heads and tails are staged in `red`, which
  // is free until the first segment ends
  if (F != INT8) {
    uint16_t* ht = reinterpret_cast<uint16_t*>(red);  // [head 16 | tail 16], bf16 bits
    if (threadIdx.x < 32) {
      const float v = level<F>(threadIdx.x % 16), h = __bfloat162float(__float2bfloat16(v));
      ht[threadIdx.x] = __bfloat16_as_ushort(__float2bfloat16(threadIdx.x < 16 ? h : v - h));
    }
    consumers_sync();
    for (int i = threadIdx.x; i < DEC_LUT_BYTES / 16; i += DEC_CONSUMERS * WARP) {  // 16 bytes: 4 lanes' copies
      const int e = i / 16, part = (i % 16) / 8;  // 8 chunks of heads, then 8 of tails
      const uint32_t v = ht[16 * part + (e & 15)] | (static_cast<uint32_t>(ht[16 * part + (e >> 4)]) << 16);
      *reinterpret_cast<uint4*>(smem + 16 * i) = make_uint4(v, v, v, v);
    }
  }
  consumers_sync();

  const int half = warp & 1, parity = warp >> 1;
  const int g = lane / 4, q = lane % 4;
  const float* col_scale = F == INT8 ? static_cast<const float*>(scales) : nullptr;
  float acc[NT][8][4];
  int js = 0;           // this warp's units count j = l / 2 from 0: stage j % stages of its ring
  uint32_t jphase = 0;  // (j / stages) & 1
  for (long u = u_begin; u < u_end;) {
    const int slab = static_cast<int>(u / n_kb);
    const long slab_end = static_cast<long>(slab + 1) * n_kb, seg_end = u_end < slab_end ? u_end : slab_end;
    const int l0 = static_cast<int>(u - u_begin), l1 = static_cast<int>(seg_end - u_begin);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][t][e] = 0.f;
    for (int l = l0 + ((l0 ^ parity) & 1); l < l1; l += 2) {  // this warp's parity, from its ring
      const int s = parity * stages + js;
      mbar_wait(hopper::smem_u32(full + s), jphase);
      decode_unit<F, NT>(ring + s * S::STAGE_BYTES, lut, half, lane, acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(hopper::smem_u32(empty + s));
      if (++js == stages) js = 0, jphase ^= 1;
    }

    // parity 1's sums into parity 0's registers
    float* my_red = red + half * (NT * 32 * WARP);
    consumers_sync();
    if (parity == 1) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 32; ++i) my_red[(nt * 32 + i) * WARP + lane] = acc[nt][i / 4][i % 4];
    }
    consumers_sync();
    const int hcol0 = slab * DEC_SLAB + half * 128;  // this half's first column
    const bool whole = u == static_cast<long>(slab) * n_kb && seg_end == slab_end;
    const int first = unit_owner(units, static_cast<long>(slab) * n_kb, G);
    const int last = unit_owner(units, slab_end - 1, G);
    if (parity == 0) {
      bool merge = false;
      if (hcol0 < N) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[nt][i / 4][i % 4] += my_red[(nt * 32 + i) * WARP + lane];
        // element (nt, t, e): column hcol0 + 16g + 2t + (e >> 1), x row 8nt + 2q + (e & 1)
        const bool col_ok = hcol0 + 16 * g < N;  // N is a multiple of 16
        if (whole) {  // the whole slab: round and store
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int t = 0; t < 8; ++t)
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int m = 8 * nt + 2 * q + r, n = hcol0 + 16 * g + 2 * t;
                if (m >= M || !col_ok) continue;
                float v0 = acc[nt][t][r], v1 = acc[nt][t][2 + r];
                if (col_scale != nullptr) v0 *= col_scale[n], v1 *= col_scale[n + 1];
                *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long>(m) * N + n) =
                    __floats2bfloat162_rn(v0, v1);
              }
        } else {
          // a cut slab: write the partial (slot 0 for the block's first
          // segment, 1 for its last); the last contributor merges
          const int slot = u == u_begin ? 0 : 1;
          float* mine = partial + ((static_cast<long>(blockIdx.x) * 2 + slot) * 2 + half) * M * 128;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int t = 0; t < 8; ++t)
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int m = 8 * nt + 2 * q + r;
                if (m >= M || !col_ok) continue;
                *reinterpret_cast<float2*>(mine + m * 128 + 16 * g + 2 * t) =
                    make_float2(acc[nt][t][r], acc[nt][t][2 + r]);
              }
          __syncwarp();  // the warp's partial is ordered before the ticket's release
          unsigned ticket = 0;
          if (lane == 0) ticket = ticket_add(tickets + 2 * slab + half);
          ticket = __shfl_sync(0xFFFFFFFFu, ticket, 0);
          merge = ticket == static_cast<unsigned>(last - first);
          if (merge && lane == 0) tickets[2 * slab + half] = 0u;  // ready for the next launch
        }
      }
      if (lane == 0) merge_half[half] = merge;
    }
    consumers_sync();

    // the last contributor's four warps add the partials of blocks first ..
    // last in that (K) order, for the halves it merges at once: 4 columns a
    // vector, 4 vectors a thread and 8 blocks of loads in flight (the
    // ticket's acquire, then the barrier, orders these loads after the
    // partials' writes)
    const int halves = merge_half[0] | (merge_half[1] << 1);
    if (halves != 0) {
      const int n_vec = M * 32;  // float4s of a half: row m, columns 4 (v % 32) ..
      const int h0 = halves == 2 ? 1 : 0, total = (halves == 3 ? 2 : 1) * n_vec;
      // block `first` began before this slab unless its run starts at it:
      // then its partial here is its last segment's (slot 1); every later
      // contributor began inside the slab (slot 0)
      const int first_slot = units * first >= static_cast<long>(slab) * n_kb * G ? 0 : 1;
      for (int v0 = threadIdx.x; v0 < total; v0 += 4 * DEC_CONSUMERS * WARP) {
        float4 sum[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) sum[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int b0 = first; b0 <= last; b0 += 8) {
          float4 v[8][4];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int b = b0 + i, b_slot = b == first ? first_slot : 0;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int vj = v0 + j * DEC_CONSUMERS * WARP, second = vj >= n_vec;
              const float4* pb = reinterpret_cast<const float4*>(
                  partial + ((static_cast<long>(b) * 2 + b_slot) * 2 + h0 + second) * M * 128);
              v[i][j] = b <= last && vj < total ? __ldcg(pb + (vj - second * n_vec))
                                                : make_float4(0.f, 0.f, 0.f, 0.f);
            }
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)  // in block order
#pragma unroll
            for (int j = 0; j < 4; ++j)
              sum[j].x += v[i][j].x, sum[j].y += v[i][j].y, sum[j].z += v[i][j].z, sum[j].w += v[i][j].w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int vj = v0 + j * DEC_CONSUMERS * WARP, second = vj >= n_vec, idx = vj - second * n_vec;
          const int m = idx >> 5, n = slab * DEC_SLAB + (h0 + second) * 128 + 4 * (idx & 31);
          if (vj >= total || n >= N) continue;
          float4 s = sum[j];
          if (col_scale != nullptr) s.x *= col_scale[n], s.y *= col_scale[n + 1], s.z *= col_scale[n + 2],
                                     s.w *= col_scale[n + 3];
          __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + static_cast<long>(m) * N + n);
          o[0] = __floats2bfloat162_rn(s.x, s.y);
          o[1] = __floats2bfloat162_rn(s.z, s.w);
        }
      }
    }
    u = seg_end;
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
  const uint32_t raw_base = hopper::smem_u32(pf_smem_raw);
  unsigned char* smem = pf_smem_raw + (((raw_base + 1023) & ~1023u) - raw_base);
  const uint32_t base = hopper::smem_u32(smem);
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
        hopper::cp_async16(stage + r * PF_ROW_BYTES + ((c ^ (r % 8)) * 16), src, ok);
      }
#pragma unroll
      for (int v = 0; v < RAW_ROWS * 8 / PF_THREADS; ++v) {
        const int e = tid + v * PF_THREADS, r = e / 8, j = e % 8;
        const bool ok = n0 + 16 * j < N;
        const uint8_t* src = ok ? data + static_cast<long>(kb * RAW_ROWS + r) * N + n0 + 16 * j : data;
        hopper::cp_async16(stage + S::X_BYTES + r * PF_BN + ((j ^ ((r / RAW_GROUP) % 8)) * 16), src, ok);
      }
      if (F != INT8 && tid < PF_BN / 8) {
        const bool ok = n0 + 8 * tid < N;
        const __nv_bfloat16* s_src = static_cast<const __nv_bfloat16*>(scales) + static_cast<long>(kb) * N + n0;
        hopper::cp_async16(stage + S::X_BYTES + S::RAW_BYTES + tid * 16, ok ? s_src + 8 * tid : s_src, ok);
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
          o[j][i] = hopper::pack_bf16(static_cast<float>(static_cast<int8_t>(w[2 * i] >> (8 * j))),
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
          o[j][i] = hopper::pack_bf16(level4<F>(lo, low_byte_sel(j), lut) * sc[j],
                                      level4<F>(hi, low_byte_sel(j), lut) * sc[j]);
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
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < QBLOCK / 16; ++k)
        wgmma_m64n128k16(acc[t], hopper::desc_k_major(xa + t * 64 * PF_ROW_BYTES + 32 * k),
                         hopper::desc_k_major(bb + 32 * k));
    }
    hopper::wgmma_commit();
#pragma unroll
    for (int t = 0; t < MW; ++t) hopper::fence_regs(acc[t]);
    // while the tensor cores run: the next step's weight tile
    if (s + 1 < n_steps) decode_step(s + 1);
    // steps <= s + 2 landed (the next step's x, the one after's bytes)
    asm volatile("cp.async.wait_group %0;\n" ::"n"(PF_STAGES - 3) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    hopper::wgmma_wait0();
#pragma unroll
    for (int t = 0; t < MW; ++t) hopper::fence_regs(acc[t]);
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

using hopper::allow_smem;
using hopper::encode_tiled;
using hopper::EncodeTiled;
using hopper::kMaxDevices;

// A row-major [rows, inner] tensor of `elem_bytes`-byte elements read in
// boxes of [box_rows, 128 bytes] in the 128-byte swizzle; out-of-range box
// elements arrive as zeros
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* base, long inner, long rows,
               int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner * elem_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem_bytes), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t element_strides[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, element_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int F, int NT>
int launch_decode(const void* x, const void* data, const void* scales, void* out, void* partial, void* tickets, int M,
                  int K, int N, int ctas, int stages, cudaStream_t stream) {
  using S = DecodeSmem<F, NT>;
  static int configured[kMaxDevices] = {};
  CUtensorMap data_map, x_map;
  if (!encode_2d(&data_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, data, N, static_cast<long>(K / QBLOCK) * S::RAW_ROWS,
                 S::RAW_ROWS) ||
      !encode_2d(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K, M, M))
    return static_cast<int>(cudaErrorNotSupported);
  const int smem = S::bytes(stages);
  cudaError_t err = allow_smem(quant_decode_ring_kernel<F, NT>, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  quant_decode_ring_kernel<F, NT><<<ctas, DEC_THREADS, smem, stream>>>(
      data_map, x_map, scales, static_cast<__nv_bfloat16*>(out), static_cast<float*>(partial),
      static_cast<unsigned*>(tickets), M, K, N, stages);
  return static_cast<int>(cudaGetLastError());
}

template <int F, int MW>
int launch_prefill(const void* x, const void* data, const void* scales, void* out, void* partial, int M, int K,
                   int N, int k_splits, int kb_per_split, cudaStream_t stream) {
  static int configured[kMaxDevices] = {};
  cudaError_t err = allow_smem(quant_prefill_kernel<F, MW>, PrefillSmem<F, MW>::BYTES, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
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

// out [M, N] bf16 = x [M, K] bf16 @ dequant(w), M <= 32, in one launch of
// `ctas` blocks (at most one per (256-column slab, scale block) unit) with
// two rings of `stages` stages (2 to 4). `partial` is float32 scratch of [ctas, 2, 2, M,
// 128]; `tickets` [2 * ceil(N / 256)] uint32 zeros that the kernel leaves at
// zero.
int ptt_quant_matmul_decode(int format, const void* x, const void* data, const void* scales, void* out,
                            void* partial, void* tickets, int M, int K, int N, int ctas, int stages, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long units = static_cast<long>((N + DEC_SLAB - 1) / DEC_SLAB) * (K / QBLOCK);
  if (M < 1 || M > 32 || K < QBLOCK || K % QBLOCK || N < 16 || N % 16 || ctas < 1 || ctas > units || stages < 2 ||
      stages > 4 || partial == nullptr || tickets == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
#define PTT_DECODE(F)                                                                                \
  switch ((M + 7) / 8) {                                                                             \
    case 1: return launch_decode<F, 1>(x, data, scales, out, partial, tickets, M, K, N, ctas, stages, s); \
    case 2: return launch_decode<F, 2>(x, data, scales, out, partial, tickets, M, K, N, ctas, stages, s); \
    case 3: return launch_decode<F, 3>(x, data, scales, out, partial, tickets, M, K, N, ctas, stages, s); \
    default: return launch_decode<F, 4>(x, data, scales, out, partial, tickets, M, K, N, ctas, stages, s); \
  }
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
