// The grouped matrix product of Mixtral's sparse experts (K7) for Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces no TPU kernel: it is the counterpart of jax.lax.ragged_dot in
// petals_tpu/models/mixtral/block.py _moe_sparse, which XLA lowers itself.
// out[r] = x[r] @ w[e] for the expert e whose group holds row r: x [n, K]
// holds the assignment rows sorted by expert, group e's group_sizes[e] rows
// after group e - 1's; w is [E, K, N] (each expert's weight [in, out], as the
// blocks keep it). float32 sums, one rounding to the output type (bf16 or
// float32, that of x). Same contract as the plain PyTorch version beside the
// wrapper (petals_tpu_torch/ops/grouped_matmul.py grouped_matmul_reference).
//
// The group sizes are read on the card: the grid depends on n, N and E
// alone. blockIdx.x runs over ceil(n / BM) + E row-tile slots (a group adds
// at most one partial tile), blockIdx.y over column tiles, and each block
// finds its (expert, start, rows) by walking the sizes (tile_slot; on the
// host, ops/grouped_matmul.py grouped_tiles is the same walk, and the CPU
// tests hold it). So one launch, and the CUDA graph of a mixed step that
// captures it, serves any routing; blocks past the last expert's tiles
// return at once. Rows past a group's end are multiplied (the next group's
// rows, or zeros past n) and never stored.
//
// Two arms, chosen by the wrapper from x's dtype (grouped_matmul.py
// kernel_arm):
//   - bfloat16, grouped_matmul_wgmma_kernel: every served Mixtral prefill
//     chunk. Tensor cores, float32 sums in registers.
//   - float32, grouped_matmul_kernel: references and float32 drafts. CUDA-
//     core float32 FMAs; TF32 is not float32, as for K2 and K4's float32
//     kernels.
//
// What bounds the bf16 arm on this card. At a 512-row prefill chunk of
// Mixtral-8x7B (1024 assignments, top-2, over 8 experts of [4096, 14336])
// a projection does 120 GFLOP over the ~0.9 GB of its experts' weights,
// ~130 operations a byte: under the bf16 ridge (~295), so the bound is the
// weight bytes, ~0.25 ms a projection. What the design does about it:
//   - the block order puts the row tiles fastest: the blocks that share one
//     expert's column slice (its row tiles) are resident together, so each
//     weight byte comes from HBM about once and the tiles after the first
//     read it from L2 (the float32 arm's first order, column tiles fastest,
//     streamed an expert's slice from HBM once per row tile: 18 times
//     117 MB at the smoke's routing);
//   - a block is a 128-row tile of one expert's rows by TN columns: two
//     consumer warpgroups of 64 rows share each weight tile, so the bytes a
//     block reads from L2 per operation are half those of a 64-row tile; a
//     warpgroup whose 64 rows lie past the group's end issues no product;
//   - a producer warp keeps a ring of STAGES tiles in flight with TMA
//     (cp.async.bulk.tensor on mbarriers: x's [128 x 64] box K-major, w's
//     [64 x 64] boxes MN-major, both in the 128-byte swizzle wgmma reads),
//     and gives its registers to the consumers (setmaxnreg); the consumers
//     run wgmma m64nTNk16 from shared memory (B transposed: w keeps its
//     [E, in, out] layout) and release a stage once its products are done.
//   - the tensor maps are __grid_constant__ kernel parameters, so a
//     captured launch keeps them and nothing is copied to the card at
//     launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

namespace {

using hopper::ATOM_BYTES;
using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;

// ---------------------------------------------------------------- the tile walk

struct Slot {
  int expert, start, rows;
};

// Row-tile slot `slot` of the grid: expert e's ceil(size_e / bm) tiles of
// bm rows in order (the last one ragged), expert after expert; a slot past
// the last expert's tiles has no rows. ops/grouped_matmul.py grouped_tiles
// is this walk on the host.
__device__ __forceinline__ Slot tile_slot(const int* __restrict__ group_sizes, int n_experts, int slot, int bm,
                                          int n_rows) {
  int start = 0;
  for (int e = 0; e < n_experts; ++e) {
    const int size = max(group_sizes[e], 0);
    const int tiles = (size + bm - 1) / bm;
    if (slot < tiles) {
      start += slot * bm;
      // a size past n reads and writes nothing outside x and out
      return {e, start, min(min(bm, size - slot * bm), n_rows - start)};
    }
    slot -= tiles;
    start += size;
  }
  return {n_experts, start, 0};
}

// ---------------------------------------------------------------- the float32 arm (CUDA cores)

constexpr int BM = 64;        // rows of a tile (one expert's)
constexpr int BN = 128;       // output columns of a tile
constexpr int BK = 32;        // K per shared-memory stage
constexpr int THREADS = 256;  // thread (ty, tx) = (tid / 16, tid % 16)

__device__ __forceinline__ void load16(const float* p, bool valid, float (&v)[4]) {
  const float4 w = valid ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
  v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
}

__global__ void __launch_bounds__(THREADS) grouped_matmul_kernel(
    const float* __restrict__ x,            // [n, K], grouped by expert
    const float* __restrict__ w,            // [E, K, N]
    const int* __restrict__ group_sizes,    // [E] on the card
    float* __restrict__ out,                // [n, N]
    int n_rows, int K, int N, int n_experts) {
  const Slot t = tile_slot(group_sizes, n_experts, blockIdx.x, BM, n_rows);
  if (t.rows <= 0) return;
  const int col0 = blockIdx.y * BN, start = t.start, rows = t.rows;

  __shared__ __align__(16) float a_s[BK][BM + 4];  // x's tile transposed: a_s[k][row]
  __shared__ __align__(16) float b_s[BK][BN + 4];  // w's tile: b_s[k][col]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float* xe = x + (long)start * K;
  const float* we = w + (long)t.expert * K * N;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // K and N are multiples of 4: a vector is wholly in range or wholly out
    for (int i = tid; i < BM * (BK / 4); i += THREADS) {
      const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
      float v[4];
      load16(xe + (long)r * K + k0 + c, r < rows && k0 + c < K, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) a_s[c + j][r] = v[j];
    }
    for (int i = tid; i < BK * (BN / 4); i += THREADS) {
      const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
      float v[4];
      load16(we + (long)(k0 + r) * N + col0 + c, k0 + r < K && col0 + c < N, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) b_s[r][c + j] = v[j];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[kk][ty + 16 * i];
      const float4 b0 = *reinterpret_cast<const float4*>(&b_s[kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&b_s[kk][64 + 4 * tx]);
      b[0] = b0.x, b[1] = b0.y, b[2] = b0.z, b[3] = b0.w;
      b[4] = b1.x, b[5] = b1.y, b[6] = b1.z, b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

  // thread (ty, tx): rows ty + 16 i, columns 4 tx + {0..3} and 64 + 4 tx + {0..3}
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    float* o = out + (long)(start + r) * N + col0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = (j < 4 ? 4 * tx : 64 + 4 * tx) + (j % 4);
      if (col0 + col < N) o[col] = acc[i][j];
    }
  }
}

int launch_fp32(const void* x, const void* w, const int* group_sizes, void* out, int n_rows, int K, int N,
                int n_experts, cudaStream_t stream) {
  if (K % 4 || N % 4) return (int)cudaErrorInvalidValue;
  const dim3 grid((n_rows + BM - 1) / BM + n_experts, (N + BN - 1) / BN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  grouped_matmul_kernel<<<grid, THREADS, 0, stream>>>(static_cast<const float*>(x), static_cast<const float*>(w),
                                                      group_sizes, static_cast<float*>(out), n_rows, K, N,
                                                      n_experts);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- the bf16 arm (wgmma, TMA ring)

constexpr int RING_BM = 128;       // rows of a block's tile: two consumer warpgroups of 64
constexpr int RING_BK = 64;        // K per stage: one 128-byte swizzled row of bf16
constexpr int RING_THREADS = 384;  // warpgroup 0 the producer, 1 and 2 the consumers
// Columns of a block's tile and stages of its ring. At Mixtral-8x7B's w1 and
// w2, 256-column tiles were 4-12% faster than 128-column ones, and 3 or 4
// stages alike (scripts/ablate_grouped_matmul.py times other values by
// rewriting these two lines in copies of this file).
constexpr int TN = 256;
constexpr int STAGES = 4;
constexpr int A_BYTES = RING_BM * RING_BK * 2;  // x's [128 rows x 64 K], K-major, swizzled
constexpr int B_BYTES = RING_BK * TN * 2;       // w's [64 K x TN]: TN / 64 MN-major atoms
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;  // a multiple of 1024: every tile stays aligned
constexpr int RING_BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;  // + alignment, full/empty barriers

__global__ void __launch_bounds__(RING_THREADS, 1) grouped_matmul_wgmma_kernel(
    const __grid_constant__ CUtensorMap x_map,  // x [n, K] bf16: boxes of [128 rows, 64 K]
    const __grid_constant__ CUtensorMap w_map,  // w [E, K, N] bf16: boxes of [1, 64 K, 64 N]
    const int* __restrict__ group_sizes, __nv_bfloat16* __restrict__ out, int n_rows, int K, int N,
    int n_experts) {
  const Slot t = tile_slot(group_sizes, n_experts, blockIdx.x, RING_BM, n_rows);
  if (t.rows <= 0) return;  // every thread walks alike: the whole block leaves
  extern __shared__ unsigned char ring_smem_raw[];
  const uint32_t raw_base = smem_u32(ring_smem_raw);
  const uint32_t base = (raw_base + 1023) & ~1023u;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_smem_raw + (base - raw_base) + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x / 128, consumers = t.rows > 64 ? 2 : 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(full + s), 1);                 // the producer's arrival and the stage's bytes
      mbar_init(smem_u32(empty + s), 4 * consumers);    // lane 0 of each live consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int k_steps = (K + RING_BK - 1) / RING_BK, col0 = blockIdx.y * TN;

  if (wg == 0) {  // the producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int i = 0; i < k_steps; ++i) {
        mbar_wait(smem_u32(empty + s), phase ^ 1);
        const uint32_t bar = smem_u32(full + s), st = base + s * STAGE_BYTES;
        // boxes past n, K or N arrive as zeros and count in full
        mbar_expect_tx(bar, STAGE_BYTES);
        hopper::tma_load_2d(st, &x_map, i * RING_BK, t.start, bar);
#pragma unroll
        for (int j = 0; j < TN / 64; ++j)
          hopper::tma_load_3d(st + A_BYTES + j * ATOM_BYTES, &w_map, col0 + 64 * j, i * RING_BK, t.expert, bar);
        if (++s == STAGES) s = 0, phase ^= 1;
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = wg - 1;  // this warpgroup's rows: 64 c .. 64 c + 63 of the tile
  if (c >= consumers) return;
  float acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
  const uint32_t a_off = c * 64 * 128;
  const bool releases = threadIdx.x % 32 == 0;
  int s = 0, prev = 0;
  uint32_t phase = 0;
  for (int i = 0; i < k_steps; ++i) {
    mbar_wait(smem_u32(full + s), phase);
    const uint32_t st = base + s * STAGE_BYTES;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < RING_BK / 16; ++kk)
      hopper::wgmma_m64n256k16_ss_tb(acc, hopper::desc_k_major(st + a_off + 32 * kk),
                                     hopper::desc_mn_major(st + A_BYTES + 2048 * kk), 1);
    hopper::wgmma_commit();
    fence_regs(acc);
    // the products of step i - 1 are done: its stage goes back to the producer
    hopper::wgmma_wait1();
    fence_regs(acc);
    if (i > 0 && releases) mbar_arrive(smem_u32(empty + prev));
    prev = s;
    if (++s == STAGES) s = 0, phase ^= 1;
  }
  hopper::wgmma_wait0();
  fence_regs(acc);

  // accumulator element i: tile row 64 c + 16 (warp in the group) + lane / 4
  // + 8 (bit 1 of i), column 8 (i / 4) + 2 (lane % 4) + (bit 0 of i); only
  // rows inside the group are stored
  const int lane = threadIdx.x % 32, r0 = 64 * c + 16 * ((threadIdx.x / 32) % 4) + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= t.rows) continue;
    __nv_bfloat16* o = out + (long)(t.start + r) * N + col0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < TN / 8; ++j)
      if (col0 + 8 * j < N)  // N is a multiple of 8: an 8-column group is wholly in or out
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// A bf16 tensor of `rank` dims (innermost first, row-major) read in boxes
// of `box` elements, the innermost 64 (128 bytes) in the 128-byte swizzle;
// out-of-range box elements arrive as zeros
bool encode_bf16(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims, const cuuint32_t* box) {
  const hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t strides[2];
  cuuint64_t stride = 2;
  for (int d = 0; d + 1 < rank; ++d) strides[d] = stride *= dims[d];
  const cuuint32_t element_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides, box,
            element_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_ring(const void* x, const void* w, const int* group_sizes, void* out, int n_rows, int K, int N,
                int n_experts, cudaStream_t stream) {
  static int configured[hopper::kMaxDevices] = {};
  if (K % 8 || N % 8) return (int)cudaErrorInvalidValue;  // TMA strides are multiples of 16 bytes
  const cuuint64_t x_dims[2] = {(cuuint64_t)K, (cuuint64_t)n_rows};
  const cuuint32_t x_box[2] = {RING_BK, RING_BM};
  const cuuint64_t w_dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)n_experts};
  const cuuint32_t w_box[3] = {64, RING_BK, 1};
  CUtensorMap x_map, w_map;
  if (!encode_bf16(&x_map, x, 2, x_dims, x_box) || !encode_bf16(&w_map, w, 3, w_dims, w_box))
    return (int)cudaErrorNotSupported;
  cudaError_t err = hopper::allow_smem(grouped_matmul_wgmma_kernel, RING_BYTES, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_rows + RING_BM - 1) / RING_BM + n_experts, (N + TN - 1) / TN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  grouped_matmul_wgmma_kernel<<<grid, RING_THREADS, RING_BYTES, stream>>>(
      x_map, w_map, group_sizes, static_cast<__nv_bfloat16*>(out), n_rows, K, N, n_experts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes (x, w and out share one type): 0 = float32 (the CUDA-core
// arm), 1 = bfloat16 (the wgmma arm). group_sizes points to E int32s on the
// card, read by the kernel. The wrapper validates every
// argument it holds on the host; K and N must be multiples of 16 bytes'
// elements.
int ptt_grouped_matmul(const void* x, const void* w, const void* group_sizes, void* out, int dtype, int n_rows,
                       int K, int N, int n_experts, void* stream) {
  const int* gs = static_cast<const int*>(group_sizes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows < 1 || K < 1 || N < 1 || n_experts < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_fp32(x, w, gs, out, n_rows, K, N, n_experts, s);
  if (dtype == 1) return launch_ring(x, w, gs, out, n_rows, K, N, n_experts, s);
  return (int)cudaErrorInvalidValue;
}

const char* ptt_grouped_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
