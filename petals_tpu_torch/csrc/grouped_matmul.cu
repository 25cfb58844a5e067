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
// alone (ceil(n / BM) + E row tiles cover every expert's ragged tiles: a
// group adds at most one partial tile), and each block finds its (expert,
// row tile) by walking the sizes. So one launch, and the CUDA graph of a
// mixed step that captures it, serves any routing; blocks past the last
// expert's tiles return at once. Rows past a group's end are zero-filled
// in shared memory and never stored.
//
// What bounds it on this card. At a 512-row prefill chunk of Mixtral-8x7B
// (1024 assignments, top-2, over 8 experts of [4096, 14336]) a projection
// does 120 GFLOP over the ~0.9 GB of its experts' weights, ~130 operations
// a byte: under the bf16 ridge (~295), so the bound is the weight bytes,
// ~0.25 ms a projection. This first kernel is the simple one: CUDA-core
// float32 FMAs from register tiles (a 64 x 128 tile a block, 4 x 8 outputs
// a thread), K in steps of 32 staged through shared memory as float32, so it
// is bound by the CUDA cores' rate (67 TFLOP/s float32 at best), several
// times the byte bound. The lever is wgmma on bf16 tiles with a TMA ring
// (PERF.md, ROADMAP Queue B).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // rows of a tile (one expert's)
constexpr int BN = 128;       // output columns of a tile
constexpr int BK = 32;        // K per shared-memory stage
constexpr int THREADS = 256;  // thread (ty, tx) = (tid / 16, tid % 16)

// 16 bytes of T as floats: 8 bf16 or 4 float32; a false `valid` reads nothing
template <typename T>
struct Vec16 {
  static constexpr int N = 16 / (int)sizeof(T);
};

__device__ __forceinline__ void load16(const float* p, bool valid, float (&v)[4]) {
  const float4 w = valid ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
  v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, bool valid, float (&v)[8]) {
  const uint4 w = valid ? *reinterpret_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
  const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(words[i] << 16);
    v[2 * i + 1] = __uint_as_float(words[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS) grouped_matmul_kernel(
    const T* __restrict__ x,                // [n, K], grouped by expert
    const T* __restrict__ w,                // [E, K, N]
    const int* __restrict__ group_sizes,    // [E] on the card
    T* __restrict__ out,                    // [n, N]
    int n_rows, int K, int N, int n_experts) {
  constexpr int V = Vec16<T>::N;
  // this block's (expert, row tile): the walk is the same in every thread
  int t = blockIdx.y, e = 0, start = 0, rows = 0;
  for (; e < n_experts; ++e) {
    const int size = max(group_sizes[e], 0);
    const int tiles = (size + BM - 1) / BM;
    if (t < tiles) {
      start += t * BM;
      rows = min(BM, size - t * BM);
      break;
    }
    t -= tiles;
    start += size;
  }
  rows = min(rows, n_rows - start);  // a size past n reads and writes nothing outside x and out
  if (e == n_experts || rows <= 0) return;
  const int col0 = blockIdx.x * BN;

  __shared__ __align__(16) float a_s[BK][BM + 4];  // x's tile transposed: a_s[k][row]
  __shared__ __align__(16) float b_s[BK][BN + 4];  // w's tile: b_s[k][col]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* xe = x + (long)start * K;
  const T* we = w + (long)e * K * N;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // K and N are multiples of V: a vector is wholly in range or wholly out
    for (int i = tid; i < BM * (BK / V); i += THREADS) {
      const int r = i / (BK / V), c = (i % (BK / V)) * V;
      float v[V];
      load16(xe + (long)r * K + k0 + c, r < rows && k0 + c < K, v);
#pragma unroll
      for (int j = 0; j < V; ++j) a_s[c + j][r] = v[j];
    }
    for (int i = tid; i < BK * (BN / V); i += THREADS) {
      const int r = i / (BN / V), c = (i % (BN / V)) * V;
      float v[V];
      load16(we + (long)(k0 + r) * N + col0 + c, k0 + r < K && col0 + c < N, v);
#pragma unroll
      for (int j = 0; j < V; ++j) b_s[r][c + j] = v[j];
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
    T* o = out + (long)(start + r) * N + col0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = (j < 4 ? 4 * tx : 64 + 4 * tx) + (j % 4);
      if (col0 + col < N) store(o + col, acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const int* group_sizes, void* out, int n_rows, int K, int N,
           int n_experts, cudaStream_t stream) {
  constexpr int V = Vec16<T>::N;
  if (n_rows < 1 || K < 1 || N < 1 || n_experts < 1 || K % V || N % V) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (n_rows + BM - 1) / BM + n_experts);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  grouped_matmul_kernel<T><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                                         group_sizes, static_cast<T*>(out), n_rows, K, N,
                                                         n_experts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes (x, w and out share one type): 0 = float32, 1 = bfloat16.
// group_sizes points to E int32s on the card, read by the kernel. The
// wrapper in petals_tpu_torch/ops/grouped_matmul.py validates every argument
// it holds on the host; K and N must be multiples of 16 bytes' elements.
int ptt_grouped_matmul(const void* x, const void* w, const void* group_sizes, void* out, int dtype, int n_rows,
                       int K, int N, int n_experts, void* stream) {
  const int* gs = static_cast<const int*>(group_sizes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, gs, out, n_rows, K, N, n_experts, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, gs, out, n_rows, K, N, n_experts, s);
  return (int)cudaErrorInvalidValue;
}

const char* ptt_grouped_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
