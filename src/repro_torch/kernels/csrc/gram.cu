// Gram matrix G = X X^T of M flattened gradients, for NVIDIA Hopper
// (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gram.py:gram_pallas
// (_gram_kernel).  X is (M, d), row-major, f32 or bf16 (read as f32), with
// 1 <= M <= 8 (the Pallas kernel's M_PAD); G is (M, M) f32.  The Pallas
// kernel pads M to 8 and carries one (8, 8) block across a sequential grid
// over tiles of d.  Blocks of a CUDA grid run in parallel and in no order,
// so the sum over d takes two passes instead:
//
//   1. gram_partial_kernel: n_blocks blocks walk d in a grid-stride loop of
//      16-byte loads (4 f32 or 8 bf16 per thread and row) and keep the
//      M(M+1)/2 upper-triangle products in f32 registers; each block reduces
//      them (warp shuffles, then one shared array) into its row of a
//      (n_blocks, M(M+1)/2) partials buffer that the wrapper allocates.
//   2. gram_finish_kernel: one block; thread p sums column p of the
//      partials over the blocks in a fixed order and writes G[i][j] and
//      G[j][i].
//
// No float atomics: every sum runs in an order fixed by the launch shape,
// so G is the same bits from run to run.  Rows whose width or alignment
// does not allow 16-byte loads take a scalar loop over the same grid.
//
// What bounds it on the H100: memory bandwidth.  It reads M*d elements once
// and does M(M+1)/2 FMAs per column; at the FIRM local step's shape
// (M = 2, d = 3,407,872 f32 LoRA gradients) that is 27.3 MB, 8.1 us at
// 3.35 TB/s, against 20 MFLOP of arithmetic.  The wrapper launches
// n_blocks = 2 x 132 blocks of 256 threads: two on every SM of an H100.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxM = 8;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Products of column values v[0..M) into the packed upper triangle.
template <int M>
__device__ __forceinline__ void accumulate(const float (&v)[M],
                                           float (&acc)[M * (M + 1) / 2]) {
  int p = 0;
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = i; j < M; ++j) acc[p++] += v[i] * v[j];
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
    gram_partial_kernel(const T* __restrict__ x, float* __restrict__ partials,
                        long long d, bool vec) {
  constexpr int P = M * (M + 1) / 2;
  constexpr int V = 16 / sizeof(T);
  __shared__ float red[kThreads / 32][P];
  float acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0.f;

  const long long tid = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  if (vec) {
    const long long nv = d / V;
    for (long long c = tid; c < nv; c += stride) {
      uint4 raw[M];
#pragma unroll
      for (int i = 0; i < M; ++i)
        raw[i] = reinterpret_cast<const uint4*>(x + i * d)[c];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float v[M];
#pragma unroll
        for (int i = 0; i < M; ++i)
          v[i] = to_f(reinterpret_cast<const T*>(&raw[i])[e]);
        accumulate<M>(v, acc);
      }
    }
  } else {
    for (long long c = tid; c < d; c += stride) {
      float v[M];
#pragma unroll
      for (int i = 0; i < M; ++i) v[i] = to_f(x[i * d + c]);
      accumulate<M>(v, acc);
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float s = acc[p];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) red[warp][p] = s;
  }
  __syncthreads();
  if (threadIdx.x < P) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += red[w][threadIdx.x];
    partials[static_cast<size_t>(blockIdx.x) * P + threadIdx.x] = s;
  }
}

template <int M>
__global__ void gram_finish_kernel(const float* __restrict__ partials,
                                   float* __restrict__ g, int n_blocks) {
  constexpr int P = M * (M + 1) / 2;
  const int p = threadIdx.x;
  if (p >= P) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partials[b * P + p];
  // packed upper-triangle index p -> (i, j), i <= j
  int i = 0, row_start = 0;
  while (p >= row_start + (M - i)) {
    row_start += M - i;
    ++i;
  }
  const int j = i + (p - row_start);
  g[i * M + j] = s;
  g[j * M + i] = s;
}

template <typename T, int M>
void launch(const void* x, float* partials, float* g, long long d,
            int n_blocks, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec =
      (reinterpret_cast<uintptr_t>(x) & 15) == 0 && d % V == 0;
  gram_partial_kernel<T, M><<<n_blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), partials, d, vec);
  gram_finish_kernel<M><<<1, 64, 0, stream>>>(partials, g, n_blocks);
}

template <typename T>
int dispatch_m(const void* x, float* partials, float* g, int m, long long d,
               int nb, cudaStream_t s) {
  switch (m) {
    case 1: launch<T, 1>(x, partials, g, d, nb, s); break;
    case 2: launch<T, 2>(x, partials, g, d, nb, s); break;
    case 3: launch<T, 3>(x, partials, g, d, nb, s); break;
    case 4: launch<T, 4>(x, partials, g, d, nb, s); break;
    case 5: launch<T, 5>(x, partials, g, d, nb, s); break;
    case 6: launch<T, 6>(x, partials, g, d, nb, s); break;
    case 7: launch<T, 7>(x, partials, g, d, nb, s); break;
    case 8: launch<T, 8>(x, partials, g, d, nb, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (m, d) contiguous; partials: scratch of n_blocks * m * (m + 1) / 2
// f32; g: (m, m) f32.  dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int firm_gram(const void* x, void* partials, void* g, int m,
                         int d, int n_blocks, int dtype, void* stream) {
  if (m < 1 || m > kMaxM || d <= 0 || n_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(partials);
  float* gp = static_cast<float*>(g);
  if (dtype == 0) return dispatch_m<float>(x, pp, gp, m, d, n_blocks, s);
  if (dtype == 1)
    return dispatch_m<__nv_bfloat16>(x, pp, gp, m, d, n_blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
