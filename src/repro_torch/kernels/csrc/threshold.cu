// The two magnitude-threshold passes of top-k selection, for NVIDIA Hopper
// (sm_90a), with a plain C interface.
//
// Replace the Pallas TPU kernels
// src/repro/kernels/quantize.py:abs_threshold_count (_count_kernel) and
// :abs_threshold_mask (_mask_kernel).  Both take a stack of C clients'
// (rows, 1024) f32 blocks and one threshold t per client, read from
// device memory:
//
//   count[c] = #{ i : |x[c, i]| >= t[c] }     (written as f32)
//   mask[c, i] = |x[c, i]| >= t[c] ? x[c, i] : +0.0
//
// The count is the inner loop of the top-k bisection (32 passes, each one
// launch over all C clients, as the reference's vmapped pallas_call is one
// batched call).  The Pallas kernel carries an f32 sum across a sequential
// grid; here blocks run in no order, so each block counts in integers,
// reduces over its warps, and adds its count to the client's total with
// an integer atomic, which is exact in any order.  The block that finishes
// last (a ticket counter, after a fence) rounds the total once to f32:
// the reference's f32 sum of ones, exact below 2^24.  scratch holds the
// totals and the tickets and must be zero at the launch.  NaN compares
// false and so is neither counted nor kept; -0.0 is kept when t <= 0, and
// a dropped entry is +0.0, as in the reference.  No denormal is flushed
// (the build passes no -ftz).
//
// What bounds them on the H100: memory bandwidth.  count reads 4 bytes an
// element and writes C floats; mask reads 4 and writes 4.  Each thread
// moves 16-byte vectors in a grid-stride loop over its client's vector
// (gridDim.y = C), with about eight blocks of 256 threads an SM in all.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;               // elements a row
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ unsigned int hits(float4 v, float t) {
  return static_cast<unsigned int>(fabsf(v.x) >= t) +
         static_cast<unsigned int>(fabsf(v.y) >= t) +
         static_cast<unsigned int>(fabsf(v.z) >= t) +
         static_cast<unsigned int>(fabsf(v.w) >= t);
}

__device__ __forceinline__ float keep(float v, float t) {
  return fabsf(v) >= t ? v : 0.f;
}

__global__ void __launch_bounds__(kThreads)
    count_kernel(const float4* __restrict__ x,
                 const float* __restrict__ thresh,
                 unsigned int* __restrict__ scratch,
                 float* __restrict__ out, long long n4, int clients) {
  __shared__ unsigned int red[kThreads / 32];
  const int c = blockIdx.y;
  const float t = thresh[c];
  const float4* xc = x + static_cast<size_t>(c) * n4;
  unsigned int cnt = 0;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n4; i += static_cast<long long>(gridDim.x) * kThreads)
    cnt += hits(xc[i], t);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += red[w];
    atomicAdd(&scratch[c], total);
    __threadfence();
    const unsigned int ticket = atomicAdd(&scratch[clients + c], 1u);
    if (ticket == gridDim.x - 1)
      out[c] = __uint2float_rn(atomicAdd(&scratch[c], 0u));
  }
}

__global__ void __launch_bounds__(kThreads)
    mask_kernel(const float4* __restrict__ x,
                const float* __restrict__ thresh, float4* __restrict__ out,
                long long n4) {
  const int c = blockIdx.y;
  const float t = thresh[c];
  const size_t base = static_cast<size_t>(c) * n4;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n4; i += static_cast<long long>(gridDim.x) * kThreads) {
    const float4 v = x[base + i];
    out[base + i] =
        make_float4(keep(v.x, t), keep(v.y, t), keep(v.z, t), keep(v.w, t));
  }
}

// Blocks a client: enough for one vector a thread, capped so that all
// clients together fill the SMs about kBlocksPerSm times.
int grid_x(long long n4, int clients) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms <= 0)
    sms = 132;
  long long cap = static_cast<long long>(sms) * kBlocksPerSm / clients;
  if (cap < 1) cap = 1;
  const long long want = (n4 + kThreads - 1) / kThreads;
  return static_cast<int>(want < cap ? want : cap);
}

bool bad_shape(int clients, int rows) {
  return clients <= 0 || clients > 65535 || rows <= 0;
}

}  // namespace

// x: (clients, rows, 1024) f32 with rows * 1024 below 2^32 (a uint32
// total); thresh: (clients,) f32; scratch: (2 * clients) uint32, all
// zero; out: (clients,) f32.  x 16-byte aligned, the others 4-byte.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int firm_abs_threshold_count(const void* x, const void* thresh,
                                        void* scratch, void* out,
                                        int clients, int rows,
                                        void* stream) {
  if (bad_shape(clients, rows) || rows >= (1 << 22))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = static_cast<long long>(rows) * (kBlock / 4);
  const dim3 grid(grid_x(n4, clients), clients);
  count_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const float*>(thresh),
      static_cast<unsigned int*>(scratch), static_cast<float*>(out), n4,
      clients);
  return static_cast<int>(cudaGetLastError());
}

// x and out: (clients, rows, 1024) f32, 16-byte aligned; thresh:
// (clients,) f32.  Returns cudaGetLastError() after the launch.
extern "C" int firm_abs_threshold_mask(const void* x, const void* thresh,
                                       void* out, int clients, int rows,
                                       void* stream) {
  if (bad_shape(clients, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = static_cast<long long>(rows) * (kBlock / 4);
  const dim3 grid(grid_x(n4, clients), clients);
  mask_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const float*>(thresh),
      static_cast<float4*>(out), n4);
  return static_cast<int>(cudaGetLastError());
}
