// RMSNorm forward and its input gradient for NVIDIA Hopper (sm_90a), with
// a plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py:rmsnorm
// (_rmsnorm_kernel).  It computes, for every row of x (rows, d):
//
//   y = round_T(round_T(x * rsqrt(mean(x^2) + eps)) * g)
//
// with the sum of squares in f32.  This is the rounding order of
// repro.kernels.ref.rmsnorm: normalise in f32, round to the input type,
// then scale by g and round again.  A bf16 x bf16 product is exact in f32,
// so against the plain PyTorch version the only differences are the order
// of the f32 reduction and rsqrtf.  In bf16 they can flip the first
// rounding by 1 ulp; scaled by g, that flip spans less than 2 ulps of the
// product, so the output is within 2 bf16 ulps (1 ulp when g = 1).  In f32
// the output is within 1e-5 relative.
//
// What bounds it on the H100: memory bandwidth.  Each element is read once
// and written once with a handful of flops in between; at the rollout's
// sequence shape (4096 x 2048 bf16) the kernel moves 33.5 MB, about 10 us
// at 3.35 TB/s, against well under 1 us of arithmetic.
//
// What the design does about it: one block per row, 16-byte vectorised
// loads and stores (8 bf16 or 4 f32 a thread) on neighbouring addresses,
// and the row's sum of squares reduced with warp shuffles and one shared
// array of 32 floats.  The second pass re-reads the row, which is still in
// L1/L2, so device memory sees each byte once.  Any row count is taken,
// including a ragged or tiny one (decode calls it with rows = batch); rows
// whose width or alignment does not allow 16-byte accesses take a scalar
// loop instead.
//
// The backward (firm_rmsnorm_bwd) computes dx given x, g and dy; it is the
// gradient of the forward above, which the JAX package never needed (its
// Pallas kernel is forward-only and JAX differentiates the XLA twin).  g is
// frozen on the LoRA path, so no dg is computed.  Per row, in f32:
//
//   r  = rsqrt(mean(x^2) + eps),  n = x * r
//   dn = float(round_T(dy * g))                 (the product autograd forms)
//   dx = round_T(r * (dn - n * mean(dn * n)))
//
// The first pass reduces sum(x^2) and sum(dn * x) together; mean(dn * n)
// is then r * sum(dn * x) / d.  The second pass re-reads x, dy and g (from
// L1/L2) and writes dx.  Bound: bytes again.  At the local step's shape
// (4096 x 2048 bf16) it reads x and dy and writes dx, 50.3 MB, 15.0 us at
// 3.35 TB/s.  The design is the forward's: one block per row, 16-byte
// vectors, a scalar loop where the width or alignment does not allow them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Sum over the block; every thread receives the total.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
  v = lane < n_warps ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ T scale_elem(float xv, float inv, T gv) {
  // round to T after normalising, then again after the scale by g
  return from_f<T>(to_f(from_f<T>(xv * inv)) * to_f(gv));
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   T* __restrict__ y, int d, float eps, bool vec) {
  __shared__ float red[32];
  constexpr int V = 16 / sizeof(T);
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;

  float ss = 0.f;
  if (vec) {
    for (int i = threadIdx.x; i < d / V; i += blockDim.x) {
      const uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_f(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float f = to_f(xr[i]);
      ss += f * f;
    }
  }
  ss = block_sum(ss, red);
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);

  if (vec) {
    for (int i = threadIdx.x; i < d / V; i += blockDim.x) {
      const uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      const uint4 graw = reinterpret_cast<const uint4*>(g)[i];
      const T* e = reinterpret_cast<const T*>(&raw);
      const T* ge = reinterpret_cast<const T*>(&graw);
      uint4 out;
      T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j) oe[j] = scale_elem<T>(to_f(e[j]), inv, ge[j]);
      reinterpret_cast<uint4*>(yr)[i] = out;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      yr[i] = scale_elem<T>(to_f(xr[i]), inv, g[i]);
  }
}

template <typename T>
void launch(const void* x, const void* g, void* y, int rows, int d, float eps,
            cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const bool vec = aligned && d % V == 0;
  const int work = vec ? d / V : d;
  int threads = (work + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  rmsnorm_kernel<T><<<rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(y),
      d, eps, vec);
}

// dn = float(round_T(dy * g)): the rounding of autograd's product
template <typename T>
__device__ __forceinline__ float dn_elem(T dyv, T gv) {
  return to_f(from_f<T>(to_f(dyv) * to_f(gv)));
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       const T* __restrict__ dy, T* __restrict__ dx, int d,
                       float eps, bool vec) {
  __shared__ float red[32];
  constexpr int V = 16 / sizeof(T);
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  const T* dyr = dy + row * d;
  T* dxr = dx + row * d;

  float ss = 0.f, dot = 0.f;
  if (vec) {
    for (int i = threadIdx.x; i < d / V; i += blockDim.x) {
      const uint4 xraw = reinterpret_cast<const uint4*>(xr)[i];
      const uint4 draw = reinterpret_cast<const uint4*>(dyr)[i];
      const uint4 graw = reinterpret_cast<const uint4*>(g)[i];
      const T* xe = reinterpret_cast<const T*>(&xraw);
      const T* de = reinterpret_cast<const T*>(&draw);
      const T* ge = reinterpret_cast<const T*>(&graw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_f(xe[j]);
        ss += f * f;
        dot += dn_elem<T>(de[j], ge[j]) * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float f = to_f(xr[i]);
      ss += f * f;
      dot += dn_elem<T>(dyr[i], g[i]) * f;
    }
  }
  ss = block_sum(ss, red);
  __syncthreads();  // red is reused by the second sum
  dot = block_sum(dot, red);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  const float c = r * dot / static_cast<float>(d);  // mean(dn * n)

  if (vec) {
    for (int i = threadIdx.x; i < d / V; i += blockDim.x) {
      const uint4 xraw = reinterpret_cast<const uint4*>(xr)[i];
      const uint4 draw = reinterpret_cast<const uint4*>(dyr)[i];
      const uint4 graw = reinterpret_cast<const uint4*>(g)[i];
      const T* xe = reinterpret_cast<const T*>(&xraw);
      const T* de = reinterpret_cast<const T*>(&draw);
      const T* ge = reinterpret_cast<const T*>(&graw);
      uint4 out;
      T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float n = to_f(xe[j]) * r;
        oe[j] = from_f<T>(r * (dn_elem<T>(de[j], ge[j]) - n * c));
      }
      reinterpret_cast<uint4*>(dxr)[i] = out;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float n = to_f(xr[i]) * r;
      dxr[i] = from_f<T>(r * (dn_elem<T>(dyr[i], g[i]) - n * c));
    }
  }
}

template <typename T>
void launch_bwd(const void* x, const void* g, const void* dy, void* dx,
                int rows, int d, float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(dy) |
                         reinterpret_cast<uintptr_t>(dx)) & 15) == 0;
  const bool vec = aligned && d % V == 0;
  const int work = vec ? d / V : d;
  int threads = (work + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  rmsnorm_bwd_kernel<T><<<rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(dy), static_cast<T*>(dx), d, eps, vec);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int firm_rmsnorm(const void* x, const void* g, void* y, int rows,
                            int d, float eps, int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(x, g, y, rows, d, eps, s);
  else if (dtype == 1)
    launch<__nv_bfloat16>(x, g, y, rows, d, eps, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// dx of firm_rmsnorm given dy; x, g, dy, dx of one dtype (0 = float32,
// 1 = bfloat16).  Returns cudaGetLastError() after the launch.
extern "C" int firm_rmsnorm_bwd(const void* x, const void* g, const void* dy,
                                void* dx, int rows, int d, float eps,
                                int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_bwd<float>(x, g, dy, dx, rows, d, eps, s);
  else if (dtype == 1)
    launch_bwd<__nv_bfloat16>(x, g, dy, dx, rows, d, eps, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
