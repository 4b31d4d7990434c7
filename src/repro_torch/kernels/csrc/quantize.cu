// Blockwise symmetric quantization of the uplink, for NVIDIA Hopper
// (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernels src/repro/kernels/quantize.py:quantize
// (_quantize_kernel) and :dequantize (_dequantize_kernel).  A flat adapter
// delta is cut into rows of 1024 elements (one group each); per row
//
//   scale = absmax * (1/qmax)   (1.0 when the row is all zero)
//   r     = f32(bits) * 2^-32   (bits: uint32 rounding offsets)
//   q     = clip(floor(x / scale + r), -qmax, qmax)   -> int8
//
// and dequantize computes codes * scale in f32.  The codes must be the
// reference's bits given the same rounding bits, so every step rounds as
// XLA does: the Pallas kernel writes absmax / qmax, but XLA compiles a
// division by a constant as a multiply by its rounded reciprocal, so the
// scale is absmax * rn(1/qmax) (__frcp_rn, __fmul_rn), while x / scale is
// a correctly rounded division (__fdiv_rn); the uint32 -> f32 conversion
// rounds to nearest (__uint2float_rn, so bits >= 2^32 - 128 give r = 1.0
// exactly, as in JAX), and the addition is __fadd_rn, which the compiler
// may not contract.  The build passes no --use_fast_math.
//
// dequantize takes an optional error-feedback epilogue: given adj (the
// quantized input, residual included), it also writes
//
//   residual = fma(-code, scale, adj)
//
// rounded once.  That is what the reference computes: XLA contracts the
// dequantize multiply into the residual subtract adj - codes * scale of
// the jitted error-feedback roundtrip (src/repro/comms/codec.py), so
// adj - decoded rounded twice differs from it in most entries.
//
// What bounds them on the H100: memory bandwidth; both do a few operations
// per element.  quantize reads 4 bytes of x and 4 of bits and writes 1 of
// code per element; dequantize reads 1 (plus 4 of adj) and writes 4 (plus 4
// of residual).  One block of 256 threads per row: each thread moves one
// 16-byte vector of x and of bits (4 elements), the row's absmax is a warp
// shuffle then one shared array, and every store is one vector.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;              // elements per row (one scale)
constexpr int kThreads = kBlock / 4;      // one float4 per thread
constexpr float kInv2p32 = 2.3283064365386963e-10f;   // 2^-32, exact

__device__ __forceinline__ signed char quantize_one(float x, uint32_t b,
                                                    float scale,
                                                    float qmax) {
  const float r = __fmul_rn(__uint2float_rn(b), kInv2p32);
  float q = floorf(__fadd_rn(__fdiv_rn(x, scale), r));
  q = fminf(fmaxf(q, -qmax), qmax);
  return static_cast<signed char>(static_cast<int>(q));
}

__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const float* __restrict__ x,
                    const uint32_t* __restrict__ bits,
                    signed char* __restrict__ codes,
                    float* __restrict__ scales, float qmax) {
  __shared__ float red[kThreads / 32];
  const size_t row = blockIdx.x;
  const float4 v =
      reinterpret_cast<const float4*>(x + row * kBlock)[threadIdx.x];
  const uint4 b =
      reinterpret_cast<const uint4*>(bits + row * kBlock)[threadIdx.x];
  float m = fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                  fmaxf(fabsf(v.z), fabsf(v.w)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  float absmax = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) absmax = fmaxf(absmax, red[w]);
  const float scale =
      absmax > 0.f ? __fmul_rn(absmax, __frcp_rn(qmax)) : 1.f;
  if (threadIdx.x == 0) scales[row] = scale;
  char4 q;
  q.x = quantize_one(v.x, b.x, scale, qmax);
  q.y = quantize_one(v.y, b.y, scale, qmax);
  q.z = quantize_one(v.z, b.z, scale, qmax);
  q.w = quantize_one(v.w, b.w, scale, qmax);
  reinterpret_cast<char4*>(codes + row * kBlock)[threadIdx.x] = q;
}

__global__ void __launch_bounds__(kThreads)
    dequantize_kernel(const signed char* __restrict__ codes,
                      const float* __restrict__ scales,
                      const float* __restrict__ adj,
                      float* __restrict__ out,
                      float* __restrict__ residual) {
  const size_t row = blockIdx.x;
  const size_t i = row * kThreads + threadIdx.x;     // float4 index
  const char4 c = reinterpret_cast<const char4*>(codes)[i];
  const float s = scales[row];
  const float cx = c.x, cy = c.y, cz = c.z, cw = c.w;
  reinterpret_cast<float4*>(out)[i] =
      make_float4(__fmul_rn(cx, s), __fmul_rn(cy, s), __fmul_rn(cz, s),
                  __fmul_rn(cw, s));
  if (adj != nullptr) {
    const float4 a = reinterpret_cast<const float4*>(adj)[i];
    reinterpret_cast<float4*>(residual)[i] =
        make_float4(__fmaf_rn(-cx, s, a.x), __fmaf_rn(-cy, s, a.y),
                    __fmaf_rn(-cz, s, a.z), __fmaf_rn(-cw, s, a.w));
  }
}

}  // namespace

// x: (rows, 1024) f32; bits: (rows, 1024) uint32 (any 32-bit pattern);
// codes: (rows, 1024) int8; scales: (rows,) f32; every pointer 16-byte
// aligned.  qmax: 127 (int8) or 7 (int4).  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int firm_quantize(const void* x, const void* bits, void* codes,
                             void* scales, int rows, int qmax,
                             void* stream) {
  if (rows <= 0 || qmax <= 0 || qmax > 127)
    return static_cast<int>(cudaErrorInvalidValue);
  quantize_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(bits),
      static_cast<signed char*>(codes), static_cast<float*>(scales),
      static_cast<float>(qmax));
  return static_cast<int>(cudaGetLastError());
}

// codes: (rows, 1024) int8; scales: (rows,) f32; out: (rows, 1024) f32.
// adj and residual: (rows, 1024) f32, both given (the error-feedback
// epilogue) or both null.  Pointers 16-byte aligned.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int firm_dequantize(const void* codes, const void* scales,
                               const void* adj, void* out, void* residual,
                               int rows, void* stream) {
  if (rows <= 0 || (adj == nullptr) != (residual == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  dequantize_kernel<<<rows, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(codes),
      static_cast<const float*>(scales), static_cast<const float*>(adj),
      static_cast<float*>(out), static_cast<float*>(residual));
  return static_cast<int>(cudaGetLastError());
}
