// GQA flash attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py:flash_attention (_flash_kernel).
// q (B, Sq, Hq, Dh), k and v (B, Skv, Hkv, Dh), output in q's shape and
// type.  Query head h reads KV head h / (Hq / Hkv) in place: no repeated-KV
// tensor exists.  Query i and key j sit at absolute positions i and j; the
// causal mask keeps i >= j and the sliding window keeps i - j < window.
// Masked scores are -1e30, the softmax is online in f32 (running max m,
// running sum l, accumulator acc), q is scaled by Dh^-0.5 in f32 before the
// product, and the output is acc / max(l, 1e-30) rounded to the input
// type: the arithmetic of the Pallas kernel.  Unlike the Pallas kernel,
// which asserts S % block == 0, this one takes ragged Sq and Skv and masks
// the edge tiles itself.
//
// What bounds it on the H100: at the rollout's shape (B=16, S=256, Hq=32,
// Hkv=8, Dh=64, causal, bf16) the function needs about 4.3 GFLOP and moves
// about 42 MB, so the card's floor is the 12.5 us of memory traffic at
// 3.35 TB/s (4.4 us of bf16 tensor-core time).  This first version does not
// reach that floor: its inner products are scalar f32 FMAs, not tensor-core
// instructions, so it is bound by the FMA pipes and shared-memory reads.
//
// What the design does: one block of 64 threads per (batch x query head,
// 64-row query tile); each thread owns one query row, keeping q and the
// accumulator in registers.  The block walks 64-key tiles of K and V,
// staged in shared memory as f32 with 16-byte coalesced loads, and skips
// every tile that the causal or sliding-window mask removes for all of its
// rows.  Within a tile a thread scores 16 keys at a time (broadcast
// shared-memory reads, all threads read the same key) and updates its
// online softmax once per 16 keys.  Moving the products to mma.sync or
// wgmma with a TMA-fed ring of tiles is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kBlockQ = 64;  // query rows per block, one per thread
constexpr int kBlockK = 64;  // keys per shared-memory tile
constexpr int kChunk = 16;   // keys per online-softmax update
constexpr float kNegInf = -1e30f;

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

template <typename T, int DH>
__global__ void __launch_bounds__(kBlockQ)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int sq,
                     int skv, int hq, int hkv, int causal, int window,
                     float scale) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte access
  constexpr int VPR = DH / V;        // 16-byte accesses per row
  __shared__ __align__(16) float ks[kBlockK][DH];
  __shared__ __align__(16) float vs[kBlockK][DH];

  const int bh = blockIdx.x;
  const int b = bh / hq, h = bh % hq;
  const int kvh = h / (hq / hkv);
  const int q0 = blockIdx.y * kBlockQ;
  const int qi = q0 + threadIdx.x;
  const bool row_ok = qi < sq;

  float qr[DH], acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  if (row_ok) {
    const T* qp = q + (static_cast<size_t>(b) * sq + qi) * hq * DH +
                  static_cast<size_t>(h) * DH;
#pragma unroll
    for (int c = 0; c < VPR; ++c) {
      const uint4 raw = reinterpret_cast<const uint4*>(qp)[c];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) qr[c * V + j] = to_f(e[j]) * scale;
    }
  } else {
#pragma unroll
    for (int d = 0; d < DH; ++d) qr[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  // keys that any row of this block may see
  const int q_last = min(q0 + kBlockQ, sq) - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  const int k_begin = window ? max(0, q0 - window + 1) : 0;

  for (int kbase = k_begin / kBlockK * kBlockK; kbase < k_end;
       kbase += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    for (int c = threadIdx.x; c < kBlockK * VPR; c += kBlockQ) {
      const int r = c / VPR, cv = c % VPR;
      const int kp = kbase + r;
      float* kd = &ks[r][cv * V];
      float* vd = &vs[r][cv * V];
      if (kp < skv) {
        const size_t off = (static_cast<size_t>(b) * skv + kp) * hkv * DH +
                           static_cast<size_t>(kvh) * DH + cv * V;
        const uint4 kraw = *reinterpret_cast<const uint4*>(k + off);
        const uint4 vraw = *reinterpret_cast<const uint4*>(v + off);
        const T* ke = reinterpret_cast<const T*>(&kraw);
        const T* ve = reinterpret_cast<const T*>(&vraw);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          kd[j] = to_f(ke[j]);
          vd[j] = to_f(ve[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) kd[j] = vd[j] = 0.f;
      }
    }
    __syncthreads();
    if (!row_ok) continue;

    for (int c0 = 0; c0 < kBlockK && kbase + c0 < k_end; c0 += kChunk) {
      float s[kChunk];
      float cmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int kp = kbase + c0 + j;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < DH; d += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(&ks[c0 + j][d]);
          dot += qr[d] * kk.x + qr[d + 1] * kk.y + qr[d + 2] * kk.z +
                 qr[d + 3] * kk.w;
        }
        const bool ok = kp < skv && (!causal || qi >= kp) &&
                        (!window || qi - kp < window);
        s[j] = ok ? dot : kNegInf;
        cmax = fmaxf(cmax, s[j]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        s[j] = expf(s[j] - m_new);
        psum += s[j];
      }
      l = l * corr + psum;
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        float a0 = acc[d] * corr, a1 = acc[d + 1] * corr;
        float a2 = acc[d + 2] * corr, a3 = acc[d + 3] * corr;
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const float4 vv = *reinterpret_cast<const float4*>(&vs[c0 + j][d]);
          a0 += s[j] * vv.x;
          a1 += s[j] * vv.y;
          a2 += s[j] * vv.z;
          a3 += s[j] * vv.w;
        }
        acc[d] = a0;
        acc[d + 1] = a1;
        acc[d + 2] = a2;
        acc[d + 3] = a3;
      }
      m = m_new;
    }
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
    T* op = o + (static_cast<size_t>(b) * sq + qi) * hq * DH +
            static_cast<size_t>(h) * DH;
#pragma unroll
    for (int c = 0; c < VPR; ++c) {
      uint4 out;
      T* e = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j) e[j] = from_f<T>(acc[c * V + j] / denom);
      reinterpret_cast<uint4*>(op)[c] = out;
    }
  }
}

template <typename T, int DH>
void launch(const void* q, const void* k, const void* v, void* o, int b,
            int sq, int skv, int hq, int hkv, int causal, int window,
            cudaStream_t stream) {
  const dim3 grid(b * hq, (sq + kBlockQ - 1) / kBlockQ);
  // Dh^-0.5 in double, rounded once to f32, as the Python side computes it
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(DH)));
  flash_fwd_kernel<T, DH><<<grid, kBlockQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, skv, hq, hkv, causal,
      window, scale);
}

template <typename T>
int dispatch_dh(const void* q, const void* k, const void* v, void* o, int b,
                int sq, int skv, int hq, int hkv, int dh, int causal,
                int window, cudaStream_t s) {
  switch (dh) {
    case 16:
      launch<T, 16>(q, k, v, o, b, sq, skv, hq, hkv, causal, window, s);
      break;
    case 32:
      launch<T, 32>(q, k, v, o, b, sq, skv, hq, hkv, causal, window, s);
      break;
    case 64:
      launch<T, 64>(q, k, v, o, b, sq, skv, hq, hkv, causal, window, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; dh in {16, 32, 64}.  Pointers must be
// 16-byte aligned and the tensors contiguous.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int firm_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, int b, int sq,
                                    int skv, int hq, int hkv, int dh,
                                    int causal, int window, int dtype,
                                    void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dh<float>(q, k, v, o, b, sq, skv, hq, hkv, dh, causal,
                              window, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(q, k, v, o, b, sq, skv, hq, hkv, dh,
                                      causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
