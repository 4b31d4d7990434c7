// GQA flash attention, forward and backward, for NVIDIA Hopper (sm_90a),
// with a plain C interface.
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
// wgmma with a TMA-fed ring of tiles is later work.  Given a non-null lse
// pointer the forward also writes the f32 log-sum-exp m + log(l) of every
// query row, (B, Hq, Sq), which the backward reads; the rollout passes
// null and moves no extra bytes.
//
// The backward (firm_flash_attention_bwd) is the gradient of this forward:
// the JAX package never needed one, since its Pallas kernel is forward-only
// and JAX differentiates the XLA twin.  FlashAttention-2 style, it
// recomputes P = exp(s - lse) from the saved log-sum-exp, with s the
// scaled score of the forward (-1e30 where masked), and uses
// D = rowsum(dO * O) in f32:
//
//   dV_j = sum_i P_ij dO_i      dP_ij = dO_i . V_j
//   dS_ij = P_ij (dP_ij - D_i)
//   dQ_i = scale * sum_j dS_ij K_j      dK_j = scale * sum_i dS_ij Q_i
//
// Two __global__ functions behind one C entry keep it deterministic
// without atomics: flash_bwd_dq_kernel, one block per (batch x query head,
// 64-row query tile), computes D (written to a scratch buffer) and dQ over
// the key tiles the mask keeps; flash_bwd_dkv_kernel, launched after it on
// the same stream, is one block per (batch x KV head, 64-key tile) and
// loops over the group's Hq/Hkv query heads and the query tiles the mask
// keeps, so GQA's sum over the group stays in registers.  Each row (query
// or key) belongs to two neighbouring threads that hold alternating
// 16-byte chunks of its Dh values; their partial dot products meet through
// one warp shuffle.  The other operand streams through shared memory as
// f32.  Products are scalar f32 FMAs, accumulated in f32; dq, dk and dv
// are written in the input type.  A query row that sees no key (possible
// only with a sliding window and Sq >= Skv + window) is refused by the
// wrapper.
//
// Bound of the backward at the local step's shape (B=16, S=256, Hq=32,
// Hkv=8, Dh=64, causal, bf16): it reads q, k, v, o, dO, lse and writes dq,
// dk, dv (about 85 MB with D: 25 us at 3.35 TB/s) and does 10 * Dh flops
// per kept (query, key) pair (10.9 GFLOP: 11 us at 989 TFLOP/s).  Like the
// forward, this first version runs on the FMA pipes, not tensor cores.
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
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int sq, int skv, int hq,
                     int hkv, int causal, int window, float scale) {
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
    if (lse != nullptr)
      lse[static_cast<size_t>(bh) * sq + qi] = m + logf(l);
  }
}

template <typename T, int DH>
void launch(const void* q, const void* k, const void* v, void* o,
            float* lse, int b, int sq, int skv, int hq, int hkv, int causal,
            int window, cudaStream_t stream) {
  const dim3 grid(b * hq, (sq + kBlockQ - 1) / kBlockQ);
  // Dh^-0.5 in double, rounded once to f32, as the Python side computes it
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(DH)));
  flash_fwd_kernel<T, DH><<<grid, kBlockQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, skv, hq, hkv,
      causal, window, scale);
}

template <typename T>
int dispatch_dh(const void* q, const void* k, const void* v, void* o,
                float* lse, int b, int sq, int skv, int hq, int hkv, int dh,
                int causal, int window, cudaStream_t s) {
  switch (dh) {
    case 16:
      launch<T, 16>(q, k, v, o, lse, b, sq, skv, hq, hkv, causal, window, s);
      break;
    case 32:
      launch<T, 32>(q, k, v, o, lse, b, sq, skv, hq, hkv, causal, window, s);
      break;
    case 64:
      launch<T, 64>(q, k, v, o, lse, b, sq, skv, hq, hkv, causal, window, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- backward
constexpr int kRows = 64;              // query (dq) or key (dkv) rows a block
constexpr int kBwdThreads = 2 * kRows;  // two threads per row

template <typename T>
__device__ __forceinline__ float4 load4(const T* p);
template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
  return make_float4(to_f(e[0]), to_f(e[1]), to_f(e[2]), to_f(e[3]));
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v);
template <>
__device__ __forceinline__ void store4<float>(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float4 v) {
  uint2 raw;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
  e[0] = from_f<__nv_bfloat16>(v.x);
  e[1] = from_f<__nv_bfloat16>(v.y);
  e[2] = from_f<__nv_bfloat16>(v.z);
  e[3] = from_f<__nv_bfloat16>(v.w);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void fma4(float4& acc, float s, float4 b) {
  acc.x += s * b.x;
  acc.y += s * b.y;
  acc.z += s * b.z;
  acc.w += s * b.w;
}

__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

__device__ __forceinline__ bool kept(int qi, int kp, int sq, int skv,
                                     int causal, int window) {
  return qi < sq && kp < skv && (!causal || qi >= kp) &&
         (!window || qi - kp < window);
}

// Stage rows [row0, row0 + kRows) of a (B, S, H, DH) tensor at (b, h) in
// shared memory as f32 times mul; rows at or past s are zero.
template <typename T, int DH>
__device__ __forceinline__ void stage(float (*dst)[DH], const T* src, int b,
                                      int s, int h, int n_heads, int row0,
                                      float mul) {
  constexpr int CPR = DH / 4;  // 4-element chunks per row
  for (int c = threadIdx.x; c < kRows * CPR; c += blockDim.x) {
    const int r = c / CPR, cc = c % CPR;
    const int row = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < s)
      val = scale4(load4<T>(src + ((static_cast<size_t>(b) * s + row) *
                                       n_heads + h) * DH + 4 * cc),
                   mul);
    *reinterpret_cast<float4*>(&dst[r][4 * cc]) = val;
  }
}

// dQ and D = rowsum(dO * O).  Block: (batch x query head, query tile);
// thread 2r + half owns the chunks {half, half + 2, ...} of query row r.
template <typename T, int DH>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse, float* __restrict__ dsum,
                        T* __restrict__ dq, int sq, int skv, int hq, int hkv,
                        int causal, int window, float scale) {
  constexpr int NC = DH / 8;  // chunks a thread owns
  __shared__ __align__(16) float ks[kRows][DH];
  __shared__ __align__(16) float vs[kRows][DH];

  const int bh = blockIdx.x;
  const int b = bh / hq, h = bh % hq;
  const int kvh = h / (hq / hkv);
  const int q0 = blockIdx.y * kRows;
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int qi = q0 + r;
  const bool row_ok = qi < sq;

  float4 qv[NC], dov[NC], acc[NC];
  float dpart = 0.f;
#pragma unroll
  for (int t = 0; t < NC; ++t) {
    qv[t] = dov[t] = acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row_ok) {
      const size_t off = (static_cast<size_t>(b) * sq + qi) * hq * DH +
                         static_cast<size_t>(h) * DH + 4 * (2 * t + half);
      qv[t] = scale4(load4<T>(q + off), scale);
      dov[t] = load4<T>(dout + off);
      dpart += dot4(dov[t], load4<T>(o + off));
    }
  }
  const float dl = dpart + __shfl_xor_sync(0xffffffffu, dpart, 1);
  const size_t row_idx = static_cast<size_t>(bh) * sq + qi;
  const float lse_i = row_ok ? lse[row_idx] : 0.f;
  if (row_ok && half == 0) dsum[row_idx] = dl;

  // keys that any row of this block may see (as in the forward)
  const int q_last = min(q0 + kRows, sq) - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  const int k_begin = window ? max(0, q0 - window + 1) : 0;

  for (int kbase = k_begin / kRows * kRows; kbase < k_end; kbase += kRows) {
    __syncthreads();  // the previous tile is consumed
    stage<T, DH>(ks, k, b, skv, kvh, hkv, kbase, 1.f);
    stage<T, DH>(vs, v, b, skv, kvh, hkv, kbase, 1.f);
    __syncthreads();
    const int n = min(kRows, k_end - kbase);
    for (int j = 0; j < n; ++j) {
      float sp = 0.f, dpp = 0.f;
#pragma unroll
      for (int t = 0; t < NC; ++t) {
        const int col = 4 * (2 * t + half);
        sp += dot4(qv[t], *reinterpret_cast<const float4*>(&ks[j][col]));
        dpp += dot4(dov[t], *reinterpret_cast<const float4*>(&vs[j][col]));
      }
      const float sc = sp + __shfl_xor_sync(0xffffffffu, sp, 1);
      const float dp = dpp + __shfl_xor_sync(0xffffffffu, dpp, 1);
      const int kp = kbase + j;
      const float p =
          kept(qi, kp, sq, skv, causal, window) ? expf(sc - lse_i) : 0.f;
      const float ds = p * (dp - dl);
#pragma unroll
      for (int t = 0; t < NC; ++t)
        fma4(acc[t], ds,
             *reinterpret_cast<const float4*>(&ks[j][4 * (2 * t + half)]));
    }
  }

  if (row_ok) {
#pragma unroll
    for (int t = 0; t < NC; ++t) {
      const size_t off = (static_cast<size_t>(b) * sq + qi) * hq * DH +
                         static_cast<size_t>(h) * DH + 4 * (2 * t + half);
      store4<T>(dq + off, scale4(acc[t], scale));
    }
  }
}

// dK and dV.  Block: (batch x KV head, key tile); thread 2r + half owns the
// chunks {half, half + 2, ...} of key row r, and sums over the group's
// query heads and every query tile the mask keeps.
template <typename T, int DH>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum, T* __restrict__ dk,
                         T* __restrict__ dv, int sq, int skv, int hq, int hkv,
                         int causal, int window, float scale) {
  constexpr int NC = DH / 8;
  __shared__ __align__(16) float qs[kRows][DH];
  __shared__ __align__(16) float dos[kRows][DH];
  __shared__ float lse_s[kRows];
  __shared__ float d_s[kRows];

  const int bkh = blockIdx.x;
  const int b = bkh / hkv, kvh = bkh % hkv;
  const int qpk = hq / hkv;
  const int k0 = blockIdx.y * kRows;
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int kj = k0 + r;
  const bool row_ok = kj < skv;

  float4 kv_k[NC], kv_v[NC], dkacc[NC], dvacc[NC];
#pragma unroll
  for (int t = 0; t < NC; ++t) {
    kv_k[t] = kv_v[t] = dkacc[t] = dvacc[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row_ok) {
      const size_t off = (static_cast<size_t>(b) * skv + kj) * hkv * DH +
                         static_cast<size_t>(kvh) * DH + 4 * (2 * t + half);
      kv_k[t] = load4<T>(k + off);
      kv_v[t] = load4<T>(v + off);
    }
  }

  // queries that may see a key of this tile
  const int k_last = min(k0 + kRows, skv) - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window ? min(sq, k_last + window) : sq;

  for (int g = 0; g < qpk; ++g) {
    const int h = kvh * qpk + g;
    const size_t bh = static_cast<size_t>(b) * hq + h;
    for (int qbase = q_begin / kRows * kRows; qbase < q_end;
         qbase += kRows) {
      __syncthreads();  // the previous tile is consumed
      stage<T, DH>(qs, q, b, sq, h, hq, qbase, scale);
      stage<T, DH>(dos, dout, b, sq, h, hq, qbase, 1.f);
      if (threadIdx.x < kRows) {
        const int qi = qbase + threadIdx.x;
        lse_s[threadIdx.x] = qi < sq ? lse[bh * sq + qi] : 0.f;
        d_s[threadIdx.x] = qi < sq ? dsum[bh * sq + qi] : 0.f;
      }
      __syncthreads();
      const int n = min(kRows, q_end - qbase);
      for (int i = 0; i < n; ++i) {
        float sp = 0.f, dpp = 0.f;
#pragma unroll
        for (int t = 0; t < NC; ++t) {
          const int col = 4 * (2 * t + half);
          sp += dot4(kv_k[t], *reinterpret_cast<const float4*>(&qs[i][col]));
          dpp += dot4(kv_v[t],
                      *reinterpret_cast<const float4*>(&dos[i][col]));
        }
        const float sc = sp + __shfl_xor_sync(0xffffffffu, sp, 1);
        const float dp = dpp + __shfl_xor_sync(0xffffffffu, dpp, 1);
        const int qi = qbase + i;
        const float p = kept(qi, kj, sq, skv, causal, window)
                            ? expf(sc - lse_s[i]) : 0.f;
        const float ds = p * (dp - d_s[i]);
#pragma unroll
        for (int t = 0; t < NC; ++t) {
          const int col = 4 * (2 * t + half);
          fma4(dvacc[t], p, *reinterpret_cast<const float4*>(&dos[i][col]));
          fma4(dkacc[t], ds, *reinterpret_cast<const float4*>(&qs[i][col]));
        }
      }
    }
  }

  if (row_ok) {
#pragma unroll
    for (int t = 0; t < NC; ++t) {
      const size_t off = (static_cast<size_t>(b) * skv + kj) * hkv * DH +
                         static_cast<size_t>(kvh) * DH + 4 * (2 * t + half);
      store4<T>(dk + off, dkacc[t]);
      store4<T>(dv + off, dvacc[t]);
    }
  }
}

template <typename T, int DH>
void launch_bwd(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* dsum, void* dq,
                void* dk, void* dv, int b, int sq, int skv, int hq, int hkv,
                int causal, int window, cudaStream_t stream) {
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(DH)));
  const dim3 grid_q(b * hq, (sq + kRows - 1) / kRows);
  flash_bwd_dq_kernel<T, DH><<<grid_q, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, dsum, static_cast<T*>(dq), sq, skv,
      hq, hkv, causal, window, scale);
  const dim3 grid_kv(b * hkv, (skv + kRows - 1) / kRows);
  flash_bwd_dkv_kernel<T, DH><<<grid_kv, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum,
      static_cast<T*>(dk), static_cast<T*>(dv), sq, skv, hq, hkv, causal,
      window, scale);
}

template <typename T>
int dispatch_bwd(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* dsum, void* dq,
                 void* dk, void* dv, int b, int sq, int skv, int hq, int hkv,
                 int dh, int causal, int window, cudaStream_t s) {
  switch (dh) {
    case 16:
      launch_bwd<T, 16>(q, k, v, o, dout, lse, dsum, dq, dk, dv, b, sq, skv,
                        hq, hkv, causal, window, s);
      break;
    case 32:
      launch_bwd<T, 32>(q, k, v, o, dout, lse, dsum, dq, dk, dv, b, sq, skv,
                        hq, hkv, causal, window, s);
      break;
    case 64:
      launch_bwd<T, 64>(q, k, v, o, dout, lse, dsum, dq, dk, dv, b, sq, skv,
                        hq, hkv, causal, window, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; dh in {16, 32, 64}.  Pointers must be
// 16-byte aligned and the tensors contiguous; lse is null or (b, hq, sq)
// f32.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int firm_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, void* lse, int b,
                                    int sq, int skv, int hq, int hkv, int dh,
                                    int causal, int window, int dtype,
                                    void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return dispatch_dh<float>(q, k, v, o, l, b, sq, skv, hq, hkv, dh, causal,
                              window, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(q, k, v, o, l, b, sq, skv, hq, hkv, dh,
                                      causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Gradients of firm_flash_attention: dq, dk, dv (the inputs' shapes and
// dtype) given q, k, v, the forward's o and lse, and dout (o's shape).
// dsum is (b, hq, sq) f32 scratch for D = rowsum(dout * o).  Launches the
// dq kernel, then the dk/dv kernel, on the stream; returns
// cudaGetLastError() after both (0 on success).
extern "C" int firm_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dsum, void* dq, void* dk,
    void* dv, int b, int sq, int skv, int hq, int hkv, int dh, int causal,
    int window, int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  if (dtype == 0)
    return dispatch_bwd<float>(q, k, v, o, dout, l, ds, dq, dk, dv, b, sq,
                               skv, hq, hkv, dh, causal, window, s);
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16>(q, k, v, o, dout, l, ds, dq, dk, dv,
                                       b, sq, skv, hq, hkv, dh, causal,
                                       window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
