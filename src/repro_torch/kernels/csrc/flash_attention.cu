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
// running sum l, accumulator acc), and the output is acc / max(l, 1e-30)
// rounded to the input type: the arithmetic of the Pallas kernel.  Unlike
// the Pallas kernel, which asserts S % block == 0, this one takes ragged
// Sq and Skv and masks the edge tiles itself.  Given a non-null lse
// pointer the forward also writes the f32 log-sum-exp m + log(l) of every
// query row, (B, Hq, Sq), which the backward reads; the rollout passes
// null and moves no extra bytes.
//
// The backward (firm_flash_attention_bwd) is the gradient of this forward:
// the JAX package never needed one, since its Pallas kernel is forward-only
// and JAX differentiates the XLA twin.  FlashAttention-2 style, it
// recomputes P = exp(s - lse) from the saved log-sum-exp, with s the
// scaled score of the forward (-1e30 where masked), and uses
// D = rowsum(dO * O) in f32, O as the forward wrote it:
//
//   dV_j = sum_i P_ij dO_i      dP_ij = dO_i . V_j
//   dS_ij = P_ij (dP_ij - D_i)
//   dQ_i = scale * sum_j dS_ij K_j      dK_j = scale * sum_i dS_ij Q_i
//
// Two kernels behind one C entry keep it deterministic without atomics:
// a dq kernel, one block per (batch x query head, 64-row query tile),
// computes D (written to a scratch buffer) and dQ over the key tiles the
// mask keeps; a dk/dv kernel, launched after it on the same stream, is one
// block per (batch x KV head, 64-key tile) and loops over the group's
// Hq/Hkv query heads and the query tiles the mask keeps, so GQA's sum over
// the group stays in registers.  A query row that sees no key (possible
// only with a sliding window and Sq >= Skv + window) is refused by the
// wrapper.
//
// What bounds them on the H100.  At the rollout's shape (B=16, S=256,
// Hq=32, Hkv=8, Dh=64, causal, bf16) the forward needs 4.3 GFLOP and moves
// 42 MB: the floor is the 12.5 us of memory traffic at 3.35 TB/s, against
// 4.4 us of bf16 tensor-core time.  At the local step's shape the
// backward reads q, k, v, o, dO, lse and writes dq, dk, dv (85 MB with D:
// 25 us) and does 10 Dh flops per kept (query, key) pair (10.9 GFLOP:
// 11 us at 989 TFLOP/s).  Both are bound by bytes, but only once their
// products run on tensor cores: on the FMA pipes (67 TFLOP/s of f32) the
// same flops take 64 and 163 us, which is why the first design, scalar
// FMAs on f32 copies of the tiles, ran at 26x and 36x its bound.  At
// Dh = 128 (mixtral's training shape, the same B, S and heads) the forward
// moves 83.9 MB (25 us) against 8.6 GFLOP (8.7 us) and the backward about
// 168 MB (50 us) against 21.6 GFLOP (22 us): bound by bytes too.
//
// Which dtype takes which path, and why:
//
// * bf16: tensor cores.  Every product (S = Q K^T and O += P V forward;
//   S, dP = dO V^T and dQ += dS K in the dq kernel; S^T = K Q^T,
//   dV += P^T dO, dP^T = V dO^T and dK += dS^T Q in the dk/dv kernel) is
//   an mma.sync.m16n8k16 with bf16 operands and f32 accumulators.  A block
//   is 4 warps, 16 rows (queries, or keys in the dk/dv kernel) a warp, as
//   in FlashAttention-2.  Tiles of 64 rows stay bf16 in shared memory,
//   double-buffered: cp.async 16-byte copies fetch the next tile while the
//   warps work on this one, and rows past S are zero-filled by the copy's
//   src-size operand.  Each row is padded by 16 bytes, so the 8 rows an
//   ldmatrix phase reads fall in 8 distinct bank groups (no conflicts,
//   with or without .trans).  A warp's own rows (Q and dO, or K and V)
//   stay in registers as A fragments for the whole kernel.  The online
//   softmax runs on the accumulator fragments: a row's 4 lanes meet by
//   two shuffles.  P (and dS) go to the next product as bf16 A fragments
//   straight from the registers: an S accumulator fragment is laid out as
//   the A fragment of the next m16n8k16.  The scale multiplies S in f32
//   (1/sqrt(Dh) is not exact in bf16, so scaling q first would round it).
//   Q, K, V and dO are bf16 already, so Q K^T and dO V^T are exact
//   products summed in f32; the error this path adds to the FMA design's
//   is the rounding of P and dS to bf16 (2^-9 relative) as operands.  The
//   forward's l sums the rounded P, so its weights sum to 1.  Tiles that
//   the causal or window mask removes whole are skipped; edge tiles are
//   masked element by element.  The epilogues stage the output tile in
//   shared memory for 16-byte coalesced stores.
//
// * f32: the FMA kernels of the first design (one thread per query row in
//   the forward, two threads a row in the backward, f32 tiles in shared
//   memory, scalar f32 FMAs).  f32 is the checking path (the card's f32
//   gates hold it to 1e-4 of the plain f32 version): TF32 products would
//   not meet them, and tensor cores have no exact f32 mode.
//
// Head dims 16, 32, 64 and 128.  Every kernel keeps its tiles in dynamic
// shared memory (flash_smem), sized by the launch and allowed past the
// static 48 KB by one cudaFuncSetAttribute for each instantiation on each
// device (allow_smem): at Dh = 128 a bf16 tile is 17,408 bytes and the
// forward holds five (87,040), the dq kernel four and the dk/dv kernel six;
// an f32 tile is 32 KB.  Registers decide the rest of the Dh = 128 design: the
// FMA kernels give a row 2 (forward) or 4 (backward) threads where they
// give it 1 or 2 below Dh = 128 (fwd_tpr, bwd_tpr), so that a thread's
// share of the row (qr and acc, or q, dO and dq, or k, v, dk and dv) stays
// at 32 floats each; the bf16 dk/dv kernel reads K and V from shared
// memory for every product instead of holding them as A fragments
// (kv_in_regs), since with its two 64-float accumulators they would pass
// 255 registers.  The instances below Dh = 128 run the arithmetic they ran
// before, in the same order: the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <cmath>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ bool kept(int qi, int kp, int sq, int skv,
                                     int causal, int window) {
  return qi < sq && kp < skv && (!causal || qi >= kp) &&
         (!window || qi - kp < window);
}

// =========================================================== f32: FMA path

constexpr int kBlockQ = 64;  // query rows per forward block
constexpr int kBlockK = 64;  // keys per shared-memory tile
constexpr int kChunk = 16;   // keys per online-softmax update
constexpr unsigned kFull = 0xffffffffu;

// threads a query row in the FMA forward; TPR threads of a row own the
// 4-float chunks {part, part + TPR, ...}
template <int DH>
__host__ __device__ constexpr int fwd_tpr() {
  return DH > 64 ? 2 : 1;
}

template <int DH>
__global__ void __launch_bounds__(kBlockQ * fwd_tpr<DH>())
    flash_fwd_fma_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int sq, int skv, int hq,
                         int hkv, int causal, int window, float scale) {
  constexpr int TPR = fwd_tpr<DH>();
  constexpr int NT = kBlockQ * TPR;  // threads a block
  constexpr int VPR = DH / 4;        // 16-byte accesses per row
  constexpr int OWN = DH / TPR;      // floats of a row a thread owns
  extern __shared__ __align__(128) unsigned char flash_smem[];
  float(*ks)[DH] = reinterpret_cast<float(*)[DH]>(flash_smem);
  float(*vs)[DH] = ks + kBlockK;

  const int bh = blockIdx.x;
  const int b = bh / hq, h = bh % hq;
  const int kvh = h / (hq / hkv);
  const int q0 = blockIdx.y * kBlockQ;
  const int part = threadIdx.x % TPR;
  const int qi = q0 + threadIdx.x / TPR;
  const bool row_ok = qi < sq;
  // column of this thread's d-th owned float
  auto col = [part](int d) { return 4 * (TPR * (d / 4) + part) + d % 4; };

  float qr[OWN], acc[OWN];
#pragma unroll
  for (int d = 0; d < OWN; ++d) acc[d] = 0.f;
  if (row_ok) {
    const float* qp = q + (static_cast<size_t>(b) * sq + qi) * hq * DH +
                      static_cast<size_t>(h) * DH;
#pragma unroll
    for (int c = 0; c < OWN / 4; ++c) {
      const float4 e = reinterpret_cast<const float4*>(qp)[TPR * c + part];
      qr[4 * c] = e.x * scale;
      qr[4 * c + 1] = e.y * scale;
      qr[4 * c + 2] = e.z * scale;
      qr[4 * c + 3] = e.w * scale;
    }
  } else {
#pragma unroll
    for (int d = 0; d < OWN; ++d) qr[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  // keys that any row of this block may see
  const int q_last = min(q0 + kBlockQ, sq) - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  const int k_begin = window ? max(0, q0 - window + 1) : 0;

  for (int kbase = k_begin / kBlockK * kBlockK; kbase < k_end;
       kbase += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    for (int c = threadIdx.x; c < kBlockK * VPR; c += NT) {
      const int r = c / VPR, cv = c % VPR;
      const int kp = kbase + r;
      float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kv4;
      if (kp < skv) {
        const size_t off = (static_cast<size_t>(b) * skv + kp) * hkv * DH +
                           static_cast<size_t>(kvh) * DH + cv * 4;
        kv4 = *reinterpret_cast<const float4*>(k + off);
        vv4 = *reinterpret_cast<const float4*>(v + off);
      }
      *reinterpret_cast<float4*>(&ks[r][cv * 4]) = kv4;
      *reinterpret_cast<float4*>(&vs[r][cv * 4]) = vv4;
    }
    __syncthreads();
    // a row's threads meet in shuffles, so with TPR > 1 a row past sq
    // computes on zeros beside the others
    if (TPR == 1 && !row_ok) continue;

    for (int c0 = 0; c0 < kBlockK && kbase + c0 < k_end; c0 += kChunk) {
      float s[kChunk];
      float cmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int kp = kbase + c0 + j;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < OWN; d += 4) {
          const float4 kk =
              *reinterpret_cast<const float4*>(&ks[c0 + j][col(d)]);
          dot += qr[d] * kk.x + qr[d + 1] * kk.y + qr[d + 2] * kk.z +
                 qr[d + 3] * kk.w;
        }
        if (TPR == 2) dot += __shfl_xor_sync(kFull, dot, 1);
        s[j] = kept(qi, kp, sq, skv, causal, window) ? dot : kNegInf;
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
      for (int d = 0; d < OWN; d += 4) {
        float a0 = acc[d] * corr, a1 = acc[d + 1] * corr;
        float a2 = acc[d + 2] * corr, a3 = acc[d + 3] * corr;
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const float4 vv =
              *reinterpret_cast<const float4*>(&vs[c0 + j][col(d)]);
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
    float* op = o + (static_cast<size_t>(b) * sq + qi) * hq * DH +
                static_cast<size_t>(h) * DH;
#pragma unroll
    for (int c = 0; c < OWN / 4; ++c)
      reinterpret_cast<float4*>(op)[TPR * c + part] =
          make_float4(acc[4 * c] / denom, acc[4 * c + 1] / denom,
                      acc[4 * c + 2] / denom, acc[4 * c + 3] / denom);
    if (lse != nullptr && part == 0)
      lse[static_cast<size_t>(bh) * sq + qi] = m + logf(l);
  }
}

constexpr int kRows = 64;  // query (dq) or key (dkv) rows a block

// threads a row in the FMA backward; TPR threads of a row own the 4-float
// chunks {part, part + TPR, ...}
template <int DH>
__host__ __device__ constexpr int bwd_tpr() {
  return DH > 64 ? 4 : 2;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
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

// the sum of a value over the TPR threads of a row: the partner's first
// (as the two-thread design added it), then the other pair's
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
  float y = x + __shfl_xor_sync(kFull, x, 1);
  if (TPR == 4) y += __shfl_xor_sync(kFull, y, 2);
  return y;
}

// Stage rows [row0, row0 + kRows) of a (B, S, H, DH) tensor at (b, h) in
// shared memory times mul; rows at or past s are zero.
template <int DH>
__device__ __forceinline__ void stage(float (*dst)[DH], const float* src,
                                      int b, int s, int h, int n_heads,
                                      int row0, float mul) {
  constexpr int CPR = DH / 4;  // 4-element chunks per row
  for (int c = threadIdx.x; c < kRows * CPR; c += blockDim.x) {
    const int r = c / CPR, cc = c % CPR;
    const int row = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < s)
      val = scale4(load4(src + ((static_cast<size_t>(b) * s + row) *
                                    n_heads + h) * DH + 4 * cc),
                   mul);
    *reinterpret_cast<float4*>(&dst[r][4 * cc]) = val;
  }
}

// dQ and D = rowsum(dO * O).  Block: (batch x query head, query tile);
// thread TPR r + part owns the chunks {part, part + TPR, ...} of query
// row r.
template <int DH>
__global__ void __launch_bounds__(kRows * bwd_tpr<DH>())
    flash_bwd_dq_fma_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ o,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            float* __restrict__ dsum, float* __restrict__ dq,
                            int sq, int skv, int hq, int hkv, int causal,
                            int window, float scale) {
  constexpr int TPR = bwd_tpr<DH>();
  constexpr int NC = DH / (4 * TPR);  // chunks a thread owns
  extern __shared__ __align__(128) unsigned char flash_smem[];
  float(*ks)[DH] = reinterpret_cast<float(*)[DH]>(flash_smem);
  float(*vs)[DH] = ks + kRows;

  const int bh = blockIdx.x;
  const int b = bh / hq, h = bh % hq;
  const int kvh = h / (hq / hkv);
  const int q0 = blockIdx.y * kRows;
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int qi = q0 + r;
  const bool row_ok = qi < sq;

  float4 qv[NC], dov[NC], acc[NC];
  float dpart = 0.f;
#pragma unroll
  for (int t = 0; t < NC; ++t) {
    qv[t] = dov[t] = acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row_ok) {
      const size_t off = (static_cast<size_t>(b) * sq + qi) * hq * DH +
                         static_cast<size_t>(h) * DH + 4 * (TPR * t + part);
      qv[t] = scale4(load4(q + off), scale);
      dov[t] = load4(dout + off);
      dpart += dot4(dov[t], load4(o + off));
    }
  }
  const float dl = row_sum<TPR>(dpart);
  const size_t row_idx = static_cast<size_t>(bh) * sq + qi;
  const float lse_i = row_ok ? lse[row_idx] : 0.f;
  if (row_ok && part == 0) dsum[row_idx] = dl;

  // keys that any row of this block may see (as in the forward)
  const int q_last = min(q0 + kRows, sq) - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  const int k_begin = window ? max(0, q0 - window + 1) : 0;

  for (int kbase = k_begin / kRows * kRows; kbase < k_end; kbase += kRows) {
    __syncthreads();  // the previous tile is consumed
    stage<DH>(ks, k, b, skv, kvh, hkv, kbase, 1.f);
    stage<DH>(vs, v, b, skv, kvh, hkv, kbase, 1.f);
    __syncthreads();
    const int n = min(kRows, k_end - kbase);
    for (int j = 0; j < n; ++j) {
      float sp = 0.f, dpp = 0.f;
#pragma unroll
      for (int t = 0; t < NC; ++t) {
        const int col = 4 * (TPR * t + part);
        sp += dot4(qv[t], *reinterpret_cast<const float4*>(&ks[j][col]));
        dpp += dot4(dov[t], *reinterpret_cast<const float4*>(&vs[j][col]));
      }
      const float sc = row_sum<TPR>(sp);
      const float dp = row_sum<TPR>(dpp);
      const int kp = kbase + j;
      const float p =
          kept(qi, kp, sq, skv, causal, window) ? expf(sc - lse_i) : 0.f;
      const float ds = p * (dp - dl);
#pragma unroll
      for (int t = 0; t < NC; ++t)
        fma4(acc[t], ds,
             *reinterpret_cast<const float4*>(&ks[j][4 * (TPR * t + part)]));
    }
  }

  if (row_ok) {
#pragma unroll
    for (int t = 0; t < NC; ++t) {
      const size_t off = (static_cast<size_t>(b) * sq + qi) * hq * DH +
                         static_cast<size_t>(h) * DH + 4 * (TPR * t + part);
      *reinterpret_cast<float4*>(dq + off) = scale4(acc[t], scale);
    }
  }
}

// dK and dV.  Block: (batch x KV head, key tile); thread TPR r + part owns
// the chunks {part, part + TPR, ...} of key row r, and sums over the
// group's query heads and every query tile the mask keeps.
template <int DH>
__global__ void __launch_bounds__(kRows * bwd_tpr<DH>())
    flash_bwd_dkv_fma_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ dsum,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int sq, int skv, int hq, int hkv, int causal,
                             int window, float scale) {
  constexpr int TPR = bwd_tpr<DH>();
  constexpr int NC = DH / (4 * TPR);
  extern __shared__ __align__(128) unsigned char flash_smem[];
  float(*qs)[DH] = reinterpret_cast<float(*)[DH]>(flash_smem);
  float(*dos)[DH] = qs + kRows;
  __shared__ float lse_s[kRows];
  __shared__ float d_s[kRows];

  const int bkh = blockIdx.x;
  const int b = bkh / hkv, kvh = bkh % hkv;
  const int qpk = hq / hkv;
  const int k0 = blockIdx.y * kRows;
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int kj = k0 + r;
  const bool row_ok = kj < skv;

  float4 kv_k[NC], kv_v[NC], dkacc[NC], dvacc[NC];
#pragma unroll
  for (int t = 0; t < NC; ++t) {
    kv_k[t] = kv_v[t] = dkacc[t] = dvacc[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row_ok) {
      const size_t off = (static_cast<size_t>(b) * skv + kj) * hkv * DH +
                         static_cast<size_t>(kvh) * DH + 4 * (TPR * t + part);
      kv_k[t] = load4(k + off);
      kv_v[t] = load4(v + off);
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
      stage<DH>(qs, q, b, sq, h, hq, qbase, scale);
      stage<DH>(dos, dout, b, sq, h, hq, qbase, 1.f);
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
          const int col = 4 * (TPR * t + part);
          sp += dot4(kv_k[t], *reinterpret_cast<const float4*>(&qs[i][col]));
          dpp += dot4(kv_v[t],
                      *reinterpret_cast<const float4*>(&dos[i][col]));
        }
        const float sc = row_sum<TPR>(sp);
        const float dp = row_sum<TPR>(dpp);
        const int qi = qbase + i;
        const float p = kept(qi, kj, sq, skv, causal, window)
                            ? expf(sc - lse_s[i]) : 0.f;
        const float ds = p * (dp - d_s[i]);
#pragma unroll
        for (int t = 0; t < NC; ++t) {
          const int col = 4 * (TPR * t + part);
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
                         static_cast<size_t>(kvh) * DH + 4 * (TPR * t + part);
      *reinterpret_cast<float4*>(dk + off) = dkacc[t];
      *reinterpret_cast<float4*>(dv + off) = dvacc[t];
    }
  }
}

// ================================================= bf16: tensor-core path

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;              // rows of a block, keys of a tile
constexpr int kThreads = 128;          // 4 warps, 16 rows each
constexpr int kPad = 8;                // bf16 padding a shared-memory row
constexpr int kSub = 32;               // keys (dq) or queries (dk/dv) a step
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy to shared memory; zero-fills when !full (the
// source address must still be valid).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a b: a 16x16 (row), b 16x8 (col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// two values (already bf16-exact, or rounded here) as one bf16x2 register,
// the lower column in the lower half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int DH>
using Tile = bf16[kTile][DH + kPad];

// Blocks an SM the tensor-core kernels are compiled for (the second
// argument of __launch_bounds__).  Below Dh = 128: 4 for the forward and
// 3 for the backward kernels, which caps them at 128 and 168 registers.
// With the tiles in dynamic shared memory and no cap, the forward at
// Dh = 64 took 136 registers, 3 blocks an SM, and lost 12% to the
// static-tile design's 128 registers and 4 blocks (0.0520 against 0.0466
// ms on an H100 at the rollout's shape, scripts/flash_same_bits.py); the
// caps give that back and let the dk/dv kernel run 3 blocks an SM (36
// bytes of spills), with the same bits.  At Dh = 128, no cap.
template <int DH>
__host__ __device__ constexpr int mma_min_blocks(bool forward) {
  return DH > 64 ? 1 : forward ? 4 : 3;
}

// Fragment loads from a row-major tile t.  Lane l supplies the address of
// one row of one of the four 8x8 matrices.
//
// load_a: the A fragment (16x16, row-major) of rows r0.. and columns c0..
template <int DH>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const Tile<DH>& t,
                                       int r0, int c0, int lane) {
  ldsm_x4(a, &t[r0 + (lane & 15)][c0 + (lane >> 4) * 8]);
}

// load_b_nk: B fragments of two n-tiles (n0 and n0 + 8: b[0..1], b[2..3])
// at k-step k0, from a tile stored [n][k] (rows are B's columns)
template <int DH>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4],
                                          const Tile<DH>& t, int n0, int k0,
                                          int lane) {
  ldsm_x4(b, &t[n0 + (lane & 7) + ((lane >> 4) << 3)]
               [k0 + ((lane >> 3) & 1) * 8]);
}

// load_b_kn: the same from a tile stored [k][n] (rows are B's rows)
template <int DH>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4],
                                          const Tile<DH>& t, int k0, int n0,
                                          int lane) {
  ldsm_x4_trans(b, &t[k0 + (lane & 7) + ((lane >> 3) & 1) * 8]
                     [n0 + (lane >> 4) * 8]);
}

// Start the copy of rows [row0, row0 + kTile) of a (B, S, H, DH) tensor at
// (b, h) into t; rows at or past s are zero.
template <int DH>
__device__ __forceinline__ void load_tile(Tile<DH>& t, const bf16* src,
                                          int b, int s, int h, int n_heads,
                                          int row0) {
  constexpr int CPR = DH / 8;  // 16-byte chunks a row
  for (int c = threadIdx.x; c < kTile * CPR; c += kThreads) {
    const int r = c / CPR, cc = c % CPR;
    const int row = row0 + r;
    const bool ok = row < s;
    cp_async16(&t[r][8 * cc],
               src + ((static_cast<size_t>(b) * s + (ok ? row : 0)) *
                          n_heads + h) * DH + 8 * cc,
               ok);
  }
}

// Write a block's output tile, staged in t, to rows [row0, row0 + kTile)
// of a (B, S, H, DH) tensor at (b, h), 16 bytes a thread at a time.
template <int DH>
__device__ __forceinline__ void store_tile(bf16* dst, const Tile<DH>& t,
                                           int b, int s, int h, int n_heads,
                                           int row0) {
  constexpr int CPR = DH / 8;
  for (int c = threadIdx.x; c < kTile * CPR; c += kThreads) {
    const int r = c / CPR, cc = c % CPR;
    const int row = row0 + r;
    if (row < s)
      *reinterpret_cast<uint4*>(
          dst + ((static_cast<size_t>(b) * s + row) * n_heads + h) * DH +
          8 * cc) = *reinterpret_cast<const uint4*>(&t[r][8 * cc]);
  }
}

// Stage a warp's accumulator fragments (rows w0 + g and w0 + g + 8, DH
// columns) times mul into t as bf16.
template <int DH>
__device__ __forceinline__ void stage_acc(Tile<DH>& t,
                                          const float (&acc)[DH / 8][4],
                                          int w0, int lane, float mul0,
                                          float mul1) {
  const int g = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) {
    *reinterpret_cast<__nv_bfloat162*>(&t[w0 + g][8 * nd + c]) =
        __floats2bfloat162_rn(acc[nd][0] * mul0, acc[nd][1] * mul0);
    *reinterpret_cast<__nv_bfloat162*>(&t[w0 + g + 8][8 * nd + c]) =
        __floats2bfloat162_rn(acc[nd][2] * mul1, acc[nd][3] * mul1);
  }
}

// Forward.  Block: (batch x query head, 64-row query tile), 4 warps of 16
// query rows; the block walks the 64-key tiles of its KV head that the
// mask keeps.
template <int DH>
__global__ void __launch_bounds__(kThreads, mma_min_blocks<DH>(true))
    flash_fwd_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         float* __restrict__ lse, int sq, int skv, int hq,
                         int hkv, int causal, int window, float scale) {
  constexpr int KD = DH / 16;     // k-steps over the head dim
  constexpr int ND = DH / 8;      // n-tiles over the head dim
  constexpr int NK = kTile / 8;   // n-tiles over a key tile
  extern __shared__ __align__(128) unsigned char flash_smem[];
  Tile<DH>* tiles = reinterpret_cast<Tile<DH>*>(flash_smem);
  Tile<DH>& qs = tiles[0];
  Tile<DH>* ks = tiles + 1;  // two buffers each
  Tile<DH>* vs = tiles + 3;

  const int lane = threadIdx.x & 31, w0 = 16 * (threadIdx.x >> 5);
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x, b = bh / hq, h = bh % hq;
  const int kvh = h / (hq / hkv);
  // the last query tiles see the most keys under a causal mask: start them
  // first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int qi0 = q0 + w0 + g, qi1 = qi0 + 8;  // this thread's two rows

  const int q_last = min(q0 + kTile, sq) - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  const int k_begin = window ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / kTile;
  const int t_end = k_end > k_begin ? (k_end + kTile - 1) / kTile : t_begin;

  load_tile<DH>(qs, q, b, sq, h, hq, q0);
  if (t_begin < t_end) {
    load_tile<DH>(ks[0], k, b, skv, kvh, hkv, t_begin * kTile);
    load_tile<DH>(vs[0], v, b, skv, kvh, hkv, t_begin * kTile);
  }
  cp_async_commit();

  uint32_t qf[KD][4];
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int it = t_begin; it < t_end; ++it) {
    const int buf = (it - t_begin) & 1;
    if (it + 1 < t_end) {
      load_tile<DH>(ks[buf ^ 1], k, b, skv, kvh, hkv, (it + 1) * kTile);
      load_tile<DH>(vs[buf ^ 1], v, b, skv, kvh, hkv, (it + 1) * kTile);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == t_begin) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) load_a<DH>(qf[kd], qs, w0, 16 * kd, lane);
    }
    const int kbase = it * kTile;

    // S = Q K^T, 16 rows x 64 keys a warp
    float s[NK][4];
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t bb[4];
        load_b_nk<DH>(bb, ks[buf], 16 * np, 16 * kd, lane);
        mma(s[2 * np], qf[kd], bb[0], bb[1]);
        mma(s[2 * np + 1], qf[kd], bb[2], bb[3]);
      }
    }

    // scale in f32, mask the edge tiles, and the rows' new maxima
    const bool edge = kbase + kTile > skv ||
                      (causal && kbase + kTile - 1 > q0) ||
                      (window && q_last - kbase >= window);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = kbase + 8 * nt + 2 * tq + e;
        float v0 = s[nt][e] * scale, v1 = s[nt][2 + e] * scale;
        if (edge) {
          if (!kept(qi0, kp, sq, skv, causal, window)) v0 = kNegInf;
          if (!kept(qi1, kp, sq, skv, causal, window)) v1 = kNegInf;
        }
        s[nt][e] = v0;
        s[nt][2 + e] = v1;
        mx0 = fmaxf(mx0, v0);
        mx1 = fmaxf(mx1, v1);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float c0 = exp2f((m0 - mx0) * kLog2e);
    const float c1 = exp2f((m1 - mx1) * kLog2e);
    m0 = mx0;
    m1 = mx1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      acc[nd][0] *= c0;
      acc[nd][1] *= c0;
      acc[nd][2] *= c1;
      acc[nd][3] *= c1;
    }

    // P rounded to bf16: the A fragments of P V (keys as k), and l
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
      float p[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        p[j][0] = round_bf16(exp2f((s[2 * kk + j][0] - m0) * kLog2e));
        p[j][1] = round_bf16(exp2f((s[2 * kk + j][1] - m0) * kLog2e));
        p[j][2] = round_bf16(exp2f((s[2 * kk + j][2] - m1) * kLog2e));
        p[j][3] = round_bf16(exp2f((s[2 * kk + j][3] - m1) * kLog2e));
        l0 += p[j][0] + p[j][1];
        l1 += p[j][2] + p[j][3];
      }
      const uint32_t pf[4] = {pack(p[0][0], p[0][1]), pack(p[0][2], p[0][3]),
                              pack(p[1][0], p[1][1]), pack(p[1][2], p[1][3])};
      // O += P V, V stored [key][d]
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        uint32_t bb[4];
        load_b_kn<DH>(bb, vs[buf], 16 * kk, 16 * np, lane);
        mma(acc[2 * np], pf, bb[0], bb[1]);
        mma(acc[2 * np + 1], pf, bb[2], bb[3]);
      }
    }
    __syncthreads();  // buffer buf is refilled two tiles on
  }

  // a row's l is spread over its 4 lanes
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    acc[nd][0] /= d0;
    acc[nd][1] /= d0;
    acc[nd][2] /= d1;
    acc[nd][3] /= d1;
  }
  if (lse != nullptr && tq == 0) {
    if (qi0 < sq) lse[static_cast<size_t>(bh) * sq + qi0] = m0 + logf(l0);
    if (qi1 < sq) lse[static_cast<size_t>(bh) * sq + qi1] = m1 + logf(l1);
  }
  cp_async_wait<0>();  // with no key tile, Q's copy may still be in flight
  __syncthreads();
  stage_acc<DH>(qs, acc, w0, lane, 1.f, 1.f);
  __syncthreads();
  store_tile<DH>(o, qs, b, sq, h, hq, q0);
}

// dQ and D = rowsum(dO * O).  Block: (batch x query head, 64-row query
// tile), 4 warps of 16 query rows, Q and dO held as A fragments; the block
// walks the key tiles the mask keeps, 32 keys a step.
template <int DH>
__global__ void __launch_bounds__(kThreads, mma_min_blocks<DH>(false))
    flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ o,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            float* __restrict__ dsum, bf16* __restrict__ dq,
                            int sq, int skv, int hq, int hkv, int causal,
                            int window, float scale) {
  constexpr int KD = DH / 16;
  constexpr int ND = DH / 8;
  constexpr int NS = kSub / 8;    // n-tiles over a step's keys
  extern __shared__ __align__(128) unsigned char flash_smem[];
  Tile<DH>* ks = reinterpret_cast<Tile<DH>*>(flash_smem);  // two buffers
  Tile<DH>* vs = ks + 2;
  __shared__ float lse_s[kTile], d_s[kTile];

  const int lane = threadIdx.x & 31, w0 = 16 * (threadIdx.x >> 5);
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x, b = bh / hq, h = bh % hq;
  const int kvh = h / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int qi0 = q0 + w0 + g, qi1 = qi0 + 8;

  // Q and dO through the second buffers into registers
  load_tile<DH>(ks[1], q, b, sq, h, hq, q0);
  load_tile<DH>(vs[1], dout, b, sq, h, hq, q0);
  cp_async_commit();
  {
    // D and lse of the tile's rows, two threads a row
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const int qi = q0 + r;
    float dpart = 0.f;
    if (qi < sq) {
      const size_t off = (static_cast<size_t>(b) * sq + qi) * hq * DH +
                         static_cast<size_t>(h) * DH + half * (DH / 2);
#pragma unroll
      for (int c = 0; c < DH / 16; ++c) {
        const uint4 ro = *reinterpret_cast<const uint4*>(o + off + 8 * c);
        const uint4 rd = *reinterpret_cast<const uint4*>(dout + off + 8 * c);
        const __nv_bfloat162* eo = reinterpret_cast<const __nv_bfloat162*>(&ro);
        const __nv_bfloat162* ed = reinterpret_cast<const __nv_bfloat162*>(&rd);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 fo = __bfloat1622float2(eo[j]);
          const float2 fd = __bfloat1622float2(ed[j]);
          dpart += fd.x * fo.x + fd.y * fo.y;
        }
      }
    }
    dpart += __shfl_xor_sync(0xffffffffu, dpart, 1);
    if (half == 0) {
      const size_t idx = static_cast<size_t>(bh) * sq + qi;
      d_s[r] = dpart;
      lse_s[r] = qi < sq ? lse[idx] : 0.f;
      if (qi < sq) dsum[idx] = dpart;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KD][4], dof[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    load_a<DH>(qf[kd], ks[1], w0, 16 * kd, lane);
    load_a<DH>(dof[kd], vs[1], w0, 16 * kd, lane);
  }
  const float lse0 = lse_s[w0 + g], lse1 = lse_s[w0 + g + 8];
  const float dd0 = d_s[w0 + g], dd1 = d_s[w0 + g + 8];
  __syncthreads();  // every warp holds its fragments: the buffers are free

  const int q_last = min(q0 + kTile, sq) - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  const int k_begin = window ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / kTile;
  const int t_end = k_end > k_begin ? (k_end + kTile - 1) / kTile : t_begin;
  if (t_begin < t_end) {
    load_tile<DH>(ks[0], k, b, skv, kvh, hkv, t_begin * kTile);
    load_tile<DH>(vs[0], v, b, skv, kvh, hkv, t_begin * kTile);
  }
  cp_async_commit();

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  for (int it = t_begin; it < t_end; ++it) {
    const int buf = (it - t_begin) & 1;
    if (it + 1 < t_end) {
      load_tile<DH>(ks[buf ^ 1], k, b, skv, kvh, hkv, (it + 1) * kTile);
      load_tile<DH>(vs[buf ^ 1], v, b, skv, kvh, hkv, (it + 1) * kTile);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int kbase = it * kTile;
    const bool edge = kbase + kTile > skv ||
                      (causal && kbase + kTile - 1 > q0) ||
                      (window && q_last - kbase >= window);

#pragma unroll
    for (int sub = 0; sub < kTile; sub += kSub) {
      // S = Q K^T and dP = dO V^T, 16 rows x 32 keys a warp
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t bb[4];
          load_b_nk<DH>(bb, ks[buf], sub + 16 * np, 16 * kd, lane);
          mma(s[2 * np], qf[kd], bb[0], bb[1]);
          mma(s[2 * np + 1], qf[kd], bb[2], bb[3]);
          load_b_nk<DH>(bb, vs[buf], sub + 16 * np, 16 * kd, lane);
          mma(dp[2 * np], dof[kd], bb[0], bb[1]);
          mma(dp[2 * np + 1], dof[kd], bb[2], bb[3]);
        }
      }
      // dS = P (dP - D), with P = exp(s - lse); as bf16 A fragments
      // (keys as k) of dQ += dS K
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        float ds[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int nt = 2 * kk + j;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = e < 2 ? qi0 : qi1;
            const int kp = kbase + sub + 8 * nt + 2 * tq + (e & 1);
            const float p =
                !edge || kept(qi, kp, sq, skv, causal, window)
                    ? exp2f((s[nt][e] * scale - (e < 2 ? lse0 : lse1)) *
                            kLog2e)
                    : 0.f;
            ds[j][e] = p * (dp[nt][e] - (e < 2 ? dd0 : dd1));
          }
        }
        const uint32_t df[4] = {pack(ds[0][0], ds[0][1]),
                                pack(ds[0][2], ds[0][3]),
                                pack(ds[1][0], ds[1][1]),
                                pack(ds[1][2], ds[1][3])};
#pragma unroll
        for (int np = 0; np < ND / 2; ++np) {
          uint32_t bb[4];
          load_b_kn<DH>(bb, ks[buf], sub + 16 * kk, 16 * np, lane);
          mma(acc[2 * np], df, bb[0], bb[1]);
          mma(acc[2 * np + 1], df, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // buffer buf is refilled two tiles on
  }

  cp_async_wait<0>();
  __syncthreads();
  stage_acc<DH>(ks[0], acc, w0, lane, scale, scale);
  __syncthreads();
  store_tile<DH>(dq, ks[0], b, sq, h, hq, q0);
}

// One step of the dk/dv kernel: start the copy of query head h's Q and dO
// rows [qbase, qbase + kTile) and load their lse and D (0 past sq).
template <int DH>
__device__ __forceinline__ void load_q_step(
    Tile<DH>& qd, Tile<DH>& dod, float* lse_d, float* d_d, const bf16* q,
    const bf16* dout, const float* lse, const float* dsum, int b, int sq,
    int h, int hq, int qbase) {
  load_tile<DH>(qd, q, b, sq, h, hq, qbase);
  load_tile<DH>(dod, dout, b, sq, h, hq, qbase);
  if (threadIdx.x < kTile) {
    const int qi = qbase + threadIdx.x;
    const size_t idx = (static_cast<size_t>(b) * hq + h) * sq + qi;
    lse_d[threadIdx.x] = qi < sq ? lse[idx] : 0.f;
    d_d[threadIdx.x] = qi < sq ? dsum[idx] : 0.f;
  }
}

// Whether the dk/dv kernel holds K and V as A fragments (2 Dh / 4
// registers a thread) beside its two Dh / 2-register accumulators; at
// Dh = 128 that would pass 255 registers, so it reads them from shared
// memory for every product instead.
template <int DH>
__host__ __device__ constexpr bool kv_in_regs() {
  return DH <= 64;
}

// bf16 tiles each kernel keeps in dynamic shared memory: Q and two K and
// two V buffers (forward); two K and two V buffers (dq); two Q and two dO
// buffers, and K and V where they are not held in registers (dk/dv)
constexpr int kFwdTiles = 5;
constexpr int kDqTiles = 4;
template <int DH>
constexpr int dkv_tiles() {
  return kv_in_regs<DH>() ? 4 : 6;
}

// dK and dV.  Block: (batch x KV head, 64-key tile), 4 warps of 16 keys,
// K and V held as A fragments (or read from their tiles, kv_in_regs); the
// block walks the group's query heads and, for each, the query tiles the
// mask keeps, 32 queries a step.
template <int DH>
__global__ void __launch_bounds__(kThreads, mma_min_blocks<DH>(false))
    flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ dsum,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             int sq, int skv, int hq, int hkv, int causal,
                             int window, float scale) {
  constexpr int KD = DH / 16;
  constexpr int ND = DH / 8;
  constexpr int NS = kSub / 8;    // n-tiles over a step's queries
  constexpr bool KV_REGS = kv_in_regs<DH>();
  extern __shared__ __align__(128) unsigned char flash_smem[];
  Tile<DH>* qs = reinterpret_cast<Tile<DH>*>(flash_smem);  // two buffers
  Tile<DH>* dos = qs + 2;
  // K and V: through the second buffers into registers, or in tiles of
  // their own for the whole kernel
  Tile<DH>& kt = *(qs + (KV_REGS ? 1 : 4));
  Tile<DH>& vt = *(qs + (KV_REGS ? 3 : 5));
  __shared__ float lse_s[2][kTile], d_s[2][kTile];

  const int lane = threadIdx.x & 31, w0 = 16 * (threadIdx.x >> 5);
  const int g = lane >> 2, tq = lane & 3;
  const int bkh = blockIdx.x, b = bkh / hkv, kvh = bkh % hkv;
  const int qpk = hq / hkv;
  // the first key tiles are seen by the most queries under a causal mask
  const int k0 = blockIdx.y * kTile;
  const int kj0 = k0 + w0 + g, kj1 = kj0 + 8;  // this thread's two keys

  load_tile<DH>(kt, k, b, skv, kvh, hkv, k0);
  load_tile<DH>(vt, v, b, skv, kvh, hkv, k0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[KV_REGS ? KD : 1][4], vf[KV_REGS ? KD : 1][4];
  if constexpr (KV_REGS) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      load_a<DH>(kf[kd], kt, w0, 16 * kd, lane);
      load_a<DH>(vf[kd], vt, w0, 16 * kd, lane);
    }
  }
  __syncthreads();

  // queries that may see a key of this tile
  const int k_last = min(k0 + kTile, skv) - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window ? min(sq, k_last + window) : sq;
  const int t_begin = q_begin / kTile;
  const int n_tiles =
      q_end > q_begin ? (q_end + kTile - 1) / kTile - t_begin : 0;
  const int n_steps = qpk * n_tiles;  // (query head, query tile) pairs

  if (n_steps > 0)
    load_q_step<DH>(qs[0], dos[0], lse_s[0], d_s[0], q, dout, lse, dsum, b,
                    sq, kvh * qpk, hq, t_begin * kTile);
  cp_async_commit();

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nd][e] = dva[nd][e] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    const int buf = i & 1;
    if (i + 1 < n_steps)
      load_q_step<DH>(qs[buf ^ 1], dos[buf ^ 1], lse_s[buf ^ 1],
                      d_s[buf ^ 1], q, dout, lse, dsum, b, sq,
                      kvh * qpk + (i + 1) / n_tiles, hq,
                      (t_begin + (i + 1) % n_tiles) * kTile);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int qbase = (t_begin + i % n_tiles) * kTile;
    const bool edge = k0 + kTile > skv || qbase + kTile > sq ||
                      (causal && qbase < k0 + kTile - 1) ||
                      (window && qbase + kTile - 1 - k0 >= window);

#pragma unroll
    for (int sub = 0; sub < kTile; sub += kSub) {
      // S^T = K Q^T and dP^T = V dO^T, 16 keys x 32 queries a warp
      float st[NS][4], dpt[NS][4];
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t ka[4], va[4];
        if constexpr (KV_REGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ka[e] = kf[kd][e];
            va[e] = vf[kd][e];
          }
        } else {
          load_a<DH>(ka, kt, w0, 16 * kd, lane);
          load_a<DH>(va, vt, w0, 16 * kd, lane);
        }
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t bb[4];
          load_b_nk<DH>(bb, qs[buf], sub + 16 * np, 16 * kd, lane);
          mma(st[2 * np], ka, bb[0], bb[1]);
          mma(st[2 * np + 1], ka, bb[2], bb[3]);
          load_b_nk<DH>(bb, dos[buf], sub + 16 * np, 16 * kd, lane);
          mma(dpt[2 * np], va, bb[0], bb[1]);
          mma(dpt[2 * np + 1], va, bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        // P^T = exp(s - lse) and dS^T = P^T (dP^T - D), queries as columns
        float p[2][4], ds[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int nt = 2 * kk + j;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = sub + 8 * nt + 2 * tq + (e & 1);
            const int kj = e < 2 ? kj0 : kj1;
            const float pe =
                !edge || kept(qbase + col, kj, sq, skv, causal, window)
                    ? exp2f((st[nt][e] * scale - lse_s[buf][col]) * kLog2e)
                    : 0.f;
            ds[j][e] = pe * (dpt[nt][e] - d_s[buf][col]);
            p[j][e] = pe;
          }
        }
        const uint32_t pf[4] = {pack(p[0][0], p[0][1]), pack(p[0][2], p[0][3]),
                                pack(p[1][0], p[1][1]), pack(p[1][2], p[1][3])};
        const uint32_t df[4] = {pack(ds[0][0], ds[0][1]),
                                pack(ds[0][2], ds[0][3]),
                                pack(ds[1][0], ds[1][1]),
                                pack(ds[1][2], ds[1][3])};
        // dV += P^T dO and dK += dS^T Q, dO and Q stored [query][d]
#pragma unroll
        for (int np = 0; np < ND / 2; ++np) {
          uint32_t bb[4];
          load_b_kn<DH>(bb, dos[buf], sub + 16 * kk, 16 * np, lane);
          mma(dva[2 * np], pf, bb[0], bb[1]);
          mma(dva[2 * np + 1], pf, bb[2], bb[3]);
          load_b_kn<DH>(bb, qs[buf], sub + 16 * kk, 16 * np, lane);
          mma(dka[2 * np], df, bb[0], bb[1]);
          mma(dka[2 * np + 1], df, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // buffer buf is refilled two steps on
  }

  cp_async_wait<0>();
  __syncthreads();
  stage_acc<DH>(qs[0], dka, w0, lane, scale, scale);
  stage_acc<DH>(dos[0], dva, w0, lane, 1.f, 1.f);
  __syncthreads();
  store_tile<DH>(dk, qs[0], b, skv, kvh, hkv, k0);
  store_tile<DH>(dv, dos[0], b, skv, kvh, hkv, k0);
}

// ================================================================ launches

// both paths share a grid: one block per 64 query rows or keys
static_assert(kBlockQ == kTile && kRows == kTile, "one tile size");

// Dh^-0.5 in double, rounded once to f32, as the Python side computes it
template <int DH>
float head_scale() {
  return static_cast<float>(1.0 / std::sqrt(static_cast<double>(DH)));
}

// Allow kernel `kernel` `bytes` of dynamic shared memory on the current
// device.  The attribute belongs to the device's context, so it is set on
// the first launch on each device: `on` holds one flag a device for one
// instantiation (a function-local static at the call site; a device past
// the 64th sets it on every launch).  A failure sets no flag and is
// returned to the wrapper, which raises.
// cudaFuncSetAttribute is not a stream operation, so a first launch under
// graph capture may set it too.
constexpr int kMaxDevices = 64;
using SmemAllowed = std::atomic<bool>[kMaxDevices];

template <typename... Args>
cudaError_t allow_smem(SmemAllowed& on, void (*kernel)(Args...), int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool tracked = dev >= 0 && dev < kMaxDevices;
  if (tracked && on[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && tracked)
    on[dev].store(true, std::memory_order_release);
  return err;
}

template <int DH>
constexpr int fma_smem() {  // two f32 tiles of kBlockK (= kRows) rows
  return 2 * kBlockK * DH * static_cast<int>(sizeof(float));
}

template <int DH>
constexpr int mma_smem(int tiles) {
  return tiles * static_cast<int>(sizeof(Tile<DH>));
}

template <int DH>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int b, int sq, int skv, int hq, int hkv,
                       int causal, int window, int dtype,
                       cudaStream_t stream) {
  const float scale = head_scale<DH>();
  const dim3 grid(b * hq, (sq + kTile - 1) / kTile);
  if (dtype == 0) {
    constexpr int smem = fma_smem<DH>();
    static SmemAllowed on;
    const cudaError_t allowed =
        allow_smem(on, flash_fwd_fma_kernel<DH>, smem);
    if (allowed != cudaSuccess) return allowed;
    flash_fwd_fma_kernel<DH><<<grid, kBlockQ * fwd_tpr<DH>(), smem,
                               stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, sq, skv,
        hq, hkv, causal, window, scale);
  } else {
    constexpr int smem = mma_smem<DH>(kFwdTiles);
    static SmemAllowed on;
    const cudaError_t allowed =
        allow_smem(on, flash_fwd_mma_kernel<DH>, smem);
    if (allowed != cudaSuccess) return allowed;
    flash_fwd_mma_kernel<DH><<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, sq, skv,
        hq, hkv, causal, window, scale);
  }
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* dsum, void* dq, void* dk, void* dv, int b,
                       int sq, int skv, int hq, int hkv, int causal,
                       int window, int dtype, cudaStream_t stream) {
  const float scale = head_scale<DH>();
  const dim3 grid_q(b * hq, (sq + kTile - 1) / kTile);
  const dim3 grid_kv(b * hkv, (skv + kTile - 1) / kTile);
  if (dtype == 0) {
    using T = float;
    constexpr int smem = fma_smem<DH>();
    constexpr int threads = kRows * bwd_tpr<DH>();
    static SmemAllowed on_dq;
    const cudaError_t allowed_dq =
        allow_smem(on_dq, flash_bwd_dq_fma_kernel<DH>, smem);
    if (allowed_dq != cudaSuccess) return allowed_dq;
    static SmemAllowed on_dkv;
    const cudaError_t allowed_dkv =
        allow_smem(on_dkv, flash_bwd_dkv_fma_kernel<DH>, smem);
    if (allowed_dkv != cudaSuccess) return allowed_dkv;
    flash_bwd_dq_fma_kernel<DH><<<grid_q, threads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(o),
        static_cast<const T*>(dout), lse, dsum, static_cast<T*>(dq), sq, skv,
        hq, hkv, causal, window, scale);
    flash_bwd_dkv_fma_kernel<DH><<<grid_kv, threads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum,
        static_cast<T*>(dk), static_cast<T*>(dv), sq, skv, hq, hkv, causal,
        window, scale);
  } else {
    using T = bf16;
    constexpr int smem_dq = mma_smem<DH>(kDqTiles);
    constexpr int smem_dkv = mma_smem<DH>(dkv_tiles<DH>());
    static SmemAllowed on_dq;
    const cudaError_t allowed_dq =
        allow_smem(on_dq, flash_bwd_dq_mma_kernel<DH>, smem_dq);
    if (allowed_dq != cudaSuccess) return allowed_dq;
    static SmemAllowed on_dkv;
    const cudaError_t allowed_dkv =
        allow_smem(on_dkv, flash_bwd_dkv_mma_kernel<DH>, smem_dkv);
    if (allowed_dkv != cudaSuccess) return allowed_dkv;
    flash_bwd_dq_mma_kernel<DH><<<grid_q, kThreads, smem_dq, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(o),
        static_cast<const T*>(dout), lse, dsum, static_cast<T*>(dq), sq, skv,
        hq, hkv, causal, window, scale);
    flash_bwd_dkv_mma_kernel<DH><<<grid_kv, kThreads, smem_dkv, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum,
        static_cast<T*>(dk), static_cast<T*>(dv), sq, skv, hq, hkv, causal,
        window, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (tensor-core kernel); dh
// in {16, 32, 64, 128}.  Pointers must be 16-byte aligned and the tensors
// contiguous; lse is null or (b, hq, sq) f32.  Returns the error of the
// kernel's shared-memory attribute, or cudaGetLastError() after the
// launch (0 on success).
extern "C" int firm_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, void* lse, int b,
                                    int sq, int skv, int hq, int hkv, int dh,
                                    int causal, int window, int dtype,
                                    void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (dh) {
    case 16:
      return static_cast<int>(launch_fwd<16>(q, k, v, o, l, b, sq, skv, hq,
                                             hkv, causal, window, dtype, s));
    case 32:
      return static_cast<int>(launch_fwd<32>(q, k, v, o, l, b, sq, skv, hq,
                                             hkv, causal, window, dtype, s));
    case 64:
      return static_cast<int>(launch_fwd<64>(q, k, v, o, l, b, sq, skv, hq,
                                             hkv, causal, window, dtype, s));
    case 128:
      return static_cast<int>(launch_fwd<128>(q, k, v, o, l, b, sq, skv, hq,
                                              hkv, causal, window, dtype, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Gradients of firm_flash_attention: dq, dk, dv (the inputs' shapes and
// dtype) given q, k, v, the forward's o and lse, and dout (o's shape).
// dsum is (b, hq, sq) f32 scratch for D = rowsum(dout * o).  Launches the
// dq kernel, then the dk/dv kernel, on the stream; returns the error of
// their shared-memory attributes, or cudaGetLastError() after both (0 on
// success).
extern "C" int firm_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dsum, void* dq, void* dk,
    void* dv, int b, int sq, int skv, int hq, int hkv, int dh, int causal,
    int window, int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  switch (dh) {
    case 16:
      return static_cast<int>(launch_bwd<16>(q, k, v, o, dout, l, ds, dq, dk,
                                             dv, b, sq, skv, hq, hkv, causal,
                                             window, dtype, s));
    case 32:
      return static_cast<int>(launch_bwd<32>(q, k, v, o, dout, l, ds, dq, dk,
                                             dv, b, sq, skv, hq, hkv, causal,
                                             window, dtype, s));
    case 64:
      return static_cast<int>(launch_bwd<64>(q, k, v, o, dout, l, ds, dq, dk,
                                             dv, b, sq, skv, hq, hkv, causal,
                                             window, dtype, s));
    case 128:
      return static_cast<int>(launch_bwd<128>(q, k, v, o, dout, l, ds, dq,
                                              dk, dv, b, sq, skv, hq, hkv,
                                              causal, window, dtype, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
