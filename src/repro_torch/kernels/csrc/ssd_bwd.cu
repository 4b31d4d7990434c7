// Backward of the Mamba2 SSD chunked scan for NVIDIA Hopper (sm_90a), with
// a plain C interface.
//
// Computes the gradient of what ssd.cu's forward computes (the scan body of
// src/repro/models/ssm.py:mamba2_seq, the Pallas TPU kernel
// src/repro/kernels/ssd.py:ssd_scan), which the JAX package takes by
// autodiff of the XLA scan.  Layout as the forward's:
//
//   x (B, S, nh, hd), B and C (B, S, ds), dt and da (B, S, nh), f32, read
//   through element strides; dy (B, S, nh, hd) and the optional d(final
//   state) (B, nh, hd, ds), contiguous f32.  Out, contiguous f32: dx
//   (B, S, nh, hd), dB and dC (B, S, ds), d(dt) and d(da) (B, S, nh).
//
// Per chunk of 128 positions, L the inclusive cumsum of da, g_ij =
// exp(L_i - L_j) for j <= i (else 0), S_ij = (C_i . B_j) g_ij dt_j, w_j =
// dt_j exp(L_end - L_j), h0 the state at the chunk's start and dh the
// gradient of the state at its end (the formulas of
// kernels/ref.py:ssd_chunked_bwd, which the CPU tests hold to autograd):
//
//   dS_ij = dy_i . x_j,  T_ij = dS_ij g_ij
//   dx_j  = sum_i S_ij dy_i + w_j (dh B_j)
//   dC_i  = sum_heads [sum_j T_ij dt_j B_j + exp(L_i) dy_i^T h0]
//   dB_j  = sum_heads [sum_i T_ij dt_j C_i + w_j x_j^T dh]
//   d(dt)_j = sum_i T_ij (C_i . B_j) + exp(L_end - L_j) dw_j,
//             dw_j = (x_j^T dh) . B_j
//   dL_i  = sum_j dS_ij S_ij - sum_k dS_ki S_ki + dy_i . y_inter_i
//           - dw_i w_i
//   d(da)_k = sum_{i >= k} dL_i + dL_end, summed from the chunk's end,
//             dL_end = sum_j dw_j w_j + exp(L_end) sum(dh * h0)
//   dh    <- exp(L_end) dh + sum_i exp(L_i) dy_i C_i^T
//
// Three launches a call, always:
//
// 1. states: one block a (batch row, head) runs the forward recurrence of
//    the state over the chunks and writes each chunk's starting state
//    (chunks 1..n-1; chunk 0 starts at zero), each thread a 4 x 4 tile of
//    it (1 x 4 at ds 16).  Recomputing them leaves the forward kernel and
//    its bits as they are.
// 2. sweep: one block a (batch row, group of 8 heads) walks the chunks
//    from last to first.  Per chunk it loads B and C and forms C B^T once
//    for the group; then for each head it loads x and dy and runs two
//    passes, each thread pair owning one position and each thread of the
//    pair one half of its 64-wide vectors, read 16 bytes at a time (a
//    tile's row holds its halves 4 floats apart, so that the pair's reads
//    fall in distinct banks): a row pass (i: dS over j <= i, the row sums
//    of dS S, dC, dy_i . y_inter_i) and a column pass (j: dS over i >= j,
//    dx, the column sums, d(dt), dB); then dL, d(da) and the new dh, each
//    thread a 4 x 4 tile of it (4 x 1 at ds 16).  Each head's dh lives in
//    device memory between chunks (L2-resident) and in shared memory while
//    the block works on the head (x^T dh, dh B_j, the new dh).  dB and dC
//    are summed over the group's heads in registers, in head order, and
//    stored as the group's partials.
// 3. reduce: dB and dC are the partials summed over the groups in group
//    order.
//
// f32 on the FMA pipes; no atomics: every sum runs in a fixed order, so
// the same inputs give the same bits, whatever their strides.  L is
// summed in order by one thread and every decay is expf of a difference
// formed before it, as in the forward kernel, so the decays have the
// forward's bits (|L| reaches ~1800 in a chunk, where one ulp of L moves
// a decay by ~1e-4).  Ragged S: positions past S load as zeros (so L
// stays at L[S - 1]) and no gradient is stored past S.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps; thread pairs own the positions
constexpr int kChunk = 128;
constexpr int kHd = 64;
constexpr int kGroup = 8;       // heads a sweep block
constexpr int kRowCB = kChunk + 1;   // C B^T's rows, a float apart in
                                     // banks

struct Strides {
  int xb, xs, xh;                // x: batch, position, head
  int bb, bs, cb, cs;            // B and C: batch, position
  int dtb, dts, dab, das;        // dt and da: batch, position (head: 1)
};

// Inclusive cumsum of L[0..128) in place, by one thread, in order: the
// forward kernel's scan_L (ssd.cu), so L has its bits and the plain
// version's.
__device__ __forceinline__ void scan_L(float* L) {
  float4* p = reinterpret_cast<float4*>(L);
  float run = 0.f;
#pragma unroll 8
  for (int k = 0; k < kChunk / 4; ++k) {
    float4 v = p[k];
    v.x = run = run + v.x;
    v.y = run = run + v.y;
    v.z = run = run + v.z;
    v.w = run = run + v.w;
    p[k] = v;
  }
}

__device__ __forceinline__ float neg_inf() {
  return __uint_as_float(0xff800000u);
}

// rows [0, 128) of a [128][COLS] tile with rows `ld` floats apart in
// shared memory, from src (row r at src + r * rstride); rows at or past
// n are zeros
template <int COLS>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* src,
                                          long long rstride, int n) {
#pragma unroll 1
  for (int e = threadIdx.x; e < kChunk * COLS; e += kThreads) {
    const int r = e / COLS, c = e % COLS;
    dst[r * ld + c] = r < n ? src[r * rstride + c] : 0.f;
  }
}

// one (B, S, nh) column of a chunk: dst[i] = src[b, c0 + i, h], zero
// past n
__device__ __forceinline__ void load_col(float* dst, const float* src,
                                         long long sb, long long ss,
                                         long long b, int c0, int h, int n) {
  for (int i = threadIdx.x; i < kChunk; i += kThreads)
    dst[i] = i < n ? src[b * sb + (c0 + i) * ss + h] : 0.f;
}

// ---------------------------------------------------------------- states
template <int DS>
struct StatesSmem {
  float x[kChunk * kHd];
  float b[kChunk * DS];
  float L[kChunk];
  float w[kChunk];
};

// h0[b, c - 1, h] = the state at the start of chunk c, for c = 1..n-1:
// state <- state exp(L_end) + sum_j (x_j w_j) B_j^T, as the forward; each
// thread a tile of kTd rows by 4 columns of the state, summed over j in
// order, element by element as fmaf(x w, B, acc).
template <int DS>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_states_kernel(const float* __restrict__ x,
                          const float* __restrict__ bm,
                          const float* __restrict__ dt,
                          const float* __restrict__ da,
                          float* __restrict__ h0, int seqlen, int nh,
                          Strides st) {
  constexpr int kTd = DS == 64 ? 4 : 1;
  constexpr int kTilesS = DS / 4;
  static_assert((kHd / kTd) * kTilesS == kThreads, "one tile a thread");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StatesSmem<DS>& sm = *reinterpret_cast<StatesSmem<DS>*>(smem_raw);
  const int tid = threadIdx.x;
  const long long b = blockIdx.x / nh;
  const int h = blockIdx.x % nh;
  const int nchunks = (seqlen + kChunk - 1) / kChunk;
  const int d0 = (tid / kTilesS) * kTd, s0 = (tid % kTilesS) * 4;
  float4 state[kTd];
#pragma unroll
  for (int a = 0; a < kTd; ++a) state[a] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c + 1 < nchunks; ++c) {
    const int c0 = c * kChunk;          // a full chunk: n = 128
    load_tile<kHd>(sm.x, kHd, x + b * st.xb + c0 * (long long)st.xs +
                   h * (long long)st.xh, st.xs, kChunk);
    load_tile<DS>(sm.b, DS, bm + b * st.bb + c0 * (long long)st.bs, st.bs,
                  kChunk);
    load_col(sm.L, da, st.dab, st.das, b, c0, h, kChunk);
    load_col(sm.w, dt, st.dtb, st.dts, b, c0, h, kChunk);
    __syncthreads();
    if (tid == 0) scan_L(sm.L);
    __syncthreads();
    const float lend = sm.L[kChunk - 1];
    if (tid < kChunk) sm.w[tid] = sm.w[tid] * expf(lend - sm.L[tid]);
    __syncthreads();
    float4 acc[kTd];
#pragma unroll
    for (int a = 0; a < kTd; ++a) acc[a] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
    for (int j = 0; j < kChunk; ++j) {
      const float wj = sm.w[j];
      const float4 b4 = *reinterpret_cast<const float4*>(sm.b + j * DS + s0);
      float xw[kTd];
      if constexpr (kTd == 4) {
        const float4 x4 =
            *reinterpret_cast<const float4*>(sm.x + j * kHd + d0);
        xw[0] = x4.x * wj; xw[1] = x4.y * wj;
        xw[2] = x4.z * wj; xw[3] = x4.w * wj;
      } else {
        xw[0] = sm.x[j * kHd + d0] * wj;
      }
#pragma unroll
      for (int a = 0; a < kTd; ++a) {
        acc[a].x = fmaf(xw[a], b4.x, acc[a].x);
        acc[a].y = fmaf(xw[a], b4.y, acc[a].y);
        acc[a].z = fmaf(xw[a], b4.z, acc[a].z);
        acc[a].w = fmaf(xw[a], b4.w, acc[a].w);
      }
    }
    // state e + new, each rounded, as the forward and the plain version
    const float e = expf(lend);
    float* out = h0 + ((b * (nchunks - 1) + c) * nh + h) * (kHd * DS);
#pragma unroll
    for (int a = 0; a < kTd; ++a) {
      float4& sa = state[a];
      sa.x = __fadd_rn(__fmul_rn(sa.x, e), acc[a].x);
      sa.y = __fadd_rn(__fmul_rn(sa.y, e), acc[a].y);
      sa.z = __fadd_rn(__fmul_rn(sa.z, e), acc[a].z);
      sa.w = __fadd_rn(__fmul_rn(sa.w, e), acc[a].w);
      *reinterpret_cast<float4*>(out + (d0 + a) * DS + s0) = sa;
    }
    __syncthreads();   // the next chunk's loads overwrite x, B, L and w
  }
}

// ----------------------------------------------------------------- sweep
// Tiles of 64 (or 16) columns are stored a row at a time as two halves of
// 32 (8) columns with 4 floats between them: a thread pair's two threads
// read their halves 16 bytes at a time from one row, in distinct banks.
template <int W>
struct Halves {
  static constexpr int kHalf = W / 2;           // columns a thread
  static constexpr int kOff = W / 2 + 4;        // where half 1 starts
  static constexpr int kRow = W + 4;            // floats a row
  static constexpr int kVec = W / 8;            // float4s a half
  __device__ __forceinline__ static int col(int c) {
    return c < kHalf ? c : c + 4;
  }
};

// rows [0, ROWS) of a [ROWS][W] tile stored as two halves, from src (row
// r at src + r * rstride); rows at or past n are zeros
template <int W, int ROWS = kChunk>
__device__ __forceinline__ void load_halves(float* dst, const float* src,
                                            long long rstride, int n) {
  using H = Halves<W>;
#pragma unroll 1
  for (int e = threadIdx.x; e < ROWS * W; e += kThreads) {
    const int r = e / W, c = e % W;
    dst[r * H::kRow + H::col(c)] = r < n ? src[r * rstride + c] : 0.f;
  }
}

template <int DS>
struct SweepSmem {
  float b[kChunk * Halves<DS>::kRow];   // B of the chunk, [j][s]
  float c[kChunk * Halves<DS>::kRow];   // C of the chunk, [i][s]
  float cb[kChunk * kRowCB];            // C B^T, [i][j], 0 above the diagonal
  float x[kChunk * Halves<kHd>::kRow];  // one head's x, [j][d]
  float dy[kChunk * Halves<kHd>::kRow]; // one head's dy, [i][d]
  float state[kHd * Halves<DS>::kRow];  // one head's dh at the chunk's end
  float L[kChunk];                      // inclusive cumsum of da
  float dt[kChunk];
  float el[kChunk];                     // exp(L_i)
  float w[kChunk];                      // dt_j exp(L_end - L_j)
  float rowp[kChunk];                   // sum_j dS_ij S_ij, then dL_i
  float colp[kChunk];                   // sum_i dS_ij S_ij
  float ydot[kChunk];                   // dy_i . y_inter_i
  float dww[kChunk];                    // dw_j w_j
  float red[kThreads];                  // a block's partial sums
};

// the sum of a pair's two halves, (half 0 + half 1) on both threads
__device__ __forceinline__ float pair_sum(float v, int p) {
  const float o = __shfl_xor_sync(0xffffffffu, v, 1);
  return p ? o + v : v + o;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& v) {
  acc.x = fmaf(a, v.x, acc.x);
  acc.y = fmaf(a, v.y, acc.y);
  acc.z = fmaf(a, v.z, acc.z);
  acc.w = fmaf(a, v.w, acc.w);
}

// a . b over the thread's half (N float4s), in four running sums, then
// (s0 + s1) + (s2 + s3)
template <int N>
__device__ __forceinline__ float dot_half(const float4 (&a)[N],
                                          const float* b) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int m = 0; m < N; ++m) {
    const float4 v = ld4(b + 4 * m);
    s0 = fmaf(a[m].x, v.x, s0);
    s1 = fmaf(a[m].y, v.y, s1);
    s2 = fmaf(a[m].z, v.z, s2);
    s3 = fmaf(a[m].w, v.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// u[s] (s in the thread's half of state columns) = sum_d a[d] m[d][s]:
// a a [128][64] shared-memory tile's row, m a (64, DS) state whose rows
// are MROW floats apart and whose half 1 starts MOFF floats into a row;
// 4 rows of m a step
template <int DS, int MROW, int MOFF>
__device__ __forceinline__ void row_times_state(float4 (&u)[DS / 8],
                                                const float* a,
                                                const float* m, int p) {
  using H = Halves<kHd>;
#pragma unroll
  for (int k = 0; k < DS / 8; ++k) u[k] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
  for (int d = 0; d < kHd; d += 4) {
    const float4 a4 = ld4(a + H::col(d));
    const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* mrow = m + (d + q) * MROW + p * MOFF;
#pragma unroll
      for (int k = 0; k < DS / 8; ++k) fma4(u[k], av[q], ld4(mrow + 4 * k));
    }
  }
}

template <int DS>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_sweep_kernel(const float* __restrict__ x,
                         const float* __restrict__ bm,
                         const float* __restrict__ cm,
                         const float* __restrict__ dt,
                         const float* __restrict__ da,
                         const float* __restrict__ dy,
                         const float* __restrict__ dstate,
                         const float* __restrict__ h0,
                         float* dh,               // read after written
                         float* __restrict__ dx, float* __restrict__ ddt,
                         float* __restrict__ dda, float* __restrict__ pdb,
                         float* __restrict__ pdc, int seqlen, int nh,
                         Strides st) {
  using HS = Halves<DS>;
  using HD = Halves<kHd>;
  constexpr int kVS = HS::kVec;                // float4s of a thread's s
  constexpr int kVD = HD::kVec;                // float4s of a thread's d
  constexpr int kState = kHd * DS;
  // the new dh: each thread a tile of kTd rows by 4 columns
  constexpr int kTd = DS == 64 ? 4 : 1;
  constexpr int kTilesS = DS / 4;
  static_assert((kHd / kTd) * kTilesS == kThreads, "one dh tile a thread");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SweepSmem<DS>& sm = *reinterpret_cast<SweepSmem<DS>*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int pos = tid >> 1, p = tid & 1;   // the pair's position, its half
  const int ngroups = (nh + kGroup - 1) / kGroup;
  const long long b = blockIdx.x / ngroups;
  const int grp = blockIdx.x % ngroups;
  const int h0_ = grp * kGroup, h1_ = min(nh, h0_ + kGroup);
  const int nchunks = (seqlen + kChunk - 1) / kChunk;
  const long long y_row = static_cast<long long>(nh) * kHd;
  const int td0 = (tid / kTilesS) * kTd, ts0 = (tid % kTilesS) * 4;

  // each head's dh starts at d(final state), or zero
  for (int h = h0_; h < h1_; ++h) {
    float* dhh = dh + (b * nh + h) * kState;
    const float* src = dstate ? dstate + (b * nh + h) * kState : nullptr;
    for (int e = tid; e < kState; e += kThreads) dhh[e] = src ? src[e] : 0.f;
  }

  for (int c = nchunks - 1; c >= 0; --c) {
    const int c0 = c * kChunk;
    const int n = min(kChunk, seqlen - c0);
    __syncthreads();   // dh initialised; the previous chunk is done
    load_halves<DS>(sm.b, bm + b * st.bb + c0 * (long long)st.bs, st.bs, n);
    load_halves<DS>(sm.c, cm + b * st.cb + c0 * (long long)st.cs, st.cs, n);
    __syncthreads();
    // C B^T once for the group, zero above the diagonal: consecutive
    // threads take consecutive j of one row i
#pragma unroll 1
    for (int e = tid; e < kChunk * kChunk; e += kThreads) {
      const int i = e / kChunk, j = e % kChunk;
      float acc = 0.f;
      if (j <= i) {
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
        for (int s = 0; s < DS; s += 4) {
          const float4 ci = ld4(sm.c + i * HS::kRow + HS::col(s));
          const float4 bj = ld4(sm.b + j * HS::kRow + HS::col(s));
          s0 = fmaf(ci.x, bj.x, s0);
          s1 = fmaf(ci.y, bj.y, s1);
          s2 = fmaf(ci.z, bj.z, s2);
          s3 = fmaf(ci.w, bj.w, s3);
        }
        acc = (s0 + s1) + (s2 + s3);
      }
      sm.cb[i * kRowCB + j] = acc;
    }

    // dC of row `pos` and dB of column `pos`, the thread's half of s,
    // summed over the group's heads in head order
    float4 dc_acc[kVS], db_acc[kVS];
#pragma unroll
    for (int k = 0; k < kVS; ++k)
      dc_acc[k] = db_acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);

    for (int h = h0_; h < h1_; ++h) {
      const float* xh = x + b * st.xb + c0 * (long long)st.xs +
                        h * (long long)st.xh;
      const float* dyh = dy + (b * seqlen + c0) * y_row + h * kHd;
      float* dhh = dh + (b * nh + h) * kState;
      const float* h0h = c > 0
          ? h0 + ((b * (nchunks - 1) + c - 1) * nh + h) * kState
          : nullptr;
      __syncthreads();   // C B^T stored; the previous head is done
      load_halves<kHd>(sm.x, xh, st.xs, n);
      load_halves<kHd>(sm.dy, dyh, y_row, n);
      load_halves<DS, kHd>(sm.state, dhh, DS, kHd);
      load_col(sm.L, da, st.dab, st.das, b, c0, h, n);
      load_col(sm.dt, dt, st.dtb, st.dts, b, c0, h, n);
      __syncthreads();
      if (tid == 0) scan_L(sm.L);
      __syncthreads();
      const float lend = sm.L[kChunk - 1];
      if (tid < kChunk) {
        sm.el[tid] = expf(sm.L[tid]);
        sm.w[tid] = sm.dt[tid] * expf(lend - sm.L[tid]);
      }
      __syncthreads();

      // ---- row pass: i = pos
      {
        const int i = pos;
        const float li = sm.L[i];
        const float* crow = sm.c + i * HS::kRow + p * HS::kOff;
        // u = dy_i^T h0 (the thread's half of s), then dy_i . y_inter_i
        // and dC
        float ydot = 0.f;
        if (h0h) {
          float4 u[kVS];
          row_times_state<DS, DS, DS / 2>(u, sm.dy + i * HD::kRow, h0h,
                                          p);
          ydot = sm.el[i] * pair_sum(dot_half<kVS>(u, crow), p);
#pragma unroll
          for (int k = 0; k < kVS; ++k) fma4(dc_acc[k], sm.el[i], u[k]);
        }
        float4 dyr[kVD];
#pragma unroll
        for (int k = 0; k < kVD; ++k)
          dyr[k] = ld4(sm.dy + i * HD::kRow + p * HD::kOff + 4 * k);
        float rowp = 0.f;
        // the warp's rows are 16 warp .. 16 warp + 15
        const int jmax = min(16 * warp + 15, n - 1);
#pragma unroll 1
        for (int j = 0; j <= jmax; ++j) {
          const float ds_ = pair_sum(
              dot_half<kVD>(dyr, sm.x + j * HD::kRow + p * HD::kOff), p);
          const float g = expf(j <= i ? li - sm.L[j] : neg_inf());
          const float s_ = sm.cb[i * kRowCB + j] * g * sm.dt[j];
          rowp = fmaf(ds_, s_, rowp);
          const float tdt = ds_ * g * sm.dt[j];
          const float* brow = sm.b + j * HS::kRow + p * HS::kOff;
#pragma unroll
          for (int k = 0; k < kVS; ++k)
            fma4(dc_acc[k], tdt, ld4(brow + 4 * k));
        }
        if (p == 0) {
          sm.rowp[i] = rowp;
          sm.ydot[i] = ydot;
        }
      }

      // ---- column pass: j = pos
      {
        const int j = pos;
        const float lj = sm.L[j], dtj = sm.dt[j], wj = sm.w[j];
        const float* brow = sm.b + j * HS::kRow + p * HS::kOff;
        float4 xr[kVD], dxa[kVD];
#pragma unroll
        for (int k = 0; k < kVD; ++k) {
          xr[k] = ld4(sm.x + j * HD::kRow + p * HD::kOff + 4 * k);
          dxa[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        float colp = 0.f, ddt_acc = 0.f;
        // the warp's columns are 16 warp .. 16 warp + 15
#pragma unroll 1
        for (int i = 16 * warp; i < n; ++i) {
          float4 dyv[kVD];
          const float* dyrow = sm.dy + i * HD::kRow + p * HD::kOff;
#pragma unroll
          for (int k = 0; k < kVD; ++k) dyv[k] = ld4(dyrow + 4 * k);
          float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
          for (int k = 0; k < kVD; ++k) {
            s0 = fmaf(xr[k].x, dyv[k].x, s0);
            s1 = fmaf(xr[k].y, dyv[k].y, s1);
            s2 = fmaf(xr[k].z, dyv[k].z, s2);
            s3 = fmaf(xr[k].w, dyv[k].w, s3);
          }
          const float ds_ = pair_sum((s0 + s1) + (s2 + s3), p);
          const float g = expf(i >= j ? sm.L[i] - lj : neg_inf());
          const float cbij = sm.cb[i * kRowCB + j];
          const float s_ = cbij * g * dtj;
          const float t_ = ds_ * g;
          colp = fmaf(ds_, s_, colp);
          ddt_acc = fmaf(t_, cbij, ddt_acc);
          const float tdt = t_ * dtj;
#pragma unroll
          for (int k = 0; k < kVD; ++k) fma4(dxa[k], s_, dyv[k]);
          const float* crow = sm.c + i * HS::kRow + p * HS::kOff;
#pragma unroll
          for (int k = 0; k < kVS; ++k)
            fma4(db_acc[k], tdt, ld4(crow + 4 * k));
        }
        // v = x_j^T dh (the thread's half of s), dw = v . B_j, dB
        float4 v[kVS];
        row_times_state<DS, HS::kRow, HS::kOff>(v, sm.x + j * HD::kRow,
                                                sm.state, p);
        const float dw = pair_sum(dot_half<kVS>(v, brow), p);
#pragma unroll
        for (int k = 0; k < kVS; ++k) fma4(db_acc[k], wj, v[k]);
        if (j < n) {
          // dh B_j for the thread's half of d, 4 columns of B a step
          float dhb[kHd / 2];
#pragma unroll
          for (int k = 0; k < kHd / 2; ++k) dhb[k] = 0.f;
          const float* bfull = sm.b + j * HS::kRow;
#pragma unroll 1
          for (int s = 0; s < DS; s += 4) {
            const float4 b4 = ld4(bfull + HS::col(s));
#pragma unroll
            for (int k = 0; k < kHd / 2; ++k) {
              const float4 h4 =
                  ld4(sm.state + (p * (kHd / 2) + k) * HS::kRow + HS::col(s));
              dhb[k] = fmaf(h4.x, b4.x, dhb[k]);
              dhb[k] = fmaf(h4.y, b4.y, dhb[k]);
              dhb[k] = fmaf(h4.z, b4.z, dhb[k]);
              dhb[k] = fmaf(h4.w, b4.w, dhb[k]);
            }
          }
          float4* dxp = reinterpret_cast<float4*>(
              dx + ((b * seqlen + c0 + j) * nh + h) * kHd + p * (kHd / 2));
#pragma unroll
          for (int k = 0; k < kVD; ++k)
            dxp[k] = make_float4(dxa[k].x + wj * dhb[4 * k],
                                 dxa[k].y + wj * dhb[4 * k + 1],
                                 dxa[k].z + wj * dhb[4 * k + 2],
                                 dxa[k].w + wj * dhb[4 * k + 3]);
          if (p == 0)
            ddt[(b * seqlen + c0 + j) * nh + h] =
                ddt_acc + expf(lend - lj) * dw;
        }
        if (p == 0) {
          sm.colp[j] = colp;
          sm.dww[j] = dw * wj;
        }
      }

      // ---- sum(dh * h0) over the thread's dh tile (before dh changes)
      float4 dht[kTd];
      float dhh0 = 0.f;
#pragma unroll
      for (int a = 0; a < kTd; ++a) {
        dht[a] = ld4(sm.state + (td0 + a) * HS::kRow + HS::col(ts0));
        if (h0h) {
          const float4 h4 = ld4(h0h + (td0 + a) * DS + ts0);
          dhh0 = fmaf(dht[a].x, h4.x, dhh0);
          dhh0 = fmaf(dht[a].y, h4.y, dhh0);
          dhh0 = fmaf(dht[a].z, h4.z, dhh0);
          dhh0 = fmaf(dht[a].w, h4.w, dhh0);
        }
      }
      sm.red[tid] = dhh0;
      __syncthreads();   // every read of the old dh is done
      if (tid < kChunk)
        sm.rowp[tid] = sm.rowp[tid] - sm.colp[tid] + sm.ydot[tid] -
                       sm.dww[tid];
      __syncthreads();
      // ---- d(da) by one thread from the chunk's end
      if (warp == 0) {
        // sum(dw w) and sum(dh * h0): each lane's share in order, then a
        // butterfly (every lane ends with the same sum)
        float sdw = 0.f, sdh = 0.f;
        for (int t = tid; t < kChunk; t += 32) sdw += sm.dww[t];
        for (int t = tid; t < kThreads; t += 32) sdh += sm.red[t];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          sdw += __shfl_xor_sync(0xffffffffu, sdw, off);
          sdh += __shfl_xor_sync(0xffffffffu, sdh, off);
        }
        if (tid == 0) {
          // d(da)_k = dL_end + sum_{i >= k} dL_i, from the end in order,
          // as autograd's reversed cumsum takes it
          const float4* dl = reinterpret_cast<const float4*>(sm.rowp);
          float* out = dda + (b * seqlen + c0) * nh + h;
          float run = sdw + expf(lend) * sdh;
#pragma unroll 4
          for (int q = kChunk / 4 - 1; q >= 0; --q) {
            const float4 v = dl[q];
            const int k = 4 * q;
            run = run + v.w;
            if (k + 3 < n) out[(k + 3) * nh] = run;
            run = run + v.z;
            if (k + 2 < n) out[(k + 2) * nh] = run;
            run = run + v.y;
            if (k + 1 < n) out[(k + 1) * nh] = run;
            run = run + v.x;
            if (k < n) out[k * nh] = run;
          }
        }
      }

      // ---- dh <- exp(L_end) dh + sum_i exp(L_i) dy_i C_i^T, the thread's
      // tile of kTd rows by 4 columns
      const float e = expf(lend);
      float4 acc[kTd];
#pragma unroll
      for (int a = 0; a < kTd; ++a) acc[a] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
      for (int i = 0; i < n; ++i) {
        const float eli = sm.el[i];
        const float4 c4 = ld4(sm.c + i * HS::kRow + HS::col(ts0));
        float dyd[kTd];
        if constexpr (kTd == 4) {
          const float4 d4 = ld4(sm.dy + i * HD::kRow + HD::col(td0));
          dyd[0] = d4.x; dyd[1] = d4.y; dyd[2] = d4.z; dyd[3] = d4.w;
        } else {
          dyd[0] = sm.dy[i * HD::kRow + HD::col(td0)];
        }
#pragma unroll
        for (int a = 0; a < kTd; ++a) fma4(acc[a], eli * dyd[a], c4);
      }
#pragma unroll
      for (int a = 0; a < kTd; ++a)
        *reinterpret_cast<float4*>(dhh + (td0 + a) * DS + ts0) = make_float4(
            __fadd_rn(__fmul_rn(dht[a].x, e), acc[a].x),
            __fadd_rn(__fmul_rn(dht[a].y, e), acc[a].y),
            __fadd_rn(__fmul_rn(dht[a].z, e), acc[a].z),
            __fadd_rn(__fmul_rn(dht[a].w, e), acc[a].w));
    }

    // the group's partial dB and dC of this chunk
    if (pos < n) {
      const long long row = ((b * ngroups + grp) * seqlen + c0 + pos) * DS +
                            p * (DS / 2);
#pragma unroll
      for (int k = 0; k < kVS; ++k) {
        *reinterpret_cast<float4*>(pdc + row + 4 * k) = dc_acc[k];
        *reinterpret_cast<float4*>(pdb + row + 4 * k) = db_acc[k];
      }
    }
  }
}

// ---------------------------------------------------------------- reduce
// dB and dC = their partials summed over the groups, in group order
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_reduce_kernel(const float* __restrict__ pdb,
                          const float* __restrict__ pdc,
                          float* __restrict__ dbm, float* __restrict__ dcm,
                          long long per_row, int ngroups, long long total) {
  const long long e = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  if (e >= 2 * total) return;
  const bool is_c = e >= total;
  const long long k = is_c ? e - total : e;
  const long long b = k / per_row, r = k % per_row;
  const float* src = (is_c ? pdc : pdb) + b * ngroups * per_row + r;
  float acc = 0.f;
  for (int g = 0; g < ngroups; ++g) acc += src[g * per_row];
  (is_c ? dcm : dbm)[k] = acc;
}

template <int DS>
cudaError_t configure() {
  static bool configured = false;
  if (configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_states_kernel<DS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(StatesSmem<DS>)));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_sweep_kernel<DS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(SweepSmem<DS>)));
  if (err == cudaSuccess) configured = true;
  return err;
}

template <int DS>
cudaError_t launch(const float* x, const float* bm, const float* cm,
                   const float* dt, const float* da, const float* dy,
                   const float* dstate, float* dx, float* dbm, float* dcm,
                   float* ddt, float* dda, float* h0, float* dh, float* pdb,
                   float* pdc, int batch, int seqlen, int nh,
                   const Strides& st, cudaStream_t stream) {
  cudaError_t err = configure<DS>();
  if (err != cudaSuccess) return err;
  ssd_bwd_states_kernel<DS><<<batch * nh, kThreads, sizeof(StatesSmem<DS>),
                              stream>>>(x, bm, dt, da, h0, seqlen, nh, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int ngroups = (nh + kGroup - 1) / kGroup;
  ssd_bwd_sweep_kernel<DS><<<batch * ngroups, kThreads,
                             sizeof(SweepSmem<DS>), stream>>>(
      x, bm, cm, dt, da, dy, dstate, h0, dh, dx, ddt, dda, pdb, pdc, seqlen,
      nh, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long per_row = static_cast<long long>(seqlen) * DS;
  const long long total = per_row * batch;
  const long long blocks = (2 * total + kThreads - 1) / kThreads;
  ssd_bwd_reduce_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(pdb, pdc, dbm, dcm, per_row, ngroups,
                                    total);
  return cudaGetLastError();
}

}  // namespace

// The number of head groups (sweep blocks a batch row) for nh heads, into
// *groups: the wrapper sizes the partials of dB and dC as (B, groups, S,
// ds).  Returns 0.
extern "C" int firm_ssd_bwd_groups(int nh, int* groups) {
  *groups = (nh + kGroup - 1) / kGroup;
  return 0;
}

// x, bm, cm, dt, da as firm_ssd_scan takes them; dy contiguous (B, S, nh,
// 64) f32; dstate contiguous (B, nh, 64, ds) f32 or null (zero).  Out,
// contiguous f32: dx (B, S, nh, 64), dbm and dcm (B, S, ds), ddt and dda
// (B, S, nh).  Scratch, contiguous f32: h0 (B, ceil(S / 128) - 1, nh, 64,
// ds), dh (B, nh, 64, ds), pdb and pdc (B, groups, S, ds).
// Three launches; returns cudaGetLastError() after them.
extern "C" int firm_ssd_scan_bwd(
    const void* x, const void* bm, const void* cm, const void* dt,
    const void* da, const void* dy, const void* dstate, void* dx, void* dbm,
    void* dcm, void* ddt, void* dda, void* h0, void* dh, void* pdb,
    void* pdc, int batch, int seqlen, int nh, int ds, int x_sb, int x_ss,
    int x_sh, int b_sb, int b_ss, int c_sb, int c_ss, int dt_sb, int dt_ss,
    int da_sb, int da_ss, void* stream) {
  if (batch <= 0 || seqlen <= 0 || nh <= 0 || batch > (1 << 24) / nh)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss,
                   dt_sb, dt_ss, da_sb, da_ss};
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto g = [](void* p) { return static_cast<float*>(p); };
  const auto s = static_cast<cudaStream_t>(stream);
  switch (ds) {
    case 16:
      return static_cast<int>(launch<16>(
          f(x), f(bm), f(cm), f(dt), f(da), f(dy), f(dstate), g(dx), g(dbm),
          g(dcm), g(ddt), g(dda), g(h0), g(dh), g(pdb), g(pdc), batch,
          seqlen, nh, st, s));
    case 64:
      return static_cast<int>(launch<64>(
          f(x), f(bm), f(cm), f(dt), f(da), f(dy), f(dstate), g(dx), g(dbm),
          g(dcm), g(ddt), g(dda), g(h0), g(dh), g(pdb), g(pdc), batch,
          seqlen, nh, st, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
