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
// exp(L_i - L_j) for j <= i (else 0), CB_ij = C_i . B_j, S_ij = CB_ij g_ij
// dt_j, w_j = dt_j exp(L_end - L_j), h0 the state at the chunk's start and
// dh the gradient of the state at its end (the formulas of
// kernels/ref.py:ssd_chunked_bwd, which the CPU tests hold to autograd):
//
//   dS_ij = dy_i . x_j,  T_ij = dS_ij g_ij,  G_ij = sum_heads T_ij dt_j
//   dx_j  = sum_i S_ij dy_i + w_j (dh B_j)
//   dC_i  = sum_j G_ij B_j + sum_heads exp(L_i) u_i,  u_i = dy_i^T h0
//   dB_j  = sum_i G_ij C_i + sum_heads w_j v_j,       v_j = x_j^T dh
//   d(dt)_j = sum_i T_ij CB_ij + exp(L_end - L_j) dw_j,  dw_j = v_j . B_j
//   dL_i  = sum_j dS_ij S_ij - sum_k dS_ki S_ki + exp(L_i) u_i . C_i
//           - dw_i w_i
//   d(da)_k = sum_{i >= k} dL_i + dL_end, summed from the chunk's end,
//             dL_end = sum_j dw_j w_j + exp(L_end) sum(dh * h0)
//   chunk boundaries: h0 <- h0 exp(L_end) + sum_j (x_j w_j) B_j^T forward,
//                     dh <- dh exp(L_end) + sum_i exp(L_i) dy_i C_i^T back
//
// What bounds it on the H100: bytes, once the products run on tensor
// cores.  At the training shape (B = 16, S = 256, nh = 64, hd = ds = 64)
// the function moves 210 MB (63 us at 3.35 TB/s) and needs 15.2 GFLOP: 31
// us at 495 TFLOP/s TF32, 92 us as three TF32 products a product, 226 us
// on the FMA pipes.  The first design (f32 on the FMA pipes, one block of
// 8 warps an SM walking the chunks in order, dS computed twice, dB and dC
// summed per head, the chunk-start state read from device memory by every
// position) took 1.85 ms.
//
// This design, three launches a call:
//
// 1. states: the serial chunk dependence, and nothing else.  One block of
//    8 warps a (batch row, group of 8 heads) and direction: forward,
//    every chunk's starting state h0 (stored transposed, [s][d]);
//    backward, every chunk's end-state gradient dh but the last's (which
//    is d(final state), or zero).  Each (chunk, head)'s share is one
//    (64 x 128)(128 x ds) product on tensor cores, chained as state <-
//    state exp(L_end) + share, each step rounded as the plain version
//    rounds it; the next head's x or dy is copied in while it runs, and
//    two blocks of 8 warps fit an SM (107,520 bytes of shared memory at
//    ds = 64), so the 256 blocks of the training shape run as one wave.
// 2. chunk: one block of 8 warps a (batch row, group of 8 heads, chunk);
//    nothing carries between chunks, so the chunks run in parallel.  The
//    block stages C and B, every head's da (whose cumsum L one thread a
//    head takes, all heads at once) and dt, then forms C B^T once for the
//    group, each warp keeping its 9 tiles in registers across the heads.
//    For each head, with its x, dy, h0 and dh staged in shared memory:
//    (a) dS^T = x dy^T once, on the warp's 9 tiles; from its fragments,
//        element by element: g, S, T, S^T to shared memory, the row and
//        column sums of dS S, sum_i T CB, and G += T dt in registers;
//    (b) u = dy h0: dy_i . y_inter_i's sums and dC += exp(L_i) u_i;
//    (c) v = x dh: dw_j's sums and dB += w_j v_j;
//    (d) dx = S^T dy + (w B) dh^T, stored;
//    then dL and d(dt) of every position; x and h0 of the next head are
//    copied in (cp.async) while (d) runs, its dy and dh while dL is
//    formed.  After the heads: each head's d(da) by one thread, all heads
//    at once, and dC += G B and dB += G^T C once for the group, stored as
//    the group's partials.
// 3. reduce: dB and dC are the partials summed over the groups in group
//    order.
//
// * Tensor cores.  Every product is mma.sync.m16n8k8 on TF32 operands with
//   f32 accumulators, split (hi = tf32(v), lo = tf32(v - hi); hi hi + hi lo
//   + lo hi) as ssd.cu splits its products, which holds them to f32's
//   error (tests/test_torch_ssd_bwd_rules.py models this arithmetic on the
//   CPU, single TF32 included).  dS^T and C B^T are formed in the [j][i]
//   layout (rows the key position j, columns the query i), so that their
//   accumulators, stored with the k index permuted (even i to the first
//   four columns of an 8-wide step, odd to the last four), are the
//   A fragments of S^T dy and G^T C with no shuffle.
// * 8 warps and 224,640 bytes of shared memory a block at ds = 64 (C, B,
//   one head's x, dy, h0 and dh, S^T's tiles, every head's L, dt and dL,
//   the sums), so one block an SM: the tiles a head needs at once take
//   ~196 KB, more than two blocks could have; a group of 8 heads, not 4,
//   halves the group's own work (C B^T, G B, G^T C, the copies of C and B)
//   a head at the same number of blocks an SM.  Warps q and q + 4 share
//   the 16-row slabs q and 7 - q (18 causal tiles a pair, 9 a warp), and
//   each takes half of the columns of every 128-row product.  Tiles are
//   XOR-swizzled in 16-byte units (no padding), so that the fragment loads
//   are free of bank conflicts at ds = 64 (but for v's A operand and G^T's
//   reads for G^T C, 2-way).
// * L by one thread a head in order, with the forward kernel's scan_L, and
//   every decay expf of a difference masked to -inf before exp, so the
//   decays have the forward's bits (|L| reaches ~1800 in a chunk, where
//   one ulp of L moves a decay by ~1e-4); d(da) summed in order from the
//   chunk's end, as autograd's flipped cumsum takes it (its terms cancel).
//
// No atomics: every sum runs in a fixed order, so the same inputs give the
// same bits, whatever their strides.  Ragged S: positions past S load as
// zeros (so L stays at L[S - 1]) and no gradient is stored past S.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // 8 warps a chunk block
constexpr int kPreThreads = 256;   // 8 warps a states block
constexpr int kChunk = 128;
constexpr int kHd = 64;
constexpr int kGroup = 8;          // heads a chunk block
constexpr int kTiles = 72;         // 16 x 8 tiles of a [j][i] matrix with
                                   // i >= j somewhere in them

struct Strides {
  int xb, xs, xh;                  // x: batch, position, head
  int bb, bs, cb, cs;              // B and C: batch, position
  int dtb, dts, dab, das;          // dt and da: batch, position (head: 1)
};

// Element offset of (row, col) in a [rows][COLS] f32 tile whose 16-byte
// units are XOR-swizzled by row (ssd.cu's swz).
template <int COLS>
__device__ __forceinline__ int swz(int row, int col) {
  static_assert(COLS == 64 || COLS == 16, "64 or 16 columns");
  if constexpr (COLS == 64) return row * 64 + (col ^ ((row & 7) << 2));
  return row * COLS + (col ^ (((row >> 1) & 3) << 2));
}

// G^T's [128][128] tile after the heads: units XOR-swizzled by row & 7
__device__ __forceinline__ int gidx(int row, int col) {
  return row * kChunk + ((((col >> 2) ^ (row & 7)) << 2) | (col & 3));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// asynchronous copies to shared memory; zero-fill when !full (the source
// address must still be valid)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [0, rows) of a tile from src (row r at src + r * rstride) by NT
// threads; rows at or past nvalid are zeros.  vec: 16-byte copies
// (aligned rows).
template <int COLS, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long rstride, int rows,
                                          int nvalid, bool vec) {
  if (vec) {
    constexpr int kUnits = COLS / 4;
#pragma unroll 1
    for (int e = threadIdx.x; e < rows * kUnits; e += NT) {
      const int r = e / kUnits, c = (e % kUnits) * 4;
      const bool in = r < nvalid;
      cp_async16(dst + swz<COLS>(r, c), in ? src + r * rstride + c : src,
                 in);
    }
  } else {
#pragma unroll 1
    for (int e = threadIdx.x; e < rows * COLS; e += NT) {
      const int r = e / COLS, c = e % COLS;
      const bool in = r < nvalid;
      cp_async4(dst + swz<COLS>(r, c), in ? src + r * rstride + c : src, in);
    }
  }
}

__device__ __forceinline__ float neg_inf() {
  return __uint_as_float(0xff800000u);
}

// v rounded to TF32 as cvt.rna.tf32.f32 rounds a finite value (ssd.cu's
// tf32)
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo, both TF32
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

// d += a b: a 16x8 (row), b 8x8 (col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b on split operands: the small terms first, then hi hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d, al, bh[0], bh[1]);
  mma(d, ah, bl[0], bl[1]);
  mma(d, ah, bh[0], bh[1]);
}

// d[j] += a b[j] for j < N on split operands, in the order of mma3, the
// N accumulators' products interleaved
template <int N>
__device__ __forceinline__ void mma3n(float (&d)[N][4],
                                      const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4],
                                      const uint32_t (&bh)[N][2],
                                      const uint32_t (&bl)[N][2]) {
#pragma unroll
  for (int j = 0; j < N; ++j) mma(d[j], al, bh[j][0], bh[j][1]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma(d[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma(d[j], ah, bh[j][0], bh[j][1]);
}

// Fragments, split.  g = lane / 4, t = lane % 4.
// A of rows r0.. r0 + 15 of a [rows][COLS] tile, k = columns k0 + t and
// k0 + t + 4, each value times sc1 (row r0 + g) or sc2 (row r0 + g + 8)
template <int COLS>
__device__ __forceinline__ void frag_a(const float* m, int r0, int k0, int g,
                                       int t, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4], float sc1 = 1.f,
                                       float sc2 = 1.f) {
  split(m[swz<COLS>(r0 + g, k0 + t)] * sc1, hi[0], lo[0]);
  split(m[swz<COLS>(r0 + g + 8, k0 + t)] * sc2, hi[1], lo[1]);
  split(m[swz<COLS>(r0 + g, k0 + t + 4)] * sc1, hi[2], lo[2]);
  split(m[swz<COLS>(r0 + g + 8, k0 + t + 4)] * sc2, hi[3], lo[3]);
}

// A as frag_a, k permuted: k slots t and t + 4 are columns k0 + 2t and
// k0 + 2t + 1
template <int COLS>
__device__ __forceinline__ void frag_ap(const float* m, int r0, int k0,
                                        int g, int t, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  const int k = k0 + 2 * t;
  split(m[swz<COLS>(r0 + g, k)], hi[0], lo[0]);
  split(m[swz<COLS>(r0 + g + 8, k)], hi[1], lo[1]);
  split(m[swz<COLS>(r0 + g, k + 1)], hi[2], lo[2]);
  split(m[swz<COLS>(r0 + g + 8, k + 1)], hi[3], lo[3]);
}

// B with n = row n0 + g of the tile and k = columns k0 + t, k0 + t + 4
template <int COLS>
__device__ __forceinline__ void frag_b(const float* m, int n0, int k0, int g,
                                       int t, uint32_t (&hi)[2],
                                       uint32_t (&lo)[2]) {
  split(m[swz<COLS>(n0 + g, k0 + t)], hi[0], lo[0]);
  split(m[swz<COLS>(n0 + g, k0 + t + 4)], hi[1], lo[1]);
}

// B with k over rows, permuted (k slots t and t + 4 are rows k0 + 2t and
// k0 + 2t + 1), n = column n0 + g
template <int COLS>
__device__ __forceinline__ void frag_bp(const float* m, int k0, int n0,
                                        int g, int t, uint32_t (&hi)[2],
                                        uint32_t (&lo)[2]) {
  split(m[swz<COLS>(k0 + 2 * t, n0 + g)], hi[0], lo[0]);
  split(m[swz<COLS>(k0 + 2 * t + 1, n0 + g)], hi[1], lo[1]);
}

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

// the sum over the 4 lanes of a row of fragments (t), on each of them
__device__ __forceinline__ float sum_t(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the sum over the 32 lanes, on each of them
__device__ __forceinline__ float sum_warp(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------- states
template <int DS>
struct StatesSmem {
  float a[2][kChunk * kHd];        // x (forward) or dy (backward) of two
                                   // heads, [pos][d], swizzled
  float m[kChunk * DS];            // B (forward) or C (backward), [pos][s]
  float L[kGroup * kChunk];        // every head's inclusive cumsum of da
  float dt[kGroup * kChunk];       // every head's dt (forward)
  float w[2][kChunk];              // forward dt_j exp(L_end - L_j); back
                                   // exp(L_i); by head parity
};

// Blocks [0, B G): h0t[b, c - 1, h] = the state at the start of chunk c
// (c = 1..n-1), transposed ([s][d]).  Blocks [B G, 2 B G): dhs[b, c, h] =
// the gradient of the state at the end of chunk c (c = 0..n-2), [d][s].
// G = ceil(nh / 8): a block takes a group of 8 heads, walking the chunks
// in its direction and, in each, the heads in order: B or C and every
// head's da (and dt) are copied once a chunk, L of every head summed at
// once (one thread a head), and each head's x or dy is copied in while
// the previous head's share is computed.  The share is one split TF32
// product over the chunk's 128 positions, each warp DS/16 of the state's
// 16 x 8 tiles; the state before it is read back from where the same
// thread wrote it (the previous chunk's output; zero, or d(final state),
// at the start).
template <int DS>
__global__ void __launch_bounds__(kPreThreads, 2)
    ssd_bwd_states_kernel(const float* __restrict__ x,
                          const float* __restrict__ bm,
                          const float* __restrict__ cm,
                          const float* __restrict__ dt,
                          const float* __restrict__ da,
                          const float* __restrict__ dy,
                          const float* __restrict__ dstate,
                          float* __restrict__ h0t, float* __restrict__ dhs,
                          int seqlen, int nh, Strides st, bool vec) {
  constexpr int KT = DS / 16;      // the warp's tiles
  constexpr long long kState = kHd * DS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StatesSmem<DS>& sm = *reinterpret_cast<StatesSmem<DS>*>(smem_raw);
  const int nc = (seqlen + kChunk - 1) / kChunk;
  if (nc < 2) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ngroups = (nh + kGroup - 1) / kGroup;
  const int nbg = gridDim.x / 2;
  const bool fwd = static_cast<int>(blockIdx.x) < nbg;
  const int bg = fwd ? blockIdx.x : blockIdx.x - nbg;
  const long long b = bg / ngroups;
  const int hlo = (bg % ngroups) * kGroup, nhg = min(nh - hlo, kGroup);
  // the state: forward transposed, [s][d] (8 column tiles a row of
  // tiles), backward [d][s] (DS / 8); the warp's KT tiles are rows 16 mt..
  // and columns 8 (nt0 + j), j < KT
  const int ld = fwd ? kHd : DS;
  const int mt = warp * KT / (ld / 8), nt0 = warp * KT % (ld / 8);
  const long long row = static_cast<long long>(nh) * kHd;

  for (int step = 0; step + 1 < nc; ++step) {
    const int c = fwd ? step : nc - 1 - step;    // the chunk whose share
    const int c0 = c * kChunk;                   // is added
    const int n = min(kChunk, seqlen - c0);
    auto load_a = [&](int k, int buf) {
      if (fwd)
        load_rows<kHd, kPreThreads>(
            sm.a[buf], x + b * st.xb + c0 * (long long)st.xs +
                           (hlo + k) * (long long)st.xh, st.xs, kChunk, n,
            vec);
      else
        load_rows<kHd, kPreThreads>(sm.a[buf], dy + (b * seqlen + c0) * row +
                                                   (hlo + k) * kHd, row,
                                    kChunk, n, true);
    };
    // ---- copies: B or C, every head's da (and dt), the first head's tile
    if (fwd)
      load_rows<DS, kPreThreads>(sm.m, bm + b * st.bb + c0 * (long long)st.bs,
                                 st.bs, kChunk, n, vec);
    else
      load_rows<DS, kPreThreads>(sm.m, cm + b * st.cb + c0 * (long long)st.cs,
                                 st.cs, kChunk, n, vec);
#pragma unroll 1
    for (int e = tid; e < kGroup * kChunk; e += kPreThreads) {
      const int k = e / kChunk, i = e % kChunk;
      const bool in = i < n && k < nhg;
      const long long pos = in ? c0 + i : 0;
      cp_async4(sm.L + e, da + b * st.dab + pos * st.das + (in ? hlo + k : 0),
                in);
      if (fwd)
        cp_async4(sm.dt + e,
                  dt + b * st.dtb + pos * st.dts + (in ? hlo + k : 0), in);
    }
    load_a(0, 0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (tid < nhg) scan_L(sm.L + tid * kChunk);
    __syncthreads();

#pragma unroll 1
    for (int k = 0; k < nhg; ++k) {
      const int h = hlo + k, buf = k & 1;
      if (k + 1 < nhg) {       // the next head's tile, while this one runs
        load_a(k + 1, buf ^ 1);
        cp_async_commit();
      }
      const float* Lk = sm.L + k * kChunk;
      const float lend = Lk[kChunk - 1];
      if (tid < kChunk)
        sm.w[buf][tid] = fwd ? sm.dt[k * kChunk + tid] *
                                   expf(lend - Lk[tid])
                             : expf(Lk[tid]);
      if (k + 1 < nhg)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();         // this head's tile and w are in
      const float* a = sm.a[buf];
      const float* wk = sm.w[buf];
      float acc[KT][4];
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
#pragma unroll 2
      for (int ks = 0; ks < kChunk / 8; ++ks) {
        const int j1 = 8 * ks + 2 * t, j2 = j1 + 1;   // k permuted
        const float w1 = wk[j1], w2 = wk[j2];
        uint32_t ah[4], al[4], bh[KT][2], bl[KT][2];
        if (fwd) {
          // share^T = B^T (x w): A = B^T, B = x w
          const int s0 = 16 * mt + g;
          split(sm.m[swz<DS>(j1, s0)], ah[0], al[0]);
          split(sm.m[swz<DS>(j1, s0 + 8)], ah[1], al[1]);
          split(sm.m[swz<DS>(j2, s0)], ah[2], al[2]);
          split(sm.m[swz<DS>(j2, s0 + 8)], ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < KT; ++j) {
            const int d = 8 * (nt0 + j) + g;
            split(a[swz<kHd>(j1, d)] * w1, bh[j][0], bl[j][0]);
            split(a[swz<kHd>(j2, d)] * w2, bh[j][1], bl[j][1]);
          }
        } else {
          // share = (dy exp(L))^T C: A = (dy exp(L))^T, B = C
          const int d0 = 16 * mt + g;
          split(a[swz<kHd>(j1, d0)] * w1, ah[0], al[0]);
          split(a[swz<kHd>(j1, d0 + 8)] * w1, ah[1], al[1]);
          split(a[swz<kHd>(j2, d0)] * w2, ah[2], al[2]);
          split(a[swz<kHd>(j2, d0 + 8)] * w2, ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < KT; ++j) {
            const int s = 8 * (nt0 + j) + g;
            split(sm.m[swz<DS>(j1, s)], bh[j][0], bl[j][0]);
            split(sm.m[swz<DS>(j2, s)], bh[j][1], bl[j][1]);
          }
        }
        mma3n<KT>(acc, ah, al, bh, bl);
      }
      // state e + share, each rounded, as the plain version has it; the
      // state before it where this thread wrote it
      const float e = expf(lend);
      const float* prev = nullptr;
      if (fwd && c > 0)
        prev = h0t + ((b * (nc - 1) + c - 1) * nh + h) * kState;
      else if (!fwd && c + 1 < nc)
        prev = dhs + ((b * (nc - 1) + c) * nh + h) * kState;
      else if (!fwd && dstate)
        prev = dstate + (b * nh + h) * kState;
      float* out = fwd ? h0t + ((b * (nc - 1) + c) * nh + h) * kState
                       : dhs + ((b * (nc - 1) + c - 1) * nh + h) * kState;
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int o = (16 * mt + g + 8 * hf) * ld + 8 * (nt0 + j) + 2 * t;
          const float2 old = prev ? *reinterpret_cast<const float2*>(prev + o)
                                  : make_float2(0.f, 0.f);
          *reinterpret_cast<float2*>(out + o) = make_float2(
              __fadd_rn(__fmul_rn(old.x, e), acc[j][2 * hf]),
              __fadd_rn(__fmul_rn(old.y, e), acc[j][2 * hf + 1]));
        }
      __syncthreads();         // the tile and w buffers are free again
    }
  }
}

// ----------------------------------------------------------------- chunk
template <int DS>
struct ChunkSmem {
  float c[kChunk * DS];            // C of the chunk, [i][s], swizzled
  float b[kChunk * DS];            // B of the chunk, [j][s], swizzled
  union {
    struct {
      float x[kChunk * kHd];       // one head's x, [j][d], swizzled
      float dy[kChunk * kHd];      // one head's dy, [i][d], swizzled
    } in;                          // the heads
    float gt[kChunk * kChunk];     // G^T, [j][i] (gidx), after them
  } u;
  float h0t[DS * kHd];             // one head's chunk-start state, [s][d]
  float dh[kHd * DS];              // one head's end-state gradient, [d][s]
  float4 s[kTiles * 32];           // one head's S^T tiles, A-fragment order
  float L[kGroup * kChunk];        // every head's inclusive cumsum of da
  float dt[kGroup * kChunk];
  float dL[kGroup * kChunk];       // every head's dL
  float el[2 * kChunk];            // exp(L_i), by head parity
  float ee[2 * kChunk];            // exp(L_end - L_j)
  float w[2 * kChunk];             // dt_j exp(L_end - L_j)
  float rowp[2 * kChunk];          // sum_i dS_ji S_ji, a pair's two warps
  float rowt[2 * kChunk];          // sum_i T_ji CB_ji
  float yp[2 * kChunk];            // u_i . C_i, each half's columns
  float dwp[2 * kChunk];           // v_j . B_j
  float colp[8 * kChunk];          // sum_j dS_ji S_ji, by slab of j
  float sdh[kGroup * 8];           // sum(dh * h0), by head and warp
  float sdw[kGroup * 4];           // sum_j dw_j w_j, by head and warp
};

template <int DS>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_chunk_kernel(const float* __restrict__ x,
                         const float* __restrict__ bm,
                         const float* __restrict__ cm,
                         const float* __restrict__ dt,
                         const float* __restrict__ da,
                         const float* __restrict__ dy,
                         const float* __restrict__ dstate,
                         const float* __restrict__ h0t,
                         const float* __restrict__ dhs,
                         float* __restrict__ dx, float* __restrict__ ddt,
                         float* __restrict__ dda, float* __restrict__ pdb,
                         float* __restrict__ pdc, int seqlen, int nh,
                         Strides st, bool vec) {
  constexpr int NPW = DS / 16;     // 8-wide column tiles of s a warp
  constexpr int KS = DS / 8;       // 8-wide steps over s
  constexpr long long kState = kHd * DS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem<DS>& sm = *reinterpret_cast<ChunkSmem<DS>*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // warps q and q + 4 share the row slabs q and 7 - q: of the pair's 18
  // causal tiles (slab q's i-tiles 2q..15, then slab 7 - q's 14 - 2q..15)
  // each takes every other one, and of every 128-row product's column
  // tiles each takes one half
  const int q = warp & 3, half = warp >> 2;
  const int slab[2] = {q, 7 - q};
  const int nfirst = 16 - 2 * q;
  const int nc = (seqlen + kChunk - 1) / kChunk;
  const int ngroups = (nh + kGroup - 1) / kGroup;
  const int grp = blockIdx.x % ngroups;
  const int c = (blockIdx.x / ngroups) % nc;
  const long long b = blockIdx.x / (ngroups * nc);
  const int c0 = c * kChunk, n = min(kChunk, seqlen - c0);
  const int hlo = grp * kGroup, nhg = min(nh - hlo, kGroup);
  const bool has_h0 = c > 0;                        // else h0 = 0
  const bool has_dh = c + 1 < nc || dstate != nullptr;   // else dh = 0
  const long long y_row = static_cast<long long>(nh) * kHd;

  auto load_x = [&](int k) {
    load_rows<kHd, kThreads>(sm.u.in.x, x + b * st.xb +
                             c0 * (long long)st.xs +
                             (hlo + k) * (long long)st.xh, st.xs, kChunk, n,
                             vec);
  };
  auto load_h0 = [&](int k) {
    if (has_h0)
      load_rows<kHd, kThreads>(sm.h0t, h0t + ((b * (nc - 1) + c - 1) * nh +
                                              hlo + k) * kState, kHd, DS, DS,
                               true);
  };
  auto load_dy = [&](int k) {
    load_rows<kHd, kThreads>(sm.u.in.dy, dy + (b * seqlen + c0) * y_row +
                             (hlo + k) * kHd, y_row, kChunk, n, true);
  };
  auto load_dh = [&](int k) {
    if (!has_dh) return;
    const float* src = c + 1 < nc
        ? dhs + ((b * (nc - 1) + c) * nh + hlo + k) * kState
        : dstate + (b * nh + hlo + k) * kState;
    load_rows<DS, kThreads>(sm.dh, src, DS, kHd, kHd, true);
  };

  // ---- copies: C and B, every head's da and dt; the first head's tiles
  load_rows<DS, kThreads>(sm.c, cm + b * st.cb + c0 * (long long)st.cs, st.cs,
                          kChunk, n, vec);
  load_rows<DS, kThreads>(sm.b, bm + b * st.bb + c0 * (long long)st.bs, st.bs,
                          kChunk, n, vec);
#pragma unroll 1
  for (int e = tid; e < kGroup * kChunk; e += kThreads) {
    const int k = e / kChunk, i = e % kChunk;
    const bool in = i < n && k < nhg;
    const long long pos = in ? c0 + i : 0;
    cp_async4(sm.L + e, da + b * st.dab + pos * st.das + (in ? hlo + k : 0),
              in);
    cp_async4(sm.dt + e, dt + b * st.dtb + pos * st.dts + (in ? hlo + k : 0),
              in);
  }
  cp_async_commit();
  load_x(0);
  load_dy(0);
  load_h0(0);
  load_dh(0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  // ---- L of every head at once, one thread a head
  if (tid < nhg) scan_L(sm.L + tid * kChunk);

  // ---- C B^T once for the group, in the [j][i] layout: the warp's 9
  // tiles, kept in registers across the heads
  float cbf[9][4], gacc[9][4];
#pragma unroll
  for (int kk = 0; kk < 9; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) cbf[kk][r] = gacc[kk][r] = 0.f;
#pragma unroll 1
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
      frag_a<DS>(sm.b, 16 * slab[p], 8 * ks, g, t, ah[p], al[p]);
#pragma unroll
    for (int kk = 0; kk < 9; ++kk) {
      const int idx = 2 * kk + half;
      const bool second = idx >= nfirst;
      const int qi = second ? idx - 2 : 2 * q + idx;
      uint32_t bh[2], bl[2], th[4], tl[4];
      frag_b<DS>(sm.c, 8 * qi, 8 * ks, g, t, bh, bl);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        th[r] = second ? ah[1][r] : ah[0][r];
        tl[r] = second ? al[1][r] : al[0][r];
      }
      mma3(cbf[kk], th, tl, bh, bl);
    }
  }
  // dB and dC of the warp's rows (slabs q and 7 - q) and columns, summed
  // over the group's heads
  float dbacc[2][NPW][4], dcacc[2][NPW][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int j = 0; j < NPW; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) dbacc[p][j][r] = dcacc[p][j][r] = 0.f;
  __syncthreads();   // L scanned

#pragma unroll 1
  for (int k = 0; k < nhg; ++k) {
    const int h = hlo + k;
    const float* Lk = sm.L + k * kChunk;
    const float* dtk = sm.dt + k * kChunk;
    float* el = sm.el + (k & 1) * kChunk;
    float* ee = sm.ee + (k & 1) * kChunk;
    float* w = sm.w + (k & 1) * kChunk;
    if (tid < kChunk) {
      const float lj = Lk[tid];
      const float e_ = expf(Lk[kChunk - 1] - lj);
      el[tid] = expf(lj);
      ee[tid] = e_;
      w[tid] = dtk[tid] * e_;
    }
    cp_async_wait<0>();
    __syncthreads();   // the head's tiles and exponentials are in

    // ---- (a) dS^T = x dy^T on the warp's 9 tiles, then element by element
    {
      float acc[9][4];
#pragma unroll
      for (int kk = 0; kk < 9; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[kk][r] = 0.f;
#pragma unroll 1
      for (int ks = 0; ks < kHd / 8; ++ks) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int p = 0; p < 2; ++p)
          frag_a<kHd>(sm.u.in.x, 16 * slab[p], 8 * ks, g, t, ah[p], al[p]);
#pragma unroll
        for (int kk = 0; kk < 9; ++kk) {
          const int idx = 2 * kk + half;
          const bool second = idx >= nfirst;
          const int qi = second ? idx - 2 : 2 * q + idx;
          uint32_t bh[2], bl[2], th[4], tl[4];
          frag_b<kHd>(sm.u.in.dy, 8 * qi, 8 * ks, g, t, bh, bl);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            th[r] = second ? ah[1][r] : ah[0][r];
            tl[r] = second ? al[1][r] : al[0][r];
          }
          mma3(acc[kk], th, tl, bh, bl);
        }
      }
      // the warp's row sums, [slab][row g or g + 8]
      float rp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      float rt[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < 9; ++kk) {
        const int idx = 2 * kk + half;
        const bool second = idx >= nfirst;
        const int r = second ? 7 - q : q;
        const int qi = second ? idx - 2 : 2 * q + idx;
        const int j1 = 16 * r + g, j2 = j1 + 8;
        const int i1 = 8 * qi + 2 * t, i2 = i1 + 1;
        const float lj1 = Lk[j1], lj2 = Lk[j2], li1 = Lk[i1], li2 = Lk[i2];
        const float d1 = dtk[j1], d2 = dtk[j2];
        // exp(L_i - L_j), masked to -inf before exp for j > i; fragment
        // e is (j1, i1), (j1, i2), (j2, i1), (j2, i2)
        const float gd[4] = {expf(j1 <= i1 ? li1 - lj1 : neg_inf()),
                             expf(j1 <= i2 ? li2 - lj1 : neg_inf()),
                             expf(j2 <= i1 ? li1 - lj2 : neg_inf()),
                             expf(j2 <= i2 ? li2 - lj2 : neg_inf())};
        const float dj[4] = {d1, d1, d2, d2};
        float sv[4], pv[4], tcb[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sv[e] = cbf[kk][e] * gd[e] * dj[e];
          const float tv = acc[kk][e] * gd[e];
          pv[e] = acc[kk][e] * sv[e];
          tcb[e] = tv * cbf[kk][e];
          gacc[kk][e] += tv * dj[e];
        }
        const float p1 = pv[0] + pv[1], p2 = pv[2] + pv[3];
        const float t1 = tcb[0] + tcb[1], t2 = tcb[2] + tcb[3];
        rp[0][0] += second ? 0.f : p1;
        rp[0][1] += second ? 0.f : p2;
        rp[1][0] += second ? p1 : 0.f;
        rp[1][1] += second ? p2 : 0.f;
        rt[0][0] += second ? 0.f : t1;
        rt[0][1] += second ? 0.f : t2;
        rt[1][0] += second ? t1 : 0.f;
        rt[1][1] += second ? t2 : 0.f;
        // the tile's column sums over its 16 rows (g)
        float cs1 = pv[0] + pv[2], cs2 = pv[1] + pv[3];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          cs1 += __shfl_xor_sync(0xffffffffu, cs1, off);
          cs2 += __shfl_xor_sync(0xffffffffu, cs2, off);
        }
        if (g == 0) {
          sm.colp[r * kChunk + i1] = cs1;
          sm.colp[r * kChunk + i2] = cs2;
        }
        // S^T in A-fragment order, k permuted: (j1, i1), (j2, i1),
        // (j1, i2), (j2, i2)
        sm.s[(r * (17 - r) + qi - 2 * r) * 32 + lane] =
            make_float4(sv[0], sv[2], sv[1], sv[3]);
      }
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float a = sum_t(rp[p][hf]), c_ = sum_t(rt[p][hf]);
          if (t == 0) {
            const int j = 16 * slab[p] + g + 8 * hf;
            sm.rowp[half * kChunk + j] = a;
            sm.rowt[half * kChunk + j] = c_;
          }
        }
    }

    // ---- (b) u = dy h0: dy_i . y_inter_i's sums, dC += exp(L_i) u_i;
    // sum(dh * h0).  Both slabs at once: they share the B fragments.
    if (has_h0) {
      float ua[2][NPW][4];
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int j = 0; j < NPW; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) ua[p][j][r] = 0.f;
#pragma unroll 2
      for (int ks = 0; ks < kHd / 8; ++ks) {
        uint32_t bh[NPW][2], bl[NPW][2];
#pragma unroll
        for (int j = 0; j < NPW; ++j)
          frag_b<kHd>(sm.h0t, 8 * (half * NPW + j), 8 * ks, g, t, bh[j],
                      bl[j]);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t ah[4], al[4];
          frag_a<kHd>(sm.u.in.dy, 16 * slab[p], 8 * ks, g, t, ah, al);
          mma3n<NPW>(ua[p], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int j1 = 16 * slab[p] + g, j2 = j1 + 8;
        const float e1 = el[j1], e2 = el[j2];
        float y1 = 0.f, y2 = 0.f;
#pragma unroll
        for (int j = 0; j < NPW; ++j) {
          const int s = 8 * (half * NPW + j) + 2 * t;
          y1 += ua[p][j][0] * sm.c[swz<DS>(j1, s)] +
                ua[p][j][1] * sm.c[swz<DS>(j1, s + 1)];
          y2 += ua[p][j][2] * sm.c[swz<DS>(j2, s)] +
                ua[p][j][3] * sm.c[swz<DS>(j2, s + 1)];
          dcacc[p][j][0] += e1 * ua[p][j][0];
          dcacc[p][j][1] += e1 * ua[p][j][1];
          dcacc[p][j][2] += e2 * ua[p][j][2];
          dcacc[p][j][3] += e2 * ua[p][j][3];
        }
        y1 = sum_t(y1);
        y2 = sum_t(y2);
        if (t == 0) {
          sm.yp[half * kChunk + j1] = y1;
          sm.yp[half * kChunk + j2] = y2;
        }
      }
      float sd = 0.f;
      if (has_dh) {
#pragma unroll 4
        for (int e = tid; e < kHd * DS; e += kThreads) {
          const int d = e / DS, s = e % DS;
          sd += sm.dh[swz<DS>(d, s)] * sm.h0t[swz<kHd>(s, d)];
        }
      }
      sd = sum_warp(sd);
      if (lane == 0) sm.sdh[k * 8 + warp] = sd;
    }

    // ---- (c) v = x dh: dw_j's sums, dB += w_j v_j; both slabs at once
    if (has_dh) {
      float va[2][NPW][4];
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int j = 0; j < NPW; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) va[p][j][r] = 0.f;
#pragma unroll 2
      for (int ks = 0; ks < kHd / 8; ++ks) {
        uint32_t bh[NPW][2], bl[NPW][2];
#pragma unroll
        for (int j = 0; j < NPW; ++j)
          frag_bp<DS>(sm.dh, 8 * ks, 8 * (half * NPW + j), g, t, bh[j],
                      bl[j]);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t ah[4], al[4];
          frag_ap<kHd>(sm.u.in.x, 16 * slab[p], 8 * ks, g, t, ah, al);
          mma3n<NPW>(va[p], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int j1 = 16 * slab[p] + g, j2 = j1 + 8;
        const float w1 = w[j1], w2 = w[j2];
        float d1 = 0.f, d2 = 0.f;
#pragma unroll
        for (int j = 0; j < NPW; ++j) {
          const int s = 8 * (half * NPW + j) + 2 * t;
          d1 += va[p][j][0] * sm.b[swz<DS>(j1, s)] +
                va[p][j][1] * sm.b[swz<DS>(j1, s + 1)];
          d2 += va[p][j][2] * sm.b[swz<DS>(j2, s)] +
                va[p][j][3] * sm.b[swz<DS>(j2, s + 1)];
          dbacc[p][j][0] += w1 * va[p][j][0];
          dbacc[p][j][1] += w1 * va[p][j][1];
          dbacc[p][j][2] += w2 * va[p][j][2];
          dbacc[p][j][3] += w2 * va[p][j][3];
        }
        d1 = sum_t(d1);
        d2 = sum_t(d2);
        if (t == 0) {
          sm.dwp[half * kChunk + j1] = d1;
          sm.dwp[half * kChunk + j2] = d2;
        }
      }
    }
    __syncthreads();   // x and h0 are read no more
    if (k + 1 < nhg) {
      load_x(k + 1);
      load_h0(k + 1);
      cp_async_commit();
    }

    // ---- (d) dx = S^T dy + (w B) dh^T, the warp's 4 column tiles of d,
    // both slabs at once: slab q's K runs over i-tiles 2q..15, slab
    // 7 - q's over 14 - 2q..15, and they share the B fragments there
    {
      float xa[2][4][4];
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) xa[p][j][e] = 0.f;
      const int base0 = q * (17 - q) - 2 * q;            // tile of (q, qi)
      const int base1 = (7 - q) * (10 + q) - 2 * (7 - q);
#pragma unroll 2
      for (int qi = 2 * q; qi < 16; ++qi) {
        uint32_t ah[4], al[4], bh[4][2], bl[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          frag_bp<kHd>(sm.u.in.dy, 8 * qi, 8 * (4 * half + j), g, t, bh[j],
                       bl[j]);
        const float4 s0 = sm.s[(base0 + qi) * 32 + lane];
        split(s0.x, ah[0], al[0]);
        split(s0.y, ah[1], al[1]);
        split(s0.z, ah[2], al[2]);
        split(s0.w, ah[3], al[3]);
        mma3n<4>(xa[0], ah, al, bh, bl);
        if (qi >= 14 - 2 * q) {
          const float4 s1 = sm.s[(base1 + qi) * 32 + lane];
          split(s1.x, ah[0], al[0]);
          split(s1.y, ah[1], al[1]);
          split(s1.z, ah[2], al[2]);
          split(s1.w, ah[3], al[3]);
          mma3n<4>(xa[1], ah, al, bh, bl);
        }
      }
      if (has_dh) {
#pragma unroll 2
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            frag_b<DS>(sm.dh, 8 * (4 * half + j), 8 * ks, g, t, bh[j],
                       bl[j]);
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const int j1 = 16 * slab[p] + g;
            uint32_t ah[4], al[4];
            frag_a<DS>(sm.b, 16 * slab[p], 8 * ks, g, t, ah, al, w[j1],
                       w[j1 + 8]);
            mma3n<4>(xa[p], ah, al, bh, bl);
          }
        }
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int j1 = 16 * slab[p] + g, j2 = j1 + 8;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* out = dx + h * kHd + 8 * (4 * half + j) + 2 * t;
          if (j1 < n)
            *reinterpret_cast<float2*>(out + (b * seqlen + c0 + j1) *
                                                 y_row) =
                make_float2(xa[p][j][0], xa[p][j][1]);
          if (j2 < n)
            *reinterpret_cast<float2*>(out + (b * seqlen + c0 + j2) *
                                                 y_row) =
                make_float2(xa[p][j][2], xa[p][j][3]);
        }
      }
    }
    __syncthreads();   // dy, dh and S^T are read no more; the sums are in
    if (k + 1 < nhg) {
      load_dy(k + 1);
      load_dh(k + 1);
      cp_async_commit();
    }

    // ---- dL and d(dt) of every position (j the key, i the query: P_ji =
    // dS_ij S_ij; dL_k = sum_j P_jk - sum_i P_ki + ...)
    if (tid < kChunk) {
      const int j = tid;
      const float pr = sm.rowp[j] + sm.rowp[kChunk + j];
      float pc = 0.f;
      for (int r = 0; r <= (j >> 4); ++r) pc += sm.colp[r * kChunk + j];
      const float dwj = has_dh ? sm.dwp[j] + sm.dwp[kChunk + j] : 0.f;
      const float yd = has_h0 ? el[j] * (sm.yp[j] + sm.yp[kChunk + j]) : 0.f;
      const float dww = dwj * w[j];
      sm.dL[k * kChunk + j] = pc - pr + yd - dww;
      if (j < n)
        ddt[(b * seqlen + c0 + j) * nh + h] =
            (sm.rowt[j] + sm.rowt[kChunk + j]) + ee[j] * dwj;
      const float sw = sum_warp(dww);
      if (lane == 0) sm.sdw[k * 4 + warp] = sw;
    }
  }

  // ---- after the heads: G^T to shared memory (x and dy are free)
#pragma unroll
  for (int kk = 0; kk < 9; ++kk) {
    const int idx = 2 * kk + half;
    const bool second = idx >= nfirst;
    const int r = second ? 7 - q : q;
    const int qi = second ? idx - 2 : 2 * q + idx;
    const int j1 = 16 * r + g, i1 = 8 * qi + 2 * t;
    *reinterpret_cast<float2*>(sm.u.gt + gidx(j1, i1)) =
        make_float2(gacc[kk][0], gacc[kk][1]);
    *reinterpret_cast<float2*>(sm.u.gt + gidx(j1 + 8, i1)) =
        make_float2(gacc[kk][2], gacc[kk][3]);
  }
  __syncthreads();   // G^T and every head's dL are in

  // ---- d(da) of head `warp`, by its lane 0, every head at once, from the
  // chunk's end in order, as autograd's reversed cumsum takes it
  if (lane == 0 && warp < nhg) {
    const int k = warp;
    const float sw = sm.sdw[k * 4] + sm.sdw[k * 4 + 1] + sm.sdw[k * 4 + 2] +
                     sm.sdw[k * 4 + 3];
    float sh = 0.f;
    if (has_h0 && has_dh)
      for (int v = 0; v < 8; ++v) sh += sm.sdh[k * 8 + v];
    float run = sw + expf(sm.L[k * kChunk + kChunk - 1]) * sh;
    const float4* dl = reinterpret_cast<const float4*>(sm.dL + k * kChunk);
    float* out = dda + (b * seqlen + c0) * nh + hlo + k;
#pragma unroll 4
    for (int qq = kChunk / 4 - 1; qq >= 0; --qq) {
      const float4 v = dl[qq];
      const int i = 4 * qq;
      run = run + v.w;
      if (i + 3 < n) out[(i + 3) * nh] = run;
      run = run + v.z;
      if (i + 2 < n) out[(i + 2) * nh] = run;
      run = run + v.y;
      if (i + 1 < n) out[(i + 1) * nh] = run;
      run = run + v.x;
      if (i < n) out[i * nh] = run;
    }
  }

  // ---- dB += G^T C and dC += G B, once for the group; the partials
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int r = slab[p], r0 = 16 * r;
#pragma unroll 1
    for (int qi = 2 * r; qi < 16; ++qi) {     // dB_j: k = i >= j
      const float2 a1 = *reinterpret_cast<const float2*>(
          sm.u.gt + gidx(r0 + g, 8 * qi + 2 * t));
      const float2 a2 = *reinterpret_cast<const float2*>(
          sm.u.gt + gidx(r0 + g + 8, 8 * qi + 2 * t));
      uint32_t ah[4], al[4], bh[NPW][2], bl[NPW][2];
      split(a1.x, ah[0], al[0]);
      split(a2.x, ah[1], al[1]);
      split(a1.y, ah[2], al[2]);
      split(a2.y, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NPW; ++j)
        frag_bp<DS>(sm.c, 8 * qi, 8 * (half * NPW + j), g, t, bh[j], bl[j]);
      mma3n<NPW>(dbacc[p], ah, al, bh, bl);
    }
#pragma unroll 1
    for (int qj = 0; qj <= 2 * r + 1; ++qj) {  // dC_i: k = j <= i
      const int j1 = 8 * qj + 2 * t;
      uint32_t ah[4], al[4], bh[NPW][2], bl[NPW][2];
      split(sm.u.gt[gidx(j1, r0 + g)], ah[0], al[0]);
      split(sm.u.gt[gidx(j1, r0 + g + 8)], ah[1], al[1]);
      split(sm.u.gt[gidx(j1 + 1, r0 + g)], ah[2], al[2]);
      split(sm.u.gt[gidx(j1 + 1, r0 + g + 8)], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NPW; ++j)
        frag_bp<DS>(sm.b, 8 * qj, 8 * (half * NPW + j), g, t, bh[j], bl[j]);
      mma3n<NPW>(dcacc[p], ah, al, bh, bl);
    }
#pragma unroll
    for (int j = 0; j < NPW; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r0 + g + 8 * hf;
        if (row >= n) continue;
        const long long o = ((b * ngroups + grp) * seqlen + c0 + row) * DS +
                            8 * (half * NPW + j) + 2 * t;
        *reinterpret_cast<float2*>(pdb + o) =
            make_float2(dbacc[p][j][2 * hf], dbacc[p][j][2 * hf + 1]);
        *reinterpret_cast<float2*>(pdc + o) =
            make_float2(dcacc[p][j][2 * hf], dcacc[p][j][2 * hf + 1]);
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
    err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<DS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(ChunkSmem<DS>)));
  if (err == cudaSuccess) configured = true;
  return err;
}

template <int DS>
cudaError_t launch(const float* x, const float* bm, const float* cm,
                   const float* dt, const float* da, const float* dy,
                   const float* dstate, float* dx, float* dbm, float* dcm,
                   float* ddt, float* dda, float* h0t, float* dhs, float* pdb,
                   float* pdc, int batch, int seqlen, int nh,
                   const Strides& st, bool vec, cudaStream_t stream) {
  cudaError_t err = configure<DS>();
  if (err != cudaSuccess) return err;
  const int ngroups = (nh + kGroup - 1) / kGroup;
  ssd_bwd_states_kernel<DS><<<2 * batch * ngroups, kPreThreads,
                              sizeof(StatesSmem<DS>), stream>>>(
      x, bm, cm, dt, da, dy, dstate, h0t, dhs, seqlen, nh, st, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nc = (seqlen + kChunk - 1) / kChunk;
  ssd_bwd_chunk_kernel<DS><<<batch * nc * ngroups, kThreads,
                             sizeof(ChunkSmem<DS>), stream>>>(
      x, bm, cm, dt, da, dy, dstate, h0t, dhs, dx, ddt, dda, pdb, pdc, seqlen,
      nh, st, vec);
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

template <int DS>
int occupancy(int* blocks_per_sm, int* smem_bytes) {
  cudaError_t err = configure<DS>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, ssd_bwd_chunk_kernel<DS>, kThreads,
        sizeof(ChunkSmem<DS>));
  *smem_bytes = static_cast<int>(sizeof(ChunkSmem<DS>));
  return static_cast<int>(err);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// The number of head groups (chunk blocks a batch row and chunk) for nh
// heads, into *groups: the wrapper sizes the partials of dB and dC as (B,
// groups, S, ds).  Returns 0.
extern "C" int firm_ssd_bwd_groups(int nh, int* groups) {
  *groups = (nh + kGroup - 1) / kGroup;
  return 0;
}

// x, bm, cm, dt, da as firm_ssd_scan takes them; dy contiguous (B, S, nh,
// 64) f32; dstate contiguous (B, nh, 64, ds) f32 or null (zero).  Out,
// contiguous f32: dx (B, S, nh, 64), dbm and dcm (B, S, ds), ddt and dda
// (B, S, nh).  Scratch, contiguous f32, n = ceil(S / 128): h0 (B, n - 1,
// nh, ds, 64), the chunk-start states transposed; dh (B, n - 1, nh, 64,
// ds), the chunks' end-state gradients but the last's; pdb and pdc (B,
// groups, S, ds).  Three launches; returns cudaGetLastError() after them.
extern "C" int firm_ssd_scan_bwd(
    const void* x, const void* bm, const void* cm, const void* dt,
    const void* da, const void* dy, const void* dstate, void* dx, void* dbm,
    void* dcm, void* ddt, void* dda, void* h0, void* dh, void* pdb,
    void* pdc, int batch, int seqlen, int nh, int ds, int x_sb, int x_ss,
    int x_sh, int b_sb, int b_ss, int c_sb, int c_ss, int dt_sb, int dt_ss,
    int da_sb, int da_ss, void* stream) {
  const long long nc = (static_cast<long long>(seqlen) + kChunk - 1) / kChunk;
  if (batch <= 0 || seqlen <= 0 || nh <= 0 ||
      2LL * batch * nh > (1LL << 30) ||
      batch * nc * ((nh + kGroup - 1) / kGroup) > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss,
                   dt_sb, dt_ss, da_sb, da_ss};
  // 16-byte copies need 16-byte aligned rows of x, B and C
  const bool vec = aligned16(x) && aligned16(bm) && aligned16(cm) &&
                   (x_sb | x_ss | x_sh | b_sb | b_ss | c_sb | c_ss) % 4 == 0;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto g = [](void* p) { return static_cast<float*>(p); };
  const auto s = static_cast<cudaStream_t>(stream);
  switch (ds) {
    case 16:
      return static_cast<int>(launch<16>(
          f(x), f(bm), f(cm), f(dt), f(da), f(dy), f(dstate), g(dx), g(dbm),
          g(dcm), g(ddt), g(dda), g(h0), g(dh), g(pdb), g(pdc), batch,
          seqlen, nh, st, vec, s));
    case 64:
      return static_cast<int>(launch<64>(
          f(x), f(bm), f(cm), f(dt), f(da), f(dy), f(dstate), g(dx), g(dbm),
          g(dcm), g(ddt), g(dda), g(h0), g(dh), g(pdb), g(pdc), batch,
          seqlen, nh, st, vec, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of the backward's chunk kernel that fit one SM, and its shared
// memory a block, for state dimension ds.  Returns a CUDA error code (0 on
// success).
extern "C" int firm_ssd_bwd_occupancy(int ds, int* blocks_per_sm,
                                      int* smem_bytes) {
  switch (ds) {
    case 16: return occupancy<16>(blocks_per_sm, smem_bytes);
    case 64: return occupancy<64>(blocks_per_sm, smem_bytes);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
