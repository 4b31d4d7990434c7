// Mamba2 SSD chunked scan for NVIDIA Hopper (sm_90a), with a plain C
// interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py:ssd_scan
// (_ssd_kernel), and computes what the scan body of
// src/repro/models/ssm.py:mamba2_seq computes, in the model's layout:
//
//   x (B, S, nh, hd), B and C (B, S, ds) shared by all heads, dt and da
//   (B, S, nh), all f32 and read through element strides (x, B and C are
//   views into the convolution's output, whose rows are din + 2 ds wide);
//   y (B, S, nh, hd) f32, contiguous; optionally the final state
//   (B, nh, hd, ds) f32, contiguous.
//
// For each chunk of 128 positions, with L the inclusive cumsum of da:
//
//   y_intra[i] = sum_{j <= i} (C_i . B_j) exp(L_i - L_j) dt_j x_j
//   y_inter[i] = (C_i . state) exp(L_i)
//   state     <- state exp(L_end) + sum_j (x_j dt_j exp(L_end - L_j)) B_j^T
//
// What bounds it on the H100: bytes, once the products run on tensor
// cores.  At the rollout's reference forward (B = 16, S = 256, nh = 64,
// hd = ds = 64) the function moves 155 MB (46.3 us at 3.35 TB/s) and needs
// 6.5 GFLOP: 13 us at 495 TFLOP/s TF32, 39 us as three TF32 products a
// product, but 97 us on the FMA pipes (67 TFLOP/s of f32).  The first
// design ran there: three register-tiled f32 FMA products, C B^T
// recomputed for each head, a 64 KB score tile in 180 KB of shared memory
// (one block an SM) and the cumsum of L taken by one thread: 0.59 ms.
//
// This design, one block of 8 warps per (batch row, group of 4 heads),
// walking the chunks in order; per chunk:
//
// 1. cp.async brings C and B, the first head's x, and (after the first
//    chunk) its state and da.
// 2. After the first chunk, each head's y_inter = (C state^T) exp(L_i)
//    goes to y; each head's state lives in the state
//    buffer in device memory between chunks (the output, or scratch from
//    the wrapper; L2-resident at these sizes).
// 3. C B^T, once for the 4 heads: 72 tiles of 16 x 8 on or below the
//    diagonal, into the shared memory that C and the state held, in
//    A-fragment order.
// 4. Each head: its scores, C B^T times exp(L_i - L_j) (masked to -inf
//    before exp for j > i) times dt_j, element by element from those
//    tiles; y = y_inter (read back by the thread that wrote it) + scores
//    x; then state <- state exp(L_end) + (x w)^T B.
//
// * Tensor cores.  Every product is mma.sync.m16n8k8 on TF32 operands
//   with f32 accumulators.  TF32 keeps 10 mantissa bits, so C B^T, the
//   scores times x and the state update are each split (hi = tf32(v),
//   lo = tf32(v - hi); hi hi + hi lo + lo hi), which holds them to f32's
//   error; single TF32 gave 2.6e-4 to 5.0e-4 of y's or the state's scale
//   in a CPU model of this kernel's arithmetic (tests/
//   test_torch_ssd_rules.py), against a 1e-4 gate.  C state^T is split
//   too: one TF32 product there holds that gate (2.6e-5) but moves y from
//   the plain version 100x further than the split does, which 32 Mamba2
//   layers compound past zamba2's f32 logits gate.  Inside each 8-wide k
//   step the k
//   index is permuted (even j to the first four columns, odd to the last
//   four), so that the accumulator layout of C B^T is the A-fragment
//   layout of the scores and no shuffle is needed.
// * Balanced causal work: warps q and q + 4 share the 16-row slabs q and
//   7 - q (18 tiles a pair), each taking 4 of y's 8 column tiles.
// * 113 KB of shared memory a block (C and one head's state, whose room C
//   B^T takes over in step 3; B; one head's x; L and dt: 115,712 bytes at
//   ds = 64) and at most 128 registers a thread, so two blocks of 8 warps
//   fit an SM.  Every tile is XOR-swizzled in 16-byte units (no padding)
//   so that the fragment loads are free of bank conflicts at ds = 64.
// * L by one thread in order, through registers (scan_L says why not
//   in parallel); past S on a ragged last chunk it stays exactly at
//   L[S - 1], so the last position's weight dt exp(L_end - L_j) is dt
//   exactly and the final state is as exact as the padded reference's.
//   exp is expf on the plain version's arguments, so the decays have its
//   bits.
//
// Ragged S: positions past S are loaded as zeros (x, B, C, dt and da), as
// the reference pads them, and rows past S are not stored.  No atomics:
// every sum runs in a fixed order, so the same inputs give the same bits,
// whatever their strides.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kChunk = 128;
constexpr int kHd = 64;
constexpr int kGroup = 4;       // heads a block
constexpr int kTiles = 72;      // 16 x 8 tiles of C B^T on or below the
                                // diagonal of 16 x 16 blocks

template <int DS>
struct Smem {
  union {
    struct {
      float c[kChunk * DS];      // C of the chunk, [i][s], swizzled
      float state[kHd * DS];     // one head's state before the chunk
    } in;                        // steps 1-2
    float4 cb[kTiles * 32];      // C B^T tiles in A-fragment order, 3-4
  } u;
  float b[kChunk * DS];          // B of the chunk, [j][s], swizzled
  float x[kChunk * kHd];         // x of one head, [j][d], swizzled
  float L[kChunk];               // inclusive cumsum of da
  float dt[kChunk];
};

struct Strides {
  int xb, xs, xh;                // x: batch, position, head
  int bb, bs, cb, cs;            // B and C: batch, position
  int dtb, dts, dab, das;        // dt and da: batch, position (head: 1)
};

// Element offset of (row, col) in a [rows][COLS] f32 tile whose 16-byte
// units are XOR-swizzled by row, so that the 8 rows x 4 columns that an
// mma fragment load touches fall in 32 distinct banks (at COLS = 64).
template <int COLS>
__device__ __forceinline__ int swz(int row, int col) {
  static_assert(COLS == 64 || COLS == 16, "64 or 16 columns");
  if constexpr (COLS == 64) return row * 64 + (col ^ ((row & 7) << 2));
  return row * COLS + (col ^ (((row >> 1) & 3) << 2));
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

// rows [0, rows) of a tile from src (row r at src + r * rstride); rows
// at or past nvalid are zeros.  vec: 16-byte copies (aligned rows).  The
// loops stay rolled: unrolled, their addresses are hoisted out of the
// chunk loop and spilled.
template <int COLS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long rstride, int rows,
                                          int nvalid, bool vec) {
  if (vec) {
    constexpr int kUnits = COLS / 4;
#pragma unroll 1
    for (int e = threadIdx.x; e < rows * kUnits; e += kThreads) {
      const int r = e / kUnits, c = (e % kUnits) * 4;
      const bool in = r < nvalid;
      cp_async16(dst + swz<COLS>(r, c), in ? src + r * rstride + c : src,
                 in);
    }
  } else {
#pragma unroll 1
    for (int e = threadIdx.x; e < rows * COLS; e += kThreads) {
      const int r = e / COLS, c = e % COLS;
      const bool in = r < nvalid;
      cp_async4(dst + swz<COLS>(r, c), in ? src + r * rstride + c : src, in);
    }
  }
}

__device__ __forceinline__ float neg_inf() {
  return __uint_as_float(0xff800000u);
}

// v rounded to TF32 as cvt.rna.tf32.f32 rounds a finite value: the
// mantissa to 10 bits, ties away from zero (half of the 13 dropped bits
// added to the magnitude, then cleared).  Two integer instructions, where
// cvt.rna compiles to four (it also keeps Inf and NaN, which no input of
// this kernel holds).
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
// N accumulators' products interleaved so that no two in a row depend on
// each other
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

// Inclusive cumsum of L[0..128) in place, by one thread, in order: the
// order of torch.cumsum over a non-innermost axis on the card, so L has
// the plain version's bits.  |L| reaches ~1800 in a chunk, where one ulp
// is ~1e-4, so another order moves exp(L_i - L_j), and y, by ~1.5e-5 of
// its scale, which 32 Mamba2 layers compound.  The values pass through
// registers (16-byte loads and stores); a zero da past S leaves L exactly
// at L[S - 1].
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

template <int DS>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                    const float* __restrict__ cm, const float* __restrict__ dt,
                    const float* __restrict__ da, float* __restrict__ y,
                    float* __restrict__ state, int seqlen, int nh,
                    Strides st, bool vec, bool final_state) {
  static_assert(DS == 16 || DS == 64, "ds must be 16 or 64");
  constexpr int KS = DS / 8;     // 8-wide steps over s
  constexpr int NSW = KS / 2;    // the warp's 8-wide state columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DS>& sm = *reinterpret_cast<Smem<DS>*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // warps q and q + 4 share the row slabs q and 7 - q, so that every pair
  // has 18 causal tiles; each takes 4 of y's 8 column tiles
  const int q = warp & 3, half = warp >> 2;
  const int slab[2] = {q, 7 - q};
  const int lim[2] = {2 * q + 1, 15 - 2 * q};   // last causal tile a slab
  const int nt0 = 4 * half;
  const int ngroups = (nh + kGroup - 1) / kGroup;
  const long long b = blockIdx.x / ngroups;
  const int h0 = (blockIdx.x % ngroups) * kGroup;
  const int h1 = min(nh, h0 + kGroup);
  const long long y_row = static_cast<long long>(nh) * kHd;
  const float* xb = x + b * st.xb;

  for (int c0 = 0; c0 < seqlen; c0 += kChunk) {
    const int n = min(kChunk, seqlen - c0);
    const bool first = c0 == 0;
    const bool update = c0 + kChunk < seqlen || final_state;
    float* yc = y + (b * seqlen + c0) * y_row;

    // copies of one head's state, of one (B, S, nh) column of it (da into
    // L, or dt), and of its x
    auto load_state = [&](int h) {
      load_rows<DS>(sm.u.in.state, state + (b * nh + h) * kHd * DS, DS,
                    kHd, kHd, true);
    };
    auto load_col = [&](float* dst, const float* src, int sb, int ss,
                        int h) {
      if (tid < kChunk) {
        const float* p = src + b * sb + h;
        const bool in = tid < n;
        cp_async4(dst + tid, in ? p + static_cast<long long>(c0 + tid) * ss
                                : p, in);
      }
    };
    auto load_x = [&](int h) {
      load_rows<kHd>(sm.x, xb + static_cast<long long>(c0) * st.xs +
                               static_cast<long long>(h) * st.xh,
                     st.xs, kChunk, n, vec);
    };

    // ---- 1. copies: C and B, the first head's state and da, its x
    load_rows<DS>(sm.u.in.c, cm + b * st.cb + static_cast<long long>(c0) *
                  st.cs, st.cs, kChunk, n, vec);
    load_rows<DS>(sm.b, bm + b * st.bb + static_cast<long long>(c0) * st.bs,
                  st.bs, kChunk, n, vec);
    cp_async_commit();
    if (!first) {
      load_state(h0);
      load_col(sm.L, da, st.dab, st.das, h0);
      cp_async_commit();
    }
    load_x(h0);
    cp_async_commit();

    // ---- 2. y_inter = (C state^T) exp(L_i) of every head, split TF32,
    // into y; C and the state leave shared memory after this
    if (!first) {
      for (int h = h0; h < h1; ++h) {
        if (h > h0) {
          __syncthreads();   // the previous head is done with state and L
          load_state(h);
          load_col(sm.L, da, st.dab, st.das, h);
          cp_async_commit();
          cp_async_wait<0>();
        } else {
          cp_async_wait<1>();   // x may still be in flight
        }
        __syncthreads();
        if (tid == 0) scan_L(sm.L);
        __syncthreads();
        float acc[2][4][4];
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[p][j][r] = 0.f;
#pragma unroll 1
        for (int ks = 0; ks < KS; ++ks) {
          const int s0 = 8 * ks + t;
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int d = 8 * (nt0 + j) + g;
            split(sm.u.in.state[swz<DS>(d, s0)], bh[j][0], bl[j][0]);
            split(sm.u.in.state[swz<DS>(d, s0 + 4)], bh[j][1], bl[j][1]);
          }
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const int i = 16 * slab[p] + g;
            uint32_t ah[4], al[4];
            split(sm.u.in.c[swz<DS>(i, s0)], ah[0], al[0]);
            split(sm.u.in.c[swz<DS>(i + 8, s0)], ah[1], al[1]);
            split(sm.u.in.c[swz<DS>(i, s0 + 4)], ah[2], al[2]);
            split(sm.u.in.c[swz<DS>(i + 8, s0 + 4)], ah[3], al[3]);
            mma3n<4>(acc[p], ah, al, bh, bl);
          }
        }
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int i1 = 16 * slab[p] + g, i2 = i1 + 8;
          const float e1 = expf(sm.L[i1]), e2 = expf(sm.L[i2]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float* yp = yc + h * kHd + 8 * (nt0 + j) + 2 * t;
            if (i1 < n)
              *reinterpret_cast<float2*>(yp + i1 * y_row) =
                  make_float2(acc[p][j][0] * e1, acc[p][j][1] * e1);
            if (i2 < n)
              *reinterpret_cast<float2*>(yp + i2 * y_row) =
                  make_float2(acc[p][j][2] * e2, acc[p][j][3] * e2);
          }
        }
      }
    }

    // ---- 3. C B^T, split TF32, once for the group: each warp computes 9
    // of its pair's 18 causal tiles (tile k: the pair's tile 2k + half)
    cp_async_wait<1>();   // C and B (x may still be in flight)
    __syncthreads();
    {
      float cbacc[9][4];
#pragma unroll
      for (int k = 0; k < 9; ++k)
#pragma unroll
        for (int r = 0; r < 4; ++r) cbacc[k][r] = 0.f;
#pragma unroll 1
      for (int ks = 0; ks < KS; ++ks) {
        const int s0 = 8 * ks + t;
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int i = 16 * slab[p] + g;
          split(sm.u.in.c[swz<DS>(i, s0)], ah[p][0], al[p][0]);
          split(sm.u.in.c[swz<DS>(i + 8, s0)], ah[p][1], al[p][1]);
          split(sm.u.in.c[swz<DS>(i, s0 + 4)], ah[p][2], al[p][2]);
          split(sm.u.in.c[swz<DS>(i + 8, s0 + 4)], ah[p][3], al[p][3]);
        }
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          const int idx = 2 * k + half;
          const bool second = idx > lim[0];
          const int jt = second ? idx - lim[0] - 1 : idx;
          uint32_t bh[2], bl[2];
          split(sm.b[swz<DS>(8 * jt + g, s0)], bh[0], bl[0]);
          split(sm.b[swz<DS>(8 * jt + g, s0 + 4)], bh[1], bl[1]);
          uint32_t th[4], tl[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            th[r] = second ? ah[1][r] : ah[0][r];
            tl[r] = second ? al[1][r] : al[0][r];
          }
          mma3(cbacc[k], th, tl, bh, bl);
        }
      }
      __syncthreads();   // every warp is done with C and the state
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int idx = 2 * k + half;
        const bool second = idx > lim[0];
        const int r = second ? slab[1] : slab[0];
        const int jt = second ? idx - lim[0] - 1 : idx;
        // in A-fragment order: (i1, j1), (i2, j1), (i1, j2), (i2, j2)
        sm.u.cb[(r * (r + 1) + jt) * 32 + lane] = make_float4(
            cbacc[k][0], cbacc[k][2], cbacc[k][1], cbacc[k][3]);
      }
    }

    // ---- 4. each head: y = y_inter + its scores times x; the state
    for (int h = h0; h < h1; ++h) {
      __syncthreads();   // C B^T stored; the previous head is done with x
      if (h > h0) load_x(h);
      load_col(sm.dt, dt, st.dtb, st.dts, h);
      load_col(sm.L, da, st.dab, st.das, h);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (tid == 0) scan_L(sm.L);
      __syncthreads();

#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int r = slab[p];
        const int i1 = 16 * r + g, i2 = i1 + 8;
        float* yp = yc + h * kHd + 8 * nt0 + 2 * t;
        // y_inter from step 2, read back by the thread that wrote it; the
        // loads are issued here and used after the products
        float2 yi[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          yi[j][0] = yi[j][1] = make_float2(0.f, 0.f);
          if (!first && i1 < n)
            yi[j][0] =
                *reinterpret_cast<const float2*>(yp + i1 * y_row + 8 * j);
          if (!first && i2 < n)
            yi[j][1] =
                *reinterpret_cast<const float2*>(yp + i2 * y_row + 8 * j);
        }
        float acc[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
        const float li1 = sm.L[i1], li2 = sm.L[i2];
#pragma unroll 2
        for (int jt = 0; jt <= lim[p]; ++jt) {
          const float4 c = sm.u.cb[(r * (r + 1) + jt) * 32 + lane];
          const int j1 = 8 * jt + 2 * t, j2 = j1 + 1;
          const float lj1 = sm.L[j1], lj2 = sm.L[j2];
          const float d1 = sm.dt[j1], d2 = sm.dt[j2];
          // exp(L_i - L_j) masked to -inf before exp for j > i
          uint32_t ah[4], al[4];
          split(c.x * expf(j1 <= i1 ? li1 - lj1 : neg_inf()) * d1, ah[0],
                al[0]);
          split(c.y * expf(j1 <= i2 ? li2 - lj1 : neg_inf()) * d1, ah[1],
                al[1]);
          split(c.z * expf(j2 <= i1 ? li1 - lj2 : neg_inf()) * d2, ah[2],
                al[2]);
          split(c.w * expf(j2 <= i2 ? li2 - lj2 : neg_inf()) * d2, ah[3],
                al[3]);
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int d = 8 * (nt0 + j) + g;
            split(sm.x[swz<kHd>(j1, d)], bh[j][0], bl[j][0]);
            split(sm.x[swz<kHd>(j2, d)], bh[j][1], bl[j][1]);
          }
          mma3n<4>(acc, ah, al, bh, bl);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (i1 < n)
            *reinterpret_cast<float2*>(yp + i1 * y_row + 8 * j) =
                make_float2(yi[j][0].x + acc[j][0], yi[j][0].y + acc[j][1]);
          if (i2 < n)
            *reinterpret_cast<float2*>(yp + i2 * y_row + 8 * j) =
                make_float2(yi[j][1].x + acc[j][2], yi[j][1].y + acc[j][3]);
        }
      }

      // state <- state exp(L_end) + (x w)^T B, split TF32: the warp owns
      // state rows d0..d0+15 and NSW of the 8-wide column tiles
      if (update) {
        const float lend = sm.L[kChunk - 1];
        const int d0 = 16 * q;
        float* out = state + (b * nh + h) * kHd * DS;
        // the state this thread wrote here in the previous chunk, loaded
        // now and used after the products
        float2 old[NSW][2];
#pragma unroll
        for (int j = 0; j < NSW; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int d = d0 + g + 8 * hf;
            const int s = 8 * (half * NSW + j) + 2 * t;
            old[j][hf] = first ? make_float2(0.f, 0.f)
                               : *reinterpret_cast<const float2*>(
                                     out + d * DS + s);
          }
        float sacc[NSW][4];
#pragma unroll
        for (int j = 0; j < NSW; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) sacc[j][r] = 0.f;
#pragma unroll 2
        for (int ks = 0; ks < kChunk / 8; ++ks) {
          const int j1 = 8 * ks + 2 * t, j2 = j1 + 1;
          const float w1 = sm.dt[j1] * expf(lend - sm.L[j1]);
          const float w2 = sm.dt[j2] * expf(lend - sm.L[j2]);
          uint32_t ah[4], al[4];
          split(sm.x[swz<kHd>(j1, d0 + g)] * w1, ah[0], al[0]);
          split(sm.x[swz<kHd>(j1, d0 + g + 8)] * w1, ah[1], al[1]);
          split(sm.x[swz<kHd>(j2, d0 + g)] * w2, ah[2], al[2]);
          split(sm.x[swz<kHd>(j2, d0 + g + 8)] * w2, ah[3], al[3]);
          uint32_t bh[NSW][2], bl[NSW][2];
#pragma unroll
          for (int j = 0; j < NSW; ++j) {
            const int s = 8 * (half * NSW + j) + g;
            split(sm.b[swz<DS>(j1, s)], bh[j][0], bl[j][0]);
            split(sm.b[swz<DS>(j2, s)], bh[j][1], bl[j][1]);
          }
          mma3n<NSW>(sacc, ah, al, bh, bl);
        }
        const float e = expf(lend);
#pragma unroll
        for (int j = 0; j < NSW; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int d = d0 + g + 8 * hf;
            const int s = 8 * (half * NSW + j) + 2 * t;
            // state e + new, each rounded, as the plain version has it
            *reinterpret_cast<float2*>(out + d * DS + s) = make_float2(
                __fadd_rn(__fmul_rn(old[j][hf].x, e), sacc[j][2 * hf]),
                __fadd_rn(__fmul_rn(old[j][hf].y, e), sacc[j][2 * hf + 1]));
          }
      }
    }
    __syncthreads();   // the next chunk's copies overwrite C, B, x
  }
}

template <int DS>
cudaError_t configure() {
  static bool configured = false;
  if (configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<DS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Smem<DS>)));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_scan_kernel<DS>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) configured = true;
  return err;
}

template <int DS>
cudaError_t launch(const float* x, const float* bm, const float* cm,
                   const float* dt, const float* da, float* y, float* state,
                   int batch, int seqlen, int nh, const Strides& st,
                   bool vec, bool final_state, cudaStream_t stream) {
  const cudaError_t err = configure<DS>();
  if (err != cudaSuccess) return err;
  const int blocks = batch * ((nh + kGroup - 1) / kGroup);
  ssd_scan_kernel<DS><<<blocks, kThreads, sizeof(Smem<DS>), stream>>>(
      x, bm, cm, dt, da, y, state, seqlen, nh, st, vec, final_state);
  return cudaGetLastError();
}

template <int DS>
int occupancy(int* blocks_per_sm, int* smem_bytes) {
  cudaError_t err = configure<DS>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, ssd_scan_kernel<DS>, kThreads, sizeof(Smem<DS>));
  *smem_bytes = static_cast<int>(sizeof(Smem<DS>));
  return static_cast<int>(err);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x, bm, cm: f32 with unit stride on their last axis; dt, da: f32 (B, S, nh)
// with unit head stride; y: contiguous (B, S, nh, 64) f32; state: contiguous
// (B, nh, 64, ds) f32, where the kernel keeps each head's state between
// chunks; null only if S <= 128 and final_state is 0.  With final_state
// the final state is left there.  hd is 64 and the chunk 128; ds is 64
// (zamba2) or 16 (its smoke preset).  Returns cudaGetLastError() after the
// launch.
extern "C" int firm_ssd_scan(const void* x, const void* bm, const void* cm,
                             const void* dt, const void* da, void* y,
                             void* state, int final_state, int batch,
                             int seqlen, int nh, int ds, int x_sb, int x_ss,
                             int x_sh, int b_sb, int b_ss, int c_sb,
                             int c_ss, int dt_sb, int dt_ss, int da_sb,
                             int da_ss, void* stream) {
  if (batch <= 0 || seqlen <= 0 || nh <= 0 ||
      batch > (1 << 24) / ((nh + kGroup - 1) / kGroup) ||
      (state == nullptr && (final_state || seqlen > kChunk)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss,
                   dt_sb, dt_ss, da_sb, da_ss};
  // 16-byte copies need 16-byte aligned rows of x, B and C
  const bool vec = aligned16(x) && aligned16(bm) && aligned16(cm) &&
                   (x_sb | x_ss | x_sh | b_sb | b_ss | c_sb | c_ss) % 4 == 0;
  const auto* xf = static_cast<const float*>(x);
  const auto* bf = static_cast<const float*>(bm);
  const auto* cf = static_cast<const float*>(cm);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* daf = static_cast<const float*>(da);
  auto* yf = static_cast<float*>(y);
  auto* sf = static_cast<float*>(state);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (ds) {
    case 16:
      return static_cast<int>(launch<16>(xf, bf, cf, dtf, daf, yf, sf, batch,
                                         seqlen, nh, st, vec, final_state != 0,
                                         s));
    case 64:
      return static_cast<int>(launch<64>(xf, bf, cf, dtf, daf, yf, sf, batch,
                                         seqlen, nh, st, vec, final_state != 0,
                                         s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of the scan kernel that fit one SM, and its shared memory a
// block, for state dimension ds.  Returns a CUDA error code (0 on success).
extern "C" int firm_ssd_occupancy(int ds, int* blocks_per_sm,
                                  int* smem_bytes) {
  switch (ds) {
    case 16: return occupancy<16>(blocks_per_sm, smem_bytes);
    case 64: return occupancy<64>(blocks_per_sm, smem_bytes);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
