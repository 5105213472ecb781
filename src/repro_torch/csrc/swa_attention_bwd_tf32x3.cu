// Hand-written Hopper (sm_90a) kernels for the float32 backward of
// sliding-window attention: dq, dk, dv of ops.swa_attention's float32
// route, reached through swa_attention_bwd (swa_attention_bwd.cu), which
// states the gradient (FlashAttention-2's, from the forward's logsumexp).
// They replace no pallas_call (the reference's gradient is XLA's of its jnp
// attention, src/repro/models/attention.py:90 _attend).
//
// Arithmetic: split TF32, the scheme of the forward (swa_attention_tf32x3.cu,
// tf32x3.cuh): each float32 operand is split into hi + lo TF32 (rna on the
// bits) and each product is lo*hi + hi*lo + hi*hi, three mma.sync m16n8k8
// TF32 products.  The tensor cores' additions into an accumulator do not
// round to nearest and their error grows with the additions, so every
// product of a tile is accumulated from zero (3 x (Dh / 8) additions for S
// and dP; 3 BT / 8 for a tile's share of dQ, dK, dV) and the
// long-lived dQ, dK and dV take each tile's share by a float32 add: their
// sum over the thousands of tiles a key or query sees rounds to nearest.
//
// Design for the card.
//   * Two kernels, no atomics (two runs give the same bits).  dq first:
//     one CTA of 8 warps per (batch x query head, 128 queries), each warp
//     16 query rows (the M of an m16n8k8 tile); D = rowsum(do o) of each
//     warp's rows in a prologue (a fixed reduction order), written out for
//     the dk/dv kernel.  dk/dv: one CTA of 8 warps per (batch x kv head,
//     128 keys), each warp 16 key rows; it walks the group's query heads in a
//     fixed order and, for each, the query tiles that the keys' windows
//     reach, so a group's sum over its heads is this loop, in registers.
//   * The CTA's own rows (Q and dO, or K and V) stay raw in shared memory
//     and are split as a warp reads them: the A operands of S and dP (S^T
//     and dP^T); two warps an SM sub-partition hide the mma.sync chains'
//     latency where one (64 rows split in advance) did not.  The
//     streamed tiles (K and V, or Q and dO) of BT rows (32 for a padded Dh
//     up to 112, else 16, as shared memory allows) come raw by cp.async
//     into a 2-stage ring (16-byte copies, 4-byte ones when Dh is not a
//     multiple of 4 or the data is not 16-byte aligned; zeros past Dh and
//     past T), so the next tile's copy runs under the current tile's
//     products; all 256 threads then split the tile once, hi in place and
//     lo beside it, which every warp reads (a split per element and CTA,
//     not per warp).  Each warp re-reads its A rows once per tile, so the
//     tiles are as long as shared memory holds.
//   * Fragment layouts as the forward's: the depth order inside each 8-deep
//     step is permuted (logical k = t <-> depth 2t, t + 4 <-> 2t + 1), so
//     the A and B reads of S and dP are 8-byte loads; the accumulator of S
//     (P, dS) holds columns 2t, 2t + 1 of a row pair, which is then exactly
//     the A operand of the next product (dQ += dS K, dV += P^T dO, dK +=
//     dS^T Q), whose B rows 2t and 2t + 1 are read from the split tile.
//     Row strides of 8 (mod 16) floats and, in the tiles, column bit 3
//     swapped by row bit 2: every fragment read meets 32 distinct banks.
//   * The tile skip is loop bounds; masks only on tiles that a window or
//     causal edge, Tq or Tk crosses, per warp; a warp none of whose rows
//     meets a tile skips it; the heaviest CTAs are scheduled first.
//
// Bound: operations.  10 Dh float32 operations per attended (query, key)
// pair; as 3 TF32 products each, 30 Dh at the card's TF32 tensor-core rate
// (495 TFLOP/s), against 10 Dh at the float32 FMA rate (67 TFLOP/s).  The
// kernels issue S and dP in both (the FlashAttention-2 recompute): 42 Dh.
// mma.sync does not reach the rate wgmma does; wgmma takes TF32 operands
// K-major only, which dQ's K, dV's dO and dK's Q are not as stored.
//
// The entry point has a plain C interface and returns cudaGetLastError()
// after the second launch (or the first error).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int NW = 8;                   // warps per CTA, 16 rows each
constexpr int NT = NW * 32;             // threads per CTA
constexpr int BR = NW * 16;             // a CTA's own rows
constexpr int STAGES = 2;               // ring depth
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// At padded depth DP (a multiple of 16): rows per streamed tile, and row
// strides in floats, 8 (mod 16) for the CTA's rows and the tiles.
template <int DP>
__host__ __device__ constexpr int bt() { return DP <= 112 ? 32 : 16; }
template <int DP>
__host__ __device__ constexpr int ld_a() { return DP + 8; }
template <int DP>
__host__ __device__ constexpr int ld_b() { return DP + 8; }

// A tile's column c of row r is stored at column c ^ (8 (r / 4 % 2)): then
// both of its reads meet 32 distinct banks, the 8-byte ones at (row g,
// columns 2t, 2t + 1) and the 4-byte ones at (rows 2t and 2t + 1, column
// g) (the stride alone serves the first, 2-way conflicts on the second).
__device__ __forceinline__ int swz(int r, int c) {
  return c ^ ((r & 4) << 1);
}

// Shared memory (floats): the CTA's rows of 2 tensors, raw (2 BR LA); the
// ring (STAGES x 2 tensors x BT rows of LB: raw, then hi in place); the
// tiles' lo (2 tensors x BT x LB); lse and D of a tile (2 BT).
template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)2 * BR * ld_a<DP>() +
                          (size_t)(STAGES + 1) * 2 * bt<DP>() * ld_b<DP>() +
                          2 * bt<DP>());
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += A B in split TF32, both split: lo*hi + hi*lo + hi*hi.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// BT rows x DP columns of src (row stride Dh floats, rows_valid rows) into
// dst (row stride LB), zero past Dh and past rows_valid.  vec: 16-byte
// copies (Dh % 4 == 0 and src 16-byte aligned), else 4-byte ones.
template <int DP>
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          int rows_valid, int Dh, bool vec) {
  constexpr int BT = bt<DP>();
  constexpr int LB = ld_b<DP>();
  if (vec) {
    constexpr int C4 = DP / 4;
    for (int idx = threadIdx.x; idx < BT * C4; idx += NT) {
      const int r = idx / C4;
      const int c = (idx - r * C4) * 4;
      const bool ok = r < rows_valid && c < Dh;
      cp_async16(smem_u32(dst + r * LB + swz(r, c)),
                 ok ? src + (long long)r * Dh + c : src, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < BT * DP; idx += NT) {
      const int r = idx / DP;
      const int c = idx - r * DP;
      const bool ok = r < rows_valid && c < Dh;
      cp_async4(smem_u32(dst + r * LB + swz(r, c)),
                ok ? src + (long long)r * Dh + c : src, ok ? 4 : 0);
    }
  }
}

// The raw tile hi (BT x DP, row stride LB) split: hi in place, lo beside
// (element by element, so in the swizzled order as it stands).
template <int DP>
__device__ __forceinline__ void split_tile(float* hi, float* lo) {
  constexpr int BT = bt<DP>();
  constexpr int LB = ld_b<DP>();
  for (int idx = threadIdx.x; idx < BT * DP / 4; idx += NT) {
    const int r = idx / (DP / 4);
    const int c = (idx - r * (DP / 4)) * 4;
    const float4 x = *reinterpret_cast<const float4*>(hi + r * LB + c);
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + r * LB + c) = h;
    *reinterpret_cast<uint4*>(lo + r * LB + c) = l;
  }
}

// BR rows x DP columns of src (row stride Dh, rows_valid rows) into dst
// (row stride LA), zero past Dh and past rows_valid: the A operands, split
// as they are read.
template <int DP>
__device__ __forceinline__ void load_rows(const float* src, float* dst,
                                          int rows_valid, int Dh, bool vec) {
  constexpr int LA = ld_a<DP>();
  constexpr int C4 = DP / 4;
  for (int idx = threadIdx.x; idx < BR * C4; idx += NT) {
    const int r = idx / C4;
    const int c = (idx - r * C4) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < rows_valid) {
      const float* s = src + (long long)r * Dh + c;
      if (vec) {
        if (c < Dh) x = __ldg(reinterpret_cast<const float4*>(s));
      } else {
        if (c < Dh) x.x = __ldg(s);
        if (c + 1 < Dh) x.y = __ldg(s + 1);
        if (c + 2 < Dh) x.z = __ldg(s + 2);
        if (c + 3 < Dh) x.w = __ldg(s + 3);
      }
    }
    *reinterpret_cast<float4*>(dst + r * LA + c) = x;
  }
}

// s and dp (16 x BT each: NS = BT / 8 n-tiles) = A B^T from zero, two
// products in one loop (2 NS independent accumulators): A the warp's 16
// rows of the CTA's raw rows (a, c at row g, stride LA; split as read), B
// the tile's BT split rows (b*, d* at row g, column 2t, stride LB,
// swizzled), depth DP in the permuted order.
template <int DP, int NS>
__device__ __forceinline__ void prod2_rows_tile(
    float (&s)[NS][4], float (&dp)[NS][4], const float* a, const float* bh,
    const float* bl, const float* c, const float* dh, const float* dl) {
  constexpr int LA = ld_a<DP>();
  constexpr int LB = ld_b<DP>();
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
  const int sw = (threadIdx.x & 16) >> 1;       // swz of row g: 8 (g / 4)
#pragma unroll 2
  for (int kk = 0; kk < DP / 8; ++kk) {
    const int d = 8 * kk;
    const int db = d ^ sw;
    uint32_t xH[2][4], xL[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float* x = m ? c : a;
      const float2 r0 = *reinterpret_cast<const float2*>(x + d);
      const float2 r1 = *reinterpret_cast<const float2*>(x + 8 * LA + d);
      split(r0.x, xH[m][0], xL[m][0]);
      split(r1.x, xH[m][1], xL[m][1]);
      split(r0.y, xH[m][2], xL[m][2]);
      split(r1.y, xH[m][3], xL[m][3]);
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float2 bH = *reinterpret_cast<const float2*>(bh + 8 * n * LB + db);
      const float2 bL = *reinterpret_cast<const float2*>(bl + 8 * n * LB + db);
      const float2 dH = *reinterpret_cast<const float2*>(dh + 8 * n * LB + db);
      const float2 dL = *reinterpret_cast<const float2*>(dl + 8 * n * LB + db);
      mma3(s[n], xH[0], xL[0], __float_as_uint(bH.x), __float_as_uint(bH.y),
           __float_as_uint(bL.x), __float_as_uint(bL.y));
      mma3(dp[n], xH[1], xL[1], __float_as_uint(dH.x), __float_as_uint(dH.y),
           __float_as_uint(dL.x), __float_as_uint(dL.y));
    }
  }
}

// The accumulator fragments x (NS n-tiles of a 16 x BT tile) as the split
// A operand of the NS 8-deep steps of the next product: c0, c1, c2, c3 ->
// a0, a2, a1, a3 (columns 2t, 2t + 1 are logical k t, t + 4).
template <int NS>
__device__ __forceinline__ void split_a(const float (&x)[NS][4],
                                        uint32_t (&h)[NS][4],
                                        uint32_t (&l)[NS][4]) {
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int a = (e >> 1) | ((e & 1) << 1);
      split(x[j][e], h[j][a], l[j][a]);
    }
}

// acc[n] (16 x DP) += X B tile by tile: X the split A operand of BT-deep
// (NS steps), B the split tile (BT rows x DP, row stride LB, swizzled) read
// at rows 2t, 2t + 1 and column 8 n + g (bh, bl at row 2t, column g); each
// n-tile's product from zero, then added.
template <int DP, int NS>
__device__ __forceinline__ void prod_tile_rows(float (&acc)[DP / 8][4],
                                               const uint32_t (&xh)[NS][4],
                                               const uint32_t (&xl)[NS][4],
                                               const float* bh,
                                               const float* bl) {
  constexpr int LB = ld_b<DP>();
  const int sw = (threadIdx.x & 2) << 2;         // swz of rows 2t: 8 (t / 2)
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int o = 8 * j * LB + ((8 * n) ^ sw);
      mma3(t, xh[j], xl[j], __float_as_uint(bh[o]),
           __float_as_uint(bh[o + LB]), __float_as_uint(bl[o]),
           __float_as_uint(bl[o + LB]));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += t[e];
  }
}

// Rows g and g + 8 (of row0; below nrows) x Dh columns of acc * mul into
// dst (row stride Dh).
template <int DP>
__device__ __forceinline__ void store_rows(float* dst,
                                           const float (&acc)[DP / 8][4],
                                           int row0, int nrows, int Dh,
                                           float mul, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= nrows) continue;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * t + e;
        if (col < Dh) dst[(long long)row * Dh + col] = acc[n][2 * r + e] * mul;
      }
  }
}

// ----------------------------------------------------------- dq kernel --

template <int DP>
__global__ void __launch_bounds__(NT, 1)
swa_bwd_dq_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ o,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ dsum,
                  float* __restrict__ dq, int Hq, int Hkv, int Tq, int Tk,
                  int Dh, long long window, int causal, long long q_offset,
                  float scale, int vec) {
  constexpr int BT = bt<DP>();
  constexpr int NS = BT / 8;
  constexpr int LA = ld_a<DP>();
  constexpr int LB = ld_b<DP>();
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // (BR, LA) each, raw
  float* Os = Qs + BR * LA;                      // dO
  float* ring = Os + BR * LA;                    // (STAGES, K / V, BT, LB)
  float* Kl = ring + STAGES * 2 * BT * LB;       // (BT, LB) each
  float* Vl = Kl + BT * LB;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;            // b * Hq + h
  const int b = bh / Hq;
  const int hk = (bh % Hq) / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;   // heaviest first
  const int nq = min(BR, Tq - q0);
  const long long row_q = (long long)bh * Tq + q0;
  const float* kp = k + (long long)(b * Hkv + hk) * Tk * Dh;
  const float* vp = v + (long long)(b * Hkv + hk) * Tk * Dh;

  const long long qlo = q_offset + q0;
  const long long qhi = qlo + nq - 1;
  long long klo = qlo - window + 1;
  if (klo < 0) klo = 0;
  long long khi = Tk - 1;
  if (causal && qhi < khi) khi = qhi;
  const bool any = klo <= khi;
  const int kt0 = any ? (int)(klo / BT) : 0;
  const int kt1 = any ? (int)(khi / BT) : -1;

  if (any) {
    copy_tile<DP>(ring, kp + (long long)kt0 * BT * Dh,
                  min(BT, Tk - kt0 * BT), Dh, vec);
    copy_tile<DP>(ring + BT * LB, vp + (long long)kt0 * BT * Dh,
                  min(BT, Tk - kt0 * BT), Dh, vec);
    cp_commit();
  }
  load_rows<DP>(q + row_q * Dh, Qs, nq, Dh, vec);
  load_rows<DP>(dout + row_q * Dh, Os, nq, Dh, vec);

  // D = rowsum(dO o) of the warp's 16 rows (lane-strided partial sums, a
  // fixed shuffle tree), written for the dk/dv kernel; each thread keeps D
  // and lse (log2 units) of its rows g, g + 8
  const int wr = warp * 16;
  float dr[2] = {0.0f, 0.0f}, lr[2] = {0.0f, 0.0f};
  for (int r = 0; r < 16; ++r) {
    float acc = 0.0f;
    if (wr + r < nq) {
      const float* a = dout + (row_q + wr + r) * Dh;
      const float* c = o + (row_q + wr + r) * Dh;
      for (int j = lane; j < Dh; j += 32) acc = fmaf(a[j], c[j], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(FULL, acc, off);
    if (g == r) dr[0] = acc;
    if (g + 8 == r) dr[1] = acc;
    if (lane == 0 && wr + r < nq) dsum[row_q + wr + r] = acc;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (wr + g + 8 * r < nq) lr[r] = lse[row_q + wr + g + 8 * r] * LOG2E;

  const float sl = scale * LOG2E;
  const bool warp_live = wr < nq;
  const long long wq_lo = qlo + wr;     // positions of the warp's rows
  const long long wq_hi = wq_lo + 15;
  float dQ[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) dQ[n][0] = dQ[n][1] = dQ[n][2] = dQ[n][3] = 0.0f;

  for (int kt = kt0; kt <= kt1; ++kt) {
    const int st = (kt - kt0) & 1;
    cp_wait<0>();
    __syncthreads();    // tile kt landed; tile kt - 1 read by every warp
    if (kt < kt1) {     // the next tile's copy runs under this one
      const int k1 = (kt + 1) * BT;
      float* nxt = ring + (st ^ 1) * 2 * BT * LB;
      copy_tile<DP>(nxt, kp + (long long)k1 * Dh, min(BT, Tk - k1), Dh, vec);
      copy_tile<DP>(nxt + BT * LB, vp + (long long)k1 * Dh, min(BT, Tk - k1),
                    Dh, vec);
      cp_commit();
    }
    float* Kh = ring + st * 2 * BT * LB;
    float* Vh = Kh + BT * LB;
    split_tile<DP>(Kh, Kl);
    split_tile<DP>(Vh, Vl);
    __syncthreads();

    const long long k0 = (long long)kt * BT;
    const bool none = (causal && k0 > wq_hi) ||
                      (k0 + BT - 1 < wq_lo - window + 1);
    if (!warp_live || none) continue;
    // rows past Tq have dO = 0 and D = 0, so dS = 0 there
    const bool full = k0 + BT <= Tk && (!causal || k0 + BT - 1 <= wq_lo) &&
                      k0 >= wq_hi - window + 1;
    float s[NS][4], dp[NS][4];
    prod2_rows_tile<DP, NS>(s, dp, Qs + (wr + g) * LA + 2 * t,
                            Kh + g * LB + 2 * t, Kl + g * LB + 2 * t,
                            Os + (wr + g) * LA + 2 * t, Vh + g * LB + 2 * t,
                            Vl + g * LB + 2 * t);
    // s[n][e]: row g + 8 (e >> 1), key 8 n + 2 t + (e & 1)
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool ok = true;
        if (!full) {
          const long long kpos = k0 + 8 * n + 2 * t + (e & 1);
          const long long qpos = wq_lo + g + 8 * (e >> 1);
          ok = kpos < Tk && kpos > qpos - window && (!causal || kpos <= qpos);
        }
        const float p = ok ? exp2f(fmaf(s[n][e], sl, -lr[e >> 1])) : 0.0f;
        s[n][e] = p * (dp[n][e] - dr[e >> 1]);      // dS
      }
    uint32_t xh[NS][4], xl[NS][4];
    split_a<NS>(s, xh, xl);
    prod_tile_rows<DP, NS>(dQ, xh, xl, Kh + 2 * t * LB + g,
                           Kl + 2 * t * LB + g);
  }
  if (warp_live)
    store_rows<DP>(dq + row_q * Dh, dQ, wr, nq, Dh, scale, g, t);
}

// -------------------------------------------------------- dk/dv kernel --

template <int DP>
__global__ void __launch_bounds__(NT, 1)
swa_bwd_dkdv_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, float* __restrict__ dk,
                    float* __restrict__ dv, int Hq, int Hkv, int Tq, int Tk,
                    int Dh, long long window, int causal, long long q_offset,
                    float scale, int vec) {
  constexpr int BT = bt<DP>();
  constexpr int NS = BT / 8;
  constexpr int LA = ld_a<DP>();
  constexpr int LB = ld_b<DP>();
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // (BR, LA) each, raw
  float* Vs = Ks + BR * LA;
  float* ring = Vs + BR * LA;                    // (STAGES, Q / dO, BT, LB)
  float* Ql = ring + STAGES * 2 * BT * LB;       // (BT, LB) each
  float* Ol = Ql + BT * LB;                      // dO
  float* Ls = Ol + BT * LB;                      // lse (log2 units), D
  float* Ds = Ls + BT;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bkv = blockIdx.x;           // b * Hkv + kv head
  const int b = bkv / Hkv;
  const int rep = Hq / Hkv;
  const int h0 = (bkv % Hkv) * rep;     // the group's first query head
  const int k0 = blockIdx.y * BR;       // heaviest (earliest keys) first
  const int nk = min(BR, Tk - k0);
  const long long row_k = (long long)bkv * Tk + k0;

  // the query tiles whose windows reach the CTA's keys, for each head
  long long qa = causal ? k0 - q_offset : 0;
  if (qa < 0) qa = 0;
  long long qz = (long long)k0 + nk - 1 + window - 1 - q_offset;
  if (qz > Tq - 1) qz = Tq - 1;
  const int qt0 = qa <= qz ? (int)(qa / BT) : 0;
  const int nqt = qa <= qz ? (int)(qz / BT) - qt0 + 1 : 0;
  const int n_tiles = rep * nqt;

  auto tile_src = [&](int i, int& qq0, long long& row) {
    const int hh = i / nqt;
    qq0 = (qt0 + i - hh * nqt) * BT;
    row = (long long)(b * Hq + h0 + hh) * Tq + qq0;
  };
  if (n_tiles > 0) {
    int qq0;
    long long row;
    tile_src(0, qq0, row);
    copy_tile<DP>(ring, q + row * Dh, min(BT, Tq - qq0), Dh, vec);
    copy_tile<DP>(ring + BT * LB, dout + row * Dh, min(BT, Tq - qq0), Dh,
                  vec);
    cp_commit();
  }
  load_rows<DP>(k + row_k * Dh, Ks, nk, Dh, vec);
  load_rows<DP>(v + row_k * Dh, Vs, nk, Dh, vec);

  const float sl = scale * LOG2E;
  const int wr = warp * 16;
  const long long wk = (long long)k0 + wr;        // position of the warp's key 0
  const bool warp_live = wr < nk;
  float dK[DP / 8][4], dV[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dK[n][e] = dV[n][e] = 0.0f;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i & 1;
    int qq0;
    long long row;
    tile_src(i, qq0, row);
    cp_wait<0>();
    __syncthreads();    // tile i landed; tile i - 1 read by every warp
    if (i + 1 < n_tiles) {  // the next tile's copy runs under this one
      int nq0;
      long long nrow;
      tile_src(i + 1, nq0, nrow);
      float* nxt = ring + (st ^ 1) * 2 * BT * LB;
      copy_tile<DP>(nxt, q + nrow * Dh, min(BT, Tq - nq0), Dh, vec);
      copy_tile<DP>(nxt + BT * LB, dout + nrow * Dh, min(BT, Tq - nq0), Dh,
                    vec);
      cp_commit();
    }
    float* Qh = ring + st * 2 * BT * LB;
    float* Oh = Qh + BT * LB;
    split_tile<DP>(Qh, Ql);
    split_tile<DP>(Oh, Ol);
    const int nqv = min(BT, Tq - qq0);
    if (threadIdx.x < BT) {
      const int r = threadIdx.x;
      Ls[r] = r < nqv ? lse[row + r] * LOG2E : 0.0f;
      Ds[r] = r < nqv ? dsum[row + r] : 0.0f;
    }
    __syncthreads();

    const long long qp0 = q_offset + qq0;         // position of query 0
    const bool none = (causal && wk > qp0 + BT - 1) ||
                      (wk + 15 <= qp0 - window);
    if (!warp_live || none) continue;
    const bool full = wk + 15 < Tk && qq0 + BT <= Tq &&
                      (!causal || wk + 15 <= qp0) &&
                      wk >= qp0 + BT - 1 - window + 1;
    float s[NS][4], dp[NS][4];                      // S^T, dP^T
    prod2_rows_tile<DP, NS>(s, dp, Ks + (wr + g) * LA + 2 * t,
                            Qh + g * LB + 2 * t, Ql + g * LB + 2 * t,
                            Vs + (wr + g) * LA + 2 * t, Oh + g * LB + 2 * t,
                            Ol + g * LB + 2 * t);
    // s[n][e]: key g + 8 (e >> 1), query 8 n + 2 t + (e & 1)
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * n + 2 * t + (e & 1);
        bool ok = true;
        if (!full) {
          const long long kpos = wk + g + 8 * (e >> 1);
          const long long qpos = qp0 + qi;
          ok = kpos < Tk && qi < nqv && kpos > qpos - window &&
               (!causal || kpos <= qpos);
        }
        const float p = ok ? exp2f(fmaf(s[n][e], sl, -Ls[qi])) : 0.0f;
        s[n][e] = p;                                   // P^T
        dp[n][e] = p * (dp[n][e] - Ds[qi]);            // dS^T
      }
    uint32_t xh[NS][4], xl[NS][4];
    split_a<NS>(s, xh, xl);
    prod_tile_rows<DP, NS>(dV, xh, xl, Oh + 2 * t * LB + g,
                           Ol + 2 * t * LB + g);
    split_a<NS>(dp, xh, xl);
    prod_tile_rows<DP, NS>(dK, xh, xl, Qh + 2 * t * LB + g,
                           Ql + 2 * t * LB + g);
  }
  if (warp_live) {
    store_rows<DP>(dk + row_k * Dh, dK, wr, nk, Dh, scale, g, t);
    store_rows<DP>(dv + row_k * Dh, dV, wr, nk, Dh, 1.0f, g, t);
  }
}

template <int DP>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* dout, const float* lse, float* dsum, float* dq,
           float* dk, float* dv, int B, int Hq, int Hkv, int Tq, int Tk,
           int Dh, long long window, int causal, long long q_offset,
           float scale, int vec, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<DP>();
  static bool ready = false;            // the attributes, set once
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        swa_bwd_dq_tf32x3<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(swa_bwd_dkdv_tf32x3<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  swa_bwd_dq_tf32x3<DP><<<dim3(B * Hq, (Tq + BR - 1) / BR), NT, smem, st>>>(
      q, k, v, o, dout, lse, dsum, dq, Hq, Hkv, Tq, Tk, Dh, window, causal,
      q_offset, scale, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  swa_bwd_dkdv_tf32x3<DP><<<dim3(B * Hkv, (Tk + BR - 1) / BR), NT, smem,
                            st>>>(
      q, k, v, dout, lse, dsum, dk, dv, Hq, Hkv, Tq, Tk, Dh, window, causal,
      q_offset, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Hq, Tq, Dh), k and v (B, Hkv, Tk, Dh), o and dout like q; lse
// (B, Hq, Tq) the forward's logsumexp; dsum (B, Hq, Tq) scratch (D); dq,
// dk, dv like q, k, v.  All contiguous float32 at any 4-byte alignment;
// 1 <= Dh <= 128, Hq % Hkv == 0 (swa_attention_bwd checks).
int swa_attention_bwd_tf32x3(const float* q, const float* k, const float* v,
                             const float* o, const float* dout,
                             const float* lse, float* dsum, float* dq,
                             float* dk, float* dv, int B, int Hq, int Hkv,
                             int Tq, int Tk, int Dh, long long window,
                             int causal, long long q_offset, float scale,
                             void* stream) {
  if ((Tq + BR - 1) / BR > 65535 || (Tk + BR - 1) / BR > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int vec = Dh % 4 == 0 &&
                  ((reinterpret_cast<uintptr_t>(q) |
                    reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) |
                    reinterpret_cast<uintptr_t>(dout)) & 15) == 0;
#define SWA_BWD_TF32X3_CASE(n)                                               \
  case n:                                                                    \
    return launch<16 * n>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, Hq,    \
                          Hkv, Tq, Tk, Dh, window, causal, q_offset, scale,  \
                          vec, st);
  switch ((Dh + 15) / 16) {
    SWA_BWD_TF32X3_CASE(1)
    SWA_BWD_TF32X3_CASE(2)
    SWA_BWD_TF32X3_CASE(3)
    SWA_BWD_TF32X3_CASE(4)
    SWA_BWD_TF32X3_CASE(5)
    SWA_BWD_TF32X3_CASE(6)
    SWA_BWD_TF32X3_CASE(7)
    SWA_BWD_TF32X3_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SWA_BWD_TF32X3_CASE
}

}  // extern "C"
