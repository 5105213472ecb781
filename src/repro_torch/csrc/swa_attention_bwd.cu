// Hand-written Hopper (sm_90a) kernels for the backward of sliding-window
// attention: the gradients dq, dk, dv of ops.swa_attention, every route.
//
// The reference's Pallas kernel _swa_kernel
// (src/repro/kernels/swa_attention.py:32, pallas_call :102) has no
// backward: the reference trains through its jnp attention
// (src/repro/models/attention.py:90 _attend) and lets XLA differentiate
// it.  These kernels port that gradient for the port's forward kernels
// (swa_attention_tc.cu, swa_attention_tf32x3.cu, swa_attention.cu), the
// FlashAttention-2 backward: nothing of the (Tq, Tk) score matrix is kept.
// The forward saves each row's logsumexp lse (natural log of the scaled
// scores' sum) beside its output o; the backward recomputes the scores
// tile by tile and
//     P  = exp(scale q k^T - lse) in the window, else 0
//     D  = rowsum(do o)                      (float32, o as saved)
//     dv = P^T do,   dP = do v^T,   dS = P (dP - D)
//     dq = scale dS k,   dk = scale dS^T q
// in float32 accumulators; the gradients are stored in the inputs' type.
// A row with no key in its window (lse saved as -1e30) has P = 0.
//
// This file holds the bf16 kernels and the entry point of every route;
// float32 goes to swa_attention_bwd_tf32x3.cu (split TF32 on mma.sync).
// The bf16 kernels read q, k, v and do through TMA: rows of ld bf16 (ld a
// multiple of 8, at least Dh) at 16-byte-aligned addresses, which the
// tensor-core route has in place and the packed route (swa_attention.cu)
// makes by packing.
//
// Design for the card (the forward's shape, swa_attention_tc.cu):
//   * Three launches, no atomics, so two runs give the same bits: D =
//     rowsum(dO o) of every row (a warp a row, a fixed order of the sums;
//     bound by its bytes, a few % of the call), the dq kernel, then the
//     dk/dv kernel.  dq: one CTA per (batch x query head, 128 queries), two
//     consumer warpgroups of 64 query rows and a producer warpgroup;
//     setmaxnreg moves the producer's registers to the consumers (24 and
//     240 a thread: the dk/dv kernel's dK and dV are 2 x 56 floats a
//     thread at Dh 112, S^T and dP^T 2 x 32 more, and ptxas allots a wgmma
//     kernel registers for whole warpgroups, 168 a thread without it).
//     Each thread holds its rows of Q and dO as the register A operands of
//     S and dP (so these products read only K and V from shared memory); K
//     and V tiles of 64 keys stream through a ring of 3 TMA stages
//     (mbarriers full / empty).  Per tile: S = Q K^T and dP = dO V^T as
//     register-A wgmma m64n64 (K and V K-major); P and dS on the
//     accumulator fragments; dQ += dS K as a register-A wgmma with K as
//     the MN-major B operand, as the forward takes V.
//   * dk/dv: one CTA per (batch x kv head, 128 keys), each consumer
//     warpgroup 64 key rows, K and V of the CTA in shared memory for the
//     whole CTA; the producer streams Q and dO tiles of 64 queries through
//     the ring (one TMA thread) with their lse and D (the lanes of the
//     TMA thread's warp copy them into the stage and arrive on the same
//     barrier),
//     over the group's query heads in a fixed order.  Per tile: S^T = K
//     Q^T and dP^T = V dO^T as wgmma, P^T and dS^T in registers, then dV
//     += P^T dO and dK += dS^T Q as register-A wgmmas with dO and Q as the
//     MN-major B operands.  A group's sum over its query heads is this
//     loop, in registers.
//   * Precision: P and dS (float32 on the fragments) are rounded once to
//     bf16 for the products that take them, as FlashAttention-2/3 and SDPA
//     do; the sums stay float32.  Products of bf16 values are exact in
//     float32.  (The forward's scheme, hi = bf16(x) and lo = bf16(x - hi)
//     as two products, held the same gates and was 1.2x slower here.)
//   * The tile skip is loop bounds: a CTA walks only the tiles that meet
//     its rows' windows; a warpgroup none of whose rows meets a tile only
//     releases it; masks only on tiles that a window or causal edge, Tq or
//     Tk crosses.  The heaviest tiles are scheduled first (the last query
//     tiles, the first key tiles).  Dh pads to a multiple of 16 for the
//     wgmma depth with the tensor maps' zeros (one instantiation per
//     padded width, so accumulators hold exactly its columns); the output
//     products are one instruction per 64-column box.
//   (Tried on the card and left out, python -m repro_torch.bench.lm_bwd at
//   B 2 x T 4,096: the two warpgroups taking turns on the tensor cores by
//   named barriers, dq 1.19 -> 1.46 ms; waiting for a tile's register-A
//   products together with the next tile's S and dP, dq 0.88 -> 1.13 ms and
//   dk/dv 1.06 -> 1.42 ms.)
//
// Bound: operations.  The five products are 10 Dh operations per attended
// (query, key) pair at the bf16 tensor-core rate; the kernels issue S and
// dP in both (the FlashAttention-2 recompute): 14 Dh.
//
// The entry point has a plain C interface for ctypes and returns
// cudaGetLastError() after the last launch (or the first error).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "swa_wgmma.cuh"

extern "C" int swa_attention_bwd_tf32x3(
    const float* q, const float* k, const float* v, const float* o,
    const float* dout, const float* lse, float* dsum, float* dq, float* dk,
    float* dv, int B, int Hq, int Hkv, int Tq, int Tk, int Dh,
    long long window, int causal, long long q_offset, float scale,
    void* stream);

namespace {

using bf16 = __nv_bfloat16;
using acp::mbar_arrive;
using acp::mbar_expect_tx;
using acp::mbar_init;
using acp::mbar_wait;
using acp::smem_u32;
using acp::tma_load_3d;
using namespace swa_wg;

constexpr int WG_ROWS = 64;             // rows per consumer warpgroup
constexpr int N_WG = 2;                 // consumer warpgroups per CTA
constexpr int BR = N_WG * WG_ROWS;      // a CTA's own rows
constexpr int BT = 64;                  // rows per streamed tile
constexpr int STAGES = 3;               // ring depth
constexpr int CONSUMER_WARPS = N_WG * 4;
constexpr int NT = (N_WG + 1) * 128;    // + the producer warpgroup
constexpr int PRODUCER_REGS = 24;       // registers per thread after
constexpr int CONSUMER_REGS = 240;      // setmaxnreg (<= 64K per SM)
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// Widths of a padded depth of KS 16-deep steps: 64-column boxes, the
// output chunks of the register-A products (first box, second box).
template <int KS>
__host__ __device__ constexpr int n_box() { return (KS + 3) / 4; }
template <int KS>
__host__ __device__ constexpr int n0() { return KS >= 4 ? 64 : 16 * KS; }
template <int KS>
__host__ __device__ constexpr int n1() { return 16 * KS - n0<KS>(); }

// A tensor's CTA rows (two warpgroups' boxes) and one tile, in bytes.
template <int KS>
__host__ __device__ constexpr uint32_t rows_bytes() {
  return N_WG * n_box<KS>() * BOX_BYTES;
}
template <int KS>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return n_box<KS>() * BOX_BYTES;
}

// Shared memory, from a 1024-byte-aligned base (the 128-byte swizzle
// repeats every 1024 bytes).  dq: STAGES stages of two tensors' tiles (K,
// then V a tile further), then the barriers.  dk/dv: two tensors' CTA rows
// (box c of warpgroup g at (c N_WG + g) boxes), the stages (Q, dO), lse
// and D of each stage (2 x 64 floats), then the barriers.
template <int KS>
constexpr size_t dq_smem() {
  return 1024 + STAGES * 2 * tile_bytes<KS>() + 8 * 2 * STAGES;
}
template <int KS>
constexpr size_t dkdv_smem() {
  return 1024 + 2 * rows_bytes<KS>() + STAGES * 2 * tile_bytes<KS>() +
         STAGES * 2 * BT * sizeof(float) + 8 * (1 + 2 * STAGES);
}

// An edge tile's mask as bounds on x = (key - query) - d0 for the tile's
// kpos - qpos = d0 + x (|x| < 64): in the window when lo < x and, causal,
// x <= hi; both clamped to +-128, so a tile needs one 64-bit step.
struct EdgeMask {
  int lo, hi;
};

__device__ __forceinline__ EdgeMask edge_mask(long long d0, long long window,
                                              int causal) {
  const long long lo = -window - d0;
  const long long hi = causal ? -d0 : 128;
  return {(int)max(-128ll, min(128ll, lo)), (int)max(-128ll, min(128ll, hi))};
}

// P and dS of one element of a tile from its score s and dP accumulators:
// p = 2^(s scale log2 e - lse log2 e) where ok, else 0; returns dS, p out.
__device__ __forceinline__ float p_ds(float s, float dp, float sl, float l2,
                                      float d, bool ok, float& p) {
  p = ok ? ex2(fmaf(s, sl, -l2)) : 0.0f;
  return p * (dp - d);
}

// The 32 float32 fragment values x (16 bf16x2 pairs) as the register A
// operand a of 4 16-deep steps.
__device__ __forceinline__ void pack_a(const float* x, uint32_t* a) {
#pragma unroll
  for (int j = 0; j < 16; ++j) a[j] = pack2(x[2 * j], x[2 * j + 1]);
}

// acc (+)= X B for the register A fragments x of 4 16-deep steps and the
// 64 rows of B at b (MN-major), over the padded depth's boxes.
template <int KS>
__device__ __forceinline__ void issue_out(float* acc, const uint32_t* x,
                                          uint32_t b) {
  issue_rs<false, n_box<KS>()>(acc, x, nullptr, b, n0<KS>(), n1<KS>());
}

// Rows r0 and r0 + 8 (below nrows) x Dh columns of the fragments acc (16
// KS columns: 4 floats per 8 columns) times mul into dst (row stride Dh).
template <int KS>
__device__ __forceinline__ void store_rows(bf16* dst, const float* acc,
                                           int r0, int nrows, int Dh,
                                           float mul, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= nrows) continue;
    bf16* p = dst + (long long)row * Dh;
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j) {
      const int col = 8 * j + 2 * t4;
      const float x = acc[4 * j + 2 * r] * mul;
      const float y = acc[4 * j + 2 * r + 1] * mul;
      if ((Dh & 1) == 0) {              // column pairs lie 4-byte aligned
        if (col < Dh)
          *reinterpret_cast<__nv_bfloat162*>(p + col) =
              __floats2bfloat162_rn(x, y);
      } else {
        if (col < Dh) p[col] = __float2bfloat16_rn(x);
        if (col + 1 < Dh) p[col + 1] = __float2bfloat16_rn(y);
      }
    }
  }
}

// ------------------------------------------------------------ D kernel --

constexpr int DSUM_THREADS = 256;       // 8 warps, a row each at a time

// D = rowsum(dout o) of every row (rows of ld and Dh elements), one warp a
// row: each lane's partial sum over the columns lane, lane + 32, ..., then a
// fixed shuffle tree (every lane ends with the same bits).  A launch of its
// own because it is faster so: summed in the dq kernel's prologue (16 rows
// a warp, one after another) it made the dq kernel 1.22 ms; in this launch
// dq takes 0.82 ms and D 0.05 ms (B 2 x T 4,096, 32 heads of 112, python
// -m repro_torch.bench.lm_bwd; NVIDIA H100 80GB HBM3, 700.00 W).
__global__ void __launch_bounds__(DSUM_THREADS)
swa_bwd_dsum_kernel(const bf16* __restrict__ dout, const bf16* __restrict__ o,
                    float* __restrict__ dsum, long long rows, int Dh,
                    int ld) {
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * (DSUM_THREADS / 32);
  for (long long r = (long long)blockIdx.x * (DSUM_THREADS / 32) +
                     (threadIdx.x >> 5);
       r < rows; r += step) {
    const bf16* dr = dout + r * ld;
    const bf16* orow = o + r * Dh;
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = lane + 32 * j;
      if (c < Dh)
        acc = fmaf(__bfloat162float(dr[c]), __bfloat162float(orow[c]), acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(FULL, acc, off);
    if (lane == 0) dsum[r] = acc;
  }
}

// ----------------------------------------------------------- dq kernel --

template <int KS>
__global__ void __launch_bounds__(NT, 1)
swa_bwd_dq_tc(const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v,
              const bf16* __restrict__ q, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dsum,
              bf16* __restrict__ dq, int Hq, int Hkv, int Tq, int Tk, int Dh,
              int ld, long long window, int causal, long long q_offset,
              float scale) {
  constexpr int NB = n_box<KS>();
  constexpr uint32_t TB = tile_bytes<KS>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = base;           // stage s: K at s 2 TB, V after it
  const uint32_t full_bar = ring + STAGES * 2 * TB;
  const uint32_t empty_bar = full_bar + 8 * STAGES;

  const int bh = blockIdx.x;            // b * Hq + h
  const int h = bh % Hq;
  const int bkv = (bh / Hq) * Hkv + h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;   // heaviest first
  const int nq = min(BR, Tq - q0);

  // key tiles that meet the windows of the CTA's queries
  const long long qlo = q_offset + q0;
  const long long qhi = qlo + nq - 1;
  long long klo = qlo - window + 1;
  if (klo < 0) klo = 0;
  long long khi = Tk - 1;
  if (causal && qhi < khi) khi = qhi;
  const int k_first = (int)(klo / BT) * BT;
  const int n_tiles = klo <= khi ? (int)((khi - k_first) / BT) + 1 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, CONSUMER_WARPS);
    }
    acp::mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp >= CONSUMER_WARPS) {
    // ------------------------------------------------------ producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    if (warp == CONSUMER_WARPS && lane == 0) {
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(empty_bar + 8 * s, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(full_bar + 8 * s, 2 * TB);
        const int k0 = k_first + t * BT;
        const uint32_t ks = ring + s * 2 * TB;
        for (int c = 0; c < NB; ++c) {
          tma_load_3d(ks + c * BOX_BYTES, &tm_k, c * BOX_COLS, k0, bkv,
                      full_bar + 8 * s);
          tma_load_3d(ks + TB + c * BOX_BYTES, &tm_v, c * BOX_COLS, k0, bkv,
                      full_bar + 8 * s);
        }
      }
    }
    return;
  }

  // -------------------------------------------------------- consumers --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(CONSUMER_REGS));
  const int wg = warp >> 2;             // consumer warpgroup
  const int g8 = lane >> 2;             // row of the fragment, 0..7
  const int t4 = lane & 3;              // column pair of the fragment
  const int r_lo = (warp & 3) * 16 + g8;              // rows r_lo, r_lo + 8
  const int row_w = q0 + wg * WG_ROWS;  // the warpgroup's first query
  const int nq_w = max(0, min(WG_ROWS, Tq - row_w));
  const long long qb = q_offset + row_w;              // its position
  long long klo_w = qb - window + 1;
  if (klo_w < 0) klo_w = 0;
  long long khi_w = Tk - 1;
  if (causal && qb + nq_w - 1 < khi_w) khi_w = qb + nq_w - 1;
  const float sl = scale * LOG2E;

  // Q and dO of the thread's rows as the register A operands of S and dP
  // (zero past Tq and past the row's ld columns)
  const long long lrow = (long long)bh * Tq + row_w + r_lo;
  uint32_t qa[4 * KS], oa[4 * KS];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row_w + r_lo + ((e & 1) ? 8 : 0);
      const int col = 16 * kk + 2 * t4 + ((e & 2) ? 8 : 0);
      const bool in = row < Tq && col < ld;
      const long long at = ((long long)bh * Tq + row) * ld + col;
      qa[4 * kk + e] = in ? *reinterpret_cast<const uint32_t*>(q + at) : 0u;
      oa[4 * kk + e] =
          in ? *reinterpret_cast<const uint32_t*>(dout + at) : 0u;
    }
  // D (from swa_bwd_dsum_kernel) and lse (log2 units) of rows r_lo and
  // r_lo + 8
  const float d0 = row_w + r_lo < Tq ? dsum[lrow] : 0.0f;
  const float d1 = row_w + r_lo + 8 < Tq ? dsum[lrow + 8] : 0.0f;
  const float l0 = row_w + r_lo < Tq ? lse[lrow] * LOG2E : 0.0f;
  const float l1 = row_w + r_lo + 8 < Tq ? lse[lrow + 8] * LOG2E : 0.0f;

  float acc[8 * KS];
#pragma unroll
  for (int i = 0; i < 8 * KS; ++i) acc[i] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const int k0 = k_first + t * BT;
    const uint32_t ks = ring + s * 2 * TB;
    mbar_wait(full_bar + 8 * s, (t / STAGES) & 1);
    // a tile that meets no window of this warpgroup's rows is only released
    if (nq_w > 0 && k0 <= khi_w && k0 + BT - 1 >= klo_w) {
      float sc[32], dp[32];
      wgmma_fence();
      issue_rk<KS>(sc, qa, ks);
      issue_rk<KS>(dp, oa, ks + TB);
      wgmma_commit();
      wgmma_wait0();
      fence_regs<32>(sc);
      fence_regs<32>(dp);
      fence_regs<4 * KS>(qa);
      fence_regs<4 * KS>(oa);
      // masks only where an edge crosses this warpgroup's part of the tile
      // (rows past Tq have dO = 0 and D = 0, so dS = 0 there)
      const bool inner = k0 + BT - 1 < Tk &&
                         k0 > qb + WG_ROWS - 1 - window &&
                         (!causal || k0 + BT - 1 <= qb);
      const EdgeMask em = edge_mask((long long)k0 - qb, window, causal);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i >> 2) + 2 * t4 + (i & 1);
        const int row = r_lo + ((i & 2) ? 8 : 0);
        bool ok = true;
        if (!inner) {
          const int x = col - row;
          ok = k0 + col < Tk && x > em.lo && x <= em.hi;
        }
        float p;
        sc[i] = p_ds(sc[i], dp[i], sl, (i & 2) ? l1 : l0, (i & 2) ? d1 : d0,
                     ok, p);
      }
      uint32_t xa[16];
      pack_a(sc, xa);
      fence_regs<8 * KS>(acc);
      fence_regs<16>(xa);
      wgmma_fence();
      issue_out<KS>(acc, xa, ks);       // dQ += dS K
      wgmma_commit();
      wgmma_wait0();
      fence_regs<8 * KS>(acc);
      fence_regs<16>(xa);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * s);
  }
  if (nq_w > 0)
    store_rows<KS>(dq + ((long long)bh * Tq + row_w) * Dh, acc, r_lo, nq_w,
                   Dh, scale, t4);
}

// -------------------------------------------------------- dk/dv kernel --

template <int KS>
__global__ void __launch_bounds__(NT, 1)
swa_bwd_dkdv_tc(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_do,
                const float* __restrict__ lse,
                const float* __restrict__ dsum, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int Hq, int Hkv, int Tq, int Tk,
                int Dh, long long window, int causal, long long q_offset,
                float scale) {
  constexpr int NB = n_box<KS>();
  constexpr uint32_t RB = rows_bytes<KS>();
  constexpr uint32_t TB = tile_bytes<KS>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = base;
  const uint32_t v_s = k_s + RB;
  const uint32_t ring = v_s + RB;       // stage s: Q at s 2 TB, dO after it
  const uint32_t ld_s = ring + STAGES * 2 * TB;     // lse, D per stage
  const uint32_t rows_bar = ld_s + STAGES * 2 * BT * 4;
  const uint32_t full_bar = rows_bar + 8;
  const uint32_t empty_bar = full_bar + 8 * STAGES;
  float* lsd = reinterpret_cast<float*>(smem_raw + (ld_s - smem_u32(smem_raw)));

  const int bkv = blockIdx.x;           // b * Hkv + kv head
  const int b = bkv / Hkv;
  const int rep = Hq / Hkv;
  const int h0 = (bkv % Hkv) * rep;     // the group's first query head
  const int k0 = blockIdx.y * BR;       // heaviest (earliest keys) first
  const int nk = min(BR, Tk - k0);

  // the query tiles whose windows reach the CTA's keys, for each head
  long long qa = causal ? k0 - q_offset : 0;
  if (qa < 0) qa = 0;
  long long qz = (long long)k0 + nk - 1 + window - 1 - q_offset;
  if (qz > Tq - 1) qz = Tq - 1;
  const int qt0 = qa <= qz ? (int)(qa / BT) : 0;
  const int nqt = qa <= qz ? (int)(qz / BT) - qt0 + 1 : 0;
  const int n_tiles = rep * nqt;

  if (threadIdx.x == 0) {
    mbar_init(rows_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1 + 32);   // the copies, lse / D's lanes
      mbar_init(empty_bar + 8 * s, CONSUMER_WARPS);
    }
    acp::mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp >= CONSUMER_WARPS) {
    // ------------------------------------------------------ producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    if (warp > CONSUMER_WARPS) return;
    if (lane == 0) {
      mbar_expect_tx(rows_bar, 2 * RB);
      for (int c = 0; c < NB; ++c)
        for (int g = 0; g < N_WG; ++g) {
          const uint32_t off = (c * N_WG + g) * BOX_BYTES;
          tma_load_3d(k_s + off, &tm_k, c * BOX_COLS, k0 + g * WG_ROWS, bkv,
                      rows_bar);
          tma_load_3d(v_s + off, &tm_v, c * BOX_COLS, k0 + g * WG_ROWS, bkv,
                      rows_bar);
        }
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const int hh = t / nqt;
      const int qq0 = (qt0 + t - hh * nqt) * BT;
      mbar_wait(empty_bar + 8 * s, ((t / STAGES) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(full_bar + 8 * s, 2 * TB);
        const uint32_t qs = ring + s * 2 * TB;
        for (int c = 0; c < NB; ++c) {
          tma_load_3d(qs + c * BOX_BYTES, &tm_q, c * BOX_COLS, qq0,
                      b * Hq + h0 + hh, full_bar + 8 * s);
          tma_load_3d(qs + TB + c * BOX_BYTES, &tm_do, c * BOX_COLS, qq0,
                      b * Hq + h0 + hh, full_bar + 8 * s);
        }
      }
      // lse (log2 units) and D of the tile's 64 queries into its stage
      const long long row = (long long)(b * Hq + h0 + hh) * Tq + qq0;
      float* L = lsd + s * 2 * BT;
      for (int r = lane; r < BT; r += 32) {
        const bool in = qq0 + r < Tq;
        L[r] = in ? lse[row + r] * LOG2E : 0.0f;
        L[BT + r] = in ? dsum[row + r] : 0.0f;
      }
      mbar_arrive(full_bar + 8 * s);
    }
    return;
  }

  // -------------------------------------------------------- consumers --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(CONSUMER_REGS));
  const int wg = warp >> 2;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  const int r_lo = (warp & 3) * 16 + g8;              // keys r_lo, r_lo + 8
  const int kb = k0 + wg * WG_ROWS;     // the warpgroup's first key
  const int nk_w = max(0, min(WG_ROWS, Tk - kb));
  const float sl = scale * LOG2E;

  float dK[8 * KS], dV[8 * KS];
#pragma unroll
  for (int i = 0; i < 8 * KS; ++i) dK[i] = dV[i] = 0.0f;

  mbar_wait(rows_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const int hh = t / nqt;
    const int qq0 = (qt0 + t - hh * nqt) * BT;
    const int nqv = min(BT, Tq - qq0);
    const long long qp0 = q_offset + qq0;             // position of query 0
    const uint32_t qs = ring + s * 2 * TB;
    mbar_wait(full_bar + 8 * s, (t / STAGES) & 1);
    const bool live = nk_w > 0 && (!causal || kb <= qp0 + nqv - 1) &&
                      kb + nk_w - 1 > qp0 - window;
    if (live) {
      float sc[32], dp[32];
      wgmma_fence();
      issue_ss(sc, k_s + wg * BOX_BYTES, N_WG * BOX_BYTES, qs, KS);
      issue_ss(dp, v_s + wg * BOX_BYTES, N_WG * BOX_BYTES, qs + TB, KS);
      wgmma_commit();
      wgmma_wait0();
      fence_regs<32>(sc);
      fence_regs<32>(dp);
      // S^T, dP^T: row = key, column = query; masks only where an edge
      // crosses this warpgroup's part of the tile
      const bool inner = kb + WG_ROWS - 1 < Tk && qq0 + BT - 1 < Tq &&
                         (!causal || kb + WG_ROWS - 1 <= qp0) &&
                         kb > qp0 + BT - 1 - window;
      const EdgeMask em = edge_mask((long long)kb - qp0, window, causal);
      const float* L = lsd + s * 2 * BT;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * t4;
        const float2 l2 = *reinterpret_cast<const float2*>(L + col);
        const float2 dd = *reinterpret_cast<const float2*>(L + BT + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const int c = col + (e & 1);
          const int row = r_lo + ((e & 2) ? 8 : 0);
          bool ok = true;
          if (!inner) {
            const int x = row - c;
            ok = row < nk_w && c < nqv && x > em.lo && x <= em.hi;
          }
          float p;
          dp[i] = p_ds(sc[i], dp[i], sl, (e & 1) ? l2.y : l2.x,
                       (e & 1) ? dd.y : dd.x, ok, p);
          sc[i] = p;
        }
      }
      // P^T's product first, so that its fragments are packed (and S^T's
      // registers free) before dS^T's are
      uint32_t pa[16], da[16];
      pack_a(sc, pa);
      fence_regs<8 * KS>(dV);
      fence_regs<16>(pa);
      wgmma_fence();
      issue_out<KS>(dV, pa, qs + TB);   // dV += P^T dO
      pack_a(dp, da);
      fence_regs<8 * KS>(dK);
      fence_regs<16>(da);
      wgmma_fence();
      issue_out<KS>(dK, da, qs);        // dK += dS^T Q
      wgmma_commit();
      wgmma_wait0();
      // the A fragments stay live until the products that read them end
      fence_regs<8 * KS>(dV);
      fence_regs<8 * KS>(dK);
      fence_regs<16>(pa);
      fence_regs<16>(da);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * s);
  }
  if (nk_w > 0) {
    const long long row = (long long)bkv * Tk + kb;
    store_rows<KS>(dk + row * Dh, dK, r_lo, nk_w, Dh, scale, t4);
    store_rows<KS>(dv + row * Dh, dV, r_lo, nk_w, Dh, 1.0f, t4);
  }
}

template <int KS>
int launch_tc(const CUtensorMap& mq, const CUtensorMap& mk,
              const CUtensorMap& mv, const CUtensorMap& mdo, const void* q,
              const void* dout, const void* o, const float* lse, float* dsum,
              void* dq, void* dk, void* dv, int B, int Hq, int Hkv, int Tq,
              int Tk, int Dh, int ld, long long window, int causal,
              long long q_offset, float scale, cudaStream_t st) {
  constexpr size_t smem1 = dq_smem<KS>();
  constexpr size_t smem2 = dkdv_smem<KS>();
  static bool ready = false;            // the attributes, set once
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        swa_bwd_dq_tc<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(swa_bwd_dkdv_tc<KS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem2);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const long long rows = (long long)B * Hq * Tq;
  const long long blocks = (rows + DSUM_THREADS / 32 - 1) / (DSUM_THREADS / 32);
  swa_bwd_dsum_kernel<<<(unsigned)(blocks < 8192 ? blocks : 8192),
                        DSUM_THREADS, 0, st>>>(
      (const bf16*)dout, (const bf16*)o, dsum, rows, Dh, ld);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  swa_bwd_dq_tc<KS><<<dim3(B * Hq, (Tq + BR - 1) / BR), NT, smem1, st>>>(
      mk, mv, (const bf16*)q, (const bf16*)dout, lse, dsum, (bf16*)dq, Hq,
      Hkv, Tq, Tk, Dh, ld, window, causal, q_offset, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  swa_bwd_dkdv_tc<KS><<<dim3(B * Hkv, (Tk + BR - 1) / BR), NT, smem2,
                        st>>>(
      mq, mk, mv, mdo, lse, dsum, (bf16*)dk, (bf16*)dv, Hq, Hkv, Tq, Tk, Dh,
      window, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Hq, Tq, *), k and v (B, Hkv, Tk, *), dout like q: rows of ld
// elements of which the first Dh are read (bf16: a packed copy's columns
// Dh .. ld are zeros; float32: ld == Dh); o (B, Hq, Tq, Dh) the forward's
// output and lse (B, Hq, Tq) float32 its logsumexp; dsum (B, Hq, Tq)
// float32 scratch (D); dq, dk, dv like q, k, v but with rows of Dh.  All
// contiguous, bf16 when is_bf16 (ld a multiple of 8, q, k, v and dout
// 16-byte aligned) else float32 (any 4-byte alignment); 1 <= Dh <= 128,
// ld >= Dh, Hq % Hkv == 0.
int swa_attention_bwd(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* dsum, void* dq, void* dk, void* dv, int B,
                      int Hq, int Hkv, int Tq, int Tk, int Dh, int ld,
                      long long window, int causal, long long q_offset,
                      float scale, int is_bf16, void* stream) {
  if (B <= 0 || Hq <= 0 || Tq <= 0) return (int)cudaGetLastError();
  if (Dh <= 0 || Dh > 128 || ld < Dh || Tk <= 0 || Hkv <= 0 ||
      Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (!is_bf16) {
    if (ld != Dh) return (int)cudaErrorInvalidValue;
    return swa_attention_bwd_tf32x3(
        (const float*)q, (const float*)k, (const float*)v, (const float*)o,
        (const float*)dout, lse, dsum, (float*)dq, (float*)dk, (float*)dv, B,
        Hq, Hkv, Tq, Tk, Dh, window, causal, q_offset, scale, stream);
  }
  if (ld % 8 != 0 || (Tq + BR - 1) / BR > 65535 ||
      (Tk + BR - 1) / BR > 65535 ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) %
              16 != 0)
    return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map(enc, &mq, q, B * Hq, Tq, Dh, ld) ||
      !make_map(enc, &mk, k, B * Hkv, Tk, Dh, ld) ||
      !make_map(enc, &mv, v, B * Hkv, Tk, Dh, ld) ||
      !make_map(enc, &mdo, dout, B * Hq, Tq, Dh, ld))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define SWA_BWD_TC_CASE(n)                                                   \
  case n:                                                                    \
    return launch_tc<n>(mq, mk, mv, mdo, q, dout, o, lse, dsum, dq, dk, dv,  \
                        B, Hq, Hkv, Tq, Tk, Dh, ld, window, causal,          \
                        q_offset, scale, st);
  switch ((Dh + 15) / 16) {
    SWA_BWD_TC_CASE(1)
    SWA_BWD_TC_CASE(2)
    SWA_BWD_TC_CASE(3)
    SWA_BWD_TC_CASE(4)
    SWA_BWD_TC_CASE(5)
    SWA_BWD_TC_CASE(6)
    SWA_BWD_TC_CASE(7)
    SWA_BWD_TC_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SWA_BWD_TC_CASE
}

}  // extern "C"
