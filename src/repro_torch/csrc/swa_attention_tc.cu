// Hand-written Hopper (sm_90a) kernel for sliding-window flash attention on
// the tensor cores: the bf16 route of ops.swa_attention.
//
// Replaces, for bf16 q, k, v, the reference's Pallas TPU kernel
//   src/repro/kernels/swa_attention.py _swa_kernel (:32), launched by
//   swa_attention (:81) through its pallas_call (:102).
// It reads q, k and v through TMA, which needs a 16-byte-aligned base and a
// row stride that is a multiple of 16 bytes: rows of ld bf16 (ld a multiple
// of 8, at least Dh), of which the first Dh are read.  Contiguous aligned
// data with Dh a multiple of 8 is read in place (ld = Dh, the
// "tensor_cores" route); any other bf16 data is first packed into such rows
// by swa_attention.cu (the "packed" route), which then calls this kernel's
// entry point.  float32 takes swa_attention_tf32x3.cu;
// kernels/swa_attention.py swa_route names the choice.
//
// What it computes: for q (B, Hq, Tq, Dh)
// and k, v (B, Hkv, Tk, Dh), query row t (position q_offset + t) of head h
// attends to the keys of kv head h / (Hq / Hkv) (GQA by index, no copy of K
// or V) at positions kpos with
//     kpos < Tk,  kpos > qpos - window,  and kpos <= qpos when causal,
// by the online-softmax recurrence with float32 state: scores masked to
// -1e30, m' = max(m, rowmax s), p = exp(s - m'), l = l exp(m - m') + rowsum p,
// acc = acc exp(m - m') + p V, out = acc / max(l, 1e-30) in bf16.  A query
// with no key in its window gets 0.  When asked (a gradient is wanted), it
// also writes each row's logsumexp, m ln 2 + ln l (m is kept in log2
// units), for the backward kernels of swa_attention_bwd.cu.
//
// Design for the card.
//   * One CTA per (batch x query head, 128 queries): two consumer
//     warpgroups of 64 query rows each and a producer warpgroup, one
//     thread of which issues the copies; setmaxnreg moves the producer's
//     registers to the consumers (40 and 232 a thread).
//   * Q K^T and P V are wgmma products with bf16 operands and float32
//     accumulators in registers.  Q K^T is m64n64k16 with both operands in
//     shared memory (K-major); P V takes P from registers and V from shared
//     memory (V is Dh-contiguous: the transposed, MN-major B operand), in
//     chunks of at most 64 output columns, one per 64-column box of V.
//   * Precision: P is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi)
//     and P V is accumulated as P_hi V + P_lo V, which keeps ~16 bits of
//     the float32 P of the reference (1.5x the operations of one product
//     pair).  Products of bf16 values are exact in float32.
//   * K/V tiles of 64 keys pass through a ring of 3 shared-memory stages,
//     filled by TMA (one thread of the producer warpgroup) and handed over
//     by mbarriers: full[s] completes on the copy's bytes, empty[s] when
//     the 8 consumer warps have finished reading the stage.  A 3-D tensor
//     map (Dh, T, B*H) with rows ld bf16 apart reads rows of Dh bf16 as
//     boxes of 64 columns (128 B, 128-byte swizzle) and zero-fills columns
//     past Dh and rows past T, so ragged Tq and Tk need no padded copy and
//     Dh pads to a multiple of 16 for the wgmma depth with zeros (an odd
//     Dh too: the output is then stored one bf16 at a time).
//   * Softmax stays in registers on the accumulator fragments: a thread
//     holds 2 rows x 16 scores of a tile; row maxima need two quad
//     shuffles, the normaliser stays a per-thread partial until the end.
//     Scores are kept in the log2 domain (scale * log2 e folded into the
//     exponent's FMA) and exponentiated by the SFU's ex2.
//   * The tile skip is loop bounds: the CTA walks only the kv tiles that
//     meet its queries' windows; a warpgroup none of whose rows meets a
//     tile only releases it.  Masks are evaluated only on tiles that a
//     window or causal edge or Tk crosses.  The heaviest query tiles are
//     scheduled first.
//   (Tried on the card and left out: issuing tile t's Q K^T with tile
//   t-1's P V so that the softmax overlaps the latter, and having the two
//   warpgroups take turns on the tensor cores; both were slower.)
//
// Bound: operations.  4 Dh flops per attended (query, key) pair at the bf16
// tensor-core rate; this kernel issues 6 Dh (the split P) plus the masked
// corners of the tiles it visits.
//
// The entry point has a plain C interface for ctypes and returns
// cudaGetLastError() (or the error of the tensor maps' creation) after its
// launch.  cuTensorMapEncodeTiled is a driver function; it is reached
// through cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include <cuda_bf16.h>

#include "async_copy.cuh"
#include "swa_wgmma.cuh"

namespace {

constexpr int WG_ROWS = 64;             // query rows per consumer warpgroup
constexpr int N_WG = 2;                 // consumer warpgroups per CTA
constexpr int BQ = N_WG * WG_ROWS;      // query rows per CTA
constexpr int BK = 64;                  // keys per kv tile
constexpr int STAGES = 3;               // kv ring depth
constexpr int NT = (N_WG + 1) * 128;    // + the producer warpgroup
constexpr int PRODUCER_REGS = 40;       // registers per thread after
constexpr int CONSUMER_REGS = 232;      // setmaxnreg (<= 64K per SM)
constexpr int CONSUMER_WARPS = N_WG * 4;
constexpr float NEG = -1e30f;           // the reference's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ------------------------------------------------------------ PTX helpers --

using acp::mbar_arrive;
using acp::mbar_expect_tx;
using acp::mbar_init;
using acp::mbar_wait;
using acp::smem_u32;
using acp::tma_load_3d;
using namespace swa_wg;

// Where a tile's scores are masked: key k0 + col against query qb + row,
// dk = k0 - qb, keys from col kvalid on past Tk.
struct TileMask {
  long long dk, window;
  int kvalid, causal;
};

// The online softmax of a tile's scores sc (the Q K^T accumulator, left
// as it is) for the thread's rows r_lo and r_lo + 8,
// in the log2 domain (scores times scale_log2; -1e30 where ``mask`` says,
// when ``masked``): new maxima and partial normalisers, the corrections
// c0, c1 of the earlier output, and P split into the A fragments of P V
// (P's accumulator fragment of keys 16 kk.. is the A fragment of the kk-th
// depth step).
__device__ __forceinline__ void softmax_tile(const float* sc, bool masked,
                                             const TileMask& mask, int r_lo,
                                             int t4, float scale_log2,
                                             float& m0, float& m1, float& l0,
                                             float& l1, float& c0, float& c1,
                                             uint32_t* ph, uint32_t* pl) {
  float v[32];                          // scores, scaled when masked
  const float sl = masked ? 1.0f : scale_log2;
  if (masked) {                         // a branch, not per score
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i >> 2) + 2 * t4 + (i & 1);
      const int row = r_lo + ((i & 2) ? 8 : 0);
      const long long d = mask.dk + col - row;  // kpos - qpos
      const bool ok = col < mask.kvalid && d > -mask.window &&
                      (!mask.causal || d <= 0);
      v[i] = ok ? sc[i] * scale_log2 : NEG;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = sc[i];
  }
  float mx0 = NEG, mx1 = NEG;
#pragma unroll
  for (int i = 0; i < 32; i += 4) {
    mx0 = fmaxf(mx0, fmaxf(v[i], v[i + 1]));
    mx1 = fmaxf(mx1, fmaxf(v[i + 2], v[i + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0 * sl), mn1 = fmaxf(m1, mx1 * sl);
  c0 = ex2(m0 - mn0);
  c1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float p[32];
  float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; i += 4) {
    p[i] = ex2(fmaf(v[i], sl, -mn0));
    p[i + 1] = ex2(fmaf(v[i + 1], sl, -mn0));
    p[i + 2] = ex2(fmaf(v[i + 2], sl, -mn1));
    p[i + 3] = ex2(fmaf(v[i + 3], sl, -mn1));
    rs0 += p[i] + p[i + 1];
    rs1 += p[i + 2] + p[i + 3];
  }
  l0 = l0 * c0 + rs0;
  l1 = l1 * c1 + rs1;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    split2(p[8 * kk], p[8 * kk + 1], ph[4 * kk], pl[4 * kk]);
    split2(p[8 * kk + 2], p[8 * kk + 3], ph[4 * kk + 1], pl[4 * kk + 1]);
    split2(p[8 * kk + 4], p[8 * kk + 5], ph[4 * kk + 2], pl[4 * kk + 2]);
    split2(p[8 * kk + 6], p[8 * kk + 7], ph[4 * kk + 3], pl[4 * kk + 3]);
  }
}

// ----------------------------------------------------------------- kernel --

// Shared memory, from a 1024-byte-aligned base (the 128-byte swizzle repeats
// every 1024 bytes): Q (nbox column boxes x 2 warpgroups of 64 rows), then
// STAGES stages of K (nbox boxes) and V (nbox boxes), then the barriers.
__global__ void __launch_bounds__(NT, 1)
swa_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
              const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v,
              __nv_bfloat16* __restrict__ out, int Hq, int Hkv, int Tq,
              int Tk, int Dh, long long window, int causal,
              long long q_offset, float scale_log2,
              float* __restrict__ lse) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int nbox = (Dh + BOX_COLS - 1) / BOX_COLS;
  const uint32_t q_s = base;
  const uint32_t stage_bytes = 2 * nbox * BOX_BYTES;
  const uint32_t kv_s = q_s + N_WG * nbox * BOX_BYTES;
  const uint32_t q_bar = kv_s + STAGES * stage_bytes;
  const uint32_t full_bar = q_bar + 8;
  const uint32_t empty_bar = full_bar + 8 * STAGES;

  const int bh = blockIdx.x;            // b * Hq + h
  const int h = bh % Hq;
  const int bkv = (bh / Hq) * Hkv + h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int nq = min(BQ, Tq - q0);

  // kv tiles that meet the windows of the CTA's queries
  const long long qlo = q_offset + q0;
  const long long qhi = qlo + nq - 1;
  long long klo = qlo - window + 1;
  if (klo < 0) klo = 0;
  long long khi = Tk - 1;
  if (causal && qhi < khi) khi = qhi;
  const int k_first = (int)(klo / BK) * BK;
  const int n_tiles = klo <= khi ? (int)((khi - k_first) / BK) + 1 : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
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
      mbar_expect_tx(q_bar, N_WG * nbox * BOX_BYTES);
      for (int c = 0; c < nbox; ++c)
        for (int g = 0; g < N_WG; ++g)
          tma_load_3d(q_s + (c * N_WG + g) * BOX_BYTES, &tm_q,
                      c * BOX_COLS, q0 + g * WG_ROWS, bh, q_bar);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(empty_bar + 8 * s, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(full_bar + 8 * s, stage_bytes);
        const int k0 = k_first + t * BK;
        const uint32_t ks = kv_s + s * stage_bytes;
        for (int c = 0; c < nbox; ++c) {
          tma_load_3d(ks + c * BOX_BYTES, &tm_k, c * BOX_COLS, k0, bkv,
                      full_bar + 8 * s);
          tma_load_3d(ks + (nbox + c) * BOX_BYTES, &tm_v, c * BOX_COLS, k0,
                      bkv, full_bar + 8 * s);
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
  const int nq_w = max(0, min(WG_ROWS, Tq - q0 - wg * WG_ROWS));
  const long long qb = q_offset + q0 + wg * WG_ROWS;  // position of row 0
  long long klo_w = qb - window + 1;
  if (klo_w < 0) klo_w = 0;
  long long khi_w = Tk - 1;
  if (causal && qb + nq_w - 1 < khi_w) khi_w = qb + nq_w - 1;

  const int ksteps = (Dh + 15) / 16;    // wgmma depth steps of Q K^T
  const int dpad = ksteps * 16;         // output columns computed
  const int n0 = min(dpad, 64);         // first output chunk (box 0)
  const int n1 = dpad - n0;             // second chunk (box 1), maybe 0

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.0f;
  float m0 = NEG, m1 = NEG;             // running max, rows r_lo, r_lo + 8
  float l0 = 0.0f, l1 = 0.0f;           // this thread's partial normaliser

  mbar_wait(q_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const int k0 = k_first + t * BK;
    const uint32_t ks = kv_s + s * stage_bytes;
    mbar_wait(full_bar + 8 * s, (t / STAGES) & 1);
    // a tile that meets no window of this warpgroup's rows is only released
    if (nq_w > 0 && k0 <= khi_w && k0 + BK - 1 >= klo_w) {
      float sc[32];
      wgmma_fence();
      issue_ss(sc, q_s + wg * BOX_BYTES, N_WG * BOX_BYTES, ks, ksteps);
      wgmma_commit();
      wgmma_wait0();
      fence_regs<32>(sc);
      // masks only where an edge crosses this warpgroup's part of the
      // tile; elsewhere the scale is folded into the exponent's FMA
      const bool inner = k0 + BK - 1 < Tk &&
                         k0 > qb + WG_ROWS - 1 - window &&
                         (!causal || k0 + BK - 1 <= qb);
      const TileMask mask = {(long long)k0 - qb, window, Tk - k0, causal};
      float c0, c1;
      uint32_t ph[16], pl[16];
      softmax_tile(sc, !inner, mask, r_lo, t4, scale_log2, m0, m1, l0, l1,
                   c0, c1, ph, pl);
#pragma unroll
      for (int i = 0; i < 64; i += 4) {
        o[i] *= c0;
        o[i + 1] *= c0;
        o[i + 2] *= c1;
        o[i + 3] *= c1;
      }
      fence_regs<64>(o);
      fence_regs<16>(ph);
      fence_regs<16>(pl);
      wgmma_fence();
      issue_rs<true, 2>(o, ph, pl, ks + nbox * BOX_BYTES, n0, n1);
      wgmma_commit();
      wgmma_wait0();
      fence_regs<64>(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * s);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = m0 == NEG ? 0.0f : 1.0f / fmaxf(l0, 1e-30f);
  const float inv1 = m1 == NEG ? 0.0f : 1.0f / fmaxf(l1, 1e-30f);
  const int row0 = q0 + wg * WG_ROWS + r_lo;
  if (lse != nullptr && t4 == 0) {      // the backward's logsumexp
    float* lp = lse + (long long)bh * Tq;
    if (row0 < Tq) lp[row0] = m0 == NEG ? NEG : m0 * LN2 + logf(l0);
    if (row0 + 8 < Tq)
      lp[row0 + 8] = m1 == NEG ? NEG : m1 * LN2 + logf(l1);
  }
  __nv_bfloat16* op = out + (long long)bh * Tq * Dh;
  if ((Dh & 1) == 0) {                  // column pairs lie 4-byte aligned
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col < Dh) {
        if (row0 < Tq)
          *reinterpret_cast<__nv_bfloat162*>(op + (long long)row0 * Dh +
                                             col) =
              __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
        if (row0 + 8 < Tq)
          *reinterpret_cast<__nv_bfloat162*>(op + (long long)(row0 + 8) * Dh +
                                             col) =
              __floats2bfloat162_rn(o[4 * j + 2] * inv1,
                                    o[4 * j + 3] * inv1);
      }
    }
  } else {                              // an odd Dh: one bf16 at a time
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t4 + e;
        if (col < Dh) {
          if (row0 < Tq)
            op[(long long)row0 * Dh + col] =
                __float2bfloat16_rn(o[4 * j + e] * inv0);
          if (row0 + 8 < Tq)
            op[(long long)(row0 + 8) * Dh + col] =
                __float2bfloat16_rn(o[4 * j + 2 + e] * inv1);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// q (B, Hq, Tq, Dh), k and v (B, Hkv, Tk, Dh) bf16 with rows ld elements
// apart (ld a multiple of 8, at least Dh) and 16-byte-aligned data; out
// like q, contiguous (rows Dh apart); 1 <= Dh <= 128, Hq % Hkv == 0.
// lse: null, or (B, Hq, Tq) float32 for each row's logsumexp of its scaled
// scores (-1e30 for a row with no key), which the backward reads.
int swa_attention_tc_fwd(const void* q, const void* k, const void* v,
                         void* out, int B, int Hq, int Hkv, int Tq, int Tk,
                         int Dh, int ld, long long window, int causal,
                         long long q_offset, float scale, float* lse,
                         void* stream) {
  if (B <= 0 || Hq <= 0 || Tq <= 0) return (int)cudaGetLastError();
  if (Dh <= 0 || Dh > 128 || ld % 8 != 0 || ld < Dh || Tk <= 0 ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap mq, mk, mv;
  if (!make_map(enc, &mq, q, B * Hq, Tq, Dh, ld) ||
      !make_map(enc, &mk, k, B * Hkv, Tk, Dh, ld) ||
      !make_map(enc, &mv, v, B * Hkv, Tk, Dh, ld))
    return (int)cudaErrorInvalidValue;
  const int nbox = (Dh + BOX_COLS - 1) / BOX_COLS;
  const size_t smem = 1024 + (size_t)(N_WG + 2 * STAGES) * nbox * BOX_BYTES +
                      8 * (1 + 2 * STAGES);
  cudaError_t e = cudaFuncSetAttribute(
      swa_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * Hq, (Tq + BQ - 1) / BQ);
  const float scale_log2 = scale * LOG2E;
  swa_tc_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      mq, mk, mv, (__nv_bfloat16*)out, Hq, Hkv, Tq, Tk, Dh, window, causal,
      q_offset, scale_log2, lse);
  return (int)cudaGetLastError();
}

}  // extern "C"
