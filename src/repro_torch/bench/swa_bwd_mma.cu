// The baseline of the sliding-window attention backward's A/B: the
// mma.sync kernels that computed dq, dk, dv of ops.swa_attention before
// csrc/swa_attention_bwd.cu (bf16 on wgmma, TMA) and
// csrc/swa_attention_bwd_tf32x3.cu (float32 in split TF32) replaced them.
// Nothing on the main path calls them; `python -m repro_torch.bench.lm_bwd`
// builds this file (with csrc/swa_attention.cu and swa_attention_tc.cu, so
// that the packed route's entry links to it) and times it in turns with
// the library's kernels.  Its entry point has the library's signature.
//
// The gradient is FlashAttention-2's, from the forward's saved logsumexp:
//     P  = exp(scale q k^T - lse) in the window, else 0
//     D  = rowsum(do o)                      (float32, o as saved)
//     dv = P^T do,   dP = do v^T,   dS = P (dP - D)
//     dq = scale dS k,   dk = scale dS^T q
// in float32; a row with no key in its window (lse -1e30) has P = 0.
//
// Two kernels, no atomics (two runs give the same bits):
//   * swa_bwd_dq_kernel: one CTA of 4 warps per (batch x query head, 64
//     queries), each warp 16 query rows; a prologue takes D of its rows
//     (one warp per row) and writes it out for the second kernel; then it
//     walks the key tiles of 64 that the rows' windows reach: S = Q K^T,
//     dP = dO V^T, P and dS on the accumulator fragments, dQ += dS K.
//   * swa_bwd_dkdv_kernel: one CTA of 4 warps per (batch x kv head, 64
//     keys), each warp 16 key rows; it walks the query heads of its group
//     in order and, for each, the query tiles of 32 that the keys'
//     windows reach: S^T = K Q^T, dP^T = V dO^T, then dV += P^T dO and
//     dK += dS^T Q.  A group's sum over its query heads is this fixed
//     loop, in registers.
// Its D comes from the dq kernel, which is launched first on the stream.
//
// Arithmetic (one template, two bodies):
//   * bf16: mma.sync m16n8k16 with float32 accumulators.  Q K^T and dO V^T
//     take bf16 operands from shared memory (exact products).  P and dS
//     are float32 on the accumulator fragments, which are the A fragments
//     of the next product as they stand; each is split into
//     hi = bf16(x) and lo = bf16(x - hi) and taken as hi B + lo B (about
//     16 bits of the float32 value, as the forward's P V), with B (dO, Q
//     or K, read [k][n]) loaded by ldmatrix.trans.  Dh pads to a multiple
//     of 16 (Dh 112: 7 depth steps).
//   * float32: the same fragments, computed by float32 FMAs on the CUDA
//     cores (each thread the elements an mma would give it; the A
//     operand of the register products travels by quad shuffles), so the
//     float32 route keeps float32 arithmetic throughout.
// Shared rows are DP + 8 bf16 or DP + 4 floats apart, so the fragments'
// loads meet 32 distinct banks.  Tiles come in by 16-byte loads (bf16
// always: the tensor-core route's Dh is a multiple of 8 and its data
// aligned, and the packed route packs q, k, v and do into rows of
// roundup(Dh, 8)), or 4-byte ones (float32 with Dh not a multiple of 4
// or unaligned data), one stage, the next tile after a barrier.
//
// Bound: operations.  The five products are 10 Dh operations per attended
// (query, key) pair at the bf16 tensor-core rate (float32: the FMA rate);
// the kernels issue S and dP twice (once in each kernel) and the split
// products twice, 16 Dh.
//
// The entry point has a plain C interface for ctypes and returns
// cudaGetLastError() after the second launch (or the first error).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "float_io.cuh"

namespace {

using bf16 = __nv_bfloat16;
using fio::store;
using fio::to_f32;

constexpr int NW = 4;                   // warps per CTA
constexpr int NT = NW * 32;             // threads per CTA
constexpr int BR = NW * 16;             // a CTA's own rows (queries or keys)
constexpr int BKT = 64;                 // keys per tile of the dq kernel
constexpr int BQT = 32;                 // queries per tile of the dk/dv one
constexpr float NEG = -1e30f;           // the forward's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
__host__ __device__ constexpr bool is_bf16() {
  return std::is_same<T, bf16>::value;
}

// Row stride, in elements, of a shared tile DP wide.
template <typename T, int DP>
__host__ __device__ constexpr int lds() {
  return is_bf16<T>() ? DP + 8 : DP + 4;
}

// rows x DP elements of src (row stride ld, nvalid rows, ncols columns)
// into dst (row stride lds), zero elsewhere.  vec: 16-byte loads (ld and
// ncols multiples of the vector, src 16-byte aligned).
template <typename T, int DP>
__device__ void load_tile(T* dst, const T* src, int ld, int rows, int nvalid,
                          int ncols, bool vec) {
  constexpr int LS = lds<T, DP>();
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    for (int idx = threadIdx.x; idx < rows * (DP / V); idx += NT) {
      const int r = idx / (DP / V);
      const int c = (idx - r * (DP / V)) * V;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < nvalid && c < ncols)
        val = *reinterpret_cast<const uint4*>(src + (long long)r * ld + c);
      *reinterpret_cast<uint4*>(dst + r * LS + c) = val;
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * DP; idx += NT) {
      const int r = idx / DP;
      const int c = idx - r * DP;
      const float x = (r < nvalid && c < ncols)
                          ? to_f32(src[(long long)r * ld + c]) : 0.0f;
      store(dst + r * LS + c, x);
    }
  }
}

// ------------------------------------------------------- bf16 products --

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Two float32 values (lower column first) as bf16x2 hi and lo registers.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ---------------------------------------------------------- products ----
//
// Fragments: a warp owns 16 rows; its thread (g = lane / 4, t = lane % 4)
// holds acc[n][0..1] = (row g, columns 8n + 2t, 8n + 2t + 1) and
// acc[n][2..3] = (row g + 8, the same columns), the m16n8 accumulator.

// acc (16 x 8 NTL) += A (16 x DP, rows of A) B^T, B given as NTL * 8 rows
// of DP (both [row][depth] in shared memory).
template <typename T, int DP, int NTL>
__device__ __forceinline__ void prod_ss(float (&acc)[NTL][4], const T* A,
                                        const T* B, int lane) {
  constexpr int LS = lds<T, DP>();
  const int g = lane >> 2;
  const int t = lane & 3;
  if constexpr (is_bf16<T>()) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const T* a = A + g * LS + 16 * kk + 2 * t;
      const uint32_t af[4] = {ld_u32(a), ld_u32(a + 8 * LS), ld_u32(a + 8),
                              ld_u32(a + 8 * LS + 8)};
#pragma unroll
      for (int n = 0; n < NTL; ++n) {
        const T* b = B + (8 * n + g) * LS + 16 * kk + 2 * t;
        mma16816(acc[n], af, ld_u32(b), ld_u32(b + 8));
      }
    }
  } else {
#pragma unroll 2
    for (int k = 0; k < DP; k += 4) {
      const float4 a0 = *reinterpret_cast<const float4*>(A + g * LS + k);
      const float4 a1 =
          *reinterpret_cast<const float4*>(A + (g + 8) * LS + k);
#pragma unroll
      for (int n = 0; n < NTL; ++n) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(B + (8 * n + 2 * t) * LS + k);
        const float4 b1 = *reinterpret_cast<const float4*>(
            B + (8 * n + 2 * t + 1) * LS + k);
        float* d = acc[n];
        d[0] = fmaf(a0.w, b0.w, fmaf(a0.z, b0.z,
               fmaf(a0.y, b0.y, fmaf(a0.x, b0.x, d[0]))));
        d[1] = fmaf(a0.w, b1.w, fmaf(a0.z, b1.z,
               fmaf(a0.y, b1.y, fmaf(a0.x, b1.x, d[1]))));
        d[2] = fmaf(a1.w, b0.w, fmaf(a1.z, b0.z,
               fmaf(a1.y, b0.y, fmaf(a1.x, b0.x, d[2]))));
        d[3] = fmaf(a1.w, b1.w, fmaf(a1.z, b1.z,
               fmaf(a1.y, b1.y, fmaf(a1.x, b1.x, d[3]))));
      }
    }
  }
}

// acc (16 x DP) += X (16 x 8 KT, float32 accumulator fragments) B, B given
// as 8 KT rows of DP ([depth][column] in shared memory).
template <typename T, int DP, int KT>
__device__ __forceinline__ void prod_rs(float (&acc)[DP / 8][4],
                                        const float (&x)[KT][4], const T* B,
                                        int lane) {
  constexpr int LS = lds<T, DP>();
  if constexpr (is_bf16<T>()) {
#pragma unroll
    for (int kk = 0; kk < KT / 2; ++kk) {
      uint32_t ah[4], al[4];
      split2(x[2 * kk][0], x[2 * kk][1], ah[0], al[0]);
      split2(x[2 * kk][2], x[2 * kk][3], ah[1], al[1]);
      split2(x[2 * kk + 1][0], x[2 * kk + 1][1], ah[2], al[2]);
      split2(x[2 * kk + 1][2], x[2 * kk + 1][3], ah[3], al[3]);
      const T* row = B + (16 * kk + (lane & 15)) * LS + (lane >> 4) * 8;
#pragma unroll
      for (int n = 0; n < DP / 8; n += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, row + 8 * n);
        mma16816(acc[n], ah, b[0], b[1]);
        mma16816(acc[n], al, b[0], b[1]);
        mma16816(acc[n + 1], ah, b[2], b[3]);
        mma16816(acc[n + 1], al, b[2], b[3]);
      }
    }
  } else {
    const int t = lane & 3;
    const int quad = lane & ~3;
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int tt = 0; tt < 4; ++tt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // depth index 8 j + 2 tt + e lives in thread tt of the quad
          const float a0 = __shfl_sync(FULL, x[j][e], quad | tt);
          const float a1 = __shfl_sync(FULL, x[j][2 + e], quad | tt);
          const T* b = B + (8 * j + 2 * tt + e) * LS + 2 * t;
#pragma unroll
          for (int n = 0; n < DP / 8; ++n) {
            const float2 bv = *reinterpret_cast<const float2*>(b + 8 * n);
            acc[n][0] = fmaf(a0, bv.x, acc[n][0]);
            acc[n][1] = fmaf(a0, bv.y, acc[n][1]);
            acc[n][2] = fmaf(a1, bv.x, acc[n][2]);
            acc[n][3] = fmaf(a1, bv.y, acc[n][3]);
          }
        }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.0f;
}

// Rows (16 from row0) x Dh columns of acc * mul into dst (row stride Dh),
// rows below nvalid only.
template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[DP / 8][4],
                                           int row0, int nvalid, int Dh,
                                           float mul, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= nvalid) continue;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * t + e;
        if (col < Dh)
          store(dst + (long long)row * Dh + col, acc[n][2 * r + e] * mul);
      }
  }
}

// ----------------------------------------------------------- dq kernel --

template <typename T, int DP>
constexpr size_t dq_smem() {
  return sizeof(T) * (size_t)(2 * BR + 2 * BKT) * lds<T, DP>() +
         sizeof(float) * 2 * BR;
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
swa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ o,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  float* __restrict__ dsum, T* __restrict__ dq, int Hq,
                  int Hkv, int Tq, int Tk, int Dh, int ld, int ncols,
                  long long window, int causal, long long q_offset,
                  float scale, int vec) {
  constexpr int LS = lds<T, DP>();
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);            // (BR, LS)
  T* dOs = Qs + BR * LS;                          // (BR, LS)
  T* Ks = dOs + BR * LS;                          // (BKT, LS)
  T* Vs = Ks + BKT * LS;                          // (BKT, LS)
  float* Ls = reinterpret_cast<float*>(Vs + BKT * LS);   // lse * log2 e
  float* Ds = Ls + BR;                                   // D

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;            // b * Hq + h
  const int hk = (bh % Hq) / (Hq / Hkv);
  const int b = bh / Hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;   // heaviest first
  const int nq = min(BR, Tq - q0);
  const long long row_q = (long long)bh * Tq + q0;
  const T* kp = k + (long long)(b * Hkv + hk) * Tk * ld;
  const T* vp = v + (long long)(b * Hkv + hk) * Tk * ld;

  load_tile<T, DP>(Qs, q + row_q * ld, ld, BR, nq, ncols, vec);
  load_tile<T, DP>(dOs, dout + row_q * ld, ld, BR, nq, ncols, vec);
  // prologue: D of the CTA's rows, one warp per row, in a fixed order
  for (int r = warp; r < BR; r += NW) {
    float acc = 0.0f;
    if (r < nq) {
      const T* dr = dout + (row_q + r) * ld;
      const T* orow = o + (row_q + r) * Dh;
      for (int c = lane; c < Dh; c += 32)
        acc = fmaf(to_f32(dr[c]), to_f32(orow[c]), acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(FULL, acc, off);
    if (lane == 0) {
      Ds[r] = acc;
      Ls[r] = r < nq ? lse[row_q + r] * LOG2E : 0.0f;
      if (r < nq) dsum[row_q + r] = acc;
    }
  }

  const long long qlo = q_offset + q0;
  const long long qhi = qlo + nq - 1;
  long long klo = qlo - window + 1;
  if (klo < 0) klo = 0;
  long long khi = Tk - 1;
  if (causal && qhi < khi) khi = qhi;
  const int kt0 = klo <= khi ? (int)(klo / BKT) : 0;
  const int kt1 = klo <= khi ? (int)(khi / BKT) : -1;
  const float sl = scale * LOG2E;
  const int wr = warp * 16;
  const long long wq = qlo + wr;        // position of the warp's row 0
  const bool warp_live = wr < nq;

  float acc[DP / 8][4];
  zero(acc);
  for (int kt = kt0; kt <= kt1; ++kt) {
    const int k0 = kt * BKT;
    __syncthreads();                    // the last tile read by every warp
    load_tile<T, DP>(Ks, kp + (long long)k0 * ld, ld, BKT, min(BKT, Tk - k0),
                     ncols, vec);
    load_tile<T, DP>(Vs, vp + (long long)k0 * ld, ld, BKT, min(BKT, Tk - k0),
                     ncols, vec);
    __syncthreads();
    const bool none = (causal && k0 > wq + 15) ||
                      (k0 + BKT - 1 <= wq - window);
    if (!warp_live || none) continue;
    float s[BKT / 8][4], dp[BKT / 8][4];
    zero(s);
    zero(dp);
    prod_ss<T, DP, BKT / 8>(s, Qs + wr * LS, Ks, lane);
    prod_ss<T, DP, BKT / 8>(dp, dOs + wr * LS, Vs, lane);
#pragma unroll
    for (int n = 0; n < BKT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = wr + g + 8 * (e >> 1);
        const long long qpos = qlo + row;
        const long long kpos = k0 + 8 * n + 2 * t + (e & 1);
        const bool ok = row < nq && kpos < Tk && kpos > qpos - window &&
                        (!causal || kpos <= qpos);
        const float p = ok ? exp2f(fmaf(s[n][e], sl, -Ls[row])) : 0.0f;
        s[n][e] = p * (dp[n][e] - Ds[row]);      // dS
      }
    prod_rs<T, DP, BKT / 8>(acc, s, Ks, lane);
  }
  if (warp_live)
    store_rows<T, DP>(dq + row_q * Dh, acc, wr, nq, Dh, scale, lane);
}

// -------------------------------------------------------- dk/dv kernel --

template <typename T, int DP>
constexpr size_t dkdv_smem() {
  return sizeof(T) * (size_t)(2 * BR + 2 * BQT) * lds<T, DP>() +
         sizeof(float) * 2 * BQT;
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
swa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, T* __restrict__ dk,
                    T* __restrict__ dv, int Hq, int Hkv, int Tq, int Tk,
                    int Dh, int ld, int ncols, long long window, int causal,
                    long long q_offset, float scale, int vec) {
  constexpr int LS = lds<T, DP>();
  extern __shared__ float4 smem4[];
  T* Ks = reinterpret_cast<T*>(smem4);            // (BR, LS)
  T* Vs = Ks + BR * LS;                           // (BR, LS)
  T* Qs = Vs + BR * LS;                           // (BQT, LS)
  T* dOs = Qs + BQT * LS;                         // (BQT, LS)
  float* Ls = reinterpret_cast<float*>(dOs + BQT * LS);
  float* Ds = Ls + BQT;

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

  load_tile<T, DP>(Ks, k + row_k * ld, ld, BR, nk, ncols, vec);
  load_tile<T, DP>(Vs, v + row_k * ld, ld, BR, nk, ncols, vec);

  // the queries whose windows reach the CTA's keys k0 .. k0 + nk - 1
  long long qa = causal ? k0 - q_offset : 0;
  if (qa < 0) qa = 0;
  long long qb = (long long)k0 + nk - 1 + window - 1 - q_offset;
  if (qb > Tq - 1) qb = Tq - 1;
  const int qt0 = qa <= qb ? (int)(qa / BQT) : 0;
  const int qt1 = qa <= qb ? (int)(qb / BQT) : -1;
  const float sl = scale * LOG2E;
  const int wr = warp * 16;
  const long long wk = (long long)k0 + wr;        // position of the warp's key 0
  const bool warp_live = wr < nk;

  float dK[DP / 8][4], dV[DP / 8][4];
  zero(dK);
  zero(dV);
  for (int hh = 0; hh < rep; ++hh) {
    const long long row_h = (long long)(b * Hq + h0 + hh) * Tq;
    for (int qt = qt0; qt <= qt1; ++qt) {
      const int qq0 = qt * BQT;
      const int nqv = min(BQT, Tq - qq0);
      __syncthreads();                  // the last tile read by every warp
      load_tile<T, DP>(Qs, q + (row_h + qq0) * ld, ld, BQT, nqv, ncols, vec);
      load_tile<T, DP>(dOs, dout + (row_h + qq0) * ld, ld, BQT, nqv, ncols,
                       vec);
      if (threadIdx.x < BQT) {
        const int r = threadIdx.x;
        Ls[r] = r < nqv ? lse[row_h + qq0 + r] * LOG2E : 0.0f;
        Ds[r] = r < nqv ? dsum[row_h + qq0 + r] : 0.0f;
      }
      __syncthreads();
      const long long qp0 = q_offset + qq0;        // position of query 0
      const bool none = (causal && wk > qp0 + BQT - 1) ||
                        (wk + 15 <= qp0 - window);
      if (!warp_live || none) continue;
      float s[BQT / 8][4], dp[BQT / 8][4];
      zero(s);
      zero(dp);
      prod_ss<T, DP, BQT / 8>(s, Ks + wr * LS, Qs, lane);     // S^T
      prod_ss<T, DP, BQT / 8>(dp, Vs + wr * LS, dOs, lane);   // dP^T
#pragma unroll
      for (int n = 0; n < BQT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int krow = wr + g + 8 * (e >> 1);
          const long long kpos = (long long)k0 + krow;
          const int qi = 8 * n + 2 * t + (e & 1);
          const long long qpos = qp0 + qi;
          const bool ok = krow < nk && qi < nqv && kpos > qpos - window &&
                          (!causal || kpos <= qpos);
          const float p = ok ? exp2f(fmaf(s[n][e], sl, -Ls[qi])) : 0.0f;
          s[n][e] = p;                               // P^T
          dp[n][e] = p * (dp[n][e] - Ds[qi]);        // dS^T
        }
      prod_rs<T, DP, BQT / 8>(dV, s, dOs, lane);
      prod_rs<T, DP, BQT / 8>(dK, dp, Qs, lane);
    }
  }
  if (warp_live) {
    store_rows<T, DP>(dk + row_k * Dh, dK, wr, nk, Dh, scale, lane);
    store_rows<T, DP>(dv + row_k * Dh, dV, wr, nk, Dh, 1.0f, lane);
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dsum, void* dq,
           void* dk, void* dv, int B, int Hq, int Hkv, int Tq, int Tk,
           int Dh, int ld, int ncols, long long window, int causal,
           long long q_offset, float scale, int vec, cudaStream_t st) {
  constexpr size_t s1 = dq_smem<T, DP>();
  constexpr size_t s2 = dkdv_smem<T, DP>();
  static bool ready = false;            // the attributes, set once
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        swa_bwd_dq_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)s1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(swa_bwd_dkdv_kernel<T, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)s2);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const dim3 g1(B * Hq, (Tq + BR - 1) / BR);
  swa_bwd_dq_kernel<T, DP><<<g1, NT, s1, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout,
      lse, dsum, (T*)dq, Hq, Hkv, Tq, Tk, Dh, ld, ncols, window, causal,
      q_offset, scale, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 g2(B * Hkv, (Tk + BR - 1) / BR);
  swa_bwd_dkdv_kernel<T, DP><<<g2, NT, s2, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dsum,
      (T*)dk, (T*)dv, Hq, Hkv, Tq, Tk, Dh, ld, ncols, window, causal,
      q_offset, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dp(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* dsum, void* dq,
              void* dk, void* dv, int B, int Hq, int Hkv, int Tq, int Tk,
              int Dh, int ld, int ncols, long long window, int causal,
              long long q_offset, float scale, int vec, cudaStream_t st) {
#define SWA_BWD_CASE(n)                                                      \
  case n:                                                                    \
    return launch<T, 16 * n>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, Hq, \
                             Hkv, Tq, Tk, Dh, ld, ncols, window, causal,     \
                             q_offset, scale, vec, st);
  switch ((Dh + 15) / 16) {
    SWA_BWD_CASE(1)
    SWA_BWD_CASE(2)
    SWA_BWD_CASE(3)
    SWA_BWD_CASE(4)
    SWA_BWD_CASE(5)
    SWA_BWD_CASE(6)
    SWA_BWD_CASE(7)
    SWA_BWD_CASE(8)
  }
#undef SWA_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (B, Hq, Tq, *), k and v (B, Hkv, Tk, *), dout like q: rows of ld
// elements of which the first Dh are read (bf16: a packed copy's columns
// Dh .. ld are zeros); o (B, Hq, Tq, Dh) the forward's output and lse
// (B, Hq, Tq) float32 its logsumexp; dsum (B, Hq, Tq) float32 scratch (D);
// dq, dk, dv like q, k, v but with rows of Dh.  All contiguous, bf16 when
// is_bf16 else float32; 1 <= Dh <= 128, ld >= Dh, Hq % Hkv == 0.
int swa_attention_bwd(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* dsum, void* dq, void* dk, void* dv, int B,
                      int Hq, int Hkv, int Tq, int Tk, int Dh, int ld,
                      long long window, int causal, long long q_offset,
                      float scale, int is_bf16, void* stream) {
  if (B <= 0 || Hq <= 0 || Tq <= 0) return (int)cudaGetLastError();
  if (Dh <= 0 || Dh > 128 || ld < Dh || Tk <= 0 || Hkv <= 0 ||
      Hq % Hkv != 0 || (Tq + BR - 1) / BR > 65535 ||
      (Tk + BR - 1) / BR > 65535)
    return (int)cudaErrorInvalidValue;
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(dout)) & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    const int vec = aligned && ld % 8 == 0;
    return launch_dp<bf16>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, Hq,
                           Hkv, Tq, Tk, Dh, ld, vec ? ld : Dh, window,
                           causal, q_offset, scale, vec, st);
  }
  const int vec = aligned && ld % 4 == 0 && Dh % 4 == 0;
  return launch_dp<float>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, Hq,
                          Hkv, Tq, Tk, Dh, ld, Dh, window, causal, q_offset,
                          scale, vec, st);
}

}  // extern "C"
