// Hand-written Hopper (sm_90a) kernel for sliding-window flash attention in
// float32 on the tensor cores: the float32 route of ops.swa_attention.
//
// Replaces, for float32 q, k, v, the reference's Pallas TPU kernel
//   src/repro/kernels/swa_attention.py _swa_kernel (:32), launched by
//   swa_attention (:81) through its pallas_call (:102).
// bf16 takes swa_attention_tc.cu (in place for Dh a multiple of 8 and
// aligned data, else on the copy swa_attention.cu packs);
// kernels/swa_attention.py swa_route names the choice.
//
// What it computes is what swa_attention_tc.cu computes: for q (B, Hq, Tq,
// Dh) and k, v (B, Hkv, Tk, Dh), query row t (position q_offset + t) of head h
// attends to the keys of kv head h / (Hq / Hkv) (GQA by index, no copy of K
// or V) at positions kpos with
//     kpos < Tk,  kpos > qpos - window,  and kpos <= qpos when causal,
// by the online-softmax recurrence with float32 state: scores masked to
// -1e30, m' = max(m, rowmax s), p = exp(s - m'), l = l exp(m - m') + rowsum p,
// acc = acc exp(m - m') + p V, out = acc / max(l, 1e-30).  A query with no
// key in its window gets 0.  When asked, it also writes each row's
// logsumexp, m scale + ln l, for the backward (swa_attention_bwd.cu).
//
// Arithmetic: split TF32.  Each float32 operand x is split into
// hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest with ties
// away (the rounding of cvt.rna.tf32, done here on the bits: add half an
// ulp of the 10-bit mantissa, clear the 13 low bits).  A product is taken
// as hi*hi + hi*lo + lo*hi, three mma.sync m16n8k8 TF32 products into one
// float32 accumulator; hi*lo and lo*hi are exact in float32 and lo*lo
// (~2^-22 relative) is dropped, so each product keeps ~21 bits of each
// operand where plain TF32 keeps 11.  This holds the reference's float32
// tolerance (2e-5); plain TF32 does not (tests/test_torch_lm_kernels.py
// emulates both).  Both products, Q K^T and P V, are taken this way.  The
// tensor cores' own additions into an accumulator do not round to
// nearest, and their error grows with the number of additions: so a
// tile's P V is accumulated from zero (12 additions) and added to O by a
// float32 FMA, and O's sum over thousands of keys rounds to nearest.
//
// Design for the card.
//   * One CTA of 8 warps per (batch x query head, 128 queries); each warp
//     owns 16 query rows, the M of an m16n8k8 tile.  Q is loaded once,
//     split, and kept as hi and lo in shared memory.
//   * K and V tiles of 32 keys, raw float32, go by 16-byte cp.async (4-byte
//     when Dh is not a multiple of 4 or the data is not 16-byte aligned)
//     into a 2-stage ring; the next tile's copy runs under the current
//     tile's products.  Operands are split as they are read from shared
//     memory.  Columns past Dh and rows past Tk are zero-filled by the
//     copies (src-size 0), so the depth pads to a multiple of 16 and the
//     ragged Tq and Tk need no padded copy.
//   * Fragment layouts.  Q K^T reads A (Q) and B (K) with the depth order
//     inside each 8-deep step permuted (logical k = t <-> depth 2t, t + 4
//     <-> 2t + 1), so a0/a2 and b0/b1 are one 8-byte shared load each.  For
//     P V the keys take the same permutation: the accumulator of S holds
//     keys 2t and 2t + 1 of a row pair, which is then exactly the A
//     operand of P V (no shuffle, no trip through shared memory), and V is
//     read at rows 2t and 2t + 1.  Row strides: Q and K rows at 8 (mod 16)
//     floats (the 8-byte loads of a half-warp meet 16 bank pairs), V rows
//     at 4 (mod 8) (rows 2t, columns g meet 32 banks).
//   * Online softmax in float32 registers on the accumulator fragments:
//     a thread holds 2 rows x 8 scores of a tile; row maxima take two quad
//     shuffles, the normaliser stays a per-thread partial until the end.
//     The scale is folded into the exponent's FMA (exp2 of s * c - m * c,
//     c = scale * log2 e).  Masks are evaluated only on tiles that a
//     window or causal edge or Tk crosses, per warp; a warp none of whose
//     rows meets a tile skips it.
//   * The tile skip is loop bounds: the CTA walks only the kv tiles that
//     meet its queries' windows; the heaviest query tiles are scheduled
//     first.
//
// Bound: operations.  4 Dh float32 operations per attended (query, key)
// pair; taken as 3 TF32 products each, that is 12 Dh at the card's TF32
// tensor-core rate (495 TFLOP/s), against 4 Dh at the float32 FMA rate
// (67 TFLOP/s) on the CUDA cores.  mma.sync does not reach the rate
// wgmma does; wgmma takes TF32 operands K-major only, and V is MN-major as
// stored, so P V would need a transposed V tile (later work).
//
// The entry point has a plain C interface for ctypes and returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int NW = 8;                   // warps per CTA, 16 query rows each
constexpr int BQ = NW * 16;             // query rows per CTA
constexpr int BK = 32;                  // keys per kv tile
constexpr int NT = NW * 32;             // threads per CTA
constexpr int STAGES = 2;               // kv ring depth
constexpr float NEG = -1e30f;           // the reference's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// Row strides in floats of the shared tiles at padded depth DP (a multiple
// of 16): Q and K rows at 8 (mod 16), V rows at 4 (mod 8); all multiples of
// 4, so every row starts 16-byte aligned.
template <int DP>
__host__ __device__ constexpr int ld_qk() { return DP + 8; }
template <int DP>
__host__ __device__ constexpr int ld_v() { return DP + 4; }

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)2 * BQ * ld_qk<DP>() +
                          (size_t)STAGES * BK * (ld_qk<DP>() + ld_v<DP>()));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

using namespace tf32x3;

// d += A B in split TF32: lo*hi + hi*lo + hi*hi.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// BK rows x DP columns of src (row stride Dh floats, rows_valid rows) into
// dst (row stride ld), zero past Dh and past rows_valid.  vec: 16-byte
// copies (Dh % 4 == 0 and src 16-byte aligned), else 4-byte ones.
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          int rows_valid, int Dh, bool vec) {
  if (vec) {
    constexpr int C4 = DP / 4;
    for (int idx = threadIdx.x; idx < BK * C4; idx += NT) {
      const int r = idx / C4;
      const int c = (idx - r * C4) * 4;
      const bool ok = r < rows_valid && c < Dh;
      cp_async16(smem_u32(dst + r * ld + c),
                 ok ? src + (long long)r * Dh + c : src, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < BK * DP; idx += NT) {
      const int r = idx / DP;
      const int c = idx - r * DP;
      const bool ok = r < rows_valid && c < Dh;
      cp_async4(smem_u32(dst + r * ld + c),
                ok ? src + (long long)r * Dh + c : src, ok ? 4 : 0);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(NT, 1)
swa_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  int Hq, int Hkv, int Tq, int Tk, int Dh, long long window,
                  int causal, long long q_offset, float scale, int vec,
                  float* __restrict__ lse) {
  constexpr int LQ = ld_qk<DP>();
  constexpr int LV = ld_v<DP>();
  constexpr int KSTEPS = DP / 8;        // depth steps of Q K^T
  constexpr int NO = DP / 8;            // 8-column output tiles of P V
  constexpr int NS = BK / 8;            // key groups of a tile
  extern __shared__ float4 smem4[];
  float* Qh = reinterpret_cast<float*>(smem4);   // (BQ, LQ) hi
  float* Ql = Qh + BQ * LQ;                      // (BQ, LQ) lo
  float* Ks = Ql + BQ * LQ;                      // (STAGES, BK, LQ)
  float* Vs = Ks + STAGES * BK * LQ;             // (STAGES, BK, LV)

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;              // groupID: rows g and g + 8
  const int t = lane & 3;               // thread in group
  const int bh = blockIdx.x;            // b * Hq + h
  const int h = bh % Hq;
  const int b = bh / Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int nq = min(BQ, Tq - q0);

  const float* qp = q + ((long long)bh * Tq + q0) * Dh;
  const float* kp = k + (long long)(b * Hkv + hk) * Tk * Dh;
  const float* vp = v + (long long)(b * Hkv + hk) * Tk * Dh;

  const long long qlo = q_offset + q0;
  const long long qhi = qlo + nq - 1;
  long long klo = qlo - window + 1;
  if (klo < 0) klo = 0;
  long long khi = Tk - 1;
  if (causal && qhi < khi) khi = qhi;
  const bool any = klo <= khi;
  const int kt0 = any ? (int)(klo / BK) : 0;
  const int kt1 = any ? (int)(khi / BK) : -1;

  if (any) {
    load_tile<DP>(Ks, LQ, kp + (long long)kt0 * BK * Dh,
                  min(BK, Tk - kt0 * BK), Dh, vec);
    load_tile<DP>(Vs, LV, vp + (long long)kt0 * BK * Dh,
                  min(BK, Tk - kt0 * BK), Dh, vec);
    cp_commit();
  }

  // Q, split once into hi and lo (zero past Dh and past Tq)
  {
    constexpr int C4 = DP / 4;
    for (int idx = threadIdx.x; idx < BQ * C4; idx += NT) {
      const int r = idx / C4;
      const int c = (idx - r * C4) * 4;
      float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (r < nq) {
        const float* s = qp + (long long)r * Dh + c;
        if (vec) {
          if (c < Dh) {
            const float4 f = __ldg(reinterpret_cast<const float4*>(s));
            x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c + e < Dh) x[e] = __ldg(s + e);
        }
      }
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(x[e], hi[e], lo[e]);
      *reinterpret_cast<uint4*>(Qh + r * LQ + c) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(Ql + r * LQ + c) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }

  const float c_log2 = scale * LOG2E;
  const int wr = warp * 16;             // the warp's first row in the tile
  const bool warp_live = wr < nq;
  const long long wq_lo = qlo + wr;     // positions of the warp's rows
  const long long wq_hi = wq_lo + 15;
  float m_i[2] = {NEG, NEG}, l_i[2] = {0.0f, 0.0f};
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;

  for (int kt = kt0; kt <= kt1; ++kt) {
    const int st = (kt - kt0) & 1;
    if (kt < kt1) {
      const int k1 = (kt + 1) * BK;
      load_tile<DP>(Ks + (st ^ 1) * BK * LQ, LQ, kp + (long long)k1 * Dh,
                    min(BK, Tk - k1), Dh, vec);
      load_tile<DP>(Vs + (st ^ 1) * BK * LV, LV, vp + (long long)k1 * Dh,
                    min(BK, Tk - k1), Dh, vec);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();                    // tile kt (and Q) visible to all

    const long long k0 = (long long)kt * BK;
    const bool none = (causal && k0 > wq_hi) ||
                      (k0 + BK - 1 < wq_lo - window + 1);
    if (warp_live && !none) {
      const bool full = k0 + BK <= Tk && (!causal || k0 + BK - 1 <= wq_lo) &&
                        k0 >= wq_hi - window + 1;
      const float* Kt = Ks + st * BK * LQ;
      const float* Vt = Vs + st * BK * LV;

      // S = Q K^T, 16 rows x 32 keys per warp
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
      const float* qh0 = Qh + (wr + g) * LQ + 2 * t;   // rows g, g + 8
      const float* ql0 = Ql + (wr + g) * LQ + 2 * t;
      const float* k0p = Kt + g * LQ + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const int d = 8 * kk;
        const float2 h0 = *reinterpret_cast<const float2*>(qh0 + d);
        const float2 h1 = *reinterpret_cast<const float2*>(qh0 + 8 * LQ + d);
        const float2 l0 = *reinterpret_cast<const float2*>(ql0 + d);
        const float2 l1 = *reinterpret_cast<const float2*>(ql0 + 8 * LQ + d);
        const uint32_t ah[4] = {__float_as_uint(h0.x), __float_as_uint(h1.x),
                                __float_as_uint(h0.y), __float_as_uint(h1.y)};
        const uint32_t al[4] = {__float_as_uint(l0.x), __float_as_uint(l1.x),
                                __float_as_uint(l0.y), __float_as_uint(l1.y)};
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float2 kv =
              *reinterpret_cast<const float2*>(k0p + 8 * n * LQ + d);
          mma3(s[n], ah, al, kv.x, kv.y);
        }
      }

      // masks, only where an edge crosses the warp's part of the tile;
      // s[n][e]: row g + 8 (e >> 1), key 8 n + 2 t + (e & 1)
      if (!full) {
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const long long kpos = k0 + 8 * n + 2 * t + (e & 1);
            const long long qpos = wq_lo + g + 8 * (e >> 1);
            const bool ok = kpos < Tk && kpos > qpos - window &&
                            (!causal || kpos <= qpos);
            if (!ok) s[n][e] = NEG;
          }
      }

      // online softmax on the fragments (rows g and g + 8)
      float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      }
      float corr[2], mc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        corr[r] = exp2f((m_i[r] - mx[r]) * c_log2);
        // a row with no key yet keeps p = 0 (not exp2(0) = 1)
        mc[r] = mx[r] == NEG ? 0.0f : mx[r] * c_log2;
        m_i[r] = mx[r];
        l_i[r] *= corr[r];
      }
      // P, split; the key group j of S is the A operand of step j of P V
      // as it stands (keys 2t, 2t + 1 <-> logical k t, t + 4)
      uint32_t ph[NS][4], pl[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fmaf(s[j][e], c_log2, -mc[e >> 1]));
          l_i[e >> 1] += p;
          // c0, c1, c2, c3 -> a0, a2, a1, a3
          const int a = (e >> 1) | ((e & 1) << 1);
          split(p, ph[j][a], pl[j][a]);
        }

      // O = O corr + P V: the tile's product from zero on the tensor
      // cores (12 accumulations), added to O by one rounded FMA, so that
      // O's accumulation over the tiles is float32 round-to-nearest
      const float* v0 = Vt + 2 * t * LV + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        float pv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < NS; ++j)
          mma3(pv, ph[j], pl[j], v0[8 * j * LV + 8 * n],
               v0[(8 * j + 1) * LV + 8 * n]);
        o[n][0] = fmaf(o[n][0], corr[0], pv[0]);
        o[n][1] = fmaf(o[n][1], corr[0], pv[1]);
        o[n][2] = fmaf(o[n][2], corr[1], pv[2]);
        o[n][3] = fmaf(o[n][3], corr[1], pv[3]);
      }
    }
    __syncthreads();                    // stage st read by every warp
  }

  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(FULL, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(FULL, l_i[r], 2);
  }
  float* op = out + ((long long)bh * Tq + q0) * Dh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wr + g + 8 * r;
    if (row >= nq) continue;
    const float inv_l = 1.0f / fmaxf(l_i[r], 1e-30f);
    const bool empty = m_i[r] == NEG;   // no key in this query's window
    if (lse != nullptr && t == 0)       // the backward's logsumexp
      lse[(long long)bh * Tq + q0 + row] =
          empty ? NEG : m_i[r] * scale + logf(l_i[r]);
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * t + e;
        if (col < Dh)
          op[(long long)row * Dh + col] =
              empty ? 0.0f : o[n][2 * r + e] * inv_l;
      }
  }
}

template <int DP>
int launch(const float* q, const float* k, const float* v, float* out, int B,
           int Hq, int Hkv, int Tq, int Tk, int Dh, long long window,
           int causal, long long q_offset, float scale, int vec, float* lse,
           cudaStream_t st) {
  constexpr size_t smem = smem_bytes<DP>();
  static bool ready = false;            // the attribute, set once
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        swa_tf32x3_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const dim3 grid(B * Hq, (Tq + BQ - 1) / BQ);
  swa_tf32x3_kernel<DP><<<grid, NT, smem, st>>>(
      q, k, v, out, Hq, Hkv, Tq, Tk, Dh, window, causal, q_offset, scale,
      vec, lse);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Hq, Tq, Dh), k and v (B, Hkv, Tk, Dh), out like q; all contiguous
// float32; 1 <= Dh <= 128, Hq % Hkv == 0.  Any alignment of 4 bytes.  lse:
// null, or (B, Hq, Tq) float32 for each row's logsumexp (as
// swa_attention_tc_fwd's).
int swa_attention_tf32x3_fwd(const float* q, const float* k, const float* v,
                             float* out, int B, int Hq, int Hkv, int Tq,
                             int Tk, int Dh, long long window, int causal,
                             long long q_offset, float scale, float* lse,
                             void* stream) {
  if (B <= 0 || Hq <= 0 || Tq <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int vec = Dh % 4 == 0 &&
                  ((reinterpret_cast<uintptr_t>(q) |
                    reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) & 15) == 0;
#define SWA_TF32X3_CASE(n)                                                    \
  case n:                                                                     \
    return launch<16 * n>(q, k, v, out, B, Hq, Hkv, Tq, Tk, Dh, window,       \
                          causal, q_offset, scale, vec, lse, st);
  switch ((Dh + 15) / 16) {
    SWA_TF32X3_CASE(1)
    SWA_TF32X3_CASE(2)
    SWA_TF32X3_CASE(3)
    SWA_TF32X3_CASE(4)
    SWA_TF32X3_CASE(5)
    SWA_TF32X3_CASE(6)
    SWA_TF32X3_CASE(7)
    SWA_TF32X3_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SWA_TF32X3_CASE
}

}  // extern "C"
