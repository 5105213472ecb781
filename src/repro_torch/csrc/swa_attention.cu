// Hand-written Hopper (sm_90a) kernel for sliding-window flash attention on
// the CUDA cores: the route of ops.swa_attention for bf16 q, k, v that the
// tensor-core kernel (swa_attention_tc.cu) does not take, a head size that
// is not a multiple of 8 or data that is not 16-byte aligned.  float32
// takes swa_attention_tf32x3.cu; kernels/swa_attention.py swa_route names
// the choice.
//
// Replaces the reference's Pallas TPU kernel
//   src/repro/kernels/swa_attention.py _swa_kernel (:32), launched by
//   swa_attention (:81) through its pallas_call (:102).
//
// What it computes: for q (B, Hq, Tq, Dh) and k, v (B, Hkv, Tk, Dh), query
// row t (position q_offset + t) of head h attends to the keys of kv head
// h / (Hq / Hkv) (GQA by index, no copy of K or V) at positions kpos with
//     kpos < Tk,  kpos > qpos - window,  and kpos <= qpos when causal,
// by the online-softmax recurrence of the reference, in float32:
//     s = (q . k) * scale, masked to -1e30;  m' = max(m, rowmax s);
//     p = exp(s - m');  l = l * exp(m - m') + rowsum p;
//     acc = acc * exp(m - m') + p V;   out = acc / max(l, 1e-30).
// A query with no key in its window gets 0 (its m stays -1e30).  bf16
// inputs and output.
//
// What changes on the card.  The Pallas grid is (batch x head, q tile, kv
// tile) with the kv axis sequential and fully masked kv tiles skipped by
// pl.when(live).  Here one CTA takes one (batch x query head, query tile of
// 64 rows) and walks, in order, only the kv tiles of 64 keys that meet
// [q_lo - window + 1, q_hi] (all keys after q_lo - window + 1 when not
// causal): the skip becomes loop bounds.  The running max, normaliser and
// the (64, Dh) accumulator stay in registers in float32.  The ragged ends
// of Tq and Tk are masked here (loads past the end read as 0, keys past Tk
// are masked, rows past Tq are not stored), so the wrapper makes no padded
// copies — and, unlike the reference's padded non-causal call, no padded
// key is ever attended.  The heaviest query tiles are scheduled first
// (the last tiles of a causal sequence see the most keys).
//
// Layout of the work: 256 threads as a 16 x 16 grid.  Thread (ty, tx) owns
// rows ty + 16 i (i < 4) of the tile: scores of keys tx + 16 j (j < 4) and
// output columns tx + 16 c (c < NC).  Q, K and V tiles are converted to
// float32 in shared memory (Q and K rows at an odd stride, so the 16 keys
// a warp reads lie in 16 banks); the probabilities go through shared memory
// to the P V product.  ~103 KB of shared memory at Dh 112: two CTAs per SM.
//
// Bound: operations.  4 * Dh flops per (query, attended key) pair; the
// products are float32 FMAs on the CUDA cores (67 TFLOP/s), not the tensor
// cores — the reference's bodies compute in float32 and this kernel keeps
// that arithmetic.  Unaligned data rules out the TMA copies of the
// tensor-core kernel, and cp.async with mma.sync is later work.
//
// The entry point has a plain C interface for ctypes and returns
// cudaGetLastError() after its launch.

#include "float_io.cuh"

namespace {

using fio::store;
using fio::to_f32;

constexpr int BQ = 64;                  // query rows per CTA
constexpr int BK = 64;                  // keys per kv tile
constexpr int NT = 256;                 // threads per CTA (16 x 16)
constexpr int LDP = BK + 1;             // row stride of the P tile
constexpr float NEG = -1e30f;           // the reference's mask value

__host__ __device__ inline int odd_stride(int dh) { return dh | 1; }

// rows x dh of src (row stride dh elements) into dst (row stride ld floats)
// as float32, rows at or past n_valid and columns past dh read as 0.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int rows, int n_valid, int dh,
                                          int cols) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += NT) {
    const int r = idx / cols;
    const int d = idx - r * cols;
    dst[r * ld + d] = (r < n_valid && d < dh)
                          ? to_f32(src[(long long)r * dh + d]) : 0.0f;
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(NT, 2)
swa_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ out, int Hq, int Hkv,
           int Tq, int Tk, int Dh, long long window, int causal,
           long long q_offset, float scale) {
  extern __shared__ float smem[];
  const int ld = odd_stride(Dh);
  const int ldv = NC * 16;
  float* Qs = smem;                     // (BQ, ld)
  float* Ks = Qs + BQ * ld;             // (BK, ld)
  float* Vs = Ks + BK * ld;             // (BK, ldv), columns >= Dh zero
  float* Ps = Vs + BK * ldv;            // (BQ, LDP)

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.x;            // b * Hq + h
  const int h = bh % Hq;
  const int b = bh / Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int nq = min(BQ, Tq - q0);
  const int nc = (Dh + 15) >> 4;        // live output column groups

  const T* qp = q + ((long long)bh * Tq + q0) * Dh;
  const T* kp = k + (long long)(b * Hkv + hk) * Tk * Dh;
  const T* vp = v + (long long)(b * Hkv + hk) * Tk * Dh;
  load_tile(Qs, ld, qp, BQ, nq, Dh, Dh);

  const long long qlo = q_offset + q0;
  const long long qhi = q_offset + q0 + nq - 1;
  long long klo = qlo - window + 1;
  if (klo < 0) klo = 0;
  long long khi = Tk - 1;
  if (causal && qhi < khi) khi = qhi;

  float m_i[4], l_i[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG;
    l_i[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  if (klo <= khi) {
    for (int k0 = (int)(klo / BK) * BK; k0 <= khi; k0 += BK) {
      __syncthreads();                  // the last tile's reads are done
      const int nk = min(BK, Tk - k0);
      load_tile(Ks, ld, kp + (long long)k0 * Dh, BK, nk, Dh, Dh);
      load_tile(Vs, ldv, vp + (long long)k0 * Dh, BK, nk, Dh, ldv);
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < Dh; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * ld + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long qpos = qlo + ty + 16 * i;
        float mx = NEG;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const long long kpos = k0 + tx + 16 * j;
          const bool ok = kpos < Tk && kpos > qpos - window &&
                          (!causal || kpos <= qpos);
          s[i][j] = ok ? s[i][j] * scale : NEG;
          mx = fmaxf(mx, s[i][j]);
        }
        // the 16 threads of a row are 16 consecutive lanes of one warp
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_i[i], mx);
        float rs = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = expf(s[i][j] - m_new);
          Ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
          rs += p;
        }
        for (int off = 8; off > 0; off >>= 1)
          rs += __shfl_xor_sync(0xffffffffu, rs, off);
        const float corr = expf(m_i[i] - m_new);
        l_i[i] = l_i[i] * corr + rs;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
        m_i[i] = m_new;
      }
      __syncthreads();                  // P complete

#pragma unroll 4
      for (int j = 0; j < BK; ++j) {
        float pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * LDP + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (c < nc) {
            const float vv = Vs[j * ldv + tx + 16 * c];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
          }
        }
      }
    }
  }

  T* op = out + ((long long)bh * Tq + q0) * Dh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    const float inv_l = 1.0f / fmaxf(l_i[i], 1e-30f);
    const bool none = m_i[i] == NEG;    // no key in this query's window
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < Dh) store(op + (long long)r * Dh + d,
                        none ? 0.0f : acc[i][c] * inv_l);
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int Tq, int Tk, int Dh, long long window,
           int causal, long long q_offset, float scale, cudaStream_t st) {
  const int ld = odd_stride(Dh);
  const size_t smem = sizeof(float) * ((size_t)(BQ + BK) * ld +
                                       (size_t)BK * NC * 16 +
                                       (size_t)BQ * LDP);
  auto kern = swa_kernel<T, NC>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * Hq, (Tq + BQ - 1) / BQ);
  kern<<<grid, NT, smem, st>>>((const T*)q, (const T*)k, (const T*)v,
                               (T*)out, Hq, Hkv, Tq, Tk, Dh, window, causal,
                               q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Hq, Tq, Dh), k and v (B, Hkv, Tk, Dh), out like q; all contiguous
// bf16; Dh <= 128, Hq % Hkv == 0.
int swa_attention_fwd(const void* q, const void* k, const void* v, void* out,
                      int B, int Hq, int Hkv, int Tq, int Tk, int Dh,
                      long long window, int causal, long long q_offset,
                      float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Tq <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  return Dh > 64 ? launch<__nv_bfloat16, 8>(q, k, v, out, B, Hq, Hkv, Tq,
                                            Tk, Dh, window, causal, q_offset,
                                            scale, st)
                 : launch<__nv_bfloat16, 4>(q, k, v, out, B, Hq, Hkv, Tq,
                                            Tk, Dh, window, causal, q_offset,
                                            scale, st);
}

}  // extern "C"
