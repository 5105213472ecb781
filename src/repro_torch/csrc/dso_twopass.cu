// Hand-written Hopper (sm_90a) kernels for the legacy two-pass dense tile
// step: the primal pass and the dual pass.
//
// Replaces the reference's Pallas TPU kernels of
// src/repro/kernels/dso_update.py dso_tile_step_pallas_twopass (:440):
//   _primal_kernel (:389), pallas_call :460 — X^T alpha and the per-column
//       nonzero counts, summed over the row tiles in VMEM, then the primal
//       Eq.-8 step;
//   _dual_kernel   (:413), pallas_call :484 — X w and the per-row nonzero
//       counts, summed over the column tiles in VMEM, then the dual step.
// It is the baseline the fused tile step (dso_update.cu) is held against:
// each pass reads all of X, so the step reads X twice by design.  Do not
// fuse the passes; that is what the fused kernel is.
//
// Both passes read the PRE-update w and alpha (a Jacobi step): the wrapper
// (kernels/ops.py dso_tile_step) passes the input alpha to the primal pass
// and the input w to the dual pass, and the outputs are separate tensors
// (the dual pass reads alpha and ga and writes every row's new alpha and
// ga to other tensors).
//
// What changes on the card.  On the TPU each pass carries its sum across a
// sequential grid.  Here CTAs run in no order.  Two designs, chosen by shape
// in the entry points (span_slots; dso_twopass_route reports the choice):
//
// Span kernels, every X whose row stride is a multiple of 4 floats and
// D <= 381 (svm-ocr's tile: one processor's 250,000 x 289 block of the
// 1,000,000 x 1,156 grid, row stride 1,156):
//   * All rows then share one misalignment, mis = (address of the first
//     column / 4) mod 4, so each row lies in a 16-byte-aligned span of
//     ns = ceil((mis + D) / 4) slots, its "virtual columns" 0..4 ns - 1,
//     with the row at [mis, mis + D).  Lane l of a warp reads slots l,
//     l + 32, l + 64 of a row with 16-byte loads (whole row spans, a warp
//     reading 512 consecutive bytes per load), carrying 4 rows at a time:
//     up to 12 loads in flight per lane.  Head and tail slots are masked
//     to the row.  (A cp.async.bulk ring carrying the same spans is no
//     faster at svm-ocr's tile: src/repro_torch/bench/twopass_loads.py.)
//   * primal pass: a lane keeps its slots' X^T alpha partials and column
//     nonzero counts in registers across all of its CTA's rows; the 8
//     warps' partials meet in shared memory and the CTA adds each column's
//     sum and count to acc[j] and cnt[j] with one atomicAdd each.  The grid
//     is what fits on the card at once (SM count x occupancy), with a grid
//     stride over groups of rows.  The primal step itself is the shared
//     launch B (dso_sparse.cu primal_update_kernel at p = 1, block 0), fed
//     acc as X^T alpha and cnt as its tile column counts; it zeroes acc.
//   * dual pass: w's slots are held in registers; the same loads give each
//     row's X w and its nonzero count, a halving butterfly (10 shuffles for
//     4 rows) finishes the 8 sums, and one lane per row takes the dual
//     step with the count as the tile row count.  It walks the rows last
//     first: the rows the primal pass read last may still be in L2.
// Row kernels, the rest (a contiguous M x 1,155 tile, whose row stride is
// not a multiple of 4, D > 381, or D = 0): 4-byte loads that need no
// alignment:
//   primal pass — one CTA covers 32 columns (one per lane) and ROWS_PER_CTA
//       rows (8 warps, interleaved rows), so a warp reads 32 consecutive
//       floats of one row per load; the 8 warps' partials meet in shared
//       memory and go to acc[j] and cnt[j] with one atomicAdd each.
//   dual pass — one warp per row, lane l reading columns l, l + 32, ...;
//       a butterfly of shuffles sums X w and the row's nonzero count, and
//       lane 0 takes the dual step.
// Counts are sums of 0/1 in float32, exact below 2^24 rows or columns.
// Atomics reorder the column sums from run to run, so the result agrees
// with the plain PyTorch version to 1e-5, not bitwise.
//
// Bound: bytes.  Each pass reads 4*M*D bytes of X (8*M*D for the step, twice
// the fused step's) and does ~3 flops per element.
//
// The entry points have a plain C interface for ctypes and return
// cudaGetLastError() after their launch.

#include "dso_common.cuh"

namespace {

using namespace dso;

constexpr unsigned FULL = 0xffffffffu;
constexpr int TP_WARPS = 8;             // warps per CTA (all kernels)
constexpr int NT = TP_WARPS * 32;
constexpr int ROWS_PER_CTA = 1024;      // row primal pass: rows of one CTA
constexpr int ROW_UNROLL = 8;           // row primal pass: loads in flight
constexpr int G = 4;                    // span kernels: rows a warp carries
constexpr int MAX_KS = 3;               // ... 16-byte slots per lane
constexpr int SPAN_COLS = 32 * 4 * MAX_KS;   // virtual columns they take

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, s))));
}

__device__ __forceinline__ float nnz4(float4 a) {
  return (a.x != 0.0f ? 1.0f : 0.0f) + (a.y != 0.0f ? 1.0f : 0.0f) +
         (a.z != 0.0f ? 1.0f : 0.0f) + (a.w != 0.0f ? 1.0f : 0.0f);
}

// Zero the elements of slot [u0, u0 + 4) outside virtual columns [lo, hi).
__device__ __forceinline__ float4 mask_slot(float4 v, int u0, int lo,
                                            int hi) {
  if (u0 < lo || u0 + 4 > hi) {
    if (u0 < lo || u0 >= hi) v.x = 0.0f;
    if (u0 + 1 < lo || u0 + 1 >= hi) v.y = 0.0f;
    if (u0 + 2 < lo || u0 + 2 >= hi) v.z = 0.0f;
    if (u0 + 3 < lo || u0 + 3 >= hi) v.w = 0.0f;
  }
  return v;
}

// The span of a row-strided X: its misalignment and slot count.
struct Span {
  const float4* x4;                     // slot 0 of row 0
  long long ld4;                        // row stride in slots
  int mis, hi, ns;                      // virtual columns [mis, hi)
};

__device__ __forceinline__ Span span_of(const float* X, long long ld, int D) {
  Span sp;
  sp.mis = (int)((reinterpret_cast<uintptr_t>(X) >> 2) & 3);
  sp.hi = sp.mis + D;
  sp.ns = (sp.hi + 3) >> 2;
  sp.x4 = reinterpret_cast<const float4*>(X - sp.mis);
  sp.ld4 = ld >> 2;
  return sp;
}

// Rows i0 .. i0 + G - 1 of the span, this lane's KS slots each, masked to
// the row; zero past M.
template <int KS>
__device__ __forceinline__ void load_rows(float4 (&x)[G][KS], const Span& sp,
                                          int i0, int M, int lane) {
#pragma unroll
  for (int r = 0; r < G; ++r)
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const int slot = lane + 32 * k;
      x[r][k] = i0 + r < M && slot < sp.ns
                    ? __ldg(sp.x4 + (long long)(i0 + r) * sp.ld4 + slot)
                    : zero4();
    }
#pragma unroll
  for (int r = 0; r < G; ++r)
#pragma unroll
    for (int k = 0; k < KS; ++k)
      x[r][k] = mask_slot(x[r][k], 4 * (lane + 32 * k), sp.mis, sp.hi);
}

// Sum of NV values over the warp by halving: at lane bit 16 >> st the lanes
// with the bit set keep the upper half of the values still held and pass
// the lower half, then the groups of 32 / NV lanes finish.  Lane l ends
// with the sum of value (l * NV) / 32.
template <int NV>
__device__ __forceinline__ float halving_sum(float (&v)[NV], int lane) {
#pragma unroll
  for (int st = 0; (NV >> st) > 1; ++st) {
    const int half = NV >> (st + 1);
    const bool up = lane & (16 >> st);
#pragma unroll
    for (int i = 0; i < half; ++i)
      v[i] = (up ? v[i + half] : v[i]) +
             __shfl_xor_sync(FULL, up ? v[i] : v[i + half], 16 >> st);
  }
#pragma unroll
  for (int off = 16 / NV; off > 0; off >>= 1)
    v[0] += __shfl_xor_sync(FULL, v[0], off);
  return v[0];
}

__global__ void __launch_bounds__(NT)
twopass_primal_kernel(const float* __restrict__ X, long long ld, int M, int D,
                      const float* __restrict__ alpha, float* __restrict__ acc,
                      float* __restrict__ cnt) {
  __shared__ float part_s[TP_WARPS][32];
  __shared__ float part_c[TP_WARPS][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * 32 + lane;
  const int lo = blockIdx.y * ROWS_PER_CTA;
  const int hi = min(lo + ROWS_PER_CTA, M);
  float s = 0.0f, c = 0.0f;
  if (j < D) {
    int i = lo + warp;
    for (; i + (ROW_UNROLL - 1) * TP_WARPS < hi; i += ROW_UNROLL * TP_WARPS) {
      float x[ROW_UNROLL];
#pragma unroll
      for (int u = 0; u < ROW_UNROLL; ++u)
        x[u] = __ldg(X + (long long)(i + u * TP_WARPS) * ld + j);
#pragma unroll
      for (int u = 0; u < ROW_UNROLL; ++u) {
        s = fmaf(x[u], __ldg(alpha + i + u * TP_WARPS), s);
        c += (x[u] != 0.0f) ? 1.0f : 0.0f;
      }
    }
    for (; i < hi; i += TP_WARPS) {
      const float x = __ldg(X + (long long)i * ld + j);
      s = fmaf(x, __ldg(alpha + i), s);
      c += (x != 0.0f) ? 1.0f : 0.0f;
    }
  }
  part_s[warp][lane] = s;
  part_c[warp][lane] = c;
  __syncthreads();
  if (warp == 0 && j < D) {
#pragma unroll
    for (int w = 1; w < TP_WARPS; ++w) {
      s += part_s[w][lane];
      c += part_c[w][lane];
    }
    atomicAdd(acc + j, s);
    atomicAdd(cnt + j, c);
  }
}

__global__ void __launch_bounds__(NT)
twopass_dual_kernel(const float* __restrict__ X, long long ld, int M, int D,
                    const float* __restrict__ w,
                    const float* __restrict__ alpha_in,
                    float* __restrict__ alpha_out,
                    const float* __restrict__ ga_in,
                    float* __restrict__ ga_out, const float* __restrict__ y,
                    const float* __restrict__ rn,
                    float eta, float m, int loss) {
  const int lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * TP_WARPS;
  for (int i = blockIdx.x * TP_WARPS + (threadIdx.x >> 5); i < M;
       i += n_warps) {
    const float* xr = X + (long long)i * ld;
    float s = 0.0f, c = 0.0f;
    for (int j = lane; j < D; j += 32) {
      const float x = __ldg(xr + j);
      s = fmaf(x, __ldg(w + j), s);
      c += (x != 0.0f) ? 1.0f : 0.0f;
    }
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      c += __shfl_xor_sync(0xffffffffu, c, off);
    }
    if (lane == 0) {
      float a_new, ga_new;
      dual_update(loss, s, alpha_in[i], ga_in[i], y[i], c, rn[i], eta, m,
                  a_new, ga_new);
      alpha_out[i] = a_new;
      ga_out[i] = ga_new;
    }
  }
}

// The span primal pass: X^T alpha and the column counts of X (M, D), row
// stride ld % 4 == 0, mis + D <= 128 KS, added into acc and cnt.
template <int KS>
__global__ void __launch_bounds__(NT)
twopass_primal_span_kernel(const float* __restrict__ X, long long ld, int M,
                           int D, const float* __restrict__ alpha,
                           float* __restrict__ acc, float* __restrict__ cnt) {
  extern __shared__ float4 part4[];     // (2, TP_WARPS, 32 KS): sums, counts
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Span sp = span_of(X, ld, D);
  float4 s[KS], c[KS];
#pragma unroll
  for (int k = 0; k < KS; ++k) s[k] = c[k] = zero4();
  const int stride = gridDim.x * TP_WARPS * G;
  for (int i0 = (blockIdx.x * TP_WARPS + warp) * G; i0 < M; i0 += stride) {
    float a[G];
#pragma unroll
    for (int r = 0; r < G; ++r)
      a[r] = i0 + r < M ? __ldg(alpha + i0 + r) : 0.0f;
    float4 x[G][KS];
    load_rows<KS>(x, sp, i0, M, lane);
#pragma unroll
    for (int r = 0; r < G; ++r)
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        s[k].x = fmaf(x[r][k].x, a[r], s[k].x);
        s[k].y = fmaf(x[r][k].y, a[r], s[k].y);
        s[k].z = fmaf(x[r][k].z, a[r], s[k].z);
        s[k].w = fmaf(x[r][k].w, a[r], s[k].w);
        c[k].x += x[r][k].x != 0.0f ? 1.0f : 0.0f;
        c[k].y += x[r][k].y != 0.0f ? 1.0f : 0.0f;
        c[k].z += x[r][k].z != 0.0f ? 1.0f : 0.0f;
        c[k].w += x[r][k].w != 0.0f ? 1.0f : 0.0f;
      }
  }
  constexpr int W = 32 * KS;            // slots of a warp's partial
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    part4[warp * W + lane + 32 * k] = s[k];
    part4[(TP_WARPS + warp) * W + lane + 32 * k] = c[k];
  }
  __syncthreads();
  const float* part = reinterpret_cast<const float*>(part4);
  for (int u = threadIdx.x; u < 4 * W; u += NT) {
    const int col = u - sp.mis;
    if (col < 0 || col >= D) continue;
    float vs = 0.0f, vc = 0.0f;
#pragma unroll
    for (int wi = 0; wi < TP_WARPS; ++wi) {
      vs += part[wi * 4 * W + u];
      vc += part[(TP_WARPS + wi) * 4 * W + u];
    }
    if (vs != 0.0f) atomicAdd(acc + col, vs);
    if (vc != 0.0f) atomicAdd(cnt + col, vc);
  }
}

// The span dual pass: X w and the row counts from the same loads, then the
// dual step of every row, from alpha_in/ga_in into alpha_out/ga_out.
template <int KS>
__global__ void __launch_bounds__(NT)
twopass_dual_span_kernel(const float* __restrict__ X, long long ld, int M,
                         int D, const float* __restrict__ w,
                         const float* __restrict__ alpha_in,
                         float* __restrict__ alpha_out,
                         const float* __restrict__ ga_in,
                         float* __restrict__ ga_out,
                         const float* __restrict__ y,
                         const float* __restrict__ rn, float eta, float m,
                         int loss) {
  constexpr int NV = 2 * G;             // X w and the count of G rows
  constexpr int LANES = 32 / NV;        // lanes a finished sum spans
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Span sp = span_of(X, ld, D);
  float4 w4[KS];
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const int u0 = 4 * (lane + 32 * k) - sp.mis;   // column of .x
    w4[k].x = u0 >= 0 && u0 < D ? __ldg(w + u0) : 0.0f;
    w4[k].y = u0 + 1 >= 0 && u0 + 1 < D ? __ldg(w + u0 + 1) : 0.0f;
    w4[k].z = u0 + 2 >= 0 && u0 + 2 < D ? __ldg(w + u0 + 2) : 0.0f;
    w4[k].w = u0 + 3 >= 0 && u0 + 3 < D ? __ldg(w + u0 + 3) : 0.0f;
  }
  const int my_r = lane / LANES;        // the row whose sum lands here
  const bool lead = lane % LANES == 0 && my_r < G;
  const int n_groups = (M + G - 1) / G;
  const int n_warps = gridDim.x * TP_WARPS;
  for (int jg = n_groups - 1 - (blockIdx.x * TP_WARPS + warp); jg >= 0;
       jg -= n_warps) {
    const int i0 = jg * G;
    const int i = i0 + my_r;
    const bool owner = lead && i < M;
    float a_old = 0.0f, ga_old = 0.0f, yi = 0.0f, rni = 1.0f;
    if (owner) {
      a_old = alpha_in[i];
      ga_old = ga_in[i];
      yi = y[i];
      rni = rn[i];
    }
    float4 x[G][KS];
    load_rows<KS>(x, sp, i0, M, lane);
    float v[NV];
#pragma unroll
    for (int r = 0; r < G; ++r) {
      v[r] = 0.0f;
      v[G + r] = 0.0f;
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        v[r] = dot4(x[r][k], w4[k], v[r]);
        v[G + r] += nnz4(x[r][k]);
      }
    }
    const float xw = halving_sum<NV>(v, lane);
    const float cnt = __shfl_down_sync(FULL, xw, 16);  // value G + my_r
    if (owner) {
      float a_new, ga_new;
      dual_update(loss, xw, a_old, ga_old, yi, cnt, rni, eta, m, a_new,
                  ga_new);
      alpha_out[i] = a_new;
      ga_out[i] = ga_new;
    }
  }
}

// The span kernels' slots per lane for X (row stride ld), or 0 when they
// do not take it and the row kernels run.
int span_slots(const float* X, long long ld, int D) {
  if (D <= 0 || ld % 4 != 0 || D + 3 > SPAN_COLS) return 0;
  const int mis = (int)((reinterpret_cast<uintptr_t>(X) >> 2) & 3);
  const int ns = (mis + D + 3) / 4;
  return (ns + 31) / 32;
}

// As many CTAs as fit on the card at once, no more than ``need``.
template <auto Kernel>
cudaError_t fill_grid(size_t smem, long long need, unsigned* n_cta) {
  int per_sm = 0;
  const cudaError_t e = ctas_per_sm<Kernel>(NT, smem, &per_sm);
  if (e != cudaSuccess) return e;
  long long fit = (long long)per_sm * sm_count();
  if (fit < 1) fit = 1;
  *n_cta = (unsigned)(need < fit ? need : fit);
  return cudaSuccess;
}

template <int KS>
int primal_span(const float* X, long long ld, int M, int D,
                const float* alpha, float* acc, float* cnt, cudaStream_t st) {
  const size_t smem = (size_t)2 * TP_WARPS * 32 * KS * sizeof(float4);
  unsigned n_cta = 0;
  const cudaError_t e = fill_grid<twopass_primal_span_kernel<KS>>(
      smem, blocks_for(M, TP_WARPS * G), &n_cta);
  if (e != cudaSuccess) return (int)e;
  twopass_primal_span_kernel<KS><<<n_cta, NT, smem, st>>>(X, ld, M, D, alpha,
                                                          acc, cnt);
  return (int)cudaGetLastError();
}

template <int KS>
int dual_span(const float* X, long long ld, int M, int D, const float* w,
              const float* alpha_in, float* alpha_out, const float* ga_in,
              float* ga_out, const float* y, const float* rn, float eta,
              float m, int loss, cudaStream_t st) {
  unsigned n_cta = 0;
  const cudaError_t e = fill_grid<twopass_dual_span_kernel<KS>>(
      0, blocks_for(M, TP_WARPS * G), &n_cta);
  if (e != cudaSuccess) return (int)e;
  twopass_dual_span_kernel<KS><<<n_cta, NT, 0, st>>>(
      X, ld, M, D, w, alpha_in, alpha_out, ga_in, ga_out, y, rn, eta, m,
      loss);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 when the entry points below take X (M, D) (row stride ld) on the span
// kernels, 0 when they take it on the row kernels.
int dso_twopass_route(const float* X, long long ld, int D) {
  return span_slots(X, ld, D) != 0;
}

// acc and cnt (D,) must be zero; the primal pass adds X^T alpha and the
// column counts into them.
int dso_twopass_primal(const float* X, long long ld, int M, int D,
                       const float* alpha, float* acc, float* cnt,
                       void* stream) {
  if (M <= 0 || D <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  switch (span_slots(X, ld, D)) {
    case 1: return primal_span<1>(X, ld, M, D, alpha, acc, cnt, st);
    case 2: return primal_span<2>(X, ld, M, D, alpha, acc, cnt, st);
    case 3: return primal_span<3>(X, ld, M, D, alpha, acc, cnt, st);
  }
  dim3 grid(blocks_for(D, 32), blocks_for(M, ROWS_PER_CTA));
  twopass_primal_kernel<<<grid, NT, 0, st>>>(X, ld, M, D, alpha, acc, cnt);
  return (int)cudaGetLastError();
}

// Reads alpha_in and ga_in, writes every row's alpha_out and ga_out.
int dso_twopass_dual(const float* X, long long ld, int M, int D,
                     const float* w, const float* alpha_in, float* alpha_out,
                     const float* ga_in, float* ga_out, const float* y,
                     const float* rn, float eta, float m, int loss,
                     void* stream) {
  if (M <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  switch (span_slots(X, ld, D)) {
    case 1: return dual_span<1>(X, ld, M, D, w, alpha_in, alpha_out, ga_in,
                                ga_out, y, rn, eta, m, loss, st);
    case 2: return dual_span<2>(X, ld, M, D, w, alpha_in, alpha_out, ga_in,
                                ga_out, y, rn, eta, m, loss, st);
    case 3: return dual_span<3>(X, ld, M, D, w, alpha_in, alpha_out, ga_in,
                                ga_out, y, rn, eta, m, loss, st);
  }
  // 16 rows per warp at most, at least one wave of the 132 SMs x 8 CTAs
  const unsigned all = blocks_for(M, TP_WARPS);
  const unsigned few = blocks_for(M, TP_WARPS * 16);
  const unsigned want = few > 132u * 8u ? few : 132u * 8u;
  const unsigned n_cta = want < all ? want : all;
  twopass_dual_kernel<<<n_cta, NT, 0, st>>>(X, ld, M, D, w, alpha_in,
                                            alpha_out, ga_in, ga_out, y, rn,
                                            eta, m, loss);
  return (int)cudaGetLastError();
}

}  // extern "C"
