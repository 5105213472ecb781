// Hand-written Hopper (sm_90a) kernels for the Mamba2 SSD chunked scan.
//
// Replaces the reference's Pallas TPU kernel
//   src/repro/kernels/ssd_scan.py _ssd_kernel (:32), launched by ssd_scan
//   (:70) through its pallas_call (:84).
//
// What it computes, per (batch, head) and chunk of L steps, with
// s = cumsum(A * dt) inside the chunk and the (n, dh) state carried over:
//     M[t, tau] = (C_t . B_tau) * exp(s_t - s_tau) * dt_tau   (tau <= t)
//     y_t       = sum_tau M[t, tau] x_tau + exp(s_t) * (C_t . state)
//     state'    = exp(s_L) * state + sum_tau B_tau (x_tau * dt_tau
//                                                   * exp(s_L - s_tau))
// all in float32, y stored in x's type (float32 or bf16).  B and C are
// shared by the heads of a batch row (one SSD group).
//
// What changes on the card.  On the TPU the grid (batch x head, chunk)
// runs the chunks in order and carries the state in VMEM between grid
// steps.  Here the chunks are independent but for a short recurrence over
// chunk states, so one call is three launches (Mamba2's chunk-state /
// state-passing / chunk-scan split):
//
//   1. chunk states, one CTA per (batch x head, chunk, 64 state rows):
//      the chunk's cumsum, then upd_c = B_c^T (x_c * dt * exp(s_L - s)),
//      an (n, dh) block, into a float32 workspace, and exp(s_L) beside it;
//   2. state passing, one thread per (batch x head, state element): in
//      place, S_in[c] = exp(s_L[c-1]) * S_in[c-1] + upd[c-1], S_in[0] = 0,
//      n_chunks dependent FMAs each;
//   3. chunk output, one CTA per (batch x head, chunk, 64 rows of y): the
//      cumsum again, then y = exp(s) * (C S_in[c]) + (C B^T o decay o dt) x
//      over the causal tau tiles only (tau <= t), y stored once.
//
// The workspace holds b * h * n_chunks * n * dh floats (235 MB at
// zamba2-7b's t 16,384, 112 heads, n = dh = 64, chunk 128), written by 1,
// rewritten by 2 and read by 3: ~0.94 GB of traffic, ~0.3 ms at the HBM
// rate, against ~60 GFLOP of chunked products.  So the launches are bound
// by float32 operations: every product is a 64 x 64 tile on 256 threads,
// each thread holding 4 x 4 outputs (4 x 4 DT for y and the states, DT =
// dh / 64 rounded up) in registers, fed by two 16-byte shared loads per
// depth step (8 FMAs per shared load; the old one-CTA-per-head kernel did
// one).  Operands sit in shared memory with a row stride of 68 floats
// (16-byte aligned).  TF32 on the tensor cores would miss the reference's
// rtol 2e-4, so the products stay on the CUDA cores.
//
// The ragged end of t is masked in the kernels: steps past t read dt = 0,
// x = B = C = 0, which is the reference's padding (a zero step is a no-op)
// without a padded copy, and their y is not stored.  With A = -1e4 the
// decays underflow to 0; the causal mask is a select, so exp of a positive
// difference (tau > t) is never multiplied in.
//
// Limits: dh <= 256 (DT <= 4); launch 3 takes 4 * (2 * n * 68 + 64 * 68 +
// 64 * (64 DT + 4) + 2 * L64) bytes of shared memory (L64 = L rounded up
// to 64): 105,472 at n = 128, dh = 64, chunk 128, 121,856 at n = dh = 128;
// a shape past the card's 232,448 (n > 361 at dh 64, chunk 128) makes the
// attribute fail and the entry point return its error.
//
// Bound: operations of the exact recurrence, ~5 * n * dh float32 flops per
// (step, head), against the card's float32 rate; the chunked form does
// ~L/2 times that in exchange for its parallelism.
//
// The backward (ssd_scan_bwd; the reference has no backward kernel: it
// trains through its jnp ssd_chunked, src/repro/models/mamba2.py:106, and
// XLA differentiates that; these launches port that gradient) reads the
// forward's workspace after its state pass, i.e. the state S_c entering
// each chunk, and its decays, and makes three launches:
//
//   1'. launch 1 as the state adjoint's local sums, sum_t exp(s_t) C_t
//       dy_t^T per chunk, into a second workspace (ADJ);
//   2'. launch 2 run from the last chunk (REV): Z_c, the adjoint of the
//       state that chunk c leaves, Z_c = exp(s_L[c+1]) Z_{c+1} +
//       loc[c+1], Z of the last chunk 0;
//   3'. the chunk gradients, one CTA of 256 threads per (batch x head,
//       chunk): 64 x 64 tiles of G = C B^T and R = dy x^T for each pair
//       of a t tile and an earlier-or-equal tau tile, the decays taken
//       only for tau <= t, then dx, ddt, dB, dC and the chunk's share of
//       dA (ssd_chunk_grad_kernel's note).  dB and dC are written per
//       head and dA per chunk, and the caller sums them (torch.sum, a
//       fixed order): no atomics, so two runs give the same bits.
//
// Bound: operations, ~10 n dh float32 operations per (step, head) of the
// exact recurrence's backward; the chunked form does ~L times that, in
// float32 FMAs on the CUDA cores as the forward.  Launch 3' takes
// 8 (3 L64 + 16) + 4 (5 * 64 * 68 + 64 (64 DT + 4) + 2 L64) bytes of
// shared memory: 108,672 at dh 64, chunk 128, so two CTAs share an SM.
//
// The entry points have a plain C interface for ctypes and return the
// first error of their launches (cudaGetLastError()).

#include "float_io.cuh"

namespace {

using fio::store;
using fio::to_f32;

constexpr int NT = 256;                 // threads per CTA of launches 1, 3
constexpr int TILE = 64;                // rows and columns of a tile
constexpr int LDT = TILE + 4;           // row stride of a 64-wide tile
constexpr int MAX_DT = 4;               // dh <= 256

__host__ __device__ inline int round64(int v) { return (v + 63) / 64 * 64; }

template <int DT>
__host__ __device__ constexpr int ldx() { return DT * TILE + 4; }

// s[i] = a * (dt[0] + ... + dt[i]) for i < len, by warp 0: each lane sums
// a run of ceil(len / 32), then a shuffle scan of the runs.
__device__ void chunk_cumsum(const float* dts, float* cs, float a, int len) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int per = (len + 31) / 32;
  const int lo = min(len, lane * per);
  const int hi = min(len, lo + per);
  float run = 0.0f;
  for (int i = lo; i < hi; ++i) run += a * dts[i];
  float incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  const float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  float pre = lane > 0 ? excl : 0.0f;
  for (int i = lo; i < hi; ++i) {
    pre += a * dts[i];
    cs[i] = pre;
  }
}

// dt of the chunk (0 past its nv live steps) into dts[0, L64), then its
// cumsum into cs; ends with a barrier.
__device__ void load_dt_cumsum(const float* dt, long long row0, int h, int hi,
                               int nv, float a_h, int L64, float* dts,
                               float* cs) {
  for (int i = threadIdx.x; i < L64; i += NT)
    dts[i] = i < nv ? dt[(row0 + i) * h + hi] : 0.0f;
  __syncthreads();
  chunk_cumsum(dts, cs, a_h, L64);
  __syncthreads();
}

// acc[i][j] += sum_k a[k][ty*4 + i] * b[k][dd*64 + tx*4 + j'] for k < depth:
// a is (depth, LDT), b is (depth, ldb) in shared memory.
template <int DT>
__device__ __forceinline__ void tile_fma(float (&acc)[4][4 * DT],
                                         const float* a, const float* b,
                                         int ldb, int depth, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < depth; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * LDT + ty * 4);
    const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
    for (int dd = 0; dd < DT; ++dd) {
      const float4 bv = *reinterpret_cast<const float4*>(
          b + k * ldb + dd * TILE + tx * 4);
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][dd * 4 + j] = fmaf(ar[i], br[j], acc[i][dd * 4 + j]);
    }
  }
}

// rows [r0, r0 + 64) of the (b, t, n) matrix M from row row0 (0 at rows
// past nv) into dst transposed: dst[k * LDT + r].  A warp takes 8 columns
// of 4 rows, so its 32 stores fall in 32 banks (bank 4k + r mod 32) and
// its loads in 4 runs of 32 bytes.
__device__ void load_rows_transposed(const float* __restrict__ M,
                                     long long row0, int r0, int nv, int n,
                                     float* dst) {
  const int kk = threadIdx.x % 8;
  const int rr = threadIdx.x / 8;       // 0..31
  for (int k0 = 0; k0 < n; k0 += 8) {
    const int k = k0 + kk;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half * 32 + rr;
      if (k < n)
        dst[k * LDT + r] = r0 + r < nv ? M[(row0 + r0 + r) * n + k] : 0.0f;
    }
  }
}

// rows [tau0, tau0 + 64) of the chunk's x (0 past nv or dh), times wgt[tau]
// when given, into xs (64, ldx<DT>()).
template <typename T, int DT>
__device__ void load_x_tile(const T* x, long long row0, int h, int hi,
                            int dh, int nv, int tau0, const float* wgt,
                            float* xs) {
  constexpr int W = DT * TILE;
  for (int e = threadIdx.x; e < TILE * W; e += NT) {
    const int tau = e / W;
    const int d = e - tau * W;
    const int tt = tau0 + tau;
    float v = 0.0f;
    if (tt < nv && d < dh) {
      v = to_f32(x[((row0 + tt) * h + hi) * dh + d]);
      if (wgt) v *= wgt[tt];
    }
    xs[tau * ldx<DT>() + d] = v;
  }
}

// Launch 1: upd_c rows [k0, k0 + 64) for one (batch x head, chunk).  ADJ
// (the backward's state adjoint): the same sum with C in place of B, dy in
// place of x and the weights exp(s) in place of dt exp(s_L - s), i.e.
// sum_t exp(s_t) C_t dy_t^T; decay is not written.
template <typename T, int DT, bool ADJ>
__global__ void __launch_bounds__(NT)
ssd_chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const float* __restrict__ Bm, float* __restrict__ ws,
                       float* __restrict__ decay, int t, int h, int dh, int n,
                       int L, int n_chunks, int n_kt) {
  extern __shared__ __align__(16) float smem[];
  const int L64 = round64(L);
  float* Bs = smem;                     // (64, LDT): B[tau][k0 + kk]
  float* xs = Bs + TILE * LDT;          // (64, ldx): x[tau] * w[tau]
  float* dts = xs + TILE * ldx<DT>();   // (L64,): dt, then the weights w
  float* cs = dts + L64;                // (L64,): cumsum of A * dt

  long long idx = blockIdx.x;
  const int kt = (int)(idx % n_kt);
  idx /= n_kt;
  const int c = (int)(idx % n_chunks);
  const long long bh = idx / n_chunks;
  const int bi = (int)(bh / h);
  const int hi = (int)(bh % h);
  const int t0 = c * L;
  const int nv = min(L, t - t0);
  const long long row0 = (long long)bi * t + t0;
  const int k0 = kt * TILE;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  load_dt_cumsum(dt, row0, h, hi, nv, A[hi], L64, dts, cs);
  const float last = cs[L - 1];
  for (int i = threadIdx.x; i < L64; i += NT)   // w = dt * exp(s_L - s)
    dts[i] = ADJ ? (i < nv ? expf(cs[i]) : 0.0f) : dts[i] * expf(last - cs[i]);
  __syncthreads();

  float acc[4][4 * DT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * DT; ++j) acc[i][j] = 0.0f;
  for (int tau0 = 0; tau0 < nv; tau0 += TILE) {
    for (int e = threadIdx.x; e < TILE * TILE; e += NT) {
      const int tau = e / TILE;
      const int kk = e - tau * TILE;
      const int tt = tau0 + tau;
      Bs[tau * LDT + kk] = (tt < nv && k0 + kk < n)
                               ? Bm[(row0 + tt) * n + k0 + kk] : 0.0f;
    }
    load_x_tile<T, DT>(x, row0, h, hi, dh, nv, tau0, dts, xs);
    __syncthreads();
    tile_fma<DT>(acc, Bs, xs, ldx<DT>(), min(TILE, nv - tau0), ty, tx);
    __syncthreads();
  }

  float* out = ws + ((long long)bh * n_chunks + c) * n * dh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= n) continue;
#pragma unroll
    for (int dd = 0; dd < DT; ++dd)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = dd * TILE + tx * 4 + j;
        if (d < dh) out[(long long)k * dh + d] = acc[i][dd * 4 + j];
      }
  }
  if (!ADJ && kt == 0 && threadIdx.x == 0)
    decay[(long long)bh * n_chunks + c] = expf(last);
}

// Launch 2: the chunk states' recurrence, in place on the workspace.  A
// thread loads PASS chunks' upd before it writes any S_in, so PASS loads
// are in flight at once: the launch is bound by the workspace's bytes,
// not by the latency of one load per chunk.
// REV (the backward's state adjoint) runs the chunks from the last:
// Z_c = decay[c + 1] Z_{c + 1} + loc[c + 1], Z_{n_chunks - 1} = 0.
constexpr int PASS = 16;

template <bool REV>
__global__ void ssd_state_pass_kernel(float* __restrict__ ws,
                                      const float* __restrict__ decay,
                                      int n_chunks, long long ne,
                                      long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long bh = idx / ne;
  float* p = ws + bh * n_chunks * ne + (idx - bh * ne);
  const float* dec = decay + bh * n_chunks;
  float st = 0.0f;
  for (int c0 = 0; c0 < n_chunks; c0 += PASS) {
    float u[PASS];
#pragma unroll
    for (int j = 0; j < PASS; ++j)
      if (c0 + j < n_chunks)
        u[j] = p[(REV ? n_chunks - 1 - c0 - j : c0 + j) * ne];
#pragma unroll
    for (int j = 0; j < PASS; ++j)
      if (c0 + j < n_chunks) {
        const int cc = REV ? n_chunks - 1 - c0 - j : c0 + j;
        p[cc * ne] = st;
        st = dec[cc] * st + u[j];
      }
  }
}

// Launch 3: rows [r0, r0 + 64) of y for one (batch x head, chunk).
template <typename T, int DT>
__global__ void __launch_bounds__(NT)
ssd_chunk_out_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A,
                     const float* __restrict__ Bm,
                     const float* __restrict__ Cm,
                     const float* __restrict__ ws, T* __restrict__ y, int t,
                     int h, int dh, int n, int L, int n_chunks, int n_rt) {
  extern __shared__ __align__(16) float smem[];
  const int L64 = round64(L);
  float* Ct = smem;                     // (n, LDT): C[r0 + r][k] at [k][r]
  float* Bt = Ct + n * LDT;             // (n, LDT): a tau tile of B, [k][tau]
  float* Mt = Bt + n * LDT;             // (64, LDT): M[r][tau] at [tau][r]
  float* xs = Mt + TILE * LDT;          // (64, ldx): x rows, or S_in rows
  float* dts = xs + TILE * ldx<DT>();   // (L64,)
  float* cs = dts + L64;                // (L64,)

  long long idx = blockIdx.x;
  const int rt = (int)(idx % n_rt);
  idx /= n_rt;
  const int c = (int)(idx % n_chunks);
  const long long bh = idx / n_chunks;
  const int bi = (int)(bh / h);
  const int hi = (int)(bh % h);
  const int t0 = c * L;
  const int nv = min(L, t - t0);
  const int r0 = rt * TILE;
  if (r0 >= nv) return;                 // no live row: the whole CTA
  const long long row0 = (long long)bi * t + t0;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  load_rows_transposed(Cm, row0, r0, nv, n, Ct);
  load_dt_cumsum(dt, row0, h, hi, nv, A[hi], L64, dts, cs);

  float acc[4][4 * DT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * DT; ++j) acc[i][j] = 0.0f;

  // the carried state's term exp(s_r) * (C_r . S_in[c]); chunk 0 has none
  if (c > 0) {
    const float* S = ws + ((long long)bh * n_chunks + c) * n * dh;
    constexpr int W = DT * TILE;
    for (int k0 = 0; k0 < n; k0 += TILE) {
      for (int e = threadIdx.x; e < TILE * W; e += NT) {
        const int kk = e / W;
        const int d = e - kk * W;
        xs[kk * ldx<DT>() + d] = (k0 + kk < n && d < dh)
                                     ? S[(long long)(k0 + kk) * dh + d] : 0.0f;
      }
      __syncthreads();
      tile_fma<DT>(acc, Ct + k0 * LDT, xs, ldx<DT>(), min(TILE, n - k0), ty,
                   tx);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float e = expf(cs[r0 + ty * 4 + i]);
#pragma unroll
      for (int j = 0; j < 4 * DT; ++j) acc[i][j] *= e;
    }
  }

  // the chunk's own term, tau tile by tau tile up to the diagonal
  const int tau_end = min(r0 + TILE, nv);
  for (int tau0 = 0; tau0 < tau_end; tau0 += TILE) {
    load_rows_transposed(Bm, row0, tau0, nv, n, Bt);
    load_x_tile<T, DT>(x, row0, h, hi, dh, nv, tau0, nullptr, xs);
    __syncthreads();
    float g[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) g[i][j] = 0.0f;
    tile_fma<1>(g, Ct, Bt, LDT, n, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int tau = tau0 + tx * 4 + j;
      float mv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + ty * 4 + i;
        mv[i] = tau <= r ? g[i][j] * expf(cs[r] - cs[tau]) * dts[tau] : 0.0f;
      }
      *reinterpret_cast<float4*>(Mt + (tx * 4 + j) * LDT + ty * 4) =
          make_float4(mv[0], mv[1], mv[2], mv[3]);
    }
    __syncthreads();
    tile_fma<DT>(acc, Mt, xs, ldx<DT>(), min(TILE, tau_end - tau0), ty, tx);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= nv) continue;
    T* yr = y + ((row0 + r) * h + hi) * dh;
#pragma unroll
    for (int dd = 0; dd < DT; ++dd)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = dd * TILE + tx * 4 + j;
        if (d < dh) store(yr + d, acc[i][dd * 4 + j]);
      }
  }
}


// ------------------------------------------------------------- backward --

// dst[kk * LDT + r] = M[(r0 + r) * ldm + c0 + kk] for r < 64 with r0 + r <
// nr and kk < 64 with c0 + kk < nc, else 0: a 64 x 64 block transposed.  A
// warp takes 8 columns of 4 rows, so its 32 stores fall in 32 banks.
template <typename U>
__device__ void tile_t(const U* __restrict__ M, long long ldm, int r0, int nr,
                       int c0, int nc, float* dst) {
  const int kk = threadIdx.x % 8;
  const int rr = threadIdx.x / 8;       // 0..31
#pragma unroll 2
  for (int k8 = 0; k8 < TILE; k8 += 8)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half * 32 + rr;
      const int k = k8 + kk;
      dst[k * LDT + r] = (r0 + r < nr && c0 + k < nc)
                             ? to_f32(M[(long long)(r0 + r) * ldm + c0 + k])
                             : 0.0f;
    }
}

// dst[r * ldd + c] = M[(r0 + r) * ldm + c0 + c] for r < 64 with r0 + r < nr
// and c < width with c0 + c < nc, else 0.
template <typename U>
__device__ void tile_r(const U* __restrict__ M, long long ldm, int r0, int nr,
                       int c0, int nc, float* dst, int ldd, int width) {
  for (int e = threadIdx.x; e < TILE * width; e += NT) {
    const int r = e / width;
    const int c = e - r * width;
    dst[r * ldd + c] = (r0 + r < nr && c0 + c < nc)
                           ? to_f32(M[(long long)(r0 + r) * ldm + c0 + c])
                           : 0.0f;
  }
}

// Sum of v over the 16 threads of a row group (tx 0..15, consecutive lanes),
// in a fixed order.
template <typename V>
__device__ __forceinline__ V row_sum16(V v) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[4][N]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) a[i][j] = 0.0f;
}

// v[i] = v[i] + ... + v[len - 1] in place, by warp 0 (chunk_cumsum run from
// the end); ends with a barrier.
__device__ void chunk_revsum(double* v, int len) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (len + 31) / 32;
    const int lo = min(len, lane * per);   // over j = len - 1 - i
    const int hi = min(len, lo + per);
    double run = 0.0;
    for (int j = lo; j < hi; ++j) run += v[len - 1 - j];
    double incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const double o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    const double excl = __shfl_up_sync(0xffffffffu, incl, 1);
    double pre = lane > 0 ? excl : 0.0;
    for (int j = lo; j < hi; ++j) {
      pre += v[len - 1 - j];
      v[len - 1 - j] = pre;
    }
  }
  __syncthreads();
}

// Shared memory of launch 3 of the backward: the float64 sums (ds, ddt's
// direct part, u w, 16 scalars), then the float32 tiles and vectors.
// 108,672 bytes at dh 64, chunk 128: two CTAs per SM.
template <int DT>
__host__ __device__ constexpr size_t grad_smem(int L64) {
  return sizeof(double) * ((size_t)3 * L64 + 16) +
         sizeof(float) * ((size_t)5 * TILE * LDT + TILE * ldx<DT>() +
                          2 * (size_t)L64);
}

// Launch 3 of the backward: every gradient of one (batch x head, chunk),
// from the state S entering it (the forward's workspace after its state
// pass) and the adjoint Z of the state it leaves (launches 1 and 2 run as
// the adjoint).  With G = C B^T, R = dy x^T, E = exp(s_t - s_tau) for tau
// <= t (else 0, never exp of a later tau), w = dt exp(s_L - s):
//   dx = dt dxt, dxt = (G E)^T dy + exp(s_L - s) (B Z)
//   dC = (E R dt) B + exp(s) dy S^T,   dB = (E R dt)^T C + w x Z^T
//   ds = rowsum(W) - colsum(W) + exp(s) dy . (C S) - u w, W = G E R dt,
//        u = (B Z) . x; the chunk's last step also gets sum(u w) and
//        exp(s_L) <S, Z>
//   da = the reversed cumulative sum of ds;
//   ddt = colsum(G E R) + exp(s_L - s) u + A da (= x . dxt + A da);
//   dA's part: sum dt da
// by 64 x 64 tiles of the chunk: tau tile J outer, t tiles I >= J inner
// (G and R of the pair, then dxt_J += (G E)^T dy_I in registers, dB_J +=
// V^T C_I and dC_I += V B_J into the per-head partials dBh, dCh, which this
// CTA alone writes, in that fixed order).  dB, dC (per head) and dA (per
// chunk) are summed by the caller in a fixed order; nothing is atomic.
// ds is summed in float64: its row and column sums of W (and the u w
// terms) cancel in da's reversed sum (da_0 takes every W twice with
// opposite signs), so float32 partial sums would leave their rounding in
// ddt and dA.  ddt's direct part is summed in float64 from the same
// column sums (of G E R), not from dxt.
template <typename T, int DT>
__global__ void __launch_bounds__(NT, 2)
ssd_chunk_grad_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const T* __restrict__ dy, const float* __restrict__ ws,
                      const float* __restrict__ wsz,
                      const float* __restrict__ decay, T* __restrict__ dx,
                      float* __restrict__ ddt, float* __restrict__ dBh,
                      float* __restrict__ dCh, float* __restrict__ dAp, int t,
                      int h, int dh, int n, int L, int n_chunks) {
  extern __shared__ __align__(16) float smem[];
  constexpr int W = DT * TILE;          // dh, padded
  constexpr int LX = ldx<DT>();
  const int L64 = round64(L);
  double* ds = reinterpret_cast<double*>(smem);   // (L64,) ds, then da
  double* dd = ds + L64;                // (L64,) ddt's direct part
  double* uw = dd + L64;                // (L64,) u w
  double* scal = uw + L64;              // (16,)
  float* ta = reinterpret_cast<float*>(scal + 16);   // (64, LDT): a operands
  float* tb = ta + TILE * LDT;          // (64, LDT): staged b operands
  // (16, 64) float64 column partial sums of W and of G E R, on tb while
  // no product reads it
  double* red = reinterpret_cast<double*>(tb);
  double* red2 = red + 16 * TILE;
  float* Mb = tb + TILE * LDT;          // (64, LDT): (G E)[t][tau]
  float* Vb = Mb + TILE * LDT;          // (64, LDT): V[t][tau] = E R dt
  float* VTb = Vb + TILE * LDT;         // (64, LDT): V[tau][t]
  float* xs = VTb + TILE * LDT;         // (64, LX): rows dh wide
  float* dts = xs + TILE * LX;          // (L64,) dt
  float* cs = dts + L64;                // (L64,) s

  const int c = (int)(blockIdx.x % n_chunks);
  const long long bh = blockIdx.x / n_chunks;
  const int bi = (int)(bh / h);
  const int hi = (int)(bh % h);
  const int nv = min(L, t - c * L);
  const long long row0 = (long long)bi * t + c * L;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const long long hd = (long long)h * dh;
  const long long hn = (long long)h * n;
  const T* xc = x + (row0 * h + hi) * dh;         // (tau, d) at tau hd + d
  const T* dyc = dy + (row0 * h + hi) * dh;
  T* dxc = dx + (row0 * h + hi) * dh;
  const float* Bc = Bm + row0 * n;                // (tau, k) at tau n + k
  const float* Cc = Cm + row0 * n;
  float* dBc = dBh + (row0 * h + hi) * n;         // (tau, k) at tau hn + k
  float* dCc = dCh + (row0 * h + hi) * n;
  const long long sc = (bh * n_chunks + c) * (long long)n * dh;
  const float* S = ws + sc;                       // (k, d) at k dh + d
  const float* Z = wsz + sc;
  const float a_h = A[hi];
  const int ntv = (nv + TILE - 1) / TILE;         // tiles with a live step

  for (int i = threadIdx.x; i < L64; i += NT) ds[i] = dd[i] = uw[i] = 0.0;
  load_dt_cumsum(dt, row0, h, hi, nv, a_h, L64, dts, cs);
  const float last = cs[L - 1];

  // the carried state's terms, t tile by t tile: ds += exp(s) dy . (C S),
  // dC = exp(s) dy S^T (the first write of the partial)
  for (int I = 0; I < ntv; ++I) {
    const int i0 = I * TILE;
    float acc[4][4 * DT];
    zero(acc);
    for (int k0 = 0; k0 < n; k0 += TILE) {
      tile_t(Cc, n, i0, nv, k0, n, ta);
      tile_r(S, dh, k0, n, 0, dh, xs, LX, W);
      __syncthreads();
      tile_fma<DT>(acc, ta, xs, LX, min(TILE, n - k0), ty, tx);
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty * 4 + a;
      float part = 0.0f;
#pragma unroll
      for (int dd_ = 0; dd_ < DT; ++dd_)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = dd_ * TILE + tx * 4 + j;
          if (i < nv && d < dh)
            part = fmaf(acc[a][dd_ * 4 + j],
                        to_f32(dyc[(long long)i * hd + d]), part);
        }
      part = row_sum16(part);
      if (tx == 0 && i < nv) ds[i] += (double)(expf(cs[i]) * part);
    }
    for (int n0 = 0; n0 < n; n0 += TILE) {
      float acc4[4][4];
      zero(acc4);
      for (int d0 = 0; d0 < dh; d0 += TILE) {
        tile_t(dyc, hd, i0, nv, d0, dh, ta);
        tile_t(S, dh, n0, n, d0, dh, tb);
        __syncthreads();
        tile_fma<1>(acc4, ta, tb, LDT, min(TILE, dh - d0), ty, tx);
        __syncthreads();
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty * 4 + a;
        if (i >= nv) continue;
        const float e = expf(cs[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = n0 + tx * 4 + j;
          if (k < n) dCc[(long long)i * hn + k] = e * acc4[a][j];
        }
      }
    }
  }

  for (int J = 0; J < ntv; ++J) {
    const int j0 = J * TILE;
    float dxt[4][4 * DT];
    zero(dxt);
    for (int I = J; I < ntv; ++I) {
      const int i0 = I * TILE;
      float G[4][4], R[4][4];
      zero(G);
      zero(R);
      for (int k0 = 0; k0 < n; k0 += TILE) {
        tile_t(Cc, n, i0, nv, k0, n, ta);
        tile_t(Bc, n, j0, nv, k0, n, tb);
        __syncthreads();
        tile_fma<1>(G, ta, tb, LDT, min(TILE, n - k0), ty, tx);
        __syncthreads();
      }
      for (int d0 = 0; d0 < dh; d0 += TILE) {
        tile_t(dyc, hd, i0, nv, d0, dh, ta);
        tile_t(xc, hd, j0, nv, d0, dh, tb);
        __syncthreads();
        tile_fma<1>(R, ta, tb, LDT, min(TILE, dh - d0), ty, tx);
        __syncthreads();
      }
      double col[4] = {0.0, 0.0, 0.0, 0.0}, colr[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int il = ty * 4 + a;
        const int i = i0 + il;
        double row = 0.0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int jl = tx * 4 + b;
          const int tau = j0 + jl;
          const float e = (tau <= i && i < nv) ? expf(cs[i] - cs[tau]) : 0.0f;
          const float mb = G[a][b] * e;
          const float v = e * dts[tau] * R[a][b];
          const float wv = G[a][b] * v;
          Mb[il * LDT + jl] = mb;
          Vb[il * LDT + jl] = v;
          VTb[jl * LDT + il] = v;
          row += wv;
          col[b] += wv;
          colr[b] += (double)mb * R[a][b];
        }
        row = row_sum16(row);
        if (tx == 0 && i < nv) ds[i] += row;
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        red[ty * TILE + tx * 4 + b] = col[b];
        red2[ty * TILE + tx * 4 + b] = colr[b];
      }
      tile_r(dyc, hd, i0, nv, 0, dh, xs, LX, W);
      __syncthreads();
      if (threadIdx.x < TILE) {
        double sum = 0.0, sumr = 0.0;
        for (int y = 0; y < 16; ++y) {
          sum += red[y * TILE + threadIdx.x];
          sumr += red2[y * TILE + threadIdx.x];
        }
        ds[j0 + threadIdx.x] -= sum;
        dd[j0 + threadIdx.x] += sumr;
      }
      tile_fma<DT>(dxt, Mb, xs, LX, TILE, ty, tx);
      for (int n0 = 0; n0 < n; n0 += TILE) {
        __syncthreads();
        tile_r(Cc, n, i0, nv, n0, n, ta, LDT, TILE);
        tile_r(Bc, n, j0, nv, n0, n, tb, LDT, TILE);
        __syncthreads();
        float acc4[4][4];
        zero(acc4);
        tile_fma<1>(acc4, Vb, ta, LDT, TILE, ty, tx);   // V^T C_I -> dB_J
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int tau = j0 + ty * 4 + a;
          if (tau >= nv) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = n0 + tx * 4 + j;
            if (k >= n) continue;
            float* p = dBc + (long long)tau * hn + k;
            *p = I == J ? acc4[a][j] : *p + acc4[a][j];
          }
        }
        zero(acc4);
        tile_fma<1>(acc4, VTb, tb, LDT, TILE, ty, tx);  // V B_J -> dC_I
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ty * 4 + a;
          if (i >= nv) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = n0 + tx * 4 + j;
            if (k < n) dCc[(long long)i * hn + k] += acc4[a][j];
          }
        }
      }
      __syncthreads();
    }

    // the state that the chunk leaves: B Z into dxt, u, w x Z^T into dB
    float bz[4][4 * DT];
    zero(bz);
    for (int k0 = 0; k0 < n; k0 += TILE) {
      tile_t(Bc, n, j0, nv, k0, n, ta);
      tile_r(Z, dh, k0, n, 0, dh, xs, LX, W);
      __syncthreads();
      tile_fma<DT>(bz, ta, xs, LX, min(TILE, n - k0), ty, tx);
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int tau = j0 + ty * 4 + a;
      const bool live = tau < nv;
      const float el = live ? expf(last - cs[tau]) : 0.0f;
      double u = 0.0;
#pragma unroll
      for (int dd_ = 0; dd_ < DT; ++dd_)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = dd_ * TILE + tx * 4 + j;
          float& g = dxt[a][dd_ * 4 + j];
          g = fmaf(el, bz[a][dd_ * 4 + j], g);
          if (live && d < dh) {
            const float xv = to_f32(xc[(long long)tau * hd + d]);
            u += (double)bz[a][dd_ * 4 + j] * xv;
            store(dxc + (long long)tau * hd + d, dts[tau] * g);
          }
        }
      u = row_sum16(u);
      if (tx == 0 && live) {
        const double uwv = u * dts[tau] * el;
        ds[tau] -= uwv;
        uw[tau] = uwv;
        dd[tau] += u * el;
      }
    }
    for (int n0 = 0; n0 < n; n0 += TILE) {
      float acc4[4][4];
      zero(acc4);
      for (int d0 = 0; d0 < dh; d0 += TILE) {
        tile_t(xc, hd, j0, nv, d0, dh, ta);
        tile_t(Z, dh, n0, n, d0, dh, tb);
        __syncthreads();
        tile_fma<1>(acc4, ta, tb, LDT, min(TILE, dh - d0), ty, tx);
        __syncthreads();
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int tau = j0 + ty * 4 + a;
        if (tau >= nv) continue;
        const float w = dts[tau] * expf(last - cs[tau]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = n0 + tx * 4 + j;
          if (k < n) dBc[(long long)tau * hn + k] += w * acc4[a][j];
        }
      }
    }
  }

  // exp(s_L) <S, Z> and sum(u w) at the chunk's last step
  double part = 0.0;
  for (long long e = threadIdx.x; e < (long long)n * dh; e += NT)
    part += (double)S[e] * Z[e];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    double sz = 0.0, su = 0.0;
    for (int w = 0; w < NT / 32; ++w) sz += red[w];
    for (int i = 0; i < nv; ++i) su += uw[i];
    ds[L - 1] += su + (double)decay[bh * n_chunks + c] * sz;
  }
  __syncthreads();
  chunk_revsum(ds, L);                  // da
  double pa = 0.0;
  for (int i = threadIdx.x; i < nv; i += NT) {
    ddt[(row0 + i) * h + hi] = (float)(a_h * ds[i] + dd[i]);
    pa += (double)dts[i] * ds[i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    pa += __shfl_xor_sync(0xffffffffu, pa, off);
  if (threadIdx.x % 32 == 0) scal[threadIdx.x / 32] = pa;
  __syncthreads();
  if (threadIdx.x == 0) {
    double sa = 0.0;
    for (int w = 0; w < NT / 32; ++w) sa += scal[w];
    dAp[bh * n_chunks + c] = (float)sa;
  }
}

template <typename T, int DT>
int launch_bwd(const void* x, const float* dt, const float* A, const float* B,
               const float* C, const void* dy, const float* ws,
               const float* decay, float* wsz, void* dx, float* ddt,
               float* dBh, float* dCh, float* dAp, int b, int t, int h,
               int dh, int n, int L, cudaStream_t stream) {
  const int L64 = round64(L);
  const int n_chunks = (t + L - 1) / L;
  const int n_kt = (n + TILE - 1) / TILE;
  const size_t s1 =
      sizeof(float) * ((size_t)TILE * LDT + TILE * ldx<DT>() + 2 * L64);
  const size_t sg = grad_smem<DT>(L64);
  const long long bh = (long long)b * h;
  const long long g1 = bh * n_chunks * n_kt;
  const long long g3 = bh * n_chunks;
  if (g1 > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_state_kernel<T, DT, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_chunk_grad_kernel<T, DT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sg);
  if (e != cudaSuccess) {               // a shape past the card's limit
    cudaGetLastError();
    return (int)e;
  }
  // the state adjoint: local sums (launch 1 as the adjoint), then the pass
  // from the last chunk (launch 2 reversed), in place on wsz
  ssd_chunk_state_kernel<T, DT, true><<<(unsigned)g1, NT, s1, stream>>>(
      (const T*)dy, dt, A, C, wsz, nullptr, t, h, dh, n, L, n_chunks, n_kt);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long long ne = (long long)n * dh;
  const long long total = bh * ne;
  ssd_state_pass_kernel<true>
      <<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
          wsz, decay, n_chunks, ne, total);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_chunk_grad_kernel<T, DT><<<(unsigned)g3, NT, sg, stream>>>(
      (const T*)x, dt, A, B, C, (const T*)dy, ws, wsz, decay, (T*)dx, ddt,
      dBh, dCh, dAp, t, h, dh, n, L, n_chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_dt(const void* x, const float* dt, const float* A,
                  const float* B, const float* C, const void* dy,
                  const float* ws, const float* decay, float* wsz, void* dx,
                  float* ddt, float* dBh, float* dCh, float* dAp, int b,
                  int t, int h, int dh, int n, int L, cudaStream_t st) {
#define SSD_BWD_CASE(k)                                                     \
  case k:                                                                   \
    return launch_bwd<T, k>(x, dt, A, B, C, dy, ws, decay, wsz, dx, ddt,    \
                            dBh, dCh, dAp, b, t, h, dh, n, L, st);
  switch ((dh + TILE - 1) / TILE) {
    SSD_BWD_CASE(1)
    SSD_BWD_CASE(2)
    SSD_BWD_CASE(3)
    SSD_BWD_CASE(4)
  }
#undef SSD_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T, int DT>
int launch(const void* x, const float* dt, const float* A, const float* B,
           const float* C, void* y, float* ws, float* decay, int b, int t,
           int h, int dh, int n, int L, cudaStream_t stream) {
  const int L64 = round64(L);
  const int n_chunks = (t + L - 1) / L;
  const int n_kt = (n + TILE - 1) / TILE;
  const int n_rt = (L + TILE - 1) / TILE;
  const size_t s1 =
      sizeof(float) * ((size_t)TILE * LDT + TILE * ldx<DT>() + 2 * L64);
  const size_t s3 = sizeof(float) * ((size_t)2 * n * LDT + TILE * LDT +
                                     TILE * ldx<DT>() + 2 * L64);
  const long long bh = (long long)b * h;
  const long long g1 = bh * n_chunks * n_kt;
  const long long g3 = bh * n_chunks * n_rt;
  if (g1 > 0x7fffffffLL || g3 > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_state_kernel<T, DT, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_chunk_out_kernel<T, DT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s3);
  if (e != cudaSuccess) {               // a shape past the card's limit
    cudaGetLastError();                 // clear it for the next launch
    return (int)e;
  }
  ssd_chunk_state_kernel<T, DT, false><<<(unsigned)g1, NT, s1, stream>>>(
      (const T*)x, dt, A, B, ws, decay, t, h, dh, n, L, n_chunks, n_kt);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long long ne = (long long)n * dh;
  const long long total = bh * ne;
  ssd_state_pass_kernel<false>
      <<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
          ws, decay, n_chunks, ne, total);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_chunk_out_kernel<T, DT><<<(unsigned)g3, NT, s3, stream>>>(
      (const T*)x, dt, A, B, C, ws, (T*)y, t, h, dh, n, L, n_chunks, n_rt);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dt(const void* x, const float* dt, const float* A, const float* B,
              const float* C, void* y, float* ws, float* decay, int b, int t,
              int h, int dh, int n, int L, cudaStream_t st) {
  switch ((dh + TILE - 1) / TILE) {
    case 1: return launch<T, 1>(x, dt, A, B, C, y, ws, decay, b, t, h, dh, n,
                                L, st);
    case 2: return launch<T, 2>(x, dt, A, B, C, y, ws, decay, b, t, h, dh, n,
                                L, st);
    case 3: return launch<T, 3>(x, dt, A, B, C, y, ws, decay, b, t, h, dh, n,
                                L, st);
    case 4: return launch<T, 4>(x, dt, A, B, C, y, ws, decay, b, t, h, dh, n,
                                L, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x (b, t, h, dh) and y like x, bf16 when is_bf16 else float32; dt (b, t, h),
// A (h,), B and C (b, t, n) float32; all contiguous; L >= 1, 1 <= dh <= 256.
// ws: b * h * n_chunks * n * dh floats and decay: b * h * n_chunks floats
// of scratch (n_chunks = ceil(t / L)).  A shape whose shared memory passes
// the card's limit returns the attribute's error.
int ssd_scan_fwd(const void* x, const float* dt, const float* A,
                 const float* B, const float* C, void* y, float* ws,
                 float* decay, int b, int t, int h, int dh, int n, int L,
                 int is_bf16, void* stream) {
  if (b <= 0 || t <= 0 || h <= 0) return (int)cudaGetLastError();
  if (L < 1 || n < 1 || dh < 1 || dh > MAX_DT * TILE)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch_dt<__nv_bfloat16>(x, dt, A, B, C, y, ws, decay, b,
                                            t, h, dh, n, L, st)
                 : launch_dt<float>(x, dt, A, B, C, y, ws, decay, b, t, h,
                                    dh, n, L, st);
}

// The backward of ssd_scan_fwd: x, dt, A, B, C as there; dy like x (the
// upstream gradient); ws and decay the forward's workspace and decays
// after its run (ws then holds the state entering each chunk); wsz
// scratch like ws.  Writes dx like x, ddt (b, t, h), the per-head parts
// dBh and dCh (b, t, h, n) and dAp (b, h, n_chunks), all float32 but dx;
// the caller sums dBh and dCh over h and dAp over b and the chunks.
int ssd_scan_bwd(const void* x, const float* dt, const float* A,
                 const float* B, const float* C, const void* dy,
                 const float* ws, const float* decay, float* wsz, void* dx,
                 float* ddt, float* dBh, float* dCh, float* dAp, int b,
                 int t, int h, int dh, int n, int L, int is_bf16,
                 void* stream) {
  if (b <= 0 || t <= 0 || h <= 0) return (int)cudaGetLastError();
  if (L < 1 || n < 1 || dh < 1 || dh > MAX_DT * TILE)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16
             ? launch_bwd_dt<__nv_bfloat16>(x, dt, A, B, C, dy, ws, decay,
                                            wsz, dx, ddt, dBh, dCh, dAp, b,
                                            t, h, dh, n, L, st)
             : launch_bwd_dt<float>(x, dt, A, B, C, dy, ws, decay, wsz, dx,
                                    ddt, dBh, dCh, dAp, b, t, h, dh, n, L,
                                    st);
}

}  // extern "C"
