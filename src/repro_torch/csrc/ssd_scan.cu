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
// The entry point has a plain C interface for ctypes and returns the
// first error of its launches (cudaGetLastError()).

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

// Launch 1: upd_c rows [k0, k0 + 64) for one (batch x head, chunk).
template <typename T, int DT>
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
  for (int i = threadIdx.x; i < L64; i += NT)
    dts[i] = dts[i] * expf(last - cs[i]);   // w = dt * exp(s_L - s)
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
  if (kt == 0 && threadIdx.x == 0)
    decay[(long long)bh * n_chunks + c] = expf(last);
}

// Launch 2: the chunk states' recurrence, in place on the workspace.  A
// thread loads PASS chunks' upd before it writes any S_in, so PASS loads
// are in flight at once: the launch is bound by the workspace's bytes,
// not by the latency of one load per chunk.
constexpr int PASS = 16;

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
      if (c0 + j < n_chunks) u[j] = p[(c0 + j) * ne];
#pragma unroll
    for (int j = 0; j < PASS; ++j)
      if (c0 + j < n_chunks) {
        p[(c0 + j) * ne] = st;
        st = dec[c0 + j] * st + u[j];
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
      ssd_chunk_state_kernel<T, DT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_chunk_out_kernel<T, DT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s3);
  if (e != cudaSuccess) {               // a shape past the card's limit
    cudaGetLastError();                 // clear it for the next launch
    return (int)e;
  }
  ssd_chunk_state_kernel<T, DT><<<(unsigned)g1, NT, s1, stream>>>(
      (const T*)x, dt, A, B, ws, decay, t, h, dh, n, L, n_chunks, n_kt);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long long ne = (long long)n * dh;
  const long long total = bh * ne;
  ssd_state_pass_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
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

}  // extern "C"
