// Hand-written Hopper (sm_90a) kernel for the Mamba2 SSD chunked scan.
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
// steps.  Here one CTA takes one (batch, head) and loops over its chunks
// itself, with the state in shared memory for the whole sequence: 16 KB at
// n = dh = 64 (zamba2), 32 KB at n = 128 (mamba2-370m).  The ragged end of
// t is masked in the kernel: steps past t read dt = 0, x = B = C = 0, which
// is the reference's padding (a zero step is a no-op) without a padded
// copy, and their y is not stored.
//
// Per chunk, 512 threads (16 warps: the one CTA on its SM is bound by the
// latency of shared-memory loads, and 16 warps hide more of it than 8):
// load dt, B, C and x into shared memory (float32);
// warp 0 takes the cumulative sum; then rows of M in blocks of 32 (each
// entry a dot product over n, only tau <= t), y for those rows (the masked
// product with x plus the carried-state term), and last the state update.
// B rows sit at an odd stride so that the 32 taus a warp reads lie in 32
// banks.
//
// Known limit: one CTA per (batch, head) is b * h CTAs — 112 at zamba2-7b
// (b 1, h 112) on 132 SMs, under one wave, each walking its chunks in
// order.  A chunk-parallel design (intra-chunk terms for all chunks at
// once, then a short scan of chunk states) is later work.
//
// Bound: operations of the exact recurrence, ~5 * n * dh float32 flops per
// (step, head), against the card's float32 rate; the chunked form does
// ~L/2 times that in exchange for its parallelism.
//
// The entry point has a plain C interface for ctypes and returns
// cudaGetLastError() after its launch.

#include "float_io.cuh"

namespace {

using fio::store;
using fio::to_f32;

constexpr int NT = 512;                 // threads per CTA
constexpr int MB = 32;                  // rows of M per block

inline size_t ssd_smem_floats(int L, int n, int dh) {
  return (size_t)n * dh + (size_t)L * (n | 1) + (size_t)L * n +
         (size_t)L * dh + (size_t)MB * L + 3 * (size_t)L;
}

template <typename T>
__global__ void __launch_bounds__(NT)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, T* __restrict__ y, int t, int h,
           int dh, int n, int L) {
  extern __shared__ float smem[];
  const int ldb = n | 1;
  float* st = smem;                     // (n, dh) carried state
  float* Bs = st + n * dh;              // (L, ldb)
  float* Cs = Bs + L * ldb;             // (L, n)
  float* xs = Cs + L * n;               // (L, dh)
  float* Ms = xs + L * dh;              // (MB, L)
  float* dts = Ms + MB * L;             // (L,)
  float* cs = dts + L;                  // (L,) cumsum of A * dt
  float* win = cs + L;                  // (L,) dt * exp(s_L - s)

  const int bi = blockIdx.x / h;
  const int hi = blockIdx.x % h;
  const float a_h = A[hi];
  for (int i = threadIdx.x; i < n * dh; i += NT) st[i] = 0.0f;

  const int n_chunks = (t + L - 1) / L;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L;
    const int nv = min(L, t - t0);
    const long long row0 = (long long)bi * t + t0;    // (b, t) row index
    __syncthreads();                    // the last chunk's reads are done
    for (int i = threadIdx.x; i < L; i += NT)
      dts[i] = i < nv ? dt[(row0 + i) * h + hi] : 0.0f;
    for (int idx = threadIdx.x; idx < L * n; idx += NT) {
      const int i = idx / n;
      const int k = idx - i * n;
      const bool live = i < nv;
      Bs[i * ldb + k] = live ? Bm[(row0 + i) * n + k] : 0.0f;
      Cs[idx] = live ? Cm[(row0 + i) * n + k] : 0.0f;
    }
    for (int idx = threadIdx.x; idx < L * dh; idx += NT) {
      const int i = idx / dh;
      const int d = idx - i * dh;
      xs[idx] = i < nv ? to_f32(x[((row0 + i) * h + hi) * dh + d]) : 0.0f;
    }
    __syncthreads();

    if (threadIdx.x < 32) {             // inclusive scan of A * dt
      const int lane = threadIdx.x;
      const int per = (L + 31) / 32;
      const int lo = min(L, lane * per);
      const int hi_i = min(L, lo + per);
      float run = 0.0f;
      for (int i = lo; i < hi_i; ++i) run += a_h * dts[i];
      float incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      const float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      float pre = lane > 0 ? excl : 0.0f;
      for (int i = lo; i < hi_i; ++i) {
        pre += a_h * dts[i];
        cs[i] = pre;
      }
    }
    __syncthreads();
    const float last = cs[L - 1];
    for (int i = threadIdx.x; i < L; i += NT)
      win[i] = dts[i] * expf(last - cs[i]);

    for (int r0 = 0; r0 < L; r0 += MB) {
      const int rows = min(MB, L - r0);
      const int span = r0 + rows;       // taus that rows r0.. can see
      for (int idx = threadIdx.x; idx < rows * span; idx += NT) {
        const int r = idx / span;
        const int tau = idx - r * span;
        const int tt = r0 + r;
        float val = 0.0f;
        if (tau <= tt) {
          const float* cr = Cs + tt * n;
          const float* br = Bs + tau * ldb;
          float g = 0.0f;
#pragma unroll 8
          for (int k = 0; k < n; ++k) g = fmaf(cr[k], br[k], g);
          val = g * expf(cs[tt] - cs[tau]) * dts[tau];
        }
        Ms[r * L + tau] = val;
      }
      __syncthreads();                  // win and this block of M are ready
      for (int idx = threadIdx.x; idx < rows * dh; idx += NT) {
        const int r = idx / dh;
        const int d = idx - r * dh;
        const int tt = r0 + r;
        const float* mr = Ms + r * L;
        float acc = 0.0f;
        for (int tau = 0; tau <= tt; ++tau)
          acc = fmaf(mr[tau], xs[tau * dh + d], acc);
        const float* cr = Cs + tt * n;
        float cst = 0.0f;
#pragma unroll 8
        for (int k = 0; k < n; ++k) cst = fmaf(cr[k], st[k * dh + d], cst);
        acc += expf(cs[tt]) * cst;
        if (tt < nv) store(y + ((row0 + tt) * h + hi) * dh + d, acc);
      }
      __syncthreads();                  // M and the old state are read
    }

    const float keep = expf(last);
    for (int idx = threadIdx.x; idx < n * dh; idx += NT) {
      const int k = idx / dh;
      const int d = idx - k * dh;
      float acc = 0.0f;
      for (int tau = 0; tau < L; ++tau)
        acc = fmaf(Bs[tau * ldb + k], xs[tau * dh + d] * win[tau], acc);
      st[idx] = keep * st[idx] + acc;
    }
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const float* B,
           const float* C, void* y, int b, int t, int h, int dh, int n,
           int L, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ssd_smem_floats(L, n, dh);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) {               // a chunk past the card's limit
    cudaGetLastError();                 // clear it for the next launch
    return (int)e;
  }
  ssd_kernel<T><<<b * h, NT, smem, stream>>>((const T*)x, dt, A, B, C,
                                             (T*)y, t, h, dh, n, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (b, t, h, dh) and y like x, bf16 when is_bf16 else float32; dt (b, t, h),
// A (h,), B and C (b, t, n) float32; all contiguous; L >= 1.  A chunk whose
// shared memory passes the card's limit returns the attribute's error.
int ssd_scan_fwd(const void* x, const float* dt, const float* A,
                 const float* B, const float* C, void* y, int b, int t, int h,
                 int dh, int n, int L, int is_bf16, void* stream) {
  if (b <= 0 || t <= 0 || h <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(x, dt, A, B, C, y, b, t, h, dh, n,
                                         L, st)
                 : launch<float>(x, dt, A, B, C, y, b, t, h, dh, n, L, st);
}

}  // extern "C"
