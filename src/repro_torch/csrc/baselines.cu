// Hand-written Hopper (sm_90a) kernels for the epochs of two of the
// paper's Sec.-5 baselines: AdaGrad SGD (and PSGD, which runs it on p
// shards at once) and LIBLINEAR's dual coordinate descent (DCD).
//
// Replace no Pallas kernel: the reference runs both epochs as jitted
// lax.scans (src/repro/baselines/sgd.py:25 _sgd_epoch, src/repro/baselines/
// dcd.py:22 _dcd_epoch).  Run eagerly on the card, each step would be about
// ten PyTorch launches (~700,000 per epoch at real-sim's m 72,309), so each
// epoch here is ONE launch that walks every step.
//
// What they compute.
//   sgd_epoch_kernel, one block per worker: for each step s, the rows
//   r_b = rows[q][s*batch + b] (b < batch; -1 marks a padding row, whose
//   x and y are 0) give u_b = <x_{r_b}, w> and lg_b = l'(u_b, y_{r_b});
//   then over every column j
//       g_j   = lam * phi'(w_j) + (sum_b x_{r_b, j} lg_b) / batch
//       acc_j = acc_j + g_j^2
//       w_j   = w_j - eta0 * g_j / sqrt(acc_j + 1e-8)
//   (sgd.py:35-39).  The trailing m % batch rows of a permutation are not
//   passed in (nsteps = m // batch).
//   dcd_epoch_kernel, one block: for each step k, i = perm[k],
//       g      = 1 - y_i <w, x_i>
//       b_new  = clip(beta_i + g * 2 lam m / max(|x_i|^2, 1e-12), 0, 1)
//       w      = w + (b_new - beta_i) * y_i * scale * x_i,  beta_i = b_new
//   with scale = 1 / (2 lam m) (dcd.py:27-35).  A step whose coefficient
//   is 0 leaves w as it is (w + 0 * x is w), so its axpy is skipped.
//
// What bounds them.  Bytes: X's rows, read once each (4 m d bytes: 6.06 GB
// at real-sim's full size, 1.81 ms at 3.35 TB/s); the operations (~12 per
// element of X for SGD at batch 1, ~4 for DCD) are far below the float32
// rate.  But the steps are a chain: step s+1 reads the w that step s
// wrote, so a worker's epoch runs on ONE block, whose SM pulls X at a
// fraction of the card's rate.  The design keeps w (and acc) in shared
// memory when they fit (8 d bytes for SGD: 168 KB at d 20,958), so each
// step reads X's row from device memory and nothing else, and reduces the
// margin with warp shuffles and one exchange through shared memory.  A
// cluster of blocks splitting d, with the reduction in distributed shared
// memory, would spread a step over several SMs; not done here.
//
// Arithmetic, shared with the plain versions (kernels/baselines.py) so that
// the two agree bit for bit: each margin <x, w> and each column's
// sum_b x_{r_b, j} lg_b is summed in double (the products of floats are
// exact there) and rounded once to float; the loss gradient is taken in
// double from the float margin and rounded to float; every other operation
// is one IEEE-rounded float operation in the reference's order
// (__fmul_rn and friends, so nvcc contracts nothing into an FMA), and
// AdaGrad's rsqrt is 1 / sqrt.  So the order of a sum changes its float
// result only where the double sum lies within a double ulp of a float
// rounding boundary.  That matters for l1: a w near 0 that an ulp moves
// across 0 takes the other sign(w) and steps the other way, so float sums
// in another order than the plain version's part the two by a whole step.
//
// Determinism: no atomics, and every sum is taken in one fixed order (each
// thread's strided partial, then the warps' in index order), so two runs
// on the same inputs agree bit for bit.

#include "dso_common.cuh"

namespace {

using namespace dso;

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;

// d/du l(u, y) (core/losses.py's grad) in double: hinge's subgradient,
// logistic's -y * sigmoid(-y u) = -y / (1 + exp(y u)), square's u - y.
__device__ __forceinline__ double loss_grad(int loss, double u, double y) {
  if (loss == HINGE) return (y * u < 1.0) ? -y : 0.0;
  if (loss == LOGISTIC) return -y * (1.0 / (1.0 + exp(y * u)));
  return u - y;
}

__device__ __forceinline__ double warp_allsum(double s) {
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// The block's sum of every thread's v, returned to every thread, in one
// fixed order.  `red` holds WARPS doubles of shared memory.
__device__ __forceinline__ double block_sum(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_allsum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double t = lane < WARPS ? red[lane] : 0.0;
  t = warp_allsum(t);
  __syncthreads();          // red is free again
  return t;
}

// Dynamic shared memory: red[WARPS] (double), rid[batch] (int), lg[batch],
// then w and acc (d each) when SMEM.
template <bool SMEM>
__global__ void __launch_bounds__(THREADS) sgd_epoch_kernel(
    const float* __restrict__ X, long long ld, const float* __restrict__ y,
    const int* __restrict__ rows, int n_rows, float* w, float* acc, int d,
    int batch, float eta0, float lam, int loss, int reg) {
  extern __shared__ double smem[];
  double* red = smem;
  int* rid = reinterpret_cast<int*>(smem + WARPS);
  float* lg = reinterpret_cast<float*>(rid + batch);
  const int q = blockIdx.x, tid = threadIdx.x;
  float* wq = w + (long long)q * d;
  float* aq = acc + (long long)q * d;
  const int* rq = rows + (long long)q * n_rows;
  float* ws = SMEM ? lg + batch : wq;
  float* as = SMEM ? lg + batch + d : aq;
  if (SMEM) {
    for (int j = tid; j < d; j += THREADS) {
      ws[j] = wq[j];
      as[j] = aq[j];
    }
  }
  const float fb = (float)batch;
  const int nsteps = n_rows / batch;
  for (int s = 0; s < nsteps; ++s) {
    for (int b = tid; b < batch; b += THREADS) rid[b] = rq[s * batch + b];
    __syncthreads();
    for (int b = 0; b < batch; ++b) {
      const int r = rid[b];
      double part = 0.0;
      if (r >= 0) {
        const float* x = X + (long long)r * ld;
        for (int j = tid; j < d; j += THREADS)
          part += (double)x[j] * (double)ws[j];
      }
      const float u = (float)block_sum(part, red);
      if (tid == 0)
        lg[b] = r >= 0 ? (float)loss_grad(loss, u, y[r]) : 0.0f;
    }
    __syncthreads();
    for (int j = tid; j < d; j += THREADS) {
      double xs = 0.0;
      for (int b = 0; b < batch; ++b) {
        const int r = rid[b];
        if (r >= 0) xs += (double)X[(long long)r * ld + j] * (double)lg[b];
      }
      const float wj = ws[j];
      // g = lam * phi'(w) + (X_b^T lg) / batch
      const float g = __fadd_rn(__fmul_rn(lam, reg_grad(reg, wj)),
                                __fdiv_rn((float)xs, fb));
      const float a = __fadd_rn(as[j], __fmul_rn(g, g));
      const float rs = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(a, ADA_EPS)));
      as[j] = a;
      ws[j] = __fsub_rn(wj, __fmul_rn(__fmul_rn(eta0, g), rs));
    }
    __syncthreads();        // rid and lg are rewritten by the next step
  }
  if (SMEM) {
    for (int j = tid; j < d; j += THREADS) {
      wq[j] = ws[j];
      aq[j] = as[j];
    }
  }
}

// Dynamic shared memory: red[WARPS] (double), coef[1], then w (d) when
// SMEM.
template <bool SMEM>
__global__ void __launch_bounds__(THREADS) dcd_epoch_kernel(
    const float* __restrict__ X, long long ld, const float* __restrict__ y,
    const int* __restrict__ perm, int n, float* w, float* beta,
    const float* __restrict__ xnorm2, int d, float lam, float m,
    float scale) {
  extern __shared__ double smem[];
  double* red = smem;
  float* coef = reinterpret_cast<float*>(smem + WARPS);
  const int tid = threadIdx.x;
  float* ws = SMEM ? coef + 1 : w;
  if (SMEM)
    for (int j = tid; j < d; j += THREADS) ws[j] = w[j];
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    const int i = perm[k];
    const float* x = X + (long long)i * ld;
    double part = 0.0;
    for (int j = tid; j < d; j += THREADS)
      part += (double)ws[j] * (double)x[j];
    const float dot = (float)block_sum(part, red);
    if (tid == 0) {
      const float yi = y[i];
      const float g = __fsub_rn(1.0f, __fmul_rn(yi, dot));
      // step = g * 2 * lam * m / max(|x_i|^2, 1e-12)
      const float step = __fdiv_rn(
          __fmul_rn(__fmul_rn(__fmul_rn(g, 2.0f), lam), m),
          fmaxf(xnorm2[i], 1e-12f));
      const float b_old = beta[i];
      const float b_new = clampf(__fadd_rn(b_old, step), 0.0f, 1.0f);
      beta[i] = b_new;
      coef[0] = __fmul_rn(__fmul_rn(__fsub_rn(b_new, b_old), yi), scale);
    }
    __syncthreads();
    const float c = coef[0];
    if (c != 0.0f)
      for (int j = tid; j < d; j += THREADS)
        ws[j] = __fadd_rn(ws[j], __fmul_rn(c, x[j]));
    __syncthreads();        // coef is rewritten by the next step
  }
  if (SMEM)
    for (int j = tid; j < d; j += THREADS) w[j] = ws[j];
}

int smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return bytes;
}

// Launch Kernel<true> with `base + staged` bytes of shared memory when
// that fits the card's opt-in limit, else Kernel<false> with `base`.
template <typename K, typename... Args>
cudaError_t launch(K small, K staged_kernel, size_t base, size_t staged,
                   unsigned grid, cudaStream_t stream, Args... args) {
  const bool fit = base + staged <= (size_t)smem_optin();
  K kern = fit ? staged_kernel : small;
  const size_t bytes = fit ? base + staged : base;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  kern<<<grid, THREADS, bytes, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One AdaGrad SGD epoch for each of n_workers workers (one block each), in
// place on w and acc (n_workers, d): worker q visits the n_rows row ids
// rows[q] (int32, -1 for a padding row) in steps of `batch`; X is (m, d)
// with row stride ld.
int sgd_epoch(const float* X, long long ld, const float* y, const int* rows,
              int n_workers, int n_rows, float* w, float* acc, int d,
              int batch, float eta0, float lam, int loss, int reg,
              void* stream) {
  if (n_workers == 0 || d == 0) return 0;
  const size_t base = WARPS * sizeof(double) + 2 * (size_t)batch * 4;
  return (int)launch(sgd_epoch_kernel<false>, sgd_epoch_kernel<true>, base,
                     2 * (size_t)d * sizeof(float), (unsigned)n_workers,
                     (cudaStream_t)stream, X, ld, y, rows, n_rows, w, acc, d,
                     batch, eta0, lam, loss, reg);
}

// One DCD epoch (one block), in place on w (d) and beta (m): the rows
// perm[0 .. n-1] of X (m, d; row stride ld) in turn; xnorm2 (m) holds
// |x_i|^2, m the problem's row count, scale 1 / (2 lam m).
int dcd_epoch(const float* X, long long ld, const float* y, const int* perm,
              int n, float* w, float* beta, const float* xnorm2, int d,
              float lam, float m, float scale, void* stream) {
  if (d == 0) return 0;
  const size_t base = WARPS * sizeof(double) + sizeof(float);
  return (int)launch(dcd_epoch_kernel<false>, dcd_epoch_kernel<true>, base,
                     (size_t)d * sizeof(float), 1u, (cudaStream_t)stream, X,
                     ld, y, perm, n, w, beta, xnorm2, d, lam, m, scale);
}

}  // extern "C"
