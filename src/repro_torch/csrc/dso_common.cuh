// Device helpers shared by the DSO kernels (dso_sparse.cu, dso_update.cu):
// the Eq.-8 loss/regulariser pieces, the dual step of one row, the primal
// step of one column, a warp sum.
//
// Arithmetic follows the reference's order of operations.  AdaGrad's rsqrt
// is computed as 1.0f / sqrtf(x) (both IEEE-rounded without fast-math), so
// it is within 1 ulp of the correctly rounded rsqrt.  The square loss's w
// box is +inf, which fminf/fmaxf take as it is.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dso {

enum Loss { HINGE = 0, LOGISTIC = 1, SQUARE = 2 };
enum Reg { L2 = 0, L1 = 1 };

constexpr float ADA_EPS = 1e-8f;
constexpr float LOG_LO = 1e-6f;
constexpr float LOG_HI = 0.999999f;   // float32(1 - 1e-6)

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float dual_grad(int loss, float a, float y) {
  if (loss == HINGE) return -y;
  if (loss == LOGISTIC) {
    float b = clampf(y * a, LOG_LO, LOG_HI);
    return y * (logf(b) - log1pf(-b));
  }
  return a - y;
}

__device__ __forceinline__ float project_alpha(int loss, float a, float y) {
  if (loss == HINGE) return y * clampf(y * a, 0.0f, 1.0f);
  if (loss == LOGISTIC) return y * clampf(y * a, LOG_LO, LOG_HI);
  return a;
}

__device__ __forceinline__ float reg_grad(int reg, float w) {
  if (reg == L2) return 2.0f * w;
  return (w > 0.0f) ? 1.0f : ((w < 0.0f) ? -1.0f : 0.0f);
}

__device__ __forceinline__ float warp_sum(float s) {
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  return s;
}

// Dual half of the Eq.-8 step of one row from its operands: its dot
// product xw with the pre-update w, its pre-update alpha a_old and AdaGrad
// sum ga_old; gives the new alpha and ga.
__device__ __forceinline__ void dual_update(int loss, float xw, float a_old,
                                            float ga_old, float y, float trn,
                                            float rn, float eta, float m,
                                            float& a_new, float& ga_new) {
  float g_a = -dual_grad(loss, a_old, y) * trn / (m * rn) - xw / m;
  ga_new = ga_old + g_a * g_a;
  float da = eta * g_a * (1.0f / sqrtf(ga_new + ADA_EPS));
  a_new = project_alpha(loss, a_old + da, y);
}

// Primal half of the Eq.-8 step of one column from its operands: its
// pre-update w and AdaGrad sum gw, its count tcn in the row tile, its
// column count cn and its entry acc of X^T alpha; gives the new w and gw.
// With tcn = 0 and acc = 0 the step is g_w = 0: a w inside [w_lo, w_hi]
// and a gw >= 0 come out bit for bit unchanged.
__device__ __forceinline__ void primal_update(int reg, float w, float gw,
                                             float tcn, float cn, float acc,
                                             float eta, float lam, float m,
                                             float w_lo, float w_hi,
                                             float& w_new, float& gw_new) {
  float g_w = lam * reg_grad(reg, w) * tcn / cn - acc / m;
  gw_new = gw + g_w * g_w;
  float dw = eta * g_w * (1.0f / sqrtf(gw_new + ADA_EPS));
  w_new = clampf(w - dw, w_lo, w_hi);
}

// The same for row r (alpha, ga at index r).
__device__ __forceinline__ void dual_step(int loss, float xw, float a_old,
                                          float* alpha, float* ga,
                                          long long r, float y, float trn,
                                          float rn, float eta, float m) {
  float a_new, ga_new;
  dual_update(loss, xw, a_old, ga[r], y, trn, rn, eta, m, a_new, ga_new);
  alpha[r] = a_new;
  ga[r] = ga_new;
}

inline unsigned blocks_for(long long n, int per_block) {
  return (unsigned)((n + per_block - 1) / per_block);
}

// The card's SM count, read once.
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// CTAs of Kernel per SM at `threads` threads and `smem` bytes of dynamic
// shared memory, worked out when the size changes (a grid keeps one size
// from step to step), together with the attribute that lets the kernel
// take that much.  On an error the error state is cleared for the next
// launch and the error returned.
template <auto Kernel>
cudaError_t ctas_per_sm(int threads, size_t smem, int* per_sm) {
  static size_t last = 0;
  static int n = 0;                     // 0 until worked out
  if (n == 0 || smem != last) {
    cudaError_t e = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, Kernel, threads,
                                                        smem);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return e;
    }
    last = smem;
  }
  *per_sm = n;
  return cudaSuccess;
}

}  // namespace dso
