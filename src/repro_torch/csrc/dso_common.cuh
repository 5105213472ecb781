// Device helpers shared by the DSO kernels (dso_sparse.cu, dso_update.cu):
// the Eq.-8 loss/regulariser pieces, the dual step of one row, a warp sum.
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

// Dual half of the Eq.-8 step for row r (alpha, ga at index r), from its
// dot product xw with the pre-update w and its pre-update alpha a_old.
__device__ __forceinline__ void dual_step(int loss, float xw, float a_old,
                                          float* alpha, float* ga,
                                          long long r, float y, float trn,
                                          float rn, float eta, float m) {
  float g_a = -dual_grad(loss, a_old, y) * trn / (m * rn) - xw / m;
  float ga_new = ga[r] + g_a * g_a;
  float da = eta * g_a * (1.0f / sqrtf(ga_new + ADA_EPS));
  alpha[r] = project_alpha(loss, a_old + da, y);
  ga[r] = ga_new;
}

inline unsigned blocks_for(long long n, int per_block) {
  return (unsigned)((n + per_block - 1) / per_block);
}

}  // namespace dso
