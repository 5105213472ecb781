// Hand-written Hopper (sm_90a) kernel for the paper-exact serial DSO epoch.
//
// Replaces no Pallas kernel: the reference runs its serial epochs
// (src/repro/engine/driver.py _serial_epochs, :669) as a jnp lax.scan over
// the epoch's nonzeros.  Run eagerly on the card, each step would be about
// ten PyTorch launches, so the port walks the whole epoch in one launch.
//
// What it computes.  Algorithm 1 with p = 1: for k = 0 .. nnz-1, the
// nonzero e = order[k] at (i, j) = (ii[e], jj[e]) with value x = vv[e]
// takes the Eq.-8 step on (w_j, alpha_i), read simultaneously (Lemma 2's
// form), with AdaGrad (optional) and the App.-B projections, exactly as
// driver.py:680-702 does.  Step k reads the w_j and alpha_i that an
// earlier step may have written, so the chain is sequential by definition:
// ONE thread walks it.
//
// What bounds it.  Not bytes (16 per nonzero plus 24 per row and 20 per
// column, read or written once: well under a microsecond at the sizes it
// runs) but the chain of dependent loads: order[k] -> (ii, jj, vv)[e] ->
// the operands of row i and column j, every step, on one thread.  The
// function's own floor is the critical path of the epoch's dependency
// graph (steps that share a row or a column), which the plain version
// walks as waves; a kernel that ran a wave per step of its threads would
// approach it.  This kernel is the simple, right one; it is not tuned.
//
// Arithmetic.  The reference's, as its compiled scan runs it on the CPU
// (kernels/dso_serial.py says which operations): x / m as x * (1 / m),
// fmaf wherever XLA contracts a fused multiply-add, and every other
// product, quotient and sum rounded on its own (__fmul_rn and friends, so
// nvcc contracts nothing else); AdaGrad's rsqrt is 1 / sqrt, each
// IEEE-rounded, and logistic's log and log1p are taken in double and
// rounded to float, as the plain version computes them, so the two agree
// bit for bit but for a rare double rounding.

#include "dso_common.cuh"

namespace {

using namespace dso;

// dual_grad with logistic's logs in double, rounded to float.
__device__ __forceinline__ float serial_dual_grad(int loss, float a,
                                                  float y) {
  if (loss != LOGISTIC) return dual_grad(loss, a, y);
  const double b = (double)clampf(__fmul_rn(y, a), LOG_LO, LOG_HI);
  return __fmul_rn(y, __fsub_rn((float)log(b), (float)log1p(-b)));
}

__global__ void serial_epoch_kernel(
    const int* __restrict__ ii, const int* __restrict__ jj,
    const float* __restrict__ vv, const int* __restrict__ order, int nnz,
    float* w, float* alpha, float* gw, float* ga,
    const float* __restrict__ y, const float* __restrict__ rn,
    const float* __restrict__ cn, float eta, float lam, float m,
    float w_lo, float w_hi, int loss, int reg, int adagrad) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  const float inv_m = __fdiv_rn(1.0f, m);
  for (int k = 0; k < nnz; ++k) {
    const int e = order[k];
    const int i = ii[e], j = jj[e];
    const float x = vv[e];
    const float wj = w[j], ai = alpha[i], yi = y[i];
    // g_w = lam * phi'(w_j) / |Omega-bar_j| - alpha_i * x / m
    const float g_w = fmaf(-__fmul_rn(ai, x), inv_m,
                           __fdiv_rn(__fmul_rn(lam, reg_grad(reg, wj)),
                                     cn[j]));
    // g_a = -l*'(-alpha_i) / (m |Omega_i|) - w_j * x / m
    const float g_a = fmaf(-__fmul_rn(wj, x), inv_m,
                           __fdiv_rn(-serial_dual_grad(loss, ai, yi),
                                     __fmul_rn(m, rn[i])));
    float w_new, a_new;
    if (adagrad) {
      const float gw_new = fmaf(g_w, g_w, gw[j]);
      const float ga_new = fmaf(g_a, g_a, ga[i]);
      w_new = fmaf(-__fmul_rn(eta, g_w),
                   __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(gw_new, ADA_EPS))),
                   wj);
      a_new = fmaf(__fmul_rn(eta, g_a),
                   __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(ga_new, ADA_EPS))),
                   ai);
      gw[j] = gw_new;
      ga[i] = ga_new;
    } else {
      w_new = fmaf(g_w, -eta, wj);
      a_new = fmaf(g_a, eta, ai);
    }
    w[j] = clampf(w_new, w_lo, w_hi);
    alpha[i] = project_alpha(loss, a_new, yi);
  }
}

}  // namespace

extern "C" {

// One serial epoch in visit order `order` (nnz,) over the coordinates
// (ii, jj, vv); in place on w, gw (d,) and alpha, ga (m,).
int dso_serial_epoch(const int* ii, const int* jj, const float* vv,
                     const int* order, int nnz, float* w, float* alpha,
                     float* gw, float* ga, const float* y, const float* rn,
                     const float* cn, float eta, float lam, float m,
                     float w_lo, float w_hi, int loss, int reg, int adagrad,
                     void* stream) {
  serial_epoch_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      ii, jj, vv, order, nnz, w, alpha, gw, ga, y, rn, cn, eta, lam, m,
      w_lo, w_hi, loss, reg, adagrad);
  return (int)cudaGetLastError();
}

}  // extern "C"
