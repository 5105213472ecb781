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
// and the input w to the dual pass, and the outputs are separate tensors.
//
// What changes on the card.  On the TPU each pass carries its sum across a
// sequential grid.  Here CTAs run in no order:
//   primal pass — a column sum over all M rows.  One CTA covers 32 columns
//       (one per lane) and ROWS_PER_CTA rows (8 warps, interleaved rows), so
//       a warp reads 32 consecutive floats of one row per load.  The 8 warps'
//       partials meet in shared memory and the CTA adds them to acc[j] and
//       cnt[j] with one atomicAdd each.  The primal step itself is the shared
//       launch B (dso_sparse.cu primal_update_kernel at p = 1, block 0), fed
//       acc as X^T alpha and cnt as its tile column counts; it zeroes acc.
//   dual pass — a per-row reduction, one warp per row as in the sparse
//       launch A: lane l reads columns l, l + 32, ... of its row, a butterfly
//       of shuffles sums X w and the row's nonzero count, and lane 0 takes
//       the dual step with the count as the tile row count.
// Counts are sums of 0/1 in float32, exact below 2^24 rows or columns.
// Atomics reorder the column sums from run to run, so the result agrees
// with the plain PyTorch version to 1e-5, not bitwise.
//
// Bound: bytes.  Each pass reads 4*M*D bytes of X (8*M*D for the step, twice
// the fused step's) and does ~3 flops per element.  Only 4-byte loads: a
// row-strided view of a dense grid starts rows at unaligned offsets.
//
// The entry points have a plain C interface for ctypes and return
// cudaGetLastError() after their launch.

#include "dso_common.cuh"

namespace {

using namespace dso;

constexpr int TP_WARPS = 8;             // warps per CTA (both passes)
constexpr int ROWS_PER_CTA = 1024;      // primal pass: rows of one CTA
constexpr int ROW_UNROLL = 8;           // primal pass: loads in flight

__global__ void __launch_bounds__(TP_WARPS * 32)
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

__global__ void __launch_bounds__(TP_WARPS * 32)
twopass_dual_kernel(const float* __restrict__ X, long long ld, int M, int D,
                    const float* __restrict__ w,
                    const float* __restrict__ alpha_in,
                    float* __restrict__ alpha_out, float* __restrict__ ga,
                    const float* __restrict__ y, const float* __restrict__ rn,
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
      // dual_step reads ga[i] and writes alpha_out[i], ga[i]
      dual_step(loss, s, alpha_in[i], alpha_out, ga, i, y[i], c, rn[i], eta,
                m);
    }
  }
}

}  // namespace

extern "C" {

// acc and cnt (D,) must be zero; the primal pass adds X^T alpha and the
// column counts into them.
int dso_twopass_primal(const float* X, long long ld, int M, int D,
                       const float* alpha, float* acc, float* cnt,
                       void* stream) {
  if (M > 0 && D > 0) {
    dim3 grid(dso::blocks_for(D, 32), dso::blocks_for(M, ROWS_PER_CTA));
    twopass_primal_kernel<<<grid, TP_WARPS * 32, 0, (cudaStream_t)stream>>>(
        X, ld, M, D, alpha, acc, cnt);
  }
  return (int)cudaGetLastError();
}

int dso_twopass_dual(const float* X, long long ld, int M, int D,
                     const float* w, const float* alpha_in, float* alpha_out,
                     float* ga, const float* y, const float* rn, float eta,
                     float m, int loss, void* stream) {
  if (M > 0) {
    // 16 rows per warp at most, at least one wave of the 132 SMs x 8 CTAs
    const unsigned all = dso::blocks_for(M, TP_WARPS);
    const unsigned few = dso::blocks_for(M, TP_WARPS * 16);
    const unsigned want = few > 132u * 8u ? few : 132u * 8u;
    const unsigned n_cta = want < all ? want : all;
    twopass_dual_kernel<<<n_cta, TP_WARPS * 32, 0, (cudaStream_t)stream>>>(
        X, ld, M, D, w, alpha_in, alpha_out, ga, y, rn, eta, m, loss);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
