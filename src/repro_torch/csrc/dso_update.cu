// Hand-written Hopper (sm_90a) kernel for the dense DSO tile step: the
// dense launch A.
//
// Replaces the bodies of the reference's Pallas TPU kernels
//   src/repro/kernels/dso_update.py  _fused_block_kernel (:217), launched by
//       dso_block_step_pallas (:354) through _fused_call (pallas_call :274)
//   src/repro/kernels/dso_update.py  _fused_tile_kernel  (:168), launched by
//       dso_tile_step_pallas  (:314) through the same pallas_call
// Both compute one Jacobi tile step per row tile; the block kernel runs
// row_batches of them in order.  On the card they are one function: the
// wrappers (kernels/ops.py dso_block_step, dso_tile_step) launch this kernel
// and then the shared launch B (primal_update_kernel, dso_sparse.cu) once
// per row tile, all p processors in each launch.
//
// What it computes, for row tile [r0, r0 + rb) of every processor q with
// active block b = blk_ids[q], reading each element of the (rb, db) slice
// X[q, i, b*db + j] exactly ONCE:
//   xw_i     = sum_j X[i, j] * w[b, j]            (pre-update w)
//   alpha_i, ga_i <- dual Eq.-8 AdaGrad step + App.-B projection
//   acc[q,j] += sum_i X[i, j] * alpha_old_i        (X^T alpha, for launch B)
//
// What changes on the card.  The Pallas grid walks row tiles in order on one
// core and sums X^T alpha in VMEM across them.  Here blocks run in parallel
// in no order, so the cross-row sum is split off into the (p, db) acc buffer
// that launch B consumes and zeroes, as in the sparse design.
//
// Layout of the work: one CTA of 8 warps per (chunk of 512 rows, processor
// q).  A warp carries 8 rows at a time through one sweep of the block's
// columns; lane l reads column j = l, l + 32, ... of all 8 rows (coalesced
// 4-byte loads: 32 consecutive floats of one row per load, 8 loads in flight
// per lane).  The 8 row dot products stay in registers and are finished by a
// butterfly of shuffles; the 8 rows' X^T alpha partial of column j is
// summed in a register and added into a per-CTA column partial in shared
// memory, which is flushed with one global atomicAdd per column per CTA.
// Any db works: when the (db,) partial does not fit in 48 KB (db > 12,288)
// the same kernel adds the 8-row partials straight into acc in device memory
// instead.  w is read through the read-only cache (its block is 4*db bytes;
// each lane reuses its w[j] across the 8 rows).
//
// Alignment: a block's rows start at float offset b*db (b*289 at ocr's
// d = 1,156, p = 4), which is not 16-byte aligned, so the kernel makes only
// 4-byte loads, which need no alignment.
//
// Jacobi reads: launch A never writes w; each row's alpha is read into a
// register before the column sweep and written by its own lane after it, so
// both mat-vecs see the pre-update (w, alpha).  Blocks are disjoint because
// blk_ids is a permutation (Lemma 2).
//
// Reduction order: atomics (shared, then global).  They keep launch B and
// its (p, db) acc contract shared with the sparse kernels; the price is a
// sum order that changes from run to run, so results agree with the plain
// PyTorch version to 1e-5, not bitwise.  Padding rows (X row 0, tile count
// 0, row_nnz 1) and padding columns (X column 0, tile count 0, col_nnz 1)
// add exact zeros and take zero steps, as in the reference.
//
// Bound: bytes.  A tile step reads 4*rb*db bytes of X per processor and
// does 4 flops per element (two FMAs), ~1 flop per byte, far below the
// card's float32 rate.  No tensor core and no TF32: the products are fp32
// FMAs in the kernel's own body.
//
// The entry point has a plain C interface for ctypes and returns
// cudaGetLastError() after its launch.

#include "dso_common.cuh"

namespace {

using namespace dso;

constexpr unsigned FULL = 0xffffffffu;
constexpr int DENSE_WARPS = 8;          // warps per CTA
constexpr int ROWS_PER_WARP = 8;        // rows a warp carries through a sweep
constexpr int ROWS_PER_CTA = 512;       // rows of the tile one CTA covers
constexpr int SMEM_COLS = 12288;        // widest block with a shared partial

// Launch A on the dense grid.  X row i of processor q starts at
// X + q * proc_stride + i * ld; the active block's columns start b*db
// floats further.  Vectors (p, mb); trn_g (p, p, mb); acc (p, db).
template <bool SMEM_ACC>
__global__ void __launch_bounds__(DENSE_WARPS * 32)
dense_dual_scatter_kernel(
    const float* __restrict__ X, long long ld, long long proc_stride,
    const int* __restrict__ blk_ids, const float* __restrict__ yg,
    const float* __restrict__ w_grid, float* __restrict__ alpha,
    float* __restrict__ ga, const float* __restrict__ trn_g,
    const float* __restrict__ rn_g, float* __restrict__ acc, int p, int mb,
    int db, int r0, int rb, float eta, float m, int loss) {
  extern __shared__ float col_part[];              // (db,) when SMEM_ACC
  const int q = blockIdx.y;
  const int b = blk_ids[q];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* Xq = X + q * proc_stride + (long long)b * db;
  const float* w = w_grid + (long long)b * db;
  float* acc_q = acc + (long long)q * db;
  float* cacc = SMEM_ACC ? col_part : acc_q;
  if (SMEM_ACC) {
    for (int j = threadIdx.x; j < db; j += blockDim.x) col_part[j] = 0.0f;
    __syncthreads();
  }
  const int lo = blockIdx.x * ROWS_PER_CTA;        // offsets in the tile
  const int hi = min(lo + ROWS_PER_CTA, rb);
  for (int g = lo + warp * ROWS_PER_WARP; g < hi;
       g += DENSE_WARPS * ROWS_PER_WARP) {
    const int n_live = min(ROWS_PER_WARP, hi - g);  // warp-uniform
    const long long row0 = (long long)q * mb + r0 + g;
    const float a_mine = (lane < n_live) ? alpha[row0 + lane] : 0.0f;
    float a[ROWS_PER_WARP], xs[ROWS_PER_WARP];
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      a[r] = __shfl_sync(FULL, a_mine, r);
      xs[r] = 0.0f;
    }
    const float* x0 = Xq + (long long)(r0 + g) * ld;
    for (int j = lane; j < db; j += 32) {
      const float wj = __ldg(w + j);
      float cj = 0.0f;
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r) {
        if (r < n_live) {
          const float x = __ldg(x0 + r * ld + j);
          xs[r] = fmaf(x, wj, xs[r]);
          cj = fmaf(x, a[r], cj);
        }
      }
      if (cj != 0.0f) atomicAdd(cacc + j, cj);
    }
    float xw = 0.0f;                                // lane r keeps row r's
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      float s = xs[r];
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(FULL, s, off);
      if (lane == r) xw = s;
    }
    if (lane < n_live) {
      const long long row = row0 + lane;
      dual_step(loss, xw, a_mine, alpha, ga, row, yg[row],
                trn_g[((long long)q * p + b) * mb + r0 + g + lane],
                rn_g[row], eta, m);
    }
  }
  if (SMEM_ACC) {
    __syncthreads();
    for (int j = threadIdx.x; j < db; j += blockDim.x) {
      const float v = col_part[j];
      if (v != 0.0f) atomicAdd(acc_q + j, v);
    }
  }
}

}  // namespace

extern "C" {

int dso_dense_dual_scatter(const float* X, long long ld,
                           long long proc_stride, const int* blk_ids,
                           const float* yg, const float* w_grid, float* alpha,
                           float* ga, const float* trn_g, const float* rn_g,
                           float* acc, int p, int mb, int db, int r0, int rb,
                           float eta, float m, int loss, void* stream) {
  if (p > 0 && rb > 0 && db > 0) {
    dim3 grid(dso::blocks_for(rb, ROWS_PER_CTA), p);
    cudaStream_t st = (cudaStream_t)stream;
    if (db <= SMEM_COLS)
      dense_dual_scatter_kernel<true>
          <<<grid, DENSE_WARPS * 32, db * sizeof(float), st>>>(
              X, ld, proc_stride, blk_ids, yg, w_grid, alpha, ga, trn_g,
              rn_g, acc, p, mb, db, r0, rb, eta, m, loss);
    else
      dense_dual_scatter_kernel<false><<<grid, DENSE_WARPS * 32, 0, st>>>(
          X, ld, proc_stride, blk_ids, yg, w_grid, alpha, ga, trn_g, rn_g,
          acc, p, mb, db, r0, rb, eta, m, loss);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
