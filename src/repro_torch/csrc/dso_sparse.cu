// Hand-written Hopper (sm_90a) kernels for the sparse DSO block step.
//
// Replaces the reference's Pallas TPU kernels
//   src/repro/kernels/dso_sparse.py  dso_sparse_block_step_pallas   (:94, call :116)
//   src/repro/kernels/dso_sparse.py  dso_bucketed_block_step_pallas (:247, call :304)
//   src/repro/kernels/ops.py         _mosaic_sparse_gather_error probe (call :223)
//
// What changes on the card.  The Pallas grid walks the row tiles of ONE
// processor's active block in order on one core, carrying w/gw in VMEM.
// Here the driver's vmap over the p processors becomes a batch dimension of
// one launch, and the cross-row reduction X^T alpha is split off:
//
//   launch A (per row tile s, all p processors):  one warp per row
//       xw      = sum_k vals * w[blk][cols]        (gather, pre-update w)
//       acc[q] += vals * alpha_old  at cols         (atomicAdd scatter)
//       alpha, ga <- dual Eq.-8 AdaGrad step + App.-B projection
//   launch B (per row tile s, all p processors):  one thread per column
//       w[blk], gw[blk] <- primal Eq.-8 step from acc[q]; acc[q] = 0
//
// Jacobi reads: launch A never writes w, so every gather sees the
// pre-update w; each row's alpha is read once into a register before the
// scatter and written after it, so the scatter uses alpha_old.  Blocks are
// disjoint because each inner iteration's blk_ids is a permutation (Lemma 2),
// so all writes into w_grid / gw_grid rows blk_ids[q] are in place and
// race-free.  Any db works: acc is a (p, db) buffer in device memory, which
// is what news20-like widths (db ~ 339k at p = 4) need; w, gw and acc would
// not fit in 227 KB of shared memory there.
//
// Bound: bytes.  A tile step reads the packed tile once (8 B per slot) and
// a few float vectors; it does ~4 flops per slot, far below the card's
// float32 rate.  The gather of w and the atomics land in L2 (a w block is
// 4*db bytes, 21 KB at real-sim scale), so the design keeps the packed
// stream coalesced (lanes of a warp read consecutive slots of one row) and
// skips atomics on padding slots (val == 0 adds an exact zero).
//
// Arithmetic (dso_common.cuh) follows the reference's order of operations.
// Atomics reorder the scatter's sum from run to run: results agree with the
// plain PyTorch version to 1e-5, not bitwise.
//
// Every entry point has a plain C interface for ctypes and returns
// cudaGetLastError() after its launch.

#include "dso_common.cuh"

namespace {

using namespace dso;

constexpr int WARPS_PER_BLOCK = 8;

// Launch A on the uniform block-ELL grid: one warp per (processor q, row i)
// of row tile [r0, r0 + rb).  cols_g/vals_g (p, p, mb, K); the active tile
// of q is [q, blk_ids[q]], read in place.
__global__ void sparse_dual_scatter_kernel(
    const int* __restrict__ cols_g, const float* __restrict__ vals_g,
    const int* __restrict__ blk_ids, const float* __restrict__ yg,
    const float* __restrict__ w_grid, float* __restrict__ alpha,
    float* __restrict__ ga, const float* __restrict__ trn_g,
    const float* __restrict__ rn_g, float* __restrict__ acc, int p, int mb,
    int K, int db, int r0, int rb, float eta, float m, int loss) {
  long long warp = (long long)blockIdx.x * WARPS_PER_BLOCK + threadIdx.x / 32;
  int lane = threadIdx.x & 31;
  if (warp >= (long long)p * rb) return;   // whole warps leave together
  int q = (int)(warp / rb);
  int i = r0 + (int)(warp % rb);
  int b = blk_ids[q];
  long long tile_row = ((long long)q * p + b) * mb + i;
  const int* c = cols_g + tile_row * K;
  const float* v = vals_g + tile_row * K;
  const float* w = w_grid + (long long)b * db;
  float* acc_q = acc + (long long)q * db;
  long long r = (long long)q * mb + i;
  float a_old = alpha[r];
  float s = 0.0f;
  for (int k = lane; k < K; k += 32) {
    float vk = v[k];
    int ck = c[k];
    s += vk * w[ck];
    if (vk != 0.0f) atomicAdd(acc_q + ck, vk * a_old);
  }
  s = warp_sum(s);
  if (lane == 0)
    dual_step(loss, s, a_old, alpha, ga, r, yg[r],
              trn_g[((long long)q * p + b) * mb + i], rn_g[r], eta, m);
}

// Launch A on the K-bucketed flat chunk view: cols_fl/vals_fl
// (p, n_chunks, mb, 8); the active tile's chunks are lut[q, b, 0..cnt-1]
// with cnt = cnt_g[q, b].  Only the live chunks are read: the dead slots,
// which the TPU kernel zeroes, would add exact zeros.
__global__ void bucketed_dual_scatter_kernel(
    const int* __restrict__ cols_fl, const float* __restrict__ vals_fl,
    const int* __restrict__ lut, const int* __restrict__ cnt_g,
    const int* __restrict__ blk_ids, const float* __restrict__ yg,
    const float* __restrict__ w_grid, float* __restrict__ alpha,
    float* __restrict__ ga, const float* __restrict__ trn_g,
    const float* __restrict__ rn_g, float* __restrict__ acc, int p, int mb,
    int n_chunks, int n_kc, int db, int r0, int rb, float eta, float m,
    int loss) {
  constexpr int KC = 8;
  long long warp = (long long)blockIdx.x * WARPS_PER_BLOCK + threadIdx.x / 32;
  int lane = threadIdx.x & 31;
  if (warp >= (long long)p * rb) return;
  int q = (int)(warp / rb);
  int i = r0 + (int)(warp % rb);
  int b = blk_ids[q];
  const int* lq = lut + ((long long)q * p + b) * n_kc;
  int n_live = cnt_g[q * p + b];
  const float* w = w_grid + (long long)b * db;
  float* acc_q = acc + (long long)q * db;
  long long r = (long long)q * mb + i;
  float a_old = alpha[r];
  float s = 0.0f;
  for (int t = lane; t < n_live * KC; t += 32) {
    long long off = (((long long)q * n_chunks + lq[t / KC]) * mb + i) * KC
                    + (t % KC);
    float vk = vals_fl[off];
    int ck = cols_fl[off];
    s += vk * w[ck];
    if (vk != 0.0f) atomicAdd(acc_q + ck, vk * a_old);
  }
  s = warp_sum(s);
  if (lane == 0)
    dual_step(loss, s, a_old, alpha, ga, r, yg[r],
              trn_g[((long long)q * p + b) * mb + i], rn_g[r], eta, m);
}

// Launch B: primal half of row tile s for every processor, one thread per
// column of the active block; consumes and zeroes acc.
__global__ void primal_update_kernel(
    const int* __restrict__ blk_ids, float* __restrict__ w_grid,
    float* __restrict__ gw_grid, float* __restrict__ acc,
    const float* __restrict__ tcn_g, const float* __restrict__ col_nnz, int p,
    int db, int n_rb, int s, float eta, float lam, float m, float w_lo,
    float w_hi, int reg) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)p * db) return;
  int q = (int)(t / db);
  int j = (int)(t % db);
  int b = blk_ids[q];
  long long col = (long long)b * db + j;
  long long d_pad = (long long)p * db;
  float w = w_grid[col];
  float g_w = lam * reg_grad(reg, w) * tcn_g[((long long)q * n_rb + s) * d_pad
                                             + col]
              / col_nnz[col] - acc[t] / m;
  float gw_new = gw_grid[col] + g_w * g_w;
  float dw = eta * g_w * (1.0f / sqrtf(gw_new + ADA_EPS));
  w_grid[col] = clampf(w - dw, w_lo, w_hi);
  gw_grid[col] = gw_new;
  acc[t] = 0.0f;
}

// Capability probe: a 2-D gather from a small vector at the given indices,
// scatter-added back with atomics — what the block-step kernels need.
__global__ void probe_kernel(const int* __restrict__ cols,
                             const float* __restrict__ w,
                             float* __restrict__ out, int n_idx, int n_w) {
  for (int j = threadIdx.x; j < n_w; j += blockDim.x) out[j] = 0.0f;
  __syncthreads();
  for (int t = threadIdx.x; t < n_idx; t += blockDim.x)
    atomicAdd(out + cols[t], w[cols[t]]);
}

}  // namespace

extern "C" {

int dso_sparse_dual_scatter(const int* cols_g, const float* vals_g,
                            const int* blk_ids, const float* yg,
                            const float* w_grid, float* alpha, float* ga,
                            const float* trn_g, const float* rn_g, float* acc,
                            int p, int mb, int K, int db, int r0, int rb,
                            float eta, float m, int loss, void* stream) {
  long long warps = (long long)p * rb;
  if (warps > 0)
    sparse_dual_scatter_kernel<<<dso::blocks_for(warps, WARPS_PER_BLOCK),
                                 32 * WARPS_PER_BLOCK, 0,
                                 (cudaStream_t)stream>>>(
        cols_g, vals_g, blk_ids, yg, w_grid, alpha, ga, trn_g, rn_g, acc, p,
        mb, K, db, r0, rb, eta, m, loss);
  return (int)cudaGetLastError();
}

int dso_bucketed_dual_scatter(const int* cols_fl, const float* vals_fl,
                              const int* lut, const int* cnt_g,
                              const int* blk_ids, const float* yg,
                              const float* w_grid, float* alpha, float* ga,
                              const float* trn_g, const float* rn_g,
                              float* acc, int p, int mb, int n_chunks,
                              int n_kc, int db, int r0, int rb, float eta,
                              float m, int loss, void* stream) {
  long long warps = (long long)p * rb;
  if (warps > 0)
    bucketed_dual_scatter_kernel<<<dso::blocks_for(warps, WARPS_PER_BLOCK),
                                   32 * WARPS_PER_BLOCK, 0,
                                   (cudaStream_t)stream>>>(
        cols_fl, vals_fl, lut, cnt_g, blk_ids, yg, w_grid, alpha, ga, trn_g,
        rn_g, acc, p, mb, n_chunks, n_kc, db, r0, rb, eta, m, loss);
  return (int)cudaGetLastError();
}

int dso_primal_update(const int* blk_ids, float* w_grid, float* gw_grid,
                      float* acc, const float* tcn_g, const float* col_nnz,
                      int p, int db, int n_rb, int s, float eta, float lam,
                      float m, float w_lo, float w_hi, int reg,
                      void* stream) {
  long long n = (long long)p * db;
  if (n > 0)
    primal_update_kernel<<<dso::blocks_for(n, 256), 256, 0,
                           (cudaStream_t)stream>>>(
        blk_ids, w_grid, gw_grid, acc, tcn_g, col_nnz, p, db, n_rb, s, eta,
        lam, m, w_lo, w_hi, reg);
  return (int)cudaGetLastError();
}

int dso_sparse_probe(const int* cols, const float* w, float* out, int n_idx,
                     int n_w, void* stream) {
  probe_kernel<<<1, 128, 0, (cudaStream_t)stream>>>(cols, w, out, n_idx,
                                                    n_w);
  return (int)cudaGetLastError();
}

}  // extern "C"
