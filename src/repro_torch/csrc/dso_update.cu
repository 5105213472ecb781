// Hand-written Hopper (sm_90a) kernels for the dense DSO tile step: the
// dense launch A.
//
// Replaces the bodies of the reference's Pallas TPU kernels
//   src/repro/kernels/dso_update.py  _fused_block_kernel (:217), launched by
//       dso_block_step_pallas (:354) through _fused_call (pallas_call :274)
//   src/repro/kernels/dso_update.py  _fused_tile_kernel  (:168), launched by
//       dso_tile_step_pallas  (:314) through the same pallas_call
// Both compute one Jacobi tile step per row tile; the block kernel runs
// row_batches of them in order.  On the card they are one function: the
// wrappers (kernels/ops.py dso_block_step, dso_tile_step) launch this
// function and then the shared launch B (primal_update_kernel,
// dso_sparse.cu) once per row tile, all p processors in each launch.
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
// Bound: bytes.  A tile step reads 4*rb*db bytes of X per processor and
// does 4 flops per element (two FMAs), ~1 flop per byte, far below the
// card's float32 rate.  So the design is about keeping X streaming at the
// HBM rate.  Two kernels, chosen by shape in the entry point:
//
// dense_stream_kernel, every dense grid at p = 4 (row stride a multiple of
// 4 floats, db <= 381; svm-ocr's db is 289):
//   * All rows of a block then share one misalignment, mis = (address of
//     the block's first column / 4) mod 4 (b*289 mod 4 at ocr's
//     d = 1,156), so each row's block lies in a 16-byte-aligned span of
//     ns = ceil((mis + db) / 4) slots, its "virtual columns" 0..4 ns - 1,
//     with the block at [mis, mis + db).
//   * A producer warp streams the spans of 16 rows at a time into a ring of
//     3 shared-memory stages with one bulk copy (cp.async.bulk) per row,
//     handed over by mbarriers: ~56 KB of X in flight per CTA and 3 CTAs
//     per SM, held neither in the consumers' registers nor in their load
//     slots.
//   * 8 consumer warps take 2 rows each of a stage: lanes read 16-byte
//     slots from shared memory, mask the head and tail slots to the block,
//     and release the stage before the arithmetic.  The rows' operands of
//     the dual step (alpha, y, the counts, ga) are loaded one stage ahead.
//   * Each lane keeps its slots' X^T alpha partials in registers across ALL
//     of its CTA's rows; they meet in shared memory at the end and go to acc
//     with one global atomicAdd per column per CTA.  w's block is read once
//     per CTA into shared memory.
//   * A row pair's dot products are finished by a halving butterfly (5
//     shuffles): row r's sum lands in lanes 16r..16r+15, and lane 16r
//     takes its dual step.
//   * Each CTA walks row blocks with a grid stride; the grid is what fits
//     on the card at once (the occupancy is worked out once per shared
//     size, not per launch).
//
// dense_general_kernel, the rest (a contiguous M x 1,155 tile, whose row
// stride is not a multiple of 4, or db > 381): the earlier design, kept
// unchanged, whose lanes load their rows themselves with 4-byte loads (no
// alignment needed), 8 rows per warp, one atomicAdd per column per 8 rows
// into a (db,) shared partial (db <= 12,288) or straight into acc in device
// memory (wider).  PERF.md's "earlier" column gives its time at svm-ocr's
// shapes.
//
// Jacobi reads: launch A never writes w; each row's alpha is read by its
// owner lane before its row's X is used and written by the same lane after
// it, so both mat-vecs see the pre-update (w, alpha).  Blocks are disjoint
// because blk_ids is a permutation (Lemma 2).
//
// Reduction order: atomics (shared, then global).  They keep launch B and
// its (p, db) acc contract shared with the sparse kernels; the price is a
// sum order that changes from run to run, so results agree with the plain
// PyTorch version to 1e-5, not bitwise.  Padding rows (X row 0, tile count
// 0, row_nnz 1) and padding columns (X column 0, tile count 0, col_nnz 1)
// add exact zeros and take zero steps, as in the reference.  No tensor core
// and no TF32: the products are fp32 FMAs in the kernels' own bodies.
//
// The entry point has a plain C interface for ctypes and returns
// cudaGetLastError() after its launch.

#include "async_copy.cuh"
#include "dso_common.cuh"

namespace {

using namespace dso;

constexpr unsigned FULL = 0xffffffffu;
constexpr int NW = 8;                   // consumer warps per CTA
constexpr int NT = NW * 32;
constexpr int G = 2;                    // rows a warp carries at a time
constexpr int LANES_PER_ROW = 32 / G;   // lanes a row's X w ends in
constexpr int KS = 3;                   // 16-byte slots per lane in a sweep
constexpr int SWEEP = 32 * KS * 4;      // virtual columns of one sweep
constexpr int STAGE_ROWS = NW * G;      // rows per stage of the ring
constexpr int STAGES = 3;
constexpr int STREAM_CTAS = 3;          // CTAs per SM (<= 72 registers)
constexpr int GEN_ROWS = 8;             // rows a general-kernel warp carries
constexpr int GEN_ROWS_PER_CTA = 512;   // rows one general-kernel CTA covers
constexpr int SMEM_COLS = 12288;        // widest block with a shared partial

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, s))));
}

__device__ __forceinline__ void axpy4(float4& y, float a, float4 x) {
  y.x = fmaf(x.x, a, y.x);
  y.y = fmaf(x.y, a, y.y);
  y.z = fmaf(x.z, a, y.z);
  y.w = fmaf(x.w, a, y.w);
}

// Zero the elements of slot [u0, u0 + 4) outside virtual columns [lo, hi).
__device__ __forceinline__ float4 mask_slot(float4 v, int u0, int lo,
                                            int hi) {
  if (u0 < lo || u0 + 4 > hi) {
    if (u0 < lo || u0 >= hi) v.x = 0.0f;
    if (u0 + 1 < lo || u0 + 1 >= hi) v.y = 0.0f;
    if (u0 + 2 < lo || u0 + 2 >= hi) v.z = 0.0f;
    if (u0 + 3 < lo || u0 + 3 >= hi) v.w = 0.0f;
  }
  return v;
}

// The operands of a row's dual step.
struct RowOps {
  float a = 0.0f, y = 0.0f, trn = 0.0f, rn = 1.0f, ga = 0.0f;
};

// Row i of processor q's row tile (offset from r0).
__device__ __forceinline__ RowOps load_ops(
    const float* alpha, const float* yg, const float* trn_g,
    const float* rn_g, const float* ga, int q, int p, int b, int mb, int r0,
    int i) {
  const long long row = (long long)q * mb + r0 + i;
  RowOps o;
  o.a = alpha[row];
  o.y = yg[row];
  o.trn = trn_g[((long long)q * p + b) * mb + r0 + i];
  o.rn = rn_g[row];
  o.ga = ga[row];
  return o;
}

// The row pair's X w: the halving butterfly over lanes (at lane bit
// 16 >> st the lanes with the bit set keep the upper half of the rows still
// held and pass the lower half), then the dual step of its row by the owner
// lane from the operands it read.
__device__ __forceinline__ void finish_rows(float* xs, int lane, bool owner,
                                            const RowOps& o, int loss,
                                            float eta, float m, float* alpha,
                                            float* ga, long long row) {
#pragma unroll
  for (int st = 0; (G >> st) > 1; ++st) {
    const int half = G >> (st + 1);
    const bool up = lane & (16 >> st);
#pragma unroll
    for (int i = 0; i < half; ++i)
      xs[i] = (up ? xs[i + half] : xs[i]) +
              __shfl_xor_sync(FULL, up ? xs[i] : xs[i + half], 16 >> st);
  }
#pragma unroll
  for (int off = LANES_PER_ROW / 2; off > 0; off >>= 1)
    xs[0] += __shfl_xor_sync(FULL, xs[0], off);
  if (owner) {
    float a_new, ga_new;
    dual_update(loss, xs[0], o.a, o.ga, o.y, o.trn, o.rn, eta, m, a_new,
                ga_new);
    alpha[row] = a_new;
    ga[row] = ga_new;
  }
}

// Launch A on the dense grid.  X row i of processor q starts at
// X + q * proc_stride + i * ld; the active block's columns start b*db
// floats further.  Vectors (p, mb); trn_g (p, p, mb); acc (p, db).
// Requires ld % 4 == 0 and db + 3 <= SWEEP.
__global__ void __launch_bounds__(NT + 32, STREAM_CTAS)
dense_stream_kernel(
    const float* __restrict__ X, long long ld, long long proc_stride,
    const int* __restrict__ blk_ids, const float* __restrict__ yg,
    const float* __restrict__ w_grid, float* __restrict__ alpha,
    float* __restrict__ ga, const float* __restrict__ trn_g,
    const float* __restrict__ rn_g, float* __restrict__ acc, int p, int mb,
    int db, int r0, int rb, float eta, float m, int loss) {
  // shared: w by virtual column (SWEEP floats), the warps' column partials
  // (NW, SWEEP), the ring (STAGES, STAGE_ROWS, ns slots), the barriers
  extern __shared__ float4 smem4[];
  float* sh = reinterpret_cast<float*>(smem4);
  const int q = blockIdx.y;
  const int b = blk_ids[q];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* Xb = X + q * proc_stride + (long long)b * db;
  const int mis = (int)((reinterpret_cast<uintptr_t>(Xb) >> 2) & 3);
  const int hi = mis + db;              // the block's virtual columns
  const int ns = (hi + 3) / 4;          // 16-byte slots of a row's span
  const uint32_t row_bytes = 16u * ns;
  float* part = sh + SWEEP;
  const float4* ring = smem4 + (1 + NW) * (SWEEP / 4);
  const uint32_t full0 = acp::smem_u32(ring + STAGES * STAGE_ROWS * ns);
  const uint32_t empty0 = full0 + 8 * STAGES;
  const float* w = w_grid + (long long)b * db;
  float* acc_q = acc + (long long)q * db;
  for (int u = threadIdx.x; u < SWEEP; u += NT + 32)
    sh[u] = (u >= mis && u < hi) ? w[u - mis] : 0.0f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      acp::mbar_init(full0 + 8 * s, 1);
      acp::mbar_init(empty0 + 8 * s, NW);
    }
    acp::mbar_init_fence();
  }
  __syncthreads();
  const int n_blocks = (rb + STAGE_ROWS - 1) / STAGE_ROWS;

  if (warp == NW) {
    // ---------------------------------------------------- producer --
    if (lane == 0) {
      int t = 0;
      for (int j = blockIdx.x; j < n_blocks; j += gridDim.x, ++t) {
        const int s = t % STAGES;
        acp::mbar_wait(empty0 + 8 * s, ((t / STAGES) & 1) ^ 1);
        const int n_live = min(STAGE_ROWS, rb - j * STAGE_ROWS);
        acp::mbar_expect_tx(full0 + 8 * s, n_live * row_bytes);
        const uint32_t dst = acp::smem_u32(ring + s * STAGE_ROWS * ns);
        for (int r = 0; r < n_live; ++r)
          acp::bulk_copy(dst + r * row_bytes,
                         Xb + (long long)(r0 + j * STAGE_ROWS + r) * ld - mis,
                         row_bytes, full0 + 8 * s);
      }
    }
    return;
  }

  // ----------------------------------------------------- consumers --
  const int my_r = lane / LANES_PER_ROW;  // the row this lane finishes
  const bool lead = lane % LANES_PER_ROW == 0;
  float4 cp[KS];                        // this lane's X^T alpha partials
#pragma unroll
  for (int k = 0; k < KS; ++k) cp[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  RowOps next;                          // operands one stage ahead
  auto fetch = [&](int j) {
    const int i = j * STAGE_ROWS + warp * G + my_r;
    if (lead && j < n_blocks && i < rb)
      next = load_ops(alpha, yg, trn_g, rn_g, ga, q, p, b, mb, r0, i);
  };
  fetch(blockIdx.x);
  int t = 0;
  for (int j = blockIdx.x; j < n_blocks; j += gridDim.x, ++t) {
    const int s = t % STAGES;
    const int i0 = j * STAGE_ROWS + warp * G;    // this warp's rows
    const int n_live = max(0, min(G, rb - i0));  // warp-uniform
    const bool owner = lead && my_r < n_live;
    const RowOps cur = owner ? next : RowOps();
    fetch(j + gridDim.x);
    float a[G], xs[G];
#pragma unroll
    for (int r = 0; r < G; ++r) {
      a[r] = __shfl_sync(FULL, cur.a, LANES_PER_ROW * r);
      xs[r] = 0.0f;
    }
    acp::mbar_wait(full0 + 8 * s, (t / STAGES) & 1);
    const float4* rows = ring + (s * STAGE_ROWS + warp * G) * ns;
    float4 x[G][KS];
#pragma unroll
    for (int r = 0; r < G; ++r)
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const int slot = lane + 32 * k;
        x[r][k] = r < n_live && slot < ns
                      ? mask_slot(rows[r * ns + slot], 4 * slot, mis, hi)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    __syncwarp();
    if (lane == 0) acp::mbar_arrive(empty0 + 8 * s);  // stage read
    const float4* w4 = smem4;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const float4 wk = w4[lane + 32 * k];
#pragma unroll
      for (int r = 0; r < G; ++r) {
        xs[r] = dot4(x[r][k], wk, xs[r]);
        axpy4(cp[k], a[r], x[r][k]);
      }
    }
    finish_rows(xs, lane, owner, cur, loss, eta, m, alpha, ga,
                (long long)q * mb + r0 + i0 + my_r);
  }

  // the CTA's column partials, once (a named barrier of the consumers: the
  // producer warp has left)
#pragma unroll
  for (int k = 0; k < KS; ++k)
    reinterpret_cast<float4*>(part + warp * SWEEP)[lane + 32 * k] = cp[k];
  asm volatile("bar.sync 1, %0;\n" :: "n"(NT) : "memory");
  for (int u = threadIdx.x; u < SWEEP; u += NT) {
    float v = 0.0f;
#pragma unroll
    for (int wi = 0; wi < NW; ++wi) v += part[wi * SWEEP + u];
    const int col = u - mis;
    if (col >= 0 && col < db && v != 0.0f) atomicAdd(acc_q + col, v);
  }
}

// The same launch A for any (ld, db), with 4-byte loads, which need no
// alignment: one CTA of 8 warps per (chunk of 512 rows, processor q).  A
// warp carries 8 rows at a time through one sweep of the block's columns;
// lane l reads column j = l, l + 32, ... of all 8 rows (32 consecutive
// floats of one row per load, 8 loads in flight per lane).  The 8 row dot
// products stay in registers and are finished by a butterfly of shuffles;
// the 8 rows' X^T alpha partial of column j is summed in a register and
// added into the (db,) column partial: in shared memory, flushed with one
// global atomicAdd per column per CTA (SMEM_ACC, db <= 12,288), or
// straight into acc in device memory (wider).
template <bool SMEM_ACC>
__global__ void __launch_bounds__(NT)
dense_general_kernel(
    const float* __restrict__ X, long long ld, long long proc_stride,
    const int* __restrict__ blk_ids, const float* __restrict__ yg,
    const float* __restrict__ w_grid, float* __restrict__ alpha,
    float* __restrict__ ga, const float* __restrict__ trn_g,
    const float* __restrict__ rn_g, float* __restrict__ acc, int p, int mb,
    int db, int r0, int rb, float eta, float m, int loss) {
  extern __shared__ float col_part[];   // (db,) when SMEM_ACC
  const int q = blockIdx.y;
  const int b = blk_ids[q];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* Xq = X + q * proc_stride + (long long)b * db;
  const float* w = w_grid + (long long)b * db;
  float* acc_q = acc + (long long)q * db;
  float* cacc = SMEM_ACC ? col_part : acc_q;
  if (SMEM_ACC) {
    for (int j = threadIdx.x; j < db; j += NT) col_part[j] = 0.0f;
    __syncthreads();
  }
  const int lo = blockIdx.x * GEN_ROWS_PER_CTA;  // offsets in the tile
  const int hi = min(lo + GEN_ROWS_PER_CTA, rb);
  for (int g = lo + warp * GEN_ROWS; g < hi; g += NW * GEN_ROWS) {
    const int n_live = min(GEN_ROWS, hi - g);   // warp-uniform
    const long long row0 = (long long)q * mb + r0 + g;
    const float a_mine = (lane < n_live) ? alpha[row0 + lane] : 0.0f;
    float a[GEN_ROWS], xs[GEN_ROWS];
#pragma unroll
    for (int r = 0; r < GEN_ROWS; ++r) {
      a[r] = __shfl_sync(FULL, a_mine, r);
      xs[r] = 0.0f;
    }
    const float* x0 = Xq + (long long)(r0 + g) * ld;
    for (int j = lane; j < db; j += 32) {
      const float wj = __ldg(w + j);
      float cj = 0.0f;
#pragma unroll
      for (int r = 0; r < GEN_ROWS; ++r) {
        if (r < n_live) {
          const float x = __ldg(x0 + r * ld + j);
          xs[r] = fmaf(x, wj, xs[r]);
          cj = fmaf(x, a[r], cj);
        }
      }
      if (cj != 0.0f) atomicAdd(cacc + j, cj);
    }
    float xw = 0.0f;                            // lane r keeps row r's
#pragma unroll
    for (int r = 0; r < GEN_ROWS; ++r) {
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
    for (int j = threadIdx.x; j < db; j += NT) {
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
  if (p <= 0 || rb <= 0 || db <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (ld % 4 == 0 && db + 3 <= SWEEP) {
    const int ns_max = (db + 6) / 4;    // slots of a span at mis = 3
    const size_t smem = (size_t)(1 + NW) * SWEEP * sizeof(float) +
                        (size_t)STAGES * STAGE_ROWS * ns_max * 16 +
                        16 * STAGES;
    int per_sm = 0;
    const cudaError_t e =
        ctas_per_sm<dense_stream_kernel>(NT + 32, smem, &per_sm);
    if (e != cudaSuccess) return (int)e;
    // as many CTAs as fit on the card at once, no more than row blocks
    const long long need = blocks_for(rb, STAGE_ROWS);
    long long fit = (long long)per_sm * sm_count() / p;
    if (fit < 1) fit = 1;
    const dim3 grid((unsigned)(need < fit ? need : fit), p);
    dense_stream_kernel<<<grid, NT + 32, smem, st>>>(
        X, ld, proc_stride, blk_ids, yg, w_grid, alpha, ga, trn_g, rn_g, acc,
        p, mb, db, r0, rb, eta, m, loss);
  } else {
    const dim3 grid(blocks_for(rb, GEN_ROWS_PER_CTA), p);
    if (db <= SMEM_COLS)
      dense_general_kernel<true><<<grid, NT, db * sizeof(float), st>>>(
          X, ld, proc_stride, blk_ids, yg, w_grid, alpha, ga, trn_g, rn_g,
          acc, p, mb, db, r0, rb, eta, m, loss);
    else
      dense_general_kernel<false><<<grid, NT, 0, st>>>(
          X, ld, proc_stride, blk_ids, yg, w_grid, alpha, ga, trn_g, rn_g,
          acc, p, mb, db, r0, rb, eta, m, loss);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
