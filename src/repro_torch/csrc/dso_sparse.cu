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
// one launch, and the cross-row reduction X^T alpha goes through a (p, db)
// accumulator acc in device memory.  One row tile s of all p processors is
// ONE cooperative launch (sparse_step_kernel<LAYOUT, true>) in two phases
// split by a grid-wide barrier, as the TPU kernel does the primal step in
// the same kernel as the dual step:
//
//   rows:    a group of 8, 16 or 32 lanes per row
//       xw      = sum_k vals * w[blk][cols]        (gather, pre-update w)
//       acc[q] += vals * alpha_old  at cols         (atomicAdd scatter)
//       alpha, ga <- dual Eq.-8 AdaGrad step + App.-B projection
//   cooperative_groups::this_grid().sync()
//   columns: every CTA a slice of the p x db columns
//       w[blk], gw[blk] <- primal Eq.-8 step from acc[q]; acc[q] = 0
//
// The barrier is the CUDA runtime's cooperative launch: a grid the card
// cannot hold resident is refused at launch (the entry returns the error),
// never left to hang.  Every CTA reaches it, those past the processor split
// and the lanes with no row included.  The primal phase skips a column
// whose count tcn in the row tile is 0: no row of the tile holds it, so the
// rows phase left its acc at 0 and its step is g_w = 0, which leaves w
// (inside its box, as every state of the engine is) and gw bit for bit
// unchanged (dso_common.cuh primal_update); it writes nothing there.  Past
// one column a thread, it reads nothing else of a skipped column either:
// 4 bytes per column and 28 more per live one (at news20's shape 5.9 % of
// the columns are live).  With one column a thread (db 5,240) it reads the
// operands with the count, which saves a round trip.  The separate launch
// B (primal_update_kernel, one thread per column, no skip) stays for the
// dense steps and the baselines: it takes any acc, so it computes every
// column.
//
// Jacobi reads: the rows phase never writes w, so every gather sees the
// pre-update w; each row's alpha is read once into a register before the
// scatter and written after it, so the scatter uses alpha_old.  Blocks are
// disjoint because each inner iteration's blk_ids is a permutation (Lemma 2),
// so all writes into w_grid / gw_grid rows blk_ids[q] are in place and
// race-free.  Any db works: acc is a (p, db) buffer in device memory, which
// is what news20-like widths (db ~ 339k at p = 4) need; w, gw and acc would
// not fit in 227 KB of shared memory there.
//
// One body, three layouts (sparse_step_kernel<LAYOUT, FOLD>; FOLD = false
// is launch A alone, which the baselines and the benchmarks time):
//
// ELL, the uniform block-ELL grid (row 1).  Rows are packed from slot 0, so
// a row's live slots are [0, trn) with trn = tile_row_nnz_g[q, b, i]; the
// rest is padding (col 0, val 0).  Only live slots are gathered and
// scattered: ~12.7 of K = 32 at svm-real-sim.  A row's trn, alpha and dual
// operands are loaded together with its first two passes of slots (a pass
// is the group's slots, loaded whether live or not), so a row costs two
// dependent round trips (slots, then w) and a third only past two passes
// (trn > 2 G).  The group: 8 lanes up to K = 32, 16 past it, so a warp
// walks 4 rows at once at svm-real-sim; and each group starts the next
// row's loads before it uses the current row's gather, so two rows are in
// flight per group.  Atomics go straight into acc[q], with no sums in
// shared memory first: the columns are uniform, and that does not pay
// there (the shared route on a uniform grid: 0.0358 against 0.0364 ms).
// But the atomics on one column serialize in L2 (without them launch A
// takes ~30 % less: python -m repro_torch.bench.fold), so acc holds
// several copies of the (p, db) sums (kernels/dso_sparse.py
// ELL_ACC_COPIES): CTA x adds into copy x mod copies, and the primal phase
// sums and zeroes them.
//
// SHARED and HOT, the K-bucketed flat chunk view (row 2; kernels/
// dso_sparse.py bucketed_route picks by db and the card's shared-memory
// limit; the global route, bucketed_dual_scatter_kernel, is reached only
// by asking for it).  On power-law data a few columns lie in almost every
// row, so one global atomicAdd per nonzero (the global route) sends ~mb
// atomics to each hot address of acc, which serialize in L2.  The "shared"
// route gives each CTA one processor and a contiguous range of its rows: it
// sums X^T alpha_old in a db-wide float32 accumulator in shared memory, so
// the hot columns meet in shared atomics contended only inside one SM, and
// then adds each nonzero entry to acc[q] with one global atomic: at most
// one per (CTA, column).  Each row is a chain of dependent loads (lut,
// slots, w) and a dual step, so the launch is bound by latency more than by
// bytes: a group of 8, 16 or 32 lanes (the fewest that cover the tile's
// live slots) takes one row, and the grid, sized from the SM count, is
// split among the processors by the chains their rows cost (the processor
// holding the popular block has 5 live chunks per row at logistic-real-sim,
// the others 1).  ELL's grid is split the same way, evenly.
//
// The "hot" route takes blocks past the shared budget (db > 58,112 on an
// H100: news20's 338,798, kdda's width).  Its CTAs sum only the block's
// n_slots hottest columns (largest col_nnz, ties by column index) in shared
// memory: a table built once per grid on the device (kernels/dso_sparse.py
// hot_table) maps each column of block b to its slot, hot[b * db + col], or
// -1; a slot's column is hot_cols[b * n_slots + slot].  A nonzero of a hot
// column takes a shared atomic, any other a direct global atomic (cold
// columns are spread, so their atomics meet little contention); the CTA
// ends with one global atomic per nonzero slot.  On power-law columns the
// hottest ~10 K columns of a block carry most of its nonzeros (~90 % at
// news20's shape), wherever they lie in the block.  n_slots: the float32
// sums that fit the SM's shared memory split kernels/dso_sparse.py
// HOT_SMEM_SHARE ways (dso_bucketed_hot_slots), chosen by measurement:
// every slot is zeroed and read once per CTA, so fewer slots cost less
// until too many columns go to global atomics.
//
// Bound: bytes.  A tile step reads the live packed slots once (8 B per
// slot) and a few float vectors; it does ~4 flops per slot, far below the
// card's float32 rate.  The gather of w and the atomics land in L2 (a w
// block is 4*db bytes, 21 KB at real-sim scale), so the design keeps the
// packed stream coalesced (lanes of a group read consecutive slots of one
// row) and skips atomics on zero values (they add an exact zero).
//
// Arithmetic (dso_common.cuh) follows the reference's order of operations.
// Atomics reorder the scatter's sum from run to run: results agree with the
// plain PyTorch version to 1e-5, not bitwise.
//
// Every entry point has a plain C interface for ctypes and returns
// cudaGetLastError() after its launch, or the launch's own error.

#include <climits>
#include <cooperative_groups.h>

#include "dso_common.cuh"

namespace {

using namespace dso;
namespace cg = cooperative_groups;

constexpr int WARPS_PER_BLOCK = 8;

// The first launch A on the uniform block-ELL grid, kept as the baseline of
// sparse_step_kernel<ELL, *> (dso_sparse_dual_scatter; no wrapper takes
// it): one warp per (processor q, row i) of row tile [r0, r0 + rb), all K
// slots of the row read.  cols_g/vals_g (p, p, mb, K); the active tile of
// q is [q, blk_ids[q]], read in place.
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

// Launch A on the K-bucketed flat chunk view, the global route: one warp
// per row, one global atomic per nonzero.  cols_fl/vals_fl
// (p, n_chunks, mb, 8); the active tile's chunks are lut[q, b, 0..cnt-1]
// with cnt = cnt_g[q, b].  Only the live chunks are read: the dead slots,
// which the TPU kernel zeroes, would add exact zeros.  bucketed_route
// never picks it: it runs only when asked for by name, as the baseline the
// hot route is timed against.
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

constexpr int SH_WARPS = 16;             // warps per CTA, sparse_step_kernel
constexpr int KC = 8;                    // slots per chunk of the flat view
constexpr int FLUSH = 8;                 // hot slots a thread ends at once
constexpr int PASSES = 2;                // passes over a row loaded at once
constexpr int HOT_MAX_SHARE = 8;         // most ways the SM's sums split
constexpr int PRIMAL_LOADS = 16;         // column counts loaded at once
constexpr int MAX_COPIES = 8;            // most copies of ELL's sums

// The layouts of sparse_step_kernel: the uniform block-ELL grid, and the
// K-bucketed flat chunk view summed in shared memory (every column, or the
// hottest ones).
enum Layout { ELL = 0, SHARED = 1, HOT = 2 };

// CTAs per SM the registers leave room for: 64 registers a thread.  Capping
// them for 3 spills in every layout's folded kernel and was measured slower
// (python -m repro_torch.bench.fold, python -m repro_torch.bench.hot_route).
constexpr int CTAS_PER_SM = 2;

// Everything one row tile of sparse_step_kernel reads and writes.  ELL:
// cols/vals (p, p, mb, K).  SHARED, HOT: cols/vals (p, n_chunks, mb, KC),
// lut (p, p, n_kc), cnt_g (p, p); n_slots shared-memory sums per CTA (db
// for SHARED); HOT also its table hot (p, db), hot_cols (p, n_slots).  acc
// holds `copies` copies of the (p, db) sums (ELL; 1 for the bucketed
// layouts): CTA x adds into copy x mod copies, and X^T alpha is their sum.
// The primal phase's operands (gw_grid, tcn_g (p, n_rb, p * db), col_nnz,
// lam, w_lo, w_hi, reg, s) are read only when FOLD.
struct StepArgs {
  const int* cols;
  const float* vals;
  const int* lut;
  const int* cnt_g;
  const int* hot;
  const int* hot_cols;
  const int* blk_ids;
  const float* yg;
  float* w_grid;
  float* gw_grid;
  float* alpha;
  float* ga;
  const float* trn_g;
  const float* rn_g;
  const float* tcn_g;
  const float* col_nnz;
  float* acc;
  int K, n_chunks, n_kc, n_slots, copies;
  int p, mb, db, n_rb, s, r0, rb;
  float eta, lam, m, w_lo, w_hi;
  int loss, reg;
};

// Lanes per row of the bucketed layouts for a tile of n_live live chunks:
// the fewest of 8, 16 or 32 that cover its slots, so a warp walks 32 / G
// rows at once where rows are short.
__device__ __forceinline__ int shared_group(int n_live) {
  const int slots = n_live * KC;
  return slots <= 8 ? 8 : (slots <= 16 ? 16 : 32);
}

// Lanes per row of the ELL layout: 8 for rows of up to 32 slots (K is the
// grid's widest row; most rows hold far fewer), 16 past them; a group
// loads two passes of its row with the row's operands.
__device__ __forceinline__ int ell_group(int K) { return K <= 32 ? 8 : 16; }

// A processor's share of a bucketed grid: each row is a chain of dependent
// loads (lut, slots, w) then a reduction and the dual step, so a row costs
// about (its passes over the slots + 1) chains, and a warp runs 32 / G rows
// side by side.  Weight = (passes + 1) * G.  ELL's tiles all have K slots
// per row: equal weights.
template <int LAYOUT>
__device__ __forceinline__ long long proc_weight(const StepArgs& a, int q) {
  if constexpr (LAYOUT == ELL) {
    return 1;
  } else {
    const int n_live = __ldg(a.cnt_g + q * a.p + __ldg(a.blk_ids + q));
    const int g = shared_group(n_live);
    return (long long)((n_live * KC + g - 1) / g + 1) * g;
  }
}

// Offset of slot t of row i of processor q's active tile (tile = q * p + b;
// lq its lut row for the bucketed layouts).
template <int LAYOUT>
__device__ __forceinline__ long long slot_offset(const StepArgs& a, int q,
                                                 long long tile,
                                                 const int* lq, int i,
                                                 int t) {
  if constexpr (LAYOUT == ELL)
    return (tile * a.mb + i) * a.K + t;
  else
    return (((long long)q * a.n_chunks + __ldg(lq + t / KC)) * a.mb + i) *
               KC + (t % KC);
}

// One row's dual operands (the group's lane 0 holds y, rn and ga_old; ELL
// gives trn to every lane, which bounds its slots) and the lane's slots of
// the row's first H passes.
template <int H>
struct Row {
  float a_old, y, trn, rn, ga_old;
  float vk[H];
  int ck[H];
};

// Load row i of processor q (nothing when !live; zeros then).  head: the
// slots the first H passes may touch (ELL: K, all loaded whether live or
// not, so that no load waits for trn; bucketed: the tile's live slots).
template <int LAYOUT, int H>
__device__ __forceinline__ void load_row(const StepArgs& a, Row<H>& row,
                                         int q, long long tile,
                                         const int* lq, int head, int i,
                                         bool live, int gl, int g) {
  row.a_old = row.y = row.trn = row.rn = row.ga_old = 0.0f;
#pragma unroll
  for (int u = 0; u < H; ++u) {
    row.vk[u] = 0.0f;                  // past the row: adds an exact zero
    row.ck[u] = 0;
  }
  if (!live) return;
  const long long r = (long long)q * a.mb + i;
  row.a_old = a.alpha[r];
  if (LAYOUT == ELL || gl == 0) row.trn = __ldg(a.trn_g + tile * a.mb + i);
  if (gl == 0) {
    row.y = __ldg(a.yg + r);
    row.rn = __ldg(a.rn_g + r);
    row.ga_old = a.ga[r];
  }
#pragma unroll
  for (int u = 0; u < H; ++u) {
    const int t = gl + u * g;
    if (t < head) {
      const long long off = slot_offset<LAYOUT>(a, q, tile, lq, i, t);
      row.vk[u] = __ldg(a.vals + off);
      row.ck[u] = __ldg(a.cols + off);
    }
  }
}

// Add v * alpha_old of one nonzero into X^T alpha: shared sums by column
// (SHARED) or by hot slot, else straight into acc[q] (HOT), or straight
// into acc[q] (ELL).
template <int LAYOUT>
__device__ __forceinline__ void scatter(float* acc_s, float* acc_q, int slot,
                                        int col, float v) {
  if constexpr (LAYOUT == HOT) {
    if (slot >= 0)
      atomicAdd(acc_s + slot, v);
    else
      atomicAdd(acc_q + col, v);
  } else if constexpr (LAYOUT == SHARED) {
    atomicAdd(acc_s + col, v);
  } else {
    atomicAdd(acc_q + col, v);
  }
}

// Rows [lo, hi) of processor q's active tile: a group of g lanes per row,
// the gather of the pre-update w, the scatter of X^T alpha_old, the dual
// step; the bucketed layouts zero their shared sums first and add them
// into acc[q] last.  ELL starts the next row's loads before it uses the
// current row's gather (two rows in flight per group); every layout loads
// the first H = PASSES passes of a row with its operands.
template <int LAYOUT>
__device__ __forceinline__ void step_rows(const StepArgs& a, float* acc_s,
                                          int q, int lo, int hi) {
  constexpr int H = PASSES;
  constexpr bool PIPE = LAYOUT == ELL;
  if constexpr (LAYOUT != ELL) {
    for (int c = threadIdx.x; c < a.n_slots; c += blockDim.x) acc_s[c] = 0.0f;
    __syncthreads();
  }
  const int b = __ldg(a.blk_ids + q);
  const long long tile = (long long)q * a.p + b;
  const int* lq = LAYOUT == ELL ? nullptr : a.lut + tile * a.n_kc;
  const int n_live = LAYOUT == ELL ? 0 : __ldg(a.cnt_g + tile);
  const int head = LAYOUT == ELL ? a.K : n_live * KC;
  const float* w = a.w_grid + (long long)b * a.db;
  const int* hot_b = LAYOUT == HOT ? a.hot + (long long)b * a.db : nullptr;
  float* acc_q =
      a.acc + ((long long)(blockIdx.x % a.copies) * a.p + q) * a.db;
  const int g = LAYOUT == ELL ? ell_group(a.K) : shared_group(n_live);
  const int per_warp = 32 / g;
  const int lane = threadIdx.x & 31;
  const int gl = lane % g;             // lane within the row's group
  const int step = SH_WARPS * per_warp;
  int i0 = lo + (int)threadIdx.x / 32 * per_warp;
  Row<H> cur;
  load_row<LAYOUT>(a, cur, q, tile, lq, head, i0 + lane / g,
                   i0 + lane / g < hi, gl, g);
  for (; i0 < hi; i0 += step) {        // the same trips for a whole warp
    const int i = i0 + lane / g;
    const bool live = i < hi;
    // the row's slots: ELL its live ones, [0, trn); bucketed the tile's
    int n = 0;
    if (live) n = LAYOUT == ELL ? min((int)cur.trn, a.K) : head;
    float wk[H];
    int slot[H];
#pragma unroll
    for (int u = 0; u < H; ++u) {
      const bool in = gl + u * g < n;
      wk[u] = in ? __ldg(w + cur.ck[u]) : 0.0f;
      slot[u] = LAYOUT == HOT && in ? __ldg(hot_b + cur.ck[u]) : -1;
    }
    Row<H> nxt;
    if constexpr (PIPE)
      load_row<LAYOUT>(a, nxt, q, tile, lq, head, i + step, i + step < hi,
                       gl, g);
    float s = 0.0f;
#pragma unroll
    for (int u = 0; u < H; ++u) {
      if (gl + u * g < n) {
        s += cur.vk[u] * wk[u];
        if (cur.vk[u] != 0.0f)
          scatter<LAYOUT>(acc_s, acc_q, slot[u], cur.ck[u],
                          cur.vk[u] * cur.a_old);
      }
    }
    for (int t0 = H * g + gl; t0 < n; t0 += PASSES * g) {   // past the head
      float vk[PASSES], wt[PASSES];
      int ck[PASSES], st[PASSES];
#pragma unroll
      for (int u = 0; u < PASSES; ++u) {
        const int t = t0 + u * g;
        vk[u] = 0.0f;
        ck[u] = 0;
        if (t < n) {
          const long long off = slot_offset<LAYOUT>(a, q, tile, lq, i, t);
          vk[u] = __ldg(a.vals + off);
          ck[u] = __ldg(a.cols + off);
        }
      }
#pragma unroll
      for (int u = 0; u < PASSES; ++u) {
        const bool in = t0 + u * g < n;
        wt[u] = in ? __ldg(w + ck[u]) : 0.0f;
        st[u] = LAYOUT == HOT && in ? __ldg(hot_b + ck[u]) : -1;
      }
#pragma unroll
      for (int u = 0; u < PASSES; ++u) {
        if (t0 + u * g < n) {
          s += vk[u] * wt[u];
          if (vk[u] != 0.0f)
            scatter<LAYOUT>(acc_s, acc_q, st[u], ck[u], vk[u] * cur.a_old);
        }
      }
    }
    for (int off = g / 2; off > 0; off >>= 1)   // every lane takes part
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (live && gl == 0) {
      float a_new, ga_new;
      dual_update(a.loss, s, cur.a_old, cur.ga_old, cur.y, cur.trn, cur.rn,
                  a.eta, a.m, a_new, ga_new);
      const long long r = (long long)q * a.mb + i;
      a.alpha[r] = a_new;
      a.ga[r] = ga_new;
    }
    if constexpr (PIPE)
      cur = nxt;
    else
      load_row<LAYOUT>(a, cur, q, tile, lq, head, i + step, i + step < hi,
                       gl, g);
  }
  if constexpr (LAYOUT == ELL) return;
  __syncthreads();
  if constexpr (LAYOUT == HOT) {
    // FLUSH slots a thread at a time: the columns of the nonzero ones are
    // loaded together, so the loads of hot_cols overlap instead of
    // queueing behind each other
    const int* cols_b = a.hot_cols + (long long)b * a.n_slots;
    for (int c0 = threadIdx.x; c0 < a.n_slots; c0 += FLUSH * blockDim.x) {
      float v[FLUSH];
      int col[FLUSH];
#pragma unroll
      for (int u = 0; u < FLUSH; ++u) {
        const int c = c0 + u * blockDim.x;
        v[u] = c < a.n_slots ? acc_s[c] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < FLUSH; ++u)
        col[u] = v[u] != 0.0f ? __ldg(cols_b + c0 + u * blockDim.x) : 0;
#pragma unroll
      for (int u = 0; u < FLUSH; ++u)
        if (v[u] != 0.0f) atomicAdd(acc_q + col[u], v[u]);
    }
  } else {
    for (int c = threadIdx.x; c < a.n_slots; c += blockDim.x) {
      const float v = acc_s[c];
      if (v != 0.0f) atomicAdd(acc_q + c, v);
    }
  }
}

// Column t = q * db + j of the primal phase: column b * db + j of w_grid
// (b = blk_ids[q]) and its count in row tile s of tile (q, b).
__device__ __forceinline__ long long primal_column(const StepArgs& a,
                                                   long long t, float& tcn) {
  const int q = (int)((unsigned)t / (unsigned)a.db);   // t < p * db <= INT_MAX
  const long long col =
      (long long)__ldg(a.blk_ids + q) * a.db + (t - (long long)q * a.db);
  tcn = __ldg(a.tcn_g + ((long long)q * a.n_rb + a.s) * a.p * a.db + col);
  return col;
}

// The primal step of column t (w_grid column col, count tcn) from its
// operands (acc summed over the copies, which it zeroes), read together.
__device__ __forceinline__ void primal_step(const StepArgs& a, long long t,
                                            long long col, float tcn) {
  const long long n = (long long)a.p * a.db;
  float part[MAX_COPIES];
#pragma unroll
  for (int c = 0; c < MAX_COPIES; ++c)
    part[c] = c < a.copies ? a.acc[c * n + t] : 0.0f;
  const float w = a.w_grid[col], gw = a.gw_grid[col];
  const float cn = __ldg(a.col_nnz + col);
  if (tcn == 0.0f) return;             // read ahead of its count: skipped
  float acc = part[0];
#pragma unroll
  for (int c = 1; c < MAX_COPIES; ++c)
    if (c < a.copies) acc += part[c];
  float w_new, gw_new;
  primal_update(a.reg, w, gw, tcn, cn, acc, a.eta, a.lam, a.m, a.w_lo,
                a.w_hi, w_new, gw_new);
  a.w_grid[col] = w_new;
  a.gw_grid[col] = gw_new;
#pragma unroll
  for (int c = 0; c < MAX_COPIES; ++c)
    if (c < a.copies) a.acc[c * n + t] = 0.0f;
}

// The primal phase of row tile s over all p x db columns, the grid's
// threads striding over them.  Where a thread has at most one column
// (p * db no more than the grid's threads: svm-real-sim, logistic-real-
// sim), it reads the column's operands together with its count, one round
// trip, and steps it when the count is not 0.  Else a thread loads the
// counts of PRIMAL_LOADS of its columns at once (at news20's shape every
// column a thread has) and keeps which are live, then reads and steps the
// live ones.  A column with tcn = 0 writes nothing, and past one column a
// thread reads nothing else of it either.
__device__ __forceinline__ void primal_phase(const StepArgs& a) {
  const long long n = (long long)a.p * a.db;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n <= stride) {
    if (first < n) {
      float tcn;
      const long long col = primal_column(a, first, tcn);
      primal_step(a, first, col, tcn);
    }
    return;
  }
  for (long long t0 = first; t0 < n; t0 += PRIMAL_LOADS * stride) {
    unsigned live = 0;
#pragma unroll
    for (int u = 0; u < PRIMAL_LOADS; ++u) {
      float tcn = 0.0f;
      if (t0 + u * stride < n) primal_column(a, t0 + u * stride, tcn);
      if (tcn != 0.0f) live |= 1u << u;
    }
    while (live != 0) {
      const long long t = t0 + (__ffs(live) - 1) * stride;
      live &= live - 1;
      float tcn;
      const long long col = primal_column(a, t, tcn);   // its count again
      primal_step(a, t, col, tcn);
    }
  }
}

// The sparse block step's kernel, one row tile of all p processors.  CTA x
// works for processor q on rows [lo, hi) of row tile [r0, r0 + rb): every
// CTA derives the same split from the weights (proc_weight).  Processor q
// takes 1 + (G - p) * w_q / W of the G CTAs (W the weights' sum); the host
// makes G >= p; CTAs past the split have no rows.  acc_s: the CTA's
// n_slots float32 sums (dynamic shared memory; none for ELL).  FOLD: the
// launch is cooperative, and after the rows every CTA meets at the grid's
// barrier and takes its slice of the primal phase.
template <int LAYOUT, bool FOLD>
__global__ void __launch_bounds__(32 * SH_WARPS, CTAS_PER_SM)
sparse_step_kernel(const StepArgs a) {
  extern __shared__ float acc_s[];
  long long wsum = 0;
  for (int q = 0; q < a.p; ++q) wsum += proc_weight<LAYOUT>(a, q);
  const long long spare = (long long)gridDim.x - a.p;
  int q = 0, first = 0, n_q = 0;
  for (; q < a.p; ++q) {
    n_q = 1 + (int)(spare * proc_weight<LAYOUT>(a, q) / wsum);
    if ((int)blockIdx.x < first + n_q) break;
    first += n_q;
  }
  if (q < a.p) {                       // a whole CTA takes this branch
    const int j = blockIdx.x - first;
    const int lo = a.r0 + (int)((long long)a.rb * j / n_q);
    const int hi = a.r0 + (int)((long long)a.rb * (j + 1) / n_q);
    step_rows<LAYOUT>(a, acc_s, q, lo, hi);
  }
  if constexpr (FOLD) {
    cg::this_grid().sync();
    primal_phase(a);
  }
}

// Launch sparse_step_kernel<LAYOUT, FOLD> on a.n_slots float32 sums of
// shared memory per CTA (none for ELL): as many CTAs as fit on the card at
// once, at least one per processor, and no more than a warp per row (FOLD:
// or than a thread per column).  FOLD launches cooperatively: a grid the
// card cannot hold resident is refused, and that error is returned.
template <int LAYOUT, bool FOLD>
int launch_step(const StepArgs& a, cudaStream_t stream) {
  if (a.p <= 0 || a.db <= 0 || (!FOLD && a.rb <= 0))
    return (int)cudaGetLastError();
  if ((long long)a.p * a.db > INT_MAX || a.copies < 1 ||
      a.copies > MAX_COPIES)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      LAYOUT == ELL ? 0 : (size_t)a.n_slots * sizeof(float);
  int per_sm = 0;
  cudaError_t e = dso::ctas_per_sm<sparse_step_kernel<LAYOUT, FOLD>>(
      32 * SH_WARPS, smem, &per_sm);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long grid = (long long)per_sm * dso::sm_count();
  long long most = (long long)a.p * dso::blocks_for(a.rb, SH_WARPS);
  const long long cols =
      dso::blocks_for((long long)a.p * a.db, 32 * SH_WARPS);
  if (FOLD && most < cols) most = cols;
  if (grid > most) grid = most;
  if (grid < a.p) grid = a.p;
  if constexpr (FOLD) {
    void* args[] = {const_cast<StepArgs*>(&a)};
    e = cudaLaunchCooperativeKernel(
        (const void*)sparse_step_kernel<LAYOUT, FOLD>, dim3((unsigned)grid),
        dim3(32 * SH_WARPS), args, smem, stream);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return (int)e;
    }
  } else {
    sparse_step_kernel<LAYOUT, FOLD>
        <<<(unsigned)grid, 32 * SH_WARPS, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// StepArgs of launch A alone (FOLD = false: no primal operands).
StepArgs dual_args(const int* cols, const float* vals, const int* blk_ids,
                   const float* yg, const float* w_grid, float* alpha,
                   float* ga, const float* trn_g, const float* rn_g,
                   float* acc, int p, int mb, int db, int r0, int rb,
                   float eta, float m, int loss) {
  StepArgs a{};
  a.cols = cols;
  a.vals = vals;
  a.blk_ids = blk_ids;
  a.yg = yg;
  a.w_grid = const_cast<float*>(w_grid);   // only read without FOLD
  a.alpha = alpha;
  a.ga = ga;
  a.trn_g = trn_g;
  a.rn_g = rn_g;
  a.acc = acc;
  a.p = p;
  a.mb = mb;
  a.db = db;
  a.r0 = r0;
  a.rb = rb;
  a.eta = eta;
  a.m = m;
  a.loss = loss;
  a.copies = 1;
  return a;
}

// The primal operands of a folded step added to launch A's.
StepArgs fold_args(StepArgs a, float* gw_grid, const float* tcn_g,
                   const float* col_nnz, int n_rb, int s, float lam,
                   float w_lo, float w_hi, int reg) {
  a.gw_grid = gw_grid;
  a.tcn_g = tcn_g;
  a.col_nnz = col_nnz;
  a.n_rb = n_rb;
  a.s = s;
  a.lam = lam;
  a.w_lo = w_lo;
  a.w_hi = w_hi;
  a.reg = reg;
  return a;
}

// The bucketed layouts' own fields.
StepArgs bucketed(StepArgs a, const int* lut, const int* cnt_g, int n_chunks,
                  int n_kc, const int* hot, const int* hot_cols,
                  int n_slots) {
  a.lut = lut;
  a.cnt_g = cnt_g;
  a.n_chunks = n_chunks;
  a.n_kc = n_kc;
  a.hot = hot;
  a.hot_cols = hot_cols;
  a.n_slots = n_slots;
  return a;
}

// Launch B: primal half of row tile s for every processor, one thread per
// column of the active block; consumes and zeroes acc.  It takes any acc,
// so it computes every column (the folded step's primal phase skips).
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
  float w_new, gw_new;
  primal_update(reg, w_grid[col], gw_grid[col],
                tcn_g[((long long)q * n_rb + s) * d_pad + col],
                col_nnz[col], acc[t], eta, lam, m, w_lo, w_hi, w_new,
                gw_new);
  w_grid[col] = w_new;
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

// The one-warp-per-row launch A (sparse_dual_scatter_kernel), the baseline.
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

// The block-ELL launch A alone on live slots (sparse_step_kernel<ELL,
// false>), timed against the baseline: its arguments and `copies`, the
// copies of the (p, db) sums in acc.
int dso_sparse_dual_scatter_live(const int* cols_g, const float* vals_g,
                                 const int* blk_ids, const float* yg,
                                 const float* w_grid, float* alpha,
                                 float* ga, const float* trn_g,
                                 const float* rn_g, float* acc, int p,
                                 int mb, int K, int db, int r0, int rb,
                                 int copies, float eta, float m, int loss,
                                 void* stream) {
  StepArgs a = dual_args(cols_g, vals_g, blk_ids, yg, w_grid, alpha, ga,
                         trn_g, rn_g, acc, p, mb, db, r0, rb, eta, m, loss);
  a.K = K;
  a.copies = copies;
  return launch_step<ELL, false>(a, (cudaStream_t)stream);
}

// One row tile s of the block-ELL block step, launch B folded in (one
// cooperative launch); acc (copies * p, db) must be zero and is zero
// after it.
int dso_sparse_block_step(const int* cols_g, const float* vals_g,
                          const int* blk_ids, const float* yg, float* w_grid,
                          float* gw_grid, float* alpha, float* ga,
                          const float* trn_g, const float* rn_g,
                          const float* tcn_g, const float* col_nnz,
                          float* acc, int p, int mb, int K, int db, int n_rb,
                          int s, int r0, int rb, int copies, float eta,
                          float lam, float m, float w_lo, float w_hi,
                          int loss, int reg, void* stream) {
  StepArgs a = fold_args(
      dual_args(cols_g, vals_g, blk_ids, yg, w_grid, alpha, ga, trn_g, rn_g,
                acc, p, mb, db, r0, rb, eta, m, loss),
      gw_grid, tcn_g, col_nnz, n_rb, s, lam, w_lo, w_hi, reg);
  a.K = K;
  a.copies = copies;
  return launch_step<ELL, true>(a, (cudaStream_t)stream);
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

// The shared route's launch A alone: db float32 sums must fit one CTA's
// shared memory (the attribute's error comes back when they do not).
int dso_bucketed_dual_scatter_shared(
    const int* cols_fl, const float* vals_fl, const int* lut,
    const int* cnt_g, const int* blk_ids, const float* yg,
    const float* w_grid, float* alpha, float* ga, const float* trn_g,
    const float* rn_g, float* acc, int p, int mb, int n_chunks, int n_kc,
    int db, int r0, int rb, float eta, float m, int loss, void* stream) {
  StepArgs a = bucketed(
      dual_args(cols_fl, vals_fl, blk_ids, yg, w_grid, alpha, ga, trn_g,
                rn_g, acc, p, mb, db, r0, rb, eta, m, loss),
      lut, cnt_g, n_chunks, n_kc, nullptr, nullptr, db);
  return launch_step<SHARED, false>(a, (cudaStream_t)stream);
}

// The hot route's launch A alone: hot (p, db) and hot_cols (p, n_slots)
// int32, the grid's hot table (kernels/dso_sparse.py hot_table);
// 1 <= n_slots <= db.
int dso_bucketed_dual_scatter_hot(
    const int* cols_fl, const float* vals_fl, const int* lut,
    const int* cnt_g, const int* blk_ids, const float* yg,
    const float* w_grid, float* alpha, float* ga, const float* trn_g,
    const float* rn_g, float* acc, int p, int mb, int n_chunks, int n_kc,
    int db, int r0, int rb, float eta, float m, int loss, const int* hot,
    const int* hot_cols, int n_slots, void* stream) {
  if (n_slots < 1 || n_slots > db || hot == nullptr || hot_cols == nullptr)
    return (int)cudaErrorInvalidValue;
  StepArgs a = bucketed(
      dual_args(cols_fl, vals_fl, blk_ids, yg, w_grid, alpha, ga, trn_g,
                rn_g, acc, p, mb, db, r0, rb, eta, m, loss),
      lut, cnt_g, n_chunks, n_kc, hot, hot_cols, n_slots);
  return launch_step<HOT, false>(a, (cudaStream_t)stream);
}

// One row tile s of the bucketed block step on the shared route, launch B
// folded in (one cooperative launch); acc as in dso_sparse_block_step.
int dso_bucketed_block_step_shared(
    const int* cols_fl, const float* vals_fl, const int* lut,
    const int* cnt_g, const int* blk_ids, const float* yg, float* w_grid,
    float* gw_grid, float* alpha, float* ga, const float* trn_g,
    const float* rn_g, const float* tcn_g, const float* col_nnz, float* acc,
    int p, int mb, int n_chunks, int n_kc, int db, int n_rb, int s, int r0,
    int rb, float eta, float lam, float m, float w_lo, float w_hi, int loss,
    int reg, void* stream) {
  StepArgs a = fold_args(
      bucketed(dual_args(cols_fl, vals_fl, blk_ids, yg, w_grid, alpha, ga,
                         trn_g, rn_g, acc, p, mb, db, r0, rb, eta, m, loss),
               lut, cnt_g, n_chunks, n_kc, nullptr, nullptr, db),
      gw_grid, tcn_g, col_nnz, n_rb, s, lam, w_lo, w_hi, reg);
  return launch_step<SHARED, true>(a, (cudaStream_t)stream);
}

// The same on the hot route, with the grid's hot table as in
// dso_bucketed_dual_scatter_hot.
int dso_bucketed_block_step_hot(
    const int* cols_fl, const float* vals_fl, const int* lut,
    const int* cnt_g, const int* blk_ids, const float* yg, float* w_grid,
    float* gw_grid, float* alpha, float* ga, const float* trn_g,
    const float* rn_g, const float* tcn_g, const float* col_nnz, float* acc,
    int p, int mb, int n_chunks, int n_kc, int db, int n_rb, int s, int r0,
    int rb, float eta, float lam, float m, float w_lo, float w_hi, int loss,
    int reg, const int* hot, const int* hot_cols, int n_slots,
    void* stream) {
  if (n_slots < 1 || n_slots > db || hot == nullptr || hot_cols == nullptr)
    return (int)cudaErrorInvalidValue;
  StepArgs a = fold_args(
      bucketed(dual_args(cols_fl, vals_fl, blk_ids, yg, w_grid, alpha, ga,
                         trn_g, rn_g, acc, p, mb, db, r0, rb, eta, m, loss),
               lut, cnt_g, n_chunks, n_kc, hot, hot_cols, n_slots),
      gw_grid, tcn_g, col_nnz, n_rb, s, lam, w_lo, w_hi, reg);
  return launch_step<HOT, true>(a, (cudaStream_t)stream);
}

// The hot route's slots per CTA when the SM's shared memory is split
// `share` ways (1 to HOT_MAX_SHARE): the float32 sums that fit one part,
// less each CTA's reserved part, within the per-CTA opt-in limit; and the
// CTAs per SM its folded kernel then reaches (its registers allow 2).
int dso_bucketed_hot_slots(int share, int* slots, int* reached) {
  if (share < 1 || share > HOT_MAX_SHARE) return (int)cudaErrorInvalidValue;
  int dev = 0, per_sm = 0, reserved = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  long long bytes = per_sm / share - reserved;
  if (bytes > optin) bytes = optin;
  *slots = (int)(bytes / (long long)sizeof(float));
  if (*slots < 1) return (int)cudaErrorInvalidValue;
  return (int)dso::ctas_per_sm<sparse_step_kernel<HOT, true>>(
      32 * SH_WARPS, (size_t)*slots * sizeof(float), reached);
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
