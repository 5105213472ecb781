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
// The K-bucketed launch A has three routes (kernels/dso_sparse.py
// bucketed_route picks "shared" or "hot" by db and the card's shared-memory
// limit; "global" is reached only by asking for it).  On power-law data a
// few columns lie in almost every row, so one global atomicAdd per nonzero
// (the "global" route, bucketed_dual_scatter_kernel) sends ~mb atomics to
// each hot address of acc, which serialize in L2.  The "shared" route
// (bucketed_dual_scatter_shared_kernel<false>) gives each CTA one processor
// and a contiguous range of its rows: it sums X^T alpha_old in a db-wide
// float32 accumulator in shared memory, so the hot columns meet in shared
// atomics contended only inside one SM, and then adds each nonzero entry to
// acc[q] with one global atomic: at most one per (CTA, column).  Each row is
// a chain of dependent loads (lut, slots, w) and a dual step, so the launch
// is bound by latency more than by bytes: a group of 8, 16 or 32 lanes (the
// fewest that cover the tile's live slots) takes one row, so a warp walks
// several short rows at once, and the grid, sized from the SM count, is
// split among the processors by the chains their rows cost (the processor
// holding the popular block has 5 live chunks per row at logistic-real-sim,
// the others 1).  The lut walk, the gather of the pre-update w and the dual
// step's arithmetic are the global route's.
//
// The "hot" route (bucketed_dual_scatter_shared_kernel<true>) takes blocks
// past the shared budget (db > 58,112 on an H100: news20's 338,798, kdda's
// width).  Its CTAs sum only the block's n_slots hottest columns (largest
// col_nnz, ties by column index) in shared memory: a table built once per
// grid on the device (kernels/dso_sparse.py hot_table) maps each column of
// block b to its slot, hot[b * db + col], or -1; a slot's column is
// hot_cols[b * n_slots + slot].  A nonzero of a hot column takes a shared
// atomic, any other a direct global atomic (cold columns are spread, so
// their atomics meet little contention); the CTA ends with one global
// atomic per nonzero slot.  On power-law columns the hottest ~10 K columns
// of a block carry most of its nonzeros (~90 % at news20's shape), wherever
// they lie in the block.  n_slots: the float32 sums that fit the SM's
// shared memory split kernels/dso_sparse.py HOT_SMEM_SHARE ways
// (dso_bucketed_hot_slots), chosen by measurement: every slot is zeroed and
// read once per CTA, so fewer slots cost less until too many columns go to
// global atomics.
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

constexpr int SH_WARPS = 16;             // warps per CTA, shared route
constexpr int KC = 8;                    // slots per chunk of the flat view
constexpr int FLUSH = 8;                 // hot slots a thread ends at once
constexpr int PASSES = 2;                // passes over a row loaded at once
constexpr int HOT_MAX_SHARE = 8;         // most ways the SM's sums split

// Lanes per row of the shared route for a tile of n_live live chunks: the
// fewest of 8, 16 or 32 that cover its slots, so a warp walks 32 / G rows
// at once where rows are short.
__device__ __forceinline__ int shared_group(int n_live) {
  const int slots = n_live * KC;
  return slots <= 8 ? 8 : (slots <= 16 ? 16 : 32);
}

// A processor's share of the shared route's grid: each row is a chain of
// dependent loads (lut, slots, w) then a reduction and the dual step, so a
// row costs about (its passes over the slots + 1) chains, and a warp runs
// 32 / G rows side by side.  Weight = (passes + 1) * G.
__device__ __forceinline__ long long shared_weight(int n_live) {
  const int g = shared_group(n_live);
  return (long long)((n_live * KC + g - 1) / g + 1) * g;
}

// The shared and hot routes of the bucketed launch A.  CTA x of the grid
// works for processor q on rows [lo, hi) of row tile [r0, r0 + rb): every
// CTA derives the same split from blk_ids and cnt_g.  Processor q takes 1 +
// (G - p) * w_q / W of the G CTAs (w_q = shared_weight, W their sum); the
// host makes G >= p.  A group of shared_group(n_live) lanes takes one row:
// the same lut walk, gather and dual step as the global route, with the
// row's dual operands loaded before its slots.  acc_s is the CTA's
// accumulator of n_slots floats (dynamic shared memory).  HOT = false: the
// shared route, n_slots = db, a column's slot is the column.  HOT = true:
// the hot route, a column's slot is hot[b * db + col], -1 for a column
// summed by a global atomic; slot s holds column hot_cols[b * n_slots + s].
// A lane issues the loads of PASSES passes over its row's slots before it
// uses them, so a long row's chains overlap; the registers that takes
// leave room for 2 CTAs per SM (capping them for 3 spills, and measured
// slower: python -m repro_torch.bench.hot_route).
template <bool HOT>
__global__ void __launch_bounds__(32 * SH_WARPS, 2)
bucketed_dual_scatter_shared_kernel(
    const int* __restrict__ cols_fl, const float* __restrict__ vals_fl,
    const int* __restrict__ lut, const int* __restrict__ cnt_g,
    const int* __restrict__ blk_ids, const float* __restrict__ yg,
    const float* __restrict__ w_grid, float* __restrict__ alpha,
    float* __restrict__ ga, const float* __restrict__ trn_g,
    const float* __restrict__ rn_g, float* __restrict__ acc,
    const int* __restrict__ hot, const int* __restrict__ hot_cols,
    int n_slots, int p, int mb, int n_chunks, int n_kc, int db, int r0,
    int rb, float eta, float m, int loss) {
  extern __shared__ float acc_s[];
  long long wsum = 0;
  for (int q = 0; q < p; ++q)
    wsum += shared_weight(cnt_g[q * p + blk_ids[q]]);
  const long long spare = (long long)gridDim.x - p;
  int q = 0, first = 0, n_q = 0;
  for (; q < p; ++q) {
    n_q = 1 + (int)(spare * shared_weight(cnt_g[q * p + blk_ids[q]]) / wsum);
    if ((int)blockIdx.x < first + n_q) break;
    first += n_q;
  }
  if (q == p) return;                  // past the split: the whole CTA
  const int j = blockIdx.x - first;
  const int lo = r0 + (int)((long long)rb * j / n_q);
  const int hi = r0 + (int)((long long)rb * (j + 1) / n_q);

  for (int c = threadIdx.x; c < n_slots; c += blockDim.x) acc_s[c] = 0.0f;
  __syncthreads();
  const int b = blk_ids[q];
  const long long tile = (long long)q * p + b;
  const int* lq = lut + tile * n_kc;
  const int n_live = cnt_g[q * p + b];
  const float* w = w_grid + (long long)b * db;
  const int* hot_b = HOT ? hot + (long long)b * db : nullptr;
  float* acc_q = acc + (long long)q * db;
  const int g = shared_group(n_live);
  const int per_warp = 32 / g;
  const int lane = threadIdx.x & 31;
  const int gl = lane % g;             // lane within the row's group
  for (int i0 = lo + (int)threadIdx.x / 32 * per_warp; i0 < hi;
       i0 += SH_WARPS * per_warp) {
    const int i = i0 + lane / g;
    const bool live = i < hi;
    const long long r = (long long)q * mb + i;
    float s = 0.0f, a_old = 0.0f;
    float y = 0.0f, trn = 0.0f, rn = 0.0f, ga_old = 0.0f;
    if (live) {
      a_old = alpha[r];
      if (gl == 0) {
        y = yg[r];
        trn = trn_g[tile * mb + i];
        rn = rn_g[r];
        ga_old = ga[r];
      }
      const int n_slot = n_live * KC;
      for (int t0 = gl; t0 < n_slot; t0 += PASSES * g) {
        float vk[PASSES], wk[PASSES];
        int ck[PASSES], slot[PASSES];
#pragma unroll
        for (int u = 0; u < PASSES; ++u) {
          const int t = t0 + u * g;
          vk[u] = 0.0f;                // past the row: adds an exact zero
          ck[u] = 0;
          if (t < n_slot) {
            const long long off =
                (((long long)q * n_chunks + lq[t / KC]) * mb + i) * KC +
                (t % KC);
            vk[u] = vals_fl[off];
            ck[u] = cols_fl[off];
          }
        }
#pragma unroll
        for (int u = 0; u < PASSES; ++u) {
          const bool in = t0 + u * g < n_slot;
          wk[u] = in ? w[ck[u]] : 0.0f;
          if constexpr (HOT) slot[u] = in ? hot_b[ck[u]] : -1;
        }
#pragma unroll
        for (int u = 0; u < PASSES; ++u) {
          s += vk[u] * wk[u];
          if (vk[u] != 0.0f) {
            if constexpr (HOT) {
              if (slot[u] >= 0)
                atomicAdd(acc_s + slot[u], vk[u] * a_old);
              else
                atomicAdd(acc_q + ck[u], vk[u] * a_old);
            } else {
              atomicAdd(acc_s + ck[u], vk[u] * a_old);
            }
          }
        }
      }
    }
    for (int off = g / 2; off > 0; off >>= 1)   // every lane takes part
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (live && gl == 0) {
      float a_new, ga_new;
      dual_update(loss, s, a_old, ga_old, y, trn, rn, eta, m, a_new, ga_new);
      alpha[r] = a_new;
      ga[r] = ga_new;
    }
  }
  __syncthreads();
  if constexpr (HOT) {
    // FLUSH slots a thread at a time: the columns of the nonzero ones are
    // loaded together, so the loads of hot_cols overlap instead of
    // queueing behind each other
    const int* cols_b = hot_cols + (long long)b * n_slots;
    for (int c0 = threadIdx.x; c0 < n_slots; c0 += FLUSH * blockDim.x) {
      float v[FLUSH];
      int col[FLUSH];
#pragma unroll
      for (int u = 0; u < FLUSH; ++u) {
        const int c = c0 + u * blockDim.x;
        v[u] = c < n_slots ? acc_s[c] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < FLUSH; ++u)
        col[u] = v[u] != 0.0f ? cols_b[c0 + u * blockDim.x] : 0;
#pragma unroll
      for (int u = 0; u < FLUSH; ++u)
        if (v[u] != 0.0f) atomicAdd(acc_q + col[u], v[u]);
    }
  } else {
    for (int c = threadIdx.x; c < n_slots; c += blockDim.x) {
      const float v = acc_s[c];
      if (v != 0.0f) atomicAdd(acc_q + c, v);
    }
  }
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

// Launch the shared (HOT = false) or hot route on n_slots float32 sums of
// shared memory per CTA: as many CTAs as fit on the card at once, at least
// one per processor and no more than a warp per row.
template <bool HOT>
int launch_shared(const int* cols_fl, const float* vals_fl, const int* lut,
                  const int* cnt_g, const int* blk_ids, const float* yg,
                  const float* w_grid, float* alpha, float* ga,
                  const float* trn_g, const float* rn_g, float* acc,
                  const int* hot, const int* hot_cols, int n_slots, int p,
                  int mb, int n_chunks, int n_kc, int db, int r0, int rb,
                  float eta, float m, int loss, cudaStream_t stream) {
  if (p <= 0 || rb <= 0 || db <= 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)n_slots * sizeof(float);
  int per_sm = 0;
  const cudaError_t e =
      dso::ctas_per_sm<bucketed_dual_scatter_shared_kernel<HOT>>(
          32 * SH_WARPS, smem, &per_sm);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long grid = (long long)per_sm * dso::sm_count();
  const long long most = (long long)p * dso::blocks_for(rb, SH_WARPS);
  if (grid > most) grid = most;
  if (grid < p) grid = p;
  bucketed_dual_scatter_shared_kernel<HOT>
      <<<(unsigned)grid, 32 * SH_WARPS, smem, stream>>>(
          cols_fl, vals_fl, lut, cnt_g, blk_ids, yg, w_grid, alpha, ga,
          trn_g, rn_g, acc, hot, hot_cols, n_slots, p, mb, n_chunks, n_kc,
          db, r0, rb, eta, m, loss);
  return (int)cudaGetLastError();
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

// The shared route: db float32 sums must fit one CTA's shared memory
// (the attribute's error comes back when they do not).
int dso_bucketed_dual_scatter_shared(
    const int* cols_fl, const float* vals_fl, const int* lut,
    const int* cnt_g, const int* blk_ids, const float* yg,
    const float* w_grid, float* alpha, float* ga, const float* trn_g,
    const float* rn_g, float* acc, int p, int mb, int n_chunks, int n_kc,
    int db, int r0, int rb, float eta, float m, int loss, void* stream) {
  return launch_shared<false>(cols_fl, vals_fl, lut, cnt_g, blk_ids, yg,
                              w_grid, alpha, ga, trn_g, rn_g, acc, nullptr,
                              nullptr, db, p, mb, n_chunks, n_kc, db, r0, rb,
                              eta, m, loss, (cudaStream_t)stream);
}

// The hot route: hot (p, db) and hot_cols (p, n_slots) int32, the grid's
// hot table (kernels/dso_sparse.py hot_table); 1 <= n_slots <= db.
int dso_bucketed_dual_scatter_hot(
    const int* cols_fl, const float* vals_fl, const int* lut,
    const int* cnt_g, const int* blk_ids, const float* yg,
    const float* w_grid, float* alpha, float* ga, const float* trn_g,
    const float* rn_g, float* acc, int p, int mb, int n_chunks, int n_kc,
    int db, int r0, int rb, float eta, float m, int loss, const int* hot,
    const int* hot_cols, int n_slots, void* stream) {
  if (n_slots < 1 || n_slots > db || hot == nullptr || hot_cols == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_shared<true>(cols_fl, vals_fl, lut, cnt_g, blk_ids, yg,
                             w_grid, alpha, ga, trn_g, rn_g, acc, hot,
                             hot_cols, n_slots, p, mb, n_chunks, n_kc, db, r0,
                             rb, eta, m, loss, (cudaStream_t)stream);
}

// The hot route's slots per CTA when the SM's shared memory is split
// `share` ways (1 to HOT_MAX_SHARE): the float32 sums that fit one part,
// less each CTA's reserved part, within the per-CTA opt-in limit; and the
// CTAs per SM its kernel then reaches (its registers allow 2).
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
  return (int)dso::ctas_per_sm<bucketed_dual_scatter_shared_kernel<true>>(
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
