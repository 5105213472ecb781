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
//   SGD, per worker: for each step s, the rows r_b = rows[q][s*batch + b]
//   (b < batch; -1 marks a padding row, whose x and y are 0) give
//   u_b = <x_{r_b}, w> and lg_b = l'(u_b, y_{r_b}); then over every column j
//       g_j   = lam * phi'(w_j) + (sum_b x_{r_b, j} lg_b) / batch
//       acc_j = acc_j + g_j^2
//       w_j   = w_j - eta0 * g_j / sqrt(acc_j + 1e-8)
//   (sgd.py:35-39).  The trailing m % batch rows of a permutation are not
//   passed in (nsteps = m // batch).
//   DCD: for each step k, i = perm[k],
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
// wrote.  So the floor is steps x the latency of one step, and a step's
// latency is its exchange: the margin's partial sums of every part of w
// have to meet before any column can move.  The matrix-vector products of
// one step are too small and too dependent for the tensor cores (a row
// against a vector, then a rank-batch update): they do not apply.
//
// The design: one thread-block cluster per worker (sgd_cluster_kernel,
// dcd_cluster_kernel).  A host plan (kernels/baselines.py epoch_plan)
// picks the cluster's C blocks (C <= 16, on neighbouring SMs) and splits d
// into C slices of `width` columns (even starts, so 8-byte copies).  Block
// r owns columns [r*width, min(d, (r+1)*width)), and each of its threads
// owns the same pairs of columns at every step, so a thread reads only what
// it wrote or copied itself.  When the slice fits (`staged`), w (and acc)
// live in shared memory and each thread copies its part of the rows two
// steps ahead into a ring of three stages (cp.async, 8 bytes where the row
// is 8-byte aligned: a row of real-sim's is 83,832 bytes, which TMA's
// 16-byte rule refuses), started while the step's partials travel; else w,
// acc and X stay in global memory (one body, the STAGED switch).  A step:
//   1. each thread's float64 partial of the margin(s) over its columns,
//      summed over the warp, then over the block's warps (one
//      __syncthreads);
//   2. the exchange (struct Exchange): the block's partial stored into
//      every rank's shared memory by st.async, each store completing on
//      that rank's mbarrier, and a wait on the block's own mbarrier; no
//      cluster-wide barrier, whose release/acquire costs more than the
//      rest of the exchange together (bench/epoch_step.py);
//   3. every block sums the C partials in float64 in rank order, so all
//      hold the same margins, rounds them once to float and takes the loss
//      gradient (SGD) or the coefficient (DCD);
//   4. each thread updates its own columns from the ring.
// The row ids (and y, and DCD's |x_i|^2) come in chunks of steps into a
// three-deep buffer, refilled every `chunk` steps.  A last cluster barrier
// keeps every block alive until its peers are done with it.
//
// DCD's beta.  Every block computes b_new from the same partials in the
// same order, so all hold the same value; rank 0 alone writes beta[i].
// The read of beta[perm[s+1]] (from L2: __ldcg, so no stale line in L1) is
// made after step s's exchange, which orders every write of the steps
// before s (rank 0 writes step s-1's before it sends step s's partial, and
// the wait acquires at cluster scope); the one write it cannot see, step
// s's own, every block holds in a register and takes when perm[s+1] ==
// perm[s].  So `perm` may repeat ids, and the read's latency hides behind
// step s+1's margin.
//
// Arithmetic, shared with the plain versions (kernels/baselines.py) so that
// the two agree bit for bit: each margin <x, w> and each column's
// sum_b x_{r_b, j} lg_b is summed in double (the products of floats are
// exact there) and rounded once to float; the loss gradient is taken in
// double from the float margin and rounded to float; every other operation
// is one IEEE-rounded float operation in the reference's order
// (__fmul_rn and friends, so nvcc contracts nothing into an FMA), and
// AdaGrad's rsqrt is 1 / sqrt.  At batch 1 the column's sum is one exact
// product, so (float)(0.0 + (double)x * lg) is __fadd_rn(0, __fmul_rn(x,
// lg)) bit for bit, and / 1 is dropped.  So the order of a sum changes its
// float result only where the double sum lies within a double ulp of a
// float rounding boundary.  That matters for l1: a w near 0 that an ulp
// moves across 0 takes the other sign(w) and steps the other way, so float
// sums in another order than the plain version's part the two by a whole
// step.
//
// Determinism: no atomics, and every sum is taken in one fixed order (each
// thread's pairs in turn, the warp's butterfly, the block's warps, the
// cluster's ranks in order), so two runs on the same inputs agree bit for
// bit.
//
// The one-block kernels (sgd_epoch_kernel, dcd_epoch_kernel: a worker's
// epoch on one block of 1,024 threads) stay as the entries
// sgd_epoch_one_block and dcd_epoch_one_block, the baseline of chip_smoke's
// A/B; no wrapper of kernels/ops.py launches them.

#include <cooperative_groups.h>

#include "dso_common.cuh"

namespace {

using namespace dso;
namespace cg = cooperative_groups;

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

// ------------------------------------------------- the cluster kernels --

constexpr int CL_THREADS = 512;
constexpr int CL_WARPS = CL_THREADS / 32;
constexpr int MAX_CLUSTER = 16;
constexpr int RING = 3;            // stages of X's rows in shared memory
constexpr int CHUNK_ROWS = 512;    // row ids per refill of the id buffer

enum Kind { SGD = 0, DCD = 1 };

// Steps per chunk of row ids (kernels/baselines.py chunk_steps).
__host__ __device__ inline int chunk_steps(int batch) {
  const int k = CHUNK_ROWS / batch;
  return k > 4 ? k : 4;
}

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Byte offsets of the dynamic shared memory (kernels/baselines.py
// epoch_smem mirrors `bytes`): the exchange's two mbarriers, its
// part[2][batch][MAX_CLUSTER] (double), red[warps][batch] (double), SGD's
// lg[warps][batch] (float), the id buffer's 3 chunks of (row id, y[,
// |x|^2]), then when staged w[width] (SGD: and acc[width]) and the
// ring[RING][batch][width].
struct Layout {
  size_t bar, part, red, lg, ids, ys, xn, w, acc, ring, bytes;
};

__host__ __device__ inline Layout layout(int kind, int batch, int width,
                                         bool staged) {
  Layout L{};
  const size_t info = 3 * (size_t)chunk_steps(batch) * batch;
  size_t o = 0;
  L.bar = o;   o += 16;
  L.part = o;  o += align16(2 * (size_t)batch * MAX_CLUSTER * sizeof(double));
  L.red = o;   o += align16((size_t)CL_WARPS * batch * sizeof(double));
  L.lg = o;    if (kind == SGD) o += align16((size_t)CL_WARPS * batch * 4);
  L.ids = o;   o += align16(info * 4);
  L.ys = o;    o += align16(info * 4);
  L.xn = o;    if (kind == DCD) o += align16(info * 4);
  L.w = o;     if (staged) o += align16((size_t)width * 4);
  L.acc = o;   if (staged && kind == SGD) o += align16((size_t)width * 4);
  L.ring = o;  if (staged) o += align16((size_t)RING * batch * width * 4);
  L.bytes = o;
  return L;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(__cvta_generic_to_global(src))
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(smem_addr(dst)), "l"(__cvta_generic_to_global(src))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// At the top of step s: wait until at most RING - 2 of this thread's copy
// groups are in flight (steps s+1 ..), so step s's rows have landed.
__device__ __forceinline__ void cp_async_wait_step() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(RING - 2) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// This thread's part of one row's slice into a ring stage: the pairs
// u = tid, tid + CL_THREADS, ... of the slice's `wr` columns, 8 bytes a
// pair where the source is 8-byte aligned, else 4 and 4.
__device__ __forceinline__ void copy_slice(float* dst, const float* src,
                                           int wr) {
  const bool al8 = (reinterpret_cast<uintptr_t>(src) & 7) == 0;
  for (int j = 2 * threadIdx.x; j < wr; j += 2 * CL_THREADS) {
    if (j + 1 < wr) {
      if (al8) {
        cp_async8(dst + j, src + j);
      } else {
        cp_async4(dst + j, src + j);
        cp_async4(dst + j + 1, src + j + 1);
      }
    } else {
      cp_async4(dst + j, src + j);
    }
  }
}

// A thread's columns: pairs 2u, 2u + 1 for u = tid, tid + CL_THREADS, ...;
// the loops take two pairs at a time (LANES columns, j0 and j0 + 1, then
// the same CL_THREADS pairs on), so that their chains run side by side.
constexpr int LANES = 4;
constexpr int STRIDE = 4 * CL_THREADS;

__device__ __forceinline__ void own_columns(int j0, int (&j)[LANES]) {
  j[0] = j0;
  j[1] = j0 + 1;
  j[2] = j0 + 2 * CL_THREADS;
  j[3] = j0 + 2 * CL_THREADS + 1;
}

// This thread's share of the step's block partial of row b: its p summed
// over its warp into red[warp][b].
__device__ __forceinline__ void block_partial(double p, int b, double* red,
                                              int batch) {
  p = warp_allsum(p);
  if ((threadIdx.x & 31) == 0) red[(threadIdx.x >> 5) * batch + b] = p;
}

__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

// The per-step exchange of the block partials among the cluster's C ranks.
// Block r's partial of row b goes straight into every rank q's
// part[s & 1][b][r] (st.async, lane q of the warp that summed it), each
// store completing on rank q's mbarrier bar[s & 1]; a block waits on its
// own bar[s & 1] for its C * batch partials.  No cluster-wide barrier: on
// an H100 a cluster.sync() (barrier.cluster with its release/acquire)
// alone costs more than the push and the wait (bench/epoch_step.py).
// Rank q's slots of step s+2 are written only after their writer has had
// q's partials of step s+1, which q sends after every thread of q has read
// step s's (the step's __syncthreads): two halves are enough.  The
// partials are summed in rank order, in float64.
struct Exchange {
  double* part;
  uint64_t* bar;
  int batch, C, rank;

  __device__ void init(const cg::cluster_group& cl) {
    if (threadIdx.x == 0) {
      for (int k = 0; k < 2; ++k)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                     :: "r"(smem_addr(bar + k)) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cl.sync();          // every rank's barriers are live before a push
  }
  __device__ void begin(int s) {      // expect the step's bytes
    if (threadIdx.x == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(smem_addr(bar + (s & 1))),
                      "r"((unsigned)(C * batch * 8)) : "memory");
  }
  // Every lane of the calling warp holds t, the block's partial of row b.
  __device__ void publish(int s, int b, double t) {
    const int lane = threadIdx.x & 31;
    if (lane < C) {
      const uint32_t dst = mapa(
          smem_addr(part + ((s & 1) * batch + b) * MAX_CLUSTER + rank), lane);
      const uint32_t bq = mapa(smem_addr(bar + (s & 1)), lane);
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 "
          "[%0], %1, [%2];\n"
          :: "r"(dst), "l"(__double_as_longlong(t)), "r"(bq) : "memory");
    }
  }
  __device__ void wait(int s) const {
    const uint32_t b = smem_addr(bar + (s & 1)), parity = (s >> 1) & 1;
    uint32_t done = 0, spins = 0;
    uint64_t t0 = 0;
    while (true) {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 "
          "p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(b), "r"(parity) : "memory");
      if (done) return;
      // a step takes microseconds; a wait of 10 s is a broken exchange,
      // and the launch fails instead of hanging the card
      if (++spins % 1024 == 0) {
        if (t0 == 0) t0 = global_ns();
        else if (global_ns() - t0 > 10000000000ull) __trap();
      }
    }
  }
  // Row b's margin: the C partials of step s in rank order.
  __device__ double sum(int s, int b) const {
    const double* v = part + ((s & 1) * batch + b) * MAX_CLUSTER;
    double u = 0.0;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < C) u += v[r];
    return u;
  }
};

// After the step's __syncthreads: warp k sums the warps' partials of rows
// k, k + CL_WARPS, ... and publishes them.
__device__ __forceinline__ void block_partials_out(const double* red,
                                                   Exchange& ex, int s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = warp; b < ex.batch; b += CL_WARPS) {
    double t = lane < CL_WARPS ? red[lane * ex.batch + b] : 0.0;
    t = warp_allsum(t);
    ex.publish(s, b, t);
  }
}

// Where step s's entries sit in the id buffer (buffer (s / K) % 3, place
// s % K) and its ring stage (s % RING), advanced one step at a time, so
// the loop divides nothing.
struct StepPos {
  int K, k, buf, stage, chunk;

  // The first of step s + ahead's `batch` entries (0 <= ahead < K).
  __device__ __forceinline__ int entry(int ahead, int batch) const {
    int kk = k + ahead, bb = buf;
    if (kk >= K) {
      kk -= K;
      bb = bb == 2 ? 0 : bb + 1;
    }
    return (bb * K + kk) * batch;
  }
  __device__ __forceinline__ int stage_of(int ahead) const {
    const int st = stage + ahead;
    return st >= RING ? st - RING : st;
  }
  __device__ __forceinline__ void next() {
    if (++k == K) {
      k = 0;
      buf = buf == 2 ? 0 : buf + 1;
      ++chunk;
    }
    if (++stage == RING) stage = 0;
  }
};

// Fill buffer (chunk % 3) of the id buffer with the chunk's `K * batch`
// row ids (past n_rows: -1) and their labels (0 for -1); DCD also |x|^2.
__device__ __forceinline__ void load_chunk(int chunk, int K, int batch,
                                           const int* ids_in, int n_rows,
                                           const float* y, const float* xn2,
                                           int* ids, float* ys, float* xn) {
  const int n = K * batch, base = chunk * n, buf = (chunk % 3) * n;
  for (int e = threadIdx.x; e < n; e += CL_THREADS) {
    const int at = base + e;
    const int r = at < n_rows ? ids_in[at] : -1;
    ids[buf + e] = r;
    ys[buf + e] = r >= 0 ? y[r] : 0.0f;
    if (xn != nullptr) xn[buf + e] = r >= 0 ? xn2[r] : 0.0f;
  }
}

// One AdaGrad SGD epoch of worker q = blockIdx.x / C on the cluster of C
// blocks; block r's slice [r*width, min(d, (r+1)*width)).
template <bool STAGED>
__global__ void __launch_bounds__(CL_THREADS, 1) sgd_cluster_kernel(
    const float* __restrict__ X, long long ld, const float* __restrict__ y,
    const int* __restrict__ rows, int n_rows, float* w, float* acc, int d,
    int batch, int width, float eta0, float lam, int loss, int reg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int q = blockIdx.x / C, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int c0 = rank * width;
  const int wr = max(0, min(d, c0 + width) - c0);
  const Layout L = layout(SGD, batch, width, STAGED);
  Exchange ex{reinterpret_cast<double*>(smem + L.part),
              reinterpret_cast<uint64_t*>(smem + L.bar), batch, C, rank};
  double* red = reinterpret_cast<double*>(smem + L.red);
  float* lg = reinterpret_cast<float*>(smem + L.lg) + warp * batch;
  int* ids = reinterpret_cast<int*>(smem + L.ids);
  float* ys = reinterpret_cast<float*>(smem + L.ys);
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  float* wq = w + (long long)q * d + c0;
  float* aq = acc + (long long)q * d + c0;
  float* ws = STAGED ? reinterpret_cast<float*>(smem + L.w) : wq;
  float* as = STAGED ? reinterpret_cast<float*>(smem + L.acc) : aq;
  const int* rq = rows + (long long)q * n_rows;
  const int K = chunk_steps(batch), nsteps = n_rows / batch;
  const float fb = (float)batch;

  if (STAGED) {             // each thread its own pairs, as everywhere
    for (int j = 2 * tid; j < wr; j += 2 * CL_THREADS) {
      ws[j] = wq[j];
      as[j] = aq[j];
      if (j + 1 < wr) {
        ws[j + 1] = wq[j + 1];
        as[j + 1] = aq[j + 1];
      }
    }
  }
  load_chunk(0, K, batch, rq, n_rows, y, nullptr, ids, ys, nullptr);
  load_chunk(1, K, batch, rq, n_rows, y, nullptr, ids, ys, nullptr);
  ex.init(cl);          // also the block's barrier for the stores above
  StepPos pos{K, 0, 0, 0, 0};
  // step s + ahead's rows into its ring stage
  auto prefetch = [&](int ahead) {
    const int e = pos.entry(ahead, batch), st = pos.stage_of(ahead);
    for (int b = 0; b < batch; ++b) {
      const int r = ids[e + b];
      if (r >= 0)
        copy_slice(ring + ((size_t)st * batch + b) * width,
                   X + (long long)r * ld + c0, wr);
    }
  };
  if (STAGED) {
    for (int t = 0; t < RING - 1; ++t) {
      if (t < nsteps) prefetch(t);
      cp_async_commit();
    }
  }
  for (int s = 0; s < nsteps; ++s, pos.next()) {
    if (s > 0 && pos.k == 0)
      load_chunk(pos.chunk + 1, K, batch, rq, n_rows, y, nullptr, ids, ys,
                 nullptr);
    ex.begin(s);
    if (STAGED) cp_async_wait_step();
    const int info = pos.entry(0, batch);
    const int* rs = ids + info;
    const float* yb = ys + info;
    const float* xs0 = STAGED ? ring + (size_t)pos.stage * batch * width
                              : nullptr;
    // 1. the margins' partial sums over this block's columns
    for (int b = 0; b < batch; ++b) {
      const int r = rs[b];
      double p = 0.0;
      if (r >= 0) {
        const float* x = STAGED ? xs0 + (size_t)b * width
                                : X + (long long)r * ld + c0;
        for (int j0 = 2 * tid; j0 < wr; j0 += STRIDE) {
          int j[LANES];
          own_columns(j0, j);
#pragma unroll
          for (int k = 0; k < LANES; ++k)
            if (j[k] < wr) p += (double)x[j[k]] * (double)ws[j[k]];
        }
      }
      block_partial(p, b, red, batch);
    }
    __syncthreads();
    block_partials_out(red, ex, s);
    // step s + RING - 1's rows, started while the partials travel
    if (STAGED) {
      if (s + RING - 1 < nsteps) prefetch(RING - 1);
      cp_async_commit();
    }
    // 2. the exchange
    ex.wait(s);
    // 3. the margins, summed over the ranks in order, and l'(u, y): at
    // batch 1 in every lane, else lane b's in the warp's lg[b]
    float lg0 = 0.0f;
    if (batch == 1) {
      lg0 = rs[0] >= 0 ? (float)loss_grad(loss, (float)ex.sum(s, 0), yb[0])
                       : 0.0f;
    } else {
      for (int b = lane; b < batch; b += 32) {
        const float u = (float)ex.sum(s, b);
        lg[b] = rs[b] >= 0 ? (float)loss_grad(loss, u, yb[b]) : 0.0f;
      }
      __syncwarp();
    }
    // 4. this thread's columns, their chains side by side
    for (int j0 = 2 * tid; j0 < wr; j0 += STRIDE) {
      int j[LANES];
      own_columns(j0, j);
      float xg[LANES], wj[LANES], aj[LANES];
#pragma unroll
      for (int k = 0; k < LANES; ++k) {
        const bool ok = j[k] < wr;
        const int c = ok ? j[k] : 0;
        wj[k] = ok ? ws[c] : 0.0f;
        aj[k] = ok ? as[c] : 0.0f;
        if (batch == 1) {           // (X_b^T lg)_j / batch, one exact product
          const int r = rs[0];
          const float x = !ok || r < 0 ? 0.0f
                          : STAGED ? xs0[c] : X[(long long)r * ld + c0 + c];
          xg[k] = r < 0 ? 0.0f : __fadd_rn(0.0f, __fmul_rn(x, lg0));
        } else {
          double xsum = 0.0;
          for (int b = 0; b < batch; ++b) {
            const int r = rs[b];
            if (ok && r >= 0) {
              const float x = STAGED ? xs0[(size_t)b * width + c]
                                     : X[(long long)r * ld + c0 + c];
              xsum += (double)x * (double)lg[b];
            }
          }
          xg[k] = __fdiv_rn((float)xsum, fb);
        }
      }
#pragma unroll
      for (int k = 0; k < LANES; ++k) {
        // g = lam * phi'(w) + (X_b^T lg) / batch; 1 / sqrt as __frcp_rn,
        // which is 1.0f / x rounded once, bit for bit
        const float g = __fadd_rn(__fmul_rn(lam, reg_grad(reg, wj[k])), xg[k]);
        aj[k] = __fadd_rn(aj[k], __fmul_rn(g, g));
        const float rsq = __frcp_rn(__fsqrt_rn(__fadd_rn(aj[k], ADA_EPS)));
        wj[k] = __fsub_rn(wj[k], __fmul_rn(__fmul_rn(eta0, g), rsq));
      }
#pragma unroll
      for (int k = 0; k < LANES; ++k)
        if (j[k] < wr) {
          as[j[k]] = aj[k];
          ws[j[k]] = wj[k];
        }
    }
  }
  if (STAGED) {
    cp_async_wait_all();
    for (int j = 2 * tid; j < wr; j += 2 * CL_THREADS) {
      wq[j] = ws[j];
      aq[j] = as[j];
      if (j + 1 < wr) {
        wq[j + 1] = ws[j + 1];
        aq[j + 1] = as[j + 1];
      }
    }
  }
  cl.sync();          // no block leaves while a peer may still store to it
}

// One DCD epoch on one cluster of C blocks; block r's slice of w as above.
template <bool STAGED>
__global__ void __launch_bounds__(CL_THREADS, 1) dcd_cluster_kernel(
    const float* __restrict__ X, long long ld, const float* __restrict__ y,
    const int* __restrict__ perm, int n, float* w, float* beta,
    const float* __restrict__ xnorm2, int d, int width, float lam, float m,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int tid = threadIdx.x;
  const int c0 = rank * width;
  const int wr = max(0, min(d, c0 + width) - c0);
  const Layout L = layout(DCD, 1, width, STAGED);
  Exchange ex{reinterpret_cast<double*>(smem + L.part),
              reinterpret_cast<uint64_t*>(smem + L.bar), 1, C, rank};
  double* red = reinterpret_cast<double*>(smem + L.red);
  int* ids = reinterpret_cast<int*>(smem + L.ids);
  float* ys = reinterpret_cast<float*>(smem + L.ys);
  float* xn = reinterpret_cast<float*>(smem + L.xn);
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  float* wq = w + c0;
  float* ws = STAGED ? reinterpret_cast<float*>(smem + L.w) : wq;
  const int K = chunk_steps(1);

  if (STAGED)
    for (int j = 2 * tid; j < wr; j += 2 * CL_THREADS) {
      ws[j] = wq[j];
      if (j + 1 < wr) ws[j + 1] = wq[j + 1];
    }
  load_chunk(0, K, 1, perm, n, y, xnorm2, ids, ys, xn);
  load_chunk(1, K, 1, perm, n, y, xnorm2, ids, ys, xn);
  ex.init(cl);
  StepPos pos{K, 0, 0, 0, 0};
  auto prefetch = [&](int ahead) {
    copy_slice(ring + (size_t)pos.stage_of(ahead) * width,
               X + (long long)ids[pos.entry(ahead, 1)] * ld + c0, wr);
  };
  if (STAGED) {
    for (int t = 0; t < RING - 1; ++t) {
      if (t < n) prefetch(t);
      cp_async_commit();
    }
  }
  // beta of step s's row as read after barrier s-1, and step s-1's id and
  // new beta (every block computes them alike)
  float b_read = n > 0 ? __ldcg(beta + ids[0]) : 0.0f;
  int i_prev = -1;
  float b_prev = 0.0f;
  for (int s = 0; s < n; ++s, pos.next()) {
    if (s > 0 && pos.k == 0)
      load_chunk(pos.chunk + 1, K, 1, perm, n, y, xnorm2, ids, ys, xn);
    ex.begin(s);
    if (STAGED) cp_async_wait_step();
    const int e = pos.entry(0, 1), i = ids[e];
    const float* x = STAGED ? ring + (size_t)pos.stage * width
                            : X + (long long)i * ld + c0;
    double p = 0.0;
    for (int j0 = 2 * tid; j0 < wr; j0 += STRIDE) {
      int j[LANES];
      own_columns(j0, j);
#pragma unroll
      for (int k = 0; k < LANES; ++k)
        if (j[k] < wr) p += (double)ws[j[k]] * (double)x[j[k]];
    }
    block_partial(p, 0, red, 1);
    __syncthreads();
    block_partials_out(red, ex, s);
    if (STAGED) {
      if (s + RING - 1 < n) prefetch(RING - 1);
      cp_async_commit();
    }
    ex.wait(s);
    const float dot = (float)ex.sum(s, 0);
    const float yi = ys[e];
    const float g = __fsub_rn(1.0f, __fmul_rn(yi, dot));
    // step = g * 2 * lam * m / max(|x_i|^2, 1e-12)
    const float step = __fdiv_rn(
        __fmul_rn(__fmul_rn(__fmul_rn(g, 2.0f), lam), m),
        fmaxf(xn[e], 1e-12f));
    const float b_old = i == i_prev ? b_prev : b_read;
    const float b_new = clampf(__fadd_rn(b_old, step), 0.0f, 1.0f);
    if (rank == 0 && tid == 0) beta[i] = b_new;
    const float c = __fmul_rn(__fmul_rn(__fsub_rn(b_new, b_old), yi), scale);
    if (s + 1 < n) b_read = __ldcg(beta + ids[pos.entry(1, 1)]);
    i_prev = i;
    b_prev = b_new;
    if (c != 0.0f)
      for (int j0 = 2 * tid; j0 < wr; j0 += STRIDE) {
        int j[LANES];
        own_columns(j0, j);
#pragma unroll
        for (int k = 0; k < LANES; ++k)
          if (j[k] < wr) ws[j[k]] = __fadd_rn(ws[j[k]], __fmul_rn(c, x[j[k]]));
      }
  }
  if (STAGED) {
    cp_async_wait_all();
    for (int j = 2 * tid; j < wr; j += 2 * CL_THREADS) {
      wq[j] = ws[j];
      if (j + 1 < wr) wq[j + 1] = ws[j + 1];
    }
  }
  cl.sync();
}

// The exchange alone, for `nsteps` steps at batch 1: each step's block
// partial (warp butterfly, the block's warps), the exchange and the C
// ranks' partials summed in rank order, as the kernels above do it, with
// no column work.  Its time per step is the floor of theirs.
__global__ void __launch_bounds__(CL_THREADS, 1) exchange_floor_kernel(
    int nsteps, float* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const cg::cluster_group cl = cg::this_cluster();
  const Layout L = layout(SGD, 1, 0, false);
  Exchange ex{reinterpret_cast<double*>(smem + L.part),
              reinterpret_cast<uint64_t*>(smem + L.bar), 1,
              (int)cl.num_blocks(), (int)cl.block_rank()};
  double* red = reinterpret_cast<double*>(smem + L.red);
  float v = (float)threadIdx.x;
  ex.init(cl);
  for (int s = 0; s < nsteps; ++s) {
    ex.begin(s);
    block_partial((double)v, 0, red, 1);
    __syncthreads();
    block_partials_out(red, ex, s);
    ex.wait(s);
    v = __fadd_rn(v, __fmul_rn((float)ex.sum(s, 0), 1e-30f));
  }
  cl.sync();
  if (threadIdx.x == 0) out[blockIdx.x] = v;
}

int smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return bytes;
}

// Launch `kern` as n_clusters clusters of C blocks of CL_THREADS threads
// with `smem` bytes: refused (an error returned, nothing launched) when
// the card cannot hold one such cluster.
template <typename... KArgs, typename... Args>
cudaError_t launch_clusters(void (*kern)(KArgs...), int C, int n_clusters,
                            size_t smem, cudaStream_t stream, Args... args) {
  if (C < 1 || C > MAX_CLUSTER || n_clusters < 1) return cudaErrorInvalidValue;
  if (smem > (size_t)smem_optin()) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(C * n_clusters));
  cfg.blockDim = dim3(CL_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fits = 0;
  e = cudaOccupancyMaxActiveClusters(&fits, kern, &cfg);
  if (e != cudaSuccess) return e;
  if (fits < 1) return cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// A plan's slices must tile [0, d) with no empty slice: width even,
// (C - 1) * width < d <= C * width.
bool slices_ok(int d, int C, int width) {
  return width > 0 && width % 2 == 0 && C >= 1 && C <= MAX_CLUSTER &&
         (long long)(C - 1) * width < d && (long long)C * width >= d;
}

// ------------------------------- the one-block kernels (the A/B's base) --

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;

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
  extern __shared__ double smem1[];
  double* red = smem1;
  int* rid = reinterpret_cast<int*>(smem1 + WARPS);
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
  extern __shared__ double smem1[];
  double* red = smem1;
  float* coef = reinterpret_cast<float*>(smem1 + WARPS);
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

// Launch Kernel<true> with `base + staged` bytes of shared memory when
// that fits the card's opt-in limit, else Kernel<false> with `base`.
template <typename K, typename... Args>
cudaError_t launch_one_block(K small, K staged_kernel, size_t base,
                             size_t staged, unsigned grid,
                             cudaStream_t stream, Args... args) {
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

// One AdaGrad SGD epoch for each of n_workers workers, in place on w and
// acc (n_workers, d): worker q visits the n_rows row ids rows[q] (int32,
// -1 for a padding row) in steps of `batch`; X is (m, d) with row stride
// ld.  Worker q is the q-th cluster of `cluster` blocks, each block a slice
// of `width` columns; `staged` picks the body that holds w, acc and a ring
// of X's rows in shared memory (kernels/baselines.py epoch_plan).
int sgd_epoch(const float* X, long long ld, const float* y, const int* rows,
              int n_workers, int n_rows, float* w, float* acc, int d,
              int batch, float eta0, float lam, int loss, int reg,
              int cluster, int width, int staged, void* stream) {
  if (n_workers == 0 || d == 0) return 0;
  if (batch < 1 || !slices_ok(d, cluster, width)) return cudaErrorInvalidValue;
  const size_t smem = layout(SGD, batch, width, staged != 0).bytes;
  auto kern = staged ? sgd_cluster_kernel<true> : sgd_cluster_kernel<false>;
  return (int)launch_clusters(kern, cluster, n_workers, smem,
                              (cudaStream_t)stream, X, ld, y, rows, n_rows,
                              w, acc, d, batch, width, eta0, lam, loss, reg);
}

// One DCD epoch, in place on w (d) and beta (m): the rows perm[0 .. n-1]
// of X (m, d; row stride ld) in turn; xnorm2 (m) holds |x_i|^2, m the
// problem's row count, scale 1 / (2 lam m).  One cluster of `cluster`
// blocks, slices and `staged` as sgd_epoch's.
int dcd_epoch(const float* X, long long ld, const float* y, const int* perm,
              int n, float* w, float* beta, const float* xnorm2, int d,
              float lam, float m, float scale, int cluster, int width,
              int staged, void* stream) {
  if (d == 0) return 0;
  if (!slices_ok(d, cluster, width)) return cudaErrorInvalidValue;
  const size_t smem = layout(DCD, 1, width, staged != 0).bytes;
  auto kern = staged ? dcd_cluster_kernel<true> : dcd_cluster_kernel<false>;
  return (int)launch_clusters(kern, cluster, 1, smem, (cudaStream_t)stream,
                              X, ld, y, perm, n, w, beta, xnorm2, d, width,
                              lam, m, scale);
}

// Bytes of dynamic shared memory of the SGD (kind 0) or DCD (kind 1)
// cluster kernel for a plan, into *bytes (kernels/baselines.py
// epoch_smem must agree).
int baselines_smem(int kind, int batch, int width, int staged, int* bytes) {
  if ((kind != SGD && kind != DCD) || batch < 1 || width < 0)
    return cudaErrorInvalidValue;
  *bytes = (int)layout(kind, kind == DCD ? 1 : batch, width, staged != 0)
               .bytes;
  return 0;
}

// The largest C <= 16 for which the card can hold one cluster of C blocks
// of the staged SGD kernel at the opt-in shared memory, into *c (0: none).
int baselines_max_cluster(int* c) {
  const size_t smem = (size_t)smem_optin();
  auto kern = sgd_cluster_kernel<true>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  *c = 0;
  for (int C = MAX_CLUSTER; C >= 1; --C) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)C);
    cfg.blockDim = dim3(CL_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
    if (e != cudaSuccess) {
      cudaGetLastError();
      continue;
    }
    if (n >= 1) {
      *c = C;
      break;
    }
  }
  return 0;
}

// The exchange alone (exchange_floor_kernel): n_clusters clusters of
// `cluster` blocks, `nsteps` steps; out holds one float per block.
int baselines_exchange_floor(int cluster, int n_clusters, int nsteps,
                             float* out, void* stream) {
  const size_t smem = layout(SGD, 1, 0, false).bytes;
  return (int)launch_clusters(exchange_floor_kernel, cluster, n_clusters,
                              smem, (cudaStream_t)stream, nsteps, out);
}

// The one-block SGD epoch (one block of 1,024 threads per worker, w and
// acc in shared memory when 8 d bytes fit): the A/B's baseline.
int sgd_epoch_one_block(const float* X, long long ld, const float* y,
                        const int* rows, int n_workers, int n_rows, float* w,
                        float* acc, int d, int batch, float eta0, float lam,
                        int loss, int reg, void* stream) {
  if (n_workers == 0 || d == 0) return 0;
  const size_t base = WARPS * sizeof(double) + 2 * (size_t)batch * 4;
  return (int)launch_one_block(
      sgd_epoch_kernel<false>, sgd_epoch_kernel<true>, base,
      2 * (size_t)d * sizeof(float), (unsigned)n_workers,
      (cudaStream_t)stream, X, ld, y, rows, n_rows, w, acc, d, batch, eta0,
      lam, loss, reg);
}

// The one-block DCD epoch: the A/B's baseline.
int dcd_epoch_one_block(const float* X, long long ld, const float* y,
                        const int* perm, int n, float* w, float* beta,
                        const float* xnorm2, int d, float lam, float m,
                        float scale, void* stream) {
  if (d == 0) return 0;
  const size_t base = WARPS * sizeof(double) + sizeof(float);
  return (int)launch_one_block(
      dcd_epoch_kernel<false>, dcd_epoch_kernel<true>, base,
      (size_t)d * sizeof(float), 1u, (cudaStream_t)stream, X, ld, y, perm, n,
      w, beta, xnorm2, d, lam, m, scale);
}

}  // extern "C"
