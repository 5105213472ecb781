// Hand-written Hopper (sm_90a) kernels for the paper-exact serial DSO epoch.
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
// earlier step on its row or its column may have written, and nothing
// else: the epoch is a dependency graph, not a chain.
//
// serial_rounds_kernel (the main path) takes the visit order in windows of
// W = S x threads x blocks consecutive steps, S per thread (coalesced on
// `order`; the next window's indices are in flight while the current one
// runs, two windows deep so no load waits on another).  Inside a window
// it runs rounds: every pending step atomicMins its window position into
// a tag of its row and one of its column; barrier; a step that holds both
// tags is ready and goes into its block's queue; barrier; the block's
// first warps run the queued steps; barrier, which also asks whether a
// step is pending.  A step runs only once every earlier step on its row
// and on its column has run, and no later one has, so every coordinate
// sees the same reads and writes, in the same order, as the one-thread
// loop: the result is that loop's, bit for bit.  A window's rounds are
// its local dependency depth (kernels/dso_serial.py serial_rounds is the
// CPU model).  A tag key holds the round's stamp as well as the
// position, so a later round's key is smaller and overwrites a stale tag:
// the tags are cleared only when the 16-bit stamp wraps.  Two layouts (the
// plan, kernels/dso_serial.py serial_plan, picks):
//   staged: ONE block; the tags, w, gw, the column counts, alpha, ga, y
//     and the row counts in shared memory (16 d + 20 m bytes besides the
//     queue); every access of a round is a shared-memory one.
//   global: a thread-block cluster of up to 16 blocks; the state packed
//     into a record per row (alpha, ga, y, rn) and per column (w, gw, cn),
//     the tags and two round counters, all in a global scratch the
//     wrapper allocates (L2-resident); the barriers are the cluster's
//     (release / acquire), and a block counts itself into the round's
//     counter when it has a step pending.  One SM makes about one
//     scattered L2 access a cycle, and a step makes a dozen (tags,
//     records, indices), so past shared memory the rounds are spread over
//     the cluster's SMs, and the records make a step's operands two
//     16-byte loads.
//
// What bounds it.  Not bytes (16 per nonzero plus 24 per row and 20 per
// column, read or written once: well under a microsecond at phase 3s's
// shape, 0.018 ms at real-sim's) but the rounds: the epoch's dependency
// depth summed over windows, each round a chain of tag atomics, a tag
// read, the operands, the Eq.-8 arithmetic and three barriers, and, on
// the global layout, the round's scattered L2 accesses.  The floor is the
// epoch's depth (its waves) times the Eq.-8 step alone
// (step_latency_kernel chains steps on registers).
//
// serial_epoch_kernel, the design before (one thread walks the whole
// order, one chain of dependent global loads per step), stays as the C
// entry dso_serial_epoch_one_thread for the A/B only.
//
// Arithmetic, both kernels' (one __device__ function, eq8_step): the
// reference's, as its compiled scan runs it on the CPU (kernels/
// dso_serial.py says which operations): x / m as x * (1 / m), fmaf
// wherever XLA contracts a fused multiply-add, and every other product,
// quotient and sum rounded on its own (__fmul_rn and friends, so nvcc
// contracts nothing else); AdaGrad's rsqrt is 1 / sqrt, each
// IEEE-rounded, and logistic's log and log1p are taken in double and
// rounded to float, as the plain version computes them, so the kernels
// and the plain version agree bit for bit but for a rare double rounding.

#include <climits>

#include <cooperative_groups.h>

#include "dso_common.cuh"

namespace {

using namespace dso;
namespace cg = cooperative_groups;

// dual_grad with logistic's logs in double, rounded to float.
__device__ __forceinline__ float serial_dual_grad(int loss, float a,
                                                  float y) {
  if (loss != LOGISTIC) return dual_grad(loss, a, y);
  const double b = (double)clampf(__fmul_rn(y, a), LOG_LO, LOG_HI);
  return __fmul_rn(y, __fsub_rn((float)log(b), (float)log1p(-b)));
}

// The epoch's scalars.
struct Eq8 {
  float eta, lam, m, inv_m, w_lo, w_hi;
  int loss, reg, adagrad;
};

// One Eq.-8 step of the nonzero x at (i, j), in place on its operands
// (gwj, gai only with AdaGrad).
__device__ __forceinline__ void eq8_step(const Eq8& p, float x, float yi,
                                         float rni, float cnj, float& wj,
                                         float& ai, float& gwj, float& gai) {
  // g_w = lam * phi'(w_j) / |Omega-bar_j| - alpha_i * x / m
  const float g_w = fmaf(-__fmul_rn(ai, x), p.inv_m,
                         __fdiv_rn(__fmul_rn(p.lam, reg_grad(p.reg, wj)),
                                   cnj));
  // g_a = -l*'(-alpha_i) / (m |Omega_i|) - w_j * x / m
  const float g_a = fmaf(-__fmul_rn(wj, x), p.inv_m,
                         __fdiv_rn(-serial_dual_grad(p.loss, ai, yi),
                                   __fmul_rn(p.m, rni)));
  float w_new, a_new;
  if (p.adagrad) {
    gwj = fmaf(g_w, g_w, gwj);
    gai = fmaf(g_a, g_a, gai);
    w_new = fmaf(-__fmul_rn(p.eta, g_w),
                 __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(gwj, ADA_EPS))), wj);
    a_new = fmaf(__fmul_rn(p.eta, g_a),
                 __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(gai, ADA_EPS))), ai);
  } else {
    w_new = fmaf(g_w, -p.eta, wj);
    a_new = fmaf(g_a, p.eta, ai);
  }
  wj = clampf(w_new, p.w_lo, p.w_hi);
  ai = project_alpha(p.loss, a_new, yi);
}

__global__ void serial_epoch_kernel(
    const int* __restrict__ ii, const int* __restrict__ jj,
    const float* __restrict__ vv, const int* __restrict__ order, int nnz,
    float* w, float* alpha, float* gw, float* ga,
    const float* __restrict__ y, const float* __restrict__ rn,
    const float* __restrict__ cn, Eq8 p) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  for (int k = 0; k < nnz; ++k) {
    const int e = order[k];
    const int i = ii[e], j = jj[e];
    float wj = w[j], ai = alpha[i];
    float gwj = p.adagrad ? gw[j] : 0.0f, gai = p.adagrad ? ga[i] : 0.0f;
    eq8_step(p, vv[e], y[i], rn[i], cn[j], wj, ai, gwj, gai);
    if (p.adagrad) {
      gw[j] = gwj;
      ga[i] = gai;
    }
    w[j] = wj;
    alpha[i] = ai;
  }
}

// Most threads a block of serial_rounds_kernel<S> may have: S steps per
// thread, with the next window's in registers, fit the register file.
__host__ __device__ constexpr int rounds_max_threads(int S) {
  return S <= 4 ? 1024 : 4096 / S;
}

constexpr int MAX_CLUSTER = 16;       // blocks of the global kernel

// Dynamic shared bytes of a block: the queue of a round's ready steps (i,
// j, x for each of the block's S x threads slots) and its two counters;
// staged, also the m + d tags, w, gw, cn (d floats) and alpha, ga, y, rn
// (m floats).
__host__ __device__ constexpr long long rounds_smem(int m, int d, int S,
                                                   int threads,
                                                   bool staged) {
  return 12LL * S * threads + 16 +
         (staged ? 4LL * ((long long)m + d) + 4LL * (3LL * d + 4LL * m)
                 : 0LL);
}

// Bytes of the global kernel's scratch: a record per row (alpha, ga, y,
// rn) and per column (w, gw, cn, 0), the m + d tags, two round counters.
__host__ __device__ constexpr long long rounds_scratch(int m, int d) {
  return 20LL * ((long long)m + d) + 16;
}

constexpr unsigned NO_TAG = 0xFFFFFFFFu;
constexpr int STAMPS = 1 << 16;       // rounds between two clearings of the tags

// A step's tag key in round r: the round's stamp in the high half,
// inverted, so a later round's key is smaller and atomicMin overwrites an
// earlier round's tag (the tags are cleared only when the stamp wraps,
// every STAMPS rounds); the window position (< 2^16: a window holds at
// most 16 x 256 x 16 steps) in the low half.
__device__ __forceinline__ unsigned tag_key(int r, int pos) {
  return (unsigned)(STAMPS - 1 - (r & (STAMPS - 1))) << 16 | (unsigned)pos;
}

template <bool STAGED>
__device__ __forceinline__ unsigned load_tag(const unsigned* p) {
  if (STAGED) return *p;
  return __ldcg(p);          // written by atomics at L2: bypass L1
}

// Every thread of the kernel: the block, or the cluster of the global
// kernel (release / acquire: the rounds' writes are seen after it).
template <bool STAGED>
__device__ __forceinline__ void sync_all() {
  if (STAGED)
    __syncthreads();
  else
    cg::this_cluster().sync();
}

template <int S>
__device__ __forceinline__ void load_order(const int* __restrict__ order,
                                           int nnz, long long start, int G,
                                           int g, int (&e)[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const long long k = start + (long long)s * G + g;
    e[s] = k < nnz ? order[k] : -1;
  }
}

template <int S>
__device__ __forceinline__ void gather(const int* __restrict__ ii,
                                       const int* __restrict__ jj,
                                       const float* __restrict__ vv,
                                       const int (&e)[S], int (&i)[S],
                                       int (&j)[S], float (&x)[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    i[s] = e[s] >= 0 ? ii[e[s]] : -1;
    j[s] = e[s] >= 0 ? jj[e[s]] : -1;
    x[s] = e[s] >= 0 ? vv[e[s]] : 0.0f;
  }
}

// STAGED: one block; the tags and the state in shared memory.  Else a
// cluster of gridDim.x blocks (launched as one); the state packed into
// records, the tags and the round counters in `scratch`
// (rounds_scratch bytes), all in global memory.  Slot s of thread g (of
// G in the kernel) is step s * G + g of the window.
template <int S, bool STAGED>
__global__ void __launch_bounds__(S <= 4 ? 1024 : 4096 / S, 1)
serial_rounds_kernel(const int* __restrict__ ii, const int* __restrict__ jj,
                     const float* __restrict__ vv,
                     const int* __restrict__ order, int nnz, float* w,
                     float* alpha, float* gw, float* ga,
                     const float* __restrict__ y,
                     const float* __restrict__ rn,
                     const float* __restrict__ cn, int m, int d,
                     void* scratch, int* rounds_out, Eq8 p) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x, t = threadIdx.x;
  const int G = T * (STAGED ? 1 : (int)gridDim.x);
  const int g = (STAGED ? 0 : (int)blockIdx.x) * T + t;
  const long long W = (long long)S * G;
  int* qi = reinterpret_cast<int*>(smem);      // the round's ready steps
  int* qj = qi + S * T;
  float* qx = reinterpret_cast<float*>(qj + S * T);
  int* qn = reinterpret_cast<int*>(qx + S * T);  // two parities
  unsigned *TR, *TC;                             // row and column tags
  float *W_ = nullptr, *GW = nullptr, *CN = nullptr, *AL = nullptr,
        *GA = nullptr, *Y = nullptr, *RN = nullptr;     // staged
  float4 *rows = nullptr, *cols = nullptr;       // global
  int* cnt = nullptr;        // global: blocks with a step pending, by parity
  if (t < 2) qn[t] = 0;
  if (STAGED) {
    TR = reinterpret_cast<unsigned*>(qn + 4);
    W_ = reinterpret_cast<float*>(TR + m + d);
    GW = W_ + d;
    CN = GW + d;
    AL = CN + d;
    GA = AL + m;
    Y = GA + m;
    RN = Y + m;
    for (int q = t; q < d; q += T) {
      W_[q] = w[q];
      GW[q] = p.adagrad ? gw[q] : 0.0f;
      CN[q] = cn[q];
    }
    for (int q = t; q < m; q += T) {
      AL[q] = alpha[q];
      GA[q] = p.adagrad ? ga[q] : 0.0f;
      Y[q] = y[q];
      RN[q] = rn[q];
    }
  } else {
    rows = reinterpret_cast<float4*>(scratch);
    cols = rows + m;
    TR = reinterpret_cast<unsigned*>(cols + d);
    cnt = reinterpret_cast<int*>(TR + m + d);
    for (int q = g; q < m; q += G)
      rows[q] = make_float4(alpha[q], p.adagrad ? ga[q] : 0.0f, y[q], rn[q]);
    for (int q = g; q < d; q += G)
      cols[q] = make_float4(w[q], p.adagrad ? gw[q] : 0.0f, cn[q], 0.0f);
    if (g < 2) cnt[g] = 0;
  }
  TC = TR + m;
  for (int q = g; q < m + d; q += G) TR[q] = NO_TAG;

  // two windows in flight: ne holds the order of the window after next,
  // (ni, nj, nx) the next window's coordinates
  int ne[S], ni[S], nj[S];
  float nx[S];
  load_order<S>(order, nnz, 0, G, g, ne);
  gather<S>(ii, jj, vv, ne, ni, nj, nx);
  load_order<S>(order, nnz, W, G, g, ne);
  sync_all<STAGED>();

  int r = 0, par = 0;        // rounds so far; the round's parity
  for (long long base = 0; base < nnz; base += W) {
    int ci[S], cj[S];
    float cx[S];
    unsigned pend = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      ci[s] = ni[s];
      cj[s] = nj[s];
      cx[s] = nx[s];
      if (ci[s] >= 0) pend |= 1u << s;
    }
    gather<S>(ii, jj, vv, ne, ni, nj, nx);
    load_order<S>(order, nnz, base + 2 * W, G, g, ne);
    for (int rw = 1;; ++rw, ++r) {
      if (r % STAMPS == 0 && r > 0) {  // the stamp wraps: clear the tags
        for (int q = g; q < m + d; q += G) TR[q] = NO_TAG;
        sync_all<STAGED>();
      }
      if (t == 0) qn[par ^ 1] = 0;   // read in the round before
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (pend >> s & 1u) {
          atomicMin(TR + ci[s], tag_key(r, s * G + g));
          atomicMin(TC + cj[s], tag_key(r, s * G + g));
        }
      sync_all<STAGED>();
      if (!STAGED && g == 0) cnt[par ^ 1] = 0;  // read in the round before
      // a step that holds both its tags is ready: into the block's queue
      unsigned ready = 0;
#pragma unroll
      for (int s = 0; s < S; ++s)
        if ((pend >> s & 1u) &&
            load_tag<STAGED>(TR + ci[s]) == tag_key(r, s * G + g) &&
            load_tag<STAGED>(TC + cj[s]) == tag_key(r, s * G + g))
          ready |= 1u << s;
      pend &= ~ready;
      if (ready) {
        int at = atomicAdd(qn + par, __popc(ready));
#pragma unroll
        for (int s = 0; s < S; ++s)
          if (ready >> s & 1u) {
            qi[at] = ci[s];
            qj[at] = cj[s];
            qx[at] = cx[s];
            ++at;
          }
      }
      __syncthreads();
      // the ready steps touch distinct rows and columns: the first warps
      // run them
      const int n = qn[par];
      for (int q = t; q < n; q += T) {
        const int i = qi[q], j = qj[q];
        if (STAGED) {
          float wj = W_[j], ai = AL[i], gwj = GW[j], gai = GA[i];
          eq8_step(p, qx[q], Y[i], RN[i], CN[j], wj, ai, gwj, gai);
          W_[j] = wj;
          GW[j] = gwj;
          AL[i] = ai;
          GA[i] = gai;
        } else {
          const float4 row = __ldcg(rows + i), col = __ldcg(cols + j);
          float wj = col.x, ai = row.x, gwj = col.y, gai = row.y;
          eq8_step(p, qx[q], row.z, row.w, col.z, wj, ai, gwj, gai);
          *reinterpret_cast<float2*>(rows + i) = make_float2(ai, gai);
          *reinterpret_cast<float2*>(cols + j) = make_float2(wj, gwj);
        }
      }
      int more = __syncthreads_or(pend != 0u);
      if (!STAGED) {
        if (t == 0 && more) atomicAdd(cnt + par, 1);
        cg::this_cluster().sync();
        more = __ldcg(cnt + par);
      }
      par ^= 1;
      if (!more) {
        ++r;
        break;
      }
      if (rw > W) __trap();  // every round runs the window's first pending
    }
  }
  if (STAGED) {
    for (int q = t; q < d; q += T) {
      w[q] = W_[q];
      if (p.adagrad) gw[q] = GW[q];
    }
    for (int q = t; q < m; q += T) {
      alpha[q] = AL[q];
      if (p.adagrad) ga[q] = GA[q];
    }
  } else {
    for (int q = g; q < m; q += G) {
      const float4 row = __ldcg(rows + q);
      alpha[q] = row.x;
      if (p.adagrad) ga[q] = row.y;
    }
    for (int q = g; q < d; q += G) {
      const float4 col = __ldcg(cols + q);
      w[q] = col.x;
      if (p.adagrad) gw[q] = col.y;
    }
  }
  if (rounds_out != nullptr && g == 0) *rounds_out = r;
}

// The Eq.-8 step's latency: one thread chains nsteps steps on operands in
// registers, each step's (w, alpha, gw, ga) the next one's input.
__global__ void step_latency_kernel(int nsteps, float x, float yi, float rni,
                                    float cnj, Eq8 p, float* out) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  float wj = out[0], ai = out[1], gwj = out[2], gai = out[3];
  for (int k = 0; k < nsteps; ++k)
    eq8_step(p, x, yi, rni, cnj, wj, ai, gwj, gai);
  out[0] = wj;
  out[1] = ai;
  out[2] = gwj;
  out[3] = gai;
}

Eq8 make_eq8(float eta, float lam, float m, float w_lo, float w_hi,
             int loss, int reg, int adagrad) {
  Eq8 p;
  p.eta = eta;
  p.lam = lam;
  p.m = m;
  p.inv_m = 1.0f / m;        // IEEE division on the host: float32(1 / m)
  p.w_lo = w_lo;
  p.w_hi = w_hi;
  p.loss = loss;
  p.reg = reg;
  p.adagrad = adagrad;
  return p;
}

// The launch configuration of serial_rounds_kernel<S, STAGED> on
// `cluster` blocks (a cluster, when not staged), with its shared memory
// allowed; refused when the card cannot hold it.
template <int S, bool STAGED>
cudaError_t rounds_config(int m_rows, int d, int threads, int cluster,
                          cudaStream_t stream, cudaLaunchConfig_t* cfg,
                          cudaLaunchAttribute* attr) {
  if (threads < 32 || threads % 32 || threads > rounds_max_threads(S) ||
      cluster < 1 || cluster > MAX_CLUSTER || (STAGED && cluster != 1))
    return cudaErrorInvalidValue;
  const long long smem = rounds_smem(m_rows, d, S, threads, STAGED);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (smem > optin) return cudaErrorInvalidValue;
  auto kern = serial_rounds_kernel<S, STAGED>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && !STAGED)
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  *cfg = {};
  cfg->gridDim = dim3((unsigned)cluster);
  cfg->blockDim = dim3((unsigned)threads);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = stream;
  if (!STAGED) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
    int fits = 0;
    e = cudaOccupancyMaxActiveClusters(&fits, kern, cfg);
    if (e != cudaSuccess) return e;
    if (fits < 1) return cudaErrorInvalidConfiguration;
  }
  return cudaSuccess;
}

template <int S, bool STAGED>
cudaError_t launch_rounds(const int* ii, const int* jj, const float* vv,
                          const int* order, int nnz, float* w, float* alpha,
                          float* gw, float* ga, const float* y,
                          const float* rn, const float* cn, int m_rows,
                          int d, void* scratch, long long scratch_bytes,
                          int* rounds, Eq8 p, int threads, int cluster,
                          cudaStream_t stream) {
  if (!STAGED &&
      (scratch == nullptr || scratch_bytes < rounds_scratch(m_rows, d)))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = rounds_config<S, STAGED>(m_rows, d, threads, cluster,
                                           stream, &cfg, attr);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, serial_rounds_kernel<S, STAGED>, ii, jj, vv,
                         order, nnz, w, alpha, gw, ga, y, rn, cn, m_rows, d,
                         scratch, rounds, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One serial epoch in visit order `order` (nnz,) over the coordinates
// (ii, jj, vv); in place on w, gw (d,) and alpha, ga (m_rows,): windows of
// `slots` (1, 2, 4, 8 or 16) steps per thread of `threads`; `staged`: one
// block, the state in shared memory; else a cluster of `cluster` blocks,
// the state in global memory, in `scratch` (`scratch_bytes`, at least
// rounds_scratch(m_rows, d); any contents).  `rounds` (nullable) receives
// the number of rounds the epoch took.
int dso_serial_epoch(const int* ii, const int* jj, const float* vv,
                     const int* order, int nnz, float* w, float* alpha,
                     float* gw, float* ga, const float* y, const float* rn,
                     const float* cn, int m_rows, int d, void* scratch,
                     long long scratch_bytes, int* rounds, float eta,
                     float lam, float m, float w_lo, float w_hi, int loss,
                     int reg, int adagrad, int threads, int slots,
                     int cluster, int staged, void* stream) {
  const Eq8 p = make_eq8(eta, lam, m, w_lo, w_hi, loss, reg, adagrad);
  const cudaStream_t st = (cudaStream_t)stream;
#define DSO_ROUNDS(S_)                                                      \
  case S_:                                                                  \
    return (int)(staged ? launch_rounds<S_, true>(                          \
                              ii, jj, vv, order, nnz, w, alpha, gw, ga, y,  \
                              rn, cn, m_rows, d, scratch, scratch_bytes,    \
                              rounds, p, threads, cluster, st)              \
                        : launch_rounds<S_, false>(                         \
                              ii, jj, vv, order, nnz, w, alpha, gw, ga, y,  \
                              rn, cn, m_rows, d, scratch, scratch_bytes,    \
                              rounds, p, threads, cluster, st));
  switch (slots) {
    DSO_ROUNDS(1)
    DSO_ROUNDS(2)
    DSO_ROUNDS(4)
    DSO_ROUNDS(8)
    DSO_ROUNDS(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DSO_ROUNDS
}

// Dynamic shared bytes of a block of the epoch at (m_rows, d, slots,
// threads, staged).
int dso_serial_smem(int m_rows, int d, int slots, int threads, int staged,
                    int* bytes) {
  const long long n = rounds_smem(m_rows, d, slots, threads, staged != 0);
  if (n > INT_MAX) return (int)cudaErrorInvalidValue;
  *bytes = (int)n;
  return 0;
}

// The largest cluster of the global epoch kernel at (slots, threads) the
// card can hold (0: none).
int dso_serial_max_cluster(int slots, int threads, int* c) {
  *c = 0;
  for (int C = MAX_CLUSTER; C >= 1; --C) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cudaError_t e = cudaErrorInvalidValue;
    switch (slots) {
      case 1: e = rounds_config<1, false>(0, 0, threads, C, 0, &cfg, attr);
        break;
      case 2: e = rounds_config<2, false>(0, 0, threads, C, 0, &cfg, attr);
        break;
      case 4: e = rounds_config<4, false>(0, 0, threads, C, 0, &cfg, attr);
        break;
      case 8: e = rounds_config<8, false>(0, 0, threads, C, 0, &cfg, attr);
        break;
      case 16: e = rounds_config<16, false>(0, 0, threads, C, 0, &cfg, attr);
        break;
      default: return (int)cudaErrorInvalidValue;
    }
    if (e == cudaSuccess) {
      *c = C;
      return 0;
    }
    cudaGetLastError();
  }
  return 0;
}

// The same epoch on one thread (the design before; the A/B baseline).
int dso_serial_epoch_one_thread(const int* ii, const int* jj, const float* vv,
                                const int* order, int nnz, float* w,
                                float* alpha, float* gw, float* ga,
                                const float* y, const float* rn,
                                const float* cn, float eta, float lam,
                                float m, float w_lo, float w_hi, int loss,
                                int reg, int adagrad, void* stream) {
  serial_epoch_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      ii, jj, vv, order, nnz, w, alpha, gw, ga, y, rn, cn,
      make_eq8(eta, lam, m, w_lo, w_hi, loss, reg, adagrad));
  return (int)cudaGetLastError();
}

// nsteps chained Eq.-8 steps of the nonzero x on one thread, from and
// into out[0..3] = (w_j, alpha_i, gw_j, ga_i).
int dso_serial_step_latency(int nsteps, float x, float y, float rn, float cn,
                            float eta, float lam, float m, float w_lo,
                            float w_hi, int loss, int reg, int adagrad,
                            float* out, void* stream) {
  step_latency_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      nsteps, x, y, rn, cn,
      make_eq8(eta, lam, m, w_lo, w_hi, loss, reg, adagrad), out);
  return (int)cudaGetLastError();
}

}  // extern "C"
