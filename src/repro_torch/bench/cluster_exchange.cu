// The per-step exchange of a thread-block cluster, alone: what the
// baselines' epoch kernels (csrc/baselines.cu) pay each step to meet their
// C blocks' partial sums, in the forms they could take.  Built and timed by
// bench/epoch_step.py; no wrapper of the port calls it.
//
// exchange_kernel<V, T> runs `nsteps` steps on clusters of C blocks of T
// threads; each step is:
//   0 nothing (the loop's own cost);
//   1 a __syncthreads;
//   2 a cluster.sync() (barrier.cluster.arrive/wait: release/acquire);
//   3 the same barrier relaxed (no memory ordering: not enough to read a
//     peer's shared memory, timed for the barrier's own cost);
//   4 the block's sum of a double per thread (warp butterfly, the warps'
//     sums through shared memory, a __syncthreads, one warp's butterfly);
//   5 4, then the partial in the block's shared memory, a cluster.sync()
//     and the C ranks' partials read from their shared memory
//     (map_shared_rank) in rank order: the pull exchange;
//   6 4, then the partial stored into every rank's slot by st.async,
//     completing on that rank's mbarrier, and a wait on the block's own
//     mbarrier (acquire at cluster scope), the C slots summed in rank
//     order: the push exchange the epoch kernels use.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

__device__ __forceinline__ double warp_allsum(double s) {
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t mapa(uint32_t a, int r) {
  uint32_t o;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(o) : "r"(a), "r"(r));
  return o;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

// A wait of 10 s is a broken exchange: trap instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0, spins = 0;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (++spins % 1024 == 0) {
      if (t0 == 0) t0 = global_ns();
      else if (global_ns() - t0 > 10000000000ull) __trap();
    }
  }
}

template <int V, int T>
__global__ void __launch_bounds__(T, 1) exchange_kernel(int nsteps,
                                                        float* out) {
  constexpr int NW = T / 32;
  __shared__ double part[2];
  __shared__ double red[NW];
  __shared__ double slots[2][16];
  __shared__ __align__(8) uint64_t bars[2];
  const cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const double v = threadIdx.x * 1e-3;
  float acc = 0.0f;
  if (V == 6 && threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(saddr(&bars[k])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cl.sync();
  for (int s = 0; s < nsteps; ++s) {
    double u = v + s;
    if (V == 1) __syncthreads();
    if (V == 2) cl.sync();
    if (V == 3)
      asm volatile("barrier.cluster.arrive.relaxed.aligned;\n"
                   "barrier.cluster.wait.aligned;" ::: "memory");
    if (V >= 4) {
      double p = warp_allsum(v + s);
      if (lane == 0) red[warp] = p;
      __syncthreads();
      if (warp == 0) {
        double t = lane < NW ? red[lane] : 0.0;
        t = warp_allsum(t);
        if (V == 5 && lane == 0) part[s & 1] = t;
        if (V == 6) {
          const uint32_t bar = saddr(&bars[s & 1]);
          if (lane == 0)
            asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                         :: "r"(bar), "r"(C * 8) : "memory");
          __syncwarp();
          if (lane < C)
            asm volatile(
                "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];"
                :: "r"(mapa(saddr(&slots[s & 1][rank]), lane)),
                   "l"(__double_as_longlong(t)), "r"(mapa(bar, lane)) : "memory");
        }
        u = t;
      }
    }
    if (V == 5) {
      cl.sync();
      double t = 0.0;
#pragma unroll
      for (int r = 0; r < 16; ++r)
        if (r < C) t += *cl.map_shared_rank(&part[s & 1], r);
      u = t;
    }
    if (V == 6) {
      mbar_wait(saddr(&bars[s & 1]), (s >> 1) & 1);
      double t = 0.0;
#pragma unroll
      for (int r = 0; r < 16; ++r)
        if (r < C) t += slots[s & 1][r];
      u = t;
    }
    acc += (float)u * 1e-30f;
  }
  cl.sync();
  out[blockIdx.x * T + threadIdx.x] = acc;
}

template <int V, int T>
int run(int C, int n_clusters, int nsteps, float* out, cudaStream_t st) {
  auto k = exchange_kernel<V, T>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute a[1];
  a[0].id = cudaLaunchAttributeClusterDimension;
  a[0].val.clusterDim.x = (unsigned)C;
  a[0].val.clusterDim.y = 1;
  a[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(C * n_clusters));
  cfg.blockDim = dim3(T);
  cfg.stream = st;
  cfg.attrs = a;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, k, nsteps, out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int V>
int run_t(int threads, int C, int n_clusters, int nsteps, float* out,
          cudaStream_t st) {
  if (threads == 256) return run<V, 256>(C, n_clusters, nsteps, out, st);
  if (threads == 512) return run<V, 512>(C, n_clusters, nsteps, out, st);
  if (threads == 1024) return run<V, 1024>(C, n_clusters, nsteps, out, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One launch of exchange_kernel<variant, threads>: n_clusters clusters of
// C blocks, nsteps steps; out holds C * n_clusters * threads floats.
extern "C" int cluster_exchange(int variant, int threads, int C,
                                int n_clusters, int nsteps, float* out,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case 0: return run_t<0>(threads, C, n_clusters, nsteps, out, st);
    case 1: return run_t<1>(threads, C, n_clusters, nsteps, out, st);
    case 2: return run_t<2>(threads, C, n_clusters, nsteps, out, st);
    case 3: return run_t<3>(threads, C, n_clusters, nsteps, out, st);
    case 4: return run_t<4>(threads, C, n_clusters, nsteps, out, st);
    case 5: return run_t<5>(threads, C, n_clusters, nsteps, out, st);
    case 6: return run_t<6>(threads, C, n_clusters, nsteps, out, st);
  }
  return (int)cudaErrorInvalidValue;
}
