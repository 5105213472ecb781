// The two-pass tile step's span passes (csrc/dso_twopass.cu) with the other
// load mechanism, for the A/B of bench/twopass_loads.py: each row's span
// reaches the SM by one bulk copy (cp.async.bulk) into a shared-memory ring
// instead of by the lanes' own 16-byte ld.global.nc loads into registers.
// The library does not hold these kernels; only the A/B builds them.
//
// The ring is csrc/dso_update.cu's dense_stream_kernel's: a producer warp
// copies the spans of 16 rows per stage into 3 stages handed over by
// mbarriers, and 8 consumer warps take 2 rows each of a stage, read their
// 16-byte slots from shared memory and mask them to the row.  The
// arithmetic is the span kernels':
//   primal — X^T alpha and the column counts in registers across all of
//       the CTA's rows, summed over the warps in shared memory (the ring's
//       space, once it is drained) and added with one atomicAdd per
//       column per CTA into acc and cnt;
//   dual — w's slots in registers, X w and the row count of each row, a
//       halving butterfly, and the dual step by one lane per row from
//       alpha_in, ga_in into alpha_out, ga_out.
// Requires a row stride that 4 divides and 0 < D <= 381.

#include "async_copy.cuh"
#include "dso_common.cuh"

namespace {

using namespace dso;

constexpr unsigned FULL = 0xffffffffu;
constexpr int NW = 8;                   // consumer warps per CTA
constexpr int NT = NW * 32;
constexpr int G = 2;                    // rows a warp takes of a stage
constexpr int KS = 3;                   // 16-byte slots per lane
constexpr int SWEEP = 32 * KS * 4;      // virtual columns of a sweep
constexpr int STAGE_ROWS = NW * G;
constexpr int STAGES = 3;
constexpr int PART_SLOTS = 2 * NW * SWEEP / 4;   // primal partials, float4s

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, s))));
}

__device__ __forceinline__ float nnz4(float4 a) {
  return (a.x != 0.0f ? 1.0f : 0.0f) + (a.y != 0.0f ? 1.0f : 0.0f) +
         (a.z != 0.0f ? 1.0f : 0.0f) + (a.w != 0.0f ? 1.0f : 0.0f);
}

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

// The slots of the shared memory before the barriers.
__host__ __device__ __forceinline__ int ring_slots(int ns, bool primal) {
  const int ring = STAGES * STAGE_ROWS * ns;
  return primal && ring < PART_SLOTS ? PART_SLOTS : ring;
}

template <bool PRIMAL>
__global__ void __launch_bounds__(NT + 32)
twopass_bulk_kernel(const float* __restrict__ X, long long ld, int M, int D,
                    const float* __restrict__ vec,  // alpha, or w (dual)
                    float* __restrict__ acc, float* __restrict__ cnt,
                    const float* __restrict__ alpha_in,
                    float* __restrict__ alpha_out,
                    const float* __restrict__ ga_in,
                    float* __restrict__ ga_out, const float* __restrict__ y,
                    const float* __restrict__ rn, float eta, float m,
                    int loss) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int mis = (int)((reinterpret_cast<uintptr_t>(X) >> 2) & 3);
  const int hi = mis + D;               // the row's virtual columns
  const int ns = (hi + 3) / 4;
  const uint32_t row_bytes = 16u * ns;
  const float4* ring = smem4;
  const uint32_t full0 = acp::smem_u32(smem4 + ring_slots(ns, PRIMAL));
  const uint32_t empty0 = full0 + 8 * STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      acp::mbar_init(full0 + 8 * s, 1);
      acp::mbar_init(empty0 + 8 * s, NW);
    }
    acp::mbar_init_fence();
  }
  __syncthreads();
  const int n_blocks = (M + STAGE_ROWS - 1) / STAGE_ROWS;

  if (warp == NW) {
    // ---------------------------------------------------- producer --
    if (lane == 0) {
      int t = 0;
      for (int j = blockIdx.x; j < n_blocks; j += gridDim.x, ++t) {
        const int s = t % STAGES;
        acp::mbar_wait(empty0 + 8 * s, ((t / STAGES) & 1) ^ 1);
        const int n_live = min(STAGE_ROWS, M - j * STAGE_ROWS);
        acp::mbar_expect_tx(full0 + 8 * s, n_live * row_bytes);
        const uint32_t dst = acp::smem_u32(ring + s * STAGE_ROWS * ns);
        for (int r = 0; r < n_live; ++r)
          acp::bulk_copy(dst + r * row_bytes,
                         X + (long long)(j * STAGE_ROWS + r) * ld - mis,
                         row_bytes, full0 + 8 * s);
      }
    }
    return;
  }

  // ----------------------------------------------------- consumers --
  constexpr int NV = 2 * G;             // dual: X w and the count of G rows
  constexpr int LANES = 32 / NV;        // lanes a finished sum spans
  const int my_r = lane / LANES;
  const bool lead = lane % LANES == 0 && my_r < G;
  float4 s4[KS], c4[KS], w4[KS];
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    s4[k] = c4[k] = w4[k] = zero4();
    if (!PRIMAL) {
      const int u0 = 4 * (lane + 32 * k) - mis;   // column of .x
      w4[k].x = u0 >= 0 && u0 < D ? __ldg(vec + u0) : 0.0f;
      w4[k].y = u0 + 1 >= 0 && u0 + 1 < D ? __ldg(vec + u0 + 1) : 0.0f;
      w4[k].z = u0 + 2 >= 0 && u0 + 2 < D ? __ldg(vec + u0 + 2) : 0.0f;
      w4[k].w = u0 + 3 >= 0 && u0 + 3 < D ? __ldg(vec + u0 + 3) : 0.0f;
    }
  }
  int t = 0;
  for (int j = blockIdx.x; j < n_blocks; j += gridDim.x, ++t) {
    const int s = t % STAGES;
    const int i0 = j * STAGE_ROWS + warp * G;    // this warp's rows
    const int n_live = max(0, min(G, M - i0));   // warp-uniform
    float a[G];
    float a_old = 0.0f, ga_old = 0.0f, yi = 0.0f, rni = 1.0f;
    const bool owner = lead && my_r < n_live;
    if (PRIMAL) {
#pragma unroll
      for (int r = 0; r < G; ++r)
        a[r] = r < n_live ? __ldg(vec + i0 + r) : 0.0f;
    } else if (owner) {
      a_old = alpha_in[i0 + my_r];
      ga_old = ga_in[i0 + my_r];
      yi = y[i0 + my_r];
      rni = rn[i0 + my_r];
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
                      : zero4();
      }
    __syncwarp();
    if (lane == 0) acp::mbar_arrive(empty0 + 8 * s);  // stage read
    if (PRIMAL) {
#pragma unroll
      for (int r = 0; r < G; ++r)
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          s4[k].x = fmaf(x[r][k].x, a[r], s4[k].x);
          s4[k].y = fmaf(x[r][k].y, a[r], s4[k].y);
          s4[k].z = fmaf(x[r][k].z, a[r], s4[k].z);
          s4[k].w = fmaf(x[r][k].w, a[r], s4[k].w);
          c4[k].x += x[r][k].x != 0.0f ? 1.0f : 0.0f;
          c4[k].y += x[r][k].y != 0.0f ? 1.0f : 0.0f;
          c4[k].z += x[r][k].z != 0.0f ? 1.0f : 0.0f;
          c4[k].w += x[r][k].w != 0.0f ? 1.0f : 0.0f;
        }
    } else {
      float v[NV];
#pragma unroll
      for (int r = 0; r < G; ++r) {
        v[r] = 0.0f;
        v[G + r] = 0.0f;
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          v[r] = dot4(x[r][k], w4[k], v[r]);
          v[G + r] += nnz4(x[r][k]);
        }
      }
      // halving butterfly: lane l ends with the sum of value (l * NV) / 32
#pragma unroll
      for (int st = 0; (NV >> st) > 1; ++st) {
        const int half = NV >> (st + 1);
        const bool up = lane & (16 >> st);
#pragma unroll
        for (int i = 0; i < half; ++i)
          v[i] = (up ? v[i + half] : v[i]) +
                 __shfl_xor_sync(FULL, up ? v[i] : v[i + half], 16 >> st);
      }
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1)
        v[0] += __shfl_xor_sync(FULL, v[0], off);
      const float c = __shfl_down_sync(FULL, v[0], 16);  // value G + my_r
      if (owner) {
        float a_new, ga_new;
        dual_update(loss, v[0], a_old, ga_old, yi, c, rni, eta, m, a_new,
                    ga_new);
        alpha_out[i0 + my_r] = a_new;
        ga_out[i0 + my_r] = ga_new;
      }
    }
  }
  if (!PRIMAL) return;

  // the CTA's column partials, in the drained ring (a named barrier of the
  // consumers: the producer warp has left)
  float* part = reinterpret_cast<float*>(smem4);
  asm volatile("bar.sync 1, %0;\n" :: "n"(NT) : "memory");
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    reinterpret_cast<float4*>(part + warp * SWEEP)[lane + 32 * k] = s4[k];
    reinterpret_cast<float4*>(part + (NW + warp) * SWEEP)[lane + 32 * k] =
        c4[k];
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(NT) : "memory");
  for (int u = threadIdx.x; u < SWEEP; u += NT) {
    const int col = u - mis;
    if (col < 0 || col >= D) continue;
    float vs = 0.0f, vc = 0.0f;
#pragma unroll
    for (int wi = 0; wi < NW; ++wi) {
      vs += part[wi * SWEEP + u];
      vc += part[(NW + wi) * SWEEP + u];
    }
    if (vs != 0.0f) atomicAdd(acc + col, vs);
    if (vc != 0.0f) atomicAdd(cnt + col, vc);
  }
}

template <bool PRIMAL>
int launch(const float* X, long long ld, int M, int D, const float* vec,
           float* acc, float* cnt, const float* alpha_in, float* alpha_out,
           const float* ga_in, float* ga_out, const float* y, const float* rn,
           float eta, float m, int loss, void* stream) {
  if (ld % 4 != 0 || D <= 0 || D + 3 > SWEEP)
    return (int)cudaErrorInvalidValue;
  if (M <= 0) return (int)cudaGetLastError();
  const int ns_max = (D + 6) / 4;       // slots of a span at mis = 3
  const size_t smem = (size_t)ring_slots(ns_max, PRIMAL) * 16 + 16 * STAGES;
  int per_sm = 0;
  const cudaError_t e =
      ctas_per_sm<twopass_bulk_kernel<PRIMAL>>(NT + 32, smem, &per_sm);
  if (e != cudaSuccess) return (int)e;
  const long long need = blocks_for(M, STAGE_ROWS);
  long long fit = (long long)per_sm * sm_count();
  if (fit < 1) fit = 1;
  twopass_bulk_kernel<PRIMAL>
      <<<(unsigned)(need < fit ? need : fit), NT + 32, smem,
         (cudaStream_t)stream>>>(X, ld, M, D, vec, acc, cnt, alpha_in,
                                 alpha_out, ga_in, ga_out, y, rn, eta, m,
                                 loss);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// As dso_twopass_primal on the span kernels: acc and cnt (D,) zero on entry.
int twopass_bulk_primal(const float* X, long long ld, int M, int D,
                        const float* alpha, float* acc, float* cnt,
                        void* stream) {
  return launch<true>(X, ld, M, D, alpha, acc, cnt, nullptr, nullptr,
                      nullptr, nullptr, nullptr, nullptr, 0.0f, 1.0f, 0,
                      stream);
}

// As dso_twopass_dual on the span kernels.
int twopass_bulk_dual(const float* X, long long ld, int M, int D,
                      const float* w, const float* alpha_in, float* alpha_out,
                      const float* ga_in, float* ga_out, const float* y,
                      const float* rn, float eta, float m, int loss,
                      void* stream) {
  return launch<false>(X, ld, M, D, w, nullptr, nullptr, alpha_in, alpha_out,
                       ga_in, ga_out, y, rn, eta, m, loss, stream);
}

}  // extern "C"
