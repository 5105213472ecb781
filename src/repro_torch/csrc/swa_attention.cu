// Hand-written Hopper (sm_90a) kernel for sliding-window attention on bf16
// data that the tensor-core kernel (swa_attention_tc.cu) cannot read in
// place: a head size that is not a multiple of 8, or q, k, v that are not
// 16-byte aligned.  That kernel reads through TMA, which needs a 16-byte
// aligned base and a row stride that is a multiple of 16 bytes, and nothing
// else: its tensor maps already zero-fill columns past Dh.  So this route
// (the "packed" route of ops.swa_attention; kernels/swa_attention.py
// swa_route names the choice) copies q, k and v into a workspace of rows of
// ld = roundup(Dh, 8) bf16 and runs the tensor-core kernel there, with the
// softmax scale of the true Dh.  float32 takes swa_attention_tf32x3.cu.
//
// Replaces, for those inputs, the reference's Pallas TPU kernel
//   src/repro/kernels/swa_attention.py _swa_kernel (:32), launched by
//   swa_attention (:81) through its pallas_call (:102).
// What the attention computes is stated in swa_attention_tc.cu.
//
// The pack kernel: one thread per 8 columns of a workspace row, 8 two-byte
// loads (the source may sit at any even address) and one 16-byte store;
// columns past Dh are written as 0 though no read of them follows.  The
// lanes of a warp take consecutive groups, so a warp reads and writes
// consecutive bytes.  One launch packs all three tensors (grid.y picks q, k
// or v).  Bound: bytes, q, k and v read once and written once; 3 x 117 MB
// at zamba2-7b's T 16,384 is ~0.2 ms at 3.35 TB/s beside the attention's
// ~7 ms.
//
// The backward (swa_attention_bwd_packed) packs q, k, v and the upstream
// gradient the same way (a second launch for the one tensor) and runs the
// bf16 backward kernels of swa_attention_bwd.cu on the copies; they write
// the gradients at the true Dh.
//
// The entry points have a plain C interface for ctypes and return
// cudaGetLastError() after a pack's launch when it fails, else what the
// tensor-core (or backward) entry point returns.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" int swa_attention_tc_fwd(const void* q, const void* k,
                                    const void* v, void* out, int B, int Hq,
                                    int Hkv, int Tq, int Tk, int Dh, int ld,
                                    long long window, int causal,
                                    long long q_offset, float scale,
                                    float* lse, void* stream);
extern "C" int swa_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const float* lse, float* dsum, void* dq,
                                 void* dk, void* dv, int B, int Hq, int Hkv,
                                 int Tq, int Tk, int Dh, int ld,
                                 long long window, int causal,
                                 long long q_offset, float scale,
                                 int is_bf16, void* stream);

namespace {

constexpr int PACK_THREADS = 256;
constexpr int VEC = 8;                  // bf16 per 16-byte store
constexpr int PACK_MAX_BLOCKS = 8192;   // grid-stride past this

// Rows of Dh bf16 of q, k or v (blockIdx.y 0, 1, 2), contiguous, into the
// workspace ws: q's rows_q rows of ld elements, then k's and v's rows_kv
// rows each.  groups_q, groups_kv: 16-byte groups of each tensor
// (rows * ld / 8, below 2^31).
__global__ void __launch_bounds__(PACK_THREADS)
swa_pack_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                const uint16_t* __restrict__ v, uint16_t* __restrict__ ws,
                int groups_q, int groups_kv, int Dh, int ld) {
  const int which = blockIdx.y;
  const uint16_t* src = which == 0 ? q : (which == 1 ? k : v);
  const int n = which == 0 ? groups_q : groups_kv;
  uint16_t* dst = ws + (which == 0 ? 0ll
                                   : (long long)(groups_q + (which - 1) *
                                                            (long long)
                                                                groups_kv) *
                                         VEC);
  const int per_row = ld / VEC;
  for (int t = blockIdx.x * PACK_THREADS + threadIdx.x; t < n;
       t += gridDim.x * PACK_THREADS) {
    const int r = t / per_row;
    const int c0 = (t - r * per_row) * VEC;
    const uint16_t* s = src + (long long)r * Dh + c0;
    uint32_t w[VEC / 2];
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      const uint32_t lo = c0 + 2 * i < Dh ? s[2 * i] : 0u;
      const uint32_t hi = c0 + 2 * i + 1 < Dh ? s[2 * i + 1] : 0u;
      w[i] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(dst + (long long)t * VEC) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Pack q, k, v (grid.y 3) into ws at rows of ld; then, when dout is
// given, dout into the rows after them (a second launch of one tensor).
cudaError_t pack(const void* q, const void* k, const void* v,
                 const void* dout, void* ws, long long groups_q,
                 long long groups_kv, int Dh, int ld, cudaStream_t st) {
  if (groups_q > INT_MAX || groups_kv > INT_MAX) return cudaErrorInvalidValue;
  const long long most = groups_q > groups_kv ? groups_q : groups_kv;
  long long blocks = (most + PACK_THREADS - 1) / PACK_THREADS;
  if (blocks > PACK_MAX_BLOCKS) blocks = PACK_MAX_BLOCKS;
  swa_pack_kernel<<<dim3((unsigned)blocks, 3), PACK_THREADS, 0, st>>>(
      (const uint16_t*)q, (const uint16_t*)k, (const uint16_t*)v,
      (uint16_t*)ws, (int)groups_q, (int)groups_kv, Dh, ld);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || dout == nullptr) return e;
  blocks = (groups_q + PACK_THREADS - 1) / PACK_THREADS;
  if (blocks > PACK_MAX_BLOCKS) blocks = PACK_MAX_BLOCKS;
  const uint16_t* d = (const uint16_t*)dout;
  swa_pack_kernel<<<dim3((unsigned)blocks, 1), PACK_THREADS, 0, st>>>(
      d, d, d, (uint16_t*)ws + (groups_q + 2 * groups_kv) * VEC,
      (int)groups_q, 0, Dh, ld);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Hq, Tq, Dh), k and v (B, Hkv, Tk, Dh), out like q; all contiguous
// bf16, q, k, v at any even address, out 16-byte aligned; 1 <= Dh <= 128,
// Hq % Hkv == 0.  ws: a 16-byte-aligned workspace of (B Hq Tq + 2 B Hkv Tk)
// * roundup(Dh, 8) bf16.  lse: null, or (B, Hq, Tq) float32 for the rows'
// logsumexp (swa_attention_tc_fwd).
int swa_attention_fwd(const void* q, const void* k, const void* v, void* out,
                      void* ws, int B, int Hq, int Hkv, int Tq, int Tk,
                      int Dh, long long window, int causal,
                      long long q_offset, float scale, float* lse,
                      void* stream) {
  if (B <= 0 || Hq <= 0 || Tq <= 0) return (int)cudaGetLastError();
  if (Dh <= 0 || Dh > 128 || Tk <= 0 || Hkv <= 0 || ws == nullptr ||
      reinterpret_cast<uintptr_t>(ws) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int ld = (Dh + VEC - 1) / VEC * VEC;
  const long long groups_q = (long long)B * Hq * Tq * (ld / VEC);
  const long long groups_kv = (long long)B * Hkv * Tk * (ld / VEC);
  const cudaError_t e = pack(q, k, v, nullptr, ws, groups_q, groups_kv, Dh,
                             ld, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  const __nv_bfloat16* wq = (const __nv_bfloat16*)ws;
  const __nv_bfloat16* wk = wq + groups_q * VEC;
  const __nv_bfloat16* wv = wk + groups_kv * VEC;
  return swa_attention_tc_fwd(wq, wk, wv, out, B, Hq, Hkv, Tq, Tk, Dh, ld,
                              window, causal, q_offset, scale, lse, stream);
}

// The packed route's backward: q, k, v and dout (like q) packed as the
// forward packs q, k, v, then swa_attention_bwd on the copies at the true
// Dh's scale, which writes dq, dk, dv (rows of Dh, contiguous) directly.
// o and lse are the forward's; dsum (B, Hq, Tq) float32 scratch; ws: a
// 16-byte-aligned workspace of (2 B Hq Tq + 2 B Hkv Tk) * roundup(Dh, 8)
// bf16.
int swa_attention_bwd_packed(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const float* lse, float* dsum, void* dq,
                             void* dk, void* dv, void* ws, int B, int Hq,
                             int Hkv, int Tq, int Tk, int Dh,
                             long long window, int causal,
                             long long q_offset, float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Tq <= 0) return (int)cudaGetLastError();
  if (Dh <= 0 || Dh > 128 || Tk <= 0 || Hkv <= 0 || ws == nullptr ||
      reinterpret_cast<uintptr_t>(ws) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int ld = (Dh + VEC - 1) / VEC * VEC;
  const long long groups_q = (long long)B * Hq * Tq * (ld / VEC);
  const long long groups_kv = (long long)B * Hkv * Tk * (ld / VEC);
  const cudaError_t e = pack(q, k, v, dout, ws, groups_q, groups_kv, Dh, ld,
                             (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  const __nv_bfloat16* wq = (const __nv_bfloat16*)ws;
  const __nv_bfloat16* wk = wq + groups_q * VEC;
  const __nv_bfloat16* wv = wk + groups_kv * VEC;
  const __nv_bfloat16* wdo = wv + groups_kv * VEC;
  return swa_attention_bwd(wq, wk, wv, o, wdo, lse, dsum, dq, dk, dv, B, Hq,
                           Hkv, Tq, Tk, Dh, ld, window, causal, q_offset,
                           scale, 1, stream);
}

}  // extern "C"
