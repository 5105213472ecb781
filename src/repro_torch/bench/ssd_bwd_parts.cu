// The SSD scan's backward one launch at a time, for bench/lm_bwd.py: CUDA
// events between the calls of ssd_scan_bwd_part time the state adjoint's
// two launches and the chunk gradients apart.  This file includes the
// library's csrc/ssd_scan.cu (its kernels and launch code) and adds one
// entry point; the bench builds it with csrc/ssd_chunk_grad.cu into a
// library of its own, and the port's library does not contain it.

#include "ssd_scan.cu"

extern "C" {

// ssd_scan_bwd's arguments (tc 0: the chunk gradients on the CUDA-core
// ssd_chunk_grad_kernel), and part: 1 launch 1' (the adjoint's local
// sums), 2 launch 2' (its pass, in place on wsz), 3 launch 3' (the chunk
// gradients, from wsz as 2' leaves it).
int ssd_scan_bwd_part(const void* x, const float* dt, const float* A,
                      const float* B, const float* C, const void* dy,
                      const float* ws, const float* decay, float* wsz,
                      void* dx, float* ddt, float* dBp, float* dCp,
                      float* dAp, const void* Bk, const void* Ck, int b,
                      int t, int h, int dh, int n, int L, int is_bf16,
                      int tc, int g, int xs, int bc_bf16, int part,
                      void* stream) {
  if (b <= 0 || t <= 0 || h <= 0) return (int)cudaGetLastError();
  if (L < 1 || n < 1 || dh < 1 || dh > MAX_DT * TILE || part < 1 ||
      part > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const GradRoute route{tc != 0, Bk, Ck, g, xs, bc_bf16};
  return is_bf16
             ? launch_bwd_dt<__nv_bfloat16>(x, dt, A, B, C, dy, ws, decay,
                                            wsz, dx, ddt, dBp, dCp, dAp, b,
                                            t, h, dh, n, L, route, part, st)
             : launch_bwd_dt<float>(x, dt, A, B, C, dy, ws, decay, wsz, dx,
                                    ddt, dBp, dCp, dAp, b, t, h, dh, n, L,
                                    route, part, st);
}

}  // extern "C"
