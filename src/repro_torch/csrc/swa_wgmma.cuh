// The bf16 tensor-core pieces that the sliding-window attention kernels
// share (the forward, swa_attention_tc.cu, and the backward,
// swa_attention_bwd.cu): wgmma products with float32 accumulators, the
// shared-memory descriptors of 128-byte-swizzled TMA boxes, float32 into
// bf16 (the forward's split into hi + lo, or one rounding), and the 3-D
// tensor maps over rows of ld bf16.
//
// Tiles live in shared memory as TMA boxes of 64 rows x 64 bf16 columns
// (128 B a row, 128-byte swizzle, 8 KB a box); a row of Dh <= 128 columns is
// two boxes.  wgmma fragments: the accumulator of an m64nN product gives
// thread (warp w of the warpgroup, lane = 4 g + t) element i at row
// 16 w + g + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 t + (i & 1); the
// accumulator of 16 columns 16 kk.. is, as it stands, the register A operand
// of the kk-th 16-deep step of the next product (after packing to bf16x2).

#pragma once

#include <cuda_bf16.h>

#include "async_copy.cuh"

namespace swa_wg {

constexpr int BOX_COLS = 64;            // bf16 columns per TMA box (128 B)
constexpr int BOX_BYTES = 64 * 128;     // one box of 64 rows

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accesses of wgmma registers across the
// fence / wait instructions.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

#define F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F8(d, i) F4(d, i), F4(d, i + 4)
#define F16(d, i) F8(d, i), F8(d, i + 8)

// d (64 x 64, float32 fragments) (+)= A (64 x 16, smem) B (16 x 64, smem),
// both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F16(d, 0), F16(d, 16)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N) += A (64 x 16, registers) B (16 x N, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, "
      "p, 1, 1, 1;\n}\n"
      : F8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : F16(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n48(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : F16(d, 0), F8(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F16(d, 0), F16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64) (+)= A (64 x 16, registers) B (16 x 64, smem, K-major).
__device__ __forceinline__ void wgmma_rs_n64_kmajor(float* d,
                                                    const uint32_t* a,
                                                    uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : F16(d, 0), F16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

#undef F16
#undef F8
#undef F4

// One 16-deep step of a register-A product into an output chunk of n
// (16..64) columns.
__device__ __forceinline__ void rs_chunk(float* d, const uint32_t* a,
                                         uint64_t db, int n) {
  switch (n) {
    case 16: wgmma_rs_n16(d, a, db); break;
    case 32: wgmma_rs_n32(d, a, db); break;
    case 48: wgmma_rs_n48(d, a, db); break;
    default: wgmma_rs_n64(d, a, db); break;
  }
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Split two float32 values (lower column first) into the bf16x2 registers
// of hi = bf16(x) and lo = bf16(x - hi).
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// Two float32 values (lower column first) as one bf16x2 register.
__device__ __forceinline__ uint32_t pack2(float x, float y) {
  return as_u32(__floats2bfloat162_rn(x, y));
}

// 2^x by the SFU (relative error ~2^-22; -1e30 gives 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 64, float32 fragments) = A B^T over the depth: A's 64 rows at a
// (column boxes a_box bytes apart), B's 64 rows at b (boxes BOX_BYTES
// apart), both as boxes of 64 columns (K-major, 128-byte swizzle); ksteps
// 16-deep steps; issued, not waited for.
__device__ __forceinline__ void issue_ss(float* d, uint32_t a, uint32_t a_box,
                                         uint32_t b, int ksteps) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if (kk < ksteps) {
      const uint32_t off = (kk & 3) * 32;
      wgmma_ss_n64(d, smem_desc(a + (kk >> 2) * a_box + off, 16, 1024),
                   smem_desc(b + (kk >> 2) * BOX_BYTES + off, 16, 1024),
                   kk > 0);
    }
  }
}

// d (64 x 64) = A B^T over KS 16-deep steps: A the register fragments of
// the steps (4 a step), B's 64 rows at b as column boxes BOX_BYTES apart
// (K-major, 128-byte swizzle); issued, not waited for.
template <int KS>
__device__ __forceinline__ void issue_rk(float* d, const uint32_t* a,
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_rs_n64_kmajor(
        d, a + 4 * kk,
        smem_desc(b + (kk >> 2) * BOX_BYTES + (kk & 3) * 32, 16, 1024),
        kk > 0);
}

// d (64 x (n0 + n1)) += X B over 64-deep: X the register A fragments of 4
// 16-deep steps (xh, and xl when SPLIT: X = xh + xl; the forward's P is
// split so, the backward's P and dS are not), B 64 rows at b as NB column
// boxes BOX_BYTES apart (MN-major: rows are the depth); issued, not waited
// for.  Depth step kk is rows 16 kk.. of a box (2048 B further); one
// instruction covers at most one box's 64 columns (n0 on the first box, n1
// on the second at d + 32, only when NB is 2 and so n0 is 64), so both
// descriptor offsets are the 1024 B between groups of 8 rows.  Widths known
// at compile time fold rs_chunk's switch away.
template <bool SPLIT, int NB>
__device__ __forceinline__ void issue_rs(float* d, const uint32_t* xh,
                                         const uint32_t* xl, uint32_t b,
                                         int n0, int n1) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t d0 = smem_desc(b + kk * 2048, 1024, 1024);
    rs_chunk(d, xh + 4 * kk, d0, n0);
    if (SPLIT) rs_chunk(d, xl + 4 * kk, d0, n0);
    if (NB > 1 && n1 > 0) {
      const uint64_t d1 = smem_desc(b + BOX_BYTES + kk * 2048, 1024, 1024);
      rs_chunk(d + 32, xh + 4 * kk, d1, n1);
      if (SPLIT) rs_chunk(d + 32, xl + 4 * kk, d1, n1);
    }
  }
}

// --------------------------------------------------------------- host side --

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a driver function, through
// cudaGetDriverEntryPoint (so the library needs no -lcuda); null if absent.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &res);
#endif
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map over (rows, T, Dh) bf16 with rows of ld elements, seen as
// (Dh, T, rows), innermost first: boxes of 64 columns x 64 positions of one
// row, 128-byte swizzle, zeros outside the tensor (columns ld - Dh past
// each row are never read).
inline bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                     int rows, int T, int Dh, int ld) {
  const cuuint64_t dims[3] = {(cuuint64_t)Dh, (cuuint64_t)T,
                              (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2,
                                 (cuuint64_t)T * ld * 2};
  const cuuint32_t box[3] = {BOX_COLS, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace swa_wg
