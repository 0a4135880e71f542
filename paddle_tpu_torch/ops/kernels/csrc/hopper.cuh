// Hopper (sm_90a) building blocks of the TMA / wgmma kernels: shared-memory
// addresses, mbarriers (with a wait that traps instead of hanging), TMA tile
// copies, wgmma descriptors and instructions, and tensor maps encoded
// through the runtime. Included by
// grouped_matmul.cu and flash_attention_tma.cu; every definition has
// internal linkage, so each library carries its own copy.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// -- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Waits until the barrier's phase of this parity has completed. A wait
// past 10 s traps: a broken ring fails the launch instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = globaltimer();
  while (!mbar_try_wait(bar, parity))
    if (globaltimer() - t0 > 10000000000ull) __trap();
}

// -- TMA: one box of a 2- to 4-D tensor map into shared memory, completing
// on bar; coordinates innermost first --------------------------------------

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// -- wgmma ------------------------------------------------------------------

// A wgmma shared-memory descriptor with 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// The descriptor of reduction slice kk (16 deep) of an operand tile held
// as TMA writes it with 128-byte swizzle: 64-wide panels of 128-byte rows,
// `panel` bytes apart, each 1024-byte aligned.
// K-major (kMN false): the rows run along M or N, the reduction along the
// row; eight-row groups are 1024 bytes apart and slice kk (< 4, within
// one panel) starts 32 kk bytes along the row.
// MN-major: the rows are reduction indices, 64 M or N values each; the
// next 64 values are a panel on (the leading offset) and slice kk starts
// 16 rows down.
template <bool kMN>
__device__ __forceinline__ uint64_t operand_desc(uint32_t tile, int kk,
                                                 uint32_t panel) {
  return kMN ? gmma_desc(tile + kk * 16 * 128, panel, 1024)
             : gmma_desc(tile + kk * 32, 16, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving other reads or writes of a wgmma
// accumulator between its issue and its wait (ptxas would then serialize
// the wgmmas): around wgmma_fence before the issue, and after the wait.
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HOPPER_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HOPPER_D16(i) \
  HOPPER_D4(i), HOPPER_D4(i + 4), HOPPER_D4(i + 8), HOPPER_D4(i + 12)
#define HOPPER_D32 HOPPER_D16(0), HOPPER_D16(16)
#define HOPPER_D64 HOPPER_D32, HOPPER_D16(32), HOPPER_D16(48)
#define HOPPER_O4(i) "=f"(d[i]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3])
#define HOPPER_O16(i) \
  HOPPER_O4(i), HOPPER_O4(i + 4), HOPPER_O4(i + 8), HOPPER_O4(i + 12)
#define HOPPER_O32 HOPPER_O16(0), HOPPER_O16(16)
#define HOPPER_R16 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define HOPPER_R32                                                         \
  HOPPER_R16                                                               \
  ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "    \
  "%29, %30, %31"
#define HOPPER_R64                                                         \
  HOPPER_R32                                                               \
  ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "    \
  "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, " \
  "%59, %60, %61, %62, %63"

// The accumulator layout of a 64 x N wgmma tile (f32): thread 32 q + 4 g + t
// of the warpgroup holds rows 16 q + g and 16 q + g + 8, columns 8 j + 2 t
// and 8 j + 2 t + 1: d[4 j] = (16 q + g, 8 j + 2 t), d[4 j + 1] its right
// neighbour, d[4 j + 2], d[4 j + 3] the same eight rows down. scale_d 0
// overwrites d instead of adding to it.

// d (64 x 128) += A (64 x 16) B (16 x 128), both from shared memory;
// kTA / kTB: the operand is MN-major (transposed).
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da,
                                      uint64_t db, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HOPPER_R64
      "}, %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : HOPPER_D64
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
}

// d (64 x 64) += A (64 x 16) B (16 x 64), both from shared memory.
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da,
                                      uint64_t db, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HOPPER_R32
      "}, %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : HOPPER_D32
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
}

// d (64 x 32) += A (64 x 16) B (16 x 32), both from shared memory.
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma(float (&d)[16], uint64_t da,
                                      uint64_t db, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" HOPPER_R16
      "}, %16, %17, p, 1, 1, %19, %20;\n"
      "}\n"
      : HOPPER_D16(0)
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
}

// d (64 x 64) = A (64 x 16) B (16 x 64), both from shared memory, d
// overwritten (scale_d 0): the compiler takes d as written here and not
// read, so it need not keep d's earlier values alive up to the issue.
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_first(float (&d)[32], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HOPPER_R32
      "}, %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : HOPPER_O32
      : "l"(da), "l"(db), "r"(0), "n"(kTA), "n"(kTB));
}

// The same for a 64 x 32 tile.
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_first(float (&d)[16], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" HOPPER_R16
      "}, %16, %17, p, 1, 1, %19, %20;\n"
      "}\n"
      : HOPPER_O16(0)
      : "l"(da), "l"(db), "r"(0), "n"(kTA), "n"(kTB));
}

// d (64 x 128) += A (64 x 16) B (16 x 128), A from registers in the
// m16n8k16 fragment layout of each warp's 16 rows (lane 4 g + t: a[0] =
// A[g][2t..2t+1], a[1] = A[g+8][2t..], a[2] = A[g][2t+8..], a[3] =
// A[g+8][2t+8..], two bf16 a register), which is where a 64 x 16 slice of
// the accumulator layout above lands after rounding pairs to bf16. B from
// shared memory, MN-major iff kTB.
template <int kTB>
__device__ __forceinline__ void wgmma(float (&d)[64], const uint32_t (&a)[4],
                                      uint64_t db, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HOPPER_R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : HOPPER_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(kTB));
}

// d (64 x 64) += A (64 x 16) B (16 x 64), A from registers in the same
// fragment layout, B from shared memory, MN-major iff kTB.
template <int kTB>
__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4],
                                      uint64_t db, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HOPPER_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : HOPPER_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(kTB));
}

#undef HOPPER_R64
#undef HOPPER_R32
#undef HOPPER_R16
#undef HOPPER_D64
#undef HOPPER_D32
#undef HOPPER_D16
#undef HOPPER_D4
#undef HOPPER_O32
#undef HOPPER_O16
#undef HOPPER_O4

// a position in a ring of N stages: the stage and the parity of its
// current round
template <int N>
struct RingPos {
  int stage = 0;
  uint32_t phase = 0;
  __device__ void next() {
    if (++stage == N) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// -- tensor maps (host) ------------------------------------------------------

// cuTensorMapEncodeTiled through the runtime, so the library needs no
// link against libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return rc == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

constexpr int kEncodeFailed = -1;  // a C entry's code for a refused map

// A bf16 tensor map of rank <= 5 with 128-byte swizzle, zeros out of
// bounds: dims and box innermost first, byte strides of dims 1 .. rank - 1.
// The encoder is a driver call and needs a current context, which the
// runtime binds to a thread lazily: a thread that has launched nothing yet
// through the runtime (an autograd worker's first backward) may have none,
// so the current device's primary context is made current first.
bool encode_tiled(CUtensorMap* map, int rank, const void* base,
                  const long long* dims, const long long* byte_strides,
                  const int* box) {
  const EncodeTiled enc = encoder();
  int dev;
  if (enc == nullptr || rank < 1 || rank > 5 ||
      cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess)
    return false;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], one[5] = {1, 1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    b[i] = static_cast<cuuint32_t>(box[i]);
  }
  for (int i = 0; i + 1 < rank; ++i)
    s[i] = static_cast<cuuint64_t>(byte_strides[i]);
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
             const_cast<void*>(base), d, s, b, one,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace
