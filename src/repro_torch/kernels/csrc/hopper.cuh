// Hopper (sm_90a) building blocks shared by the wgmma kernels
// (flash_attention.cu, dequant.cu) and the LoRA forward (lora_fwd.cuh):
// mbarriers (arrivals from cp.async copies, threads or TMA copies,
// suspending and polling waits), 16-byte cp.async copies, TMA loads and
// stores of tensor-map boxes with the maps' encoder, wgmma shared-memory
// descriptors for the 128- and 64-byte swizzles, and the warpgroup
// products themselves.
//
// The accumulator layout of every m64nNk16 f32 product here: thread
// t = 32 w + l of the warpgroup holds rows 16 w + l / 4 (elements 4 i,
// 4 i + 1) and that + 8 (elements 4 i + 2, 4 i + 3), columns
// 8 i + 2 (l % 4) and + 1, for i < N / 8.
#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include <cstdint>

#include "common.cuh"

namespace repro {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; pred false writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 16 : 0) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// arrives on *bar once all of this thread's earlier cp.async copies land
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// a plain arrive (release at CTA scope)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// whether the phase of *bar with this parity has completed (no wait)
__device__ __forceinline__ bool mbar_test(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

// a wait that polls instead of suspending: a suspended thread resumes
// hundreds of cycles after the phase completes, which a pipeline that
// hands every step between warpgroups cannot afford; the short sleep
// between polls keeps the waiting warps off the shared-memory pipe that
// wgmma reads its operands through
__device__ __forceinline__ void mbar_spin(uint64_t* bar, int parity) {
  while (!mbar_test(bar, parity)) __nanosleep(32);
}

// the generic-proxy writes (cp.async, st.shared) seen by wgmma's async
// proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- the TMA: boxes of tensor maps in and out of shared memory
// arrive on *bar, expecting ``bytes`` of TMA copies in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// the box at (c0 innermost, c1[, c2]) into shared dst, its bytes counted
// on *bar
__device__ __forceinline__ void tma_load2(uint32_t dst, const CUtensorMap* tm,
                                          int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1),
         "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* tm,
                                          int c0, int c1, int c2,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1),
         "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// shared src to the box at (c0, c1), in this thread's current bulk group
__device__ __forceinline__ void tma_store2(const CUtensorMap* tm, int c0,
                                           int c1, uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], "
      "[%3];\n"
      :: "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1), "r"(src)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// at most N of this thread's bulk groups still read their shared source
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// at most N of this thread's bulk groups still incomplete
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}

// cuTensorMapEncodeTiled, looked up in libcuda once (no driver library
// is linked)
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// A map of a tensor of ``rank`` (2 or 3) dims, innermost first, with the
// element strides of the outer dims and elements of ``elem`` bytes, read
// or written in ``box``es; elements out of range arrive as zeros and are
// not stored.
inline bool make_map(CUtensorMap* tm, CUtensorMapDataType type, const void* p,
                     int rank, const long* dims, const long* strides,
                     int elem, const int* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr || rank < 2 || rank > 3) return false;
  cuuint64_t d[3], s[2];
  cuuint32_t b[3], e[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    b[i] = static_cast<cuuint32_t>(box[i]);
    if (i) s[i - 1] = static_cast<cuuint64_t>(strides[i - 1]) * elem;
  }
  return enc(tm, type, rank, const_cast<void*>(p), d, s, b, e,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A bf16 tile of 64-element (or 32-element) rows in wgmma's 128-byte (or
// 64-byte) swizzle: row r of width kRowBytes at r * kRowBytes, its
// 16-byte chunk j at j ^ (r % 8) (128 B) or j ^ ((r / 2) % 4) (64 B).
// The tile must sit at a multiple of 1024 bytes.
template <int kRowBytes>
__device__ __forceinline__ uint32_t swz(uint32_t tile, int r, int j) {
  static_assert(kRowBytes == 128 || kRowBytes == 64, "swizzle width");
  const int sw = kRowBytes == 128 ? (r & 7) : ((r >> 1) & 3);
  return tile + r * kRowBytes + ((j ^ sw) << 4);
}

// wgmma shared-memory descriptor for that swizzle: start address, leading
// byte offset (MN-major operands: the distance between 64-element column
// blocks; unused for K-major ones), stride byte offset (the distance
// between 8-row groups: 8 rows of the swizzle width), layout type 1
// (128 B) or 2 (64 B).
template <int kRowBytes>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  constexpr uint64_t kMode = kRowBytes == 128 ? 1 : 2;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16)
         | (static_cast<uint64_t>(8 * kRowBytes >> 4) << 32)
         | (kMode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// the accumulator registers are written asynchronously: pin every use
// after the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

#define REPRO_WGMMA_D16 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define REPRO_WGMMA_D16_OPS(d) \
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
      "+f"(d[15])
#define REPRO_WGMMA_D32 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"
#define REPRO_WGMMA_D32_OPS(d) \
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
      "+f"(d[30]), "+f"(d[31])
#define REPRO_WGMMA_D64 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63}"
#define REPRO_WGMMA_D64_OPS(d) \
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (+)= A·B, m64nNk16, A K-major and B K-major (kTransB 0) or MN-major
// (kTransB 1), both in shared memory; N = 64 or 128 (the accumulator's
// size)
template <int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      REPRO_WGMMA_D32 ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : REPRO_WGMMA_D32_OPS(d)
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      REPRO_WGMMA_D64 ", %64, %65, p, 1, 1, 0, %67;\n}\n"
      : REPRO_WGMMA_D64_OPS(d)
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransB));
}

// d += A·B, m64nNk16, A (four bf16 pairs a thread) from registers, B
// MN-major in shared memory; N = 32, 64, 128 (the accumulator's size)
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      REPRO_WGMMA_D16 ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : REPRO_WGMMA_D16_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      REPRO_WGMMA_D32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_WGMMA_D32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      REPRO_WGMMA_D64 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : REPRO_WGMMA_D64_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

}  // namespace sm90
}  // namespace repro
