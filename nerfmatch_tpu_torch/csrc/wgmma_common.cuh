// Device helpers shared by the Hopper kernels that stage their operands
// asynchronously (attention.cu, render_train.cu, render_eval.cu; sepconv.cu
// uses the copy and mbarrier helpers) and multiply with wgmma:
// cp.async and bulk copies into shared memory, mbarriers, a warpgroup's
// named barrier, the fence to the asynchronous proxy, the 128-byte swizzle
// and its wgmma descriptors, and
// wgmma.mma_async m64nNk16 (bf16 operands, f32 accumulators), m64nNk32
// (s8 operands, s32 accumulators) and m64nNk8 (tf32 operands, f32
// accumulators) with A in registers or in shared memory.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- cp.async ----

// 16 bytes global -> shared, zero-filled when !valid (src is not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// All but the N most recent groups of this thread's copies have landed.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This thread's shared-memory writes (and landed copies) become visible to
// the asynchronous proxy that wgmma and the bulk copies go through.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- mbarriers and bulk copies ----

// mbarrier with one arrival a phase plus the bytes of the bulk copies
// that complete on it.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// bytes (a multiple of 16) global -> shared by the copy engine, completing
// on the mbarrier bar.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// bytes shared -> global by the copy engine, in this thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               "cp.async.bulk.commit_group;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}

// This thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_read_done() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// The 128 threads of warpgroup wg (named barrier 1 + wg).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// ---- wgmma ----

// Operand tiles are blocks of 128-byte rows (64 bf16) in the 128-byte
// swizzle: byte offset of 16-byte chunk c (0..7) of row r of a block.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// wgmma shared-memory descriptor in the 128-byte swizzle: start address,
// leading byte offset `lbo` (MN-major: from one 64-element block of the M or
// N index to the next; not used K-major), stride byte offset 1024 (eight
// rows on).  Blocks start on 1024-byte boundaries.
__device__ __forceinline__ uint64_t desc128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         (64ull << 32) | (1ull << 62);
}

// Compile-time int, to pass a product's slice counts and width through a
// generic lambda.
template <int N>
struct Int {
  static constexpr int value = N;
};

// Half of a reduce-scatter over lanes differing in bit M: of the N values
// v[0 ..], a lane keeps the half its bit M selects (the upper half where
// set) plus its partner's copy of that half, in v[0 .. N / 2).
template <int M, int N>
__device__ __forceinline__ void fold_half(float* v, int lane) {
  const bool up = lane & M;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = up ? v[i] : v[i + N / 2];
    const float keep = up ? v[i + N / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// All but the N most recent wgmma groups of the warpgroup are done.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The accumulator operands d[i] ..: constraint C ("+f": f32 variables,
// "+r": 32-bit integer ones), and the operand numbers of the first 8 / 16 /
// 32 / 48 / 64 / 96 / 128 of them in an asm template.  An f32 accumulator may live in
// integer variables (PTX takes .b32 registers for .f32 operands): a kernel
// that runs both bf16 and s8 products keeps one accumulator array for both.
#define NM_ACC8(C, i)                                                    \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]),           \
      C(d[i + 5]), C(d[i + 6]), C(d[i + 7])
#define NM_ACC16(C, i) NM_ACC8(C, i), NM_ACC8(C, i + 8)
#define NM_ACC32(C, i) NM_ACC16(C, i), NM_ACC16(C, i + 16)
#define NM_ACC64(C, i) NM_ACC32(C, i), NM_ACC32(C, i + 32)
#define NM_ACC128(C, i) NM_ACC64(C, i), NM_ACC64(C, i + 64)
#define NM_ACC48(C, i) NM_ACC32(C, i), NM_ACC16(C, i + 32)
#define NM_ACC96(C, i) NM_ACC64(C, i), NM_ACC32(C, i + 64)
#define NM_REGS8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define NM_REGS16 \
  NM_REGS8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define NM_REGS32                                                          \
  NM_REGS16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
            "%28, %29, %30, %31"
#define NM_REGS64                                                        \
  NM_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "  \
            "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
            "%55, %56, %57, %58, %59, %60, %61, %62, %63"
#define NM_REGS128                                                         \
  NM_REGS64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, "    \
            "%75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "   \
            "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, "   \
            "%99, %100, %101, %102, %103, %104, %105, %106, %107, %108, "    \
            "%109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "   \
            "%119, %120, %121, %122, %123, %124, %125, %126, %127"
#define NM_REGS48 \
  NM_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
            "%44, %45, %46, %47"
#define NM_REGS96                                                          \
  NM_REGS64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, "    \
            "%75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "   \
            "%87, %88, %89, %90, %91, %92, %93, %94, %95"

// One wgmma.mma_async of shape and types SHAPE: accumulator operands ACC
// (numbered REGS), then the inputs; PRED names the scale-d input (0: d =
// A B, else d += A B) and TAIL the A, B and immediate operands after the
// accumulator.
#define NM_WGMMA(SHAPE, REGS, TAIL, PRED, ACC, ...)                      \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " PRED ", 0;\n"         \
               "wgmma.mma_async.sync.aligned." SHAPE " {" REGS "}, " TAIL \
               ";\n}\n"                                                  \
               : ACC                                                     \
               : __VA_ARGS__                                             \
               : "memory")
#define NM_BF16(n) "m64n" #n "k16.f32.bf16.bf16"
#define NM_S8(n) "m64n" #n "k32.s32.s8.s8"

// d (64 x N f32, N / 2 a thread; T float or uint32_t holding f32 bits) = or
// += A (64 x 16) B (16 x N), both in shared memory (descriptors da, db); B
// MN-major (its transpose bit set), A MN-major (TA = 1) or K-major (TA = 0).
// Accumulator element 4 j + e of a thread holds row 16 (warp % 4) + lane / 4
// (+ 8 for e >= 2), column 8 j + 2 (lane % 4) + (e & 1).
template <int N, int TA = 1, typename T>
__device__ __forceinline__ void wgmma_ss(T* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  static_assert(N == 64 || N == 96 || N == 128 || N == 192 || N == 256,
                "wgmma_ss: n64, n96, n128, n192, n256");
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (N == 256)
      NM_WGMMA(NM_BF16(256), NM_REGS128, "%128, %129, p, 1, 1, %131, 1", "%130",
               NM_ACC128("+f", 0), "l"(da), "l"(db), "r"(scale_d), "n"(TA));
    else if constexpr (N == 192)
      NM_WGMMA(NM_BF16(192), NM_REGS96, "%96, %97, p, 1, 1, %99, 1", "%98",
               NM_ACC96("+f", 0), "l"(da), "l"(db), "r"(scale_d), "n"(TA));
    else if constexpr (N == 128)
      NM_WGMMA(NM_BF16(128), NM_REGS64, "%64, %65, p, 1, 1, %67, 1", "%66",
               NM_ACC64("+f", 0), "l"(da), "l"(db), "r"(scale_d), "n"(TA));
    else if constexpr (N == 96)
      NM_WGMMA(NM_BF16(96), NM_REGS48, "%48, %49, p, 1, 1, %51, 1", "%50",
               NM_ACC48("+f", 0), "l"(da), "l"(db), "r"(scale_d), "n"(TA));
    else
      NM_WGMMA(NM_BF16(64), NM_REGS32, "%32, %33, p, 1, 1, %35, 1", "%34",
               NM_ACC32("+f", 0), "l"(da), "l"(db), "r"(scale_d), "n"(TA));
  } else {
    if constexpr (N == 256)
      NM_WGMMA(NM_BF16(256), NM_REGS128, "%128, %129, p, 1, 1, %131, 1", "%130",
               NM_ACC128("+r", 0), "l"(da), "l"(db), "r"(scale_d), "n"(TA));
    else if constexpr (N == 192)
      NM_WGMMA(NM_BF16(192), NM_REGS96, "%96, %97, p, 1, 1, %99, 1", "%98",
               NM_ACC96("+r", 0), "l"(da), "l"(db), "r"(scale_d), "n"(TA));
    else if constexpr (N == 128)
      NM_WGMMA(NM_BF16(128), NM_REGS64, "%64, %65, p, 1, 1, %67, 1", "%66",
               NM_ACC64("+r", 0), "l"(da), "l"(db), "r"(scale_d), "n"(TA));
    else if constexpr (N == 96)
      NM_WGMMA(NM_BF16(96), NM_REGS48, "%48, %49, p, 1, 1, %51, 1", "%50",
               NM_ACC48("+r", 0), "l"(da), "l"(db), "r"(scale_d), "n"(TA));
    else
      NM_WGMMA(NM_BF16(64), NM_REGS32, "%32, %33, p, 1, 1, %35, 1", "%34",
               NM_ACC32("+r", 0), "l"(da), "l"(db), "r"(scale_d), "n"(TA));
  }
}

// d (64 x N f32) = or += A (64 x 16 bf16: four registers a thread, the
// layout of mma.sync m16n8k16's A, warp w of the warpgroup holding rows
// 16 w ..) times the 16 x N tile of B in shared memory (descriptor db),
// K-major (TB = 0) or MN-major (TB = 1).  T as for wgmma_ss.
template <int N, int TB, typename T>
__device__ __forceinline__ void wgmma_rs(T* d, const uint32_t* a,
                                         uint64_t db, int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 96 || N == 128 ||
                    N == 192 || N == 256,
                "wgmma_rs: n16, n32, n64, n96, n128, n192, n256");
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (N == 256)
      NM_WGMMA(NM_BF16(256), NM_REGS128,
               "{%128, %129, %130, %131}, %132, p, 1, 1, %134", "%133",
               NM_ACC128("+f", 0), "r"(a[0]), "r"(a[1]), "r"(a[2]),
               "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
    else if constexpr (N == 192)
      NM_WGMMA(NM_BF16(192), NM_REGS96,
               "{%96, %97, %98, %99}, %100, p, 1, 1, %102", "%101",
               NM_ACC96("+f", 0), "r"(a[0]), "r"(a[1]), "r"(a[2]),
               "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
    else if constexpr (N == 128)
      NM_WGMMA(NM_BF16(128), NM_REGS64, "{%64, %65, %66, %67}, %68, p, 1, 1, %70",
               "%69", NM_ACC64("+f", 0), "r"(a[0]), "r"(a[1]), "r"(a[2]),
               "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
    else if constexpr (N == 96)
      NM_WGMMA(NM_BF16(96), NM_REGS48, "{%48, %49, %50, %51}, %52, p, 1, 1, %54",
               "%53", NM_ACC48("+f", 0), "r"(a[0]), "r"(a[1]), "r"(a[2]),
               "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
    else if constexpr (N == 64)
      NM_WGMMA(NM_BF16(64), NM_REGS32, "{%32, %33, %34, %35}, %36, p, 1, 1, %38",
               "%37", NM_ACC32("+f", 0), "r"(a[0]), "r"(a[1]), "r"(a[2]),
               "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
    else if constexpr (N == 32)
      NM_WGMMA(NM_BF16(32), NM_REGS16, "{%16, %17, %18, %19}, %20, p, 1, 1, %22",
               "%21", NM_ACC16("+f", 0), "r"(a[0]), "r"(a[1]), "r"(a[2]),
               "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
    else
      NM_WGMMA(NM_BF16(16), NM_REGS8, "{%8, %9, %10, %11}, %12, p, 1, 1, %14",
               "%13", NM_ACC8("+f", 0), "r"(a[0]), "r"(a[1]), "r"(a[2]),
               "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
  } else {
    if constexpr (N == 256)
      NM_WGMMA(NM_BF16(256), NM_REGS128,
               "{%128, %129, %130, %131}, %132, p, 1, 1, %134", "%133",
               NM_ACC128("+r", 0), "r"(a[0]), "r"(a[1]), "r"(a[2]),
               "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
    else if constexpr (N == 192)
      NM_WGMMA(NM_BF16(192), NM_REGS96,
               "{%96, %97, %98, %99}, %100, p, 1, 1, %102", "%101",
               NM_ACC96("+r", 0), "r"(a[0]), "r"(a[1]), "r"(a[2]),
               "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
    else if constexpr (N == 128)
      NM_WGMMA(NM_BF16(128), NM_REGS64, "{%64, %65, %66, %67}, %68, p, 1, 1, %70",
               "%69", NM_ACC64("+r", 0), "r"(a[0]), "r"(a[1]), "r"(a[2]),
               "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
    else if constexpr (N == 96)
      NM_WGMMA(NM_BF16(96), NM_REGS48, "{%48, %49, %50, %51}, %52, p, 1, 1, %54",
               "%53", NM_ACC48("+r", 0), "r"(a[0]), "r"(a[1]), "r"(a[2]),
               "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
    else if constexpr (N == 64)
      NM_WGMMA(NM_BF16(64), NM_REGS32, "{%32, %33, %34, %35}, %36, p, 1, 1, %38",
               "%37", NM_ACC32("+r", 0), "r"(a[0]), "r"(a[1]), "r"(a[2]),
               "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
    else if constexpr (N == 32)
      NM_WGMMA(NM_BF16(32), NM_REGS16, "{%16, %17, %18, %19}, %20, p, 1, 1, %22",
               "%21", NM_ACC16("+r", 0), "r"(a[0]), "r"(a[1]), "r"(a[2]),
               "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
    else
      NM_WGMMA(NM_BF16(16), NM_REGS8, "{%8, %9, %10, %11}, %12, p, 1, 1, %14",
               "%13", NM_ACC8("+r", 0), "r"(a[0]), "r"(a[1]), "r"(a[2]),
               "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
  }
}

// ---- s8 x s8 -> s32 ----

// wgmma shared-memory descriptor of a K-major tile in the 64-byte swizzle:
// rows (the N index) of 64 bytes, 16-byte chunk c of row r stored at chunk
// c ^ ((r / 2) % 4); eight rows (512 bytes) to the next group, from a
// 512-byte boundary.  A k32 step of s8 is 32 bytes of a row.
__device__ __forceinline__ uint64_t desc64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (32ull << 32) |
         (2ull << 62);
}

// d (64 x N s32 in uint32_t, the accumulator layout above) = or += A
// (64 x 32 s8) B (32 x N s8): A K-major in shared memory (descriptor da,
// wgmma_ss8) or in four registers a thread (wgmma_rs8: register r holds
// row 16 (warp % 4) + lane / 4 (+ 8 for odd r), columns 4 (lane % 4) ..
// + 3 (+ 16 for r >= 2), lowest byte first: mma.sync m16n8k32's A); B
// K-major (descriptor db; 8-bit wgmma takes no transposed B).  kInit: the
// first product of a chain (d = A B), which reads nothing of d, so the
// compiler need not keep d's old values in registers until it.
template <int N, bool kInit = false>
__device__ __forceinline__ void wgmma_ss8(uint32_t* d, uint64_t da, uint64_t db,
                                          int scale_d) {
  static_assert(N == 64 || N == 128 || N == 192 || N == 256,
                "wgmma_ss8: n64, n128, n192, n256");
  if constexpr (kInit) {
    if constexpr (N == 256)
      NM_WGMMA(NM_S8(256), NM_REGS128, "%128, %129, p", "%130", NM_ACC128("=r", 0),
               "l"(da), "l"(db), "n"(0));
    else if constexpr (N == 192)
      NM_WGMMA(NM_S8(192), NM_REGS96, "%96, %97, p", "%98", NM_ACC96("=r", 0),
               "l"(da), "l"(db), "n"(0));
    else if constexpr (N == 128)
      NM_WGMMA(NM_S8(128), NM_REGS64, "%64, %65, p", "%66", NM_ACC64("=r", 0),
               "l"(da), "l"(db), "n"(0));
    else
      NM_WGMMA(NM_S8(64), NM_REGS32, "%32, %33, p", "%34", NM_ACC32("=r", 0),
               "l"(da), "l"(db), "n"(0));
  } else {
    if constexpr (N == 256)
      NM_WGMMA(NM_S8(256), NM_REGS128, "%128, %129, p", "%130", NM_ACC128("+r", 0),
               "l"(da), "l"(db), "r"(scale_d));
    else if constexpr (N == 192)
      NM_WGMMA(NM_S8(192), NM_REGS96, "%96, %97, p", "%98", NM_ACC96("+r", 0),
               "l"(da), "l"(db), "r"(scale_d));
    else if constexpr (N == 128)
      NM_WGMMA(NM_S8(128), NM_REGS64, "%64, %65, p", "%66", NM_ACC64("+r", 0),
               "l"(da), "l"(db), "r"(scale_d));
    else
      NM_WGMMA(NM_S8(64), NM_REGS32, "%32, %33, p", "%34", NM_ACC32("+r", 0),
               "l"(da), "l"(db), "r"(scale_d));
  }
}

template <int N, bool kInit = false>
__device__ __forceinline__ void wgmma_rs8(uint32_t* d, const uint32_t* a,
                                          uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128 || N == 192 || N == 256,
                "wgmma_rs8: n64, n128, n192, n256");
  if constexpr (kInit) {
    if constexpr (N == 256)
      NM_WGMMA(NM_S8(256), NM_REGS128, "{%128, %129, %130, %131}, %132, p", "%133",
               NM_ACC128("=r", 0), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
               "l"(db), "n"(0));
    else if constexpr (N == 192)
      NM_WGMMA(NM_S8(192), NM_REGS96, "{%96, %97, %98, %99}, %100, p", "%101",
               NM_ACC96("=r", 0), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
               "l"(db), "n"(0));
    else if constexpr (N == 128)
      NM_WGMMA(NM_S8(128), NM_REGS64, "{%64, %65, %66, %67}, %68, p", "%69",
               NM_ACC64("=r", 0), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
               "l"(db), "n"(0));
    else
      NM_WGMMA(NM_S8(64), NM_REGS32, "{%32, %33, %34, %35}, %36, p", "%37",
               NM_ACC32("=r", 0), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
               "l"(db), "n"(0));
  } else {
    if constexpr (N == 256)
      NM_WGMMA(NM_S8(256), NM_REGS128, "{%128, %129, %130, %131}, %132, p", "%133",
               NM_ACC128("+r", 0), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
               "l"(db), "r"(scale_d));
    else if constexpr (N == 192)
      NM_WGMMA(NM_S8(192), NM_REGS96, "{%96, %97, %98, %99}, %100, p", "%101",
               NM_ACC96("+r", 0), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
               "l"(db), "r"(scale_d));
    else if constexpr (N == 128)
      NM_WGMMA(NM_S8(128), NM_REGS64, "{%64, %65, %66, %67}, %68, p", "%69",
               NM_ACC64("+r", 0), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
               "l"(db), "r"(scale_d));
    else
      NM_WGMMA(NM_S8(64), NM_REGS32, "{%32, %33, %34, %35}, %36, p", "%37",
               NM_ACC32("+r", 0), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
               "l"(db), "r"(scale_d));
  }
}

// ---- tf32 x tf32 -> f32 ----

// d (64 x N f32, the accumulator layout above) = or += A (64 x 8 tf32) B
// (8 x N tf32), B K-major in shared memory (descriptor db; tf32 wgmma
// takes no transposed operand), A K-major in shared memory (descriptor
// da, wgmma_ss_tf32) or in four registers a thread (wgmma_rs_tf32:
// register r holds row 16 (warp % 4) + lane / 4 (+ 8 for odd r), column
// lane % 4 (+ 4 for r >= 2): mma.sync m16n8k8's tf32 A).  The tensor
// cores read only the 19 high bits of each operand (they truncate): a
// caller that wants it rounded passes it rounded.
#define NM_TF32(n) "m64n" #n "k8.f32.tf32.tf32"
template <int N>
__device__ __forceinline__ void wgmma_ss_tf32(float* d, uint64_t da, uint64_t db,
                                              int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128,
                "wgmma_ss_tf32: n16, n32, n64, n128");
  if constexpr (N == 128)
    NM_WGMMA(NM_TF32(128), NM_REGS64, "%64, %65, p, 1, 1", "%66",
             NM_ACC64("+f", 0), "l"(da), "l"(db), "r"(scale_d));
  else if constexpr (N == 64)
    NM_WGMMA(NM_TF32(64), NM_REGS32, "%32, %33, p, 1, 1", "%34",
             NM_ACC32("+f", 0), "l"(da), "l"(db), "r"(scale_d));
  else if constexpr (N == 32)
    NM_WGMMA(NM_TF32(32), NM_REGS16, "%16, %17, p, 1, 1", "%18",
             NM_ACC16("+f", 0), "l"(da), "l"(db), "r"(scale_d));
  else
    NM_WGMMA(NM_TF32(16), NM_REGS8, "%8, %9, p, 1, 1", "%10",
             NM_ACC8("+f", 0), "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_rs_tf32(float* d, const uint32_t* a,
                                              uint64_t db, int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128,
                "wgmma_rs_tf32: n16, n32, n64, n128");
  if constexpr (N == 128)
    NM_WGMMA(NM_TF32(128), NM_REGS64, "{%64, %65, %66, %67}, %68, p, 1, 1",
             "%69", NM_ACC64("+f", 0), "r"(a[0]), "r"(a[1]), "r"(a[2]),
             "r"(a[3]), "l"(db), "r"(scale_d));
  else if constexpr (N == 64)
    NM_WGMMA(NM_TF32(64), NM_REGS32, "{%32, %33, %34, %35}, %36, p, 1, 1",
             "%37", NM_ACC32("+f", 0), "r"(a[0]), "r"(a[1]), "r"(a[2]),
             "r"(a[3]), "l"(db), "r"(scale_d));
  else if constexpr (N == 32)
    NM_WGMMA(NM_TF32(32), NM_REGS16, "{%16, %17, %18, %19}, %20, p, 1, 1",
             "%21", NM_ACC16("+f", 0), "r"(a[0]), "r"(a[1]), "r"(a[2]),
             "r"(a[3]), "l"(db), "r"(scale_d));
  else
    NM_WGMMA(NM_TF32(16), NM_REGS8, "{%8, %9, %10, %11}, %12, p, 1, 1", "%13",
             NM_ACC8("+f", 0), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
             "l"(db), "r"(scale_d));
}

#undef NM_TF32
#undef NM_WGMMA
#undef NM_BF16
#undef NM_S8
#undef NM_REGS128
#undef NM_REGS96
#undef NM_REGS48
#undef NM_REGS64
#undef NM_REGS32
#undef NM_REGS16
#undef NM_REGS8
#undef NM_ACC128
#undef NM_ACC96
#undef NM_ACC48
#undef NM_ACC64
#undef NM_ACC32
#undef NM_ACC16
#undef NM_ACC8

}  // namespace
