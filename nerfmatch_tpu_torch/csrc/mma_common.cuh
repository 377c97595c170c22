// Device helpers shared by the render kernels (render.cu, render_train.cu)
// and the resample kernel: bf16 tensor-core products with mma.sync
// m16n8k16 over 64-row chunks held in shared memory, weight fragments
// packed on the host, and warp reductions.
//
// Weight fragments: for a (K, N) matrix, K padded to a multiple of 16,
// uint2 index ((k_step * (N / 8) + n_tile) * 32 + lane) holds the two
// b-registers of mma.m16n8k16 for that lane (see render_kernel.py:
// pack_fragments); int8 weights the same with 32-deep k steps for
// mma.m16n8k32 (quant.py: pack_fragments_s8).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;                        // rows of an MLP chunk
constexpr int kMTiles = kRows / 16;              // mma row tiles
constexpr int kMaxLayers = 16;
constexpr int kEncMax = 96;                      // 2 * 3 * F <= 96, padded K
constexpr int kEncStride = kEncMax + 8;          // bf16; conflict-free ldmatrix
constexpr int kDirsMax = 32;                     // 2 * 3 * Fd + 3
constexpr float kHalfPi = 1.57079632679489661923f;
constexpr float kF32Eps = 1.1920928955078125e-07f;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// Transposing load: lane t receives elements (2 (t % 4), t / 4) and
// (2 (t % 4) + 1, t / 4) of each stored 8 x 8 matrix.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// acc[m][j] += A[64 rows, 16 * ksteps] (bf16, shared, row stride lda) times
// the weight columns of n-tiles nt0 .. nt0 + NT - 1 (of ntt).
template <int NT>
__device__ __forceinline__ void mma_rows(const __nv_bfloat16* A, int lda,
                                         int ksteps,
                                         const uint2* __restrict__ W, int ntt,
                                         int nt0, int lane,
                                         float (&acc)[kMTiles][NT][4]) {
  const uint32_t a0 = (uint32_t)__cvta_generic_to_shared(A) +
                      (uint32_t)(((lane & 15) * lda + (lane >> 4) * 8) * 2);
  const uint2* wl = W + (size_t)nt0 * 32 + lane;
#pragma unroll 2
  for (int ks = 0; ks < ksteps; ++ks) {
    uint2 b[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) b[j] = __ldg(wl + ((size_t)ks * ntt + j) * 32);
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) {
      uint32_t a[4];
      ldmatrix_x4(a, a0 + (uint32_t)((m * 16 * lda + ks * 16) * 2));
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(acc[m][j], a, b[j]);
    }
  }
}

// int8 x int8 -> int32.  For a 16 x 32 int8 tile, ldmatrix's b16 pairs
// (of the 16 x 16 b16 view) are exactly the s8 quads of the A fragment.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// acc[m][j] += A[16 * MT rows, 32 * ksteps] (int8, shared, row stride lda
// bytes) times the int8 weight columns of n-tiles nt0 .. nt0 + NT - 1 (of
// ntt); the fragments are laid out as the bf16 ones with 32-deep k steps
// (quant.py: pack_fragments_s8).
template <int MT, int NT>
__device__ __forceinline__ void mma_rows_s8(const int8_t* A, int lda,
                                            int ksteps,
                                            const uint2* __restrict__ W,
                                            int ntt, int nt0, int lane,
                                            int (&acc)[MT][NT][4]) {
  const uint32_t a0 = (uint32_t)__cvta_generic_to_shared(A) +
                      (uint32_t)((lane & 15) * lda + (lane >> 4) * 16);
  const uint2* wl = W + (size_t)nt0 * 32 + lane;
#pragma unroll 1
  for (int ks = 0; ks < ksteps; ++ks) {
    uint2 b[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) b[j] = __ldg(wl + ((size_t)ks * ntt + j) * 32);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      uint32_t a[4];
      ldmatrix_x4(a, a0 + (uint32_t)(m * 16 * lda + ks * 32));
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_s8(acc[m][j], a, b[j]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[kMTiles][NT][4]) {
#pragma unroll
  for (int m = 0; m < kMTiles; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
}

// Row / column of accumulator element e of fragment (m, j).
__device__ __forceinline__ int frag_row(int m, int e, int lane) {
  return m * 16 + (lane >> 2) + (e >= 2 ? 8 : 0);
}
__device__ __forceinline__ int frag_col(int nt, int e, int lane) {
  return nt * 8 + (lane & 3) * 2 + (e & 1);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the 8 lanes that share (lane % 4): a column of an accumulator
// fragment summed over its 8 rows-per-lane groups.
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

}  // namespace
