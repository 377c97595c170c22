// Constants and device helpers shared by the render kernels
// (render_train.cuh, render_eval.cuh): the MLP's padded widths and warp
// reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;                        // rows of an MLP chunk
constexpr int kMaxLayers = 16;
constexpr int kEncMax = 128;    // 2 * 3 * F <= 128 (F <= 21): the encoding tile
constexpr int kExtraMax = 128;  // 2 * 3 * Fd + 3 (+ kAppDim) <= 128
constexpr int kAppDim = 16;                      // appearance row of a ray
constexpr float kHalfPi = 1.57079632679489661923f;
constexpr float kF32Eps = 1.1920928955078125e-07f;

constexpr int kEncStd = 96;    // the encoding rows of an instantiation for
                               // 2 * 3 * F <= 96 (F <= 16); wider: kEncMax
// The encoding's rows as the products, the packed weights and the stash
// take them: 96 (three 32-row slices) up to F = 16, the production
// encoding's instantiation, else 128 (four, the wide instantiation); and
// the view-direction PE's (2 * 3 * Fd + 3) padded to 32-row slices (32 at
// Fd = 4).
__host__ __device__ inline int enc_rows(int F) { return 6 * F <= kEncStd ? kEncStd : kEncMax; }
__host__ __device__ inline int dirs_rows(int Fd) { return (6 * Fd + 3 + 31) / 32 * 32; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

}  // namespace
