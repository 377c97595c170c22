// Constants and device helpers shared by the render kernels
// (render_train.cu, render_eval.cu): the MLP's padded widths and warp
// reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;                        // rows of an MLP chunk
constexpr int kMaxLayers = 16;
constexpr int kEncMax = 96;                      // 2 * 3 * F <= 96, padded K
constexpr int kDirsMax = 32;                     // 2 * 3 * Fd + 3
constexpr int kAppDim = 16;                      // appearance row of a ray
constexpr float kHalfPi = 1.57079632679489661923f;
constexpr float kF32Eps = 1.1920928955078125e-07f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

}  // namespace
