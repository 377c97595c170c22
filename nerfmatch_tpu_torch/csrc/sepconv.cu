// Fused StarReLU + K x K depthwise convolution for Hopper (sm_90a): the
// forward, the input gradient (dgrad) and the weight gradient (wgrad).
//
// Replaces the TPU kernels of nerfmatch_tpu/ops/pallas/sepconv_kernel.py:
// _dw_star_fwd, _dw_star_dgrad and _dw_star_wgrad.  The ConvFormer token
// mixer's core, y = dwconv(s * relu(x)^2 + b, w) + cbias, with SAME zero
// padding applied AFTER the activation (a position outside the image
// contributes 0, not StarReLU's bias b).  Layout NHWC, f32 throughout.
//
// What bounds it on the H100: 49 FMA per output against one f32 read and one
// write, so the forward and dgrad are memory-bound (stage 0 of the c2f
// trunk: 2 x 240 x 240 x 256, 118 MB in and out; ~70 us at 3.35 TB/s).
// The fusion saves writing and re-reading the activation (another 118 MB
// each way per block), which cuDNN's depthwise convolution cannot fuse.
//
// Design (simple first; wgmma / TMA staging are later work):
// * threads run along C (128 channels per block, one per thread), so every
//   load of a warp is 128 contiguous bytes;
// * each thread owns an 8 x 4 output tile of its channel: it walks the
//   (8 + K - 1) input rows of the tile's halo, activates each row of
//   (4 + K - 1) values in registers (0 outside the image) and feeds every
//   output row that tap row reaches; the 49-tap sums stay in registers;
// * dgrad runs the same tile over g with the taps flipped, then forms
//   dx = 2 s relu(x) dact and the StarReLU scalar gradients; ds and db are
//   reduced per block in a fixed order into a partials buffer (no atomics:
//   two runs are bit-identical), summed by the caller;
// * wgrad: each thread accumulates the K * K tap products of its channel
//   over a 32-row x 4-column region and writes them to a (regions, K*K, C)
//   partials buffer, reduced over regions by the caller in a fixed order.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTaps = 7;          // every ConvFormer token mixer is 7 x 7
constexpr int kCh = 128;          // channels per block (one per thread)
constexpr int kTH = 8;            // output rows of a thread's tile
constexpr int kTW = 4;            // output columns of a thread's tile
constexpr int kWgradTiles = 4;    // row tiles of a wgrad region (32 rows)

__device__ __forceinline__ float star_relu(float v, float s, float b) {
  const float r = fmaxf(v, 0.f);
  return s * r * r + b;
}

// acc[oy][ox] = sum_{dy, dx} taps[dy * K + dx] * src(y0 + oy + dy - P,
// x0 + ox + dx - P) for one channel; src is StarReLU(x) when ACT, else the
// raw array, and 0 outside the image.  ``p`` points at channel c of image b.
template <int K, bool ACT>
__device__ __forceinline__ void tile_taps(const float* __restrict__ p,
                                          const float (&taps)[K * K], int y0,
                                          int x0, int H, int W, int C,
                                          float s, float b,
                                          float (&acc)[kTH][kTW]) {
  constexpr int P = K / 2;
#pragma unroll
  for (int oy = 0; oy < kTH; ++oy)
#pragma unroll
    for (int ox = 0; ox < kTW; ++ox) acc[oy][ox] = 0.f;
#pragma unroll
  for (int iy = 0; iy < kTH + K - 1; ++iy) {
    const int yy = y0 + iy - P;
    const bool row_ok = yy >= 0 && yy < H;
    float row[kTW + K - 1];
#pragma unroll
    for (int ix = 0; ix < kTW + K - 1; ++ix) {
      const int xx = x0 + ix - P;
      float v = 0.f;
      if (row_ok && xx >= 0 && xx < W) {
        v = p[((size_t)yy * W + xx) * C];
        if (ACT) v = star_relu(v, s, b);
      }
      row[ix] = v;
    }
#pragma unroll
    for (int oy = 0; oy < kTH; ++oy) {
      const int dy = iy - oy;
      if (dy < 0 || dy >= K) continue;
#pragma unroll
      for (int ox = 0; ox < kTW; ++ox)
#pragma unroll
        for (int dx = 0; dx < K; ++dx)
          acc[oy][ox] = fmaf(taps[dy * K + dx], row[ox + dx], acc[oy][ox]);
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kCh)
dw_star_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ cbias,
                   const float* __restrict__ sb, float* __restrict__ y,
                   int H, int W, int C, int tiles_w) {
  const int c = blockIdx.x * kCh + threadIdx.x;
  const int y0 = (blockIdx.y / tiles_w) * kTH;
  const int x0 = (blockIdx.y % tiles_w) * kTW;
  const size_t img = (size_t)blockIdx.z * H * W * C;
  float taps[K * K];
#pragma unroll
  for (int i = 0; i < K * K; ++i) taps[i] = w[(size_t)i * C + c];
  float acc[kTH][kTW];
  tile_taps<K, true>(x + img + c, taps, y0, x0, H, W, C, sb[0], sb[1], acc);
  const float cb = cbias[c];
#pragma unroll
  for (int oy = 0; oy < kTH; ++oy)
#pragma unroll
    for (int ox = 0; ox < kTW; ++ox)
      if (y0 + oy < H && x0 + ox < W)
        y[img + ((size_t)(y0 + oy) * W + x0 + ox) * C + c] = acc[oy][ox] + cb;
}

// Fixed-order sum over the block's 128 threads (warp xor tree, then warps
// in order); the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < kCh / 32; ++i) total += red[i];
  return total;
}

template <int K>
__global__ void __launch_bounds__(kCh)
dw_star_dgrad_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ w, const float* __restrict__ sb,
                     float* __restrict__ dx, float* __restrict__ part,
                     int H, int W, int C, int tiles_w) {
  __shared__ float red[kCh / 32];
  const int c = blockIdx.x * kCh + threadIdx.x;
  const int y0 = (blockIdx.y / tiles_w) * kTH;
  const int x0 = (blockIdx.y % tiles_w) * kTW;
  const size_t img = (size_t)blockIdx.z * H * W * C;
  // Correlation of g with the flipped taps: flipping both axes reverses
  // the flat tap index.
  float taps[K * K];
#pragma unroll
  for (int i = 0; i < K * K; ++i) taps[i] = w[(size_t)(K * K - 1 - i) * C + c];
  float dact[kTH][kTW];
  tile_taps<K, false>(g + img + c, taps, y0, x0, H, W, C, 0.f, 0.f, dact);
  const float s = sb[0];
  float ds = 0.f, db = 0.f;
#pragma unroll
  for (int oy = 0; oy < kTH; ++oy)
#pragma unroll
    for (int ox = 0; ox < kTW; ++ox)
      if (y0 + oy < H && x0 + ox < W) {
        const size_t off = img + ((size_t)(y0 + oy) * W + x0 + ox) * C + c;
        const float r = fmaxf(x[off], 0.f);
        const float d = dact[oy][ox];
        dx[off] = 2.f * s * r * d;
        ds = fmaf(d, r * r, ds);
        db += d;
      }
  const size_t blk =
      ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  const float ds_blk = block_sum(ds, red);
  if (threadIdx.x == 0) part[2 * blk] = ds_blk;
  const float db_blk = block_sum(db, red);
  if (threadIdx.x == 0) part[2 * blk + 1] = db_blk;
}

template <int K>
__global__ void __launch_bounds__(kCh)
dw_star_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ sb, float* __restrict__ part,
                     int H, int W, int C, int tiles_w) {
  constexpr int P = K / 2;
  const int c = blockIdx.x * kCh + threadIdx.x;
  const int region = blockIdx.y;
  const int x0 = (region % tiles_w) * kTW;
  const int yr = (region / tiles_w) * kTH * kWgradTiles;
  const size_t img = (size_t)blockIdx.z * H * W * C;
  const float* xp = x + img + c;
  const float* gp = g + img + c;
  const float s = sb[0], b = sb[1];
  float acc[K * K];
#pragma unroll
  for (int i = 0; i < K * K; ++i) acc[i] = 0.f;
  for (int t = 0; t < kWgradTiles; ++t) {
    const int y0 = yr + t * kTH;
    if (y0 >= H) break;
    float gr[kTH][kTW];
#pragma unroll
    for (int oy = 0; oy < kTH; ++oy)
#pragma unroll
      for (int ox = 0; ox < kTW; ++ox)
        gr[oy][ox] = (y0 + oy < H && x0 + ox < W)
                         ? gp[((size_t)(y0 + oy) * W + x0 + ox) * C]
                         : 0.f;
#pragma unroll
    for (int iy = 0; iy < kTH + K - 1; ++iy) {
      const int yy = y0 + iy - P;
      const bool row_ok = yy >= 0 && yy < H;
      float row[kTW + K - 1];
#pragma unroll
      for (int ix = 0; ix < kTW + K - 1; ++ix) {
        const int xx = x0 + ix - P;
        row[ix] = (row_ok && xx >= 0 && xx < W)
                      ? star_relu(xp[((size_t)yy * W + xx) * C], s, b)
                      : 0.f;
      }
#pragma unroll
      for (int oy = 0; oy < kTH; ++oy) {
        const int dy = iy - oy;
        if (dy < 0 || dy >= K) continue;
#pragma unroll
        for (int dxi = 0; dxi < K; ++dxi)
#pragma unroll
          for (int ox = 0; ox < kTW; ++ox)
            acc[dy * K + dxi] = fmaf(gr[oy][ox], row[ox + dxi],
                                     acc[dy * K + dxi]);
      }
    }
  }
  float* dst = part + ((size_t)blockIdx.z * gridDim.y + region) * K * K * C + c;
#pragma unroll
  for (int i = 0; i < K * K; ++i) dst[(size_t)i * C] = acc[i];
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

bool bad_shape(int B, int H, int W, int C, int K) {
  return K != kTaps || B < 1 || H < 1 || W < 1 || C < kCh || C % kCh != 0;
}

}  // namespace

// x (B, H, W, C) pre-activation; w (K, K, C); cbias (C,); sb = [s, b] on the
// device; y (B, H, W, C).
extern "C" int nm_dw_star_forward(const void* x, const void* w,
                                  const void* cbias, const void* sb, void* y,
                                  int B, int H, int W, int C, int K,
                                  void* stream) {
  if (bad_shape(B, H, W, C, K)) return (int)cudaErrorInvalidValue;
  const int tiles_w = ceil_div(W, kTW);
  const dim3 grid(C / kCh, ceil_div(H, kTH) * tiles_w, B);
  cudaStream_t s = (cudaStream_t)stream;
  const float *xp = (const float*)x, *wp = (const float*)w,
              *cp = (const float*)cbias, *sp = (const float*)sb;
  float* yp = (float*)y;
  dw_star_fwd_kernel<kTaps><<<grid, kCh, 0, s>>>(xp, wp, cp, sp, yp, H, W, C, tiles_w);
  return (int)cudaGetLastError();
}

// dx (B, H, W, C); part (blocks, 2): per-block [ds, db] partials, blocks =
// (C / 128) * ceil(H / 8) * ceil(W / 4) * B.
extern "C" int nm_dw_star_dgrad(const void* x, const void* g, const void* w,
                                const void* sb, void* dx, void* part, int B,
                                int H, int W, int C, int K, void* stream) {
  if (bad_shape(B, H, W, C, K)) return (int)cudaErrorInvalidValue;
  const int tiles_w = ceil_div(W, kTW);
  const dim3 grid(C / kCh, ceil_div(H, kTH) * tiles_w, B);
  cudaStream_t s = (cudaStream_t)stream;
  const float *xp = (const float*)x, *gp = (const float*)g,
              *wp = (const float*)w, *sp = (const float*)sb;
  float *dxp = (float*)dx, *pp = (float*)part;
  dw_star_dgrad_kernel<kTaps><<<grid, kCh, 0, s>>>(xp, gp, wp, sp, dxp, pp, H, W, C, tiles_w);
  return (int)cudaGetLastError();
}

// part (B * ceil(H / 32) * ceil(W / 4), K * K, C): per-region tap sums.
extern "C" int nm_dw_star_wgrad(const void* x, const void* g, const void* sb,
                                void* part, int B, int H, int W, int C, int K,
                                void* stream) {
  if (bad_shape(B, H, W, C, K)) return (int)cudaErrorInvalidValue;
  const int tiles_w = ceil_div(W, kTW);
  const dim3 grid(C / kCh, ceil_div(H, kTH * kWgradTiles) * tiles_w, B);
  cudaStream_t s = (cudaStream_t)stream;
  const float *xp = (const float*)x, *gp = (const float*)g,
              *sp = (const float*)sb;
  float* pp = (float*)part;
  dw_star_wgrad_kernel<kTaps><<<grid, kCh, 0, s>>>(xp, gp, sp, pp, H, W, C, tiles_w);
  return (int)cudaGetLastError();
}
