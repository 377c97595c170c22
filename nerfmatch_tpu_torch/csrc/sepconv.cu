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
// trunk: 2 x 240 x 240 x 256, 118 MB in and out; ~70 us at 3.35 TB/s), with
// the f32 FMAs (43 us at 67 TFLOP/s) close behind: loads and arithmetic have
// to overlap.  The wgrad reads x and g (236 MB, the same ~70 us) for the
// same FMAs and writes only dw.  The fusion saves writing and re-reading
// the activation (another 118 MB each way per block), which cuDNN's
// depthwise convolution cannot fuse.
//
// Forward and dgrad share one tile engine (dw_star_tile_kernel):
// * a persistent grid of one 512-thread block per SM (the forward's cut to
//   a multiple of the channel groups, so a block keeps one) walks tiles of
//   16 x 16 output pixels x 32 channels statically (tile blockIdx.x + i *
//   gridDim.x; image, tile row, tile column, channel group innermost), so
//   the blocks at work at one time read whole pixels and the partial sums
//   come out in a fixed order;
// * each tile's (16 + 6) x (16 + 6) x 32 input halo is staged in shared
//   memory by one TMA load (a 4-D tensor map over the NHWC array, encoded on
//   the host; the copy engine's zero fill is the padding at image edges),
//   behind an mbarrier, in a ring of two stages: tile i + 2 loads while tile
//   i + 1 computes.  The 49 x 32 taps come with a tile whose channel group
//   differs from the block's last (in the forward, its first tile only);
// * forward: one pass over the landed halo applies StarReLU to in-image
//   positions and writes 0 elsewhere (StarReLU(0) = b, so the zero fill is
//   not the activated map's padding); dgrad correlates g, whose zero fill
//   is its padding, with the flipped taps, and stages x at the tile's
//   outputs (no halo) behind the same mbarrier;
// * a warp computes a 4 x 4 output patch of the tile's 32 channels, a lane
//   per channel (shared-memory reads free of bank conflicts), its 49 taps in
//   registers, sliding a row of 10 inputs down the 10 halo rows: 7.8 FMA per
//   shared load;
// * forward epilogue: y = acc + cbias into an output buffer, then one TMA
//   store a tile (it writes nothing outside the array).  dgrad epilogue,
//   from registers (its two stages leave no room for a buffer): dx = 2 s
//   relu(x) dact, 128 bytes a warp, and per-thread ds, db over every tile
//   the block walks, reduced once per block in a fixed order into a
//   partials buffer (no atomics: two runs are bit-identical), summed by the
//   caller.
//
// wgrad (kernel 9) runs on the same walk and ring (dw_star_wgrad_kernel):
// * a stage holds the tile's x halo, activated in place as the forward's,
//   and g at the tile's 16 x 16 outputs (g's zero fill is its padding: a g
//   outside the image adds nothing), both by TMA behind one mbarrier;
// * the grid is a multiple of the channel groups, so a block keeps one
//   group, and each warp keeps its 49 tap sums of its lane's channel in
//   registers across every tile of its walk: per halo row it slides a row
//   of 10 activated inputs against its 4 x 4 g values (6.8 FMA per shared
//   load), with no partial sum per tile;
// * after the walk the block sums its 16 warps' 49 x 32 sums in warp order
//   through shared memory (the ring is idle by then) into one partials row
//   per block, and a second launch (wgrad_sum_kernel) sums the rows of each
//   channel group in row order into dw (K, K, C).  No atomics: two runs are
//   bit-identical.  The rows' count is the grid, so the sum's order (and
//   its last bits) follows the SM count.

#include <cuda.h>   // CUtensorMap and its enums (libcuda itself is not linked)
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "wgmma_common.cuh"

namespace {

constexpr int kTaps = 7;          // every ConvFormer token mixer is 7 x 7
constexpr int kPad = kTaps / 2;
constexpr int kCh = 128;          // channel multiple the kernels take

// Forward and dgrad tile engine.
constexpr int kTileH = 16;        // output rows of a tile
constexpr int kTileW = 16;        // output columns of a tile
constexpr int kTileC = 32;        // channels of a tile, one per lane
constexpr int kHaloH = kTileH + kTaps - 1;
constexpr int kHaloW = kTileW + kTaps - 1;
constexpr int kPatch = 4;         // a warp's patch: 4 x 4 outputs
constexpr int kPatchCols = kTileW / kPatch;
constexpr int kWarps = (kTileH / kPatch) * kPatchCols;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;        // tiles in flight: the ring's stages
constexpr uint32_t kHaloBytes = kHaloH * kHaloW * kTileC * 4;
constexpr uint32_t kInBytes = kTileH * kTileW * kTileC * 4;
constexpr uint32_t kTapBytes = kTaps * kTaps * kTileC * 4;

// One stage of the ring: the halo, (dgrad) x at the outputs, the taps.
// Every region is a multiple of 128 bytes, as TMA destinations need.
template <bool kDgrad>
struct Stage {
  static constexpr uint32_t kX = kHaloBytes;
  static constexpr uint32_t kW = kX + (kDgrad ? kInBytes : 0);
  static constexpr uint32_t kBytes = kW + kTapBytes;
};

__device__ __forceinline__ float star_relu(float v, float s, float b) {
  const float r = fmaxf(v, 0.f);
  return s * r * r + b;
}

// TMA tile loads (coordinates innermost first; out-of-range elements are
// written as 0) completing on the mbarrier bar.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// A (kTileC, kTileW, kTileH, 1) tile shared -> global by TMA (elements
// outside the array are not written), in this thread's bulk group.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// This thread's bulk stores are complete.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The tiles in the order the blocks walk them: image, tile row, tile
// column, channel group innermost, so the blocks at work at one time read
// whole pixels (every channel group of neighbouring tiles).
struct Tile {
  int grp, b, y0, x0;
};

struct Tiles {
  int groups, tiles_w, tiles_hw, count;
  __host__ __device__ Tiles(int B, int H, int W, int C) {
    groups = C / kTileC;
    tiles_w = (W + kTileW - 1) / kTileW;
    tiles_hw = tiles_w * ((H + kTileH - 1) / kTileH);
    count = groups * B * tiles_hw;
  }
  __device__ Tile at(int t) const {
    const int grp = t % groups, r = t / groups;
    const int yx = r % tiles_hw;
    return {grp, r / tiles_hw, (yx / tiles_w) * kTileH, (yx % tiles_w) * kTileW};
  }
};

// StarReLU over the landed halo of the tile at (y0, x0), in place; 0 at
// positions outside the image (an interior tile has none: no test there).
__device__ __forceinline__ void activate(float* halo, int y0, int x0, int H,
                                         int W, float s, float b) {
  float4* h4 = reinterpret_cast<float4*>(halo);
  constexpr int n4 = kHaloH * kHaloW * kTileC / 4;
  if (y0 >= kPad && x0 >= kPad && y0 + kTileH + kPad <= H &&
      x0 + kTileW + kPad <= W) {
    for (int e = threadIdx.x; e < n4; e += kThreads) {
      float4 v = h4[e];
      v = make_float4(star_relu(v.x, s, b), star_relu(v.y, s, b),
                      star_relu(v.z, s, b), star_relu(v.w, s, b));
      h4[e] = v;
    }
    return;
  }
  for (int e = threadIdx.x; e < n4; e += kThreads) {
    const int p = e / (kTileC / 4);
    const int hy = p / kHaloW, hx = p - hy * kHaloW;
    const bool in = (unsigned)(y0 - kPad + hy) < (unsigned)H &&
                    (unsigned)(x0 - kPad + hx) < (unsigned)W;
    float4 v = h4[e];
    v.x = in ? star_relu(v.x, s, b) : 0.f;
    v.y = in ? star_relu(v.y, s, b) : 0.f;
    v.z = in ? star_relu(v.z, s, b) : 0.f;
    v.w = in ? star_relu(v.w, s, b) : 0.f;
    h4[e] = v;
  }
}

// acc[oy][ox] = sum_{dy, dx} taps[dy * K + dx] * src[((oy + dy) * kHaloW +
// ox + dx) * kTileC]: ``src`` points at the patch's corner of the halo, at
// this lane's channel.
__device__ __forceinline__ void patch_taps(const float* src,
                                           const float (&taps)[kTaps * kTaps],
                                           float (&acc)[kPatch][kPatch]) {
#pragma unroll
  for (int oy = 0; oy < kPatch; ++oy)
#pragma unroll
    for (int ox = 0; ox < kPatch; ++ox) acc[oy][ox] = 0.f;
#pragma unroll
  for (int iy = 0; iy < kPatch + kTaps - 1; ++iy) {
    float row[kPatch + kTaps - 1];
#pragma unroll
    for (int ix = 0; ix < kPatch + kTaps - 1; ++ix)
      row[ix] = src[(iy * kHaloW + ix) * kTileC];
#pragma unroll
    for (int oy = 0; oy < kPatch; ++oy) {
      const int dy = iy - oy;
      if (dy < 0 || dy >= kTaps) continue;
#pragma unroll
      for (int ox = 0; ox < kPatch; ++ox)
#pragma unroll
        for (int dx = 0; dx < kTaps; ++dx)
          acc[oy][ox] = fmaf(taps[dy * kTaps + dx], row[ox + dx], acc[oy][ox]);
    }
  }
}

// Shared memory of the tile kernel: the ring, (forward) the output tile
// for its TMA store, the mbarriers, the block's [ds, db] per warp.  The
// dgrad stores from registers: its two stages leave no room for an output
// tile, and a store from x's slot would hold back the next tile's load.
template <bool kDgrad>
struct Smem {
  static constexpr uint32_t kOut = kStages * Stage<kDgrad>::kBytes;
  static constexpr uint32_t kBars = kOut + (kDgrad ? 0 : kInBytes);
  static constexpr uint32_t kRed = kBars + 8 * kStages;
  static constexpr uint32_t kBytes = kRed + 2 * kWarps * 4;
};

// Forward (kDgrad false): in_map is x, out and out_map y.  dgrad: in_map is
// g, x_map x (a tile's outputs, no halo), out dx, and part gets the block's
// [ds, db].  w_map: the taps as a (K * K, C) array.  s, b: StarReLU's
// scalars on the device (dgrad reads s only).
template <bool kDgrad>
__global__ void __launch_bounds__(kThreads, 1)
dw_star_tile_kernel(const __grid_constant__ CUtensorMap in_map,
                    const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap w_map,
                    const __grid_constant__ CUtensorMap out_map,
                    const float* __restrict__ cbias,
                    const float* __restrict__ s_ptr,
                    const float* __restrict__ b_ptr, float* __restrict__ out,
                    float* __restrict__ part, int B, int H, int W, int C) {
  using L = Stage<kDgrad>;
  using M = Smem<kDgrad>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t sm0 = smem_u32(smem_raw);
  const uint32_t bars = sm0 + M::kBars;
  float* red = reinterpret_cast<float*>(smem_raw + M::kRed);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Tiles tl(B, H, W, C);
  const int mine = (tl.count - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int tile0 = blockIdx.x;
  auto tile = [&](int i) { return tl.at(tile0 + i * (int)gridDim.x); };
  // The taps travel with a tile whose channel group differs from the last's.
  auto new_taps = [&](int i) { return i == 0 || tile(i).grp != tile(i - 1).grp; };

  // Thread 0: stage tile i (the expected bytes next to the copies).
  auto load_tile = [&](int i) {
    const int st = i % kStages;
    const uint32_t base = sm0 + st * L::kBytes, bar = bars + 8 * st;
    const Tile tt = tile(i);
    const int c0 = tt.grp * kTileC;
    const bool taps = new_taps(i);
    mbar_expect(bar, kHaloBytes + (kDgrad ? kInBytes : 0) + (taps ? kTapBytes : 0));
    tma_load_4d(base, &in_map, bar, c0, tt.x0 - kPad, tt.y0 - kPad, tt.b);
    if (kDgrad) tma_load_4d(base + L::kX, &x_map, bar, c0, tt.x0, tt.y0, tt.b);
    if (taps) tma_load_2d(base + L::kW, &w_map, bar, c0, 0);
  };

  if (tid == 0)
    for (int st = 0; st < kStages; ++st) mbar_init(bars + 8 * st);
  fence_async();
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < kStages && i < mine; ++i) load_tile(i);

  const int py = (warp / kPatchCols) * kPatch, px = (warp % kPatchCols) * kPatch;
  const float s = *s_ptr;
  const float b_act = kDgrad ? 0.f : *b_ptr;
  float taps[kTaps * kTaps];
  float cb = 0.f, ds = 0.f, db = 0.f;
  for (int i = 0; i < mine; ++i) {
    const int st = i % kStages;
    const Tile tt = tile(i);
    const int grp = tt.grp, b = tt.b, y0 = tt.y0, x0 = tt.x0;
    float* stage = reinterpret_cast<float*>(smem_raw + st * L::kBytes);
    float* halo = stage;
    mbar_wait(bars + 8 * st, (i / kStages) & 1);
    if (!kDgrad) {
      if (tid == 0) bulk_read_done();   // the last tile's y is out
      activate(halo, y0, x0, H, W, s, b_act);
      __syncthreads();   // the activated halo (and the output buffer is free)
    }
    if (new_taps(i)) {
      const float* wt = stage + L::kW / 4 + lane;
#pragma unroll
      for (int k = 0; k < kTaps * kTaps; ++k)   // dgrad: flipped taps
        taps[k] = wt[(kDgrad ? kTaps * kTaps - 1 - k : k) * kTileC];
      if (!kDgrad) cb = cbias[grp * kTileC + lane];
    }
    float acc[kPatch][kPatch];
    patch_taps(halo + (py * kHaloW + px) * kTileC + lane, taps, acc);

    // Epilogue before the tile's barrier, so one warp's stores overlap the
    // others' products.  ``ot``: this thread's outputs in a (kTileH, kTileW,
    // kTileC) tile, x's slot of the stage (dgrad) or the output buffer.
    const int oy0 = y0 + py, ox0 = x0 + px;
    float* o = out + (((size_t)b * H + oy0) * W + ox0) * C + grp * kTileC + lane;
    float* ot = reinterpret_cast<float*>(smem_raw + (kDgrad ? st * L::kBytes + L::kX : M::kOut)) +
                (py * kTileW + px) * kTileC + lane;
    float ds_t = 0.f, db_t = 0.f;
#pragma unroll
    for (int oy = 0; oy < kPatch; ++oy)
#pragma unroll
      for (int ox = 0; ox < kPatch; ++ox) {
        float& slot = ot[(oy * kTileW + ox) * kTileC];
        if (!kDgrad) {   // TMA writes nothing outside the array
          slot = acc[oy][ox] + cb;
          continue;
        }
        if (oy0 + oy >= H || ox0 + ox >= W) continue;
        const size_t off = ((size_t)oy * W + ox) * C;
        const float rx = fmaxf(slot, 0.f), d = acc[oy][ox];
        o[off] = 2.f * s * rx * d;
        ds_t = fmaf(d, rx * rx, ds_t);
        db_t += d;
      }
    ds += ds_t;
    db += db_t;
    if (!kDgrad) fence_async();   // the halo and y writes, for TMA
    __syncthreads();   // stage st is free (and the output tile complete)
    if (tid == 0) {
      if (!kDgrad) tma_store_4d(&out_map, sm0 + M::kOut, grp * kTileC, x0, y0, b);
      if (i + kStages < mine) load_tile(i + kStages);
    }
  }
  if (!kDgrad && tid == 0) bulk_wait_all();

  if (kDgrad) {   // the block's [ds, db]: warp xor trees, then warps in order
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      ds += __shfl_xor_sync(0xffffffffu, ds, m);
      db += __shfl_xor_sync(0xffffffffu, db, m);
    }
    if (lane == 0) {
      red[2 * warp] = ds;
      red[2 * warp + 1] = db;
    }
    __syncthreads();
    if (tid == 0) {
      float ds_b = 0.f, db_b = 0.f;
      for (int k = 0; k < kWarps; ++k) {
        ds_b += red[2 * k];
        db_b += red[2 * k + 1];
      }
      part[2 * blockIdx.x] = ds_b;
      part[2 * blockIdx.x + 1] = db_b;
    }
  }
}

// acc[dy * K + dx] += sum_{oy, ox} gp[oy][ox] * src[((oy + dy) * kHaloW +
// ox + dx) * kTileC], oy ascending: ``src`` points at the patch's corner of
// the activated halo, ``gp`` at its first output of the g tile, both at
// this lane's channel.
__device__ __forceinline__ void patch_wgrad(const float* src, const float* gp,
                                            float (&acc)[kTaps * kTaps]) {
  float gv[kPatch][kPatch];
#pragma unroll
  for (int oy = 0; oy < kPatch; ++oy)
#pragma unroll
    for (int ox = 0; ox < kPatch; ++ox) gv[oy][ox] = gp[(oy * kTileW + ox) * kTileC];
#pragma unroll
  for (int iy = 0; iy < kPatch + kTaps - 1; ++iy) {
    float row[kPatch + kTaps - 1];
#pragma unroll
    for (int ix = 0; ix < kPatch + kTaps - 1; ++ix)
      row[ix] = src[(iy * kHaloW + ix) * kTileC];
#pragma unroll
    for (int oy = 0; oy < kPatch; ++oy) {
      const int dy = iy - oy;
      if (dy < 0 || dy >= kTaps) continue;
#pragma unroll
      for (int ox = 0; ox < kPatch; ++ox)
#pragma unroll
        for (int dx = 0; dx < kTaps; ++dx)
          acc[dy * kTaps + dx] = fmaf(gv[oy][ox], row[ox + dx], acc[dy * kTaps + dx]);
    }
  }
}

// Shared memory of the wgrad: the ring (a stage: the halo, then g at the
// outputs), after the walk the warps' tap sums in its place, the mbarriers.
struct WgradSmem {
  static constexpr uint32_t kStage = kHaloBytes + kInBytes;
  static constexpr uint32_t kRing = kStages * kStage;
  static constexpr uint32_t kRed = kWarps * kTapBytes;
  static constexpr uint32_t kBars = kRing > kRed ? kRing : kRed;
  static constexpr uint32_t kBytes = kBars + 8 * kStages;
};

// x_map: x with the halo box; g_map: g with the tile box.  part (gridDim.x,
// K * K, kTileC): the block's tap sums over its walk; the grid is a
// multiple of the channel groups, so block k keeps group k % groups.
__global__ void __launch_bounds__(kThreads, 1)
dw_star_wgrad_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap g_map,
                     const float* __restrict__ s_ptr,
                     const float* __restrict__ b_ptr, float* __restrict__ part,
                     int B, int H, int W, int C) {
  using M = WgradSmem;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t sm0 = smem_u32(smem_raw);
  const uint32_t bars = sm0 + M::kBars;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Tiles tl(B, H, W, C);
  const int mine = (tl.count - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  auto tile = [&](int i) { return tl.at((int)blockIdx.x + i * (int)gridDim.x); };

  // Thread 0: stage tile i (the expected bytes next to the copies).
  auto load_tile = [&](int i) {
    const int st = i % kStages;
    const uint32_t base = sm0 + st * M::kStage, bar = bars + 8 * st;
    const Tile tt = tile(i);
    const int c0 = tt.grp * kTileC;
    mbar_expect(bar, kHaloBytes + kInBytes);
    tma_load_4d(base, &x_map, bar, c0, tt.x0 - kPad, tt.y0 - kPad, tt.b);
    tma_load_4d(base + kHaloBytes, &g_map, bar, c0, tt.x0, tt.y0, tt.b);
  };

  if (tid == 0)
    for (int st = 0; st < kStages; ++st) mbar_init(bars + 8 * st);
  fence_async();
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < kStages && i < mine; ++i) load_tile(i);

  const int py = (warp / kPatchCols) * kPatch, px = (warp % kPatchCols) * kPatch;
  const float s = *s_ptr, b = *b_ptr;
  float acc[kTaps * kTaps];
#pragma unroll
  for (int k = 0; k < kTaps * kTaps; ++k) acc[k] = 0.f;
  for (int i = 0; i < mine; ++i) {
    const int st = i % kStages;
    const Tile tt = tile(i);
    float* halo = reinterpret_cast<float*>(smem_raw + st * M::kStage);
    mbar_wait(bars + 8 * st, (i / kStages) & 1);
    activate(halo, tt.y0, tt.x0, H, W, s, b);
    __syncthreads();   // the activated halo
    patch_wgrad(halo + (py * kHaloW + px) * kTileC + lane,
                halo + kHaloBytes / 4 + (py * kTileW + px) * kTileC + lane, acc);
    fence_async();     // the halo writes, before TMA overwrites the stage
    __syncthreads();   // stage st is free
    if (tid == 0 && i + kStages < mine) load_tile(i + kStages);
  }

  // Every load was waited for: the ring is idle.  The warps' sums, then the
  // block's, warps in order.
  float* red = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int k = 0; k < kTaps * kTaps; ++k)
    red[(warp * kTaps * kTaps + k) * kTileC + lane] = acc[k];
  __syncthreads();
  constexpr int kRow = kTaps * kTaps * kTileC;
  float* dst = part + (size_t)blockIdx.x * kRow;
  for (int e = tid; e < kRow; e += kThreads) {
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) v += red[k * kRow + e];
    dst[e] = v;
  }
}

// dw[k, grp * kTileC + lane] = the sum of the group's partials rows (blocks
// grp, grp + groups, ...) in row order.  Grid (groups, K * K), kTileC
// threads.
__global__ void __launch_bounds__(kTileC)
wgrad_sum_kernel(const float* __restrict__ part, float* __restrict__ dw,
                 int groups, int rows, int C) {
  const int grp = blockIdx.x, k = blockIdx.y, lane = threadIdx.x;
  const float* src = part + ((size_t)grp * kTaps * kTaps + k) * kTileC + lane;
  const size_t step = (size_t)groups * kTaps * kTaps * kTileC;
  float v = 0.f;
#pragma unroll 4
  for (int r = 0; r < rows; ++r) v += src[r * step];
  dw[(size_t)k * C + grp * kTileC + lane] = v;
}

bool bad_shape(int B, int H, int W, int C, int K) {
  return K != kTaps || B < 1 || H < 1 || W < 1 || C < kCh || C % kCh != 0;
}

// cuTensorMapEncodeTiled, reached through the runtime (no link to libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                     12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A tensor map over a row-major f32 array of the given dims (innermost
// first), with a box of the given sizes; elements outside it read as 0.
template <int N>
cudaError_t tensor_map(CUtensorMap* map, const void* p, const cuuint64_t (&dims)[N],
                       const cuuint32_t (&box)[N]) {
  EncodeTiled encode;
  const cudaError_t e = encoder(&encode);
  if (e != cudaSuccess) return e;
  cuuint64_t strides[N > 1 ? N - 1 : 1];
  cuuint64_t stride = 4;
  for (int i = 0; i + 1 < N; ++i) strides[i] = stride *= dims[i];
  cuuint32_t ones[N];
  for (int i = 0; i < N; ++i) ones[i] = 1;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, N,
                            const_cast<void*>(p), dims, strides, box, ones,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

constexpr int kMaxDevices = 64;

// The current device and its SM count, queried once per device.
cudaError_t device_sms(int* dev, int* sms) {
  static std::atomic<int> cached[kMaxDevices];
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return e;
  if (*dev >= kMaxDevices) return cudaErrorInvalidDevice;
  *sms = cached[*dev].load(std::memory_order_relaxed);
  if (*sms == 0) {
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
    if (e != cudaSuccess) return e;
    cached[*dev].store(*sms, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

// The persistent grid: one block per SM (a block's two stages take most of
// the SM's shared memory), at most one per tile.  The forward's is cut to a
// multiple of the channel groups, so each block keeps one channel group and
// its taps for all its tiles (reloading them costs the forward's
// instruction slots); the dgrad, held by memory, takes every SM.
template <bool kDgrad>
cudaError_t tile_grid(int B, int H, int W, int C, int* grid) {
  int dev = 0, sms = 0;
  const cudaError_t e = device_sms(&dev, &sms);
  if (e != cudaSuccess) return e;
  const Tiles tl(B, H, W, C);
  if (!kDgrad && sms > tl.groups) sms -= sms % tl.groups;
  *grid = tl.count < sms ? tl.count : sms;
  return cudaSuccess;
}

// The wgrad's grid: a multiple of the channel groups (a block keeps one
// group, and its tap sums, for all its tiles), one block per SM where the
// SMs outnumber the groups, else one per group; at most one per tile.
cudaError_t wgrad_grid(int B, int H, int W, int C, int* grid) {
  int dev = 0, sms = 0;
  const cudaError_t e = device_sms(&dev, &sms);
  if (e != cudaSuccess) return e;
  const Tiles tl(B, H, W, C);
  const int blocks = (sms > tl.groups ? sms / tl.groups : 1) * tl.groups;
  *grid = tl.count < blocks ? tl.count : blocks;   // count: a multiple too
  return cudaSuccess;
}

// Lets ``kernel`` take ``bytes`` of dynamic shared memory, once per device
// (kId tells the kernels apart).
template <int kId>
cudaError_t allow_smem(const void* kernel, int bytes) {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0, sms = 0;
  cudaError_t e = device_sms(&dev, &sms);
  if (e != cudaSuccess || done[dev].load(std::memory_order_relaxed)) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) done[dev].store(true, std::memory_order_relaxed);
  return e;
}

// in: x (forward) or g (dgrad); x: x (dgrad only).  grid: the blocks, any
// number in [1, tiles] (the tiles are dealt round-robin).
template <bool kDgrad>
cudaError_t launch_tiles(const void* in, const void* x, const void* w,
                         const float* cbias, const float* s, const float* b,
                         float* out, float* part, int B, int H, int W, int C,
                         int grid, cudaStream_t stream) {
  if (grid < 1 || grid > Tiles(B, H, W, C).count) return cudaErrorInvalidValue;
  const cuuint64_t nhwc[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint32_t halo_box[4] = {kTileC, kHaloW, kHaloH, 1};
  const cuuint32_t tile_box[4] = {kTileC, kTileW, kTileH, 1};
  const cuuint64_t taps[2] = {(cuuint64_t)C, kTaps * kTaps};
  const cuuint32_t taps_box[2] = {kTileC, kTaps * kTaps};
  CUtensorMap in_map, x_map, w_map, out_map;
  cudaError_t e = tensor_map(&in_map, in, nhwc, halo_box);
  if (e == cudaSuccess) e = tensor_map(&w_map, w, taps, taps_box);
  x_map = in_map;   // the forward reads no x tile
  if (kDgrad && e == cudaSuccess) e = tensor_map(&x_map, x, nhwc, tile_box);
  out_map = in_map;   // the dgrad stores from registers
  if (!kDgrad && e == cudaSuccess) e = tensor_map(&out_map, out, nhwc, tile_box);
  if (e == cudaSuccess)
    e = allow_smem<kDgrad>(reinterpret_cast<const void*>(dw_star_tile_kernel<kDgrad>),
                           (int)Smem<kDgrad>::kBytes);
  if (e != cudaSuccess) return e;
  dw_star_tile_kernel<kDgrad><<<grid, kThreads, Smem<kDgrad>::kBytes, stream>>>(
      in_map, x_map, w_map, out_map, cbias, s, b, out, part, B, H, W, C);
  return cudaGetLastError();
}

// dw (K, K, C) from the wgrad kernel's partials rows (part: grid rows of
// K * K x kTileC) and their sum.  grid: a multiple of the channel groups in
// [groups, tiles].
cudaError_t launch_wgrad(const void* x, const void* g, const float* s,
                         const float* b, float* dw, float* part, int B, int H,
                         int W, int C, int grid, cudaStream_t stream) {
  const Tiles tl(B, H, W, C);
  if (grid < tl.groups || grid > tl.count || grid % tl.groups != 0)
    return cudaErrorInvalidValue;
  const cuuint64_t nhwc[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint32_t halo_box[4] = {kTileC, kHaloW, kHaloH, 1};
  const cuuint32_t tile_box[4] = {kTileC, kTileW, kTileH, 1};
  CUtensorMap x_map, g_map;
  cudaError_t e = tensor_map(&x_map, x, nhwc, halo_box);
  if (e == cudaSuccess) e = tensor_map(&g_map, g, nhwc, tile_box);
  if (e == cudaSuccess)
    e = allow_smem<2>(reinterpret_cast<const void*>(dw_star_wgrad_kernel),
                      (int)WgradSmem::kBytes);
  if (e != cudaSuccess) return e;
  dw_star_wgrad_kernel<<<grid, kThreads, WgradSmem::kBytes, stream>>>(
      x_map, g_map, s, b, part, B, H, W, C);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  wgrad_sum_kernel<<<dim3(tl.groups, kTaps * kTaps), kTileC, 0, stream>>>(
      part, dw, tl.groups, grid / tl.groups, C);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, C) pre-activation; w (K, K, C); cbias (C,); s, b: StarReLU's
// scalars on the device; y (B, H, W, C).  x and w 16-byte aligned.
extern "C" int nm_dw_star_forward(const void* x, const void* w,
                                  const void* cbias, const void* s,
                                  const void* b, void* y, int B, int H, int W,
                                  int C, int K, void* stream) {
  if (bad_shape(B, H, W, C, K)) return (int)cudaErrorInvalidValue;
  int grid = 0;
  const cudaError_t e = tile_grid<false>(B, H, W, C, &grid);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_tiles<false>(x, nullptr, w, (const float*)cbias,
                                  (const float*)s, (const float*)b, (float*)y,
                                  nullptr, B, H, W, C, grid, (cudaStream_t)stream);
}

// The dgrad's grid for this shape on the current device, into *parts: the
// rows of [ds, db] partials to give nm_dw_star_dgrad.
extern "C" int nm_dw_star_dgrad_parts(int B, int H, int W, int C, int* parts) {
  if (bad_shape(B, H, W, C, kTaps)) return (int)cudaErrorInvalidValue;
  return (int)tile_grid<true>(B, H, W, C, parts);
}

// s: StarReLU's scale on the device; dx (B, H, W, C); part (parts, 2): the
// per-block [ds, db] partials, one block a row (parts in [1, tiles]; the
// caller's count from nm_dw_star_dgrad_parts).  x, g and w 16-byte aligned.
extern "C" int nm_dw_star_dgrad(const void* x, const void* g, const void* w,
                                const void* s, void* dx, void* part, int parts,
                                int B, int H, int W, int C, int K, void* stream) {
  if (bad_shape(B, H, W, C, K)) return (int)cudaErrorInvalidValue;
  return (int)launch_tiles<true>(g, x, w, nullptr, (const float*)s, nullptr,
                                 (float*)dx, (float*)part, B, H, W, C, parts,
                                 (cudaStream_t)stream);
}

// The wgrad's grid for this shape on the current device, into *parts: the
// partials rows (of K * K x 32 floats) to give nm_dw_star_wgrad.
extern "C" int nm_dw_star_wgrad_parts(int B, int H, int W, int C, int* parts) {
  if (bad_shape(B, H, W, C, kTaps)) return (int)cudaErrorInvalidValue;
  return (int)wgrad_grid(B, H, W, C, parts);
}

// s, b: StarReLU's scalars on the device; dw (K, K, C); part (parts, K * K,
// 32): the per-block tap sums, one block a row (parts a multiple of C / 32
// in [C / 32, tiles]; the caller's count from nm_dw_star_wgrad_parts).  x
// and g 16-byte aligned.
extern "C" int nm_dw_star_wgrad(const void* x, const void* g, const void* s,
                                const void* b, void* dw, void* part, int parts,
                                int B, int H, int W, int C, int K, void* stream) {
  if (bad_shape(B, H, W, C, K)) return (int)cudaErrorInvalidValue;
  return (int)launch_wgrad(x, g, (const float*)s, (const float*)b, (float*)dw,
                           (float*)part, B, H, W, C, parts, (cudaStream_t)stream);
}
