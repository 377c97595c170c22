// Fused mip-NeRF render stage for Hopper (sm_90a) with a bf16 trunk: the
// eval render's MLP on wgmma, f32 everywhere else.
//
// Replaces the TPU kernel nerfmatch_tpu/ops/pallas/render_kernel.py:
// make_fused_render (bodies blocked_body / kernel) for the stages whose
// trunk is bf16, driven twice per ray batch by make_fused_hierarchical: a
// coarse variant (weights, depth, acc) and a fine variant (+ rgb, the
// composited layer-`feat_layer` descriptor and the composited 3D point).
// The int8 trunk (kernel 1b) stays in render.cu on mma.sync.
//
// Per ray: conical-frustum moments from the z fenceposts -> integrated
// positional encoding -> L x HID MLP (skip concat after the skip layer) ->
// sigma [-> feature -> views -> sigmoid rgb] -> alpha compositing with a
// log-transmittance prefix sum carried across z-ordered blocks of 32
// samples.  Early termination: once every ray of a tile of kTileRays = 2
// rays has transmittance < eps (log T < log_eps), the tile's remaining
// sample blocks are skipped and their weights written as exact zeros (the
// JAX kernel's semantics; skipped weights are < eps).
//
// Precision, as in the JAX kernel: the trunk, feature and views products
// take bf16 operands (the encoding, the hidden activations, the weights)
// and accumulate in f32; biases, ReLU, the sigma head, the descriptor tap,
// the frustum / encoding phases, transmittance and every composited output
// stay f32.  The dirs rows of the views layer and the rgb head are f32 FMA
// on f32 weights (the train kernel rounds those weights to bf16; this one
// does not).
//
// What bounds it on the H100: the MLP's products, ~1.2 MFLOP a sample (the
// 9216-ray fine stage at 128 samples: 1.44 TFLOP, 1.46 ms at the bf16
// peak; fewer where early termination skips blocks).  Design, kernel 5's
// engine (render_train.cu: train_fwd_kernel): a persistent grid (at most
// one block an SM) of two warpgroups.  Each warpgroup owns a tile of 2
// rays, taken from a tile counter, and walks its 32-sample blocks in z
// order, one 64-row chunk (2 rays x 32 samples, one wgmma m64 tile) a step;
// when the tile is done or dead it writes the tile's outputs (and the zero
// weights) and takes the next.  The two warpgroups run each step's
// products in lock-step, both reading every slot of a ring of 32-row
// weight slices (one bulk copy each of the host-packed (in x out) slot
// images, render_train_kernel.py: forward_images; the same images kernel 5
// reads); a warpgroup without a tile runs the products on whatever it
// holds and writes nothing.  Each layer is wgmma m64nHIDk16 with A in registers
// (the layer before's accumulator after bias and ReLU, rounded to bf16)
// or, for layer 0 and the skip layer, the encoding tile in shared memory
// (K-major, 128-byte swizzle).  Compositing runs on the warpgroup's four
// warps (a half-warp scan of log(1 - alpha) per 16 rows, one shared-memory
// pass for the two halves of a ray's block).  The fine stage's descriptor:
// the tap layer's f32 activations (64 KB a warpgroup) do not fit beside
// the ring, so the warpgroup keeps the tap layer's bf16 A fragments (32 KB)
// in shared memory and, once the chunk's weights are known, runs the tap
// layer again on them (the same wgmma on the same operands: the same bits)
// and reduces sum w h_tap from the accumulator (a reduce-scatter over the
// warp's rows, one row of partials a warp in shared memory; the warps'
// rows are summed in a fixed order at the tile's end).  Each ray's outputs
// come from one warpgroup in z order, so the result does not depend on
// the schedule.
//
// What holds it (scripts/render_eval_probe.py, PERF.md): the products
// and the SIMT work of a step (encoding, epilogues, compositing, barriers)
// run one after the other; without products or weight copies a stage
// takes ~40% of its time, and the copies hide behind the products.  The
// epilogues, the tap layer's second pass, the ring's depth (5 to 9 slots)
// and half the block barriers move it by < 3% each.
// -Xptxas -v (sm_90a, CUDA 12.8): render_eval_kernel<256, *, false> 254
// registers, no spills; <256, fine, debug> 248; <64, *> 122-127, no
// spills.  Dynamic shared memory 166,856 bytes (coarse) and 216,000
// (fine: 6 ring slots 96 KB, encoding tiles 32 KB, tap fragments 64 KB)
// at HID 256; 73,160 and 89,544 at 64.  One block an SM.

#include <math.h>

#include "mma_common.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int kTileRays = 2;
constexpr int kSampleBlock = 32;
constexpr int kWgRows = kTileRays * kSampleBlock;  // a warpgroup's chunk
constexpr int kEvalThreads = 256;                  // two warpgroups
constexpr int kSliceK = 32;                        // weight rows a ring slot
constexpr int kEncSlices = kEncMax / kSliceK;      // encoding rows: 3 slices
static_assert(kWgRows == 64, "one chunk = one wgmma m64 tile");

struct EvalParams {
  // Every weight matrix's slot images, (in x out) rows, in the order the
  // ring streams them: per layer its encoding rows (if any) then its
  // hidden rows, then the feature and the views layers.
  const __nv_bfloat16* W;
  const void* Wenc[kMaxLayers];  // non-null where layer i takes the encoding
  const float* b[kMaxLayers];
  const float* wa;   // (hid,) sigma head
  const float* ba;   // (1,)
  const float* bf;   // feature bias
  const float* wvd;  // views layer, dirs rows, f32 (dirs_dim, hid / 2)
  const float* bv;
  const float* wr;   // rgb head, f32 (hid / 2, 3)
  const float* br;
  const float* rays;  // (N, 12) packed, unit-direction parameterization
  const float* z;     // (N, S + 1) fenceposts
};

template <int HID, bool FINE>
struct EvalSmem {
  static constexpr int HV = HID / 2;
  static constexpr int NV = HV < 64 ? 64 : HV;  // the views product's width
  // The fine stage's tap fragments leave room for 6 slots at HID 256.
  static constexpr int kRing = FINE && HID > 64 ? 6 : 7;
  // Ring slot: kSliceK weight rows x HID outputs, MN-major in 64-column
  // blocks; a views slice fills NV / HID of its slot.  The encoding tile:
  // per warpgroup two K-major blocks of 64 rows x 64 bf16 (the encoding
  // padded to 96), 128-byte swizzle.  The fine stage's tap fragments: per
  // warpgroup 128 threads x HID / 16 x 16 bytes.
  static constexpr int kSlot = (HID / 64) * kSliceK * 128;
  static constexpr int kVSlot = (NV / 64) * kSliceK * 128;
  static constexpr int kEncBlock = 64 * 128;
  static constexpr int kEncOff = kRing * kSlot;
  static constexpr int kAOff = kEncOff + 4 * kEncBlock;
  static constexpr int kFloatOff = kAOff + (FINE ? 2 * 128 * HID : 0);
  // f32 a warpgroup: row info (64 x 8: mean, variance, t_mean, mid-point),
  // sigma (64), weights (64), rgb (64 x 4), warp segments (4 x 8), ray state
  // (2 x 8: carry, depth, acc, sum w t_mean, rgb), xt (2 x HV), dirs PE
  // (2 x kDirsMax), descriptor partials (a row of HID a warp).
  static constexpr int kInfo = 0, kSig = kInfo + kWgRows * 8, kWts = kSig + kWgRows,
                       kRgb = kWts + kWgRows, kSeg = kRgb + kWgRows * 4,
                       kRay = kSeg + 4 * 8, kXt = kRay + kTileRays * 8,
                       kDpe = kXt + kTileRays * HV, kFacc = kDpe + kTileRays * kDirsMax,
                       kWgFloats = kFacc + 4 * HID;
  static constexpr int kCtlOff = kFloatOff + 2 * kWgFloats * 4;  // 2 x (tile, block)
  static constexpr int kBarOff = kCtlOff + 16;
  static constexpr size_t kBytes = 1024 + kBarOff + 8 * kRing;
};

// The 128 threads of warpgroup wg (named barrier 1 + wg).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// kDbg: dbg receives the tap layer's activations, (2, N, S, HID) f32: the
// first pass's, then the recomputed ones.
template <int HID, bool FINE, bool kDbg>
__global__ void __launch_bounds__(kEvalThreads, 1)
render_eval_kernel(EvalParams p, int layer_num, int feat_layer, int F, int Fd,
                   int S, int n_tiles, float var_scale, float log_eps,
                   int white_bg, int* __restrict__ tile_counter,
                   float* __restrict__ out_w, float* __restrict__ out_depth,
                   float* __restrict__ out_acc, float* __restrict__ out_rgb,
                   float* __restrict__ out_feat, float* __restrict__ out_pts,
                   float* __restrict__ dbg) {
  using L = EvalSmem<HID, FINE>;
  constexpr int HV = L::HV, NV = L::NV, R = L::kRing;
  constexpr int NJ = HID / 8, NJV = HV / 8;   // n8 column groups
  constexpr int KS = HID / kSliceK;           // slices of a HID-row product
  static_assert(HID % 64 == 0 && KS >= 2, "HID must be a multiple of 64");
  static_assert(L::kBytes <= 232448, "render_eval shared memory");
  static_assert(!kDbg || FINE, "the tap exists in the fine stage only");

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = tid >> 7, lt = tid & 127, wl = warp & 3, t = lane & 3;
  const int wrow = wl * 16 + (lane >> 2);   // first of this thread's two rows
  const uint32_t ring_s = base, full0 = base + L::kBarOff;
  const uint32_t enc_w = base + L::kEncOff + wg * 2 * L::kEncBlock;
  unsigned char* enc_p = sm + L::kEncOff + wg * 2 * L::kEncBlock;
  uint4* astash = reinterpret_cast<uint4*>(sm + L::kAOff) + wg * 128 * (HID / 16);
  float* fw = reinterpret_cast<float*>(sm + L::kFloatOff) + wg * L::kWgFloats;
  float* info = fw + L::kInfo;
  float* sig = fw + L::kSig;
  float* wts = fw + L::kWts;
  float* rgbs = fw + L::kRgb;
  float* seg = fw + L::kSeg;
  float* ray_s = fw + L::kRay;
  float* xt = fw + L::kXt;
  float* dpe = fw + L::kDpe;
  float* facc = fw + L::kFacc;
  int* ctl = reinterpret_cast<int*>(sm + L::kCtlOff);   // [2 wg]: tile, block

  const int enc_dim = 6 * F, dirs_dim = 6 * Fd + 3;
  const int n_blocks = S / kSampleBlock;
  const size_t n_rows = (size_t)n_tiles * kTileRays * S;
  // The epilogues' weights at this thread's columns 8 j + 2 t: constant
  // offsets from one base each.
  const float* wa_t = p.wa + 2 * t;
  const float* bf_t = p.bf + 2 * t;
  const float* bv_t = p.bv + 2 * t;
  const float* wr_t = p.wr + 6 * t;

  // Slices a step streams, in the images' order: the trunk (per layer its
  // encoding rows, then its hidden rows), then for the fine stage the
  // feature, the views layer and the tap layer again (from the trunk's
  // images).  All but the views slices fill a whole slot.
  int Qt = 0, tap_q0 = 0;
  for (int i = 0; i < layer_num; ++i) {
    if (i == feat_layer) tap_q0 = Qt;
    Qt += (p.Wenc[i] != nullptr ? kEncSlices : 0) + (i > 0 ? KS : 0);
  }
  const bool tap_enc = FINE && p.Wenc[feat_layer] != nullptr;
  const int Q = FINE ? Qt + 2 * KS + (tap_enc ? kEncSlices : 0) + (feat_layer > 0 ? KS : 0)
                     : Qt;

  // The encoding tiles' padding columns (enc_dim .. 95) stay zero.
  for (int i = tid; i < 2 * kWgRows * (kEncMax - enc_dim); i += kEvalThreads) {
    const int row = i / (kEncMax - enc_dim), k = enc_dim + i % (kEncMax - enc_dim);
    *reinterpret_cast<__nv_bfloat16*>(
        sm + L::kEncOff + (row >> 6) * 2 * L::kEncBlock + (k >> 6) * L::kEncBlock +
        swz(row & 63, (k & 63) >> 3) + (k & 7) * 2) = __float2bfloat16(0.f);
  }
  if (tid == 0)
    for (int i = 0; i < R; ++i) mbar_init(full0 + 8 * i);
  if (lt == 0) {
    ctl[2 * wg] = -1;   // no tile yet
    ctl[2 * wg + 1] = 0;
  }
  fence_async();
  __syncthreads();

  auto load_slice = [&](int q) {
    const int qc = q % Q;
    uint32_t bytes = L::kSlot;
    size_t off;
    if (!FINE || qc < Qt + KS) {
      off = (size_t)qc * L::kSlot;
    } else if (qc < Qt + 2 * KS) {
      bytes = L::kVSlot;
      off = (size_t)(Qt + KS) * L::kSlot + (size_t)(qc - Qt - KS) * L::kVSlot;
    } else {
      off = (size_t)(tap_q0 + qc - Qt - 2 * KS) * L::kSlot;
    }
    const int slot = q % R;
    mbar_expect(full0 + 8 * slot, bytes);
    bulk_copy(ring_s + slot * L::kSlot, reinterpret_cast<const unsigned char*>(p.W) + off,
              bytes, full0 + 8 * slot);
  };
  int q = 0;   // next ring slice to consume
  if (tid == 0)
    for (int s = 0; s < R - 2; ++s) load_slice(s);

  float acc[NJ * 4];
  uint32_t a[HID / 16][4];   // bf16 A fragments: 16 columns (k) a step
  // acc = the next NE encoding slices (A: the encoding tile) + the next NH
  // hidden slices (A: the registers a), N columns.  One wgmma batch stays
  // in flight, so slot q - 2 is the one refilled (with slice q + R - 2).
  // A warpgroup without a chunk multiplies too, on whatever its registers
  // and encoding tile hold (its epilogues write nothing): testing `live`
  // around the wgmma made the stage 1.35-1.5x slower and spilled
  // (scripts/render_eval_probe.py, live_gate).
  auto product = [&](auto ne_c, auto nh_c, auto n_c) {
    constexpr int NE = decltype(ne_c)::value, NH = decltype(nh_c)::value;
    constexpr int N = decltype(n_c)::value;
    constexpr int KK = kSliceK / 16;   // k16 steps a slice
    auto begin = [&]() {
      __syncthreads();   // batch q - 2 done everywhere: its slot is free
      if (tid == 0) load_slice(q + R - 2);
      mbar_wait(full0 + 8 * (q % R), (q / R) & 1);
      wgmma_fence();
      return ring_s + (uint32_t)(q % R) * L::kSlot;
    };
    auto end = [&]() {
      wgmma_commit();
      wgmma_wait<1>();
      ++q;
    };
#pragma unroll
    for (int s = 0; s < NE; ++s) {
      const uint32_t slot = begin();
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const int ks = s * KK + kk;   // k16 step of the encoding tile
        wgmma_ss<N, 0>(acc, desc128(enc_w + (ks >> 2) * L::kEncBlock + (ks & 3) * 32, 16),
                       desc128(slot + kk * 2048, kSliceK * 128), ks > 0);
      }
      end();
    }
#pragma unroll
    for (int s = 0; s < NH; ++s) {
      const uint32_t slot = begin();
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
        wgmma_rs<N, 1>(acc, a[s * KK + kk], desc128(slot + kk * 2048, kSliceK * 128),
                       NE + s + kk > 0);
      end();
    }
    wgmma_wait<0>();
  };
  // Layer i's product, by which rows it takes.
  auto layer_product = [&](int i) {
    if (i == 0)
      product(Int<kEncSlices>{}, Int<0>{}, Int<HID>{});
    else if (p.Wenc[i] != nullptr)
      product(Int<kEncSlices>{}, Int<KS>{}, Int<HID>{});
    else
      product(Int<0>{}, Int<KS>{}, Int<HID>{});
  };
  auto put_dbg = [&](int which, int tile, int sb, int row, int col, float v0, float v1) {
    const size_t gr = (size_t)(tile * kTileRays + row / kSampleBlock) * S +
                      sb * kSampleBlock + row % kSampleBlock;
    *reinterpret_cast<float2*>(dbg + (which * n_rows + gr) * HID + col) = make_float2(v0, v1);
  };

  for (;;) {
    // ---- this warpgroup's chunk: finish a tile that is done or dead
    //      (its outputs, zero weights for its skipped blocks), take the next
    //      ----
    wg_sync(wg);   // the last step's ray state, partials and block index
    int tile = ctl[2 * wg];
    int sb = tile >= 0 ? ctl[2 * wg + 1] : 0;
    if (tile >= 0 && (sb == n_blocks ||
                      (sb > 0 && ray_s[0] < log_eps && ray_s[8] < log_eps))) {
      const int ray0 = tile * kTileRays, nb = S - sb * kSampleBlock;
      for (int i = lt; i < kTileRays * nb; i += 128)
        out_w[(size_t)(ray0 + i / nb) * S + sb * kSampleBlock + i % nb] = 0.f;
      if (lt < kTileRays) {
        const int n = ray0 + lt;
        const float* rs = ray_s + lt * 8;
        out_depth[n] = rs[1];
        out_acc[n] = rs[2];
        if (FINE) {
          const float* ray = p.rays + (size_t)n * 12;
          const float bg = white_bg ? 1.f - rs[2] : 0.f;
          for (int c = 0; c < 3; ++c) {
            out_rgb[n * 3 + c] = rs[4 + c] + bg;
            out_pts[n * 3 + c] = ray[c] * rs[2] + ray[8 + c] * rs[3];
          }
        }
      }
      if (FINE)
        for (int i = lt; i < kTileRays * HID; i += 128) {
          const int r = i / HID, c = i % HID;
          out_feat[(size_t)ray0 * HID + i] = facc[2 * r * HID + c] + facc[(2 * r + 1) * HID + c];
        }
      tile = -1;
    }
    if (tile == -1) {
      wg_sync(wg);   // the tile's state is read
      if (lt == 0) {
        const int next = atomicAdd(tile_counter, 1);
        ctl[2 * wg] = next < n_tiles ? next : -2;
        ctl[2 * wg + 1] = 0;
      }
      wg_sync(wg);
      tile = ctl[2 * wg];
      sb = 0;
      if (tile >= 0) {
        const int ray0 = tile * kTileRays;
        if (lt < kTileRays * 8) ray_s[lt] = 0.f;
        if (FINE) {
          for (int i = lt; i < 4 * HID; i += 128) facc[i] = 0.f;
          // View-direction PE per ray: [sin(2^f d) | sin(2^f d + pi/2) | d].
          for (int i = lt; i < kTileRays * dirs_dim; i += 128) {
            const int r = i / dirs_dim, j = i % dirs_dim;
            const float* ray = p.rays + (size_t)(ray0 + r) * 12;
            float v;
            if (j < 6 * Fd) {
              const int jj = j % (3 * Fd);
              const float x = ray[8 + jj % 3] * exp2f((float)(jj / 3));
              v = j < 3 * Fd ? sinf(x) : sinf(x + kHalfPi);
            } else {
              v = ray[8 + j - 6 * Fd];
            }
            dpe[r * kDirsMax + j] = v;
          }
          wg_sync(wg);
          // Per-ray view contribution of the views layer: dirs_pe @ wvd (f32).
          for (int i = lt; i < kTileRays * HV; i += 128) {
            const int r = i / HV, k = i % HV;
            float s = 0.f;
            for (int j = 0; j < dirs_dim; ++j)
              s = fmaf(dpe[r * kDirsMax + j], __ldg(p.wvd + (size_t)j * HV + k), s);
            xt[i] = s;
          }
        }
      }
    }
    __syncthreads();   // both warpgroups have chosen
    if (ctl[0] < 0 && ctl[2] < 0) break;
    const bool live = tile >= 0;   // this warpgroup has a chunk
    const int ray0 = tile * kTileRays;

    if (live) {
      // ---- per-row frustum moments -> Gaussian mean / variance ----
      if (lt < kWgRows) {
        const int n = ray0 + lt / kSampleBlock, s = sb * kSampleBlock + lt % kSampleBlock;
        const float* ray = p.rays + (size_t)n * 12;
        const float* zr = p.z + (size_t)n * (S + 1);
        const float t0 = zr[s], t1 = zr[s + 1];
        const float mu = (t0 + t1) / 2.f, hw = (t1 - t0) / 2.f;
        const float mu2 = mu * mu, hw2 = hw * hw;
        const float den = fmaxf(kF32Eps, 3.f * mu2 + hw2);
        const float t_mean = mu + (2.f * mu * hw2) / den;
        float t_var = hw2 / 3.f - (4.f / 15.f) * ((hw2 * hw2 * (12.f * mu2 - hw2)) / (den * den));
        const float rad = ray[11];
        float r_var = rad * rad * (mu2 / 4.f + (5.f / 12.f) * hw2 - (4.f / 15.f) * (hw2 * hw2) / den);
        t_var *= var_scale;
        r_var *= var_scale;
        const float dx = ray[8], dy = ray[9], dz = ray[10];
        const float dmag = fmaxf(1e-10f, dx * dx + dy * dy + dz * dz);
        float* in = info + lt * 8;
        const float d[3] = {dx, dy, dz};
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float d2 = d[c] * d[c];
          in[c] = __fadd_rn(__fmul_rn(d[c], t_mean), ray[c]);
          in[3 + c] = t_var * d2 + r_var * (1.f - d2 / dmag);
        }
        in[6] = t_mean;
        in[7] = mu;
      }
      wg_sync(wg);
      // ---- integrated positional encoding (f32, rounded to bf16) into this
      //      warpgroup's encoding tile: [sin block | cos block] ----
      for (int i = lt; i < kWgRows * 3 * F; i += 128) {
        const int row = i / (3 * F), j = i % (3 * F);
        const int f = j / 3, c = j % 3;
        const float* in = info + row * 8;
        const float x = in[c] * exp2f((float)f);
        const float y = in[3 + c] * exp2f((float)(2 * f));
        const float damp = expf(-0.5f * y);
        const __nv_bfloat16 v[2] = {__float2bfloat16(damp * sinf(x)),
                                    __float2bfloat16(damp * sinf(x + kHalfPi))};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = h * 3 * F + j;
          *reinterpret_cast<__nv_bfloat16*>(enc_p + (k >> 6) * L::kEncBlock +
                                            swz(row, (k & 63) >> 3) + (k & 7) * 2) = v[h];
        }
      }
      fence_async();   // the encoding tile, for wgmma
    }

    // ---- trunk: acc = [enc @ Wenc_i] + [bf16(h) @ Wh_i]; h = relu(acc + b) ----
    float sp[2] = {0.f, 0.f};   // sigma head partials of its two rows
    for (int i = 0; i < layer_num; ++i) {
      if (FINE && live && i == feat_layer && i > 0) {
        // The tap layer's hidden A, for its second pass.
#pragma unroll
        for (int s = 0; s < HID / 16; ++s)
          astash[s * 128 + lt] = make_uint4(a[s][0], a[s][1], a[s][2], a[s][3]);
      }
      layer_product(i);
      if (live) {
        const bool last = i == layer_num - 1;
        const float* b_t = p.b[i] + 2 * t;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float b0 = __ldg(b_t + 8 * j), b1 = __ldg(b_t + 8 * j + 1);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v0 = fmaxf(acc[4 * j + 2 * h] + b0, 0.f);
            const float v1 = fmaxf(acc[4 * j + 2 * h + 1] + b1, 0.f);
            a[j >> 1][2 * (j & 1) + h] = pack_bf16(v0, v1);
            if (last)
              sp[h] = fmaf(v0, __ldg(wa_t + 8 * j), fmaf(v1, __ldg(wa_t + 8 * j + 1), sp[h]));
            if (kDbg && i == feat_layer)
              put_dbg(0, tile, sb, wrow + 8 * h, 8 * j + 2 * t, v0, v1);
          }
        }
      }
    }
    // ---- sigma = h . wa + ba (f32 activations) ----
    if (live) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s = sp[h];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (t == 0) sig[wrow + 8 * h] = s + __ldg(p.ba);
      }
    }

    if (FINE) {
      // ---- feature = bf16(h) @ wf + bf (no activation), rounded to bf16 ----
      product(Int<0>{}, Int<KS>{}, Int<HID>{});
      if (live) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float b0 = __ldg(bf_t + 8 * j), b1 = __ldg(bf_t + 8 * j + 1);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            a[j >> 1][2 * (j & 1) + h] =
                pack_bf16(acc[4 * j + 2 * h] + b0, acc[4 * j + 2 * h + 1] + b1);
        }
      }
      // ---- views = relu(feature @ wvh + dirs_pe @ wvd + bv), rounded to
      //      bf16; rgb = sigmoid(views @ wr + br), f32 FMA ----
      product(Int<0>{}, Int<KS>{}, Int<NV>{});
      if (live) {
        const float* x = xt + (wl >> 1) * HV;   // the ray of the warp's rows
        float pr[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
        for (int j = 0; j < NJV; ++j) {
          const int col = 8 * j + 2 * t;
          const float c0 = x[col], c1 = x[col + 1];
          const float b0 = __ldg(bv_t + 8 * j), b1 = __ldg(bv_t + 8 * j + 1);
          float wr[2][3];
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int c = 0; c < 3; ++c) wr[e][c] = __ldg(wr_t + 24 * j + 3 * e + c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v0 = fmaxf(acc[4 * j + 2 * h] + c0 + b0, 0.f);
            const float v1 = fmaxf(acc[4 * j + 2 * h + 1] + c1 + b1, 0.f);
            const uint32_t pk = pack_bf16(v0, v1);
            const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pk));
#pragma unroll
            for (int c = 0; c < 3; ++c) pr[h][c] = fmaf(r.x, wr[0][c], fmaf(r.y, wr[1][c], pr[h][c]));
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            float s = pr[h][c];
            s += __shfl_xor_sync(0xffffffffu, s, 1);
            s += __shfl_xor_sync(0xffffffffu, s, 2);
            if (t == 0) rgbs[(wrow + 8 * h) * 4 + c] = 1.f / (1.f + expf(-(s + __ldg(p.br + c))));
          }
      }
    }

    // ---- compositing: warp w of the warpgroup takes rows 16 w .. (ray
    //      w / 2), one row a lane of each half (the halves compute the
    //      same) ----
    if (live) {
      wg_sync(wg);   // sigma and rgb of every row
      const int row = wl * 16 + (lane & 15), r = wl >> 1;
      const int n = ray0 + r, s = sb * kSampleBlock + (row & (kSampleBlock - 1));
      const float* zr = p.z + (size_t)n * (S + 1);
      const float dist = zr[s + 1] - zr[s];
      const float alpha = 1.f - expf(-fmaxf(sig[row], 0.f) * dist);
      const float lt_ = logf(1.f - alpha + 1e-10f);
      float incl = lt_;
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o, 16);
        if ((lane & 15) >= o) incl += v;
      }
      if (lane == 15) seg[wl * 8] = incl;
      wg_sync(wg);
      const float before = ray_s[r * 8] + ((wl & 1) ? seg[(wl - 1) * 8] : 0.f);
      const float w = alpha * expf(before + (incl - lt_));
      if (lane < 16) {
        out_w[(size_t)n * S + s] = w;
        wts[row] = w;
      }
      const float* in = info + row * 8;
      float sums[6] = {w * in[7], w, w * in[6], 0.f, 0.f, 0.f};
      if (FINE)
        for (int c = 0; c < 3; ++c) sums[3 + c] = w * rgbs[row * 4 + c];
#pragma unroll
      for (int c = 0; c < 6; ++c)
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) sums[c] += __shfl_xor_sync(0xffffffffu, sums[c], o);
      if (lane == 0)
        for (int c = 0; c < 6; ++c) seg[wl * 8 + 1 + c] = sums[c];
      wg_sync(wg);
      if (lt < kTileRays) {   // per ray, its two warps in order
        float* rs = ray_s + lt * 8;
        for (int w2 = 2 * lt; w2 < 2 * lt + 2; ++w2) {
          rs[0] += seg[w2 * 8];
          for (int c = 0; c < 6; ++c) rs[1 + c] += seg[w2 * 8 + 1 + c];
        }
      }
      if (lt == 0) ctl[2 * wg + 1] = sb + 1;
    }

    if (FINE) {
      // ---- descriptor: the tap layer again on its kept A, then
      //      sum w relu(acc + b) over the warp's rows into its partials ----
      if (live && feat_layer > 0) {
#pragma unroll
        for (int s = 0; s < HID / 16; ++s) {
          const uint4 v = astash[s * 128 + lt];
          a[s][0] = v.x;
          a[s][1] = v.y;
          a[s][2] = v.z;
          a[s][3] = v.w;
        }
      }
      layer_product(feat_layer);
      if (live) {
        const float* b_t = p.b[feat_layer] + 2 * t;
        const float w0 = wts[wrow], w1 = wts[wrow + 8];
        float part[2 * NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float b0 = __ldg(b_t + 8 * j), b1 = __ldg(b_t + 8 * j + 1);
          const float v00 = fmaxf(acc[4 * j] + b0, 0.f), v01 = fmaxf(acc[4 * j + 1] + b1, 0.f);
          const float v10 = fmaxf(acc[4 * j + 2] + b0, 0.f), v11 = fmaxf(acc[4 * j + 3] + b1, 0.f);
          part[2 * j] = fmaf(w1, v10, w0 * v00);
          part[2 * j + 1] = fmaf(w1, v11, w0 * v01);
          if (kDbg) {
            put_dbg(1, tile, sb, wrow, 8 * j + 2 * t, v00, v01);
            put_dbg(1, tile, sb, wrow + 8, 8 * j + 2 * t, v10, v11);
          }
        }
        fold_half<16, 2 * NJ>(part, lane);
        fold_half<8, NJ>(part, lane);
        fold_half<4, NJ / 2>(part, lane);
        float* fa = facc + wl * HID;
        const int g = lane >> 2;
#pragma unroll
        for (int i = 0; i < NJ / 4; ++i) {
          const int k = (NJ / 4) * g + i;
          fa[8 * (k >> 1) + 2 * t + (k & 1)] += part[i];
        }
      }
    }
  }

  // Slices loaded ahead for steps that never came: land them before the
  // block's shared memory goes.
  if (tid == 0)
    for (int s = q; s < q + R - 2; ++s) mbar_wait(full0 + 8 * (s % R), (s / R) & 1);
}

template <int HID, bool FINE, bool kDbg>
cudaError_t launch(const EvalParams& p, int n_rays, int layer_num,
                   int feat_layer, int F, int Fd, int S, float var_scale,
                   float log_eps, int white_bg, int* counter, float* w,
                   float* depth, float* acc, float* rgb, float* feat,
                   float* pts, float* dbg, cudaStream_t stream) {
  const size_t bytes = EvalSmem<HID, FINE>::kBytes;
  auto kern = render_eval_kernel<HID, FINE, kDbg>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return e;
  // Persistent: at most one block an SM, two tiles a block to begin with.
  const int n_tiles = n_rays / kTileRays;
  const int grid = (n_tiles + 1) / 2 < sms ? (n_tiles + 1) / 2 : sms;
  kern<<<grid, kEvalThreads, bytes, stream>>>(p, layer_num, feat_layer, F, Fd, S,
                                               n_tiles, var_scale, log_eps,
                                               white_bg, counter, w, depth, acc,
                                               rgb, feat, pts, dbg);
  return cudaGetLastError();
}

template <int HID>
cudaError_t launch_hid(bool fine, bool dbg, const EvalParams& p, int n_rays,
                       int layer_num, int feat_layer, int F, int Fd, int S,
                       float var_scale, float log_eps, int white_bg,
                       int* counter, float* w, float* depth, float* acc,
                       float* rgb, float* feat, float* pts, float* dbg_out,
                       cudaStream_t s) {
  auto fn = !fine ? launch<HID, false, false>
                  : dbg ? launch<HID, true, true> : launch<HID, true, false>;
  return fn(p, n_rays, layer_num, feat_layer, F, Fd, S, var_scale, log_eps,
            white_bg, counter, w, depth, acc, rgb, feat, pts, dbg_out, s);
}

}  // namespace

// ptrs: host array of 2 * layer_num + 10 device pointers: W (every weight
// matrix's slot images, render_train_kernel.py: forward_images), then
// (Wenc_i, b_i) for each layer i (Wenc_i: non-null where the layer takes
// the encoding rows), then wa, ba, bf, wvd, bv, wr, br, rays, z.  counter:
// one int32, zero at launch (the tile counter).  dbg: null, or (2, n_rays,
// samples, hid) f32 receiving the tap layer's activations of the first
// pass and of the second (fine stage only).
extern "C" int nm_render_eval_forward(const void* const* ptrs, int n_rays,
                                      int hid, int layer_num, int feat_layer,
                                      int num_freqs, int dirs_freqs,
                                      int samples, float var_scale,
                                      float log_eps, int white_bg, int fine,
                                      void* counter, void* out_w,
                                      void* out_depth, void* out_acc,
                                      void* out_rgb, void* out_feat,
                                      void* out_pts, void* dbg, void* stream) {
  if (layer_num < 1 || layer_num > kMaxLayers || 6 * num_freqs > kEncMax ||
      6 * dirs_freqs + 3 > kDirsMax || n_rays % kTileRays != 0 || n_rays <= 0 ||
      samples % kSampleBlock != 0 || samples <= 0 ||
      (fine && (feat_layer < 0 || feat_layer >= layer_num)) ||
      (dbg != nullptr && !fine) || (hid != 64 && hid != 256))
    return (int)cudaErrorInvalidValue;
  EvalParams p;
  int k = 0;
  p.W = (const __nv_bfloat16*)ptrs[k++];
  for (int i = 0; i < kMaxLayers; ++i) {
    const bool here = i < layer_num;
    p.Wenc[i] = here ? ptrs[k++] : nullptr;
    p.b[i] = here ? (const float*)ptrs[k++] : nullptr;
  }
  if (p.Wenc[0] == nullptr) return (int)cudaErrorInvalidValue;
  p.wa = (const float*)ptrs[k++];
  p.ba = (const float*)ptrs[k++];
  p.bf = (const float*)ptrs[k++];
  p.wvd = (const float*)ptrs[k++];
  p.bv = (const float*)ptrs[k++];
  p.wr = (const float*)ptrs[k++];
  p.br = (const float*)ptrs[k++];
  p.rays = (const float*)ptrs[k++];
  p.z = (const float*)ptrs[k++];
  const int tap = fine ? feat_layer : 0;
  auto fn = hid == 64 ? launch_hid<64> : launch_hid<256>;
  return (int)fn(fine, dbg != nullptr, p, n_rays, layer_num, tap, num_freqs,
                 dirs_freqs, samples, var_scale, log_eps, white_bg,
                 (int*)counter, (float*)out_w, (float*)out_depth,
                 (float*)out_acc, (float*)out_rgb, (float*)out_feat,
                 (float*)out_pts, (float*)dbg, (cudaStream_t)stream);
}

// Dynamic shared memory of the kernel at hid (64 or 256), the coarse or the
// fine stage, in bytes.
extern "C" int nm_render_eval_smem(int hid, int fine) {
  if (hid == 64) return (int)(fine ? EvalSmem<64, true>::kBytes : EvalSmem<64, false>::kBytes);
  if (hid == 256)
    return (int)(fine ? EvalSmem<256, true>::kBytes : EvalSmem<256, false>::kBytes);
  return -1;
}
