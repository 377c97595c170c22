// Fused mip-NeRF render stage for Hopper (sm_90a): the eval render's MLP on
// wgmma, f32 everywhere else; one engine for both trunks, a bf16 trunk
// (kernel 1) and the int8 serving trunk (kernel 1b).
//
// This header holds the kernel; render_eval.cu the C entries, each
// render_eval_<trunk>_<HID>.cu the instantiations of one trunk at one MLP
// width, HID in {64, 128, 192, 256}, and each render_eval_wide_<HID>.cu
// those of the wide encoding at one width, so that each compiles in an
// nvcc process of its own.  An MLP of another width up to 256 runs at the
// smallest of these that holds it, zero-padded on the host
// (render_train_kernel.py: pad_mlp_to_kernel_width); widths 257-1024 run on
// the tile engine of render_eval_512.cuh (its _512.cu and _1024.cu files).  The encoding takes
// 2 * 3 * F <= 128 columns (F <= 21): ENC = 3 slices of 32 rows up to 96
// columns (the production encoding's code, F = 15), ENC = 4 beyond (the
// wide instantiation; no debug outputs).  The view-direction PE plus the
// appearance row takes 2 * 3 * Fd + 3 (+ 16) <= 128 columns: the
// shared-memory rows of the dirs PE are sized from the config at launch.
//
// Replaces the TPU kernel nerfmatch_tpu/ops/pallas/render_kernel.py:
// make_fused_render (bodies blocked_body / kernel, with its trunk_int8
// branch and the weights of nerfmatch_tpu/ops/pallas/quant.py, packed by
// ops/kernels/quant.py), driven twice per ray batch by
// make_fused_hierarchical: a coarse variant (weights, depth, acc) and a
// fine variant (+ rgb, the composited layer-`feat_layer` descriptor and the
// composited 3D point: the weighted sums, or with feat_max (feat_comb='max',
// the JAX kernel's feat_max branch) the descriptor and the point of the
// sample with the largest weight, the first in z order among equals).  An
// appearance NeRF's fine stage also takes each ray's appearance row (app,
// 16 f32 a ray): the views layer adds app @ Wva
// to the per-ray dirs_pe @ Wvd, both f32 FMA on unrounded weights, in the
// tile's prologue (the JAX kernel's SelApp extras of from_rays mode).
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
// does not).  The int8 trunk (Q8): layers from int8_from on multiply s8 x
// s8 -> s32 (wgmma m64nHIDk32) on the quantized encoding xq and int8
// activations; their f32 epilogue keeps the JAX order and rounding (acc *
// c, then + acc_s * c_s, then + B, no FMA contraction; round half even for
// the encoding and the 'posttap' boundary, truncation after max(y, 0.5) for
// hidden layers; the last layer in real units), so the integer activations
// equal the plain version's.  Layers below int8_from and the heads stay
// bf16.
//
// What bounds it on the H100: the MLP's products, ~1.2 MFLOP a sample (the
// 9216-ray fine stage at 128 samples: 1.44 TFLOP, 1.46 ms at the bf16
// peak; the int8 coarse stage 1.19 TOP, 0.60 ms at the int8 peak; fewer
// where early termination skips blocks).  Design, kernel 5's engine
// (render_train.cu: train_fwd_kernel): a persistent grid (at most one block
// an SM) of two warpgroups.  Each warpgroup owns a tile of 2 rays, taken
// from a tile counter, and walks its 32-sample blocks in z order, one
// 64-row chunk (2 rays x 32 samples, one wgmma m64 tile) a step; when the
// tile is done or dead it writes the tile's outputs (and the zero weights)
// and takes the next.  The two warpgroups run each step's products in
// lock-step, both reading every slot of a ring of weight slices (one bulk
// copy each of host-packed slot images in the order the ring streams them:
// bf16 (in x out) slices of 32 rows, render_train_kernel.py:
// forward_images, the images kernel 5 reads; s8 slices of 64 K-major rows,
// the same 16 KB at HID 256, quant.py: slot_images_s8); a warpgroup without
// a tile runs the products on whatever it holds and writes nothing.  Each
// layer is one wgmma m64nHID chain with A in registers (the layer before's
// accumulator after its epilogue, as bf16 or as s8) or, for layer 0 and the
// skip layer, the encoding tile in shared memory (K-major, 128-byte
// swizzle; xq for s8 layers).  An s8 layer's A comes straight from the
// accumulator registers: a thread's accumulator columns of a 32-column
// block are a fixed permutation (quant.py: PERM32) of the K columns its s8
// A fragment takes, so the host permutes the K rows of every s8 image fed
// from an accumulator and the epilogue packs its own bytes.  The post-skip
// s8 layer's encoding rows have their own scale row: its hidden product
// fills the accumulator, which is scaled in place, then the encoding
// product runs 64 columns at a time (both encoding slices held in the
// ring) into a second, small accumulator.  Compositing runs on the
// warpgroup's four warps (a half-warp scan of log(1 - alpha) per 16 rows,
// one shared-memory pass for the two halves of a ray's block).  The fine
// stage's descriptor: the tap layer's f32 activations (64 KB a warpgroup)
// do not fit beside the ring, so the warpgroup keeps the tap layer's A
// fragments (32 KB bf16, 16 KB s8) in shared memory and, once the chunk's
// weights are known, runs the tap layer again on them (the same wgmma on
// the same operands: the same bits) and reduces sum w h_tap from the
// accumulator (a reduce-scatter over the warp's rows, one row of partials a
// warp in shared memory; the warps' rows are summed in a fixed order at the
// tile's end).  feat_max, a runtime flag of the fine stage: each ray carries
// its largest weight so far and that sample's t_mean across its blocks (the
// JAX kernel's carry: the first block always replaces it, a later block
// only with a strictly larger weight); one thread a ray finds the block's
// first largest weight in z order after the compositing scan, and the
// descriptor pass runs the same reduction with a one-hot weight on that
// sample, writing the warp's partials row instead of adding to it (the
// ray's other warp writes zeros), so the tile's end sums x + 0.  Each ray's
// outputs come from one warpgroup in z order, so the result does not depend
// on the schedule.
//
// What holds it (scripts/render_eval_probe.py, PERF.md): the products
// and the SIMT work of a step (encoding, epilogues, compositing, barriers)
// run one after the other; without products or weight copies a bf16 stage
// takes ~40% of its time, and the copies hide behind the products.  The
// epilogues, the tap layer's second pass, the ring's depth (5 to 9 slots)
// and half the block barriers move it by < 3% each.  The int8 trunk halves
// the products' time but its epilogue (I2F, an unfused multiply and add,
// the cast and pack, two rows of loads a column) is heavier, and at HID
// 256 its builds spill: the epilogues' row loads are issued 8 column
// groups at a time (fence8), and the int8 fine stage keeps 4 ring slots
// so that its spills stay in a 60 KB L1 cache.
// -Xptxas -v (sm_90a, CUDA 12.8): render_eval_kernel<256, *, *, false, *>
// 254-255 registers, no spills; <192> 240-255, <128> 199-240, <64>
// 122-128, no spills; <256, *, *, true, *> 255 registers, 376-676 bytes of
// spill stores; <192, *, *, true> 255 with 8-40; <128> 244-254, <64>
// 156-166, no spills.  The ENC template parameter (the encoding's slices)
// must stay one: counting them at run time, as a loop or a switch of
// compile-time counts, made the HID-256 bf16 fine stage spill and run 48%
// slower (PERF.md).  Dynamic shared memory at HID 256 and Fd = 4:
// 166,784 bytes (bf16 coarse), 215,920 (bf16 fine: 6 ring slots 96 KB,
// encoding tiles 32 KB, tap fragments 64 KB), 183,168 (int8 coarse),
// 199,520 (int8 fine, 4 slots); at 64: 73,088, 89,472, 89,472 and 105,856.
// One block an SM.

#include <math.h>

#include "mma_common.cuh"
#include "wgmma_common.cuh"

// The types the C entries (render_eval.cu) share with the instantiations.
namespace nm_eval {

struct EvalParams {
  // Every weight matrix's slot images, (in x out) rows, in the order the
  // ring streams them: per layer its encoding rows (if any) then its
  // hidden rows, then the feature and the views layers.
  const unsigned char* W;
  const void* Wenc[kMaxLayers];  // non-null where layer i takes the encoding
  const float* b[kMaxLayers];
  const float* wa;   // (hid,) sigma head
  const float* ba;   // (1,)
  const float* bf;   // feature bias
  const float* wvd;  // views layer, dirs rows, f32 (dirs_dim, hid / 2)
  const float* wva;  // views layer, appearance rows, f32 (kAppDim, hid / 2),
                     // or null (no appearance table)
  const float* app;  // (N, kAppDim) appearance rows of the rays, or null
  const float* bv;
  const float* wr;   // rgb head, f32 (hid / 2, 3)
  const float* br;
  const float* rays;  // (N, 12) packed, unit-direction parameterization
  const float* z;     // (N, S + 1) fenceposts
};

// The int8 trunk (quant.py: pack_mlp_int8) of layers int8_from .. L - 1: the
// rows of its f32 epilogue (its weights stream in EvalParams::W).
struct QuantParams {
  const float* scale[kMaxLayers];    // c_i (q-domain), s_L (last layer)
  const float* scale_s[kMaxLayers];  // the same for the post-skip layer's
                                     // encoding rows, or null
  const float* bias[kMaxLayers];     // B_i = b_i q_i + 0.5, b_L
  const float* qenc;  // (enc_rows(F),) encoding requant row
  const float* qh;    // (HID,) posttap boundary requant row, or null
  const float* iq;    // (HID,) real units of the tap layer, or null
};

// A launch's sizes, flags and outputs (nm_render_eval_forward's).
struct EvalArgs {
  int n_rays, layer_num, feat_layer, int8_from, F, Fd, S;
  float var_scale, log_eps;
  int white_bg, fine, feat_max, dbg;
  int* counter;
  float* scratch;          // the tile engine's scratch (tile_scratch_bytes), or null
  size_t scratch_floats;
  float *w, *depth, *acc, *rgb, *feat, *pts, *dbg_out;
  int8_t* dbgq;
  cudaStream_t stream;
};

// The global scratch of one block of the tile engine (render_eval_512.cuh,
// HID 512 and 1024), in bytes: the fine stage's tap values (64 rows x HID
// f32) and, at 1024, its descriptor partials (4 x HID f32) and, in both
// stages, a pass's parked outputs (64 rows x 512 bf16); 0 below 512.
__host__ __device__ constexpr size_t tile_scratch_bytes(int hid, bool fine) {
  return hid < 512 ? 0
                   : (fine ? (size_t)(64 + (hid > 512 ? 4 : 0)) * hid * sizeof(float) : 0) +
                         (hid > 512 ? (size_t)64 * 512 * 2 : 0);
}

// One trunk at one width: its launch (for the production encoding, and
// the wide one's), and its dynamic shared memory for the coarse or the
// fine stage and a dirs PE of dirs_dim columns; defined by
// NM_RENDER_EVAL_WIDTH in render_eval_<trunk>_<HID>.cu and
// NM_RENDER_EVAL_WIDE in render_eval_wide_<HID>.cu.
#define NM_RENDER_EVAL_DECL(NAME)                                              \
  cudaError_t launch_##NAME(const EvalParams& p, const QuantParams& qp,        \
                            const EvalArgs& a);                                \
  cudaError_t launch_wide_##NAME(const EvalParams& p, const QuantParams& qp,   \
                                 const EvalArgs& a);                           \
  size_t smem_##NAME(bool fine, int dirs_dim);
NM_RENDER_EVAL_DECL(bf16_64)
NM_RENDER_EVAL_DECL(bf16_128)
NM_RENDER_EVAL_DECL(bf16_192)
NM_RENDER_EVAL_DECL(bf16_256)
NM_RENDER_EVAL_DECL(q8_64)
NM_RENDER_EVAL_DECL(q8_128)
NM_RENDER_EVAL_DECL(q8_192)
NM_RENDER_EVAL_DECL(q8_256)
NM_RENDER_EVAL_DECL(bf16_512)   // render_eval_512.cuh
NM_RENDER_EVAL_DECL(q8_512)
NM_RENDER_EVAL_DECL(bf16_1024)  // render_eval_512.cuh
NM_RENDER_EVAL_DECL(q8_1024)
#undef NM_RENDER_EVAL_DECL

}  // namespace nm_eval

namespace {

using nm_eval::EvalArgs;
using nm_eval::EvalParams;
using nm_eval::QuantParams;

constexpr int kTileRays = 2;
constexpr int kSampleBlock = 32;
constexpr int kWgRows = kTileRays * kSampleBlock;  // a warpgroup's chunk
constexpr int kEvalThreads = 256;                  // two warpgroups
constexpr int kSliceK = 32;                        // bf16 weight rows a ring slot
constexpr int kSliceK8 = 64;                       // s8 weight rows a ring slot
static_assert(kWgRows == 64, "one chunk = one wgmma m64 tile");

template <int HID, bool FINE, bool Q8>
struct EvalSmem {
  static constexpr int HV = HID / 2;
  static constexpr int NV = HV < 64 ? 64 : HV;  // the views product's width
  // The fine stage's tap fragments leave room for 6 slots at HID 256.  The
  // int8 fine stage takes 4: at <= 196 KB of shared memory the SM keeps a
  // 60 KB L1 cache (28 KB above), where its spills stay (probe: 3.10 ms
  // against 3.37 with 6 slots, 'both' at eps 1e-4).
  static constexpr int kRing = FINE && HID > 64 ? (Q8 ? 4 : 6) : 7;
  // Ring slot: kSliceK bf16 weight rows x HID outputs, MN-major in
  // 64-column blocks, or kSliceK8 s8 rows, K-major (64 bytes a column,
  // 64-byte swizzle); a views slice (NV columns in whole 64-column blocks)
  // fills part of its slot.  The encoding tile: per warpgroup two K-major
  // blocks of 64 rows x 64 bf16 (kEncMax columns, zero past the
  // encoding), 128-byte swizzle; xq (Q8): one block of 64 rows x 128 s8.
  // The fine stage's tap fragments: per warpgroup 128 threads x HID / 16 x
  // 16 bytes (half of it for s8).
  static constexpr int kSlot = (HID / 64) * kSliceK * 128;
  static constexpr int kVSlot = (NV + 63) / 64 * kSliceK * 128;
  static constexpr int kEncBlock = 64 * 128;
  static constexpr int kEncOff = kRing * kSlot;
  static constexpr int kXqOff = kEncOff + 4 * kEncBlock;
  static constexpr int kAOff = kXqOff + (Q8 ? 2 * kEncBlock : 0);
  static constexpr int kFloatOff = kAOff + (FINE ? 2 * 128 * HID : 0);
  // f32 a warpgroup: row info (64 x 8: mean, variance, t_mean, mid-point),
  // sigma (64), weights (64), rgb (64 x 4), warp segments (4 x 8), ray state
  // (2 x 8: carry, depth, acc, sum w t_mean or feat_max's t_mean, rgb,
  // feat_max's largest weight), xt (2 x HV), descriptor partials (a row of
  // HID a warp).
  static constexpr int kInfo = 0, kSig = kInfo + kWgRows * 8, kWts = kSig + kWgRows,
                       kRgb = kWts + kWgRows, kSeg = kRgb + kWgRows * 4,
                       kRay = kSeg + 4 * 8, kXt = kRay + kTileRays * 8,
                       kFacc = kXt + kTileRays * HV, kWgFloats = kFacc + 4 * HID;
  static constexpr int kCtlOff = kFloatOff + 2 * kWgFloats * 4;  // 2 x (tile, block)
  static constexpr int kBarOff = kCtlOff + 16;
  // Last, sized at launch: the dirs PE of each warpgroup's rays (2 x 2 x
  // dirs_dim f32).
  static constexpr int kDirsOff = (kBarOff + 8 * kRing + 15) / 16 * 16;
  __host__ __device__ static constexpr size_t bytes(int dirs_dim) {
    return 1024 + kDirsOff + (size_t)2 * kTileRays * dirs_dim * 4;
  }
};

// An accumulator element as f32: the bf16 trunk keeps f32 variables, the
// int8 trunk one array of 32-bit integer variables for its s32 and f32
// products (and the f32 bits of an s8 layer's epilogue).
__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(uint32_t x) { return __uint_as_float(x); }
__device__ __forceinline__ void set_f32(float& x, float v) { x = v; }
__device__ __forceinline__ void set_f32(uint32_t& x, float v) { x = __float_as_uint(v); }

// clip(round_half_even(x), -127, 127)
__device__ __forceinline__ int sat_rn(float x) {
  return max(-127, min(127, __float2int_rn(x)));
}

// Four s32 values, each saturated to [-128, 127], as the bytes of one
// register, x0 the lowest.
__device__ __forceinline__ uint32_t pack_s8(int x0, int x1, int x2, int x3) {
  uint32_t hi, d;
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;\n" : "=r"(hi) : "r"(x3), "r"(x2), "r"(0));
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(x1), "r"(x0), "r"(hi));
  return d;
}

// Two f32 row values at p (8-byte aligned) by a plain load: the compiler
// hoists __ldg's of a whole epilogue above the products before it and
// holds them in registers (spills at 255 registers).
__device__ __forceinline__ float2 row2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// f(Int<I>{}), f(Int<I + 1>{}), .. f(Int<N - 1>{}): a loop whose index is a
// constant expression.
template <int I, int N, typename Fn>
__device__ __forceinline__ void static_for(Fn&& f) {
  if constexpr (I < N) {
    f(Int<I>{});
    static_for<I + 1, N>(f);
  }
}

// ENC: the encoding's 32-row slices (3: 2 * 3 * F <= 96; 4: <= 128).
// kDbg: dbg receives the tap layer's activations, (2, N, S, HID) f32: the
// first pass's, then the recomputed ones (fine stage; may be null with Q8);
// dbgq (Q8, may be null) the integer activations, (N, S, kEncMax + HID)
// int8: the quantized encoding (its first 2 * 3 * F columns), then the last
// layer's int8 input.
template <int HID, bool FINE, bool kDbg, bool Q8, int ENC>
__global__ void __launch_bounds__(kEvalThreads, 1)
render_eval_kernel(EvalParams p, QuantParams qp, int layer_num, int feat_layer,
                   int int8_from, int F, int Fd, int S, int n_tiles,
                   float var_scale, float log_eps, int white_bg, int feat_max,
                   int* __restrict__ tile_counter, float* __restrict__ out_w,
                   float* __restrict__ out_depth, float* __restrict__ out_acc,
                   float* __restrict__ out_rgb, float* __restrict__ out_feat,
                   float* __restrict__ out_pts, float* __restrict__ dbg,
                   int8_t* __restrict__ dbgq) {
  using L = EvalSmem<HID, FINE, Q8>;
  using Acc = typename std::conditional<Q8, uint32_t, float>::type;
  constexpr int HV = L::HV, NV = L::NV, R = L::kRing;
  constexpr int NJ = HID / 8, NJV = HV / 8;   // n8 column groups
  constexpr int KS = HID / kSliceK;           // bf16 slices of a HID-row product
  constexpr int KS8 = HID / kSliceK8;         // s8 slices of a HID-row product
  static_assert(HID % 64 == 0 && KS >= 2, "HID must be a multiple of 64");
  static_assert(HID * kSliceK8 == L::kSlot, "an s8 slice fills a bf16 slot");
  static_assert(L::bytes(kExtraMax) <= 232448, "render_eval shared memory");
  static_assert(!kDbg || FINE || Q8, "the tap exists in the fine stage only");
  static_assert(ENC == 3 || ENC == 4, "96 or 128 encoding rows");
  constexpr int ENC8 = 2;   // s8 slices of the encoding rows (64 each)

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
  const uint32_t xq_w = base + L::kXqOff + wg * L::kEncBlock;
  unsigned char* xq_p = sm + L::kXqOff + wg * L::kEncBlock;
  uint4* astash = reinterpret_cast<uint4*>(sm + L::kAOff) + wg * 128 * (HID / 16);
  float* fw = reinterpret_cast<float*>(sm + L::kFloatOff) + wg * L::kWgFloats;
  float* info = fw + L::kInfo;
  float* sig = fw + L::kSig;
  float* wts = fw + L::kWts;
  float* rgbs = fw + L::kRgb;
  // seg: a warp's row of 8 (its scan total, its six sums); feat_max: slot
  // 7 of warp r's row holds ray r's row of its block's largest weight when
  // it replaced the ray's carry, else -1.
  float* seg = fw + L::kSeg;
  float* ray_s = fw + L::kRay;
  float* xt = fw + L::kXt;
  float* facc = fw + L::kFacc;
  int* ctl = reinterpret_cast<int*>(sm + L::kCtlOff);   // [2 wg]: tile, block

  const int enc_dim = 6 * F, dirs_dim = 6 * Fd + 3;
  float* dpe = reinterpret_cast<float*>(sm + L::kDirsOff) + wg * kTileRays * dirs_dim;
  const int n_blocks = S / kSampleBlock;
  const size_t n_rows = (size_t)n_tiles * kTileRays * S;
  // The first s8 layer (none in the bf16 trunk).
  const int q_from = Q8 ? int8_from : layer_num;
  // The epilogues' weights at this thread's columns 8 j + 2 t: constant
  // offsets from one base each.
  const float* wa_t = p.wa + 2 * t;
  const float* bf_t = p.bf + 2 * t;
  const float* bv_t = p.bv + 2 * t;
  const float* wr_t = p.wr + 6 * t;

  // Slices a step streams, in the images' order: the trunk (per bf16 layer
  // its encoding rows, then its hidden rows; per s8 layer its hidden rows,
  // then its encoding rows), then for the fine stage the feature, the views
  // layer and the tap layer again (from the trunk's images).  All but the
  // views slices fill a whole slot.
  auto n_slices = [&](int i) {
    const bool enc = p.Wenc[i] != nullptr;
    return i >= q_from ? (enc ? ENC8 : 0) + (i > 0 ? KS8 : 0)
                       : (enc ? ENC : 0) + (i > 0 ? KS : 0);
  };
  int Qt = 0, tap_q0 = 0;
  for (int i = 0; i < layer_num; ++i) {
    if (i == feat_layer) tap_q0 = Qt;
    Qt += n_slices(i);
  }
  const int Q = FINE ? Qt + 2 * KS + n_slices(feat_layer) : Qt;

  // The encoding tiles' padding columns (enc_dim .. kEncMax - 1) stay zero.
  for (int i = tid; i < 2 * kWgRows * (kEncMax - enc_dim); i += kEvalThreads) {
    const int row = i / (kEncMax - enc_dim), k = enc_dim + i % (kEncMax - enc_dim);
    *reinterpret_cast<__nv_bfloat16*>(
        sm + L::kEncOff + (row >> 6) * 2 * L::kEncBlock + (k >> 6) * L::kEncBlock +
        swz(row & 63, (k & 63) >> 3) + (k & 7) * 2) = __float2bfloat16(0.f);
    if (Q8) sm[L::kXqOff + (row >> 6) * L::kEncBlock + swz(row & 63, k >> 4) + (k & 15)] = 0;
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
    bulk_copy(ring_s + slot * L::kSlot, p.W + off, bytes, full0 + 8 * slot);
  };
  int q = 0;   // next ring slice to consume
  if (tid == 0)
    for (int s = 0; s < R - 2; ++s) load_slice(s);

  Acc acc[NJ * 4];
  // A fragments: bf16, 16 columns (k) a step; or s8, 32 columns a step in
  // a[0 .. HID / 32).
  uint32_t a[HID / 16][4];
  // One wgmma batch stays in flight, so slot q - 2 is the one refilled
  // (with slice q + R - 2) when slice q is taken.
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
  // acc = the next NE encoding slices (A: the encoding tile) + the next NH
  // hidden slices (A: the registers a), N columns, bf16.
  // A warpgroup without a chunk multiplies too, on whatever its registers
  // and encoding tile hold (its epilogues write nothing): testing `live`
  // around the wgmma made the stage 1.35-1.5x slower and spilled
  // (scripts/render_eval_probe.py, live_gate).
  auto product = [&](auto ne_c, auto nh_c, auto n_c) {
    constexpr int NE = decltype(ne_c)::value, NH = decltype(nh_c)::value;
    constexpr int N = decltype(n_c)::value;
    constexpr int KK = kSliceK / 16;   // k16 steps a slice
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
  // The same for s8 (Q8): acc (s32) = the next NH hidden slices (A: the
  // registers a, s8) + the next NE encoding slices (A: xq; k32 steps 0-1,
  // then 2 (and 3 with ENC = 4)), N columns.
  auto product8 = [&](auto ne_c, auto nh_c, auto n_c) {
    constexpr int NE = decltype(ne_c)::value, NH = decltype(nh_c)::value;
    constexpr int N = decltype(n_c)::value;
    static_for<0, NH>([&](auto s_c) {
      constexpr int s = decltype(s_c)::value;
      const uint32_t slot = begin();
      wgmma_rs8<N, s == 0>(acc, a[2 * s], desc64(slot), 1);
      wgmma_rs8<N>(acc, a[2 * s + 1], desc64(slot + 32), 1);
      end();
    });
    static_for<0, NE>([&](auto s_c) {
      constexpr int s = decltype(s_c)::value;
      const uint32_t slot = begin();
      wgmma_ss8<N, NH + s == 0>(acc, desc128(xq_w + 64 * s, 16), desc64(slot), 1);
      if constexpr (s == 0 || ENC > 3)   // encoding k32 steps 0-1, then 2 (-3)
        wgmma_ss8<N>(acc, desc128(xq_w + 64 * s + 32, 16), desc64(slot + 32), 1);
      end();
    });
    wgmma_wait<0>();
  };
  // Layer i's product, by which rows it takes.
  auto layer_product = [&](int i) {
    if (i == 0)
      product(Int<ENC>{}, Int<0>{}, Int<HID>{});
    else if (p.Wenc[i] != nullptr)
      product(Int<ENC>{}, Int<KS>{}, Int<HID>{});
    else
      product(Int<0>{}, Int<KS>{}, Int<HID>{});
  };
  auto put_dbg = [&](int which, int tile, int sb, int row, int col, float v0, float v1) {
    const size_t gr = (size_t)(tile * kTileRays + row / kSampleBlock) * S +
                      sb * kSampleBlock + row % kSampleBlock;
    if (dbg != nullptr)
      *reinterpret_cast<float2*>(dbg + (which * n_rows + gr) * HID + col) = make_float2(v0, v1);
  };
  auto put_dbg1 = [&](int tile, int sb, int row, int col, float v) {   // first pass
    const size_t gr = (size_t)(tile * kTileRays + row / kSampleBlock) * S +
                      sb * kSampleBlock + row % kSampleBlock;
    if (dbg != nullptr) dbg[gr * HID + col] = v;
  };
  auto put_dbgq = [&](int tile, int sb, int row, int k, int v) {
    const size_t gr = (size_t)(tile * kTileRays + row / kSampleBlock) * S +
                      sb * kSampleBlock + row % kSampleBlock;
    if (dbgq != nullptr) dbgq[gr * (kEncMax + HID) + k] = (int8_t)v;
  };
  // The s8 A fragment of the next layer from accumulator columns 8 j + 2 t,
  // + 1, 8 (j + 1) + 2 t and + 1 of row half h (j even): k32 step j / 4,
  // register 2 ((j / 2) % 2) + h.  The next layer's image holds its K rows
  // in that order (quant.py: PERM32).  Values above 127 saturate.
  auto put_s8 = [&](int j, int h, int q0, int q1, int q2, int q3) {
    a[j >> 2][2 * ((j >> 1) & 1) + h] = pack_s8(q0, q1, q2, q3);
  };
  // Before column group j of an int8 trunk's epilogue, every 8 groups: a
  // point the compiler does not move loads across, so an epilogue's row
  // loads are issued 8 groups (32 registers) at a time, not all at once
  // (the accumulator, the A fragments and 128 loaded values spill).
  auto fence8 = [&](int j) {
    if (Q8 && j > 0 && (j & 7) == 0) __syncwarp();
  };
  // s8 layer i (Q8): its products, then acc <- the f32 bits of
  // y = acc * c (+ acc_s * c_s) + B, in the JAX epilogue's order, unfused.
  // The post-skip layer's encoding rows keep their own accumulator: the
  // hidden rows' product fills acc, scaled in place, then the encoding
  // rows' product runs 64 columns at a time with both encoding slices held
  // in the ring.  The s8 epilogues run on a warpgroup without a chunk too
  // (on whatever it holds; it writes nothing): gated by `live`, the A
  // registers they write would stay live across the trunk and spill.
  auto q8_layer = [&](int i) {
    if constexpr (Q8) {
      const float* c_t = qp.scale[i] + 2 * t;
      const float* b_t = qp.bias[i] + 2 * t;
      const auto i2f = [](uint32_t v) { return __int2float_rn((int)v); };
      if (i == 0) {
        product8(Int<ENC8>{}, Int<0>{}, Int<HID>{});
      } else {
        product8(Int<0>{}, Int<KS8>{}, Int<HID>{});
      }
      if (i > 0 && p.Wenc[i] != nullptr) {
        const float* cs_t = qp.scale_s[i] + 2 * t;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          fence8(j);
          const float2 c = row2(c_t + 8 * j);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[4 * j + e] = __float_as_uint(__fmul_rn(i2f(acc[4 * j + e]), e & 1 ? c.y : c.x));
        }
        const uint32_t e0 = begin();
        ++q;
        const uint32_t e1 = begin();
#pragma unroll
        for (int nb = 0; nb < HID / 64; ++nb) {
          uint32_t accs[32];
          if (nb > 0) wgmma_fence();
          wgmma_ss8<64, true>(accs, desc128(xq_w, 16), desc64(e0 + nb * 4096), 0);
          wgmma_ss8<64>(accs, desc128(xq_w + 32, 16), desc64(e0 + nb * 4096 + 32), 1);
          wgmma_ss8<64>(accs, desc128(xq_w + 64, 16), desc64(e1 + nb * 4096), 1);
          if constexpr (ENC > 3)
            wgmma_ss8<64>(accs, desc128(xq_w + 96, 16), desc64(e1 + nb * 4096 + 32), 1);
          wgmma_commit();
          wgmma_wait<0>();
          __syncwarp();   // fence8's point: this block's row loads stay here
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = 8 * nb + jj;
            const float2 cs = row2(cs_t + 8 * j), b = row2(b_t + 8 * j);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float ys = __fmul_rn(i2f(accs[4 * jj + e]), e & 1 ? cs.y : cs.x);
              acc[4 * j + e] = __float_as_uint(
                  __fadd_rn(__fadd_rn(f32(acc[4 * j + e]), ys), e & 1 ? b.y : b.x));
            }
          }
        }
        ++q;
      } else {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          fence8(j);
          const float2 c = row2(c_t + 8 * j), b = row2(b_t + 8 * j);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[4 * j + e] = __float_as_uint(__fadd_rn(
                __fmul_rn(i2f(acc[4 * j + e]), e & 1 ? c.y : c.x), e & 1 ? b.y : b.x));
        }
      }
    }
  };
  // The tap layer's A (the layer's input when it is a hidden layer), kept
  // for its second pass: HID / 16 fragments of bf16, HID / 32 of s8.
  auto stash_a = [&](int i, bool live, int groups) {
    if (FINE && live && i == feat_layer && i > 0) {
#pragma unroll
      for (int s = 0; s < HID / 16; ++s)
        if (s < groups) astash[s * 128 + lt] = make_uint4(a[s][0], a[s][1], a[s][2], a[s][3]);
    }
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
            out_pts[n * 3 + c] = feat_max ? ray[c] + ray[8 + c] * rs[3]
                                          : ray[c] * rs[2] + ray[8 + c] * rs[3];
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
        // Slot 7, feat_max's largest weight, starts below any weight.
        if (lt < kTileRays * 8) ray_s[lt] = (lt & 7) == 7 ? -1.f : 0.f;
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
            dpe[r * dirs_dim + j] = v;
          }
          wg_sync(wg);
          // Per-ray view contribution of the views layer: dirs_pe @ wvd
          // (+ app @ wva), f32; the appearance row is read from global
          // memory (dpe holds the dirs_dim values of a ray).
          for (int i = lt; i < kTileRays * HV; i += 128) {
            const int r = i / HV, k = i % HV;
            float s = 0.f;
            for (int j = 0; j < dirs_dim; ++j)
              s = fmaf(dpe[r * dirs_dim + j], __ldg(p.wvd + (size_t)j * HV + k), s);
            if (p.app != nullptr) {
              const float* a = p.app + (size_t)(ray0 + r) * kAppDim;
              for (int j = 0; j < kAppDim; ++j)
                s = fmaf(__ldg(a + j), __ldg(p.wva + (size_t)j * HV + k), s);
            }
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
      //      warpgroup's encoding tile: [sin block | cos block]; Q8: also
      //      quantized from the f32 values into xq ----
      for (int i = lt; i < kWgRows * 3 * F; i += 128) {
        const int row = i / (3 * F), j = i % (3 * F);
        const int f = j / 3, c = j % 3;
        const float* in = info + row * 8;
        const float x = in[c] * exp2f((float)f);
        const float y = in[3 + c] * exp2f((float)(2 * f));
        const float damp = expf(-0.5f * y);
        const __nv_bfloat16 v[2] = {__float2bfloat16(damp * sinf(x)),
                                    __float2bfloat16(damp * sinf(x + kHalfPi))};
        if (!Q8 || q_from > 0) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = h * 3 * F + j;
            *reinterpret_cast<__nv_bfloat16*>(enc_p + (k >> 6) * L::kEncBlock +
                                              swz(row, (k & 63) >> 3) + (k & 7) * 2) = v[h];
          }
        }
        if (Q8) {
          const float vf[2] = {damp * sinf(x), damp * sinf(x + kHalfPi)};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = h * 3 * F + j;
            const int xq = sat_rn(__fmul_rn(vf[h], __ldg(qp.qenc + k)));
            xq_p[swz(row, k >> 4) + (k & 15)] = (unsigned char)xq;
            if (kDbg) put_dbgq(tile, sb, row, k, xq);
          }
        }
      }
      fence_async();   // the encoding tile, for wgmma
    }

    // ---- trunk: acc = [enc @ Wenc_i] + [h @ Wh_i]; h = relu(acc + b)
    //      (bf16), or the s8 epilogue ----
    float sp[2] = {0.f, 0.f};   // sigma head partials of its two rows
    if constexpr (!Q8) {
      for (int i = 0; i < layer_num; ++i) {
        stash_a(i, live, HID / 16);
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
    } else {
      // The bf16 layers below int8_from; the last of them requantizes its
      // output for the s8 trunk (round half even, qh).
      for (int i = 0; i < q_from; ++i) {
        stash_a(i, live, HID / 16);
        layer_product(i);
        if (live) {
          const float* b_t = p.b[i] + 2 * t;
          const float* qh_t = qp.qh + 2 * t;
          if (i < q_from - 1) {
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              fence8(j);
              const float2 b = row2(b_t + 8 * j);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float v0 = fmaxf(f32(acc[4 * j + 2 * h]) + b.x, 0.f);
                const float v1 = fmaxf(f32(acc[4 * j + 2 * h + 1]) + b.y, 0.f);
                a[j >> 1][2 * (j & 1) + h] = pack_bf16(v0, v1);
                if (kDbg && FINE && i == feat_layer)
                  put_dbg(0, tile, sb, wrow + 8 * h, 8 * j + 2 * t, v0, v1);
              }
            }
          } else {   // into the s8 trunk: round half even (v >= 0)
#pragma unroll
            for (int j = 0; j < NJ; j += 2)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                if (h == 0) fence8(j);
                int qv[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int jj = j + e / 2, col = 8 * jj + 2 * t + e % 2;
                  const float v = fmaxf(f32(acc[4 * jj + 2 * h + e % 2]) + p.b[i][col], 0.f);
                  qv[e] = __float2int_rn(__fmul_rn(v, qp.qh[col]));
                  if (kDbg && i == layer_num - 2)
                    put_dbgq(tile, sb, wrow + 8 * h, kEncMax + col, min(qv[e], 127));
                  if (kDbg && FINE && i == feat_layer)
                    put_dbg1(tile, sb, wrow + 8 * h, col, v);
                }
                put_s8(j, h, qv[0], qv[1], qv[2], qv[3]);
              }
          }
        }
      }
      // The s8 hidden layers: max(y, 0.5) is the ReLU, the +0.5 in B turns
      // the truncating cast into round to nearest.
      for (int i = q_from; i < layer_num - 1; ++i) {
        stash_a(i, live, HID / 32);
        q8_layer(i);
#pragma unroll
        for (int j = 0; j < NJ; j += 2)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            int qv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int jj = j + e / 2, col = 8 * jj + 2 * t + e % 2;
              const float y = fmaxf(f32(acc[4 * jj + 2 * h + e % 2]), 0.5f);
              qv[e] = __float2int_rz(y);
              if (kDbg && live && i == layer_num - 2)
                put_dbgq(tile, sb, wrow + 8 * h, kEncMax + col, min(qv[e], 127));
              if (kDbg && FINE && live && i == feat_layer)
                put_dbg1(tile, sb, wrow + 8 * h, col,
                         __fmul_rn(__fsub_rn(y, 0.5f), qp.iq[col]));
            }
            put_s8(j, h, qv[0], qv[1], qv[2], qv[3]);
          }
      }
      // The last layer in real units: relu(acc * s (+ acc_s * s_s) + b),
      // rounded to bf16 for the feature head.
      {
        const int i = layer_num - 1;
        stash_a(i, live, HID / 32);
        q8_layer(i);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (h == 0) fence8(j);
            const float v0 = fmaxf(f32(acc[4 * j + 2 * h]), 0.f);
            const float v1 = fmaxf(f32(acc[4 * j + 2 * h + 1]), 0.f);
            const float2 wa = row2(wa_t + 8 * j);
            a[j >> 1][2 * (j & 1) + h] = pack_bf16(v0, v1);
            sp[h] = fmaf(v0, wa.x, fmaf(v1, wa.y, sp[h]));
            if (kDbg && FINE && live && i == feat_layer)
              put_dbg(0, tile, sb, wrow + 8 * h, 8 * j + 2 * t, v0, v1);
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
                pack_bf16(f32(acc[4 * j + 2 * h]) + b0, f32(acc[4 * j + 2 * h + 1]) + b1);
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
            const float v0 = fmaxf(f32(acc[4 * j + 2 * h]) + c0 + b0, 0.f);
            const float v1 = fmaxf(f32(acc[4 * j + 2 * h + 1]) + c1 + b1, 0.f);
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
          for (int c = 0; c < 6; ++c)
            if (!(FINE && feat_max && c == 2)) rs[1 + c] += seg[w2 * 8 + 1 + c];
        }
        if (FINE && feat_max) {
          // The block's first largest weight in z order; it replaces the
          // carry only when strictly larger (the first block always does).
          const float* wr = wts + lt * kSampleBlock;
          int best = 0;
          for (int j = 1; j < kSampleBlock; ++j)
            if (wr[j] > wr[best]) best = j;
          const bool upd = wr[best] > rs[7];
          if (upd) {
            rs[7] = wr[best];
            rs[3] = info[(lt * kSampleBlock + best) * 8 + 6];
          }
          seg[lt * 8 + 7] = upd ? (float)best : -1.f;
        }
      }
      if (lt == 0) ctl[2 * wg + 1] = sb + 1;
    }

    if (FINE) {
      // ---- descriptor: the tap layer again on its kept A, then
      //      sum w h_tap over the warp's rows into its partials (h_tap:
      //      relu(acc + b) for a bf16 tap, (max(y, 0.5) - 0.5) iq for an s8
      //      hidden one, relu(y) for the s8 last layer) ----
      const bool tap8 = Q8 && feat_layer >= q_from;
      if (live && feat_layer > 0) {
#pragma unroll
        for (int s = 0; s < HID / 16; ++s) {
          if (!tap8 || s < HID / 32) {
            const uint4 v = astash[s * 128 + lt];
            a[s][0] = v.x;
            a[s][1] = v.y;
            a[s][2] = v.z;
            a[s][3] = v.w;
          }
        }
      }
      if (tap8)
        q8_layer(feat_layer);
      else
        layer_product(feat_layer);
      if (live) {
        // h_tap into acc, in place.
        if (!tap8) {
          const float* b_t = p.b[feat_layer] + 2 * t;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            fence8(j);
            const float b0 = __ldg(b_t + 8 * j), b1 = __ldg(b_t + 8 * j + 1);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              set_f32(acc[4 * j + e], fmaxf(f32(acc[4 * j + e]) + (e & 1 ? b1 : b0), 0.f));
          }
        } else if (feat_layer == layer_num - 1) {
#pragma unroll
          for (int e = 0; e < NJ * 4; ++e) set_f32(acc[e], fmaxf(f32(acc[e]), 0.f));
        } else {
          const float* iq_t = qp.iq + 2 * t;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            fence8(j);
            const float2 iq = row2(iq_t + 8 * j);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              set_f32(acc[4 * j + e], __fmul_rn(__fsub_rn(fmaxf(f32(acc[4 * j + e]), 0.5f), 0.5f),
                                                e & 1 ? iq.y : iq.x));
          }
        }
        // feat_max: a one-hot weight on the ray's new argmax row, and no
        // write at all for a ray that kept its carry (warp-uniform: a warp's
        // rows belong to one ray).
        const float sel = feat_max ? seg[(wl >> 1) * 8 + 7] : 0.f;
        const int hot = (wl >> 1) * kSampleBlock + (int)sel;
        const float w0 = feat_max ? (wrow == hot ? 1.f : 0.f) : wts[wrow];
        const float w1 = feat_max ? (wrow + 8 == hot ? 1.f : 0.f) : wts[wrow + 8];
        float part[2 * NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float v00 = f32(acc[4 * j]), v01 = f32(acc[4 * j + 1]);
          const float v10 = f32(acc[4 * j + 2]), v11 = f32(acc[4 * j + 3]);
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
        if (!feat_max) {
#pragma unroll
          for (int i = 0; i < NJ / 4; ++i) {
            const int k = (NJ / 4) * g + i;
            fa[8 * (k >> 1) + 2 * t + (k & 1)] += part[i];
          }
        } else if (sel >= 0.f) {   // x + 0 == x: the other warp's row is 0
#pragma unroll
          for (int i = 0; i < NJ / 4; ++i) {
            const int k = (NJ / 4) * g + i;
            fa[8 * (k >> 1) + 2 * t + (k & 1)] = part[i];
          }
        }
      }
    }
  }

  // Slices loaded ahead for steps that never came: land them before the
  // block's shared memory goes.
  if (tid == 0)
    for (int s = q; s < q + R - 2; ++s) mbar_wait(full0 + 8 * (s % R), (s / R) & 1);
}

template <int HID, bool FINE, bool kDbg, bool Q8, int ENC>
cudaError_t launch(const EvalParams& p, const QuantParams& qp, const EvalArgs& a) {
  const size_t bytes = EvalSmem<HID, FINE, Q8>::bytes(6 * a.Fd + 3);
  auto kern = render_eval_kernel<HID, FINE, kDbg, Q8, ENC>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return e;
  // Persistent: at most one block an SM, two tiles a block to begin with.
  const int n_tiles = a.n_rays / kTileRays;
  const int grid = (n_tiles + 1) / 2 < sms ? (n_tiles + 1) / 2 : sms;
  kern<<<grid, kEvalThreads, bytes, a.stream>>>(
      p, qp, a.layer_num, a.feat_layer, a.int8_from, a.F, a.Fd, a.S, n_tiles,
      a.var_scale, a.log_eps, a.white_bg, a.feat_max, a.counter, a.w, a.depth,
      a.acc, a.rgb, a.feat, a.pts, a.dbg_out, a.dbgq);
  return cudaGetLastError();
}

// One trunk (Q8: the int8 one) at one width: the coarse or the fine stage,
// with the debug outputs or without.
template <int HID, bool Q8>
cudaError_t launch_trunk(const EvalParams& p, const QuantParams& qp, const EvalArgs& a) {
  if constexpr (!Q8) {   // the bf16 coarse stage has no debug outputs
    auto fn = !a.fine ? launch<HID, false, false, false, 3>
                      : a.dbg ? launch<HID, true, true, false, 3> : launch<HID, true, false, false, 3>;
    return fn(p, qp, a);
  } else {
    auto fn = !a.fine ? (a.dbg ? launch<HID, false, true, true, 3> : launch<HID, false, false, true, 3>)
                      : a.dbg ? launch<HID, true, true, true, 3> : launch<HID, true, false, true, 3>;
    return fn(p, qp, a);
  }
}

// The same at the wide encoding (ENC = 4), without debug outputs.
template <int HID, bool Q8>
cudaError_t launch_trunk_wide(const EvalParams& p, const QuantParams& qp, const EvalArgs& a) {
  if (a.dbg) return cudaErrorInvalidValue;
  return (a.fine ? launch<HID, true, false, Q8, 4> : launch<HID, false, false, Q8, 4>)(p, qp, a);
}

template <int HID, bool Q8>
size_t smem_trunk(bool fine, int dirs_dim) {
  return fine ? EvalSmem<HID, true, Q8>::bytes(dirs_dim)
              : EvalSmem<HID, false, Q8>::bytes(dirs_dim);
}

}  // namespace

// The instantiations of one trunk at one width (render_eval_<NAME>.cu),
// and those of the wide encoding (render_eval_wide_<HID>.cu).
#define NM_RENDER_EVAL_WIDTH(HID, Q8, NAME)                                    \
  cudaError_t nm_eval::launch_##NAME(const EvalParams& p, const QuantParams& qp, \
                                     const EvalArgs& a) {                      \
    return launch_trunk<HID, Q8>(p, qp, a);                                    \
  }                                                                            \
  size_t nm_eval::smem_##NAME(bool fine, int dirs_dim) {                       \
    return smem_trunk<HID, Q8>(fine, dirs_dim);                                \
  }
#define NM_RENDER_EVAL_WIDE(HID, Q8, NAME)                                     \
  cudaError_t nm_eval::launch_wide_##NAME(const EvalParams& p,                 \
                                          const QuantParams& qp,               \
                                          const EvalArgs& a) {                 \
    return launch_trunk_wide<HID, Q8>(p, qp, a);                               \
  }
