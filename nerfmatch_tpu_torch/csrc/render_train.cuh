// Fused mip-NeRF TRAIN render stage for Hopper (sm_90a): forward and
// hand-written backward, bf16 tensor-core MLP products, f32 elsewhere.
//
// This header holds the forward kernel and the trunk backward (launch 1
// below); render_train.cu the weight-gradient GEMM, the reductions and the
// C entries, each render_train_<HID>.cu the instantiations at one MLP
// width, HID in {64, 128, 192, 256}, and each render_train_wide_<HID>.cu
// the forward's at the wide encoding (one nvcc process each).  An MLP of
// another width up to 256 runs at the smallest of these that holds it,
// zero-padded on the host (render_train_kernel.py:
// pad_mlp_to_kernel_width).  The encoding takes 2 * 3 * F <= 128 columns
// (F <= 21): the forward's products and the stash take enc_rows(F) of
// them, 96 up to F = 16 (ENC = 3 slices, the production encoding's code)
// and 128 beyond (ENC = 4); a ray's extras row the view-direction PE
// padded to dirs_rows(Fd) (32 at Fd = 4) and the appearance row, at most
// kExtraMax + 16.
//
// Replaces the TPU kernels nerfmatch_tpu/ops/pallas/render_train.py:
// make_fused_train_render -> _fwd_impl (:420, fwd_kernel) and _bwd_impl
// (:455, bwd_kernel at :243), driven twice per step (coarse, fine) by
// make_fused_train_hierarchical.
//
// Forward, per ray: frustum moments from the jittered z fenceposts -> IPE
// -> L x HID trunk (skip concat as a second product into the same
// accumulator) -> sigma (+ the caller's density noise, before the ReLU) ->
// feature -> views -> sigmoid rgb -> alpha compositing.  Outputs rgb (N, 3)
// and weights (N, S).  No early termination (training).  An appearance MLP
// takes each ray's appearance row (app, N x kAppDim): it joins the views
// layer once a ray beside the viewdir PE (the JAX kernel's extras @ wvx),
// and the backward returns its cotangent g_app (extras_grad, :303-312).
// train_fwd_kernel:
// a persistent grid (at most one block an SM) of two warpgroups walking
// over 128-row chunks, each layer a wgmma m64nHIDk16 with A in registers
// (the layer before's accumulator after bias and ReLU, rounded to bf16;
// the encoding tile from shared memory for layer 0 and the skip layer) and
// B from a ring of 7 slots of 32 weight rows, one bulk copy each of the
// host-packed (in x out) images.  The training forward (kStash, a stash
// pointer given) also keeps every sample's bf16 activations (the encoding,
// each trunk layer, feature, views) and an f32 record (rgb, sigma_raw,
// alpha, transmittance) in the stash, which the backward reads: the
// forward runs once a step, where the JAX kernel recomputes it in its
// backward (VMEM keeps nothing from one call to the next).  The stash rows
// leave by one bulk store a row through a row buffer.
//
// Backward (nm_render_train_backward), three launches on the stash:
//   1. train_bwd_kernel, a persistent grid (at most one block an SM) of two
//      warpgroups walking over 128-row chunks (one ray at S = 128, two at
//      64, half of one at 256): per ray the composite backward (the reverse
//      exclusive prefix sum of g_w * w, warp shuffles over 32 samples),
//      then per chunk the heads and the trunk backward, each layer's
//      g_h = bf16(g_pre) @ bf16(W)^T as wgmma m64nHIDk16 with A in
//      registers (the masked accumulator of the layer before, rounded to
//      bf16, as FlashAttention-3 reuses P) and B from a ring of 8 slots of
//      32 weight rows in shared memory, one bulk copy each (the host packs
//      the weights as the slots' swizzled images), both warpgroups reading
//      each slot; the stashed activations arrive and the gradient rows
//      (g_pre of every layer, g_feat, g_hv, g_rgb) leave as row bulk
//      copies through one row buffer, apart from the ring; the vector
//      gradients (biases, sigma head) are column sums in a fixed order,
//      one partial row per block;
//   2. wgrad_gemm_kernel: every matrix-weight gradient,
//      sum over rows of bf16(act)^T bf16(g), as wgmma (both operands
//      MN-major in shared memory, the transpose bits set) on 128 x 256
//      output tiles (128 x 128 or x 64 for narrow N) of two warpgroups,
//      64-row stages in a 4-stage cp.async ring, split over 48 fixed row
//      ranges into partials;
//   3. reduce_parts_kernel: a fixed-order sum over the partials (matrix and
//      vector gradients);
//   4. with appearance rows, app_grad_kernel: g_app per ray from the
//      per-ray sum of g_hv that launch 1 leaves (rounded to bf16 once)
//      and the views layer's appearance rows, f32 FMAs in a fixed order
//      (the JAX kernel rounds each sample's g_hv @ wvx^T to bf16 and sums
//      those in f32: the two differ by that rounding).  The appearance
//      rows' weight gradient is the extras product of launch 2, its rows
//      widened from dirs_rows(Fd) to dirs_rows(Fd) + kAppDim.
// No atomics: the result is bit-reproducible run to run.
//
// Precision, as in the JAX kernel: matrix-product operands bf16 with f32
// accumulation (forward, backward g_h, and the weight-gradient products),
// residual activations bf16, everything else f32; the dirs part of the
// views layer and the rgb head take bf16-rounded operands too (the JAX
// train kernel rounds extras, wvx and wrgb).  sinf / expf in place of the
// TPU kernel's bf16-accurate polynomials.
//
// What bounds the backward on the H100 (9216 rays x 128 samples, 8 x 256
// MLP: 1,179,648 sample rows).  The JAX kernel keeps every weight gradient
// in VMEM across its sequential grid; on the GPU 2.4 MB of f32 gradients
// fit no SM and blocks run in no order, so the activations go through a
// stash and the weight gradients are a GEMM over it.  The training forward
// writes 6.0 GB of stash (5,088 bytes a row); launch 1 reads 4,384 and
// writes 4,880 bytes a row (10.9 GB, 3.3 ms at 3.35 TB/s) for 1.3 TFLOP of
// products, and streams 1.1 MB of weights from L2 per 128 rows; launch 2
// reads every product's operands once (12.7 GB with its partials, 3.8 ms)
// for 1.4 TFLOP.  Both are bound by bytes, not by the tensor cores
// (1.3-1.4 ms at the bf16 peak).  So is the training forward: 1.2 TFLOP
// (1.46 ms) against the 6.0 GB of stash it writes (1.8 ms); it streams the
// 1.2 MB of weights from L2 once per 128 rows (the mma.sync forward it
// replaces re-read them per 64 rows from global memory, and stored its
// stash 4 bytes at a time from the fragments).  chip_smoke.py phase 3b prints each launch's time beside
// its bytes; scripts/train_bwd_probe.py builds edited copies of this file
// without the products, the weight ring, the row copies or the column sums
// (and with fewer GEMM row ranges) and times them.
// -Xptxas -v (sm_90a, CUDA 12.8): train_fwd_kernel<256, stash, 3> 255
// registers, 36 bytes of spill stores / 44 of loads; <256, no stash, 3>
// 254 registers, no spills; <192, *, *> 250-253, <128, *, *> 209-220,
// <64, *, *> 124-128, no spills; dynamic shared memory at HID 256 ~226 KB
// (ring 112 KB, encoding tiles 32 KB, row buffer 66 KB, record 4 KB, f32
// 6 KB; nm_render_train_smem gives each width's).  train_bwd_kernel<256>
// 255 registers, 24 bytes of spill stores / 40 of loads, ~224 KB (ring
// 128 KB, row buffer 66 KB, f32 sums 24 KB); <192> 243, <128> 175, <64>
// 117 registers, no spills; wgrad_gemm_kernel 183 registers, no spills,
// 197,632 bytes (four 48 KB stages).  One block an SM for both.

#include <math.h>

#include "mma_common.cuh"
#include "wgmma_common.cuh"

// The types the C entries (render_train.cu) share with the instantiations.
namespace nm_train {

struct TrainParams {
  // Forward: every weight matrix's slot images (in x out), in the order the
  // forward's ring streams them (render_train_kernel.py: pack_train).
  const __nv_bfloat16* Wfwd;
  const __nv_bfloat16* Wenc[kMaxLayers];  // layer i's encoding rows there, or null
  const __nv_bfloat16* WhT[kMaxLayers];   // hidden rows of layer i (out x in): slot images
  const float* b[kMaxLayers];
  const float* wa;    // (hid,) sigma head, f32
  const float* ba;    // (1,)
  const __nv_bfloat16* wfT;   // feature head (out x in): slot images
  const float* bf;
  const __nv_bfloat16* wvhT;  // views layer, hidden rows (hv x hid): slot images
  const float* wvd;   // views layer, dirs rows (dirs_dim, hv), bf16 values
  const float* wva;   // views layer, appearance rows (kAppDim, hv), bf16
                      // values, or null (no appearance table)
  const float* bv;
  const float* wr;    // rgb head (hv, 3), bf16 values
  const float* br;
  const float* rays;   // (N, 12) packed, unit-direction parameterization
  const float* z;      // (N, S + 1) fenceposts
  const float* noise;  // (N, S) density noise
  const float* app;    // (N, kAppDim) appearance rows, or null
};

// Workspace slots; sample row r = ray * S + s.  bf16 unless noted.
struct Stash {
  __nv_bfloat16* xb;               // (rows, enc_rows(F)) encoding
  __nv_bfloat16* hs[kMaxLayers];   // (rows, HID) trunk activations
  __nv_bfloat16* feat;             // (rows, HID)
  __nv_bfloat16* hv;               // (rows, HV)
  float* rec;                      // (rows, 8) f32: rgb, sigma_raw, alpha, T
  __nv_bfloat16* extras;           // (N, extras_width) viewdir PE [+ app]
  __nv_bfloat16* g_pre[kMaxLayers];
  __nv_bfloat16* g_feat;           // (rows, HID)
  __nv_bfloat16* g_hv;             // (rows, HV)
  __nv_bfloat16* g_rgb;            // (rows, 8): d loss / d rgb logits
  __nv_bfloat16* g_hvsum;          // (N, HV): per-ray sum of g_hv
  float* vec_part;                 // (N / kTileRays, P) f32
};

// The forward (a stash given: the training forward; the production
// encoding's, and the wide one's) and the trunk backward (launch 1; *parts
// gets its blocks, the vector partials' rows) at one width; defined by
// NM_RENDER_TRAIN_WIDTH in render_train_<HID>.cu and NM_RENDER_TRAIN_WIDE
// in render_train_wide_<HID>.cu.
#define NM_RENDER_TRAIN_DECL(H)                                                \
  cudaError_t train_fwd_##H(const TrainParams& p, const Stash& st, bool stash,  \
                            int n_rays, int layer_num, int F, int Fd, int S,    \
                            float var_scale, int white_bg, float* rgb, float* w, \
                            cudaStream_t stream);                               \
  cudaError_t train_fwd_wide_##H(const TrainParams& p, const Stash& st,         \
                                 bool stash, int n_rays, int layer_num, int F,  \
                                 int Fd, int S, float var_scale, int white_bg,  \
                                 float* rgb, float* w, cudaStream_t stream);    \
  cudaError_t train_bwd_##H(const TrainParams& p, const Stash& st, int n_rays,  \
                            int layer_num, int S, int white_bg,                 \
                            const float* g_rgb, const float* g_w, int* parts,   \
                            cudaStream_t stream);
NM_RENDER_TRAIN_DECL(64)
NM_RENDER_TRAIN_DECL(128)
NM_RENDER_TRAIN_DECL(192)
NM_RENDER_TRAIN_DECL(256)
#undef NM_RENDER_TRAIN_DECL

}  // namespace nm_train

namespace {

using nm_train::Stash;
using nm_train::TrainParams;

constexpr int kTileRays = 2;      // rays a vector-partial row (N / 2 rows)
constexpr int kMaxSamples = 256;
constexpr int kRecWidth = 8;      // f32 record per sample
constexpr int kGrgbWidth = 8;     // bf16 g_rgb_t row (3 used)

// A ray's extras row: the viewdir PE padded to dirs_rows(Fd), then its
// appearance row.
__host__ __device__ inline int extras_width(int Fd, bool app) {
  return dirs_rows(Fd) + (app ? kAppDim : 0);
}

// Vector-gradient layout (P floats): b_0 .. b_{L-1}, bf, bv, brgb (4),
// wa, ba (4).
struct VecLayout {
  int bf, bv, brgb, wa, ba, P;
  __host__ __device__ VecLayout(int L, int hid) {
    bf = L * hid;
    bv = bf + hid;
    brgb = bv + hid / 2;
    wa = brgb + 4;
    ba = wa + hid;
    P = ba + 4;
  }
};

constexpr int kBwdThreads = 256;   // two warpgroups, 64 chunk rows each
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kChunkRows = 128;
constexpr int kRingStages = 8;     // a whole HID 256 layer of weight slices
constexpr int kSliceK = 32;        // weight rows (the product's k) a slot

template <int HID>
struct BwdSmem {
  static constexpr int HV = HID / 2;
  // Ring slot: kSliceK weight rows x HID, MN-major in 64-column blocks; the
  // chunk's 128 rows of hs (or hv), row-major, rows padded by 16 bytes.
  static constexpr int kSlot = (HID / 64) * kSliceK * 128;
  static constexpr int kHsStride = HID * 2 + 16;
  static constexpr int kHsOff = kRingStages * kSlot;
  static constexpr int kFloatOff = kHsOff + kChunkRows * kHsStride;
  static size_t bytes(int P) {
    return 1024 + kFloatOff +
           (size_t)(4 * kMaxSamples + P + kBwdWarps * HID + 2 * HV + 8) * 4 +
           8 * (1 + kRingStages);
  }
};

// ---- the forward: heads, trunk and compositing, one 128-row chunk at a time ----

constexpr int kFwdRing = 7;                    // weight slots (ring stages)

template <int HID>
struct FwdSmem {
  static constexpr int HV = HID / 2;
  static constexpr int NV = HV < 64 ? 64 : HV;   // the views product's width
  // Ring slot: kSliceK weight rows (the product's k, the layer's input) x
  // HID outputs, MN-major in 64-column blocks; a views slice (NV columns in
  // whole 64-column blocks) fills part of its slot.  The encoding tile: per
  // warpgroup two K-major blocks of 64 rows x 64 bf16 (kEncMax columns,
  // zero past the encoding), 128-byte swizzle.  The row buffer: the
  // chunk's 128 stash rows, row-major, padded by 16 bytes.  The record: 128
  // rows of 8 f32 (rgb, sigma_raw, alpha, T, 0 ...).  (Below HID 128 the
  // rows are as wide as the widest encoding's 128.)
  static constexpr int kSlot = (HID / 64) * kSliceK * 128;
  static constexpr int kVSlot = (NV + 63) / 64 * kSliceK * 128;
  static constexpr int kEncBlock = 64 * 128;
  static constexpr int kEncOff = kFwdRing * kSlot;
  static constexpr int kRowStride = (HID > kEncMax ? HID : kEncMax) * 2 + 16;
  static constexpr int kRowOff = kEncOff + 4 * kEncBlock;
  static constexpr int kRecOff = kRowOff + kChunkRows * kRowStride;
  static constexpr int kFloatOff = kRecOff + kChunkRows * kRecWidth * 4;
  // f32: row info (128 x 8), xt (2 x HV), segment sums (8 x 8), per-ray
  // carries (2 x 8); then the ring's mbarriers; last, sized at launch, the
  // extras rows of the unit's rays (2 x ew f32).
  static constexpr int kFloats = kChunkRows * 8 + 2 * HV + kBwdWarps * 8 + 2 * 8;
  static constexpr int kDpeOff = (kFloatOff + kFloats * 4 + 8 * kFwdRing + 15) / 16 * 16;
  __host__ __device__ static constexpr size_t bytes(int ew) {
    return 1024 + kDpeOff + (size_t)2 * ew * 4;
  }
};

// Train forward: a persistent grid (at most one block an SM) of two
// warpgroups walking over 128-row chunks (units of one ray at S >= 128, two
// at S = 64; a ray of S = 256 is two chunks, with its transmittance and
// sums carried from the first to the second).  Per chunk: frustum moments
// and the IPE of every row into the swizzled encoding tile; each trunk
// layer as wgmma m64nHIDk16, A in registers (the layer before's
// accumulator after bias and ReLU, rounded to bf16) and, for layer 0 and
// the skip layer, the encoding tile from shared memory into the same
// accumulator; B from a ring of kFwdRing slots of 32 weight rows, one bulk
// copy each from the host-packed images (render_train_kernel.py:
// pack_train, slices in the order they are used), both warpgroups reading
// each slot; the sigma and rgb heads as per-thread dot products over the
// accumulator's columns and quad shuffles; compositing on all warps (a
// half-warp scan of log(1 - alpha) per 16 rows and one shared-memory pass
// over the segments).  kStash: every row's encoding and activations leave
// by one bulk store a row through the row buffer, the record by one bulk
// store a chunk.  ENC: the encoding's 32-row slices (3: 2 * 3 * F <= 96;
// 4: <= 128).
template <int HID, bool kStash, int ENC>
__global__ void __launch_bounds__(kBwdThreads, 1)
train_fwd_kernel(TrainParams p, Stash st, int layer_num, int F, int Fd, int S,
                 int n_rays, float var_scale, int white_bg,
                 float* __restrict__ out_rgb, float* __restrict__ out_w) {
  using L = FwdSmem<HID>;
  constexpr int HV = L::HV, NV = L::NV;
  constexpr int NJ = HID / 8, NJV = HV / 8;   // n8 column groups
  constexpr int KS = HID / kSliceK;           // slices of a HID-row product
  static_assert(HID % 64 == 0 && KS >= 2, "HID must be a multiple of 64");
  static_assert(L::bytes(kExtraMax + kAppDim) <= 232448, "forward shared memory");

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t ring_s = base, enc_s = base + L::kEncOff;
  const uint32_t row_s = base + L::kRowOff, rec_s = base + L::kRecOff;
  unsigned char* rowbuf = sm + L::kRowOff;
  float* rec = reinterpret_cast<float*>(sm + L::kRecOff);      // 128 x 8
  float* info = reinterpret_cast<float*>(sm + L::kFloatOff);   // 128 x 8
  float* xt = info + kChunkRows * 8;                           // 2 x HV
  float* seg = xt + 2 * HV;                                    // 8 x 8
  float* ray_s = seg + kBwdWarps * 8;   // 2 x 8: carry, acc, rgb (3)
  const uint32_t full0 = smem_u32(ray_s + 16);                 // slot s: + 8 s

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = tid >> 7, t = lane & 3;
  const int wrow = (warp & 3) * 16 + (lane >> 2);   // first of its two rows
  const int enc_dim = 6 * F, dirs_dim = 6 * Fd + 3;
  static_assert(ENC == 3 || ENC == 4, "96 or 128 encoding rows");
  constexpr int enc_pad = ENC * kSliceK;
  const int dpad = dirs_rows(Fd);
  const int ew = extras_width(Fd, p.app != nullptr);
  float* dpe = reinterpret_cast<float*>(sm + L::kDpeOff);      // 2 x ew
  const uint32_t enc_w = enc_s + wg * 2 * L::kEncBlock;   // this warpgroup's
  // The epilogues' weights at this thread's columns 8 j + 2 t (rows of wr):
  // constant offsets from one base each, not an address a column for the
  // compiler to hoist out of the chunk loop (and spill).
  const float* wa_t = p.wa + 2 * t;
  const float* bf_t = p.bf + 2 * t;
  const float* bv_t = p.bv + 2 * t;
  const float* wr_t = p.wr + 6 * t;

  const int G = S >= kChunkRows ? 1 : kChunkRows / S;
  const int unit_chunks = G * S / kChunkRows;
  const int n_units = n_rays / G;
  const int my_units = (n_units - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  // Slices a chunk streams, in the host images' order: per layer its
  // encoding rows (if any) then its hidden rows, then the feature and the
  // views layers.  All but the views slices fill a whole slot.
  int Qt = KS * (layer_num - 1);
  for (int i = 0; i < layer_num; ++i) Qt += p.Wenc[i] != nullptr ? ENC : 0;
  const int Q = Qt + 2 * KS;
  const int q_total = my_units * unit_chunks * Q;

  // The encoding tile's padding columns (enc_dim .. kEncMax - 1) stay zero.
  for (int i = tid; i < kChunkRows * (kEncMax - enc_dim); i += kBwdThreads) {
    const int row = i / (kEncMax - enc_dim), k = enc_dim + i % (kEncMax - enc_dim);
    *reinterpret_cast<__nv_bfloat16*>(
        sm + L::kEncOff + (row >> 6) * 2 * L::kEncBlock + (k >> 6) * L::kEncBlock +
        swz(row & 63, (k & 63) >> 3) + (k & 7) * 2) = __float2bfloat16(0.f);
  }
  if (tid == 0)
    for (int i = 0; i < kFwdRing; ++i) mbar_init(full0 + 8 * i);
  fence_async();
  __syncthreads();

  auto load_slice = [&](int q) {
    const int qc = q % Q;
    const bool views = qc >= Qt + KS;
    const uint32_t bytes = views ? L::kVSlot : L::kSlot;
    const size_t off = views ? (size_t)(Qt + KS) * L::kSlot + (size_t)(qc - Qt - KS) * L::kVSlot
                             : (size_t)qc * L::kSlot;
    const int slot = q % kFwdRing;
    mbar_expect(full0 + 8 * slot, bytes);
    bulk_copy(ring_s + slot * L::kSlot,
              reinterpret_cast<const unsigned char*>(p.Wfwd) + off, bytes,
              full0 + 8 * slot);
  };
  int q = 0;   // next ring slice to consume
  if (tid == 0)
    for (int s = 0; s < kFwdRing - 2 && s < q_total; ++s) load_slice(s);

  float acc[NJ * 4];
  uint32_t a[HID / 16][4];   // bf16 A fragments: 16 columns (k) a step
  // acc = the next NE encoding slices (A: the encoding tile) + the next NH
  // hidden slices (A: the registers a), N columns.  One wgmma batch stays
  // in flight, so slot q - 2 is the one refilled (with slice q + kFwdRing
  // - 2).  The stores of the previous stash rows have read the row buffer
  // once the second slice starts.
  auto product = [&](auto ne_c, auto nh_c, auto n_c) {
    constexpr int NE = decltype(ne_c)::value, NH = decltype(nh_c)::value;
    constexpr int N = decltype(n_c)::value;
    constexpr int KK = kSliceK / 16;   // k16 steps a slice
    // Slice s of the product: its slot, once it has landed.
    auto begin = [&](int s) {
      if (kStash && s == 1 && tid < kChunkRows) bulk_read_done();
      __syncthreads();   // batch q - 2 done everywhere: its slot is free
      if (tid == 0 && q + kFwdRing - 2 < q_total) load_slice(q + kFwdRing - 2);
      mbar_wait(full0 + 8 * (q % kFwdRing), (q / kFwdRing) & 1);
      wgmma_fence();
      return ring_s + (uint32_t)(q % kFwdRing) * L::kSlot;
    };
    auto end = [&]() {
      wgmma_commit();
      wgmma_wait<1>();
      ++q;
    };
#pragma unroll
    for (int s = 0; s < NE; ++s) {
      const uint32_t slot = begin(s);
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
      const uint32_t slot = begin(NE + s);
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
        wgmma_rs<N, 1>(acc, a[s * KK + kk], desc128(slot + kk * 2048, kSliceK * 128),
                       NE + s + kk > 0);
      end();
    }
    wgmma_wait<0>();
  };
  // The row buffer's rows (width bf16 each) -> dst rows rg0 ..; after every
  // thread's writes to it.
  auto store_rows = [&](__nv_bfloat16* dst, int width, size_t rg0) {
    fence_async();
    __syncthreads();
    if (tid < kChunkRows)
      bulk_store(dst + (rg0 + tid) * width, row_s + tid * L::kRowStride, width * 2);
  };
  auto put_pair = [&](int r, int col, uint32_t v) {   // row r of the warpgroup
    *reinterpret_cast<uint32_t*>(rowbuf + (wg * 64 + r) * L::kRowStride + col * 2) = v;
  };

  for (int ui = 0; ui < my_units; ++ui) {
    const int ray0 = ((int)blockIdx.x + ui * (int)gridDim.x) * G;
    __syncthreads();   // the last unit's sums are read
    // Extras per ray, rounded to bf16: the view-direction PE [sin(2^f d) |
    // cos | d], zeros to dpad, then the appearance row.
    for (int i = tid; i < G * ew; i += kBwdThreads) {
      const int r = i / ew, j = i % ew;
      const float* ray = p.rays + (size_t)(ray0 + r) * 12;
      float v = 0.f;
      if (j < 6 * Fd) {
        const int jj = j % (3 * Fd);
        const float x = ray[8 + jj % 3] * exp2f((float)(jj / 3));
        v = j < 3 * Fd ? sinf(x) : sinf(x + kHalfPi);
      } else if (j < dirs_dim) {
        v = ray[8 + j - 6 * Fd];
      } else if (j >= dpad) {
        v = p.app[(size_t)(ray0 + r) * kAppDim + j - dpad];
      }
      dpe[r * ew + j] = bf16_round(v);
      if (kStash) st.extras[(size_t)(ray0 + r) * ew + j] = __float2bfloat16(v);
    }
    if (tid < 2 * 8) ray_s[tid] = 0.f;
    __syncthreads();
    // xt = extras @ [wvd; wva] (bf16 values, f32 FMAs), once a ray.
    for (int i = tid; i < G * HV; i += kBwdThreads) {
      const int r = i / HV, k = i % HV;
      const float* e = dpe + r * ew;
      float s = 0.f;
      for (int j = 0; j < dirs_dim; ++j)
        s = fmaf(e[j], __ldg(p.wvd + (size_t)j * HV + k), s);
      if (p.wva != nullptr)
        for (int j = 0; j < kAppDim; ++j)
          s = fmaf(e[dpad + j], __ldg(p.wva + (size_t)j * HV + k), s);
      xt[i] = s;
    }

    for (int ch = 0; ch < unit_chunks; ++ch) {
      const size_t rg0 = (size_t)ray0 * S + ch * kChunkRows;
      // The stores of the last chunk have read the row buffer and the
      // record; every read of the encoding tile and the row info is done.
      if (kStash && tid < kChunkRows) bulk_read_done();
      __syncthreads();
      // ---- per-row frustum moments -> Gaussian mean / variance ----
      if (tid < kChunkRows) {
        const int ul = ch * kChunkRows + tid, n = ray0 + ul / S, s = ul % S;
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
        float* in = info + tid * 8;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float d = ray[8 + c], d2 = d * d;
          in[c] = __fadd_rn(__fmul_rn(d, t_mean), ray[c]);
          in[3 + c] = t_var * d2 + r_var * (1.f - d2);
        }
        in[6] = t1 - t0;
      }
      __syncthreads();
      // ---- integrated positional encoding (f32, rounded to bf16) into the
      //      encoding tile and, for the stash, the row buffer ----
      for (int i = tid; i < kChunkRows * 3 * F; i += kBwdThreads) {
        const int row = i / (3 * F), j = i % (3 * F);
        const int f = j / 3, c = j % 3;
        const float* in = info + row * 8;
        const float x = in[c] * exp2f((float)f);
        const float y = in[3 + c] * exp2f((float)(2 * f));
        const float damp = expf(-0.5f * y);
        const __nv_bfloat16 v[2] = {__float2bfloat16(damp * sinf(x)),
                                    __float2bfloat16(damp * sinf(x + kHalfPi))};
        unsigned char* tile = sm + L::kEncOff + (row >> 6) * 2 * L::kEncBlock;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = h * 3 * F + j;
          *reinterpret_cast<__nv_bfloat16*>(tile + (k >> 6) * L::kEncBlock +
                                            swz(row & 63, (k & 63) >> 3) + (k & 7) * 2) = v[h];
          if (kStash)
            *reinterpret_cast<__nv_bfloat16*>(rowbuf + row * L::kRowStride + k * 2) = v[h];
        }
      }
      if (kStash) {
        for (int i = tid; i < kChunkRows * (enc_pad - enc_dim); i += kBwdThreads) {
          const int row = i / (enc_pad - enc_dim), k = enc_dim + i % (enc_pad - enc_dim);
          *reinterpret_cast<__nv_bfloat16*>(rowbuf + row * L::kRowStride + k * 2) =
              __float2bfloat16(0.f);
        }
      }
      fence_async();   // the encoding tile, for wgmma
      if (kStash) store_rows(st.xb, enc_pad, rg0);

      // ---- trunk: acc = [enc @ Wenc_i] + [bf16(h) @ Wh_i]; h = relu(acc + b) ----
      float sp[2] = {0.f, 0.f};   // sigma head partials of its two rows
      for (int i = 0; i < layer_num; ++i) {
        if (i == 0)
          product(Int<ENC>{}, Int<0>{}, Int<HID>{});
        else if (p.Wenc[i] != nullptr)
          product(Int<ENC>{}, Int<KS>{}, Int<HID>{});
        else
          product(Int<0>{}, Int<KS>{}, Int<HID>{});
        const bool last = i == layer_num - 1;
        const float* b_t = p.b[i] + 2 * t;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = 8 * j + 2 * t;
          const float b0 = __ldg(b_t + 8 * j), b1 = __ldg(b_t + 8 * j + 1);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v0 = fmaxf(acc[4 * j + 2 * h] + b0, 0.f);
            const float v1 = fmaxf(acc[4 * j + 2 * h + 1] + b1, 0.f);
            const uint32_t pk = pack_bf16(v0, v1);
            a[j >> 1][2 * (j & 1) + h] = pk;
            if (kStash) put_pair(wrow + 8 * h, col, pk);
            if (last)
              sp[h] = fmaf(v0, __ldg(wa_t + 8 * j), fmaf(v1, __ldg(wa_t + 8 * j + 1), sp[h]));
          }
        }
        if (kStash) store_rows(st.hs[i], HID, rg0);
      }
      // ---- sigma_raw = h . wa + ba + noise (f32 activations) ----
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s = sp[h];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        const int row = wg * 64 + wrow + 8 * h;
        if (t == 0) rec[row * 8 + 3] = s + __ldg(p.ba) + p.noise[rg0 + row];
      }

      // ---- feature = bf16(h) @ wf + bf (no activation), rounded to bf16 ----
      product(Int<0>{}, Int<KS>{}, Int<HID>{});
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = 8 * j + 2 * t;
        const float b0 = __ldg(bf_t + 8 * j), b1 = __ldg(bf_t + 8 * j + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t pk = pack_bf16(acc[4 * j + 2 * h] + b0, acc[4 * j + 2 * h + 1] + b1);
          a[j >> 1][2 * (j & 1) + h] = pk;
          if (kStash) put_pair(wrow + 8 * h, col, pk);
        }
      }
      if (kStash) store_rows(st.feat, HID, rg0);

      // ---- views = relu(feature @ wvh + dirs_pe @ wvd + bv), rounded to
      //      bf16; rgb = sigmoid(views @ wr + br) on the rounded views ----
      product(Int<0>{}, Int<KS>{}, Int<NV>{});
      {
        const float* x = xt + ((ch * kChunkRows + wg * 64) / S) * HV;
        float pr[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
        for (int j = 0; j < NJV; ++j) {
          const int col = 8 * j + 2 * t;
          const float c0 = x[col] , c1 = x[col + 1];
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
            if (kStash) put_pair(wrow + 8 * h, col, pk);
            const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pk));
#pragma unroll
            for (int c = 0; c < 3; ++c) pr[h][c] = fmaf(r.x, wr[0][c], fmaf(r.y, wr[1][c], pr[h][c]));
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wg * 64 + wrow + 8 * h;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            float s = pr[h][c];
            s += __shfl_xor_sync(0xffffffffu, s, 1);
            s += __shfl_xor_sync(0xffffffffu, s, 2);
            if (t == 0) rec[row * 8 + c] = 1.f / (1.f + expf(-(s + __ldg(p.br + c))));
          }
        }
      }
      if (kStash) store_rows(st.hv, HV, rg0);
      else __syncthreads();   // the record's rgb and sigma_raw

      // ---- compositing: warp w takes chunk rows 16 w .., one row a lane
      //      of each half (the halves compute the same); the transmittance
      //      is exp of the exclusive prefix of log(1 - alpha) over the ray
      //      ----
      {
        const int row = warp * 16 + (lane & 15);
        const int r = (ch * kChunkRows + row) / S;   // ray of the unit
        float* rr = rec + row * 8;
        const float alpha = 1.f - expf(-fmaxf(rr[3], 0.f) * info[row * 8 + 6]);
        const float lt = logf(1.f - alpha + 1e-10f);
        float incl = lt;
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) {
          const float v = __shfl_up_sync(0xffffffffu, incl, o, 16);
          if ((lane & 15) >= o) incl += v;
        }
        if (lane == 15) seg[warp * 8] = incl;
        __syncthreads();
        const int w0 = S >= kChunkRows ? 0 : warp & ~(S / 16 - 1);  // ray's first
        float before = ray_s[r * 8];
        for (int w = w0; w < warp; ++w) before += seg[w * 8];
        const float trans = expf(before + (incl - lt));
        const float wt = alpha * trans;
        float sums[4] = {wt, wt * rr[0], wt * rr[1], wt * rr[2]};
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int o = 8; o > 0; o >>= 1) sums[c] += __shfl_xor_sync(0xffffffffu, sums[c], o);
        if (lane < 16) {
          out_w[rg0 + row] = wt;
          rr[4] = alpha;
          rr[5] = trans;
          rr[6] = rr[7] = 0.f;
        }
        if (lane == 0)
          for (int c = 0; c < 4; ++c) seg[warp * 8 + 1 + c] = sums[c];
      }
      fence_async();   // the record, for its bulk store
      __syncthreads();
      if (kStash && tid == 0)
        bulk_store(st.rec + rg0 * kRecWidth, rec_s, kChunkRows * kRecWidth * 4);
      // Per ray of the chunk, its segments in order.
      const int rays_here = S >= kChunkRows ? 1 : G;
      if (tid < rays_here) {
        const int r = S >= kChunkRows ? 0 : tid, per = kChunkRows / 16 / rays_here;
        float* rs = ray_s + r * 8;
        for (int w = r * per; w < (r + 1) * per; ++w) {
          rs[0] += seg[w * 8];
          for (int c = 0; c < 4; ++c) rs[1 + c] += seg[w * 8 + 1 + c];
        }
      }
    }
    __syncthreads();
    if (tid < G) {
      const float* rs = ray_s + tid * 8;
      const float bg = white_bg ? 1.f - rs[1] : 0.f;
      for (int c = 0; c < 3; ++c) out_rgb[(size_t)(ray0 + tid) * 3 + c] = rs[2 + c] + bg;
    }
  }

  if (kStash && tid < kChunkRows)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---- backward launch 1: heads and trunk backward, one 128-row chunk at a time ----

// Column sums over a warp's 16 rows.  v[2 j + e] holds this thread's two
// rows of column 8 j + 2 (lane % 4) + e; a reduce-scatter over the eight
// lanes of equal lane % 4 (K / 2 + K / 4 + K / 8 shuffles) leaves lane
// (g, t) the sums of j = K g / 16 .., stored to dst[column].
template <int K>
__device__ __forceinline__ void col_sums(float (&v)[K], int lane, float* dst) {
  static_assert(K % 8 == 0, "eight lanes share a column");
  fold_half<16, K>(v, lane);
  fold_half<8, K / 2>(v, lane);
  fold_half<4, K / 4>(v, lane);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < K / 8; ++i) {
    const int k = (K / 8) * g + i;
    dst[8 * (k >> 1) + 2 * t + (k & 1)] = v[i];
  }
}

template <int HID>
__global__ void __launch_bounds__(kBwdThreads, 1)
train_bwd_kernel(TrainParams p, Stash st, int layer_num, int S, int n_rays,
                 int white_bg, const float* __restrict__ g_rgb_in,
                 const float* __restrict__ g_w_in) {
  using L = BwdSmem<HID>;
  constexpr int HV = L::HV;
  constexpr int NJ = HID / 8, NJV = HV / 8;     // n8 column groups
  constexpr int KS = HID / kSliceK, KSV = HV / kSliceK;
  constexpr int JB = NJV < 16 ? NJV : 16;   // column groups a col_sums call
  static_assert(KSV >= 1 && HID % 64 == 0, "HID must be a multiple of 64");
  const VecLayout vl(layer_num, HID);

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t ring_s = base, hs_s = base + L::kHsOff;
  float* gsr = reinterpret_cast<float*>(sm + L::kFloatOff);  // unit rows
  float* grgb = gsr + kMaxSamples;                             // unit rows x 3
  float* vec = grgb + 3 * kMaxSamples;                         // P
  float* colpart = vec + vl.P;                                 // warps x HID
  float* hvsum = colpart + kBwdWarps * HID;                    // 2 rays x HV
  float* tot = hvsum + 2 * HV;                                 // 2 rays x 4
  const uint32_t bar = smem_u32(tot + 8);                      // hs rows landed
  const uint32_t full0 = bar + 8;                              // ring slot s: + 8 s

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = tid >> 7, t = lane & 3;
  const int wrow = (warp & 3) * 16 + (lane >> 2);  // first of its two rows
  const unsigned char* hb = sm + L::kHsOff + wg * 64 * L::kHsStride;
  float* cpw = colpart + warp * HID;

  // A unit is one ray (S >= 128: S / 128 chunks) or 128 / S rays (one chunk).
  const int G = S >= kChunkRows ? 1 : kChunkRows / S;
  const int unit_chunks = G * S / kChunkRows;
  const int n_units = n_rays / G;
  const int my_units = (n_units - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  // Weight slices a chunk streams: views (HV rows), feature, then the
  // hidden rows of layers L-1 .. 1 (HID rows each), all (out x in).
  const int Q = KSV + KS * layer_num;
  const int q_total = my_units * unit_chunks * Q;

  for (int i = tid; i < vl.P; i += kBwdThreads) vec[i] = 0.f;
  for (int i = tid; i < 2 * HV; i += kBwdThreads) hvsum[i] = 0.f;
  if (tid == 0) {
    mbar_init(bar);
    for (int i = 0; i < kRingStages; ++i) mbar_init(full0 + 8 * i);
  }
  __syncthreads();
  uint32_t hs_phase = 0;

  // Ring slice q (thread 0): one bulk copy of a slot image (the host packs
  // each weight matrix as its slots' images, swizzled), landing on the
  // slot's mbarrier.
  auto load_slice = [&](int q) {
    const int qc = q % Q;
    const __nv_bfloat16* src;
    int sl;
    if (qc < KSV) {
      src = p.wvhT;
      sl = qc;
    } else {
      const int r = qc - KSV, m = r / KS;   // m = 0: feature; m: layer L - m
      src = m == 0 ? p.wfT : p.WhT[layer_num - m];
      sl = r % KS;
    }
    const int slot = q % kRingStages;
    mbar_expect(full0 + 8 * slot, L::kSlot);
    bulk_copy(ring_s + slot * L::kSlot, src + (size_t)sl * (L::kSlot / 2),
              L::kSlot, full0 + 8 * slot);
  };
  // The row buffer: thread r < 128 moves chunk row r in and out by bulk
  // copies.  Rows of a (rows, width) stash array land on bar, apart from
  // the ring's cp.async groups, so the ring never waits for them; the
  // gradient rows written over them go out the same way.
  auto load_rows = [&](const __nv_bfloat16* src, int width, size_t rg0) {
    if (tid < kChunkRows) {
      bulk_read_done();   // this row's previous store has left the buffer
      if (tid == 0) mbar_expect(bar, kChunkRows * width * 2);
      fence_async();
      bulk_copy(hs_s + tid * L::kHsStride, src + (rg0 + tid) * width, width * 2, bar);
    }
  };
  auto rows_landed = [&]() {
    mbar_wait(bar, hs_phase);
    hs_phase ^= 1;
  };
  // Element col of row r (of this warpgroup's 64) of the hs buffer.
  auto hs_at = [&](int r, int col) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        hb + r * L::kHsStride + col * 2));
  };
  // Gradient pair (row r of the warpgroup, column col) -> the row buffer,
  // over the activation pair read there.
  auto put_pair = [&](int r, int col, uint32_t v) {
    *reinterpret_cast<uint32_t*>(const_cast<unsigned char*>(hb) + r * L::kHsStride +
                                 col * 2) = v;
  };
  // The row buffer's gradient rows -> dst rows rg0 ..; after every
  // thread's put_pair, fence_async and a barrier.
  auto store_rows = [&](__nv_bfloat16* dst, int width, size_t rg0) {
    if (tid < kChunkRows)
      bulk_store(dst + (rg0 + tid) * width, hs_s + tid * L::kHsStride, width * 2);
  };
  auto rows_free = [&]() {   // the stores have read the row buffer
    if (tid < kChunkRows) bulk_read_done();
    __syncthreads();
  };
  // Fixed-order sum of the warps' column partials of column c.
  auto col_total = [&](int c, int w0, int w1) {
    float s = 0.f;
    for (int w = w0; w < w1; ++w) s += colpart[w * HID + c];
    return s;
  };

  int q = 0;   // next ring slice to consume
  if (tid == 0)
    for (int s = 0; s < kRingStages - 2 && s < q_total; ++s) load_slice(s);

  float acc[NJ * 4];
  uint32_t a[HID / 16][4];   // bf16 A fragments: 16 columns (k) a step
  // acc = A (k = NKS * kSliceK, from the registers a) times the next NKS
  // ring slices.  One wgmma batch stays in flight, so slot q - 2 is the one
  // refilled (with slice q + kRingStages - 2).  With pre >= 0 the chunk's
  // rows of hs[pre] start loading into the row buffer at slice LS, when
  // the last gradient rows have most likely left it.
  auto product = [&](auto nks_c, int pre, size_t rg0) {
    constexpr int NKS = decltype(nks_c)::value;
    constexpr int LS = NKS > 2 ? 2 : NKS - 1;
#pragma unroll
    for (int s = 0; s < NKS; ++s, ++q) {
      __syncthreads();   // batch q - 2 done everywhere: its slot is free
      if (tid == 0 && q + kRingStages - 2 < q_total) load_slice(q + kRingStages - 2);
      mbar_wait(full0 + 8 * (q % kRingStages), (q / kRingStages) & 1);
      if (s == LS && pre >= 0) load_rows(st.hs[pre], HID, rg0);
      const uint32_t slot = ring_s + (uint32_t)(q % kRingStages) * L::kSlot;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSliceK / 16; ++kk)
        wgmma_rs<HID, 1>(acc, a[s * (kSliceK / 16) + kk],
                         desc128(slot + kk * 2048, kSliceK * 128), s + kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
  };

  for (int ui = 0; ui < my_units; ++ui) {
    const int ray0 = ((int)blockIdx.x + ui * (int)gridDim.x) * G;
    for (int ch = 0; ch < unit_chunks; ++ch) {
      const size_t rg0 = (size_t)ray0 * S + ch * kChunkRows;
      const int ul0 = ch * kChunkRows + wg * 64;  // its first row in the unit
      load_rows(st.hv, HV, rg0);

      // ---- composite backward: warp r takes ray r of the unit, blocks of
      //      32 samples from the far end (reverse exclusive prefix sum of
      //      g_w * w) ----
      if (ch == 0) {
        if (warp < G) {
          const int r = warp, n = ray0 + r;
          const float g0 = g_rgb_in[n * 3 + 0], g1 = g_rgb_in[n * 3 + 1],
                      g2 = g_rgb_in[n * 3 + 2];
          const float* zr = p.z + (size_t)n * (S + 1);
          float carry = 0.f, sum_gsr = 0.f, sum_g[3] = {0.f, 0.f, 0.f};
          for (int b = S / 32 - 1; b >= 0; --b) {
            const int s = b * 32 + lane;
            const size_t rg = (size_t)n * S + s;
            const float* rec = st.rec + rg * kRecWidth;
            const float rgb[3] = {rec[0], rec[1], rec[2]};
            const float sigma_raw = rec[3], alpha = rec[4], trans = rec[5];
            const float w = alpha * trans;
            float gw = g_w_in[rg] + g0 * rgb[0] + g1 * rgb[1] + g2 * rgb[2];
            if (white_bg) gw -= g0 + g1 + g2;
            const float qv = gw * w;
            float incl = qv;  // suffix sum over lanes >= lane
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
              const float v = __shfl_down_sync(0xffffffffu, incl, o);
              if (lane + o < 32) incl += v;
            }
            const float after = carry + (incl - qv);
            carry += __shfl_sync(0xffffffffu, incl, 0);
            const float g_alpha = gw * trans - after / (1.f - alpha + 1e-10f);
            const float g_sigma = g_alpha * (1.f - alpha) * (zr[s + 1] - zr[s]);
            const float g_sr = sigma_raw > 0.f ? g_sigma : 0.f;
            gsr[r * S + s] = g_sr;
            sum_gsr += g_sr;
            const float gc[3] = {g0, g1, g2};
            float v[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              v[c] = gc[c] * w * rgb[c] * (1.f - rgb[c]);
              grgb[(r * S + s) * 3 + c] = v[c];
              sum_g[c] += v[c];
            }
            *reinterpret_cast<uint4*>(st.g_rgb + rg * kGrgbWidth) =
                make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], 0.f), 0u, 0u);
          }
          sum_gsr = warp_sum(sum_gsr);
          for (int c = 0; c < 3; ++c) sum_g[c] = warp_sum(sum_g[c]);
          if (lane == 0) {
            tot[r * 4 + 0] = sum_g[0];
            tot[r * 4 + 1] = sum_g[1];
            tot[r * 4 + 2] = sum_g[2];
            tot[r * 4 + 3] = sum_gsr;
          }
        }
        __syncthreads();
        if (tid == 0) {
          for (int r = 0; r < G; ++r) {
            for (int c = 0; c < 3; ++c) vec[vl.brgb + c] += tot[r * 4 + c];
            vec[vl.ba] += tot[r * 4 + 3];
          }
        }
      }
      __syncthreads();   // composite results visible
      rows_landed();     // hv

      // ---- g_hv = relu'(hv) * (bf16(g_rgb_t) @ bf16(wrgb)^T) ----
#pragma unroll
      for (int j0 = 0; j0 < NJV; j0 += JB) {
        float cs[2 * JB];
#pragma unroll
        for (int jj = 0; jj < JB; ++jj) {
          const int j = j0 + jj, col = 8 * j + 2 * t;
          float w[2][3];
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int c = 0; c < 3; ++c) w[e][c] = __ldg(p.wr + (col + e) * 3 + c);
          cs[2 * jj] = cs[2 * jj + 1] = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wrow + 8 * h;
            const float* gr = grgb + (ul0 + r) * 3;
            const float a0 = bf16_round(gr[0]), a1 = bf16_round(gr[1]),
                        a2 = bf16_round(gr[2]);
            const float2 hv = hs_at(r, col);
            float v0 = a0 * w[0][0] + a1 * w[0][1] + a2 * w[0][2];
            float v1 = a0 * w[1][0] + a1 * w[1][1] + a2 * w[1][2];
            if (!(hv.x > 0.f)) v0 = 0.f;
            if (!(hv.y > 0.f)) v1 = 0.f;
            cs[2 * jj] += v0;
            cs[2 * jj + 1] += v1;
            const uint32_t pk = pack_bf16(v0, v1);
            a[j >> 1][2 * (j & 1) + h] = pk;
            put_pair(r, col, pk);
          }
        }
        col_sums(cs, lane, cpw + 8 * j0);
      }
      fence_async();
      __syncthreads();
      store_rows(st.g_hv, HV, rg0);
      for (int c = tid; c < HV; c += kBwdThreads) {
        const float s0 = col_total(c, 0, 4), s1 = col_total(c, 4, 8);
        vec[vl.bv + c] += s0 + s1;
        if (G == 1) {
          hvsum[c] += s0 + s1;
        } else {
          hvsum[c] += s0;
          hvsum[HV + c] += s1;
        }
        if (ch == unit_chunks - 1) {
          for (int r = 0; r < G; ++r) {
            st.g_hvsum[(size_t)(ray0 + r) * HV + c] = __float2bfloat16(hvsum[r * HV + c]);
            hvsum[r * HV + c] = 0.f;
          }
        }
      }

      // ---- g_feature = bf16(g_hv) @ bf16(wvh)^T (no activation) ----
      product(Int<KSV>{}, -1, rg0);
      rows_free();
#pragma unroll
      for (int j0 = 0; j0 < NJ; j0 += JB) {
        float cs[2 * JB];
#pragma unroll
        for (int jj = 0; jj < JB; ++jj) {
          const int j = j0 + jj, col = 8 * j + 2 * t;
          cs[2 * jj] = cs[2 * jj + 1] = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
            cs[2 * jj] += v0;
            cs[2 * jj + 1] += v1;
            const uint32_t pk = pack_bf16(v0, v1);
            a[j >> 1][2 * (j & 1) + h] = pk;
            put_pair(wrow + 8 * h, col, pk);
          }
        }
        col_sums(cs, lane, cpw + 8 * j0);
      }
      fence_async();
      __syncthreads();
      store_rows(st.g_feat, HID, rg0);
      for (int c = tid; c < HID; c += kBwdThreads) vec[vl.bf + c] += col_total(c, 0, 8);

      // ---- g_h = bf16(g_feature) @ bf16(wf)^T + g_sigma_raw * wa ----
      product(Int<KS>{}, layer_num - 1, rg0);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[4 * j + e] += gsr[ul0 + wrow + 8 * (e >> 1)] *
                            __ldg(p.wa + 8 * j + 2 * t + (e & 1));

      // ---- trunk: g_pre_i = relu'(h_i) * g_h; g_h = bf16(g_pre_i) @ bf16(W_i)^T
      for (int i = layer_num - 1; i >= 0; --i) {
        rows_landed();   // hs[i]
        if (i == layer_num - 1) {
          // sigma head: wa gets sum over rows of h_{L-1} * g_sigma_raw,
          // read before the gradient rows overwrite h_{L-1}.
#pragma unroll
          for (int j0 = 0; j0 < NJ; j0 += JB) {
            float cs[2 * JB];
#pragma unroll
            for (int jj = 0; jj < JB; ++jj) {
              const int col = 8 * (j0 + jj) + 2 * t;
              cs[2 * jj] = cs[2 * jj + 1] = 0.f;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = wrow + 8 * h;
                const float gs = gsr[ul0 + r];
                const float2 hh = hs_at(r, col);
                cs[2 * jj] += hh.x * gs;
                cs[2 * jj + 1] += hh.y * gs;
              }
            }
            col_sums(cs, lane, cpw + 8 * j0);
          }
          __syncthreads();
          for (int c = tid; c < HID; c += kBwdThreads) vec[vl.wa + c] += col_total(c, 0, 8);
          __syncthreads();
        }
#pragma unroll
        for (int j0 = 0; j0 < NJ; j0 += JB) {
          float cs[2 * JB];
#pragma unroll
          for (int jj = 0; jj < JB; ++jj) {
            const int j = j0 + jj, col = 8 * j + 2 * t;
            cs[2 * jj] = cs[2 * jj + 1] = 0.f;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = wrow + 8 * h;
              const float2 hh = hs_at(r, col);
              const float v0 = hh.x > 0.f ? acc[4 * j + 2 * h] : 0.f;
              const float v1 = hh.y > 0.f ? acc[4 * j + 2 * h + 1] : 0.f;
              cs[2 * jj] += v0;
              cs[2 * jj + 1] += v1;
              const uint32_t pk = pack_bf16(v0, v1);
              a[j >> 1][2 * (j & 1) + h] = pk;
              put_pair(r, col, pk);
            }
          }
          col_sums(cs, lane, cpw + 8 * j0);
        }
        fence_async();
        __syncthreads();
        store_rows(st.g_pre[i], HID, rg0);
        for (int c = tid; c < HID; c += kBwdThreads) vec[i * HID + c] += col_total(c, 0, 8);
        if (i > 0) product(Int<KS>{}, i - 1, rg0);
      }
    }
  }

  if (tid < kChunkRows)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  __syncthreads();
  for (int i = tid; i < vl.P; i += kBwdThreads)
    st.vec_part[(size_t)blockIdx.x * vl.P + i] = vec[i];
}

int persistent_grid(int units, cudaError_t* e) {
  int dev = 0, sms = 0;
  if ((*e = cudaGetDevice(&dev)) != cudaSuccess) return 0;
  if ((*e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return 0;
  return units < sms ? units : sms;
}

// Persistent grid: at most one block per SM, over the units of 128 rows
// (or one ray).
template <int HID, bool kStash, int ENC>
cudaError_t launch_fwd(const TrainParams& p, const Stash& st, int n_rays,
                       int layer_num, int F, int Fd, int S, float var_scale,
                       int white_bg, float* rgb, float* w, cudaStream_t stream) {
  const size_t bytes = FwdSmem<HID>::bytes(extras_width(Fd, p.app != nullptr));
  auto kern = train_fwd_kernel<HID, kStash, ENC>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  const int grid = persistent_grid(S >= kChunkRows ? n_rays : n_rays * S / kChunkRows, &e);
  if (e != cudaSuccess) return e;
  kern<<<grid, kBwdThreads, bytes, stream>>>(p, st, layer_num, F, Fd, S, n_rays,
                                             var_scale, white_bg, rgb, w);
  return cudaGetLastError();
}

// Persistent grid: at most one block per SM and one vec_part row each (at
// most N / kTileRays); *parts gets the number of blocks, the rows the
// vector reduction sums.
template <int HID>
cudaError_t launch_bwd(const TrainParams& p, const Stash& st, int n_rays,
                       int layer_num, int S, int white_bg, const float* g_rgb,
                       const float* g_w, int* parts, cudaStream_t stream) {
  const size_t bytes = BwdSmem<HID>::bytes(VecLayout(layer_num, HID).P);
  auto kern = train_bwd_kernel<HID>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  int grid = persistent_grid(S >= kChunkRows ? n_rays : n_rays * S / kChunkRows, &e);
  if (e != cudaSuccess) return e;
  if (grid > n_rays / kTileRays) grid = n_rays / kTileRays;   // vec_part rows
  *parts = grid;
  kern<<<grid, kBwdThreads, bytes, stream>>>(p, st, layer_num, S, n_rays,
                                             white_bg, g_rgb, g_w);
  return cudaGetLastError();
}

}  // namespace

// The instantiations at one width (render_train_<HID>.cu), and the
// forward's at the wide encoding (render_train_wide_<HID>.cu).
#define NM_RENDER_TRAIN_WIDTH(H)                                               \
  cudaError_t nm_train::train_fwd_##H(                                         \
      const TrainParams& p, const Stash& st, bool stash, int n_rays,            \
      int layer_num, int F, int Fd, int S, float var_scale, int white_bg,       \
      float* rgb, float* w, cudaStream_t stream) {                              \
    return (stash ? launch_fwd<H, true, 3> : launch_fwd<H, false, 3>)(          \
        p, st, n_rays, layer_num, F, Fd, S, var_scale, white_bg, rgb, w,        \
        stream);                                                                \
  }                                                                            \
  cudaError_t nm_train::train_bwd_##H(                                         \
      const TrainParams& p, const Stash& st, int n_rays, int layer_num, int S,  \
      int white_bg, const float* g_rgb, const float* g_w, int* parts,           \
      cudaStream_t stream) {                                                    \
    return launch_bwd<H>(p, st, n_rays, layer_num, S, white_bg, g_rgb, g_w,     \
                         parts, stream);                                        \
  }
#define NM_RENDER_TRAIN_WIDE(H)                                                \
  cudaError_t nm_train::train_fwd_wide_##H(                                    \
      const TrainParams& p, const Stash& st, bool stash, int n_rays,            \
      int layer_num, int F, int Fd, int S, float var_scale, int white_bg,       \
      float* rgb, float* w, cudaStream_t stream) {                              \
    return (stash ? launch_fwd<H, true, 4> : launch_fwd<H, false, 4>)(          \
        p, st, n_rays, layer_num, F, Fd, S, var_scale, white_bg, rgb, w,        \
        stream);                                                                \
  }
