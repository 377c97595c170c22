// The fused render stage (kernels 1 and 1b) at MLP widths 512 and 1024:
// the same stage as render_eval.cuh's (its per-ray semantics, the
// early-termination rule, feat_max and app as runtime flags of the fine
// launch, the ENC = 3 / ENC = 4 encodings, every rounding order of its
// "Precision" paragraph), on an engine of its own, the tile engine (A from
// a shared-memory tile).  render_eval_{bf16,q8,wide}_512.cu and
// render_eval_{bf16,q8,wide}_1024.cu instantiate it, each in an nvcc
// process of its own; the HID 64-256 instantiations never include this
// header.  An MLP of a width from 257 to 511 runs at 512, one from 513 to
// 1023 at 1024, on zero-padded weights (render_train_kernel.py:
// pad_mlp_to_kernel_width).
//
// Why render_eval.cuh's engine stops at 256: a layer there is one wgmma
// m64nHID chain a warpgroup with A in registers.  wgmma's N is at most 256;
// at 512 the m64 f32 accumulator alone is 256 registers a thread and the
// bf16 A fragments of a 512-deep K 128 more.
//
// Design.  A persistent grid (at most one block an SM) of two warpgroups
// that share one 64-row chunk (a tile of 2 rays x a block of 32 samples,
// one wgmma m64 tile): warpgroup wg owns output columns 256 wg .. 256 wg +
// 255 of every layer (two N = 256 halves, an m64n256 chain each, a
// 128-register accumulator).  A comes from shared memory: the layer's
// input is a K-major activation tile of 64 rows x 512 (bf16, 128-byte
// swizzle, eight blocks of 64 columns; an s8 layer's input the same tile's
// first half as 64 rows x 512 s8, four blocks of 128 columns), read whole
// by both warpgroups.  After a layer's products both warpgroups
// wgmma.wait, meet at a block barrier, and write their epilogues into the
// tile in place: the next layer's input.  An s8 epilogue writes its bytes
// straight into the K-major tile, so the s8 images this engine streams keep
// their K rows in order (no quant.py: PERM32, which only an A taken from
// accumulator registers needs).  The sigma head's 512-long dot product and
// the rgb head's 256-long one are summed per warpgroup, then the two halves
// in a fixed order (warpgroup 0's + warpgroup 1's) by the compositing
// warps.  The weight ring, its slot images and its protocol are
// render_eval.cuh's (32 bf16 rows or 64 s8 rows x 512 columns a slot, one
// bulk copy each; a warpgroup reads its 256 columns of a slot, at a byte
// offset).  Compositing runs on warpgroup 0's four warps as in
// render_eval.cuh.
//
// The fine stage's descriptor needs the tap layer's activations once the
// chunk's weights are known.  At 512 neither render_eval.cuh's way (its A
// kept in shared memory, the tap layer run again) nor a kept f32 tile fits
// beside the ring: the tap layer's input is 64 KB bf16 and would leave two
// 32 KB ring slots, and running the layer again streams its 512 KB of
// weights a chunk once more.  So each thread writes its 128 tap values
// (f32, relu(acc + b), or (max(y, 0.5) - 0.5) iq, or relu(y) for an s8 last
// layer) to a per-block global scratch in the tap layer's epilogue (128 KB
// a block, 17 MB for 132 blocks: L2-resident), and reads its own values
// back after compositing (the same thread, no barrier): the bits of the
// first pass, 256 KB of L2 traffic a chunk against the 512 KB of weights
// a second pass would stream.  The reduction over the rows is
// render_eval.cuh's (a warp's partials row, the two warps of a ray summed
// in order at the tile's end).
//
// Shared memory (bytes; Fd = 4 adds 2 x 27 f32 of dirs PE; kExtraMax's
// 128 columns 1024):
//   ring           kRing x 32,768  (bf16: 4 slots; int8: 4 coarse, 3 fine)
//   activation     65,536          (64 rows x 512 bf16, or x 512 s8 in its
//                                   first 32,768)
//   encoding       16,384          (64 rows x 128 bf16)
//   xq (int8)       8,192          (64 rows x 128 s8)
//   f32 rows        3,008 coarse, 15,296 fine (row info 64 x 8, sigma
//                   partials 2 x 64, weights 64, warp segments 4 x 8, ray
//                   state 2 x 8; fine: rgb partials 2 x 64 x 4, xt 2 x 256,
//                   descriptor partials 4 x 512)
//   control, mbarriers, dirs PE, 1024 of alignment slack
// Totals at Fd = 4: bf16 coarse 217,288, fine 229,576; int8 coarse
// 225,480, fine 205,000; at 128 dirs columns 808 more (of the 232,448 a
// block may take).
//
// What bounds it: the products, ~4.8 MFLOP a sample (four times HID 256's),
// and the weights each chunk streams from L2: a 64-row chunk reads every
// weight once for 64 rows (HID 256's block reads them for 128), 64 FLOP a
// byte, which 132 SMs at the tensor rate would need some 15 TB/s of L2 for.
// A simple engine that is right first (PERF.md has its times).
//
// HID 1024: NP = 2 passes a layer.  A warpgroup's accumulator cannot grow
// (m64n256 is 128 registers; two warpgroups at 255 registers fill the SM's
// register file), so each layer runs twice over the same input tile,
// warpgroup wg computing columns 512 p + 256 wg .. + 255 in pass p: the ring
// streams every image slice of the layer once a pass, the pass's half of
// its columns (32 KB, contiguous in the slot images of both trunks).  The
// input tile is 64 rows x 1024 bf16 (128 KB) and must stay whole until
// the last pass's products retire, so pass 0's outputs have no room in
// shared memory: each thread parks its 64 packed values (bf16 pairs, or
// s8 pairs) in the block's global scratch (64 KB a block, L2-resident) and
// reads its own values back into the tile after the last pass's barrier.
// The views layer (512 outputs) is one pass.  The fine stage's tap values
// (64 x 1024 f32) and the descriptor partials (4 x 1024 f32) sit in the
// same scratch; the ring keeps 2 slots of 32 KB, so each slice's copy
// from L2 is waited for with one batch of products in flight (PERF.md:
// 15-23% of the bound).  The passes are a loop, not unrolled (one trip at
// 512, where the compiler folds it: the 512 code is unchanged), and so
// are the slices of a 1024-row product.  Shared memory at 1024, Fd = 4:
// bf16 coarse 217,272, fine 223,416; int8 coarse 225,464, fine 231,608
// (at 128 dirs columns 808 more: 232,416 of the 232,448).  -Xptxas -v
// (sm_90a, CUDA 12.8): bf16 194-255 registers, no spills; int8 255 with
// 408-448 bytes of spill stores.

#pragma once

#include "render_eval.cuh"

namespace {

template <int HID_, bool FINE, bool Q8>
struct EvalSmemTile {
  static constexpr int HID = HID_, HV = HID / 2;
  static constexpr int NP = HID / 512;   // N passes a layer
  static constexpr int HP = HID / NP;    // a pass's columns: 512
  static constexpr int kRing = NP > 1 ? 2 : FINE && Q8 ? 3 : 4;
  static constexpr int kSlot = (HP / 64) * kSliceK * 128;    // 32 KB
  static constexpr int kVSlot = (HV / 64) * kSliceK * 128;   // 16 KB (32 KB at 1024)
  static constexpr int kBlock = 64 * 128;                     // 64 rows x 128 B
  static constexpr int kXOff = kRing * kSlot;
  static constexpr int kEncOff = kXOff + (HID / 64) * kBlock;
  static constexpr int kXqOff = kEncOff + 2 * kBlock;
  static constexpr int kFloatOff = kXqOff + (Q8 ? kBlock : 0);
  static constexpr int kInfo = 0, kSig = kInfo + kWgRows * 8, kWts = kSig + 2 * kWgRows,
                       kSeg = kWts + kWgRows, kRay = kSeg + 4 * 8,
                       kRgb = kRay + kTileRays * 8,
                       kXt = kRgb + (FINE ? 2 * kWgRows * 4 : 0),
                       kFacc = kXt + (FINE ? kTileRays * HV : 0),
                       kFloats = kFacc + (FINE && NP == 1 ? 4 * HID : 0);
  static constexpr int kCtlOff = kFloatOff + kFloats * 4;   // tile, block
  static constexpr int kBarOff = kCtlOff + 16;
  // Last, sized at launch: the dirs PE of the tile's rays (2 x dirs_dim f32).
  static constexpr int kDirsOff = (kBarOff + 8 * kRing + 15) / 16 * 16;
  __host__ __device__ static constexpr size_t bytes(int dirs_dim) {
    return 1024 + kDirsOff + (size_t)kTileRays * dirs_dim * 4;
  }
};

// The scratch of one block (nm_eval::tile_scratch_bytes), in floats: the
// fine stage's tap values (64 rows x HID f32, a thread's 128 a pass), at
// 1024 the descriptor partials (4 x HID) and the parked pass (64 x 256).
template <int HID, bool FINE>
constexpr int kScratchFloats = (int)(nm_eval::tile_scratch_bytes(HID, FINE) / sizeof(float));
static_assert(kScratchFloats<512, true> == kWgRows * 512, "the tap scratch of a chunk");
static_assert(kScratchFloats<1024, false> == kWgRows * 256, "a parked pass");

// kDbg as render_eval_kernel's (dbg: the tap layer's activations written in
// the epilogue, then those read back for the descriptor; dbgq the integer
// activations).
template <int HID_, bool FINE, bool kDbg, bool Q8, int ENC>
__global__ void __launch_bounds__(kEvalThreads, 1)
render_eval_tile_kernel(EvalParams p, QuantParams qp, int layer_num, int feat_layer,
                      int int8_from, int F, int Fd, int S, int n_tiles,
                      float var_scale, float log_eps, int white_bg, int feat_max,
                      int* __restrict__ tile_counter, float* __restrict__ tap_scratch,
                      float* __restrict__ out_w, float* __restrict__ out_depth,
                      float* __restrict__ out_acc, float* __restrict__ out_rgb,
                      float* __restrict__ out_feat, float* __restrict__ out_pts,
                      float* __restrict__ dbg, int8_t* __restrict__ dbgq) {
  using L = EvalSmemTile<HID_, FINE, Q8>;
  using Acc = typename std::conditional<Q8, uint32_t, float>::type;
  constexpr int HID = L::HID, HV = L::HV, R = L::kRing;
  constexpr int NP = L::NP, HP = L::HP;
  constexpr int HW = HP / 2;           // a warpgroup's output columns a pass
  constexpr int NJ = HW / 8;           // its n8 column groups
  constexpr int NJV = HV / 2 / 8;      // the same of the views product
  constexpr int KS = HID / kSliceK;    // bf16 slices of a HID-row product
  constexpr int KS8 = HID / kSliceK8;  // s8 slices
  constexpr int ENC8 = 2;              // s8 slices of the encoding rows
  static_assert(HP * kSliceK8 == L::kSlot, "an s8 slice fills a bf16 slot");
  static_assert(L::bytes(kExtraMax) <= 232448, "render_eval_512 shared memory");
  static_assert(NP == 1 || L::kVSlot == L::kSlot, "a views slice fills a slot");
  static_assert(!kDbg || FINE || Q8, "the tap exists in the fine stage only");
  static_assert(ENC == 3 || ENC == 4, "96 or 128 encoding rows");

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = tid >> 7, lt = tid & 127, wl = warp & 3, t = lane & 3;
  const int wrow = wl * 16 + (lane >> 2);   // first of this thread's two rows
  const int c0 = wg * HW;                   // this warpgroup's first column (pass 0)
  const uint32_t ring_s = base, full0 = base + L::kBarOff;
  const uint32_t x_w = base + L::kXOff, enc_w = base + L::kEncOff;
  const uint32_t xq_w = base + L::kXqOff;
  unsigned char* x_p = sm + L::kXOff;
  unsigned char* enc_p = sm + L::kEncOff;
  unsigned char* xq_p = sm + L::kXqOff;
  float* fw = reinterpret_cast<float*>(sm + L::kFloatOff);
  float* info = fw + L::kInfo;
  float* sigp = fw + L::kSig;   // [wg][row]: sigma partials
  float* wts = fw + L::kWts;
  float* seg = fw + L::kSeg;    // as render_eval.cuh's (feat_max: slot 7)
  float* ray_s = fw + L::kRay;
  float* rgbp = fw + L::kRgb;   // [wg][row][4]: rgb head partials
  float* xt = fw + L::kXt;
  float* const scr = tap_scratch + (size_t)blockIdx.x * kScratchFloats<HID, FINE>;
  // [warp of a warpgroup][HID]: in the scratch at 1024
  float* facc = NP == 1 ? fw + L::kFacc : scr + kWgRows * HID;
  int* ctl = reinterpret_cast<int*>(sm + L::kCtlOff);
  // This thread's tap values: element e (its accumulator's) of pass P at
  // tap[256 (128 P + e)].
  float* tap = scr + tid;
  // This thread's parked values of pass 0 (NP = 2): pair (j, h) at
  // park[256 (2 j + h)].
  uint32_t* park = reinterpret_cast<uint32_t*>(scr + (FINE ? (kWgRows + 4) * HID : 0)) + tid;

  const int enc_dim = 6 * F, dirs_dim = 6 * Fd + 3;
  float* dpe = reinterpret_cast<float*>(sm + L::kDirsOff);
  const int n_blocks = S / kSampleBlock;
  const size_t n_rows = (size_t)n_tiles * kTileRays * S;
  const int q_from = Q8 ? int8_from : layer_num;
  const float* wa_t = p.wa + c0 + 2 * t;   // + P HP in pass P

  // Slices a step streams, in the images' order: the trunk (per bf16 layer
  // its encoding rows, then its hidden rows; per s8 layer its hidden rows,
  // then its encoding rows), then for the fine stage the feature and the
  // views layers.  All but the views slices fill a whole slot.
  auto n_slices = [&](int i) {
    const bool enc = p.Wenc[i] != nullptr;
    return i >= q_from ? (enc ? ENC8 : 0) + (i > 0 ? KS8 : 0)
                       : (enc ? ENC : 0) + (i > 0 ? KS : 0);
  };
  int Qt = 0;
  for (int i = 0; i < layer_num; ++i) Qt += n_slices(i);
  // Each trunk and feature slice streams once a pass.
  const int Q = FINE ? NP * Qt + (NP + 1) * KS : NP * Qt;

  // The encoding tile's padding columns (enc_dim .. kEncMax - 1) stay zero.
  for (int i = tid; i < kWgRows * (kEncMax - enc_dim); i += kEvalThreads) {
    const int row = i / (kEncMax - enc_dim), k = enc_dim + i % (kEncMax - enc_dim);
    *reinterpret_cast<__nv_bfloat16*>(enc_p + (k >> 6) * L::kBlock + swz(row, (k & 63) >> 3) +
                                      (k & 7) * 2) = __float2bfloat16(0.f);
    if (Q8) xq_p[swz(row, k >> 4) + (k & 15)] = 0;
  }
  if (tid == 0) {
    for (int i = 0; i < R; ++i) mbar_init(full0 + 8 * i);
    ctl[0] = -1;   // no tile yet
    ctl[1] = 0;
  }
  fence_async();
  __syncthreads();

  auto load_slice = [&](int q) {
    const int qc = q % Q;
    uint32_t bytes = L::kSlot;
    size_t off = (size_t)qc * L::kSlot;
    if constexpr (NP == 1) {
      if (FINE && qc >= Qt + KS) {
        bytes = L::kVSlot;
        off = (size_t)(Qt + KS) * L::kSlot + (size_t)(qc - Qt - KS) * L::kVSlot;
      }
    } else {
      // Per trunk layer (then the feature layer) its n image slices once
      // a pass, pass P reading the P-th kSlot of each (an image slice holds
      // NP of them); then the views layer's slices, a slot each (n = 0).
      int r = qc, n = 0;
      size_t at = 0;
      for (int i = 0; i < layer_num + (FINE ? 1 : 0); ++i) {
        const int m = i < layer_num ? n_slices(i) : KS;
        if (r < NP * m) {
          n = m;
          break;
        }
        r -= NP * m;
        at += (size_t)m * NP * L::kSlot;
      }
      off = n == 0 ? at + (size_t)r * L::kSlot
                   : at + (size_t)(r % n) * NP * L::kSlot + (size_t)(r / n) * L::kSlot;
    }
    const int slot = q % R;
    mbar_expect(full0 + 8 * slot, bytes);
    bulk_copy(ring_s + slot * L::kSlot, p.W + off, bytes, full0 + 8 * slot);
  };
  int q = 0;   // next ring slice to consume
  if (tid == 0)
    for (int s = 0; s < R - 2; ++s) load_slice(s);

  Acc acc[NJ * 4];
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
  // The k16 step ks of a K-major bf16 tile of 64-column blocks (the
  // encoding or the activation tile), and the k32 step of an s8 one.
  auto a16 = [&](uint32_t tile, int ks) {
    return desc128(tile + (ks >> 2) * L::kBlock + (ks & 3) * 32, 16);
  };
  // acc = the next NE encoding slices (A: the encoding tile) + the next NH
  // hidden slices (A: the activation tile), this warpgroup's N columns
  // (its N / 64 blocks of each slot), bf16.
  auto product = [&](auto ne_c, auto nh_c, auto n_c) {
    constexpr int NE = decltype(ne_c)::value, NH = decltype(nh_c)::value;
    constexpr int N = decltype(n_c)::value;
    constexpr int KK = kSliceK / 16;   // k16 steps a slice
    const uint32_t boff = (uint32_t)wg * (N / 64) * (kSliceK * 128);
#pragma unroll
    for (int s = 0; s < NE; ++s) {
      const uint32_t slot = begin() + boff;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
        wgmma_ss<N, 0>(acc, a16(enc_w, s * KK + kk), desc128(slot + kk * 2048, kSliceK * 128),
                       s * KK + kk > 0);
      end();
    }
    if constexpr (NP == 1) {
#pragma unroll
      for (int s = 0; s < NH; ++s) {
        const uint32_t slot = begin() + boff;
#pragma unroll
        for (int kk = 0; kk < KK; ++kk)
          wgmma_ss<N, 0>(acc, a16(x_w, s * KK + kk), desc128(slot + kk * 2048, kSliceK * 128),
                         NE + s + kk > 0);
        end();
      }
    } else {   // 1024: a loop (unrolled, its 32 slices double 512's code)
#pragma unroll 2
      for (int s = 0; s < NH; ++s) {
        const uint32_t slot = begin() + boff;
#pragma unroll
        for (int kk = 0; kk < KK; ++kk)
          wgmma_ss<N, 0>(acc, a16(x_w, s * KK + kk), desc128(slot + kk * 2048, kSliceK * 128),
                         NE + s + kk > 0);
        end();
      }
    }
    wgmma_wait<0>();
  };
  // The same for s8 (Q8): acc (s32) = the next NH hidden slices (A: the
  // activation tile's s8 view) + the next NE encoding slices (A: xq; k32
  // steps 0-1, then 2 (and 3 with ENC = 4)), this warpgroup's 256 columns.
  auto product8 = [&](auto ne_c, auto nh_c) {
    constexpr int NE = decltype(ne_c)::value, NH = decltype(nh_c)::value;
    const uint32_t boff = (uint32_t)wg * HW * kSliceK8;
    if constexpr (NP == 1) {
      static_for<0, NH>([&](auto s_c) {
        constexpr int s = decltype(s_c)::value;
        const uint32_t slot = begin() + boff;
        wgmma_ss8<HW, s == 0>(acc, a16(x_w, 2 * s), desc64(slot), 1);
        wgmma_ss8<HW>(acc, a16(x_w, 2 * s + 1), desc64(slot + 32), 1);
        end();
      });
    } else if constexpr (NH > 0) {
      // 1024: slice 0 starts the chain, the others a loop (unrolled, the
      // int8 layer around it was compiled as a call with its accumulator
      // on the stack: the stage ran 2.3x slower than plain).
      // (The kInit arguments name NH so that these calls, like the
      // static_for ones, are checked only where the int8 trunk calls them.)
      uint32_t slot = begin() + boff;
      wgmma_ss8<HW, NH != 0>(acc, a16(x_w, 0), desc64(slot), 1);
      wgmma_ss8<HW, NH == 0>(acc, a16(x_w, 1), desc64(slot + 32), 1);
      end();
#pragma unroll 1
      for (int s = 1; s < NH; ++s) {
        slot = begin() + boff;
        wgmma_ss8<HW, NH == 0>(acc, a16(x_w, 2 * s), desc64(slot), 1);
        wgmma_ss8<HW, NH == 0>(acc, a16(x_w, 2 * s + 1), desc64(slot + 32), 1);
        end();
      }
    }
    static_for<0, NE>([&](auto s_c) {
      constexpr int s = decltype(s_c)::value;
      const uint32_t slot = begin() + boff;
      wgmma_ss8<HW, NH + s == 0>(acc, desc128(xq_w + 64 * s, 16), desc64(slot), 1);
      if constexpr (s == 0 || ENC > 3)
        wgmma_ss8<HW>(acc, desc128(xq_w + 64 * s + 32, 16), desc64(slot + 32), 1);
      end();
    });
    wgmma_wait<0>();
  };
  auto layer_product = [&](int i) {
    if (i == 0)
      product(Int<ENC>{}, Int<0>{}, Int<HW>{});
    else if (p.Wenc[i] != nullptr)
      product(Int<ENC>{}, Int<KS>{}, Int<HW>{});
    else
      product(Int<0>{}, Int<KS>{}, Int<HW>{});
  };
  // Columns c, c + 1 of row r into the activation tile: bf16 (64 columns a
  // block) or s8 (128; saturated to [-128, 127]).
  auto put_x16 = [&](int r, int c, uint32_t v) {
    *reinterpret_cast<uint32_t*>(x_p + (c >> 6) * L::kBlock + swz(r, (c & 63) >> 3) +
                                 (c & 7) * 2) = v;
  };
  auto put_x8 = [&](int r, int c, int v0, int v1) {
    *reinterpret_cast<uint16_t*>(x_p + (c >> 7) * L::kBlock + swz(r, (c & 127) >> 4) +
                                 (c & 15)) = (uint16_t)(pack_s8(v0, v1, 0, 0) & 0xffffu);
  };
  // Pass P's outputs of column pair (j, h) (row wrow + 8 h, columns P HP +
  // c0 + 8 j + 2 t, + 1): into the tile in the last pass, else parked.
  auto out16 = [&](int P, int j, int h, uint32_t v) {
    if (P + 1 < NP)
      park[(2 * j + h) * kEvalThreads] = v;
    else
      put_x16(wrow + 8 * h, P * HP + c0 + 8 * j + 2 * t, v);
  };
  auto out8 = [&](int P, int j, int h, int v0, int v1) {
    if (P + 1 < NP)
      park[(2 * j + h) * kEvalThreads] = pack_s8(v0, v1, 0, 0) & 0xffffu;
    else
      put_x8(wrow + 8 * h, P * HP + c0 + 8 * j + 2 * t, v0, v1);
  };
  // The parked pass into the tile (after the last pass's barrier): bf16
  // pairs, or s8 pairs.
  auto unpark = [&](bool s8) {
    if constexpr (NP > 1) {
#pragma unroll 8
      for (int k = 0; k < 2 * NJ; ++k) {
        const uint32_t v = park[k * kEvalThreads];
        const int r = wrow + 8 * (k & 1), c = c0 + 8 * (k >> 1) + 2 * t;
        if (s8)
          *reinterpret_cast<uint16_t*>(x_p + (c >> 7) * L::kBlock + swz(r, (c & 127) >> 4) +
                                       (c & 15)) = (uint16_t)v;
        else
          put_x16(r, c, v);
      }
    }
  };
  int tile = -1, sb = 0;
  auto grow = [&](int row) {
    return (size_t)(tile * kTileRays + row / kSampleBlock) * S + sb * kSampleBlock +
           row % kSampleBlock;
  };
  auto put_dbg = [&](int which, int row, int col, float v0, float v1) {
    if (dbg != nullptr)
      *reinterpret_cast<float2*>(dbg + (which * n_rows + grow(row)) * HID + col) =
          make_float2(v0, v1);
  };
  auto put_dbgq = [&](int row, int k, int v) {
    if (dbgq != nullptr) dbgq[grow(row) * (kEncMax + HID) + k] = (int8_t)v;
  };
  // The tap layer's values of pass P's accumulator elements 4 j + 2 h, + 1
  // (row wrow + 8 h, columns P HP + c0 + 8 j + 2 t, + 1), kept for the
  // descriptor.
  auto keep_tap = [&](int i, int P, int j, int h, float v0, float v1) {
    if (FINE && i == feat_layer) {
      tap[(4 * NJ * P + 4 * j + 2 * h) * kEvalThreads] = v0;
      tap[(4 * NJ * P + 4 * j + 2 * h + 1) * kEvalThreads] = v1;
      if (kDbg) put_dbg(0, wrow + 8 * h, P * HP + c0 + 8 * j + 2 * t, v0, v1);
    }
  };
  // Before column group j of an int8 trunk's epilogue, every 8 groups: a
  // point the compiler does not move loads across (render_eval.cuh).
  auto fence8 = [&](int j) {
    if (Q8 && j > 0 && (j & 7) == 0) __syncwarp();
  };
  // s8 layer i (Q8): its products, then acc <- the f32 bits of
  // y = acc * c (+ acc_s * c_s) + B, in the JAX epilogue's order, unfused;
  // the post-skip layer's encoding rows into a second accumulator, 64
  // columns at a time (render_eval.cuh's q8_layer).
  auto q8_layer = [&](int i, int P) {
    if constexpr (Q8) {
      const float* c_t = qp.scale[i] + P * HP + c0 + 2 * t;
      const float* b_t = qp.bias[i] + P * HP + c0 + 2 * t;
      const auto i2f = [](uint32_t v) { return __int2float_rn((int)v); };
      if (i == 0)
        product8(Int<ENC8>{}, Int<0>{});
      else
        product8(Int<0>{}, Int<KS8>{});
      if (i > 0 && p.Wenc[i] != nullptr) {
        const float* cs_t = qp.scale_s[i] + P * HP + c0 + 2 * t;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          fence8(j);
          const float2 c = row2(c_t + 8 * j);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[4 * j + e] = __float_as_uint(__fmul_rn(i2f(acc[4 * j + e]), e & 1 ? c.y : c.x));
        }
        const uint32_t boff = (uint32_t)wg * HW * kSliceK8;
        const uint32_t e0 = begin() + boff;
        ++q;
        const uint32_t e1 = begin() + boff;
#pragma unroll
        for (int nb = 0; nb < HW / 64; ++nb) {
          uint32_t accs[32];
          if (nb > 0) wgmma_fence();
          wgmma_ss8<64, true>(accs, desc128(xq_w, 16), desc64(e0 + nb * 4096), 0);
          wgmma_ss8<64>(accs, desc128(xq_w + 32, 16), desc64(e0 + nb * 4096 + 32), 1);
          wgmma_ss8<64>(accs, desc128(xq_w + 64, 16), desc64(e1 + nb * 4096), 1);
          if constexpr (ENC > 3)
            wgmma_ss8<64>(accs, desc128(xq_w + 96, 16), desc64(e1 + nb * 4096 + 32), 1);
          wgmma_commit();
          wgmma_wait<0>();
          __syncwarp();
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

  for (;;) {
    // ---- the block's chunk: finish a tile that is done or dead (its
    //      outputs, zero weights for its skipped blocks), take the next ----
    __syncthreads();   // the last step's ray state, partials and block index
    tile = ctl[0];
    sb = tile >= 0 ? ctl[1] : 0;
    if (tile >= 0 && (sb == n_blocks ||
                      (sb > 0 && ray_s[0] < log_eps && ray_s[8] < log_eps))) {
      const int ray0 = tile * kTileRays, nb = S - sb * kSampleBlock;
      for (int i = tid; i < kTileRays * nb; i += kEvalThreads)
        out_w[(size_t)(ray0 + i / nb) * S + sb * kSampleBlock + i % nb] = 0.f;
      if (tid < kTileRays) {
        const int n = ray0 + tid;
        const float* rs = ray_s + tid * 8;
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
        for (int i = tid; i < kTileRays * HID; i += kEvalThreads) {
          const int r = i / HID, c = i % HID;
          out_feat[(size_t)ray0 * HID + i] = facc[2 * r * HID + c] + facc[(2 * r + 1) * HID + c];
        }
      tile = -1;
    }
    if (tile == -1) {
      __syncthreads();   // the tile's state is read
      if (tid == 0) {
        const int next = atomicAdd(tile_counter, 1);
        ctl[0] = next < n_tiles ? next : -2;
        ctl[1] = 0;
      }
      __syncthreads();
      tile = ctl[0];
      sb = 0;
      if (tile < 0) break;
      const int ray0 = tile * kTileRays;
      // Slot 7, feat_max's largest weight, starts below any weight.
      if (tid < kTileRays * 8) ray_s[tid] = (tid & 7) == 7 ? -1.f : 0.f;
      if (FINE) {
        for (int i = tid; i < 4 * HID; i += kEvalThreads) facc[i] = 0.f;
        // View-direction PE per ray: [sin(2^f d) | sin(2^f d + pi/2) | d].
        for (int i = tid; i < kTileRays * dirs_dim; i += kEvalThreads) {
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
        __syncthreads();
        // Per-ray view contribution of the views layer: dirs_pe @ wvd
        // (+ app @ wva), f32.
        for (int i = tid; i < kTileRays * HV; i += kEvalThreads) {
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
    const int ray0 = tile * kTileRays;

    // ---- per-row frustum moments -> Gaussian mean / variance ----
    if (tid < kWgRows) {
      const int n = ray0 + tid / kSampleBlock, s = sb * kSampleBlock + tid % kSampleBlock;
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
      float* in = info + tid * 8;
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
    __syncthreads();
    // ---- integrated positional encoding (f32, rounded to bf16) into the
    //      encoding tile: [sin block | cos block]; Q8: also quantized from
    //      the f32 values into xq ----
    for (int i = tid; i < kWgRows * 3 * F; i += kEvalThreads) {
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
          *reinterpret_cast<__nv_bfloat16*>(enc_p + (k >> 6) * L::kBlock +
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
          if (kDbg) put_dbgq(row, k, xq);
        }
      }
    }
    fence_async();   // the encoding tile, for wgmma

    // ---- trunk: acc = [enc @ Wenc_i] + [h @ Wh_i]; h = relu(acc + b)
    //      (bf16), or the s8 epilogue; each epilogue in place, after both
    //      warpgroups' products have read the activation tile ----
    float sp[2] = {0.f, 0.f};   // sigma head partials of its two rows
    if constexpr (!Q8) {
      for (int i = 0; i < layer_num; ++i) {
        const bool last = i == layer_num - 1;
#pragma unroll 1   // N passes: one at 512, a loop at 1024
        for (int P = 0; P < NP; ++P) {
          layer_product(i);
          if (P + 1 == NP) __syncthreads();   // the input tile is read
          const float* b_t = p.b[i] + P * HP + c0 + 2 * t;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float b0 = __ldg(b_t + 8 * j), b1 = __ldg(b_t + 8 * j + 1);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float v0 = fmaxf(acc[4 * j + 2 * h] + b0, 0.f);
              const float v1 = fmaxf(acc[4 * j + 2 * h + 1] + b1, 0.f);
              if (FINE || !last) out16(P, j, h, pack_bf16(v0, v1));
              if (last)
                sp[h] = fmaf(v0, __ldg(wa_t + P * HP + 8 * j),
                             fmaf(v1, __ldg(wa_t + P * HP + 8 * j + 1), sp[h]));
              keep_tap(i, P, j, h, v0, v1);
            }
          }
        }
        if (FINE || !last) unpark(false);
        fence_async();
      }
    } else {
      // The bf16 layers below int8_from; the last of them requantizes its
      // output for the s8 trunk (round half even, qh).
      for (int i = 0; i < q_from; ++i) {
#pragma unroll 1   // N passes: one at 512, a loop at 1024
        for (int P = 0; P < NP; ++P) {
          layer_product(i);
          if (P + 1 == NP) __syncthreads();
          const float* b_t = p.b[i] + P * HP + c0 + 2 * t;
          if (i < q_from - 1) {
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              fence8(j);
              const float2 b = row2(b_t + 8 * j);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float v0 = fmaxf(f32(acc[4 * j + 2 * h]) + b.x, 0.f);
                const float v1 = fmaxf(f32(acc[4 * j + 2 * h + 1]) + b.y, 0.f);
                out16(P, j, h, pack_bf16(v0, v1));
                keep_tap(i, P, j, h, v0, v1);
              }
            }
          } else {   // into the s8 trunk: round half even (v >= 0)
            const float* qh_t = qp.qh + P * HP + c0 + 2 * t;
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              fence8(j);
              const float2 b = row2(b_t + 8 * j), qh = row2(qh_t + 8 * j);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float v0 = fmaxf(f32(acc[4 * j + 2 * h]) + b.x, 0.f);
                const float v1 = fmaxf(f32(acc[4 * j + 2 * h + 1]) + b.y, 0.f);
                const int q0 = __float2int_rn(__fmul_rn(v0, qh.x));
                const int q1 = __float2int_rn(__fmul_rn(v1, qh.y));
                const int col = P * HP + c0 + 8 * j + 2 * t;
                out8(P, j, h, q0, q1);
                if (kDbg && i == layer_num - 2) {
                  put_dbgq(wrow + 8 * h, kEncMax + col, min(q0, 127));
                  put_dbgq(wrow + 8 * h, kEncMax + col + 1, min(q1, 127));
                }
                keep_tap(i, P, j, h, v0, v1);
              }
            }
          }
        }
        unpark(i == q_from - 1);
        fence_async();
      }
      // The s8 hidden layers: max(y, 0.5) is the ReLU, the +0.5 in B turns
      // the truncating cast into round to nearest.
      for (int i = q_from; i < layer_num - 1; ++i) {
#pragma unroll 1   // N passes: one at 512, a loop at 1024
        for (int P = 0; P < NP; ++P) {
          q8_layer(i, P);
          if (P + 1 == NP) __syncthreads();
          const float* iq_t =
              FINE && i == feat_layer ? qp.iq + P * HP + c0 + 2 * t : nullptr;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float y0 = fmaxf(f32(acc[4 * j + 2 * h]), 0.5f);
              const float y1 = fmaxf(f32(acc[4 * j + 2 * h + 1]), 0.5f);
              const int q0 = __float2int_rz(y0), q1 = __float2int_rz(y1);
              const int col = P * HP + c0 + 8 * j + 2 * t;
              out8(P, j, h, q0, q1);
              if (kDbg && i == layer_num - 2) {
                put_dbgq(wrow + 8 * h, kEncMax + col, min(q0, 127));
                put_dbgq(wrow + 8 * h, kEncMax + col + 1, min(q1, 127));
              }
              if (FINE && i == feat_layer) {
                const float2 iq = row2(iq_t + 8 * j);
                keep_tap(i, P, j, h, __fmul_rn(__fsub_rn(y0, 0.5f), iq.x),
                         __fmul_rn(__fsub_rn(y1, 0.5f), iq.y));
              }
            }
          }
        }
        unpark(true);
        fence_async();
      }
      // The last layer in real units: relu(acc * s (+ acc_s * s_s) + b),
      // rounded to bf16 for the feature head.
      {
        const int i = layer_num - 1;
#pragma unroll 1   // N passes: one at 512, a loop at 1024
        for (int P = 0; P < NP; ++P) {
          q8_layer(i, P);
          if (P + 1 == NP) __syncthreads();
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            fence8(j);
            const float2 wa = row2(wa_t + P * HP + 8 * j);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float v0 = fmaxf(f32(acc[4 * j + 2 * h]), 0.f);
              const float v1 = fmaxf(f32(acc[4 * j + 2 * h + 1]), 0.f);
              if (FINE) out16(P, j, h, pack_bf16(v0, v1));
              sp[h] = fmaf(v0, wa.x, fmaf(v1, wa.y, sp[h]));
              keep_tap(i, P, j, h, v0, v1);
            }
          }
        }
        if (FINE) unpark(false);
        fence_async();
      }
    }
    // ---- sigma partials: this warpgroup's columns of h . wa ----
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = sp[h];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (t == 0) sigp[wg * kWgRows + wrow + 8 * h] = s;
    }

    if (FINE) {
      // ---- feature = bf16(h) @ wf + bf (no activation), rounded to bf16,
      //      in place ----
#pragma unroll 1   // N passes: one at 512, a loop at 1024
      for (int P = 0; P < NP; ++P) {
        product(Int<0>{}, Int<KS>{}, Int<HW>{});
        if (P + 1 == NP) __syncthreads();
        const float* bf_t = p.bf + P * HP + c0 + 2 * t;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float b0 = __ldg(bf_t + 8 * j), b1 = __ldg(bf_t + 8 * j + 1);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            out16(P, j, h,
                  pack_bf16(f32(acc[4 * j + 2 * h]) + b0, f32(acc[4 * j + 2 * h + 1]) + b1));
        }
      }
      unpark(false);
      fence_async();
      // ---- views = relu(feature @ wvh + dirs_pe @ wvd + bv), rounded to
      //      bf16 (this warpgroup's 128 columns); the rgb head's partials
      //      over them, f32 FMA ----
      product(Int<0>{}, Int<KS>{}, Int<HV / 2>{});
      {
        const int v0c = wg * (HV / 2);
        const float* x = xt + (wl >> 1) * HV;   // the ray of the warp's rows
        float pr[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
        for (int j = 0; j < NJV; ++j) {
          const int col = v0c + 8 * j + 2 * t;
          const float xa = x[col], xb = x[col + 1];
          const float b0 = __ldg(p.bv + col), b1 = __ldg(p.bv + col + 1);
          float wr[2][3];
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int c = 0; c < 3; ++c) wr[e][c] = __ldg(p.wr + 3 * (col + e) + c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v0 = fmaxf(f32(acc[4 * j + 2 * h]) + xa + b0, 0.f);
            const float v1 = fmaxf(f32(acc[4 * j + 2 * h + 1]) + xb + b1, 0.f);
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
            if (t == 0) rgbp[(wg * kWgRows + wrow + 8 * h) * 4 + c] = s;
          }
      }
    }

    // ---- compositing on warpgroup 0: warp w takes rows 16 w .. (ray
    //      w / 2), one row a lane of each half (the halves compute the
    //      same); sigma and rgb from the two warpgroups' partials ----
    __syncthreads();   // the partials of every row
    if (wg == 0) {
      const int row = wl * 16 + (lane & 15), r = wl >> 1;
      const int n = ray0 + r, s = sb * kSampleBlock + (row & (kSampleBlock - 1));
      const float* zr = p.z + (size_t)n * (S + 1);
      const float dist = zr[s + 1] - zr[s];
      const float sigma = sigp[row] + sigp[kWgRows + row] + __ldg(p.ba);
      const float alpha = 1.f - expf(-fmaxf(sigma, 0.f) * dist);
      const float lt_ = logf(1.f - alpha + 1e-10f);
      float incl = lt_;
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o, 16);
        if ((lane & 15) >= o) incl += v;
      }
      if (lane == 15) seg[wl * 8] = incl;
      wg_sync(0);
      const float before = ray_s[r * 8] + ((wl & 1) ? seg[(wl - 1) * 8] : 0.f);
      const float w = alpha * expf(before + (incl - lt_));
      if (lane < 16) {
        out_w[(size_t)n * S + s] = w;
        wts[row] = w;
      }
      const float* in = info + row * 8;
      float sums[6] = {w * in[7], w, w * in[6], 0.f, 0.f, 0.f};
      if (FINE)
        for (int c = 0; c < 3; ++c) {
          const float z = rgbp[row * 4 + c] + rgbp[(kWgRows + row) * 4 + c];
          sums[3 + c] = w * (1.f / (1.f + expf(-(z + __ldg(p.br + c)))));
        }
#pragma unroll
      for (int c = 0; c < 6; ++c)
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) sums[c] += __shfl_xor_sync(0xffffffffu, sums[c], o);
      if (lane == 0)
        for (int c = 0; c < 6; ++c) seg[wl * 8 + 1 + c] = sums[c];
      wg_sync(0);
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
      if (lt == 0) ctl[1] = sb + 1;
    }

    if (FINE) {
      // ---- descriptor: sum w h_tap over the warp's rows into its
      //      partials, from the tap values this thread kept ----
      __syncthreads();   // the chunk's weights, feat_max's rows
      const float sel = feat_max ? seg[(wl >> 1) * 8 + 7] : 0.f;
      const int hot = (wl >> 1) * kSampleBlock + (int)sel;
      const float w0 = feat_max ? (wrow == hot ? 1.f : 0.f) : wts[wrow];
      const float w1 = feat_max ? (wrow + 8 == hot ? 1.f : 0.f) : wts[wrow + 8];
#pragma unroll 1   // N passes: one at 512, a loop at 1024
      for (int P = 0; P < NP; ++P) {
        const float* tp = tap + 4 * NJ * P * kEvalThreads;
        float part[2 * NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float v00 = tp[(4 * j) * kEvalThreads], v01 = tp[(4 * j + 1) * kEvalThreads];
          const float v10 = tp[(4 * j + 2) * kEvalThreads], v11 = tp[(4 * j + 3) * kEvalThreads];
          part[2 * j] = fmaf(w1, v10, w0 * v00);
          part[2 * j + 1] = fmaf(w1, v11, w0 * v01);
          if (kDbg) {
            put_dbg(1, wrow, P * HP + c0 + 8 * j + 2 * t, v00, v01);
            put_dbg(1, wrow + 8, P * HP + c0 + 8 * j + 2 * t, v10, v11);
          }
        }
        fold_half<16, 2 * NJ>(part, lane);
        fold_half<8, NJ>(part, lane);
        fold_half<4, NJ / 2>(part, lane);
        float* fa = facc + wl * HID + P * HP + c0;
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
cudaError_t launch_tile(const EvalParams& p, const QuantParams& qp, const EvalArgs& a) {
  const size_t bytes = EvalSmemTile<HID, FINE, Q8>::bytes(6 * a.Fd + 3);
  auto kern = render_eval_tile_kernel<HID, FINE, kDbg, Q8, ENC>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return e;
  // Persistent: at most one block an SM, one tile a block at a time; the
  // scratch holds one block's (kScratchFloats) an SM.
  const int n_tiles = a.n_rays / kTileRays;
  const int grid = n_tiles < sms ? n_tiles : sms;
  constexpr size_t per_block = kScratchFloats<HID, FINE>;
  if (per_block > 0 && (a.scratch == nullptr || a.scratch_floats < (size_t)grid * per_block))
    return cudaErrorInvalidValue;
  kern<<<grid, kEvalThreads, bytes, a.stream>>>(
      p, qp, a.layer_num, a.feat_layer, a.int8_from, a.F, a.Fd, a.S, n_tiles,
      a.var_scale, a.log_eps, a.white_bg, a.feat_max, a.counter, a.scratch, a.w,
      a.depth, a.acc, a.rgb, a.feat, a.pts, a.dbg_out, a.dbgq);
  return cudaGetLastError();
}

template <int HID, bool Q8>
cudaError_t launch_trunk_tile(const EvalParams& p, const QuantParams& qp, const EvalArgs& a) {
  if constexpr (!Q8) {   // the bf16 coarse stage has no debug outputs
    auto fn = !a.fine ? launch_tile<HID, false, false, false, 3>
                      : a.dbg ? launch_tile<HID, true, true, false, 3>
                              : launch_tile<HID, true, false, false, 3>;
    return fn(p, qp, a);
  } else {
    auto fn = !a.fine ? (a.dbg ? launch_tile<HID, false, true, true, 3>
                               : launch_tile<HID, false, false, true, 3>)
                      : a.dbg ? launch_tile<HID, true, true, true, 3>
                              : launch_tile<HID, true, false, true, 3>;
    return fn(p, qp, a);
  }
}

template <int HID, bool Q8>
cudaError_t launch_trunk_tile_wide(const EvalParams& p, const QuantParams& qp,
                                   const EvalArgs& a) {
  if (a.dbg) return cudaErrorInvalidValue;
  return (a.fine ? launch_tile<HID, true, false, Q8, 4>
                 : launch_tile<HID, false, false, Q8, 4>)(p, qp, a);
}

template <int HID, bool Q8>
size_t smem_trunk_tile(bool fine, int dirs_dim) {
  return fine ? EvalSmemTile<HID, true, Q8>::bytes(dirs_dim)
              : EvalSmemTile<HID, false, Q8>::bytes(dirs_dim);
}

}  // namespace

// The instantiations of one trunk at width HID (render_eval_<trunk>_<HID>.cu)
// and those of the wide encoding (render_eval_wide_<HID>.cu).
#define NM_RENDER_EVAL_TILE(HID, Q8, NAME)                                     \
  cudaError_t nm_eval::launch_##NAME(const EvalParams& p, const QuantParams& qp, \
                                     const EvalArgs& a) {                      \
    return launch_trunk_tile<HID, Q8>(p, qp, a);                               \
  }                                                                            \
  size_t nm_eval::smem_##NAME(bool fine, int dirs_dim) {                       \
    return smem_trunk_tile<HID, Q8>(fine, dirs_dim);                           \
  }
#define NM_RENDER_EVAL_TILE_WIDE(HID, Q8, NAME)                                \
  cudaError_t nm_eval::launch_wide_##NAME(const EvalParams& p,                 \
                                          const QuantParams& qp,               \
                                          const EvalArgs& a) {                 \
    return launch_trunk_tile_wide<HID, Q8>(p, qp, a);                          \
  }
