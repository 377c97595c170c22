// The NeRF train-render stage (kernel 5, and kernel 6's trunk backward,
// launch 1) at MLP widths 512 and 1024: the same stage as
// render_train.cuh's (its per-ray semantics, its stash layout, every
// rounding order of its "Precision" paragraph), on an engine of its own, the
// tile engine (A from a shared-memory tile).  render_train_512.cu,
// render_train_wide_512.cu, render_train_1024.cu and
// render_train_wide_1024.cu instantiate it, each in an nvcc process of its
// own; the HID 64-256 instantiations never include this header.  An MLP of
// a width from 257 to 511 runs at 512, one from 513 to 1023 at 1024, on
// zero-padded weights (render_train_kernel.py: pad_mlp_to_kernel_width).
// Launches 2-4 of the backward (the weight-gradient GEMM, the reductions,
// g_app) are render_train.cu's, unchanged: they read the stash this forward
// fills and the gradient rows this backward writes, in render_train.cuh's
// layout scaled to HID columns.  The per-row stages (frustum moments, IPE,
// the extras row and its xt, the heads, the compositing scan, the composite
// backward) are render_train.cuh's helpers.
//
// Why render_train.cuh's engine stops at 256: a layer there is one wgmma
// m64nHID chain a warpgroup with A in registers.  wgmma's N is at most 256;
// at 512 the m64 f32 accumulator alone is 256 registers a thread and the
// bf16 A fragments of a 512-deep K 128 more; and a 128-row chunk's stash
// rows (its row buffer) do not fit beside a weight ring.
//
// Design (render_eval_512.cuh's column split).  A persistent grid (at most
// one block an SM) of two warpgroups that share one 64-row chunk (64
// samples of one ray; a ray of S samples is S / 64 chunks, its
// transmittance and sums carried from chunk to chunk): at 512 warpgroup wg
// owns output columns 256 wg .. 256 wg + 255 of every layer, an m64n256
// chain (a 128-register f32 accumulator).  A comes from shared memory: the
// layer's input is a K-major tile of 64 rows x HID bf16 (128-byte swizzle,
// HID / 64 blocks of 64 columns), read whole by both warpgroups.  After a
// layer's products both warpgroups wgmma.wait, meet at a block barrier, and
// write their epilogues into the tile in place: the next layer's input (the
// forward's activations; the backward's masked gradient rows).  Weights
// stream through a ring of slots of 32 weight rows x 512 columns (32 KB,
// one bulk copy each of pack_train's slot images, the same images the 256
// engine streams); a warpgroup reads its 256 columns of a slot, at a byte
// offset.
//
// HID 1024: NP = 2 N passes a layer (render_eval_512.cuh's 1024 design).  A
// warpgroup's accumulator cannot grow (m64n256 is 128 registers; two
// warpgroups at 255 registers fill the SM's register file), so each layer
// runs twice over the same input tile, warpgroup wg computing columns 512 p
// + 256 wg .. + 255 in pass p: the ring streams every image slice of the
// layer once a pass, the pass's half of its columns (32 KB, contiguous in
// pack_train's slot images: slot_images lays a slice out as HID / 64
// blocks of 32 x 64, so pass p's half is its blocks 8 p .. 8 p + 7).  The
// input tile is 64 rows x 1024 bf16 (128 KB) and must stay whole until the
// last pass's products retire, so pass 0's outputs have no room in shared
// memory: each thread parks its 64 packed bf16 pairs in its block's 64 KB
// of a global scratch (nm_train::kTileParkBytes, L2-resident: 8.6 MB on 132
// SMs) and reads its own values back into the tile after the last pass's
// barrier.  One parking place serves the training forward, the forward
// without a gradient (which has no stash rows to park in) and the trunk
// backward; each thread's stores are neighbours of its neighbours' (128
// bytes a warp), where the stash rows would take 16-byte pieces of eight
// rows.  The views layer (512 outputs) is one pass.  The ring keeps 2 slots
// of 32 KB, so each slice's copy from L2 is waited for with one batch of
// products in flight.  The passes are a loop, not unrolled (one trip at
// 512, where the compiler folds it: the 512 code is unchanged), and so are
// the slices of a 1024-row product.
//
// The stash.  The forward keeps what the 256 engine keeps (the encoding,
// every layer's bf16 activations, feature, views, the f32 record, the
// extras rows) in the same global layout: after each epilogue a block
// barrier, then all 256 threads copy the tile's rows to the stash, 16
// bytes a thread and neighbouring threads on neighbouring addresses
// (streaming stores: the rows are read once, by the backward); the record
// leaves by one bulk store a chunk.  The backward writes its gradient rows
// (g_hv, g_feat, every g_pre) the same way from its A tile, reads the ReLU
// masks (the stashed activations) straight from global memory at its
// accumulator elements, and sums its vector gradients (biases, the sigma
// head) into its block's row of the vector partials in global memory, in a
// fixed order (their 21 KB at 8 layers of 512 do not fit beside the ring
// and the tile).
//
// Shared memory (bytes): forward ring 131,072 at 512 (4 slots), 65,536 at
// 1024 (2 slots), activation tile 65,536 / 131,072, encoding tile 16,384,
// record 2,048, f32 rows 5,792 / 6,816 (row info 64 x 8, sigma partials 2 x
// 64, rgb partials 2 x 64 x 4, xt HID / 2, warp segments 4 x 8, ray state
// 8), mbarriers, the extras row (at most 144 f32) and 1024 of alignment
// slack: 222,464 / 223,472 at most.  Backward: ring 131,072 / 65,536, A
// tile 65,536 / 131,072, f32 13,328 / 22,544 (g_sigma_raw and g_rgb of a
// ray's samples, 4 warps x HID column partials, the ray's g_hv sum),
// mbarriers: 210,992 / 220,192.
//
// What bounds it (9216 rays x 128 samples): at 512 the forward's products,
// ~2.3 M MACs a sample (4.7 TFLOP at 8 layers, ~5.5 ms at the bf16 peak),
// beside the ~11.7 GB of stash it writes (~3.5 ms); at 1024 ~9.7 M MACs a
// sample (22.9 TFLOP, ~23 ms) beside 23.2 GB (~6.9 ms); the trunk backward
// about as many products (g_h of every layer) beside the stash it reads and
// the gradient rows it writes.  Each 64-row chunk streams every weight from
// L2 once (64 FLOP a byte).  A simple engine that is right first (PERF.md
// has its times).  -Xptxas -v (sm_90a, CUDA 12.8): train_fwd_tile_kernel<512>
// 255 registers, 192 bytes of spill stores / 216 of loads with the stash
// (180 / 188 without); train_bwd_tile_kernel<512> 255, 552 / 1036; at 1024
// PERF.md has them.

#include "render_train.cuh"

namespace {

constexpr int kRows512 = 64;           // a chunk: one wgmma m64 tile
constexpr int kBlock512 = 64 * 128;    // 64 rows x 64 bf16, 128-byte swizzle
// A thread's parked pass (NP = 2): its 64 packed bf16 pairs, pair (j, h)
// at park[kBwdThreads (2 j + h)] of its block's nm_train::kTileParkBytes.
constexpr int kParkPairs = 64;
static_assert((size_t)kParkPairs * kBwdThreads * 4 == nm_train::kTileParkBytes,
              "a block's parked pass");

template <int HID_>
struct FwdTileSmem {
  static constexpr int HID = HID_, HV = HID / 2;
  static constexpr int NP = HID / 512;   // N passes a layer
  static constexpr int HP = HID / NP;    // a pass's columns: 512
  static constexpr int kRing = NP > 1 ? 2 : 4;               // weight slots
  static constexpr int kSlot = (HP / 64) * kSliceK * 128;    // 32 KB
  static constexpr int kVSlot = (HV / 64) * kSliceK * 128;   // 16 KB (32 KB at 1024)
  static constexpr int kXOff = kRing * kSlot;                // activation tile
  static constexpr int kEncOff = kXOff + (HID / 64) * kBlock512;   // encoding tile
  static constexpr int kRecOff = kEncOff + 2 * kBlock512;    // record 64 x 8 f32
  static constexpr int kFloatOff = kRecOff + kRows512 * kRecWidth * 4;
  static constexpr int kInfo = 0, kSig = kInfo + kRows512 * 8, kRgb = kSig + 2 * kRows512,
                       kXt = kRgb + 2 * kRows512 * 4, kSeg = kXt + HV, kRay = kSeg + 4 * 8,
                       kFloats = kRay + 8;
  static constexpr int kBarOff = kFloatOff + kFloats * 4;
  // Last, sized at launch: the unit's extras row (ew f32).
  static constexpr int kDpeOff = (kBarOff + 8 * kRing + 15) / 16 * 16;
  __host__ __device__ static constexpr size_t bytes(int ew) {
    return 1024 + kDpeOff + (size_t)ew * 4;
  }
};

template <int HID_>
struct BwdTileSmem {
  static constexpr int HID = HID_, HV = HID / 2;
  static constexpr int NP = HID / 512, HP = HID / NP;
  static constexpr int kRing = NP > 1 ? 2 : 4;
  static constexpr int kSlot = (HP / 64) * kSliceK * 128;    // 32 KB
  static constexpr int kAOff = kRing * kSlot;                // A tile 64 x HID bf16
  static constexpr int kFloatOff = kAOff + (HID / 64) * kBlock512;
  static constexpr int kGsr = 0, kGrgb = kGsr + kMaxSamples, kCol = kGrgb + 3 * kMaxSamples,
                       kHvsum = kCol + 4 * HID, kTot = kHvsum + HV, kFloats = kTot + 4;
  static constexpr int kBarOff = kFloatOff + kFloats * 4;
  __host__ __device__ static constexpr size_t bytes() { return 1024 + kBarOff + 8 * kRing; }
};

// Element pair (row r, columns c, c + 1) of a K-major tile of 64-column
// bf16 blocks.
__device__ __forceinline__ void put_tile(unsigned char* tile, int r, int c, uint32_t v) {
  *reinterpret_cast<uint32_t*>(tile + (c >> 6) * kBlock512 + swz(r, (c & 63) >> 3) + (c & 7) * 2) = v;
}

// The tile's 64 rows (width bf16 each, width % 8 == 0) -> dst rows rg0 ..,
// 16 bytes a thread, streaming stores; after a barrier behind the writes.
__device__ __forceinline__ void stash_rows(const unsigned char* tile, __nv_bfloat16* dst,
                                           int width, size_t rg0, int tid) {
  const int cpr = width / 8;   // 16-byte chunks a row
  for (int i = tid; i < kRows512 * cpr; i += kBwdThreads) {
    const int r = i / cpr, c = i % cpr;
    __stcs(reinterpret_cast<int4*>(dst + (rg0 + r) * width) + c,
           *reinterpret_cast<const int4*>(tile + (c >> 3) * kBlock512 + swz(r, c & 7)));
  }
}

// The parked pass into the tile (after the last pass's barrier): this
// thread's pairs (j, h) of pass 0, row wrow + 8 h, columns c0 + 8 j + 2 t.
__device__ __forceinline__ void unpark(unsigned char* tile, const uint32_t* park, int wrow,
                                       int c0, int t) {
#pragma unroll 8
  for (int k = 0; k < kParkPairs; ++k)
    put_tile(tile, wrow + 8 * (k & 1), c0 + 8 * (k >> 1) + 2 * t, park[k * kBwdThreads]);
}

// The parked pass's scratch of this block (NP = 2: the kernel's last
// argument), at this thread's first pair; null at 512, which takes none.
__device__ __forceinline__ uint32_t* park_base(int tid) { return nullptr; }
__device__ __forceinline__ uint32_t* park_base(int tid, uint32_t* scratch) {
  return scratch + (size_t)blockIdx.x * kParkPairs * kBwdThreads + tid;
}

// The stashed pair (row, columns col, col + 1) of a (rows, width) bf16
// array, as f32.
__device__ __forceinline__ float2 stashed(const __nv_bfloat16* src, int width, size_t row,
                                          int col) {
  return __bfloat1622float2(
      __ldg(reinterpret_cast<const __nv_bfloat162*>(src + row * width + col)));
}

// The k16 step ks of a K-major bf16 tile of 64-column blocks, as wgmma's A.
__device__ __forceinline__ uint64_t a_desc(uint32_t tile, int ks) {
  return desc128(tile + (ks >> 2) * kBlock512 + (ks & 3) * 32, 16);
}

// Train forward on the tile engine: a persistent grid of two warpgroups
// walking over the rays (units), a ray's S / 64 chunks in order.  Per
// chunk: frustum moments and the IPE of its 64 rows into the encoding tile;
// each trunk layer as NP passes of two m64n256 wgmma chains (A: the
// encoding tile for layer 0 and the skip layer's encoding rows, the
// activation tile for the hidden rows; B: the ring), its epilogue (bias,
// ReLU, bf16) into the activation tile (pass 0 of two parked first); the
// sigma head's and the rgb head's dot products per warpgroup, summed in
// order by the compositing warps (warpgroup 0).  kStash: every row's
// encoding and activations, and the record, into the stash.  ENC: the
// encoding's 32-row slices (3: 2 * 3 * F <= 96; 4: <= 128).  Park: empty at
// 512; at 1024 the parked pass's scratch (uint32_t*), so that 512's
// parameters, and its code, are those of the 512-only engine before it.
template <int HID_, bool kStash, int ENC, class... Park>
__global__ void __launch_bounds__(kBwdThreads, 1)
train_fwd_tile_kernel(TrainParams p, Stash st, int layer_num, int F, int Fd, int S,
                      int n_rays, float var_scale, int white_bg,
                      float* __restrict__ out_rgb, float* __restrict__ out_w,
                      Park... scratch) {
  using L = FwdTileSmem<HID_>;
  constexpr int HID = L::HID, HV = L::HV, R = L::kRing;
  constexpr int NP = L::NP, HP = L::HP;
  constexpr int HW = HP / 2;          // a warpgroup's output columns a pass
  constexpr int NJ = HW / 8;          // its n8 column groups
  constexpr int NJV = HV / 2 / 8;     // the same of the views product
  constexpr int KS = HID / kSliceK;   // slices of a HID-row product
  static_assert(L::bytes(kExtraMax + kAppDim) <= 232448, "forward shared memory");
  static_assert(ENC == 3 || ENC == 4, "96 or 128 encoding rows");
  static_assert((NP > 1) == (sizeof...(Park) == 1) && 2 * NJ == kParkPairs,
                "the parked pass's scratch at 1024 only");
  static_assert(NP == 1 || L::kVSlot == L::kSlot, "a views slice fills a slot");

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = tid >> 7, wl = warp & 3, t = lane & 3;
  const int wrow = wl * 16 + (lane >> 2);   // first of this thread's two rows
  const int c0 = wg * HW;                   // this warpgroup's first column (pass 0)
  const uint32_t ring_s = base, x_w = base + L::kXOff, enc_w = base + L::kEncOff;
  const uint32_t rec_s = base + L::kRecOff, full0 = base + L::kBarOff;
  unsigned char* x_p = sm + L::kXOff;
  unsigned char* enc_p = sm + L::kEncOff;
  float* rec = reinterpret_cast<float*>(sm + L::kRecOff);   // 64 x 8
  float* fw = reinterpret_cast<float*>(sm + L::kFloatOff);
  float* info = fw + L::kInfo;   // 64 x 8
  float* sigp = fw + L::kSig;    // [wg][row]: sigma partials
  float* rgbp = fw + L::kRgb;    // [wg][row][4]: rgb partials
  float* xt = fw + L::kXt;       // HV
  float* seg = fw + L::kSeg;     // 4 warps x 8
  float* ray_s = fw + L::kRay;   // carry, acc, rgb (3)
  float* dpe = reinterpret_cast<float*>(sm + L::kDpeOff);
  uint32_t* const park = park_base(tid, scratch...);

  const int enc_dim = 6 * F, dirs_dim = 6 * Fd + 3;
  constexpr int enc_pad = ENC * kSliceK;
  const int dpad = dirs_rows(Fd);
  const int ew = extras_width(Fd, p.app != nullptr);
  const float* wa_t = p.wa + c0 + 2 * t;   // + P HP in pass P
  const float* bf_t = p.bf + c0 + 2 * t;

  const int unit_chunks = S / kRows512;
  const int my_units = (n_rays - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  // Slices a chunk streams, in the host images' order: per layer its
  // encoding rows (if any) then its hidden rows, then the feature and the
  // views layers; each trunk and feature slice once a pass.  All but the
  // views slices at 512 fill a whole slot.
  int Qt = KS * (layer_num - 1);
  for (int i = 0; i < layer_num; ++i) Qt += p.Wenc[i] != nullptr ? ENC : 0;
  const int Q = NP * (Qt + KS) + KS;
  const int q_total = my_units * unit_chunks * Q;

  // The encoding tile's padding columns (enc_dim .. kEncMax - 1) stay zero.
  for (int i = tid; i < kRows512 * (kEncMax - enc_dim); i += kBwdThreads) {
    const int row = i / (kEncMax - enc_dim), k = enc_dim + i % (kEncMax - enc_dim);
    *reinterpret_cast<__nv_bfloat16*>(enc_p + (k >> 6) * kBlock512 + swz(row, (k & 63) >> 3) +
                                      (k & 7) * 2) = __float2bfloat16(0.f);
  }
  if (tid == 0)
    for (int i = 0; i < R; ++i) mbar_init(full0 + 8 * i);
  fence_async();
  __syncthreads();

  auto load_slice = [&](int q) {
    const int qc = q % Q;
    uint32_t bytes = L::kSlot;
    size_t off;
    if constexpr (NP == 1) {
      const bool views = qc >= Qt + KS;
      bytes = views ? L::kVSlot : L::kSlot;
      off = views ? (size_t)(Qt + KS) * L::kSlot + (size_t)(qc - Qt - KS) * L::kVSlot
                  : (size_t)qc * L::kSlot;
    } else {
      // Per trunk layer (then the feature layer) its n image slices once a
      // pass, pass P reading the P-th kSlot of each (an image slice holds
      // NP of them); then the views layer's slices, a slot each (n = 0).
      int r = qc, n = 0;
      size_t at = 0;
      for (int i = 0; i <= layer_num; ++i) {
        const int m = i == layer_num ? KS
                                     : (p.Wenc[i] != nullptr ? ENC : 0) + (i > 0 ? KS : 0);
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
    bulk_copy(ring_s + slot * L::kSlot, reinterpret_cast<const unsigned char*>(p.Wfwd) + off,
              bytes, full0 + 8 * slot);
  };
  int q = 0;   // next ring slice to consume
  if (tid == 0)
    for (int s = 0; s < R - 2 && s < q_total; ++s) load_slice(s);

  float acc[NJ * 4];
  // One wgmma batch stays in flight, so slot q - 2 is the one refilled
  // (with slice q + R - 2) when slice q is taken.
  auto begin = [&]() {
    __syncthreads();   // batch q - 2 done everywhere: its slot is free
    if (tid == 0 && q + R - 2 < q_total) load_slice(q + R - 2);
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
  // hidden slices (A: the activation tile), this warpgroup's N columns
  // (its N / 64 blocks of each slot).
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
        wgmma_ss<N, 0>(acc, a_desc(enc_w, s * KK + kk), desc128(slot + kk * 2048, kSliceK * 128),
                       s * KK + kk > 0);
      end();
    }
    if constexpr (NP == 1) {
#pragma unroll
      for (int s = 0; s < NH; ++s) {
        const uint32_t slot = begin() + boff;
#pragma unroll
        for (int kk = 0; kk < KK; ++kk)
          wgmma_ss<N, 0>(acc, a_desc(x_w, s * KK + kk), desc128(slot + kk * 2048, kSliceK * 128),
                         NE + s + kk > 0);
        end();
      }
    } else {   // 1024: a loop (unrolled, its 32 slices double 512's code)
#pragma unroll 2
      for (int s = 0; s < NH; ++s) {
        const uint32_t slot = begin() + boff;
#pragma unroll
        for (int kk = 0; kk < KK; ++kk)
          wgmma_ss<N, 0>(acc, a_desc(x_w, s * KK + kk), desc128(slot + kk * 2048, kSliceK * 128),
                         NE + s + kk > 0);
        end();
      }
    }
    wgmma_wait<0>();
  };
  // Pass P's outputs of column pair (j, h) (row wrow + 8 h, columns P HP +
  // c0 + 8 j + 2 t, + 1): into the tile in the last pass, else parked.
  auto out = [&](int P, int j, int h, uint32_t v) {
    if (P + 1 < NP)
      park[(2 * j + h) * kBwdThreads] = v;
    else
      put_tile(x_p, wrow + 8 * h, P * HP + c0 + 8 * j + 2 * t, v);
  };
  // The tile's rows, after every thread's epilogue writes, into the stash.
  auto keep = [&](const unsigned char* tile, __nv_bfloat16* dst, int width, size_t rg0) {
    if (kStash) {
      __syncthreads();
      stash_rows(tile, dst, width, rg0, tid);
    }
  };

  for (int ui = 0; ui < my_units; ++ui) {
    const int n = (int)blockIdx.x + ui * (int)gridDim.x;
    __syncthreads();   // the last unit's sums are read
    for (int j = tid; j < ew; j += kBwdThreads) {
      const float v = extras_value(p, n, j, Fd, dirs_dim, dpad);
      dpe[j] = bf16_round(v);
      if (kStash) st.extras[(size_t)n * ew + j] = __float2bfloat16(v);
    }
    if (tid < 8) ray_s[tid] = 0.f;
    __syncthreads();
    for (int k = tid; k < HV; k += kBwdThreads) xt[k] = xt_value<HV>(p, dpe, k, dirs_dim, dpad);

    for (int ch = 0; ch < unit_chunks; ++ch) {
      const size_t rg0 = (size_t)n * S + ch * kRows512;
      // The record's last bulk store has read it; every read of the row
      // info and of the tiles is done.
      if (kStash && tid == 0) bulk_read_done();
      __syncthreads();
      if (tid < kRows512)
        frustum_row(p.rays + (size_t)n * 12, p.z + (size_t)n * (S + 1), ch * kRows512 + tid,
                    var_scale, info + tid * 8);
      __syncthreads();
      for (int i = tid; i < kRows512 * 3 * F; i += kBwdThreads) {
        const int row = i / (3 * F), j = i % (3 * F);
        __nv_bfloat16 v[2];
        ipe_pair(info + row * 8, j, v);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = h * 3 * F + j;
          *reinterpret_cast<__nv_bfloat16*>(enc_p + (k >> 6) * kBlock512 +
                                            swz(row, (k & 63) >> 3) + (k & 7) * 2) = v[h];
        }
      }
      fence_async();   // the encoding tile, for wgmma
      keep(enc_p, st.xb, enc_pad, rg0);

      // ---- trunk: acc = [enc @ Wenc_i] + [h @ Wh_i]; h = relu(acc + b),
      //      rounded to bf16, in place ----
      float sp[2] = {0.f, 0.f};   // sigma head partials of its two rows
      for (int i = 0; i < layer_num; ++i) {
#pragma unroll 1   // N passes: one at 512, a loop at 1024
        for (int P = 0; P < NP; ++P) {
          if (i == 0)
            product(Int<ENC>{}, Int<0>{}, Int<HW>{});
          else if (p.Wenc[i] != nullptr)
            product(Int<ENC>{}, Int<KS>{}, Int<HW>{});
          else
            product(Int<0>{}, Int<KS>{}, Int<HW>{});
          if (P + 1 == NP) __syncthreads();   // both warpgroups' products have read the tile
          const bool last = i == layer_num - 1;
          const float* b_t = p.b[i] + P * HP + c0 + 2 * t;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float b0 = __ldg(b_t + 8 * j), b1 = __ldg(b_t + 8 * j + 1);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float v0 = fmaxf(acc[4 * j + 2 * h] + b0, 0.f);
              const float v1 = fmaxf(acc[4 * j + 2 * h + 1] + b1, 0.f);
              out(P, j, h, pack_bf16(v0, v1));
              if (last)
                sp[h] = fmaf(v0, __ldg(wa_t + P * HP + 8 * j),
                             fmaf(v1, __ldg(wa_t + P * HP + 8 * j + 1), sp[h]));
            }
          }
        }
        if constexpr (NP > 1) unpark(x_p, park, wrow, c0, t);
        fence_async();
        keep(x_p, st.hs[i], HID, rg0);
      }
      // ---- sigma partials: this warpgroup's columns of h . wa ----
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s = sp[h];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (t == 0) sigp[wg * kRows512 + wrow + 8 * h] = s;
      }

      // ---- feature = bf16(h) @ wf + bf (no activation), rounded to bf16,
      //      in place ----
#pragma unroll 1   // N passes: one at 512, a loop at 1024
      for (int P = 0; P < NP; ++P) {
        product(Int<0>{}, Int<KS>{}, Int<HW>{});
        if (P + 1 == NP) __syncthreads();
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float b0 = __ldg(bf_t + P * HP + 8 * j), b1 = __ldg(bf_t + P * HP + 8 * j + 1);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            out(P, j, h, pack_bf16(acc[4 * j + 2 * h] + b0, acc[4 * j + 2 * h + 1] + b1));
        }
      }
      if constexpr (NP > 1) unpark(x_p, park, wrow, c0, t);
      fence_async();
      keep(x_p, st.feat, HID, rg0);

      // ---- views = relu(feature @ wvh + xt + bv), rounded to bf16 (this
      //      warpgroup's HV / 2 columns, one pass; into the tile for the
      //      stash); the rgb head's partials over them ----
      product(Int<0>{}, Int<KS>{}, Int<HV / 2>{});
      __syncthreads();
      {
        const int v0c = wg * (HV / 2);
        float pr[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
        for (int j = 0; j < NJV; ++j) {
          const int col = v0c + 8 * j + 2 * t;
          const float xa = xt[col], xb = xt[col + 1];
          const float b0 = __ldg(p.bv + col), b1 = __ldg(p.bv + col + 1);
          float wr[2][3];
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int c = 0; c < 3; ++c) wr[e][c] = __ldg(p.wr + 3 * (col + e) + c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v0 = fmaxf(acc[4 * j + 2 * h] + xa + b0, 0.f);
            const float v1 = fmaxf(acc[4 * j + 2 * h + 1] + xb + b1, 0.f);
            const uint32_t pk = pack_bf16(v0, v1);
            if (kStash) put_tile(x_p, wrow + 8 * h, col, pk);
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
            if (t == 0) rgbp[(wg * kRows512 + wrow + 8 * h) * 4 + c] = s;
          }
      }
      keep(x_p, st.hv, HV, rg0);
      // ---- compositing on warpgroup 0: warp w takes rows 16 w .., one
      //      row a lane of each half (the halves compute the same); the
      //      heads from the two warpgroups' partials, in order ----
      __syncthreads();   // the partials of every row
      if (wg == 0) {
        const int row = wl * 16 + (lane & 15);
        const size_t rg = rg0 + row;
        const float sr = sigma_raw_head(p, sigp[row] + sigp[kRows512 + row], rg);
        float rgb[3];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          rgb[c] = rgb_head(p, rgbp[row * 4 + c] + rgbp[(kRows512 + row) * 4 + c], c);
        float lt, incl;
        const float alpha = alpha_scan16(sr, info[row * 8 + 6], lane, lt, incl);
        if (lane == 15) seg[wl * 8] = incl;
        wg_sync(0);
        float before = ray_s[0];
        for (int w = 0; w < wl; ++w) before += seg[w * 8];
        const float trans = expf(before + (incl - lt));
        const float wt = alpha * trans;
        float sums[4] = {wt, wt * rgb[0], wt * rgb[1], wt * rgb[2]};
        sum16(sums);
        if (lane < 16) {
          out_w[rg] = wt;
          if (kStash) {
            float* rr = rec + row * 8;
            rr[0] = rgb[0];
            rr[1] = rgb[1];
            rr[2] = rgb[2];
            rr[3] = sr;
            rr[4] = alpha;
            rr[5] = trans;
            rr[6] = rr[7] = 0.f;
          }
        }
        if (lane == 0)
          for (int c = 0; c < 4; ++c) seg[wl * 8 + 1 + c] = sums[c];
        wg_sync(0);
        if (tid == 0)   // the ray's sums, its four warps' segments in order
          for (int w = 0; w < 4; ++w) {
            ray_s[0] += seg[w * 8];
            for (int c = 0; c < 4; ++c) ray_s[1 + c] += seg[w * 8 + 1 + c];
          }
      }
      if (kStash) {
        fence_async();   // the record, for its bulk store
        __syncthreads();
        if (tid == 0)
          bulk_store(st.rec + rg0 * kRecWidth, rec_s, kRows512 * kRecWidth * 4);
      }
    }
    __syncthreads();
    if (tid < 3) out_rgb[(size_t)n * 3 + tid] = ray_s[2 + tid] + (white_bg ? 1.f - ray_s[1] : 0.f);
  }

  if (kStash && tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Trunk backward on the tile engine (kernel 6's launch 1): a persistent
// grid of two warpgroups walking over the rays, a ray's S / 64 chunks in
// order.  Per ray the composite backward (composite_bwd_ray, one warp); per
// chunk the rgb head's and the views layer's backward (this warpgroup's
// HV / 2 g_hv columns into the A tile), then each product g =
// bf16(g_rows) @ bf16(W)^T as NP passes of two m64n256 wgmma chains (A: the
// A tile; B: the ring of the (out x in) slot images, views, feature, then
// layers L-1 .. 1), its epilogue (ReLU mask from the stashed activations,
// column sums, bf16) into the A tile in place (pass 0 of two parked
// first).  Every gradient row leaves for the workspace as launch 2 reads
// it; the column sums go to the block's vector-partial row in a fixed
// order.  Park as train_fwd_tile_kernel's.
template <int HID_, class... Park>
__global__ void __launch_bounds__(kBwdThreads, 1)
train_bwd_tile_kernel(TrainParams p, Stash st, int layer_num, int S, int n_rays, int white_bg,
                      const float* __restrict__ g_rgb_in, const float* __restrict__ g_w_in,
                      Park... scratch) {
  using L = BwdTileSmem<HID_>;
  constexpr int HID = L::HID, HV = L::HV, R = L::kRing;
  constexpr int NP = L::NP, HP = L::HP;
  constexpr int HW = HP / 2;                  // a warpgroup's output columns a pass
  constexpr int NJ = HW / 8, NJV = HV / 2 / 8;  // its n8 column groups, of g_hv
  constexpr int KS = HID / kSliceK, KSV = HV / kSliceK;
  constexpr int JB = 16;                      // column groups a col_sums call
  static_assert(L::bytes() <= 232448, "trunk backward shared memory");
  static_assert((NP > 1) == (sizeof...(Park) == 1) && 2 * NJ == kParkPairs,
                "the parked pass's scratch at 1024 only");
  const VecLayout vl(layer_num, HID);

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t ring_s = base, a_w = base + L::kAOff, full0 = base + L::kBarOff;
  unsigned char* a_p = sm + L::kAOff;
  float* fw = reinterpret_cast<float*>(sm + L::kFloatOff);
  float* gsr = fw + L::kGsr;       // the ray's samples
  float* grgb = fw + L::kGrgb;     // the ray's samples x 3
  float* colpart = fw + L::kCol;   // 4 warps x HID: column partials
  float* hvsum = fw + L::kHvsum;   // HV
  float* tot = fw + L::kTot;       // 4
  float* vec = st.vec_part + (size_t)blockIdx.x * vl.P;   // this block's row

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = tid >> 7, wl = warp & 3, t = lane & 3;
  const int wrow = wl * 16 + (lane >> 2);   // first of this thread's two rows
  const int c0 = wg * HW;                   // this warpgroup's first column (pass 0)
  float* cpw = colpart + wl * HID;          // this warp's partials row
  uint32_t* const park = park_base(tid, scratch...);

  const int unit_chunks = S / kRows512;
  const int my_units = (n_rays - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  // Weight slices a chunk streams: views (HV rows), feature, then the
  // hidden rows of layers L-1 .. 1 (HID rows each), all (out x in), each
  // once a pass.
  const int Q = NP * (KSV + KS * layer_num);
  const int q_total = my_units * unit_chunks * Q;

  for (int i = tid; i < vl.P; i += kBwdThreads) vec[i] = 0.f;
  for (int i = tid; i < HV; i += kBwdThreads) hvsum[i] = 0.f;
  if (tid == 0)
    for (int i = 0; i < R; ++i) mbar_init(full0 + 8 * i);
  __syncthreads();

  auto load_slice = [&](int q) {
    const int qc = q % Q;
    const __nv_bfloat16* src;
    int sl;
    if (qc < NP * KSV) {
      src = p.wvhT;
      sl = qc;
    } else {
      const int r = qc - NP * KSV, m = r / (NP * KS);   // m = 0: feature; m: layer L - m
      src = m == 0 ? p.wfT : p.WhT[layer_num - m];
      sl = r % (NP * KS);
    }
    if constexpr (NP > 1) {
      // Pass sl / n of the matrix's image slice sl % n: its P-th kSlot (an
      // image slice holds NP of them).
      const int n = qc < NP * KSV ? KSV : KS;
      sl = (sl % n) * NP + sl / n;
    }
    const int slot = q % R;
    mbar_expect(full0 + 8 * slot, L::kSlot);
    bulk_copy(ring_s + slot * L::kSlot, src + (size_t)sl * (L::kSlot / 2), L::kSlot,
              full0 + 8 * slot);
  };
  int q = 0;   // next ring slice to consume
  if (tid == 0)
    for (int s = 0; s < R - 2 && s < q_total; ++s) load_slice(s);

  float acc[NJ * 4];
  // acc = the A tile (k = NKS * kSliceK) times the next NKS ring slices,
  // this warpgroup's 256 columns.  One wgmma batch stays in flight.
  auto product = [&](auto nks_c) {
    constexpr int NKS = decltype(nks_c)::value;
    const uint32_t boff = (uint32_t)wg * (HW / 64) * (kSliceK * 128);
    if constexpr (NP == 1) {
#pragma unroll
      for (int s = 0; s < NKS; ++s, ++q) {
        __syncthreads();   // batch q - 2 done everywhere: its slot is free
        if (tid == 0 && q + R - 2 < q_total) load_slice(q + R - 2);
        mbar_wait(full0 + 8 * (q % R), (q / R) & 1);
        const uint32_t slot = ring_s + (uint32_t)(q % R) * L::kSlot + boff;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSliceK / 16; ++kk)
          wgmma_ss<HW, 0>(acc, a_desc(a_w, s * (kSliceK / 16) + kk),
                          desc128(slot + kk * 2048, kSliceK * 128), s + kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
      }
    } else {   // 1024: a loop (unrolled, its 32 slices double 512's code)
#pragma unroll 2
      for (int s = 0; s < NKS; ++s, ++q) {
        __syncthreads();
        if (tid == 0 && q + R - 2 < q_total) load_slice(q + R - 2);
        mbar_wait(full0 + 8 * (q % R), (q / R) & 1);
        const uint32_t slot = ring_s + (uint32_t)(q % R) * L::kSlot + boff;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSliceK / 16; ++kk)
          wgmma_ss<HW, 0>(acc, a_desc(a_w, s * (kSliceK / 16) + kk),
                          desc128(slot + kk * 2048, kSliceK * 128), s + kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
      }
    }
    wgmma_wait<0>();
  };
  // Fixed-order sum of the four warps' partials of column c (its
  // warpgroup's rows 0-15, 16-31, ...).
  auto col_total = [&](int c) {
    return ((colpart[c] + colpart[HID + c]) + colpart[2 * HID + c]) + colpart[3 * HID + c];
  };
  // The epilogue of pass P of a product: g = acc, masked (kMask) where the
  // stashed activations hs are not > 0 (the ReLU), its column sums, bf16
  // into the A tile (in the last pass, else parked).
  auto epilogue = [&](auto mask_c, const __nv_bfloat16* hs, size_t rg0, int P) {
    constexpr bool kMask = decltype(mask_c)::value;
#pragma unroll
    for (int j0 = 0; j0 < NJ; j0 += JB) {
      float cs[2 * JB];
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) {
        const int j = j0 + jj, col = P * HP + c0 + 8 * j + 2 * t;
        cs[2 * jj] = cs[2 * jj + 1] = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wrow + 8 * h;
          float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (kMask) {
            const float2 hh = stashed(hs, HID, rg0 + r, col);
            if (!(hh.x > 0.f)) v0 = 0.f;
            if (!(hh.y > 0.f)) v1 = 0.f;
          }
          cs[2 * jj] += v0;
          cs[2 * jj + 1] += v1;
          if (P + 1 < NP)
            park[(2 * j + h) * kBwdThreads] = pack_bf16(v0, v1);
          else
            put_tile(a_p, r, col, pack_bf16(v0, v1));
        }
      }
      col_sums(cs, lane, cpw + P * HP + c0 + 8 * j0);
    }
    fence_async();
    __syncthreads();
  };
  // After the last pass's epilogue: the parked pass into the A tile.
  auto unpark_all = [&]() {
    if constexpr (NP > 1) {
      unpark(a_p, park, wrow, c0, t);
      fence_async();
      __syncthreads();
    }
  };

  for (int ui = 0; ui < my_units; ++ui) {
    const int n = (int)blockIdx.x + ui * (int)gridDim.x;
    for (int ch = 0; ch < unit_chunks; ++ch) {
      const size_t rg0 = (size_t)n * S + ch * kRows512;
      const int ul0 = ch * kRows512;   // the chunk's first row in the ray
      if (ch == 0) {
        if (warp == 0)
          composite_bwd_ray(p, st, g_rgb_in, g_w_in, n, S, lane, white_bg, gsr, grgb, tot);
        __syncthreads();
        if (tid == 0) {
          for (int c = 0; c < 3; ++c) vec[vl.brgb + c] += tot[c];
          vec[vl.ba] += tot[3];
        }
      }
      __syncthreads();   // composite results visible; the last chunk is done

      // ---- g_hv = relu'(hv) * (bf16(g_rgb_t) @ bf16(wrgb)^T): this
      //      warpgroup's HV / 2 columns ----
      {
        const int v0c = wg * (HV / 2);
        float cs[2 * NJV];
#pragma unroll
        for (int j = 0; j < NJV; ++j) {
          const int col = v0c + 8 * j + 2 * t;
          float w[2][3];
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int c = 0; c < 3; ++c) w[e][c] = __ldg(p.wr + (col + e) * 3 + c);
          cs[2 * j] = cs[2 * j + 1] = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wrow + 8 * h;
            const float* gr = grgb + (ul0 + r) * 3;
            const float a0 = bf16_round(gr[0]), a1 = bf16_round(gr[1]), a2 = bf16_round(gr[2]);
            const float2 hv = stashed(st.hv, HV, rg0 + r, col);
            float v0 = a0 * w[0][0] + a1 * w[0][1] + a2 * w[0][2];
            float v1 = a0 * w[1][0] + a1 * w[1][1] + a2 * w[1][2];
            if (!(hv.x > 0.f)) v0 = 0.f;
            if (!(hv.y > 0.f)) v1 = 0.f;
            cs[2 * j] += v0;
            cs[2 * j + 1] += v1;
            put_tile(a_p, r, col, pack_bf16(v0, v1));
          }
        }
        col_sums(cs, lane, cpw + v0c);
      }
      fence_async();
      __syncthreads();
      stash_rows(a_p, st.g_hv, HV, rg0, tid);
      for (int c = tid; c < HV; c += kBwdThreads) {
        const float s = col_total(c);
        vec[vl.bv + c] += s;
        hvsum[c] += s;
        if (ch == unit_chunks - 1) {
          st.g_hvsum[(size_t)n * HV + c] = __float2bfloat16(hvsum[c]);
          hvsum[c] = 0.f;
        }
      }

      // ---- g_feature = bf16(g_hv) @ bf16(wvh)^T (no activation) ----
#pragma unroll 1   // N passes: one at 512, a loop at 1024
      for (int P = 0; P < NP; ++P) {
        product(Int<KSV>{});
        __syncthreads();   // both warpgroups' products have read the A tile
        epilogue(std::false_type{}, nullptr, rg0, P);
      }
      unpark_all();
      stash_rows(a_p, st.g_feat, HID, rg0, tid);
      for (int c = tid; c < HID; c += kBwdThreads) vec[vl.bf + c] += col_total(c);

      // ---- g_h = bf16(g_feature) @ bf16(wf)^T + g_sigma_raw * wa (pass
      //      0 here, pass 1 in the loop) ----
      product(Int<KS>{});
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[4 * j + e] += gsr[ul0 + wrow + 8 * (e >> 1)] *
                            __ldg(p.wa + c0 + 8 * j + 2 * t + (e & 1));

      // ---- trunk: g_pre_i = relu'(h_i) * g_h; g_h = bf16(g_pre_i) @
      //      bf16(W_i)^T (pass 0 at the end of the layer before, pass 1 in
      //      the pass loop) ----
      for (int i = layer_num - 1; i >= 0; --i) {
#pragma unroll 1   // N passes: one at 512, a loop at 1024
        for (int P = 0; P < NP; ++P) {
          if (P > 0) {
            product(Int<KS>{});
            if (i == layer_num - 1) {
#pragma unroll
              for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  acc[4 * j + e] += gsr[ul0 + wrow + 8 * (e >> 1)] *
                                    __ldg(p.wa + P * HP + c0 + 8 * j + 2 * t + (e & 1));
            }
          }
          if (i == layer_num - 1) {
            // sigma head: wa gets sum over rows of h_{L-1} * g_sigma_raw
            // (this pass's columns).
#pragma unroll
            for (int j0 = 0; j0 < NJ; j0 += JB) {
              float cs[2 * JB];
#pragma unroll
              for (int jj = 0; jj < JB; ++jj) {
                const int col = P * HP + c0 + 8 * (j0 + jj) + 2 * t;
                cs[2 * jj] = cs[2 * jj + 1] = 0.f;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int r = wrow + 8 * h;
                  const float gs = gsr[ul0 + r];
                  const float2 hh = stashed(st.hs[i], HID, rg0 + r, col);
                  cs[2 * jj] += hh.x * gs;
                  cs[2 * jj + 1] += hh.y * gs;
                }
              }
              col_sums(cs, lane, cpw + P * HP + c0 + 8 * j0);
            }
            __syncthreads();
            for (int c = tid; c < HP; c += kBwdThreads)
              vec[vl.wa + P * HP + c] += col_total(P * HP + c);
          }
          __syncthreads();   // every product has read the A tile; the partials are read
          epilogue(std::true_type{}, st.hs[i], rg0, P);
        }
        unpark_all();
        stash_rows(a_p, st.g_pre[i], HID, rg0, tid);
        for (int c = tid; c < HID; c += kBwdThreads) vec[i * HID + c] += col_total(c);
        if (i > 0) product(Int<KS>{});
      }
    }
  }
}

// Sets the kernel's shared memory and launches it on a persistent grid.
template <class... A, class... B>
cudaError_t launch_tile(void (*kern)(A...), int grid, size_t bytes, cudaStream_t stream,
                        B... args) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return e;
  kern<<<grid, kBwdThreads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

template <int HID, bool kStash, int ENC>
cudaError_t launch_fwd_tile(const TrainParams& p, const Stash& st, int n_rays, int layer_num,
                            int F, int Fd, int S, float var_scale, int white_bg, float* rgb,
                            float* w, void* park, cudaStream_t stream) {
  const size_t bytes = FwdTileSmem<HID>::bytes(extras_width(Fd, p.app != nullptr));
  cudaError_t e;
  const int grid = persistent_grid(n_rays, &e);   // a ray a unit
  if (e != cudaSuccess) return e;
  if constexpr (HID == 512) {
    void (*kern)(TrainParams, Stash, int, int, int, int, int, float, int, float*, float*) =
        train_fwd_tile_kernel<HID, kStash, ENC>;
    return launch_tile(kern, grid, bytes, stream, p, st, layer_num, F, Fd, S, n_rays,
                       var_scale, white_bg, rgb, w);
  } else {
    void (*kern)(TrainParams, Stash, int, int, int, int, int, float, int, float*, float*,
                 uint32_t*) = train_fwd_tile_kernel<HID, kStash, ENC, uint32_t*>;
    return launch_tile(kern, grid, bytes, stream, p, st, layer_num, F, Fd, S, n_rays,
                       var_scale, white_bg, rgb, w, (uint32_t*)park);
  }
}

// Persistent grid: at most one block per SM and one vec_part row each (at
// most N / kTileRays); *parts gets the number of blocks.
template <int HID>
cudaError_t launch_bwd_tile(const TrainParams& p, const Stash& st, int n_rays, int layer_num,
                            int S, int white_bg, const float* g_rgb, const float* g_w,
                            int* parts, void* park, cudaStream_t stream) {
  const size_t bytes = BwdTileSmem<HID>::bytes();
  cudaError_t e;
  int grid = persistent_grid(n_rays, &e);
  if (e != cudaSuccess) return e;
  if (grid > n_rays / kTileRays) grid = n_rays / kTileRays;   // vec_part rows
  *parts = grid;
  if constexpr (HID == 512) {
    void (*kern)(TrainParams, Stash, int, int, int, int, const float*, const float*) =
        train_bwd_tile_kernel<HID>;
    return launch_tile(kern, grid, bytes, stream, p, st, layer_num, S, n_rays, white_bg,
                       g_rgb, g_w);
  } else {
    void (*kern)(TrainParams, Stash, int, int, int, int, const float*, const float*,
                 uint32_t*) = train_bwd_tile_kernel<HID, uint32_t*>;
    return launch_tile(kern, grid, bytes, stream, p, st, layer_num, S, n_rays, white_bg,
                       g_rgb, g_w, (uint32_t*)park);
  }
}

}  // namespace

// The instantiations at width H, 512 or 1024 (render_train_<H>.cu), and the
// forward's at the wide encoding (render_train_wide_<H>.cu).  park: the
// parked pass's scratch at 1024 (nm_render_train_scratch), else unused.
#define NM_RENDER_TRAIN_TILE(H)                                                \
  cudaError_t nm_train::train_fwd_##H(                                         \
      const TrainParams& p, const Stash& st, bool stash, int n_rays,            \
      int layer_num, int F, int Fd, int S, float var_scale, int white_bg,       \
      float* rgb, float* w, void* park, cudaStream_t stream) {                  \
    return (stash ? launch_fwd_tile<H, true, 3> : launch_fwd_tile<H, false, 3>)( \
        p, st, n_rays, layer_num, F, Fd, S, var_scale, white_bg, rgb, w, park,  \
        stream);                                                                \
  }                                                                            \
  cudaError_t nm_train::train_bwd_##H(                                         \
      const TrainParams& p, const Stash& st, int n_rays, int layer_num, int S,  \
      int white_bg, const float* g_rgb, const float* g_w, int* parts,           \
      void* park, cudaStream_t stream) {                                        \
    return launch_bwd_tile<H>(p, st, n_rays, layer_num, S, white_bg, g_rgb,    \
                              g_w, parts, park, stream);                        \
  }                                                                            \
  size_t nm_train::train_smem_##H(int ew, bool fwd) {                          \
    return fwd ? FwdTileSmem<H>::bytes(ew) : BwdTileSmem<H>::bytes();           \
  }
#define NM_RENDER_TRAIN_TILE_WIDE(H)                                           \
  cudaError_t nm_train::train_fwd_wide_##H(                                    \
      const TrainParams& p, const Stash& st, bool stash, int n_rays,            \
      int layer_num, int F, int Fd, int S, float var_scale, int white_bg,       \
      float* rgb, float* w, void* park, cudaStream_t stream) {                  \
    return (stash ? launch_fwd_tile<H, true, 4> : launch_fwd_tile<H, false, 4>)( \
        p, st, n_rays, layer_num, F, Fd, S, var_scale, white_bg, rgb, w, park,  \
        stream);                                                                \
  }
