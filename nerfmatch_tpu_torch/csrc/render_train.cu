// Fused mip-NeRF TRAIN render stage for Hopper (sm_90a): forward and
// hand-written backward, bf16 tensor-core MLP products, f32 elsewhere.
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
// and weights (N, S).  No early termination (training).  mma.sync over
// 64-row chunks of 2 rays (train_fwd_kernel).
//
// Backward (nm_render_train_backward), four launches:
//   1. train_fwd_kernel again, stashing every sample's bf16 activations
//      (the encoding, each trunk layer, feature, views) and an f32 record
//      (rgb, sigma_raw, alpha, transmittance) in a global workspace;
//   2. train_bwd_kernel, a persistent grid (at most one block an SM) of two
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
//   3. wgrad_gemm_kernel: every matrix-weight gradient,
//      sum over rows of bf16(act)^T bf16(g), as wgmma (both operands
//      MN-major in shared memory, the transpose bits set) on 128 x 256
//      output tiles (128 x 128 or x 64 for narrow N) of two warpgroups,
//      64-row stages in a 4-stage cp.async ring, split over 48 fixed row
//      ranges into partials;
//   4. reduce_parts_kernel: a fixed-order sum over the partials (matrix and
//      vector gradients).
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
// workspace and the weight gradients are a GEMM over it.  Launch 1 writes
// 6.0 GB (5,088 bytes a row), launch 2 reads 4,384 and writes 4,880 bytes
// a row (10.9 GB, 3.3 ms at 3.35 TB/s) for 1.3 TFLOP of products, and
// streams 1.1 MB of weights from L2 per 128 rows; launch 3 reads every
// product's operands once (12.7 GB with its partials, 3.8 ms) for 1.4
// TFLOP.  Both are bound by bytes, not by the tensor cores (1.3-1.4 ms at
// the bf16 peak).  chip_smoke.py phase 3b prints each launch's time beside
// its bytes; scripts/train_bwd_probe.py builds edited copies of this file
// without the products, the weight ring, the row copies or the column sums
// (and with fewer GEMM row ranges) and times them.
// -Xptxas -v (sm_90a, CUDA 12.8): train_bwd_kernel<256> 255 registers,
// 24 bytes of spill stores / 40 of loads, 223,880 bytes of dynamic shared
// memory (ring 128 KB, row buffer 66 KB, f32 sums 24 KB); <64> 117
// registers, no spills; wgrad_gemm_kernel 183 registers, no spills,
// 197,632 bytes (four 48 KB stages).  One block an SM for both.

#include <math.h>

#include "mma_common.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int kTileRays = 2;
constexpr int kSampleBlock = 32;
static_assert(kTileRays * kSampleBlock == kRows, "one chunk = 2 rays x 32");
constexpr int kMaxSamples = 256;
constexpr int kRecWidth = 8;      // f32 record per sample
constexpr int kGrgbWidth = 8;     // bf16 g_rgb_t row (3 used)
constexpr int kMaxProds = 2 * kMaxLayers + 4;
constexpr int kMaxSplits = 48;

struct TrainParams {
  const uint2* Wenc[kMaxLayers];  // encoding rows of layer i (in x out), or null
  const uint2* Wh[kMaxLayers];    // hidden rows of layer i (in x out), or null
  const __nv_bfloat16* WhT[kMaxLayers];  // same rows (out x in): slot images
  const float* b[kMaxLayers];
  const float* wa;    // (hid,) sigma head, f32
  const float* ba;    // (1,)
  const uint2* wf;    // feature head (hid, hid)
  const __nv_bfloat16* wfT;   // the same (out x in): slot images
  const float* bf;
  const uint2* wvh;   // views layer, hidden rows (hid, hv)
  const __nv_bfloat16* wvhT;  // the same (hv x hid): slot images
  const float* wvd;   // views layer, dirs rows (dirs_dim, hv), bf16 values
  const float* bv;
  const float* wr;    // rgb head (hv, 3), bf16 values
  const float* br;
  const float* rays;   // (N, 12) packed, unit-direction parameterization
  const float* z;      // (N, S + 1) fenceposts
  const float* noise;  // (N, S) density noise
};

// Workspace slots; sample row r = ray * S + s.  bf16 unless noted.
struct Stash {
  __nv_bfloat16* xb;               // (rows, kEncMax) encoding
  __nv_bfloat16* hs[kMaxLayers];   // (rows, HID) trunk activations
  __nv_bfloat16* feat;             // (rows, HID)
  __nv_bfloat16* hv;               // (rows, HV)
  float* rec;                      // (rows, 8) f32: rgb, sigma_raw, alpha, T
  __nv_bfloat16* extras;           // (N, kDirsMax) viewdir PE
  __nv_bfloat16* g_pre[kMaxLayers];
  __nv_bfloat16* g_feat;           // (rows, HID)
  __nv_bfloat16* g_hv;             // (rows, HV)
  __nv_bfloat16* g_rgb;            // (rows, 8): d loss / d rgb logits
  __nv_bfloat16* g_hvsum;          // (N, HV): per-ray sum of g_hv
  float* vec_part;                 // (N / kTileRays, P) f32
};

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

template <int HID>
struct FwdSmem {
  static constexpr int kActStride = HID + 8;
  static constexpr int HV = HID / 2;
  static size_t bytes() {
    return (size_t)kRows * kActStride * 2 + (size_t)kRows * kEncStride * 2 +
           (kRows * 8 + kRows * 4 + kRows + kWarps * kRows + kTileRays * HV +
            kTileRays * kDirsMax) * 4;
  }
};

template <int HID>
__global__ void __launch_bounds__(kThreads)
train_fwd_kernel(TrainParams p, Stash st, int stash, int layer_num, int F,
                 int Fd, int S, float var_scale, int white_bg, float* out_rgb,
                 float* out_w) {
  constexpr int NTT = HID / 8;
  constexpr int NT = NTT / kWarps;
  constexpr int HV = HID / 2;
  constexpr int NTTV = HV / 8;
  constexpr int NTV = NTTV >= kWarps ? NTTV / kWarps : 1;
  constexpr int kActStride = FwdSmem<HID>::kActStride;
  static_assert(NT >= 1 && NTT % kWarps == 0, "HID must be a multiple of 64");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* enc = act + kRows * kActStride;
  float* rowinfo = reinterpret_cast<float*>(enc + kRows * kEncStride);  // kRows * 8
  float* rgbs = rowinfo + kRows * 8;                                   // kRows * 4
  float* sig = rgbs + kRows * 4;                                       // kRows
  float* sigp = sig + kRows;                                           // kWarps * kRows
  float* xt = sigp + kWarps * kRows;                                   // kTileRays * HV
  float* dpe = xt + kTileRays * HV;                                    // kTileRays * kDirsMax
  __shared__ float carry[kTileRays], acc_s[kTileRays], rgb_s[kTileRays][3];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ray0 = blockIdx.x * kTileRays;
  const int enc_dim = 6 * F;
  const int enc_ksteps = (enc_dim + 15) / 16;
  const int dirs_dim = 6 * Fd + 3;
  const int nt0 = warp * NT;

  if (tid < kTileRays) {
    carry[tid] = acc_s[tid] = 0.f;
    rgb_s[tid][0] = rgb_s[tid][1] = rgb_s[tid][2] = 0.f;
  }
  for (int i = tid; i < kRows * (kEncMax - enc_dim); i += kThreads) {
    const int row = i / (kEncMax - enc_dim), j = enc_dim + i % (kEncMax - enc_dim);
    enc[row * kEncStride + j] = __float2bfloat16(0.f);
  }
  // View-direction PE per ray, rounded to bf16: [sin(2^f d) | cos | d].
  for (int i = tid; i < kTileRays * kDirsMax; i += kThreads) {
    const int r = i / kDirsMax, j = i % kDirsMax;
    const float* ray = p.rays + (size_t)(ray0 + r) * 12;
    float v = 0.f;
    if (j < 6 * Fd) {
      const int jj = j % (3 * Fd);
      const float x = ray[8 + jj % 3] * exp2f((float)(jj / 3));
      v = j < 3 * Fd ? sinf(x) : sinf(x + kHalfPi);
    } else if (j < dirs_dim) {
      v = ray[8 + j - 6 * Fd];
    }
    dpe[i] = bf16_round(v);
    if (stash) st.extras[(size_t)(ray0 + r) * kDirsMax + j] = __float2bfloat16(v);
  }
  __syncthreads();
  for (int i = tid; i < kTileRays * HV; i += kThreads) {
    const int r = i / HV, k = i % HV;
    float s = 0.f;
    for (int j = 0; j < dirs_dim; ++j)
      s = fmaf(dpe[r * kDirsMax + j], __ldg(p.wvd + (size_t)j * HV + k), s);
    xt[i] = s;
  }

  const int n_blocks = S / kSampleBlock;
  for (int sb = 0; sb < n_blocks; ++sb) {
    // ---- per-row frustum moments -> Gaussian mean / variance ----
    if (tid < kRows) {
      const int r = tid / kSampleBlock, s = sb * kSampleBlock + tid % kSampleBlock;
      const float* ray = p.rays + (size_t)(ray0 + r) * 12;
      const float* zr = p.z + (size_t)(ray0 + r) * (S + 1);
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
      float* info = rowinfo + tid * 8;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float d = ray[8 + c], d2 = d * d;
        info[c] = __fadd_rn(__fmul_rn(d, t_mean), ray[c]);
        info[3 + c] = t_var * d2 + r_var * (1.f - d2);
      }
      info[6] = t1 - t0;
      sig[tid] = p.noise[(size_t)(ray0 + r) * S + s];
    }
    __syncthreads();
    // ---- integrated positional encoding (f32, stored bf16) ----
    for (int i = tid; i < kRows * 3 * F; i += kThreads) {
      const int row = i / (3 * F), j = i % (3 * F);
      const int f = j / 3, c = j % 3;
      const float* info = rowinfo + row * 8;
      const float x = info[c] * exp2f((float)f);
      const float y = info[3 + c] * exp2f((float)(2 * f));
      const float damp = expf(-0.5f * y);
      const __nv_bfloat16 vs = __float2bfloat16(damp * sinf(x));
      const __nv_bfloat16 vc = __float2bfloat16(damp * sinf(x + kHalfPi));
      enc[row * kEncStride + j] = vs;
      enc[row * kEncStride + 3 * F + j] = vc;
      if (stash) {
        const size_t rg = (size_t)(ray0 + row / kSampleBlock) * S +
                          sb * kSampleBlock + row % kSampleBlock;
        st.xb[rg * kEncMax + j] = vs;
        st.xb[rg * kEncMax + 3 * F + j] = vc;
      }
    }
    if (stash) {
      for (int i = tid; i < kRows * (kEncMax - enc_dim); i += kThreads) {
        const int row = i / (kEncMax - enc_dim), j = enc_dim + i % (kEncMax - enc_dim);
        const size_t rg = (size_t)(ray0 + row / kSampleBlock) * S +
                          sb * kSampleBlock + row % kSampleBlock;
        st.xb[rg * kEncMax + j] = __float2bfloat16(0.f);
      }
    }
    __syncthreads();

    // ---- MLP trunk: bf16 mma, f32 accumulate, f32 bias + ReLU ----
    for (int i = 0; i < layer_num; ++i) {
      float acc[kMTiles][NT][4];
      zero_acc(acc);
      if (p.Wenc[i] != nullptr)
        mma_rows<NT>(enc, kEncStride, enc_ksteps, p.Wenc[i], NTT, nt0, lane, acc);
      if (p.Wh[i] != nullptr)
        mma_rows<NT>(act, kActStride, HID / 16, p.Wh[i], NTT, nt0, lane, acc);
      __syncthreads();  // every warp has read this layer's input
      const bool is_last = i == layer_num - 1;
#pragma unroll
      for (int m = 0; m < kMTiles; ++m) {
        float sp[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = frag_row(m, 2 * h, lane);
            const int col = frag_col(nt0 + j, 0, lane);
            const float v0 = fmaxf(acc[m][j][2 * h] + __ldg(p.b[i] + col), 0.f);
            const float v1 = fmaxf(acc[m][j][2 * h + 1] + __ldg(p.b[i] + col + 1), 0.f);
            const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
            *reinterpret_cast<__nv_bfloat162*>(act + row * kActStride + col) = v;
            if (stash) {
              const size_t rg = (size_t)(ray0 + row / kSampleBlock) * S +
                                sb * kSampleBlock + row % kSampleBlock;
              *reinterpret_cast<__nv_bfloat162*>(st.hs[i] + rg * HID + col) = v;
            }
            if (is_last)
              sp[h] = fmaf(v0, __ldg(p.wa + col), fmaf(v1, __ldg(p.wa + col + 1), sp[h]));
          }
        }
        if (is_last) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float s = sp[h];
            s += __shfl_xor_sync(0xffffffffu, s, 1);
            s += __shfl_xor_sync(0xffffffffu, s, 2);
            if ((lane & 3) == 0) sigp[warp * kRows + frag_row(m, 2 * h, lane)] = s;
          }
        }
      }
      __syncthreads();
    }

    // ---- sigma_raw = h . wa + ba + noise (f32 activations) ----
    if (tid < kRows) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += sigp[w * kRows + tid];
      sig[tid] += s + __ldg(p.ba);
    }

    // feature = h @ wf + bf (no activation), stored bf16
    {
      float acc[kMTiles][NT][4];
      zero_acc(acc);
      mma_rows<NT>(act, kActStride, HID / 16, p.wf, NTT, nt0, lane, acc);
      __syncthreads();
#pragma unroll
      for (int m = 0; m < kMTiles; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = frag_row(m, 2 * h, lane);
            const int col = frag_col(nt0 + j, 0, lane);
            const __nv_bfloat162 v = __floats2bfloat162_rn(
                acc[m][j][2 * h] + __ldg(p.bf + col),
                acc[m][j][2 * h + 1] + __ldg(p.bf + col + 1));
            *reinterpret_cast<__nv_bfloat162*>(act + row * kActStride + col) = v;
            if (stash) {
              const size_t rg = (size_t)(ray0 + row / kSampleBlock) * S +
                                sb * kSampleBlock + row % kSampleBlock;
              *reinterpret_cast<__nv_bfloat162*>(st.feat + rg * HID + col) = v;
            }
          }
      __syncthreads();
    }
    // views = relu(feature @ wvh + dirs_pe @ wvd + bv), stored bf16
    {
      const int ntv0 = warp * NTV;
      float acc[kMTiles][NTV][4];
      zero_acc(acc);
      const bool active = ntv0 < NTTV;
      if (active)
        mma_rows<NTV>(act, kActStride, HID / 16, p.wvh, NTTV, ntv0, lane, acc);
      __syncthreads();
      if (active) {
#pragma unroll
        for (int m = 0; m < kMTiles; ++m)
#pragma unroll
          for (int j = 0; j < NTV; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = frag_row(m, 2 * h, lane);
              const int col = frag_col(ntv0 + j, 0, lane);
              const float* x = xt + (row / kSampleBlock) * HV + col;
              const float v0 = fmaxf(acc[m][j][2 * h] + x[0] + __ldg(p.bv + col), 0.f);
              const float v1 = fmaxf(acc[m][j][2 * h + 1] + x[1] + __ldg(p.bv + col + 1), 0.f);
              const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
              *reinterpret_cast<__nv_bfloat162*>(act + row * kActStride + col) = v;
              if (stash) {
                const size_t rg = (size_t)(ray0 + row / kSampleBlock) * S +
                                  sb * kSampleBlock + row % kSampleBlock;
                *reinterpret_cast<__nv_bfloat162*>(st.hv + rg * HV + col) = v;
              }
            }
      }
      __syncthreads();
    }
    // rgb = sigmoid(views @ wr + br): bf16 operands, f32 FMA
    if (tid < kRows * 3) {
      const int row = tid / 3, c = tid % 3;
      float s = 0.f;
      for (int k = 0; k < HV; ++k)
        s = fmaf(__bfloat162float(act[row * kActStride + k]), __ldg(p.wr + k * 3 + c), s);
      s += __ldg(p.br + c);
      rgbs[row * 4 + c] = 1.f / (1.f + expf(-s));
    }
    __syncthreads();

    // ---- compositing: warp r takes ray r, lane = sample in the block ----
    if (warp < kTileRays) {
      const int r = warp, row = r * kSampleBlock + lane;
      const int s = sb * kSampleBlock + lane;
      const float dist = rowinfo[row * 8 + 6];
      const float sigma_raw = sig[row];
      const float alpha = 1.f - expf(-fmaxf(sigma_raw, 0.f) * dist);
      const float lt = logf(1.f - alpha + 1e-10f);
      float incl = lt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const float trans = expf(carry[r] + (incl - lt));
      const float w = alpha * trans;
      const size_t rg = (size_t)(ray0 + r) * S + s;
      out_w[rg] = w;
      const float asum = warp_sum(w);
      float cs[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) cs[c] = warp_sum(w * rgbs[row * 4 + c]);
      if (stash) {
        float* rec = st.rec + rg * kRecWidth;
        rec[0] = rgbs[row * 4 + 0];
        rec[1] = rgbs[row * 4 + 1];
        rec[2] = rgbs[row * 4 + 2];
        rec[3] = sigma_raw;
        rec[4] = alpha;
        rec[5] = trans;
      }
      const float total = __shfl_sync(0xffffffffu, incl, 31);
      if (lane == 0) {
        acc_s[r] += asum;
        for (int c = 0; c < 3; ++c) rgb_s[r][c] += cs[c];
        carry[r] += total;
      }
    }
    __syncthreads();
  }

  if (tid < kTileRays) {
    const int n = ray0 + tid;
    const float bg = white_bg ? 1.f - acc_s[tid] : 0.f;
    for (int c = 0; c < 3; ++c) out_rgb[n * 3 + c] = rgb_s[tid][c] + bg;
  }
}

// ===========================================================================
// Backward on the tensor cores: wgmma (sm_90a) on shared-memory operands
// ===========================================================================

// Operand tiles are blocks of 128-byte rows (64 bf16) in the 128-byte
// swizzle: byte offset of 16-byte chunk c (0..7) of row r of a block.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// wgmma shared-memory descriptor in the 128-byte swizzle: start address,
// leading byte offset `lbo` (MN-major: from one 64-element block of the M or
// N index to the next; not used K-major), stride byte offset 1024 (eight
// rows on).  Blocks start on 1024-byte boundaries.
__device__ __forceinline__ uint64_t desc128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         (64ull << 32) | (1ull << 62);
}

// ---- launch 2: heads and trunk backward, one 128-row chunk at a time ----

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

template <int N>
struct Int {
  static constexpr int value = N;
};

// Column sums over a warp's 16 rows.  v[2 j + e] holds this thread's two
// rows of column 8 j + 2 (lane % 4) + e; a reduce-scatter over the eight
// lanes of equal lane % 4 (K / 2 + K / 4 + K / 8 shuffles) leaves lane
// (g, t) the sums of j = K g / 16 .., stored to dst[column].
template <int M, int N>
__device__ __forceinline__ void fold_half(float* v, int lane) {
  const bool up = lane & M;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = up ? v[i] : v[i + N / 2];
    const float keep = up ? v[i + N / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

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

// ---- launch 3: weight gradients, C (M x N) = sum over rows of A[row]^T B[row]
//      (bf16 operands, f32 sums), one 128 x bn output tile per block and
//      row range ----

constexpr int kGemmThreads = 256;   // two warpgroups: output rows 0-63, 64-127
constexpr int kGemmStages = 4;
constexpr int kGemmK = 64;          // sample rows a stage
constexpr int kGemmBlock = kGemmK * 128;              // 64 rows x 64 bf16
constexpr int kGemmStageBytes = 6 * kGemmBlock;       // A: 2 blocks, B: up to 4
constexpr size_t kGemmSmem = 1024 + (size_t)kGemmStages * kGemmStageBytes;

struct Prod {
  const __nv_bfloat16* A;  // (rows, M) row-major, M % 8 == 0
  const __nv_bfloat16* B;  // (rows, N) row-major, N % 8 == 0
  int M, N, rows;
  long long out_off;       // into the (M x N) row-major output block
  int tile0, ntn, bn;      // first tile index, n-tiles, n-tile width
};
struct ProdTable {
  Prod p[kMaxProds];
  int count;
};

__global__ void __launch_bounds__(kGemmThreads, 1)
wgrad_gemm_kernel(ProdTable tab, long long total, float* __restrict__ part) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sm0 = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tile = blockIdx.x;
  int pi = 0;
  while (pi + 1 < tab.count && tile >= tab.p[pi + 1].tile0) ++pi;
  const Prod prod = tab.p[pi];
  const int lt = tile - prod.tile0, bn = prod.bn;
  const int m0 = (lt / prod.ntn) * 128, n0 = (lt % prod.ntn) * bn;
  int per = (prod.rows + gridDim.y - 1) / gridDim.y;
  per = (per + kGemmK - 1) / kGemmK * kGemmK;
  const int r0 = min(prod.rows, (int)blockIdx.y * per);
  const int r1 = min(prod.rows, r0 + per);
  const int nsl = (r1 - r0 + kGemmK - 1) / kGemmK;
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const bool active = m0 + 64 * wg < prod.M;
  const int bsh = bn == 256 ? 5 : bn == 128 ? 4 : 3;   // log2 16-byte chunks a B row

  // Stage s: rows r0 + 64 s .. of A (128 columns from m0) and B (bn from
  // n0), MN-major; columns past M / N and rows past r1 zero-filled.
  auto load = [&](int s) {
    const uint32_t sb = sm0 + (uint32_t)(s % kGemmStages) * kGemmStageBytes;
    const int rb = r0 + s * kGemmK;
#pragma unroll
    for (int i = tid; i < kGemmK * 16; i += kGemmThreads) {
      const int row = i >> 4, c = i & 15, gr = rb + row, col = m0 + c * 8;
      const bool ok = gr < r1 && col < prod.M;
      cp_async16(sb + (c >> 3) * kGemmBlock + swz(row, c & 7),
                 ok ? prod.A + (size_t)gr * prod.M + col : prod.A, ok);
    }
    for (int i = tid; i < (kGemmK << bsh); i += kGemmThreads) {
      const int row = i >> bsh, c = i & ((1 << bsh) - 1), gr = rb + row,
                col = n0 + c * 8;
      const bool ok = gr < r1 && col < prod.N;
      cp_async16(sb + (2 + (c >> 3)) * kGemmBlock + swz(row, c & 7),
                 ok ? prod.B + (size_t)gr * prod.N + col : prod.B, ok);
    }
  };

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < kGemmStages - 1; ++s) {
    if (s < nsl) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < nsl; ++s) {
    cp_async_wait<kGemmStages - 2>();
    fence_async();
    __syncthreads();   // stage s landed; every wgmma on stage s - 1 is done
    if (s + kGemmStages - 1 < nsl) load(s + kGemmStages - 1);
    cp_async_commit();
    if (active) {
      const uint32_t sb = sm0 + (uint32_t)(s % kGemmStages) * kGemmStageBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGemmK / 16; ++kk) {   // 16 rows on: 2048 bytes
        const uint64_t da = desc128(sb + wg * kGemmBlock + kk * 2048, kGemmBlock);
        const uint64_t db = desc128(sb + 2 * kGemmBlock + kk * 2048, kGemmBlock);
        if (bn == 256) wgmma_ss<256>(acc, da, db, 1);
        else if (bn == 128) wgmma_ss<128>(acc, da, db, 1);
        else wgmma_ss<64>(acc, da, db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
    }
  }
  cp_async_wait<0>();
  if (!active) return;
  float* out = part + (size_t)blockIdx.y * total + prod.out_off;
  const int row0 = m0 + 64 * wg + 16 * ((tid >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = n0 + 8 * j + 2 * (lane & 3);
    if (8 * j >= bn || col >= prod.N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < prod.M)
        *reinterpret_cast<float2*>(out + (size_t)row * prod.N + col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// out[j] = sum over p (in order) of part[p * width + j].
__global__ void reduce_parts_kernel(const float* __restrict__ part, int nparts,
                                    long long width, float* __restrict__ out) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= width) return;
  float s = 0.f;
  for (int q = 0; q < nparts; ++q) s += part[(size_t)q * width + j];
  out[j] = s;
}

// ---- host side ----
struct Dims {
  int n_rays, hid, layer_num, S;
  long long rows;
  int hv, splits;
  long long mat_total;
  VecLayout vl;
  Dims(int n, int h, int L, int s)
      : n_rays(n), hid(h), layer_num(L), S(s), rows((long long)n * s),
        hv(h / 2), vl(L, h) {
    splits = (int)(rows / 4096);
    splits = splits < 1 ? 1 : splits > kMaxSplits ? kMaxSplits : splits;
    // Worst case (every layer with encoding rows) bounds the matrix block.
    mat_total = (long long)L * (kEncMax * h + h * h) + h * h + h * hv +
                kDirsMax * hv + hv * kGrgbWidth;
  }
};

size_t align256(size_t b) { return (b + 255) & ~(size_t)255; }

// Carves the workspace; returns its size.  With base == nullptr only sizes.
size_t carve(const Dims& d, char* base, Stash* st, float** scratch_rgb,
             float** scratch_w, float** mat_part) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += align256(bytes);
    return p;
  };
  const size_t R = (size_t)d.rows, H = d.hid, HV = d.hv;
  Stash s{};
  s.xb = (__nv_bfloat16*)take(R * kEncMax * 2);
  for (int i = 0; i < d.layer_num; ++i) s.hs[i] = (__nv_bfloat16*)take(R * H * 2);
  s.feat = (__nv_bfloat16*)take(R * H * 2);
  s.hv = (__nv_bfloat16*)take(R * HV * 2);
  s.rec = (float*)take(R * kRecWidth * 4);
  s.extras = (__nv_bfloat16*)take((size_t)d.n_rays * kDirsMax * 2);
  for (int i = 0; i < d.layer_num; ++i) s.g_pre[i] = (__nv_bfloat16*)take(R * H * 2);
  s.g_feat = (__nv_bfloat16*)take(R * H * 2);
  s.g_hv = (__nv_bfloat16*)take(R * HV * 2);
  s.g_rgb = (__nv_bfloat16*)take(R * kGrgbWidth * 2);
  s.g_hvsum = (__nv_bfloat16*)take((size_t)d.n_rays * HV * 2);
  s.vec_part = (float*)take((size_t)(d.n_rays / kTileRays) * d.vl.P * 4);
  float* rgb = (float*)take((size_t)d.n_rays * 3 * 4);
  float* w = (float*)take(R * 4);
  float* mp = (float*)take((size_t)d.splits * d.mat_total * 4);
  if (st) *st = s;
  if (scratch_rgb) *scratch_rgb = rgb;
  if (scratch_w) *scratch_w = w;
  if (mat_part) *mat_part = mp;
  return off;
}

// S: one 64-row half of a backward chunk, or whole 128-row chunks.
bool bad_dims(int n_rays, int hid, int layer_num, int F, int Fd, int S) {
  return layer_num < 1 || layer_num > kMaxLayers || 6 * F > kEncMax ||
         6 * Fd + 3 > kDirsMax || n_rays % kTileRays != 0 ||
         (S != kRows && S % kChunkRows != 0) || S < kRows ||
         S > kMaxSamples || (hid != 64 && hid != 256);
}

void unpack(const void* const* ptrs, int layer_num, TrainParams* p) {
  int k = 0;
  for (int i = 0; i < kMaxLayers; ++i) {
    const bool live = i < layer_num;
    p->Wenc[i] = live ? (const uint2*)ptrs[k++] : nullptr;
    p->Wh[i] = live ? (const uint2*)ptrs[k++] : nullptr;
    p->WhT[i] = live ? (const __nv_bfloat16*)ptrs[k++] : nullptr;
    p->b[i] = live ? (const float*)ptrs[k++] : nullptr;
  }
  p->wa = (const float*)ptrs[k++];
  p->ba = (const float*)ptrs[k++];
  p->wf = (const uint2*)ptrs[k++];
  p->wfT = (const __nv_bfloat16*)ptrs[k++];
  p->bf = (const float*)ptrs[k++];
  p->wvh = (const uint2*)ptrs[k++];
  p->wvhT = (const __nv_bfloat16*)ptrs[k++];
  p->wvd = (const float*)ptrs[k++];
  p->bv = (const float*)ptrs[k++];
  p->wr = (const float*)ptrs[k++];
  p->br = (const float*)ptrs[k++];
  p->rays = (const float*)ptrs[k++];
  p->z = (const float*)ptrs[k++];
  p->noise = (const float*)ptrs[k++];
}

template <int HID>
cudaError_t launch_fwd(const TrainParams& p, const Stash& st, int stash,
                       int n_rays, int layer_num, int F, int Fd, int S,
                       float var_scale, int white_bg, float* rgb, float* w,
                       cudaStream_t stream) {
  const size_t bytes = FwdSmem<HID>::bytes();
  auto kern = train_fwd_kernel<HID>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  kern<<<n_rays / kTileRays, kThreads, bytes, stream>>>(
      p, st, stash, layer_num, F, Fd, S, var_scale, white_bg, rgb, w);
  return cudaGetLastError();
}

// Persistent grid: at most one block per SM (and one vec_part row each);
// *parts gets the number of blocks, the rows the vector reduction sums.
template <int HID>
cudaError_t launch_bwd(const TrainParams& p, const Stash& st, int n_rays,
                       int layer_num, int S, int white_bg, const float* g_rgb,
                       const float* g_w, int* parts, cudaStream_t stream) {
  const size_t bytes = BwdSmem<HID>::bytes(VecLayout(layer_num, HID).P);
  auto kern = train_bwd_kernel<HID>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return e;
  const int units = S >= kChunkRows ? n_rays : n_rays * S / kChunkRows;
  int grid = units < sms ? units : sms;
  if (grid > n_rays / kTileRays) grid = n_rays / kTileRays;   // vec_part rows
  *parts = grid;
  kern<<<grid, kBwdThreads, bytes, stream>>>(p, st, layer_num, S, n_rays,
                                             white_bg, g_rgb, g_w);
  return cudaGetLastError();
}

}  // namespace

// ptrs: host array of 4 * layer_num + 14 device pointers, in the order
// (Wenc_i, Wh_i, WhT_i, b_i) for each layer i, then wa, ba, wf, wfT, bf,
// wvh, wvhT, wvd, bv, wr, br, rays, z, noise (Wenc_i / Wh_i / WhT_i null
// where layer i has no such rows).  Wenc_i, Wh_i, wf, wvh: mma.sync
// fragments of the (in x out) rows (render_kernel.py: pack_fragments);
// WhT_i, wfT, wvhT: the same rows, bf16 (out x in), as the backward's ring
// slot images (render_train_kernel.py: slot_images).
extern "C" int nm_render_train_forward(const void* const* ptrs, int n_rays,
                                       int hid, int layer_num, int num_freqs,
                                       int dirs_freqs, int samples,
                                       float var_scale, int white_bg,
                                       void* out_rgb, void* out_w,
                                       void* stream) {
  if (bad_dims(n_rays, hid, layer_num, num_freqs, dirs_freqs, samples))
    return (int)cudaErrorInvalidValue;
  TrainParams p;
  unpack(ptrs, layer_num, &p);
  Stash st{};
  cudaStream_t s = (cudaStream_t)stream;
  if (hid == 64)
    return (int)launch_fwd<64>(p, st, 0, n_rays, layer_num, num_freqs,
                               dirs_freqs, samples, var_scale, white_bg,
                               (float*)out_rgb, (float*)out_w, s);
  return (int)launch_fwd<256>(p, st, 0, n_rays, layer_num, num_freqs,
                              dirs_freqs, samples, var_scale, white_bg,
                              (float*)out_rgb, (float*)out_w, s);
}

// Workspace bytes for nm_render_train_backward (written to *out_bytes, a
// host int64), and the matrix-gradient block size (*out_mat, int64).
extern "C" int nm_render_train_workspace(int n_rays, int hid, int layer_num,
                                         int samples, void* out_bytes,
                                         void* out_mat) {
  const Dims d(n_rays, hid, layer_num, samples);
  *(long long*)out_bytes = (long long)carve(d, nullptr, nullptr, nullptr,
                                            nullptr, nullptr);
  *(long long*)out_mat = d.mat_total;
  return 0;
}

// g_rgb (N, 3), g_w (N, S) f32 cotangents.  grad_mat: the matrix-weight
// gradients, f32 sums in (in x out) layout, one block per product in this
// order: per layer i, [encoding rows (kEncMax x hid) if the layer has them]
// [hidden rows (hid x hid) if i > 0]; then wf (hid x hid), wvh (hid x hv),
// wvd (kDirsMax x hv), wr (hv x 8).  grad_vec: P floats, the VecLayout.
extern "C" int nm_render_train_backward(const void* const* ptrs, int n_rays,
                                        int hid, int layer_num, int num_freqs,
                                        int dirs_freqs, int samples,
                                        float var_scale, int white_bg,
                                        const void* g_rgb, const void* g_w,
                                        void* workspace, void* grad_mat,
                                        void* grad_vec, void* stream) {
  if (bad_dims(n_rays, hid, layer_num, num_freqs, dirs_freqs, samples))
    return (int)cudaErrorInvalidValue;
  TrainParams p;
  unpack(ptrs, layer_num, &p);
  const Dims d(n_rays, hid, layer_num, samples);
  Stash st;
  float *rgb, *w, *mat_part;
  carve(d, (char*)workspace, &st, &rgb, &w, &mat_part);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  int parts = 0;
  if (hid == 64) {
    e = launch_fwd<64>(p, st, 1, n_rays, layer_num, num_freqs, dirs_freqs,
                       samples, var_scale, white_bg, rgb, w, s);
    if (e == cudaSuccess)
      e = launch_bwd<64>(p, st, n_rays, layer_num, samples, white_bg,
                         (const float*)g_rgb, (const float*)g_w, &parts, s);
  } else {
    e = launch_fwd<256>(p, st, 1, n_rays, layer_num, num_freqs, dirs_freqs,
                        samples, var_scale, white_bg, rgb, w, s);
    if (e == cudaSuccess)
      e = launch_bwd<256>(p, st, n_rays, layer_num, samples, white_bg,
                          (const float*)g_rgb, (const float*)g_w, &parts, s);
  }
  if (e != cudaSuccess) return (int)e;

  ProdTable t{};
  long long off = 0;
  int tiles = 0;
  auto add = [&](const __nv_bfloat16* A, int M, const __nv_bfloat16* B, int N,
                 int rows) {
    Prod& q = t.p[t.count++];
    q.A = A;
    q.B = B;
    q.M = M;
    q.N = N;
    q.rows = rows;
    q.out_off = off;
    q.tile0 = tiles;
    q.bn = N >= 256 ? 256 : N > 64 ? 128 : 64;
    q.ntn = (N + q.bn - 1) / q.bn;
    tiles += ((M + 127) / 128) * q.ntn;
    off += (long long)M * N;
  };
  const int R = (int)d.rows, H = hid, HV = d.hv;
  for (int i = 0; i < layer_num; ++i) {
    if (p.Wenc[i] != nullptr) add(st.xb, kEncMax, st.g_pre[i], H, R);
    if (i > 0) add(st.hs[i - 1], H, st.g_pre[i], H, R);
  }
  add(st.hs[layer_num - 1], H, st.g_feat, H, R);
  add(st.feat, H, st.g_hv, HV, R);
  add(st.extras, kDirsMax, st.g_hvsum, HV, n_rays);
  add(st.hv, HV, st.g_rgb, kGrgbWidth, R);
  e = cudaFuncSetAttribute(wgrad_gemm_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kGemmSmem);
  if (e != cudaSuccess) return (int)e;
  wgrad_gemm_kernel<<<dim3(tiles, d.splits), kGemmThreads, kGemmSmem, s>>>(
      t, d.mat_total, mat_part);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  reduce_parts_kernel<<<(unsigned)((off + 255) / 256), 256, 0, s>>>(
      mat_part, d.splits, d.mat_total, (float*)grad_mat);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  reduce_parts_kernel<<<(d.vl.P + 255) / 256, 256, 0, s>>>(
      st.vec_part, parts, d.vl.P, (float*)grad_vec);
  return (int)cudaGetLastError();
}
