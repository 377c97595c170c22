// Fused mip-NeRF render stage for Hopper (sm_90a): bf16 tensor-core MLP,
// f32 everywhere else.
//
// Replaces the TPU kernel nerfmatch_tpu/ops/pallas/render_kernel.py:
// make_fused_render (bodies blocked_body / kernel), driven twice per ray
// batch by make_fused_hierarchical: a coarse variant (weights, depth, acc)
// and a fine variant (+ rgb, the composited layer-`feat_layer` descriptor
// and the composited 3D point).
//
// Per ray: conical-frustum moments from the z fenceposts -> integrated
// positional encoding -> 8 x HID MLP (skip concat after the skip layer) ->
// sigma [-> feature -> views -> sigmoid rgb] -> alpha compositing with a
// log-transmittance prefix sum carried across z-ordered blocks of 32
// samples.  Early termination: once every ray of the block's tile has
// transmittance < eps (log T < log_eps), the remaining sample blocks are
// skipped and their weights written as exact zeros (the JAX kernel's
// semantics; skipped weights are < eps).
//
// Precision, as in the JAX kernel: the MLP's matrix products take bf16
// operands (the encoding, the hidden activations, the weights) and
// accumulate in f32 (mma.sync m16n8k16); biases, ReLU, the sigma head, the
// descriptor tap, the frustum / encoding phases, transmittance and every
// composited output stay f32.  The dirs part of the views layer and the
// rgb head run in f32 FMA (per ray, and 3 columns).
//
// What bounds it on the H100: the MLP, ~1.2 MFLOP per sample per stage
// (1.4 TFLOP per 9216-ray fine stage), so the trunk runs on the tensor
// cores.  Design: one block of 256 threads (8 warps) per tile of 2 rays;
// each 32-sample block of the tile is one 64-row chunk.  Activations
// (64 x HID bf16) and the encoding stay in shared memory; each warp owns
// HID/8 output columns of every row, loads A with ldmatrix and its weight
// fragments straight from global memory (packed on the host in mma
// fragment order, one 8-byte load per lane; 128 KB per bf16 layer, read
// once per chunk by the block and L2-resident).  Later work: wgmma with
// TMA-staged weights and larger row tiles.

#include <math.h>

#include "mma_common.cuh"

namespace {

constexpr int kTileRays = 2;
constexpr int kSampleBlock = 32;
static_assert(kTileRays * kSampleBlock == kRows, "one chunk = 2 rays x 32");

// Weight fragments in the layout of mma_common.cuh.
struct RenderParams {
  const uint2* Wenc[kMaxLayers];  // encoding rows of layer i, or null
  const uint2* Wh[kMaxLayers];    // hidden rows of layer i, or null
  const float* b[kMaxLayers];
  const float* wa;   // (hid,)  sigma head, f32
  const float* ba;   // (1,)
  const uint2* wf;   // feature head, fragments (hid, hid)
  const float* bf;
  const uint2* wvh;  // views layer, hidden rows, fragments (hid, hid/2)
  const float* wvd;  // views layer, dirs rows, f32 (dirs_dim, hid/2)
  const float* bv;
  const float* wr;   // rgb head, f32 (hid/2, 3)
  const float* br;
  const float* rays;  // (N, 12) packed, unit-direction parameterization
  const float* z;     // (N, S + 1) fenceposts
};

template <int HID>
struct Smem {
  static constexpr int kActStride = HID + 8;  // bf16; conflict-free ldmatrix
  static constexpr int kTapStride = HID + 8;  // f32
  static constexpr int HV = HID / 2;
  static size_t bytes(bool fine) {
    return (size_t)kRows * kActStride * 2 + (size_t)kRows * kEncStride * 2 +
           ((fine ? (size_t)kRows * kTapStride : 0) + kRows * 8 + kRows * 4 +
            2 * kRows + kWarps * kRows + kTileRays * HV +
            kTileRays * kDirsMax + kTileRays * HID) * 4;
  }
};

template <int HID, bool FINE>
__global__ void __launch_bounds__(kThreads)
render_kernel(RenderParams p, int layer_num, int feat_layer, int F, int Fd,
              int S, float var_scale, float log_eps, int white_bg,
              float* out_w, float* out_depth, float* out_acc, float* out_rgb,
              float* out_feat, float* out_pts) {
  constexpr int NTT = HID / 8;                   // n-tiles of a hidden layer
  constexpr int NT = NTT / kWarps;               // per warp
  constexpr int HV = HID / 2;
  constexpr int NTTV = HV / 8;                   // n-tiles of the views layer
  constexpr int NTV = NTTV >= kWarps ? NTTV / kWarps : 1;
  constexpr int kActStride = Smem<HID>::kActStride;
  constexpr int kTapStride = Smem<HID>::kTapStride;
  static_assert(NT >= 1 && NTT % kWarps == 0, "HID must be a multiple of 64");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* enc = act + kRows * kActStride;
  float* tap = reinterpret_cast<float*>(enc + kRows * kEncStride);
  float* rowinfo = tap + (FINE ? kRows * kTapStride : 0);  // kRows * 8
  float* rgbs = rowinfo + kRows * 8;                       // kRows * 4
  float* sig = rgbs + kRows * 4;                           // kRows
  float* wts = sig + kRows;                                // kRows
  float* sigp = wts + kRows;                               // kWarps * kRows
  float* xt = sigp + kWarps * kRows;                       // kTileRays * HV
  float* dpe = xt + kTileRays * HV;                        // kTileRays * kDirsMax
  float* facc = dpe + kTileRays * kDirsMax;                // kTileRays * HID
  __shared__ float carry[kTileRays], acc_s[kTileRays], depth_s[kTileRays],
      tw_s[kTileRays], rgb_s[kTileRays][3];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ray0 = blockIdx.x * kTileRays;
  const int enc_dim = 6 * F;
  const int enc_ksteps = (enc_dim + 15) / 16;
  const int dirs_dim = 6 * Fd + 3;
  const int nt0 = warp * NT;

  if (tid < kTileRays) {
    carry[tid] = 0.f;
    acc_s[tid] = 0.f;
    depth_s[tid] = 0.f;
    tw_s[tid] = 0.f;
    rgb_s[tid][0] = rgb_s[tid][1] = rgb_s[tid][2] = 0.f;
  }
  // Zero the encoding's K padding once; the encoding never writes it.
  for (int i = tid; i < kRows * (kEncMax - enc_dim); i += kThreads) {
    const int row = i / (kEncMax - enc_dim), j = enc_dim + i % (kEncMax - enc_dim);
    enc[row * kEncStride + j] = __float2bfloat16(0.f);
  }
  if (FINE) {
    for (int i = tid; i < kTileRays * HID; i += kThreads) facc[i] = 0.f;
    // View-direction PE per ray: [sin(2^f d) | sin(2^f d + pi/2) | d].
    for (int i = tid; i < kTileRays * dirs_dim; i += kThreads) {
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
  }
  __syncthreads();
  if (FINE) {
    // Per-ray view contribution of the views layer: dirs_pe @ wvd (f32).
    for (int i = tid; i < kTileRays * HV; i += kThreads) {
      const int r = i / HV, k = i % HV;
      float s = 0.f;
      for (int j = 0; j < dirs_dim; ++j)
        s = fmaf(dpe[r * kDirsMax + j], __ldg(p.wvd + (size_t)j * HV + k), s);
      xt[i] = s;
    }
  }

  const int n_blocks = S / kSampleBlock;
  for (int sb = 0; sb < n_blocks; ++sb) {
    if (sb > 0) {
      bool dead = true;
#pragma unroll
      for (int r = 0; r < kTileRays; ++r) dead = dead && (carry[r] < log_eps);
      if (__syncthreads_and(dead)) {
        const int nb = S - sb * kSampleBlock;
        for (int i = tid; i < kTileRays * nb; i += kThreads) {
          const int r = i / nb, s = sb * kSampleBlock + i % nb;
          out_w[(size_t)(ray0 + r) * S + s] = 0.f;
        }
        break;
      }
    }
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
      const float dx = ray[8], dy = ray[9], dz = ray[10];
      const float dmag = fmaxf(1e-10f, dx * dx + dy * dy + dz * dz);
      float* info = rowinfo + tid * 8;
      const float d[3] = {dx, dy, dz};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float d2 = d[c] * d[c];
        info[c] = __fadd_rn(__fmul_rn(d[c], t_mean), ray[c]);
        info[3 + c] = t_var * d2 + r_var * (1.f - d2 / dmag);
      }
      info[6] = t_mean;
      info[7] = mu;
    }
    __syncthreads();
    // ---- integrated positional encoding (f32, stored bf16):
    //      [sin block | cos block] ----
    for (int i = tid; i < kRows * 3 * F; i += kThreads) {
      const int row = i / (3 * F), j = i % (3 * F);
      const int f = j / 3, c = j % 3;
      const float* info = rowinfo + row * 8;
      const float x = info[c] * exp2f((float)f);
      const float y = info[3 + c] * exp2f((float)(2 * f));
      const float damp = expf(-0.5f * y);
      enc[row * kEncStride + j] = __float2bfloat16(damp * sinf(x));
      enc[row * kEncStride + 3 * F + j] = __float2bfloat16(damp * sinf(x + kHalfPi));
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
      const bool is_tap = FINE && i == feat_layer;
      const bool is_last = i == layer_num - 1;
#pragma unroll
      for (int m = 0; m < kMTiles; ++m) {
        float sp[2] = {0.f, 0.f};  // sigma partials of rows g and g + 8
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = frag_row(m, 2 * h, lane);
            const int col = frag_col(nt0 + j, 0, lane);
            const float v0 = fmaxf(acc[m][j][2 * h] + __ldg(p.b[i] + col), 0.f);
            const float v1 = fmaxf(acc[m][j][2 * h + 1] + __ldg(p.b[i] + col + 1), 0.f);
            *reinterpret_cast<__nv_bfloat162*>(act + row * kActStride + col) =
                __floats2bfloat162_rn(v0, v1);
            if (is_tap)
              *reinterpret_cast<float2*>(tap + row * kTapStride + col) =
                  make_float2(v0, v1);
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

    // ---- sigma head (f32, from the f32 activations) ----
    if (tid < kRows) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += sigp[w * kRows + tid];
      sig[tid] = s + __ldg(p.ba);
    }

    if (FINE) {
      // feature = h @ wf + bf (no activation)
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
              *reinterpret_cast<__nv_bfloat162*>(act + row * kActStride + col) =
                  __floats2bfloat162_rn(acc[m][j][2 * h] + __ldg(p.bf + col),
                                        acc[m][j][2 * h + 1] + __ldg(p.bf + col + 1));
            }
        __syncthreads();
      }
      // views = relu(feature @ wvh + dirs_pe @ wvd + bv)
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
                *reinterpret_cast<__nv_bfloat162*>(act + row * kActStride + col) =
                    __floats2bfloat162_rn(v0, v1);
              }
        }
        __syncthreads();
      }
      // rgb = sigmoid(views @ wr + br), f32 FMA over the bf16 views
      if (tid < kRows * 3) {
        const int row = tid / 3, c = tid % 3;
        float s = 0.f;
        for (int k = 0; k < HV; ++k)
          s = fmaf(__bfloat162float(act[row * kActStride + k]), __ldg(p.wr + k * 3 + c), s);
        s += __ldg(p.br + c);
        rgbs[row * 4 + c] = 1.f / (1.f + expf(-s));
      }
    }
    __syncthreads();

    // ---- compositing: warp r takes ray r, lane = sample in the block ----
    if (warp < kTileRays) {
      const int r = warp, row = r * kSampleBlock + lane;
      const int s = sb * kSampleBlock + lane;
      const float* zr = p.z + (size_t)(ray0 + r) * (S + 1);
      const float dist = zr[s + 1] - zr[s];
      const float sigma = fmaxf(sig[row], 0.f);
      const float alpha = 1.f - expf(-sigma * dist);
      const float lt = logf(1.f - alpha + 1e-10f);
      float incl = lt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const float excl = incl - lt;
      const float w = alpha * expf(carry[r] + excl);
      out_w[(size_t)(ray0 + r) * S + s] = w;
      wts[row] = w;
      const float* info = rowinfo + row * 8;
      const float dsum = warp_sum(w * info[7]);
      const float asum = warp_sum(w);
      const float tsum = warp_sum(w * info[6]);
      float cs[3] = {0.f, 0.f, 0.f};
      if (FINE) {
#pragma unroll
        for (int c = 0; c < 3; ++c) cs[c] = warp_sum(w * rgbs[row * 4 + c]);
      }
      const float total = __shfl_sync(0xffffffffu, incl, 31);
      if (lane == 0) {
        depth_s[r] += dsum;
        acc_s[r] += asum;
        tw_s[r] += tsum;
        if (FINE)
          for (int c = 0; c < 3; ++c) rgb_s[r][c] += cs[c];
        carry[r] += total;
      }
    }
    __syncthreads();
    if (FINE) {
      for (int i = tid; i < kTileRays * HID; i += kThreads) {
        const int r = i / HID, c = i % HID;
        float s = 0.f;
        for (int k = 0; k < kSampleBlock; ++k) {
          const int row = r * kSampleBlock + k;
          s = fmaf(wts[row], tap[row * kTapStride + c], s);
        }
        facc[i] += s;
      }
    }
    __syncthreads();
  }

  // ---- per-ray outputs ----
  if (tid < kTileRays) {
    const int r = tid, n = ray0 + r;
    const float* ray = p.rays + (size_t)n * 12;
    out_depth[n] = depth_s[r];
    out_acc[n] = acc_s[r];
    if (FINE) {
      const float bg = white_bg ? 1.f - acc_s[r] : 0.f;
      for (int c = 0; c < 3; ++c) {
        out_rgb[n * 3 + c] = rgb_s[r][c] + bg;
        out_pts[n * 3 + c] = ray[c] * acc_s[r] + ray[8 + c] * tw_s[r];
      }
    }
  }
  if (FINE) {
    for (int i = tid; i < kTileRays * HID; i += kThreads)
      out_feat[(size_t)ray0 * HID + i] = facc[i];
  }
}

template <int HID, bool FINE>
cudaError_t launch(const RenderParams& p, int n_rays, int layer_num,
                   int feat_layer, int F, int Fd, int S, float var_scale,
                   float log_eps, int white_bg, float* w, float* depth,
                   float* acc, float* rgb, float* feat, float* pts,
                   cudaStream_t stream) {
  const size_t bytes = Smem<HID>::bytes(FINE);
  auto kern = render_kernel<HID, FINE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  const int grid = n_rays / kTileRays;
  kern<<<grid, kThreads, bytes, stream>>>(p, layer_num, feat_layer, F, Fd, S,
                                          var_scale, log_eps, white_bg, w,
                                          depth, acc, rgb, feat, pts);
  return cudaGetLastError();
}

}  // namespace

// ptrs: host array of 3 * layer_num + 11 device pointers, in the order
// Wenc0, Wh0, b0, ..., Wenc{L-1}, Wh{L-1}, b{L-1}, wa, ba, wf, bf, wvh, wvd,
// bv, wr, br, rays, z (Wenc_i / Wh_i null where layer i has no such rows).
extern "C" int nm_render_forward(const void* const* ptrs, int n_rays, int hid,
                                 int layer_num, int feat_layer, int num_freqs,
                                 int dirs_freqs, int samples, float var_scale,
                                 float log_eps, int white_bg, int fine,
                                 void* out_w, void* out_depth, void* out_acc,
                                 void* out_rgb, void* out_feat, void* out_pts,
                                 void* stream) {
  if (layer_num < 1 || layer_num > kMaxLayers || 6 * num_freqs > kEncMax ||
      6 * dirs_freqs + 3 > kDirsMax || n_rays % kTileRays != 0 ||
      samples % kSampleBlock != 0)
    return (int)cudaErrorInvalidValue;
  RenderParams p;
  int k = 0;
  for (int i = 0; i < layer_num; ++i) {
    p.Wenc[i] = (const uint2*)ptrs[k++];
    p.Wh[i] = (const uint2*)ptrs[k++];
    p.b[i] = (const float*)ptrs[k++];
  }
  for (int i = layer_num; i < kMaxLayers; ++i) {
    p.Wenc[i] = p.Wh[i] = nullptr;
    p.b[i] = nullptr;
  }
  p.wa = (const float*)ptrs[k++];
  p.ba = (const float*)ptrs[k++];
  p.wf = (const uint2*)ptrs[k++];
  p.bf = (const float*)ptrs[k++];
  p.wvh = (const uint2*)ptrs[k++];
  p.wvd = (const float*)ptrs[k++];
  p.bv = (const float*)ptrs[k++];
  p.wr = (const float*)ptrs[k++];
  p.br = (const float*)ptrs[k++];
  p.rays = (const float*)ptrs[k++];
  p.z = (const float*)ptrs[k++];
  float* w = (float*)out_w;
  float* depth = (float*)out_depth;
  float* acc = (float*)out_acc;
  float* rgb = (float*)out_rgb;
  float* feat = (float*)out_feat;
  float* pts = (float*)out_pts;
  cudaStream_t s = (cudaStream_t)stream;
#define NM_RENDER_CASE(H)                                                     \
  if (hid == H)                                                               \
    return (int)(fine ? launch<H, true>(p, n_rays, layer_num, feat_layer,     \
                                        num_freqs, dirs_freqs, samples,       \
                                        var_scale, log_eps, white_bg, w,      \
                                        depth, acc, rgb, feat, pts, s)        \
                      : launch<H, false>(p, n_rays, layer_num, feat_layer,    \
                                         num_freqs, dirs_freqs, samples,      \
                                         var_scale, log_eps, white_bg, w,     \
                                         depth, acc, rgb, feat, pts, s));
  NM_RENDER_CASE(64)
  NM_RENDER_CASE(256)
#undef NM_RENDER_CASE
  return (int)cudaErrorInvalidValue;
}
