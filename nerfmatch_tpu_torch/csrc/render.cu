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
//
// INT8 = true: the int8 serving trunk, replacing the trunk_int8 branch of
// the same TPU kernel (render_kernel.py, blocked_body) and the weights of
// nerfmatch_tpu/ops/pallas/quant.py (packed by ops/kernels/quant.py).
// Trunk layers from int8_from on run mma.sync m16n8k32 s8 x s8 -> s32 on
// int8 activations held in shared memory (64 x HID, plus the 64 x 96
// quantized encoding); the f32 epilogue keeps the JAX order and rounding
// (acc * c, then + acc_s * c_s, then + B, no FMA contraction; round half
// even for the encoding and the posttap boundary, truncation after
// max(y, 0.5) for hidden layers), so the integer activations equal the
// plain version's.  The post-skip layer's two products (hidden rows and
// encoding rows) keep separate accumulators and scale rows; each int8
// layer runs in two halves of 32 rows to keep both in registers.  Layers
// below int8_from, the heads and compositing are the bf16 kernel's.  What
// bounds it: the trunk's ~1.19 T int8 operations per 9216-ray coarse
// stage, ~0.60 ms at 1,979 TOPS.  Later work: wgmma s8 with TMA-staged
// weights.

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

// The int8 trunk (quant.py: pack_mlp_int8), layers int8_from .. L - 1.
struct QuantParams {
  const uint2* W[kMaxLayers];    // int8 fragments (layer 0: encoding rows)
  const uint2* Ws[kMaxLayers];   // post-skip layer's encoding rows, or null
  const float* scale[kMaxLayers];    // c_i (q-domain), s_L (last layer)
  const float* scale_s[kMaxLayers];  // the same for the encoding rows
  const float* bias[kMaxLayers];     // B_i = b_i q_i + 0.5, b_L
  const float* qenc;  // (kEncMax,) encoding requant row
  const float* qh;    // (HID,) posttap boundary requant row, or null
  const float* iq;    // (HID,) real units of the tap layer, or null
};

constexpr int kEncQStride = kEncMax + 16;  // int8; conflict-free ldmatrix

template <int HID>
struct Smem {
  static constexpr int kActStride = HID + 8;  // bf16; conflict-free ldmatrix
  static constexpr int kTapStride = HID + 8;  // f32
  static constexpr int kActQStride = HID + 16;  // int8
  static constexpr int HV = HID / 2;
  static size_t bytes(bool fine, bool int8) {
    return (size_t)kRows * kActStride * 2 + (size_t)kRows * kEncStride * 2 +
           ((fine ? (size_t)kRows * kTapStride : 0) + kRows * 8 + kRows * 4 +
            2 * kRows + kWarps * kRows + kTileRays * HV +
            kTileRays * kDirsMax + kTileRays * HID) * 4 +
           (int8 ? (size_t)kRows * (kActQStride + kEncQStride) : 0);
  }
};

// clip(round_half_even(x), -127, 127)
__device__ __forceinline__ signed char sat_rn(float x) {
  return (signed char)max(-127, min(127, __float2int_rn(x)));
}

template <int HID, bool FINE, bool INT8>
__global__ void __launch_bounds__(kThreads)
render_kernel(RenderParams p, QuantParams q, int layer_num, int feat_layer,
              int int8_from, int F, int Fd, int S, float var_scale,
              float log_eps, int white_bg, float* out_w, float* out_depth,
              float* out_acc, float* out_rgb, float* out_feat, float* out_pts,
              int8_t* dbg) {
  constexpr int NTT = HID / 8;                   // n-tiles of a hidden layer
  constexpr int NT = NTT / kWarps;               // per warp
  constexpr int HV = HID / 2;
  constexpr int NTTV = HV / 8;                   // n-tiles of the views layer
  constexpr int NTV = NTTV >= kWarps ? NTTV / kWarps : 1;
  constexpr int kActStride = Smem<HID>::kActStride;
  constexpr int kTapStride = Smem<HID>::kTapStride;
  constexpr int kActQStride = Smem<HID>::kActQStride;
  constexpr int kDbg = kEncMax + HID;            // debug row: [xq | hq]
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
  int8_t* actq = reinterpret_cast<int8_t*>(facc + kTileRays * HID);
  int8_t* encq = actq + kRows * kActQStride;               // INT8 only
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
    if (INT8) encq[row * kEncQStride + j] = 0;
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
      const float vs = damp * sinf(x), vc = damp * sinf(x + kHalfPi);
      enc[row * kEncStride + j] = __float2bfloat16(vs);
      enc[row * kEncStride + 3 * F + j] = __float2bfloat16(vc);
      if (INT8) {
        // Quantized from the f32 encoding, not the bf16 one.
        const signed char qs = sat_rn(__fmul_rn(vs, __ldg(q.qenc + j)));
        const signed char qc = sat_rn(__fmul_rn(vc, __ldg(q.qenc + 3 * F + j)));
        encq[row * kEncQStride + j] = qs;
        encq[row * kEncQStride + 3 * F + j] = qc;
        if (dbg != nullptr) {
          int8_t* d = dbg + ((size_t)(ray0 + row / kSampleBlock) * S +
                             sb * kSampleBlock + row % kSampleBlock) * kDbg;
          d[j] = qs;
          d[3 * F + j] = qc;
        }
      }
    }
    __syncthreads();

    // ---- MLP trunk: bf16 mma, f32 accumulate, f32 bias + ReLU; with
    //      INT8, layers from int8_from on in the quantized domain ----
    for (int i = 0; i < layer_num; ++i) {
      const bool is_tap = FINE && i == feat_layer;
      const bool is_last = i == layer_num - 1;
      if (INT8 && i >= int8_from) {
        const bool from_enc = i == 0;
        const int8_t* in = from_enc ? encq : actq;
        const int lda = from_enc ? kEncQStride : kActQStride;
        const int ksteps = from_enc ? kEncMax / 32 : HID / 32;
        const uint2* ws = q.Ws[i];
        const float* sc = q.scale[i];
        const float* scs = q.scale_s[i];
        const float* bq = q.bias[i];
        // Two halves of 32 rows: the epilogue of rows 0-31 overwrites
        // them in place while other warps still read rows 32-63.
#pragma unroll 1
        for (int part = 0; part < 2; ++part) {
          int acc[2][NT][4], accs[2][NT][4];
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[m][j][e] = accs[m][j][e] = 0;
          mma_rows_s8<2, NT>(in + part * 32 * lda, lda, ksteps, q.W[i], NTT,
                             nt0, lane, acc);
          if (ws != nullptr)
            mma_rows_s8<2, NT>(encq + part * 32 * kEncQStride, kEncQStride,
                               kEncMax / 32, ws, NTT, nt0, lane, accs);
          __syncthreads();  // every warp has read these rows of the input
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const int mg = part * 2 + m;
            float sp[2] = {0.f, 0.f};  // sigma partials (last layer)
#pragma unroll
            for (int j = 0; j < NT; ++j) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int row = frag_row(mg, 2 * h, lane);
                const int col = frag_col(nt0 + j, 0, lane);
                float y[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  y[e] = __fmul_rn((float)acc[m][j][2 * h + e], __ldg(sc + col + e));
                  if (ws != nullptr)
                    y[e] = __fadd_rn(y[e], __fmul_rn((float)accs[m][j][2 * h + e],
                                                     __ldg(scs + col + e)));
                  y[e] = __fadd_rn(y[e], __ldg(bq + col + e));
                }
                if (!is_last) {
                  // max(y, 0.5) is the ReLU; the +0.5 in B turns truncation
                  // into round-to-nearest.
                  const float y0 = fmaxf(y[0], 0.5f), y1 = fmaxf(y[1], 0.5f);
                  const signed char q0 = (signed char)__float2int_rz(fminf(y0, 127.f));
                  const signed char q1 = (signed char)__float2int_rz(fminf(y1, 127.f));
                  *reinterpret_cast<char2*>(actq + row * kActQStride + col) =
                      make_char2(q0, q1);
                  if (is_tap)
                    *reinterpret_cast<float2*>(tap + row * kTapStride + col) =
                        make_float2(__fmul_rn(__fsub_rn(y0, 0.5f), __ldg(q.iq + col)),
                                    __fmul_rn(__fsub_rn(y1, 0.5f), __ldg(q.iq + col + 1)));
                  if (dbg != nullptr && i == layer_num - 2) {
                    int8_t* d = dbg + ((size_t)(ray0 + row / kSampleBlock) * S +
                                       sb * kSampleBlock + row % kSampleBlock) * kDbg;
                    d[kEncMax + col] = q0;
                    d[kEncMax + col + 1] = q1;
                  }
                } else {
                  const float v0 = fmaxf(y[0], 0.f), v1 = fmaxf(y[1], 0.f);
                  *reinterpret_cast<__nv_bfloat162*>(act + row * kActStride + col) =
                      __floats2bfloat162_rn(v0, v1);
                  if (is_tap)
                    *reinterpret_cast<float2*>(tap + row * kTapStride + col) =
                        make_float2(v0, v1);
                  sp[h] = fmaf(v0, __ldg(p.wa + col), fmaf(v1, __ldg(p.wa + col + 1), sp[h]));
                }
              }
            }
            if (is_last) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float s = sp[h];
                s += __shfl_xor_sync(0xffffffffu, s, 1);
                s += __shfl_xor_sync(0xffffffffu, s, 2);
                if ((lane & 3) == 0) sigp[warp * kRows + frag_row(mg, 2 * h, lane)] = s;
              }
            }
          }
        }
        __syncthreads();
        continue;
      }
      float acc[kMTiles][NT][4];
      zero_acc(acc);
      if (p.Wenc[i] != nullptr)
        mma_rows<NT>(enc, kEncStride, enc_ksteps, p.Wenc[i], NTT, nt0, lane, acc);
      if (p.Wh[i] != nullptr)
        mma_rows<NT>(act, kActStride, HID / 16, p.Wh[i], NTT, nt0, lane, acc);
      __syncthreads();  // every warp has read this layer's input
      // INT8 posttap: this bf16 layer's output enters the quantized domain.
      const bool to_q = INT8 && i == int8_from - 1;
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
            if (to_q) {
              const signed char q0 = sat_rn(__fmul_rn(v0, __ldg(q.qh + col)));
              const signed char q1 = sat_rn(__fmul_rn(v1, __ldg(q.qh + col + 1)));
              *reinterpret_cast<char2*>(actq + row * kActQStride + col) =
                  make_char2(q0, q1);
              if (dbg != nullptr && i == layer_num - 2) {
                int8_t* d = dbg + ((size_t)(ray0 + row / kSampleBlock) * S +
                                   sb * kSampleBlock + row % kSampleBlock) * kDbg;
                d[kEncMax + col] = q0;
                d[kEncMax + col + 1] = q1;
              }
            }
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

template <int HID, bool FINE, bool INT8>
cudaError_t launch(const RenderParams& p, const QuantParams& q, int n_rays,
                   int layer_num, int feat_layer, int int8_from, int F, int Fd,
                   int S, float var_scale, float log_eps, int white_bg,
                   float* w, float* depth, float* acc, float* rgb, float* feat,
                   float* pts, int8_t* dbg, cudaStream_t stream) {
  const size_t bytes = Smem<HID>::bytes(FINE, INT8);
  auto kern = render_kernel<HID, FINE, INT8>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  const int grid = n_rays / kTileRays;
  kern<<<grid, kThreads, bytes, stream>>>(p, q, layer_num, feat_layer,
                                          int8_from, F, Fd, S, var_scale,
                                          log_eps, white_bg, w, depth, acc,
                                          rgb, feat, pts, dbg);
  return cudaGetLastError();
}

template <int HID>
cudaError_t launch_hid(bool fine, bool int8, const RenderParams& p,
                       const QuantParams& q, int n_rays, int layer_num,
                       int feat_layer, int int8_from, int F, int Fd, int S,
                       float var_scale, float log_eps, int white_bg, float* w,
                       float* depth, float* acc, float* rgb, float* feat,
                       float* pts, int8_t* dbg, cudaStream_t s) {
  auto fn = fine ? (int8 ? launch<HID, true, true> : launch<HID, true, false>)
                 : (int8 ? launch<HID, false, true> : launch<HID, false, false>);
  return fn(p, q, n_rays, layer_num, feat_layer, int8_from, F, Fd, S,
            var_scale, log_eps, white_bg, w, depth, acc, rgb, feat, pts, dbg,
            s);
}

}  // namespace

// ptrs: host array of 3 * layer_num + 11 device pointers, in the order
// Wenc0, Wh0, b0, ..., Wenc{L-1}, Wh{L-1}, b{L-1}, wa, ba, wf, bf, wvh, wvd,
// bv, wr, br, rays, z (Wenc_i / Wh_i null where layer i has no such rows).
// qptrs: null for the bf16 trunk, or the int8 trunk of layers int8_from ..
// L - 1 as 5 * layer_num + 3 device pointers: per layer W, Ws, scale,
// scale_s, bias (null below int8_from; Ws and scale_s null without
// encoding rows), then qenc, qh (int8_from > 0), iq (fine stage, tap layer
// quantized and not last).  dbg: null, or (n_rays, samples, 96 + hid) int8
// receiving the quantized encoding and the last layer's int8 input.
extern "C" int nm_render_forward(const void* const* ptrs,
                                 const void* const* qptrs, int n_rays,
                                 int hid, int layer_num, int feat_layer,
                                 int int8_from, int num_freqs, int dirs_freqs,
                                 int samples, float var_scale, float log_eps,
                                 int white_bg, int fine, void* out_w,
                                 void* out_depth, void* out_acc, void* out_rgb,
                                 void* out_feat, void* out_pts, void* dbg,
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
  QuantParams q = {};
  const bool int8 = qptrs != nullptr;
  if (int8) {
    if (int8_from < 0 || int8_from >= layer_num) return (int)cudaErrorInvalidValue;
    k = 0;
    for (int i = 0; i < layer_num; ++i) {
      q.W[i] = (const uint2*)qptrs[k++];
      q.Ws[i] = (const uint2*)qptrs[k++];
      q.scale[i] = (const float*)qptrs[k++];
      q.scale_s[i] = (const float*)qptrs[k++];
      q.bias[i] = (const float*)qptrs[k++];
      if (i >= int8_from &&
          (q.W[i] == nullptr || q.scale[i] == nullptr || q.bias[i] == nullptr ||
           (q.Ws[i] == nullptr) != (q.scale_s[i] == nullptr)))
        return (int)cudaErrorInvalidValue;
    }
    q.qenc = (const float*)qptrs[k++];
    q.qh = (const float*)qptrs[k++];
    q.iq = (const float*)qptrs[k++];
    const bool tap_q = fine && feat_layer >= int8_from && feat_layer < layer_num - 1;
    if (q.qenc == nullptr || (int8_from > 0 && q.qh == nullptr) ||
        (tap_q && q.iq == nullptr))
      return (int)cudaErrorInvalidValue;
  } else if (dbg != nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  float* w = (float*)out_w;
  float* depth = (float*)out_depth;
  float* acc = (float*)out_acc;
  float* rgb = (float*)out_rgb;
  float* feat = (float*)out_feat;
  float* pts = (float*)out_pts;
  cudaStream_t s = (cudaStream_t)stream;
  if (hid == 64)
    return (int)launch_hid<64>(fine, int8, p, q, n_rays, layer_num, feat_layer,
                               int8_from, num_freqs, dirs_freqs, samples,
                               var_scale, log_eps, white_bg, w, depth, acc,
                               rgb, feat, pts, (int8_t*)dbg, s);
  if (hid == 256)
    return (int)launch_hid<256>(fine, int8, p, q, n_rays, layer_num,
                                feat_layer, int8_from, num_freqs, dirs_freqs,
                                samples, var_scale, log_eps, white_bg, w,
                                depth, acc, rgb, feat, pts, (int8_t*)dbg, s);
  return (int)cudaErrorInvalidValue;
}
