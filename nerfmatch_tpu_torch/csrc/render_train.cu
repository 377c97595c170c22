// Fused mip-NeRF TRAIN render stage for Hopper (sm_90a): forward and
// hand-written backward, bf16 tensor-core MLP products, f32 elsewhere.
//
// Replaces the TPU kernels nerfmatch_tpu/ops/pallas/render_train.py:
// make_fused_train_render -> _fwd_impl (fwd_kernel) and _bwd_impl
// (bwd_kernel), driven twice per step (coarse, fine) by
// make_fused_train_hierarchical.
//
// Forward, per ray: frustum moments from the jittered z fenceposts -> IPE
// -> L x HID trunk (skip concat as a second product into the same
// accumulator) -> sigma (+ the caller's density noise, before the ReLU) ->
// feature -> views -> sigmoid rgb -> alpha compositing.  Outputs rgb (N, 3)
// and weights (N, S).  No early termination (training).
//
// Backward (nm_render_train_backward), four launches:
//   1. the forward again, stashing every sample's bf16 activations (the
//      encoding, each trunk layer, feature, views) and an f32 record (rgb,
//      sigma_raw, alpha, transmittance) in a global workspace;
//   2. per tile of 2 rays: the composite backward over all S samples (the
//      reverse exclusive prefix sum of g_w * w is whole-ray, so it runs
//      first), then per 64-row chunk the heads and trunk backward on
//      mma.sync (g_h = bf16(g_pre) @ bf16(W)^T with fragments of W^T
//      packed on the host), writing bf16 g_pre of every layer to the
//      workspace and summing the f32 vector gradients (biases, sigma head)
//      into a per-block partial row;
//   3. the matrix-weight gradients as GEMMs over the sample rows,
//      sum_rows bf16(act)^T bf16(g), split over row ranges into partials
//      (ldmatrix.trans feeds both operands);
//   4. a fixed-order sum over the partials (matrix and vector gradients).
// No atomics: the result is bit-reproducible run to run.
//
// Precision, as in the JAX kernel: matrix-product operands bf16 with f32
// accumulation (forward, backward g_h, and the weight-gradient products),
// residual activations bf16, everything else f32; the dirs part of the
// views layer and the rgb head take bf16-rounded operands too (the JAX
// train kernel rounds extras, wvx and wrgb).  sinf / expf in place of the
// TPU kernel's bf16-accurate polynomials.
//
// What bounds it on the H100: the MLP (about 1.2 MFLOP per sample forward,
// 3x that in the backward with the recompute) and the workspace traffic of
// step 1-3 (~10 KB per sample at HID 256).  The workspace (the stash,
// ~10 KB per sample) is the price of not keeping weight-gradient
// accumulators on chip: a 256 x 256 f32 gradient is 256 KB, more than a
// block's shared memory.

#include <math.h>

#include "mma_common.cuh"

namespace {

constexpr int kTileRays = 2;
constexpr int kSampleBlock = 32;
static_assert(kTileRays * kSampleBlock == kRows, "one chunk = 2 rays x 32");
constexpr int kMaxSamples = 256;
constexpr int kRecWidth = 8;      // f32 record per sample
constexpr int kGrgbWidth = 8;     // bf16 g_rgb_t row (3 used)
constexpr int kMaxProds = 2 * kMaxLayers + 4;
constexpr int kMaxSplits = 48;
constexpr int kGemmThreads = 128;

struct TrainParams {
  const uint2* Wenc[kMaxLayers];  // encoding rows of layer i (in x out), or null
  const uint2* Wh[kMaxLayers];    // hidden rows of layer i (in x out), or null
  const uint2* WhT[kMaxLayers];   // their transpose (out x in), backward
  const float* b[kMaxLayers];
  const float* wa;    // (hid,) sigma head, f32
  const float* ba;    // (1,)
  const uint2* wf;    // feature head (hid, hid)
  const uint2* wfT;   // its transpose
  const float* bf;
  const uint2* wvh;   // views layer, hidden rows (hid, hv)
  const uint2* wvhT;  // its transpose (hv, hid)
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

template <int HID>
struct BwdSmem {
  static constexpr int kActStride = HID + 8;
  static constexpr int HV = HID / 2;
  static size_t bytes(int S, int P) {
    return (size_t)kRows * kActStride * 2 +
           ((size_t)kTileRays * S * 4 + P + kThreads + kTileRays * HV + 8) * 4;
  }
};

// Accumulator columns summed over the chunk's 64 rows, added to vec[off + col].
template <int NT>
__device__ __forceinline__ void add_col_sums(const float (&cs)[NT][2], int nt0,
                                             int lane, float* vec) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float s0 = col_sum(cs[j][0]), s1 = col_sum(cs[j][1]);
    if (lane < 4) {
      const int col = frag_col(nt0 + j, 0, lane);
      vec[col] += s0;
      vec[col + 1] += s1;
    }
  }
}

template <int HID>
__global__ void __launch_bounds__(kThreads)
train_bwd_kernel(TrainParams p, Stash st, int layer_num, int S, int white_bg,
                 const float* __restrict__ g_rgb_in,
                 const float* __restrict__ g_w_in) {
  constexpr int NTT = HID / 8;
  constexpr int NT = NTT / kWarps;
  constexpr int HV = HID / 2;
  constexpr int kActStride = BwdSmem<HID>::kActStride;
  const VecLayout vl(layer_num, HID);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* gsr = reinterpret_cast<float*>(act + kRows * kActStride);  // kTileRays * S
  float* grgb = gsr + kTileRays * S;                                // kTileRays * S * 3
  float* vec = grgb + kTileRays * S * 3;                            // P
  float* colpart = vec + vl.P;                                      // kThreads
  float* hvsum = colpart + kThreads;                                // kTileRays * HV
  float* tot = hvsum + kTileRays * HV;                              // 8

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ray0 = blockIdx.x * kTileRays;
  const int nt0 = warp * NT;
  for (int i = tid; i < vl.P; i += kThreads) vec[i] = 0.f;
  for (int i = tid; i < kTileRays * HV; i += kThreads) hvsum[i] = 0.f;

  // ---- composite backward: warp r takes ray r, blocks of 32 samples from
  //      the far end (reverse exclusive prefix sum of g_w * w) ----
  if (warp < kTileRays) {
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
      const float q = gw * w;
      float incl = q;  // suffix sum over lanes >= lane
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += v;
      }
      const float after = carry + (incl - q);
      carry += __shfl_sync(0xffffffffu, incl, 0);
      const float g_alpha = gw * trans - after / (1.f - alpha + 1e-10f);
      const float g_sigma = g_alpha * (1.f - alpha) * (zr[s + 1] - zr[s]);
      const float g_sr = sigma_raw > 0.f ? g_sigma : 0.f;
      gsr[r * S + s] = g_sr;
      sum_gsr += g_sr;
      const float gc[3] = {g0, g1, g2};
      __nv_bfloat16* grow = st.g_rgb + rg * kGrgbWidth;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float v = gc[c] * w * rgb[c] * (1.f - rgb[c]);
        grgb[(r * S + s) * 3 + c] = v;
        grow[c] = __float2bfloat16(v);
        sum_g[c] += v;
      }
#pragma unroll
      for (int c = 3; c < kGrgbWidth; ++c) grow[c] = __float2bfloat16(0.f);
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
    for (int r = 0; r < kTileRays; ++r) {
      for (int c = 0; c < 3; ++c) vec[vl.brgb + c] += tot[r * 4 + c];
      vec[vl.ba] += tot[r * 4 + 3];
    }
  }

  // ---- heads and trunk backward, one 64-row chunk (of one ray) at a time ----
  const int n_chunks = kTileRays * S / kRows;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int lr0 = ch * kRows;               // local row of the tile
    const int rl = lr0 / S;                   // the chunk's ray (S % 64 == 0)
    const size_t rg0 = (size_t)ray0 * S + lr0;

    // g_hv = relu'(hv) * (bf16(g_rgb_t) @ bf16(wrgb)^T)
    {
      const int j = tid % HV, grp = tid / HV, ngrp = kThreads / HV;
      const float w0 = __ldg(p.wr + j * 3), w1 = __ldg(p.wr + j * 3 + 1),
                  w2 = __ldg(p.wr + j * 3 + 2);
      float cs = 0.f;
      for (int row = grp; row < kRows; row += ngrp) {
        const float* g = grgb + (lr0 + row) * 3;
        float v = bf16_round(g[0]) * w0 + bf16_round(g[1]) * w1 + bf16_round(g[2]) * w2;
        if (!(__bfloat162float(st.hv[(rg0 + row) * HV + j]) > 0.f)) v = 0.f;
        cs += v;
        const __nv_bfloat16 vb = __float2bfloat16(v);
        act[row * kActStride + j] = vb;
        st.g_hv[(rg0 + row) * HV + j] = vb;
      }
      colpart[grp * HV + j] = cs;
      __syncthreads();
      if (tid < HV) {
        float s = 0.f;
        for (int g = 0; g < ngrp; ++g) s += colpart[g * HV + tid];
        vec[vl.bv + tid] += s;
        hvsum[rl * HV + tid] += s;
      }
      __syncthreads();
    }

    float acc[kMTiles][NT][4];
    // g_feature = bf16(g_hv) @ bf16(wvh)^T (no activation)
    zero_acc(acc);
    mma_rows<NT>(act, kActStride, HV / 16, p.wvhT, NTT, nt0, lane, acc);
    __syncthreads();
    {
      float cs[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
      for (int m = 0; m < kMTiles; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = frag_row(m, 2 * h, lane);
            const int col = frag_col(nt0 + j, 0, lane);
            const float v0 = acc[m][j][2 * h], v1 = acc[m][j][2 * h + 1];
            cs[j][0] += v0;
            cs[j][1] += v1;
            const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
            *reinterpret_cast<__nv_bfloat162*>(act + row * kActStride + col) = v;
            *reinterpret_cast<__nv_bfloat162*>(st.g_feat + (rg0 + row) * HID + col) = v;
          }
      add_col_sums<NT>(cs, nt0, lane, vec + vl.bf);
    }
    __syncthreads();
    // g_h = bf16(g_feature) @ bf16(wf)^T + g_sigma_raw * wa
    zero_acc(acc);
    mma_rows<NT>(act, kActStride, HID / 16, p.wfT, NTT, nt0, lane, acc);
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kMTiles; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = frag_row(m, e, lane), col = frag_col(nt0 + j, e, lane);
          acc[m][j][e] += gsr[lr0 + row] * __ldg(p.wa + col);
        }

    // trunk: g_pre_i = relu'(h_i) * g_h; g_h = bf16(g_pre_i) @ bf16(W_i)^T
    for (int i = layer_num - 1; i >= 0; --i) {
      const bool is_last = i == layer_num - 1;
      float cs[NT][2], ca[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) cs[j][0] = cs[j][1] = ca[j][0] = ca[j][1] = 0.f;
#pragma unroll
      for (int m = 0; m < kMTiles; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = frag_row(m, 2 * h, lane);
            const int col = frag_col(nt0 + j, 0, lane);
            const size_t off = (rg0 + row) * HID + col;
            const float2 hh = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(st.hs[i] + off));
            const float v0 = hh.x > 0.f ? acc[m][j][2 * h] : 0.f;
            const float v1 = hh.y > 0.f ? acc[m][j][2 * h + 1] : 0.f;
            cs[j][0] += v0;
            cs[j][1] += v1;
            if (is_last) {
              const float g = gsr[lr0 + row];
              ca[j][0] += hh.x * g;
              ca[j][1] += hh.y * g;
            }
            const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
            *reinterpret_cast<__nv_bfloat162*>(st.g_pre[i] + off) = v;
            if (i > 0)
              *reinterpret_cast<__nv_bfloat162*>(act + row * kActStride + col) = v;
          }
      add_col_sums<NT>(cs, nt0, lane, vec + i * HID);
      if (is_last) add_col_sums<NT>(ca, nt0, lane, vec + vl.wa);
      if (i > 0) {
        __syncthreads();
        zero_acc(acc);
        mma_rows<NT>(act, kActStride, HID / 16, p.WhT[i], NTT, nt0, lane, acc);
        __syncthreads();
      }
    }
    __syncthreads();
  }

  __syncthreads();
  for (int i = tid; i < kTileRays * HV; i += kThreads)
    st.g_hvsum[(size_t)ray0 * HV + i] = __float2bfloat16(hvsum[i]);
  for (int i = tid; i < vl.P; i += kThreads)
    st.vec_part[(size_t)blockIdx.x * vl.P + i] = vec[i];
}

// ---- weight gradients: C (M x N) = sum over rows of A[row]^T B[row] ----
struct Prod {
  const __nv_bfloat16* A;  // (rows, M) row-major, M % 8 == 0
  const __nv_bfloat16* B;  // (rows, N) row-major, N % 8 == 0
  int M, N, rows;
  long long out_off;       // into the (M x N) row-major output block
  int tile0, ntn;          // first tile index, n-tiles of 64
};
struct ProdTable {
  Prod p[kMaxProds];
  int count;
};

__global__ void __launch_bounds__(kGemmThreads)
wgrad_kernel(ProdTable t, long long total, float* __restrict__ part) {
  __shared__ __align__(16) __nv_bfloat16 As[32][72];
  __shared__ __align__(16) __nv_bfloat16 Bs[32][72];
  const int tile = blockIdx.x;
  int pi = 0;
  while (pi + 1 < t.count && tile >= t.p[pi + 1].tile0) ++pi;
  const Prod prod = t.p[pi];
  const int lt = tile - prod.tile0;
  const int m0 = (lt / prod.ntn) * 64, n0 = (lt % prod.ntn) * 64;
  const int per = (prod.rows + gridDim.y - 1) / gridDim.y;
  const int r0 = blockIdx.y * per;
  const int r1 = min(prod.rows, r0 + per);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  float acc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;

  const int mj = lane >> 3, r8 = lane & 7;
  const uint32_t as = (uint32_t)__cvta_generic_to_shared(&As[0][0]);
  const uint32_t bs = (uint32_t)__cvta_generic_to_shared(&Bs[0][0]);
  for (int r = r0; r < r1; r += 32) {
    for (int i = tid; i < 256; i += kGemmThreads) {
      const int row = i >> 3, c8 = (i & 7) * 8, gr = r + row;
      uint4 va = make_uint4(0, 0, 0, 0), vb = make_uint4(0, 0, 0, 0);
      if (gr < r1 && m0 + c8 < prod.M)
        va = *reinterpret_cast<const uint4*>(prod.A + (size_t)gr * prod.M + m0 + c8);
      if (gr < r1 && n0 + c8 < prod.N)
        vb = *reinterpret_cast<const uint4*>(prod.B + (size_t)gr * prod.N + n0 + c8);
      *reinterpret_cast<uint4*>(&As[row][c8]) = va;
      *reinterpret_cast<uint4*>(&Bs[row][c8]) = vb;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)  // A^T: stored rows = k, cols = m
        ldmatrix_x4_trans(a[mt], as + (uint32_t)(((ks * 16 + (mj >> 1) * 8 + r8) * 72 +
                                                  wm + mt * 16 + (mj & 1) * 8) * 2));
#pragma unroll
      for (int np = 0; np < 2; ++np)  // B: stored rows = k, cols = n
        ldmatrix_x4_trans(b[np], bs + (uint32_t)(((ks * 16 + (mj & 1) * 8 + r8) * 72 +
                                                  wn + np * 16 + (mj >> 1) * 8) * 2));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], a[mt],
                   make_uint2(b[nt >> 1][(nt & 1) * 2], b[nt >> 1][(nt & 1) * 2 + 1]));
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.y * total + prod.out_off;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + mt * 16 + (lane >> 2) + (e >= 2 ? 8 : 0);
        const int n = n0 + wn + nt * 8 + (lane & 3) * 2 + (e & 1);
        if (m < prod.M && n < prod.N) out[(size_t)m * prod.N + n] = acc[mt][nt][e];
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

bool bad_dims(int n_rays, int hid, int layer_num, int F, int Fd, int S) {
  return layer_num < 1 || layer_num > kMaxLayers || 6 * F > kEncMax ||
         6 * Fd + 3 > kDirsMax || n_rays % kTileRays != 0 || S % kRows != 0 ||
         S > kMaxSamples || (hid != 64 && hid != 256);
}

void unpack(const void* const* ptrs, int layer_num, TrainParams* p) {
  int k = 0;
  for (int i = 0; i < kMaxLayers; ++i) {
    const bool live = i < layer_num;
    p->Wenc[i] = live ? (const uint2*)ptrs[k++] : nullptr;
    p->Wh[i] = live ? (const uint2*)ptrs[k++] : nullptr;
    p->WhT[i] = live ? (const uint2*)ptrs[k++] : nullptr;
    p->b[i] = live ? (const float*)ptrs[k++] : nullptr;
  }
  p->wa = (const float*)ptrs[k++];
  p->ba = (const float*)ptrs[k++];
  p->wf = (const uint2*)ptrs[k++];
  p->wfT = (const uint2*)ptrs[k++];
  p->bf = (const float*)ptrs[k++];
  p->wvh = (const uint2*)ptrs[k++];
  p->wvhT = (const uint2*)ptrs[k++];
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

template <int HID>
cudaError_t launch_bwd(const TrainParams& p, const Stash& st, int n_rays,
                       int layer_num, int S, int white_bg, const float* g_rgb,
                       const float* g_w, cudaStream_t stream) {
  const size_t bytes = BwdSmem<HID>::bytes(S, VecLayout(layer_num, HID).P);
  auto kern = train_bwd_kernel<HID>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  kern<<<n_rays / kTileRays, kThreads, bytes, stream>>>(p, st, layer_num, S,
                                                        white_bg, g_rgb, g_w);
  return cudaGetLastError();
}

}  // namespace

// ptrs: host array of 4 * layer_num + 14 device pointers, in the order
// (Wenc_i, Wh_i, WhT_i, b_i) for each layer i, then wa, ba, wf, wfT, bf,
// wvh, wvhT, wvd, bv, wr, br, rays, z, noise (Wenc_i / Wh_i / WhT_i null
// where layer i has no such rows; the transposes only matter backward).
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
  if (hid == 64) {
    e = launch_fwd<64>(p, st, 1, n_rays, layer_num, num_freqs, dirs_freqs,
                       samples, var_scale, white_bg, rgb, w, s);
    if (e == cudaSuccess)
      e = launch_bwd<64>(p, st, n_rays, layer_num, samples, white_bg,
                         (const float*)g_rgb, (const float*)g_w, s);
  } else {
    e = launch_fwd<256>(p, st, 1, n_rays, layer_num, num_freqs, dirs_freqs,
                        samples, var_scale, white_bg, rgb, w, s);
    if (e == cudaSuccess)
      e = launch_bwd<256>(p, st, n_rays, layer_num, samples, white_bg,
                          (const float*)g_rgb, (const float*)g_w, s);
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
    q.ntn = (N + 63) / 64;
    tiles += ((M + 63) / 64) * q.ntn;
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
  wgrad_kernel<<<dim3(tiles, d.splits), kGemmThreads, 0, s>>>(t, d.mat_total,
                                                             mat_part);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  reduce_parts_kernel<<<(unsigned)((off + 255) / 256), 256, 0, s>>>(
      mat_part, d.splits, d.mat_total, (float*)grad_mat);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  reduce_parts_kernel<<<(d.vl.P + 255) / 256, 256, 0, s>>>(
      st.vec_part, n_rays / kTileRays, d.vl.P, (float*)grad_vec);
  return (int)cudaGetLastError();
}
