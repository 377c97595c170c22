// mip-NeRF inverse-CDF z resampling for Hopper (sm_90a).
//
// Replaces the TPU kernel nerfmatch_tpu/ops/pallas/resample_kernel.py:
// _resample_lookup (body _lookup_kernel, pallas_call at :82) AND the XLA prep
// around it in resample_z_pallas: max-then-average weight blur, +padding,
// eps padding of degenerate rows, pdf, clamped cdf, u (deterministic
// linspace(0, 1 - eps_f32, n_bins), or the caller's stratified draws
// (N, n_bins) in training), interval lookup and linear interpolation.
// Semantics follow nerf/sampling.py: resample_z_from_weights; the summation
// order is the one ops/kernels/resample_kernel.py: resample_z_scan_plain
// repeats in torch.
//
// Bound on the H100: bytes.  At 9216 rays x 129 bins it must read the bins
// and weights and write the new bins, 14.2 MB (4.2 us at 3.35 TB/s), plus
// 4.7 MB of u in training; the arithmetic is ~30 flops a bin.
//
// What the first design (one warp a ray) lost, and what this one does:
// 1. Its cdf was a serial loop in lane 0 (nb - 2 IEEE divisions, shared
//    loads and stores, 31 lanes idle).  Here each lane keeps a contiguous
//    chunk of kPer weights in registers, divides its own, sums its chunk
//    in order, and a log2(kRayLanes)-step __shfl_up scan over the ray's
//    lanes gives each lane its exclusive offset.
// 2. It read every weight three times from global memory (the blur's
//    neighbours) and staged weights, bins and cdf in three 257-float arrays
//    a warp.  Here each weight is loaded once (float4 where the row start
//    is 16-byte aligned and nw % 4 == 0), the neighbours come by shuffles,
//    and a ray keeps only its cdf and bins in shared memory (1 KB at 129).
// 3. One ray a warp made 9216 warps, 1.09 waves of the card's 8448 resident
//    warps.  Here a ray takes kRayLanes = 16 lanes (two rays a warp): 4608
//    warps, one wave.
// The search: cdf is non-decreasing, so count = #{cdf <= u} is one binary
// search a u over the ray's kCap = 16 kPer + 1 slots (the slots past nb
// hold +inf): 8 unrolled halvings at 129 bins, each a shared load, a
// compare and a select, with no branch (a loop that stops when its range
// is empty, or that starts from the lane's previous count, was slower).  A
// lane takes k = lane, lane + 16, ...: stores are coalesced (16
// consecutive bins a step) and u may come in any order.
// What holds it now (scripts/resample_probe.py): the launch and the
// dispatch of its blocks, then one chain a lane of dependent steps (the
// loads, the shuffles of the sums and the scan, then its ~9 searches one
// after the other); the IEEE divisions the plain version's rounding needs
// are a tenth of the time.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRayLanes = 16;                // lanes a ray
constexpr int kThreads = 64;                 // 4 rays a block
constexpr int kRays = kThreads / kRayLanes;
// 36 warps an SM (<= 56 registers a thread): 132 SMs then hold 4752 warps,
// the 4608 of 9216 rays in one wave.  Above 129 bins (kPer 16) half as
// many, so that the lane's 17 bins and u stay in registers.
constexpr int kMinBlocks = 36 * 32 / kThreads;
constexpr int kMaxBins = 257;
constexpr float kF32Eps = 1.1920928955078125e-07f;

// count = #{i < kLen : cdf[i] <= u} for a non-decreasing cdf (a prefix), by
// halving a range of compile-time length: ceil(log2(kLen)) steps of one
// shared load, one compare and one select, the same for every lane.
template <int kLen>
__device__ __forceinline__ int count_le(const float* cdf, float u, int base) {
  if constexpr (kLen == 1) {
    return base + (cdf[base] <= u);
  } else {
    constexpr int kHalf = kLen / 2;
    base = cdf[base + kHalf] <= u ? base + kHalf : base;
    return count_le<kLen - kHalf>(cdf, u, base);
  }
}

template <int kPer>
__global__ void __launch_bounds__(kThreads, kPer <= 8 ? kMinBlocks : kMinBlocks / 2)
resample_kernel(const float* __restrict__ bins, const float* __restrict__ weights,
                const float* __restrict__ u_in, float* __restrict__ out,
                int n_rays, int nb, float padding, bool vec) {
  constexpr int kCap = kRayLanes * kPer + 1;   // bins a ray at most
  constexpr int kOut = kPer + 1;               // bins a lane at most
  __shared__ float s_cdf[kRays][kCap];
  __shared__ float s_bins[kRays][kCap];
  const int sub = threadIdx.x % kRayLanes, slot = threadIdx.x / kRayLanes;
  // Whole warps past the last ray leave; a warp with one live ray keeps all
  // its lanes for the shuffles and masks its memory accesses.
  if ((blockIdx.x * kThreads + (threadIdx.x & ~31)) / kRayLanes >= n_rays) return;
  const int ray = blockIdx.x * kRays + slot;
  const bool live = ray < n_rays;
  const int nw = nb - 1;
  const int j0 = sub * kPer;                   // this lane's first weight
  const float* w = weights + (size_t)ray * nw;
  float* cdf = s_cdf[slot];
  float* sb = s_bins[slot];

  // Weights, once: float4 where the chunk is aligned, scalars otherwise.
  float v[kPer];
  if constexpr (kPer % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < kPer; k += 4) {
        float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
        if (live && j0 + k < nw) q = *reinterpret_cast<const float4*>(w + j0 + k);
        v[k] = q.x; v[k + 1] = q.y; v[k + 2] = q.z; v[k + 3] = q.w;
      }
    }
  }
  if (!(kPer % 4 == 0 && vec)) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) v[k] = live && j0 + k < nw ? w[j0 + k] : 0.f;
  }
  // Bins and u: the lane's k = sub, sub + kRayLanes, ..., all loads issued
  // before any is used (with the weights').
  const float* br = bins + (size_t)ray * nb;
  const bool has_u = u_in != nullptr;
  const float* ur = has_u ? u_in + (size_t)ray * nb : nullptr;
  float bv[kOut], uv[kOut];
#pragma unroll
  for (int m = 0; m < kOut; ++m) {
    const int k = sub + m * kRayLanes;
    bv[m] = live && k < nb ? br[k] : 0.f;
    uv[m] = has_u && live && k < nb ? ur[k] : 0.f;
  }
#pragma unroll
  for (int m = 0; m < kOut; ++m)
    if (sub + m * kRayLanes < nb) sb[sub + m * kRayLanes] = bv[m];

  // Blur: wp = [w0, w, w_last]; wmax[i] = max(wp[i], wp[i+1]);
  // blur[i] = (wmax[i] + wmax[i+1]) / 2; + padding.  Neighbours across the
  // chunk's ends come from the lanes beside it.
  const float left = __shfl_up_sync(0xffffffffu, v[kPer - 1], 1, kRayLanes);
  const float right = __shfl_down_sync(0xffffffffu, v[0], 1, kRayLanes);
  float blur[kPer];
  float part = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = j0 + k;
    const float wm1 = j == 0 ? v[k] : k == 0 ? left : v[k - 1];
    const float wp1 = j >= nw - 1 ? v[k] : k == kPer - 1 ? right : v[k + 1];
    const float b = j < nw ? 0.5f * (fmaxf(wm1, v[k]) + fmaxf(v[k], wp1)) + padding
                           : 0.f;
    blur[k] = b;
    part += b;
  }
  // weight_sum: chunk sums in order, then a butterfly over the ray's lanes
  // (every lane ends with the same value); pad degenerate rays up to eps.
  float wsum = part;
#pragma unroll
  for (int o = kRayLanes / 2; o > 0; o >>= 1)
    wsum += __shfl_xor_sync(0xffffffffu, wsum, o, kRayLanes);
  const float pad = fmaxf(0.f, 1e-5f - wsum);
  wsum += pad;
  const float pad_w = pad / (float)nw;

  // pdf and the chunk's inclusive prefix, then the lanes' exclusive offset.
  float c = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    c += j0 + k < nw ? (blur[k] + pad_w) / wsum : 0.f;
    blur[k] = c;
  }
  float x = c;
#pragma unroll
  for (int o = 1; o < kRayLanes; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, o, kRayLanes);
    if (sub >= o) x = y + x;
  }
  float excl = __shfl_up_sync(0xffffffffu, x, 1, kRayLanes);
  if (sub == 0) excl = 0.f;
  // cdf = [0, min(1, cumsum(pdf[:-1])), 1].
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (j0 + k < nw - 1) cdf[j0 + k + 1] = fminf(1.f, excl + blur[k]);
  if (sub == 0) cdf[0] = 0.f;
  if (sub == (nw - 1) / kPer) cdf[nb - 1] = 1.f;
  for (int k = nb + sub; k < kCap; k += kRayLanes) cdf[k] = INFINITY;
  __syncwarp();
  if (!live) return;

  const float step = (1.f - kF32Eps) / (float)(nb - 1);
  const float b_first = sb[0], b_last = sb[nb - 1];
  float* o = out + (size_t)ray * nb;
#pragma unroll
  for (int m = 0; m < kOut; ++m) {
    const int k = sub + m * kRayLanes;
    if (k >= nb) break;
    const float u = has_u ? uv[m] : k == nb - 1 ? 1.f - kF32Eps : (float)k * step;
    const int cnt = min(count_le<kCap>(cdf, u, 0), nb);   // u = +inf
    // The bracketing slots, clamped to the row: at cnt 0 (or nb) both are
    // slot 0 (nb - 1), which is what the plain version's clamps of its
    // +-1e10 fills give.  The cdf needs no clamp (0 <= cdf <= 1 = cdf[nb-1]),
    // the bins keep theirs.
    const int i0 = max(cnt - 1, 0), i1 = min(cnt, nb - 1);
    const float c0 = cdf[i0], c1 = cdf[i1];
    const float b0 = fmaxf(sb[i0], b_first), b1 = fminf(sb[i1], b_last);
    // fmaxf takes the number over a NaN: t = 0 where 0 / 0, as nan_to_num.
    const float t = fminf(fmaxf((u - c0) / (c1 - c0), 0.f), 1.f);
    // b0 + t (b1 - b0), rounded as the plain version rounds it (no FMA).
    o[k] = __fadd_rn(b0, __fmul_rn(t, b1 - b0));
  }
}

template <int kPer>
cudaError_t launch(const float* bins, const float* weights, const float* u,
                   float* out, int n_rays, int nb, float padding,
                   cudaStream_t stream) {
  const int nw = nb - 1;
  const bool vec = nw % 4 == 0 && reinterpret_cast<size_t>(weights) % 16 == 0;
  const int grid = (n_rays + kRays - 1) / kRays;
  resample_kernel<kPer><<<grid, kThreads, 0, stream>>>(bins, weights, u, out,
                                                       n_rays, nb, padding, vec);
  return cudaGetLastError();
}

}  // namespace

// u: null for the deterministic linspace, else (n_rays, n_bins) draws.
extern "C" int nm_resample_forward(const void* bins, const void* weights,
                                   const void* u, void* out, int n_rays,
                                   int n_bins, float padding, void* stream) {
  if (n_bins > kMaxBins || n_bins < 2) return (int)cudaErrorInvalidValue;
  // Weights a lane: the least power of two that covers the row.
  const int need = (n_bins - 1 + kRayLanes - 1) / kRayLanes;
  const auto b = (const float*)bins;
  const auto w = (const float*)weights;
  const auto uu = (const float*)u;
  const auto o = (float*)out;
  const auto s = (cudaStream_t)stream;
  cudaError_t err;
  if (need <= 1) err = launch<1>(b, w, uu, o, n_rays, n_bins, padding, s);
  else if (need <= 2) err = launch<2>(b, w, uu, o, n_rays, n_bins, padding, s);
  else if (need <= 4) err = launch<4>(b, w, uu, o, n_rays, n_bins, padding, s);
  else if (need <= 8) err = launch<8>(b, w, uu, o, n_rays, n_bins, padding, s);
  else err = launch<16>(b, w, uu, o, n_rays, n_bins, padding, s);
  return (int)err;
}
