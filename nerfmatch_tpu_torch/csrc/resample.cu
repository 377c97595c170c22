// mip-NeRF inverse-CDF z resampling for Hopper (sm_90a).
//
// Replaces the TPU kernel nerfmatch_tpu/ops/pallas/resample_kernel.py:
// _resample_lookup (body _lookup_kernel) AND the XLA prep around it in
// resample_z_pallas: max-then-average weight blur, +padding, pdf, clamped
// cdf, u (deterministic linspace(0, 1 - eps_f32, n_bins), or the caller's
// stratified draws (N, n_bins) in training), interval lookup and linear
// interpolation.  Semantics follow nerf/sampling.py: resample_z_from_weights.
//
// What bounds it on the H100: memory traffic (reads bins + weights, writes
// new bins: ~1.5 KB per ray) and the serial cdf.  Design: one warp per ray;
// blur and pdf lane-parallel, the cumulative sum in one lane (sequential,
// like a CPU cumsum), then each lane binary-searches its share of the u
// values in the shared cdf.  cdf is non-decreasing, so the masked max/min
// interval search of the reference reduces to one search per u.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxBins = 257;
constexpr float kF32Eps = 1.1920928955078125e-07f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kWarps * 32)
resample_kernel(const float* __restrict__ bins, const float* __restrict__ weights,
                const float* __restrict__ u_in, float* __restrict__ out,
                int n_rays, int nb, float padding) {
  __shared__ float s_bins[kWarps][kMaxBins];
  __shared__ float s_w[kWarps][kMaxBins];
  __shared__ float s_cdf[kWarps][kMaxBins];
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int ray = blockIdx.x * kWarps + wi;
  if (ray >= n_rays) return;
  const int nw = nb - 1;  // weights per ray
  const float* b = bins + (size_t)ray * nb;
  const float* w = weights + (size_t)ray * nw;
  float* sb = s_bins[wi];
  float* sw = s_w[wi];
  float* cdf = s_cdf[wi];
  for (int i = lane; i < nb; i += 32) sb[i] = b[i];
  // Blur: wp = [w0, w, w_last]; wmax[i] = max(wp[i], wp[i+1]);
  // blur[i] = (wmax[i] + wmax[i+1]) / 2; + padding.
  float part = 0.f;
  for (int i = lane; i < nw; i += 32) {
    const float wm1 = w[i > 0 ? i - 1 : 0];
    const float w0 = w[i];
    const float wp1 = w[i < nw - 1 ? i + 1 : nw - 1];
    const float m0 = fmaxf(wm1, w0), m1 = fmaxf(w0, wp1);
    const float v = 0.5f * (m0 + m1) + padding;
    sw[i] = v;
    part += v;
  }
  __syncwarp();
  // weight_sum is reduced lane-parallel (the reference's jnp.sum order is
  // unspecified as well); pad degenerate rays up to eps as the reference.
  float wsum = warp_sum(part);
  const float pad = fmaxf(0.f, 1e-5f - wsum);
  wsum += pad;
  if (lane == 0) {
    float c = 0.f;
    cdf[0] = 0.f;
    for (int i = 0; i < nw - 1; ++i) {
      c += (sw[i] + pad / nw) / wsum;
      cdf[i + 1] = fminf(1.f, c);
    }
    cdf[nb - 1] = 1.f;
  }
  __syncwarp();
  const float step = (1.f - kF32Eps) / (float)(nb - 1);
  for (int k = lane; k < nb; k += 32) {
    const float u = u_in != nullptr ? u_in[(size_t)ray * nb + k]
                    : k == nb - 1 ? 1.f - kF32Eps : (float)k * step;
    // count = #{i : cdf[i] <= u} (a prefix: cdf is non-decreasing).
    int lo = 0, hi = nb;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cdf[mid] <= u) lo = mid + 1; else hi = mid;
    }
    const int cnt = lo;
    float c0 = cnt > 0 ? cdf[cnt - 1] : -1e10f;
    float c1 = cnt < nb ? cdf[cnt] : 1e10f;
    float b0 = cnt > 0 ? sb[cnt - 1] : -1e10f;
    float b1 = cnt < nb ? sb[cnt] : 1e10f;
    c0 = fmaxf(c0, cdf[0]);
    c1 = fminf(c1, cdf[nb - 1]);
    b0 = fmaxf(b0, sb[0]);
    b1 = fminf(b1, sb[nb - 1]);
    float t = (u - c0) / (c1 - c0);
    if (isnan(t)) t = 0.f;
    t = fminf(fmaxf(t, 0.f), 1.f);
    out[(size_t)ray * nb + k] = b0 + t * (b1 - b0);
  }
}

}  // namespace

// u: null for the deterministic linspace, else (n_rays, n_bins) draws.
extern "C" int nm_resample_forward(const void* bins, const void* weights,
                                   const void* u, void* out, int n_rays,
                                   int n_bins, float padding, void* stream) {
  if (n_bins > kMaxBins || n_bins < 2) return (int)cudaErrorInvalidValue;
  const int grid = (n_rays + kWarps - 1) / kWarps;
  resample_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)bins, (const float*)weights, (const float*)u, (float*)out,
      n_rays, n_bins, padding);
  return (int)cudaGetLastError();
}
