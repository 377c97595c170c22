// Non-causal multi-head softmax attention, forward and backward, for Hopper
// (sm_90a).  The backward is described above nm_attention_backward's kernels.
//
// Replaces the TPU kernel nerfmatch_tpu/ops/pallas/attention_kernel.py:
// _fused_fwd (body _attn_kernel): out = softmax(q k^T) v per (batch, head),
// q pre-scaled by the caller, layout (B, N, H, D), f32 output.  Ragged L
// and S are masked here, so nothing is padded in device memory, and the
// (L, S) logits never touch device memory.
//
// What bounds it on the H100: at the matcher's shapes (L = S ~ 3600,
// D = 32, 8 heads) it is 13 GFLOP per call against ~3.7 MB of operands,
// so it is compute-bound.  Two instantiations of the operand type:
//
// * f32 (attn_bf16 off): FP32 FMA, flash-style online softmax, one block
//   per (64-query tile, batch * head), one query row per thread, K/V tiles
//   of 64 keys staged in shared memory.
// * bf16 (attn_bf16 on, the matcher's default): the JAX kernel's
//   semantics on the tensor cores (mma.sync m16n8k16, f32 accumulation).
//   Each warp owns 16 query rows; K/V tiles of 64 keys are staged in
//   shared memory as bf16.  Two passes over the keys: the first finds each
//   row's maximum logit, the second forms e = exp(s - max) in f32, sums e
//   in f32 and accumulates e (rounded to bf16, the JAX kernel's
//   e.astype(v.dtype)) times V in f32.  The extra q k^T pass costs a third
//   more tensor-core work and keeps every rounding where the JAX kernel
//   has it.  Later work: wgmma, and K/V tiles double-buffered with TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQTile = 64;
constexpr int kKTile = 64;

__global__ void __launch_bounds__(kQTile)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int L, int S, int H) {
  constexpr int D = 32;
  __shared__ float ks[kKTile][D];
  __shared__ float vs[kKTile][D];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int l = blockIdx.x * kQTile + tid;
  const bool active = l < L;
  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = active ? q[(((size_t)b * L + l) * H + h) * D + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, lsum = 0.f;
  for (int s0 = 0; s0 < S; s0 += kKTile) {
    __syncthreads();
    for (int i = tid; i < kKTile * D; i += kQTile) {
      const int j = i / D, d = i % D, s = s0 + j;
      float kv = 0.f, vv = 0.f;
      if (s < S) {
        const size_t off = (((size_t)b * S + s) * H + h) * D + d;
        kv = k[off];
        vv = v[off];
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();
    const int n = min(kKTile, S - s0);
    float sc[kKTile];
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKTile; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[j][d], dot);
      sc[j] = j < n ? dot : -INFINITY;
      mt = fmaxf(mt, sc[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float scale = expf(m - m_new);
    lsum *= scale;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= scale;
#pragma unroll
    for (int j = 0; j < kKTile; ++j) {
      const float pj = expf(sc[j] - m_new);
      lsum += pj;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(pj, vs[j][d], acc[d]);
    }
    m = m_new;
  }
  if (active) {
    const float inv = 1.f / lsum;
#pragma unroll
    for (int d = 0; d < D; ++d)
      out[(((size_t)b * L + l) * H + h) * D + d] = acc[d] * inv;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p,
                                            bool trans) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  if (trans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

constexpr int kMmaWarps = kQTile / 16;
constexpr int kMmaThreads = kMmaWarps * 32;

__global__ void __launch_bounds__(kMmaThreads)
attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      float* __restrict__ out, int L, int S, int H) {
  constexpr int D = 32;
  constexpr int kStride = D + 8;       // bf16; conflict-free ldmatrix
  constexpr int NT = kKTile / 8;       // score n-tiles per key tile
  constexpr int DT = D / 8;            // output n-tiles
  __shared__ __align__(16) __nv_bfloat16 ks[kKTile * kStride];
  __shared__ __align__(16) __nv_bfloat16 vs[kKTile * kStride];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kQTile + warp * 16;

  // q fragments (A operand, k-steps over D); rows past L are zero.
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + g + (r & 1) * 8;
      const int col = kk * 16 + 2 * t + (r >> 1) * 8;
      qa[kk][r] = row < L ? *reinterpret_cast<const uint32_t*>(
                                q + (((size_t)b * L + row) * H + h) * D + col)
                          : 0u;
    }

  auto load_tile = [&](const __nv_bfloat16* src, __nv_bfloat16* dst, int s0) {
    for (int i = tid; i < kKTile * D / 8; i += kMmaThreads) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8, s = s0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (s < S)
        val = *reinterpret_cast<const uint4*>(src + (((size_t)b * S + s) * H + h) * D + c);
      *reinterpret_cast<uint4*>(dst + r * kStride + c) = val;
    }
  };
  // Logits of this warp's 16 rows against the staged key tile; keys past
  // S are -inf.  sc[n][e]: row g (e < 2) or g + 8, key 8 n + 2 t + (e & 1).
  auto scores = [&](float (&sc)[NT][4], int s0) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t kb[4];  // b-registers of k-steps 0 (kb[0..1]) and 1 (kb[2..3])
      ldmatrix_x4(kb, ks + (n * 8 + (lane & 7)) * kStride + (lane >> 3) * 8,
                  false);
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
      mma_bf16(sc[n], qa[0], kb[0], kb[1]);
      mma_bf16(sc[n], qa[1], kb[2], kb[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (s0 + n * 8 + 2 * t + (e & 1) >= S) sc[n][e] = -INFINITY;
    }
  };

  // ---- pass 1: row maxima ----
  float mx[2] = {-INFINITY, -INFINITY};  // rows g, g + 8
  for (int s0 = 0; s0 < S; s0 += kKTile) {
    __syncthreads();
    load_tile(k, ks, s0);
    __syncthreads();
    float sc[NT][4];
    scores(sc, s0);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[n][0], sc[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[n][2], sc[n][3]));
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }

  // ---- pass 2: e = exp(s - max), sum e, accumulate bf16(e) v ----
  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float lsum[2] = {0.f, 0.f};
  for (int s0 = 0; s0 < S; s0 += kKTile) {
    __syncthreads();
    load_tile(k, ks, s0);
    load_tile(v, vs, s0);
    __syncthreads();
    float sc[NT][4];
    scores(sc, s0);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = expf(sc[n][e] - mx[e >> 1]);
        lsum[e >> 1] += sc[n][e];
      }
#pragma unroll
    for (int kk = 0; kk < kKTile / 16; ++kk) {
      // The score fragments of keys 16 kk .. 16 kk + 15 are the A operand.
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < DT; n += 2) {
        uint32_t vb[4];  // b-registers of output n-tiles n (vb[0..1]), n + 1
        ldmatrix_x4(vb, vs + (kk * 16 + (lane & 15)) * kStride + n * 8 +
                            (lane >> 4) * 8,
                    true);
        mma_bf16(o[n], pa, vb[0], vb[1]);
        mma_bf16(o[n + 1], pa, vb[2], vb[3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], 1);
    lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= L) continue;
    const float inv = 1.f / lsum[i];
    float* dst = out + (((size_t)b * L + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<float2*>(dst + n * 8) =
          make_float2(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
  }
}

// ===========================================================================
// Backward (replaces _fused_bwd / _attn_bwd_kernel).  Per (batch, head):
//   z  = softmax(q k^T)                (recomputed, f32, normalized)
//   dz = g v^T,  delta = sum_s dz z,   dl = z (dz - delta)
//   dq = dl k,   dk = dl^T q,          dv = z^T g
// bf16 mode rounds where the JAX kernel does: q, k, v, g are bf16; dl and
// z are rounded to bf16 only where they feed a product; every sum is f32.
// Three launches and no atomics, so two runs are bit-identical:
//   1. stats: per query row the max logit m, the sum l of e = exp(s - m)
//      and delta = sum_s dz e / l, in a (3, B * H, L) f32 workspace;
//   2. dK/dV: one block per 64-key tile, looping over every query tile;
//   3. dQ: one block per 64-query tile, looping over every key tile.
// The (L, S) matrices never touch device memory; the price is that the
// logits are recomputed four times (twice in stats, once in each of 2, 3).
// ===========================================================================

// ---- f32 mode: one row per thread, FP32 FMA ----

__global__ void __launch_bounds__(kQTile)
attn_bwd_stats_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ g,
                   float* __restrict__ stats, int L, int S, int H, int BH) {
  constexpr int D = 32;
  __shared__ float ks[kKTile][D];
  __shared__ float vs[kKTile][D];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int l = blockIdx.x * kQTile + tid;
  const bool active = l < L;
  float qr[D], gr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const size_t off = (((size_t)b * L + l) * H + h) * D + d;
    qr[d] = active ? q[off] : 0.f;
    gr[d] = active ? g[off] : 0.f;
  }
  auto stage = [&](int s0, bool with_v) {
    __syncthreads();
    for (int i = tid; i < kKTile * D; i += kQTile) {
      const int j = i / D, d = i % D, s = s0 + j;
      const size_t off = (((size_t)b * S + s) * H + h) * D + d;
      ks[j][d] = s < S ? k[off] : 0.f;
      if (with_v) vs[j][d] = s < S ? v[off] : 0.f;
    }
    __syncthreads();
  };
  float m = -INFINITY;
  for (int s0 = 0; s0 < S; s0 += kKTile) {
    stage(s0, false);
    const int n = min(kKTile, S - s0);
    for (int j = 0; j < n; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[j][d], dot);
      m = fmaxf(m, dot);
    }
  }
  float lsum = 0.f, acc = 0.f;
  for (int s0 = 0; s0 < S; s0 += kKTile) {
    stage(s0, true);
    const int n = min(kKTile, S - s0);
    for (int j = 0; j < n; ++j) {
      float dot = 0.f, dz = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dot = fmaf(qr[d], ks[j][d], dot);
        dz = fmaf(gr[d], vs[j][d], dz);
      }
      const float e = expf(dot - m);
      lsum += e;
      acc = fmaf(dz, e, acc);
    }
  }
  if (active) {
    const size_t row = (size_t)bh * L + l;
    stats[row] = m;
    stats[(size_t)BH * L + row] = lsum;
    stats[2 * (size_t)BH * L + row] = acc / lsum;
  }
}

// Row statistics of queries [l0, l0 + 64) staged in shared memory; rows past
// L get m = 0, l = 1, delta = 0 (their q and g are zero: they add nothing).
__device__ __forceinline__ void stage_stats(const float* __restrict__ stats,
                                            float* ms, float* ls, float* ds,
                                            int bh, int l0, int L, int BH,
                                            int tid, int nthreads) {
  for (int i = tid; i < kQTile; i += nthreads) {
    const int l = l0 + i;
    const size_t row = (size_t)bh * L + l;
    ms[i] = l < L ? stats[row] : 0.f;
    ls[i] = l < L ? stats[(size_t)BH * L + row] : 1.f;
    ds[i] = l < L ? stats[2 * (size_t)BH * L + row] : 0.f;
  }
}

__global__ void __launch_bounds__(kKTile)
attn_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ g,
                  const float* __restrict__ stats, float* __restrict__ dk,
                  float* __restrict__ dv, int L, int S, int H, int BH) {
  constexpr int D = 32;
  __shared__ float qs[kQTile][D];
  __shared__ float gs[kQTile][D];
  __shared__ float ms[kQTile], ls[kQTile], dls[kQTile];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int s = blockIdx.x * kKTile + tid;
  const bool active = s < S;
  float kr[D], vr[D], dkr[D], dvr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const size_t off = (((size_t)b * S + s) * H + h) * D + d;
    kr[d] = active ? k[off] : 0.f;
    vr[d] = active ? v[off] : 0.f;
    dkr[d] = dvr[d] = 0.f;
  }
  for (int l0 = 0; l0 < L; l0 += kQTile) {
    __syncthreads();
    for (int i = tid; i < kQTile * D; i += kKTile) {
      const int j = i / D, d = i % D, l = l0 + j;
      const size_t off = (((size_t)b * L + l) * H + h) * D + d;
      qs[j][d] = l < L ? q[off] : 0.f;
      gs[j][d] = l < L ? g[off] : 0.f;
    }
    stage_stats(stats, ms, ls, dls, bh, l0, L, BH, tid, kKTile);
    __syncthreads();
    const int n = min(kQTile, L - l0);
    for (int j = 0; j < n; ++j) {
      float dot = 0.f, dz = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dot = fmaf(kr[d], qs[j][d], dot);
        dz = fmaf(vr[d], gs[j][d], dz);
      }
      const float z = expf(dot - ms[j]) / ls[j];
      const float dl = z * (dz - dls[j]);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dkr[d] = fmaf(dl, qs[j][d], dkr[d]);
        dvr[d] = fmaf(z, gs[j][d], dvr[d]);
      }
    }
  }
  if (active) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const size_t off = (((size_t)b * S + s) * H + h) * D + d;
      dk[off] = dkr[d];
      dv[off] = dvr[d];
    }
  }
}

__global__ void __launch_bounds__(kQTile)
attn_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ g,
                const float* __restrict__ stats, float* __restrict__ dq,
                int L, int S, int H, int BH) {
  constexpr int D = 32;
  __shared__ float ks[kKTile][D];
  __shared__ float vs[kKTile][D];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int l = blockIdx.x * kQTile + tid;
  const bool active = l < L;
  float qr[D], gr[D], dqr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const size_t off = (((size_t)b * L + l) * H + h) * D + d;
    qr[d] = active ? q[off] : 0.f;
    gr[d] = active ? g[off] : 0.f;
    dqr[d] = 0.f;
  }
  const size_t row = (size_t)bh * L + l;
  const float m = active ? stats[row] : 0.f;
  const float lsum = active ? stats[(size_t)BH * L + row] : 1.f;
  const float delta = active ? stats[2 * (size_t)BH * L + row] : 0.f;
  for (int s0 = 0; s0 < S; s0 += kKTile) {
    __syncthreads();
    for (int i = tid; i < kKTile * D; i += kQTile) {
      const int j = i / D, d = i % D, s = s0 + j;
      const size_t off = (((size_t)b * S + s) * H + h) * D + d;
      ks[j][d] = s < S ? k[off] : 0.f;
      vs[j][d] = s < S ? v[off] : 0.f;
    }
    __syncthreads();
    const int n = min(kKTile, S - s0);
    for (int j = 0; j < n; ++j) {
      float dot = 0.f, dz = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dot = fmaf(qr[d], ks[j][d], dot);
        dz = fmaf(gr[d], vs[j][d], dz);
      }
      const float z = expf(dot - m) / lsum;
      const float dl = z * (dz - delta);
#pragma unroll
      for (int d = 0; d < D; ++d) dqr[d] = fmaf(dl, ks[j][d], dqr[d]);
    }
  }
  if (active) {
#pragma unroll
    for (int d = 0; d < D; ++d)
      dq[(((size_t)b * L + l) * H + h) * D + d] = dqr[d];
  }
}

// ---- bf16 mode: mma.sync m16n8k16, one warp per 16 rows ----

constexpr int kStrideB = 32 + 8;   // bf16 row stride of a staged tile

// A-operand fragments of 16 rows (row0 ..) x 32 columns of a (B, N, H, 32)
// bf16 array; rows past n are zero.
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[2][4],
                                            const __nv_bfloat16* __restrict__ x,
                                            int b, int row0, int n, int H,
                                            int h, int lane) {
  const int gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + gq + (r & 1) * 8;
      const int col = kk * 16 + 2 * t + (r >> 1) * 8;
      a[kk][r] = row < n ? *reinterpret_cast<const uint32_t*>(
                               x + (((size_t)b * n + row) * H + h) * 32 + col)
                         : 0u;
    }
}

// Stage rows [r0, r0 + 64) of a (B, N, H, 32) bf16 array (zero past n).
__device__ __forceinline__ void stage_rows_bf16(const __nv_bfloat16* __restrict__ src,
                                                __nv_bfloat16* dst, int b,
                                                int r0, int n, int H, int h,
                                                int tid, int nthreads) {
  for (int i = tid; i < 64 * 4; i += nthreads) {
    const int r = i / 4, c = (i % 4) * 8, row = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < n)
      val = *reinterpret_cast<const uint4*>(src + (((size_t)b * n + row) * H + h) * 32 + c);
    *reinterpret_cast<uint4*>(dst + r * kStrideB + c) = val;
  }
}

// acc[n] (16 x 8 tiles n = 0..7) = A (16 x 32 fragments) times the staged
// tile's 64 rows transposed: acc[n][e] pairs A row g (+8 for e >= 2) with
// tile row 8 n + 2 t + (e & 1).
__device__ __forceinline__ void rows_times_tile(float (&acc)[8][4],
                                                const uint32_t (&a)[2][4],
                                                const __nv_bfloat16* tile,
                                                int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    uint32_t b[4];
    ldmatrix_x4(b, tile + (n * 8 + (lane & 7)) * kStrideB + (lane >> 3) * 8,
                false);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    mma_bf16(acc[n], a[0], b[0], b[1]);
    mma_bf16(acc[n], a[1], b[2], b[3]);
  }
}

// out[n] (16 x 8 tiles n = 0..3, the 32 columns) += P (16 x 64, the C
// fragments p rounded to bf16) times the staged tile (64 rows x 32).
__device__ __forceinline__ void probs_times_tile(float (&out)[4][4],
                                                 const float (&p)[8][4],
                                                 const __nv_bfloat16* tile,
                                                 int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < 4; n += 2) {
      uint32_t vb[4];
      ldmatrix_x4(vb, tile + (kk * 16 + (lane & 15)) * kStrideB + n * 8 +
                          (lane >> 4) * 8,
                  true);
      mma_bf16(out[n], pa, vb[0], vb[1]);
      mma_bf16(out[n + 1], pa, vb[2], vb[3]);
    }
  }
}

// Store 16 rows x 32 f32 columns from C fragments (rows past n skipped).
__device__ __forceinline__ void store_rows_f32(float* __restrict__ dst,
                                               const float (&o)[4][4], int b,
                                               int row0, int n, int H, int h,
                                               int lane) {
  const int gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + gq + 8 * i;
    if (row >= n) continue;
    float* p = dst + (((size_t)b * n + row) * H + h) * 32 + 2 * t;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float2*>(p + c * 8) = make_float2(o[c][2 * i], o[c][2 * i + 1]);
  }
}

__global__ void __launch_bounds__(kMmaThreads)
attn_bwd_stats_bf16(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ g,
                    float* __restrict__ stats, int L, int S, int H, int BH) {
  __shared__ __align__(16) __nv_bfloat16 ks[kKTile * kStrideB];
  __shared__ __align__(16) __nv_bfloat16 vs[kKTile * kStrideB];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kQTile + warp * 16;
  uint32_t qa[2][4], ga[2][4];
  load_a_rows(qa, q, b, row0, L, H, h, lane);
  load_a_rows(ga, g, b, row0, L, H, h, lane);
  float mx[2] = {-INFINITY, -INFINITY};
  for (int s0 = 0; s0 < S; s0 += kKTile) {
    __syncthreads();
    stage_rows_bf16(k, ks, b, s0, S, H, h, tid, kMmaThreads);
    __syncthreads();
    float sc[8][4];
    rows_times_tile(sc, qa, ks, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (s0 + n * 8 + 2 * t + (e & 1) < S) mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
  float lsum[2] = {0.f, 0.f}, acc[2] = {0.f, 0.f};
  for (int s0 = 0; s0 < S; s0 += kKTile) {
    __syncthreads();
    stage_rows_bf16(k, ks, b, s0, S, H, h, tid, kMmaThreads);
    stage_rows_bf16(v, vs, b, s0, S, H, h, tid, kMmaThreads);
    __syncthreads();
    float sc[8][4], dz[8][4];
    rows_times_tile(sc, qa, ks, lane);
    rows_times_tile(dz, ga, vs, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (s0 + n * 8 + 2 * t + (e & 1) < S) {
          const float ev = expf(sc[n][e] - mx[e >> 1]);
          lsum[e >> 1] += ev;
          acc[e >> 1] = fmaf(dz[n][e], ev, acc[e >> 1]);
        }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], 1);
    lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], 2);
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 1);
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 2);
  }
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int l = row0 + gq + 8 * i;
      if (l >= L) continue;
      const size_t row = (size_t)bh * L + l;
      stats[row] = mx[i];
      stats[(size_t)BH * L + row] = lsum[i];
      stats[2 * (size_t)BH * L + row] = acc[i] / lsum[i];
    }
  }
}

__global__ void __launch_bounds__(kMmaThreads)
attn_bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ g,
                   const float* __restrict__ stats, float* __restrict__ dk,
                   float* __restrict__ dv, int L, int S, int H, int BH) {
  __shared__ __align__(16) __nv_bfloat16 qs[kQTile * kStrideB];
  __shared__ __align__(16) __nv_bfloat16 gs[kQTile * kStrideB];
  __shared__ float ms[kQTile], ls[kQTile], dls[kQTile];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int row0 = blockIdx.x * kKTile + warp * 16;     // this warp's keys
  uint32_t ka[2][4], va[2][4];
  load_a_rows(ka, k, b, row0, S, H, h, lane);
  load_a_rows(va, v, b, row0, S, H, h, lane);
  float dko[4][4], dvo[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dko[n][e] = dvo[n][e] = 0.f;
  for (int l0 = 0; l0 < L; l0 += kQTile) {
    __syncthreads();
    stage_rows_bf16(q, qs, b, l0, L, H, h, tid, kMmaThreads);
    stage_rows_bf16(g, gs, b, l0, L, H, h, tid, kMmaThreads);
    stage_stats(stats, ms, ls, dls, bh, l0, L, BH, tid, kMmaThreads);
    __syncthreads();
    // Transposed tiles: rows are this warp's keys, columns the 64 queries.
    float z[8][4], dz[8][4];
    rows_times_tile(z, ka, qs, lane);
    rows_times_tile(dz, va, gs, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        const float zv = expf(z[n][e] - ms[c]) / ls[c];
        z[n][e] = zv;
        dz[n][e] = zv * (dz[n][e] - dls[c]);         // dl^T
      }
    probs_times_tile(dvo, z, gs, lane);
    probs_times_tile(dko, dz, qs, lane);
  }
  store_rows_f32(dk, dko, b, row0, S, H, h, lane);
  store_rows_f32(dv, dvo, b, row0, S, H, h, lane);
}

__global__ void __launch_bounds__(kMmaThreads)
attn_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ g,
                 const float* __restrict__ stats, float* __restrict__ dq,
                 int L, int S, int H, int BH) {
  __shared__ __align__(16) __nv_bfloat16 ks[kKTile * kStrideB];
  __shared__ __align__(16) __nv_bfloat16 vs[kKTile * kStrideB];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kQTile + warp * 16;
  uint32_t qa[2][4], ga[2][4];
  load_a_rows(qa, q, b, row0, L, H, h, lane);
  load_a_rows(ga, g, b, row0, L, H, h, lane);
  float m[2], lsum[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int l = row0 + gq + 8 * i;
    const size_t row = (size_t)bh * L + l;
    m[i] = l < L ? stats[row] : 0.f;
    lsum[i] = l < L ? stats[(size_t)BH * L + row] : 1.f;
    delta[i] = l < L ? stats[2 * (size_t)BH * L + row] : 0.f;
  }
  float dqo[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqo[n][e] = 0.f;
  for (int s0 = 0; s0 < S; s0 += kKTile) {
    __syncthreads();
    stage_rows_bf16(k, ks, b, s0, S, H, h, tid, kMmaThreads);
    stage_rows_bf16(v, vs, b, s0, S, H, h, tid, kMmaThreads);
    __syncthreads();
    float sc[8][4], dz[8][4];
    rows_times_tile(sc, qa, ks, lane);
    rows_times_tile(dz, ga, vs, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = s0 + n * 8 + 2 * t + (e & 1) < S;
        const float zv = in ? expf(sc[n][e] - m[e >> 1]) / lsum[e >> 1] : 0.f;
        dz[n][e] = zv * (dz[n][e] - delta[e >> 1]);   // dl
      }
    probs_times_tile(dqo, dz, ks, lane);
  }
  store_rows_f32(dq, dqo, b, row0, L, H, h, lane);
}

}  // namespace

extern "C" int nm_attention_forward(const void* q, const void* k,
                                    const void* v, void* out, int B, int L,
                                    int S, int H, int D, int bf16,
                                    void* stream) {
  if (S < 1 || L < 1 || D != 32) return (int)cudaErrorInvalidValue;
  const dim3 grid((L + kQTile - 1) / kQTile, B * H);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    attention_bf16_kernel<<<grid, kMmaThreads, 0, s>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (float*)out, L, S, H);
  else
    attention_f32_kernel<<<grid, kQTile, 0, s>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, L, S,
        H);
  return (int)cudaGetLastError();
}

// g (B, L, H, D) in the operand type; dq (B, L, H, D), dk / dv (B, S, H, D)
// f32; stats a (3, B * H, L) f32 workspace.
extern "C" int nm_attention_backward(const void* q, const void* k,
                                     const void* v, const void* g, void* dq,
                                     void* dk, void* dv, void* stats, int B,
                                     int L, int S, int H, int D, int bf16,
                                     void* stream) {
  if (S < 1 || L < 1 || D != 32) return (int)cudaErrorInvalidValue;
  const int BH = B * H;
  const dim3 qgrid((L + kQTile - 1) / kQTile, BH);
  const dim3 kgrid((S + kKTile - 1) / kKTile, BH);
  cudaStream_t s = (cudaStream_t)stream;
  float *st = (float*)stats, *dqp = (float*)dq, *dkp = (float*)dk,
        *dvp = (float*)dv;
  if (bf16) {
    const __nv_bfloat16 *qp = (const __nv_bfloat16*)q,
                        *kp = (const __nv_bfloat16*)k,
                        *vp = (const __nv_bfloat16*)v,
                        *gp = (const __nv_bfloat16*)g;
    attn_bwd_stats_bf16<<<qgrid, kMmaThreads, 0, s>>>(qp, kp, vp, gp, st, L, S, H, BH);
    attn_bwd_dkdv_bf16<<<kgrid, kMmaThreads, 0, s>>>(qp, kp, vp, gp, st, dkp, dvp, L, S, H, BH);
    attn_bwd_dq_bf16<<<qgrid, kMmaThreads, 0, s>>>(qp, kp, vp, gp, st, dqp, L, S, H, BH);
  } else {
    const float *qp = (const float*)q, *kp = (const float*)k,
                *vp = (const float*)v, *gp = (const float*)g;
    attn_bwd_stats_f32<<<qgrid, kQTile, 0, s>>>(qp, kp, vp, gp, st, L, S, H, BH);
    attn_bwd_dkdv_f32<<<kgrid, kKTile, 0, s>>>(qp, kp, vp, gp, st, dkp, dvp, L, S, H, BH);
    attn_bwd_dq_f32<<<qgrid, kQTile, 0, s>>>(qp, kp, vp, gp, st, dqp, L, S, H, BH);
  }
  return (int)cudaGetLastError();
}
