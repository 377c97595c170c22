// Non-causal multi-head softmax attention forward for Hopper (sm_90a).
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
