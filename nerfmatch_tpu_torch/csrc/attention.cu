// Non-causal multi-head softmax attention, forward and backward, for Hopper
// (sm_90a).  Layout (B, N, H, D) with D = 32, q pre-scaled by the caller,
// f32 outputs and gradients.  Ragged L and S are masked here, nothing is
// padded in device memory, and no (L, S) array ever touches device memory.
//
// Forward: replaces the TPU kernel nerfmatch_tpu/ops/pallas/
// attention_kernel.py: _fused_fwd (body _attn_kernel),
//   out = softmax(q k^T) v,  lse = rowmax + log(rowsum exp)   per (batch, head).
// Backward: replaces _fused_bwd (body _attn_bwd_kernel),
//   z  = exp(q k^T - lse)              (lse handed over by the forward)
//   dz = g v^T,  delta = rowsum(g * out) = sum_s dz z,  dl = z (dz - delta)
//   dq = dl k,   dk = dl^T q,          dv = z^T g.
//
// What bounds them on the H100.  At the matcher's shapes (L = S = 3600,
// D = 32, 8 heads) a call moves a few MB against 13 (forward) to 67
// (backward, B = 2) GFLOP, so the operands live in L2 and the work is on
// the SM.  At D = 32 every logit gets only 128 (forward) to 448 (backward)
// tensor-core FLOPs, but one ex2 on the special-function units (16 a clock
// an SM: more time than the products) and four or five FP32 instructions.
// The instruction stream of the softmax chain, not the tensor cores, sets
// the pace: with the exponentials or the tile loads taken out (the probe
// switches below) the kernels run only about a tenth faster on an H100,
// while 64-bit address arithmetic for the tile loads inside the loop cost
// more than either.  The design therefore
// does every product once, keeps the per-logit chain at FFMA, ex2.approx,
// one add or multiply and the paired bf16 convert, keeps the loop's
// bookkeeping in 32-bit registers set up once, and never lets a warp wait
// for a load.
//
// bf16 mode (attn_bf16 on, the matcher's default), all three kernels:
//  * One block is one warpgroup (128 threads) that owns 64 rows, and three
//    or four blocks share an SM (24.5 KB of shared memory each), so one
//    block's softmax overlaps another's products.  Two or four warpgroups
//    sharing one ring of stages were measured no faster: the L2 traffic
//    they save is not what holds the kernels.  At B = 1 the forward's 456
//    blocks are 3.45 an SM, all resident at once: the SMs with four set
//    the time, a 14% tail.
//  * The 64 x 32 bf16 tiles a block loops over (K and V, or Q and G) arrive
//    by cp.async (16 bytes a thread) in a ring of kStages stages of shared
//    memory, two tiles ahead of the one being multiplied; one
//    __syncthreads per tile.  A tile is 64 rows of 64 bytes in the 64-byte
//    swizzle, which serves wgmma both K-major (logits: rows are the N
//    index) and MN-major (outputs: rows are the K index, tnspB) without a
//    transpose.  Rows past the end are zero-filled by cp.async itself.
//  * Products: wgmma m64n64k16 for the logits and m64n32k16 for the
//    outputs, with the A operand (q, g, k, v rows; the probabilities) and
//    the f32 accumulators in registers: no ldmatrix, and one instruction
//    per 64 x 64 x 16 product, leave the instruction slots to the softmax chain
//    (mma.sync m16n8k16 on the same tiles gave the same results, slower).
//  * Forward: ONE pass over the keys.  In base 2, x = s log2(e), the
//    running reference is the row maximum so far rounded UP to an integer,
//    r = ceil(max x), so every rescale of the accumulator and the row sum
//    between tiles is an exact power of two and the result does not depend
//    on the tiling.  The rounding points are the JAX kernel's (q, k, v
//    bf16; e' = 2^(x - r) rounded to bf16 for e' v; sums f32); e' is the
//    two-pass kernel's e = exp(s - max) times 2^(max x - r) in (1/2, 1],
//    no power of two, so the two kernels' bf16 roundings of the
//    probabilities fall independently (each within 2^-8 relative).
//  * Backward: no statistics pass and no division.  A small prologue
//    launch takes delta = rowsum(g * out) and rounds g to bf16; then dK/dV
//    (one block per 64 keys, looping over the query tiles, whose lse and
//    delta ride along in the stage) and dQ (one block per 64 queries,
//    looping over the key tiles) are separate launches, the price of no
//    atomics: two runs are bit-identical.  Seven products in all.  z and
//    dl are rounded to bf16 only where they feed a product; every
//    statistic and sum is f32.
//  * Only the ragged last tile pays for masking.
//
// f32 mode (attn_bf16 off): FP32 FMA, one row per thread, flash-style
// online softmax in the forward; the same lse / delta interface.
//
// Two probe switches, set only by scripts/attention_probe.py to show what
// the bf16 kernels' time is made of (results are wrong with either):
// NM_ATTN_PROBE_NO_EX2 puts a multiply-add in place of every ex2, and
// NM_ATTN_PROBE_NO_LOADS leaves the tile loads out of the loops.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_common.cuh"

namespace {

constexpr int kQTile = 64;
constexpr int kKTile = 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ===========================================================================
// f32 mode
// ===========================================================================

__global__ void __launch_bounds__(kQTile)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int L, int S, int H) {
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
    if (lse != nullptr) lse[(size_t)bh * L + l] = m + logf(lsum);
  }
}

// stats: (2, B * H, L) f32, [0] the forward's lse (times log2(e) in bf16
// mode), [1] delta.

__global__ void __launch_bounds__(kKTile)
attn_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ g,
                  const float* __restrict__ stats, float* __restrict__ dk,
                  float* __restrict__ dv, int L, int S, int H, int BH) {
  constexpr int D = 32;
  __shared__ float qs[kQTile][D];
  __shared__ float gs[kQTile][D];
  __shared__ float ls[kQTile], dls[kQTile];
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
    for (int i = tid; i < kQTile; i += kKTile) {
      const int l = l0 + i;
      const size_t row = (size_t)bh * L + l;
      ls[i] = l < L ? stats[row] : 0.f;
      dls[i] = l < L ? stats[(size_t)BH * L + row] : 0.f;
    }
    __syncthreads();
    const int n = min(kQTile, L - l0);
    for (int j = 0; j < n; ++j) {
      float dot = 0.f, dz = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dot = fmaf(kr[d], qs[j][d], dot);
        dz = fmaf(vr[d], gs[j][d], dz);
      }
      const float z = expf(dot - ls[j]);
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
  const float lse = active ? stats[row] : 0.f;
  const float delta = active ? stats[(size_t)BH * L + row] : 0.f;
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
      const float dl = expf(dot - lse) * (dz - delta);
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

// ===========================================================================
// Small launches around the kernels
// ===========================================================================

// f32 -> bf16 of up to three arrays in one launch (blockIdx.y picks the
// array; n counts float4 groups; four independent 16-byte loads a thread).
__global__ void __launch_bounds__(256)
attention_cast_bf16(const float4* __restrict__ s0, const float4* __restrict__ s1,
                    const float4* __restrict__ s2, uint2* __restrict__ d0,
                    uint2* __restrict__ d1, uint2* __restrict__ d2, int n0,
                    int n1, int n2) {
  const float4* src = blockIdx.y == 0 ? s0 : blockIdx.y == 1 ? s1 : s2;
  uint2* dst = blockIdx.y == 0 ? d0 : blockIdx.y == 1 ? d1 : d2;
  const int n = blockIdx.y == 0 ? n0 : blockIdx.y == 1 ? n1 : n2;
  const int base = blockIdx.x * 1024 + threadIdx.x;
  float4 x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (base + 256 * j < n) x[j] = src[base + 256 * j];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (base + 256 * j < n)
      dst[base + 256 * j] = make_uint2(pack_bf16(x[j].x, x[j].y),
                                       pack_bf16(x[j].z, x[j].w));
}

// Head of the backward: per query row delta = sum_d g out with g rounded
// to the operand type first (the products see the rounded g), the
// forward's lse times lse_scale, and, where g_b is given, the bf16 copy of
// g.  Eight threads per row of 32, one float4 each.
__global__ void __launch_bounds__(256)
attn_bwd_prep(const float4* __restrict__ g, const float4* __restrict__ out,
              const float* __restrict__ lse, uint2* __restrict__ g_b,
              float* __restrict__ stats, int L, int H, int BH, int rows,
              float lse_scale) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = idx >> 3;                 // (b * L + l) * H + h
  const bool ok = row < rows;
  float4 gv = make_float4(0.f, 0.f, 0.f, 0.f), ov = gv;
  if (ok) {
    gv = g[idx];
    ov = out[idx];
    if (g_b != nullptr) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(gv.x, gv.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(gv.z, gv.w);
      g_b[idx] = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                            *reinterpret_cast<const uint32_t*>(&hi));
      gv = make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                       __high2float(hi));
    }
  }
  float d = fmaf(gv.x, ov.x, fmaf(gv.y, ov.y, fmaf(gv.z, ov.z, gv.w * ov.w)));
  d += __shfl_xor_sync(0xffffffffu, d, 1);
  d += __shfl_xor_sync(0xffffffffu, d, 2);
  d += __shfl_xor_sync(0xffffffffu, d, 4);
  if (ok && (idx & 7) == 0) {
    const int h = row % H, bl = row / H, l = bl % L, b = bl / L;
    const size_t o = ((size_t)b * H + h) * L + l;
    stats[o] = lse[o] * lse_scale;
    stats[(size_t)BH * L + o] = d;
  }
}

// ===========================================================================
// bf16 mode
// ===========================================================================

constexpr int kThreads = 128;            // one warpgroup, 64 rows
constexpr int kTileBytes = 64 * 64;      // 64 rows x 32 bf16
constexpr int kStages = 3;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

// The oldest pending stage has landed (this thread's copies); make the
// writes visible to the asynchronous proxy that wgmma reads through.
__device__ __forceinline__ void stage_landed() {
  cp_async_wait<kStages - 2>();
  fence_async();
}

// Byte offset of 16-byte chunk c (0..3) of row r in a swizzled tile.
__device__ __forceinline__ uint32_t tile_off(int r, int c) {
  return (uint32_t)(r * 64 + ((c ^ ((r >> 1) & 3)) << 4));
}

// One thread's share of the loads of head h of a (B, n, H, 32) bf16 array,
// tile after tile: 16-byte chunk c = tid & 3 of tile rows r = tid >> 2 and
// r + 32.  Rows past n are zero-filled.
struct TileLoad {
  const char* base;     // chunk c of row 0 of this batch and head
  uint32_t row_bytes;   // H * 64
  uint32_t dst;         // byte offset of (r, c) in a tile
  int r, n;

  __device__ __forceinline__ TileLoad(const __nv_bfloat16* __restrict__ src,
                                      int b, int n_, int H, int h, int tid)
      : base(reinterpret_cast<const char*>(src + ((size_t)b * n_ * H + h) * 32) +
             (tid & 3) * 16),
        row_bytes((uint32_t)H * 64),
        dst(tile_off(tid >> 2, tid & 3)),
        r(tid >> 2),
        n(n_) {}

  // Rows [r0, r0 + 64) -> the tile at shared address `tile`.
  __device__ __forceinline__ void start(uint32_t tile, int r0) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + r + 32 * i;     // the swizzle of r + 32 is that of r
      const bool ok = row < n;
      cp_async16(tile + dst + 2048 * i, base + (ok ? row * row_bytes : 0u), ok);
    }
  }
};

// A-operand fragments of 16 rows (row0 ..) x 32 columns of a (B, N, H, 32)
// bf16 array; rows past n are zero.  The layout is that of mma.sync
// m16n8k16's A and of wgmma's A in registers (warp w of the warpgroup
// holds rows 16 w ..).
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

// ---- wgmma ----

// Shared-memory matrix descriptor of a tile: start address, stride byte
// offset 512 (eight 64-byte rows; the leading byte offset is not used, since
// one swizzle row spans the tile's whole 32-element extent, and is set to
// the same), 64-byte swizzle.
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (32ull << 16) | (32ull << 32) |
         (2ull << 62);
}

template <int N>
__device__ __forceinline__ void keep(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

template <int N>
__device__ __forceinline__ void keep(uint32_t (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}

// ---- the two products ----

// acc (64 x 64; this warp's 16 rows) = A (16 x 32 fragments a warp) times
// the tile's 64 rows transposed: acc[4 n + e] pairs A row g (+8 for e >= 2)
// with tile row 8 n + 2 t + (e & 1).  Asynchronous: products_done() before
// acc is read.
__device__ __forceinline__ void rows_times_tile(float (&acc)[32],
                                                const uint32_t (&a)[2][4],
                                                uint32_t tile) {
  const uint64_t desc = tile_desc(tile);
  wgmma_fence();
  wgmma_rs<64, 0>(acc, a[0], desc, 0);
  wgmma_rs<64, 0>(acc, a[1], desc + 2, 1);        // 16 columns on: 32 bytes
}

// out (64 x 32; this warp's 16 rows) += P (16 x 64 a warp, bf16 A
// fragments pa[kk] of tile rows 16 kk ..) times the tile (64 rows x 32).
// Asynchronous: products_done() before out is read or pa is reused.
__device__ __forceinline__ void probs_times_tile(float (&out)[16],
                                                 const uint32_t (&pa)[4][4],
                                                 uint32_t tile) {
  const uint64_t desc = tile_desc(tile);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)                  // 16 rows on: 1024 bytes
    wgmma_rs<32, 1>(out, pa[kk], desc + 64 * kk, 1);
}

__device__ __forceinline__ void products_done() {
  wgmma_commit();
  wgmma_wait<0>();
}

// C fragments (16 x 64 a warp) rounded to bf16 as the next product's A.
__device__ __forceinline__ void pack_probs(uint32_t (&pa)[4][4],
                                           const float (&p)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(p[8 * kk + 2 * r], p[8 * kk + 2 * r + 1]);
}

__device__ __forceinline__ float ex2(float x) {
#ifdef NM_ATTN_PROBE_NO_EX2
  return fmaf(x, 0.001f, 1.f);
#else
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
#endif
}

// Store 16 rows x 32 f32 columns from C fragments (rows past n skipped),
// each times scale[row half].
__device__ __forceinline__ void store_rows_f32(float* __restrict__ dst,
                                               const float (&o)[16],
                                               const float (&scale)[2], int b,
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
      *reinterpret_cast<float2*>(p + c * 8) = make_float2(
          o[4 * c + 2 * i] * scale[i], o[4 * c + 2 * i + 1] * scale[i]);
  }
}

__global__ void __launch_bounds__(kThreads)
attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      float* __restrict__ out, float* __restrict__ lse, int L,
                      int S, int H) {
  __shared__ __align__(1024) unsigned char ring[kStages][2][kTileBytes];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * 64 + warp * 16;
  const uint32_t ring0 = smem_u32(ring);
  const int tiles = (S + kKTile - 1) / kKTile;
  const TileLoad k_load(k, b, S, H, h, tid), v_load(v, b, S, H, h, tid);
  auto load = [&](int j) {
    const uint32_t kt = ring0 + (j % kStages) * 2 * kTileBytes;
    k_load.start(kt, j * kKTile);
    v_load.start(kt + kTileBytes, j * kKTile);
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < tiles) load(j);
    cp_async_commit();
  }
  uint32_t qa[2][4];
  load_a_rows(qa, q, b, row0, L, H, h, lane);

  // Rows gq (index 0) and gq + 8 (index 1) of this warp's 16: the integer
  // reference r, the sum of e' = 2^(x - r) and the accumulator of
  // bf16(e') v, all in units of 2^r.
  float o[16], r[2] = {-1e30f, -1e30f}, lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = 0.f;

  for (int j = 0; j < tiles; ++j) {
    stage_landed();
    __syncthreads();   // tile j is in; every warp is done with tile j - 1
#ifndef NM_ATTN_PROBE_NO_LOADS
    if (j + kStages - 1 < tiles) load(j + kStages - 1);
#endif
    cp_async_commit();
    const uint32_t kt = ring0 + (j % kStages) * 2 * kTileBytes;
    float sc[32];
    rows_times_tile(sc, qa, kt);
    products_done();
    keep(sc);
    if (j == tiles - 1 && (S % kKTile) != 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (j * kKTile + 8 * (i >> 2) + 2 * t + (i & 1) >= S) sc[i] = -INFINITY;
    }
    float m4[4] = {sc[0], sc[1], sc[2], sc[3]};   // four independent chains
#pragma unroll
    for (int i = 4; i < 32; ++i) m4[i & 3] = fmaxf(m4[i & 3], sc[i]);
    float mx[2] = {fmaxf(m4[0], m4[1]), fmaxf(m4[2], m4[3])};
    float scale[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      const float rn = fmaxf(r[i], ceilf(mx[i] * kLog2e));
      // 2^(r - rn), exact; 0 below 2^-126 (and on the first tile).
      const float d = fmaxf(r[i] - rn, -127.f);
      scale[i] = __int_as_float((int)(d + 127.f) << 23);
      r[i] = rn;
    }
    if (__any_sync(kFull, scale[0] != 1.f || scale[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < 2; ++i) lsum[i] *= scale[i];
#pragma unroll
      for (int i = 0; i < 16; ++i) o[i] *= scale[(i >> 1) & 1];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = ex2(fmaf(sc[i], kLog2e, -r[(i >> 1) & 1]));
      lsum[(i >> 1) & 1] += sc[i];
    }
    uint32_t pa[4][4];
    pack_probs(pa, sc);
    probs_times_tile(o, pa, kt + kTileBytes);
    products_done();
    keep(o);
    keep(pa);
  }
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lsum[i] += __shfl_xor_sync(kFull, lsum[i], 1);
    lsum[i] += __shfl_xor_sync(kFull, lsum[i], 2);
    inv[i] = 1.f / lsum[i];
  }
  store_rows_f32(out, o, inv, b, row0, L, H, h, lane);
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + gq + 8 * i;
      if (row < L) lse[(size_t)bh * L + row] = (r[i] + log2f(lsum[i])) * kLn2;
    }
  }
}

// dQ: one block per 64 queries, looping over the key tiles.
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ g,
                 const float* __restrict__ stats, float* __restrict__ dq,
                 int L, int S, int H, int BH) {
  __shared__ __align__(1024) unsigned char ring[kStages][2][kTileBytes];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * 64 + warp * 16;
  const uint32_t ring0 = smem_u32(ring);
  const int tiles = (S + kKTile - 1) / kKTile;
  const TileLoad k_load(k, b, S, H, h, tid), v_load(v, b, S, H, h, tid);
  auto load = [&](int j) {
    const uint32_t kt = ring0 + (j % kStages) * 2 * kTileBytes;
    k_load.start(kt, j * kKTile);
    v_load.start(kt + kTileBytes, j * kKTile);
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < tiles) load(j);
    cp_async_commit();
  }
  uint32_t qa[2][4], ga[2][4];
  load_a_rows(qa, q, b, row0, L, H, h, lane);
  load_a_rows(ga, g, b, row0, L, H, h, lane);
  float lse2[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int l = row0 + gq + 8 * i;
    const size_t row = (size_t)bh * L + l;
    lse2[i] = l < L ? stats[row] : 0.f;
    delta[i] = l < L ? stats[(size_t)BH * L + row] : 0.f;
  }
  float dqo[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) dqo[i] = 0.f;

  for (int j = 0; j < tiles; ++j) {
    stage_landed();
    __syncthreads();
#ifndef NM_ATTN_PROBE_NO_LOADS
    if (j + kStages - 1 < tiles) load(j + kStages - 1);
#endif
    cp_async_commit();
    const uint32_t kt = ring0 + (j % kStages) * 2 * kTileBytes;
    float sc[32], dz[32];
    rows_times_tile(sc, qa, kt);
    rows_times_tile(dz, ga, kt + kTileBytes);
    products_done();
    keep(sc);
    keep(dz);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float z = ex2(fmaf(sc[i], kLog2e, -lse2[(i >> 1) & 1]));
      dz[i] = z * (dz[i] - delta[(i >> 1) & 1]);             // dl
    }
    if (j == tiles - 1 && (S % kKTile) != 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (j * kKTile + 8 * (i >> 2) + 2 * t + (i & 1) >= S) dz[i] = 0.f;
    }
    uint32_t pa[4][4];
    pack_probs(pa, dz);
    probs_times_tile(dqo, pa, kt);
    products_done();
    keep(dqo);
    keep(pa);
  }
  const float one[2] = {1.f, 1.f};
  store_rows_f32(dq, dqo, one, b, row0, L, H, h, lane);
}

// dK, dV: one block per 64 keys, looping over the query tiles.  The tiles
// are transposed: rows are this block's keys, columns the tile's queries,
// whose lse and delta ride along in the stage.
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ g,
                   const float* __restrict__ stats, float* __restrict__ dk,
                   float* __restrict__ dv, int L, int S, int H, int BH) {
  __shared__ __align__(1024) unsigned char ring[kStages][2][kTileBytes];
  __shared__ __align__(16) float rowstat[kStages][2][kQTile];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int row0 = blockIdx.x * 64 + warp * 16;      // this warp's keys
  const uint32_t ring0 = smem_u32(ring), stat0 = smem_u32(rowstat);
  const int tiles = (L + kQTile - 1) / kQTile;
  const TileLoad q_load(q, b, L, H, h, tid), g_load(g, b, L, H, h, tid);
  // Threads 0..63 bring the tile's lse, 64..127 its delta.
  const float* stat_src = stats + (size_t)(tid >> 6) * BH * L + (size_t)bh * L;
  auto load = [&](int j) {
    const int slot = j % kStages;
    const uint32_t qt = ring0 + slot * 2 * kTileBytes;
    q_load.start(qt, j * kQTile);
    g_load.start(qt + kTileBytes, j * kQTile);
    const int l = j * kQTile + (tid & 63);
    cp_async4(stat0 + (uint32_t)(slot * 2 * kQTile + tid) * 4,
              stat_src + (l < L ? l : 0), l < L);
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < tiles) load(j);
    cp_async_commit();
  }
  uint32_t ka[2][4], va[2][4];
  load_a_rows(ka, k, b, row0, S, H, h, lane);
  load_a_rows(va, v, b, row0, S, H, h, lane);
  float dko[16], dvo[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) dko[i] = dvo[i] = 0.f;

  for (int j = 0; j < tiles; ++j) {
    stage_landed();
    __syncthreads();
#ifndef NM_ATTN_PROBE_NO_LOADS
    if (j + kStages - 1 < tiles) load(j + kStages - 1);
#endif
    cp_async_commit();
    const int slot = j % kStages;
    const uint32_t qt = ring0 + slot * 2 * kTileBytes;
    float z[32], dz[32];
    rows_times_tile(z, ka, qt);
    rows_times_tile(dz, va, qt + kTileBytes);
    products_done();
    keep(z);
    keep(dz);
    // Queries past L have q = g = 0 and staged lse = delta = 0: z = 1,
    // dl = 0, and both add nothing.
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 ls = *reinterpret_cast<const float2*>(&rowstat[slot][0][8 * n + 2 * t]);
      const float2 ds = *reinterpret_cast<const float2*>(&rowstat[slot][1][8 * n + 2 * t]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * n + e;
        z[i] = ex2(fmaf(z[i], kLog2e, -((e & 1) ? ls.y : ls.x)));
        dz[i] = z[i] * (dz[i] - ((e & 1) ? ds.y : ds.x));    // dl^T
      }
    }
    uint32_t pz[4][4], pdl[4][4];
    pack_probs(pz, z);
    pack_probs(pdl, dz);
    probs_times_tile(dvo, pz, qt + kTileBytes);
    probs_times_tile(dko, pdl, qt);
    products_done();
    keep(dvo);
    keep(dko);
    keep(pz);
    keep(pdl);
  }
  const float one[2] = {1.f, 1.f};
  store_rows_f32(dk, dko, one, b, row0, S, H, h, lane);
  store_rows_f32(dv, dvo, one, b, row0, S, H, h, lane);
}

}  // namespace

// q, k, v in the operand type (bf16 != 0: bf16, else f32); out (B, L, H, D)
// f32; lse (B * H, L) f32 or null.  With `cast` (bf16 mode only), q, k and
// v arrive as f32 and are first rounded to bf16 into that workspace, laid
// out [q | k | v], by one launch; the kernel then reads the workspace.
extern "C" int nm_attention_forward(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    void* cast, int B, int L, int S, int H,
                                    int D, int bf16, void* stream) {
  if (S < 1 || L < 1 || D != 32 || (cast != nullptr && !bf16))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((L + kQTile - 1) / kQTile, B * H);
  cudaStream_t s = (cudaStream_t)stream;
  const __nv_bfloat16 *qp = (const __nv_bfloat16*)q,
                      *kp = (const __nv_bfloat16*)k,
                      *vp = (const __nv_bfloat16*)v;
  if (cast != nullptr) {
    const int nq = B * L * H * D, nk = B * S * H * D;   // multiples of 32
    __nv_bfloat16* ws = (__nv_bfloat16*)cast;
    attention_cast_bf16<<<dim3((max(nq, nk) / 4 + 1023) / 1024, 3), 256, 0, s>>>(
        (const float4*)q, (const float4*)k, (const float4*)v, (uint2*)ws,
        (uint2*)(ws + nq), (uint2*)(ws + nq + nk), nq / 4, nk / 4, nk / 4);
    qp = ws;
    kp = ws + nq;
    vp = ws + nq + nk;
  }
  if (bf16)
    attention_bf16_kernel<<<grid, kThreads, 0, s>>>(
        qp, kp, vp, (float*)out, (float*)lse, L, S, H);
  else
    attention_f32_kernel<<<grid, kQTile, 0, s>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out,
        (float*)lse, L, S, H);
  return (int)cudaGetLastError();
}

// q, k, v in the operand type; g, out (B, L, H, D) and lse (B * H, L) f32;
// dq (B, L, H, D), dk / dv (B, S, H, D) f32; g_cast a (B, L, H, D) bf16
// workspace (bf16 mode only); stats a (2, B * H, L) f32 workspace.
extern "C" int nm_attention_backward(const void* q, const void* k,
                                     const void* v, const void* g,
                                     const void* out, const void* lse,
                                     void* dq, void* dk, void* dv,
                                     void* g_cast, void* stats, int B, int L,
                                     int S, int H, int D, int bf16,
                                     void* stream) {
  if (S < 1 || L < 1 || D != 32) return (int)cudaErrorInvalidValue;
  const int BH = B * H, rows = B * L * H;
  const dim3 qgrid((L + kQTile - 1) / kQTile, BH);
  const dim3 kgrid((S + kKTile - 1) / kKTile, BH);
  cudaStream_t s = (cudaStream_t)stream;
  float *st = (float*)stats, *dqp = (float*)dq, *dkp = (float*)dk,
        *dvp = (float*)dv;
  attn_bwd_prep<<<(rows * 8 + 255) / 256, 256, 0, s>>>(
      (const float4*)g, (const float4*)out, (const float*)lse,
      bf16 ? (uint2*)g_cast : nullptr, st, L, H, BH, rows,
      bf16 ? kLog2e : 1.f);
  if (bf16) {
    const __nv_bfloat16 *qp = (const __nv_bfloat16*)q,
                        *kp = (const __nv_bfloat16*)k,
                        *vp = (const __nv_bfloat16*)v,
                        *gp = (const __nv_bfloat16*)g_cast;
    attn_bwd_dkdv_bf16<<<kgrid, kThreads, 0, s>>>(qp, kp, vp, gp, st, dkp, dvp, L, S, H, BH);
    attn_bwd_dq_bf16<<<qgrid, kThreads, 0, s>>>(qp, kp, vp, gp, st, dqp, L, S, H, BH);
  } else {
    const float *qp = (const float*)q, *kp = (const float*)k,
                *vp = (const float*)v, *gp = (const float*)g;
    attn_bwd_dkdv_f32<<<kgrid, kKTile, 0, s>>>(qp, kp, vp, gp, st, dkp, dvp, L, S, H, BH);
    attn_bwd_dq_f32<<<qgrid, kQTile, 0, s>>>(qp, kp, vp, gp, st, dqp, L, S, H, BH);
  }
  return (int)cudaGetLastError();
}
