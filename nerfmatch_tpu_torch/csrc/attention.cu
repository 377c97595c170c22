// Non-causal multi-head softmax attention, forward and backward, for Hopper
// (sm_90a).  Layout (B, N, H, D) with any head_dim D from 1 to 128 (the
// JAX kernel's range), q pre-scaled by the caller, f32 outputs and
// gradients.  Ragged L and S are masked here, nothing is padded in device
// memory, and no (L, S) array ever touches device memory.
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
// for a load.  The per-logit chain does not depend on D; the products grow
// with it, and from D = 64 on their least tensor-core time exceeds that of
// the exponentials.
//
// bf16 mode (attn_bf16 on, the matcher's default), all three kernels, each
// instantiated at kD = 16, 32, 64 and 128 (Tiles below); a head_dim D runs
// at the smallest kD >= D:
//  * Operands are bf16 rows of W = D rounded up to a multiple of 8 (16
//    bytes): bf16 inputs of such a D as they are, everything else through
//    the cast launch, which writes W-wide rows with zeros past D.  The
//    columns from W to kD exist only in shared memory and registers: the
//    tile loads zero-fill them (cp.async with a source size of 0) and the
//    register loads give 0.  Zero columns add nothing to q k^T, and v's
//    (and g's) give output columns that are never stored: only D columns
//    of out, dq, dk and dv are written.
//  * One block is one warpgroup (128 threads) that owns 64 rows, and
//    several blocks share an SM (kD 32: 25 KB of shared memory each; kD
//    128: 97 KB, two an SM), so one block's softmax overlaps another's
//    products.  Two or four warpgroups sharing one ring of stages were
//    measured no faster at D = 32: the L2 traffic they save is not what
//    holds the kernels.
//  * The 64 x kD bf16 tiles a block loops over (K and V, or Q and G) arrive
//    by cp.async (16 bytes a thread) in a ring of kStages stages of dynamic
//    shared memory, two tiles ahead of the one being multiplied; one
//    __syncthreads per tile.  A tile is 64 rows of 2 kD bytes in the swizzle
//    of that width (32, 64 or 128 bytes; kD = 128 keeps two 64-column
//    halves of 128-byte rows), which serves wgmma both K-major (logits:
//    rows are the N index) and MN-major (outputs: rows are the K index,
//    tnspB) without a transpose.  Rows past the end are zero-filled by
//    cp.async itself.
//  * Products: wgmma m64n64k16 for the logits (kD / 16 k-steps) and
//    m64nkDk16 for the outputs, with the A operand (q, g, k, v rows; the
//    probabilities) and the f32 accumulators in registers: no ldmatrix, and
//    one instruction per 64 x N x 16 product, leave the instruction slots
//    to the softmax chain (mma.sync m16n8k16 on the same tiles gave the
//    same results, slower, at D = 32).
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
//    launch takes delta = rowsum(g * out) over the D columns and rounds g
//    to bf16 rows of W; then dK/dV (one block per 64 keys, looping over the
//    query tiles, whose lse and delta ride along in the stage) and dQ (one
//    block per 64 queries, looping over the key tiles) are separate
//    launches, the price of no atomics: two runs are bit-identical.  Seven
//    products in all.  z and dl are rounded to bf16 only where they feed a
//    product; every statistic and sum is f32.  At kD = 128 the two 64 x 128
//    f32 accumulators of dK and dV would not fit one warpgroup's registers
//    beside the logits, so dK/dV runs as two launches over the query tiles,
//    dV (z only) and then dK, each with one accumulator.
//  * Only the ragged last tile pays for masking.
//
// f32 mode (attn_bf16 off): FP32 FMA, one row per thread over tiles of 32
// keys (queries) in shared memory, the products looping over the D
// columns; a block owns 32 output columns (blockIdx.z picks which), so a
// row's registers hold 32 accumulators whatever D is, and the logits are
// formed once per 32 output columns.  Flash-style online softmax in the
// forward; the same lse / delta interface.  Right, not fast: it is off the
// default path.
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
constexpr int kMaxD = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Operand row width: D rounded up to 16 bytes of bf16.
__host__ __device__ __forceinline__ int operand_width(int D) {
  return (D + 7) & ~7;
}

// Four f32 values row[j ..], 0 past D; one float4 load where D is a
// multiple of 4 (the row then starts on a 16-byte boundary).
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int j,
                                        int D) {
  if ((D & 3) == 0)
    return j < D ? *reinterpret_cast<const float4*>(row + j)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(j < D ? row[j] : 0.f, j + 1 < D ? row[j + 1] : 0.f,
                     j + 2 < D ? row[j + 2] : 0.f, j + 3 < D ? row[j + 3] : 0.f);
}

// ===========================================================================
// f32 mode
// ===========================================================================

constexpr int kF32Tile = 32;     // keys (queries) a stage
constexpr int kF32Cols = 32;     // output columns a block

// Rows [r0, r0 + 32) of head h of a (B, n, H, D) f32 array -> dst, columns
// up to D rounded up to 32 (zeros past D and past n).
__device__ __forceinline__ void stage_rows_f32(float (*dst)[kMaxD],
                                               const float* __restrict__ src,
                                               int b, int r0, int n, int H,
                                               int h, int D, int tid,
                                               int threads) {
  const int D32 = (D + 31) & ~31;
  for (int i = tid; i < kF32Tile * D32; i += threads) {
    const int j = i / D32, d = i % D32, r = r0 + j;
    dst[j][d] = (r < n && d < D) ? src[(((size_t)b * n + r) * H + h) * D + d]
                                 : 0.f;
  }
}

__global__ void __launch_bounds__(kQTile)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int L, int S, int H, int D) {
  __shared__ float ks[kF32Tile][kMaxD];
  __shared__ float vs[kF32Tile][kMaxD];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, c0 = blockIdx.z * kF32Cols;
  const int l = blockIdx.x * kQTile + tid;
  const bool active = l < L;
  const float* qr = q + (((size_t)b * L + (active ? l : 0)) * H + h) * D;
  float acc[kF32Cols];
#pragma unroll
  for (int c = 0; c < kF32Cols; ++c) acc[c] = 0.f;
  float m = -INFINITY, lsum = 0.f;
  for (int s0 = 0; s0 < S; s0 += kF32Tile) {
    __syncthreads();
    stage_rows_f32(ks, k, b, s0, S, H, h, D, tid, kQTile);
    stage_rows_f32(vs, v, b, s0, S, H, h, D, tid, kQTile);
    __syncthreads();
    float sc[kF32Tile];
#pragma unroll
    for (int j = 0; j < kF32Tile; ++j) sc[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d];
#pragma unroll
      for (int j = 0; j < kF32Tile; ++j) sc[j] = fmaf(qd, ks[j][d], sc[j]);
    }
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < kF32Tile; ++j) {
      if (s0 + j >= S) sc[j] = -INFINITY;
      mt = fmaxf(mt, sc[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float scale = expf(m - m_new);
    lsum *= scale;
#pragma unroll
    for (int c = 0; c < kF32Cols; ++c) acc[c] *= scale;
#pragma unroll
    for (int j = 0; j < kF32Tile; ++j) {
      const float pj = expf(sc[j] - m_new);
      lsum += pj;
#pragma unroll
      for (int c = 0; c < kF32Cols; ++c)
        acc[c] = fmaf(pj, vs[j][c0 + c], acc[c]);
    }
    m = m_new;
  }
  if (active) {
    const float inv = 1.f / lsum;
    float* o = out + (((size_t)b * L + l) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kF32Cols; ++c)
      if (c0 + c < D) o[c0 + c] = acc[c] * inv;
    if (lse != nullptr && blockIdx.z == 0)
      lse[(size_t)bh * L + l] = m + logf(lsum);
  }
}

// stats: (2, B * H, L) f32, [0] the forward's lse (times log2(e) in bf16
// mode), [1] delta.

// dK, dV: one thread per key.  Queries past L have q = g = 0 and staged
// lse = delta = 0: z = 1, dl = 0, and both add nothing.
__global__ void __launch_bounds__(kKTile)
attn_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ g,
                  const float* __restrict__ stats, float* __restrict__ dk,
                  float* __restrict__ dv, int L, int S, int H, int BH, int D) {
  __shared__ float qs[kF32Tile][kMaxD];
  __shared__ float gs[kF32Tile][kMaxD];
  __shared__ float ls[kF32Tile], dls[kF32Tile];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, c0 = blockIdx.z * kF32Cols;
  const int s = blockIdx.x * kKTile + tid;
  const bool active = s < S;
  const size_t row = (((size_t)b * S + (active ? s : 0)) * H + h) * D;
  const float *kr = k + row, *vr = v + row;
  float dkr[kF32Cols], dvr[kF32Cols];
#pragma unroll
  for (int c = 0; c < kF32Cols; ++c) dkr[c] = dvr[c] = 0.f;
  for (int l0 = 0; l0 < L; l0 += kF32Tile) {
    __syncthreads();
    stage_rows_f32(qs, q, b, l0, L, H, h, D, tid, kKTile);
    stage_rows_f32(gs, g, b, l0, L, H, h, D, tid, kKTile);
    if (tid < kF32Tile) {
      const int l = l0 + tid;
      const size_t o = (size_t)bh * L + l;
      ls[tid] = l < L ? stats[o] : 0.f;
      dls[tid] = l < L ? stats[(size_t)BH * L + o] : 0.f;
    }
    __syncthreads();
    float dot[kF32Tile], dz[kF32Tile];
#pragma unroll
    for (int j = 0; j < kF32Tile; ++j) dot[j] = dz[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d], vd = vr[d];
#pragma unroll
      for (int j = 0; j < kF32Tile; ++j) {
        dot[j] = fmaf(kd, qs[j][d], dot[j]);
        dz[j] = fmaf(vd, gs[j][d], dz[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kF32Tile; ++j) {
      const float z = expf(dot[j] - ls[j]);
      const float dl = z * (dz[j] - dls[j]);
#pragma unroll
      for (int c = 0; c < kF32Cols; ++c) {
        dkr[c] = fmaf(dl, qs[j][c0 + c], dkr[c]);
        dvr[c] = fmaf(z, gs[j][c0 + c], dvr[c]);
      }
    }
  }
  if (active) {
#pragma unroll
    for (int c = 0; c < kF32Cols; ++c)
      if (c0 + c < D) {
        dk[row + c0 + c] = dkr[c];
        dv[row + c0 + c] = dvr[c];
      }
  }
}

// dQ: one thread per query.  Keys past S have k = v = 0: dl times k adds
// nothing.
__global__ void __launch_bounds__(kQTile)
attn_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ g,
                const float* __restrict__ stats, float* __restrict__ dq,
                int L, int S, int H, int BH, int D) {
  __shared__ float ks[kF32Tile][kMaxD];
  __shared__ float vs[kF32Tile][kMaxD];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, c0 = blockIdx.z * kF32Cols;
  const int l = blockIdx.x * kQTile + tid;
  const bool active = l < L;
  const size_t row = (((size_t)b * L + (active ? l : 0)) * H + h) * D;
  const float *qr = q + row, *gr = g + row;
  const size_t srow = (size_t)bh * L + (active ? l : 0);
  const float lse = stats[srow], delta = stats[(size_t)BH * L + srow];
  float dqr[kF32Cols];
#pragma unroll
  for (int c = 0; c < kF32Cols; ++c) dqr[c] = 0.f;
  for (int s0 = 0; s0 < S; s0 += kF32Tile) {
    __syncthreads();
    stage_rows_f32(ks, k, b, s0, S, H, h, D, tid, kQTile);
    stage_rows_f32(vs, v, b, s0, S, H, h, D, tid, kQTile);
    __syncthreads();
    float dot[kF32Tile], dz[kF32Tile];
#pragma unroll
    for (int j = 0; j < kF32Tile; ++j) dot[j] = dz[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d], gd = gr[d];
#pragma unroll
      for (int j = 0; j < kF32Tile; ++j) {
        dot[j] = fmaf(qd, ks[j][d], dot[j]);
        dz[j] = fmaf(gd, vs[j][d], dz[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kF32Tile; ++j) {
      const float dl = expf(dot[j] - lse) * (dz[j] - delta);
#pragma unroll
      for (int c = 0; c < kF32Cols; ++c)
        dqr[c] = fmaf(dl, ks[j][c0 + c], dqr[c]);
    }
  }
  if (active) {
#pragma unroll
    for (int c = 0; c < kF32Cols; ++c)
      if (c0 + c < D) dq[row + c0 + c] = dqr[c];
  }
}

// ===========================================================================
// Small launches around the kernels
// ===========================================================================

// f32 -> bf16 of up to three (rows, D) arrays in one launch (blockIdx.y
// picks the array) into rows of W = operand_width(D), zeros past D.  An
// item is four columns (n counts them: rows x W / 4), four independent
// items a thread; where W == D the items are the source's float4s in
// order.
__global__ void __launch_bounds__(256)
attention_cast_bf16(const float* __restrict__ s0, const float* __restrict__ s1,
                    const float* __restrict__ s2, uint2* __restrict__ d0,
                    uint2* __restrict__ d1, uint2* __restrict__ d2, int n0,
                    int n1, int n2, int D) {
  const float* src = blockIdx.y == 0 ? s0 : blockIdx.y == 1 ? s1 : s2;
  uint2* dst = blockIdx.y == 0 ? d0 : blockIdx.y == 1 ? d1 : d2;
  const int n = blockIdx.y == 0 ? n0 : blockIdx.y == 1 ? n1 : n2;
  const int per_row = operand_width(D) / 4;
  const int base = blockIdx.x * 1024 + threadIdx.x;
  float4 x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = base + 256 * j;
    if (i >= n) continue;
    if (per_row * 4 == D) {
      x[j] = reinterpret_cast<const float4*>(src)[i];
    } else {
      const int row = i / per_row;
      x[j] = load4(src + (size_t)row * D, 4 * (i - row * per_row), D);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (base + 256 * j < n)
      dst[base + 256 * j] = make_uint2(pack_bf16(x[j].x, x[j].y),
                                       pack_bf16(x[j].z, x[j].w));
}

// Head of the backward: per query row delta = sum_d g out over the D
// columns with g rounded to the operand type first (the products see the
// rounded g), the forward's lse times lse_scale, and, where g_b is given,
// the bf16 copy of g in rows of W = operand_width(D).  kP threads a row
// (a power of two, 4 kP >= W), one float4 each.
template <int kP>
__global__ void __launch_bounds__(256)
attn_bwd_prep(const float* __restrict__ g, const float* __restrict__ out,
              const float* __restrict__ lse, uint2* __restrict__ g_b,
              float* __restrict__ stats, int L, int H, int BH, int rows,
              int D, float lse_scale) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = idx / kP, c = idx % kP;   // row: (b * L + l) * H + h
  const int W = operand_width(D);
  const bool ok = row < rows;
  float4 gv = make_float4(0.f, 0.f, 0.f, 0.f), ov = gv;
  if (ok) {
    if (4 * kP == D) {          // rows of kD columns: the float4s in order
      gv = reinterpret_cast<const float4*>(g)[idx];
      ov = reinterpret_cast<const float4*>(out)[idx];
    } else {
      gv = load4(g + (size_t)row * D, 4 * c, D);
      ov = load4(out + (size_t)row * D, 4 * c, D);
    }
    if (g_b != nullptr) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(gv.x, gv.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(gv.z, gv.w);
      if (4 * c < W)
        g_b[(size_t)row * (W / 4) + c] =
            make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                       *reinterpret_cast<const uint32_t*>(&hi));
      gv = make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                       __high2float(hi));
    }
  }
  float d = fmaf(gv.x, ov.x, fmaf(gv.y, ov.y, fmaf(gv.z, ov.z, gv.w * ov.w)));
#pragma unroll
  for (int m = 1; m < kP; m <<= 1) d += __shfl_xor_sync(0xffffffffu, d, m);
  if (ok && c == 0) {
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
constexpr int kStages = 3;
constexpr unsigned kFull = 0xffffffffu;

// The shared-memory tile of 64 rows x kD bf16 and what wgmma needs of it.
template <int kD>
struct Tiles {
  static_assert(kD == 16 || kD == 32 || kD == 64 || kD == 128,
                "attention: kD in 16, 32, 64, 128");
  static constexpr int kNC = kD / 8;                 // 16-byte chunks a row
  static constexpr int kRowB = kD < 64 ? 2 * kD : 128;   // bytes of a swizzle row
  static constexpr int kChunksPerRow = kRowB / 16;   // chunks of a swizzle row
  static constexpr int kBlockB = 64 * kRowB;         // 64 swizzle rows
  static constexpr int kBytes = 64 * 2 * kD;         // kD = 128: two blocks
  static constexpr int kSteps = kD / 16;             // k16 steps over kD
  static constexpr int kStepsPerRow = kRowB / 32;
  // Descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle.
  static constexpr uint64_t kSwizzle = kRowB == 128 ? 1 : kRowB == 64 ? 2 : 3;
  static constexpr int kLoads = kNC / 2;             // a thread's copies a tile
  static constexpr int kRowStep = kThreads / kNC;    // rows between them
  static constexpr int kSmem = kStages * 2 * kBytes + 1024;   // + alignment

  // Byte offset of 16-byte chunk c of row r: a swizzle row holds chunks
  // c ^ (address bits 7.. of the row), as the hardware reads them.
  static __device__ __forceinline__ uint32_t off(int r, int c) {
    const int cc = c % kChunksPerRow;
    return (uint32_t)((c / kChunksPerRow) * kBlockB + r * kRowB +
                      ((cc ^ ((r * kRowB >> 7) & (kChunksPerRow - 1))) << 4));
  }

  // Matrix descriptor: start address, leading byte offset kBlockB (used
  // only MN-major at kD = 128: from the first 64 columns to the next),
  // stride byte offset eight rows on.
  static __device__ __forceinline__ uint64_t desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFFu) >> 4) |
           ((uint64_t)(kBlockB >> 4) << 16) |
           ((uint64_t)(8 * kRowB >> 4) << 32) | (kSwizzle << 62);
  }
};

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

// 1024-byte aligned shared address of the dynamic ring.
__device__ __forceinline__ uint32_t ring_base() {
  extern __shared__ unsigned char smem_raw[];
  return (smem_u32(smem_raw) + 1023u) & ~1023u;
}

// One thread's share of the loads of head h of a (B, n, H, W) bf16 array,
// tile after tile: 16-byte chunk c = tid % kNC of tile rows tid / kNC + i
// kRowStep.  Rows past n are zero-filled, and so is every row of a chunk
// past W (its n is 0; it reads nothing and points at chunk 0).
template <int kD>
struct TileLoad {
  using T = Tiles<kD>;
  const char* base;     // chunk c of row 0 of this batch and head
  uint32_t row_bytes;   // H * W * 2
  uint32_t dst;         // byte offset of (r, c) in a tile
  int r, n;

  __device__ __forceinline__ TileLoad(const __nv_bfloat16* __restrict__ src,
                                      int b, int n_, int H, int h, int W,
                                      int tid)
      : base(reinterpret_cast<const char*>(src + ((size_t)b * n_ * H + h) * W) +
             ((tid % T::kNC) * 8 < W ? (tid % T::kNC) * 16 : 0)),
        row_bytes((uint32_t)H * W * 2),
        dst(T::off(tid / T::kNC, tid % T::kNC)),
        r(tid / T::kNC),
        n((tid % T::kNC) * 8 < W ? n_ : 0) {}

  // Rows [r0, r0 + 64) -> the tile at shared address `tile`.  The swizzle
  // of row r + i kRowStep is that of row r.
  __device__ __forceinline__ void start(uint32_t tile, int r0) const {
#pragma unroll
    for (int i = 0; i < T::kLoads; ++i) {
      const int row = r0 + r + T::kRowStep * i;
      const bool ok = row < n;
      cp_async16(tile + dst + T::kRowStep * T::kRowB * i,
                 base + (ok ? row * row_bytes : 0u), ok);
    }
  }
};

// A-operand fragments of 16 rows (row0 ..) x kD columns of a (B, N, H, W)
// bf16 array; rows past n and columns past W are zero.  The layout is that
// of mma.sync m16n8k16's A and of wgmma's A in registers (warp w of the
// warpgroup holds rows 16 w ..).
template <int kD>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[kD / 16][4],
                                            const __nv_bfloat16* __restrict__ x,
                                            int b, int row0, int n, int H,
                                            int h, int W, int lane) {
  const int gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + gq + (r & 1) * 8;
      const int col = kk * 16 + 2 * t + (r >> 1) * 8;
      a[kk][r] = row < n && col < W
                     ? *reinterpret_cast<const uint32_t*>(
                           x + (((size_t)b * n + row) * H + h) * W + col)
                     : 0u;
    }
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

// acc (64 x 64; this warp's 16 rows) = A (16 x kD fragments a warp) times
// the 64 rows of the tile with descriptor `desc`, transposed: acc[4 n + e]
// pairs A row g (+8 for e >= 2) with tile row 8 n + 2 t + (e & 1).  A
// step's descriptor is the tile's plus its byte offset / 16.
// Asynchronous: products_done() before acc is read.
template <int kD>
__device__ __forceinline__ void rows_times_tile(float (&acc)[32],
                                                const uint32_t (&a)[kD / 16][4],
                                                uint64_t desc) {
  using T = Tiles<kD>;
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < T::kSteps; ++s)      // 16 columns on: 32 bytes
    wgmma_rs<64, 0>(acc, a[s],
                    desc + (((s / T::kStepsPerRow) * T::kBlockB +
                             (s % T::kStepsPerRow) * 32) >> 4),
                    s > 0);
}

// out (64 x kD; this warp's 16 rows) += P (16 x 64 a warp, bf16 A
// fragments pa[kk] of tile rows 16 kk ..) times the tile (64 rows x kD)
// with descriptor `desc`.  Asynchronous: products_done() before out is
// read or pa is reused.
template <int kD>
__device__ __forceinline__ void probs_times_tile(float (&out)[kD / 2],
                                                 const uint32_t (&pa)[4][4],
                                                 uint64_t desc) {
  using T = Tiles<kD>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)           // 16 rows on
    wgmma_rs<kD, 1>(out, pa[kk], desc + ((kk * 16 * T::kRowB) >> 4), 1);
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

// Store 16 rows x the first D of kD f32 columns from C fragments (rows
// past n skipped), each times scale[row half], into a (B, n, H, D) array.
template <int kD>
__device__ __forceinline__ void store_rows_f32(float* __restrict__ dst,
                                               const float (&o)[kD / 2],
                                               const float (&scale)[2], int b,
                                               int row0, int n, int H, int h,
                                               int D, int lane) {
  const int gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + gq + 8 * i;
    if (row >= n) continue;
    float* p = dst + (((size_t)b * n + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kD / 8; ++c) {
      const int col = 8 * c + 2 * t;
      const float x0 = o[4 * c + 2 * i] * scale[i];
      const float x1 = o[4 * c + 2 * i + 1] * scale[i];
      if ((D & 1) == 0) {
        if (col < D) *reinterpret_cast<float2*>(p + col) = make_float2(x0, x1);
      } else {
        if (col < D) p[col] = x0;
        if (col + 1 < D) p[col + 1] = x1;
      }
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads)
attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      float* __restrict__ out, float* __restrict__ lse, int L,
                      int S, int H, int D) {
  using T = Tiles<kD>;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * 64 + warp * 16;
  const int W = operand_width(D);
  const uint32_t ring0 = ring_base();
  const uint64_t desc0 = T::desc(ring0);   // a stage's descriptors: + offset / 16
  const int tiles = (S + kKTile - 1) / kKTile;
  const TileLoad<kD> k_load(k, b, S, H, h, W, tid), v_load(v, b, S, H, h, W, tid);
  auto load = [&](int j) {
    const uint32_t kt = ring0 + (j % kStages) * 2 * T::kBytes;
    k_load.start(kt, j * kKTile);
    v_load.start(kt + T::kBytes, j * kKTile);
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < tiles) load(j);
    cp_async_commit();
  }
  uint32_t qa[T::kSteps][4];
  load_a_rows<kD>(qa, q, b, row0, L, H, h, W, lane);

  // Rows gq (index 0) and gq + 8 (index 1) of this warp's 16: the integer
  // reference r, the sum of e' = 2^(x - r) and the accumulator of
  // bf16(e') v, all in units of 2^r.
  float o[kD / 2], r[2] = {-1e30f, -1e30f}, lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;

  for (int j = 0; j < tiles; ++j) {
    stage_landed();
    __syncthreads();   // tile j is in; every warp is done with tile j - 1
#ifndef NM_ATTN_PROBE_NO_LOADS
    if (j + kStages - 1 < tiles) load(j + kStages - 1);
#endif
    cp_async_commit();
    const uint64_t kd = desc0 + (j % kStages) * (2 * T::kBytes >> 4);
    float sc[32];
    rows_times_tile<kD>(sc, qa, kd);
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
      for (int i = 0; i < kD / 2; ++i) o[i] *= scale[(i >> 1) & 1];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = ex2(fmaf(sc[i], kLog2e, -r[(i >> 1) & 1]));
      lsum[(i >> 1) & 1] += sc[i];
    }
    uint32_t pa[4][4];
    pack_probs(pa, sc);
    probs_times_tile<kD>(o, pa, kd + (T::kBytes >> 4));
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
  store_rows_f32<kD>(out, o, inv, b, row0, L, H, h, D, lane);
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + gq + 8 * i;
      if (row < L) lse[(size_t)bh * L + row] = (r[i] + log2f(lsum[i])) * kLn2;
    }
  }
}

// dQ: one block per 64 queries, looping over the key tiles.
template <int kD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ g,
                 const float* __restrict__ stats, float* __restrict__ dq,
                 int L, int S, int H, int BH, int D) {
  using T = Tiles<kD>;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * 64 + warp * 16;
  const int W = operand_width(D);
  const uint32_t ring0 = ring_base();
  const uint64_t desc0 = T::desc(ring0);   // a stage's descriptors: + offset / 16
  const int tiles = (S + kKTile - 1) / kKTile;
  const TileLoad<kD> k_load(k, b, S, H, h, W, tid), v_load(v, b, S, H, h, W, tid);
  auto load = [&](int j) {
    const uint32_t kt = ring0 + (j % kStages) * 2 * T::kBytes;
    k_load.start(kt, j * kKTile);
    v_load.start(kt + T::kBytes, j * kKTile);
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < tiles) load(j);
    cp_async_commit();
  }
  uint32_t qa[T::kSteps][4], ga[T::kSteps][4];
  load_a_rows<kD>(qa, q, b, row0, L, H, h, W, lane);
  load_a_rows<kD>(ga, g, b, row0, L, H, h, W, lane);
  float lse2[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int l = row0 + gq + 8 * i;
    const size_t row = (size_t)bh * L + l;
    lse2[i] = l < L ? stats[row] : 0.f;
    delta[i] = l < L ? stats[(size_t)BH * L + row] : 0.f;
  }
  float dqo[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dqo[i] = 0.f;

  for (int j = 0; j < tiles; ++j) {
    stage_landed();
    __syncthreads();
#ifndef NM_ATTN_PROBE_NO_LOADS
    if (j + kStages - 1 < tiles) load(j + kStages - 1);
#endif
    cp_async_commit();
    const uint64_t kd = desc0 + (j % kStages) * (2 * T::kBytes >> 4);
    float sc[32], dz[32];
    rows_times_tile<kD>(sc, qa, kd);
    rows_times_tile<kD>(dz, ga, kd + (T::kBytes >> 4));
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
    probs_times_tile<kD>(dqo, pa, kd);
    products_done();
    keep(dqo);
    keep(pa);
  }
  const float one[2] = {1.f, 1.f};
  store_rows_f32<kD>(dq, dqo, one, b, row0, L, H, h, D, lane);
}

// Which gradients a dK/dV launch forms: both, or (kD = 128, two launches)
// dV alone and then dK alone.
enum DkdvPass { kBoth = 0, kDvOnly = 1, kDkOnly = 2 };

// dK, dV: one block per 64 keys, looping over the query tiles.  The tiles
// are transposed: rows are this block's keys, columns the tile's queries,
// whose lse and delta ride along in the stage.
template <int kD, int kPass>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ g,
                   const float* __restrict__ stats, float* __restrict__ dk,
                   float* __restrict__ dv, int L, int S, int H, int BH, int D) {
  using T = Tiles<kD>;
  constexpr bool kDk = kPass != kDvOnly, kDv = kPass != kDkOnly;
  __shared__ __align__(16) float rowstat[kStages][2][kQTile];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int row0 = blockIdx.x * 64 + warp * 16;      // this warp's keys
  const int W = operand_width(D);
  const uint32_t ring0 = ring_base(), stat0 = smem_u32(rowstat);
  const uint64_t desc0 = T::desc(ring0);   // a stage's descriptors: + offset / 16
  const int tiles = (L + kQTile - 1) / kQTile;
  const TileLoad<kD> q_load(q, b, L, H, h, W, tid), g_load(g, b, L, H, h, W, tid);
  // Threads 0..63 bring the tile's lse, 64..127 its delta.
  const float* stat_src = stats + (size_t)(tid >> 6) * BH * L + (size_t)bh * L;
  auto load = [&](int j) {
    const int slot = j % kStages;
    const uint32_t qt = ring0 + slot * 2 * T::kBytes;
    q_load.start(qt, j * kQTile);
    g_load.start(qt + T::kBytes, j * kQTile);
    const int l = j * kQTile + (tid & 63);
    cp_async4(stat0 + (uint32_t)(slot * 2 * kQTile + tid) * 4,
              stat_src + (l < L ? l : 0), l < L);
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < tiles) load(j);
    cp_async_commit();
  }
  uint32_t ka[T::kSteps][4], va[kDk ? T::kSteps : 1][4];
  load_a_rows<kD>(ka, k, b, row0, S, H, h, W, lane);
  if constexpr (kDk) load_a_rows<kD>(va, v, b, row0, S, H, h, W, lane);
  float dko[kDk ? kD / 2 : 1], dvo[kDv ? kD / 2 : 1];
#pragma unroll
  for (int i = 0; i < (kDk ? kD / 2 : 1); ++i) dko[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kDv ? kD / 2 : 1); ++i) dvo[i] = 0.f;

  for (int j = 0; j < tiles; ++j) {
    stage_landed();
    __syncthreads();
#ifndef NM_ATTN_PROBE_NO_LOADS
    if (j + kStages - 1 < tiles) load(j + kStages - 1);
#endif
    cp_async_commit();
    const int slot = j % kStages;
    const uint64_t qd = desc0 + slot * (2 * T::kBytes >> 4);
    float z[32], dz[32];
    rows_times_tile<kD>(z, ka, qd);
    if constexpr (kDk) rows_times_tile<kD>(dz, va, qd + (T::kBytes >> 4));
    products_done();
    keep(z);
    if constexpr (kDk) keep(dz);
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
        if constexpr (kDk) dz[i] = z[i] * (dz[i] - ((e & 1) ? ds.y : ds.x));  // dl^T
      }
    }
    uint32_t pz[4][4], pdl[4][4];
    if constexpr (kDv) {
      pack_probs(pz, z);
      probs_times_tile<kD>(dvo, pz, qd + (T::kBytes >> 4));
    }
    if constexpr (kDk) {
      pack_probs(pdl, dz);
      probs_times_tile<kD>(dko, pdl, qd);
    }
    products_done();
    if constexpr (kDv) {
      keep(dvo);
      keep(pz);
    }
    if constexpr (kDk) {
      keep(dko);
      keep(pdl);
    }
  }
  const float one[2] = {1.f, 1.f};
  if constexpr (kDk) store_rows_f32<kD>(dk, dko, one, b, row0, S, H, h, D, lane);
  if constexpr (kDv) store_rows_f32<kD>(dv, dvo, one, b, row0, S, H, h, D, lane);
}

// Launch a bf16 kernel with the dynamic shared memory of its width.
template <int kD, typename Kernel, typename... Args>
cudaError_t launch_bf16(Kernel kern, dim3 grid, cudaStream_t s, Args... args) {
  constexpr int bytes = Tiles<kD>::kSmem;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, kThreads, bytes, s>>>(args...);
  return cudaGetLastError();
}

template <int kD>
cudaError_t forward_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, float* out, float* lse,
                         int B, int L, int S, int H, int D, cudaStream_t s) {
  const dim3 grid((L + kQTile - 1) / kQTile, B * H);
  return launch_bf16<kD>(attention_bf16_kernel<kD>, grid, s, q, k, v, out, lse,
                         L, S, H, D);
}

template <int kD>
cudaError_t backward_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                          const __nv_bfloat16* v, const __nv_bfloat16* g,
                          const float* st, float* dq, float* dk, float* dv,
                          int B, int L, int S, int H, int D, cudaStream_t s) {
  const int BH = B * H;
  const dim3 qgrid((L + kQTile - 1) / kQTile, BH);
  const dim3 kgrid((S + kKTile - 1) / kKTile, BH);
  cudaError_t e;
  if constexpr (kD == 128) {
    e = launch_bf16<kD>(attn_bwd_dkdv_bf16<kD, kDvOnly>, kgrid, s, q, k, v, g,
                        st, dk, dv, L, S, H, BH, D);
    if (e != cudaSuccess) return e;
    e = launch_bf16<kD>(attn_bwd_dkdv_bf16<kD, kDkOnly>, kgrid, s, q, k, v, g,
                        st, dk, dv, L, S, H, BH, D);
  } else {
    e = launch_bf16<kD>(attn_bwd_dkdv_bf16<kD, kBoth>, kgrid, s, q, k, v, g,
                        st, dk, dv, L, S, H, BH, D);
  }
  if (e != cudaSuccess) return e;
  return launch_bf16<kD>(attn_bwd_dq_bf16<kD>, qgrid, s, q, k, v, g, st, dq, L,
                         S, H, BH, D);
}

// The instantiated width a head_dim runs at (the wrapper's kernel_head_dim).
int kernel_width(int D) { return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : 128; }

template <int kP>
void launch_prep(const float* g, const float* out, const float* lse,
                 uint2* g_b, float* st, int L, int H, int BH, int rows, int D,
                 float lse_scale, cudaStream_t s) {
  const long threads = (long)rows * kP;
  attn_bwd_prep<kP><<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
      g, out, lse, g_b, st, L, H, BH, rows, D, lse_scale);
}

}  // namespace

// q, k, v in the operand type (bf16 != 0: bf16, else f32); out (B, L, H, D)
// f32; lse (B * H, L) f32 or null; 1 <= D <= 128.  bf16 operands are rows
// of W = D rounded up to a multiple of 8: given as bf16, D must be one.
// With `cast` (bf16 mode only), q, k and v arrive as f32 (B, N, H, D) and
// are first rounded into that workspace, laid out [q | k | v] in rows of W
// with zeros past D, by one launch; the kernel then reads the workspace.
extern "C" int nm_attention_forward(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    void* cast, int B, int L, int S, int H,
                                    int D, int bf16, void* stream) {
  if (S < 1 || L < 1 || D < 1 || D > kMaxD || (cast != nullptr && !bf16) ||
      (bf16 && cast == nullptr && D % 8 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!bf16) {
    const dim3 grid((L + kQTile - 1) / kQTile, B * H, (D + kF32Cols - 1) / kF32Cols);
    attention_f32_kernel<<<grid, kQTile, 0, s>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out,
        (float*)lse, L, S, H, D);
    return (int)cudaGetLastError();
  }
  const __nv_bfloat16 *qp = (const __nv_bfloat16*)q,
                      *kp = (const __nv_bfloat16*)k,
                      *vp = (const __nv_bfloat16*)v;
  if (cast != nullptr) {
    const int W = operand_width(D);
    const int nq = B * L * H * (W / 4), nk = B * S * H * (W / 4);   // items
    __nv_bfloat16* ws = (__nv_bfloat16*)cast;
    attention_cast_bf16<<<dim3(((nq > nk ? nq : nk) + 1023) / 1024, 3), 256, 0, s>>>(
        (const float*)q, (const float*)k, (const float*)v, (uint2*)ws,
        (uint2*)(ws + 4 * (size_t)nq), (uint2*)(ws + 4 * ((size_t)nq + nk)),
        nq, nk, nk, D);
    qp = ws;
    kp = ws + 4 * (size_t)nq;
    vp = ws + 4 * ((size_t)nq + nk);
  }
  float *o = (float*)out, *ls = (float*)lse;
  switch (kernel_width(D)) {
    case 16: return (int)forward_bf16<16>(qp, kp, vp, o, ls, B, L, S, H, D, s);
    case 32: return (int)forward_bf16<32>(qp, kp, vp, o, ls, B, L, S, H, D, s);
    case 64: return (int)forward_bf16<64>(qp, kp, vp, o, ls, B, L, S, H, D, s);
    default: return (int)forward_bf16<128>(qp, kp, vp, o, ls, B, L, S, H, D, s);
  }
}

// q, k, v in the operand type (bf16 rows of W = D rounded up to 8, as the
// forward's workspace holds them); g, out (B, L, H, D) and lse (B * H, L)
// f32; dq (B, L, H, D), dk / dv (B, S, H, D) f32; g_cast a (B, L, H, W)
// bf16 workspace (bf16 mode only); stats a (2, B * H, L) f32 workspace.
extern "C" int nm_attention_backward(const void* q, const void* k,
                                     const void* v, const void* g,
                                     const void* out, const void* lse,
                                     void* dq, void* dk, void* dv,
                                     void* g_cast, void* stats, int B, int L,
                                     int S, int H, int D, int bf16,
                                     void* stream) {
  if (S < 1 || L < 1 || D < 1 || D > kMaxD || (bf16 && g_cast == nullptr))
    return (int)cudaErrorInvalidValue;
  const int BH = B * H, rows = B * L * H;
  cudaStream_t s = (cudaStream_t)stream;
  float *st = (float*)stats, *dqp = (float*)dq, *dkp = (float*)dk,
        *dvp = (float*)dv;
  const float *gp = (const float*)g, *op = (const float*)out,
              *lp = (const float*)lse;
  uint2* gb = bf16 ? (uint2*)g_cast : nullptr;
  const float lse_scale = bf16 ? kLog2e : 1.f;
  switch (kernel_width(D)) {
    case 16: launch_prep<4>(gp, op, lp, gb, st, L, H, BH, rows, D, lse_scale, s); break;
    case 32: launch_prep<8>(gp, op, lp, gb, st, L, H, BH, rows, D, lse_scale, s); break;
    case 64: launch_prep<16>(gp, op, lp, gb, st, L, H, BH, rows, D, lse_scale, s); break;
    default: launch_prep<32>(gp, op, lp, gb, st, L, H, BH, rows, D, lse_scale, s); break;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (bf16) {
    const __nv_bfloat16 *qp = (const __nv_bfloat16*)q,
                        *kp = (const __nv_bfloat16*)k,
                        *vp = (const __nv_bfloat16*)v,
                        *gbp = (const __nv_bfloat16*)g_cast;
    switch (kernel_width(D)) {
      case 16: return (int)backward_bf16<16>(qp, kp, vp, gbp, st, dqp, dkp, dvp, B, L, S, H, D, s);
      case 32: return (int)backward_bf16<32>(qp, kp, vp, gbp, st, dqp, dkp, dvp, B, L, S, H, D, s);
      case 64: return (int)backward_bf16<64>(qp, kp, vp, gbp, st, dqp, dkp, dvp, B, L, S, H, D, s);
      default: return (int)backward_bf16<128>(qp, kp, vp, gbp, st, dqp, dkp, dvp, B, L, S, H, D, s);
    }
  }
  const float *qp = (const float*)q, *kp = (const float*)k,
              *vp = (const float*)v;
  const int chunks = (D + kF32Cols - 1) / kF32Cols;
  const dim3 qgrid((L + kQTile - 1) / kQTile, BH, chunks);
  const dim3 kgrid((S + kKTile - 1) / kKTile, BH, chunks);
  attn_bwd_dkdv_f32<<<kgrid, kKTile, 0, s>>>(qp, kp, vp, gp, st, dkp, dvp, L, S, H, BH, D);
  attn_bwd_dq_f32<<<qgrid, kQTile, 0, s>>>(qp, kp, vp, gp, st, dqp, L, S, H, BH, D);
  return (int)cudaGetLastError();
}
