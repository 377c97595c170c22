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
// f32 mode (attn_bf16 off), three-pass TF32 on the tensor cores, the same
// three launches (forward; dK/dV and dQ after the prologue) and lse /
// delta interface, templated on the same kD:
//  * f32 keeps 24 significant bits, TF32 11: each operand x is split into
//    big = tf32(x) and small = tf32(x - big), both rounded to nearest (the
//    tensor cores would truncate), and every product A B runs as three
//    wgmma ...f32.tf32.tf32 into one accumulator, As Bb + Ab Bs + Ab Bb:
//    about 21 bits, at 495 / 3 TFLOP/s against the 67 of the f32 FMA
//    units.  One pass would give ~1e-3; the tests hold the mode to 1e-5.
//  * TF32 wgmma reads B only K-major (no transpose, unlike bf16).  The
//    logits q k^T and g v^T read k and v rows as stored; p v, dl k, dl^T q
//    and z^T g need v, k, q and g transposed.  A split launch writes every
//    image a launch reads, big and small, head-major, rows (or columns)
//    padded to 64 with zeros and columns (rows) to kD: q, k rows and v^T
//    for the forward; q, g, k rows, their transposes and v rows for the
//    backward (14 images, 0.42 GB at B 2, L = S = 3600, H 8, D 128: a
//    tenth of that backward's time at the memory rate).  So no tile load
//    is masked, and no transpose is done in shared memory.
//  * A of the logits (q, g; k, v) stays in shared memory for the whole
//    loop (big and small: up to 128 KB at kD = 128, which registers could
//    not hold beside the accumulators); the probabilities, z and dl are
//    A from registers, split as they come out of the softmax.  TF32's A
//    fragment wants columns t and t + 4 of each 8 where the accumulator
//    gives thread t columns 2t and 2t + 1, so the transposed images store
//    each group of 8 in that order (kperm) and no register moves.
//  * Tiles are f32 rows in the 128-byte swizzle (32 floats a row of an
//    atom; 64-byte at kD = 16), kT keys (queries) a stage in a ring of kSt
//    stages, or one stage split in two copy groups (Tf32Plan: mostly
//    64-row tiles in one split stage up to kD 64, 32-row tiles at 128).  One
//    warpgroup a block, as the bf16 mode; one or two blocks an SM.
//  * The tensor cores' accumulation truncates: over thousands of keys in
//    one accumulator that shows at 1e-5.  Each tile's products go into a
//    fresh accumulator, added to the running sum in f32 registers.
//  * dK/dV is two launches (dV, then dK) from kD = 64 on: a gradient's
//    running sum and its tile accumulator, twice, would not fit beside the
//    logits.  No atomics: two runs are bit-identical.
//
// Two probe switches, set only by scripts/attention_probe.py to show what
// the kernels' time is made of (results are wrong with either):
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

// ===========================================================================
// f32 mode: three-pass TF32 on wgmma
// ===========================================================================

// Every f32-mode image (below) has its rows, or its columns, padded with
// zeros to a multiple of this.
constexpr int kImgRows = 64;

__host__ __device__ __forceinline__ int image_rows(int n) {
  return (n + kImgRows - 1) / kImgRows * kImgRows;
}

// The TF32 value nearest x (ties away from zero, as cvt.rna.tf32.f32): the
// low 13 of the 23 fraction bits cleared after adding half of the last
// bit kept.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small in TF32 values, both rounded: the products big big, big
// small and small big keep about 21 of x's 24 bits, small small (dropped)
// is 2^-22 of the product.
__device__ __forceinline__ void tf32_split(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// Position p (0..7) in a group of 8 of a transposed image holds row
// kperm(p) of the group.  A product whose A comes from an accumulator
// (the probabilities, dl) finds columns 2t and 2t + 1 of each group of 8
// in thread t's registers, where the TF32 A fragment wants columns t and
// t + 4: so K is permuted in B instead of moving registers, and register
// r of the fragment is accumulator element 2 (r & 1) + (r >> 1).
__host__ __device__ __forceinline__ int kperm(int p) {
  return 2 * (p & 3) + (p >> 2);
}

// One source array of a split launch and the images it fills: `rows`
// (big rows, then the small rows one image on) of the (B, H, n padded,
// kD) layout, and/or `cols`, its transpose (B, H, kD, n padded) in kperm
// order, big then small.  Columns past D and rows past n are zeros.
struct SplitJob {
  const float* src;   // (B, n, H, D)
  float* rows;
  float* cols;
  int n;
};
struct SplitJobs {
  SplitJob job[4];
};

// One block per 64 rows of one (batch, head) of one job (blockIdx.z).
template <int kD>
__global__ void __launch_bounds__(256)
attention_split_tf32(SplitJobs jobs, int B, int H, int D) {
  const int z = blockIdx.z;
  const SplitJob jb = z == 0 ? jobs.job[0] : z == 1 ? jobs.job[1]
                    : z == 2 ? jobs.job[2] : jobs.job[3];
  const int np = image_rows(jb.n), n0 = blockIdx.x * kImgRows;
  if (n0 >= np) return;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const size_t img = (size_t)B * H * np * kD;
  __shared__ float x[kImgRows][kD + 1];
  for (int i = threadIdx.x; i < kImgRows * kD; i += 256) {
    const int r = i / kD, c = i % kD, n = n0 + r;
    const float v = n < jb.n && c < D
                        ? jb.src[(((size_t)b * jb.n + n) * H + h) * D + c]
                        : 0.f;
    x[r][c] = v;
    if (jb.rows != nullptr) {
      uint32_t big, small;
      tf32_split(v, big, small);
      const size_t o = ((size_t)bh * np + n) * kD + c;
      jb.rows[o] = __uint_as_float(big);
      jb.rows[img + o] = __uint_as_float(small);
    }
  }
  if (jb.cols == nullptr) return;
  __syncthreads();
  for (int i = threadIdx.x; i < kImgRows * kD; i += 256) {
    const int d = i / kImgRows, p = i % kImgRows;
    uint32_t big, small;
    tf32_split(x[(p & ~7) | kperm(p & 7)][d], big, small);
    const size_t o = ((size_t)bh * kD + d) * np + n0 + p;
    jb.cols[o] = __uint_as_float(big);
    jb.cols[img + o] = __uint_as_float(small);
  }
}

// R rows of RB bytes of f32 in shared memory, K-major for wgmma (a k8 step
// is 32 bytes of every row): rows of min(RB, 128) bytes in that swizzle, an
// RB-byte row spread over RB / 128 blocks of R such rows.
template <int R, int RB>
struct F32Tile {
  static constexpr int kAtomB = RB < 128 ? RB : 128;
  static constexpr int kChunks = kAtomB / 16;        // 16-byte chunks an atom row
  static constexpr int kBlockB = R * kAtomB;
  static constexpr int kBytes = R * RB;
  static constexpr uint64_t kSwizzle = kAtomB == 128 ? 1 : kAtomB == 64 ? 2 : 3;
  static constexpr int kCopies = R * RB / 16 / kThreads;   // a thread's, a tile
  static_assert(RB % kAtomB == 0 && kAtomB >= 32 && R % 8 == 0 &&
                    R * RB % (16 * kThreads) == 0,
                "F32Tile");

  // Byte offset of 16-byte chunk c of row r.
  static __device__ __forceinline__ uint32_t off(int r, int c) {
    const int cc = c % kChunks;
    return (uint32_t)((c / kChunks) * kBlockB + r * kAtomB +
                      ((cc ^ ((r * kAtomB >> 7) & (kChunks - 1))) << 4));
  }

  // Descriptor: start address, stride byte offset eight rows on.
  static __device__ __forceinline__ uint64_t desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
           ((uint64_t)(8 * kAtomB >> 4) << 32) | (kSwizzle << 62);
  }

  // Descriptor offset (16-byte units) of k8 step s: 32 bytes of a row.
  static __device__ __forceinline__ uint32_t step(int s) {
    return (uint32_t)(((s / (kAtomB / 32)) * kBlockB +
                       (s % (kAtomB / 32)) * 32) >> 4);
  }

  // R rows of src, row_bytes apart, -> the tile at dst (cp.async).
  static __device__ __forceinline__ void load(uint32_t dst, const char* src,
                                              uint32_t row_bytes, int tid) {
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int idx = tid + i * kThreads, r = idx / (RB / 16),
                c = idx % (RB / 16);
      cp_async16(dst + off(r, c), src + r * row_bytes + c * 16, true);
    }
  }
};

// big and small of the A fragments of a k8 step from accumulator elements
// c[0..3] (see kperm).
__device__ __forceinline__ void split_frag(uint32_t (&big)[4],
                                           uint32_t (&small)[4],
                                           const float* c) {
#pragma unroll
  for (int r = 0; r < 4; ++r) tf32_split(c[2 * (r & 1) + (r >> 1)], big[r], small[r]);
}

// acc (64 x N) = the 64 rows of A tile `a` times the N rows of B tile `b`
// transposed, over 8 kSteps columns: three products a k8 step (small
// big, big small, big big); each tile holds its big image, then its small
// one.
template <typename TA, typename TB, int N, int kSteps>
__device__ __forceinline__ void rows_times_rows_tf32(float* acc, uint32_t a,
                                                     uint32_t b) {
  const uint64_t ab = TA::desc(a), as = TA::desc(a + TA::kBytes);
  const uint64_t bb = TB::desc(b), bs = TB::desc(b + TB::kBytes);
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const uint32_t x = TA::step(k), y = TB::step(k);
    wgmma_ss_tf32<N>(acc, as + x, bb + y, k > 0);
    wgmma_ss_tf32<N>(acc, ab + x, bs + y, 1);
    wgmma_ss_tf32<N>(acc, ab + x, bb + y, 1);
  }
}

// acc (64 x N) = P (64 x 8 kSteps: the accumulator p, split into big and
// small fragments) times the kSteps k8 steps of B tile `b` (N rows, big
// image then small).
template <typename TB, int N, int kSteps>
__device__ __forceinline__ void probs_times_rows_tf32(
    float* acc, const uint32_t (&pb)[kSteps][4], const uint32_t (&ps)[kSteps][4],
    uint32_t b) {
  const uint64_t bb = TB::desc(b), bs = TB::desc(b + TB::kBytes);
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const uint32_t y = TB::step(k);
    wgmma_rs_tf32<N>(acc, ps[k], bb + y, k > 0);
    wgmma_rs_tf32<N>(acc, pb[k], bs + y, 1);
    wgmma_rs_tf32<N>(acc, pb[k], bb + y, 1);
  }
}

template <int kT, int N>
__device__ __forceinline__ void split_probs(uint32_t (&pb)[kT / 8][4],
                                           uint32_t (&ps)[kT / 8][4],
                                           const float (&p)[N]) {
  static_assert(N == kT / 2, "split_probs");
#pragma unroll
  for (int k = 0; k < kT / 8; ++k) split_frag(pb[k], ps[k], p + 4 * k);
}

// The loop's tiles come through a ring of kSt stages, one copy group a
// tile, kSt - 1 tiles ahead.  With one stage (kSt = 1) a tile is two copy
// groups, its rows (the logits' B) and its transposed part (the output
// product's B): the next tile's rows load while this tile's softmax and
// output product run, its transposed part while the next logits do.
//
// Top of loop trip j: tile j's rows have landed (kSt > 1: all of tile j)
// and every warp is done with the stage they land in.
template <int kSt>
__device__ __forceinline__ void tile_landed() {
  cp_async_wait<(kSt > 1 ? kSt - 2 : 1)>();
  fence_async();
  __syncthreads();
}

// One stage, after the logits of tile j: the next tile's rows.
template <int kSt, typename Load>
__device__ __forceinline__ void next_rows(const Load& load_rows, int j,
                                          int tiles) {
  if constexpr (kSt == 1) {
    __syncthreads();
    if (j + 1 < tiles) load_rows(j + 1);
    cp_async_commit();
  }
}

// One stage, before the output product of tile j: its transposed part
// has landed.
template <int kSt>
__device__ __forceinline__ void cols_landed() {
  if constexpr (kSt == 1) {
    cp_async_wait<1>();
    fence_async();
    __syncthreads();
  }
}

// One stage, after the output product of tile j: the next tile's
// transposed part.
template <int kSt, typename Load>
__device__ __forceinline__ void next_cols(const Load& load_cols, int j,
                                          int tiles) {
  if constexpr (kSt == 1) {
    __syncthreads();
    if (j + 1 < tiles) load_cols(j + 1);
    cp_async_commit();
  }
}

// Tiles 0 .. kSt - 2 (kSt = 1: tile 0's two groups).
template <int kSt, typename Rows, typename Cols>
__device__ __forceinline__ void first_tiles(const Rows& load_rows,
                                            const Cols& load_cols,
                                            int tiles) {
  if constexpr (kSt == 1) {
    load_rows(0);
    cp_async_commit();
    load_cols(0);
    cp_async_commit();
  } else {
#pragma unroll
    for (int j = 0; j < kSt - 1; ++j) {
      if (j < tiles) {
        load_rows(j);
        load_cols(j);
      }
      cp_async_commit();
    }
  }
}

// Ring of kSt > 1 stages, top of loop trip j: tile j + kSt - 1.
template <int kSt, typename Rows, typename Cols>
__device__ __forceinline__ void next_stage(const Rows& load_rows,
                                           const Cols& load_cols, int j,
                                           int tiles) {
  if constexpr (kSt > 1) {
    if (j + kSt - 1 < tiles) {
      load_rows(j + kSt - 1);
      load_cols(j + kSt - 1);
    }
    cp_async_commit();
  }
}

// Forward: one block (a warpgroup) per 64 queries of one (batch, head),
// over tiles of kT keys in a ring of kSt stages.
template <int kD, int kT, int kSt>
struct Tf32Fwd {
  using A = F32Tile<64, 4 * kD>;     // q rows: A of the logits
  using K = F32Tile<kT, 4 * kD>;     // key rows: B of the logits (N = kT)
  using V = F32Tile<kD, 4 * kT>;     // v^T: B of the output (N = kD)
  static constexpr int kStage = 2 * (K::kBytes + V::kBytes);
  static constexpr int kSmem = 2 * A::kBytes + kSt * kStage + 1024;
};

// qi, ki: the q and k row images, vti: the v^T image (big, then small).
template <int kD, int kT, int kSt>
__global__ void __launch_bounds__(kThreads)
attention_tf32_kernel(const float* __restrict__ qi, const float* __restrict__ ki,
                      const float* __restrict__ vti, float* __restrict__ out,
                      float* __restrict__ lse, int B, int L, int S, int H,
                      int D) {
  using C = Tf32Fwd<kD, kT, kSt>;
  using A = typename C::A;
  using K = typename C::K;
  using V = typename C::V;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * 64 + warp * 16;
  const int Lp = image_rows(L), Sp = image_rows(S);
  const size_t q_img = (size_t)B * H * Lp * kD * 4,   // bytes of an image
      k_img = (size_t)B * H * Sp * kD * 4;
  const uint32_t a0 = ring_base(), st0 = a0 + 2 * A::kBytes;
  const char* qp = reinterpret_cast<const char*>(
      qi + ((size_t)bh * Lp + blockIdx.x * 64) * kD);
  const char* kp = reinterpret_cast<const char*>(ki + (size_t)bh * Sp * kD);
  const char* vp = reinterpret_cast<const char*>(vti + (size_t)bh * kD * Sp);
  const int tiles = (S + kT - 1) / kT;
  auto load_rows = [&](int j) {
    const uint32_t s = st0 + (j % kSt) * C::kStage;
    const char* kj = kp + (size_t)j * K::kBytes;
    K::load(s, kj, 4 * kD, tid);
    K::load(s + K::kBytes, kj + k_img, 4 * kD, tid);
  };
  auto load_cols = [&](int j) {
    const uint32_t s = st0 + (j % kSt) * C::kStage + 2 * K::kBytes;
    const char* vj = vp + (size_t)j * kT * 4;
    V::load(s, vj, Sp * 4, tid);
    V::load(s + V::kBytes, vj + k_img, Sp * 4, tid);
  };
  A::load(a0, qp, 4 * kD, tid);
  A::load(a0 + A::kBytes, qp + q_img, 4 * kD, tid);
  first_tiles<kSt>(load_rows, load_cols, tiles);

  // Rows gq (index 0) and gq + 8 (1) of this warp's 16: the integer
  // reference r, the sum of e' = 2^(x - r) and of e' v, in units of 2^r.
  // Each tile's e' v is formed in its own accumulator and added here in
  // f32 (the tensor cores' accumulation truncates: over thousands of keys
  // in one accumulator that would show).
  float o[kD / 2], r[2] = {-1e30f, -1e30f}, lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;

  for (int j = 0; j < tiles; ++j) {
    tile_landed<kSt>();
    next_stage<kSt>(load_rows, load_cols, j, tiles);
    const uint32_t s = st0 + (j % kSt) * C::kStage;
    float sc[kT / 2];
    wgmma_fence();
    rows_times_rows_tf32<A, K, kT, kD / 8>(sc, a0, s);
    products_done();
    keep(sc);
    next_rows<kSt>(load_rows, j, tiles);
    if (j == tiles - 1 && (S % kT) != 0) {
#pragma unroll
      for (int i = 0; i < kT / 2; ++i)
        if (j * kT + 8 * (i >> 2) + 2 * t + (i & 1) >= S) sc[i] = -INFINITY;
    }
    float m4[4] = {sc[0], sc[1], sc[2], sc[3]};
#pragma unroll
    for (int i = 4; i < kT / 2; ++i) m4[i & 3] = fmaxf(m4[i & 3], sc[i]);
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
      lsum[i] *= scale[i];
    }
#pragma unroll
    for (int i = 0; i < kT / 2; ++i) {
      sc[i] = ex2(fmaf(sc[i], kLog2e, -r[(i >> 1) & 1]));
      lsum[(i >> 1) & 1] += sc[i];
    }
    uint32_t pb[kT / 8][4], ps[kT / 8][4];
    split_probs<kT>(pb, ps, sc);
    float ot[kD / 2];
    cols_landed<kSt>();
    wgmma_fence();
    probs_times_rows_tf32<V, kD, kT / 8>(ot, pb, ps, s + 2 * K::kBytes);
    products_done();
    keep(ot);
    keep(pb);
    keep(ps);
    next_cols<kSt>(load_cols, j, tiles);
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o[i] = fmaf(o[i], scale[(i >> 1) & 1], ot[i]);
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

// dQ: one block per 64 queries, over tiles of kT keys.
template <int kD, int kT, int kSt>
struct Tf32Dq {
  using A = F32Tile<64, 4 * kD>;     // q, g rows
  using K = F32Tile<kT, 4 * kD>;     // key, value rows (N = kT)
  using Kt = F32Tile<kD, 4 * kT>;    // k^T (N = kD)
  static constexpr int kStage = 4 * K::kBytes + 2 * Kt::kBytes;
  static constexpr int kSmem = 4 * A::kBytes + kSt * kStage + 1024;
};

template <int kD, int kT, int kSt>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_tf32(const float* __restrict__ qi, const float* __restrict__ gi,
                 const float* __restrict__ ki, const float* __restrict__ vi,
                 const float* __restrict__ kti, const float* __restrict__ stats,
                 float* __restrict__ dq, int B, int L, int S, int H, int D) {
  using C = Tf32Dq<kD, kT, kSt>;
  using A = typename C::A;
  using K = typename C::K;
  using Kt = typename C::Kt;
  const int BH = B * H, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * 64 + warp * 16;
  const int Lp = image_rows(L), Sp = image_rows(S);
  const size_t q_img = (size_t)BH * Lp * kD * 4, k_img = (size_t)BH * Sp * kD * 4;
  const uint32_t a0 = ring_base(), st0 = a0 + 4 * A::kBytes;
  const size_t qrow = ((size_t)bh * Lp + blockIdx.x * 64) * kD;
  const char* qp = reinterpret_cast<const char*>(qi + qrow);
  const char* gp = reinterpret_cast<const char*>(gi + qrow);
  const char* kp = reinterpret_cast<const char*>(ki + (size_t)bh * Sp * kD);
  const char* vp = reinterpret_cast<const char*>(vi + (size_t)bh * Sp * kD);
  const char* ktp = reinterpret_cast<const char*>(kti + (size_t)bh * kD * Sp);
  const int tiles = (S + kT - 1) / kT;
  auto load_rows = [&](int j) {
    const uint32_t s = st0 + (j % kSt) * C::kStage;
    const size_t r = (size_t)j * K::kBytes;
    K::load(s, kp + r, 4 * kD, tid);
    K::load(s + K::kBytes, kp + r + k_img, 4 * kD, tid);
    K::load(s + 2 * K::kBytes, vp + r, 4 * kD, tid);
    K::load(s + 3 * K::kBytes, vp + r + k_img, 4 * kD, tid);
  };
  auto load_cols = [&](int j) {
    const uint32_t s = st0 + (j % kSt) * C::kStage + 4 * K::kBytes;
    const size_t c = (size_t)j * kT * 4;
    Kt::load(s, ktp + c, Sp * 4, tid);
    Kt::load(s + Kt::kBytes, ktp + c + k_img, Sp * 4, tid);
  };
  A::load(a0, qp, 4 * kD, tid);
  A::load(a0 + A::kBytes, qp + q_img, 4 * kD, tid);
  A::load(a0 + 2 * A::kBytes, gp, 4 * kD, tid);
  A::load(a0 + 3 * A::kBytes, gp + q_img, 4 * kD, tid);
  first_tiles<kSt>(load_rows, load_cols, tiles);
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
    tile_landed<kSt>();
    next_stage<kSt>(load_rows, load_cols, j, tiles);
    const uint32_t s = st0 + (j % kSt) * C::kStage;
    float sc[kT / 2], dz[kT / 2];
    wgmma_fence();
    rows_times_rows_tf32<A, K, kT, kD / 8>(sc, a0, s);
    rows_times_rows_tf32<A, K, kT, kD / 8>(dz, a0 + 2 * A::kBytes,
                                           s + 2 * K::kBytes);
    products_done();
    keep(sc);
    keep(dz);
    next_rows<kSt>(load_rows, j, tiles);
#pragma unroll
    for (int i = 0; i < kT / 2; ++i) {
      const float z = ex2(fmaf(sc[i], kLog2e, -lse2[(i >> 1) & 1]));
      dz[i] = z * (dz[i] - delta[(i >> 1) & 1]);             // dl
    }
    // Keys past S: k = v = 0 in the images, so dl times k adds nothing,
    // but z (and so dl) may overflow there.
    if (j == tiles - 1 && (S % kT) != 0) {
#pragma unroll
      for (int i = 0; i < kT / 2; ++i)
        if (j * kT + 8 * (i >> 2) + 2 * t + (i & 1) >= S) dz[i] = 0.f;
    }
    uint32_t pb[kT / 8][4], ps[kT / 8][4];
    split_probs<kT>(pb, ps, dz);
    float dqt[kD / 2];
    cols_landed<kSt>();
    wgmma_fence();
    probs_times_rows_tf32<Kt, kD, kT / 8>(dqt, pb, ps, s + 4 * K::kBytes);
    products_done();
    keep(dqt);
    keep(pb);
    keep(ps);
    next_cols<kSt>(load_cols, j, tiles);
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) dqo[i] += dqt[i];
  }
  const float one[2] = {1.f, 1.f};
  store_rows_f32<kD>(dq, dqo, one, b, row0, L, H, h, D, lane);
}

// dK, dV: one block per 64 keys, over tiles of kT queries, whose lse and
// delta ride along in the stage.  kD >= 64: two launches, dV and then dK
// (each gradient keeps a tile accumulator beside its sum).
template <int kD, int kT, int kSt, int kPass>
struct Tf32Dkdv {
  static constexpr bool kDk = kPass != kDvOnly, kDv = kPass != kDkOnly;
  using A = F32Tile<64, 4 * kD>;     // k (and v) rows of the block's keys
  using Q = F32Tile<kT, 4 * kD>;     // q (and g) rows (N = kT)
  using Qt = F32Tile<kD, 4 * kT>;    // q^T, g^T (N = kD)
  // A stage: q rows, [g rows, q^T] (dK), [g^T] (dV), big and small each.
  static constexpr int kG = 2 * Q::kBytes, kQt = kG + (kDk ? 2 * Q::kBytes : 0),
                       kGt = kQt + (kDk ? 2 * Qt::kBytes : 0),
                       kStage = kGt + (kDv ? 2 * Qt::kBytes : 0);
  static constexpr int kSmem = (kDk ? 4 : 2) * A::kBytes + kSt * kStage + 1024;
};

template <int kD, int kT, int kSt, int kPass>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_tf32(const float* __restrict__ ki, const float* __restrict__ vi,
                   const float* __restrict__ qi, const float* __restrict__ gi,
                   const float* __restrict__ qti, const float* __restrict__ gti,
                   const float* __restrict__ stats, float* __restrict__ dk,
                   float* __restrict__ dv, int B, int L, int S, int H, int D) {
  using C = Tf32Dkdv<kD, kT, kSt, kPass>;
  using A = typename C::A;
  using Q = typename C::Q;
  using Qt = typename C::Qt;
  constexpr bool kDk = C::kDk, kDv = C::kDv;
  // The tiles' lse and delta ride with their rows: one stage still keeps
  // two (the next tile's arrive during this one's softmax).
  constexpr int kStats = kSt > 1 ? kSt : 2;
  __shared__ __align__(16) float rowstat[kStats][2][kT];
  const int BH = B * H, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int row0 = blockIdx.x * 64 + warp * 16;      // this warp's keys
  const int Lp = image_rows(L), Sp = image_rows(S);
  const size_t q_img = (size_t)BH * Lp * kD * 4, k_img = (size_t)BH * Sp * kD * 4;
  const uint32_t a0 = ring_base(), st0 = a0 + (kDk ? 4 : 2) * A::kBytes;
  const uint32_t stat0 = smem_u32(rowstat);
  const size_t krow = ((size_t)bh * Sp + blockIdx.x * 64) * kD;
  const char* kp = reinterpret_cast<const char*>(ki + krow);
  const char* vp = reinterpret_cast<const char*>(vi + krow);
  const char* qp = reinterpret_cast<const char*>(qi + (size_t)bh * Lp * kD);
  const char* gp = reinterpret_cast<const char*>(gi + (size_t)bh * Lp * kD);
  const char* qtp = reinterpret_cast<const char*>(qti + (size_t)bh * kD * Lp);
  const char* gtp = reinterpret_cast<const char*>(gti + (size_t)bh * kD * Lp);
  // Threads 0 .. kT - 1 bring the tile's lse, kT .. 2 kT - 1 its delta.
  const float* stat_src = stats + (size_t)(tid / kT) * BH * L + (size_t)bh * L;
  const int tiles = (L + kT - 1) / kT;
  auto load_rows = [&](int j) {
    const uint32_t s = st0 + (j % kSt) * C::kStage;
    const size_t r = (size_t)j * Q::kBytes;
    Q::load(s, qp + r, 4 * kD, tid);
    Q::load(s + Q::kBytes, qp + r + q_img, 4 * kD, tid);
    if constexpr (kDk) {
      Q::load(s + C::kG, gp + r, 4 * kD, tid);
      Q::load(s + C::kG + Q::kBytes, gp + r + q_img, 4 * kD, tid);
    }
    if (tid < 2 * kT) {
      const int l = j * kT + tid % kT;
      cp_async4(stat0 + (uint32_t)((j % kStats) * 2 * kT + tid) * 4,
                stat_src + (l < L ? l : 0), l < L);
    }
  };
  auto load_cols = [&](int j) {
    const uint32_t s = st0 + (j % kSt) * C::kStage;
    const size_t c = (size_t)j * kT * 4;
    if constexpr (kDk) {
      Qt::load(s + C::kQt, qtp + c, Lp * 4, tid);
      Qt::load(s + C::kQt + Qt::kBytes, qtp + c + q_img, Lp * 4, tid);
    }
    if constexpr (kDv) {
      Qt::load(s + C::kGt, gtp + c, Lp * 4, tid);
      Qt::load(s + C::kGt + Qt::kBytes, gtp + c + q_img, Lp * 4, tid);
    }
  };
  A::load(a0, kp, 4 * kD, tid);
  A::load(a0 + A::kBytes, kp + k_img, 4 * kD, tid);
  if constexpr (kDk) {
    A::load(a0 + 2 * A::kBytes, vp, 4 * kD, tid);
    A::load(a0 + 3 * A::kBytes, vp + k_img, 4 * kD, tid);
  }
  first_tiles<kSt>(load_rows, load_cols, tiles);
  constexpr int kNk = kDk ? kD / 2 : 1, kNv = kDv ? kD / 2 : 1;
  float dko[kNk], dvo[kNv];
#pragma unroll
  for (int i = 0; i < kNk; ++i) dko[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kNv; ++i) dvo[i] = 0.f;

  for (int j = 0; j < tiles; ++j) {
    tile_landed<kSt>();
    next_stage<kSt>(load_rows, load_cols, j, tiles);
    const int slot = j % kStats;
    const uint32_t s = st0 + (j % kSt) * C::kStage;
    float z[kT / 2], dz[kT / 2];
    wgmma_fence();
    rows_times_rows_tf32<A, Q, kT, kD / 8>(z, a0, s);
    if constexpr (kDk)
      rows_times_rows_tf32<A, Q, kT, kD / 8>(dz, a0 + 2 * A::kBytes, s + C::kG);
    products_done();
    keep(z);
    if constexpr (kDk) keep(dz);
    next_rows<kSt>(load_rows, j, tiles);
    // Queries past L have q = g = 0 in the images and staged lse = delta =
    // 0: z = 1, dl = 0, and both add nothing.
#pragma unroll
    for (int n = 0; n < kT / 8; ++n) {
      const float2 ls = *reinterpret_cast<const float2*>(&rowstat[slot][0][8 * n + 2 * t]);
      const float2 ds = *reinterpret_cast<const float2*>(&rowstat[slot][1][8 * n + 2 * t]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * n + e;
        z[i] = ex2(fmaf(z[i], kLog2e, -((e & 1) ? ls.y : ls.x)));
        if constexpr (kDk) dz[i] = z[i] * (dz[i] - ((e & 1) ? ds.y : ds.x));  // dl^T
      }
    }
    uint32_t pzb[kT / 8][4], pzs[kT / 8][4], pdb[kT / 8][4], pds[kT / 8][4];
    if constexpr (kDv) split_probs<kT>(pzb, pzs, z);
    if constexpr (kDk) split_probs<kT>(pdb, pds, dz);
    float dvt[kNv], dkt[kNk];
    cols_landed<kSt>();
    wgmma_fence();
    if constexpr (kDv)
      probs_times_rows_tf32<Qt, kD, kT / 8>(dvt, pzb, pzs, s + C::kGt);
    if constexpr (kDk)
      probs_times_rows_tf32<Qt, kD, kT / 8>(dkt, pdb, pds, s + C::kQt);
    products_done();
    if constexpr (kDv) {
      keep(dvt);
      keep(pzb);
      keep(pzs);
    }
    if constexpr (kDk) {
      keep(dkt);
      keep(pdb);
      keep(pds);
    }
    next_cols<kSt>(load_cols, j, tiles);
#pragma unroll
    for (int i = 0; i < kNv; ++i)
      if constexpr (kDv) dvo[i] += dvt[i];
#pragma unroll
    for (int i = 0; i < kNk; ++i)
      if constexpr (kDk) dko[i] += dkt[i];
  }
  const float one[2] = {1.f, 1.f};
  if constexpr (kDk) store_rows_f32<kD>(dk, dko, one, b, row0, S, H, h, D, lane);
  if constexpr (kDv) store_rows_f32<kD>(dv, dvo, one, b, row0, S, H, h, D, lane);
}

// Launch an f32-mode kernel with `bytes` of dynamic shared memory.
template <typename Kernel, typename... Args>
cudaError_t launch_tf32(Kernel kern, int bytes, dim3 grid, cudaStream_t s,
                        Args... args) {
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, kThreads, bytes, s>>>(args...);
  return cudaGetLastError();
}

// Tile rows (kT) and stages (kSt) of each f32-mode launch by width, the
// fastest measured on an H100: 64-row tiles in one split stage up to kD
// 64 (two stages for kD 16's backward), against 32-row tiles in two
// stages (64 rows put the logits' B beside their A in shared-memory
// reads); at kD 128, where a block's fixed operands alone take 64 or 128
// KB, 64-row tiles spill, and 32-row tiles run in two stages or one.
template <int kD>
struct Tf32Plan {
  static constexpr int kT = kD <= 64 ? 64 : 32;       // every launch
  static constexpr int kFwdSt = kD <= 64 ? 1 : 2, kDqSt = kD == 16 ? 2 : 1;
  static constexpr bool kKvSplit = kD >= 64;         // dV, then dK
  // dK/dV (kKvSplit: dV alone), then dK alone.
  static constexpr int kKvSt = kD == 16 || kD == 128 ? 2 : 1, kDkSt = 1;
};

template <int kD>
cudaError_t split_tf32(const SplitJobs& jobs, int n_jobs, int n_max, int B,
                       int H, int D, cudaStream_t s) {
  attention_split_tf32<kD><<<dim3(image_rows(n_max) / kImgRows, B * H, n_jobs),
                             256, 0, s>>>(jobs, B, H, D);
  return cudaGetLastError();
}

// ws: the q, k row images and the v^T image, 2 B H kD (Lp + 2 Sp) floats.
template <int kD>
cudaError_t forward_tf32(const float* q, const float* k, const float* v,
                         float* out, float* lse, float* ws, int B, int L,
                         int S, int H, int D, cudaStream_t s) {
  using P = Tf32Plan<kD>;
  const size_t q_img = (size_t)B * H * image_rows(L) * kD,
               k_img = (size_t)B * H * image_rows(S) * kD;
  float *qi = ws, *ki = qi + 2 * q_img, *vti = ki + 2 * k_img;
  const SplitJobs jobs = {{{q, qi, nullptr, L}, {k, ki, nullptr, S},
                           {v, nullptr, vti, S}, {nullptr, nullptr, nullptr, 0}}};
  cudaError_t e = split_tf32<kD>(jobs, 3, L > S ? L : S, B, H, D, s);
  if (e != cudaSuccess) return e;
  constexpr int kT = P::kT, kSt = P::kFwdSt;
  return launch_tf32(attention_tf32_kernel<kD, kT, kSt>,
                     Tf32Fwd<kD, kT, kSt>::kSmem,
                     dim3(image_rows(L) / 64, B * H), s, (const float*)qi,
                     (const float*)ki, (const float*)vti, out, lse, B, L, S, H,
                     D);
}

// ws: the q, g row and transposed images, the k row and transposed
// images and the v row image, B H kD (8 Lp + 6 Sp) floats.
template <int kD>
cudaError_t backward_tf32(const float* q, const float* k, const float* v,
                          const float* g, const float* st, float* dq,
                          float* dk, float* dv, float* ws, int B, int L,
                          int S, int H, int D, cudaStream_t s) {
  using P = Tf32Plan<kD>;
  const size_t q_img = (size_t)B * H * image_rows(L) * kD,
               k_img = (size_t)B * H * image_rows(S) * kD;
  float *qi = ws, *qti = qi + 2 * q_img, *gi = qti + 2 * q_img,
        *gti = gi + 2 * q_img, *ki = gti + 2 * q_img, *kti = ki + 2 * k_img,
        *vi = kti + 2 * k_img;
  const SplitJobs jobs = {{{q, qi, qti, L}, {g, gi, gti, L}, {k, ki, kti, S},
                           {v, vi, nullptr, S}}};
  cudaError_t e = split_tf32<kD>(jobs, 4, L > S ? L : S, B, H, D, s);
  if (e != cudaSuccess) return e;
  const dim3 qgrid(image_rows(L) / 64, B * H), kgrid(image_rows(S) / 64, B * H);
  constexpr int kT = P::kT;
  if constexpr (P::kKvSplit) {
    constexpr int kV = P::kKvSt, kK = P::kDkSt;
    e = launch_tf32(attn_bwd_dkdv_tf32<kD, kT, kV, kDvOnly>,
                    Tf32Dkdv<kD, kT, kV, kDvOnly>::kSmem, kgrid, s,
                    (const float*)ki, (const float*)vi, (const float*)qi,
                    (const float*)gi, (const float*)qti, (const float*)gti, st,
                    dk, dv, B, L, S, H, D);
    if (e != cudaSuccess) return e;
    e = launch_tf32(attn_bwd_dkdv_tf32<kD, kT, kK, kDkOnly>,
                    Tf32Dkdv<kD, kT, kK, kDkOnly>::kSmem, kgrid, s,
                    (const float*)ki, (const float*)vi, (const float*)qi,
                    (const float*)gi, (const float*)qti, (const float*)gti, st,
                    dk, dv, B, L, S, H, D);
  } else {
    constexpr int kSt = P::kKvSt;
    e = launch_tf32(attn_bwd_dkdv_tf32<kD, kT, kSt, kBoth>,
                    Tf32Dkdv<kD, kT, kSt, kBoth>::kSmem, kgrid, s,
                    (const float*)ki, (const float*)vi, (const float*)qi,
                    (const float*)gi, (const float*)qti, (const float*)gti, st,
                    dk, dv, B, L, S, H, D);
  }
  if (e != cudaSuccess) return e;
  constexpr int kQSt = P::kDqSt;
  return launch_tf32(attn_bwd_dq_tf32<kD, kT, kQSt>,
                     Tf32Dq<kD, kT, kQSt>::kSmem, qgrid, s, (const float*)qi,
                     (const float*)gi, (const float*)ki, (const float*)vi,
                     (const float*)kti, st, dq, B, L, S, H, D);
}

}  // namespace

// q, k, v in the operand type (bf16 != 0: bf16, else f32); out (B, L, H, D)
// f32; lse (B * H, L) f32 or null; 1 <= D <= 128.  bf16 operands are rows
// of W = D rounded up to a multiple of 8: given as bf16, D must be one.
// With `cast` in bf16 mode, q, k and v arrive as f32 (B, N, H, D) and are
// first rounded into that workspace, laid out [q | k | v] in rows of W
// with zeros past D, by one launch; the kernel then reads the workspace.
// The f32 mode takes f32 (B, N, H, D) q, k, v and needs `cast`: the split
// launch's TF32 images, 2 B H kD (Lp + 2 Sp) floats (kD = kernel_width(D),
// Lp, Sp = L, S rounded up to 64).
extern "C" int nm_attention_forward(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    void* cast, int B, int L, int S, int H,
                                    int D, int bf16, void* stream) {
  if (S < 1 || L < 1 || D < 1 || D > kMaxD || (cast == nullptr && !bf16) ||
      (bf16 && cast == nullptr && D % 8 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!bf16) {
    const float *qf = (const float*)q, *kf = (const float*)k,
                *vf = (const float*)v;
    float *o = (float*)out, *ls = (float*)lse, *ws = (float*)cast;
    switch (kernel_width(D)) {
      case 16: return (int)forward_tf32<16>(qf, kf, vf, o, ls, ws, B, L, S, H, D, s);
      case 32: return (int)forward_tf32<32>(qf, kf, vf, o, ls, ws, B, L, S, H, D, s);
      case 64: return (int)forward_tf32<64>(qf, kf, vf, o, ls, ws, B, L, S, H, D, s);
      default: return (int)forward_tf32<128>(qf, kf, vf, o, ls, ws, B, L, S, H, D, s);
    }
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
// forward's workspace holds them; f32 (B, N, H, D)); g, out (B, L, H, D)
// and lse (B * H, L) f32; dq (B, L, H, D), dk / dv (B, S, H, D) f32;
// g_cast a (B, L, H, W) bf16 workspace in bf16 mode, the split launch's
// TF32 images in f32 mode (B H kD (8 Lp + 6 Sp) floats); stats a
// (2, B * H, L) f32 workspace.
extern "C" int nm_attention_backward(const void* q, const void* k,
                                     const void* v, const void* g,
                                     const void* out, const void* lse,
                                     void* dq, void* dk, void* dv,
                                     void* g_cast, void* stats, int B, int L,
                                     int S, int H, int D, int bf16,
                                     void* stream) {
  if (S < 1 || L < 1 || D < 1 || D > kMaxD || g_cast == nullptr)
    return (int)cudaErrorInvalidValue;
  const int BH = B * H, rows = B * L * H;
  cudaStream_t s = (cudaStream_t)stream;
  float *st = (float*)stats, *dqp = (float*)dq, *dkp = (float*)dk,
        *dvp = (float*)dv;
  const float *gp = (const float*)g, *op = (const float*)out,
              *lp = (const float*)lse;
  uint2* gb = bf16 ? (uint2*)g_cast : nullptr;
  const float lse_scale = kLog2e;
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
  float* ws = (float*)g_cast;
  switch (kernel_width(D)) {
    case 16: return (int)backward_tf32<16>(qp, kp, vp, gp, st, dqp, dkp, dvp, ws, B, L, S, H, D, s);
    case 32: return (int)backward_tf32<32>(qp, kp, vp, gp, st, dqp, dkp, dvp, ws, B, L, S, H, D, s);
    case 64: return (int)backward_tf32<64>(qp, kp, vp, gp, st, dqp, dkp, dvp, ws, B, L, S, H, D, s);
    default: return (int)backward_tf32<128>(qp, kp, vp, gp, st, dqp, dkp, dvp, ws, B, L, S, H, D, s);
  }
}
