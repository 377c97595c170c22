// The NeRF train-render stage's weight-gradient GEMM, its reductions, the
// appearance-row gradient and the C entries (kernels 5 and 6: the forward
// and the trunk backward are render_train.cuh, instantiated at each width
// in render_train_<HID>.cu).

#include "render_train.cuh"

namespace {

constexpr int kMaxProds = 2 * kMaxLayers + 4;
constexpr int kMaxSplits = 48;

// ---- backward launch 2: weight gradients, C (M x N) = sum over rows of A[row]^T B[row]
//      (bf16 operands, f32 sums), one 128 x bn output tile per block and
//      row range ----

constexpr int kGemmThreads = 256;   // two warpgroups: output rows 0-63, 64-127
constexpr int kGemmStages = 4;
constexpr int kGemmK = 64;          // sample rows a stage
constexpr int kGemmBlock = kGemmK * 128;              // 64 rows x 64 bf16
constexpr int kGemmStageBytes = 6 * kGemmBlock;       // A: 2 blocks, B: up to 4
constexpr size_t kGemmSmem = 1024 + (size_t)kGemmStages * kGemmStageBytes;

struct Prod {
  const __nv_bfloat16* A;  // (rows, M) row-major, M % 8 == 0
  const __nv_bfloat16* B;  // (rows, N) row-major, N % 8 == 0
  int M, N, rows;
  long long out_off;       // into the (M x N) row-major output block
  int tile0, ntn, bn;      // first tile index, n-tiles, n-tile width
};
struct ProdTable {
  Prod p[kMaxProds];
  int count;
};

__global__ void __launch_bounds__(kGemmThreads, 1)
wgrad_gemm_kernel(ProdTable tab, long long total, float* __restrict__ part) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sm0 = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tile = blockIdx.x;
  int pi = 0;
  while (pi + 1 < tab.count && tile >= tab.p[pi + 1].tile0) ++pi;
  const Prod prod = tab.p[pi];
  const int lt = tile - prod.tile0, bn = prod.bn;
  const int m0 = (lt / prod.ntn) * 128, n0 = (lt % prod.ntn) * bn;
  int per = (prod.rows + gridDim.y - 1) / gridDim.y;
  per = (per + kGemmK - 1) / kGemmK * kGemmK;
  const int r0 = min(prod.rows, (int)blockIdx.y * per);
  const int r1 = min(prod.rows, r0 + per);
  const int nsl = (r1 - r0 + kGemmK - 1) / kGemmK;
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const bool active = m0 + 64 * wg < prod.M;
  const int bsh = bn == 256 ? 5 : bn == 128 ? 4 : 3;   // log2 16-byte chunks a B row

  // Stage s: rows r0 + 64 s .. of A (128 columns from m0) and B (bn from
  // n0), MN-major; columns past M / N and rows past r1 zero-filled.
  auto load = [&](int s) {
    const uint32_t sb = sm0 + (uint32_t)(s % kGemmStages) * kGemmStageBytes;
    const int rb = r0 + s * kGemmK;
#pragma unroll
    for (int i = tid; i < kGemmK * 16; i += kGemmThreads) {
      const int row = i >> 4, c = i & 15, gr = rb + row, col = m0 + c * 8;
      const bool ok = gr < r1 && col < prod.M;
      cp_async16(sb + (c >> 3) * kGemmBlock + swz(row, c & 7),
                 ok ? prod.A + (size_t)gr * prod.M + col : prod.A, ok);
    }
    for (int i = tid; i < (kGemmK << bsh); i += kGemmThreads) {
      const int row = i >> bsh, c = i & ((1 << bsh) - 1), gr = rb + row,
                col = n0 + c * 8;
      const bool ok = gr < r1 && col < prod.N;
      cp_async16(sb + (2 + (c >> 3)) * kGemmBlock + swz(row, c & 7),
                 ok ? prod.B + (size_t)gr * prod.N + col : prod.B, ok);
    }
  };

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < kGemmStages - 1; ++s) {
    if (s < nsl) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < nsl; ++s) {
    cp_async_wait<kGemmStages - 2>();
    fence_async();
    __syncthreads();   // stage s landed; every wgmma on stage s - 1 is done
    if (s + kGemmStages - 1 < nsl) load(s + kGemmStages - 1);
    cp_async_commit();
    if (active) {
      const uint32_t sb = sm0 + (uint32_t)(s % kGemmStages) * kGemmStageBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGemmK / 16; ++kk) {   // 16 rows on: 2048 bytes
        const uint64_t da = desc128(sb + wg * kGemmBlock + kk * 2048, kGemmBlock);
        const uint64_t db = desc128(sb + 2 * kGemmBlock + kk * 2048, kGemmBlock);
        if (bn == 256) wgmma_ss<256>(acc, da, db, 1);
        else if (bn == 128) wgmma_ss<128>(acc, da, db, 1);
        else wgmma_ss<64>(acc, da, db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
    }
  }
  cp_async_wait<0>();
  if (!active) return;
  float* out = part + (size_t)blockIdx.y * total + prod.out_off;
  const int row0 = m0 + 64 * wg + 16 * ((tid >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = n0 + 8 * j + 2 * (lane & 3);
    if (8 * j >= bn || col >= prod.N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < prod.M)
        *reinterpret_cast<float2*>(out + (size_t)row * prod.N + col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
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

// ---- backward launch 4 (appearance rows only): g_app[n, j] = sum over k
//      of g_hvsum[n, k] * wva[j, k], one thread an output, k in order ----
__global__ void app_grad_kernel(const __nv_bfloat16* __restrict__ g_hvsum,
                                const float* __restrict__ wva, int n_rays, int hv,
                                float* __restrict__ g_app) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays * kAppDim) return;
  const __nv_bfloat16* g = g_hvsum + (size_t)(i / kAppDim) * hv;
  const float* w = wva + (size_t)(i % kAppDim) * hv;
  float s = 0.f;
  for (int k = 0; k < hv; ++k) s = fmaf(__bfloat162float(g[k]), __ldg(w + k), s);
  g_app[i] = s;
}

// ---- host side ----
struct Dims {
  int n_rays, hid, layer_num, S;
  long long rows;
  int hv, enc, ew, splits;
  long long mat_total;
  VecLayout vl;
  Dims(int n, int h, int L, int s, int F, int Fd, bool app)
      : n_rays(n), hid(h), layer_num(L), S(s), rows((long long)n * s),
        hv(h / 2), enc(enc_rows(F)), ew(extras_width(Fd, app)), vl(L, h) {
    splits = (int)(rows / 4096);
    splits = splits < 1 ? 1 : splits > kMaxSplits ? kMaxSplits : splits;
    // Worst case (every layer with encoding rows) bounds the matrix block.
    mat_total = (long long)L * (enc * h + h * h) + h * h + h * hv +
                (long long)ew * hv + hv * kGrgbWidth;
  }
};

size_t align256(size_t b) { return (b + 255) & ~(size_t)255; }

// Carves the stash (what the training forward keeps for the backward: the
// encoding, every activation, the f32 record and the extras rows) from base;
// returns its size.  With base == nullptr only sizes.
size_t carve_stash(const Dims& d, char* base, Stash* st) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += align256(bytes);
    return p;
  };
  const size_t R = (size_t)d.rows, H = d.hid, HV = d.hv;
  st->xb = (__nv_bfloat16*)take(R * d.enc * 2);
  for (int i = 0; i < d.layer_num; ++i) st->hs[i] = (__nv_bfloat16*)take(R * H * 2);
  st->feat = (__nv_bfloat16*)take(R * H * 2);
  st->hv = (__nv_bfloat16*)take(R * HV * 2);
  st->rec = (float*)take(R * kRecWidth * 4);
  st->extras = (__nv_bfloat16*)take((size_t)d.n_rays * d.ew * 2);
  return off;
}

// Carves the backward's gradient workspace (the gradient rows, the vector
// partials and the GEMM's matrix partials) from base; returns its size.
size_t carve_grad(const Dims& d, char* base, Stash* st, float** mat_part) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += align256(bytes);
    return p;
  };
  const size_t R = (size_t)d.rows, H = d.hid, HV = d.hv;
  for (int i = 0; i < d.layer_num; ++i) st->g_pre[i] = (__nv_bfloat16*)take(R * H * 2);
  st->g_feat = (__nv_bfloat16*)take(R * H * 2);
  st->g_hv = (__nv_bfloat16*)take(R * HV * 2);
  st->g_rgb = (__nv_bfloat16*)take(R * kGrgbWidth * 2);
  st->g_hvsum = (__nv_bfloat16*)take((size_t)d.n_rays * HV * 2);
  st->vec_part = (float*)take((size_t)(d.n_rays / kTileRays) * d.vl.P * 4);
  *mat_part = (float*)take((size_t)d.splits * d.mat_total * 4);
  return off;
}

// The instantiated widths (render_train_<HID>.cu, render_train_wide_<HID>.cu).
struct TrainWidth {
  int hid;
  decltype(&nm_train::train_fwd_64) fwd, fwd_wide;
  decltype(&nm_train::train_bwd_64) bwd;
};
#define NM_TRAIN_WIDTH_ROW(H) \
  {H, nm_train::train_fwd_##H, nm_train::train_fwd_wide_##H, nm_train::train_bwd_##H}
const TrainWidth kWidths[] = {NM_TRAIN_WIDTH_ROW(64), NM_TRAIN_WIDTH_ROW(128),
                              NM_TRAIN_WIDTH_ROW(192), NM_TRAIN_WIDTH_ROW(256)};
#undef NM_TRAIN_WIDTH_ROW

const TrainWidth* train_width(int hid) {
  for (const TrainWidth& w : kWidths)
    if (w.hid == hid) return &w;
  return nullptr;
}

// S: one 64-row half of a backward chunk, or whole 128-row chunks; the
// encoding and the extras rows within the kernels' widths.
bool bad_dims(int n_rays, int hid, int layer_num, int F, int Fd, int S, bool app) {
  return layer_num < 1 || layer_num > kMaxLayers || F < 1 || 6 * F > kEncMax ||
         Fd < 0 || 6 * Fd + 3 + (app ? kAppDim : 0) > kExtraMax ||
         n_rays % kTileRays != 0 || (S != kRows && S % kChunkRows != 0) ||
         S < kRows || S > kMaxSamples || train_width(hid) == nullptr;
}

void unpack(const void* const* ptrs, int layer_num, TrainParams* p) {
  int k = 0;
  for (int i = 0; i < kMaxLayers; ++i) {
    const bool live = i < layer_num;
    p->Wenc[i] = live ? (const __nv_bfloat16*)ptrs[k++] : nullptr;
    p->WhT[i] = live ? (const __nv_bfloat16*)ptrs[k++] : nullptr;
    p->b[i] = live ? (const float*)ptrs[k++] : nullptr;
  }
  p->Wfwd = (const __nv_bfloat16*)ptrs[k++];
  p->wa = (const float*)ptrs[k++];
  p->ba = (const float*)ptrs[k++];
  p->wfT = (const __nv_bfloat16*)ptrs[k++];
  p->bf = (const float*)ptrs[k++];
  p->wvhT = (const __nv_bfloat16*)ptrs[k++];
  p->wvd = (const float*)ptrs[k++];
  p->wva = (const float*)ptrs[k++];
  p->bv = (const float*)ptrs[k++];
  p->wr = (const float*)ptrs[k++];
  p->br = (const float*)ptrs[k++];
  p->rays = (const float*)ptrs[k++];
  p->z = (const float*)ptrs[k++];
  p->noise = (const float*)ptrs[k++];
  p->app = (const float*)ptrs[k++];
}

}  // namespace

// ptrs: host array of 3 * layer_num + 15 device pointers, in the order
// (Wenc_i, WhT_i, b_i) for each layer i, then Wfwd, wa, ba, wfT, bf, wvhT,
// wvd, wva, bv, wr, br, rays, z, noise, app; wva and app both null (no
// appearance table) or both given.  Wfwd: the forward's ring-slot images of
// every weight matrix, (in x out) rows, in the order the forward streams
// them (render_train_kernel.py: pack_train); Wenc_i: layer i's encoding
// rows there (null where the layer takes no encoding); WhT_i (null for
// layer 0), wfT, wvhT: the backward's slot images of the (out x in) rows.
// stash: null (no gradient to come), or the stash for the backward (as
// nm_render_train_workspace sizes it).  hid: 64, 128, 192 or 256;
// num_freqs <= 21; 6 * dirs_freqs + 3 (+ 16 with appearance rows) <= 128.
extern "C" int nm_render_train_forward(const void* const* ptrs, int n_rays,
                                       int hid, int layer_num, int num_freqs,
                                       int dirs_freqs, int samples,
                                       float var_scale, int white_bg,
                                       void* out_rgb, void* out_w, void* stash,
                                       void* stream) {
  TrainParams p;
  unpack(ptrs, layer_num, &p);
  const bool app = p.app != nullptr;
  if (bad_dims(n_rays, hid, layer_num, num_freqs, dirs_freqs, samples, app) ||
      app != (p.wva != nullptr))
    return (int)cudaErrorInvalidValue;
  Stash st{};
  if (stash != nullptr)
    carve_stash(Dims(n_rays, hid, layer_num, samples, num_freqs, dirs_freqs, app),
                (char*)stash, &st);
  const TrainWidth* width = train_width(hid);
  return (int)(6 * num_freqs > kEncStd ? width->fwd_wide : width->fwd)(
      p, st, stash != nullptr, n_rays, layer_num, num_freqs, dirs_freqs, samples,
      var_scale, white_bg, (float*)out_rgb, (float*)out_w, (cudaStream_t)stream);
}

template <int HID>
size_t train_smem(int layer_num, int ew, bool fwd) {
  return fwd ? FwdSmem<HID>::bytes(ew) : BwdSmem<HID>::bytes(VecLayout(layer_num, HID).P);
}

// Dynamic shared memory of the forward (fwd) or of the trunk backward at
// hid (64, 128, 192 or 256), with layer_num layers, dirs_freqs
// view-direction frequencies and app_dim (0 or kAppDim) appearance
// columns, in bytes; -1 for another width.
extern "C" int nm_render_train_smem(int hid, int layer_num, int dirs_freqs,
                                    int app_dim, int fwd) {
  const int ew = extras_width(dirs_freqs, app_dim != 0);
  switch (hid) {
    case 64: return (int)train_smem<64>(layer_num, ew, fwd);
    case 128: return (int)train_smem<128>(layer_num, ew, fwd);
    case 192: return (int)train_smem<192>(layer_num, ew, fwd);
    case 256: return (int)train_smem<256>(layer_num, ew, fwd);
    default: return -1;
  }
}

// Sizes (app_dim: 0, or kAppDim with appearance rows), written to host
// int64s: the stash the training forward fills
// (*out_stash bytes), the backward's gradient workspace (*out_grad bytes)
// and the matrix-gradient block (*out_mat floats).
extern "C" int nm_render_train_workspace(int n_rays, int hid, int layer_num,
                                         int samples, int num_freqs,
                                         int dirs_freqs, int app_dim,
                                         void* out_stash, void* out_grad,
                                         void* out_mat) {
  if (app_dim != 0 && app_dim != kAppDim) return (int)cudaErrorInvalidValue;
  const Dims d(n_rays, hid, layer_num, samples, num_freqs, dirs_freqs, app_dim != 0);
  Stash st{};
  float* mat_part;
  *(long long*)out_stash = (long long)carve_stash(d, nullptr, &st);
  *(long long*)out_grad = (long long)carve_grad(d, nullptr, &st, &mat_part);
  *(long long*)out_mat = d.mat_total;
  return 0;
}

// g_rgb (N, 3), g_w (N, S) f32 cotangents; stash: what
// nm_render_train_forward filled for these inputs; workspace: the gradient
// workspace.  grad_mat: the matrix-weight
// gradients, f32 sums in (in x out) layout, one block per product in this
// order: per layer i, [encoding rows (enc_rows(F) x hid) if the layer has them]
// [hidden rows (hid x hid) if i > 0]; then wf (hid x hid), wvh (hid x hv),
// the extras rows (extras_width x hv: wvd's, zeros to dirs_rows(Fd), wva's), wr
// (hv x 8).  grad_vec: P floats, the VecLayout.  grad_app: (N, kAppDim)
// f32, given with appearance rows (and only then).
extern "C" int nm_render_train_backward(const void* const* ptrs, int n_rays,
                                        int hid, int layer_num, int num_freqs,
                                        int dirs_freqs, int samples,
                                        float var_scale, int white_bg,
                                        const void* g_rgb, const void* g_w,
                                        const void* stash, void* workspace,
                                        void* grad_mat, void* grad_vec,
                                        void* grad_app, void* stream) {
  TrainParams p;
  unpack(ptrs, layer_num, &p);
  const bool app = p.app != nullptr;
  if (bad_dims(n_rays, hid, layer_num, num_freqs, dirs_freqs, samples, app) ||
      stash == nullptr || app != (p.wva != nullptr) || app != (grad_app != nullptr))
    return (int)cudaErrorInvalidValue;
  const Dims d(n_rays, hid, layer_num, samples, num_freqs, dirs_freqs, app);
  Stash st{};
  float* mat_part;
  carve_stash(d, (char*)stash, &st);
  carve_grad(d, (char*)workspace, &st, &mat_part);
  cudaStream_t s = (cudaStream_t)stream;
  int parts = 0;
  cudaError_t e = train_width(hid)->bwd(p, st, n_rays, layer_num, samples, white_bg,
                                        (const float*)g_rgb, (const float*)g_w,
                                        &parts, s);
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
    q.bn = N >= 256 ? 256 : N > 64 ? 128 : 64;
    q.ntn = (N + q.bn - 1) / q.bn;
    tiles += ((M + 127) / 128) * q.ntn;
    off += (long long)M * N;
  };
  const int R = (int)d.rows, H = hid, HV = d.hv;
  for (int i = 0; i < layer_num; ++i) {
    if (p.Wenc[i] != nullptr) add(st.xb, d.enc, st.g_pre[i], H, R);
    if (i > 0) add(st.hs[i - 1], H, st.g_pre[i], H, R);
  }
  add(st.hs[layer_num - 1], H, st.g_feat, H, R);
  add(st.feat, H, st.g_hv, HV, R);
  add(st.extras, d.ew, st.g_hvsum, HV, n_rays);
  add(st.hv, HV, st.g_rgb, kGrgbWidth, R);
  e = cudaFuncSetAttribute(wgrad_gemm_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kGemmSmem);
  if (e != cudaSuccess) return (int)e;
  wgrad_gemm_kernel<<<dim3(tiles, d.splits), kGemmThreads, kGemmSmem, s>>>(
      t, d.mat_total, mat_part);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  reduce_parts_kernel<<<(unsigned)((off + 255) / 256), 256, 0, s>>>(
      mat_part, d.splits, d.mat_total, (float*)grad_mat);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  reduce_parts_kernel<<<(d.vl.P + 255) / 256, 256, 0, s>>>(
      st.vec_part, parts, d.vl.P, (float*)grad_vec);
  if ((e = cudaGetLastError()) != cudaSuccess || !app) return (int)e;
  app_grad_kernel<<<(n_rays * kAppDim + 255) / 256, 256, 0, s>>>(
      st.g_hvsum, p.wva, n_rays, HV, (float*)grad_app);
  return (int)cudaGetLastError();
}
