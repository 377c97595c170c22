// The C entries of the fused render stage (kernels 1 and 1b: the kernel is
// render_eval.cuh): they check the arguments, unpack the pointers and call
// the trunk's instantiation at the MLP's width and the encoding's
// (render_eval_<trunk>_<HID>.cu, render_eval_wide_<HID>.cu, each built in
// an nvcc process of its own).

#include "render_eval.cuh"

namespace {

// The instantiated widths and their trunks' launches (the production
// encoding's and the wide one's) and shared-memory sizes.
using Launch = cudaError_t (*)(const EvalParams&, const QuantParams&, const EvalArgs&);
struct EvalWidth {
  int hid;
  Launch bf16, q8, bf16_wide, q8_wide;
  size_t (*smem_bf16)(bool fine, int dirs_dim);
  size_t (*smem_q8)(bool fine, int dirs_dim);
};

#define NM_EVAL_WIDTH_ROW(H)                                                  \
  {H, nm_eval::launch_bf16_##H, nm_eval::launch_q8_##H,                       \
   nm_eval::launch_wide_bf16_##H, nm_eval::launch_wide_q8_##H,                \
   nm_eval::smem_bf16_##H, nm_eval::smem_q8_##H}
const EvalWidth kWidths[] = {NM_EVAL_WIDTH_ROW(64), NM_EVAL_WIDTH_ROW(128),
                             NM_EVAL_WIDTH_ROW(192), NM_EVAL_WIDTH_ROW(256),
                             NM_EVAL_WIDTH_ROW(512), NM_EVAL_WIDTH_ROW(1024)};
#undef NM_EVAL_WIDTH_ROW

const EvalWidth* eval_width(int hid) {
  for (const EvalWidth& w : kWidths)
    if (w.hid == hid) return &w;
  return nullptr;
}

}  // namespace

// ptrs: host array of 2 * layer_num + 11 device pointers: W (the slot
// images the ring streams: render_kernel.py: pack_mlp), then (Wenc_i, b_i)
// for each layer i (Wenc_i: non-null where the layer takes the encoding
// rows), then wa, ba, bf, wvd, wva, bv, wr, br, rays, z (wva null without
// an appearance table).  app: null, or (n_rays, 16) f32 appearance rows
// (the fine stage of an appearance NeRF; needs wva).  qptrs: null (a bf16
// trunk), or the int8 trunk of layers int8_from .. L - 1 as 3 * layer_num
// + 3 device pointers: per layer scale, scale_s, bias (null below
// int8_from; scale_s null without encoding rows), then qenc, qh (int8_from
// > 0), iq (fine stage, tap layer quantized and not last).  counter: one
// int32, zero at launch (the tile counter).  scratch: the tile engine's
// scratch (hid 512: the fine stage's tap values; 1024: also the descriptor
// partials and a parked pass, both stages), scratch_bytes of it
// (nm_render_eval_scratch), else null.  dbg: null, or (2, n_rays,
// samples, hid) f32 receiving the tap layer's activations of the first pass
// and of the second (fine stage only).  dbgq: null, or (n_rays, samples,
// 128 + hid) int8 receiving the quantized encoding and the last layer's int8
// input (int8 trunk only); either only up to num_freqs 16.  feat_max (fine
// stage only): composite the descriptor and the point of each ray's largest
// weight (feat_comb='max').  hid: 64, 128, 192, 256, 512 or 1024;
// num_freqs <= 21;
// 6 * dirs_freqs + 3 (+ 16 with an appearance table) <= 128.
extern "C" int nm_render_eval_forward(const void* const* ptrs,
                                      const void* const* qptrs,
                                      const void* app, int n_rays,
                                      int hid, int layer_num, int feat_layer,
                                      int int8_from, int num_freqs,
                                      int dirs_freqs, int samples,
                                      float var_scale, float log_eps,
                                      int white_bg, int fine, int feat_max,
                                      void* counter, void* scratch,
                                      int scratch_bytes,
                                      void* out_w, void* out_depth,
                                      void* out_acc, void* out_rgb,
                                      void* out_feat, void* out_pts, void* dbg,
                                      void* dbgq, void* stream) {
  const bool q8 = qptrs != nullptr;
  const EvalWidth* width = eval_width(hid);
  if (layer_num < 1 || layer_num > kMaxLayers || num_freqs < 1 ||
      6 * num_freqs > kEncMax || dirs_freqs < 0 || n_rays % kTileRays != 0 ||
      n_rays <= 0 || samples % kSampleBlock != 0 || samples <= 0 ||
      (fine && (feat_layer < 0 || feat_layer >= layer_num)) ||
      (dbg != nullptr && !fine) || (dbgq != nullptr && !q8) ||
      (q8 && (int8_from < 0 || int8_from >= layer_num)) || width == nullptr ||
      (feat_max && !fine))
    return (int)cudaErrorInvalidValue;
  EvalParams p;
  int k = 0;
  p.W = (const unsigned char*)ptrs[k++];
  for (int i = 0; i < kMaxLayers; ++i) {
    const bool here = i < layer_num;
    p.Wenc[i] = here ? ptrs[k++] : nullptr;
    p.b[i] = here ? (const float*)ptrs[k++] : nullptr;
  }
  if (p.Wenc[0] == nullptr) return (int)cudaErrorInvalidValue;
  p.wa = (const float*)ptrs[k++];
  p.ba = (const float*)ptrs[k++];
  p.bf = (const float*)ptrs[k++];
  p.wvd = (const float*)ptrs[k++];
  p.wva = (const float*)ptrs[k++];
  p.app = fine ? (const float*)app : nullptr;
  if ((p.app != nullptr && p.wva == nullptr) ||
      6 * dirs_freqs + 3 + (p.wva != nullptr ? kAppDim : 0) > kExtraMax)
    return (int)cudaErrorInvalidValue;
  p.bv = (const float*)ptrs[k++];
  p.wr = (const float*)ptrs[k++];
  p.br = (const float*)ptrs[k++];
  p.rays = (const float*)ptrs[k++];
  p.z = (const float*)ptrs[k++];
  QuantParams qp = {};
  const int tap = fine ? feat_layer : 0;
  if (q8) {
    k = 0;
    for (int i = 0; i < layer_num; ++i) {
      qp.scale[i] = (const float*)qptrs[k++];
      qp.scale_s[i] = (const float*)qptrs[k++];
      qp.bias[i] = (const float*)qptrs[k++];
      if (i >= int8_from &&
          (qp.scale[i] == nullptr || qp.bias[i] == nullptr ||
           (qp.scale_s[i] != nullptr) != (i > 0 && p.Wenc[i] != nullptr)))
        return (int)cudaErrorInvalidValue;
    }
    qp.qenc = (const float*)qptrs[k++];
    qp.qh = (const float*)qptrs[k++];
    qp.iq = (const float*)qptrs[k++];
    if (qp.qenc == nullptr || (int8_from > 0 && qp.qh == nullptr) ||
        (fine && tap >= int8_from && tap < layer_num - 1 && qp.iq == nullptr))
      return (int)cudaErrorInvalidValue;
  } else {
    int8_from = layer_num;
  }
  EvalArgs a;
  a.n_rays = n_rays;
  a.layer_num = layer_num;
  a.feat_layer = tap;
  a.int8_from = int8_from;
  a.F = num_freqs;
  a.Fd = dirs_freqs;
  a.S = samples;
  a.var_scale = var_scale;
  a.log_eps = log_eps;
  a.white_bg = white_bg;
  a.fine = fine;
  a.feat_max = feat_max != 0;
  a.dbg = dbg != nullptr || dbgq != nullptr;
  a.counter = (int*)counter;
  a.scratch = (float*)scratch;
  a.scratch_floats = scratch_bytes > 0 ? (size_t)scratch_bytes / sizeof(float) : 0;
  a.w = (float*)out_w;
  a.depth = (float*)out_depth;
  a.acc = (float*)out_acc;
  a.rgb = (float*)out_rgb;
  a.feat = (float*)out_feat;
  a.pts = (float*)out_pts;
  a.dbg_out = (float*)dbg;
  a.dbgq = (int8_t*)dbgq;
  a.stream = (cudaStream_t)stream;
  const bool wide = 6 * num_freqs > kEncStd;
  return (int)(q8 ? (wide ? width->q8_wide : width->q8)
                  : (wide ? width->bf16_wide : width->bf16))(p, qp, a);
}

// Bytes of the scratch the stage at hid takes for n_rays on the current
// device (one block's an SM it runs on, nm_eval::tile_scratch_bytes): 0
// below hid 512 and for the coarse stage at 512; -1 on an error.
extern "C" int nm_render_eval_scratch(int hid, int fine, int n_rays) {
  const size_t per_block = nm_eval::tile_scratch_bytes(hid, fine != 0);
  if (per_block == 0) return 0;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  const int n_tiles = n_rays / kTileRays;
  return (int)((n_tiles < sms ? n_tiles : sms) * per_block);
}

// Dynamic shared memory of the kernel at hid (64-256, 512 or 1024), the
// coarse or the fine stage, the bf16 or the int8 trunk, with dirs_freqs
// view-direction frequencies, in bytes; -1 for another width.
extern "C" int nm_render_eval_smem(int hid, int fine, int int8, int dirs_freqs) {
  const EvalWidth* width = eval_width(hid);
  if (width == nullptr) return -1;
  return (int)(int8 ? width->smem_q8 : width->smem_bf16)(fine, 6 * dirs_freqs + 3);
}
