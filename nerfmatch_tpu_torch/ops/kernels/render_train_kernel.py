"""Fused mip-NeRF TRAIN render stage: CUDA kernels, their plain version, and
the autograd binding.

Replaces ``nerfmatch_tpu/ops/pallas/render_train.py:
make_fused_train_render`` (``_fwd_impl`` and the hand-written ``_bwd_impl``).
One stage: frustum moments of the (jittered) z fenceposts -> IPE -> NeRF MLP
-> density noise before the ReLU -> heads -> alpha compositing, returning
``rgb`` (N, 3) and the per-sample ``weights`` (N, S).  The backward returns
gradients for every MLP parameter in the parameter's own layout; rays, z
and noise get none (as in JAX).

Precision follows the JAX kernel: every matrix product takes bf16 operands
with f32 accumulation (the views layer's dirs rows and the rgb head
included), residual activations are bf16, the backward's matrix operands
are bf16, and the matrix-weight gradients are rounded to bf16; biases, the
sigma head and compositing stay f32.

:func:`render_train` launches ``csrc/render_train.cu`` for CUDA tensors and
raises on anything the kernels do not implement; for CPU tensors it runs
:func:`render_train_plain`, whose backward is explicit (it mirrors the JAX
``bwd_kernel``) and chunked over rays.  :func:`train_stage_forward` with
``bf16=False`` is the f32 reference whose autograd the tests use as the
looser semantic check.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from . import LAUNCHES, check, library, require_cuda_tensors, stream_ptr
from ...nerf.embedding import ipe_embedding, pe_embedding
from ...nerf.model import NerfMLP
from ...nerf.sampling import frustum_moments
from .render_kernel import pack_fragments

TILE_RAYS = 2
SAMPLE_CHUNK = 64
KERNEL_HIDS = (64, 256)
ENC_MAX = 96          # csrc: kEncMax (padded encoding width)
DIRS_MAX = 32         # csrc: kDirsMax
GRGB_WIDTH = 8        # csrc: kGrgbWidth


@dataclasses.dataclass(frozen=True, eq=False)
class StageSpec:
    """What one train stage renders with (``FusedRenderSpec`` in JAX)."""
    mlp: NerfMLP
    num_freqs: int
    dirs_freqs: int
    var_scale: float = 1.0
    white_bg: bool = False


def _bf16(x, on: bool = True):
    return x.to(torch.bfloat16).float() if on else x


def _skip_in(cfg, i: int) -> bool:
    """Layer i takes the encoding rows (layer 0, or the skip concat)."""
    return i == 0 or (i - 1) in cfg.skips


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def train_stage_forward(spec: StageSpec, rays, z, noise, bf16: bool = True,
                        keep: bool = False):
    """Plain train stage -> (rgb, weights[, intermediates]).  Differentiable
    when called with grad enabled (``bf16=False`` is the f32 reference)."""
    mlp, cfg = spec.mlp, spec.mlp.cfg
    rnd = functools.partial(_bf16, on=bf16)
    o, d = rays[:, 0:3], rays[:, 8:11]
    t0, t1 = z[:, :-1], z[:, 1:]
    t_mean, t_var, r_var = frustum_moments(t0, t1, rays[:, 11:12])
    t_var, r_var = spec.var_scale * t_var, spec.var_scale * r_var
    d2 = (d * d)[:, None, :]
    mean = o[:, None, :] + d[:, None, :] * t_mean[..., None]
    var = t_var[..., None] * d2 + r_var[..., None] * (1.0 - d2)
    xb = rnd(ipe_embedding(mean, var, spec.num_freqs)[0])
    hs, h = [], None
    for i, lin in enumerate(mlp.pts_linears):
        if i == 0:
            inp = xb
        elif (i - 1) in cfg.skips:
            inp = torch.cat([xb, h], dim=-1)
        else:
            inp = h
        h = torch.relu(F.linear(rnd(inp), rnd(lin.weight), lin.bias))
        hs.append(rnd(h))
    sigma_raw = F.linear(h, mlp.alpha_linear.weight,
                         mlp.alpha_linear.bias)[..., 0] + noise
    feature = rnd(F.linear(rnd(h), rnd(mlp.feature_linear.weight),
                           mlp.feature_linear.bias))
    views = mlp.views_linears[0]
    w_h, w_d = views.weight[:, :cfg.hid_dim], views.weight[:, cfg.hid_dim:]
    dirs = rnd(pe_embedding(d, spec.dirs_freqs))
    xt = F.linear(dirs, rnd(w_d))
    hv = rnd(torch.relu(F.linear(feature, rnd(w_h)) + xt[:, None, :]
                        + views.bias))
    rgb_s = torch.sigmoid(F.linear(hv, rnd(mlp.rgb_linear.weight),
                                   mlp.rgb_linear.bias))
    dists = t1 - t0
    alpha = 1.0 - torch.exp(-torch.relu(sigma_raw) * dists)
    log_t = torch.log(1.0 - alpha + 1e-10)
    csum = torch.cumsum(log_t, dim=-1) - log_t
    weights = alpha * torch.exp(csum)
    rgb = (weights[..., None] * rgb_s).sum(1)
    if spec.white_bg:
        rgb = rgb + (1.0 - weights.sum(-1, keepdim=True))
    if not keep:
        return rgb, weights
    return rgb, weights, dict(xb=xb, hs=hs, sigma_raw=sigma_raw,
                              feature=feature, dirs=dirs, hv=hv, rgb_s=rgb_s,
                              dists=dists, alpha=alpha, csum=csum)


@torch.no_grad()
def train_stage_backward(spec: StageSpec, rays, z, noise, g_rgb, g_w,
                         chunk_rays: int = 1024):
    """Explicit backward of the bf16 plain stage (the JAX ``bwd_kernel``,
    with its bf16 operand roundings), recomputing the forward per chunk of
    rays -> {parameter name: gradient}."""
    mlp, cfg = spec.mlp, spec.mlp.cfg
    b = _bf16
    enc, hid = cfg.xyz_dim, cfg.hid_dim
    L = cfg.layer_num
    params = dict(mlp.named_parameters())
    acc = {k: torch.zeros_like(v) for k, v in params.items()}
    wf = b(mlp.feature_linear.weight)
    views_w = mlp.views_linears[0].weight
    wvh = b(views_w[:, :hid])
    wrgb = b(mlp.rgb_linear.weight)
    wa = mlp.alpha_linear.weight[0]
    w_hid = [None] + [b(lin.weight[:, enc:] if (i - 1) in cfg.skips
                        else lin.weight)
                      for i, lin in enumerate(mlp.pts_linears) if i > 0]
    outer = lambda g, a: torch.einsum("nso,nsi->oi", b(g), b(a))
    for lo in range(0, rays.shape[0], chunk_rays):
        sl = slice(lo, lo + chunk_rays)
        _, weights, f = train_stage_forward(spec, rays[sl], z[sl], noise[sl],
                                            keep=True)
        gr = g_rgb[sl]
        # composite backward
        g_wt = g_w[sl] + (gr[:, None, :] * f["rgb_s"]).sum(-1)
        if spec.white_bg:
            g_wt = g_wt - gr.sum(-1, keepdim=True)
        g_csum = g_wt * weights
        g_logt = torch.flip(torch.cumsum(torch.flip(g_csum, [-1]), -1),
                            [-1]) - g_csum
        alpha = f["alpha"]
        g_alpha = g_wt * torch.exp(f["csum"]) - g_logt / (1.0 - alpha + 1e-10)
        g_sigma = g_alpha * (1.0 - alpha) * f["dists"]
        gsr = torch.where(f["sigma_raw"] > 0, g_sigma, torch.zeros_like(g_sigma))
        # rgb head
        rgb_s = f["rgb_s"]
        g_rgbt = gr[:, None, :] * weights[..., None] * rgb_s * (1.0 - rgb_s)
        acc["rgb_linear.weight"] += outer(g_rgbt, f["hv"])
        acc["rgb_linear.bias"] += g_rgbt.sum((0, 1))
        g_hv = b(g_rgbt) @ wrgb
        g_hv = torch.where(f["hv"] > 0, g_hv, torch.zeros_like(g_hv))
        acc["views_linears.0.bias"] += g_hv.sum((0, 1))
        acc["views_linears.0.weight"][:, hid:] += b(g_hv.sum(1)).T @ f["dirs"]
        acc["views_linears.0.weight"][:, :hid] += outer(g_hv, f["feature"])
        g_feature = b(g_hv) @ wvh
        # feature / sigma heads into the trunk
        hl = f["hs"][L - 1]
        acc["feature_linear.weight"] += outer(g_feature, hl)
        acc["feature_linear.bias"] += g_feature.sum((0, 1))
        g_h = b(g_feature) @ wf + gsr[..., None] * wa
        acc["alpha_linear.weight"][0] += (hl * gsr[..., None]).sum((0, 1))
        acc["alpha_linear.bias"] += gsr.sum()
        # trunk
        for i in range(L - 1, -1, -1):
            g_pre = torch.where(f["hs"][i] > 0, g_h, torch.zeros_like(g_h))
            acc[f"pts_linears.{i}.bias"] += g_pre.sum((0, 1))
            wgrad = acc[f"pts_linears.{i}.weight"]
            if i == 0:
                wgrad += outer(g_pre, f["xb"])
                break
            if (i - 1) in cfg.skips:
                wgrad[:, :enc] += outer(g_pre, f["xb"])
                wgrad[:, enc:] += outer(g_pre, f["hs"][i - 1])
            else:
                wgrad += outer(g_pre, f["hs"][i - 1])
            g_h = b(g_pre) @ w_hid[i]
    for k, v in acc.items():
        if k.endswith("weight") and not k.startswith("alpha_linear"):
            acc[k] = b(v)
    return acc


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def pack_train(mlp: NerfMLP):
    """Kernel weight list in the C entry's order: per layer (encoding-row
    fragments, hidden-row fragments, transposed hidden-row fragments, bias;
    None where absent), then wa, ba, wf, wf^T, bf, wvh, wvh^T, wvd, bv, wr,
    br.  wvd and wr are f32 arrays of bf16-rounded values."""
    cfg = mlp.cfg
    enc, hid = cfg.xyz_dim, cfg.hid_dim
    t = lambda w: w.detach().t().contiguous()
    out = []
    for i, lin in enumerate(mlp.pts_linears):
        w = lin.weight.detach()
        w_enc = w[:, :enc] if _skip_in(cfg, i) else None
        w_hid = None if i == 0 else (w[:, enc:] if (i - 1) in cfg.skips else w)
        out += [None if w_enc is None else pack_fragments(t(w_enc)),
                None if w_hid is None else pack_fragments(t(w_hid)),
                None if w_hid is None else pack_fragments(w_hid.contiguous()),
                lin.bias.detach().contiguous()]
    wv = mlp.views_linears[0].weight.detach()
    wf = mlp.feature_linear.weight.detach()
    out += [mlp.alpha_linear.weight.detach().reshape(-1).contiguous(),
            mlp.alpha_linear.bias.detach().contiguous(),
            pack_fragments(t(wf)), pack_fragments(wf.contiguous()),
            mlp.feature_linear.bias.detach().contiguous(),
            pack_fragments(t(wv[:, :hid])),
            pack_fragments(wv[:, :hid].contiguous()),
            _bf16(t(wv[:, hid:])).contiguous(),
            mlp.views_linears[0].bias.detach().contiguous(),
            _bf16(t(mlp.rgb_linear.weight)).contiguous(),
            mlp.rgb_linear.bias.detach().contiguous()]
    return out


def check_train_config(spec: StageSpec):
    """Raise for configs the train kernels do not implement."""
    cfg = spec.mlp.cfg
    if cfg.app_dim:
        raise NotImplementedError(
            "appearance embeddings (extras_grad) are not in the CUDA train "
            "kernel (ROADMAP: Cambridge appearance path)")
    if not cfg.use_viewdirs or cfg.xyz_dim != 6 * spec.num_freqs \
            or cfg.dirs_dim != 6 * spec.dirs_freqs + 3 \
            or cfg.xyz_dim > ENC_MAX or cfg.dirs_dim > DIRS_MAX:
        raise NotImplementedError(f"train kernel: config {cfg} not supported")
    if cfg.hid_dim not in KERNEL_HIDS:
        raise NotImplementedError(
            f"train kernel instantiates hid in {KERNEL_HIDS}, not "
            f"{cfg.hid_dim} (ROADMAP: train kernel widths)")


def _ptrs(packed, *tensors):
    vals = [None if p is None else p.data_ptr() for p in packed]
    vals += [t.data_ptr() for t in tensors]
    return (ctypes.c_void_p * len(vals))(*vals)


def _kernel_args(spec: StageSpec, rays, z, noise, packed):
    check_train_config(spec)
    require_cuda_tensors("render_train", rays, z, noise,
                         *[p for p in packed if p is not None])
    n, S = z.shape[0], z.shape[1] - 1
    if any(t.dtype != torch.float32 for t in (rays, z, noise)) \
            or rays.shape != (n, 12) or noise.shape != (n, S):
        raise ValueError("render_train: rays (N, 12), z (N, S+1), noise "
                         "(N, S), all f32")
    if n % TILE_RAYS or S % SAMPLE_CHUNK or S > 256:
        raise NotImplementedError(
            f"train kernel needs N % {TILE_RAYS} == 0 and S a multiple of "
            f"{SAMPLE_CHUNK} up to 256 (N={n}, S={S})")
    cfg = spec.mlp.cfg
    return (_ptrs(packed, rays, z, noise), n, cfg.hid_dim, cfg.layer_num,
            spec.num_freqs, spec.dirs_freqs, S, spec.var_scale,
            int(spec.white_bg))


def kernel_forward(spec: StageSpec, rays, z, noise, packed):
    args = _kernel_args(spec, rays, z, noise, packed)
    n, S = z.shape[0], z.shape[1] - 1
    rgb = torch.empty(n, 3, device=rays.device)
    w = torch.empty(n, S, device=rays.device)
    err = library().nm_render_train_forward(
        *args, rgb.data_ptr(), w.data_ptr(), stream_ptr(rays.device))
    check(err, "render_train_fwd")
    LAUNCHES["render_train_fwd"] += 1
    return rgb, w


def kernel_backward(spec: StageSpec, rays, z, noise, g_rgb, g_w, packed):
    """Kernel gradients -> {parameter name: gradient}."""
    args = _kernel_args(spec, rays, z, noise, packed)
    mlp, cfg = spec.mlp, spec.mlp.cfg
    n, S = z.shape[0], z.shape[1] - 1
    L, hid, enc = cfg.layer_num, cfg.hid_dim, cfg.xyz_dim
    hv, dirs = hid // 2, cfg.dirs_dim
    g_rgb, g_w = g_rgb.contiguous(), g_w.contiguous()
    require_cuda_tensors("render_train", rays, g_rgb, g_w)
    nbytes, nmat = ctypes.c_longlong(0), ctypes.c_longlong(0)
    check(library().nm_render_train_workspace(
        n, hid, L, S, ctypes.addressof(nbytes), ctypes.addressof(nmat)),
        "render_train_workspace")
    dev = rays.device
    work = torch.empty(nbytes.value, dtype=torch.uint8, device=dev)
    mat = torch.empty(nmat.value, device=dev)
    P = L * hid + hid + hv + 4 + hid + 4          # csrc: VecLayout
    vec = torch.empty(P, device=dev)
    err = library().nm_render_train_backward(
        *args, g_rgb.data_ptr(), g_w.data_ptr(), work.data_ptr(),
        mat.data_ptr(), vec.data_ptr(), stream_ptr(dev))
    check(err, "render_train_bwd")
    LAUNCHES["render_train_bwd"] += 1
    del work
    # Split the (in x out) matrix blocks in the C product order.
    off = 0

    def block(rows, cols):
        nonlocal off
        v = mat[off:off + rows * cols].view(rows, cols)
        off += rows * cols
        return v

    g = {}
    for i in range(L):
        parts = []
        if _skip_in(cfg, i):
            parts.append(block(ENC_MAX, hid)[:enc])
        if i > 0:
            parts.append(block(hid, hid))
        g[f"pts_linears.{i}.weight"] = torch.cat(parts).t()
        g[f"pts_linears.{i}.bias"] = vec[i * hid:(i + 1) * hid]
    g["feature_linear.weight"] = block(hid, hid).t()
    w_h = block(hid, hv)
    w_d = block(DIRS_MAX, hv)[:dirs]
    g["views_linears.0.weight"] = torch.cat([w_h, w_d]).t()
    g["rgb_linear.weight"] = block(hv, GRGB_WIDTH)[:, :3].t()
    o = L * hid
    g["feature_linear.bias"] = vec[o:o + hid]
    g["views_linears.0.bias"] = vec[o + hid:o + hid + hv]
    g["rgb_linear.bias"] = vec[o + hid + hv:o + hid + hv + 3]
    o += hid + hv + 4
    g["alpha_linear.weight"] = vec[o:o + hid][None]
    g["alpha_linear.bias"] = vec[o + hid:o + hid + 1]
    for k, v in g.items():
        if k.endswith("weight") and not k.startswith("alpha_linear"):
            v = _bf16(v)
        g[k] = v.contiguous()
    return g


# ---------------------------------------------------------------------------
# Autograd binding and entry points
# ---------------------------------------------------------------------------

class _RenderTrainFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, use_kernel, rays, z, noise, *params):
        packed = pack_train(spec.mlp) if use_kernel else None
        if use_kernel:
            rgb, w = kernel_forward(spec, rays, z, noise, packed)
        else:
            with torch.no_grad():
                rgb, w = train_stage_forward(spec, rays, z, noise)
        ctx.spec, ctx.use_kernel, ctx.packed = spec, use_kernel, packed
        ctx.save_for_backward(rays, z, noise)
        return rgb, w

    @staticmethod
    def backward(ctx, g_rgb, g_w):
        rays, z, noise = ctx.saved_tensors
        spec = ctx.spec
        g_rgb = torch.zeros(rays.shape[0], 3, device=rays.device) \
            if g_rgb is None else g_rgb
        g_w = torch.zeros_like(noise) if g_w is None else g_w
        if ctx.use_kernel:
            g = kernel_backward(spec, rays, z, noise, g_rgb, g_w, ctx.packed)
        else:
            g = train_stage_backward(spec, rays, z, noise, g_rgb, g_w)
        names = [k for k, _ in spec.mlp.named_parameters()]
        return (None, None, None, None, None, *[g[k] for k in names])


def _apply(spec, use_kernel, rays, z, noise):
    return _RenderTrainFn.apply(spec, use_kernel, rays, z, noise,
                                *spec.mlp.parameters())


def render_train_plain(spec: StageSpec, rays, z, noise):
    """Plain train stage (bf16 operand roundings) with the explicit
    backward -> (rgb (N, 3), weights (N, S))."""
    return _apply(spec, False, rays, z, noise)


def render_train(spec: StageSpec, rays, z, noise):
    """Train stage: the CUDA kernels for CUDA tensors (or an error), the
    plain version for CPU tensors -> (rgb (N, 3), weights (N, S))."""
    if rays.device.type != "cuda":
        return render_train_plain(spec, rays, z, noise)
    check_train_config(spec)
    return _apply(spec, True, rays.contiguous(), z.contiguous(),
                  noise.contiguous())
