"""Fused mip-NeRF render stage: CUDA kernel wrapper and its plain version.

Replaces ``nerfmatch_tpu/ops/pallas/render_kernel.py: make_fused_render``.
One stage = frustum moments -> IPE -> NeRF MLP -> heads -> alpha
compositing over packed rays (N, 12) in the unit-direction
parameterization and z fenceposts (N, S+1).  ``fine=False`` is the coarse
variant (weights, depth, acc); ``fine=True`` adds rgb, the composited
descriptor (the MLP's tap layer) and the composited point
``o * acc + d * sum(w * t_mean)``.

Precision follows the JAX kernel: the MLP's matrix products take bf16
operands with f32 accumulation; everything else is f32.  The plain version
rounds the same operands (``trunk_bf16=True``, the default) or, as the
tests' f32 reference, runs the MLP in f32 (the XLA path's precision).

Early termination (``early_term_eps > 0``): rays are grouped in tiles of
:data:`TILE_RAYS`; once every ray of a tile has transmittance < eps after a
block of :data:`SAMPLE_BLOCK` samples, the remaining blocks get exact zero
weights.  Skipped weights are < eps, so outputs move by < eps.

CUDA tensors launch ``csrc/render.cu`` (and raise on anything it does not
implement); CPU tensors run :func:`render_stage_plain`.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import LAUNCHES, check, library, require_cuda_tensors, stream_ptr
from ...nerf.embedding import ipe_embedding, pe_embedding
from ...nerf.model import NerfMLP, eval_feat_layer
from ...nerf.sampling import frustum_moments, lift_gaussian
from .quant import ENC_PAD

TILE_RAYS = 2
SAMPLE_BLOCK = 32
KERNEL_HIDS = (64, 256)


def pack_fragments(w):
    """(K, N) f32 ``in x out`` weight -> bf16 mma.m16n8k16 B fragments.

    K is zero-padded to a multiple of 16.  Returns an int32 tensor of shape
    (K/16, N/8, 32, 2): entry [ks, nt, lane, r] holds the bf16 pair
    ``w[k, n], w[k + 1, n]`` (low half first) with
    ``k = 16 ks + 8 r + 2 (lane % 4)`` and ``n = 8 nt + lane // 4``.
    """
    K, N = w.shape
    w = F.pad(w, (0, 0, 0, (-K) % 16)).to(torch.bfloat16)
    # k = 16 ks + 8 r + 2 lq + h,  n = 8 nt + ln,  lane = 4 ln + lq
    w = w.reshape(-1, 2, 4, 2, N // 8, 8)           # ks, r, lq, h, nt, ln
    w = w.permute(0, 4, 5, 2, 1, 3).contiguous()    # ks, nt, ln, lq, r, h
    return w.view(torch.int32).reshape(-1, N // 8, 32, 2)


def pack_mlp(mlp: NerfMLP):
    """Kernel weight list, in the order the C entry expects: per layer
    (encoding-row fragments or None, hidden-row fragments or None, bias),
    then wa, ba, wf, bf, wvh, wvd, bv, wr, br."""
    cfg = mlp.cfg
    t = lambda w: w.detach().t().contiguous()
    out = []
    for i, lin in enumerate(mlp.pts_linears):
        w = t(lin.weight)
        if i == 0:
            parts = (w, None)
        elif i - 1 in cfg.skips:
            parts = (w[:cfg.xyz_dim], w[cfg.xyz_dim:])
        else:
            parts = (None, w)
        out += [None if p is None else pack_fragments(p) for p in parts]
        out.append(lin.bias.detach().contiguous())
    wv = t(mlp.views_linears[0].weight)
    out += [mlp.alpha_linear.weight.detach().reshape(-1).contiguous(),
            mlp.alpha_linear.bias.detach().contiguous(),
            pack_fragments(t(mlp.feature_linear.weight)),
            mlp.feature_linear.bias.detach().contiguous(),
            pack_fragments(wv[:cfg.hid_dim]), wv[cfg.hid_dim:].contiguous(),
            mlp.views_linears[0].bias.detach().contiguous(),
            t(mlp.rgb_linear.weight),
            mlp.rgb_linear.bias.detach().contiguous()]
    return out


def _check_config(mlp: NerfMLP, num_freqs: int, dirs_freqs: int):
    cfg = mlp.cfg
    if not cfg.use_viewdirs:
        raise NotImplementedError("fused render needs use_viewdirs")
    if cfg.app_dim:
        raise NotImplementedError(
            "appearance embeddings are not in the CUDA render kernel "
            "(ROADMAP: Cambridge appearance path)")
    if cfg.xyz_dim != 6 * num_freqs or cfg.dirs_dim != 6 * dirs_freqs + 3:
        raise NotImplementedError(f"fused render config {cfg} not supported")


def int8_pointers(mlp: NerfMLP, int8):
    """The int8 trunk's device pointers in the order of ``nm_render_forward``'s
    ``qptrs``: per layer (weight fragments, encoding-row fragments, scale
    row, encoding-row scale row, bias row), null below ``int8["start"]``;
    then qenc, qh, iq."""
    last = mlp.cfg.layer_num - 1
    get = lambda k: int8["frag"].get(k, int8.get(k))
    ptrs = []
    for i in range(mlp.cfg.layer_num):
        pre, bias = ("s", f"b{i}") if i == last else ("c", f"B{i}")
        keys = (f"w{i}q", f"w{i}sq", f"{pre}{i}", f"{pre}{i}s", bias)
        ptrs += [get(k) if i >= int8["start"] else None for k in keys]
    tap = int8["tap"]
    return ptrs + [int8["qenc"], int8.get("qh"),
                   int8.get(f"iq{tap}") if tap is not None else None]


def render_stage(mlp: NerfMLP, rays, z, *, fine: bool, num_freqs: int,
                 dirs_freqs: int, var_scale: float = 1.0,
                 early_term_eps: float = 0.0, white_bg: bool = False,
                 packed=None, int8=None, debug_q: bool = False):
    """One fused render stage -> dict(weights, depth, acc[, rgb, feat, pts]).
    ``int8`` (``quant.pack_mlp_int8``): run the trunk from ``int8["start"]``
    on in the quantized domain; ``debug_q`` adds the int8 encoding ``xq``
    and the last layer's int8 input ``hq`` (``int8`` only)."""
    _check_config(mlp, num_freqs, dirs_freqs)
    if rays.device.type != "cuda":
        return render_stage_plain(mlp, rays, z, fine=fine, num_freqs=num_freqs,
                                  dirs_freqs=dirs_freqs, var_scale=var_scale,
                                  early_term_eps=early_term_eps,
                                  white_bg=white_bg, int8=int8,
                                  debug_q=debug_q)
    cfg = mlp.cfg
    packed = pack_mlp(mlp) if packed is None else packed
    qptrs = [] if int8 is None else int8_pointers(mlp, int8)
    require_cuda_tensors("render_stage", rays, z,
                         *[p for p in [*packed, *qptrs] if p is not None])
    n, S = z.shape[0], z.shape[1] - 1
    if rays.dtype != torch.float32 or z.dtype != torch.float32 \
            or rays.shape != (n, 12):
        raise ValueError("render_stage: rays (N, 12) and z (N, S+1) f32")
    if n % TILE_RAYS or S % SAMPLE_BLOCK or cfg.hid_dim not in KERNEL_HIDS:
        raise NotImplementedError(
            f"render kernel needs N % {TILE_RAYS} == 0, S % {SAMPLE_BLOCK} "
            f"== 0 and hid in {KERNEL_HIDS} (N={n}, S={S}, "
            f"hid={cfg.hid_dim})")
    if debug_q and int8 is None:
        raise ValueError("render_stage: debug_q needs the int8 trunk")
    if int8 is not None and fine and int8["tap"] != eval_feat_layer(cfg):
        raise ValueError("render_stage: the fine stage's int8 trunk must be "
                         "packed with its tap layer")
    if torch.is_grad_enabled() and any(p.requires_grad for p in mlp.parameters()):
        raise RuntimeError("render kernel has no backward (ROADMAP kernels "
                           "5-6): call under torch.no_grad()")
    dev = rays.device
    f32 = dict(device=dev, dtype=torch.float32)
    hid = cfg.hid_dim
    out = {"weights": torch.empty(n, S, **f32), "depth": torch.empty(n, **f32),
           "acc": torch.empty(n, **f32)}
    if fine:
        out.update(rgb=torch.empty(n, 3, **f32), feat=torch.empty(n, hid, **f32),
                   pts=torch.empty(n, 3, **f32))
    dbg = (torch.empty(n, S, ENC_PAD + hid, device=dev, dtype=torch.int8)
           if debug_q else None)
    ptr = lambda p: None if p is None else p.data_ptr()
    ptrs = (ctypes.c_void_p * (len(packed) + 2))(
        *map(ptr, packed), rays.data_ptr(), z.data_ptr())
    qarr = (ctypes.c_void_p * len(qptrs))(*map(ptr, qptrs)) if qptrs else None
    opt = lambda k: out[k].data_ptr() if k in out else None
    log_eps = math.log(early_term_eps) if early_term_eps > 0 else -math.inf
    err = library().nm_render_forward(
        ptrs, qarr, n, hid, cfg.layer_num, eval_feat_layer(cfg),
        -1 if int8 is None else int8["start"], num_freqs, dirs_freqs, S,
        var_scale, log_eps, int(white_bg), int(fine),
        out["weights"].data_ptr(), out["depth"].data_ptr(),
        out["acc"].data_ptr(), opt("rgb"), opt("feat"), opt("pts"),
        ptr(dbg), stream_ptr(dev))
    check(err, "render")
    name = "render_fine" if fine else "render_coarse"
    LAUNCHES[name if int8 is None else name + "_int8"] += 1
    if debug_q:
        out.update(xq=dbg[..., :cfg.xyz_dim], hq=dbg[..., ENC_PAD:])
    return out


def early_term_mask(alpha, eps: float):
    """(N, S) bool: samples the kernel skips at ``eps`` (see module doc)."""
    n, S = alpha.shape
    if eps <= 0:
        return torch.zeros_like(alpha, dtype=torch.bool)
    log_t = torch.log(1.0 - alpha + 1e-10)
    blk = log_t.reshape(n, S // SAMPLE_BLOCK, SAMPLE_BLOCK).sum(-1)
    before = torch.cumsum(blk, dim=-1) - blk             # carry entering block
    dead = (before < math.log(eps)).reshape(n // TILE_RAYS, TILE_RAYS, -1)
    dead = dead.all(dim=1)
    dead[:, 0] = False                                   # block 0 always runs
    dead = torch.cummax(dead.to(torch.int32), dim=-1).values.bool()
    dead = dead.repeat_interleave(TILE_RAYS, dim=0)
    return dead.repeat_interleave(SAMPLE_BLOCK, dim=1)


def _sat8(x):
    return torch.clamp(x, -127.0, 127.0)


def mlp_plain(mlp: NerfMLP, enc, dirs, feat_layer: int, trunk_bf16: bool,
              int8=None, debug=None):
    """The kernel's MLP: (sigma, rgb, tap) from the encoding (..., xyz_dim)
    and the viewdir PE (..., dirs_dim).  With ``trunk_bf16`` every matrix
    product of the trunk, feature, views and rgb layers rounds its operands
    to bf16 (the dirs rows of the views layer excepted); sigma reads the f32
    activations.

    ``int8`` (from ``quant.pack_mlp_int8``): the trunk layers from
    ``int8["start"]`` on run in the quantized domain.  Integer products are
    f32 products of integer-valued tensors, exact since every sum stays
    below 2^24 (127^2 * 352); rounding is half-even (``torch.round``) for
    the encoding and the posttap boundary, truncation after ``max(y, 0.5)``
    for hidden layers.  ``debug`` (a dict) receives the int8 encoding
    ``xq`` and the int8 input of the last layer ``hq``."""
    cfg = mlp.cfg
    rnd = (lambda x: x.to(torch.bfloat16).float()) if trunk_bf16 else (lambda x: x)
    lin = lambda x, layer: F.linear(rnd(x), rnd(layer.weight), layer.bias)
    L = cfg.layer_num
    start = L if int8 is None else int8["start"]
    h, tap = enc, None
    for i in range(start):
        x = torch.cat([enc, h], dim=-1) if i > 0 and i - 1 in cfg.skips else h
        h = torch.relu(lin(x, mlp.pts_linears[i]))
        if i == feat_layer:
            tap = h
    if int8 is not None:
        q, E, last = int8, enc.shape[-1], L - 1
        xq = _sat8(torch.round(enc * q["qenc"][..., :E]))
        hq = _sat8(torch.round(h * q["qh"])) if start > 0 else None
        for i in range(start, L):
            inp = xq if i == 0 else hq
            if i == last and debug is not None:
                debug.update(xq=xq, hq=inp)
            acc = inp @ q[f"w{i}q"][:inp.shape[-1]].float()
            pre = "s" if i == last else "c"
            y = acc * q[f"{pre}{i}"]
            if f"w{i}sq" in q:
                y = y + (xq @ q[f"w{i}sq"][:E].float()) * q[f"{pre}{i}s"]
            if i == last:
                h = torch.relu(y + q[f"b{i}"])
                if i == feat_layer:
                    tap = h
            else:
                y = torch.clamp(y + q[f"B{i}"], min=0.5)
                if i == feat_layer:
                    tap = (y - 0.5) * q[f"iq{i}"]
                hq = torch.trunc(torch.clamp(y, max=127.0))
    sigma = F.linear(h, mlp.alpha_linear.weight, mlp.alpha_linear.bias)[..., 0]
    feature = lin(h, mlp.feature_linear)
    views = mlp.views_linears[0]
    w_h, w_d = views.weight[:, :cfg.hid_dim], views.weight[:, cfg.hid_dim:]
    hv = torch.relu(F.linear(rnd(feature), rnd(w_h)) + F.linear(dirs, w_d)
                    + views.bias)
    rgb = torch.sigmoid(F.linear(rnd(hv), mlp.rgb_linear.weight,
                                 mlp.rgb_linear.bias))
    return sigma, rgb, tap


def render_stage_plain(mlp: NerfMLP, rays, z, *, fine: bool, num_freqs: int,
                       dirs_freqs: int, var_scale: float = 1.0,
                       early_term_eps: float = 0.0, white_bg: bool = False,
                       trunk_bf16: bool = True, int8=None,
                       debug_q: bool = False):
    """Plain PyTorch version of :func:`render_stage` (same outputs).
    ``int8``: the quantized trunk (see :func:`mlp_plain`); ``debug_q`` adds
    its int8 encoding ``xq`` (N, S, E) and the last layer's int8 input
    ``hq`` (N, S, hid)."""
    o, d = rays[:, 0:3], rays[:, 8:11]
    t0, t1 = z[:, :-1], z[:, 1:]
    t_mean, t_var, r_var = frustum_moments(t0, t1, rays[:, 11:12])
    mean, var = lift_gaussian(d, t_mean, var_scale * t_var, var_scale * r_var)
    mean = mean + o[:, None, :]
    enc, _ = ipe_embedding(mean, var, num_freqs)
    dirs = pe_embedding(d, dirs_freqs)[:, None, :]
    debug = {} if debug_q else None
    sigma, rgb_s, tap = mlp_plain(
        mlp, enc, dirs, eval_feat_layer(mlp.cfg) if fine else -1, trunk_bf16,
        int8=int8, debug=debug)
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * (t1 - t0))
    alpha = torch.where(early_term_mask(alpha, early_term_eps),
                        torch.zeros_like(alpha), alpha)
    log_t = torch.log(1.0 - alpha + 1e-10)
    weights = alpha * torch.exp(torch.cumsum(log_t, dim=-1) - log_t)
    acc = weights.sum(-1)
    out = {"weights": weights, "depth": (weights * 0.5 * (t0 + t1)).sum(-1),
           "acc": acc}
    if fine:
        rgb = (weights[..., None] * rgb_s).sum(1)
        if white_bg:
            rgb = rgb + (1.0 - acc[:, None])
        tw = (weights * t_mean).sum(-1, keepdim=True)
        out.update(rgb=rgb, feat=(weights[..., None] * tap).sum(1),
                   pts=o * acc[:, None] + d * tw)
    if debug_q:
        out.update({k: v.to(torch.int8) for k, v in debug.items()})
    return out
