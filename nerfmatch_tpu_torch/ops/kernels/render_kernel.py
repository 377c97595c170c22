"""Fused mip-NeRF render stage: CUDA kernel wrapper and its plain version.

Replaces ``nerfmatch_tpu/ops/pallas/render_kernel.py: make_fused_render``.
One stage = frustum moments -> IPE -> NeRF MLP -> heads -> alpha
compositing over packed rays (N, 12) in the unit-direction
parameterization and z fenceposts (N, S+1).  ``fine=False`` is the coarse
variant (weights, depth, acc); ``fine=True`` adds rgb, the composited
descriptor (the MLP's tap layer) and the composited point
``o * acc + d * sum(w * t_mean)``; with ``feat_max`` (``feat_comb='max'``)
the descriptor and the point ``o + d * t_mean`` of each ray's sample with
the largest weight instead, the first in z order among equal weights (as
``torch.argmax`` and ``jnp.argmax``).  An appearance NeRF's fine stage takes
``app`` (N, 16), each ray's appearance row: the views layer adds
``app @ Wva`` to the per-ray ``dirs_pe @ Wvd`` (f32 FMA on unrounded
weights); nothing else reads it, so weights, depth, feat and pts do not
depend on it.

Precision follows the JAX kernel: the MLP's matrix products take bf16
operands with f32 accumulation; everything else is f32.  The plain version
rounds the same operands (``trunk_bf16=True``, the default) or, as the
tests' f32 reference, runs the MLP in f32 (the XLA path's precision).

Early termination (``early_term_eps > 0``): rays are grouped in tiles of
:data:`TILE_RAYS`; once every ray of a tile has transmittance < eps after a
block of :data:`SAMPLE_BLOCK` samples, the remaining blocks get exact zero
weights.  Skipped weights are < eps, so outputs move by < eps.

CUDA tensors launch the kernel ``csrc/render_eval.cuh`` (``wgmma``; it
raises on anything the kernel does not implement) with the weights of
:func:`pack_mlp`: a bf16 trunk, or the int8 trunk of
``quant.pack_kernel_int8`` (s8 ``wgmma`` from its first int8 layer on).  An
MLP whose width is not instantiated (``render_train_kernel.KERNEL_HIDS``)
runs at the next wider one on zero-padded weights, and its descriptor is
sliced back to its width; above 256 it raises (ROADMAP Queue 2A).  CPU
tensors run :func:`render_stage_plain`.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import LAUNCHES, check, library, require_cuda_tensors, stream_ptr
from ...nerf.embedding import ipe_embedding, pe_embedding
from ...nerf.model import NerfMLP, eval_feat_layer, pnt_mode
from ...nerf.sampling import frustum_moments, lift_gaussian
from .render_train_kernel import (APP_DIM, ENC_MAX, ENC_STD, _skip_in,
                                  check_encoding, enc_rows, forward_images,
                                  kernel_cfg, kernel_width,
                                  pad_mlp_to_kernel_width, views_cols)

TILE_RAYS = 2
SAMPLE_BLOCK = 32


def stream_bytes(cfg, int8_from=None) -> int:
    """Bytes of the weight images the render kernel's ring streams for
    ``cfg`` at its kernel width (:func:`pack_mlp`): the bf16 images of the
    trunk layers below ``int8_from`` (every layer without it), the s8
    images of the others (the encoding rows padded to whole 64-row slots),
    the feature and views layers'."""
    cfg = kernel_cfg(cfg)
    hid, L, E = cfg.hid_dim, cfg.layer_num, enc_rows(cfg.xyz_dim)
    start = L if int8_from is None else int8_from
    n = 0
    for i in range(L):
        enc, rows = _skip_in(cfg, i), hid if i > 0 else 0
        n += hid * (2 * (E * enc + rows) if i < start
                    else -(-E // 64) * 64 * enc + rows)
    return n + 2 * hid * (hid + views_cols(hid))


def check_int8_width(int8, layer_num: int, width: int, who: str):
    """Raise unless the int8 trunk ``int8`` was packed at the kernel width
    ``width`` (``quant.pack_kernel_int8``)."""
    packed_at = int8[f"w{layer_num - 1}q"].shape[1]
    if packed_at != width:
        raise ValueError(f"{who}: int8 trunk packed at width {packed_at}, the "
                         f"kernel runs at {width} (quant.pack_kernel_int8)")


def pack_mlp(mlp: NerfMLP, int8=None):
    """The render kernel's weight list (``csrc/render_eval.cuh``), in the
    order its C entry expects: the slot images its ring streams, per layer
    (its encoding flag or None, bias), then wa, ba, bf, wvd, wva, bv, wr,
    br, of ``mlp`` at its kernel width (:func:`pad_mlp_to_kernel_width`;
    ``int8`` packed at that width: ``quant.pack_kernel_int8``).
    A bf16 trunk's images are every matrix's bf16 slot images
    (``render_train_kernel.forward_images``, the images kernel 5 reads);
    with ``int8`` (``quant.pack_mlp_int8``) the trunk layers from
    ``int8["start"]`` on are its s8 images (``int8["img"]``), in bytes.  wvd
    and wva (the views layer's dirs and appearance rows; wva None without
    a table) and wr (the rgb head) stay f32: the kernel's FMAs take them
    unrounded.  A scene-coordinate head (``pnt_block``) is not packed, as
    the Pallas pack leaves it out."""
    mlp, _ = pad_mlp_to_kernel_width(mlp)
    cfg = mlp.cfg
    if int8 is not None:
        check_int8_width(int8, cfg.layer_num, cfg.hid_dim, "pack_mlp")
    fwd, enc_at = forward_images(mlp, None if int8 is None else int8["start"])
    if int8 is None:
        imgs, flags = fwd, {i: fwd[at:] for i, at in enc_at.items()}
    else:
        hid = cfg.hid_dim
        heads = fwd.numel() - hid * (hid + views_cols(hid))
        imgs = torch.cat([fwd[:heads].view(torch.uint8),
                          int8["img"].view(torch.uint8),
                          fwd[heads:].view(torch.uint8)])
        flags = {i: imgs for i in range(cfg.layer_num) if _skip_in(cfg, i)}
    out = [imgs]
    for i, lin in enumerate(mlp.pts_linears):
        out += [flags.get(i), lin.bias.detach().contiguous()]
    wv = mlp.views_linears[0].weight.detach()
    app_at = cfg.hid_dim + cfg.dirs_dim
    out += [mlp.alpha_linear.weight.detach().reshape(-1).contiguous(),
            mlp.alpha_linear.bias.detach().contiguous(),
            mlp.feature_linear.bias.detach().contiguous(),
            wv[:, cfg.hid_dim:app_at].t().contiguous(),
            wv[:, app_at:].t().contiguous() if cfg.app_dim else None,
            mlp.views_linears[0].bias.detach().contiguous(),
            mlp.rgb_linear.weight.detach().t().contiguous(),
            mlp.rgb_linear.bias.detach().contiguous()]
    return out


def kernel_forms_descriptor(cfg) -> bool:
    """Whether the descriptor of an MLP config is the trunk activation the
    kernel taps: not the views layer's of a ``"viewdir"`` head, and not a
    final-layer tap on a skip layer (the plain descriptor there is the
    post-concat state, which the kernel never forms)."""
    if cfg.stop_layer < 0 and "viewdir" in (pnt_mode(cfg) or ""):
        return False
    tap = eval_feat_layer(cfg)
    return not (tap == cfg.layer_num - 1 and tap in cfg.skips)


def check_render_config(cfg, num_freqs: int, dirs_freqs: int):
    """Raise for MLP and encoding widths the kernel does not take: a width
    above 256 (``render_train_kernel.kernel_width``), an encoding past the
    JAX kernels' limits (``render_train_kernel.check_encoding``)."""
    check_encoding(cfg, num_freqs, dirs_freqs, "render kernel")
    kernel_width(cfg.hid_dim)


def _check_config(mlp: NerfMLP, num_freqs: int, dirs_freqs: int, fine: bool,
                  app):
    """Raise for MLPs the kernel does not render.  A scene-coordinate head
    (``pnt_block``) is accepted and not rendered: :func:`pack_mlp` packs
    the trunk and the heads only."""
    cfg = mlp.cfg
    if not cfg.use_viewdirs:
        raise NotImplementedError("fused render needs use_viewdirs")
    if not kernel_forms_descriptor(cfg):
        raise NotImplementedError(f"fused render: the descriptor of {cfg} is "
                                  "not the trunk activation the kernel taps")
    if cfg.app_dim not in (0, APP_DIM):
        raise NotImplementedError(f"appearance rows of {cfg.app_dim} columns "
                                  f"(the kernel takes {APP_DIM})")
    if cfg.xyz_dim != 6 * num_freqs or cfg.dirs_dim != 6 * dirs_freqs + 3:
        raise NotImplementedError(f"fused render config {cfg} not supported")
    if fine and bool(cfg.app_dim) != (app is not None):
        raise ValueError("render_stage: the fine stage of an appearance NeRF "
                         "takes app (N, 16), and only it")


def int8_pointers(mlp: NerfMLP, int8):
    """The int8 trunk's rows in the order of ``nm_render_eval_forward``'s
    ``qptrs``: per layer (scale row, encoding-row scale row, bias row), None
    below ``int8["start"]``; then qenc, qh, iq."""
    last = mlp.cfg.layer_num - 1
    ptrs = []
    for i in range(mlp.cfg.layer_num):
        pre, bias = ("s", f"b{i}") if i == last else ("c", f"B{i}")
        keys = (f"{pre}{i}", f"{pre}{i}s", bias)
        ptrs += [int8.get(k) if i >= int8["start"] else None for k in keys]
    tap = int8["tap"]
    return ptrs + [int8["qenc"], int8.get("qh"),
                   int8.get(f"iq{tap}") if tap is not None else None]


def render_stage(mlp: NerfMLP, rays, z, *, fine: bool, num_freqs: int,
                 dirs_freqs: int, var_scale: float = 1.0,
                 early_term_eps: float = 0.0, white_bg: bool = False,
                 packed=None, int8=None, app=None, feat_max: bool = False,
                 debug_q: bool = False, debug_tap: bool = False):
    """One fused render stage -> dict(weights, depth, acc[, rgb, feat, pts]).
    ``feat_max`` (fine stage): feat and pts of each ray's largest weight.
    ``packed``: :func:`pack_mlp` of ``mlp`` (with ``int8``), to pack once
    for many calls.  ``app`` (N, 16) f32: the appearance rows of an
    appearance NeRF's fine stage (the coarse stage emits no rgb and ignores
    it).  ``int8`` (``quant.pack_mlp_int8``): run the trunk from
    ``int8["start"]`` on in the quantized domain (on CUDA packed at the
    kernel width: ``quant.pack_kernel_int8``); ``debug_q`` adds the int8
    encoding ``xq`` and the last layer's int8 input ``hq`` (``int8`` only;
    0 in skipped blocks on CUDA).  ``debug_tap`` (fine stage, CUDA): adds the
    tap layer's activations of the kernel's first pass ``tap_first`` and of
    its second ``tap_again`` (N, S, hid; 0 in skipped blocks)."""
    if rays.device.type != "cuda":
        return render_stage_plain(mlp, rays, z, fine=fine, num_freqs=num_freqs,
                                  dirs_freqs=dirs_freqs, var_scale=var_scale,
                                  early_term_eps=early_term_eps,
                                  white_bg=white_bg, int8=int8, app=app,
                                  feat_max=feat_max, debug_q=debug_q)
    _check_config(mlp, num_freqs, dirs_freqs, fine, app)
    cfg = mlp.cfg
    check_render_config(cfg, num_freqs, dirs_freqs)
    hid, W = cfg.hid_dim, kernel_width(cfg.hid_dim)
    start = None if int8 is None else int8["start"]
    if int8 is not None:
        check_int8_width(int8, cfg.layer_num, W, "render_stage")
    if packed is None:
        packed = pack_mlp(mlp, int8)
    if (packed[0].dtype == torch.bfloat16) != (int8 is None) or \
            packed[0].numel() * packed[0].element_size() != stream_bytes(cfg, start):
        raise ValueError("render_stage: packed for another trunk (pack_mlp(mlp, "
                         "int8) packs the one int8 gives)")
    qptrs = None if int8 is None else int8_pointers(mlp, int8)
    app = app if fine else None
    require_cuda_tensors("render_stage", rays, z, *[
        p for p in [*packed, *(qptrs or []), app] if p is not None])
    n, S = z.shape[0], z.shape[1] - 1
    if rays.dtype != torch.float32 or z.dtype != torch.float32 \
            or rays.shape != (n, 12):
        raise ValueError("render_stage: rays (N, 12) and z (N, S+1) f32")
    if app is not None and (app.dtype != torch.float32
                            or app.shape != (n, APP_DIM)
                            or not app.is_contiguous()):
        raise ValueError(f"render_stage: app ({n}, {APP_DIM}) f32, "
                         "contiguous")
    if n % TILE_RAYS or S % SAMPLE_BLOCK:
        raise NotImplementedError(
            f"render kernel needs N % {TILE_RAYS} == 0 and S % {SAMPLE_BLOCK} "
            f"== 0 (N={n}, S={S})")
    if debug_q and int8 is None:
        raise ValueError("render_stage: debug_q needs the int8 trunk")
    if debug_tap and not fine:
        raise ValueError("render_stage: debug_tap needs the fine stage")
    if (debug_tap or debug_q) and enc_rows(cfg.xyz_dim) > ENC_STD:
        raise NotImplementedError("render_stage: the debug outputs exist at "
                                  "encodings up to 96 columns (the wide "
                                  "encoding's instantiation has none)")
    if feat_max and not fine:
        raise ValueError("render_stage: feat_max needs the fine stage")
    if int8 is not None and fine and int8["tap"] != eval_feat_layer(cfg):
        raise ValueError("render_stage: the fine stage's int8 trunk must be "
                         "packed with its tap layer")
    if torch.is_grad_enabled() and any(p.requires_grad for p in mlp.parameters()):
        raise RuntimeError("render kernel has no backward (ROADMAP kernels "
                           "5-6): call under torch.no_grad()")
    dev = rays.device
    f32 = dict(device=dev, dtype=torch.float32)
    out = {"weights": torch.empty(n, S, **f32), "depth": torch.empty(n, **f32),
           "acc": torch.empty(n, **f32)}
    if fine:
        out.update(rgb=torch.empty(n, 3, **f32), feat=torch.empty(n, W, **f32),
                   pts=torch.empty(n, 3, **f32))
    ptr = lambda p: None if p is None else p.data_ptr()
    ptrs = (ctypes.c_void_p * (len(packed) + 2))(
        *map(ptr, packed), rays.data_ptr(), z.data_ptr())
    qarr = None if qptrs is None else (ctypes.c_void_p * len(qptrs))(*map(ptr, qptrs))
    opt = lambda k: out[k].data_ptr() if k in out else None
    outs = (out["weights"].data_ptr(), out["depth"].data_ptr(),
            out["acc"].data_ptr(), opt("rgb"), opt("feat"), opt("pts"))
    log_eps = math.log(early_term_eps) if early_term_eps > 0 else -math.inf
    counter = torch.zeros(1, device=dev, dtype=torch.int32)
    dbg = torch.zeros(2, n, S, W, **f32) if debug_tap else None
    dbgq = (torch.zeros(n, S, ENC_MAX + W, device=dev, dtype=torch.int8)
            if debug_q else None)
    with torch.cuda.device(dev):
        err = library().nm_render_eval_forward(
            ptrs, qarr, ptr(app), n, W, cfg.layer_num, eval_feat_layer(cfg),
            -1 if start is None else start, num_freqs, dirs_freqs, S,
            var_scale, log_eps, int(white_bg), int(fine), int(feat_max),
            counter.data_ptr(), *outs, ptr(dbg), ptr(dbgq), stream_ptr(dev))
    check(err, "render_eval")
    LAUNCHES[("render_fine" if fine else "render_coarse")
             + ("" if int8 is None else "_int8")
             + ("" if app is None else "_app")
             + ("_max" if feat_max else "")] += 1
    if fine and W != hid:
        out["feat"] = out["feat"][:, :hid].contiguous()
    if debug_tap:
        out.update(tap_first=dbg[0, ..., :hid], tap_again=dbg[1, ..., :hid])
    if debug_q:
        out.update(xq=dbgq[..., :cfg.xyz_dim], hq=dbgq[..., ENC_MAX:ENC_MAX + hid])
    return out


def feat_max_agreement(out, ref, rays, z):
    """How far a fine stage with ``feat_max`` (``out``) agrees with another
    on the same rays and fenceposts (``ref``), both dicts of tensors.  The
    argmax is discontinuous: where a ray's two largest ``ref`` weights lie
    within a margin (twice the largest weight difference of the two), either
    may win, and the whole descriptor row changes.  ->
    dict(margin, near_tie: rays inside it, flipped: those of them whose
    point differs from ``ref``'s by more than 1e-5 (another sample won),
    pts_err / feat_err: largest error of the other rays (feat relative to
    ``ref``'s largest value), pick_err: over the rays inside it, the
    distance of ``out``'s point to the nearest point ``o + d * t_mean`` of a
    sample whose ``ref`` weight lies within the margin of ``ref``'s
    largest)."""
    w_ref = ref["weights"]
    margin = 2.0 * float((out["weights"] - w_ref).abs().max())
    top2 = torch.topk(w_ref, 2, dim=-1).values
    tie = (top2[:, 0] - top2[:, 1]) <= margin
    far = ~tie
    pts_err = float((out["pts"][far] - ref["pts"][far]).abs().max()) \
        if far.any() else 0.0
    feat_err = float((out["feat"][far] - ref["feat"][far]).abs().max()
                     / ref["feat"].abs().max()) if far.any() else 0.0
    pick_err = 0.0
    if tie.any():
        t_mean = frustum_moments(z[tie, :-1], z[tie, 1:],
                                 rays[tie, 11:12])[0]
        cand = w_ref[tie] >= top2[tie, :1] - margin
        pts = rays[tie, None, 0:3] + rays[tie, None, 8:11] * t_mean[..., None]
        dist = (pts - out["pts"][tie, None, :]).abs().amax(-1)
        pick_err = float(torch.where(cand, dist, torch.inf).amin(-1).max())
    flipped = int(((out["pts"] - ref["pts"]).abs().amax(-1) > 1e-5)[tie].sum())
    return dict(margin=margin, near_tie=int(tie.sum()), flipped=flipped,
                pts_err=pts_err, feat_err=feat_err, pick_err=pick_err)


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


def stage_alpha_plain(mlp: NerfMLP, rays, z, *, num_freqs: int,
                      dirs_freqs: int, var_scale: float = 1.0, int8=None,
                      app=None):
    """(N, S) alpha of the plain stage with its bf16 MLP operands (and the
    int8 trunk ``int8``), before early termination: what
    :func:`early_term_mask` reads (``app`` does not move it)."""
    t0, t1 = z[:, :-1], z[:, 1:]
    t_mean, t_var, r_var = frustum_moments(t0, t1, rays[:, 11:12])
    d = rays[:, 8:11]
    mean, var = lift_gaussian(d, t_mean, var_scale * t_var, var_scale * r_var)
    enc, _ = ipe_embedding(mean + rays[:, None, 0:3], var, num_freqs)
    dirs = pe_embedding(d, dirs_freqs)[:, None, :]
    sigma = mlp_plain(mlp, enc, dirs, -1, True, int8=int8, app=app)[0]
    return 1.0 - torch.exp(-torch.relu(sigma) * (t1 - t0))


def _sat8(x):
    return torch.clamp(x, -127.0, 127.0)


def mlp_plain(mlp: NerfMLP, enc, dirs, feat_layer: int, trunk_bf16: bool,
              int8=None, debug=None, app=None):
    """The kernel's MLP: (sigma, rgb, tap) from the encoding (..., xyz_dim),
    the viewdir PE (..., dirs_dim) and, for an appearance NeRF, the
    appearance rows ``app`` (..., 16; None: rgb is not computed).  With
    ``trunk_bf16`` every matrix product of the trunk, feature, views and
    rgb layers rounds its operands to bf16 (the dirs and appearance rows of
    the views layer excepted, f32 on unrounded weights as the kernel's
    FMAs); sigma reads the f32 activations.

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
    if cfg.app_dim and app is None:
        return sigma, None, tap
    feature = lin(h, mlp.feature_linear)
    views = mlp.views_linears[0]
    app_at = cfg.hid_dim + cfg.dirs_dim
    w_h, w_d = views.weight[:, :cfg.hid_dim], views.weight[:, cfg.hid_dim:app_at]
    xt = F.linear(dirs, w_d)
    if cfg.app_dim:
        xt = xt + F.linear(app, views.weight[:, app_at:])
    hv = torch.relu(F.linear(rnd(feature), rnd(w_h)) + xt + views.bias)
    rgb = torch.sigmoid(F.linear(rnd(hv), mlp.rgb_linear.weight,
                                 mlp.rgb_linear.bias))
    return sigma, rgb, tap


def render_stage_plain(mlp: NerfMLP, rays, z, *, fine: bool, num_freqs: int,
                       dirs_freqs: int, var_scale: float = 1.0,
                       early_term_eps: float = 0.0, white_bg: bool = False,
                       trunk_bf16: bool = True, int8=None, app=None,
                       feat_max: bool = False, debug_q: bool = False):
    """Plain PyTorch version of :func:`render_stage` (same outputs).
    ``int8``: the quantized trunk (see :func:`mlp_plain`); ``app`` (N, 16):
    the appearance rows of the fine stage; ``debug_q`` adds its int8
    encoding ``xq`` (N, S, E) and the last layer's int8 input ``hq`` (N, S,
    hid); ``feat_max``: feat and pts of each ray's first largest weight."""
    _check_config(mlp, num_freqs, dirs_freqs, fine, app)
    if feat_max and not fine:
        raise ValueError("render_stage_plain: feat_max needs the fine stage")
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
        int8=int8, debug=debug,
        app=None if app is None or not fine else app[:, None, :])
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
        if feat_max:
            best = weights.argmax(-1, keepdim=True)      # first occurrence
            feat = torch.take_along_dim(tap, best[..., None], dim=1)[:, 0]
            pts = o + d * torch.take_along_dim(t_mean, best, dim=1)
        else:
            feat = (weights[..., None] * tap).sum(1)
            pts = o * acc[:, None] + d * (weights * t_mean).sum(-1, keepdim=True)
        out.update(rgb=rgb, feat=feat, pts=pts)
    if debug_q:
        out.update({k: v.to(torch.int8) for k, v in debug.items()})
    return out
