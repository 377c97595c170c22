"""Fused mip-NeRF TRAIN render stage: CUDA kernels, their plain version, and
the autograd binding.

Replaces ``nerfmatch_tpu/ops/pallas/render_train.py:
make_fused_train_render`` (``_fwd_impl`` and the hand-written ``_bwd_impl``).
One stage: frustum moments of the (jittered) z fenceposts -> IPE -> NeRF MLP
-> density noise before the ReLU -> heads -> alpha compositing, returning
``rgb`` (N, 3) and the per-sample ``weights`` (N, S).  The backward returns
gradients for every MLP parameter in the parameter's own layout; rays, z
and noise get none (as in JAX).  An appearance MLP (``app_dim`` 16) takes
``app`` (N, 16), each ray's appearance row: it joins the views layer once a
ray, after the viewdir PE (``extras @ wvx``), and its cotangent ``g_app``
comes back as the JAX kernel's ``extras_grad`` does (``render_train.py:
303-312``).

Widths: the kernels are instantiated at the MLP widths :data:`TRAIN_HIDS`
(the eval render kernels, ``render_kernel``, at :data:`EVAL_HIDS`; 512 and
1024 in both on engines of their own, the tile engines of
``csrc/render_train_512.cuh`` and ``csrc/render_eval_512.cuh``, 1024 in two
N passes a layer); an MLP of another width up to 1024 runs at the smallest
of them that holds it, on a zero-padded copy of its weights
(:func:`pad_mlp_to_kernel_width`: the padded hidden units take zero weights
in and out and a zero bias, so they stay 0 and move nothing), and its
gradients are sliced back to the parameters' shapes.  Wider MLPs raise
``NotImplementedError`` on the card (``NerfTrainer`` trains them on the
plain route without ``render.use_fused_train``: :func:`train_kernels_take`).
At 1024 the kernels take a scratch for the first N pass's outputs
(``nm_render_train_scratch``: 64 KB a block, a block an SM), which the
wrappers allocate.
The encoding takes 2 * 3 * F <= 128 columns and a ray's view-direction PE
plus its appearance row <= 128, the JAX kernels' limits; the products and
the stash take them padded (:func:`enc_rows`: 96 rows up to 96 columns,
the production encoding's code, 128 beyond; :func:`dirs_rows`).

Precision follows the JAX kernel: every matrix product takes bf16 operands
with f32 accumulation (the views layer's dirs rows and the rgb head
included), residual activations are bf16, the backward's matrix operands
are bf16, and the matrix-weight gradients are rounded to bf16; biases, the
sigma head and compositing stay f32.  ``g_app`` is the per-ray sum over
samples of ``g_hv`` (f32), rounded to bf16 once, times the bf16 appearance
rows of the views weight in f32 (the JAX kernel rounds each sample's
product to bf16 and sums those: the two differ by that rounding).

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
from ...nerf.model import NerfMLP, effective_stop_layer
from ...nerf.sampling import frustum_moments

TILE_RAYS = 2         # csrc: kTileRays (N even; N / 2 vector-partial rows)
KERNEL_SAMPLES = (64, 128, 256)   # csrc: one 64-row half or whole 128-row chunks
# The instantiated MLP widths of each kernel family: the train kernels
# (csrc: render_train_<HID>.cu, HID 512 and 1024 on render_train_512.cuh's
# tile engine) and the eval render kernels (csrc:
# render_eval_<trunk>_<HID>.cu, HID 512 and 1024 on render_eval_512.cuh's
# tile engine); 1024 in two N passes a layer in both.
TRAIN_HIDS = (64, 128, 192, 256, 512, 1024)
EVAL_HIDS = (64, 128, 192, 256, 512, 1024)
FAMILY_HIDS = {"train": TRAIN_HIDS, "eval": EVAL_HIDS}
# The widest MLP whose engines take each layer's A operand from the
# accumulator's registers (csrc: render_eval.cuh, render_train.cuh); the
# widths above it run on render_eval_512.cuh and render_train_512.cuh, A
# from shared memory.
REGISTER_A_MAX = 256
ENC_MAX = 128         # csrc: kEncMax (the widest encoding, 2 * 3 * 21 <= 128)
ENC_STD = 96          # csrc: kEncStd (the production encoding's instantiation)
EXTRA_MAX = 128       # csrc: kExtraMax (view-direction PE + appearance row)
APP_DIM = 16          # csrc: kAppDim (columns of an appearance row)
GRGB_WIDTH = 8        # csrc: kGrgbWidth
REC_WIDTH = 8         # csrc: kRecWidth (f32 record a sample)
MAX_SPLITS = 48       # csrc: kMaxSplits (the GEMM's row ranges)
SLOT_ROWS = 32        # csrc: kSliceK (weight rows a ring slot)


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


def enc_rows(enc_dim: int) -> int:
    """The encoding's rows as the kernels take them (csrc: enc_rows): the K
    of the encoding products and the stash's encoding width, 96 (three
    32-row slices of the weight rings) up to 96 columns, the production
    encoding's instantiation (15 frequencies: 90), else 128 (the wide
    one's)."""
    return ENC_STD if enc_dim <= ENC_STD else ENC_MAX


def dirs_rows(dirs_dim: int) -> int:
    """The view-direction PE's rows padded the same way (csrc: dirs_rows):
    the dirs part of a ray's stashed extras row (32 for 4 frequencies)."""
    return -(-dirs_dim // SLOT_ROWS) * SLOT_ROWS


def views_cols(hid: int) -> int:
    """Columns of the views layer's forward images: its hid // 2 outputs in
    whole 64-column blocks (the views product is max(hid // 2, 64) wide)."""
    return max(-(-(hid // 2) // 64) * 64, 64)


def kernel_width(hid: int, family: str) -> int:
    """The instantiated width an MLP of ``hid`` runs at in the kernel
    ``family`` ("train": kernels 5-6, "eval": kernels 1 and 1b): the
    smallest of its widths (:data:`FAMILY_HIDS`) that holds it.  Above the
    largest ``NotImplementedError``.  Both families take 257-512 on engines
    of their own (two warpgroups an m64n256 N-half each, A from a 64-row
    shared-memory tile) and 513-1024 on the same engines in two N passes a
    layer (the first pass's outputs parked in global memory), and stop
    there: a wider layer's 64-row bf16 activation tile no longer fits in
    shared memory beside a weight ring."""
    hids = FAMILY_HIDS[family]
    for w in hids:
        if hid <= w:
            return w
    kernels = "train kernels (5-6)" if family == "train" \
        else "eval kernels (1, 1b)"
    raise NotImplementedError(
        f"render {kernels}: hid_dim {hid} > {hids[-1]} (ROADMAP Queue 2, "
        f"MLP widths above {hids[-1]}: one 64-row activation tile of the "
        "width in shared memory beside the weight ring)")


def train_kernels_take(cfg) -> bool:
    """Whether the train kernels hold an MLP config's width (a pure
    function of the config: :class:`NerfTrainer` routes by it)."""
    return cfg.hid_dim <= TRAIN_HIDS[-1]


def kernel_cfg(cfg, family: str):
    """``cfg`` at its kernel width (:func:`kernel_width`)."""
    return dataclasses.replace(cfg, hid_dim=kernel_width(cfg.hid_dim, family))


def _pad_to(x, shape):
    """x zero-padded at the end of each dimension to ``shape``."""
    pads = []
    for d in reversed(range(x.dim())):
        pads += [0, shape[d] - x.shape[d]]
    return F.pad(x, pads)


@torch.no_grad()
def pad_mlp_to_kernel_width(mlp: NerfMLP, family: str):
    """-> (an MLP at the kernel width :func:`kernel_width` gives for the
    kernel ``family``, the real hid).  The padded MLP holds zero-padded copies of the weights: a padded
    hidden unit has zero weights in and out and a zero bias, so it is 0
    after every ReLU and adds nothing to a real column, in the forward or
    the backward; the views layer's hid // 2 outputs pad the same way.  Its
    config keeps the descriptor tap and drops the scene-coordinate head,
    which the kernels neither render nor pack.  ``mlp`` itself where its
    width is instantiated; its parameters are never resized."""
    cfg = mlp.cfg
    hid, W = cfg.hid_dim, kernel_width(cfg.hid_dim, family)
    if W == hid:
        return mlp, hid
    kcfg = dataclasses.replace(cfg, hid_dim=W, out_3d_pnt=False,
                               stop_layer=effective_stop_layer(cfg))
    with torch.device("meta"):
        kmlp = NerfMLP(kcfg)
    for name, p in kmlp.named_parameters():
        w = mlp.get_parameter(name).detach()
        if name == "views_linears.0.weight":     # [hidden | dirs | app] columns
            hv = p.shape[0]
            w = torch.cat([_pad_to(w[:, :hid], (hv, W)),
                           _pad_to(w[:, hid:], (hv, w.shape[1] - hid))], 1)
        mod, _, attr = name.rpartition(".")
        setattr(kmlp.get_submodule(mod), attr,
                torch.nn.Parameter(_pad_to(w, p.shape)))
    return kmlp, hid


def unpad_grads(g: dict, mlp: NerfMLP) -> dict:
    """Gradients of :func:`pad_mlp_to_kernel_width`'s MLP sliced back to
    the parameters of ``mlp`` (keys without a parameter pass through)."""
    hid = mlp.cfg.hid_dim
    out = dict(g)
    for name, p in mlp.named_parameters():
        if name not in g or g[name].shape == p.shape:
            continue
        v = g[name]
        if name == "views_linears.0.weight":
            W = v.shape[1] - (p.shape[1] - hid)
            v = torch.cat([v[:, :hid], v[:, W:]], 1)
        out[name] = v[tuple(slice(0, n) for n in p.shape)].contiguous()
    return out


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def train_stage_forward(spec: StageSpec, rays, z, noise, bf16: bool = True,
                        keep: bool = False, app=None):
    """Plain train stage -> (rgb, weights[, intermediates]).  Differentiable
    when called with grad enabled (``bf16=False`` is the f32 reference),
    in ``app`` (N, 16) too."""
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
    w_h, w_x = views.weight[:, :cfg.hid_dim], views.weight[:, cfg.hid_dim:]
    # extras: the viewdir PE, then the appearance row (views.weight's order).
    extras = rnd(pe_embedding(d, spec.dirs_freqs))
    if app is not None:
        extras = torch.cat([extras, rnd(app)], dim=-1)
    xt = F.linear(extras, rnd(w_x))
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
                              feature=feature, extras=extras, hv=hv,
                              rgb_s=rgb_s, dists=dists, alpha=alpha,
                              csum=csum)


@torch.no_grad()
def train_stage_backward(spec: StageSpec, rays, z, noise, g_rgb, g_w,
                         chunk_rays: int = 1024, app=None):
    """Explicit backward of the bf16 plain stage (the JAX ``bwd_kernel``,
    with its bf16 operand roundings), recomputing the forward per chunk of
    rays -> {parameter name: gradient}, and ``"app"``: ``g_app`` (N, 16)
    when ``app`` is given (the kernel's rounding, see the module doc)."""
    mlp, cfg = spec.mlp, spec.mlp.cfg
    b = _bf16
    enc, hid = cfg.xyz_dim, cfg.hid_dim
    L = cfg.layer_num
    params = dict(mlp.named_parameters())
    acc = {k: torch.zeros_like(v) for k, v in params.items()}
    wf = b(mlp.feature_linear.weight)
    views_w = mlp.views_linears[0].weight
    wvh = b(views_w[:, :hid])
    wva = b(views_w[:, hid + cfg.dirs_dim:])
    g_app = None if app is None else torch.empty(app.shape[0], APP_DIM,
                                                  device=app.device)
    wrgb = b(mlp.rgb_linear.weight)
    wa = mlp.alpha_linear.weight[0]
    w_hid = [None] + [b(lin.weight[:, enc:] if (i - 1) in cfg.skips
                        else lin.weight)
                      for i, lin in enumerate(mlp.pts_linears) if i > 0]
    outer = lambda g, a: torch.einsum("nso,nsi->oi", b(g), b(a))
    for lo in range(0, rays.shape[0], chunk_rays):
        sl = slice(lo, lo + chunk_rays)
        _, weights, f = train_stage_forward(
            spec, rays[sl], z[sl], noise[sl], keep=True,
            app=None if app is None else app[sl])
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
        g_hvsum = b(g_hv.sum(1))
        acc["views_linears.0.weight"][:, hid:] += g_hvsum.T @ f["extras"]
        if app is not None:
            g_app[sl] = g_hvsum @ wva
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
    if app is not None:
        acc["app"] = g_app
    return acc


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def slot_images(w, rows: int = SLOT_ROWS):
    """A (K, N) weight matrix (the product's k x its outputs) -> the train
    kernels' ring-slot images, bf16, (K, N) elements in another order: per
    ``rows`` rows (one slot), N / 64 blocks of ``rows`` x 64 elements, the
    16-byte chunk c of row r stored at chunk c ^ (r % 8) of its 128-byte row
    (the 128-byte swizzle their wgmma descriptors read).  One bulk copy
    fills a slot.  The backward takes the images of (out x in) rows, the
    forward those of (in x out) rows."""
    K, N = w.shape
    x = w.detach().to(torch.bfloat16).reshape(K // rows, rows, N // 64, 8, 8)
    x = x.permute(0, 2, 1, 3, 4)                   # slot, block, row, chunk
    r = torch.arange(rows, device=w.device).view(rows, 1)
    src = torch.arange(8, device=w.device).view(1, 8) ^ (r % 8)
    idx = src.view(1, 1, rows, 8, 1).expand(x.shape)
    return torch.gather(x, 3, idx).contiguous().reshape(K, N)


def _fwd_images(w, k: int | None = None, n: int | None = None):
    """Forward slot images of an (out x in) weight: its (in x out) rows,
    zero-padded to k rows and n columns."""
    wt = w.detach().t()
    wt = F.pad(wt, (0, (n or wt.shape[1]) - wt.shape[1],
                    0, (k or wt.shape[0]) - wt.shape[0]))
    return slot_images(wt).reshape(-1)


def forward_images(mlp: NerfMLP, layers: int | None = None):
    """Every weight matrix's (in x out) slot images, in the order the
    forward kernels' rings stream them (``train_fwd_kernel`` and the
    render kernel, ``csrc/render_eval.cuh``): per layer the encoding rows
    padded to :func:`enc_rows` then the hidden rows, then the feature and
    the views layers, the views' columns padded to :func:`views_cols`.
    ``layers``: only the first ``layers`` trunk layers (the render kernel's
    int8 trunk streams its own images for the others).  ``mlp`` at a kernel
    width.  Returns (the flat bf16 images, {layer: offset of its encoding
    rows' images})."""
    cfg = mlp.cfg
    enc, hid = cfg.xyz_dim, cfg.hid_dim
    imgs, enc_at = [], {}
    for i, lin in enumerate(mlp.pts_linears[:layers]):
        w = lin.weight.detach()
        if _skip_in(cfg, i):
            enc_at[i] = sum(x.numel() for x in imgs)
            imgs.append(_fwd_images(w[:, :enc], k=enc_rows(enc)))
        if i > 0:
            imgs.append(_fwd_images(w[:, enc:] if (i - 1) in cfg.skips else w))
    wv = mlp.views_linears[0].weight.detach()
    imgs += [_fwd_images(mlp.feature_linear.weight),
             _fwd_images(wv[:, :hid], n=views_cols(hid))]
    return torch.cat(imgs), enc_at


def pack_train(mlp: NerfMLP):
    """Kernel weight list in the C entry's order: per layer (its encoding
    rows' part of the forward images, the hidden rows' backward images,
    bias; None where absent), then the forward images
    (:func:`forward_images`), wa, ba, the feature's backward images, bf, the
    views' hidden-row backward images, wvd, wva, bv, wr, br.  The
    backward's images are of the (out x in) rows.  wvd (the views layer's
    dirs rows), wva (its appearance rows, None without them) and wr are f32
    arrays of bf16-rounded values, (in x out).  The weights of ``mlp`` at
    its kernel width (:func:`pad_mlp_to_kernel_width`)."""
    mlp, _ = pad_mlp_to_kernel_width(mlp, "train")
    cfg = mlp.cfg
    enc, hid = cfg.xyz_dim, cfg.hid_dim
    app_at = hid + cfg.dirs_dim
    t = lambda w: w.detach().t().contiguous()
    wv = mlp.views_linears[0].weight.detach()
    wf = mlp.feature_linear.weight.detach()
    fwd, enc_at = forward_images(mlp)
    out = []
    for i, lin in enumerate(mlp.pts_linears):
        w = lin.weight.detach()
        w_hid = None if i == 0 else (w[:, enc:] if (i - 1) in cfg.skips else w)
        out += [fwd[enc_at[i]:] if i in enc_at else None,
                None if w_hid is None else slot_images(w_hid),
                lin.bias.detach().contiguous()]
    out += [fwd, mlp.alpha_linear.weight.detach().reshape(-1).contiguous(),
            mlp.alpha_linear.bias.detach().contiguous(), slot_images(wf),
            mlp.feature_linear.bias.detach().contiguous(),
            slot_images(wv[:, :hid]), _bf16(t(wv[:, hid:app_at])),
            _bf16(t(wv[:, app_at:])) if cfg.app_dim else None,
            mlp.views_linears[0].bias.detach().contiguous(),
            _bf16(t(mlp.rgb_linear.weight)).contiguous(),
            mlp.rgb_linear.bias.detach().contiguous()]
    return out


def check_encoding(cfg, num_freqs: int, dirs_freqs: int, who: str):
    """Raise for encodings the render kernels do not take: the JAX kernels'
    limits, 2 * 3 * F <= 128 and the view-direction PE plus the appearance
    row <= 128 (F <= 21; Fd <= 18 with an appearance table, 20 without),
    and a config whose widths are not those of its frequencies."""
    if cfg.xyz_dim != 6 * num_freqs or cfg.dirs_dim != 6 * dirs_freqs + 3:
        raise NotImplementedError(f"{who}: config {cfg} does not match "
                                  f"{num_freqs} / {dirs_freqs} frequencies")
    if cfg.xyz_dim > ENC_MAX or cfg.dirs_dim + cfg.app_dim > EXTRA_MAX:
        raise NotImplementedError(
            f"{who}: encoding of {cfg.xyz_dim} columns (<= {ENC_MAX}) and "
            f"view-direction rows of {cfg.dirs_dim} + {cfg.app_dim} (<= "
            f"{EXTRA_MAX}), as the JAX kernels")


def check_train_config(spec: StageSpec):
    """Raise for configs the train kernels do not implement (a width above
    1024: :func:`kernel_width`)."""
    cfg = spec.mlp.cfg
    if cfg.app_dim not in (0, APP_DIM):
        raise NotImplementedError(f"train kernel: appearance rows of "
                                  f"{cfg.app_dim} columns (it takes "
                                  f"{APP_DIM})")
    if not cfg.use_viewdirs:
        raise NotImplementedError(f"train kernel: config {cfg} not supported")
    check_encoding(cfg, spec.num_freqs, spec.dirs_freqs, "train kernel")
    kernel_width(cfg.hid_dim, "train")


@dataclasses.dataclass(frozen=True)
class BackwardLayout:
    """What ``nm_render_train_backward`` builds for one stage (csrc: Dims,
    VecLayout, the Stash and the ProdTable), for the callers that size its
    outputs or account for its traffic."""
    vec_len: int      # f32 vector gradients (biases, sigma head)
    products: tuple   # (M, N, rows) of each weight-gradient product, C order
    splits: int       # the GEMM's row ranges, summed in order
    stash: int        # bytes the training forward writes into the stash
    traffic: dict     # bytes each backward launch reads and writes


def _align256(n: int) -> int:
    return (n + 255) // 256 * 256


def extras_width(cfg) -> int:
    """A ray's stashed extras row: the viewdir PE padded to
    :func:`dirs_rows`, then the appearance row (csrc: Dims::ew)."""
    return dirs_rows(cfg.dirs_dim) + cfg.app_dim


def _stash_parts(cfg, n: int, S: int):
    """Bytes of each stash array (csrc: carve_stash, in its order); ``cfg``
    at its kernel width."""
    L, H, R = cfg.layer_num, cfg.hid_dim, n * S
    return [R * enc_rows(cfg.xyz_dim) * 2, *[R * H * 2] * L, R * H * 2,
            R * (H // 2) * 2, R * REC_WIDTH * 4, n * extras_width(cfg) * 2]


def _grad_parts(cfg, n: int, S: int, lay: BackwardLayout):
    """Bytes of each gradient-workspace array (csrc: carve_grad, in its
    order; the matrix partials are sized for the widest layer layout);
    ``cfg`` at its kernel width."""
    L, H, R = cfg.layer_num, cfg.hid_dim, n * S
    HV = H // 2
    mat_total = L * (enc_rows(cfg.xyz_dim) * H + H * H) + H * H + H * HV \
        + extras_width(cfg) * HV + HV * GRGB_WIDTH
    return [*[R * H * 2] * L, R * H * 2, R * HV * 2, R * GRGB_WIDTH * 2,
            n * HV * 2, (n // TILE_RAYS) * lay.vec_len * 4,
            lay.splits * mat_total * 4]


def workspace_bytes(cfg, n: int, S: int) -> tuple:
    """(stash bytes, gradient-workspace bytes) as
    ``nm_render_train_workspace`` returns them (each array 256-aligned), at
    the kernel width of ``cfg``."""
    cfg = kernel_cfg(cfg, "train")
    lay = backward_layout(cfg, n, S)
    return (sum(map(_align256, _stash_parts(cfg, n, S))),
            sum(map(_align256, _grad_parts(cfg, n, S, lay))))


def backward_layout(cfg, n: int, S: int) -> BackwardLayout:
    """The backward's layout for ``cfg`` at its kernel width."""
    cfg = kernel_cfg(cfg, "train")
    L, H = cfg.layer_num, cfg.hid_dim
    HV, R = H // 2, n * S
    prods = []
    for i in range(L):
        if _skip_in(cfg, i):
            prods.append((enc_rows(cfg.xyz_dim), H, R))
        if i > 0:
            prods.append((H, H, R))
    prods += [(H, H, R), (H, HV, R), (extras_width(cfg), HV, n),
              (HV, GRGB_WIDTH, R)]
    splits = min(MAX_SPLITS, max(1, R // 4096))
    part = 4 * sum(m * k for m, k, _ in prods)        # one f32 partial
    rec = 4 * REC_WIDTH
    traffic = {
        "trunk backward": R * (rec + 2 * HV + 2 * L * H)           # reads
        + R * 2 * (L * H + H + HV + GRGB_WIDTH),                   # writes
        "weight-gradient GEMM": sum(r * 2 * (m + k) for m, k, r in prods)
        + splits * part,
        "reductions": splits * part + part}
    return BackwardLayout(L * H + H + HV + 4 + H + 4, tuple(prods), splits,
                          sum(_stash_parts(cfg, n, S)), traffic)


def _ptrs(*tensors):
    vals = [None if p is None else p.data_ptr() for p in tensors]
    return (ctypes.c_void_p * len(vals))(*vals)


def _check_app(cfg, app, n: int):
    """An appearance MLP takes ``app`` (N, 16) f32, and only it."""
    if bool(cfg.app_dim) != (app is not None):
        raise ValueError("render_train: an appearance MLP takes app "
                         f"(N, {APP_DIM}), and only it")
    if app is not None and (app.dtype != torch.float32
                            or app.shape != (n, APP_DIM)):
        raise ValueError(f"render_train: app ({n}, {APP_DIM}) f32, got "
                         f"{tuple(app.shape)} {app.dtype}")


def _kernel_args(spec: StageSpec, rays, z, noise, packed, app=None):
    check_train_config(spec)
    n, S = z.shape[0], z.shape[1] - 1
    if any(t.dtype != torch.float32 for t in (rays, z, noise)) \
            or rays.shape != (n, 12) or noise.shape != (n, S):
        raise ValueError("render_train: rays (N, 12), z (N, S+1), noise "
                         "(N, S), all f32")
    _check_app(spec.mlp.cfg, app, n)
    if n % TILE_RAYS or S not in KERNEL_SAMPLES:
        raise NotImplementedError(
            f"train kernel needs N % {TILE_RAYS} == 0 and S in "
            f"{KERNEL_SAMPLES} (N={n}, S={S})")
    require_cuda_tensors("render_train", rays, z, noise,
                         *[p for p in (*packed, app) if p is not None])
    cfg = spec.mlp.cfg
    return (_ptrs(*packed, rays, z, noise, app), n,
            kernel_width(cfg.hid_dim, "train"),
            cfg.layer_num, spec.num_freqs, spec.dirs_freqs, S,
            spec.var_scale, int(spec.white_bg))


def _sizes(cfg, n: int, S: int):
    """(stash bytes, gradient-workspace bytes, matrix-block floats) from the
    C side, at the kernel width of ``cfg``."""
    out = [ctypes.c_longlong(0) for _ in range(3)]
    check(library().nm_render_train_workspace(
        n, kernel_width(cfg.hid_dim, "train"), cfg.layer_num, S, cfg.xyz_dim // 6,
        (cfg.dirs_dim - 3) // 6, cfg.app_dim,
        *map(ctypes.addressof, out)), "render_train_workspace")
    return tuple(v.value for v in out)


def _scratch(cfg, n: int, dev):
    """The tile engine's scratch for a stage of ``n`` rays at the kernel
    width of ``cfg`` on ``dev`` (current): (uint8 tensor or None, bytes)."""
    size = library().nm_render_train_scratch(kernel_width(cfg.hid_dim, "train"),
                                             n)
    check(min(size, 0), "render_train scratch")
    return (torch.empty(size, dtype=torch.uint8, device=dev) if size
            else None), size


def kernel_forward(spec: StageSpec, rays, z, noise, packed,
                   stash: bool = False, app=None):
    """Kernel forward -> (rgb, weights, stash).  With ``stash`` it is the
    training forward: it also fills and returns the stash (uint8, the
    activations :func:`kernel_backward` reads); else the stash is None and
    nothing beyond the outputs is allocated.  ``app``: the rays'
    appearance rows, for an appearance MLP.  ``packed``:
    :func:`pack_train` of the stage's MLP (at its kernel width)."""
    args = _kernel_args(spec, rays, z, noise, packed, app)
    n, S = z.shape[0], z.shape[1] - 1
    rgb = torch.empty(n, 3, device=rays.device)
    w = torch.empty(n, S, device=rays.device)
    st = None
    if stash:
        st = torch.empty(_sizes(spec.mlp.cfg, n, S)[0], dtype=torch.uint8,
                         device=rays.device)
    with torch.cuda.device(rays.device):
        scratch, size = _scratch(spec.mlp.cfg, n, rays.device)
        err = library().nm_render_train_forward(
            *args, rgb.data_ptr(), w.data_ptr(),
            None if st is None else st.data_ptr(),
            None if scratch is None else scratch.data_ptr(), size,
            stream_ptr(rays.device))
    check(err, "render_train_fwd")
    LAUNCHES["render_train_fwd" + ("" if app is None else "_app")] += 1
    return rgb, w, st


def kernel_backward(spec: StageSpec, stash, rays, z, noise, g_rgb, g_w,
                    packed, app=None):
    """Kernel gradients on the stash of the training forward of the same
    inputs -> {parameter name: gradient}, each in its parameter's shape
    (an MLP run at a wider kernel width gets its padded gradients sliced
    back), and ``"app"``: ``g_app`` (N, 16) for an appearance MLP."""
    args = _kernel_args(spec, rays, z, noise, packed, app)
    cfg = kernel_cfg(spec.mlp.cfg, "train")
    n, S = z.shape[0], z.shape[1] - 1
    L, hid, enc = cfg.layer_num, cfg.hid_dim, cfg.xyz_dim
    hv, dirs = hid // 2, cfg.dirs_dim
    g_rgb, g_w = g_rgb.contiguous(), g_w.contiguous()
    require_cuda_tensors("render_train", rays, g_rgb, g_w, stash)
    n_stash, n_grad, n_mat = _sizes(cfg, n, S)
    if stash.dtype != torch.uint8 or stash.numel() != n_stash:
        raise ValueError(f"render_train: the stash must be the {n_stash} "
                         f"bytes kernel_forward(..., stash=True) returned")
    dev = rays.device
    work = torch.empty(n_grad, dtype=torch.uint8, device=dev)
    mat = torch.empty(n_mat, device=dev)
    vec = torch.empty(backward_layout(cfg, n, S).vec_len, device=dev)
    g_app = None if app is None else torch.empty(n, APP_DIM, device=dev)
    with torch.cuda.device(dev):
        scratch, size = _scratch(cfg, n, dev)
        err = library().nm_render_train_backward(
            *args, g_rgb.data_ptr(), g_w.data_ptr(), stash.data_ptr(),
            work.data_ptr(), mat.data_ptr(), vec.data_ptr(),
            None if g_app is None else g_app.data_ptr(),
            None if scratch is None else scratch.data_ptr(), size,
            stream_ptr(dev))
    check(err, "render_train_bwd")
    LAUNCHES["render_train_bwd" + ("" if app is None else "_app")] += 1
    del work, scratch
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
            parts.append(block(enc_rows(enc), hid)[:enc])
        if i > 0:
            parts.append(block(hid, hid))
        g[f"pts_linears.{i}.weight"] = torch.cat(parts).t()
        g[f"pts_linears.{i}.bias"] = vec[i * hid:(i + 1) * hid]
    g["feature_linear.weight"] = block(hid, hid).t()
    w_h = block(hid, hv)
    w_x = block(extras_width(cfg), hv)      # dirs rows, padding, app rows
    g["views_linears.0.weight"] = torch.cat(
        [w_h, w_x[:dirs], w_x[dirs_rows(dirs):]]).t()
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
    if g_app is not None:
        g["app"] = g_app
    return unpad_grads(g, spec.mlp)


# ---------------------------------------------------------------------------
# Autograd binding and entry points
# ---------------------------------------------------------------------------

class _RenderTrainFn(torch.autograd.Function):
    # Inputs: spec, use_kernel, grad, rays, z, noise, app, *params; the
    # gradients go to app (index 6) and the parameters (7 on).
    @staticmethod
    def forward(ctx, spec, use_kernel, grad, rays, z, noise, app, *params):
        packed = pack_train(spec.mlp) if use_kernel else None
        ctx.stash = None
        if use_kernel:
            # The training forward keeps its activations for the backward
            # (the stash); a forward that needs no gradient allocates none.
            rgb, w, ctx.stash = kernel_forward(spec, rays, z, noise, packed,
                                               stash=grad, app=app)
        else:
            with torch.no_grad():
                rgb, w = train_stage_forward(spec, rays, z, noise, app=app)
        ctx.spec, ctx.use_kernel, ctx.packed = spec, use_kernel, packed
        ctx.save_for_backward(rays, z, noise, app)
        return rgb, w

    @staticmethod
    def backward(ctx, g_rgb, g_w):
        rays, z, noise, app = ctx.saved_tensors
        spec = ctx.spec
        if not any(ctx.needs_input_grad[6:]):
            # Only rays, z or noise asked for a gradient, and the stage gives
            # none to them: the forward kept no stash for this.
            return (None,) * len(ctx.needs_input_grad)
        g_rgb = torch.zeros(rays.shape[0], 3, device=rays.device) \
            if g_rgb is None else g_rgb
        g_w = torch.zeros_like(noise) if g_w is None else g_w
        if ctx.use_kernel:
            if ctx.stash is None:
                raise RuntimeError(
                    "render_train: the stash of this forward was freed by an "
                    "earlier backward (the kernels do not recompute the "
                    "forward); run the forward again")
            stash, ctx.stash = ctx.stash, None
            g = kernel_backward(spec, stash, rays, z, noise, g_rgb, g_w,
                                ctx.packed, app)
            del stash
            _release_if_huge(spec.mlp.cfg, z.shape[0], z.shape[1] - 1,
                             rays.device)
        else:
            g = train_stage_backward(spec, rays, z, noise, g_rgb, g_w,
                                     app=app)
        names = [k for k, _ in spec.mlp.named_parameters()]
        return (None,) * 6 + (g.get("app"),) + tuple(g[k] for k in names)


def _release_if_huge(cfg, n: int, S: int, dev):
    """Hand a stage's freed stash and gradient workspace back to CUDA when
    together they take more than a third of the card (hid 1024 at 9216
    rays x 128 samples: 45 GiB of 79).  Left in PyTorch's cache, their
    segments are cut up by the step's smaller tensors (the gradients, the
    optimizer's state), and the next step's two stashes and workspace no
    longer fit beside the pieces."""
    stash, grad = workspace_bytes(cfg, n, S)
    if 3 * (stash + grad) > torch.cuda.get_device_properties(dev).total_memory:
        torch.cuda.empty_cache()


def _apply(spec, use_kernel, rays, z, noise, app):
    params = list(spec.mlp.parameters())
    grad = torch.is_grad_enabled() and (
        any(p.requires_grad for p in params)
        or (app is not None and app.requires_grad))
    return _RenderTrainFn.apply(spec, use_kernel, grad, rays, z, noise, app,
                                *params)


def render_train_plain(spec: StageSpec, rays, z, noise, app=None):
    """Plain train stage (bf16 operand roundings) with the explicit
    backward -> (rgb (N, 3), weights (N, S)); ``app`` (N, 16): the rays'
    appearance rows of an appearance MLP, differentiable."""
    _check_app(spec.mlp.cfg, app, rays.shape[0])
    return _apply(spec, False, rays, z, noise, app)


def render_train(spec: StageSpec, rays, z, noise, app=None):
    """Train stage: the CUDA kernels for CUDA tensors (or an error), the
    plain version for CPU tensors -> (rgb (N, 3), weights (N, S)).
    ``app`` (N, 16): the rays' appearance rows, which an appearance MLP
    takes and which get their gradient (``g_app``) from the backward."""
    if rays.device.type != "cuda":
        return render_train_plain(spec, rays, z, noise, app)
    check_train_config(spec)
    return _apply(spec, True, rays.contiguous(), z.contiguous(),
                  noise.contiguous(), None if app is None else app.contiguous())
