"""Static int8 quantization of the render trunk (counterpart of
``nerfmatch_tpu/ops/pallas/quant.py``): the serving default's coarse stage
(``trunk_int8='coarse'``) and the opt-in ``'both'`` / ``'posttap'`` modes.

* weights: per-output-column symmetric int8, with the static per-channel
  input-activation scales folded into the weight before quantization;
* activations: calibrated once per scene (per-channel abs-max over a ray
  batch, :func:`calibrate_act_scales`), so the trunk runs in the quantized
  domain: layer ``i``'s epilogue ``y = acc * c_i (+ acc_s * c_i_s) + B_i``
  dequantizes, applies the ReLU (``max(y, 0.5)``) and requantizes for layer
  ``i + 1`` in one scale row; the ``+0.5`` folded into ``B_i`` makes the
  truncating float -> int cast round to nearest;
* real units come back only at the descriptor tap (``(y - 0.5) * iq_i``)
  and the last layer (``relu(acc * s_L (+ acc_s * s_L_s) + b_L)``); the
  heads stay as in the bf16 render;
* ``int8_from > 0`` ("posttap") keeps the layers below it on bf16 operands
  and enters the quantized domain with one requant row ``qh``.

:func:`pack_mlp_int8` returns the rows and int8 weights under the JAX
packing's names (``qenc``, ``qh``, ``w{i}q``, ``w{i}sq``, ``c{i}``,
``c{i}s``, ``B{i}``, ``s{L}``, ``s{L}s``, ``b{L}``, ``iq{i}``), and under
``img`` the int8 weights as the ring's slot images of the render kernel
(``csrc/render_eval.cuh``, :func:`slot_images_s8`).  The encoding rows are
padded to ``render_train_kernel.enc_rows`` (the 90 of 15 frequencies to 96,
three 32-deep k steps, the widest to 128; the s8 images to whole 64-row
slots); the JAX packing pads them to 128.  :func:`pack_kernel_int8` packs
the trunk of an MLP at the render kernel's width (its padded columns at
unit activation scale).  The tile engine (``csrc/render_eval_512.cuh``,
HID 512 and 1024) feeds its s8 products from a K-major tile in shared
memory, so its images keep their K rows in order
(:func:`s8_rows_permuted`).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ...nerf.compositing import volume_render
from ...nerf.embedding import ipe_embedding
from ...nerf.sampling import sample_along_rays
from .render_train_kernel import (REGISTER_A_MAX, enc_rows,
                                  pad_mlp_to_kernel_width)

_EPS = 1e-6
S8_SLOT_ROWS = 64   # csrc: kSliceK8 (s8 weight rows a ring slot)
# The K order of an s8 image fed from an accumulator: position k of each
# 32-row block holds row PERM32[k].  A thread's s32 accumulator holds
# columns 8 j + 2 q (+ 1) (q = lane % 4) of a 32-column block, its s8 A
# fragment takes columns 4 q .. 4 q + 3 and 16 + 4 q .. + 3: with the rows
# in this order the epilogue packs its own bytes (csrc/render_eval.cu:
# put_s8).
PERM32 = torch.tensor([16 * hi + 8 * (r // 2) + 2 * q + r % 2
                       for hi in (0, 1) for q in range(4) for r in range(4)])


def s8_rows_permuted(hid: int) -> bool:
    """Whether the s8 images of an int8 trunk of width ``hid`` fed from a
    layer's output hold their K rows in :data:`PERM32` order: at the widths
    of ``csrc/render_eval.cuh`` (A from the accumulator's registers), not at
    512 and 1024 (``render_eval_512.cuh``: A from a K-major tile in shared
    memory, its rows in order)."""
    return hid <= REGISTER_A_MAX


def colq(w_eff):
    """Per-output-column symmetric int8 quantization of an (in, out) f32
    matrix -> (int8 weight, (1, out) f32 dequant row)."""
    sw = w_eff.abs().amax(dim=0, keepdim=True) / 127.0 + 1e-12
    return torch.round(w_eff / sw).to(torch.int8), sw


def slot_images_s8(w, permute: bool):
    """A (K, N) int8 ``in x out`` weight -> the render kernel's s8 ring-slot
    images, flat int8: K zero-padded to a multiple of 64, its rows in the
    order :data:`PERM32` gives each 32-row block where ``permute`` (the rows
    fed from an accumulator), then per 64-row slot the N columns K-major,
    64 bytes each, the 16-byte chunk c of column n stored at chunk
    c ^ ((n // 2) % 4) (the 64-byte swizzle their wgmma descriptors read).
    One bulk copy fills a slot."""
    K, N = w.shape
    w = F.pad(w.to(torch.int8), (0, 0, 0, (-K) % S8_SLOT_ROWS))
    if permute:   # row 16 hi + 8 r1 + 2 q + r0 to position 16 hi + 4 q + 2 r1 + r0
        w = w.reshape(-1, 2, 2, 4, 2, N).permute(0, 1, 3, 2, 4, 5).reshape(-1, N)
    x = w.reshape(-1, S8_SLOT_ROWS, N).transpose(1, 2).reshape(-1, N, 4, 16)
    n = torch.arange(N, device=w.device).view(N, 1)
    src = torch.arange(4, device=w.device).view(1, 4) ^ (n // 2 % 4)
    idx = src.view(1, N, 4, 1).expand(x.shape)
    return torch.gather(x, 2, idx).reshape(-1)


def _pad_rows(w, rows):
    return F.pad(w, (0, 0, 0, rows - w.shape[0]))


def pack_mlp_int8(mlp, scales, int8_from: int = 0, tap: int | None = None):
    """NeRF MLP + one stage's activation scales -> the int8 trunk.

    ``scales``: ``{"enc": (enc_dim,), "acts": [(hid,)] * (>= layer_num -
    1)}`` from :func:`calibrate_act_scales`.  Layers from ``int8_from`` on
    are quantized; ``tap``: the descriptor-tap layer (fine stage) or None.
    The math is ``pack_mlp_weights_int8``'s: the ``_EPS`` floor, scale 1 on
    the padded encoding lanes.  ``img``: the int8 layers' slot images
    (:func:`slot_images_s8`, the hidden rows permuted where
    :func:`s8_rows_permuted`), for the render kernel."""
    cfg = mlp.cfg
    L, last, hid, E = cfg.layer_num, cfg.layer_num - 1, cfg.hid_dim, cfg.xyz_dim
    if not 0 <= int8_from <= last:
        raise ValueError(f"int8_from={int8_from} outside [0, {last}]")
    dev = mlp.pts_linears[0].weight.device
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    enc_s = torch.clamp(f32(scales["enc"]), min=_EPS)
    if enc_s.shape != (E,):
        raise ValueError(f"encoding scales {tuple(enc_s.shape)} != ({E},)")
    acts = [torch.clamp(f32(a), min=_EPS) for a in scales["acts"]]
    if len(acts) < L - 1:
        raise ValueError(f"{len(acts)} activation scales for {L} layers")
    q_rows = [(127.0 / a)[None, :] for a in acts]
    iq_rows = [(a / 127.0)[None, :] for a in acts]
    enc_pad = torch.cat([enc_s, torch.ones(enc_rows(E) - E, device=dev)])

    out = {"start": int8_from, "tap": tap, "qenc": (127.0 / enc_pad)[None, :]}
    if int8_from > 0:
        out["qh"] = q_rows[int8_from - 1]
        if tap is not None and tap >= int8_from:
            raise ValueError(f"posttap boundary {int8_from} at or below the "
                             f"tap layer {tap}")
    for i in range(int8_from, L):
        lin = mlp.pts_linears[i]
        wi = lin.weight.detach().t().float()           # (in, out)
        parts = {}
        if i > 0 and i - 1 in cfg.skips:               # [enc | hid] rows
            qs, sws = colq(wi[:E] * (enc_s / 127.0)[:, None])
            parts["s"] = (_pad_rows(qs, enc_rows(E)), sws)
            parts[""] = colq(wi[E:] * (acts[i - 1] / 127.0)[:, None])
        else:
            a_in = enc_s if i == 0 else acts[i - 1]
            q, sw = colq(wi * (a_in / 127.0)[:, None])
            parts[""] = (_pad_rows(q, enc_rows(E)) if i == 0 else q, sw)
        for suf, (q, sw) in parts.items():
            out[f"w{i}{suf}q"] = q
            if i == last:
                out[f"s{i}{suf}"] = sw
            else:
                out[f"c{i}{suf}"] = sw * q_rows[i]
        bias = lin.bias.detach().float()[None, :]
        if i < last:
            out[f"B{i}"] = bias * q_rows[i] + 0.5
        else:
            out[f"b{i}"] = bias
        if tap is not None and tap == i and i < last:
            out[f"iq{i}"] = iq_rows[i]
    # The s8 layers' images in the order the ring streams them: per layer
    # its hidden rows (permuted where the kernel takes A from registers),
    # then its encoding rows.
    perm = s8_rows_permuted(hid)
    out["img"] = torch.cat([
        slot_images_s8(out[k], permute=perm and i > 0 and k == f"w{i}q")
        for i in range(int8_from, L) for k in (f"w{i}q", f"w{i}sq") if k in out])
    return out


def pad_act_scales(scales, width: int):
    """One stage's activation scales (:func:`calibrate_act_scales`) with
    each layer's row padded to ``width`` columns at scale 1: a padded
    hidden unit is always 0, so its calibrated range would be 0; the unit
    scale keeps its requant rows finite and moves no real column."""
    def pad(a):
        a = torch.as_tensor(a, dtype=torch.float32)
        return torch.cat([a, a.new_ones(width - a.numel())])
    return {"enc": scales["enc"], "acts": [pad(a) for a in scales["acts"]]}


def pack_kernel_int8(mlp, scales, int8_from: int = 0, tap: int | None = None):
    """:func:`pack_mlp_int8` of ``mlp`` at the render kernel's width
    (``render_train_kernel.pad_mlp_to_kernel_width``, the scales by
    :func:`pad_act_scales`): the trunk ``render_kernel.render_stage`` takes
    on CUDA.  Its real columns are those of ``pack_mlp_int8(mlp, scales,
    ...)``; at an instantiated width it is that pack.  ``mlp`` may be the
    padded MLP itself, with the real width's scales (``render_kernel.
    pack_stage`` pads once and hands the padded MLP to both packers)."""
    kmlp, _ = pad_mlp_to_kernel_width(mlp, "eval")
    width = kmlp.cfg.hid_dim
    if any(len(a) != width for a in scales["acts"]):
        scales = pad_act_scales(scales, width)
    return pack_mlp_int8(kmlp, scales, int8_from, tap)


@contextlib.contextmanager
def _full_f32():
    """Matrix products in full f32 (no TF32), as ``Precision.HIGHEST``."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _trunk_acts(mlp, enc):
    """Per-channel post-ReLU abs-max of every trunk layer, and sigma."""
    h, acts = enc, []
    for i, lin in enumerate(mlp.pts_linears):
        h = torch.relu(F.linear(h, lin.weight, lin.bias))
        acts.append(torch.clamp(h.abs().amax(dim=0), min=_EPS))
        if i in mlp.cfg.skips:
            h = torch.cat([enc, h], dim=-1)
    sigma = F.linear(h, mlp.alpha_linear.weight, mlp.alpha_linear.bias)
    return acts, sigma


@torch.no_grad()
def calibrate_act_scales(renderer, rays):
    """Per-channel activation abs-max of both trunks on a calibration ray
    batch (N, 12), through the plain f32 render.

    The rays take the unit-direction parameterization the kernels march;
    the fine stage samples from the f32 coarse weights.  Returns
    ``{"coarse" | "fine": {"enc": (E,), "acts": [(hid,)] * layer_num}}``."""
    from ...nerf.renderer import reparam_unit_dir

    cfg = renderer.cfg
    rays = reparam_unit_dir(rays.float())[0]
    (_, cmlp), (_, fmlp) = renderer._stages()
    out = {}
    with _full_f32():
        (mean, var), z = sample_along_rays(
            rays, num_pts=cmlp.cfg.num_pts, model_type="coarse",
            scale_var=cfg.mip_var_scale)
        enc = ipe_embedding(mean, var, cfg.xyz_num_freqs)[0]
        R, S = enc.shape[:2]
        enc = enc.reshape(R * S, -1)
        acts, sigma = _trunk_acts(cmlp, enc)
        out["coarse"] = {"enc": torch.clamp(enc.abs().amax(dim=0), min=_EPS),
                         "acts": acts}
        field = torch.cat([torch.zeros(R, S, 3, device=rays.device),
                           sigma.reshape(R, S, 1)], dim=-1)
        weights = volume_render(field, z, rays[:, 3:6],
                                white_bg=cfg.white_bg)["weights"]
        (mean, var), _ = sample_along_rays(
            rays, num_pts=fmlp.cfg.num_pts, z_vals=z, weights=weights,
            model_type="fine", scale_var=cfg.mip_var_scale)
        enc = ipe_embedding(mean, var, cfg.xyz_num_freqs)[0]
        enc = enc.reshape(-1, enc.shape[-1])
        out["fine"] = {"enc": torch.clamp(enc.abs().amax(dim=0), min=_EPS),
                       "acts": _trunk_acts(fmlp, enc)[0]}
    return out
