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
``frag`` the int8 weights as ``mma.m16n8k32`` B fragments for
``csrc/render.cu``.  The 90 encoding rows are padded to 96 (a multiple of
the 32-deep k step); the JAX packing pads them to 128.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ...nerf.compositing import volume_render
from ...nerf.embedding import ipe_embedding
from ...nerf.sampling import sample_along_rays

_EPS = 1e-6
ENC_PAD = 96        # encoding rows, padded to the k step of mma.m16n8k32


def colq(w_eff):
    """Per-output-column symmetric int8 quantization of an (in, out) f32
    matrix -> (int8 weight, (1, out) f32 dequant row)."""
    sw = w_eff.abs().amax(dim=0, keepdim=True) / 127.0 + 1e-12
    return torch.round(w_eff / sw).to(torch.int8), sw


def pack_fragments_s8(w):
    """(K, N) int8 ``in x out`` weight -> s8 mma.m16n8k32 B fragments.

    K is zero-padded to a multiple of 32.  Returns an int32 tensor of shape
    (K/32, N/8, 32, 2): entry [ks, nt, lane, r] holds the four int8
    ``w[k .. k + 3, n]`` (lowest byte first) with
    ``k = 32 ks + 16 r + 4 (lane % 4)`` and ``n = 8 nt + lane // 4``.
    """
    K, N = w.shape
    w = F.pad(w.to(torch.int8), (0, 0, 0, (-K) % 32))
    # k = 32 ks + 16 r + 4 lq + b,  n = 8 nt + ln,  lane = 4 ln + lq
    w = w.reshape(-1, 2, 4, 4, N // 8, 8)           # ks, r, lq, b, nt, ln
    w = w.permute(0, 4, 5, 2, 1, 3).contiguous()    # ks, nt, ln, lq, r, b
    return w.view(torch.int32).reshape(-1, N // 8, 32, 2)


def unpack_fragments_s8(frag, K: int):
    """Inverse of :func:`pack_fragments_s8` -> the (K, N) int8 weight."""
    ks, nt = frag.shape[:2]
    w = frag.contiguous().view(torch.int8).reshape(ks, nt, 8, 4, 2, 4)
    w = w.permute(0, 4, 3, 5, 1, 2)                 # ks, r, lq, b, nt, ln
    return w.reshape(ks * 32, nt * 8)[:K]


def _pad_rows(w, rows):
    return F.pad(w, (0, 0, 0, rows - w.shape[0]))


def pack_mlp_int8(mlp, scales, int8_from: int = 0, tap: int | None = None):
    """NeRF MLP + one stage's activation scales -> the int8 trunk.

    ``scales``: ``{"enc": (enc_dim,), "acts": [(hid,)] * (>= layer_num -
    1)}`` from :func:`calibrate_act_scales`.  Layers from ``int8_from`` on
    are quantized; ``tap``: the descriptor-tap layer (fine stage) or None.
    The math is ``pack_mlp_weights_int8``'s: the ``_EPS`` floor, scale 1 on
    the padded encoding lanes."""
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
    enc_pad = torch.cat([enc_s, torch.ones(ENC_PAD - E, device=dev)])

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
            parts["s"] = (_pad_rows(qs, ENC_PAD), sws)
            parts[""] = colq(wi[E:] * (acts[i - 1] / 127.0)[:, None])
        else:
            a_in = enc_s if i == 0 else acts[i - 1]
            q, sw = colq(wi * (a_in / 127.0)[:, None])
            parts[""] = (_pad_rows(q, ENC_PAD) if i == 0 else q, sw)
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
    out["frag"] = {k: pack_fragments_s8(v) for k, v in out.items()
                   if k.startswith("w")}
    return out


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
