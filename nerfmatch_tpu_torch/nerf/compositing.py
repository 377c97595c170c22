"""Volume rendering (counterpart of ``nerfmatch_tpu/nerf/compositing.py``):
alpha compositing with the tf-style exclusive transmittance cumprod (mip
fenceposts or classic sample depths), the training density noise, the
scene-coordinate channels composited on detached weights, feature
compositing, the t <-> s reparameterization of the distortion loss, and the
mip-NeRF 360 scene contraction."""

from __future__ import annotations

import torch


def volume_render(radiance_field, z_vals, rays_d, white_bg: bool = True,
                  input_dim: int = 4, noise=None, mip: bool = True,
                  out_last: bool = False):
    """Alpha-composite (R, S, C) radiance (rgb, raw density at
    ``input_dim - 1``, extra channels after it) over mip fenceposts
    (R, S+1), or (``mip=False``) over classic sample depths (R, S), whose
    last interval is 1e10 long.  ``noise`` (R, S): training density noise,
    added before the ReLU (``compositing.py:29-32``; the caller scales it
    by ``noise_std``).  ``out_last``: also ``last``, the extra channels
    composited with the weights detached."""
    rgb = radiance_field[..., : input_dim - 1]
    raw_density = radiance_field[..., input_dim - 1]
    if noise is not None:
        raw_density = raw_density + noise
    density = torch.relu(raw_density)
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    if mip:
        z_mids = 0.5 * (z_vals[..., :-1] + z_vals[..., 1:])
    else:
        dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)],
                          dim=-1)
        z_mids = z_vals
    dists = dists * torch.linalg.norm(rays_d, dim=-1)[..., None]
    alpha = 1.0 - torch.exp(-density * dists)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10],
                  dim=-1), dim=-1)[..., :-1]
    weights = alpha * trans
    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_mids, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    disp_map = 1.0 / torch.clamp(depth_map / torch.clamp(acc_map, min=1e-10),
                                 min=1e-10)
    if white_bg:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    out = dict(rgb=rgb_map, disp=disp_map, acc=acc_map, weights=weights,
               depth=depth_map)
    if out_last:
        out["last"] = torch.sum(weights.detach()[..., None]
                                * radiance_field[..., input_dim:], dim=-2)
    return out


def composite_features(weights, feats, comb: str = "lin"):
    """'lin': weighted sum along the ray; 'max': the argmax-weight sample."""
    if comb == "max":
        idx = torch.argmax(weights, dim=-1)
        return torch.take_along_dim(
            feats, idx[..., None, None].expand(*idx.shape, 1, feats.shape[-1]),
            dim=-2)[..., 0, :]
    return torch.sum(weights[..., None] * feats, dim=-2)


def _g(x, eps: float = 1e-6):
    return 1.0 / (x + eps)


def t_to_s(t_vals, near, far):
    """Distance t -> normalized inverse-depth s (mip-NeRF 360)."""
    return (_g(t_vals) - _g(near)) / (_g(far) - _g(near))


def s_to_t(s_vals, near, far):
    return _g(s_vals * _g(far) + (1.0 - s_vals) * _g(near))


def contract(x):
    """mip-NeRF 360 scene contraction (eq. 10 of arXiv:2111.12077)."""
    x_mag_sq = torch.clamp(torch.sum(x**2, dim=-1, keepdim=True), min=1e-10)
    return torch.where(x_mag_sq <= 1.0, x,
                       ((2.0 * torch.sqrt(x_mag_sq) - 1.0) / x_mag_sq) * x)
