"""Volume rendering, eval half (counterpart of
``nerfmatch_tpu/nerf/compositing.py``): alpha compositing with the
tf-style exclusive transmittance cumprod, and feature compositing."""

from __future__ import annotations

import torch


def volume_render(radiance_field, z_vals, rays_d, white_bg: bool = True,
                  input_dim: int = 4):
    """Alpha-composite (R, S, C) radiance over mip fenceposts (R, S+1)."""
    rgb = radiance_field[..., : input_dim - 1]
    density = torch.relu(radiance_field[..., input_dim - 1])
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    z_mids = 0.5 * (z_vals[..., :-1] + z_vals[..., 1:])
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
    return dict(rgb=rgb_map, disp=disp_map, acc=acc_map, weights=weights,
                depth=depth_map)


def composite_features(weights, feats, comb: str = "lin"):
    """'lin': weighted sum along the ray; 'max': the argmax-weight sample."""
    if comb == "max":
        idx = torch.argmax(weights, dim=-1)
        return torch.take_along_dim(
            feats, idx[..., None, None].expand(*idx.shape, 1, feats.shape[-1]),
            dim=-2)[..., 0, :]
    return torch.sum(weights[..., None] * feats, dim=-2)
