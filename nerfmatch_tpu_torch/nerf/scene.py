"""Ray / unit-sphere intersection (counterpart of ``nerfmatch_tpu/nerf/scene.py:
rays_intersect_sphere``)."""

from __future__ import annotations

import torch


def rays_intersect_sphere(rays_o, rays_d, r: float = 1.0):
    """Forward intersection distance t with ``||o + t d|| = r``; nan where the
    ray misses the sphere or the sphere lies behind it."""
    odotd = torch.sum(rays_o * rays_d, dim=-1)
    d_norm_sq = torch.sum(rays_d**2, dim=-1)
    o_norm_sq = torch.sum(rays_o**2, dim=-1)
    det = odotd**2 + (r**2 - o_norm_sq) * d_norm_sq
    det_safe = torch.where(det >= 0, det, torch.ones_like(det))
    t = (torch.sqrt(det_safe) - odotd) / d_norm_sq
    return torch.where((det >= 0) & (t > 0), t, torch.full_like(t, float("nan")))
