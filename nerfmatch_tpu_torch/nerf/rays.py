"""Ray generation and the 12-column ray packing
``[o(3), d(3), near, far, viewdir(3), radii(1)]`` (counterpart of
``nerfmatch_tpu/nerf/rays.py``).  The matrix products must run in full f32
(callers keep TF32 off)."""

from __future__ import annotations

import math

import torch

from .scene import rays_intersect_sphere

RAY_NEAR = 6
RAY_FAR = 7
RAY_VIEWDIR = slice(8, 11)
RAY_RADII = 11


def get_ray_dirs(H: int, W: int, K, flipped_yz: bool = False):
    """Per-pixel ray directions in camera coords from intrinsics K: (H, W, 3);
    ``flipped_yz``: y and z negated (OpenGL camera axes)."""
    K = torch.as_tensor(K, dtype=torch.float32)
    ys, xs = torch.meshgrid(torch.arange(H, device=K.device),
                            torch.arange(W, device=K.device), indexing="ij")
    xys = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1).to(torch.float32)
    dirs = xys @ torch.linalg.inv(K).T
    if flipped_yz:
        dirs = dirs * torch.tensor([1.0, -1.0, -1.0], device=K.device)
    return dirs


def get_rays_c2w(dirs, c2w):
    """Rotate camera-frame dirs into the world frame -> (o, d, unit viewdirs)."""
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    return rays_o, rays_d, viewdirs


def prepare_rays_data(rays_o, rays_d, viewdirs, near, far):
    """Pack an (H, W, .) ray grid as ``[o, d, near, far, viewdir, radii]``;
    ``near`` / ``far``: (H, W, 1) tensors or scalars; the mip cone radius
    comes from the distance between vertically neighbouring pixel
    directions, scaled by 2/sqrt(12)."""
    near, far = (v if torch.is_tensor(v)
                 else torch.full_like(rays_d[..., :1], v) for v in (near, far))
    dx = torch.sqrt(torch.sum((rays_d[:-1] - rays_d[1:]) ** 2, -1))
    dx = torch.cat([dx, dx[-2:-1]], dim=0)
    radii = dx[..., None] * 2.0 / math.sqrt(12.0)
    return torch.cat([rays_o, rays_d, near, far, viewdirs, radii], dim=-1)


def sample_nerf_rays(H: int, W: int, K, c2w, ds: int = 8):
    """Rays at the centers of a ds-strided pixel grid with a dynamic far plane
    at the unit sphere (far=1 where the solve fails) -> (n, 12)."""
    c2w = torch.as_tensor(c2w, dtype=torch.float32)
    directions = get_ray_dirs(H, W, torch.as_tensor(K, dtype=torch.float32,
                                                    device=c2w.device))
    rays_o, _, viewdirs = get_rays_c2w(directions, c2w)
    far = rays_intersect_sphere(rays_o.reshape(-1, 3), viewdirs.reshape(-1, 3))
    far = torch.where(torch.isfinite(far), far, torch.ones_like(far))
    far = far.reshape(H, W, 1)
    near = torch.full_like(far, 0.01)
    rays = prepare_rays_data(rays_o, viewdirs, viewdirs, near, far)
    rays = rays[ds // 2::ds, ds // 2::ds]
    return rays.reshape(-1, rays.shape[-1]).contiguous()
