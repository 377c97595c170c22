"""Scene normalization and ray / unit-sphere intersection (counterpart of
``nerfmatch_tpu/nerf/scene.py``): the frustum-union bounding sphere and the
json-driven "fst" world -> unit-sphere similarity in numpy (host-side
setup), the intersection in torch."""

from __future__ import annotations

import json

import numpy as np
import torch

# Homogeneous (h, w, depth)-fraction image-corner skeleton: camera center plus
# the four far-plane corners of the image frustum.
_CORNERS_HWD = np.array(
    [[0, 0, 0], [0, 0, 1], [0, 1, 1], [1, 0, 1], [1, 1, 1]], dtype=np.float64)


def frustum_bounding_sphere(HWs, Ks, cam2worlds, max_depth):
    """(center (3,), radius) bounding the union of camera frustums cut at
    ``max_depth`` (the 'sphere' bounds of ``frustum_world_bounds``)."""
    HWs = np.asarray(HWs, dtype=np.float64)
    Ks = np.asarray(Ks, dtype=np.float64)
    c2ws = np.asarray(cam2worlds, dtype=np.float64)
    n, k = len(HWs), len(_CORNERS_HWD)
    hw1 = np.concatenate([HWs, np.ones((n, 1))], axis=1)
    skel = hw1[:, None, :] * _CORNERS_HWD[None]
    # K rows are (x, y, 1); swap to (y, x, 1) to match the hw skeleton.
    Ks_inv = np.linalg.inv(Ks[:, [1, 0, 2]])
    corners_cam = np.einsum("nij,nkj->nki", Ks_inv, skel) * max_depth
    corners_cam_h = np.concatenate([corners_cam, np.ones((n, k, 1))], axis=-1)
    corners_world = np.einsum("nij,nkj->nki", c2ws,
                              corners_cam_h).reshape(-1, 4)[:, :3]
    center = corners_world.mean(0)
    return center, np.linalg.norm(corners_world - center, axis=1).max()


def compute_world2nscene(HWs, Ks, cam2worlds, max_depth,
                         rescale_factor: float = 1.0):
    """4x4 similarity mapping world coords into the unit sphere enclosing all
    camera frustums ("fst" scene normalization)."""
    if rescale_factor < 1.0:
        raise ValueError("rescale_factor < 1 would push cameras outside the "
                         "unit sphere")
    center, radius = frustum_bounding_sphere(HWs, Ks, cam2worlds, max_depth)
    radius = radius * rescale_factor
    T = np.eye(4)
    T[:3, :3] /= radius
    T[:3, 3] = -center / radius
    return T.astype(np.float32)


def compute_scene_normalization_fst(transform_json, max_frustum_depth: float = 10,
                                    rescale_factor: float = 1.0):
    """Scene normalization from a ``transforms_*.json`` annotation file."""
    with open(transform_json, "r") as f:
        frames = json.load(f)["frames"]
    c2ws = np.stack([np.asarray(f["transform_matrix"], dtype=np.float64)
                     for f in frames])
    Ks = np.stack([np.asarray(f["intrinsics"], dtype=np.float64)
                   for f in frames])
    HWs = np.stack([[f["height"], f["width"]] for f in frames]).astype(np.float64)
    return compute_world2nscene(HWs, Ks, c2ws, max_frustum_depth,
                                rescale_factor)


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
