"""Pose-error and point-mapping geometry (counterpart of the parts of
``nerfmatch_tpu/utils/geometry.py`` the localization path uses)."""

from __future__ import annotations

import torch


def rotation_angle_deg(R):
    """Geodesic angle of a rotation matrix in degrees."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos))


def pose_err(gt_pose, est_pose):
    """(rotation deg, translation norm) error between two c2w poses."""
    gt_pose = torch.as_tensor(gt_pose, dtype=torch.float32)
    est_pose = torch.as_tensor(est_pose, dtype=torch.float32)
    t_err = torch.linalg.norm(gt_pose[..., :3, 3] - est_pose[..., :3, 3], dim=-1)
    rel = est_pose[..., :3, :3] @ gt_pose[..., :3, :3].transpose(-1, -2)
    return rotation_angle_deg(rel), t_err


def unnormalize_pts(pts_normed, unnorm_mat):
    """Map scene-normalized points (..., N, 3) to world coords through a
    (..., 4, 4) similarity."""
    pts_h = torch.cat([pts_normed, torch.ones_like(pts_normed[..., :1])], -1)
    return torch.einsum("...ij,...nj->...ni", unnorm_mat, pts_h)[..., :3]


def skew(v):
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1)], dim=-2)


def rodrigues(rvec):
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3).  The smoothed
    norm ``sqrt(|r|^2 + 1e-24)`` keeps the gradient finite at the zero
    rotation (iNeRF's starting point), where ``torch.linalg.norm``'s is NaN."""
    theta = torch.sqrt(torch.sum(rvec**2, dim=-1, keepdim=True) + 1e-24)
    K = skew(rvec / theta)
    s, c = torch.sin(theta)[..., None], torch.cos(theta)[..., None]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + s * K + (1.0 - c) * (K @ K)


def mutual_nn_matching(desc1, desc2, eps: float = 1e-9):
    """Cosine-similarity mutual nearest neighbours of (N1, C) and (N2, C)
    descriptors -> (matches (N1, 2) long, scores (N1,), valid (N1,) bool):
    row i is the candidate (i, nn12[i]); ``valid`` marks mutual pairs (JAX
    ``utils/geometry.py: mutual_nn_matching`` without a threshold)."""
    d1 = desc1 / (torch.linalg.norm(desc1, dim=1, keepdim=True) + eps)
    d2 = desc2 / (torch.linalg.norm(desc2, dim=1, keepdim=True) + eps)
    sim = d1 @ d2.t()
    nn12 = torch.argmax(sim, dim=1)
    nn21 = torch.argmax(sim, dim=0)
    ids1 = torch.arange(sim.shape[0], device=sim.device)
    valid = ids1 == nn21[nn12]
    scores = sim.max(dim=1).values
    return torch.stack([ids1, nn12], dim=1), scores, valid
