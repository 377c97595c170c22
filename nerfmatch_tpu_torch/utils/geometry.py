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
