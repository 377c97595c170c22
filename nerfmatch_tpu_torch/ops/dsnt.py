"""Soft-argmax over a heatmap (counterpart of ``nerfmatch_tpu/ops/dsnt.py``)."""

from __future__ import annotations

import torch


def create_meshgrid(h: int, w: int, device=None):
    """(h, w, 2) grid of (x, y) coords normalized to [-1, 1]."""
    xs = torch.linspace(-1.0, 1.0, w, device=device)
    ys = torch.linspace(-1.0, 1.0, h, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def heatmap_expectation_with_std(heatmap):
    """(coords (..., 2), std (...,)) of a (..., H, W) probability map."""
    h, w = heatmap.shape[-2:]
    grid = create_meshgrid(h, w, heatmap.device).reshape(-1, 2)
    flat = heatmap.reshape(*heatmap.shape[:-2], -1)
    coords = flat @ grid
    var = flat @ (grid**2) - coords**2
    std = torch.sum(torch.sqrt(torch.clamp(var, min=1e-10)), dim=-1)
    return coords, std
