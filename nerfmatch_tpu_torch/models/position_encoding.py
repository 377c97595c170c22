"""LoFTR-style 2D sinusoidal position encoding (counterpart of
``nerfmatch_tpu/models/position_encoding.py``), NHWC."""

from __future__ import annotations

import math

import torch


def sine_position_encoding_2d(d_model: int, h: int, w: int, device=None):
    """(h, w, d_model); channel groups of 4 carry
    [sin(x f), cos(x f), sin(y f), cos(y f)] with 1-indexed positions."""
    y_pos = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None]
    x_pos = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :]
    n_freq = d_model // 4
    div_term = torch.exp(
        torch.arange(0, d_model // 2, 2, dtype=torch.float32, device=device)
        * (-math.log(10000.0) / (d_model // 2)))
    xv = (x_pos[..., None] * div_term).expand(h, w, n_freq)
    yv = (y_pos[..., None] * div_term).expand(h, w, n_freq)
    pe = torch.stack([torch.sin(xv), torch.cos(xv), torch.sin(yv),
                      torch.cos(yv)], dim=-1)
    return pe.reshape(h, w, n_freq * 4)


def add_sine_pe(x_nhwc):
    n, h, w, c = x_nhwc.shape
    return x_nhwc + sine_position_encoding_2d(c, h, w, x_nhwc.device)[None]
