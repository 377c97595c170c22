"""Positional encodings: classic Fourier PE and the mip-NeRF IPE.

Counterpart of ``nerfmatch_tpu/nerf/embedding.py``; same feature orderings
(Fourier: ``[x, sin f0 x, cos f0 x, ...]``; mip: freq-major
``[sin block | cos block]`` with cos taken as ``sin(x + pi/2)``).
"""

from __future__ import annotations

import math

import torch


def fourier_embedding_dim(in_dim: int, num_freqs: int) -> int:
    return in_dim + 2 * in_dim * num_freqs


def fourier_embedding(x, num_freqs: int, logscale: bool = True,
                      scale: float = 1.0):
    """Classic NeRF Fourier features: ``(x, sin(f_k s x), cos(f_k s x), ...)``
    with ``f_k = 2^k`` (``logscale``) or evenly spaced in [1, 2^(F-1)], and
    ``s = scale``; the sines and cosines of one frequency side by side."""
    if logscale:
        freqs = 2.0 ** torch.linspace(0.0, num_freqs - 1, num_freqs,
                                      dtype=x.dtype, device=x.device)
    else:
        freqs = torch.linspace(1.0, 2.0 ** (num_freqs - 1), num_freqs,
                               dtype=x.dtype, device=x.device)
    xs = x[..., None, :] * (freqs[:, None] * scale)           # (..., F, D)
    enc = torch.stack([torch.sin(xs), torch.cos(xs)], dim=-2)  # (..., F, 2, D)
    return torch.cat([x, enc.reshape(*x.shape[:-1], -1)], dim=-1)


def _mip_scaled(x, num_freqs: int, squared: bool = False):
    scales = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    if squared:
        scales = scales**2
    return (x[..., None, :] * scales[:, None]).reshape(*x.shape[:-1], -1)


def pe_embedding(x, num_freqs: int):
    """mip-style PE (no variance): ``[sin(enc), cos(enc), x]``."""
    x_enc = _mip_scaled(x, num_freqs)
    x_enc = torch.cat([x_enc, x_enc + 0.5 * math.pi], dim=-1)
    return torch.cat([torch.sin(x_enc), x], dim=-1)


def ipe_embedding(mean, var, num_freqs: int):
    """mip-NeRF integrated positional encoding -> (enc_mean, enc_var)."""
    x_enc = _mip_scaled(mean, num_freqs)
    x_enc = torch.cat([x_enc, x_enc + 0.5 * math.pi], dim=-1)
    y_enc = _mip_scaled(var, num_freqs, squared=True)
    y_enc = torch.cat([y_enc, y_enc], dim=-1)
    enc_mean = torch.exp(-0.5 * y_enc) * torch.sin(x_enc)
    enc_var = torch.clamp(
        0.5 * (1.0 - torch.exp(-2.0 * y_enc) * torch.cos(2.0 * x_enc))
        - enc_mean**2, min=0.0)
    return enc_mean, enc_var


def ipe_embedding_dim(in_dim: int, num_freqs: int) -> int:
    return 2 * in_dim * num_freqs
