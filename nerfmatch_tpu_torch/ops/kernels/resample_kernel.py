"""mip-NeRF inverse-CDF z resampling: CUDA kernel wrapper and plain versions.

Replaces ``nerfmatch_tpu/ops/pallas/resample_kernel.py: resample_z_pallas``
(the Pallas ``_lookup_kernel`` plus its XLA prep), fused into one kernel,
``csrc/resample.cu``.  CUDA tensors launch it; CPU tensors run
:func:`resample_z_plain`, which is ``nerf/sampling.py:
resample_z_from_weights``.  ``u=None`` is the deterministic eval draw; in
training ``u`` is the caller's stratified (N, S+1) draw
(``nerf/sampling.py: stratified_u``), the JAX ``randomized=True`` mode.
:func:`resample_z_scan_plain` computes the same function in the kernel's
summation order, so the card tests can hold the kernel to it tightly.
"""

from __future__ import annotations

import torch

from . import LAUNCHES, check, library, require_cuda_tensors, stream_ptr
from ...nerf.sampling import (_F32_EPS, blur_weights, invert_cdf,
                              resample_z_from_weights)

MAX_BINS = 257
RAY_LANES = 16          # csrc/resample.cu: kRayLanes


def resample_z_plain(t_vals, weights, resample_padding: float = 0.01, u=None):
    return resample_z_from_weights(t_vals, weights, resample_padding, u=u)


def lane_chunk(n_weights: int) -> int:
    """Weights a lane holds: the least power of two with ``RAY_LANES`` of
    them covering the row (the kernel's template argument)."""
    per = 1
    while per * RAY_LANES < n_weights:
        per *= 2
    return per


def resample_z_scan_plain(t_vals, weights, resample_padding: float = 0.01,
                          u=None):
    """:func:`resample_z_plain` with the kernel's rounding: ``weight_sum`` as
    per-lane chunk sums in order, then a butterfly over the ray's lanes;
    the cdf as each lane's in-order prefix of its chunk plus its exclusive
    offset from a Hillis-Steele scan over the lanes; the deterministic u as
    ``k * ((1 - eps) / S)``, f32 throughout.  t_vals (N, S+1), weights
    (N, S)."""
    t_vals, weights = t_vals.detach(), weights.detach()
    n, nb = t_vals.shape
    nw = nb - 1
    lanes, per = RAY_LANES, lane_chunk(nw)
    f32 = dict(dtype=torch.float32, device=t_vals.device)
    v = torch.zeros(n, lanes * per, **f32)
    v[:, :nw] = blur_weights(weights, resample_padding)
    v = v.view(n, lanes, per)
    part = torch.zeros(n, lanes, **f32)
    for k in range(per):
        part = part + v[:, :, k]
    wsum, o = part, lanes // 2                  # butterfly: lane 0's order
    while o:
        wsum, o = wsum[:, :o] + wsum[:, o:2 * o], o // 2
    pad = torch.clamp(1e-5 - wsum, min=0.0)
    wsum = wsum + pad
    valid = (torch.arange(lanes * per, device=t_vals.device) < nw).view(lanes, per)
    pdf = torch.where(valid, (v + (pad / nw)[:, :, None]) / wsum[:, :, None], 0.0)
    loc, c = [], torch.zeros(n, lanes, **f32)
    for k in range(per):
        c = c + pdf[:, :, k]
        loc.append(c)
    x, o = c, 1
    while o < lanes:
        x, o = torch.cat([x[:, :o], x[:, :-o] + x[:, o:]], 1), 2 * o
    excl = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], 1)
    inner = torch.clamp(excl[:, :, None] + torch.stack(loc, -1), max=1.0)
    cdf = torch.cat([torch.zeros(n, 1, **f32), inner.reshape(n, -1)[:, :nw - 1],
                     torch.ones(n, 1, **f32)], 1)
    if u is None:
        step = torch.tensor(1.0 - _F32_EPS, **f32) / nw
        u = torch.arange(nb, **f32) * step
        u[-1] = 1.0 - _F32_EPS
        u = u.expand(n, nb)
    return invert_cdf(t_vals, cdf, u)


def resample_z(t_vals, weights, resample_padding: float = 0.01, u=None):
    """t_vals (N, S+1) sorted fenceposts, weights (N, S), optional draws u
    (N, S+1) in [0, 1) -> new (N, S+1); 2 <= S+1 <= 257."""
    if t_vals.device.type != "cuda":
        return resample_z_plain(t_vals, weights, resample_padding, u)
    require_cuda_tensors("resample_z", t_vals, weights,
                         *([] if u is None else [u]))
    n, nb = t_vals.shape
    if t_vals.dtype != torch.float32 or weights.dtype != torch.float32 \
            or weights.shape != (n, nb - 1) or not 2 <= nb <= MAX_BINS or (
                u is not None and (u.shape != t_vals.shape
                                   or u.dtype != torch.float32)):
        raise ValueError(f"resample_z: f32 t_vals (N, 2 <= S+1 <= {MAX_BINS}), "
                         f"weights (N, S) and u (N, S+1); got "
                         f"{tuple(t_vals.shape)}, {tuple(weights.shape)}")
    out = torch.empty_like(t_vals)
    with torch.cuda.device(t_vals.device):
        err = library().nm_resample_forward(
            t_vals.data_ptr(), weights.data_ptr(),
            None if u is None else u.data_ptr(), out.data_ptr(), n, nb,
            resample_padding, stream_ptr(t_vals.device))
    check(err, "resample")
    LAUNCHES["resample"] += 1
    return out
