"""mip-NeRF inverse-CDF z resampling: CUDA kernel wrapper and plain version.

Replaces ``nerfmatch_tpu/ops/pallas/resample_kernel.py: resample_z_pallas``
(the Pallas ``_lookup_kernel`` plus its XLA prep), fused into one kernel,
``csrc/resample.cu``.  CUDA tensors launch it; CPU tensors run
:func:`resample_z_plain`, which is ``nerf/sampling.py:
resample_z_from_weights``.  ``u=None`` is the deterministic eval draw; in
training ``u`` is the caller's stratified (N, S+1) draw
(``nerf/sampling.py: stratified_u``), the JAX ``randomized=True`` mode.
"""

from __future__ import annotations

import torch

from . import LAUNCHES, check, library, require_cuda_tensors, stream_ptr
from ...nerf.sampling import resample_z_from_weights

MAX_BINS = 257


def resample_z_plain(t_vals, weights, resample_padding: float = 0.01, u=None):
    return resample_z_from_weights(t_vals, weights, resample_padding, u=u)


def resample_z(t_vals, weights, resample_padding: float = 0.01, u=None):
    """t_vals (N, S+1) sorted fenceposts, weights (N, S), optional draws u
    (N, S+1) in [0, 1) -> new (N, S+1)."""
    if t_vals.device.type != "cuda":
        return resample_z_plain(t_vals, weights, resample_padding, u)
    require_cuda_tensors("resample_z", t_vals, weights,
                         *([] if u is None else [u]))
    n, nb = t_vals.shape
    if t_vals.dtype != torch.float32 or weights.dtype != torch.float32 \
            or weights.shape != (n, nb - 1) or nb > MAX_BINS or (
                u is not None and (u.shape != t_vals.shape
                                   or u.dtype != torch.float32)):
        raise ValueError(f"resample_z: f32 t_vals (N, S+1 <= {MAX_BINS}), "
                         f"weights (N, S) and u (N, S+1); got "
                         f"{tuple(t_vals.shape)}, {tuple(weights.shape)}")
    out = torch.empty_like(t_vals)
    err = library().nm_resample_forward(
        t_vals.data_ptr(), weights.data_ptr(),
        None if u is None else u.data_ptr(), out.data_ptr(), n, nb,
        resample_padding, stream_ptr(t_vals.device))
    check(err, "resample")
    LAUNCHES["resample"] += 1
    return out
