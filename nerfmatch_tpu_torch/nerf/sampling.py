"""Ray sampling (counterpart of ``nerfmatch_tpu/nerf/sampling.py``).

* mip-NeRF: fencepost init (jittered in training), the conical-frustum
  Gaussian cast, and the weight-blurred inverse-CDF resampling (stratified
  u in training).  ``resample_z_from_weights`` is the plain version of the
  resample kernel (``ops/kernels/resample_kernel.py``).
* classic NeRF: stratified z between near and far (linear in depth or in
  disparity, jittered in training), the inverse-CDF draw of the fine
  samples over the coarse mid-points (right-side search) and their merge
  with the coarse z.

Random draws enter as tensors (``t_rand``, ``u``) so that a caller, or a
test feeding both packages the same numbers, controls them;
:func:`jitter_uniforms` and :func:`stratified_u` make them from an explicit
``torch.Generator``."""

from __future__ import annotations

import torch

from .rays import RAY_FAR, RAY_NEAR, RAY_RADII

_F32_EPS = float(torch.finfo(torch.float32).eps)


def lift_gaussian(d, t_mean, t_var, r_var):
    """Lift a 1D Gaussian along ``d`` into 3D (mean, diagonal cov)."""
    mean = d[..., None, :] * t_mean[..., None]
    d_mag_sq = torch.clamp(torch.sum(d**2, dim=-1, keepdim=True), min=1e-10)
    d_outer_diag = d**2
    null_outer_diag = 1.0 - d_outer_diag / d_mag_sq
    t_cov_diag = t_var[..., None] * d_outer_diag[..., None, :]
    xy_cov_diag = r_var[..., None] * null_outer_diag[..., None, :]
    return mean, t_cov_diag + xy_cov_diag


def frustum_moments(t0, t1, base_radius):
    """Stable closed form of a conical frustum's (t_mean, t_var, r_var)."""
    mu = (t0 + t1) / 2.0
    hw = (t1 - t0) / 2.0
    denom = torch.clamp(3.0 * mu**2 + hw**2, min=_F32_EPS)
    t_mean = mu + (2.0 * mu * hw**2) / denom
    t_var = hw**2 / 3.0 - (4.0 / 15.0) * ((hw**4 * (12.0 * mu**2 - hw**2))
                                          / denom**2)
    r_var = base_radius**2 * (mu**2 / 4.0 + (5.0 / 12.0) * hw**2
                              - (4.0 / 15.0) * hw**4 / denom)
    return t_mean, t_var, r_var


def conical_frustum_to_gaussian(d, t0, t1, base_radius):
    """Moment-matched Gaussian of a conical frustum (mip-NeRF eq. 7)."""
    return lift_gaussian(d, *frustum_moments(t0, t1, base_radius))


def cast_rays(t_vals, origins, directions, radii):
    """Fencepost t_vals (..., S+1) -> S Gaussians (means, diagonal covs)."""
    means, covs = conical_frustum_to_gaussian(
        directions, t_vals[..., :-1], t_vals[..., 1:], radii)
    return means + origins[..., None, :], covs


def jitter_fenceposts(t_vals, t_rand):
    """Stratified jitter of sorted fenceposts (..., S+1) by uniforms
    ``t_rand`` in [0, 1) of the same shape (``sampling.py:176-182``)."""
    mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
    upper = torch.cat([mids, t_vals[..., -1:]], dim=-1)
    lower = torch.cat([t_vals[..., :1], mids], dim=-1)
    return lower + (upper - lower) * t_rand


def jitter_uniforms(n: int, num_fenceposts: int, generator=None, device=None):
    """The uniforms of :func:`jitter_fenceposts`: (n, S+1) in [0, 1)."""
    return torch.rand((n, num_fenceposts), generator=generator, device=device)


def stratified_u(n: int, num_samples: int, generator=None, device=None,
                 u_rand=None):
    """Training draw of the inverse-CDF lookup: stratum k of width
    ``s = 1/num_samples`` plus a uniform in [0, s - eps), clipped below 1
    (``sampling.py:208-216``).  ``u_rand`` in [0, 1) may be given."""
    s = 1.0 / num_samples
    if u_rand is None:
        u_rand = torch.rand((n, num_samples), generator=generator,
                            device=device)
    base = torch.arange(num_samples, dtype=torch.float32,
                        device=u_rand.device) * s
    return torch.clamp(base + u_rand * (s - _F32_EPS), max=1.0 - _F32_EPS)


def sample_gaussians_along_rays(origins, directions, radii, num_samples: int,
                                near, far, t_rand=None):
    """mip-NeRF fenceposts (jittered by ``t_rand`` (..., S+1) when given)
    -> (t_vals (..., S+1), (means, covs))."""
    t = torch.linspace(0.0, 1.0, num_samples + 1, dtype=origins.dtype,
                       device=origins.device)
    t_vals = near * (1.0 - t) + far * t
    if t_rand is not None:
        t_vals = jitter_fenceposts(t_vals, t_rand)
    return t_vals, cast_rays(t_vals, origins, directions, radii)


def sorted_piecewise_constant_pdf(bins, weights, num_samples: int, u=None):
    """Invert a piecewise-constant PDF over sorted ``bins`` at ``u``
    (..., num_samples), by default the deterministic
    ``linspace(0, 1 - eps_f32, num_samples)``."""
    eps = 1e-5
    weight_sum = torch.sum(weights, dim=-1, keepdim=True)
    padding = torch.clamp(eps - weight_sum, min=0.0)
    weights = weights + padding / weights.shape[-1]
    weight_sum = weight_sum + padding

    pdf = weights / weight_sum
    cdf = torch.clamp(torch.cumsum(pdf[..., :-1], dim=-1), max=1.0)
    # The end columns take pdf's shape: with one weight, cdf is empty here.
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]), cdf,
                     torch.ones_like(pdf[..., :1])], dim=-1)
    if u is None:
        u = torch.linspace(0.0, 1.0 - _F32_EPS, num_samples, dtype=cdf.dtype,
                           device=cdf.device)
        u = u.expand(*cdf.shape[:-1], num_samples)
    return invert_cdf(bins, cdf, u)


def invert_cdf(bins, cdf, u):
    """The interval lookup and interpolation of an inverse-CDF draw: ``u``
    (..., S) against the sorted ``bins`` and their ``cdf`` (..., B)."""
    mask = cdf[..., :, None] <= u[..., None, :]                 # (N, B, S)
    big = 1e10
    cdf_g0 = torch.where(mask, cdf[..., :, None], -big).amax(dim=-2)
    cdf_g1 = torch.where(mask, big, cdf[..., :, None]).amin(dim=-2)
    bins_g0 = torch.where(mask, bins[..., :, None], -big).amax(dim=-2)
    bins_g1 = torch.where(mask, big, bins[..., :, None]).amin(dim=-2)
    cdf_g0 = torch.maximum(cdf_g0, cdf[..., :1])
    cdf_g1 = torch.minimum(cdf_g1, cdf[..., -1:])
    bins_g0 = torch.maximum(bins_g0, bins[..., :1])
    bins_g1 = torch.minimum(bins_g1, bins[..., -1:])

    t = torch.clamp(torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0), nan=0.0),
                    0.0, 1.0)
    return bins_g0 + t * (bins_g1 - bins_g0)


def resample_z_from_weights(t_vals, weights, resample_padding: float = 0.01,
                            u=None):
    """mip-NeRF weight-blurred z resampling (same sample count as t_vals),
    at the stratified draws ``u`` (..., S+1) when given; no gradient."""
    return sorted_piecewise_constant_pdf(
        t_vals.detach(), blur_weights(weights.detach(), resample_padding),
        t_vals.shape[-1], u)


def blur_weights(weights, resample_padding: float):
    """mip-NeRF's max-then-average weight blur, plus ``resample_padding``."""
    weights_pad = torch.cat([weights[..., :1], weights, weights[..., -1:]],
                            dim=-1)
    weights_max = torch.maximum(weights_pad[..., :-1], weights_pad[..., 1:])
    return 0.5 * (weights_max[..., :-1] + weights_max[..., 1:]) + resample_padding


def sample_pts_init(rays_o, rays_d, near, far, num_pts: int = 64,
                    use_disp: bool = False, t_rand=None):
    """Classic stratified z between ``near`` and ``far`` (R, 1), linear in
    depth or (``use_disp``) in disparity, jittered within each stratum by
    the uniforms ``t_rand`` (R, num_pts) when given -> (pts (R, S, 3), z)."""
    t = torch.linspace(0.0, 1.0, num_pts, dtype=rays_o.dtype,
                       device=rays_o.device)
    if use_disp:
        z_vals = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    else:
        z_vals = near * (1.0 - t) + far * t
    z_vals = z_vals.expand(rays_o.shape[0], num_pts)
    if t_rand is not None:
        z_vals = jitter_fenceposts(z_vals, t_rand)
    return rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None], \
        z_vals


def sample_pdf(bins, weights, num_samples: int, u=None, eps: float = 1e-5):
    """Classic hierarchical sampling: invert the piecewise-constant CDF of
    ``weights`` (..., B-1) + ``eps`` over ``bins`` (..., B) at ``u``
    (..., num_samples), by default ``linspace(0, 1, num_samples)`` (the
    deterministic draw), with a right-side search
    (``torch.searchsorted(right=True)``)."""
    weights = weights + eps
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    if u is None:
        u = torch.linspace(0.0, 1.0, num_samples, dtype=cdf.dtype,
                           device=cdf.device)
        u = u.expand(*cdf.shape[:-1], num_samples)
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_g0, cdf_g1 = (torch.gather(cdf, -1, i) for i in (below, above))
    bins_g0, bins_g1 = (torch.gather(bins, -1, i) for i in (below, above))
    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_g0) / denom
    return bins_g0 + t * (bins_g1 - bins_g0)


def sample_pts_fine(rays_o, rays_d, z_vals, weights, num_pts: int = 64,
                    u=None):
    """The fine samples of a classic NeRF: ``num_pts`` draws from the coarse
    ``weights`` over the coarse mid-points (``u`` (R, num_pts): the
    training draw; None: the deterministic one), merged with the coarse z
    and sorted -> (pts (R, S_c + num_pts, 3), z); no gradient to the
    draws."""
    z_mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    z_samples = sample_pdf(z_mids, weights[..., 1:-1], num_pts, u).detach()
    z_vals, _ = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1)
    return rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None], \
        z_vals


def sample_along_rays(rays, num_pts: int = 128, z_vals=None, weights=None,
                      model_type: str = "coarse", scale_var: float = -1.0,
                      rand=None, embed_type: str = "mip",
                      use_disp: bool = False):
    """Sampling entry.  mip (``embed_type='mip'``): coarse fenceposts, or the
    fine resample of ``z_vals`` by ``weights`` -> ((means, vars), z_vals);
    ``rand``: the training draw (coarse: ``t_rand`` (R, S+1); fine: ``u``
    (R, S+1)).  Classic (any other ``embed_type``): the stratified coarse z
    (``use_disp``: linear in disparity) or the fine draw merged with the
    coarse z -> (pts, z_vals); ``rand``: coarse ``t_rand`` (R, S), fine
    ``u`` (R, num_pts)."""
    rays_o, rays_d = rays[..., 0:3], rays[..., 3:6]
    if embed_type != "mip":
        if model_type == "coarse":
            return sample_pts_init(rays_o, rays_d,
                                   rays[..., RAY_NEAR:RAY_NEAR + 1],
                                   rays[..., RAY_FAR:RAY_FAR + 1], num_pts,
                                   use_disp, t_rand=rand)
        return sample_pts_fine(rays_o, rays_d, z_vals, weights, num_pts, u=rand)
    radii = rays[..., RAY_RADII:RAY_RADII + 1]
    if model_type == "coarse":
        near = rays[..., RAY_NEAR:RAY_NEAR + 1]
        far = rays[..., RAY_FAR:RAY_FAR + 1]
        z_vals, (mean, var) = sample_gaussians_along_rays(
            rays_o, rays_d, radii, num_pts, near, far, t_rand=rand)
    else:
        z_vals = resample_z_from_weights(z_vals, weights, u=rand)
        mean, var = cast_rays(z_vals, rays_o, rays_d, radii)
    if scale_var > 0:
        var = scale_var * var
    return (mean, var), z_vals
