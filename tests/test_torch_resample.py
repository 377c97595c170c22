"""Port parity: the resample kernel's summation order on the CPU.

``resample_z_scan_plain`` runs ``csrc/resample.cu``'s order (per-lane chunk
sums, the butterfly ``weight_sum``, the shuffle scan of the cdf) in torch;
it is held to JAX's ``resample_z_pallas(interpret=True)`` (deterministic u)
and to JAX's prep + ``_resample_lookup(interpret=True)`` with the same
stratified u, at atol 1e-5 (f32 sums in another order: the cdf moves by a
few ulp of 1, the output by that over the bin's pdf times its width), and
to the port's plain version at the same tolerance.  With one weight
(S+1 = 2) the port keeps the cdf [0, 1] and JAX does not (see the test).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nerfmatch_tpu.ops.pallas.resample_kernel import (_resample_lookup,
                                                      resample_z_pallas)
from nerfmatch_tpu_torch.nerf.sampling import stratified_u
from nerfmatch_tpu_torch.ops.kernels.resample_kernel import (
    lane_chunk, resample_z_plain, resample_z_scan_plain)

torch.set_num_threads(2)


def rows(nb, seed=5):
    """Fenceposts (8, nb) and weights (8, nb - 1): exponential rows (two
    normalised below 1 as a render's, two raw), an all-zero row (eps
    padding), a one-hot row and two near-one-hot rows."""
    rng = np.random.default_rng(seed + nb)
    nw = nb - 1
    z = np.sort(rng.uniform(0.05, 1.4, (8, nb)), axis=-1).astype(np.float32)
    w = rng.exponential(size=(8, nw)).astype(np.float32)
    w[:2] /= w[:2].sum(-1, keepdims=True) * 1.2
    w[4] = 0.0
    w[5] = 0.0
    w[5, nw // 3] = 1.0
    w[6:] = rng.uniform(0, 1e-6, (2, nw))
    w[6, nw // 2] = 1.0
    w[7, -1] = 0.97
    return z, w


def jax_reference(z, w, u):
    """JAX's resample: resample_z_pallas (deterministic u), or its prep
    with ``u`` in place of its own draw + _resample_lookup."""
    if u is None:
        return np.asarray(resample_z_pallas(jnp.asarray(z), jnp.asarray(w),
                                            interpret=True))
    wj = jnp.asarray(w)
    wp = jnp.concatenate([wj[:, :1], wj, wj[:, -1:]], -1)
    wm = jnp.maximum(wp[:, :-1], wp[:, 1:])
    wb = 0.5 * (wm[:, :-1] + wm[:, 1:]) + 0.01
    ws = jnp.sum(wb, -1, keepdims=True)
    pad = jnp.maximum(0.0, 1e-5 - ws)
    pdf = (wb + pad / wb.shape[-1]) / (ws + pad)
    cdf = jnp.minimum(1.0, jnp.cumsum(pdf[:, :-1], -1))
    cdf = jnp.concatenate([jnp.zeros_like(cdf[:, :1]), cdf,
                           jnp.ones_like(cdf[:, :1])], -1)
    return np.asarray(_resample_lookup(jnp.asarray(z), cdf, jnp.asarray(u),
                                       interpret=True))


@pytest.mark.parametrize("mode", ["deterministic", "stratified"])
@pytest.mark.parametrize("nb", [2, 33, 65, 129, 257])
def test_scan_plain_matches_pallas(nb, mode):
    z, w = rows(nb)
    u = None
    if mode == "stratified":
        rng = np.random.default_rng(nb)
        u = stratified_u(8, nb, u_rand=torch.from_numpy(
            rng.uniform(size=(8, nb)).astype(np.float32))).numpy()
    ref = jax_reference(z, w, u)
    tu = None if u is None else torch.from_numpy(u)
    ours = resample_z_scan_plain(torch.from_numpy(z), torch.from_numpy(w),
                                 u=tu).numpy()
    plain = resample_z_plain(torch.from_numpy(z), torch.from_numpy(w),
                             u=tu).numpy()
    if nb == 2:
        # One weight: the cdf is [0, 1] and the draw lands at
        # z0 + u (z1 - z0).  JAX builds the cdf's end columns from the empty
        # cumsum (zeros_like(cdf[..., :1])), so its cdf has no column, every
        # u counts 0 and every sample lands on z0; its XLA path
        # (nerf/sampling.py) fails on the empty reduction.
        uu = np.linspace(0, 1 - 2.0**-23, 2, dtype=np.float32) if u is None else u
        np.testing.assert_allclose(ours, z[:, :1] + uu * (z[:, 1:] - z[:, :1]),
                                   atol=1e-6, rtol=0)
        np.testing.assert_array_equal(ref, np.repeat(z[:, :1], 2, 1))
    else:
        np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours, plain, atol=1e-5, rtol=0)
    assert np.all(np.isfinite(ours))
    assert np.all(np.diff(ours, axis=-1) >= 0)
    assert np.all(ours >= z[:, :1]) and np.all(ours <= z[:, -1:])


@pytest.mark.parametrize("nw,per", [(1, 1), (16, 1), (17, 2), (32, 2),
                                    (64, 4), (99, 8), (128, 8), (256, 16)])
def test_lane_chunk_covers_the_row(nw, per):
    """The kernel's template argument: 16 lanes of ``per`` weights hold the
    row, and half as many would not."""
    assert lane_chunk(nw) == per
    assert 16 * per >= nw and (per == 1 or 8 * per < nw)
