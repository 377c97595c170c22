"""Early termination at eps 1e-4 against eps 0: the JAX fused render and
the port's render on the same weights and rays.

Both packages skip a sample block once every ray of a tile has
transmittance below eps, and write exact zero weights there.  The rules
differ: the JAX kernel tiles 16 rays, always runs blocks 0 and 1, and
skips below a margin under ``log(eps)`` on a bound of the carry; the port
tiles 2 rays, always runs block 0 and compares the carry itself with
``log(eps)`` (``render_kernel.early_term_mask``, which the card test
``test_render_eval_zero_weights_match_early_term_mask`` holds kernel 1
to).  Each is held here to its own guarantee at fixed z: a skipped block
enters with transmittance below eps, so the weights it drops sum to less
than eps on every ray, and each composited output moves by less than eps
times the largest value it composites.  The JAX side runs in interpret
mode, as the JAX package's own tests run it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nerfmatch_tpu.nerf.renderer import NerfRenderer as JaxRenderer
from nerfmatch_tpu.ops.pallas.render_kernel import (
    FusedRenderSpec, make_fused_hierarchical, make_fused_render)
from nerfmatch_tpu.ops.pallas.render_kernel import (
    reparam_unit_dir as j_reparam)
from nerfmatch_tpu.ops.pallas.render_train import pack_mlp_weights_traced

from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer
from nerfmatch_tpu_torch.nerf.renderer import reparam_unit_dir as t_reparam
from nerfmatch_tpu_torch.ops.kernels.render_kernel import (
    early_term_mask, mlp_plain, render_stage_plain, stage_alpha_plain)
from nerfmatch_tpu_torch.nerf.embedding import ipe_embedding, pe_embedding
from nerfmatch_tpu_torch.nerf.sampling import frustum_moments, lift_gaussian
from nerfmatch_tpu_torch.train.checkpoint import state_dict_from_jax

from test_torch_nerf import flat_params, make_rays, nerf_config, t

torch.set_num_threads(2)

EPS = 1e-4
N_RAYS = 32
S = 128
# The alpha bias shift that saturates every ray inside block 0 (sigma of
# about 30 over steps of 0.0105: log T falls by ~0.3 a sample), so both
# rules skip: the port from block 1 on, JAX from block 2 on.
OPAQUE = 30.0
# The render tolerance chip_smoke.py holds kernel 1 to.
RENDER_TOL = 5e-3


def make_scene():
    cfg = nerf_config()
    jr = JaxRenderer(cfg, stop_layer=3)
    params = jr.init_params(jax.random.PRNGKey(0))
    for k in ("nerf_coarse", "nerf_fine"):
        params[k]["alpha_linear"]["bias"] = (
            params[k]["alpha_linear"]["bias"] + OPAQUE)
    tr = NerfRenderer(cfg, stop_layer=3)
    tr.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    rays = make_rays(N_RAYS, 11)
    return jr, params, tr, rays


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def _z(rays):
    tt = np.linspace(0.0, 1.0, S + 1, dtype=np.float32)
    return rays[:, 6:7] * (1.0 - tt) + rays[:, 7:8] * tt


def _jax_stage(params, rays, eps):
    spec = FusedRenderSpec(num_freqs=15, hid_dim=64, layer_num=8, samples=S,
                           ray_tile=16, feat_layer=3, white_bg=False,
                           from_rays=True, dirs_freqs=4, sample_blocks=4,
                           early_term_eps=eps)
    fused = make_fused_render(spec, interpret=True)
    w = pack_mlp_weights_traced(params["nerf_fine"], spec)
    jrays, _ = j_reparam(jnp.asarray(rays))
    out = fused(w, jrays, jnp.asarray(_z(rays)))
    return {k: np.asarray(out[k]) for k in ("weights", "rgb", "depth", "acc",
                                            "feat")}


def _port_stage(tr, rays, eps):
    mlp = tr._stages()[1][1]
    trays, _ = t_reparam(t(rays))
    with torch.no_grad():
        out = render_stage_plain(mlp, trays, t(_z(rays)), fine=True,
                                 num_freqs=15, dirs_freqs=4,
                                 early_term_eps=eps)
    return {k: out[k].numpy() for k in ("weights", "rgb", "depth", "acc",
                                        "feat")}


def _port_tap_max(tr, rays):
    """Largest |tap| over the stage's samples: what feat composites."""
    mlp = tr._stages()[1][1]
    trays, _ = t_reparam(t(rays))
    z = t(_z(rays))
    t_mean, t_var, r_var = frustum_moments(z[:, :-1], z[:, 1:],
                                           trays[:, 11:12])
    mean, var = lift_gaussian(trays[:, 8:11], t_mean, t_var, r_var)
    enc, _ = ipe_embedding(mean + trays[:, None, 0:3], var, 15)
    dirs = pe_embedding(trays[:, 8:11], 4)[:, None, :]
    with torch.no_grad():
        tap = mlp_plain(mlp, enc, dirs, 3, True)[2]
    return float(tap.abs().max())


def _assert_guarantee(on, off, far, tap_max):
    dw = np.abs(on["weights"] - off["weights"])
    skipped = (on["weights"] == 0) & (off["weights"] > 0)
    assert skipped.any(), "no block was skipped: the scene does not saturate"
    assert dw.max() < EPS and dw.sum(-1).max() < EPS, dw.sum(-1).max()
    assert np.abs(on["acc"] - off["acc"]).max() < EPS
    assert np.abs(on["rgb"] - off["rgb"]).max() < EPS
    assert np.abs(on["depth"] - off["depth"]).max() < EPS * far
    assert np.abs(on["feat"] - off["feat"]).max() < EPS * tap_max
    return dict(skipped=int(skipped.sum()), w_sum=float(dw.sum(-1).max()),
                feat=float(np.abs(on["feat"] - off["feat"]).max()))


def test_single_stage_guarantee_in_both_packages(scene):
    """At fixed z each package's eps-1e-4 stage drops weights that sum to
    less than eps on every ray, and acc, rgb, depth (over far) and feat
    (over its largest tap value) move by less than eps; the port's 2-ray
    tile skips at least every block JAX's 16-ray tile skips."""
    jr, params, tr, rays = scene
    far, tap_max = float(rays[:, 7].max()), _port_tap_max(tr, rays)
    j_on, j_off = _jax_stage(params, rays, EPS), _jax_stage(params, rays, 0.0)
    p_on, p_off = _port_stage(tr, rays, EPS), _port_stage(tr, rays, 0.0)
    jd = _assert_guarantee(j_on, j_off, far, tap_max)
    pd = _assert_guarantee(p_on, p_off, far, tap_max)
    # The port's rule is the finer one: it skips where JAX skips, and more.
    j_skip = (j_on["weights"] == 0) & (j_off["weights"] > 0)
    p_skip = (p_on["weights"] == 0) & (p_off["weights"] > 0)
    assert not (j_skip & ~p_skip).any()
    assert pd["skipped"] > jd["skipped"], (pd, jd)
    # The port's skipped samples are the ones early_term_mask names.
    mlp = tr._stages()[1][1]
    trays, _ = t_reparam(t(rays))
    with torch.no_grad():
        mask = early_term_mask(stage_alpha_plain(mlp, trays, t(_z(rays)),
                                                 num_freqs=15, dirs_freqs=4),
                               EPS).numpy()
    assert (p_on["weights"][mask] == 0).all()
    np.testing.assert_array_equal(p_on["weights"][~mask],
                                  p_off["weights"][~mask])


def hierarchical_outputs(scene):
    """{eps: (JAX's two-stage outputs, the port's)} at eps 1e-4 and 0."""
    jr, params, tr, rays = scene
    jr.fused_interpret = True
    outs = {}
    for eps in (EPS, 0.0):
        render, pack = make_fused_hierarchical(jr, interpret=True,
                                               ray_tile=16, early_term_eps=eps)
        wc, wf = pack(params)
        ref = render(wc, wf, jnp.asarray(rays))
        port = NerfRenderer(nerf_config(early_term_eps=eps), stop_layer=3)
        port.load_state_dict(tr.state_dict())
        with torch.no_grad():
            ours = port.fused_render(t(rays))
        outs[eps] = ({k: np.asarray(v) for k, v in ref.items()},
                     {k: v.numpy() for k, v in ours.items()})
    return outs


def test_hierarchical_port_tracks_jax_at_eps(scene):
    """The two-stage render at eps 1e-4: the port's plain path within the
    render tolerance of JAX's fused render (interpret mode); each package
    moves its own outputs by less than the tolerance from eps 0."""
    outs = hierarchical_outputs(scene)
    ref, ours = outs[EPS]
    for k in ("rgb_fine", "depth_fine", "acc_fine", "pts_fine",
              "depth_coarse"):
        np.testing.assert_allclose(ours[k], ref[k], atol=RENDER_TOL, err_msg=k)
    scale = np.abs(ref["feat_fine"]).max()
    assert np.abs(ours["feat_fine"] - ref["feat_fine"]).max() < RENDER_TOL * scale
    for side in (0, 1):
        on, off = outs[EPS][side], outs[0.0][side]
        for k in ("rgb_fine", "depth_fine", "acc_fine", "pts_fine"):
            assert np.abs(on[k] - off[k]).max() < RENDER_TOL, (side, k)
        f = np.abs(on["feat_fine"] - off["feat_fine"]).max()
        assert f < RENDER_TOL * np.abs(off["feat_fine"]).max(), (side, f)


if __name__ == "__main__":
    # The figures the records quote: each package's eps-1e-4 render against
    # its eps-0 render, at fixed z and through both stages.
    #   PYTHONPATH=. python tests/test_torch_early_term.py
    import conftest  # noqa: F401  (jax on the CPU)

    sc = make_scene()
    jr, params, tr, rays = sc
    far, tap_max = float(rays[:, 7].max()), _port_tap_max(tr, rays)
    for name, stage in (("jax", lambda e: _jax_stage(params, rays, e)),
                        ("port", lambda e: _port_stage(tr, rays, e))):
        print(name, "stage of", S * N_RAYS, "samples:",
              _assert_guarantee(stage(EPS), stage(0.0), far, tap_max))
    outs = hierarchical_outputs(sc)
    for side, name in ((0, "jax"), (1, "port")):
        on, off = outs[EPS][side], outs[0.0][side]
        print(name, "two stages, feat moved",
              float(np.abs(on["feat_fine"] - off["feat_fine"]).max()),
              "of", float(np.abs(off["feat_fine"]).max()))
