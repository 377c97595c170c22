"""``feat_comb='max'`` in the port's render stage against the JAX package on
the CPU: the fine stage's plain version with ``feat_max`` (the descriptor
and the point ``o + d * t_mean`` of each ray's first largest weight) against
``make_fused_render(feat_max=True)`` in interpret mode, with a bf16 trunk
and with the int8 trunks of ``'posttap'`` and ``'both'``, with and without
early termination; the eval render's ``composite_features(..., 'max')``
against the JAX XLA path; and ``NerfEvaluator.cache_scene_pts(
feat_comb='max')`` against the JAX evaluator's.

Same seeded rays and the same weights (JAX params through the weight
bridge) on both sides, hid 64 for the stages.  The argmax is discontinuous:
where a ray's two largest weights lie closer than the two sides' weights
differ, either side may pick either sample, and the whole descriptor row
changes.  The tie margin of a comparison is twice the largest weight
difference it measured: outside it the two sides must pick the same
sample (features to the stated tolerance, points to 1e-4); inside it the
port's point must be that of a sample whose reference weight lies within
the margin of the reference's largest.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nerfmatch_tpu.config import dict2namespace, namespace2dict
from nerfmatch_tpu.eval import nerf_evaluator as jne
from nerfmatch_tpu.nerf import compositing as jcomp
from nerfmatch_tpu.nerf.renderer import NerfRenderer as JaxRenderer
from nerfmatch_tpu.ops.pallas import quant as jquant
from nerfmatch_tpu.ops.pallas.quant import pack_mlp_weights_int8
from nerfmatch_tpu.ops.pallas.render_kernel import (FusedRenderSpec,
                                                    make_fused_render)
from nerfmatch_tpu.ops.pallas.render_train import pack_mlp_weights_traced

from nerfmatch_tpu_torch.eval.nerf_evaluator import NerfEvaluator
from nerfmatch_tpu_torch.nerf import compositing as tcomp
from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer
from nerfmatch_tpu_torch.ops.kernels.quant import pack_mlp_int8
from nerfmatch_tpu_torch.ops.kernels.render_kernel import (feat_max_agreement,
                                                           render_stage_plain)
from nerfmatch_tpu_torch.train.checkpoint import state_dict_from_jax

from _synthetic import H, W, build_scene
from test_torch_nerf import flat_params, make_rays, nerf_config, t

torch.set_num_threads(2)
S = 128


def renderers(bias, feat_comb="lin", hid=64, seed=0):
    """(jax renderer, params, port renderer) on the same weights, the
    density biases raised by ``bias``.  The JAX renderer takes
    ``feat_comb`` as its evaluator's ``cache_scene_pts`` sets it (its
    ``RenderConfig.from_config`` does not read ``render.feat_comb``)."""
    cfg = nerf_config(hid=hid, feat_comb=feat_comb)
    jr = JaxRenderer(cfg, stop_layer=3)
    jr.cfg = dataclasses.replace(jr.cfg, feat_comb=feat_comb)
    params = jr.init_params(jax.random.PRNGKey(seed))
    for k in ("nerf_coarse", "nerf_fine"):
        params[k]["alpha_linear"]["bias"] = params[k]["alpha_linear"]["bias"] + bias
    tr = NerfRenderer(cfg, stop_layer=3)
    tr.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    return jr, params, tr


@pytest.fixture(scope="module")
def partly_opaque():
    return renderers(3.0)


@pytest.fixture(scope="module")
def opaque():
    """An opaque field: every ray's surface sits in its first block, so early
    termination skips the blocks after its argmax."""
    return renderers(60.0)


def stage_inputs(n, seed):
    """(n, 12) unit-direction rays and jittered, sorted fenceposts (n, S+1)
    between their near and far planes."""
    rays = make_rays(n, seed)
    rng = np.random.default_rng(seed + 100)
    u = np.sort(rng.uniform(0.0, 1.0, (n, S + 1)), axis=-1)
    u[:, 0], u[:, -1] = 0.0, 1.0
    z = (rays[:, 6:7] * (1.0 - u) + rays[:, 7:8] * u).astype(np.float32)
    return rays, z


def pallas_stage(params, scales=None, int8_from=None, eps=0.0):
    """The JAX fine stage with feat_max, the port's tile and block sizes
    (2 rays of 128 samples in 4 blocks), in interpret mode."""
    spec = FusedRenderSpec(num_freqs=15, hid_dim=64, layer_num=8, samples=S,
                           ray_tile=8, feat_layer=3, from_rays=True,
                           dirs_freqs=4, feat_max=True, sample_blocks=4,
                           early_term_eps=eps, trunk_int8=int8_from is not None,
                           trunk_int8_from=int8_from or 0)
    w = (pack_mlp_weights_traced(params["nerf_fine"], spec) if scales is None
         else pack_mlp_weights_int8(params["nerf_fine"], spec, scales["fine"]))
    return make_fused_render(spec, interpret=True), w


def hold_feat_max(ours, ref, rays, z, feat_rtol):
    """The module doc's rule (``feat_max_agreement``) -> its numbers."""
    ref = {k: t(ref[k]) for k in ("weights", "pts", "feat")}
    got = feat_max_agreement(ours, ref, t(rays), t(z))
    assert got["pts_err"] < 1e-4 and got["pick_err"] < 1e-4, got
    assert got["feat_err"] < feat_rtol, got
    return got


@pytest.mark.parametrize("eps", [0.0, 1e-4])
def test_feat_max_stage_matches_pallas_bf16(partly_opaque, opaque, eps):
    """The bf16 fine stage with feat_max (the plain version of the kernel's
    branch) against the Pallas stage: weights, depth and acc within 2e-3
    (the Pallas encoding's fast sin and exp), pts and feat by the module
    doc's rule with features to 2e-2 of their largest value.  At eps 1e-4
    on the opaque field the blocks after each ray's surface are skipped
    (exact zeros: from block 1 in the port, from block 2 in the JAX kernel,
    which always runs blocks 0 and 1) and the carried argmax survives
    them."""
    jr, params, tr = opaque if eps > 0 else partly_opaque
    rays, z = stage_inputs(16, 21)
    fused, w = pallas_stage(params, eps=eps)
    ref = fused(w, jnp.asarray(rays), jnp.asarray(z))
    with torch.no_grad():
        ours = render_stage_plain(tr.nerf_fine, t(rays), t(z), fine=True,
                                  num_freqs=15, dirs_freqs=4,
                                  early_term_eps=eps, feat_max=True)
        lin = render_stage_plain(tr.nerf_fine, t(rays), t(z), fine=True,
                                 num_freqs=15, dirs_freqs=4,
                                 early_term_eps=eps)
    for k in ("weights", "depth", "acc"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   atol=2e-3, err_msg=k)
        assert torch.equal(ours[k], lin[k])          # feat_comb moves feat, pts only
    got = hold_feat_max(ours, ref, rays, z, 2e-2)
    assert got["near_tie"] <= 2, got
    if eps > 0:   # the JAX kernel always runs blocks 0 and 1
        assert (ours["weights"].numpy()[:, 32:] == 0.0).all()
        assert (np.asarray(ref["weights"])[:, 64:] == 0.0).all()
        best = ours["weights"].argmax(-1)
        assert (best < 32).all()


@pytest.mark.parametrize("mode", ["posttap", "both"])
def test_feat_max_stage_matches_pallas_int8(partly_opaque, mode):
    """The int8 fine trunks with feat_max ('posttap': s8 from the layer after
    the tap; 'both': the whole trunk, the tap dequantized) against the
    Pallas int8 stage with the same scales: weights within 2e-2, pts and
    feat by the module doc's rule with features to 0.1 of their largest
    value (the int8 fused test's budgets)."""
    jr, params, tr = partly_opaque
    rays, z = stage_inputs(16, 22)
    scales = jquant.calibrate_act_scales(jr, params, jnp.asarray(rays))
    start = 4 if mode == "posttap" else 0
    fused, w = pallas_stage(params, scales, start)
    ref = fused(w, jnp.asarray(rays), jnp.asarray(z))
    sc = {k: t(v) for k, v in scales["fine"].items() if k == "enc"}
    sc["acts"] = [t(a) for a in scales["fine"]["acts"]]
    q = pack_mlp_int8(tr.nerf_fine, sc, start, 3)
    with torch.no_grad():
        ours = render_stage_plain(tr.nerf_fine, t(rays), t(z), fine=True,
                                  num_freqs=15, dirs_freqs=4, int8=q,
                                  feat_max=True)
    np.testing.assert_allclose(ours["weights"].numpy(),
                               np.asarray(ref["weights"]), atol=2e-2)
    got = hold_feat_max(ours, ref, rays, z, 0.1)
    assert got["near_tie"] <= 4, got


def test_composite_features_max_takes_the_first_largest_weight():
    """``composite_features(..., 'max')`` as the JAX one, ties included (the
    first in z order, as ``jnp.argmax``); the plain stage's selection is
    the same rule."""
    rng = np.random.default_rng(3)
    w = rng.integers(0, 4, (40, 12)).astype(np.float32) / 4.0   # many ties
    f = rng.normal(size=(40, 12, 5)).astype(np.float32)
    ours = tcomp.composite_features(t(w), t(f), "max").numpy()
    ref = np.asarray(jcomp.composite_features(jnp.asarray(w), jnp.asarray(f),
                                              "max"))
    np.testing.assert_array_equal(ours, ref)
    first = f[np.arange(40), (w == w.max(-1, keepdims=True)).argmax(-1)]
    np.testing.assert_array_equal(ours, first)


def test_render_rays_max_matches_xla_path():
    """The port's CPU eval render with feat_comb='max' (the sample of the
    largest weight, ``composite_features``) against the JAX XLA path:
    coarse outputs at 1e-4; fine outputs by mean and p99 (the resample is
    chaotic at silhouette edges, and a near-tie there picks another
    sample)."""
    jr, params, tr = renderers(3.0, feat_comb="max")
    rays = make_rays(32, 4, nonunit=True)
    ref = jr.render_rays(params, jnp.asarray(rays), train=False,
                         ret_pfeat=True, validation=True)
    with torch.no_grad():
        ours = tr.render_rays(t(rays))
    for k in ("pts_coarse", "feat_coarse"):
        np.testing.assert_allclose(ours[k].numpy(), ref[k], atol=1e-4)
    for k in ("pts_fine", "feat_fine"):
        err = np.abs(ours[k].numpy() - np.asarray(ref[k]))
        assert err.mean() < 1e-4 and np.quantile(err, 0.99) < 1e-3, (k, err.max())
    lin = NerfRenderer(nerf_config(), stop_layer=3)
    lin.load_state_dict(tr.state_dict())
    with torch.no_grad():
        assert not torch.allclose(lin.render_rays(t(rays))["pts_coarse"],
                                  ours["pts_coarse"])


def test_fused_cuda_accepts_feat_max(partly_opaque):
    """``fused_render`` (the kernels' plain versions on the CPU) with
    feat_comb='max' passes the flag to the fine stage: its pts and feat are
    the plain stage's with feat_max on the same z, and its weights, depth
    and rgb those of the lin config."""
    _, _, tr = partly_opaque
    tm = NerfRenderer(nerf_config(feat_comb="max", early_term_eps=0.0),
                      stop_layer=3)
    tm.load_state_dict(tr.state_dict())
    tl = NerfRenderer(nerf_config(early_term_eps=0.0), stop_layer=3)
    tl.load_state_dict(tr.state_dict())
    tm.check_fused_supported()
    rays = t(make_rays(16, 6))
    with torch.no_grad():
        a, b = tm.fused_render(rays), tl.fused_render(rays)
    for k in ("weights_fine", "depth_fine", "rgb_fine", "acc_fine"):
        assert torch.equal(a[k], b[k])
    assert not torch.allclose(a["pts_fine"], b["pts_fine"])
    best = a["weights_fine"].argmax(-1)
    assert (a["weights_fine"].gather(1, best[:, None])[:, 0] > 0).all()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """``_synthetic.build_scene``'s 64x64 frames and a hid-32 NeRF (32
    samples, partly opaque) in both packages, ds 8."""
    root = tmp_path_factory.mktemp("featmax")
    build_scene(root, n_frames=4)
    cfg = nerf_config(hid=32)
    cfg.data = dict2namespace({
        "dataset": "NerfBaseDataset", "data_dir": str(root), "scene": "toy",
        "img_wh": [W, H], "ray_type": "mip", "max_frustum_depth": 1,
        "rescale_factor": 1.0, "snorm_type": "fst", "downsample": 8})
    cfg.exp = dict2namespace({"seed": 0})
    cfg.downsample = 8
    cfg.coarse_nerf.num_pts = cfg.fine_nerf.num_pts = 32
    jr = JaxRenderer(cfg, stop_layer=3)
    params = jr.init_params(jax.random.PRNGKey(0))
    for k in ("nerf_coarse", "nerf_fine"):
        params[k]["alpha_linear"]["bias"] = params[k]["alpha_linear"]["bias"] + 3.0
    tr = NerfRenderer(cfg, stop_layer=3)
    tr.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    return dict(root=root, cfg=cfg, jr=jr, params=params, tr=tr.eval())


def test_cache_scene_pts_max_matches_jax(scene, tmp_path):
    """``cache_scene_pts(feat_comb='max')`` writes the ``ds8max`` tag, as the
    JAX evaluator's, with the same frames and keys; ``pt3d`` and
    ``pt_feat`` within 1e-4 on at least 99% of the points (a near-tie of
    the fine stage's weights may pick another sample: the rest are
    counted), ``pt_color`` within 1e-4; and the points move against the
    ``ds8lin`` cache."""
    cfg = dict2namespace(namespace2dict(scene["cfg"]))
    jdir = jne.NerfEvaluator(cfg, scene["jr"], scene["params"]) \
        .cache_scene_pts(feat_comb="max", cache_dir=tmp_path / "jax",
                         trunk_int8="none")
    tdir = NerfEvaluator(cfg, scene["tr"]).cache_scene_pts(
        feat_comb="max", cache_dir=tmp_path / "port")
    ldir = NerfEvaluator(cfg, scene["tr"]).cache_scene_pts(
        cache_dir=tmp_path / "lin")
    assert tdir.name == jdir.name == "ds8max" and ldir.name == "ds8lin"
    names = sorted(p.name for p in jdir.glob("*.npy"))
    assert names and names == sorted(p.name for p in tdir.glob("*.npy"))
    moved = []
    for name in names:
        a = np.load(tdir / name, allow_pickle=True).item()
        b = np.load(jdir / name, allow_pickle=True).item()
        lin = np.load(ldir / name, allow_pickle=True).item()
        assert set(a) == set(b)
        np.testing.assert_allclose(a["pt_color"], b["pt_color"], atol=1e-4)
        for k in ("pt3d", "pt_feat"):
            off = np.abs(a[k] - b[k]).max(-1) > 1e-4
            assert off.mean() <= 0.01, (name, k, off.sum())
        moved.append(np.abs(a["pt3d"] - lin["pt3d"]).max())
    assert max(moved) > 1e-3
