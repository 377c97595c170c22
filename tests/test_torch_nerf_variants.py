"""Port parity: the NeRF variants the render kernels do not cover -- the
classic (non-mip) NeRF, the NeRF without viewdirs, the scene-coordinate
head (``out_3d_pnt`` / ``data.out_scr``) -- and the route predicate
``fused_eval_supported``, against the JAX package on the CPU at small
widths.

The same seeded numpy inputs, the same weights (JAX params through the
weight bridge) and the same random draws (regenerated from the JAX keys) go
into both packages.  Tolerances are stated per test; the Pallas comparison
runs the JAX kernel in interpret mode, as the JAX package's own tests do.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nerfmatch_tpu.nerf import compositing as jcomp
from nerfmatch_tpu.nerf import embedding as jemb
from nerfmatch_tpu.nerf import sampling as jsamp
from nerfmatch_tpu.nerf.model import NerfConfig as JNerfConfig
from nerfmatch_tpu.nerf.model import init_nerf_params, nerf_apply
from nerfmatch_tpu.nerf.renderer import NerfRenderer as JaxRenderer

from nerfmatch_tpu_torch.nerf import compositing as tcomp
from nerfmatch_tpu_torch.nerf import embedding as temb
from nerfmatch_tpu_torch.nerf import sampling as tsamp
from nerfmatch_tpu_torch.nerf.model import NerfConfig, NerfMLP
from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer
from nerfmatch_tpu_torch.ops.kernels.render_kernel import pack_mlp
from nerfmatch_tpu_torch.train.checkpoint import state_dict_from_jax

from test_torch_nerf import flat_params, make_rays, nerf_config, t
from test_torch_train import nerf_train_config

torch.set_num_threads(2)
EPS32 = float(np.finfo(np.float32).eps)


def test_classic_sampler_encoding_and_compositing_match_jax():
    """fourier_embedding (log and linear frequencies, scaled),
    sample_pts_init (depth and disparity, jittered by an injected draw),
    volume_render(mip=False, out_last=True) (its sums over 40 samples at
    rtol 1e-5 besides: XLA sums in another order) and contract at 1e-6;
    sample_pdf (deterministic and at an injected u) and sample_pts_fine at
    1e-5: the pdf's sum and cumsum round differently in XLA (1e-7 on the
    cdf), and the inverse CDF divides that by a bin's probability."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 7, 3)).astype(np.float32)
    for kw in ({}, {"logscale": False}, {"scale": 0.5}):
        np.testing.assert_allclose(temb.fourier_embedding(t(x), 5, **kw).numpy(),
                                   jemb.fourier_embedding(jnp.asarray(x), 5, **kw),
                                   atol=1e-6)
    rays = make_rays(12, 1, nonunit=True)
    o, d = rays[:, :3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    key = jax.random.PRNGKey(3)
    for use_disp in (False, True):
        for perturb in (False, True):
            jp, jz = jsamp.sample_pts_init(jnp.asarray(o), jnp.asarray(d),
                                           jnp.asarray(near), jnp.asarray(far),
                                           16, use_disp, perturb, key)
            draw = t(jax.random.uniform(key, (12, 16))) if perturb else None
            tp, tz = tsamp.sample_pts_init(t(o), t(d), t(near), t(far), 16,
                                           use_disp, t_rand=draw)
            np.testing.assert_allclose(tz.numpy(), jz, atol=1e-6)
            np.testing.assert_allclose(tp.numpy(), jp, atol=1e-6)
    w = rng.exponential(size=(12, 16)).astype(np.float32)
    w[2] = 0.0                                   # all-zero row: eps padding
    for det in (True, False):
        ref = jsamp.sample_pdf(jz, jnp.asarray(w[:, 1:]), 24, det=det, key=key)
        u = None if det else t(jax.random.uniform(key, (12, 24)))
        np.testing.assert_allclose(
            tsamp.sample_pdf(tz, t(w[:, 1:]), 24, u=u).numpy(), ref, atol=1e-5)
        jp, jzf = jsamp.sample_pts_fine(jnp.asarray(o), jnp.asarray(d), jz,
                                        jnp.asarray(w), 24, perturb=not det,
                                        key=key)
        tp, tzf = tsamp.sample_pts_fine(t(o), t(d), tz, t(w), 24, u=u)
        np.testing.assert_allclose(tzf.numpy(), jzf, atol=1e-5)
        np.testing.assert_allclose(tp.numpy(), jp, atol=1e-5)
    field = rng.normal(size=(12, 40, 7)).astype(np.float32)
    field[..., 3] = np.abs(field[..., 3]) * 20
    for white_bg in (False, True):
        jout = jcomp.volume_render(jnp.asarray(field), jzf, jnp.asarray(d),
                                   white_bg=white_bg, mip=False, out_last=True)
        tout = tcomp.volume_render(t(field), tzf, t(d), white_bg=white_bg,
                                   mip=False, out_last=True)
        for k in ("rgb", "depth", "acc", "weights", "disp", "last"):
            np.testing.assert_allclose(tout[k].numpy(), jout[k], atol=1e-6,
                                       rtol=1e-5)
    big = rng.normal(size=(30, 3)).astype(np.float32) * 2
    np.testing.assert_allclose(tcomp.contract(t(big)).numpy(),
                               jcomp.contract(jnp.asarray(big)), atol=1e-6,
                               rtol=1e-6)


MLP_MODES = [("no_viewdirs", False), ("default", True), ("short", "short"),
             ("begin", "begin"), ("viewdir", "viewdir")]


def mlp_pair(mode, stop_layer=-1):
    """(JAX config, params, port MLP) with shared weights."""
    jcfg = JNerfConfig(layer_num=6, hid_dim=32, xyz_dim=39, dirs_dim=27,
                       skips=(2,), use_viewdirs=mode != "no_viewdirs",
                       out_3d_pnt=dict(MLP_MODES)[mode], out_add_ch=3,
                       stop_layer=stop_layer)
    params = init_nerf_params(jax.random.PRNGKey(1), jcfg)
    mlp = NerfMLP(NerfConfig(**dataclasses.asdict(jcfg)))
    mlp.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    return jcfg, params, mlp


@pytest.mark.parametrize("mode", [m for m, _ in MLP_MODES])
def test_nerf_mlp_variants_match_nerf_apply(mode):
    """NerfMLP against nerf_apply without viewdirs and in each out_3d_pnt
    mode (the head's widths, its skip in validation, the descriptor pick,
    the "begin" tap at layer 4), with and without validation, in f32 and
    (validation) bf16: outputs and descriptor at 1e-5 (bf16: 1e-2, a
    rounding step of the narrow type)."""
    jcfg, params, mlp = mlp_pair(mode)
    x = np.random.default_rng(4).normal(size=(4, 9, 66)).astype(np.float32)
    for val, dtype in ((False, None), (True, None), (True, jnp.bfloat16)):
        jout, jfeat = nerf_apply(params, jcfg, jnp.asarray(x), val=val,
                                 compute_dtype=dtype)
        with torch.no_grad():
            tout, tfeat = mlp(t(x), dtype=None if dtype is None
                              else torch.bfloat16, val=val)
        tol = 1e-5 if dtype is None else 1e-2
        np.testing.assert_allclose(tout.numpy(), jout, atol=tol)
        np.testing.assert_allclose(tfeat.numpy(), jfeat, atol=tol)
        extra = 3 if (jcfg.out_3d_pnt and not val) else 0
        assert tout.shape[-1] == 4 + extra


# The classic NeRF's Fourier features of the points at 2^0 .. 2^(F-1): a
# rounding step of a point (XLA fuses o + d * z into one FMA, torch does
# not) moves its top feature by 2^(F-1) steps.  The parity tests use F = 4,
# where an f32 step stays below their tolerance; the production F = 15
# amplifies it 2^11 times more (the mip IPE damps those frequencies).
CLASSIC_FREQS = 4


def classic(cfg):
    cfg.embedding.type = "normal"
    cfg.embedding.xyz_num_freqs = CLASSIC_FREQS
    cfg.render.use_viewdirs = False
    return cfg


def variant_config(variant, **render):
    """A 4-layer hid-32 NeRF at 16 samples: ``classic`` (Fourier features,
    no viewdirs) or ``out_scr`` (mip, viewdirs, the scene-coordinate
    head)."""
    cfg = nerf_config(hid=32, **render)
    for m in (cfg.coarse_nerf, cfg.fine_nerf):
        m.layer_num, m.skips, m.num_pts = 4, [2], 16
    if variant == "classic":
        classic(cfg)
    else:
        cfg.data.out_scr = True
    return cfg


def variant_pair(cfg, stop_layer=3):
    jr = JaxRenderer(cfg, stop_layer=stop_layer)
    params = jr.init_params(jax.random.PRNGKey(0))
    key = "output_linear" if not cfg.render.use_viewdirs else "alpha_linear"
    for k in ("nerf_coarse", "nerf_fine"):
        b = params[k][key]["bias"]
        params[k][key]["bias"] = b.at[-1].add(3.0)   # a partly opaque field
    tr = NerfRenderer(cfg, stop_layer=stop_layer)
    tr.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    return jr, params, tr


def jax_train_draws(key, n, S_c, S_f, mip, perturb=True, noise_std=1.0):
    """The draws of JAX ``render_rays(train=True, key=key)`` as the port's
    ``draws`` dict (``NerfRenderer.train_draws``' keys)."""
    draws, k = {}, key
    for stage in ("coarse", "fine"):
        k, k_samp, k_noise = jax.random.split(k, 3)
        if mip:
            if stage == "coarse":
                draws["t_rand"] = t(jax.random.uniform(k_samp, (n, S_c + 1)))
            else:
                s = 1.0 / (S_c + 1)
                u = jnp.arange(S_c + 1) * s + jax.random.uniform(
                    k_samp, (n, S_c + 1), minval=0.0, maxval=s - EPS32)
                draws["u"] = t(jnp.minimum(u, 1.0 - EPS32))
        elif perturb:
            S = S_c if stage == "coarse" else S_f
            draws["t_rand" if stage == "coarse" else "u"] = t(
                jax.random.uniform(k_samp, (n, S)))
        S = S_c if (mip or stage == "coarse") else S_c + S_f
        if noise_std > 0:
            draws[f"noise_{stage}"] = t(noise_std * jax.random.normal(
                k_noise, (n, S)))
    return draws


@pytest.mark.parametrize("variant", ["classic", "out_scr"])
@pytest.mark.parametrize("train", [False, True])
def test_render_rays_variant_matches_jax(variant, train):
    """render_rays of a classic no-viewdir NeRF (12- and 11-column rays)
    and of an out_scr NeRF against the JAX XLA render, eval
    (``ret_pfeat=True, validation=True``: rgb, depth, pts, feat) and train
    (injected draws, perturb on, noise 1: rgb, depth, weights_fine, s_fine,
    scr_{stage}), f32, at 1e-5."""
    cfg = variant_config(variant, perturb=True, noise_std=1.0)
    jr, params, tr = variant_pair(cfg)
    rays = make_rays(24, 5, nonunit=True)
    widths = (12, 11) if variant == "classic" else (12,)
    key = jax.random.PRNGKey(7)
    for width in widths:
        r = rays[:, :width]
        ref = jr.render_rays(params, jnp.asarray(r), key=key, train=train,
                             ret_pfeat=not train, validation=not train)
        draws = jax_train_draws(key, 24, 16, 16, variant != "classic") \
            if train else None
        with torch.no_grad():
            ours = tr.render_rays(t(r), train=train, draws=draws)
        assert set(ours) == set(ref), (sorted(ours), sorted(ref))
        for k in ref:
            np.testing.assert_allclose(ours[k].numpy(), ref[k], atol=1e-5,
                                       err_msg=k)
    if train and variant == "out_scr":
        assert {"scr_coarse", "scr_fine"} <= set(ours)


@pytest.mark.parametrize("variant", ["classic", "out_scr"])
def test_trainer_step_variant_matches_jax(variant, tmp_path):
    """One NerfTrainer step (the plain route, as the JAX trainer's XLA
    step; SGD, perturb on, noise 1, the JAX key's draws injected) against
    the JAX trainer's step from the same weights: loss at rtol 1e-5, every
    parameter's update within 1e-4 of its leaf's largest (the head of the
    out_scr NeRF gets no gradient in either: the loss ignores scr)."""
    from tests._synthetic import build_scene

    from nerfmatch_tpu.parallel.mesh import make_mesh
    from nerfmatch_tpu.train.nerf_trainer import NerfTrainer as JTrainer
    from nerfmatch_tpu_torch.data.loaders import init_data_loader
    from nerfmatch_tpu_torch.train.nerf_trainer import NerfTrainer

    scene = build_scene(tmp_path)
    cfg = nerf_train_config(scene, tmp_path / "out", hid=32, layers=4,
                            skips=(2,), pts=16, noise_std=1.0)
    cfg.optim.optimizer = "sgd"
    cfg.optim.lr = 0.5
    if variant == "classic":
        classic(cfg)
    else:
        cfg.data.out_scr = True
    jt = JTrainer(cfg, num_frames=1, mesh=make_mesh(data=1))
    params, opt_state = jt.init_state(0)
    tt = NerfTrainer(cfg, device="cpu")
    assert tt.route == "plain"
    start = state_dict_from_jax(flat_params(params))
    tt.renderer.load_state_dict(start, strict=True)
    ds = init_data_loader(cfg.data, split="train").dataset
    b = next(ds.ray_batches(16, np.random.default_rng(0)))
    key = jax.random.PRNGKey(5)
    params, opt_state, jm = jt.train_step_fn()(
        params, opt_state, jnp.asarray(b["rays"]), jnp.asarray(b["rgbs"]),
        jnp.asarray(b["ts"], jnp.int32), key)
    draws = jax_train_draws(key, 16, 16, 16, variant != "classic")
    m = tt.train_step(t(b["rays"]), t(b["rgbs"]), draws=draws)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    ref = state_dict_from_jax(flat_params(params))
    for k, v in tt.renderer.state_dict().items():
        d_ours, d_ref = v - start[k], ref[k] - start[k]
        scale = float(d_ref.abs().max())
        assert float((d_ours - d_ref).abs().max()) <= 1e-4 * max(scale, 1e-12), \
            (k, scale)
        if k.startswith("nerf_fine.pnt_block"):
            assert scale == 0.0


def jax_predicate(cfg, stop_layer, fine_over=None):
    jr = JaxRenderer(cfg, stop_layer=stop_layer)
    jr.fused_interpret = True
    if fine_over is not None:
        jr.fine_cfg = dataclasses.replace(jr.fine_cfg, **fine_over)
    return jr.fused_eval_supported


@pytest.mark.parametrize("embed,viewdirs", [("mip", True), ("mip", False),
                                            ("normal", True)])
def test_fused_eval_supported_matches_jax(embed, viewdirs):
    """The port's route predicate equals the JAX property
    (``fused_interpret=True``) over a grid: embed type, viewdirs, out_scr,
    each out_3d_pnt mode of the fine MLP, stop_layer, skips and the stages'
    sample counts."""
    seen = set()
    grid = itertools.product((False, True), (None, True, "short", "begin",
                                             "viewdir"),
                             (-1, 2, 5), ((4,), (5,)), (128, 64), (128, 32))
    for out_scr, mode, stop, skips, c_pts, f_pts in grid:
        cfg = nerf_config(hid=32)
        cfg.embedding.type = embed
        cfg.render.use_viewdirs = viewdirs
        cfg.data.out_scr = out_scr
        for m in (cfg.coarse_nerf, cfg.fine_nerf):
            m.layer_num, m.skips = 6, list(skips)
        cfg.coarse_nerf.num_pts, cfg.fine_nerf.num_pts = c_pts, f_pts
        over = None if mode is None else {"out_3d_pnt": mode, "out_add_ch": 3}
        ref = jax_predicate(cfg, stop, over)
        tr = NerfRenderer(cfg, stop_layer=stop)
        if over is not None:
            tr.fine_cfg = dataclasses.replace(tr.fine_cfg, **over)
        assert tr.fused_eval_supported == ref, (out_scr, mode, stop, skips,
                                                c_pts, f_pts)
        seen.add(ref)
    assert seen == ({False, True} if (embed, viewdirs) == ("mip", True)
                    else {False})


def test_pack_mlp_of_an_out_scr_mlp_equals_the_headless_one():
    """pack_mlp of an MLP with a scene-coordinate head equals that of the
    same trunk and heads without it, array for array."""
    cfg = NerfConfig(layer_num=8, hid_dim=64, xyz_dim=90, dirs_dim=27,
                     use_viewdirs=True, out_3d_pnt=True, out_add_ch=3)
    with_head = NerfMLP(cfg)
    plain = NerfMLP(dataclasses.replace(cfg, out_3d_pnt=False, out_add_ch=0))
    state = {k: v for k, v in with_head.state_dict().items()
             if not k.startswith("pnt_block")}
    plain.load_state_dict(state, strict=True)
    a, b = pack_mlp(with_head), pack_mlp(plain)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x, y)


def test_out_scr_kernel_route_matches_pallas():
    """fused_render of an out_scr NeRF through the kernels' plain versions
    against JAX fused_predict in interpret mode (its Pallas pack leaves the
    head out): the JAX fused-vs-XLA tolerance of test_torch_nerf.py (2e-2 on
    rgb / depth / pts, 0.1 relative on features); and bit for bit the same
    as the port's render of the same weights without the head."""
    cfg = variant_config("out_scr")
    for m in (cfg.coarse_nerf, cfg.fine_nerf):
        m.hid_dim, m.num_pts, m.layer_num, m.skips = 64, 128, 8, [4]
    jr, params, tr = variant_pair(cfg)
    jr.fused_interpret = True
    assert jr.fused_eval_supported and tr.fused_eval_supported
    rays = make_rays(16, 6, nonunit=True)
    ref = jr.fused_predict(params, jnp.asarray(rays))
    cfg_plain = variant_config("out_scr")
    cfg_plain.data.out_scr = False
    for m in (cfg_plain.coarse_nerf, cfg_plain.fine_nerf):
        m.hid_dim, m.num_pts, m.layer_num, m.skips = 64, 128, 8, [4]
    headless = NerfRenderer(cfg_plain, stop_layer=3)
    headless.load_state_dict({k: v for k, v in tr.state_dict().items()
                              if "pnt_block" not in k}, strict=True)
    with torch.no_grad():
        ours = tr.fused_render(t(rays))
        bare = headless.fused_render(t(rays))
    for k in ("rgb_fine", "depth_fine", "pts_fine", "depth_coarse", "acc_fine"):
        np.testing.assert_allclose(ours[k].numpy(), ref[k], atol=2e-2)
    f_rel = (np.abs(ours["feat_fine"].numpy() - np.asarray(ref["feat_fine"])).max()
             / (np.abs(np.asarray(ref["feat_fine"])).max() + 1e-9))
    assert f_rel < 0.1, f_rel
    for k in ours:
        assert torch.equal(ours[k], bare[k]), k


@pytest.fixture(scope="module")
def classic_scene(tmp_path_factory):
    from tests._synthetic import build_scene

    from nerfmatch_tpu.config import dict2namespace

    root = tmp_path_factory.mktemp("classic_scene")
    scene = build_scene(root)
    cfg = variant_config("classic")
    cfg.data = dict2namespace({
        "dataset": "NerfBaseDataset", "data_dir": str(scene["root"]),
        "scene": "toy", "img_wh": [64, 64], "ray_type": "mip",
        "max_frustum_depth": 1, "rescale_factor": 1.0, "snorm_type": "fst",
        "downsample": 8})
    cfg.exp = dict2namespace({"seed": 0})
    cfg.downsample = 8
    jr, params, tr = variant_pair(cfg)
    return dict(scene=scene, cfg=cfg, jr=jr, params=params, tr=tr)


def test_classic_psnr_and_scene_points_match_jax_evaluator(classic_scene,
                                                           tmp_path):
    """The PSNR mode (eval_data_loader: PSNR per frame at 1e-3 dB, rgb at
    1e-5) and cache_scene_pts (pt3d and pt_feat at 1e-4; the int8 default
    resolves to 'none' on the plain route, as in JAX) of a classic
    no-viewdir NeRF against the JAX evaluator."""
    from nerfmatch_tpu.eval import nerf_evaluator as jne
    from nerfmatch_tpu_torch.data.loading import load_frame_3d
    from nerfmatch_tpu_torch.eval.nerf_evaluator import NerfEvaluator

    c = classic_scene
    jev = jne.NerfEvaluator(c["cfg"], c["jr"], c["params"])
    tev = NerfEvaluator(c["cfg"], c["tr"])
    ref = jev.eval_data_loader(cache_dir=tmp_path / "jax")
    ours = tev.eval_data_loader(cache_dir=tmp_path / "port")
    np.testing.assert_allclose(ours["psnr"], ref["psnr"], atol=1e-3)
    batch = next(iter(tev.data_loader))
    jp = jev.eval_batch(batch, comp_metric=False)
    tp = tev.eval_batch(batch, comp_metric=False)
    for k in ("rgb_fine", "rgb_coarse", "depth_fine"):
        np.testing.assert_allclose(tp[k], jp[k], atol=1e-5)
    jdir = jev.cache_scene_pts(cache_dir=tmp_path / "jax")
    tdir = tev.cache_scene_pts(cache_dir=tmp_path / "port")
    assert tev.renderer.cfg.trunk_int8 == "none"
    for frame in c["scene"]["frames"]:
        for a, b in zip(load_frame_3d(frame, tdir, return_pose=True),
                        load_frame_3d(frame, jdir, return_pose=True)):
            np.testing.assert_allclose(a, b, atol=1e-4)


def test_render_single_view_of_a_classic_nerf_matches_jax(classic_scene):
    """render_single_view packs 11-column rays (no mip radius) for a classic
    NeRF, as the JAX evaluator: rgb at 1e-5."""
    from nerfmatch_tpu.eval import nerf_evaluator as jne
    from nerfmatch_tpu_torch.eval.nerf_evaluator import NerfEvaluator

    c = classic_scene
    K = np.array([[30.0, 0, 16], [0, 30.0, 16], [0, 0, 1]], np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.0, 0.0, -0.6]
    ref, _ = jne.NerfEvaluator(c["cfg"], c["jr"], c["params"]) \
        .render_single_view(pose, K, near=0.05, far=1.5)
    ours, _ = NerfEvaluator(c["cfg"], c["tr"]).render_single_view(
        pose, K, near=0.05, far=1.5)
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_out_scr_int8_trunk_matches_jax_and_the_headless_one():
    """The int8 serving trunk of an out_scr NeRF (kernel 1b's weights at the
    serving default 'coarse', and 'both'): its activation scales against
    JAX ``calibrate_act_scales`` of the same out_scr NeRF (rtol 1e-4, a
    nearly dead channel 1e-4 of its layer's largest, as in
    test_torch_quant.py); ``pack_fused`` and the two-stage render through
    the kernels' plain versions equal those of the same weights without
    the head, array for array: only the trunk is quantized."""
    from nerfmatch_tpu.ops.pallas import quant as jquant
    from nerfmatch_tpu_torch.ops.kernels import quant as tquant

    cfg = variant_config("out_scr")
    for m in (cfg.coarse_nerf, cfg.fine_nerf):
        m.hid_dim, m.num_pts, m.layer_num, m.skips = 64, 128, 8, [4]
    jr, params, tr = variant_pair(cfg)
    rays = make_rays(64, 11, nonunit=True)
    ref = jquant.calibrate_act_scales(jr, params, jnp.asarray(rays))
    ours = tquant.calibrate_act_scales(tr, t(rays))
    for stage in ("coarse", "fine"):
        np.testing.assert_allclose(ours[stage]["enc"].numpy(),
                                   ref[stage]["enc"], rtol=1e-4)
        for a, b in zip(ours[stage]["acts"], ref[stage]["acts"]):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                       atol=1e-4 * float(np.max(b)))
    cfg_plain = variant_config("out_scr")
    cfg_plain.data.out_scr = False
    for m in (cfg_plain.coarse_nerf, cfg_plain.fine_nerf):
        m.hid_dim, m.num_pts, m.layer_num, m.skips = 64, 128, 8, [4]
    bare = NerfRenderer(cfg_plain, stop_layer=3)
    bare.load_state_dict({k: v for k, v in tr.state_dict().items()
                          if "pnt_block" not in k}, strict=True)
    for mode in ("coarse", "both"):
        for r in (tr, bare):
            r.cfg = dataclasses.replace(r.cfg, trunk_int8=mode)
            r.act_scales = ours
        packs = [r.pack_fused() for r in (tr, bare)]
        for (_, qa), (_, qb) in zip(*packs):
            assert (qa is None) == (qb is None)
            if qa is not None:
                assert set(qa) == set(qb)
                for k in qa:
                    if torch.is_tensor(qa[k]):
                        assert torch.equal(qa[k], qb[k]), (mode, k)
                    else:
                        assert qa[k] == qb[k], (mode, k)
        with torch.no_grad():
            a, b = tr.fused_render(t(rays)), bare.fused_render(t(rays))
        for k in a:
            assert torch.equal(a[k], b[k]), (mode, k)


@pytest.mark.parametrize("variant", ["classic", "out_scr"])
def test_cli_trains_resumes_and_evaluates_a_variant(variant, tmp_path):
    """cli.train_nerf --debug on a classic no-viewdir NeRF and on an
    out_scr NeRF (2 epochs of 10 steps on the plain route: ``route.txt``
    reads ``plain``), its resume (the weights stay), and cli.eval_nerf's
    PSNR mode and scene-point cache on the checkpoint."""
    from tests._synthetic import build_scene

    from nerfmatch_tpu.config import save_config
    from nerfmatch_tpu_torch.cli import eval_nerf
    from nerfmatch_tpu_torch.cli.train_nerf import main
    from nerfmatch_tpu_torch.train.checkpoint import latest_checkpoint
    from nerfmatch_tpu_torch.train.nerf_trainer import init_config_odir

    scene = build_scene(tmp_path)
    cfg = nerf_train_config(scene, tmp_path / "out", hid=32, layers=3,
                            skips=(1,), pts=16, noise_std=1.0)
    if variant == "classic":
        classic(cfg)
    else:
        cfg.data.out_scr = True
    path = tmp_path / "cfg.yaml"
    save_config(path, cfg)
    out_cfg, r1 = main(["--config", str(path), "--device", "cpu"])
    run_dir = init_config_odir(out_cfg)
    assert (run_dir / "route.txt").read_text() == "plain"
    w1 = r1.nerf_fine.pts_linears[0].weight.detach().clone()
    _, r2 = main(["--config", str(path), "--device", "cpu"])
    assert torch.equal(r2.nerf_fine.pts_linears[0].weight, w1)
    last = latest_checkpoint(run_dir / "checkpoints", name="last")
    assert last is not None and last.name == "last_2"
    argv = ["--ckpt", str(last), "--split", "test", "--img_wh", "64", "64",
            "--nums", "2", "--stop_layer", "1", "--device", "cpu"]
    res = eval_nerf.main(argv + ["--cache_dir", str(tmp_path / "psnr")])
    assert len(res["psnr"]) == 2 and np.isfinite(res["psnr"]).all()
    cache = eval_nerf.main(argv + ["--cache_scene_pts", "--downsample", "8",
                                   "--cache_dir", str(tmp_path / "pts")])
    pts = np.load(next(cache.glob("*.npy")), allow_pickle=True).item()
    assert pts["pt3d"].shape == (64, 3) and np.isfinite(pts["pt_feat"]).all()
