"""Port parity, appearance training: the train-render stage with each ray's
appearance row (forward, explicit backward with ``g_app``), the table's
gradient through the two-stage training render, the trainer's steps and
CLI on the Cambridge config cut to small widths, and the retrieval-pair
validation, against the JAX package on the CPU.

The same seeded numpy inputs go into both packages; weights cross through
the weight bridge.  The Pallas kernels run in interpret mode, as the JAX
package's own tests run them.  Tolerances are stated per test.
"""

import json
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nerfmatch_tpu.nerf.embedding import pe_embedding as j_pe
from nerfmatch_tpu.nerf.model import NerfConfig as JNerfConfig
from nerfmatch_tpu.nerf.model import init_nerf_params
from nerfmatch_tpu.ops.pallas.render_kernel import (FusedRenderSpec,
                                                    prepare_ray_inputs)
from nerfmatch_tpu.ops.pallas.render_train import (make_fused_train_render,
                                                   pack_mlp_weights_traced)

from nerfmatch_tpu_torch.nerf.model import NerfConfig, NerfMLP
from nerfmatch_tpu_torch.ops.kernels.render_train_kernel import (
    StageSpec, render_train, render_train_plain, train_stage_forward)
from nerfmatch_tpu_torch.train.checkpoint import state_dict_from_jax

from test_torch_nerf import flat_params
from test_torch_train import (_compare, _grads_by_jax_leaf, make_rays,
                              nerf_train_config, stage_loss, t)

torch.set_num_threads(2)

F, FD, APP = 15, 4, 16
HID, LAYERS, SKIPS = 64, 4, (2,)
S, N = 32, 8
DIRS = 6 * FD + 3


@pytest.fixture(scope="module")
def app_stage():
    """JAX params of one small appearance MLP (density bias +1) and the
    port's MLP with the same weights, seeded rays / jittered z / noise, the
    rays' appearance rows (two rows of a 0.5 N(0, 1) table, alternating)
    and a target."""
    jcfg = JNerfConfig(layer_num=LAYERS, hid_dim=HID, xyz_dim=6 * F,
                       dirs_dim=DIRS, app_dim=APP, use_viewdirs=True,
                       skips=SKIPS)
    params = init_nerf_params(jax.random.PRNGKey(3), jcfg)
    params["alpha_linear"]["bias"] = params["alpha_linear"]["bias"] + 1.0
    mlp = NerfMLP(NerfConfig(layer_num=LAYERS, hid_dim=HID, xyz_dim=6 * F,
                             dirs_dim=DIRS, app_dim=APP, use_viewdirs=True,
                             skips=SKIPS))
    mlp.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    rng = np.random.default_rng(11)
    rays = make_rays(N, 12)
    tt = np.linspace(0, 1, S + 1)
    z = rays[:, 6:7] * (1 - tt) + rays[:, 7:8] * tt
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    lo = np.concatenate([z[:, :1], mids], -1)
    hi = np.concatenate([mids, z[:, -1:]], -1)
    z = (lo + (hi - lo) * rng.uniform(size=z.shape)).astype(np.float32)
    noise = rng.normal(size=(N, S)).astype(np.float32)
    table = (0.5 * rng.normal(size=(2, APP))).astype(np.float32)
    app = table[np.arange(N) % 2]
    target = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    return params, mlp, rays, z, noise, app, target


def jax_app_stage(rays, z, noise):
    """The Pallas train stage with ``extras_grad`` (interpret) as a function
    of (params, the appearance rows): extras = [dirs PE | app | 0]."""
    spec = FusedRenderSpec(num_freqs=F, hid_dim=HID, layer_num=LAYERS,
                           skips=SKIPS, samples=S, ray_tile=N, feat_layer=0)
    fused = make_fused_train_render(spec, interpret=True, extras_grad=True)
    o8, d8 = prepare_ray_inputs(jnp.asarray(rays))
    dirs = j_pe(jnp.asarray(rays[:, 8:11]), FD)

    def run(p, app):
        extras = jnp.pad(jnp.concatenate([dirs, app], -1),
                         ((0, 0), (0, 128 - DIRS - APP)))
        return fused(pack_mlp_weights_traced(p, spec), o8, d8,
                     jnp.asarray(z), extras, jnp.asarray(noise))
    return run


def _cos_ratio(a, b):
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)
    return cos, np.linalg.norm(b) / (np.linalg.norm(a) + 1e-12)


def test_app_train_stage_matches_pallas_extras_grad(app_stage):
    """Plain train stage with appearance rows vs the Pallas train kernel
    with ``extras_grad`` (interpret): rgb and weights at atol 2e-3 (sinf /
    expf against the TPU's polynomials), and through mse(rgb) + 0.1
    mean(w^2) every weight leaf and ``g_app`` (JAX's ``g_extras`` columns
    after the dirs PE) at cosine > 0.999 and norm ratio 1 +- 1e-2 (the
    tolerances of test_train_stage_grads_match_pallas_vjp; ``g_app`` rounds
    the per-ray sum of g_hv to bf16 once where JAX rounds each sample's
    product).  The appearance rows move rgb."""
    params, mlp, rays, z, noise, app, target = app_stage
    run = jax_app_stage(rays, z, noise)
    rgb_j, w_j = run(params, jnp.asarray(app))
    spec = StageSpec(mlp, F, FD)
    with torch.no_grad():
        rgb, w = render_train(spec, t(rays), t(z), t(noise), t(app))
        rgb0, _ = render_train(spec, t(rays), t(z), t(noise), t(0 * app))
    np.testing.assert_allclose(rgb.numpy(), rgb_j, atol=2e-3)
    np.testing.assert_allclose(w.numpy(), w_j, atol=2e-3)
    assert float((rgb - rgb0).abs().max()) > 1e-3
    loss = lambda p, a: stage_loss(*run(p, a), jnp.asarray(target), jnp)
    g_j, g_aj = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(app))
    mlp.zero_grad()
    a = t(app).requires_grad_(True)
    rgb, w = render_train_plain(spec, t(rays), t(z), t(noise), a)
    stage_loss(rgb, w, t(target), torch).backward()
    ours = _grads_by_jax_leaf(mlp)
    assert _compare(ours, flat_params(g_j), 0.999, (0.99, 1.01),
                    "pallas") >= 4 * LAYERS
    wv = ours["views_linears/0/weight"]
    assert np.abs(wv[HID + DIRS:]).max() > 0     # the table's rows' columns
    cos, ratio = _cos_ratio(g_aj, a.grad.numpy())
    assert cos > 0.999 and abs(ratio - 1) < 1e-2, (cos, ratio)


def test_app_train_stage_matches_f32_autograd(app_stage):
    """The explicit bf16 backward (weights and ``g_app``) vs autograd of the
    f32 plain stage with the appearance rows as a leaf: cosine > 0.98,
    norm ratio in 0.8-1.25 (the JAX package's own semantic bound)."""
    _, mlp, rays, z, noise, app, target = app_stage
    spec = StageSpec(mlp, F, FD)
    grads = []
    for fn in (lambda *x: train_stage_forward(*x[:4], bf16=False, app=x[4]),
               render_train_plain):
        mlp.zero_grad()
        a = t(app).requires_grad_(True)
        rgb, w = fn(spec, t(rays), t(z), t(noise), a)
        stage_loss(rgb, w, t(target), torch).backward()
        grads.append({**_grads_by_jax_leaf(mlp), "app": a.grad.numpy()})
    ref, ours = grads
    assert _compare(ours, ref, 0.98, (0.8, 1.25), "f32") >= 4 * LAYERS + 1


def test_app_stage_backward_with_only_app_grad(app_stage):
    """Only the appearance rows ask for a gradient: the stage returns
    ``g_app`` (equal to the one of a backward with every parameter) and no
    parameter gradient; without any gradient asked the backward returns
    nothing."""
    _, mlp, rays, z, noise, app, target = app_stage
    spec = StageSpec(mlp, F, FD)
    mlp.zero_grad()
    a = t(app).requires_grad_(True)
    stage_loss(*render_train_plain(spec, t(rays), t(z), t(noise), a),
               t(target), torch).backward()
    full = a.grad.clone()
    mlp.zero_grad()
    mlp.requires_grad_(False)
    try:
        a = t(app).requires_grad_(True)
        stage_loss(*render_train_plain(spec, t(rays), t(z), t(noise), a),
                   t(target), torch).backward()
        assert torch.equal(a.grad, full)
        assert all(p.grad is None for p in mlp.parameters())
        r = t(rays).requires_grad_(True)
        stage_loss(*render_train_plain(spec, r, t(z), t(noise), t(app)),
                   t(target), torch).backward()
        assert r.grad is None
    finally:
        mlp.requires_grad_(True)


def test_app_stage_refuses_missing_or_wrong_rows(app_stage):
    """An appearance MLP takes app (N, 16), and only it."""
    _, mlp, rays, z, noise, app, _ = app_stage
    plain = NerfMLP(NerfConfig(layer_num=2, hid_dim=64, xyz_dim=6 * F,
                               dirs_dim=DIRS, use_viewdirs=True))
    for spec, rows in ((StageSpec(mlp, F, FD), None),
                       (StageSpec(mlp, F, FD), t(app[:, :8])),
                       (StageSpec(plain, F, FD), t(app))):
        with pytest.raises(ValueError, match="app"):
            render_train(spec, t(rays), t(z), t(noise), rows)


# ---------------------------------------------------------------------------
# Renderer, trainer, CLI and pair validation
# ---------------------------------------------------------------------------

def app_train_config(scene_root, odir, **render):
    cfg = nerf_train_config({"root": scene_root}, odir, **render)
    cfg.embedding.appearance_embed = True
    return cfg


@pytest.fixture(scope="module")
def scene2(tmp_path_factory):
    """The synthetic scene with its last two frames under a second sequence
    folder (two appearance rows; the train split, the last 4 of the 12
    sorted frames, holds both), plus transient and background masks where
    the Cambridge config reads them."""
    from PIL import Image
    from tests._synthetic import build_scene

    root = tmp_path_factory.mktemp("torch_app_scene")
    scene = build_scene(root)
    data = scene["data_dir"]
    frames = []
    for i, f in enumerate(scene["frames"]):
        name = f["file_path"]
        if i >= len(scene["frames"]) - 2:
            name = name.replace("seq-01", "seq-02")
            (data / name).parent.mkdir(exist_ok=True)
            shutil.move(data / f["file_path"], data / name)
        frames.append(dict(f, file_path=name))
        rng = np.random.default_rng(i)
        for kind, frac in (("masks_trnz_cars", 0.05), ("masks_bg", 0.2)):
            m = (rng.uniform(size=(64, 64)) < frac).astype(np.uint8) * 255
            path = root / "masks" / kind / "toy" / name
            path.parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray(m).save(path)
    for split in ("train", "test"):
        (data / f"transforms_{split}.json").write_text(
            json.dumps({"frames": frames}))
    return root


def _jax_train_draws(key, n, s, noise_std):
    """The draws of the JAX ``make_fused_train_hierarchical`` for ``key``,
    as the port's ``draws`` dict."""
    from nerfmatch_tpu_torch.nerf.sampling import stratified_u

    k_strat, k_res, k_n1, k_n2 = jax.random.split(key, 4)
    return {"t_rand": t(jax.random.uniform(k_strat, (n, s + 1))),
            "u": stratified_u(n, s + 1, u_rand=t(jax.random.uniform(
                k_res, (n, s + 1)))),
            "noise_coarse": t(jax.random.normal(k_n1, (n, s)) * noise_std),
            "noise_fine": t(jax.random.normal(k_n2, (n, s)) * noise_std)}


def test_train_render_table_grad_matches_jax(scene2, tmp_path):
    """train_render with ray ids (rows 0 and 2 of a 4-row table, both
    stages reading them; perturb on, noise_std 1, the JAX draws fed to the
    port): the loss 0.5 (coarse + fine) rgb MSE matches the JAX
    ``make_fused_train_hierarchical`` (interpret) at rtol 1e-3 and the
    table's gradient ``jax.grad``'s at cosine > 0.999 and norm ratio 1 +-
    2e-2 (bf16 operands on both sides, the resample's f32 lookups); only
    the ids' rows are non-zero."""
    from nerfmatch_tpu.nerf.renderer import NerfRenderer as JRenderer
    from nerfmatch_tpu.ops.pallas.render_train import (
        make_fused_train_hierarchical)
    from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer

    cfg = app_train_config(scene2, tmp_path, pts=32, noise_std=1.0)
    jr = JRenderer(cfg, num_frames=4)
    params = jr.init_params(jax.random.PRNGKey(5))
    for k in ("nerf_coarse", "nerf_fine"):
        params[k]["alpha_linear"]["bias"] = params[k]["alpha_linear"]["bias"] + 1.0
    n = 16
    rays = make_rays(n, 21)
    ids = np.arange(n) % 2 * 2
    tgt = np.random.default_rng(22).uniform(size=(n, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    train_render = make_fused_train_hierarchical(jr, interpret=True)

    def loss_j(p):
        out = train_render(p, jnp.asarray(rays), key,
                           ray_id=jnp.asarray(ids, jnp.int32))
        return 0.5 * (jnp.mean((out["rgb_coarse"] - tgt) ** 2)
                      + jnp.mean((out["rgb_fine"] - tgt) ** 2))
    l_j, g_j = jax.value_and_grad(loss_j)(params)
    tr = NerfRenderer(cfg, num_frames=4)
    tr.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    out = tr.train_render(t(rays), draws=_jax_train_draws(key, n, 32, 1.0),
                          ray_id=torch.as_tensor(ids))
    loss = 0.5 * (((out["rgb_coarse"] - t(tgt)) ** 2).mean()
                  + ((out["rgb_fine"] - t(tgt)) ** 2).mean())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_j), rtol=1e-3)
    ours = tr.embedding_a.weight.grad.numpy()
    ref = np.asarray(g_j["embedding_a"]["weight"])
    assert np.all(ours[[1, 3]] == 0) and np.all(np.abs(ours[[0, 2]]) > 0)
    cos, ratio = _cos_ratio(ref, ours)
    assert cos > 0.999 and abs(ratio - 1) < 2e-2, (cos, ratio)


def _xla_train_draws(key, n, s):
    """The draws of the JAX XLA training render (``render_rays(train=True)``,
    noise_std 1) for ``key``, as the port's ``draws`` dict."""
    draws, k = {}, key
    eps = np.finfo(np.float32).eps
    for stage in ("coarse", "fine"):
        k, k_samp, k_noise = jax.random.split(k, 3)
        if stage == "coarse":
            draws["t_rand"] = t(jax.random.uniform(k_samp, (n, s + 1)))
        else:
            w = 1.0 / (s + 1)
            u = jnp.arange(s + 1) * w + jax.random.uniform(
                k_samp, (n, s + 1), minval=0.0, maxval=w - eps)
            draws["u"] = t(jnp.minimum(u, 1.0 - eps))
        draws[f"noise_{stage}"] = t(jax.random.normal(k_noise, (n, s)))
    return draws


def test_render_rays_train_differentiates_into_the_table(scene2, tmp_path):
    """The plain training path (render_rays(train=True), no fused train)
    sends the table its gradient: jax.grad of the JAX XLA training render
    with the same draws, the fine rgb MSE, cosine > 0.999 and norm ratio
    1 +- 1e-2 (f32 both sides; the fine resample is chaotic at edges)."""
    from nerfmatch_tpu.nerf.renderer import NerfRenderer as JRenderer
    from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer

    cfg = app_train_config(scene2, tmp_path, pts=16, noise_std=1.0)
    jr = JRenderer(cfg, num_frames=3)
    params = jr.init_params(jax.random.PRNGKey(8))
    n = 8
    rays = make_rays(n, 31)
    ids = np.arange(n) % 3
    tgt = np.random.default_rng(32).uniform(size=(n, 3)).astype(np.float32)
    key = jax.random.PRNGKey(9)

    def loss_j(p):
        out = jr.render_rays(p, jnp.asarray(rays), key=key,
                             ray_id=jnp.asarray(ids, jnp.int32), train=True)
        return jnp.mean((out["rgb_fine"] - tgt) ** 2)
    g_j = jax.grad(loss_j)(params)
    tr = NerfRenderer(cfg, num_frames=3)
    tr.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    out = tr.render_rays(t(rays), train=True, draws=_xla_train_draws(key, n, 16),
                         ray_id=torch.as_tensor(ids))
    ((out["rgb_fine"] - t(tgt)) ** 2).mean().backward()
    cos, ratio = _cos_ratio(g_j["embedding_a"]["weight"],
                            tr.embedding_a.weight.grad.numpy())
    assert cos > 0.999 and abs(ratio - 1) < 1e-2, (cos, ratio)


def test_trainer_steps_with_appearance_match_jax(scene2, tmp_path):
    """Three NerfTrainer steps of an appearance NeRF on the two-sequence
    scene (each batch's ``ts`` picks the rows; perturb off, noise 0) from
    the same exported weights: the JAX trainer on its fused Pallas path
    (interpret, ``num_frames=2``) vs the port's on the plain versions of
    the train kernels.  Loss per step at rtol 2e-3; the updates after three
    adam steps, table included, within the bounds of
    test_trainer_steps_match_jax (10% of the JAX update's norm, 6 lr an
    element)."""
    from nerfmatch_tpu.parallel.mesh import make_mesh
    from nerfmatch_tpu.train.nerf_trainer import NerfTrainer as JTrainer
    from nerfmatch_tpu_torch.data.loaders import init_data_loader
    from nerfmatch_tpu_torch.train.nerf_trainer import NerfTrainer

    cfg = app_train_config(scene2, tmp_path, perturb=False,
                           use_fused_train=True)
    jt = JTrainer(cfg, num_frames=2, mesh=make_mesh(data=1))
    jt.renderer.fused_interpret = True
    assert jt.renderer.fused_eval_supported      # the fused path: 128 samples
    params, _ = jt.init_state(0)
    for k in ("nerf_coarse", "nerf_fine"):
        params[k]["alpha_linear"]["bias"] = params[k]["alpha_linear"]["bias"] + 3.0
    opt_state = jt.opt.init(params)
    step = jt.train_step_fn()
    tt = NerfTrainer(cfg, device="cpu", num_frames=2)
    start = state_dict_from_jax(flat_params(params))
    tt.renderer.load_state_dict(start, strict=True)
    ds = init_data_loader(cfg.data, split="train").dataset
    assert set(np.unique(ds.all_ts)) == {0, 1}
    batches = ds.ray_batches(16, np.random.default_rng(0))
    for i in range(3):
        b = next(batches)
        params, opt_state, jm = step(params, opt_state, jnp.asarray(b["rays"]),
                                     jnp.asarray(b["rgbs"]),
                                     jnp.asarray(b["ts"], jnp.int32),
                                     jax.random.PRNGKey(i))
        m = tt.train_step(t(b["rays"]), t(b["rgbs"]),
                          ts=torch.as_tensor(b["ts"]))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=2e-3)
    ref = state_dict_from_jax(flat_params(params))
    moved = tt.renderer.embedding_a.weight.detach() - start["embedding_a.weight"]
    assert float(moved.abs().min()) > 0            # both rows train
    for k, v in tt.renderer.state_dict().items():
        d_ours, d_ref = v - start[k], ref[k] - start[k]
        rel = float((d_ours - d_ref).norm() / d_ref.norm())
        assert rel < 0.1 and float((d_ours - d_ref).abs().max()) <= 6 * 2e-3, \
            (k, rel)


def cambridge_config(scene_root, odir):
    """``configs/nerf/nerf_cambridge_mip_app.yaml`` with the data paths,
    the output dir, the widths (hid 64, 3 layers, 16 + 16 samples), the
    image size (64 x 64, all frames) and the run's length (batch 256, two
    epochs) cut; appearance table, masks, white background, perturb, noise
    and bf16 compute as the config sets them."""
    from pathlib import Path

    from nerfmatch_tpu_torch.config import load_yaml_config

    root = Path(__file__).resolve().parent.parent
    cfg, _ = load_yaml_config(root / "configs/nerf/nerf_cambridge_mip_app.yaml")
    cfg.data.data_dir = str(scene_root)
    cfg.data.scene = "toy"
    cfg.data.scene_anno_path = str(scene_root / "#scene" /
                                   "transforms_#split.json")
    cfg.data.mask_dir = str(scene_root / "masks")
    cfg.data.img_wh = [64, 64]
    cfg.data.max_sample_num = None
    cfg.data.max_frustum_depth = 1
    for mlp in (cfg.coarse_nerf, cfg.fine_nerf):
        mlp.hid_dim, mlp.layer_num, mlp.skips, mlp.num_pts = 64, 3, [1], 16
    cfg.exp.odir = str(odir)
    cfg.exp.batch_size, cfg.exp.max_epochs, cfg.exp.num_workers = 256, 2, 0
    return cfg


def test_cli_trains_the_cambridge_config_and_resumes(scene2, tmp_path):
    """cli.train_nerf on the Cambridge config cut to small widths (debug:
    10 steps an epoch, 2 epochs, the plain render_rays(train=True) path,
    bf16 MLP) writes last_2 with a (2, 16) table that moved from its
    initialization; a second run resumes at epoch 2 with the table's shape
    and leaves it as it was; the checkpoint's table row count is what
    ``infer_appearance_vocab`` reads, and it loads strictly into a serving
    renderer."""
    from nerfmatch_tpu.config import save_config
    from nerfmatch_tpu_torch.cli.train_nerf import main
    from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer
    from nerfmatch_tpu_torch.train.checkpoint import (infer_appearance_vocab,
                                                      latest_checkpoint)
    from nerfmatch_tpu_torch.train.nerf_trainer import init_config_odir

    cfg = cambridge_config(scene2, tmp_path)
    path = tmp_path / "cfg.yaml"
    save_config(path, cfg)
    out_cfg, r1 = main(["--config", str(path), "--device", "cpu", "--debug"])
    last = latest_checkpoint(init_config_odir(out_cfg) / "checkpoints",
                             name="last")
    assert last is not None and last.name == "last_2"
    table = r1.embedding_a.weight.detach().clone()
    assert table.shape == (2, 16) and torch.isfinite(table).all()
    init = NerfRenderer(out_cfg, num_frames=2).init_params(
        torch.Generator().manual_seed(out_cfg.exp.seed)).embedding_a.weight.detach()
    assert float((table - init).abs().min()) > 0
    _, r2 = main(["--config", str(path), "--device", "cpu", "--debug"])
    assert torch.equal(r2.embedding_a.weight, table)
    state = torch.load(last / "model.pt")
    assert infer_appearance_vocab(state) == 2
    serving = NerfRenderer(out_cfg, num_frames=2, stop_layer=1)
    serving.load_state_dict(state, strict=True)


def test_validate_image_renders_the_sample_sequence_row(scene2, tmp_path):
    """validate_image renders a val image with its sequence's table row: a
    sample of ``seq_ind`` 1 renders as ``predict`` with row 1, unlike row
    0."""
    from nerfmatch_tpu_torch.data.loaders import init_data_loader
    from nerfmatch_tpu_torch.train.nerf_trainer import NerfTrainer

    cfg = app_train_config(scene2, tmp_path, pts=16)
    tr = NerfTrainer(cfg, device="cpu", num_frames=2)
    sample = next(iter(init_data_loader(cfg.data, split="val")))
    sample = {k: (v[0] if isinstance(v, (np.ndarray, list)) else v)
              for k, v in sample.items()}
    sample["seq_ind"] = 1
    _, preds = tr.validate_image(sample, max_rays=64)
    rays = torch.as_tensor(np.asarray(sample["rays"]).reshape(-1, 12)[:64])
    with torch.no_grad():
        rows = [tr.renderer.predict(rays, ray_id=torch.full((64,), i))[
            "rgb_fine"].numpy() for i in (0, 1)]
    np.testing.assert_array_equal(preds["rgb_fine"], rows[1])
    assert np.abs(rows[0] - rows[1]).max() > 0


@pytest.fixture(scope="module")
def pair_case(tmp_path_factory):
    """A retrieval-pair val sample of the synthetic scene (its pairs file),
    the JAX trainer's params (density bias +2) and the port's trainer with
    the same weights."""
    from nerfmatch_tpu.train.nerf_trainer import NerfTrainer as JTrainer
    from nerfmatch_tpu_torch.data.loaders import init_data_loader
    from nerfmatch_tpu_torch.train.nerf_trainer import NerfTrainer
    from tests._synthetic import build_scene

    root = tmp_path_factory.mktemp("torch_pair_scene")
    scene = build_scene(root)
    cfg = nerf_train_config(scene, root / "out", pts=32)
    cfg.data.train_pair_txt = str(root / "pairs.txt")
    sample = next(iter(init_data_loader(cfg.data, split="val")))
    sample = {k: (v[0] if isinstance(v, (np.ndarray, list)) else v)
              for k, v in sample.items()}
    jt = JTrainer(cfg, num_frames=1)
    params, _ = jt.init_state(0)
    for k in ("nerf_coarse", "nerf_fine"):
        params[k]["alpha_linear"]["bias"] = params[k]["alpha_linear"]["bias"] + 2.0
    tt = NerfTrainer(cfg, device="cpu")
    tt.renderer.load_state_dict(state_dict_from_jax(flat_params(params)),
                                strict=True)
    return sample, jt, params, tt


PAIR_KEYS = {"R_err_depth": float, "t_err_depth": float, "R_err_match": float,
             "t_err_match": float, "match_score": float, "num_matches": int}


def test_validate_pair_matches_jax(pair_case):
    """validate_pair on a retrieval-pair val sample: the ds-8 grid render of
    both images (points at atol 1e-4, features at 1e-4 of their largest
    value: the same f32 plain render) against the JAX ``predict`` of the
    same rays, and the metrics against JAX ``validate_pair``: the same keys
    and types, finite or inf."""
    sample, jt, params, tt = pair_case
    assert np.asarray(sample["c2w"]).size == 32
    ref = jt.validate_pair(params, sample, ds=8)
    ours = tt.validate_pair(sample, ds=8)
    assert set(ours) == set(ref) == set(PAIR_KEYS)
    for k, typ in PAIR_KEYS.items():
        assert type(ours[k]) is typ and type(ref[k]) is typ, k
        assert not np.isnan(ours[k]), k
    rays = np.asarray(sample["rays"]).reshape(-1, 12)
    w, h = [int(x) for x in np.asarray(sample["img_wh"]).reshape(-1)[:2]]
    grid = (np.arange(h // 8)[:, None] * w * 8 + np.arange(w // 8)[None] * 8
            + 4 * w + 4).reshape(-1)
    idx = np.concatenate([grid, len(rays) // 2 + grid])
    pj = jt.renderer.predict(params, jnp.asarray(rays[idx]), ret_pfeat=True,
                             use_fused=False)
    with torch.no_grad():
        pt = tt.renderer.predict(torch.as_tensor(rays[idx]))
    np.testing.assert_allclose(pt["pts_fine"].numpy(), pj["pts_fine"],
                               atol=1e-4)
    feat = np.asarray(pj["feat_fine"])
    np.testing.assert_allclose(pt["feat_fine"].numpy(), feat,
                               atol=1e-4 * np.abs(feat).max())


def test_nerf_pose_metrics_match_jax_on_the_same_inputs(pair_case):
    """compute_nerf_pose_metrics on the JAX render of the pair: the port's
    numbers equal the JAX function's (the same host PnP, mutual nearest
    neighbours in f32) at rtol 1e-5, inf where JAX gives inf; and the
    mutual-NN matches themselves are equal."""
    from nerfmatch_tpu.utils.geometry import mutual_nn_matching as j_mnn
    from nerfmatch_tpu.utils.metrics import compute_nerf_pose_metrics as j_m
    from nerfmatch_tpu_torch.utils.geometry import mutual_nn_matching
    from nerfmatch_tpu_torch.utils.metrics import compute_nerf_pose_metrics

    sample, jt, params, _ = pair_case
    rays = np.asarray(sample["rays"]).reshape(-1, 12)
    w, h = [int(x) for x in np.asarray(sample["img_wh"]).reshape(-1)[:2]]
    grid = (np.arange(h // 8)[:, None] * w * 8 + np.arange(w // 8)[None] * 8
            + 4 * w + 4).reshape(-1)
    idx = np.concatenate([grid, len(rays) // 2 + grid])
    pj = jt.renderer.predict(params, jnp.asarray(rays[idx]), ret_pfeat=True,
                             use_fused=False)
    pts, feat = np.asarray(pj["pts_fine"]), np.asarray(pj["feat_fine"])
    ref = j_m(pts, feat, sample, ds=8)
    ours = compute_nerf_pose_metrics(pts, feat, sample, ds=8)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-5, err_msg=k)
    f1, f2 = feat.reshape(2, -1, feat.shape[-1])
    m_j, s_j, v_j = j_mnn(jnp.asarray(f1), jnp.asarray(f2))
    m_t, s_t, v_t = mutual_nn_matching(torch.as_tensor(f1),
                                       torch.as_tensor(f2))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-6)
