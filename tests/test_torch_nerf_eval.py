"""The port's NeRF evaluator, its appearance table and its eval render in
``compute_dtype`` against the JAX package on the CPU, at a small size: hid
32-64 NeRFs with 16-128 samples, weights from ``jax.random.PRNGKey(0)``
carried across by the weight bridge, 32x32 and 64x64 images.

The scene: ``_synthetic.build_scene``'s 64x64 frames, copied so that half
of them sit under a second sequence folder (``ts`` takes both values, the
appearance table has two rows).  Tolerances: non-resampled (coarse) maps
1e-4; resampled (fine) maps by mean 1e-5 and 99th percentile 1e-4 (the
resample is chaotic at silhouette edges); PSNR 0.01 dB; decoded 8-bit
PNGs within 1 (a float rounding at a .5 boundary); colorized depth PNGs
by share (a depth on a colormap step can land on the next step, 4 values
apart, and the port's jet is within 1 of OpenCV's); the Pallas comparison
at the JAX fused-vs-XLA tolerance of ``test_torch_nerf.py``.
"""

import json
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from nerfmatch_tpu.config import dict2namespace, namespace2dict
from nerfmatch_tpu.eval import nerf_evaluator as jne
from nerfmatch_tpu.nerf.renderer import NerfRenderer as JaxRenderer
from nerfmatch_tpu.train.checkpoint import export_torch_state_dict

from nerfmatch_tpu_torch.cli import eval_nerf
from nerfmatch_tpu_torch.eval.nerf_evaluator import (NerfEvaluator,
                                                     load_nerf_from_ckpt,
                                                     load_renderer)
from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer
from nerfmatch_tpu_torch.train.checkpoint import (save_checkpoint,
                                                  state_dict_from_jax)

from _synthetic import W, H, build_scene
from test_torch_nerf import flat_params, make_rays, nerf_config, t

torch.set_num_threads(2)


def jax_and_port(cfg, vocab=None, seed=0, bias=3.0):
    """(jax renderer, params, port renderer) on the same weights; the
    density biases raised by ``bias`` so the field is partly opaque, the
    appearance table (``vocab`` rows) scaled up so its rows move rgb."""
    jr = JaxRenderer(cfg, num_frames=vocab, stop_layer=3)
    params = jr.init_params(jax.random.PRNGKey(seed))
    for k in ("nerf_coarse", "nerf_fine"):
        params[k]["alpha_linear"]["bias"] = params[k]["alpha_linear"]["bias"] + bias
    if vocab:
        params["embedding_a"]["weight"] = params["embedding_a"]["weight"] * 4.0
    tr = NerfRenderer(cfg, num_frames=vocab, stop_layer=3)
    tr.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    return jr, params, tr.eval()


def app_config(hid=32, pts=16, **render):
    cfg = nerf_config(hid=hid, **render)
    cfg.embedding.appearance_embed = True
    cfg.coarse_nerf.num_pts = cfg.fine_nerf.num_pts = pts
    return cfg


def fine_close(ours, ref):
    err = np.abs(np.asarray(ours) - np.asarray(ref))
    assert err.mean() < 1e-5 and np.quantile(err, 0.99) < 1e-4, err.max()


def test_eval_render_rays_in_bfloat16_matches_jax():
    """``render_rays(train=False)`` runs the MLP in ``compute_dtype``, as the
    JAX ``_forward_nerf``: with ``'bfloat16'`` against JAX
    ``render_rays(train=False)`` at the f32 test's bounds (coarse 1e-4, fine
    mean 1e-5 / p99 1e-4), through ``render_rays`` and chunked ``predict``."""
    jr, params, tr = jax_and_port(nerf_config(hid=64, compute_dtype="bfloat16"))
    rays = make_rays(32, 4, nonunit=True)
    ref = jr.render_rays(params, jnp.asarray(rays), train=False,
                         ret_pfeat=True, validation=True)
    with torch.no_grad():
        ours = tr.render_rays(t(rays))
        chunked = tr.predict(t(rays), chunk_rays=12)
    for k in ("rgb_coarse", "depth_coarse", "pts_coarse", "feat_coarse"):
        np.testing.assert_allclose(ours[k].numpy(), ref[k], atol=1e-4)
    for k in ("rgb_fine", "depth_fine", "pts_fine", "feat_fine"):
        fine_close(ours[k].numpy(), ref[k])
        assert torch.equal(chunked[k], ours[k])


@pytest.mark.parametrize("vocab,ids", [(3, "per_ray"), (3, "default"),
                                       (1, "clamped")])
def test_appearance_render_matches_jax(vocab, ids):
    """``render_rays`` and ``predict`` of an appearance NeRF (16-column
    table of ``vocab`` rows) against JAX ``render_rays(ray_id=...)``: ids
    per ray in 0..2, the default (row 1 for every ray), and a one-row
    table read at id 1 (JAX's gather clamps to row 0; the port clamps)."""
    jr, params, tr = jax_and_port(app_config(), vocab=vocab)
    rays = make_rays(24, 9, nonunit=True)
    rid = {"per_ray": np.arange(24) % 3, "default": None,
           "clamped": np.ones(24)}[ids]
    rid = None if rid is None else rid.astype(np.int32)
    ref = jr.render_rays(params, jnp.asarray(rays), train=False,
                         ret_pfeat=True, validation=True,
                         ray_id=None if rid is None else jnp.asarray(rid))
    tid = None if rid is None else torch.from_numpy(rid)
    with torch.no_grad():
        ours = tr.render_rays(t(rays), ray_id=tid)
        chunked = tr.predict(t(rays), chunk_rays=10, ray_id=tid)
        other = tr.render_rays(t(rays), ray_id=torch.zeros(24, dtype=torch.long))
    for k in ("rgb_coarse", "depth_coarse", "feat_coarse"):
        np.testing.assert_allclose(ours[k].numpy(), ref[k], atol=1e-4)
    for k in ("rgb_fine", "depth_fine", "pts_fine", "feat_fine"):
        fine_close(ours[k].numpy(), ref[k])
        assert torch.equal(chunked[k], ours[k])
    moved = float((other["rgb_fine"] - ours["rgb_fine"]).abs().max())
    assert (moved == 0.0) == (vocab == 1), moved    # row 0 is not row 1
    for k in ("depth_fine", "pts_fine", "feat_fine"):
        assert torch.equal(other[k], ours[k])       # the table reaches rgb only


def test_fused_render_with_app_matches_pallas():
    """``fused_render`` through the kernels' plain versions with per-ray
    appearance rows against JAX ``fused_predict(..., ray_id=...)`` in
    interpret mode (the Pallas kernel's ``app`` operand): 2e-2 on rgb,
    depth and points, 0.1 relative on features, as without ``app``; the
    rows move rgb alike in both packages."""
    jr, params, tr = jax_and_port(app_config(hid=64, pts=128), vocab=2)
    jr.fused_interpret = True
    rays = make_rays(16, 6, nonunit=True)
    rid = (np.arange(16) % 2).astype(np.int32)
    ref = jr.fused_predict(params, jnp.asarray(rays), ray_id=rid)
    ref_flip = jr.fused_predict(params, jnp.asarray(rays), ray_id=1 - rid)
    with torch.no_grad():
        ours = tr.fused_render(t(rays), ray_id=torch.from_numpy(rid))
        flip = tr.fused_render(t(rays), ray_id=torch.from_numpy(1 - rid))
    for k in ("rgb_fine", "depth_fine", "pts_fine", "depth_coarse", "acc_fine"):
        np.testing.assert_allclose(ours[k].numpy(), ref[k], atol=2e-2)
    f_rel = (np.abs(ours["feat_fine"].numpy() - ref["feat_fine"]).max()
             / np.abs(ref["feat_fine"]).max())
    assert f_rel < 0.1, f_rel
    d_ref = np.asarray(ref_flip["rgb_fine"]) - np.asarray(ref["rgb_fine"])
    d_ours = (flip["rgb_fine"] - ours["rgb_fine"]).numpy()
    assert np.abs(d_ref).max() > 1e-2
    np.testing.assert_allclose(d_ours, d_ref, atol=2e-2)
    for k in ("feat_fine", "pts_fine", "weights_fine"):
        assert torch.equal(flip[k], ours[k])


# ---------------------------------------------------------------------------
# The evaluator on a two-sequence scene
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene2(tmp_path_factory):
    """A 4-frame copy of the synthetic scene, frames 2-3 under ``seq-02``;
    an appearance NeRF (two table rows) on it in both packages; its
    reference Lightning ``.ckpt`` (``export_torch_state_dict`` keys under
    ``model.``, the config as ``hyper_parameters``)."""
    root = tmp_path_factory.mktemp("scene2")
    scene = build_scene(root, n_frames=4)
    data = scene["data_dir"]
    (data / "seq-02").mkdir()
    frames = []
    for i, f in enumerate(scene["frames"]):
        if i >= 2:
            name = f["file_path"].replace("seq-01", "seq-02")
            shutil.move(data / f["file_path"], data / name)
            f = dict(f, file_path=name)
        frames.append(f)
    for split in ("train", "test"):
        (data / f"transforms_{split}.json").write_text(
            json.dumps({"frames": frames}))
    cfg = app_config(pts=16)
    cfg.data = dict2namespace({
        "dataset": "NerfBaseDataset", "data_dir": str(root), "scene": "toy",
        "img_wh": [W, H], "ray_type": "mip", "max_frustum_depth": 1,
        "rescale_factor": 1.0, "snorm_type": "fst", "downsample": 1})
    cfg.exp = dict2namespace({"seed": 0})
    jr, params, tr = jax_and_port(cfg, vocab=2, bias=1.0)
    ckpt = root / "chess.ckpt"
    torch.save({"state_dict": {k: torch.as_tensor(v) for k, v in
                               export_torch_state_dict(params).items()},
                "hyper_parameters": vars(cfg)}, ckpt)
    return dict(root=root, cfg=cfg, jr=jr, params=params, tr=tr, ckpt=ckpt,
                frames=frames)


def decoded(path):
    return np.asarray(Image.open(path)).astype(int)


def test_eval_nerf_cli_matches_jax_evaluator(scene2):
    """``cli.eval_nerf`` in its default PSNR mode on the CPU, looping over
    ``--dataset 7scenes`` with ``#scene`` in ``--ckpt`` (only ``chess``
    has a checkpoint: the reference ``.ckpt``; the others are skipped),
    against the JAX evaluator's ``eval_data_loader`` on the same file: PSNR
    per frame within 0.01 dB (both sequences rendered with their own
    table row), the rgb PNGs within 1, the colorized depth PNGs, and
    ``results.npy``."""
    root = scene2["root"]
    args = eval_nerf.build_parser().parse_args(
        ["--ckpt", str(root / "chess.ckpt"), "--img_wh", str(W), str(H),
         "--save_depth", "--device", "cpu"])
    jev = jne.load_nerf_from_ckpt(scene2["ckpt"], args)
    ref = jev.eval_data_loader(None, save_depth=True, cache_dir=root / "jax")
    out = eval_nerf.main(
        ["--ckpt", str(root / "#scene.ckpt"), "--dataset", "7scenes",
         "--img_wh", str(W), str(H), "--save_depth", "--device", "cpu",
         "--cache_dir", str(root / "port" / "#scene")])
    assert list(out) == ["chess"]
    np.testing.assert_allclose(out["chess"]["psnr"], ref["psnr"], atol=1e-2)
    port = root / "port" / "chess"
    res = np.load(port / "results.npy", allow_pickle=True).item()
    assert set(res) == set(np.load(root / "jax" / "results.npy",
                                   allow_pickle=True).item()) == {"psnr"}
    np.testing.assert_allclose(res["psnr"], ref["psnr"], atol=1e-2)
    for f in scene2["frames"]:
        idx = f["file_path"].replace("/", "_").replace(".color", "")[:-4]
        a, b = decoded(port / "rgb" / f"{idx}.png"), decoded(
            root / "jax" / "rgb" / f"{idx}.png")
        assert a.shape == b.shape == (H, W, 3) and np.abs(a - b).max() <= 1
        a, b = decoded(port / "depth" / f"{idx}.png"), decoded(
            root / "jax" / "depth" / f"{idx}.png")
        assert a.shape == b.shape == (H, W, 3)
        assert np.mean(np.abs(a - b) <= 1) > 0.98 and np.abs(a - b).max() <= 5
    # The two sequences render with different rows: the same frame's PSNR
    # under the other id differs.
    tev = load_nerf_from_ckpt(scene2["ckpt"], args, device="cpu")
    batch = next(iter(tev.data_loader))
    _, m0 = tev.eval_batch(batch)
    batch["ts"] = 1 - batch["ts"]
    _, m1 = tev.eval_batch(batch)
    assert abs(m0["rgb_fine_psnr"] - m1["rgb_fine_psnr"]) > 1e-2


@pytest.mark.parametrize("ts", ["per_ray", "broadcast"])
def test_eval_batch_ray_ids_match_jax(scene2, ts):
    """``eval_batch`` turns ``ts`` into ray ids as the JAX one: one id a
    ray, or, when the counts differ, the first id for every ray; rgb,
    depth and PSNR against JAX's on the frame of the second sequence."""
    cfg = scene2["cfg"]
    jev = jne.NerfEvaluator(cfg, scene2["jr"], scene2["params"])
    tev = NerfEvaluator(cfg, scene2["tr"])
    jb = list(jev.data_loader)[3]
    tb = list(tev.data_loader)[3]
    assert int(np.asarray(jb["ts"]).reshape(-1)[0]) == 1
    if ts == "broadcast":
        jb = dict(jb, ts=np.asarray(jb["ts"])[:, :5])
        tb = dict(tb, ts=tb["ts"][:, :5])
    ref, ref_m = jev.eval_batch(jb)
    ours, m = tev.eval_batch(tb)
    for k in ("rgb_fine", "depth_fine"):
        assert ours[k].shape == np.shape(ref[k]) == (H, W, ours[k].shape[-1])
        fine_close(ours[k], ref[k])
    np.testing.assert_allclose(ours["rgb_coarse"], ref["rgb_coarse"], atol=1e-4)
    for k in ("rgb_coarse_psnr", "rgb_fine_psnr"):
        assert m[k] == pytest.approx(float(ref_m[k]), abs=1e-2)


def test_cache_scene_pts_with_appearance_matches_jax(scene2, tmp_path):
    """``cache_scene_pts`` of an appearance NeRF (ds 8): ``pt_color``
    follows each frame's ``ts`` as the JAX cache's, within 1e-4, and
    ``pt3d`` / ``pt_feat`` with it."""
    cfg = dict2namespace(namespace2dict(scene2["cfg"]))
    cfg.data.downsample = cfg.downsample = 8
    jdir = jne.NerfEvaluator(cfg, scene2["jr"], scene2["params"]) \
        .cache_scene_pts(cache_dir=tmp_path / "jax", trunk_int8="none")
    tdir = NerfEvaluator(cfg, scene2["tr"]).cache_scene_pts(
        cache_dir=tmp_path / "port")
    for f in scene2["frames"]:
        name = f["file_path"].replace("/", "_").replace(".color", "")[:-4]
        a = np.load(tdir / f"{name}.npy", allow_pickle=True).item()
        b = np.load(jdir / f"{name}.npy", allow_pickle=True).item()
        assert set(a) == set(b)
        for k in ("pt_color", "pt3d", "pt_feat"):
            np.testing.assert_allclose(a[k], b[k], atol=1e-4)


def test_render_single_view_and_scaled_poses_match_jax(scene2, tmp_path):
    """``render_single_view`` (non-unit ray directions, scalar near / far,
    the intrinsics' size, table row 1; also with ``flipped_yz``) and
    ``eval_on_scaled_poses`` (translation x 1.2, decoded PNGs within 1)
    against the JAX evaluator's."""
    cfg = scene2["cfg"]
    jev = jne.NerfEvaluator(cfg, scene2["jr"], scene2["params"])
    tev = NerfEvaluator(cfg, scene2["tr"])
    ds = tev.data_loader.dataset
    pose = np.asarray(ds.cam2s_scenes[1])
    K = np.array([[30.0, 0, 16], [0, 30.0, 16], [0, 0, 1]], np.float32)
    for flip in (False, True):
        ref, ref_p = jev.render_single_view(pose, K, near=0.01,
                                            flipped_yz=flip)
        ours, ours_p = tev.render_single_view(pose, K, near=0.01,
                                              flipped_yz=flip)
        assert ours.shape == (32, 32, 3)
        fine_close(ours, ref)
        np.testing.assert_allclose(ours_p["depth_coarse"],
                                   ref_p["depth_coarse"], atol=1e-4)
    jev.cache_dir, tev.cache_dir = tmp_path / "jax", tmp_path / "port"
    jdir = jev.eval_on_scaled_poses(pose_scale=1.2)
    tdir = tev.eval_on_scaled_poses(pose_scale=1.2)
    names = sorted(p.name for p in jdir.iterdir())
    assert names == sorted(p.name for p in tdir.iterdir()) and len(names) == 4
    for n in names:
        assert np.abs(decoded(tdir / n) - decoded(jdir / n)).max() <= 1


@pytest.mark.parametrize("kind", ["port_dir", "reference_ckpt"])
def test_checkpoints_with_the_table_load(scene2, tmp_path, kind):
    """A port checkpoint directory and a reference ``.ckpt`` holding the
    appearance table load strictly into a renderer whose vocab is read
    from the stored table; the reference file's config comes from its
    ``hyper_parameters``."""
    tr = scene2["tr"]
    if kind == "port_dir":
        path = save_checkpoint(tmp_path, 1, tr,
                               config=namespace2dict(scene2["cfg"]))
    else:
        path = scene2["ckpt"]
    loaded, cfg = load_renderer(path, stop_layer=3)
    assert loaded.embedding_a.weight.shape == (2, 16)
    assert cfg.embedding.appearance_embed
    for k, v in tr.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
