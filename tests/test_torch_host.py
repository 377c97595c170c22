"""The port's host-side helpers against the JAX package's: YAML configs (with
the ``inherit`` splice) and the host PnP + RANSAC solver."""

from pathlib import Path

import numpy as np
import pytest
import yaml

from nerfmatch_tpu.config import load_yaml_config as jax_load_yaml_config
from nerfmatch_tpu.config import merge_configs as jax_merge_configs
from nerfmatch_tpu.pose import estimate_pose as jax_estimate_pose
from nerfmatch_tpu_torch.config import (dict2namespace, load_yaml_config,
                                        merge_configs, namespace2dict,
                                        save_config)
from nerfmatch_tpu_torch.pose import estimate_pose

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs").rglob("*.yaml"))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_load_yaml_config_matches_jax(path, tmp_path):
    """Same namespace and dict as the JAX loader (one level of parent
    splice: a grandparent's ``inherit`` entry stays, as in JAX), and
    ``save_config`` writes that dict."""
    ns, raw = load_yaml_config(path)
    jns, jraw = jax_load_yaml_config(path)
    assert raw == jraw
    assert namespace2dict(ns) == namespace2dict(jns) == jraw
    save_config(tmp_path / "c.yaml", ns)
    assert yaml.safe_load((tmp_path / "c.yaml").read_text()) == raw
    extra = dict2namespace({"exp": {"seed": 3}, "debug": True})
    assert namespace2dict(merge_configs(ns, extra)) == namespace2dict(
        jax_merge_configs(jns, extra))


def pnp_problem(seed, n=200, outliers=0.3):
    rng = np.random.default_rng(seed)
    K = np.array([[500.0, 0, 240], [0, 500.0, 240], [0, 0, 1]])
    ang = rng.normal(size=3) * 0.3
    th = np.linalg.norm(ang)
    k = ang / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    t = rng.normal(size=3) * 0.2
    cam = rng.uniform([-1, -1, 2], [1, 1, 5], (n, 3))
    pts3d = (cam - t) @ R                      # world points: R^T (cam - t)
    pts2d = cam[:, :2] / cam[:, 2:] * 500 + 240 + rng.normal(size=(n, 2)) * 0.5
    bad = rng.random(n) < outliers
    pts2d[bad] = rng.uniform(0, 480, (bad.sum(), 2))
    return pts2d, pts3d, K, R, t


@pytest.mark.parametrize("seed", [0, 1])
def test_estimate_pose_matches_jax_package(seed):
    """The port's copy of the C++ solver gives the JAX package's pose and
    inliers on the same correspondences, close to the true pose."""
    pts2d, pts3d, K, R, t = pnp_problem(seed)
    got = estimate_pose(pts2d, pts3d, K, ransac_thres=2.0, seed=seed)
    want = jax_estimate_pose(pts2d, pts3d, K, ransac_thres=2.0, seed=seed)
    np.testing.assert_allclose(got[0], want[0], atol=1e-9)
    np.testing.assert_allclose(got[1], want[1], atol=1e-9)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], R, atol=1e-2)
    np.testing.assert_allclose(got[1], t, atol=1e-2)
    assert estimate_pose(pts2d[:3], pts3d[:3], K) is None


def test_resolve_device_turns_tf32_off(monkeypatch):
    """Every entry point resolves its device through ``resolve_device``,
    which leaves cuBLAS and cuDNN TF32 off whatever the caller had set."""
    import torch

    from nerfmatch_tpu_torch.utils import resolve_device

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """With CUDA hidden, the port's entry points raise unless the caller
    asks for the CPU, instead of carrying on there."""
    import torch

    from nerfmatch_tpu_torch.cli import eval_nerf
    from nerfmatch_tpu_torch.eval.match_evaluator import NeRFMatchEvaluator
    from nerfmatch_tpu_torch.eval.nerf_evaluator import (
        load_nerf_from_ckpt, load_nerf_render_from_ckpt)
    from nerfmatch_tpu_torch.train.matcher_trainer import train_c2f
    from nerfmatch_tpu_torch.train.nerf_trainer import NerfTrainer, train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nerf, _ = load_yaml_config(ROOT / "configs/nerf/nerf_7scenes_mip_sfm.yaml")
    c2f, _ = load_yaml_config(
        ROOT / "configs/nerfmatch/nerfmatch_7scenes_sfm_c2f.yaml")
    nerf.exp.odir = c2f.exp.odir = str(tmp_path / "out")
    for call in (lambda: train(nerf), lambda: NerfTrainer(nerf),
                 lambda: NeRFMatchEvaluator(c2f), lambda: train_c2f(c2f),
                 lambda: load_nerf_from_ckpt(tmp_path),
                 lambda: load_nerf_render_from_ckpt(tmp_path, serving=True),
                 lambda: eval_nerf.main(["--ckpt", str(tmp_path),
                                         "--cache_scene_pts"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not (tmp_path / "out").exists()
    mini = dict2namespace({"exp": {"seed": 0}, "data": {}, "model": {
        "backbone": "tiny", "pretrained": False, "cfeat_dim": 32,
        "pt_dim": 16, "im_pe": True, "im_sa": 0, "im_sa_type": None,
        "pt_sa": 0, "pt_sa_type": None, "pt_pe": False, "coarse_layers": 0,
        "temp_type": "mul"}})
    ev = NeRFMatchEvaluator(mini, device="cpu")
    assert ev.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in ev.model.parameters())


def test_new_modules_import_and_run_without_jax():
    """A fresh interpreter imports every module of the port (the int8
    trunk, the localization evaluator, the benchmark CLI and the e2e
    modules included), then
    calibrates and runs an int8 render stage on the CPU, without importing
    jax, the JAX package or its ``scripts``."""
    import subprocess
    import sys

    code = f"""
import pkgutil, sys, importlib, torch
sys.path.insert(0, {str(ROOT)!r})
import nerfmatch_tpu_torch
for m in pkgutil.walk_packages(nerfmatch_tpu_torch.__path__, 'nerfmatch_tpu_torch.'):
    importlib.import_module(m.name)
from nerfmatch_tpu_torch.config import dict2namespace
from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer
from nerfmatch_tpu_torch.cli.benchmark_nerfmatch import build_parser
import nerfmatch_tpu_torch.parallel.distributed, nerfmatch_tpu_torch.parallel.mesh
import nerfmatch_tpu_torch.parallel.point_sharding
import nerfmatch_tpu_torch.parallel.pair_sharding
import nerfmatch_tpu_torch.parallel.render_sharding
import nerfmatch_tpu_torch.e2e.scene, nerfmatch_tpu_torch.e2e.pipeline
import nerfmatch_tpu_torch.e2e.parity_artifacts, nerfmatch_tpu_torch.e2e.ladder
import nerfmatch_tpu_torch.e2e.gates
mlp = dict(layer_num=8, hid_dim=64, skips=[4], num_pts=32, output_dim=4)
cfg = dict2namespace(dict(render=dict(use_viewdirs=True, white_bg=False,
                                      trunk_int8='coarse'),
    embedding=dict(xyz_num_freqs=15, dirs_num_freqs=4, type='mip'),
    coarse_nerf=dict(mlp), fine_nerf=dict(mlp)))
r = NerfRenderer(cfg, stop_layer=3).init_params(torch.Generator().manual_seed(0))
rays = torch.cat([torch.zeros(4, 3), torch.tensor([[0., 0., 1.]]).repeat(4, 1),
                  torch.tensor([[0.1, 1.0]]).repeat(4, 1),
                  torch.tensor([[0., 0., 1.]]).repeat(4, 1),
                  torch.full((4, 1), 1e-3)], -1)
with torch.no_grad():
    r.calibrate_int8(rays)
    out = r.fused_render(rays)
assert torch.isfinite(out['feat_fine']).all()
assert build_parser().parse_args(['--iters', '2']).device == 'cuda'
assert not any(m.split('.')[0] in ('jax', 'nerfmatch_tpu', 'scripts')
               for m in sys.modules)
print('OK')
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
