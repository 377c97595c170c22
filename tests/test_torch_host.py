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
