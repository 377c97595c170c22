"""Port parity: the annotation generators, the scene-cache reader, the
quaternion helpers and the host pose refinement against the JAX package.

Each generator runs on the fixture layouts of ``tests/test_data.py`` (a
7-Scenes scene, SfM pseudo-GT text, a Cambridge NVM reconstruction) in both
packages; the JSON files are equal, floats at 1e-6.
"""

import json

import numpy as np
import pytest

from nerfmatch_tpu.data import loading as jl
from nerfmatch_tpu.utils import geometry as jgeo

from nerfmatch_tpu_torch.data import loading as tl
from nerfmatch_tpu_torch.utils import geometry as tgeo


def assert_json_equal(a, b, path=""):
    """Nested JSON values equal, floats at 1e-6."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            assert_json_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_json_equal(x, y, f"{path}/{i}")
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= 1e-6, (path, a, b)
    else:
        assert a == b, (path, a, b)


def assert_dirs_equal(ours, ref):
    names = sorted(p.name for p in ref.glob("*.json"))
    assert names and sorted(p.name for p in ours.glob("*.json")) == names
    for n in names:
        assert_json_equal(json.loads((ours / n).read_text()),
                          json.loads((ref / n).read_text()))


def seven_scenes_layout(root):
    """Two scenes of the 7-Scenes layout: poses in two train sequences and
    one test sequence, a comment line in a split file."""
    rng = np.random.default_rng(0)
    for scene in ("heads", "fire"):
        d = root / scene
        for seq in (1, 2, 3):
            (d / f"seq-0{seq}").mkdir(parents=True)
            for i in range(3):
                q = rng.normal(size=4) + [2.0, 0.0, 0.0, 0.0]
                pose = np.eye(4)
                pose[:3, :3] = tgeo.qvec2rotmat(q / np.linalg.norm(q))
                pose[:3, 3] = rng.normal(size=3)
                np.savetxt(d / f"seq-0{seq}" / f"frame-{i:06d}.pose.txt", pose)
        (d / "TrainSplit.txt").write_text("# splits\nsequence1\nsequence2\n")
        (d / "TestSplit.txt").write_text("sequence3\n")


def test_generate_7scenes_annotations_match_jax(tmp_path):
    """generate_7scenes_annotations over two scenes, then again without
    ``overwrite`` (the files stay) and with it."""
    seven_scenes_layout(tmp_path)
    jl.generate_7scenes_annotations(tmp_path, tmp_path / "jax")
    tl.generate_7scenes_annotations(tmp_path, tmp_path / "port")
    assert_dirs_equal(tmp_path / "port", tmp_path / "jax")
    assert len(list((tmp_path / "port").glob("*.json"))) == 4
    stale = tmp_path / "port" / "transforms_heads_test.json"
    stale.write_text('{"frames": []}')
    tl.generate_7scenes_annotations(tmp_path, tmp_path / "port")
    assert stale.read_text() == '{"frames": []}'
    tl.generate_7scenes_annotations(tmp_path, tmp_path / "port", overwrite=True)
    assert_dirs_equal(tmp_path / "port", tmp_path / "jax")


def test_convert_7scenes_pgt_annotations_match_jax(tmp_path):
    """SfM pseudo-GT lines with and without a focal, and a short line that
    is skipped."""
    rng = np.random.default_rng(1)
    pgt = tmp_path / "pgt"
    pgt.mkdir()
    for name in ("heads_train", "heads_test"):
        lines = []
        for i in range(4):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            vals = " ".join(f"{v:.9f}" for v in (*q, *rng.normal(size=3)))
            focal = f" {520 + i}.5" if i % 2 else ""
            lines.append(f"seq-01/frame-{i:06d}.color.png {vals}{focal}")
        lines.append("seq-01/broken.png 1 0 0")
        (pgt / f"{name}.txt").write_text("\n".join(lines) + "\n")
    jl.convert_7scenes_pgt_annotations(pgt, tmp_path / "jax")
    tl.convert_7scenes_pgt_annotations(pgt, tmp_path / "port")
    assert_dirs_equal(tmp_path / "port", tmp_path / "jax")


def cambridge_layout(root):
    d = root / "ShopFacade"
    d.mkdir(parents=True)
    ang = np.pi / 6
    q1 = [np.cos(ang / 2), 0.0, 0.0, np.sin(ang / 2)]
    rows = [
        f"seq1/frame1.jpg 744.4 {q1[0]} {q1[1]} {q1[2]} {q1[3]} 1 2 3 0 0",
        "seq1/frame2.jpg 600.0 1 0 0 0 0.5 0 -0.5 0 0",
        "seq1/frame3.jpg 600.0 1 0 0 0 1e6 0 0 0 0",
        "seq1/frame4.jpg 610.0 0.9 0.1 0.3 0.2 -2e6 -3e6 1 0 0",
    ]
    (d / "reconstruction.nvm").write_text(
        "NVM_V3\n\n" + f"{len(rows)}\n" + "\n".join(rows) + "\n")
    header = "h1\nh2\nh3\n"
    (d / "dataset_train.txt").write_text(
        header + "seq1/frame1.png x\nseq1/frame3.png x\nseq1/frame4.png x\n")
    (d / "dataset_test.txt").write_text(header + "seq1/frame2.png x\n")
    return d


@pytest.mark.parametrize("cache", [False, True])
def test_cambridge_annotations_match_jax(tmp_path, cache):
    """parse_cambridge_nvm (the ill-posed camera dropped, the large
    negative-only one kept, as the reference's filter) and
    generate_cambridge_annotations, into the scene dirs or a cache dir."""
    d = cambridge_layout(tmp_path)
    ours, ref = (tl.parse_cambridge_nvm(d / "reconstruction.nvm"),
                 jl.parse_cambridge_nvm(d / "reconstruction.nvm"))
    assert_json_equal(ours, ref)
    assert sorted(ours) == ["seq1/frame1.png", "seq1/frame2.png",
                            "seq1/frame4.png"]
    if cache:
        jl.generate_cambridge_annotations(tmp_path, tmp_path / "jax")
        tl.generate_cambridge_annotations(tmp_path, tmp_path / "port")
        assert_dirs_equal(tmp_path / "port", tmp_path / "jax")
    else:
        tl.generate_cambridge_annotations(tmp_path)
        ours = {s: json.loads((d / f"transforms_{s}.json").read_text())
                for s in ("train", "test")}
        jl.generate_cambridge_annotations(tmp_path)
        for s, v in ours.items():
            assert_json_equal(v, json.loads((d / f"transforms_{s}.json")
                                            .read_text()))


def test_load_scene_cache_matches_jax(tmp_path):
    """load_scene_cache: every frame's points and colors in glob order,
    masked and not, a frame with a cached mask among them."""
    from _synthetic import build_scene

    scene = build_scene(tmp_path)
    cache = scene["cache_dir"]
    first = sorted(cache.glob("*.npy"))[0]
    data = np.load(first, allow_pickle=True).item()
    data["mask"] = np.arange(len(data["pt3d"])) % 3 == 0
    np.save(first, data, allow_pickle=True)
    for masked in (True, False):
        ours, ref = (tl.load_scene_cache(cache, masked),
                     jl.load_scene_cache(cache, masked))
        for a_list, b_list in zip(ours, ref):
            assert len(a_list) == len(b_list) == len(scene["frames"])
            for a, b in zip(a_list, b_list):
                np.testing.assert_array_equal(a, b)


def test_quaternions_and_pose_refinement_match_jax():
    """qvec2rotmat / rotmat2qvec at 1e-12; refine_pose_native from a
    perturbed pose and estimate_pose_pycolmap against the JAX host solver
    on the same noisy correspondences at 1e-9 (the same C++ source)."""
    from nerfmatch_tpu import pose as jpose
    from nerfmatch_tpu_torch import pose as tpose

    rng = np.random.default_rng(3)
    for _ in range(5):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        np.testing.assert_allclose(tgeo.qvec2rotmat(q), jgeo.qvec2rotmat(q),
                                   atol=1e-12)
        R = tgeo.qvec2rotmat(q)
        np.testing.assert_allclose(tgeo.rotmat2qvec(R), jgeo.rotmat2qvec(R),
                                   atol=1e-12)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    R = tgeo.qvec2rotmat([0.95, 0.1, -0.2, 0.2] / np.linalg.norm(
        [0.95, 0.1, -0.2, 0.2]))
    t = np.array([0.1, -0.2, 4.0])
    pts3d = rng.uniform(-1, 1, (60, 3))
    cam = pts3d @ R.T + t
    pts2d = cam[:, :2] / cam[:, 2:] * 500.0 + [320, 240]
    pts2d += rng.normal(scale=0.5, size=pts2d.shape)
    R0, t0 = tgeo.qvec2rotmat([1, 0.03, 0.0, -0.02]) @ R, t + 0.05
    a = tpose.refine_pose_native(pts2d, pts3d, K, R0, t0)
    b = jpose.refine_pose_native(pts2d, pts3d, K, R0, t0)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, atol=1e-9)
    assert np.abs(a[1] - t).max() < np.abs(t0 - t).max()
    a = tpose.estimate_pose_pycolmap(pts2d, pts3d, K, img_wh=(640, 480),
                                     ransac_thres=2.0, center_subpixel=True)
    b = jpose.estimate_pose_pycolmap(pts2d, pts3d, K, img_wh=(640, 480),
                                     ransac_thres=2.0, center_subpixel=True)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, atol=1e-9)
