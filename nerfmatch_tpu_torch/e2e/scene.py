"""A view-consistent synthetic scene (counterpart of
``scripts/e2e_full_pipeline_tpu.py:47-181``): a ball with banded
normal-coloured texture rendered analytically through the dataset's own
camera and ray conventions, so images, annotations and projections agree by
construction.

* ``enclosed``: the ball sits inside a textured shell, so every camera ray
  ends on geometry (the 7-Scenes depth profile; the early-termination gate
  needs it).
* ``app_seqs`` > 0: the Cambridge-style variant, the training views spread
  round-robin over that many sequence dirs, each at its own exposure
  (``default_rng(7)``, 0.75-1.25), so only a per-sequence appearance
  embedding fits all of them; the queries keep sequence 1's.

``build_scene`` writes the frames, ``transforms_{train,val,test}.json``
(test holds every frame: the cache stage renders them all) and the pair
files (each training view with its next two; each query with its two
nearest training views).

    python -m nerfmatch_tpu_torch.e2e.scene ROOT [--enclosed] [--app_seqs 4]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
from PIL import Image

from ..data.nerf_dataset import ray_dirs_np, rays_c2w_np
from ..utils import resolve_device

W = H = 128
DS = 8
FOCAL = 160.0
CAM_R = 2.0
BALL_R = 0.7
SHELL_R = 3.2
N_TRAIN, N_TEST = 24, 6


def look_at(eye):
    """c2w (4, 4) of a camera at ``eye`` looking at the origin."""
    eye = np.asarray(eye, float)
    fwd = -eye / np.linalg.norm(eye)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up2, fwd, eye
    return c2w


def ball_image(K, c2w, enclosed: bool = False):
    """(H, W, 3) image in [0, 1] and the (H, W) mask of ball pixels."""
    dirs = ray_dirs_np(H, W, np.asarray(K, np.float64))
    o, d, vdirs = rays_c2w_np(dirs, np.asarray(c2w, np.float64)[:3])
    o = np.broadcast_to(o, vdirs.shape).reshape(-1, 3)
    dn = np.asarray(vdirs).reshape(-1, 3)
    b = np.sum(o * dn, axis=-1)
    c = np.sum(o * o, axis=-1) - BALL_R**2
    disc = b * b - c
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    hit = (disc > 0) & (t > 0)
    p = o + t[:, None] * dn
    normal = p / BALL_R
    if enclosed:
        # Rays past the ball end on the shell: its inward normal times a
        # positional pattern, textured for the matcher.
        t_sh = -b + np.sqrt(np.maximum(
            b * b - (np.sum(o * o, -1) - SHELL_R**2), 0.0))
        q = o + t_sh[:, None] * dn
        n_in = -q / SHELL_R
        mod = 0.6 + 0.4 * np.sin(2.5 * q[:, 0:1]) * np.cos(2.5 * q[:, 2:3])
        bg = np.clip((0.5 * n_in + 0.5) * mod, 0, 1)
    else:
        bg = 0.02
    rgb = np.where(hit[:, None],
                   0.35 + 0.3 * normal + 0.25 * np.sin(6.0 * p),
                   bg)
    return np.clip(rgb, 0, 1).reshape(H, W, 3), hit.reshape(H, W)


def build_scene(root, app_seqs: int = 0, enclosed: bool = False):
    """Write the scene under ``root`` (frames and annotations in
    ``root/toy``, pair files in ``root``) -> ``root``."""
    root = Path(root)
    data_dir = root / "toy"
    K = [[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]]
    n_seq = max(app_seqs, 1)
    rng = np.random.default_rng(7)
    exposures = (1.0 if n_seq == 1
                 else rng.uniform(0.75, 1.25, n_seq).round(3))
    for s in range(n_seq):
        (data_dir / f"seq-{s + 1:02d}").mkdir(parents=True, exist_ok=True)

    def frames_for(angles, tag, seq_of=lambda i: 0):
        frames = []
        for i, ang in enumerate(angles):
            eye = [CAM_R * np.cos(ang), 0.6 * np.sin(2 * ang),
                   CAM_R * np.sin(ang)]
            c2w = look_at(eye)
            s = seq_of(i)
            fname = f"seq-{s + 1:02d}/frame-{tag}{i:03d}.color.png"
            img, hit = ball_image(np.asarray(K), c2w, enclosed)
            expo = exposures if n_seq == 1 else exposures[s]
            img = np.clip(img * expo, 0, 1)
            Image.fromarray((img * 255).astype(np.uint8)).save(
                data_dir / fname)
            frames.append(dict(file_path=fname, intrinsics=K, height=H,
                               width=W, transform_matrix=c2w.tolist(),
                               ball_frac=float(hit.mean())))
        return frames

    tr_ang = np.linspace(0, 2 * np.pi, N_TRAIN, endpoint=False)
    te_ang = tr_ang[:N_TEST] + (tr_ang[1] - tr_ang[0]) * 0.43
    # Round-robin sequences: each exposure is seen from all sides.
    train_frames = frames_for(tr_ang, "t", seq_of=lambda i: i % n_seq)
    test_frames = frames_for(te_ang, "q")
    if n_seq > 1:
        print(f"scene: {n_seq} sequences, exposures {list(exposures)}")
    print(f"scene: ball covers "
          f"{np.mean([f['ball_frac'] for f in train_frames]):.0%} of a view")
    for f in train_frames + test_frames:
        f.pop("ball_frac")

    # The test json holds every frame (the cache stage renders them all);
    # the matcher's queries come from the pair files.
    for split, fr in [("train", train_frames), ("val", test_frames),
                      ("test", train_frames + test_frames)]:
        (data_dir / f"transforms_{split}.json").write_text(
            json.dumps({"frames": fr}))

    lines = []
    for i in range(N_TRAIN):
        for di in (1, 2):
            lines.append(f"{train_frames[i]['file_path']} "
                         f"{train_frames[(i + di) % N_TRAIN]['file_path']}")
    (root / "pairs_train.txt").write_text("\n".join(lines))
    lines = []
    for i in range(N_TEST):
        for di in (0, 1):
            lines.append(f"{test_frames[i]['file_path']} "
                         f"{train_frames[(i + di) % N_TRAIN]['file_path']}")
    (root / "pairs_test.txt").write_text("\n".join(lines))
    return root


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("root", type=Path)
    p.add_argument("--enclosed", action="store_true")
    p.add_argument("--app_seqs", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu, as every e2e entry point")
    args = p.parse_args(argv)
    resolve_device(args.device)
    return build_scene(args.root, args.app_seqs, args.enclosed)


if __name__ == "__main__":
    main()
