"""NeRF evaluation CLI (counterpart of ``nerfmatch_tpu/cli/eval_nerf.py``).
The default mode renders the split and scores its PSNR:

    python -m nerfmatch_tpu_torch.cli.eval_nerf --ckpt <run>/checkpoints/last_N \\
        --split test --img_wh 480 480 --downsample 1 --save_depth

writes ``rgb/<idx>.png`` (and ``depth/<idx>.png``) and ``results.npy``
under ``--cache_dir`` (default: beside the checkpoint).
``--cache_scene_pts --downsample 8 --stop_layer 3`` writes the scene-point
cache ``<dir>/ds8lin/<frame>.npy``; ``--scale_pose S`` renders the split
from scaled poses.  ``--dataset cambridge|7scenes`` runs every scene of the
dataset whose checkpoint exists, with ``#scene`` in ``--ckpt`` and
``--cache_dir`` standing for the scene's name.  ``--ckpt`` takes a port
checkpoint directory or a reference Lightning ``.ckpt``.
"""

from __future__ import annotations

import argparse
import os

from ..data.loading import CAMBRIDGE_LANDMARKS, SEVEN_SCENES
from ..eval.nerf_evaluator import load_nerf_from_ckpt

SCENES = {"cambridge": CAMBRIDGE_LANDMARKS, "7scenes": SEVEN_SCENES}


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--cache_dir", type=str, default=None)
    p.add_argument("--scene_anno_path", type=str, default=None)
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--feat_comb", type=str, default="lin")
    p.add_argument("--img_wh", type=int, nargs=2, default=[480, 480],
                   metavar=("W", "H"))
    p.add_argument("--downsample", type=int, default=1)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--dataset", type=str, default=None, choices=sorted(SCENES))
    p.add_argument("--scale_pose", type=float, default=None)
    p.add_argument("--cache_scene_pts", action="store_true")
    p.add_argument("--save_depth", action="store_true")
    p.add_argument("--mask", action="store_true")
    p.add_argument("--nums", type=int, default=-1)
    p.add_argument("--stop_layer", type=int, default=3)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu.")
    return p


def run_one(args):
    evaluator = load_nerf_from_ckpt(args.ckpt, args, mask=args.mask,
                                    frame_num=args.nums, device=args.device)
    if args.cache_scene_pts:
        return evaluator.cache_scene_pts(cache_dir=args.cache_dir,
                                         feat_comb=args.feat_comb,
                                         debug=args.debug)
    if args.scale_pose:
        return evaluator.eval_on_scaled_poses(pose_scale=args.scale_pose,
                                              debug=args.debug)
    return evaluator.eval_data_loader(None, save_depth=args.save_depth,
                                      cache_dir=args.cache_dir,
                                      debug=args.debug)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.dataset:
        return run_one(args)
    ckpt, cache_dir = args.ckpt, args.cache_dir
    out = {}
    for scene in SCENES[args.dataset]:
        args.ckpt = ckpt.replace("#scene", scene)
        args.cache_dir = cache_dir.replace("#scene", scene) if cache_dir else None
        if os.path.exists(args.ckpt):
            out[scene] = run_one(args)
        else:
            print(f"eval_nerf: skipping {scene}: no checkpoint at {args.ckpt}")
    if not out:
        raise SystemExit(f"eval_nerf: no checkpoint matched {ckpt!r} for any "
                         f"{args.dataset} scene; check the --ckpt template")
    return out


if __name__ == "__main__":
    main()
