"""NeRF evaluation CLI (counterpart of ``nerfmatch_tpu/cli/eval_nerf.py``),
the scene-point cache mode:

    python -m nerfmatch_tpu_torch.cli.eval_nerf --ckpt <run>/checkpoints/last_N \\
        --cache_scene_pts --downsample 8 --split train --stop_layer 3 \\
        --cache_dir <dir>

writes ``<dir>/ds8lin/<frame>.npy`` for every frame of the split.  The
test-split PSNR render and the scaled-pose mode are not ported and raise.
"""

from __future__ import annotations

import argparse

from ..eval.nerf_evaluator import load_nerf_from_ckpt


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
    p.add_argument("--cache_scene_pts", action="store_true")
    p.add_argument("--nums", type=int, default=-1)
    p.add_argument("--stop_layer", type=int, default=3)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu.")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.cache_scene_pts:
        raise NotImplementedError("only --cache_scene_pts is ported (the PSNR "
                                  "render: ROADMAP, NeRF evaluator)")
    evaluator = load_nerf_from_ckpt(args.ckpt, args, frame_num=args.nums,
                                    device=args.device)
    return evaluator.cache_scene_pts(cache_dir=args.cache_dir,
                                     feat_comb=args.feat_comb,
                                     debug=args.debug)


if __name__ == "__main__":
    main()
