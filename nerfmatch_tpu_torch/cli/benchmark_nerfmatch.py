"""Localization benchmark CLI (counterpart of
``nerfmatch_tpu/cli/benchmark_nerfmatch.py``): checkpoint globbing by
feature-layer dir and model name, multi-seed runs, the eval flag surface,
tag-keyed result files and cross-run score aggregation
(``merge_scene_metrics``).

    python -m nerfmatch_tpu_torch.cli.benchmark_nerfmatch --ckpts <ckpt> \\
        --nerf_path <nerf ckpt, $scene placeholder> --iters 2 --mutual \\
        --rthres 10 --eval_bs 2

Runs on the GPU (``--device cpu`` for the CPU); the re-render and iNeRF's
coarse pass serve the NeRF's int8 mode (``serving_int8_mode``).  ``--inerf``
(with ``--inerf_optim``, ``--inerf_lr``, ``--inerf_lrd``, ``--inerf_ds``,
``--inerf_pose``, ``--inerf_match_loss``), ``--query2query``,
``--no_cache_pt``, ``--retrieval_only`` and ``--match_oracle`` localize one
query a batch, and so does ``--pair_topk K > 1`` (``NeRFMatchMultiPair``:
each query against its K retrieved frames' points, stacked, or merged with
``--sample_mode rand --sample_pts N``).  ``--visualize`` (bs=1 whatever
``--eval_bs`` says) writes a GIF of iNeRF's overlay frames for each query
over 50 cm under ``<cache dir>/visualization/<scene>/``.  ``--point_shard``
and ``--pair_shard`` split matching over the local GPUs (one process; on one
GPU they change nothing).
"""

from __future__ import annotations

import argparse
from argparse import Namespace
from collections import defaultdict
from pathlib import Path

import numpy as np

from ..eval.match_evaluator import load_nerfmatch_from_ckpt
from ..utils.metrics import (POSE_THRES, average_pose_metrics,
                             summarize_pose_statis)


def merge_scene_metrics(cache_root, scenes, conf="rth10test_coarse_colmap",
                        runs=("results",), feats=None, print_out=False):
    """Aggregate cached per-scene results across feature dirs and runs."""
    scores = defaultdict(list)
    feats = feats or ["pt3d", "pe3d"] + [f"layer{i}" for i in range(1, 8)]
    for feat in feats:
        feat_dir = Path(cache_root) / feat
        if not feat_dir.exists():
            continue
        for tag in runs:
            metr_all = []
            for scene in scenes:
                cache_path = feat_dir / tag / f"{scene}_{conf}.npy"
                if not cache_path.exists():
                    continue
                metrics = np.load(cache_path, allow_pickle=True).item()
                metr_all.append(summarize_pose_statis(
                    metrics, pose_thres=POSE_THRES.get(scene, [(5, 5)]),
                    t_unit="cm", t_scale=1e2, print_out=print_out))
            if metr_all:
                cells = ["/".join(f"{f[k]:.1f}" for k in
                                  ("t_med", "r_med", "recall"))
                         for f in metr_all]
                print(f"{feat}/{tag}: {cells}")
                for k, v in average_pose_metrics(metr_all).items():
                    scores[k].append(v)
    if not scores:
        # The result tag always carries an iteration suffix (_itr<N>).
        print(f"merge_scene_metrics: NO cache files matched "
              f"'*_{conf}.npy' under {cache_root} (did you forget the "
              f"'_itr<N>' suffix in conf?)")
    return scores


def eval_ckpt(args):
    evaluator = load_nerfmatch_from_ckpt(args.ckpt, args, arg_mask=args.mask,
                                         device=args.device)
    if not evaluator.coarse_only:
        evaluator.coarse_only = args.coarse_only

    data_conf = Namespace()
    if args.pair_topk > 1:
        data_conf = Namespace(dataset="NeRFMatchMultiPair",
                              sample_mode=args.sample_mode,
                              sample_pts=args.sample_pts,
                              pair_topk=args.pair_topk)
    if args.scene and "allscenes" in args.ckpt:
        data_conf.scenes = [args.scene]
    if args.scene_anno_path:
        data_conf.scene_anno_path = args.scene_anno_path
    inerf_conf = None
    if args.inerf:
        inerf_conf = Namespace(num_optim=args.inerf_optim, lrate=args.inerf_lr,
                               lrdecay=args.inerf_lrd,
                               eval_pose=args.inerf_pose, ds=args.inerf_ds,
                               use_match_loss=args.inerf_match_loss)
    return evaluator.eval_multi_scenes(
        rthres=args.rthres, center_subpixel=args.center_subpixel,
        solver=args.solver, split=args.split, mutual=args.mutual,
        match_thres=args.match_thres, iters=args.iters,
        nerf_path=args.nerf_path, test_pair_txt=args.test_pair_txt,
        scene_dir=args.scene_dir, data_conf=data_conf,
        query2query=args.query2query, ow_cache=args.ow_cache,
        inerf_conf=inerf_conf, debug=args.debug,
        cached_pt=not args.no_cache_pt, cache_dir=args.cache_dir,
        cache_iters=args.cache_iters, retrieval_only=args.retrieval_only,
        match_oracle=args.match_oracle, seed=args.seed,
        visualize=args.visualize, eval_bs=args.eval_bs)


def benchmark(args):
    """Every checkpoint of ``--ckpts`` (or globbed under ``--ckpt_dir``)
    through :func:`eval_ckpt`, once per seed -> list of its results."""
    if args.ckpts:
        ckpts = [Path(c) for c in args.ckpts]
    else:
        ckpt_dir = Path(args.ckpt_dir)
        pattern = (f"{args.model_name}.ckpt" if "allscenes" in str(ckpt_dir)
                   else f"*_{args.model_name}.ckpt")
        ckpts = []
        for k in args.feats or ["*"]:
            ckpts += list(ckpt_dir.glob(f"{k}/{pattern}"))
        if args.scene:
            ckpts = [c for c in ckpts if args.scene in str(c)]
    print(f"Found {len(ckpts)} ckpts.")

    cache_tag = f"{args.cache_tag}_" if args.cache_tag else ""
    if args.model_name != "best":
        cache_tag += f"{args.model_name}_"
    results = []
    for ckpt in ckpts:
        args.ckpt = str(ckpt)
        runs = list(enumerate(args.seeds)) or [(None, None)]
        for i, seed in runs:
            args.cache_dir = ckpt.parent / (f"{cache_tag}run{i}" if seed is not None
                                            else f"{cache_tag}results")
            args.seed = seed
            results.append(eval_ckpt(args))
    return results


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--ckpt_dir", type=str, default=None)
    p.add_argument("--scene_anno_path", type=str, default=None)
    p.add_argument("--ckpts", type=str, nargs="*", default=[])
    p.add_argument("--model_name", type=str, default="best_tmed")
    p.add_argument("--coarse_only", action="store_true")
    p.add_argument("--mutual", action="store_true")
    p.add_argument("--query2query", action="store_true")
    p.add_argument("--match_thres", type=float, default=0.0)
    p.add_argument("--ow_cache", action="store_true")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--solver", type=str, default="colmap")
    p.add_argument("--rthres", type=float, default=10)
    p.add_argument("--center_subpixel", action="store_true")
    p.add_argument("--iters", type=int, default=1)
    p.add_argument("--nerf_path", type=str, default=None)
    p.add_argument("--test_pair_txt", type=str, default=None)
    p.add_argument("--scene_dir", type=str, default=None)
    p.add_argument("--dataset", type=str, default=None)
    p.add_argument("--scene", type=str, default=None)
    p.add_argument("--pair_topk", type=int, default=1)
    p.add_argument("--sample_pts", type=int, default=-1)
    p.add_argument("--sample_mode", type=str, default=None)
    p.add_argument("--mask", type=str, default="default")
    p.add_argument("--cache_tag", type=str, default=None)
    p.add_argument("--inerf", action="store_true")
    p.add_argument("--inerf_optim", type=int, default=5)
    p.add_argument("--inerf_lr", type=float, default=0.001)
    p.add_argument("--inerf_lrd", action="store_true")
    p.add_argument("--inerf_ds", type=int, default=8)
    p.add_argument("--inerf_pose", action="store_true")
    p.add_argument("--inerf_match_loss", action="store_true")
    p.add_argument("--cache_iters", action="store_true")
    p.add_argument("--no_cache_pt", action="store_true")
    p.add_argument("--retrieval_only", action="store_true")
    p.add_argument("--match_oracle", action="store_true")
    p.add_argument("--point_shard", action="store_true",
                   help="Split single-pair matching over the local GPUs "
                        "(merged multi-pair point clouds): the coarse dual "
                        "softmax over the POINT axis and, for c2f models, "
                        "the fine stage over the MATCH axis "
                        "(parallel/point_sharding.py; results equal the "
                        "dense path).  One GPU, or points that do not "
                        "divide over the GPUs: the dense path.")
    p.add_argument("--pair_shard", action="store_true",
                   help="Split the pairs of multi-pair matching "
                        "(--pair_topk K > 1) over the local GPUs; one GPU: "
                        "the pairs one after the other.")
    p.add_argument("--visualize", action="store_true",
                   help="a GIF of the iNeRF overlay frames (--inerf) for "
                        "each query over 50 cm")
    p.add_argument("--eval_bs", type=int, default=1,
                   help="queries per matcher / render call (single-shot and "
                        "--iters; results identical); --cache_iters, "
                        "--visualize and the single-query protocols stay at "
                        "bs=1")
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--feats", type=str, nargs="*", default=[])
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu.")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return benchmark(args)


if __name__ == "__main__":
    main()
