"""NeRFMatch localization for the cached-point protocols (counterpart of
``nerfmatch_tpu/eval/match_evaluator.py``).

Per query: match the image against scene points (NeRF descriptors + 3D
points), solve PnP on the host (``nerfmatch_tpu_torch.pose``, C++ through
ctypes), and with ``iters > 1`` re-render the scene points at the pose
estimate and match again.  Single-shot and ``iters > 1``, at bs=1 and at
``eval_bs > 1``.  Batches are dicts of numpy arrays: image (B, H, W, 3),
pt_feat (B, N, C), pt3d (B, N, 3), pt_mask (B, N), im_mask (B, M),
pt2d (B, M, 2), K (B, 3, 3), c2w (B, 4, 4), unnorm_scene (B, 4, 4).

:meth:`NeRFMatchEvaluator.eval_multi_scenes` is the benchmark's scene loop
(``cli/benchmark_nerfmatch``): per scene the NeRF re-render through
``load_nerf_render_from_ckpt(serving=True)``, the ``eval_bs`` batching rule,
per-query timers and a metrics ``.npy`` under the reference's tag name.
iNeRF, multi-pair matching, the match oracle, retrieval-only, query2query,
uncached points and the visualization raise ``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
import time
from argparse import Namespace
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from ..config import dict2namespace, merge_configs
from ..data.loaders import (DataLoader, init_mixed_dataset,
                            init_multiscene_dataset)
from ..models.layers import init_params_
from ..models.matcher_c2f import C2FMatcherConfig, NeRFMatcherMS
from ..models.matcher_coarse import CoarseMatcherConfig, NeRFMatcherCoarse
from ..pose import estimate_pose
from ..train.checkpoint import load_reference_checkpoint
from ..utils import get_logger, resolve_device
from ..utils.geometry import pose_err
from ..utils.metrics import (POSE_THRES, average_pose_metrics,
                             summarize_pose_statis)
from .nerf_evaluator import load_nerf_render_from_ckpt

logger = get_logger(level="INFO", name="nerfmatch_eval")


def _unported(what: str):
    raise NotImplementedError(f"{what} is not ported (ROADMAP: what "
                              f"remains, localization protocols)")


def update_paths(conf, root_dir):
    for k in ("data_dir", "scene_dir", "train_pair_txt", "test_pair_txt"):
        setattr(conf, k, os.path.join(root_dir, getattr(conf, k)))


def parse_nerf_stop_layer(scene_dir: str) -> int:
    """Feature layer from the scene-dir tag (``.../inter_layer3/...``)."""
    parts = str(scene_dir).split("inter_layer")
    if len(parts) == 2:
        return int(parts[1].split("/")[0])
    return -1


def load_nerfmatch_from_ckpt(ckpt_path, args=None, root_dir: str = ".",
                             arg_mask=None, device="cuda"):
    """A :class:`NeRFMatchEvaluator` from a port checkpoint directory or a
    reference Lightning ``.ckpt`` (its hyper-parameters are the config),
    with the JAX loader's config rewrites; on the card unless
    ``device="cpu"``."""
    ckpt_path = str(ckpt_path)
    if (Path(ckpt_path) / "meta.json").exists():
        meta = json.loads((Path(ckpt_path) / "meta.json").read_text())
        config = dict2namespace(meta["config"])
        state = torch.load(Path(ckpt_path) / "model.pt", map_location="cpu",
                           weights_only=True)
    else:
        state, hparams = load_reference_checkpoint(ckpt_path)
        config = dict2namespace(dict(vars(hparams) if isinstance(
            hparams, Namespace) else hparams))
    config.ckpt = ckpt_path
    if getattr(config.data, "datasets", None):
        for _, dt_config in vars(config.data.datasets).items():
            update_paths(dt_config, root_dir)
    else:
        update_paths(config.data, root_dir)
    if args:
        config = merge_configs(config, args)
        if getattr(args, "img_wh", None):
            config.data.img_wh = config.img_wh
        if getattr(args, "pair_topk", None):
            config.data.pair_topk = args.pair_topk
        if getattr(args, "scene_dir", None):
            config.data.scene_dir = args.scene_dir
        if getattr(args, "scene", None):
            config.data.scenes = [args.scene]
        if arg_mask == "no mask":
            config.data.use_msk = False
        elif arg_mask not in (None, "default"):
            config.data.use_msk = arg_mask
    return NeRFMatchEvaluator(config, state_dict=state, device=device)


class NeRFMatchEvaluator:
    def __init__(self, config, state_dict=None, device="cuda",
                 generator: torch.Generator | None = None):
        """``state_dict``: reference-format matcher weights (loaded strictly);
        without it the matcher is initialized from ``generator``.  On the
        card unless ``device="cpu"``."""
        self.device = resolve_device(device)
        self.config = config
        model_conf = config.model
        if hasattr(model_conf, "ffeat_dim"):
            self.model = NeRFMatcherMS(C2FMatcherConfig.from_namespace(model_conf))
            self.coarse_only = False
        else:
            self.model = NeRFMatcherCoarse(
                CoarseMatcherConfig.from_namespace(model_conf))
            self.coarse_only = True
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        else:
            init_params_(self.model, generator or torch.Generator().manual_seed(0))
        self.model.to(self.device).eval()
        self.max_matches = int(getattr(config, "max_matches", 2048))
        ckpt = str(getattr(config, "ckpt", "eval"))
        self.cache_dir = Path(ckpt.replace("checkpoints/", "")
                              .replace(".ckpt", "_eval_results"))
        self.timer = defaultdict(list)

    def _t(self, x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _match(self, image, pt_feat, pt3d, im_mask, pt_mask, mutual,
               match_thres):
        out = self.model.eval_match(
            self._t(image), self._t(pt_feat), self._t(pt3d),
            im_mask=self._t(im_mask), pt_mask=self._t(pt_mask), mutual=mutual,
            match_thres=match_thres, top_k=self.max_matches)
        return {k: (v.cpu().numpy() if torch.is_tensor(v) else
                    {kk: vv.cpu().numpy() for kk, vv in v.items()})
                for k, v in out.items()}

    def _item_matches(self, out, pt2d_all, pt3d, b):
        """Host-side (pt2d, pt3d) correspondences of batch item ``b``."""
        lists = out["lists"]
        valid = lists["valid"][b]
        i_ids = lists["i_ids"][b][valid]
        j_ids = lists["j_ids"][b][valid]
        mpt2d = pt2d_all[b][i_ids]
        if not self.coarse_only:
            M = out["j_ids"].shape[1]
            expec = out["expec_f"].reshape(-1, M, 3)[b][i_ids]
            mpt2d = self.model.fine_coords(
                torch.from_numpy(expec), torch.from_numpy(
                    np.asarray(mpt2d, np.float32))).numpy()
        return mpt2d, pt3d[b][j_ids]

    def _solve_pose(self, pt2d, pt3d, K, c2w_gt, solver, rthres):
        """PnP + pose error -> (c2w_est, R_err, t_err, num_matches)."""
        solver_name = {"colmap": "native", "cv2": "cv", "cv": "cv",
                       "native": "native"}[solver]
        res = estimate_pose(pt2d, pt3d, K, ransac_thres=rthres,
                            solver=solver_name)
        if res is None:
            return None, float("inf"), float("inf"), len(pt2d)
        R, t, _ = res
        w2c = np.eye(4)
        w2c[:3, :3] = R
        w2c[:3, 3] = t
        c2w_est = np.linalg.inv(w2c)
        r_err, t_err = pose_err(np.asarray(c2w_gt, np.float32),
                                c2w_est.astype(np.float32))
        return c2w_est, float(r_err), float(t_err), len(pt2d)

    def eval_batch(self, batch, renderer=None, iters: int = 1,
                   mutual: bool = True, match_thres: float = 0.0,
                   solver: str = "colmap", rthres: float = 1.0,
                   cache_iters: bool = False):
        """Localize every query of ``batch``; ``iters > 1`` re-renders the
        scene points through ``renderer`` at each successful estimate.
        Returns dict(R_err, t_err, num_matches, c2w_est) lists of length B
        (with ``cache_iters``, also iter_R_errs / iter_t_errs: per query,
        the errors after each iteration).  Records ``match_time`` (per query
        per iteration) and ``localize_time`` (per query) in ``timer``."""
        if iters > 1 and renderer is None:
            raise ValueError("iters > 1 needs the NeRF renderer")
        ts = time.perf_counter()
        B = np.asarray(batch["image"]).shape[0]
        H, W = np.asarray(batch["image"]).shape[1:3]
        Ks, c2ws = np.asarray(batch["K"]), np.asarray(batch["c2w"])
        pt2d_all = np.asarray(batch["pt2d"])
        pt3d = np.asarray(batch["pt3d"])
        pt_feat = np.asarray(batch["pt_feat"])
        pt_mask = np.asarray(batch["pt_mask"], np.float32)
        un = np.asarray(batch["unnorm_scene"])
        c2w_ests = [None] * B
        res = dict(R_err=[float("inf")] * B, t_err=[float("inf")] * B,
                   num_matches=[0] * B, iter_R_errs=[[] for _ in range(B)],
                   iter_t_errs=[[] for _ in range(B)])
        for itr in range(iters):
            dead = set()
            if itr > 0:
                live = [b for b in range(B) if c2w_ests[b] is not None]
                if live:
                    outs = renderer.render_novel_views(
                        (H, W), Ks[live], [c2w_ests[b] for b in live],
                        [un[b] for b in live], downsample=8)
                    n_new = outs["pt3d"].shape[1]
                    if n_new != pt3d.shape[1]:
                        # A new point budget: queries whose PnP failed keep
                        # their iteration-0 results.
                        dead = set(range(B)) - set(live)
                        pt3d = np.zeros((B, n_new, 3), np.float32)
                        pt_feat = np.zeros((B, n_new, outs["pt_feat"].shape[-1]),
                                           np.float32)
                        pt_mask = np.zeros((B, n_new), np.float32)
                    else:
                        pt3d, pt_feat, pt_mask = (pt3d.copy(), pt_feat.copy(),
                                                  pt_mask.copy())
                    for j, b in enumerate(live):
                        pt3d[b] = outs["pt3d"][j]
                        pt_feat[b] = outs["pt_feat"][j]
                        pt_mask[b] = 1.0
            t_match = time.perf_counter()
            out = self._match(batch["image"], pt_feat, pt3d, batch["im_mask"],
                              pt_mask, mutual, match_thres)
            self.timer["match_time"].extend(
                [(time.perf_counter() - t_match) / B] * B)
            for b in range(B):
                if b not in dead:
                    mpt2d, mpt3d = self._item_matches(out, pt2d_all, pt3d, b)
                    c2w_est, r_err, t_err, n = self._solve_pose(
                        mpt2d, mpt3d, Ks[b], c2ws[b], solver, rthres)
                    c2w_ests[b] = c2w_est
                    res["R_err"][b] = r_err
                    res["t_err"][b] = t_err
                    res["num_matches"][b] = n
                if cache_iters:
                    res["iter_R_errs"][b].append(res["R_err"][b])
                    res["iter_t_errs"][b].append(res["t_err"][b])
        self.timer["localize_time"].extend(
            [(time.perf_counter() - ts) / B] * B)
        res["c2w_est"] = c2w_ests
        if not cache_iters:
            del res["iter_R_errs"], res["iter_t_errs"]
        return res

    def eval_data_loader(self, data_loader, renderer=None, iters: int = 1,
                         rthres: float = 1.0, solver: str = "colmap",
                         mutual: bool = True, match_thres: float = 0.0,
                         cache_iters: bool = False, debug: bool = False):
        """Every batch of ``data_loader`` through :meth:`eval_batch` ->
        per-query arrays R_err, t_err, num_matches (and (Q, iters)
        iter_R_errs / iter_t_errs with ``cache_iters``)."""
        metrics = defaultdict(list)
        for i, batch in enumerate(data_loader):
            res = self.eval_batch(batch, renderer, iters=iters, mutual=mutual,
                                  match_thres=match_thres, solver=solver,
                                  rthres=rthres, cache_iters=cache_iters)
            for k in ("R_err", "t_err", "num_matches", "iter_R_errs",
                      "iter_t_errs"):
                if k in res:
                    metrics[k].append(np.asarray(res[k]))
            if debug:
                logger.info(f"{i} t={res['t_err'][0] * 100:.1f}cm "
                            f"r={res['R_err'][0]:.3f}deg")
                if i >= 5:
                    break
        return {k: (np.concatenate(v) if "iter" in k
                    else np.concatenate(v).squeeze())
                for k, v in metrics.items()}

    def eval_multi_scenes(self, split: str = "test", rthres: float = 1.0,
                          center_subpixel: bool = False,
                          solver: str = "colmap", mutual: bool = True,
                          match_thres: float = 0.0, iters: int = 1,
                          nerf_path=None, inerf_conf=None,
                          test_pair_txt=None, scene_dir=None,
                          ow_cache: bool = False, data_conf=None,
                          query2query: bool = False, cached_pt: bool = True,
                          stop_layer: int = -1, debug: bool = False,
                          cache_dir=None, cache_iters: bool = False,
                          retrieval_only: bool = False,
                          match_oracle: bool = False, seed=None,
                          visualize: bool = False, eval_bs: int = 1):
        """The scene loop: per scene of the config's (or ``data_conf``'s)
        ``scenes``, localize every query, save the metrics under the
        reference's tag name (:meth:`_cache_tag`; an existing file is read
        back unless ``ow_cache``) and summarize -> (averages over the
        scenes, per-scene summaries).  ``center_subpixel`` only tags the
        file: it is an identity, as in the JAX package."""
        for flag, what in ((inerf_conf, "iNeRF refinement (--inerf)"),
                           (query2query, "--query2query"),
                           (not cached_pt, "uncached points (--no_cache_pt)"),
                           (retrieval_only, "--retrieval_only"),
                           (match_oracle, "--match_oracle"),
                           (visualize, "--visualize")):
            if flag:
                _unported(what)
        if cache_dir:
            self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)

        conf = self.config.data
        if data_conf is not None:
            conf = merge_configs(conf, data_conf)
        if getattr(conf, "dataset", "") == "NeRFMatchMultiPair":
            _unported("multi-pair matching (--pair_topk > 1)")
        if test_pair_txt:
            conf.test_pair_txt = test_pair_txt
        if scene_dir:
            conf.scene_dir = scene_dir
        if hasattr(conf, "datasets"):
            datasets = init_mixed_dataset(conf, split=split, concat=False)
        else:
            datasets = init_multiscene_dataset(conf, split=split, concat=False)

        metr_all = []
        for dataset in datasets:
            if seed is not None:
                np.random.seed(seed)
            self.timer = defaultdict(list)
            cache_path = self._cache_tag(
                dataset, split, rthres, mutual, match_thres, solver,
                center_subpixel, retrieval_only, inerf_conf, iters, conf,
                test_pair_txt, cached_pt, query2query, cache_iters,
                match_oracle, debug)
            logger.info(f"Cache path: {cache_path}")
            if os.path.exists(cache_path) and not ow_cache:
                metrics = np.load(cache_path, allow_pickle=True).item()
            else:
                bs = eval_bs if eval_bs > 1 and not cache_iters else 1
                loader = DataLoader(dataset, batch_size=bs, shuffle=False)
                renderer = None
                if iters > 1:
                    if nerf_path is None:
                        raise ValueError(
                            "--iters > 1 re-renders through the NeRF but no "
                            "NeRF checkpoint was given: pass --nerf_path "
                            "(supports $scene / #scene placeholders)")
                    sl = stop_layer if stop_layer > 0 else \
                        parse_nerf_stop_layer(dataset.scene_dir)
                    if sl < 0:
                        logger.warning(
                            f"scene_dir {dataset.scene_dir} has no "
                            "inter_layer<k> tag: --iters re-renders will use "
                            "the final-layer feature tap, which likely "
                            "mismatches the cached features the matcher was "
                            "trained on.")
                    nerf_ckpt = str(nerf_path).replace(
                        "$scene", dataset.scene).replace("#scene", dataset.scene)
                    renderer = load_nerf_render_from_ckpt(
                        nerf_ckpt, stop_layer=sl, serving=True,
                        device=self.device)
                with torch.no_grad():
                    metrics = self.eval_data_loader(
                        loader, renderer, iters=iters, rthres=rthres,
                        solver=solver, mutual=mutual, match_thres=match_thres,
                        cache_iters=cache_iters, debug=debug)
                for k, v in self.timer.items():
                    metrics[k] = np.asarray(v)
                np.save(cache_path, metrics)
            metr_all.append(summarize_pose_statis(
                metrics, pose_thres=POSE_THRES.get(dataset.scene, [(5, 5)]),
                t_unit="cm", t_scale=1e2))
        if metr_all:
            return average_pose_metrics(metr_all), metr_all
        return None, []

    def _cache_tag(self, dataset, split, rthres, mutual, match_thres, solver,
                   center_subpixel, retrieval_only, inerf_conf, iters, conf,
                   test_pair_txt, cached_pt, query2query, cache_iters,
                   match_oracle, debug):
        """The reference's tag-keyed result file name."""
        path = str(self.cache_dir / f"{dataset.scene}_rth{rthres:.0f}{split}.npy")
        if self.coarse_only:
            path = path.replace(".npy", "_coarse.npy")
        if not mutual:
            path = path.replace(".npy", "_no_mutual.npy")
        if match_thres > 0:
            path = path.replace(".npy", f"_sc{match_thres:.2f}.npy")
        if solver != "cv":
            path = path.replace(".npy", f"_{solver}.npy")
        if center_subpixel:
            path = path.replace(".npy", "_subpx.npy")
        if retrieval_only:
            path = path.replace(".npy", "_IR.npy")
        if inerf_conf:
            num_optim = getattr(inerf_conf, "num_optim", 5)
            lrate = getattr(inerf_conf, "lrate", 0.001)
            ds = getattr(inerf_conf, "ds", 8)
            tag = f"_itr{iters}ds{ds}inerf{num_optim}lr{lrate}"
            tag += "lrdcos" if getattr(inerf_conf, "lrdecay", False) else ""
            tag += "pose" if getattr(inerf_conf, "eval_pose", False) else "match"
            path = path.replace(".npy", f"{tag}.npy")
        else:
            path = path.replace(".npy", f"_itr{iters}.npy")
        if getattr(conf, "dataset", "") == "NeRFMatchMultiPair":
            path = path.replace(
                ".npy", f"_top{conf.pair_topk}pt{getattr(conf, 'sample_pts', -1)}.npy")
        if not cached_pt:
            path = path.replace(".npy", "_nocache.npy")
        if query2query:
            path = path.replace(".npy", ".query2query.npy")
        if cache_iters:
            path = path.replace(".npy", ".itercache.npy")
        if match_oracle:
            path = path.replace(".npy", ".match_oracle.npy")
        if debug:
            path = path.replace(".npy", ".debug.npy")
        return path
