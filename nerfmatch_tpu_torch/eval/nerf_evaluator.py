"""NeRF evaluator (counterpart of ``nerfmatch_tpu/eval/nerf_evaluator.py``).

* PSNR: :meth:`NerfEvaluator.eval_data_loader` renders every image of a
  split, scores it (``rgb_fine_psnr``) and writes ``rgb/<idx>.png``
  (``depth/<idx>.png`` with ``save_depth``) and ``results.npy``;
  :meth:`~NerfEvaluator.render_single_view` and
  :meth:`~NerfEvaluator.eval_on_scaled_poses` render given poses.
* Scene points: :meth:`NerfEvaluator.cache_scene_pts` renders every view on
  the ds grid and writes, per frame, the ``.npy`` schema that
  ``data.loading.load_frame_3d`` reads: ``pt3d`` (world frame),
  ``unnorm_scene``, ``pt_feat``, ``pt_color`` and ``cam2scene``, with the
  serving int8 mode (``serving_int8_mode``: the JAX package's ``'coarse'``
  default when the config does not set ``render.trunk_int8``).

Both go through :meth:`NerfEvaluator.eval_batch`, which turns the frames'
sequence ids ``ts`` into the appearance rows of an appearance NeRF.  CUDA
renders run the eval render and resample kernels (the PSNR render in the
config's ``trunk_int8``, ``'none'`` when absent: the bf16 trunk), CPU
renders the plain path.  Checkpoints are the port's own directories or
reference Lightning ``.ckpt`` files; :func:`load_nerf_render_from_ckpt` is
the localization evaluator's re-render NeRF.
"""

from __future__ import annotations

import dataclasses
import json
import os
from argparse import Namespace
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from ..config import dict2namespace, merge_configs
from ..data.loaders import init_data_loader
from ..nerf.rays import get_ray_dirs, get_rays_c2w, prepare_rays_data
from ..nerf.renderer import NerfRenderer, serving_int8_mode
from ..nerf.scene import compute_scene_normalization_fst
from ..train.checkpoint import infer_appearance_vocab, load_reference_checkpoint
from ..utils import get_logger, resolve_device
from ..utils.images import img2int8, save_depth_as_img
from ..utils.metrics import compute_nerf_metrics

logger = get_logger(level="INFO", name="nerf_eval")


def load_renderer(ckpt_path, stop_layer: int = -1, config=None):
    """A port NeRF checkpoint directory or a reference Lightning ``.ckpt``
    (a pickle: load only files you trust) -> (renderer, config); the config
    comes from the checkpoint (its ``hyper_parameters`` for a ``.ckpt``)
    unless given, the appearance table's rows from the stored table."""
    ckpt_path = Path(ckpt_path)
    if (ckpt_path / "meta.json").exists():
        meta = json.loads((ckpt_path / "meta.json").read_text())
        cfg = config or dict2namespace(meta["config"])
        state = torch.load(ckpt_path / "model.pt", map_location="cpu",
                           weights_only=True)
    else:
        state, hparams = load_reference_checkpoint(ckpt_path)
        cfg = config or dict2namespace(dict(
            vars(hparams) if isinstance(hparams, Namespace) else hparams))
    renderer = NerfRenderer(cfg, num_frames=infer_appearance_vocab(state),
                            stop_layer=stop_layer)
    renderer.load_state_dict(state, strict=True)
    return renderer, cfg


def load_scene_normalization(config, root_dir: str = "."):
    """The fst scene normalization recomputed from the train json (JAX
    ``nerf_evaluator.py: load_scene_normalization``) -> the unnorm matrix."""
    if getattr(config, "snorm_type", "fst") != "fst":
        raise NotImplementedError(f"snorm_type={config.snorm_type!r}")
    if getattr(config, "snorm_json", None):
        train_json = Path(config.snorm_json)
    elif getattr(config, "scene_anno_path", None):
        train_json = Path(config.scene_anno_path.replace("#scene", config.scene)
                          .replace("#split", "train"))
    else:
        train_json = Path(config.data_dir) / config.scene / "transforms_train.json"
    scene2s = compute_scene_normalization_fst(
        Path(root_dir) / train_json, config.max_frustum_depth,
        config.rescale_factor)
    return np.linalg.inv(scene2s)


def load_nerf_render_from_ckpt(ckpt_path, stop_layer: int = -1,
                               serving: bool = False, device="cuda"):
    """The renderer of a checkpoint, on ``device``, with ``unnorm_scene``
    attached.  ``serving=True`` (the localization re-render): resolve
    ``trunk_int8`` through :func:`serving_int8_mode`, as the scene-point
    cache does (an explicit ``render.trunk_int8``, ``'none'`` included,
    wins)."""
    device = resolve_device(device)
    renderer, cfg = load_renderer(ckpt_path, stop_layer)
    if serving:
        renderer.cfg = dataclasses.replace(renderer.cfg,
                                           trunk_int8=serving_int8_mode(cfg))
    renderer.unnorm_scene = load_scene_normalization(cfg.data)
    return renderer.to(device).eval()


def load_nerf_from_ckpt(ckpt_path, args=None, root_dir: str = ".",
                        mask: bool = False, frame_num: int = -1,
                        seq: bool = False, device="cuda"):
    """A :class:`NerfEvaluator` from a checkpoint, with the reference's config
    rewrites (data root, scene annotations, ``snorm_json``, img_wh /
    downsample / ``mip_var_scale`` overrides, every sequence unless ``seq``,
    the test split takes the whole dataset, ``mask``: transient masks and a
    white background), on the card unless ``device="cpu"``."""
    device = resolve_device(device)
    stop_layer = getattr(args, "stop_layer", -1) if args else -1
    renderer, config = load_renderer(ckpt_path, stop_layer)
    config.ckpt = str(ckpt_path)
    config.data.data_dir = os.path.join(root_dir, config.data.data_dir)
    if args:
        if getattr(args, "scene_anno_path", None):
            config.data.scene_anno_path = args.scene_anno_path
        if getattr(args, "snorm_json", None):
            config.data.snorm_json = args.snorm_json
        config = merge_configs(config, args)
        if getattr(args, "img_wh", None):
            config.data.img_wh = config.img_wh
        if hasattr(config, "downsample"):
            config.data.downsample = config.downsample
        if hasattr(args, "mip_var_scale"):
            config.embedding.mip_var_scale = args.mip_var_scale
    if not seq:
        config.data.scene_seq = None
    if getattr(config, "split", "test") != "train":
        config.data.max_sample_num = None
    if mask:
        config.data.mask_transient = True
        config.data.white_bg = True
    return NerfEvaluator(config, renderer.to(device).eval(),
                         frame_num=frame_num)


def image_preds(preds, w: int, h: int, ret_pfeat: bool = True):
    """Render outputs (tensors) -> numpy, rgb and depth maps of h * w rays
    as (h, w, c) images (the JAX ``predict(w, h)``); without ``ret_pfeat``
    the composited descriptors are dropped."""
    out = {}
    for k, v in preds.items():
        if k.startswith("feat_") and not ret_pfeat:
            continue
        v = v.cpu().numpy()
        if k.split("_")[0] in ("rgb", "depth") and v.shape[0] == h * w:
            v = v.reshape(h, w, -1)
        out[k] = v
    return out


class NerfEvaluator:
    def __init__(self, config, renderer: NerfRenderer, frame_num: int = -1):
        self.config = config
        self.renderer = renderer
        if frame_num > 0:
            config.data.max_sample_num = frame_num
        self.split = getattr(config, "split", "test")
        self.data_loader = init_data_loader(config.data, split=self.split)
        ckpt = str(getattr(config, "ckpt", "eval"))
        tag = (f"_rendered_{config.data.img_wh[0]}-{config.data.img_wh[1]}"
               f"_{self.split}")
        base = ckpt.replace("checkpoints/", "")
        base = (base.replace(".ckpt", tag) if ".ckpt" in base
                else base.rstrip("/") + tag)
        self.cache_dir = Path(base)
        mvs = float(renderer.cfg.mip_var_scale)
        if mvs > -1:
            self.cache_dir = self.cache_dir / f"mip_var{mvs}"

    @torch.no_grad()
    def eval_batch(self, batch, comp_metric: bool = True,
                   ret_pfeat: bool = False):
        """Render one collated (batch of 1) full-image sample -> preds as
        numpy (rgb / depth as (h, w, c) images) [, metrics as floats].

        An appearance NeRF renders each ray with its frame's sequence id
        ``ts`` (the first id for every ray when the counts differ), as the
        JAX ``eval_batch``.  On the card the fused kernels render and give
        ``rgb_fine`` only, so the metrics hold ``rgb_fine_psnr`` (which
        :meth:`eval_data_loader` reads) and no coarse PSNR; on the CPU the
        plain path gives both.  ``ret_pfeat`` keeps the composited
        descriptors ``feat_*``."""
        first = lambda k: np.asarray(batch[k][0])
        w, h = (int(x) for x in first("img_wh").reshape(-1)[:2])
        rays = first("rays").reshape(-1, 12)
        dev = self.renderer.device
        ray_id = None
        if self.renderer.cfg.appearance_embedding and "ts" in batch:
            ray_id = first("ts").reshape(-1)[:len(rays)].astype(np.int64)
            if len(ray_id) != len(rays):
                ray_id = np.full(len(rays), int(ray_id.flat[0]), np.int64)
            ray_id = torch.as_tensor(ray_id, device=dev)
        preds = self.renderer.predict(
            torch.as_tensor(rays, dtype=torch.float32, device=dev),
            ray_id=ray_id)
        preds = image_preds(preds, w, h, ret_pfeat)
        if not comp_metric:
            return preds
        rgb_gt = torch.as_tensor(first("rgbs").reshape(h, w, -1))
        masks = (torch.as_tensor(first("mask").reshape(h, w, -1))
                 if "mask" in batch else None)
        metrics = compute_nerf_metrics(
            {k: torch.as_tensor(v) for k, v in preds.items()
             if k.startswith("rgb_")}, rgb_gt, validation_mode=True,
            mask_loss=masks)
        return preds, {k: float(v) for k, v in metrics.items()}

    @staticmethod
    def unnorm(unnorm_scene, pts):
        flat = np.asarray(pts).reshape(-1, 3)
        h = np.concatenate([flat, np.ones_like(flat[:, :1])], -1)
        return (np.asarray(unnorm_scene) @ h.T).T[:, :3].reshape(np.shape(pts))

    def eval_data_loader(self, data_loader=None, save_depth: bool = False,
                         cache_dir=None, debug: bool = False):
        """Render every image of the split (``data_loader``, default the
        evaluator's) -> ``{"psnr": [per frame]}``; writes
        ``<cache_dir>/rgb/<idx>.png`` (``depth/<idx>.png``, colorized, with
        ``save_depth``) and ``results.npy``; ``debug``: the first 12 frames
        under ``<cache_dir>/debug``."""
        data_loader = data_loader or self.data_loader
        cache_dir = Path(cache_dir if cache_dir else self.cache_dir)
        if debug:
            cache_dir = cache_dir / "debug"
        (cache_dir / "rgb").mkdir(parents=True, exist_ok=True)
        if save_depth:
            (cache_dir / "depth").mkdir(parents=True, exist_ok=True)
        results = defaultdict(list)
        for i, batch in enumerate(data_loader):
            preds, metrics = self.eval_batch(batch)
            psnr = metrics.get("rgb_fine_psnr", metrics.get("rgb_coarse_psnr"))
            results["psnr"].append(psnr)
            img_idx = batch["img_idx"][0]
            rgb = preds.get("rgb_fine", preds.get("rgb_coarse"))
            Image.fromarray(img2int8(rgb)).save(cache_dir / "rgb" / f"{img_idx}.png")
            if save_depth:
                depth = preds.get("depth_fine", preds.get("depth_coarse"))
                save_depth_as_img(cache_dir / "depth" / f"{img_idx}.png",
                                  depth.squeeze())
            if debug:
                logger.info(f"{i} psnr={psnr:.3f}")
                if i > 10:
                    break
        logger.info(f"Average psnr={np.mean(results['psnr']):.4f}")
        np.save(cache_dir / "results.npy", dict(results))
        return dict(results)

    @torch.no_grad()
    def render_single_view(self, pose, K, near: float = 0.0, far: float = 1.0,
                           flipped_yz: bool = False):
        """Render the image of a normalized-scene c2w ``pose`` and intrinsics
        ``K`` (its size twice the principal point) -> (rgb (h, w, 3), preds
        as numpy); an appearance NeRF renders with table row 1."""
        K = np.asarray(K, np.float32)
        w, h = (int(x) for x in K[:2, 2] * 2)
        dev = self.renderer.device
        dirs = get_ray_dirs(h, w, torch.as_tensor(K, device=dev),
                            flipped_yz=flipped_yz)
        o, d, v = get_rays_c2w(dirs, torch.as_tensor(
            np.asarray(pose), dtype=torch.float32, device=dev))
        rays = prepare_rays_data(o, d, v, near, far).reshape(-1, 12)
        preds = image_preds(self.renderer.predict(rays.contiguous()), w, h)
        return preds.get("rgb_fine", preds.get("rgb_coarse")), preds

    def eval_on_scaled_poses(self, pose_scale: float = 1.0,
                             pose_shift=(0, 0, 0), debug: bool = False):
        """Render the split from its poses with the translation scaled by
        ``pose_scale`` and shifted by ``pose_shift`` (an out-of-distribution
        check) -> the directory of the ``<i>.png`` renders."""
        dataset = self.data_loader.dataset
        sav_dir = self.cache_dir / f"rgb_pose_scale{pose_scale}"
        sav_dir.mkdir(parents=True, exist_ok=True)
        shift = np.asarray(pose_shift, np.float64)
        for i, idx in enumerate(dataset.split_inds):
            c2w = np.array(dataset.cam2s_scenes[idx])
            c2w[:3, 3] = c2w[:3, 3] * pose_scale + shift
            K = np.asarray(dataset.org_Ks[idx])
            sK = np.diag([dataset.img_wh[0] / (K[0, 2] * 2),
                          dataset.img_wh[1] / (K[1, 2] * 2), 1.0])
            rgb, _ = self.render_single_view(c2w, sK @ K, near=0.01)
            Image.fromarray(img2int8(rgb)).save(sav_dir / f"{i:04d}.png")
            if debug and i > 5:
                break
        return sav_dir

    def cache_scene_pts(self, feat_comb: str = "lin", debug: bool = False,
                        cache_dir=None, trunk_int8: str | None = None):
        """Render every view of the split on the ds grid and write the
        per-frame scene points under ``<cache_dir>/ds{downsample}{feat_comb}``
        (default ``<cache of the checkpoint>/scene/...``) -> that directory.
        ``trunk_int8`` None resolves through :func:`serving_int8_mode`; the
        CUDA kernels serve it, the CPU path renders in ``compute_dtype``.
        An appearance NeRF's ``pt_color`` follows each frame's ``ts``.
        ``feat_comb='max'`` (tag ``ds{downsample}max``) caches each ray's
        descriptor and point of its largest weight, on the card through the
        fine render kernel's ``feat_max`` branch."""
        if trunk_int8 is None:
            trunk_int8 = serving_int8_mode(self.config)
        self.renderer.cfg = dataclasses.replace(
            self.renderer.cfg, feat_comb=feat_comb, trunk_int8=trunk_int8)
        ds_tag = f"ds{getattr(self.config, 'downsample', 8)}{feat_comb}"
        scene_dir = (self.cache_dir / "scene" if cache_dir is None
                     else Path(cache_dir)) / ds_tag
        scene_dir.mkdir(parents=True, exist_ok=True)
        logger.info(f"Scene-point cache dir: {scene_dir}")
        for i, batch in enumerate(self.data_loader):
            preds = self.eval_batch(batch, comp_metric=False, ret_pfeat=True)
            pt3d = preds["pts_fine"]
            unnorm_scene = np.eye(4, dtype=np.float32)
            if "unnorm_scene" in batch:
                unnorm_scene = np.asarray(batch["unnorm_scene"][0])
                pt3d = self.unnorm(unnorm_scene, pt3d)
            scene_pts = dict(
                pt3d=pt3d.astype(np.float32),
                unnorm_scene=unnorm_scene.astype(np.float32),
                pt_feat=preds["feat_fine"].astype(np.float32),
                pt_color=np.clip(preds["rgb_fine"].reshape(-1, 3), 0, 1
                                 ).astype(np.float32))
            if "cam2scene" in batch:
                scene_pts["cam2scene"] = np.asarray(batch["cam2scene"][0],
                                                    np.float32)
            if "sky_mask" in batch:
                scene_pts["sky_mask"] = np.asarray(batch["sky_mask"])
            np.save(scene_dir / f"{batch['img_idx'][0]}.npy", scene_pts)
            if debug and i > 10:
                break
        return scene_dir
