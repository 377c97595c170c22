"""Scene-point cache (counterpart of ``nerfmatch_tpu/eval/nerf_evaluator.py``:
``NerfEvaluator.cache_scene_pts`` and what it needs).

Renders every view of a split on the ds grid and writes, per frame, the
``.npy`` schema that ``data.loading.load_frame_3d`` reads: ``pt3d`` (world
frame), ``unnorm_scene``, ``pt_feat``, ``pt_color`` and ``cam2scene``.  This
turns a NeRF trained by the port into matcher training data.  CUDA renders
go through the eval render and resample kernels with the serving int8 mode
(``serving_int8_mode``: the JAX package's ``'coarse'`` default when the
config does not set ``render.trunk_int8``), CPU renders through the plain
f32 path.  :func:`load_nerf_render_from_ckpt` is the localization
evaluator's re-render NeRF.  The checkpoints are the port's own
(``train.checkpoint`` directories); the PSNR evaluation of the JAX
evaluator is not ported.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import torch

from ..config import dict2namespace, merge_configs
from ..data.loaders import init_data_loader
from ..nerf.renderer import NerfRenderer, serving_int8_mode
from ..nerf.scene import compute_scene_normalization_fst
from ..utils import get_logger, resolve_device

logger = get_logger(level="INFO", name="nerf_eval")


def load_renderer(ckpt_path, stop_layer: int = -1, config=None):
    """A port NeRF checkpoint directory -> (renderer, config); the config
    comes from the checkpoint unless given."""
    ckpt_path = Path(ckpt_path)
    if not (ckpt_path / "meta.json").exists():
        raise NotImplementedError(
            f"{ckpt_path}: only the port's own checkpoint directories load "
            f"here (reference Lightning .ckpt files: ROADMAP, NeRF evaluator)")
    meta = json.loads((ckpt_path / "meta.json").read_text())
    cfg = config or dict2namespace(meta["config"])
    renderer = NerfRenderer(cfg, stop_layer=stop_layer)
    renderer.load_state_dict(torch.load(ckpt_path / "model.pt",
                                        map_location="cpu", weights_only=True),
                             strict=True)
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
                        frame_num: int = -1, device="cuda"):
    """A :class:`NerfEvaluator` from a checkpoint, with the reference's config
    rewrites (data root, img_wh / downsample overrides, the test split takes
    the whole dataset), on the card unless ``device="cpu"``."""
    device = resolve_device(device)
    stop_layer = getattr(args, "stop_layer", -1) if args else -1
    renderer, config = load_renderer(ckpt_path, stop_layer)
    config.ckpt = str(ckpt_path)
    config.data.data_dir = os.path.join(root_dir, config.data.data_dir)
    if args:
        if getattr(args, "scene_anno_path", None):
            config.data.scene_anno_path = args.scene_anno_path
        config = merge_configs(config, args)
        if getattr(args, "img_wh", None):
            config.data.img_wh = config.img_wh
        if hasattr(config, "downsample"):
            config.data.downsample = config.downsample
    config.data.scene_seq = None
    if getattr(config, "split", "test") != "train":
        config.data.max_sample_num = None
    return NerfEvaluator(config, renderer.to(device).eval(),
                         frame_num=frame_num)


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
    def render_sample(self, batch):
        """Render one collated (batch of 1) sample -> preds as numpy."""
        rays = np.asarray(batch["rays"][0]).reshape(-1, 12)
        preds = self.renderer.predict(torch.as_tensor(
            rays, dtype=torch.float32, device=self.renderer.device))
        return {k: v.cpu().numpy() for k, v in preds.items()}

    @staticmethod
    def unnorm(unnorm_scene, pts):
        flat = np.asarray(pts).reshape(-1, 3)
        h = np.concatenate([flat, np.ones_like(flat[:, :1])], -1)
        return (np.asarray(unnorm_scene) @ h.T).T[:, :3].reshape(np.shape(pts))

    def cache_scene_pts(self, feat_comb: str = "lin", debug: bool = False,
                        cache_dir=None, trunk_int8: str | None = None):
        """Render every view of the split on the ds grid and write the
        per-frame scene points under ``<cache_dir>/ds{downsample}{feat_comb}``
        (default ``<cache of the checkpoint>/scene/...``) -> that directory.
        ``trunk_int8`` None resolves through :func:`serving_int8_mode`; the
        CUDA kernels serve it, the CPU path renders f32.  ``feat_comb='max'``
        raises in the CUDA kernels."""
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
            preds = self.render_sample(batch)
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
