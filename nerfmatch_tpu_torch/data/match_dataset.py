"""Matcher datasets (counterpart of ``nerfmatch_tpu/data/match_dataset.py``),
numpy only.

* :class:`NeRFMatchBase`: identity pairs (an image against its own cached
  scene points);
* :class:`NeRFMatchPair`: retrieval pairs (a query image against a retrieved
  reference frame's cached points), with the GT conf matrix from projecting
  the reference points into the query's ds-grid, self-pair augmentation and
  seeded per-epoch resampling.

Samples are dicts of numpy arrays with the reference's keys, images NHWC.
``NeRFMatchMultiPair`` is not ported (ROADMAP: multi-pair matching).
"""

from __future__ import annotations

import json
import os
import random
from pathlib import Path

import numpy as np
from PIL import Image

from .loading import (load_frame_3d, load_topk_retrieval_pairs,
                      parse_pair_ids, parse_pair_ids_balanced)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406])
IMAGENET_STD = np.array([0.229, 0.224, 0.225])


def process_img(img_wh, img_path, imagenet_norm: bool = False):
    """LANCZOS resize -> ((H, W, 3) float32 image, intrinsics scaler)."""
    img = Image.open(img_path)
    sK = np.diag([img_wh[0] / img.size[0], img_wh[1] / img.size[1], 1.0]
                 ).astype(np.float32)
    arr = np.asarray(img.resize(tuple(img_wh), Image.LANCZOS), np.float64) / 255.0
    if imagenet_norm:
        arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
    return arr.astype(np.float32), sK


def pixel_grid_np(w, h, ds: int = 1):
    xs, ys = np.meshgrid(np.arange(w // ds), np.arange(h // ds), indexing="xy")
    return (np.stack([xs, ys], -1).astype(np.float32) * ds + ds / 2).reshape(-1, 2)


def project_points_np(K, R, t, pts3d):
    pcam = pts3d @ np.asarray(R).T + np.asarray(t).reshape(-1)
    return ((pcam / pcam[:, 2:]) @ np.asarray(K).T)[:, :2]


def build_conf_gt(qpt2d, rpt3d, qK, qw2c, img_wh, ds, qmask, rmask):
    """GT conf matrix from projecting the reference points into the query's
    ds-grid -> (conf, qpt2d_proj).  Reference quirks kept: ``> 0`` drops
    grid row and column 0, there is no depth check, and a pair without any
    match gets one random false supervision (from the ``random`` module)."""
    w, h = img_wh
    qpt2d_proj = project_points_np(qK, qw2c[:3, :3], qw2c[:3, 3], rpt3d)
    ds_ids = np.floor(qpt2d_proj / ds).astype(np.int64)
    visible = ((ds_ids.min(-1) > 0) & (ds_ids[:, 0] < (w // ds))
               & (ds_ids[:, 1] < (h // ds)))
    q_ids = (ds_ids[:, 0] + ds_ids[:, 1] * (w // ds)).clip(0, len(qpt2d) - 1)
    conf = np.zeros((len(qpt2d), len(rpt3d)), np.float32)
    conf[q_ids, np.arange(len(rpt3d))] = 1.0
    conf = qmask[:, None] * rmask[None, :] * visible[None, :] * conf
    if conf.sum() < 1:
        conf[int(random.random() * (conf.shape[0] - 1)),
             int(random.random() * (conf.shape[1] - 1))] = 1.0
    return conf.astype(np.float32), qpt2d_proj.astype(np.float32)


def _sorted_frames(path):
    with open(path, "r") as f:
        return sorted(json.load(f)["frames"], key=lambda x: x["file_path"])


class NeRFMatchBase:
    """Identity pairs: an image matched against its own cached points."""

    def __init__(self, config, split: str = "train", val_num: int = 100,
                 debug: bool = False):
        self.config = config
        self.split = split
        self.scene = config.scene
        self.root_dir = Path(config.data_dir) / self.scene
        self.scene_dir = config.scene_dir.replace("#scene", self.scene)
        self.model_ds = getattr(config, "model_ds", 1)
        self.img_wh = list(config.img_wh)
        self.val_num = val_num
        self.use_msk = getattr(config, "use_msk", False)
        self.load_scene_data()

    def load_scene_data(self):
        tag = "test" if self.split == "test" else "train"
        self.frames = _sorted_frames(self.root_dir / f"transforms_{tag}.json")

    def load_sample(self, idx):
        frame = self.frames[idx]
        w, h = self.img_wh
        img_path = str(self.root_dir / frame["file_path"])
        img, sK = process_img(self.img_wh, img_path)
        pt3d, pt_feat, _, unnorm_scene = load_frame_3d(
            frame, self.scene_dir, use_msk=self.use_msk)
        mask = np.ones(len(pt3d), bool)   # identity pairs: all-ones masks
        return {
            "image_path": img_path,
            "image": img,
            "im_mask": mask,
            "pt2d": pixel_grid_np(w, h, self.model_ds),
            "pt3d": pt3d.astype(np.float32),
            "pt_feat": pt_feat.astype(np.float32),
            "pt_mask": mask,
            "c2w": np.asarray(frame["transform_matrix"], np.float32),
            "K": sK @ np.asarray(frame["intrinsics"], np.float32),
            "conf_gt": np.eye(len(pt3d), dtype=np.float32),
            "unnorm_scene": np.asarray(unnorm_scene, np.float32),
        }

    def __getitem__(self, idx):
        return self.load_sample(idx)

    def __len__(self):
        return len(self.frames)


class NeRFMatchPair(NeRFMatchBase):
    """Retrieval pairs: a query image against a retrieved reference frame's
    scene points."""

    def __init__(self, config, split: str = "train", val_num: int = 500,
                 debug: bool = False):
        self.anno_tag = "test" if split == "test" else "train"
        self.pair_txt = getattr(config, f"{self.anno_tag}_pair_txt").replace(
            "#scene", config.scene)
        self.pair_topk = getattr(config, "pair_topk", 10)
        self.imagenet_norm = getattr(config, "imagenet_norm", False)
        self.balanced_pair = getattr(config, "balanced_pair", False)
        if self.balanced_pair and split == "val":
            self.pair_topk = -1
        self.aug_self_pairs = (getattr(config, "aug_self_pairs", False)
                               if split == "train" else False)
        super().__init__(config, split=split, val_num=val_num, debug=debug)
        self.im_dir = self.root_dir
        self.epoch_sample_num = (getattr(config, "epoch_sample_num", -1)
                                 if split == "train" else -1)
        # Seeded epoch resampling: exp.seed (copied into the data config by
        # the trainer) and the process index, 0 in one process.
        seed = int(getattr(config, "seed", 0) or 0)
        self.rng = np.random.default_rng(np.random.SeedSequence([seed, 0]))

    def load_scene_data(self):
        if getattr(self.config, "scene_anno_path", None):
            anno = self.config.scene_anno_path.replace("#scene", self.scene)
            self.ref_json = anno.replace("#split", "train")
            self.query_json = anno.replace("#split", self.anno_tag)
        else:
            self.ref_json = str(self.root_dir / "transforms_train.json")
            self.query_json = str(self.root_dir
                                  / f"transforms_{self.anno_tag}.json")
        self.rframes = _sorted_frames(self.ref_json)
        self.qframes = self.rframes if self.query_json == self.ref_json \
            else _sorted_frames(self.query_json)
        pairs = load_topk_retrieval_pairs(self.pair_txt, kmax=self.pair_topk)
        parse = parse_pair_ids_balanced if self.balanced_pair else parse_pair_ids
        self.pair_ids = parse(self.qframes, self.rframes, pairs,
                              split=self.split, val_num=self.val_num)
        if self.aug_self_pairs:
            self.pair_ids += [(i, i) for i in range(len(self.qframes))] * int(
                self.aug_self_pairs)

    def load_sample(self, idx):
        if self.epoch_sample_num > 0:
            idx = int(self.rng.integers(len(self.pair_ids)))
        qid, rid = self.pair_ids[idx]
        qframe = self.qframes[qid]
        ds = self.model_ds
        w, h = self.img_wh
        qc2w = np.asarray(qframe["transform_matrix"], np.float64)
        qw2c = np.linalg.inv(qc2w)
        qim_path = str(self.im_dir / qframe["file_path"])
        qim, sK = process_img(self.img_wh, qim_path,
                              imagenet_norm=self.imagenet_norm)
        qK = sK @ np.asarray(qframe["intrinsics"], np.float32)
        qpt2d = pixel_grid_np(w, h, ds)
        if self.split != "test":
            qpt3d, _, qmask, _ = load_frame_3d(qframe, self.scene_dir,
                                               use_msk=self.use_msk)
        else:
            qmask, qpt3d = np.ones(len(qpt2d), bool), None
        rframe = self.rframes[rid]
        rim_path = str(self.im_dir / rframe["file_path"])
        rc2w = np.asarray(rframe["transform_matrix"], np.float32)
        if not os.path.exists(self.scene_dir):
            return {"rim_path": rim_path, "qim_path": qim_path, "image": qim,
                    "im_mask": qmask, "K": qK,
                    "c2w": qc2w.astype(np.float32), "rc2w": rc2w,
                    "pt2d": qpt2d}
        rpt3d, rpt_feat, rmask, unnorm_scene = load_frame_3d(
            rframe, self.scene_dir, use_msk=self.use_msk)
        sample = {
            "rim_path": rim_path,
            "qim_path": qim_path,
            "image": qim,
            "im_mask": qmask.astype(np.float32),
            "K": qK,
            "c2w": qc2w.astype(np.float32),
            "rc2w": rc2w,
            "pt2d": qpt2d,
            "pt3d": rpt3d.astype(np.float32),
            "pt_feat": rpt_feat.astype(np.float32),
            "pt_mask": rmask.astype(np.float32),
            "unnorm_scene": np.asarray(unnorm_scene, np.float32),
        }
        if self.split != "test":
            conf_gt, qpt2d_proj = build_conf_gt(
                qpt2d, rpt3d, qK, qw2c, self.img_wh, ds, qmask, rmask)
            sample["conf_gt"] = conf_gt
            sample["pt2d_proj"] = qpt2d_proj
            sample["qpt3d"] = qpt3d.astype(np.float32)
        else:
            sample["pt2d_proj"] = project_points_np(
                qK, qw2c[:3, :3], qw2c[:3, 3], rpt3d).astype(np.float32)
        return sample

    def __len__(self):
        if self.epoch_sample_num > 0:
            return self.epoch_sample_num
        return len(self.pair_ids)


class NeRFMatchMultiPair:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("NeRFMatchMultiPair (top-k merged refs) is "
                                  "not ported (ROADMAP: multi-pair matching)")
