"""Matcher datasets (counterpart of ``nerfmatch_tpu/data/match_dataset.py``),
numpy only.

* :class:`NeRFMatchBase`: identity pairs (an image against its own cached
  scene points);
* :class:`NeRFMatchPair`: retrieval pairs (a query image against a retrieved
  reference frame's cached points), with the GT conf matrix from projecting
  the reference points into the query's ds-grid, self-pair augmentation and
  seeded per-epoch resampling;
* :class:`NeRFMatchMultiPair`: a query against its top-k retrieved frames'
  points, stacked (K, N, .) per pair or merged into one visibility-filtered,
  resampled cloud (``sample_mode='rand'``).

Samples are dicts of numpy arrays with the reference's keys, images NHWC.
"""

from __future__ import annotations

import json
import os
import random
from pathlib import Path

import numpy as np
from PIL import Image

from ..parallel.distributed import process_info
from .loading import (load_frame_3d, load_retrieval_pairs,
                      load_topk_retrieval_pairs, parse_multipair_ids_balanced,
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
        # the trainer) and the process index, so ranks draw distinct pairs.
        seed = int(getattr(config, "seed", 0) or 0)
        self.rng = np.random.default_rng(
            np.random.SeedSequence([seed, process_info()[0]]))

    def _load_frames(self):
        """The reference and query annotations, each sorted by path."""
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

    def load_scene_data(self):
        self._load_frames()
        pairs = load_topk_retrieval_pairs(self.pair_txt, kmax=self.pair_topk)
        parse = parse_pair_ids_balanced if self.balanced_pair else parse_pair_ids
        self.pair_ids = parse(self.qframes, self.rframes, pairs,
                              split=self.split, val_num=self.val_num)
        if self.aug_self_pairs:
            self.pair_ids += [(i, i) for i in range(len(self.qframes))] * int(
                self.aug_self_pairs)

    def _load_query(self, qid):
        """Query ``qid`` -> (image path, image, K, c2w (f64), w2c, ds-grid
        pixels, its cached points (None on the test split), its mask)."""
        qframe = self.qframes[qid]
        qc2w = np.asarray(qframe["transform_matrix"], np.float64)
        qim_path = str(self.im_dir / qframe["file_path"])
        qim, sK = process_img(self.img_wh, qim_path,
                              imagenet_norm=self.imagenet_norm)
        qK = sK @ np.asarray(qframe["intrinsics"], np.float32)
        qpt2d = pixel_grid_np(*self.img_wh, self.model_ds)
        if self.split != "test":
            qpt3d, _, qmask, _ = load_frame_3d(qframe, self.scene_dir,
                                               use_msk=self.use_msk)
        else:
            qmask, qpt3d = np.ones(len(qpt2d), bool), None
        return (qim_path, qim, qK, qc2w, np.linalg.inv(qc2w), qpt2d, qpt3d,
                qmask)

    def load_sample(self, idx):
        if self.epoch_sample_num > 0:
            idx = int(self.rng.integers(len(self.pair_ids)))
        qid, rid = self.pair_ids[idx]
        ds = self.model_ds
        qim_path, qim, qK, qc2w, qw2c, qpt2d, qpt3d, qmask = \
            self._load_query(qid)
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


class NeRFMatchMultiPair(NeRFMatchPair):
    """A query against its top-k retrieved frames' scene points.  Without
    ``sample_mode`` (stacked) the points keep a pair axis, (K, N, .); with
    ``sample_mode='rand'`` (merged) the K frames' points pass a
    visibility-intersection filter and a ``np.random`` permutation, tiled to
    ``sample_pts``.  ``conf_gt`` and ``pt2d_proj`` are built on every split,
    over all K * N (or the merged) points.  Random draws come from numpy's
    global generator, as in the reference, so a seed gives the same
    samples in both packages."""

    def __init__(self, config, split: str = "train", val_num: int = 500,
                 debug: bool = False):
        super().__init__(config, split=split, val_num=val_num, debug=debug)
        self.sample_pts = getattr(config, "sample_pts", -1)
        self.sample_mode = getattr(config, "sample_mode", None)
        self.pair_topk = getattr(config, "pair_topk", 10)

    def load_scene_data(self):
        self._load_frames()
        self.pair_ids = parse_multipair_ids_balanced(
            self.qframes, self.rframes, load_retrieval_pairs(self.pair_txt),
            split=self.split, val_num=self.val_num)
        self.pair_ids_keys = list(self.pair_ids.keys())

    def load_ref_pts(self, rids):
        """The refs' points -> (pt3d, pt_feat, mask, unnorm_scene of the last,
        c2w of the first): K refs drawn with replacement on the train split;
        elsewhere the first K, cycled when the query has fewer."""
        if len(rids) == 0:
            raise ValueError(
                "multi-pair query has no refs resolvable against the ref "
                "annotations — check pair_txt / ref_json consistency")
        if self.split == "train":
            rids_ = np.random.choice(rids, self.pair_topk)
        else:
            rids = list(rids)
            if len(rids) < self.pair_topk:
                rids = rids * (-(-self.pair_topk // len(rids)))
            rids_ = np.asarray(rids[: self.pair_topk])
        all_pt3d, all_feat, all_mask = [], [], []
        rc2w = None
        for i, rid in enumerate(rids_):
            rframe = self.rframes[rid]
            if i == 0:
                rc2w = np.asarray(rframe["transform_matrix"], np.float32)
            pt3d, pt_feat, mask, unnorm_scene = load_frame_3d(
                rframe, self.scene_dir, use_msk=self.use_msk)
            all_pt3d.append(pt3d)
            all_feat.append(pt_feat)
            all_mask.append(mask)
        rpt3d = np.concatenate(all_pt3d, 0)
        rpt_feat = np.concatenate(all_feat, 0)
        rmask = np.concatenate(all_mask, 0)
        if not self.sample_mode:
            return rpt3d, rpt_feat, rmask, unnorm_scene, rc2w

        # Keep the points every ref sees (their union where the intersection
        # would drop below a third).
        visible = np.ones(len(rpt3d), bool)
        WH = np.asarray(self.img_wh, np.float64)
        for rid in rids_:
            rframe = self.rframes[rid]
            rw2c = np.linalg.inv(np.asarray(rframe["transform_matrix"],
                                            np.float64))
            sK = np.diag([WH[0] / rframe["width"], WH[1] / rframe["height"], 1.0])
            rK = sK @ np.asarray(rframe["intrinsics"], np.float64)
            rpt2d = project_points_np(rK, rw2c[:3, :3], rw2c[:3, 3], rpt3d)
            i_vis = (rpt2d >= 0).all(-1) & (rpt2d < WH).all(-1)
            intersect = visible & i_vis
            union = visible | i_vis
            visible = union if intersect.sum() < visible.sum() / 3 else intersect
        rpt3d, rpt_feat, rmask = rpt3d[visible], rpt_feat[visible], rmask[visible]
        if self.sample_mode == "rand":
            n = len(rpt3d)
            idx = np.random.permutation(n)
            if self.sample_pts > 0:
                idx = np.tile(idx, (self.sample_pts // max(n, 1)) + 1)[
                    : self.sample_pts]
            rpt3d, rpt_feat, rmask = rpt3d[idx], rpt_feat[idx], rmask[idx]
        return rpt3d, rpt_feat, rmask, unnorm_scene, rc2w

    def load_sample(self, idx):
        if self.epoch_sample_num > 0:
            idx = int(np.random.randint(len(self.pair_ids)))
        qid = self.pair_ids_keys[idx]
        qim_path, qim, qK, qc2w, qw2c, qpt2d, qpt3d, qmask = \
            self._load_query(qid)
        rpt3d, rpt_feat, rmask, unnorm_scene, rc2w = self.load_ref_pts(
            self.pair_ids[qid])
        conf_gt, qpt2d_proj = build_conf_gt(
            qpt2d, rpt3d, qK, qw2c, self.img_wh, self.model_ds, qmask, rmask)
        if not self.sample_mode:
            n = len(rpt3d) // self.pair_topk
            rpt3d = rpt3d.reshape(self.pair_topk, n, -1)
            rpt_feat = rpt_feat.reshape(self.pair_topk, n, -1)
            rmask = rmask.reshape(self.pair_topk, n)
        sample = {
            "qim_path": qim_path,
            "image": qim,
            "im_mask": qmask.astype(np.float32),
            "K": qK,
            "c2w": qc2w.astype(np.float32),
            "rc2w": rc2w,
            "pt2d": qpt2d,
            "pt2d_proj": qpt2d_proj,
            "pt3d": np.asarray(rpt3d, np.float32),
            "pt_feat": np.asarray(rpt_feat, np.float32),
            "pt_mask": np.asarray(rmask, np.float32),
            "conf_gt": conf_gt,
            "unnorm_scene": np.asarray(unnorm_scene, np.float32),
        }
        if self.split != "test":
            sample["qpt3d"] = np.asarray(qpt3d, np.float32)
        return sample

    def __len__(self):
        if self.epoch_sample_num > 0:
            return self.epoch_sample_num
        return len(self.pair_ids)
