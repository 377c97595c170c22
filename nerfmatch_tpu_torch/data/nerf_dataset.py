"""NeRF ray dataset, host-side numpy (counterpart of
``nerfmatch_tpu/data/nerf_dataset.py: NerfBaseDataset``).

Loads ``transforms_{split}.json`` annotations, computes the fst scene
normalization, pre-loads all training rays / rgbs and serves shuffled
fixed-size ray batches; val / test splits serve per-image ray grids;
transient / bg masking, the downsampled cache mode and retrieval-pair
validation samples as in the JAX package.  The ray math is numpy (float64
intermediates, float32 out), so the same ``np.random.default_rng(seed)``
gives the same batches in both packages; the trainer moves a batch to the
device once per step.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
from PIL import Image

from ..nerf.scene import compute_scene_normalization_fst
from ..parallel.distributed import local_slice, process_info
from .loading import load_retrieval_pair_ids


# ---------------------------------------------------------------------------
# numpy ray helpers (host mirror of nerf/rays.py)
# ---------------------------------------------------------------------------

def ray_dirs_np(H, W, K):
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    xys = np.stack([xs, ys, np.ones_like(xs)], axis=-1).astype(np.float64)
    return xys @ np.linalg.inv(K).T


def rays_c2w_np(dirs, c2w):
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    return rays_o, rays_d, viewdirs


def rays_sphere_far_np(rays_o, rays_d, r=1.0):
    odotd = np.sum(rays_o * rays_d, -1)
    d2 = np.sum(rays_d**2, -1)
    o2 = np.sum(rays_o**2, -1)
    det = odotd**2 + (r**2 - o2) * d2
    with np.errstate(invalid="ignore"):
        far = (np.sqrt(det) - odotd) / d2
    return far, np.all(det >= 0)


def pack_rays_np(rays_o, rays_d, viewdirs, near, far, comp_radii=True):
    near = np.full_like(rays_d[..., :1], near) if np.isscalar(near) else near
    far = np.full_like(rays_d[..., :1], far) if np.isscalar(far) else far
    rays = np.concatenate([rays_o, rays_d, near, far, viewdirs], axis=-1)
    if comp_radii:
        dx = np.sqrt(np.sum((rays_d[:-1] - rays_d[1:]) ** 2, -1))
        dx = np.concatenate([dx, dx[-2:-1]], axis=0)
        radii = dx[..., None] * 2.0 / np.sqrt(12.0)
        rays = np.concatenate([rays, radii], axis=-1)
    return rays.astype(np.float32)


def process_img(img_wh, img_path, load_mask=False):
    """Load + LANCZOS-resize an image -> (H, W, C) float [0,1] and the
    intrinsics scaler for the resize."""
    img_path = str(img_path)
    if "_aug" in img_path:
        name = img_path.split("_aug")
        img_path = name[0] + "." + name[1].split(".")[-1]
    img = Image.open(img_path)
    if load_mask:
        img = img.convert("L")
    sK = np.diag([img_wh[0] / img.size[0], img_wh[1] / img.size[1], 1.0])
    img = img.resize(tuple(img_wh), Image.LANCZOS)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr[..., :3] if not load_mask else arr, sK.astype(np.float32)


class NerfBaseDataset:
    def __init__(self, config, split: str = "train", val_num: int = 8,
                 debug: bool = False):
        self.config = config
        self.split = split
        self.scene = config.scene
        self.root_dir = Path(config.data_dir) / self.scene
        self.max_sample_num = getattr(config, "max_sample_num", None)
        self.val_num = 3 if debug else val_num
        self.img_wh = list(config.img_wh)
        self.ray_type = getattr(config, "ray_type", "normal")
        self.norm_ray_dir = getattr(config, "norm_ray_dir", True)
        self.downsample = getattr(config, "downsample", 1)

        frames = self.load_scene_frames(config)
        self.init_split_indices(self.dataset_size)
        self.init_scene_normalization(config)
        self.init_masks(config, frames)
        self.init_retrieval_pair(frames, config)

        if self.split == "train":
            self.process_train_data()

        self.frame_inds = {}
        for i in range(len(self.split_inds)):
            key = "_".join(frames[self.split_inds[i]]["file_path"].split("/"))[:-4]
            self.frame_inds[key] = self.split_inds[i]

    # ------------------------------------------------------------------
    def load_scene_frames(self, config, sort: bool = True):
        if hasattr(config, "scene_anno_path") and config.scene_anno_path:
            anno = config.scene_anno_path.replace("#scene", self.scene)
            self.train_json = anno.replace("#split", "train")
            self.test_json = anno.replace("#split", "test")
        else:
            self.train_json = str(self.root_dir / "transforms_train.json")
            self.test_json = str(self.root_dir / "transforms_test.json")
        self.scene_anno_path = (self.test_json if self.split == "test"
                                else self.train_json)
        self.scene_seq = (None if self.split == "test"
                          else getattr(config, "scene_seq", None))

        with open(self.scene_anno_path, "r") as f:
            frames = json.load(f)["frames"]
        if self.scene_seq is not None:
            frames = [f for f in frames
                      if f["file_path"].split("/")[0] == self.scene_seq]
        if sort:
            frames = sorted(frames, key=lambda x: x["file_path"])

        seq_ind = [f["file_path"].split("/")[0] for f in frames]
        seq_map = {s: i for i, s in enumerate(np.unique(seq_ind))}
        self.seq_ind = [seq_map[i] for i in seq_ind]
        self.img_paths = [self.root_dir / f["file_path"] for f in frames]
        self.img_idxs = [
            f["file_path"].replace("/", "_").replace(".color", "").replace(".png", "")
            for f in frames
        ]
        self.cam2scenes = [np.asarray(f["transform_matrix"], np.float64)
                           for f in frames]
        self.org_Ks = [np.asarray(f["intrinsics"], np.float64) for f in frames]
        self.dataset_size = len(frames)
        return frames

    def init_retrieval_pair(self, frames, config):
        self.pair_txt = (getattr(config, "train_pair_txt", None)
                         if self.split == "val" else None)
        if not self.pair_txt:
            return
        self.pair_txt = self.pair_txt.replace("$scene", config.scene) \
            .replace("#scene", config.scene)
        self.pair_ids = load_retrieval_pair_ids(frames, self.pair_txt, topk=10)

    def init_scene_normalization(self, config):
        self.snorm_type = getattr(config, "snorm_type", "fst")
        self.rescale_factor = getattr(config, "rescale_factor", 1.0)
        if self.snorm_type == "fst":
            self.max_frustum_depth = getattr(config, "max_frustum_depth", 10)
            self.scale_tag = (f"snfst_dep{self.max_frustum_depth}"
                              f"rs{self.rescale_factor}")
            snorm_json = getattr(config, "snorm_json", None) or self.train_json
            self.scene2s_scene = compute_scene_normalization_fst(
                snorm_json, self.max_frustum_depth, self.rescale_factor
            ).astype(np.float64)
        else:
            raise ValueError(f"Unknown snorm_type: {self.snorm_type}")
        self.unnorm_scene = np.linalg.inv(self.scene2s_scene)
        self.s_scaling = self.scene2s_scene[0, 0]
        self.cam2s_scenes = {
            idx: self.scene2s_scene @ c2w
            for idx, c2w in enumerate(self.cam2scenes)
        }

    def init_masks(self, config, frames):
        self.exclude_masks = getattr(config, "exclude_masks", True)
        self.white_bg = getattr(config, "white_bg", False)
        self.load_transient = getattr(config, "mask_transient", False)
        mask_dir = Path(getattr(config, "mask_dir", "data"))
        self.mask_trnz_paths = [mask_dir / "masks_trnz_cars" / self.scene /
                                f["file_path"] for f in frames]
        self.mask_bg_paths = [mask_dir / "masks_bg" / self.scene /
                              f["file_path"] for f in frames]

    def init_split_indices(self, num_samples):
        sample_inds = np.arange(num_samples)
        if self.split in ["train", "val", "val_check"]:
            frame_skip = len(sample_inds) // self.val_num
            val_inds = sample_inds[:: max(1, frame_skip)][: self.val_num]
            train_inds = np.asarray(
                [i for i in sample_inds if i not in val_inds])
            if self.max_sample_num and len(train_inds) > self.max_sample_num:
                # Reference-faithful (nerfbase.py:182): draws WITH
                # replacement (duplicate frames, some omitted) — kept
                # verbatim so subsampled training sees the reference's
                # frame distribution.
                np.random.seed(1357)
                train_inds = np.random.choice(train_inds, self.max_sample_num)
            self.split_inds = (val_inds if self.split in ["val", "val_check"]
                               else train_inds)
        else:
            self.split_inds = (sample_inds[: self.max_sample_num]
                               if self.max_sample_num else sample_inds)
        self.split_inds = np.sort(np.asarray(self.split_inds))

    # ------------------------------------------------------------------
    def mask_img_bg(self, img, sample_idx, ret_mask: bool = False):
        bg_mask, _ = process_img(self.img_wh, self.mask_bg_paths[sample_idx],
                                 load_mask=True)
        bg_mask = np.round(bg_mask)
        img = img * (1 - bg_mask) + bg_mask * np.array([1.0, 1.0, 1.0])
        return (img, bg_mask) if ret_mask else img

    def load_sample(self, sample_idx, exclude_mask: bool = True,
                    validation: bool = False, camera_only: bool = False,
                    camera_mat=None):
        cam2s_scene = self.cam2s_scenes[sample_idx]
        if camera_only:
            return cam2s_scene.astype(np.float32)
        if camera_mat is not None:
            cam2s_scene = np.asarray(camera_mat, np.float64)
        img, sK = process_img(self.img_wh, self.img_paths[sample_idx])
        K = sK.astype(np.float64) @ self.org_Ks[sample_idx]
        img_w, img_h = self.img_wh
        bg_mask = None
        if self.white_bg:
            img, bg_mask = self.mask_img_bg(img, sample_idx, ret_mask=True)

        img_ijs = np.argwhere(np.ones_like(img[..., 0], dtype=bool))
        rgbs = img.reshape(-1, 3).astype(np.float32)

        dirs = ray_dirs_np(img_h, img_w, K)
        rays_o, rays_d, viewdirs = rays_c2w_np(dirs, cam2s_scene)
        rays_d = viewdirs if self.norm_ray_dir else rays_d

        far, ok = rays_sphere_far_np(rays_o.reshape(-1, 3),
                                     viewdirs.reshape(-1, 3))
        if not ok:
            far = np.ones((img_h, img_w, 1))
        else:
            far = far.reshape(img_h, img_w, 1)

        rays = pack_rays_np(rays_o, rays_d, viewdirs, 0.01, far,
                            comp_radii=(self.ray_type == "mip"))
        rays = rays.reshape(-1, rays.shape[-1])

        sample = {
            "img_idx": self.img_idxs[sample_idx],
            "rgbs": rgbs,
            "rays": rays,
            "img_ijs": img_ijs.astype(np.int64),
            "img_wh": np.array([img_w, img_h], np.int64),
            "K": K.astype(np.float32),
            "ts": np.full((len(rays), 1), self.seq_ind[sample_idx], np.int64),
            "unnorm_scene": self.unnorm_scene.astype(np.float32),
            "seq_ind": self.seq_ind[sample_idx],
            "cam2scene": cam2s_scene.astype(np.float32),
            "cam2scene_org": self.cam2scenes[sample_idx].astype(np.float32),
        }
        if bg_mask is not None and self.downsample > 1:
            # Kept only for _data_downsample's sky_mask (cache grids).
            sample["_bg"] = bg_mask.reshape(-1, 1).astype(np.float32)

        if self.load_transient:
            mask, _ = process_img(self.img_wh, self.mask_trnz_paths[sample_idx],
                                  load_mask=True)
            mask = np.round(mask).reshape(-1, 1)
            sample["mask"] = 1 - mask
            if exclude_mask:
                keep = (1 - mask[:, 0]).astype(bool)
                n_rays = len(sample["rgbs"])
                for k, v in list(sample.items()):
                    if isinstance(v, np.ndarray) and v.ndim >= 1 \
                            and len(v) == n_rays:
                        sample[k] = v[keep]

        if self.downsample > 1:
            self._data_downsample(sample)
        return sample

    def _data_downsample(self, sample):
        ds = self.downsample
        img_w, img_h = sample["img_wh"]
        sample["r_orig"] = sample["rays"]
        for k in ["rgbs", "rays", "img_ijs", "ts", "mask", "_bg"]:
            if k in sample:
                v = sample[k].reshape(img_h, img_w, -1)
                sample[k] = v[ds // 2 :: ds, ds // 2 :: ds]
        sample["img_wh"] = sample["img_wh"] // ds
        if self.white_bg and ("_bg" in sample or "mask" in sample):
            # Sky/bg mask at the cache grid (Cambridge SAM-masked path):
            # 1 = masked-out (sky OR transient).  The reference's own
            # downsample path (nerfbase.py:251-253) references unbound
            # locals and can never run — this reconstructs its intent so
            # load_frame_3d(use_msk='sky') can actually drop the
            # white-composited far-sphere sky points from caches.
            gh, gw = img_h // ds, img_w // ds
            sky = np.zeros((gh, gw), np.float32)
            if "_bg" in sample:
                sky = np.maximum(sky, sample.pop("_bg").reshape(gh, gw))
            if "mask" in sample:
                sky = np.maximum(sky,
                                 1 - sample["mask"].reshape(gh, gw))
            sample["sky_mask"] = sky[None]

    def load_retrieval_pair_sample(self, sample_idx, validation: bool = True):
        kid = sample_idx % len(self.pair_ids[sample_idx])
        ret_idx = self.pair_ids[sample_idx][kid]
        s1 = self.load_sample(sample_idx, exclude_mask=False, validation=validation)
        s2 = self.load_sample(ret_idx, exclude_mask=False, validation=validation)
        sample = {
            "img_idx": [s1["img_idx"], s2["img_idx"]],
            "rays": np.concatenate([s1["rays"], s2["rays"]], 0),
            "rgbs": np.concatenate([s1["rgbs"], s2["rgbs"]], 0),
            "img_wh": np.concatenate([s1["img_wh"], s2["img_wh"]], 0),
            "K": np.concatenate([s1["K"], s2["K"]], 0),
            "seq_ind": [s1["seq_ind"], s2["seq_ind"]],
            "c2w": np.concatenate(
                [s1["unnorm_scene"] @ s1["cam2scene"],
                 s2["unnorm_scene"] @ s2["cam2scene"]], 0),
            "unnorm_scene": self.unnorm_scene.astype(np.float32),
        }
        if "mask" in s1:
            sample["mask"] = np.concatenate([s1["mask"], s2["mask"]], 0)
        return sample

    # ------------------------------------------------------------------
    def process_train_data(self):
        all_rays, all_rgbs, all_ijs, all_ts, all_msks = [], [], [], [], []
        for sample_idx in self.split_inds:
            s = self.load_sample(sample_idx, exclude_mask=self.exclude_masks)
            all_rays.append(s["rays"])
            all_rgbs.append(s["rgbs"])
            all_ijs.append(s["img_ijs"])
            all_ts.append(np.full((len(s["rays"]), 1), s["seq_ind"], np.int64))
            if "mask" in s:
                all_msks.append(s["mask"])
        self.all_wh = s["img_wh"]
        self.all_rays = np.concatenate(all_rays, 0)
        self.all_rgbs = np.concatenate(all_rgbs, 0)
        self.all_img_ijs = np.concatenate(all_ijs, 0)
        self.all_ts = np.concatenate(all_ts, 0)
        self.all_msks = np.concatenate(all_msks, 0) if all_msks else None

    def getframe(self, frame_name, camera_only: bool = False, id: bool = False,
                 camera_input=None):
        if camera_only:
            if id:
                return self.load_sample(frame_name, camera_only=True)
            if frame_name in self.frame_inds:
                return self.load_sample(self.frame_inds[frame_name],
                                        camera_only=True)
            return None
        if camera_input is not None:
            return self.load_sample(0, exclude_mask=False, validation=True,
                                    camera_mat=camera_input)
        return self.load_sample(self.frame_inds[frame_name],
                                exclude_mask=False, validation=True)

    def __len__(self):
        if self.split == "train":
            return len(self.all_rays)
        return len(self.split_inds)

    def __getitem__(self, idx):
        if self.split in ["train", "all"]:
            sample = {
                "rays": self.all_rays[idx],
                "rgbs": self.all_rgbs[idx],
                "ts": self.all_ts[idx],
                "img_ijs": self.all_img_ijs[idx],
                "img_wh": self.all_wh,
            }
            if self.load_transient and self.all_msks is not None:
                sample["mask"] = self.all_msks[idx]
            return sample
        if self.pair_txt:
            return self.load_retrieval_pair_sample(self.split_inds[idx])
        return self.load_sample(self.split_inds[idx], exclude_mask=False,
                                validation=True)

    def ray_batches(self, batch_size: int, rng: np.random.Generator,
                    drop_last: bool = True):
        """Shuffled fixed-size ray batches over the preloaded train rays.
        ``batch_size`` is the global batch: every process draws the same
        permutation (the trainer seeds ``rng`` alike on every rank) and
        yields its contiguous block of each batch (``local_slice``)."""
        if self.split != "train":
            raise ValueError("ray_batches serves the train split")
        pid, pcount = process_info()
        n = len(self.all_rays)
        perm = rng.permutation(n)
        end = n - (n % batch_size) if drop_last else n
        for i in range(0, end, batch_size):
            idx = perm[i : i + batch_size]
            idx = idx[local_slice(len(idx), pid, pcount)]
            batch = {
                "rays": self.all_rays[idx],
                "rgbs": self.all_rgbs[idx],
                "ts": self.all_ts[idx, 0],
            }
            if self.all_msks is not None:
                batch["mask"] = self.all_msks[idx]
            yield batch

    def __repr__(self):
        return (f"NerfBaseDataset(split={self.split} samples={len(self)} "
                f"img_wh={self.img_wh} downsample={self.downsample} "
                f"annotations={self.scene_anno_path} tag={self.scale_tag})")
