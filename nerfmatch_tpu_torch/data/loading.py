"""Annotation, retrieval-pair and scene-cache helpers (counterpart of the
parts of ``nerfmatch_tpu/data/loading.py`` that ``NerfBaseDataset`` and the
matcher datasets need), numpy only."""

from __future__ import annotations

import os
import random
from collections import defaultdict

import numpy as np

SEVEN_SCENES = ["heads", "chess", "fire", "office", "pumpkin", "redkitchen",
                "stairs"]
CAMBRIDGE_LANDMARKS = ["KingsCollege", "OldHospital", "ShopFacade",
                       "StMarysChurch", "GreatCourt"]


def frame_cache_name(fname: str) -> str:
    """Image path -> scene-point cache stem (reference ``data_loading.py:40``)."""
    return fname.replace("/", "_").replace(".color", "").replace(".png", "")


def load_frame_3d(frame, scene_dir, use_msk=None, return_pose: bool = False):
    """A frame's cached NeRF scene points (the ``.npy`` schema written by
    ``NerfEvaluator.cache_scene_pts``) -> (pt3d, pt_feat, mask,
    unnorm_scene[, c2w]).  ``use_msk`` reads the cache key of its mode."""
    pt_path = os.path.join(scene_dir, f"{frame_cache_name(frame['file_path'])}.npy")
    scene_pts = np.load(pt_path, allow_pickle=True).item()
    pt3d = scene_pts["pt3d"]
    unnorm_scene = scene_pts["unnorm_scene"]
    c2w = unnorm_scene @ scene_pts["cam2scene"] if "cam2scene" in scene_pts \
        else None
    mask = np.ones(len(pt3d), dtype=bool)
    if use_msk:
        if use_msk == "sky" and "sky_mask" in scene_pts:
            mask = (1 - scene_pts["sky_mask"][0].reshape(-1)).astype(bool)
        elif use_msk == "corr" and "corr_mask" in scene_pts:
            mask = (1 - scene_pts["corr_mask"].reshape(-1)).astype(bool)
        elif "pt_mask" in scene_pts:
            mask = (1 - scene_pts["pt_mask"][0].reshape(-1)).astype(bool)
    if return_pose:
        return pt3d, scene_pts["pt_feat"], mask, unnorm_scene, c2w
    return pt3d, scene_pts["pt_feat"], mask, unnorm_scene


def split_val_ids(total_num: int, chunck_size: int = 4, val_percent: float = 0.1):
    """Uniformly-spread chunks forming the validation subset."""
    chunck_num = total_num // chunck_size
    val_num = int(val_percent * total_num)
    ids = np.array_split(np.arange(total_num), chunck_num)
    skip = len(ids) // max(val_num // chunck_size, 1)
    return np.concatenate(ids[::skip])[:val_num]


def load_retrieval_pair_ids(frames, pair_txt, topk: int = 1):
    """Same-frame-set pair ids {qid: [rids]} for NeRF pose-val metrics."""
    im2ids = {f["file_path"]: i for i, f in enumerate(frames)}
    pair_ids = defaultdict(list)
    with open(pair_txt, "r") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            qim, rim = parts[:2]
            if qim not in im2ids or rim not in im2ids:
                continue
            qlist = pair_ids[im2ids[qim]]
            if len(qlist) < topk:
                qlist.append(im2ids[rim])
    return pair_ids


def load_topk_retrieval_pairs(pair_txt, kmax: int = 5, mode: str = "top"):
    """'(query ref)' lines, at most ``kmax`` refs per query (``mode='random'``
    samples them with the ``random`` module)."""
    k_count = defaultdict(int)
    pairs, all_pairs = [], defaultdict(list)
    with open(pair_txt, "r") as f:
        for line in f:
            pair = line.split()[:2]
            if len(pair) < 2:
                continue
            if mode == "random":
                all_pairs[pair[0]].append(pair)
            if kmax > 0 and k_count[pair[0]] >= kmax:
                continue
            pairs.append(pair)
            k_count[pair[0]] += 1
    if mode == "random":
        pairs = []
        for k in all_pairs:
            pairs += random.sample(all_pairs[k], kmax)
    return pairs


def load_retrieval_pairs(pair_txt):
    """All '(query ref)' lines -> {query: [refs...]}."""
    pairs = defaultdict(list)
    with open(pair_txt, "r") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                pairs[parts[0]].append(parts[1])
    return pairs


def parse_pair_ids(qframes, rframes, pairs, split: str = "train",
                   val_num: int = 500):
    """Name pairs -> (qid, rid) with an interleaved train/val split."""
    rname2ids = {f["file_path"]: i for i, f in enumerate(rframes)}
    qname2ids = {f["file_path"]: i for i, f in enumerate(qframes)}
    if split == "test":
        return [(qname2ids[q], rname2ids[r]) for q, r in pairs
                if q in qname2ids and r in rname2ids]
    val_num = min(len(pairs) // 5, val_num)
    skip = max(len(pairs) // max(val_num, 1), 1)
    val_indices = set(np.arange(len(pairs))[::skip][:val_num].tolist())
    train_ids, val_ids = [], []
    for i, (qname, rname) in enumerate(pairs):
        if qname in qname2ids and rname in rname2ids:
            ids = (qname2ids[qname], rname2ids[rname])
            (val_ids if i in val_indices else train_ids).append(ids)
    return train_ids if split == "train" else val_ids


def parse_pair_ids_balanced(qframes, rframes, pairs, split: str = "train",
                            val_num: int = 500):
    """Balanced split: the val queries are uniformly spread chunks of the
    query set (the same across pair_topk settings); seeds numpy's global
    generator with ``val_num``, as the reference does."""
    np.random.seed(val_num)
    rname2ids = {f["file_path"]: i for i, f in enumerate(rframes)}
    qname2ids = {f["file_path"]: i for i, f in enumerate(qframes)}
    if split == "test":
        return [(qname2ids[q], rname2ids[r]) for q, r in pairs
                if q in qname2ids and r in rname2ids]
    val_qids = set(split_val_ids(len(qframes), val_percent=0.1).tolist())
    train_pairs, val_pairs = [], []
    for qname, rname in pairs:
        if qname not in qname2ids:
            continue
        qid = qname2ids[qname]
        if qid in val_qids:
            if rname in rname2ids:
                val_pairs.append((qid, rname2ids[rname]))
        elif rname in rname2ids:
            train_pairs.append((qid, rname2ids[rname]))
        elif "_aug" in rname:
            # The reference's name pass-through for augmented refs.
            train_pairs.append((qid, rname))
    if val_num < len(val_pairs):
        ids = np.random.permutation(len(val_pairs))
        val_pairs = [val_pairs[i] for i in ids[:val_num]]
    return train_pairs if split == "train" else val_pairs


def parse_multipair_ids_balanced(qframes, rframes, pairs, split: str = "train",
                                 val_num: int = 500):
    """Multi-pair variant: {qid: [rids...]} (refs missing from ``rframes``
    dropped) with the balanced val split; seeds numpy's global generator
    with ``val_num``, as the reference does."""
    np.random.seed(val_num)
    rname2ids = {f["file_path"]: i for i, f in enumerate(rframes)}
    qname2ids = {f["file_path"]: i for i, f in enumerate(qframes)}

    def ridlist(rnames):
        return [rname2ids[r] for r in rnames if r in rname2ids]

    if split == "test":
        return {qname2ids[q]: ridlist(rs) for q, rs in pairs.items()
                if q in qname2ids}
    val_qids = set(split_val_ids(len(qframes), val_percent=0.1).tolist())
    train_pairs, val_pairs = {}, {}
    for qname, rnames in pairs.items():
        if qname not in qname2ids:
            continue
        qid = qname2ids[qname]
        (val_pairs if qid in val_qids else train_pairs)[qid] = ridlist(rnames)
    if val_num < len(val_pairs):
        keys = list(val_pairs.keys())
        ids = np.random.permutation(len(keys))
        val_pairs = {keys[i]: val_pairs[keys[i]] for i in ids[:val_num]}
    return train_pairs if split == "train" else val_pairs
