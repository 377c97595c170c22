"""Annotation and retrieval-pair helpers (counterpart of the parts of
``nerfmatch_tpu/data/loading.py`` that ``NerfBaseDataset`` needs), numpy
only."""

from __future__ import annotations

from collections import defaultdict

import numpy as np


def frame_cache_name(fname: str) -> str:
    """Image path -> scene-point cache stem (reference ``data_loading.py:40``)."""
    return fname.replace("/", "_").replace(".color", "").replace(".png", "")


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
