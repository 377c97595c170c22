"""Loader factory (counterpart of ``nerfmatch_tpu/data/loaders.py``): the
dataset by ``config.dataset`` name (``NerfBaseDataset``, ``NeRFMatchBase``,
``NeRFMatchPair``), the single-scene ``scenes: [x]`` form with its
``#scene`` substitutions, and a batch loader that stacks numpy samples, with
the JAX loader's ordered background-thread prefetch (``num_workers > 0``)
so the host's image decode overlaps the device step.  Multi-scene and mixed
configs raise.
"""

from __future__ import annotations

import queue
import threading
from argparse import Namespace

import numpy as np

from .match_dataset import NeRFMatchBase, NeRFMatchMultiPair, NeRFMatchPair
from .nerf_dataset import NerfBaseDataset

DATASETS = {"NerfBaseDataset": NerfBaseDataset, "NeRFMatchBase": NeRFMatchBase,
            "NeRFMatchPair": NeRFMatchPair,
            "NeRFMatchMultiPair": NeRFMatchMultiPair}


def _collate(samples):
    """Stack dict samples into batched numpy arrays (non-array values
    become lists)."""
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.integer, np.floating, bool)):
            out[k] = np.asarray(vals)
        else:
            out[k] = vals
    return out


class DataLoader:
    """Shuffled (or ordered) index batches collated into numpy dicts;
    ``num_workers > 0`` builds them in one background thread, in order, two
    batches ahead.  A dataset error reaches the consumer."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 num_workers: int = 0, drop_last: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = num_workers > 0
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            idx = self._rng.permutation(idx)
        end = (len(idx) // self.batch_size * self.batch_size
               if self.drop_last else len(idx))
        for i in range(0, end, self.batch_size):
            yield _collate([self.dataset[int(j)]
                            for j in idx[i:i + self.batch_size]])

    @staticmethod
    def _put(q, stop, item) -> bool:
        """Queue ``item`` unless the consumer stopped -> whether it was."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, q, stop):
        try:
            for batch in self._batches():
                if not self._put(q, stop, batch):
                    return
            self._put(q, stop, None)
        except Exception as e:  # noqa: BLE001 -- re-raised by the consumer
            self._put(q, stop, e)

    def __iter__(self):
        if not self.prefetch:
            yield from self._batches()
            return
        q, stop = queue.Queue(maxsize=2), threading.Event()
        t = threading.Thread(target=self._produce, args=(q, stop), daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def _single_scene(config):
    """``scenes: [x]`` -> the config of scene x, with ``#scene`` replaced in
    the scene dir and the pair files (the JAX multi-scene expansion of one
    scene)."""
    scenes = list(config.scenes)
    if len(scenes) != 1:
        raise NotImplementedError(
            f"multi-scene configs ({len(scenes)} scenes) are not ported "
            f"(ROADMAP: datasets and loaders)")
    sconf = {"scene": scenes[0]}
    for k, v in vars(config).items():
        if k == "scenes":
            continue
        if k in ("scene_dir", "train_pair_txt", "test_pair_txt") \
                and isinstance(v, str) and "#" in v:
            v = v.replace("#scene", scenes[0])
        sconf[k] = v
    return Namespace(**sconf)


def init_data_loader(config, batch_size: int = 1, split: str = "train",
                     debug: bool = False, num_workers: int = 0):
    if hasattr(config, "datasets") or config.dataset not in DATASETS:
        raise NotImplementedError(
            f"dataset {getattr(config, 'dataset', None)!r} (or a mixed config) "
            f"is not ported; the port loads {sorted(DATASETS)} (ROADMAP: "
            f"datasets and loaders)")
    if hasattr(config, "scenes"):
        config = _single_scene(config)
    dataset = DATASETS[config.dataset](config, split=split, debug=debug)
    if split == "train":
        return DataLoader(dataset, batch_size=batch_size, shuffle=True,
                          num_workers=num_workers, drop_last=True)
    return DataLoader(dataset, batch_size=1, shuffle=False,
                      num_workers=num_workers)
