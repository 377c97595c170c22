"""Loader factory for NeRF training (counterpart of
``nerfmatch_tpu/data/loaders.py`` for ``NerfBaseDataset``): the dataset by
``config.dataset`` name and a batch loader that stacks numpy samples.  The
matcher datasets, multi-scene and mixed configs are not ported and raise.
"""

from __future__ import annotations

import numpy as np

from .nerf_dataset import NerfBaseDataset

DATASETS = {"NerfBaseDataset": NerfBaseDataset}


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
    """Shuffled (or ordered) index batches collated into numpy dicts, in
    one process (the JAX loader's thread prefetch is not needed here: the
    NeRF trainer draws ray batches straight from the preloaded arrays)."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            idx = self._rng.permutation(idx)
        end = (len(idx) // self.batch_size * self.batch_size
               if self.drop_last else len(idx))
        for i in range(0, end, self.batch_size):
            yield _collate([self.dataset[int(j)]
                            for j in idx[i:i + self.batch_size]])


def init_data_loader(config, batch_size: int = 1, split: str = "train",
                     debug: bool = False):
    if hasattr(config, "datasets") or hasattr(config, "scenes") \
            or config.dataset not in DATASETS:
        raise NotImplementedError(
            f"dataset {getattr(config, 'dataset', None)!r} (or a multi-scene "
            f"/ mixed config) is not ported; the port loads "
            f"{sorted(DATASETS)} (ROADMAP: datasets and loaders)")
    dataset = DATASETS[config.dataset](config, split=split, debug=debug)
    if split == "train":
        return DataLoader(dataset, batch_size=batch_size, shuffle=True,
                          drop_last=True)
    return DataLoader(dataset, batch_size=1, shuffle=False)
