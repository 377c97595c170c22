"""Loader factory (counterpart of ``nerfmatch_tpu/data/loaders.py``): the
dataset by ``config.dataset`` name (``NerfBaseDataset``, ``NeRFMatchBase``,
``NeRFMatchPair``, ``NeRFMatchMultiPair``: the JAX registry); a ``scenes``
list expanded into one dataset per scene with its ``#scene``
substitutions, concatenated (:class:`ConcatDataset`, so one matcher trains
over several scenes' caches) or as a list (``concat=False``, the
localization benchmark's scene loop); a mixed config (``datasets``: named
sub-configs, each merged over the top-level keys and expanded in turn);
and a batch loader that stacks numpy samples, with the JAX loader's
ordered background-thread prefetch (``num_workers > 0``) so the host's
image decode overlaps the device step.
"""

from __future__ import annotations

import queue
import threading
from argparse import Namespace

import numpy as np

from ..config import merge_configs
from ..parallel.distributed import local_slice, process_info
from .match_dataset import NeRFMatchBase, NeRFMatchMultiPair, NeRFMatchPair
from .nerf_dataset import NerfBaseDataset

DATASETS = {"NerfBaseDataset": NerfBaseDataset, "NeRFMatchBase": NeRFMatchBase,
            "NeRFMatchPair": NeRFMatchPair,
            "NeRFMatchMultiPair": NeRFMatchMultiPair}


class ConcatDataset:
    """Datasets end to end: item ``i`` is item ``i - offset`` of the dataset
    whose range holds it."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, idx):
        d = int(np.searchsorted(self.offsets, idx, side="right") - 1)
        return self.datasets[d][idx - int(self.offsets[d])]


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
    batches ahead.  A dataset error reaches the consumer.

    Data-parallel training: ``batch_size`` is the global batch, and process
    ``process_index`` of ``process_count`` loads its contiguous block of
    every global batch (every process shuffles with the same seed)."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 num_workers: int = 0, drop_last: bool = False, seed: int = 0,
                 process_index: int = 0, process_count: int = 1):
        assert batch_size % process_count == 0, \
            f"global batch {batch_size} % processes {process_count} != 0"
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = num_workers > 0
        self.rows = local_slice(batch_size, process_index, process_count)
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
                            for j in idx[i:i + self.batch_size][self.rows]])

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


def _scene_config(config, scene):
    """The config of one scene of ``config.scenes``, with ``#scene``
    replaced in the scene dir and the pair files."""
    sconf = {"scene": scene}
    for k, v in vars(config).items():
        if k == "scenes":
            continue
        if k in ("scene_dir", "train_pair_txt", "test_pair_txt") \
                and isinstance(v, str) and "#" in v:
            v = v.replace("#scene", scene)
        sconf[k] = v
    return Namespace(**sconf)


def _dataset_class(config):
    """The dataset class of ``config.dataset`` (a ``KeyError`` for a name
    outside :data:`DATASETS`, as the JAX registry lookup)."""
    if config.dataset not in DATASETS:
        raise KeyError(f"unknown dataset {config.dataset!r}; the registry "
                       f"holds {sorted(DATASETS)}")
    return DATASETS[config.dataset]


def init_multiscene_dataset(config, split: str = "train", concat: bool = True,
                            debug: bool = False):
    """One dataset per scene of ``config.scenes`` (``#scene`` substituted),
    concatenated, or as a list (``concat=False``)."""
    cls = _dataset_class(config)
    ms = [cls(_scene_config(config, s), split=split, debug=debug)
          for s in config.scenes]
    return ConcatDataset(ms) if concat else ms


def init_mixed_dataset(config, split: str = "train", concat: bool = True,
                       debug: bool = False):
    """The datasets of a mixed config: each entry of ``config.datasets``
    merged over ``config`` (its keys win) and expanded by its ``scenes``,
    in order; concatenated, or as a list (``concat=False``)."""
    mixed = []
    for _, dt_config in vars(config.datasets).items():
        mixed += init_multiscene_dataset(merge_configs(config, dt_config),
                                         split=split, concat=False,
                                         debug=debug)
    return ConcatDataset(mixed) if concat else mixed


def init_data_loader(config, batch_size: int = 1, split: str = "train",
                     debug: bool = False, num_workers: int = 0):
    """The loader of ``config``: a mixed config (``datasets``), a
    multi-scene one (``scenes``, any length) or one dataset, in the JAX
    order; the train split shuffled in whole batches, the others in order,
    one sample a batch; the train loader loads this process's block of each
    global batch (``parallel.distributed.process_info``)."""
    if hasattr(config, "datasets"):
        dataset = init_mixed_dataset(config, split=split, debug=debug)
    elif hasattr(config, "scenes"):
        dataset = init_multiscene_dataset(config, split=split, debug=debug)
    else:
        dataset = _dataset_class(config)(config, split=split, debug=debug)
    if split == "train":
        pid, pcount = process_info()
        return DataLoader(dataset, batch_size=batch_size, shuffle=True,
                          num_workers=num_workers, drop_last=True,
                          process_index=pid, process_count=pcount)
    return DataLoader(dataset, batch_size=1, shuffle=False,
                      num_workers=num_workers)
