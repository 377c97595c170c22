"""Device meshes and placement (counterpart of
``nerfmatch_tpu/parallel/mesh.py``).

Two kinds of parallelism, as in the JAX package:

* **training** runs one process per GPU (``parallel.distributed``): each
  process loads its block of the global batch, :func:`shard_batch` moves it
  to its device, :func:`replicate_params` broadcasts rank 0's weights, and
  :func:`all_gather_host` gathers validation metrics;
* **evaluation sharding** runs in one process over a :class:`Mesh`, an
  ordered list of local devices (``point_sharding``, ``pair_sharding``,
  ``render_sharding``): a tensor is split over the mesh's ``data`` axis
  (:func:`device_put` with :func:`data_sharding`) or copied to every device
  (:func:`replicated`), and a collective is a move of small per-row
  statistics to the first device.  A device may appear more than once, which
  runs the sharded arithmetic on one GPU.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import weakref
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered tuple of local devices along the ``data`` axis."""
    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(data: int | None = None, model: int = 1, devices=None) -> Mesh:
    """A ``data`` mesh over the first ``data`` of ``devices`` (default: every
    CUDA device)."""
    if model != 1:
        raise NotImplementedError(
            "no trainer builds a model axis: both trainers and the evaluator "
            "shard the data axis only (the JAX package's model axis served "
            "its TPU tensor-parallel dry run)")
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no CUDA device: pass devices= for a CPU mesh")
    devices = [torch.device(d) for d in devices]
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d for d in devices]
    data = len(devices) if data is None else data
    assert 0 < data <= len(devices), f"mesh {data} > {len(devices)} devices"
    return Mesh(tuple(devices[:data]))


class Sharding(NamedTuple):
    """How a tensor lies on a mesh: split on ``dim`` over the data axis, or
    a copy on every device (``dim`` None)."""
    mesh: Mesh
    dim: int | None


def data_sharding(mesh: Mesh, dim: int = 0) -> Sharding:
    """Split ``dim`` over the data axis (dim 0: the batch or ray axis)."""
    return Sharding(mesh, dim)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def device_put(x, sharding: Sharding) -> list:
    """``x`` placed by ``sharding`` -> one tensor a mesh device: equal
    contiguous blocks of ``dim`` (which must divide by the mesh size), or
    copies."""
    x = torch.as_tensor(x)
    mesh, dim = sharding
    if dim is None:
        return [x.to(d) for d in mesh.devices]
    n = x.shape[dim]
    assert n % mesh.size == 0, f"dim {dim} ({n}) % mesh {mesh.size} != 0"
    return [blk.to(d) for blk, d in zip(x.split(n // mesh.size, dim),
                                        mesh.devices)]


def on_device(device):
    """A context in which ``device`` is the current CUDA device (nothing for
    a CPU device): a shard's work runs in it, so what reads the current
    device (a kernel's grid size, a stream) reads the shard's."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


_REPLICAS = weakref.WeakKeyDictionary()


def weights_key(module):
    """What a copy of ``module`` depends on: its config, every tensor's
    storage and in-place version (an optimizer step or ``load_state_dict``
    bumps it), and the int8 scales of a renderer."""
    return (repr(getattr(module, "cfg", None)),
            id(getattr(module, "act_scales", None)),
            tuple((t.data_ptr(), t._version)
                  for t in module.state_dict().values()))


def replicas(module, mesh: Mesh) -> list:
    """``module`` on each mesh device: itself where it lies, elsewhere a
    copy, cached per mesh and dropped when the weights or the config
    change."""
    home = next(module.parameters()).device
    key = weights_key(module)
    cache = _REPLICAS.get(module)
    if cache is None or cache[0] != key:
        cache = (key, {})
        _REPLICAS[module] = cache
    copies = cache[1]
    out = []
    for d in mesh.devices:
        if d == home:
            out.append(module)
            continue
        if d not in copies:
            copies[d] = copy.deepcopy(module).to(d)
        out.append(copies[d])
    return out


def shard_batch(batch: dict, mesh: Mesh) -> list:
    """A dict of host arrays -> one dict a mesh device with its block of
    the batch dim (strings, objects and scalars stay host-side).  A training
    process's mesh is its own device: the dict holds this rank's rows
    (``data.loaders.DataLoader``), moved to it."""
    out = [{} for _ in mesh.devices]
    for k, v in batch.items():
        arr = np.asarray(v)
        if arr.dtype.kind not in "fiub" or arr.ndim == 0:
            parts = [v] * mesh.size
        else:
            parts = device_put(torch.from_numpy(np.ascontiguousarray(arr)),
                               data_sharding(mesh))
        for o, p in zip(out, parts):
            o[k] = p
    return out


def replicate_params(module):
    """Rank 0's parameters and buffers on every rank of the process group
    (a broadcast; nothing without a group) -> ``module``."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        with torch.no_grad():
            for t in module.state_dict().values():
                dist.broadcast(t, src=0)
    return module


def all_gather_host(values):
    """Every rank's list of host values, concatenated in rank order (one
    process: ``values`` unchanged) -- the reference's ``all_gather_object``
    of validation metrics."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return values
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, list(values))
    return [v for part in gathered for v in part]
