"""Pair-axis-sharded multi-pair matching (counterpart of
``nerfmatch_tpu/parallel/pair_sharding.py``).

Top-k retrieval matches one query image against K reference point sets;
the pairs are independent, so the K axis splits over the mesh: each device
runs its K/d pairs one after the other with the query's image features
copied to it, and the stacked (K, ...) outputs come back to the first
device.  Complements ``point_sharding``, which splits the points of one
merged matching problem.
"""

from __future__ import annotations

import torch

from .mesh import data_sharding, device_put, on_device


def map_pairs_sharded(mesh, one_pair, args_k):
    """``one_pair(shard, *args)`` for each pair of ``args_k`` (tensors with
    a leading pair axis K), the pairs split over the mesh -> dict of the
    outputs stacked (K, ...) on the first device.  K is padded to a
    multiple of the mesh size by repeating the first pair (the padding's
    outputs are dropped), so any K runs on any mesh; the pairs are issued
    to the devices in turn, so the devices work at once."""
    K = args_k[0].shape[0]
    K_pad = -(-K // mesh.size) * mesh.size
    parts = [device_put(torch.cat([x, x[:1].expand(K_pad - K, *x.shape[1:])]),
                        data_sharding(mesh)) for x in args_k]
    per = K_pad // mesh.size
    outs = [[None] * per for _ in range(mesh.size)]
    for k in range(per):
        for s, dev in enumerate(mesh.devices):
            with on_device(dev):
                outs[s][k] = one_pair(s, *(p[s][k] for p in parts))
    first = mesh.devices[0]
    flat = [o for shard in outs for o in shard][:K]
    return {name: torch.stack([o[name].to(first) for o in flat])
            for name in flat[0]}
