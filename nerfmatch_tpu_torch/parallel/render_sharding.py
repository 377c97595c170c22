"""Ray-axis-sharded fused rendering (counterpart of
``nerfmatch_tpu/parallel/render_sharding.py``).

Rays are independent: the rays (and an appearance NeRF's per-ray rows)
split over the mesh's devices, each device runs the serving render
(``NerfRenderer.fused_render``: the coarse stage, the resample, the fine
stage; kernels 1b, 2 and 1 on CUDA) on its block with a copy of the
renderer, and the outputs are concatenated in order on the first device.
"""

from __future__ import annotations

import torch

from ..ops.kernels.render_kernel import TILE_RAYS
from .mesh import (data_sharding, device_put, on_device, replicas,
                   weights_key)


def make_sharded_render(mesh, renderer):
    """-> ``render(rays, app=None)``: (N, 12) rays, N divisible by the mesh
    size times ``TILE_RAYS`` (the kernels' ray tile), and for an appearance
    NeRF the (N, 16) rows of each ray -> the fused render's outputs (N,
    ...) on the first device.  The int8 scales are calibrated on the whole
    batch first, as ``fused_predict`` calibrates them.  Each copy's kernel
    weights are packed once and kept until the weights change."""
    app_dim = 16 if renderer.cfg.appearance_embedding else 0
    packs = {}

    def packed(reps):
        key = weights_key(renderer)
        if packs.get("key") != key:
            packs.clear()
            packs["key"] = key
        out = []
        for r, dev in zip(reps, mesh.devices):
            if id(r) not in packs:
                with on_device(dev):
                    packs[id(r)] = r.pack_fused()
            out.append(packs[id(r)])
        return out

    def render(rays, app=None):
        if app_dim and app is None:
            raise ValueError("appearance-embedding renderer: pass per-ray "
                             "app rows (embedding_a.weight[ray_id]) as the "
                             "second argument")
        n = rays.shape[0]
        assert n % (mesh.size * TILE_RAYS) == 0, \
            f"rays {n} % (mesh {mesh.size} x ray tile {TILE_RAYS}) != 0"
        renderer._ensure_int8_calibrated(rays)
        parts = device_put(rays, data_sharding(mesh))
        apps = device_put(app, data_sharding(mesh)) if app_dim \
            else [None] * mesh.size
        reps = replicas(renderer, mesh)
        outs = []
        for r, w, dev, x, a in zip(reps, packed(reps), mesh.devices, parts,
                                   apps):
            with on_device(dev):
                outs.append(r.fused_render(x.contiguous(), w, app=a))
        first = mesh.devices[0]
        return {k: torch.cat([o[k].to(first) for o in outs]) for k in outs[0]}

    return render
