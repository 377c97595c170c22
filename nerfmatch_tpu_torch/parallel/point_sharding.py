"""Point-axis-sharded coarse matching (counterpart of
``nerfmatch_tpu/parallel/point_sharding.py``).

A merged multi-pair point cloud grows N (``pair_topk`` x 3600 points) and
the (M, N) dual softmax with it.  Here each mesh device holds all M image
tokens and an N/d block of the points and computes its (B, M, N/d) block of
the confidence matrix; the softmax over M is local to a block, and the
softmax over the global point axis and the match extraction combine (B, M)
row statistics on the first device (row max, row sum, row max of the
confidence, each block's best value and index), never the matrix itself.
Blocks combine in shard order, so the first index wins a tie, as in the
dense :func:`nerfmatch_tpu_torch.ops.matching.extract_mutual_matches`.  The
similarity stays f32 (callers keep TF32 off).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.matching import NEG_INF, safe_normalize
from .mesh import data_sharding, device_put, on_device, replicated


def _to(parts, device):
    return torch.stack([p.to(device) for p in parts])


def sharded_point_match(mesh, im_feat, pt_feat, temperature, im_mask=None,
                        pt_mask=None, temp_type: str = "mul",
                        mutual: bool = True, threshold: float = 0.0):
    """Dual softmax + mutual match extraction with the points split over
    the mesh.  im_feat (B, M, D), pt_feat (B, N, D) with N divisible by the
    mesh size -> dict(j_ids (global point indices), mconf, valid), each
    (B, M) on the mesh's first device, as ``extract_mutual_matches``
    returns them."""
    B, M, _ = im_feat.shape
    N = pt_feat.shape[1]
    n = mesh.size
    assert N % n == 0, f"point count {N} % mesh size {n} != 0"
    if im_mask is None:
        im_mask = im_feat.new_ones((B, M))
    if pt_mask is None:
        pt_mask = pt_feat.new_ones((B, N))
    rep = replicated(mesh)
    cols = data_sharding(mesh, dim=1)
    temperature = torch.as_tensor(temperature, dtype=torch.float32)
    shards = []
    for im, pt, im_m, pt_m, temp in zip(
            device_put(safe_normalize(im_feat), rep),
            device_put(pt_feat, cols), device_put(im_mask.float(), rep),
            device_put(pt_mask.float(), cols), device_put(temperature, rep)):
        sim = torch.einsum("bmd,bnd->bmn", im, safe_normalize(pt))
        sim = sim / temp if temp_type == "div" else sim * temp
        valid = (im_m[:, :, None] * pt_m[:, None, :]) > 0
        sim = torch.where(valid, sim, torch.full_like(sim, NEG_INF))
        # The softmax over the image tokens: every column is on this shard.
        e = torch.exp(sim - sim.amax(dim=1, keepdim=True))
        shards.append((sim, e / e.sum(dim=1, keepdim=True), valid))

    first = mesh.devices[0]
    row_max = _to([s.amax(dim=2) for s, _, _ in shards], first).amax(0)
    row_sum = _to([torch.exp(s - row_max.to(s.device)[..., None]).sum(2)
                   for s, _, _ in shards], first).sum(0)
    confs = []
    for sim, soft_m, valid in shards:
        dev = sim.device
        conf = soft_m * (torch.exp(sim - row_max.to(dev)[..., None])
                         / row_sum.to(dev)[..., None])
        confs.append(torch.where(valid, conf, torch.zeros_like(conf)))
    conf_max = _to([c.amax(dim=2) for c in confs], first).amax(0)

    best, best_j, any_valid = [], [], []
    for s, conf in enumerate(confs):
        row_best = conf_max.to(conf.device)[..., None]
        mask = (conf > threshold) & (conf == row_best)
        if mutual:
            mask = mask & (conf == conf.amax(dim=1, keepdim=True))
        masked = torch.where(mask, conf, torch.zeros_like(conf))
        j = masked.argmax(dim=2)
        best.append(torch.gather(masked, 2, j[..., None])[..., 0])
        best_j.append(j + s * (N // n))
        any_valid.append(mask.any(dim=2))
    best, best_j = _to(best, first), _to(best_j, first)
    # The first shard holding the row's best value: the first index wins.
    shard = best.argmax(dim=0, keepdim=True)
    valid = _to(any_valid, first).any(0)
    mconf = torch.gather(best, 0, shard)[0]
    return {"j_ids": torch.gather(best_j, 0, shard)[0].to(torch.int32),
            "mconf": torch.where(valid, mconf, torch.zeros_like(mconf)),
            "valid": valid}


def make_sharded_fine_stage(mesh, fine_local):
    """Shard the c2f fine stage over the flat match axis: every match's
    window gather, window attention and soft-argmax is independent, so the
    (L,) id lists split over the mesh while the feature maps are copied to
    every device.  ``fine_local(shard, fmap_f, im_cfeat, pt_cfeat, b_ids,
    i_ids, j_ids)`` -> (L_shard, 3) on shard ``shard``'s device.  Returns
    ``call(fmap_f, im_cfeat, pt_cfeat, b_ids, i_ids, j_ids)`` -> (L, 3) on
    the first device: L padded to the mesh size, the padding stripped."""
    def call(fmap_f, im_cfeat, pt_cfeat, b_ids, i_ids, j_ids):
        L = b_ids.shape[0]
        pad = (-L) % mesh.size
        reps = [device_put(x, replicated(mesh))
                for x in (fmap_f, im_cfeat, pt_cfeat)]
        ids = [device_put(F.pad(x, (0, pad)), data_sharding(mesh))
               for x in (b_ids, i_ids, j_ids)]
        outs = []
        for s, dev in enumerate(mesh.devices):
            with on_device(dev):
                outs.append(fine_local(s, *(r[s] for r in reps),
                                       *(i[s] for i in ids)))
        return torch.cat([o.to(mesh.devices[0]) for o in outs])[:L]

    return call
