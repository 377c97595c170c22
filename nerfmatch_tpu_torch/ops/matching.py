"""Fixed-shape coarse matching ops (counterpart of
``nerfmatch_tpu/ops/matching.py``, inference half).

The similarity that decides matches stays full f32: callers keep
``torch.backends.cuda.matmul.allow_tf32`` off."""

from __future__ import annotations

import torch

NEG_INF = -1e9


def safe_normalize(f):
    return f / (torch.sqrt(torch.sum(f**2, dim=-1, keepdim=True) + 1e-12)
                + 1e-6)


def dual_softmax(im_feat, pt_feat, temperature, im_mask=None, pt_mask=None,
                 temp_type: str = "mul"):
    """L2-normalized similarity -> temperature -> masked dual softmax.
    Returns (conf (B, M, N), im_feat_n, pt_feat_n)."""
    im_n = safe_normalize(im_feat)
    pt_n = safe_normalize(pt_feat)
    sim = torch.einsum("bmd,bnd->bmn", im_n, pt_n)
    sim = sim / temperature if temp_type == "div" else sim * temperature
    if im_mask is None:
        im_mask = torch.ones(im_feat.shape[:2], dtype=sim.dtype,
                             device=sim.device)
    if pt_mask is None:
        pt_mask = torch.ones(pt_feat.shape[:2], dtype=sim.dtype,
                             device=sim.device)
    valid = (im_mask[:, :, None] * pt_mask[:, None, :]) > 0
    sim = torch.where(valid, sim, torch.full_like(sim, NEG_INF))
    # The softmax over image tokens as column reductions: torch.softmax over
    # a non-last dim of (B, M, N) runs a strided kernel 10x slower on CUDA.
    e = torch.exp(sim - sim.amax(dim=1, keepdim=True))
    conf = (e / e.sum(dim=1, keepdim=True)) * torch.softmax(sim, dim=2)
    conf = torch.where(valid, conf, torch.zeros_like(conf))
    return conf, im_n, pt_n


def extract_mutual_matches(conf, mutual: bool = True, threshold: float = 0.0):
    """Dense mutual-max extraction -> dict(j_ids (B, M), mconf, valid)."""
    mask = conf > threshold
    mask = mask & (conf == conf.amax(dim=2, keepdim=True))
    if mutual:
        mask = mask & (conf == conf.amax(dim=1, keepdim=True))
    masked_conf = torch.where(mask, conf, torch.zeros_like(conf))
    j_ids = torch.argmax(masked_conf, dim=2).to(torch.int32)
    valid = mask.any(dim=2)
    mconf = torch.gather(conf, 2, j_ids[..., None].long())[..., 0]
    mconf = torch.where(valid, mconf, torch.zeros_like(mconf))
    return {"j_ids": j_ids, "mconf": mconf, "valid": valid}


def dense_to_match_lists(matches, max_matches: int):
    """Top-``max_matches`` valid tokens per image by confidence ->
    dict(i_ids, j_ids, mconf, valid), each (B, max_matches)."""
    mconf = matches["mconf"]
    B, M = mconf.shape
    k = min(max_matches, M)
    top_conf, top_i = torch.topk(mconf, k, dim=1)
    top_j = torch.gather(matches["j_ids"], 1, top_i)
    top_valid = torch.gather(matches["valid"], 1, top_i)
    out = {"i_ids": top_i.to(torch.int32), "j_ids": top_j, "mconf": top_conf,
           "valid": top_valid & (top_conf > 0)}
    if k < max_matches:
        pad = max_matches - k
        out = {kk: torch.nn.functional.pad(v, (0, pad)) for kk, v in out.items()}
    return out
