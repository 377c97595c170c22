"""Fixed-shape coarse matching ops (counterpart of
``nerfmatch_tpu/ops/matching.py``), including the training-time GT padding
of the match list.

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


def pad_match_budgets(B: int, M: int, N: int, coarse_percent: float = 0.3,
                      train_percent: float = 0.3):
    """(train_num, pred_budget): the fixed list length and the slots that
    prefer predicted matches."""
    train_num = int(B * min(M, N) * train_percent)
    return train_num, int(train_num * coarse_percent)


def pad_match_draws(matches, conf_gt, train_num: int, generator=None,
                    group=None):
    """The three draws of :func:`pad_matches_with_gt` from ``generator``:
    ``pred_pick`` (uniform over valid predictions, or over all tokens when
    none is valid), ``row_pick`` (a (b, i) row with probability proportional
    to its GT positives, uniform when there are none) and ``gt_j`` (uniform
    over the picked row's positives, over all columns when there are none:
    the ``floor(u * count)``-th of them for a uniform ``u``).

    With a data-parallel ``group`` (``parallel.distributed.DataGroup``)
    ``matches`` are the global batch's (gathered) and ``conf_gt`` holds this
    rank's rows: the draws are the global batch's on every rank (the same
    generator state, the global shapes), and ``gt_j`` is drawn for this
    rank's rows only (0 elsewhere)."""
    B, M, N = conf_gt.shape
    # torch.where, not a host branch: no device sync in the train step.
    valid = matches["valid"].reshape(-1).float()
    w = torch.where(valid.any(), valid, torch.ones_like(valid))
    pred_pick = torch.multinomial(w, train_num, replacement=True,
                                  generator=generator)
    gt_pos = (conf_gt.reshape(B * M, N) > 0).float()
    row_w = gt_pos.sum(1) if group is None else group.gather(gt_pos.sum(1))
    any_gt = row_w.any()
    row_pick = torch.multinomial(torch.where(any_gt, row_w, 1.0), train_num,
                                 replacement=True, generator=generator)
    u = torch.rand(train_num, generator=generator, device=conf_gt.device)
    local = row_pick - (0 if group is None else group.rank * B * M)
    own = (local >= 0) & (local < B * M)
    cols = torch.where(any_gt, gt_pos[local.clamp(0, B * M - 1)], 1.0)
    count = cols.sum(1)
    k = torch.minimum((u * count).floor(), count - 1)
    gt_j = (cols.cumsum(1) <= k[:, None]).sum(1)
    return {"pred_pick": pred_pick, "row_pick": row_pick,
            "gt_j": torch.where(own, gt_j, torch.zeros_like(gt_j))}


def pad_matches_with_gt(matches, conf_gt, coarse_percent: float = 0.3,
                        train_percent: float = 0.3, generator=None,
                        draws=None, group=None):
    """Fixed-budget train-time match list: predicted matches padded with GT
    (the JAX ``pad_matches_with_gt``).

    ``train_num = B * min(M, N) * train_percent`` slots; the first
    ``train_num * coarse_percent`` take a predicted match where any exists,
    the rest a GT positive drawn row-first (row by its positive count, then a
    column of the row).  With no GT positives the GT slots are garbage and
    ``valid`` is False there.  Draws come from ``draws`` (keys of
    :func:`pad_match_draws`) or ``generator``.  With a data-parallel
    ``group``, the list of the global batch (B the global batch size, b_ids
    global): ``matches`` gathered, ``conf_gt`` this rank's rows, and the GT
    columns (``j_ids`` of the GT slots) right on this rank's rows only.
    Returns dict(b_ids, i_ids, j_ids, mconf, is_pred, valid) of length
    train_num."""
    B, M, N = conf_gt.shape
    if group is not None:
        B *= group.world
    train_num, pred_budget = pad_match_budgets(B, M, N, coarse_percent,
                                               train_percent)
    if draws is None:
        draws = pad_match_draws(matches, conf_gt, train_num, generator, group)
    dev = conf_gt.device
    pred_pick, row_pick, gt_j = (torch.as_tensor(draws[k], device=dev).long()
                                 for k in ("pred_pick", "row_pick", "gt_j"))
    valid_flat = matches["valid"].reshape(-1)
    any_pred = valid_flat.any()
    any_gt = (conf_gt > 0).any()
    if group is not None:
        any_gt = group.sum(any_gt.int()) > 0
    slot = torch.arange(train_num, device=dev)
    use_pred = (slot < pred_budget) & any_pred & valid_flat[pred_pick]
    pred_j = matches["j_ids"].reshape(-1)[pred_pick].long()
    pick = lambda p, g: torch.where(use_pred, p, g).to(torch.int32)
    return {"b_ids": pick(pred_pick // M, row_pick // M),
            "i_ids": pick(pred_pick % M, row_pick % M),
            "j_ids": pick(pred_j, gt_j),
            "mconf": torch.where(use_pred,
                                 matches["mconf"].reshape(-1)[pred_pick],
                                 torch.zeros((), device=dev)),
            "is_pred": use_pred, "valid": use_pred | any_gt}


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
