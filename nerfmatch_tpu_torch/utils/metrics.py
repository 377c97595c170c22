"""Losses and metrics (counterpart of ``nerfmatch_tpu/utils/metrics.py``):
MSE / PSNR, the mip-NeRF 360 distortion regularizer in its O(S) prefix-sum
form, the NeRF loss assembly, the matcher losses (focal, feature l2, the
two fine losses) with their ``valid`` masks and stop-gradient weights, the
host PnP pose metrics (the NeRF trainer's retrieval-pair validation
included), and the localization summaries (median errors, recall at the
scene's DSAC* thresholds, AUC)."""

from __future__ import annotations

from argparse import Namespace
from collections import defaultdict

import numpy as np
import torch

# Scene-dependent success thresholds following DSAC* (deg, cm).
POSE_THRES = {
    # Cambridge
    "GreatCourt": [(5, 45)],
    "KingsCollege": [(5, 38)],
    "OldHospital": [(5, 22)],
    "ShopFacade": [(5, 15)],
    "StMarysChurch": [(5, 35)],
    # 7-Scenes
    "chess": [(5, 5)],
    "fire": [(5, 5)],
    "heads": [(5, 5)],
    "office": [(5, 5)],
    "pumpkin": [(5, 5)],
    "redkitchen": [(5, 5)],
    "stairs": [(5, 5)],
}


def mse(img_pred, img_gt, mask=None):
    d = (img_pred - img_gt) ** 2
    if mask is not None:
        # Mean over every selected ELEMENT (a broadcast (.., 1) mask counts
        # once per channel).
        m = torch.broadcast_to(mask, d.shape).to(d.dtype)
        return torch.sum(d * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(d)


def mse2psnr(x):
    return -10.0 * torch.log10(torch.as_tensor(x))


def psnr(img_pred, img_gt, mask=None):
    return mse2psnr(mse(img_pred, img_gt, mask))


def l2_regularize(mu):
    return torch.mean(mu**2)


def lossfun_distortion(t, w):
    """mip-NeRF 360 distortion: sum_ij w_i w_j |u_i - u_j| + intra-interval,
    the inter term through exclusive prefix sums of w and w * u (O(S);
    identical value and gradient to the pairwise form)."""
    if w.shape[-1] == t.shape[-1]:
        t = torch.cat([t[..., :1] * 0, t], dim=-1)
    ut = (t[..., 1:] + t[..., :-1]) / 2
    w_lt = torch.cumsum(w, dim=-1) - w
    s_lt = torch.cumsum(w * ut, dim=-1) - w * ut
    loss_inter = 2.0 * torch.sum(w * (ut * w_lt - s_lt), dim=-1)
    loss_intra = torch.sum(w**2 * (t[..., 1:] - t[..., :-1]), dim=-1) / 3.0
    return loss_inter + loss_intra


def distortion_loss(s, w):
    return torch.mean(lossfun_distortion(s, w))


def _rank_share(mean, group=None):
    """A rank's share of a mean over the global batch: every rank holds as
    many rows, so the ranks' shares sum to the global mean."""
    return mean if group is None else mean / group.world


def _global_count(count, group=None):
    """A count over the global batch (summed over the ranks)."""
    return count if group is None else group.sum(count)


def compute_nerf_metrics(preds, rgb_gt, validation_mode: bool = False,
                         mask_loss=None, cnfg_loss=None, group=None):
    """0.5 * (coarse + fine MSE) + distortion regularizer -> metrics dict
    (tensors).  The 0.5-scaled MSE feeds the train PSNR, as in the reference
    (+3.01 dB against the val-path ``psnr``), kept for log parity.  With a
    data-parallel ``group`` (``parallel.distributed.DataGroup``) every term
    is this rank's share of the global-batch mean: the losses and the MSEs
    sum over the ranks, the PSNRs must be taken again from the summed
    MSEs."""
    metrics = {}
    loss = 0.0
    if mask_loss is not None:
        if validation_mode:
            mask_loss = torch.round(mask_loss)
    else:
        mask_loss = 1.0
    if "rgb_coarse" in preds:
        coarse_weight = getattr(cnfg_loss, "coarse_weight", 1.0) \
            if cnfg_loss else 1.0
        if "app_coarse" in preds and not validation_mode:
            loss = loss + _rank_share(l2_regularize(preds["app_coarse"]),
                                      group) * 1e-5
        m = _rank_share(0.5 * torch.mean(
            mask_loss * (preds["rgb_coarse"] - rgb_gt) ** 2), group)
        loss = loss + m * coarse_weight
        metrics["rgb_coarse_mse"] = m
        metrics["rgb_coarse_psnr"] = mse2psnr(m)
    if "rgb_fine" in preds:
        m = _rank_share(0.5 * torch.mean(
            mask_loss * (preds["rgb_fine"] - rgb_gt) ** 2), group)
        loss = loss + m
        metrics["rgb_fine_mse"] = m
        metrics["rgb_fine_psnr"] = mse2psnr(m)
    else:
        metrics["rgb_fine_mse"] = metrics["rgb_coarse_mse"]
        metrics["rgb_fine_psnr"] = metrics["rgb_coarse_psnr"]
    if not validation_mode and cnfg_loss is not None:
        ray_reg = getattr(cnfg_loss, "ray_reg_weight", None)
        if "s_fine" in preds and ray_reg:
            loss = loss + _rank_share(distortion_loss(
                preds["s_fine"], preds["weights_fine"]), group) * ray_reg
    metrics["loss"] = loss
    return metrics


# ---------------------------------------------------------------------------
# Matching losses (fixed shapes, masked)
# ---------------------------------------------------------------------------

def compute_matching_loss(conf, conf_gt, alpha: float = 0.25,
                          gamma: float = 2.0, clamp: bool = True,
                          valid_mask=None, group=None):
    """Focal loss over the dual-softmax confidence matrix; conf_gt in {0, 1};
    cells outside ``valid_mask`` count as neither positive nor negative.
    With a data-parallel ``group`` the positive and negative counts are the
    global batch's (here and in the losses below: each rank's loss is its
    share, the ranks' losses and gradients sum to the global batch's)."""
    conf = conf.clamp(1e-6, 1 - 1e-6) if clamp else conf.clamp(1e-12, 1 - 1e-12)
    pos, neg = conf_gt == 1, conf_gt == 0
    if valid_mask is not None:
        pos, neg = pos & valid_mask, neg & valid_mask
    loss_pos = -alpha * (1 - conf) ** gamma * torch.log(conf)
    loss_neg = -alpha * conf ** gamma * torch.log(1 - conf)
    zero = torch.zeros((), device=conf.device)
    pos_mean = torch.where(pos, loss_pos, zero).sum() \
        / _global_count(pos.sum(), group).clamp(min=1)
    neg_mean = torch.where(neg, loss_neg, zero).sum() \
        / _global_count(neg.sum(), group).clamp(min=1)
    return pos_mean + neg_mean


def compute_feat_l2(im_feat, pt_feat, conf_gt, group=None):
    """Mean L2 distance of GT-corresponding features: per-image means over
    the positives, then the batch mean (the reference's weighting)."""
    sq = ((im_feat ** 2).sum(-1)[:, :, None] + (pt_feat ** 2).sum(-1)[:, None, :]
          - 2.0 * torch.einsum("bmd,bnd->bmn", im_feat, pt_feat))
    dist = torch.sqrt(sq.clamp(min=1e-12))
    pos = conf_gt > 0
    per_b = torch.where(pos, dist, torch.zeros((), device=dist.device)).sum(
        (1, 2)) / pos.sum((1, 2)).clamp(min=1)
    return _rank_share(per_b.mean(), group)


def _std_weight(std, valid, group=None):
    """Stop-gradient inverse-std weights normalized by their mean over the
    ``valid`` rows (of every rank with a ``group``)."""
    inv_std = 1.0 / std.clamp(min=1e-10)
    vnum = _global_count(valid.sum(), group).clamp(min=1)
    mean_inv = _global_count(torch.where(
        valid, inv_std, torch.zeros_like(inv_std)).sum(), group) / vnum
    return (inv_std / mean_inv).detach(), vnum


def compute_fine_loss_l2_std(expec_f, expec_f_gt, training: bool = True,
                             valid=None, group=None):
    """LoFTR local expectation loss: std-weighted l2 of window-normalized
    offsets over the rows whose GT lies inside the window (and ``valid``);
    ``training`` is unused, as in the reference."""
    correct = torch.linalg.norm(expec_f_gt, ord=float("inf"), dim=1) < 1.0
    if valid is None:
        valid_w = torch.ones_like(correct)
    else:
        valid_w = valid
        correct = correct & valid
    weight, _ = _std_weight(expec_f[:, 2], valid_w, group)
    flow_l2 = ((expec_f_gt - expec_f[:, :2]) ** 2).sum(-1)
    return torch.where(correct, flow_l2 * weight, torch.zeros_like(flow_l2)).sum() \
        / _global_count(correct.sum(), group).clamp(min=1)


def compute_fine_match_loss_l2_std(mpt2d_f, mpt2d_f_gt, std, mask=None,
                                   valid=None, group=None):
    """Global-pixel fine loss: std-weighted l2 in image coordinates, summed
    over ``mask & valid`` and divided by the number of valid rows."""
    if valid is None:
        valid = torch.ones_like(std, dtype=torch.bool)
    weight, vnum = _std_weight(std, valid, group)
    mask = valid if mask is None else mask & valid
    flow_l2 = ((mpt2d_f - mpt2d_f_gt) ** 2).sum(-1)
    return torch.where(mask, flow_l2 * weight, torch.zeros_like(flow_l2)).sum() / vnum


# ---------------------------------------------------------------------------
# Pose metrics (host: numpy + PnP)
# ---------------------------------------------------------------------------

def compute_pose_errs(K, c2w_gt, pt3d, pt2d, solver: str = "native",
                      ransac_thres: float = 1.0, seed: int = 0):
    """Solve PnP -> (R_err deg, t_err, inliers); inf on failure."""
    from ..pose import estimate_pose
    from .geometry import pose_err

    res = estimate_pose(np.asarray(pt2d), np.asarray(pt3d), np.asarray(K),
                        ransac_thres=ransac_thres, solver=solver,
                        **({"seed": seed} if solver != "cv" else {}))
    if res is None:
        return float("inf"), float("inf"), []
    R, t, inliers = res
    w2c = np.eye(4)
    w2c[:3, :3] = R
    w2c[:3, 3] = t
    r_err, t_err = pose_err(np.asarray(c2w_gt, np.float32),
                            np.linalg.inv(w2c).astype(np.float32))
    return float(r_err), float(t_err), inliers


def compute_pose_metrics_host(batch_matches, solver: str = "native",
                              rthres: float = 1.0, seed: int = 0):
    """Per-sample pose metrics from host match arrays (dicts of pt2d, pt3d,
    K, c2w_gt) -> defaultdict(list) of num_matches / num_inls / R_err /
    t_err."""
    metrics = defaultdict(list)
    for m in batch_matches:
        r_err, t_err, inls = compute_pose_errs(
            m["K"], m["c2w_gt"], m["pt3d"], m["pt2d"], solver=solver,
            ransac_thres=rthres, seed=seed)
        metrics["num_matches"].append(len(m["pt2d"]))
        metrics["num_inls"].append(len(inls))
        metrics["R_err"].append(r_err)
        metrics["t_err"].append(t_err)
    return metrics


def compute_nerf_pose_metrics(pts_fine, pts_feat, data, ds: int = 8):
    """NeRF validation pose metrics of a rendered retrieval pair (JAX
    ``utils/metrics.py: compute_nerf_pose_metrics`` at its defaults: the
    native solver, RANSAC threshold 1 px), host numpy.

    ``pts_fine`` (2 * n, 3) scene-normalized points and ``pts_feat``
    (2 * n, C) features of both images' ds-grid rays (n = (H // ds) *
    (W // ds)); ``data``: the pair sample (``c2w`` and ``K`` of both images
    stacked, ``img_wh``, ``unnorm_scene``).  Depth-based: each image's
    points, projected into the other camera at its true pose, localize it
    (PnP).  Match-based: mutual nearest neighbours of the two feature maps
    pair one image's grid pixels with the other's points -> dict of
    R_err_depth, t_err_depth (x100), match_score, num_matches,
    R_err_match, t_err_match (x100); inf where PnP fails or fewer than 4
    matches."""
    from .geometry import mutual_nn_matching

    w, h = [int(x) for x in np.asarray(data["img_wh"]).reshape(-1)[:2]]
    gw, gh = w // ds, h // ds
    n = gw * gh
    c2w = np.asarray(data["c2w"], np.float64).reshape(2, 4, 4)
    K = np.asarray(data["K"], np.float64).reshape(2, 3, 3)
    unnorm = np.asarray(data["unnorm_scene"], np.float64)
    pts = np.asarray(pts_fine, np.float64).reshape(2, n, 3)
    pts_h = np.concatenate([pts, np.ones((2, n, 1))], -1)
    pts_w = np.einsum("ij,bnj->bni", unnorm, pts_h)[..., :3]
    xs, ys = np.meshgrid(np.arange(gw), np.arange(gh), indexing="xy")
    pt2d = np.stack([xs, ys], -1).reshape(-1, 2) * ds + ds / 2.0

    metrics = {}
    r_errs, t_errs = [], []
    for i in range(2):
        # The other image's points projected into camera i (the
        # reference's int cast; points behind the camera become outliers).
        w2c = np.linalg.inv(c2w[i])
        pc = pts_w[1 - i] @ w2c[:3, :3].T + w2c[:3, 3]
        with np.errstate(divide="ignore", invalid="ignore"):
            pix = (pc / pc[:, 2:]) @ K[i].T
        pt2d_proj = np.nan_to_num(pix[:, :2], nan=-1e6, posinf=1e6,
                                  neginf=-1e6).astype(np.int32)
        r_err, t_err, _ = compute_pose_errs(K[i], c2w[i], pts_w[1 - i],
                                            pt2d_proj)
        r_errs.append(r_err)
        t_errs.append(t_err)
    metrics["R_err_depth"] = float(np.mean(r_errs))
    metrics["t_err_depth"] = float(np.mean(t_errs)) * 100

    f1, f2 = np.asarray(pts_feat, np.float64).reshape(2, n, -1)
    matches, scores, valid = mutual_nn_matching(
        torch.as_tensor(f1, dtype=torch.float32),
        torch.as_tensor(f2, dtype=torch.float32))
    matches, scores = matches[valid].numpy(), scores[valid].numpy()
    metrics["match_score"] = float(scores.mean()) if len(scores) else 0.0
    metrics["num_matches"] = int(len(matches))
    if len(matches) >= 4:
        r1, t1, _ = compute_pose_errs(K[0], c2w[0], pts_w[1][matches[:, 1]],
                                      pt2d[matches[:, 0]])
        r2, t2, _ = compute_pose_errs(K[1], c2w[1], pts_w[0][matches[:, 0]],
                                      pt2d[matches[:, 1]])
        r_errs, t_errs = [r1, r2], [t1, t2]
    else:
        r_errs, t_errs = [np.inf], [np.inf]
    metrics["R_err_match"] = float(np.mean(r_errs))
    metrics["t_err_match"] = float(np.mean(t_errs)) * 100
    return metrics


# ---------------------------------------------------------------------------
# Localization summaries (host)
# ---------------------------------------------------------------------------

def pose_recall(r_errs, t_errs, r_thres, t_thres):
    return float(((np.array(r_errs) < r_thres)
                  & (np.array(t_errs) < t_thres)).mean() * 100)


def cal_error_auc(errors, thresholds):
    if len(errors) == 0:
        return np.zeros(len(thresholds))
    N = len(errors)
    errors = np.append([0.0], np.sort(errors))
    recalls = np.arange(N + 1) / N
    aucs = []
    for thres in thresholds:
        last = np.searchsorted(errors, thres)
        rcs = np.append(recalls[:last], recalls[last - 1])
        ers = np.append(errors[:last], thres)
        aucs.append(np.trapezoid(rcs, x=ers) / thres)
    return np.array(aucs) * 100


def compute_mean_recall(errs, thres):
    rec = [[(np.asarray(err) < th).mean() for th in thres] for err in errs]
    return np.array(rec).mean(0) * 100


def summarize_pose_statis(statis, pose_thres=(1, 2, 5, 10),
                          auc_thres=(1, 2, 5, 10), t_unit: str = "cm",
                          t_scale: float = 1.0, print_out: bool = True):
    """Median / recall / AUC summary of per-query errors (a dict or
    namespace with ``R_err``, ``t_err`` and optionally ``num_matches``,
    ``num_inls``, ``match_time``, ``localize_time``) -> dict of t_med,
    r_med, recall at the first threshold[, match_time, localize_time in
    ms], printed in the reference's format."""
    printf = print if print_out else (lambda *_: None)
    if isinstance(statis, dict):
        statis = Namespace(**statis)
    if isinstance(pose_thres[0], (int, float)):
        pose_thres = [(th, th) for th in pose_thres]

    r_errs = np.asarray(statis.R_err, dtype=np.float64)
    t_errs = np.asarray(statis.t_err, dtype=np.float64) * t_scale

    printf(f"\nSamples: {len(r_errs)} t_unit={t_unit} t_scale={t_scale}")
    if hasattr(statis, "num_matches"):
        printf(f"Mean matches: {np.mean(statis.num_matches):.0f}")
    if hasattr(statis, "num_inls"):
        printf(f"Ransac inliers:{np.mean(statis.num_inls):.0f}")

    t_med = float(np.median(t_errs))
    r_med = float(np.median(r_errs))
    printf(f"Median Error: {t_med:.1f}/{r_med:.1f} {t_unit}/deg")
    rec = np.array([pose_recall(r_errs, t_errs, rth, tth)
                    for rth, tth in pose_thres])
    printf(f"Recall@{list(pose_thres)}{t_unit}/deg: {rec}%")
    auc = cal_error_auc(np.maximum(t_errs, r_errs), list(auc_thres))
    printf(f"AUC@{list(auc_thres)}{t_unit}/deg: {auc}%")

    out = {"t_med": t_med, "r_med": r_med, "recall": float(rec[0])}
    if hasattr(statis, "match_time"):
        mt = float(np.mean(statis.match_time) * 1000)
        out["match_time"] = mt
        printf(f"Avg match time: {mt:.1f}ms")
    if hasattr(statis, "localize_time"):
        out["localize_time"] = float(np.mean(statis.localize_time) * 1000)
    return out


def average_pose_metrics(metr_all, print_out: bool = True):
    """Mean of per-scene :func:`summarize_pose_statis` dicts."""
    printf = print if print_out else (lambda *_: None)
    avg = {k: float(np.mean([m[k] for m in metr_all])) for k in metr_all[0]}
    printf(f"\nAverage metrics of {len(metr_all)} (scene) caches:")
    printf(f"Median pose error(cm/deg): {avg['t_med']:.1f}/{avg['r_med']:.1f}")
    printf(f"Recall(%): {avg['recall']:.1f}")
    printf(f"Table: {avg['t_med']:.1f}/{avg['r_med']:.1f}/{avg['recall']:.1f}")
    return avg
