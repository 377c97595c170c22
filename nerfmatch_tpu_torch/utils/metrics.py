"""NeRF losses and image metrics (counterpart of the NeRF half of
``nerfmatch_tpu/utils/metrics.py``): MSE / PSNR, the mip-NeRF 360
distortion regularizer in its O(S) prefix-sum form, and the NeRF loss
assembly."""

from __future__ import annotations

import torch


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


def compute_nerf_metrics(preds, rgb_gt, validation_mode: bool = False,
                         mask_loss=None, cnfg_loss=None):
    """0.5 * (coarse + fine MSE) + distortion regularizer -> metrics dict
    (tensors).  The 0.5-scaled MSE feeds the train PSNR, as in the reference
    (+3.01 dB against the val-path ``psnr``), kept for log parity."""
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
            loss = loss + l2_regularize(preds["app_coarse"]) * 1e-5
        m = 0.5 * torch.mean(mask_loss * (preds["rgb_coarse"] - rgb_gt) ** 2)
        loss = loss + m * coarse_weight
        metrics["rgb_coarse_mse"] = m
        metrics["rgb_coarse_psnr"] = mse2psnr(m)
    if "rgb_fine" in preds:
        m = 0.5 * torch.mean(mask_loss * (preds["rgb_fine"] - rgb_gt) ** 2)
        loss = loss + m
        metrics["rgb_fine_mse"] = m
        metrics["rgb_fine_psnr"] = mse2psnr(m)
    else:
        metrics["rgb_fine_mse"] = metrics["rgb_coarse_mse"]
        metrics["rgb_fine_psnr"] = metrics["rgb_coarse_psnr"]
    if not validation_mode and cnfg_loss is not None:
        ray_reg = getattr(cnfg_loss, "ray_reg_weight", None)
        if "s_fine" in preds and ray_reg:
            loss = loss + distortion_loss(preds["s_fine"],
                                          preds["weights_fine"]) * ray_reg
    metrics["loss"] = loss
    return metrics
