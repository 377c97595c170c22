"""iNeRF pose refinement (counterpart of ``nerfmatch_tpu/eval/inerf.py``).

Adam on an se(3) delta (rvec, tvec) right-composed onto the normalized
starting pose; per step a mip render of the ds-grid (60x60 at 480/8),
differentiable in the pose through the ray origins and directions, the
photometric MSE against the downsampled query (plus, with
``use_match_loss``, the matcher's focal loss against an identity match
matrix), an optional cosine learning-rate decay, and an evaluation on the
pose error or by re-matching the refined render + PnP.

The step's no-gradient half, the coarse pass and the resample, is
:meth:`NerfRenderer.coarse_resample`: on the card the serving render kernel
(its int8 trunk under the serving default ``'coarse'``) and the resample
kernel.  The half under gradient is plain PyTorch: the fine NeRF MLP in
f32 on ``torch.matmul``, then ``volume_render``, differentiated by
autograd.  An appearance NeRF renders every query with table row 1, the
reference's quirk the JAX package keeps (``inerf.py: _app``); the row takes
no gradient.  The JAX package computes it outside any Pallas kernel too
(``inerf.py:92-116``: ``nerf_apply`` and ``volume_render`` under
``jax.value_and_grad``); the training render kernels return weight
gradients, not ray gradients.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..nerf.compositing import volume_render
from ..nerf.embedding import ipe_embedding, pe_embedding
from ..nerf.sampling import frustum_moments, lift_gaussian
from ..nerf.scene import rays_intersect_sphere
from ..ops.matching import dual_softmax
from ..utils import get_logger
from ..utils.geometry import pose_err, rodrigues, unnormalize_pts
from ..utils.metrics import compute_matching_loss

logger = get_logger(level="INFO", name="nerfmatch_eval")


def _apply_delta(pose, delta):
    """Right-compose ``[R(rvec) | tvec]`` of ``delta`` (6,) onto a 4x4 pose."""
    upd = torch.cat([rodrigues(delta[:3]), delta[3:, None]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=pose.dtype,
                          device=pose.device)
    return pose @ torch.cat([upd, bottom])


def _gen_rays_from_pose(pose, K_inv, H: int, W: int, ds: int,
                        near: float = 0.01):
    """Packed (n, 12) rays at the ``ds // 2 :: ds`` pixels of an H x W
    camera at the normalized ``pose``, differentiable in the pose: far at the
    unit sphere (1 where it is missed), radii from the rows' direction
    differences over the full grid."""
    dev = pose.device
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    xys = torch.stack([xs, ys, torch.ones_like(xs)], -1).to(K_inv.dtype)
    dirs = xys @ K_inv.T
    o = pose[:3, 3].expand(H, W, 3)
    d = torch.einsum("ij,hwj->hwi", pose[:3, :3], dirs)
    v = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    far = rays_intersect_sphere(o.reshape(-1, 3), v.reshape(-1, 3), r=1.0)
    far = torch.where(torch.isfinite(far), far, torch.ones_like(far))
    dx = torch.sqrt(torch.sum((v[:-1] - v[1:]) ** 2, -1))
    dx = torch.cat([dx, dx[-2:-1]], 0)
    radii = dx[..., None] * 2.0 / math.sqrt(12.0)
    rays = torch.cat([o, v, torch.full_like(o[..., :1], near),
                      far.reshape(H, W, 1), v, radii], dim=-1)
    return rays[ds // 2::ds, ds // 2::ds].reshape(-1, 12)


class InerfQuery:
    """One query's refinement state: the normalized starting pose, the
    downsampled image, the delta and its Adam (optax's betas and eps), the
    renderer's packed kernel weights and, with ``use_match_loss``, the
    query's coarse image tokens.  ``plain`` runs the no-gradient half as
    the plain pass on the card too (tests)."""

    def __init__(self, evaluator, batch, renderer, unnorm_scene, c2w_est,
                 inerf_conf, plain: bool = False):
        self.evaluator, self.renderer, self.plain = evaluator, renderer, plain
        self.lrate = float(getattr(inerf_conf, "lrate", 0.001))
        self.lrdecay = bool(getattr(inerf_conf, "lrdecay", False))
        self.num_optim = int(getattr(inerf_conf, "num_optim", 5))
        self.ds = ds = int(getattr(inerf_conf, "ds", 8))
        dev = renderer.device
        f32 = dict(dtype=torch.float32, device=dev)
        img = np.asarray(batch["image"])[0]
        self.hw = img.shape[:2]
        self.img_ds = torch.as_tensor(
            img[ds // 2::ds, ds // 2::ds].reshape(-1, 3), **f32)
        self.K_inv = torch.as_tensor(np.linalg.inv(np.asarray(batch["K"])[0]),
                                     **f32)
        self.unnorm = np.asarray(unnorm_scene, np.float64)
        self.unnorm_t = torch.as_tensor(self.unnorm, **f32)
        self.init_pose = torch.as_tensor(
            np.linalg.inv(self.unnorm) @ np.asarray(c2w_est, np.float64), **f32)
        self.delta = torch.zeros(6, requires_grad=True, **f32)
        self.opt = torch.optim.Adam([self.delta], lr=self.lrate,
                                    betas=(0.9, 0.999), eps=1e-8)
        self.packed = None
        if dev.type == "cuda" and not plain:
            with torch.no_grad():
                renderer._ensure_int8_calibrated(self._rays(self.delta))
            self.packed = renderer.pack_fused()
        self.im_cfeat = None
        if getattr(inerf_conf, "use_match_loss", False):
            model = evaluator.model
            with torch.no_grad():
                image = torch.as_tensor(np.asarray(batch["image"]), **f32)
                self.im_cfeat = model.extract_im_feat(image) \
                    if evaluator.coarse_only else model.extract_im_feat_ms(image)[0]

    def _rays(self, delta):
        return _gen_rays_from_pose(_apply_delta(self.init_pose, delta),
                                   self.K_inv, *self.hw, self.ds)

    def render(self, delta):
        """Fine render of the ds-grid at the delta -> (rgb, pts, feats),
        differentiable in ``delta`` through o and the view directions; z
        and the sample variances carry no gradient."""
        r = self.renderer
        rays = self._rays(delta)
        sg = rays.detach()
        z = r.coarse_resample(sg, self.packed, plain=self.plain)
        t_mean, t_var, r_var = frustum_moments(z[:, :-1], z[:, 1:], sg[:, 11:12])
        _, var = lift_gaussian(sg[:, 3:6], t_mean, t_var, r_var)
        o, viewdirs = rays[:, :3], rays[:, 8:11]
        pts = o[:, None, :] + t_mean[..., None] * viewdirs[:, None, :]
        enc, _ = ipe_embedding(pts, var, r.cfg.xyz_num_freqs)
        dirs = pe_embedding(viewdirs, r.cfg.dirs_num_freqs)
        app = r.app_rows(None, dirs.shape[0], dirs.device)
        if app is not None:
            dirs = torch.cat([dirs, app], dim=-1)
        raw, feats = r.nerf_fine(
            torch.cat([enc, dirs[:, None, :].expand(-1, enc.shape[1], -1)], -1),
            val=True)
        rf = volume_render(raw[..., :4], z, rays[:, 3:6], white_bg=True)
        w = rf["weights"][..., None]
        return rf["rgb"], (w * pts).sum(-2), (w * feats).sum(-2)

    def loss(self, delta):
        """-> (loss, (rgb, pts, feats)) at ``delta``."""
        rgb, pts, feats = self.render(delta)
        loss = torch.mean((rgb - self.img_ds) ** 2)
        if self.im_cfeat is not None:
            model = self.evaluator.model
            pt3d = unnormalize_pts(pts[None], self.unnorm_t[None])
            im_cf, pt_cf = model.apply_coarse_former(
                self.im_cfeat, model.extract_pt_feat(feats[None], pt3d))
            conf, _, _ = dual_softmax(im_cf, pt_cf, model.temperature,
                                      temp_type=model.cfg.temp_type)
            # Identity GT over the rendered points, as the reference
            # (nerfmatch_evaluator.py:446): needs one image token a point.
            if conf.shape[1] != conf.shape[2]:
                raise ValueError(
                    "use_match_loss requires inerf_ds == model stride 8 "
                    f"(image tokens {conf.shape[1]} vs rendered "
                    f"{conf.shape[2]})")
            eye = torch.eye(conf.shape[1], device=conf.device)[None]
            loss = loss + compute_matching_loss(conf, eye)
        return loss, (rgb, pts, feats)

    def step(self, j: int):
        """Adam step ``j`` (the learning rate of the cosine decay set first)
        -> (loss, pts, feats, rgb) at the delta before the step.  Records
        ``inerf_step_time`` in the evaluator's timer."""
        t0 = time.perf_counter()
        if self.lrdecay:
            self.opt.param_groups[0]["lr"] = self.lrate * (
                1 + math.cos(math.pi * j / self.num_optim)) / 2
        with torch.enable_grad():
            loss, (rgb, pts, feats) = self.loss(self.delta)
            self.delta.grad, = torch.autograd.grad(loss, self.delta)
        self.opt.step()
        loss = float(loss.detach())
        self.evaluator.timer["inerf_step_time"].append(time.perf_counter() - t0)
        return loss, pts.detach(), feats.detach(), rgb.detach()

    def overlay(self, rgb):
        """The failure-case GIF's frame: ``rgb`` (n, 3) of the ds-grid
        blended over the downsampled query, ``uint8(255 * clip(0.7 *
        clip(rgb, 0, 1) + 0.3 * query, 0, 1))`` (gh, gw, 3)."""
        H, W = self.hw
        ds = self.ds
        gh, gw = len(range(ds // 2, H, ds)), len(range(ds // 2, W, ds))
        blend = 0.7 * rgb.clamp(0, 1) + 0.3 * self.img_ds
        return (255 * blend.clamp(0, 1)).reshape(gh, gw, 3).cpu().numpy() \
            .astype(np.uint8)

    def c2w(self):
        """World-frame c2w of the current delta (float64 numpy)."""
        with torch.no_grad():
            pose = _apply_delta(self.init_pose, self.delta)
        return self.unnorm @ pose.cpu().numpy().astype(np.float64)


def inerf_refinement(evaluator, batch, renderer, unnorm_scene, c2w_est,
                     inerf_conf, mutual: bool = True, match_thres: float = 0.0,
                     solver: str = "colmap", rthres: float = 1.0,
                     cache_iters: bool = False, iter_t_errs=None,
                     iter_R_errs=None, debug: bool = False,
                     overlay_ims=None):
    """Refine the world-frame ``c2w_est`` of a bs=1 ``batch`` -> (c2w_est,
    R_err, t_err).  ``inerf_conf``: num_optim, lrate, lrdecay, eval_pose,
    use_match_loss, ds.  On the steps the JAX package evaluates (every step
    with ``debug`` or ``cache_iters``, else the last) the pose is scored
    directly (``eval_pose``) or by matching the refined render's points and
    features and solving PnP; ``cache_iters`` appends the errors of the
    steps strictly between the first and the last.  A list
    ``overlay_ims`` gets each step's :meth:`InerfQuery.overlay` frame."""
    q = InerfQuery(evaluator, batch, renderer, unnorm_scene, c2w_est,
                   inerf_conf)
    eval_pose = bool(getattr(inerf_conf, "eval_pose", False))
    c2w_gt = np.asarray(batch["c2w"])[0]
    R_err = t_err = float("inf")
    for j in range(q.num_optim):
        loss, pts, feats, rgb = q.step(j)
        if overlay_ims is not None:
            overlay_ims.append(q.overlay(rgb))
        if not (debug or cache_iters or j == q.num_optim - 1):
            continue
        c2w_cur = q.c2w()
        if eval_pose:
            R_err, t_err = map(float, pose_err(
                np.asarray(c2w_gt, np.float32), c2w_cur.astype(np.float32)))
            c2w_est = c2w_cur
        else:
            pt3d = unnormalize_pts(pts[None], q.unnorm_t[None])[0]
            b = dict(batch, pt3d=pt3d.cpu().numpy()[None],
                     pt_feat=feats.cpu().numpy()[None],
                     pt_mask=np.ones((1, pt3d.shape[0]), np.float32))
            c2w_new, R_err, t_err, _ = evaluator.eval_match_pose(
                b, mutual=mutual, match_thres=match_thres, solver=solver,
                rthres=rthres)
            if c2w_new is not None:
                c2w_est = c2w_new
        if cache_iters and 0 < j < q.num_optim - 1:
            iter_t_errs.append(t_err)
            iter_R_errs.append(R_err)
        if debug:
            logger.info(f"  inerf step={j} loss={loss:.4f} "
                        f"t={t_err * 100:.3f}cm R={R_err:.3f}")
    return c2w_est, R_err, t_err
