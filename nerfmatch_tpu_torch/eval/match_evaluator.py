"""NeRFMatch localization for the cached-point protocols (counterpart of
``nerfmatch_tpu/eval/match_evaluator.py: NeRFMatchEvaluator``).

Per query: match the image against scene points (NeRF descriptors + 3D
points), solve PnP on the host (``nerfmatch_tpu_torch.pose``, C++ through
ctypes), and with ``iters > 1`` re-render the scene points at the pose
estimate and match again.  Single-shot and ``iters > 1``, at bs=1 and at
``eval_bs > 1``.  Batches are dicts of numpy arrays: image (B, H, W, 3),
pt_feat (B, N, C), pt3d (B, N, 3), pt_mask (B, N), im_mask (B, M),
pt2d (B, M, 2), K (B, 3, 3), c2w (B, 4, 4), unnorm_scene (B, 4, 4).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.layers import init_params_
from ..models.matcher_c2f import C2FMatcherConfig, NeRFMatcherMS
from ..models.matcher_coarse import CoarseMatcherConfig, NeRFMatcherCoarse
from ..pose import estimate_pose
from ..utils.geometry import pose_err


class NeRFMatchEvaluator:
    def __init__(self, config, state_dict=None, device="cpu",
                 generator: torch.Generator | None = None):
        """``state_dict``: reference-format matcher weights (loaded strictly);
        without it the matcher is initialized from ``generator``."""
        model_conf = config.model
        if hasattr(model_conf, "ffeat_dim"):
            self.model = NeRFMatcherMS(C2FMatcherConfig.from_namespace(model_conf))
            self.coarse_only = False
        else:
            self.model = NeRFMatcherCoarse(
                CoarseMatcherConfig.from_namespace(model_conf))
            self.coarse_only = True
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        else:
            init_params_(self.model, generator or torch.Generator().manual_seed(0))
        self.model.to(device).eval()
        self.device = torch.device(device)
        self.max_matches = int(getattr(config, "max_matches", 2048))

    def _t(self, x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _match(self, image, pt_feat, pt3d, im_mask, pt_mask, mutual,
               match_thres):
        out = self.model.eval_match(
            self._t(image), self._t(pt_feat), self._t(pt3d),
            im_mask=self._t(im_mask), pt_mask=self._t(pt_mask), mutual=mutual,
            match_thres=match_thres, top_k=self.max_matches)
        return {k: (v.cpu().numpy() if torch.is_tensor(v) else
                    {kk: vv.cpu().numpy() for kk, vv in v.items()})
                for k, v in out.items()}

    def _item_matches(self, out, pt2d_all, pt3d, b):
        """Host-side (pt2d, pt3d) correspondences of batch item ``b``."""
        lists = out["lists"]
        valid = lists["valid"][b]
        i_ids = lists["i_ids"][b][valid]
        j_ids = lists["j_ids"][b][valid]
        mpt2d = pt2d_all[b][i_ids]
        if not self.coarse_only:
            M = out["j_ids"].shape[1]
            expec = out["expec_f"].reshape(-1, M, 3)[b][i_ids]
            mpt2d = self.model.fine_coords(
                torch.from_numpy(expec), torch.from_numpy(
                    np.asarray(mpt2d, np.float32))).numpy()
        return mpt2d, pt3d[b][j_ids]

    def _solve_pose(self, pt2d, pt3d, K, c2w_gt, solver, rthres):
        """PnP + pose error -> (c2w_est, R_err, t_err, num_matches)."""
        solver_name = {"colmap": "native", "cv2": "cv", "cv": "cv",
                       "native": "native"}[solver]
        res = estimate_pose(pt2d, pt3d, K, ransac_thres=rthres,
                            solver=solver_name)
        if res is None:
            return None, float("inf"), float("inf"), len(pt2d)
        R, t, _ = res
        w2c = np.eye(4)
        w2c[:3, :3] = R
        w2c[:3, 3] = t
        c2w_est = np.linalg.inv(w2c)
        r_err, t_err = pose_err(np.asarray(c2w_gt, np.float32),
                                c2w_est.astype(np.float32))
        return c2w_est, float(r_err), float(t_err), len(pt2d)

    def eval_batch(self, batch, renderer=None, iters: int = 1,
                   mutual: bool = True, match_thres: float = 0.0,
                   solver: str = "colmap", rthres: float = 1.0):
        """Localize every query of ``batch``; ``iters > 1`` re-renders the
        scene points through ``renderer`` at each successful estimate.
        Returns dict(R_err, t_err, num_matches) lists of length B."""
        if iters > 1 and renderer is None:
            raise ValueError("iters > 1 needs the NeRF renderer")
        B = np.asarray(batch["image"]).shape[0]
        H, W = np.asarray(batch["image"]).shape[1:3]
        Ks, c2ws = np.asarray(batch["K"]), np.asarray(batch["c2w"])
        pt2d_all = np.asarray(batch["pt2d"])
        pt3d = np.asarray(batch["pt3d"])
        pt_feat = np.asarray(batch["pt_feat"])
        pt_mask = np.asarray(batch["pt_mask"], np.float32)
        un = np.asarray(batch["unnorm_scene"])
        c2w_ests = [None] * B
        res = dict(R_err=[float("inf")] * B, t_err=[float("inf")] * B,
                   num_matches=[0] * B)
        for itr in range(iters):
            dead = set()
            if itr > 0:
                live = [b for b in range(B) if c2w_ests[b] is not None]
                if live:
                    outs = renderer.render_novel_views(
                        (H, W), Ks[live], [c2w_ests[b] for b in live],
                        [un[b] for b in live], downsample=8)
                    n_new = outs["pt3d"].shape[1]
                    if n_new != pt3d.shape[1]:
                        # A new point budget: queries whose PnP failed keep
                        # their iteration-0 results.
                        dead = set(range(B)) - set(live)
                        pt3d = np.zeros((B, n_new, 3), np.float32)
                        pt_feat = np.zeros((B, n_new, outs["pt_feat"].shape[-1]),
                                           np.float32)
                        pt_mask = np.zeros((B, n_new), np.float32)
                    else:
                        pt3d, pt_feat, pt_mask = (pt3d.copy(), pt_feat.copy(),
                                                  pt_mask.copy())
                    for j, b in enumerate(live):
                        pt3d[b] = outs["pt3d"][j]
                        pt_feat[b] = outs["pt_feat"][j]
                        pt_mask[b] = 1.0
            out = self._match(batch["image"], pt_feat, pt3d, batch["im_mask"],
                              pt_mask, mutual, match_thres)
            for b in range(B):
                if b in dead:
                    continue
                mpt2d, mpt3d = self._item_matches(out, pt2d_all, pt3d, b)
                c2w_est, r_err, t_err, n = self._solve_pose(
                    mpt2d, mpt3d, Ks[b], c2ws[b], solver, rthres)
                c2w_ests[b] = c2w_est
                res["R_err"][b] = r_err
                res["t_err"][b] = t_err
                res["num_matches"][b] = n
        res["c2w_est"] = c2w_ests
        return res
