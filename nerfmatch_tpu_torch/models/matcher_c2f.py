"""NeRFMatch coarse-to-fine matcher ("Full"), inference and training
(counterpart of ``nerfmatch_tpu/models/matcher_c2f.py``).

Two-scale ConvFormer (1/8 coarse, 1/2 fine), the coarse path of the Mini
model, then per image token: the 5x5 window of the fine map around it, a
window self-attention (batched plain attention over 25 tokens per window),
and point-vs-window soft-argmax.  As in the reference, the ``cat_c_feat``
merge is part of the checkpoint but its output is discarded unless
``use_merged_fine``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.dsnt import heatmap_expectation_with_std
from ..ops.gather import take_rows, take_rows_b
from ..ops.matching import dual_softmax, extract_mutual_matches
from .attention import SelfAttentionBlock, set_attention_bf16
from .backbone import MetaFormerMS
from .matcher_coarse import CoarseMatcherConfig, NeRFMatcherCoarse


@dataclasses.dataclass(frozen=True)
class C2FMatcherConfig(CoarseMatcherConfig):
    ffeat_dim: int = 128
    fine_sa: int = 1
    fsa_type: str = "full"
    win_sz: int = 5
    fine_ds: int = 2
    fine_stride: int = 4
    cat_c_feat: bool = True
    use_merged_fine: bool = False
    coarse_percent: float = 0.3
    coarse_dthres: float = 20.0
    fine_loss: str = "match"


class NeRFMatcherMS(NeRFMatcherCoarse):
    two_scale = True

    def __init__(self, cfg: C2FMatcherConfig):
        super().__init__(cfg)
        cdim, fdim = cfg.cfeat_dim, cfg.ffeat_dim
        self.pt_ffeat_proj = nn.ModuleList([nn.Linear(cdim, fdim),
                                            nn.Linear(fdim, fdim)])
        if cfg.cat_c_feat:
            self.fine_preprocess = nn.ModuleDict({
                "down_proj": nn.Linear(cdim, fdim),
                "merge_feat": nn.Linear(2 * fdim, fdim)})
        if cfg.fine_sa > 0:
            self.fine_sa = SelfAttentionBlock(cfg.fine_sa, fdim, 8, fdim // 8,
                                              att_type=cfg.fsa_type)
        set_attention_bf16(self, cfg.attn_bf16)

    def _build_backbone(self):
        self.backbone = MetaFormerMS(self.backbone_cfg)
        cdim, fdim = self.backbone_cfg.dims[1], self.backbone_cfg.dims[0]
        if cdim != self.cfg.cfeat_dim:
            self.cfeat_proj = nn.Linear(cdim, self.cfg.cfeat_dim)
        if fdim != self.cfg.ffeat_dim:
            self.ffeat_proj = nn.Linear(fdim, self.cfg.ffeat_dim)

    # ------------------------------------------------------------------
    def im_backbone(self, img_nhwc):
        return self.backbone(img_nhwc)

    def im_feat_from_fmap(self, fmaps):
        fmap_c, fmap_f = fmaps
        if hasattr(self, "ffeat_proj"):
            fmap_f = self.ffeat_proj(fmap_f)
        return self._im_tokens(fmap_c), fmap_f

    def extract_im_feat_ms(self, img_nhwc):
        """-> (coarse tokens (B, M, cdim), fine map (B, Hf, Wf, fdim))."""
        return self.im_feat_from_fmap(self.im_backbone(img_nhwc))

    def gather_fine_windows(self, fmap_f, im_cfeat, b_ids, i_ids,
                            identity_list: bool = False):
        """W x W fine-map windows at coarse match sites -> (L, W*W, Cf);
        zero-padded borders (torch unfold with padding W//2)."""
        cfg = self.cfg
        W, s = cfg.win_sz, cfg.fine_stride
        half = W // 2
        B, Hf, Wf, Cf = fmap_f.shape
        Hc, Wc = Hf // s, Wf // s
        padded = F.pad(fmap_f, (0, 0, half, half, half, half))
        shifts = [padded[:, dy:dy + s * Hc:s, dx:dx + s * Wc:s, :]
                  for dy in range(W) for dx in range(W)]
        allw = torch.stack(shifts, dim=3).reshape(B * Hc * Wc, W * W * Cf)
        wins = allw if identity_list else take_rows(
            allw, b_ids.long() * (Hc * Wc) + i_ids.long())
        wins = wins.reshape(wins.shape[0], W * W, Cf)
        if cfg.cat_c_feat and cfg.use_merged_fine:
            pre = self.fine_preprocess
            c_win = pre["down_proj"](take_rows_b(im_cfeat, b_ids, i_ids))
            wins = pre["merge_feat"](torch.cat(
                [wins, c_win[:, None, :].expand(-1, wins.shape[1], -1)], -1))
        return wins

    def fine_matching(self, pt_ffeat_sel, win_feat):
        """(L, Cf) points vs (L, WW, Cf) windows -> expec_f (L, 3)."""
        W = self.cfg.win_sz
        C = win_feat.shape[-1]
        sim = torch.einsum("mc,mrc->mr", pt_ffeat_sel, win_feat) / math.sqrt(C)
        heat = torch.softmax(sim, dim=1).reshape(-1, W, W)
        coords, std = heatmap_expectation_with_std(heat)
        return torch.cat([coords, std[:, None]], dim=-1)

    def forward_fine(self, fmap_f, im_cfeat, pt_cfeat, b_ids, i_ids, j_ids,
                     identity_list: bool = False):
        pt_ffeat = pt_cfeat
        for lyr in self.pt_ffeat_proj:
            pt_ffeat = lyr(pt_ffeat)
        pt_sel = take_rows_b(pt_ffeat, b_ids, j_ids)
        wins = self.gather_fine_windows(fmap_f, im_cfeat, b_ids, i_ids,
                                        identity_list)
        if hasattr(self, "fine_sa"):
            wins = self.fine_sa(wins)
        return self.fine_matching(pt_sel, wins)

    def forward_match(self, img, pt_feat, pt3d, im_mask=None, pt_mask=None,
                      mutual: bool = False, match_thres: float = 0.0,
                      ret_feats: bool = False):
        """Dense c2f forward: the fine stage runs for every image token with
        its best point; ``valid`` masks the tokens without a match.
        ``ret_feats`` adds the L2-normalized coarse features."""
        im_cfeat, fmap_f = self.extract_im_feat_ms(img)
        pt_cfeat = self.extract_pt_feat(pt_feat, pt3d)
        im_cfeat, pt_cfeat = self.apply_coarse_former(im_cfeat, pt_cfeat)
        conf, im_n, pt_n = dual_softmax(
            im_cfeat, pt_cfeat, self.temperature, im_mask, pt_mask,
            temp_type=self.cfg.temp_type)
        matches = extract_mutual_matches(conf, mutual=mutual,
                                         threshold=match_thres)
        B, M = matches["j_ids"].shape
        dev = conf.device
        b_ids = torch.arange(B, device=dev).repeat_interleave(M)
        i_ids = torch.arange(M, device=dev).repeat(B)
        j_ids = matches["j_ids"].reshape(-1)
        expec_f = self.forward_fine(fmap_f, im_cfeat, pt_cfeat, b_ids, i_ids,
                                    j_ids, identity_list=True)
        out = dict(conf_matrix=conf, expec_f=expec_f, fine_b_ids=b_ids,
                   fine_i_ids=i_ids, fine_j_ids=j_ids, **matches)
        if ret_feats:
            out.update(im_cfeat=im_n, pt_cfeat=pt_n)
        return out

    def forward_multi_pair(self, img, pt_feat, pt3d, im_mask=None,
                           pt_mask=None, mutual: bool = False,
                           match_thres: float = 0.0, pair_mesh=None):
        """Top-k retrieval pairs, points (B, K, N, .): the two-scale image
        features once, then per pair the point path, the coarse matching
        and the dense fine stage (every image token with its best point;
        sharded over the pairs with ``pair_mesh``) -> j_ids, mconf, valid
        stacked (K, B, M) and expec_f (K, B * M, 3)."""
        def pair(model, shared, feat, p3d, p_mask):
            im_cfeat0, fmap_f, i_mask = shared
            B, M = im_cfeat0.shape[:2]
            dev = im_cfeat0.device
            im_cfeat, pt_cfeat, m = model._one_pair(
                im_cfeat0, feat, p3d, i_mask, p_mask, mutual, match_thres)
            m["expec_f"] = model.forward_fine(
                fmap_f, im_cfeat, pt_cfeat,
                torch.arange(B, device=dev).repeat_interleave(M),
                torch.arange(M, device=dev).repeat(B),
                m["j_ids"].reshape(-1), identity_list=True)
            return m

        return self._map_pairs(pair, (*self.extract_im_feat_ms(img), im_mask),
                               pt_feat, pt3d, pt_mask, pair_mesh)

    def _point_sharded_feats(self, img, pt_feat, pt3d):
        im_cfeat, fmap_f = self.extract_im_feat_ms(img)
        pt_cfeat = self.extract_pt_feat(pt_feat, pt3d)
        return (*self.apply_coarse_former(im_cfeat, pt_cfeat), fmap_f)

    def _sharded_fine(self, mesh, fmap_f, im_cfeat, pt_cfeat, j_ids):
        """The dense fine stage of a point-sharded match, split over the
        match axis (``make_sharded_fine_stage``; a copy of the model on
        each device) -> expec_f (B * M, 3)."""
        from ..parallel.mesh import replicas
        from ..parallel.point_sharding import make_sharded_fine_stage

        models = replicas(self, mesh)
        fine = make_sharded_fine_stage(
            mesh, lambda s, *a: models[s].forward_fine(*a))
        B, M = j_ids.shape
        dev = im_cfeat.device
        return fine(fmap_f, im_cfeat, pt_cfeat,
                    torch.arange(B, device=dev).repeat_interleave(M),
                    torch.arange(M, device=dev).repeat(B),
                    j_ids.reshape(-1).to(dev))

    def fine_coords(self, expec_f, mpt2d_c):
        """Window-normalized offsets -> image-resolution fine coords."""
        return mpt2d_c + expec_f[:, :2] * self.cfg.win_sz / 2 * self.cfg.fine_ds
