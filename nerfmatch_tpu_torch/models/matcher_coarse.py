"""NeRFMatch coarse matcher ("Mini"), inference (counterpart of
``nerfmatch_tpu/models/matcher_coarse.py``).

Image: ConvFormer 1/8 map -> [proj] -> sine PE -> self-attention.  Points:
NeRF descriptors -> [proj] -> Fourier PE concat+proj (pre or post SA) ->
self-attention.  Cross-attention ``coarse_former``, masked dual softmax and
dense mutual-match extraction.  Images are NHWC.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..nerf.embedding import fourier_embedding, fourier_embedding_dim
from ..ops.matching import (dense_to_match_lists, dual_softmax,
                            extract_mutual_matches)
from .attention import EncoderLayer, SelfAttentionBlock, set_attention_bf16
from .backbone import MetaFormer, make_config
from .position_encoding import add_sine_pe

PT_PE_FREQS = 15


@dataclasses.dataclass(frozen=True)
class CoarseMatcherConfig:
    backbone: str = "convformer384"
    pretrained: bool = True
    cfeat_dim: int = 256
    temp_type: str = "mul"
    im_pe: bool = True
    im_sa: int = 3
    im_sa_type: str | None = "share"
    pt_dim: int = 256
    pt_ftype: str = "nerf"
    pt_feat_norm: bool = False
    pt_pe: bool = True
    pt_pe_type: str = "fourier"
    post_pt_pe: bool = False
    pt_sa: int = 3
    pt_sa_type: str | None = "full"
    cformer_type: str = "crs"
    coarse_layers: int = 1
    attn_bf16: bool = True

    @classmethod
    def from_namespace(cls, ns):
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in vars(ns).items() if k in fields})

    @property
    def effective_pt_dim(self):
        if self.pt_ftype == "pe3d":
            return fourier_embedding_dim(3, PT_PE_FREQS)
        if self.pt_ftype == "pt3d":
            return 3
        return self.pt_dim

    @property
    def pt_pe_dim(self):
        if not self.pt_pe:
            return 0
        if self.pt_pe_type == "id":
            return self.effective_pt_dim
        return fourier_embedding_dim(3, PT_PE_FREQS)

    @property
    def has_pt_sa(self):
        return self.pt_sa_type is not None and self.pt_sa > 0

    @property
    def has_im_sa(self):
        if self.im_sa_type is None or self.im_sa <= 0:
            return False
        if self.im_sa_type == "share":
            return self.has_pt_sa
        assert self.im_sa_type == "full", self.im_sa_type
        return True


def feature_normalization(x):
    x = x - x.mean(dim=1, keepdim=True)
    max_norm = torch.linalg.norm(x, dim=-1).amax(dim=-1)
    return x / max_norm[:, None, None]


class NeRFMatcherCoarse(nn.Module):
    two_scale = False

    def __init__(self, cfg: CoarseMatcherConfig):
        super().__init__()
        if cfg.pt_ftype == "rand":
            raise NotImplementedError("pt_ftype='rand' ablation is not ported")
        self.cfg = cfg
        self.backbone_cfg = make_config(cfg.backbone, two_scale=self.two_scale)
        self._build_backbone()
        self._build_match_trunk()
        set_attention_bf16(self, cfg.attn_bf16)

    def _build_backbone(self):
        self.backbone = MetaFormer(self.backbone_cfg)
        if self.backbone_cfg.dims[-1] != self.cfg.cfeat_dim:
            self.cfeat_proj = nn.Linear(self.backbone_cfg.dims[-1],
                                        self.cfg.cfeat_dim)

    def _build_match_trunk(self):
        cfg = self.cfg
        d = cfg.cfeat_dim
        self.temperature = nn.Parameter(
            torch.tensor(0.1 if cfg.temp_type == "div" else 10.0))
        if cfg.effective_pt_dim != d:
            self.pt_proj = nn.Linear(cfg.effective_pt_dim, d)
        if cfg.pt_pe_dim > 0:
            self.pt_pe_proj = nn.Linear(d + cfg.pt_pe_dim, d)
        if cfg.has_pt_sa:
            self.pt_sa = SelfAttentionBlock(cfg.pt_sa, d, 8, d // 8)
        if cfg.has_im_sa and cfg.im_sa_type == "full":
            self.im_sa = SelfAttentionBlock(cfg.im_sa, d, 8, d // 8)
        if cfg.cformer_type.startswith("crs") and cfg.coarse_layers > 0:
            self.coarse_former = EncoderLayer(d, d, 8, d // 8,
                                              att_mode="cross")

    # ------------------------------------------------------------------
    def im_backbone(self, img_nhwc):
        return self.backbone(img_nhwc)[-1]

    def _im_tokens(self, fmap_c):
        cfg = self.cfg
        b, h, w, _ = fmap_c.shape
        feat = fmap_c.reshape(b, h * w, -1)
        if hasattr(self, "cfeat_proj"):
            feat = self.cfeat_proj(feat)
        if cfg.im_pe:
            feat = add_sine_pe(feat.reshape(b, h, w, -1)).reshape(b, h * w, -1)
        if cfg.has_im_sa:
            feat = (self.pt_sa if cfg.im_sa_type == "share" else self.im_sa)(feat)
        return feat

    def im_feat_from_fmap(self, fmap):
        return self._im_tokens(fmap)

    def extract_im_feat(self, img_nhwc):
        """(B, H, W, 3) -> (B, (H/8)*(W/8), cfeat_dim) image tokens."""
        return self.im_feat_from_fmap(self.im_backbone(img_nhwc))

    def _cat_pe(self, pt_feat, pt_feat_in, pt3d):
        pe = pt_feat_in if self.cfg.pt_pe_type == "id" \
            else fourier_embedding(pt3d, PT_PE_FREQS)
        return self.pt_pe_proj(torch.cat([pt_feat, pe], dim=-1))

    def extract_pt_feat(self, pt_feat, pt3d):
        """(B, N, pt_dim), (B, N, 3) -> (B, N, cfeat_dim) point tokens."""
        cfg = self.cfg
        if cfg.pt_feat_norm:
            pt_feat = feature_normalization(pt_feat)
            pt3d = feature_normalization(pt3d)
        if cfg.pt_ftype == "pt3d":
            pt_feat = pt3d
        elif cfg.pt_ftype == "pe3d":
            pt_feat = fourier_embedding(pt3d, PT_PE_FREQS)
        pt_feat_in = pt_feat
        if hasattr(self, "pt_proj"):
            pt_feat = self.pt_proj(pt_feat)
        if cfg.pt_pe_dim > 0 and not cfg.post_pt_pe:
            pt_feat = self._cat_pe(pt_feat, pt_feat_in, pt3d)
        if cfg.has_pt_sa:
            pt_feat = self.pt_sa(pt_feat)
        if cfg.pt_pe_dim > 0 and cfg.post_pt_pe:
            pt_feat = self._cat_pe(pt_feat, pt_feat_in, pt3d)
        return pt_feat

    def apply_coarse_former(self, im_cfeat, pt_cfeat):
        if not hasattr(self, "coarse_former"):
            return im_cfeat, pt_cfeat
        ca = self.coarse_former
        if self.cfg.cformer_type == "crs":
            im_cfeat = ca(im_cfeat, pt_cfeat)
            pt_cfeat = ca(pt_cfeat, im_cfeat)  # sequential: sees updated im
        else:
            im_cfeat, pt_cfeat = ca(im_cfeat, pt_cfeat), ca(pt_cfeat, im_cfeat)
        return im_cfeat, pt_cfeat

    def coarse_match(self, im_cfeat, pt_cfeat, im_mask, pt_mask, mutual,
                     match_thres):
        conf, im_n, pt_n = dual_softmax(
            im_cfeat, pt_cfeat, self.temperature, im_mask, pt_mask,
            temp_type=self.cfg.temp_type)
        return conf, extract_mutual_matches(conf, mutual=mutual,
                                            threshold=match_thres)

    def forward_match(self, img, pt_feat, pt3d, im_mask=None, pt_mask=None,
                      mutual: bool = False, match_thres: float = 0.0):
        im_cfeat = self.extract_im_feat(img)
        pt_cfeat = self.extract_pt_feat(pt_feat, pt3d)
        im_cfeat, pt_cfeat = self.apply_coarse_former(im_cfeat, pt_cfeat)
        conf, matches = self.coarse_match(im_cfeat, pt_cfeat, im_mask, pt_mask,
                                          mutual, match_thres)
        return dict(conf_matrix=conf, **matches)

    @torch.no_grad()
    def eval_match(self, img, pt_feat, pt3d, im_mask=None, pt_mask=None,
                   mutual: bool = False, match_thres: float = 0.0,
                   top_k: int | None = None):
        """Inference forward: only what localization consumes (the dense
        conf matrix is dropped), plus top-k match lists under ``lists``."""
        out = self.forward_match(img, pt_feat, pt3d, im_mask, pt_mask,
                                 mutual=mutual, match_thres=match_thres)
        res = {k: out[k] for k in ("j_ids", "mconf", "valid", "expec_f")
               if k in out}
        if top_k:
            res["lists"] = dense_to_match_lists(res, top_k)
        return res
