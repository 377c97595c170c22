"""NeRFMatch coarse matcher ("Mini"), inference and training (counterpart
of ``nerfmatch_tpu/models/matcher_coarse.py``).

Image: ConvFormer 1/8 map -> [proj] -> sine PE -> self-attention.  Points:
NeRF descriptors -> [proj] -> Fourier PE concat+proj (pre or post SA) ->
self-attention.  Cross-attention ``coarse_former``, masked dual softmax and
dense mutual-match extraction.  Images are NHWC.  Top-k retrieval pairs
(points (B, K, N, .)) run the image branch once and the rest once a pair
(:meth:`NeRFMatcherCoarse.forward_multi_pair`).  The ``pt_ftype='rand'``
ablation replaces the point descriptors by standard normal draws: from the
trainer's generator in training, from a generator seeded with 0 at
inference (the JAX package's ``PRNGKey(0)``; the draws themselves differ
from ``jax.random``'s).
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


def rand_point_features(shape, dim: int, device,
                        generator: torch.Generator | None = None):
    """The ``pt_ftype='rand'`` descriptors: (*shape, dim) standard normal
    draws from ``generator``, or from a fresh generator seeded with 0 (the
    inference draw, the same at every call)."""
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    return torch.randn((*shape, dim), generator=generator, device=device)


def feature_normalization(x):
    x = x - x.mean(dim=1, keepdim=True)
    max_norm = torch.linalg.norm(x, dim=-1).amax(dim=-1)
    return x / max_norm[:, None, None]


class NeRFMatcherCoarse(nn.Module):
    two_scale = False

    def __init__(self, cfg: CoarseMatcherConfig):
        super().__init__()
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
        # The div (LoFTR) temperature is frozen, as in the reference
        # (requires_grad=False; the JAX package stops its gradient and keeps
        # it out of weight decay); trainers leave it out of the optimizer.
        self.temperature = nn.Parameter(
            torch.tensor(0.1 if cfg.temp_type == "div" else 10.0),
            requires_grad=cfg.temp_type != "div")
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

    def extract_pt_feat(self, pt_feat, pt3d, generator=None, rand_feat=None):
        """(B, N, pt_dim), (B, N, 3) -> (B, N, cfeat_dim) point tokens.
        ``pt_ftype='rand'`` draws the descriptors from ``generator`` (None:
        the fixed inference draw) unless ``rand_feat`` (B, N, pt_dim) gives
        them."""
        cfg = self.cfg
        if cfg.pt_feat_norm:
            pt_feat = feature_normalization(pt_feat)
            pt3d = feature_normalization(pt3d)
        if cfg.pt_ftype == "pt3d":
            pt_feat = pt3d
        elif cfg.pt_ftype == "rand":
            pt_feat = rand_feat if rand_feat is not None else \
                rand_point_features(pt_feat.shape[:2], cfg.effective_pt_dim,
                                    pt_feat.device, generator)
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

    def forward_match(self, img, pt_feat, pt3d, im_mask=None, pt_mask=None,
                      mutual: bool = False, match_thres: float = 0.0,
                      ret_feats: bool = False):
        """-> dict(conf_matrix, j_ids, mconf, valid[, im_cfeat, pt_cfeat]);
        ``ret_feats`` adds the L2-normalized features the dual softmax saw."""
        im_cfeat = self.extract_im_feat(img)
        pt_cfeat = self.extract_pt_feat(pt_feat, pt3d)
        im_cfeat, pt_cfeat = self.apply_coarse_former(im_cfeat, pt_cfeat)
        conf, im_n, pt_n = dual_softmax(
            im_cfeat, pt_cfeat, self.temperature, im_mask, pt_mask,
            temp_type=self.cfg.temp_type)
        out = dict(conf_matrix=conf, **extract_mutual_matches(
            conf, mutual=mutual, threshold=match_thres))
        if ret_feats:
            out.update(im_cfeat=im_n, pt_cfeat=pt_n)
        return out

    def _one_pair(self, im_cfeat0, pt_feat, pt3d, im_mask, pt_mask, mutual,
                  match_thres):
        """One pair's points (B, N, .) through the point path, the coarse
        former and the matching against the image tokens ``im_cfeat0`` ->
        (im_cfeat, pt_cfeat, matches)."""
        pt_cfeat = self.extract_pt_feat(pt_feat, pt3d)
        im_cfeat, pt_cfeat = self.apply_coarse_former(im_cfeat0, pt_cfeat)
        conf, _, _ = dual_softmax(im_cfeat, pt_cfeat, self.temperature,
                                  im_mask, pt_mask,
                                  temp_type=self.cfg.temp_type)
        return im_cfeat, pt_cfeat, extract_mutual_matches(
            conf, mutual=mutual, threshold=match_thres)

    def _map_pairs(self, pair_fn, shared, pt_feat, pt3d, pt_mask, pair_mesh):
        """``pair_fn(model, shared, ipt_feat, ipt3d, ipt_mask)`` for each pair
        of multi-pair points (B, K, N, .; an absent mask is ones), on the
        model's device or, with a ``pair_mesh`` of more than one device,
        sharded over its pairs (``parallel.pair_sharding``; the image-side
        tensors ``shared`` and the model copied to each device) -> dict of
        the outputs stacked (K, ...)."""
        if pt_mask is None:
            pt_mask = pt3d.new_ones(pt3d.shape[:3])
        args_k = [x.transpose(0, 1) for x in (pt_feat, pt3d, pt_mask)]
        if pair_mesh is None or pair_mesh.size == 1:
            outs = [pair_fn(self, shared, *(x[k] for x in args_k))
                    for k in range(pt3d.shape[1])]
            return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        from ..parallel.mesh import device_put, replicas, replicated
        from ..parallel.pair_sharding import map_pairs_sharded

        models = replicas(self, pair_mesh)
        rep = [[None] * pair_mesh.size if x is None
               else device_put(x, replicated(pair_mesh)) for x in shared]
        return map_pairs_sharded(
            pair_mesh, lambda s, *a: pair_fn(
                models[s], tuple(r[s] for r in rep), *a), args_k)

    def forward_multi_pair(self, img, pt_feat, pt3d, im_mask=None,
                           pt_mask=None, mutual: bool = False,
                           match_thres: float = 0.0, pair_mesh=None):
        """Top-k retrieval pairs: points (B, K, N, .) against one image.  The
        image branch runs once; the point path, the coarse former and the
        matching run once a pair (a loop over K where JAX maps; sharded
        over the pairs with ``pair_mesh``) -> dense matches stacked (K, B,
        M): j_ids, mconf, valid."""
        def pair(model, shared, feat, p3d, p_mask):
            im_cfeat0, i_mask = shared
            return model._one_pair(im_cfeat0, feat, p3d, i_mask, p_mask,
                                   mutual, match_thres)[2]

        return self._map_pairs(pair, (self.extract_im_feat(img), im_mask),
                               pt_feat, pt3d, pt_mask, pair_mesh)

    @torch.no_grad()
    def eval_match(self, img, pt_feat, pt3d, im_mask=None, pt_mask=None,
                   mutual: bool = False, match_thres: float = 0.0,
                   top_k: int | None = None, pair_mesh=None):
        """Inference forward: only what localization consumes (the dense
        conf matrix is dropped), plus top-k match lists under ``lists``.
        Multi-pair points (pt3d (B, K, N, 3)) go through
        :meth:`forward_multi_pair` (sharded over the pairs with
        ``pair_mesh``): every output gains a leading pair axis, the lists
        (K, B, top_k) too."""
        multi = pt3d.dim() == 4
        kw = {"pair_mesh": pair_mesh} if multi else {}
        fwd = self.forward_multi_pair if multi else self.forward_match
        out = fwd(img, pt_feat, pt3d, im_mask, pt_mask, mutual=mutual,
                  match_thres=match_thres, **kw)
        res = {k: out[k] for k in ("j_ids", "mconf", "valid", "expec_f")
               if k in out}
        if top_k:
            dense = {k: res[k] for k in ("j_ids", "mconf", "valid")}
            if not multi:
                res["lists"] = dense_to_match_lists(dense, top_k)
            else:
                lists = [dense_to_match_lists({k: v[i] for k, v in dense.items()},
                                              top_k)
                         for i in range(pt3d.shape[1])]
                res["lists"] = {k: torch.stack([m[k] for m in lists])
                                for k in lists[0]}
        return res

    def _point_sharded_feats(self, img, pt_feat, pt3d):
        """-> (image tokens, point tokens after the coarse former, fine map
        or None): the replicated half of the point-sharded match."""
        im_cfeat = self.extract_im_feat(img)
        pt_cfeat = self.extract_pt_feat(pt_feat, pt3d)
        return (*self.apply_coarse_former(im_cfeat, pt_cfeat), None)

    @torch.no_grad()
    def eval_match_point_sharded(self, mesh, img, pt_feat, pt3d, im_mask=None,
                                 pt_mask=None, mutual: bool = False,
                                 match_thres: float = 0.0,
                                 top_k: int | None = None):
        """Single-pair matching with the POINT axis split over ``mesh``
        (``parallel.point_sharding``): the features once on the model's
        device, the (M, N) dual softmax and the mutual extraction in (M,
        N/d) blocks -> :meth:`eval_match`'s outputs (on the mesh's first
        device); for merged multi-pair clouds, where that matrix grows with
        ``pair_topk``."""
        from ..parallel.point_sharding import sharded_point_match

        im_cfeat, pt_cfeat, fmap_f = self._point_sharded_feats(img, pt_feat,
                                                               pt3d)
        out = sharded_point_match(mesh, im_cfeat, pt_cfeat, self.temperature,
                                  im_mask, pt_mask,
                                  temp_type=self.cfg.temp_type, mutual=mutual,
                                  threshold=match_thres)
        if fmap_f is not None:
            out["expec_f"] = self._sharded_fine(mesh, fmap_f, im_cfeat,
                                                pt_cfeat, out["j_ids"])
        if top_k:
            out["lists"] = dense_to_match_lists(
                {k: out[k] for k in ("j_ids", "mconf", "valid")}, top_k)
        return out
