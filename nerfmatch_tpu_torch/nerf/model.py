"""NeRF MLP as an ``nn.Module`` (counterpart of ``nerfmatch_tpu/nerf/model.py``).

8 x hid trunk with the input skip concat after each layer in ``skips``,
optional viewdir branch (alpha / feature heads, one views layer, sigmoid
rgb), and the layer-``stop_layer`` descriptor tap.  Parameter names are the
reference's state-dict keys (``pts_linears.<i>``, ``alpha_linear``, ...).
The scene-coordinate head (``out_3d_pnt``) is not ported; configs that ask
for it raise.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class NerfConfig:
    layer_num: int = 8
    hid_dim: int = 256
    xyz_dim: int = 3
    dirs_dim: int = 3
    app_dim: int = 0
    output_dim: int = 4
    skips: tuple = (4,)
    use_viewdirs: bool = False
    out_3d_pnt: object = False
    stop_layer: int = -1
    num_pts: int = 128

    @classmethod
    def from_namespace(cls, ns, **overrides):
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in vars(ns).items() if k in fields}
        kw.update(overrides)
        if isinstance(kw.get("skips"), list):
            kw["skips"] = tuple(kw["skips"])
        return cls(**kw)


def eval_feat_layer(cfg: NerfConfig) -> int:
    """Descriptor-tap layer: an explicit ``stop_layer >= 0`` wins, otherwise
    the final hidden layer (``render_kernel.py: eval_feat_layer``)."""
    return cfg.stop_layer if cfg.stop_layer >= 0 else cfg.layer_num - 1


class NerfMLP(nn.Module):
    def __init__(self, cfg: NerfConfig):
        super().__init__()
        if cfg.out_3d_pnt:
            raise NotImplementedError(
                "out_3d_pnt (scene-coordinate head) is not ported "
                "(ROADMAP: training slice)")
        self.cfg = cfg
        layers = []
        in_dim = cfg.xyz_dim
        for i in range(cfg.layer_num):
            layers.append(nn.Linear(in_dim, cfg.hid_dim))
            in_dim = cfg.hid_dim + cfg.xyz_dim if i in cfg.skips else cfg.hid_dim
        self.pts_linears = nn.ModuleList(layers)
        if cfg.use_viewdirs:
            self.feature_linear = nn.Linear(cfg.hid_dim, cfg.hid_dim)
            self.alpha_linear = nn.Linear(cfg.hid_dim, 1)
            self.views_linears = nn.ModuleList([nn.Linear(
                cfg.dirs_dim + cfg.hid_dim + cfg.app_dim, cfg.hid_dim // 2)])
            self.rgb_linear = nn.Linear(cfg.hid_dim // 2, cfg.output_dim - 1)
        else:
            self.output_linear = nn.Linear(cfg.hid_dim, cfg.output_dim)

    def forward(self, x, dtype=None):
        """Encoded inputs (..., xyz+dirs+app) -> (outputs, point feature).
        ``dtype`` (e.g. ``torch.bfloat16``): run every layer in that type
        (inputs and parameters cast, as ``nerf_apply(compute_dtype=...)``);
        outputs come back in f32."""
        cfg = self.cfg
        lin = F.linear if dtype is None else (
            lambda h, w, b: F.linear(h, w.to(dtype), b.to(dtype)))
        if dtype is not None:
            x = x.to(dtype)
        input_pts = x[..., : cfg.xyz_dim]
        input_views = x[..., cfg.xyz_dim:cfg.xyz_dim + cfg.dirs_dim]
        input_app = x[..., cfg.xyz_dim + cfg.dirs_dim:]
        h = input_pts
        stop_feat = None
        for i, layer in enumerate(self.pts_linears):
            h = torch.relu(lin(h, layer.weight, layer.bias))
            if i == cfg.stop_layer:
                stop_feat = h
            if i in cfg.skips:
                h = torch.cat([input_pts, h], dim=-1)
        if cfg.use_viewdirs:
            alpha = lin(h, self.alpha_linear.weight, self.alpha_linear.bias)
            feature = lin(h, self.feature_linear.weight,
                          self.feature_linear.bias)
            h_rgb = torch.cat([feature, input_views, input_app], dim=-1)
            for lyr in self.views_linears:
                h_rgb = torch.relu(lin(h_rgb, lyr.weight, lyr.bias))
            rgb = torch.sigmoid(lin(h_rgb, self.rgb_linear.weight,
                                    self.rgb_linear.bias))
            outputs = torch.cat([rgb, alpha], dim=-1)
        else:
            outputs = lin(h, self.output_linear.weight,
                          self.output_linear.bias)
        feat = stop_feat if cfg.stop_layer >= 0 else h
        return outputs.float(), feat.float()
