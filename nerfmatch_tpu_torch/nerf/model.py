"""NeRF MLP as an ``nn.Module`` (counterpart of ``nerfmatch_tpu/nerf/model.py``).

8 x hid trunk with the input skip concat after each layer in ``skips``,
the viewdir branch (alpha / feature heads, one views layer, sigmoid rgb) or,
without viewdirs, one ``output_linear`` head, the layer-``stop_layer``
descriptor tap, and the scene-coordinate head ``pnt_block`` (``out_3d_pnt``:
``True`` for the default mode, or ``"short"``, ``"begin"``, ``"viewdir"``),
which adds ``out_add_ch`` channels to the outputs outside validation.
Parameter names are the reference's state-dict keys (``pts_linears.<i>``,
``alpha_linear``, ``output_linear``, ``pnt_block.<i>``, ...).
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
    out_3d_pnt: object = False  # False | True | "short" | "begin" | "viewdir"
    out_add_ch: int = 0
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


def pnt_mode(cfg: NerfConfig):
    """The scene-coordinate head's mode: None without one, ``"default"`` for
    ``out_3d_pnt=True``, else the string."""
    if not cfg.out_3d_pnt:
        return None
    return cfg.out_3d_pnt if isinstance(cfg.out_3d_pnt, str) else "default"


def effective_stop_layer(cfg: NerfConfig) -> int:
    """The tapped trunk layer: an explicit ``stop_layer >= 0``, else layer 4
    for a ``"begin"`` head, else -1 (none)."""
    if cfg.stop_layer >= 0:
        return cfg.stop_layer
    return 4 if "begin" in (pnt_mode(cfg) or "") else -1


def eval_feat_layer(cfg: NerfConfig) -> int:
    """Descriptor-tap layer of the render kernels: an explicit
    ``stop_layer >= 0`` wins, then layer 4 for a ``"begin"`` head, otherwise
    the final hidden layer (``render_kernel.py: eval_feat_layer``)."""
    sl = effective_stop_layer(cfg)
    return sl if sl >= 0 else cfg.layer_num - 1


def pnt_block_dims(cfg: NerfConfig):
    """Layer widths of the scene-coordinate head, input first."""
    mode = pnt_mode(cfg)
    if "viewdir" in mode:
        return [cfg.hid_dim // 2, cfg.hid_dim // 2, cfg.out_add_ch]
    if mode == "short":
        return [cfg.hid_dim, cfg.out_add_ch]
    return [cfg.hid_dim, cfg.hid_dim // 2, cfg.out_add_ch]


class NerfMLP(nn.Module):
    def __init__(self, cfg: NerfConfig):
        super().__init__()
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
        if cfg.out_3d_pnt:
            dims = pnt_block_dims(cfg)
            self.pnt_block = nn.ModuleList([nn.Linear(a, b) for a, b in
                                            zip(dims[:-1], dims[1:])])

    def forward(self, x, dtype=None, val: bool = False):
        """Encoded inputs (..., xyz+dirs+app) -> (outputs, point feature).
        ``dtype`` (e.g. ``torch.bfloat16``): run every layer in that type
        (inputs and parameters cast, each product rounded to ``dtype``
        before its bias is added, as ``nerf_apply(compute_dtype=...)``);
        outputs come back in f32.  The scene-coordinate head's channels
        follow the heads' outside validation (``val=False``)."""
        cfg = self.cfg
        lin = F.linear if dtype is None else (
            lambda h, w, b: torch.matmul(h, w.to(dtype).t()) + b.to(dtype))
        # XLA's logistic in a narrow type rounds after each of its steps.
        sigmoid = torch.sigmoid if dtype is None else (
            lambda y: 1.0 / (1.0 + torch.exp(-y)))
        if dtype is not None:
            x = x.to(dtype)
        input_pts = x[..., : cfg.xyz_dim]
        input_views = x[..., cfg.xyz_dim:cfg.xyz_dim + cfg.dirs_dim]
        input_app = x[..., cfg.xyz_dim + cfg.dirs_dim:]
        stop_layer = effective_stop_layer(cfg)
        h = input_pts
        stop_feat = h_rgb = None
        for i, layer in enumerate(self.pts_linears):
            h = torch.relu(lin(h, layer.weight, layer.bias))
            if i == stop_layer:
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
            rgb = sigmoid(lin(h_rgb, self.rgb_linear.weight,
                              self.rgb_linear.bias))
            outputs = torch.cat([rgb, alpha], dim=-1)
        else:
            outputs = lin(h, self.output_linear.weight,
                          self.output_linear.bias)
        mode = pnt_mode(cfg)
        if mode is not None and not val:
            p = h_rgb if "viewdir" in mode else (
                stop_feat if "begin" in mode else h)
            for i, lyr in enumerate(self.pnt_block):
                p = lin(p, lyr.weight, lyr.bias)
                if i < len(self.pnt_block) - 1:
                    p = torch.relu(p)
            outputs = torch.cat([outputs, p], dim=-1)
        # The descriptor (nerf_apply's pick): an explicit tap, else the views
        # layer's activations of a "viewdir" head, else the "begin" tap, else
        # the last hidden state.
        if cfg.stop_layer < 0 and "viewdir" in (mode or ""):
            feat = h_rgb
        else:
            feat = stop_feat if stop_layer >= 0 else h
        return outputs.float(), feat.float()
