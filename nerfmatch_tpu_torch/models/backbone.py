"""ConvFormer (MetaFormer with SepConv mixers) stages 0-1 (counterpart of
``nerfmatch_tpu/models/backbone.py``).

NHWC at the boundaries; the convolutions run as ``F.conv2d`` in NCHW, except
the token mixers' StarReLU + 7x7 depthwise conv, which CUDA tensors run
through the fused ``dw_star`` kernels where the JAX package's gate allows.
Module names follow the reference (timm ``FeatureListNet`` flattening:
``stem``, ``stages_0``, ``stages_1``); the two-scale variant wraps the
trunk in ``.model`` and keeps its FPN convs on the wrapper, as the
reference's ``MetaFormer_MS`` does.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.kernels.sepconv_kernel import dw_star, dw_star_available

_LN_EPS = 1e-6
_BN_EPS = 1e-5

SUPPORTED = {
    "convformer": ((3, 12), (128, 256)),
    "convformer384": ((3, 12), (128, 256)),
    "caformer": ((3, 12), (128, 256)),
    "caformer384": ((3, 12), (128, 256)),
    "tiny": ((1, 1), (16, 32)),
}


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    depths: tuple
    dims: tuple
    stem_stride: int = 4
    stem_pad: int = 2
    stage1_stride: int = 2
    mlp_ratio: int = 4
    sep_expansion: int = 2
    use_fpn: bool = False


def make_config(name: str, two_scale: bool = False) -> BackboneConfig:
    use_fpn = "_fpn" in name
    base = name.replace("_fpn", "")
    for key in SUPPORTED:
        if base.startswith(key):
            base = key
            break
    depths, dims = SUPPORTED[base]
    if two_scale:
        return BackboneConfig(depths, dims, stem_stride=2, stem_pad=3,
                              stage1_stride=4, use_fpn=use_fpn)
    return BackboneConfig(depths, dims)


class StarReLU(nn.Module):
    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(1.0 / math.sqrt(1.25)))
        self.bias = nn.Parameter(torch.tensor(-0.5 / math.sqrt(1.25)))

    def forward(self, x):
        return self.scale * torch.relu(x) ** 2 + self.bias


class LayerNormNoBias(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var + _LN_EPS) * self.weight


def conv_nhwc(conv: nn.Conv2d, x):
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias, conv.stride,
                 conv.padding, groups=conv.groups)
    return y.permute(0, 2, 3, 1)


class SepConv(nn.Module):
    def __init__(self, dim: int, expansion: int):
        super().__init__()
        mid = dim * expansion
        self.pwconv1 = nn.Linear(dim, mid)
        self.act1 = StarReLU()
        self.dwconv = nn.Conv2d(mid, mid, 7, padding=3, groups=mid)
        self.pwconv2 = nn.Linear(mid, dim)

    def forward(self, x):
        h = self.pwconv1(x)
        w = self.dwconv.weight[:, 0].permute(1, 2, 0)            # (K, K, C)
        if h.device.type == "cuda" and dw_star_available(h, w):
            # StarReLU + depthwise conv fused (kernels 7, 8, 9): the same
            # shapes the JAX package routes through its dw_star.
            h = dw_star(h, w, self.dwconv.bias, self.act1.scale,
                        self.act1.bias)
            return self.pwconv2(h)
        return self.pwconv2(conv_nhwc(self.dwconv, self.act1(h)))


class Mlp(nn.Module):
    def __init__(self, dim: int, ratio: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim * ratio)
        self.act = StarReLU()
        self.fc2 = nn.Linear(dim * ratio, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, cfg: BackboneConfig):
        super().__init__()
        self.norm1 = LayerNormNoBias(dim)
        self.token_mixer = SepConv(dim, cfg.sep_expansion)
        self.norm2 = LayerNormNoBias(dim)
        self.mlp = Mlp(dim, cfg.mlp_ratio)

    def forward(self, x):
        x = x + self.token_mixer(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class Downsample(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, stride: int):
        super().__init__()
        self.norm = LayerNormNoBias(in_dim)
        self.conv = nn.Conv2d(in_dim, out_dim, 3, stride=stride, padding=1)

    def forward(self, x):
        return conv_nhwc(self.conv, self.norm(x))


class Stage(nn.Module):
    def __init__(self, depth: int, dim: int, cfg: BackboneConfig,
                 down: Downsample | None):
        super().__init__()
        if down is not None:
            self.downsample = down
        self.blocks = nn.Sequential(*[Block(dim, cfg) for _ in range(depth)])

    def forward(self, x):
        if hasattr(self, "downsample"):
            x = self.downsample(x)
        return self.blocks(x)


class Stem(nn.Module):
    def __init__(self, in_ch: int, dim: int, stride: int, pad: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, dim, 7, stride=stride, padding=pad)
        self.norm = LayerNormNoBias(dim)

    def forward(self, x):
        return self.norm(conv_nhwc(self.conv, x))


class MetaFormer(nn.Module):
    """Stages 0-1; forward returns the per-stage NHWC maps."""

    def __init__(self, cfg: BackboneConfig, in_ch: int = 3):
        super().__init__()
        self.stem = Stem(in_ch, cfg.dims[0], cfg.stem_stride, cfg.stem_pad)
        self.stages_0 = Stage(cfg.depths[0], cfg.dims[0], cfg, None)
        self.stages_1 = Stage(cfg.depths[1], cfg.dims[1], cfg, Downsample(
            cfg.dims[0], cfg.dims[1], cfg.stage1_stride))

    def forward(self, x):
        x0 = self.stages_0(self.stem(x))
        return [x0, self.stages_1(x0)]


class FrozenBatchNorm(nn.Module):
    """BatchNorm2d over NHWC that normalizes with its running statistics,
    in training too (the JAX trainer's ``fpn_apply(train=False)``), with the
    reference's four state entries.  As in the JAX package, where all four
    are parameter leaves, ``running_mean`` and ``running_var`` are
    parameters: the optimizer moves them by their gradients (the reference
    trains the FPN in train-mode BatchNorm instead: batch statistics and a
    momentum update of the running ones)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.running_mean = nn.Parameter(torch.zeros(dim))
        self.running_var = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + _BN_EPS) * self.weight
        return (x - self.running_mean) * inv + self.bias


def bilinear_upsample(x, factor: int):
    """NHWC bilinear upsample with align_corners=True."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=factor,
                      mode="bilinear", align_corners=True)
    return y.permute(0, 2, 3, 1)


class MetaFormerMS(nn.Module):
    """Two-scale (1/8, 1/2) backbone with the stem-stride surgery; the FPN
    (``*_fpn`` names) merges the 1/8 map into the 1/2 map."""

    def __init__(self, cfg: BackboneConfig):
        super().__init__()
        self.cfg = cfg
        self.model = MetaFormer(cfg)
        if cfg.use_fpn:
            d0, d1 = cfg.dims
            self.layer2_outconv = nn.Conv2d(d1, d1, 1, bias=False)
            self.layer1_outconv = nn.Conv2d(d0, d1, 1, bias=False)
            self.layer1_outconv2 = nn.Sequential(
                nn.Conv2d(d1, d1, 3, padding=1, bias=False),
                FrozenBatchNorm(d1), nn.LeakyReLU(0.01),
                nn.Conv2d(d1, d0, 3, padding=1, bias=False))

    def forward(self, img_nhwc):
        """-> (coarse 1/8 map, fine 1/2 map), NHWC."""
        f_fine, f_coarse = self.model(img_nhwc)
        if self.cfg.use_fpn:
            x2_out = conv_nhwc(self.layer2_outconv, f_coarse)
            h = conv_nhwc(self.layer1_outconv, f_fine) \
                + bilinear_upsample(x2_out, 4)
            c1, bn, act, c2 = self.layer1_outconv2
            h = conv_nhwc(c2, act(bn(conv_nhwc(c1, h))))
            return x2_out, h
        return f_coarse, f_fine
