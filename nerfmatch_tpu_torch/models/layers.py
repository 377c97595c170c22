"""Shared NN pieces (counterpart of ``nerfmatch_tpu/models/layers.py``):
activations by name and seeded parameter initialization.

Modules are plain ``torch.nn`` layers (``nn.Linear``, ``nn.LayerNorm``,
``nn.Conv2d``) so their state-dict keys are the reference's.
:func:`init_params_` re-draws every parameter from an explicit
``torch.Generator`` with torch's default distributions, so a model built
from a seed is the same on any device.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

ACTIVATIONS = {
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="none"),  # torch nn.GELU (erf)
}


class Activation(nn.Module):
    def __init__(self, name: str):
        super().__init__()
        self.name = name

    def forward(self, x):
        return ACTIVATIONS[self.name](x)


@torch.no_grad()
def init_params_(module: nn.Module, generator: torch.Generator):
    """Re-draw all parameters from ``generator``: Linear/Conv weights and
    biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)), LayerNorm weight 1 / bias 0;
    other parameters keep their constructed values."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            for p in (m.weight, m.bias):
                if p is not None:
                    u = torch.rand(p.shape, generator=generator)
                    p.copy_((u * 2.0 - 1.0) * bound)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
    return module
