"""Transformer attention for the matcher (counterpart of
``nerfmatch_tpu/models/attention.py``): FullAttention, LSA, MHA, FFN, the
pre/post-norm encoder layer and the Self / SelfCross blocks.

Reference quirks kept on purpose: the FullAttention temperature divides,
LSA softmaxes the unmasked logits, and the pre-norm encoder layer's final
residual adds the *normalized* input.  The softmax core (:func:`attend`)
runs the attention kernel for unbiased CUDA calls that pass the JAX
package's size gate, and plain torch otherwise.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.kernels.attention_kernel import (attention_plain, fused_attention,
                                            fused_attention_available)
from .layers import Activation


def attend(qs, k, v, bias=None, bf16: bool = False):
    """Pre-scaled softmax attention core; (B, N, H, D) layout."""
    if bias is None and qs.device.type == "cuda" \
            and fused_attention_available(qs, k):
        return fused_attention(qs, k, v, bf16)
    if bias is None:
        return attention_plain(qs, k, v)
    logits = torch.einsum("blhd,bshd->bhls", qs, k) + bias
    return torch.einsum("bhls,bshd->blhd", torch.softmax(logits, dim=-1), v)


class LSAttend(nn.Module):
    """Learned temperature of locality self-attention (``attend.scale``)."""

    def __init__(self, head_dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(math.log(head_dim**-0.5)))


class MultiHeadAttention(nn.Module):
    def __init__(self, model_dim: int, context_dim: int | None = None,
                 head_num: int = 8, head_dim: int = 64,
                 att_type: str = "full"):
        super().__init__()
        context_dim = context_dim or model_dim
        inner = head_num * head_dim
        self.head_num = head_num
        self.att_type = att_type
        self.proj_q = nn.Linear(model_dim, inner, bias=False)
        self.proj_k = nn.Linear(context_dim, inner, bias=False)
        self.proj_v = nn.Linear(context_dim, inner, bias=False)
        self.proj_out = nn.Sequential(nn.Linear(inner, model_dim, bias=False))
        if att_type == "lsa":
            self.attend = LSAttend(head_dim)
        self.attn_bf16 = False

    def forward(self, query, key, value, attn_bias=None):
        split = lambda t: t.reshape(t.shape[0], t.shape[1], self.head_num, -1)
        q = split(self.proj_q(query))
        k = split(self.proj_k(key))
        v = split(self.proj_v(value))
        if self.att_type == "lsa":
            qs = q * torch.exp(self.attend.scale)
        else:
            qs = q * (1.0 / math.sqrt(q.shape[-1]))
        out = attend(qs, k, v, attn_bias, self.attn_bf16)
        return self.proj_out(out.reshape(out.shape[0], out.shape[1], -1))


class FeedForward(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, act: str = "relu"):
        super().__init__()
        self.layers = nn.Sequential(nn.Linear(in_dim, in_dim), Activation(act),
                                    nn.Linear(in_dim, out_dim))

    def forward(self, x):
        return self.layers(x)


class EncoderLayer(nn.Module):
    """Pre/post-norm transformer encoder layer, self or cross attention."""

    def __init__(self, model_dim: int = 512, context_dim: int | None = None,
                 head_num: int = 8, head_dim: int = 64, norm_type: str = "pre",
                 act_fn: str = "gelu", att_type: str = "full",
                 att_mode: str = "self"):
        super().__init__()
        assert not (att_type == "lsa" and att_mode == "cross")
        context_dim = context_dim or model_dim
        self.norm_type = norm_type
        self.att_mode = att_mode
        self.attention = MultiHeadAttention(model_dim, context_dim, head_num,
                                            head_dim, att_type)
        norms = [nn.LayerNorm(model_dim)]
        if norm_type == "pre" and att_mode == "cross":
            norms.append(nn.LayerNorm(context_dim))
        self.norm1 = nn.ModuleList(norms)
        self.feedforward = FeedForward(model_dim, model_dim, act_fn)
        self.norm2 = nn.LayerNorm(model_dim)

    def forward(self, x, context=None, attn_bias=None):
        if self.att_mode == "self":
            assert context is None
            context = x
        if self.norm_type == "pre":
            xn = self.norm1[0](x)
            norm_c = self.norm1[1] if len(self.norm1) > 1 else self.norm1[0]
            cn = norm_c(context) if self.att_mode == "cross" else xn
            out = xn + self.attention(xn, cn, cn, attn_bias)
            # Reference quirk: the final residual adds the normalized input.
            return xn + self.feedforward(self.norm2(out))
        out = self.norm1[0](x + self.attention(x, context, context, attn_bias))
        return self.norm2(x + self.feedforward(out))


class SelfAttentionBlock(nn.Module):
    def __init__(self, layer_num: int, model_dim: int = 256,
                 head_num: int = 8, head_dim: int = 64, att_type: str = "full",
                 act_fn: str = "gelu"):
        super().__init__()
        self.layers = nn.Sequential(*[
            EncoderLayer(model_dim, head_num=head_num, head_dim=head_dim,
                         act_fn=act_fn, att_type=att_type, att_mode="self")
            for _ in range(layer_num)])

    def forward(self, x, attn_bias=None):
        for layer in self.layers:
            x = layer(x, attn_bias=attn_bias)
        return x


class SelfCrossBlock(nn.Module):
    def __init__(self, sa_layer_num: int = 3, model_dim: int = 256,
                 head_dim: int = 64, sa_head_num: int = 8,
                 ca_head_num: int = 8, sa_type: str = "lsa",
                 ca_type: str = "full", sa_act: str = "relu",
                 ca_act: str = "gelu"):
        super().__init__()
        self.sa = SelfAttentionBlock(sa_layer_num, model_dim, sa_head_num,
                                     head_dim, sa_type, sa_act)
        self.ca = EncoderLayer(model_dim, model_dim, ca_head_num, head_dim,
                               act_fn=ca_act, att_type=ca_type,
                               att_mode="cross")

    def forward(self, x1, x2):
        x1 = self.sa(x1)
        x2 = self.sa(x2)
        return self.ca(x1, x2), self.ca(x2, x1)


def set_attention_bf16(module: nn.Module, enabled: bool):
    """Operand storage of the attention kernel for every MHA in ``module``."""
    for m in module.modules():
        if isinstance(m, MultiHeadAttention):
            m.attn_bf16 = enabled
