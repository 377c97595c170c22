"""Multi-head softmax attention, forward and backward: CUDA kernel wrappers
and plain versions.

Replaces ``nerfmatch_tpu/ops/pallas/attention_kernel.py: _fused_fwd``
(``_attn_kernel``) and ``_fused_bwd`` (``_attn_bwd_kernel``) with
``csrc/attention.cu``: non-causal, unmasked ``softmax(qs k^T) v`` with
``qs`` pre-scaled by the caller (the learned LSA scale and ``1/sqrt(d)``
stay outside, so their gradients flow through plain autograd), layout
(B, N, H, D), f32 output and f32 gradients.  ``bf16=True`` is the JAX
kernels' bf16 mode: q, k, v (and the upstream gradient) are stored as bf16;
the forward rounds the unnormalized probabilities ``e = exp(s - rowmax)``
to bf16 for the ``e @ v`` product, the backward rounds the normalized
softmax ``z`` (for dV) and ``dl = z (dz - sum dz z)`` (for dQ, dK); row
statistics and every accumulation stay f32.
"""

from __future__ import annotations

import torch

from . import LAUNCHES, check, library, require_cuda_tensors, stream_ptr

MAX_KV = 8192
KERNEL_HEAD_DIMS = (32,)          # the matcher's coarse head_dim


def _bf16_round(t):
    return t.to(torch.bfloat16).to(torch.float32)


def attention_plain(qs, k, v, bf16: bool = False):
    """Plain version: head-first softmax attention, f32 or the bf16 mode."""
    if not bf16:
        logits = torch.einsum("blhd,bshd->bhls", qs, k)
        return torch.einsum("bhls,bshd->blhd", torch.softmax(logits, dim=-1), v)
    rnd = _bf16_round
    logits = torch.einsum("blhd,bshd->bhls", rnd(qs), rnd(k))
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    out = torch.einsum("bhls,bshd->bhld", rnd(e), rnd(v)) / e.sum(-1, keepdim=True)
    return out.transpose(1, 2)


def attention_bwd_plain(qs, k, v, g, bf16: bool = False):
    """Plain backward (``_attn_bwd_xla`` with the bf16 mode's roundings of
    ``_attn_bwd_kernel``) -> (dq, dk, dv), f32."""
    rnd = _bf16_round if bf16 else (lambda t: t)
    qs, k, v, g = (rnd(t.float()) for t in (qs, k, v, g))
    z = torch.softmax(torch.einsum("blhd,bshd->bhls", qs, k), dim=-1)
    dz = torch.einsum("blhd,bshd->bhls", g, v)
    dl = rnd(z * (dz - (dz * z).sum(-1, keepdim=True)))
    dq = torch.einsum("bhls,bshd->blhd", dl, k)
    dk = torch.einsum("bhls,blhd->bshd", dl, qs)
    dv = torch.einsum("bhls,blhd->bshd", rnd(z), g)
    return dq, dk, dv


def fused_attention_available(q, k) -> bool:
    """Size gate of the JAX package's ``fused_attention_available`` (KV fits,
    real workload, head_dim <= 128), without its backend test."""
    s = k.shape[1]
    sp = -(-s // 128) * 128
    return sp <= MAX_KV and q.shape[1] * s >= 256 * 256 and q.shape[-1] <= 128


def _check_shapes(name, qs, k, v):
    B, L, H, D = qs.shape
    S = k.shape[1]
    if k.shape != (B, S, H, D) or v.shape != k.shape:
        raise ValueError(f"{name}: shapes {qs.shape} {k.shape} {v.shape}")
    if D not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"attention kernel head_dim {D} not in "
                                  f"{KERNEL_HEAD_DIMS} (ROADMAP: what "
                                  f"remains, attention widths)")
    return B, L, S, H, D


def _forward_kernel(qs, k, v, bf16):
    B, L, S, H, D = _check_shapes("fused_attention", qs, k, v)
    require_cuda_tensors("fused_attention", qs, k, v)
    out = torch.empty(B, L, H, D, device=qs.device, dtype=torch.float32)
    err = library().nm_attention_forward(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, L, S, H,
        D, int(bf16), stream_ptr(qs.device))
    check(err, "attention")
    LAUNCHES["attention"] += 1
    return out


def attention_bwd(qs, k, v, g, bf16: bool = False):
    """(dq, dk, dv) of ``fused_attention`` for the upstream gradient ``g``:
    the backward kernel on CUDA tensors, the plain version on CPU ones."""
    if qs.device.type != "cuda":
        return attention_bwd_plain(qs, k, v, g, bf16)
    B, L, S, H, D = _check_shapes("attention_bwd", qs, k, v)
    dt = torch.bfloat16 if bf16 else torch.float32
    qs, k, v, g = (t.to(dt).contiguous() for t in (qs, k, v, g))
    require_cuda_tensors("attention_bwd", qs, k, v, g)
    dev = qs.device
    dq = torch.empty(B, L, H, D, device=dev, dtype=torch.float32)
    dk = torch.empty(B, S, H, D, device=dev, dtype=torch.float32)
    dv = torch.empty_like(dk)
    stats = torch.empty(3, B * H, L, device=dev, dtype=torch.float32)
    err = library().nm_attention_backward(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), B, L, S, H, D,
        int(bf16), stream_ptr(dev))
    check(err, "attention_bwd")
    LAUNCHES["attention_bwd"] += 1
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    """Forward kernel; backward kernel on the saved operand-typed q, k, v."""

    @staticmethod
    def forward(ctx, qs, k, v, bf16):
        dt = torch.bfloat16 if bf16 else torch.float32
        qs, k, v = (t.to(dt).contiguous() for t in (qs, k, v))
        ctx.save_for_backward(qs, k, v)
        ctx.bf16 = bf16
        return _forward_kernel(qs, k, v, bf16)

    @staticmethod
    def backward(ctx, g):
        qs, k, v = ctx.saved_tensors
        dq, dk, dv = attention_bwd(qs, k, v, g, ctx.bf16)
        return dq, dk, dv, None


def fused_attention(qs, k, v, bf16: bool = False):
    """(B, L, H, D) pre-scaled q, (B, S, H, D) k/v -> (B, L, H, D) f32.

    CPU tensors take the plain version (autograd runs through it); CUDA
    tensors launch the forward kernel, and the backward kernel when a
    gradient is needed."""
    if qs.device.type != "cuda":
        return attention_plain(qs, k, v, bf16)
    return _FusedAttention.apply(qs, k, v, bool(bf16))
