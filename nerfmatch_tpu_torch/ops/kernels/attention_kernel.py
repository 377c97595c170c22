"""Multi-head softmax attention forward: CUDA kernel wrapper and plain version.

Replaces ``nerfmatch_tpu/ops/pallas/attention_kernel.py: _fused_fwd``
(``_attn_kernel``) with ``csrc/attention.cu``: non-causal, unmasked
``softmax(qs k^T) v`` with ``qs`` pre-scaled by the caller, layout
(B, N, H, D), f32 output.  ``bf16=True`` is the JAX kernel's bf16 mode:
q, k and v are stored as bf16, and the unnormalized probabilities
``e = exp(s - rowmax)`` are rounded to bf16 for the ``e @ v`` product;
the row maxima, the sums of ``e`` and every accumulation stay f32.  There
is no backward kernel yet: a CUDA call that needs gradients raises.
"""

from __future__ import annotations

import torch

from . import LAUNCHES, check, library, require_cuda_tensors, stream_ptr

MAX_KV = 8192
KERNEL_HEAD_DIMS = (32,)          # the matcher's coarse head_dim


def attention_plain(qs, k, v, bf16: bool = False):
    """Plain version: head-first softmax attention, f32 or the bf16 mode."""
    if not bf16:
        logits = torch.einsum("blhd,bshd->bhls", qs, k)
        return torch.einsum("bhls,bshd->blhd", torch.softmax(logits, dim=-1), v)
    rnd = lambda t: t.to(torch.bfloat16).to(torch.float32)
    logits = torch.einsum("blhd,bshd->bhls", rnd(qs), rnd(k))
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    out = torch.einsum("bhls,bshd->bhld", rnd(e), rnd(v)) / e.sum(-1, keepdim=True)
    return out.transpose(1, 2)


def fused_attention_available(q, k) -> bool:
    """Size gate of the JAX package's ``fused_attention_available`` (KV fits,
    real workload, head_dim <= 128), without its backend test."""
    s = k.shape[1]
    sp = -(-s // 128) * 128
    return sp <= MAX_KV and q.shape[1] * s >= 256 * 256 and q.shape[-1] <= 128


def fused_attention(qs, k, v, bf16: bool = False):
    """(B, L, H, D) pre-scaled q, (B, S, H, D) k/v -> (B, L, H, D) f32."""
    if qs.device.type != "cuda":
        return attention_plain(qs, k, v, bf16)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (qs, k, v)):
        raise RuntimeError("attention kernel has no backward yet (ROADMAP "
                           "kernel 4): call under torch.no_grad()")
    B, L, H, D = qs.shape
    S = k.shape[1]
    if k.shape != (B, S, H, D) or v.shape != k.shape:
        raise ValueError(f"fused_attention: shapes {qs.shape} {k.shape} "
                         f"{v.shape}")
    if D not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"attention kernel head_dim {D} not in "
                                  f"{KERNEL_HEAD_DIMS}")
    dt = torch.bfloat16 if bf16 else torch.float32
    qs, k, v = (t.to(dt).contiguous() for t in (qs, k, v))
    require_cuda_tensors("fused_attention", qs, k, v)
    out = torch.empty(B, L, H, D, device=qs.device, dtype=torch.float32)
    err = library().nm_attention_forward(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, L, S, H,
        D, int(bf16), stream_ptr(qs.device))
    check(err, "attention")
    LAUNCHES["attention"] += 1
    return out
