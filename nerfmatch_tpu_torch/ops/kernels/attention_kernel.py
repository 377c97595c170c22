"""Multi-head softmax attention, forward and backward: CUDA kernel wrappers
and plain versions.

Replaces ``nerfmatch_tpu/ops/pallas/attention_kernel.py: _fused_fwd``
(``_attn_kernel``) and ``_fused_bwd`` (``_attn_bwd_kernel``) with
``csrc/attention.cu``: non-causal, unmasked ``softmax(qs k^T) v`` with
``qs`` pre-scaled by the caller (the learned LSA scale and ``1/sqrt(d)``
stay outside, so their gradients flow through plain autograd), layout
(B, N, H, D), f32 output and f32 gradients.  ``bf16=True`` is the JAX
kernels' bf16 mode: q, k, v (and the upstream gradient) are stored as bf16;
the forward rounds the unnormalized probabilities to bf16 for the ``e @ v``
product (``e = exp(s - rowmax)`` in the plain version,
``2^(s log2 e - ceil(rowmax log2 e))`` in the one-pass kernel: the same
rounding point, another scale), the backward rounds the normalized
softmax ``z`` (for dV) and ``dl = z (dz - sum dz z)`` (for dQ, dK); row
statistics and every accumulation stay f32.

The forward kernel passes over the keys once and, when a gradient is
needed, also returns the row statistic ``lse = rowmax + log(rowsum e)`` as
(B * H, L) f32.  The backward takes ``z = exp(s - lse)`` from it and
``delta = sum_s dz z`` as ``rowsum(g * out)``: a small prologue launch,
then dK/dV and dQ, no statistics pass and no atomics.
:func:`attention_onepass_plain` and :func:`attention_bwd_stats_plain` are
those two algorithms in plain torch, at any head_dim.

The kernels take every head_dim D from 1 to 128, the JAX kernel's range:
both modes run at the smallest instantiated width :func:`kernel_head_dim`
(16, 32, 64 or 128) on columns that are zero only on the card, and write D
columns back; D above 128 raises, as the JAX gate refuses it.  bf16
operands are rows of ``D`` rounded up to a multiple of 8
(:func:`operand_width`): bf16 inputs of such a D go in as they are, all
others are cast into a workspace of that width.

The f32 mode (``bf16=False``) keeps f32 accuracy on the tensor cores in
three TF32 passes: a split launch writes each operand as ``big =
tf32(x)`` and ``small = tf32(x - big)`` (round to nearest, into a
workspace of :func:`tf32_workspace_floats`), and every product ``A B``
runs as ``As Bb + Ab Bs + Ab Bb``.  :func:`attention_tf32_plain` and
:func:`attention_bwd_tf32_plain` are that arithmetic in plain torch, for
the tests (``passes=1``: one TF32 product, which the tolerances refuse).
"""

from __future__ import annotations

import math

import torch

from . import LAUNCHES, check, library, require_cuda_tensors, stream_ptr

KERNEL_HEAD_DIMS = (16, 32, 64, 128)   # the kernels' instantiations
MAX_HEAD_DIM = KERNEL_HEAD_DIMS[-1]    # the JAX kernel's gate, head_dim <= 128
KEY_TILE = 64                     # keys per tile of the bf16 kernels' loops
IMAGE_ROWS = 64                   # f32 mode: image rows padded to this
LOG2E = math.log2(math.e)


def kernel_head_dim(D: int) -> int:
    """The instantiated width a head_dim runs at on the card: the smallest
    of :data:`KERNEL_HEAD_DIMS` that holds ``D``; above 128 (the JAX gate's
    limit) ``NotImplementedError``."""
    if D < 1:
        raise ValueError(f"attention head_dim {D}")
    for width in KERNEL_HEAD_DIMS:
        if D <= width:
            return width
    raise NotImplementedError(f"attention kernel head_dim {D} > "
                              f"{MAX_HEAD_DIM}, the JAX kernel's limit")


def operand_width(D: int) -> int:
    """Row width of the kernels' bf16 operands: ``D`` rounded up to 8
    elements (16 bytes, one copy)."""
    return -(-D // 8) * 8


def tf32_workspace_floats(B, L, S, H, D, backward: bool) -> int:
    """Floats of the f32 mode's TF32 images (``csrc/attention.cu``, big and
    small each, rows padded to :data:`IMAGE_ROWS`, columns to
    :func:`kernel_head_dim`): the forward's q and k rows and v transposed;
    the backward's q, g and k rows and transposes and v rows."""
    kD = kernel_head_dim(D)
    Lp, Sp = (-(-n // IMAGE_ROWS) * IMAGE_ROWS for n in (L, S))
    return B * H * kD * (8 * Lp + 6 * Sp if backward else 2 * Lp + 4 * Sp)


def _bf16_round(t):
    return t.to(torch.bfloat16).to(torch.float32)


def tf32_round(t):
    """The TF32 value nearest each element (ties away from zero), by bit
    masking: the low 13 of the 23 fraction bits cleared after adding half
    of the last bit kept, as the kernels' ``tf32_rna``."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(t):
    """``t = big + small`` in TF32 values, both rounded to nearest."""
    big = tf32_round(t)
    return big, tf32_round(t - big)


def tf32_product(eq, a, b, passes: int = 3):
    """``einsum(eq, a, b)`` as the f32 mode's tensor cores form it: three
    TF32 products ``As Bb + Ab Bs + Ab Bb`` (``passes=3``), or one of the
    rounded operands (``passes=1``).  TF32 products are exact in f32."""
    if passes == 1:
        return torch.einsum(eq, tf32_round(a), tf32_round(b))
    (ab, as_), (bb, bs) = tf32_split(a), tf32_split(b)
    return (torch.einsum(eq, as_, bb) + torch.einsum(eq, ab, bs)
            + torch.einsum(eq, ab, bb))


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


def attention_onepass_plain(qs, k, v, bf16: bool = True, tile: int = KEY_TILE):
    """The forward kernel's algorithm, key tile by key tile -> (out, lse).

    In base 2 (``x = s log2 e``) the running reference of each row is its
    maximum so far rounded up to an integer, ``r = ceil(max x)``, so every
    rescale of the accumulator and the row sum between tiles is an exact
    power of two and the result does not depend on the tiling.  The bf16
    mode rounds ``e' = 2^(x - r)`` where the two-pass
    :func:`attention_plain` rounds ``exp(s - rowmax)``: their ratio
    ``2^(max x - r)`` lies in (1/2, 1] and is no power of two, so the two
    roundings fall independently (each within 2^-8 relative).
    ``lse = (r + log2(sum e')) ln 2``, (B * H, L)."""
    rnd = _bf16_round if bf16 else (lambda t: t)
    q, k, v = (rnd(t.float()) for t in (qs, k, v))
    B, L, H, D = q.shape
    r = torch.full((B, H, L, 1), -1e30, device=q.device)
    lsum = torch.zeros(B, H, L, 1, device=q.device)
    acc = torch.zeros(B, H, L, D, device=q.device)
    for s0 in range(0, k.shape[1], tile):
        s = torch.einsum("blhd,bshd->bhls", q, k[:, s0:s0 + tile])
        rn = torch.maximum(r, torch.ceil(s.amax(-1, keepdim=True) * LOG2E))
        scale = torch.exp2(torch.clamp(r - rn, min=-127.0))
        scale = torch.where(r - rn < -126.0, torch.zeros_like(scale), scale)
        e = torch.exp2(s * LOG2E - rn)
        lsum = lsum * scale + e.sum(-1, keepdim=True)
        acc = acc * scale + torch.einsum("bhls,bshd->bhld", rnd(e),
                                         v[:, s0:s0 + tile])
        r = rn
    lse = (r + torch.log2(lsum)) * math.log(2.0)
    return (acc / lsum).transpose(1, 2), lse.reshape(B * H, L)


def attention_tf32_plain(qs, k, v, passes: int = 3):
    """The f32-mode forward kernel's arithmetic -> (out, lse): the one-pass
    algorithm of :func:`attention_onepass_plain` with every product a
    :func:`tf32_product`, each tile's ``e' v`` formed alone and added to
    the running sum in f32, as the kernel does."""
    q, k, v = (t.float() for t in (qs, k, v))
    B, L, H, D = q.shape
    r = torch.full((B, H, L, 1), -1e30, device=q.device)
    lsum = torch.zeros(B, H, L, 1, device=q.device)
    acc = torch.zeros(B, H, L, D, device=q.device)
    for s0 in range(0, k.shape[1], KEY_TILE):
        s = tf32_product("blhd,bshd->bhls", q, k[:, s0:s0 + KEY_TILE], passes)
        rn = torch.maximum(r, torch.ceil(s.amax(-1, keepdim=True) * LOG2E))
        scale = torch.exp2(torch.clamp(r - rn, min=-127.0))
        scale = torch.where(r - rn < -126.0, torch.zeros_like(scale), scale)
        e = torch.exp2(s * LOG2E - rn)
        lsum = lsum * scale + e.sum(-1, keepdim=True)
        acc = acc * scale + tf32_product("bhls,bshd->bhld", e,
                                         v[:, s0:s0 + KEY_TILE], passes)
        r = rn
    lse = (r + torch.log2(lsum)) * math.log(2.0)
    return (acc / lsum).transpose(1, 2), lse.reshape(B * H, L)


def attention_bwd_tf32_plain(qs, k, v, g, out, lse, passes: int = 3):
    """The f32-mode backward kernels' arithmetic -> (dq, dk, dv): the
    formulas of :func:`attention_bwd_stats_plain` (f32) with every product
    a :func:`tf32_product`."""
    qs, k, v, g = (t.float() for t in (qs, k, v, g))
    B, L, H, _ = qs.shape
    z = torch.exp2(tf32_product("blhd,bshd->bhls", qs, k, passes) * LOG2E
                   - lse.reshape(B, H, L, 1) * LOG2E)
    dz = tf32_product("blhd,bshd->bhls", g, v, passes)
    delta = (g * out).sum(-1).permute(0, 2, 1).unsqueeze(-1)
    dl = z * (dz - delta)
    return (tf32_product("bhls,bshd->blhd", dl, k, passes),
            tf32_product("bhls,blhd->bshd", dl, qs, passes),
            tf32_product("bhls,blhd->bshd", z, g, passes))


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


def attention_bwd_stats_plain(qs, k, v, g, out, lse, bf16: bool = False):
    """The backward kernels' formulas in plain torch -> (dq, dk, dv): the
    softmax from the forward's ``lse`` (no maximum, no division) and
    ``delta = rowsum(g * out)`` with ``g`` rounded to the operand type."""
    rnd = _bf16_round if bf16 else (lambda t: t)
    qs, k, v, g = (rnd(t.float()) for t in (qs, k, v, g))
    B, L, H, _ = qs.shape
    z = torch.exp2((torch.einsum("blhd,bshd->bhls", qs, k)
                    - lse.reshape(B, H, L, 1)) * LOG2E)
    dz = torch.einsum("blhd,bshd->bhls", g, v)
    delta = (g * out).sum(-1).permute(0, 2, 1).unsqueeze(-1)
    dl = rnd(z * (dz - delta))
    dq = torch.einsum("bhls,bshd->blhd", dl, k)
    dk = torch.einsum("bhls,blhd->bshd", dl, qs)
    dv = torch.einsum("bhls,blhd->bshd", rnd(z), g)
    return dq, dk, dv


def fused_attention_available(q, k) -> bool:
    """Size gate of the JAX package's ``fused_attention_available`` (a real
    workload, head_dim <= 128), without its backend test and without its
    key limit: the JAX kernel holds every key in VMEM (S <= 8192), the CUDA
    kernels stream them in tiles, so the merged multi-pair clouds (S of
    10,000s) run on them too."""
    return (q.shape[1] * k.shape[1] >= 256 * 256
            and q.shape[-1] <= MAX_HEAD_DIM)


def _check_shapes(name, qs, k, v):
    B, L, H, D = qs.shape
    S = k.shape[1]
    if k.shape != (B, S, H, D) or v.shape != k.shape:
        raise ValueError(f"{name}: shapes {qs.shape} {k.shape} {v.shape}")
    kernel_head_dim(D)
    return B, L, S, H, D


def _as_kernel_input(t, dt):
    """``t`` as contiguous ``dt`` at a 16-byte address (the kernels load 16
    bytes at a time); a tensor that is one already is returned as it is,
    without the conversion calls (the wrappers' host time shows at small
    shapes and in host-bound training steps)."""
    if t.dtype != dt or not t.is_contiguous():
        t = t.to(dt).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _f32(t):
    return _as_kernel_input(t, torch.float32)


def _operands(tensors, bf16, width=None):
    """``tensors`` in the kernels' operand type (see
    :func:`_as_kernel_input`); with ``width``, bf16 rows of that many
    columns: a tensor with fewer (a direct backward call at a head_dim that
    is no multiple of 8) is copied into zeroed rows."""
    dt = torch.bfloat16 if bf16 else torch.float32
    out = []
    for t in tensors:
        if width is not None and t.shape[-1] != width:
            buf = torch.zeros(*t.shape[:-1], width, device=t.device, dtype=dt)
            buf[..., :t.shape[-1]] = t
            t = buf
        out.append(_as_kernel_input(t, dt))
    return out


def _forward_kernel(qs, k, v, bf16, want_lse):
    """The forward kernel -> (out, lse, operands).  ``lse`` and the
    operand-typed (q, k, v) are made only when ``want_lse`` (the backward
    takes them).  In bf16 mode q, k and v are cast by one launch inside the
    same call, into one workspace of rows of :func:`operand_width` (zeros
    past D), unless all three are bf16 already at a D that is a multiple
    of 8.  In f32 mode the split launch writes their TF32 images into a
    workspace the same way, and the operands handed on stay f32."""
    B, L, S, H, D = _check_shapes("fused_attention", qs, k, v)
    W = operand_width(D)
    dev = qs.device
    cast = None
    if bf16 and not (qs.dtype == k.dtype == v.dtype == torch.bfloat16
                     and W == D):
        qs, k, v = _f32(qs), _f32(k), _f32(v)
        cast = torch.empty((B * L + 2 * B * S) * H * W, device=dev,
                           dtype=torch.bfloat16)
    else:
        qs, k, v = _operands((qs, k, v), bf16)
        if not bf16:
            cast = torch.empty(tf32_workspace_floats(B, L, S, H, D, False),
                               device=dev, dtype=torch.float32)
    require_cuda_tensors("fused_attention", qs, k, v)
    out = torch.empty(B, L, H, D, device=dev, dtype=torch.float32)
    lse = (torch.empty(B * H, L, device=dev, dtype=torch.float32)
           if want_lse else None)
    with torch.cuda.device(dev):
        err = library().nm_attention_forward(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if want_lse else 0,
            cast.data_ptr() if cast is not None else 0, B, L, S, H, D,
            int(bf16), stream_ptr(dev))
    check(err, "attention")
    LAUNCHES["attention"] += 1
    if not want_lse:
        return out, None, None
    if bf16 and cast is not None:
        nq, nk = B * L * H * W, B * S * H * W
        qs = cast[:nq].view(B, L, H, W)
        k = cast[nq:nq + nk].view(B, S, H, W)
        v = cast[nq + nk:].view(B, S, H, W)
    return out, lse, (qs, k, v)


def attention_bwd(qs, k, v, g, bf16: bool = False, out=None, lse=None):
    """(dq, dk, dv) of ``fused_attention`` for the upstream gradient ``g``.

    ``out`` and ``lse`` are the forward's output and row statistic.  On
    CUDA tensors the backward kernels take them; given neither, the
    forward kernel runs first to make them.  In bf16 mode ``qs``, ``k`` and
    ``v`` may also be the forward's operands, bf16 rows of
    :func:`operand_width` (the workspace ``_FusedAttention`` saves), with
    ``g`` and ``out`` at the head_dim D.  CPU tensors take the plain
    versions: :func:`attention_bwd_stats_plain` when they are given,
    :func:`attention_bwd_plain` otherwise."""
    if (out is None) != (lse is None):
        raise ValueError("attention_bwd: pass both out and lse, or neither")
    if qs.device.type != "cuda":
        if out is None:
            return attention_bwd_plain(qs, k, v, g, bf16)
        return attention_bwd_stats_plain(qs, k, v, g, out, lse, bf16)
    D = g.shape[-1]
    kernel_head_dim(D)
    W = operand_width(D) if bf16 else D
    if out is None:
        _check_shapes("attention_bwd", qs, k, v)
        out, lse, (qs, k, v) = _forward_kernel(qs, k, v, bf16, want_lse=True)
    else:
        qs, k, v = _operands((qs, k, v), bf16, W if bf16 else None)
    B, L, H, _ = g.shape
    S = k.shape[1]
    if qs.shape != (B, L, H, W) or k.shape != (B, S, H, W) \
            or v.shape != k.shape or out.shape != g.shape:
        raise ValueError(f"attention_bwd: shapes {qs.shape} {k.shape} "
                         f"{v.shape} {g.shape} {out.shape}")
    g, out, lse = _f32(g), _f32(out), _f32(lse)
    require_cuda_tensors("attention_bwd", qs, k, v, g, out, lse)
    dev = qs.device
    dq = torch.empty(B, L, H, D, device=dev, dtype=torch.float32)
    dk = torch.empty(B, S, H, D, device=dev, dtype=torch.float32)
    dv = torch.empty_like(dk)
    g_cast = (torch.empty(B, L, H, W, device=dev, dtype=torch.bfloat16)
              if bf16 else torch.empty(
                  tf32_workspace_floats(B, L, S, H, D, True), device=dev,
                  dtype=torch.float32))
    stats = torch.empty(2, B * H, L, device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        err = library().nm_attention_backward(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            out.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), g_cast.data_ptr(),
            stats.data_ptr(), B, L, S, H, D, int(bf16), stream_ptr(dev))
    check(err, "attention_bwd")
    LAUNCHES["attention_bwd"] += 1
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    """Forward kernel with ``lse``; the backward kernels run on the saved
    operand-typed q, k, v, the output and ``lse``."""

    @staticmethod
    def forward(ctx, qs, k, v, bf16):
        out, lse, operands = _forward_kernel(qs, k, v, bf16, want_lse=True)
        ctx.save_for_backward(*operands, out, lse)
        ctx.bf16 = bf16
        return out

    @staticmethod
    def backward(ctx, g):
        qs, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(qs, k, v, g, ctx.bf16, out=out, lse=lse)
        return dq, dk, dv, None


def fused_attention(qs, k, v, bf16: bool = False):
    """(B, L, H, D) pre-scaled q, (B, S, H, D) k/v -> (B, L, H, D) f32.

    CPU tensors take the plain version (autograd runs through it); CUDA
    tensors launch the forward kernel, which also emits ``lse`` for the
    backward kernels when a gradient is needed.  Any ``D`` up to 128 runs
    on the kernels (the e2e matcher's 8 heads of 8 at the 16-wide
    instantiation); above it ``NotImplementedError``."""
    if qs.device.type != "cuda":
        return attention_plain(qs, k, v, bf16)
    if torch.is_grad_enabled() and (qs.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FusedAttention.apply(qs, k, v, bool(bf16))
    return _forward_kernel(qs, k, v, bool(bf16), want_lse=False)[0]
