"""Fused StarReLU + 7x7 depthwise convolution (the ConvFormer token mixer's
core): CUDA kernel wrappers, plain versions and the autograd Function.

Replaces ``nerfmatch_tpu/ops/pallas/sepconv_kernel.py``: ``_dw_star_fwd``
(kernel 7), ``_dw_star_dgrad`` (kernel 8) and ``_dw_star_wgrad`` (kernel 9)
behind ``dw_star``, with ``csrc/sepconv.cu``.  Semantics of
``dw_star(x, w, cbias, s, b)``: ``y = dwconv(s * relu(x)^2 + b, w) + cbias``
with SAME zero padding applied *after* the activation; x (B, H, W, C) NHWC,
w (K, K, C), cbias (C,), s and b scalar tensors; f32 throughout.  The
backward recomputes the activation from the saved pre-activation x: dgrad
gives dx, ds, db, wgrad gives dw, and the conv-bias gradient is the plain
sum of g (the JAX package leaves it to XLA too).
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.nn import functional as F

from . import LAUNCHES, check, library, require_cuda_tensors, stream_ptr

KERNEL_TAPS = 7                 # every ConvFormer token mixer is 7 x 7
CHANNEL_BLOCK = 128
TILE_CHANNELS = 32              # a tile's channels: kernel 9's partials rows


def _row_block(H: int, K: int) -> int | None:
    """The JAX kernels' row block: the largest divisor of H in [K-1, 32]."""
    for th in range(min(H, 32), K - 2, -1):
        if H % th == 0 and th >= K - 1:
            return th
    return None


def dw_star_available(x, w) -> bool:
    """The JAX package's ``dw_star_available`` gate without its backend
    test, so both packages route the same shapes through the fused op."""
    _, H, W, C = x.shape
    K = w.shape[0]
    return C % 128 == 0 and W >= K and _row_block(H, K) is not None


def star_relu(x, s, b):
    r = torch.relu(x)
    return s * r * r + b


def dw_star_plain(x, w, cbias, s, b):
    """Plain version: StarReLU, then a grouped ``F.conv2d`` (zero padding of
    the activated map), NHWC in and out."""
    K, C = w.shape[0], w.shape[-1]
    act = star_relu(x, s, b).permute(0, 3, 1, 2)
    y = F.conv2d(act, w.permute(2, 0, 1).unsqueeze(1), cbias, padding=K // 2,
                 groups=C)
    return y.permute(0, 2, 3, 1)


def dw_star_dgrad_plain(x, w, s, g):
    """(dx, ds, db): dact = g correlated with the flipped taps, then
    dx = 2 s relu(x) dact, ds = sum dact relu(x)^2, db = sum dact."""
    K, C = w.shape[0], w.shape[-1]
    wf = torch.flip(w, (0, 1)).permute(2, 0, 1).unsqueeze(1)
    dact = F.conv2d(g.permute(0, 3, 1, 2), wf, padding=K // 2,
                    groups=C).permute(0, 2, 3, 1)
    r = torch.relu(x)
    return 2.0 * s * r * dact, (dact * r * r).sum(), dact.sum()


def dw_star_wgrad_plain(x, s, b, g, K: int = 7):
    """dw[dy, dx, c] = sum_{b,h,w} g[b, h, w, c] act[b, h + dy - P,
    w + dx - P, c], with act zero outside the image."""
    _, H, W, _ = g.shape
    P = K // 2
    act = F.pad(star_relu(x, s, b), (0, 0, P, P, P, P))
    return torch.stack([torch.stack([
        (g * act[:, dy:dy + H, dx:dx + W]).sum((0, 1, 2)) for dx in range(K)])
        for dy in range(K)])


def _check(name, x, K, C):
    if K != KERNEL_TAPS:
        raise NotImplementedError(f"{name}: kernel size {K}, the kernels "
                                  f"take {KERNEL_TAPS} only (ROADMAP: what "
                                  f"remains, item 9)")
    if C % CHANNEL_BLOCK:
        raise NotImplementedError(f"{name}: channels {C} not a multiple of "
                                  f"{CHANNEL_BLOCK} (ROADMAP: what remains, "
                                  f"item 9)")
    if x.dtype != torch.float32:
        raise ValueError(f"{name}: float32 inputs only, got {x.dtype}")


def _aligned(t):
    """``t`` contiguous and starting on a 16-byte boundary: the tile kernels
    read x, g and w through TMA tensor maps, whose base addresses must be;
    a view that does not (an offset into a larger buffer) is copied into a
    fresh one, which the allocator aligns.  The JAX ``dw_star`` takes any
    array."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _scalar(t, dev):
    """A float32 device scalar (the tensor itself when it is one)."""
    return torch.as_tensor(t, dtype=torch.float32, device=dev).detach()


def dw_star_fwd(x, w, cbias, s, b):
    """Kernel 7 on CUDA tensors -> y (B, H, W, C)."""
    B, H, W, C = x.shape
    K = w.shape[0]
    _check("dw_star_fwd", x, K, C)
    x, w, cbias = _aligned(x), _aligned(w), cbias.contiguous()
    s, b = _scalar(s, x.device), _scalar(b, x.device)
    require_cuda_tensors("dw_star_fwd", x, w, cbias, s, b)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = library().nm_dw_star_forward(
            x.data_ptr(), w.data_ptr(), cbias.data_ptr(), s.data_ptr(),
            b.data_ptr(), y.data_ptr(), B, H, W, C, K, stream_ptr(x.device))
    check(err, "dw_star_fwd")
    LAUNCHES["dw_star_fwd"] += 1
    return y


@functools.lru_cache(maxsize=None)
def dw_star_dgrad_parts(device: int, B: int, H: int, W: int, C: int) -> int:
    """Rows of kernel 8's [ds, db] partials for this shape on CUDA device
    ``device``: its persistent grid, as the C side computes it (asked once
    per device and shape; the kernel launches one block a row)."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        check(library().nm_dw_star_dgrad_parts(B, H, W, C, ctypes.byref(n)),
              "dw_star_dgrad_parts")
    return n.value


def dw_star_dgrad(x, w, s, g):
    """Kernel 8 on CUDA tensors -> (dx, ds, db); ds and db are fixed-order
    sums of per-block partials (no atomics)."""
    B, H, W, C = x.shape
    K = w.shape[0]
    _check("dw_star_dgrad", x, K, C)
    x, w, g = _aligned(x), _aligned(w), _aligned(g)
    s = _scalar(s, x.device)
    require_cuda_tensors("dw_star_dgrad", x, w, g, s)
    dx = torch.empty_like(x)
    parts = dw_star_dgrad_parts(x.device.index, B, H, W, C)
    part = torch.empty(parts, 2, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = library().nm_dw_star_dgrad(
            x.data_ptr(), g.data_ptr(), w.data_ptr(), s.data_ptr(),
            dx.data_ptr(), part.data_ptr(), parts, B, H, W, C, K,
            stream_ptr(x.device))
    check(err, "dw_star_dgrad")
    LAUNCHES["dw_star_dgrad"] += 1
    dsb = part.sum(0)
    return dx, dsb[0], dsb[1]


@functools.lru_cache(maxsize=None)
def dw_star_wgrad_parts(device: int, B: int, H: int, W: int, C: int) -> int:
    """Rows of kernel 9's tap-sum partials for this shape on CUDA device
    ``device``: its persistent grid, a multiple of the channel groups (asked
    once per device and shape; the kernel launches one block a row)."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        check(library().nm_dw_star_wgrad_parts(B, H, W, C, ctypes.byref(n)),
              "dw_star_wgrad_parts")
    return n.value


def dw_star_wgrad(x, s, b, g, K: int = 7):
    """Kernel 9 on CUDA tensors -> dw (K, K, C): per-block tap sums over a
    persistent walk, summed per channel group in a fixed order by the
    kernel's second launch (no atomics)."""
    B, H, W, C = x.shape
    _check("dw_star_wgrad", x, K, C)
    x, g = _aligned(x), _aligned(g)
    s, b = _scalar(s, x.device), _scalar(b, x.device)
    require_cuda_tensors("dw_star_wgrad", x, g, s, b)
    parts = dw_star_wgrad_parts(x.device.index, B, H, W, C)
    part = torch.empty(parts, K * K, TILE_CHANNELS, device=x.device,
                       dtype=torch.float32)
    dw = torch.empty(K, K, C, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = library().nm_dw_star_wgrad(
            x.data_ptr(), g.data_ptr(), s.data_ptr(), b.data_ptr(),
            dw.data_ptr(), part.data_ptr(), parts, B, H, W, C, K,
            stream_ptr(x.device))
    check(err, "dw_star_wgrad")
    LAUNCHES["dw_star_wgrad"] += 1
    return dw


class _DwStar(torch.autograd.Function):
    """Kernel 7 forward; kernels 8 and 9 backward from the saved
    pre-activation x, w, s and b."""

    @staticmethod
    def forward(ctx, x, w, cbias, s, b):
        ctx.save_for_backward(x, w, s, b)
        return dw_star_fwd(x, w, cbias, s, b)

    @staticmethod
    def backward(ctx, g):
        x, w, s, b = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx = ds = db = dw = dcb = None
        if need[0] or need[3] or need[4]:
            dx, ds, db = dw_star_dgrad(x, w, s, g)
            ds, db = ds.reshape(s.shape), db.reshape(b.shape)
        if need[1]:
            dw = dw_star_wgrad(x, s, b, g, K=w.shape[0])
        if need[2]:
            dcb = g.sum((0, 1, 2))
        return dx, dw, dcb, ds, db


def dw_star(x, w, cbias, s, b):
    """StarReLU + depthwise conv: the kernels on CUDA tensors (forward 7,
    backward 8 and 9), the plain version (with autograd) on CPU tensors."""
    if x.device.type != "cuda":
        return dw_star_plain(x, w, cbias, s, b)
    return _DwStar.apply(x, w, cbias, s, b)
