"""Host-side image helpers of the NeRF evaluator (counterpart of
``nerfmatch_tpu/utils/images.py``): 8-bit conversion, depth colorization,
and depth maps stored as 8-bit PNGs.  PNGs are written and read with PIL."""

from __future__ import annotations

import numpy as np
from PIL import Image


def img2int8(img):
    """An RGB image in [0, 1] -> uint8 (values outside clipped)."""
    img = np.asarray(img)[..., :3]
    return (255 * np.clip(img, 0, 1)).astype(np.uint8)


def colorize_depth(depth):
    """Depth map -> (H, W, 3) uint8 image on the jet colormap over its
    min..max range (within one step of OpenCV's ``COLORMAP_JET``, which the
    JAX package takes where OpenCV is installed)."""
    depth = np.nan_to_num(np.asarray(depth, np.float64))
    lo, hi = depth.min(), depth.max()
    d8 = (255 * np.clip((depth - lo) / max(hi - lo, 1e-8), 0, 1)).astype(np.uint8)
    x = d8.astype(np.float64)[..., None] / 255.0
    jet = np.clip(1.5 - np.abs(4.0 * x - np.array([3.0, 2.0, 1.0])), 0, 1)
    return np.round(255 * jet).astype(np.uint8)


def depth2img(depth, max_val):
    """Depth -> uint8 image, 255 at depth 0 and 0 at ``max_val``."""
    depth = np.asarray(depth).squeeze()
    return (255 - depth / max_val * 255).astype(np.uint8)


def img2depth(depth_img, max_val, bg_val: float = 0.0, bg_mask=None):
    """Inverse of :func:`depth2img` (first channel of an RGB image);
    ``bg_mask`` False pixels take ``bg_val``."""
    if isinstance(depth_img, Image.Image):
        depth_img = np.array(depth_img)
    if depth_img.ndim > 2:
        depth_img = depth_img[..., 0]
    depth = max_val * ((255 - depth_img) / 255)
    if bg_mask is not None:
        depth[~bg_mask] = bg_val
    return depth


def save_depth_as_img(path, raw_depth, max_val=None):
    """A depth map as a PNG: :func:`depth2img` with ``max_val``, else
    :func:`colorize_depth`."""
    depth = depth2img(raw_depth, max_val) if max_val else colorize_depth(raw_depth)
    Image.fromarray(depth).save(path)


def load_depth_from_img(depth_path, max_val, img_wh=None, bg_val: float = 0.0,
                        bg_mask=None):
    """A :func:`save_depth_as_img` PNG (``max_val`` mode) -> depth, resized
    to ``img_wh`` with LANCZOS first when given."""
    depth = Image.open(depth_path)
    if img_wh:
        depth = depth.resize(tuple(img_wh), Image.LANCZOS)
    return img2depth(depth, max_val, bg_val=bg_val, bg_mask=bg_mask)
