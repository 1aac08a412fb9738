"""Raster utilities for the layout scene compiler (host side, NumPy/SciPy).

TPU-native re-design of the reference raster layer (image.c):
pixel data is a uint32 [H, W] NumPy array in the same packed-RGBA word format
the reference uses (0xAABBGGRR over little-endian RGBA bytes, image.c:189-199),
but the BFS-based distance transform (image.c:88-142) and flood fill
(image.c:144-179) become vectorized SciPy/NumPy ops with identical results.

Copy of flatmatch_tpu/scene/image.py without its optional C++ raster
accelerator (flatmatch_tpu/native): the NumPy/SciPy path gives the same
results.
"""
from __future__ import annotations

import numpy as np
from PIL import Image as PILImage
from scipy import ndimage

# Packed pixel classes (parseLayout.c:15-24). The words read as
# 0xFF000000 | R | G<<8 | B<<16 (image.c:196).
INVALIDATED = 0x00000000
WALL = 0xFF000000
EMPTY = 0xFFFFFFFF
OUTSIDE = 0xFF7F7F7F
DOOR = 0xFFDFDFDF
WINDOW = 0xFF00FF00
BALCONY_WINDOW = 0xFFFF7F00
BALCONY_DOOR = 0xFFFF0000

_EIGHT = np.ones((3, 3), bool)


def load_layout(path: str) -> np.ndarray:
    """Load a layout PNG into a packed uint32 [H, W] array (image.c:210-227)."""
    img = PILImage.open(path).convert("RGBA")
    rgba = np.asarray(img, dtype=np.uint32)  # [H, W, 4] R,G,B,A
    packed = (
        rgba[..., 0]
        | (rgba[..., 1] << 8)
        | (rgba[..., 2] << 16)
        | np.uint32(0xFF000000)  # reference promotes RGB with alpha=0xFF
    )
    return packed.astype(np.uint32)


def save_image(packed: np.ndarray, path: str) -> None:
    """Write a packed uint32 image as RGBA PNG (image.c:181-184)."""
    h, w = packed.shape
    rgba = np.empty((h, w, 4), np.uint8)
    rgba[..., 0] = packed & 0xFF
    rgba[..., 1] = (packed >> 8) & 0xFF
    rgba[..., 2] = (packed >> 16) & 0xFF
    rgba[..., 3] = (packed >> 24) & 0xFF
    PILImage.fromarray(rgba, "RGBA").save(path)


def get_pixel(img: np.ndarray, x: int, y: int):
    """Clamped pixel read (image.c:61-66)."""
    h, w = img.shape
    return img[min(max(y, 0), h - 1), min(max(x, 0), w - 1)]


def distance_transform(mask: np.ndarray) -> tuple[np.ndarray, int]:
    """Chebyshev (8-neighbor) BFS distance transform (image.c:88-142).

    Input: array with nonzero = seed ("wall"), 0 = free space. Returns the
    transformed array where seeds keep value 1, free pixels get
    1 + chebyshev-distance-to-nearest-seed, and the maximum value — exactly
    the reference's in-place result and return value (image.c:140 returns the
    max assigned distance).
    """
    seeds = mask != 0
    if not seeds.any():
        return np.zeros_like(mask, dtype=np.int64), 0
    dist = ndimage.distance_transform_cdt(~seeds, metric="chessboard")
    out = dist.astype(np.int64) + 1
    out[seeds] = 1
    return out, int(out.max())


def flood_fill(img: np.ndarray, x: int, y: int, value: int, background: int) -> None:
    """8-connected flood fill, in place (image.c:144-179)."""
    h, w = img.shape
    if not (0 <= x < w and 0 <= y < h):
        return
    if img[y, x] != background:
        return
    bg = img == background
    labels, _ = ndimage.label(bg, structure=_EIGHT)
    img[labels == labels[y, x]] = np.uint32(value)


def dilate_mask(mask: np.ndarray, radius: int) -> np.ndarray:
    """Square (Chebyshev) dilation of a boolean mask by `radius` pixels
    (parseLayout.c:571-594 dilates the impassable area with a full
    (2r+1)x(2r+1) square kernel)."""
    k = np.ones((2 * radius + 1, 2 * radius + 1), bool)
    return ndimage.binary_dilation(mask, structure=k)
