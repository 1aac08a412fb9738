"""Tone mapping + 8-bit conversion (host side, NumPy).

Mirrors the reference export math:
  - luminance tone curve 1 - exp(-2 L) with per-channel luminance rescale
    (convert/convert2, rectangle.c:263-284)
  - clamped float -> uint8 truncation (rectangle.c:286-291)
  - floor post-tint for horizontal rects at z == 0, applied on the uint8
    data, doubled when `tint_extra` is set (AO / native / radiosity modes,
    rectangle.c:314-334, main.c:88-91)
"""
from __future__ import annotations

import numpy as np

f32 = np.float32

_LUMA = np.array([0.2126, 0.7152, 0.0722], np.float64)  # rectangle.c:277


def convert_luminance(lum: np.ndarray) -> np.ndarray:
    """Perceptual brightness curve (rectangle.c:263-271)."""
    return 1.0 - np.exp(-2.0 * lum)


def tone_map(texels: np.ndarray) -> np.ndarray:
    """convert2 over [T,3] float32 radiance -> [T,3] float32 (rectangle.c:274-284).

    Zero-radiance texels divide 0/0 in the reference (NaN, truncating to 0 on
    export); here they map to exact 0.
    """
    t = texels.astype(np.float64)
    lum = t @ _LUMA
    lum_p = convert_luminance(lum)
    with np.errstate(invalid="ignore", divide="ignore"):
        scale = np.where(lum > 0, lum_p / np.where(lum == 0, 1, lum), 0.0)
    return (t * scale[:, None]).astype(f32)


def to_uint8(rgb: np.ndarray) -> np.ndarray:
    """clamp(color*255) with trunc-toward-zero (rectangle.c:286-309)."""
    v = rgb.astype(np.float64) * 255.0
    v = np.clip(v, 0.0, 255.0)
    return v.astype(np.uint8)


def is_floor_rect(pos, wvec, hvec) -> bool:
    """Horizontal rect lying at z == 0 (rectangle.c:317)."""
    return float(pos[2]) == 0.0 and float(wvec[2]) == 0.0 and float(hvec[2]) == 0.0


def apply_floor_tint(data: np.ndarray, tint_extra: bool) -> np.ndarray:
    """Brownish floor post-tint on uint8 RGB rows (rectangle.c:317-334).

    Applied after tone mapping so the brown does not bleed through the GI
    (comment at rectangle.c:314-316). uint8 *= float truncates in C; mirror
    that exactly.
    """
    out = data.astype(np.float64)
    out[:, 1] *= 0.95
    out[:, 2] *= 0.9
    out = out.astype(np.uint8)
    if tint_extra:
        ext = out.astype(np.float64)
        ext[:, 1] *= f32(0.95)
        ext[:, 2] *= f32(0.9)
        out = ext.astype(np.uint8)
    return out
