"""Lightmap tile export (host side).

Reproduces the reference per-wall PNG export path: saveAs
(rectangle.c:293-346) — tone map, uint8 conversion, floor
post-tint — plus the raw float32 dump with TileMetadata header
(rectangle.c:391-429), which the reference keeps as its only
checkpoint-adjacent artifact (SURVEY.md §5).
"""
from __future__ import annotations

import pathlib
import struct
from typing import Sequence

import numpy as np
from PIL import Image as PILImage

from ..ops import tonemap
from ..scene.rectangle import Rect, num_tiles


def seam_dilate(rgb: np.ndarray) -> np.ndarray:
    """Fill the dark fringe at lit/unlit lightmap boundaries: every pixel
    with at least one black AND one non-black 8-neighbor takes the
    brightest pixel of its 3x3 neighborhood.

    Vectorized re-design of the dilation the reference prototyped but
    never shipped (the dead imageProcessing.c:100-143 `selectiveDilate`,
    #error'd out at imageProcessing.c:1): without it, bilinear texture
    filtering in the WebGL viewer bleeds the never-lit texels behind
    walls into the visible surface as dark seams. Opt-in
    (`render --dilate-seams`)."""
    h, w, _ = rgb.shape
    pad = np.pad(rgb, ((1, 1), (1, 1), (0, 0)), mode="edge")
    neigh = np.stack(
        [
            pad[1 + dy : h + 1 + dy, 1 + dx : w + 1 + dx]
            for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)
        ]
    )  # [9, h, w, 3]; index 4 = the pixel itself
    lum = neigh.astype(np.int32).sum(axis=-1)          # [9, h, w]
    others = [k for k in range(9) if k != 4]
    has_black = (lum[others] == 0).any(axis=0)
    has_lit = (lum[others] > 0).any(axis=0)
    brightest = np.take_along_axis(
        neigh, lum.argmax(axis=0)[None, ..., None], axis=0
    )[0]
    return np.where((has_black & has_lit)[..., None], brightest, rgb)


def tile_rgb(
    rect: Rect, texels: np.ndarray, tint_extra: bool,
    dilate_seams: bool = False,
) -> np.ndarray:
    """Tone-mapped uint8 [htiles, wtiles, 3] image for one wall
    (saveAs_core, rectangle.c:293-336)."""
    data = texels[rect.base : rect.base + num_tiles(rect)].astype(np.float32)
    rgb = tonemap.to_uint8(tonemap.tone_map(data))
    if tonemap.is_floor_rect(rect.pos, rect.width, rect.height):
        rgb = tonemap.apply_floor_tint(rgb, tint_extra)
    rgb = rgb.reshape(rect.htiles, rect.wtiles, 3)
    if dilate_seams:
        rgb = seam_dilate(rgb)
    return rgb


def save_tile(
    rect: Rect, texels: np.ndarray, path: str, tint_extra: bool,
    dilate_seams: bool = False,
) -> None:
    """saveAs (rectangle.c:338-346)."""
    PILImage.fromarray(
        tile_rgb(rect, texels, tint_extra, dilate_seams), "RGB"
    ).save(path)


def save_tiles(
    walls: Sequence[Rect],
    texels: np.ndarray,
    out_dir: str,
    tint_extra: bool,
    dilate_seams: bool = False,
) -> list:
    """Per-wall tiles/tile_<i>.png export loop (main.c:83-95)."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, r in enumerate(walls):
        p = out / f"tile_{i}.png"
        save_tile(r, texels, str(p), tint_extra, dilate_seams)
        paths.append(p)
    return paths


def save_tile_raw(rect: Rect, texels: np.ndarray, path: str) -> None:
    """Raw float32 dump with TileMetadata header (saveAsRaw,
    rectangle.c:391-429): {int w, int h, float pos[3], width[3], height[3]}
    followed by w*h*3 float32 radiance values."""
    data = texels[rect.base : rect.base + num_tiles(rect)].astype("<f4")
    header = struct.pack(
        "<2i9f",
        rect.wtiles,
        rect.htiles,
        *np.asarray(rect.pos, np.float32),
        *np.asarray(rect.width, np.float32),
        *np.asarray(rect.height, np.float32),
    )
    with open(path, "wb") as f:
        f.write(header)
        f.write(data.tobytes())


def load_tile_raw(path: str):
    """Inverse of save_tile_raw: returns (rect-shaped metadata dict,
    [h, w, 3] float32 radiance)."""
    raw = pathlib.Path(path).read_bytes()
    w, h = struct.unpack_from("<2i", raw, 0)
    vals = struct.unpack_from("<9f", raw, 8)
    data = np.frombuffer(raw, "<f4", count=w * h * 3, offset=8 + 36)
    meta = {
        "pos": np.array(vals[0:3], np.float32),
        "width": np.array(vals[3:6], np.float32),
        "height": np.array(vals[6:9], np.float32),
        "wtiles": w,
        "htiles": h,
    }
    return meta, data.reshape(h, w, 3).copy()
