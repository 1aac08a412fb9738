"""Scene container, struct-of-arrays packing, and geometry.json writer.

The reference keeps the scene as an array-of-structs Geometry
(geometry.h:7-15) for OpenCL; the TPU framework packs it as a
struct-of-arrays for the device (ops/device_scene.pack_rects). The JSON
writer reproduces writeJsonOutput (geometry.c:57-90)
byte-for-byte.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..utils.spans import span
from .layout import ParsedLayout
from .rectangle import Rect, length_f32, num_mipmap_texels, num_tiles

f32 = np.float32


@dataclasses.dataclass
class Scene:
    """Compiled scene: ordered rect lists + texel arena layout."""

    layout: ParsedLayout

    @property
    def walls(self) -> List[Rect]:
        return self.layout.walls

    @property
    def windows(self) -> List[Rect]:
        return self.layout.windows

    @property
    def lights(self) -> List[Rect]:
        return self.layout.lights

    @property
    def box(self) -> List[Rect]:
        return self.layout.box

    @property
    def num_texels(self) -> int:
        return self.layout.num_texels

    def level0_mask(self) -> np.ndarray:
        """Boolean [num_texels] mask of level-0 (non-mipmap) texels."""
        mask = np.zeros(self.num_texels, bool)
        for r in self.walls:
            mask[r.base : r.base + num_tiles(r)] = True
        return mask


def _fmt(v) -> str:
    """printf("%f") equivalent: fixed 6 decimals of the double value."""
    return f"{float(v):f}"


def _fmt_vec(p) -> str:
    return f"[{_fmt(p[0])}, {_fmt(p[1])}, {_fmt(p[2])}]"


def geometry_json(scene: Scene) -> str:
    """Exact reproduction of the reference geometry.json
    (geometry.c:57-90)."""
    with span("export.geometry"):
        lay = scene.layout
        out = []
        sp = lay.starting_position
        out.append('{\n"startingPosition" : [%s, %s],\n'
                   % (_fmt(sp[0]), _fmt(sp[1])))
        out.append('"layoutImageSize" : [%d, %d],\n'
                   % (lay.width, lay.height))
        out.append('"geometry" : [\n')
        nw = len(lay.walls)
        for i, r in enumerate(lay.walls):
            out.append(
                '  { "pos": %s, "width": %s, "height": %s, '
                '"textureId": %d}%s\n'
                % (_fmt_vec(r.pos), _fmt_vec(r.width), _fmt_vec(r.height),
                   i, "," if i + 1 < nw else "")
            )
        out.append('],\n"box": [\n')
        nb = len(lay.box)
        for i, r in enumerate(lay.box):
            out.append(
                '  { "pos": %s, "width": %s, "height": %s}%s\n'
                % (_fmt_vec(r.pos), _fmt_vec(r.width), _fmt_vec(r.height),
                   "," if i + 1 < nb else "")
            )
        out.append(']\n}\n')
        return "".join(out)


def mipmap_level_offsets(r: Rect):
    """(level base offset within the rect's arena slice, w, h) per mipmap
    level, following the in-arena pyramid layout (rectangle.c:232-259)."""
    out = []
    w, h = r.wtiles, r.htiles
    off = 0
    out.append((off, w, h))
    while w > 1 or h > 1:
        off += w * h
        if w > 1:
            w //= 2
        if h > 1:
            h //= 2
        out.append((off, w, h))
    assert off + 1 == num_mipmap_texels(r)
    return out
