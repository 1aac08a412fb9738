"""Layout-PNG → rectangle-scene compiler (host side).

Re-designs the reference scene compiler (parseLayout.c:359-536)
for the TPU framework: the output is an ordered rectangle soup whose order —
and therefore wall indices and texel arena offsets — matches the reference
exactly, but wall emission is driven by a declarative transition table instead
of an if-chain, and raster passes use vectorized NumPy.

Pipeline:
  1. central starting position  (parseLayout.c:131-166)
  2. synthetic ceiling lights   (flatmatch_tpu.scene.lights)
  3. horizontal + vertical color-transition scans → vertical wall rects
     (parseLayout.c:375-423, transition table :48-128)
  4. greedy rectangle decomposition → floors/ceilings/frames
     (parseLayout.c:425-491)
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..config import SceneConfig
from . import image as im
from .lights import create_lights
from .rectangle import Rect, create_rect, num_mipmap_texels

f32 = np.float32

# --- wall-emission transition table (parseLayout.c:48-128) ------------------
# Key: ordered pixel-class pair (col0, col1) as seen by the scans
# (col0 = above/left of the boundary). Each emission is
# (target, z_low, z_high, swap): `swap` flips the boundary orientation
# relative to the matched order. A pair matched in reverse order emits the
# same list with every `swap` inverted.
_H = "height"  # sentinels resolved against SceneConfig at parse time
_DH = "door_height"
_WL = "window_low"
_WH = "window_high"
_BOX_LO = "box_lo"  # -margin
_BOX_HI = "box_hi"  # height + margin


def _transition_table():
    W, E, O, D, WIN, BWIN, BD = (
        im.WALL,
        im.EMPTY,
        im.OUTSIDE,
        im.DOOR,
        im.WINDOW,
        im.BALCONY_WINDOW,
        im.BALCONY_DOOR,
    )
    return {
        (W, E): [("walls", 0.0, _H, False)],
        (W, D): [("walls", 0.0, _DH, False)],
        (W, BD): [("walls", 0.0, _WH, False)],
        (W, WIN): [("walls", _WL, _WH, False)],
        (W, BWIN): [("walls", _WL, _H, False)],
        (O, E): [("walls", 0.0, _H, False)],
        (D, E): [("walls", _DH, _H, False)],
        (BD, E): [("walls", _WH, _H, False)],
        (W, O): [("box", _BOX_LO, _BOX_HI, False)],
        (WIN, E): [("walls", 0.0, _WL, False), ("walls", _WH, _H, False)],
        (BWIN, E): [("walls", 0.0, _WL, False)],
        # window emitters appear only on OUTSIDE<->WINDOW boundaries, facing
        # inward; box rects cover the outside frame (parseLayout.c:102-125).
        (O, WIN): [
            ("box", _BOX_LO, _WL, True),
            ("box", _WH, _BOX_HI, True),
            ("windows", _WL, _WH, False),
        ],
        (O, BWIN): [
            ("box", _BOX_LO, _WL, True),
            ("windows", _WL, _H, False),
            ("box", _H, _BOX_HI, True),
        ],
    }


@dataclasses.dataclass
class ParsedLayout:
    walls: List[Rect]
    windows: List[Rect]
    lights: List[Rect]
    box: List[Rect]
    width: int
    height: int
    starting_position: tuple  # (x, y) in meters
    num_texels: int = 0


def _resolve_z(z, cfg: SceneConfig) -> np.float32:
    if isinstance(z, str):
        if z == _H:
            return f32(cfg.height)
        if z == _DH:
            return f32(cfg.door_height)
        if z == _WL:
            return f32(cfg.window_low)
        if z == _WH:
            return f32(cfg.window_high)
        if z == _BOX_LO:
            return f32(-cfg.box_margin)
        if z == _BOX_HI:
            # C computes HEIGHT + 0.2 in double then narrows (parseLayout.c:79)
            return f32(np.float64(f32(cfg.height)) + cfg.box_margin)
        raise KeyError(z)
    return f32(z)


def _add_wall(out: List[Rect], x0, y0, x1, y1, zlo, zhi, tile_size):
    """addWall (parseLayout.c:33-36): vertical rect over the segment
    (x0,y1)->(x1,y0) spanning [zlo, zhi]."""
    out.append(
        create_rect(
            (x0, y1, zlo),
            (f32(x1 - x0), f32(y0 - y1), 0.0),
            (0.0, 0.0, f32(zhi - zlo)),
            tile_size,
        )
    )


def _register_wall(table, arrays, col0, col1, x0, y0, x1, y1, tile_size, cfg):
    emissions, flip = table.get((col0, col1)), False
    if emissions is None:
        emissions = table.get((col1, col0))
        flip = True
    if emissions is None:
        return
    for target, zlo, zhi, swap in emissions:
        zlo = _resolve_z(zlo, cfg)
        zhi = _resolve_z(zhi, cfg)
        if swap != flip:  # emit with swapped boundary orientation
            _add_wall(arrays[target], x1, y1, x0, y0, zlo, zhi, tile_size)
        else:
            _add_wall(arrays[target], x0, y0, x1, y1, zlo, zhi, tile_size)
    return


def _central_position(img: np.ndarray) -> tuple:
    """argmax-of-distance-transform starting position (parseLayout.c:131-166).

    Quirk preserved: the reference looks for the first pixel whose distance
    value equals max-1, in row-major scan order."""
    passable = (img == im.EMPTY) | (img == im.WINDOW) | (img == im.DOOR)
    dist, maxd = im.distance_transform(~passable)
    ys, xs = np.nonzero(dist == maxd - 1)
    if len(ys) == 0:
        raise ValueError("layout has no interior space")
    i = np.lexsort((xs, ys))[0]  # first in y-then-x scan order
    return int(xs[i]), int(ys[i])


def _horizontal_scan(img, scaling, table, arrays, tile_size, cfg):
    """Row scan emitting walls at vertical color transitions
    (parseLayout.c:375-398). Transition runs are found vectorized per row."""
    h, w = img.shape
    for y in range(1, h):
        above = img[y - 1]
        here = img[y]
        diff = above != here
        xs = np.nonzero(diff[1:])[0] + 1  # scan starts at x=1
        if len(xs) == 0:
            continue
        # group consecutive columns with identical (above, here) pairs
        brk = np.nonzero(
            (np.diff(xs) != 1)
            | (above[xs[1:]] != above[xs[:-1]])
            | (here[xs[1:]] != here[xs[:-1]])
        )[0]
        starts = np.concatenate(([0], brk + 1))
        ends = np.concatenate((brk, [len(xs) - 1]))
        for s, e in zip(starts, ends):
            x0, x1 = int(xs[s]), int(xs[e]) + 1
            _register_wall(
                table,
                arrays,
                int(above[x0]),
                int(here[x0]),
                f32(f32(x0) * scaling),
                f32(f32(y) * scaling),
                f32(f32(x1) * scaling),
                f32(f32(y) * scaling),
                tile_size,
                cfg,
            )


def _vertical_scan(img, scaling, table, arrays, tile_size, cfg):
    """Column scan (parseLayout.c:401-423)."""
    h, w = img.shape
    for x in range(1, w):
        left = img[:, x - 1]
        here = img[:, x]
        diff = left != here
        ys = np.nonzero(diff[1:])[0] + 1
        if len(ys) == 0:
            continue
        brk = np.nonzero(
            (np.diff(ys) != 1)
            | (left[ys[1:]] != left[ys[:-1]])
            | (here[ys[1:]] != here[ys[:-1]])
        )[0]
        starts = np.concatenate(([0], brk + 1))
        ends = np.concatenate((brk, [len(ys) - 1]))
        for s, e in zip(starts, ends):
            y0, y1 = int(ys[s]), int(ys[e]) + 1
            _register_wall(
                table,
                arrays,
                int(left[y0]),
                int(here[y0]),
                f32(f32(x) * scaling),
                f32(f32(y0) * scaling),
                f32(f32(x) * scaling),
                f32(f32(y1) * scaling),
                tile_size,
                cfg,
            )


def _add_horizontal(out: List[Rect], x, y, dx, dy, z, tile_size):
    """addHorizontalRect (parseLayout.c:43-46)."""
    out.append(
        create_rect((x, y, z), (dx, 0.0, 0.0), (0.0, dy, 0.0), tile_size)
    )


def _greedy_rect_runs(img):
    """Greedy maximal-run decomposition runs (x_start, y, x_end+1, y_end+1,
    color) in the reference's scan order (parseLayout.c:425-491).
    Destructive on `img`."""
    h, w = img.shape
    for y in range(h):
        x = 0
        while x < w:
            color = int(img[y, x])
            if color == im.INVALIDATED:
                x += 1
                continue
            x_start = x
            while x + 1 < w and int(img[y, x + 1]) == color:
                x += 1
            x_end = x
            y_end = y + 1
            while y_end < h and bool(np.all(img[y_end, x_start : x_end + 1] == color)):
                y_end += 1
            img[y:y_end, x_start : x_end + 1] = im.INVALIDATED
            yield x_start, y, x_end + 1, y_end, color
            x += 1


def _decompose_areas(img, scaling, arrays, tile_size, cfg: SceneConfig):
    """Emit floors/ceilings/window-frame rects from the greedy decomposition
    (parseLayout.c:425-491)."""
    H = f32(cfg.height)
    for x_start, y, x_end, y_end, color in _greedy_rect_runs(img):
        sx0 = f32(f32(x_start) * scaling)
        sx1 = f32(f32(x_end) * scaling)
        sy0 = f32(f32(y) * scaling)
        dxf = f32(f32(x_start - x_end) * scaling)  # x_end -> x_start
        dxr = f32(f32(x_end - x_start) * scaling)
        dyf = f32(f32(y_end - y) * scaling)
        walls = arrays["walls"]
        if color == im.WINDOW:
            _add_horizontal(walls, sx1, sy0, dxf, dyf, f32(cfg.window_low), tile_size)
            _add_horizontal(walls, sx0, sy0, dxr, dyf, f32(cfg.window_high), tile_size)
        elif color == im.BALCONY_WINDOW:
            _add_horizontal(walls, sx1, sy0, dxf, dyf, f32(cfg.window_low), tile_size)
            _add_horizontal(walls, sx0, sy0, dxr, dyf, H, tile_size)
        elif color == im.EMPTY:
            _add_horizontal(walls, sx1, sy0, dxf, dyf, f32(0.0), tile_size)
            _add_horizontal(walls, sx0, sy0, dxr, dyf, H, tile_size)
        elif color == im.DOOR:
            _add_horizontal(walls, sx1, sy0, dxf, dyf, f32(0.0), tile_size)
            _add_horizontal(walls, sx0, sy0, dxr, dyf, f32(cfg.door_height), tile_size)
        elif color == im.BALCONY_DOOR:
            _add_horizontal(walls, sx1, sy0, dxf, dyf, f32(0.0), tile_size)
            _add_horizontal(walls, sx0, sy0, dxr, dyf, f32(cfg.window_high), tile_size)

        if color != im.OUTSIDE:
            box = arrays["box"]
            ztop = _resolve_z(_BOX_HI, cfg)
            zbot = _resolve_z(_BOX_LO, cfg)
            _add_horizontal(box, sx1, sy0, dxf, dyf, ztop, tile_size)
            _add_horizontal(box, sx0, sy0, dxr, dyf, zbot, tile_size)


def parse_layout(
    img: np.ndarray, scaling: float, tile_size: float, cfg: SceneConfig | None = None
) -> ParsedLayout:
    """Compile a packed uint32 layout image into an ordered rectangle scene
    (parseLayout.c:359-536). `scaling` is meters per pixel."""
    cfg = cfg or SceneConfig()
    img = img.copy()
    scaling = f32(scaling)
    table = _transition_table()
    arrays = {"walls": [], "windows": [], "lights": [], "box": []}

    cx, cy = _central_position(img)
    create_lights(img, scaling, arrays["lights"], cfg)

    _horizontal_scan(img, scaling, table, arrays, tile_size, cfg)
    _vertical_scan(img, scaling, table, arrays, tile_size, cfg)
    _decompose_areas(img, scaling, arrays, tile_size, cfg)

    h, w = img.shape
    out = ParsedLayout(
        walls=arrays["walls"],
        windows=arrays["windows"],
        lights=arrays["lights"],
        box=arrays["box"],
        width=w,
        height=h,
        starting_position=(float(f32(cx * scaling)), float(f32(cy * scaling))),
    )

    # texel arena layout: per-wall base offsets incl. mipmap pyramids,
    # 1 GB cap (parseLayout.c:512-530)
    total = 0
    for r in out.walls:
        r.base = total
        total += num_mipmap_texels(r)
    check_texel_cap(total, cfg)
    out.num_texels = total
    return out


def check_texel_cap(total: int, cfg: SceneConfig, context: str = ""):
    """The reference's 1 GB texel-arena refusal (parseLayout.c:520-524,
    16 bytes per cl_float4 texel) — the ONE cap check, shared by the
    scene compiler and the supersampled twin (render.py)."""
    if total * 16 > cfg.texel_cap_bytes:
        raise MemoryError(
            f"{context}texel arena would need {total * 16 / 1e9:.2f} GB "
            f"(cap {cfg.texel_cap_bytes / 1e9:.2f} GB)"
        )
