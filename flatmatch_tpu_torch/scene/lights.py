"""Synthetic ceiling lights for windowless rooms (host side).

Port of the reference light-placement pass (parseLayout.c:168-341):
rooms reachable from a window are flood-filled away; remaining rooms get a
square ceiling light at the skeletal pixel nearest the room-AABB center, sized
by room area. The room traversal keeps the reference's exact LIFO order so the
tie-breaking skeletal-point choice (parseLayout.c:248-260) is identical.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np

from ..config import SceneConfig
from . import image as im
from .rectangle import Rect, create_rect

f32 = np.float32


def _traverse_room(dist, visited, x0, y0):
    """LIFO flood traversal collecting skeletal points (parseLayout.c:168-212).

    Returns (num_pixels, max_dist, skeletal_points in discovery order)."""
    h, w = dist.shape
    stack = [(x0, y0)]
    skeletal: List[tuple] = []
    num_pixels = 0
    max_dist = 1

    def d(x, y):  # clamped read (image.c:61-66)
        return dist[min(max(y, 0), h - 1), min(max(x, 0), w - 1)]

    while stack:
        x, y = stack.pop()
        if x < 0 or x >= w or y < 0 or y >= h:
            continue
        if dist[y, x] == 0:
            continue
        if visited[y, x]:
            continue
        visited[y, x] = 2
        num_pixels += 1

        v = dist[y, x]
        if v >= d(x + 1, y) and v >= d(x - 1, y) and v >= d(x, y + 1) and v >= d(x, y - 1):
            skeletal.append((x, y))
            visited[y, x] = 3
        if v > max_dist:
            max_dist = int(v)

        # push order matches the reference so pops (and thus skeletal order)
        # agree; push checks use clamped visited reads (parseLayout.c:203-206)
        if not visited[y, max(x - 1, 0)]:
            stack.append((x - 1, y))
        if not visited[y, min(x + 1, w - 1)]:
            stack.append((x + 1, y))
        if not visited[max(y - 1, 0), x]:
            stack.append((x, y - 1))
        if not visited[min(y + 1, h - 1), x]:
            stack.append((x, y + 1))

    return num_pixels, max_dist, skeletal


def _create_light_in_room(dist, visited, x, y, scaling, out: List[Rect], cfg: SceneConfig):
    """Steps 3a-3e of the light pass (parseLayout.c:216-282)."""
    num_pixels, max_dist, skeletal = _traverse_room(dist, visited, x, y)
    assert skeletal, "room traversal found no skeletal points"

    xs = [p[0] for p in skeletal]
    ys = [p[1] for p in skeletal]
    mid_x = (min(xs) + max(xs)) // 2
    mid_y = (min(ys) + max(ys)) // 2

    best = skeletal[0]
    best_d = (best[0] - mid_x) ** 2 + (best[1] - mid_y) ** 2
    for px, py in skeletal:
        dd = (px - mid_x) ** 2 + (py - mid_y) ** 2
        if dd < best_d:
            best_d = dd
            best = (px, py)

    # light half-edge: sqrt(area)/divisor clamped to max_dist-1, in meters
    # (parseLayout.c:266-272; C narrows the double sqrt to float)
    e = f32(math.sqrt(num_pixels) / cfg.light_edge_divisor)
    if e > max_dist - 1:
        e = f32(max_dist - 1)
    e = f32(e * scaling)
    px = f32(f32(best[0]) * scaling)
    py = f32(f32(best[1]) * scaling)

    z = f32(np.float64(f32(cfg.height)) - cfg.light_z_offset)  # HEIGHT - 0.001
    out.append(
        create_rect(
            (f32(px - e), f32(py - e), z),
            (f32(np.float32(2) * e), 0.0, 0.0),
            (0.0, f32(np.float32(2) * e), 0.0),
            0.0,  # lights keep a 1x1 lightmap (TILE_SIZE=0, parseLayout.c:280)
        )
    )


def create_lights(src: np.ndarray, scaling, out: List[Rect], cfg: SceneConfig) -> None:
    """Find windowless rooms and add ceiling lights (parseLayout.c:298-341)."""
    img = src.copy()
    h, w = img.shape

    # Step 1: flood-fill window-adjacent rooms with the window color. Scanning
    # original window pixels in row-major order matches the reference's
    # full-image scan (filled pixels never trigger further fills).
    win_ys, win_xs = np.nonzero(img == im.WINDOW)
    for y, x in zip(win_ys.tolist(), win_xs.tolist()):
        for nx, ny in ((x - 1, y), (x + 1, y), (x, y - 1), (x, y + 1)):
            if im.get_pixel(img, nx, ny) == im.EMPTY:
                im.flood_fill(img, min(max(nx, 0), w - 1), min(max(ny, 0), h - 1),
                              im.WINDOW, im.EMPTY)
    if cfg.write_filled_debug_png:
        im.save_image(img, "filled.png")

    # Step 2: distance transform over remaining empty space
    dist, _ = im.distance_transform(img != im.EMPTY)

    visited = np.zeros((h, w), np.uint8)
    visited[dist == 1] = 1  # walls / non-empty

    # Step 3: one light per unvisited room
    for y in range(h):
        row = dist[y]
        vrow = visited[y]
        cand = np.nonzero((row > 1) & (vrow == 0))[0]
        ci = 0
        while ci < len(cand):
            x = int(cand[ci])
            if visited[y, x] == 0 and dist[y, x] > 1:
                _create_light_in_room(dist, visited, x, y, scaling, out, cfg)
            ci += 1
