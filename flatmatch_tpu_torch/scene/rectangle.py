"""Host-side rectangle primitive for the scene compiler.

The single scene primitive mirrors the reference's Rectangle
(rectangle.h:19-26): an oriented 3D rectangle spanned by a
width and a height vector, carrying a lightmap tile grid. Construction
arithmetic is float32-exact so the compiled scene matches the reference
bit-for-bit (rectangle.c:15-57). On-device the scene lives as a
struct-of-arrays (see flatmatch_tpu.scene.geometry), not as objects.
"""
from __future__ import annotations

import dataclasses

import numpy as np

f32 = np.float32


def v3(x, y, z) -> np.ndarray:
    return np.array([x, y, z], dtype=np.float32)


def cross_f32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """float32 cross product, component-wise like vector3_cl.c:81-86."""
    return np.array(
        [
            f32(a[1] * b[2]) - f32(a[2] * b[1]),
            f32(a[2] * b[0]) - f32(a[0] * b[2]),
            f32(a[0] * b[1]) - f32(a[1] * b[0]),
        ],
        dtype=np.float32,
    )


def length_f32(a: np.ndarray) -> np.float32:
    """float32 norm with left-to-right accumulation (vector3_cl.c:93)."""
    return np.sqrt(f32(f32(f32(a[0] * a[0]) + f32(a[1] * a[1])) + f32(a[2] * a[2])))


def normalized_f32(a: np.ndarray) -> np.ndarray:
    """Normalization via reciprocal length (vector3_cl.c:95-100)."""
    fac = f32(1.0) / length_f32(a)
    return np.array([f32(a[0] * fac), f32(a[1] * fac), f32(a[2] * fac)], dtype=np.float32)


@dataclasses.dataclass
class Rect:
    """pos + width/height span vectors + unit normal + lightmap tile grid."""

    pos: np.ndarray
    width: np.ndarray
    height: np.ndarray
    n: np.ndarray
    base: int = 0      # lightmapSetup.s[0]: first texel index in the arena
    wtiles: int = 1    # lightmapSetup.s[1]
    htiles: int = 1    # lightmapSetup.s[2]


def create_rect(pos, width, height, tile_size: float) -> Rect:
    """Rectangle with power-of-two lightmap sizing (rectangle.c:15-57).

    Starting from a 1x1 tile grid, the dimension with the lower linear texel
    density doubles until the areal density reaches `tile_size` texels/m^2.
    """
    pos = np.asarray(pos, np.float32)
    width = np.asarray(width, np.float32)
    height = np.asarray(height, np.float32)
    n = normalized_f32(cross_f32(height, width))

    wlen = length_f32(width)
    hlen = length_f32(height)
    s1, s2 = 1, 1  # wtiles, htiles
    area = f32(wlen * hlen)
    density = f32(f32(f32(s1) * s2) / area)
    ts = f32(tile_size)
    while density < ts:
        width_res = f32(f32(s1) / wlen)
        height_res = f32(f32(s2) / hlen)
        if width_res < height_res:
            s1 *= 2
        else:
            s2 *= 2
        density = f32(f32(f32(s1) * s2) / area)
    return Rect(pos=pos, width=width, height=height, n=n, wtiles=s1, htiles=s2)


def num_tiles(r: Rect) -> int:
    """Level-0 texel count (rectangle.c:157-164)."""
    return r.wtiles * r.htiles


def num_mipmap_texels(r: Rect) -> int:
    """Texel count including the full mipmap pyramid (rectangle.c:166-192)."""
    w, h = r.wtiles, r.htiles
    total = w * h
    while w > 1 or h > 1:
        if w > 1:
            assert w % 2 == 0
            w //= 2
        if h > 1:
            assert h % 2 == 0
            h //= 2
        total += w * h
    return total


def area_f32(r: Rect) -> np.float32:
    """Surface area (rectangle.c:194-197)."""
    return f32(length_f32(r.width) * length_f32(r.height))


def distance_to_plane(r: Rect, p: np.ndarray) -> np.float32:
    """Signed distance from point to the rect's plane
    (getDistanceToPlane, rectangle.c:436-440)."""
    d = np.asarray(p, np.float32) - r.pos
    return f32(np.dot(d, r.n))


def is_behind_ray(r: Rect, src, direc) -> bool:
    """All four corners behind the ray origin (isBehindRay,
    rectangle.c:97-113)."""
    src = np.asarray(src, np.float32)
    direc = np.asarray(direc, np.float32)
    corners = [
        r.pos,
        r.pos + r.width,
        r.pos + r.height,
        r.pos + r.width + r.height,
    ]
    return all(float(np.dot(c - src, direc)) < 0 for c in corners)


def bsp_position(plane: Rect, r: Rect) -> int:
    """-1/0/+1: rect entirely on the negative/straddling/positive side of
    the plane (getPosition, rectangle.c:476-506) — the BSP split classifier,
    kept as a host utility (the TPU path needs no BSP)."""
    corners = [
        r.pos,
        r.pos + r.width,
        r.pos + r.height,
        r.pos + r.width + r.height,
    ]
    is_left = is_right = False
    for c in corners:
        d = float(distance_to_plane(plane, c))
        is_left |= d < 0
        is_right |= d > 0
    if is_left and not is_right:
        return -1
    if is_right and not is_left:
        return 1
    return 0


def shortest_distance_to_point(r: Rect, p) -> np.float32:
    """Min distance from a point to the (bounded) rectangle
    (getShortestDistanceRectToPoint, rectangle.c:442-473) — the radiosity
    candidate-sort key in the reference."""
    p = np.asarray(p, np.float32)
    vdist = p - r.pos
    proj = r.n * f32(np.dot(vdist, r.n))
    on_plane = p - proj
    d = on_plane - r.pos
    hlen = length_f32(r.height)
    wlen = length_f32(r.width)
    u = f32(np.dot(d, normalized_f32(r.height)) / hlen)
    v = f32(np.dot(d, normalized_f32(r.width)) / wlen)
    u = min(max(u, 0.0), 1.0)
    v = min(max(v, 0.0), 1.0)
    clamped = r.pos + r.width * f32(v) + r.height * f32(u)
    return f32(np.linalg.norm(p - clamped))


def tile_center(r: Rect, tile_id: int) -> np.ndarray:
    """Center point of a level-0 tile (rectangle.c:140-154)."""
    if tile_id >= num_tiles(r):
        return v3(0, 0, 0)
    vw = r.width.astype(np.float32) * f32(f32(1.0) / f32(r.wtiles))
    vh = r.height.astype(np.float32) * f32(f32(1.0) / f32(r.htiles))
    tx = tile_id % r.wtiles
    ty = tile_id // r.wtiles
    return (r.pos + vw * f32(tx + 0.5) + vh * f32(ty + 0.5)).astype(np.float32)
