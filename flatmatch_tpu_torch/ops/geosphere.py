"""Geodesic hemisphere direction tables (numpy; a copy of
flatmatch_tpu/ops/geosphere.py, which the port does not import).

Regenerates the reference's precomputed near-uniform unit vectors on the
z >= 0 hemisphere (the reference's geoSphere.c, generator geoSphere.py:30-81)
with the same algorithm: four quarter-sphere triangles around +z are
icosphere-subdivided to the requested depth, the unique vertices collected in
first-visit order, and vertices with z == 0 filtered out. Depths 2..5 yield
19 / 113 / 481 / 1985 vectors (geoSphere.h:15-25). Ambient occlusion uses
depth 4 (photonmap.c:450).
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np


def _normalized(v):
    l = math.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    return (v[0] / l, v[1] / l, v[2] / l)


def _mid(a, b):
    return _normalized(((a[0] + b[0]) / 2.0, (a[1] + b[1]) / 2.0, (a[2] + b[2]) / 2.0))


def _subdivide(v1, v2, v3, depth, vertices):
    if depth <= 0:
        return
    v12 = _mid(v1, v2)
    v23 = _mid(v2, v3)
    v31 = _mid(v3, v1)
    if depth == 1:
        for v in (v1, v2, v3, v12, v23, v31):
            vertices.setdefault(v, v)
    else:
        _subdivide(v1, v12, v31, depth - 1, vertices)
        _subdivide(v2, v12, v23, depth - 1, vertices)
        _subdivide(v3, v23, v31, depth - 1, vertices)
        _subdivide(v12, v23, v31, depth - 1, vertices)


@lru_cache(maxsize=None)
def geosphere(depth: int) -> np.ndarray:
    """Unit directions [K,3] float32 on the open upper hemisphere (z > 0).

    Quirk preserved: the reference's depth-2 table (geoSphere2, 19 vectors)
    was generated with the 3-seed ring variant that survives commented out in
    geoSphere.py:65-67; depths 3-5 use the 4-seed ring (geoSphere.py:60-63),
    giving 2n(n-1)+1 vectors for edge division n = 2^depth (113/481/1985).
    """
    apex = (0.0, 0.0, 1.0)
    angles = (120, 240, 360) if depth == 2 else (90, 180, 270, 360)
    ring = [
        (math.sin(a / 180.0 * math.pi), math.cos(a / 180.0 * math.pi), 0.0)
        for a in angles
    ]
    vertices: dict = {}
    for i in range(len(ring)):
        _subdivide(apex, ring[i], ring[(i + 1) % len(ring)], depth, vertices)
    vs = [v for v in vertices if v[2] != 0.0]
    return np.array(vs, np.float32)
