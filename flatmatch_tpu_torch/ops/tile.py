"""Point -> lightmap-texel addressing of the general engines.

Counterpart of flatmatch_tpu/ops/tile.py, getTileIdAt (rectangle.c:205-230):
project the hit point onto the rect's span axes, scale by the tile grid,
truncate toward zero and clip to the grid. Ids are int32 throughout, so
they stay exact past 2^24 texels.
"""
from __future__ import annotations

import torch

from .device_scene import Rects
from .linalg import dot3


def texel_index(rects: Rects, hit, p):
    """Arena texel index [B] int32 of hit points p [B, 3] on rects `hit`
    [B] int32."""
    h = hit.long()
    pdir = p - rects.pos[h]
    dx = dot3(rects.w_unit[h], pdir)
    dy = dot3(rects.h_unit[h], pdir)
    wt = rects.wtiles[h]
    ht = rects.htiles[h]
    # the (int) cast truncates toward zero (rectangle.c:220-221)
    tx = torch.minimum(torch.clamp(
        (dx * wt.to(dx.dtype) / rects.wlen[h]).to(torch.int32), min=0),
        wt - 1)
    ty = torch.minimum(torch.clamp(
        (dy * ht.to(dy.dtype) / rects.hlen[h]).to(torch.int32), min=0),
        ht - 1)
    return rects.base[h] + ty * wt + tx
