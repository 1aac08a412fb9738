"""Batched ray-rectangle intersection over the padded rect table: the
nearest-hit query of the general engines.

Counterpart of flatmatch_tpu/ops/intersect.py: intersects()
(rectangle.c:67-95) for every ray against every rect, then a min over the
rect axis.

  denom = dot(n, dir)         reject denom >= 0  (backface / parallel)
  fac   = (n_off - dot(n, src)) / denom           reject fac < 0 (behind)
  dx    = dot(w_unit, src) + fac * dot(w_unit, dir) - dot(w_unit, pos_r)
                                                  reject outside [0, wlen]
  dy    = the same along h_unit                   reject outside [0, hlen]

The projections are the JAX package's expanded form, so no [B, N, 3] tensor
is made and the roundings are its own. Every [B, 3] x [3, N] contraction
is three explicit broadcast products summed left to right, never a matmul:
on the card a float32 matmul may run in TF32, and on the TPU one ran in
bf16 and turned grazing distances into false hits (intersect.py:62-70 of
the JAX package).
"""
from __future__ import annotations

import torch

from .device_scene import Rects

INF = float("inf")
TILE_ELEMS = 1 << 25     # rays x rects of one [B, N] tile: 128 MB in f32


def rays_per_tile(n_rects: int) -> int:
    """Rays per step of the [B, N] work, so that no [B, N] f32 tensor
    passes TILE_ELEMS elements."""
    return max(1, TILE_ELEMS // max(1, int(n_rects)))


def _dot3(a, bT):
    """[B, 3] x [3, N] -> [B, N] as component broadcasts, left to right."""
    return (a[:, 0:1] * bT[0][None, :] + a[:, 1:2] * bT[1][None, :]
            + a[:, 2:3] * bT[2][None, :])


def _offset(unit, pos):
    """dot(unit, pos) per rect, left to right."""
    p = unit * pos
    return p[:, 0] + p[:, 1] + p[:, 2]


def intersect_all(src, direc, rects: Rects):
    """Distances from rays [B, 3] to every rect: dist [B, N], +inf where the
    rect is missed."""
    nT, wT, hT = rects.n.T, rects.w_unit.T, rects.h_unit.T
    denom = _dot3(direc, nT)
    fac = (rects.n_off[None, :] - _dot3(src, nT)) / denom
    dx = (_dot3(src, wT) + fac * _dot3(direc, wT)
          - _offset(rects.w_unit, rects.pos))
    dy = (_dot3(src, hT) + fac * _dot3(direc, hT)
          - _offset(rects.h_unit, rects.pos))
    valid = ((denom < 0) & (fac >= 0) & (dx >= 0)
             & (dx <= rects.wlen[None, :]) & (dy >= 0)
             & (dy <= rects.hlen[None, :]))
    return torch.where(valid, fac, torch.full_like(fac, INF))


def nearest_hit(src, direc, rects: Rects):
    """Closest front-face hit per ray: (dist [B], hit [B] int32). dist is
    +inf on a miss, and hit is then 0 and must be masked by the caller;
    ties go to the first rect."""
    dist = intersect_all(src, direc, rects)
    return (torch.amin(dist, dim=-1),
            torch.argmin(dist, dim=-1).to(torch.int32))
