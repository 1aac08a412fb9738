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

`nearest_hit` launches `csrc/general_nearest.cu` for CUDA tensors (one
thread a ray over `general_table`'s per-rect records, every output bit the
plain version's) and runs `nearest_hit_plain`, the same function on
[B, N] tensors in tiles of `rays_per_tile` rays, for CPU tensors only.
"""
from __future__ import annotations

import torch

from .device_scene import Rects, rect_count
from ..utils.cuda_build import launch, table_plan

INF = float("inf")
TILE_ELEMS = 1 << 25     # rays x rects of one [B, N] tile: 128 MB in f32
RECORD_FLOATS = 16       # floats a rect in general_table
_TABLES = []             # (rects, table) of the last few tables built
_TABLE_CACHE = 8


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


def nearest_hit_plain(src, direc, rects: Rects):
    """Plain version of `nearest_hit`: amin and argmin of `intersect_all`
    over the real rects, in tiles of `rays_per_tile` rays so that no
    [B, N] tensor passes 128 MB (each ray's result depends on that ray
    alone). The padding rows are left out: their zero normals never hit,
    so the minimum and its first column are the padded table's."""
    n = rect_count(rects)
    B = src.shape[0]
    if n == 0 or B == 0:
        return (torch.full((B,), INF, dtype=torch.float32, device=src.device),
                torch.zeros((B,), dtype=torch.int32, device=src.device))
    real = Rects(*(t[:n] for t in rects))
    step = rays_per_tile(n)
    dists, hits = [], []
    for r0 in range(0, B, step):
        dist = intersect_all(src[r0:r0 + step], direc[r0:r0 + step], real)
        dists.append(torch.amin(dist, dim=-1))
        hits.append(torch.argmin(dist, dim=-1).to(torch.int32))
    if len(dists) == 1:
        return dists[0], hits[0]
    return torch.cat(dists), torch.cat(hits)


def general_table(rects: Rects) -> torch.Tensor:
    """The kernel's record table of `rects`: [rect_count, 16] f32 on the
    rects' device, four 16-byte records a rect, {n, n_off}, {w_unit, wlen},
    {h_unit, hlen}, {off_w, off_h, 0, 0}, where off_w = dot(w_unit, pos)
    and off_h = dot(h_unit, pos) are the plain version's own `_offset`. The
    padding rows (zero normals, never hit) are left out. Cached for the
    last few `Rects` it was asked for."""
    for r, table in _TABLES:
        if r is rects:
            return table
    n = rect_count(rects)
    z = torch.zeros_like(rects.wlen)
    table = torch.stack([
        rects.n[:, 0], rects.n[:, 1], rects.n[:, 2], rects.n_off,
        rects.w_unit[:, 0], rects.w_unit[:, 1], rects.w_unit[:, 2],
        rects.wlen,
        rects.h_unit[:, 0], rects.h_unit[:, 1], rects.h_unit[:, 2],
        rects.hlen,
        _offset(rects.w_unit, rects.pos), _offset(rects.h_unit, rects.pos),
        z, z,
    ], dim=1)[:n].to(torch.float32).contiguous()
    _TABLES.append((rects, table))
    del _TABLES[:-_TABLE_CACHE]
    return table


def nearest_hit(src, direc, rects: Rects):
    """Closest front-face hit per ray (src, direc [B, 3] f32): (dist [B],
    +inf on a miss; hit [B] int32, 0 on a miss, which the caller must
    mask); ties go to the first rect.

    CUDA tensors launch `csrc/general_nearest.cu` on `general_table`
    (every bit the plain version's); a failed build or launch raises. CPU
    tensors run `nearest_hit_plain`."""
    dev = rects.n.device
    if src.dim() != 2 or src.shape[1] != 3 or direc.shape != src.shape:
        raise ValueError(f"src {tuple(src.shape)} and direc "
                         f"{tuple(direc.shape)} must both be [B, 3]")
    for name, t in (("src", src), ("direc", direc)):
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"{name} must be float32 on {dev}")
    if dev.type == "cpu":
        return nearest_hit_plain(src, direc, rects)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    R = src.shape[0]
    if 3 * R >= 2**31:
        raise ValueError(f"{R} rays: index past 2^31")
    if R == 0:
        return (src.new_empty((0,)),
                torch.empty((0,), dtype=torch.int32, device=dev))
    table = general_table(rects)
    src, direc = src.contiguous(), direc.contiguous()
    dist = torch.empty((R,), dtype=torch.float32, device=dev)
    hit = torch.empty((R,), dtype=torch.int32, device=dev)
    launch("fm_general_nearest", dev, table.data_ptr(), src.data_ptr(),
           direc.data_ptr(), dist.data_ptr(), hit.data_ptr(),
           table.shape[0], R)
    nearest_hit.launches += 1
    return dist, hit


nearest_hit.launches = 0


def general_plan(n_rects: int, device="cuda") -> dict:
    """What `nearest_hit` launches for a table of n_rects real rects on
    CUDA device `device`, as csrc/general_nearest.cu chooses it
    (fm_general_nearest_plan): instance ("shared" or "device"),
    shared_bytes, registers, blocks_per_sm. It asks the kernel library, so
    it needs the CUDA build; a CUDA error raises."""
    return table_plan("fm_general_nearest_plan", device, n_rects)
