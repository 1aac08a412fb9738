"""Plain ray casting over axis-aligned rects, in PyTorch: the nearest hit
of rays against every rect (intersects, rectangle.c), the lightmap texel of
a hit point (getTileIdAt, rectangle.c) and the orthonormal base of a
normal (createBase, vector3_cl.c). `dtype` is the arithmetic's precision:
float32 as the configurations state it, bfloat16 for the control.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

INF = float("inf")
TWO_PI = 2.0 * 3.141592   # the upstream literal (photonmap.cl)


class Group(NamedTuple):
    """Rects whose normal lies along axis k; a and b are the other axes."""

    k: int
    a: int
    b: int
    plane: torch.Tensor    # [R] the rect's coordinate along k
    sign: torch.Tensor     # [R] its normal's component along k (+1 or -1)
    lo_a: torch.Tensor
    hi_a: torch.Tensor
    lo_b: torch.Tensor
    hi_b: torch.Tensor
    index: torch.Tensor    # [R] int64 position in the rect list


class Table(NamedTuple):
    """The rects of a cast: groups by normal axis, and per-rect fields for
    the texel lookup."""

    groups: List[Group]
    pos: torch.Tensor      # [N, 3]
    w_unit: torch.Tensor   # [N, 3]
    h_unit: torch.Tensor
    wlen: torch.Tensor     # [N]
    hlen: torch.Tensor
    base: torch.Tensor     # [N] int64
    wtiles: torch.Tensor   # [N] int64
    htiles: torch.Tensor
    n: torch.Tensor        # [N, 3]


def _length(v: np.ndarray) -> np.ndarray:
    return np.sqrt((v * v).sum(-1))


def table(rects, device, dtype=torch.float32) -> Table:
    """The table of `rects` (dicts of pos, width, height, n, base, wtiles,
    htiles). Every rect must be axis-aligned: its normal along one axis,
    its sides along the other two."""
    pos = np.array([r["pos"] for r in rects], np.float64)
    wv = np.array([r["width"] for r in rects], np.float64)
    hv = np.array([r["height"] for r in rects], np.float64)
    nv = np.array([r["n"] for r in rects], np.float64)
    axis = np.argmax(np.abs(nv), 1)
    for i, k in enumerate(axis):
        if (np.count_nonzero(nv[i]) != 1 or wv[i, k] != 0 or hv[i, k] != 0
                or np.count_nonzero(wv[i]) != 1
                or np.count_nonzero(hv[i]) != 1):
            raise ValueError(f"rect {i} is not axis-aligned")
    far = pos + wv + hv

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    groups = []
    for k in range(3):
        sel = np.nonzero(axis == k)[0]
        if len(sel) == 0:
            continue
        a, b = (k + 1) % 3, (k + 2) % 3
        groups.append(Group(
            k, a, b, t(pos[sel, k]), t(np.sign(nv[sel, k])),
            t(np.minimum(pos[sel, a], far[sel, a])),
            t(np.maximum(pos[sel, a], far[sel, a])),
            t(np.minimum(pos[sel, b], far[sel, b])),
            t(np.maximum(pos[sel, b], far[sel, b])),
            t(sel, torch.int64)))
    wlen, hlen = _length(wv), _length(hv)
    return Table(
        groups, t(pos), t(wv / wlen[:, None]), t(hv / hlen[:, None]),
        t(wlen), t(hlen), t([r["base"] for r in rects], torch.int64),
        t([r["wtiles"] for r in rects], torch.int64),
        t([r["htiles"] for r in rects], torch.int64), t(nv))


def nearest(o: torch.Tensor, d: torch.Tensor, tab: Table):
    """(distance [B], rect [B] int64) of the nearest rect that rays o + t d
    ([B, 3]) hit from its front, t >= 0; (inf, -1) where none is hit.
    Every ray tests every rect: per rect 20 operations (benchmark/
    roofline.py counts them from this function)."""
    best_t = torch.full((o.shape[0],), INF, dtype=o.dtype, device=o.device)
    best_i = torch.full((o.shape[0],), -1, dtype=torch.int64, device=o.device)
    for g in tab.groups:
        dk = d[:, g.k:g.k + 1]
        t = (g.plane[None] - o[:, g.k:g.k + 1]) / dk
        xa = o[:, g.a:g.a + 1] + t * d[:, g.a:g.a + 1]
        xb = o[:, g.b:g.b + 1] + t * d[:, g.b:g.b + 1]
        valid = ((g.sign[None] * dk < 0) & (t >= 0)
                 & (xa >= g.lo_a[None]) & (xa <= g.hi_a[None])
                 & (xb >= g.lo_b[None]) & (xb <= g.hi_b[None]))
        t = torch.where(valid, t, torch.full_like(t, INF))
        tmin, arg = t.min(1)
        better = tmin < best_t
        best_t = torch.where(better, tmin, best_t)
        best_i = torch.where(better, g.index[arg], best_i)
    return best_t, best_i


def texel(tab: Table, rect: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Arena texel [B] int64 of hit points p [B, 3] on rects `rect` [B]
    (>= 0): the offsets along the sides scaled by the tile grid, truncated
    toward zero and clipped to it."""
    rel = p - tab.pos[rect]
    dx = (tab.w_unit[rect] * rel).sum(1)
    dy = (tab.h_unit[rect] * rel).sum(1)
    wt, ht = tab.wtiles[rect], tab.htiles[rect]
    tx = torch.minimum((dx * wt.to(dx.dtype) / tab.wlen[rect]).to(
        torch.int64).clamp(min=0), wt - 1)
    ty = torch.minimum((dy * ht.to(dy.dtype) / tab.hlen[rect]).to(
        torch.int64).clamp(min=0), ht - 1)
    return tab.base[rect] + ty * wt + tx


def base(n: torch.Tensor):
    """(u, v) [B, 3] completing normals n [B, 3] to a right-handed base:
    v = normalize(c x n), u = normalize(v x n), c = +z, or +y where n is
    within 1e-6 of z (createBase)."""
    colinear = n[:, 2].abs() >= 0.999999
    c = torch.zeros_like(n)
    c[:, 1] = colinear.to(n.dtype)
    c[:, 2] = (~colinear).to(n.dtype)
    v = torch.linalg.cross(c, n)
    v = v / torch.sqrt((v * v).sum(1, keepdim=True))
    u = torch.linalg.cross(v, n)
    u = u / torch.sqrt((u * u).sum(1, keepdim=True))
    return u, v


def cosine_dirs(n: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor,
                fold_u: torch.Tensor = None) -> torch.Tensor:
    """Cosine-distributed directions [B, 3] about normals n [B, 3] from
    uniforms u1, u2 [B]: a uniform disk point (sqrt(u1), 2 pi u2) lifted
    onto the hemisphere. Where `fold_u` is set the disk's u is taken
    positive (the sky sampler of windows, photonmap.cl)."""
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    du = r * torch.cos(phi)
    dv = r * torch.sin(phi)
    dn = torch.sqrt(torch.clamp(1.0 - r * r, min=0.0))
    if fold_u is not None:
        du = torch.where(fold_u, du.abs(), du)
    bu, bv = base(n)
    return bu * du[:, None] + bv * dv[:, None] + n * dn[:, None]
