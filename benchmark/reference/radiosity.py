"""Plain Monte-Carlo radiosity: the expected radiosity arena of a layout,
with the benchmark's own draws (torch.Generator from the seed).

The method is the upstream native radiosity (performRadiosityNative,
radiosityNative.c of rbuch703/flatmatch-global-illumination): windows and
lights join the walls with texel ranges after the walls' arena; window
texels emit (30, 30, 30), light texels (28, 28, 32). From the center of
every level-0 wall texel `rays` cosine-distributed rays start 1e-5 along
their direction and record the level-0 texel they hit first, over walls,
windows and lights (none where they escape). Each of `iterations` steps
gathers, for every level-0 wall texel, the sum of the arena at its rays'
hits, and sets arena = arena * (1 - rho) + gather * rho / rays on those
texels and arena * (1 - rho) elsewhere, rho = 0.3. The walls' arena is the
result (its mipmap levels rebuilt from level 0).
"""
from __future__ import annotations

import numpy as np
import torch

from . import geometry as geo
from .layout import Layout, mipmap_texels, tile_centers, tiles

NUDGE = 1e-5
REFLECTANCE = 0.3
WINDOW_EMISSION = (30.0, 30.0, 30.0)
LIGHT_EMISSION = (28.0, 28.0, 32.0)
CHUNK_RAYS = 1 << 22


def extended(layout: Layout):
    """(walls + windows + lights with texel ranges appended after the
    walls' arena, total texels, first window texel, first light texel)."""
    rects = [dict(r) for r in layout.walls]
    total = layout.num_texels
    first = {}
    for g in ("windows", "lights"):
        first[g] = total
        for r in layout.groups[g]:
            rects.append(dict(r, base=total))
            total += mipmap_texels(r)
    return rects, total, first["windows"], first["lights"]


def form_factors(layout: Layout, tab, rays: int, gen, device, dtype):
    """[level-0 wall texels, rays] int64 arena ids of each ray's hit, -1
    where it escaped, rows in wall order."""
    centers = np.concatenate([tile_centers(r) for r in layout.walls])
    normals = np.concatenate([np.repeat(r["n"][None], tiles(r), 0)
                              for r in layout.walls])
    rows = len(centers)
    ids = torch.empty((rows, rays), dtype=torch.int64, device=device)
    step = max(1, CHUNK_RAYS // rays)
    for r0 in range(0, rows, step):
        c = torch.as_tensor(centers[r0:r0 + step], device=device).to(dtype)
        n = torch.as_tensor(normals[r0:r0 + step], device=device).to(dtype)
        C = c.shape[0]
        u = torch.rand((C * rays, 2), generator=gen, device=device).to(dtype)
        nn = n.repeat_interleave(rays, 0)
        d = geo.cosine_dirs(nn, u[:, 0], u[:, 1])
        o = c.repeat_interleave(rays, 0) + NUDGE * d
        t, rect = geo.nearest(o, d, tab)
        hit = rect >= 0
        p = o + d * torch.where(hit, t, torch.zeros_like(t))[:, None]
        tex = geo.texel(tab, rect.clamp(min=0), p)
        ids[r0:r0 + C] = torch.where(hit, tex, torch.full_like(tex, -1)
                                     ).reshape(C, rays)
    return ids


def _gather(src: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """sum over each row's rays of src[id] ([rows, 3]), a miss adding a
    zero row; in blocks of rows."""
    ext = torch.cat([src, src.new_zeros((1,) + src.shape[1:])])
    miss = src.shape[0]
    step = max(1, (1 << 22) // ids.shape[1])
    out = []
    for r0 in range(0, ids.shape[0], step):
        sl = ids[r0:r0 + step]
        v = ext[torch.where(sl < 0, miss, sl)]
        out.append(v.sum(1))
    return torch.cat(out)


def estimate(layout: Layout, settings: dict, rays: int,
             gen: torch.Generator, device, dtype=torch.float32):
    """(the walls' arena [T, 3] with `rays` rays a texel, level 0 only,
    the extended rects' count)."""
    rects, total, first_win, first_light = extended(layout)
    tab = geo.table(rects, device, dtype)
    ids = form_factors(layout, tab, rays, gen, device, dtype)
    l0 = torch.as_tensor(np.concatenate([
        np.arange(r["base"], r["base"] + tiles(r)) for r in layout.walls]),
        device=device)
    src = torch.zeros((total, 3), dtype=dtype, device=device)
    src[first_win:first_light] = torch.tensor(WINDOW_EMISSION, dtype=dtype)
    src[first_light:] = torch.tensor(LIGHT_EMISSION, dtype=dtype)
    keep, gain = 1.0 - REFLECTANCE, REFLECTANCE / rays
    for _ in range(int(settings["iterations"])):
        dest = _gather(src, ids)
        src = src * keep
        src[l0] = src[l0] + dest * gain
    arena = np.zeros((layout.num_texels, 3))
    l0n = l0.cpu().numpy()
    arena[l0n] = src[l0].to(torch.float64).cpu().numpy()
    return arena, len(rects)


def program_samples(layout: Layout, settings: dict) -> int:
    """`estimate`'s samples of one render of the program: its rays a
    texel."""
    return int(settings["rays_per_texel"])


def expected(layout: Layout, settings: dict, budget: dict, seed: int,
             device, dtype=torch.float32) -> dict:
    """The reference's estimate of the program's output, in two
    independent halves of `budget["rays_per_texel"]` rays a texel:
    `halves` (two arenas [T, 3], level 0), `share` (one half's rays over
    the program's), `mipmapped` and `work`: a render's rays and the rects
    each tests."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    half = int(budget["rays_per_texel"]) // 2
    arenas = []
    for _ in range(2):
        arena, rects = estimate(layout, settings, half, gen, device, dtype)
        arenas.append(arena)
    return dict(halves=arenas,
                share=half / int(settings["rays_per_texel"]),
                mipmapped=True,
                work=dict(rays=sum(tiles(r) for r in layout.walls)
                          * program_samples(layout, settings),
                          rects=rects))
