"""Plain photon tracer: the expected photon arena of a layout, by Monte
Carlo with the benchmark's own draws (torch.Generator from the seed).

The physics is the upstream OpenCL kernel's (tracePhoton, photonmap.cl of
rbuch703/flatmatch-global-illumination): photons leave a uniform point of
each window and light, 1e-5 along a cosine-distributed direction (a
window's disk u taken positive); each of up to `max_depth` bounces finds
the nearest wall, deposits the photon's color at the texel it hit after
the bounce's attenuation, and goes on: a mirror reflection with
probability 0.75 where the hit lies on the floor (z <= 0.0005), else a
diffuse bounce that multiplies the color by the floor tint (z < 1e-5) and
the albedo 0.9. A photon that hits nothing leaves. Every emitter sends
floor(samplesPerArea * area) photons, and a wall's level-0 texels are
scaled by exposure * tiles / (area * samplesPerArea) (main.c).

`trace` sends `photons` photons in all, shared over the emitters in
proportion to their budgets, and weighs each emitter's by budget / sent,
so the arena estimates the full budget's; it counts the bounces traced
(one nearest-hit query each).
"""
from __future__ import annotations

import numpy as np
import torch

from . import geometry as geo
from .layout import Layout, emitters, exposure_scale, photon_counts

EPS = 1e-5
MIRROR_P = 0.75
MIRROR_Z = 0.0005
FLOOR_Z = 1e-5
ALBEDO = 0.9
FLOOR_TINT = (1.0, 0.85, 0.7)
WINDOW_COLOR = (18.0, 18.0, 18.0)
LIGHT_COLOR = (16.0, 16.0, 18.0)
EXPOSURE = 0.35
CHUNK = 1 << 21


def shares(counts: np.ndarray, photons: int) -> np.ndarray:
    """Photons sent per emitter: `photons` shared in proportion to
    `counts`, at least one each."""
    return np.maximum(np.round(counts / counts.sum() * photons), 1).astype(
        np.int64)


def trace(layout: Layout, samples_per_area: float, max_depth: int,
          photons: int, gen: torch.Generator, device,
          dtype=torch.float32) -> dict:
    """Monte-Carlo photon arena of `layout` with `photons` photons drawn
    from `gen`: `raw` [T, 3] float64 (the weighted deposit sums of the
    full budget, un-exposed), `bounces` (nearest-hit queries), `sent` and
    `budget` (photons traced and the full budget's)."""
    tab = geo.table(layout.walls, device, dtype)
    raw = torch.zeros((layout.num_texels, 3), dtype=torch.float64,
                      device=device)
    tint = torch.tensor(FLOOR_TINT, dtype=dtype, device=device)
    counts = photon_counts(layout, samples_per_area)
    sent = shares(counts, photons)
    bounces = 0
    for e, (em, n_e) in enumerate(zip(emitters(layout), sent)):
        weight = float(counts[e]) / float(n_e)
        color0 = WINDOW_COLOR if em["window"] else LIGHT_COLOR
        vec = {k: torch.as_tensor(em[k], device=device).to(dtype)
               for k in ("pos", "width", "height", "n")}
        for s in range(0, int(n_e), CHUNK):
            B = min(CHUNK, int(n_e) - s)
            u = torch.rand((B, 4 + 3 * max_depth), generator=gen,
                           device=device).to(dtype)
            n = vec["n"].expand(B, 3)
            d = geo.cosine_dirs(n, u[:, 2], u[:, 3], torch.full(
                (B,), em["window"], device=device))
            o = (vec["pos"] + vec["width"] * u[:, 0:1]
                 + vec["height"] * u[:, 1:2] + d * EPS)
            col = torch.tensor(color0, dtype=dtype, device=device).expand(
                B, 3)
            for depth in range(max_depth):
                bounces += o.shape[0]
                t, rect = geo.nearest(o, d, tab)
                live = rect >= 0
                o, d, col, t, rect, u = (x[live] for x in
                                         (o, d, col, t, rect, u))
                if o.shape[0] == 0:
                    break
                o = o + d * t[:, None]
                idx = geo.texel(tab, rect, o)
                nh = tab.n[rect]
                u_rr = u[:, 4 + 3 * depth]
                diffuse = (o[:, 2] > MIRROR_Z) | (u_rr > MIRROR_P)
                d_diffuse = geo.cosine_dirs(nh, u[:, 5 + 3 * depth],
                                            u[:, 6 + 3 * depth])
                d_mirror = d - 2.0 * (nh * d).sum(1, keepdim=True) * nh
                on_floor = o[:, 2] < FLOOR_Z
                att = torch.where(on_floor[:, None], tint[None],
                                  torch.ones_like(tint)[None]) * ALBEDO
                col = torch.where(diffuse[:, None], col * att, col)
                d = torch.where(diffuse[:, None], d_diffuse, d_mirror)
                raw.index_add_(0, idx, col.to(torch.float64) * weight)
                o = o + d * EPS
    return dict(raw=raw.cpu().numpy(), bounces=int(bounces),
                sent=int(sent.sum()), budget=int(counts.sum()))


def estimate(layout: Layout, settings: dict, photons: int,
             gen: torch.Generator, device, dtype=torch.float32):
    """(the exposed arena [T, 3] estimated with `photons` photons, the
    trace's figures)."""
    spa = float(settings["samples_per_area"])
    r = trace(layout, spa, int(settings["max_depth"]), photons, gen,
              device, dtype)
    return r["raw"] * exposure_scale(layout, spa, EXPOSURE)[:, None], r


def program_samples(layout: Layout, settings: dict) -> int:
    """`estimate`'s samples of one render of the program: its photons."""
    return int(photon_counts(layout, float(settings["samples_per_area"]))
               .sum())


def expected(layout: Layout, settings: dict, budget: dict, seed: int,
             device, dtype=torch.float32) -> dict:
    """The reference's estimate of the program's output, in two
    independent halves of `budget["photons"]` photons: `halves` (two
    exposed arenas [T, 3]), `share` (one half's photons over a render's),
    and `work`: a render's photons and the bounces a photon traces."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    half = int(budget["photons"]) // 2
    arenas, sent, bounces = [], 0, 0
    for _ in range(2):
        arena, r = estimate(layout, settings, half, gen, device, dtype)
        arenas.append(arena)
        sent += r["sent"]
        bounces += r["bounces"]
    photons = program_samples(layout, settings)
    return dict(halves=arenas, share=half / photons,
                work=dict(photons=photons, bounces_per_photon=bounces / sent,
                          rects=len(layout.walls),
                          texels=layout.num_texels))
