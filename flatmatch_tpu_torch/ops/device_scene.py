"""Emitter table and exposure normalization.

Counterpart of flatmatch_tpu/ops/device_scene.py. `pack_rects` is not here:
only the general (non axis-aligned) engine reads it, and that engine is not
ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..scene.geometry import Scene
from ..scene.rectangle import area_f32, num_tiles

f32 = np.float32


class Emitters(NamedTuple):
    """Photon emitters (windows then lights), concatenated. `counts` stays a
    host int64 array: production budgets exceed int32."""

    pos: torch.Tensor        # [E,3] f32
    wvec: torch.Tensor       # [E,3]
    hvec: torch.Tensor       # [E,3]
    n: torch.Tensor          # [E,3]
    color: torch.Tensor      # [E,3] initial photon flux color
    is_window: torch.Tensor  # [E] bool: sky sampler vs cosine sampler
    area: torch.Tensor       # [E]
    counts: np.ndarray       # [E] int64 photon budget per emitter (host)


def emitters_from_numpy(pos, wvec, hvec, n, color, is_window, area, counts,
                        device="cpu") -> Emitters:
    def t(a, dtype=f32):
        return torch.from_numpy(np.array(a, dtype)).to(device)

    return Emitters(
        pos=t(pos), wvec=t(wvec), hvec=t(hvec), n=t(n), color=t(color),
        is_window=t(is_window, bool), area=t(area),
        counts=np.asarray(counts, np.int64),
    )


def pack_emitters(
    scene: Scene,
    samples_per_area: float,
    window_color,
    light_color,
    device="cpu",
) -> Emitters:
    """Emitter table with per-emitter photon budgets: numSamples =
    (uint64)(samplesPerArea * area), truncated (photonmap.c:417-418).
    Windows come first, then lights (global_illumination_cl.c:304-308)."""
    ems = list(scene.windows) + list(scene.lights)
    n_win = len(scene.windows)
    if not ems:
        raise ValueError("scene has no emitters (no windows and no lights)")
    area = np.array([area_f32(r) for r in ems], f32)
    return emitters_from_numpy(
        pos=np.array([r.pos for r in ems], f32),
        wvec=np.array([r.width for r in ems], f32),
        hvec=np.array([r.height for r in ems], f32),
        n=np.array([r.n for r in ems], f32),
        color=np.array(
            [window_color] * n_win + [light_color] * (len(ems) - n_win), f32
        ),
        is_window=np.arange(len(ems)) < n_win,
        area=area,
        counts=(np.float32(samples_per_area) * area).astype(np.int64),
        device=device,
    )


def exposure_scale(scene: Scene, samples_per_area: float,
                   exposure: float) -> np.ndarray:
    """Per-texel exposure normalization (main.c:68-79): texel *= exposure *
    numTiles(wall) / (area(wall) * samplesPerArea) on level-0 texels; the
    mipmap slots get scale 0."""
    scale = np.zeros(scene.num_texels, f32)
    for r in scene.walls:
        tiles_per_sample = f32(
            num_tiles(r) / np.float64(area_f32(r) * samples_per_area)
        )
        scale[r.base : r.base + num_tiles(r)] = f32(
            np.float64(exposure) * tiles_per_sample
        )
    return scale
