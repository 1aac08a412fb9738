"""Rect table of the general engines, emitter table and exposure
normalization.

Counterpart of flatmatch_tpu/ops/device_scene.py. `pack_rects` builds the
rect struct-of-arrays of the general photon engines and the general AO,
padded to a multiple of 128 rows whose zero normals can never be hit
(rectangle.c:70-72 culls denom >= 0); `rect_count` gives the rows before
the padding.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..scene.geometry import Scene
from ..scene.rectangle import Rect, area_f32, length_f32, num_tiles

f32 = np.float32


class Rects(NamedTuple):
    """Packed rectangle set (RectsDev). Shapes: [N, 3] vectors, [N]
    scalars, N padded to a multiple of `pad_to`."""

    pos: torch.Tensor
    wvec: torch.Tensor
    hvec: torch.Tensor
    n: torch.Tensor
    w_unit: torch.Tensor   # wvec / |wvec|
    h_unit: torch.Tensor
    wlen: torch.Tensor
    hlen: torch.Tensor
    n_off: torch.Tensor    # dot(n, pos): plane offset for intersection
    base: torch.Tensor     # int32 texel arena base index
    wtiles: torch.Tensor   # int32
    htiles: torch.Tensor   # int32


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((n,) + a.shape[1:], a.dtype)
    out[: len(a)] = a
    return out


def rects_from_numpy(device="cpu", **fields) -> Rects:
    """`Rects` from numpy arrays of its fields, on `device`."""
    return Rects(**{k: torch.from_numpy(np.array(v)).to(device)
                    for k, v in fields.items()})


def pack_rects(rects: List[Rect], pad_to: int = 128, device="cpu") -> Rects:
    """Pack host rectangles into the padded table on `device`, with the
    float32 arithmetic of the JAX package's pack_rects."""
    count = len(rects)
    n_pad = max(((count + pad_to - 1) // pad_to) * pad_to, pad_to)
    pos = np.array([r.pos for r in rects], f32).reshape(count, 3)
    wvec = np.array([r.width for r in rects], f32).reshape(count, 3)
    hvec = np.array([r.height for r in rects], f32).reshape(count, 3)
    nrm = np.array([r.n for r in rects], f32).reshape(count, 3)
    wlen = np.array([length_f32(r.width) for r in rects], f32)
    hlen = np.array([length_f32(r.height) for r in rects], f32)
    w_unit = wvec / wlen[:, None]
    h_unit = hvec / hlen[:, None]
    n_off = np.sum(nrm * pos, axis=-1, dtype=f32)
    base = np.array([r.base for r in rects], np.int32)
    wt = np.array([r.wtiles for r in rects], np.int32)
    ht = np.array([r.htiles for r in rects], np.int32)
    return rects_from_numpy(
        device,
        pos=_pad_rows(pos, n_pad), wvec=_pad_rows(wvec, n_pad),
        hvec=_pad_rows(hvec, n_pad), n=_pad_rows(nrm, n_pad),
        w_unit=_pad_rows(w_unit, n_pad), h_unit=_pad_rows(h_unit, n_pad),
        wlen=_pad_rows(wlen, n_pad), hlen=_pad_rows(hlen, n_pad),
        n_off=_pad_rows(n_off, n_pad), base=_pad_rows(base, n_pad),
        wtiles=np.maximum(_pad_rows(wt, n_pad), 1),
        htiles=np.maximum(_pad_rows(ht, n_pad), 1),
    )


def rect_count(rects: Rects) -> int:
    """Rows before the padding: the padding rows, and only they, have a
    zero normal."""
    real = (rects.n != 0).any(dim=1).nonzero()
    return int(real[-1, 0]) + 1 if real.numel() else 0


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
