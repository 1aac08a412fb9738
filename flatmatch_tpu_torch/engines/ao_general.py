"""Ambient occlusion of a scene of any orientation: the general
intersector over every rect, in plain PyTorch.

Counterpart of flatmatch_tpu/engines/ao.py (`_ao_chunk`, `render_ao`), which
the JAX package runs on scenes without an axis-aligned table
(render.py:259-261); `render.run_engine` does the same. For every wall
texel it fires the 481 geosphere-depth-4 directions rotated into the
surface frame from 1e-5 along each, takes the nearest hit over every rect
(ops/intersect.py), counts a miss as sky at cfg.sky_distance and writes
sum_k dist_k * fac_k / (sum_k fac_k * normalization) in all three channels
(performAmbientOcclusionNative, photonmap.c:436-491); mipmap slots stay 0.
The JAX engine has no Pallas kernel here: XLA fuses the [rays, N] work.
The port casts cfg.texels_per_chunk texels' rays at a time on the rect
table's device, each chunk one `ops/intersect.nearest_hit`: a launch of
`csrc/general_nearest.cu` on the card, the plain version in tiles of rays
on the CPU. The nearest distance is the minimum of the plain version's
[rays, N] distances, exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import AoConfig
from ..ops.device_scene import Rects
from ..ops.geosphere import geosphere
from ..ops.intersect import nearest_hit
from ..scene.geometry import Scene
from ..scene.rectangle import num_tiles
from .ao import NUDGE, tile_centers, wall_directions

f32 = np.float32


def chunk_rays(centers, dirs):
    """The rays of a [C] texel chunk over its [K] directions: origins
    NUDGE along each direction from each center, and the directions,
    [C * K, 3] each, texel-major."""
    C, K = centers.shape[0], dirs.shape[0]
    src = (centers[:, None, :] + dirs[None, :, :] * NUDGE).reshape(C * K, 3)
    return src, dirs[None, :, :].expand(C, K, 3).reshape(C * K, 3)


def ao_chunk(rects: Rects, centers, dirs, fac, sky_distance: float,
             normalization: float) -> torch.Tensor:
    """AO of a [C] texel chunk over its [K] directions (photonmap.c:
    441-475): [C] f32."""
    C, K = centers.shape[0], dirs.shape[0]
    dist, _ = nearest_hit(*chunk_rays(centers, dirs), rects)
    dist = torch.where(torch.isfinite(dist), dist,
                       torch.full_like(dist, sky_distance)).reshape(C, K)
    dist_sum = torch.sum(dist * fac[None, :], dim=-1)
    return dist_sum / (torch.sum(fac) * normalization)


def render_ao(scene: Scene, rects: Rects, cfg: AoConfig,
              wall_indices=None) -> np.ndarray:
    """Full AO pass over every wall (or the walls `wall_indices`, the
    others' texels staying 0) on the rect table's device; returns the
    [num_texels, 3] arena."""
    dev = rects.n.device
    texels = np.zeros((scene.num_texels, 3), f32)
    fac = torch.from_numpy(geosphere(cfg.geosphere_level)[:, 2].copy()
                           ).to(dev)
    chunk = int(cfg.texels_per_chunk)
    sky = float(f32(cfg.sky_distance))
    norm = float(f32(cfg.normalization))
    walls = (scene.walls if wall_indices is None
             else [scene.walls[i] for i in wall_indices])
    for wall in walls:
        dirs = torch.from_numpy(
            wall_directions(wall.n, cfg.geosphere_level)).to(dev)
        centers = torch.from_numpy(tile_centers(wall)).to(dev)
        vals = torch.cat([ao_chunk(rects, centers[s:s + chunk], dirs, fac,
                                   sky, norm)
                          for s in range(0, num_tiles(wall), chunk)])
        texels[wall.base:wall.base + num_tiles(wall)] = (
            vals.cpu().numpy()[:, None])
    return texels
