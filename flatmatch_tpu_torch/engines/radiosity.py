"""Monte-Carlo form-factor radiosity engine.

Counterpart of flatmatch_tpu/engines/radiosity.py on its single-device
paths (`render_radiosity` with `_form_factors_device(use_aa=True,
compact_rows=True)` on a scene with an axis-aligned table, `use_aa=False`
on any other), after performRadiosityNative (radiosityNative.c:92-268):

  1. extend the rect set with windows and lights, their texel ranges
     appended after the wall arena (:104-127);
  2. emissive init: window texels (30,30,30), light texels (28,28,32);
  3. form factors: from every level-0 wall texel center, `rays_per_texel`
     cosine-distributed rays, drawn with jax.random's threefry
     (ops/threefry.py, bit for bit), record the level-0 texel id they hit
     (-1 on a miss). The rays of each chunk are cast by one launch of
     `ops/aa_query.aa_nearest` (`csrc/aa_nearest.cu`) on a scene with an
     axis-aligned table, else by `form_factor_chunk`: one launch of
     `ops/intersect.nearest_hit` (`csrc/general_nearest.cu`) and the texel
     lookup of `ops/tile.texel_index`;
  4. `iterations` gathers with reflectance rho:
         dest[t] = sum_j src[ids[t, j]]
         src     = src * (1 - rho) + dest * rho / rays
     and one mipmap rebuild after the last (the gather reads level-0 ids
     only, so rebuilds between iterations are overwritten unread);
  5. the first num_texels rows (the wall arena) are the result.

The id table lives on the device as int32 [rows, rays], one row per level-0
wall texel in wall order (the JAX package's compact rows): at the CLI
default of 10000 rays, 240 MB on tests/fixtures/mini.png and 3.86 GB on its
4x4 tiling. It is gathered in chunks of (1 << 22) // rays rows, so no
[rows, rays, 3] tensor is ever made.
"""
from __future__ import annotations

import copy
from typing import List, Tuple

import numpy as np
import torch

from ..config import RadiosityConfig
from ..ops import threefry
from ..ops.aa_query import aa_nearest
from ..ops.aa_scene import AARects, pack_aa
from ..ops.device_scene import Rects, pack_rects
from ..ops.intersect import nearest_hit
from ..ops.mipmap import MipmapPlan, apply_plan, build_plan
from ..ops.sampling import TWO_PI_REF, build_base
from ..ops.tile import texel_index
from ..scene.geometry import Scene
from ..scene.rectangle import Rect, num_mipmap_texels, num_tiles
from .ao import NUDGE, tile_centers

f32 = np.float32
GATHER_IDS = 1 << 22            # ids gathered per step of the relaxation


def extended_rects(scene: Scene) -> Tuple[List[Rect], int, int, int]:
    """Walls + windows + lights with appended texel ranges
    (radiosityNative.c:104-127). Returns (rects, total_texels,
    first_window_texel, first_light_texel)."""
    rects = [copy.copy(r) for r in scene.walls]
    total = scene.num_texels
    first_window = total
    for r in scene.windows:
        r = copy.copy(r)
        r.base = total
        total += num_mipmap_texels(r)
        rects.append(r)
    first_light = total
    for r in scene.lights:
        r = copy.copy(r)
        r.base = total
        total += num_mipmap_texels(r)
        rects.append(r)
    return rects, total, first_window, first_light


def ff_rays(centers: torch.Tensor, normal: torch.Tensor, key, rays: int):
    """Cosine-distributed form-factor rays from [C] texel centers of one
    wall (radiosity._ff_rays): (origins [C*rays, 3], dirs [C*rays, 3]).
    The draws are jax.random.uniform(key, (C, rays, 2))."""
    C = centers.shape[0]
    u = threefry.uniform(key, (C, rays, 2), centers.device)
    r = torch.sqrt(u[..., 0])
    phi = float(f32(TWO_PI_REF)) * u[..., 1]
    du = r * torch.cos(phi)
    dv = r * torch.sin(phi)
    dn = torch.sqrt(1.0 - r * r)
    udir, vdir = build_base(normal[None, :])
    direc = (udir[:, None, :] * du[..., None] + vdir[:, None, :] * dv[..., None]
             + normal[None, None, :] * dn[..., None])
    src = centers[:, None, :] + NUDGE * direc
    return src.reshape(C * rays, 3), direc.reshape(C * rays, 3)


def form_factor_chunk(rects: Rects, centers: torch.Tensor,
                      normal: torch.Tensor, key, rays: int) -> torch.Tensor:
    """Hit-texel ids [C, rays] int32 of `rays` cosine rays from each of [C]
    texel centers over the general table `rects` (radiosity.
    _form_factor_chunk): ff_rays, the nearest hit, the texel of the hit
    point, -1 where the ray escaped."""
    C = centers.shape[0]
    src, direc = ff_rays(centers, normal, key, rays)
    dist, hit = nearest_hit(src, direc, rects)
    found = torch.isfinite(dist)
    p = src + direc * torch.where(found, dist, torch.zeros_like(dist))[:, None]
    ids = texel_index(rects, hit, p)
    return torch.where(found, ids, torch.full_like(ids, -1)).reshape(C, rays)


def form_factors(scene: Scene, table, cfg: RadiosityConfig
                 ) -> torch.Tensor:
    """The source-texel id table [level-0 wall texels, rays] int32 on the
    scene table's device (-1 where the ray escaped). `table` packs the
    EXTENDED rect set: an `AARects` (each chunk one `aa_nearest`) or the
    general `Rects` (`form_factor_chunk`). Chunk ci of wall wi draws with
    key fold_in(fold_in(PRNGKey(seed), wi), ci), as the JAX package does.

    A wall's last chunk holds fewer than texels_per_chunk texels; the JAX
    package pads it and discards the padded rows. Element i of a threefry
    draw depends only on the key and i, so drawing the real rows alone
    gives the same rays, and the padding is not traced here."""
    rays = int(cfg.rays_per_texel)
    chunk = int(cfg.texels_per_chunk)
    general = isinstance(table, Rects)
    dev = table.n.device if general else table.fields.device
    rows = sum(num_tiles(w) for w in scene.walls)
    ids = torch.full((rows, rays), -1, dtype=torch.int32, device=dev)
    key = threefry.prng_key(cfg.seed)
    row0 = 0
    for wi, wall in enumerate(scene.walls):
        centers = torch.from_numpy(tile_centers(wall)).to(dev)
        normal = torch.from_numpy(np.asarray(wall.n, f32)).to(dev)
        T = num_tiles(wall)
        for ci, s in enumerate(range(0, T, chunk)):
            c = centers[s:s + chunk]
            k = threefry.fold_in(threefry.fold_in(key, wi), ci)
            if general:
                tex = form_factor_chunk(table, c, normal, k, rays)
            else:
                src, direc = ff_rays(c, normal, k, rays)
                _, tex = aa_nearest(table.fields, table.group_counts, src,
                                    direc)
            ids[row0 + s:row0 + s + c.shape[0]] = tex.reshape(-1, rays)
        row0 += T
    return ids


def level0_arena_indices(scene: Scene) -> np.ndarray:
    """Arena texel id of each id-table row."""
    return np.concatenate([
        np.arange(w.base, w.base + num_tiles(w), dtype=np.int64)
        for w in scene.walls
    ])


def relax(src: torch.Tensor, ids: torch.Tensor, l0_idx: torch.Tensor,
          plan: MipmapPlan, cfg: RadiosityConfig) -> torch.Tensor:
    """All `cfg.iterations` gathers and the mipmap rebuild
    (radiosity._make_relax_impl) on the emissive arena `src` [total, 3]
    with the id table `ids` [rows, rays]; returns the final arena. The
    scalars 1 - rho and rho / rays are rounded to float32 as the JAX
    package rounds them."""
    rows, rays = ids.shape
    total = src.shape[0]
    rho = f32(cfg.reflectance)
    keep = float(f32(1.0) - rho)
    gain = float(rho / f32(rays))
    step = max(1, GATHER_IDS // max(rays, 1))
    # a zero row past the arena takes the misses (id -1)
    miss_row = torch.tensor(total, dtype=torch.int64, device=src.device)
    for _ in range(int(cfg.iterations)):
        src_ext = torch.cat([src, src.new_zeros((1, 3))])
        dest_full = torch.zeros_like(src)
        for r0 in range(0, rows, step):
            sl = ids[r0:r0 + step].long()
            sl = torch.where(sl < 0, miss_row, sl)
            dest_full[l0_idx[r0:r0 + step]] = src_ext[sl].sum(1)
        src = src * keep + dest_full * gain
    return apply_plan(src, plan)


def prepare(scene: Scene, cfg: RadiosityConfig, device="cuda"):
    """(extended rects, their table on `device`, the emissive arena
    [total, 3] on `device`): window texels (30,30,30), light texels
    (28,28,32), radiosityNative.c:135-145. The table is the axis-aligned
    `AARects` where `pack_aa` gives one, else the general `Rects` of
    `pack_rects` (a scene with non-axis-aligned rects or a texel arena of
    2^24 or more), as the JAX package's render_radiosity chooses."""
    rects, total, first_window, first_light = extended_rects(scene)
    table = pack_aa(rects, device=device)
    if table is None:
        table = pack_rects(rects, device=device)
    src = np.zeros((total, 3), f32)
    src[first_window:first_light] = np.asarray(cfg.window_emission, f32)
    src[first_light:total] = np.asarray(cfg.light_emission, f32)
    return rects, table, torch.from_numpy(src).to(device)


def render_radiosity(scene: Scene, cfg: RadiosityConfig,
                     device="cuda") -> np.ndarray:
    """Radiosity of the scene's walls on `device`: the [num_texels, 3]
    arena (radiosity.render_radiosity): the axis-aligned form factors
    where the extended rects have a table, else the general ones."""
    rects, table, src = prepare(scene, cfg, device)
    ids = form_factors(scene, table, cfg)
    l0_idx = torch.from_numpy(level0_arena_indices(scene)).to(src.device)
    out = relax(src, ids, l0_idx, build_plan(rects), cfg)
    return out[:scene.num_texels].cpu().numpy()
