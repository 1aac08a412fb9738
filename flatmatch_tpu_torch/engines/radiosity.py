"""Monte-Carlo form-factor radiosity engine.

Counterpart of flatmatch_tpu/engines/radiosity.py: `render_radiosity`
(with `_form_factors_device(use_aa=True, compact_rows=True)` on a scene
with an axis-aligned table, `use_aa=False` on any other) and
`render_radiosity_sharded` (the ray axis over the shards of
parallel/mesh.py), after performRadiosityNative
(radiosityNative.c:92-268):

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
     (the gather one launch of `ops/relax_gather.relax_gather`,
     `csrc/relax_gather.cu`, an iteration and a shard) and one mipmap
     rebuild after the last (the gather reads level-0 ids only, so
     rebuilds between iterations are overwritten unread);
  5. the first num_texels rows (the wall arena) are the result.

The id table lives on the device as int32 [rows, rays], one row per level-0
wall texel in wall order (the JAX package's compact rows): at the CLI
default of 10000 rays, 240 MB on tests/fixtures/mini.png and 3.86 GB on its
4x4 tiling. The kernel streams it once an iteration; the plain version
on the CPU gathers (1 << 22) // rays rows at a time, so no [rows, rays, 3]
tensor is ever made.
"""
from __future__ import annotations

import copy
import dataclasses
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
from ..ops.relax_gather import relax_gather
from ..ops.sampling import TWO_PI_REF, build_base
from ..ops.tile import texel_index
from ..scene.geometry import Scene
from ..scene.rectangle import Rect, num_mipmap_texels, num_tiles
from ..utils.spans import span
from .ao import NUDGE, tile_centers

f32 = np.float32


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


def form_factors(scene: Scene, table, cfg: RadiosityConfig, key=None
                 ) -> torch.Tensor:
    """The source-texel id table [level-0 wall texels, rays] int32 on the
    scene table's device (-1 where the ray escaped). `table` packs the
    EXTENDED rect set: an `AARects` (each chunk one `aa_nearest`) or the
    general `Rects` (`form_factor_chunk`). Chunk ci of wall wi draws with
    key fold_in(fold_in(key, wi), ci), key PRNGKey(seed) by default, as
    the JAX package does.

    A wall's last chunk holds fewer than texels_per_chunk texels; the JAX
    package pads it and discards the padded rows. Element i of a threefry
    draw depends only on the key and i, so drawing the real rows alone
    gives the same rays, and the padding is not traced here."""
    with span("radiosity.form_factors"):
        rays = int(cfg.rays_per_texel)
        chunk = int(cfg.texels_per_chunk)
        general = isinstance(table, Rects)
        dev = table.n.device if general else table.fields.device
        rows = sum(num_tiles(w) for w in scene.walls)
        ids = torch.full((rows, rays), -1, dtype=torch.int32, device=dev)
        if key is None:
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


def relax(src: torch.Tensor, ids, l0_idx: torch.Tensor,
          plan: MipmapPlan, cfg: RadiosityConfig, mesh=None) -> torch.Tensor:
    """All `cfg.iterations` gathers and the mipmap rebuild
    (radiosity._make_relax_impl) on the emissive arena `src` [total, 3]
    with the id table `ids` [rows, rays]; returns the final arena. The
    scalars 1 - rho and rho / rays are rounded to float32 as the JAX
    package rounds them.

    With a `mesh` (parallel/mesh.py), `ids` is the list of the local
    shards' tables [rows, rays_local], each on its shard's device: every
    iteration each shard gathers over its own rays, `mesh.combine` adds
    the partial gathers once, and the relaxation divides by rays_local x
    shards (render_radiosity_sharded)."""
    tables = list(ids) if mesh is not None else [ids]
    rows, rays = tables[0].shape
    if mesh is not None:
        rays *= mesh.size
    rho = f32(cfg.reflectance)
    keep = float(f32(1.0) - rho)
    gain = float(rho / f32(rays))
    with span("radiosity.relax"):
        for _ in range(int(cfg.iterations)):
            parts = [relax_gather(src.to(t.device), t) for t in tables]
            dest = parts[0] if mesh is None else mesh.combine(parts)
            dest_full = torch.zeros_like(src)
            dest_full[l0_idx] = dest.to(src.device)
            src = src * keep + dest_full * gain
    with span("radiosity.mipmap_apply"):
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
    with span("engine.tables"):
        rects, table, src = prepare(scene, cfg, device)
    ids = form_factors(scene, table, cfg)
    with span("engine.tables"):
        l0_idx = torch.from_numpy(level0_arena_indices(scene)).to(src.device)
    with span("radiosity.mipmap_plan"):
        plan = build_plan(rects)
    out = relax(src, ids, l0_idx, plan, cfg)
    with span("engine.readback"):
        return out[:scene.num_texels].cpu().numpy()


def render_radiosity_sharded(scene: Scene, cfg: RadiosityConfig,
                             mesh=None) -> np.ndarray:
    """Radiosity with the ray axis sharded over the mesh
    (radiosity.render_radiosity_sharded): the [num_texels, 3] arena.

    Shard ax casts rays_local = ceil(rays / shards) rays from every
    level-0 texel with the key fold_in(PRNGKey(seed), ax) (chunk ci of
    wall wi: fold_in(fold_in(that key, wi), ci)) and keeps only its own
    [rows, rays_local] slice of the id table on its device: this divides
    the 4 bytes a ray of the table across cards. The form factors run
    `aa_nearest` (csrc/aa_nearest.cu) where the extended rects have an
    axis-aligned table, else the general intersector
    (csrc/general_nearest.cu). Every iteration combines the shards'
    partial gathers once and relaxes with rho / (rays_local x shards);
    the mipmap is rebuilt once, after the last. The same estimator as
    the single-device engine at the same total ray budget; the rays
    differ, so the two agree statistically."""
    from ..parallel.mesh import per_device, photon_mesh

    mesh = mesh or photon_mesh()
    n = mesh.size
    rays_local = -(-int(cfg.rays_per_texel) // n)
    local_cfg = dataclasses.replace(cfg, rays_per_texel=rays_local)
    with span("engine.tables"):
        preps = per_device(mesh, lambda dev: prepare(scene, cfg, dev))
    ids = []
    for ax, dev in mesh.shards():
        key = threefry.fold_in(threefry.prng_key(cfg.seed), ax)
        ids.append(form_factors(scene, preps[dev][1], local_cfg, key))
    rects, _, src = preps[mesh.devices[0]]
    with span("engine.tables"):
        l0_idx = torch.from_numpy(level0_arena_indices(scene)).to(src.device)
    with span("radiosity.mipmap_plan"):
        plan = build_plan(rects)
    out = relax(src, ids, l0_idx, plan, cfg, mesh)
    with span("engine.readback"):
        return out[:scene.num_texels].cpu().numpy()
