"""Ambient-occlusion engine (axis-aligned scenes): host tables, the fused
kernel's wrapper and its plain PyTorch version, and the two passes.

Counterpart of flatmatch_tpu/engines/ao.py (`tile_centers`,
`wall_directions`) and flatmatch_tpu/engines/ao_pallas.py. For every wall
texel it fires the 481 geosphere-depth-4 directions rotated into the
surface frame, counts misses as sky at distance 10, and writes
sum_k dist_k * fac_k / (sum_k fac_k * 1.5) in all three channels
(performAmbientOcclusionNative, photonmap.c:436-491); mipmap slots stay 0.

- `render_ao_fused`, the default: one launch of `ao_fused`
  (`csrc/ao_fused.cu`), which makes every ray in the kernel.
- `render_ao` (`--ao-chunked`): rays expanded in chunks on the device and
  cast by `ops/aa_query.nearest_distances` (`csrc/aa_nearest.cu`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import AoConfig
from ..ops.aa_query import (
    check_on, check_table, nearest_distances, nearest_distances_plain,
)
from ..ops.aa_scene import AARects
from ..ops.geosphere import geosphere
from ..scene.geometry import Scene
from ..scene.rectangle import Rect, num_tiles
from ..utils.cuda_build import launch, table_plan

f32 = np.float32
NUDGE = float(f32(1e-5))       # ray origins start 1e-5 along the direction
K_BLOCK = 128                  # directions per pass of the fused kernel
PLAIN_TEXELS = 256             # texels per step of the plain fused version
RAYS_PER_LAUNCH = 1 << 21      # rays per launch of the chunked pass


def _create_base_np(n: np.ndarray):
    """createBase (vector3_cl.c:152-170), host side for one wall normal."""
    c1 = np.array([0, 0, 1], f32)
    if abs(float(np.dot(n, c1))) >= 0.999999:
        c1 = np.array([0, 1, 0], f32)
    c2 = np.cross(c1, n).astype(f32)
    c2 /= np.linalg.norm(c2).astype(f32)
    c1 = np.cross(c2, n).astype(f32)
    c1 /= np.linalg.norm(c1).astype(f32)
    return c1, c2


def wall_directions(n: np.ndarray, level: int) -> np.ndarray:
    """geoSphere directions rotated into the surface frame
    (transformToOrthoNormalBase, photonmap.c:31-48,450-453)."""
    vs = geosphere(level)
    b1, b2 = _create_base_np(n.astype(f32))
    return (
        vs[:, 0:1] * b1[None, :]
        + vs[:, 1:2] * b2[None, :]
        + vs[:, 2:3] * n[None, :].astype(f32)
    ).astype(f32)


def tile_centers(rect: Rect) -> np.ndarray:
    """All level-0 tile centers of a wall [T,3] (getTileCenter,
    rectangle.c:140-154)."""
    wt, ht = rect.wtiles, rect.htiles
    vw = rect.width.astype(f32) / f32(wt)
    vh = rect.height.astype(f32) / f32(ht)
    tx, ty = np.meshgrid(np.arange(wt), np.arange(ht))
    tx = (tx.ravel() + f32(0.5))[:, None]
    ty = (ty.ravel() + f32(0.5))[:, None]
    return (rect.pos[None, :] + vw[None, :] * tx + vh[None, :] * ty).astype(f32)


def _texel_tables(scene: Scene):
    """Level-0 texel centers [T0, 3] in wall order, the wall of each
    texel [T0] int32, and each arena texel's row (gather_idx)."""
    centers = np.concatenate([tile_centers(w) for w in scene.walls])
    wall_of_texel = np.concatenate(
        [np.full(num_tiles(w), i, np.int32) for i, w in enumerate(scene.walls)]
    )
    gather_idx = np.zeros(scene.num_texels, np.int64)
    pos = 0
    for w in scene.walls:
        n = num_tiles(w)
        gather_idx[w.base : w.base + n] = pos + np.arange(n)
        pos += n
    return centers.astype(f32), wall_of_texel, gather_idx


def direction_weights(level: int, multiple: int) -> np.ndarray:
    """[k_pad] f32 weights of the geosphere directions (their z, the
    cosine in the surface frame), zero-padded to a multiple of
    `multiple`."""
    vs = geosphere(level)
    k_pad = -(-len(vs) // multiple) * multiple
    fac = np.zeros(k_pad, f32)
    fac[:len(vs)] = vs[:, 2].astype(f32)
    return fac


def chunk_texels(level: int) -> int:
    """Texels per `nearest_distances` launch of `render_ao` at a geosphere
    level: RAYS_PER_LAUNCH rays of k_pad directions each."""
    return max(1, RAYS_PER_LAUNCH // len(direction_weights(level, 8)))


def _padded_dirs(scene: Scene, level: int, k_pad: int) -> np.ndarray:
    """[walls, k_pad, 3] rotated directions; the padding repeats
    direction 0 (its weight is 0, so it adds exactly +0.0)."""
    out = []
    for w in scene.walls:
        d = wall_directions(w.n, level)
        out.append(np.concatenate(
            [d, np.broadcast_to(d[0:1], (k_pad - len(d), 3))]).astype(f32))
    return np.stack(out)


def ao_fused_write_back(scene: Scene, sums, gather_idx, norm) -> np.ndarray:
    """Gather the fused pass's per-texel sums back into the texel arena
    (grayscale broadcast, photonmap.c:474-475; mipmap slots stay 0)."""
    texels = np.zeros((scene.num_texels, 3), f32)
    for w in scene.walls:
        n = num_tiles(w)
        vals = sums[gather_idx[w.base : w.base + n]] / norm
        texels[w.base : w.base + n] = vals[:, None]
    return texels


# --------------------------------------------------------------------------
# the fused kernel: wrapper and plain version
# --------------------------------------------------------------------------
def ao_fused_plain(fields, group_counts, centers, wall_ids, dirs, fac,
                   sky: float) -> torch.Tensor:
    """Plain version of `ao_fused`, summing each texel's products in the
    kernel's order: per lane j = k mod 128 over k-blocks in order, then a
    halving tree over the 128 lanes."""
    k_pad = dirs.shape[2]
    out = []
    for t0 in range(0, centers.shape[0], PLAIN_TEXELS):
        c = centers[t0:t0 + PLAIN_TEXELS]
        d = dirs[wall_ids[t0:t0 + PLAIN_TEXELS].long()].transpose(1, 2)
        C = c.shape[0]
        origins = (c[:, None, :] + d * NUDGE).reshape(-1, 3)
        dist = nearest_distances_plain(fields, group_counts, origins,
                                       d.reshape(-1, 3), sky)
        prod = (dist.reshape(C, k_pad) * fac).reshape(C, -1, K_BLOCK)
        acc = prod[:, 0]
        for i in range(1, prod.shape[1]):
            acc = acc + prod[:, i]
        w = K_BLOCK // 2
        while w:
            acc = acc[:, :w] + acc[:, w:2 * w]
            w //= 2
        out.append(acc[:, 0])
    return torch.cat(out) if out else centers.new_zeros((0,))


def ao_fused(fields: torch.Tensor, group_counts, centers: torch.Tensor,
             wall_ids: torch.Tensor, dirs: torch.Tensor, fac: torch.Tensor,
             sky: float = 10.0) -> torch.Tensor:
    """Sum over k of dist(center[t] + dirs[w][:, k] * 1e-5, dirs[w][:, k])
    * fac[k] for each texel t of wall w = wall_ids[t]: [T] f32. centers
    [T, 3] f32, wall_ids [T] int32, dirs [walls, 3, k_pad] f32 with k_pad
    a multiple of 128, fac [k_pad] f32; a miss counts as `sky`.

    CUDA tensors launch `csrc/ao_fused.cu` (the port of
    ao_pallas._ao_fused); a failed build or launch raises. CPU tensors run
    the plain version."""
    n = check_table(fields, group_counts)
    dev = fields.device
    if centers.dim() != 2 or centers.shape[1] != 3:
        raise ValueError(f"centers must be [T, 3], got {tuple(centers.shape)}")
    T = centers.shape[0]
    if (wall_ids.dtype != torch.int32 or tuple(wall_ids.shape) != (T,)
            or wall_ids.device != dev or not wall_ids.is_contiguous()):
        raise ValueError(f"wall_ids must be contiguous int32 [{T}] on {dev}")
    if dirs.dim() != 3 or dirs.shape[1] != 3 or dirs.shape[2] % K_BLOCK:
        raise ValueError(f"dirs must be [walls, 3, k_pad] with k_pad a "
                         f"multiple of {K_BLOCK}, got {tuple(dirs.shape)}")
    if tuple(fac.shape) != (dirs.shape[2],):
        raise ValueError(f"fac must be [{dirs.shape[2]}], got "
                         f"{tuple(fac.shape)}")
    check_on(dev, centers=centers, dirs=dirs, fac=fac)
    if dev.type == "cpu":
        return ao_fused_plain(fields, group_counts, centers, wall_ids, dirs,
                              fac, sky)
    sums = torch.empty((T,), dtype=torch.float32, device=dev)
    launch("fm_ao_fused", dev, fields.data_ptr(), centers.data_ptr(),
           wall_ids.data_ptr(), dirs.data_ptr(), fac.data_ptr(),
           sums.data_ptr(), n, *(int(g) for g in group_counts), T,
           dirs.shape[2], f32(sky))
    ao_fused.launches += 1
    return sums


ao_fused.launches = 0


def ao_fused_plan(n_rects: int, device="cuda") -> dict:
    """What `ao_fused` launches for a table of n_rects rects on CUDA device
    `device`, as csrc/ao_fused.cu chooses it (fm_ao_fused_plan): instance
    ("shared" or "device"), shared_bytes, registers, blocks_per_sm. It asks
    the kernel library, so it needs the CUDA build; a CUDA error raises."""
    return table_plan("fm_ao_fused_plan", device, n_rects)


# --------------------------------------------------------------------------
# the two passes
# --------------------------------------------------------------------------
def _ao_fused_prep(scene: Scene, cfg: AoConfig):
    """Host tables of the fused pass: (centers [T0, 3], wall_ids [T0],
    dirs [walls, 3, k_pad], fac [k_pad], gather_idx, norm)."""
    fac = direction_weights(cfg.geosphere_level, K_BLOCK)
    dirs = _padded_dirs(scene, cfg.geosphere_level, len(fac)).transpose(
        0, 2, 1)
    centers, wall_ids, gather_idx = _texel_tables(scene)
    norm = float(fac.sum()) * float(cfg.normalization)
    return (centers, wall_ids, np.ascontiguousarray(dirs), fac, gather_idx,
            norm)


def render_ao_fused(scene: Scene, aa: AARects, cfg: AoConfig) -> np.ndarray:
    """Full AO pass with in-kernel ray synthesis on the scene table's
    device (ao_pallas.render_ao_fused); returns the [num_texels, 3] arena."""
    centers, wall_ids, dirs, fac, gather_idx, norm = _ao_fused_prep(scene,
                                                                    cfg)
    dev = aa.fields.device
    sums = ao_fused(aa.fields, aa.group_counts,
                    torch.from_numpy(centers).to(dev),
                    torch.from_numpy(wall_ids).to(dev),
                    torch.from_numpy(dirs).to(dev),
                    torch.from_numpy(fac).to(dev), float(cfg.sky_distance))
    return ao_fused_write_back(scene, sums.cpu().numpy(), gather_idx, norm)


def render_ao(scene: Scene, aa: AARects, cfg: AoConfig) -> np.ndarray:
    """Full AO pass with rays expanded on the device, `chunk_texels`
    texels per `nearest_distances` launch (ao_pallas.render_ao, the
    chunked path); returns the [num_texels, 3] arena."""
    fac_np = direction_weights(cfg.geosphere_level, 8)
    k_pad = len(fac_np)
    centers, wall_of_texel, _ = _texel_tables(scene)
    dev = aa.fields.device
    fac = torch.from_numpy(fac_np).to(dev)
    dir_tables = torch.from_numpy(
        _padded_dirs(scene, cfg.geosphere_level, k_pad)).to(dev)
    centers_t = torch.from_numpy(centers).to(dev)
    walls_t = torch.from_numpy(wall_of_texel).to(dev).long()
    denom = fac.sum() * float(cfg.normalization)
    T0 = len(centers)
    chunk = chunk_texels(cfg.geosphere_level)
    vals = []
    for s in range(0, T0, chunk):
        c = centers_t[s:s + chunk]
        d = dir_tables[walls_t[s:s + chunk]]          # [C, k_pad, 3]
        origins = (c[:, None, :] + d * NUDGE).reshape(-1, 3)
        dist = nearest_distances(aa.fields, aa.group_counts, origins,
                                 d.reshape(-1, 3).contiguous(),
                                 float(cfg.sky_distance))
        vals.append(torch.sum(dist.reshape(-1, k_pad) * fac, -1) / denom)
    vals = torch.cat(vals).cpu().numpy()

    # write back per wall (grayscale, photonmap.c:474-475)
    texels = np.zeros((scene.num_texels, 3), f32)
    t = 0
    for wall in scene.walls:
        n = num_tiles(wall)
        texels[wall.base : wall.base + n] = vals[t : t + n, None]
        t += n
    return texels
