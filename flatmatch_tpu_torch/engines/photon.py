"""The general photon engine: brute-force nearest hit over every rect of a
scene of any orientation, in plain PyTorch on [B, N] tensors.

Counterpart of flatmatch_tpu/engines/photon.py, the JAX package's XLA
engine (`--engine photon_xla`, and `photon_pallas` on arenas of 2^24 texels
or more, whose ids the f32 tables cannot hold). Physics as in tracePhoton
(photonmap.cl:161-265): emission from a uniform point, 1e-5 along the ray;
the sky sampler for windows and the cosine sampler for lamps; eight
bounces of nearest hit (ops/intersect.py) with int32 texel ids
(ops/tile.py); Russian roulette at the floor, 75% mirror; a diffuse bounce
resamples the cosine lobe and attenuates by the floor tint, then the
albedo; the deposit is the attenuated color.

The JAX engine has no Pallas kernel: XLA fuses its [B, N] work. Here each
batch runs in tiles of photons (`ops/intersect.rays_per_tile`), so that no
[B, N] tensor passes 128 MB, and writes a deposit stream that
`ops/splat.fused_splat_add` adds into the lightmap with f32 colors: on the
card the int64 fixed-point f32 splat (`csrc/splat_stream.cu`), exact and
the same bits run to run, where the JAX engine adds each bounce with an
f32 scatter-add; on the CPU its plain version, `index_add_` in f32. The draws are the JAX engine's threefry
uniforms (`ops/threefry`, `csrc/threefry.cu` on the card).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import PhotonConfig
from ..ops.device_scene import Emitters, Rects
from ..ops.intersect import nearest_hit, rays_per_tile
from ..ops.linalg import dot3
from ..ops.sampling import TWO_PI_REF, build_base
from ..ops.splat import fused_splat_add, stream_bound
from ..ops.tile import texel_index


class EmitterSlice(NamedTuple):
    """One emitter's fields: [3] tensors and a bool scalar."""

    pos: torch.Tensor
    wvec: torch.Tensor
    hvec: torch.Tensor
    n: torch.Tensor
    color: torch.Tensor
    is_window: torch.Tensor


def _f(x) -> float:
    """A config constant as the f32 value the JAX engine compares with."""
    return float(np.float32(x))


def emit(em: EmitterSlice, uniforms, eps: float):
    """Emission points [B, 3] and directions [B, 3] of a batch (columns 0-1:
    the point on the emitter, photonmap.cl:173-174; columns 2-3: the disk
    sample of the direction, whose u is folded positive for windows,
    photonmap.cl:40-41)."""
    dx, dy = uniforms[:, 0], uniforms[:, 1]
    r = torch.sqrt(uniforms[:, 2])
    phi = _f(TWO_PI_REF) * uniforms[:, 3]
    u = r * torch.cos(phi)
    v = r * torch.sin(phi)
    nz = torch.sqrt(1.0 - r * r)
    u = torch.where(em.is_window, torch.abs(u), u)
    ndir = em.n.expand(uniforms.shape[0], 3)
    udir, vdir = build_base(ndir)
    direc = udir * u[:, None] + vdir * v[:, None] + ndir * nz[:, None]
    pos = (em.pos[None, :] + em.wvec[None, :] * dx[:, None]
           + em.hvec[None, :] * dy[:, None] + direc * eps)
    return pos, direc


def _trace_tile(rects: Rects, em: EmitterSlice, uniforms, pid, n_valid,
                cfg: PhotonConfig, albedo, power):
    """Deposits of photons `pid` (uniforms [C, U]): ids [C, D] int32 (0
    where dead) and colors [C, D, 3] (0 where dead)."""
    eps = _f(cfg.self_intersect_eps)
    dev = uniforms.device
    tint = torch.tensor(np.asarray(cfg.floor_tint, np.float32), device=dev)
    one3 = torch.ones((1, 3), dtype=torch.float32, device=dev)
    C = uniforms.shape[0]

    pos, direc = emit(em, uniforms, eps)
    color = em.color.expand(C, 3).to(torch.float32)
    if power is not None:
        color = color * power
    alive = pid < int(n_valid)
    ids, cols = [], []
    for d in range(cfg.max_depth):
        dist, hit = nearest_hit(pos, direc, rects)
        hitmask = torch.isfinite(dist)
        alive = alive & hitmask
        dist_safe = torch.where(hitmask, dist, torch.zeros_like(dist))
        pos = pos + direc * dist_safe[:, None]
        idx = texel_index(rects, hit, pos)
        n_hit = rects.n[hit.long()]

        u_rr = uniforms[:, 4 + 3 * d]
        u1 = uniforms[:, 5 + 3 * d]
        u2 = uniforms[:, 6 + 3 * d]
        # Russian roulette: diffuse unless at the reflective floor and the
        # 75% mirror branch wins (photonmap.cl:236)
        diffuse = ((pos[:, 2] > _f(cfg.mirror_z_threshold))
                   | (u_rr > _f(cfg.rr_mirror_prob)))
        r = torch.sqrt(u1)
        phi = _f(TWO_PI_REF) * u2
        du = r * torch.cos(phi)
        dv = r * torch.sin(phi)
        dn = torch.sqrt(1.0 - r * r)
        udir, vdir = build_base(n_hit)
        dir_diffuse = (udir * du[:, None] + vdir * dv[:, None]
                       + n_hit * dn[:, None])
        dir_mirror = direc - 2.0 * dot3(n_hit, direc)[:, None] * n_hit
        on_floor = pos[:, 2] < _f(cfg.floor_tint_z_threshold)
        tnt = torch.where(on_floor[:, None], tint[None, :], one3)
        alb = (_f(cfg.albedo) if albedo is None
               else albedo[hit.long()][:, None].to(torch.float32))
        color = torch.where(diffuse[:, None], color * tnt * alb, color)
        direc = torch.where(diffuse[:, None], dir_diffuse, dir_mirror)

        ids.append(torch.where(alive, idx, torch.zeros_like(idx)))
        cols.append(torch.where(alive[:, None], color,
                                torch.zeros_like(color)))
        pos = pos + direc * eps
    return torch.stack(ids, 1), torch.stack(cols, 1)


def trace_deposits(rects: Rects, em: EmitterSlice, uniforms: torch.Tensor,
                   n_valid, cfg: PhotonConfig,
                   albedo: Optional[torch.Tensor] = None,
                   power: Optional[torch.Tensor] = None):
    """The deposits of one batch (uniforms [B, U] f32): texel ids [B, D]
    int32 and colors [B, D, 3] f32, both 0 for a dead photon and for a
    bounce after a miss. `albedo` optionally gives a per-rect [N] albedo in
    place of cfg.albedo; `power` scales the emitter color."""
    B = uniforms.shape[0]
    step = rays_per_tile(rects.n.shape[0])
    pid = torch.arange(B, dtype=torch.int64, device=uniforms.device)
    parts = [_trace_tile(rects, em, uniforms[c0:c0 + step],
                         pid[c0:c0 + step], n_valid, cfg, albedo, power)
             for c0 in range(0, B, step)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def splat_bound(cfg: PhotonConfig, batch: int, power=None) -> float:
    """A bound on a batch's summed deposit colors, which sets the
    fixed-point scale of the f32 splat (ops/splat.stream_bound at this
    batch, times the largest power above 1)."""
    bound = stream_bound(cfg) * max(1.0, batch / cfg.photons_per_batch)
    if power is not None:
        bound *= max(1.0, float(torch.as_tensor(power).abs().max()))
    return bound


def trace_batch(lightmap: torch.Tensor, rects: Rects, em: EmitterSlice,
                uniforms: torch.Tensor, n_valid, cfg: PhotonConfig,
                albedo: Optional[torch.Tensor] = None,
                power: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Trace one batch and add its deposits into `lightmap` [T, 3] in place
    (the JAX engine returns a new array); returns it."""
    idx, col = trace_deposits(rects, em, uniforms, n_valid, cfg, albedo,
                              power)
    fused_splat_add(lightmap, idx.reshape(-1), col.reshape(-1, 3),
                    splat_bound(cfg, uniforms.shape[0], power), bf16=False)
    return lightmap


def render_photons(rects: Rects, emitters: Emitters, num_texels: int,
                   cfg: PhotonConfig, checkpoint_path: str = None,
                   on_segment=None) -> torch.Tensor:
    """Full photon pass on the rect table's device: every window, then
    every light. Returns the raw (un-normalized) [num_texels, 3] lightmap."""
    from .schedule import emitter_slice, run_schedule

    slices = {}

    def trace(lm, e, uniforms, n_valid):
        if e not in slices:
            slices[e] = emitter_slice(emitters, e)
        trace_batch(lm, rects, slices[e], uniforms, n_valid, cfg)

    return run_schedule(trace, emitters, num_texels, cfg,
                        checkpoint_path=checkpoint_path,
                        on_segment=on_segment)
