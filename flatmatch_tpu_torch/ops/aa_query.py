"""Axis-aligned nearest-hit queries: one ray -> nearest front-face distance
and hit texel id, over the [F_AA, N] scene table.

Counterpart of flatmatch_tpu/ops/aa_query.py (`aa_nearest`) and of
flatmatch_tpu/engines/ao_pallas.py `nearest_distances`. Both wrappers launch
`csrc/aa_nearest.cu` for CUDA tensors (one thread per ray; the rect loop is
the photon trace's, `nearest_rect` in `csrc/trace_wide.cuh`) and run the plain
PyTorch version for CPU tensors only. `nearest_hit` is that plain rect loop,
shared with the photon engine's plain trace (engines/photon_wide.py).
"""
from __future__ import annotations

import numpy as np
import torch

from .aa_scene import (
    A_BASE, A_CU, A_CV, A_HLEN, A_HS, A_HT, A_KTU, A_KTV, A_O, A_SN, A_WLEN,
    A_WS, A_WT, F_AA, GROUP_UV,
)
from ..utils.cuda_build import launch, table_plan

MISS = 1e30
PLAIN_RAYS = 1 << 17        # rays per step of the plain versions


def nearest_hit(fields, group_counts, p, dr):
    """Nearest front-face hit over the three axis groups: per group an
    argmin over [rays, rects] (first minimum), then a strict-< merge
    across groups, which keeps the rect loop's first-min tie break.
    `p` and `dr` are (x, y, z) component tensors. Returns (best distance,
    MISS on a miss; texel id, 0 on a miss; hit axis; hit normal sign; the
    winning rect's table column, -1 on a miss)."""
    inv = tuple(torch.reciprocal(x) for x in dr)
    n = p[0].shape[0]
    best = torch.full((n,), MISS, dtype=torch.float32, device=p[0].device)
    btex = torch.zeros((n,), dtype=torch.int32, device=p[0].device)
    baxis = torch.zeros((n,), dtype=torch.int32, device=p[0].device)
    bsign = torch.zeros((n,), dtype=torch.float32, device=p[0].device)
    bslot = torch.full((n,), -1, dtype=torch.int64, device=p[0].device)
    start = 0
    for a in range(3):
        count = group_counts[a]
        if count == 0:
            continue
        first = start
        F = fields[:, start:start + count]
        start += count
        au, av = GROUP_UV[a]
        fac = (F[A_O][None, :] - p[a][:, None]) * inv[a][:, None]
        front = (dr[a] < 0)[:, None] ^ (F[A_SN] < 0)[None, :]
        u = (p[au][:, None] + dr[au][:, None] * fac - F[A_CU]) * F[A_WS]
        v = (p[av][:, None] + dr[av][:, None] * fac - F[A_CV]) * F[A_HS]
        # compare chain: false on NaN, like the JAX min-tree
        valid = (front & (fac >= 0) & (u >= 0) & (F[A_WLEN] - u >= 0)
                 & (v >= 0) & (F[A_HLEN] - v >= 0))
        dist = torch.where(valid, fac, torch.full_like(fac, MISS))
        j = torch.argmin(dist, dim=1)
        jc = j[:, None]
        dmin = dist.gather(1, jc)[:, 0]
        upd = dmin < best
        Fj = F[:, j]
        zero = torch.zeros_like(dmin)
        tx = torch.minimum(torch.floor(u.gather(1, jc)[:, 0] * Fj[A_KTU]),
                           Fj[A_WT] - 1.0)
        ty = torch.minimum(torch.floor(v.gather(1, jc)[:, 0] * Fj[A_KTV]),
                           Fj[A_HT] - 1.0)
        tx = torch.where(upd, tx, zero).to(torch.int32)
        ty = torch.where(upd, ty, zero).to(torch.int32)
        tex = (Fj[A_BASE].to(torch.int32) + ty * Fj[A_WT].to(torch.int32)
               + tx)
        best = torch.where(upd, dmin, best)
        btex = torch.where(upd, tex, btex)
        baxis = torch.where(upd, torch.full_like(baxis, a), baxis)
        bsign = torch.where(upd, Fj[A_SN], bsign)
        bslot = torch.where(upd, j + first, bslot)
    return best, btex, baxis, bsign, bslot


def aa_nearest_plain(fields, group_counts, origins, dirs):
    """Plain version of `aa_nearest`: (best [R], texel id [R], -1 on a
    miss), in steps of PLAIN_RAYS rays."""
    bests, texs = [], []
    for r0 in range(0, origins.shape[0], PLAIN_RAYS):
        o = origins[r0:r0 + PLAIN_RAYS]
        d = dirs[r0:r0 + PLAIN_RAYS]
        best, btex, _, _, _ = nearest_hit(
            fields, group_counts, (o[:, 0], o[:, 1], o[:, 2]),
            (d[:, 0], d[:, 1], d[:, 2]))
        bests.append(best)
        texs.append(torch.where(best < MISS * 0.5, btex,
                                torch.full_like(btex, -1)))
    if not bests:
        empty = origins.new_empty((0,))
        return empty, empty.to(torch.int32)
    return torch.cat(bests), torch.cat(texs)


def nearest_distances_plain(fields, group_counts, origins, dirs,
                            sky: float):
    """Plain version of `nearest_distances`."""
    best, _ = aa_nearest_plain(fields, group_counts, origins, dirs)
    return torch.where(best < MISS * 0.5, best, torch.full_like(best, sky))


def check_table(fields: torch.Tensor, group_counts) -> int:
    """The scene table must be a contiguous f32 [F_AA, N] on the CPU or a
    CUDA device, with group counts summing to N. Returns N."""
    if fields.dim() != 2 or fields.shape[0] != F_AA:
        raise ValueError(f"scene table must be [{F_AA}, N], got "
                         f"{tuple(fields.shape)}")
    n = fields.shape[1]
    if sum(group_counts) != n:
        raise ValueError(f"group_counts {group_counts} do not sum to {n}")
    if fields.dtype != torch.float32 or not fields.is_contiguous():
        raise ValueError("fields must be contiguous float32")
    if fields.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {fields.device}")
    return n


def check_on(dev, **tensors):
    """Each named tensor must be contiguous float32 on `dev`."""
    for name, t in tensors.items():
        if (t.dtype != torch.float32 or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 on {dev}")


def _check_rays(fields, group_counts, origins, dirs):
    n = check_table(fields, group_counts)
    if origins.dim() != 2 or origins.shape[1] != 3:
        raise ValueError(f"origins must be [R, 3], got "
                         f"{tuple(origins.shape)}")
    if tuple(dirs.shape) != tuple(origins.shape):
        raise ValueError(f"dirs {tuple(dirs.shape)} must match origins "
                         f"{tuple(origins.shape)}")
    check_on(fields.device, origins=origins, dirs=dirs)
    if 3 * origins.shape[0] >= 2**31:
        raise ValueError(f"{origins.shape[0]} rays: index past 2^31")
    return n, origins.shape[0]


def _launch_rays(entry, fields, group_counts, origins, dirs, outs, *tail):
    n = fields.shape[1]
    launch(entry, fields.device, fields.data_ptr(), origins.data_ptr(),
           dirs.data_ptr(), *(o.data_ptr() for o in outs), n,
           *(int(g) for g in group_counts), origins.shape[0], *tail)


def aa_nearest(fields: torch.Tensor, group_counts, origins: torch.Tensor,
               dirs: torch.Tensor):
    """Nearest front-face hit of each ray (origins, dirs [R, 3] f32):
    (dist [R] f32, MISS on a miss; texel id [R] int32, -1 on a miss).

    CUDA tensors launch `csrc/aa_nearest.cu` (the port of
    ops/aa_query.aa_nearest); a failed build or launch raises. CPU tensors
    run the plain version."""
    _, R = _check_rays(fields, group_counts, origins, dirs)
    if fields.device.type == "cpu":
        return aa_nearest_plain(fields, group_counts, origins, dirs)
    dist = torch.empty((R,), dtype=torch.float32, device=fields.device)
    tex = torch.empty((R,), dtype=torch.int32, device=fields.device)
    _launch_rays("fm_aa_nearest", fields, group_counts, origins, dirs,
                 (dist, tex))
    aa_nearest.launches += 1
    return dist, tex


aa_nearest.launches = 0


def nearest_distances(fields: torch.Tensor, group_counts,
                      origins: torch.Tensor, dirs: torch.Tensor,
                      sky: float = 10.0) -> torch.Tensor:
    """Nearest-hit distance of each ray (origins, dirs [R, 3] f32), `sky`
    on a miss: [R] f32.

    CUDA tensors launch `csrc/aa_nearest.cu` (the port of
    engines/ao_pallas.nearest_distances); a failed build or launch raises.
    CPU tensors run the plain version."""
    _, R = _check_rays(fields, group_counts, origins, dirs)
    if fields.device.type == "cpu":
        return nearest_distances_plain(fields, group_counts, origins, dirs,
                                       sky)
    dist = torch.empty((R,), dtype=torch.float32, device=fields.device)
    _launch_rays("fm_nearest_distances", fields, group_counts, origins,
                 dirs, (dist,), np.float32(sky))
    nearest_distances.launches += 1
    return dist


nearest_distances.launches = 0


def nearest_plan(n_rects: int, tex: bool = True, device="cuda") -> dict:
    """What `aa_nearest` (tex) or `nearest_distances` launches for a table
    of n_rects rects on CUDA device `device`, as csrc/aa_nearest.cu
    chooses it (fm_nearest_plan): instance ("shared" or "device"),
    shared_bytes, registers, blocks_per_sm. It asks the kernel library, so
    it needs the CUDA build; a CUDA error raises."""
    return table_plan("fm_nearest_plan", device, int(bool(tex)), n_rects)
