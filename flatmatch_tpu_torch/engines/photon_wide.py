"""Axis-aligned photon engine of the default render: host schedule, the CUDA
megakernel's wrapper, and its plain PyTorch version.

Counterpart of flatmatch_tpu/engines/photon_pallas_wide.py on its default
path (device RNG, in-kernel 7-bit splat). One kernel launch per photon batch
traces the batch and sums its dithered 7-bit deposits into an exact int32
texel accumulator; the host de-scales each batch into the float32 lightmap
in the JAX package's batch order (photon_pallas_wide.py:1651-1729).

The kernel is `csrc/trace_splat_wide_rng.cu`. `trace_splat_wide_rng_i8`
launches it for CUDA tensors and runs the plain version
(`trace_deposits_rng_plain` + `splat_i8_plain`) for CPU tensors only.
"""
from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import torch

from ..config import PhotonConfig
from ..ops import rng
from ..ops.aa_scene import (
    A_BASE, A_CU, A_CV, A_HLEN, A_HS, A_HT, A_KTU, A_KTV, A_O, A_SN, A_WLEN,
    A_WS, A_WT, F_AA, GROUP_UV, AARects,
)
from ..ops.device_scene import Emitters

MISS = 1e30
TWO_PI_REF = 2.0 * 3.141592       # ops/sampling.py of the JAX package
THREADS = 256                      # photons per CUDA block
PLAIN_CHUNK = 16384                # photons per step of the plain version
# dynamic shared memory a block may use on sm_90 (232,448 bytes)
MAX_SMEM_RECTS = 232448 // (4 * F_AA)


def unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to flatmatch_tpu_torch yet; the slice runs "
        f"the default photon render only (see ROADMAP.md)"
    )


def check_i8_accumulator(cfg: PhotonConfig, batch_size: int):
    """The int32 accumulator wraps past 2^31; the per-batch worst case is
    batch * max_depth * 127 per texel."""
    worst = int(batch_size) * int(cfg.max_depth) * 127
    if worst >= 2**31:
        raise ValueError(
            f"photons_per_batch={batch_size} x max_depth={cfg.max_depth} "
            f"can overflow the int32 i8-splat accumulator "
            f"({worst} >= 2^31); lower the batch"
        )


def splat_color_scale(cfg: PhotonConfig) -> float:
    """7-bit grid: the brightest emitter channel / 127 bounds every
    deposit (colors only attenuate, photonmap.cl:236-254)."""
    return max(*cfg.window_color, *cfg.light_color) / 127.0


def emitter_vector(emitters: Emitters, e: int) -> torch.Tensor:
    """[16] f32: pos, wvec, hvec, n, color, is_window flag
    (photon_pallas.emitter_vector)."""
    return torch.cat([
        emitters.pos[e], emitters.wvec[e], emitters.hvec[e], emitters.n[e],
        emitters.color[e], emitters.is_window[e].to(torch.float32)[None],
    ]).contiguous()


def tail_batch_size(last_valid: int, batch_size: int) -> int:
    """Physical size of an emitter's tail batch: the live photons rounded
    up to a power-of-two count of blocks, capped at the batch. Draws depend
    only on (batch seed, photon index), so the dropped photons, which are
    all dead, change nothing."""
    blocks = -(-int(last_valid) // THREADS)
    p2 = 1
    while p2 < blocks:
        p2 *= 2
    return min(int(batch_size), p2 * THREADS)


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------
def _normalize(x, y, z):
    # 1/sqrt as reciprocal(sqrt): IEEE-rounded on the CPU and on the card,
    # and what the kernel computes (1.0f / sqrtf)
    inv = torch.reciprocal(torch.sqrt(x * x + y * y + z * z))
    return x * inv, y * inv, z * inv


def _base_cols(nx, ny, nz):
    """build_base (photonmap.cl:43-48) on per-photon components."""
    colinear = torch.abs(nz) >= 0.999999
    zero = torch.zeros_like(nx)
    one = torch.ones_like(nx)
    u0x = zero
    u0y = torch.where(colinear, one, zero)
    u0z = torch.where(colinear, zero, one)
    vx = u0y * nz - u0z * ny
    vy = u0z * nx - u0x * nz
    vz = u0x * ny - u0y * nx
    vx, vy, vz = _normalize(vx, vy, vz)
    ux = vy * nz - vz * ny
    uy = vz * nx - vx * nz
    uz = vx * ny - vy * nx
    ux, uy, uz = _normalize(ux, uy, uz)
    return (ux, uy, uz), (vx, vy, vz)


def _nearest_hit(fields, group_counts, p, dr):
    """Nearest front-face hit over the three axis groups: per group an
    argmin over [photons, rects] (first minimum), then a strict-< merge
    across groups, which keeps the rect loop's first-min tie break."""
    inv = tuple(torch.reciprocal(x) for x in dr)
    n = p[0].shape[0]
    best = torch.full((n,), MISS, dtype=torch.float32, device=p[0].device)
    btex = torch.zeros((n,), dtype=torch.int32, device=p[0].device)
    baxis = torch.zeros((n,), dtype=torch.int32, device=p[0].device)
    bsign = torch.zeros((n,), dtype=torch.float32, device=p[0].device)
    start = 0
    for a in range(3):
        count = group_counts[a]
        if count == 0:
            continue
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
    return best, btex, baxis, bsign


def _trace_chunk(fields, group_counts, em, seed, n_valid, cfg, pid):
    D = cfg.max_depth
    eps = float(np.float32(cfg.self_intersect_eps))
    two_pi = float(np.float32(TWO_PI_REF))
    rr = float(np.float32(cfg.rr_mirror_prob))
    mirror_z = float(np.float32(cfg.mirror_z_threshold))
    tint_z = float(np.float32(cfg.floor_tint_z_threshold))
    tint = [float(np.float32(t)) for t in cfg.floor_tint]
    albedo = float(np.float32(cfg.albedo))

    def draw(c):
        return rng.draw(pid, seed, c)

    epx, epy, epz, ewx, ewy, ewz, ehx, ehy, ehz, enx, eny, enz = (
        em[i] for i in range(12)
    )
    ones = torch.ones(pid.shape, dtype=torch.float32, device=pid.device)
    cr, cg, cb = em[12] * ones, em[13] * ones, em[14] * ones

    # --- emission (photonmap.cl:173-181) -----------------------------------
    dxe = draw(0)
    dye = draw(1)
    r = torch.sqrt(draw(2))
    phi = two_pi * draw(3)
    uu = r * torch.cos(phi)
    vv = r * torch.sin(phi)
    nn = torch.sqrt(1.0 - r * r)
    if float(em[15]) > 0:
        uu = torch.abs(uu)
    (ux, uy, uz), (vx, vy, vz) = _base_cols(enx * ones, eny * ones,
                                            enz * ones)
    dirx = ux * uu + vx * vv + enx * nn
    diry = uy * uu + vy * vv + eny * nn
    dirz = uz * uu + vz * vv + enz * nn
    px = epx + ewx * dxe + ehx * dye + dirx * eps
    py = epy + ewy * dxe + ehy * dye + diry * eps
    pz = epz + ewz * dxe + ehz * dye + dirz * eps

    alive = (pid < n_valid).to(torch.float32)
    idx, col = [], []
    for d in range(D):
        best, btex, baxis, bsign = _nearest_hit(
            fields, group_counts, (px, py, pz), (dirx, diry, dirz)
        )
        hit = best < MISS * 0.5
        alive = alive * hit.to(torch.float32)
        dist = torch.where(hit, best, torch.zeros_like(best))
        px = px + dirx * dist
        py = py + diry * dist
        pz = pz + dirz * dist
        zero = torch.zeros_like(bsign)
        hnx = torch.where(baxis == 0, bsign, zero)
        hny = torch.where(baxis == 1, bsign, zero)
        hnz = torch.where(baxis == 2, bsign, zero)

        # --- Russian roulette + bounce (photonmap.cl:236-254) --------------
        u_rr = draw(4 + 3 * d)
        u1 = draw(5 + 3 * d)
        u2 = draw(6 + 3 * d)
        diffuse = (pz > mirror_z) | (u_rr > rr)
        rd = torch.sqrt(u1)
        phid = two_pi * u2
        duu = rd * torch.cos(phid)
        dvv = rd * torch.sin(phid)
        dnn = torch.sqrt(1.0 - rd * rd)
        (bux, buy, buz), (bvx, bvy, bvz) = _base_cols(hnx, hny, hnz)
        ddx = bux * duu + bvx * dvv + hnx * dnn
        ddy = buy * duu + bvy * dvv + hny * dnn
        ddz = buz * duu + bvz * dvv + hnz * dnn
        ndotd = hnx * dirx + hny * diry + hnz * dirz
        mdx = dirx - 2.0 * ndotd * hnx
        mdy = diry - 2.0 * ndotd * hny
        mdz = dirz - 2.0 * ndotd * hnz
        on_floor = pz < tint_z
        one = torch.ones_like(pz)
        tr = torch.where(on_floor, tint[0] * one, one)
        tg = torch.where(on_floor, tint[1] * one, one)
        tb = torch.where(on_floor, tint[2] * one, one)
        cr = torch.where(diffuse, cr * tr * albedo, cr)
        cg = torch.where(diffuse, cg * tg * albedo, cg)
        cb = torch.where(diffuse, cb * tb * albedo, cb)
        dirx = torch.where(diffuse, ddx, mdx)
        diry = torch.where(diffuse, ddy, mdy)
        dirz = torch.where(diffuse, ddz, mdz)

        # --- deposit ----------------------------------------------------------
        idx.append(torch.where(alive > 0, btex, torch.zeros_like(btex)))
        col.append(torch.stack([cr * alive, cg * alive, cb * alive], -1))

        px = px + dirx * eps
        py = py + diry * eps
        pz = pz + dirz * eps
    return torch.stack(idx, 1), torch.stack(col, 1)


def trace_deposits_rng_plain(
    fields: torch.Tensor, group_counts, em_vec: torch.Tensor, seed: int,
    n_valid: int, batch_size: int, cfg: PhotonConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deposit stream of one batch with the counter-hash draws: texel ids
    [B, D] int32 (0 for dead photons) and colors [B, D, 3] f32 (0 for dead
    photons). Same photons as photon_pallas_wide.trace_deposits_wide_rng."""
    dev = fields.device
    idx, col = [], []
    for c0 in range(0, int(batch_size), PLAIN_CHUNK):
        pid = torch.arange(c0, min(c0 + PLAIN_CHUNK, int(batch_size)),
                           dtype=torch.int64, device=dev)
        i, c = _trace_chunk(fields, group_counts, em_vec, int(seed),
                            int(n_valid), cfg, pid)
        idx.append(i)
        col.append(c)
    return torch.cat(idx), torch.cat(col)


def splat_i8_plain(idx: torch.Tensor, col: torch.Tensor, num_texels: int,
                   inv_s: float, out: torch.Tensor = None) -> torch.Tensor:
    """Quantize a deposit stream to the 7-bit grid with the kernel's dither
    keys (photon p, bounce d, channel ch: p*3D + 3d + ch) and sum it exactly
    into an int32 [num_texels, 3] accumulator."""
    B, D = idx.shape
    dev = idx.device
    p = torch.arange(B, dtype=torch.int64, device=dev)[:, None, None]
    d = torch.arange(D, dtype=torch.int64, device=dev)[None, :, None]
    ch = torch.arange(3, dtype=torch.int64, device=dev)[None, None, :]
    key = rng.dither_key(p, D, d, ch)
    q = torch.clamp(torch.floor(col * inv_s + rng.dither(key)), 0.0, 127.0)
    acc = out if out is not None else torch.zeros(
        (num_texels, 3), dtype=torch.int32, device=dev)
    flat = (idx.to(torch.int64)[:, :, None] * 3 + ch).reshape(-1)
    acc.view(-1).index_add_(0, flat, q.to(torch.int32).reshape(-1))
    return acc


# --------------------------------------------------------------------------
# the kernel's wrapper
# --------------------------------------------------------------------------
def trace_splat_wide_rng_i8(
    fields: torch.Tensor, group_counts, em_vec: torch.Tensor, seed: int,
    n_valid: int, batch_size: int, cfg: PhotonConfig, num_texels: int,
    out: torch.Tensor = None,
) -> torch.Tensor:
    """Trace one batch and return its int32 [num_texels, 3] accumulator of
    7-bit deposits (de-scale with `splat_color_scale(cfg)`).

    CUDA tensors launch `csrc/trace_splat_wide_rng.cu` (the port of
    photon_pallas_wide.trace_splat_wide_rng(i8=True)); a failed build or
    launch raises. CPU tensors run the plain version. `out`, if given, is
    zeroed and filled."""
    if fields.dim() != 2 or fields.shape[0] != F_AA:
        raise ValueError(f"scene table must be [{F_AA}, N], got "
                         f"{tuple(fields.shape)}")
    n = fields.shape[1]
    if sum(group_counts) != n:
        raise ValueError(f"group_counts {group_counts} do not sum to {n}")
    if tuple(em_vec.shape) != (16,):
        raise ValueError(f"em_vec must be [16], got {tuple(em_vec.shape)}")
    dev = fields.device
    for name, t, dt in (("fields", fields, torch.float32),
                        ("em_vec", em_vec, torch.float32)):
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dt} on {dev}")
    if not 0 <= int(n_valid) <= int(batch_size):
        raise ValueError(f"n_valid={n_valid} outside [0, {batch_size}]")
    check_i8_accumulator(cfg, batch_size)
    if out is None:
        out = torch.zeros((num_texels, 3), dtype=torch.int32, device=dev)
    else:
        if (out.dtype != torch.int32 or out.device != dev
                or tuple(out.shape) != (num_texels, 3)
                or not out.is_contiguous()):
            raise ValueError(f"out must be contiguous int32 "
                             f"[{num_texels}, 3] on {dev}")
        out.zero_()
    inv_s = float(np.float32(1.0 / splat_color_scale(cfg)))

    if dev.type == "cpu":
        idx, col = trace_deposits_rng_plain(
            fields, group_counts, em_vec, seed, n_valid, batch_size, cfg
        )
        return splat_i8_plain(idx, col, num_texels, inv_s, out)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if n > MAX_SMEM_RECTS:
        raise ValueError(f"{n} rects exceed the kernel's shared-memory scene "
                         f"table ({MAX_SMEM_RECTS} rects)")
    from ..utils.cuda_build import load_library

    lib = load_library()
    f = np.float32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fm_trace_splat_wide_rng_i8(
            fields.data_ptr(), em_vec.data_ptr(), out.data_ptr(),
            n, *(int(g) for g in group_counts), int(rng.wrap_i32(int(seed))),
            int(n_valid), int(cfg.max_depth), int(num_texels),
            f(cfg.self_intersect_eps), f(TWO_PI_REF), f(cfg.rr_mirror_prob),
            f(cfg.mirror_z_threshold), f(cfg.floor_tint_z_threshold),
            *(f(t) for t in cfg.floor_tint), f(cfg.albedo), f(inv_s),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"trace_splat_wide_rng kernel launch failed: "
                           f"CUDA error {err}")
    trace_splat_wide_rng_i8.launches += 1
    return out


trace_splat_wide_rng_i8.launches = 0


# --------------------------------------------------------------------------
# host side
# --------------------------------------------------------------------------
def compact_aa(aa: AARects, num_texels: int):
    """Re-base the scene so deposits land in a compact level-0-only arena
    (mipmap slots excluded). Returns (aa_compact, compact_total, expand)
    where expand(compact_lightmap) -> arena lightmap
    (photon_pallas_wide.compact_aa)."""
    fields = aa.fields.cpu().numpy()
    wt = fields[A_WT].astype(np.int64)
    ht = fields[A_HT].astype(np.int64)
    arena_base = fields[A_BASE].astype(np.int64)
    counts = wt * ht
    cbase = np.zeros_like(counts)
    cbase[1:] = np.cumsum(counts)[:-1]
    total = int(counts.sum())
    fields_c = fields.copy()
    fields_c[A_BASE] = cbase.astype(np.float32)
    dev = aa.fields.device
    aa_c = AARects(fields=torch.from_numpy(fields_c).to(dev),
                   group_counts=aa.group_counts, perm=aa.perm)
    positions = np.concatenate(
        [np.arange(a0, a0 + n) for a0, n in zip(arena_base, counts)]
        or [np.zeros(0, np.int64)]
    )
    pos_t = torch.from_numpy(positions).to(dev)

    def expand(compact_lm: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((num_texels, 3), dtype=torch.float32,
                          device=compact_lm.device)
        out[pos_t] = compact_lm
        return out

    return aa_c, total, expand


def emitter_schedule(counts, batch_size: int) -> List[tuple]:
    """(emitter, base batch, batches, live photons of the last batch) for
    every emitter with photons, in dispatch order."""
    B = int(batch_size)
    schedule, base_batch = [], 0
    for e, n in enumerate(np.asarray(counts)):
        n = int(n)
        if n == 0:
            continue
        n_batches = (n + B - 1) // B
        schedule.append((e, base_batch, n_batches, n - (n_batches - 1) * B))
        base_batch += n_batches
    return schedule


def render_all_wide(fields, group_counts, emitters: Emitters,
                    cfg: PhotonConfig, batch_size: int, schedule,
                    num_texels: int) -> torch.Tensor:
    """The whole emitter schedule: one kernel launch per batch, each batch's
    int32 accumulator de-scaled into the f32 lightmap in batch order
    (photon_pallas_wide._render_all_wide). The tail batch of each emitter
    runs at `tail_batch_size`."""
    dev = fields.device
    B = int(batch_size)
    lm = torch.zeros((num_texels, 3), dtype=torch.float32, device=dev)
    acc = torch.empty((num_texels, 3), dtype=torch.int32, device=dev)
    scale = float(np.float32(splat_color_scale(cfg)))
    for e, base_batch, n_batches, last_valid in schedule:
        ev = emitter_vector(emitters, e)
        for i in range(n_batches):
            last = i == n_batches - 1
            trace_splat_wide_rng_i8(
                fields, group_counts, ev,
                rng.batch_seed(cfg.seed, base_batch + i),
                last_valid if last else B,
                tail_batch_size(last_valid, B) if last else B,
                cfg, num_texels, out=acc,
            )
            lm += acc.to(torch.float32) * scale
    return lm


def render_photons(emitters: Emitters, num_texels: int, cfg: PhotonConfig,
                   aa: AARects) -> torch.Tensor:
    """Full photon pass: the raw (un-normalized) [num_texels, 3] lightmap
    on the scene table's device (photon_pallas_wide.render_photons)."""
    if cfg.splat != "inkernel_i8":
        raise unsupported(f"splat={cfg.splat!r}")
    if not cfg.device_rng:
        raise unsupported("the threefry draws (device_rng=False)")
    B = int(cfg.photons_per_batch)
    if B < 1:
        raise ValueError(f"photons_per_batch must be >= 1, got {B}")
    check_i8_accumulator(cfg, B)
    aa_c, total_c, expand = compact_aa(aa, num_texels)
    schedule = emitter_schedule(emitters.counts, B)
    compact_lm = render_all_wide(aa_c.fields, aa_c.group_counts, emitters,
                                 cfg, B, schedule, total_c)
    return expand(compact_lm)
