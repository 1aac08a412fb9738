"""Axis-aligned photon engine: host schedule, the CUDA kernels' wrappers,
and their plain PyTorch versions.

Counterpart of flatmatch_tpu/engines/photon_pallas_wide.py on its in-kernel
tiers (7-bit and f32, with either draw source) and its deposit-stream tier.
The host de-scales, adds or splats each batch into the float32 lightmap in
the JAX package's batch order (photon_pallas_wide.py:1651-1729). Per photon
batch:

- `trace_splat_wide_rng_i8` (`csrc/trace_splat_wide_rng.cu`): the CLI's
  default render (device RNG, `inkernel_i8`). It traces the batch and sums
  its dithered 7-bit deposits into an exact int32 texel accumulator.
- `trace_splat_wide_rng_f32`, `trace_splat_wide_i8` and
  `trace_splat_wide_f32` (`csrc/trace_splat_wide.cu`): the other in-kernel
  routes, `--splat inkernel` (bf16 colors summed in f32: an int64
  fixed-point sum converted once to an f32 increment) with the counter
  hash, and both splats with threefry uniforms passed in
  (`--no-device-rng`).
- `trace_deposits_wide_rng` and `trace_deposits_wide`
  (`csrc/trace_deposits_wide.cu`): the same trace writing a deposit stream
  in the JAX package's row order (`stream_block`), with the counter-hash
  draws or with threefry uniforms passed in (`ops/threefry.batch_uniforms`,
  the library default). `ops/splat.splat_stream` then sums the stream
  (`--splat fused`, `fused_i8`, `scatter`, `bucket`, `bucket_exact`).
- `trace_splat_wide_diff_rng_i8` and `trace_splat_wide_diff_rng_f32`
  (`csrc/trace_splat_wide_diff_rng.cu`): the forward of the differentiable
  render, with a per-slot albedo and a grid set at run time;
  `trace_splat_wide_diff_i8` and `trace_splat_wide_diff_f32`, the same
  with threefry uniforms passed in (`fit --no-device-rng`).
- `trace_fold_wide_rng` and `trace_fold_wide`
  (`csrc/trace_fold_wide_rng.cu`): its backward, which replays the batch
  and folds the lightmap cotangent into per-slot albedo cotangents and the
  batch's <g, lightmap> total, with either draw source.
- `trace_deposits_wide_diff` (`csrc/trace_deposits_wide.cu`): the diff
  render's deposit stream, with each row's diffuse-hit slot (`fit --splat
  scatter|bucket|bucket_exact`).

The uniforms-in wrappers take the batch's [B, U] uniforms, or with
`transposed` their [U, B] transpose, the layout their kernels read (which
`ops/threefry.batch_uniforms(..., transposed=True)` draws directly). Each
wrapper launches its kernel for CUDA tensors and runs the plain version
(the plain trace, `trace_deposits_rng_plain`, `trace_uniforms_plain` or
`trace_deposits_wide_plain`, with `splat_i8_plain`,
`ops/splat.fused_splat_plain` or `fold_plain`) for CPU tensors only. The
kernels stage the scene table in shared memory, or read it from device
memory when it does not fit, so no scene is refused for its rect count;
only the fold's own shared buffers cap it (`fold_max_rects`).
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from ..config import PhotonConfig
from ..ops import rng, threefry
from ..ops.aa_query import MISS, check_on, check_table, nearest_hit
from ..ops.aa_scene import A_BASE, A_HT, A_WT, F_AA, AARects
from ..ops.device_scene import Emitters
from ..ops.sampling import TWO_PI_REF, base_cols
from ..ops.splat import (
    STREAM_MODES, fixed_point_scale, fused_splat_plain, splat_color_scale,
    splat_stream, stream_bound,
)
from ..utils.cuda_build import SMEM_LIMIT, check_smem, launch

THREADS = 256                      # photons per CUDA block
WARPS = THREADS // 32
PLAIN_CHUNK = 16384                # photons per step of the plain version
LANES = 128                        # the JAX engine's batch quantum
MAX_SUBLANES = 64                  # the JAX engine's photon-block height
INKERNEL_MODES = ("inkernel", "inkernel_i8")


def unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to flatmatch_tpu_torch yet; the port runs "
        f"the photon render (both general engines on any scene, every "
        f"splat on axis-aligned ones), the ambient-occlusion engine, and "
        f"the fit and the radiosity engine on axis-aligned scenes (see "
        f"ROADMAP.md)"
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


def emitter_vector(emitters: Emitters, e: int) -> torch.Tensor:
    """[16] f32: pos, wvec, hvec, n, color, is_window flag
    (photon_pallas.emitter_vector)."""
    return torch.cat([
        emitters.pos[e], emitters.wvec[e], emitters.hvec[e], emitters.n[e],
        emitters.color[e], emitters.is_window[e].to(torch.float32)[None],
    ]).contiguous()


def uniforms_per_photon(max_depth: int) -> int:
    """Draw columns per photon: [dx, dy, dir_u1, dir_u2, (rr, u1, u2) x
    depth] (engines/photon.py:56)."""
    return 4 + 3 * int(max_depth)


def stream_block(batch_size: int) -> int:
    """Photons per block of the deposit stream's row order: the JAX wide
    engine's TB = S * 128 with S = 64 halved until TB divides the batch
    (photon_pallas_wide.py:1755-1764). Row (b * D + d) * TB + w holds photon
    b * TB + w at bounce d."""
    B = int(batch_size)
    if B < 1 or B % LANES:
        raise ValueError(f"photons_per_batch must be a positive multiple of "
                         f"{LANES} for the deposit-stream tier (got {B})")
    s = MAX_SUBLANES
    while s > 1 and B % (s * LANES):
        s //= 2
    return s * LANES


def tail_batch_size(last_valid: int, batch_size: int,
                    quantum: int = THREADS) -> int:
    """Physical size of an emitter's tail batch: the live photons rounded
    up to a power-of-two count of `quantum`-photon blocks, capped at the
    batch. Draws depend only on (batch seed or key, photon index), so the
    dropped photons, which are all dead, change nothing."""
    blocks = -(-int(last_valid) // int(quantum))
    p2 = 1
    while p2 < blocks:
        p2 *= 2
    return min(int(batch_size), p2 * int(quantum))


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------
def aa_nearest(fields, group_counts):
    """The nearest-hit query of `_trace_chunk` over the axis-aligned table:
    nearest(p, dr) -> (best distance, MISS on a miss; texel id; hit normal
    (x, y, z); the winning rect's table column)."""
    def nearest(p, dr):
        best, btex, baxis, bsign, bslot = nearest_hit(fields, group_counts,
                                                      p, dr)
        zero = torch.zeros_like(bsign)
        hn = tuple(torch.where(baxis == a, bsign, zero) for a in range(3))
        return best, btex, hn, bslot
    return nearest


def _trace_chunk(nearest, em, draw, n_valid, cfg, pid, albedo_aa=None):
    """Trace photons `pid` (in-batch indices) with the nearest-hit query
    `nearest` (`aa_nearest`, or the general engine's); draw(c) returns
    their draw column c."""
    D = cfg.max_depth
    eps = float(np.float32(cfg.self_intersect_eps))
    two_pi = float(np.float32(TWO_PI_REF))
    rr = float(np.float32(cfg.rr_mirror_prob))
    mirror_z = float(np.float32(cfg.mirror_z_threshold))
    tint_z = float(np.float32(cfg.floor_tint_z_threshold))
    tint = [float(np.float32(t)) for t in cfg.floor_tint]
    albedo = float(np.float32(cfg.albedo))

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
    (ux, uy, uz), (vx, vy, vz) = base_cols(enx * ones, eny * ones,
                                           enz * ones)
    dirx = ux * uu + vx * vv + enx * nn
    diry = uy * uu + vy * vv + eny * nn
    dirz = uz * uu + vz * vv + enz * nn
    px = epx + ewx * dxe + ehx * dye + dirx * eps
    py = epy + ewy * dxe + ehy * dye + diry * eps
    pz = epz + ewz * dxe + ehz * dye + dirz * eps

    alive = (pid < n_valid).to(torch.float32)
    idx, col, ridx = [], [], []
    for d in range(D):
        best, btex, (hnx, hny, hnz), bslot = nearest((px, py, pz),
                                                      (dirx, diry, dirz))
        hit = best < MISS * 0.5
        alive = alive * hit.to(torch.float32)
        dist = torch.where(hit, best, torch.zeros_like(best))
        px = px + dirx * dist
        py = py + diry * dist
        pz = pz + dirz * dist

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
        (bux, buy, buz), (bvx, bvy, bvz) = base_cols(hnx, hny, hnz)
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
        # per-slot albedo of the winning rect (diff tier,
        # photon_pallas_wide.py:373-379), in the order c * tint * albedo
        alb = albedo if albedo_aa is None else torch.where(
            bslot >= 0, albedo_aa[bslot.clamp(min=0)], albedo)
        cr = torch.where(diffuse, cr * tr * alb, cr)
        cg = torch.where(diffuse, cg * tg * alb, cg)
        cb = torch.where(diffuse, cb * tb * alb, cb)
        dirx = torch.where(diffuse, ddx, mdx)
        diry = torch.where(diffuse, ddy, mdy)
        dirz = torch.where(diffuse, ddz, mdz)

        # --- deposit ----------------------------------------------------------
        idx.append(torch.where(alive > 0, btex, torch.zeros_like(btex)))
        col.append(torch.stack([cr * alive, cg * alive, cb * alive], -1))
        # slot whose albedo multiplied into this and every later deposit
        ridx.append(torch.where(diffuse & (alive > 0), bslot,
                                torch.full_like(bslot, -1)).to(torch.int32))

        px = px + dirx * eps
        py = py + diry * eps
        pz = pz + dirz * eps
    return torch.stack(idx, 1), torch.stack(col, 1), torch.stack(ridx, 1)


def trace_deposits_rng_plain(
    fields: torch.Tensor, group_counts, em_vec: torch.Tensor, seed: int,
    n_valid: int, batch_size: int, cfg: PhotonConfig,
    albedo_aa: torch.Tensor = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deposit stream of one batch with the counter-hash draws: texel ids
    [B, D] int32 (0 for dead photons), colors [B, D, 3] f32 (0 for dead
    photons) and the diffuse-hit slots [B, D] int32 (the winning rect's
    table column at a diffuse hit of a live photon, -1 otherwise). Same
    photons as photon_pallas_wide.trace_deposits_wide_rng. With `albedo_aa`
    [N] a diffuse hit on slot j multiplies by albedo_aa[j] instead of
    cfg.albedo, as the diff kernels do."""
    return trace_plain(aa_nearest(fields, group_counts), em_vec, n_valid,
                       batch_size, cfg,
                       lambda pid: lambda c: rng.draw(pid, int(seed), c),
                       albedo_aa)


def trace_plain(nearest, em_vec, n_valid, batch_size, cfg, draws,
                albedo_aa=None, chunk=PLAIN_CHUNK):
    """The plain trace of a batch on em_vec's device in chunks of `chunk`
    photons, with the nearest-hit query `nearest`; draws(pid) gives the
    draw function of photons pid."""
    idx, col, ridx = [], [], []
    for c0 in range(0, int(batch_size), int(chunk)):
        pid = torch.arange(c0, min(c0 + int(chunk), int(batch_size)),
                           dtype=torch.int64, device=em_vec.device)
        i, c, r = _trace_chunk(nearest, em_vec, draws(pid), int(n_valid),
                               cfg, pid, albedo_aa)
        idx.append(i)
        col.append(c)
        ridx.append(r)
    return torch.cat(idx), torch.cat(col), torch.cat(ridx)


def stream_rows(idx: torch.Tensor, col: torch.Tensor, block: int,
                ridx: torch.Tensor = None):
    """Photon-major deposits (idx [B, D], col [B, D, 3], and the diff
    tier's slots ridx [B, D] if given) -> the stream (idx [B * D],
    col [B * D, 3], ridx [B * D]) in the JAX row order of `stream_block`."""
    B, D = idx.shape
    nb = B // int(block)

    def rows(x):
        return (x.reshape(nb, block, D, *x.shape[2:]).transpose(1, 2)
                .reshape(B * D, *x.shape[2:]).contiguous())

    out = (rows(idx), rows(col))
    return out if ridx is None else out + (rows(ridx),)


def uniform_draws(uniforms: torch.Tensor):
    """The draws of `trace_plain` from a [B, U] uniforms tensor: photon p
    draws its column c from uniforms[p, c]."""
    return lambda pid: lambda c: uniforms[pid, c]


def trace_uniforms_plain(
    fields: torch.Tensor, group_counts, em_vec: torch.Tensor,
    uniforms: torch.Tensor, n_valid: int, cfg: PhotonConfig,
    albedo_aa: torch.Tensor = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`trace_deposits_rng_plain` with the draws passed in: photon p draws
    column c from uniforms[p, c] ([B, U] f32). Returns photon-major (idx
    [B, D], col [B, D, 3], ridx [B, D])."""
    return trace_plain(aa_nearest(fields, group_counts), em_vec, n_valid,
                       uniforms.shape[0], cfg, uniform_draws(uniforms),
                       albedo_aa)


def trace_deposits_wide_plain(
    fields: torch.Tensor, group_counts, em_vec: torch.Tensor,
    uniforms: torch.Tensor, n_valid: int, cfg: PhotonConfig,
    block: int = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `trace_deposits_wide`: the stream of one batch whose
    photon p draws its column c from uniforms[p, c] ([B, U] f32)."""
    idx, col, _ = trace_uniforms_plain(fields, group_counts, em_vec,
                                       uniforms, n_valid, cfg)
    return stream_rows(idx, col, block or stream_block(uniforms.shape[0]))


def trace_deposits_wide_diff_plain(
    fields: torch.Tensor, group_counts, albedo_aa: torch.Tensor,
    em_vec: torch.Tensor, uniforms: torch.Tensor, n_valid: int,
    cfg: PhotonConfig, block: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of `trace_deposits_wide_diff`: the diff stream (idx,
    col, ridx) of one batch in the row order of `block`."""
    idx, col, ridx = trace_uniforms_plain(fields, group_counts, em_vec,
                                          uniforms, n_valid, cfg, albedo_aa)
    return stream_rows(idx, col, block, ridx)


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


def splat_f32_plain(idx: torch.Tensor, col: torch.Tensor,
                    num_texels: int) -> torch.Tensor:
    """The in-kernel f32 splat of a photon-major deposit stream (idx [B, D],
    col [B, D, 3]): colors rounded to bf16 once and summed in f32
    (`ops/splat.fused_splat_plain`, `index_add_`'s order)."""
    return fused_splat_plain(idx.reshape(-1), col.reshape(-1, 3), num_texels)


def trace_splat_wide_rng_f32_plain(
    fields: torch.Tensor, group_counts, em_vec: torch.Tensor, seed: int,
    n_valid: int, batch_size: int, cfg: PhotonConfig, num_texels: int,
    albedo_aa: torch.Tensor = None,
) -> torch.Tensor:
    """Plain version of `trace_splat_wide_rng_f32` and, with `albedo_aa`,
    of `trace_splat_wide_diff_rng_f32`: the plain trace, `splat_f32_plain`."""
    idx, col, _ = trace_deposits_rng_plain(fields, group_counts, em_vec, seed,
                                           n_valid, batch_size, cfg,
                                           albedo_aa)
    return splat_f32_plain(idx, col, num_texels)


def trace_splat_wide_plain(
    fields: torch.Tensor, group_counts, em_vec: torch.Tensor,
    uniforms: torch.Tensor, n_valid: int, cfg: PhotonConfig,
    num_texels: int, i8: bool, out: torch.Tensor = None,
) -> torch.Tensor:
    """Plain version of `trace_splat_wide_i8` (the int32 accumulator, into
    `out` if given) and `trace_splat_wide_f32` (the f32 increment)."""
    idx, col, _ = trace_uniforms_plain(fields, group_counts, em_vec,
                                       uniforms, n_valid, cfg)
    if i8:
        inv_s = float(np.float32(1.0 / splat_color_scale(cfg)))
        return splat_i8_plain(idx, col, num_texels, inv_s, out)
    return splat_f32_plain(idx, col, num_texels)


def splat_diff_i8_plain(idx: torch.Tensor, col: torch.Tensor,
                        num_texels: int, inv_scale: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """The diff forward's lightmap increment of one batch: the 7-bit splat
    on the run-time grid `inv_scale`, de-scaled by `scale` (f32 scalars,
    photon_pallas_wide.py:1316-1317)."""
    acc = splat_i8_plain(idx, col, num_texels, float(inv_scale))
    return acc.to(torch.float32) * scale


def fold_plain(idx: torch.Tensor, col: torch.Tensor, ridx: torch.Tensor,
               g_c: torch.Tensor, n_slots: int):
    """The replay backward's fold of one batch's deposit stream (the fold
    of photon_pallas_wide._make_kernel, :588-629 and :652-685):
    w = <bf16(g)[idx], col> in channel order, its inclusive suffix sums S
    over bounces, da[slot] += S at every diffuse hit, w_sum = sum S(p, 0).
    g is rounded to bf16 once, the fold's only rounding (cotangent_t).
    Returns (da_slots [n_slots], w_sum), undivided."""
    g = g_c.to(torch.bfloat16).to(torch.float32)
    gi = g[idx.to(torch.int64)]                              # [B, D, 3]
    w = (gi[..., 0] * col[..., 0] + gi[..., 1] * col[..., 1]
         + gi[..., 2] * col[..., 2])
    suf = torch.empty_like(w)
    run = torch.zeros_like(w[:, 0])
    for d in reversed(range(w.shape[1])):
        run = run + w[:, d]
        suf[:, d] = run
    hit = ridx >= 0
    da = torch.zeros((n_slots,), dtype=torch.float32, device=w.device)
    da.index_add_(0, ridx[hit].to(torch.int64), suf[hit])
    return da, suf[:, 0].sum()


# --------------------------------------------------------------------------
# the kernels' wrappers
# --------------------------------------------------------------------------
def _check_batch(fields, group_counts, em_vec, n_valid, batch_size,
                 **more) -> int:
    """Checks shared by the three wrappers; `more` names further f32
    tensors that must lie contiguous on the scene table's device. Returns
    the rect count N."""
    n = check_table(fields, group_counts)
    if tuple(em_vec.shape) != (16,):
        raise ValueError(f"em_vec must be [16], got {tuple(em_vec.shape)}")
    check_on(fields.device, em_vec=em_vec, **more)
    if not 0 <= int(n_valid) <= int(batch_size):
        raise ValueError(f"n_valid={n_valid} outside [0, {batch_size}]")
    return n


def _check_albedo(albedo_aa, n):
    if tuple(albedo_aa.shape) != (n,):
        raise ValueError(f"albedo_aa must be [{n}], got "
                         f"{tuple(albedo_aa.shape)}")


def _check_uniforms(fields, group_counts, em_vec, uniforms, n_valid, cfg,
                    transposed=False, **more):
    """Checks of the uniforms-in wrappers: uniforms [B, U] f32 (with
    `transposed`, [U, B]), U = 4 + 3 * max_depth, contiguous on the scene
    table's device; `more` as in `_check_batch`. Returns (N, B)."""
    U = uniforms_per_photon(cfg.max_depth)
    want = "[U, B]" if transposed else "[B, U]"
    if uniforms.dim() != 2 or uniforms.shape[0 if transposed else 1] != U:
        raise ValueError(f"uniforms must be {want} with U = {U}, got "
                         f"{tuple(uniforms.shape)}")
    B = uniforms.shape[1 if transposed else 0]
    n = _check_batch(fields, group_counts, em_vec, n_valid, B,
                     uniforms=uniforms, **more)
    return n, B


def _uniforms_of(uniforms, transposed):
    """(the [B, U] view the plain versions read, the [U, B] tensor the
    kernels read); the second is made only on a CUDA device."""
    if transposed:
        return uniforms.t(), uniforms
    if uniforms.device.type == "cpu":
        return uniforms, None
    return uniforms, uniforms.t().contiguous()


def _check_acc(out, num_texels, dev):
    if out is None:
        return torch.zeros((num_texels, 3), dtype=torch.int32, device=dev)
    if (out.dtype != torch.int32 or out.device != dev
            or tuple(out.shape) != (num_texels, 3) or not out.is_contiguous()):
        raise ValueError(f"out must be contiguous int32 [{num_texels}, 3] "
                         f"on {dev}")
    return out.zero_()


def _trace_args(fields, group_counts, seed, n_valid, cfg, num_texels):
    """The C entry points' shared scalar arguments, from n_rects to the
    scalar albedo."""
    f = np.float32
    return (
        fields.shape[1], *(int(g) for g in group_counts),
        int(rng.wrap_i32(int(seed))), int(n_valid), int(cfg.max_depth),
        int(num_texels), f(cfg.self_intersect_eps), f(TWO_PI_REF),
        f(cfg.rr_mirror_prob), f(cfg.mirror_z_threshold),
        f(cfg.floor_tint_z_threshold), *(f(t) for t in cfg.floor_tint),
        f(cfg.albedo),
    )


def _launch_f32(entry, dev, num_texels, head, tail):
    """Launch an in-kernel f32 entry point: `head` are its arguments before
    the int64 [T, 3] scratch and the f32 [T, 3] output it writes, `tail`
    those after. Returns the output, the batch's lightmap increment."""
    if not 0 <= 3 * int(num_texels) < 2**31:
        raise ValueError(f"num_texels={num_texels} out of range")
    acc = torch.empty((num_texels, 3), dtype=torch.int64, device=dev)
    out = torch.empty((num_texels, 3), dtype=torch.float32, device=dev)
    launch(entry, dev, *head, acc.data_ptr(), out.data_ptr(), *tail)
    return out


def _stream_fixed(cfg: PhotonConfig):
    """(2^k, 2^-k) of the stream route's f32 splat, as f32 arguments."""
    return tuple(np.float32(x) for x in fixed_point_scale(stream_bound(cfg)))


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
    _check_batch(fields, group_counts, em_vec, n_valid, batch_size)
    check_i8_accumulator(cfg, batch_size)
    dev = fields.device
    out = _check_acc(out, num_texels, dev)
    inv_s = float(np.float32(1.0 / splat_color_scale(cfg)))

    if dev.type == "cpu":
        idx, col, _ = trace_deposits_rng_plain(
            fields, group_counts, em_vec, seed, n_valid, batch_size, cfg
        )
        return splat_i8_plain(idx, col, num_texels, inv_s, out)
    launch("fm_trace_splat_wide_rng_i8", dev,
            fields.data_ptr(), em_vec.data_ptr(), out.data_ptr(),
            *_trace_args(fields, group_counts, seed, n_valid, cfg,
                         num_texels),
            np.float32(inv_s))
    trace_splat_wide_rng_i8.launches += 1
    return out


trace_splat_wide_rng_i8.launches = 0


def trace_splat_wide_rng_f32(
    fields: torch.Tensor, group_counts, em_vec: torch.Tensor, seed: int,
    n_valid: int, batch_size: int, cfg: PhotonConfig, num_texels: int,
) -> torch.Tensor:
    """Trace one batch and return its f32 [num_texels, 3] lightmap
    increment: bf16 colors summed in f32 (`--splat inkernel`).

    CUDA tensors launch `csrc/trace_splat_wide.cu` (the port of
    photon_pallas_wide.trace_splat_wide_rng(i8=False)); it sums in int64
    fixed point at the stream route's scale (`ops/splat.fixed_point_scale`
    of `stream_bound(cfg)`), so it equals `trace_deposits_wide_rng` +
    `fused_splat` bit for bit; a failed build or launch raises. CPU tensors
    run the plain version."""
    _check_batch(fields, group_counts, em_vec, n_valid, batch_size)
    dev = fields.device
    if dev.type == "cpu":
        return trace_splat_wide_rng_f32_plain(fields, group_counts, em_vec,
                                              seed, n_valid, batch_size, cfg,
                                              num_texels)
    out = _launch_f32(
        "fm_trace_splat_wide_rng_f32", dev, num_texels,
        (fields.data_ptr(), em_vec.data_ptr()),
        (*_trace_args(fields, group_counts, seed, n_valid, cfg, num_texels),
         *_stream_fixed(cfg)))
    trace_splat_wide_rng_f32.launches += 1
    return out


trace_splat_wide_rng_f32.launches = 0


def _check_diff(n, albedo_aa, grid, size, what):
    _check_albedo(albedo_aa, n)
    if grid.numel() != size:
        raise ValueError(f"{what} must hold {size} value(s)")


def trace_splat_wide_diff_rng_i8(
    fields: torch.Tensor, group_counts, albedo_aa: torch.Tensor,
    em_vec: torch.Tensor, seed: int, n_valid: int, batch_size: int,
    cfg: PhotonConfig, num_texels: int, inv_scale: torch.Tensor,
    out: torch.Tensor = None,
) -> torch.Tensor:
    """Diff forward of one batch: the int32 [num_texels, 3] accumulator of
    7-bit deposits on the run-time grid `inv_scale` (a one-element f32
    tensor on the scene's device; de-scale with the matching `scale` of
    diff.render.scale_pair). A diffuse hit on rect slot j multiplies by
    albedo_aa[j] ([N] f32).

    CUDA tensors launch `csrc/trace_splat_wide_diff_rng.cu` (the port of
    photon_pallas_wide.trace_splat_wide_diff_rng(i8=True)); a failed build
    or launch raises. CPU tensors run the plain version. `out`, if given,
    is zeroed and filled."""
    n = _check_batch(fields, group_counts, em_vec, n_valid, batch_size,
                     albedo_aa=albedo_aa, inv_scale=inv_scale)
    _check_diff(n, albedo_aa, inv_scale, 1, "inv_scale")
    check_i8_accumulator(cfg, batch_size)
    dev = fields.device
    out = _check_acc(out, num_texels, dev)

    if dev.type == "cpu":
        idx, col, _ = trace_deposits_rng_plain(
            fields, group_counts, em_vec, seed, n_valid, batch_size, cfg,
            albedo_aa,
        )
        return splat_i8_plain(idx, col, num_texels, float(inv_scale), out)
    launch("fm_trace_splat_wide_diff_rng_i8", dev,
            fields.data_ptr(), albedo_aa.data_ptr(), em_vec.data_ptr(),
            inv_scale.data_ptr(), out.data_ptr(),
            *_trace_args(fields, group_counts, seed, n_valid, cfg,
                         num_texels))
    trace_splat_wide_diff_rng_i8.launches += 1
    return out


trace_splat_wide_diff_rng_i8.launches = 0


def trace_splat_wide_diff_rng_f32(
    fields: torch.Tensor, group_counts, albedo_aa: torch.Tensor,
    em_vec: torch.Tensor, seed: int, n_valid: int, batch_size: int,
    cfg: PhotonConfig, num_texels: int, fixed: torch.Tensor,
) -> torch.Tensor:
    """Diff forward of one batch on the f32 tier (`fit --splat inkernel` or
    `fused`): the f32 [num_texels, 3] lightmap increment of its bf16
    colors. `fixed` is the run-time fixed-point scale (2^k, 2^-k), a [2] f32
    tensor on the scene's device (diff.render.fixed_pair); a diffuse hit on
    rect slot j multiplies by albedo_aa[j] ([N] f32).

    CUDA tensors launch `csrc/trace_splat_wide_diff_rng.cu` (the port of
    photon_pallas_wide.trace_splat_wide_diff_rng(i8=False)); a failed build
    or launch raises. CPU tensors run the plain version, which sums in f32
    and does not read `fixed`."""
    n = _check_batch(fields, group_counts, em_vec, n_valid, batch_size,
                     albedo_aa=albedo_aa, fixed=fixed)
    _check_diff(n, albedo_aa, fixed, 2, "fixed")
    dev = fields.device
    if dev.type == "cpu":
        return trace_splat_wide_rng_f32_plain(fields, group_counts, em_vec,
                                              seed, n_valid, batch_size, cfg,
                                              num_texels, albedo_aa)
    out = _launch_f32(
        "fm_trace_splat_wide_diff_rng_f32", dev, num_texels,
        (fields.data_ptr(), albedo_aa.data_ptr(), em_vec.data_ptr(),
         fixed.data_ptr()),
        _trace_args(fields, group_counts, seed, n_valid, cfg, num_texels))
    trace_splat_wide_diff_rng_f32.launches += 1
    return out


trace_splat_wide_diff_rng_f32.launches = 0


def trace_splat_wide_diff_i8(
    fields: torch.Tensor, group_counts, albedo_aa: torch.Tensor,
    em_vec: torch.Tensor, uniforms: torch.Tensor, n_valid: int,
    cfg: PhotonConfig, num_texels: int, inv_scale: torch.Tensor,
    out: torch.Tensor = None, transposed: bool = False,
) -> torch.Tensor:
    """`trace_splat_wide_diff_rng_i8` with the draws passed in (`fit
    --no-device-rng`): photon p draws column c from uniforms[p, c] ([B, U]
    f32, or its [U, B] transpose with `transposed`; the threefry draws of
    `ops.threefry.batch_uniforms`). Returns the int32 [num_texels, 3]
    accumulator on the run-time grid `inv_scale`.

    CUDA tensors launch `csrc/trace_splat_wide_diff_rng.cu` (the port of
    photon_pallas_wide.trace_splat_wide_diff(i8=True)); a failed build or
    launch raises. CPU tensors run the plain version. `out`, if given, is
    zeroed and filled."""
    n, B = _check_uniforms(fields, group_counts, em_vec, uniforms, n_valid,
                           cfg, transposed, albedo_aa=albedo_aa,
                           inv_scale=inv_scale)
    _check_diff(n, albedo_aa, inv_scale, 1, "inv_scale")
    check_i8_accumulator(cfg, B)
    dev = fields.device
    out = _check_acc(out, num_texels, dev)
    u, u_t = _uniforms_of(uniforms, transposed)
    if dev.type == "cpu":
        idx, col, _ = trace_uniforms_plain(fields, group_counts, em_vec, u,
                                           n_valid, cfg, albedo_aa)
        return splat_i8_plain(idx, col, num_texels, float(inv_scale), out)
    launch("fm_trace_splat_wide_diff_i8", dev,
           fields.data_ptr(), albedo_aa.data_ptr(), em_vec.data_ptr(),
           u_t.data_ptr(), inv_scale.data_ptr(), out.data_ptr(), B,
           *_trace_args(fields, group_counts, 0, n_valid, cfg, num_texels))
    trace_splat_wide_diff_i8.launches += 1
    return out


trace_splat_wide_diff_i8.launches = 0


def trace_splat_wide_diff_f32(
    fields: torch.Tensor, group_counts, albedo_aa: torch.Tensor,
    em_vec: torch.Tensor, uniforms: torch.Tensor, n_valid: int,
    cfg: PhotonConfig, num_texels: int, fixed: torch.Tensor,
    transposed: bool = False,
) -> torch.Tensor:
    """`trace_splat_wide_diff_rng_f32` with the draws passed in (uniforms
    as in `trace_splat_wide_diff_i8`): the f32 [num_texels, 3] lightmap
    increment of the batch's bf16 colors at the run-time scale `fixed`.

    CUDA tensors launch `csrc/trace_splat_wide_diff_rng.cu` (the port of
    photon_pallas_wide.trace_splat_wide_diff(i8=False)); a failed build or
    launch raises. CPU tensors run the plain version, which sums in f32
    and does not read `fixed`."""
    n, B = _check_uniforms(fields, group_counts, em_vec, uniforms, n_valid,
                           cfg, transposed, albedo_aa=albedo_aa, fixed=fixed)
    _check_diff(n, albedo_aa, fixed, 2, "fixed")
    dev = fields.device
    u, u_t = _uniforms_of(uniforms, transposed)
    if dev.type == "cpu":
        idx, col, _ = trace_uniforms_plain(fields, group_counts, em_vec, u,
                                           n_valid, cfg, albedo_aa)
        return splat_f32_plain(idx, col, num_texels)
    out = _launch_f32(
        "fm_trace_splat_wide_diff_f32", dev, num_texels,
        (fields.data_ptr(), albedo_aa.data_ptr(), em_vec.data_ptr(),
         u_t.data_ptr(), fixed.data_ptr()),
        (B, *_trace_args(fields, group_counts, 0, n_valid, cfg,
                         num_texels)))
    trace_splat_wide_diff_f32.launches += 1
    return out


trace_splat_wide_diff_f32.launches = 0


def fold_smem_bytes(n_rects: int, max_depth: int) -> int:
    """Shared memory of the fold kernel: scene table, albedo row and one
    [N] row per warp, plus w and slot of every (bounce, photon)."""
    return 4 * ((F_AA + 1 + WARPS) * n_rects + 2 * max_depth * THREADS)


def fold_max_rects(max_depth: int) -> int:
    """The most rect slots the fold takes: its per-warp [N] rows and the
    w and slot buffers in shared memory (the table and albedo row move to
    device memory when they do not fit beside them): 6,752 at depth 8."""
    return (SMEM_LIMIT - 4 * 2 * int(max_depth) * THREADS) // (4 * WARPS)


def _check_fold(n, fields, albedo_aa, g_c, cfg, n_slots):
    """The fold wrappers' own checks, after `_check_batch` gave the rect
    count n."""
    _check_albedo(albedo_aa, n)
    if g_c.dim() != 2 or g_c.shape[1] != 3:
        raise ValueError(f"g_c must be [T, 3], got {tuple(g_c.shape)}")
    if int(n_slots) != n:
        raise ValueError(f"n_slots={n_slots}, but the table has {n} slots")
    if fields.device.type != "cpu":
        check_smem("the fold", fold_smem_bytes(n, cfg.max_depth)
                   - 4 * (F_AA + 1) * n, n, fold_max_rects(cfg.max_depth))


def _launch_fold(entry, fields, albedo_aa, em_vec, g_c, head, tail, n,
                 n_valid):
    """Launch a fold entry point: its per-block partials, then the N + 1
    sums. Returns (da_slots [n], w_sum)."""
    dev = fields.device
    blocks = -(-int(n_valid) // THREADS)
    part = torch.empty(((n + 1) * max(blocks, 1),), dtype=torch.float32,
                       device=dev)
    out = torch.empty((n + 1,), dtype=torch.float32, device=dev)
    launch(entry, dev, fields.data_ptr(), albedo_aa.data_ptr(),
           em_vec.data_ptr(), g_c.data_ptr(), *head, part.data_ptr(),
           out.data_ptr(), *tail)
    return out[:n], out[n]


def trace_fold_wide_rng(
    fields: torch.Tensor, group_counts, albedo_aa: torch.Tensor,
    em_vec: torch.Tensor, g_c: torch.Tensor, seed: int, n_valid: int,
    batch_size: int, cfg: PhotonConfig, n_slots: int,
):
    """Replay backward of one batch: re-trace the diff forward's photons
    and fold the compact-arena cotangent g_c [T, 3] f32 (rounded to bf16
    inside). Returns (da_slots [n_slots], w_sum), the suffix-sum totals per
    rect slot, not yet divided by albedo, and <g, batch lightmap> for
    d_power (photon_pallas_wide.trace_fold_wide_rng). Deterministic: no
    float atomics, so two runs are bit-identical.

    CUDA tensors launch `csrc/trace_fold_wide_rng.cu`; a failed build or
    launch raises. CPU tensors run the plain version (`fold_plain`)."""
    n = _check_batch(fields, group_counts, em_vec, n_valid, batch_size,
                     albedo_aa=albedo_aa, g_c=g_c)
    _check_fold(n, fields, albedo_aa, g_c, cfg, n_slots)
    if fields.device.type == "cpu":
        idx, col, ridx = trace_deposits_rng_plain(
            fields, group_counts, em_vec, seed, n_valid, batch_size, cfg,
            albedo_aa,
        )
        return fold_plain(idx, col, ridx, g_c, n)
    out = _launch_fold("fm_trace_fold_wide_rng", fields, albedo_aa, em_vec,
                       g_c, (), _trace_args(fields, group_counts, seed,
                                            n_valid, cfg, g_c.shape[0]),
                       n, n_valid)
    trace_fold_wide_rng.launches += 1
    return out


trace_fold_wide_rng.launches = 0


def trace_fold_wide(
    fields: torch.Tensor, group_counts, albedo_aa: torch.Tensor,
    em_vec: torch.Tensor, g_c: torch.Tensor, uniforms: torch.Tensor,
    n_valid: int, cfg: PhotonConfig, n_slots: int, transposed: bool = False,
):
    """`trace_fold_wide_rng` with the draws passed in (uniforms as in
    `trace_splat_wide_diff_i8`): the backward of `fit --no-device-rng`,
    which replays `trace_splat_wide_diff_i8` or `_f32`'s photons. Returns
    (da_slots [n_slots], w_sum), undivided; deterministic.

    CUDA tensors launch `csrc/trace_fold_wide_rng.cu` (the port of
    photon_pallas_wide.trace_fold_wide); a failed build or launch raises.
    CPU tensors run the plain version (`fold_plain`)."""
    n, B = _check_uniforms(fields, group_counts, em_vec, uniforms, n_valid,
                           cfg, transposed, albedo_aa=albedo_aa, g_c=g_c)
    _check_fold(n, fields, albedo_aa, g_c, cfg, n_slots)
    u, u_t = _uniforms_of(uniforms, transposed)
    if fields.device.type == "cpu":
        idx, col, ridx = trace_uniforms_plain(fields, group_counts, em_vec, u,
                                              n_valid, cfg, albedo_aa)
        return fold_plain(idx, col, ridx, g_c, n)
    out = _launch_fold("fm_trace_fold_wide", fields, albedo_aa, em_vec, g_c,
                       (u_t.data_ptr(),),
                       (B, *_trace_args(fields, group_counts, 0, n_valid,
                                        cfg, g_c.shape[0])), n, n_valid)
    trace_fold_wide.launches += 1
    return out


trace_fold_wide.launches = 0


def _stream_block_of(batch_size: int, block) -> int:
    block = stream_block(batch_size) if block is None else int(block)
    if block < 1 or int(batch_size) % block:
        raise ValueError(f"stream block {block} must divide the batch "
                         f"{batch_size}")
    return block


def _launch_stream(entry, fields, group_counts, em_vec, extra, n_valid,
                   batch_size, cfg, block, seed=0, albedo_aa=None):
    """Allocate the stream of one batch and launch `entry` on it; `extra`
    are the pointers between the emitter vector and the stream. With
    `albedo_aa` (the diff stream) its pointer goes before the emitter
    vector, and the slots [R] int32 are allocated and written too."""
    R = int(batch_size) * int(cfg.max_depth)
    dev = fields.device
    idx = torch.empty((R,), dtype=torch.int32, device=dev)
    col = torch.empty((R, 3), dtype=torch.float32, device=dev)
    out = (idx, col)
    head = (fields.data_ptr(),)
    if albedo_aa is not None:
        out += (torch.empty((R,), dtype=torch.int32, device=dev),)
        head += (albedo_aa.data_ptr(),)
    launch(entry, dev, *head, em_vec.data_ptr(), *extra,
           *(t.data_ptr() for t in out), int(batch_size), block,
           *_trace_args(fields, group_counts, seed, n_valid, cfg, 0))
    return out


def trace_deposits_wide_rng(
    fields: torch.Tensor, group_counts, em_vec: torch.Tensor, seed: int,
    n_valid: int, batch_size: int, cfg: PhotonConfig, block: int = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trace one batch with the counter-hash draws and return its deposit
    stream: (idx [R] int32, col [R, 3] f32), R = batch_size * max_depth, in
    the JAX row order with `block` photons per stream block (default
    `stream_block(batch_size)`). Dead photons and misses give id 0 and
    color 0.

    CUDA tensors launch `csrc/trace_deposits_wide.cu` (the port of
    photon_pallas_wide.trace_deposits_wide_rng); a failed build or launch
    raises. CPU tensors run the plain version."""
    _check_batch(fields, group_counts, em_vec, n_valid, batch_size)
    block = _stream_block_of(batch_size, block)
    if fields.device.type == "cpu":
        idx, col, _ = trace_deposits_rng_plain(
            fields, group_counts, em_vec, seed, n_valid, batch_size, cfg)
        return stream_rows(idx, col, block)
    out = _launch_stream("fm_trace_deposits_wide_rng", fields, group_counts,
                         em_vec, (), n_valid, batch_size, cfg, block, seed)
    trace_deposits_wide_rng.launches += 1
    return out


trace_deposits_wide_rng.launches = 0


def trace_deposits_wide(
    fields: torch.Tensor, group_counts, em_vec: torch.Tensor,
    uniforms: torch.Tensor, n_valid: int, cfg: PhotonConfig,
    block: int = None, transposed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`trace_deposits_wide_rng` with the draws passed in: photon p draws
    column c from uniforms[p, c] ([B, U] f32, U = 4 + 3 * max_depth, or its
    [U, B] transpose with `transposed`; the threefry draws of
    `ops.threefry.batch_uniforms`).

    CUDA tensors launch `csrc/trace_deposits_wide.cu` (the port of
    photon_pallas_wide.trace_deposits_wide) on the [U, B] layout (a
    transposed copy of [B, U] uniforms); a failed build or launch raises.
    CPU tensors run the plain version."""
    _, B = _check_uniforms(fields, group_counts, em_vec, uniforms, n_valid,
                           cfg, transposed)
    block = _stream_block_of(B, block)
    u, u_t = _uniforms_of(uniforms, transposed)
    if fields.device.type == "cpu":
        return trace_deposits_wide_plain(fields, group_counts, em_vec, u,
                                         n_valid, cfg, block)
    out = _launch_stream("fm_trace_deposits_wide", fields, group_counts,
                         em_vec, (u_t.data_ptr(),), n_valid, B, cfg, block)
    trace_deposits_wide.launches += 1
    return out


trace_deposits_wide.launches = 0


def trace_deposits_wide_diff(
    fields: torch.Tensor, group_counts, albedo_aa: torch.Tensor,
    em_vec: torch.Tensor, uniforms: torch.Tensor, n_valid: int,
    cfg: PhotonConfig, block: int, transposed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The diff renderer's deposit stream of one batch (`fit --splat
    scatter|bucket|bucket_exact`, forward and backward): `trace_deposits_wide`
    with a diffuse hit on rect slot j multiplying by albedo_aa[j] ([N] f32),
    returning (idx [R] int32, col [R, 3] f32, ridx [R] int32), ridx the
    diffuse-hit slot of each row (-1 at a mirror bounce, a miss or a dead
    photon), in the JAX row order of `block` (the diff renderer's block,
    diff.render.diff_block, not `stream_block`).

    CUDA tensors launch `csrc/trace_deposits_wide.cu` (the port of
    photon_pallas_wide.trace_deposits_wide_diff); a failed build or launch
    raises. CPU tensors run the plain version."""
    n, B = _check_uniforms(fields, group_counts, em_vec, uniforms, n_valid,
                           cfg, transposed, albedo_aa=albedo_aa)
    _check_albedo(albedo_aa, n)
    block = _stream_block_of(B, block)
    u, u_t = _uniforms_of(uniforms, transposed)
    if fields.device.type == "cpu":
        return trace_deposits_wide_diff_plain(fields, group_counts,
                                              albedo_aa, em_vec, u, n_valid,
                                              cfg, block)
    out = _launch_stream("fm_trace_deposits_wide_diff", fields, group_counts,
                         em_vec, (u_t.data_ptr(),), n_valid, B, cfg, block,
                         albedo_aa=albedo_aa)
    trace_deposits_wide_diff.launches += 1
    return out


trace_deposits_wide_diff.launches = 0


def trace_splat_wide_i8(
    fields: torch.Tensor, group_counts, em_vec: torch.Tensor,
    uniforms: torch.Tensor, n_valid: int, cfg: PhotonConfig,
    num_texels: int, out: torch.Tensor = None, transposed: bool = False,
) -> torch.Tensor:
    """`trace_splat_wide_rng_i8` with the draws passed in: photon p draws
    column c from uniforms[p, c] ([B, U] f32, or its [U, B] transpose with
    `transposed`; the threefry draws of `ops.threefry.batch_uniforms`).
    Returns the int32 [num_texels, 3] accumulator of the batch's 7-bit
    deposits, dithered per photon as the default kernel dithers (de-scale
    with `splat_color_scale(cfg)`).

    CUDA tensors launch `csrc/trace_splat_wide.cu` (the port of
    photon_pallas_wide.trace_splat_wide(i8=True)) on the [U, B] layout; a
    failed build or launch raises. CPU tensors run the plain version.
    `out`, if given, is zeroed and filled."""
    _, B = _check_uniforms(fields, group_counts, em_vec, uniforms, n_valid,
                           cfg, transposed)
    check_i8_accumulator(cfg, B)
    dev = fields.device
    out = _check_acc(out, num_texels, dev)
    u, u_t = _uniforms_of(uniforms, transposed)
    if dev.type == "cpu":
        return trace_splat_wide_plain(fields, group_counts, em_vec, u,
                                      n_valid, cfg, num_texels, True, out)
    inv_s = float(np.float32(1.0 / splat_color_scale(cfg)))
    launch("fm_trace_splat_wide_i8", dev,
           fields.data_ptr(), em_vec.data_ptr(), u_t.data_ptr(),
           out.data_ptr(), B,
           *_trace_args(fields, group_counts, 0, n_valid, cfg, num_texels),
           np.float32(inv_s))
    trace_splat_wide_i8.launches += 1
    return out


trace_splat_wide_i8.launches = 0


def trace_splat_wide_f32(
    fields: torch.Tensor, group_counts, em_vec: torch.Tensor,
    uniforms: torch.Tensor, n_valid: int, cfg: PhotonConfig,
    num_texels: int, transposed: bool = False,
) -> torch.Tensor:
    """`trace_splat_wide_rng_f32` with the draws passed in (uniforms as in
    `trace_splat_wide_i8`): the f32 [num_texels, 3] lightmap increment of
    the batch's bf16 colors, equal to `trace_deposits_wide` + `fused_splat`
    bit for bit on the card.

    CUDA tensors launch `csrc/trace_splat_wide.cu` (the port of
    photon_pallas_wide.trace_splat_wide(i8=False)) on the [U, B] layout; a
    failed build or launch raises. CPU tensors run the plain version."""
    _, B = _check_uniforms(fields, group_counts, em_vec, uniforms, n_valid,
                           cfg, transposed)
    dev = fields.device
    u, u_t = _uniforms_of(uniforms, transposed)
    if dev.type == "cpu":
        return trace_splat_wide_plain(fields, group_counts, em_vec, u,
                                      n_valid, cfg, num_texels, False)
    out = _launch_f32(
        "fm_trace_splat_wide_f32", dev, num_texels,
        (fields.data_ptr(), em_vec.data_ptr(), u_t.data_ptr()),
        (B, *_trace_args(fields, group_counts, 0, n_valid, cfg, num_texels),
         *_stream_fixed(cfg)))
    trace_splat_wide_f32.launches += 1
    return out


trace_splat_wide_f32.launches = 0


# --------------------------------------------------------------------------
# host side
# --------------------------------------------------------------------------
def compact_arena_positions(aa: AARects) -> np.ndarray:
    """compact texel index -> arena texel index (int64, injective), so
    g_compact = g_arena[positions] is the exact transpose of compact_aa's
    expand (photon_pallas_wide.compact_arena_positions)."""
    fields = aa.fields.cpu().numpy()
    counts = fields[A_WT].astype(np.int64) * fields[A_HT].astype(np.int64)
    arena_base = fields[A_BASE].astype(np.int64)
    return np.concatenate(
        [np.arange(a0, a0 + n) for a0, n in zip(arena_base, counts)]
        or [np.zeros(0, np.int64)]
    )


def compact_aa(aa: AARects, num_texels: int):
    """Re-base the scene so deposits land in a compact level-0-only arena
    (mipmap slots excluded). Returns (aa_compact, compact_total, expand)
    where expand(compact_lightmap) -> arena lightmap
    (photon_pallas_wide.compact_aa)."""
    fields = aa.fields.cpu().numpy()
    counts = fields[A_WT].astype(np.int64) * fields[A_HT].astype(np.int64)
    cbase = np.zeros_like(counts)
    cbase[1:] = np.cumsum(counts)[:-1]
    total = int(counts.sum())
    fields_c = fields.copy()
    fields_c[A_BASE] = cbase.astype(np.float32)
    dev = aa.fields.device
    aa_c = AARects(fields=torch.from_numpy(fields_c).to(dev),
                   group_counts=aa.group_counts, perm=aa.perm)
    pos_t = torch.from_numpy(compact_arena_positions(aa)).to(dev)

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


def schedule_batches(schedule, batch_size: int, tail_shrink: bool = True,
                     quantum: int = THREADS):
    """(emitter, global batch index, live photons, physical batch size) of
    every batch of the schedule in dispatch order; each emitter's tail
    batch runs at `tail_batch_size` (in blocks of `quantum` photons) unless
    `tail_shrink` is off."""
    B = int(batch_size)
    for e, base_batch, n_batches, last_valid in schedule:
        for i in range(n_batches):
            if i < n_batches - 1:
                yield e, base_batch + i, B, B
            else:
                yield (e, base_batch + i, last_valid,
                       tail_batch_size(last_valid, B, quantum)
                       if tail_shrink else B)


def render_all_wide(fields, group_counts, emitters: Emitters,
                    cfg: PhotonConfig, batch_size: int, schedule,
                    num_texels: int) -> torch.Tensor:
    """The whole emitter schedule, one batch after another into the f32
    lightmap (photon_pallas_wide._render_all_wide). The draws are the
    counter hash with the device RNG, else the batch's threefry uniforms.
    The in-kernel tiers: one launch per batch, its int32 accumulator
    de-scaled (`inkernel_i8`) or its f32 increment added (`inkernel`). The
    stream tiers: the stream trace, then `splat_stream`. Each emitter's
    tail batch runs at `tail_batch_size` (on the stream tiers in whole
    stream blocks, so its stream is the first rows of the full batch's).
    Draws, dither keys and f32 sums depend only on the photon index, and a
    shrunk threefry batch draws the first rows of the full one, so the
    shrink changes no bit; the JAX package keeps the full grid on threefry
    (photon_pallas_wide.py:1713-1719), with the same result."""
    dev = fields.device
    lm = torch.zeros((num_texels, 3), dtype=torch.float32, device=dev)
    evs = {}

    def ev(e):
        if e not in evs:
            evs[e] = emitter_vector(emitters, e)
        return evs[e]

    U = uniforms_per_photon(cfg.max_depth)
    if cfg.splat in INKERNEL_MODES:
        i8 = cfg.splat == "inkernel_i8"
        acc = torch.empty((num_texels, 3), dtype=torch.int32, device=dev)
        scale = float(np.float32(splat_color_scale(cfg)))
        for e, gb, nv, bsz in schedule_batches(schedule, batch_size):
            if cfg.device_rng:
                kernel = (trace_splat_wide_rng_i8 if i8
                          else trace_splat_wide_rng_f32)
                draws = (rng.batch_seed(cfg.seed, gb), nv, bsz)
            else:
                kernel = functools.partial(
                    trace_splat_wide_i8 if i8 else trace_splat_wide_f32,
                    transposed=True)
                draws = (threefry.batch_uniforms(cfg.seed, gb, bsz, U, dev,
                                                 transposed=True), nv)
            if i8:
                kernel(fields, group_counts, ev(e), *draws, cfg, num_texels,
                       out=acc)
                lm += acc.to(torch.float32) * scale
            else:
                lm += kernel(fields, group_counts, ev(e), *draws, cfg,
                             num_texels)
        return lm
    block = stream_block(batch_size)
    for e, gb, nv, bsz in schedule_batches(schedule, batch_size,
                                           quantum=block):
        if cfg.device_rng:
            idx, col = trace_deposits_wide_rng(
                fields, group_counts, ev(e), rng.batch_seed(cfg.seed, gb),
                nv, bsz, cfg, block)
        else:
            u = threefry.batch_uniforms(cfg.seed, gb, bsz, U, dev,
                                        transposed=True)
            idx, col = trace_deposits_wide(fields, group_counts, ev(e), u,
                                           nv, cfg, block, transposed=True)
        splat_stream(lm, idx, col, cfg)
    return lm


def check_port_cfg(cfg: PhotonConfig):
    """Refuse a photon configuration the engine cannot run: a batch under
    one photon, an unknown splat mode, or, on the stream tiers, a batch
    that is not a multiple of 128, as the JAX wide engine refuses it
    (photon_pallas_wide.py:1755)."""
    if int(cfg.photons_per_batch) < 1:
        raise ValueError(f"photons_per_batch must be >= 1, got "
                         f"{cfg.photons_per_batch}")
    if cfg.splat in INKERNEL_MODES:
        return
    if cfg.splat not in STREAM_MODES:
        raise ValueError(f"unknown splat mode {cfg.splat!r}")
    stream_block(cfg.photons_per_batch)


def render_photons(emitters: Emitters, num_texels: int, cfg: PhotonConfig,
                   aa: AARects) -> torch.Tensor:
    """Full photon pass: the raw (un-normalized) [num_texels, 3] lightmap
    on the scene table's device (photon_pallas_wide.render_photons)."""
    check_port_cfg(cfg)
    B = int(cfg.photons_per_batch)
    if cfg.splat in ("inkernel_i8", "fused_i8"):
        check_i8_accumulator(cfg, B)
    aa_c, total_c, expand = compact_aa(aa, num_texels)
    schedule = emitter_schedule(emitters.counts, B)
    compact_lm = render_all_wide(aa_c.fields, aa_c.group_counts, emitters,
                                 cfg, B, schedule, total_c)
    return expand(compact_lm)
