"""Axis-aligned photon engine: host schedule, the CUDA kernels' wrappers,
and their plain PyTorch versions.

Counterpart of flatmatch_tpu/engines/photon_pallas_wide.py on its in-kernel
7-bit tier and its deposit-stream tier. The host de-scales or splats each
batch into the float32 lightmap in the JAX package's batch order
(photon_pallas_wide.py:1651-1729). Per photon batch:

- `trace_splat_wide_rng_i8` (`csrc/trace_splat_wide_rng.cu`): the CLI's
  default render (device RNG, `inkernel_i8`). It traces the batch and sums
  its dithered 7-bit deposits into an exact int32 texel accumulator.
- `trace_deposits_wide_rng` and `trace_deposits_wide`
  (`csrc/trace_deposits_wide.cu`): the same trace writing a deposit stream
  in the JAX package's row order (`stream_block`), with the counter-hash
  draws or with threefry uniforms passed in (`ops/threefry.batch_uniforms`,
  the library default). `ops/splat.splat_stream` then sums the stream
  (`--splat fused`, `fused_i8`, `scatter`, `bucket`, `bucket_exact`).
- `trace_splat_wide_diff_rng_i8` (`csrc/trace_splat_wide_diff_rng.cu`): the
  forward of the differentiable render, with a per-slot albedo and a 7-bit
  grid set at run time.
- `trace_fold_wide_rng` (`csrc/trace_fold_wide_rng.cu`): its backward,
  which replays the batch and folds the lightmap cotangent into per-slot
  albedo cotangents and the batch's <g, lightmap> total.

Each wrapper launches its kernel for CUDA tensors and runs the plain version
(`trace_deposits_rng_plain` or `trace_deposits_wide_plain`, with
`splat_i8_plain` or `fold_plain`) for CPU tensors only.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..config import PhotonConfig
from ..ops import rng, threefry
from ..ops.aa_query import MISS, check_on, check_table, nearest_hit
from ..ops.aa_scene import A_BASE, A_HT, A_WT, F_AA, AARects
from ..ops.device_scene import Emitters
from ..ops.sampling import TWO_PI_REF, base_cols
from ..ops.splat import STREAM_MODES, splat_color_scale, splat_stream
from ..utils.cuda_build import check_smem, launch

THREADS = 256                      # photons per CUDA block
WARPS = THREADS // 32
PLAIN_CHUNK = 16384                # photons per step of the plain version
LANES = 128                        # the JAX engine's batch quantum
MAX_SUBLANES = 64                  # the JAX engine's photon-block height


def unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to flatmatch_tpu_torch yet; the port runs "
        f"the photon render (in-kernel 7-bit splat with the device RNG, and "
        f"the deposit-stream splats with either draw source), the fit and "
        f"the ambient-occlusion and radiosity engines on axis-aligned "
        f"scenes (see ROADMAP.md)"
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
def _trace_chunk(fields, group_counts, em, draw, n_valid, cfg, pid,
                 albedo_aa=None):
    """Trace photons `pid` (in-batch indices); draw(c) returns their draw
    column c."""
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
        best, btex, baxis, bsign, bslot = nearest_hit(
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
    return _trace_plain(fields, group_counts, em_vec, n_valid, batch_size,
                        cfg, lambda pid: lambda c: rng.draw(pid, int(seed), c),
                        albedo_aa)


def _trace_plain(fields, group_counts, em_vec, n_valid, batch_size, cfg,
                 draws, albedo_aa=None):
    """The plain trace of a batch in chunks of PLAIN_CHUNK photons;
    draws(pid) gives the draw function of photons pid."""
    dev = fields.device
    idx, col, ridx = [], [], []
    for c0 in range(0, int(batch_size), PLAIN_CHUNK):
        pid = torch.arange(c0, min(c0 + PLAIN_CHUNK, int(batch_size)),
                           dtype=torch.int64, device=dev)
        i, c, r = _trace_chunk(fields, group_counts, em_vec, draws(pid),
                               int(n_valid), cfg, pid, albedo_aa)
        idx.append(i)
        col.append(c)
        ridx.append(r)
    return torch.cat(idx), torch.cat(col), torch.cat(ridx)


def stream_rows(idx: torch.Tensor, col: torch.Tensor, block: int):
    """Photon-major deposits (idx [B, D], col [B, D, 3]) -> the stream
    (idx [B * D], col [B * D, 3]) in the JAX row order of `stream_block`."""
    B, D = idx.shape
    nb = B // int(block)
    return (idx.reshape(nb, block, D).permute(0, 2, 1).reshape(-1)
            .contiguous(),
            col.reshape(nb, block, D, 3).permute(0, 2, 1, 3).reshape(-1, 3)
            .contiguous())


def trace_deposits_wide_plain(
    fields: torch.Tensor, group_counts, em_vec: torch.Tensor,
    uniforms: torch.Tensor, n_valid: int, cfg: PhotonConfig,
    block: int = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `trace_deposits_wide`: the stream of one batch whose
    photon p draws its column c from uniforms[p, c] ([B, U] f32)."""
    B = uniforms.shape[0]
    idx, col, _ = _trace_plain(
        fields, group_counts, em_vec, n_valid, B, cfg,
        lambda pid: lambda c: uniforms[pid, c])
    return stream_rows(idx, col, block or stream_block(B))


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
    n = _check_batch(fields, group_counts, em_vec, n_valid, batch_size)
    check_i8_accumulator(cfg, batch_size)
    dev = fields.device
    out = _check_acc(out, num_texels, dev)
    inv_s = float(np.float32(1.0 / splat_color_scale(cfg)))

    if dev.type == "cpu":
        idx, col, _ = trace_deposits_rng_plain(
            fields, group_counts, em_vec, seed, n_valid, batch_size, cfg
        )
        return splat_i8_plain(idx, col, num_texels, inv_s, out)
    check_smem("trace_splat_wide_rng", 4 * F_AA * n, n)
    launch("fm_trace_splat_wide_rng_i8", dev,
            fields.data_ptr(), em_vec.data_ptr(), out.data_ptr(),
            *_trace_args(fields, group_counts, seed, n_valid, cfg,
                         num_texels),
            np.float32(inv_s))
    trace_splat_wide_rng_i8.launches += 1
    return out


trace_splat_wide_rng_i8.launches = 0


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
    if tuple(albedo_aa.shape) != (n,):
        raise ValueError(f"albedo_aa must be [{n}], got "
                         f"{tuple(albedo_aa.shape)}")
    if inv_scale.numel() != 1:
        raise ValueError("inv_scale must hold one value")
    check_i8_accumulator(cfg, batch_size)
    dev = fields.device
    out = _check_acc(out, num_texels, dev)

    if dev.type == "cpu":
        idx, col, _ = trace_deposits_rng_plain(
            fields, group_counts, em_vec, seed, n_valid, batch_size, cfg,
            albedo_aa,
        )
        return splat_i8_plain(idx, col, num_texels, float(inv_scale), out)
    check_smem("trace_splat_wide_diff_rng", 4 * (F_AA + 1) * n, n)
    launch("fm_trace_splat_wide_diff_rng_i8", dev,
            fields.data_ptr(), albedo_aa.data_ptr(), em_vec.data_ptr(),
            inv_scale.data_ptr(), out.data_ptr(),
            *_trace_args(fields, group_counts, seed, n_valid, cfg,
                         num_texels))
    trace_splat_wide_diff_rng_i8.launches += 1
    return out


trace_splat_wide_diff_rng_i8.launches = 0


def fold_smem_bytes(n_rects: int, max_depth: int) -> int:
    """Shared memory of the fold kernel: scene table, albedo row and one
    [N] row per warp, plus w and slot of every (bounce, photon)."""
    return 4 * ((F_AA + 1 + WARPS) * n_rects + 2 * max_depth * THREADS)


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
    if tuple(albedo_aa.shape) != (n,):
        raise ValueError(f"albedo_aa must be [{n}], got "
                         f"{tuple(albedo_aa.shape)}")
    if g_c.dim() != 2 or g_c.shape[1] != 3:
        raise ValueError(f"g_c must be [T, 3], got {tuple(g_c.shape)}")
    if int(n_slots) != n:
        raise ValueError(f"n_slots={n_slots}, but the table has {n} slots")
    dev = fields.device

    if dev.type == "cpu":
        idx, col, ridx = trace_deposits_rng_plain(
            fields, group_counts, em_vec, seed, n_valid, batch_size, cfg,
            albedo_aa,
        )
        return fold_plain(idx, col, ridx, g_c, n)
    check_smem("trace_fold_wide_rng", fold_smem_bytes(n, cfg.max_depth), n)
    blocks = -(-int(n_valid) // THREADS)
    part = torch.empty(((n + 1) * max(blocks, 1),), dtype=torch.float32,
                       device=dev)
    out = torch.empty((n + 1,), dtype=torch.float32, device=dev)
    launch("fm_trace_fold_wide_rng", dev,
            fields.data_ptr(), albedo_aa.data_ptr(), em_vec.data_ptr(),
            g_c.data_ptr(), part.data_ptr(), out.data_ptr(),
            *_trace_args(fields, group_counts, seed, n_valid, cfg,
                         g_c.shape[0]))
    trace_fold_wide_rng.launches += 1
    return out[:n], out[n]


trace_fold_wide_rng.launches = 0


def _stream_block_of(batch_size: int, block) -> int:
    block = stream_block(batch_size) if block is None else int(block)
    if block < 1 or int(batch_size) % block:
        raise ValueError(f"stream block {block} must divide the batch "
                         f"{batch_size}")
    return block


def _launch_stream(entry, fields, group_counts, em_vec, extra, n_valid,
                   batch_size, cfg, block, seed=0):
    """Allocate the stream of one batch and launch `entry` on it; `extra`
    are the pointers between the emitter vector and the stream."""
    n = fields.shape[1]
    check_smem(entry, 4 * F_AA * n, n)
    R = int(batch_size) * int(cfg.max_depth)
    dev = fields.device
    idx = torch.empty((R,), dtype=torch.int32, device=dev)
    col = torch.empty((R, 3), dtype=torch.float32, device=dev)
    launch(entry, dev, fields.data_ptr(), em_vec.data_ptr(), *extra,
           idx.data_ptr(), col.data_ptr(), int(batch_size), block,
           *_trace_args(fields, group_counts, seed, n_valid, cfg, 0))
    return idx, col


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
    block: int = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`trace_deposits_wide_rng` with the draws passed in: photon p draws
    column c from uniforms[p, c] ([B, U] f32, U = 4 + 3 * max_depth; the
    threefry draws of `ops.threefry.batch_uniforms`).

    CUDA tensors launch `csrc/trace_deposits_wide.cu` (the port of
    photon_pallas_wide.trace_deposits_wide) on a transposed [U, B] copy of
    the uniforms; a failed build or launch raises. CPU tensors run the
    plain version."""
    U = uniforms_per_photon(cfg.max_depth)
    if uniforms.dim() != 2 or uniforms.shape[1] != U:
        raise ValueError(f"uniforms must be [B, {U}], got "
                         f"{tuple(uniforms.shape)}")
    B = uniforms.shape[0]
    _check_batch(fields, group_counts, em_vec, n_valid, B,
                 uniforms=uniforms)
    block = _stream_block_of(B, block)
    if fields.device.type == "cpu":
        return trace_deposits_wide_plain(fields, group_counts, em_vec,
                                         uniforms, n_valid, cfg, block)
    u_t = uniforms.t().contiguous()
    out = _launch_stream("fm_trace_deposits_wide", fields, group_counts,
                         em_vec, (u_t.data_ptr(),), n_valid, B, cfg, block)
    trace_deposits_wide.launches += 1
    return out


trace_deposits_wide.launches = 0


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
    lightmap (photon_pallas_wide._render_all_wide). `inkernel_i8`: one
    launch per batch, its int32 accumulator de-scaled. The stream tiers:
    the stream trace (counter hash, or threefry uniforms without the device
    RNG), then `splat_stream`. Each emitter's tail batch runs at
    `tail_batch_size`, on the stream tiers in whole stream blocks, so its
    stream is the first rows of the full batch's."""
    dev = fields.device
    lm = torch.zeros((num_texels, 3), dtype=torch.float32, device=dev)
    evs = {}

    def ev(e):
        if e not in evs:
            evs[e] = emitter_vector(emitters, e)
        return evs[e]

    if cfg.splat == "inkernel_i8":
        acc = torch.empty((num_texels, 3), dtype=torch.int32, device=dev)
        scale = float(np.float32(splat_color_scale(cfg)))
        for e, gb, nv, bsz in schedule_batches(schedule, batch_size):
            trace_splat_wide_rng_i8(fields, group_counts, ev(e),
                                    rng.batch_seed(cfg.seed, gb), nv, bsz,
                                    cfg, num_texels, out=acc)
            lm += acc.to(torch.float32) * scale
        return lm
    block = stream_block(batch_size)
    U = uniforms_per_photon(cfg.max_depth)
    for e, gb, nv, bsz in schedule_batches(schedule, batch_size,
                                           quantum=block):
        if cfg.device_rng:
            idx, col = trace_deposits_wide_rng(
                fields, group_counts, ev(e), rng.batch_seed(cfg.seed, gb),
                nv, bsz, cfg, block)
        else:
            u = threefry.batch_uniforms(cfg.seed, gb, bsz, U, dev)
            idx, col = trace_deposits_wide(fields, group_counts, ev(e), u,
                                           nv, cfg, block)
        splat_stream(lm, idx, col, cfg)
    return lm


def check_port_cfg(cfg: PhotonConfig):
    """Refuse the photon configurations the port does not run: the
    in-kernel bf16 splat, and the in-kernel 7-bit splat with the threefry
    draws. The stream tiers need a batch that is a multiple of 128, as the
    JAX wide engine does (photon_pallas_wide.py:1755)."""
    if int(cfg.photons_per_batch) < 1:
        raise ValueError(f"photons_per_batch must be >= 1, got "
                         f"{cfg.photons_per_batch}")
    if cfg.splat == "inkernel":
        raise unsupported("splat='inkernel' (the in-kernel bf16 splat)")
    if cfg.splat == "inkernel_i8":
        if not cfg.device_rng:
            raise unsupported("splat='inkernel_i8' with the threefry draws "
                              "(device_rng=False)")
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
