"""The general photon route of `photon_pallas`: scenes that the axis-aligned
table cannot hold, through the hand-written row 11 kernel.

Counterpart of flatmatch_tpu/engines/photon_pallas.py (the "narrow" kernel,
whose table holds one row per rect field, as photon_pallas_wide.py became
photon_wide.py). `render.run_engine` sends `photon_pallas` here when
`ops/aa_scene.pack_aa` gives no table for a scene below 2^24 texels.

- `scene_matrix`: the [18, N] f32 rect table (pos, n, w_unit, h_unit,
  wlen, hlen, n_off, base, wt, ht rows) of `ops/device_scene.pack_rects`;
  `narrow_table` cuts its padding columns, which can never be hit.
- `trace_deposits_narrow`: one batch's deposits, idx [B, D] int32 and col
  [B, 3D] f32 in the TPU kernel's layout. CUDA tensors launch
  `csrc/trace_deposits_narrow.cu` (the port of trace_deposits_pallas); a
  failed build or launch raises. CPU tensors run the plain version,
  `trace_deposits_narrow_plain`, which computes what the TPU kernel's
  _make_kernel does on [photons, N] tiles, line for line.
- `trace_batch_narrow`: the trace, then `ops/splat.fused_splat_add` with
  f32 colors, the int64 fixed-point f32 splat adding into the lightmap
  (exact, where the JAX package adds in f32).
- `render_photons`: the shared schedule (engines/schedule.py), each batch
  drawing its threefry uniforms in the kernel's [U, B] layout.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import PhotonConfig
from ..ops import aa_scene
from ..ops.aa_query import MISS, check_on
from ..ops.device_scene import Emitters, Rects, rect_count
from ..ops.intersect import rays_per_tile
from ..ops.sampling import TWO_PI_REF
from ..ops.splat import fused_splat_add
from ..utils.cuda_build import launch
from . import photon_wide as pw
from .photon import splat_bound

# rows of the [F_GEN, N] table (photon_pallas.py:41-51)
G_POS, G_N, G_WU, G_HU = 0, 3, 6, 9
G_WLEN, G_HLEN, G_NOFF, G_BASE, G_WT, G_HT = 12, 13, 14, 15, 16, 17
F_GEN = 18


def scene_matrix(rects: Rects) -> torch.Tensor:
    """The [F_GEN, N] field table of `rects` (padding included), bit for
    bit the JAX package's. Texel ids are f32 in the kernel, exact only
    below 2^24, so a larger arena is refused: the general XLA engine
    (engines/photon.py) runs it."""
    max_id = int(rects.base.max()) + int((rects.wtiles * rects.htiles).max())
    if max_id >= aa_scene.MAX_TEXELS:
        raise ValueError(
            f"texel arena too large for f32-exact texel ids ({max_id} >= "
            f"2^24); use the general photon engine (engines/photon.py)")
    rows = [rects.pos[:, i] for i in range(3)]
    rows += [rects.n[:, i] for i in range(3)]
    rows += [rects.w_unit[:, i] for i in range(3)]
    rows += [rects.h_unit[:, i] for i in range(3)]
    rows += [rects.wlen, rects.hlen, rects.n_off,
             rects.base.to(torch.float32), rects.wtiles.to(torch.float32),
             rects.htiles.to(torch.float32)]
    return torch.stack(rows, 0)


def narrow_table(rects: Rects) -> torch.Tensor:
    """`scene_matrix` without the padding columns: what the kernel loops
    over."""
    return scene_matrix(rects)[:, :rect_count(rects)].contiguous()


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------
def narrow_nearest(scene: torch.Tensor):
    """The nearest-hit query of the plain trace (photon_wide.trace_plain)
    over the [F_GEN, N] table, as _make_kernel (photon_pallas.py:169-239)
    computes it: distances on [photons, N] tiles, the first minimum, the
    winner's texel id from its projections at fac, and its normal."""
    F = scene

    def nearest(p, dr):
        px, py, pz = (x[:, None] for x in p)
        dx, dy, dz = (x[:, None] for x in dr)
        rnx, rny, rnz = F[G_N], F[G_N + 1], F[G_N + 2]
        denom = dx * rnx + dy * rny + dz * rnz
        pn = px * rnx + py * rny + pz * rnz
        fac = (F[G_NOFF] - pn) / denom
        ex = px + dx * fac - F[G_POS]
        ey = py + dy * fac - F[G_POS + 1]
        ez = pz + dz * fac - F[G_POS + 2]
        pdx = ex * F[G_WU] + ey * F[G_WU + 1] + ez * F[G_WU + 2]
        pdy = ex * F[G_HU] + ey * F[G_HU + 1] + ez * F[G_HU + 2]
        # compare chain: false on NaN, like the TPU kernel's min-tree
        valid = ((denom < 0) & (fac >= 0) & (pdx >= 0)
                 & (F[G_WLEN] - pdx >= 0) & (pdy >= 0)
                 & (F[G_HLEN] - pdy >= 0))
        dist = torch.where(valid, fac, torch.full_like(fac, MISS))
        j = torch.argmin(dist, dim=1)
        jc = j[:, None]
        best = dist.gather(1, jc)[:, 0]
        hit = best < MISS * 0.5
        Fj = F[:, j]
        zero = torch.zeros_like(best)
        bpdx = torch.where(hit, pdx.gather(1, jc)[:, 0], zero)
        bpdy = torch.where(hit, pdy.gather(1, jc)[:, 0], zero)
        tx = torch.minimum(torch.floor(bpdx * Fj[G_WT] / Fj[G_WLEN]),
                           Fj[G_WT] - 1.0)
        ty = torch.minimum(torch.floor(bpdy * Fj[G_HT] / Fj[G_HLEN]),
                           Fj[G_HT] - 1.0)
        btex = (Fj[G_BASE].to(torch.int32)
                + ty.to(torch.int32) * Fj[G_WT].to(torch.int32)
                + tx.to(torch.int32))
        return best, btex, (Fj[G_N], Fj[G_N + 1], Fj[G_N + 2]), j
    return nearest


def trace_deposits_narrow_plain(
    scene: torch.Tensor, em_vec: torch.Tensor, uniforms: torch.Tensor,
    n_valid: int, cfg: PhotonConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `trace_deposits_narrow` on [B, U] uniforms: (idx
    [B, D] int32, col [B, 3D] f32), in tiles of photons so that no
    [photons, N] tensor passes 128 MB."""
    B = uniforms.shape[0]
    idx, col, _ = pw.trace_plain(
        narrow_nearest(scene), em_vec, n_valid, B, cfg,
        pw.uniform_draws(uniforms), chunk=rays_per_tile(scene.shape[1]))
    return idx, col.reshape(B, -1)


# --------------------------------------------------------------------------
# the kernel's wrapper
# --------------------------------------------------------------------------
def trace_deposits_narrow(
    scene: torch.Tensor, em_vec: torch.Tensor, uniforms: torch.Tensor,
    n_valid: int, cfg: PhotonConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trace one batch over the [F_GEN, N] table `scene` (`narrow_table`,
    or `scene_matrix` with its padding) from the emitter vector em_vec [16]
    (photon_wide.emitter_vector); photon p draws column c from uniforms[c,
    p] ([U, B] f32, U = 4 + 3 * max_depth: the layout of
    `threefry.batch_uniforms(..., transposed=True)`, which the kernel reads
    coalesced). Returns (idx [B, D] int32, col [B, 3D] f32); dead photons
    and the bounces from a miss on give id 0 and color 0.

    CUDA tensors launch `csrc/trace_deposits_narrow.cu` (the port of
    photon_pallas.trace_deposits_pallas); a failed build or launch raises.
    CPU tensors run the plain version on the [B, U] view."""
    if scene.dim() != 2 or scene.shape[0] != F_GEN:
        raise ValueError(f"scene table must be [{F_GEN}, N], got "
                         f"{tuple(scene.shape)}")
    if scene.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {scene.device}")
    if tuple(em_vec.shape) != (16,):
        raise ValueError(f"em_vec must be [16], got {tuple(em_vec.shape)}")
    U = pw.uniforms_per_photon(cfg.max_depth)
    if uniforms.dim() != 2 or uniforms.shape[0] != U:
        raise ValueError(f"uniforms must be [U, B] with U = {U}, got "
                         f"{tuple(uniforms.shape)}")
    B = uniforms.shape[1]
    check_on(scene.device, scene=scene, em_vec=em_vec, uniforms=uniforms)
    if not 0 <= int(n_valid) <= B:
        raise ValueError(f"n_valid={n_valid} outside [0, {B}]")
    if scene.device.type == "cpu":
        return trace_deposits_narrow_plain(scene, em_vec, uniforms.t(),
                                           n_valid, cfg)
    D = int(cfg.max_depth)
    idx = torch.empty((B, D), dtype=torch.int32, device=scene.device)
    col = torch.empty((B, 3 * D), dtype=torch.float32, device=scene.device)
    f = np.float32
    launch("fm_trace_deposits_narrow", scene.device, scene.data_ptr(),
           em_vec.data_ptr(), uniforms.data_ptr(), idx.data_ptr(),
           col.data_ptr(), B, scene.shape[1], int(n_valid), D,
           f(cfg.self_intersect_eps), f(TWO_PI_REF), f(cfg.rr_mirror_prob),
           f(cfg.mirror_z_threshold), f(cfg.floor_tint_z_threshold),
           *(f(t) for t in cfg.floor_tint), f(cfg.albedo))
    trace_deposits_narrow.launches += 1
    return idx, col


trace_deposits_narrow.launches = 0


# --------------------------------------------------------------------------
# host side
# --------------------------------------------------------------------------
def trace_batch_narrow(lightmap: torch.Tensor, scene: torch.Tensor,
                       em_vec: torch.Tensor, uniforms: torch.Tensor,
                       n_valid: int, cfg: PhotonConfig) -> torch.Tensor:
    """Trace one batch ([U, B] uniforms) and add its deposits into
    `lightmap` [T, 3] in place through `fused_splat_add`
    (photon_pallas.trace_batch_pallas, which adds in f32; the int64
    fixed-point sum here is exact); returns it."""
    idx, col = trace_deposits_narrow(scene, em_vec, uniforms, n_valid, cfg)
    fused_splat_add(lightmap, idx.reshape(-1), col.reshape(-1, 3),
                    splat_bound(cfg, idx.shape[0]), bf16=False)
    return lightmap


def render_photons(rects: Rects, emitters: Emitters, num_texels: int,
                   cfg: PhotonConfig, checkpoint_path: str = None,
                   on_segment=None) -> torch.Tensor:
    """Full photon pass through the narrow kernel on the rect table's
    device: the raw (un-normalized) [num_texels, 3] lightmap
    (photon_pallas.render_photons)."""
    from .schedule import run_schedule

    scene = narrow_table(rects)
    evs = {}

    def trace(lm, e, u_t, n_valid):
        if e not in evs:
            evs[e] = pw.emitter_vector(emitters, e)
        trace_batch_narrow(lm, scene, evs[e], u_t, n_valid, cfg)

    return run_schedule(trace, emitters, num_texels, cfg, transposed=True,
                        checkpoint_path=checkpoint_path,
                        on_segment=on_segment)
