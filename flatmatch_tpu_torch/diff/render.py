"""Differentiable photon rendering: gradients with respect to per-rect albedo
and per-emitter power, on the wide kernels.

Counterpart of flatmatch_tpu/diff/render.py, its production tier
(`make_diff_renderer_wide` at device RNG and the in-kernel 7-bit splat).
Photon trajectories depend only on the draws and the geometry, never on
albedo or power, and every deposit is

    deposit(d) = power[e] * base_color * prod_{diffuse hits k<=d} albedo[r_k] * tint_k

so the backward saves only the parameters and replays each batch from its
seed (`trace_fold_wide_rng`), folding the lightmap cotangent g:

    w(p, d)     = <g[texel(p, d)], deposit(p, d)>
    S(p, k)     = sum_{d>=k} w(p, d)
    d_albedo[r] = sum_{p, k: diffuse hit on r} S(p, k) / albedo[r]
    d_power[e]  = sum_{p in e} S(p, 0) / power[e]
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import PhotonConfig
from ..engines import photon_wide as pw
from ..ops import rng
from ..ops.aa_scene import AARects
from ..ops.device_scene import Emitters


def _integer_pow(x: torch.Tensor, y: int) -> torch.Tensor:
    """x ** y by the square-and-multiply order of jax.lax.integer_pow, so
    the f32 roundings are the JAX renderer's."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return torch.ones_like(x) if acc is None else acc


def scale_pair(cfg: PhotonConfig, power_e: torch.Tensor,
               albedo_aa: torch.Tensor):
    """The dynamic 7-bit grid of one emitter (diff/render.py:274-296):
    corr = max(1, |power[e]|) * max(1, max(albedo_aa))^D covers the
    parameter-scaled deposit bound, and (scale, inv_scale) = (base_s *
    corr, base_inv / corr) with the production constants in f32. At
    power <= 1 and albedo <= 1, corr is exactly 1 and both equal the
    production grid. Returns two one-element f32 tensors on the
    parameters' device."""
    def const(x):
        return torch.full((1,), np.float32(x), dtype=torch.float32,
                          device=albedo_aa.device)

    one = const(1.0)
    corr = torch.maximum(one, torch.abs(power_e)) * _integer_pow(
        torch.maximum(one, torch.max(albedo_aa)), int(cfg.max_depth))
    return (const(pw.splat_color_scale(cfg)) * corr,
            const(1.0 / pw.splat_color_scale(cfg)) / corr)


def check_diff_cfg(cfg: PhotonConfig):
    """Refuse every tier of the differentiable renderer but its production
    one, the in-kernel 7-bit splat with the device RNG: the diff stream
    tiers and the threefry tiers are not ported yet."""
    if cfg.splat != "inkernel_i8":
        raise pw.unsupported(f"the differentiable renderer with "
                             f"splat={cfg.splat!r}")
    if not cfg.device_rng:
        raise pw.unsupported("the differentiable renderer with the threefry "
                             "draws (device_rng=False)")
    pw.check_port_cfg(cfg)


def diff_batch_size(cfg: PhotonConfig) -> int:
    """The JAX renderer's batch: photons_per_batch rounded up to a multiple
    of 128 (diff/render.py:371-377). The batch fixes the schedule and so
    the photon set."""
    B = int(cfg.photons_per_batch)
    return -(-B // pw.LANES) * pw.LANES


class WideDiffRenderer:
    """render(albedo [N_rects], power [N_emitters]) -> arena lightmap
    [num_texels, 3], differentiable in both (make_diff_renderer_wide).
    Runs on the scene table's device: CUDA tensors launch the kernels,
    CPU tensors run their plain versions."""

    def __init__(self, emitters: Emitters, num_texels: int,
                 cfg: PhotonConfig, aa: AARects, tail_shrink: bool = True):
        check_diff_cfg(cfg)
        self.cfg = cfg
        self.B = diff_batch_size(cfg)
        pw.check_i8_accumulator(cfg, self.B)
        self.aa_c, self.total_c, self.expand = pw.compact_aa(aa, num_texels)
        dev = aa.fields.device
        self.device = dev
        self.n_slots = int(self.aa_c.fields.shape[1])
        self.perm = torch.from_numpy(
            np.asarray(aa.perm, np.int64)).to(dev)       # slot -> rect
        self.arena_pos = torch.from_numpy(
            pw.compact_arena_positions(aa)).to(dev)
        self.schedule = pw.emitter_schedule(emitters.counts, self.B)
        self.batches = list(pw.schedule_batches(self.schedule, self.B,
                                                tail_shrink))
        self.em_base = {e: pw.emitter_vector(emitters, e)
                        for e, *_ in self.schedule}

    def em_vec(self, e: int, power: torch.Tensor) -> torch.Tensor:
        """Emitter vector with its color scaled by power[e]
        (diff/render.py:389-391)."""
        v = self.em_base[e].clone()
        v[12:15] = v[12:15] * power[e]
        return v

    def forward_loop(self, albedo, power) -> torch.Tensor:
        cfg, fields = self.cfg, self.aa_c.fields
        gc = self.aa_c.group_counts
        albedo_aa = albedo[self.perm].contiguous()
        lm = torch.zeros((self.total_c, 3), dtype=torch.float32,
                         device=self.device)
        acc = torch.empty((self.total_c, 3), dtype=torch.int32,
                          device=self.device)
        grid = {}
        for e, gb, nv, bsz in self.batches:
            if e not in grid:
                grid[e] = (self.em_vec(e, power),
                           *scale_pair(cfg, power[e], albedo_aa))
            ev, scale, inv_scale = grid[e]
            pw.trace_splat_wide_diff_rng_i8(
                fields, gc, albedo_aa, ev, rng.batch_seed(cfg.seed, gb), nv,
                bsz, cfg, self.total_c, inv_scale, out=acc)
            lm += acc.to(torch.float32) * scale
        return self.expand(lm)

    def backward_replay(self, albedo, power, g):
        cfg, fields = self.cfg, self.aa_c.fields
        gc = self.aa_c.group_counts
        albedo_aa = albedo[self.perm].contiguous()
        g_c = g[self.arena_pos].contiguous()    # exact transpose of expand
        da_slots = torch.zeros((self.n_slots,), dtype=torch.float32,
                               device=self.device)
        dpe, evs = {}, {}
        for e, gb, nv, bsz in self.batches:
            if e not in evs:
                evs[e] = self.em_vec(e, power)
                dpe[e] = torch.zeros((), dtype=torch.float32,
                                     device=self.device)
            da_b, w_sum = pw.trace_fold_wide_rng(
                fields, gc, albedo_aa, evs[e], g_c,
                rng.batch_seed(cfg.seed, gb), nv, bsz, cfg, self.n_slots)
            da_slots = da_slots + da_b
            dpe[e] = dpe[e] + w_sum
        d_power = torch.zeros_like(power)
        for e, w in dpe.items():
            d_power[e] = d_power[e] + torch.where(
                power[e] != 0, w / power[e], torch.zeros_like(w))
        keep = albedo_aa > 1e-12
        safe = torch.where(keep, albedo_aa, torch.ones_like(albedo_aa))
        da_slots = torch.where(keep, da_slots / safe,
                               torch.zeros_like(da_slots))
        d_albedo = torch.zeros_like(albedo).index_add_(0, self.perm,
                                                       da_slots)
        return d_albedo, d_power

    def __call__(self, albedo: torch.Tensor,
                 power: torch.Tensor) -> torch.Tensor:
        return _WideDiffRender.apply(albedo, power, self)


class _WideDiffRender(torch.autograd.Function):
    """Saves only (albedo, power); the backward replays the trajectories."""

    @staticmethod
    def forward(ctx, albedo, power, r):
        ctx.r = r
        ctx.save_for_backward(albedo, power)
        return r.forward_loop(albedo, power)

    @staticmethod
    def backward(ctx, g):
        albedo, power = ctx.saved_tensors
        d_albedo, d_power = ctx.r.backward_replay(albedo, power, g)
        return d_albedo, d_power, None


def make_diff_renderer_wide(emitters: Emitters, num_texels: int,
                            cfg: PhotonConfig, aa: AARects,
                            tail_shrink: bool = True) -> WideDiffRenderer:
    """Differentiable renderer on the wide kernels
    (flatmatch_tpu.diff.render.make_diff_renderer_wide at device RNG and
    splat inkernel_i8). Forward: `trace_splat_wide_diff_rng_i8` per batch,
    de-scaled on each emitter's dynamic grid. Backward: replays every batch
    with `trace_fold_wide_rng`. `tail_shrink` runs each emitter's last
    batch on a smaller grid, bit-identically."""
    return WideDiffRenderer(emitters, num_texels, cfg, aa, tail_shrink)
