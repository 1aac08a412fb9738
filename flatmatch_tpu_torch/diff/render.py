"""Differentiable photon rendering: gradients with respect to per-rect albedo
and per-emitter power, on the wide kernels.

Counterpart of flatmatch_tpu/diff/render.py `make_diff_renderer_wide`, every
tier of it (diff/render.py:363-500):
- the in-kernel tiers: the 7-bit splat for `inkernel_i8` and `fused_i8`,
  bf16 colors summed in f32 for `inkernel` and `fused` (as the JAX renderer
  maps them, :364-366), with the counter-hash draws (`device_rng`) or the
  threefry draws; the forward splats inside the trace kernel, the backward
  replays each batch and folds the cotangent inside the kernel;
- the deposit-stream tier (`scatter`, `bucket`, `bucket_exact`), which
  draws threefry under either `device_rng` setting, as JAX does (:366):
  the forward traces the diff stream and splats it (f32 colors, or bf16
  for `bucket`), the backward traces it again and folds it in torch ops
  with the unrounded f32 cotangent (`stream_fold`, JAX's XLA fold
  :488-500).
Photon trajectories depend only on the draws and the geometry, never on
albedo or power, and every deposit is

    deposit(d) = power[e] * base_color * prod_{diffuse hits k<=d} albedo[r_k] * tint_k

so the backward saves only the parameters and replays each batch from its
seed or its uniforms, folding the lightmap cotangent g:

    w(p, d)     = <g[texel(p, d)], deposit(p, d)>
    S(p, k)     = sum_{d>=k} w(p, d)
    d_albedo[r] = sum_{p, k: diffuse hit on r} S(p, k) / albedo[r]
    d_power[e]  = sum_{p in e} S(p, 0) / power[e]
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import PhotonConfig
from ..engines import photon_wide as pw
from ..ops import rng, threefry
from ..ops.aa_scene import AARects
from ..ops.device_scene import Emitters
from ..ops.splat import fixed_point_scale, fused_splat_add, stream_bound

IN_KERNEL_TIERS = ("inkernel", "inkernel_i8", "fused", "fused_i8")
STREAM_TIERS = ("scatter", "bucket", "bucket_exact")
DIFF_SUBLANES = 32     # make_diff_renderer_wide's default block height


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


def _const(x, like: torch.Tensor) -> torch.Tensor:
    return torch.full((1,), np.float32(x), dtype=torch.float32,
                      device=like.device)


def grid_corr(cfg: PhotonConfig, power_e: torch.Tensor,
              albedo_aa: torch.Tensor) -> torch.Tensor:
    """corr = max(1, |power[e]|) * max(1, max(albedo_aa))^D, a one-element
    f32 tensor on the parameters' device: the factor by which power and
    albedo can raise one emitter's deposit bound (diff/render.py:274-296).
    It is exactly 1 at power <= 1 and albedo <= 1."""
    one = _const(1.0, albedo_aa)
    return torch.maximum(one, torch.abs(power_e)) * _integer_pow(
        torch.maximum(one, torch.max(albedo_aa)), int(cfg.max_depth))


def scale_pair(cfg: PhotonConfig, power_e: torch.Tensor,
               albedo_aa: torch.Tensor):
    """The dynamic 7-bit grid of one emitter (diff/render.py:274-296):
    (scale, inv_scale) = (base_s * corr, base_inv / corr) with the
    production constants in f32 and corr = `grid_corr`. At power <= 1 and
    albedo <= 1 both equal the production grid. Returns two one-element
    f32 tensors on the parameters' device."""
    corr = grid_corr(cfg, power_e, albedo_aa)
    return (_const(pw.splat_color_scale(cfg), albedo_aa) * corr,
            _const(1.0 / pw.splat_color_scale(cfg), albedo_aa) / corr)


def fixed_pair(cfg: PhotonConfig, power_e: torch.Tensor,
               albedo_aa: torch.Tensor, batch_size: int) -> torch.Tensor:
    """The f32 tier's fixed-point scale of one emitter: (2^k, 2^-k) as a [2]
    f32 tensor on the parameters' device, for the stream bound of
    `batch_size`-photon batches times `grid_corr`, computed there with no
    host sync. At corr == 1 it is the production route's scale."""
    bound = stream_bound(dataclasses.replace(cfg,
                                             photons_per_batch=batch_size))
    return fixed_point_scale(bound, grid_corr(cfg, power_e, albedo_aa))


def stream_total_bound(cfg: PhotonConfig, power_e: torch.Tensor,
                       albedo_aa: torch.Tensor, batch_size: int) -> float:
    """The stream tier's splat bound of one emitter, a host float for
    `fused_splat_add`: the stream bound of `batch_size`-photon batches times
    `grid_corr`, read from the parameters' device once. Its fixed-point
    scale is `fixed_pair`'s (the product is taken in float64 both ways)."""
    bound = stream_bound(dataclasses.replace(cfg,
                                             photons_per_batch=batch_size))
    return bound * float(grid_corr(cfg, power_e, albedo_aa))


def check_diff_cfg(cfg: PhotonConfig):
    """Refuse a configuration the differentiable renderer cannot run: an
    unknown splat mode or a batch under one photon."""
    if cfg.splat not in IN_KERNEL_TIERS + STREAM_TIERS:
        raise ValueError(f"unknown splat mode {cfg.splat!r}")
    if int(cfg.photons_per_batch) < 1:
        raise ValueError(f"photons_per_batch must be >= 1, got "
                         f"{cfg.photons_per_batch}")


def diff_batch_size(cfg: PhotonConfig) -> int:
    """The JAX renderer's batch: photons_per_batch rounded up to a multiple
    of 128 (diff/render.py:371-377). The batch fixes the schedule and so
    the photon set."""
    B = int(cfg.photons_per_batch)
    return -(-B // pw.LANES) * pw.LANES


def diff_block(batch_size: int) -> int:
    """Photons per block of the diff stream's row order: the JAX renderer's
    TB = S * 128 with S = 32 halved until TB divides the batch
    (diff/render.py:371-377). A 131072-photon batch has 4096-photon blocks,
    not the render stream's 8192 (`photon_wide.stream_block`)."""
    B = int(batch_size)
    s = DIFF_SUBLANES
    while s > 1 and B % (s * pw.LANES):
        s //= 2
    return s * pw.LANES


def stream_fold(idx: torch.Tensor, col: torch.Tensor, ridx: torch.Tensor,
                g_c: torch.Tensor, n_slots: int, block: int, depth: int):
    """The stream tier's backward fold of one batch's diff stream (JAX's
    XLA fold, diff/render.py:488-500), in torch ops on the stream's device:
    w = sum_ch g_c[idx] * col with the unrounded f32 cotangent (unlike
    `photon_wide.fold_plain`, which rounds g to bf16 as the in-kernel fold
    does), inclusive suffix sums over the `depth` bounces of the row
    order's [blocks, depth, block] view, da[ridx] += S at ridx >= 0, and
    w_sum = sum w. The per-slot sums are a stable sort by slot and a
    segment sum, a fixed order (index_add_ on CUDA floats is not), so two
    runs give the same bits. Returns (da_slots [n_slots], w_sum),
    undivided."""
    w = torch.sum(g_c[idx.to(torch.int64)] * col, dim=-1)
    w3 = w.reshape(-1, int(depth), int(block))
    suf = torch.flip(torch.cumsum(torch.flip(w3, [1]), 1), [1]).reshape(-1)
    hit = ridx >= 0
    slots, order = torch.sort(ridx[hit], stable=True)
    lengths = torch.bincount(slots, minlength=int(n_slots))
    da = torch.segment_reduce(suf[hit][order], "sum", lengths=lengths)
    return da, w.sum()


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
        self.stream = cfg.splat in STREAM_TIERS
        # the stream tier draws threefry only (diff/render.py:366)
        self.device_rng = bool(cfg.device_rng) and not self.stream
        self.i8 = not self.stream and cfg.splat.endswith("_i8")
        if self.i8:
            pw.check_i8_accumulator(cfg, self.B)
        self.block = diff_block(self.B)
        self.U = pw.uniforms_per_photon(cfg.max_depth)
        self.aa_c, self.total_c, self.expand = pw.compact_aa(aa, num_texels)
        dev = aa.fields.device
        self.device = dev
        self.n_slots = int(self.aa_c.fields.shape[1])
        self.perm = torch.from_numpy(
            np.asarray(aa.perm, np.int64)).to(dev)       # slot -> rect
        self.arena_pos = torch.from_numpy(
            pw.compact_arena_positions(aa)).to(dev)
        self.schedule = pw.emitter_schedule(emitters.counts, self.B)
        # a shrunk tail batch keeps whole diff blocks on the stream tier, so
        # its stream is the first rows of the full batch's; threefry draws
        # the first rows of the full batch's uniforms (ops/threefry.py)
        self.batches = list(pw.schedule_batches(
            self.schedule, self.B, tail_shrink,
            self.block if self.stream else pw.THREADS))
        self.em_base = {e: pw.emitter_vector(emitters, e)
                        for e, *_ in self.schedule}

    def em_vec(self, e: int, power: torch.Tensor) -> torch.Tensor:
        """Emitter vector with its color scaled by power[e]
        (diff/render.py:389-391)."""
        v = self.em_base[e].clone()
        v[12:15] = v[12:15] * power[e]
        return v

    def emitter_grid(self, e: int, power: torch.Tensor,
                     albedo_aa: torch.Tensor):
        """Emitter e's scaled vector and the forward's run-time grid: the
        7-bit tiers' (scale, inv_scale), the f32 tier's fixed-point
        (2^k, 2^-k) for the deposit bound times `grid_corr`, or that bound
        itself on the host for the stream tier's splat."""
        if self.stream:
            grid = stream_total_bound(self.cfg, power[e], albedo_aa, self.B)
        elif self.i8:
            grid = scale_pair(self.cfg, power[e], albedo_aa)
        else:
            grid = fixed_pair(self.cfg, power[e], albedo_aa, self.B)
        return self.em_vec(e, power), grid

    def draws(self, gb: int, bsz: int) -> torch.Tensor:
        """Global batch gb's threefry uniforms, transposed to [U, bsz]."""
        return threefry.batch_uniforms(self.cfg.seed, gb, bsz, self.U,
                                       self.device, transposed=True)

    def live_rows(self, n_valid: int) -> int:
        """Stream rows of the diff blocks that hold live photons: the rows
        after them are zero deposits with no slot, so both passes stop
        there, and a batch gives the same bits at any tail size."""
        return -(-int(n_valid) // self.block) * self.block * \
            int(self.cfg.max_depth)

    def trace_stream(self, albedo_aa, ev, gb, nv, bsz):
        """The diff stream of one batch, cut to its live rows."""
        idx, col, ridx = pw.trace_deposits_wide_diff(
            self.aa_c.fields, self.aa_c.group_counts, albedo_aa, ev,
            self.draws(gb, bsz), nv, self.cfg, self.block)
        rows = self.live_rows(nv)
        return idx[:rows], col[:rows], ridx[:rows]

    def forward_loop(self, albedo, power) -> torch.Tensor:
        """The forward of every batch on the tier's kernels: the 7-bit
        accumulator de-scaled on the emitter's grid, the f32 increment
        added, or the diff stream splatted at the emitter's scale."""
        cfg, fields = self.cfg, self.aa_c.fields
        gc = self.aa_c.group_counts
        albedo_aa = albedo[self.perm].contiguous()
        lm = torch.zeros((self.total_c, 3), dtype=torch.float32,
                         device=self.device)
        acc = torch.empty((self.total_c, 3), dtype=torch.int32,
                          device=self.device)
        grids = {}
        for e, gb, nv, bsz in self.batches:
            if e not in grids:
                grids[e] = self.emitter_grid(e, power, albedo_aa)
            ev, g = grids[e]
            if self.stream:
                idx, col, _ = self.trace_stream(albedo_aa, ev, gb, nv, bsz)
                fused_splat_add(lm, idx, col, g, bf16=cfg.splat == "bucket")
            elif self.device_rng:
                seed = rng.batch_seed(cfg.seed, gb)
                if self.i8:
                    pw.trace_splat_wide_diff_rng_i8(
                        fields, gc, albedo_aa, ev, seed, nv, bsz, cfg,
                        self.total_c, g[1], out=acc)
                    lm += acc.to(torch.float32) * g[0]
                else:
                    lm += pw.trace_splat_wide_diff_rng_f32(
                        fields, gc, albedo_aa, ev, seed, nv, bsz, cfg,
                        self.total_c, g)
            elif self.i8:
                pw.trace_splat_wide_diff_i8(
                    fields, gc, albedo_aa, ev, self.draws(gb, bsz), nv, cfg,
                    self.total_c, g[1], out=acc)
                lm += acc.to(torch.float32) * g[0]
            else:
                lm += pw.trace_splat_wide_diff_f32(
                    fields, gc, albedo_aa, ev, self.draws(gb, bsz), nv, cfg,
                    self.total_c, g)
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
            if self.stream:
                idx, col, ridx = self.trace_stream(albedo_aa, evs[e], gb, nv,
                                                   bsz)
                da_b, w_sum = stream_fold(idx, col, ridx, g_c, self.n_slots,
                                          self.block, cfg.max_depth)
            elif self.device_rng:
                da_b, w_sum = pw.trace_fold_wide_rng(
                    fields, gc, albedo_aa, evs[e], g_c,
                    rng.batch_seed(cfg.seed, gb), nv, bsz, cfg, self.n_slots)
            else:
                da_b, w_sum = pw.trace_fold_wide(
                    fields, gc, albedo_aa, evs[e], g_c, self.draws(gb, bsz),
                    nv, cfg, self.n_slots)
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
    (flatmatch_tpu.diff.render.make_diff_renderer_wide), by tier:
    - `inkernel_i8`, `fused_i8`: forward `trace_splat_wide_diff_rng_i8`
      (device RNG) or `trace_splat_wide_diff_i8` (threefry) per batch,
      de-scaled on each emitter's dynamic grid;
    - `inkernel`, `fused`: `trace_splat_wide_diff_rng_f32` or
      `trace_splat_wide_diff_f32`;
    - `scatter`, `bucket`, `bucket_exact` (threefry only):
      `trace_deposits_wide_diff`, then the stream splat.
    Backward: the in-kernel tiers replay every batch with
    `trace_fold_wide_rng` or `trace_fold_wide`, which fold exact f32 colors
    against g rounded to bf16; the stream tier traces the stream again and
    folds it with `stream_fold`. `tail_shrink` runs each emitter's last
    batch on a smaller grid, bit-identically."""
    return WideDiffRenderer(emitters, num_texels, cfg, aa, tail_shrink)
