"""Stream splats: sum a photon batch's deposit stream (texel id [R] int32,
color [R, 3] f32) into a [T, 3] f32 lightmap increment.

Counterpart of flatmatch_tpu/ops/splat_pallas.py (`fused_splat_i8`,
`fused_splat`, `dither01`), of ops/splat.scatter_splat and of the mode
dispatch engines/photon_pallas_wide._splat (:1527-1568), which
`splat_stream` mirrors. The wrappers launch `csrc/splat_stream.cu` for CUDA
tensors and run the plain versions for CPU tensors only:

- `fused_splat_i8`: the dithered 7-bit grid, an exact int32 sum, de-scaled
  once; equal to the JAX package's bit for bit.
- `fused_splat`: colors rounded to bf16 once, summed in f32. The kernel sums
  64-bit fixed-point integers (see the source note), so two runs give the
  same bits; the plain version sums in `index_add_`'s f32 order.
- `scatter_splat`: the same kernel on the f32 colors (`scatter`,
  `bucket_exact`).

The TPU's MXU pass depth K (photon_pallas_wide.py:1553) only groups its f32
sums and has no counterpart here.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import PhotonConfig
from ..utils.cuda_build import launch
from . import rng

BF16_MODES = ("fused", "bucket")          # bf16 colors, f32 sums
F32_MODES = ("scatter", "bucket_exact")   # f32 colors, f32 sums
STREAM_MODES = ("fused_i8",) + BF16_MODES + F32_MODES


def splat_color_scale(cfg: PhotonConfig) -> float:
    """7-bit grid: the brightest emitter channel / 127 bounds every
    deposit (colors only attenuate, photonmap.cl:236-254)."""
    return max(*cfg.window_color, *cfg.light_color) / 127.0


def stream_bound(cfg: PhotonConfig) -> float:
    """A bound on the summed colors of any batch's stream: every photon of
    a full batch depositing the brightest emitter color at every bounce.
    It comes from the config, never from a stream's length, so an
    emitter's shortened tail batch is summed at the same fixed-point scale
    as a full one."""
    return (float(cfg.photons_per_batch) * cfg.max_depth
            * splat_color_scale(cfg) * 127.0)


def fixed_point_scale(total_bound: float):
    """(2^k, 2^-k) for the fixed-point f32 splat: the largest k at which a
    texel sum up to `total_bound` stays within 2^62 in int64."""
    if not total_bound > 0 or not math.isfinite(total_bound):
        raise ValueError(f"total_bound must be positive, got {total_bound}")
    k = 62 - math.ceil(math.log2(total_bound))
    k = max(-120, min(120, k))
    return 2.0 ** k, 2.0 ** -k


def dither01(rows: int, device="cpu") -> torch.Tensor:
    """[rows, 3] dither in [0, 1) keyed by row * 3 + channel
    (splat_pallas.dither01: fmix32(key * 0x9E3779B9) >>> 8, times 2^-24)."""
    key = torch.arange(3 * int(rows), dtype=torch.int64, device=device)
    return rng.dither(key).reshape(int(rows), 3)


def _in_range(idx: torch.Tensor, num_texels: int) -> torch.Tensor:
    return (idx >= 0) & (idx < int(num_texels))


def fused_splat_i8_plain(idx, col, num_texels: int, scale: float):
    """Plain version of `fused_splat_i8`: q = clip(floor(col * f32(1/scale)
    + dither01), 0, 127) summed into int32 [T, 3], times f32(scale)."""
    inv = float(np.float32(1.0 / scale))
    q = torch.clamp(torch.floor(col * inv + dither01(col.shape[0],
                                                     col.device)),
                    0.0, 127.0).to(torch.int32)
    keep = _in_range(idx, num_texels)
    acc = torch.zeros((int(num_texels), 3), dtype=torch.int32,
                      device=idx.device)
    acc.index_add_(0, idx[keep].to(torch.int64), q[keep])
    return acc.to(torch.float32) * float(np.float32(scale))


def scatter_plain(idx, col, num_texels: int):
    """Plain version of `scatter_splat`: f32 colors, `index_add_`."""
    keep = _in_range(idx, num_texels)
    out = torch.zeros((int(num_texels), 3), dtype=torch.float32,
                      device=idx.device)
    return out.index_add_(0, idx[keep].to(torch.int64), col[keep])


def fused_splat_plain(idx, col, num_texels: int):
    """Plain version of `fused_splat`: colors rounded to bf16 once (round
    to nearest even), summed in f32 by `index_add_`."""
    return scatter_plain(idx, col.to(torch.bfloat16).to(torch.float32),
                         num_texels)


def _check_stream(idx, col, num_texels) -> int:
    """The stream must be contiguous int32 [R] and f32 [R, 3] on one CPU or
    CUDA device. Returns R."""
    if idx.dim() != 1 or tuple(col.shape) != (idx.shape[0], 3):
        raise ValueError(f"stream must be idx [R] and col [R, 3], got "
                         f"{tuple(idx.shape)} and {tuple(col.shape)}")
    if idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError("idx must be contiguous int32")
    if col.dtype != torch.float32 or not col.is_contiguous():
        raise ValueError("col must be contiguous float32")
    if col.device != idx.device or idx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"idx ({idx.device}) and col ({col.device}) must "
                         f"lie on one CPU or CUDA device")
    if not 0 <= 3 * int(num_texels) < 2**31:
        raise ValueError(f"num_texels={num_texels} out of range")
    if 3 * idx.shape[0] >= 2**31:
        raise ValueError(f"{idx.shape[0]} rows: index past 2^31")
    return idx.shape[0]


def fused_splat_i8(idx: torch.Tensor, col: torch.Tensor, num_texels: int,
                   scale: float) -> torch.Tensor:
    """[num_texels, 3] f32 sum of the stream on the 7-bit grid of spacing
    `scale` (every color must lie in [0, 127 * scale]).

    CUDA tensors launch `csrc/splat_stream.cu` (the port of
    splat_pallas.fused_splat_i8); a failed launch raises. CPU tensors run
    the plain version."""
    R = _check_stream(idx, col, num_texels)
    if 127 * R >= 2**31:
        raise ValueError(f"{R} rows can overflow the int32 accumulator")
    if idx.device.type == "cpu":
        return fused_splat_i8_plain(idx, col, num_texels, scale)
    dev = idx.device
    acc = torch.empty((int(num_texels), 3), dtype=torch.int32, device=dev)
    out = torch.empty((int(num_texels), 3), dtype=torch.float32, device=dev)
    launch("fm_fused_splat_i8", dev, idx.data_ptr(), col.data_ptr(),
           acc.data_ptr(), out.data_ptr(), R, int(num_texels),
           np.float32(1.0 / scale), np.float32(scale))
    fused_splat_i8.launches += 1
    return out


fused_splat_i8.launches = 0


def fused_splat(idx: torch.Tensor, col: torch.Tensor, num_texels: int,
                total_bound: float, bf16: bool = True) -> torch.Tensor:
    """[num_texels, 3] f32 sum of the stream, colors rounded to bf16 first
    unless `bf16` is off. `total_bound` bounds the summed |colors| of the
    stream (`stream_bound`); it sets the fixed-point scale.

    CUDA tensors launch `csrc/splat_stream.cu` (the port of
    splat_pallas.fused_splat, deterministic: no float atomics); a failed
    launch raises. CPU tensors run the plain versions."""
    R = _check_stream(idx, col, num_texels)
    to_fixed, from_fixed = fixed_point_scale(total_bound)
    if idx.device.type == "cpu":
        if bf16:
            return fused_splat_plain(idx, col, num_texels)
        return scatter_plain(idx, col, num_texels)
    dev = idx.device
    acc = torch.empty((int(num_texels), 3), dtype=torch.int64, device=dev)
    out = torch.empty((int(num_texels), 3), dtype=torch.float32, device=dev)
    launch("fm_fused_splat", dev, idx.data_ptr(), col.data_ptr(),
           acc.data_ptr(), out.data_ptr(), R, int(num_texels), int(bf16),
           np.float32(to_fixed), np.float32(from_fixed))
    fused_splat.launches += 1
    return out


fused_splat.launches = 0


def scatter_splat(idx: torch.Tensor, col: torch.Tensor, num_texels: int,
                  total_bound: float) -> torch.Tensor:
    """The exact-tier splat (ops/splat.scatter_splat): `fused_splat` on the
    f32 colors, the same kernel (it counts its launches)."""
    return fused_splat(idx, col, num_texels, total_bound, bf16=False)


def splat_stream(lm: torch.Tensor, idx: torch.Tensor, col: torch.Tensor,
                 cfg: PhotonConfig) -> torch.Tensor:
    """Add one batch's stream into the f32 lightmap `lm` [T, 3] in place,
    by cfg.splat (photon_pallas_wide._splat): fused_i8 on the 7-bit grid,
    fused and bucket with bf16 colors, scatter and bucket_exact with f32
    colors. Returns `lm`."""
    mode = cfg.splat
    T = lm.shape[0]
    if mode == "fused_i8":
        inc = fused_splat_i8(idx, col, T, splat_color_scale(cfg))
    elif mode in BF16_MODES + F32_MODES:
        inc = fused_splat(idx, col, T, stream_bound(cfg),
                          bf16=mode in BF16_MODES)
    else:
        raise ValueError(f"unknown splat mode {cfg.splat!r}")
    lm += inc
    return lm
