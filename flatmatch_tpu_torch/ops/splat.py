"""Stream splats: sum a photon batch's deposit stream (texel id [R] int32,
color [R, 3] f32) into a [T, 3] f32 lightmap increment.

Counterpart of flatmatch_tpu/ops/splat_pallas.py (`fused_splat_i8`,
`fused_splat`, `dither01`), of ops/splat.scatter_splat and of the mode
dispatch engines/photon_pallas_wide._splat (:1527-1568), which
`splat_stream` mirrors. The wrappers launch `csrc/splat_stream.cu` for CUDA
tensors and run the plain versions for CPU tensors only:

- `fused_splat_i8`: the dithered 7-bit grid, an exact int32 sum, de-scaled
  once; equal to the JAX package's bit for bit. `fused_splat_i8_add` adds
  that sum into a lightmap in the pass that de-scales it (what
  `splat_stream` calls): `lm += fused_splat_i8(...)` bit for bit.
- `fused_splat`: colors rounded to bf16 once, summed in f32. The kernel sums
  64-bit fixed-point integers (see the source note), so two runs give the
  same bits; the plain version sums in `index_add_`'s f32 order, and
  `fused_splat_fixed_plain` is the kernel's exact function in torch (the
  card's result equals it bit for bit).
- `scatter_splat`: the same kernel on the f32 colors (`scatter`,
  `bucket_exact`).
- `fused_splat_add`: the same kernel adding its sum into a lightmap in the
  pass that converts it (what `splat_stream`, the diff renderer's stream
  tier and the general engines call): `lm += fused_splat(...)` bit for bit.

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


def fixed_point_scale(total_bound: float, corr: torch.Tensor = None):
    """(2^k, 2^-k) for the fixed-point f32 splats: the largest k at which a
    texel sum up to `total_bound` stays within 2^62 in int64, k = 62 -
    ceil(log2(bound)) clipped to [-120, 120]. ceil(log2) comes exactly from
    the bound's binary exponent (frexp), so a power of two is its own.

    Without `corr`: two Python floats. With `corr`, a one-element f32 tensor
    (the diff tier's grid correction, which scales the deposit bound with
    power and albedo), the bound is total_bound * corr, taken in float64, and
    the pair comes back as a [2] f32 tensor on corr's device, computed there
    without a host sync; at corr == 1 it holds the same two values."""
    if not total_bound > 0 or not math.isfinite(total_bound):
        raise ValueError(f"total_bound must be positive, got {total_bound}")
    if corr is None:
        m, e = math.frexp(total_bound)
        k = max(-120, min(120, 62 - (e - 1 if m == 0.5 else e)))
        return 2.0 ** k, 2.0 ** -k
    m, e = torch.frexp(corr.reshape(()).to(torch.float64) * total_bound)
    k = torch.clamp(62 - e + (m == 0.5).to(e.dtype), -120, 120)
    one = torch.ones((2,), dtype=torch.float64, device=corr.device)
    return torch.ldexp(one, torch.stack([k, -k])).to(torch.float32)


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


def fixed_point_sums(idx, col, num_texels: int, to_fixed: float,
                     bf16: bool = True) -> torch.Tensor:
    """The integer stage of the f32 stream splat's kernel (to_fixed in
    csrc/trace_wide.cuh): each color, rounded to bf16 first with `bf16`,
    becomes round(c * to_fixed) to nearest even as an int64 (the f32
    product is exact: to_fixed is a power of two), and the integers are
    summed per texel and channel into int64 [T, 3], wrapping as the card's
    int64 sums wrap. Ids outside [0, T) are dropped; zeros add nothing."""
    c = col.to(torch.bfloat16).to(torch.float32) if bf16 else col
    v = torch.round(c.to(torch.float64) * float(to_fixed)).to(torch.int64)
    keep = _in_range(idx, num_texels)
    acc = torch.zeros((int(num_texels), 3), dtype=torch.int64,
                      device=idx.device)
    return acc.index_add_(0, idx[keep].to(torch.int64), v[keep])


def fused_splat_fixed_plain(idx, col, num_texels: int, total_bound: float,
                            bf16: bool = True) -> torch.Tensor:
    """The f32 stream splat's exact function (`fused_splat` on the card,
    either instance, bit for bit): `fixed_point_sums` at the scale 2^k of
    `fixed_point_scale(total_bound)`, each sum converted to f32 once
    (round to nearest even) and times 2^-k."""
    to_fixed, from_fixed = fixed_point_scale(total_bound)
    acc = fixed_point_sums(idx, col, num_texels, to_fixed, bf16)
    return acc.to(torch.float32) * float(np.float32(from_fixed))


def splat_accumulator(num_texels: int, i8: bool = False):
    """(instance, shared bytes) of the f32 stream splat's kernel (with
    `i8`, of the 7-bit one's) for an arena of num_texels texels, as
    csrc/splat_stream.cu chooses them (fm_fused_splat_plan,
    fm_fused_splat_i8_plan): "arena" when the int64 (int32) [T, 3] sums fit
    in a block's shared memory, else "paged". It asks the kernel library,
    so it needs the CUDA build."""
    import ctypes

    from ..utils.cuda_build import load_library

    inst, smem = ctypes.c_int(), ctypes.c_int()
    lib = load_library()
    plan = lib.fm_fused_splat_i8_plan if i8 else lib.fm_fused_splat_plan
    plan(int(num_texels), ctypes.byref(inst), ctypes.byref(smem))
    return ("arena", "paged")[inst.value], smem.value


# One zeroed scratch per device and stream for each stream splat, int64 for
# the f32 splat, int32 for the 7-bit one, kept across calls as a cache of
# device memory: the kernels need it zero on entry and every launch of
# fm_fused_splat(_add) and fm_fused_splat_i8(_add) leaves it zero, so no
# call clears it. Calls on one stream run in order; calls on two streams of
# a device may run at once, so each stream has its own.
_fixed_scratch = {}
_i8_scratch = {}


def _scratch_key(dev):
    """The scratch of PyTorch's current stream on CUDA device `dev`."""
    return dev, torch.cuda.current_stream(dev).cuda_stream


def _scratch(dev, n: int, cache=_fixed_scratch,
             dtype=torch.int64) -> torch.Tensor:
    key = _scratch_key(dev)
    buf = cache.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=dtype, device=dev)
        cache[key] = buf
    return buf


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


def _check_i8(idx, col, num_texels) -> int:
    """_check_stream, and every partial sum of the int32 accumulator (127
    a row at most) below 2^31."""
    R = _check_stream(idx, col, num_texels)
    if 127 * R >= 2**31:
        raise ValueError(f"{R} rows can overflow the int32 accumulator")
    return R


def _check_lm(lm, idx):
    if (lm.dim() != 2 or lm.shape[1] != 3 or lm.dtype != torch.float32
            or not lm.is_contiguous() or lm.device != idx.device):
        raise ValueError(f"lm must be contiguous float32 [T, 3] on "
                         f"{idx.device}, got {lm.dtype} "
                         f"{tuple(lm.shape)} on {lm.device}")


def _launch_scratch(entry, out, idx, col, R, num_texels, *args,
                    cache=_fixed_scratch, dtype=torch.int64):
    """Launch a stream splat's entry point `entry` on the zeroed scratch
    (`cache`, of `dtype`) of the device's current stream; on a failed
    launch the scratch is dropped (a later call makes a zeroed one) and the
    error raised."""
    dev = idx.device
    acc = _scratch(dev, 3 * int(num_texels), cache, dtype)
    try:
        launch(entry, dev, idx.data_ptr(), col.data_ptr(), acc.data_ptr(),
               out.data_ptr(), R, int(num_texels), *args)
    except RuntimeError:
        cache.pop(_scratch_key(dev), None)
        raise


def _launch_i8(entry, out, idx, col, R, num_texels, scale):
    _launch_scratch(entry, out, idx, col, R, num_texels,
                    np.float32(1.0 / scale), np.float32(scale),
                    cache=_i8_scratch, dtype=torch.int32)
    fused_splat_i8.launches += 1


def fused_splat_i8(idx: torch.Tensor, col: torch.Tensor, num_texels: int,
                   scale: float) -> torch.Tensor:
    """[num_texels, 3] f32 sum of the stream on the 7-bit grid of spacing
    `scale` (every color must lie in [0, 127 * scale]).

    CUDA tensors launch `csrc/splat_stream.cu` (the port of
    splat_pallas.fused_splat_i8, exact integer sums: equal to
    `fused_splat_i8_plain` bit for bit); a failed launch raises. CPU
    tensors run the plain version."""
    R = _check_i8(idx, col, num_texels)
    if idx.device.type == "cpu":
        return fused_splat_i8_plain(idx, col, num_texels, scale)
    out = torch.empty((int(num_texels), 3), dtype=torch.float32,
                      device=idx.device)
    _launch_i8("fm_fused_splat_i8", out, idx, col, R, num_texels, scale)
    return out


fused_splat_i8.launches = 0


def fused_splat_i8_add(lm: torch.Tensor, idx: torch.Tensor,
                       col: torch.Tensor, scale: float) -> torch.Tensor:
    """Add the stream's `fused_splat_i8` sum into the f32 lightmap `lm`
    [T, 3] in place, bit for bit `lm += fused_splat_i8(idx, col, T,
    scale)`; returns `lm`.

    CUDA tensors launch the same kernel as `fused_splat_i8`, whose
    finishing pass adds f32(sum) * scale into `lm`; its launches count
    there and here. A failed launch raises. CPU tensors add the plain
    version's sum."""
    R = _check_i8(idx, col, lm.shape[0])
    _check_lm(lm, idx)
    if idx.device.type == "cpu":
        lm += fused_splat_i8_plain(idx, col, lm.shape[0], scale)
        return lm
    _launch_i8("fm_fused_splat_i8_add", lm, idx, col, R, lm.shape[0], scale)
    fused_splat_i8_add.launches += 1
    return lm


fused_splat_i8_add.launches = 0


def _launch_fixed(entry, out, idx, col, R, num_texels, total_bound, bf16):
    to_fixed, from_fixed = fixed_point_scale(total_bound)
    _launch_scratch(entry, out, idx, col, R, num_texels, int(bf16),
                    np.float32(to_fixed), np.float32(from_fixed))
    fused_splat.launches += 1


def fused_splat(idx: torch.Tensor, col: torch.Tensor, num_texels: int,
                total_bound: float, bf16: bool = True) -> torch.Tensor:
    """[num_texels, 3] f32 sum of the stream, colors rounded to bf16 first
    unless `bf16` is off. `total_bound` bounds the summed |colors| of the
    stream (`stream_bound`); it sets the fixed-point scale.

    CUDA tensors launch `csrc/splat_stream.cu` (the port of
    splat_pallas.fused_splat, deterministic: no float atomics; equal to
    `fused_splat_fixed_plain` bit for bit); a failed launch raises. CPU
    tensors run the plain versions."""
    R = _check_stream(idx, col, num_texels)
    if idx.device.type == "cpu":
        fixed_point_scale(total_bound)   # refuses a bound with no scale
        if bf16:
            return fused_splat_plain(idx, col, num_texels)
        return scatter_plain(idx, col, num_texels)
    out = torch.empty((int(num_texels), 3), dtype=torch.float32,
                      device=idx.device)
    _launch_fixed("fm_fused_splat", out, idx, col, R, num_texels,
                  total_bound, bf16)
    return out


fused_splat.launches = 0


def scatter_splat(idx: torch.Tensor, col: torch.Tensor, num_texels: int,
                  total_bound: float) -> torch.Tensor:
    """The exact-tier splat (ops/splat.scatter_splat): `fused_splat` on the
    f32 colors, the same kernel (it counts its launches)."""
    return fused_splat(idx, col, num_texels, total_bound, bf16=False)


def fused_splat_add(lm: torch.Tensor, idx: torch.Tensor, col: torch.Tensor,
                    total_bound: float, bf16: bool = True) -> torch.Tensor:
    """Add the stream's `fused_splat` sum into the f32 lightmap `lm`
    [T, 3] in place, bit for bit `lm += fused_splat(idx, col, T,
    total_bound, bf16)`; returns `lm`.

    CUDA tensors launch the same kernel as `fused_splat` (its launches
    count there), whose finishing pass adds f32(sum) * 2^-k into `lm`; a
    failed launch raises. CPU tensors add the plain version's sum."""
    R = _check_stream(idx, col, lm.shape[0])
    _check_lm(lm, idx)
    if idx.device.type == "cpu":
        lm += fused_splat(idx, col, lm.shape[0], total_bound, bf16)
        return lm
    _launch_fixed("fm_fused_splat_add", lm, idx, col, R, lm.shape[0],
                  total_bound, bf16)
    return lm


def splat_stream(lm: torch.Tensor, idx: torch.Tensor, col: torch.Tensor,
                 cfg: PhotonConfig) -> torch.Tensor:
    """Add one batch's stream into the f32 lightmap `lm` [T, 3] in place,
    by cfg.splat (photon_pallas_wide._splat): fused_i8 on the 7-bit grid,
    fused and bucket with bf16 colors, scatter and bucket_exact with f32
    colors. Returns `lm`."""
    mode = cfg.splat
    if mode == "fused_i8":
        fused_splat_i8_add(lm, idx, col, splat_color_scale(cfg))
    elif mode in BF16_MODES + F32_MODES:
        fused_splat_add(lm, idx, col, stream_bound(cfg),
                        bf16=mode in BF16_MODES)
    else:
        raise ValueError(f"unknown splat mode {cfg.splat!r}")
    return lm
