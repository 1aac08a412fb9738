"""Counter-hash random numbers of the photon kernel, bit for bit.

The JAX package draws its main-path uniforms inside the wide kernel from
murmur3's fmix32 finalizer over (photon, draw column, batch seed)
(flatmatch_tpu/ops/splat_pallas.py:49-55, engines/photon_pallas_wide.py:
81-102 and :188-197). This module reproduces that arithmetic exactly, so the
port traces the same photons as the JAX package at the same seed.

All hash arithmetic wraps mod 2^32. torch has no logical right shift for
int32 (`>>` is arithmetic), so the work is done on int64 values holding the
int32 bit pattern: products of two int32-range values stay below 2^62, and
`& MASK32` keeps the low 32 bits, after which `>>` is logical. Every
function takes Python ints or int32/int64 tensors.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF

# hash constants as signed int32 values (the JAX package's spellings)
GOLDEN = -1640531527      # 0x9E3779B9: photon and dither-key multiplier
DRAW_STRIDE = 97929       # per-draw-column seed offset
SEED_STRIDE = 1000003     # per-run-seed batch seed multiplier
C1 = -2048144789          # 0x85EBCA6B: fmix32, and the device_seed stride
C2 = -1028477387          # 0xC2B2AE35: fmix32
TWO_POW_M24 = 1.0 / (1 << 24)


def _i64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    return int(x)


def wrap_i32(x):
    """Signed int32 value of the low 32 bits (an int64 tensor or an int)."""
    return ((x + (1 << 31)) & MASK32) - (1 << 31)


def _out(x):
    return x.to(torch.int32) if isinstance(x, torch.Tensor) else x


def _fmix32_u(x):
    """fmix32 on unsigned 32-bit values held in int64."""
    x = x ^ (x >> 16)
    x = (wrap_i32(x) * C1) & MASK32
    x = x ^ (x >> 13)
    x = (wrap_i32(x) * C2) & MASK32
    return x ^ (x >> 16)


def fmix32(x):
    """murmur3 finalizer on int32 values (splat_pallas._fmix32)."""
    return _out(wrap_i32(_fmix32_u(_i64(x) & MASK32)))


def batch_seed(seed, global_batch):
    """int32 seed of one batch: seed * 1000003 + global batch index."""
    return _out(wrap_i32(wrap_i32(_i64(seed)) * SEED_STRIDE
                         + wrap_i32(_i64(global_batch))))


def device_seed(seed, ax):
    """A batch seed decorrelated per device ax by a full fmix32 avalanche
    (photon_pallas_wide.device_seed)."""
    s = wrap_i32(_i64(seed)) + wrap_i32(wrap_i32(_i64(ax)) + 1) * C1
    return fmix32(wrap_i32(s))


def _unit(h):
    """Top 24 bits of an unsigned hash as a float32 in [0, 1), exactly."""
    return (h >> 8).to(torch.float32) * TWO_POW_M24


def draw(p: torch.Tensor, seed: int, c: int) -> torch.Tensor:
    """Uniform draw column `c` of photons `p` (int tensor of in-batch photon
    indices) under batch seed `seed`: fmix32(p * 0x9E3779B9 + (seed +
    c * 97929)) >>> 8, times 2^-24 (photon_pallas_wide.py:188-197)."""
    off = wrap_i32(wrap_i32(int(seed)) + wrap_i32(int(c) * DRAW_STRIDE))
    x = wrap_i32(wrap_i32(_i64(p) * GOLDEN) + off)
    return _unit(_fmix32_u(x & MASK32))


def dither_key(p: torch.Tensor, depth: int, d, ch) -> torch.Tensor:
    """Key of photon p's deposit at bounce d, channel ch: p*3D + 3d + ch
    in int32 wrap arithmetic (photon_pallas_wide.py:524). d and ch may be
    ints or tensors that broadcast against p."""
    return _out(wrap_i32(_i64(p) * (3 * depth) + (3 * d + ch)))


def dither(key: torch.Tensor) -> torch.Tensor:
    """Dither in [0, 1) of a deposit key: fmix32(key * 0x9E3779B9) >>> 8,
    times 2^-24 (photon_pallas_wide.py:526-536)."""
    x = wrap_i32(_i64(key) * GOLDEN)
    return _unit(_fmix32_u(x & MASK32))
