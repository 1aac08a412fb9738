"""jax.random's threefry2x32 draws, bit for bit, in PyTorch.

The radiosity form-factor pass samples its rays with
`jax.random.uniform(fold_in(fold_in(PRNGKey(seed), wall), chunk), shape)`
(flatmatch_tpu/engines/radiosity.py:89, :206), and the photon engines
without the device RNG draw each batch's uniforms with
`uniform(fold_in(PRNGKey(seed), batch), (B, U))` (`batch_uniforms`). This
module reproduces those draws exactly, so the port fires the same rays and
photons as the JAX package:

- `prng_key(seed)`: the raw key [seed >> 32, seed & 0xffffffff]
  (jax/_src/prng.py threefry_seed);
- `fold_in(key, data)`: threefry2x32(key, threefry_seed(data))
  (prng.py threefry_fold_in);
- `uniform(key, shape)`: the partitionable random bits (the default of
  `jax_threefry_partitionable`): element i of the flat draw is
  bits1 ^ bits2 of threefry2x32(key, (i >> 32, i & 0xffffffff)), and its
  float is (bits >> 9) * 2^-23, which is jax.random.uniform's
  `bitcast(bits >> 9 | 0x3f800000) - 1.0` without rounding.

Element i of a draw depends only on the key and i, not on the shape, so the
first rows of a draw equal the draw of those rows alone.

`uniform` on a CUDA device launches `csrc/threefry.cu` (uint32 arithmetic,
one thread per element; a failed build or launch raises); on the CPU it
runs `uniform_plain`, the same function in int64 torch ops. Keys are pairs
of Python ints (`prng_key` and `fold_in` are scalar work on the host); in
the plain version the bits are int64 tensors holding uint32 values, so every
sum is taken mod 2^32 with `& MASK32` and `>>` is logical. A [B, U] draw can
also be written transposed, as [U, B]: the layout the uniforms-in trace
kernels read.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..utils.cuda_build import launch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_MANTISSA_ULP = 2.0 ** -23

Key = Tuple[int, int]


def _rotl(x, r: int):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(key: Key, x0, x1):
    """The Threefry-2x32 block cipher, 20 rounds (prng.py
    _threefry2x32_lowering), on Python ints or int64 tensors of uint32
    values. Returns the two output words."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def prng_key(seed: int) -> Key:
    """jax.random.PRNGKey(seed) for an int32 seed (64-bit values are off in
    the JAX package, so the high word is 0)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} is outside the int32 range")
    return 0, seed & MASK32


def fold_in(key: Key, data: int) -> Key:
    """jax.random.fold_in(key, data) for a data value taken as uint32."""
    return threefry2x32(key, 0, int(data) & MASK32)


def uniform_plain(key: Key, shape, device="cpu") -> torch.Tensor:
    """Plain version of `uniform`: jax.random.uniform(key, shape, float32)
    in [0, 1), in int64 torch ops on `device`."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key, idx >> 32, idx & MASK32)
    bits = b0 ^ b1
    return ((bits >> 9).to(torch.float32) * _MANTISSA_ULP).reshape(shape)


def uniform(key: Key, shape, device="cpu",
            transposed: bool = False) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32) in [0, 1), on `device`; with
    `transposed` a 2-D shape (B, U) comes back as its contiguous [U, B]
    transpose.

    A CUDA device launches `csrc/threefry.cu` (bit-equal to the plain
    version); a failed build or launch raises. The CPU runs
    `uniform_plain`."""
    shape = tuple(int(x) for x in shape)
    if transposed and len(shape) != 2:
        raise ValueError(f"a transposed draw must be 2-D, got {shape}")
    dev = torch.device(device)
    if dev.type == "cpu":
        u = uniform_plain(key, shape, dev)
        return u.t().contiguous() if transposed else u
    if dev.type != "cuda":
        raise ValueError(f"uniform runs on the CPU or a CUDA device, not "
                         f"{dev}")
    n = math.prod(shape)
    if transposed and n >= 2**31:
        raise ValueError(f"{shape}: a transposed draw must hold < 2^31 "
                         f"elements")
    out = torch.empty(shape[::-1] if transposed else shape,
                      dtype=torch.float32, device=dev)
    if n == 0:
        return out
    k0, k1 = (int(k) & MASK32 for k in key)
    if transposed:
        launch("fm_threefry_uniform_t", dev, k0, k1, shape[0], shape[1],
               out.data_ptr())
    else:
        launch("fm_threefry_uniform", dev, k0, k1, n, out.data_ptr())
    uniform.launches += 1
    return out


uniform.launches = 0


def batch_uniforms(seed: int, batch_index: int, batch_size: int, U: int,
                   device="cpu", transposed: bool = False) -> torch.Tensor:
    """The [batch_size, U] uniforms of photon batch `batch_index` (the
    global batch index) of a run with `seed`:
    uniform(fold_in(prng_key(seed), batch_index), (batch_size, U)), the
    keying of the JAX photon engines (engines/photon.py:183-184,
    engines/photon_pallas_wide.py:1692-1693). Row p depends only on the key
    and p, so a batch cut to its first rows draws those rows unchanged.
    With `transposed`, the [U, batch_size] transpose (what the uniforms-in
    kernels read)."""
    key = fold_in(prng_key(seed), batch_index)
    return uniform(key, (int(batch_size), int(U)), device, transposed)
