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

Keys are pairs of Python ints; the bits are int64 tensors holding uint32
values, so every sum is taken mod 2^32 with `& MASK32` and `>>` is logical.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

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


def uniform(key: Key, shape, device="cpu") -> torch.Tensor:
    """jax.random.uniform(key, shape, float32) in [0, 1), on `device`."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key, idx >> 32, idx & MASK32)
    bits = b0 ^ b1
    return ((bits >> 9).to(torch.float32) * _MANTISSA_ULP).reshape(shape)


def batch_uniforms(seed: int, batch_index: int, batch_size: int, U: int,
                   device="cpu") -> torch.Tensor:
    """The [batch_size, U] uniforms of photon batch `batch_index` (the
    global batch index) of a run with `seed`:
    uniform(fold_in(prng_key(seed), batch_index), (batch_size, U)), the
    keying of the JAX photon engines (engines/photon.py:183-184,
    engines/photon_pallas_wide.py:1692-1693). Row p depends only on the key
    and p, so a batch cut to its first rows draws those rows unchanged."""
    key = fold_in(prng_key(seed), batch_index)
    return uniform(key, (int(batch_size), int(U)), device)
