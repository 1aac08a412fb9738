"""The port's counter-hash RNG against the JAX package's, bit for bit.

flatmatch_tpu_torch/ops/rng.py re-implements fmix32, batch_seed,
device_seed, the in-kernel [0, 1) draw and the dither of the i8 splat in
int64 torch arithmetic (torch has no logical right shift on int32). Every
value here must equal the JAX value exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flatmatch_tpu.engines import photon_pallas_wide as jwide
from flatmatch_tpu.ops.splat_pallas import _fmix32
from flatmatch_tpu_torch.ops import rng

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
EDGES = np.array([0, 1, -1, 2, -2, I32_MIN, I32_MAX, I32_MIN + 1,
                  I32_MAX - 1, 0x7FFF, -0x8000, 97929, -1640531527],
                 np.int32)


def _values():
    rs = np.random.default_rng(1234)
    rand = rs.integers(I32_MIN, I32_MAX, size=100_000, endpoint=True,
                       dtype=np.int64).astype(np.int32)
    return np.concatenate([EDGES, rand])


def _jax_draw(p, seed, c):
    """photon_pallas_wide.py:188-197, with p in place of rgid."""
    x = _fmix32(jnp.asarray(p, jnp.int32) * jnp.int32(-1640531527)
                + (jnp.int32(seed) + jnp.int32(c) * jnp.int32(97929)))
    return np.asarray(jax.lax.shift_right_logical(x, 8).astype(jnp.float32)
                      * jnp.float32(1.0 / (1 << 24)))


def _jax_dither(key):
    """photon_pallas_wide.py:526-536."""
    x = _fmix32(jnp.asarray(key, jnp.int32) * jnp.int32(-1640531527))
    return np.asarray(jax.lax.shift_right_logical(x, 8).astype(jnp.float32)
                      * jnp.float32(1.0 / (1 << 24)))


@pytest.mark.parametrize("what", ["fmix32", "batch_seed", "device_seed"])
def test_hashes_bit_exact(what):
    v = _values()
    t = torch.from_numpy(v)
    if what == "fmix32":
        want = np.asarray(_fmix32(jnp.asarray(v)))
        got = rng.fmix32(t).numpy()
    elif what == "batch_seed":
        # run seed x batch index, both over the edge/random values
        b = np.roll(v, 7)
        want = np.asarray(jwide.batch_seed(jnp.asarray(v), jnp.asarray(b)))
        got = rng.batch_seed(t, torch.from_numpy(b)).numpy()
    else:
        ax = (np.abs(v.astype(np.int64)) % 64).astype(np.int32)
        want = np.asarray(jwide.device_seed(jnp.asarray(v), jnp.asarray(ax)))
        got = rng.device_seed(t, torch.from_numpy(ax)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # Python ints take the same path as tensors
    for x in EDGES[:7]:
        if what == "fmix32":
            assert rng.fmix32(int(x)) == int(np.asarray(_fmix32(jnp.int32(x))))
        elif what == "batch_seed":
            assert rng.batch_seed(int(x), 5) == int(
                np.asarray(jwide.batch_seed(int(x), 5)))


def test_draws_and_dither_bit_exact():
    v = _values()
    p = np.arange(100_000, dtype=np.int32)
    pt = torch.from_numpy(p)
    # the per-batch seeds a render uses, plus the edge seeds
    seeds = [int(rng.batch_seed(0, 0)), int(rng.batch_seed(3, 471)),
             *map(int, EDGES[:7])]
    for seed in seeds:
        for c in (0, 3, 4, 27):
            got = rng.draw(pt, seed, c).numpy()
            want = _jax_draw(p, seed, c)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
            assert got.min() >= 0.0 and got.max() < 1.0
    # dither over raw int32 keys (including wrapped ones) ...
    np.testing.assert_array_equal(
        rng.dither(torch.from_numpy(v)).numpy(), _jax_dither(v))
    # ... and over the kernel's keys p*3D + 3d + ch
    D = 8
    for d in (0, 7):
        for ch in range(3):
            key = rng.dither_key(pt, D, d, ch)
            want_key = np.asarray(jnp.asarray(p) * jnp.int32(3 * D)
                                  + jnp.int32(3 * d) + jnp.int32(ch))
            np.testing.assert_array_equal(key.numpy(), want_key)
            np.testing.assert_array_equal(rng.dither(key).numpy(),
                                          _jax_dither(want_key))
