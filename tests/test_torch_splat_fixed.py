"""The exact function of the port's f32 stream splat (row 16) and of its
threefry conversion, on the CPU.

`ops/splat.fused_splat_fixed_plain` is what csrc/splat_stream.cu computes
bit for bit (tests/test_torch_cuda.py holds the kernel to it on the card):
each color, rounded to bf16 or not, becomes round(c * 2^k) in int64; the
integers are summed per texel; each sum is converted to f32 once and scaled
by 2^-k. These tests, on seeded numpy streams, show what that buys and what
the kernel may rely on: the result is the exact sum rounded once wherever
every color exceeds 2^-14; it stays within the band the port has always
held the splat to against `index_add_`'s f32 order; and int64 partial sums
over any split of the stream add up to the same integers, through
wraparound too, which is why the kernel may sum rows in shared memory per
block and add the blocks' sums in any order. The adding entry's plain path
is `lm += fused_splat(...)`. The threefry kernel makes its floats as
bitcast(m | 0x3f800000) - 1; the identity with m * 2^-23 is checked for
every m, and `uniform_plain` against draws of jax.random.uniform stored
here.
"""
import math
from fractions import Fraction

import numpy as np
import pytest
import torch

from flatmatch_tpu_torch.ops import splat as sp, threefry


def _stream(seed, rows, texels, lo=2.0 ** -14, hi=18.0, out_of_range=0,
            zero_rows=0):
    """A seeded stream: ids in [0, texels) (some out of range when asked),
    colors log-uniform in [lo, hi), some rows zero when asked."""
    rs = np.random.RandomState(seed)
    idx = rs.randint(0, texels, rows).astype(np.int32)
    col = np.exp(rs.uniform(np.log(lo), np.log(hi), (rows, 3))).astype(
        np.float32)
    if out_of_range:
        pick = rs.choice(rows, out_of_range, replace=False)
        idx[pick] = rs.choice([-1, -7, texels, texels + 5, 2**31 - 1],
                              out_of_range)
    if zero_rows:
        col[rs.choice(rows, zero_rows, replace=False)] = 0.0
    return torch.from_numpy(idx), torch.from_numpy(col)


def _int_to_f32(n: int) -> np.float32:
    """A Python integer rounded once to float32 (to nearest, ties to
    even), without passing through float64."""
    if n == 0:
        return np.float32(0.0)
    sign, m = (-1, -n) if n < 0 else (1, n)
    shift = max(m.bit_length() - 24, 0)
    q, r = divmod(m, 1 << shift)
    half = (1 << shift) >> 1
    if shift and (r > half or (r == half and q & 1)):
        q += 1
    return np.float32(sign * math.ldexp(q, shift))


@pytest.mark.parametrize("bf16", [True, False])
def test_twin_is_the_exact_sum_rounded_once(bf16):
    """Where every color exceeds 2^-14 (the stream bound's scale 2^37
    makes each of them an integer), the twin is the exact sum of the
    (bf16-rounded) colors, rounded once to f32."""
    rows, T = 20_000, 300
    idx, col = _stream(1, rows, T)
    bound = 131072 * 8 * 18.0
    to_fixed, from_fixed = sp.fixed_point_scale(bound)
    assert to_fixed == 2.0 ** 37
    got = sp.fused_splat_fixed_plain(idx, col, T, bound, bf16).numpy()
    c = col.to(torch.bfloat16).to(torch.float32) if bf16 else col
    exact = [[Fraction(0)] * 3 for _ in range(T)]
    for t, row in zip(idx.tolist(), c.tolist()):
        for ch in range(3):
            exact[t][ch] += Fraction(row[ch])
    want = np.array([[_int_to_f32(int(x * 2**37)) for x in e]
                     for e in exact], dtype=np.float32) * np.float32(
                         from_fixed)
    assert all(x * 2**37 == int(x * 2**37) for e in exact for x in e)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bf16", [True, False])
def test_twin_within_the_band_of_index_add(bf16):
    """The twin against the plain versions the CPU runs (`index_add_` in
    f32): within rtol 1e-5, the band the splat has always been held to,
    with ids out of range dropped by both and colors down to 1e-7."""
    idx, col = _stream(2, 50_000, 700, lo=1e-7, out_of_range=200,
                       zero_rows=300)
    bound = 131072 * 8 * 18.0
    plain = sp.fused_splat_plain if bf16 else sp.scatter_plain
    want = plain(idx, col, 700)
    got = sp.fused_splat_fixed_plain(idx, col, 700, bound, bf16)
    assert want.sum().item() > 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("chunks", [2, 7, 64])
@pytest.mark.parametrize("wrap", [False, True])
def test_partial_sums_of_any_split_add_to_the_same_integers(chunks, wrap):
    """Int64 sums of row chunks, added, equal the sum of the whole stream:
    the grouping the kernel's blocks make. With `wrap` the scale is so
    large that the sums pass 2^63 and wrap; they still agree."""
    idx, col = _stream(3, 30_000, 64, lo=1e-3, out_of_range=50,
                       zero_rows=100)
    to_fixed = 2.0 ** 58 if wrap else 2.0 ** 37
    whole = sp.fixed_point_sums(idx, col, 64, to_fixed)
    bounds = np.linspace(0, idx.shape[0], chunks + 1).astype(int)
    parts = torch.zeros_like(whole)
    for a, b in zip(bounds[:-1], bounds[1:]):
        parts += sp.fixed_point_sums(idx[a:b], col[a:b], 64, to_fixed)
    assert torch.equal(parts, whole)
    exact = [[0] * 3 for _ in range(64)]
    c = col.to(torch.bfloat16).to(torch.float32)
    for t, row in zip(idx.tolist(), c.tolist()):
        if 0 <= t < 64:
            for ch in range(3):
                exact[t][ch] += int(row[ch] * to_fixed)
    big = max(abs(x) for e in exact for x in e)
    assert (big >= 2**63) == wrap
    wrapped = [[(x + 2**63) % 2**64 - 2**63 for x in e] for e in exact]
    assert whole.tolist() == wrapped


@pytest.mark.parametrize("bf16", [True, False])
def test_adding_entry_plain_path_is_lm_plus_increment(bf16):
    """fused_splat_add on CPU tensors adds the plain version's increment
    into the lightmap in place, bit for bit lm += fused_splat_plain(...),
    with dropped ids and zero rows, and refuses a lightmap it cannot
    take."""
    idx, col = _stream(4, 10_000, 200, out_of_range=40, zero_rows=500)
    lm0 = torch.from_numpy(np.random.RandomState(5).rand(200, 3).astype(
        np.float32))
    lm = lm0.clone()
    before = sp.fused_splat.launches
    got = sp.fused_splat_add(lm, idx, col, 1e6, bf16)
    assert got is lm and sp.fused_splat.launches == before
    plain = sp.fused_splat_plain if bf16 else sp.scatter_plain
    want = lm0.clone()
    want += plain(idx, col, 200)
    assert torch.equal(lm, want)
    for bad in (torch.zeros((200, 3), dtype=torch.float64),
                torch.zeros((3, 200)).t(), torch.zeros((200, 4))):
        with pytest.raises(ValueError):
            sp.fused_splat_add(bad, idx, col, 1e6, bf16)
    with pytest.raises(ValueError):
        sp.fused_splat_add(lm, idx, col, 0.0, bf16)


def test_fixed_point_rounds_to_nearest_even():
    """A color whose product with 2^k is not an integer rounds to the
    nearest integer, ties to even, as the kernel's __float2ll_rn does; the
    bf16 rounding comes first."""
    k = 2.0 ** 37
    unit = 2.0 ** -37
    col = torch.tensor([[0.5 * unit, 1.5 * unit, 2.5 * unit],
                        [-1.5 * unit, 1.25 * unit, 1.75 * unit],
                        [1e-7, -1e-7, 3.0]], dtype=torch.float32)
    idx = torch.tensor([0, 1, 2], dtype=torch.int32)
    got = sp.fixed_point_sums(idx, col, 3, k, bf16=False)
    assert got.tolist() == [[0, 2, 2], [-2, 1, 2],
                            [13744, -13744, 3 * 2**37]]
    bf = sp.fixed_point_sums(idx, col, 3, k, bf16=True)
    c = col.to(torch.bfloat16).double() * k
    assert bf.tolist() == torch.round(c).long().tolist()


def test_conversion_identity_for_every_mantissa():
    """For every m in [0, 2^23): bitcast(m | 0x3f800000) - 1 equals
    m * 2^-23 bit for bit, as the threefry kernel and jax.random.uniform
    make their floats."""
    m = np.arange(1 << 23, dtype=np.uint32)
    via_bits = (m | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    scaled = m.astype(np.float32) * np.float32(2.0 ** -23)
    np.testing.assert_array_equal(via_bits.view(np.uint32),
                                  scaled.view(np.uint32))


# jax.random.uniform(key, (1000, 28), float32) at flat indices STORED_AT,
# as float32 bit patterns (jax_threefry_partitionable on)
STORED_AT = [0, 1, 2, 3, 27, 28, 1000, 27999]
STORED = {
    (0, 0): [0x3F729A4E, 0x3F7A8436, 0x3EAA221C, 0x3EEFF550, 0x3F414716,
             0x3E58B8A0, 0x3F57DDD8, 0x3E2A0140],
    (2807956043, 295189521): [0x3F2F7BCA, 0x3F2A36EC, 0x3F678DA4,
                              0x3EAF5DA0, 0x3F53DECC, 0x3EC15220,
                              0x3EC8DCA0, 0x3DC01050],
}


def test_uniform_plain_matches_stored_draws():
    """uniform_plain of PRNGKey(0) and of fold_in(PRNGKey(7), 472) at
    (1000, 28) against jax.random.uniform's stored bits."""
    keys = [threefry.prng_key(0), threefry.fold_in(threefry.prng_key(7),
                                                   472)]
    assert keys == list(STORED)
    for key in keys:
        u = threefry.uniform_plain(key, (1000, 28)).numpy().ravel()
        assert u.view(np.uint32)[STORED_AT].tolist() == STORED[key]
