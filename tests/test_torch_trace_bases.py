"""The bases the axis-aligned trace kernels build once per block, bit for bit.

The wide trace kernels (csrc/trace_wide.cuh, `stage_scene`) do not call
build_base at every diffuse bounce and emission: each block builds, once,
the bases of the six axis normals +-e_a and of its emitter's normal, and the
trace reads them. A hit normal is (SN on its axis, +0 elsewhere), SN the
winning rect's table sign, which normalization leaves 1 ulp off +-1 on some
rects; the block checks that build_base at every rect's normal equals its
class's basis and otherwise builds the basis at each bounce.
`photon_wide.trace_bases` is the plain model of that staging. These tests
hold it, bit for bit with signed zeros, to the plain trace's own per-photon
`ops/sampling.base_cols` at every hit normal of the tables of tiny, mini and
mini tiled 4x4 and at every f32 normal component that normalization can
give, to the emitter normals of tiny and mini, and, for the six axis normals
and the emitters, to the JAX package's `_build_base_cols`
(engines/photon_pallas.py) and `sampling.build_base`.
"""
import importlib.util

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flatmatch_tpu.engines import photon_pallas as jpp
from flatmatch_tpu.ops import sampling as jsampling
from flatmatch_tpu_torch.config import DEFAULT_CONFIG
from flatmatch_tpu_torch.engines import photon_wide as pw
from flatmatch_tpu_torch.ops.aa_scene import A_SN, pack_aa
from flatmatch_tpu_torch.ops.device_scene import pack_emitters
from flatmatch_tpu_torch.ops.sampling import base_cols
from flatmatch_tpu_torch.render import compile_scene
from tests.conftest import FIXTURES

f32 = np.float32


def _bits(x):
    return np.asarray(x, f32).view(np.uint32)


def _scene(name, tmp_path_factory):
    png = FIXTURES / f"{name}.png"
    if name == "mini_4x4":
        spec = importlib.util.spec_from_file_location(
            "make_layout", FIXTURES / "make_layout.py")
        make_layout = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(make_layout)
        png = tmp_path_factory.mktemp("tiled") / "mini_4x4.png"
        make_layout.tiled(str(FIXTURES / "mini.png"), str(png), 4, 4)
    scene, _ = compile_scene(str(png), 30.0, DEFAULT_CONFIG)
    ph = DEFAULT_CONFIG.photon
    em = pack_emitters(scene, ph.samples_per_area, ph.window_color,
                       ph.light_color)
    return pack_aa(scene.walls), em


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    return {name: _scene(name, tmp_path_factory)
            for name in ("tiny", "mini", "mini_4x4")}


def _table(sn, axes):
    """A [13, N] table with normal signs `sn` in the groups `axes` (the
    model reads only SN and the group counts)."""
    fields = torch.zeros((13, len(sn)), dtype=torch.float32)
    fields[A_SN] = torch.from_numpy(np.asarray(sn, f32))
    return fields, tuple(int((np.asarray(axes) == a).sum()) for a in range(3))


@pytest.mark.parametrize("k", range(6))
def test_axis_bases_are_build_base_of_the_axis_normals(k):
    """Row 2a + (sign < 0) of the model is build_base of the normal with
    `sign` on axis a and +0 elsewhere, in the port's base_cols and in the
    JAX package's two build_base functions, signed zeros included."""
    a, sign = k // 2, (-1.0 if k % 2 else 1.0)
    n = np.zeros(3, f32)
    n[a] = sign
    axis_bases, _, _ = pw.trace_bases(*_table([1.0], [0]),
                                      torch.zeros(16))
    got = _bits(axis_bases[k])
    u, v = base_cols(*(torch.tensor([c]) for c in n))
    np.testing.assert_array_equal(got, _bits(torch.stack(u + v, -1)[0]))
    ju, jv = jpp._build_base_cols(*(jnp.asarray([c]) for c in n))
    np.testing.assert_array_equal(got, _bits(np.concatenate(
        [np.asarray(c) for c in ju + jv])))
    su, sv = jsampling.build_base(jnp.asarray(n))
    np.testing.assert_array_equal(got, _bits(np.concatenate([su, sv])))
    # u is -e_z or -e_y, v completes the frame: no component is a stray
    # non-zero
    assert set(np.abs(np.asarray(axis_bases[k])).tolist()) == {0.0, 1.0}


@pytest.mark.parametrize("name", ["tiny", "mini", "mini_4x4"])
def test_axis_bases_stand_for_every_table_normal(scenes, name):
    """At every rect of the table, base_cols of its hit normal, formed as
    the plain trace forms it (torch.where(axis == a, SN, +0)), equals its
    class's row of the model bit for bit, 1-ulp-off signs included; so
    the kernels read the table (the model's check holds)."""
    aa, _ = scenes[name]
    f, gc = aa.fields, aa.group_counts
    axis_bases, _, exact = pw.trace_bases(f, gc, torch.zeros(16))
    assert exact
    sn = f[A_SN]
    assert set(np.abs(sn.numpy()).tolist()) == {1.0, f32(1 - 2**-24)}
    axis = torch.repeat_interleave(torch.arange(3), torch.tensor(gc))
    zero = torch.zeros_like(sn)
    u, v = base_cols(*(torch.where(axis == a, sn, zero) for a in range(3)))
    want = torch.stack(u + v, -1)
    got = axis_bases[2 * axis + (sn < 0).long()]
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("name", ["tiny", "mini"])
def test_emitter_basis_is_build_base_of_the_emitter_normal(scenes, name):
    """The emitter's basis, built once per block, equals base_cols of the
    per-photon normal the plain trace builds it from (em[9:12] times ones),
    and the JAX package's _build_base_cols, for every emitter; the
    emitters' -0 components make it differ from the axis rows in sign."""
    aa, em = scenes[name]
    ones = torch.ones(4)
    for e in range(em.counts.shape[0]):
        ev = pw.emitter_vector(em, e)
        _, eb, _ = pw.trace_bases(aa.fields, aa.group_counts, ev)
        u, v = base_cols(*(ev[9 + a] * ones for a in range(3)))
        per_photon = torch.stack(u + v, -1)
        for row in per_photon:
            np.testing.assert_array_equal(_bits(eb), _bits(row))
        ju, jv = jpp._build_base_cols(*(jnp.asarray([ev[9 + a].item()])
                                        for a in range(3)))
        np.testing.assert_array_equal(_bits(eb), _bits(np.concatenate(
            [np.asarray(c) for c in ju + jv])))


def test_axis_bases_hold_over_the_normalization_range():
    """pack_aa takes a rect whose normal has |n[a]| >= 0.999999 and zeros
    elsewhere. For every f32 |SN| from 0.999999 up to 1.0006 (a normalized
    vector is a few ulp from 1), on each axis and sign, build_base gives
    the class's basis bit for bit: the model's check holds."""
    lo, hi = f32(0.999999), f32(1.0006)
    mags = np.arange(lo.view(np.int32), hi.view(np.int32),
                     dtype=np.int32).view(f32)
    sn = np.concatenate([mags, -mags] * 3)
    axes = np.repeat(np.arange(3), 2 * len(mags))
    assert pw.trace_bases(*_table(sn, axes), torch.zeros(16))[2]


@pytest.mark.parametrize("sn", [f32(1.0006226), f32(-1.000712)])
def test_a_normal_off_the_range_turns_the_axis_bases_off(sn):
    """A sign whose build_base differs from its class's (far off unit
    length) fails the check: the kernels then build every basis at the
    bounce, as the plain trace does, and stay bit for bit with it."""
    fields, gc = _table([1.0, sn, -1.0], [0, 1, 2])
    assert not pw.trace_bases(fields, gc, torch.zeros(16))[2]
