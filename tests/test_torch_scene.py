"""The port's host modules against the JAX package's, byte for byte.

flatmatch_tpu_torch carries its own copies of the numpy-only scene compiler
(importing any flatmatch_tpu module imports jax), so these tests hold the
copies to the JAX package's outputs and to the reference goldens: scene
artifacts byte-identical, packed tables bit-identical.
"""
import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from flatmatch_tpu.engines import photon_pallas, photon_pallas_wide as jw
from flatmatch_tpu.engines.schedule import emitter_slice
from flatmatch_tpu.ops import aa_scene as jax_aa, device_scene as jax_ds
from flatmatch_tpu.scene import (
    collision as j_col, geometry as j_geo, image as j_im, layout as j_lay,
)
from flatmatch_tpu_torch import interop
from flatmatch_tpu_torch.engines import photon_wide as pw
from flatmatch_tpu_torch.ops import aa_scene as p_aa, device_scene as p_ds
from flatmatch_tpu_torch.scene import (
    collision as p_col, geometry as p_geo, image as p_im, layout as p_lay,
)
from tests.conftest import FIXTURES

f32 = np.float32
NAMES = ["tiny", "mini"]
SPA = 3000.0
WIN, LIGHT = (18.0, 18.0, 18.0), (16.0, 16.0, 18.0)


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name in NAMES:
        png = str(FIXTURES / f"{name}.png")
        j_img, p_img = j_im.load_layout(png), p_im.load_layout(png)
        np.testing.assert_array_equal(j_img, p_img)
        j_scene = j_geo.Scene(j_lay.parse_layout(j_img, f32(1) / f32(30),
                                                 200.0))
        p_scene = p_geo.Scene(p_lay.parse_layout(p_img, f32(1) / f32(30),
                                                 200.0))
        out[name] = (j_img, p_img, j_scene, p_scene)
    return out


def _rect_equal(a, b):
    return all(
        np.array_equal(np.asarray(getattr(a, f.name)),
                       np.asarray(getattr(b, f.name)))
        for f in dataclasses.fields(a)
    )


@pytest.mark.parametrize("name", NAMES)
def test_scene_artifacts_byte_identical(scenes, name):
    j_img, p_img, j_scene, p_scene = scenes[name]
    for group in ("walls", "windows", "lights", "box"):
        ja, pa = getattr(j_scene, group), getattr(p_scene, group)
        assert len(ja) == len(pa)
        assert all(_rect_equal(a, b) for a, b in zip(ja, pa)), group
    assert j_scene.num_texels == p_scene.num_texels
    geo = p_geo.geometry_json(p_scene)
    assert geo == j_geo.geometry_json(j_scene)
    assert geo == (FIXTURES / f"{name}_geometry.json").read_text()
    col = p_col.build_collision_map(p_img)
    assert col == j_col.build_collision_map(j_img)
    assert col == (FIXTURES / f"{name}_collisionMap.json").read_text()


@pytest.mark.parametrize("name", NAMES)
def test_packed_tables_bit_identical(scenes, name):
    _, _, j_scene, p_scene = scenes[name]
    j_aa = jax_aa.pack_aa(j_scene.walls)
    p_tab = p_aa.pack_aa(p_scene.walls)
    assert p_tab.fields.dtype == torch.float32
    np.testing.assert_array_equal(p_tab.fields.numpy(), np.asarray(j_aa.fields))
    assert p_tab.group_counts == j_aa.group_counts
    np.testing.assert_array_equal(p_tab.perm, j_aa.perm)

    j_em = jax_ds.pack_emitters(j_scene, SPA, WIN, LIGHT)
    p_em = p_ds.pack_emitters(p_scene, SPA, WIN, LIGHT)
    for field in j_em._fields:
        want, got = np.asarray(getattr(j_em, field)), getattr(p_em, field)
        got = got if isinstance(got, np.ndarray) else got.numpy()
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    for i in range(len(p_em.counts)):
        np.testing.assert_array_equal(
            pw.emitter_vector(p_em, i).numpy(),
            np.asarray(photon_pallas.emitter_vector(
                emitter_slice(j_em, i))).reshape(16),
        )
    np.testing.assert_array_equal(
        p_ds.exposure_scale(p_scene, SPA, 0.35),
        jax_ds.exposure_scale(j_scene, SPA, 0.35),
    )

    # the interop path builds the same tensors from the JAX tables
    via = interop.from_jax_aa(np.asarray(j_aa.fields), j_aa.group_counts,
                              j_aa.perm)
    assert torch.equal(via.fields, p_tab.fields)
    via_em = interop.from_jax_emitters(*j_em)
    for field in ("pos", "color", "is_window"):
        assert torch.equal(getattr(via_em, field), getattr(p_em, field))


@pytest.mark.parametrize("name", NAMES)
def test_compact_aa_bit_identical(scenes, name):
    _, _, j_scene, p_scene = scenes[name]
    T = j_scene.num_texels
    j_c, j_total, j_expand = jw.compact_aa(jax_aa.pack_aa(j_scene.walls), T)
    p_c, p_total, p_expand = pw.compact_aa(p_aa.pack_aa(p_scene.walls), T)
    assert p_total == j_total
    np.testing.assert_array_equal(p_c.fields.numpy(), np.asarray(j_c.fields))
    lm = np.random.default_rng(5).random((j_total, 3), np.float32)
    np.testing.assert_array_equal(
        p_expand(torch.from_numpy(lm)).numpy(), np.asarray(j_expand(lm))
    )


def test_port_imports_without_jax():
    """Every module of the port imports in a fresh interpreter without
    pulling in jax."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import flatmatch_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'flatmatch_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not any(m.startswith('flatmatch_tpu.') for m in sys.modules)\n"
        "print(len(names))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(FIXTURES.parent.parent),
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20
