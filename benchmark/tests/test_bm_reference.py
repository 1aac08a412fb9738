"""The plain reference against data made by neither side (the upstream C
engine's dumps and geometry.json in tests/fixtures), and its arithmetic
against the program's where the two must agree exactly."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import compare, layout as L, photon, radiosity

from .conftest import ROOT

FIX = ROOT / "tests" / "fixtures"
LAY = L.parse_rects(ROOT / "benchmark" / "layouts" / "example_rects.txt")


def _gold(name):
    return np.fromfile(FIX / name, "<f4").reshape(-1, 4)[:, :3].astype(
        np.float64)


def test_layout_counts():
    g = LAY.groups
    assert [len(g[k]) for k in L.GROUPS] == [172, 7, 3, 147]
    assert LAY.num_texels == 113964
    assert int(L.level0_mask(LAY).sum()) == 85056


def test_geometry_json_is_upstream_bytes():
    assert L.geometry_json(LAY).encode() == (
        FIX / "example_geometry.json").read_bytes()


def test_photon_reference_matches_upstream_engine():
    """1M photons against the upstream engine's spa-300k dump (4.6M
    photons): energy within 0.5%, texel correlation above 0.98."""
    gen = torch.Generator()
    gen.manual_seed(4)
    r = photon.trace(LAY, 300000.0, 8, 1000000, gen, "cpu")
    gold = _gold("example_photon_native_spa300k.f32")
    l0 = L.level0_mask(LAY)
    assert abs(r["raw"].sum() / gold.sum() - 1) < 5e-3
    assert np.corrcoef(r["raw"][l0].ravel(), gold[l0].ravel())[0, 1] > 0.98
    assert 5.3 < r["bounces"] / r["sent"] < 5.7


def test_radiosity_reference_matches_upstream_engine():
    """100 rays a texel against the upstream engine's 2,000-ray dump:
    energy within 1%, correlation above 0.97."""
    gen = torch.Generator()
    gen.manual_seed(4)
    arena, rects = radiosity.estimate(LAY, dict(iterations=7), 100, gen,
                                      "cpu")
    gold = _gold("example_radiosity_rays2000.f32")
    l0 = L.level0_mask(LAY)
    assert rects == 182
    assert abs(arena[l0].sum() / gold[l0].sum() - 1) < 1e-2
    assert np.corrcoef(arena[l0].ravel(), gold[l0].ravel())[0, 1] > 0.97


def _port_scene():
    from benchmark import loop

    return loop.build_scene(LAY)


def test_budgets_and_exposure_equal_the_programs():
    from flatmatch_tpu_torch.ops.device_scene import (exposure_scale,
                                                      pack_emitters)

    scene = _port_scene()
    em = pack_emitters(scene, 1e8, (18, 18, 18), (16, 16, 18))
    assert (L.photon_counts(LAY, 1e8) == em.counts).all()
    assert photon.program_samples(LAY, dict(samples_per_area=1e8)) == \
        1538352527
    np.testing.assert_allclose(L.exposure_scale(LAY, 1e8, 0.35),
                               exposure_scale(scene, 1e8, 0.35), rtol=1e-6)


def test_tile_centers_equal_the_programs():
    """To float32 rounding: the reference scales the sides in its own
    order."""
    from flatmatch_tpu_torch.engines.ao import tile_centers

    for w, r in zip(LAY.walls[::17], _port_scene().walls[::17]):
        np.testing.assert_allclose(L.tile_centers(w), tile_centers(r),
                                   rtol=1e-6)


@pytest.mark.parametrize("extra", [False, True])
def test_tone_map_equals_the_programs_tiles(extra):
    from flatmatch_tpu_torch.io.tiles import tile_rgb

    rng = np.random.default_rng(3)
    texels = (rng.exponential(0.4, (LAY.num_texels, 3))
              * (rng.random((LAY.num_texels, 1)) > 0.05)).astype(np.float32)
    for w, r in zip(LAY.walls, _port_scene().walls):
        np.testing.assert_array_equal(compare.tile(w, texels, extra),
                                      tile_rgb(r, texels, extra))


def test_mipmap_equals_the_programs():
    from flatmatch_tpu_torch.ops.mipmap import apply_plan, build_plan

    scene = _port_scene()
    rng = np.random.default_rng(5)
    base = rng.random((LAY.num_texels, 3)).astype(np.float32)
    full = apply_plan(torch.from_numpy(base), build_plan(scene.walls))
    arena = full.numpy()
    assert compare.outside_gap(LAY, arena, True) < 1e-6
    assert compare.outside_gap(LAY, base, True) > 0.1
