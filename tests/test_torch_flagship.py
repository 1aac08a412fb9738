"""The product's scene from its rect dump, and the bands of the port's
gates on it (flatmatch_tpu_torch/tools/flagship.py).

- `scene_from_rects` of tiny_rects.txt and mini_rects.txt equals the port's
  own compile of tiny.png and mini.png: every rect field bit for bit, the
  texel total, the image size, the starting position and geometry.json
  byte for byte. On example_rects.txt the header counts hold and
  geometry.json equals the fixture byte for byte.
- The port's packed tables of the flagship (pack_rects, pack_aa,
  pack_emitters) equal the JAX package's, bit for bit, for a JAX Scene
  built from tests.conftest.parse_rects_fixture.
- One 512-photon batch of the flagship's first window through the port's
  plain version of the production kernel (trace_splat_wide_rng, 7-bit)
  equals the JAX wide kernel run in Pallas interpret mode, as its own
  tests run it, at the 7-bit tier's band of tests/test_torch_inkernel.py:
  the int32 accumulator bit for bit.
- Each gate's band on synthetic arrays, a case that passes and cases that
  fail, so no band goes unchecked; the AO gate on tiny through the plain
  versions (the path CPU tensors take) against the reference dump.
"""
import argparse
import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from flatmatch_tpu.config import PhotonConfig as JaxPhotonConfig
from flatmatch_tpu.engines import photon_pallas, photon_pallas_wide as jw
from flatmatch_tpu.engines.schedule import emitter_slice
from flatmatch_tpu.ops import aa_scene as jax_aa, device_scene as jax_ds
from flatmatch_tpu.scene import (
    geometry as j_geo, layout as j_lay, rectangle as j_rect,
)
from flatmatch_tpu_torch import cli
from flatmatch_tpu_torch.config import DEFAULT_CONFIG, PhotonConfig
from flatmatch_tpu_torch.engines import photon_wide as pw
from flatmatch_tpu_torch.ops import aa_scene as p_aa, device_scene as p_ds
from flatmatch_tpu_torch.render import compile_scene
from flatmatch_tpu_torch.scene.geometry import geometry_json
from flatmatch_tpu_torch.scene.rectangle import num_tiles
from flatmatch_tpu_torch.tools import flagship
from tests.conftest import FIXTURES, parse_rects_fixture

f32 = np.float32
GROUPS = ("walls", "windows", "lights", "box")
SPA = 3000.0
WIN, LIGHT = (18.0, 18.0, 18.0), (16.0, 16.0, 18.0)
B, N_VALID = 512, 500     # the last 12 photons are dead from the start


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: the plain versions' tensors are
    small, and the parallel test workers do not oversubscribe the cores
    they share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flag():
    return flagship.flagship_scene()


@pytest.fixture(scope="module")
def jax_flag():
    """The JAX package's Scene of the flagship, from the conftest parser."""
    header, groups = parse_rects_fixture(FIXTURES / "example_rects.txt")
    lay = j_lay.ParsedLayout(
        **{g: [j_rect.Rect(**row) for row in groups[g]] for g in GROUPS},
        width=header["width"], height=header["height"],
        starting_position=tuple(float(v) for v in header["start"]),
        num_texels=header["texels"])
    return j_geo.Scene(lay)


@pytest.mark.parametrize("name", ["tiny", "mini"])
def test_scene_from_rects_equals_png_compile(name):
    got = flagship.scene_from_rects(FIXTURES / f"{name}_rects.txt")
    want, _ = compile_scene(str(FIXTURES / f"{name}.png"), 30.0,
                            DEFAULT_CONFIG)
    for g in GROUPS:
        a, b = getattr(got, g), getattr(want, g)
        assert len(a) == len(b), g
        for i, (ra, rb) in enumerate(zip(a, b)):
            for f in dataclasses.fields(ra):
                x, y = getattr(ra, f.name), getattr(rb, f.name)
                assert type(x) is type(y), (g, i, f.name)
                assert np.asarray(x).dtype == np.asarray(y).dtype
                np.testing.assert_array_equal(x, y, err_msg=f"{g}[{i}]")
    gl, wl = got.layout, want.layout
    assert got.num_texels == want.num_texels
    assert (gl.width, gl.height) == (wl.width, wl.height)
    assert gl.starting_position == wl.starting_position
    geo = geometry_json(got)
    assert geo == geometry_json(want)
    assert geo == (FIXTURES / f"{name}_geometry.json").read_text()


def test_flagship_header_and_geometry(flag):
    lay = flag.layout
    counts = tuple(len(getattr(flag, g)) for g in GROUPS)
    assert counts == (172, 7, 3, 147)
    assert flag.num_texels == 113964
    assert (lay.width, lay.height) == (640, 440)
    assert lay.starting_position == (float(f32("10.833334")),
                                     float(f32("4.73333359")))
    # only walls get an arena base
    assert all(r.base == 0 for g in GROUPS[1:] for r in getattr(flag, g))
    assert geometry_json(flag) == (FIXTURES / "example_geometry.json"
                                   ).read_text()


def test_loader_refuses_a_header_that_disagrees(tmp_path):
    text = (FIXTURES / "tiny_rects.txt").read_text()
    bad = tmp_path / "bad_rects.txt"
    bad.write_text(text.replace("walls=13", "walls=12", 1))
    with pytest.raises(ValueError, match="walls rows"):
        flagship.scene_from_rects(bad)
    bad.write_text(text.replace("texels=2993", "texels=2994", 1))
    with pytest.raises(ValueError, match="texels"):
        flagship.scene_from_rects(bad)


def test_flagship_rects_table_equals_jax(flag, jax_flag):
    want = jax_ds.pack_rects(jax_flag.walls)
    got = p_ds.pack_rects(flag.walls)
    for field in want._fields:
        w, g = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)


def test_flagship_aa_table_equals_jax(flag, jax_flag):
    want = jax_aa.pack_aa(jax_flag.walls)
    got = p_aa.pack_aa(flag.walls)
    np.testing.assert_array_equal(got.fields.numpy(), np.asarray(want.fields))
    assert got.group_counts == want.group_counts
    assert sum(got.group_counts) == 172
    np.testing.assert_array_equal(got.perm, want.perm)
    T = flag.num_texels
    j_c, j_total, _ = jw.compact_aa(want, T)
    p_c, p_total, _ = pw.compact_aa(got, T)
    assert p_total == j_total == sum(num_tiles(r) for r in flag.walls)
    np.testing.assert_array_equal(p_c.fields.numpy(), np.asarray(j_c.fields))


@pytest.mark.parametrize("spa", [SPA, 1e8])
def test_flagship_emitters_equal_jax(flag, jax_flag, spa):
    want = jax_ds.pack_emitters(jax_flag, spa, WIN, LIGHT)
    got = p_ds.pack_emitters(flag, spa, WIN, LIGHT)
    for field in want._fields:
        w, g = np.asarray(getattr(want, field)), getattr(got, field)
        g = g if isinstance(g, np.ndarray) else g.numpy()
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    np.testing.assert_array_equal(
        p_ds.exposure_scale(flag, spa, 0.35),
        jax_ds.exposure_scale(jax_flag, spa, 0.35))


def test_flagship_batch_matches_jax(flag, jax_flag):
    kw = dict(samples_per_area=SPA, photons_per_batch=B, seed=9,
              splat="inkernel_i8", device_rng=True)
    jcfg, cfg = JaxPhotonConfig(**kw), PhotonConfig(**kw)
    aa_c, total_c, _ = jw.compact_aa(jax_aa.pack_aa(jax_flag.walls),
                                     jax_flag.num_texels)
    em = jax_ds.pack_emitters(jax_flag, SPA, WIN, LIGHT)
    ev = photon_pallas.emitter_vector(emitter_slice(em, 0))
    seed = int(jw.batch_seed(cfg.seed, 3))
    with pltpu.force_tpu_interpret_mode():
        lm = np.asarray(jw.trace_splat_wide_rng(
            aa_c.fields, ev, seed, N_VALID, jcfg, aa_c.group_counts,
            total_c, B, 4, i8=True, unroll=1))
    scale = f32(pw.splat_color_scale(cfg))
    want = np.rint(lm / scale).astype(np.int64)
    np.testing.assert_array_equal(want.astype(f32) * scale, lm)  # integral
    # the port's own tables of the loaded scene, not the JAX ones
    p_c, p_total, _ = pw.compact_aa(p_aa.pack_aa(flag.walls), flag.num_texels)
    assert p_total == total_c
    p_ev = pw.emitter_vector(p_ds.pack_emitters(flag, SPA, WIN, LIGHT), 0)
    np.testing.assert_array_equal(p_ev.numpy(), np.asarray(ev).reshape(16))
    acc = pw.trace_splat_wide_rng_i8(p_c.fields, p_c.group_counts, p_ev,
                                     seed, N_VALID, B, cfg, total_c).numpy()
    assert acc.sum() > 0
    np.testing.assert_array_equal(acc, want)


# --------------------------------------------------------------------------
# the gates' bands on synthetic arrays
# --------------------------------------------------------------------------
def _arena(scene, seed):
    """A positive level-0 arena, mipmap slots 0."""
    rng = np.random.default_rng(seed)
    a = np.zeros((scene.num_texels, 3), f32)
    l0 = scene.level0_mask()
    a[l0] = rng.uniform(0.5, 1.5, (int(l0.sum()), 3)).astype(f32)
    return a


def _noisy(gold, rel, seed=1):
    rng = np.random.default_rng(seed)
    return (gold * (1 + rel * rng.standard_normal(gold.shape))).astype(f32)


def _big_wall(scene):
    return max(range(len(scene.walls)),
               key=lambda i: num_tiles(scene.walls[i]))


def _wall(scene, arena, wi, factor):
    r = scene.walls[wi]
    out = arena.copy()
    out[r.base:r.base + num_tiles(r)] *= f32(factor)
    return out


@pytest.mark.parametrize("case", ["pass", "energy", "wall", "corr",
                                  "walls_checked"])
def test_photon_bands(flag, case):
    gold = _arena(flag, 0)
    if case == "walls_checked":
        # only the first 19 walls lit past a tenth of the texel mean
        for wi in range(19, len(flag.walls)):
            gold = _wall(flag, gold, wi, 1e-3)
    ours = _noisy(gold, 0.02)
    if case == "energy":
        ours = ours * f32(1.03)
    elif case == "wall":
        ours = _wall(flag, ours, _big_wall(flag), 1.2)
    elif case == "corr":
        ours = np.random.default_rng(3).permutation(ours)
    res = flagship.photon_bands(flag, ours, gold)
    assert res["pass"] is (case == "pass"), res
    assert res["walls_checked"] == (19 if case == "walls_checked"
                                    else len(flag.walls))
    if case == "energy":
        assert res["energy_rel_err"] > 0.02
    if case == "wall":
        assert res["energy_rel_err"] < 0.02
        assert res["worst_wall_rel_vs_tolerance"] > 1.0
    if case == "corr":
        assert res["texel_corr"] < 0.98


@pytest.mark.parametrize("case", ["pass", "energy", "lit"])
def test_i8_bands(flag, case):
    ref = _arena(flag, 0)
    out = _noisy(ref, 1e-3)
    if case == "energy":
        out = out * f32(1.01)
    elif case == "lit":
        # energy and correlation kept, the lit texels 3% off either way
        sign = np.where(np.arange(ref.shape[0]) % 2 == 0, 1.03, 0.97)
        out = (ref * sign[:, None]).astype(f32)
    res = flagship.i8_bands(out, ref)
    assert res["pass"] is (case == "pass"), res
    if case == "lit":
        assert res["energy_rel_err"] < 5e-3
        assert res["lit_rel_err_mean"] > 0.02


@pytest.mark.parametrize("case", ["pass", "mean", "outliers"])
def test_ao_bands(flag, case):
    gold = _arena(flag, 0)
    ours = _noisy(gold, 1e-5)
    if case == "mean":
        ours = gold * f32(1 + 3e-4)
    elif case == "outliers":
        # 3% of the level-0 texels at 1e-3: the mean stays under 2e-4
        l0 = np.flatnonzero(flag.level0_mask())
        hit = l0[::33]
        ours = gold.copy()
        ours[hit] *= f32(1 + 1e-3)
    res = flagship.ao_bands(flag, ours, gold)
    assert res["pass"] is (case == "pass"), res
    if case == "outliers":
        assert res["mean_rel"] < 2e-4
        assert res["frac_texels_rel_ge_5e4"] > 0.02


@pytest.mark.parametrize("case", ["pass", "fail"])
def test_ao_wall_bands(flag, case):
    gold = _arena(flag, 0)
    ours = gold.copy()
    # a texel of the last wall off by 2e-4; other walls untouched
    r = flag.walls[flagship.AO_WALLS[-1]]
    ours[r.base + num_tiles(r) - 1] *= f32(1 + (2e-4 if case == "fail"
                                                else 5e-5))
    res = flagship.ao_wall_bands(flag, ours, gold)
    assert res["pass"] is (case == "pass"), res
    assert sorted(res["max_rel"]) == sorted(map(str, flagship.AO_WALLS))


@pytest.mark.parametrize("rays,case", [
    (10000, "pass"), (10000, "energy"), (10000, "corr"), (10000, "wall"),
    (2000, "pass"), (2000, "energy"), (2000, "wall")])
def test_radiosity_bands(flag, rays, case):
    gold = _arena(flag, 0)
    ours = _noisy(gold, 0.01)
    big = _big_wall(flag)
    if case == "energy":
        ours = ours * f32(1.015 if rays == 10000 else 1.03)
    elif case == "corr":
        ours = np.random.default_rng(3).permutation(ours)
    elif case == "wall":
        ours = _wall(flag, ours, big, 1.12 if rays == 10000 else 1.09)
    elif rays == 2000:
        # passes at 2,000 rays, where 10,000 would refuse it
        ours = _wall(flag, ours * f32(1.015), big, 1.05)
    res = flagship.radiosity_bands(flag, ours, gold, rays)
    assert res["pass"] is (case == "pass"), res
    assert res["walls_checked"] == len(flag.walls)
    if case == "pass" and rays == 2000:
        assert not flagship.radiosity_bands(flag, ours, gold, 10000)["pass"]
    if case == "wall":
        assert res["energy_rel_err"] < 0.01


def test_unexposed_undoes_the_exposure_scale(flag):
    raw = _arena(flag, 4)
    scale = p_ds.exposure_scale(flag, 1e8, 0.35)
    got = flagship.unexposed(flag, raw * scale[:, None], 1e8, 0.35)
    np.testing.assert_allclose(got, raw, rtol=2e-7)
    assert (got[~flag.level0_mask()] == 0).all()


def test_cli_config_is_the_cli_default():
    p = argparse.ArgumentParser()
    cli._add_engine_flags(p)
    cfg = flagship.cli_config()
    assert cfg == cli._build_cfg(p.parse_args([]))
    ph = cfg.photon
    assert (ph.samples_per_area, ph.splat, ph.device_rng,
            ph.photons_per_batch) == (1e8, "inkernel_i8", True, 1 << 17)
    assert cfg.engine.value == "photon_pallas"


def test_ao_gate_on_tiny_through_the_plain_versions():
    res = flagship.ao("cpu", scenes=("tiny",))
    assert res["pass"], res
    assert set(res) == {"gate", "tiny_fused", "tiny_chunked", "pass"}


def test_flagship_imports_without_jax_or_tests():
    code = (
        "import sys\n"
        "from flatmatch_tpu_torch.tools import flagship\n"
        "s = flagship.flagship_scene()\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not any(m == 'tests' or m.startswith(('tests.', "
        "'flatmatch_tpu.')) for m in sys.modules)\n"
        "print(len(s.walls))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(FIXTURES.parent.parent),
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "172"
