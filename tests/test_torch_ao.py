"""The port's ambient-occlusion engine against the JAX package and the
reference goldens.

The port's host tables (geosphere, tile centers, rotated directions) are
numpy copies and must be byte-equal. Its plain versions of the two AO
kernels are held to the JAX kernels run in Pallas interpret mode, as the
JAX package's own tests run them, on identical scene tables
(flatmatch_tpu_torch.interop): the nearest-hit arithmetic is the same IEEE
float32 sequence, so distances agree on >= 99.9% of rays; the fused pass
sums over directions in another order than XLA, so texels agree to 1e-5
relative with the same zeros. The port's AO of tiny (fused and chunked) and
of mini (chunked) must sit in the bands of test_ao_parity.py against the
reference build's dumps, and the tiles of mini within 1 LSB of its PNGs.

One band differs on mini. test_ao_parity's mean bound of 1e-4 holds the
JAX package's general XLA intersector (4.8e-5 on mini). The axis-aligned
kernels, which the JAX package runs on its accelerator and the port runs
everywhere, test rect bounds in another arithmetic, and a few rays that
graze a coplanar wall's edge land on the other side of it. JAX's own
axis-aligned AO misses 1e-4 on mini against the same dump, and the port
matches it texel by texel (test_mini_ao_matches_jax_axis_aligned). On
mini the mean bound is therefore MINI_AA_MEAN.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from PIL import Image as PILImage

from flatmatch_tpu.config import AoConfig as JaxAoConfig
from flatmatch_tpu.engines import ao as jax_ao, ao_pallas
from flatmatch_tpu.ops.aa_scene import pack_aa as jax_pack_aa
from flatmatch_tpu.ops.geosphere import geosphere as jax_geosphere
from flatmatch_tpu.scene import geometry, image as im, layout
from flatmatch_tpu.scene.rectangle import num_tiles
from flatmatch_tpu_torch import cli, interop
from flatmatch_tpu_torch.config import DEFAULT_CONFIG, AoConfig
from flatmatch_tpu_torch.engines import ao
from flatmatch_tpu_torch.io import tiles as tiles_io
from flatmatch_tpu_torch.ops import aa_query
from flatmatch_tpu_torch.ops.aa_scene import pack_aa
from flatmatch_tpu_torch.ops.geosphere import geosphere
from flatmatch_tpu_torch.render import compile_scene
from tests.conftest import FIXTURES

f32 = np.float32
MINI_AA_MEAN = 1.25e-4   # JAX's own axis-aligned AO misses 1e-4 (see above)
_cache = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: the plain versions' tensors are
    small, so one thread is about as fast alone, and the parallel test
    workers do not oversubscribe the cores they share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scenes(name):
    """(JAX scene, port scene) of a fixture layout."""
    if name not in _cache:
        img = im.load_layout(str(FIXTURES / f"{name}.png"))
        jscene = geometry.Scene(layout.parse_layout(img, f32(1) / f32(30),
                                                    200.0))
        pscene, _ = compile_scene(str(FIXTURES / f"{name}.png"), 30.0,
                                  DEFAULT_CONFIG)
        _cache[name] = (jscene, pscene)
    return _cache[name]


def _port_table(jaa):
    return interop.from_jax_aa(np.asarray(jaa.fields), jaa.group_counts,
                               jaa.perm)


@pytest.mark.parametrize("depth", [2, 3, 4, 5])
def test_geosphere_byte_equal(depth):
    a, b = geosphere(depth), jax_geosphere(depth)
    assert a.dtype == b.dtype == np.float32
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", ["tiny", "mini"])
def test_tile_centers_and_wall_directions_byte_equal(name):
    jscene, pscene = _scenes(name)
    for jw, pw in zip(jscene.walls, pscene.walls):
        assert (ao.tile_centers(pw).tobytes()
                == jax_ao.tile_centers(jw).tobytes())
        for level in (3, 4):
            assert (ao.wall_directions(pw.n, level).tobytes()
                    == jax_ao.wall_directions(jw.n, level).tobytes())


def test_nearest_distances_plain_matches_jax():
    """1024 AO rays of mini (texels of three walls, every geosphere-4
    direction, some with exact zero components) through JAX's
    nearest_distances in interpret mode and the port's plain version."""
    jscene, _ = _scenes("mini")
    jaa = jax_pack_aa(jscene.walls)
    origins, dirs = [], []
    for wi, t in ((0, 40), (8, 80), (20, 3)):
        w = jscene.walls[wi]
        d = jax_ao.wall_directions(w.n, 4)
        c = jax_ao.tile_centers(w)[t]
        origins.append(c[None, :] + d * f32(1e-5))
        dirs.append(d)
    origins = np.concatenate(origins)[:1024].astype(f32)
    dirs = np.concatenate(dirs)[:1024].astype(f32)
    assert (dirs == 0).any()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ao_pallas.nearest_distances(
            jaa.fields, origins, dirs, jaa.group_counts, sky=10.0))
    t = _port_table(jaa)
    before = aa_query.nearest_distances.launches
    got = aa_query.nearest_distances(t.fields, t.group_counts,
                                     torch.from_numpy(origins),
                                     torch.from_numpy(dirs), 10.0).numpy()
    assert aa_query.nearest_distances.launches == before  # plain version
    assert (want < 10.0).mean() > 0.5
    assert (got == want).mean() >= 0.999


def test_ao_fused_plain_matches_jax():
    """The fused pass of tiny at geosphere level 3 (113 directions, one
    128-direction block) against JAX render_ao_fused(sublanes=8)."""
    jscene, pscene = _scenes("tiny")
    jaa = jax_pack_aa(jscene.walls)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ao_pallas.render_ao_fused(
            jscene, jaa, JaxAoConfig(geosphere_level=3), sublanes=8))
    before = ao.ao_fused.launches
    got = ao.render_ao_fused(pscene, _port_table(jaa),
                             AoConfig(geosphere_level=3))
    assert ao.ao_fused.launches == before
    assert got.dtype == np.float32 and got.shape == want.shape
    assert ((got == 0) == (want == 0)).all()
    nz = want != 0
    assert nz.mean() > 0.5
    assert (np.abs(got[nz] - want[nz]) / np.abs(want[nz])).max() <= 1e-5


def _golden_rel(scene, ours, name):
    """Relative error of the level-0 texels against the reference dump."""
    gold = np.fromfile(FIXTURES / f"{name}_ao_texels.f32",
                       dtype="<f4").reshape(scene.num_texels, 4)[:, :3]
    level0 = scene.level0_mask()
    a, g = ours[level0], gold[level0]
    return np.abs(a - g) / np.maximum(np.abs(g), 1e-6)


def _golden_bands(scene, ours, name):
    """The bands of test_ao_parity.test_ao_texels_match_reference, with
    MINI_AA_MEAN as the mean bound on mini."""
    rel = _golden_rel(scene, ours, name)
    level0 = scene.level0_mask()
    assert (rel < 2e-2).all(), f"max rel diff {rel.max()}"
    assert (rel < 5e-4).mean() > 0.98
    assert rel.mean() < (MINI_AA_MEAN if name == "mini" else 1e-4)
    assert (ours[~level0] == 0).all()
    # grayscale in all three channels
    assert (ours[:, 0] == ours[:, 1]).all() and (ours[:, 1] == ours[:, 2]).all()


def _port_ao_chunked(name):
    """The port's chunked AO of a fixture at the defaults (cached)."""
    key = (name, "ao")
    if key not in _cache:
        _, scene = _scenes(name)
        _cache[key] = ao.render_ao(scene, pack_aa(scene.walls), AoConfig())
    return _cache[key]


def _jax_ao_aa_mini():
    """JAX's axis-aligned chunked AO of mini at the defaults: the program
    of ao_pallas.render_ao (`_ao_all` on the tables of `_ao_prep`), in
    interpret mode, as one chunk of 512-sublane blocks. Each ray's arithmetic and each texel's sum over
    directions are those of render_ao's 8-sublane chunks; the wider blocks
    only cut the interpreter's per-block cost."""
    jscene, _ = _scenes("mini")
    cfg = JaxAoConfig()
    fac, dirs, _, _, k_pad, _, _, _, t0 = ao_pallas._ao_prep(jscene, cfg,
                                                            1 << 21)
    centers = np.concatenate([jax_ao.tile_centers(w) for w in jscene.walls])
    walls = np.concatenate([np.full(num_tiles(w), i, np.int32)
                            for i, w in enumerate(jscene.walls)])
    sublanes = 512
    quantum = sublanes * 128 // np.gcd(k_pad, sublanes * 128)
    pad = np.arange(-(-t0 // quantum) * quantum) % t0      # wrap-pad
    jaa = jax_pack_aa(jscene.walls)
    with pltpu.force_tpu_interpret_mode():
        vals = np.asarray(ao_pallas._ao_all(
            jaa.fields, jnp.asarray(centers[pad]), jnp.asarray(walls[pad]),
            dirs, fac, jaa.group_counts, k_pad, len(pad), 1,
            float(cfg.sky_distance), float(cfg.normalization),
            sublanes))[:t0]
    texels = np.zeros((jscene.num_texels, 3), f32)
    t = 0
    for w in jscene.walls:
        n = num_tiles(w)
        texels[w.base:w.base + n] = vals[t:t + n, None]
        t += n
    return texels


def test_mini_ao_matches_jax_axis_aligned():
    """Backs MINI_AA_MEAN: JAX's own axis-aligned AO of mini misses
    test_ao_parity's mean bound of 1e-4 but keeps MINI_AA_MEAN, and the
    port's AO equals it texel by texel, apart from a few texels where
    XLA's ray origins (c + d * 1e-5) round otherwise and a grazing ray
    lands on the other side of an edge."""
    _, scene = _scenes("mini")
    want = _jax_ao_aa_mini()
    jax_mean = float(_golden_rel(scene, want, "mini").mean())
    assert 1e-4 < jax_mean < MINI_AA_MEAN, jax_mean
    got = _port_ao_chunked("mini")
    assert ((got == 0) == (want == 0)).all()
    nz = want != 0
    rel = np.abs(got[nz] - want[nz]) / np.abs(want[nz])
    assert (rel <= 1e-5).mean() >= 0.999
    assert rel.max() < 1e-2


@pytest.mark.parametrize("name,fused", [
    ("tiny", True), ("tiny", False), ("mini", False),
])
def test_ao_matches_reference_golden(name, fused):
    _, scene = _scenes(name)
    aa = pack_aa(scene.walls)
    cfg = AoConfig()
    ours = (ao.render_ao_fused(scene, aa, cfg) if fused
            else _port_ao_chunked(name))
    _golden_bands(scene, ours, name)
    if fused:
        chunked = _port_ao_chunked(name)
        nz = chunked != 0
        assert ((ours == 0) == ~nz).all()
        assert (np.abs(ours[nz] - chunked[nz]) / chunked[nz]).max() < 1e-5


@pytest.mark.parametrize("idx", [0, 5])
def test_ao_tile_png_matches_reference(idx):
    """Tone map, uint8 and the floor tint of AO exports (tintExtra,
    main.c:88-91) reproduce the reference PNG within 1 LSB."""
    _, scene = _scenes("mini")
    ours = tiles_io.tile_rgb(scene.walls[idx], _port_ao_chunked("mini"),
                             tint_extra=True)
    gold = np.asarray(PILImage.open(FIXTURES / f"mini_ao_tile_{idx}.png")
                      .convert("RGB"))
    assert ours.shape == gold.shape
    diff = np.abs(ours.astype(int) - gold.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.02


@pytest.mark.parametrize("flags", [[], ["--ao-chunked"]])
def test_cli_ao_writes_tiles_and_identical_artifacts(flags, tmp_path):
    out = tmp_path / "out"
    rc = cli.main(["render", str(FIXTURES / "tiny.png"), "30", "--device",
                   "cpu", "--engine", "ambient_occlusion", *flags,
                   "--out", str(out)])
    assert rc == 0
    for art in ("geometry", "collisionMap"):
        assert ((out / f"{art}.json").read_bytes()
                == (FIXTURES / f"tiny_{art}.json").read_bytes())
    assert len(list((out / "tiles").glob("tile_*.png"))) == 13


def test_ao_wrappers_refuse_bad_inputs():
    _, scene = _scenes("tiny")
    aa = pack_aa(scene.walls)
    f, gc = aa.fields, aa.group_counts
    o = torch.zeros((8, 3))
    with pytest.raises(ValueError):                   # float64 rays
        aa_query.nearest_distances(f, gc, o.double(), o.double())
    with pytest.raises(ValueError):                   # [R, 2]
        aa_query.nearest_distances(f, gc, o[:, :2], o[:, :2])
    with pytest.raises(ValueError):                   # non-contiguous
        aa_query.nearest_distances(f, gc, o.t().t()[::2], o[::2])
    with pytest.raises(ValueError):                   # wrong table
        aa_query.nearest_distances(f[:12], gc, o, o)
    c = torch.zeros((4, 3))
    w = torch.zeros((4,), dtype=torch.int32)
    d = torch.zeros((1, 3, 128))
    fac = torch.zeros((128,))
    with pytest.raises(ValueError):                   # wall ids int64
        ao.ao_fused(f, gc, c, w.long(), d, fac)
    with pytest.raises(ValueError):                   # k_pad of 100
        ao.ao_fused(f, gc, c, w, d[:, :, :100], fac[:100])
    with pytest.raises(ValueError):                   # fac too short
        ao.ao_fused(f, gc, c, w, d, fac[:64])
    with pytest.raises(ValueError):                   # dirs [W, 2, K]
        ao.ao_fused(f, gc, c, w, d[:, :2], fac)
