"""The port's radiosity engine against the JAX package and the reference
engine's dumps.

- The threefry draws (`ops/threefry.py`) are bit-equal to jax.random.
- The mipmap plan is byte-equal; the torch apply_plan equals the JAX
  package's numpy twin to rtol 1e-6 (the same sums in the same order).
- The plain `aa_nearest` agrees with JAX's kernel in Pallas interpret mode
  on >= 99.9% of distances and ids (the same IEEE float32 sequence).
- The form-factor id table of tiny at 32 rays equals JAX's
  `_form_factors_device(use_aa=True, compact_rows=True)` in interpret mode
  on >= 99.5% of entries, test_radiosity.py's bar for two intersectors at
  the same keys: torch's and XLA's sin/cos may differ in the last ulp.
- Fed JAX's id table, the relaxation and mipmap rebuild equal JAX's to rtol
  1e-5 (sums over rays in another order).
- Radiosity of tiny at 2000 rays sits in the bands of
  test_radiosity_vs_reference.py against the reference engine's dump.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from flatmatch_tpu.config import RadiosityConfig as JaxRadiosityConfig
from flatmatch_tpu.engines import radiosity as jr
from flatmatch_tpu.ops.aa_query import aa_nearest as jax_aa_nearest
from flatmatch_tpu.ops.aa_scene import pack_aa as jax_pack_aa
from flatmatch_tpu.ops.mipmap import apply_plan_np, build_plan as jax_plan
from flatmatch_tpu.scene import geometry, image as im, layout
from flatmatch_tpu_torch import cli, interop
from flatmatch_tpu_torch.config import DEFAULT_CONFIG, RadiosityConfig
from flatmatch_tpu_torch.engines import ao, radiosity
from flatmatch_tpu_torch.ops import aa_query, threefry
from flatmatch_tpu_torch.ops.mipmap import apply_plan, build_plan
from flatmatch_tpu_torch.render import compile_scene
from flatmatch_tpu_torch.scene.rectangle import num_tiles
from tests.conftest import FIXTURES

f32 = np.float32
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


def _words(key):
    return tuple(int(x) for x in np.asarray(key))


@pytest.mark.parametrize("seed", [0, 3, 5, 2**31 - 1])
def test_threefry_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    port_key = threefry.prng_key(seed)
    assert _words(key) == port_key
    for wi, ci in ((0, 0), (3, 1), (431, 7)):
        jk = jax.random.fold_in(jax.random.fold_in(key, wi), ci)
        pk = threefry.fold_in(threefry.fold_in(port_key, wi), ci)
        assert _words(jk) == pk
        for shape in ((512, 32, 2), (7, 3), (1,), (3, 2000, 2)):
            want = np.asarray(jax.random.uniform(jk, shape, jnp.float32))
            got = threefry.uniform(pk, shape).numpy()
            assert got.shape == want.shape and got.dtype == np.float32
            assert got.view(np.uint32).tobytes() == \
                want.view(np.uint32).tobytes()


def test_threefry_draw_rows_do_not_depend_on_the_shape():
    """Element i of a draw depends only on the key and i: the rows of a
    wall's short last chunk equal the first rows of the padded draw the
    JAX package makes, so the port draws the real rows only."""
    key = threefry.fold_in(threefry.prng_key(5), 2)
    full = threefry.uniform(key, (512, 64, 2))
    assert torch.equal(threefry.uniform(key, (37, 64, 2)), full[:37])
    jk = jax.random.fold_in(jax.random.PRNGKey(5), 2)
    want = np.asarray(jax.random.uniform(jk, (512, 64, 2), jnp.float32))
    assert np.array_equal(full.numpy(), want)
    with pytest.raises(ValueError):
        threefry.prng_key(2**31)


def test_extended_rects_match_jax():
    jscene, pscene = _scenes("mini")
    jrects, jtotal, jfw, jfl = jr.extended_rects(jscene)
    prects, ptotal, pfw, pfl = radiosity.extended_rects(pscene)
    assert (ptotal, pfw, pfl) == (jtotal, jfw, jfl)
    assert [(r.base, r.wtiles, r.htiles) for r in prects] == \
        [(r.base, r.wtiles, r.htiles) for r in jrects]
    assert all(r.base == 0 for r in pscene.windows + pscene.lights)


@pytest.mark.parametrize("name", ["tiny", "mini"])
def test_mipmap_plan_byte_equal_and_apply(name):
    jscene, pscene = _scenes(name)
    jplan = jax_plan(jr.extended_rects(jscene)[0])
    pplan = build_plan(radiosity.extended_rects(pscene)[0])
    for field in ("parents", "children", "weights"):
        a, b = getattr(pplan, field), getattr(jplan, field)
        assert len(a) == len(b)
        assert all(x.dtype == y.dtype and x.tobytes() == y.tobytes()
                   for x, y in zip(a, b))
    total = radiosity.extended_rects(pscene)[1]
    tex = np.random.default_rng(1).random((total, 3)).astype(f32)
    tex_t = torch.from_numpy(tex.copy())
    got = apply_plan(tex_t, pplan).numpy()
    np.testing.assert_allclose(got, apply_plan_np(tex, jplan), rtol=1e-6)
    assert np.array_equal(tex_t.numpy(), tex)       # the input is not written


def test_aa_nearest_plain_matches_jax():
    """1024 random rays over mini's extended rects, as
    test_radiosity.test_aa_query_unroll_invariant makes them."""
    jscene, _ = _scenes("mini")
    jaa = jax_pack_aa(jr.extended_rects(jscene)[0])
    rng = np.random.default_rng(7)
    n = 8 * 128
    origins = rng.uniform(0.2, 5.0, (n, 3)).astype(f32)
    dirs = rng.normal(size=(n, 3)).astype(f32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    with pltpu.force_tpu_interpret_mode():
        jd, jt = jax_aa_nearest(jaa.fields, origins, dirs, jaa.group_counts)
    t = _port_table(jaa)
    before = aa_query.aa_nearest.launches
    pd, pt = aa_query.aa_nearest(t.fields, t.group_counts,
                                 torch.from_numpy(origins),
                                 torch.from_numpy(dirs))
    assert aa_query.aa_nearest.launches == before       # plain version
    assert pt.dtype == torch.int32
    jt = np.asarray(jt)
    assert (jt >= 0).any() and (jt < 0).any()
    assert (pd.numpy() == np.asarray(jd)).mean() >= 0.999
    assert (pt.numpy() == jt).mean() >= 0.999


def _jax_ff(name, rays, seed):
    """JAX's device form-factor table of `name` (interpret mode) and the
    pieces of its relaxation."""
    key = ("ff", name, rays, seed)
    if key not in _cache:
        jscene, _ = _scenes(name)
        cfg = JaxRadiosityConfig(rays_per_texel=rays, seed=seed)
        prep = jr._radiosity_prep(jscene, cfg)
        jaa = jax_pack_aa(prep[0])
        with pltpu.force_tpu_interpret_mode():
            ids = np.asarray(jr._form_factors_device(
                jscene, jaa, cfg, prep[-1], use_aa=True, compact_rows=True))
        _cache[key] = (cfg, prep, jaa, ids)
    return _cache[key]


def test_ff_rays_match_jax():
    jscene, pscene = _scenes("tiny")
    w = jscene.walls[3]
    c = jr.tile_centers(w)[:40]
    jkey = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(5), 3), 0)
    js, jd = jr._ff_rays(jnp.asarray(c), jnp.asarray(w.n), jkey, 16)
    ps, pd = radiosity.ff_rays(
        torch.from_numpy(ao.tile_centers(pscene.walls[3])[:40]),
        torch.from_numpy(np.asarray(pscene.walls[3].n, f32)),
        threefry.fold_in(threefry.fold_in(threefry.prng_key(5), 3), 0), 16)
    # the same draws; torch's and XLA's sin/cos (and XLA's fused
    # multiply-adds) differ in the last ulps of about half the components
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=0, atol=1e-6)


def test_form_factor_ids_match_jax():
    cfg, prep, jaa, jids = _jax_ff("tiny", 32, 5)
    _, pscene = _scenes("tiny")
    l0_total = prep[6]
    before = aa_query.aa_nearest.launches
    ids = radiosity.form_factors(
        pscene, _port_table(jaa), RadiosityConfig(rays_per_texel=32, seed=5))
    assert aa_query.aa_nearest.launches == before
    assert ids.dtype == torch.int32 and tuple(ids.shape) == (l0_total, 32)
    ids = ids.numpy()
    assert (ids >= 0).mean() > 0.95
    assert ids.max() < prep[1]
    share = (ids == jids[:l0_total]).mean()
    print(f"form-factor ids equal to JAX's: {share:.6f} of {ids.size}")
    assert share >= 0.995


def test_relax_matches_jax_on_jax_ids():
    cfg, prep, _, jids = _jax_ff("tiny", 32, 5)
    (rects, total, plan, src, _, rays, l0_total, l0_idx, chunk, n_chunks,
     rows_pad) = prep
    relax_impl = jr._make_relax_impl(cfg, plan, rays, l0_total, l0_idx,
                                     chunk, n_chunks, rows_pad, total)
    want = np.asarray(jax.jit(relax_impl, static_argnames=("iters",))(
        jnp.asarray(src), jnp.asarray(jids), iters=7))
    _, pscene = _scenes("tiny")
    prects = radiosity.extended_rects(pscene)[0]
    got = radiosity.relax(
        torch.from_numpy(src.copy()), torch.from_numpy(jids[:l0_total].copy()),
        torch.from_numpy(radiosity.level0_arena_indices(pscene)),
        build_plan(prects), RadiosityConfig(rays_per_texel=32, seed=5)
    ).numpy()
    assert got.shape == want.shape and got.sum() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-30)


def test_radiosity_matches_reference_engine_tiny():
    """The bands of test_radiosity_vs_reference.py at 2000 rays, seed 5."""
    _, scene = _scenes("tiny")
    cfg = RadiosityConfig(rays_per_texel=2000, iterations=7, seed=5)
    ours = radiosity.render_radiosity(scene, cfg, "cpu")
    gold = np.fromfile(FIXTURES / "tiny_radiosity_rays2000.f32",
                       dtype="<f4").reshape(scene.num_texels, 4)[:, :3]
    assert ours.dtype == np.float32 and np.isfinite(ours).all()
    np.testing.assert_allclose(ours.sum(), gold.sum(), rtol=0.02)
    checked = 0
    for i, r in enumerate(scene.walls):
        sl = slice(r.base, r.base + num_tiles(r))
        o, g = ours[sl].mean(), gold[sl].mean()
        if g > 1e-3:
            rtol = 0.08 if num_tiles(r) >= 64 else 0.2
            np.testing.assert_allclose(o, g, rtol=rtol, err_msg=f"wall {i}")
            checked += 1
    assert checked >= 5
    assert np.corrcoef(ours.ravel(), gold.ravel())[0, 1] > 0.99


def test_cli_radiosity_writes_tiles_and_identical_artifacts(tmp_path):
    out = tmp_path / "out"
    rc = cli.main(["render", str(FIXTURES / "tiny.png"), "30", "--device",
                   "cpu", "--engine", "radiosity", "--radiosity-rays", "64",
                   "--radiosity-iterations", "3", "--seed", "2",
                   "--out", str(out)])
    assert rc == 0
    for art in ("geometry", "collisionMap"):
        assert ((out / f"{art}.json").read_bytes()
                == (FIXTURES / f"tiny_{art}.json").read_bytes())
    assert len(list((out / "tiles").glob("tile_*.png"))) == 13


def test_radiosity_deterministic_and_iterations_add_light():
    _, scene = _scenes("tiny")
    cfg = RadiosityConfig(rays_per_texel=64, seed=3)
    a = radiosity.render_radiosity(scene, cfg, "cpu")
    np.testing.assert_array_equal(a, radiosity.render_radiosity(scene, cfg,
                                                                "cpu"))
    one = radiosity.render_radiosity(
        scene, dataclasses.replace(cfg, iterations=1), "cpu")
    assert a.sum() > one.sum() > 0
