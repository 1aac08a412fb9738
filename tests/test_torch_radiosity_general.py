"""The port's general radiosity (a scene without an axis-aligned table)
against the JAX package and the reference engine's dump.

`tiny` turned 30 degrees about z (chip_smoke.rotated_scene) has no
axis-aligned table, so both packages cast the form-factor rays through the
general intersector: JAX's `_form_factors_device(use_aa=False,
compact_rows=True)` (`_form_factor_chunk`: `_ff_rays`, `nearest_hit`,
`texel_index`), the port's `form_factors` on the `Rects` of its extended
rects (`form_factor_chunk`: `ff_rays`, `ops/intersect.nearest_hit`, which
runs its plain version on the CPU, `ops/tile.texel_index`).

- The id table at 32 rays equals JAX's on >= 99.5% of entries,
  test_radiosity.py's bar for two intersectors at the same keys: torch's
  and XLA's sin/cos may differ in the last ulp.
- Fed JAX's id table, the relaxation and mipmap rebuild equal JAX's to rtol
  1e-5 (sums over rays in another order).
- At 2000 rays, rotated tiny sits in the bands of
  test_radiosity_vs_reference.py against the unrotated reference dump: the
  rays' cosine lobes turn with the walls (the floor's and the ceiling's
  frames keep the world's y axis, whose lobe is symmetric in azimuth), so
  the estimator is the same.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import rotated_scene
from flatmatch_tpu.config import RadiosityConfig as JaxRadiosityConfig
from flatmatch_tpu.engines import radiosity as jr
from flatmatch_tpu.ops.device_scene import pack_rects as j_pack_rects
from flatmatch_tpu.scene import geometry, image as im, layout
from flatmatch_tpu_torch.config import DEFAULT_CONFIG, RadiosityConfig
from flatmatch_tpu_torch.engines import radiosity
from flatmatch_tpu_torch.ops import aa_query, intersect
from flatmatch_tpu_torch.ops.aa_scene import pack_aa
from flatmatch_tpu_torch.ops.device_scene import Rects
from flatmatch_tpu_torch.ops.mipmap import build_plan
from flatmatch_tpu_torch.render import compile_scene
from flatmatch_tpu_torch.scene.rectangle import num_tiles
from tests.conftest import FIXTURES

f32 = np.float32
RAYS, SEED = 32, 5
_cache = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: the tensors are small, and the
    parallel test workers do not oversubscribe the cores they share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scenes():
    """(JAX scene, port scene) of tiny turned 30 degrees."""
    if "scenes" not in _cache:
        img = im.load_layout(str(FIXTURES / "tiny.png"))
        jscene = geometry.Scene(layout.parse_layout(img, f32(1) / f32(30),
                                                    200.0))
        pscene, _ = compile_scene(str(FIXTURES / "tiny.png"), 30.0,
                                  DEFAULT_CONFIG)
        _cache["scenes"] = (rotated_scene(jscene, 30),
                            rotated_scene(pscene, 30))
    return _cache["scenes"]


def _jax_ff():
    """JAX's general device form-factor table of rotated tiny and the
    pieces of its relaxation."""
    if "ff" not in _cache:
        jscene, _ = _scenes()
        cfg = JaxRadiosityConfig(rays_per_texel=RAYS, seed=SEED)
        prep = jr._radiosity_prep(jscene, cfg)
        assert prep[4] is None          # no axis-aligned table
        ids = np.asarray(jr._form_factors_device(
            jscene, j_pack_rects(prep[0]), cfg, prep[-1], use_aa=False,
            compact_rows=True))
        _cache["ff"] = (cfg, prep, ids)
    return _cache["ff"]


def test_prepare_takes_the_general_table():
    _, pscene = _scenes()
    rects, table, src = radiosity.prepare(pscene, RadiosityConfig(), "cpu")
    assert pack_aa(rects) is None and isinstance(table, Rects)
    assert len(rects) == (len(pscene.walls) + len(pscene.windows)
                          + len(pscene.lights))
    assert tuple(src.shape) == (radiosity.extended_rects(pscene)[1], 3)


def test_form_factor_ids_match_jax():
    cfg, prep, jids = _jax_ff()
    _, pscene = _scenes()
    l0_total = prep[6]
    _, table, _ = radiosity.prepare(pscene, RadiosityConfig(), "cpu")
    before = (aa_query.aa_nearest.launches, intersect.nearest_hit.launches)
    ids = radiosity.form_factors(
        pscene, table, RadiosityConfig(rays_per_texel=RAYS, seed=SEED))
    assert (aa_query.aa_nearest.launches,
            intersect.nearest_hit.launches) == before   # plain version
    assert ids.dtype == torch.int32 and tuple(ids.shape) == (l0_total, RAYS)
    ids = ids.numpy()
    assert (ids >= 0).mean() > 0.95
    assert ids.max() < prep[1]
    share = (ids == jids[:l0_total]).mean()
    print(f"general form-factor ids equal to JAX's: {share:.6f} of "
          f"{ids.size}")
    assert share >= 0.995


def test_form_factor_chunk_marks_escapes():
    """A chunk's rays that leave the room get -1; the others the texel of
    their hit point."""
    _, pscene = _scenes()
    _, table, _ = radiosity.prepare(pscene, RadiosityConfig(), "cpu")
    wall = pscene.walls[0]
    c = torch.from_numpy(radiosity.tile_centers(wall)[:8])
    n = torch.from_numpy(np.asarray(wall.n, f32))
    key = (0, 7)
    ids = radiosity.form_factor_chunk(table, c, n, key, 16)
    src, d = radiosity.ff_rays(c, n, key, 16)
    dist, _ = intersect.nearest_hit_plain(src, d, table)
    assert tuple(ids.shape) == (8, 16) and ids.dtype == torch.int32
    assert torch.equal(ids.reshape(-1) < 0, ~torch.isfinite(dist))


def test_relax_matches_jax_on_jax_ids():
    cfg, prep, jids = _jax_ff()
    (rects, total, plan, src, _, rays, l0_total, l0_idx, chunk, n_chunks,
     rows_pad) = prep
    relax_impl = jr._make_relax_impl(cfg, plan, rays, l0_total, l0_idx,
                                     chunk, n_chunks, rows_pad, total)
    want = np.asarray(jax.jit(relax_impl, static_argnames=("iters",))(
        jnp.asarray(src), jnp.asarray(jids), iters=7))
    _, pscene = _scenes()
    prects = radiosity.extended_rects(pscene)[0]
    got = radiosity.relax(
        torch.from_numpy(src.copy()), torch.from_numpy(jids[:l0_total].copy()),
        torch.from_numpy(radiosity.level0_arena_indices(pscene)),
        build_plan(prects), RadiosityConfig(rays_per_texel=RAYS, seed=SEED)
    ).numpy()
    assert got.shape == want.shape and got.sum() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-30)


def test_rotated_radiosity_matches_reference_engine_tiny():
    """The bands of test_radiosity_vs_reference.py at 2000 rays, seed 5,
    against the unrotated tiny's dump."""
    _, scene = _scenes()
    cfg = RadiosityConfig(rays_per_texel=2000, iterations=7, seed=SEED)
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
