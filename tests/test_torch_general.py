"""The port's general photon route and general AO against the JAX package.

The general route runs scenes that the axis-aligned table cannot hold:
`photon_pallas` on a scene with a rotated rect goes to the narrow kernel
(engines/photon_narrow.py, the port of engines/photon_pallas.py), and
`--engine photon_xla` and arenas of 2^24 texels or more to the general
engine (engines/photon.py); ambient occlusion of a scene without a table to
the general AO (engines/ao_general.py). Each is held against its JAX
counterpart on `tiny` and on `tiny` turned 30 degrees about z
(chip_smoke.rotated_scene), with the same scene tables and the same
uniforms (numpy seeds, or the JAX package's threefry draws, which the port
reproduces bit for bit). The narrow kernel's plain version (the path CPU
tensors take) is held against the TPU kernel run in Pallas interpret mode,
as the JAX package's own tests run it.

Tolerances. The packed tables are integer-exact and the f32 packing uses
the same numpy arithmetic: equal field by field. The intersector's sums
run in the same order as XLA's: distances within rtol 1e-6, hit ids on
>= 99.9% of rays, texel ids exactly. The traces draw the same uniforms; only
a last-ulp sin/cos/rsqrt difference between XLA and torch (the port
normalizes with 1/sqrt, XLA rewrites it to rsqrt) can split a path: the
narrow trace's ids on >= 99.9% of rows and colors within 1e-5, the general
trace's lightmap at the bands of tests/test_pallas.py (>= 99.9% of cells
within rtol 1e-3, atol 1e-2; total within 1e-4), whole renders on >= 99% of
texels within rtol 1e-4 and total within 1e-3 (the splats sum in another
f32 order). The AO sums 481 rays per texel in another f32 order: rtol 1e-5,
against the JAX function run op by op (see the test).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from chip_smoke import rotated_scene
from flatmatch_tpu.config import (
    DEFAULT_CONFIG as JAX_DEFAULT, AoConfig as JAoConfig, Engine as JEngine,
    PhotonConfig as JPhotonConfig,
)
from flatmatch_tpu.engines import ao as jao, photon as jphoton
from flatmatch_tpu.engines import photon_pallas as jpp
from flatmatch_tpu.engines.schedule import emitter_slice as j_slice
from flatmatch_tpu.ops import intersect as jint, linalg as jlinalg
from flatmatch_tpu.ops import sampling as jsampling
from flatmatch_tpu.ops import tile as jtile
from flatmatch_tpu.ops.device_scene import (
    pack_emitters as j_pack_em, pack_rects as j_pack_rects,
)
from flatmatch_tpu.render import (
    compile_scene as j_compile, run_engine as j_run_engine,
)
from flatmatch_tpu_torch import cli, interop
from flatmatch_tpu_torch.config import (
    DEFAULT_CONFIG, AoConfig, Engine, PhotonConfig,
)
from flatmatch_tpu_torch.engines import ao_general, photon, photon_narrow as pn
from flatmatch_tpu_torch.engines import photon_wide as pw
from flatmatch_tpu_torch.engines.schedule import emitter_slice
from flatmatch_tpu_torch.ops import aa_scene, intersect, linalg, sampling, tile
from flatmatch_tpu_torch.ops.device_scene import (
    pack_emitters, pack_rects, rect_count,
)
from flatmatch_tpu_torch.render import compile_scene, run_engine
from tests.conftest import FIXTURES

f32 = np.float32
TINY = str(FIXTURES / "tiny.png")
B = 512
U = 28
SPA = 2000.0
J_CFG = JPhotonConfig(samples_per_area=SPA, photons_per_batch=B, seed=9)
P_CFG = PhotonConfig(samples_per_area=SPA, photons_per_batch=B, seed=9)
DEGREES = [0, 30]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: the plain versions' tensors are
    small, so one thread is about as fast alone, and the parallel test
    workers do not oversubscribe the cores they share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=DEGREES, ids=lambda d: f"deg{d}")
def s(request):
    """tiny, turned request.param degrees, in both packages, with its
    packed tables and the uniforms of one batch."""
    deg = request.param
    jscene = rotated_scene(j_compile(TINY, 30.0, JAX_DEFAULT)[0],
                           deg)
    pscene = rotated_scene(compile_scene(TINY, 30.0, DEFAULT_CONFIG)[0], deg)
    jem = j_pack_em(jscene, SPA, J_CFG.window_color, J_CFG.light_color)
    return dict(
        deg=deg, jscene=jscene, pscene=pscene,
        jr=j_pack_rects(jscene.walls), pr=pack_rects(pscene.walls),
        jem=jem, pem=pack_emitters(pscene, SPA, P_CFG.window_color,
                                   P_CFG.light_color),
        u=np.random.RandomState(11 + deg).rand(B, U).astype(f32),
    )


def _t(a):
    return torch.from_numpy(np.array(a))


def test_rotation_takes_the_scene_off_the_table(s):
    """Turned 30 degrees, no rect is axis-aligned any more; the arena is
    laid out as before."""
    tab = aa_scene.pack_aa(s["pscene"].walls)
    assert (tab is None) == (s["deg"] != 0)
    base = compile_scene(TINY, 30.0, DEFAULT_CONFIG)[0]
    assert s["pscene"].num_texels == base.num_texels
    assert [(r.base, r.wtiles, r.htiles) for r in s["pscene"].walls] == [
        (r.base, r.wtiles, r.htiles) for r in base.walls]


def test_pack_rects_equals_jax_field_by_field(s):
    jr, pr = s["jr"], s["pr"]
    assert pr._fields == jr._fields
    for name in jr._fields:
        a, b = np.asarray(getattr(jr, name)), getattr(pr, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name
    assert pr.n.shape[0] == 128
    assert rect_count(pr) == len(s["pscene"].walls)
    # carried across from the JAX package's arrays, and back
    back = interop.from_jax_rects(*(np.asarray(x) for x in jr))
    assert all(torch.equal(x, y) for x, y in zip(back, pr))
    assert all(np.array_equal(x, np.asarray(y)) for x, y in
               zip(interop.to_jax_rects(pr), jr))


def test_scene_matrix_equals_jax_bit_for_bit(s):
    want = np.asarray(jpp.scene_matrix(s["jr"]))
    got = pn.scene_matrix(s["pr"]).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    table = pn.narrow_table(s["pr"])
    assert table.is_contiguous()
    assert np.array_equal(table.numpy(), want[:, :len(s["pscene"].walls)])
    assert np.array_equal(
        interop.from_jax_scene_matrix(want).numpy(), want)


def test_emitter_vector_equals_jax(s):
    for e in range(len(s["pem"].counts)):
        want = np.asarray(jpp.emitter_vector(j_slice(s["jem"], e)))[0]
        assert np.array_equal(pw.emitter_vector(s["pem"], e).numpy(), want)


def test_build_base_matches_jax_on_the_scene_normals(s):
    n = np.array([r.n for r in s["pscene"].walls + s["pscene"].windows],
                 f32)
    ju, jv = (np.asarray(x) for x in jsampling.build_base(jnp.asarray(n)))
    pu, pv = (x.numpy() for x in sampling.build_base(_t(n)))
    np.testing.assert_allclose(pu, ju, rtol=0, atol=2e-7)
    np.testing.assert_allclose(pv, jv, rtol=0, atol=2e-7)


def _rays(s, count=4096, seed=5):
    """Random rays from inside the room's box: origins [R, 3] and unit
    directions [R, 3]."""
    rs = np.random.RandomState(seed)
    pos = np.array([r.pos for r in s["pscene"].walls], f32)
    lo, hi = pos.min(0), pos.max(0)
    src = (lo + (hi - lo) * rs.uniform(0.05, 0.95, (count, 3))).astype(f32)
    d = rs.normal(size=(count, 3))
    return src, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(f32)


def test_nearest_hit_matches_jax(s):
    src, d = _rays(s)
    jd, jh = (np.asarray(x) for x in jint.nearest_hit(
        jnp.asarray(src), jnp.asarray(d), s["jr"]))
    pd, ph = (x.numpy() for x in intersect.nearest_hit(_t(src), _t(d),
                                                        s["pr"]))
    assert ph.dtype == np.int32
    hit = np.isfinite(jd)
    assert hit.mean() > 0.5
    assert np.array_equal(np.isfinite(pd), hit)
    np.testing.assert_allclose(pd[hit], jd[hit], rtol=1e-6)
    assert (ph[hit] == jh[hit]).mean() >= 0.999
    # texel ids of JAX's hits, in both packages: exact
    p = (src + d * np.where(hit, jd, 0.0)[:, None]).astype(f32)
    want = np.asarray(jtile.texel_index(s["jr"], jnp.asarray(jh),
                                        jnp.asarray(p)))
    got = tile.texel_index(s["pr"], _t(jh), _t(p)).numpy()
    assert got.dtype == np.int32 and np.array_equal(got[hit], want[hit])


def test_general_trace_batch_matches_jax(s):
    """engines/photon.trace_batch against the JAX XLA engine's at shared
    uniforms (the bands of tests/test_pallas.py:77-79)."""
    T = s["pscene"].num_texels
    want = np.asarray(jax.jit(jphoton.trace_batch,
                              static_argnames=("cfg",))(
        jnp.zeros((T, 3), jnp.float32), s["jr"], j_slice(s["jem"], 0),
        jnp.asarray(s["u"]), B, J_CFG))
    got = photon.trace_batch(torch.zeros((T, 3)), s["pr"],
                             emitter_slice(s["pem"], 0), _t(s["u"]), B,
                             P_CFG).numpy()
    assert want.sum() > 0
    close = np.isclose(got, want, rtol=1e-3, atol=1e-2)
    assert close.mean() > 0.999, f"only {close.mean():.4%} match"
    np.testing.assert_allclose(got.sum(), want.sum(), rtol=1e-4)


def test_general_trace_batch_with_albedo_and_power_matches_jax(s):
    """The differentiable path's arguments of trace_batch, a per-rect
    albedo and an emitter power, against JAX's at the same bands."""
    T = s["pscene"].num_texels
    n = s["pr"].n.shape[0]
    alb = np.random.RandomState(3).uniform(0.2, 0.9, n).astype(f32)
    power = f32(1.7)
    want = np.asarray(jax.jit(jphoton.trace_batch,
                              static_argnames=("cfg",))(
        jnp.zeros((T, 3), jnp.float32), s["jr"], j_slice(s["jem"], 0),
        jnp.asarray(s["u"]), B, J_CFG, jnp.asarray(alb), jnp.asarray(power)))
    got = photon.trace_batch(torch.zeros((T, 3)), s["pr"],
                             emitter_slice(s["pem"], 0), _t(s["u"]), B,
                             P_CFG, _t(alb), torch.tensor(power)).numpy()
    plain = photon.trace_batch(torch.zeros((T, 3)), s["pr"],
                               emitter_slice(s["pem"], 0), _t(s["u"]), B,
                               P_CFG).numpy()
    assert want.sum() > 0 and not np.allclose(got, plain)
    close = np.isclose(got, want, rtol=1e-3, atol=1e-2)
    assert close.mean() > 0.999, f"only {close.mean():.4%} match"
    np.testing.assert_allclose(got.sum(), want.sum(), rtol=1e-4)


@pytest.mark.parametrize("fn", ["dot3", "cross3", "normalize3"])
def test_linalg_matches_jax(fn):
    """ops/linalg against flatmatch_tpu/ops/linalg, op by op, on random
    vectors: cross3 exactly, the sums and the reciprocal length to 1e-6."""
    rs = np.random.RandomState(17)
    a, b = (rs.normal(size=(4096, 3)).astype(f32) for _ in range(2))
    args = {"dot3": (a, b), "cross3": (a, b), "normalize3": (a,)}[fn]
    want = np.asarray(getattr(jlinalg, fn)(*map(jnp.asarray, args)))
    got = getattr(linalg, fn)(*map(_t, args)).numpy()
    assert got.dtype == f32 and got.shape == want.shape
    if fn == "cross3":
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n_valid", [B, 300])
def test_narrow_trace_matches_the_tpu_kernel(s, n_valid):
    """trace_deposits_narrow_plain against trace_deposits_pallas in
    interpret mode at the same uniforms."""
    sceneT = jpp.scene_matrix(s["jr"])
    ev = jpp.emitter_vector(j_slice(s["jem"], 0))
    with pltpu.force_tpu_interpret_mode():
        ji, jc = jpp.trace_deposits_pallas(sceneT, ev, jnp.asarray(s["u"]),
                                           n_valid, J_CFG,
                                           block_photons=128)
    ji, jc = np.asarray(ji), np.asarray(jc)
    pi, pc = pn.trace_deposits_narrow_plain(
        pn.narrow_table(s["pr"]), pw.emitter_vector(s["pem"], 0),
        _t(s["u"]), n_valid, P_CFG)
    assert pi.dtype == torch.int32 and tuple(pi.shape) == ji.shape
    assert tuple(pc.shape) == jc.shape
    pi, pc = pi.numpy(), pc.numpy()
    assert jc.sum() > 0 and (jc[n_valid:] == 0).all()
    assert (pi == ji).all(axis=1).mean() >= 0.999
    np.testing.assert_allclose(pc, jc, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("padded", [False, True], ids=["trimmed", "padded"])
def test_narrow_wrapper_runs_the_plain_version(s, padded):
    """The wrapper on the CPU takes [U, B] uniforms (the threefry layout
    the kernel reads) and runs the plain version on their [B, U] view; the
    padded scene_matrix gives the same deposits as the trimmed table."""
    ev = pw.emitter_vector(s["pem"], 0)
    u = _t(s["u"])
    table = (pn.scene_matrix if padded else pn.narrow_table)(s["pr"])
    got = pn.trace_deposits_narrow(table, ev, u.t().contiguous(), 400, P_CFG)
    want = pn.trace_deposits_narrow_plain(pn.narrow_table(s["pr"]), ev, u,
                                          400, P_CFG)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("bad", ["rows", "em", "uniforms", "layout",
                                 "strided", "n_valid", "dtype"])
def test_narrow_wrapper_refuses_bad_inputs(s, bad):
    table = pn.narrow_table(s["pr"])
    ev = pw.emitter_vector(s["pem"], 0)
    u = _t(s["u"])
    u_t = u.t().contiguous()
    args = dict(scene=table, em_vec=ev, uniforms=u_t, n_valid=B)
    args.update({
        "rows": dict(scene=table[:13].contiguous()),
        "em": dict(em_vec=ev[:15]),
        "uniforms": dict(uniforms=u_t[:27].contiguous()),
        "layout": dict(uniforms=u),
        "strided": dict(uniforms=u.t()),
        "n_valid": dict(n_valid=B + 1),
        "dtype": dict(uniforms=u_t.double()),
    }[bad])
    with pytest.raises(ValueError):
        pn.trace_deposits_narrow(cfg=P_CFG, **args)


def test_scene_matrix_refuses_a_large_arena(s, monkeypatch):
    monkeypatch.setattr(aa_scene, "MAX_TEXELS", 64)
    with pytest.raises(ValueError, match="2\\^24"):
        pn.scene_matrix(s["pr"])


# --------------------------------------------------------------------------
# the slice as a whole
# --------------------------------------------------------------------------
RUN_SPA = 3000.0
RUN_B = 1024


@pytest.fixture(scope="module")
def rotated_runs():
    """JAX run_engine on rotated tiny (on the CPU it runs its XLA engine,
    with the draws of every photon engine) and the port's two general
    routes on the same scene, post-exposure."""
    jcfg = JAX_DEFAULT.replace(engine=JEngine.PHOTON_PALLAS)
    jcfg = jcfg.replace(photon=dataclasses.replace(
        jcfg.photon, samples_per_area=RUN_SPA, photons_per_batch=RUN_B))
    jscene = rotated_scene(j_compile(TINY, 30.0, jcfg)[0], 30)
    want = np.asarray(j_run_engine(jscene, jcfg, mesh=None))
    cfg = DEFAULT_CONFIG.replace(photon=dataclasses.replace(
        DEFAULT_CONFIG.photon, samples_per_area=RUN_SPA,
        photons_per_batch=RUN_B))
    pscene = rotated_scene(compile_scene(TINY, 30.0, cfg)[0], 30)
    before = pn.trace_deposits_narrow.launches
    got = {e: run_engine(pscene, cfg.replace(engine=e), device="cpu")
           for e in (Engine.PHOTON_PALLAS, Engine.PHOTON_XLA)}
    assert pn.trace_deposits_narrow.launches == before   # the CPU: plain
    return want, got


@pytest.mark.parametrize("engine", ["photon_pallas", "photon_xla"])
def test_general_routes_match_jax_run_engine(rotated_runs, engine):
    want, got = rotated_runs
    got = got[Engine(engine)]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert want.sum() > 0
    close = np.isclose(got, want, rtol=1e-4, atol=1e-6 * want.max())
    assert close.mean() >= 0.99, f"only {close.mean():.4%} close"
    np.testing.assert_allclose(got.sum(), want.sum(), rtol=1e-3)


def test_general_ao_matches_jax():
    cfg = DEFAULT_CONFIG.replace(engine=Engine.AMBIENT_OCCLUSION,
                                 ao=AoConfig(geosphere_level=3,
                                              texels_per_chunk=128))
    jscene = rotated_scene(j_compile(TINY, 30.0, JAX_DEFAULT)[0],
                           30)
    # op by op: inside a jitted fusion XLA's CPU backend contracts
    # multiply-adds into FMAs, which on rotated walls moves the grazing
    # rays' distances by an ulp and flips some between hit and miss; op by
    # op each operation rounds on its own, as in the port
    with jax.disable_jit():
        want = jao.render_ao(jscene, j_pack_rects(jscene.walls),
                             JAoConfig(geosphere_level=3,
                                       texels_per_chunk=128))
    pscene = rotated_scene(compile_scene(TINY, 30.0, cfg)[0], 30)
    got = run_engine(pscene, cfg, device="cpu")     # no table: general AO
    assert got.shape == want.shape
    l0 = pscene.level0_mask()
    assert (got[l0] > 0).all() and (got[~l0] == 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_large_arena_goes_to_the_general_engines(monkeypatch):
    """With the 2^24 threshold (aa_scene.MAX_TEXELS) lowered to tiny's
    largest texel id, photon_pallas runs engines/photon.render_photons and
    ambient occlusion runs the general AO, as in the JAX package."""
    cfg = DEFAULT_CONFIG.replace(photon=dataclasses.replace(
        DEFAULT_CONFIG.photon, samples_per_area=300.0, photons_per_batch=512))
    scene, _ = compile_scene(TINY, 30.0, cfg)
    monkeypatch.setattr(aa_scene, "MAX_TEXELS", max(
        r.base + r.wtiles * r.htiles for r in scene.walls))
    calls = []

    def spy(mod, name):
        real = getattr(mod, name)

        def wrapped(*a, **k):
            calls.append(f"{mod.__name__}.{name}")
            return real(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    spy(photon, "render_photons")
    spy(pn, "render_photons")
    spy(pw, "render_photons")
    spy(ao_general, "render_ao")
    out = run_engine(scene, cfg, device="cpu")
    assert calls == ["flatmatch_tpu_torch.engines.photon.render_photons"]
    assert np.isfinite(out).all() and out.sum() > 0
    ao_cfg = cfg.replace(engine=Engine.AMBIENT_OCCLUSION,
                         ao=AoConfig(geosphere_level=2))
    ao_out = run_engine(scene, ao_cfg, device="cpu")
    assert calls[1:] == ["flatmatch_tpu_torch.engines.ao_general.render_ao"]
    assert (ao_out[scene.level0_mask()] > 0).all()


def test_cli_renders_photon_xla(tmp_path):
    out = tmp_path / "xla"
    assert cli.main(["render", TINY, "30", "--engine", "photon_xla",
                     "--device", "cpu", "--samples-per-area", "3000",
                     "--photons-per-batch", "1024", "--out",
                     str(out)]) == 0
    scene, _ = compile_scene(TINY, 30.0, DEFAULT_CONFIG)
    assert len(list((out / "tiles").glob("tile_*.png"))) == len(scene.walls)
    assert (out / "geometry.json").read_bytes() == (
        FIXTURES / "tiny_geometry.json").read_bytes()
