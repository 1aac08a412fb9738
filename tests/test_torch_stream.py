"""The port's deposit-stream photon tier against the JAX package.

The stream tier traces each batch into a deposit stream (texel id, rgb per
photon and bounce) and splats it separately: `trace_deposits_wide` (the
draws passed in, here jax.random's threefry uniforms) or
`trace_deposits_wide_rng` (the counter hash), then `fused_splat_i8`,
`fused_splat` or the exact scatter. One 1024-photon batch of `tiny` goes
through the JAX package's kernels, run in Pallas interpret mode as its own
tests run them, and through the port's plain PyTorch versions (the path CPU
tensors take), with identical scene and emitter tables and identical draws.

Tolerances. The threefry draws, the counter-hash draws, the stream's ids and
the 7-bit splat are integer work and must agree bit for bit. The colors
must too on this batch: the same uniforms give the same f32 operations in
the same order (the trace's sin/cos agree here on every photon). The f32
splats differ from JAX's only in the order of their f32 sums: rtol 1e-5,
atol 1e-6 per texel. The whole render of `mini` is held to the bands of
tests/test_photon_parity.py::test_full_render_parity against the JAX
package's XLA engine, which draws the same threefry uniforms.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from flatmatch_tpu.config import PhotonConfig
from flatmatch_tpu.engines import photon, photon_pallas
from flatmatch_tpu.engines import photon_pallas_wide as jw
from flatmatch_tpu.engines.schedule import emitter_slice
from flatmatch_tpu.ops import splat as jsplat, splat_pallas
from flatmatch_tpu.ops.aa_scene import pack_aa as jax_pack_aa
from flatmatch_tpu.ops.device_scene import (
    exposure_scale as jax_exposure, pack_emitters as jax_pack_em,
    pack_rects as jax_pack_rects,
)
from flatmatch_tpu.scene import geometry, image as im, layout
from flatmatch_tpu_torch import cli, interop
from flatmatch_tpu_torch.config import DEFAULT_CONFIG
from flatmatch_tpu_torch.diff import render as pdiff
from flatmatch_tpu_torch.engines import photon_wide as pw
from flatmatch_tpu_torch.ops import splat as psplat, threefry
from flatmatch_tpu_torch.ops.aa_scene import pack_aa
from flatmatch_tpu_torch.ops.device_scene import pack_emitters
from flatmatch_tpu_torch.render import compile_scene, run_engine
from tests.conftest import FIXTURES

f32 = np.float32
B = 1024
N_VALID = 1000     # the last 24 photons are dead from the start
BLOCK = 512        # the JAX kernels run at sublanes=4: TB = 4 * 128
U = 28             # 4 + 3 * max_depth
GLOBAL_BATCH = 70000
CFG = PhotonConfig(samples_per_area=3000.0, photons_per_batch=B, seed=9,
                   splat="fused", device_rng=False)
TINY = str(FIXTURES / "tiny.png")
MINI = str(FIXTURES / "mini.png")
# the module, which the package's `render` function shadows
prender = importlib.import_module("flatmatch_tpu_torch.render")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: the plain versions' tensors are
    small, so one thread is about as fast alone, and the parallel test
    workers do not oversubscribe the cores they share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tables():
    img = im.load_layout(TINY)
    scene = geometry.Scene(layout.parse_layout(img, f32(1) / f32(30), 200.0))
    aa = jax_pack_aa(scene.walls)
    em = jax_pack_em(scene, CFG.samples_per_area, CFG.window_color,
                     CFG.light_color)
    aa_c, total_c, _ = jw.compact_aa(aa, scene.num_texels)
    ev = photon_pallas.emitter_vector(emitter_slice(em, 0))
    port_aa = interop.from_jax_aa(np.asarray(aa_c.fields), aa_c.group_counts,
                                  aa_c.perm)
    port_ev = torch.from_numpy(np.array(ev, f32).reshape(16))
    uniforms = jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(CFG.seed), GLOBAL_BATCH),
        (B, U), jnp.float32)
    return dict(aa_c=aa_c, total_c=total_c, ev=ev, port_aa=port_aa,
                port_ev=port_ev, uniforms=uniforms,
                seed=int(jw.batch_seed(CFG.seed, 3)))


@pytest.fixture(scope="module")
def jax_stream(tables):
    """JAX's trace_deposits_wide on the threefry uniforms (interpret)."""
    t = tables
    with pltpu.force_tpu_interpret_mode():
        idx, col = jw.trace_deposits_wide(
            t["aa_c"].fields, t["ev"], t["uniforms"], N_VALID, CFG,
            t["aa_c"].group_counts, 4)
        return np.array(idx), np.array(col)


@pytest.fixture(scope="module")
def jax_stream_rng(tables):
    t = tables
    with pltpu.force_tpu_interpret_mode():
        idx, col = jw.trace_deposits_wide_rng(
            t["aa_c"].fields, t["ev"], t["seed"], N_VALID, CFG,
            t["aa_c"].group_counts, B, 4)
        return np.array(idx), np.array(col)


@pytest.fixture(scope="module")
def jax_splats(tables, jax_stream):
    """JAX's two stream splats and the XLA scatter on the stream."""
    idx, col = (jnp.asarray(a) for a in jax_stream)
    T = tables["total_c"]
    with pltpu.force_tpu_interpret_mode():
        i8 = splat_pallas.fused_splat_i8(idx, col, T,
                                         scale=jw.splat_color_scale(CFG))
        fused = splat_pallas.fused_splat(idx, col, T)
    scatter = jsplat.scatter_splat(jnp.zeros((T, 3), jnp.float32), idx, col)
    return dict(fused_i8=np.array(i8), fused=np.array(fused), scatter=np.array(scatter))


@pytest.mark.parametrize("seed,batch", [(0, 0), (9, GLOBAL_BATCH),
                                        (2**31 - 1, 5)])
def test_batch_uniforms_match_jax(seed, batch):
    want = np.array(jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(seed), batch), (B, U),
        jnp.float32))
    got = threefry.batch_uniforms(seed, batch, B, U).numpy()
    assert got.dtype == np.float32 and got.shape == (B, U)
    assert got.view(np.uint32).tobytes() == want.view(np.uint32).tobytes()
    # the first rows of a batch do not depend on its size (tail shrink)
    assert torch.equal(threefry.batch_uniforms(seed, batch, 300, U),
                       torch.from_numpy(want[:300]))


def test_stream_block_is_the_jax_photon_block():
    assert pw.stream_block(131072) == 64 * 128
    assert pw.stream_block(1024) == 8 * 128
    assert pw.stream_block(384) == 128
    for bad in (0, 100, 1000):
        with pytest.raises(ValueError):
            pw.stream_block(bad)


def _check_stream(got, want):
    """Ids on every row and colors bit for bit, in the JAX row order."""
    pidx, pcol = (x.numpy() for x in got)
    idx, col = want
    assert pidx.shape == (B * 8,) and pcol.shape == (B * 8, 3)
    assert pidx.dtype == np.int32 and pcol.dtype == np.float32
    np.testing.assert_array_equal(pidx, idx)
    assert pcol.view(np.uint32).tobytes() == col.view(np.uint32).tobytes()
    # rows (b * D + d) * TB + w: dead photons (w >= 488 of block 1) hold 0
    rows = pcol.reshape(2, 8, BLOCK, 3)
    assert not rows[1, :, N_VALID - BLOCK:].any()
    assert (rows[:, 0].sum(-1) > 0).mean() > 0.5


def test_stream_trace_matches_jax(tables, jax_stream):
    t = tables
    u = threefry.batch_uniforms(CFG.seed, GLOBAL_BATCH, B, U)
    before = pw.trace_deposits_wide.launches
    got = pw.trace_deposits_wide(t["port_aa"].fields,
                                 t["port_aa"].group_counts, t["port_ev"], u,
                                 N_VALID, CFG, block=BLOCK)
    assert pw.trace_deposits_wide.launches == before   # the plain version
    _check_stream(got, jax_stream)


def test_stream_trace_rng_matches_jax(tables, jax_stream_rng):
    t = tables
    before = pw.trace_deposits_wide_rng.launches
    got = pw.trace_deposits_wide_rng(
        t["port_aa"].fields, t["port_aa"].group_counts, t["port_ev"],
        t["seed"], N_VALID, B, CFG, block=BLOCK)
    assert pw.trace_deposits_wide_rng.launches == before
    _check_stream(got, jax_stream_rng)


def _stream(jax_stream):
    return tuple(torch.from_numpy(a.copy()) for a in jax_stream)


def test_fused_splat_i8_matches_jax(tables, jax_stream, jax_splats):
    idx, col = _stream(jax_stream)
    before = psplat.fused_splat_i8.launches
    got = psplat.fused_splat_i8(idx, col, tables["total_c"],
                                pw.splat_color_scale(CFG)).numpy()
    assert psplat.fused_splat_i8.launches == before
    assert got.sum() > 0
    np.testing.assert_array_equal(got, jax_splats["fused_i8"])


@pytest.mark.parametrize("mode", ["fused", "scatter"])
def test_f32_splats_match_jax(tables, jax_stream, jax_splats, mode):
    """The same colors (bf16-rounded for fused) summed in another f32
    order."""
    idx, col = _stream(jax_stream)
    fn = psplat.fused_splat if mode == "fused" else psplat.scatter_splat
    got = fn(idx, col, tables["total_c"], psplat.stream_bound(CFG)).numpy()
    want = jax_splats[mode]
    assert want.sum() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the splat mode dispatch adds the same increment in place
    lm = torch.ones((tables["total_c"], 3))
    cfg = dataclasses.replace(CFG, splat=mode)
    assert psplat.splat_stream(lm, idx, col, cfg) is lm
    np.testing.assert_array_equal(lm.numpy(), got + 1.0)


def test_splats_skip_ids_out_of_range():
    idx = torch.tensor([0, 3, -1, 4, 2], dtype=torch.int32)
    col = torch.full((5, 3), 1.5)
    for fn in (psplat.fused_splat, psplat.scatter_splat):
        got = fn(idx, col, 4, 100.0)
        assert got.shape == (4, 3)
        np.testing.assert_array_equal(got[:, 0].numpy(), [1.5, 0, 1.5, 1.5])
    got = psplat.fused_splat_i8(idx, col, 4, 2.0 / 127)
    assert got[1].sum() == 0 and got.sum() > 0


def test_splat_wrappers_refuse_bad_streams():
    idx = torch.zeros(8, dtype=torch.int32)
    col = torch.zeros(8, 3)
    for args in ((idx.long(), col), (idx, col.double()), (idx[:7], col),
                 (idx, col[:, :2]), (idx, col.t().contiguous().t())):
        with pytest.raises(ValueError):
            psplat.fused_splat(*args, 4, 10.0)
        with pytest.raises(ValueError):
            psplat.fused_splat_i8(*args, 4, 0.1)
    with pytest.raises(ValueError):
        psplat.fused_splat(idx, col, 4, 0.0)     # no fixed-point scale


def test_stream_wrappers_check_inputs(tables):
    t = tables
    f, gc, ev = t["port_aa"].fields, t["port_aa"].group_counts, t["port_ev"]
    u = threefry.batch_uniforms(0, 0, 256, U)
    with pytest.raises(ValueError):          # block does not divide
        pw.trace_deposits_wide_rng(f, gc, ev, 0, 8, 256, CFG, block=96)
    with pytest.raises(ValueError):          # batch not a multiple of 128
        pw.trace_deposits_wide_rng(f, gc, ev, 0, 8, 200, CFG)
    with pytest.raises(ValueError):          # U != 4 + 3 * max_depth
        pw.trace_deposits_wide(f, gc, ev, u[:, :27].contiguous(), 8, CFG)
    with pytest.raises(ValueError):          # float64 uniforms
        pw.trace_deposits_wide(f, gc, ev, u.double(), 8, CFG)
    with pytest.raises(ValueError):          # n_valid past the batch
        pw.trace_deposits_wide(f, gc, ev, u, 257, CFG)


# --------------------------------------------------------------------------
# the slice as a whole
# --------------------------------------------------------------------------
def _port_cfg(**photon):
    return DEFAULT_CONFIG.replace(photon=dataclasses.replace(
        DEFAULT_CONFIG.photon, samples_per_area=3000.0, **photon))


def test_mini_scatter_render_matches_xla_engine():
    """run_engine on the threefry stream tier with the exact splat against
    the JAX package's XLA engine (engines/photon.render_photons), which
    draws the same uniforms per batch, at test_full_render_parity's
    bands."""
    jcfg = PhotonConfig(samples_per_area=3000.0, photons_per_batch=512,
                        seed=7)
    img = im.load_layout(MINI)
    scene = geometry.Scene(layout.parse_layout(img, f32(1) / f32(30), 200.0))
    em = jax_pack_em(scene, jcfg.samples_per_area, jcfg.window_color,
                     jcfg.light_color)
    lm = np.array(photon.render_photons(jax_pack_rects(scene.walls), em,
                                   scene.num_texels, jcfg))
    want = lm * jax_exposure(scene, jcfg.samples_per_area,
                             jcfg.exposure)[:, None]
    cfg = _port_cfg(photons_per_batch=512, seed=7, device_rng=False,
                    splat="scatter")
    pscene, _ = compile_scene(MINI, 30.0, cfg)
    got = run_engine(pscene, cfg, device="cpu")
    assert got.shape == want.shape and want.sum() > 0
    close = np.isclose(got, want, rtol=1e-3, atol=1e-2)
    assert close.mean() > 0.999, f"only {close.mean():.4%} texels match"
    np.testing.assert_allclose(got.sum(), want.sum(), rtol=1e-4)


def test_library_default_renders_the_threefry_fused_route(tmp_path,
                                                          monkeypatch):
    """render(png) with no cfg: DEFAULT_CONFIG's device_rng=False and
    splat="fused" (at a test budget), within bf16 rounding of the exact
    splat's render."""
    assert not DEFAULT_CONFIG.photon.device_rng
    assert DEFAULT_CONFIG.photon.splat == "fused"
    small = _port_cfg(photons_per_batch=1024)
    monkeypatch.setattr(prender, "DEFAULT_CONFIG", small)
    res = prender.render(TINY, str(tmp_path), device="cpu")
    assert len(res.tile_paths) == len(res.scene.walls)
    exact = run_engine(res.scene, _port_cfg(photons_per_batch=1024,
                                            splat="scatter"), "cpu")
    assert exact.sum() > 0 and not np.array_equal(res.texels, exact)
    np.testing.assert_allclose(res.texels.sum(), exact.sum(), rtol=1e-3)


def _raw(cfg, name=TINY):
    scene, _ = compile_scene(name, 30.0, cfg)
    aa = pack_aa(scene.walls, "cpu")
    ph = cfg.photon
    em = pack_emitters(scene, ph.samples_per_area, ph.window_color,
                       ph.light_color, "cpu")
    aa_c, total_c, _ = pw.compact_aa(aa, scene.num_texels)
    sched = pw.emitter_schedule(em.counts, ph.photons_per_batch)
    return pw.render_all_wide(aa_c.fields, aa_c.group_counts, em, ph,
                              ph.photons_per_batch, sched, total_c)


def test_fused_i8_matches_fused_statistically():
    """The 7-bit grid against bf16 colors on the same photons, at the
    bounds of test_pallas_wide.test_wide_splat_i8_matches_fused_
    statistically."""
    scale = pw.splat_color_scale(DEFAULT_CONFIG.photon)
    i8 = _raw(_port_cfg(photons_per_batch=1024, splat="fused_i8"))
    fused = _raw(_port_cfg(photons_per_batch=1024))
    assert fused.sum() > 0
    err = (i8 - fused).abs()
    assert err.max().item() < 40 * scale
    assert err.mean().item() < scale
    np.testing.assert_allclose(i8.sum().item(), fused.sum().item(),
                               rtol=2e-3)


@pytest.mark.parametrize("device_rng,splat", [
    (True, "scatter"), (True, "fused"), (True, "fused_i8"),
    (False, "fused"),
    (True, "inkernel"), (False, "inkernel_i8"), (False, "inkernel"),
])
def test_tail_shrink_bit_identical(device_rng, splat, monkeypatch):
    """Each emitter's tail batch runs at whole stream blocks (8192 photons
    of a 16384 batch here): its stream is the first rows of the full
    batch's, the dropped rows are zeros, and the row keys of the 7-bit
    dither do not move, so the render equals the unshrunk one bit for bit.
    On the threefry route the shrunk batch draws only its first rows. The
    in-kernel routes shrink in blocks of 256 photons: their dither keys and
    f32 sums depend only on the photon index."""
    cfg = _port_cfg(photons_per_batch=16384, device_rng=device_rng,
                    splat=splat)
    ph = cfg.photon
    scene, _ = compile_scene(TINY, 30.0, cfg)
    em = pack_emitters(scene, ph.samples_per_area, ph.window_color,
                       ph.light_color, "cpu")
    sched = pw.emitter_schedule(em.counts, ph.photons_per_batch)
    inkernel = splat in pw.INKERNEL_MODES
    sizes = [b[3] for b in pw.schedule_batches(
        sched, 16384, True, pw.THREADS if inkernel else 8192)]
    # a tail batch is shrunk
    assert min(sizes) < 16384 if inkernel else 8192 in sizes
    fast = _raw(cfg)
    assert fast.sum() > 0
    monkeypatch.setattr(pw, "tail_batch_size", lambda n, batch, q: batch)
    assert torch.equal(fast, _raw(cfg))


@pytest.mark.parametrize("photon", [
    dict(splat="inkernel"),
    dict(splat="inkernel", device_rng=True),
    dict(splat="inkernel_i8", device_rng=False),
])
def test_library_refuses_what_stays_unported(photon, monkeypatch):
    """A scene that needs the general engine (pack_aa gives no table) now
    renders through the narrow kernel's route under each of these photon
    settings (the general route ignores --splat and --device-rng, as the
    JAX package's does), with a finite, non-zero arena; the fit of such a
    scene (the general differentiable renderer) is still refused."""
    cfg = _port_cfg(photons_per_batch=1024, **photon)
    scene, _ = compile_scene(TINY, 30.0, cfg)
    monkeypatch.setattr("flatmatch_tpu_torch.ops.aa_scene.pack_aa",
                        lambda walls, device="cpu": None)
    narrow = importlib.import_module(
        "flatmatch_tpu_torch.engines.photon_narrow")
    calls = []
    real = narrow.render_photons
    monkeypatch.setattr(narrow, "render_photons",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = run_engine(scene, cfg, device="cpu")
    assert calls == [1]
    assert np.isfinite(out).all() and out.sum() > 0
    pfit = importlib.import_module("flatmatch_tpu_torch.diff.fit")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ph = cfg.photon
        pfit.fit_materials(np.zeros((scene.num_texels, 3), f32),
                           pack_emitters(scene, 3000.0, ph.window_color,
                                         ph.light_color),
                           scene.num_texels, ph, aa=None)


@pytest.mark.parametrize("photon", [
    dict(splat="bucket", device_rng=True),
    dict(splat="scatter", device_rng=False),
    dict(splat="inkernel_i8", device_rng=False),
])
def test_diff_renderer_refuses_the_stream_tiers(photon):
    """The diff renderer runs the stream tiers and the threefry draws
    (tests/test_torch_diff_threefry.py); what it still refuses is a scene
    without an axis-aligned table, on every tier."""
    from flatmatch_tpu_torch.diff.fit import fit_materials

    cfg = dataclasses.replace(DEFAULT_CONFIG.photon, **photon)
    scene, _ = compile_scene(TINY, 30.0, DEFAULT_CONFIG)
    em = pack_emitters(scene, 3000.0, cfg.window_color, cfg.light_color)
    r = pdiff.make_diff_renderer_wide(em, scene.num_texels, cfg,
                                      pack_aa(scene.walls))
    assert r.stream == (cfg.splat in pdiff.STREAM_TIERS)
    assert not r.device_rng
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        fit_materials(np.zeros((scene.num_texels, 3), f32), em,
                      scene.num_texels, cfg, aa=None)


@pytest.mark.parametrize("argv", [
    ["render", TINY, "--splat", "inkernel", "--checkpoint", "ck.npz"],
    ["fit", TINY, "tiles", "--splat", "inkernel", "--no-device-rng",
     "--profile", "prof"],
    ["fit", TINY, "tiles", "--splat", "scatter", "--coordinator",
     "localhost:1234"],
])
def test_cli_refuses_what_stays_unported(argv, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main([*argv, "--device", "cpu", "--out", str(tmp_path / "o")])
    assert e.value.code == 2
    assert "ROADMAP.md" in capsys.readouterr().err
    assert not (tmp_path / "o").exists()


@pytest.mark.parametrize("flags", [
    ["--splat", "fused"],
    ["--no-device-rng", "--splat", "fused_i8"],
])
def test_cli_renders_the_stream_routes(flags, tmp_path):
    out = tmp_path / "out"
    assert cli.main(["render", TINY, "30", "--device", "cpu",
                     "--samples-per-area", "3000", "--photons-per-batch",
                     "1024", *flags, "--out", str(out)]) == 0
    scene, _ = compile_scene(TINY, 30.0, DEFAULT_CONFIG)
    assert len(list((out / "tiles").glob("tile_*.png"))) == len(scene.walls)
