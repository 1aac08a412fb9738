"""The port's default render as a whole against the JAX package.

On `tiny` (samples per area 3000, 1024-photon batches, device RNG, in-kernel
7-bit splat) the port's run_engine(device="cpu") — the plain version of the
kernel under the real schedule, de-scale, compaction and exposure — is
compared with the JAX package's wide engine in Pallas interpret mode times
exposure_scale. Tolerance: total energy within 1e-3 and >= 99% of texels
within rtol 1e-5; the draws and integer sums are exact, and only a
last-ulp sin/cos/rsqrt difference between XLA and torch can split a path.
The CLI is checked for its artifacts and for refusing what the port does
not run, the multi-host flags (tests/test_torch_stream.py checks the
stream tiers it runs, tests/test_torch_inkernel.py the other in-kernel
routes, tests/test_torch_oracle.py the NumPy oracle engine).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from flatmatch_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT
from flatmatch_tpu.engines import photon_pallas_wide as jw
from flatmatch_tpu.ops.aa_scene import pack_aa as jax_pack_aa
from flatmatch_tpu.ops.device_scene import (
    exposure_scale as jax_exposure, pack_emitters as jax_pack_em,
    pack_rects as jax_pack_rects,
)
from flatmatch_tpu.scene import geometry as j_geo, image as j_im
from flatmatch_tpu.scene import layout as j_lay
from flatmatch_tpu_torch import cli
from flatmatch_tpu_torch.render import compile_scene, render, run_engine
from flatmatch_tpu_torch.config import DEFAULT_CONFIG, Engine
from flatmatch_tpu_torch.engines import photon_wide as pw
from tests.conftest import FIXTURES

f32 = np.float32
SPA = 3000.0
TINY = str(FIXTURES / "tiny.png")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: the plain versions' tensors are
    small, so one thread is about as fast alone, and the parallel test
    workers do not oversubscribe the cores they share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(cfg):
    return cfg.replace(photon=dataclasses.replace(
        cfg.photon, samples_per_area=SPA, photons_per_batch=1024,
        device_rng=True, splat="inkernel_i8"))


@pytest.fixture(scope="module")
def jax_texels():
    cfg = _cfg(JAX_DEFAULT).photon
    img = j_im.load_layout(TINY)
    scene = j_geo.Scene(j_lay.parse_layout(img, f32(1) / f32(30), 200.0))
    em = jax_pack_em(scene, SPA, cfg.window_color, cfg.light_color)
    with pltpu.force_tpu_interpret_mode():
        lm = jw.render_photons(jax_pack_rects(scene.walls), em,
                               scene.num_texels, cfg,
                               jax_pack_aa(scene.walls), sublanes=8)
    return np.asarray(lm) * jax_exposure(scene, SPA, cfg.exposure)[:, None]


def test_run_engine_matches_jax(jax_texels):
    cfg = _cfg(DEFAULT_CONFIG)
    scene, _ = compile_scene(TINY, 30.0, cfg)
    before = pw.trace_splat_wide_rng_i8.launches
    got = run_engine(scene, cfg, device="cpu")
    assert pw.trace_splat_wide_rng_i8.launches == before  # plain version
    assert got.dtype == np.float32 and got.shape == jax_texels.shape
    assert np.isfinite(got).all() and got.sum() > 0
    np.testing.assert_allclose(got.sum(), jax_texels.sum(), rtol=1e-3)
    assert np.isclose(got, jax_texels, rtol=1e-5, atol=0).mean() >= 0.99
    # deterministic: a second run is bit-identical
    np.testing.assert_array_equal(run_engine(scene, cfg, "cpu"), got)


def test_cli_writes_tiles_and_identical_artifacts(tmp_path):
    out = tmp_path / "out"
    rc = cli.main(["render", TINY, "30", "--device", "cpu",
                   "--samples-per-area", str(SPA), "--dump-raw",
                   "--out", str(out)])
    assert rc == 0
    for art in ("geometry", "collisionMap"):
        assert ((out / f"{art}.json").read_bytes()
                == (FIXTURES / f"tiny_{art}.json").read_bytes())
    scene, _ = compile_scene(TINY, 30.0, DEFAULT_CONFIG)
    n = len(scene.walls)
    assert len(list((out / "tiles").glob("tile_*.png"))) == n
    assert len(list((out / "tiles").glob("tile_*.raw"))) == n


def test_supersample_render(tmp_path):
    res = render(TINY, str(tmp_path), 30.0, _cfg(DEFAULT_CONFIG),
                 device="cpu", supersample=2)
    assert res.texels.shape == (res.scene.num_texels, 3)
    assert np.isfinite(res.texels).all() and res.texels.sum() > 0
    assert len(res.tile_paths) == len(res.scene.walls)


@pytest.mark.parametrize("flags", [
    ["--engine", "photon_oracle"],
    ["--process-id", "0"],
    ["--coordinator", "localhost:1234"],
    ["--num-processes", "2"],
])
def test_cli_refuses_what_the_slice_does_not_run(flags, tmp_path, capsys):
    """The multi-host flags stay refused, naming ROADMAP.md, before any
    artifact is written; `--engine photon_oracle`, once refused, renders
    (the NumPy oracle on the general engine's draws,
    tests/test_torch_oracle.py) and writes its tiles."""
    argv = ["render", TINY, "30", "--device", "cpu", "--out", str(tmp_path),
            *flags]
    if "photon_oracle" in flags:
        assert cli.main([*argv, "--samples-per-area", str(SPA),
                         "--photons-per-batch", "1024"]) == 0
        assert len(list((tmp_path / "tiles").glob("tile_*.png"))) == 13
        assert "ROADMAP.md" not in capsys.readouterr().err
        return
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 2
    assert "ROADMAP.md" in capsys.readouterr().err
    assert not (tmp_path / "geometry.json").exists()


def _tile_bytes(out):
    return [p.read_bytes()
            for p in sorted((out / "tiles").glob("tile_*.png"))]


@pytest.mark.parametrize("flags", [
    ["--engine", "photon_xla", "--checkpoint", "ck.npz"],
    ["--profile", "prof"],
    ["--splat", "inkernel", "--no-device-rng", "--checkpoint", "ck.npz"],
    ["--no-device-rng", "--splat", "inkernel_i8", "--preview"],
    ["--checkpoint", "ck.npz"],
    ["--preview"],
])
def test_cli_runs_what_the_slice_runs(flags, tmp_path, capsys):
    """The flags the port once refused run on tiny (869 photons in four
    batches of 256, one a segment), and each writes what it promises: the
    tiles of the same render without it; a checkpoint whose cursor is past
    the last emitter, from which a rerun writes the same tiles; a profiler
    trace of the torch operations; and a preview after each segment, the
    last of which covers every photon."""
    ck, prof = tmp_path / "ck.npz", tmp_path / "prof"
    flags = [{"ck.npz": str(ck), "prof": str(prof)}.get(f, f) for f in flags]
    base = ["render", TINY, "30", "--device", "cpu", "--samples-per-area",
            str(SPA), "--photons-per-batch", "256", "--checkpoint-every",
            "1"]
    plain, it = [], iter(flags)
    for f in it:
        if f in ("--checkpoint", "--profile"):
            next(it)
        elif f != "--preview":
            plain.append(f)
    assert cli.main([*base, "--out", str(tmp_path / "plain"), *plain]) == 0
    want = _tile_bytes(tmp_path / "plain")
    assert len(want) == 13
    capsys.readouterr()
    assert cli.main([*base, "--out", str(tmp_path / "out"), *flags]) == 0
    assert _tile_bytes(tmp_path / "out") == want
    previews = [ln for ln in capsys.readouterr().out.splitlines()
                if "preview tiles at" in ln]
    if "--preview" in flags:
        assert len(previews) == 4 and previews[-1].endswith("869/869 photons")
    else:
        assert not previews
    assert ck.exists() == ("--checkpoint" in flags)
    if ck.exists():
        with np.load(ck) as z:
            assert (int(z["emitter_index"]), int(z["batch_index"])) == (1, 0)
            assert np.isfinite(z["lightmap"]).all() and z["lightmap"].sum() > 0
        assert cli.main([*base, "--out", str(tmp_path / "again"),
                         *flags]) == 0
        assert _tile_bytes(tmp_path / "again") == want
    assert prof.exists() == ("--profile" in flags)
    if prof.exists():
        trace = json.loads((prof / "flatmatch_torch.pt.trace.json")
                           .read_text())
        assert any(str(e.get("name")).startswith("aten::")
                   for e in trace["traceEvents"])


@pytest.mark.parametrize("kw,warning", [
    (dict(supersample=2), "--preview is unsupported with --supersample"),
    (dict(engine=Engine.AMBIENT_OCCLUSION),
     "--preview applies to the photon engines only"),
], ids=["supersample", "ambient_occlusion"])
def test_preview_is_ignored_where_it_cannot_run(kw, warning, tmp_path,
                                                capsys):
    """As in the JAX package: `preview` warns and writes no preview under
    `supersample` and for an engine that has no segments."""
    cfg = _cfg(DEFAULT_CONFIG).replace(
        engine=kw.get("engine", Engine.PHOTON_PALLAS))
    res = render(TINY, str(tmp_path), 30.0, cfg, device="cpu", preview=True,
                 supersample=kw.get("supersample", 1))
    assert len(res.tile_paths) == 13
    out = capsys.readouterr()
    assert warning in out.err and "preview tiles at" not in out.out


@pytest.mark.parametrize("change", [
    dict(engine=Engine.PHOTON_ORACLE),
    dict(engine=Engine.PHOTON_ORACLE, photon=dict(device_rng=False)),
    dict(engine=Engine.PHOTON_ORACLE, photon=dict(splat="inkernel")),
    dict(engine=Engine.RADIOSITY, no_table=True),
])
def test_library_refuses_what_the_slice_does_not_run(change, monkeypatch):
    """What the slice once refused now runs through run_engine: the NumPy
    oracle engine, whatever the photon route (it ignores --splat and
    --device-rng, as the JAX package's does: the same arena each time), and
    radiosity of a scene without an axis-aligned table, through the general
    form factors (tests/test_torch_radiosity_general.py holds both against
    the JAX package)."""
    from flatmatch_tpu_torch.engines import photon_oracle_driver, radiosity
    from flatmatch_tpu_torch.ops.device_scene import (
        exposure_scale as p_exposure,
    )

    cfg = _cfg(DEFAULT_CONFIG).replace(engine=change["engine"])
    cfg = cfg.replace(photon=dataclasses.replace(cfg.photon,
                                                 **change.get("photon", {})),
                      radiosity=dataclasses.replace(cfg.radiosity,
                                                    rays_per_texel=64))
    scene, _ = compile_scene(TINY, 30.0, cfg)
    if change.get("no_table"):
        monkeypatch.setattr(
            "flatmatch_tpu_torch.engines.radiosity.pack_aa",
            lambda rects, device="cpu": None)
        calls = []
        real = radiosity.form_factor_chunk
        monkeypatch.setattr(radiosity, "form_factor_chunk",
                            lambda *a: calls.append(1) or real(*a))
    out = run_engine(scene, cfg, device="cpu")
    assert out.shape == (scene.num_texels, 3)
    assert np.isfinite(out).all() and out.sum() > 0
    if change.get("no_table"):
        assert calls        # the general form factors ran
        return
    raw = photon_oracle_driver.render_photons_np(
        scene, dataclasses.replace(cfg.photon, splat="inkernel_i8",
                                   device_rng=True), "cpu")
    scale = p_exposure(scene, SPA, cfg.photon.exposure)
    assert np.array_equal(out, raw * scale[:, None])
