"""The port's default render as a whole against the JAX package.

On `tiny` (samples per area 3000, 1024-photon batches, device RNG, in-kernel
7-bit splat) the port's run_engine(device="cpu") — the plain version of the
kernel under the real schedule, de-scale, compaction and exposure — is
compared with the JAX package's wide engine in Pallas interpret mode times
exposure_scale. Tolerance: total energy within 1e-3 and >= 99% of texels
within rtol 1e-5; the draws and integer sums are exact, and only a
last-ulp sin/cos/rsqrt difference between XLA and torch can split a path.
The CLI is checked for its artifacts and for refusing what the port does
not run (tests/test_torch_stream.py checks the stream tiers it runs,
tests/test_torch_inkernel.py the other in-kernel routes).
"""
import dataclasses

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
    ["--engine", "photon_xla", "--checkpoint", "ck.npz"],
    ["--engine", "photon_oracle"],
    ["--profile", "prof"],
    ["--process-id", "0"],
    ["--splat", "inkernel", "--no-device-rng", "--checkpoint", "ck.npz"],
    ["--no-device-rng", "--splat", "inkernel_i8", "--preview"],
    ["--checkpoint", "ck.npz"],
    ["--preview"],
    ["--coordinator", "localhost:1234"],
    ["--num-processes", "2"],
])
def test_cli_refuses_what_the_slice_does_not_run(flags, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["render", TINY, "30", "--device", "cpu",
                  "--out", str(tmp_path), *flags])
    assert e.value.code == 2
    assert "ROADMAP.md" in capsys.readouterr().err
    assert not (tmp_path / "geometry.json").exists()


@pytest.mark.parametrize("change", [
    dict(engine=Engine.PHOTON_ORACLE),
    dict(engine=Engine.PHOTON_ORACLE, photon=dict(device_rng=False)),
    dict(engine=Engine.PHOTON_ORACLE, photon=dict(splat="inkernel")),
    dict(engine=Engine.RADIOSITY, no_table=True),
])
def test_library_refuses_what_the_slice_does_not_run(change, monkeypatch):
    """The NumPy oracle engine stays unported, whatever the photon route,
    and so does radiosity of a scene without an axis-aligned table (the
    general form factors); the general photon engines run
    (tests/test_torch_general.py)."""
    cfg = _cfg(DEFAULT_CONFIG).replace(engine=change["engine"])
    cfg = cfg.replace(photon=dataclasses.replace(cfg.photon,
                                                 **change.get("photon", {})))
    scene, _ = compile_scene(TINY, 30.0, cfg)
    if change.get("no_table"):
        monkeypatch.setattr(
            "flatmatch_tpu_torch.engines.radiosity.pack_aa",
            lambda rects, device="cpu": None)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        run_engine(scene, cfg, device="cpu")
