"""The port's NumPy photon oracle (`--engine photon_oracle`) against the JAX
package's, and against the port's general engine.

engines/oracle.py is a copy of the JAX package's NumPy oracle, and
engines/photon_oracle_driver.py draws each batch with ops/threefry, which
is jax.random's threefry bit for bit. On the same draws and tables the two
oracles run the same NumPy operations in the same order: their batches and
renders must be equal (checked at rtol 1e-6, the float tolerance). The
port's oracle against its own photon_xla engine (engines/photon.py) on
`tiny` and on `tiny` turned 30 degrees: the bands of
tests/test_photon_parity.py (>= 99.9% of cells within rtol 1e-3, atol
1e-2; total within 1e-4), since the oracle's matmul dots and the engine's
broadcast sums round differently and a near-tie can route a photon to
another texel.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from chip_smoke import rotated_scene
from flatmatch_tpu.config import PhotonConfig as JaxPhotonConfig
from flatmatch_tpu.engines import oracle as joracle
from flatmatch_tpu.engines import photon_oracle_driver as jdriver
from flatmatch_tpu.ops.device_scene import (
    pack_emitters as jax_pack_em, pack_rects as jax_pack_rects,
)
from flatmatch_tpu.scene import geometry, image as im, layout
from flatmatch_tpu_torch import cli
from flatmatch_tpu_torch.config import DEFAULT_CONFIG, Engine, PhotonConfig
from flatmatch_tpu_torch.engines import oracle, photon, photon_oracle_driver
from flatmatch_tpu_torch.ops import threefry
from flatmatch_tpu_torch.ops.device_scene import pack_emitters, pack_rects
from flatmatch_tpu_torch.render import compile_scene, run_engine
from tests.conftest import FIXTURES

f32 = np.float32
TINY = str(FIXTURES / "tiny.png")
KW = dict(samples_per_area=3000.0, photons_per_batch=512, seed=7)
JCFG = JaxPhotonConfig(**KW)
CFG = PhotonConfig(**KW)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: the tensors are small, and the
    parallel test workers do not oversubscribe the cores they share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[0, 30], ids=lambda d: f"deg{d}")
def scene(request):
    img = im.load_layout(TINY)
    return rotated_scene(geometry.Scene(layout.parse_layout(
        img, f32(1.0) / f32(30.0), 200.0)), request.param)


def test_batch_equals_jax_oracle(scene):
    jrects = jax_pack_rects(scene.walls)
    jem = jax_pack_em(scene, CFG.samples_per_area, CFG.window_color,
                      CFG.light_color)
    prects = pack_rects(scene.walls)
    key = jax.random.fold_in(jax.random.PRNGKey(CFG.seed), 3)
    u = np.asarray(jax.random.uniform(key, (512, 28), dtype=np.float32))
    assert np.array_equal(
        threefry.batch_uniforms(CFG.seed, 3, 512, 28).numpy(), u)
    args = [np.asarray(getattr(jem, k)[0])
            for k in ("pos", "wvec", "hvec", "n", "color")]
    want = joracle.trace_batch_np(np.zeros((scene.num_texels, 3), f32),
                                  jrects, *args, bool(jem.is_window[0]), u,
                                  500, JCFG)
    got = oracle.trace_batch_np(np.zeros((scene.num_texels, 3), f32),
                                prects, *args, bool(jem.is_window[0]), u,
                                500, CFG)
    assert want.sum() > 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_render_equals_jax_oracle(scene):
    want = jdriver.render_photons_np(scene, JCFG)
    got = photon_oracle_driver.render_photons_np(scene, CFG, "cpu")
    assert got.dtype == np.float32 and want.sum() > 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_oracle_matches_photon_xla(scene):
    rects = pack_rects(scene.walls)
    em = pack_emitters(scene, CFG.samples_per_area, CFG.window_color,
                       CFG.light_color)
    xla = photon.render_photons(rects, em, scene.num_texels, CFG).numpy()
    ora = photon_oracle_driver.render_photons_np(scene, CFG, "cpu")
    assert xla.sum() > 0
    close = np.isclose(ora, xla, rtol=1e-3, atol=1e-2)
    assert close.mean() > 0.999, f"only {close.mean():.4%} texels match"
    np.testing.assert_allclose(ora.sum(), xla.sum(), rtol=1e-4)


def test_run_engine_scales_the_oracle_by_the_exposure():
    cfg = DEFAULT_CONFIG.replace(engine=Engine.PHOTON_ORACLE,
                                 photon=dataclasses.replace(
                                     DEFAULT_CONFIG.photon, **KW))
    pscene, _ = compile_scene(TINY, 30.0, cfg)
    got = run_engine(pscene, cfg, device="cpu")
    from flatmatch_tpu_torch.ops.device_scene import exposure_scale

    raw = photon_oracle_driver.render_photons_np(pscene, cfg.photon, "cpu")
    scale = exposure_scale(pscene, cfg.photon.samples_per_area,
                           cfg.photon.exposure)
    assert np.array_equal(got, raw * scale[:, None])


def test_cli_renders_photon_oracle(tmp_path):
    out = tmp_path / "o"
    assert cli.main(["render", TINY, "30", "--device", "cpu", "--engine",
                     "photon_oracle", "--samples-per-area", "3000",
                     "--photons-per-batch", "512", "--seed", "7",
                     "--out", str(out)]) == 0
    assert len(list((out / "tiles").glob("tile_*.png"))) == 13
