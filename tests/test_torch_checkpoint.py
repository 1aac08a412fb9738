"""The port's checkpoint and resume against its straight render and the
JAX package's schedule.

On `tiny` (2,174 photons at 7,500 per m^2: four full 512-photon batches and
a tail of 126, which the in-kernel tiers shrink to 256 photons) every
photon route of the port renders once straight and once checkpointed every
2 batches: the wide engine's in-kernel 7-bit tier (counter hash) and its
`fused` stream tier (threefry uniforms), the narrow kernel's plain version
(tiny turned 30 degrees, chip_smoke.rotated_scene) and the general engine
(`photon_xla`). A render killed in a subprocess by
FLATMATCH_FAULT_EXIT_AFTER_CHECKPOINTS and resumed through the CLI is held
against the straight CLI render's .raw dumps on the in-kernel and the
stream tier. All of these must be equal bit for bit: the port adds each
batch into the lightmap in the same order with exact sums however the
schedule is cut.

Against the JAX package: the cursor and the (photons done, photons total)
sequence of `on_segment`, straight and resumed, equal those of JAX's
`run_schedule` driven with a stub trace on tiny's and mini's emitter
counts; the fingerprint payload is JAX's, so without the "torch" that the
port adds the fingerprints are equal, and with it each package refuses
the other's checkpoint with ValueError.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from chip_smoke import rotated_scene
from flatmatch_tpu.config import (
    DEFAULT_CONFIG as JAX_DEFAULT, PhotonConfig as JPhotonConfig,
)
from flatmatch_tpu.engines import schedule as jschedule
from flatmatch_tpu.ops.device_scene import pack_emitters as j_pack_em
from flatmatch_tpu.render import compile_scene as j_compile
from flatmatch_tpu.utils import checkpoint as jckpt
from flatmatch_tpu_torch import cli
from flatmatch_tpu_torch.config import DEFAULT_CONFIG, Engine, PhotonConfig
from flatmatch_tpu_torch.engines import photon_wide as pw
from flatmatch_tpu_torch.engines import schedule
from flatmatch_tpu_torch.ops.aa_scene import pack_aa
from flatmatch_tpu_torch.ops.device_scene import pack_emitters
from flatmatch_tpu_torch.render import compile_scene, run_engine
from flatmatch_tpu_torch.utils import checkpoint as ckpt
from tests.conftest import FIXTURES

ROOT = FIXTURES.parent.parent
TINY = str(FIXTURES / "tiny.png")
MINI = str(FIXTURES / "mini.png")
SPA, B, EVERY = 7500.0, 512, 2
ROUTES = {
    "inkernel_i8": dict(engine=Engine.PHOTON_PALLAS,
                        photon=dict(device_rng=True, splat="inkernel_i8")),
    "fused": dict(engine=Engine.PHOTON_PALLAS,
                  photon=dict(device_rng=False, splat="fused")),
    "narrow": dict(engine=Engine.PHOTON_PALLAS, rotate=True,
                   photon=dict(device_rng=True, splat="inkernel_i8")),
    "general": dict(engine=Engine.PHOTON_XLA, photon={}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: the plain versions' tensors are
    small, so one thread is about as fast alone, and the parallel test
    workers do not oversubscribe the cores they share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(route):
    r = ROUTES[route]
    return DEFAULT_CONFIG.replace(
        engine=r["engine"], photon=dataclasses.replace(
            DEFAULT_CONFIG.photon, samples_per_area=SPA, photons_per_batch=B,
            checkpoint_every=EVERY, **r["photon"]))


def _scene(route):
    scene, _ = compile_scene(TINY, 30.0, DEFAULT_CONFIG)
    return rotated_scene(scene, 30.0) if ROUTES[route].get("rotate") \
        else scene


@pytest.mark.parametrize("route", list(ROUTES))
def test_checkpointed_render_equals_straight(route, tmp_path):
    cfg, scene = _cfg(route), _scene(route)
    straight = run_engine(scene, cfg, "cpu")
    assert straight.sum() > 0
    path = tmp_path / "ck.npz"
    seen = []
    got = run_engine(scene, cfg, "cpu", checkpoint_path=str(path),
                     on_segment=lambda lm, done, total: seen.append(done))
    np.testing.assert_array_equal(got, straight)
    # segments of 2, 2 and 1 batches (the turned scene's area rounds to one
    # photon more); the cursor past the last emitter
    n = int(pack_emitters(scene, SPA, cfg.photon.window_color,
                          cfg.photon.light_color).counts.sum())
    assert n in (2174, 2175) and seen == [1024, 2048, n]
    with np.load(path) as z:
        assert (int(z["emitter_index"]), int(z["batch_index"])) == (1, 0)


def _cli_args(out, flags):
    return ["render", TINY, "30", "--device", "cpu", "--samples-per-area",
            str(SPA), "--photons-per-batch", str(B), "--checkpoint-every",
            str(EVERY), "--dump-raw", "--out", str(out), *flags]


@pytest.mark.parametrize("flags", [[], ["--splat", "fused"]],
                         ids=["inkernel_i8", "fused"])
def test_killed_render_resumes_to_the_straight_bits(flags, tmp_path):
    ck = str(tmp_path / "ck.npz")
    killed = subprocess.Popen(
        [sys.executable, "-m", "flatmatch_tpu_torch.cli",
         *_cli_args(tmp_path / "resumed", [*flags, "--checkpoint", ck])],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        env={**os.environ, "FLATMATCH_FAULT_EXIT_AFTER_CHECKPOINTS": "1",
             "PYTHONPATH": str(ROOT)})
    try:
        assert cli.main(_cli_args(tmp_path / "straight", flags)) == 0
        err = killed.communicate(timeout=120)[1].decode()
    finally:
        killed.kill()
    assert killed.returncode == 17, err
    assert "FAULT INJECTION" in err
    with np.load(ck) as z:
        assert (int(z["emitter_index"]), int(z["batch_index"])) == (0, 2)
    assert cli.main(_cli_args(tmp_path / "resumed",
                              [*flags, "--checkpoint", ck])) == 0
    raws = sorted((tmp_path / "straight" / "tiles").glob("tile_*.raw"))
    assert len(raws) == 13
    for p in raws:
        assert (tmp_path / "resumed" / "tiles" / p.name).read_bytes() \
            == p.read_bytes(), p.name


def _tiny_wide(cfg):
    """The wide engine's inputs on tiny: emitters, arena size, table, and
    the compact arena's size (what its checkpoint holds)."""
    scene = _scene("inkernel_i8")
    em = pack_emitters(scene, cfg.samples_per_area, cfg.window_color,
                       cfg.light_color, "cpu")
    aa = pack_aa(scene.walls, "cpu")
    return em, scene.num_texels, aa, pw.compact_aa(aa, scene.num_texels)[1]


def test_fingerprint_mismatch_refuses_and_schema_change_restarts(tmp_path):
    cfg = _cfg("inkernel_i8").photon
    em, T, aa, _ = _tiny_wide(cfg)
    path = str(tmp_path / "ck.npz")
    straight = pw.render_photons(em, T, cfg, aa, checkpoint_path=path)
    other = dataclasses.replace(cfg, seed=cfg.seed + 1)
    with pytest.raises(ValueError, match="written for config"):
        pw.render_photons(em, T, other, aa, checkpoint_path=path)
    resegmented = dataclasses.replace(cfg, checkpoint_every=EVERY + 1)
    with pytest.raises(ValueError, match="written for config"):
        pw.render_photons(em, T, resegmented, aa, checkpoint_path=path)
    # a checkpoint of another schema version: a warning, and the render
    # starts again from batch 0
    with np.load(path) as z:
        data = dict(z)
    data["fp_version"] = np.int64(ckpt.FINGERPRINT_VERSION - 1)
    data["lightmap"] = np.full_like(data["lightmap"], 7.0)
    np.savez_compressed(path, **data)
    assert ckpt.load(path, "0" * 16) is None
    torch.testing.assert_close(
        pw.render_photons(em, T, cfg, aa, checkpoint_path=path), straight,
        rtol=0, atol=0)


def test_each_package_refuses_the_others_checkpoint(tmp_path):
    cfg = _cfg("inkernel_i8").photon
    jcfg = JPhotonConfig(**dataclasses.asdict(cfg))
    em, T, aa, total_c = _tiny_wide(cfg)
    jscene, _ = j_compile(TINY, 30.0, JAX_DEFAULT)
    jem = j_pack_em(jscene, SPA, jcfg.window_color, jcfg.light_color)
    np.testing.assert_array_equal(np.asarray(jem.counts), em.counts)
    extra = ("wide", "compact", B, EVERY)
    jfp = jckpt.config_fingerprint(jcfg, total_c, em.counts, extra)
    # the same payload: only the port's "torch" tells the two apart
    assert ckpt.config_fingerprint(cfg, total_c, em.counts, extra) == jfp
    # JAX's wide-engine schedule writes its checkpoint (a stub trace)
    jpath = str(tmp_path / "jax.npz")
    jschedule.run_schedule(lambda lm, *a: lm + 1.0, jem, total_c, jcfg, B,
                           checkpoint_path=jpath, every_batches=EVERY,
                           fingerprint_extra=("wide", "compact"))
    with pytest.raises(ValueError, match="written for config"):
        pw.render_photons(em, T, cfg, aa, checkpoint_path=jpath)
    ppath = str(tmp_path / "torch.npz")
    pw.render_photons(em, T, cfg, aa, checkpoint_path=ppath)
    with pytest.raises(ValueError, match="written for config"):
        jckpt.load(ppath, jfp)


def _segments_jax(png, cfg, cursor, path):
    jscene, _ = j_compile(png, 30.0, JAX_DEFAULT)
    jem = j_pack_em(jscene, cfg.samples_per_area, cfg.window_color,
                    cfg.light_color)
    extra = (cfg.photons_per_batch, EVERY)
    if cursor is not None:
        fp = jckpt.config_fingerprint(cfg, 5, np.asarray(jem.counts), extra)
        jckpt.save(path, np.zeros((5, 3), np.float32), *cursor, fp)
    batches, seen = [], []

    def trace_seg(lm, em, base, off, seg, n_batches, last_valid):
        batches.extend(int(base) + int(off) + i for i in range(int(seg)))
        return lm

    jschedule.run_schedule(
        trace_seg, jem, 5, cfg, cfg.photons_per_batch,
        checkpoint_path=None if cursor is None else path,
        every_batches=EVERY,
        on_segment=lambda lm, done, total: seen.append((done, total)))
    return batches, seen


def _segments_torch(png, cfg, cursor, path):
    scene, _ = compile_scene(png, 30.0, DEFAULT_CONFIG)
    em = pack_emitters(scene, cfg.samples_per_area, cfg.window_color,
                       cfg.light_color, "cpu")
    if cursor is not None:
        fp = ckpt.config_fingerprint(cfg, 5, em.counts,
                                     ("torch", cfg.photons_per_batch, EVERY))
        ckpt.save(path, np.zeros((5, 3), np.float32), *cursor, fp)
    batches, seen = [], []
    schedule.run_schedule(
        lambda lm, e, gb, n_valid, bsz: batches.append(gb), em, 5, cfg,
        checkpoint_path=None if cursor is None else path,
        on_segment=lambda lm, done, total: seen.append((done, total)))
    return batches, seen


@pytest.mark.parametrize("png,spa,cursor", [
    (TINY, 3000.0, None), (TINY, 7500.0, (0, 2)), (MINI, 3000.0, None),
    (MINI, 3000.0, (0, 1)), (MINI, 3000.0, (1, 0)),
], ids=["tiny", "tiny-resumed", "mini", "mini-resumed-0-1",
        "mini-resumed-1-0"])
def test_segments_follow_the_jax_schedule(png, spa, cursor, tmp_path):
    """The global batches traced and the on_segment counts, straight and
    resumed from a cursor, are the JAX schedule's."""
    cfg = PhotonConfig(samples_per_area=spa, photons_per_batch=256,
                       checkpoint_every=EVERY)
    jcfg = JPhotonConfig(**dataclasses.asdict(cfg))
    want = _segments_jax(png, jcfg, cursor, str(tmp_path / "j.npz"))
    got = _segments_torch(png, cfg, cursor, str(tmp_path / "t.npz"))
    assert got == want
    assert want[1] and want[1][-1][0] == want[1][-1][1]
