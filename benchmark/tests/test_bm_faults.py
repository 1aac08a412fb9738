"""A run of each cell on CPU shards, at a budget a test can hold, sound and
with the timed path broken underneath: `correct` has to come out true for
the sound run and false for each fault the cell can have."""
from __future__ import annotations

import numpy as np
import pytest

from .conftest import cpu_run, small_config

PHOTON = ("example_photon.render", 20000.0, 1200000)
RADIOSITY = ("example_radiosity.render", 64, 256)


def _unchanged(real):
    def engine(scene, cfg, device, **kw):
        return np.zeros_like(real(scene, cfg, device, **kw))
    return engine


def _half(real):
    """Half the photons or rays left out, the mean taken over the rest."""
    import dataclasses

    def engine(scene, cfg, device, **kw):
        if cfg.engine.value == "radiosity":
            sub = dataclasses.replace(
                cfg.radiosity, rays_per_texel=cfg.radiosity.rays_per_texel // 2)
            return real(scene, cfg.replace(radiosity=sub), device, **kw)
        sub = dataclasses.replace(
            cfg.photon, samples_per_area=cfg.photon.samples_per_area / 2)
        return real(scene, cfg.replace(photon=sub), device, **kw)
    return engine


def _altered_arena(real):
    """The brightest wall's texels altered (x1.5) where the engine
    returns them."""
    def engine(scene, cfg, device, **kw):
        out = real(scene, cfg, device, **kw).copy()
        spans = [slice(r.base, r.base + r.wtiles * r.htiles)
                 for r in scene.walls]
        sl = max(spans, key=lambda s: float(out[s].sum()))
        out[sl] *= 1.5
        return out
    return engine


@pytest.fixture
def patch_engine(monkeypatch):
    import importlib

    render = importlib.import_module("flatmatch_tpu_torch.render")

    def apply(make):
        monkeypatch.setattr(render, "run_engine", make(render.run_engine))
    return apply


@pytest.mark.parametrize("cell", [PHOTON, RADIOSITY], ids=["photon", "radiosity"])
@pytest.mark.parametrize("fault", [None, _unchanged, _half, _altered_arena],
                         ids=["sound", "unchanged", "half", "altered_arena"])
def test_engine_faults(capsys, patch_engine, cell, fault):
    workload, samples, reference = cell
    config = small_config(workload.split(".")[0], samples, reference)
    if fault is not None:
        patch_engine(fault)
    res = cpu_run(capsys, workload, config)
    assert res["correct"] is (fault is None), res["checks"]


def test_altered_tile(capsys, monkeypatch):
    """An answer altered where the export produces it: one written tile's
    first pixel is changed."""
    import flatmatch_tpu_torch.io.tiles as tiles

    real = tiles.save_tiles

    def save(walls, texels, out_dir, *a, **kw):
        paths = real(walls, texels, out_dir, *a, **kw)
        from PIL import Image

        with Image.open(paths[3]) as im:
            px = np.asarray(im.convert("RGB")).copy()
        px[0, 0] = (px[0, 0].astype(int) + 40) % 256
        Image.fromarray(px, "RGB").save(paths[3])
        return paths

    monkeypatch.setattr(tiles, "save_tiles", save)
    res = cpu_run(capsys, PHOTON[0], small_config("example_photon", *PHOTON[1:]))
    assert res["correct"] is False
    assert res["checks"]["tiles_gap"]["value"] > 0


def test_altered_geometry(capsys, monkeypatch):
    """The scene layer's answer altered: geometry.json loses a digit."""
    import flatmatch_tpu_torch.scene.geometry as geometry

    real = geometry.geometry_json
    monkeypatch.setattr(geometry, "geometry_json",
                        lambda scene: real(scene).replace("9", "8", 1))
    res = cpu_run(capsys, PHOTON[0], small_config("example_photon", *PHOTON[1:]))
    assert res["correct"] is False
    assert res["checks"]["geometry_bytes"]["value"] == 1


@pytest.mark.parametrize("broken", [False, True], ids=["sound", "no_exchange"])
def test_exchange_between_chips(capsys, monkeypatch, broken):
    """The four-card render (traffic/render_4chip.json, a cell left for a
    later benchmark change) on four CPU shards; with the exchange between
    the shards left out (the combine keeps the first shard's partial)."""
    from flatmatch_tpu_torch.parallel import mesh

    if broken:
        monkeypatch.setattr(mesh.PhotonMesh, "combine",
                            lambda self, parts: parts[0])
    cell = dict(name="example_photon.render_4chip", config="example_photon",
                traffic="render_4chip", chips=4, why="four shards")
    res = cpu_run(capsys, cell["name"],
                  small_config("example_photon", *PHOTON[1:]), chips=4,
                  cell=cell)
    assert res["correct"] is (not broken), res["checks"]
