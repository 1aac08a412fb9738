"""The program's spans (flatmatch_tpu_torch/utils/spans.py) on the CPU.

With no profiler recording, `span` is one shared no-op context and a render
records nothing. Under torch.profiler a photon and a radiosity render of
mini, each followed by its export, give a `user_annotation` event for
every step they reach, nested as the steps are, with one tone map and one
PNG encode a wall; the arena's bits and the tiles' bytes do not depend on
whether the profiler records; a sharded render reaches `mesh.combine`
and a checkpointed one `photon.checkpoint`.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flatmatch_tpu_torch.config import DEFAULT_CONFIG, Engine
from flatmatch_tpu_torch.io import tiles
from flatmatch_tpu_torch.parallel import mesh as pm
from flatmatch_tpu_torch.render import compile_scene, run_engine
from flatmatch_tpu_torch.scene.geometry import geometry_json
from flatmatch_tpu_torch.utils import spans
from tests.conftest import FIXTURES

MINI = str(FIXTURES / "mini.png")
# the CLI's photon route (the counter hash, the in-kernel 7-bit splat) at a
# CPU budget, and radiosity at a few rays a texel
PHOTON = DEFAULT_CONFIG.replace(photon=dataclasses.replace(
    DEFAULT_CONFIG.photon, samples_per_area=3000.0, photons_per_batch=1024,
    splat="inkernel_i8", device_rng=True, seed=7))
RADIOSITY = DEFAULT_CONFIG.replace(
    engine=Engine.RADIOSITY, radiosity=dataclasses.replace(
        DEFAULT_CONFIG.radiosity, rays_per_texel=16, seed=7))
CONFIGS = {"photon": PHOTON, "radiosity": RADIOSITY}
EXPORT = {"export.geometry", "export.tiles", "export.tonemap",
          "export.encode"}
NAMES = {
    "photon": {"scene.build", "engine.run", "engine.tables",
               "photon.schedule", "engine.readback"} | EXPORT,
    "radiosity": {"scene.build", "engine.run", "engine.tables",
                  "radiosity.form_factors", "radiosity.mipmap_plan",
                  "radiosity.relax", "radiosity.mipmap_apply",
                  "engine.readback"} | EXPORT,
}
_cache = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _render(cfg, out, mesh=None, checkpoint_path=None):
    """One render of mini as `render` does it past the collision map: the
    arena and the bytes of geometry.json and of every tile."""
    scene, _ = compile_scene(MINI, 30.0, cfg)
    texels = run_engine(scene, cfg, "cpu", checkpoint_path, mesh=mesh)
    geo = geometry_json(scene)
    paths = tiles.save_tiles(scene.walls, texels, str(out), False)
    return texels, geo, [p.read_bytes() for p in paths], len(scene.walls)


def _traced(tmp, fn):
    """(fn()'s result, the trace's user_annotation events) of fn() under
    torch.profiler on the CPU."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = fn()
    path = tmp / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return res, events


def _engine(kind, tmp_path_factory):
    """(untraced render, traced render, its events) of engine `kind`."""
    if kind not in _cache:
        tmp = tmp_path_factory.mktemp(kind)
        cfg = CONFIGS[kind]
        plain = _render(cfg, tmp / "off")
        traced, events = _traced(tmp, lambda: _render(cfg, tmp / "on"))
        _cache[kind] = plain, traced, events
    return _cache[kind]


def _named(events, name):
    return [e for e in events if e["name"] == name]


def _inside(inner, outer) -> bool:
    """Whether event `inner` lies within event `outer` (µs, to the trace's
    rounding)."""
    return (float(outer["ts"]) - 1e-3 <= float(inner["ts"])
            and float(inner["ts"]) + float(inner["dur"])
            <= float(outer["ts"]) + float(outer["dur"]) + 1e-3)


def test_span_off_is_one_shared_noop():
    assert not torch._C._autograd._profiler_enabled()
    first = spans.span("engine.run")
    assert spans.span("export.encode") is first
    with first:
        with spans.span("engine.tables") as inner:
            assert inner is None


def test_untraced_render_records_nothing(monkeypatch, tmp_path):
    """With no profiler recording, a render and its export never make a
    record_function."""
    made = []

    def record(name):
        made.append(name)
        raise AssertionError(f"span {name} recorded with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", record)
    _render(PHOTON, tmp_path)
    assert made == []


def test_traced_span_is_record_function():
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(spans.span("engine.run"),
                          torch.profiler.record_function)


@pytest.mark.parametrize("kind", ["photon", "radiosity"])
def test_render_spans_by_name(kind, tmp_path_factory):
    _, (_, _, _, walls), events = _engine(kind, tmp_path_factory)
    assert {e["name"] for e in events} == NAMES[kind]
    for name in ("scene.build", "engine.run", "export.geometry",
                 "export.tiles"):
        assert len(_named(events, name)) == 1, name
    assert walls == 27
    assert len(_named(events, "export.tonemap")) == walls
    assert len(_named(events, "export.encode")) == walls


@pytest.mark.parametrize("kind", ["photon", "radiosity"])
def test_render_spans_nest(kind, tmp_path_factory):
    """Every engine step lies inside engine.run, every tone map and encode
    inside export.tiles, and no export step inside the engine."""
    events = _engine(kind, tmp_path_factory)[2]
    (run,) = _named(events, "engine.run")
    (tiles_span,) = _named(events, "export.tiles")
    engine_steps = NAMES[kind] - EXPORT - {"scene.build", "engine.run"}
    for e in events:
        if e["name"] in engine_steps:
            assert _inside(e, run), e["name"]
        if e["name"] in ("export.tonemap", "export.encode"):
            assert _inside(e, tiles_span) and not _inside(e, run)
    (scene,) = _named(events, "scene.build")
    assert float(scene["ts"]) + float(scene["dur"]) <= float(run["ts"])
    if kind == "radiosity":
        (plan,) = _named(events, "radiosity.mipmap_plan")
        (relax,) = _named(events, "radiosity.relax")
        (ff,) = _named(events, "radiosity.form_factors")
        assert float(ff["ts"]) + float(ff["dur"]) <= float(plan["ts"])
        assert float(plan["ts"]) + float(plan["dur"]) <= float(relax["ts"])
    else:
        (sched,) = _named(events, "photon.schedule")
        tables = _named(events, "engine.tables")
        assert len(tables) == 2
        assert all(float(t["ts"]) + float(t["dur"]) <= float(sched["ts"])
                   for t in tables)


@pytest.mark.parametrize("kind", ["photon", "radiosity"])
def test_profiler_changes_no_bit(kind, tmp_path_factory):
    """The arena's bits, geometry.json and the tiles' bytes are the same
    with the profiler recording and without."""
    (tex0, geo0, png0, _), (tex1, geo1, png1, _), _ = _engine(
        kind, tmp_path_factory)
    assert np.array_equal(tex0.view(np.uint32), tex1.view(np.uint32))
    assert geo0 == geo1 and png0 == png1


@pytest.mark.parametrize("kind", ["photon", "radiosity"])
def test_two_shard_mesh_reaches_combine(kind, tmp_path):
    """A render over two CPU shards combines its partials inside
    engine.run, on the photon schedule's end or in every gather."""
    cfg = CONFIGS[kind]
    mesh = pm.photon_mesh(["cpu"] * 2)
    _, events = _traced(tmp_path, lambda: _render(cfg, tmp_path, mesh))
    (run,) = _named(events, "engine.run")
    combines = _named(events, "mesh.combine")
    want = 1 if kind == "photon" else cfg.radiosity.iterations
    assert len(combines) == want
    assert all(_inside(c, run) for c in combines)
    if kind == "radiosity":
        (relax,) = _named(events, "radiosity.relax")
        assert all(_inside(c, relax) for c in combines)
        assert len(_named(events, "radiosity.form_factors")) == 2


def test_checkpointed_render_spans_every_save(tmp_path):
    """Each checkpoint save is a photon.checkpoint inside
    photon.schedule."""
    cfg = PHOTON.replace(photon=dataclasses.replace(
        PHOTON.photon, checkpoint_every=4))
    ck = str(tmp_path / "ck.npz")
    _, events = _traced(tmp_path, lambda: _render(cfg, tmp_path,
                                                  checkpoint_path=ck))
    (sched,) = _named(events, "photon.schedule")
    saves = _named(events, "photon.checkpoint")
    assert len(saves) >= 2
    assert all(_inside(s, sched) for s in saves)
