"""The traffic generator: the request, and the closed loop that a traffic
mix of parameters (traffic/<mix>.json) drives into the program. A mix
that needs another loop is a module of its own (traffic/<mix>.py, see
registry.traffic) and may reuse what is here.

A request renders one layout, as `render <layout> 30` of the program's CLI
does: it builds the program's Scene from the parsed rects, runs
`render.run_engine` on the cell's cards and synchronises them, then
writes geometry.json and the tone-mapped tiles into one directory, which
every request overwrites.

Mix parameters:
- "loop": "closed" (the only kind of a .json mix): one client sends its
  next request when the last one has returned.
- "clients": 1.
- "trace_requests": requests of the window that a --trace 1 run profiles.
- "photons_per_batch_per_chip" (optional): the photon engines' global
  batch is this times the cell's chips, so each card launches batches of
  this size; without it the configuration's batch holds.

What a request returns (its outputs) is a [T, 3] arena, or a mapping of
named arrays with the arena, where there is one, under "arena" (a fit
step: its loss, gradients and parameters before and after). `digest`
digests either. A mix's `window` returns the last request's outputs as
`last` and may return `inputs`: what that request consumed beyond the
layout and the configuration's settings (a fit step: its starting
parameters and optimizer moments), which the reference is given.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import zlib
from collections.abc import Mapping
from typing import Callable

import numpy as np


def check_mix(mix: dict):
    if mix.get("loop") != "closed" or int(mix.get("clients", 1)) != 1:
        raise ValueError(f"unsupported traffic mix {mix}: only a closed "
                         "loop of one client")


def render_config(config: dict, params: dict, seed: int, chips: int,
                  warmup: bool = False):
    """The program's RenderConfig of a configuration's engine settings
    (its `settings`, and its `warmup` over them for the warm-up
    request), the mix's batch per chip (`params`, a Mix's) and the run's
    seed, folded into the program's int32 seeds."""
    from flatmatch_tpu_torch.config import DEFAULT_CONFIG, Engine

    settings = dict(config["settings"])
    if warmup:
        settings.update(config.get("warmup", {}))
    if params.get("photons_per_batch_per_chip"):
        settings["photons_per_batch"] = (
            int(params["photons_per_batch_per_chip"]) * chips)
    engine = Engine(config["engine"])
    section = {Engine.RADIOSITY: "radiosity",
               Engine.AMBIENT_OCCLUSION: "ao"}.get(engine, "photon")
    sub = getattr(DEFAULT_CONFIG, section)
    fields = {f.name for f in dataclasses.fields(sub)}
    unknown = set(settings) - fields
    if unknown:
        raise ValueError(f"settings {sorted(unknown)} are not fields of the "
                         f"program's {type(sub).__name__}")
    if "seed" in fields:
        settings["seed"] = int(seed) % (1 << 31)
    return DEFAULT_CONFIG.replace(
        engine=engine, **{section: dataclasses.replace(sub, **settings)})


def build_scene(layout):
    """The program's Scene of the parsed layout (fresh rects each call)."""
    from flatmatch_tpu_torch.scene.geometry import Scene
    from flatmatch_tpu_torch.scene.layout import ParsedLayout
    from flatmatch_tpu_torch.scene.rectangle import Rect

    groups = {g: [Rect(pos=r["pos"].copy(), width=r["width"].copy(),
                       height=r["height"].copy(), n=r["n"].copy(),
                       base=r["base"], wtiles=r["wtiles"],
                       htiles=r["htiles"]) for r in rows]
              for g, rows in layout.groups.items()}
    return Scene(ParsedLayout(
        **groups, width=layout.width, height=layout.height,
        starting_position=tuple(float(v) for v in layout.start),
        num_texels=layout.num_texels))


@dataclasses.dataclass
class Target:
    """What a request runs on: the cards, the mesh over them (None on one
    card), the export directory and whether the tiles take the extra floor
    tint; and `state`, which a mix's requests may keep from one to the
    next, set-up's warm-up request to the window's first (a fit's
    parameters and optimizer moments). This module's requests keep none."""

    devices: list
    mesh: object
    out_dir: str
    tint_extra: bool
    state: dict = dataclasses.field(default_factory=dict)


def request(layout, rcfg, target: Target, annotate=False) -> tuple:
    """One request; returns (arena [T, 3] float32, spans {scene, engine,
    export} in seconds)."""
    import pathlib

    import torch

    from flatmatch_tpu_torch.io import tiles
    from flatmatch_tpu_torch.render import run_engine
    from flatmatch_tpu_torch.scene.geometry import geometry_json

    def span(name):
        if annotate:
            return torch.profiler.record_function(f"request.{name}")
        return contextlib.nullcontext()

    t0 = time.perf_counter()
    with span("scene"):
        scene = build_scene(layout)
    t1 = time.perf_counter()
    with span("engine"):
        texels = run_engine(scene, rcfg, target.devices[0],
                            mesh=target.mesh)
        for d in target.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
    t2 = time.perf_counter()
    with span("export"):
        out = pathlib.Path(target.out_dir)
        out.mkdir(parents=True, exist_ok=True)
        (out / "geometry.json").write_text(geometry_json(scene))
        tiles.save_tiles(scene.walls, texels, str(out / "tiles"),
                         target.tint_extra, False)
    t3 = time.perf_counter()
    return texels, dict(scene=t1 - t0, engine=t2 - t1, export=t3 - t2)


def digest(outputs) -> int:
    """crc32 of an arena's bytes; of a mapping, of each name and its
    array's bytes in name order."""
    if not isinstance(outputs, Mapping):
        return zlib.crc32(np.ascontiguousarray(outputs).tobytes())
    crc = 0
    for name in sorted(outputs):
        crc = zlib.crc32(name.encode(), crc)
        crc = zlib.crc32(np.ascontiguousarray(outputs[name]).tobytes(), crc)
    return crc


def window(layout, rcfg, target: Target, seconds: float) -> dict:
    """Requests back to back until the first request boundary past
    `seconds`: the window's seconds, requests and failures, each request's
    spans and arena digest, and the last arena (`last`)."""
    import traceback

    spans, digests, failed, last = [], [], 0, None
    t_start = time.perf_counter()
    n = 0
    while True:
        try:
            texels, sp = request(layout, rcfg, target)
            spans.append(sp)
            digests.append(digest(texels))
            last = texels
        except Exception:  # a failed request counts, the loop goes on
            traceback.print_exc()
            failed += 1
        n += 1
        if time.perf_counter() - t_start >= seconds:
            break
    return dict(seconds=time.perf_counter() - t_start, requests=n,
                failed=failed, spans=spans, digests=digests, last=last)


def traced(layout, rcfg, target: Target, profiler, n: int, sync) -> list:
    """`n` requests after the window under `profiler`, inside the span
    bench.window, each with its spans annotated: their arena digests."""
    import torch

    digests = []
    sync()
    with profiler:
        with torch.profiler.record_function("bench.window"):
            for _ in range(n):
                texels, _ = request(layout, rcfg, target, annotate=True)
                digests.append(digest(texels))
            sync()
    return digests


@dataclasses.dataclass
class Mix:
    """A traffic mix: its parameters, its `request` (the one set-up runs
    to warm up), and its request loop, `window` (requests for `seconds`)
    and `traced` (the requests a --trace 1 run profiles after the window),
    with the signatures of this module's."""

    params: dict
    window: Callable = window
    traced: Callable = traced
    request: Callable = request
