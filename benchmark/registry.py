"""Name discovery: every cell, configuration, traffic mix, metric and
reference is found by its name in BENCHMARK.json, as a file of its own.

- a configuration `<config>`: configs/<config>.json
- a traffic mix `<traffic>`: traffic/<traffic>.json, parameters of
  loop.py's closed loop, or traffic/<traffic>.py, a module with its own
  loop
- a metric `<metric>`: metrics/<metric>.py, whose `read(run)` returns the
  metric's value or None where the run has nothing to read; a split
  metric `<m>.<part>` without a file of its own is read by `<m>`'s
- a reference `<kind>` (a configuration's "reference" "kind"):
  reference/<kind>.py, whose `expected(layout, settings, budget, seed,
  device, dtype)` estimates what the program should return. Where the
  cell's mix returns `inputs` (what its last request consumed beyond the
  layout and the settings, such as a fit step's starting parameters),
  the harness passes them as `expected(..., inputs=inputs)`; a kind whose
  mix returns none is called without. A kind may define its own
  `checks(layout, outputs, ref, out_dir, extra, answers_differ, limits,
  inputs=None)`, returning [(name, value, limit)] with each limit the
  configuration's: it judges what the request returned (`outputs`, an
  arena or a mapping of named arrays, loop.py) against `ref`, what
  `expected` returned. Without one reference/compare.checks judges a
  bare arena. Either way the checks' names and the configuration's
  `limits` have to agree one to one. For tools/readings.py a kind with
  its own checks may define `control(layout, settings, budget, seed,
  device, inputs=None)`: outputs of the reference in the program's place,
  one precision below the configuration's

Adding any of them takes new files only.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
import re

HERE = pathlib.Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _checked(name: str) -> str:
    if not NAME.fullmatch(name or ""):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_benchmark(root) -> dict:
    return json.loads((pathlib.Path(root) / "BENCHMARK.json").read_text())


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(name: str, here=HERE) -> dict:
    return json.loads((here / "configs" / f"{_checked(name)}.json")
                      .read_text())


def traffic(name: str, here=HERE):
    """The loop.Mix of traffic mix `name`. A module traffic/<name>.py gives
    its `PARAMS` (a dict, the parameters loop.py reads) and may give its own
    `window`, `traced` and `request` (the warm-up), with loop.py's
    signatures; the rest are loop.py's (whose loops call loop.request).
    Without one, traffic/<name>.json holds the parameters of loop.py's
    closed loop."""
    from . import loop

    path = here / "traffic" / f"{_checked(name)}.py"
    if path.exists():
        mod = _module(path, "benchmark_traffic_" + name)
        return loop.Mix(dict(getattr(mod, "PARAMS", {})),
                        getattr(mod, "window", loop.window),
                        getattr(mod, "traced", loop.traced),
                        getattr(mod, "request", loop.request))
    params = json.loads((here / "traffic" / f"{name}.json").read_text())
    loop.check_mix(params)
    return loop.Mix(params)


def metric(name: str, here=HERE):
    """The reader module of metric `name`: metrics/<name>.py, or, for a
    metric split by the end-to-end metric it moves (`<m>.<part>`, one
    quantity whose cells report different end-to-end metrics) that has no
    file of its own, the reader of `<m>`."""
    base = _checked(name)
    while "." in base and not (here / "metrics" / f"{base}.py").exists():
        base = base.rsplit(".", 1)[0]
    return _module(here / "metrics" / f"{base}.py",
                   "benchmark_metric_" + base)


def _module(path, mod_name: str):
    spec = importlib.util.spec_from_file_location(
        re.sub(r"\W", "_", mod_name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(kind: str):
    return importlib.import_module(f"benchmark.reference.{_checked(kind)}")


def metrics_of(bench: dict, section: str, workload: str) -> list:
    """The metrics of `section` ("end_to_end" or "per_layer") that cell
    `workload` reports: those without a `workloads` list, and those whose
    list names it."""
    return [m for m in bench[section]
            if "workloads" not in m or workload in m["workloads"]]
