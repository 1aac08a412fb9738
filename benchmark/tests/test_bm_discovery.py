"""BENCHMARK.json against the contract's shape, and name discovery: every
configuration, traffic mix and metric is a file found by its name, and a
cell added as new files alone runs."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import registry

from .conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_configurations():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and c["name"] in used
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        body = registry.config(c["name"])
        assert body["reduced"] == c["reduced"] == []
        assert body["source"].startswith(c["source"].split(" ")[0])
        assert (ROOT / "benchmark" / body["layout"]).exists()
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text


def test_cells():
    names = [c["name"] for c in BENCH["configs"]]
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        registry.traffic(w["traffic"])
        assert len(w["why"]) <= 200
        e2e = [m["name"] for m in registry.metrics_of(BENCH, "end_to_end",
                                                      w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert registry.metrics_of(BENCH, "per_layer", w["name"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    seen = set()
    for section in ("end_to_end", "per_layer"):
        for m in BENCH[section]:
            assert NAME.fullmatch(m["name"]) and m["name"] not in seen
            seen.add(m["name"])
            assert UNIT.fullmatch(m["unit"]) and m["better"] in (
                "lower", "higher")
            assert set(m.get("workloads", [])) <= cells
            assert callable(registry.metric(m["name"]).read)
            if section == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert m["moves"] in e2e and "\n" not in m["layer"]
    assert e2e >= {"setup_s", "render_s"}


def test_names_are_checked():
    with pytest.raises(ValueError):
        registry.config("../BENCHMARK")
    with pytest.raises(ValueError):
        registry.metric("a/b")


def test_split_metric_reads_with_its_base_reader(tmp_path):
    """`<m>.<part>` without a file of its own is read by metrics/<m>.py;
    one with its own file by that file."""
    m = tmp_path / "metrics"
    m.mkdir()
    (m / "x_s.py").write_text("def read(run):\n    return 1.0\n")
    (m / "x_s.own.py").write_text("def read(run):\n    return 2.0\n")
    assert registry.metric("x_s.radiosity", here=tmp_path).read({}) == 1.0
    assert registry.metric("x_s.a.b", here=tmp_path).read({}) == 1.0
    assert registry.metric("x_s.own", here=tmp_path).read({}) == 2.0
    with pytest.raises(FileNotFoundError):
        registry.metric("y_s.radiosity", here=tmp_path)
    assert registry.metric("engine_s.radiosity").read(
        dict(spans=[dict(engine=0.5)])) == 0.5


def test_traffic_module_or_parameters(tmp_path):
    """traffic/<mix>.py gives its PARAMS and its own loop functions and
    request, and loop.py's where it has none; traffic/<mix>.json gives the
    parameters of loop.py's closed loop, which refuses any other kind."""
    from benchmark import loop

    t = tmp_path / "traffic"
    t.mkdir()
    (t / "own.py").write_text("PARAMS = {'burst': 4}\n"
                              "def window(*args):\n    return 'own'\n"
                              "def request(*args):\n    return 'step'\n")
    (t / "bare.py").write_text("")
    (t / "closed.json").write_text('{"loop": "closed", "clients": 1}')
    (t / "open.json").write_text('{"loop": "open", "clients": 1}')
    own = registry.traffic("own", here=tmp_path)
    assert own.params == {"burst": 4} and own.window() == "own"
    assert own.traced is loop.traced and own.request() == "step"
    bare = registry.traffic("bare", here=tmp_path)
    assert bare.params == {} and bare.window is loop.window
    assert bare.request is loop.request
    closed = registry.traffic("closed", here=tmp_path)
    assert closed.params["loop"] == "closed"
    assert closed.window is loop.window and closed.traced is loop.traced
    with pytest.raises(ValueError):
        registry.traffic("open", here=tmp_path)
    with pytest.raises(ValueError):
        registry.traffic("../open", here=tmp_path)


def test_new_cell_takes_new_files_only(tmp_path):
    """A throwaway configuration, traffic mix and metric, added as new
    files to a copy of the benchmark, run as a cell of their own (on the
    CPU, past the look for a card) with no edit to a file there."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    b = root / "benchmark"
    shutil.copy(ROOT / "tests" / "fixtures" / "tiny_rects.txt",
                b / "layouts" / "tiny_rects.txt")
    config = registry.config("example_photon")
    config.update(layout="layouts/tiny_rects.txt",
                  reference={"kind": "photon", "photons": 400000})
    config["settings"].update(samples_per_area=30000.0,
                              photons_per_batch=4096)
    # a throwaway cell's own limits, loose for its few photons
    config["limits"].update(energy_gap=0.05, texel_chi2=1.5)
    (b / "configs" / "tiny_photon.json").write_text(json.dumps(config))
    # a mix with a loop of its own: two requests whatever the seconds
    (b / "traffic" / "twice.py").write_text(
        "import time\n"
        "from benchmark import loop\n"
        "PARAMS = {'trace_requests': 1}\n"
        "def window(layout, rcfg, target, seconds):\n"
        "    t0, spans, digests = time.perf_counter(), [], []\n"
        "    for _ in range(2):\n"
        "        texels, sp = loop.request(layout, rcfg, target)\n"
        "        spans.append(sp)\n"
        "        digests.append(loop.digest(texels))\n"
        "    return dict(seconds=time.perf_counter() - t0, requests=2,\n"
        "                failed=0, spans=spans, digests=digests,\n"
        "                last=texels)\n")
    (b / "metrics" / "requests_n.py").write_text(
        "def read(run):\n    return float(run['requests'])\n")
    bench = dict(BENCH)
    bench["configs"] = BENCH["configs"] + [dict(
        BENCH["configs"][0], name="tiny_photon",
        file="benchmark/configs/tiny_photon.json")]
    bench["workloads"] = BENCH["workloads"] + [dict(
        name="tiny_photon.twice", config="tiny_photon", traffic="twice",
        chips=1, why="a throwaway cell")]
    bench["end_to_end"] = BENCH["end_to_end"] + [dict(
        name="requests_n", unit="requests", better="higher", bound=0.01,
        source="host_clock", workloads=["tiny_photon.twice"])]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = f"""
import sys, time, types
sys.path[:0] = [{str(root)!r}, {str(ROOT)!r}]
import torch
torch.set_num_threads(2)
from benchmark import harness, registry
assert harness.__file__.startswith({str(root)!r})
bench = registry.load_benchmark({str(root)!r})
cell = registry.cell(bench, "tiny_photon.twice")
args = types.SimpleNamespace(workload=cell["name"], seed=2 ** 31 + 5,
                             seconds=0.0, trace=0)
sys.exit(harness.run_cell(args, {str(root)!r}, bench, cell,
                          registry.config(cell["config"]),
                          registry.traffic(cell["traffic"]),
                          [torch.device("cpu")], time.perf_counter()))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res
    assert res["attempted"] == 2
    assert res["metrics"]["requests_n"]["value"] == 2.0
    assert set(res["metrics"]) == {"setup_s", "requests_n"}
    for p, data in before.items():
        assert p.read_bytes() == data
