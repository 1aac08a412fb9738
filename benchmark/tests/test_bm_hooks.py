"""A configuration that brings its own judgement, as new files alone: the
two fixture cells of fixture_cells/ (a stand-in step with named outputs
and inputs, and a stand-in deterministic engine), added to a copy of the
benchmark and run on the CPU past the look for a card. Also the run's
refusals: checks and limits that disagree, and a mix that returns no
outputs though no request failed."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from benchmark.reference import compare

from .conftest import ROOT

FIXTURES = ROOT / "benchmark" / "tests" / "fixture_cells"
STEP, EXACT = "fixture_step.fixture_step", "fixture_exact.fixture_exact"
STEP_CHECKS = ["arena_gap", "loss_gap", "grad_gap", "update_gap",
               "before_gap", "answers_differ"]


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A copy of the benchmark with the fixture cells added as new files,
    and a BENCHMARK.json that lists them."""
    root = tmp_path_factory.mktemp("hooks") / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for sub in ("configs", "traffic", "reference"):
        for path in (FIXTURES / sub).iterdir():
            assert not (root / "benchmark" / sub / path.name).exists()
            shutil.copy(path, root / "benchmark" / sub / path.name)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name in ("fixture_step", "fixture_exact"):
        bench["configs"].append(dict(
            bench["configs"][0], name=name,
            file=f"benchmark/configs/{name}.json"))
        bench["workloads"].append(dict(
            name=f"{name}.{name}", config=name, traffic=name, chips=1,
            why="a stand-in of the tests"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _python(root, body: str, fault=None):
    code = f"""
import json, sys, time, types
sys.path[:0] = [{str(root)!r}, {str(ROOT)!r}]
import torch
torch.set_num_threads(2)
from benchmark import harness, registry
assert harness.__file__.startswith({str(root)!r})
bench = registry.load_benchmark({str(root)!r})
""" + body
    env = dict(os.environ, PYTHONPATH="")
    env.pop("FIXTURE_FAULT", None)
    if fault:
        env["FIXTURE_FAULT"] = fault
    return subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=600,
                          env=env)


def run(root, workload: str, fault=None, **config):
    """A run of `workload` in the copy, its configuration's keys replaced
    by `config`: (exit code, the result line or None, standard error)."""
    out = _python(root, f"""
cell = registry.cell(bench, {workload!r})
config = dict(registry.config(cell["config"]), **json.loads({json.dumps(
        json.dumps(config))}))
args = types.SimpleNamespace(workload=cell["name"], seed=2 ** 31 + 5,
                             seconds=0.0, trace=0)
sys.exit(harness.run_cell(args, {str(root)!r}, bench, cell, config,
                          registry.traffic(cell["traffic"]),
                          [torch.device("cpu")], time.perf_counter()))
""", fault)
    lines = out.stdout.strip().splitlines()
    return out.returncode, json.loads(lines[-1]) if lines else None, out.stderr


def test_step_fixture_sound(checkout):
    rc, res, err = run(checkout, STEP)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, res["checks"]
    assert list(res["checks"]) == STEP_CHECKS
    limits = json.loads((FIXTURES / "configs" / "fixture_step.json")
                        .read_text())["limits"]
    for name, check in res["checks"].items():
        assert check["limit"] == limits[name]
        assert check["value"] <= check["limit"]
    assert res["attempted"] >= 3 and res["failed"] == 0
    for name in STEP_CHECKS:
        assert f"check {name} " in err


@pytest.mark.parametrize("fault, failing", [
    ("perturb", {"grad_gap"}),
    ("missing", {"grad_gap"}),
    ("alter_inputs", {"before_gap", "grad_gap"}),
], ids=["perturbed", "missing", "altered_inputs"])
def test_step_fixture_faults(checkout, fault, failing):
    """One output perturbed or missing, or the inputs altered between the
    request and the reference: not correct, the value beside its limit."""
    rc, res, err = run(checkout, STEP, fault)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False
    over = {n for n, c in res["checks"].items() if c["value"] > c["limit"]}
    assert failing <= over, res["checks"]
    if fault == "missing":
        assert res["checks"]["grad_gap"]["value"] == float(1 << 30)


def test_exact_fixture(checkout):
    """A deterministic reference (equal halves) judged exactly by its
    kind's own check; one texel altered fails it."""
    rc, res, err = run(checkout, EXACT)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True
    assert res["checks"] == {"texel_gap": {"value": 0.0, "limit": 0.0},
                             "answers_differ": {"value": 0, "limit": 0}}
    rc, res, err = run(checkout, EXACT, "altered")
    assert rc == 0, err[-3000:]
    assert res["correct"] is False
    assert res["checks"]["texel_gap"]["value"] == 1.0


def test_exact_fixture_default_checks_stop(checkout):
    """The same fixture through compare.checks (a kind with no checks of
    its own): the run stops with a message naming the kind, and prints no
    result."""
    default = json.loads((ROOT / "benchmark" / "configs" /
                          "example_photon.json").read_text())["limits"]
    rc, res, err = run(checkout, EXACT,
                       reference={"kind": "fixture_exact_default"},
                       limits=default)
    assert rc == 4 and res is None, err[-3000:]
    assert "'fixture_exact_default'" in err and "halves" in err
    assert not [x for x in err.splitlines() if x.startswith("check ")]


@pytest.mark.parametrize("limits, says", [
    ({"texel_gap": 0.0, "answers_differ": 0, "energy_gap": 0.01},
     "limits that no check gives: ['energy_gap']"),
    ({"texel_gap": 0.0}, "checks without a limit in the configuration: "
                         "['answers_differ']"),
], ids=["limit_without_check", "check_without_limit"])
def test_limits_and_checks_agree(checkout, limits, says):
    rc, res, err = run(checkout, EXACT, limits=limits)
    assert rc == 4 and res is None, err[-3000:]
    assert says in err and "'fixture_exact'" in err


def test_no_outputs_stops(checkout):
    """A mix that returns no outputs though no request failed escapes no
    check: the run stops and prints no result."""
    rc, res, err = run(checkout, STEP, "no_outputs")
    assert rc == 4 and res is None, err[-3000:]
    assert "no outputs" in err


def test_readings_of_the_step_fixture(checkout):
    """tools/readings.py on the step fixture: its program readings pass
    every limit of the kind's own checks, given each request's inputs;
    the program at half its rows and the kind's bfloat16 control fail
    them."""
    out = _python(checkout, f"""
from benchmark.tools import readings
args = readings.parse_args(["--workload", {STEP!r}, "--seeds", "2",
                            "--halves", "1", "--controls", "1"])
readings.read(args, registry.cell(bench, {STEP!r}), [torch.device("cpu")])
""")
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    assert [x["kind"] for x in lines] == ["program", "program", "half",
                                          "control"]
    limits = json.loads((FIXTURES / "configs" / "fixture_step.json")
                        .read_text())["limits"]
    for x in lines:
        assert list(x["checks"]) == STEP_CHECKS
        passed = all(v <= limits[n] for n, v in x["checks"].items())
        assert passed is (x["kind"] == "program"), x
        if x["kind"] != "control":
            assert x["checks"]["before_gap"] == 0.0


def test_digest_of_named_outputs():
    """A bare arena keeps its crc32; a mapping digests its arrays in name
    order, so the order it was built in does not matter."""
    import zlib

    from benchmark import loop

    a = np.arange(12, dtype=np.float32).reshape(4, 3)
    assert loop.digest(a) == zlib.crc32(a.tobytes())
    g = np.ones(5, np.float32)
    assert loop.digest({"arena": a, "grad": g}) == loop.digest(
        {"grad": g, "arena": a})
    assert loop.digest({"arena": a, "grad": g}) != loop.digest(
        {"arena": a, "grad": g * 2})
    assert loop.digest({"arena": a}) != loop.digest(a)


def test_agree():
    ok = [("a", 1.0, 2.0), ("b", 0, 0)]
    assert compare.agree(ok, {"a": 2.0, "b": 0}) is ok
    for checks, limits in (
            (ok, {"a": 2.0}), (ok, {"a": 2.0, "b": 0, "c": 1}),
            ([("a", 1.0, 3.0), ("b", 0, 0)], {"a": 2.0, "b": 0}),
            (ok + [("a", 1.0, 2.0)], {"a": 2.0, "b": 0})):
        with pytest.raises(compare.CheckError):
            compare.agree(checks, limits)


def test_named_outputs_need_the_kinds_checks():
    with pytest.raises(compare.CheckError, match="named outputs"):
        compare.judge(object(), None, {"arena": np.zeros((1, 3))}, {}, ".",
                      False, 0, {})


def test_readings_of_an_arena_kind_are_compare_checks(capsys, monkeypatch,
                                                     tmp_path):
    """tools/readings.py on a configuration without checks of its own (the
    photon cell at a CPU test's budget) reads what compare.checks and
    compare.engine_checks read of one request, at the same seed."""
    import torch

    from benchmark import loop, registry
    from benchmark.reference import photon
    from benchmark.reference.layout import parse_rects
    from benchmark.tools import readings

    from .conftest import small_config

    config = small_config("example_photon", 20000.0, 300000)
    monkeypatch.setattr(registry, "config", lambda name, here=None: config)
    cell = registry.cell(registry.load_benchmark(ROOT),
                         "example_photon.render")
    seed, dev = 2 ** 31 + 17, torch.device("cpu")
    args = readings.parse_args(["--workload", cell["name"], "--seeds", "1",
                                "--halves", "1", "--controls", "1",
                                "--first-seed", str(seed)])
    readings.read(args, cell, [dev])
    got = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["kind"] for x in got] == ["program", "half", "control"]

    layout = parse_rects(ROOT / "benchmark" / config["layout"])
    target = loop.Target([dev], None, str(tmp_path), False)
    settings = config["settings"]
    ref = photon.expected(layout, settings, config["reference"], seed, dev)
    texels, _ = loop.request(layout, loop.render_config(config, {}, seed, 1),
                             target)
    assert got[0]["checks"] == {n: v for n, v, _ in compare.checks(
        layout, texels, ref, tmp_path, False, 0, config["limits"])}
    half = dict(config, settings=dict(
        settings, samples_per_area=settings["samples_per_area"] / 2))
    texels, _ = loop.request(layout, loop.render_config(half, {}, seed, 1),
                             target)
    energy, chi2 = compare.engine_checks(layout, texels, ref)
    assert got[1]["checks"] == dict(energy_gap=energy, texel_chi2=chi2)
    gen = torch.Generator()
    gen.manual_seed(seed + 1)
    arena, _ = photon.estimate(layout, settings, photon.program_samples(
        layout, settings), gen, dev, torch.bfloat16)
    energy, chi2 = compare.engine_checks(layout, arena.astype("float32"),
                                         ref)
    assert got[2]["checks"] == dict(energy_gap=energy, texel_chi2=chi2)
