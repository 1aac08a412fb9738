"""The result line's shape, the run's refusals (no card, a checkout of the
benchmark alone) and the import check."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

from benchmark import harness

from .conftest import ROOT, cpu_run, small_config


def test_result_line_keys_and_order():
    line = harness.result_line(
        True, 3, 0, {"render_s": {"value": 2.5, "unit": "s"}},
        dict(platform="gpu", kind="NVIDIA H100 80GB HBM3", count=1,
             memory_peak_bytes=123),
        [("energy_gap", 1e-4, 0.01), ("tiles_gap", 0, 0)],
        dict(device_ops=[["k", 1.0]], idle_gaps=[["h", 0.5]]))
    res = json.loads(line)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert res["checks"]["energy_gap"] == {"value": 1e-4, "limit": 0.01}
    assert "breakdown" not in json.loads(harness.result_line(
        True, 1, 0, {}, {}, []))


def test_passed():
    assert harness.passed([("a", 0, 0), ("b", 0.5, 1.0)])
    assert not harness.passed([("a", 1, 0)])


def test_foreign_modules_by_whole_top_level_name():
    names = ["flatmatch_tpu_torch", "flatmatch_tpu_torch.render", "jax",
             "jaxlib.xla_client", "flax.linen", "flatmatch_tpu",
             "flatmatch_tpu.render", "jaxtyping", "numpy"]
    assert harness.foreign_modules(names) == [
        "flatmatch_tpu", "flatmatch_tpu.render", "flax.linen", "jax",
        "jaxlib.xla_client"]


def test_cpu_run_result(capsys):
    """A whole run on the CPU (past the look for a card): the last line
    has every key the driver reads, the checks last."""
    res = cpu_run(capsys, "example_photon.render",
                  small_config("example_photon", 20000.0, 1200000), trace=1)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes", "busy_s", "window_s"}
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert {"scene_s", "engine_s", "export_s"} <= set(res["metrics"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def _run(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "example_photon.render", "--seed", str(2 ** 31 + 3), "--seconds",
         "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_no_card_no_result():
    """Without a CUDA card (this sandbox) a run exits non-zero and prints
    no result."""
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the run would measure")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_alone_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files a run exits non-zero and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
