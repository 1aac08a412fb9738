"""On the card: one short run of each one-card cell through the command
as the driver gives it, correct, with every end-to-end metric. Skips
without a card (run on the chip:
`python -m pytest benchmark/tests/test_bm_card.py -n 0`)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import registry

from .conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["example_photon.render",
                                      "example_radiosity.render"])
def test_cell_runs_correct(cuda_card, workload):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 17), "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    bench = registry.load_benchmark(ROOT)
    want = {m["name"] for m in registry.metrics_of(bench, "end_to_end",
                                                   workload)}
    assert set(res["metrics"]) == want
    assert res["device"]["platform"] == "gpu"
