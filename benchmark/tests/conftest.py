"""Fixtures of the benchmark's tests. Whether a card is there is decided
inside a fixture, never while a module is imported."""
from __future__ import annotations

import copy
import json
import pathlib
import sys
import time
import types

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the program's CUDA kernels run "
                    "only there")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_config(name: str, samples: float, reference: float) -> dict:
    """Configuration `name` at a budget a CPU test can hold: photons a m^2
    or rays a texel `samples`, the reference's `reference`."""
    from benchmark import registry

    config = copy.deepcopy(registry.config(name))
    if config["engine"] == "radiosity":
        config["settings"]["rays_per_texel"] = int(samples)
        config["reference"]["rays_per_texel"] = int(reference)
    else:
        config["settings"]["samples_per_area"] = float(samples)
        config["settings"]["photons_per_batch"] = 8192
        config["warmup"]["samples_per_area"] = 1000.0
        config["reference"]["photons"] = int(reference)
    return config


def cpu_run(capsys, workload: str, config: dict, chips: int = 1,
            seed: int = 2 ** 31 + 11, trace: int = 0, cell=None) -> dict:
    """A run of `workload` (or of `cell`, a cell's entry) on CPU shards
    with `config` (the harness past its look for a card): the result line
    as a dict."""
    import torch

    from benchmark import harness, registry

    bench = registry.load_benchmark(ROOT)
    cell = cell or registry.cell(bench, workload)
    mix = registry.traffic(cell["traffic"])
    if mix.params.get("photons_per_batch_per_chip"):
        mix.params["photons_per_batch_per_chip"] = 2048
    args = types.SimpleNamespace(workload=workload, seed=seed, seconds=0.0,
                                 trace=trace)
    rc = harness.run_cell(args, ROOT, bench, cell, config, mix,
                          [torch.device("cpu")] * chips, time.perf_counter())
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


sys.path.insert(0, str(ROOT))
