"""The control, at a size a test can hold: the reference put in the
program's place, computed in bfloat16 (the step below the float32 that the
configurations state), has to fail the cell's limits, and the same
reference in float32 has to pass them. The readings at the cells' own
size come from benchmark/tools/readings.py on the card."""
from __future__ import annotations

import pytest
import torch

from benchmark import registry
from benchmark.reference import compare, photon, radiosity
from benchmark.reference.layout import parse_rects

from .conftest import ROOT

LAYOUT = ROOT / "benchmark" / "layouts" / "example_rects.txt"


@pytest.mark.parametrize("kind, module, settings, budget, reference", [
    ("example_photon", photon, dict(samples_per_area=65000.0), None,
     dict(photons=2000000)),
    ("example_radiosity", radiosity, dict(rays_per_texel=64), None,
     dict(rays_per_texel=256)),
], ids=["photon", "radiosity"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_control(kind, module, settings, budget, reference, dtype):
    config = registry.config(kind)
    s = dict(config["settings"], **settings)
    layout = parse_rects(LAYOUT)
    gen = torch.Generator()
    gen.manual_seed(12345)
    arena, _ = module.estimate(layout, s, module.program_samples(layout, s),
                               gen, "cpu", dtype)
    ref = module.expected(layout, s, reference, 777, "cpu")
    energy, chi2 = compare.engine_checks(layout, arena.astype("float32"),
                                         ref)
    limits = config["limits"]
    failed = energy > limits["energy_gap"] or chi2 > limits["texel_chi2"]
    assert failed is (dtype == torch.bfloat16), (energy, chi2)
