"""A stand-in reference kind for a deterministic engine (the tests'
deterministic fixture, not a cell of BENCHMARK.json), as ambient occlusion
is: no seed, so the reference's two halves are equal and
compare.engine_checks' texel_chi2 has no noise to divide by. Its own
checks compare the arena exactly.

The arena is a fixed function of the layout: on each wall's level-0
texels, the texel's index within the wall modulo 7, 5 and 3.
"""
from __future__ import annotations

import numpy as np

from .layout import Layout, tiles


def arena(layout: Layout) -> np.ndarray:
    out = np.zeros((layout.num_texels, 3))
    for r in layout.walls:
        i = np.arange(tiles(r))
        out[r["base"]:r["base"] + len(i)] = np.stack([i % 7, i % 5, i % 3], 1)
    return out


def expected(layout: Layout, settings: dict, budget: dict, seed: int,
             device, dtype=None) -> dict:
    a = arena(layout)
    return dict(halves=[a, a.copy()], share=1.0, arena=a, work={})


def checks(layout, outputs, ref, out_dir, extra, answers_differ, limits,
           inputs=None) -> list:
    """texel_gap: the largest gap of the arena from the reference's, exact
    (a misshapen arena reads 2^30); answers_differ."""
    got = np.asarray(outputs, np.float64)
    gap = (float(np.abs(got - ref["arena"]).max())
           if got.shape == ref["arena"].shape else float(1 << 30))
    values = dict(texel_gap=gap, answers_differ=answers_differ)
    return [(k, v, limits.get(k)) for k, v in values.items()]
