"""A stand-in reference kind for a fit step (the tests' step fixture, not a
cell of BENCHMARK.json): one Adam step of a least-squares fit of per-rect
albedo and per-emitter power to a linear forward model, in float64.

The benchmark makes the problem from the seed (`problem`, which the
fixture's mix uses too): `rows` observations y = A albedo + B power of a
[rows, walls] and a [rows, emitters] matrix, and targets from parameters
drawn from the seed with some noise. A step starts from the parameters
and Adam's moments that the request consumed (`inputs`), so the
reference judges that step and not one from the seed's start.
"""
from __future__ import annotations

import numpy as np
import torch

from .layout import Layout, emitters

LR, BETAS, EPS = 0.01, (0.9, 0.999), 1e-8
MISSING = float(1 << 30)


def problem(layout: Layout, seed: int, rows: int, dtype=torch.float64):
    """(A, B, target) of the seed, in `dtype`."""
    gen = torch.Generator()
    gen.manual_seed(int(seed) % (1 << 31))
    walls, lights = len(layout.walls), len(emitters(layout))
    a = torch.rand(rows, walls, generator=gen, dtype=torch.float64) / walls
    b = torch.rand(rows, lights, generator=gen, dtype=torch.float64) / lights
    albedo = 0.1 + 0.8 * torch.rand(walls, generator=gen, dtype=torch.float64)
    power = 0.5 + torch.rand(lights, generator=gen, dtype=torch.float64)
    noise = 0.05 * torch.randn(rows, generator=gen, dtype=torch.float64)
    target = a @ albedo + b @ power + noise
    return a.to(dtype), b.to(dtype), target.to(dtype)


def step(a, b, target, albedo, power, m, v, count: int, dtype) -> dict:
    """One Adam step in `dtype` with the gradient written out: the
    forward, the loss, both gradients and the parameters after."""
    albedo, power, m, v = (torch.as_tensor(np.asarray(x)).to(dtype)
                           for x in (albedo, power, m, v))
    y = a @ albedo + b @ power
    r = y - target
    g_a = (2.0 / len(r)) * (a.T @ r)
    g_p = (2.0 / len(r)) * (b.T @ r)
    g = torch.cat([g_a, g_p])
    t = count + 1
    m = BETAS[0] * m + (1 - BETAS[0]) * g
    v = BETAS[1] * v + (1 - BETAS[1]) * g * g
    update = LR * (m / (1 - BETAS[0] ** t)) / (
        torch.sqrt(v / (1 - BETAS[1] ** t)) + EPS)
    before = torch.cat([albedo, power])
    out = dict(arena=y, loss=torch.mean(r * r), grad_albedo=g_a,
               grad_power=g_p, params_before=before,
               params_after=before - update)
    return {k: x.to(torch.float64).numpy() for k, x in out.items()}


def expected(layout: Layout, settings: dict, budget: dict, seed: int,
             device, dtype=torch.float64, inputs=None) -> dict:
    """The step that `inputs` (albedo, power, m, v, step) start, in
    float64."""
    if inputs is None:
        raise ValueError("a step's reference needs the inputs it started from")
    a, b, target = problem(layout, seed, int(settings["samples_per_area"]),
                           dtype)
    ref = step(a, b, target, inputs["albedo"], inputs["power"], inputs["m"],
               inputs["v"], int(inputs["step"]), dtype)
    return dict(ref, work={})


def control(layout: Layout, settings: dict, budget: dict, seed: int, device,
            inputs=None) -> dict:
    """The reference in the program's place, in bfloat16 (the step below
    the program's float32)."""
    return {k: v for k, v in expected(layout, settings, budget, seed, device,
                                      torch.bfloat16, inputs).items()
            if k != "work"}


def _leaf(outputs, name, shape):
    x = outputs.get(name) if hasattr(outputs, "get") else None
    if x is None or np.shape(x) != shape:
        return None
    return np.asarray(x, np.float64)


def _rel(got, want) -> float:
    if got is None:
        return MISSING
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _norm_gap(got: list, want: list) -> float:
    """The worst leaf's gap of norms, over the larger of that leaf's
    reference norm and the median leaf's."""
    if any(g is None for g in got):
        return MISSING
    ref = [float(np.linalg.norm(w)) for w in want]
    floor = float(np.median(ref))
    return max(abs(float(np.linalg.norm(g)) - r) / max(r, floor, 1e-30)
               for g, r in zip(got, ref))


def checks(layout, outputs, ref, out_dir, extra, answers_differ, limits,
           inputs=None) -> list:
    """arena_gap, loss_gap (largest relative gaps), grad_gap and
    update_gap (gaps of leaf norms: the gradients, the parameters'
    change), before_gap (the step's starting parameters against the
    inputs the reference was given; exact) and answers_differ. A missing
    or misshapen output reads MISSING."""
    walls = len(ref["grad_albedo"])
    grads = [_leaf(outputs, n, ref[n].shape)
             for n in ("grad_albedo", "grad_power")]
    before = _leaf(outputs, "params_before", ref["params_before"].shape)
    after = _leaf(outputs, "params_after", ref["params_after"].shape)
    start = np.concatenate([inputs["albedo"], inputs["power"]]).astype(
        np.float64)
    change = ([None, None] if after is None else
              [after[:walls] - start[:walls], after[walls:] - start[walls:]])
    want = ref["params_after"] - ref["params_before"]
    values = dict(
        arena_gap=_rel(_leaf(outputs, "arena", ref["arena"].shape),
                       ref["arena"]),
        loss_gap=_rel(_leaf(outputs, "loss", ref["loss"].shape),
                      ref["loss"]),
        grad_gap=_norm_gap(grads, [ref["grad_albedo"], ref["grad_power"]]),
        update_gap=_norm_gap(change, [want[:walls], want[walls:]]),
        before_gap=(MISSING if before is None
                    else float(np.max(np.abs(before - start)))),
        answers_differ=answers_differ)
    return [(k, v, limits.get(k)) for k, v in values.items()]
