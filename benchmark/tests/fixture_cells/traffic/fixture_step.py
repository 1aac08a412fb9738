"""A stand-in step mix (the tests' step fixture): each request is one Adam
step, in float32 under autograd, of the least-squares fit that
reference/fixture_step.py states, chained from the step before it (set-up's
warm-up step hands its parameters to the window on `target.state`). It
returns named outputs and, from its window, the inputs of its last step.

FIXTURE_FAULT in the environment breaks the window's last step: `perturb`
(its albedo gradient scaled by 1.1), `missing` (no power gradient),
`alter_inputs` (the albedo the reference is given moved by 0.05),
`no_outputs` (nothing returned, though no step failed).
"""
import os
import time

import numpy as np
import torch

from benchmark.reference.fixture_step import BETAS, EPS, LR, problem

PARAMS = {"trace_requests": 1}
MIN_STEPS = 3


def start(walls: int, lights: int) -> dict:
    return dict(albedo=np.full(walls, 0.6, np.float32),
                power=np.full(lights, 0.5, np.float32),
                m=np.zeros(walls + lights, np.float32),
                v=np.zeros(walls + lights, np.float32), step=0)


def step(prob, state: dict) -> tuple:
    """(outputs, the state after) of one step from `state`."""
    a, b, target = prob
    albedo = torch.tensor(state["albedo"], requires_grad=True)
    power = torch.tensor(state["power"], requires_grad=True)
    y = a @ albedo + b @ power
    loss = torch.mean((y - target) ** 2)
    loss.backward()
    with torch.no_grad():
        g = torch.cat([albedo.grad, power.grad])
        t = state["step"] + 1
        m = BETAS[0] * torch.from_numpy(state["m"]) + (1 - BETAS[0]) * g
        v = BETAS[1] * torch.from_numpy(state["v"]) + (1 - BETAS[1]) * g * g
        before = torch.cat([albedo, power])
        after = before - LR * (m / (1 - BETAS[0] ** t)) / (
            torch.sqrt(v / (1 - BETAS[1] ** t)) + EPS)
    walls = len(state["albedo"])
    outputs = dict(arena=y.detach().numpy(), loss=loss.detach().numpy(),
                   grad_albedo=albedo.grad.numpy(),
                   grad_power=power.grad.numpy(),
                   params_before=before.numpy(), params_after=after.numpy())
    return outputs, dict(albedo=after[:walls].numpy(),
                         power=after[walls:].numpy(), m=m.numpy(),
                         v=v.numpy(), step=t)


def _state(layout, rcfg, target) -> dict:
    """The fit's problem and parameters on `target`, kept from one request
    to the next; made anew from the seed's start for another seed."""
    key = (rcfg.photon.seed, int(rcfg.photon.samples_per_area))
    if target.state.get("key") != key:
        prob = problem(layout, rcfg.photon.seed,
                       int(rcfg.photon.samples_per_area), torch.float32)
        target.state.update(key=key, prob=prob,
                            params=start(prob[0].shape[1], prob[1].shape[1]))
    return target.state


def request(layout, rcfg, target, annotate=False):
    """One step from where the steps before it left off (set-up's warm-up:
    the first step from the seed's start)."""
    t0 = time.perf_counter()
    st = _state(layout, rcfg, target)
    outputs, st["params"] = step(st["prob"], st["params"])
    return outputs, dict(step=time.perf_counter() - t0)


def window(layout, rcfg, target, seconds):
    """Steps back to back, at least MIN_STEPS, until the first boundary
    past `seconds`, on from set-up's. Chained steps differ by design, so
    no digests."""
    st = _state(layout, rcfg, target)
    spans, t_start = [], time.perf_counter()
    while True:
        t0 = time.perf_counter()
        inputs = {k: np.copy(v) for k, v in st["params"].items()}
        outputs, st["params"] = step(st["prob"], st["params"])
        spans.append(dict(step=time.perf_counter() - t0))
        if (len(spans) >= MIN_STEPS
                and time.perf_counter() - t_start >= seconds):
            break
    fault = os.environ.get("FIXTURE_FAULT")
    if fault == "perturb":
        outputs["grad_albedo"] = outputs["grad_albedo"] * np.float32(1.1)
    elif fault == "missing":
        del outputs["grad_power"]
    elif fault == "alter_inputs":
        inputs["albedo"] = inputs["albedo"] + np.float32(0.05)
    elif fault == "no_outputs":
        outputs = None
    return dict(seconds=time.perf_counter() - t_start, requests=len(spans),
                failed=0, spans=spans, digests=[], last=outputs,
                inputs=inputs)


def traced(layout, rcfg, target, profiler, n, sync):
    with profiler:
        for _ in range(n):
            request(layout, rcfg, target)
    return []
