"""A stand-in deterministic mix (the tests' deterministic fixture): each
request returns the same arena, worked out in float32 with PyTorch, one
wall at a time. FIXTURE_FAULT=altered in the environment adds 1 to one
texel of the window's last arena."""
import os
import time

import torch

from benchmark import loop

PARAMS = {"trace_requests": 1}


def request(layout, rcfg, target, annotate=False):
    t0 = time.perf_counter()
    out = torch.zeros(layout.num_texels, 3)
    for r in layout.walls:
        n = r["wtiles"] * r["htiles"]
        i = torch.arange(n)
        out[r["base"]:r["base"] + n] = torch.stack([i % 7, i % 5, i % 3], 1)
    return out.numpy(), dict(engine=time.perf_counter() - t0)


def window(layout, rcfg, target, seconds):
    spans, digests, t_start = [], [], time.perf_counter()
    while True:
        arena, sp = request(layout, rcfg, target)
        spans.append(sp)
        digests.append(loop.digest(arena))
        if time.perf_counter() - t_start >= seconds:
            break
    if os.environ.get("FIXTURE_FAULT") == "altered":
        arena = arena.copy()
        arena[layout.walls[0]["base"], 0] += 1.0
    return dict(seconds=time.perf_counter() - t_start, requests=len(spans),
                failed=0, spans=spans, digests=digests, last=arena)


def traced(layout, rcfg, target, profiler, n, sync):
    with profiler:
        return [loop.digest(request(layout, rcfg, target)[0])
                for _ in range(n)]
