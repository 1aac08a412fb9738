"""Reading a torch.profiler trace (its Chrome trace JSON): device
operations, their busy time as a union of intervals per device, the
kernels by name, and the idle gaps labelled by what the host was doing.

Times in the trace are microseconds. An event is a dict with `name`,
`cat`, `ts`, `dur` and `args` (a device operation's `args.device`).
"""
from __future__ import annotations

import json
import pathlib
import re

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")
WINDOW = "bench.window"
# PyTorch's own kernels are named in its C++ namespaces (at::native::...,
# its cub as at_cuda_detail::cub::...); the program's are not
TORCH_NAMESPACES = ("at::", "c10::", "at_cuda_detail::")
_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_:]*")


def load(path) -> list:
    """The events of a Chrome trace file that the readers use."""
    data = json.loads(pathlib.Path(path).read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS + HOST_CATS]


def window(events) -> tuple:
    """(start, end) in µs of the traced window: the host span WINDOW."""
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] == WINDOW:
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    raise ValueError(f"the trace has no {WINDOW!r} span")


def device_ops(events, devices=None) -> list:
    """[(device, start, end, name)] of the device operations."""
    out = []
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            dev = int(e.get("args", {}).get("device", 0))
            if devices is None or dev in devices:
                ts = float(e["ts"])
                out.append((dev, ts, ts + float(e["dur"]), e["name"]))
    return out


def identifier(name: str) -> str:
    """The function name of a kernel's trace name, without its return type,
    anonymous namespaces, template arguments and parameters:
    'void (anonymous namespace)::f<true>(int)' -> 'f'."""
    s = name.strip().replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    m = _IDENT.match(s)
    return m.group(0) if m else s


def pytorch_kernel(ident: str) -> bool:
    """Whether a kernel's identifier names one of PyTorch's own kernels."""
    return ident.startswith(TORCH_NAMESPACES)


def busy_s(events, lo: float, hi: float, device: int) -> float:
    """Seconds of [lo, hi] (µs) in which an operation ran on `device`: the
    union of their intervals, so operations that overlap count once."""
    spans = sorted((max(s, lo), min(e, hi))
                   for d, s, e, _ in device_ops(events, [device])
                   if e > lo and s < hi)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6


def kernel_s(events, match) -> float:
    """Seconds of the kernels (not copies or sets) for whose identifier
    `match` is true, summed over devices."""
    return sum(float(e["dur"]) for e in events
               if e.get("cat") == "kernel" and match(identifier(e["name"]))
               ) * 1e-6


def top_ops(events, n=10) -> list:
    """[[identifier, seconds]] of the n device operations that took most
    time, summed over devices."""
    tot = {}
    for _, s, e, name in device_ops(events):
        k = identifier(name)
        tot[k] = tot.get(k, 0.0) + (e - s) * 1e-6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(events, lo: float, hi: float, device: int, n=10) -> list:
    """[[host activity, seconds]] of the n longest idle gaps of `device`
    inside [lo, hi], each named by the innermost host span (a benchmark
    span or a PyTorch op) that covers its middle."""
    spans = sorted((s, e) for _, s, e, _ in device_ops(events, [device]))
    gaps, t = [], lo
    for s, e in spans:
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])[:n]
    host = [e for e in events
            if e.get("cat") in HOST_CATS and e["name"] != WINDOW]
    hs = np.array([float(e["ts"]) for e in host])
    he = hs + np.array([float(e["dur"]) for e in host])
    out = []
    for s, e in gaps:
        mid = 0.5 * (s + e)
        cover = np.nonzero((hs <= mid) & (he >= mid))[0]
        label = (host[cover[np.argmin(he[cover] - hs[cover])]]["name"]
                 if len(cover) else "host (no span)")
        out.append([label, (e - s) * 1e-6])
    return out


def kernel_s_per_request(run: dict, match):
    """Device seconds a traced request of the kernels `match` accepts, or
    None where the run was not traced or ran none of them."""
    t = run.get("trace")
    if not t or not t["requests"]:
        return None
    s = kernel_s(t["events"], match)
    return s / t["requests"] if s > 0 else None
