"""The program's spans in a traced run: the `user_annotation` events that
flatmatch_tpu_torch/utils/spans.py records inside the traced window, on
the profiler's clock with the card's operations.

Each value is the mean over the traced requests. "Host ms" sums a span's
instances' durations; "card idle ms" sums, for each instance, its
duration less the card's busy union inside it (trace.busy_s), averaged
over the cell's cards: the card idling while the host ran that step. Both
are None where the run was not traced or its trace holds no instance of
the span, as with a program that records none.
"""
from __future__ import annotations

from benchmark import trace


def instances(run, name: str) -> list:
    """[(start, end)] µs of span `name`'s instances inside the traced
    window; [] where the run was not traced."""
    t = run.get("trace")
    if not t or not t["requests"]:
        return []
    lo, hi = t["window"]
    out = []
    for e in t["events"]:
        if e.get("cat") == "user_annotation" and e["name"] == name:
            s = float(e["ts"])
            end = s + float(e["dur"])
            if lo <= s and end <= hi:
                out.append((s, end))
    return out


def host_ms(run, name: str):
    """Host ms a traced request inside span `name`, or None."""
    spans = instances(run, name)
    if not spans:
        return None
    return sum(e - s for s, e in spans) * 1e-3 / run["trace"]["requests"]


def card_idle_ms(run, name: str):
    """Card idle ms a traced request inside span `name`, averaged over the
    cell's cards, or None."""
    spans = instances(run, name)
    if not spans:
        return None
    t = run["trace"]
    idle_s = sum((e - s) * 1e-6 - trace.busy_s(t["events"], s, e, d)
                 for s, e in spans for d in t["devices"])
    return 1e3 * idle_s / len(t["devices"]) / t["requests"]
