"""device_idle_pct: 100 - the share of the traced window in which some
kernel, copy or set ran on the card (the union of their intervals), the
mean over the cell's cards."""
from benchmark import trace


def read(run):
    t = run.get("trace")
    if not t:
        return None
    lo, hi = t["window"]
    if hi <= lo:
        return None
    busy = sum(trace.busy_s(t["events"], lo, hi, d) for d in t["devices"])
    return 100.0 * (1.0 - busy / len(t["devices"]) / ((hi - lo) * 1e-6))
