"""nearest_roofline_pct: the least time of a render's form-factor rays
(benchmark/roofline.py: every ray against every rect) over the nearest-hit
kernel's device time a render, in %."""
from benchmark import roofline, trace

KERNEL = "nearest_kernel"


def read(run):
    s = trace.kernel_s_per_request(run, lambda name: name == KERNEL)
    if s is None or not run["work"]:
        return None
    return roofline.share_pct(*roofline.nearest_work(run["work"]), s)
