"""trace_roofline_pct: the least time of a render's photon trace
(benchmark/roofline.py, from the reference's photons and bounces a photon)
over the trace kernel's device time a render, summed over cards, in %."""
from benchmark import roofline, trace

KERNEL = "trace_splat_kernel"


def read(run):
    s = trace.kernel_s_per_request(run, lambda name: name == KERNEL)
    if s is None or not run["work"]:
        return None
    return roofline.share_pct(*roofline.photon_trace_work(run["work"]), s)
