"""nearest_kernel_ms: device ms a render of the form factors' nearest-hit
kernel (csrc/aa_nearest.cu, nearest_kernel, via ops/aa_query), summed
over cards, from the traced requests."""
from benchmark import trace

KERNEL = "nearest_kernel"


def read(run):
    s = trace.kernel_s_per_request(run, lambda name: name == KERNEL)
    return None if s is None else 1e3 * s
