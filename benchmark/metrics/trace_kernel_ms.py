"""trace_kernel_ms: device ms a render of the photon trace kernel
(csrc/trace_splat_wide_rng.cu, trace_splat_kernel), summed over cards,
from the traced requests."""
from benchmark import trace

KERNEL = "trace_splat_kernel"


def read(run):
    s = trace.kernel_s_per_request(run, lambda name: name == KERNEL)
    return None if s is None else 1e3 * s
