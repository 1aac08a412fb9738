"""gather_kernel_ms: device ms a render of the relaxation's gather kernel
(csrc/relax_gather.cu, relax_gather_kernel, via ops/relax_gather), summed
over cards, from the traced requests."""
from benchmark import trace

KERNEL = "relax_gather_kernel"


def read(run):
    s = trace.kernel_s_per_request(run, lambda name: name == KERNEL)
    return None if s is None else 1e3 * s
