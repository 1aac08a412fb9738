"""torch_kernel_ms: device ms a render of PyTorch's own kernels, those in
its namespaces (trace.pytorch_kernel: radiosity's ray making, relaxation
gathers and mipmaps), summed over cards, from the traced requests."""
from benchmark import trace


def read(run):
    s = trace.kernel_s_per_request(run, trace.pytorch_kernel)
    return None if s is None else 1e3 * s
