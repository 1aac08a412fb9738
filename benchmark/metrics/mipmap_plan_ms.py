"""mipmap_plan_ms: host ms a render inside the span radiosity.mipmap_plan
(ops/mipmap.build_plan of the extended rects, Python lists on the host),
from the traced requests."""
from benchmark import spans


def read(run):
    return spans.host_ms(run, "radiosity.mipmap_plan")
