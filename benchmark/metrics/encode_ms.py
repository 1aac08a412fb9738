"""encode_ms: host ms a render inside the spans export.encode
(io/tiles.save_tile, one a wall: the PNG encoded and written), from the
traced requests."""
from benchmark import spans


def read(run):
    return spans.host_ms(run, "export.encode")
