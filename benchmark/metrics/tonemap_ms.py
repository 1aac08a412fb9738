"""tonemap_ms: host ms a render inside the spans export.tonemap
(io/tiles.tile_rgb, one a wall: the tone map to uint8 and the floor
tint), from the traced requests."""
from benchmark import spans


def read(run):
    return spans.host_ms(run, "export.tonemap")
