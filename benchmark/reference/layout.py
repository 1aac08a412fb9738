"""The layout as the benchmark reads it, and the plain arithmetic of its
rects: the benchmark's own copy, independent of the program.

A `*_rects.txt` dump holds every rect the scene compiler makes from a
layout PNG, at full precision: a `# counts` header (walls, windows, lights,
box, texels, size=WxH, start=X,Y), then one `# <group> <n>` line per group
and one row per rect: pos (3), width (3), height (3), n (3), base, wtiles,
htiles. Values are parsed straight to float32.

Everything the engines derive from the rects (tile grids, mipmap sizes,
areas, photon budgets, the exposure scale, texel centers) is worked out
here again from the upstream C renderer's definitions
(rbuch703/flatmatch-global-illumination, rectangle.c and photonmap.c).
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Dict, List

import numpy as np

f32 = np.float32
GROUPS = ("walls", "windows", "lights", "box")


@dataclasses.dataclass
class Layout:
    """The parsed dump: each group's rows in file order, and the header."""

    groups: Dict[str, List[dict]]
    width: int
    height: int
    start: tuple
    num_texels: int

    @property
    def walls(self) -> List[dict]:
        return self.groups["walls"]


def parse_rects(path) -> Layout:
    """The layout of a `*_rects.txt` dump. The header's counts and texel
    total must agree with the rows."""
    header, groups, cur = {}, {g: [] for g in GROUPS}, None
    for line in pathlib.Path(path).read_text().splitlines():
        if line.startswith("# counts"):
            for tok in line.split()[2:]:
                k, v = tok.split("=")
                if k == "size":
                    header["width"], header["height"] = map(int, v.split("x"))
                elif k == "start":
                    header["start"] = tuple(f32(t) for t in v.split(","))
                else:
                    header[k] = int(v)
        elif line.startswith("# "):
            name, _ = line[2:].split()
            if name not in groups:
                raise ValueError(f"{path}: unknown group {name!r}")
            cur = groups[name]
        elif line.strip():
            vals = line.split()
            if len(vals) != 15 or cur is None:
                raise ValueError(f"{path}: malformed row {line!r}")
            cur.append(dict(
                pos=np.array(vals[0:3], f32),
                width=np.array(vals[3:6], f32),
                height=np.array(vals[6:9], f32),
                n=np.array(vals[9:12], f32),
                base=int(vals[12]), wtiles=int(vals[13]),
                htiles=int(vals[14])))
    for g in GROUPS:
        if len(groups[g]) != header[g]:
            raise ValueError(f"{path}: {len(groups[g])} {g} rows, header "
                             f"says {header[g]}")
    total = sum(mipmap_texels(r) for r in groups["walls"])
    if total != header["texels"]:
        raise ValueError(f"{path}: the walls hold {total} texels, header "
                         f"says {header['texels']}")
    return Layout(groups, header["width"], header["height"],
                  header["start"], header["texels"])


def length(v) -> f32:
    """|v| in float32, the squares summed left to right (vector3_cl.c)."""
    return np.sqrt(f32(f32(f32(v[0] * v[0]) + f32(v[1] * v[1]))
                       + f32(v[2] * v[2])))


def area(r) -> f32:
    return f32(length(r["width"]) * length(r["height"]))


def tiles(r) -> int:
    """Level-0 texels of a rect."""
    return r["wtiles"] * r["htiles"]


def mipmap_texels(r) -> int:
    """Texels of a rect with its whole mipmap pyramid (rectangle.c)."""
    w, h = r["wtiles"], r["htiles"]
    total = w * h
    while w > 1 or h > 1:
        w, h = max(w // 2, 1), max(h // 2, 1)
        total += w * h
    return total


def level0_mask(layout: Layout) -> np.ndarray:
    """[num_texels] bool: the level-0 texels of the walls."""
    mask = np.zeros(layout.num_texels, bool)
    for r in layout.walls:
        mask[r["base"]:r["base"] + tiles(r)] = True
    return mask


def emitters(layout: Layout) -> List[dict]:
    """Windows, then lights: the photon emitters (photonmap.c)."""
    return ([dict(r, window=True) for r in layout.groups["windows"]]
            + [dict(r, window=False) for r in layout.groups["lights"]])


def photon_counts(layout: Layout, samples_per_area: float) -> np.ndarray:
    """Photons of each emitter: (uint64)(samplesPerArea * area), the
    product in float32 (photonmap.c)."""
    return np.array([int(f32(samples_per_area) * area(e))
                     for e in emitters(layout)], np.int64)


def exposure_scale(layout: Layout, samples_per_area: float,
                   exposure: float) -> np.ndarray:
    """[num_texels] float64: exposure * tiles / (area * samplesPerArea) on a
    wall's level-0 texels, 0 elsewhere (main.c)."""
    scale = np.zeros(layout.num_texels)
    for r in layout.walls:
        scale[r["base"]:r["base"] + tiles(r)] = (
            exposure * tiles(r) / (float(area(r)) * samples_per_area))
    return scale


def tile_centers(r) -> np.ndarray:
    """[tiles, 3] float32 centers of a rect's level-0 texels, row by row
    (getTileCenter, rectangle.c)."""
    vw = r["width"] / f32(r["wtiles"])
    vh = r["height"] / f32(r["htiles"])
    tx, ty = np.meshgrid(np.arange(r["wtiles"]), np.arange(r["htiles"]))
    tx = (tx.ravel() + f32(0.5)).astype(f32)[:, None]
    ty = (ty.ravel() + f32(0.5)).astype(f32)[:, None]
    return (r["pos"][None] + vw[None] * tx + vh[None] * ty).astype(f32)


def _num(v) -> str:
    return f"{float(v):f}"


def _vec(p) -> str:
    return f"[{_num(p[0])}, {_num(p[1])}, {_num(p[2])}]"


def geometry_json(layout: Layout) -> str:
    """The viewer's geometry.json (writeJsonOutput, geometry.c): printf
    "%f" of every value, walls with their texture ids, then the box."""
    sp = layout.start
    out = ['{\n"startingPosition" : [%s, %s],\n' % (_num(sp[0]), _num(sp[1])),
           '"layoutImageSize" : [%d, %d],\n' % (layout.width, layout.height),
           '"geometry" : [\n']
    walls = layout.walls
    for i, r in enumerate(walls):
        out.append('  { "pos": %s, "width": %s, "height": %s, '
                   '"textureId": %d}%s\n'
                   % (_vec(r["pos"]), _vec(r["width"]), _vec(r["height"]),
                      i, "," if i + 1 < len(walls) else ""))
    out.append('],\n"box": [\n')
    box = layout.groups["box"]
    for i, r in enumerate(box):
        out.append('  { "pos": %s, "width": %s, "height": %s}%s\n'
                   % (_vec(r["pos"]), _vec(r["width"]), _vec(r["height"]),
                      "," if i + 1 < len(box) else ""))
    out.append(']\n}\n')
    return "".join(out)


def mipmap(level0: np.ndarray, r) -> np.ndarray:
    """A rect's pyramid above its level-0 texels [tiles, 3]: each level the
    2x2 means of the one below while both sides pass 1, pair means along
    the side left otherwise (rectangle.c)."""
    w, h = r["wtiles"], r["htiles"]
    cur = level0.reshape(h, w, -1).astype(np.float64)
    out = []
    while w > 1 or h > 1:
        if w > 1 and h > 1:
            cur = 0.25 * (cur[0::2, 0::2] + cur[1::2, 0::2]
                          + cur[0::2, 1::2] + cur[1::2, 1::2])
            w, h = w // 2, h // 2
        else:
            flat = cur.reshape(-1, cur.shape[-1])
            flat = 0.5 * (flat[0::2] + flat[1::2])
            w, h = (len(flat), 1) if w > 1 else (1, len(flat))
            cur = flat.reshape(h, w, -1)
        out.append(cur.reshape(-1, cur.shape[-1]))
    return np.concatenate(out) if out else level0[:0].astype(np.float64)
