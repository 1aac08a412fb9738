"""Collision map: passable-space mask, dilation, RLE JSON encoding.

Mirrors parseLayout.c:538-630. Passable pixel classes are
EMPTY, DOOR and BALCONY_DOOR (:604-614); the impassable area is dilated by a
square radius (:571-594); the result is RLE-encoded as a JSON int array whose
first run is impassable and even-indexed runs are impassable (:538-569).
(The README's claim that the map starts passable contradicts the code; we
follow the code, see SURVEY.md §2.)
"""
from __future__ import annotations

import numpy as np

from ..config import SceneConfig
from . import image as im


def passable_mask(img: np.ndarray) -> np.ndarray:
    """Boolean [H,W]: True where walkable (parseLayout.c:607-614)."""
    return (img == im.EMPTY) | (img == im.DOOR) | (img == im.BALCONY_DOOR)


def collision_map(img: np.ndarray, cfg: SceneConfig | None = None) -> np.ndarray:
    """Dilated passability mask (True = passable)."""
    cfg = cfg or SceneConfig()
    passable = passable_mask(img)
    impassable = im.dilate_mask(~passable, cfg.collision_dilate_radius)
    return ~impassable


def rle_json(passable: np.ndarray) -> str:
    """RLE-encode row-major passability into the reference's JSON format
    (parseLayout.c:538-569): '[' + comma-separated run lengths, a newline
    after every 30th printed run, final run closing with ']\\n'. The first
    run is impassable (length 0 if the map starts passable)."""
    flat = passable.reshape(-1).astype(bool)
    # run-length encode
    change = np.nonzero(np.diff(flat))[0]
    starts = np.concatenate(([0], change + 1))
    ends = np.concatenate((change + 1, [len(flat)]))
    lengths = (ends - starts).tolist()
    first_passable = bool(flat[0]) if len(flat) else False
    runs = ([0] if first_passable else []) + lengths

    parts = ["["]
    count = 0
    for rl in runs[:-1]:
        parts.append("%d," % rl)
        count += 1
        if count % 30 == 0:
            parts.append("\n")
    parts.append("%d]\n" % runs[-1])
    return "".join(parts)


def build_collision_map(img: np.ndarray, cfg: SceneConfig | None = None) -> str:
    """buildCollisionMap equivalent (parseLayout.c:604-630)."""
    return rle_json(collision_map(img, cfg))
