"""Axis-aligned scene table of the photon kernel.

Counterpart of flatmatch_tpu/ops/aa_scene.py: the same [F_AA, N] float32
table, field rows and group order, held as a torch tensor. Rects are grouped
by normal axis so the kernel runs one rect loop per group:

  axis 0 (normal +-x): span u along y, v along z
  axis 1 (normal +-y): span u along x, v along z
  axis 2 (normal +-z): span u along x, v along y

`pack_aa` returns None when a rect is not axis-aligned in this exact form,
or when a texel id reaches MAX_TEXELS.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..scene.rectangle import Rect, length_f32

f32 = np.float32

# Texel ids below this are exact in float32. The axis-aligned table and the
# narrow kernel's table store texel bases as f32, so a scene whose arena
# reaches it gets no table here, and the photon render sends it to the
# general engine (render.run_engine).
MAX_TEXELS = 1 << 24

# u/v coordinate axes per normal-axis group
GROUP_UV = {0: (1, 2), 1: (0, 2), 2: (0, 1)}

# scalar-field row layout of the [F_AA, N] table
A_O = 0      # plane offset pos[a]
A_SN = 1     # normal sign (+-1)
A_CU = 2     # span origin pos[au]
A_WS = 3     # width sign (+-1): du = (p_u - cu) * ws in [0, wlen]
A_WLEN = 4
A_CV = 5
A_HS = 6     # height sign
A_HLEN = 7
A_BASE = 8
A_WT = 9
A_HT = 10
A_KTU = 11   # wt / wlen  (tx = floor(du * ktu))
A_KTV = 12   # ht / hlen
F_AA = 13


class AARects(NamedTuple):
    fields: torch.Tensor                # [F_AA, N] f32, rects grouped by axis
    group_counts: Tuple[int, int, int]  # rects per normal-axis group
    perm: np.ndarray                    # [N] int32: kernel slot -> input index


def _classify(r: Rect):
    """(axis, au, av) or None if not axis-aligned. The on-axis normal
    component may be ~1 ulp off exactly 1 (normalized_f32 rounds)."""
    n = np.asarray(r.n, f32)
    a = int(np.argmax(np.abs(n)))
    au, av = GROUP_UV[a]
    if n[au] != 0.0 or n[av] != 0.0 or abs(n[a]) < 0.999999:
        return None
    w = np.asarray(r.width, f32)
    h = np.asarray(r.height, f32)
    if w[a] != 0.0 or w[av] != 0.0 or h[a] != 0.0 or h[au] != 0.0:
        return None
    if w[au] == 0.0 or h[av] == 0.0:
        return None
    return a, au, av


def pack_aa(rects: List[Rect], device="cpu") -> Optional[AARects]:
    """The [13, N] table (field rows as in aa_scene.py:35-48 of the JAX
    package) on `device`, or None for a scene it cannot hold."""
    groups: List[List] = [[], [], []]
    group_src: List[List[int]] = [[], [], []]
    for ri, r in enumerate(rects):
        c = _classify(r)
        if c is None:
            return None
        a, au, av = c
        group_src[a].append(ri)
        w = np.asarray(r.width, f32)
        h = np.asarray(r.height, f32)
        wlen = length_f32(w)
        hlen = length_f32(h)
        groups[a].append(
            [
                f32(r.pos[a]),
                f32(r.n[a]),
                f32(r.pos[au]),
                f32(w[au] / wlen),
                wlen,
                f32(r.pos[av]),
                f32(h[av] / hlen),
                hlen,
                f32(r.base),
                f32(r.wtiles),
                f32(r.htiles),
                f32(r.wtiles) / wlen,
                f32(r.htiles) / hlen,
            ]
        )
    max_id = max((r.base + r.wtiles * r.htiles for r in rects), default=0)
    if max_id >= MAX_TEXELS:
        return None
    rows = groups[0] + groups[1] + groups[2]
    fields = np.asarray(rows, f32).T.copy()
    return AARects(
        fields=torch.from_numpy(fields).to(device),
        group_counts=(len(groups[0]), len(groups[1]), len(groups[2])),
        perm=np.asarray(group_src[0] + group_src[1] + group_src[2], np.int32),
    )
