"""Scene tables carried across from the JAX package.

The renderer has no weights: the state both packages share is the packed
scene and the config. These take the JAX package's `AARectsDev` and
`EmittersDev` fields as numpy arrays (`np.asarray` of each field) and build
the port's tensors, so both engines can be fed identical tables.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.aa_scene import F_AA, AARects
from .ops.device_scene import Emitters, emitters_from_numpy


def from_jax_aa(fields_np, group_counts, perm, device="cpu") -> AARects:
    """`AARectsDev` (fields [13, N], group_counts, perm) -> `AARects`."""
    fields = np.array(fields_np, np.float32)  # a writable copy
    if fields.ndim != 2 or fields.shape[0] != F_AA:
        raise ValueError(f"expected a [{F_AA}, N] table, got {fields.shape}")
    gc = tuple(int(g) for g in group_counts)
    if sum(gc) != fields.shape[1]:
        raise ValueError(f"group_counts {gc} do not sum to {fields.shape[1]}")
    return AARects(
        fields=torch.from_numpy(fields).to(device),
        group_counts=gc,
        perm=np.asarray(perm, np.int32),
    )


def from_jax_emitters(pos, wvec, hvec, n, color, is_window, area, counts,
                      device="cpu") -> Emitters:
    """`EmittersDev` fields, in its field order -> `Emitters`."""
    return emitters_from_numpy(pos, wvec, hvec, n, color, is_window, area,
                               counts, device)
