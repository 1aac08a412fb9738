"""Scene tables carried across from the JAX package, and back.

The renderer has no weights: the state both packages share is the packed
scene, the config and, for the fit, its parameters. These take the JAX
package's `AARectsDev`, `RectsDev` (and its `scene_matrix`) and
`EmittersDev` fields and fit parameters as numpy arrays (`np.asarray` of
each field) and build the port's tensors, so both packages can be fed
identical state; `to_jax_rects` gives the port's rect table back as numpy
arrays in `RectsDev`'s field order.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.aa_scene import F_AA, AARects
from .ops.device_scene import (
    Emitters, Rects, emitters_from_numpy, rects_from_numpy,
)


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


def from_jax_rects(*fields_np, device="cpu") -> Rects:
    """`RectsDev` fields, in its field order (pos, wvec, hvec, n, w_unit,
    h_unit, wlen, hlen, n_off, base, wtiles, htiles) -> `Rects`."""
    return rects_from_numpy(device, **dict(zip(Rects._fields, fields_np)))


def to_jax_rects(rects: Rects) -> tuple:
    """`Rects` -> numpy arrays in `RectsDev`'s field order
    (`RectsDev(*map(jnp.asarray, to_jax_rects(r)))` builds the JAX one)."""
    return tuple(t.cpu().numpy() for t in rects)


def from_jax_scene_matrix(matrix_np, device="cpu") -> torch.Tensor:
    """The narrow kernel's [18, N] `scene_matrix` -> the port's table
    (engines/photon_narrow.py)."""
    m = np.array(matrix_np, np.float32)
    if m.ndim != 2 or m.shape[0] != 18:
        raise ValueError(f"expected an [18, N] table, got {m.shape}")
    return torch.from_numpy(m).to(device)


def from_jax_emitters(pos, wvec, hvec, n, color, is_window, area, counts,
                      device="cpu") -> Emitters:
    """`EmittersDev` fields, in its field order -> `Emitters`."""
    return emitters_from_numpy(pos, wvec, hvec, n, color, is_window, area,
                               counts, device)


def fit_params_from_jax(a_logit, p_log, device="cpu") -> dict:
    """The JAX fit's parameter dict ({"a_logit", "p_log"} as numpy arrays)
    -> the `params` of diff.fit.fit_materials, so both fits can start from
    identical state."""
    return {
        "a_logit": torch.from_numpy(np.array(a_logit, np.float32)).to(device),
        "p_log": torch.from_numpy(np.array(p_log, np.float32)).to(device),
    }
