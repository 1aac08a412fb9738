"""Batched 3-vector helpers over a trailing xyz axis (torch, float32).

Counterpart of flatmatch_tpu/ops/linalg.py (vector3_cl.c:76-100). Every sum
of three products associates left to right, ((x + y) + z), which is the
order XLA's three-element reduction takes on the CPU; the reciprocal length
is 1 / sqrt, IEEE-rounded on the CPU and on the card.
"""
from __future__ import annotations

import torch


def dot3(a, b):
    """Batched dot product over the trailing xyz axis (vector3_cl.c:76-79)."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def cross3(a, b):
    """Batched cross product (vector3_cl.c:81-86)."""
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def normalize3(a):
    """Normalization via reciprocal length (vector3_cl.c:95-100)."""
    fac = torch.reciprocal(torch.sqrt(dot3(a, a)))
    return a * fac[..., None]
