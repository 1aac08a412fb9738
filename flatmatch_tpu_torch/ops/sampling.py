"""Orthonormal bases and the reference's 2*pi (torch, float32).

Counterpart of flatmatch_tpu/ops/sampling.py (`TWO_PI_REF`, `build_base`)
and ops/linalg.py (`normalize3`). The photon trace works on per-photon
components (`base_cols`); the radiosity form factors on [..., 3] normals
(`build_base`). Both round as the JAX package does: every cross product
and the squared length sum left to right, 1/sqrt as reciprocal(sqrt).
"""
from __future__ import annotations

import torch

# The reference uses this truncated pi literal (photonmap.cl:33,57).
TWO_PI_REF = 2.0 * 3.141592


def normalize(x, y, z):
    # 1/sqrt as reciprocal(sqrt): IEEE-rounded on the CPU and on the card,
    # and what the kernels compute (1.0f / sqrtf)
    inv = torch.reciprocal(torch.sqrt(x * x + y * y + z * z))
    return x * inv, y * inv, z * inv


def base_cols(nx, ny, nz):
    """build_base (photonmap.cl:43-48) on per-element components: udir
    starts as +z and falls back to +y when |n.z| >= 0.999999."""
    colinear = torch.abs(nz) >= 0.999999
    zero = torch.zeros_like(nx)
    one = torch.ones_like(nx)
    u0x = zero
    u0y = torch.where(colinear, one, zero)
    u0z = torch.where(colinear, zero, one)
    vx = u0y * nz - u0z * ny
    vy = u0z * nx - u0x * nz
    vz = u0x * ny - u0y * nx
    vx, vy, vz = normalize(vx, vy, vz)
    ux = vy * nz - vz * ny
    uy = vz * nx - vx * nz
    uz = vx * ny - vy * nx
    ux, uy, uz = normalize(ux, uy, uz)
    return (ux, uy, uz), (vx, vy, vz)


def build_base(ndir: torch.Tensor):
    """Orthonormal (udir, vdir) [..., 3] completing `ndir` [..., 3]
    (sampling.build_base of the JAX package)."""
    u, v = base_cols(ndir[..., 0], ndir[..., 1], ndir[..., 2])
    return torch.stack(u, -1), torch.stack(v, -1)
