"""The radiosity relaxation's gather: dest[r] = sum_j src[ids[r, j]] over
the form-factor id table, a miss (id -1) adding zero.

The JAX package gathers in XLA (flatmatch_tpu/engines/radiosity.py
`_gather_chunk`). `relax_gather` launches `csrc/relax_gather.cu` for CUDA
tensors, one launch on the whole table, and runs the plain PyTorch version
for CPU tensors only.
"""
from __future__ import annotations

import torch

from ..utils.cuda_build import launch

GATHER_IDS = 1 << 22            # ids gathered per step of the plain version


def relax_gather_plain(src: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """dest[r] = sum_j src[ids[r, j]] [rows, 3] on ids' device, a miss
    (id -1) adding a zero row; (1 << 22) // rays rows at a time, so no
    [rows, rays, 3] tensor is made."""
    rows, rays = ids.shape
    step = max(1, GATHER_IDS // max(rays, 1))
    # a zero row past the arena takes the misses
    miss_row = torch.tensor(src.shape[0], dtype=torch.int64,
                            device=src.device)
    src_ext = torch.cat([src, src.new_zeros((1, 3))])
    dest = src.new_empty((rows, 3))
    for r0 in range(0, rows, step):
        sl = ids[r0:r0 + step].long()
        dest[r0:r0 + step] = src_ext[torch.where(sl < 0, miss_row, sl)].sum(1)
    return dest


def _check(src: torch.Tensor, ids: torch.Tensor):
    if src.dim() != 2 or src.shape[1] != 3 or src.dtype != torch.float32:
        raise ValueError(f"src must be float32 [total, 3], got "
                         f"{src.dtype} {tuple(src.shape)}")
    if ids.dim() != 2 or ids.dtype != torch.int32:
        raise ValueError(f"ids must be int32 [rows, rays], got "
                         f"{ids.dtype} {tuple(ids.shape)}")
    if src.device != ids.device:
        raise ValueError(f"src on {src.device}, ids on {ids.device}")
    if not (src.is_contiguous() and ids.is_contiguous()):
        raise ValueError("src and ids must be contiguous")
    if ids.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {ids.device}")
    if src.shape[0] >= 2**31 - 1 or max(ids.shape) >= 2**31:
        raise ValueError(f"src {tuple(src.shape)}, ids {tuple(ids.shape)}: "
                         f"past 32-bit indices")


def relax_gather(src: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """dest [rows, 3] f32 with dest[r] = sum_j src[ids[r, j]], src [total,
    3] f32 and ids [rows, rays] int32 contiguous on one device, an id of -1
    adding zero.

    CUDA tensors launch `csrc/relax_gather.cu` once, a block a row, on the
    current stream; a failed launch raises. The sums over a row run in
    another order than the plain version's. CPU tensors run the plain
    version."""
    _check(src, ids)
    if ids.device.type == "cpu":
        return relax_gather_plain(src, ids)
    rows, rays = ids.shape
    total = src.shape[0]
    src4 = src.new_zeros((total + 1, 4))
    src4[:total, :3] = src
    dest = src.new_empty((rows, 3))
    launch("fm_relax_gather", ids.device, src4.data_ptr(), ids.data_ptr(),
           dest.data_ptr(), rows, rays, total)
    relax_gather.launches += 1
    return dest


relax_gather.launches = 0
