"""The per-emitter photon schedule of the general engines.

Counterpart of flatmatch_tpu/engines/schedule.py (`emitter_slice`,
`run_schedule`): every window emitter, then every lamp
(global_illumination_cl.c:304-308), each with numSamples = samplesPerArea *
area photons in batches of a fixed size B with a masked tail (no shorter
tail batch), batch i of an emitter drawing the threefry uniforms of global
batch base_batch + i (uniform(fold_in(PRNGKey(seed), base_batch + i), (B,
U)), `ops/threefry.batch_uniforms`). `photon_wide.emitter_schedule` gives
those base batches: an emitter with no photons takes none, as in the JAX
package. Checkpoints and progressive previews (`checkpoint_path`,
`on_segment`) are not ported.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..config import PhotonConfig
from ..ops import threefry
from ..ops.device_scene import Emitters
from .photon import EmitterSlice
from .photon_wide import (
    emitter_schedule, schedule_batches, uniforms_per_photon, unsupported,
)


def emitter_slice(emitters: Emitters, e: int) -> EmitterSlice:
    """Emitter e's fields as the general engine's EmitterSlice."""
    return EmitterSlice(
        pos=emitters.pos[e], wvec=emitters.wvec[e], hvec=emitters.hvec[e],
        n=emitters.n[e], color=emitters.color[e],
        is_window=emitters.is_window[e],
    )


def run_schedule(trace: Callable, emitters: Emitters, num_texels: int,
                 cfg: PhotonConfig, transposed: bool = False,
                 checkpoint_path: Optional[str] = None,
                 on_segment: Optional[Callable] = None) -> torch.Tensor:
    """Run the whole emitter schedule into a fresh f32 [num_texels, 3]
    lightmap on the emitters' device and return it, raw (un-normalized).
    trace(lightmap, e, uniforms, n_valid) adds one batch of emitter e into
    the lightmap in place; `uniforms` are its [B, U] threefry draws, or
    their [U, B] transpose with `transposed`."""
    if checkpoint_path is not None:
        raise unsupported("--checkpoint (ROADMAP.md queue 1 item 5)")
    if on_segment is not None:
        raise unsupported("--preview (ROADMAP.md queue 1 item 5)")
    B = int(cfg.photons_per_batch)
    if B < 1:
        raise ValueError(f"photons_per_batch must be >= 1, got {B}")
    dev = emitters.pos.device
    U = uniforms_per_photon(cfg.max_depth)
    lightmap = torch.zeros((int(num_texels), 3), dtype=torch.float32,
                           device=dev)
    for e, gb, n_valid, _ in schedule_batches(
            emitter_schedule(emitters.counts, B), B, tail_shrink=False):
        u = threefry.batch_uniforms(cfg.seed, gb, B, U, dev,
                                    transposed=transposed)
        trace(lightmap, e, u, n_valid)
    return lightmap
