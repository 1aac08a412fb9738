"""The per-emitter photon schedule, with checkpoint and resume.

Counterpart of flatmatch_tpu/engines/schedule.py (`emitter_slice`,
`run_schedule`): every window emitter, then every lamp
(global_illumination_cl.c:304-308), each with numSamples = samplesPerArea *
area photons in batches of B, batch i of an emitter being global batch
base_batch + i (`photon_wide.emitter_schedule`; an emitter with no photons
takes none). Every photon engine of the port runs this one loop: the wide
engine's step traces a batch on the counter hash or threefry uniforms, the
general engines' steps draw threefry (`threefry_step`).

Each emitter's batches run in segments of `cfg.checkpoint_every`. With
`checkpoint_path` the lightmap and the cursor are saved after every
segment, and a run finds its cursor there and resumes; `on_segment` sees
the lightmap after every segment (the progressive previews). The draws
depend only on the global batch and each batch is added in a fixed order
with exact sums, so a segmented, checkpointed or resumed run ends on the
straight run's bits. A run with neither makes no host sync in its loop.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from ..config import PhotonConfig
from ..ops import threefry
from ..ops.device_scene import Emitters
from ..utils.spans import span
from .photon import EmitterSlice
from .photon_wide import (
    emitter_schedule, schedule_batches, uniforms_per_photon,
)

# step(lightmap, e, global_batch, n_valid, batch_size) adds one batch of
# emitter e, `batch_size` photons of which the first `n_valid` are live, into
# the lightmap in place
Step = Callable[[torch.Tensor, int, int, int, int], None]


def emitter_slice(emitters: Emitters, e: int) -> EmitterSlice:
    """Emitter e's fields as the general engine's EmitterSlice."""
    return EmitterSlice(
        pos=emitters.pos[e], wvec=emitters.wvec[e], hvec=emitters.hvec[e],
        n=emitters.n[e], color=emitters.color[e],
        is_window=emitters.is_window[e],
    )


def threefry_step(trace: Callable, cfg: PhotonConfig, device,
                  transposed: bool = False) -> Step:
    """The general engines' step: trace(lightmap, e, uniforms, n_valid)
    with the batch's [B, U] threefry draws (uniform(fold_in(PRNGKey(seed),
    global batch), (B, U)), `ops/threefry.batch_uniforms`), or their [U, B]
    transpose."""
    U = uniforms_per_photon(cfg.max_depth)

    def step(lm, e, gb, n_valid, bsz):
        trace(lm, e, threefry.batch_uniforms(cfg.seed, gb, bsz, U, device,
                                             transposed=transposed), n_valid)

    return step


def run_schedule(step: Step, emitters: Emitters, num_texels: int,
                 cfg: PhotonConfig, quantum: Optional[int] = None,
                 checkpoint_path: Optional[str] = None,
                 fingerprint_extra=(),
                 on_segment: Optional[Callable] = None,
                 write_checkpoints: bool = True,
                 end_segment: Optional[Callable] = None) -> torch.Tensor:
    """Run the whole emitter schedule into a fresh f32 [num_texels, 3]
    lightmap on the emitters' device and return it, raw (un-normalized).

    `quantum`: each emitter's tail batch runs at `tail_batch_size` in
    blocks of `quantum` photons; None keeps it at B. cfg.checkpoint_every
    is the segment length, and `fingerprint_extra` names the engine; both
    enter the checkpoint's fingerprint with the batch size and "torch",
    so a checkpoint resumes neither another engine, segmentation or
    batching, nor a render of the JAX package. `on_segment(lightmap, photons_done, photons_total)` fires
    after every segment, photons_done counted as the JAX package counts
    them (whole batches, capped at each emitter's budget).

    A sharded render (parallel/mesh.py) traces each batch into its shards'
    own partials; `end_segment(lightmap)` then adds their combine into the
    lightmap after every segment, before the checkpoint and `on_segment`.
    Every process of a render spread over several loads the checkpoint;
    only the one with `write_checkpoints` writes it.

    Fault injection: with FLATMATCH_FAULT_EXIT_AFTER_CHECKPOINTS=N set, the
    process exits with code 17 after its N-th checkpoint, as a preempted
    host would (the JAX package's drill); every process of a group counts
    the checkpoints, written or not, so all of them stop at the same
    one."""
    from ..utils import checkpoint as ckpt
    from ..utils.progress import info, warn

    B = int(cfg.photons_per_batch)
    if B < 1:
        raise ValueError(f"photons_per_batch must be >= 1, got {B}")
    every = int(cfg.checkpoint_every)
    if every < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got {every}")
    with span("photon.schedule"):
        counts = np.asarray(emitters.counts)
        dev = emitters.pos.device
        lightmap = torch.zeros((int(num_texels), 3), dtype=torch.float32,
                               device=dev)
        resume_e, resume_b = 0, 0
        if checkpoint_path is not None:
            fp = ckpt.config_fingerprint(
                cfg, num_texels, counts,
                extra=(*fingerprint_extra, "torch", B, every))
            state = ckpt.load(checkpoint_path, fp)
            if state is not None:
                arr, resume_e, resume_b = state
                lightmap.copy_(torch.from_numpy(arr))
                info(f"resuming from {checkpoint_path}: emitter {resume_e}, "
                     f"batch {resume_b}")

        total = int(counts.sum())
        done_before = 0     # photons of the emitters finished before this one
        for entry in emitter_schedule(counts, B):
            e, n_batches, n = entry[0], entry[2], int(counts[entry[0]])
            if e < resume_e:
                done_before += n
                continue
            batches = list(schedule_batches([entry], B, quantum is not None,
                                            quantum or 1))
            for off in range(resume_b if e == resume_e else 0, n_batches,
                             every):
                seg = batches[off:off + every]
                for _, gb, n_valid, bsz in seg:
                    step(lightmap, e, gb, n_valid, bsz)
                if end_segment is not None:
                    end_segment(lightmap)
                nxt = off + len(seg)
                if checkpoint_path is not None:
                    cursor = (e, nxt) if nxt < n_batches else (e + 1, 0)
                    if write_checkpoints:
                        with span("photon.checkpoint"):
                            ckpt.save(checkpoint_path,
                                      lightmap.cpu().numpy(), *cursor, fp)
                    kill_after = os.environ.get(
                        "FLATMATCH_FAULT_EXIT_AFTER_CHECKPOINTS")
                    if kill_after is not None:
                        saves = getattr(run_schedule, "_fault_saves", 0) + 1
                        run_schedule._fault_saves = saves
                        if saves >= int(kill_after):
                            warn(f"FAULT INJECTION: exiting after {saves} "
                                 f"checkpoint rounds")
                            os._exit(17)
                if on_segment is not None:
                    on_segment(lightmap, done_before + min(nxt * B, n), total)
            done_before += n
        return lightmap
