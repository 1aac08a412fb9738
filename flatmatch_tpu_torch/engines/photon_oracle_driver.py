"""Full-pipeline NumPy photon render (the PHOTON_ORACLE engine).

Counterpart of flatmatch_tpu/engines/photon_oracle_driver.py: drives
engines/oracle.py over every emitter with exactly the draws of the general
engine (engines/photon.py): the same threefry keys (uniform(fold_in(
PRNGKey(seed), global batch), (B, U))), the same batch layout, so the two
lightmaps agree to float tolerance. The analog of the reference's
PHOTON_NATIVE CPU-oracle mode (main.c:14,62; photonmap.c:408-434). The
draws are made on `device` (csrc/threefry.cu on the card, bit-equal to
jax.random) and read back; the trace runs in NumPy on the host.
"""
from __future__ import annotations

import types

import numpy as np

from ..config import PhotonConfig
from ..ops import threefry
from ..ops.device_scene import pack_emitters, pack_rects
from ..scene.geometry import Scene
from .oracle import trace_batch_np
from .photon_wide import uniforms_per_photon

f32 = np.float32


def render_photons_np(scene: Scene, cfg: PhotonConfig,
                      device="cpu") -> np.ndarray:
    """The raw (un-normalized) [num_texels, 3] lightmap of every window,
    then every light, traced by the NumPy oracle."""
    rects = types.SimpleNamespace(**{
        k: v.numpy() for k, v in pack_rects(scene.walls)._asdict().items()})
    emitters = pack_emitters(
        scene, cfg.samples_per_area, cfg.window_color, cfg.light_color
    )
    lightmap = np.zeros((scene.num_texels, 3), f32)
    B = int(cfg.photons_per_batch)
    U = uniforms_per_photon(cfg.max_depth)
    counts = np.asarray(emitters.counts)
    base_batch = 0
    for e in range(len(counts)):
        n = int(counts[e])
        if n == 0:
            continue
        n_batches = (n + B - 1) // B
        for i in range(n_batches):
            uniforms = threefry.batch_uniforms(
                cfg.seed, base_batch + i, B, U, device).cpu().numpy()
            n_valid = B if i < n_batches - 1 else n - (n_batches - 1) * B
            lightmap = trace_batch_np(
                lightmap,
                rects,
                emitters.pos[e].numpy(),
                emitters.wvec[e].numpy(),
                emitters.hvec[e].numpy(),
                emitters.n[e].numpy(),
                emitters.color[e].numpy(),
                bool(emitters.is_window[e]),
                uniforms,
                n_valid,
                cfg,
            )
        base_batch += n_batches
    return lightmap
