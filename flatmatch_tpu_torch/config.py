"""Typed configuration for the TPU-native flatmatch global-illumination framework.

Every compile-time constant scattered through the reference renderer is lifted
into one frozen dataclass (reference citations per field):

  - mode selection            main.c:14,29
  - lightmap density          main.c:44, rectangle.c:31-42
  - photon budget             main.c:58
  - bounce depth / RR / tint  photonmap.cl:171,236-254
  - emitter colors            photonmap.cl:167-169
  - exposure                  main.c:73-77
  - scene heights             parseLayout.c:26-29
  - collision dilation        parseLayout.c:616
  - light placement           parseLayout.c:240,266-270
  - AO constants              photonmap.c:450-475
  - radiosity constants       radiosityNative.c:102,135-147,230
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class Engine(enum.Enum):
    """Interchangeable illumination engines (reference MODE enum, main.c:14)."""

    PHOTON_XLA = "photon_xla"        # production TPU path (XLA bounce loop)
    PHOTON_PALLAS = "photon_pallas"  # fused Pallas megakernel
    PHOTON_ORACLE = "photon_oracle"  # NumPy CPU oracle (shares RNG with XLA path)
    AMBIENT_OCCLUSION = "ambient_occlusion"
    RADIOSITY = "radiosity"


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """Layout-parsing and geometry constants."""

    scale_px_per_m: float = 30.0          # main.c:32
    tile_size: float = 200.0              # texels per m^2, main.c:44
    height: float = 2.60                  # parseLayout.c:26
    door_height: float = 2.00             # parseLayout.c:27
    window_low: float = 0.85              # parseLayout.c:28
    window_high: float = 2.30             # parseLayout.c:29
    box_margin: float = 0.2               # parseLayout.c:79,104
    collision_dilate_radius: int = 5      # parseLayout.c:616
    light_edge_divisor: float = 9.0       # parseLayout.c:266
    light_z_offset: float = 0.001         # parseLayout.c:279 (HEIGHT-0.001)
    texel_cap_bytes: int = 1000 * 1000 * 1000  # parseLayout.c:520
    write_filled_debug_png: bool = False  # parseLayout.c:314 always writes; opt-in here


@dataclasses.dataclass(frozen=True)
class PhotonConfig:
    """Photon-mapping physics + batching. Physics mirrors photonmap.cl."""

    samples_per_area: float = 1e8         # photons per m^2 of emitter, main.c:58
    max_depth: int = 8                    # photonmap.cl:171
    rr_mirror_prob: float = 0.75          # photonmap.cl:236
    mirror_z_threshold: float = 0.0005    # photonmap.cl:236 (floor is reflective)
    floor_tint_z_threshold: float = 1e-5  # photonmap.cl:241
    albedo: float = 0.9                   # photonmap.cl:249
    floor_tint: Tuple[float, float, float] = (1.0, 0.85, 0.7)  # photonmap.cl:244-247
    window_color: Tuple[float, float, float] = (18.0, 18.0, 18.0)  # photonmap.cl:168
    light_color: Tuple[float, float, float] = (16.0, 16.0, 18.0)   # photonmap.cl:169
    self_intersect_eps: float = 1e-5      # photonmap.cl:181,261
    exposure: float = 0.35                # main.c:77
    # TPU batching (no reference analog: replaces the OpenCL chunked enqueue
    # loop, global_illumination_cl.c:246-267)
    photons_per_batch: int = 1 << 17
    seed: int = 0
    # Deposit splat for the Pallas engines: "inkernel" = the one-hot MXU
    # binning runs INSIDE the wide trace kernel against a VMEM-resident
    # accumulator (deposits never touch HBM; splat MXU work overlaps trace
    # VPU work — fastest, wide engine only), "fused" = separate Pallas
    # one-hot MXU binning pass (colors quantize to bf16 once, far below MC
    # noise, same as inkernel), "fused_i8" = the same pass at int8 MXU
    # rate (2x bf16 on v5e): colors quantize to a 7-bit grid with
    # deterministic unbiased dithering, binning is exact int32 — the extra
    # quantization noise is MC-noise-level (gated vs the f32 splat in
    # tests), "inkernel_i8" = the in-kernel binning at int8 rate (same
    # quantization; the splat MXU work overlaps the trace VPU work inside
    # one instruction stream), "bucket" = XLA one-hot binning,
    # "bucket_exact" = two-pass f32-precision binning, "scatter" = XLA
    # scatter-add (exact, slow — the XLA engine always uses this).
    splat: str = "fused"
    # Wide-Pallas engine only: generate uniforms inside the kernel with a
    # murmur3-fmix32 counter hash over (photon id, draw, batch seed) — the
    # analog of the reference kernel's in-register LCG (photonmap.cl:21-25)
    # — instead of a precomputed threefry tensor. (Not the pltpu hardware
    # PRNG: that returns zeros under interpret mode, so it can't be gated.)
    # Deterministic per (seed, batch, device); parity vs the other engines
    # becomes statistical, like the reference's CL-vs-native pair.
    device_rng: bool = False
    # Checkpoint/segment granularity for the photon engines, in batches
    # (engines/schedule.py run_schedule; part of the resume fingerprint).
    # No reference analog — the reference has no checkpointing at all
    # (SURVEY.md §5 "Checkpoint / resume: none").
    checkpoint_every: int = 64


@dataclasses.dataclass(frozen=True)
class AoConfig:
    """Ambient occlusion (photonmap.c:436-491)."""

    geosphere_level: int = 4              # photonmap.c:450 (geoSphere4, 481 dirs)
    sky_distance: float = 10.0            # photonmap.c:465
    normalization: float = 1.5            # photonmap.c:473
    texels_per_chunk: int = 512           # TPU batching knob
    # in-kernel ray synthesis (ao_pallas.render_ao_fused): constant HBM
    # footprint in scene size. PRODUCTION DEFAULT since round 5: at
    # steady state (in-program repetition) it measures 27.6 ms/pass vs
    # the chunked pass's 47.6 ms on example.png/v5e — the round-4
    # "at parity" read was a dispatch-noise artifact. Used single-chip
    # (ao_pallas.render_ao_fused) and sharded (mesh.render_ao_fused_sharded);
    # --ao-chunked opts out.
    fused: bool = True


@dataclasses.dataclass(frozen=True)
class RadiosityConfig:
    """Monte-Carlo radiosity (radiosityNative.c)."""

    rays_per_texel: int = 10000           # radiosityNative.c:147
    iterations: int = 7                   # radiosityNative.c:230
    reflectance: float = 0.3              # radiosityNative.c:102
    window_emission: Tuple[float, float, float] = (30.0, 30.0, 30.0)  # :139
    light_emission: Tuple[float, float, float] = (28.0, 28.0, 32.0)   # :142
    seed: int = 0
    texels_per_chunk: int = 512


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Top-level configuration for a render run."""

    # default = the fast device path, like the reference's hard-coded
    # PHOTON_CL (main.c:29); off-TPU it falls back to the XLA engine with
    # a warning (render.py:84-91), mirroring the reference's CPU build
    engine: Engine = Engine.PHOTON_PALLAS
    scene: SceneConfig = dataclasses.field(default_factory=SceneConfig)
    photon: PhotonConfig = dataclasses.field(default_factory=PhotonConfig)
    ao: AoConfig = dataclasses.field(default_factory=AoConfig)
    radiosity: RadiosityConfig = dataclasses.field(default_factory=RadiosityConfig)

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = RenderConfig()
