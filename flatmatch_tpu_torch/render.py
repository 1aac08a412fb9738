"""Top-level render pipeline: layout PNG -> collision map JSON -> scene
compile -> geometry JSON -> illumination engine -> per-wall lightmap tiles
(main.c:17-101).

Counterpart of flatmatch_tpu/render.py for every engine: the photon render
(photon_pallas, photon_xla and the NumPy photon_oracle, then exposure
normalization), ambient occlusion and radiosity (`run_engine` says which
route runs where), with
the photon engines' checkpoint and resume and progressive previews, and
the sharded engines of parallel/mesh.py where a mesh is given or found
(`run_engine(mesh="auto")`). Every function that touches tensors takes an
explicit `device`. In a render spread over several processes
(parallel/multihost.py) every process compiles the scene and runs its
shards, and only the primary writes the artifacts.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Optional

import numpy as np

from .config import DEFAULT_CONFIG, Engine, RenderConfig
from .io import tiles as tiles_io
from .ops.device_scene import exposure_scale, pack_emitters
from .scene import collision, geometry, image as im, layout
from .utils.spans import span

f32 = np.float32


@dataclasses.dataclass
class RenderResult:
    scene: geometry.Scene
    texels: np.ndarray          # [num_texels, 3] float32, post-normalization
    tile_paths: list
    geometry_json: str
    collision_json: str


def compile_scene(layout_png: str, scale: float, cfg: RenderConfig):
    """Layout PNG -> compiled scene + collision JSON (main.c:33-52)."""
    with span("scene.build"):
        img = im.load_layout(layout_png)
        collision_json = collision.build_collision_map(img, cfg.scene)
        lay = layout.parse_layout(
            img, f32(1.0) / f32(scale), cfg.scene.tile_size, cfg.scene
        )
        return geometry.Scene(lay), collision_json


def supersampled_scene(
    scene: geometry.Scene, ss: int, cfg: RenderConfig
) -> geometry.Scene:
    """Twin of `scene` whose wall tile grids are exactly ss x in each
    dimension, with the texel arena re-laid-out to match. ss must be a
    power of two so the grids keep the power-of-two mipmap invariant
    (rectangle.c:176-186)."""
    from .scene.rectangle import num_mipmap_texels

    if ss < 1 or (ss & (ss - 1)):
        raise ValueError(f"supersample must be a power of two >= 1, got {ss}")
    lay = scene.layout
    walls = []
    total = 0
    for r in lay.walls:
        r2 = dataclasses.replace(
            r, wtiles=r.wtiles * ss, htiles=r.htiles * ss, base=total
        )
        total += num_mipmap_texels(r2)
        walls.append(r2)
    layout.check_texel_cap(total, cfg.scene, context=f"supersample={ss}: ")
    lay2 = dataclasses.replace(lay, walls=walls, num_texels=total)
    return geometry.Scene(lay2)


def downsample_supersampled(
    scene, scene_ss, texels_ss: np.ndarray, ss: int
) -> np.ndarray:
    """Box-average an ss x-supersampled render down to `scene`'s texel grid,
    excluding sub-texels that are zero in any channel
    (imageProcessing.c:145-184)."""
    from .scene.rectangle import num_tiles

    out = np.zeros((scene.num_texels, 3), np.float32)
    for r, r2 in zip(scene.walls, scene_ss.walls):
        if (r2.wtiles, r2.htiles) != (r.wtiles * ss, r.htiles * ss):
            raise ValueError(
                f"supersample={ss}: wall tile grid {r.wtiles}x{r.htiles} "
                f"did not scale to {r2.wtiles}x{r2.htiles}"
            )
        block = texels_ss[r2.base : r2.base + num_tiles(r2)].reshape(
            r.htiles, ss, r.wtiles, ss, 3
        )
        lit = np.all(block != 0.0, axis=-1, keepdims=True)
        count = lit.sum(axis=(1, 3))
        total = np.where(lit, block, 0.0).sum(axis=(1, 3))
        avg = np.divide(
            total, count, out=np.zeros_like(total), where=count > 0
        )
        out[r.base : r.base + num_tiles(r)] = avg.reshape(-1, 3)
    return out


def _auto_devices(device):
    """This process's shard devices under the automatic mesh, or None for
    the single-device engines (flatmatch_tpu/render.py:113-126). In a
    group of more than one process, one shard a process: on
    cuda:LOCAL_RANK when torchrun set LOCAL_RANK and `device` names no
    card, else on `device`. In one process, one shard on every visible
    card when there is more than one."""
    import os

    import torch

    from .parallel import multihost

    dev = torch.device(device)
    if multihost.process_count() > 1:
        local = os.environ.get("LOCAL_RANK")
        if dev.type == "cuda" and dev.index is None and local is not None:
            dev = torch.device("cuda", int(local))
        return [dev]
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return None


def _auto_mesh(device):
    """The mesh over `_auto_devices(device)`, or None."""
    from .parallel.mesh import photon_mesh

    devices = _auto_devices(device)
    return None if devices is None else photon_mesh(devices)


def run_engine(scene: geometry.Scene, cfg: RenderConfig,
               device="cuda", checkpoint_path: Optional[str] = None,
               on_segment=None, mesh="auto") -> np.ndarray:
    """Run `cfg.engine` on `device` and return the [num_texels, 3] arena
    (main.c:60-79), dispatching as flatmatch_tpu/render.py:146-261 does on
    a TPU. `mesh`: "auto" shards over every visible card, or every
    process, when there is more than one (`_auto_mesh`); None runs one
    device; a parallel/mesh.PhotonMesh pins the shards, whose first
    device then stands for `device`. Under a mesh the photon engines, the
    axis-aligned AO and radiosity run sharded (parallel/mesh.py,
    engines/radiosity.render_radiosity_sharded); the general AO and
    photon_oracle run on one device, as in the JAX package:

    - photon_pallas: the axis-aligned engine (engines/photon_wide.py) with
      every splat (`inkernel_i8`, `inkernel`, `fused`, `fused_i8`,
      `scatter`, `bucket`, `bucket_exact`) at either draw source; on a
      scene that `pack_aa` gives no table, the narrow kernel
      (engines/photon_narrow.py); on an arena of 2^24 texels or more, the
      general engine;
    - photon_xla: the general engine (engines/photon.py);
    - photon_oracle: the NumPy oracle on the host
      (engines/photon_oracle_driver.py), on the general engine's draws,
      made on `device`;
    - ambient_occlusion: fused by default, chunked with cfg.ao.fused off;
      on a scene without a table, the general AO (engines/ao_general.py);
    - radiosity: the axis-aligned form factors on a scene with a table,
      the general ones (csrc/general_nearest.cu) on any other.

    Under a mesh, photon_pallas on a scene without a table runs the
    sharded general engine, not the narrow kernel
    (flatmatch_tpu/render.py:185-202).

    The general engines draw threefry and splat exactly whatever cfg.splat
    and cfg.device_rng say, as in the JAX package. The photon engines'
    arenas get the exposure normalization. No engine falls back to another
    device: only a kernel's plain version runs, for CPU tensors.

    Photon engines only: `checkpoint_path` checkpoints the render and
    resumes it bit-identically, and `on_segment(raw_lightmap,
    photons_done, photons_total)` fires after every dispatch segment with
    the un-normalized lightmap (engines/schedule.py). The other engines
    warn and ignore `checkpoint_path`.

    Under a recording torch.profiler the call is the span `engine.run`
    (utils/spans.py), its table packing `engine.tables`, the photon
    arena's copy to the host with the exposure scale `engine.readback`,
    and the engines' steps spans of their own."""
    from .engines import photon_wide
    from .ops import aa_scene
    from .ops.device_scene import pack_rects
    from .parallel import mesh as pmesh
    from .utils.progress import info, warn

    with span("engine.run"):
        if mesh == "auto":
            mesh = _auto_mesh(device)
        if mesh is not None:
            device = mesh.devices[0]
            shards = (f"{mesh.size} shards ({mesh.local_count} here, "
                      f"{mesh.process_count} processes)")
        photon_engine = cfg.engine in (Engine.PHOTON_PALLAS,
                                       Engine.PHOTON_XLA)
        if checkpoint_path is not None and not photon_engine:
            warn("--checkpoint applies to the photon engines only; ignored")
        if cfg.engine is Engine.AMBIENT_OCCLUSION:
            from .engines import ao

            with span("engine.tables"):
                aa = aa_scene.pack_aa(scene.walls, device=device)
            if aa is None:
                from .engines import ao_general

                with span("engine.tables"):
                    rects = pack_rects(scene.walls, device=device)
                return ao_general.render_ao(scene, rects, cfg.ao)
            if mesh is not None:
                kind = "fused" if cfg.ao.fused else "chunked"
                info(f"sharded {kind} AO engine over {shards}")
                render_ao = (pmesh.render_ao_fused_sharded if cfg.ao.fused
                             else pmesh.render_ao_sharded)
                return render_ao(scene, aa, cfg.ao, mesh)
            if cfg.ao.fused:
                return ao.render_ao_fused(scene, aa, cfg.ao)
            return ao.render_ao(scene, aa, cfg.ao)
        if cfg.engine is Engine.RADIOSITY:
            from .engines import radiosity

            if mesh is not None:
                info(f"sharded radiosity engine over {shards} (ray axis)")
                return radiosity.render_radiosity_sharded(
                    scene, cfg.radiosity, mesh)
            return radiosity.render_radiosity(scene, cfg.radiosity, device)
        if cfg.engine is Engine.PHOTON_ORACLE:
            from .engines import photon_oracle_driver

            lightmap = photon_oracle_driver.render_photons_np(
                scene, cfg.photon, device)
            scale = exposure_scale(
                scene, cfg.photon.samples_per_area, cfg.photon.exposure
            )
            return lightmap * scale[:, None]
        if not photon_engine:
            raise ValueError(f"unknown engine {cfg.engine}")
        with span("engine.tables"):
            emitters = pack_emitters(
                scene, cfg.photon.samples_per_area, cfg.photon.window_color,
                cfg.photon.light_color, device=device,
            )
            use_pallas = cfg.engine is Engine.PHOTON_PALLAS
            if use_pallas and scene.num_texels >= aa_scene.MAX_TEXELS:
                warn("texel arena exceeds 2^24 (f32-exact kernel ids); "
                     "using the general engine")
                use_pallas = False
            aa = (aa_scene.pack_aa(scene.walls, device=device)
                  if use_pallas else None)
            rects = (None if use_pallas and aa is not None
                     else pack_rects(scene.walls, device=device))
        if mesh is not None:
            if use_pallas and aa is not None:
                info(f"sharded wide photon engine over {shards}")
                lightmap = pmesh.render_photons_sharded_wide(
                    emitters, scene.num_texels, cfg.photon, aa, mesh,
                    checkpoint_path=checkpoint_path, on_segment=on_segment)
            else:
                if use_pallas:
                    warn("scene has non-axis-aligned rects; wide AA engine "
                         "unavailable")
                info(f"sharded general photon engine over {shards}")
                lightmap = pmesh.render_photons_sharded(
                    rects, emitters, scene.num_texels, cfg.photon, mesh,
                    checkpoint_path=checkpoint_path, on_segment=on_segment)
        elif use_pallas and aa is not None:
            lightmap = photon_wide.render_photons(
                emitters, scene.num_texels, cfg.photon, aa,
                checkpoint_path=checkpoint_path, on_segment=on_segment)
        elif use_pallas:
            from .engines import photon_narrow

            warn("scene has non-axis-aligned rects; wide AA engine "
                 "unavailable")
            lightmap = photon_narrow.render_photons(
                rects, emitters, scene.num_texels, cfg.photon,
                checkpoint_path=checkpoint_path, on_segment=on_segment)
        else:
            from .engines import photon

            lightmap = photon.render_photons(
                rects, emitters, scene.num_texels, cfg.photon,
                checkpoint_path=checkpoint_path, on_segment=on_segment)
        with span("engine.readback"):
            scale = exposure_scale(
                scene, cfg.photon.samples_per_area, cfg.photon.exposure
            )
            return lightmap.cpu().numpy() * scale[:, None]


def render(
    layout_png: str,
    out_dir: str = ".",
    scale: float = 30.0,
    cfg: Optional[RenderConfig] = None,
    device="cuda",
    checkpoint_path: Optional[str] = None,
    preview: bool = False,
    dump_raw: bool = False,
    dilate_seams: bool = False,
    supersample: int = 1,
    mesh="auto",
) -> RenderResult:
    """Full pipeline, `./globalIllumination <png> <scale>`.

    `dump_raw=True` also writes tiles/tile_<i>.raw float32 dumps with
    TileMetadata headers (rectangle.c:391-429). `supersample=N` renders at
    N^2 x the texel density and box-averages down before tone mapping.
    `checkpoint_path` (photon engines) checkpoints the render and resumes
    an interrupted one bit-identically. `preview=True` (photon engines)
    re-writes the tiles after every dispatch segment, exposure-scaled by
    the traced-so-far fraction so that their brightness is final from the
    first preview (the browser port's incremental lightmaps,
    worker.js:43-60); it is ignored with a warning under `supersample`.
    `mesh` passes to `run_engine`. In a render spread over several
    processes every process compiles the scene and runs its shards, and
    only the primary writes the collision map, the geometry, the tiles,
    the previews and the raw dumps (flatmatch_tpu/render.py:311-330);
    the others return their texels with no tile paths."""
    from .parallel import multihost
    from .utils.progress import warn

    cfg = cfg or DEFAULT_CONFIG
    primary = multihost.is_primary()
    out = pathlib.Path(out_dir)
    if primary:
        out.mkdir(parents=True, exist_ok=True)

    scene, collision_json = compile_scene(layout_png, scale, cfg)
    geo_json = geometry.geometry_json(scene)
    if primary:
        (out / "collisionMap.json").write_text(collision_json)
        (out / "geometry.json").write_text(geo_json)

    lay = scene.layout
    if primary:
        print(
            f"[INF] Layout consists of {len(lay.walls)} walls "
            f"({scene.num_texels / 1000.0:.2f}k texels) "
            f"{len(lay.windows)} windows, {len(lay.lights)} lights"
        )

    # tintExtra for AO and radiosity, not the photon path (main.c:88-91)
    tint_extra = cfg.engine in (Engine.AMBIENT_OCCLUSION, Engine.RADIOSITY)
    on_segment = None
    photon_engine = cfg.engine in (Engine.PHOTON_XLA, Engine.PHOTON_PALLAS)
    ss = int(supersample)
    if ss > 1 and preview:
        warn("--preview is unsupported with --supersample; ignored")
        preview = False
    if preview and photon_engine:
        full_scale = exposure_scale(
            scene, cfg.photon.samples_per_area, cfg.photon.exposure
        )

        # every process segments the render alike (its combines are
        # collectives); only the primary writes the previews
        def on_segment(raw_lm, done, total):
            if not primary:
                return
            # scale the partial lightmap as if `done` were the whole
            # budget: the brightness is right at once, the noise converges
            part = raw_lm.cpu().numpy() * (
                full_scale[:, None] * (total / max(done, 1))
            )
            tiles_io.save_tiles(
                scene.walls, part, str(out / "tiles"), tint_extra,
                dilate_seams,
            )
            print(f"[INF] preview tiles at {done}/{total} photons")
    elif preview and primary:
        warn("--preview applies to the photon engines only; ignored")

    if ss > 1:
        scene_ss = supersampled_scene(scene, ss, cfg)
        texels_ss = run_engine(scene_ss, cfg, device, checkpoint_path,
                               mesh=mesh)
        texels = downsample_supersampled(scene, scene_ss, texels_ss, ss)
    else:
        texels = run_engine(scene, cfg, device, checkpoint_path, on_segment,
                            mesh=mesh)
    tile_paths = []
    if primary:
        tile_paths = tiles_io.save_tiles(
            scene.walls, texels, str(out / "tiles"), tint_extra,
            dilate_seams)
        if dump_raw:
            for i, r in enumerate(scene.walls):
                tiles_io.save_tile_raw(
                    r, texels, str(out / "tiles" / f"tile_{i}.raw")
                )
    return RenderResult(
        scene=scene,
        texels=texels,
        tile_paths=tile_paths,
        geometry_json=geo_json,
        collision_json=collision_json,
    )
