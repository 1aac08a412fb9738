"""Top-level render pipeline: layout PNG -> collision map JSON -> scene
compile -> geometry JSON -> illumination engine -> per-wall lightmap tiles
(main.c:17-101).

Counterpart of flatmatch_tpu/render.py for four engines: the photon render
(photon_pallas and photon_xla, then exposure normalization), ambient
occlusion and radiosity (`run_engine` says which route runs where).
Every function that touches tensors takes an explicit `device`.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Optional

import numpy as np

from .config import DEFAULT_CONFIG, Engine, RenderConfig
from .engines.photon_wide import unsupported
from .io import tiles as tiles_io
from .ops.device_scene import exposure_scale, pack_emitters
from .scene import collision, geometry, image as im, layout

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


def run_engine(scene: geometry.Scene, cfg: RenderConfig,
               device="cuda") -> np.ndarray:
    """Run `cfg.engine` on `device` and return the [num_texels, 3] arena
    (main.c:60-79), dispatching as flatmatch_tpu/render.py:146-261 does on
    a TPU:

    - photon_pallas: the axis-aligned engine (engines/photon_wide.py) with
      every splat (`inkernel_i8`, `inkernel`, `fused`, `fused_i8`,
      `scatter`, `bucket`, `bucket_exact`) at either draw source; on a
      scene that `pack_aa` gives no table, the narrow kernel
      (engines/photon_narrow.py); on an arena of 2^24 texels or more, the
      general engine;
    - photon_xla: the general engine (engines/photon.py);
    - ambient_occlusion: fused by default, chunked with cfg.ao.fused off;
      on a scene without a table, the general AO (engines/ao_general.py);
    - radiosity, on scenes with a table.

    The general engines draw threefry and splat exactly whatever cfg.splat
    and cfg.device_rng say, as in the JAX package. The photon engines'
    arenas get the exposure normalization. No engine falls back to another
    device: only a kernel's plain version runs, for CPU tensors."""
    from .engines import photon_wide
    from .ops import aa_scene
    from .ops.device_scene import pack_rects
    from .utils.progress import warn

    if cfg.engine is Engine.AMBIENT_OCCLUSION:
        from .engines import ao

        aa = aa_scene.pack_aa(scene.walls, device=device)
        if aa is None:
            from .engines import ao_general

            return ao_general.render_ao(
                scene, pack_rects(scene.walls, device=device), cfg.ao)
        if cfg.ao.fused:
            return ao.render_ao_fused(scene, aa, cfg.ao)
        return ao.render_ao(scene, aa, cfg.ao)
    if cfg.engine is Engine.RADIOSITY:
        from .engines import radiosity

        return radiosity.render_radiosity(scene, cfg.radiosity, device)
    if cfg.engine not in (Engine.PHOTON_PALLAS, Engine.PHOTON_XLA):
        raise unsupported(f"engine {cfg.engine.value!r}")
    emitters = pack_emitters(
        scene, cfg.photon.samples_per_area, cfg.photon.window_color,
        cfg.photon.light_color, device=device,
    )
    use_pallas = cfg.engine is Engine.PHOTON_PALLAS
    if use_pallas and scene.num_texels >= aa_scene.MAX_TEXELS:
        warn("texel arena exceeds 2^24 (f32-exact kernel ids); using the "
             "general engine")
        use_pallas = False
    aa = aa_scene.pack_aa(scene.walls, device=device) if use_pallas else None
    if use_pallas and aa is not None:
        lightmap = photon_wide.render_photons(
            emitters, scene.num_texels, cfg.photon, aa)
    else:
        rects = pack_rects(scene.walls, device=device)
        if use_pallas:
            from .engines import photon_narrow

            warn("scene has non-axis-aligned rects; wide AA engine "
                 "unavailable")
            lightmap = photon_narrow.render_photons(
                rects, emitters, scene.num_texels, cfg.photon)
        else:
            from .engines import photon

            lightmap = photon.render_photons(
                rects, emitters, scene.num_texels, cfg.photon)
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
    dump_raw: bool = False,
    dilate_seams: bool = False,
    supersample: int = 1,
) -> RenderResult:
    """Full pipeline, `./globalIllumination <png> <scale>`.

    `dump_raw=True` also writes tiles/tile_<i>.raw float32 dumps with
    TileMetadata headers (rectangle.c:391-429). `supersample=N` renders at
    N^2 x the texel density and box-averages down before tone mapping."""
    cfg = cfg or DEFAULT_CONFIG
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    scene, collision_json = compile_scene(layout_png, scale, cfg)
    geo_json = geometry.geometry_json(scene)
    (out / "collisionMap.json").write_text(collision_json)
    (out / "geometry.json").write_text(geo_json)

    lay = scene.layout
    print(
        f"[INF] Layout consists of {len(lay.walls)} walls "
        f"({scene.num_texels / 1000.0:.2f}k texels) "
        f"{len(lay.windows)} windows, {len(lay.lights)} lights"
    )

    ss = int(supersample)
    if ss > 1:
        scene_ss = supersampled_scene(scene, ss, cfg)
        texels_ss = run_engine(scene_ss, cfg, device)
        texels = downsample_supersampled(scene, scene_ss, texels_ss, ss)
    else:
        texels = run_engine(scene, cfg, device)
    # tintExtra for AO and radiosity, not the photon path (main.c:88-91)
    tint_extra = cfg.engine in (Engine.AMBIENT_OCCLUSION, Engine.RADIOSITY)
    tile_paths = tiles_io.save_tiles(
        scene.walls, texels, str(out / "tiles"), tint_extra, dilate_seams
    )
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
