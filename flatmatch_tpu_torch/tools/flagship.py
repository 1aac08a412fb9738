#!/usr/bin/env python3
"""The product's scene without its PNG, and the port's gates on it.

    python -m flatmatch_tpu_torch.tools.flagship [GATE ...] [--device cuda]
        [--out DIR]

The reference ships one input, example.png: 172 walls, 7 windows, 3
lights, 147 box rects and 113,964 texels. `tests/fixtures/example_rects.txt`
holds every rect the scene compiler makes from it, at full precision, with
a header of the counts, the image size and the starting position;
`scene_from_rects` builds the port's Scene from that file (or from any
`*_rects.txt` fixture), so the scene runs without the PNG.

The gates hold the port on that scene against the reference C engine's
dumps, at the bands of the JAX repo's root tools (each gate names its
counterpart); each returns a dict of its figures with `pass`:

- production: the photon render at the CLI's defaults (the wide engine,
  device RNG, the in-kernel 7-bit splat, 131072-photon batches), seed 3,
  300,000 samples per m^2, the raw arena against
  example_photon_native_spa300k.f32;
- i8: 2^24 photons in batches of 2^18 at `fused` (the f32-grade splat),
  then at `fused_i8` and `inkernel_i8` against it;
- ao: the fused and the chunked axis-aligned AO of tiny, mini and the
  flagship against `*_ao_texels.f32`, and the general AO of five flagship
  walls;
- radiosity: 10,000 rays (the production budget) and 2,000, 7 iterations,
  seed 5, against example_radiosity_rays{10000,2000}.f32, with the peak
  device memory of each run;
- render: the product render, `render.run_engine` at the CLI's defaults
  (1e8 samples per m^2) and the export `render.render` runs after it (tone
  mapping, tiles, geometry.json) into DIR, compared in distribution with
  the spa-300k dump once the exposure scale is undone.

With no GATE every gate runs; one JSON line is printed per gate, and the
exit code is 1 if any failed. It imports no JAX and nothing of tests/.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import tempfile
import time

import numpy as np

from ..config import DEFAULT_CONFIG, AoConfig, PhotonConfig, RadiosityConfig
from ..scene.geometry import Scene
from ..scene.layout import ParsedLayout
from ..scene.rectangle import Rect, num_mipmap_texels, num_tiles

f32 = np.float32
FIXTURES = pathlib.Path(__file__).resolve().parents[2] / "tests" / "fixtures"
EXAMPLE_RECTS = FIXTURES / "example_rects.txt"
GROUPS = ("walls", "windows", "lights", "box")

# the reference dump's photon budget (samplesPerArea=300000, srand(12345))
PRODUCTION_SPA = 300000.0
PRODUCTION_SEED = 3
I8_PHOTONS = 1 << 24
I8_BATCH = 1 << 18
# flagship walls of the general AO gate: one per size class (16 to 2048
# tiles), among them the downward door soffit whose grazing rays once
# exposed an intersector fault
AO_WALLS = (147, 164, 38, 88, 154)
RADIOSITY_RAYS = (10000, 2000)
RADIOSITY_SEED = 5


# --------------------------------------------------------------------------
# the loader
# --------------------------------------------------------------------------
def parse_rects(path):
    """(header, groups) of a `*_rects.txt` dump: the header's counts,
    `width` and `height` from size=, `start` from start= as float32; each
    group's rows as dicts of pos, width, height and n (float32, parsed
    straight from the text) and base, wtiles and htiles."""
    header, groups, cur = {}, {}, None
    for line in pathlib.Path(path).read_text().splitlines():
        if line.startswith("# counts"):
            for tok in line.split()[2:]:
                k, v = tok.split("=")
                if k == "size":
                    header["width"], header["height"] = map(int, v.split("x"))
                elif k == "start":
                    header["start"] = tuple(f32(t) for t in v.split(","))
                else:
                    header[k] = int(v)
        elif line.startswith("# "):
            name, _ = line[2:].split()
            cur = groups[name] = []
        elif line.strip():
            vals = line.split()
            cur.append(dict(
                pos=np.array(vals[0:3], f32),
                width=np.array(vals[3:6], f32),
                height=np.array(vals[6:9], f32),
                n=np.array(vals[9:12], f32),
                base=int(vals[12]), wtiles=int(vals[13]),
                htiles=int(vals[14])))
    return header, groups


def scene_from_rects(path) -> Scene:
    """The port's Scene of a `*_rects.txt` dump, its groups in file order.
    Every field comes from the file; base is 0 on windows, lights and box
    rects there, as the scene compiler leaves it. The header's counts and
    texel total must match the rows."""
    header, groups = parse_rects(path)
    rects = {g: [Rect(**row) for row in groups.get(g, [])] for g in GROUPS}
    for g in GROUPS:
        if len(rects[g]) != header[g]:
            raise ValueError(f"{path}: {len(rects[g])} {g} rows, header "
                             f"says {header[g]}")
    total = sum(num_mipmap_texels(r) for r in rects["walls"])
    if total != header["texels"]:
        raise ValueError(f"{path}: the walls hold {total} texels, header "
                         f"says {header['texels']}")
    lay = ParsedLayout(
        **rects, width=header["width"], height=header["height"],
        starting_position=tuple(float(v) for v in header["start"]),
        num_texels=header["texels"])
    return Scene(lay)


def flagship_scene() -> Scene:
    return scene_from_rects(EXAMPLE_RECTS)


def cli_config():
    """The configuration `render layout.png 30` takes with no flags: the
    library defaults with the CLI's device RNG and 7-bit in-kernel splat."""
    return DEFAULT_CONFIG.replace(photon=dataclasses.replace(
        DEFAULT_CONFIG.photon, device_rng=True, splat="inkernel_i8"))


def golden(name: str, num_texels: int) -> np.ndarray:
    """A reference dump (numTexels x float4) as [num_texels, 3]."""
    return np.fromfile(FIXTURES / name, dtype="<f4").reshape(
        num_texels, 4)[:, :3]


# --------------------------------------------------------------------------
# the bands (numpy only)
# --------------------------------------------------------------------------
def _corr(a, b) -> float:
    return float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])


def _wall_slices(scene):
    for r in scene.walls:
        yield r, slice(r.base, r.base + num_tiles(r))


def photon_bands(scene, ours, gold) -> dict:
    """A raw photon arena against the reference engine's at the same
    budget (validate_production_vs_reference.py): energy within 2%, the
    mean of every wall whose gold mean passes a tenth of the texel mean
    within 0.12 (walls of 64 tiles or more) or 0.25, at least 20 such
    walls, texel correlation above 0.98."""
    energy = float(abs(ours.sum() - gold.sum()) / gold.sum())
    worst, walls = 0.0, 0
    for r, sl in _wall_slices(scene):
        o, g = ours[sl].mean(), gold[sl].mean()
        if g > gold.sum() / scene.num_texels * 0.1:
            rtol = 0.12 if num_tiles(r) >= 64 else 0.25
            worst = max(worst, float(abs(o - g) / g / rtol))
            walls += 1
    corr = _corr(ours, gold)
    ok = (bool(np.isfinite(ours).all()) and energy < 0.02 and corr > 0.98
          and worst < 1.0 and walls >= 20)
    return dict(energy_rel_err=energy, texel_corr=corr, walls_checked=walls,
                worst_wall_rel_vs_tolerance=worst, **{"pass": ok})


def i8_bands(out, ref) -> dict:
    """A 7-bit splat's arena against the f32-grade `fused` one
    (validate_i8.py): energy within 5e-3, correlation above 0.9995, mean
    relative error under 0.02 on the texels above the 60th percentile."""
    energy = float(abs(out.sum() - ref.sum()) / ref.sum())
    corr = _corr(out, ref)
    lit = ref.sum(1) > np.percentile(ref.sum(1), 60)
    rel = np.abs(out[lit] - ref[lit]) / np.maximum(ref[lit], 1e-6)
    ok = energy < 5e-3 and corr > 0.9995 and float(rel.mean()) < 0.02
    return dict(energy_rel_err=energy, texel_corr=corr,
                lit_rel_err_mean=float(rel.mean()),
                lit_rel_err_p99=float(np.percentile(rel, 99)),
                **{"pass": bool(ok)})


def ao_bands(scene, ours, gold) -> dict:
    """An axis-aligned AO arena against the reference build's dump
    (ao_hardware_gate.py): on level-0 texels, mean relative error under
    2e-4 and at most 2% of texels with a channel at 5e-4 or more."""
    l0 = scene.level0_mask()
    rel = np.abs(ours[l0] - gold[l0]) / np.maximum(np.abs(gold[l0]), 1e-6)
    frac = float((rel.max(axis=1) >= 5e-4).mean())
    ok = float(rel.mean()) < 2e-4 and frac <= 0.02
    return dict(max_rel=float(rel.max()), mean_rel=float(rel.mean()),
                frac_texels_rel_ge_5e4=frac, **{"pass": bool(ok)})


def ao_wall_bands(scene, ours, gold) -> dict:
    """The general AO on AO_WALLS against the dump (ao_hardware_gate.py):
    the largest relative error of every wall under 1e-4."""
    max_rel = {}
    for wi in AO_WALLS:
        r = scene.walls[wi]
        sl = slice(r.base, r.base + num_tiles(r))
        rel = np.abs(ours[sl] - gold[sl]) / np.maximum(np.abs(gold[sl]),
                                                       1e-6)
        max_rel[str(wi)] = float(rel.max())
    ok = all(v < 1e-4 for v in max_rel.values())
    return dict(max_rel=max_rel, **{"pass": ok})


def radiosity_bands(scene, ours, gold, rays) -> dict:
    """A radiosity arena against the reference engine's dump. At 10,000
    rays (radiosity_hardware_gate.py): energy within 0.01, correlation
    above 0.995, the worst relative error of a wall mean (walls with a
    gold mean above 1e-3) under 0.1. At 2,000
    (test_radiosity_vs_reference.py): energy within 0.02, those wall means
    within 0.08 (64 tiles or more) or 0.2 on at least 5 walls, correlation
    above 0.99."""
    energy = float(abs(ours.sum() - gold.sum()) / gold.sum())
    corr = _corr(ours, gold)
    prod = rays >= 10000
    worst, share, walls = 0.0, 0.0, 0
    for r, sl in _wall_slices(scene):
        o, g = ours[sl].mean(), gold[sl].mean()
        if g > 1e-3:
            rel = float(abs(o - g) / g)
            worst = max(worst, rel)
            share = max(share, rel / (0.08 if num_tiles(r) >= 64 else 0.2))
            walls += 1
    if prod:
        ok = energy < 0.01 and corr > 0.995 and worst < 0.1
    else:
        ok = energy < 0.02 and corr > 0.99 and share < 1.0 and walls >= 5
    ok = ok and bool(np.isfinite(ours).all())
    return dict(rays=rays, energy_rel_err=energy, texel_corr=corr,
                worst_wall_mean_rel=worst, worst_wall_share_of_band=share,
                walls_checked=walls, **{"pass": bool(ok)})


# --------------------------------------------------------------------------
# the gates
# --------------------------------------------------------------------------
def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def production(device="cuda") -> dict:
    """The photon engine at the CLI's production defaults on the flagship
    at the reference dump's budget (validate_production_vs_reference.py,
    without its TPU-only sublanes)."""
    from ..engines import photon_wide
    from ..ops.aa_scene import pack_aa
    from ..ops.device_scene import pack_emitters

    scene = flagship_scene()
    cfg = PhotonConfig(samples_per_area=PRODUCTION_SPA,
                       photons_per_batch=1 << 17, seed=PRODUCTION_SEED,
                       device_rng=True, splat="inkernel_i8")
    em = pack_emitters(scene, PRODUCTION_SPA, cfg.window_color,
                       cfg.light_color, device=device)
    aa = pack_aa(scene.walls, device=device)
    raw, wall = _timed(lambda: photon_wide.render_photons(
        em, scene.num_texels, cfg, aa).cpu().numpy(), device)
    gold = golden("example_photon_native_spa300k.f32", scene.num_texels)
    return dict(gate="production", photons=int(em.counts.sum()),
                wall_s=wall, **photon_bands(scene, raw, gold))


def i8(device="cuda") -> dict:
    """`fused_i8` and `inkernel_i8` against `fused` at I8_PHOTONS photons
    on the flagship (validate_i8.py, without its TPU-only sublanes)."""
    from ..engines import photon_wide
    from ..ops.aa_scene import pack_aa
    from ..ops.device_scene import pack_emitters

    scene = flagship_scene()
    probe = pack_emitters(scene, 1.0, (18, 18, 18), (16, 16, 18))
    spa = I8_PHOTONS / float(probe.area.sum())
    base = PhotonConfig(samples_per_area=spa, photons_per_batch=I8_BATCH,
                        seed=0, device_rng=True, splat="fused")
    em = pack_emitters(scene, spa, base.window_color, base.light_color,
                       device=device)
    aa = pack_aa(scene.walls, device=device)

    def run(splat):
        cfg = dataclasses.replace(base, splat=splat)
        return _timed(lambda: photon_wide.render_photons(
            em, scene.num_texels, cfg, aa).cpu().numpy(), device)

    ref, ref_s = run("fused")
    out = dict(gate="i8", photons=int(em.counts.sum()), fused_wall_s=ref_s)
    ok = True
    for splat in ("fused_i8", "inkernel_i8"):
        got, wall = run(splat)
        out[splat] = dict(wall_s=wall, **i8_bands(got, ref))
        ok = ok and out[splat]["pass"]
    return dict(out, **{"pass": ok})


def ao(device="cuda", scenes=("tiny", "mini", "flagship")) -> dict:
    """The fused and the chunked axis-aligned AO against the reference
    build's dumps on `scenes` (tiny and mini from their PNGs, the flagship
    from the loader), then the general AO of AO_WALLS on the flagship
    (ao_hardware_gate.py)."""
    from ..engines import ao as ao_aa, ao_general
    from ..ops.aa_scene import pack_aa
    from ..ops.device_scene import pack_rects
    from ..render import compile_scene

    cfg = AoConfig()
    out, ok = dict(gate="ao"), True
    for name in scenes:
        if name == "flagship":
            scene, dump = flagship_scene(), "example_ao_texels.f32"
        else:
            scene = compile_scene(str(FIXTURES / f"{name}.png"), 30.0,
                                  DEFAULT_CONFIG)[0]
            dump = f"{name}_ao_texels.f32"
        gold = golden(dump, scene.num_texels)
        aa = pack_aa(scene.walls, device=device)
        for kind, fn in (("fused", ao_aa.render_ao_fused),
                         ("chunked", ao_aa.render_ao)):
            tex, wall = _timed(lambda: fn(scene, aa, cfg), device)
            res = dict(wall_s=wall, **ao_bands(scene, tex, gold))
            out[f"{name}_{kind}"] = res
            ok = ok and res["pass"]
    if "flagship" in scenes:
        scene = flagship_scene()
        tex, wall = _timed(lambda: ao_general.render_ao(
            scene, pack_rects(scene.walls, device=device), cfg,
            list(AO_WALLS)), device)
        res = dict(walls=list(AO_WALLS), wall_s=wall,
                   **ao_wall_bands(scene, tex, golden(
                       "example_ao_texels.f32", scene.num_texels)))
        out["flagship_general"] = res
        ok = ok and res["pass"]
    return dict(out, **{"pass": ok})


def radiosity(device="cuda") -> dict:
    """Radiosity of the flagship at each of RADIOSITY_RAYS, 7 iterations,
    seed 5, against the reference engine's dumps, with the run's peak
    device memory (radiosity_hardware_gate.py, and the flagship case of
    test_radiosity_vs_reference.py)."""
    import torch

    from ..engines import radiosity as rad

    scene = flagship_scene()
    cuda = torch.device(device).type == "cuda"
    out, ok = dict(gate="radiosity"), True
    for n in RADIOSITY_RAYS:
        cfg = RadiosityConfig(rays_per_texel=n, iterations=7,
                              seed=RADIOSITY_SEED)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        tex, wall = _timed(lambda: rad.render_radiosity(scene, cfg, device),
                           device)
        peak = torch.cuda.max_memory_allocated(device) if cuda else None
        res = dict(wall_s=wall, peak_device_bytes=peak, **radiosity_bands(
            scene, tex, golden(f"example_radiosity_rays{n}.f32",
                               scene.num_texels), n))
        out[f"rays{n}"] = res
        ok = ok and res["pass"]
    return dict(out, **{"pass": ok})


def unexposed(scene, texels, samples_per_area, exposure) -> np.ndarray:
    """The raw arena of an exposure-scaled one (render.run_engine's
    scale undone on level-0 texels; mipmap slots, scaled by 0, stay 0)."""
    from ..ops.device_scene import exposure_scale

    scale = exposure_scale(scene, samples_per_area, exposure)
    raw = np.zeros_like(texels)
    lit = scale > 0
    raw[lit] = texels[lit] / scale[lit, None]
    return raw


def product_render(device="cuda", out_dir=None) -> dict:
    """`render layout.png 30` on the flagship with no flags: run_engine at
    the CLI's defaults, then render.render's export (geometry.json and
    the tone-mapped tiles) into `out_dir` (a temporary directory when
    None). Checks 172 tiles, geometry.json byte for byte against the
    fixture, and the arena in distribution against the spa-300k dump: the
    exposure scale undone and the arena scaled by the ratio of the two
    budgets' photon counts, at photon_bands."""
    from ..io import tiles as tiles_io
    from ..ops.device_scene import pack_emitters
    from ..render import run_engine
    from ..scene.geometry import geometry_json

    scene = flagship_scene()
    cfg = cli_config()
    ph = cfg.photon
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(out_dir or tmp)
        out.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        texels, engine_s = _timed(lambda: run_engine(scene, cfg, device),
                                  device)
        geo = geometry_json(scene)
        (out / "geometry.json").write_text(geo)
        paths = tiles_io.save_tiles(scene.walls, texels, str(out / "tiles"),
                                    False, False)
        wall = time.perf_counter() - t0
        tiles = len(list((out / "tiles").glob("tile_*.png")))
        geo_equal = ((out / "geometry.json").read_bytes()
                     == (FIXTURES / "example_geometry.json").read_bytes())
    photons = int(pack_emitters(scene, ph.samples_per_area, ph.window_color,
                                ph.light_color).counts.sum())
    gold_photons = int(pack_emitters(scene, PRODUCTION_SPA, ph.window_color,
                                     ph.light_color).counts.sum())
    raw = unexposed(scene, texels, ph.samples_per_area, ph.exposure)
    bands = photon_bands(scene, raw * f32(gold_photons / photons),
                         golden("example_photon_native_spa300k.f32",
                                scene.num_texels))
    ok = bands.pop("pass") and tiles == len(scene.walls) == len(paths) \
        and geo_equal
    return dict(gate="render", samples_per_area=ph.samples_per_area,
                photons=photons, engine_s=engine_s, wall_s=wall,
                photons_per_s=photons / engine_s, tiles=tiles,
                geometry_json_equal=geo_equal, **bands, **{"pass": ok})


GATES = {"production": production, "i8": i8, "ao": ao,
         "radiosity": radiosity, "render": product_render}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m flatmatch_tpu_torch.tools.flagship",
        description="the port's gates on the product's scene")
    p.add_argument("gates", nargs="*", metavar="GATE",
                   help=f"any of {', '.join(GATES)} (default: all)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None,
                   help="directory of the product render's export")
    args = p.parse_args(argv)
    unknown = [g for g in args.gates if g not in GATES]
    if unknown:
        p.error(f"unknown gate {unknown[0]!r}")
    ok = True
    for name in args.gates or list(GATES):
        kw = dict(out_dir=args.out) if name == "render" else {}
        res = GATES[name](args.device, **kw)
        print(json.dumps(res), flush=True)
        ok = ok and res["pass"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
