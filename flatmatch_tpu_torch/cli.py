"""Command-line interface of the PyTorch port.

  python -m flatmatch_tpu_torch.cli render <layout.png> [scale] [options]

Same positional arguments, flags and defaults as `flatmatch_tpu.cli render`
(its production defaults: --device-rng on, --splat inkernel_i8), plus
`--device` (default cuda). Flags and values outside the ported slice exit
with an error that names ROADMAP.md rather than being ignored. The other
commands of the JAX package (package, serve, fit, debug) are not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

from .config import DEFAULT_CONFIG, Engine


def _add_engine_flags(p: argparse.ArgumentParser):
    p.add_argument(
        "--engine",
        choices=[e.value for e in Engine],
        default=DEFAULT_CONFIG.engine.value,
        help="illumination engine (only photon_pallas is ported)",
    )
    p.add_argument(
        "--samples-per-area",
        type=float,
        default=DEFAULT_CONFIG.photon.samples_per_area,
        help="photons per m^2 of emitter area (main.c:58)",
    )
    p.add_argument("--seed", type=int, default=DEFAULT_CONFIG.photon.seed)
    p.add_argument(
        "--photons-per-batch",
        type=int,
        default=DEFAULT_CONFIG.photon.photons_per_batch,
    )
    p.add_argument(
        "--device-rng",
        action=argparse.BooleanOptionalAction,
        default=True,
        help="generate uniforms in-kernel with the counter-hash PRNG "
        "(photonmap.cl:21-25 analog); --no-device-rng is not ported",
    )
    p.add_argument(
        "--splat",
        choices=["fused", "fused_i8", "inkernel", "inkernel_i8", "bucket",
                 "bucket_exact", "scatter"],
        default="inkernel_i8",
        help="deposit splat strategy; only inkernel_i8 (dithered 7-bit "
        "colors summed exactly in int32 inside the kernel) is ported",
    )
    p.add_argument(
        "--radiosity-rays",
        type=int,
        default=DEFAULT_CONFIG.radiosity.rays_per_texel,
        help="form-factor rays per texel (radiosity engine, not ported)",
    )
    p.add_argument(
        "--radiosity-iterations",
        type=int,
        default=DEFAULT_CONFIG.radiosity.iterations,
    )
    p.add_argument(
        "--ao-chunk",
        type=int,
        default=DEFAULT_CONFIG.ao.texels_per_chunk,
        help="AO texels per device dispatch (AO engine, not ported)",
    )
    p.add_argument("--ao-fused", dest="ao_fused", action="store_true",
                   default=True)
    p.add_argument("--ao-chunked", dest="ao_fused", action="store_false")
    p.add_argument("--out", default=".", help="output directory")
    p.add_argument(
        "--checkpoint",
        default=None,
        metavar="PATH",
        help="checkpoint file (not ported)",
    )
    p.add_argument(
        "--checkpoint-every",
        type=int,
        default=DEFAULT_CONFIG.photon.checkpoint_every,
        metavar="BATCHES",
    )
    p.add_argument(
        "--single-device",
        action="store_true",
        help="run on the one device --device names (the port's only mode)",
    )
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="profiler trace (not ported)")
    p.add_argument("--coordinator", default=None,
                   help="multi-host coordinator (not ported)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument(
        "--device",
        default="cuda",
        help="torch device to render on: cuda (the CUDA kernel) or cpu "
        "(the plain PyTorch version)",
    )


def _build_cfg(args):
    cfg = DEFAULT_CONFIG.replace(engine=Engine(args.engine))
    return cfg.replace(
        photon=dataclasses.replace(
            cfg.photon,
            samples_per_area=args.samples_per_area,
            seed=args.seed,
            photons_per_batch=args.photons_per_batch,
            splat=args.splat,
            device_rng=args.device_rng,
            checkpoint_every=args.checkpoint_every,
        ),
        radiosity=dataclasses.replace(
            cfg.radiosity,
            rays_per_texel=args.radiosity_rays,
            iterations=args.radiosity_iterations,
            seed=args.seed,
        ),
        ao=dataclasses.replace(cfg.ao, texels_per_chunk=args.ao_chunk,
                               fused=args.ao_fused),
    )


def _outside_slice(args) -> list:
    """What this invocation asks for that the port does not run yet."""
    out = []
    if args.engine != Engine.PHOTON_PALLAS.value:
        out.append(f"--engine {args.engine}")
    if not args.device_rng:
        out.append("--no-device-rng (threefry draws)")
    if args.splat != "inkernel_i8":
        out.append(f"--splat {args.splat}")
    if args.checkpoint is not None:
        out.append("--checkpoint")
    if args.preview:
        out.append("--preview")
    if args.profile is not None:
        out.append("--profile")
    if (args.coordinator is not None or args.num_processes is not None
            or args.process_id is not None):
        out.append("multi-host flags")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="flatmatch_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_render = sub.add_parser("render", help="render lightmap tiles")
    p_render.add_argument("layout", help="layout PNG path")
    p_render.add_argument(
        "scale", nargs="?", type=float, default=30.0, help="pixels per meter"
    )
    _add_engine_flags(p_render)
    p_render.add_argument("--preview", action="store_true",
                          help="progressive tiles (not ported)")
    p_render.add_argument(
        "--dump-raw",
        action="store_true",
        help="also write tiles/tile_<i>.raw float32 dumps with TileMetadata "
        "headers (rectangle.c:391-429)",
    )
    p_render.add_argument(
        "--dilate-seams",
        action="store_true",
        help="fill lit/unlit boundary texels with their brightest neighbor "
        "on export",
    )
    p_render.add_argument(
        "--supersample",
        type=int,
        default=1,
        metavar="N",
        help="render at N^2 x the texel density and box-average non-zero "
        "sub-texels down before tone mapping",
    )

    args = parser.parse_args(argv)
    missing = _outside_slice(args)
    if missing:
        parser.error(
            f"not ported to flatmatch_tpu_torch yet: {', '.join(missing)} "
            f"(see ROADMAP.md)"
        )
    ss = args.supersample
    if ss < 1 or (ss & (ss - 1)):
        parser.error(
            f"--supersample must be a power of two >= 1, got {ss} "
            "(the scaled tile grids must keep the power-of-two mipmap "
            "invariant, rectangle.c:176-186)"
        )
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        parser.error("no CUDA device visible; --device cpu runs the plain "
                     "PyTorch version")

    from .render import render

    render(args.layout, args.out, args.scale, _build_cfg(args),
           device=args.device, dump_raw=args.dump_raw,
           dilate_seams=args.dilate_seams, supersample=ss)
    return 0


if __name__ == "__main__":
    sys.exit(main())
