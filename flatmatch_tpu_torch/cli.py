"""Command-line interface of the PyTorch port.

  python -m flatmatch_tpu_torch.cli render <layout.png> [scale] [options]
  python -m flatmatch_tpu_torch.cli fit <layout.png> <target_dir> [scale] [options]

Same positional arguments, flags and defaults as `flatmatch_tpu.cli render`
and `fit` (their production defaults: --device-rng on, --splat
inkernel_i8), plus `--device` (default cuda). `render` runs the engines
photon_pallas (the default; every --splat, in-kernel or deposit-stream,
with or without --device-rng, on axis-aligned scenes, and the narrow
general kernel on others), photon_xla (the general engine, which ignores
--splat and --device-rng as the JAX package's does), ambient_occlusion
(fused, or --ao-chunked) and radiosity; `fit` runs every --splat too: the
in-kernel splats (inkernel_i8, inkernel, and fused_i8 and fused, which the
JAX package's fit maps onto them) with or without --device-rng, and the
deposit-stream splats (scatter, bucket, bucket_exact), which draw threefry
either way, as the JAX package's fit does. Flags and values outside the ported slices exit
with an error that names ROADMAP.md rather than being ignored. The other
commands of the JAX package (package, serve, debug) are not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

from .config import DEFAULT_CONFIG, Engine

PORTED_ENGINES = tuple(e.value for e in (
    Engine.PHOTON_PALLAS, Engine.PHOTON_XLA, Engine.AMBIENT_OCCLUSION,
    Engine.RADIOSITY))


def _add_engine_flags(p: argparse.ArgumentParser):
    p.add_argument(
        "--engine",
        choices=[e.value for e in Engine],
        default=DEFAULT_CONFIG.engine.value,
        help="illumination engine (photon_oracle is not ported; fit runs "
        "photon_pallas's differentiable renderer, not photon_xla's)",
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
        "(photonmap.cl:21-25 analog); --no-device-rng draws them with "
        "threefry (jax.random's) and passes them to the kernel, for every "
        "splat (fit's deposit-stream splats draw threefry either way)",
    )
    p.add_argument(
        "--splat",
        choices=["fused", "fused_i8", "inkernel", "inkernel_i8", "bucket",
                 "bucket_exact", "scatter"],
        default="inkernel_i8",
        help="deposit splat strategy: inside the trace kernel, inkernel_i8 "
        "(dithered 7-bit colors summed exactly in int32) or inkernel (bf16 "
        "colors summed in f32); or a separate splat of the deposit stream: "
        "fused and bucket (bf16 colors, f32 sums), fused_i8 (the 7-bit "
        "grid), scatter and bucket_exact (f32 colors). fit's fused and "
        "fused_i8 are inkernel and inkernel_i8",
    )
    p.add_argument(
        "--radiosity-rays",
        type=int,
        default=DEFAULT_CONFIG.radiosity.rays_per_texel,
        help="form-factor rays per texel (radiosity engine)",
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
        help="AO texels per chunk of the general-intersector AO pass; the "
        "axis-aligned AO passes size their own chunks and do not read it",
    )
    p.add_argument("--ao-fused", dest="ao_fused", action="store_true",
                   default=True,
                   help="AO with the rays made inside the kernel (default)")
    p.add_argument("--ao-chunked", dest="ao_fused", action="store_false",
                   help="AO with the rays expanded on the device in chunks")
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
        help="torch device to render on: cuda (the CUDA kernels) or cpu "
        "(their plain PyTorch versions)",
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
    if args.engine not in PORTED_ENGINES:
        out.append(f"--engine {args.engine}")
    elif args.cmd == "fit" and args.engine == Engine.PHOTON_XLA.value:
        out.append("fit --engine photon_xla (the general differentiable "
                   "renderer)")
    if args.checkpoint is not None:
        out.append("--checkpoint")
    if getattr(args, "preview", False):
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

    p_fit = sub.add_parser(
        "fit",
        help="inverse rendering: fit per-wall albedo + per-emitter power "
        "so the photon render matches a target (render --dump-raw output)",
    )
    p_fit.add_argument("layout", help="layout PNG path")
    p_fit.add_argument(
        "target", help="directory containing tile_<i>.raw dumps "
        "(the tiles/ dir of a `render --dump-raw` run)"
    )
    p_fit.add_argument(
        "scale", nargs="?", type=float, default=30.0, help="pixels per meter"
    )
    _add_engine_flags(p_fit)
    p_fit.add_argument("--fit-steps", type=int, default=100)
    p_fit.add_argument("--fit-lr", type=float, default=0.1)
    p_fit.add_argument(
        "--fit-power-only", action="store_true",
        help="hold albedo at its init; fit emitter powers only",
    )
    p_fit.add_argument(
        "--fit-init-albedo", type=float, default=None,
        help="starting albedo (default: the physics constant 0.9)",
    )
    p_fit.add_argument(
        "--fit-render", default=None, metavar="DIR",
        help="also export tone-mapped tiles rendered at the fitted "
        "parameters into DIR",
    )
    p_fit.add_argument(
        "--fit-init-power", type=float, default=1.0,
        help="starting emitter power multiplier",
    )

    args = parser.parse_args(argv)
    missing = _outside_slice(args)
    if missing:
        parser.error(
            f"not ported to flatmatch_tpu_torch yet: {', '.join(missing)} "
            f"(see ROADMAP.md)"
        )
    if args.cmd == "render":
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

    if args.cmd == "fit":
        import pathlib

        from .diff.fit import fit_layout
        from .utils.progress import info

        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        report = out / "fitted.json"
        res = fit_layout(
            args.layout, args.target, args.scale, _build_cfg(args),
            steps=args.fit_steps, learning_rate=args.fit_lr,
            fit_albedo=not args.fit_power_only,
            init_albedo=args.fit_init_albedo,
            init_power=args.fit_init_power, out_path=str(report),
            render_out=args.fit_render, device=args.device,
        )
        if len(res.losses):
            info(f"fit: loss {res.losses[0]:.3e} -> {res.losses[-1]:.3e} "
                 f"over {args.fit_steps} steps; report {report}")
        return 0

    from .render import render

    render(args.layout, args.out, args.scale, _build_cfg(args),
           device=args.device, dump_raw=args.dump_raw,
           dilate_seams=args.dilate_seams, supersample=args.supersample)
    return 0


if __name__ == "__main__":
    sys.exit(main())
