#!/usr/bin/env python3
"""The readings that a cell's limits are set from (benchmark/reference/
compare.py, or the reference kind's own checks), on the card at the
cell's own size, in one process:

    python3 benchmark/tools/readings.py --workload <cell> [--seeds 12]
        [--controls 3] [--halves 3] [--first-seed N]

- program: one request of the cell's mix per seed, then the reference,
  given what the request consumed where the mix returns it (`inputs`),
  and every check, as a run of the cell makes them after its window;
- control: the reference in the program's place, one precision below the
  configuration's (bfloat16 below float32), at the program's budget,
  against the reference of the same seed: for a kind with its own checks
  its `control`, judged by those checks (none where it has no `control`);
- half: the program with half its photons, rays or samples (the budget
  halved, its mean taken over the rest) against the reference.

A kind without checks of its own reads `energy_gap` and `texel_chi2` in
its half and control lines; a kind with its own reads all of its checks.
One JSON line a reading. The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from benchmark import loop, registry  # noqa: E402
from benchmark.reference import compare  # noqa: E402
from benchmark.reference.layout import parse_rects  # noqa: E402

SAMPLE_KEYS = ("samples_per_area", "rays_per_texel")


def parse_args(argv):
    p = argparse.ArgumentParser(prog="benchmark/tools/readings.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--halves", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3000000001)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    bench = registry.load_benchmark(pathlib.Path.cwd())
    cell = registry.cell(bench, args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s)", file=sys.stderr)
        return 2
    from flatmatch_tpu_torch.utils import cuda_build

    cuda_build.load_library()
    read(args, cell, [torch.device("cuda", i) for i in range(chips)])
    return 0


def read(args, cell: dict, devices: list) -> None:
    """Print the readings of `cell` on `devices` (past the look for cards)."""
    import torch

    from flatmatch_tpu_torch.parallel.mesh import photon_mesh

    config = registry.config(cell["config"])
    mix = registry.traffic(cell["traffic"])
    chips = len(devices)
    here = pathlib.Path(__file__).resolve().parents[1]
    layout = parse_rects(here / config["layout"])
    kind = registry.reference(config["reference"]["kind"])
    own = hasattr(kind, "checks")
    settings = config["settings"]
    out_dir = tempfile.mkdtemp(prefix="readings_")
    target = loop.Target(devices, photon_mesh(devices) if chips > 1 else None,
                         out_dir, bool(config.get("export", {}).get(
                             "tint_extra", False)))

    def emit(kind_of, seed, values, t0):
        print(json.dumps(dict(cell=args.workload, kind=kind_of, seed=seed,
                              seconds=time.perf_counter() - t0,
                              checks=values)), flush=True)

    def request(cfg, seed):
        """One request of the mix: its outputs and what it consumed."""
        win = mix.window(layout, loop.render_config(cfg, mix.params, seed,
                                                    chips), target, 0.0)
        if win["last"] is None:
            raise RuntimeError(f"{args.workload}: the request of seed {seed} "
                               "returned nothing")
        torch.cuda.empty_cache()
        return win["last"], win.get("inputs")

    def reference(seed, inputs=None):
        return compare.expected(kind, layout, settings, config["reference"],
                                seed, devices[0], inputs)

    def judged(outputs, inputs, seed):
        return {n: v for n, v, _ in compare.judge(
            kind, layout, outputs, reference(seed, inputs), out_dir,
            target.tint_extra, 0, config["limits"], inputs)}

    def half(seed):
        cfg = dict(config, settings=dict(settings))
        cfg["settings"][key] = type(settings[key])(settings[key] / 2)
        outputs, inputs = request(cfg, seed)
        if own:
            return judged(outputs, inputs, seed)
        energy, chi2 = compare.engine_checks(layout, outputs, reference(seed))
        return dict(energy_gap=energy, texel_chi2=chi2)

    def control(seed):
        if own:
            inputs = request(config, seed)[1]
            outputs = kind.control(layout, settings, config["reference"],
                                   seed, devices[0], inputs=inputs)
            return judged(outputs, inputs, seed)
        gen = torch.Generator(device=devices[0])
        gen.manual_seed(seed + 1)
        arena, _ = kind.estimate(
            layout, settings, kind.program_samples(layout, settings), gen,
            devices[0], torch.bfloat16)
        energy, chi2 = compare.engine_checks(
            layout, arena.astype("float32"), reference(seed))
        return dict(energy_gap=energy, texel_chi2=chi2)

    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    key = next((k for k in SAMPLE_KEYS if k in settings), None)
    halves = seeds[:args.halves] if key is not None else []
    controls = (seeds[:args.controls]
                if not own or hasattr(kind, "control") else [])
    try:
        mix.request(layout, loop.render_config(config, mix.params, 1, chips,
                                               True), target)
        for seed in seeds:
            t0 = time.perf_counter()
            emit("program", seed, judged(*request(config, seed), seed), t0)
        for name, reading, some in (("half", half, halves),
                                    ("control", control, controls)):
            for seed in some:
                t0 = time.perf_counter()
                emit(name, seed, reading(seed), t0)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
