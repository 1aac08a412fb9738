#!/usr/bin/env python3
"""The readings that a cell's limits are set from (benchmark/reference/
compare.py), on the card at the cell's own size, in one process:

    python3 benchmark/tools/readings.py --workload <cell> [--seeds 12]
        [--controls 3] [--halves 3] [--first-seed N]

- program: one request of the cell per seed, then the reference and every
  check, as a run of the cell makes them after its window;
- control: the reference in the program's place, in bfloat16 (the step
  below the float32 that the configuration states), at the program's
  budget, against the float32 reference of the same seed;
- half: the program with half its photons or rays (the budget halved,
  its mean taken over the rest) against the reference.

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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/tools/readings.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--halves", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3000000001)
    args = p.parse_args(argv)

    import torch

    from flatmatch_tpu_torch.parallel.mesh import photon_mesh
    from flatmatch_tpu_torch.utils import cuda_build

    bench = registry.load_benchmark(pathlib.Path.cwd())
    cell = registry.cell(bench, args.workload)
    config = registry.config(cell["config"])
    mix = registry.traffic(cell["traffic"]).params
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s)", file=sys.stderr)
        return 2
    cuda_build.load_library()
    devices = [torch.device("cuda", i) for i in range(chips)]
    here = pathlib.Path(__file__).resolve().parents[1]
    layout = parse_rects(here / config["layout"])
    ref_mod = registry.reference(config["reference"]["kind"])
    settings = config["settings"]
    out_dir = tempfile.mkdtemp(prefix="readings_")
    target = loop.Target(devices, photon_mesh(devices) if chips > 1 else None,
                         out_dir, bool(config.get("export", {}).get(
                             "tint_extra", False)))
    loop.request(layout, loop.render_config(config, mix, 1, chips, True),
                 target)

    def emit(kind, seed, values, t0):
        print(json.dumps(dict(cell=args.workload, kind=kind, seed=seed,
                              seconds=time.perf_counter() - t0,
                              checks=values)), flush=True)

    def reference(seed):
        return ref_mod.expected(layout, settings, config["reference"], seed,
                                devices[0])

    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    for seed in seeds:
        t0 = time.perf_counter()
        texels, _ = loop.request(layout, loop.render_config(
            config, mix, seed, chips), target)
        torch.cuda.empty_cache()
        checks = compare.checks(layout, texels, reference(seed), out_dir,
                                target.tint_extra, 0, config["limits"])
        emit("program", seed, {n: v for n, v, _ in checks}, t0)
    half = dict(config, settings=dict(settings))
    key = ("samples_per_area" if "samples_per_area" in settings
           else "rays_per_texel")
    half["settings"][key] = type(settings[key])(settings[key] / 2)
    for seed in seeds[:args.halves]:
        t0 = time.perf_counter()
        texels, _ = loop.request(layout, loop.render_config(
            half, mix, seed, chips), target)
        torch.cuda.empty_cache()
        energy, chi2 = compare.engine_checks(layout, texels, reference(seed))
        emit("half", seed, dict(energy_gap=energy, texel_chi2=chi2), t0)
    for seed in seeds[:args.controls]:
        t0 = time.perf_counter()
        gen = torch.Generator(device=devices[0])
        gen.manual_seed(seed + 1)
        arena, _ = ref_mod.estimate(
            layout, settings, ref_mod.program_samples(layout, settings), gen,
            devices[0], torch.bfloat16)
        energy, chi2 = compare.engine_checks(
            layout, arena.astype("float32"), reference(seed))
        emit("control", seed, dict(energy_gap=energy, texel_chi2=chi2), t0)
    shutil.rmtree(out_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
