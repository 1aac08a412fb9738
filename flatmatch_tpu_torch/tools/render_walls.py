#!/usr/bin/env python3
"""Time the straight photon render of checkouts of the port on one card.

    python3 flatmatch_tpu_torch/tools/render_walls.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (for example a `git archive` of
another commit unpacked into a directory that .gitignore lists). For each,
in a fresh interpreter, the script imports that checkout's
flatmatch_tpu_torch, builds its kernels with one render of mini, and prints
one JSON line: the seconds of `render PNG 30 --out DIR` through the CLI at
its defaults (no checkpoint, no preview) and of the photon pass alone
(`render.run_engine` at the CLI's photon defaults), each the median of 3
runs, on `tests/fixtures/mini.png` and on mini tiled 4x4. Give two commits in turns
(A B B A) to compare them on one card; the last line names the card and its
power limit. It needs a CUDA device and imports no JAX.
"""
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

FIXTURES = pathlib.Path(__file__).resolve().parents[2] / "tests" / "fixtures"
REPS = 3


def measure(root: str) -> dict:
    sys.path.insert(0, root)
    import dataclasses
    import importlib.util

    import torch

    from flatmatch_tpu_torch import cli
    from flatmatch_tpu_torch.config import DEFAULT_CONFIG
    from flatmatch_tpu_torch.render import compile_scene, run_engine

    if not pathlib.Path(cli.__file__).resolve() \
            .is_relative_to(pathlib.Path(root).resolve()):
        raise RuntimeError(f"imported the CLI from outside {root}")
    dev = torch.device("cuda")
    # the CLI's photon defaults: device RNG and the 7-bit in-kernel splat
    cfg = DEFAULT_CONFIG.replace(photon=dataclasses.replace(
        DEFAULT_CONFIG.photon, device_rng=True, splat="inkernel_i8"))

    def median_s(fn):
        walls = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return statistics.median(walls)

    out = {"root": root}
    with tempfile.TemporaryDirectory() as tmp:
        spec = importlib.util.spec_from_file_location(
            "make_layout", FIXTURES / "make_layout.py")
        make_layout = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(make_layout)
        tiled = pathlib.Path(tmp) / "mini_4x4.png"
        make_layout.tiled(str(FIXTURES / "mini.png"), str(tiled), 4, 4)
        scenes = {"mini": FIXTURES / "mini.png", "4x4": tiled}

        def cli_render(png):
            rc = cli.main(["render", str(png), "30", "--out",
                           str(pathlib.Path(tmp) / "out")])
            if rc != 0:
                raise RuntimeError(f"render {png} returned {rc}")

        cli_render(scenes["mini"])
        for name, png in scenes.items():
            out[f"{name}_cli_s"] = median_s(lambda: cli_render(png))
            scene, _ = compile_scene(str(png), 30.0, cfg)
            out[f"{name}_run_engine_s"] = median_s(
                lambda: run_engine(scene, cfg, dev))
    return out


def main(argv):
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(measure(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv:
        res = subprocess.run([sys.executable, __file__, "--one", root],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1], flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    print(card.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
