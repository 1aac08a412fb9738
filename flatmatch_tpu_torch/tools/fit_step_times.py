#!/usr/bin/env python3
"""Time the fit of checkouts of the port on one card.

    python3 flatmatch_tpu_torch/tools/fit_step_times.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (for example a `git archive` of
another commit unpacked into a directory that .gitignore lists). For each,
in a fresh interpreter, the script imports that checkout's
flatmatch_tpu_torch, builds its kernels and prints one JSON line: the
seconds per steady step of `fit_materials` on `tests/fixtures/mini.png` (10
steps after 2 of warm-up, Adam included, to a target the same renderer
gives at albedo 0.9 and power 1) on three tiers of the fit (the CLI's
default: device RNG and the 7-bit splat; the library's default: threefry
and the f32 splat; `--splat scatter`, the deposit stream), and the seconds
of one forward plus backward of mini tiled 4x4 at the CLI's default. Give
two commits in turns (A B B A) to compare them on one card; the last line
names the card and its power limit. It needs a CUDA device and imports no
JAX.
"""
import dataclasses
import json
import pathlib
import subprocess
import sys
import tempfile
import time

FIXTURES = pathlib.Path(__file__).resolve().parents[2] / "tests" / "fixtures"
TIERS = {"device_rng_i8": (True, "inkernel_i8"),
         "threefry_f32": (False, "inkernel"),
         "scatter": (False, "scatter")}


def measure(root: str) -> dict:
    sys.path.insert(0, root)
    import importlib.util

    import torch

    from flatmatch_tpu_torch.config import DEFAULT_CONFIG
    from flatmatch_tpu_torch.diff.fit import fit_materials
    from flatmatch_tpu_torch.diff.render import make_diff_renderer_wide
    from flatmatch_tpu_torch.ops.aa_scene import pack_aa
    from flatmatch_tpu_torch.ops.device_scene import pack_emitters
    from flatmatch_tpu_torch.render import compile_scene

    if not pathlib.Path(fit_materials.__code__.co_filename).resolve() \
            .is_relative_to(pathlib.Path(root).resolve()):
        raise RuntimeError(f"imported the fit from outside {root}")
    dev = torch.device("cuda")
    ph = DEFAULT_CONFIG.photon

    def setup(png):
        scene, _ = compile_scene(str(png), 30.0, DEFAULT_CONFIG)
        em = pack_emitters(scene, ph.samples_per_area, ph.window_color,
                           ph.light_color, device=dev)
        return scene, em, pack_aa(scene.walls, device=dev)

    def sync_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    out = {"root": root}
    scene, em, aa = setup(FIXTURES / "mini.png")
    n_rect, n_em = len(scene.walls), len(em.counts)
    for tier, (device_rng, splat) in TIERS.items():
        cfg = dataclasses.replace(ph, device_rng=device_rng, splat=splat)
        r = make_diff_renderer_wide(em, scene.num_texels, cfg, aa)
        with torch.no_grad():
            target = r(torch.full((n_rect,), 0.9, device=dev),
                       torch.ones(n_em, device=dev)).cpu().numpy()

        def fit(steps, cfg=cfg, target=target):
            fit_materials(target, None, em, scene.num_texels, cfg, aa=aa,
                          steps=steps, init_albedo=0.6, init_power=0.5)

        fit(2)
        out[f"mini_{tier}_s_per_step"] = sync_s(lambda: fit(10)) / 10
    with tempfile.TemporaryDirectory() as tmp:
        spec = importlib.util.spec_from_file_location(
            "make_layout", FIXTURES / "make_layout.py")
        make_layout = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(make_layout)
        png = pathlib.Path(tmp) / "mini_4x4.png"
        make_layout.tiled(str(FIXTURES / "mini.png"), str(png), 4, 4)
        scene, em, aa = setup(png)
    r = make_diff_renderer_wide(em, scene.num_texels, ph, aa)
    a = torch.full((len(scene.walls),), 0.6, device=dev, requires_grad=True)
    p = torch.full((len(em.counts),), 0.5, device=dev, requires_grad=True)
    out["4x4_forward_backward_s"] = sync_s(
        lambda: torch.mean(r(a, p) ** 2).backward())
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
