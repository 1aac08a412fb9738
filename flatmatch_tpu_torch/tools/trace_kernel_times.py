#!/usr/bin/env python3
"""Time the photon trace kernels of checkouts of the port on one card.

    python3 flatmatch_tpu_torch/tools/trace_kernel_times.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (for example a `git archive` of
another commit unpacked into a directory that .gitignore lists). For each,
in a fresh interpreter, the script imports that checkout's
flatmatch_tpu_torch, builds its kernels and prints one JSON line: the mean
CUDA-event milliseconds per 131072-photon batch of the three kernels that
share the trace (`trace_splat_wide_rng_i8`, `trace_splat_wide_diff_rng_i8`,
`trace_fold_wide_rng`) on batch 0 of `tests/fixtures/mini.png` and of mini
tiled 4x4, at the CLI's defaults. Give two commits in turns (A B B A) to
compare them on one card. The last line names the card and its power
limit. It needs a CUDA device and imports no JAX.
"""
import json
import pathlib
import subprocess
import sys
import tempfile

FIXTURES = pathlib.Path(__file__).resolve().parents[2] / "tests" / "fixtures"
REPS = {"mini": 50, "4x4": 20}


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def measure(root: str) -> dict:
    sys.path.insert(0, root)
    import dataclasses
    import importlib.util

    import numpy as np
    import torch

    from flatmatch_tpu_torch.config import DEFAULT_CONFIG
    from flatmatch_tpu_torch.engines import photon_wide as pw
    from flatmatch_tpu_torch.ops import rng
    from flatmatch_tpu_torch.ops.aa_scene import pack_aa
    from flatmatch_tpu_torch.ops.device_scene import pack_emitters
    from flatmatch_tpu_torch.render import compile_scene

    if not pathlib.Path(pw.__file__).resolve().is_relative_to(
            pathlib.Path(root).resolve()):
        raise RuntimeError(f"imported {pw.__file__}, not from {root}")
    dev = torch.device("cuda")
    cfg = dataclasses.replace(DEFAULT_CONFIG.photon, device_rng=True,
                              splat="inkernel_i8")
    B = cfg.photons_per_batch
    spec = importlib.util.spec_from_file_location(
        "make_layout", FIXTURES / "make_layout.py")
    make_layout = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(make_layout)
    out = {"root": root}
    with tempfile.TemporaryDirectory() as tmp:
        tiled = pathlib.Path(tmp) / "mini_4x4.png"
        make_layout.tiled(str(FIXTURES / "mini.png"), str(tiled), 4, 4)
        for name, png in (("mini", FIXTURES / "mini.png"), ("4x4", tiled)):
            scene, _ = compile_scene(str(png), 30.0, DEFAULT_CONFIG)
            aa_c, T, _ = pw.compact_aa(pack_aa(scene.walls, dev),
                                       scene.num_texels)
            em = pack_emitters(scene, cfg.samples_per_area, cfg.window_color,
                               cfg.light_color, device=dev)
            ev = pw.emitter_vector(em, 0)
            f, gc = aa_c.fields, aa_c.group_counts
            n = f.shape[1]
            seed = rng.batch_seed(cfg.seed, 0)
            alb = torch.full((n,), np.float32(cfg.albedo), device=dev)
            inv = torch.full(
                (1,), np.float32(1.0 / pw.splat_color_scale(cfg)),
                device=dev)
            g = torch.from_numpy(np.random.RandomState(1).rand(T, 3).astype(
                np.float32)).to(dev)
            acc = torch.empty((T, 3), dtype=torch.int32, device=dev)
            fns = {
                "trace_splat_wide_rng_i8": lambda: pw.trace_splat_wide_rng_i8(
                    f, gc, ev, seed, B, B, cfg, T, out=acc),
                "trace_splat_wide_diff_rng_i8":
                    lambda: pw.trace_splat_wide_diff_rng_i8(
                        f, gc, alb, ev, seed, B, B, cfg, T, inv, out=acc),
                "trace_fold_wide_rng": lambda: pw.trace_fold_wide_rng(
                    f, gc, alb, ev, g, seed, B, B, cfg, n),
            }
            out[name] = {k: cuda_ms(fn, REPS[name]) for k, fn in fns.items()}
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
                             capture_output=True, text=True, timeout=600)
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
