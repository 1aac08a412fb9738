#!/usr/bin/env python3
"""Time the photon trace kernels of checkouts of the port on one card, and
digest their outputs.

    python3 flatmatch_tpu_torch/tools/trace_kernel_times.py \
        [--scenes mini,4x4,13x13] [--placements K] ROOT [ROOT ...]

Each ROOT is a checkout of this repository (for example a `git archive` of
another commit unpacked into a directory that .gitignore lists). For each,
in a fresh interpreter, the script imports that checkout's
flatmatch_tpu_torch, builds its kernels and prints one JSON line: the
CUDA-event milliseconds per 131072-photon batch (the median of ROUNDS
timed runs, the kernels taking turns) of every instance of the
shared trace (rows 1-10 of PERF.md's kernel table: the counter-hash and
threefry-uniforms renders with the 7-bit and the f32 splat, the two stream
traces, the diff stream of `fit --splat scatter`, the diff forwards and the
two folds) and of the f32 stream splat `fused_splat`, on batch 0 of
`tests/fixtures/mini.png`, of mini tiled 4x4 and of mini tiled 13x13 (a
table past shared memory: the device-memory instances) at the CLI's
defaults (or the scenes --scenes names), and the SHA-256 of each kernel's
outputs there. The threefry uniforms are drawn
once, in the [U, B] layout; each checkout's wrappers get the arguments its
signature takes (older ones a `transposed` flag). The diff kernels run at a
per-slot albedo from a numpy seed. After the roots, one line says whether
every root gave the same digests, and the last line names the card and its
power limit. Give two commits in turns (A B B A) to compare them on one
card. With --placements K, each kernel that reads the uniforms is also
timed (the median of ROUNDS runs) on K copies of them at other addresses,
all held at once, to show how far its time depends on where they lie. It
needs a CUDA device and imports no JAX.
"""
import hashlib
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile

FIXTURES = pathlib.Path(__file__).resolve().parents[2] / "tests" / "fixtures"
# launches per timed run, per scene; each kernel's time is the median of
# ROUNDS runs, the kernels taking turns within each round
REPS = {"mini": 200, "4x4": 50, "13x13": 2}
ROUNDS = 5


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


def digest(out) -> str:
    """SHA-256 of a kernel's output tensors: dtype, shape and bytes."""
    import torch

    h = hashlib.sha256()
    for t in (out if isinstance(out, (tuple, list)) else (out,)):
        t = t.detach().contiguous().cpu()
        h.update(f"{t.dtype}{tuple(t.shape)}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def kernel_calls(pw, sp, prender, cfg, f, gc, ev, seed, u_t, alb, inv,
                 fixed, g, T, B):
    """name -> call of every trace instance on one batch (and the f32
    stream splat), with the uniforms-in wrappers given [U, B] uniforms in
    whatever form their signature asks for."""
    import inspect

    import torch

    def uniforms_in(fn):
        if "transposed" in inspect.signature(fn).parameters:
            return lambda *a, **kw: fn(*a, transposed=True, **kw)
        return fn

    n = f.shape[1]
    acc = torch.empty((T, 3), dtype=torch.int32, device=f.device)
    idx, col = pw.trace_deposits_wide_rng(f, gc, ev, seed, B, B, cfg)
    diff_block = prender.diff_block(B)
    return {
        "trace_splat_wide_rng_i8": lambda: pw.trace_splat_wide_rng_i8(
            f, gc, ev, seed, B, B, cfg, T, out=acc),
        "trace_splat_wide_rng_f32": lambda: pw.trace_splat_wide_rng_f32(
            f, gc, ev, seed, B, B, cfg, T),
        "trace_deposits_wide_rng": lambda: pw.trace_deposits_wide_rng(
            f, gc, ev, seed, B, B, cfg),
        "trace_deposits_wide": lambda: uniforms_in(pw.trace_deposits_wide)(
            f, gc, ev, u_t, B, cfg),
        "trace_splat_wide_i8": lambda: uniforms_in(pw.trace_splat_wide_i8)(
            f, gc, ev, u_t, B, cfg, T, out=acc),
        "trace_splat_wide_f32": lambda: uniforms_in(pw.trace_splat_wide_f32)(
            f, gc, ev, u_t, B, cfg, T),
        "trace_deposits_wide_diff": lambda: uniforms_in(
            pw.trace_deposits_wide_diff)(f, gc, alb, ev, u_t, B, cfg,
                                         diff_block),
        "trace_splat_wide_diff_i8": lambda: uniforms_in(
            pw.trace_splat_wide_diff_i8)(f, gc, alb, ev, u_t, B, cfg, T, inv,
                                         out=acc),
        "trace_splat_wide_diff_f32": lambda: uniforms_in(
            pw.trace_splat_wide_diff_f32)(f, gc, alb, ev, u_t, B, cfg, T,
                                          fixed),
        "trace_splat_wide_diff_rng_i8":
            lambda: pw.trace_splat_wide_diff_rng_i8(f, gc, alb, ev, seed, B,
                                                    B, cfg, T, inv, out=acc),
        "trace_splat_wide_diff_rng_f32":
            lambda: pw.trace_splat_wide_diff_rng_f32(f, gc, alb, ev, seed, B,
                                                     B, cfg, T, fixed),
        "trace_fold_wide": lambda: uniforms_in(pw.trace_fold_wide)(
            f, gc, alb, ev, g, u_t, B, cfg, n),
        "trace_fold_wide_rng": lambda: pw.trace_fold_wide_rng(
            f, gc, alb, ev, g, seed, B, B, cfg, n),
        "fused_splat": lambda: sp.fused_splat(idx, col, T,
                                              sp.stream_bound(cfg)),
    }


UNIFORM_KERNELS = ("trace_deposits_wide", "trace_splat_wide_i8",
                   "trace_splat_wide_f32", "trace_deposits_wide_diff",
                   "trace_splat_wide_diff_i8", "trace_splat_wide_diff_f32",
                   "trace_fold_wide")


def measure(root: str, names, placements=0) -> dict:
    sys.path.insert(0, root)
    import dataclasses
    import importlib.util

    import numpy as np
    import torch

    from flatmatch_tpu_torch.config import DEFAULT_CONFIG
    from flatmatch_tpu_torch.diff import render as prender
    from flatmatch_tpu_torch.engines import photon_wide as pw
    from flatmatch_tpu_torch.ops import rng, splat as sp, threefry
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
    out = {"root": root, "sha256": {}}
    with tempfile.TemporaryDirectory() as tmp:
        scenes = {"mini": FIXTURES / "mini.png"}
        for k in (4, 13):
            scenes[f"{k}x{k}"] = pathlib.Path(tmp) / f"mini_{k}x{k}.png"
            make_layout.tiled(str(scenes["mini"]), str(scenes[f"{k}x{k}"]),
                              k, k)
        for name in names:
            png = scenes[name]
            scene, _ = compile_scene(str(png), 30.0, DEFAULT_CONFIG)
            aa_c, T, _ = pw.compact_aa(pack_aa(scene.walls, dev),
                                       scene.num_texels)
            em = pack_emitters(scene, cfg.samples_per_area, cfg.window_color,
                               cfg.light_color, device=dev)
            f, gc = aa_c.fields, aa_c.group_counts
            rs = np.random.RandomState(1)
            g = torch.from_numpy(rs.rand(T, 3).astype(np.float32)).to(dev)
            alb = torch.from_numpy(rs.uniform(0.4, 0.95, f.shape[1]).astype(
                np.float32)).to(dev)
            inv = torch.full(
                (1,), np.float32(1.0 / pw.splat_color_scale(cfg)),
                device=dev)
            fixed = torch.tensor(
                [np.float32(x) for x in
                 sp.fixed_point_scale(sp.stream_bound(cfg))], device=dev)
            u_t = threefry.batch_uniforms(
                cfg.seed, 0, B, pw.uniforms_per_photon(cfg.max_depth), dev,
                transposed=True)
            fns = kernel_calls(pw, sp, prender, cfg, f, gc,
                               pw.emitter_vector(em, 0),
                               rng.batch_seed(cfg.seed, 0), u_t, alb, inv,
                               fixed, g, T, B)
            out["sha256"][name] = {k: digest(fn()) for k, fn in fns.items()}
            runs = {k: [] for k in fns}
            for _ in range(ROUNDS):
                for k, fn in fns.items():
                    runs[k].append(cuda_ms(fn, REPS[name]))
            out[name] = {k: statistics.median(v) for k, v in runs.items()}
            if placements:
                copies = [u_t.clone() for _ in range(placements)]
                times = {k: [] for k in UNIFORM_KERNELS}
                for u in copies:
                    fns = kernel_calls(pw, sp, prender, cfg, f, gc,
                                       pw.emitter_vector(em, 0),
                                       rng.batch_seed(cfg.seed, 0), u, alb,
                                       inv, fixed, g, T, B)
                    for k in UNIFORM_KERNELS:
                        times[k].append(statistics.median(
                            cuda_ms(fns[k], REPS[name])
                            for _ in range(ROUNDS)))
                out[f"{name}_placements"] = times
                del copies
    return out


def main(argv):
    opts = {"--scenes": "mini,4x4,13x13", "--placements": "0"}
    while argv and argv[0] in opts:
        opts[argv[0]] = argv[1]
        argv = argv[2:]
    scenes = opts["--scenes"]
    placements = int(opts["--placements"])
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(measure(argv[1], scenes.split(","), placements)),
              flush=True)
        return 0
    if not argv or not set(scenes.split(",")) <= set(REPS):
        print(__doc__, file=sys.stderr)
        return 2
    digests = []
    for root in argv:
        res = subprocess.run([sys.executable, __file__, "--scenes", scenes,
                              "--placements", str(placements), "--one",
                              root],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        line = res.stdout.strip().splitlines()[-1]
        digests.append(json.loads(line)["sha256"])
        print(line, flush=True)
    differ = sorted({f"{scene}/{k}" for d in digests[1:]
                     for scene, ks in d.items() for k in ks
                     if ks[k] != digests[0][scene][k]})
    print(json.dumps({"same_digests": not differ, "differ": differ}))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    print(card.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
