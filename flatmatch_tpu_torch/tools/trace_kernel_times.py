#!/usr/bin/env python3
"""Time the photon trace kernels, the stream splats and the threefry draws
of checkouts of the port on one card, and digest their outputs.

    python3 flatmatch_tpu_torch/tools/trace_kernel_times.py \
        [--scenes mini,4x4,13x13] [--placements K] [--kernels A,B,...] \
        [--routes] ROOT[+VARIANT] [ROOT[+VARIANT] ...]

Each ROOT is a checkout of this repository (for example a `git archive` of
another commit unpacked into a directory that .gitignore lists);
ROOT+VARIANT is a copy of ROOT's package, made for the run in a temporary
directory, with the source edits of VARIANTS[VARIANT] (an ablation: one
design choice of a kernel undone; each edit must match exactly once). For each,
in a fresh interpreter, the script imports that checkout's
flatmatch_tpu_torch, builds its kernels and prints one JSON line: the
device milliseconds per call (chip_smoke.device_ms of this script's
checkout: the calls queued behind a device sleep, so no host work hides in
the time; the median of ROUNDS timed runs, the kernels taking turns) and
the host microseconds per call of
- every instance of the shared trace (rows 1-10 of PERF.md's kernel table:
  the counter-hash and threefry-uniforms renders with the 7-bit and the
  f32 splat, the two stream traces, the diff stream of `fit --splat
  scatter`, the diff forwards and the two folds), per 131072-photon batch;
- the stream splats on that batch's 1M-row stream: row 15
  (`fused_splat_i8`), row 16 with bf16 colors (`fused_splat`) and f32
  colors (`fused_splat_f32`), and row 16 adding into a lightmap
  (`fused_splat_add`; a checkout without that entry adds `fused_splat`'s
  increment with torch, as its callers did; `fused_splat_then_add` always
  does that);
- the threefry draws: the scene's last photon batch flat (`threefry_flat`)
  and transposed to [U, B] (`threefry_t`), and radiosity's first chunk of
  the scene's first wall (`threefry_radiosity`);
on batch 0 of `tests/fixtures/mini.png`, of mini tiled 4x4 and of mini
tiled 13x13 (a table past shared memory: the device-memory instances) at
the CLI's defaults (or the scenes --scenes names), and the SHA-256 of each
kernel's outputs there. The threefry uniforms of the trace are drawn
once, in the [U, B] layout; each checkout's wrappers get the arguments its
signature takes (older ones a `transposed` flag). The diff kernels run at a
per-slot albedo from a numpy seed. After the roots, one line says whether
every root gave the same digests, and the last line names the card and its
power limit. Give two commits in turns (A B B A) to compare them on one
card. With --placements K, each kernel that reads the uniforms is also
timed (the median of ROUNDS runs) on K copies of them at other addresses,
all held at once, to show how far its time depends on where they lie.
--kernels times and digests only the named kernels. With --routes, the
SHA-256 of whole routes that run the stream splat and the threefry draws
(`routes`: renders of mini through the stream tiers, rotated mini through
the narrow and the general engine, a short `scatter` fit's losses and
parameters) and the wall seconds of a render of mini tiled 4x4 and turned
30 degrees (the narrow route) are added. It needs a CUDA device and
imports no JAX.
"""
import hashlib
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parents[2]
FIXTURES = REPO / "tests" / "fixtures"
# launches per timed run, per scene; each kernel's time is the median of
# ROUNDS runs, the kernels taking turns within each round
# (the stream splats and the draws: STREAM_REPS on every scene)
REPS = {"mini": 200, "4x4": 50, "13x13": 2}
STREAM_REPS = 100
ROUNDS = 5

# ablations: (file under flatmatch_tpu_torch/, text, replacement) edits
# that undo one design choice of row 16 or of the threefry kernel
_TF_FLAT = """  const uint32_t stride = gridDim.x * kTfThreads;
  for (uint32_t j = blockIdx.x * kTfThreads + threadIdx.x; j < m;
       j += stride) {
    out[j] = uniform_at(k, hi, lo0 + j);
  }"""
_TF_T = """  for (int p = blockIdx.x * kTfThreads + threadIdx.x; p < rows;
       p += gridDim.x * kTfThreads) {
    const uint32_t ctr = static_cast<uint32_t>(p) * cols;
    float* o = out + static_cast<size_t>(c0) * rows + p;
    for (int c = c0; c < c1; ++c, o += rows) {
      *o = uniform_at(k, 0u, ctr + static_cast<uint32_t>(c));
    }
  }"""
VARIANTS = {
    **{f"splat_blocks{n}": [("csrc/splat_stream.cu", "std::min(most, want)",
                             f"std::min({n}, want)")]
       for n in (16, 32, 64, 96)},
    # every row's atomics to device memory (the shared sums stay zero)
    "splat_global": [("csrc/splat_stream.cu", "  if (s != nullptr) {",
                      "  if (false && s != nullptr) {")],
    "splat_atom64": [("csrc/splat_stream.cu",
                      "  unsigned* w = reinterpret_cast<unsigned*>(a);",
                      "  atomicAdd(a, static_cast<unsigned long long>(v));\n"
                      "  return;\n"
                      "  unsigned* w = reinterpret_cast<unsigned*>(a);")],
    # the float by __uint2float_rn and a multiply
    "threefry_i2f": [("csrc/threefry.cu",
                      "return __uint_as_float(((x0 ^ x1) >> 9) | 0x3f800000u)"
                      " - 1.0f;",
                      "return __uint2float_rn((x0 ^ x1) >> 9) * "
                      "(1.0f / 8388608.0f);")],
    # grids of up to 4096 blocks, not whole waves
    "threefry_grid4096": [("csrc/threefry.cu",
                           "return sms > 0 ? sms * kTfBlocksPerSm : -1;",
                           "return sms > 0 ? 4096 : -1;"),
                          ("csrc/threefry.cu",
                           "constexpr int kTfFlatWaves = 4;",
                           "constexpr int kTfFlatWaves = 1;")],
    # the flat draw on one wave
    "threefry_flat_onewave": [("csrc/threefry.cu",
                               "constexpr int kTfFlatWaves = 4;",
                               "constexpr int kTfFlatWaves = 1;")],
    # the flat draw indexed in 64 bits
    "threefry_flat64": [("csrc/threefry.cu", _TF_FLAT, """\
  const long long stride = static_cast<long long>(gridDim.x) * kTfThreads;
  const unsigned long long base =
      (static_cast<unsigned long long>(hi) << 32) | lo0;
  for (long long j = static_cast<long long>(blockIdx.x) * kTfThreads +
                     threadIdx.x;
       j < m; j += stride) {
    const unsigned long long i = base + j;
    out[j] = uniform_at(k, static_cast<uint32_t>(i >> 32),
                        static_cast<uint32_t>(i));
  }""")],
    # the transposed draw walked by its output index, divided by rows
    "threefry_tdiv": [("csrc/threefry.cu", _TF_T, """\
  const long long n = static_cast<long long>(rows) * cols;
  const long long stride =
      static_cast<long long>(gridDim.x) * gridDim.y * kTfThreads;
  for (long long o = (static_cast<long long>(blockIdx.y) * gridDim.x +
                      blockIdx.x) * kTfThreads + threadIdx.x;
       o < n; o += stride) {
    const long long c = o / rows;
    const long long p = o - c * rows;
    out[o] = uniform_at(k, 0u, static_cast<uint32_t>(p * cols + c));
  }""")],
}


def variant_root(root: str, name: str, tmp: str) -> str:
    """A copy of ROOT's package under tmp with VARIANTS[name]'s edits."""
    dst = pathlib.Path(tmp) / name
    shutil.copytree(pathlib.Path(root) / "flatmatch_tpu_torch",
                    dst / "flatmatch_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, old, new in VARIANTS[name]:
        f = dst / "flatmatch_tpu_torch" / rel
        text = f.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {rel} holds {text.count(old)} "
                               f"copies of the text to edit")
        f.write_text(text.replace(old, new))
    return str(dst)


def load_smoke():
    """chip_smoke of this script's checkout, whichever checkout is
    measured: its device_ms (fn, reps -> (device ms, host µs) per call) and
    rotated_scene."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def digest(out) -> str:
    """SHA-256 of a kernel's output tensors: dtype, shape and bytes."""
    import torch

    h = hashlib.sha256()
    for t in (out if isinstance(out, (tuple, list)) else (out,)):
        t = t.detach().contiguous().cpu()
        h.update(f"{t.dtype}{tuple(t.shape)}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def kernel_calls(pw, prender, cfg, f, gc, ev, seed, u_t, alb, inv,
                 fixed, g, T, B):
    """name -> call of every trace instance on one batch, with the uniforms-in wrappers given [U, B] uniforms in
    whatever form their signature asks for."""
    import inspect

    import torch

    def uniforms_in(fn):
        if "transposed" in inspect.signature(fn).parameters:
            return lambda *a, **kw: fn(*a, transposed=True, **kw)
        return fn

    n = f.shape[1]
    acc = torch.empty((T, 3), dtype=torch.int32, device=f.device)
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
    }


def stream_calls(sp, threefry, cfg, rad, idx, col, T, gb, chunk, lm0):
    """name -> call of the stream splats on one batch's stream and of the
    threefry draws; `fused_splat_add` adds into a copy of lm0 made once,
    so its digest is of lm0 plus one increment (each timed call adds one
    more)."""
    import math

    bound = sp.stream_bound(cfg)
    lm, lm2 = lm0.clone(), lm0.clone()
    if hasattr(sp, "fused_splat_add"):
        def add():
            return sp.fused_splat_add(lm, idx, col, bound)
    else:
        def add():
            lm.add_(sp.fused_splat(idx, col, T, bound))
            return lm
    key = threefry.fold_in(threefry.prng_key(cfg.seed), gb)
    U = 4 + 3 * int(cfg.max_depth)
    B = cfg.photons_per_batch
    rkey = threefry.fold_in(threefry.fold_in(threefry.prng_key(rad.seed), 0),
                            0)
    rshape = (chunk, int(rad.rays_per_texel), 2)
    assert math.prod(rshape) > 0
    return {
        "fused_splat_i8": lambda: sp.fused_splat_i8(
            idx, col, T, sp.splat_color_scale(cfg)),
        "fused_splat": lambda: sp.fused_splat(idx, col, T, bound),
        "fused_splat_f32": lambda: sp.scatter_splat(idx, col, T, bound),
        "fused_splat_add": add,
        "fused_splat_then_add": lambda: lm2.add_(sp.fused_splat(idx, col, T,
                                                                bound)),
        "threefry_flat": lambda: threefry.uniform(key, (B, U), idx.device),
        "threefry_t": lambda: threefry.uniform(key, (B, U), idx.device,
                                               transposed=True),
        "threefry_radiosity": lambda: threefry.uniform(rkey, rshape,
                                                       idx.device),
    }


UNIFORM_KERNELS = ("trace_deposits_wide", "trace_splat_wide_i8",
                   "trace_splat_wide_f32", "trace_deposits_wide_diff",
                   "trace_splat_wide_diff_i8", "trace_splat_wide_diff_f32",
                   "trace_fold_wide")


def routes(dev, mini, tiled4, rotated_scene) -> dict:
    """SHA-256 of whole routes that run row 16 and the threefry draws, on
    the checkout imported: the photon arena of mini through `--splat fused`
    and `scatter` (device RNG) and threefry with `fused`, of mini turned 30
    degrees at the library's defaults (the narrow route) and through
    `photon_xla` at a tenth of the samples (the general engine), and the
    losses, parameters and lightmap of a 3-step `scatter` fit of mini; and
    the wall seconds of a render of the 4x4 tiling turned 30 degrees (the
    narrow route, once, after the others)."""
    import dataclasses

    import numpy as np
    import torch

    from flatmatch_tpu_torch.config import DEFAULT_CONFIG, Engine
    from flatmatch_tpu_torch.diff.fit import fit_materials
    from flatmatch_tpu_torch.diff.render import make_diff_renderer_wide
    from flatmatch_tpu_torch.ops.aa_scene import pack_aa
    from flatmatch_tpu_torch.ops.device_scene import pack_emitters
    from flatmatch_tpu_torch.render import compile_scene, run_engine

    base = DEFAULT_CONFIG
    ph = base.photon

    def photon(**kw):
        return base.replace(photon=dataclasses.replace(ph, **kw))

    scene, _ = compile_scene(str(mini), 30.0, base)
    rscene = rotated_scene(scene, 30)
    out = {
        "render_mini_fused": run_engine(
            scene, photon(device_rng=True, splat="fused"), dev),
        "render_mini_scatter": run_engine(
            scene, photon(device_rng=True, splat="scatter"), dev),
        "render_mini_threefry_fused": run_engine(
            scene, photon(device_rng=False, splat="fused"), dev),
        "render_rotated_mini": run_engine(rscene, base, dev),
        "render_rotated_mini_xla": run_engine(
            rscene, photon(samples_per_area=ph.samples_per_area / 10).replace(
                engine=Engine.PHOTON_XLA), dev),
    }
    cfg = dataclasses.replace(ph, device_rng=False, splat="scatter")
    em = pack_emitters(scene, ph.samples_per_area, ph.window_color,
                       ph.light_color, device=dev)
    aa = pack_aa(scene.walls, device=dev)
    r = make_diff_renderer_wide(em, scene.num_texels, cfg, aa)
    with torch.no_grad():
        target = r(torch.full((len(scene.walls),), 0.9, device=dev),
                   torch.ones(len(em.counts), device=dev)).cpu().numpy()
    fit = fit_materials(target, em, scene.num_texels, cfg, aa=aa, steps=3,
                        init_albedo=0.6, init_power=0.5)
    out["fit_mini_scatter"] = (fit.losses, fit.albedo, fit.power,
                               fit.lightmap)
    res = {k: digest(tuple(torch.from_numpy(np.ascontiguousarray(a))
                           for a in (v if isinstance(v, tuple) else (v,))))
           for k, v in out.items()}
    scene4, _ = compile_scene(str(tiled4), 30.0, base)
    rscene4 = rotated_scene(scene4, 30)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lm4 = run_engine(rscene4, base, dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    res["render_rotated_4x4"] = digest(torch.from_numpy(lm4))
    return res, seconds


def measure(root: str, names, placements=0, kernels=None,
            with_routes=False) -> dict:
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
    from flatmatch_tpu_torch.scene.rectangle import num_tiles

    smoke = load_smoke()
    device_ms = smoke.device_ms
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
            ev, seed = pw.emitter_vector(em, 0), rng.batch_seed(cfg.seed, 0)
            fns = kernel_calls(pw, prender, cfg, f, gc, ev, seed, u_t, alb,
                               inv, fixed, g, T, B)
            idx, col = pw.trace_deposits_wide_rng(f, gc, ev, seed, B, B, cfg)
            last = sum(-(-int(n) // B) for n in em.counts if n > 0) - 1
            chunk = min(int(DEFAULT_CONFIG.radiosity.texels_per_chunk),
                        num_tiles(scene.walls[0]))
            lm0 = torch.from_numpy(rs.rand(T, 3).astype(np.float32)).to(dev)
            stream = stream_calls(sp, threefry, cfg, DEFAULT_CONFIG.radiosity,
                                  idx, col, T, last, chunk, lm0)
            fns.update(stream)
            if kernels:
                fns = {k: fn for k, fn in fns.items() if k in kernels}
            out["sha256"][name] = {k: digest(fn()) for k, fn in fns.items()}
            runs = {k: [] for k in fns}
            for _ in range(ROUNDS):
                for k, fn in fns.items():
                    runs[k].append(device_ms(
                        fn, STREAM_REPS if k in stream else REPS[name]))
            out[name] = {k: statistics.median(v[0] for v in runs[k])
                         for k in runs}
            out[f"{name}_host_us"] = {
                k: statistics.median(v[1] for v in runs[k]) for k in runs}
            if placements and not kernels:
                copies = [u_t.clone() for _ in range(placements)]
                times = {k: [] for k in UNIFORM_KERNELS}
                for u in copies:
                    fns = kernel_calls(pw, prender, cfg, f, gc, ev, seed, u,
                                       alb, inv, fixed, g, T, B)
                    for k in UNIFORM_KERNELS:
                        times[k].append(statistics.median(
                            device_ms(fns[k], REPS[name])[0]
                            for _ in range(ROUNDS)))
                out[f"{name}_placements"] = times
                del copies
        if with_routes:
            out["sha256"]["routes"], out["rotated_4x4_render_s"] = routes(
                dev, scenes["mini"], scenes["4x4"], smoke.rotated_scene)
    return out


def main(argv):
    opts = {"--scenes": "mini,4x4,13x13", "--placements": "0",
            "--kernels": ""}
    with_routes = False
    while argv and (argv[0] in opts or argv[0] == "--routes"):
        if argv[0] == "--routes":
            with_routes, argv = True, argv[1:]
            continue
        opts[argv[0]] = argv[1]
        argv = argv[2:]
    scenes = opts["--scenes"]
    placements = int(opts["--placements"])
    kernels = [k for k in opts["--kernels"].split(",") if k]
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(measure(argv[1], scenes.split(","), placements,
                                 kernels, with_routes)), flush=True)
        return 0
    variants = {r.rpartition("+")[2] for r in argv if "+" in r}
    if (not argv or not set(scenes.split(",")) <= set(REPS)
            or not variants <= set(VARIANTS)):
        print(__doc__, file=sys.stderr)
        return 2
    digests = []
    for arg in argv:
        with tempfile.TemporaryDirectory() as tmp:
            root, _, variant = arg.partition("+")
            if variant:
                root = variant_root(root, variant, tmp)
            cmd = [sys.executable, __file__, "--scenes", scenes,
                   "--placements", str(placements), "--kernels",
                   ",".join(kernels)] + (["--routes"] if with_routes else [])
            res = subprocess.run(cmd + ["--one", root], capture_output=True,
                                 text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        line = json.loads(res.stdout.strip().splitlines()[-1])
        line["root"] = arg
        digests.append(line["sha256"])
        print(json.dumps(line), flush=True)
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
