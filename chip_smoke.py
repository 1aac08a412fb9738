#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from flatmatch_tpu_torch/csrc and drives the port's
twelve groups of paths on the card:
- the render: the production kernel against its plain PyTorch version,
  `tests/fixtures/mini.png` through the port's CLI at its defaults, the
  physics against the reference C engine's golden lightmap, and a 4x4
  tiling of mini at full budget (phases 1-6);
- the fit: the diff forward and the replay-backward kernels against their
  plain versions (and the forward against the production kernel at the
  default parameters), the power identity of the gradient, `render
  --dump-raw` then `fit` on mini through the CLI at its defaults, and one
  forward plus backward of the 4x4 tiling (phases 7-11);
- ambient occlusion and radiosity: the three nearest-hit kernels against
  their plain versions, AO of mini (fused and chunked) against the
  reference build's dump and tiles, both through the CLI, radiosity of
  mini at 2000 and 10000 rays against the reference engine's dumps and
  through the CLI at its defaults, and both engines on the 4x4 tiling at
  their defaults (phases 12-17);
- the deposit-stream tier: the two stream traces (counter hash, threefry
  uniforms in) and the two stream splats (7-bit, and bf16 or f32 colors
  summed in fixed point) against their plain versions on one batch of
  mini, the physics of four splat and draw routes against the reference C
  engine, `render mini.png 30 --splat fused` with and without
  `--device-rng` (and `--splat fused_i8`) through the CLI, and the 4x4
  tiling with `--splat fused` (phases 18-21);
- the other in-kernel tiers: the counter-hash and threefry traces with the
  f32 splat (bf16 colors summed in int64 fixed point) and the threefry trace
  with the 7-bit splat, and the diff forward's f32 tier, against their plain
  versions on one batch of mini, each f32 kernel against the deposit-stream
  route bit for bit, the physics of `--splat inkernel`, `--no-device-rng`
  and both, those three routes and `fit --splat inkernel` on mini through
  the CLI, and the 4x4 tiling with `--splat inkernel` (phases 22-25);
- the fit's threefry and deposit-stream tiers: the threefry kernel against
  its plain version (photon batches in both layouts, a radiosity chunk),
  the diff stream, the uniforms-in diff forward (7-bit and f32) and fold
  against their plain versions on one batch of mini and against the render
  kernels at the default parameters, `fit --no-device-rng` (7-bit and
  `--splat inkernel`) and `fit --splat scatter` on mini through the CLI
  with the gradients of the two tiers compared, the new kernels and one
  forward plus backward on the 4x4 tiling, and every kernel on mini tiled
  13x13, whose scene table is past a block's shared memory (phases
  26-30);
- the general route, on mini and on mini turned 30 degrees about z
  (`rotated_scene`, which no axis-aligned table holds): the narrow kernel
  (row 11) against its plain version, the physics of both general engines
  (`photon_pallas` through the narrow kernel, `photon_xla`) against the
  reference C engine, rotated mini through `run_engine` and mini through
  `render --engine photon_xla` at the CLI defaults, the rotated 4x4
  tiling at full budget and 8 batches of `photon_xla` on it, the narrow
  kernel's device-memory instance on rotated 13x13, and the general AO of
  mini and rotated mini against the reference build's dump (phases
  31-35);
- the redesigned trace (csrc/trace_wide.cuh): every instance of it (rows
  1-10) on mini, on the 4x4 tiling and, in its device-memory instances, on
  mini tiled 13x13, against its plain version and rerun bit for bit, with
  its time per batch beside its bound, its registers and its blocks per SM
  (phase 36);
- the redesigned stream splat (csrc/splat_stream.cu, row 16) and the
  threefry kernel: on batch 0's 1M-row stream of mini (the arena
  accumulator), the 4x4 tiling and mini tiled 13x13 (the paged one), row 16
  with bf16 and f32 colors and adding into a lightmap against
  fused_splat_fixed_plain bit for bit, and the threefry draws (flat,
  transposed, radiosity's chunk) against their plain version bit for bit,
  each with its device ms and host µs per call, share of the bound,
  registers, shared bytes, blocks per SM and accumulator instance (phase
  37);
- the redesigned narrow kernel (row 11, csrc/trace_deposits_narrow.cu) on
  rotated mini, rotated 4x4 and, in its device-memory instance, rotated
  13x13 against its plain version and rerun bit for bit, and the
  redesigned 7-bit stream splat (row 15) and its adding entry on batch 0's
  1M-row stream of mini (the int32 arena), the 4x4 tiling and 13x13 (the
  paged accumulator) against fused_splat_i8_plain bit for bit, each with
  its device ms and host µs per call, share of the bound, registers,
  shared bytes and blocks per SM (phase 38);
- the redesigned nearest-hit kernels (rows 12-14, the photon trace's rect
  loop in csrc/trace_wide.cuh) as phases 12, 17 and 30 held them on mini,
  the 4x4 tiling and, in their device-memory instances, mini tiled 13x13,
  against their plain versions at phase 12's bands and rerun bit for bit,
  with device ms and host µs per call, share of the bound, and the
  instance, registers, shared bytes and blocks per SM that the library
  reports, beside the 4x4 AO and radiosity walls; and the fold past its old cap of
  6,752 rect slots on mini tiled 16x16 (two passes over slot ranges)
  against its plain version, both draw sources, and one fit step there
  (phase 39);
- the publishing path at the CLI's defaults: a straight, a checkpointed
  and a killed-then-resumed render of the 4x4 tiling (row 1, through the
  CLI; the killed one a child process stopped by
  FLATMATCH_FAULT_EXIT_AFTER_CHECKPOINTS) and of rotated mini (rows 11
  and 16), every .raw byte (every texel bit) equal, with their walls
  (phase 40); `render --preview` of mini, a tile write per segment and
  the straight render's tiles at the end (phase 41); `package` of mini
  (its offer splices the fixtures verbatim) and of the 4x4 tiling, whose
  tree the REST server serves from a thread and every route reads back
  (phase 42); `debug` of mini on the card against the CPU, and `render
  --profile` of mini, whose trace names the row-1 kernel (phase 43).
The kernels line's times, and phases 12's, 17's, 30's and 37-39's
kernel times, are device times
(device_ms:
the calls queued behind a device sleep, so that no host work hides in
them); the phases' other times bracket a host loop of calls with events
(cuda_ms). Any failure exits non-zero. The line before the card's name lists every
kernel with its launches on its path, its error against its plain version,
its time, the plain version's time and its bound. The last line of standard
output is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count":
...}}. It imports no JAX.
"""
import dataclasses
import json
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
FIXTURES = ROOT / "tests" / "fixtures"
TPU_WIDE = "flatmatch_tpu/engines/photon_pallas_wide.py"
TPU_AO = "flatmatch_tpu/engines/ao_pallas.py"
# kernel name -> (port module holding its wrapper, CUDA source, TPU kernel)
KERNEL_SITES = {
    "trace_splat_wide_rng_i8": ("engines.photon_wide", "trace_splat_wide_rng",
                                f"{TPU_WIDE}:1002"),
    "trace_splat_wide_diff_rng_i8": ("engines.photon_wide",
                                     "trace_splat_wide_diff_rng",
                                     f"{TPU_WIDE}:1252"),
    "trace_fold_wide_rng": ("engines.photon_wide", "trace_fold_wide_rng",
                            f"{TPU_WIDE}:1394"),
    "ao_fused": ("engines.ao", "ao_fused", f"{TPU_AO}:412"),
    "nearest_distances": ("ops.aa_query", "aa_nearest", f"{TPU_AO}:111"),
    "aa_nearest": ("ops.aa_query", "aa_nearest",
                   "flatmatch_tpu/ops/aa_query.py:127"),
    "trace_deposits_wide_rng": ("engines.photon_wide", "trace_deposits_wide",
                                f"{TPU_WIDE}:741"),
    "trace_deposits_wide": ("engines.photon_wide", "trace_deposits_wide",
                            f"{TPU_WIDE}:804"),
    "fused_splat_i8": ("ops.splat", "splat_stream",
                       "flatmatch_tpu/ops/splat_pallas.py:145"),
    # row 15's adding entry (fm_fused_splat_i8_add): the same kernel, whose
    # launches also count in fused_splat_i8's
    "fused_splat_i8_add": ("ops.splat", "splat_stream",
                           "flatmatch_tpu/ops/splat_pallas.py:145"),
    "fused_splat": ("ops.splat", "splat_stream",
                    "flatmatch_tpu/ops/splat_pallas.py:219"),
    "trace_splat_wide_rng_f32": ("engines.photon_wide", "trace_splat_wide",
                                 f"{TPU_WIDE}:1002"),
    "trace_splat_wide_i8": ("engines.photon_wide", "trace_splat_wide",
                            f"{TPU_WIDE}:937"),
    "trace_splat_wide_f32": ("engines.photon_wide", "trace_splat_wide",
                             f"{TPU_WIDE}:937"),
    "trace_splat_wide_diff_rng_f32": ("engines.photon_wide",
                                      "trace_splat_wide_diff_rng",
                                      f"{TPU_WIDE}:1252"),
    # jax.random's threefry draws run in XLA, not Pallas: the line is the
    # JAX diff renderer's batch draw
    "threefry_uniform": ("ops.threefry", "threefry",
                         "flatmatch_tpu/diff/render.py:393"),
    "trace_deposits_wide_diff": ("engines.photon_wide", "trace_deposits_wide",
                                 f"{TPU_WIDE}:1070"),
    "trace_splat_wide_diff_i8": ("engines.photon_wide",
                                 "trace_splat_wide_diff_rng",
                                 f"{TPU_WIDE}:1168"),
    "trace_splat_wide_diff_f32": ("engines.photon_wide",
                                  "trace_splat_wide_diff_rng",
                                  f"{TPU_WIDE}:1168"),
    "trace_fold_wide": ("engines.photon_wide", "trace_fold_wide_rng",
                        f"{TPU_WIDE}:1326"),
    "trace_deposits_narrow": ("engines.photon_narrow",
                              "trace_deposits_narrow",
                              "flatmatch_tpu/engines/photon_pallas.py:299"),
    # the general intersector runs in XLA, not Pallas: the line is its
    # intersect_all, which nearest_hit (:74) reduces
    "general_nearest": ("ops.intersect", "general_nearest",
                        "flatmatch_tpu/ops/intersect.py:45"),
}
# the wrapper of a kernel is the function of its name, except
WRAPPER_NAMES = {"threefry_uniform": "uniform",
                 "general_nearest": "nearest_hit"}
# rows 6, 7 and 9: the fit's uniforms-in kernels (phases 26-30)
DIFF_UNIFORM_KERNELS = ("trace_deposits_wide_diff", "trace_splat_wide_diff_i8",
                        "trace_splat_wide_diff_f32", "trace_fold_wide")
# the kernels that read threefry uniforms, and those of phases 22-25 that
# sum in int64 fixed point
UNIFORM_KERNELS = ("trace_deposits_wide", "trace_splat_wide_i8",
                   "trace_splat_wide_f32") + DIFF_UNIFORM_KERNELS
F32_KERNELS = ("trace_splat_wide_rng_f32", "trace_splat_wide_f32",
               "trace_splat_wide_diff_rng_f32", "trace_splat_wide_diff_f32")
KERNELS = {
    name: dict(name=name, route="cuda",
               source=f"flatmatch_tpu_torch/csrc/{src}.cu", replaces=tpu)
    for name, (_, src, tpu) in KERNEL_SITES.items()
}
# The axis-aligned AO of mini against the reference build's dump: the
# bands of tests/test_ao_parity.py, except the mean, which there holds the
# JAX package's general XLA intersector (4.8e-5). Its axis-aligned AO,
# which the port matches texel by texel, misses 1e-4 on mini: a few rays
# that graze a coplanar wall's edge land on its other side
# (tests/test_torch_ao.py::test_mini_ao_matches_jax_axis_aligned).
MINI_AA_MEAN = 1.25e-4
# Roofline of the trace kernels (H100 SXM datasheet rates:
# 3.35 TB/s HBM, 67 TFLOP/s float32 outside the tensor cores; that rate
# counts a fused multiply-add as two operations, and the kernels are built
# with -fmad=false, so each add or multiply issues on its own and they can
# reach at most half of it, 128 lanes x 132 SMs x 1.98 GHz = 33.5e12 a
# second: an operations bound here is a floor half as high as that). Operations
# are counted from the kernel source per unit of this run's work: a rect
# test is 12 f32 add/sub/mul and 8 compares and selects (trace_wide.cuh
# rect loop); a traced bounce adds about 150 (three reciprocals, the draws,
# sqrt/sin/cos, the basis, the new direction, attenuation and the deposit's
# quantization); an emitted photon about 150; the fold adds about 10 per
# traced bounce (three bf16 roundings, the dot and the suffix sum).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
OPS_PER_RECT_TEST = 20
OPS_PER_BOUNCE = 150
OPS_PER_PHOTON = 150
FOLD_OPS_PER_BOUNCE = 10
# the stream splats per row and channel (splat_stream.cu): the 7-bit grid's
# hash, multiply-add, floor and clip; the f32 splat's bf16 rounding,
# scaling and conversion
SPLAT_I8_OPS = 20
SPLAT_F32_OPS = 6
# the threefry function per element, counted in the SASS of
# csrc/threefry.cu (cuobjdump -sass, PERF.md): the counter's add, 20 rounds
# of add, funnel-shift rotate and xor, the five x1 key injections, the last
# x0 injection (the others fold into the next round's three-input add), the
# xor of the two words, the shift and the two-instruction conversion: 71,
# loads, stores, addresses and loop control left out. The rate is the
# card's integer issue: 128 thread operations per SM and cycle (four warp
# schedulers of 32 lanes, the ALU and FMA pipes together: the FMA pipe
# issues integer adds as IMAD), 132 SMs at the 1.98 GHz boost clock, half
# the 67 TFLOP/s of f32, which counts a fused multiply-add as two
THREEFRY_OPS = 71
INT32_OPS_PER_S = 128 * 132 * 1.98e9
# The general rect test of row 11 (csrc/trace_deposits_narrow.cu rect
# loop), counted in its SASS (tools/sass_loops.py, PERF.md): 17 FADD and 15
# FMUL (the two plane dot products, n_off - p.n, the hit point, its two
# projections and the two far-edge differences), the IEEE division's fast
# path (MUFU.RCP, 5 FFMA, FCHK: 7), 7 compares and the 2 selects that keep
# the minimum and its column: 48 instructions, none of which -fmad=false
# lets fuse, at the rate the card issues them, 128 lanes an SM a cycle
# (INT32_OPS_PER_S); the per-bounce and per-photon work (OPS_PER_BOUNCE,
# OPS_PER_PHOTON) at the same rate. The table's loads, the loop control
# and the stores are left out.
GENERAL_RECT_TEST_INSTRUCTIONS = 48
LANE_INSTR_PER_S = INT32_OPS_PER_S
# The axis-aligned rect test of the nearest-hit kernels (rows 12-14; the
# shared loop, csrc/trace_wide.cuh nearest_rect), counted from its source,
# each FADD, FMUL, compare and select one instruction: 5 FADD (O - p, and
# p + d * fac - c on each of u and v), 5 FMUL (* 1/d, d * fac and the scale
# on each of u and v), 7 compares (the sign, fac >= 0, the four edges,
# fac < best) and the 2 selects that keep the minimum and its column: 19,
# at LANE_INSTR_PER_S. Per ray, AA_RAY_INSTRUCTIONS: the three reciprocals
# (1.0f / d, each MUFU.RCP, its two FFMA steps and the two-instruction
# check that guards its slow path in the SASS: 5) and the result:
# aa_nearest the hit test, the winner's u and v (8), its texel (two
# products, two floors, two subtractions, two minimums, three conversions,
# the multiply-add: 12) and the id's select; nearest_distances the hit test
# and the select of sky; ao_fused the weight's test, the origin (3 FMUL, 3
# FADD), the hit test, the select of sky, the product and the sum. The
# table's loads, the loop control and the stores are left out.
AA_RECT_TEST_INSTRUCTIONS = 19
# The rect test of the general nearest-hit kernel (csrc/general_nearest.cu,
# the loop of the shared-memory instance), counted in its SASS
# (tools/sass_loops.py, PERF.md): the six dot products of src and dir with
# n, w_unit and h_unit (18 FMUL, 12 FADD), n_off - src.n, the IEEE
# division's fast path (MUFU.RCP, 5 FFMA, FCHK: 7), the two projections
# (2 FMUL, 4 FADD), 7 compares and the 2 selects that keep the minimum and
# its column, at LANE_INSTR_PER_S. The table's loads and the loop control
# are left out.
GENERAL_NEAREST_RECT_TEST_INSTRUCTIONS = 53
AA_RAY_INSTRUCTIONS = {"aa_nearest": 15 + 22, "nearest_distances": 15 + 2,
                       "ao_fused": 15 + 11}
# The debug render of mini at the CLI's camera on the card against the
# CPU: the pixels that must agree (tests/test_torch_debug.py holds the CPU
# against the JAX package at the same share; every pixel agreed there)
DEBUG_SHARE = 0.999


def rotated_scene(scene, degrees):
    """`scene` turned `degrees` about the z axis, for the general routes:
    pos, width, height and n of every wall, window, light and box rect
    rotated (in float64, rounded to float32), base and tile grids kept, so
    the texel arena is laid out as before. Only numpy and
    dataclasses.replace on the layout and its rects, so it turns either
    package's Scene with the same arithmetic. The floor tint and the mirror
    floor test only z, the samplers are symmetric in azimuth and the
    window's sky fold is about the vertical, so the physics is unchanged."""
    import numpy as np

    t = np.radians(float(degrees))
    rot = np.array([[np.cos(t), -np.sin(t), 0.0],
                    [np.sin(t), np.cos(t), 0.0], [0.0, 0.0, 1.0]])

    def turn(r):
        return dataclasses.replace(r, **{
            k: (rot @ np.asarray(getattr(r, k), np.float64)).astype(
                np.float32) for k in ("pos", "width", "height", "n")})

    lay = scene.layout
    return type(scene)(dataclasses.replace(lay, **{
        k: [turn(r) for r in getattr(lay, k)]
        for k in ("walls", "windows", "lights", "box")}))


def say(phase, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps calls, after one warm-up."""
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


# the SM clock that torch.cuda._sleep counts (the H100 SXM's boost clock;
# a lower clock only makes the sleep longer)
SLEEP_CYCLES_PER_S = 1.98e9


def device_ms(fn, reps):
    """(device ms, host µs) per call of fn(), after one warm-up. cuda_ms
    brackets the host's loop of calls with events, so a wrapper whose host
    work (allocation, the ctypes launch, checks) outlasts its kernels times
    the host. Here the reps calls are queued behind torch.cuda._sleep,
    long enough that the host has enqueued them all before the card wakes,
    and the events bracket the queued calls: the card then runs them back
    to back. The host µs is the enqueue time of one call. If the host still
    outran the sleep, the sleep is doubled and the run repeated."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    sleep_s = 2 * host_s + 1e-3
    for _ in range(4):
        torch.cuda._sleep(int(sleep_s * SLEEP_CYCLES_PER_S))
        t = time.perf_counter()
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        queued_s = time.perf_counter() - t
        torch.cuda.synchronize()
        if queued_s < sleep_s:
            return t0.elapsed_time(t1) / reps, queued_s / reps * 1e6
        sleep_s *= 2
    fail(f"device_ms: the host did not run ahead of a {sleep_s} s sleep")


def kernel_ms(fn, reps):
    """Device ms per call of fn() (device_ms's first number)."""
    return device_ms(fn, reps)[0]


def bound(nbytes, ops, rate=F32_OPS_PER_S):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over `rate` (the f32 rate unless said)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def trace_bound(s, bounces, photons, kernel, depth=8):
    """Bound of one launch of `kernel` on this run's batch: `bounces`
    traced bounces over all N rects each. Bytes read: the scene table, the
    emitter vector, the albedo row (diff kernels), g (the fold) and the
    uniforms (4 * (4 + 3 * depth) per photon, UNIFORM_KERNELS); written:
    the int32 accumulator (12 bytes a texel; the f32 kernels: the int64
    one, 24 bytes a texel, and the f32 increment, 12; the fold: N + 1 sums;
    the stream traces: the stream, 16 bytes per photon and bounce, 20 with
    the diff stream's slot)."""
    n = s["aa_c"].fields.shape[1]
    T = s["total_c"]
    fold = kernel.startswith("trace_fold")
    per_bounce = n * OPS_PER_RECT_TEST + OPS_PER_BOUNCE + (
        FOLD_OPS_PER_BOUNCE if fold else 0)
    ops = bounces * per_bounce + photons * OPS_PER_PHOTON
    nbytes = 4 * (13 * n + 16)
    if kernel in UNIFORM_KERNELS:
        nbytes += 4 * (4 + 3 * depth) * photons
    if kernel.startswith("trace_deposits"):
        nbytes += (20 if kernel.endswith("_diff") else 16) * photons * depth
    elif kernel in F32_KERNELS:
        nbytes += (24 + 12) * T
    elif not fold:
        nbytes += 12 * T
    if kernel.startswith(("trace_splat_wide_diff", "trace_fold",
                          "trace_deposits_wide_diff")):
        nbytes += 4 * n
    if fold:
        nbytes += 12 * T + 4 * (n + 1)     # g read, the sums written
    return bound(nbytes, ops)


def splat_bound(rows, T, kernel):
    """Bound of one stream splat: the stream read (16 bytes a row), the
    accumulator (int32 or int64 per texel and channel) and the f32
    increment written (the adding entries: the lightmap read and
    written); the per-channel operations of SPLAT_*_OPS."""
    i8 = kernel.startswith("fused_splat_i8")
    nbytes = 16 * rows + (12 if i8 else 24) * T + 12 * T
    if kernel.endswith("_add"):
        nbytes += 12 * T
    ops = 3 * rows * (SPLAT_I8_OPS if i8 else SPLAT_F32_OPS)
    return bound(nbytes, ops)


def physics_bands(scene, ours, route):
    """The raw photon lightmap of mini at 200k samples per m^2 against the
    reference C engine's golden: energy within 0.02, wall means within
    0.12 (0.25 for walls under 64 texels), texel correlation > 0.98."""
    import numpy as np

    from flatmatch_tpu_torch.scene.rectangle import num_tiles

    gold = np.fromfile(FIXTURES / "mini_photon_native_spa200k.f32",
                       dtype="<f4").reshape(scene.num_texels, 4)[:, :3]
    check(np.isfinite(ours).all(), f"{route}: raw lightmap not finite")
    e_ratio = float(ours.sum() / gold.sum())
    check(abs(e_ratio - 1) <= 0.02, f"{route}: energy ratio {e_ratio}")
    walls = 0
    for i, r in enumerate(scene.walls):
        sl = slice(r.base, r.base + num_tiles(r))
        o, g = ours[sl].mean(), gold[sl].mean()
        if g > gold.sum() / scene.num_texels * 0.1:
            rtol = 0.12 if num_tiles(r) >= 64 else 0.25
            check(abs(o - g) <= rtol * abs(g),
                  f"{route}: wall {i} mean {o} vs reference {g} (rtol "
                  f"{rtol})")
            walls += 1
    check(walls >= 5, f"{route}: only {walls} walls carried energy")
    corr = float(np.corrcoef(ours.ravel(), gold.ravel())[0, 1])
    check(corr > 0.98, f"{route}: texel correlation {corr}")
    return dict(energy_ratio=e_ratio, walls_checked=walls, texel_corr=corr)


def wrapper(name):
    """The port's wrapper function of kernel `name` (it holds the count)."""
    import importlib

    mod = importlib.import_module(
        f"flatmatch_tpu_torch.{KERNEL_SITES[name][0]}")
    return getattr(mod, WRAPPER_NAMES.get(name, name))


def reset_launches():
    for name in KERNELS:
        wrapper(name).launches = 0


def read_launches():
    return {name: wrapper(name).launches for name in KERNELS}


def ray_bound(kernel, n_rects, rays, bytes_per_ray, extra_bytes=0):
    """Bound of a launch of the nearest-hit kernel `kernel` over `rays`
    rays: every ray tests all n_rects rects (AA_RECT_TEST_INSTRUCTIONS
    each, AA_RAY_INSTRUCTIONS[kernel] more per ray), at LANE_INSTR_PER_S.
    Bytes: the scene table, `bytes_per_ray` (origin and direction read,
    results written; 0 when the kernel makes its rays) and `extra_bytes`
    (a kernel's other inputs and outputs)."""
    ops = rays * (n_rects * AA_RECT_TEST_INSTRUCTIONS
                  + AA_RAY_INSTRUCTIONS[kernel])
    nbytes = 4 * 13 * n_rects + rays * bytes_per_ray + extra_bytes
    return bound(nbytes, ops, LANE_INSTR_PER_S)


def batch_setup(png, cfg, dev):
    """Scene table, emitters and batch-0 inputs of a layout at cfg."""
    from flatmatch_tpu_torch.engines import photon_wide as pw
    from flatmatch_tpu_torch.ops import rng
    from flatmatch_tpu_torch.ops.aa_scene import pack_aa
    from flatmatch_tpu_torch.ops.device_scene import pack_emitters
    from flatmatch_tpu_torch.render import compile_scene

    scene, _ = compile_scene(str(png), 30.0, cfg)
    aa = pack_aa(scene.walls, device=dev)
    check(aa is not None, f"{png}: scene not axis-aligned")
    aa_c, total_c, expand = pw.compact_aa(aa, scene.num_texels)
    ph = cfg.photon
    em = pack_emitters(scene, ph.samples_per_area, ph.window_color,
                       ph.light_color, device=dev)
    return dict(scene=scene, aa_c=aa_c, total_c=total_c, expand=expand,
                em=em, ev=pw.emitter_vector(em, 0),
                seed=rng.batch_seed(ph.seed, 0))


def plain_stream(s, cfg, B, ev=None, albedo_aa=None):
    from flatmatch_tpu_torch.engines import photon_wide as pw

    return pw.trace_deposits_rng_plain(
        s["aa_c"].fields, s["aa_c"].group_counts,
        s["ev"] if ev is None else ev, s["seed"], B, B, cfg.photon, albedo_aa)


def plain_batch(s, cfg, B):
    import numpy as np

    from flatmatch_tpu_torch.engines import photon_wide as pw

    idx, col, _ = plain_stream(s, cfg, B)
    inv_s = float(np.float32(1.0 / pw.splat_color_scale(cfg.photon)))
    return pw.splat_i8_plain(idx, col, s["total_c"], inv_s)


def traced_bounces(s, cfg, B):
    """Bounces the kernel traces for batch 0: every live bounce plus the
    one that misses, for each photon that dies within max_depth. Each
    traced bounce tests every rect of the scene."""
    _, col, _ = plain_stream(s, cfg, B)
    live = col.sum(-1) > 0
    return int(live.sum().item()) + B - int(live[:, -1].sum().item())


def diff_setup(s, cfg, dev, power, seed=7):
    """Diff-kernel inputs on batch 0 of `s`: per-slot albedo from a numpy
    seed (0.9 everywhere when power is 1), the emitter color times power,
    and the dynamic grid."""
    import numpy as np
    import torch

    from flatmatch_tpu_torch.diff.render import scale_pair

    n = s["aa_c"].fields.shape[1]
    if power == 1.0:
        alb = torch.full((n,), np.float32(cfg.photon.albedo), device=dev)
    else:
        alb = torch.from_numpy(np.random.RandomState(seed).uniform(
            0.4, 0.95, n).astype(np.float32)).to(dev)
    ev = s["ev"].clone()
    ev[12:15] = ev[12:15] * power
    scale, inv = scale_pair(cfg.photon, torch.tensor(power, device=dev), alb)
    g = torch.from_numpy(np.random.RandomState(seed + 1).rand(
        s["total_c"], 3).astype(np.float32)).to(dev)
    return dict(alb=alb, ev=ev, scale=scale, inv=inv, g=g)


def diff_batch(s, d, cfg, B, out=None):
    from flatmatch_tpu_torch.engines import photon_wide as pw

    return pw.trace_splat_wide_diff_rng_i8(
        s["aa_c"].fields, s["aa_c"].group_counts, d["alb"], d["ev"],
        s["seed"], B, B, cfg.photon, s["total_c"], d["inv"], out=out)


def diff_plain(s, d, cfg, B):
    from flatmatch_tpu_torch.engines import photon_wide as pw

    idx, col, _ = plain_stream(s, cfg, B, d["ev"], d["alb"])
    return pw.splat_i8_plain(idx, col, s["total_c"], d["inv"].item())


def fold_batch(s, d, cfg, B):
    from flatmatch_tpu_torch.engines import photon_wide as pw

    return pw.trace_fold_wide_rng(
        s["aa_c"].fields, s["aa_c"].group_counts, d["alb"], d["ev"], d["g"],
        s["seed"], B, B, cfg.photon, s["aa_c"].fields.shape[1])


def fold_plain(s, d, cfg, B):
    from flatmatch_tpu_torch.engines import photon_wide as pw

    idx, col, ridx = plain_stream(s, cfg, B, d["ev"], d["alb"])
    return pw.fold_plain(idx, col, ridx, d["g"], s["aa_c"].fields.shape[1])


def kernel_batch(s, cfg, B, out=None):
    from flatmatch_tpu_torch.engines import photon_wide as pw

    return pw.trace_splat_wide_rng_i8(
        s["aa_c"].fields, s["aa_c"].group_counts, s["ev"], s["seed"], B, B,
        cfg.photon, s["total_c"], out=out)


# --------------------------------------------------------------------------
# ambient occlusion and radiosity (phases 12-17)
# --------------------------------------------------------------------------
def sync():
    import torch

    torch.cuda.synchronize()


def nearest_inputs(scene, dev, cfg):
    """Inputs of the three nearest-hit kernels as the engines make them at
    cfg: the first form-factor chunk of wall 0 (aa_nearest), the first chunk
    of the chunked AO's rays (nearest_distances) and the fused AO's tables
    (ao_fused)."""
    import numpy as np
    import torch

    from flatmatch_tpu_torch.engines import ao, radiosity
    from flatmatch_tpu_torch.ops import threefry
    from flatmatch_tpu_torch.ops.aa_scene import pack_aa

    rad, aoc = cfg.radiosity, cfg.ao
    _, aa_ext, _ = radiosity.prepare(scene, rad, dev)
    wall = scene.walls[0]
    c = torch.from_numpy(ao.tile_centers(wall)[:rad.texels_per_chunk]).to(dev)
    n = torch.from_numpy(np.asarray(wall.n, np.float32)).to(dev)
    key = threefry.fold_in(threefry.fold_in(threefry.prng_key(rad.seed), 0),
                           0)
    src, direc = radiosity.ff_rays(c, n, key, rad.rays_per_texel)
    aa = pack_aa(scene.walls, dev)
    k_pad = len(ao.direction_weights(aoc.geosphere_level, 8))
    centers, walls, _ = ao._texel_tables(scene)
    chunk = ao.chunk_texels(aoc.geosphere_level)   # render_ao's launch
    d = torch.from_numpy(ao._padded_dirs(scene, aoc.geosphere_level, k_pad)
                         ).to(dev)[torch.from_numpy(walls[:chunk]).long()
                                   .to(dev)]
    cc = torch.from_numpy(centers[:chunk]).to(dev)
    origins = (cc[:, None, :] + d * ao.NUDGE).reshape(-1, 3)
    fused = [torch.from_numpy(a).to(dev)
             for a in ao._ao_fused_prep(scene, aoc)[:4]]
    return dict(aa_ext=aa_ext, src=src, direc=direc, aa=aa, origins=origins,
                dirs=d.reshape(-1, 3).contiguous(), fused=fused)


# 13x13's cut for the nearest-hit kernels: compared on the first rays and
# texels, the AO timed on its first texels (its whole pass takes seconds)
NEAREST_CUT_13 = (1 << 18, 1024, 16384)


def kernels_vs_plain(inp, reps, plain_reps, rays=None, texels=None,
                     timed_texels=None):
    """Each nearest-hit kernel (rows 12-14) on `inp` (nearest_inputs)
    against its plain version at phase 12's bands (ids and distances equal
    on >= 99.9% of rays; the AO within rel 1e-5 with the same zeros) and
    run twice bit for bit; with its device ms and host µs a call
    (device_ms), the plain version's ms, the bound and its share, and the
    instance, registers, shared bytes and blocks per SM that the library
    reports (aa_query.nearest_plan, ao.ao_fused_plan). Compared (and the
    plain version timed) on the first `rays` rays and `texels` texels when
    given, else on all; the fused AO timed on its first `timed_texels`
    texels when given, else on the whole pass."""
    import torch

    from flatmatch_tpu_torch.engines import ao
    from flatmatch_tpu_torch.ops import aa_query

    def twice(run):
        a, b = run(), run()
        sync()
        same = all(torch.equal(x, y) for x, y in zip(a, b)) if \
            isinstance(a, tuple) else torch.equal(a, b)
        check(same, "two runs differ")
        return a

    def timed(run, plain, bnd, plan, cut, **r):
        ms, host_us = device_ms(run, reps)
        pms = cuda_ms(plain, plain_reps)
        return dict(r, bit_identical_rerun=True, ms=ms, host_us=host_us,
                    **{"plain_ms_compared" if cut else "plain_ms": pms},
                    bound_ms=bnd[0], bound_by=bnd[1],
                    share_of_bound=bnd[0] / ms, **plan)

    out = {}
    ext, aa = inp["aa_ext"], inp["aa"]
    n_ext, n = ext.fields.shape[1], aa.fields.shape[1]
    dev = aa.fields.device
    args = (ext.fields, ext.group_counts, inp["src"], inp["direc"])
    cargs = (ext.fields, ext.group_counts, inp["src"][:rays],
             inp["direc"][:rays])
    dist, tex = twice(lambda: aa_query.aa_nearest(*args))
    pdist, ptex = aa_query.aa_nearest_plain(*cargs)
    dist, tex = dist[:rays], tex[:rays]
    ids_eq = (tex == ptex).float().mean().item()
    dist_eq = (dist == pdist).float().mean().item()
    check(ids_eq >= 0.999 and dist_eq >= 0.999,
          f"aa_nearest: ids equal {ids_eq}, distances equal {dist_eq}")
    same = (tex == ptex) & (tex >= 0)
    R = inp["src"].shape[0]
    out["aa_nearest"] = timed(
        lambda: aa_query.aa_nearest(*args),
        lambda: aa_query.aa_nearest_plain(*cargs),
        ray_bound("aa_nearest", n_ext, R, 24 + 8),
        aa_query.nearest_plan(n_ext, True, dev), rays is not None,
        rays=R, compared_rays=ptex.shape[0], rects=n_ext, ids_equal=ids_eq,
        dist_equal=dist_eq, hit_share=(ptex >= 0).float().mean().item(),
        max_abs_err=(dist - pdist)[same].abs().max().item())

    args = (aa.fields, aa.group_counts, inp["origins"], inp["dirs"], 10.0)
    cargs = (aa.fields, aa.group_counts, inp["origins"][:rays],
             inp["dirs"][:rays], 10.0)
    got = twice(lambda: aa_query.nearest_distances(*args))[:rays]
    want = aa_query.nearest_distances_plain(*cargs)
    eq = (got == want).float().mean().item()
    check(eq >= 0.999, f"nearest_distances: only {eq} equal")
    R = inp["origins"].shape[0]
    out["nearest_distances"] = timed(
        lambda: aa_query.nearest_distances(*args),
        lambda: aa_query.nearest_distances_plain(*cargs),
        ray_bound("nearest_distances", n, R, 24 + 4),
        aa_query.nearest_plan(n, False, dev), rays is not None,
        rays=R, compared_rays=want.shape[0], rects=n, equal_share=eq,
        max_abs_err=(got - want).abs().max().item())

    centers, walls, dirs, fac = inp["fused"]
    T = min(centers.shape[0], timed_texels or centers.shape[0])
    Tc = min(T, texels or T)
    run = (aa.fields, aa.group_counts, centers[:T], walls[:T], dirs, fac,
           10.0)
    cargs = (aa.fields, aa.group_counts, centers[:Tc], walls[:Tc], dirs, fac,
             10.0)
    got = twice(lambda: ao.ao_fused(*run))[:Tc]
    want = ao.ao_fused_plain(*cargs)
    sync()
    check(bool(((got == 0) == (want == 0)).all()),
          "ao_fused: zero pattern differs from the plain version")
    nz = want != 0
    rel = ((got[nz] - want[nz]).abs() / want[nz].abs()).max().item()
    check(rel <= 1e-5, f"ao_fused: relative error {rel}")
    K = int((fac > 0).sum().item())   # the real directions
    extra = (12 + 4 + 4) * T + 4 * dirs.numel() + 4 * fac.numel()
    out["ao_fused"] = timed(
        lambda: ao.ao_fused(*run),
        lambda: ao.ao_fused_plain(*cargs),
        ray_bound("ao_fused", n, T * K, 0, extra), ao.ao_fused_plan(n, dev),
        Tc < centers.shape[0], texels=T, compared_texels=Tc, directions=K,
        rects=n, max_rel_err=rel,
        equal_share=(got == want).float().mean().item(),
        max_abs_err=(got - want).abs().max().item())
    return out


def ao_bands(scene, tex, mean=MINI_AA_MEAN):
    """The AO arena of mini against the reference build's dump (the bulk
    bands of tests/test_ao_parity.py, with `mean` for its mean band)."""
    import numpy as np

    gold = np.fromfile(FIXTURES / "mini_ao_texels.f32", dtype="<f4"
                       ).reshape(scene.num_texels, 4)[:, :3]
    l0 = scene.level0_mask()
    rel = np.abs(tex[l0] - gold[l0]) / np.maximum(np.abs(gold[l0]), 1e-6)
    within = float((rel < 5e-4).mean())
    check(bool((rel < 2e-2).all()), f"AO max rel diff {rel.max()}")
    check(within > 0.98, f"AO: only {within} of texels within 5e-4")
    check(float(rel.mean()) < mean, f"AO mean rel {rel.mean()}")
    check(bool((tex[~l0] == 0).all()), "AO wrote a mipmap slot")
    return dict(max_rel=float(rel.max()), share_within_5e4=within,
                mean_rel=float(rel.mean()))


def ao_tiles_match(scene, tex):
    """Tiles 0 and 5 of mini within 1 LSB of the reference PNGs."""
    import numpy as np
    from PIL import Image

    from flatmatch_tpu_torch.io import tiles as tiles_io

    worst = 0
    for idx in (0, 5):
        ours = tiles_io.tile_rgb(scene.walls[idx], tex, tint_extra=True)
        gold = np.asarray(Image.open(FIXTURES / f"mini_ao_tile_{idx}.png")
                          .convert("RGB"))
        check(ours.shape == gold.shape, f"tile {idx} shape")
        diff = np.abs(ours.astype(int) - gold.astype(int))
        check(diff.max() <= 1 and (diff > 0).mean() < 0.02,
              f"tile {idx}: max diff {diff.max()}")
        worst = max(worst, int(diff.max()))
    return worst


def radiosity_bands(scene, out, rays):
    """Radiosity of mini against the reference engine's dump at `rays`:
    the bands of tests/test_radiosity_vs_reference.py (at 10000 rays its
    production bands)."""
    import numpy as np

    from flatmatch_tpu_torch.scene.rectangle import num_tiles

    gold = np.fromfile(FIXTURES / f"mini_radiosity_rays{rays}.f32",
                       dtype="<f4").reshape(scene.num_texels, 4)[:, :3]
    prod = rays == 10000
    check(np.isfinite(out).all(), "radiosity not finite")
    ratio = float(out.sum() / gold.sum())
    check(abs(ratio - 1) <= (0.01 if prod else 0.02),
          f"radiosity energy ratio {ratio} at {rays} rays")
    worst, walls = 0.0, 0
    for i, r in enumerate(scene.walls):
        sl = slice(r.base, r.base + num_tiles(r))
        o, g = out[sl].mean(), gold[sl].mean()
        if g > 1e-3:
            rtol = 0.08 if num_tiles(r) >= 64 else 0.2
            if prod:
                rtol = max(0.02, rtol / np.sqrt(5.0))
            check(abs(o - g) <= rtol * abs(g),
                  f"wall {i} radiosity {o} vs {g} (rtol {rtol}, {rays} rays)")
            worst = max(worst, float(abs(o - g) / (rtol * abs(g))))
            walls += 1
    check(walls >= 5, f"only {walls} walls carried energy")
    corr = float(np.corrcoef(out.ravel(), gold.ravel())[0, 1])
    check(corr > (0.995 if prod else 0.99), f"radiosity correlation {corr}")
    return dict(energy_ratio=ratio, walls_checked=walls,
                worst_wall_share_of_band=worst, texel_corr=corr)


def profiled(fn):
    """Run fn() once under torch.profiler (CUDA activity): its wall
    seconds, the device milliseconds of its kernels in groups (the port's
    kernels by name, PyTorch's own kernels, copies and fills) and the
    share of the wall the device was busy. The groups are None when the
    profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    groups = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        name = e.key
        if "general_nearest_kernel" in name:
            group = "general_nearest.cu"
        elif "nearest_kernel" in name:
            group = "aa_nearest.cu"
        elif "ao_fused_kernel" in name:
            group = "ao_fused.cu"
        elif "trace_deposits_kernel" in name:
            group = "trace_deposits_wide.cu"
        elif "trace_deposits_narrow_kernel" in name:
            group = "trace_deposits_narrow.cu"
        elif "uniform_kernel" in name or "uniform_t_kernel" in name:
            group = "threefry.cu"
        elif any(k in name for k in ("fused_splat", "finish_kernel",
                                      "fixed_to_f32_kernel")):
            group = "splat_stream.cu"
        elif "memcpy" in name.lower() or "memset" in name.lower():
            group = "copies and fills"
        else:
            group = "torch kernels"
        groups[group] = groups.get(group, 0.0) + us / 1e3
    busy = sum(groups.values())
    if busy <= 0:
        return dict(wall_s=wall, device_ms=None, busy_share=None)
    return dict(wall_s=wall, device_ms=groups,
                busy_share=busy / (wall * 1e3))


def cli_render(args, tmp, want_tiles):
    """One `render` through the CLI with the counts reset just before:
    (wall seconds, launches, output dir)."""
    import torch

    from flatmatch_tpu_torch import cli

    out = pathlib.Path(tmp) / "out"
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    rc = cli.main(["render", *args, "--out", str(out)])
    sync()
    wall = time.perf_counter() - t0
    launches = read_launches()
    check(rc == 0, f"cli {args} returned {rc}")
    tiles = len(list((out / "tiles").glob("tile_*.png")))
    check(tiles == want_tiles, f"{tiles} tiles, want {want_tiles}")
    return wall, launches, out


def ao_radiosity_phases(dev, results, make_layout):
    import dataclasses as dc

    import numpy as np
    import torch

    from flatmatch_tpu_torch.config import DEFAULT_CONFIG, Engine
    from flatmatch_tpu_torch.engines import ao, radiosity
    from flatmatch_tpu_torch.ops.mipmap import build_plan
    from flatmatch_tpu_torch.render import compile_scene, run_engine
    from flatmatch_tpu_torch.scene.rectangle import num_tiles

    mini = FIXTURES / "mini.png"
    cfg = DEFAULT_CONFIG
    cfg_ao = cfg.replace(engine=Engine.AMBIENT_OCCLUSION)
    cfg_rad = cfg.replace(engine=Engine.RADIOSITY)
    scene, _ = compile_scene(str(mini), 30.0, cfg)
    T0 = sum(num_tiles(w) for w in scene.walls)

    # 12. the three kernels against their plain versions on mini -----------
    k12 = kernels_vs_plain(nearest_inputs(scene, dev, cfg), 20, 2)
    for name, r in k12.items():
        results[name] = dict(max_abs_err=r["max_abs_err"], ms=r["ms"],
                             plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                             bound_by=r["bound_by"], library_ms=None)
    say("nearest_kernels_vs_plain", scene="mini", **k12)

    # 13. AO physics: fused and chunked against the reference dump ---------
    fused = run_engine(scene, cfg_ao, dev)
    fused2 = run_engine(scene, cfg_ao, dev)
    cfg_chunked = cfg_ao.replace(ao=dc.replace(cfg.ao, fused=False))
    chunked = run_engine(scene, cfg_chunked, dev)
    chunked2 = run_engine(scene, cfg_chunked, dev)
    check(np.array_equal(fused, fused2) and np.array_equal(chunked, chunked2),
          "two AO runs differ")
    nz = chunked != 0
    check(bool(((fused != 0) == nz).all()), "fused and chunked zeros differ")
    fc = float((np.abs(fused[nz] - chunked[nz]) / chunked[nz]).max())
    check(fc < 1e-5, f"fused vs chunked AO {fc}")
    say("ao_physics", scene="mini", fused=ao_bands(scene, fused),
        chunked=ao_bands(scene, chunked), tiles_max_lsb=ao_tiles_match(
            scene, fused), fused_vs_chunked_max_rel=fc, bit_identical=True)

    # 14. AO through the CLI: the fused default, then --ao-chunked ---------
    expect = {"ao_fused": 1, "nearest_distances":
              -(-T0 // ao.chunk_texels(cfg.ao.geosphere_level))}
    cli14 = {}
    for flags, name in (([], "ao_fused"), (["--ao-chunked"],
                                           "nearest_distances")):
        with tempfile.TemporaryDirectory() as tmp:
            wall, launches, out = cli_render(
                [str(mini), "30", "--engine", "ambient_occlusion", *flags],
                tmp, 27)
            for art in ("geometry", "collisionMap"):
                check((out / f"{art}.json").read_bytes()
                      == (FIXTURES / f"mini_{art}.json").read_bytes(),
                      f"{art}.json differs from the fixture")
        check(launches[name] == expect[name],
              f"{name}: {launches[name]} launches, want {expect[name]}")
        check(sum(launches.values()) == launches[name],
              f"AO launched other kernels: {launches}")
        results[name]["launches"] = launches[name]
        cfg14 = cfg_ao.replace(ao=dc.replace(cfg.ao,
                                             fused=name == "ao_fused"))
        sync()
        t0 = time.perf_counter()
        run_engine(scene, cfg14, dev)
        sync()
        engine = time.perf_counter() - t0
        cli14[name] = dict(wall_s=wall, launches=launches[name],
                           run_engine_s=engine,
                           kernel_share_of_run_engine=launches[name]
                           * k12[name]["ms"] / 1e3 / engine)
    say("cli_ao", scene="mini", tiles=27, **cli14)

    # 15. radiosity physics against the reference engine's dumps -----------
    rad5 = dc.replace(cfg.radiosity, seed=5)
    r2k = [radiosity.render_radiosity(
        scene, dc.replace(rad5, rays_per_texel=2000), dev) for _ in range(2)]
    check(np.array_equal(r2k[0], r2k[1]), "two radiosity runs differ")
    t0 = time.perf_counter()
    r10k = radiosity.render_radiosity(scene, rad5, dev)
    wall10k = time.perf_counter() - t0
    say("radiosity_physics", scene="mini", seed=5,
        rays2000=radiosity_bands(scene, r2k[0], 2000),
        rays10000=radiosity_bands(scene, r10k, 10000),
        rays10000_wall_s=wall10k, bit_identical=True)

    # 16. radiosity through the CLI at its defaults -------------------------
    n_chunks = sum(-(-num_tiles(w) // cfg.radiosity.texels_per_chunk)
                   for w in scene.walls)
    with tempfile.TemporaryDirectory() as tmp:
        wall16, launches, out = cli_render(
            [str(mini), "30", "--engine", "radiosity"], tmp, 27)
        peak16 = torch.cuda.max_memory_allocated()
        for art in ("geometry", "collisionMap"):
            check((out / f"{art}.json").read_bytes()
                  == (FIXTURES / f"mini_{art}.json").read_bytes(),
                  f"{art}.json differs from the fixture")
    check(launches["aa_nearest"] == n_chunks
          and launches["threefry_uniform"] == n_chunks,
          f"aa_nearest and threefry: {launches}, want {n_chunks} each")
    check(sum(launches.values()) == 2 * n_chunks,
          f"radiosity launched other kernels: {launches}")
    results["aa_nearest"]["launches"] = n_chunks

    def split(scene_, rad):
        """Seconds of the form factors and of the relaxation, the table's
        bytes, and a profiled rerun of each (device time by group)."""
        rects, aa, src = radiosity.prepare(scene_, rad, dev)
        l0 = torch.from_numpy(radiosity.level0_arena_indices(scene_)).to(dev)
        plan = build_plan(rects)
        sync()
        t0 = time.perf_counter()
        ids = radiosity.form_factors(scene_, aa, rad)
        sync()
        t1 = time.perf_counter()
        radiosity.relax(src, ids, l0, plan, rad)
        sync()
        t2 = time.perf_counter()
        return dict(
            form_factor_s=t1 - t0, relax_s=t2 - t1,
            table_bytes=ids.numel() * 4,
            form_factor_profile=profiled(
                lambda: radiosity.form_factors(scene_, aa, rad)),
            relax_profile=profiled(
                lambda: radiosity.relax(src, ids, l0, plan, rad)))

    split16 = split(scene, cfg.radiosity)
    say("cli_radiosity", scene="mini", rays=cfg.radiosity.rays_per_texel,
        tiles=27, wall_s=wall16, launches=n_chunks, peak_bytes=peak16,
        **split16)

    # 17. both engines on the 4x4 tiling at their defaults ------------------
    with tempfile.TemporaryDirectory() as tmp:
        png = pathlib.Path(tmp) / "mini_4x4.png"
        make_layout.tiled(str(mini), str(png), 4, 4)
        scene6, _ = compile_scene(str(png), 30.0, cfg)
    k17 = kernels_vs_plain(nearest_inputs(scene6, dev, cfg), 5, 1,
                           texels=8192)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    ao6 = run_engine(scene6, cfg_ao, dev)
    wall_ao6 = time.perf_counter() - t0
    ao_launches6 = read_launches()["ao_fused"]
    ao_peak6 = torch.cuda.max_memory_allocated()
    check(ao_launches6 == 1, f"4x4 AO: {ao_launches6} launches")
    l06 = scene6.level0_mask()
    check(np.isfinite(ao6).all() and (ao6[l06] > 0).all(),
          "4x4 AO not finite and positive")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    rad6 = run_engine(scene6, cfg_rad, dev)
    wall_rad6 = time.perf_counter() - t0
    rad_launches6 = read_launches()["aa_nearest"]
    rad_peak6 = torch.cuda.max_memory_allocated()
    n_chunks6 = sum(-(-num_tiles(w) // cfg.radiosity.texels_per_chunk)
                    for w in scene6.walls)
    check(rad_launches6 == n_chunks6,
          f"4x4 radiosity: {rad_launches6} launches, want {n_chunks6}")
    check(np.isfinite(rad6).all() and rad6.sum() > 0
          and (rad6 >= 0).all(), "4x4 radiosity not finite and positive")
    say("apartment_4x4_ao_radiosity", rects=len(scene6.walls),
        texels=scene6.num_texels, level0_texels=int(l06.sum()),
        ao=dict(wall_s=wall_ao6, launches=ao_launches6, peak_bytes=ao_peak6,
                kernel_share_of_wall=k17["ao_fused"]["ms"] / 1e3 / wall_ao6,
                profile=profiled(lambda: run_engine(scene6, cfg_ao, dev))),
        radiosity=dict(rays=cfg.radiosity.rays_per_texel, wall_s=wall_rad6,
                       launches=rad_launches6, peak_bytes=rad_peak6,
                       **split(scene6, cfg.radiosity)),
        kernels=k17)
    walls = dict(ao_wall_s=wall_ao6, ao_fused_launches=ao_launches6,
                 radiosity_wall_s=wall_rad6,
                 radiosity_aa_nearest_launches=rad_launches6)
    return walls, {"mini": k12, "4x4": k17}


# --------------------------------------------------------------------------
# the deposit-stream tier (phases 18-21)
# --------------------------------------------------------------------------
def stream_bounces(col, B, D, block):
    """Traced bounces of a stream: every live row plus the bounce that
    misses, for each photon that dies within D bounces."""
    live = col.sum(-1).reshape(B // block, D, block) > 0
    return int(live.sum().item()) + B - int(live[:, -1].sum().item())


def stream_phases(dev, results, cfg, s, s5, s6):
    import dataclasses as dc

    import numpy as np
    import torch

    from flatmatch_tpu_torch.engines import photon_wide as pw
    from flatmatch_tpu_torch.ops import splat as sp, threefry
    from flatmatch_tpu_torch.ops.aa_scene import pack_aa
    from flatmatch_tpu_torch.render import run_engine

    mini = FIXTURES / "mini.png"

    def route(base, device_rng, splat):
        return base.replace(photon=dc.replace(
            base.photon, device_rng=device_rng, splat=splat))

    ph = route(cfg, True, "fused").photon
    B, D = ph.photons_per_batch, ph.max_depth
    U, block = pw.uniforms_per_photon(D), pw.stream_block(B)
    R = B * D

    # 18. the four kernels against their plain versions on mini ------------
    f, gc, ev = s["aa_c"].fields, s["aa_c"].group_counts, s["ev"]
    u = threefry.batch_uniforms(ph.seed, 0, B, U, dev, transposed=True)
    traces = {
        "trace_deposits_wide_rng": (
            lambda: pw.trace_deposits_wide_rng(f, gc, ev, s["seed"], B, B,
                                               ph, block),
            lambda: pw.stream_rows(*pw.trace_deposits_rng_plain(
                f, gc, ev, s["seed"], B, B, ph)[:2], block)),
        "trace_deposits_wide": (
            lambda: pw.trace_deposits_wide(f, gc, ev, u, B, ph, block),
            lambda: pw.trace_deposits_wide_plain(f, gc, ev, u.t(), B, ph,
                                                 block)),
    }
    k18, streams = {}, {}
    for name, (run, plain) in traces.items():
        a, b = run(), run()
        want = plain()
        sync()
        ids_eq = (a[0] == want[0]).float().mean().item()
        col_eq = (a[1] == want[1]).all(-1).float().mean().item()
        check(ids_eq == 1.0 and col_eq == 1.0,
              f"{name}: ids equal on {ids_eq}, colors on {col_eq} of rows")
        check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
              f"{name}: two runs differ")
        check(want[1].sum().item() > 0, f"{name}: plain stream is empty")
        bounces = stream_bounces(want[1], B, D, block)
        bnd = trace_bound(s, bounces, B, name, D)
        k18[name] = dict(
            rows=R, ids_equal=ids_eq, colors_equal=col_eq,
            bit_identical_rerun=True,
            max_abs_err=(a[1] - want[1]).abs().max().item(),
            traced_bounces_per_photon=bounces / B,
            ms=kernel_ms(run, 20), plain_ms=cuda_ms(plain, 3),
            bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)
        streams[name] = a
    idx, col = streams["trace_deposits_wide_rng"]
    T = s["total_c"]
    scale = sp.splat_color_scale(ph)
    total = sp.stream_bound(ph)
    # each kernel against its exact function, bit for bit: the 7-bit
    # plain version, and fused_splat_fixed_plain for row 16; the plain
    # pair (fused_splat_fixed_plain against index_add_'s f32 order, the
    # CPU's plain versions) within rtol 1e-5
    lm18 = torch.from_numpy(np.random.RandomState(18).rand(T, 3).astype(
        np.float32)).to(dev)
    splats = {
        "fused_splat_i8": (
            lambda: sp.fused_splat_i8(idx, col, T, scale),
            lambda: sp.fused_splat_i8_plain(idx, col, T, scale), None),
        "fused_splat_i8_add": (
            lambda: sp.fused_splat_i8_add(lm18.clone(), idx, col, scale),
            lambda: lm18 + sp.fused_splat_i8_plain(idx, col, T, scale),
            None),
        "fused_splat": (
            lambda: sp.fused_splat(idx, col, T, total),
            lambda: sp.fused_splat_fixed_plain(idx, col, T, total),
            lambda: sp.fused_splat_plain(idx, col, T)),
        "fused_splat_f32": (
            lambda: sp.scatter_splat(idx, col, T, total),
            lambda: sp.fused_splat_fixed_plain(idx, col, T, total, False),
            lambda: sp.scatter_plain(idx, col, T)),
    }
    for name, (run, exact, plain) in splats.items():
        a, b = run(), run()
        want = exact()
        sync()
        check(torch.equal(a, b), f"{name}: two runs differ")
        check(want.sum().item() > 0, f"{name}: plain splat is empty")
        check(torch.equal(a, want), f"{name}: differs from its exact "
              f"plain version")
        pair = {}
        if plain is not None:
            ref = plain()
            check(bool(((want - ref).abs() <= 1e-5 * ref.abs() + 1e-6)
                       .all()), f"{name}: fused_splat_fixed_plain not "
                  f"within rtol 1e-5 of index_add_")
            pair = dict(plain_pair_max_abs_err=(want - ref).abs().max()
                        .item())
        bnd = splat_bound(R, T, name)
        k18[name] = dict(
            rows=R, texels=T, equal_share=(a == want).float().mean().item(),
            max_abs_err=(a - want).abs().max().item(), **pair,
            bit_identical_rerun=True,
            ms=kernel_ms(run, 20), plain_ms=cuda_ms(exact, 5),
            bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)
    # yardstick: one index_add_ of the same pre-rounded stream
    rounded = col.to(torch.bfloat16).to(torch.float32)
    idx64 = idx.to(torch.int64)
    buf = torch.zeros((T, 3), dtype=torch.float32, device=dev)
    k18["fused_splat"]["library_ms"] = kernel_ms(
        lambda: buf.index_add_(0, idx64, rounded), 20)
    for name in KERNEL_SITES:
        if name in k18:
            results[name] = {k: k18[name][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}
    say("stream_kernels_vs_plain", scene="mini", batch=B, block=block,
        **k18)

    # 19. the physics gate of phase 5 on four stream routes ------------------
    scene = s5["scene"]
    aa5 = pack_aa(scene.walls, device=dev)
    gates = {}
    for splat, device_rng, kernels in (
            ("fused", True, ("trace_deposits_wide_rng", "fused_splat")),
            ("fused", False, ("trace_deposits_wide", "fused_splat",
                              "threefry_uniform")),
            ("fused_i8", True, ("trace_deposits_wide_rng", "fused_splat_i8",
                                "fused_splat_i8_add")),
            ("scatter", True, ("trace_deposits_wide_rng", "fused_splat"))):
        key = f"{splat}_{'device_rng' if device_rng else 'threefry'}"
        c = route(s5["cfg"], device_rng, splat).photon
        reset_launches()
        raw = pw.render_photons(s5["em"], scene.num_texels, c, aa5)
        sync()
        launches = read_launches()
        check(all(launches[k] > 0 for k in kernels)
              and sum(launches.values()) == sum(launches[k]
                                                for k in kernels),
              f"{key}: launches {launches}")
        gates[key] = dict(launches={k: launches[k] for k in kernels},
                          **physics_bands(scene, raw.cpu().numpy(), key))
    say("stream_physics_vs_reference", scene="mini",
        samples_per_area=s5["cfg"].photon.samples_per_area, **gates)

    # 20. the CLI on mini at its default budget -----------------------------
    counts = s["em"].counts
    n_batches = sum(-(-int(n) // B) for n in counts if n > 0)
    photons = int(counts.sum())
    cli20 = {}
    for key, flags, kernels in (
            ("fused_device_rng", ["--splat", "fused"],
             ("trace_deposits_wide_rng", "fused_splat")),
            ("fused_threefry", ["--no-device-rng", "--splat", "fused"],
             ("trace_deposits_wide", "fused_splat", "threefry_uniform")),
            ("fused_i8_device_rng", ["--splat", "fused_i8"],
             ("trace_deposits_wide_rng", "fused_splat_i8",
              "fused_splat_i8_add"))):
        with tempfile.TemporaryDirectory() as tmp:
            wall, launches, out = cli_render([str(mini), "30", *flags], tmp,
                                             27)
            for art in ("geometry", "collisionMap"):
                check((out / f"{art}.json").read_bytes()
                      == (FIXTURES / f"mini_{art}.json").read_bytes(),
                      f"{art}.json differs from the fixture")
        for k in kernels:
            check(launches[k] == n_batches,
                  f"{key}: {k} launched {launches[k]}, want {n_batches}")
            if k in results:   # the threefry kernel's row comes later
                results[k].setdefault("launches", launches[k])
        check(sum(launches.values()) == len(kernels) * n_batches,
              f"{key}: other kernels ran: {launches}")
        cli20[key] = dict(wall_s=wall, photons_per_s=photons / wall,
                          launches={k: launches[k] for k in kernels})
    # the library's entry point with no cfg: threefry draws, --splat fused
    from flatmatch_tpu_torch.render import render

    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        sync()
        t0 = time.perf_counter()
        res = render(str(mini), tmp)
        sync()
        wall = time.perf_counter() - t0
        launches = read_launches()
    check(len(res.tile_paths) == 27 and bool(np.isfinite(res.texels).all())
          and res.texels.sum() > 0, "render(png) gave no finite tiles")
    check(launches["trace_deposits_wide"] == n_batches
          and launches["fused_splat"] == n_batches
          and launches["threefry_uniform"] == n_batches
          and sum(launches.values()) == 3 * n_batches,
          f"render(png) launches {launches}")
    cli20["library_default"] = dict(
        wall_s=wall, photons_per_s=photons / wall,
        launches={k: launches[k] for k in ("trace_deposits_wide",
                                           "fused_splat")})
    # the threefry route's split: the draws (in the [U, B] layout the
    # trace reads), the trace kernel and the splat, per batch and per
    # render, and a profiled run_engine
    cfg_tf = route(cfg, False, "fused")
    draw_ms = cuda_ms(lambda: threefry.batch_uniforms(ph.seed, 0, B, U, dev,
                                                      transposed=True), 5)
    sync()
    t0 = time.perf_counter()
    run_engine(s["scene"], cfg_tf, dev)
    sync()
    engine_s = time.perf_counter() - t0
    cli20["fused_threefry"].update(
        run_engine_s=engine_s, draws_ms_per_batch=draw_ms,
        trace_ms_per_batch=k18["trace_deposits_wide"]["ms"],
        splat_ms_per_batch=k18["fused_splat"]["ms"],
        draws_s_per_render=draw_ms * n_batches / 1e3,
        trace_s_per_render=k18["trace_deposits_wide"]["ms"] * n_batches
        / 1e3,
        splat_s_per_render=k18["fused_splat"]["ms"] * n_batches / 1e3,
        profile=profiled(lambda: run_engine(s["scene"], cfg_tf, dev)))
    say("cli_stream", scene="mini", photons=photons, batches=n_batches,
        tiles=27, **cli20)

    # 21. the 4x4 tiling at full budget, --splat fused (device RNG) -------
    # every stream kernel on batch 0 of the tiling: ms, plain ms, bound
    f6, gc6, ev6 = s6["aa_c"].fields, s6["aa_c"].group_counts, s6["ev"]
    T6 = s6["total_c"]
    u6 = threefry.batch_uniforms(ph.seed, 0, B, U, dev, transposed=True)
    runs6 = {
        "trace_deposits_wide_rng": (
            lambda: pw.trace_deposits_wide_rng(f6, gc6, ev6, s6["seed"], B,
                                               B, ph, block),
            lambda: pw.stream_rows(*pw.trace_deposits_rng_plain(
                f6, gc6, ev6, s6["seed"], B, B, ph)[:2], block)),
        "trace_deposits_wide": (
            lambda: pw.trace_deposits_wide(f6, gc6, ev6, u6, B, ph, block),
            lambda: pw.trace_deposits_wide_plain(f6, gc6, ev6, u6.t(), B,
                                                 ph, block)),
    }
    k21 = {}
    for name, (run, plain) in runs6.items():
        want = plain()
        k21[name] = dict(ms=cuda_ms(run, 10), plain_ms=cuda_ms(plain, 1))
        bnd = trace_bound(s6, stream_bounces(want[1], B, D, block), B, name,
                          D)
        k21[name].update(bound_ms=bnd[0], bound_by=bnd[1])
    idx6, col6 = runs6["trace_deposits_wide_rng"][0]()
    splats6 = {
        "fused_splat_i8": (
            lambda: sp.fused_splat_i8(idx6, col6, T6, scale),
            lambda: sp.fused_splat_i8_plain(idx6, col6, T6, scale)),
        "fused_splat": (
            lambda: sp.fused_splat(idx6, col6, T6, total),
            lambda: sp.fused_splat_plain(idx6, col6, T6)),
        "fused_splat_f32": (
            lambda: sp.scatter_splat(idx6, col6, T6, total),
            lambda: sp.scatter_plain(idx6, col6, T6)),
    }
    for name, (run, plain) in splats6.items():
        bnd = splat_bound(R, T6, name)
        k21[name] = dict(ms=kernel_ms(run, 10), plain_ms=cuda_ms(plain, 3),
                         bound_ms=bnd[0], bound_by=bnd[1])
    rounded6 = col6.to(torch.bfloat16).to(torch.float32)
    idx6_64 = idx6.to(torch.int64)
    buf6 = torch.zeros((T6, 3), dtype=torch.float32, device=dev)
    k21["fused_splat"]["library_ms"] = kernel_ms(
        lambda: buf6.index_add_(0, idx6_64, rounded6), 10)
    scene6 = s6["scene"]
    batches6 = sum(-(-int(n) // B) for n in s6["em"].counts if n > 0)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    tex = run_engine(scene6, route(cfg, True, "fused"), dev)
    wall6 = time.perf_counter() - t0
    launches = read_launches()
    peak6 = torch.cuda.max_memory_allocated()
    for k in ("trace_deposits_wide_rng", "fused_splat"):
        check(launches[k] == batches6,
              f"4x4 fused: {k} launched {launches[k]}, want {batches6}")
    check(sum(launches.values()) == 2 * batches6,
          f"4x4 fused: other kernels ran: {launches}")
    check(bool(np.isfinite(tex).all()) and tex.sum() > 0,
          "4x4 fused render not finite")
    say("apartment_4x4_stream", splat="fused", device_rng=True,
        rects=len(scene6.walls), compact_texels=T6,
        photons=int(s6["em"].counts.sum()), batches=batches6,
        launches=launches, wall_s=wall6, peak_bytes=peak6,
        photons_per_s=int(s6["em"].counts.sum()) / wall6,
        trace_ms_per_batch=k21["trace_deposits_wide_rng"]["ms"],
        splat_ms_per_batch=k21["fused_splat"]["ms"], kernels=k21)


# --------------------------------------------------------------------------
# the other in-kernel tiers (phases 22-25)
# --------------------------------------------------------------------------
def inkernel_runs(s, cfg, dev, power):
    """The four in-kernel kernels of batch 0 of `s` (diff inputs at
    `power`): (the batch's threefry uniforms, name -> (kernel call, its
    plain version on the card))."""
    import torch

    from flatmatch_tpu_torch.diff.render import fixed_pair
    from flatmatch_tpu_torch.engines import photon_wide as pw
    from flatmatch_tpu_torch.ops import threefry

    ph = cfg.photon
    B = ph.photons_per_batch
    f, gc, ev = s["aa_c"].fields, s["aa_c"].group_counts, s["ev"]
    T, seed = s["total_c"], s["seed"]
    u = threefry.batch_uniforms(ph.seed, 0, B,
                                pw.uniforms_per_photon(ph.max_depth), dev,
                                transposed=True)
    d = diff_setup(s, cfg, dev, power)
    fixed = fixed_pair(ph, torch.tensor([power], device=dev), d["alb"], B)
    return u, {
        "trace_splat_wide_rng_f32": (
            lambda: pw.trace_splat_wide_rng_f32(f, gc, ev, seed, B, B, ph, T),
            lambda: pw.trace_splat_wide_rng_f32_plain(f, gc, ev, seed, B, B,
                                                      ph, T)),
        "trace_splat_wide_i8": (
            lambda: pw.trace_splat_wide_i8(f, gc, ev, u, B, ph, T),
            lambda: pw.trace_splat_wide_plain(f, gc, ev, u.t(), B, ph, T,
                                              True)),
        "trace_splat_wide_f32": (
            lambda: pw.trace_splat_wide_f32(f, gc, ev, u, B, ph, T),
            lambda: pw.trace_splat_wide_plain(f, gc, ev, u.t(), B, ph, T,
                                              False)),
        "trace_splat_wide_diff_rng_f32": (
            lambda: pw.trace_splat_wide_diff_rng_f32(
                f, gc, d["alb"], d["ev"], seed, B, B, ph, T, fixed),
            lambda: pw.trace_splat_wide_rng_f32_plain(
                f, gc, d["ev"], seed, B, B, ph, T, d["alb"])),
    }


def inkernel_bounces(s, cfg, u):
    """Traced bounces of batch 0 of `s`: (counter hash, threefry)."""
    from flatmatch_tpu_torch.engines import photon_wide as pw

    ph = cfg.photon
    B, D = ph.photons_per_batch, ph.max_depth
    block = pw.stream_block(B)
    _, col = pw.trace_deposits_wide_plain(s["aa_c"].fields,
                                          s["aa_c"].group_counts, s["ev"],
                                          u.t(), B, ph, block)
    return traced_bounces(s, cfg, B), stream_bounces(col, B, D, block)


def inkernel_phases(dev, results, cfg, s, s5, s6):
    import dataclasses as dc

    import numpy as np
    import torch

    from flatmatch_tpu_torch import cli
    from flatmatch_tpu_torch.diff.render import make_diff_renderer_wide
    from flatmatch_tpu_torch.engines import photon_wide as pw
    from flatmatch_tpu_torch.ops import splat as sp
    from flatmatch_tpu_torch.ops.aa_scene import pack_aa
    from flatmatch_tpu_torch.render import run_engine

    mini = FIXTURES / "mini.png"

    def route(base, device_rng, splat):
        return base.replace(photon=dc.replace(
            base.photon, device_rng=device_rng, splat=splat))

    ph = cfg.photon
    B, D = ph.photons_per_batch, ph.max_depth
    scale = float(np.float32(sp.splat_color_scale(ph)))

    # 22. the four kernels against their plain versions on mini ------------
    u, runs = inkernel_runs(s, cfg, dev, power=1.7)
    hashed, drawn = inkernel_bounces(s, cfg, u)
    k22 = {}
    for name, (run, plain) in runs.items():
        a, b = run(), run()
        want = plain()
        sync()
        check(torch.equal(a, b), f"{name}: two runs differ")
        check(want.sum().item() > 0, f"{name}: plain version is empty")
        if name == "trace_splat_wide_i8":
            check(torch.equal(a, want), f"{name}: differs from its plain "
                  f"version on {int((a != want).sum().item())} cells")
            err = (a - want).abs().max().item() * scale
        else:
            check(bool(((a - want).abs() <= 1e-5 * want.abs() + 1e-5).all()),
                  f"{name}: not within rtol 1e-5, atol 1e-5 of plain")
            err = (a - want).abs().max().item()
        bounces = drawn if name in UNIFORM_KERNELS else hashed
        bnd = trace_bound(s, bounces, B, name, D)
        k22[name] = dict(
            cells=a.numel(), equal_share=(a == want).float().mean().item(),
            max_abs_err=err, bit_identical_rerun=True,
            traced_bounces_per_photon=bounces / B,
            ms=kernel_ms(run, 20), plain_ms=cuda_ms(plain, 3),
            bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)
        results[name] = {k: k22[name][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}
    say("inkernel_kernels_vs_plain", scene="mini", batch=B, **k22)

    # 23. the exactness identities ------------------------------------------
    f, gc, ev, T = (s["aa_c"].fields, s["aa_c"].group_counts, s["ev"],
                    s["total_c"])
    bound = sp.stream_bound(ph)
    streams = {
        "trace_splat_wide_rng_f32": ("trace_deposits_wide_rng",
                                     pw.trace_deposits_wide_rng(
                                         f, gc, ev, s["seed"], B, B, ph)),
        "trace_splat_wide_f32": ("trace_deposits_wide",
                                 pw.trace_deposits_wide(f, gc, ev, u, B, ph)),
    }
    same = {}
    for name, (trace, (idx, col)) in streams.items():
        got = runs[name][0]()
        want = sp.fused_splat(idx, col, T, bound)
        sync()
        check(torch.equal(got, want),
              f"{name}: differs from {trace} + fused_splat on "
              f"{int((got != want).sum().item())} cells")
        same[name] = f"{trace} + fused_splat"
    _, runs1 = inkernel_runs(s, cfg, dev, power=1.0)
    diff1 = runs1["trace_splat_wide_diff_rng_f32"][0]()
    prod1 = runs1["trace_splat_wide_rng_f32"][0]()
    sync()
    check(torch.equal(diff1, prod1), "trace_splat_wide_diff_rng_f32 at "
          "uniform albedo and power 1 differs from trace_splat_wide_rng_f32")
    say("inkernel_identities", scene="mini", batch=B,
        bit_equal_to_stream_route=same,
        diff_f32_at_defaults_bit_equal_to="trace_splat_wide_rng_f32",
        bit_identical_reruns=sorted(F32_KERNELS))

    # 24. the physics gate of phase 5 on the three routes -------------------
    scene = s5["scene"]
    aa5 = pack_aa(scene.walls, device=dev)
    routes = (("inkernel_device_rng", True, "inkernel",
               "trace_splat_wide_rng_f32", ["--splat", "inkernel"]),
              ("inkernel_i8_threefry", False, "inkernel_i8",
               "trace_splat_wide_i8", ["--no-device-rng"]),
              ("inkernel_threefry", False, "inkernel",
               "trace_splat_wide_f32", ["--no-device-rng", "--splat",
                                        "inkernel"]))
    gates = {}
    for key, device_rng, splat, kernel, _ in routes:
        c = route(s5["cfg"], device_rng, splat).photon
        reset_launches()
        raw = pw.render_photons(s5["em"], scene.num_texels, c, aa5)
        sync()
        launches = read_launches()
        # the threefry routes draw each batch with the threefry kernel
        draws = 0 if device_rng else launches[kernel]
        check(launches[kernel] > 0 and launches["threefry_uniform"] == draws
              and sum(launches.values()) == launches[kernel] + draws,
              f"{key}: launches {launches}")
        gates[key] = dict(launches=launches[kernel],
                          **physics_bands(scene, raw.cpu().numpy(), key))
    say("inkernel_physics_vs_reference", scene="mini",
        samples_per_area=s5["cfg"].photon.samples_per_area, **gates)

    # 25. the routes through the CLI on mini, the fit, and 4x4 -------------
    counts = s["em"].counts
    n_batches = sum(-(-int(n) // B) for n in counts if n > 0)
    photons = int(counts.sum())
    cli25 = {}
    for key, device_rng, _, kernel, flags in routes:
        with tempfile.TemporaryDirectory() as tmp:
            wall, launches, out = cli_render([str(mini), "30", *flags], tmp,
                                             27)
            for art in ("geometry", "collisionMap"):
                check((out / f"{art}.json").read_bytes()
                      == (FIXTURES / f"mini_{art}.json").read_bytes(),
                      f"{art}.json differs from the fixture")
        draws = 0 if device_rng else n_batches
        check(launches[kernel] == n_batches
              and launches["threefry_uniform"] == draws
              and sum(launches.values()) == n_batches + draws,
              f"{key}: launches {launches}, want {n_batches} of {kernel}")
        results[kernel]["launches"] = launches[kernel]
        cli25[key] = dict(wall_s=wall, photons_per_s=photons / wall,
                          launches={kernel: launches[kernel]})
    steps = 100
    fit_batches = len(make_diff_renderer_wide(
        s["em"], s["scene"].num_texels,
        route(cfg, True, "inkernel").photon,
        pack_aa(s["scene"].walls, device=dev)).batches)
    with tempfile.TemporaryDirectory() as tmp:
        target = pathlib.Path(tmp) / "target"
        check(cli.main(["render", str(mini), "30", "--dump-raw", "--out",
                        str(target)]) == 0, "render --dump-raw failed")
        reset_launches()
        sync()
        t0 = time.perf_counter()
        rc = cli.main(["fit", str(mini), str(target / "tiles"), "30",
                       "--splat", "inkernel", "--fit-init-albedo", "0.6",
                       "--fit-init-power", "0.5", "--out",
                       str(pathlib.Path(tmp) / "fit")])
        sync()
        wall_fit = time.perf_counter() - t0
        fit_launches = read_launches()
        check(rc == 0, f"fit --splat inkernel returned {rc}")
        rep = json.loads((pathlib.Path(tmp) / "fit" / "fitted.json")
                         .read_text())
    check(rep["final_loss"] < rep["initial_loss"] / 10,
          f"fit --splat inkernel: loss {rep['initial_loss']} -> "
          f"{rep['final_loss']}")
    n_diff = fit_launches["trace_splat_wide_diff_rng_f32"]
    n_fold = fit_launches["trace_fold_wide_rng"]
    check(n_diff == (steps + 1) * fit_batches
          and n_fold == steps * fit_batches
          and sum(fit_launches.values()) == n_diff + n_fold,
          f"fit --splat inkernel: launches {fit_launches}")
    results["trace_splat_wide_diff_rng_f32"]["launches"] = n_diff
    cli25["fit_inkernel"] = dict(
        steps=steps, initial_loss=rep["initial_loss"],
        final_loss=rep["final_loss"],
        loss_ratio=rep["final_loss"] / rep["initial_loss"],
        wall_s=wall_fit, wall_s_per_step=wall_fit / steps,
        launches={k: fit_launches[k] for k in (
            "trace_splat_wide_diff_rng_f32", "trace_fold_wide_rng")})
    say("cli_inkernel", scene="mini", photons=photons, batches=n_batches,
        tiles=27, **cli25)

    # every new kernel on batch 0 of the tiling, then --splat inkernel there
    u6, runs6 = inkernel_runs(s6, cfg, dev, power=1.7)
    hashed6, drawn6 = inkernel_bounces(s6, cfg, u6)
    k25 = {}
    for name, (run, plain) in runs6.items():
        bnd = trace_bound(s6, drawn6 if name in UNIFORM_KERNELS else hashed6,
                          B, name, D)
        k25[name] = dict(ms=cuda_ms(run, 10), plain_ms=cuda_ms(plain, 1),
                         bound_ms=bnd[0], bound_by=bnd[1])
    scene6 = s6["scene"]
    batches6 = sum(-(-int(n) // B) for n in s6["em"].counts if n > 0)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    tex = run_engine(scene6, route(cfg, True, "inkernel"), dev)
    wall6 = time.perf_counter() - t0
    launches = read_launches()
    check(launches["trace_splat_wide_rng_f32"] == batches6
          and sum(launches.values()) == batches6,
          f"4x4 inkernel: launches {launches}, want {batches6}")
    check(bool(np.isfinite(tex).all()) and tex.sum() > 0,
          "4x4 inkernel render not finite")
    say("apartment_4x4_inkernel", splat="inkernel", device_rng=True,
        rects=len(scene6.walls), compact_texels=s6["total_c"],
        photons=int(s6["em"].counts.sum()), batches=batches6,
        launches=launches["trace_splat_wide_rng_f32"], wall_s=wall6,
        peak_bytes=torch.cuda.max_memory_allocated(),
        photons_per_s=int(s6["em"].counts.sum()) / wall6, kernels=k25)


# --------------------------------------------------------------------------
# the threefry kernel and the fit's threefry and stream tiers (phases 26-30)
# --------------------------------------------------------------------------
def fwd_bwd_ms(dev, r, n_rect, n_em, albedo, power):
    """Device ms of one forward and one backward of loss = mean(lm^2),
    timed with CUDA events, and the wall seconds of both."""
    import torch

    a = torch.full((n_rect,), albedo, device=dev, requires_grad=True)
    p = torch.full((n_em,), power, device=dev, requires_grad=True)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    sync()
    t0 = time.perf_counter()
    ev[0].record()
    loss = torch.mean(r(a, p) ** 2)
    ev[1].record()
    loss.backward()
    ev[2].record()
    sync()
    wall = time.perf_counter() - t0
    check(bool(torch.isfinite(a.grad).all() & torch.isfinite(p.grad)
               .all()), "gradient not finite")
    return ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]), wall


def threefry_bound(n):
    """Bound of one threefry draw of n elements: 4 bytes written per
    element (the key is two scalars), THREEFRY_OPS integer operations per
    element at the int32 rate."""
    t_bytes = 4 * n / HBM_BYTES_PER_S * 1e3
    t_ops = n * THREEFRY_OPS / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def diff_uniform_runs(s, cfg, dev, power, seed=7):
    """Rows 6, 7 (i8, f32) and 9 on batch 0 of `s` with its threefry
    uniforms drawn transposed, as the diff renderer draws them, and diff
    inputs at `power` (diff_setup): (inputs, name -> (kernel call, plain
    version on the card))."""
    import torch

    from flatmatch_tpu_torch.diff.render import diff_block, fixed_pair
    from flatmatch_tpu_torch.engines import photon_wide as pw
    from flatmatch_tpu_torch.ops import threefry

    ph = cfg.photon
    B = ph.photons_per_batch
    f, gc, T = s["aa_c"].fields, s["aa_c"].group_counts, s["total_c"]
    n = f.shape[1]
    d = diff_setup(s, cfg, dev, power, seed)
    u_t = threefry.batch_uniforms(ph.seed, 0, B,
                                  pw.uniforms_per_photon(ph.max_depth), dev,
                                  transposed=True)
    fixed = fixed_pair(ph, torch.tensor([power], device=dev), d["alb"], B)
    block = diff_block(B)

    def plain():
        return pw.trace_uniforms_plain(f, gc, d["ev"], u_t.t(), B, ph,
                                       d["alb"])

    def plain_stream():
        idx, col, ridx = plain()
        return pw.stream_rows(idx, col, block, ridx)

    d.update(u_t=u_t, fixed=fixed, block=block)
    return d, {
        "trace_deposits_wide_diff": (
            lambda: pw.trace_deposits_wide_diff(f, gc, d["alb"], d["ev"], u_t,
                                                B, ph, block),
            plain_stream),
        "trace_splat_wide_diff_i8": (
            lambda: pw.trace_splat_wide_diff_i8(f, gc, d["alb"], d["ev"], u_t,
                                                B, ph, T, d["inv"]),
            lambda: pw.splat_i8_plain(*plain()[:2], T, d["inv"].item())),
        "trace_splat_wide_diff_f32": (
            lambda: pw.trace_splat_wide_diff_f32(f, gc, d["alb"], d["ev"],
                                                 u_t, B, ph, T, fixed),
            lambda: pw.splat_f32_plain(*plain()[:2], T)),
        "trace_fold_wide": (
            lambda: pw.trace_fold_wide(f, gc, d["alb"], d["ev"], d["g"], u_t,
                                       B, ph, n),
            lambda: pw.fold_plain(*plain(), d["g"], n)),
    }


def diff_uniform_bounds(s, cfg, u_t, D):
    """Bounds of rows 6, 7 and 9 on batch 0 of `s`: the traced bounces of
    its threefry photons (the forward's trajectories: the albedo does not
    move them)."""
    from flatmatch_tpu_torch.engines import photon_wide as pw

    ph = cfg.photon
    B = ph.photons_per_batch
    block = pw.stream_block(B)
    _, col = pw.trace_deposits_wide_plain(s["aa_c"].fields,
                                          s["aa_c"].group_counts, s["ev"],
                                          u_t.t(), B, ph, block)
    bounces = stream_bounces(col, B, D, block)
    return bounces, {name: trace_bound(s, bounces, B, name, D)
                     for name in DIFF_UNIFORM_KERNELS}


def threefry_phases(dev, results, cfg, s, s6, make_layout):
    import dataclasses as dc

    import numpy as np
    import torch

    from flatmatch_tpu_torch import cli
    from flatmatch_tpu_torch.diff.render import (
        make_diff_renderer_wide, stream_total_bound,
    )
    from flatmatch_tpu_torch.engines import ao, photon_wide as pw
    from flatmatch_tpu_torch.ops import aa_query, splat as sp, threefry
    from flatmatch_tpu_torch.ops.aa_scene import pack_aa
    from flatmatch_tpu_torch.scene.rectangle import num_tiles

    mini = FIXTURES / "mini.png"
    ph = cfg.photon
    B, D = ph.photons_per_batch, ph.max_depth
    U = pw.uniforms_per_photon(D)
    counts = s["em"].counts
    n_batches = sum(-(-int(n) // B) for n in counts if n > 0)

    # 26. the threefry kernel against its plain version ---------------------
    eq26 = {}
    for gb in (0, 1, n_batches - 1):
        key = threefry.fold_in(threefry.prng_key(ph.seed), gb)
        want = threefry.uniform_plain(key, (B, U), dev)
        flat = threefry.batch_uniforms(ph.seed, gb, B, U, dev)
        tr = threefry.batch_uniforms(ph.seed, gb, B, U, dev, transposed=True)
        sync()
        check(torch.equal(flat, want) and torch.equal(tr, want.t()),
              f"threefry batch {gb}: differs from its plain version on "
              f"{int((flat != want).sum().item())} elements")
        eq26[f"batch_{gb}"] = dict(elements=want.numel(), equal_share=1.0)
    rad = cfg.radiosity
    scene = s["scene"]
    C = min(int(rad.texels_per_chunk), num_tiles(scene.walls[0]))
    rkey = threefry.fold_in(threefry.fold_in(threefry.prng_key(rad.seed), 0),
                            0)
    rshape = (C, int(rad.rays_per_texel), 2)
    got = threefry.uniform(rkey, rshape, dev)
    sync()
    check(torch.equal(got, threefry.uniform_plain(rkey, rshape, dev)),
          "threefry: radiosity's first chunk differs from its plain version")
    eq26["radiosity_chunk_0"] = dict(elements=got.numel(), equal_share=1.0)
    key0 = threefry.fold_in(threefry.prng_key(ph.seed), 0)
    ms = kernel_ms(lambda: threefry.uniform(key0, (B, U), dev, True), 50)
    ms_flat = kernel_ms(lambda: threefry.uniform(key0, (B, U), dev), 50)
    plain_ms = cuda_ms(lambda: threefry.uniform_plain(key0, (B, U), dev), 5)
    bnd = threefry_bound(B * U)
    results["threefry_uniform"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bnd[0],
        bound_by=bnd[1], library_ms=plain_ms)
    say("threefry_vs_plain", scene="mini", batch=B, columns=U, **eq26,
        ms_per_batch_transposed=ms, ms_per_batch_flat=ms_flat,
        plain_ms_per_batch=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
        radiosity_chunk_ms=cuda_ms(lambda: threefry.uniform(rkey, rshape,
                                                            dev), 20))

    # 27. rows 6, 7 and 9 against their plain versions; the identities -----
    d27, runs = diff_uniform_runs(s, cfg, dev, power=1.3)
    T27 = s["total_c"]
    bounces, bounds = diff_uniform_bounds(s, cfg, d27["u_t"], D)
    k27 = {}
    for name, (run, plain) in runs.items():
        a, b = run(), run()
        want = plain()
        sync()
        if name == "trace_deposits_wide_diff":
            eqs = [(x == y).float().mean().item() if x.dim() == 1 else
                   (x == y).all(-1).float().mean().item()
                   for x, y in zip(a, want)]
            check(eqs == [1.0, 1.0, 1.0],
                  f"{name}: ids, colors and slots equal on {eqs} of rows")
            check(all(torch.equal(x, y) for x, y in zip(a, b)),
                  f"{name}: two runs differ")
            check(want[1].sum().item() > 0 and bool((want[2] >= 0).any()),
                  f"{name}: plain stream is empty")
            err = (a[1] - want[1]).abs().max().item()
            extra = dict(rows=a[0].numel(), ids_equal=eqs[0],
                         colors_equal=eqs[1], slots_equal=eqs[2])
        elif name == "trace_fold_wide":
            check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
                  f"{name}: two runs differ")
            # f32 sums in another order than index_add_'s: rtol 1e-5
            da_max = want[0].abs().max().item()
            check(da_max > 0, f"{name}: plain fold folded nothing")
            gap = (a[0] - want[0]).abs() - 1e-6 * da_max
            rel_da = (gap / want[0].abs().clamp(min=1e-30)).max().item()
            rel_w = abs(a[1].item() - want[1].item()) / abs(want[1].item())
            check(rel_da <= 1e-5 and rel_w <= 1e-5,
                  f"{name}: da relative error {rel_da}, w_sum {rel_w}")
            err = (a[0] - want[0]).abs().max().item()
            extra = dict(da_max=da_max, da_max_rel_err=rel_da,
                         w_sum_rel_err=rel_w)
        else:
            check(torch.equal(a, b), f"{name}: two runs differ")
            check(want.sum().item() > 0, f"{name}: plain version is empty")
            if name.endswith("_i8"):
                check(torch.equal(a, want), f"{name}: differs from its "
                      f"plain version on {int((a != want).sum().item())} "
                      f"cells")
                err = (a - want).abs().max().item() * d27["scale"].item()
            else:
                check(bool(((a - want).abs() <= 1e-5 * want.abs() + 1e-5)
                           .all()), f"{name}: not within 1e-5 of plain")
                err = (a - want).abs().max().item()
            extra = dict(cells=a.numel(),
                         equal_share=(a == want).float().mean().item())
        bnd = bounds[name]
        k27[name] = dict(
            max_abs_err=err, bit_identical_rerun=True,
            traced_bounces_per_photon=bounces / B, **extra,
            ms=kernel_ms(run, 20), plain_ms=cuda_ms(plain, 3),
            bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)
        results[name] = {k: k27[name][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}
    # the stream tier's forward splat of that row-6 stream, at the scale
    # the renderer gives it at power 1.3 (fit --splat scatter|bucket*)
    idx, col, _ = runs["trace_deposits_wide_diff"][0]()
    fit_bound = stream_total_bound(ph, torch.tensor(1.3, device=dev),
                                   d27["alb"], B)
    check(fit_bound > sp.stream_bound(ph), "power 1.3 left the stream "
          "tier's bound at the production one")
    fit_splat = dict(total_bound=fit_bound,
                     to_fixed=sp.fixed_point_scale(fit_bound)[0])
    for bf16, plain in ((True, sp.fused_splat_plain),
                        (False, sp.scatter_plain)):
        a = sp.fused_splat(idx, col, T27, fit_bound, bf16=bf16)
        b = sp.fused_splat(idx, col, T27, fit_bound, bf16=bf16)
        want = sp.fused_splat_fixed_plain(idx, col, T27, fit_bound, bf16)
        ref = plain(idx, col, T27)
        sync()
        key = "bf16" if bf16 else "f32"
        check(torch.equal(a, b), f"fit stream splat ({key}): two runs differ")
        check(want.sum().item() > 0, f"fit stream splat ({key}): empty")
        check(torch.equal(a, want), f"fit stream splat ({key}): differs "
              f"from fused_splat_fixed_plain")
        check(bool(((want - ref).abs() <= 1e-5 * ref.abs() + 1e-6).all()),
              f"fit stream splat ({key}): fused_splat_fixed_plain not "
              f"within rtol 1e-5 of index_add_")
        err = (a - want).abs().max().item()
        fit_splat[key] = dict(max_abs_err=err, bit_identical_rerun=True,
                              plain_pair_max_abs_err=(want - ref).abs().max()
                              .item())
        results["fused_splat"]["max_abs_err"] = max(
            results["fused_splat"]["max_abs_err"], err)
    # at albedo 0.9 and power 1: rows 7 and 6 are rows 5a, 5b and 4
    d1, runs1 = diff_uniform_runs(s, cfg, dev, power=1.0)
    f, gc, ev, T = (s["aa_c"].fields, s["aa_c"].group_counts, s["ev"],
                    s["total_c"])
    u_t = d1["u_t"]
    same = {
        "trace_splat_wide_diff_i8": (
            "trace_splat_wide_i8",
            pw.trace_splat_wide_i8(f, gc, ev, u_t, B, ph, T)),
        "trace_splat_wide_diff_f32": (
            "trace_splat_wide_f32",
            pw.trace_splat_wide_f32(f, gc, ev, u_t, B, ph, T)),
    }
    for name, (other, want) in same.items():
        got = runs1[name][0]()
        sync()
        check(torch.equal(got, want), f"{name} at albedo 0.9 and power 1 "
              f"differs from {other}")
    idx, col, _ = runs1["trace_deposits_wide_diff"][0]()
    sidx, scol = pw.trace_deposits_wide(f, gc, ev, u_t, B, ph, d1["block"])
    sync()
    check(torch.equal(idx, sidx) and torch.equal(col, scol),
          "trace_deposits_wide_diff at albedo 0.9 and power 1 differs from "
          "trace_deposits_wide at the same block")
    say("diff_threefry_kernels_vs_plain", scene="mini", batch=B, power=1.3,
        block=d27["block"], **k27, fit_stream_splat=fit_splat,
        identities_at_defaults={
            "trace_splat_wide_diff_i8": "trace_splat_wide_i8",
            "trace_splat_wide_diff_f32": "trace_splat_wide_f32",
            "trace_deposits_wide_diff": f"trace_deposits_wide at block "
                                        f"{d1['block']}"})

    # 28. the three fits through the CLI on mini ----------------------------
    steps = 100
    aa_mini = pack_aa(scene.walls, device=dev)
    cli28 = {}
    fits = (
        ("threefry_inkernel_i8", ["--no-device-rng"],
         ("trace_splat_wide_diff_i8", "trace_fold_wide")),
        ("threefry_inkernel", ["--no-device-rng", "--splat", "inkernel"],
         ("trace_splat_wide_diff_f32", "trace_fold_wide")),
        ("scatter", ["--splat", "scatter"],
         ("trace_deposits_wide_diff", "fused_splat")),
    )
    with tempfile.TemporaryDirectory() as tmp:
        target = pathlib.Path(tmp) / "target"
        check(cli.main(["render", str(mini), "30", "--dump-raw", "--out",
                        str(target)]) == 0, "render --dump-raw failed")
        for key, flags, kernels in fits:
            c = _fit_cfg(ph, flags)
            nb = len(make_diff_renderer_wide(s["em"], scene.num_texels, c,
                                             aa_mini).batches)
            out = pathlib.Path(tmp) / key
            reset_launches()
            sync()
            t0 = time.perf_counter()
            rc = cli.main(["fit", str(mini), str(target / "tiles"), "30",
                           *flags, "--fit-init-albedo", "0.6",
                           "--fit-init-power", "0.5", "--out", str(out)])
            sync()
            wall = time.perf_counter() - t0
            launches = read_launches()
            check(rc == 0, f"fit {flags} returned {rc}")
            rep = json.loads((out / "fitted.json").read_text())
            check(rep["final_loss"] < rep["initial_loss"] / 10,
                  f"fit {flags}: loss {rep['initial_loss']} -> "
                  f"{rep['final_loss']}")
            fwd, bwd = kernels
            want = {fwd: (steps + 1) * nb, bwd: steps * nb,
                    "threefry_uniform": (2 * steps + 1) * nb}
            if key == "scatter":       # the stream is traced in both passes
                want = {fwd: (2 * steps + 1) * nb, bwd: (steps + 1) * nb,
                        "threefry_uniform": (2 * steps + 1) * nb}
            ran = {k: v for k, v in launches.items() if v}
            check(ran == want, f"fit {flags}: launches {ran}, want {want}")
            for k in want:     # each kernel's count from its first fit
                results[k].setdefault("launches", launches[k])
            cli28[key] = dict(
                steps=steps, batches_per_pass=nb,
                initial_loss=rep["initial_loss"],
                final_loss=rep["final_loss"],
                loss_ratio=rep["final_loss"] / rep["initial_loss"],
                wall_s=wall, wall_s_per_step=wall / steps, launches=ran)
    # the gradients of the scatter tier and the threefry f32 tier at the
    # same parameters: 5e-4 of the largest (tests/test_diff.py:216-224)
    rs = np.random.RandomState(28)
    albedo = torch.from_numpy(rs.uniform(0.5, 0.9, len(scene.walls))
                              .astype(np.float32)).to(dev)
    power = torch.linspace(0.8, 1.3, len(counts), device=dev)
    w = torch.from_numpy(rs.rand(scene.num_texels, 3).astype(np.float32)
                         ).to(dev)
    grads = {}
    for splat in ("scatter", "inkernel"):
        r = make_diff_renderer_wide(
            s["em"], scene.num_texels,
            dc.replace(ph, splat=splat, device_rng=False), aa_mini)
        a = albedo.clone().requires_grad_()
        p = power.clone().requires_grad_()
        torch.sum(r(a, p) * w).backward()
        grads[splat] = (a.grad, p.grad)
    ga_sc, gp_sc = grads["scatter"]
    ga_fu, gp_fu = grads["inkernel"]
    rel_a = ((ga_fu - ga_sc).abs().max() / ga_sc.abs().max()).item()
    rel_p = ((gp_fu - gp_sc).abs() / gp_sc.abs()).max().item()
    check(rel_a <= 5e-4 and rel_p <= 5e-4,
          f"scatter vs inkernel gradients: albedo {rel_a}, power {rel_p}")
    say("cli_fit_threefry", scene="mini", **cli28,
        gradients_scatter_vs_inkernel=dict(
            albedo_max_rel_of_largest=rel_a, power_max_rel=rel_p,
            bound=5e-4))

    # 29. the 4x4 tiling: the new kernels on batch 0, then one forward plus
    # backward of the threefry 7-bit tier --------------------------------
    scene6 = s6["scene"]
    _, runs6 = diff_uniform_runs(s6, cfg, dev, power=1.3)
    u6 = threefry.batch_uniforms(ph.seed, 0, B, U, dev, transposed=True)
    _, bounds6 = diff_uniform_bounds(s6, cfg, u6, D)
    k29 = {name: dict(ms=cuda_ms(run, 10), plain_ms=cuda_ms(plain, 1),
                      bound_ms=bounds6[name][0], bound_by=bounds6[name][1])
           for name, (run, plain) in runs6.items()}
    r29 = make_diff_renderer_wide(s6["em"], scene6.num_texels,
                                  dc.replace(ph, device_rng=False),
                                  pack_aa(scene6.walls, device=dev))
    reset_launches()
    fwd29, bwd29, wall29 = fwd_bwd_ms(dev, r29, len(scene6.walls),
                                      len(s6["em"].counts), 0.6, 0.5)
    launches = {k: v for k, v in read_launches().items() if v}
    nb6 = len(r29.batches)
    want = {"trace_splat_wide_diff_i8": nb6, "trace_fold_wide": nb6,
            "threefry_uniform": 2 * nb6}
    check(launches == want, f"4x4 threefry fit step: launches {launches}, "
          f"want {want}")
    say("apartment_4x4_threefry_fit_step", rects=len(scene6.walls),
        batches_per_pass=nb6, photons=int(s6["em"].counts.sum()),
        forward_ms=fwd29, backward_ms=bwd29, wall_s=wall29,
        launches=launches, kernels=k29,
        threefry_ms_per_batch=cuda_ms(
            lambda: threefry.batch_uniforms(ph.seed, 0, B, U, dev,
                                            transposed=True), 20))

    # 30. part A: every kernel on a scene past the old shared-memory caps --
    with tempfile.TemporaryDirectory() as tmp:
        png = pathlib.Path(tmp) / "mini_13x13.png"
        make_layout.tiled(str(mini), str(png), 13, 13)
        s13 = batch_setup(png, cfg, dev)
    n13 = s13["aa_c"].fields.shape[1]
    check(n13 == 4563, f"13x13 tiling gave {n13} rects")
    check(4 * (13 + 1) * n13 > 232448, "13x13 table fits in shared memory")
    k30 = part_a_checks(s13, cfg, dev)
    # the production kernel's and the fold's global-table instances at the
    # CLI's batch: ms per batch beside the bound
    d13 = diff_setup(s13, cfg, dev, 1.0)
    bnd13 = trace_bound(s13, traced_bounces(s13, cfg, B), B,
                        "trace_splat_wide_rng_i8")
    k30["global_table_ms_per_batch"] = dict(
        batch=B, trace_splat_wide_rng_i8=cuda_ms(
            lambda: kernel_batch(s13, cfg, B), 5),
        trace_fold_wide_rng=cuda_ms(lambda: fold_batch(s13, d13, cfg, B), 5),
        bound_ms=bnd13[0], bound_by=bnd13[1])
    del d13
    scene13 = s13["scene"]
    aa13 = pack_aa(scene13.walls, device=dev)
    # the nearest-hit kernels on rays from wall 0 and the AO's first texels
    from flatmatch_tpu_torch.config import AoConfig
    from flatmatch_tpu_torch.engines import radiosity

    wall = scene13.walls[0]
    c = torch.from_numpy(ao.tile_centers(wall)[:64]).to(dev)
    nrm = torch.from_numpy(np.asarray(wall.n, np.float32)).to(dev)
    src, direc = radiosity.ff_rays(c, nrm, rkey, 128)
    dist, tex = aa_query.aa_nearest(aa13.fields, aa13.group_counts, src,
                                    direc)
    pdist, ptex = aa_query.aa_nearest_plain(aa13.fields, aa13.group_counts,
                                            src, direc)
    sync()
    check(torch.equal(tex, ptex) and torch.equal(dist, pdist),
          "aa_nearest on 13x13 differs from its plain version")
    nd = aa_query.nearest_distances(aa13.fields, aa13.group_counts, src,
                                    direc, 10.0)
    check(torch.equal(nd, aa_query.nearest_distances_plain(
        aa13.fields, aa13.group_counts, src, direc, 10.0)),
        "nearest_distances on 13x13 differs from its plain version")
    centers, walls_, dirs, fac, _, _ = ao._ao_fused_prep(
        scene13, AoConfig(geosphere_level=3))
    args = [torch.from_numpy(x).to(dev) for x in (centers[:256],
                                                  walls_[:256], dirs, fac)]
    got = ao.ao_fused(aa13.fields, aa13.group_counts, *args, 10.0)
    want = ao.ao_fused_plain(aa13.fields, aa13.group_counts, *args, 10.0)
    sync()
    nz = want != 0
    rel = ((got[nz] - want[nz]).abs() / want[nz].abs()).max().item()
    check(bool(nz.any()) and bool(((got == 0) == (want == 0)).all())
          and rel <= 1e-5, f"ao_fused on 13x13: relative error {rel}")
    k30.update(aa_nearest=dict(rays=src.shape[0], equal_share=1.0,
                               hit_share=(tex >= 0).float().mean().item()),
               nearest_distances=dict(rays=src.shape[0], equal_share=1.0),
               ao_fused=dict(texels=256, max_rel_err=rel))
    # and at the CLI's defaults (phase 12's inputs), on NEAREST_CUT_13
    k30["nearest_at_cli_defaults"] = kernels_vs_plain(
        nearest_inputs(scene13, dev, cfg), 2, 1, *NEAREST_CUT_13)
    say("past_the_old_shared_memory_caps", scene="mini tiled 13x13",
        rects=n13, table_bytes=4 * 13 * n13, compact_texels=s13["total_c"],
        fold_pass_slots=pw.fold_pass_slots(D), **k30)
    del s13, aa13
    return k30["nearest_at_cli_defaults"]


# --------------------------------------------------------------------------
# the general route: row 11, the general engine, the general AO (31-35)
# --------------------------------------------------------------------------
def general_setup(scene, cfg, dev, gb=0):
    """The narrow table, emitter 0's vector and the [U, B] threefry
    uniforms of global batch `gb` of `scene` at cfg."""
    from flatmatch_tpu_torch.engines import photon_narrow as pn
    from flatmatch_tpu_torch.engines import photon_wide as pw
    from flatmatch_tpu_torch.ops import threefry
    from flatmatch_tpu_torch.ops.device_scene import pack_emitters, pack_rects

    ph = cfg.photon
    rects = pack_rects(scene.walls, device=dev)
    em = pack_emitters(scene, ph.samples_per_area, ph.window_color,
                       ph.light_color, device=dev)
    U = pw.uniforms_per_photon(ph.max_depth)
    return dict(scene=scene, rects=rects, em=em,
                table=pn.narrow_table(rects), ev=pw.emitter_vector(em, 0),
                u_t=threefry.batch_uniforms(ph.seed, gb, ph.photons_per_batch,
                                            U, dev, transposed=True))


def narrow_bound(n_rects, bounces, photons, depth=8):
    """Bound of one row 11 launch: `bounces` traced bounces over all
    n_rects rects (GENERAL_RECT_TEST_INSTRUCTIONS each, OPS_PER_BOUNCE more
    per bounce, OPS_PER_PHOTON per photon, at LANE_INSTR_PER_S); bytes: the
    [18, N] table and the emitter vector, the [U, B] uniforms read, idx and
    col (16 bytes per photon and bounce) written."""
    ops = (bounces * (n_rects * GENERAL_RECT_TEST_INSTRUCTIONS
                      + OPS_PER_BOUNCE) + photons * OPS_PER_PHOTON)
    nbytes = (4 * (18 * n_rects + 16) + 4 * (4 + 3 * depth) * photons
              + 16 * depth * photons)
    return bound(nbytes, ops, LANE_INSTR_PER_S)


def narrow_vs_plain(g, cfg, n_valid, reps=20, plain_reps=2):
    """Row 11 on one batch of `g` against its plain version: ids equal on
    >= 99.9% of rows, colors within rtol 1e-5, two runs bit-identical;
    its time, the plain time and the bound."""
    import numpy as np

    from flatmatch_tpu_torch.engines import photon_narrow as pn

    ph = cfg.photon
    args = (g["table"], g["ev"], g["u_t"], n_valid, ph)
    idx, col = pn.trace_deposits_narrow(*args)
    idx2, col2 = pn.trace_deposits_narrow(*args)
    pidx, pcol = pn.trace_deposits_narrow_plain(
        g["table"], g["ev"], g["u_t"].t(), n_valid, ph)
    sync()
    check(bool((idx == idx2).all() and (col == col2).all()),
          "trace_deposits_narrow: two runs differ")
    rows_eq = (idx == pidx).all(1).float().mean().item()
    check(rows_eq >= 0.999, f"trace_deposits_narrow: ids equal on only "
          f"{rows_eq} of rows")
    c, pc = col.cpu().numpy(), pcol.cpu().numpy()
    check(pc.sum() > 0, "plain narrow trace deposited nothing")
    check(bool((c[n_valid:] == 0).all()), "dead photons deposited")
    close = np.abs(c - pc) <= 1e-5 * np.abs(pc) + 1e-7
    check(bool(close.all()), f"trace_deposits_narrow: colors off by "
          f"{np.abs(c - pc).max()}")
    B, D = idx.shape
    live = pcol.reshape(B, D, 3).sum(-1) > 0
    bounces = int(live.sum().item()) + B - int(live[:, -1].sum().item())
    n = g["table"].shape[1]
    bnd = narrow_bound(n, bounces, B, D)
    return dict(
        rects=n, batch=B, n_valid=n_valid, rows_equal=rows_eq,
        max_abs_err=float(np.abs(c - pc).max()), bit_identical_rerun=True,
        traced_bounces_per_photon=bounces / B,
        ms=kernel_ms(lambda: pn.trace_deposits_narrow(*args), reps),
        plain_ms=cuda_ms(lambda: pn.trace_deposits_narrow_plain(
            g["table"], g["ev"], g["u_t"].t(), n_valid, ph), plain_reps),
        bound_ms=bnd[0], bound_by=bnd[1])


def rotated_ao_bands(scene, tex):
    """AO of mini turned 30 degrees against the unrotated reference dump.
    The walls' geosphere frames turn with them, so the vertical walls keep
    the bands of tests/test_ao_parity.py but for its bulk share (0.95; the
    CPU measured 0.976) and a mean of 1e-3 (1.4e-4);
    the floor's and the ceiling's frames stay fixed to the world's y axis,
    so their 481 directions sample the hemisphere at other azimuths: a
    mean relative difference below 0.06 there (0.031 measured on the CPU),
    the level-0 total within 5e-3 and the texel correlation above 0.995."""
    import numpy as np

    from flatmatch_tpu_torch.scene.rectangle import num_tiles

    gold = np.fromfile(FIXTURES / "mini_ao_texels.f32", dtype="<f4"
                       ).reshape(scene.num_texels, 4)[:, :3]
    l0 = scene.level0_mask()
    vert = np.zeros(scene.num_texels, bool)
    for w in scene.walls:
        if abs(float(w.n[2])) < 0.5:
            vert[w.base:w.base + num_tiles(w)] = True
    out = {}
    for name, m in (("vertical", vert & l0), ("horizontal", ~vert & l0)):
        rel = np.abs(tex[m] - gold[m]) / np.maximum(np.abs(gold[m]), 1e-6)
        out[name] = dict(texels=int(m.sum()), max_rel=float(rel.max()),
                         mean_rel=float(rel.mean()),
                         share_within_5e4=float((rel < 5e-4).mean()))
    v, h = out["vertical"], out["horizontal"]
    check(v["max_rel"] < 2e-2 and v["share_within_5e4"] > 0.95
          and v["mean_rel"] < 1e-3, f"rotated AO, vertical walls: {v}")
    check(h["mean_rel"] < 0.06, f"rotated AO, floor and ceiling: {h}")
    ratio = float(tex[l0].sum() / gold[l0].sum())
    corr = float(np.corrcoef(tex[l0, 0], gold[l0, 0])[0, 1])
    check(abs(ratio - 1) < 5e-3 and corr > 0.995,
          f"rotated AO: total ratio {ratio}, correlation {corr}")
    check(bool((tex[~l0] == 0).all()), "AO wrote a mipmap slot")
    return dict(out, total_ratio=ratio, texel_corr=corr)


def general_phases(dev, results, make_layout):
    import dataclasses as dc

    import numpy as np
    import torch

    from flatmatch_tpu_torch.config import DEFAULT_CONFIG, Engine
    from flatmatch_tpu_torch.engines import ao_general, photon
    from flatmatch_tpu_torch.engines import photon_narrow as pn
    from flatmatch_tpu_torch.engines.schedule import emitter_slice
    from flatmatch_tpu_torch.io import tiles as tiles_io
    from flatmatch_tpu_torch.ops import threefry
    from flatmatch_tpu_torch.ops.aa_scene import pack_aa
    from flatmatch_tpu_torch.ops.device_scene import pack_rects
    from flatmatch_tpu_torch.render import compile_scene, run_engine
    from flatmatch_tpu_torch.scene.rectangle import num_tiles

    mini = FIXTURES / "mini.png"
    cfg = DEFAULT_CONFIG
    ph = cfg.photon
    B, D = ph.photons_per_batch, ph.max_depth
    scene, _ = compile_scene(str(mini), 30.0, cfg)
    rscene = rotated_scene(scene, 30)
    check(pack_aa(rscene.walls) is None, "rotated mini has a table")

    # 31. row 11 against its plain version on mini and rotated mini --------
    k31 = {"mini": narrow_vs_plain(general_setup(scene, cfg, dev), cfg, B),
           "rotated_mini": narrow_vs_plain(general_setup(rscene, cfg, dev),
                                           cfg, B - 4097)}
    r = k31["rotated_mini"]
    results["trace_deposits_narrow"] = dict(
        max_abs_err=max(k["max_abs_err"] for k in k31.values()), ms=r["ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=None)
    say("narrow_kernel_vs_plain", **k31)

    # 32. physics of both general engines against the reference C engine --
    cfg5 = cfg.replace(photon=dc.replace(ph, samples_per_area=200000.0))
    k32 = {}
    for name, sc in (("mini", scene), ("rotated_mini", rscene)):
        g5 = general_setup(sc, cfg5, dev)
        before = pn.trace_deposits_narrow.launches
        narrow = pn.render_photons(g5["rects"], g5["em"], sc.num_texels,
                                   cfg5.photon)
        check(pn.trace_deposits_narrow.launches > before,
              "the narrow route launched no row 11")
        xla = photon.render_photons(g5["rects"], g5["em"], sc.num_texels,
                                    cfg5.photon)
        k32[name] = dict(
            photons=int(g5["em"].counts.sum()),
            photon_pallas_narrow=physics_bands(
                sc, narrow.cpu().numpy(), f"{name} narrow"),
            photon_xla=physics_bands(sc, xla.cpu().numpy(),
                                     f"{name} photon_xla"))
    say("general_physics_vs_reference", samples_per_area=200000.0, **k32)

    # 33. both general engines at the CLI defaults ---------------------------
    counts = general_setup(scene, cfg, dev)["em"].counts
    n_batches = sum(-(-int(n) // B) for n in counts if n > 0)
    photons = int(counts.sum())
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        sync()
        t0 = time.perf_counter()
        tex = run_engine(rscene, cfg, dev)
        paths = tiles_io.save_tiles(rscene.walls, tex, str(
            pathlib.Path(tmp) / "tiles"), False)
        sync()
        wall33 = time.perf_counter() - t0
        launches33 = read_launches()
    check(len(paths) == 27 and np.isfinite(tex).all() and tex.sum() > 0,
          "rotated mini render")
    want = {"trace_deposits_narrow": n_batches,
            "threefry_uniform": n_batches, "fused_splat": n_batches}
    check({k: v for k, v in launches33.items() if v} == want,
          f"rotated mini launches {launches33}, want {want}")
    results["trace_deposits_narrow"]["launches"] = n_batches
    prof33 = profiled(lambda: run_engine(rscene, cfg, dev))
    with tempfile.TemporaryDirectory() as tmp:
        wall_x, launches_x, _ = cli_render(
            [str(mini), "30", "--engine", "photon_xla"], tmp, 27)
    want_x = {"threefry_uniform": n_batches, "fused_splat": n_batches,
              "general_nearest": n_batches * D}
    check({k: v for k, v in launches_x.items() if v} == want_x,
          f"photon_xla launches {launches_x}, want {want_x}")
    say("general_cli", photons=photons, batches=n_batches,
        rotated_mini_photon_pallas=dict(
            wall_s=wall33, photons_per_s=photons / wall33,
            launches=launches33["trace_deposits_narrow"], profile=prof33),
        mini_photon_xla=dict(wall_s=wall_x, photons_per_s=photons / wall_x,
                             launches=launches_x))

    # 34. rotated 4x4 at the full budget; 8 batches of photon_xla on 4x4 ---
    with tempfile.TemporaryDirectory() as tmp:
        png = pathlib.Path(tmp) / "mini_4x4.png"
        make_layout.tiled(str(mini), str(png), 4, 4)
        scene6, _ = compile_scene(str(png), 30.0, cfg)
    rscene6 = rotated_scene(scene6, 30)
    g6 = general_setup(rscene6, cfg, dev)
    photons6 = int(g6["em"].counts.sum())
    batches6 = sum(-(-int(n) // B) for n in g6["em"].counts if n > 0)
    k34 = narrow_vs_plain(g6, cfg, B, reps=5, plain_reps=1)
    reset_launches()
    sync()
    t0 = time.perf_counter()
    tex6 = run_engine(rscene6, cfg, dev)
    wall34 = time.perf_counter() - t0
    launches34 = read_launches()["trace_deposits_narrow"]
    check(launches34 == batches6, f"rotated 4x4: {launches34} launches, "
          f"want {batches6}")
    check(np.isfinite(tex6).all() and tex6.sum() > 0, "rotated 4x4 render")
    em0 = emitter_slice(g6["em"], 0)
    U = 4 + 3 * D
    lm = torch.zeros((rscene6.num_texels, 3), device=dev)
    sync()
    t0 = time.perf_counter()
    for gb in range(8):
        photon.trace_batch(lm, g6["rects"], em0, threefry.batch_uniforms(
            ph.seed, gb, B, U, dev), B, ph)
    sync()
    xla8 = time.perf_counter() - t0
    check(lm.sum().item() > 0, "photon_xla on 4x4 deposited nothing")
    say("rotated_4x4", rects=len(rscene6.walls), photons=photons6,
        batches=batches6, narrow=dict(wall_s=wall34,
                                      photons_per_s=photons6 / wall34,
                                      launches=launches34, kernel=k34),
        photon_xla_8_batches=dict(wall_s=xla8, s_per_batch=xla8 / 8,
                                  whole_render_s_extrapolated=xla8 / 8
                                  * batches6))
    del tex6, lm

    # 35. rotated 13x13 past shared memory; the general AO of mini ----------
    with tempfile.TemporaryDirectory() as tmp:
        png = pathlib.Path(tmp) / "mini_13x13.png"
        make_layout.tiled(str(mini), str(png), 13, 13)
        scene13, _ = compile_scene(str(png), 30.0, cfg)
    g13 = general_setup(rotated_scene(scene13, 30), cfg, dev)
    n13 = g13["table"].shape[1]
    check(n13 == 4563 and 4 * 18 * n13 > 232448,
          f"rotated 13x13: {n13} rects fit in shared memory")
    k35 = narrow_vs_plain(g13, cfg, B, reps=3, plain_reps=1)
    cfg_ao = cfg.replace(engine=Engine.AMBIENT_OCCLUSION)
    ao_out = {}
    for name, sc in (("mini", scene), ("rotated_mini", rscene)):
        rects = pack_rects(sc.walls, device=dev)
        sync()
        t0 = time.perf_counter()
        tex = ao_general.render_ao(sc, rects, cfg_ao.ao)
        wall = time.perf_counter() - t0
        check(np.array_equal(tex, ao_general.render_ao(sc, rects, cfg_ao.ao)),
              f"two general AO runs of {name} differ")
        bands = (ao_bands(sc, tex, mean=1e-4) if name == "mini"
                 else rotated_ao_bands(sc, tex))
        ao_out[name] = dict(wall_s=wall, bit_identical=True, **bands)
    # run_engine takes the general AO when there is no table
    check(np.array_equal(run_engine(rscene, cfg_ao, dev),
                         ao_general.render_ao(rscene, pack_rects(
                             rscene.walls, device=dev), cfg_ao.ao)),
          "run_engine's AO of rotated mini is not the general AO")
    say("general_past_shared_memory_and_ao", rotated_13x13=dict(
        table_bytes=4 * 18 * n13, **k35), general_ao=ao_out,
        level0_texels=int(sum(num_tiles(w) for w in scene.walls)))
    return {"rotated_mini": general_setup(rscene, cfg, dev),
            "rotated_4x4": g6, "rotated_13x13": g13}


def _fit_cfg(ph, flags):
    """The photon config the fit CLI builds from `flags`."""
    import dataclasses as dc

    device_rng = "--no-device-rng" not in flags
    splat = flags[flags.index("--splat") + 1] if "--splat" in flags \
        else "inkernel_i8"
    return dc.replace(ph, device_rng=device_rng, splat=splat)


def trace_instances(s, cfg, dev, batch, plain=True):
    """Every instance of the shared trace (rows 1-10) on one batch of `s`,
    the diff ones at power 1.3: (name -> (kernel call, its plain
    version's output on the card, None without `plain`), the traced
    bounces of the batch with the counter hash and with the threefry
    uniforms: the plain traces', or without `plain` the stream kernels')."""
    import dataclasses as dc

    import numpy as np
    import torch

    from flatmatch_tpu_torch.diff.render import diff_block, fixed_pair
    from flatmatch_tpu_torch.engines import photon_wide as pw
    from flatmatch_tpu_torch.ops import threefry

    ph = dc.replace(cfg.photon, photons_per_batch=batch)
    B, D = batch, ph.max_depth
    f, gc, ev, T = (s["aa_c"].fields, s["aa_c"].group_counts, s["ev"],
                    s["total_c"])
    n = f.shape[1]
    seed = s["seed"]
    d = diff_setup(s, cfg, dev, 1.3)
    alb, dev_ev, inv, g = d["alb"], d["ev"], d["inv"], d["g"]
    u = threefry.batch_uniforms(ph.seed, 0, B, pw.uniforms_per_photon(D),
                                dev, transposed=True)
    fixed = fixed_pair(ph, torch.tensor([1.3], device=dev), alb, B)
    block, dblock = pw.stream_block(B), diff_block(B)
    calls = {
        "trace_splat_wide_rng_i8": lambda: pw.trace_splat_wide_rng_i8(
            f, gc, ev, seed, B, B, ph, T),
        "trace_splat_wide_rng_f32": lambda: pw.trace_splat_wide_rng_f32(
            f, gc, ev, seed, B, B, ph, T),
        "trace_splat_wide_i8": lambda: pw.trace_splat_wide_i8(
            f, gc, ev, u, B, ph, T),
        "trace_splat_wide_f32": lambda: pw.trace_splat_wide_f32(
            f, gc, ev, u, B, ph, T),
        "trace_deposits_wide_rng": lambda: pw.trace_deposits_wide_rng(
            f, gc, ev, seed, B, B, ph, block),
        "trace_deposits_wide": lambda: pw.trace_deposits_wide(
            f, gc, ev, u, B, ph, block),
        "trace_deposits_wide_diff": lambda: pw.trace_deposits_wide_diff(
            f, gc, alb, dev_ev, u, B, ph, dblock),
        "trace_splat_wide_diff_rng_i8":
            lambda: pw.trace_splat_wide_diff_rng_i8(
                f, gc, alb, dev_ev, seed, B, B, ph, T, inv),
        "trace_splat_wide_diff_rng_f32":
            lambda: pw.trace_splat_wide_diff_rng_f32(
                f, gc, alb, dev_ev, seed, B, B, ph, T, fixed),
        "trace_splat_wide_diff_i8": lambda: pw.trace_splat_wide_diff_i8(
            f, gc, alb, dev_ev, u, B, ph, T, inv),
        "trace_splat_wide_diff_f32": lambda: pw.trace_splat_wide_diff_f32(
            f, gc, alb, dev_ev, u, B, ph, T, fixed),
        "trace_fold_wide_rng": lambda: pw.trace_fold_wide_rng(
            f, gc, alb, dev_ev, g, seed, B, B, ph, n),
        "trace_fold_wide": lambda: pw.trace_fold_wide(
            f, gc, alb, dev_ev, g, u, B, ph, n),
    }
    if not plain:
        return ({name: (call, None) for name, call in calls.items()},
                stream_bounces(calls["trace_deposits_wide_rng"]()[1], B, D,
                               block),
                stream_bounces(calls["trace_deposits_wide"]()[1], B, D,
                               block))
    inv_s = float(np.float32(1.0 / pw.splat_color_scale(ph)))
    hp = pw.trace_deposits_rng_plain(f, gc, ev, seed, B, B, ph)
    up = pw.trace_uniforms_plain(f, gc, ev, u.t(), B, ph)
    hd = pw.trace_deposits_rng_plain(f, gc, dev_ev, seed, B, B, ph, alb)
    ud = pw.trace_uniforms_plain(f, gc, dev_ev, u.t(), B, ph, alb)
    wants = {
        "trace_splat_wide_rng_i8": pw.splat_i8_plain(hp[0], hp[1], T, inv_s),
        "trace_splat_wide_rng_f32": pw.splat_f32_plain(hp[0], hp[1], T),
        "trace_splat_wide_i8": pw.splat_i8_plain(up[0], up[1], T, inv_s),
        "trace_splat_wide_f32": pw.splat_f32_plain(up[0], up[1], T),
        "trace_deposits_wide_rng": pw.stream_rows(hp[0], hp[1], block),
        "trace_deposits_wide": pw.stream_rows(up[0], up[1], block),
        "trace_deposits_wide_diff": pw.stream_rows(ud[0], ud[1], dblock,
                                                   ud[2]),
        "trace_splat_wide_diff_rng_i8": pw.splat_i8_plain(hd[0], hd[1], T,
                                                          inv.item()),
        "trace_splat_wide_diff_rng_f32": pw.splat_f32_plain(hd[0], hd[1], T),
        "trace_splat_wide_diff_i8": pw.splat_i8_plain(ud[0], ud[1], T,
                                                      inv.item()),
        "trace_splat_wide_diff_f32": pw.splat_f32_plain(ud[0], ud[1], T),
        "trace_fold_wide_rng": pw.fold_plain(*hd, g, n),
        "trace_fold_wide": pw.fold_plain(*ud, g, n),
    }

    def bounces(col):
        live = col.sum(-1) > 0
        return int(live.sum().item()) + B - int(live[:, -1].sum().item())

    return ({name: (call, wants[name]) for name, call in calls.items()},
            bounces(hp[1]), bounces(up[1]))


def instance_error(name, got, want, n):
    """Hold one trace instance's output to its plain version's: the 7-bit
    sums and the streams equal, the f32 sums within 1e-5, the folds
    within rtol 1e-4 (another f32 order); returns the largest error."""
    import torch

    if name.startswith("trace_deposits"):
        ok = all(torch.equal(x, y) for x, y in zip(got, want))
        nonzero = want[1].sum().item() > 0
        err = (got[1] - want[1]).abs().max().item()
    elif name.startswith("trace_fold"):
        top = want[0].abs().max().item()
        ok = bool(((got[0] - want[0]).abs()
                   <= 1e-4 * want[0].abs() + 1e-6 * top).all()) and \
            abs(got[1].item() - want[1].item()) <= 1e-4 * abs(
                want[1].item())
        nonzero = top > 0
        err = (got[0] - want[0]).abs().max().item()
    elif got.dtype == torch.int32:
        ok, nonzero = torch.equal(got, want), want.sum().item() > 0
        err = (got - want).abs().max().item()
    else:
        ok = bool(((got - want).abs() <= 1e-5 * want.abs() + 1e-5).all())
        nonzero = want.sum().item() > 0
        err = (got - want).abs().max().item()
    check(ok and nonzero, f"{name} on {n} rects differs from its plain "
          f"version (or is empty)")
    return err


def part_a_checks(s, cfg, dev, batch=8192):
    """Every trace instance and both folds on one batch of `s` (a table
    past shared memory: the global-table instances) against their plain
    versions (instance_error's bands)."""
    runs, _, _ = trace_instances(s, cfg, dev, batch)
    got = {name: run() for name, (run, _) in runs.items()}
    sync()
    n = s["aa_c"].fields.shape[1]
    return {name: dict(photons=batch, equal=True, max_abs_err=instance_error(
        name, got[name], want, n)) for name, (_, want) in runs.items()}


# --------------------------------------------------------------------------
# the redesigned trace (36)
# --------------------------------------------------------------------------
# each instance's kernel template in the ptxas log, before its kSmem flag
PTXAS_NAMES = {
    "trace_splat_wide_rng_i8": "trace_splat_kernelI",
    "trace_splat_wide_rng_f32": "trace_splat_wide_kernelINS_8HashDrawELb1E",
    "trace_splat_wide_i8": "trace_splat_wide_kernelINS_11UniformDrawELb0E",
    "trace_splat_wide_f32": "trace_splat_wide_kernelINS_11UniformDrawELb1E",
    "trace_deposits_wide_rng": "trace_deposits_kernelILb0ELb0E",
    "trace_deposits_wide": "trace_deposits_kernelILb1ELb0E",
    "trace_deposits_wide_diff": "trace_deposits_kernelILb1ELb1E",
    "trace_splat_wide_diff_rng_i8":
        "trace_splat_diff_kernelINS_8HashDrawELb0E",
    "trace_splat_wide_diff_rng_f32":
        "trace_splat_diff_kernelINS_8HashDrawELb1E",
    "trace_splat_wide_diff_i8":
        "trace_splat_diff_kernelINS_11UniformDrawELb0E",
    "trace_splat_wide_diff_f32":
        "trace_splat_diff_kernelINS_11UniformDrawELb1E",
    "trace_fold_wide_rng": "trace_fold_kernelINS_8HashDrawE",
    "trace_fold_wide": "trace_fold_kernelINS_11UniformDrawE",
}
# an H100 SM: 65,536 registers, given out in 8 a thread; 228 KB of shared
# memory, 1 KB of it reserved per block; 2,048 threads
SM_REGISTERS, SM_SMEM, SM_THREADS = 65536, 233472, 2048
# the staged scene's block constants (kConstFloats, csrc/trace_wide.cuh)
CONST_FLOATS = 64


def ptxas_registers(log):
    """{kernel symbol: registers} from the build's -Xptxas -v output."""
    import re

    regs, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            regs[cur] = int(m.group(1))
            cur = None
    return regs


def instance_occupancy(name, n_rects, depth, regs):
    """(instance, registers, shared bytes, blocks per SM) of one trace
    instance on a table of n_rects: the shared-memory instance when the
    staged scene fits beside its buffers (launch_table), else the
    device-memory one; blocks per SM from the registers and the shared
    bytes by the SM's allocation rules."""
    diff = name.startswith(("trace_deposits_wide_diff",
                            "trace_splat_wide_diff", "trace_fold"))
    table = 4 * (CONST_FLOATS + 13 * n_rects + (n_rects if diff else 0))
    buffers = 4 * (8 * n_rects + 2 * depth * 256) if name.startswith(
        "trace_fold") else 0
    smem_instance = table + buffers <= 232448
    smem = buffers + (table if smem_instance else 0)
    flag = "Lb1EE" if smem_instance else "Lb0EE"
    found = [r for sym, r in regs.items() if PTXAS_NAMES[name] + flag in sym]
    check(len(found) == 1, f"{name}: {len(found)} kernels in the ptxas log")
    r = found[0]
    blocks = min(SM_REGISTERS // (-(-r // 8) * 8 * 256),
                 SM_SMEM // (smem + 1024), SM_THREADS // 256)
    return ("shared" if smem_instance else "device"), r, smem, blocks


def redesigned_trace_phase(dev, cfg, s, s6, make_layout):
    """36. every instance of the redesigned trace (csrc/trace_wide.cuh):
    on mini and the 4x4 tiling at the CLI's batch, and on mini tiled 13x13
    (the device-memory instances), each against its plain version
    (instance_error's bands, on a batch of 8192 photons on 13x13) and run
    twice bit for bit; ms per batch beside its bound and the share of it,
    registers and blocks per SM."""
    import torch

    from flatmatch_tpu_torch.utils import cuda_build

    regs = ptxas_registers(cuda_build.build_info["log"])
    B, D = cfg.photon.photons_per_batch, cfg.photon.max_depth
    with tempfile.TemporaryDirectory() as tmp:
        png = pathlib.Path(tmp) / "mini_13x13.png"
        make_layout.tiled(str(FIXTURES / "mini.png"), str(png), 13, 13)
        s13 = batch_setup(png, cfg, dev)
    k36 = {}
    for scene, st, reps in (("mini", s, 20), ("4x4", s6, 10),
                            ("13x13", s13, 2)):
        n = st["aa_c"].fields.shape[1]
        checked, bh, bu = trace_instances(st, cfg, dev,
                                          8192 if scene == "13x13" else B)
        k = {}
        for name, (run, want) in checked.items():
            a, b = run(), run()
            sync()
            same = all(torch.equal(x, y) for x, y in zip(a, b)) if \
                isinstance(a, tuple) else torch.equal(a, b)
            check(same, f"{scene} {name}: two runs differ")
            k[name] = dict(max_abs_err=instance_error(name, a, want, n),
                           bit_identical_rerun=True)
        if scene == "13x13":           # timed at the CLI's batch
            checked, bh, bu = trace_instances(st, cfg, dev, B, plain=False)
        for name, (run, _) in checked.items():
            ms = cuda_ms(run, reps)
            bnd = trace_bound(st, bu if name in UNIFORM_KERNELS else bh, B,
                              name, D)
            inst, r, smem, blocks = instance_occupancy(name, n, D, regs)
            k[name].update(ms=ms, bound_ms=bnd[0], bound_by=bnd[1],
                           share_of_bound=bnd[0] / ms, instance=inst,
                           registers=r, shared_bytes=smem,
                           blocks_per_sm=blocks)
        del checked
        k36[scene] = dict(rects=n, batch=B, checked_batch=(
            8192 if scene == "13x13" else B), kernels=k)
    say("redesigned_trace", **k36)
    return s13


# --------------------------------------------------------------------------
# the redesigned stream splat and the threefry draws (37)
# --------------------------------------------------------------------------
def splat_occupancy(T, regs, bf16, i8=False):
    """(accumulator instance, registers, shared bytes, blocks per SM) of
    row 16's kernel (with i8, row 15's) on an arena of T texels: the
    instance and its shared bytes as csrc/splat_stream.cu chooses them
    (ops/splat.splat_accumulator asks it), 1024 threads a block. The
    kernel template's symbol names its slot type and instance."""
    from flatmatch_tpu_torch.ops import splat as sp

    inst, smem = sp.splat_accumulator(T, i8=i8)
    slot = "I8SlotE" if i8 else f"FixedSlotILb{int(bf16)}EEE"
    sym = f"{slot}Li{int(inst == 'paged')}E"
    found = [r for name, r in regs.items()
             if "fused_splat_kernel" in name and sym in name]
    check(len(found) == 1, f"{sym}: {len(found)} kernels in the ptxas log "
          f"{sorted(n for n in regs if 'fused_splat_kernel' in n)}")
    r = found[0]
    blocks = min(SM_REGISTERS // (-(-r // 8) * 8 * 1024),
                 SM_SMEM // (smem + 1024), SM_THREADS // 1024)
    return inst, r, smem, blocks


def redesigned_splat_phase(dev, results, cfg, scenes):
    """37. the redesigned stream splat (row 16, csrc/splat_stream.cu) and
    the threefry kernel, on batch 0's 1M-row stream of each scene (mini:
    the arena accumulator; the 4x4 tiling and mini tiled 13x13: the paged
    one): fused_splat with bf16 and with f32 colors, and fused_splat_add
    into a lightmap, each against fused_splat_fixed_plain bit for bit, the
    device's scratch zero after every call; the threefry draws (the
    scene's last photon batch flat and transposed to [U, B], radiosity's
    first chunk of its first wall) against uniform_plain bit for bit; each
    with its device ms and host µs per call (device_ms), the share of its
    bound, its registers, shared bytes and blocks per SM, and the
    accumulator instance that ran."""
    import numpy as np
    import torch

    from flatmatch_tpu_torch.engines import photon_wide as pw
    from flatmatch_tpu_torch.ops import splat as sp, threefry
    from flatmatch_tpu_torch.scene.rectangle import num_tiles
    from flatmatch_tpu_torch.utils import cuda_build

    regs = ptxas_registers(cuda_build.build_info["log"])
    ph = dataclasses.replace(cfg.photon, splat="fused")
    B, D = ph.photons_per_batch, ph.max_depth
    U = pw.uniforms_per_photon(D)
    rad = cfg.radiosity
    total = sp.stream_bound(ph)
    k37 = {}
    for scene, st in scenes.items():
        f, gc = st["aa_c"].fields, st["aa_c"].group_counts
        T = st["total_c"]
        idx, col = pw.trace_deposits_wide_rng(f, gc, st["ev"], st["seed"],
                                              B, B, ph, pw.stream_block(B))
        R = idx.shape[0]
        lm0 = torch.from_numpy(np.random.RandomState(37).rand(T, 3).astype(
            np.float32)).to(dev)
        lm = lm0.clone()
        calls = {
            "fused_splat": (
                lambda: sp.fused_splat(idx, col, T, total),
                lambda: sp.fused_splat_fixed_plain(idx, col, T, total), True),
            "fused_splat_f32": (
                lambda: sp.scatter_splat(idx, col, T, total),
                lambda: sp.fused_splat_fixed_plain(idx, col, T, total, False),
                False),
            "fused_splat_add": (
                lambda: sp.fused_splat_add(lm, idx, col, total),
                lambda: lm0 + sp.fused_splat_fixed_plain(idx, col, T, total),
                True),
        }
        k = {}
        for name, (run, exact, bf16) in calls.items():
            got = run().clone()
            want = exact()
            sync()
            check(want.sum().item() > 0, f"{scene} {name}: plain is empty")
            check(torch.equal(got, want), f"{scene} {name}: differs from "
                  f"fused_splat_fixed_plain")
            scratch = sp._fixed_scratch[sp._scratch_key(dev)]
            check(not bool(scratch.any()),
                  f"{scene} {name}: the scratch was not left zeroed")
            ms, host_us = device_ms(run, 50)
            bnd = splat_bound(R, T, "fused_splat")
            inst, r, smem, blocks = splat_occupancy(T, regs, bf16)
            k[name] = dict(equal_to_fixed_plain=True, ms=ms,
                           host_us=host_us, bound_ms=bnd[0],
                           bound_by=bnd[1], share_of_bound=bnd[0] / ms,
                           accumulator=inst, registers=r, shared_bytes=smem,
                           blocks_per_sm=blocks)
        last = sum(-(-int(n) // B) for n in st["em"].counts if n > 0) - 1
        key = threefry.fold_in(threefry.prng_key(ph.seed), last)
        chunk = min(int(rad.texels_per_chunk),
                    num_tiles(st["scene"].walls[0]))
        rkey = threefry.fold_in(threefry.fold_in(
            threefry.prng_key(rad.seed), 0), 0)
        rshape = (chunk, int(rad.rays_per_texel), 2)
        draws = {
            "threefry_flat": (lambda: threefry.uniform(key, (B, U), dev),
                              lambda: threefry.uniform_plain(key, (B, U),
                                                             dev),
                              "uniform_kernel"),
            "threefry_t": (lambda: threefry.uniform(key, (B, U), dev, True),
                           lambda: threefry.uniform_plain(key, (B, U),
                                                          dev).t(),
                           "uniform_t_kernel"),
            "threefry_radiosity": (
                lambda: threefry.uniform(rkey, rshape, dev),
                lambda: threefry.uniform_plain(rkey, rshape, dev),
                "uniform_kernel"),
        }
        for name, (run, exact, sym) in draws.items():
            got = run()
            want = exact()
            sync()
            check(torch.equal(got, want), f"{scene} {name}: differs from "
                  f"uniform_plain")
            ms, host_us = device_ms(run, 50)
            bnd = threefry_bound(got.numel())
            found = [r for n_, r in regs.items()
                     if f"{len(sym)}{sym}E" in n_]
            check(len(found) == 1, f"{sym}: {len(found)} kernels in the "
                  f"ptxas log")
            r = found[0]
            k[name] = dict(equal_to_plain=True, elements=got.numel(), ms=ms,
                           host_us=host_us, bound_ms=bnd[0],
                           bound_by=bnd[1], share_of_bound=bnd[0] / ms,
                           registers=r, shared_bytes=0, blocks_per_sm=min(
                               SM_REGISTERS // (-(-r // 8) * 8 * 256),
                               SM_THREADS // 256))
        k37[scene] = dict(rows=R, texels=T, kernels=k)
    mini = k37["mini"]["kernels"]
    results["fused_splat"].update(ms=mini["fused_splat"]["ms"])
    results["threefry_uniform"].update(ms=mini["threefry_t"]["ms"])
    say("redesigned_splat", **k37)


# --------------------------------------------------------------------------
# the redesigned narrow kernel (row 11) and 7-bit stream splat (row 15) (38)
# --------------------------------------------------------------------------
NARROW_THREADS = 256
NARROW_SYMBOLS = {"staged": "trace_deposits_narrow_kernelILb1ELb1E",
                  "table": "trace_deposits_narrow_kernelILb1ELb0E",
                  "device": "trace_deposits_narrow_kernelILb0ELb0E"}


def narrow_occupancy(n_rects, depth, regs, dev):
    """(instance, registers, shared bytes, blocks per SM) of row 11 on a
    table of n_rects: the instance and its shared bytes as
    csrc/trace_deposits_narrow.cu chooses them (photon_narrow.
    narrow_instance asks it), the registers from the ptxas log."""
    from flatmatch_tpu_torch.engines import photon_narrow as pn

    inst, smem = pn.narrow_instance(n_rects, depth, dev)
    found = [r for name, r in regs.items() if NARROW_SYMBOLS[inst] in name]
    check(len(found) == 1, f"{inst}: {len(found)} kernels in the ptxas log")
    r = found[0]
    blocks = min(SM_REGISTERS // (-(-r // 8) * 8 * NARROW_THREADS),
                 SM_SMEM // (smem + 1024), SM_THREADS // NARROW_THREADS)
    return inst, r, smem, blocks


def redesigned_narrow_splat_phase(dev, results, cfg, gens, scenes):
    """38. the redesigned narrow kernel (row 11, csrc/
    trace_deposits_narrow.cu) on batch 0 of rotated mini, rotated 4x4 and
    rotated 13x13 (`gens`: the shared-memory instance, then the
    device-memory one), against its plain version at phase 31's bands and
    rerun bit for bit; and the redesigned 7-bit stream splat (row 15,
    csrc/splat_stream.cu) on batch 0's 1M-row stream of mini (the int32
    arena), the 4x4 tiling and mini tiled 13x13 (the paged accumulator),
    fused_splat_i8 and fused_splat_i8_add each against
    fused_splat_i8_plain (and lm + it) bit for bit, the device's scratch
    zero after every call. Each with its device ms and host µs a call
    (device_ms), the share of its bound, registers, shared bytes and
    blocks per SM."""
    import numpy as np
    import torch

    from flatmatch_tpu_torch.engines import photon_narrow as pn
    from flatmatch_tpu_torch.engines import photon_wide as pw
    from flatmatch_tpu_torch.ops import splat as sp
    from flatmatch_tpu_torch.utils import cuda_build

    regs = ptxas_registers(cuda_build.build_info["log"])
    ph = cfg.photon
    B, D = ph.photons_per_batch, ph.max_depth
    k38 = {}
    for scene, g in gens.items():
        k = narrow_vs_plain(g, cfg, B, reps=2, plain_reps=1)
        args = (g["table"], g["ev"], g["u_t"], B, ph)
        reps = {"rotated_mini": 50, "rotated_4x4": 10}.get(scene, 2)
        ms, host_us = device_ms(lambda: pn.trace_deposits_narrow(*args),
                                reps)
        inst, r, smem, blocks = narrow_occupancy(k["rects"], D, regs, dev)
        k.update(ms=ms, host_us=host_us, share_of_bound=k["bound_ms"] / ms,
                 instance=inst, registers=r, shared_bytes=smem,
                 blocks_per_sm=blocks)
        k38[scene] = k
    insts = [k38[s]["instance"] for s in gens]
    check(insts[0] != "device" and insts[1] != "device"
          and insts[2] == "device", f"row 11's instances {insts}")
    results["trace_deposits_narrow"].update(
        ms=k38["rotated_mini"]["ms"], bound_ms=k38["rotated_mini"][
            "bound_ms"], bound_by=k38["rotated_mini"]["bound_by"])

    scale = sp.splat_color_scale(ph)
    for scene, st in scenes.items():
        f, gc = st["aa_c"].fields, st["aa_c"].group_counts
        T = st["total_c"]
        idx, col = pw.trace_deposits_wide_rng(f, gc, st["ev"], st["seed"],
                                              B, B, ph, pw.stream_block(B))
        R = idx.shape[0]
        lm0 = torch.from_numpy(np.random.RandomState(38).rand(T, 3).astype(
            np.float32)).to(dev)
        lm = lm0.clone()
        want = sp.fused_splat_i8_plain(idx, col, T, scale)
        calls = {
            "fused_splat_i8": (lambda: sp.fused_splat_i8(idx, col, T, scale),
                               want),
            "fused_splat_i8_add": (
                lambda: sp.fused_splat_i8_add(lm, idx, col, scale),
                lm0 + want),
        }
        k = {}
        for name, (run, exact) in calls.items():
            got = run().clone()
            sync()
            check(exact.sum().item() > 0, f"{scene} {name}: plain is empty")
            check(torch.equal(got, exact), f"{scene} {name}: differs from "
                  f"fused_splat_i8_plain")
            scratch = sp._i8_scratch[sp._scratch_key(dev)]
            check(not bool(scratch.any()),
                  f"{scene} {name}: the scratch was not left zeroed")
            ms, host_us = device_ms(run, 50)
            bnd = splat_bound(R, T, name)
            inst, r, smem, blocks = splat_occupancy(T, regs, False, i8=True)
            k[name] = dict(equal_to_plain=True, ms=ms, host_us=host_us,
                           bound_ms=bnd[0], bound_by=bnd[1],
                           share_of_bound=bnd[0] / ms, accumulator=inst,
                           registers=r, shared_bytes=smem,
                           blocks_per_sm=blocks)
        check(k["fused_splat_i8"]["accumulator"] == (
            "arena" if scene == "mini" else "paged"),
            f"{scene}: row 15 took the {k['fused_splat_i8']['accumulator']}"
            f" accumulator")
        k38[scene] = dict(rows=R, texels=T, kernels=k)
    for name in ("fused_splat_i8", "fused_splat_i8_add"):
        mini = k38["mini"]["kernels"][name]
        results[name].update(ms=mini["ms"], bound_ms=mini["bound_ms"],
                             bound_by=mini["bound_by"])
    say("redesigned_narrow_and_i8_splat", **k38)


# --------------------------------------------------------------------------
# the redesigned nearest-hit kernels (rows 12-14) and the fold past its old
# cap (39)
# --------------------------------------------------------------------------
# the fold past its old cap: mini tiled 16x16 (6,912 rect slots, two
# passes) at this share of the CLI's samples, about 60 batches a pass
FOLD16_SAMPLES_SHARE = 1 / 2048


def redesigned_nearest_phase(nearest, walls17):
    """39. the redesigned nearest-hit kernels (rows 12-14: the photon
    trace's rect loop over per-rect records, the texel after the loop,
    grids of up to 32,768 blocks; row 12's tree within a warp by shuffles),
    as phases 12, 17 and 30 held them against their plain versions and
    timed them on mini, the 4x4 tiling and mini tiled 13x13 (`nearest`,
    scene -> kernels_vs_plain): mini and 4x4 take the shared-memory
    instances, 13x13 the device-memory ones; beside them, the walls of
    phase 17's 4x4 AO and radiosity renders."""
    for scene, want in (("mini", "shared"), ("4x4", "shared"),
                        ("13x13", "device")):
        insts = {kern: r["instance"] for kern, r in nearest[scene].items()}
        check(set(insts.values()) == {want},
              f"{scene}: the nearest-hit kernels took {insts}")
    say("redesigned_nearest_kernels", **{
        scene: {kern: {k: r[k] for k in (
            "ms", "host_us", "bound_ms", "share_of_bound", "instance",
            "registers", "shared_bytes", "blocks_per_sm")}
            for kern, r in k.items()} for scene, k in nearest.items()},
        apartment_4x4_walls=dict(
            walls17,
            aa_nearest_ms_per_chunk=nearest["4x4"]["aa_nearest"]["ms"],
            ao_fused_ms_per_pass=nearest["4x4"]["ao_fused"]["ms"]))


def fold_past_the_cap_phase(dev, cfg, make_layout):
    """39, part A. The fold past its old cap of 6,752 rect slots: mini tiled
    16x16 (6,912 slots, two passes of the fold), on a batch of 8192
    photons, both folds (counter hash, threefry uniforms) against their
    plain versions at the fold band (rtol 1e-4) and run twice bit for bit,
    with device ms a batch of the CLI's size; then one step of the fit
    (fit_materials) of that scene at FOLD16_SAMPLES_SHARE of the CLI's
    samples, with its launches, and one forward plus backward of it."""
    import numpy as np
    import torch

    from flatmatch_tpu_torch.diff.fit import fit_materials
    from flatmatch_tpu_torch.diff.render import make_diff_renderer_wide
    from flatmatch_tpu_torch.engines import photon_wide as pw
    from flatmatch_tpu_torch.ops import threefry
    from flatmatch_tpu_torch.ops.aa_scene import pack_aa

    ph = cfg.photon
    B, D = ph.photons_per_batch, ph.max_depth
    cfg16 = cfg.replace(photon=dataclasses.replace(
        ph, samples_per_area=ph.samples_per_area * FOLD16_SAMPLES_SHARE))
    with tempfile.TemporaryDirectory() as tmp:
        png = pathlib.Path(tmp) / "mini_16x16.png"
        make_layout.tiled(str(FIXTURES / "mini.png"), str(png), 16, 16)
        s16 = batch_setup(png, cfg16, dev)
    scene16 = s16["scene"]
    # the last emitter lights the last tile, whose rects lie past slot
    # 6,752 too (the first emitter's photons never leave tile 0)
    s16["ev"] = pw.emitter_vector(s16["em"], len(s16["em"].counts) - 1)
    f, gc = s16["aa_c"].fields, s16["aa_c"].group_counts
    n = f.shape[1]
    per = pw.fold_pass_slots(D)
    check(n == 6912 and per < n <= 2 * per,
          f"16x16: {n} slots, not two passes of {per}")
    passes = [(0, per), (per, n)]
    d = diff_setup(s16, cfg16, dev, power=1.7)
    Bc = 8192
    u = threefry.batch_uniforms(ph.seed, 0, Bc, pw.uniforms_per_photon(D),
                                dev, transposed=True)
    folds = {
        "trace_fold_wide_rng": (
            lambda: fold_batch(s16, d, cfg16, Bc),
            lambda: fold_plain(s16, d, cfg16, Bc)),
        "trace_fold_wide": (
            lambda: pw.trace_fold_wide(f, gc, d["alb"], d["ev"], d["g"], u,
                                       Bc, ph, n),
            lambda: pw.fold_plain(*pw.trace_uniforms_plain(
                f, gc, d["ev"], u.t(), Bc, ph, d["alb"]), d["g"], n)),
    }
    k = {}
    for name, (run, plain) in folds.items():
        (da, w), (da2, w2) = run(), run()
        want_da, want_w = plain()
        sync()
        check(torch.equal(da, da2) and torch.equal(w, w2),
              f"16x16 {name}: two runs differ")
        da_max = want_da.abs().max().item()
        check(da_max > 0, f"16x16 {name}: the plain fold folded nothing")
        check(bool(((da - want_da).abs()
                    <= 1e-4 * want_da.abs() + 1e-6 * da_max).all()),
              f"16x16 {name}: da differs from the plain fold")
        rel_w = abs(w.item() - want_w.item()) / abs(want_w.item())
        check(rel_w <= 1e-4, f"16x16 {name}: w_sum relative error {rel_w}")
        check(bool((want_da[passes[1][0]:] != 0).any()),
              f"16x16 {name}: no slot of the second pass was hit")
        k[name] = dict(da_max_abs_err=(da - want_da).abs().max().item(),
                       da_max=da_max, w_sum_rel_err=rel_w,
                       slots_touched=int((want_da != 0).sum().item()),
                       slots_touched_past_first_pass=int(
                           (want_da[passes[0][1]:] != 0).sum().item()),
                       bit_identical_rerun=True)
    k["trace_fold_wide_rng"]["ms_per_cli_batch"] = kernel_ms(
        lambda: fold_batch(s16, d, cfg16, B), 2)
    del d, u
    em = s16["em"]
    aa = pack_aa(scene16.walls, device=dev)
    r = make_diff_renderer_wide(em, scene16.num_texels, cfg16.photon, aa)
    nb = len(r.batches)
    with torch.no_grad():
        target = r(torch.full((len(scene16.walls),), 0.9, device=dev),
                   torch.ones(len(em.counts), device=dev)).cpu().numpy()
    reset_launches()
    sync()
    t0 = time.perf_counter()
    fit = fit_materials(target, None, em, scene16.num_texels, cfg16.photon,
                        aa=aa, steps=1, init_albedo=0.6, init_power=0.5)
    sync()
    fit_s = time.perf_counter() - t0
    launches = {kk: v for kk, v in read_launches().items() if v}
    want = {"trace_splat_wide_diff_rng_i8": 2 * nb, "trace_fold_wide_rng": nb}
    check(launches == want, f"16x16 fit step: launches {launches}, want "
          f"{want}")
    check(bool(np.isfinite(fit.losses).all() & np.isfinite(fit.albedo).all()
               & np.isfinite(fit.power).all()), "16x16 fit not finite")
    fwd, bwd, wall = fwd_bwd_ms(dev, r, len(scene16.walls), len(em.counts),
                                0.6, 0.5)
    say("fold_past_the_old_cap", scene="mini tiled 16x16", rects=n,
        fold_pass_slots=pw.fold_pass_slots(D), passes=passes,
        compact_texels=s16["total_c"], checked_batch=Bc, folds=k,
        fit=dict(samples_per_area=cfg16.photon.samples_per_area,
                 photons=int(em.counts.sum()), batches_per_pass=nb,
                 fit_materials_one_step_s=fit_s, launches=launches,
                 forward_ms=fwd, backward_ms=bwd, step_wall_s=wall))


def cli_photon_cfg():
    """The CLI's photon defaults: device RNG on, in-kernel 7-bit splat."""
    from flatmatch_tpu_torch.config import DEFAULT_CONFIG

    return DEFAULT_CONFIG.replace(photon=dataclasses.replace(
        DEFAULT_CONFIG.photon, device_rng=True, splat="inkernel_i8"))


def rotated_mini_texels(dev, checkpoint_path=None):
    """Mini turned 30 degrees through `run_engine` at the CLI's defaults:
    the narrow kernel (row 11), then the f32 stream splat (row 16). Also
    the body of phase 40's killed child process."""
    from flatmatch_tpu_torch.render import compile_scene, run_engine

    cfg = cli_photon_cfg()
    scene, _ = compile_scene(str(FIXTURES / "mini.png"), 30.0, cfg)
    return run_engine(rotated_scene(scene, 30), cfg, dev, checkpoint_path)


def killed_run(args, env_kill, timeout=600):
    """Run `args` (a Python command line) in a child process from the
    checkout's root with FLATMATCH_FAULT_EXIT_AFTER_CHECKPOINTS=env_kill:
    its wall seconds. The child must exit with code 17, after its
    env_kill-th checkpoint."""
    import os

    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, *args], cwd=ROOT, capture_output=True, text=True,
        timeout=timeout,
        env={**os.environ, "FLATMATCH_FAULT_EXIT_AFTER_CHECKPOINTS":
             str(env_kill)})
    wall = time.perf_counter() - t0
    check(res.returncode == 17 and "FAULT INJECTION" in res.stderr,
          f"killed run {args[:3]} exited {res.returncode}: "
          f"{res.stderr[-2000:]}")
    return wall


def batches_before(counts, B, cursor):
    """Batches of the schedule before checkpoint cursor (emitter, batch)."""
    from flatmatch_tpu_torch.engines import photon_wide as pw

    e0, b0 = cursor
    return sum(nb if e < e0 else b0 if e == e0 else 0
               for e, _, nb, _ in pw.emitter_schedule(counts, B))


def segments_of(counts, B, every):
    """Segments of `every` batches in the schedule (each emitter's batches
    cut on their own); every=1 counts its batches."""
    from flatmatch_tpu_torch.engines import photon_wide as pw

    return sum(-(-nb // every) for _, _, nb, _ in
               pw.emitter_schedule(counts, B))


def raw_bytes(out):
    return {p.name: p.read_bytes()
            for p in sorted((out / "tiles").glob("tile_*.raw"))}


def timed(fn):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return time.perf_counter() - t0, out


def publishing_phases(dev, make_layout):
    """Phases 40-43: checkpoint and resume, previews, package and serve,
    debug and the profiler, through the CLI at its defaults."""
    import base64
    import threading
    import urllib.error
    import urllib.request

    import numpy as np
    from PIL import Image

    from flatmatch_tpu_torch import cli
    from flatmatch_tpu_torch.io import rest
    from flatmatch_tpu_torch.io import tiles as tiles_io
    from flatmatch_tpu_torch.ops.device_scene import pack_emitters
    from flatmatch_tpu_torch.render import compile_scene
    from flatmatch_tpu_torch.utils import checkpoint as ckpt

    cfg = cli_photon_cfg()
    ph = cfg.photon
    B, every = ph.photons_per_batch, ph.checkpoint_every
    mini = FIXTURES / "mini.png"
    seconds = {}

    def counts_of(png):
        scene, _ = compile_scene(str(png), 30.0, cfg)
        return scene, pack_emitters(scene, ph.samples_per_area,
                                    ph.window_color, ph.light_color).counts

    def cursor_of(path):
        with np.load(path) as z:
            return int(z["emitter_index"]), int(z["batch_index"])

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        png4 = tmp / "mini_4x4.png"
        make_layout.tiled(str(mini), str(png4), 4, 4)

        # 40. a killed render resumes to the straight render's bits -------
        t40 = time.perf_counter()
        scene4, counts4 = counts_of(png4)
        batches4 = segments_of(counts4, B, 1)
        segs4 = segments_of(counts4, B, every)
        kill4 = segs4 // 2
        d = tmp / "40"
        args4 = [str(png4), "30", "--dump-raw"]

        def cli_run(name, *extra):
            """(wall s, row 1's launches, .raw bytes) of one render."""
            wall, got, out = cli_render([*args4, *extra], d / name,
                                        len(scene4.walls))
            return wall, got["trace_splat_wide_rng_i8"], raw_bytes(out)

        w_straight, n_straight, want = cli_run("straight")
        check(n_straight == batches4,
              f"{n_straight} launches, {batches4} batches")
        w_ck, n_ck, got = cli_run("ck", "--checkpoint", str(d / "full.npz"))
        check(n_ck == batches4, f"checkpointed: {n_ck} launches")
        check(got == want,
              "4x4: the checkpointed render differs from the straight one")
        with np.load(d / "full.npz") as z:
            lm4 = z["lightmap"]
        save_s, _ = timed(lambda: [ckpt.save(str(d / "probe.npz"), lm4, 0, 0,
                                             "0" * 16) for _ in range(5)])
        ck = str(d / "kill.npz")
        w_killed = killed_run(["-m", "flatmatch_tpu_torch.cli", "render",
                               *args4, "--checkpoint", ck, "--out",
                               str(d / "killed")], kill4)
        cursor = cursor_of(ck)
        left = batches4 - batches_before(counts4, B, cursor)
        w_resumed, n_resumed, got = cli_run("resumed", "--checkpoint", ck)
        check(n_resumed == left,
              f"resumed: {n_resumed} launches, {left} batches left")
        check(got == want,
              "4x4: the resumed render differs from the straight one")
        r40 = {"4x4": dict(
            route="trace_splat_wide_rng_i8 (row 1)", batches=batches4,
            segments=segs4, checkpoint_save_ms=save_s / 5 * 1e3,
            checkpoint_bytes=lm4.nbytes, killed_after_checkpoints=kill4,
            cursor_at_kill=cursor, batches_resumed=left,
            straight_wall_s=w_straight, checkpointed_wall_s=w_ck,
            killed_process_wall_s=w_killed, resumed_wall_s=w_resumed,
            raw_tiles_equal=len(want))}

        scene_m, counts_m = counts_of(mini)
        rcounts = pack_emitters(rotated_scene(scene_m, 30),
                                ph.samples_per_area, ph.window_color,
                                ph.light_color).counts

        def lib_run(path=None):
            reset_launches()
            wall, tex = timed(lambda: rotated_mini_texels(dev, path))
            got = read_launches()
            return wall, tex, got["trace_deposits_narrow"], got["fused_splat"]

        w_rs, tex_rs, n11, n16 = lib_run()
        w_rck, tex_rck, _, _ = lib_run(str(d / "rfull.npz"))
        check(tex_rck.tobytes() == tex_rs.tobytes(),
              "rotated mini: the checkpointed render differs")
        rck = str(d / "rkill.npz")
        rsegs = segments_of(rcounts, B, every)
        w_rkilled = killed_run(
            ["-c", "import sys, chip_smoke; chip_smoke."
             "rotated_mini_texels(sys.argv[1], sys.argv[2])", str(dev), rck],
            max(1, rsegs // 2))
        rcursor = cursor_of(rck)
        w_rres, tex_rres, n11r, n16r = lib_run(rck)
        check(tex_rres.tobytes() == tex_rs.tobytes(),
              "rotated mini: the resumed render differs")
        rbatches = segments_of(rcounts, B, 1)
        rleft = rbatches - batches_before(rcounts, B, rcursor)
        check(n11 == n16 == rbatches and n11r == n16r == rleft,
              f"rotated mini launches: rows 11/16 {n11}/{n16} straight, "
              f"{n11r}/{n16r} resumed; {rbatches} batches, {rleft} left")
        check(np.isfinite(tex_rs).all() and tex_rs.sum() > 0,
              "rotated mini render not finite and positive")
        r40["rotated_mini"] = dict(
            route="trace_deposits_narrow (row 11) + fused_splat (row 16)",
            batches=rbatches, segments=rsegs, cursor_at_kill=rcursor,
            batches_resumed=rleft, straight_wall_s=w_rs,
            checkpointed_wall_s=w_rck, killed_process_wall_s=w_rkilled,
            resumed_wall_s=w_rres, texels_equal=int(tex_rs.shape[0]))
        seconds["40"] = time.perf_counter() - t40
        say("checkpoint_resume", **r40, seconds=seconds["40"])

        # 41. progressive previews of mini ---------------------------------
        t41 = time.perf_counter()
        segs_m = segments_of(counts_m, B, every)
        n_m = len(scene_m.walls)
        w_plain, _, out_p = cli_render([str(mini), "30"], tmp / "41p", n_m)
        writes = []
        real_save = tiles_io.save_tiles

        def counting_save(*a, **k):
            writes.append(time.perf_counter())
            return real_save(*a, **k)

        tiles_io.save_tiles = counting_save
        try:
            w_prev, got, out_v = cli_render([str(mini), "30", "--preview"],
                                            tmp / "41v", n_m)
        finally:
            tiles_io.save_tiles = real_save
        check(got["trace_splat_wide_rng_i8"] == segments_of(counts_m, B, 1),
              f"preview: {got['trace_splat_wide_rng_i8']} launches")
        check(len(writes) == segs_m + 1,
              f"{len(writes)} tile writes, {segs_m} segments")

        def pngs(out):
            return [p.read_bytes() for p in
                    sorted((out / "tiles").glob("tile_*.png"))]

        check(pngs(out_v) == pngs(out_p),
              "the previewed render's final tiles differ")
        seconds["41"] = time.perf_counter() - t41
        say("preview", scene="mini", segments=segs_m,
            tile_writes=len(writes), tiles=n_m,
            straight_wall_s=w_plain, preview_wall_s=w_prev,
            final_tiles_equal=True, seconds=seconds["41"])

        # 42. package mini and the 4x4 tiling, serve the 4x4 tree ---------
        t42 = time.perf_counter()
        r42 = {}
        for name, png, n_walls in (("mini", mini, n_m),
                                   ("4x4", png4, len(scene4.walls))):
            out = tmp / "42" / name
            wall, rc = timed(lambda: cli.main([
                "package", str(png), "7", "30", "52.13", "11.62", "0.5",
                "2", "--out", str(out)]))
            check(rc == 0, f"package {name} returned {rc}")
            get = out / "rest" / "get"
            check((get / "layout" / "7").read_bytes() == png.read_bytes(),
                  f"{name}: layout is not the PNG")
            tex = json.loads((get / "textures" / "7").read_text())
            check(sorted(tex, key=int) == [str(i) for i in range(n_walls)],
                  f"{name}: {len(tex)} textures, {n_walls} walls")
            for i, b64 in tex.items():
                check(base64.b64decode(b64) == (
                    out / "tiles" / f"tile_{i}.png").read_bytes(),
                      f"{name}: texture {i} is not tile_{i}.png")
            r42[name] = dict(walls=n_walls, wall_s=wall,
                             offer_bytes=(get / "offer" / "7").stat().st_size,
                             textures_bytes=(get / "textures" / "7")
                             .stat().st_size)
        offer = rest.OFFER_TEMPLATE
        for key, val in (
                ("$COLLISION_MAP",
                 (FIXTURES / "mini_collisionMap.json").read_text()),
                ("$LONGITUDE", "11.62"), ("$LATITUDE", "52.13"),
                ("$LEVEL", "2"), ("$SCALE", "30.0"), ("$YAW", "0.5"),
                ("$LAYOUT", (FIXTURES / "mini_geometry.json").read_text()),
                ("$ROW_ID", "7")):
            offer = offer.replace(key, val)
        check((tmp / "42" / "mini" / "rest" / "get" / "offer" / "7")
              .read_text() == offer,
              "mini's offer does not splice the fixtures verbatim")

        root4 = tmp / "42" / "4x4"
        get4 = root4 / "rest" / "get"
        srv = rest.make_rest_server(str(root4), port=0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()

        def fetch(path):
            url = f"http://127.0.0.1:{srv.server_port}{path}"
            try:
                with urllib.request.urlopen(url, timeout=60) as r:
                    return r.status, r.read()
            except urllib.error.HTTPError as e:
                return e.code, b""

        routes = {
            "/": (200, rest._VIEWER_HTML.encode()),
            "/walk?id=7": (200, rest._WALK_HTML.encode()),
            "/offers": (200, b"[7]"),
            "/rest/get/offer/7": (200, (get4 / "offer" / "7").read_bytes()),
            "/rest/get/layout/7": (200, png4.read_bytes()),
            "/rest/get/textures/7": (
                200, (get4 / "textures" / "7").read_bytes()),
            "/rest/get/offer/8": (404, b""),
            "/rest/get/offer/..%2F..%2Fgeometry.json": (404, b""),
        }
        try:
            t_srv = time.perf_counter()
            for path, (status, body) in routes.items():
                got = fetch(path)
                check(got[0] == status and (status != 200 or got[1] == body),
                      f"served {path}: status {got[0]}, "
                      f"{len(got[1])} bytes")
            serve_s = time.perf_counter() - t_srv
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=60)
        check(not thread.is_alive(), "the REST server did not stop")
        seconds["42"] = time.perf_counter() - t42
        say("package_and_serve", **r42, routes_served=len(routes),
            serve_s=serve_s, seconds=seconds["42"])

        # 43. the first-hit debug render and the profiler ------------------
        t43 = time.perf_counter()
        w_dbg, rc = timed(lambda: cli.main([
            "debug", str(mini), "30", "--out", str(tmp / "dbg.png")]))
        check(rc == 0, f"debug returned {rc}")
        w_dbg_cpu, rc = timed(lambda: cli.main([
            "debug", str(mini), "30", "--device", "cpu", "--out",
            str(tmp / "dbg_cpu.png")]))
        check(rc == 0, f"debug --device cpu returned {rc}")
        card = np.asarray(Image.open(tmp / "dbg.png"))
        host = np.asarray(Image.open(tmp / "dbg_cpu.png"))
        share = float((card == host).all(-1).mean())
        check(card.shape == (768, 1024, 4) and share >= DEBUG_SHARE,
              f"debug: {share} of pixels equal the CPU's")
        check(len(np.unique(card[..., :3].reshape(-1, 3), axis=0)) >= 4,
              "debug: too few rects in view")
        prof = tmp / "prof"
        w_prof, got, _ = cli_render([str(mini), "30", "--profile", str(prof)],
                                    tmp / "43p", n_m)
        launches = got["trace_splat_wide_rng_i8"]
        events = json.loads((prof / "flatmatch_torch.pt.trace.json")
                            .read_text())["traceEvents"]
        kern = [e for e in events if "trace_splat_kernel" in
                str(e.get("name")) and e.get("ph") == "X"
                and e.get("cat") == "kernel"]
        check(launches > 0 and kern,
              f"the trace names trace_splat_kernel {len(kern)} times, "
              f"{launches} launches")
        seconds["43"] = time.perf_counter() - t43
        say("debug_and_profile", debug_wall_s=w_dbg,
            debug_cpu_wall_s=w_dbg_cpu, pixels_equal_share=share,
            profiled_render_wall_s=w_prof, straight_render_wall_s=w_plain,
            trace_splat_kernel_events=len(kern), launches=launches,
            trace_splat_kernel_device_ms=sum(e.get("dur", 0) for e in kern)
            / 1e3, seconds=seconds["43"])
    say("publishing_phases", seconds=seconds, total_s=sum(seconds.values()))


# --------------------------------------------------------------------------
# the general intersector on the card: its kernel, the general radiosity,
# the general differentiable renderer, the NumPy oracle (phases 44-47)
# --------------------------------------------------------------------------
def general_nearest_bound(n_rects, rays):
    """Bound of one general nearest-hit launch: every ray tests all
    n_rects rects (GENERAL_NEAREST_RECT_TEST_INSTRUCTIONS each, at
    LANE_INSTR_PER_S); bytes: the record table (64 a rect), the rays (24
    bytes each) read, dist and hit (8) written."""
    ops = rays * n_rects * GENERAL_NEAREST_RECT_TEST_INSTRUCTIONS
    return bound(64 * n_rects + 32 * rays, ops, LANE_INSTR_PER_S)


def second_bounce_rays(g, cfg):
    """The rays of the second bounce of batch 0 of emitter 0 of `g`
    (general_setup), as engines/photon.trace_deposits casts them."""
    import torch

    from flatmatch_tpu_torch.engines import photon
    from flatmatch_tpu_torch.engines.schedule import emitter_slice
    from flatmatch_tpu_torch.ops import intersect, threefry

    ph = cfg.photon
    u = threefry.batch_uniforms(ph.seed, 0, ph.photons_per_batch,
                                4 + 3 * ph.max_depth, g["rects"].n.device)
    rays = []

    def record(src, d, rects):
        rays.append((src.clone(), d.clone()))
        return intersect.nearest_hit(src, d, rects)

    photon.nearest_hit = record
    try:
        photon.trace_deposits(g["rects"], emitter_slice(g["em"], 0), u,
                              ph.photons_per_batch, ph)
    finally:
        photon.nearest_hit = intersect.nearest_hit
    check(len(rays) == ph.max_depth, "trace_deposits cast no rays")
    return tuple(torch.Tensor.contiguous(x) for x in rays[1])


def form_factor_rays(scene, dev, rays=10000, texels=None):
    """The general table of `scene`'s extended rects and the form-factor
    rays of wall 0's first chunk at `rays` rays a texel (its first
    `texels` texels when given), as engines/radiosity casts them."""
    import numpy as np
    import torch

    from flatmatch_tpu_torch.config import DEFAULT_CONFIG
    from flatmatch_tpu_torch.engines import radiosity
    from flatmatch_tpu_torch.ops import threefry
    from flatmatch_tpu_torch.ops.device_scene import pack_rects

    rad = DEFAULT_CONFIG.radiosity
    table = pack_rects(radiosity.extended_rects(scene)[0], device=dev)
    wall = scene.walls[0]
    c = radiosity.tile_centers(wall)[:texels or rad.texels_per_chunk]
    key = threefry.fold_in(threefry.fold_in(threefry.prng_key(rad.seed), 0),
                           0)
    src, d = radiosity.ff_rays(
        torch.from_numpy(c).to(dev),
        torch.from_numpy(np.asarray(wall.n, np.float32)).to(dev), key, rays)
    return table, src, d


def general_nearest_vs_plain(rects, src, d, reps=10, plain_reps=1,
                             cut=None):
    """The general nearest-hit kernel on rays (src, d) against
    nearest_hit_plain on the same card: every distance's bits and hit id
    equal (on the first `cut` rays when given), a rerun bit for bit; its
    device ms and host µs a launch (device_ms), the plain version's ms, the
    bound and its share, and the plan the library reports."""
    import torch

    from flatmatch_tpu_torch.ops import intersect

    dist, hit = intersect.nearest_hit(src, d, rects)
    dist2, hit2 = intersect.nearest_hit(src, d, rects)
    sync()
    check(torch.equal(dist.view(torch.int32), dist2.view(torch.int32))
          and torch.equal(hit, hit2), "general_nearest: two runs differ")
    cs, cd = src[:cut], d[:cut]
    pd, ph = intersect.nearest_hit_plain(cs, cd, rects)
    sync()
    n_cmp = pd.shape[0]
    same_d = torch.equal(dist[:n_cmp].view(torch.int32), pd.view(torch.int32))
    same_h = torch.equal(hit[:n_cmp], ph)
    check(same_d and same_h, f"general_nearest differs from its plain "
          f"version: distances equal {same_d}, hits equal {same_h}")
    n = intersect.general_table(rects).shape[0]
    R = src.shape[0]
    ms, host_us = device_ms(lambda: intersect.nearest_hit(src, d, rects),
                            reps)
    pms = cuda_ms(lambda: intersect.nearest_hit_plain(cs, cd, rects),
                  plain_reps)
    bnd = general_nearest_bound(n, R)
    return dict(rays=R, compared_rays=n_cmp, rects=n,
                hit_share=torch.isfinite(pd).float().mean().item(),
                bit_identical_to_plain=True, bit_identical_rerun=True,
                ms=ms, host_us=host_us,
                **{"plain_ms_compared" if cut else "plain_ms": pms},
                bound_ms=bnd[0], bound_by=bnd[1], share_of_bound=bnd[0] / ms,
                **intersect.general_plan(n, rects.n.device))


def general_intersector_phases(dev, results, make_layout):
    import dataclasses as dc

    import numpy as np
    import torch

    from flatmatch_tpu_torch import cli
    from flatmatch_tpu_torch.config import DEFAULT_CONFIG, Engine
    from flatmatch_tpu_torch.diff import render as prender
    from flatmatch_tpu_torch.diff.fit import fit_materials
    from flatmatch_tpu_torch.engines import photon, radiosity
    from flatmatch_tpu_torch.engines.schedule import emitter_slice
    from flatmatch_tpu_torch.io.tiles import load_tile_raw
    from flatmatch_tpu_torch.ops import intersect, threefry
    from flatmatch_tpu_torch.ops.device_scene import (
        exposure_scale, pack_emitters, pack_rects,
    )
    from flatmatch_tpu_torch.render import compile_scene, run_engine
    from flatmatch_tpu_torch.scene.rectangle import num_tiles

    t_all = time.perf_counter()
    seconds = {}
    mini = FIXTURES / "mini.png"
    cfg = DEFAULT_CONFIG
    ph = cfg.photon
    scene, _ = compile_scene(str(mini), 30.0, cfg)
    rscene = rotated_scene(scene, 30)
    with tempfile.TemporaryDirectory() as tmp:
        scenes = {}
        for k in (4, 13):
            png = pathlib.Path(tmp) / f"mini_{k}x{k}.png"
            make_layout.tiled(str(mini), str(png), k, k)
            scenes[k] = rotated_scene(compile_scene(str(png), 30.0, cfg)[0],
                                      30)

    # 44. the general nearest-hit kernel against its plain version ---------
    t0 = time.perf_counter()
    k44 = {}
    for name, sc in (("mini", scene), ("rotated_mini", rscene),
                     ("rotated_4x4", scenes[4])):
        g = general_setup(sc, cfg, dev)
        src, d = second_bounce_rays(g, cfg)
        k44[f"{name}_photon"] = general_nearest_vs_plain(g["rects"], src, d)
        if name != "mini":
            table, src, d = form_factor_rays(sc, dev)
            k44[f"{name}_form_factors"] = general_nearest_vs_plain(
                table, src, d, reps=3,
                cut=None if name == "rotated_mini" else 1 << 20)
        del g, src, d
    table, src, d = form_factor_rays(scenes[13], dev, texels=7)
    k44["rotated_13x13_form_factors"] = general_nearest_vs_plain(
        table, src[:65536].contiguous(), d[:65536].contiguous(), reps=3)
    del table, src, d
    check(k44["rotated_13x13_form_factors"]["instance"] == "device"
          and k44["rotated_13x13_form_factors"]["rects"] > 3632,
          "rotated 13x13's extended rects took the shared-memory instance")
    check(all(v["instance"] == "shared" for k, v in k44.items()
              if not k.startswith("rotated_13x13")),
          "a table under 3,632 rects took the device-memory instance")
    r = k44["rotated_mini_form_factors"]
    results["general_nearest"] = dict(
        max_abs_err=0.0, ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None)
    seconds["44"] = time.perf_counter() - t0
    say("general_nearest_vs_plain", **k44, seconds=seconds["44"])

    # 45. radiosity of rotated mini at the CLI defaults ---------------------
    t0 = time.perf_counter()
    cfg_rad = cfg.replace(engine=Engine.RADIOSITY)
    rad = cfg_rad.radiosity
    chunks = sum(-(-num_tiles(w) // rad.texels_per_chunk)
                 for w in rscene.walls)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    sync()
    t1 = time.perf_counter()
    out45 = run_engine(rscene, cfg_rad, dev)
    wall45 = time.perf_counter() - t1
    launches45 = {k: v for k, v in read_launches().items() if v}
    peak45 = torch.cuda.max_memory_allocated()
    check(launches45 == {"general_nearest": chunks,
                         "threefry_uniform": chunks},
          f"rotated mini radiosity launches {launches45}, want {chunks} "
          f"general_nearest and threefry_uniform")
    results["general_nearest"]["launches"] = chunks
    bands45 = radiosity_bands(rscene, out45, rad.rays_per_texel)
    prof45 = profiled(lambda: run_engine(rscene, cfg_rad, dev))
    # rotated 4x4's form-factor pass
    _, table6, _ = radiosity.prepare(scenes[4], rad, dev)
    chunks6 = sum(-(-num_tiles(w) // rad.texels_per_chunk)
                  for w in scenes[4].walls)
    reset_launches()
    sync()
    t1 = time.perf_counter()
    ids6 = radiosity.form_factors(scenes[4], table6, rad)
    sync()
    ff6 = time.perf_counter() - t1
    launches6 = read_launches()["general_nearest"]
    check(launches6 == chunks6, f"rotated 4x4 form factors: {launches6} "
          f"launches, want {chunks6}")
    hit6 = (ids6 >= 0).float().mean().item()
    check(hit6 > 0.95, f"rotated 4x4 form factors: {hit6} of rays hit")
    del ids6
    prof6 = profiled(lambda: radiosity.form_factors(scenes[4], table6, rad))
    seconds["45"] = time.perf_counter() - t0
    say("general_radiosity", rotated_mini=dict(
        rays=rad.rays_per_texel, iterations=rad.iterations, wall_s=wall45,
        form_factor_launches=chunks, launches=launches45,
        peak_device_bytes=peak45, profile=prof45, **bands45),
        rotated_4x4_form_factors=dict(
            rects=int(intersect.general_table(table6).shape[0]),
            launches=launches6,
            rays=int(sum(num_tiles(w) for w in scenes[4].walls))
            * rad.rays_per_texel, wall_s=ff6, hit_share=hit6,
            profile=prof6), seconds=seconds["45"])
    del table6

    # 46. the general diff renderer on rotated mini -------------------------
    t0 = time.perf_counter()
    g = general_setup(rscene, cfg, dev)
    rects, em = g["rects"], g["em"]
    T, N, E = rscene.num_texels, rects.n.shape[0], len(em.counts)
    r46 = prender.make_diff_renderer(rects, em, T, ph)
    a0 = torch.full((N,), np.float32(ph.albedo), device=dev)
    p0 = torch.ones(E, device=dev)
    reset_launches()
    sync()
    t1 = time.perf_counter()
    with torch.no_grad():
        fwd = r46(a0, p0)
    sync()
    fwd_s = time.perf_counter() - t1
    launches46 = {k: v for k, v in read_launches().items() if v}
    n_b = sum(-(-int(n) // ph.photons_per_batch) for n in em.counts if n)
    want46 = {"general_nearest": n_b * ph.max_depth, "threefry_uniform": n_b,
              "fused_splat": n_b}
    check(launches46 == want46, f"diff forward launches {launches46}, "
          f"want {want46}")
    check(torch.equal(fwd, photon.render_photons(rects, em, T, ph)),
          "the general diff forward differs from render_photons")
    # the card's share of the general engine's batches: 16 of them under
    # the profiler (a whole render's events take the profiler minutes)
    em0 = emitter_slice(em, 0)
    lm16 = torch.zeros((T, 3), device=dev)
    prof46 = profiled(lambda: [photon.trace_batch(
        lm16, rects, em0, threefry.batch_uniforms(
            ph.seed, gb, ph.photons_per_batch, 4 + 3 * ph.max_depth, dev),
        ph.photons_per_batch, ph) for gb in range(16)])
    del lm16
    fwd_ms, bwd_ms, step_s = fwd_bwd_ms(dev, r46, N, E, ph.albedo, 1.0)
    # gradients against the oracle at a small budget
    small = dc.replace(ph, samples_per_area=ph.samples_per_area / 512,
                       photons_per_batch=16384)
    em_s = pack_emitters(rscene, small.samples_per_area, small.window_color,
                         small.light_color, device=dev)
    w46 = torch.from_numpy(np.random.RandomState(46).rand(T, 3).astype(
        np.float32)).to(dev)
    alb = torch.from_numpy(np.random.RandomState(47).uniform(
        0.5, 0.95, N).astype(np.float32)).to(dev)
    pw_ = torch.linspace(0.8, 1.3, E, device=dev)

    def grads(fn):
        a, p = alb.clone().requires_grad_(), pw_.clone().requires_grad_()
        torch.sum(fn(a, p) * w46).backward()
        return a.grad, p.grad

    rs = prender.make_diff_renderer(rects, em_s, T, small)
    ga, gp = grads(rs)
    oa, op = grads(prender.make_autodiff_oracle(rects, em_s, T, small))
    ga2, gp2 = grads(rs)
    sync()
    check(torch.equal(ga, ga2) and torch.equal(gp, gp2),
          "two replayed backward passes differ")
    check(bool(((ga - oa).abs() <= 1e-4 * oa.abs() + 1e-2).all()),
          f"albedo gradient off the oracle by {(ga - oa).abs().max()}")
    check(bool(((gp - op).abs() <= 1e-4 * op.abs()).all()),
          f"power gradient off the oracle by {(gp - op).abs().max()}")
    check(ga.abs().sum().item() > 0, "no albedo gradient")
    # a power-only fit at the small budget
    with torch.no_grad():
        target = rs(a0, torch.full((E,), 1.3, device=dev))
    fit = fit_materials(target.cpu().numpy(), rects, em_s, T, small,
                        aa=None, steps=20, fit_albedo=False)
    check(fit.losses[-1] < fit.losses[0] / 10,
          f"general fit loss {fit.losses[0]} -> {fit.losses[-1]}")
    seconds["46"] = time.perf_counter() - t0
    say("general_diff_renderer", scene="rotated_mini", batches=n_b,
        photons=int(em.counts.sum()), forward_equals_render_photons=True,
        photon_xla_16_batches_profile=prof46,
        forward_s=fwd_s, launches=launches46, forward_ms=fwd_ms,
        backward_ms=bwd_ms, step_s=step_s,
        small_budget=dict(batches=len(list(rs.batches())),
                          albedo_max_abs_err=(ga - oa).abs().max().item(),
                          power_max_rel_err=((gp - op).abs() / op.abs())
                          .max().item(), bit_identical_rerun=True),
        fit_losses=[float(fit.losses[0]), float(fit.losses[-1])],
        fit_power=fit.power.tolist(), seconds=seconds["46"])
    del g, rects, r46, fwd

    # 47. --engine photon_oracle of tiny against photon_xla on the card -----
    t0 = time.perf_counter()
    tiny = FIXTURES / "tiny.png"
    flags = ["--samples-per-area", "3000", "--photons-per-batch", "512",
             "--seed", "7", "--dump-raw"]
    raws, walls47 = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for engine in ("photon_oracle", "photon_xla"):
            w, launches, out = cli_render(
                [str(tiny), "30", "--engine", engine, *flags],
                pathlib.Path(tmp) / engine, 13)
            walls47[engine] = dict(wall_s=w, launches={
                k: v for k, v in launches.items() if v})
            raws[engine] = np.concatenate([
                load_tile_raw(str(out / "tiles" / f"tile_{i}.raw"))[1]
                .reshape(-1, 3) for i in range(13)])
    tscene, _ = compile_scene(str(tiny), 30.0, cfg)
    es = exposure_scale(tscene, 3000.0, ph.exposure)
    es = np.concatenate([es[w.base:w.base + num_tiles(w)]
                         for w in tscene.walls])
    ora, xla = (raws[k] / es[:, None] for k in ("photon_oracle",
                                                 "photon_xla"))
    close = float(np.isclose(ora, xla, rtol=1e-3, atol=1e-2).mean())
    total = float(abs(ora.sum() / xla.sum() - 1))
    check(xla.sum() > 0 and close >= 0.999 and total <= 1e-4,
          f"photon_oracle against photon_xla: {close} of cells close, "
          f"total off by {total}")
    n47 = walls47["photon_oracle"]["launches"].get("threefry_uniform", 0)
    check(n47 > 0 and set(walls47["photon_oracle"]["launches"])
          == {"threefry_uniform"},
          f"photon_oracle launches {walls47['photon_oracle']['launches']}")
    seconds["47"] = time.perf_counter() - t0
    say("photon_oracle_vs_photon_xla", scene="tiny", cells_close=close,
        total_rel_err=total, **walls47, seconds=seconds["47"])
    say("general_intersector_phases", seconds=seconds,
        total_s=time.perf_counter() - t_all)


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from flatmatch_tpu_torch import cli
    from flatmatch_tpu_torch.diff.fit import fit_materials
    from flatmatch_tpu_torch.diff.render import make_diff_renderer_wide
    from flatmatch_tpu_torch.engines import photon_wide as pw
    from flatmatch_tpu_torch.ops.aa_scene import pack_aa
    from flatmatch_tpu_torch.render import run_engine
    from flatmatch_tpu_torch.scene.rectangle import num_tiles
    from flatmatch_tpu_torch.utils import cuda_build

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    mini = FIXTURES / "mini.png"
    cfg = cli_photon_cfg()
    B = cfg.photon.photons_per_batch
    scale = np.float32(pw.splat_color_scale(cfg.photon))

    # 1. build -------------------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.load_library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in cuda_build.build_info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    say("build", seconds=build_s, library=cuda_build.build_info["path"],
        ptxas=ptxas, torch=torch.__version__, cuda=torch.version.cuda,
        device=kind, card=card)

    # 2. kernel against its plain version on the card -------------------------
    s = batch_setup(mini, cfg, dev)
    got = kernel_batch(s, cfg, B)
    torch.cuda.synchronize()
    want = plain_batch(s, cfg, B)
    torch.cuda.synchronize()
    eq_share = (got == want).float().mean().item()
    e_got, e_want = got.sum().item(), want.sum().item()
    max_abs_err = ((got.float() - want.float()).abs().max().item()
                   * float(scale))
    check(e_want > 0, "plain version deposited nothing")
    check(abs(e_got - e_want) <= 1e-6 * abs(e_want),
          f"energy {e_got} vs plain {e_want}")
    check(eq_share >= 0.999, f"only {eq_share:.6f} of cells equal")
    acc = torch.empty_like(got)
    ms = kernel_ms(lambda: kernel_batch(s, cfg, B, out=acc), 20)
    plain_ms = cuda_ms(lambda: plain_batch(s, cfg, B), 3)
    bounces = traced_bounces(s, cfg, B)
    n_rects = s["aa_c"].fields.shape[1]
    bound_ms, bound_by = trace_bound(s, bounces, B, "trace_splat_wide_rng_i8")
    say("kernel_vs_plain", scene="mini", batch=B, cells=got.numel(),
        rects=n_rects, traced_bounces_per_photon=bounces / B,
        kernel_rect_tests_per_s=bounces * n_rects / ms * 1e3,
        equal_share=eq_share, energy=e_got, plain_energy=e_want,
        max_abs_err=max_abs_err, kernel_ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by,
        kernel_photons_per_s=B / ms * 1e3, plain_photons_per_s=B / plain_ms
        * 1e3)
    results = {"trace_splat_wide_rng_i8": dict(
        max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None)}

    # 3. determinism: one emitter's full schedule, twice ----------------------
    sched = [pw.emitter_schedule(s["em"].counts, B)[0]]
    em0 = s["em"]._replace(counts=np.where(
        np.arange(len(s["em"].counts)) == sched[0][0], s["em"].counts, 0))

    def emitter_render():
        return pw.render_all_wide(s["aa_c"].fields, s["aa_c"].group_counts,
                                  em0, cfg.photon, s["total_c"])

    a, b = emitter_render(), emitter_render()
    torch.cuda.synchronize()
    check(torch.equal(a, b), "two runs of one emitter differ")
    check(bool(torch.isfinite(a).all()) and a.sum().item() > 0,
          "emitter render is not finite and positive")
    say("determinism", emitter=0, batches=sched[0][2], bit_identical=True)

    # 4. the CLI path at its defaults ------------------------------------------
    counts = s["em"].counts
    n_batches = sum(-(-int(n) // B) for n in counts if n > 0)
    photons = int(counts.sum())
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "mini"
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(["render", str(mini), "30", "--out", str(out)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = pw.trace_splat_wide_rng_i8.launches
        results["trace_splat_wide_rng_i8"]["launches"] = launches
        check(rc == 0, f"cli returned {rc}")
        tiles = sorted((out / "tiles").glob("tile_*.png"))
        check(len(tiles) == 27, f"{len(tiles)} tiles, want 27")
        for art in ("geometry", "collisionMap"):
            check((out / f"{art}.json").read_bytes()
                  == (FIXTURES / f"mini_{art}.json").read_bytes(),
                  f"{art}.json differs from the fixture")
    check(launches == n_batches, f"{launches} launches, {n_batches} batches")
    check(photons == 61_862_829, f"{photons} photons")
    say("cli_render", scene="mini", samples_per_area=cfg.photon
        .samples_per_area, photons=photons, batches=n_batches,
        launches=launches, tiles=len(tiles), wall_s=wall,
        photons_per_s=photons / wall)

    # 5. physics against the reference C engine --------------------------------
    spa = 200000.0
    cfg5 = cfg.replace(photon=dataclasses.replace(
        cfg.photon, samples_per_area=spa))
    s5 = batch_setup(mini, cfg5, dev)
    scene = s5["scene"]
    raw = pw.render_photons(s5["em"], scene.num_texels, cfg5.photon,
                            pack_aa(scene.walls, device=dev))
    say("physics_vs_reference", scene="mini", samples_per_area=spa,
        photons=int(s5["em"].counts.sum()),
        **physics_bands(scene, raw.cpu().numpy(), "inkernel_i8"))

    # 6. apartment scale: mini tiled 4x4 --------------------------------------
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_layout", FIXTURES / "make_layout.py")
    make_layout = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(make_layout)
    with tempfile.TemporaryDirectory() as tmp:
        png = pathlib.Path(tmp) / "mini_4x4.png"
        make_layout.tiled(str(mini), str(png), 4, 4)
        s6 = batch_setup(png, cfg, dev)
        scene6 = s6["scene"]
        rects, T, Tc = len(scene6.walls), scene6.num_texels, s6["total_c"]
        check((rects, T, Tc) == (432, 130352, 96384),
              f"tiling gave {rects} rects, {T} texels, {Tc} compact")
        photons6 = int(s6["em"].counts.sum())
        check(photons6 == 989_805_360, f"{photons6} photons")
        ms6 = cuda_ms(lambda: kernel_batch(s6, cfg, B), 10)
        plain_ms6 = cuda_ms(lambda: plain_batch(s6, cfg, B), 2)
        bounces6 = traced_bounces(s6, cfg, B)
        pw.trace_splat_wide_rng_i8.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tex = run_engine(scene6, cfg, device=dev)
        wall6 = time.perf_counter() - t0
        launches6 = pw.trace_splat_wide_rng_i8.launches
    batches6 = sum(-(-int(n) // B) for n in s6["em"].counts if n > 0)
    check(launches6 == batches6, f"{launches6} launches, {batches6} batches")
    check(np.isfinite(tex).all() and tex.sum() > 0, "4x4 render not finite")
    b6 = trace_bound(s6, bounces6, B, "trace_splat_wide_rng_i8")
    say("apartment_4x4", rects=rects, texels=T, compact_texels=Tc,
        photons=photons6, batches=batches6, launches=launches6,
        wall_s=wall6, photons_per_s=photons6 / wall6,
        kernel_ms_per_batch=ms6, kernel_photons_per_s=B / ms6 * 1e3,
        traced_bounces_per_photon=bounces6 / B,
        kernel_rect_tests_per_s=bounces6 * rects / ms6 * 1e3,
        plain_ms_per_batch=plain_ms6,
        plain_photons_per_s=B / plain_ms6 * 1e3, bound_ms=b6[0],
        bound_by=b6[1])

    # 7. diff forward kernel against its plain version and production ------
    d7 = diff_setup(s, cfg, dev, power=1.7)
    got7 = diff_batch(s, d7, cfg, B)
    torch.cuda.synchronize()
    want7 = diff_plain(s, d7, cfg, B)
    torch.cuda.synchronize()
    eq7 = (got7 == want7).float().mean().item()
    err7 = ((got7.float() - want7.float()).abs().max() * d7["scale"]).item()
    check(want7.sum().item() > 0, "plain diff forward deposited nothing")
    check(eq7 >= 0.999, f"diff forward: only {eq7:.6f} of cells equal")
    d_def = diff_setup(s, cfg, dev, power=1.0)
    prod7 = kernel_batch(s, cfg, B)
    diff_def = diff_batch(s, d_def, cfg, B)
    torch.cuda.synchronize()
    check(torch.equal(prod7, diff_def),
          "diff forward at the default parameters differs from production")
    ms7 = kernel_ms(lambda: diff_batch(s, d7, cfg, B, out=acc), 20)
    plain_ms7 = cuda_ms(lambda: diff_plain(s, d7, cfg, B), 3)
    b7 = trace_bound(s, bounces, B, "trace_splat_wide_diff_rng_i8")
    results["trace_splat_wide_diff_rng_i8"] = dict(
        max_abs_err=err7, ms=ms7, plain_ms=plain_ms7, bound_ms=b7[0],
        bound_by=b7[1], library_ms=None)
    say("diff_forward_vs_plain", scene="mini", batch=B, power=1.7,
        equal_share=eq7, max_abs_err=err7, bit_identical_to_production=True,
        kernel_ms=ms7, plain_ms=plain_ms7, production_ms=ms, bound_ms=b7[0],
        bound_by=b7[1])

    # 8. fold kernel against its plain version, and determinism -------------
    da8, w8 = fold_batch(s, d7, cfg, B)
    da8b, w8b = fold_batch(s, d7, cfg, B)
    torch.cuda.synchronize()
    check(torch.equal(da8, da8b) and torch.equal(w8, w8b),
          "two fold runs differ")
    want_da, want_w = fold_plain(s, d7, cfg, B)
    torch.cuda.synchronize()
    err8 = (da8 - want_da).abs().max().item()
    da_max = want_da.abs().max().item()
    rel_w = abs(w8.item() - want_w.item()) / abs(want_w.item())
    check(da_max > 0, "plain fold folded nothing")
    # f32 sums in another order than index_add_: rtol 1e-4
    check(bool(((da8 - want_da).abs()
                <= 1e-4 * want_da.abs() + 1e-6 * da_max).all()),
          f"fold da differs from the plain fold (max abs err {err8})")
    check(rel_w <= 1e-4, f"fold w_sum relative error {rel_w}")
    ms8 = kernel_ms(lambda: fold_batch(s, d7, cfg, B), 20)
    plain_ms8 = cuda_ms(lambda: fold_plain(s, d7, cfg, B), 3)
    b8 = trace_bound(s, bounces, B, "trace_fold_wide_rng")
    results["trace_fold_wide_rng"] = dict(
        max_abs_err=err8, ms=ms8, plain_ms=plain_ms8, bound_ms=b8[0],
        bound_by=b8[1], library_ms=None)
    say("fold_vs_plain", scene="mini", batch=B, da_max_abs_err=err8,
        da_max=da_max, w_sum=w8.item(), w_sum_rel_err=rel_w,
        bit_identical_rerun=True, kernel_ms=ms8, plain_ms=plain_ms8,
        forward_ms=ms7, bound_ms=b8[0], bound_by=b8[1])

    # 9. the power identity of the gradient ---------------------------------
    n5 = len(scene.walls)
    r9 = make_diff_renderer_wide(s5["em"], scene.num_texels, cfg5.photon,
                                 pack_aa(scene.walls, device=dev))
    rs9 = np.random.RandomState(9)
    a9 = torch.from_numpy(rs9.uniform(0.5, 0.95, n5).astype(np.float32)).to(
        dev).requires_grad_()
    p9 = torch.tensor([1.3, 0.7], device=dev, requires_grad=True)
    w9 = torch.from_numpy(rs9.rand(scene.num_texels, 3).astype(np.float32)
                          ).to(dev)
    loss9 = torch.sum(r9(a9, p9) * w9)
    loss9.backward()
    ident = torch.sum(p9.grad * p9).item()
    rel9 = abs(ident - loss9.item()) / abs(loss9.item())
    # every deposit is linear in power; the slack is the fold's bf16 g
    check(rel9 <= 1e-2, f"power identity off by {rel9}")
    check(bool(torch.isfinite(a9.grad).all()), "albedo gradient not finite")
    say("power_identity", scene="mini", samples_per_area=spa,
        loss=loss9.item(), sum_p_dl_dp=ident, rel_err=rel9, rtol=1e-2)

    # 10. render --dump-raw, then fit, through the CLI at its defaults ------
    steps = 100
    fit_batches = len(make_diff_renderer_wide(
        s["em"], s["scene"].num_texels, cfg.photon,
        pack_aa(s["scene"].walls, device=dev)).batches)
    with tempfile.TemporaryDirectory() as tmp:
        target = pathlib.Path(tmp) / "target"
        check(cli.main(["render", str(mini), "30", "--dump-raw", "--out",
                        str(target)]) == 0, "render --dump-raw failed")
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(["fit", str(mini), str(target / "tiles"), "30",
                       "--fit-init-albedo", "0.6", "--fit-init-power", "0.5",
                       "--out", str(pathlib.Path(tmp) / "fit")])
        torch.cuda.synchronize()
        wall10 = time.perf_counter() - t0
        fit_launches = read_launches()
        check(rc == 0, f"fit returned {rc}")
        rep = json.loads((pathlib.Path(tmp) / "fit" / "fitted.json")
                         .read_text())
    check(rep["steps"] == steps, f"fit ran {rep['steps']} steps")
    check(rep["final_loss"] < rep["initial_loss"] / 10,
          f"fit loss {rep['initial_loss']} -> {rep['final_loss']}")
    n_diff = fit_launches["trace_splat_wide_diff_rng_i8"]
    n_fold = fit_launches["trace_fold_wide_rng"]
    # one forward and one backward per step, and the render at the end
    check(n_diff == (steps + 1) * fit_batches,
          f"{n_diff} diff launches, want {(steps + 1) * fit_batches}")
    check(n_fold == steps * fit_batches,
          f"{n_fold} fold launches, want {steps * fit_batches}")
    check(fit_launches["trace_splat_wide_rng_i8"] == 0,
          "the fit launched the production kernel")
    results["trace_splat_wide_diff_rng_i8"]["launches"] = n_diff
    results["trace_fold_wide_rng"]["launches"] = n_fold

    r10 = make_diff_renderer_wide(s["em"], s["scene"].num_texels, cfg.photon,
                                  pack_aa(s["scene"].walls, device=dev))
    fwd10, bwd10, step10 = fwd_bwd_ms(dev, r10, len(s["scene"].walls),
                                      len(s["em"].counts), 0.6, 0.5)
    # steady fit steps (Adam included), and the one-time import that
    # torch.optim's first optimizer pulls in (torch._dynamo), in a fresh
    # interpreter: both are part of the CLI wall above
    with torch.no_grad():
        target10 = r10(torch.full((len(s["scene"].walls),), 0.9, device=dev),
                       torch.ones(len(s["em"].counts), device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit_materials(target10.cpu().numpy(), None, s["em"],
                  s["scene"].num_texels,
                  cfg.photon, aa=pack_aa(s["scene"].walls, device=dev),
                  steps=10, init_albedo=0.6, init_power=0.5)
    torch.cuda.synchronize()
    steady_step = (time.perf_counter() - t0) / 10
    probe = subprocess.run(
        [sys.executable, "-c", "import time, torch; t = time.perf_counter(); "
         "import torch._dynamo; print(time.perf_counter() - t)"],
        capture_output=True, text=True, timeout=300)
    check(probe.returncode == 0, f"import probe failed: {probe.stderr}")
    say("cli_fit", scene="mini", steps=steps, initial_loss=rep[
        "initial_loss"], final_loss=rep["final_loss"],
        loss_ratio=rep["final_loss"] / rep["initial_loss"],
        batches_per_pass=fit_batches, launches=fit_launches,
        diff_launches_per_step=fit_batches, fold_launches_per_step=fit_batches,
        wall_s=wall10, wall_s_per_step=wall10 / steps,
        forward_ms=fwd10, backward_ms=bwd10, step_wall_s=step10,
        steady_fit_step_s=steady_step,
        optimizer_first_import_s=float(probe.stdout.strip()))

    # 11. one forward + backward of the 4x4 tiling at the defaults ----------
    d11 = diff_setup(s6, cfg, dev, power=1.7)
    ms11f = cuda_ms(lambda: diff_batch(s6, d11, cfg, B), 10)
    ms11b = cuda_ms(lambda: fold_batch(s6, d11, cfg, B), 10)
    plain11f = cuda_ms(lambda: diff_plain(s6, d11, cfg, B), 2)
    plain11b = cuda_ms(lambda: fold_plain(s6, d11, cfg, B), 2)
    r11 = make_diff_renderer_wide(s6["em"], scene6.num_texels, cfg.photon,
                                  pack_aa(scene6.walls, device=dev))
    fwd11, bwd11, wall11 = fwd_bwd_ms(dev, r11, rects, len(s6["em"].counts),
                                      cfg.photon.albedo, 1.0)
    b11f = trace_bound(s6, bounces6, B, "trace_splat_wide_diff_rng_i8")
    b11b = trace_bound(s6, bounces6, B, "trace_fold_wide_rng")
    say("apartment_4x4_fit_step", rects=rects, batches_per_pass=len(
        r11.batches), photons=photons6, forward_ms=fwd11, backward_ms=bwd11,
        wall_s=wall11, diff_kernel_ms_per_batch=ms11f,
        fold_kernel_ms_per_batch=ms11b, diff_plain_ms_per_batch=plain11f,
        fold_plain_ms_per_batch=plain11b, diff_bound_ms=b11f[0],
        fold_bound_ms=b11b[0], production_ms_per_batch=ms6)

    walls17, nearest = ao_radiosity_phases(dev, results, make_layout)
    stream_phases(dev, results, cfg, s, dict(s5, cfg=cfg5), s6)
    inkernel_phases(dev, results, cfg, s, dict(s5, cfg=cfg5), s6)
    nearest["13x13"] = threefry_phases(dev, results, cfg, s, s6,
                                       make_layout)
    gens = general_phases(dev, results, make_layout)
    s13 = redesigned_trace_phase(dev, cfg, s, s6, make_layout)
    redesigned_splat_phase(dev, results, cfg, {"mini": s, "4x4": s6,
                                               "13x13": s13})
    redesigned_narrow_splat_phase(dev, results, cfg, gens,
                                  {"mini": s, "4x4": s6, "13x13": s13})
    redesigned_nearest_phase(nearest, walls17)
    fold_past_the_cap_phase(dev, cfg, make_layout)
    publishing_phases(dev, make_layout)
    general_intersector_phases(dev, results, make_layout)

    print(json.dumps({"kernels": [dict(KERNELS[k], **results[k])
                                  for k in KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
