"""The benchmark's run: one cell of BENCHMARK.json, measured once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up (timed as setup_s, from the process's start): import torch, check
the cards, load the program and its CUDA library (built into the
checkout's flatmatch_tpu_torch/_build/ on the first run there), parse the
layout, run one warm-up request and freeze what set-up made out of
Python's cyclic collector. Then the traffic mix's loop runs requests for
`--seconds` (loop.py's closed loop: back to back). Once the window has closed, the device memory peak
is read, the program's state is dropped, and the reference estimates on
the first card what the last request should have returned, given what
that request consumed where the mix returns it (`inputs`, loop.py); the
reference kind's own checks, or reference/compare.py's, decide `correct`.
The last line of standard output is the result, its last key the checks
beside their limits, which also close standard error. A run that cannot
be judged (no outputs though no request failed; checks and limits that
disagree; a reference with nothing to judge by) says why on standard
error and prints no result.

With --trace 1 the mix's `trace_requests` more requests run after the
window under torch.profiler, and the result carries the cell's per-layer
metrics (the spans from the window's requests, the rest from the trace),
the device's busy and window seconds, and a breakdown; with --trace 0 it
carries the end-to-end metrics. Every request's digest that the mix
gives must equal the last one's (`answers_differ`).
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

from . import loop, registry
from . import trace as tr
from .reference import compare
from .reference.layout import parse_rects

FOREIGN = ("jax", "jaxlib", "flax", "flatmatch_tpu")
NO_CARD, FOREIGN_IMPORT, NOT_JUDGED = 2, 3, 4


def foreign_modules(names) -> list:
    """The loaded modules whose top-level name is one the benchmark must
    never load (JAX and the JAX package), compared whole."""
    return sorted(n for n in names if n.split(".")[0] in FOREIGN)


def parse_args(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def read_metrics(bench, section, workload, run) -> dict:
    out = {}
    for m in registry.metrics_of(bench, section, workload):
        value = registry.metric(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(correct, attempted, failed, metrics, device, checks,
                breakdown=None) -> str:
    """The result: `checks` comes last, each check's value beside its
    limit."""
    res = dict(correct=bool(correct), attempted=int(attempted),
               failed=int(failed), metrics=metrics, device=device)
    if breakdown is not None:
        res["breakdown"] = breakdown
    res["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return json.dumps(res)


def passed(checks) -> bool:
    return all(v <= lim for _, v, lim in checks)


def main(argv=None, t_start=None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    root = pathlib.Path.cwd()
    bench = registry.load_benchmark(root)
    cell = registry.cell(bench, args.workload)
    config = registry.config(cell["config"])
    mix = registry.traffic(cell["traffic"])
    chips = int(cell["chips"])
    cache = root / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: cell {args.workload} needs {chips} CUDA "
              f"card(s); {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return NO_CARD
    devices = [torch.device("cuda", i) for i in range(chips)]
    return run_cell(args, root, bench, cell, config, mix, devices, t_start)


def run_cell(args, root, bench, cell, config, mix, devices, t_start) -> int:
    """The run after the card check: set-up, window, checks, result."""
    import torch

    from flatmatch_tpu_torch.parallel.mesh import photon_mesh

    cuda = devices[0].type == "cuda"
    if cuda:
        from flatmatch_tpu_torch.utils import cuda_build

        cuda_build.load_library()

    def sync():
        if cuda:
            for d in devices:
                torch.cuda.synchronize(d)

    chips = len(devices)
    layout = parse_rects(pathlib.Path(__file__).parent / config["layout"])
    out_dir = tempfile.mkdtemp(prefix="bench_")
    try:
        target = loop.Target(
            devices, photon_mesh(devices) if chips > 1 else None, out_dir,
            bool(config.get("export", {}).get("tint_extra", False)))
        warm = loop.render_config(config, mix.params, args.seed, chips,
                                  warmup=True)
        rcfg = loop.render_config(config, mix.params, args.seed, chips)
        profiler = None
        if args.trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts):
                mix.request(layout, warm, target)
            profiler = torch.profiler.profile(activities=acts)
        else:
            mix.request(layout, warm, target)
        sync()
        # set-up's objects (torch's modules, the layout) leave the cyclic
        # collector, so that a collection inside the window scans only what
        # the requests made (the configurations' `assumed` list it)
        gc.collect()
        gc.freeze()
        setup_s = time.perf_counter() - t_start
        peak_setup = [torch.cuda.max_memory_allocated(d) if cuda else 0
                      for d in devices]
        if cuda:
            for d in devices:
                torch.cuda.reset_peak_memory_stats(d)
        win = mix.window(layout, rcfg, target, args.seconds)
        peak_window = [torch.cuda.max_memory_allocated(d) if cuda else 0
                       for d in devices]
        outputs = win.pop("last")
        inputs = win.pop("inputs", None)
        if outputs is None and win["failed"] == 0:
            print(f"benchmark: cell {cell['name']}: its traffic mix returned "
                  "no outputs, though no request failed: nothing to judge",
                  file=sys.stderr)
            return NOT_JUDGED
        run = dict(setup_s=setup_s, window_s=win["seconds"],
                   requests=win["requests"], spans=win["spans"],
                   peak_window_bytes=max(peak_window), trace=None,
                   work=None)
        digests = list(win["digests"])
        if profiler is not None:
            n = int(mix.params.get("trace_requests", 2))
            digests += mix.traced(layout, rcfg, target, profiler, n, sync)
            path = pathlib.Path(out_dir) / "trace.json"
            profiler.export_chrome_trace(str(path))
            events = tr.load(path)
            path.unlink()
            run["trace"] = dict(events=events, window=tr.window(events),
                                requests=n, devices=list(range(chips)))
        differ = (sum(d != digests[-1] for d in digests) + win["failed"]
                  if digests else win["failed"])
        del profiler
        sync()
        if cuda:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        if outputs is None:
            checks = [("answers_differ", differ, 0)]
        else:
            name = config["reference"]["kind"]
            kind = registry.reference(name)
            try:
                ref = compare.expected(
                    kind, layout, config["settings"], config["reference"],
                    args.seed, devices[0], inputs)
                run["work"] = ref.get("work")
                checks = compare.judge(
                    kind, layout, outputs, ref, out_dir, target.tint_extra,
                    differ, config["limits"], inputs)
            except compare.CheckError as e:
                print(f"benchmark: cell {cell['name']}, reference kind "
                      f"{name!r}: cannot judge the run: {e}", file=sys.stderr)
                return NOT_JUDGED
        print(f"benchmark: setup_s {setup_s:.3f} window_s "
              f"{win['seconds']:.3f} requests {win['requests']} "
              f"check_s {time.perf_counter() - t_ref:.3f}", file=sys.stderr)
        for k in ("scene", "engine", "export"):
            v = [s[k] for s in win["spans"] if k in s]
            if v:
                print(f"benchmark: {k}_s min {min(v):.4f} median "
                      f"{sorted(v)[len(v) // 2]:.4f} max {max(v):.4f}",
                      file=sys.stderr)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    section = "per_layer" if args.trace else "end_to_end"
    metrics = read_metrics(bench, section, cell["name"], run)
    device = dict(
        platform="gpu" if cuda else "cpu",
        kind=torch.cuda.get_device_name(0) if cuda else "cpu",
        count=chips, memory_peak_bytes=max(peak_setup + peak_window))
    breakdown = None
    if run["trace"] is not None:
        lo, hi = run["trace"]["window"]
        events = run["trace"]["events"]
        device["busy_s"] = sum(tr.busy_s(events, lo, hi, d)
                               for d in range(chips)) / chips
        device["window_s"] = (hi - lo) * 1e-6
        breakdown = dict(device_ops=tr.top_ops(events),
                         idle_gaps=tr.idle_gaps(events, lo, hi, 0))
        print(f"benchmark: card and power limit: {power_limit()}",
              file=sys.stderr)
    foreign = foreign_modules(sys.modules)
    if foreign:
        print(f"benchmark: JAX or the JAX package was loaded: {foreign}",
              file=sys.stderr)
        return FOREIGN_IMPORT
    correct = passed(checks) and win["failed"] == 0
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(result_line(correct, win["requests"], win["failed"], metrics,
                      device, checks, breakdown), flush=True)
    return 0
