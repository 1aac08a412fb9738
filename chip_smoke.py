#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernel from flatmatch_tpu_torch/csrc, holds it against its
plain PyTorch version on the card, renders `tests/fixtures/mini.png` through
the port's CLI at its defaults, checks the physics against the reference C
engine's golden lightmap, and renders a 4x4 tiling of mini at full budget.
Any failure exits non-zero. The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It imports no JAX.
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
KERNEL = dict(
    name="trace_splat_wide_rng_i8",
    route="cuda",
    source="flatmatch_tpu_torch/csrc/trace_splat_wide_rng.cu",
    replaces="flatmatch_tpu/engines/photon_pallas_wide.py:1002",
)


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


def plain_stream(s, cfg, B):
    from flatmatch_tpu_torch.engines import photon_wide as pw

    return pw.trace_deposits_rng_plain(
        s["aa_c"].fields, s["aa_c"].group_counts, s["ev"], s["seed"], B, B,
        cfg.photon)


def plain_batch(s, cfg, B):
    import numpy as np

    from flatmatch_tpu_torch.engines import photon_wide as pw

    idx, col = plain_stream(s, cfg, B)
    inv_s = float(np.float32(1.0 / pw.splat_color_scale(cfg.photon)))
    return pw.splat_i8_plain(idx, col, s["total_c"], inv_s)


def traced_bounces(s, cfg, B):
    """Bounces the kernel traces for batch 0: every live bounce plus the
    one that misses, for each photon that dies within max_depth. Each
    traced bounce tests every rect of the scene."""
    _, col = plain_stream(s, cfg, B)
    live = col.sum(-1) > 0
    return int(live.sum().item()) + B - int(live[:, -1].sum().item())


def kernel_batch(s, cfg, B, out=None):
    from flatmatch_tpu_torch.engines import photon_wide as pw

    return pw.trace_splat_wide_rng_i8(
        s["aa_c"].fields, s["aa_c"].group_counts, s["ev"], s["seed"], B, B,
        cfg.photon, s["total_c"], out=out)


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from flatmatch_tpu_torch import cli
    from flatmatch_tpu_torch.config import DEFAULT_CONFIG
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
    # the CLI's defaults: device RNG on, in-kernel 7-bit splat
    cfg = DEFAULT_CONFIG.replace(photon=dataclasses.replace(
        DEFAULT_CONFIG.photon, device_rng=True, splat="inkernel_i8"))
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
    ms = cuda_ms(lambda: kernel_batch(s, cfg, B, out=acc), 20)
    plain_ms = cuda_ms(lambda: plain_batch(s, cfg, B), 3)
    bounces = traced_bounces(s, cfg, B)
    n_rects = s["aa_c"].fields.shape[1]
    say("kernel_vs_plain", scene="mini", batch=B, cells=got.numel(),
        rects=n_rects, traced_bounces_per_photon=bounces / B,
        kernel_rect_tests_per_s=bounces * n_rects / ms * 1e3,
        equal_share=eq_share, energy=e_got, plain_energy=e_want,
        max_abs_err=max_abs_err, kernel_ms=ms, plain_ms=plain_ms,
        kernel_photons_per_s=B / ms * 1e3, plain_photons_per_s=B / plain_ms
        * 1e3)

    # 3. determinism: one emitter's full schedule, twice ----------------------
    sched = [pw.emitter_schedule(s["em"].counts, B)[0]]

    def emitter_render():
        return pw.render_all_wide(s["aa_c"].fields, s["aa_c"].group_counts,
                                  s["em"], cfg.photon, B, sched,
                                  s["total_c"])

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
        pw.trace_splat_wide_rng_i8.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(["render", str(mini), "30", "--out", str(out)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = pw.trace_splat_wide_rng_i8.launches
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
    ours = raw.cpu().numpy()
    gold = np.fromfile(FIXTURES / "mini_photon_native_spa200k.f32",
                       dtype="<f4").reshape(scene.num_texels, 4)[:, :3]
    check(np.isfinite(ours).all(), "raw lightmap not finite")
    e_ratio = float(ours.sum() / gold.sum())
    check(abs(e_ratio - 1) <= 0.02, f"energy ratio {e_ratio}")
    walls = 0
    for i, r in enumerate(scene.walls):
        sl = slice(r.base, r.base + num_tiles(r))
        o, g = ours[sl].mean(), gold[sl].mean()
        if g > gold.sum() / scene.num_texels * 0.1:
            rtol = 0.12 if num_tiles(r) >= 64 else 0.25
            check(abs(o - g) <= rtol * abs(g),
                  f"wall {i} mean {o} vs reference {g} (rtol {rtol})")
            walls += 1
    check(walls >= 5, f"only {walls} walls carried energy")
    corr = float(np.corrcoef(ours.ravel(), gold.ravel())[0, 1])
    check(corr > 0.98, f"texel correlation {corr}")
    say("physics_vs_reference", scene="mini", samples_per_area=spa,
        photons=int(s5["em"].counts.sum()), energy_ratio=e_ratio,
        walls_checked=walls, texel_corr=corr)

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
    say("apartment_4x4", rects=rects, texels=T, compact_texels=Tc,
        photons=photons6, batches=batches6, launches=launches6,
        wall_s=wall6, photons_per_s=photons6 / wall6,
        kernel_ms_per_batch=ms6, kernel_photons_per_s=B / ms6 * 1e3,
        traced_bounces_per_photon=bounces6 / B,
        kernel_rect_tests_per_s=bounces6 * rects / ms6 * 1e3,
        plain_ms_per_batch=plain_ms6,
        plain_photons_per_s=B / plain_ms6 * 1e3)

    print(json.dumps({"kernels": [dict(
        KERNEL, launches=launches, max_abs_err=max_abs_err, ms=ms,
        plain_ms=plain_ms)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
