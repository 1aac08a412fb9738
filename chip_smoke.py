#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from flatmatch_tpu_torch/csrc and drives the port's
two paths on the card:
- the render: the production kernel against its plain PyTorch version,
  `tests/fixtures/mini.png` through the port's CLI at its defaults, the
  physics against the reference C engine's golden lightmap, and a 4x4
  tiling of mini at full budget (phases 1-6);
- the fit: the diff forward and the replay-backward kernels against their
  plain versions (and the forward against the production kernel at the
  default parameters), the power identity of the gradient, `render
  --dump-raw` then `fit` on mini through the CLI at its defaults, and one
  forward plus backward of the 4x4 tiling (phases 7-11).
Any failure exits non-zero. The line before the card's name lists every
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
KERNELS = {
    name: dict(name=name, route="cuda",
               source=f"flatmatch_tpu_torch/csrc/{src}.cu",
               replaces=f"{TPU_WIDE}:{line}")
    for name, src, line in (
        ("trace_splat_wide_rng_i8", "trace_splat_wide_rng", 1002),
        ("trace_splat_wide_diff_rng_i8", "trace_splat_wide_diff_rng", 1252),
        ("trace_fold_wide_rng", "trace_fold_wide_rng", 1394),
    )
}
# Roofline of the trace kernels (H100 SXM datasheet rates:
# 3.35 TB/s HBM, 67 TFLOP/s float32 outside the tensor cores). Operations
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


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def trace_bound(s, bounces, photons, kernel):
    """Bound of one launch of `kernel` on this run's batch: `bounces`
    traced bounces over all N rects each. Bytes read: the scene table, the
    emitter vector, the albedo row (diff kernels) and g (the fold); written:
    the int32 accumulator (the fold: N + 1 sums)."""
    n = s["aa_c"].fields.shape[1]
    T = s["total_c"]
    fold = kernel == "trace_fold_wide_rng"
    per_bounce = n * OPS_PER_RECT_TEST + OPS_PER_BOUNCE + (
        FOLD_OPS_PER_BOUNCE if fold else 0)
    ops = bounces * per_bounce + photons * OPS_PER_PHOTON
    nbytes = 4 * (13 * n + 16) + 12 * T
    if kernel != "trace_splat_wide_rng_i8":
        nbytes += 4 * n
    if fold:
        nbytes += 4 * (n + 1)
    return bound(nbytes, ops)


def reset_launches():
    from flatmatch_tpu_torch.engines import photon_wide as pw

    for name in KERNELS:
        getattr(pw, name).launches = 0


def read_launches():
    from flatmatch_tpu_torch.engines import photon_wide as pw

    return {name: getattr(pw, name).launches for name in KERNELS}


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


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from flatmatch_tpu_torch import cli
    from flatmatch_tpu_torch.config import DEFAULT_CONFIG
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
    ms7 = cuda_ms(lambda: diff_batch(s, d7, cfg, B, out=acc), 20)
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
    ms8 = cuda_ms(lambda: fold_batch(s, d7, cfg, B), 20)
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

    def fwd_bwd_ms(r, n_rect, n_em, albedo, power):
        """Device ms of one forward and one backward of loss = mean(lm^2),
        timed with CUDA events, and the wall seconds of both."""
        a = torch.full((n_rect,), albedo, device=dev, requires_grad=True)
        p = torch.full((n_em,), power, device=dev, requires_grad=True)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        loss = torch.mean(r(a, p) ** 2)
        ev[1].record()
        loss.backward()
        ev[2].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(bool(torch.isfinite(a.grad).all() & torch.isfinite(p.grad)
                   .all()), "gradient not finite")
        return ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]), wall

    r10 = make_diff_renderer_wide(s["em"], s["scene"].num_texels, cfg.photon,
                                  pack_aa(s["scene"].walls, device=dev))
    fwd10, bwd10, step10 = fwd_bwd_ms(r10, len(s["scene"].walls),
                                      len(s["em"].counts), 0.6, 0.5)
    # steady fit steps (Adam included), and the one-time import that
    # torch.optim's first optimizer pulls in (torch._dynamo), in a fresh
    # interpreter: both are part of the CLI wall above
    with torch.no_grad():
        target10 = r10(torch.full((len(s["scene"].walls),), 0.9, device=dev),
                       torch.ones(len(s["em"].counts), device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit_materials(target10.cpu().numpy(), s["em"], s["scene"].num_texels,
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
    fwd11, bwd11, wall11 = fwd_bwd_ms(r11, rects, len(s6["em"].counts),
                                      cfg.photon.albedo, 1.0)
    b11f = trace_bound(s6, bounces6, B, "trace_splat_wide_diff_rng_i8")
    b11b = trace_bound(s6, bounces6, B, "trace_fold_wide_rng")
    say("apartment_4x4_fit_step", rects=rects, batches_per_pass=len(
        r11.batches), photons=photons6, forward_ms=fwd11, backward_ms=bwd11,
        wall_s=wall11, diff_kernel_ms_per_batch=ms11f,
        fold_kernel_ms_per_batch=ms11b, diff_plain_ms_per_batch=plain11f,
        fold_plain_ms_per_batch=plain11b, diff_bound_ms=b11f[0],
        fold_bound_ms=b11b[0], production_ms_per_batch=ms6)

    print(json.dumps({"kernels": [dict(KERNELS[k], **results[k])
                                  for k in KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
