"""CUDA kernels of flatmatch_tpu_torch against their plain PyTorch versions.

These tests need an NVIDIA GPU (marker `cuda`) and skip without one. They
import neither jax nor the JAX package, so they run on a machine that has
only PyTorch (see README, "PyTorch / H100 port"):

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda.py
"""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from flatmatch_tpu_torch.config import DEFAULT_CONFIG
from flatmatch_tpu_torch.diff import render as prender
from flatmatch_tpu_torch.engines import photon_wide as pw
from flatmatch_tpu_torch.ops import rng
from flatmatch_tpu_torch.ops.aa_scene import pack_aa
from flatmatch_tpu_torch.ops.device_scene import pack_emitters
from flatmatch_tpu_torch.render import compile_scene, run_engine

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
CFG = DEFAULT_CONFIG.replace(photon=dataclasses.replace(
    DEFAULT_CONFIG.photon, device_rng=True, splat="inkernel_i8",
    samples_per_area=3000.0))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(name, dev, emitter=0):
    scene, _ = compile_scene(str(FIXTURES / f"{name}.png"), 30.0, CFG)
    aa_c, total_c, _ = pw.compact_aa(pack_aa(scene.walls, dev),
                                     scene.num_texels)
    ph = CFG.photon
    em = pack_emitters(scene, ph.samples_per_area, ph.window_color,
                       ph.light_color, device=dev)
    return aa_c, total_c, pw.emitter_vector(em, emitter)


@pytest.mark.cuda
@pytest.mark.parametrize("name,n_valid,batch", [
    ("tiny", 1000, 1024),
    ("mini", 131072, 131072),
    ("mini", 4097, 8192),     # a tail batch: the last block is partial
])
def test_kernel_matches_plain(dev, name, n_valid, batch):
    """-fmad=false and the plain version's op order make the integer
    accumulators agree cell for cell; >= 99.9% of cells is the bound."""
    aa_c, total_c, ev = _inputs(name, dev)
    seed = rng.batch_seed(CFG.photon.seed, 5)
    before = pw.trace_splat_wide_rng_i8.launches
    got = pw.trace_splat_wide_rng_i8(aa_c.fields, aa_c.group_counts, ev,
                                     seed, n_valid, batch, CFG.photon,
                                     total_c)
    torch.cuda.synchronize()
    assert pw.trace_splat_wide_rng_i8.launches == before + 1
    idx, col, _ = pw.trace_deposits_rng_plain(
        aa_c.fields, aa_c.group_counts, ev, seed, n_valid, batch, CFG.photon)
    inv_s = float(np.float32(1.0 / pw.splat_color_scale(CFG.photon)))
    want = pw.splat_i8_plain(idx, col, total_c, inv_s)
    assert want.sum().item() > 0
    assert (got == want).float().mean().item() >= 0.999
    np.testing.assert_allclose(got.sum().item(), want.sum().item(),
                               rtol=1e-6)


@pytest.mark.cuda
def test_render_deterministic_and_close_to_plain(dev):
    """Two card renders are bit-identical, and the card render equals the
    CPU render (plain version) within float32 de-scale rounding."""
    scene, _ = compile_scene(str(FIXTURES / "tiny.png"), 30.0, CFG)
    a = run_engine(scene, CFG, dev)
    b = run_engine(scene, CFG, dev)
    np.testing.assert_array_equal(a, b)
    c = run_engine(scene, CFG, "cpu")
    np.testing.assert_allclose(a.sum(), c.sum(), rtol=1e-6)
    assert np.isclose(a, c, rtol=1e-6, atol=0).mean() >= 0.999


@pytest.mark.cuda
def test_wrapper_refuses_mixed_devices(dev):
    aa_c, total_c, ev = _inputs("tiny", dev)
    with pytest.raises(ValueError):
        pw.trace_splat_wide_rng_i8(aa_c.fields, aa_c.group_counts, ev.cpu(),
                                   0, 16, 16, CFG.photon, total_c)
    out = torch.zeros((total_c, 3), dtype=torch.int32)    # on the CPU
    with pytest.raises(ValueError):
        pw.trace_splat_wide_rng_i8(aa_c.fields, aa_c.group_counts, ev, 0, 16,
                                   16, CFG.photon, total_c, out=out)


def _diff_inputs(name, dev, power=1.7):
    """Batch inputs of the diff kernels: albedo per slot from a numpy seed
    (or the default 0.9 when power is 1), the emitter color times power."""
    aa_c, total_c, ev = _inputs(name, dev)
    n = aa_c.fields.shape[1]
    if power == 1.0:
        alb = torch.full((n,), np.float32(CFG.photon.albedo), device=dev)
    else:
        alb = torch.from_numpy(np.random.RandomState(3).uniform(
            0.4, 0.95, n).astype(np.float32)).to(dev)
    ev = ev.clone()
    ev[12:15] = ev[12:15] * power
    _, inv = prender.scale_pair(CFG.photon, torch.tensor(power, device=dev),
                                alb)
    return aa_c, total_c, alb, ev, inv


@pytest.mark.cuda
@pytest.mark.parametrize("name,n_valid,batch", [
    ("tiny", 1000, 1024),
    ("mini", 131072, 131072),
])
def test_diff_kernel_matches_plain(dev, name, n_valid, batch):
    """Per-slot albedo and the run-time grid: >= 99.9% of cells equal."""
    aa_c, total_c, alb, ev, inv = _diff_inputs(name, dev)
    seed = rng.batch_seed(CFG.photon.seed, 2)
    before = pw.trace_splat_wide_diff_rng_i8.launches
    got = pw.trace_splat_wide_diff_rng_i8(
        aa_c.fields, aa_c.group_counts, alb, ev, seed, n_valid, batch,
        CFG.photon, total_c, inv)
    torch.cuda.synchronize()
    assert pw.trace_splat_wide_diff_rng_i8.launches == before + 1
    idx, col, _ = pw.trace_deposits_rng_plain(
        aa_c.fields, aa_c.group_counts, ev, seed, n_valid, batch, CFG.photon,
        alb)
    want = pw.splat_i8_plain(idx, col, total_c, inv.item())
    assert want.sum().item() > 0
    assert (got == want).float().mean().item() >= 0.999


@pytest.mark.cuda
def test_diff_kernel_at_defaults_equals_production(dev):
    aa_c, total_c, alb, ev, inv = _diff_inputs("mini", dev, power=1.0)
    seed = rng.batch_seed(CFG.photon.seed, 4)
    prod = pw.trace_splat_wide_rng_i8(aa_c.fields, aa_c.group_counts, ev,
                                      seed, 131072, 131072, CFG.photon,
                                      total_c)
    diff = pw.trace_splat_wide_diff_rng_i8(
        aa_c.fields, aa_c.group_counts, alb, ev, seed, 131072, 131072,
        CFG.photon, total_c, inv)
    torch.cuda.synchronize()
    assert prod.sum().item() > 0
    assert torch.equal(prod, diff)


@pytest.mark.cuda
@pytest.mark.parametrize("name,n_valid,batch", [
    ("tiny", 1000, 1024),
    ("mini", 131072, 131072),
    ("mini", 4097, 8192),
])
def test_fold_kernel_matches_plain_and_is_deterministic(dev, name, n_valid,
                                                        batch):
    """The fold sums in another order than index_add_: da at rtol 1e-4
    against the plain fold, and two kernel runs bit-identical."""
    aa_c, total_c, alb, ev, _ = _diff_inputs(name, dev)
    g = torch.from_numpy(np.random.RandomState(5).rand(total_c, 3)
                         .astype(np.float32)).to(dev)
    seed = rng.batch_seed(CFG.photon.seed, 6)
    n = aa_c.fields.shape[1]
    before = pw.trace_fold_wide_rng.launches
    runs = [pw.trace_fold_wide_rng(aa_c.fields, aa_c.group_counts, alb, ev,
                                   g, seed, n_valid, batch, CFG.photon, n)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert pw.trace_fold_wide_rng.launches == before + 2
    (da, w_sum), (da2, w_sum2) = runs
    assert torch.equal(da, da2) and torch.equal(w_sum, w_sum2)
    idx, col, ridx = pw.trace_deposits_rng_plain(
        aa_c.fields, aa_c.group_counts, ev, seed, n_valid, batch, CFG.photon,
        alb)
    want, want_w = pw.fold_plain(idx, col, ridx, g, n)
    assert want.abs().sum().item() > 0
    np.testing.assert_allclose(da.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4,
                               atol=1e-6 * want.abs().max().item())
    np.testing.assert_allclose(w_sum.item(), want_w.item(), rtol=1e-4)


@pytest.mark.cuda
def test_diff_renderer_power_identity_and_determinism(dev):
    """On the card: sum_e p_e dL/dp_e == L (every deposit is linear in
    power; slack: the fold's bf16 rounding of g), and two backward passes
    give the same bits."""
    scene, _ = compile_scene(str(FIXTURES / "tiny.png"), 30.0, CFG)
    ph = CFG.photon
    em = pack_emitters(scene, ph.samples_per_area, ph.window_color,
                       ph.light_color, device=dev)
    r = prender.make_diff_renderer_wide(em, scene.num_texels, ph,
                                        pack_aa(scene.walls, dev))
    w = torch.from_numpy(np.random.RandomState(1).rand(scene.num_texels, 3)
                         .astype(np.float32)).to(dev)
    n = len(scene.walls)
    grads = []
    for _ in range(2):
        a = torch.full((n,), 0.8, device=dev, requires_grad=True)
        p = torch.full((len(em.counts),), 1.3, device=dev,
                       requires_grad=True)
        loss = torch.sum(r(a, p) * w)
        loss.backward()
        grads.append((a.grad, p.grad, loss.detach()))
    (ga, gp, loss), (ga2, gp2, _) = grads
    assert torch.equal(ga, ga2) and torch.equal(gp, gp2)
    assert torch.isfinite(ga).all() and ga.abs().sum().item() > 0
    np.testing.assert_allclose((gp * 1.3).sum().item(), loss.item(),
                               rtol=2e-3)


# --------------------------------------------------------------------------
# the nearest-hit kernels of the AO and radiosity engines
# --------------------------------------------------------------------------
def _ff_chunk(name, dev, texels=64, rays=256):
    """One form-factor chunk of `name`'s extended rects: the scene table
    and the rays of wall 0's first `texels` texels."""
    from flatmatch_tpu_torch.engines import ao, radiosity
    from flatmatch_tpu_torch.ops import threefry

    scene, _ = compile_scene(str(FIXTURES / f"{name}.png"), 30.0, CFG)
    rects, _, _, _ = radiosity.extended_rects(scene)
    aa = pack_aa(rects, dev)
    wall = scene.walls[0]
    c = torch.from_numpy(ao.tile_centers(wall)[:texels]).to(dev)
    n = torch.from_numpy(np.asarray(wall.n, np.float32)).to(dev)
    src, direc = radiosity.ff_rays(c, n, threefry.prng_key(5), rays)
    return aa, src, direc


def _ao_rays(name, dev, texels=128):
    """The chunked AO rays of `name`'s first `texels` level-0 texels."""
    from flatmatch_tpu_torch.engines import ao

    scene, _ = compile_scene(str(FIXTURES / f"{name}.png"), 30.0, CFG)
    aa = pack_aa(scene.walls, dev)
    centers, walls, _ = ao._texel_tables(scene)
    k_pad = len(ao.direction_weights(4, 8))
    d = torch.from_numpy(ao._padded_dirs(scene, 4, k_pad)).to(dev)[
        torch.from_numpy(walls[:texels]).long().to(dev)]
    c = torch.from_numpy(centers[:texels]).to(dev)
    origins = (c[:, None, :] + d * ao.NUDGE).reshape(-1, 3)
    return aa, origins, d.reshape(-1, 3).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny", "mini"])
def test_aa_nearest_kernel_matches_plain(dev, name):
    """Same rays, same rect order and -fmad=false: ids and distances agree
    on >= 99.9% of rays (only a last-ulp sin/cos of the rays' making could
    split them, and those are made once, on the card)."""
    from flatmatch_tpu_torch.ops import aa_query

    aa, src, direc = _ff_chunk(name, dev)
    before = aa_query.aa_nearest.launches
    dist, tex = aa_query.aa_nearest(aa.fields, aa.group_counts, src, direc)
    torch.cuda.synchronize()
    assert aa_query.aa_nearest.launches == before + 1
    pdist, ptex = aa_query.aa_nearest_plain(aa.fields, aa.group_counts, src,
                                            direc)
    assert tex.dtype == torch.int32 and dist.dtype == torch.float32
    assert (ptex >= 0).float().mean().item() > 0.9
    assert (tex == ptex).float().mean().item() >= 0.999
    assert (dist == pdist).float().mean().item() >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny", "mini"])
def test_nearest_distances_kernel_matches_plain(dev, name):
    from flatmatch_tpu_torch.ops import aa_query

    aa, origins, dirs = _ao_rays(name, dev)
    before = aa_query.nearest_distances.launches
    got = aa_query.nearest_distances(aa.fields, aa.group_counts, origins,
                                     dirs, 10.0)
    torch.cuda.synchronize()
    assert aa_query.nearest_distances.launches == before + 1
    want = aa_query.nearest_distances_plain(aa.fields, aa.group_counts,
                                            origins, dirs, 10.0)
    assert (want < 10.0).float().mean().item() > 0.5
    assert (got == want).float().mean().item() >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("name,level", [("tiny", 3), ("mini", 4)])
def test_ao_fused_kernel_matches_plain_and_is_deterministic(dev, name,
                                                            level):
    """The kernel sums in the plain version's order: relative error <= 1e-5
    on nonzero texels, the same zeros, and two runs bit-identical."""
    from flatmatch_tpu_torch.config import AoConfig
    from flatmatch_tpu_torch.engines import ao

    scene, _ = compile_scene(str(FIXTURES / f"{name}.png"), 30.0, CFG)
    aa = pack_aa(scene.walls, dev)
    centers, walls, dirs, fac, _, _ = ao._ao_fused_prep(
        scene, AoConfig(geosphere_level=level))
    args = [torch.from_numpy(a).to(dev) for a in (centers, walls, dirs, fac)]
    before = ao.ao_fused.launches
    a = ao.ao_fused(aa.fields, aa.group_counts, *args, 10.0)
    b = ao.ao_fused(aa.fields, aa.group_counts, *args, 10.0)
    torch.cuda.synchronize()
    assert ao.ao_fused.launches == before + 2
    assert torch.equal(a, b)
    want = ao.ao_fused_plain(aa.fields, aa.group_counts, *args, 10.0)
    assert torch.equal(a == 0, want == 0)
    nz = want != 0
    assert nz.float().mean().item() > 0.99
    assert ((a[nz] - want[nz]).abs() / want[nz].abs()).max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("engine,fused", [
    ("ambient_occlusion", True),
    ("ambient_occlusion", False),
    ("radiosity", True),
])
def test_ao_and_radiosity_on_card_close_to_cpu(dev, engine, fused):
    """A whole render of tiny on the card and on the CPU (plain versions),
    and two card renders bit-identical. AO: rtol 1e-5 on every texel.
    Radiosity (64 rays): the card's and the CPU's sin/cos of the ray
    directions may differ in the last ulp, which can move a ray across a
    texel edge and, through the gathers, every texel a little: total
    within 1e-4 and >= 99% of texels within 1e-3."""
    from flatmatch_tpu_torch.config import Engine

    cfg = CFG.replace(engine=Engine(engine))
    cfg = cfg.replace(
        ao=dataclasses.replace(cfg.ao, fused=fused),
        radiosity=dataclasses.replace(cfg.radiosity, rays_per_texel=64))
    scene, _ = compile_scene(str(FIXTURES / "tiny.png"), 30.0, cfg)
    a = run_engine(scene, cfg, dev)
    np.testing.assert_array_equal(a, run_engine(scene, cfg, dev))
    c = run_engine(scene, cfg, "cpu")
    assert np.isfinite(a).all() and a.sum() > 0
    if engine == "radiosity":
        np.testing.assert_allclose(a.sum(), c.sum(), rtol=1e-4)
        assert np.isclose(a, c, rtol=1e-3, atol=1e-6).mean() >= 0.99
    else:
        np.testing.assert_allclose(a, c, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_nearest_hit_wrappers_refuse_bad_inputs(dev):
    from flatmatch_tpu_torch.engines import ao
    from flatmatch_tpu_torch.ops import aa_query

    aa, src, direc = _ff_chunk("tiny", dev, texels=2, rays=8)
    f, gc = aa.fields, aa.group_counts
    for fn in (aa_query.aa_nearest, aa_query.nearest_distances):
        with pytest.raises(ValueError):           # origins on the CPU
            fn(f, gc, src.cpu(), direc)
        with pytest.raises(ValueError):           # float64
            fn(f, gc, src.double(), direc.double())
        with pytest.raises(ValueError):           # [R, 4]
            fn(f, gc, torch.zeros((4, 4), device=dev),
               torch.zeros((4, 4), device=dev))
        with pytest.raises(ValueError):           # shapes differ
            fn(f, gc, src, direc[:-1])
        with pytest.raises(ValueError):           # counts do not sum to N
            fn(f, (1, 1, 1), src, direc)
    c = torch.zeros((4, 3), device=dev)
    w = torch.zeros((4,), dtype=torch.int32, device=dev)
    d = torch.zeros((1, 3, 128), device=dev)
    fac = torch.zeros((128,), device=dev)
    ao.ao_fused(f, gc, c, w, d, fac)              # well-formed: runs
    with pytest.raises(ValueError):               # wall ids int64
        ao.ao_fused(f, gc, c, w.long(), d, fac)
    with pytest.raises(ValueError):               # k_pad not a multiple
        ao.ao_fused(f, gc, c, w, d[:, :, :100], fac[:100])
    with pytest.raises(ValueError):               # fac on the CPU
        ao.ao_fused(f, gc, c, w, d, fac.cpu())
    with pytest.raises(ValueError):               # centers [T, 2]
        ao.ao_fused(f, gc, c[:, :2], w, d, fac)


# --------------------------------------------------------------------------
# the deposit-stream tier: two stream traces and two splats
# --------------------------------------------------------------------------
def _stream_cfg(max_depth=8):
    return dataclasses.replace(CFG.photon, device_rng=False, splat="fused",
                               max_depth=max_depth)


def _stream_inputs(name, dev, batch):
    from flatmatch_tpu_torch.ops import threefry

    aa_c, total_c, ev = _inputs(name, dev)
    u = threefry.batch_uniforms(3, 11, batch, pw.uniforms_per_photon(8), dev,
                                transposed=True)
    return aa_c, total_c, ev, u


def _traces(aa_c, ev, u, n_valid, batch, block=None):
    """Both stream traces of one batch: (name, wrapper call, the plain
    version on the same device)."""
    cfg = _stream_cfg()
    seed = rng.batch_seed(CFG.photon.seed, 5)
    f, gc = aa_c.fields, aa_c.group_counts
    blk = block or pw.stream_block(batch)
    return [
        ("trace_deposits_wide_rng",
         lambda: pw.trace_deposits_wide_rng(f, gc, ev, seed, n_valid, batch,
                                            cfg, block),
         lambda: pw.stream_rows(*pw.trace_deposits_rng_plain(
             f, gc, ev, seed, n_valid, batch, cfg)[:2], blk)),
        ("trace_deposits_wide",
         lambda: pw.trace_deposits_wide(f, gc, ev, u, n_valid, cfg, block),
         lambda: pw.trace_deposits_wide_plain(f, gc, ev, u.t(), n_valid,
                                              cfg, blk)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("name,n_valid,batch,block", [
    ("tiny", 1000, 1024, 512),
    ("mini", 131072, 131072, None),
    ("mini", 4097, 8192, None),   # a tail batch: dead photons write zeros
])
def test_stream_traces_match_plain(dev, name, n_valid, batch, block):
    """-fmad=false and the plain version's op order: every id and color
    of the stream equal to the plain version on the card, rows in the JAX
    order, and two runs identical."""
    aa_c, _, ev, u = _stream_inputs(name, dev, batch)
    for kernel, run, plain in _traces(aa_c, ev, u, n_valid, batch, block):
        wrapper = getattr(pw, kernel)
        before = wrapper.launches
        idx, col = run()
        idx2, col2 = run()
        torch.cuda.synchronize()
        assert wrapper.launches == before + 2
        assert torch.equal(idx, idx2) and torch.equal(col, col2)
        pidx, pcol = plain()
        assert idx.shape == (batch * 8,) and col.shape == (batch * 8, 3)
        assert pcol.sum().item() > 0
        assert torch.equal(idx, pidx), kernel
        assert torch.equal(col, pcol), kernel


@pytest.mark.cuda
def test_stream_traces_on_cpu_tensors_run_the_plain_version(dev):
    from flatmatch_tpu_torch.ops.aa_scene import AARects

    aa_c, _, ev, u = _stream_inputs("tiny", dev, 1024)
    cpu = AARects(fields=aa_c.fields.cpu(), group_counts=aa_c.group_counts,
                  perm=aa_c.perm)
    for kernel, run, plain in _traces(cpu, ev.cpu(), u.cpu(), 1000, 1024,
                                      512):
        wrapper = getattr(pw, kernel)
        before = wrapper.launches
        idx, col = run()
        assert wrapper.launches == before
        pidx, pcol = plain()
        assert idx.device.type == "cpu" and pcol.sum().item() > 0
        assert torch.equal(idx, pidx) and torch.equal(col, pcol)


def _stream_of(name, dev, batch=1024):
    aa_c, total_c, ev, u = _stream_inputs(name, dev, batch)
    idx, col = pw.trace_deposits_wide(aa_c.fields, aa_c.group_counts, ev, u,
                                      batch - 24, _stream_cfg())
    return idx, col, total_c


@pytest.mark.cuda
@pytest.mark.parametrize("name,batch", [("tiny", 1024), ("mini", 131072)])
def test_stream_splats_match_plain(dev, name, batch):
    """fused_splat_i8 exactly; fused_splat (bf16 colors) and its f32 mode
    bit for bit equal to fused_splat_fixed_plain, the kernel's exact
    function, which is within rtol 1e-5 of index_add_'s f32 order (the
    CPU's plain version); two runs identical."""
    from flatmatch_tpu_torch.ops import splat as sp

    idx, col, T = _stream_of(name, dev, batch)
    cfg = _stream_cfg()
    bound = sp.stream_bound(dataclasses.replace(cfg,
                                                photons_per_batch=batch))
    cases = [
        (sp.fused_splat_i8, (sp.splat_color_scale(cfg),),
         lambda: sp.fused_splat_i8_plain(idx.cpu(), col.cpu(), T,
                                         sp.splat_color_scale(cfg)), None),
        (sp.fused_splat, (bound,),
         lambda: sp.fused_splat_plain(idx.cpu(), col.cpu(), T),
         lambda: sp.fused_splat_fixed_plain(idx.cpu(), col.cpu(), T,
                                            bound)),
        (sp.scatter_splat, (bound,),
         lambda: sp.scatter_plain(idx.cpu(), col.cpu(), T),
         lambda: sp.fused_splat_fixed_plain(idx.cpu(), col.cpu(), T, bound,
                                            bf16=False)),
    ]
    for fn, args, plain, exact in cases:
        counter = sp.fused_splat_i8 if fn is sp.fused_splat_i8 \
            else sp.fused_splat
        before = counter.launches
        a, b = fn(idx, col, T, *args), fn(idx, col, T, *args)
        torch.cuda.synchronize()
        assert counter.launches == before + 2
        assert torch.equal(a, b)
        want = plain()
        assert want.sum().item() > 0
        if exact is None:
            assert torch.equal(a.cpu(), want)
        else:
            assert torch.equal(a.cpu(), exact())
            np.testing.assert_allclose(exact().numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-6)
        # a CPU stream takes the plain version and launches nothing
        got = fn(idx.cpu(), col.cpu(), T, *args)
        assert counter.launches == before + 2
        assert got.device.type == "cpu" and torch.equal(got, want)


def _tiled_stream(name, dev, tmp_path):
    """Batch 0's 1M-row stream of mini or of mini tiled k x k at the CLI's
    defaults, its compact texel count and stream bound."""
    import importlib.util

    from flatmatch_tpu_torch.ops import splat as sp

    png = FIXTURES / "mini.png"
    if name != "mini":
        spec = importlib.util.spec_from_file_location(
            "make_layout", FIXTURES / "make_layout.py")
        make_layout = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(make_layout)
        k = int(name.split("x")[0])
        png = tmp_path / f"mini_{name}.png"
        make_layout.tiled(str(FIXTURES / "mini.png"), str(png), k, k)
    cfg = dataclasses.replace(DEFAULT_CONFIG.photon, device_rng=True,
                              splat="fused")
    scene, _ = compile_scene(str(png), 30.0, DEFAULT_CONFIG)
    aa_c, T, _ = pw.compact_aa(pack_aa(scene.walls, dev), scene.num_texels)
    em = pack_emitters(scene, cfg.samples_per_area, cfg.window_color,
                       cfg.light_color, device=dev)
    B = cfg.photons_per_batch
    idx, col = pw.trace_deposits_wide_rng(
        aa_c.fields, aa_c.group_counts, pw.emitter_vector(em, 0),
        rng.batch_seed(cfg.seed, 0), B, B, cfg)
    return idx, col, T, sp.stream_bound(cfg)


def _hold_row16(dev, idx, col, T, bound):
    """Row 16 (bf16 and f32 colors, fused_splat and fused_splat_add) on a
    stream against fused_splat_fixed_plain bit for bit, the device's
    scratch zero after each call, and one launch counted per call."""
    from flatmatch_tpu_torch.ops import splat as sp

    lm0 = torch.from_numpy(np.random.RandomState(16).rand(T, 3).astype(
        np.float32)).to(dev)
    for bf16 in (True, False):
        want = sp.fused_splat_fixed_plain(idx, col, T, bound, bf16)
        before = sp.fused_splat.launches
        got = sp.fused_splat(idx, col, T, bound, bf16)
        assert not bool(sp._fixed_scratch[sp._scratch_key(idx.device)]
                        .any())
        lm = sp.fused_splat_add(lm0.clone(), idx, col, bound, bf16)
        torch.cuda.synchronize()
        assert sp.fused_splat.launches == before + 2
        assert not bool(sp._fixed_scratch[sp._scratch_key(idx.device)]
                        .any())
        assert torch.equal(got, want)
        assert torch.equal(lm, lm0 + want)


@pytest.mark.cuda
@pytest.mark.parametrize("name,accumulator", [
    ("mini", "arena"), ("4x4", "paged"), ("13x13", "paged")])
def test_row16_equals_its_fixed_twin_bit_for_bit(dev, tmp_path, name,
                                                 accumulator):
    """Row 16's kernel on batch 0's 1M-row stream of mini (the whole
    arena in shared memory) and of the 4x4 and 13x13 tilings (the paged
    accumulator) equals fused_splat_fixed_plain bit for bit, in both color
    instances and adding into a lightmap."""
    from flatmatch_tpu_torch.ops import splat as sp

    idx, col, T, bound = _tiled_stream(name, dev, tmp_path)
    assert sp.splat_accumulator(T)[0] == accumulator
    assert idx.shape[0] == 131072 * 8
    _hold_row16(dev, idx, col, T, bound)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [6008, 1 << 20])
def test_row16_on_streams_that_stress_its_accumulators(dev, T):
    """Seeded streams that no render makes: ids spread over the whole
    arena (on 2^20 texels every block meets more pages than it holds, and
    pages that share a directory entry), ids out of range, zero rows,
    signed colors, a stream whose rows are not a multiple of four and one
    that is not 16-byte aligned (the scalar loads), and an empty stream;
    all equal fused_splat_fixed_plain bit for bit."""
    rs = np.random.RandomState(T % 9973)
    R = 300_003
    idx = torch.from_numpy(rs.randint(-3, T + 3, R).astype(np.int32)).to(dev)
    col = rs.uniform(-2.0, 18.0, (R, 3)).astype(np.float32)
    col[rs.rand(R) < 0.2] = 0.0
    col = torch.from_numpy(col).to(dev)
    bound = 18.0 * R
    _hold_row16(dev, idx, col, T, bound)
    _hold_row16(dev, idx[1:], col[1:], T, bound)
    _hold_row16(dev, idx[:0], col[:0], T, bound)


@pytest.mark.cuda
def test_row16_on_two_streams_at_once(dev):
    """Two streams of one device splat at the same time, each on its own
    scratch: every call equals fused_splat_fixed_plain bit for bit and
    both scratches are left zero."""
    from flatmatch_tpu_torch.ops import splat as sp

    T, R = 6008, 1 << 20
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    inputs, outs = [], []
    for seed, s in enumerate(streams):
        rs = np.random.RandomState(seed)
        idx = torch.from_numpy(rs.randint(0, T, R).astype(np.int32)).to(dev)
        col = torch.from_numpy(rs.uniform(0.0, 18.0, (R, 3)).astype(
            np.float32)).to(dev)
        inputs.append((idx, col))
    torch.cuda.synchronize()
    for _ in range(4):
        for s, (idx, col) in zip(streams, inputs):
            with torch.cuda.stream(s):
                outs.append((sp.fused_splat(idx, col, T, 18.0 * R),
                             sp.fused_splat_add(torch.zeros((T, 3),
                                                            device=dev),
                                                idx, col, 18.0 * R)))
    torch.cuda.synchronize()
    keys = {(inputs[0][0].device, s.cuda_stream) for s in streams}
    assert keys <= set(sp._fixed_scratch)
    for k in keys:
        assert not bool(sp._fixed_scratch[k].any())
    for i, (got, lm) in enumerate(outs):
        idx, col = inputs[i % 2]
        want = sp.fused_splat_fixed_plain(idx, col, T, 18.0 * R)
        assert torch.equal(got, want) and torch.equal(lm, want)


@pytest.mark.cuda
def test_accumulator_instance_follows_the_arena_size(dev):
    """The arena instance while 24 T bytes fit in a block's 227 KB of
    shared memory (mini's 6,008 texels), the paged one past that (the 4x4
    tiling's 96,384: the directory and 36 pages)."""
    from flatmatch_tpu_torch.ops import splat as sp

    assert sp.splat_accumulator(6008) == ("arena", 24 * 6008)
    assert sp.splat_accumulator(232448 // 24) == ("arena",
                                                  24 * (232448 // 24))
    inst, smem = sp.splat_accumulator(232448 // 24 + 1)
    assert inst == "paged" and smem <= 232448
    assert sp.splat_accumulator(96384) == ("paged", 229648)


def _hold_row15(dev, idx, col, T, scale):
    """Row 15 (fused_splat_i8, and fused_splat_i8_add into a lightmap) on a
    stream against fused_splat_i8_plain bit for bit, the device's scratch
    zero after each call, and the launches counted: two of row 15's
    kernel, one of them through the adding entry."""
    from flatmatch_tpu_torch.ops import splat as sp

    lm0 = torch.from_numpy(np.random.RandomState(15).rand(T, 3).astype(
        np.float32)).to(dev)
    want = sp.fused_splat_i8_plain(idx, col, T, scale)
    before = (sp.fused_splat_i8.launches, sp.fused_splat_i8_add.launches)
    got = sp.fused_splat_i8(idx, col, T, scale)
    assert not bool(sp._i8_scratch[sp._scratch_key(idx.device)].any())
    lm = sp.fused_splat_i8_add(lm0.clone(), idx, col, scale)
    torch.cuda.synchronize()
    assert (sp.fused_splat_i8.launches, sp.fused_splat_i8_add.launches) \
        == (before[0] + 2, before[1] + 1)
    assert not bool(sp._i8_scratch[sp._scratch_key(idx.device)].any())
    assert torch.equal(got, want)
    assert torch.equal(lm, lm0 + want)


@pytest.mark.cuda
@pytest.mark.parametrize("name,accumulator", [
    ("mini", "arena"), ("4x4", "paged"), ("13x13", "paged")])
def test_row15_equals_its_plain_version_bit_for_bit(dev, tmp_path, name,
                                                    accumulator):
    """Row 15's kernel on batch 0's 1M-row stream of mini (the whole int32
    arena in shared memory) and of the 4x4 and 13x13 tilings (the paged
    accumulator) equals fused_splat_i8_plain bit for bit, writing the
    increment and adding into a lightmap."""
    from flatmatch_tpu_torch.ops import splat as sp

    idx, col, T, _ = _tiled_stream(name, dev, tmp_path)
    assert sp.splat_accumulator(T, i8=True)[0] == accumulator
    scale = sp.splat_color_scale(DEFAULT_CONFIG.photon)
    _hold_row15(dev, idx, col, T, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [6008, 19370, 1 << 20])
def test_row15_on_streams_that_stress_its_accumulators(dev, T):
    """Seeded streams that no render makes: ids spread over the whole
    arena (on 2^20 texels every block meets more pages than it holds, so
    rows are refused to device memory, and pages share directory entries;
    19,370 texels is the largest int32 arena), ids out of range, zero rows,
    colors past the grid's ends, a stream whose rows are not a multiple of
    four, one that is not 16-byte aligned (the scalar loads, keyed by their
    own rows) and an empty stream; all equal fused_splat_i8_plain bit for
    bit."""
    rs = np.random.RandomState(T % 9973)
    R = 300_003
    scale = 18.0 / 127.0
    idx = torch.from_numpy(rs.randint(-3, T + 3, R).astype(np.int32)).to(dev)
    col = rs.uniform(-0.5, 18.5, (R, 3)).astype(np.float32)
    col[rs.rand(R) < 0.2] = 0.0
    col = torch.from_numpy(col).to(dev)
    _hold_row15(dev, idx, col, T, scale)
    _hold_row15(dev, idx[1:], col[1:], T, scale)
    _hold_row15(dev, idx[:0], col[:0], T, scale)


@pytest.mark.cuda
def test_row15_accumulator_instance_follows_the_arena_size(dev):
    """The int32 arena while 12 T bytes fit in a block's 227 KB of shared
    memory (up to 19,370 texels: mini's 6,008 take 72 KB), the paged one
    past that (the 4x4 tiling's 96,384: the directory and 64 pages of 256
    int32 texels)."""
    from flatmatch_tpu_torch.ops import splat as sp

    assert sp.splat_accumulator(6008, i8=True) == ("arena", 12 * 6008)
    assert sp.splat_accumulator(19370, i8=True) == ("arena", 12 * 19370)
    inst, smem = sp.splat_accumulator(19371, i8=True)
    assert inst == "paged" and smem <= 232448
    assert sp.splat_accumulator(96384, i8=True) == ("paged",
                                                    8464 + 64 * 3072)
    assert sp.splat_accumulator(96384) == ("paged", 229648)


@pytest.mark.cuda
def test_fused_splat_i8_add_raises_on_a_failed_launch(dev, monkeypatch):
    """A CUDA error from fm_fused_splat_i8_add raises; no launch is
    counted, the lightmap is not touched by a fallback, and the scratch is
    dropped (the next call makes a zeroed one)."""
    from flatmatch_tpu_torch.ops import splat as sp
    from flatmatch_tpu_torch.utils import cuda_build

    idx = torch.zeros(16, dtype=torch.int32, device=dev)
    col = torch.ones((16, 3), device=dev)
    lm = torch.zeros((4, 3), device=dev)
    sp.fused_splat_i8_add(lm, idx, col, 0.1)
    assert sp._scratch_key(idx.device) in sp._i8_scratch
    kept = lm.clone()
    cuda_build.load_library()
    monkeypatch.setattr(cuda_build, "_lib", _FailingLibrary())
    before = (sp.fused_splat_i8.launches, sp.fused_splat_i8_add.launches)
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        sp.fused_splat_i8_add(lm, idx, col, 0.1)
    assert (sp.fused_splat_i8.launches,
            sp.fused_splat_i8_add.launches) == before
    assert sp._scratch_key(idx.device) not in sp._i8_scratch
    assert torch.equal(lm, kept) and lm.sum().item() > 0


@pytest.mark.cuda
def test_stream_wrappers_refuse_bad_inputs(dev):
    from flatmatch_tpu_torch.ops import splat as sp

    aa_c, total_c, ev, u = _stream_inputs("tiny", dev, 256)
    f, gc, cfg = aa_c.fields, aa_c.group_counts, _stream_cfg()
    with pytest.raises(ValueError):             # emitter vector on the CPU
        pw.trace_deposits_wide_rng(f, gc, ev.cpu(), 0, 8, 256, cfg)
    with pytest.raises(ValueError):             # uniforms on the CPU
        pw.trace_deposits_wide(f, gc, ev, u.cpu(), 8, cfg)
    with pytest.raises(ValueError):             # float64 uniforms
        pw.trace_deposits_wide(f, gc, ev, u.double(), 8, cfg)
    with pytest.raises(ValueError):             # [U, B], not contiguous
        pw.trace_deposits_wide(f, gc, ev, u.t().contiguous().t(), 8, cfg)
    with pytest.raises(ValueError):             # [B, U]
        pw.trace_deposits_wide(f, gc, ev, u.t().contiguous(), 8, cfg)
    with pytest.raises(ValueError):             # U of another depth
        pw.trace_deposits_wide(f, gc, ev, u, 8, _stream_cfg(max_depth=6))
    with pytest.raises(ValueError):             # block does not divide
        pw.trace_deposits_wide_rng(f, gc, ev, 0, 8, 256, cfg, block=96)
    idx = torch.zeros(16, dtype=torch.int32, device=dev)
    col = torch.zeros((16, 3), device=dev)
    for bad in ((idx.cpu(), col), (idx.long(), col), (idx, col.double()),
                (idx[:15], col), (idx, col.t().contiguous().t())):
        with pytest.raises(ValueError):
            sp.fused_splat(*bad, total_c, 100.0)
        with pytest.raises(ValueError):
            sp.fused_splat_i8(*bad, total_c, 0.1)
        with pytest.raises(ValueError):
            sp.fused_splat_add(torch.zeros((total_c, 3), device=dev), *bad,
                               100.0)
        with pytest.raises(ValueError):
            sp.fused_splat_i8_add(torch.zeros((total_c, 3), device=dev),
                                  *bad, 0.1)
    for lm in (torch.zeros((total_c, 3)), torch.zeros((total_c, 3),
                                                      device=dev).double(),
               torch.zeros((3, total_c), device=dev).t()):
        with pytest.raises(ValueError):
            sp.fused_splat_add(lm, idx, col, 100.0)
        with pytest.raises(ValueError):
            sp.fused_splat_i8_add(lm, idx, col, 0.1)


class _FailingLibrary:
    """Stands in for the kernel library: every entry point returns CUDA
    error 9 (cudaErrorInvalidConfiguration) without launching."""

    def __getattr__(self, name):
        return lambda *args: 9


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["trace_deposits_wide_rng",
                                    "trace_deposits_wide", "fused_splat_i8",
                                    "fused_splat"])
def test_stream_wrappers_raise_on_a_failed_launch(dev, kernel, monkeypatch):
    """A CUDA error from the entry point raises; nothing falls back to the
    plain version and no launch is counted."""
    from flatmatch_tpu_torch.ops import splat as sp
    from flatmatch_tpu_torch.utils import cuda_build

    aa_c, total_c, ev, u = _stream_inputs("tiny", dev, 256)
    f, gc, cfg = aa_c.fields, aa_c.group_counts, _stream_cfg()
    idx = torch.zeros(16, dtype=torch.int32, device=dev)
    col = torch.ones((16, 3), device=dev)
    calls = {
        "trace_deposits_wide_rng": (pw, lambda: pw.trace_deposits_wide_rng(
            f, gc, ev, 0, 256, 256, cfg)),
        "trace_deposits_wide": (pw, lambda: pw.trace_deposits_wide(
            f, gc, ev, u, 256, cfg)),
        "fused_splat_i8": (sp, lambda: sp.fused_splat_i8(idx, col, total_c,
                                                         0.1)),
        "fused_splat": (sp, lambda: sp.fused_splat(idx, col, total_c,
                                                   100.0)),
    }
    mod, call = calls[kernel]
    cuda_build.load_library()
    monkeypatch.setattr(cuda_build, "_lib", _FailingLibrary())
    before = getattr(mod, kernel).launches
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        call()
    assert getattr(mod, kernel).launches == before


@pytest.mark.cuda
def test_fused_splat_add_raises_on_a_failed_launch(dev, monkeypatch):
    """A CUDA error from fm_fused_splat_add raises; no launch is counted,
    the lightmap is not touched by a fallback, and the scratch, which the
    failed call may have left dirty, is dropped (the next call makes a
    zeroed one)."""
    from flatmatch_tpu_torch.ops import splat as sp
    from flatmatch_tpu_torch.utils import cuda_build

    idx = torch.zeros(16, dtype=torch.int32, device=dev)
    col = torch.ones((16, 3), device=dev)
    lm = torch.zeros((4, 3), device=dev)
    sp.fused_splat_add(lm, idx, col, 100.0)
    assert sp._scratch_key(idx.device) in sp._fixed_scratch
    cuda_build.load_library()
    monkeypatch.setattr(cuda_build, "_lib", _FailingLibrary())
    before = sp.fused_splat.launches
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        sp.fused_splat_add(lm, idx, col, 100.0)
    assert sp.fused_splat.launches == before
    assert sp._scratch_key(idx.device) not in sp._fixed_scratch


@pytest.mark.cuda
def test_stream_trace_launch_refused_for_its_shared_memory(dev):
    """A scene table past a block's shared memory (5,200 rects, 270 KB) is
    no longer refused: the stream trace reads it from device memory and
    equals its plain version on every row, and, since each rect's copies
    follow it and a copy never wins the strict-< tie, the stream of tiny's
    own 13-rect table (its shared-memory instance)."""
    aa_c, _, ev, u = _stream_inputs("tiny", dev, 256)
    big, gc = _big_table(aa_c, 400)
    assert 4 * 13 * big.shape[1] > 232448
    cfg = _stream_cfg()
    idx, col = pw.trace_deposits_wide(big, gc, ev, u, 200, cfg)
    pidx, pcol = pw.trace_deposits_wide_plain(big, gc, ev, u.t(), 200, cfg,
                                              pw.stream_block(256))
    assert pcol.sum().item() > 0
    assert torch.equal(idx, pidx) and torch.equal(col, pcol)
    sidx, scol = pw.trace_deposits_wide(aa_c.fields, aa_c.group_counts, ev,
                                        u, 200, cfg)
    assert torch.equal(idx, sidx) and torch.equal(col, scol)


def _big_table(aa_c, k):
    """The compact table with every rect repeated k times in place (group
    by group): the same scene, k times the rects."""
    f, start, cols = aa_c.fields, 0, []
    for c in aa_c.group_counts:
        cols.append(f[:, start:start + c].repeat_interleave(k, dim=1))
        start += c
    return (torch.cat(cols, 1).contiguous(),
            tuple(k * int(c) for c in aa_c.group_counts))


# --------------------------------------------------------------------------
# the in-kernel tiers: trace_splat_wide.cu (three entry points) and the f32
# tier of the diff forward
# --------------------------------------------------------------------------
INKERNEL = ("trace_splat_wide_rng_f32", "trace_splat_wide_i8",
            "trace_splat_wide_f32", "trace_splat_wide_diff_rng_f32")


def _inkernel_calls(name, dev, n_valid, batch, power=1.7):
    """Each in-kernel kernel of one batch: name -> (wrapper call, its plain
    version on the same device)."""
    aa_c, T, alb, ev, _ = _diff_inputs(name, dev, power)
    _, _, ev0 = _inputs(name, dev)
    u = _stream_inputs(name, dev, batch)[3]
    cfg = CFG.photon
    seed = rng.batch_seed(cfg.seed, 5)
    f, gc = aa_c.fields, aa_c.group_counts
    fixed = prender.fixed_pair(cfg, torch.tensor([power], device=dev), alb,
                               cfg.photons_per_batch)
    return {
        "trace_splat_wide_rng_f32": (
            lambda: pw.trace_splat_wide_rng_f32(f, gc, ev0, seed, n_valid,
                                                batch, cfg, T),
            lambda: pw.trace_splat_wide_rng_f32_plain(f, gc, ev0, seed,
                                                      n_valid, batch, cfg, T)),
        "trace_splat_wide_i8": (
            lambda: pw.trace_splat_wide_i8(f, gc, ev0, u, n_valid, cfg, T),
            lambda: pw.trace_splat_wide_plain(f, gc, ev0, u.t(), n_valid,
                                              cfg, T, True)),
        "trace_splat_wide_f32": (
            lambda: pw.trace_splat_wide_f32(f, gc, ev0, u, n_valid, cfg, T),
            lambda: pw.trace_splat_wide_plain(f, gc, ev0, u.t(), n_valid,
                                              cfg, T, False)),
        "trace_splat_wide_diff_rng_f32": (
            lambda: pw.trace_splat_wide_diff_rng_f32(
                f, gc, alb, ev, seed, n_valid, batch, cfg, T, fixed),
            lambda: pw.trace_splat_wide_rng_f32_plain(
                f, gc, ev, seed, n_valid, batch, cfg, T, alb)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name,n_valid,batch", [
    ("tiny", 1000, 1024),
    ("mini", 131072, 131072),
    ("mini", 4097, 8192),     # a tail batch
])
def test_inkernel_kernels_match_plain(dev, name, n_valid, batch):
    """The 7-bit kernel equals its plain version on every int32 cell; the
    f32 kernels lie within rtol 1e-5 of index_add_'s f32 order; two runs
    of each give the same bits (no float atomics)."""
    for kernel, (run, plain) in _inkernel_calls(name, dev, n_valid,
                                                batch).items():
        wrapper = getattr(pw, kernel)
        before = wrapper.launches
        a, b = run(), run()
        torch.cuda.synchronize()
        assert wrapper.launches == before + 2, kernel
        assert torch.equal(a, b), kernel
        want = plain()
        assert want.sum().item() > 0, kernel
        if kernel == "trace_splat_wide_i8":
            assert a.dtype == torch.int32 and torch.equal(a, want), kernel
        else:
            np.testing.assert_allclose(a.cpu().numpy(), want.cpu().numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=kernel)


@pytest.mark.cuda
@pytest.mark.parametrize("name,n_valid,batch", [
    ("tiny", 1000, 1024),
    ("mini", 131072, 131072),
])
def test_inkernel_f32_equals_the_stream_route(dev, name, n_valid, batch):
    """The in-kernel f32 sums add the integers the stream route's
    fused_splat adds at the same 2^k: both draw sources equal trace +
    fused_splat bit for bit, and the diff forward at the scalar albedo and
    power 1 equals the counter-hash kernel bit for bit."""
    from flatmatch_tpu_torch.ops import splat as sp

    calls = _inkernel_calls(name, dev, n_valid, batch, power=1.0)
    aa_c, T, ev = _inputs(name, dev)
    u = _stream_inputs(name, dev, batch)[3]
    cfg = CFG.photon            # the kernels' fixed-point scale
    f, gc = aa_c.fields, aa_c.group_counts
    seed = rng.batch_seed(cfg.seed, 5)
    bound = sp.stream_bound(cfg)
    stream = {
        "trace_splat_wide_rng_f32": pw.trace_deposits_wide_rng(
            f, gc, ev, seed, n_valid, batch, cfg),
        "trace_splat_wide_f32": pw.trace_deposits_wide(f, gc, ev, u, n_valid,
                                                       cfg),
    }
    for kernel, (idx, col) in stream.items():
        got = calls[kernel][0]()
        want = sp.fused_splat(idx, col, T, bound)
        torch.cuda.synchronize()
        assert want.sum().item() > 0
        assert torch.equal(got, want), kernel
    assert torch.equal(calls["trace_splat_wide_diff_rng_f32"][0](),
                       calls["trace_splat_wide_rng_f32"][0]())


@pytest.mark.cuda
@pytest.mark.parametrize("device_rng,splat", [
    (True, "inkernel"), (False, "inkernel_i8"), (False, "inkernel"),
])
def test_inkernel_routes_on_card_close_to_cpu(dev, device_rng, splat):
    """A whole render of tiny on the card and on the CPU: two card renders
    bit-identical; the 7-bit route within the de-scale's f32 rounding of
    the CPU's, the f32 routes within rtol 1e-5 (another f32 order)."""
    cfg = CFG.replace(photon=dataclasses.replace(
        CFG.photon, photons_per_batch=1024, device_rng=device_rng,
        splat=splat))
    scene, _ = compile_scene(str(FIXTURES / "tiny.png"), 30.0, cfg)
    a = run_engine(scene, cfg, dev)
    np.testing.assert_array_equal(a, run_engine(scene, cfg, dev))
    c = run_engine(scene, cfg, "cpu")
    assert np.isfinite(a).all() and a.sum() > 0
    np.testing.assert_allclose(a.sum(), c.sum(), rtol=1e-5)
    assert np.isclose(a, c, rtol=1e-5, atol=1e-6).mean() >= 0.999


@pytest.mark.cuda
def test_diff_renderer_f32_tier_on_card(dev):
    """`fit --splat inkernel` on the card: the forward runs the f32 diff
    kernel, the gradients equal the 7-bit tier's bit for bit (one fold for
    both) and two passes give the same bits."""
    scene, _ = compile_scene(str(FIXTURES / "tiny.png"), 30.0, CFG)
    ph = CFG.photon
    em = pack_emitters(scene, ph.samples_per_area, ph.window_color,
                       ph.light_color, device=dev)
    w = torch.from_numpy(np.random.RandomState(1).rand(scene.num_texels, 3)
                         .astype(np.float32)).to(dev)
    n = len(scene.walls)
    grads = {}
    for splat in ("inkernel", "inkernel", "inkernel_i8"):
        r = prender.make_diff_renderer_wide(
            em, scene.num_texels, dataclasses.replace(ph, splat=splat),
            pack_aa(scene.walls, dev))
        before = pw.trace_splat_wide_diff_rng_f32.launches
        a = torch.full((n,), 0.8, device=dev, requires_grad=True)
        p = torch.full((len(em.counts),), 1.3, device=dev,
                       requires_grad=True)
        lm = r(a, p)
        torch.sum(lm * w).backward()
        launched = pw.trace_splat_wide_diff_rng_f32.launches - before
        assert launched == (len(r.batches) if splat == "inkernel" else 0)
        grads.setdefault(splat, []).append((lm.detach(), a.grad, p.grad))
    (l1, ga1, gp1), (l2, ga2, gp2) = grads["inkernel"]
    _, ga8, gp8 = grads["inkernel_i8"][0]
    assert torch.equal(l1, l2) and l1.sum().item() > 0
    assert torch.equal(ga1, ga2) and torch.equal(gp1, gp2)
    assert torch.equal(ga1, ga8) and torch.equal(gp1, gp8)


@pytest.mark.cuda
def test_inkernel_wrappers_refuse_bad_inputs(dev):
    aa_c, T, alb, ev, _ = _diff_inputs("tiny", dev)
    u = _stream_inputs("tiny", dev, 256)[3]
    f, gc, cfg = aa_c.fields, aa_c.group_counts, CFG.photon
    fixed = torch.ones(2, device=dev)
    for fn in (pw.trace_splat_wide_i8, pw.trace_splat_wide_f32):
        with pytest.raises(ValueError):           # uniforms on the CPU
            fn(f, gc, ev, u.cpu(), 8, cfg, T)
        with pytest.raises(ValueError):           # [U, B], not contiguous
            fn(f, gc, ev, u.t().contiguous().t(), 8, cfg, T)
    with pytest.raises(ValueError):               # emitter vector on the CPU
        pw.trace_splat_wide_rng_f32(f, gc, ev.cpu(), 0, 8, 256, cfg, T)
    with pytest.raises(ValueError):               # the scale on the CPU
        pw.trace_splat_wide_diff_rng_f32(f, gc, alb, ev, 0, 8, 256, cfg, T,
                                         fixed.cpu())
    with pytest.raises(ValueError):               # int32 accumulator on CPU
        pw.trace_splat_wide_i8(f, gc, ev, u, 8, cfg, T,
                               out=torch.zeros((T, 3), dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", INKERNEL)
def test_inkernel_wrappers_raise_on_a_failed_launch(dev, kernel,
                                                    monkeypatch):
    """A CUDA error from the entry point raises; nothing falls back to the
    plain version and no launch is counted."""
    from flatmatch_tpu_torch.utils import cuda_build

    run, _ = _inkernel_calls("tiny", dev, 200, 256)[kernel]
    cuda_build.load_library()
    monkeypatch.setattr(cuda_build, "_lib", _FailingLibrary())
    before = getattr(pw, kernel).launches
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        run()
    assert getattr(pw, kernel).launches == before


# --------------------------------------------------------------------------
# the threefry kernel, the diff stream (row 6), the uniforms-in diff forward
# (row 7) and fold (row 9), the stream tier's fold, and the kernels past the
# old shared-memory cap
# --------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", [(131072, 28), (1000, 7), (3, 1)])
def test_threefry_kernel_matches_plain(dev, rows, cols):
    """Bit for bit, in both layouts, and a draw cut to its first rows is
    the first rows of the full draw."""
    from flatmatch_tpu_torch.ops import threefry

    key = threefry.fold_in(threefry.prng_key(7), 472)
    before = threefry.uniform.launches
    flat = threefry.uniform(key, (rows, cols), dev)
    tr = threefry.uniform(key, (rows, cols), dev, transposed=True)
    torch.cuda.synchronize()
    assert threefry.uniform.launches == before + 2
    want = threefry.uniform_plain(key, (rows, cols))
    assert torch.equal(flat.cpu(), want)
    assert tr.shape == (cols, rows) and torch.equal(tr.cpu(), want.t())
    assert torch.equal(threefry.uniform(key, (rows // 2 + 1, cols), dev),
                       flat[:rows // 2 + 1])
    # radiosity's [C, rays, 2] draw of one chunk key
    k2 = threefry.fold_in(threefry.fold_in(threefry.prng_key(3), 5), 2)
    assert torch.equal(threefry.uniform(k2, (64, 100, 2), dev).cpu(),
                       threefry.uniform_plain(k2, (64, 100, 2)))


def _plain_at(key, index):
    """uniform_plain's function at the flat indices `index` (int64): the
    same threefry2x32 bits and conversion, for draws too large to make in
    full on the host."""
    from flatmatch_tpu_torch.ops import threefry

    b0, b1 = threefry.threefry2x32(key, index >> 32,
                                   index & threefry.MASK32)
    return ((b0 ^ b1) >> 9).to(torch.float32) * 2.0 ** -23


@pytest.mark.cuda
def test_threefry_kernel_past_2_32_elements(dev):
    """The flat draw past 2^32 elements (the counter's high word set; a
    launch for each 2^31 elements) and the largest transposed draw the
    wrapper takes (just under 2^31 elements), against uniform_plain's
    function at the same indices, bit for bit, at both ends and across
    each 2^31 and 2^32 seam."""
    from flatmatch_tpu_torch.ops import threefry

    key = threefry.fold_in(threefry.prng_key(11), 3)
    free, _ = torch.cuda.mem_get_info()
    n = (1 << 32) + 4096
    if free < 4 * n + (1 << 30):
        pytest.skip(f"the draw needs {4 * n} bytes, {free} free")
    flat = threefry.uniform(key, (n,), dev)
    for lo, hi in ((0, 4096), ((1 << 31) - 2048, (1 << 31) + 2048),
                   ((1 << 32) - 2048, n)):
        index = torch.arange(lo, hi, dtype=torch.int64, device=dev)
        assert torch.equal(flat[lo:hi], _plain_at(key, index)), (lo, hi)
    del flat
    torch.cuda.empty_cache()
    cols = 28
    rows = ((1 << 31) - 1) // cols
    tr = threefry.uniform(key, (rows, cols), dev, transposed=True)
    assert tr.shape == (cols, rows)
    for lo, hi in ((0, 4096), (rows - 4096, rows)):
        p = torch.arange(lo, hi, dtype=torch.int64, device=dev)
        c = torch.arange(cols, dtype=torch.int64, device=dev)
        want = _plain_at(key, p[None, :] * cols + c[:, None])
        assert torch.equal(tr[:, lo:hi], want), (lo, hi)


def _diff_uniform_calls(name, dev, n_valid, batch, power=1.7):
    """Rows 6, 7 (i8, f32) and 9 on one batch of threefry uniforms: name ->
    (wrapper call, its plain version on the same device)."""
    from flatmatch_tpu_torch.ops import threefry

    aa_c, T, alb, ev, inv = _diff_inputs(name, dev, power)
    f, gc, cfg = aa_c.fields, aa_c.group_counts, CFG.photon
    u = threefry.batch_uniforms(cfg.seed, 9, batch, 28, dev,
                                transposed=True)
    fixed = prender.fixed_pair(cfg, torch.tensor([power], device=dev), alb,
                               batch)
    g = torch.from_numpy(np.random.RandomState(5).rand(T, 3)
                         .astype(np.float32)).to(dev)
    n = f.shape[1]
    block = prender.diff_block(batch)
    plain = pw.trace_uniforms_plain(f, gc, ev, u.t(), n_valid, cfg, alb)
    return {
        "trace_deposits_wide_diff": (
            lambda: pw.trace_deposits_wide_diff(f, gc, alb, ev, u, n_valid,
                                                cfg, block),
            lambda: pw.stream_rows(plain[0], plain[1], block, plain[2])),
        "trace_splat_wide_diff_i8": (
            lambda: pw.trace_splat_wide_diff_i8(f, gc, alb, ev, u, n_valid,
                                                cfg, T, inv),
            lambda: pw.splat_i8_plain(plain[0], plain[1], T, inv.item())),
        "trace_splat_wide_diff_f32": (
            lambda: pw.trace_splat_wide_diff_f32(f, gc, alb, ev, u, n_valid,
                                                 cfg, T, fixed),
            lambda: pw.splat_f32_plain(plain[0], plain[1], T)),
        "trace_fold_wide": (
            lambda: pw.trace_fold_wide(f, gc, alb, ev, g, u, n_valid, cfg, n),
            lambda: pw.fold_plain(*plain, g, n)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name,n_valid,batch", [
    ("tiny", 1000, 1024),
    ("mini", 131072, 131072),
    ("mini", 4097, 8192),     # a tail batch
])
def test_diff_uniform_kernels_match_plain(dev, name, n_valid, batch):
    """Row 6 equals its plain stream on every row; row 7's 7-bit
    accumulator on every cell, its f32 increment within rtol 1e-5 (another
    f32 order); row 9 within rtol 1e-4. Rows 7 f32 and 9 give the same bits
    twice (no float atomics)."""
    for kernel, (run, plain) in _diff_uniform_calls(name, dev, n_valid,
                                                    batch).items():
        wrapper = getattr(pw, kernel)
        before = wrapper.launches
        a, b = run(), run()
        torch.cuda.synchronize()
        assert wrapper.launches == before + 2, kernel
        want = plain()
        if kernel == "trace_deposits_wide_diff":
            assert all(torch.equal(x, y) for x, y in zip(a, b))
            assert want[1].sum().item() > 0 and (want[2] >= 0).any()
            for x, y in zip(a, want):
                assert torch.equal(x, y), kernel
        elif kernel == "trace_fold_wide":
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            assert want[0].abs().sum().item() > 0
            np.testing.assert_allclose(
                a[0].cpu().numpy(), want[0].cpu().numpy(), rtol=1e-4,
                atol=1e-6 * want[0].abs().max().item())
            np.testing.assert_allclose(a[1].item(), want[1].item(),
                                       rtol=1e-4)
        else:
            assert torch.equal(a, b), kernel
            assert want.sum().item() > 0
            if kernel.endswith("_i8"):
                assert torch.equal(a, want), kernel
            else:
                np.testing.assert_allclose(a.cpu().numpy(),
                                           want.cpu().numpy(), rtol=1e-5,
                                           atol=1e-5)


@pytest.mark.cuda
def test_diff_uniform_kernels_at_defaults_equal_production(dev):
    """At albedo 0.9 and power 1: row 7 i8 equals trace_splat_wide_i8 bit
    for bit, row 7 f32 equals trace_splat_wide_f32, and row 6's (idx, col)
    equals trace_deposits_wide's stream at the same block."""
    calls = _diff_uniform_calls("mini", dev, 131072, 131072, power=1.0)
    aa_c, T, ev = _inputs("mini", dev)
    from flatmatch_tpu_torch.ops import threefry

    cfg = CFG.photon
    u = threefry.batch_uniforms(cfg.seed, 9, 131072, 28, dev,
                                transposed=True)
    f, gc = aa_c.fields, aa_c.group_counts
    assert torch.equal(calls["trace_splat_wide_diff_i8"][0](),
                       pw.trace_splat_wide_i8(f, gc, ev, u, 131072, cfg, T))
    assert torch.equal(calls["trace_splat_wide_diff_f32"][0](),
                       pw.trace_splat_wide_f32(f, gc, ev, u, 131072, cfg, T))
    idx, col, _ = calls["trace_deposits_wide_diff"][0]()
    sidx, scol = pw.trace_deposits_wide(f, gc, ev, u, 131072, cfg,
                                        prender.diff_block(131072))
    assert torch.equal(idx, sidx) and torch.equal(col, scol)


@pytest.mark.cuda
@pytest.mark.parametrize("splat", ["inkernel_i8", "inkernel", "scatter",
                                   "bucket"])
def test_threefry_diff_renderer_on_card(dev, splat):
    """The threefry and stream tiers of the diff renderer on the card: two
    passes give the same bits (row 9 and the stream tier's fold are fixed-
    order sums), the lightmap is close to the CPU's and the gradients
    within rtol 1e-4 of them."""
    scene, _ = compile_scene(str(FIXTURES / "tiny.png"), 30.0, CFG)
    ph = dataclasses.replace(CFG.photon, splat=splat, device_rng=False,
                             photons_per_batch=4096)
    w = np.random.RandomState(1).rand(scene.num_texels, 3).astype(np.float32)
    runs = {}
    for where in (dev, "cpu", dev):
        em = pack_emitters(scene, ph.samples_per_area, ph.window_color,
                           ph.light_color, device=where)
        r = prender.make_diff_renderer_wide(em, scene.num_texels, ph,
                                            pack_aa(scene.walls, where))
        a = torch.full((len(scene.walls),), 0.8, device=where,
                       requires_grad=True)
        p = torch.full((len(em.counts),), 1.3, device=where,
                       requires_grad=True)
        lm = r(a, p)
        torch.sum(lm * torch.from_numpy(w).to(where)).backward()
        runs.setdefault(str(where), []).append(
            (lm.detach().cpu(), a.grad.cpu(), p.grad.cpu()))
    (l1, ga1, gp1), (l2, ga2, gp2) = runs[str(dev)]
    (lc, gac, gpc), = runs["cpu"]
    assert torch.equal(l1, l2) and torch.equal(ga1, ga2)
    assert torch.equal(gp1, gp2) and l1.sum().item() > 0
    np.testing.assert_allclose(l1.sum().item(), lc.sum().item(), rtol=1e-5)
    np.testing.assert_allclose(ga1.numpy(), gac.numpy(), rtol=1e-4,
                               atol=1e-6 * gac.abs().max().item())
    np.testing.assert_allclose(gp1.numpy(), gpc.numpy(), rtol=1e-4)


@pytest.mark.cuda
def test_stream_tier_lightmap_scales_with_power_exactly(dev):
    """The stream tier's splat scale follows the power: at power 4 the
    lightmap is exactly 4x the one at power 1 (the fixed-point scale drops
    two binary orders, so the integers are the same)."""
    scene, _ = compile_scene(str(FIXTURES / "tiny.png"), 30.0, CFG)
    ph = dataclasses.replace(CFG.photon, splat="scatter",
                             photons_per_batch=4096)
    em = pack_emitters(scene, ph.samples_per_area, ph.window_color,
                       ph.light_color, device=dev)
    r = prender.make_diff_renderer_wide(em, scene.num_texels, ph,
                                        pack_aa(scene.walls, dev))
    a = torch.full((len(scene.walls),), 0.8, device=dev)
    lm1 = r(a, torch.ones(len(em.counts), device=dev))
    lm4 = r(a, torch.full((len(em.counts),), 4.0, device=dev))
    assert lm1.sum().item() > 0
    assert torch.equal(lm4, 4 * lm1)


@pytest.mark.cuda
def test_stream_fold_is_deterministic_on_card(dev):
    """Two stream-tier folds of a mini batch give the same bits, and equal
    the CPU's within rtol 1e-4, the fold's bound for f32 sums of up to 10^5
    terms in another order (tests/test_torch_diff.py)."""
    calls = _diff_uniform_calls("mini", dev, 131072, 131072)
    idx, col, ridx = calls["trace_deposits_wide_diff"][0]()
    T = int(idx.max().item()) + 1
    g = torch.from_numpy(np.random.RandomState(2).rand(T, 3)
                         .astype(np.float32)).to(dev)
    n = int(ridx.max().item()) + 1
    a = prender.stream_fold(idx, col, ridx, g, n, 4096, 8)
    b = prender.stream_fold(idx, col, ridx, g, n, 4096, 8)
    c = prender.stream_fold(idx.cpu(), col.cpu(), ridx.cpu(), g.cpu(), n,
                            4096, 8)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[0].abs().sum().item() > 0
    np.testing.assert_allclose(a[0].cpu().numpy(), c[0].numpy(), rtol=1e-4)
    np.testing.assert_allclose(a[1].item(), c[1].item(), rtol=1e-4)


@pytest.mark.cuda
def test_kernels_past_the_old_shared_memory_cap(dev):
    """tiny's table with every rect repeated 400 times (5,200 rects, past
    every kernel's old cap): each trace kernel, the fold and the three
    nearest-hit kernels run their global-table instances and equal their
    plain versions on the repeated table; the non-diff traces also equal
    the 13-rect table's (shared-memory) results."""
    from flatmatch_tpu_torch.engines import ao
    from flatmatch_tpu_torch.ops import aa_query, threefry

    aa_c, T, alb, ev, inv = _diff_inputs("tiny", dev)
    big, gc = _big_table(aa_c, 400)
    n = big.shape[1]
    alb_big = alb.repeat_interleave(400).contiguous()
    cfg = CFG.photon
    B, nv = 512, 500
    seed = rng.batch_seed(cfg.seed, 3)
    u = threefry.batch_uniforms(cfg.seed, 3, B, 28, dev, transposed=True)
    g = torch.from_numpy(np.random.RandomState(5).rand(T, 3)
                         .astype(np.float32)).to(dev)
    fixed = prender.fixed_pair(cfg, torch.tensor([1.7], device=dev), alb, B)
    # the production, in-kernel and stream traces: equal to the small table
    for run in (
            lambda f, gc_: pw.trace_splat_wide_rng_i8(f, gc_, ev, seed, nv,
                                                      B, cfg, T),
            lambda f, gc_: pw.trace_splat_wide_rng_f32(f, gc_, ev, seed, nv,
                                                       B, cfg, T),
            lambda f, gc_: pw.trace_splat_wide_i8(f, gc_, ev, u, nv, cfg, T),
            lambda f, gc_: pw.trace_splat_wide_f32(f, gc_, ev, u, nv, cfg, T),
            lambda f, gc_: torch.cat([x.reshape(-1).float() for x in
                                      pw.trace_deposits_wide_rng(
                                          f, gc_, ev, seed, nv, B, cfg)])):
        a = run(big, gc)
        b = run(aa_c.fields, aa_c.group_counts)
        torch.cuda.synchronize()
        assert a.sum().item() > 0 and torch.equal(a, b)
    # against the plain versions on the big table
    plain = pw.trace_deposits_rng_plain(big, gc, ev, seed, nv, B, cfg,
                                        alb_big)
    uplain = pw.trace_uniforms_plain(big, gc, ev, u.t(), nv, cfg, alb_big)
    assert torch.equal(pw.trace_splat_wide_diff_rng_i8(
        big, gc, alb_big, ev, seed, nv, B, cfg, T, inv),
        pw.splat_i8_plain(plain[0], plain[1], T, inv.item()))
    assert torch.equal(pw.trace_splat_wide_diff_i8(
        big, gc, alb_big, ev, u, nv, cfg, T, inv),
        pw.splat_i8_plain(uplain[0], uplain[1], T, inv.item()))
    for got, want in (
            (pw.trace_splat_wide_diff_rng_f32(big, gc, alb_big, ev, seed, nv,
                                              B, cfg, T, fixed),
             pw.splat_f32_plain(plain[0], plain[1], T)),
            (pw.trace_splat_wide_diff_f32(big, gc, alb_big, ev, u, nv, cfg,
                                          T, fixed),
             pw.splat_f32_plain(uplain[0], uplain[1], T))):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    stream = pw.trace_deposits_wide_diff(big, gc, alb_big, ev, u, nv, cfg,
                                         512)
    for x, y in zip(stream, pw.stream_rows(uplain[0], uplain[1], 512,
                                           uplain[2])):
        assert torch.equal(x, y)
    for got, want in (
            (pw.trace_fold_wide_rng(big, gc, alb_big, ev, g, seed, nv, B,
                                    cfg, n), pw.fold_plain(*plain, g, n)),
            (pw.trace_fold_wide(big, gc, alb_big, ev, g, u, nv, cfg, n),
             pw.fold_plain(*uplain, g, n))):
        assert want[0].abs().sum().item() > 0
        np.testing.assert_allclose(got[0].cpu().numpy(),
                                   want[0].cpu().numpy(), rtol=1e-4,
                                   atol=1e-6 * want[0].abs().max().item())
        np.testing.assert_allclose(got[1].item(), want[1].item(), rtol=1e-4)
    # the nearest-hit kernels
    _, o, d = _ff_chunk("tiny", dev)        # rays from wall 0 into the room
    dist, tex = aa_query.aa_nearest(big, gc, o, d)
    pdist, ptex = aa_query.aa_nearest_plain(big, gc, o, d)
    assert torch.equal(tex, ptex) and torch.equal(dist, pdist)
    assert (tex >= 0).float().mean().item() > 0.5
    assert torch.equal(aa_query.nearest_distances(big, gc, o, d, 10.0),
                       aa_query.nearest_distances_plain(big, gc, o, d, 10.0))
    from flatmatch_tpu_torch.config import AoConfig

    scene, _ = compile_scene(str(FIXTURES / "tiny.png"), 30.0, CFG)
    aa = pack_aa(scene.walls, dev)
    big_aa, big_gc = _big_table(aa, 400)
    centers, walls, dirs, fac, _, _ = ao._ao_fused_prep(
        scene, AoConfig(geosphere_level=3))
    args = [torch.from_numpy(x).to(dev) for x in (centers[:64], walls[:64],
                                                  dirs, fac)]
    got = ao.ao_fused(big_aa, big_gc, *args, 10.0)
    assert torch.equal(got, ao.ao_fused(aa.fields, aa.group_counts, *args,
                                        10.0))
    want = ao.ao_fused_plain(big_aa, big_gc, *args, 10.0)
    nz = want != 0
    assert nz.any() and torch.equal(got == 0, want == 0)
    assert ((got[nz] - want[nz]).abs() / want[nz].abs()).max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["trace_fold_wide_rng", "trace_fold_wide"])
def test_fold_past_the_old_cap(dev, kernel):
    """tiny's table with 3,380 rects that are never hit (a far edge below
    0) in front of its x group and of its z group (6,773 slots, past the
    6,752 whose per-warp rows fit in a block at depth 8, with real rects in
    both passes): the fold runs in two passes over slot ranges, equals its
    plain version at the fold band (rtol 1e-4), and two runs give the same
    bits; one launch is counted a call."""
    from flatmatch_tpu_torch.ops import threefry
    from flatmatch_tpu_torch.ops.aa_scene import A_WLEN

    aa_c, T, _, ev, _ = _diff_inputs("tiny", dev)
    g0, g1, g2 = (int(c) for c in aa_c.group_counts)
    pad = aa_c.fields[:, :1].repeat(1, 3380)
    pad[A_WLEN] = -1.0
    big = torch.cat([pad, aa_c.fields[:, :g0 + g1], pad,
                     aa_c.fields[:, g0 + g1:]], 1).contiguous()
    gc = (3380 + g0, g1, 3380 + g2)
    n = big.shape[1]
    second = pw.fold_pass_slots(8)
    assert second < n <= 2 * second                 # two passes
    alb_big = torch.from_numpy(np.random.RandomState(3).uniform(
        0.4, 0.95, n).astype(np.float32)).to(dev)
    cfg = CFG.photon
    B, nv = 512, 500
    g = torch.from_numpy(np.random.RandomState(5).rand(T, 3)
                         .astype(np.float32)).to(dev)
    if kernel == "trace_fold_wide_rng":
        seed = rng.batch_seed(cfg.seed, 3)

        def run():
            return pw.trace_fold_wide_rng(big, gc, alb_big, ev, g, seed, nv,
                                          B, cfg, n)
        plain = pw.trace_deposits_rng_plain(big, gc, ev, seed, nv, B, cfg,
                                            alb_big)
    else:
        u = threefry.batch_uniforms(cfg.seed, 3, B, 28, dev, transposed=True)

        def run():
            return pw.trace_fold_wide(big, gc, alb_big, ev, g, u, nv, cfg, n)
        plain = pw.trace_uniforms_plain(big, gc, ev, u.t(), nv, cfg, alb_big)
    wrapper = getattr(pw, kernel)
    before = wrapper.launches
    da, w = run()
    da2, w2 = run()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert torch.equal(da, da2) and torch.equal(w, w2)
    want_da, want_w = pw.fold_plain(*plain, g, n)
    assert (want_da[second:] != 0).any() and (want_da[:second] != 0).any()
    np.testing.assert_allclose(da.cpu().numpy(), want_da.cpu().numpy(),
                               rtol=1e-4,
                               atol=1e-6 * want_da.abs().max().item())
    np.testing.assert_allclose(w.item(), want_w.item(), rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["aa_nearest", "nearest_distances",
                                    "ao_fused"])
def test_nearest_plan_follows_the_table_size(dev, kernel):
    """The library's plan for rows 12-14 (launch_table's rule): the
    shared-memory instance while the table's 52 bytes a rect (and row 12's
    512-byte reduction buffer) fit in a block's 232,448 bytes, the
    device-memory one past that; registers and blocks per SM from the
    occupancy calculator."""
    from flatmatch_tpu_torch.engines import ao
    from flatmatch_tpu_torch.ops import aa_query

    def plan(n):
        if kernel == "ao_fused":
            return ao.ao_fused_plan(n, dev)
        return aa_query.nearest_plan(n, kernel == "aa_nearest", dev)

    last = (232448 - (512 if kernel == "ao_fused" else 0)) // 52
    for n, inst in ((27, "shared"), (last, "shared"), (last + 1, "device"),
                    (4563, "device")):
        p = plan(n)
        assert p["instance"] == inst, (n, p)
        extra = 512 if kernel == "ao_fused" else 0
        assert p["shared_bytes"] == (52 * n if inst == "shared" else 0) + extra
        assert p["registers"] > 0 and p["blocks_per_sm"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["aa_nearest", "nearest_distances",
                                    "ao_fused"])
def test_nearest_kernels_on_a_table_past_shared_memory(dev, kernel):
    """The nearest-hit kernels (rows 12-14) on mini's tables with every
    rect repeated 200 times in place (past a block's shared memory: the
    device-memory instance of the shared rect loop) against their plain
    versions: ids and distances equal on every ray, the AO within rel 1e-5
    with the same zeros; and, since a copy never wins the strict-< tie,
    equal to the shared-memory instance on the unrepeated table."""
    from flatmatch_tpu_torch.config import AoConfig
    from flatmatch_tpu_torch.engines import ao
    from flatmatch_tpu_torch.ops import aa_query

    if kernel == "ao_fused":
        scene, _ = compile_scene(str(FIXTURES / "mini.png"), 30.0, CFG)
        aa = pack_aa(scene.walls, dev)
        big, gc = _big_table(aa, 200)
        assert 4 * 13 * big.shape[1] > 232448
        centers, walls, dirs, fac, _, _ = ao._ao_fused_prep(
            scene, AoConfig(geosphere_level=4))
        args = [torch.from_numpy(x).to(dev) for x in (
            centers[:96], walls[:96], dirs, fac)]
        got = ao.ao_fused(big, gc, *args, 10.0)
        want = ao.ao_fused_plain(big, gc, *args, 10.0)
        nz = want != 0
        assert nz.any() and torch.equal(got == 0, want == 0)
        assert ((got[nz] - want[nz]).abs() / want[nz].abs()).max() <= 1e-5
        assert torch.equal(got, ao.ao_fused(aa.fields, aa.group_counts,
                                            *args, 10.0))
        return
    aa, o, d = _ff_chunk("mini", dev, texels=32, rays=128)
    big, gc = _big_table(aa, 200)
    assert 4 * 13 * big.shape[1] > 232448
    if kernel == "aa_nearest":
        dist, tex = aa_query.aa_nearest(big, gc, o, d)
        pdist, ptex = aa_query.aa_nearest_plain(big, gc, o, d)
        assert (tex >= 0).float().mean().item() > 0.5
        assert torch.equal(tex, ptex) and torch.equal(dist, pdist)
        sdist, stex = aa_query.aa_nearest(aa.fields, aa.group_counts, o, d)
        assert torch.equal(tex, stex) and torch.equal(dist, sdist)
    else:
        got = aa_query.nearest_distances(big, gc, o, d, 10.0)
        assert torch.equal(got, aa_query.nearest_distances_plain(
            big, gc, o, d, 10.0))
        assert torch.equal(got, aa_query.nearest_distances(
            aa.fields, aa.group_counts, o, d, 10.0))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["trace_deposits_wide_diff",
                                    "trace_splat_wide_diff_i8",
                                    "trace_splat_wide_diff_f32",
                                    "trace_fold_wide", "threefry_uniform"])
def test_threefry_tier_wrappers_raise_on_a_failed_launch(dev, kernel,
                                                         monkeypatch):
    """A CUDA error from the entry point raises; nothing falls back to the
    plain version and no launch is counted."""
    from flatmatch_tpu_torch.ops import threefry
    from flatmatch_tpu_torch.utils import cuda_build

    if kernel == "threefry_uniform":
        wrapper = threefry.uniform

        def run():
            return threefry.uniform((0, 1), (256, 28), dev, True)
    else:
        wrapper = getattr(pw, kernel)
        run = _diff_uniform_calls("tiny", dev, 200, 256)[kernel][0]
    cuda_build.load_library()
    monkeypatch.setattr(cuda_build, "_lib", _FailingLibrary())
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        run()
    assert wrapper.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["shared", "device", "inexact_sign"])
def test_rows_6_and_9_match_plain_in_each_table_instance(dev, table):
    """Rows 6 and 9 (the diff stream, the uniforms-in fold) against their
    plain versions with a dead tail, on tiny's table in each instance of
    the redesigned trace: staged as per-rect records in shared memory
    (`shared`); every rect repeated 400 times in place (5,200 rects, past
    shared memory: the device-memory instance); and one rect's sign moved
    to 1.0006226, off the range where the six axis bases stand for
    build_base (photon_wide.trace_bases), so the shared-memory instance
    builds each basis at the bounce. Row 6 equals its plain stream on every
    row, row 9 within rtol 1e-4 of the plain fold; two runs of each give
    the same bits."""
    from flatmatch_tpu_torch.ops import threefry
    from flatmatch_tpu_torch.ops.aa_scene import A_SN

    aa_c, T, alb, ev, _ = _diff_inputs("tiny", dev)
    f, gc = aa_c.fields, aa_c.group_counts
    if table == "device":
        f, gc = _big_table(aa_c, 400)
        alb = alb.repeat_interleave(400).contiguous()
        assert 4 * 14 * f.shape[1] > 232448
    elif table == "inexact_sign":
        f = f.clone()
        f[A_SN, 1] = torch.sign(f[A_SN, 1]) * np.float32(1.0006226)
        assert not pw.trace_bases(f, gc, ev)[2]
    else:
        assert pw.trace_bases(f, gc, ev)[2]
    cfg, n = CFG.photon, f.shape[1]
    n_valid, batch = 1000, 1024
    u = threefry.batch_uniforms(cfg.seed, 9, batch, 28, dev, transposed=True)
    g = torch.from_numpy(np.random.RandomState(5).rand(T, 3)
                         .astype(np.float32)).to(dev)
    block = prender.diff_block(batch)
    plain = pw.trace_uniforms_plain(f, gc, ev, u.t(), n_valid, cfg, alb)
    assert plain[1].sum().item() > 0 and (plain[2] >= 0).any()

    def row6():
        return pw.trace_deposits_wide_diff(f, gc, alb, ev, u, n_valid, cfg,
                                           block)

    def row9():
        return pw.trace_fold_wide(f, gc, alb, ev, g, u, n_valid, cfg, n)

    a, b = row6(), row6()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for x, y in zip(a, pw.stream_rows(plain[0], plain[1], block, plain[2])):
        assert torch.equal(x, y)
    (da, w), (da2, w2) = row9(), row9()
    torch.cuda.synchronize()
    assert torch.equal(da, da2) and torch.equal(w, w2)
    want_da, want_w = pw.fold_plain(*plain, g, n)
    assert want_da.abs().sum().item() > 0
    np.testing.assert_allclose(da.cpu().numpy(), want_da.cpu().numpy(),
                               rtol=1e-4,
                               atol=1e-6 * want_da.abs().max().item())
    np.testing.assert_allclose(w.item(), want_w.item(), rtol=1e-4)


# --------------------------------------------------------------------------
# the general route: trace_deposits_narrow.cu (row 11) and the general
# engine's reruns
# --------------------------------------------------------------------------
def _narrow_inputs(dev, deg, batch):
    """tiny turned `deg` degrees: its narrow table, emitter 0's vector and
    the threefry uniforms of global batch 3 in the [U, B] layout."""
    from chip_smoke import rotated_scene
    from flatmatch_tpu_torch.engines import photon_narrow as pn
    from flatmatch_tpu_torch.ops import threefry
    from flatmatch_tpu_torch.ops.device_scene import pack_rects

    scene = rotated_scene(compile_scene(str(FIXTURES / "tiny.png"), 30.0,
                                        CFG)[0], deg)
    ph = CFG.photon
    em = pack_emitters(scene, ph.samples_per_area, ph.window_color,
                       ph.light_color, device=dev)
    u_t = threefry.batch_uniforms(ph.seed, 3, batch, 28, dev,
                                  transposed=True)
    return pn.narrow_table(pack_rects(scene.walls, device=dev)), \
        pw.emitter_vector(em, 0), u_t


@pytest.mark.cuda
@pytest.mark.parametrize("deg", [0, 30])
@pytest.mark.parametrize("repeat", [1, 400])
def test_narrow_kernel_matches_plain(dev, deg, repeat):
    """Row 11 against its plain version, with a dead tail (n_valid < B):
    ids equal on >= 99.9% of rows, colors within 1e-5, and two runs
    bit-identical. repeat=400 repeats every rect in place (5,200 rects,
    374 KB of table): the device-memory instance, whose ties go to the
    first copy, so it equals the shared-memory instance on the real
    table."""
    from flatmatch_tpu_torch.engines import photon_narrow as pn

    B, nv = 8192, 8000
    table, ev, u_t = _narrow_inputs(dev, deg, B)
    small = pn.trace_deposits_narrow(table, ev, u_t, nv, CFG.photon)
    if repeat > 1:
        table = table.repeat_interleave(repeat, dim=1).contiguous()
        assert 4 * 18 * table.shape[1] > 232448
    before = pn.trace_deposits_narrow.launches
    idx, col = pn.trace_deposits_narrow(table, ev, u_t, nv, CFG.photon)
    idx2, col2 = pn.trace_deposits_narrow(table, ev, u_t, nv, CFG.photon)
    torch.cuda.synchronize()
    assert pn.trace_deposits_narrow.launches == before + 2
    assert torch.equal(idx, idx2) and torch.equal(col, col2)
    assert torch.equal(idx, small[0]) and torch.equal(col, small[1])
    pidx, pcol = pn.trace_deposits_narrow_plain(table, ev, u_t.t(), nv,
                                                CFG.photon)
    assert pcol.sum().item() > 0 and (col[nv:] == 0).all()
    assert (idx == pidx).all(1).float().mean().item() >= 0.999
    np.testing.assert_allclose(col.cpu().numpy(), pcol.cpu().numpy(),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("deg", [0, 30])
@pytest.mark.parametrize("repeat", [1, 400])
def test_narrow_kernel_off_the_block_matches_plain(dev, deg, repeat):
    """Row 11 with a batch that is not a multiple of its 256-photon block
    (8,037: the last block and its last warp partial, so the staged stores
    end mid-warp) and n_valid that is not one either (7,777), in both
    table instances (repeat=400: the device-memory one): ids equal on
    >= 99.9% of rows, colors within 1e-5, dead and absent rows as the
    plain version has them, two runs bit-identical, and the two instances
    equal."""
    from flatmatch_tpu_torch.engines import photon_narrow as pn

    B, nv = 8037, 7777
    table, ev, u_t = _narrow_inputs(dev, deg, B)
    small = pn.trace_deposits_narrow(table, ev, u_t, nv, CFG.photon)
    if repeat > 1:
        table = table.repeat_interleave(repeat, dim=1).contiguous()
    idx, col = pn.trace_deposits_narrow(table, ev, u_t, nv, CFG.photon)
    idx2, col2 = pn.trace_deposits_narrow(table, ev, u_t, nv, CFG.photon)
    torch.cuda.synchronize()
    assert idx.shape == (B, 8) and col.shape == (B, 24)
    assert torch.equal(idx, idx2) and torch.equal(col, col2)
    assert torch.equal(idx, small[0]) and torch.equal(col, small[1])
    pidx, pcol = pn.trace_deposits_narrow_plain(table, ev, u_t.t(), nv,
                                                CFG.photon)
    assert pcol.sum().item() > 0
    assert (idx[nv:] == 0).all() and (col[nv:] == 0).all()
    assert (idx == pidx).all(1).float().mean().item() >= 0.999
    np.testing.assert_allclose(col.cpu().numpy(), pcol.cpu().numpy(),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
def test_narrow_instances_follow_table_and_staging(dev):
    """fm_trace_deposits_narrow_plan: a table past shared memory (5,200
    rects) takes the device-memory instance and no shared memory; a depth
    whose staging (16 bytes a photon and bounce, 256 photons) cannot sit
    beside the table takes the table alone; otherwise the staging joins
    the table where it costs no block a SM. A depth past the staging runs
    and matches the plain version."""
    from flatmatch_tpu_torch.engines import photon_narrow as pn

    assert pn.narrow_instance(5200, 8, dev) == ("device", 0)
    assert pn.narrow_instance(13, 57, dev) == ("table", 72 * 13)
    inst, smem = pn.narrow_instance(13, 8, dev)
    assert (inst, smem) in (("staged", 72 * 13 + 16 * 256 * 8),
                            ("table", 72 * 13))
    cfg = dataclasses.replace(CFG.photon, max_depth=57)
    table, ev, _ = _narrow_inputs(dev, 30, 1000)
    from flatmatch_tpu_torch.ops import threefry
    u_t = threefry.batch_uniforms(CFG.photon.seed, 3, 1000, 4 + 3 * 57, dev,
                                  transposed=True)
    idx, col = pn.trace_deposits_narrow(table, ev, u_t, 999, cfg)
    pidx, pcol = pn.trace_deposits_narrow_plain(table, ev, u_t.t(), 999,
                                                cfg)
    assert idx.shape == (1000, 57) and pcol.sum().item() > 0
    assert (idx == pidx).all(1).float().mean().item() >= 0.999
    np.testing.assert_allclose(col.cpu().numpy(), pcol.cpu().numpy(),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
def test_narrow_wrapper_raises_on_a_failed_launch(dev, monkeypatch):
    """A CUDA error from the entry point raises; nothing falls back to the
    plain version and no launch is counted."""
    from flatmatch_tpu_torch.engines import photon_narrow as pn
    from flatmatch_tpu_torch.utils import cuda_build

    table, ev, u_t = _narrow_inputs(dev, 30, 256)
    cuda_build.load_library()
    monkeypatch.setattr(cuda_build, "_lib", _FailingLibrary())
    before = pn.trace_deposits_narrow.launches
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        pn.trace_deposits_narrow(table, ev, u_t, 200, CFG.photon)
    assert pn.trace_deposits_narrow.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["photon_pallas", "photon_xla"])
def test_general_routes_rerun_bit_identical(dev, engine):
    """Rotated tiny through the narrow kernel's route and the general
    engine: two card renders give the same bits (the fixed-point splat has
    no float atomics), and each agrees with the CPU render (the plain
    versions) texel by texel at the bands of test_torch_general.py's
    test_general_routes_match_jax_run_engine: >= 99% of texels within rtol
    1e-4, the total within 1e-3."""
    from chip_smoke import rotated_scene
    from flatmatch_tpu_torch.config import Engine

    cfg = CFG.replace(engine=Engine(engine))
    scene = rotated_scene(compile_scene(str(FIXTURES / "tiny.png"), 30.0,
                                        cfg)[0], 30)
    a = run_engine(scene, cfg, dev)
    b = run_engine(scene, cfg, dev)
    assert np.array_equal(a, b) and a.sum() > 0
    c = run_engine(scene, cfg, "cpu")
    assert a.shape == c.shape and np.isfinite(a).all()
    close = np.isclose(a, c, rtol=1e-4, atol=1e-6 * c.max())
    assert close.mean() >= 0.99, f"only {close.mean():.4%} close"
    np.testing.assert_allclose(a.sum(), c.sum(), rtol=1e-3)


def _random_rects(n, dev, seed=0):
    """A general table of n rects of random orientation in a 10 m box,
    packed as pack_rects packs one (ops/device_scene.Rects)."""
    from flatmatch_tpu_torch.ops.device_scene import rects_from_numpy

    rs = np.random.RandomState(seed)
    f32 = np.float32

    def unit(v):
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(f32)

    pos = rs.uniform(0, 10, (n, 3)).astype(f32)
    nrm = unit(rs.normal(size=(n, 3)))
    w_unit = unit(np.cross(nrm, rs.normal(size=(n, 3))))
    h_unit = unit(np.cross(nrm, w_unit))
    wlen = rs.uniform(0.2, 3, n).astype(f32)
    hlen = rs.uniform(0.2, 3, n).astype(f32)
    ones = np.ones(n, np.int32)
    return rects_from_numpy(
        dev, pos=pos, wvec=w_unit * wlen[:, None], hvec=h_unit * hlen[:, None],
        n=nrm, w_unit=w_unit, h_unit=h_unit, wlen=wlen, hlen=hlen,
        n_off=np.sum(nrm * pos, axis=-1, dtype=f32),
        base=np.arange(n, dtype=np.int32), wtiles=ones, htiles=ones)


def _general_rays(name, dev):
    """(Rects, origins, directions, expected instance) of a case: the
    photon engine's first-bounce rays of mini and of rotated mini (emitted
    from their first emitter), or random rays over 4,000 random rects,
    past a block's shared memory (3,632 rects)."""
    from chip_smoke import rotated_scene
    from flatmatch_tpu_torch.engines import photon
    from flatmatch_tpu_torch.engines.schedule import emitter_slice
    from flatmatch_tpu_torch.ops import threefry
    from flatmatch_tpu_torch.ops.device_scene import pack_rects

    if name == "random4000":
        rects = _random_rects(4000, dev)
        rs = np.random.RandomState(1)
        src = torch.from_numpy(rs.uniform(0, 10, (65536, 3)).astype(
            np.float32)).to(dev)
        d = torch.from_numpy(rs.normal(size=(65536, 3)).astype(np.float32))
        d = (d / d.norm(dim=1, keepdim=True)).to(dev)
        return rects, src, d, "device"
    scene, _ = compile_scene(str(FIXTURES / "mini.png"), 30.0, CFG)
    if name == "rotated_mini":
        scene = rotated_scene(scene, 30)
    rects = pack_rects(scene.walls, device=dev)
    ph = CFG.photon
    em = pack_emitters(scene, ph.samples_per_area, ph.window_color,
                       ph.light_color, device=dev)
    u = threefry.batch_uniforms(ph.seed, 0, 131072, 28, dev)
    src, d = photon.emit(emitter_slice(em, 0), u, 1e-5)
    return rects, src.contiguous(), d.contiguous(), "shared"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mini", "rotated_mini", "random4000"])
def test_general_nearest_kernel_matches_plain_bit_for_bit(dev, name):
    """csrc/general_nearest.cu against ops/intersect.nearest_hit_plain on
    the same card: every distance's bits and every hit id equal, in the
    shared-memory instance and in the device-memory one (tables past 3,632
    rects), and a rerun gives the same bits."""
    from flatmatch_tpu_torch.ops import intersect

    rects, src, d, inst = _general_rays(name, dev)
    n = intersect.general_table(rects).shape[0]
    assert intersect.general_plan(n, dev)["instance"] == inst
    before = intersect.nearest_hit.launches
    dist, hit = intersect.nearest_hit(src, d, rects)
    dist2, hit2 = intersect.nearest_hit(src, d, rects)
    torch.cuda.synchronize()
    assert intersect.nearest_hit.launches == before + 2
    want_d, want_h = intersect.nearest_hit_plain(src, d, rects)
    assert torch.isfinite(want_d).float().mean().item() > 0.2
    assert torch.equal(dist.view(torch.int32), want_d.view(torch.int32))
    assert torch.equal(hit, want_h)
    assert torch.equal(dist.view(torch.int32), dist2.view(torch.int32))
    assert torch.equal(hit, hit2)


@pytest.mark.cuda
def test_general_nearest_wrapper_refuses_and_raises(dev, monkeypatch):
    """Rays on another device than the table are refused; a CUDA error
    from the entry point raises, with no launch counted and no fallback."""
    from flatmatch_tpu_torch.ops import intersect
    from flatmatch_tpu_torch.utils import cuda_build

    rects, src, d, _ = _general_rays("random4000", dev)
    with pytest.raises(ValueError):
        intersect.nearest_hit(src.cpu(), d, rects)
    cuda_build.load_library()
    monkeypatch.setattr(cuda_build, "_lib", _FailingLibrary())
    before = intersect.nearest_hit.launches
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        intersect.nearest_hit(src, d, rects)
    assert intersect.nearest_hit.launches == before


@pytest.mark.cuda
def test_general_diff_renderer_on_card(dev):
    """The general differentiable renderer on rotated tiny: at albedo 0.9
    and power 1 its forward equals the general engine's render_photons
    bit for bit; its replay gradients equal the autograd oracle's at
    test_diff.py's bands and repeat bit for bit."""
    from chip_smoke import rotated_scene
    from flatmatch_tpu_torch.engines import photon
    from flatmatch_tpu_torch.ops.device_scene import pack_rects

    ph = dataclasses.replace(CFG.photon, samples_per_area=2000.0,
                             photons_per_batch=512, seed=5)
    scene = rotated_scene(compile_scene(str(FIXTURES / "tiny.png"), 30.0,
                                        CFG)[0], 30)
    rects = pack_rects(scene.walls, device=dev)
    em = pack_emitters(scene, ph.samples_per_area, ph.window_color,
                       ph.light_color, device=dev)
    T = scene.num_texels
    r = prender.make_diff_renderer(rects, em, T, ph)
    oracle = prender.make_autodiff_oracle(rects, em, T, ph)
    a0 = torch.full((rects.n.shape[0],), np.float32(ph.albedo), device=dev)
    p0 = torch.ones(len(em.counts), device=dev)
    with torch.no_grad():
        assert torch.equal(r(a0, p0),
                           photon.render_photons(rects, em, T, ph))
    w = torch.from_numpy(np.random.RandomState(0).rand(T, 3).astype(
        np.float32)).to(dev)

    def grads(fn):
        a, p = a0.clone().requires_grad_(), p0.clone().requires_grad_()
        torch.sum(fn(a, p) * w).backward()
        return a.grad.cpu().numpy(), p.grad.cpu().numpy()

    ga, gp = grads(r)
    oa, op = grads(oracle)
    np.testing.assert_allclose(ga, oa, rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(gp, op, rtol=1e-4)
    ga2, gp2 = grads(r)
    assert np.array_equal(ga, ga2) and np.array_equal(gp, gp2)
