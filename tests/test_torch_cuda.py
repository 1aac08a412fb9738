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
    u = threefry.batch_uniforms(3, 11, batch, pw.uniforms_per_photon(8), dev)
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
         lambda: pw.trace_deposits_wide_plain(f, gc, ev, u, n_valid, cfg,
                                              blk)),
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
    within rtol 1e-5 of index_add_'s f32 order; two runs identical."""
    from flatmatch_tpu_torch.ops import splat as sp

    idx, col, T = _stream_of(name, dev, batch)
    cfg = _stream_cfg()
    bound = sp.stream_bound(dataclasses.replace(cfg,
                                                photons_per_batch=batch))
    cases = [
        (sp.fused_splat_i8, (sp.splat_color_scale(cfg),),
         lambda: sp.fused_splat_i8_plain(idx.cpu(), col.cpu(), T,
                                         sp.splat_color_scale(cfg))),
        (sp.fused_splat, (bound,),
         lambda: sp.fused_splat_plain(idx.cpu(), col.cpu(), T)),
        (sp.scatter_splat, (bound,),
         lambda: sp.scatter_plain(idx.cpu(), col.cpu(), T)),
    ]
    for fn, args, plain in cases:
        counter = sp.fused_splat_i8 if fn is sp.fused_splat_i8 \
            else sp.fused_splat
        before = counter.launches
        a, b = fn(idx, col, T, *args), fn(idx, col, T, *args)
        torch.cuda.synchronize()
        assert counter.launches == before + 2
        assert torch.equal(a, b)
        want = plain()
        assert want.sum().item() > 0
        if fn is sp.fused_splat_i8:
            assert torch.equal(a.cpu(), want)
        else:
            np.testing.assert_allclose(a.cpu().numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-6)
        # a CPU stream takes the plain version and launches nothing
        got = fn(idx.cpu(), col.cpu(), T, *args)
        assert counter.launches == before + 2
        assert got.device.type == "cpu" and torch.equal(got, want)


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
def test_stream_trace_launch_refused_for_its_shared_memory(dev, monkeypatch):
    """A scene table past a block's shared memory: with the wrapper's own
    check out of the way, the CUDA attribute call refuses the launch and
    the wrapper raises."""
    n = 5000                                    # 13 * 4 * 5000 > 232448
    f = torch.zeros((13, n), device=dev)
    ev = torch.zeros(16, device=dev)
    monkeypatch.setattr(pw, "check_smem", lambda *a: None)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        pw.trace_deposits_wide_rng(f, (n, 0, 0), ev, 0, 256, 256,
                                   _stream_cfg())
