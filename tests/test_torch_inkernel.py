"""The port's in-kernel splat tiers beyond the default render, against the
JAX package.

Three kernels of the render and one of the fit: the counter-hash trace with
bf16 colors summed in f32 (`render --splat inkernel`,
trace_splat_wide_rng(i8=False)), the threefry-uniforms trace with the 7-bit
and with the f32 splat (`render --no-device-rng`, trace_splat_wide(i8)), and
the diff forward with the f32 splat (`fit --splat inkernel` or `fused`,
trace_splat_wide_diff_rng(i8=False)). One 1024-photon batch of `tiny` goes
through the JAX package's kernels, run in Pallas interpret mode at
sublanes=4 as its own tests run them, and through the port's plain PyTorch
versions (the path CPU tensors take), with identical tables and draws.
The JAX kernels run at unroll=1: the unrolled rect loop tests the rects in
the same order (photon_pallas_wide.trace_splat_wide_rng), so the bits are
the same, and interpret mode compiles the rolled loop in less time.

Tolerances. The 7-bit tier is integer work (draws, ids, dither keys and
sums): its int32 accumulator must agree bit for bit. The f32 tiers sum the
same bf16-rounded colors in another f32 order (the TPU kernel's one-hot MXU
contraction against `index_add_`): rtol 1e-5, atol 1e-5, the tolerance of
tests/test_pallas_wide.py:233. The backward of the diff renderer does not
depend on the forward's tier, so the gradients at `inkernel` equal those at
`inkernel_i8` bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from flatmatch_tpu.config import PhotonConfig as JaxPhotonConfig
from flatmatch_tpu.engines import photon_pallas
from flatmatch_tpu.engines import photon_pallas_wide as jw
from flatmatch_tpu.engines.schedule import emitter_slice
from flatmatch_tpu.ops.aa_scene import pack_aa as jax_pack_aa
from flatmatch_tpu.ops.device_scene import pack_emitters as jax_pack_em
from flatmatch_tpu.scene import geometry, image as im, layout
from flatmatch_tpu_torch import cli, interop
from flatmatch_tpu_torch.config import DEFAULT_CONFIG, PhotonConfig
from flatmatch_tpu_torch.diff import render as prender
from flatmatch_tpu_torch.engines import photon_wide as pw
from flatmatch_tpu_torch.ops import splat as psplat, threefry
from flatmatch_tpu_torch.render import compile_scene, run_engine
from tests.conftest import FIXTURES

f32 = np.float32
B = 1024
N_VALID = 1000     # the last 24 photons are dead from the start
U = 28             # 4 + 3 * max_depth
SUBLANES = 4
GLOBAL_BATCH = 70000
POWER = f32(1.7)
KW = dict(samples_per_area=3000.0, photons_per_batch=B, seed=9,
          splat="inkernel", device_rng=True)
JCFG = JaxPhotonConfig(**KW)
CFG = PhotonConfig(**KW)
TINY = str(FIXTURES / "tiny.png")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: the plain versions' tensors are
    small, so one thread is about as fast alone, and the parallel test
    workers do not oversubscribe the cores they share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def t():
    """tiny's compact tables in both packages, one batch's draws and seed,
    and per-rect albedo from a numpy seed."""
    img = im.load_layout(TINY)
    scene = geometry.Scene(layout.parse_layout(img, f32(1) / f32(30), 200.0))
    aa = jax_pack_aa(scene.walls)
    em = jax_pack_em(scene, CFG.samples_per_area, CFG.window_color,
                     CFG.light_color)
    aa_c, total_c, _ = jw.compact_aa(aa, scene.num_texels)
    ev = photon_pallas.emitter_vector(emitter_slice(em, 0))
    n = aa_c.fields.shape[1]
    albedo = (0.5 + 0.45 * np.random.RandomState(7).rand(n)).astype(f32)
    return dict(
        scene=scene, aa=aa, em=em, aa_c=aa_c, total_c=total_c, n=n, ev=ev,
        port_aa=interop.from_jax_aa(np.asarray(aa.fields), aa.group_counts,
                                    aa.perm),
        port_aa_c=interop.from_jax_aa(np.asarray(aa_c.fields),
                                      aa_c.group_counts, aa_c.perm),
        port_ev=torch.from_numpy(np.array(ev, f32).reshape(16)),
        uniforms=jax.random.uniform(
            jax.random.fold_in(jax.random.PRNGKey(CFG.seed), GLOBAL_BATCH),
            (B, U), jnp.float32),
        seed=int(jw.batch_seed(CFG.seed, 0)), albedo=albedo,
        albedo_aa=albedo[np.asarray(aa_c.perm)])


def _lm(x):
    return np.array(x, f32)


@pytest.fixture(scope="module")
def jax_rng_f32(t):
    """Row 2: trace_splat_wide_rng(i8=False)."""
    with pltpu.force_tpu_interpret_mode():
        return _lm(jw.trace_splat_wide_rng(
            t["aa_c"].fields, t["ev"], t["seed"], N_VALID, JCFG,
            t["aa_c"].group_counts, t["total_c"], B, SUBLANES, unroll=1))


@pytest.fixture(scope="module")
def jax_uniforms(t):
    """Row 5, both splats: trace_splat_wide(i8=True), trace_splat_wide."""
    with pltpu.force_tpu_interpret_mode():
        return {i8: _lm(jw.trace_splat_wide(
            t["aa_c"].fields, t["ev"], t["uniforms"], N_VALID, JCFG,
            t["aa_c"].group_counts, t["total_c"], SUBLANES, unroll=1,
            i8=i8))
            for i8 in (True, False)}


@pytest.fixture(scope="module")
def jax_diff_f32(t):
    """Row 8b: trace_splat_wide_diff_rng(i8=False) at per-slot albedo and
    the emitter's color times POWER."""
    ev = t["ev"].at[:, 12:15].mul(POWER)
    with pltpu.force_tpu_interpret_mode():
        return _lm(jw.trace_splat_wide_diff_rng(
            t["aa_c"].fields, jnp.asarray(t["albedo_aa"]), ev, t["seed"],
            N_VALID, JCFG, t["aa_c"].group_counts, t["total_c"], B,
            SUBLANES, unroll=1))


def _port_args(t):
    return t["port_aa_c"].fields, t["port_aa_c"].group_counts, t["port_ev"]


def _port_uniforms(t):
    u = threefry.batch_uniforms(CFG.seed, GLOBAL_BATCH, B, U,
                                transposed=True)
    assert torch.equal(u.t(), torch.from_numpy(np.array(t["uniforms"])))
    return u


def _scaled_ev(t, power):
    ev = t["port_ev"].clone()
    ev[12:15] = ev[12:15] * torch.tensor(power)
    return ev


def _counted(fn, *args, **kw):
    """fn on CPU tensors: the plain version, no launch counted."""
    before = fn.launches
    out = fn(*args, **kw)
    assert fn.launches == before
    return out


def test_rng_f32_plain_matches_jax(t, jax_rng_f32):
    f, gc, ev = _port_args(t)
    got = _counted(pw.trace_splat_wide_rng_f32, f, gc, ev, t["seed"],
                   N_VALID, B, CFG, t["total_c"]).numpy()
    assert got.dtype == np.float32 and jax_rng_f32.sum() > 0
    np.testing.assert_allclose(got, jax_rng_f32, rtol=1e-5, atol=1e-5)


def test_uniforms_i8_plain_matches_jax_bit_for_bit(t, jax_uniforms):
    """The int32 accumulator: JAX de-scales it once, acc * f32(scale), in
    the same f32 product the engine takes."""
    f, gc, ev = _port_args(t)
    acc = _counted(pw.trace_splat_wide_i8, f, gc, ev, _port_uniforms(t),
                   N_VALID, CFG, t["total_c"])
    assert acc.dtype == torch.int32 and acc.sum().item() > 0
    scale = f32(pw.splat_color_scale(CFG))
    want = jax_uniforms[True]
    np.testing.assert_array_equal(np.rint(want / scale).astype(np.int32),
                                  acc.numpy())
    got = (acc.to(torch.float32) * float(scale)).numpy()
    assert got.view(np.uint32).tobytes() == want.view(np.uint32).tobytes()


def test_uniforms_f32_plain_matches_jax(t, jax_uniforms):
    f, gc, ev = _port_args(t)
    got = _counted(pw.trace_splat_wide_f32, f, gc, ev, _port_uniforms(t),
                   N_VALID, CFG, t["total_c"]).numpy()
    assert jax_uniforms[False].sum() > 0
    np.testing.assert_allclose(got, jax_uniforms[False], rtol=1e-5,
                               atol=1e-5)
    # the 7-bit grid of the same photons carries the same energy
    np.testing.assert_allclose(jax_uniforms[True].sum(), got.sum(),
                               rtol=2e-3)


def test_diff_f32_plain_matches_jax(t, jax_diff_f32):
    f, gc, _ = _port_args(t)
    alb = torch.from_numpy(t["albedo_aa"])
    fixed = prender.fixed_pair(CFG, torch.tensor([POWER]), alb, B)
    got = _counted(pw.trace_splat_wide_diff_rng_f32, f, gc, alb,
                   _scaled_ev(t, POWER), t["seed"], N_VALID, B, CFG,
                   t["total_c"], fixed).numpy()
    assert jax_diff_f32.sum() > 0
    np.testing.assert_allclose(got, jax_diff_f32, rtol=1e-5, atol=1e-5)


def test_diff_f32_plain_at_uniform_albedo_equals_row_2(t):
    """The port's form of tests/test_diff.py:245-263: at the scalar albedo
    everywhere and power 1 the diff forward is the production one."""
    f, gc, ev = _port_args(t)
    alb = torch.full((t["n"],), f32(CFG.albedo))
    fixed = prender.fixed_pair(CFG, torch.ones(1), alb, B)
    diff = pw.trace_splat_wide_diff_rng_f32(f, gc, alb, ev, t["seed"],
                                            N_VALID, B, CFG, t["total_c"],
                                            fixed)
    prod = pw.trace_splat_wide_rng_f32(f, gc, ev, t["seed"], N_VALID, B, CFG,
                                       t["total_c"])
    assert prod.sum().item() > 0
    assert torch.equal(diff, prod)


def test_fixed_pair_is_the_stream_scale_at_the_defaults():
    """(2^k, 2^-k) computed on the device from the grid correction: at
    corr == 1 the stream route's scale, above it the scale of the scaled
    bound, exact powers of two either way."""
    bound = psplat.stream_bound(CFG)
    ones = torch.full((8,), f32(CFG.albedo))
    got = prender.fixed_pair(CFG, torch.ones(1), ones, B)
    assert got.dtype == torch.float32 and got.shape == (2,)
    assert tuple(got.tolist()) == psplat.fixed_point_scale(bound)
    high = prender.fixed_pair(CFG, torch.tensor([3.0]),
                              torch.full((8,), 1.25), B)
    corr = f32(3.0) * f32(1.25) ** CFG.max_depth
    assert tuple(high.tolist()) == psplat.fixed_point_scale(bound * corr)
    k = np.log2(high.numpy().astype(np.float64))
    assert (k == np.round(k)).all() and k[0] == -k[1]
    # ceil(log2) from the binary exponent: a power of two is its own
    assert psplat.fixed_point_scale(2.0 ** 24) == (2.0 ** 38, 2.0 ** -38)
    assert psplat.fixed_point_scale(2.0 ** 24 * (1 + 2.0 ** -52))[0] == \
        2.0 ** 37


def test_inkernel_wrappers_check_inputs(t):
    f, gc, ev = _port_args(t)
    T, n = t["total_c"], t["n"]
    u = threefry.batch_uniforms(0, 0, 256, U, transposed=True)
    alb = torch.full((n,), 0.9)
    fixed = torch.ones(2)
    for fn in (pw.trace_splat_wide_i8, pw.trace_splat_wide_f32):
        with pytest.raises(ValueError):      # U != 4 + 3 * max_depth
            fn(f, gc, ev, u[:27].contiguous(), 8, CFG, T)
        with pytest.raises(ValueError):      # float64 uniforms
            fn(f, gc, ev, u.double(), 8, CFG, T)
        with pytest.raises(ValueError):      # n_valid past the batch
            fn(f, gc, ev, u, 257, CFG, T)
    with pytest.raises(ValueError):          # n_valid past the batch
        pw.trace_splat_wide_rng_f32(f, gc, ev, 0, 9, 8, CFG, T)
    with pytest.raises(ValueError):          # albedo row of the wrong length
        pw.trace_splat_wide_diff_rng_f32(f, gc, alb[:-1], ev, 0, 8, 8, CFG,
                                         T, fixed)
    with pytest.raises(ValueError):          # the scale pair is two values
        pw.trace_splat_wide_diff_rng_f32(f, gc, alb, ev, 0, 8, 8, CFG, T,
                                         torch.ones(1))
    # no live photon: nothing deposited
    assert not pw.trace_splat_wide_i8(f, gc, ev, u, 0, CFG, T).any()
    assert not pw.trace_splat_wide_f32(f, gc, ev, u, 0, CFG, T).any()


def test_threefry_i8_route_checks_its_int32_accumulator():
    cfg = DEFAULT_CONFIG.replace(photon=dataclasses.replace(
        DEFAULT_CONFIG.photon, photons_per_batch=1 << 22,
        splat="inkernel_i8", device_rng=False))
    scene, _ = compile_scene(TINY, 30.0, cfg)
    with pytest.raises(ValueError, match="int32"):
        run_engine(scene, cfg, device="cpu")


# --------------------------------------------------------------------------
# the diff renderer on the f32 tier
# --------------------------------------------------------------------------
def _one_batch_renderer(t, splat):
    """The wide diff renderer over one emitter of N_VALID photons: one
    batch, global batch 0, as the fixtures."""
    counts = np.array(t["em"].counts).copy()
    counts[:] = 0
    counts[0] = N_VALID
    fields = [np.asarray(x) for x in t["em"]][:-1]
    em = interop.from_jax_emitters(*fields, counts)
    return prender.make_diff_renderer_wide(
        em, t["scene"].num_texels, dataclasses.replace(CFG, splat=splat),
        t["port_aa"])


def test_diff_renderer_f32_forward_matches_jax(t, jax_diff_f32):
    r = _one_batch_renderer(t, "inkernel")
    assert [b[:3] for b in r.batches] == [(0, 0, N_VALID)]
    lm = r(torch.from_numpy(t["albedo"]), torch.tensor([POWER]))
    got = lm[r.arena_pos].numpy()          # back to the compact arena
    np.testing.assert_allclose(got, jax_diff_f32, rtol=1e-5, atol=1e-5)


def test_diff_renderer_tiers_share_the_backward(t):
    """Gradients of sum(lm * w) at `inkernel` equal those at `inkernel_i8`
    bit for bit (the fold replays exact f32 colors whatever the forward);
    `fused` and `fused_i8` are the same tiers as the JAX renderer maps
    them."""
    w = torch.from_numpy(np.random.RandomState(3).rand(
        t["scene"].num_texels, 3).astype(f32))
    res = {}
    for splat in ("inkernel", "inkernel_i8", "fused", "fused_i8"):
        r = _one_batch_renderer(t, splat)
        a = torch.from_numpy(t["albedo"]).requires_grad_()
        p = torch.tensor([POWER], requires_grad=True)
        lm = r(a, p)
        torch.sum(lm * w).backward()
        res[splat] = (lm.detach(), a.grad, p.grad)
    f, i8 = res["inkernel"], res["inkernel_i8"]
    assert f[1].abs().sum().item() > 0
    assert torch.equal(f[1], i8[1]) and torch.equal(f[2], i8[2])
    assert not torch.equal(f[0], i8[0])
    np.testing.assert_allclose(f[0].sum().item(), i8[0].sum().item(),
                               rtol=2e-3)
    for a, b in (("fused", "inkernel"), ("fused_i8", "inkernel_i8")):
        assert all(torch.equal(x, y) for x, y in zip(res[a], res[b]))


# --------------------------------------------------------------------------
# the routes through the CLI
# --------------------------------------------------------------------------
@pytest.mark.parametrize("flags", [
    ["--splat", "inkernel"],
    ["--no-device-rng"],
    ["--no-device-rng", "--splat", "inkernel"],
])
def test_cli_renders_the_inkernel_routes(flags, tmp_path):
    out = tmp_path / "out"
    assert cli.main(["render", TINY, "30", "--device", "cpu",
                     "--samples-per-area", "3000", "--photons-per-batch",
                     "1024", *flags, "--out", str(out)]) == 0
    scene, _ = compile_scene(TINY, 30.0, DEFAULT_CONFIG)
    assert len(list((out / "tiles").glob("tile_*.png"))) == len(scene.walls)


@pytest.fixture(scope="module")
def target_tiles(tmp_path_factory):
    out = tmp_path_factory.mktemp("target")
    assert cli.main(["render", TINY, "30", "--device", "cpu",
                     "--samples-per-area", "1300", "--photons-per-batch",
                     "384", "--dump-raw", "--out", str(out)]) == 0
    return out / "tiles"


@pytest.mark.parametrize("splat", ["inkernel", "fused", "fused_i8"])
def test_cli_fits_on_the_inkernel_tiers(splat, target_tiles, tmp_path):
    out = tmp_path / "fit"
    assert cli.main(["fit", TINY, str(target_tiles), "30", "--device", "cpu",
                     "--samples-per-area", "1300", "--photons-per-batch",
                     "384", "--splat", splat, "--fit-steps", "2",
                     "--fit-init-albedo", "0.7", "--out", str(out)]) == 0
    assert (out / "fitted.json").exists()
