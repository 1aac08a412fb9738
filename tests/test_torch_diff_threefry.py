"""The port's differentiable render with the threefry draws and its
deposit-stream tier, against the JAX package.

The tiers of `make_diff_renderer_wide` that draw jax.random's threefry
uniforms: the in-kernel tiers without the device RNG (`fit
--no-device-rng`: forward trace_splat_wide_diff with the 7-bit or the f32
splat, backward trace_fold_wide) and the deposit-stream tier (`fit --splat
scatter|bucket|bucket_exact`: trace_deposits_wide_diff in both passes, the
stream splat forward, an XLA fold backward), which draws threefry under
either device_rng setting. Scene `tiny` (13 rects, one window of 376 photons
at 1300 samples per m^2), 384-photon batches, one batch live. The JAX side
runs in Pallas interpret mode with sublanes=1, as tests/test_diff.py runs
it, at unroll=1 (the rolled rect loop tests the rects in the unrolled
loop's order, so the bits are the same, and interpret mode compiles it in
less time); the port runs the plain PyTorch versions (the path CPU tensors
take). Tables come through flatmatch_tpu_torch.interop; albedo, uniforms
and cotangents from numpy seeds. The JAX runs are module-scoped fixtures,
shared by the tests; an interpret-mode kernel takes 8-9 s here, so each
runs once:
- row 6 runs alone on numpy uniforms with N_VALID 300 live photons;
- the three JAX renderers run on their one live batch (the threefry
  uniforms of global batch 0, 376 photons). Their forward and backward ARE
  rows 7 (i8 and f32) and 9 of that batch, called by
  make_diff_renderer_wide with _make_scale_pair's grid and
  cotangent_t(g): the port's row-7 and row-9 wrappers are held against
  them directly, then the port's renderers against the whole renderers.

Tolerances and why:
- row 6 (the diff stream): ids and slots are integer work, equal on every
  row; colors to 1e-6 (the same f32 operations in the same order).
- row 7: >= 99% of cells equal and the energy within 1e-3, the criterion of
  tests/test_torch_diff.py (a last-ulp sin/cos difference between XLA and
  torch could split a path); the 7-bit cells compare as integers, the f32
  cells at rtol 1e-5, atol 1e-5 (bf16 colors summed in another f32 order,
  the MXU contraction against index_add_: tests/test_torch_inkernel.py).
- row 9 (the fold): rtol 1e-4, for the order of the f32 sums
  (tests/test_torch_diff.py).
- whole renderers: lightmap texels equal for >= 99% and in total to 1e-5;
  gradients of sum(lm * w) at rtol 1e-4. The f32 tier's gradients are the
  7-bit tier's bit for bit (one fold replays exact colors for both, in both
  packages), so its JAX renderer runs the forward only.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from flatmatch_tpu.config import PhotonConfig as JaxPhotonConfig
from flatmatch_tpu.diff.render import _make_scale_pair
from flatmatch_tpu.diff.render import (
    make_diff_renderer_wide as jax_make_diff_renderer_wide,
)
from flatmatch_tpu.engines import photon_pallas, photon_pallas_wide as jw
from flatmatch_tpu.engines.schedule import emitter_slice
from flatmatch_tpu.ops.aa_scene import pack_aa as jax_pack_aa
from flatmatch_tpu.ops.device_scene import (
    pack_emitters as jax_pack_em, pack_rects as jax_pack_rects,
)
from flatmatch_tpu.scene import geometry, image as im, layout
from flatmatch_tpu_torch import cli, interop
from flatmatch_tpu_torch.config import PhotonConfig
from flatmatch_tpu_torch.diff import render as prender
from flatmatch_tpu_torch.engines import photon_wide as pw
from flatmatch_tpu_torch.ops import splat as psplat, threefry
from tests.conftest import FIXTURES

f32 = np.float32
B = 384
N_VALID = 300
U = 28             # 4 + 3 * max_depth
SPA = 1300.0
POWER = f32(1.3)
TINY = str(FIXTURES / "tiny.png")
KW = dict(samples_per_area=SPA, photons_per_batch=B, seed=5,
          splat="inkernel_i8", device_rng=False)
JCFG = JaxPhotonConfig(**KW)
CFG = PhotonConfig(**KW)
N_LIVE = 376       # tiny's window photons: the renderers' one batch
# the JAX kernels of these tiers, at unroll=1 (see the module docstring)
ROLLED = ("trace_deposits_wide_diff", "trace_splat_wide_diff",
          "trace_fold_wide")


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
    img = im.load_layout(TINY)
    scene = geometry.Scene(layout.parse_layout(img, f32(1) / f32(30), 200.0))
    aa = jax_pack_aa(scene.walls)
    em = jax_pack_em(scene, SPA, JCFG.window_color, JCFG.light_color)
    aa_c, total_c, _ = jw.compact_aa(aa, scene.num_texels)
    n = aa_c.fields.shape[1]
    rs = np.random.RandomState(17)
    ev = photon_pallas.emitter_vector(emitter_slice(em, 0)).at[
        :, 12:15].mul(POWER)
    return dict(
        scene=scene, aa=aa, em=em, aa_c=aa_c, total_c=total_c, n=n, ev=ev,
        pev=torch.from_numpy(np.array(ev, f32).reshape(16)),
        port_aa=interop.from_jax_aa(np.asarray(aa.fields), aa.group_counts,
                                    aa.perm),
        port_aa_c=interop.from_jax_aa(np.asarray(aa_c.fields),
                                      aa_c.group_counts, aa_c.perm),
        port_em=interop.from_jax_emitters(*(np.asarray(x) for x in em)),
        rects=jax_pack_rects(scene.walls),
        albedo=(0.5 + 0.45 * rs.rand(n)).astype(f32),
        u=rs.rand(B, U).astype(f32),
        g=rs.rand(total_c, 3).astype(f32),
        w=(rs.rand(scene.num_texels, 3) ** 2).astype(f32))


def _rolled(name):
    return functools.partial(getattr(jw, name), unroll=1)


@pytest.fixture(scope="module")
def jax_stream(t):
    """Row 6 of the JAX package on one batch of numpy uniforms, called as
    the stream-tier renderer calls it (its config, an int32 n_valid, the
    block height positional), so the renderer reuses its trace."""
    cfg = JaxPhotonConfig(**dict(KW, splat="scatter", device_rng=True))
    with pltpu.force_tpu_interpret_mode():
        stream = _rolled("trace_deposits_wide_diff")(
            t["aa_c"].fields, jnp.asarray(t["albedo"]), t["ev"],
            jnp.asarray(t["u"]), jnp.int32(N_VALID), cfg,
            t["aa_c"].group_counts, 1)
    return [np.asarray(x) for x in stream]


def _port(t):
    f, gc = t["port_aa_c"].fields, t["port_aa_c"].group_counts
    return f, gc, torch.from_numpy(t["albedo"]), torch.from_numpy(t["u"])


def test_row6_diff_stream_matches_jax(t, jax_stream):
    f, gc, alb, u = _port(t)
    before = pw.trace_deposits_wide_diff.launches
    idx, col, ridx = pw.trace_deposits_wide_diff(f, gc, alb, t["pev"],
                                                 u.t().contiguous(), N_VALID,
                                                 CFG, block=128)
    assert pw.trace_deposits_wide_diff.launches == before   # plain
    jidx, jcol, jridx = jax_stream
    assert idx.shape == (B * 8,) and ridx.dtype == torch.int32
    assert jcol.sum() > 0 and (jridx >= 0).sum() > 100
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(ridx.numpy(), jridx)
    np.testing.assert_allclose(col.numpy(), jcol, rtol=1e-6, atol=0)
    # the wrapper on the [U, B] uniforms is the plain version on [B, U]
    again = pw.trace_deposits_wide_diff_plain(f, gc, alb, t["pev"], u,
                                              N_VALID, CFG, 128)
    assert all(torch.equal(a, b) for a, b in zip(again, (idx, col, ridx)))


@pytest.fixture(scope="module")
def renderers(t):
    """The JAX and port renderers of the three tiers; the JAX ones built
    with the rolled kernels."""
    out = {}
    with pytest.MonkeyPatch.context() as mp, \
            pltpu.force_tpu_interpret_mode():
        for name in ROLLED:
            mp.setattr(jw, name, _rolled(name))
        for splat, device_rng in (("inkernel_i8", False),
                                  ("inkernel", False), ("scatter", True)):
            kw = dict(KW, splat=splat, device_rng=device_rng)
            jr = jax_make_diff_renderer_wide(
                t["rects"], t["em"], t["scene"].num_texels,
                JaxPhotonConfig(**kw), t["aa"], sublanes=1)
            pr = prender.make_diff_renderer_wide(
                t["port_em"], t["scene"].num_texels, PhotonConfig(**kw),
                t["port_aa"])
            out[splat] = (jr, pr)
    return out


def _params(t):
    albedo = np.random.RandomState(11).uniform(0.6, 0.95, t["n"])
    return albedo.astype(f32), np.array([1.3], f32)


def _port_grads(pr, w, albedo, power):
    a = torch.from_numpy(np.array(albedo, f32)).requires_grad_()
    p = torch.from_numpy(np.array(power, f32)).requires_grad_()
    lm = pr(a, p)
    torch.sum(lm * torch.from_numpy(w)).backward()
    return lm.detach().numpy(), a.grad.numpy(), p.grad.numpy()


@pytest.fixture(scope="module")
def jax_renders(t, renderers):
    """Lightmap and gradients of sum(lm * w) of each JAX renderer (the f32
    tier: the lightmap only)."""
    albedo, power = _params(t)
    out = {}
    with pltpu.force_tpu_interpret_mode():
        for splat, (jr, _) in renderers.items():
            if splat == "inkernel":
                out[splat] = (np.asarray(jr(jnp.asarray(albedo),
                                            jnp.asarray(power))), None, None)
                continue
            lm, vjp_fn = jax.vjp(jr, jnp.asarray(albedo), jnp.asarray(power))
            ga, gp = vjp_fn(jnp.asarray(t["w"]))
            out[splat] = (np.asarray(lm), np.asarray(ga), np.asarray(gp))
    return out


def _batch0(t, pr, albedo, power):
    """The port renderer's one batch: its albedo per slot, scaled emitter
    vector, grid, compact table and threefry uniforms."""
    (e, gb, nv, bsz), = pr.batches
    assert (e, gb, nv, bsz) == (0, 0, N_LIVE, B)
    alb = torch.from_numpy(albedo)[pr.perm].contiguous()
    ev, grid = pr.emitter_grid(e, torch.from_numpy(power), alb)
    u = threefry.batch_uniforms(CFG.seed, gb, bsz, U, transposed=True)
    return alb, ev, grid, pr.aa_c.fields, pr.aa_c.group_counts, u


@pytest.mark.parametrize("i8", [True, False])
def test_row7_diff_forward_matches_jax(t, renderers, jax_renders, i8):
    """The port's row-7 wrappers against JAX's trace_splat_wide_diff as
    its renderer calls it on the one live batch (the renderer's lightmap
    is that call's output, expanded)."""
    splat = "inkernel_i8" if i8 else "inkernel"
    pr = renderers[splat][1]
    albedo, power = _params(t)
    alb, ev, grid, f, gc, u = _batch0(t, pr, albedo, power)
    want = jax_renders[splat][0][pr.arena_pos.numpy()]   # compact arena
    before = (pw.trace_splat_wide_diff_i8.launches,
              pw.trace_splat_wide_diff_f32.launches)
    if i8:
        scale, inv = grid
        got = pw.trace_splat_wide_diff_i8(f, gc, alb, ev, u, N_LIVE, CFG,
                                          pr.total_c, inv).numpy()
        lm = want
        want = np.rint(lm / scale.item()).astype(np.int64)
        np.testing.assert_array_equal(want.astype(f32) * scale.item(), lm)
        same = got == want
    else:
        got = pw.trace_splat_wide_diff_f32(f, gc, alb, ev, u, N_LIVE, CFG,
                                           pr.total_c, grid).numpy()
        same = np.isclose(got, want, rtol=1e-5, atol=1e-5)
    assert before == (pw.trace_splat_wide_diff_i8.launches,
                      pw.trace_splat_wide_diff_f32.launches)     # plain
    assert want.sum() > 0
    assert same.mean() >= 0.99
    np.testing.assert_allclose(got.sum(), want.sum(), rtol=1e-3)


def test_row9_fold_matches_jax(t, renderers, jax_renders):
    """The port's row-9 wrapper against JAX's trace_fold_wide as the 7-bit
    renderer's backward calls it on the one live batch with g = w: the
    renderer returns da / albedo per rect and w_sum / power."""
    pr = renderers["inkernel_i8"][1]
    albedo, power = _params(t)
    alb, ev, _, f, gc, u = _batch0(t, pr, albedo, power)
    g_c = torch.from_numpy(t["w"])[pr.arena_pos].contiguous()
    before = pw.trace_fold_wide.launches
    da, w_sum = pw.trace_fold_wide(f, gc, alb, ev, g_c, u, N_LIVE, CFG,
                                   t["n"])
    assert pw.trace_fold_wide.launches == before              # plain
    _, ga, gp = jax_renders["inkernel_i8"]
    want = ga[pr.perm.numpy()] * alb.numpy()
    assert (want > 0).sum() >= 5
    np.testing.assert_allclose(da.numpy(), want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(w_sum.item(), gp[0] * power[0], rtol=1e-4)
    # the wrapper on the [U, B] uniforms is the plain fold on [B, U]
    again = pw.fold_plain(*pw.trace_uniforms_plain(
        f, gc, ev, u.t(), N_LIVE, CFG, alb), g_c, t["n"])
    assert torch.equal(again[0], da) and torch.equal(again[1], w_sum)


@pytest.mark.parametrize("splat", ["inkernel_i8", "inkernel", "scatter"])
def test_renderer_matches_jax(t, renderers, jax_renders, splat):
    pr = renderers[splat][1]
    assert not pr.device_rng and pr.stream == (splat == "scatter")
    albedo, power = _params(t)
    launches = (pw.trace_splat_wide_diff_i8.launches,
                pw.trace_splat_wide_diff_f32.launches,
                pw.trace_fold_wide.launches,
                pw.trace_deposits_wide_diff.launches,
                threefry.uniform.launches)
    plm, pga, pgp = _port_grads(pr, t["w"], albedo, power)
    assert launches == (pw.trace_splat_wide_diff_i8.launches,
                        pw.trace_splat_wide_diff_f32.launches,
                        pw.trace_fold_wide.launches,
                        pw.trace_deposits_wide_diff.launches,
                        threefry.uniform.launches)    # plain versions
    lm, ga, gp = jax_renders[splat]
    assert plm.shape == lm.shape and lm.sum() > 0
    assert np.isclose(plm, lm, rtol=1e-6, atol=0).mean() >= 0.99
    np.testing.assert_allclose(plm.sum(), lm.sum(), rtol=1e-5)
    if splat == "inkernel":
        # one fold for both in-kernel tiers: the 7-bit tier's gradients
        _, ga, gp = jax_renders["inkernel_i8"]
        _, pga8, pgp8 = _port_grads(renderers["inkernel_i8"][1], t["w"],
                                    albedo, power)
        np.testing.assert_array_equal(pga, pga8)
        np.testing.assert_array_equal(pgp, pgp8)
    assert np.abs(ga).sum() > 0
    np.testing.assert_allclose(pga, ga, rtol=1e-4,
                               atol=1e-6 * np.abs(ga).max())
    np.testing.assert_allclose(pgp, gp, rtol=1e-4)


@pytest.mark.parametrize("splat,device_rng", [
    ("inkernel_i8", False), ("inkernel", False), ("scatter", True),
    ("bucket", False),
])
def test_tail_shrink_bit_identical(t, splat, device_rng):
    """Lightmap and gradients with the tail batch shrunk or not, at
    1536-photon batches: the threefry tiers draw only the first rows of the
    full batch's uniforms (256-photon blocks), the stream tier keeps whole
    512-photon diff blocks, and both passes stop at the last block with a
    live photon, so nothing changes."""
    cfg = dataclasses.replace(CFG, photons_per_batch=1536, splat=splat,
                              device_rng=device_rng)
    runs = []
    for shrink in (True, False):
        r = prender.make_diff_renderer_wide(
            t["port_em"], t["scene"].num_texels, cfg, t["port_aa"],
            tail_shrink=shrink)
        assert [b[3] for b in r.batches] == [512 if shrink else 1536]
        runs.append(_port_grads(r, t["w"], t["albedo"], np.ones(1, f32)))
    (lm_s, ga_s, gp_s), (lm_f, ga_f, gp_f) = runs
    assert lm_s.sum() > 0 and np.abs(ga_s).sum() > 0
    np.testing.assert_array_equal(lm_s, lm_f)
    np.testing.assert_array_equal(ga_s, ga_f)
    np.testing.assert_array_equal(gp_s, gp_f)


def test_diff_block_is_the_jax_renderers_block():
    """S = 32 halved until S * 128 divides the batch
    (diff/render.py:371-377)."""
    for batch, want in ((131072, 4096), (384, 128), (1536, 512),
                        (1024, 1024), (3 * 4096, 4096)):
        assert prender.diff_block(batch) == want


def test_stream_tier_fixed_point_scale_covers_power(t):
    """The stream tier's splat scale at power 4 is fixed_point_scale of the
    stream bound times corr = 4: two binary orders below power 1's."""
    cfg = dataclasses.replace(CFG, splat="scatter")
    r = prender.make_diff_renderer_wide(t["port_em"], t["scene"].num_texels,
                                        cfg, t["port_aa"])
    alb = torch.full((t["n"],), f32(0.8))
    _, bound4 = r.emitter_grid(0, torch.tensor([4.0]), alb)
    bound = psplat.stream_bound(dataclasses.replace(cfg,
                                                    photons_per_batch=r.B))
    fixed = psplat.fixed_point_scale(bound4)
    want = psplat.fixed_point_scale(bound, torch.tensor([4.0]))
    assert bound4 == 4 * bound and list(fixed) == want.tolist()
    _, bound1 = r.emitter_grid(0, torch.tensor([1.0]), alb)
    fixed1 = psplat.fixed_point_scale(bound1)
    assert bound1 == bound
    assert [f32(x) for x in fixed1] == [f32(x) for x in
                                        psplat.fixed_point_scale(bound)]
    assert fixed1[0] == 4 * fixed[0]


def test_stream_fold_is_the_jax_fold_with_unrounded_g(t):
    """`stream_fold` on the row-6 stream against the fold written out as
    JAX writes it (diff/render.py:488-500), with g unrounded: bf16 rounding
    of g would move da by far more than the f32 order."""
    f, gc, alb, u = _port(t)
    idx, col, ridx = pw.trace_deposits_wide_diff(f, gc, alb, t["pev"],
                                                 u.t().contiguous(), N_VALID,
                                                 CFG, block=128)
    g = torch.from_numpy(t["g"])
    da, w_sum = prender.stream_fold(idx, col, ridx, g, t["n"], 128, 8)
    w = (g[idx.long()].double() * col.double()).sum(-1)
    suf = w.reshape(-1, 8, 128).flip(1).cumsum(1).flip(1).reshape(-1)
    hit = ridx >= 0
    want = torch.zeros(t["n"], dtype=torch.float64).index_add_(
        0, ridx[hit].long(), suf[hit])
    np.testing.assert_allclose(da.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-7 * want.abs().max().item())
    np.testing.assert_allclose(w_sum.item(), w.sum().item(), rtol=1e-6)
    rounded, _ = pw.fold_plain(*pw.trace_uniforms_plain(
        f, gc, t["pev"], u, N_VALID, CFG, alb), g, t["n"])
    assert not torch.equal(rounded, da)


@pytest.fixture(scope="module")
def target_tiles(tmp_path_factory):
    out = tmp_path_factory.mktemp("target")
    assert cli.main(["render", TINY, "30", "--device", "cpu",
                     "--samples-per-area", str(SPA), "--photons-per-batch",
                     str(B), "--dump-raw", "--out", str(out)]) == 0
    return out / "tiles"


@pytest.mark.parametrize("flags", [["--no-device-rng"],
                                   ["--splat", "scatter"]])
def test_fit_cli_runs_the_threefry_routes(flags, target_tiles, tmp_path):
    tiles = target_tiles
    out = tmp_path / "fit"
    assert cli.main(["fit", TINY, str(tiles), "30", "--device", "cpu",
                     "--samples-per-area", str(SPA), "--photons-per-batch",
                     str(B), "--fit-steps", "2", "--fit-init-albedo", "0.7",
                     *flags, "--out", str(out)]) == 0
    rep = json.loads((out / "fitted.json").read_text())
    assert rep["steps"] == 2 and len(rep["albedo"]) == 13
    assert np.isfinite(rep["initial_loss"]) and np.isfinite(rep["final_loss"])
    assert rep["final_loss"] < rep["initial_loss"]
