"""The port's differentiable render and fit against the JAX package.

Scene `tiny` (13 rects, one window of 376 photons at 1300 samples per
m^2), 384-photon batches, device RNG, in-kernel 7-bit splat. The JAX side runs
trace_splat_wide_diff_rng(i8=True), trace_fold_wide_rng and
make_diff_renderer_wide in Pallas interpret mode with sublanes=1, as
tests/test_diff.py runs them, at unroll=1 (the rolled rect loop tests the
rects in the unrolled loop's order, so the bits are the same:
flatmatch_tpu/ops/aa_query.resolve_unroll; interpret mode compiles it in
less time); the port runs the plain PyTorch versions (the
path CPU tensors take). Both read identical tables (flatmatch_tpu_torch.
interop); parameters and cotangents are made from numpy seeds.

Tolerances and why:
- forward batch: >= 99% of int32 accumulator cells equal and the energy
  within 1e-3, the criterion of test_torch_photon_wide.py (draws, dither
  keys, ids and integer sums are exact; only a last-ulp sin/cos difference
  between XLA and torch can split a path). On this CPU build all agree.
- at default parameters (albedo 0.9, power 1) the grid is the production
  constant and every albedo the scalar one: the diff forward must equal the
  production plain version bit for bit, per batch and per render.
- scale_pair: equal to JAX's to 1 ulp (both multiply in f32 in the order of
  jax.lax.integer_pow).
- fold: da and w_sum at rtol 1e-4. g's one bf16 rounding is the same on
  both sides; the f32 sums run in another order (an MXU one-hot dot and
  dw.sum() against index_add_ and a sum), about 1e-6 relative.
- whole renderer: lightmap texels equal for >= 99% and in total to 1e-5;
  gradients of sum(lm * w) at rtol 1e-4, for the fold's reason.
- 3 Adam steps from identical parameters: losses at rtol 1e-4, fitted
  parameters at 1e-5. sigmoid, exp and Adam's update round differently in
  the two frameworks (about 1 ulp in each parameter), which can move a
  dithered 7-bit deposit by one step.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
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
from flatmatch_tpu_torch.diff import fit as pfit
from flatmatch_tpu_torch.diff import render as prender
from flatmatch_tpu_torch.engines import photon_wide as pw
from tests.conftest import FIXTURES

f32 = np.float32
B = 384
N_VALID = 300
SPA = 1300.0
TINY = str(FIXTURES / "tiny.png")
KW = dict(samples_per_area=SPA, photons_per_batch=B, seed=5,
          splat="inkernel_i8", device_rng=True)
JCFG = JaxPhotonConfig(**KW)
CFG = PhotonConfig(**KW)


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
    port_aa = interop.from_jax_aa(np.asarray(aa.fields), aa.group_counts,
                                  aa.perm)
    port_aa_c = interop.from_jax_aa(np.asarray(aa_c.fields),
                                    aa_c.group_counts, aa_c.perm)
    port_em = interop.from_jax_emitters(*(np.asarray(x) for x in em))
    rs = np.random.RandomState(7)
    w = (rs.rand(scene.num_texels, 3) ** 2).astype(f32)
    return dict(scene=scene, aa=aa, em=em, aa_c=aa_c, total_c=total_c, n=n,
                port_aa=port_aa, port_aa_c=port_aa_c, port_em=port_em,
                rects=jax_pack_rects(scene.walls), w=w,
                albedo=(0.5 + 0.45 * rs.rand(n)).astype(f32),
                g=rs.rand(total_c, 3).astype(f32),
                seed=int(jw.batch_seed(JCFG.seed, 1)),
                ev=photon_pallas.emitter_vector(emitter_slice(em, 0)))


@pytest.fixture(scope="module")
def renderers(t):
    with pytest.MonkeyPatch.context() as mp, \
            pltpu.force_tpu_interpret_mode():
        for name in ("trace_splat_wide_diff_rng", "trace_fold_wide_rng"):
            mp.setattr(jw, name, functools.partial(getattr(jw, name),
                                                   unroll=1))
        jr = jax_make_diff_renderer_wide(
            t["rects"], t["em"], t["scene"].num_texels, JCFG, t["aa"],
            sublanes=1)
    pr = prender.make_diff_renderer_wide(t["port_em"], t["scene"].num_texels,
                                         CFG, t["port_aa"])
    return jr, pr


def _scaled_ev(t, power):
    ev = t["ev"].at[:, 12:15].mul(f32(power))
    return ev, torch.from_numpy(np.array(ev, f32).reshape(16))


def test_diff_forward_batch_matches_jax(t):
    power = f32(1.7)
    ev, pev = _scaled_ev(t, power)
    alb = t["albedo"]
    scale, inv_scale = _make_scale_pair(JCFG, JCFG.max_depth)(
        0, jnp.asarray(alb), jnp.asarray([power]))
    with pltpu.force_tpu_interpret_mode():
        lm = np.asarray(jw.trace_splat_wide_diff_rng(
            t["aa_c"].fields, jnp.asarray(alb), ev, t["seed"], N_VALID, JCFG,
            t["aa_c"].group_counts, t["total_c"], B, 1, unroll=1, i8=True,
            scale=scale, inv_scale=inv_scale))
    p_scale, p_inv = prender.scale_pair(CFG, torch.tensor(power),
                                        torch.from_numpy(alb))
    f, gc = t["port_aa_c"].fields, t["port_aa_c"].group_counts
    before = pw.trace_splat_wide_diff_rng_i8.launches
    acc = pw.trace_splat_wide_diff_rng_i8(
        f, gc, torch.from_numpy(alb), pev, t["seed"], N_VALID, B, CFG,
        t["total_c"], p_inv).numpy()
    assert pw.trace_splat_wide_diff_rng_i8.launches == before  # plain
    want = np.rint(lm / f32(scale)).astype(np.int64)
    np.testing.assert_array_equal(want.astype(f32) * f32(scale), lm)
    assert acc.sum() > 0
    assert (acc == want).mean() >= 0.99
    np.testing.assert_allclose(acc.sum(), want.sum(), rtol=1e-3)
    # the plain lightmap increment gives JAX's wherever the cells agree
    idx, col, _ = pw.trace_deposits_rng_plain(
        f, gc, pev, t["seed"], N_VALID, B, CFG, torch.from_numpy(alb))
    got = pw.splat_diff_i8_plain(idx, col, t["total_c"], p_inv,
                                 p_scale).numpy()
    np.testing.assert_array_equal(got[acc == want], lm[acc == want])


def test_diff_forward_at_defaults_equals_production(t):
    """Per batch and per render, at albedo 0.9 and power 1."""
    f, gc = t["port_aa_c"].fields, t["port_aa_c"].group_counts
    _, pev = _scaled_ev(t, 1.0)
    alb = torch.full((t["n"],), f32(CFG.albedo))
    _, p_inv = prender.scale_pair(CFG, torch.tensor(f32(1.0)), alb)
    prod = pw.trace_splat_wide_rng_i8(f, gc, pev, t["seed"], N_VALID, B, CFG,
                                      t["total_c"])
    diff = pw.trace_splat_wide_diff_rng_i8(f, gc, alb, pev, t["seed"],
                                           N_VALID, B, CFG, t["total_c"],
                                           p_inv)
    assert prod.sum() > 0
    assert torch.equal(prod, diff)
    r = prender.make_diff_renderer_wide(t["port_em"], t["scene"].num_texels,
                                        CFG, t["port_aa"])
    lm = r(torch.full((t["n"],), f32(CFG.albedo)), torch.ones(1))
    want = pw.render_photons(t["port_em"], t["scene"].num_texels, CFG,
                             t["port_aa"])
    assert torch.equal(lm, want)


@pytest.mark.parametrize("power,albedo_max,depth", [
    (1.0, 0.9, 8), (1.7, 0.95, 8), (0.3, 1.2, 8), (-2.5, 1.37, 5),
    (3.1, 1.05, 1),
])
def test_scale_pair_matches_jax(power, albedo_max, depth):
    alb = np.array([0.2, albedo_max, 0.5], f32)
    pw_ = np.array([0.5, power], f32)
    cfg_j = dataclasses.replace(JCFG, max_depth=depth)
    cfg_p = dataclasses.replace(CFG, max_depth=depth)
    js, ji = _make_scale_pair(cfg_j, depth)(1, jnp.asarray(alb),
                                            jnp.asarray(pw_))
    ps, pi = prender.scale_pair(cfg_p, torch.from_numpy(pw_)[1],
                                torch.from_numpy(alb))
    assert ps.dtype == pi.dtype == torch.float32
    np.testing.assert_array_max_ulp(ps.numpy()[0], np.asarray(js), 1)
    np.testing.assert_array_max_ulp(pi.numpy()[0], np.asarray(ji), 1)
    if power <= 1 and albedo_max <= 1:   # the production grid exactly
        assert ps.item() == f32(pw.splat_color_scale(CFG))
        assert pi.item() == f32(1.0 / pw.splat_color_scale(CFG))


@pytest.mark.parametrize("depth", [2, 8])
def test_fold_matches_jax(t, depth):
    jcfg = dataclasses.replace(JCFG, max_depth=depth)
    cfg = dataclasses.replace(CFG, max_depth=depth)
    ev, pev = _scaled_ev(t, 1.3)
    alb, g = t["albedo"], t["g"]
    with pltpu.force_tpu_interpret_mode():
        da, dw = jw.trace_fold_wide_rng(
            t["aa_c"].fields, jnp.asarray(alb), ev,
            jw.cotangent_t(jnp.asarray(g), t["total_c"]), t["seed"], N_VALID,
            jcfg, t["aa_c"].group_counts, t["n"], B, 1, unroll=1)
    f, gc = t["port_aa_c"].fields, t["port_aa_c"].group_counts
    before = pw.trace_fold_wide_rng.launches
    pda, pdw = pw.trace_fold_wide_rng(
        f, gc, torch.from_numpy(alb), pev, torch.from_numpy(g), t["seed"],
        N_VALID, B, cfg, t["n"])
    assert pw.trace_fold_wide_rng.launches == before   # plain version
    assert pda.shape == (t["n"],) and pda.dtype == torch.float32
    da = np.asarray(da)
    assert (da > 0).sum() >= 5
    np.testing.assert_allclose(pda.numpy(), da, rtol=1e-4,
                               atol=1e-6 * np.abs(da).max())
    np.testing.assert_allclose(pdw.item(), float(dw), rtol=1e-4)
    # the plain fold of the plain stream is the wrapper's CPU path
    idx, col, ridx = pw.trace_deposits_rng_plain(
        f, gc, pev, t["seed"], N_VALID, B, cfg, torch.from_numpy(alb))
    assert ((ridx >= -1) & (ridx < t["n"])).all()
    assert (ridx[N_VALID:] == -1).all()        # dead photons hit nothing
    fda, fdw = pw.fold_plain(idx, col, ridx, torch.from_numpy(g), t["n"])
    assert torch.equal(fda, pda) and torch.equal(fdw, pdw)


def _jax_vjp(jr, albedo, power, g):
    """Lightmap and (d_albedo, d_power) of the JAX renderer for the
    cotangent g, or g(lightmap) when g is callable. Every JAX render here
    goes through this one vjp, so interpret mode compiles the renderer once
    per module."""
    with pltpu.force_tpu_interpret_mode():
        lm, vjp_fn = jax.vjp(jr, jnp.asarray(albedo), jnp.asarray(power))
        ga, gp = vjp_fn(jnp.asarray(g(lm) if callable(g) else g))
    return np.asarray(lm), np.asarray(ga), np.asarray(gp)


def _port_grads(pr, w, albedo, power):
    a = torch.from_numpy(np.array(albedo, f32)).requires_grad_()
    p = torch.from_numpy(np.array(power, f32)).requires_grad_()
    lm = pr(a, p)
    loss = torch.sum(lm * torch.from_numpy(w))
    loss.backward()
    return lm.detach().numpy(), a.grad.numpy(), p.grad.numpy(), loss.item()


def test_renderer_matches_jax(t, renderers):
    jr, pr = renderers
    albedo = np.random.RandomState(11).uniform(0.6, 0.95, t["n"]).astype(f32)
    power = np.array([1.3], f32)
    lm, ga, gp = _jax_vjp(jr, albedo, power, t["w"])
    plm, pga, pgp, _ = _port_grads(pr, t["w"], albedo, power)
    assert plm.shape == lm.shape and lm.sum() > 0
    assert np.isclose(plm, lm, rtol=1e-6, atol=0).mean() >= 0.99
    np.testing.assert_allclose(plm.sum(), lm.sum(), rtol=1e-5)
    assert np.abs(ga).sum() > 0
    np.testing.assert_allclose(pga, ga, rtol=1e-4,
                               atol=1e-6 * np.abs(ga).max())
    np.testing.assert_allclose(pgp, gp, rtol=1e-4)


def test_renderer_power_identity(t, renderers):
    """Every deposit is linear in power: sum_e p_e dL/dp_e == L; the only
    slack is the fold's bf16 rounding of g."""
    _, pr = renderers
    _, _, pgp, loss = _port_grads(pr, t["w"], t["albedo"],
                                  np.array([1.3], f32))
    np.testing.assert_allclose(float(pgp[0]) * 1.3, loss, rtol=2e-3)


def test_renderer_tail_shrink_bit_identical(t):
    """Lightmap and gradients with the tail batch shrunk or not: dropped
    photons are dead, so nothing changes (test_diff.py:315)."""
    cfg = dataclasses.replace(CFG, photons_per_batch=1024)
    runs = []
    for shrink in (True, False):
        r = prender.make_diff_renderer_wide(
            t["port_em"], t["scene"].num_texels, cfg, t["port_aa"],
            tail_shrink=shrink)
        assert [b[3] for b in r.batches] == [512 if shrink else 1024]
        runs.append(_port_grads(r, t["w"], t["albedo"], np.ones(1, f32)))
    (lm_s, ga_s, gp_s, _), (lm_f, ga_f, gp_f, _) = runs
    assert lm_s.sum() > 0
    np.testing.assert_array_equal(lm_s, lm_f)
    np.testing.assert_array_equal(ga_s, ga_f)
    np.testing.assert_array_equal(gp_s, gp_f)


def test_batch_rounds_like_jax():
    for b, want in ((512, 512), (1000, 1024), (1, 128), (1 << 17, 1 << 17)):
        cfg = dataclasses.replace(CFG, photons_per_batch=b)
        assert prender.diff_batch_size(cfg) == want


def test_fit_three_adam_steps_match_jax(t, renderers):
    """Three steps of a JAX loop of optax.adam over the JAX renderer (its
    value_and_grad taken as vjp's, fit.py:136-154) against the port's
    fit_materials started from the same parameters."""
    jr, _ = renderers
    rs = np.random.RandomState(5)
    target, _, _ = _jax_vjp(jr, rs.uniform(0.7, 0.9, t["n"]).astype(f32),
                            np.array([1.2], f32), t["w"])
    a0 = np.full((t["n"],), np.log(0.6 / 0.4), f32)
    p0 = np.full((1,), np.log(0.8), f32)
    norm = jnp.maximum(jnp.mean(jnp.asarray(target) ** 2), 1e-20)

    def constrain(params):
        return jax.nn.sigmoid(params["a_logit"]), jnp.exp(params["p_log"])

    params = {"a_logit": jnp.asarray(a0), "p_log": jnp.asarray(p0)}
    opt = optax.adam(0.1)
    state = opt.init(params)
    losses = []
    def loss_cotangent(lm):
        loss, l_vjp = jax.vjp(
            lambda x: jnp.mean((x - target) ** 2) / norm, lm)
        losses.append(float(loss))
        return l_vjp(jnp.float32(1.0))[0]

    for _ in range(3):
        (albedo, power), c_vjp = jax.vjp(constrain, params)
        _, ga, gp = _jax_vjp(jr, albedo, power, loss_cotangent)
        (grads,) = c_vjp((jnp.asarray(ga), jnp.asarray(gp)))
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    res = pfit.fit_materials(
        target, None, t["port_em"], t["scene"].num_texels, CFG,
        aa=t["port_aa"], steps=3, learning_rate=0.1,
        params=interop.fit_params_from_jax(a0, p0))
    assert res.losses.dtype == np.float64 and res.losses.shape == (3,)
    assert losses[2] < losses[0]
    np.testing.assert_allclose(res.losses, losses, rtol=1e-4)
    np.testing.assert_allclose(
        res.albedo, np.asarray(jax.nn.sigmoid(params["a_logit"])), rtol=1e-5)
    np.testing.assert_allclose(
        res.power, np.asarray(jnp.exp(params["p_log"])), rtol=1e-5)


def test_fit_power_recovers_exactly(t):
    """Power-only fit to a target rendered at known powers with the same
    seed: the true powers are an exact optimum (test_diff.py:530)."""
    r = prender.make_diff_renderer_wide(t["port_em"], t["scene"].num_texels,
                                        CFG, t["port_aa"])
    power_true = torch.tensor([1.4])
    target = r(torch.full((t["n"],), f32(CFG.albedo)), power_true)
    res = pfit.fit_materials(
        target.numpy(), None, t["port_em"], t["scene"].num_texels, CFG,
        aa=t["port_aa"], steps=150, learning_rate=0.05, fit_albedo=False)
    assert res.losses[-1] < 1e-4, res.losses[-1]
    np.testing.assert_allclose(res.power, power_true.numpy(), rtol=0.01)
    np.testing.assert_allclose(res.albedo, CFG.albedo, atol=1e-6)


def test_fit_materials_joint(t):
    """Joint albedo and power fit: the loss collapses and the fitted render
    explains the target (test_diff.py:553)."""
    r = prender.make_diff_renderer_wide(t["port_em"], t["scene"].num_texels,
                                        CFG, t["port_aa"])
    rs = np.random.RandomState(3)
    albedo_true = torch.from_numpy((0.6 + 0.3 * rs.rand(t["n"])).astype(f32))
    target = r(albedo_true, torch.tensor([1.3])).numpy()
    res = pfit.fit_materials(
        target, None, t["port_em"], t["scene"].num_texels, CFG,
        aa=t["port_aa"], steps=120, learning_rate=0.1)
    assert res.losses[-1] < res.losses[0] / 50, (res.losses[0],
                                                 res.losses[-1])
    rel = float(np.mean((res.lightmap - target) ** 2) / np.mean(target ** 2))
    assert rel < 2e-3, rel


def _render_target(tmp_path, scale="30"):
    out = tmp_path / "target"
    assert cli.main(["render", TINY, scale, "--device", "cpu",
                     "--samples-per-area", str(SPA), "--photons-per-batch",
                     str(B), "--dump-raw", "--out", str(out)]) == 0
    return out / "tiles"


def test_fit_layout_rejects_mismatched_target(tmp_path):
    from flatmatch_tpu_torch.config import DEFAULT_CONFIG

    tiles = _render_target(tmp_path)
    cfg = DEFAULT_CONFIG.replace(photon=CFG)
    with pytest.raises(ValueError, match="wall 0"):
        # scale 15 halves the texel grid -> dimension mismatch
        pfit.fit_layout(TINY, str(tiles), 15.0, cfg, steps=1, device="cpu")


def test_fit_cli_writes_report(tmp_path):
    tiles = _render_target(tmp_path)
    out = tmp_path / "fit"
    before = (pw.trace_splat_wide_diff_rng_i8.launches,
              pw.trace_fold_wide_rng.launches)
    assert cli.main(["fit", TINY, str(tiles), "30", "--device", "cpu",
                     "--samples-per-area", str(SPA), "--photons-per-batch",
                     str(B), "--fit-steps", "2", "--fit-init-albedo", "0.7",
                     "--fit-render", str(tmp_path / "fitted_tiles"),
                     "--out", str(out)]) == 0
    assert (pw.trace_splat_wide_diff_rng_i8.launches,
            pw.trace_fold_wide_rng.launches) == before   # plain versions
    rep = json.loads((out / "fitted.json").read_text())
    assert sorted(rep) == ["albedo", "final_loss", "initial_loss", "power",
                           "steps"]
    assert len(rep["albedo"]) == 13 and len(rep["power"]) == 1
    assert rep["steps"] == 2
    assert np.isfinite(rep["initial_loss"]) and np.isfinite(rep["final_loss"])
    assert len(list((tmp_path / "fitted_tiles").glob("tile_*.png"))) == 13


@pytest.mark.parametrize("flags", [
    ["--no-device-rng", "--coordinator", "localhost:1234"],
    ["--engine", "photon_xla"],
    ["--checkpoint", "ck.npz"],
])
def test_fit_cli_refuses_what_the_port_does_not_run(flags, tmp_path, capsys):
    """`fit --splat bucket` and `fit --no-device-rng` run
    (tests/test_torch_diff_threefry.py), and so does `fit --profile`
    (test_fit_cli_runs_what_the_port_runs); multi-host flags and
    checkpoints, which the JAX package's fit ignores, stay refused. `fit
    --engine photon_xla`, once refused, runs: the fit ignores --engine as
    the JAX package's does, so its report is the one without the flag."""
    if "photon_xla" in flags:
        tiles = _render_target(tmp_path)
        reports = []
        for extra in ([], flags):
            out = tmp_path / f"fit{len(extra)}"
            assert cli.main(["fit", TINY, str(tiles), "30", "--device", "cpu",
                             "--samples-per-area", str(SPA),
                             "--photons-per-batch", str(B), "--fit-steps",
                             "2", "--out", str(out), *extra]) == 0
            reports.append((out / "fitted.json").read_bytes())
        assert reports[0] == reports[1]
        assert "ROADMAP.md" not in capsys.readouterr().err
        return
    with pytest.raises(SystemExit) as e:
        cli.main(["fit", TINY, str(tmp_path), "--device", "cpu",
                  "--out", str(tmp_path / "o"), *flags])
    assert e.value.code == 2
    assert "ROADMAP.md" in capsys.readouterr().err
    assert not (tmp_path / "o").exists()


@pytest.mark.parametrize("flags", [
    ["--splat", "bucket", "--profile", "prof"],
])
def test_fit_cli_runs_what_the_port_runs(flags, tmp_path):
    """`fit --profile DIR`, once refused, runs and writes its report and a
    profiler trace of the fit's torch operations."""
    tiles = _render_target(tmp_path)
    prof = tmp_path / "prof"
    flags = [str(prof) if f == "prof" else f for f in flags]
    out = tmp_path / "fit"
    assert cli.main(["fit", TINY, str(tiles), "30", "--device", "cpu",
                     "--samples-per-area", str(SPA), "--photons-per-batch",
                     str(B), "--fit-steps", "1", "--out", str(out),
                     *flags]) == 0
    assert json.loads((out / "fitted.json").read_text())["steps"] == 1
    trace = json.loads((prof / "flatmatch_torch.pt.trace.json").read_text())
    assert any(str(e.get("name")).startswith("aten::")
               for e in trace["traceEvents"])


@pytest.mark.parametrize("change", [dict(splat="scatter"),
                                    dict(device_rng=False)])
def test_fit_library_refuses_what_the_port_does_not_run(t, change):
    """The stream and threefry tiers build (tests/test_torch_diff_threefry.py
    runs them); a fit without an axis-aligned table (aa=None), once
    refused, now runs the general differentiable renderer on the rect
    table under every tier's config (it draws threefry and splats f32,
    whatever the tier, as the JAX package's does), fitting albedo [N_pad]
    (tests/test_torch_diff_general.py holds it against the JAX package)."""
    from flatmatch_tpu_torch.ops.device_scene import pack_rects

    cfg = dataclasses.replace(CFG, **change)
    r = prender.make_diff_renderer_wide(t["port_em"], t["scene"].num_texels,
                                        cfg, t["port_aa"])
    assert r.stream == (cfg.splat == "scatter") and not r.device_rng
    rects = pack_rects(t["scene"].walls)
    T = t["scene"].num_texels
    with torch.no_grad():
        target = prender.make_diff_renderer(rects, t["port_em"], T, cfg)(
            torch.full((rects.n.shape[0],), 0.8), torch.tensor([1.2]))
    res = pfit.fit_materials(target.numpy(), rects, t["port_em"], T, cfg,
                             aa=None, steps=2, init_albedo=0.6)
    assert res.albedo.shape == (rects.n.shape[0],)
    assert res.power.shape == (1,) and res.lightmap.shape == (T, 3)
    assert np.isfinite(res.losses).all() and res.losses[1] < res.losses[0]


def test_diff_wrappers_check_inputs(t):
    f, gc = t["port_aa_c"].fields, t["port_aa_c"].group_counts
    _, ev = _scaled_ev(t, 1.0)
    n, T = t["n"], t["total_c"]
    alb = torch.full((n,), 0.9)
    inv = torch.ones(1)
    g = torch.ones((T, 3))
    with pytest.raises(ValueError):      # albedo row of the wrong length
        pw.trace_splat_wide_diff_rng_i8(f, gc, alb[:-1], ev, 0, 8, 8, CFG,
                                        T, inv)
    with pytest.raises(ValueError):      # float64 albedo
        pw.trace_splat_wide_diff_rng_i8(f, gc, alb.double(), ev, 0, 8, 8,
                                        CFG, T, inv)
    with pytest.raises(ValueError):      # inv_scale of two values
        pw.trace_splat_wide_diff_rng_i8(f, gc, alb, ev, 0, 8, 8, CFG, T,
                                        torch.ones(2))
    with pytest.raises(ValueError):      # g_c not [T, 3]
        pw.trace_fold_wide_rng(f, gc, alb, ev, g[:, :2].contiguous(), 0, 8,
                               8, CFG, n)
    with pytest.raises(ValueError):      # n_slots must be the table's
        pw.trace_fold_wide_rng(f, gc, alb, ev, g, 0, 8, 8, CFG, n + 1)
    with pytest.raises(ValueError):      # n_valid past the batch
        pw.trace_fold_wide_rng(f, gc, alb, ev, g, 0, 9, 8, CFG, n)
    # no live photon: nothing deposited, nothing folded
    acc = pw.trace_splat_wide_diff_rng_i8(f, gc, alb, ev, 0, 0, 256, CFG, T,
                                          inv)
    assert not acc.any()
    da, w_sum = pw.trace_fold_wide_rng(f, gc, alb, ev, g, 0, 0, 256, CFG, n)
    assert not da.any() and w_sum.item() == 0.0
    # the fold's smem check counts the scene, albedo and warp rows
    assert pw.fold_smem_bytes(432, 8) == 4 * (22 * 432 + 2 * 8 * 256)
