"""The port's general differentiable renderer (diff/render.make_diff_renderer,
make_autodiff_oracle) and the fit of a scene without an axis-aligned table,
against the JAX package.

Scene `tiny` and `tiny` turned 30 degrees about z (chip_smoke.rotated_scene),
2000 samples per m^2 (one window of 578 photons: two 512-photon batches),
seed 5, test_diff.py's configuration. Both packages read identical tables
(the port's are carried across from the JAX package's arrays by
flatmatch_tpu_torch.interop), draw the same threefry uniforms and run on
the CPU, where the port's nearest hit is its plain version.

Tolerances and why:
- at albedo 0.9 and power 1 the forward must equal the general engine's
  render_photons bit for bit (the same batches, draws and f32 splat);
- the forward against JAX's make_diff_renderer at the general trace's bands
  of tests/test_torch_general.py (>= 99.9% of cells within rtol 1e-3, atol
  1e-2; total within 1e-4): only a last-ulp sin/cos/rsqrt difference
  between XLA and torch can split a path;
- replay gradients against the port's autograd oracle at test_diff.py's
  bands (rtol 1e-4, atol 1e-2; power rtol 1e-4): the same deposits, the
  per-rect sums in another f32 order;
- gradients against JAX's jax.grad of the same loss: the power gradient at
  rtol 1e-3 and the albedo gradient within rtol 1e-3 plus atol of 1e-3 of
  its largest entry. A split path moves the weighted deposits of one
  photon, about 1/500 of an emitter's; measured on this CPU build, every
  entry agreed to 2.2e-7 relative at both angles (no path split);
- central differences at the three largest albedo entries and power[0] at
  rtol 5e-2, power linearity (one emitter: dL/dp * p = L) at rtol 1e-5,
  test_diff.py's bands;
- a power-only fit_materials(aa=None) of rotated tiny recovers the powers
  to rtol 0.01 (test_diff.py's fit);
- three Adam steps from the JAX fit's parameters (interop.
  fit_params_from_jax, which carries the general [N_pad] albedo logits as
  it carries the wide renderer's) against a JAX loop of optax.adam over its
  renderer: losses at rtol 1e-4, parameters at rtol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import rotated_scene
from flatmatch_tpu.config import PhotonConfig as JaxPhotonConfig
from flatmatch_tpu.diff.render import make_diff_renderer as jax_make_diff
from flatmatch_tpu.ops.device_scene import (
    pack_emitters as jax_pack_em, pack_rects as jax_pack_rects,
)
from flatmatch_tpu.scene import geometry, image as im, layout
from flatmatch_tpu_torch import interop
from flatmatch_tpu_torch.config import PhotonConfig
from flatmatch_tpu_torch.diff import fit as pfit
from flatmatch_tpu_torch.diff import render as prender
from flatmatch_tpu_torch.engines import photon
from flatmatch_tpu_torch.ops import intersect
from tests.conftest import FIXTURES

f32 = np.float32
KW = dict(samples_per_area=2000.0, photons_per_batch=512, seed=5)
JCFG = JaxPhotonConfig(**KW)
CFG = PhotonConfig(**KW)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: the tensors are small, and the
    parallel test workers do not oversubscribe the cores they share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[0, 30], ids=lambda d: f"deg{d}")
def t(request):
    deg = request.param
    img = im.load_layout(str(FIXTURES / "tiny.png"))
    scene = rotated_scene(geometry.Scene(layout.parse_layout(
        img, f32(1.0) / f32(30.0), 200.0)), deg)
    jrects = jax_pack_rects(scene.walls)
    jem = jax_pack_em(scene, CFG.samples_per_area, CFG.window_color,
                      CFG.light_color)
    rects = interop.from_jax_rects(*(np.asarray(x) for x in jrects))
    em = interop.from_jax_emitters(*(np.asarray(x) for x in jem))
    T = scene.num_texels
    n, n_em = rects.n.shape[0], len(em.counts)
    w = (np.random.RandomState(0).normal(size=(T, 3)) ** 2).astype(f32)
    return dict(
        deg=deg, scene=scene, jrects=jrects, jem=jem, rects=rects, em=em,
        T=T, n=n, n_em=n_em, w=w,
        albedo0=np.full((n,), f32(CFG.albedo)),
        power0=np.ones((n_em,), f32),
        render=prender.make_diff_renderer(rects, em, T, CFG),
        oracle=prender.make_autodiff_oracle(rects, em, T, CFG),
        jrender=jax_make_diff(jrects, jem, T, JCFG),
    )


def _grads(fn, w, albedo, power):
    a = torch.from_numpy(np.array(albedo, f32)).requires_grad_()
    p = torch.from_numpy(np.array(power, f32)).requires_grad_()
    lm = fn(a, p)
    loss = torch.sum(lm * torch.from_numpy(w))
    loss.backward()
    return lm.detach().numpy(), a.grad.numpy(), p.grad.numpy(), loss.item()


def _loss(t, albedo, power):
    with torch.no_grad():
        lm = t["render"](torch.from_numpy(np.array(albedo, f32)),
                         torch.from_numpy(np.array(power, f32)))
    return float(torch.sum(lm * torch.from_numpy(t["w"])).double())


def test_schedule_is_jax_emitter_batches(t):
    """The renderer's schedule is JAX's _emitter_batches, every batch at
    the full batch size."""
    from flatmatch_tpu.diff.render import _emitter_batches
    from flatmatch_tpu_torch.engines import photon_wide as pw

    counts = np.asarray(t["em"].counts)
    assert t["render"].schedule == _emitter_batches(counts, 512)
    assert pw.emitter_schedule([0, 1024, 5], 512) == _emitter_batches(
        [0, 1024, 5], 512) == [(1, 0, 2, 512), (2, 2, 1, 5)]
    r = prender.make_diff_renderer(t["rects"], t["em"]._replace(
        counts=np.array([1100])), t["T"], CFG)
    assert list(r.batches()) == [(0, 0, 512), (0, 1, 512), (0, 2, 76)]


def test_forward_equals_render_photons_bit_for_bit(t):
    before = intersect.nearest_hit.launches
    got = t["render"](torch.from_numpy(t["albedo0"]),
                      torch.from_numpy(t["power0"]))
    want = photon.render_photons(t["rects"], t["em"], t["T"], CFG)
    assert intersect.nearest_hit.launches == before     # plain version
    assert want.sum() > 0
    assert torch.equal(got, want)


def test_forward_matches_jax(t):
    rs = np.random.RandomState(2)
    albedo = rs.uniform(0.5, 0.95, t["n"]).astype(f32)
    power = np.array([1.3], f32)[:t["n_em"]]
    want = np.asarray(t["jrender"](jnp.asarray(albedo), jnp.asarray(power)))
    with torch.no_grad():
        got = t["render"](torch.from_numpy(albedo),
                          torch.from_numpy(power)).numpy()
    assert want.sum() > 0
    close = np.isclose(got, want, rtol=1e-3, atol=1e-2)
    assert close.mean() > 0.999, f"only {close.mean():.4%} match"
    np.testing.assert_allclose(got.sum(), want.sum(), rtol=1e-4)


def test_replay_gradients_match_the_oracle(t):
    lm, ga, gp, _ = _grads(t["render"], t["w"], t["albedo0"], t["power0"])
    olm, oa, op, _ = _grads(t["oracle"], t["w"], t["albedo0"], t["power0"])
    np.testing.assert_allclose(lm, olm, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ga, oa, rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(gp, op, rtol=1e-4)
    assert np.abs(ga).sum() > 0 and np.abs(gp).sum() > 0
    # the padding rows are never hit
    assert (ga[len(t["scene"].walls):] == 0).all()
    # the backward sums in a fixed order: a second pass, the same bits
    _, ga2, gp2, _ = _grads(t["render"], t["w"], t["albedo0"], t["power0"])
    assert np.array_equal(ga, ga2) and np.array_equal(gp, gp2)


def test_gradients_match_jax(t):
    rs = np.random.RandomState(4)
    albedo = rs.uniform(0.6, 0.95, t["n"]).astype(f32)
    power = np.array([1.2], f32)[:t["n_em"]]
    w = jnp.asarray(t["w"])
    ja, jp = (np.asarray(x) for x in jax.grad(
        lambda a, p: jnp.sum(t["jrender"](a, p) * w), argnums=(0, 1))(
        jnp.asarray(albedo), jnp.asarray(power)))
    _, ga, gp, _ = _grads(t["render"], t["w"], albedo, power)
    np.testing.assert_allclose(gp, jp, rtol=1e-3)
    np.testing.assert_allclose(ga, ja, rtol=1e-3,
                               atol=1e-3 * np.abs(ja).max())


def test_gradients_match_finite_differences(t):
    _, ga, gp, _ = _grads(t["render"], t["w"], t["albedo0"], t["power0"])
    h = 1e-2
    for i in np.argsort(-np.abs(ga))[:3]:
        ap, am = t["albedo0"].copy(), t["albedo0"].copy()
        ap[i] += h
        am[i] -= h
        fd = (_loss(t, ap, t["power0"]) - _loss(t, am, t["power0"])) / (2 * h)
        np.testing.assert_allclose(ga[i], fd, rtol=5e-2)
    pp, pm = t["power0"].copy(), t["power0"].copy()
    pp[0] += h
    pm[0] -= h
    fd = (_loss(t, t["albedo0"], pp) - _loss(t, t["albedo0"], pm)) / (2 * h)
    np.testing.assert_allclose(gp[0], fd, rtol=5e-2)


def test_power_gradient_is_exact_linearity(t):
    assert t["n_em"] == 1
    _, _, gp, val = _grads(t["render"], t["w"], t["albedo0"], t["power0"])
    np.testing.assert_allclose(gp[0], val, rtol=1e-5)


@pytest.mark.parametrize("t", [30], indirect=True, ids=["deg30"])
def test_fit_power_recovers_exactly(t):
    """test_diff.py's power-only fit on rotated tiny, 100 steps of Adam at
    0.05 (the JAX test's 150 reach the same optimum: the true powers are
    an exact one, the target being rendered with the same seed)."""
    power_true = torch.tensor([1.4])
    with torch.no_grad():
        target = t["render"](torch.from_numpy(t["albedo0"]), power_true)
    res = pfit.fit_materials(
        target.numpy(), t["rects"], t["em"], t["T"], CFG, aa=None,
        steps=100, learning_rate=0.05, fit_albedo=False)
    assert res.albedo.shape == (t["n"],)
    assert res.losses[-1] < 1e-4, res.losses[-1]
    np.testing.assert_allclose(res.power, power_true.numpy(), rtol=0.01)
    np.testing.assert_allclose(res.albedo, CFG.albedo, atol=1e-6)


def test_make_renderer_dispatches_on_the_table(t):
    r = pfit.make_renderer(t["rects"], t["em"], t["T"], CFG, aa=None)
    assert isinstance(r, prender.DiffRenderer)
    with pytest.raises(ValueError):
        pfit.fit_materials(np.zeros((t["T"], 3), f32), None, t["em"], t["T"],
                           CFG, aa=None)


def test_fit_three_adam_steps_match_jax(t):
    """Three steps of a JAX loop of optax.adam over JAX's general renderer
    (fit.py:136-154) against the port's fit_materials(aa=None) started from
    the same parameters, carried across by interop.fit_params_from_jax."""
    jr = t["jrender"]
    rs = np.random.RandomState(5)
    target = np.asarray(jr(jnp.asarray(rs.uniform(0.7, 0.9, t["n"])
                                       .astype(f32)),
                           jnp.asarray(np.array([1.2], f32))))
    a0 = np.full((t["n"],), np.log(0.6 / 0.4), f32)
    p0 = np.full((1,), np.log(0.8), f32)
    norm = jnp.maximum(jnp.mean(jnp.asarray(target) ** 2), 1e-20)

    def loss_fn(params):
        lm = jr(jax.nn.sigmoid(params["a_logit"]), jnp.exp(params["p_log"]))
        return jnp.mean((lm - target) ** 2) / norm

    params = {"a_logit": jnp.asarray(a0), "p_log": jnp.asarray(p0)}
    opt = optax.adam(0.1)
    state = opt.init(params)
    losses = []
    for _ in range(3):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        losses.append(float(loss))
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    res = pfit.fit_materials(
        target, t["rects"], t["em"], t["T"], CFG, aa=None, steps=3,
        learning_rate=0.1, params=interop.fit_params_from_jax(a0, p0))
    assert res.losses.shape == (3,) and losses[2] < losses[0]
    np.testing.assert_allclose(res.losses, losses, rtol=1e-4)
    np.testing.assert_allclose(
        res.albedo, np.asarray(jax.nn.sigmoid(params["a_logit"])), rtol=1e-5)
    np.testing.assert_allclose(
        res.power, np.asarray(jnp.exp(params["p_log"])), rtol=1e-5)


def test_fit_params_from_jax_carries_the_general_parameters(t):
    a = np.random.RandomState(1).normal(size=t["n"]).astype(f32)
    p = np.array([0.25], f32)
    params = interop.fit_params_from_jax(a, p)
    assert params["a_logit"].shape == (t["n"],)
    assert np.array_equal(params["a_logit"].numpy(), a)
    res = pfit.fit_materials(np.ones((t["T"], 3), f32), t["rects"], t["em"],
                             t["T"], CFG, aa=None, steps=0, params=params)
    np.testing.assert_allclose(res.albedo, 1 / (1 + np.exp(-a)), rtol=1e-6)
    np.testing.assert_allclose(res.power, np.exp(p), rtol=1e-6)


def test_cfg_batch_checked(t):
    with pytest.raises(ValueError):
        prender.make_diff_renderer(t["rects"], t["em"], t["T"],
                                   dataclasses.replace(CFG,
                                                       photons_per_batch=0))
