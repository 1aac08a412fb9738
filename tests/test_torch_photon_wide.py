"""The port's photon kernel module against the JAX wide kernel.

One 1024-photon batch of `tiny` with the same batch seed goes through the
JAX package's trace_splat_wide_rng(i8=True) and trace_deposits_wide_rng, run
in Pallas interpret mode as the JAX package's own tests run them, and
through the port's plain PyTorch version (the path CPU tensors take). Both
sides read identical scene and emitter tables (flatmatch_tpu_torch.interop).

Tolerances: the draws, dither keys, texel ids and the integer splat are
exact, but XLA's and torch's sin/cos/rsqrt may differ in the last ulp, and
a path that differs once splits from its twin chaotically over the later
bounces. So texel ids must agree for >= 99.9% of deposits at max_depth=2,
and ids, colors and accumulator cells for >= 99% at max_depth=8, with the
batch energy within 1e-3. (On the reference CPU build they agree exactly.)
"""
import dataclasses

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from flatmatch_tpu.config import PhotonConfig
from flatmatch_tpu.engines import photon_pallas, photon_pallas_wide as jw
from flatmatch_tpu.engines.schedule import emitter_slice
from flatmatch_tpu.ops.aa_scene import pack_aa as jax_pack_aa
from flatmatch_tpu.ops.device_scene import pack_emitters as jax_pack_em
from flatmatch_tpu.scene import geometry, image as im, layout
from flatmatch_tpu_torch import interop
from flatmatch_tpu_torch.engines import photon_wide as pw
from tests.conftest import FIXTURES

f32 = np.float32
B = 1024
N_VALID = 1000   # the last 24 photons are dead from the start
CFG = PhotonConfig(samples_per_area=3000.0, photons_per_batch=B, seed=9,
                   splat="inkernel_i8", device_rng=True)


@pytest.fixture(scope="module")
def tables():
    img = im.load_layout(str(FIXTURES / "tiny.png"))
    scene = geometry.Scene(layout.parse_layout(img, f32(1) / f32(30), 200.0))
    aa = jax_pack_aa(scene.walls)
    em = jax_pack_em(scene, CFG.samples_per_area, CFG.window_color,
                     CFG.light_color)
    aa_c, total_c, _ = jw.compact_aa(aa, scene.num_texels)
    ev = photon_pallas.emitter_vector(emitter_slice(em, 0))
    seed = int(jw.batch_seed(CFG.seed, 3))
    port_aa = interop.from_jax_aa(np.asarray(aa_c.fields), aa_c.group_counts,
                                  aa_c.perm)
    port_ev = torch.from_numpy(np.array(ev, f32).reshape(16))
    return dict(aa_c=aa_c, total_c=total_c, ev=ev, seed=seed,
                port_aa=port_aa, port_ev=port_ev)


def _port_acc(t, cfg=CFG, n_valid=N_VALID, batch=B):
    return pw.trace_splat_wide_rng_i8(
        t["port_aa"].fields, t["port_aa"].group_counts, t["port_ev"],
        t["seed"], n_valid, batch, cfg, t["total_c"],
    )


def test_batch_i8_splat_matches_jax(tables):
    t = tables
    with pltpu.force_tpu_interpret_mode():
        lm = np.asarray(jw.trace_splat_wide_rng(
            t["aa_c"].fields, t["ev"], t["seed"], N_VALID, CFG,
            t["aa_c"].group_counts, t["total_c"], B, 8, i8=True,
        ))
    scale = f32(pw.splat_color_scale(CFG))
    want = np.rint(lm / scale).astype(np.int64)
    np.testing.assert_array_equal(want.astype(f32) * scale, lm)  # integral
    acc = _port_acc(t).numpy()
    assert acc.dtype == np.int32 and acc.shape == (t["total_c"], 3)
    assert acc.sum() > 0
    assert (acc == want).mean() >= 0.99
    np.testing.assert_allclose(acc.sum(), want.sum(), rtol=1e-3)
    # the port's de-scale gives the JAX lightmap increment wherever the
    # integer cells agree
    got = acc.astype(f32) * scale
    np.testing.assert_array_equal(got[acc == want], lm[acc == want])


@pytest.mark.parametrize("depth", [2, 8])
def test_deposit_stream_matches_jax(tables, depth):
    t = tables
    cfg = dataclasses.replace(CFG, max_depth=depth)
    with pltpu.force_tpu_interpret_mode():
        idx, col = jw.trace_deposits_wide_rng(
            t["aa_c"].fields, t["ev"], t["seed"], N_VALID, cfg,
            t["aa_c"].group_counts, B, 8,
        )
    # one 1024-photon block: JAX rows are bounce-major
    idx = np.asarray(idx).reshape(depth, B).T
    col = np.asarray(col).reshape(depth, B, 3).transpose(1, 0, 2)
    pidx, pcol = pw.trace_deposits_rng_plain(
        t["port_aa"].fields, t["port_aa"].group_counts, t["port_ev"],
        t["seed"], N_VALID, B, cfg,
    )
    pidx, pcol = pidx.numpy(), pcol.numpy()
    assert pidx.shape == (B, depth) and pcol.shape == (B, depth, 3)
    # dead photons deposit exactly nothing
    assert not pcol[N_VALID:].any() and not pidx[N_VALID:].any()
    live = pcol.sum(-1) > 0
    assert live[:, 0].mean() > 0.5
    same = pidx == idx
    assert same.mean() >= (0.999 if depth == 2 else 0.99)
    np.testing.assert_allclose(pcol.sum(), col.sum(), rtol=1e-3)
    assert np.isclose(pcol, col, rtol=1e-5, atol=0).mean() >= 0.99
    if depth == 2:
        # before paths can split, deposits at equal texels carry equal color
        np.testing.assert_allclose(pcol[same], col[same], rtol=1e-5)


def test_tail_shrink_bit_identical(tables):
    """The tail batch runs at tail_batch_size: the dropped photons are all
    dead, and every draw depends only on (batch seed, photon index), so the
    result equals the full-batch trace bit for bit."""
    assert pw.tail_batch_size(300, B) == 512
    assert pw.tail_batch_size(1, B) == pw.THREADS
    assert pw.tail_batch_size(B, B) == B
    assert pw.tail_batch_size(700, 900) == 900
    n_valid = 300
    full = _port_acc(tables, n_valid=n_valid, batch=B)
    tail = _port_acc(tables, n_valid=n_valid,
                     batch=pw.tail_batch_size(n_valid, B))
    assert full.sum() > 0
    assert torch.equal(full, tail)


def test_wrapper_checks_and_plain_path(tables):
    t = tables
    f, gc, ev = t["port_aa"].fields, t["port_aa"].group_counts, t["port_ev"]
    before = pw.trace_splat_wide_rng_i8.launches
    with pytest.raises(ValueError):
        pw.trace_splat_wide_rng_i8(f.double(), gc, ev, 0, 8, 8, CFG, 16)
    with pytest.raises(ValueError):
        pw.trace_splat_wide_rng_i8(f, gc, ev[:15], 0, 8, 8, CFG, 16)
    with pytest.raises(ValueError):
        pw.trace_splat_wide_rng_i8(f, (1, 1, 1), ev, 0, 8, 8, CFG, 16)
    with pytest.raises(ValueError):
        pw.trace_splat_wide_rng_i8(f, gc, ev, 0, 9, 8, CFG, 16)
    with pytest.raises(ValueError):   # int32 accumulator could wrap
        pw.trace_splat_wide_rng_i8(f, gc, ev, 0, 8, 1 << 22, CFG, 16)
    # `out` is zeroed and filled in place; reruns are bit-identical
    out = torch.full((t["total_c"], 3), 7, dtype=torch.int32)
    got = pw.trace_splat_wide_rng_i8(f, gc, ev, t["seed"], 200, 256, CFG,
                                     t["total_c"], out=out)
    assert got is out
    assert torch.equal(out, _port_acc(t, n_valid=200, batch=256))
    # the plain version is not a kernel launch
    assert pw.trace_splat_wide_rng_i8.launches == before

