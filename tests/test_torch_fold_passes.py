"""The replay backward's fold past 6,752 rect slots, against the JAX package.

`csrc/trace_fold_wide_rng.cu` keeps one [N] row of slot sums per warp in
shared memory; at depth 8 the rows of 6,752 slots fit beside its w and
slot buffers (`photon_wide.fold_pass_slots`). A larger table is folded in
passes over slot ranges [lo, hi), each a replay of the batch that adds only
the slots of its range, in the order one pass would take; pass 0 alone
writes w_sum. The JAX folds set no cap. Here, on the CPU:
- the pass split, built in torch from `fold_plain` (each pass folds the
  stream with the slots outside its range dropped, and keeps its range),
  equals one pass bit for bit;
- tiny's compact table with 3,540 rects that are never hit (copies of rect
  0 with a far edge below 0) in front of its x group and of its z group,
  7,093 slots: past the old cap, and at depth 3 (7,072 slots a pass) two
  passes with real rects in both. The port's `trace_fold_wide_rng` (its
  plain version, the path CPU tensors take) takes it, and equals the JAX
  package's `trace_fold_wide_rng` at the fold band, rtol 1e-4
  (tests/test_torch_diff.py: the same bf16 rounding of g, the f32 sums in
  another order).

The JAX fold runs in Pallas's interpret mode with sublanes=1 and unroll=1,
through `pallas_call(interpret=True)`, which lowers the kernel body to XLA
on the CPU (a few seconds at depth 3); the TPU interpret mode of the other
tests simulates every table read and takes minutes on 7,000 rects. Tables,
albedo and g come from the JAX package's tiny scene and numpy seeds.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from flatmatch_tpu.config import PhotonConfig as JaxPhotonConfig
from flatmatch_tpu.engines import photon_pallas, photon_pallas_wide as jw
from flatmatch_tpu.engines.schedule import emitter_slice
from flatmatch_tpu.ops.aa_scene import pack_aa as jax_pack_aa
from flatmatch_tpu.ops.device_scene import pack_emitters as jax_pack_em
from flatmatch_tpu.scene import geometry, image as im, layout
from flatmatch_tpu_torch.config import PhotonConfig
from flatmatch_tpu_torch.engines import photon_wide as pw
from flatmatch_tpu_torch.ops.aa_scene import A_WLEN
from tests.conftest import FIXTURES

f32 = np.float32
B = 128
N_VALID = 100
PADS = 3540
KW = dict(samples_per_area=1300.0, photons_per_batch=B, seed=5,
          splat="inkernel_i8", device_rng=True)
JCFG = JaxPhotonConfig(**KW, max_depth=3)
CFG = PhotonConfig(**KW, max_depth=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def past_cap_table(fields, group_counts, pads):
    """The [13, N] table with `pads` copies of rect 0 whose far edge WLEN
    is -1 (no u passes both u >= 0 and u <= WLEN, so none is ever hit) in
    front of the x group and of the z group."""
    g0, g1, g2 = (int(c) for c in group_counts)
    pad = np.repeat(fields[:, :1], pads, 1)
    pad[A_WLEN] = -1.0
    big = np.concatenate([pad, fields[:, :g0 + g1], pad, fields[:, g0 + g1:]],
                         1)
    return np.ascontiguousarray(big, f32), (pads + g0, g1, pads + g2)


@pytest.fixture(scope="module")
def t():
    img = im.load_layout(str(FIXTURES / "tiny.png"))
    scene = geometry.Scene(layout.parse_layout(img, f32(1) / f32(30), 200.0))
    em = jax_pack_em(scene, KW["samples_per_area"], JCFG.window_color,
                     JCFG.light_color)
    aa_c, T, _ = jw.compact_aa(jax_pack_aa(scene.walls), scene.num_texels)
    fields, gc = past_cap_table(np.asarray(aa_c.fields), aa_c.group_counts,
                                PADS)
    rs = np.random.RandomState(11)
    ev = photon_pallas.emitter_vector(emitter_slice(em, 0))
    return dict(fields=fields, gc=gc, n=fields.shape[1], T=T, ev=ev,
                pev=torch.from_numpy(np.array(ev, f32).reshape(16)),
                albedo=rs.uniform(0.4, 0.95, fields.shape[1]).astype(f32),
                g=rs.rand(T, 3).astype(f32),
                seed=int(jw.batch_seed(JCFG.seed, 1)))


def _stream(t):
    return pw.trace_deposits_rng_plain(
        torch.from_numpy(t["fields"]), t["gc"], t["pev"], t["seed"], N_VALID,
        B, CFG, torch.from_numpy(t["albedo"]))


def test_fold_split_over_slot_ranges_equals_one_pass(t):
    """The kernel's passes over [0, 7072) and [7072, 7093), and cuts
    elsewhere: each pass folds the stream with the other slots dropped and
    keeps its own range, pass 0's w_sum is kept; da and w_sum equal one
    pass bit for bit."""
    idx, col, ridx = _stream(t)
    g, n = torch.from_numpy(t["g"]), t["n"]
    per = pw.fold_pass_slots(3)
    assert per == 7072 and per < n <= 2 * per
    one = pw.fold_plain(idx, col, ridx, g, n)
    assert bool((one[0][:per] != 0).any()) and bool((one[0][per:] != 0).any())
    for cuts in ([0, per, n], [0, 1, n], [0, PADS + 5, per + 3, n]):
        da = torch.empty(n)
        for i, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
            mine = torch.where((ridx >= lo) & (ridx < hi), ridx, -1)
            part, w_sum = pw.fold_plain(idx, col, mine, g, n)
            da[lo:hi] = part[lo:hi]
            if i == 0:
                first_w = w_sum
        assert torch.equal(da, one[0]) and torch.equal(first_w, one[1])


def test_fold_past_the_old_cap_matches_jax(t):
    """The port's fold on 7,093 slots (no refusal) against JAX's
    trace_fold_wide_rng on the same table, draws, albedo and g: da and
    w_sum at rtol 1e-4, with slots hit in both passes."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        da, dw = jw.trace_fold_wide_rng(
            jnp.asarray(t["fields"]), jnp.asarray(t["albedo"]), t["ev"],
            jw.cotangent_t(jnp.asarray(t["g"]), t["T"]), t["seed"], N_VALID,
            JCFG, t["gc"], t["n"], B, 1, unroll=1)
    before = pw.trace_fold_wide_rng.launches
    pda, pdw = pw.trace_fold_wide_rng(
        torch.from_numpy(t["fields"]), t["gc"], torch.from_numpy(t["albedo"]),
        t["pev"], torch.from_numpy(t["g"]), t["seed"], N_VALID, B, CFG,
        t["n"])
    assert pw.trace_fold_wide_rng.launches == before        # plain version
    da = np.asarray(da)
    per = pw.fold_pass_slots(3)
    assert pda.shape == (t["n"],) and t["n"] > per > 6752
    assert (da[:per] != 0).sum() >= 3 and (da[per:] != 0).sum() >= 2
    np.testing.assert_allclose(pda.numpy(), da, rtol=1e-4,
                               atol=1e-6 * np.abs(da).max())
    np.testing.assert_allclose(pdw.item(), float(dw), rtol=1e-4)
