"""The general intersector (ops/intersect.nearest_hit) against the JAX
package, and the record table that its kernel reads.

On the card `nearest_hit` launches csrc/general_nearest.cu, one thread a ray
over `general_table`'s per-rect records; on the CPU it runs
`nearest_hit_plain`, the [B, N] torch version. Here, on `tiny` and on `tiny`
turned 30 degrees about z (chip_smoke.rotated_scene):

- the plain version against the JAX package's nearest_hit on rays made with
  numpy seeds: random rays inside the room, and a fuzz of rays that graze
  a wall in its plane, run parallel to a wall, aim at the edges and corners
  of every wall, and miss everything. Bands of tests/test_torch_general.py:
  distances within rtol 1e-6 (the sums run in XLA's order), hit ids on
  >= 99.9% of rays;
- the record table field by field against the packed `Rects`;
- the kernel's loop, emulated in torch rect by rect in the kernel's float
  order over the record table (the strict `<` from +inf and column 0),
  against the plain version bit for bit: the function the kernel must
  compute (tests/test_torch_cuda.py holds the kernel itself to it on the
  card).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import rotated_scene
from flatmatch_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT
from flatmatch_tpu.ops import intersect as jint
from flatmatch_tpu.ops.device_scene import pack_rects as j_pack_rects
from flatmatch_tpu.render import compile_scene as j_compile
from flatmatch_tpu_torch.config import DEFAULT_CONFIG
from flatmatch_tpu_torch.ops import intersect
from flatmatch_tpu_torch.ops.device_scene import pack_rects, rect_count
from flatmatch_tpu_torch.render import compile_scene
from tests.conftest import FIXTURES

f32 = np.float32
TINY = str(FIXTURES / "tiny.png")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: the tensors are small, and the
    parallel test workers do not oversubscribe the cores they share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[0, 30], ids=lambda d: f"deg{d}")
def s(request):
    deg = request.param
    jscene = rotated_scene(j_compile(TINY, 30.0, JAX_DEFAULT)[0], deg)
    pscene = rotated_scene(compile_scene(TINY, 30.0, DEFAULT_CONFIG)[0], deg)
    return dict(deg=deg, pscene=pscene, jr=j_pack_rects(jscene.walls),
                pr=pack_rects(pscene.walls))


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(f32)


def _rays(s, seed=5, count=2048):
    """(name, origins [R, 3], directions [R, 3]) of each family of rays."""
    rs = np.random.RandomState(seed + s["deg"])
    walls = s["pscene"].walls
    pos = np.array([r.pos for r in walls], f32)
    wv = np.array([r.width for r in walls], f32)
    hv = np.array([r.height for r in walls], f32)
    lo, hi = pos.min(0), pos.max(0)
    center = ((lo + hi) / 2).astype(f32)
    inside = (lo + (hi - lo) * rs.uniform(0.05, 0.95, (count, 3))).astype(f32)
    out = [("random", inside, _unit(rs.normal(size=(count, 3))))]
    # grazing: from the middle of each wall, along its own plane
    mid = (pos + 0.5 * wv + 0.5 * hv).astype(f32)
    t = rs.uniform(-1, 1, (len(walls), 2)).astype(f32)
    out.append(("grazing", mid, _unit(wv * t[:, :1] + hv * t[:, 1:])))
    # parallel: from points inside the room, along each wall's span axes
    k = rs.randint(0, len(walls), count)
    out.append(("parallel", inside,
                np.where((rs.rand(count) < 0.5)[:, None], _unit(wv[k]),
                         _unit(hv[k]))))
    # edges and corners: from the room's center toward points on each
    # wall's four edges and its corners
    u = rs.rand(len(walls), 8).astype(f32)
    targets = [pos, pos + wv, pos + hv, pos + wv + hv]
    targets += [pos + wv * u[:, i:i + 1] + hv * (i % 2) for i in range(2)]
    targets += [pos + hv * u[:, i:i + 1] + wv * (i % 2) for i in (2, 3)]
    tgt = np.concatenate(targets).astype(f32)
    out.append(("edges", np.broadcast_to(center, tgt.shape).copy(),
                _unit(tgt - center)))
    # misses: far outside the room, pointing away from it
    d = _unit(rs.normal(size=(256, 3)))
    out.append(("misses", (center + 100.0 * d).astype(f32), d))
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_nearest_hit_plain_matches_jax(s):
    hit_shares = {}
    for name, src, d in _rays(s):
        jd, jh = (np.asarray(x) for x in jint.nearest_hit(
            jnp.asarray(src), jnp.asarray(d), s["jr"]))
        pd, ph = (x.numpy() for x in intersect.nearest_hit_plain(
            _t(src), _t(d), s["pr"]))
        assert pd.dtype == np.float32 and ph.dtype == np.int32
        hit = np.isfinite(jd) & np.isfinite(pd)
        assert (np.isfinite(jd) == np.isfinite(pd)).mean() >= 0.999, name
        np.testing.assert_allclose(pd[hit], jd[hit], rtol=1e-6,
                                   err_msg=name)
        assert hit.sum() == 0 or (ph[hit] == jh[hit]).mean() >= 0.999, name
        # a miss is +inf with hit 0 in both
        miss = ~np.isfinite(jd) & ~np.isfinite(pd)
        assert (ph[miss] == 0).all() and (jh[miss] == 0).all(), name
        hit_shares[name] = float(np.isfinite(pd).mean())
    assert hit_shares["random"] > 0.5 and hit_shares["edges"] > 0.3
    assert hit_shares["misses"] == 0.0


def test_general_table_equals_rects_field_by_field(s):
    pr = s["pr"]
    n = rect_count(pr)
    table = intersect.general_table(pr)
    assert table.dtype == torch.float32 and table.is_contiguous()
    assert tuple(table.shape) == (n, intersect.RECORD_FLOATS)
    assert n == len(s["pscene"].walls)
    for col, want in enumerate([
            pr.n[:, 0], pr.n[:, 1], pr.n[:, 2], pr.n_off,
            pr.w_unit[:, 0], pr.w_unit[:, 1], pr.w_unit[:, 2], pr.wlen,
            pr.h_unit[:, 0], pr.h_unit[:, 1], pr.h_unit[:, 2], pr.hlen]):
        assert torch.equal(table[:, col], want[:n]), col
    # the offsets are the plain version's own expression, left to right
    for col, unit in ((12, pr.w_unit), (13, pr.h_unit)):
        p = unit[:n] * pr.pos[:n]
        assert torch.equal(table[:, col], p[:, 0] + p[:, 1] + p[:, 2])
    assert (table[:, 14:] == 0).all()
    # the padding has zero normals: it never wins
    assert (pr.n[n:] == 0).all()
    # cached per Rects
    assert intersect.general_table(pr) is table


def _kernel_loop(table, src, d):
    """csrc/general_nearest.cu's loop in torch, one rect at a time in the
    kernel's float order, over the record table."""
    best = torch.full((src.shape[0],), float("inf"))
    bj = torch.zeros((src.shape[0],), dtype=torch.int32)
    sx, sy, sz = src[:, 0], src[:, 1], src[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    for j in range(table.shape[0]):
        (nx, ny, nz, noff, wx, wy, wz, wlen, hx, hy, hz, hlen, offw, offh,
         _, _) = table[j]
        denom = dx * nx + dy * ny + dz * nz
        sn = sx * nx + sy * ny + sz * nz
        fac = (noff - sn) / denom
        sw = sx * wx + sy * wy + sz * wz
        dw = dx * wx + dy * wy + dz * wz
        sh = sx * hx + sy * hy + sz * hz
        dh = dx * hx + dy * hy + dz * hz
        px = (sw + fac * dw) - offw
        py = (sh + fac * dh) - offh
        win = ((denom < 0) & (fac >= 0) & (px >= 0) & (px <= wlen)
               & (py >= 0) & (py <= hlen) & (fac < best))
        best = torch.where(win, fac, best)
        bj = torch.where(win, torch.full_like(bj, j), bj)
    return best, bj


def test_kernel_loop_equals_the_plain_version_bit_for_bit(s):
    table = intersect.general_table(s["pr"])
    for name, src, d in _rays(s, seed=8):
        want_d, want_h = intersect.nearest_hit_plain(_t(src), _t(d), s["pr"])
        got_d, got_h = _kernel_loop(table, _t(src), _t(d))
        assert torch.equal(got_d.view(torch.int32),
                           want_d.view(torch.int32)), name
        assert torch.equal(got_h, want_h), name


def test_nearest_hit_on_cpu_runs_the_plain_version(s, monkeypatch):
    src, d = (_t(a) for a in _rays(s)[0][1:])
    before = intersect.nearest_hit.launches
    got = intersect.nearest_hit(src, d, s["pr"])
    want = intersect.nearest_hit_plain(src, d, s["pr"])
    assert intersect.nearest_hit.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the plain version's tiles change no bit
    monkeypatch.setattr(intersect, "TILE_ELEMS", 300 * rect_count(s["pr"]))
    tiled = intersect.nearest_hit_plain(src, d, s["pr"])
    assert all(torch.equal(a, b) for a, b in zip(tiled, want))
    empty = intersect.nearest_hit(src[:0], d[:0], s["pr"])
    assert [tuple(x.shape) for x in empty] == [(0,), (0,)]


@pytest.mark.parametrize("bad", ["shape", "dtype", "mismatch"])
def test_nearest_hit_refuses_bad_inputs(s, bad):
    src, d = (_t(a) for a in _rays(s)[0][1:])
    if bad == "shape":
        src = src[:, :2]
    elif bad == "dtype":
        d = d.double()
    else:
        d = d[:5]
    with pytest.raises(ValueError):
        intersect.nearest_hit(src, d, s["pr"])
