"""The radiosity relaxation's gather (ops/relax_gather.py,
csrc/relax_gather.cu).

- The plain version equals dest[r] = sum_j src[ids[r, j]] in numpy, a
  miss (-1) adding zero, on random tables with about 5% misses.
- `kernel_order_sum` repeats the kernel's float32 additions in the
  kernel's order (each of a row's 256 threads' ids, the warp's shuffle
  tree, the row's warps in order) for every alignment of a row's start;
  on the CPU it agrees with the exact sums, and on the card (marker
  `cuda`) the kernel equals it bit for bit and the plain version to rtol
  1e-5.
- CPU tensors run the plain version and launch nothing; `relax` gathers
  once an iteration and a shard.

No JAX here: the CUDA tests run on a machine that has only PyTorch.
"""
import pathlib

import numpy as np
import pytest
import torch

from flatmatch_tpu_torch.config import DEFAULT_CONFIG, RadiosityConfig
from flatmatch_tpu_torch.engines import radiosity
from flatmatch_tpu_torch.ops import relax_gather as rg
from flatmatch_tpu_torch.parallel.mesh import photon_mesh
from flatmatch_tpu_torch.render import compile_scene

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
f32 = np.float32
# (rows, rays): ids only in a row's scalar head or tail, a part of one
# sweep of the 256 threads' int4s, and rows of several sweeps
SHAPES = [(37, 1), (45, 3), (29, 32), (11, 2500)]
THREADS = 256                   # the kernel's threads a row


def _table(rows, rays, total, seed, miss=0.05):
    """A float32 arena [total, 3] in [0, 30) and ids [rows, rays] int32,
    about `miss` of them -1, from a numpy seed."""
    r = np.random.RandomState(seed)
    src = r.uniform(0, 30, (total, 3)).astype(f32)
    ids = r.randint(0, total, (rows, rays)).astype(np.int32)
    ids[r.uniform(size=ids.shape) < miss] = -1
    return src, ids


def _exact(src, ids):
    """The sums in float64."""
    ext = np.concatenate([src, np.zeros((1, 3), f32)]).astype(np.float64)
    return ext[np.where(ids < 0, len(src), ids)].sum(1)


def kernel_order_sum(src, ids, first=0, threads=THREADS):
    """csrc/relax_gather.cu's float32 sums, addition for addition, with
    `threads` threads a row, on ids whose element 0 lies `first` int32s
    past a 16-byte boundary. Thread t adds, from 0: row element t if t <
    head (the ids before the row's first boundary); the int4s t, t +
    threads, t + 2 threads, ..., each's four ids in order; element tail + t
    if t < rays - tail. Lane 0 of each warp then holds the shuffle tree's
    sum (x[l] += x[l + off], off 16, 8, 4, 2, 1), and the row is its first
    warp's plus the others' in order."""
    rows, rays = ids.shape
    ext = np.concatenate([src, np.zeros((1, 3), f32)])
    miss = len(src)
    out = np.empty((rows, 3), f32)
    t = np.arange(threads)
    for r in range(rows):
        vals = ext[np.minimum(ids[r].astype(np.uint32), miss)]
        head = min(rays, (4 - (first + r * rays) % 4) % 4)
        body = (rays - head) // 4
        tail = head + 4 * body
        acc = np.zeros((threads, 3), f32)
        acc[t < head] += vals[t[t < head]]
        vec = vals[head:tail].reshape(body, 4, 3)
        for k in range(0, body, threads):
            live = t + k < body
            for c in range(4):
                acc[live] += vec[(t + k)[live], c]
        n_tail = rays - tail
        acc[t < n_tail] += vals[tail + t[t < n_tail]]
        warps = acc.reshape(threads // 32, 32, 3)
        for off in (16, 8, 4, 2, 1):
            src_lane = np.where(np.arange(32) + off < 32,
                                np.arange(32) + off, np.arange(32))
            warps = warps + warps[:, src_lane]
        row = warps[0, 0].copy()
        for w in range(1, threads // 32):
            row += warps[w, 0]
        out[r] = row
    return out


@pytest.mark.parametrize("rows,rays", SHAPES)
def test_plain_matches_numpy(rows, rays):
    src, ids = _table(rows, rays, 700, seed=rows * 7 + rays)
    assert (ids < 0).any() or rays < 4
    got = rg.relax_gather_plain(torch.from_numpy(src),
                                torch.from_numpy(ids)).numpy()
    assert got.dtype == np.float32 and got.shape == (rows, 3)
    np.testing.assert_allclose(got, _exact(src, ids), rtol=1e-5, atol=0)


@pytest.mark.parametrize("first", range(4))
@pytest.mark.parametrize("rows,rays", SHAPES)
def test_kernel_order_matches_the_exact_sums(rows, rays, first):
    src, ids = _table(rows, rays, 700, seed=rows + rays)
    got = kernel_order_sum(src, ids, first)
    np.testing.assert_allclose(got, _exact(src, ids), rtol=1e-5, atol=0)


def test_cpu_tensors_run_the_plain_version():
    src, ids = _table(45, 3, 300, seed=4)
    s, i = torch.from_numpy(src), torch.from_numpy(ids)
    before = rg.relax_gather.launches
    got = rg.relax_gather(s, i)
    assert rg.relax_gather.launches == before
    assert torch.equal(got, rg.relax_gather_plain(s, i))


def test_wrapper_refuses_bad_inputs():
    src, ids = (torch.from_numpy(a) for a in _table(5, 8, 50, seed=1))
    with pytest.raises(ValueError):
        rg.relax_gather(src.double(), ids)
    with pytest.raises(ValueError):
        rg.relax_gather(src, ids.long())
    with pytest.raises(ValueError):
        rg.relax_gather(src[:, :2].contiguous(), ids)
    with pytest.raises(ValueError):
        rg.relax_gather(src, ids.t())
    with pytest.raises(ValueError):
        rg.relax_gather(src, ids[0])


@pytest.mark.parametrize("shards", [0, 3])
def test_relax_gathers_once_an_iteration_and_shard(monkeypatch, shards):
    """tiny at 16 rays, 3 iterations: one gather an iteration on one
    device, one a shard and iteration on a mesh (0: no mesh), each on the
    CPU equal to the plain version bit for bit."""
    scene, _ = compile_scene(str(FIXTURES / "tiny.png"), 30.0,
                             DEFAULT_CONFIG)
    cfg = RadiosityConfig(rays_per_texel=16, iterations=3, seed=2)
    rows = len(radiosity.level0_arena_indices(scene))
    calls = []

    def counting(src, ids):
        got = rg.relax_gather(src, ids)
        calls.append((tuple(ids.shape),
                      torch.equal(got, rg.relax_gather_plain(src, ids))))
        return got

    monkeypatch.setattr(radiosity, "relax_gather", counting)
    if shards:
        out = radiosity.render_radiosity_sharded(
            scene, cfg, photon_mesh(["cpu"] * shards))
    else:
        out = radiosity.render_radiosity(scene, cfg, "cpu")
    assert np.isfinite(out).all() and out.sum() > 0
    rays = -(-16 // max(shards, 1))
    assert calls == [((rows, rays), True)] * (cfg.iterations * max(shards, 1))


# -- on the card ------------------------------------------------------------
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _misaligned(ids, first, dev):
    """ids on `dev` as a contiguous tensor whose data starts `first` int32s
    past the allocation's start (allocations are 16-byte aligned)."""
    flat = torch.empty(ids.size + first, dtype=torch.int32, device=dev)
    out = flat[first:].view(ids.shape)
    out.copy_(torch.from_numpy(ids))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("first", range(4))
@pytest.mark.parametrize("rows,rays", SHAPES + [(9, 10000)])
def test_kernel_equals_its_order_bit_for_bit(dev, rows, rays, first):
    src, ids = _table(rows, rays, 700, seed=rows + rays)
    s = torch.from_numpy(src).to(dev)
    i = _misaligned(ids, first, dev)
    before = rg.relax_gather.launches
    got = rg.relax_gather(s, i).cpu().numpy()
    assert rg.relax_gather.launches == before + 1
    want = kernel_order_sum(src, ids, first)
    assert got.tobytes() == want.tobytes(), np.abs(got - want).max()
    plain = rg.relax_gather_plain(s, i).cpu().numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_kernel_reruns_bit_for_bit_and_refuses_bad_inputs(dev):
    src, ids = _table(300, 2500, 5000, seed=3)
    s, i = torch.from_numpy(src).to(dev), torch.from_numpy(ids).to(dev)
    a, b = rg.relax_gather(s, i), rg.relax_gather(s, i)
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        rg.relax_gather(s, i.cpu())
    empty = rg.relax_gather(s, i[:0])
    assert empty.shape == (0, 3)
