"""CUDA kernel of flatmatch_tpu_torch against its plain PyTorch version.

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
    idx, col = pw.trace_deposits_rng_plain(
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
