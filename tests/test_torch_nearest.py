"""CPU checks of the nearest-hit kernels' redesign.

- Each ablation of `flatmatch_tpu_torch/tools/trace_kernel_times.py`
  (VARIANTS: one design choice of a kernel undone in a copy of the package)
  still finds the text it edits exactly once, so the copies it times on the
  card build from the sources as they are.
- Row 12 (`csrc/ao_fused.cu`) traces the padded directions, whose weight
  is 0; its ablation `ao_skip_padded` skips them, which keeps every bit:
  the fused AO's plain sum with them dropped from each lane's sum equals
  the padded sum bit for bit.

Each runs in a few seconds on the CPU; none needs JAX or a card.
"""
import dataclasses
import importlib.util
import pathlib

import pytest
import torch

from flatmatch_tpu_torch.config import DEFAULT_CONFIG, AoConfig
from flatmatch_tpu_torch.engines import ao
from flatmatch_tpu_torch.ops import aa_query
from flatmatch_tpu_torch.ops.aa_scene import pack_aa
from flatmatch_tpu_torch.render import compile_scene

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"
CFG = DEFAULT_CONFIG.replace(photon=dataclasses.replace(
    DEFAULT_CONFIG.photon, samples_per_area=3000.0))


def _tool():
    spec = importlib.util.spec_from_file_location(
        "trace_kernel_times",
        ROOT / "flatmatch_tpu_torch" / "tools" / "trace_kernel_times.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()


@pytest.mark.parametrize("variant", sorted(TOOL.VARIANTS))
def test_ablation_edits_match_their_source_once(variant, tmp_path):
    """variant_root copies the package and applies the variant's edits in
    order, raising unless each text to edit occurs exactly once; every
    edit changes its file."""
    root = pathlib.Path(TOOL.variant_root(str(ROOT), variant, str(tmp_path)))
    for rel, old, new in TOOL.VARIANTS[variant]:
        assert old != new
        text = (root / "flatmatch_tpu_torch" / rel).read_text()
        assert new in text


def test_ao_fused_padded_directions_add_nothing():
    """The fused AO of tiny's first texels at the default geosphere level
    (481 directions padded to 512 at weight 0): each lane j summing only
    the real directions j, j + 128, ... < K, then the halving tree over the
    128 lanes (the kernel's order), equals ao_fused_plain's padded sum bit
    for bit."""
    scene, _ = compile_scene(str(FIXTURES / "tiny.png"), 30.0, CFG)
    aa = pack_aa(scene.walls, "cpu")
    centers, walls, dirs, fac, _, _ = ao._ao_fused_prep(scene, AoConfig())
    c = torch.from_numpy(centers[:64])
    w = torch.from_numpy(walls[:64])
    d = torch.from_numpy(dirs)
    f = torch.from_numpy(fac)
    K = int((f > 0).sum())
    assert K == 481 and f.shape[0] == 512 and bool((f[K:] == 0).all())
    padded = ao.ao_fused_plain(aa.fields, aa.group_counts, c, w, d, f, 10.0)

    dd = d[w.long()].transpose(1, 2)[:, :K]            # [C, K, 3], real only
    dist = aa_query.nearest_distances_plain(
        aa.fields, aa.group_counts, (c[:, None, :] + dd * ao.NUDGE)
        .reshape(-1, 3), dd.reshape(-1, 3).contiguous(), 10.0)
    prod = dist.reshape(-1, K) * f[:K]
    lanes = []
    for j in range(ao.K_BLOCK):
        acc = torch.zeros(prod.shape[0])
        for k in range(j, K, ao.K_BLOCK):
            acc = acc + prod[:, k]
        lanes.append(acc)
    acc = torch.stack(lanes, 1)
    half = ao.K_BLOCK // 2
    while half:
        acc = acc[:, :half] + acc[:, half:2 * half]
        half //= 2
    assert bool((padded > 0).all())
    assert torch.equal(acc[:, 0], padded)
