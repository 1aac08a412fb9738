"""No module the benchmark loads has `jax`, `jaxlib`, `flax` or the JAX
package `flatmatch_tpu` as its top-level name, and the reference loads
nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys

from .conftest import ROOT

FOREIGN = {"jax", "jaxlib", "flax", "flatmatch_tpu"}


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint('\\n'.join("
         "sorted(sys.modules)))"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return {m.split(".")[0] for m in out.stdout.split()}


def test_a_run_loads_no_jax():
    """Every module of the benchmark, every metric reader and one request
    of each configuration through the program, on the CPU."""
    code = f"""
import sys, copy, tempfile
sys.path.insert(0, {str(ROOT)!r})
import torch
torch.set_num_threads(2)
from benchmark import harness, loop, registry, roofline, trace
from benchmark.reference import compare, geometry, layout, photon, radiosity
from benchmark.tools import readings
bench = registry.load_benchmark({str(ROOT)!r})
for section in ("end_to_end", "per_layer"):
    for m in bench[section]:
        registry.metric(m["name"])
lay = layout.parse_rects({str(ROOT / "benchmark" / "layouts" /
                              "example_rects.txt")!r})
for name in ("example_photon", "example_radiosity"):
    cfg = copy.deepcopy(registry.config(name))
    cfg["settings"].update(cfg.get("warmup", {{}}))
    if name == "example_photon":
        cfg["settings"]["samples_per_area"] = 1000.0
    else:
        cfg["settings"]["rays_per_texel"] = 4
    target = loop.Target([torch.device("cpu")], None, tempfile.mkdtemp(),
                         False)
    loop.request(lay, loop.render_config(cfg, {{}}, 1, 1), target)
"""
    loaded = _modules_after(code)
    assert "flatmatch_tpu_torch" in loaded
    assert not loaded & FOREIGN, loaded & FOREIGN


def test_reference_loads_nothing_of_the_program():
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from benchmark.reference import compare, geometry, layout, photon, radiosity
"""
    loaded = _modules_after(code)
    assert not loaded & (FOREIGN | {"flatmatch_tpu_torch"})


def test_reference_sources_import_no_program():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FOREIGN | {
                    "flatmatch_tpu_torch"}, (path, n)
