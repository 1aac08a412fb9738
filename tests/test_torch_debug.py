"""The port's first-hit debug render against the JAX package's, and the
CLI's `debug` and `package --profile`.

`render_first_hit` shoots one ray per pixel through the general engines'
intersector, whose sums run in the JAX package's order, and takes ties in
rect order. On mini from the starting position (the CLI's camera, and two
small ones) the two packages' images were equal on every pixel when this
test was written; the bound, 99.9% of pixels, leaves room for a last-ulp
tie at a rect edge. The profiler cases of `render` and `fit` are cases of
tests/test_torch_render.py::test_cli_runs_what_the_slice_runs and
tests/test_torch_diff.py::test_fit_cli_runs_what_the_port_runs.
"""
import json

import numpy as np
import pytest
from PIL import Image

from flatmatch_tpu.debug.raytrace import (
    Camera as JCamera, rect_index_colors as j_colors,
    render_first_hit as j_first_hit,
)
from flatmatch_tpu.ops.device_scene import pack_rects as j_pack_rects
from flatmatch_tpu.scene import geometry as j_geo, image as j_im
from flatmatch_tpu.scene import layout as j_lay
from flatmatch_tpu_torch import cli
from flatmatch_tpu_torch.debug.raytrace import (
    Camera, rect_index_colors, render_first_hit,
)
from flatmatch_tpu_torch.ops.device_scene import pack_rects
from flatmatch_tpu_torch.scene import geometry, image, layout
from tests.conftest import FIXTURES

f32 = np.float32
MINI = str(FIXTURES / "mini.png")
SHARE = 0.999


def test_rect_index_colors_are_jax_colors():
    np.testing.assert_array_equal(rect_index_colors(300), j_colors(300))


@pytest.fixture(scope="module")
def scenes():
    jscene = j_geo.Scene(j_lay.parse_layout(j_im.load_layout(MINI),
                                            f32(1) / f32(30), 200.0))
    scene = geometry.Scene(layout.parse_layout(image.load_layout(MINI),
                                               f32(1) / f32(30), 200.0))
    return jscene, scene


@pytest.mark.parametrize("cam", [
    dict(direction=(1.0, 0.3, 0.0), width=160, height=120,
         pixel_pitch=0.01, z=1.3),
    dict(direction=(-1.0, 0.2, -0.1), width=256, height=192, z=1.6),
], ids=["small", "looking-down"])
def test_first_hit_matches_jax(scenes, cam):
    jscene, scene = scenes
    sp = scene.layout.starting_position
    kw = {k: v for k, v in cam.items() if k != "z"}
    kw["position"] = (sp[0], sp[1], cam["z"])
    want = j_first_hit(jscene, j_pack_rects(jscene.walls), JCamera(**kw))
    got = render_first_hit(scene, pack_rects(scene.walls), Camera(**kw))
    assert got.shape == want.shape == (kw["height"], kw["width"], 4)
    assert (got == want).all(-1).mean() >= SHARE
    assert (got[..., 3] == 255).any()
    assert len(np.unique(got[..., :3].reshape(-1, 3), axis=0)) >= 3


def test_cli_debug_writes_the_png(tmp_path, scenes):
    out = tmp_path / "dbg.png"
    assert cli.main(["debug", MINI, "30", "--device", "cpu", "--out",
                     str(out), "--width", "192", "--height", "128"]) == 0
    img = np.asarray(Image.open(out))
    assert img.shape == (128, 192, 4)
    assert (img[..., 3] == 255).all()   # interior camera: every ray hits
    jscene = scenes[0]
    sp = jscene.layout.starting_position
    want = j_first_hit(jscene, j_pack_rects(jscene.walls), JCamera(
        position=(sp[0], sp[1], 1.6), width=192, height=128))
    assert (img == want).all(-1).mean() >= SHARE


def test_package_profile_writes_a_trace(tmp_path):
    prof = tmp_path / "prof"
    assert cli.main(["package", str(FIXTURES / "tiny.png"), "7", "30",
                     "52.13", "11.62", "0.5", "2", "--device", "cpu",
                     "--samples-per-area", "1000", "--photons-per-batch",
                     "1024", "--out", str(tmp_path / "o"), "--profile",
                     str(prof)]) == 0
    assert (tmp_path / "o" / "rest" / "get" / "offer" / "7").is_file()
    trace = json.loads((prof / "flatmatch_torch.pt.trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(str(n).startswith("aten::") for n in names)
