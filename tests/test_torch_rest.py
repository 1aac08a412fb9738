"""The port's REST packager and server against the JAX package's.

The offer template and the two pages are the JAX package's strings. With
`render` replaced in both packages by one stub that writes the same tiles
and JSON, the two `package_offer` trees are equal byte for byte, file for
file. A real `package` of tiny through the port's CLI on the CPU splices
the fixtures' collision map and geometry verbatim, copies the layout byte
for byte and carries every tile as base64. The port's server and the JAX
package's, serving one tree, answer every route, a missing id and a
traversal attempt with the same status, content type and bytes.
"""
import base64
import json
import pathlib
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from flatmatch_tpu.io import rest as jrest
from flatmatch_tpu_torch import cli
from flatmatch_tpu_torch.config import DEFAULT_CONFIG
from flatmatch_tpu_torch.io import rest, tiles as tiles_io
from flatmatch_tpu_torch.render import compile_scene
from flatmatch_tpu_torch.scene import geometry
from tests.conftest import FIXTURES

TINY = str(FIXTURES / "tiny.png")
PKG = dict(offer_id=42, scale=30.0, latitude=52.13, longitude=11.62,
           yaw=0.5, level=2)


def test_template_and_pages_are_the_jax_strings():
    assert rest.OFFER_TEMPLATE == jrest.OFFER_TEMPLATE
    assert rest._VIEWER_HTML == jrest._VIEWER_HTML
    assert rest._WALK_HTML == jrest._WALK_HTML


def _stub_render(png, out_dir, scale, cfg, **_):
    """Both packages' `render`: the tiny scene's JSON and tiles of one
    seeded lightmap."""
    scene, collision_json = compile_scene(png, scale, DEFAULT_CONFIG)
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    texels = np.random.RandomState(3).rand(scene.num_texels, 3).astype(
        np.float32)
    paths = tiles_io.save_tiles(scene.walls, texels, str(out / "tiles"),
                                False, False)
    return types.SimpleNamespace(
        tile_paths=paths, collision_json=collision_json,
        geometry_json=geometry.geometry_json(scene))


def _tree(root: pathlib.Path):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_trees_are_the_jax_packages_byte_for_byte(tmp_path, monkeypatch):
    monkeypatch.setattr(rest, "render", _stub_render)
    monkeypatch.setattr(jrest, "render", _stub_render)
    got = rest.package_offer(TINY, out_dir=str(tmp_path / "t"),
                             device="cpu", **PKG)
    want = jrest.package_offer(TINY, out_dir=str(tmp_path / "j"), mesh=None,
                               **PKG)
    assert got == tmp_path / "t" / "rest"
    assert want == tmp_path / "j" / "rest"
    t, j = _tree(tmp_path / "t"), _tree(tmp_path / "j")
    assert sorted(t) == sorted(j) and len(t) == 3 + 13
    for name in j:
        assert t[name] == j[name], name


@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    """A real `package` of tiny through the port's CLI on the CPU."""
    out = tmp_path_factory.mktemp("pkg")
    assert cli.main(["package", TINY, "42", "30", "52.13", "11.62", "0.5",
                     "2", "--device", "cpu", "--samples-per-area", "3000",
                     "--photons-per-batch", "1024", "--out", str(out)]) == 0
    return out


def test_package_splices_the_fixtures_verbatim(tiny_tree):
    get = tiny_tree / "rest" / "get"
    offer = (get / "offer" / "42").read_text()
    cm = (FIXTURES / "tiny_collisionMap.json").read_text()
    geo = (FIXTURES / "tiny_geometry.json").read_text()
    want = jrest.OFFER_TEMPLATE
    for key, val in (("$COLLISION_MAP", cm), ("$LONGITUDE", "11.62"),
                     ("$LATITUDE", "52.13"), ("$LEVEL", "2"),
                     ("$SCALE", "30.0"), ("$YAW", "0.5"), ("$LAYOUT", geo),
                     ("$ROW_ID", "42")):
        want = want.replace(key, val)
    assert offer == want
    assert json.loads(offer)["collisionMap"] == json.loads(cm)
    assert (get / "layout" / "42").read_bytes() == pathlib.Path(
        TINY).read_bytes()
    textures = json.loads((get / "textures" / "42").read_text())
    assert sorted(textures, key=int) == [str(i) for i in range(13)]
    for i, b64 in textures.items():
        assert base64.b64decode(b64) == (
            tiny_tree / "tiles" / f"tile_{i}.png").read_bytes()


def _serve(make, root):
    srv = make(str(root), port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, t


def _fetch(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_servers_answer_alike(tiny_tree):
    paths = ["/", "/viewer", "/walk", "/walk?id=42", "/offers",
             "/rest/get/offer/42", "/rest/get/layout/42",
             "/rest/get/textures/42", "/rest/get/offer/43",
             "/rest/get/offer/..%2F..%2Fgeometry.json",
             "/rest/get/../../geometry.json", "/rest/get/tiles/42"]
    servers = [_serve(rest.make_rest_server, tiny_tree),
               _serve(jrest.make_rest_server, tiny_tree)]
    try:
        for path in paths:
            got, want = (_fetch(s.server_port, path) for s, _ in servers)
            assert got == want, path
        get = tiny_tree / "rest" / "get"
        port = servers[0][0].server_port
        assert _fetch(port, "/rest/get/offer/42") == (
            200, "application/json", (get / "offer" / "42").read_bytes())
        assert _fetch(port, "/rest/get/layout/42")[2] == pathlib.Path(
            TINY).read_bytes()
        assert _fetch(port, "/offers")[2] == b"[42]"
        assert _fetch(port, "/rest/get/offer/43")[0] == 404
        assert _fetch(port, "/rest/get/../../geometry.json")[0] == 404
    finally:
        for s, t in servers:
            s.shutdown()
            s.server_close()
            t.join(timeout=30)
    assert not any(t.is_alive() for _, t in servers)
