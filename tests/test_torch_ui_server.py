"""The port's headless UI server (utils/ui_server.py) on a live port
Renderer: tests/test_ui_server.py on the port (settings, telemetry and
frame endpoints, debug views, the scene explorer and its deferred
transform edits, the PNG encoder), on 127.0.0.1."""

import json
import struct
import urllib.error
import urllib.request
import zlib

import numpy as np

from basicrenderer_tpu_torch.models import procedural
from basicrenderer_tpu_torch.models.materials import Material
from basicrenderer_tpu_torch.renderer import Renderer
from basicrenderer_tpu_torch.scene.bridge import BridgeCapacities
from basicrenderer_tpu_torch.scene.scene import Scene
from basicrenderer_tpu_torch.utils.ui_server import DEBUG_VIEWS, UIServer, encode_png


def _get(url):
    with urllib.request.urlopen(url, timeout=300) as r:
        return r.read()


def _get_json(url):
    return json.loads(_get(url))


def _post_json(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _make_renderer():
    r = Renderer(caps=BridgeCapacities(
        max_vertices=1 << 10, max_triangles=1 << 10, max_objects=8,
        max_materials=4, max_lights=4, max_clusters=32), device="cpu")
    cube = r.meshes.add(procedural.make_cube(1.0))
    red = r.materials.add(Material(
        base_color=np.array([0.8, 0.1, 0.1, 1], np.float32)))
    sc = Scene()
    sc.create_renderable(cube, red, position=(0, 0.5, 0))
    sc.create_directional_light(direction=(-0.4, -1, -0.3), intensity=3)
    sc.set_camera(position=(3, 2, 4), target=(0, 0.5, 0))
    sc.propagate_transforms()
    r.settings.set("renderResolution", (64, 64))
    r.settings.set("maxTrianglePairs", 1 << 12)
    r.settings.set("maxVisibleClusters", 32)
    # The default 4 x 1024^2 cascades cost ~1 s a CPU frame.
    r.settings.set("enableShadows", False)
    r.set_current_scene(sc)
    return r


def test_ui_server_settings_telemetry_frame():
    r = _make_renderer()
    ui = UIServer(r).start()
    try:
        base = ui.url
        assert base.startswith("http://127.0.0.1:")
        assert b"basicrenderer_tpu_torch" in _get(base + "/")
        assert _get_json(base + "/api/views") == {"views": list(DEBUG_VIEWS)}

        d = _get_json(base + "/api/settings")
        assert d["settings"]["renderResolution"]["value"] == [64, 64]
        assert d["settings"]["renderResolution"]["structural"] is True
        gen0 = d["generation"]

        d = _post_json(base + "/api/settings", {"exposure": 2.0})
        assert d["settings"]["exposure"]["value"] == 2.0
        assert d["generation"] == gen0
        assert r.settings.get("exposure") == 2.0

        d = _post_json(base + "/api/settings", {"enableBloom": False})
        assert d["generation"] == gen0 + 1

        png = _get(base + "/api/frame.png")
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        w, h = struct.unpack(">II", png[16:24])
        assert (w, h) == (64, 64)

        png_depth = _get(base + "/api/frame.png?view=depth")
        assert png_depth != png
        assert r.settings.get("debugView") == "none"

        t = _get_json(base + "/api/telemetry")
        assert t["frame_index"] >= 2
        assert t["last"]["frame_ms"] > 0
        assert "dispatch" in t["last"]["stages"]
        assert t["last"]["counters"]["bin_overflow"] == 0

        try:
            _get(base + "/api/nothing")
            code = 200
        except urllib.error.HTTPError as e:
            code = e.code
        assert code == 404
    finally:
        ui.stop()


def test_png_encoder_roundtrip():
    img = (np.arange(4 * 5 * 3, dtype=np.uint8).reshape(4, 5, 3) * 3) % 251
    png = encode_png(img)
    w, h = struct.unpack(">II", png[16:24])
    assert (w, h) == (5, 4)
    idat_off = png.index(b"IDAT") + 4
    idat_len = struct.unpack(">I", png[idat_off - 8:idat_off - 4])[0]
    raw = zlib.decompress(png[idat_off:idat_off + idat_len])
    rows = [raw[y * (1 + 5 * 3) + 1:(y + 1) * (1 + 5 * 3)] for y in range(4)]
    dec = np.frombuffer(b"".join(rows), np.uint8).reshape(4, 5, 3)
    np.testing.assert_array_equal(dec, img)


def test_png_encoder_matches_jax():
    from basicrenderer_tpu.utils.ui_server import encode_png as j_encode_png
    img = np.random.default_rng(3).integers(0, 256, (7, 9, 3), np.uint8)
    assert encode_png(img) == j_encode_png(img)
    assert encode_png(img[..., 0]) == j_encode_png(img[..., 0])


def test_scene_explorer_and_live_transform_edit():
    """GET /api/scene lists the graph; POST /api/scene/transform queues a
    deferred edit that lands at the next update() and changes the frame."""
    r = _make_renderer()
    ui = UIServer(r).start()
    try:
        base = ui.url
        r.update()
        img0 = r.render_to_numpy()
        ents = _get_json(base + "/api/scene")["entities"]
        assert len(ents) >= 1
        cube = [e for e in ents if "mesh" in e][0]
        assert cube["position"] == [0.0, 0.5, 0.0]
        res = _post_json(base + "/api/scene/transform",
                         {"entity": cube["entity"],
                          "position": [0.8, 0.5, 0.0]})
        assert res["queued"]["fields"] == ["position"]
        r.update()
        img1 = r.render_to_numpy()
        assert np.abs(img1.astype(int) - img0).mean() > 0.05
        sc2 = _get_json(base + "/api/scene")
        cube2 = [e for e in sc2["entities"]
                 if e["entity"] == cube["entity"]][0]
        np.testing.assert_allclose(cube2["position"], [0.8, 0.5, 0.0],
                                   rtol=1e-6)
        res = _post_json(base + "/api/scene/transform",
                         {"entity": 999999, "position": [0, 0, 0]})
        assert "error" in res
    finally:
        ui.stop()
