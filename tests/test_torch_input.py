"""The port's input stack, cameras and cluster-LOD cache tool
(utils/input.py, utils/camera.py, tools/clod_cache.py):
tests/test_input.py and tests/test_camera_tools.py on the port. Held keys
move the fly camera frame-rate-independently, mouse drags rotate, the
pump drains per frame, the UI server's /input endpoint feeds the port
Renderer's pump, and the cache tool lists the port's LOD cache."""

import json
import urllib.request

import numpy as np

from basicrenderer_tpu_torch.scene.scene import Scene
from basicrenderer_tpu_torch.utils.camera import FlyCamera, OrbitCamera
from basicrenderer_tpu_torch.utils.input import (InputAction, InputPump,
                                                 OrbitContext, WASDContext,
                                                 attach_fly, attach_orbit)


def test_wasd_held_keys_move_fly_camera():
    cam = FlyCamera()
    pump = InputPump(WASDContext())
    attach_fly(pump, cam)
    p0 = cam.position.copy()
    pump.push_raw("key_down", key="w")
    for _ in range(10):
        pump.pump(0.1)                      # 1 second held
    moved = np.linalg.norm(cam.position - p0)
    assert abs(moved - cam.move_speed) < 1e-6
    pump.push_raw("key_up", key="w")
    pump.pump(0.1)
    p1 = cam.position.copy()
    pump.pump(0.1)                          # released: no further motion
    np.testing.assert_array_equal(cam.position, p1)


def test_mouse_drag_rotates_fly_camera():
    cam = FlyCamera()
    pump = InputPump(WASDContext())
    attach_fly(pump, cam)
    yaw0 = cam.yaw
    pump.push_raw("mouse_move", dx=100.0, dy=0.0, buttons=2)
    pump.pump(0.016)
    assert cam.yaw != yaw0
    yaw1 = cam.yaw
    pump.push_raw("mouse_move", dx=100.0, dy=0.0, buttons=0)
    pump.pump(0.016)
    assert cam.yaw == yaw1


def test_orbit_context_zoom_and_rotate():
    cam = OrbitCamera()
    pump = InputPump(OrbitContext())
    attach_orbit(pump, cam)
    d0, yaw0 = cam.distance, cam.yaw
    pump.push_raw("wheel", wheel=1.0)
    pump.push_raw("mouse_move", dx=50.0, dy=0.0, buttons=1)
    pump.pump(0.016)
    assert cam.distance < d0
    assert cam.yaw != yaw0


def test_reset_action_fires():
    fired = []
    ctx = WASDContext()
    ctx.on(InputAction.RESET, lambda m, e: fired.append(m))
    pump = InputPump(ctx)
    pump.push_raw("key_down", key="r")
    assert pump.pump(0.016) == 1
    assert fired == [1.0]


def test_ui_server_input_endpoint():
    from basicrenderer_tpu_torch.renderer import Renderer
    from basicrenderer_tpu_torch.scene.bridge import BridgeCapacities
    from basicrenderer_tpu_torch.utils.ui_server import UIServer
    r = Renderer(caps=BridgeCapacities(
        max_vertices=1 << 8, max_triangles=1 << 8, max_objects=4,
        max_materials=2, max_lights=2), device="cpu")
    sc = Scene()
    sc.set_camera(position=(0, 1, 3), target=(0, 0, 0))
    sc.propagate_transforms()
    r.set_current_scene(sc)
    cam = FlyCamera()
    pump = InputPump(WASDContext())
    attach_fly(pump, cam)
    r.input_pump = pump
    srv = UIServer(r).start()
    try:
        assert srv.url.startswith("http://127.0.0.1:")
        body = json.dumps([{"kind": "key_down", "key": "w"},
                           {"kind": "mouse_move", "dx": 10, "dy": 0,
                            "buttons": 2}]).encode()
        req = urllib.request.Request(
            srv.url + "/api/input", data=body,
            headers={"Content-Type": "application/json"})
        resp = json.load(urllib.request.urlopen(req, timeout=10))
        assert resp == {"queued": 2}
        p0 = cam.position.copy()
        pump.pump(0.1)
        assert np.linalg.norm(cam.position - p0) > 0
    finally:
        srv.stop()


def test_fly_camera_moves_and_looks():
    cam = FlyCamera()
    p0 = cam.position.copy()
    cam.keys(0.5, {"w"})
    assert np.linalg.norm(cam.position - p0) > 1.0
    f0 = cam.forward().copy()
    cam.look(200, 0)
    assert np.linalg.norm(cam.forward() - f0) > 0.1
    sc = Scene()
    cam.apply(sc)
    e1 = sc._primary_camera
    cam.keys(0.1, {"d"})
    cam.apply(sc)
    assert sc._primary_camera == e1   # entity reused, not leaked


def test_orbit_camera():
    cam = OrbitCamera(distance=5.0)
    p0 = cam.position().copy()
    cam.orbit(100, 0)
    assert np.linalg.norm(cam.position() - p0) > 0.5
    cam.zoom(3.0)
    assert np.linalg.norm(cam.position() - cam.target) < 5.0
    sc = Scene()
    cam.apply(sc)
    view, proj, _pos = sc.camera_matrices(aspect=1.0)
    assert np.isfinite(view).all() and np.isfinite(proj).all()


def _camera_run(fly, orbit, scene):
    """Poses and camera matrices after one key, look and orbit sequence."""
    fly.keys(0.3, {"w", "d", "e"})
    fly.look(40, -25)
    orbit.orbit(30, 12)
    orbit.zoom(-1.5)
    fly.apply(scene)
    fly_mats = scene.camera_matrices(aspect=1.5)
    orbit.apply(scene)
    return ([fly.position, fly.forward(), orbit.position()]
            + list(fly_mats) + list(scene.camera_matrices(aspect=1.5)))


def test_cameras_match_jax():
    """The same sequence gives the JAX package's poses and matrices."""
    from basicrenderer_tpu.scene.scene import Scene as JScene
    from basicrenderer_tpu.utils.camera import FlyCamera as JFly
    from basicrenderer_tpu.utils.camera import OrbitCamera as JOrbit
    port = _camera_run(FlyCamera(), OrbitCamera(), Scene())
    ref = _camera_run(JFly(), JOrbit(), JScene())
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_clod_cache_cli_info(capsys, tmp_path, monkeypatch):
    from basicrenderer_tpu_torch.models import clusters
    from basicrenderer_tpu_torch.tools.clod_cache import main
    (tmp_path / "deadbeef.npz").write_bytes(b"x" * 1024)
    monkeypatch.setattr(clusters, "CACHE_DIR", str(tmp_path))
    assert main(["info"]) == 0
    out = capsys.readouterr().out
    assert "artifact" in out and "deadbeef" in out
    monkeypatch.setattr(clusters, "CACHE_DIR", str(tmp_path / "missing"))
    assert main(["info"]) == 0
    assert "cache empty" in capsys.readouterr().out


def test_clod_cache_cli_build(capsys, tmp_path, monkeypatch):
    """`build` imports a model with the port's importer and leaves one LOD
    artifact per heavy mesh in the cache."""
    from basicrenderer_tpu_torch.models import clusters, procedural
    from basicrenderer_tpu_torch.tools.clod_cache import main
    mesh = procedural.make_uv_sphere(0.5, rings=12, sectors=24)
    obj = tmp_path / "sphere.obj"
    lines = [f"v {x} {y} {z}" for x, y, z in mesh.positions]
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in mesh.indices]
    obj.write_text("\n".join(lines) + "\n")
    monkeypatch.setattr(clusters, "CACHE_DIR", tmp_path / "cache")
    assert main(["build", str(obj)]) == 0
    out = capsys.readouterr().out
    assert "sphere.obj[0]" in out and "clusters" in out
    assert len(list((tmp_path / "cache").glob("*.npz"))) == 1
