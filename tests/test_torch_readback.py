"""The port's async readback service (utils/readback.py):
tests/test_readback.py on the port. Futures resolve to the right numpy
values in request order, errors surface through the future, backpressure
bounds in-flight requests, and the Renderer's render_async gives the
synchronous image. The pinned-memory side-stream copy runs on the card
only (the `cuda` test)."""

import time

import numpy as np
import pytest
import torch

from basicrenderer_tpu_torch.utils.readback import ReadbackManager


def test_readback_resolves_values_in_order():
    rb = ReadbackManager(max_in_flight=2)
    futs = [rb.request({"x": torch.full((4,), float(i)), "n": [i, (i,)]})
            for i in range(5)]
    outs = [f.result(timeout=30) for f in futs]
    for i, o in enumerate(outs):
        np.testing.assert_allclose(o["x"], np.full((4,), float(i)))
        assert isinstance(o["x"], np.ndarray)
        assert o["n"][0] == i and o["n"][1] == (i,)
    rb.close()


def test_readback_copies_at_request():
    """The value read back is the tensor as it was when requested."""
    rb = ReadbackManager()
    x = torch.zeros(3)
    fut = rb.request(x, post=lambda a: (time.sleep(0.05), a)[1])
    x += 1.0
    np.testing.assert_array_equal(fut.result(timeout=30), np.zeros(3))
    rb.close()


def test_readback_post_hook_runs_on_worker():
    rb = ReadbackManager()
    fut = rb.request(torch.arange(8.0), post=lambda a: float(a.sum()))
    assert fut.result(timeout=30) == 28.0
    rb.close()


def test_readback_error_surfaces_through_future():
    rb = ReadbackManager()
    fut = rb.request(torch.arange(4.0), post=lambda a: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        fut.result(timeout=30)
    # The manager survives a failed request.
    assert rb.request(torch.ones(2)).result(timeout=30).sum() == 2.0
    rb.close()


def test_readback_backpressure_bounds_in_flight():
    rb = ReadbackManager(max_in_flight=2)
    slow = lambda a: (time.sleep(0.15), a)[1]
    t0 = time.monotonic()
    futs = [rb.request(torch.ones(2), post=slow) for _ in range(4)]
    # The 3rd/4th requests waited for slots.
    assert time.monotonic() - t0 > 0.25
    for f in futs:
        f.result(timeout=30)
    rb.close()
    with pytest.raises(RuntimeError, match="closed"):
        rb.request(torch.ones(1))


def test_renderer_render_async_matches_sync():
    from basicrenderer_tpu_torch.models import procedural
    from basicrenderer_tpu_torch.models.materials import Material
    from basicrenderer_tpu_torch.renderer import Renderer
    from basicrenderer_tpu_torch.scene.bridge import BridgeCapacities
    from basicrenderer_tpu_torch.scene.scene import Scene
    r = Renderer(caps=BridgeCapacities(
        max_vertices=1 << 10, max_triangles=1 << 10, max_objects=8,
        max_materials=4, max_lights=4), device="cpu")
    cube = r.meshes.add(procedural.make_cube(1.0))
    red = r.materials.add(Material(
        base_color=np.array([.8, .1, .1, 1], np.float32)))
    sc = Scene()
    sc.create_renderable(cube, red, position=(0, 0.5, 0))
    sc.create_directional_light(direction=(-.4, -1, -.3), intensity=3)
    sc.set_camera(position=(3, 2, 4), target=(0, .5, 0))
    sc.propagate_transforms()
    r.settings.set("renderResolution", (128, 128))
    r.settings.set("maxTrianglePairs", 1 << 12)
    r.settings.set("enableShadows", False)
    r.set_current_scene(sc)
    r.update()
    sync_img = r.render_to_numpy()
    r.update()
    out = r.render_async(keys=("image", "vis", "missing")).result(timeout=60)
    assert set(out) == {"image", "vis"}
    np.testing.assert_array_equal(out["image"], sync_img)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the pinned side-stream copy is a "
                    "card path")
    return torch.device("cuda")


@pytest.mark.cuda
def test_readback_from_the_card(cuda_device):
    """On the card: the pinned side-stream copies equal the tensors, in
    request order, even when the source is freed right after."""
    rb = ReadbackManager(max_in_flight=2)
    futs = []
    for i in range(6):
        x = torch.full((1 << 20,), float(i), device=cuda_device)
        futs.append(rb.request({"x": x * 2.0}))
        del x
    for i, f in enumerate(futs):
        assert (f.result(timeout=60)["x"] == 2.0 * i).all()
    rb.close()
