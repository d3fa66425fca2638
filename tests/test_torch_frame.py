"""The whole soup frame: port vs the JAX frame program on the CPU.

Scene: tests/test_frame_e2e.build_test_scene (the golden scene), built by
each package from its own host modules, at 128x128 with tile_h=16.

Parity levels:
- `vis` equal on every pixel. The port's soup setup spells the vertex
  transform and the near-plane clip in the fused multiply-add chains
  XLA's CPU backend evaluates them with (tests/test_torch_raster_setup.py
  holds those lanes bit for bit), so no pixel on an edge moves.
- image RMSE vs the JAX frame <= 1.0 on the 0-255 scale (measured 0.0).
- image RMSE vs tests/goldens/basic_deferred.png <= 6, the check of
  tests/test_goldens.py.
- equal bin_overflow and num_pairs.
"""

import dataclasses
import os

import numpy as np
import jax
import pytest
import torch

from basicrenderer_tpu.graph.frame import build_frame_fn as j_build_frame_fn
from basicrenderer_tpu.graph.framedata import FrameConfig as JConfig
from basicrenderer_tpu.graph.framedata import FrameParams as JParams
from basicrenderer_tpu.graph.framedata import make_view as j_make_view
from basicrenderer_tpu_torch.graph.frame import build_frame_fn
from basicrenderer_tpu_torch.graph.framedata import FrameConfig, FrameParams, make_view
from basicrenderer_tpu_torch.utils.png import read_png

from tests.test_torch_bridge import JAX_PKG, PORT_PKG, build_scene

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "basic_deferred.png")
CFG_KW = dict(width=128, height=128, tile_h=16, tile_w=128, max_pairs=1 << 12,
              use_pallas_raster=False)


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float32)
                                  - np.asarray(b, np.float32)) ** 2)))


def _frames(variant):
    jsc, jb = build_scene(JAX_PKG, variant)
    view, proj, pos = jsc.camera_matrices(aspect=1.0)
    jout = jax.jit(j_build_frame_fn(JConfig(**CFG_KW)))(
        jb.build_scene_buffers(), j_make_view(view, proj, pos), JParams.default())
    psc, pb = build_scene(PORT_PKG, variant)
    view, proj, pos = psc.camera_matrices(aspect=1.0)
    pout = build_frame_fn(FrameConfig(**CFG_KW))(
        pb.build_scene_buffers(device="cpu"),
        make_view(view, proj, pos, device="cpu"), FrameParams.default("cpu"))
    return ({k: np.asarray(v) for k, v in jout.items()},
            {k: v.numpy() for k, v in pout.items()})


@pytest.fixture(scope="module")
def basic_frames():
    return _frames("basic")


def test_frame_vis_matches_jax(basic_frames):
    jout, pout = basic_frames
    agree = (pout["vis"] == jout["vis"]).mean()
    assert agree == 1.0, f"vis agreement {agree:.5f}"
    assert 0.3 < (pout["vis"] > 0).mean() < 0.95


def test_frame_image_matches_jax(basic_frames):
    jout, pout = basic_frames
    assert pout["image"].shape == jout["image"].shape == (128, 128, 3)
    assert pout["image"].dtype == np.uint8
    assert _rmse(pout["image"], jout["image"]) <= 1.0


def test_frame_matches_golden(basic_frames):
    _, pout = basic_frames
    assert _rmse(pout["image"], read_png(GOLDEN)) <= 6.0


def test_frame_counters_and_keys_match_jax(basic_frames):
    jout, pout = basic_frames
    assert set(pout) == set(jout)
    for k in ("bin_overflow", "num_pairs", "cluster_overflow",
              "light_overflow", "oit_overflow"):
        assert int(pout[k]) == int(jout[k]), k
    assert int(pout["bin_overflow"]) == 0


def test_frame_with_local_lights_matches_jax():
    """Point and spot lights, metals and emissive through the same path."""
    jout, pout = _frames("mixed")
    assert (pout["vis"] == jout["vis"]).mean() == 1.0
    assert _rmse(pout["image"], jout["image"]) <= 1.0


@pytest.mark.parametrize("field,value", [
    ("enable_texture_streaming", True),
    ("enable_voxel_rt", True), ("enable_skinning", True),
    ("enable_rt_reflect", True), ("enable_streaming", True),
    ("enable_voxel_fallback", True), ("cut_windows", 2),
])
def test_unported_toggles_raise(field, value):
    """The toggles the port once refused build now, through the frame
    function and the program cache, the config keeping the value."""
    from basicrenderer_tpu_torch.graph.frame import (FrameProgramCache,
                                                     check_config)
    cfg = dataclasses.replace(FrameConfig(**CFG_KW), **{field: value})
    check_config(cfg)
    assert callable(build_frame_fn(cfg))
    assert getattr(cfg, field) == value
    cache = FrameProgramCache()
    assert cache.get(cfg) is cache.get(dataclasses.replace(cfg))


def test_png_reader_matches_imageio():
    import imageio.v3 as iio
    for name in ("basic_deferred.png", "g512_oit.png"):
        path = os.path.join(os.path.dirname(GOLDEN), name)
        if not os.path.exists(path):
            continue
        np.testing.assert_array_equal(read_png(path), iio.imread(path))
    assert read_png(GOLDEN).shape == (128, 128, 3)


def flagship_scene(full=False):
    """__graft_entry__._build_small_inputs(full=full)'s scene from the
    port's modules: a floor, a checkered red cube, a gold sphere and a
    glass cube (the cube mesh instanced twice), a directional and a point
    light, 256x128; its bridge carries the textures only with `full`, as
    there."""
    from basicrenderer_tpu_torch.models import procedural
    from basicrenderer_tpu_torch.models.materials import (Material,
                                                          MaterialRegistry)
    from basicrenderer_tpu_torch.models.mesh import MeshRegistry
    from basicrenderer_tpu_torch.models.textures import TextureRegistry
    from basicrenderer_tpu_torch.scene.bridge import (BridgeCapacities,
                                                      SceneRenderBridge)
    from basicrenderer_tpu_torch.scene.scene import Scene
    meshes, mats = MeshRegistry(), MaterialRegistry()
    tex = TextureRegistry(resolution=64)
    checker = tex.checkerboard()
    cube = meshes.add(procedural.make_cube(1.0))
    sphere = meshes.add(procedural.make_uv_sphere(0.5, rings=8, sectors=16))
    plane = meshes.add(procedural.make_plane(10.0, 2))
    red = mats.add(Material(base_color=np.array([0.8, 0.1, 0.1, 1],
                                                np.float32),
                            base_color_texture=checker))
    gold = mats.add(Material(base_color=np.array([0.9, 0.7, 0.3, 1],
                                                 np.float32),
                             metallic=1.0, roughness=0.3))
    glass = mats.add(Material(base_color=np.array([0.5, 0.7, 0.9, 0.5],
                                                  np.float32),
                              alpha_blend=True, roughness=0.1))
    sc = Scene()
    sc.create_renderable(plane, 0)
    sc.create_renderable(cube, red, position=(0, 0.5, 0))
    sc.create_renderable(sphere, gold, position=(1.4, 0.5, 0.3))
    sc.create_renderable(cube, glass, position=(0.6, 0.5, 1.2),
                         scale=(0.6, 0.6, 0.6))
    sc.create_directional_light(direction=(-0.4, -1, -0.3), intensity=3.0)
    sc.create_point_light(position=(0, 2, 2), intensity=10.0, range=10.0)
    sc.set_camera(position=(3, 2.5, 4), target=(0, 0.5, 0), aspect=2.0)
    sc.propagate_transforms()
    caps = BridgeCapacities(max_vertices=1 << 12, max_triangles=1 << 12,
                            max_objects=16, max_materials=8, max_lights=8,
                            max_clusters=256)
    return sc, SceneRenderBridge(sc, meshes, mats, caps,
                                 textures=tex if full else None)


def test_flagship_frame_matches_jax():
    """The frame of __graft_entry__.entry() (the default FrameConfig at
    256x128 over _build_small_inputs' scene): the port on its own rebuild
    of the scene vs jax.jit(build_frame_fn) on _build_small_inputs
    (pallas=False)."""
    from __graft_entry__ import _build_small_inputs
    jcfg, jbuf, jvd, jparams = _build_small_inputs(pallas=False)
    jout = jax.jit(j_build_frame_fn(jcfg))(jbuf, jvd, jparams)
    sc, bridge = flagship_scene()
    pcfg = FrameConfig(width=256, height=128, tile_h=16, tile_w=128,
                       max_pairs=1 << 13)
    pout = build_frame_fn(pcfg)(
        bridge.build_scene_buffers(device="cpu"),
        make_view(*sc.camera_matrices(aspect=2.0), device="cpu"),
        FrameParams.default("cpu"))
    np.testing.assert_array_equal(pout["vis"].numpy(), np.asarray(jout["vis"]))
    assert 0.3 < (pout["vis"].numpy() > 0).mean() < 0.95
    assert _rmse(pout["image"].numpy(), np.asarray(jout["image"])) <= 1.0


def clod_textured_scene():
    """tests/test_goldens.py's clod_textured scene from the port's modules:
    a cluster-LOD sphere with a checkered base colour under one
    directional light."""
    from basicrenderer_tpu_torch.models import clusters, procedural
    from basicrenderer_tpu_torch.models.materials import (Material,
                                                          MaterialRegistry)
    from basicrenderer_tpu_torch.models.mesh import MeshRegistry
    from basicrenderer_tpu_torch.models.textures import TextureRegistry
    from basicrenderer_tpu_torch.scene.bridge import (BridgeCapacities,
                                                      SceneRenderBridge)
    from basicrenderer_tpu_torch.scene.scene import Scene
    cl = clusters.build_cluster_lod(
        procedural.make_uv_sphere(1.0, rings=32, sectors=64), use_cache=False)
    meshes, mats = MeshRegistry(), MaterialRegistry()
    tex = TextureRegistry(resolution=64)
    checker = tex.checkerboard(a=(1, 1, 1), b=(0.1, 0.1, 0.1), squares=8)
    mid = meshes.add(clusters.to_mesh_data(cl))
    m = mats.add(Material(base_color=np.array([0.9, 0.7, 0.4, 1], np.float32),
                          roughness=0.5, base_color_texture=checker))
    sc = Scene()
    sc.create_renderable(mid, m)
    sc.create_directional_light(direction=(-0.4, -1, -0.3), intensity=3.0)
    sc.set_camera(position=(0, 0.5, 2.8), target=(0, 0, 0), aspect=1.0)
    sc.propagate_transforms()
    caps = BridgeCapacities(max_vertices=1 << 15, max_triangles=1 << 15,
                            max_objects=8, max_materials=4, max_lights=4,
                            max_clusters=1 << 10, max_geom_clusters=1 << 10)
    return sc, SceneRenderBridge(sc, meshes, mats, caps, textures=tex)


def test_clod_textured_golden():
    """tests/test_goldens.py's clod_textured frame (cluster LOD + base
    colour texture at texture_downscale 1) rendered by the port on the
    CPU, against the golden PNG at the golden limit."""
    sc, bridge = clod_textured_scene()
    cfg = FrameConfig(width=128, height=128, tile_h=16, tile_w=128,
                      max_pairs=1 << 14, enable_clod=True,
                      enable_textures=True, texture_downscale=1)
    out = build_frame_fn(cfg)(bridge.build_scene_buffers(device="cpu"),
                              make_view(*sc.camera_matrices(aspect=1.0),
                                        device="cpu"),
                              FrameParams.default("cpu"))
    golden = read_png(os.path.join(os.path.dirname(GOLDEN),
                                   "clod_textured.png"))
    assert _rmse(out["image"].numpy(), golden) <= 6.0
