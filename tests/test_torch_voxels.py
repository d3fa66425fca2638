"""The voxel tiers: the port against the JAX package on the CPU.

Mirrors tests/test_voxels.py and tests/test_voxel_rt_frame.py. Scenes
(each package building them from its own modules): a mirror floor under
an emissive slab above the camera's frustum (only reflected rays see it),
and a large cube with every triangle dropped (the whole frame is voxel
fallback); 128x128 frames with tile_h=16.

Tolerances:
- the voxel grid, its meta row and the SGGX words: equal;
- cone_trace on seeded rays through that grid (with and without SGGX):
  radiance and transmittance within 1e-6 absolute on >= 99.9% of rays;
  the level of a step comes from a log, whose last bit may differ
  between the backends;
- the frames (voxel reflections with IBL, SGGX and SSR; the primary
  fallback): vis equal on >= 99.9% of pixels, image RMSE <= 1.0 on the
  0-255 scale.
"""

import dataclasses
import importlib
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

JAX_PKG = "basicrenderer_tpu"
PORT_PKG = "basicrenderer_tpu_torch"
TRACE_ATOL = 1e-6
TRACE_SHARE = 0.999


def _pkg(root):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(
        procedural=mod("models.procedural"), materials=mod("models.materials"),
        mesh=mod("models.mesh"), bridge=mod("scene.bridge"),
        scene=mod("scene.scene"), voxels=mod("models.voxels"),
        voxel_rt=mod("ops.voxel_rt"), frame=mod("graph.frame"),
        fd=mod("graph.framedata"))


def build(root, variant):
    """(modules, bridge, view matrices, VoxelSceneGrid) of a scene of
    tests/test_voxel_rt_frame.py."""
    m = _pkg(root)
    Material = m.materials.Material
    meshes, mats = m.mesh.MeshRegistry(), m.materials.MaterialRegistry()
    sc = m.scene.Scene()
    if variant == "offscreen":
        plane = meshes.add(m.procedural.make_plane(20.0, 16))
        slab = meshes.add(m.procedural.make_cube(1.0))
        mirror = mats.add(Material(
            base_color=np.array([0.9, 0.9, 0.9, 1], np.float32),
            metallic=1.0, roughness=0.05))
        red = mats.add(Material(
            base_color=np.array([0.9, 0.05, 0.05, 1], np.float32),
            emissive=np.array([6.0, 0.2, 0.2], np.float32)))
        sc.create_renderable(plane, mirror)
        sc.create_renderable(slab, red, position=(0, 6.0, -3.0),
                             scale=(6.0, 0.5, 6.0))
        sc.set_camera(position=(0, 2.0, 5.0), target=(0, 0.0, 1.0),
                      aspect=1.0)
    else:
        cube = meshes.add(m.procedural.make_cube(1.0))
        red = mats.add(Material(
            base_color=np.array([0.9, 0.1, 0.1, 1], np.float32),
            emissive=np.array([2.0, 0.1, 0.1], np.float32)))
        sc.create_renderable(cube, red, position=(0, 0, 0), scale=(4, 4, 4))
        sc.set_camera(position=(0, 0, 9), target=(0, 0, 0), aspect=1.0)
    sc.create_directional_light(direction=(-0.3, -1.0, -0.2), intensity=2.0)
    sc.propagate_transforms()
    caps = m.bridge.BridgeCapacities(max_vertices=1 << 11,
                                     max_triangles=1 << 11, max_objects=8,
                                     max_materials=4, max_lights=4,
                                     max_clusters=16)
    bridge = m.bridge.SceneRenderBridge(sc, meshes, mats, caps)
    vox = bridge.build_voxel_scene(n=32)
    return m, bridge, sc.camera_matrices(aspect=1.0), vox


@pytest.fixture(scope="module")
def scenes():
    return {(root, v): build(root, v) for root in (JAX_PKG, PORT_PKG)
            for v in ("offscreen", "fallback")}


@pytest.mark.parametrize("variant", ["offscreen", "fallback"])
def test_voxel_words_match_jax(scenes, variant):
    _, jb, _, jvox = scenes[(JAX_PKG, variant)]
    _, pb, _, pvox = scenes[(PORT_PKG, variant)]
    np.testing.assert_array_equal(pvox.grid, jvox.grid)
    np.testing.assert_array_equal(pvox.sggx, jvox.sggx)
    np.testing.assert_array_equal(pvox.meta(), jvox.meta())
    assert pvox.level_offsets == jvox.level_offsets
    jbuf = jb.build_scene_buffers()
    pbuf = pb.build_scene_buffers(device="cpu")
    np.testing.assert_array_equal(pbuf.voxel_grid.numpy(),
                                  np.asarray(jbuf.voxel_grid).view(np.int32))
    np.testing.assert_array_equal(pbuf.voxel_sggx.numpy(),
                                  np.asarray(jbuf.voxel_sggx).view(np.int32))
    np.testing.assert_array_equal(pbuf.voxel_meta.numpy(),
                                  np.asarray(jbuf.voxel_meta))
    assert (pvox.grid & 0xFF).max() > 0


def test_static_level_offsets_match_jax():
    jv, pv = _pkg(JAX_PKG).voxels, _pkg(PORT_PKG).voxels
    for n in (1, 2, 16, 32, 64, 128):
        assert pv.static_level_offsets(n) == jv.static_level_offsets(n)
    assert pv.empty_voxel_scene().meta().tolist() == \
        jv.empty_voxel_scene().meta().tolist()


@pytest.mark.parametrize("sggx", [False, True])
def test_cone_trace_matches_jax(scenes, sggx):
    jm, _, _, vox = scenes[(JAX_PKG, "offscreen")]
    pm = scenes[(PORT_PKG, "offscreen")][0]
    rng = np.random.default_rng(11)
    R = 4096
    lo, hi = vox.origin, vox.origin + vox.cell * vox.n
    o = rng.uniform(lo, hi, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    meta = vox.meta()
    kw = dict(steps=12, growth=1.32, cone_tan=0.14)

    def jtrace(grid, sg, origin, cell, px, py, pz, dx, dy, dz):
        return jm.voxel_rt.cone_trace(
            grid, origin, cell, vox.n, vox.level_offsets, px, py, pz, dx, dy,
            dz, sggx=sg if sggx else None, **kw)
    cols = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]]
    j = jax.jit(jtrace)(jnp.asarray(vox.grid), jnp.asarray(vox.sggx),
                        jnp.asarray(meta[0:3]), jnp.asarray(meta[3]),
                        *map(jnp.asarray, cols))
    p = pm.voxel_rt.cone_trace(
        torch.as_tensor(vox.grid.view(np.int32)), torch.as_tensor(meta[0:3]),
        torch.as_tensor(meta[3]), vox.n, vox.level_offsets,
        *map(torch.as_tensor, cols),
        sggx=torch.as_tensor(vox.sggx.view(np.int32)) if sggx else None,
        **kw)
    close = np.ones(R, bool)
    for jc, pc in zip(j, p):
        close &= np.abs(pc.numpy() - np.asarray(jc)) <= TRACE_ATOL
    assert close.mean() >= TRACE_SHARE, close.mean()
    assert (np.asarray(j[3]) < 0.5).mean() > 0.05     # rays that hit


FRAMES = {
    "reflect": ("offscreen", dict(enable_voxel_rt=True)),
    "reflect_ibl_sggx": ("offscreen", dict(enable_voxel_rt=True,
                                           enable_ibl=True, voxel_sggx=True,
                                           enable_ssr=True)),
    "fallback": ("fallback", dict(enable_voxel_fallback=True,
                                  voxel_primary_steps=24)),
    "reflect_off": ("offscreen", dict()),
    "fallback_off": ("fallback", dict()),
}


def _frame(scenes, root, name):
    variant, flags = FRAMES[name]
    m, bridge, (vw, pr, pos), vox = scenes[(root, variant)]
    kw = dict(width=128, height=128, tile_h=16, tile_w=128,
              max_pairs=1 << 12, voxel_n=vox.n,
              voxel_level_offsets=vox.level_offsets, voxel_rt_downscale=2,
              voxel_rt_steps=20, **flags)
    if root == JAX_PKG:
        buf = bridge.build_scene_buffers()
        if variant == "fallback":       # nothing rasters: all fallback
            buf = buf.replace(tri_object=jnp.full_like(buf.tri_object, -1))
        out = jax.jit(m.frame.build_frame_fn(m.fd.FrameConfig(
            **kw, use_pallas_raster=False)))(
            buf, m.fd.make_view(vw, pr, pos), m.fd.FrameParams.default())
        return {k: np.asarray(out[k]) for k in ("vis", "image")}
    buf = bridge.build_scene_buffers(device="cpu")
    if variant == "fallback":
        buf = dataclasses.replace(buf, tri_object=torch.full_like(
            buf.tri_object, -1))
    out = m.frame.build_frame_fn(m.fd.FrameConfig(**kw))(
        buf, m.fd.make_view(vw, pr, pos, device="cpu"),
        m.fd.FrameParams.default("cpu"))
    return {k: out[k].numpy() for k in ("vis", "image")}


COMPARED = ("reflect_ibl_sggx", "fallback")


@pytest.fixture(scope="module")
def frames(scenes):
    """{name: (JAX outputs or None, port outputs)}: the JAX frames of
    COMPARED compile on threads while the port renders every frame."""
    with ThreadPoolExecutor(len(COMPARED)) as pool:
        jfut = {n: pool.submit(_frame, scenes, JAX_PKG, n) for n in COMPARED}
        pouts = {n: _frame(scenes, PORT_PKG, n) for n in FRAMES}
        return {n: (jfut[n].result() if n in jfut else None, pouts[n])
                for n in FRAMES}


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float32)
                                  - np.asarray(b, np.float32)) ** 2)))


@pytest.mark.parametrize("name", COMPARED)
def test_voxel_frames_match_jax(frames, name):
    jout, pout = frames[name]
    assert (pout["vis"] == jout["vis"]).mean() >= 0.999
    assert _rmse(pout["image"], jout["image"]) <= 1.0


def test_reflections_show_offscreen_slab(frames):
    """The JAX package's check on the port's frames: the reflected slab
    reddens the floor, which SSR cannot do."""
    img = frames["reflect"][1]["image"].astype(np.float32)
    img0 = frames["reflect_off"][1]["image"].astype(np.float32)
    floor = frames["reflect"][1]["vis"] > 0
    assert floor.mean() > 0.5
    zone = np.zeros_like(floor)
    zone[40:110, 30:98] = True
    sel = floor & zone
    red_on = (img[..., 0][sel] - img[..., 2][sel]).mean()
    red_off = (img0[..., 0][sel] - img0[..., 2][sel]).mean()
    assert red_on > red_off + 8, (red_on, red_off)


def test_primary_fallback_fills_uncovered_pixels(frames):
    img = frames["fallback"][1]["image"].astype(np.float32)
    assert (frames["fallback"][1]["vis"] > 0).mean() == 0.0
    center, border = img[44:84, 44:84], img[:8, :]
    assert (center[..., 0] - center[..., 2]).mean() > 12
    assert (border[..., 0] - border[..., 2]).mean() < 4
    c0 = frames["fallback_off"][1]["image"].astype(np.float32)[44:84, 44:84]
    assert (c0[..., 0] - c0[..., 2]).mean() < 4


def test_renderer_voxel_rebuild_on_light_change():
    """The Renderer bakes the grid when the voxel tier is on and rebakes it
    when a light changes, as the JAX Renderer does."""
    from basicrenderer_tpu_torch.models import procedural
    from basicrenderer_tpu_torch.models.materials import Material
    from basicrenderer_tpu_torch.renderer import Renderer
    from basicrenderer_tpu_torch.scene.components import Light
    from basicrenderer_tpu_torch.scene.scene import Scene
    r = Renderer(caps=_pkg(PORT_PKG).bridge.BridgeCapacities(
        max_vertices=1 << 10, max_triangles=1 << 10, max_objects=4,
        max_materials=4, max_lights=4, max_clusters=64,
        max_geom_clusters=64), device="cpu")
    for k, v in (("renderResolution", (64, 64)), ("enableVoxelRT", True),
                 ("voxelResolution", 16), ("enableShadows", False)):
        r.settings.set(k, v)
    cube = r.meshes.add(procedural.make_cube(1.0))
    red = r.materials.add(Material(
        base_color=np.array([0.8, 0.1, 0.1, 1], np.float32)))
    sc = Scene()
    sc.create_renderable(cube, red, position=(0, 0.5, 0))
    light = sc.create_directional_light(direction=(-0.4, -1, -0.3),
                                        intensity=3.0)
    sc.set_camera(position=(3, 2, 4), target=(0, 0.5, 0))
    r.set_current_scene(sc)
    r.update()
    assert r.render_to_numpy().shape[:2] == (64, 64)
    cfg = r.current_config()
    assert cfg.enable_voxel_rt and cfg.voxel_n == 16
    assert cfg.voxel_level_offsets == \
        _pkg(PORT_PKG).voxels.static_level_offsets(16)
    grid1 = r._buffers.voxel_grid.clone()
    assert grid1.numel() > 1 and (grid1 & 0xFF).max() > 0
    h1 = r._voxel_hash
    sc.world.get(light, Light).intensity = 0.5
    r.update()
    assert r._voxel_hash != h1
    assert (r._buffers.voxel_grid != grid1).any()

