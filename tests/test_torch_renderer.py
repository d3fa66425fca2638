"""The port's Renderer (basicrenderer_tpu_torch/renderer.py) against the JAX
package's Renderer on the CPU, and the frame's debug views, wireframe
overlay, program cache and profiling.

Each scene is built twice, once from each package's own modules, and
driven through each package's Renderer with the same settings.

Parity levels:
- current_config(): every FrameConfig field equal to the JAX Renderer's
  but `use_pallas_raster` (a JAX backend switch, left at its default).
- frames of tests/test_scene_overlap.py's (its cascades cut to 2 x 256^2
  in both packages, for CPU time) and tests/test_motion.py::
  test_taa_no_ghost_moving_object's scenes: vis equal on every pixel of
  every frame, the floor's near-clip rows included, and image RMSE <= 1.0
  (0-255) on every frame of both.
- each debug view and the wireframe overlay of tests/test_frame_e2e.py's
  scene at 128x128: vis equal, image RMSE <= 1.0 and the same output keys
  as the JAX frame's.
"""

import dataclasses
import importlib
import inspect

import numpy as np
import jax
import pytest
import torch

from tests.test_torch_bridge import JAX_PKG, PORT_PKG, build_scene

SMALL_CAPS = dict(max_vertices=1 << 12, max_triangles=1 << 12, max_objects=8,
                  max_materials=4, max_lights=4)


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float32)
                                  - np.asarray(b, np.float32)) ** 2)))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def make_renderer(root, caps=SMALL_CAPS, **settings):
    """(renderer, package modules) of `root` with `settings` applied."""
    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    caps = mod("scene.bridge").BridgeCapacities(**caps)
    kw = dict(device="cpu") if root == PORT_PKG else {}
    r = mod("renderer").Renderer(caps=caps, **kw)
    for k, v in settings.items():
        r.settings.set(k, v)
    return r, mod


# The overlap frames' cascades, cut from the default 4 x 1024^2 for CPU
# time (the same settings in both packages).
CHEAP_SHADOWS = dict(numShadowCascades=2, shadowResolution=256)


def overlap_scene(root, overlap, **settings):
    """tests/test_scene_overlap.py::_build from `root`'s modules, with
    `settings` applied."""
    r, mod = make_renderer(root, renderResolution=(128, 128),
                           maxTrianglePairs=1 << 12,
                           enableSceneOverlap=overlap, **settings)
    cube = r.meshes.add(mod("models.procedural").make_cube(1.0))
    red = r.materials.add(mod("models.materials").Material(
        base_color=np.array([.8, .1, .1, 1], np.float32)))
    sc = mod("scene.scene").Scene()
    ent = sc.create_renderable(cube, red, position=(0.0, 0.5, 0.0))
    sc.create_directional_light(direction=(-.4, -1, -.3), intensity=3)
    sc.set_camera(position=(3, 2, 4), target=(0, .5, 0))
    sc.propagate_transforms()
    r.set_current_scene(sc)
    return r, sc, ent, mod("scene.components").Position


def _frame(r):
    out = r.render()
    return _np(out["image"]), _np(out["vis"])


def _drain(r):
    if r._update_future is not None:
        r._update_future.result()


def test_renderer_defaults_to_the_card():
    from basicrenderer_tpu_torch.renderer import Renderer
    default = inspect.signature(Renderer).parameters["device"].default
    assert default == "cuda"
    try:
        r = Renderer()
    except RuntimeError:     # no nvcc or no card here: no CPU fallback
        return
    assert r.device.type == "cuda"


def rich_scene(root):
    """A scene that turns on every material-, light- and texture-derived
    FrameConfig field: textures on every channel, an alpha-MASK and an
    OpenPBR material, shadow-casting spot and point lights, an instanced
    mesh (forces enableClod)."""
    r, mod = make_renderer(root, caps=dict(SMALL_CAPS, max_lights=8))
    M = mod("models.materials").Material
    tex = r.textures.checkerboard()
    cube = r.meshes.add(mod("models.procedural").make_cube(1.0))
    mats = [r.materials.add(M(base_color_texture=tex, normal_texture=tex,
                              metallic_roughness_texture=tex,
                              emissive_texture=tex)),
            r.materials.add(M(alpha_cutoff=0.5, coat_weight=0.5,
                              fuzz_weight=0.3, subsurface_weight=0.2,
                              anisotropy_strength=0.4,
                              transmission_weight=0.5))]
    sc = mod("scene.scene").Scene()
    for k, m in enumerate(mats):
        sc.create_renderable(cube, m, position=(k * 2.0, 0.5, 0.0))
    sc.create_directional_light(direction=(-.4, -1, -.3), intensity=3)
    for k in range(5):
        sc.create_spot_light(position=(k, 3, 0), cast_shadows=True)
    sc.create_point_light(position=(0, 2, 2), cast_shadows=True)
    sc.set_camera(position=(3, 2, 4), target=(0, .5, 0))
    sc.propagate_transforms()
    r.set_current_scene(sc)
    return r


@pytest.mark.parametrize("case", ["defaults", "rich", "settings"])
def test_current_config_matches_jax(case):
    changes = {}
    if case == "settings":
        changes = dict(
            renderResolution=(320, 200), tileSize=(16, 128),
            upscaleMode="taa", outputResolution=(640, 400), enableVSM=True,
            vsmNumLights=2, enableGTAO=True, enableSSR=True, enableOIT=True,
            oitLayers=2, maskPeels=2, vertexTangents=True,
            enableEnergyCompensation=True, enableAutoExposure=True,
            enableOcclusionCulling=True, maxVisibleClusters=512,
            debugView="albedo", wireframe=True, enableReyes=True,
            reyesTriBudget=1024, reyesDiceRate=3, reyesPixelThreshold=20.0,
            reyesSplitBudget=16, reyesSplitFactor=2.0, voxelResolution=32,
            textureFormat="bc3", enableShadows=False)
    configs = []
    for root in (JAX_PKG, PORT_PKG):
        if case == "rich":
            r = rich_scene(root)
        else:
            r = overlap_scene(root, False)[0]
        for k, v in changes.items():
            r.settings.set(k, v)
        configs.append(r.current_config())
    jc, pc = configs
    fields = [f.name for f in dataclasses.fields(jc)]
    assert fields == [f.name for f in dataclasses.fields(pc)]
    differ = {f: (getattr(pc, f), getattr(jc, f)) for f in fields
              if f != "use_pallas_raster" and getattr(pc, f) != getattr(jc, f)}
    assert not differ
    assert pc.use_pallas_raster == type(pc)().use_pallas_raster
    if case == "rich":
        assert pc.enable_clod and pc.enable_textures and pc.enable_coat
        assert (pc.max_shadow_lights, pc.max_shadow_cubes) == (4, 1)
        assert pc.tex_channels == ("base", "normal", "mr", "emissive")


@pytest.fixture(scope="module")
def jax_overlap_frames():
    """The JAX Renderer's sync frames of the overlap scene: before and
    after the deferred move."""
    r, sc, ent, Position = overlap_scene(JAX_PKG, False, **CHEAP_SHADOWS)
    r.update()
    f0 = _frame(r)
    sc.world.defer(lambda: sc.world.set(ent, Position(
        np.array([1.0, 0.5, 0.0], np.float32))))
    r.update()
    return f0, _frame(r)


def test_overlap_matches_sync_and_jax(jax_overlap_frames):
    """tests/test_scene_overlap.py on the port (the overlapped mode gives
    the synchronous mode's images, deferred edits one commit later), and
    the synchronous frames against the JAX Renderer's."""
    rs, ss, es, Position = overlap_scene(PORT_PKG, False, **CHEAP_SHADOWS)
    ro, so, eo, _ = overlap_scene(PORT_PKG, True, **CHEAP_SHADOWS)
    rs.update()
    s0 = _frame(rs)
    ro.update()
    o0 = _frame(ro)
    np.testing.assert_array_equal(s0[0], o0[0])
    _drain(ro)
    move = np.array([1.0, 0.5, 0.0], np.float32)
    so.world.defer(lambda: so.world.set(eo, Position(move)))
    ss.world.defer(lambda: ss.world.set(es, Position(move)))
    rs.update()
    s1 = _frame(rs)
    assert np.abs(s1[0].astype(int) - s0[0].astype(int)).max() > 0
    ro.update()
    np.testing.assert_array_equal(_frame(ro)[0], o0[0])   # 1-frame latency
    _drain(ro)
    ro.update()
    np.testing.assert_array_equal(_frame(ro)[0], s1[0])
    ro.settings.set("enableSceneOverlap", False)
    ro.update()
    np.testing.assert_array_equal(_frame(ro)[0], s1[0])
    assert "scene_commit" in ro.telemetry.history[-2]["stages"]
    for (pimg, pvis), (jimg, jvis) in zip((s0, s1), jax_overlap_frames):
        np.testing.assert_array_equal(pvis, jvis)
        assert _rmse(pimg, jimg) <= 1.0


def ghost_run(root):
    """tests/test_motion.py::test_taa_no_ghost_moving_object's sequence
    through `root`'s Renderer: [(hdr, image, vis)] of its 7 frames."""
    r, mod = make_renderer(
        root, caps=dict(SMALL_CAPS, max_vertices=1 << 10,
                        max_triangles=1 << 10, max_clusters=32),
        maxTrianglePairs=1 << 12, renderResolution=(256, 128),
        enableTAA=True, taaBlend=0.1, enableBloom=False,
        enableShadows=False, enableClusteredLighting=False, enableIBL=False)
    proc, M = mod("models.procedural"), mod("models.materials").Material
    Position = mod("scene.components").Position
    cube = r.meshes.add(proc.make_cube())
    plane = r.meshes.add(proc.make_plane(30.0))
    bright = r.materials.add(M(base_color=(0.1, 0.1, 0.1, 1.0),
                               emissive=(8.0, 8.0, 8.0)))
    dark = r.materials.add(M(base_color=(0.02, 0.02, 0.02, 1.0)))
    scene = mod("scene.scene").Scene()
    scene.create_renderable(plane, dark, position=(0, -1.0, 0))
    e = scene.create_renderable(cube, bright, position=(-2.0, 0.0, 0.0))
    scene.set_camera(position=(0, 1.5, 8), target=(0, 0, 0), aspect=2.0)
    scene.create_directional_light(direction=(-0.3, -1.0, -0.2),
                                   intensity=0.5)
    r.set_current_scene(scene)
    frames = []
    for x in np.linspace(-2.0, 2.0, 7):
        scene.world.set(e, Position(np.array([x, 0.0, 0.0], np.float32)))
        r.update(1 / 60)
        out = r.render()
        frames.append((_np(out["hdr"]), _np(out["image"]), _np(out["vis"])))
    return frames


def test_taa_no_ghost_matches_jax():
    pframes, jframes = ghost_run(PORT_PKG), ghost_run(JAX_PKG)
    img = pframes[-1][0]
    H, W = img.shape[:2]
    band = img[int(H * 0.45):int(H * 0.55), int(W * 0.12):int(W * 0.30)]
    assert float(band.max()) < 1.0, "ghost trail"
    right = img[int(H * 0.3):int(H * 0.7), int(W * 0.55):int(W * 0.95)]
    assert float(right.max()) > 4.0
    for i, ((_ph, pimg, pvis), (_jh, jimg, jvis)) in enumerate(
            zip(pframes, jframes)):
        np.testing.assert_array_equal(pvis, jvis, err_msg=f"frame {i}")
        err = _rmse(pimg, jimg)
        assert err <= 1.0, f"frame {i}: image RMSE {err:.4f}"


VIEWS = ("normals", "depth", "albedo", "material", "clusters", "ao", "uv",
         "wireframe")


def _view_flags(view):
    if view == "wireframe":
        return dict(wireframe=True)
    return dict(debug_view=view, enable_gtao=view == "ao")


@pytest.fixture(scope="module")
def jax_views():
    """The JAX frame of tests/test_frame_e2e.py's scene in every view."""
    from basicrenderer_tpu.graph.frame import build_frame_fn
    from basicrenderer_tpu.graph.framedata import FrameParams, make_view
    from tests.test_frame_e2e import CFG
    sc, bridge = build_scene(JAX_PKG, "basic")
    buf = bridge.build_scene_buffers()
    vd = make_view(*sc.camera_matrices(aspect=1.0))
    params = FrameParams.default()

    def run(view):
        fn = jax.jit(build_frame_fn(dataclasses.replace(CFG,
                                                        **_view_flags(view))))
        return {k: np.asarray(v) for k, v in fn(buf, vd, params).items()}
    return {view: run(view) for view in VIEWS}


@pytest.mark.parametrize("view", VIEWS)
def test_debug_view_matches_jax(view, jax_views):
    """tests/test_frame_e2e.py::test_debug_views on the port, for every
    view and the wireframe, against the JAX frame."""
    from basicrenderer_tpu_torch.graph.frame import build_frame_fn
    from basicrenderer_tpu_torch.graph.framedata import (FrameConfig,
                                                         FrameParams,
                                                         make_view)
    sc, bridge = build_scene(PORT_PKG, "basic")
    cfg = FrameConfig(width=128, height=128, tile_h=16, tile_w=128,
                      max_pairs=1 << 12, **_view_flags(view))
    out = build_frame_fn(cfg)(bridge.build_scene_buffers(device="cpu"),
                              make_view(*sc.camera_matrices(aspect=1.0),
                                        device="cpu"),
                              FrameParams.default("cpu"))
    out = {k: _np(v) for k, v in out.items()}
    jout = jax_views[view]
    assert set(out) == set(jout)
    img, vis = out["image"], out["vis"]
    assert img.shape == (128, 128, 3)
    assert img[vis > 0].std() > 1
    np.testing.assert_array_equal(vis, jout["vis"])
    assert _rmse(img, jout["image"]) <= 1.0
    if view == "wireframe":
        green = (img[..., 1] > 200) & (img[..., 0] < 120)
        assert green.sum() > 100


def test_wireframe_skipped_under_taau():
    """Under TAAU the HDR frame is output-size, so the overlay (drawn from
    the render-size vis buffer) is skipped, as in the JAX frame."""
    from basicrenderer_tpu_torch.graph.frame import build_frame_fn
    from basicrenderer_tpu_torch.graph.framedata import (FrameConfig,
                                                         FrameParams,
                                                         make_view)
    sc, bridge = build_scene(PORT_PKG, "basic")
    buf = bridge.build_scene_buffers(device="cpu")
    vd = make_view(*sc.camera_matrices(aspect=1.0), device="cpu")
    kw = dict(width=64, height=64, tile_h=16, tile_w=128, max_pairs=1 << 12,
              enable_taa=True, output_width=128, output_height=128)
    imgs = [build_frame_fn(FrameConfig(**kw, wireframe=w))(
        buf, vd, FrameParams.default("cpu"))["image"] for w in (False, True)]
    assert imgs[0].shape == (128, 128, 3)
    assert torch.equal(imgs[0], imgs[1])


def test_frame_program_cache():
    from basicrenderer_tpu_torch.graph.frame import FrameProgramCache
    from basicrenderer_tpu_torch.graph.framedata import FrameConfig
    cache = FrameProgramCache()
    a = cache.get(FrameConfig(width=64, height=64))
    assert cache.get(FrameConfig(width=64, height=64)) is a
    assert cache.get(FrameConfig(width=64, height=64, wireframe=True)) is not a
    # Every toggle of the JAX package builds (enable_streaming among them).
    assert cache.get(FrameConfig(enable_streaming=True)) is not a


@pytest.mark.parametrize("setting", ["enableStreaming",
                                     "enableTextureStreaming",
                                     "enableVoxelRT", "enableVoxelFallback",
                                     "enableRTReflections",
                                     "enableSkinning"])
def test_unported_settings_raise(setting):
    """The settings the port once refused (streaming, the voxel tiers, RT
    reflections, skinning) are ported: each one reaches the FrameConfig
    as the JAX Renderer's current_config() gives it, and update() runs
    its host work (the streamers' bring-up, the voxel bake)."""
    configs = []
    for root in (JAX_PKG, PORT_PKG):
        r = overlap_scene(root, False, **CHEAP_SHADOWS)[0]
        r.settings.set(setting, True)
        configs.append(r.current_config())
    jc, pc = configs
    differ = {f.name for f in dataclasses.fields(jc)
              if f.name != "use_pallas_raster"
              and getattr(pc, f.name) != getattr(jc, f.name)}
    assert not differ
    field = {"enableStreaming": "enable_streaming",
             "enableTextureStreaming": "enable_texture_streaming",
             "enableVoxelRT": "enable_voxel_rt",
             "enableVoxelFallback": "enable_voxel_fallback",
             "enableRTReflections": "enable_rt_reflect",
             "enableSkinning": "enable_skinning"}[setting]
    assert getattr(pc, field) is True
    r.update()
    if setting == "enableStreaming":
        assert r._streamer is not None
    if setting in ("enableVoxelRT", "enableVoxelFallback"):
        assert r._buffers.voxel_grid.numel() > 1


def test_profile_fn_stage_rows():
    """utils/profiling.profile_fn on a CPU frame: one row per stage the
    frame enters, in frame order (the card adds kernel rows)."""
    from basicrenderer_tpu_torch.graph.frame import build_frame_fn
    from basicrenderer_tpu_torch.graph.framedata import (FrameConfig,
                                                         FrameParams,
                                                         make_view)
    from basicrenderer_tpu_torch.utils.profiling import (print_profile,
                                                         profile_fn)
    sc, bridge = build_scene(PORT_PKG, "basic")
    fn = build_frame_fn(FrameConfig(width=64, height=64, tile_h=16,
                                    max_pairs=1 << 12))
    rows = profile_fn(fn, bridge.build_scene_buffers(device="cpu"),
                      make_view(*sc.camera_matrices(aspect=1.0),
                                device="cpu"),
                      FrameParams.default("cpu"), iters=2)
    names = [n for n, _ in rows]
    assert names[:4] == ["stage setup", "stage bin", "stage raster",
                         "stage gbuffer"]
    assert all(ms >= 0.0 for _, ms in rows)
    print_profile(rows)
