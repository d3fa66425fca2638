"""Order-independent transparency (ops/oit.py) and the masked peels: port
vs the JAX frame program on the CPU.

Scenes (tests/test_oit.py's and tests/test_alpha_mask.py's, built by
each package from its own host modules, 128x128, tile_h=16): a white
floor behind
- "two": a red and a blue glass quad (build_oit_scene);
- "glass8": eight parallel green glass quads, alpha 0.4 (_glass_stack(8));
- "tinted8": eight red OpenPBR transmission quads (_tinted_stack(8): the
  per-channel tail);
- "emission": a grey pane, then a red and a blue pane (the depth-weighted
  tail emission of test_oit_tail_emission_is_depth_weighted).
Each goes through two OIT configurations: bench.py's full_oit one
(two layers, K2 through the default group binning, transmission on)
and tests/test_oit.py's (four layers, here through K1 with
group_binning=False, transmission off). The JAX frame runs its
reference path (use_pallas_raster=False), jitted once per
configuration; the configurations run in threads, so that their XLA
compiles overlap.

Parity on each frame: every peeled layer's vis equal (the port's layers
as its raster returns them, the JAX frame's through a debug callback on
its layer raster), the opaque vis equal, `oit_overflow` equal, image RMSE
vs the JAX frame <= 1.0 (0-255).

Then `mask_peels=2` on tests/test_alpha_mask.py's stacked masked leaves
(vis equal, RMSE <= 1.0), and tests/test_goldens_512.py's `g512_oit`
frame rendered by the port against its golden PNG (RMSE <= 6, the
golden limit).
"""

import contextlib
import importlib
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import pytest

from basicrenderer_tpu.graph.frame import build_frame_fn as j_build_frame_fn
from basicrenderer_tpu.graph.framedata import FrameConfig as JConfig
from basicrenderer_tpu.graph.framedata import FrameParams as JParams
from basicrenderer_tpu.graph.framedata import make_view as j_make_view
from basicrenderer_tpu.ops import oit as joit
from basicrenderer_tpu_torch.graph.frame import build_frame_fn
from basicrenderer_tpu_torch.graph.framedata import (FrameConfig, FrameParams,
                                                     make_view)
from basicrenderer_tpu_torch.ops import oit as poit
from basicrenderer_tpu_torch.utils.png import read_png

from tests.test_torch_cluster_frame import JAX_PKG, PORT_PKG, build_rig

QX90 = np.array([np.sin(np.pi / 4), 0, 0, np.cos(np.pi / 4)], np.float32)
BASE = dict(width=128, height=128, tile_h=16, tile_w=128, max_pairs=1 << 11,
            enable_clod=True, max_visible_clusters=64, enable_oit=True,
            oit_clusters=64)
CONFIGS = {
    # bench.py's full_oit: K2 (group binning), two layers, transmission.
    "k2_groups_transmission": dict(oit_layers=2, enable_transmission=True),
    # tests/test_oit.py's: four layers, here through K1, no transmission.
    "k4_soup": dict(oit_layers=4, group_binning=False),
}
SCENES = ("two", "glass8", "tinted8", "emission")


def _mod(root, name):
    return importlib.import_module(f"{root}.{name}")


def oit_scene(root, name):
    """(scene, bridge) of one OIT scene from `root`'s modules. All share
    one set of capacities, so each JAX configuration compiles once."""
    Material = _mod(root, "models.materials").Material
    meshes = _mod(root, "models.mesh").MeshRegistry()
    mats = _mod(root, "models.materials").MaterialRegistry()
    plane = meshes.add(_mod(root, "models.procedural").make_plane(8.0, 1))

    def mat(rgba, **kw):
        return mats.add(Material(base_color=np.array(rgba, np.float32), **kw))
    sc = _mod(root, "scene.scene").Scene()
    sc.create_renderable(plane, mat([1, 1, 1, 1], roughness=1.0),
                         position=(0, 0, -2), rotation=QX90)

    def pane(m, z, s):
        sc.create_renderable(plane, m, position=(0, 0, z), rotation=QX90,
                             scale=(s, 1, s))
    if name == "two":
        pane(mat([1, 0, 0, 0.5], alpha_blend=True, roughness=0.5), 0, 0.4)
        pane(mat([0, 0, 1, 0.5], alpha_blend=True, roughness=0.5), 1, 0.25)
    elif name == "glass8":
        g = mat([0.2, 0.9, 0.3, 0.4], alpha_blend=True, roughness=0.5)
        for k in range(8):
            pane(g, -1 + 0.2 * k, 0.4)
    elif name == "tinted8":
        g = mat([1, 1, 1, 1], roughness=0.1, transmission_weight=1.0,
                transmission_color=np.array([0.9, 0.25, 0.25], np.float32))
        for k in range(8):
            pane(g, -1 + 0.2 * k, 0.4)
    else:
        pane(mat([0.5, 0.5, 0.5, 0.5], alpha_blend=True, roughness=0.5),
             1, 0.4)
        pane(mat([1, 0.05, 0.05, 0.6], alpha_blend=True, roughness=0.5),
             0.2, 0.4)
        pane(mat([0.05, 0.05, 1, 0.6], alpha_blend=True, roughness=0.5),
             -0.2, 0.4)
    sc.create_directional_light(direction=(0, -0.3, -1), intensity=3.0)
    sc.set_camera(position=(0, 0, 5), target=(0, 0, 0), aspect=1.0)
    sc.propagate_transforms()
    br = _mod(root, "scene.bridge")
    caps = br.BridgeCapacities(max_vertices=1 << 9, max_triangles=1 << 9,
                               max_objects=16, max_materials=8, max_lights=4,
                               max_clusters=64)
    return sc, br.SceneRenderBridge(sc, meshes, mats, caps)


_local = threading.local()


@contextlib.contextmanager
def layer_recorders():
    """While installed, the JAX OIT's layer raster and the port's append
    each layer's vis to the calling thread's `_local.layers` = (JAX list,
    port list): the JAX frame's through an ordered debug callback compiled
    into the frames traced meanwhile (the list is the one of the thread
    that traces; a layer its lax.cond skips records nothing), the port's
    as its raster returns."""
    j_orig, p_orig = joit.raster_tiles_ref, poit.raster_tiles

    def j_rec(pairs, cfg, *a, accum=False, **kw):
        out = j_orig(pairs, cfg, *a, accum=accum, **kw)
        if not accum:
            jl = _local.layers[0]
            jax.debug.callback(lambda v: jl.append(np.asarray(v)), out[1],
                               ordered=True)
        return out

    def p_rec(pairs, cfg, *a, accum=False, **kw):
        out = p_orig(pairs, cfg, *a, accum=accum, **kw)
        if not accum:
            _local.layers[1].append(out[1].numpy())
        return out
    joit.raster_tiles_ref, poit.raster_tiles = j_rec, p_rec
    try:
        yield
    finally:
        joit.raster_tiles_ref, poit.raster_tiles = j_orig, p_orig


def _views(jsc, psc):
    return (j_make_view(*jsc.camera_matrices(aspect=1.0)),
            make_view(*psc.camera_matrices(aspect=1.0), device="cpu"))


@pytest.fixture(scope="module")
def oit_frames():
    """{(config, scene): (JAX outputs, port outputs, JAX layer vis list,
    port layer vis list)}, as numpy; one thread per configuration."""
    scenes = {s: (oit_scene(JAX_PKG, s), oit_scene(PORT_PKG, s))
              for s in SCENES}

    def run(cname):
        flags = dict(BASE, **CONFIGS[cname])
        jf = jax.jit(j_build_frame_fn(JConfig(**flags,
                                              use_pallas_raster=False)))
        pf = build_frame_fn(FrameConfig(**flags))
        jl, pl = _local.layers = ([], [])
        out = {}
        for s in SCENES:
            (jsc, jb), (psc, pb) = scenes[s]
            jvd, pvd = _views(jsc, psc)
            jl.clear()
            pl.clear()
            jo = {k: np.asarray(v) for k, v in
                  jf(jb.build_scene_buffers(), jvd, JParams.default()).items()}
            jax.effects_barrier()
            po = {k: v.numpy() for k, v in
                  pf(pb.build_scene_buffers(device="cpu"), pvd,
                     FrameParams.default("cpu")).items()}
            out[(cname, s)] = (jo, po, list(jl), list(pl))
        return out

    frames = {}
    with layer_recorders(), ThreadPoolExecutor(len(CONFIGS)) as pool:
        for res in pool.map(run, CONFIGS):
            frames.update(res)
    return frames


def _rmse(a, b):
    return float(np.sqrt(np.mean((a.astype(np.float32)
                                  - b.astype(np.float32)) ** 2)))


CASES = [(c, s) for c in CONFIGS for s in SCENES]


@pytest.mark.parametrize("config,scene", CASES)
def test_oit_layers_match_jax(oit_frames, config, scene):
    _jo, _po, jl, pl = oit_frames[(config, scene)]
    assert len(pl) == len(jl) >= 1
    for k, (jv, pv) in enumerate(zip(jl, pl)):
        np.testing.assert_array_equal(pv, jv, err_msg=f"layer {k}")
    assert (pl[0] > 0).any()


@pytest.mark.parametrize("config,scene", CASES)
def test_oit_frame_matches_jax(oit_frames, config, scene):
    jo, po, _jl, _pl = oit_frames[(config, scene)]
    assert set(po) == set(jo)
    np.testing.assert_array_equal(po["vis"], jo["vis"])
    assert int(po["oit_overflow"]) == int(jo["oit_overflow"])
    err = _rmse(po["image"], jo["image"])
    assert err <= 1.0, f"image RMSE {err:.4f}"
    assert np.isfinite(po["hdr"]).all()


def test_oit_reaches_the_tail_and_skips_empty_layers(oit_frames):
    """The deep stacks overflow K (the accum tail runs). At K=4 the
    two-pane scene's third layer is rastered and found empty, so the
    fourth is skipped and there is no tail."""
    for c in CONFIGS:
        assert int(oit_frames[(c, "glass8")][1]["oit_overflow"]) > 100
    assert len(oit_frames[("k2_groups_transmission", "two")][3]) == 2
    assert len(oit_frames[("k4_soup", "two")][3]) == 3
    assert int(oit_frames[("k4_soup", "two")][1]["oit_overflow"]) == 0


def stacked_mask_scene(root):
    """tests/test_alpha_mask.py's _stacked_scene from `root`'s modules:
    a blue backdrop, a masked red leaf (hole on the left half) and a
    masked green leaf above it (hole on the right half)."""
    Material = _mod(root, "models.materials").Material
    meshes = _mod(root, "models.mesh").MeshRegistry()
    mats = _mod(root, "models.materials").MaterialRegistry()
    tex = _mod(root, "models.textures").TextureRegistry(resolution=64)
    img_g = np.ones((64, 64, 4), np.float32)
    img_g[:, 32:, 3] = 0.0
    img_r = np.ones((64, 64, 4), np.float32)
    img_r[:, :32, 3] = 0.0
    gtex = tex.add(img_g, srgb=False)
    rtex = tex.add(img_r, srgb=False)
    green = mats.add(Material(
        base_color=np.array([0.1, 0.8, 0.1, 1], np.float32), roughness=0.8,
        alpha_cutoff=0.5, base_color_texture=gtex))
    red = mats.add(Material(
        base_color=np.array([0.9, 0.1, 0.1, 1], np.float32), roughness=0.8,
        alpha_cutoff=0.5, base_color_texture=rtex))
    blue = mats.add(Material(base_color=np.array([0.1, 0.1, 0.9, 1],
                                                 np.float32), roughness=0.8))
    quad = meshes.add(_mod(root, "models.procedural").make_plane(4.0, 1))
    sc = _mod(root, "scene.scene").Scene()
    sc.create_renderable(quad, blue, position=(0, 0, 0))
    sc.create_renderable(quad, red, position=(0, 1.0, 0))
    sc.create_renderable(quad, green, position=(0, 1.5, 0))
    sc.create_directional_light(direction=(0, -1, 0), intensity=3.0)
    sc.set_camera(position=(0, 6, 0.05), target=(0, 0, 0), aspect=1.0)
    sc.propagate_transforms()
    br = _mod(root, "scene.bridge")
    caps = br.BridgeCapacities(max_vertices=64, max_triangles=64,
                               max_objects=4, max_materials=4, max_lights=2,
                               max_clusters=8, max_geom_clusters=8)
    return sc, br.SceneRenderBridge(sc, meshes, mats, caps, textures=tex)


def test_second_mask_peel_matches_jax():
    """mask_peels=2 (tests/test_alpha_mask.py's CFG): the red leaf shows
    through the green leaf's hole, as in the JAX frame."""
    flags = dict(width=128, height=128, tile_h=16, tile_w=128,
                 max_pairs=1 << 10, enable_clod=True, max_visible_clusters=8,
                 enable_textures=True, texture_downscale=1,
                 enable_alpha_mask=True, mask_clusters=8, mask_peels=2)
    (jsc, jb), (psc, pb) = (stacked_mask_scene(JAX_PKG),
                            stacked_mask_scene(PORT_PKG))
    jvd, pvd = _views(jsc, psc)
    jo = jax.jit(j_build_frame_fn(JConfig(**flags, use_pallas_raster=False)))(
        jb.build_scene_buffers(), jvd, JParams.default())
    po = build_frame_fn(FrameConfig(**flags))(
        pb.build_scene_buffers(device="cpu"), pvd, FrameParams.default("cpu"))
    np.testing.assert_array_equal(po["vis"].numpy(), np.asarray(jo["vis"]))
    img = po["image"].numpy()
    assert _rmse(img, np.asarray(jo["image"])) <= 1.0
    right = img[40:88, 68:118].reshape(-1, 3).astype(np.float32).mean(0)
    assert right[0] > right[2] + 20, right          # red, not the backdrop


def test_g512_oit_golden():
    """tests/test_goldens_512.py's g512_oit frame (the 512x512 rig with
    enable_oit at its defaults) rendered by the port on the CPU, against
    the golden PNG at the golden limit."""
    sc, bridge = build_rig(PORT_PKG)
    cfg = FrameConfig(width=512, height=512, tile_h=16, tile_w=128,
                      max_pairs=1 << 15, enable_clod=True,
                      max_visible_clusters=1024, enable_oit=True)
    out = build_frame_fn(cfg)(bridge.build_scene_buffers(device="cpu"),
                              make_view(*sc.camera_matrices(aspect=1.0),
                                        device="cpu"),
                              FrameParams.default("cpu"))
    golden = read_png(os.path.join(os.path.dirname(__file__), "goldens",
                                   "g512_oit.png"))
    err = _rmse(out["image"].numpy(), golden)
    assert err <= 6.0, f"g512_oit RMSE {err:.4f}"
