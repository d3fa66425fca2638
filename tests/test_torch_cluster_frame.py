"""The cluster-LOD frame: port vs the JAX frame program on the CPU.

Scene: the shared rig of tests/test_goldens_512.py (LOD sphere, cube,
checkered floor, glass quad, alpha-MASK leaf quad; directional, point and
spot lights) without the voxel pyramid, built by each package from its own
host modules, at 128x128 with tile_h=16. Five toggle sets over
enable_clod: alone; with two-phase occlusion over 3 frames (the first has
no previous depth), group-binned (K2 seeded), and per-triangle binned
over 2 frames (group_binning off: K1 seeded); with clustered lights; with
the alpha-MASK pass at texture_downscale 2. The JAX frame runs its
reference path (use_pallas_raster=False).

Parity levels:
- `vis` equal on >= 99.9% of pixels (the setups round differently in the
  last ulp, and mask cutoffs may flip where alpha is at the cutoff);
- image RMSE vs the JAX frame <= 1.0 on the 0-255 scale;
- equal overflow counters and pair counts, and the same output keys.
"""

import importlib

import numpy as np
import jax
import pytest

from basicrenderer_tpu.graph.frame import build_frame_fn as j_build_frame_fn
from basicrenderer_tpu.graph.framedata import FrameConfig as JConfig
from basicrenderer_tpu.graph.framedata import FrameParams as JParams
from basicrenderer_tpu.graph.framedata import make_view as j_make_view
from basicrenderer_tpu.utils import math3d as jmath3d
from basicrenderer_tpu_torch.graph.frame import build_frame_fn
from basicrenderer_tpu_torch.graph.framedata import FrameConfig, FrameParams, make_view

JAX_PKG = "basicrenderer_tpu"
PORT_PKG = "basicrenderer_tpu_torch"
QX90 = np.asarray(jmath3d.quat_from_axis_angle((1, 0, 0), np.pi / 2))
BASE = dict(width=128, height=128, tile_h=16, tile_w=128, max_pairs=1 << 15,
            enable_clod=True, max_visible_clusters=1024)
TOGGLES = {
    "clod": ({}, 1),
    "occlusion": (dict(enable_occlusion=True), 3),
    # Per-triangle binning: phase 2 takes K1's seeded mode (the second
    # frame is the first with a previous depth).
    "occlusion_k1": (dict(enable_occlusion=True, group_binning=False), 2),
    "clustered": (dict(enable_clustered=True), 1),
    "alpha_mask": (dict(enable_alpha_mask=True, texture_downscale=2), 1),
}
COUNTERS = ("bin_overflow", "num_pairs", "cluster_overflow", "light_overflow",
            "oit_overflow")


def wait_for_jax_native(timeout_s: float = 120.0):
    """Load the JAX package's native QEM library, waiting for it to be
    whole, and return it.

    The JAX package builds native/libclod.so in place with g++ at first
    use, and a checkout has none (*.so is gitignored). Under pytest-xdist
    several workers build it at once: a worker can open a half-written
    file (ctypes raises OSError "file too short"), or its g++ fails and
    the package falls back to its numpy decimator, whose clusters differ
    from the port's. Reset the package's handle and load again until the
    library loads, within `timeout_s`; then require a real library, so a
    fallback fails here and not as an array mismatch."""
    import ctypes
    import time
    from basicrenderer_tpu.models import clusters as jcl
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            lib = jcl._load_native()
        except OSError:
            lib = None
        if isinstance(lib, ctypes.CDLL) or time.monotonic() > deadline:
            break
        jcl._NATIVE = None
        time.sleep(0.5)
    assert isinstance(lib, ctypes.CDLL), (
        f"the JAX package's native QEM library did not load within "
        f"{timeout_s} s (got {lib!r})")
    return lib


def build_rig(root):
    """(scene, bridge) of the rig, from `root`'s own modules. The LOD
    sphere is built afresh (no DAG cache), with the JAX package's native
    library loaded first."""
    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    if root == JAX_PKG:
        wait_for_jax_native()
    clusters, procedural = mod("models.clusters"), mod("models.procedural")
    materials, br = mod("models.materials"), mod("scene.bridge")
    Material = materials.Material
    meshes, mats = mod("models.mesh").MeshRegistry(), materials.MaterialRegistry()
    tex = mod("models.textures").TextureRegistry(resolution=64)
    checker = tex.checkerboard(a=(1, 1, 1), b=(0.15, 0.15, 0.15), squares=8)
    r = tex.resolution
    yy, xx = np.mgrid[0:r, 0:r]
    hole = (((yy * 4 // r) + (xx * 4 // r)) % 2).astype(np.float32)
    leaf = tex.add(np.dstack([np.full((r, r), 0.2, np.float32),
                              np.full((r, r), 0.7, np.float32),
                              np.full((r, r), 0.2, np.float32), hole]),
                   srgb=False)
    sphere = meshes.add(clusters.to_mesh_data(clusters.build_cluster_lod(
        procedural.make_uv_sphere(0.8, rings=24, sectors=48),
        use_cache=False)))
    plane = meshes.add(procedural.make_plane(8.0, 2))
    cube = meshes.add(procedural.make_cube(0.7))
    quad = meshes.add(procedural.make_plane(1.2, 1))
    floor_m = mats.add(Material(
        base_color=np.array([0.7, 0.7, 0.72, 1], np.float32),
        roughness=0.25, metallic=0.1, base_color_texture=checker))
    gold_m = mats.add(Material(
        base_color=np.array([0.9, 0.6, 0.25, 1], np.float32),
        roughness=0.35, metallic=0.8))
    glass_m = mats.add(Material(
        base_color=np.array([0.4, 0.6, 0.9, 0.45], np.float32),
        roughness=0.1, alpha_blend=True))
    leaf_m = mats.add(Material(
        base_color=np.array([1, 1, 1, 1], np.float32), roughness=0.7,
        alpha_cutoff=0.5, base_color_texture=leaf))
    sc = mod("scene.scene").Scene()
    sc.create_renderable(plane, floor_m)
    sc.create_renderable(sphere, gold_m, position=(0, 0.8, 0))
    sc.create_renderable(cube, 0, position=(-1.4, 0.35, 0.6))
    sc.create_renderable(quad, glass_m, position=(0.9, 0.7, 1.2), rotation=QX90)
    sc.create_renderable(quad, leaf_m, position=(-0.6, 0.7, 1.6), rotation=QX90)
    sc.create_directional_light(direction=(-0.5, -1, -0.35), intensity=2.5)
    sc.create_point_light(position=(1.5, 1.8, -0.5), color=(1.0, 0.4, 0.2),
                          intensity=6.0)
    sc.create_spot_light(position=(-2.0, 2.5, 1.5), direction=(0.6, -1, -0.4),
                         intensity=8.0, outer_cone=0.5)
    sc.set_camera(position=(2.6, 2.0, 3.2), target=(0, 0.6, 0), aspect=1.0)
    sc.propagate_transforms()
    caps = br.BridgeCapacities(max_vertices=1 << 15, max_triangles=1 << 15,
                               max_objects=16, max_materials=8, max_lights=8,
                               max_clusters=1 << 10, max_geom_clusters=1 << 10)
    return sc, br.SceneRenderBridge(sc, meshes, mats, caps, textures=tex)


@pytest.fixture(scope="module")
def rigs():
    jsc, jb = build_rig(JAX_PKG)
    psc, pb = build_rig(PORT_PKG)
    return ((jb.build_scene_buffers(), j_make_view(*jsc.camera_matrices(aspect=1.0)),
             JParams.default()),
            (pb.build_scene_buffers(device="cpu"),
             make_view(*psc.camera_matrices(aspect=1.0), device="cpu"),
             FrameParams.default("cpu")))


@pytest.fixture(scope="module")
def frames(rigs):
    """Per toggle set: (JAX outputs, port outputs) of the last frame, as
    numpy. Rendered on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            flags, steps = TOGGLES[name]
            (jbuf, jvd, jp), (pbuf, pvd, pp) = rigs
            jf = jax.jit(j_build_frame_fn(JConfig(**BASE, **flags,
                                                  use_pallas_raster=False)))
            pf = build_frame_fn(FrameConfig(**BASE, **flags))
            jprev = pprev = None
            for _ in range(steps):
                jo = jf(jbuf, jvd, jp, prev_depth=jprev)
                po = pf(pbuf, pvd, pp, prev_depth=pprev)
                jprev, pprev = jo["depth_padded"], po["depth_padded"]
            cache[name] = ({k: np.asarray(v) for k, v in jo.items()},
                           {k: v.numpy() for k, v in po.items()})
        return cache[name]
    return get


@pytest.mark.parametrize("toggles", list(TOGGLES))
def test_cluster_frame_vis_matches_jax(frames, toggles):
    jout, pout = frames(toggles)
    agree = (pout["vis"] == jout["vis"]).mean()
    assert agree >= 0.999, f"vis agreement {agree:.5f}"
    assert 0.3 < (pout["vis"] > 0).mean() < 0.95


@pytest.mark.parametrize("toggles", list(TOGGLES))
def test_cluster_frame_image_matches_jax(frames, toggles):
    jout, pout = frames(toggles)
    assert pout["image"].shape == jout["image"].shape == (128, 128, 3)
    assert pout["image"].dtype == np.uint8
    err = np.sqrt(np.mean((pout["image"].astype(np.float32)
                           - jout["image"].astype(np.float32)) ** 2))
    assert err <= 1.0, f"image RMSE {err:.4f}"


@pytest.mark.parametrize("toggles", list(TOGGLES))
def test_cluster_frame_counters_match_jax(frames, toggles):
    jout, pout = frames(toggles)
    assert set(pout) == set(jout)
    for k in COUNTERS:
        assert int(pout[k]) == int(jout[k]), k
    np.testing.assert_array_equal(pout["depth_padded"].shape,
                                  jout["depth_padded"].shape)


def test_mask_pass_changes_the_frame(frames):
    """The leaf quad's MASK clusters leave the opaque pass and come back
    through the masked raster with holes where the alpha checker fails
    the cutoff."""
    _, plain = frames("clod")
    _, masked = frames("alpha_mask")
    assert (plain["vis"] != masked["vis"]).mean() > 0.005
