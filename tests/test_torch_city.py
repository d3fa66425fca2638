"""bench.py's city (models/city.py): port vs the JAX package on the CPU.

Both packages load assets/city.glb through their own load_city, as
bench.py does (lod=True, 256^2 textures, 988 + 12 point lights), and
build scene buffers with bench.py's capacities. Checked:
- load_city parity: every mesh (the cluster-LOD DAGs included), material,
  texture layer (with its alpha cutoff) and the triangle count
  (5,097,780, the count bench.py prints for the same file) equal, and the
  scene buffers equal field by field;
- one 128x128 frame (tile_h=16, tests/test_frame_e2e.py's size) with
  bench.py's config1_minimal toggles (cluster LOD, two-phase occlusion,
  clustered lights, the alpha-MASK pass over the `leaf` material, whose
  MASK layer has coverage-preserving mips), held to the thresholds of
  tests/test_torch_cluster_frame.py: vis equal on >= 99.9% of pixels,
  image RMSE <= 1.0 (0-255), equal counters. The JAX frame runs its
  reference path (use_pallas_raster=False).
"""

import dataclasses

import numpy as np
import jax
import pytest

from basicrenderer_tpu.graph.frame import build_frame_fn as j_build_frame_fn
from basicrenderer_tpu.graph.framedata import FrameConfig as JConfig
from basicrenderer_tpu.graph.framedata import FrameParams as JParams
from basicrenderer_tpu.graph.framedata import make_view as j_make_view
from basicrenderer_tpu_torch.graph import frame as pframe
from basicrenderer_tpu_torch.graph.frame import build_frame_fn
from basicrenderer_tpu_torch.graph.framedata import FrameConfig, FrameParams, make_view

from tests.test_torch_cluster_frame import COUNTERS, wait_for_jax_native
from tests.test_torch_importers import JAX_PKG, PORT_PKG, _equal, _mod

# bench.py:205-211 and :217-224 (config1_minimal) at the test size.
CAPS = dict(max_vertices=1 << 22, max_triangles=1 << 22, max_objects=512,
            max_materials=64, max_lights=1024 + 8, max_clusters=1 << 16,
            max_geom_clusters=1 << 15, max_groups=1 << 13)
CONFIG1 = dict(width=128, height=128, tile_h=16, tile_w=128,
               max_pairs=1 << 18, max_tiles_per_tri=8, enable_clod=True,
               max_visible_clusters=3072, max_phase2_clusters=256,
               shadow_clusters=768, enable_clustered=True,
               enable_alpha_mask=True, enable_occlusion=True)
CITY_TRIANGLES = 5_097_780


def _city(root):
    """(built scene, texture registry, scene buffers) from `root`'s own
    modules, as bench.py builds them."""
    if root == JAX_PKG:
        wait_for_jax_native()
    tex = _mod(root, "models.textures").TextureRegistry(256)
    built = _mod(root, "models.city").load_city(lod=True, textures=tex,
                                                num_point_lights=1000 - 12)
    br = _mod(root, "scene.bridge")
    bridge = br.SceneRenderBridge(built.scene, built.meshes, built.materials,
                                  br.BridgeCapacities(**CAPS), textures=tex)
    kw = {} if root == JAX_PKG else {"device": "cpu"}
    return built, tex, bridge.build_scene_buffers(**kw)


@pytest.fixture(scope="module")
def cities():
    return _city(JAX_PKG), _city(PORT_PKG)


def test_load_city_matches_jax(cities):
    (jb, jtex, _), (pb, ptex, _) = cities
    assert pb.num_triangles == jb.num_triangles == CITY_TRIANGLES
    _equal(jb.meshes.meshes, pb.meshes.meshes, "meshes")
    _equal(jb.materials.materials, pb.materials.materials, "materials")
    _equal(jtex.images, ptex.images, "texture images")
    assert ptex.alpha_cutoffs == jtex.alpha_cutoffs
    assert sum(c == 0.5 for c in ptex.alpha_cutoffs) == 1
    assert sum(m.clusters is not None for m in pb.meshes.meshes) == 15


def test_city_scene_buffers_match_jax(cities):
    (_, _, jbuf), (_, _, pbuf) = cities
    for f in dataclasses.fields(pbuf):   # the JAX buffers have more fields
        j, p = getattr(jbuf, f.name), getattr(pbuf, f.name)
        if j is None:
            assert p is None, f.name
            continue
        p, j = p.numpy(), np.asarray(j)
        if p.dtype != j.dtype:       # u32 words the port holds as i32 bits
            j = j.view(p.dtype)
        np.testing.assert_array_equal(p, j, err_msg=f.name)


@pytest.fixture(scope="module")
def city_frames(cities):
    """The city's config1_minimal frame in both packages, as numpy, and
    the port's mask pass: (pixels the masked raster covered in front of
    the opaque depth, pixels whose alpha kept them)."""
    (jb, _, jbuf), (pb, _, pbuf) = cities
    jout = jax.jit(j_build_frame_fn(JConfig(**CONFIG1,
                                            use_pallas_raster=False)))(
        jbuf, j_make_view(*jb.scene.camera_matrices(aspect=1.0)),
        JParams.default())
    masked = []
    keep_fn = pframe._mask_alpha_keep

    def spy(*args, **kw):
        keep = keep_fn(*args, **kw)
        dm, vm, depth_ref_p = args[3], args[4], args[6]
        masked.append((int(((vm > 0) & (dm > depth_ref_p)).sum()),
                       int(keep.sum())))
        return keep

    pframe._mask_alpha_keep = spy
    try:
        pout = build_frame_fn(FrameConfig(**CONFIG1))(
            pbuf, make_view(*pb.scene.camera_matrices(aspect=1.0),
                            device="cpu"), FrameParams.default("cpu"))
    finally:
        pframe._mask_alpha_keep = keep_fn
    return ({k: np.asarray(v) for k, v in jout.items()},
            {k: v.numpy() for k, v in pout.items()}, masked)


def test_city_frame_vis_matches_jax(city_frames):
    jout, pout, _ = city_frames
    agree = (pout["vis"] == jout["vis"]).mean()
    assert agree >= 0.999, f"vis agreement {agree:.5f}"
    assert 0.1 < (pout["vis"] > 0).mean() < 0.95


def test_city_frame_image_matches_jax(city_frames):
    jout, pout, _ = city_frames
    assert pout["image"].shape == jout["image"].shape == (128, 128, 3)
    err = np.sqrt(np.mean((pout["image"].astype(np.float32)
                           - jout["image"].astype(np.float32)) ** 2))
    assert err <= 1.0, f"image RMSE {err:.4f}"
    assert pout["image"].std() > 10


def test_city_frame_counters_match_jax(city_frames):
    jout, pout, _ = city_frames
    assert set(pout) == set(jout)
    for k in COUNTERS:
        assert int(pout[k]) == int(jout[k]), k
    assert int(pout["cluster_overflow"]) == 0


def test_city_mask_pass_cuts_leaf_texels(city_frames):
    """The `leaf` MASK clusters are in view: the mask pass covers leaf
    pixels, keeps those whose texture alpha reaches the cutoff and cuts
    the rest away."""
    masked = city_frames[2]
    assert len(masked) == 1
    covered, kept = masked[0]
    assert 0 < kept < covered, masked
