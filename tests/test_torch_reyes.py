"""Reyes micro-tessellation (ops/reyes.py): the port against the JAX
package on the CPU, and tests/test_reyes.py's five contracts on the port.

Rig: tests/test_reyes.py's displaced plane (a 4x4 plane of 8 triangles
whose material displaces by a half-raised height texture), built by each
package from its own host modules.

Tolerances:
- dice_reyes at 240x200 (neither side a power of two): parent_keep and
  the overflow equal; the main setup rows (the parents kept and their
  masking) bit for bit equal; the micro rows' validity, bboxes and every
  id / material / bbox / pad lane equal, and their planes within
  tests/test_torch_raster_setup.py's plane tolerance. The micro corners
  go through an f32 inverse of the view-projection (LAPACK here, XLA's LU
  there) and a root, which round apart in the last bits.
- the 128x128 enable_reyes frame: vis agreement >= 0.999 (measured 1.0)
  and image RMSE <= 1.0 on the 0-255 scale against the JAX frame.
"""

import dataclasses
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_bridge import JAX_PKG, PORT_PKG
from tests.test_torch_raster_setup import assert_lanes_close

CFG = dict(width=256, height=256, tile_h=16, tile_w=128, max_pairs=1 << 14,
           enable_clod=True, max_visible_clusters=256)
REYES = dict(enable_reyes=True, reyes_tris=256, reyes_dice=4, reyes_px=16.0)
SPLIT = dict(REYES, reyes_split_tris=64, reyes_split_factor=1.0)


def rig(root, displacement):
    """(scene, bridge) of tests/test_reyes.py::_rig from `root`'s modules."""
    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    procedural, materials = mod("models.procedural"), mod("models.materials")
    meshes = mod("models.mesh").MeshRegistry()
    mats = materials.MaterialRegistry()
    tex = mod("models.textures").TextureRegistry(resolution=64)
    r = tex.resolution
    _yy, xx = np.mgrid[0:r, 0:r]
    h = (xx > r // 2).astype(np.float32)
    height = tex.add(np.dstack([h, h * 0, h * 0]), srgb=False)
    plane = meshes.add(procedural.make_plane(4.0, 2))
    m = mats.add(materials.Material(
        base_color=np.array([0.8, 0.8, 0.8, 1], np.float32), roughness=0.6,
        displacement_scale=displacement, displacement_texture=height))
    sc = mod("scene.scene").Scene()
    sc.create_renderable(plane, m)
    sc.create_directional_light(direction=(-0.4, -1, -0.3), intensity=3.0)
    sc.set_camera(position=(0, 2.2, 3.2), target=(0, 0, 0), aspect=1.0)
    sc.propagate_transforms()
    br = mod("scene.bridge")
    caps = br.BridgeCapacities(max_vertices=1 << 12, max_triangles=1 << 12,
                               max_objects=4, max_materials=4, max_lights=4,
                               max_clusters=1 << 8, max_geom_clusters=1 << 8)
    return sc, br.SceneRenderBridge(sc, meshes, mats, caps, textures=tex)


def port_frames(displacement, configs):
    """The port's frames of the rig, one per config, from one bridge."""
    from basicrenderer_tpu_torch.graph.frame import build_frame_fn
    from basicrenderer_tpu_torch.graph.framedata import (FrameConfig,
                                                         FrameParams,
                                                         make_view)
    sc, bridge = rig(PORT_PKG, displacement)
    buf = bridge.build_scene_buffers(device="cpu")
    view = make_view(*sc.camera_matrices(aspect=1.0), device="cpu")
    return [build_frame_fn(FrameConfig(**c))(buf, view,
                                             FrameParams.default("cpu"))
            for c in configs]


def _holes(flat, diced):
    """Crack pixels: covered flat, uncovered diced, and enclosed by the
    diced surface 2 pixels away on every side."""
    cov_f = flat["depth_padded"].numpy() > 0
    cov_r = diced["depth_padded"].numpy() > 0
    enclosed = (np.roll(cov_r, 2, 0) & np.roll(cov_r, -2, 0)
                & np.roll(cov_r, 2, 1) & np.roll(cov_r, -2, 1))
    return int((cov_f & ~cov_r & enclosed).sum())


def test_bary_grid_tiles_parent():
    """tests/test_reyes.py::test_bary_grid_tiles_parent on the port's grid,
    which also equals the JAX package's."""
    from basicrenderer_tpu.ops.reyes import _bary_grid as j_grid
    from basicrenderer_tpu_torch.ops.reyes import _bary_grid
    for D in (2, 3, 4):
        g = _bary_grid(D)
        np.testing.assert_array_equal(g, j_grid(D))
        assert g.shape == (D * D, 3, 3)
        assert np.allclose(g.sum(-1), 1.0, atol=1e-6)
        assert (g >= -1e-6).all()
        p = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]], np.float32)
        v = g @ p
        e1 = v[:, 1] - v[:, 0]
        e2 = v[:, 2] - v[:, 0]
        a2 = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
        assert (a2 > 0).all()
        assert np.isclose(a2.sum(), 1.0, atol=1e-5)


@pytest.mark.parametrize("flags", [REYES, SPLIT], ids=["dice", "split"])
def test_reyes_displaces_without_holes(flags):
    """tests/test_reyes.py's displace and split-stage contracts: the diced
    (and, with split_factor 1.0, every eligible parent split) surface
    visibly changes the frame and opens no crack."""
    flat, diced = port_frames(0.5, [CFG, dict(CFG, **flags)])
    img_f = flat["image"].numpy().astype(np.int32)
    img_r = diced["image"].numpy().astype(np.int32)
    assert np.abs(img_f - img_r).mean() > 0.5
    assert _holes(flat, diced) == 0


def test_reyes_without_displacement_is_identity():
    """tests/test_reyes.py's two identity contracts (dice, and split then
    dice): an undisplaced surface renders bit for bit as the flat one."""
    flat, diced, split = port_frames(0.0, [CFG, dict(CFG, **REYES),
                                           dict(CFG, **SPLIT)])
    np.testing.assert_array_equal(flat["image"].numpy(),
                                  diced["image"].numpy())
    np.testing.assert_array_equal(flat["image"].numpy(),
                                  split["image"].numpy())


def _setups(flags):
    """The clustered setup of the rig at 240x200 with `flags` in both
    packages from the same compacted slots, with dice_reyes's parent_keep
    and overflow captured: (port, jax) tuples of (lanes, bbox, valid,
    overflow, parent_keep, reyes_overflow) as numpy."""
    from basicrenderer_tpu.graph.framedata import FrameConfig as JConfig
    from basicrenderer_tpu.graph.framedata import make_view as j_make_view
    from basicrenderer_tpu.ops import clod as jclod
    from basicrenderer_tpu.ops import raster_setup as jrs
    from basicrenderer_tpu.ops import reyes as jreyes
    from basicrenderer_tpu_torch.graph import frame as pframe
    from basicrenderer_tpu_torch.graph.framedata import FrameConfig as PConfig
    from basicrenderer_tpu_torch.graph.framedata import FrameParams
    from basicrenderer_tpu_torch.graph.framedata import make_view as p_make_view
    from basicrenderer_tpu_torch.ops import raster_setup as prs
    from basicrenderer_tpu_torch.ops import reyes as preyes
    kw = dict(CFG, width=240, height=200, **flags)
    jc, pc = JConfig(**kw), PConfig(**kw)
    psc, pb = rig(PORT_PKG, 0.5)
    _jsc, jb = rig(JAX_PKG, 0.5)
    cams = psc.camera_matrices(aspect=1.2)
    pview, jview = p_make_view(*cams, device="cpu"), j_make_view(*cams)
    pbuf, jbuf = pb.build_scene_buffers(device="cpu"), jb.build_scene_buffers()
    comp = pframe.clod_compact(pbuf, pview, pc, FrameParams.default("cpu"))
    jcomp = jclod.CompactedTris(**{f: jnp.asarray(getattr(comp, f).numpy())
                                   for f in comp._fields})

    def captured(module, run):
        got, orig = [], module.dice_reyes

        def wrap(*a, **k):
            got.append(orig(*a, **k))
            return got[-1]
        module.dice_reyes = wrap
        try:
            return tuple(run()) + tuple(got[0][3:])
        finally:
            module.dice_reyes = orig

    jout = jax.jit(lambda s, c, vp: captured(
        jreyes, lambda: jrs.setup_from_compacted(s, c, vp, jc)))(
            jbuf, jcomp, jview.viewproj)
    pout = captured(preyes, lambda: prs.setup_from_compacted(
        pbuf, comp, pview.viewproj, pc))
    return ([np.asarray(x.numpy()) for x in pout],
            [np.asarray(x) for x in jout], comp.valid.shape[0])


@pytest.mark.parametrize("flags", [REYES, SPLIT], ids=["dice", "split"])
def test_dice_reyes_matches_jax(flags):
    (pl, pbb, pv, povf, pkeep, prov), (jl, jbb, jv, jovf, jkeep, jrov), Kt = \
        _setups(flags)
    np.testing.assert_array_equal(pkeep, jkeep)
    assert int(prov) == int(jrov) and int(povf) == int(jovf)
    assert (~pkeep).sum() >= 4          # parents were diced
    assert pl.shape == jl.shape and pl.shape[0] > Kt
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pbb[pv], jbb[jv])
    # The main rows: bit for bit on the live ones (dead rows' planes are
    # never read).
    live = pv[:Kt]
    np.testing.assert_array_equal(pl[:Kt][live], jl[:Kt][live])
    # The micro rows.
    micro = pv[Kt:]
    assert micro.sum() >= 16 * 4
    assert_lanes_close(pl[Kt:][micro], jl[Kt:][micro], 240, 200)


@pytest.fixture(scope="module")
def reyes_frames():
    """The 128x128 enable_reyes frame of the rig in both packages."""
    from basicrenderer_tpu.graph.frame import build_frame_fn as j_build
    from basicrenderer_tpu.graph.framedata import FrameConfig as JConfig
    from basicrenderer_tpu.graph.framedata import FrameParams as JParams
    from basicrenderer_tpu.graph.framedata import make_view as j_make_view
    kw = dict(CFG, width=128, height=128, **REYES)
    jsc, jb = rig(JAX_PKG, 0.5)
    jout = jax.jit(j_build(JConfig(**kw, use_pallas_raster=False)))(
        jb.build_scene_buffers(), j_make_view(*jsc.camera_matrices(aspect=1.0)),
        JParams.default())
    pout = port_frames(0.5, [kw])[0]
    return ({k: np.asarray(v) for k, v in jout.items()},
            {k: v.numpy() for k, v in pout.items()})


def test_reyes_frame_matches_jax(reyes_frames):
    jout, pout = reyes_frames
    agree = (pout["vis"] == jout["vis"]).mean()
    assert agree >= 0.999, f"vis agreement {agree:.5f}"
    assert (pout["vis"] > 256 * 128).any()     # micro rows visible
    rmse = float(np.sqrt(np.mean((pout["image"].astype(np.float32)
                                  - jout["image"].astype(np.float32)) ** 2)))
    assert rmse <= 1.0, rmse
    for k in ("bin_overflow", "num_pairs", "cluster_overflow"):
        assert int(pout[k]) == int(jout[k]), k
