"""The soup frame's object-granular two-phase HZB occlusion (K1 seeded) in
the port vs the JAX package on the CPU.

- K1's seeded mode on the soup setup of two scenes, objects split over
  the two phases: the plain version equals the Pallas kernel in interpret
  mode (seeded, and seeded with the tangent channel) and the reference
  twin's seeded raster with its channel merge (visibility_pass with
  use_pallas_raster off: channels of the pixels whose vis changed, the
  seed's elsewhere), exactly: depth, vis and all 8 channels. The port
  continues into the seed as the Pallas kernel does; the test shows the
  two forms agree on these scenes.
- A 3-frame sequence over a walled scene (objects behind a wall that the
  orbiting camera uncovers), each package carrying its own previous depth
  (the port through graph/temporal.TemporalState): vis equal on every
  pixel, near-clip rows included, image RMSE
  <= 1.0, counters equal; phase 1 culls occluded objects and phase 2
  rasters objects that a frame uncovers. Occlusion on equals occlusion
  off in vis and image on every frame.
- On the static golden scene, the two-phase frame equals the
  single-phase frame, first with an empty previous depth and then fed
  its own (tests/test_culling.py's check).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from basicrenderer_tpu.graph import frame as jframe
from basicrenderer_tpu.graph.framedata import FrameConfig as JConfig
from basicrenderer_tpu.graph.framedata import FrameParams as JParams
from basicrenderer_tpu.graph.framedata import make_view as j_make_view
from basicrenderer_tpu.ops import raster_setup as jrs
from basicrenderer_tpu.ops.raster_pallas import raster_tiles_pallas
from basicrenderer_tpu_torch import interop
from basicrenderer_tpu_torch.graph.frame import build_frame_fn
from basicrenderer_tpu_torch.graph.framedata import FrameConfig, FrameParams, make_view
from basicrenderer_tpu_torch.graph.temporal import TemporalState
from basicrenderer_tpu_torch.ops import culling as pculling
from basicrenderer_tpu_torch.ops import raster as praster

from tests.test_torch_bridge import JAX_PKG, PORT_PKG, _pkg, build_scene

CFG_KW = dict(width=128, height=128, tile_h=16, tile_w=128, max_pairs=1 << 12,
              use_pallas_raster=False)
OCC_KW = dict(CFG_KW, enable_occlusion=True, hzb_levels=4)


def _np_fields(nt):
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float32)
                                  - np.asarray(b, np.float32)) ** 2)))


# --- K1 seeded on the soup scenes ----------------------------------------

@pytest.mark.parametrize("variant", ["basic", "mixed"])
def test_seeded_soup_raster_matches_pallas_and_ref_merge(variant):
    """Phase 1 rasters the even objects, phase 2 the odd ones seeded from
    phase 1, per-triangle binned from one setup (the frame's branch)."""
    sc, br = build_scene(JAX_PKG, variant)
    buf = br.build_scene_buffers()
    view, proj, pos = sc.camera_matrices(aspect=1.0)
    vd = j_make_view(view, proj, pos)
    jc = JConfig(**CFG_KW)
    _c, _w, _n, lanes, bbox, valid = jax.jit(
        lambda b, v: jframe.geometry_setup(b, v, jc))(buf, vd)
    tobj = np.asarray(buf.tri_object)
    rows = valid.shape[0]
    obj = np.concatenate([tobj, np.full(rows - tobj.shape[0], -1)])
    even = (obj >= 0) & (obj % 2 == 0)
    odd = obj % 2 == 1
    p1 = jrs.bin_pairs(lanes, bbox, valid & jnp.asarray(even), jc)
    p2 = jrs.bin_pairs(lanes, bbox, valid & jnp.asarray(odd), jc)
    init = jframe.visibility_pass(p1, jc)
    merged = jframe.visibility_pass(p2, jc, init=init)
    pallas = raster_tiles_pallas(p2, jc, interpret=True, init=init)
    pc = FrameConfig(**CFG_KW)
    pinit = praster.raster_tiles(
        interop.binned_pairs(_np_fields(p1), device="cpu"), pc)
    for got, want in zip(pinit, init):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pp2 = interop.binned_pairs(_np_fields(p2), device="cpu")
    got = praster.raster_tiles(pp2, pc, init=pinit)
    for want in (pallas, merged):
        for g, w, name in zip(got, want, ("depth", "vis", "channels")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)
    won = (got[1] != pinit[1]).numpy()
    assert won.mean() > 0.02 and (pinit[1].numpy() > 0).mean() > 0.2
    # The tangent channel in seeded mode: a random angle per triangle in
    # lane 27 (every pair row of a triangle carries the same one).
    tc = dataclasses.replace(jc, enable_vertex_tangents=True)
    rng = np.random.default_rng(5)
    pd = np.array(p2.pair_data)
    angle = rng.uniform(-np.pi, 5 * np.pi, rows + 1)
    pd[:, 27] = np.where(pd[:, 9] > 0.5, angle[pd[:, 9].astype(np.int64)], 0)
    p2t = p2._replace(pair_data=jnp.asarray(pd))
    tinit = (init[0], init[1], init[2].at[5].set(
        jnp.asarray(rng.normal(size=init[2].shape[1:]), jnp.float32)))
    want = raster_tiles_pallas(p2t, tc, interpret=True, init=tinit)
    got = praster.raster_tiles(
        interop.binned_pairs(_np_fields(p2t), device="cpu"),
        dataclasses.replace(pc, enable_vertex_tangents=True),
        init=tuple(torch.as_tensor(np.array(x)) for x in tinit))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --- The frame ------------------------------------------------------------

def walled_scene(root):
    """A floor, a wall and six objects behind it (cubes and spheres), a
    directional and a point light, from `root`'s own modules."""
    m = _pkg(root)
    Material = m.materials.Material
    meshes, mats = m.mesh.MeshRegistry(), m.materials.MaterialRegistry()
    plane = meshes.add(m.procedural.make_plane(14.0, 2))
    cube = meshes.add(m.procedural.make_cube(1.0))
    sphere = meshes.add(m.procedural.make_uv_sphere(0.5, 8, 16))
    ids = [mats.add(Material(base_color=np.array([r, g, b, 1], np.float32),
                             roughness=rough))
           for r, g, b, rough in ((0.5, 0.5, 0.5, 0.9), (0.7, 0.6, 0.5, 0.6),
                                  (0.8, 0.1, 0.1, 0.4), (0.1, 0.4, 0.8, 0.3))]
    sc = m.scene.Scene()
    sc.create_renderable(plane, ids[0])
    sc.create_renderable(cube, ids[1], position=(0, 1.0, 0),
                         scale=(3.0, 2.0, 0.3))
    for k in range(6):
        x = -2.5 + k
        sc.create_renderable(cube if k % 2 else sphere, ids[2 + k % 2],
                             position=(x, 0.5, -1.5 - 0.3 * (k % 3)),
                             scale=(0.7, 0.7, 0.7))
    sc.create_directional_light(direction=(-0.4, -1, -0.3), intensity=3.0)
    sc.create_point_light(position=(0, 2.5, 1.5), intensity=6.0, range=8.0)
    sc.propagate_transforms()
    caps = m.bridge.BridgeCapacities(max_vertices=1 << 12,
                                     max_triangles=1 << 12, max_objects=16,
                                     max_materials=8, max_lights=4)
    return sc, m.bridge.SceneRenderBridge(sc, meshes, mats, caps)


def orbit(sc, k):
    """Frame k's camera: in front of the wall, swinging to the side."""
    ang = 0.45 * k
    sc.set_camera(position=(6.0 * np.sin(ang), 1.6, 6.0 * np.cos(ang)),
                  target=(0, 0.6, -0.8), aspect=1.0)


FRAMES = 3


@pytest.fixture(scope="module")
def sequence():
    """Per frame: the JAX frame, the port's frame with occlusion, the
    port's frame without, and the port's phase verdicts (objects in the
    frustum, phase-1 survivors, phase-2 survivors)."""
    jsc, jb = walled_scene(JAX_PKG)
    jbuf = jb.build_scene_buffers()
    jfn = jax.jit(jframe.build_frame_fn(JConfig(**OCC_KW)))
    psc, pb = walled_scene(PORT_PKG)
    pbuf = pb.build_scene_buffers(device="cpu")
    pcfg = FrameConfig(**OCC_KW)
    pfn, pfn_off = build_frame_fn(pcfg), build_frame_fn(FrameConfig(**CFG_KW))
    temporal = TemporalState(pcfg, device="cpu")
    jprev = jnp.zeros((pcfg.padded_height, pcfg.padded_width), jnp.float32)
    out = []
    for k in range(FRAMES):
        orbit(jsc, k)
        orbit(psc, k)
        view, proj, pos = jsc.camera_matrices(aspect=1.0)
        jout = jfn(jbuf, j_make_view(view, proj, pos), JParams.default(),
                   jprev)
        jprev = jout["depth_padded"]
        pview, params, kw = temporal.inputs(psc, pb)
        verdict = phase_verdicts(pbuf, pview, pcfg, kw["prev_depth"])
        pout = pfn(pbuf, pview, params, **kw)
        temporal.carry(pout)
        poff = pfn_off(pbuf, pview, params)
        out.append(({k_: np.asarray(v) for k_, v in jout.items()},
                    {k_: v.numpy() for k_, v in pout.items()},
                    {k_: v.numpy() for k_, v in poff.items()}, verdict))
    return out


def phase_verdicts(buf, view, cfg, prev_depth):
    """(in frustum, phase 1, phase 2) object counts of the frame's two
    phases, recomputed from its inputs with the port's culling ops."""
    c, r = buf.object_bounds[:, :3], buf.object_bounds[:, 3]
    frame = build_frame_fn(dataclasses.replace(cfg, enable_occlusion=False))
    hzb = pculling.build_hzb(prev_depth, cfg.hzb_levels)
    vis1, cand = pculling.two_phase_object_cull(
        view.viewproj, c, r, buf.object_valid, hzb, cfg.width, cfg.height)
    # Phase 1's depth: the frame of the phase-1 objects alone.
    alone = dataclasses.replace(buf, object_valid=vis1)
    d1 = frame(alone, view, FrameParams.default("cpu"))["depth_padded"]
    bb, zn, behind = pculling.project_sphere_bounds(view.viewproj, c, r,
                                                    cfg.width, cfg.height)
    vis2 = cand & pculling.occlusion_test_hzb(
        pculling.build_hzb(d1, cfg.hzb_levels), bb, zn, behind, cfg.width,
        cfg.height)
    return int((vis1 | cand).sum()), int(vis1.sum()), int(vis2.sum())


def test_soup_occlusion_sequence_matches_jax(sequence):
    """vis equal on every pixel, the soup frame's parity level
    (tests/test_torch_frame.py), the near-clip rows of the clipped floor
    quad included: the port's clip lerps as XLA fuses them."""
    for i, (j, p, _off, _v) in enumerate(sequence):
        diff = p["vis"] != j["vis"]
        assert not diff.any(), f"frame {i + 1}: {diff.sum()} pixels"
        err = _rmse(p["image"], j["image"])
        assert err <= 1.0, f"frame {i + 1}: image RMSE {err:.4f}"
        for key in ("bin_overflow", "num_pairs", "cluster_overflow"):
            assert int(p[key]) == int(j[key]), (i, key)
        assert 0.3 < (p["vis"] > 0).mean() < 0.99


def test_soup_occlusion_culls_and_uncovers(sequence):
    """Phase 1 culls objects behind the wall, phase 2 rasters some that a
    frame uncovers, and the image is the one without occlusion."""
    verdicts = [v for *_x, v in sequence]
    assert verdicts[0][0] == verdicts[0][1]      # no previous depth yet
    assert any(inf > p1 for inf, p1, _p2 in verdicts[1:]), verdicts
    assert any(p2 > 0 for _inf, _p1, p2 in verdicts[1:]), verdicts
    for i, (_j, p, off, _v) in enumerate(sequence):
        np.testing.assert_array_equal(p["vis"], off["vis"],
                                      err_msg=f"frame {i + 1}")
        np.testing.assert_array_equal(p["image"], off["image"])


def test_two_phase_frame_matches_single_phase_on_a_static_scene():
    psc, pb = build_scene(PORT_PKG, "basic")
    buf = pb.build_scene_buffers(device="cpu")
    view, proj, pos = psc.camera_matrices(aspect=1.0)
    vd = make_view(view, proj, pos, device="cpu")
    params = FrameParams.default("cpu")
    occ = FrameConfig(**OCC_KW)
    base = build_frame_fn(FrameConfig(**CFG_KW))(buf, vd, params)
    prev = torch.zeros((occ.padded_height, occ.padded_width))
    out = build_frame_fn(occ)(buf, vd, params, prev)
    assert torch.equal(out["vis"], base["vis"])
    assert torch.equal(out["image"], base["image"])
    again = build_frame_fn(occ)(buf, vd, params, out["depth_padded"])
    assert torch.equal(again["vis"], base["vis"])
    assert torch.equal(again["image"], base["image"])
