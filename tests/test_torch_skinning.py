"""Skinning: the port against the JAX package on the CPU.

Mirrors tests/test_skinning.py. Rig (each package building it from its
own modules): the two-bone cylinder of tests/test_skinning.py, bent 90
degrees about z by its clip over one second, on a floor, at 128x128 with
tile_h=16.

Tolerances:
- the bridge's skinned packing (vert_joints, vert_weights, the skin
  instances): equal; the joint palette at each time within 1e-6 absolute
  (models/animation.py composes it with numpy f32 quaternion helpers,
  which stay within 6e-8 of the JAX package's);
- apply_skinning: positions and normals within 1e-6 absolute (the JAX
  package fetches the joint matrices by one-hot matmuls, the port by
  index: both exact; the blend is the same f32 sum);
- the frames at t = 0, 0.5 and 1 on the soup path and on the cluster path
  (which with enable_skinning sets up from the vertex table): vis equal
  on >= 99.9% of pixels, image RMSE <= 1.0 on the 0-255 scale.
"""

import importlib
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import jax
import pytest
import torch

from tests.test_skinning import make_two_bone_cylinder, make_two_bone_skeleton

JAX_PKG = "basicrenderer_tpu"
PORT_PKG = "basicrenderer_tpu_torch"
TIMES = (0.0, 0.5, 1.0 - 1e-4)
CFG_KW = dict(width=128, height=128, tile_h=16, tile_w=128,
              max_pairs=1 << 12, enable_skinning=True)
PATHS = {"soup": dict(), "cluster": dict(enable_clod=True,
                                         max_visible_clusters=64)}
# The clip's end key: 90 degrees about +z.
Q90 = np.array([0.0, 0.0, np.sin(np.pi / 4), np.cos(np.pi / 4)], np.float32)


def _pkg(root):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(
        procedural=mod("models.procedural"), materials=mod("models.materials"),
        mesh=mod("models.mesh"), animation=mod("models.animation"),
        bridge=mod("scene.bridge"), scene=mod("scene.scene"),
        skinning=mod("ops.skinning"), frame=mod("graph.frame"),
        fd=mod("graph.framedata"))


def build(root):
    """(modules, bridge, view matrices, mesh) of the bending rig."""
    m = _pkg(root)
    meshes, mats = m.mesh.MeshRegistry(), m.materials.MaterialRegistry()
    c = make_two_bone_cylinder()
    mesh = m.mesh.MeshData(c.positions, c.normals, c.uvs, c.indices,
                           joints=c.joints, weights=c.weights)
    mid = meshes.add(mesh)
    floor = meshes.add(m.procedural.make_plane(6.0, 2))
    s = make_two_bone_skeleton()
    reg = m.animation.SkeletonRegistry()
    sid = reg.add(m.animation.Skeleton(s.parents, s.inverse_bind, s.rest_pos,
                                       s.rest_rot, s.rest_scale))
    reg.add_clip(sid, m.animation.AnimationClip("bend", [
        m.animation.Channel(1, "rotation", np.array([0.0, 1.0], np.float32),
                            np.stack([np.array([0, 0, 0, 1], np.float32),
                                      Q90]))]))
    reg.play(sid, 0)
    red = mats.add(m.materials.Material(
        base_color=np.array([0.8, 0.2, 0.2, 1], np.float32)))
    sc = m.scene.Scene()
    sc.create_renderable(mid, red, skeleton_id=sid)   # packed first
    sc.create_renderable(floor, 0)
    sc.create_directional_light(direction=(-0.4, -1, -0.3), intensity=3.0)
    sc.set_camera(position=(0.5, 1.6, 3.2), target=(-0.3, 0.9, 0),
                  aspect=1.0)
    sc.propagate_transforms()
    caps = m.bridge.BridgeCapacities(
        max_vertices=1 << 10, max_triangles=1 << 10, max_objects=4,
        max_materials=4, max_lights=2, max_clusters=128, max_joints=16,
        max_geom_clusters=64)
    bridge = m.bridge.SceneRenderBridge(sc, meshes, mats, caps,
                                        skeletons=reg)
    return m, bridge, sc.camera_matrices(aspect=1.0), mesh


@pytest.fixture(scope="module")
def rigs():
    return {root: build(root) for root in (JAX_PKG, PORT_PKG)}


def test_skinned_packing_matches_jax(rigs):
    _, jb, _, _ = rigs[JAX_PKG]
    _, pb, _, _ = rigs[PORT_PKG]
    jp, pp = jb.pack_geometry(), pb.pack_geometry()
    np.testing.assert_array_equal(pp.vert_joints, jp.vert_joints)
    np.testing.assert_array_equal(pp.vert_weights, jp.vert_weights)
    assert pp.skin_instances == jp.skin_instances == [(0, 0, 2)]
    for t in TIMES:
        np.testing.assert_allclose(pb.snapshot_joint_palette(t),
                                   jb.snapshot_joint_palette(t), atol=1e-6)
    buf = pb.update_dynamic(pb.build_scene_buffers(device="cpu"), TIMES[2])
    np.testing.assert_array_equal(buf.joint_palette.numpy(),
                                  pb.snapshot_joint_palette(TIMES[2]))
    assert not np.allclose(buf.joint_palette.numpy()[1],
                           np.eye(4).reshape(-1))


def test_instances_of_a_skinned_mesh_pack_apart():
    """Two skinned instances of one mesh get their own vertices and
    palette blocks; an unskinned instance of it shares nothing with
    them (the JAX bridge's ("skin", entity) pack key)."""
    out = {}
    for root in (JAX_PKG, PORT_PKG):
        m, bridge, _, _ = build(root)
        mid = bridge.meshes.meshes.index(
            next(x for x in bridge.meshes.meshes if x.joints is not None))
        bridge.scene.create_renderable(mid, 0, skeleton_id=0,
                                       position=(1.5, 0, 0))
        bridge.scene.create_renderable(mid, 0, position=(-1.5, 0, 0))
        bridge.scene.propagate_transforms()
        p = bridge.pack_geometry()
        out[root] = p
    jp, pp = out[JAX_PKG], out[PORT_PKG]
    assert pp.skin_instances == jp.skin_instances
    assert len(pp.skin_instances) == 2
    assert (pp.num_verts, pp.num_tris, pp.num_clusters) == \
        (jp.num_verts, jp.num_tris, jp.num_clusters)
    np.testing.assert_array_equal(pp.vert_joints, jp.vert_joints)
    np.testing.assert_array_equal(pp.cluster_table, jp.cluster_table)


def test_apply_skinning_matches_jax(rigs):
    jm, jb, _, mesh = rigs[JAX_PKG]
    pm, pb, _, _ = rigs[PORT_PKG]
    nv = mesh.num_vertices
    for t in TIMES:
        jbuf = jb.update_dynamic(jb.build_scene_buffers(), t)
        pbuf = pb.update_dynamic(pb.build_scene_buffers(device="cpu"), t)
        js = jax.jit(lambda b: jm.skinning.apply_skinning(
            b, b.joint_palette, b.vert_joints, b.vert_weights))(jbuf)
        ps = pm.skinning.apply_skinning(pbuf, pbuf.joint_palette,
                                        pbuf.vert_joints, pbuf.vert_weights)
        np.testing.assert_allclose(ps.positions.numpy(),
                                   np.asarray(js.positions), atol=1e-6)
        np.testing.assert_allclose(ps.normals.numpy(),
                                   np.asarray(js.normals), atol=1e-6)
    # t ~ 1: bent 90 degrees, the top ring moved toward -x about the
    # middle joint; the floor's vertices (zero weights) pass through.
    top = ps.positions.numpy()[:nv][-8:]
    assert top[:, 0].mean() < -0.5 and abs(top[:, 1].mean() - 1.0) < 0.3
    np.testing.assert_array_equal(ps.positions.numpy()[nv:],
                                  pbuf.positions.numpy()[nv:])


def _frames(rigs, root, path):
    m, bridge, view, _ = rigs[root]
    kw = dict(CFG_KW, **PATHS[path])
    outs = []
    if root == JAX_PKG:
        fn = jax.jit(m.frame.build_frame_fn(m.fd.FrameConfig(
            **kw, use_pallas_raster=False)))
        for t in TIMES:
            buf = bridge.update_dynamic(bridge.build_scene_buffers(), t)
            o = fn(buf, m.fd.make_view(*view), m.fd.FrameParams.default())
            outs.append({k: np.asarray(o[k]) for k in ("vis", "image")})
        return outs
    fn = m.frame.build_frame_fn(m.fd.FrameConfig(**kw))
    for t in TIMES:
        buf = bridge.update_dynamic(bridge.build_scene_buffers(device="cpu"),
                                    t)
        o = fn(buf, m.fd.make_view(*view, device="cpu"),
               m.fd.FrameParams.default("cpu"))
        outs.append({k: o[k].numpy() for k in ("vis", "image")})
    return outs


@pytest.fixture(scope="module")
def frames(rigs):
    with ThreadPoolExecutor(len(PATHS)) as pool:
        jfut = {p: pool.submit(_frames, rigs, JAX_PKG, p) for p in PATHS}
        pouts = {p: _frames(rigs, PORT_PKG, p) for p in PATHS}
        return {p: (jfut[p].result(), pouts[p]) for p in PATHS}


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float32)
                                  - np.asarray(b, np.float32)) ** 2)))


@pytest.mark.parametrize("path", list(PATHS))
def test_skinned_frames_match_jax(frames, path):
    jouts, pouts = frames[path]
    for i, (j, p) in enumerate(zip(jouts, pouts)):
        assert (p["vis"] == j["vis"]).mean() >= 0.999, i
        assert _rmse(p["image"], j["image"]) <= 1.0, i
    # The cylinder bends: its pixels move between the first and last frame.
    assert (pouts[0]["vis"] != pouts[-1]["vis"]).mean() > 0.01
    assert (pouts[0]["vis"] > 0).mean() > 0.3


def test_cluster_setup_reads_the_vertex_table(rigs):
    """With enable_skinning the cluster setup takes the vertex table (the
    pages are static): the bent cylinder's cluster frame equals its soup
    frame's image."""
    pm, bridge, view, _ = rigs[PORT_PKG]
    buf = bridge.update_dynamic(bridge.build_scene_buffers(device="cpu"),
                                TIMES[2])
    vd = pm.fd.make_view(*view, device="cpu")
    imgs = [pm.frame.build_frame_fn(pm.fd.FrameConfig(**CFG_KW, **flags))(
        buf, vd, pm.fd.FrameParams.default("cpu"))["image"].numpy()
        for flags in (dict(), dict(enable_clod=True,
                                   max_visible_clusters=64))]
    assert _rmse(imgs[0], imgs[1]) <= 1.0


def test_renderer_enables_skinning_and_animates():
    """The Renderer switches skinning on for a skinned instance and its
    palette follows the clock in update(), inline and overlapped."""
    from basicrenderer_tpu_torch.renderer import Renderer
    pm = _pkg(PORT_PKG)
    for overlap in (False, True):
        r = Renderer(caps=pm.bridge.BridgeCapacities(
            max_vertices=1 << 10, max_triangles=1 << 10, max_objects=4,
            max_materials=4, max_lights=2, max_clusters=128, max_joints=16,
            max_geom_clusters=64), device="cpu")
        c = make_two_bone_cylinder()
        mid = r.meshes.add(pm.mesh.MeshData(
            c.positions, c.normals, c.uvs, c.indices, joints=c.joints,
            weights=c.weights))
        s = make_two_bone_skeleton()
        sid = r.skeletons.add(pm.animation.Skeleton(
            s.parents, s.inverse_bind, s.rest_pos, s.rest_rot, s.rest_scale))
        r.skeletons.add_clip(sid, pm.animation.AnimationClip("bend", [
            pm.animation.Channel(1, "rotation",
                                 np.array([0.0, 1.0], np.float32),
                                 np.stack([np.array([0, 0, 0, 1],
                                                    np.float32), Q90]))]))
        r.skeletons.play(sid, 0)
        sc = pm.scene.Scene()
        sc.create_renderable(mid, 0, skeleton_id=sid)
        sc.create_directional_light(direction=(-0.4, -1, -0.3),
                                    intensity=3.0)
        sc.set_camera(position=(0.5, 1.6, 3.2), target=(-0.3, 0.9, 0))
        for k, v in (("renderResolution", (64, 64)), ("enableShadows", False),
                     ("enableSceneOverlap", overlap)):
            r.settings.set(k, v)
        r.set_current_scene(sc)
        vis = []
        for _ in range(4):
            r.update(dt=0.3)
            vis.append(r.render()["vis"].numpy())
        assert r.current_config().enable_skinning
        assert not np.array_equal(vis[0], vis[-1])
        palette = r._buffers.joint_palette.numpy()
        assert not np.allclose(palette[1], np.eye(4).reshape(-1))
