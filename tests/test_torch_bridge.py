"""Port bridge vs JAX bridge: the same scene built through each package's
own host modules must pack to identical soup fields, object snapshots and
light tables (exact equality: both are the same numpy code)."""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

JAX_PKG = "basicrenderer_tpu"
PORT_PKG = "basicrenderer_tpu_torch"
SOUP_FIELDS = ("positions", "normals", "tangents", "uvs", "vert_object",
               "indices", "tri_material", "tri_object", "num_verts",
               "num_tris", "local_bounds")


def _pkg(root):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(
        procedural=mod("models.procedural"), materials=mod("models.materials"),
        mesh=mod("models.mesh"), bridge=mod("scene.bridge"),
        scene=mod("scene.scene"))


def build_scene(root, variant):
    """(scene, bridge) for one of two test scenes, built from `root`'s own
    modules. "basic" is tests/test_frame_e2e.build_test_scene; "mixed" has
    four distinct meshes with rotations and scales, two directional, a
    point and two spot lights."""
    m = _pkg(root)
    Material = m.materials.Material
    meshes = m.mesh.MeshRegistry()
    mats = m.materials.MaterialRegistry()
    sc = m.scene.Scene()
    if variant == "basic":
        cube = meshes.add(m.procedural.make_cube(1.0))
        plane = meshes.add(m.procedural.make_plane(10.0, 2))
        red = mats.add(Material(name="red", base_color=np.array(
            [0.8, 0.1, 0.1, 1], np.float32), roughness=0.4))
        gray = mats.add(Material(name="gray", base_color=np.array(
            [0.5, 0.5, 0.5, 1], np.float32), roughness=0.9))
        sc.create_renderable(plane, gray)
        sc.create_renderable(cube, red, position=(0, 0.5, 0))
        sc.create_directional_light(direction=(-0.4, -1, -0.3), intensity=3.0)
        sc.set_camera(position=(3, 2.5, 4), target=(0, 0.5, 0), aspect=1.0)
    else:
        shapes = [meshes.add(m.procedural.make_plane(12.0, 4)),
                  meshes.add(m.procedural.make_uv_sphere(0.6, 8, 16)),
                  meshes.add(m.procedural.make_torus(0.5, 0.2, 12, 8)),
                  meshes.add(m.procedural.make_cube(0.8))]
        ids = [mats.add(Material(base_color=np.array([r, g, b, 1], np.float32),
                                 metallic=met, roughness=rough,
                                 emissive=np.array([0.0, 0.1 * k, 0.0],
                                                   np.float32)))
               for k, (r, g, b, met, rough) in enumerate(
                   [(0.5, 0.5, 0.5, 0.0, 0.9), (0.9, 0.7, 0.3, 1.0, 0.25),
                    (0.1, 0.5, 0.8, 0.0, 0.2), (0.8, 0.15, 0.1, 0.0, 0.35)])]
        sc.create_renderable(shapes[0], ids[0])
        for k, (shape, mid) in enumerate(zip(shapes[1:], ids[1:])):
            ang = 0.7 * (k + 1)
            q = (0.0, np.sin(ang / 2), 0.0, np.cos(ang / 2))
            sc.create_renderable(shape, mid, position=(1.5 * k - 1.5, 0.6, 0.3 * k),
                                 rotation=q, scale=(1.0, 0.8 + 0.2 * k, 1.1))
        sc.create_point_light(position=(0, 2, 2), intensity=10.0, range=10.0)
        sc.create_spot_light(position=(2, 3, 0), direction=(-0.5, -1, 0),
                             intensity=20.0, cast_shadows=True)
        sc.create_directional_light(direction=(-0.4, -1, -0.3), intensity=2.0)
        sc.create_spot_light(position=(-2, 3, 1), direction=(0.3, -1, 0.2),
                             color=(1.0, 0.5, 0.2), intensity=15.0)
        sc.create_directional_light(direction=(0.3, -0.6, 0.5), intensity=0.5,
                                    color=(0.6, 0.7, 1.0))
        sc.set_camera(position=(4, 3, 5), target=(0, 0.5, 0), aspect=1.0)
    sc.propagate_transforms()
    caps = m.bridge.BridgeCapacities(max_vertices=1 << 12, max_triangles=1 << 12,
                                     max_objects=16, max_materials=16,
                                     max_lights=8)
    return sc, m.bridge.SceneRenderBridge(sc, meshes, mats, caps)


@pytest.mark.parametrize("variant", ["basic", "mixed"])
def test_soup_fields_match_jax_bridge(variant):
    _, jb = build_scene(JAX_PKG, variant)
    _, pb = build_scene(PORT_PKG, variant)
    jp, pp = jb.pack_geometry(), pb.pack_geometry()
    for f in SOUP_FIELDS:
        np.testing.assert_array_equal(getattr(pp, f), getattr(jp, f), err_msg=f)
    assert pp.entity_to_object == jp.entity_to_object


@pytest.mark.parametrize("variant", ["basic", "mixed"])
def test_snapshots_match_jax_bridge(variant):
    _, jb = build_scene(JAX_PKG, variant)
    _, pb = build_scene(PORT_PKG, variant)
    jb.pack_geometry()
    pb.pack_geometry()
    for a, b in zip(pb.snapshot_objects(), jb.snapshot_objects()):
        np.testing.assert_array_equal(a, b)
    (pt, pn, pd), (jt, jn, jd) = pb.snapshot_lights(), jb.snapshot_lights()
    np.testing.assert_array_equal(pt, jt)
    assert (pn, pd) == (jn, jd)


@pytest.mark.parametrize("variant", ["basic", "mixed"])
def test_scene_buffers_match_jax(variant):
    """build_scene_buffers: every soup field of the port equals the JAX
    SceneBuffers field, and update_dynamic keeps them equal after a move."""
    from basicrenderer_tpu.scene.components import Position as JPos
    from basicrenderer_tpu_torch.graph.framedata import SceneBuffers
    from basicrenderer_tpu_torch.scene.components import Position as PPos
    jsc, jb = build_scene(JAX_PKG, variant)
    psc, pb = build_scene(PORT_PKG, variant)
    jbuf, pbuf = jb.build_scene_buffers(), pb.build_scene_buffers(device="cpu")
    names = [f for f in SceneBuffers.__dataclass_fields__]
    for f in names:
        assert_field_equal(getattr(pbuf, f), getattr(jbuf, f), f)
    # Move the last renderable in both worlds, refresh the dynamic fields.
    for sc, Pos in ((jsc, JPos), (psc, PPos)):
        ents = sorted(e for e, _ in sc.world.query(Pos))
        sc.world.set(ents[-1], Pos(np.array([0.3, 1.1, -0.2], np.float32)))
        sc.propagate_transforms()
    jbuf, pbuf = jb.update_dynamic(jbuf), pb.update_dynamic(pbuf)
    for f in names:
        assert_field_equal(getattr(pbuf, f), getattr(jbuf, f), f)


def test_instanced_mesh_packs_like_jax():
    """A mesh instanced twice packs its geometry and vertex pages once and
    gets one set of cluster rows per instance, as in the JAX bridge."""
    bufs = []
    for root in (JAX_PKG, PORT_PKG):
        m = _pkg(root)
        meshes, mats = m.mesh.MeshRegistry(), m.materials.MaterialRegistry()
        cube = meshes.add(m.procedural.make_cube(1.0))
        sphere = meshes.add(m.procedural.make_uv_sphere(0.5, 12, 24))
        sc = m.scene.Scene()
        sc.create_renderable(cube, 0)
        sc.create_renderable(sphere, 0, position=(0, 1, 0))
        sc.create_renderable(cube, 0, position=(2, 0, 0))
        sc.propagate_transforms()
        caps = m.bridge.BridgeCapacities(max_vertices=1 << 11,
                                         max_triangles=1 << 11, max_objects=8,
                                         max_clusters=64, max_geom_clusters=32)
        b = m.bridge.SceneRenderBridge(sc, meshes, mats, caps)
        bufs.append(b.build_scene_buffers(**({"device": "cpu"}
                                             if root == PORT_PKG else {})))
    jbuf, pbuf = bufs
    assert int(pbuf.num_clusters) == int(jbuf.num_clusters) == 7  # 1 + 5 + 1
    for f in ("cluster_table", "cluster_object", "cluster_verts",
              "cluster_dequant", "tri_cluster", "cluster_windows"):
        assert_field_equal(getattr(pbuf, f), getattr(jbuf, f), f)


def test_entry_points_default_to_the_card():
    """The port's entry points place data on the card unless the caller
    names another device."""
    import inspect
    from basicrenderer_tpu_torch import interop
    from basicrenderer_tpu_torch.graph import framedata
    from basicrenderer_tpu_torch.scene.bridge import SceneRenderBridge
    fns = [SceneRenderBridge.build_scene_buffers, framedata.make_view,
           framedata.FrameParams.default, interop.scene_buffers,
           interop.view_data, interop.frame_params, interop.binned_pairs,
           interop.group_binned_pairs]
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def assert_field_equal(p, j, name):
    """A port tensor equals a JAX array; int32 tensors holding uint32 words
    are compared bit for bit."""
    j = np.asarray(j)
    p = p.numpy()
    if j.dtype == np.uint32:
        p = p.view(np.uint32)
    np.testing.assert_array_equal(p, j, err_msg=name)


def test_scene_buffers_move_between_devices():
    _, pb = build_scene(PORT_PKG, "basic")
    buf = pb.build_scene_buffers(device="cpu")
    moved = buf.to(torch.device("cpu"))
    assert moved.positions.device.type == "cpu"
    np.testing.assert_array_equal(moved.lights.numpy(), buf.lights.numpy())
