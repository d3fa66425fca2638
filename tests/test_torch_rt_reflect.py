"""Triangle ray-traced reflections: the port against the JAX package on
the CPU.

Mirrors tests/test_rt_reflect.py. Scene (each package building it from
its own modules): a mirror floor and a cluster-LOD red sphere above and
behind the camera's view of it, so only reflected rays see the sphere;
128x128 frames with tile_h=16 and 64 visible-cluster slots.

Tolerances:
- the slot BVH (Morton order by a stable sort, node boxes, spheres):
  equal;
- the Möller-Trumbore pass on the same rows (rays aimed at the sphere,
  every slot): hits equal, t and the geometric normal within 1e-5
  relative;
- trace_reflections on a frame's depth and a flat normal field:
  its column math decides hits near triangle edges, where the JAX
  package's contracted products may round apart, so the hit masks are
  held by their agreement share, >= 99.9%, and the radiance within 1e-5
  absolute where they agree;
- the frame with every reflection tier (RT reflections with IBL, the
  voxel tier under them, SSR over them, the windowed cut): vis equal on
  >= 99.9% of pixels, image RMSE <= 1.0 on the 0-255 scale.
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
CFG_KW = dict(width=128, height=128, tile_h=16, tile_w=128,
              max_pairs=1 << 12, enable_clod=True, max_visible_clusters=64,
              enable_ibl=True, enable_rt_reflect=True, rt_downscale=2)
HIT_SHARE = 0.999
RTOL = 1e-5


def _pkg(root):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(
        procedural=mod("models.procedural"), clusters=mod("models.clusters"),
        materials=mod("models.materials"), mesh=mod("models.mesh"),
        bridge=mod("scene.bridge"), scene=mod("scene.scene"),
        rt=mod("ops.rt_reflect"), frame=mod("graph.frame"),
        fd=mod("graph.framedata"))


def build(root):
    m = _pkg(root)
    meshes, mats = m.mesh.MeshRegistry(), m.materials.MaterialRegistry()
    plane = meshes.add(m.procedural.make_plane(20.0, 8))
    lod = m.clusters.build_cluster_lod(
        m.procedural.make_uv_sphere(1.5, rings=16, sectors=32),
        use_cache=False)
    sphere = meshes.add(m.clusters.to_mesh_data(lod))
    mirror = mats.add(m.materials.Material(
        base_color=np.array([0.9, 0.9, 0.9, 1], np.float32),
        metallic=1.0, roughness=0.05))
    red = mats.add(m.materials.Material(
        base_color=np.array([0.9, 0.05, 0.05, 1], np.float32)))
    sc = m.scene.Scene()
    sc.create_renderable(plane, mirror)
    sc.create_renderable(sphere, red, position=(0.0, 4.0, -1.0))
    sc.create_directional_light(direction=(-0.3, -1.0, -0.2), intensity=3.0)
    sc.set_camera(position=(0, 2.0, 6.0), target=(0, 0.0, 0.0), aspect=1.0)
    sc.propagate_transforms()
    caps = m.bridge.BridgeCapacities(
        max_vertices=1 << 14, max_triangles=1 << 14, max_objects=8,
        max_materials=4, max_lights=4, max_clusters=256,
        max_geom_clusters=128, max_groups=128)
    bridge = m.bridge.SceneRenderBridge(sc, meshes, mats, caps)
    vox = bridge.build_voxel_scene(n=32)
    view = sc.camera_matrices(aspect=1.0)
    if root == JAX_PKG:
        return SimpleNamespace(m=m, buf=bridge.build_scene_buffers(),
                               view=m.fd.make_view(*view), vox=vox,
                               params=m.fd.FrameParams.default())
    return SimpleNamespace(m=m, buf=bridge.build_scene_buffers(device="cpu"),
                           view=m.fd.make_view(*view, device="cpu"), vox=vox,
                           params=m.fd.FrameParams.default("cpu"))


@pytest.fixture(scope="module")
def rig():
    j, p = build(JAX_PKG), build(PORT_PKG)
    jcfg = j.m.fd.FrameConfig(**CFG_KW, use_pallas_raster=False)
    pcfg = p.m.fd.FrameConfig(**CFG_KW)
    jcomp = jax.jit(lambda b, v: j.m.frame.clod_compact(
        b, v, jcfg, j.params, frustum=False))(j.buf, j.view)
    pcomp = p.m.frame.clod_compact(p.buf, p.view, pcfg, p.params,
                                   frustum=False)
    return SimpleNamespace(j=j, p=p, jcfg=jcfg, pcfg=pcfg, jcomp=jcomp,
                           pcomp=pcomp)


def test_slot_bvh_matches_jax(rig):
    jo = rig.j.m.rt.build_slot_bvh(rig.j.buf, rig.jcomp)
    po = rig.p.m.rt.build_slot_bvh(rig.p.buf, rig.pcomp)
    for name, a, b in zip(("node_lo", "node_hi", "order", "cw", "rw"),
                          po, jo):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    live = (rig.pcomp.slot_cluster >= 0).sum()
    assert 0 < live < rig.pcomp.slot_cluster.shape[0]


def test_morton_codes_match_jax():
    x = np.arange(1024, dtype=np.int32)
    np.testing.assert_array_equal(
        _pkg(PORT_PKG).rt._morton10(torch.as_tensor(x)).numpy(),
        np.asarray(_pkg(JAX_PKG).rt._morton10(jnp.asarray(x))).astype(
            np.int64))


def test_argmin_takes_the_first_of_ties():
    """The trace's node and candidate picks rely on the first index of a
    tie, as jnp.argmin gives it (rows of all inf included)."""
    x = torch.tensor([[3.0, 1.0, 1.0, 2.0], [float("inf")] * 4,
                      [0.5, 0.5, 0.5, 0.5]])
    assert torch.min(x, dim=1).indices.tolist() == [1, 0, 0]
    assert np.asarray(jnp.argmin(jnp.asarray(x.numpy()), axis=1)).tolist() \
        == [1, 0, 0]


def _rays(R=8):
    z = np.linspace(6.0, 8.0, R).astype(np.float32)
    return ([np.zeros(R, np.float32), np.full(R, 4.0, np.float32), z],
            [np.zeros(R, np.float32), np.zeros(R, np.float32),
             np.full(R, -1.0, np.float32)])


def test_intersect_matches_jax_and_hits_analytic_sphere(rig):
    """Rays aimed at the sphere, every slot brute-forced: each package's
    nearest hit; the two agree, and sit at the analytic distance (true
    triangles, quantized vertices)."""
    jrt, prt = rig.j.m.rt, rig.p.m.rt
    node_lo, node_hi, order, cw, rw = jrt.build_slot_bvh(rig.j.buf,
                                                         rig.jcomp)
    combined = np.asarray(jrt._combined_rows(rig.j.buf, rig.jcomp, order,
                                             cw, rw))
    _, _, porder, pcw, prw = prt.build_slot_bvh(rig.p.buf, rig.pcomp)
    pages, meta = prt._combined_rows(rig.p.buf, rig.pcomp, porder, pcw, prw)
    # The JAX combined row is [page bits | the port's meta row].
    np.testing.assert_array_equal(pages.numpy(),
                                  combined[:, :1152].view(np.int32))
    np.testing.assert_array_equal(meta.numpy(), combined[:, 1152:])
    (o, d), R = _rays(), 8
    jt_best = np.full(R, np.inf, np.float32)
    pt_best = np.full(R, np.inf, np.float32)
    jcols = [jnp.asarray(c) for c in o + d]
    pcols = [torch.as_tensor(c) for c in o + d]
    j_int = jax.jit(jrt._intersect_cluster)
    for s in range(combined.shape[0]):
        rows = np.broadcast_to(combined[s], (R, combined.shape[1]))
        jt, jx, jy, jz, jhit = (np.asarray(v) for v in j_int(
            jnp.asarray(rows), *jcols, 1e-3))
        pt, px, py, pz, phit = (v.numpy() for v in prt._intersect_cluster(
            pages[s].expand(R, -1), meta[s].expand(R, -1), *pcols, 1e-3))
        np.testing.assert_array_equal(phit, jhit)
        np.testing.assert_allclose(pt[phit], jt[jhit], rtol=RTOL)
        for a, b in ((px, jx), (py, jy), (pz, jz)):
            np.testing.assert_allclose(a[phit], b[jhit], rtol=RTOL,
                                       atol=1e-6)
        jt_best = np.where(jhit & (jt < jt_best), jt, jt_best)
        pt_best = np.where(phit & (pt < pt_best), pt, pt_best)
    assert np.isfinite(pt_best).all()
    np.testing.assert_allclose(pt_best, jt_best, rtol=RTOL)
    # Sphere centre (0, 4, -1), r 1.5: a ray from (0, 4, z0) along -z hits
    # at t = z0 - 0.5.
    np.testing.assert_allclose(pt_best, o[2] - 0.5, atol=0.08)


# Every reflection tier: the voxel cone trace under the RT hits under
# SSR, with the windowed cut.
JAX_FRAMES = {
    "rt_voxel_ssr": dict(enable_voxel_rt=True, voxel_rt_downscale=2,
                         enable_ssr=True, cut_windows=2),
}


def _jax_frame(rig, flags):
    vox = rig.j.vox
    cfg = dataclasses.replace(rig.jcfg, voxel_n=vox.n,
                              voxel_level_offsets=vox.level_offsets, **flags)
    out = jax.jit(rig.j.m.frame.build_frame_fn(cfg))(rig.j.buf, rig.j.view,
                                                     rig.j.params)
    return {k: np.asarray(out[k]) for k in ("vis", "image")}


def _port_frame(rig, flags):
    vox = rig.p.vox
    cfg = dataclasses.replace(rig.pcfg, voxel_n=vox.n,
                              voxel_level_offsets=vox.level_offsets, **flags)
    out = rig.p.m.frame.build_frame_fn(cfg)(rig.p.buf, rig.p.view,
                                            rig.p.params)
    return {k: out[k].numpy() for k in ("vis", "image", "depth")}


@pytest.fixture(scope="module")
def frames(rig):
    with ThreadPoolExecutor(len(JAX_FRAMES)) as pool:
        jfut = {n: pool.submit(_jax_frame, rig, f)
                for n, f in JAX_FRAMES.items()}
        pouts = {n: _port_frame(rig, f) for n, f in JAX_FRAMES.items()}
        pouts["rt"] = _port_frame(rig, dict())
        pouts["off"] = _port_frame(rig, dict(enable_rt_reflect=False))
        return {n: (jfut[n].result() if n in jfut else None, pouts[n])
                for n in pouts}


def test_trace_reflections_matches_jax(rig, frames):
    depth = frames["rt"][1]["depth"]
    nrm = np.zeros((128, 128, 3), np.float32)
    nrm[..., 1] = 1.0
    jcol, jhit = (np.asarray(v) for v in jax.jit(
        lambda buf, comp, view, d, n: rig.j.m.rt.trace_reflections(
            buf, comp, d, n, view, rig.jcfg))(
        rig.j.buf, rig.jcomp, rig.j.view, jnp.asarray(depth),
        jnp.asarray(nrm)))
    pcol, phit = (v.numpy() for v in rig.p.m.rt.trace_reflections(
        rig.p.buf, rig.pcomp, torch.from_numpy(depth.copy()),
        torch.from_numpy(nrm),
        rig.p.view, rig.pcfg))
    agree = phit == jhit
    assert agree.mean() >= HIT_SHARE
    assert jhit.max() == 1.0
    np.testing.assert_allclose(pcol[agree], jcol[agree], atol=1e-5)


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float32)
                                  - np.asarray(b, np.float32)) ** 2)))


@pytest.mark.parametrize("name", list(JAX_FRAMES))
def test_rt_frames_match_jax(frames, name):
    jout, pout = frames[name]
    assert (pout["vis"] == jout["vis"]).mean() >= 0.999
    assert _rmse(pout["image"], jout["image"]) <= 1.0


def test_frame_reflects_offscreen_sphere(frames):
    """The JAX package's check on the port's frames: the reflection
    changes a patch of the mirror floor toward red."""
    img = frames["rt"][1]["image"].astype(np.float32) / 255.0
    img0 = frames["off"][1]["image"].astype(np.float32) / 255.0
    floor = frames["rt"][1]["vis"] > 0
    changed = (np.abs(img - img0).max(-1) > 0.05) & floor
    assert changed.mean() > 0.005, changed.mean()
    ys, xs = np.nonzero(changed)
    assert (img[ys, xs, 0] - img0[ys, xs, 0]).mean() > 0.0
