"""Vertex tangents in the port vs the JAX package on the CPU.

- The theta wire encoding (raster_setup.encode_theta_cols), its decode
  (shade.tangent_from_theta) and the soup setup's per-vertex theta
  (raster_setup.vertex_world_theta): within 2e-5, the bound of
  tests/test_tangents.py's round trip.
- SceneBuffers.cluster_tangents: equal to the JAX bridge's (the same
  numpy code).
- K1's and K2's tangent modes (channel 5 takes setup lane 27): the plain
  versions equal the Pallas kernels in interpret mode exactly (depth, vis
  and all 8 channels) on the same lanes, with random tangent angles in
  lane 27.
- The mirrored-UV planes of tests/test_tangents.py, rendered by both
  packages with a normal map and enable_vertex_tangents on the cluster
  path (straight and rotated instance) and the soup path: the port's
  perturbed G-buffer normals against the JAX frame's debug_view="normals"
  image within 2/255 (the port has no debug views: the normals are taken
  from its texture stage), and the shaded image of the straight
  cluster-path plane within RMSE 1.0 with vis equal.

The JAX frames run the reference raster twins under jax.jit; the CUDA
kernels have no CPU mode (tests/test_torch_raster*.py hold them against
the plain versions on a card).
"""

import dataclasses
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from basicrenderer_tpu.graph.frame import build_frame_fn as j_build_frame_fn
from basicrenderer_tpu.graph.framedata import FrameConfig as JConfig
from basicrenderer_tpu.graph.framedata import FrameParams as JParams
from basicrenderer_tpu.graph.framedata import make_view as j_make_view
from basicrenderer_tpu.ops import raster_setup as jrs
from basicrenderer_tpu.ops import shade as jshade
from basicrenderer_tpu.ops.raster_pallas import raster_tiles_pallas
from basicrenderer_tpu_torch import interop
from basicrenderer_tpu_torch.graph import frame as pframe
from basicrenderer_tpu_torch.graph.framedata import FrameConfig as PConfig
from basicrenderer_tpu_torch.graph.framedata import FrameParams, make_view
from basicrenderer_tpu_torch.ops import raster as praster
from basicrenderer_tpu_torch.ops import raster_setup as prs
from basicrenderer_tpu_torch.ops import shade as pshade

from tests.test_raster import random_clip_triangles, setup_from_clip
from tests.test_torch_bridge import JAX_PKG, PORT_PKG, _pkg, build_scene
from tests.test_torch_raster import peel_band, with_payload

TOL = 2e-5


def _np_fields(nt):
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


def _t(x):
    return torch.as_tensor(np.array(x, np.float32))


def _random_frames(seed, n=64):
    """Unit normals, unit tangents orthogonal to them, random handedness."""
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    tan = rng.normal(size=(n, 3))
    tan -= nrm * np.sum(tan * nrm, 1, keepdims=True)
    tan /= np.linalg.norm(tan, axis=1, keepdims=True)
    w = np.where(rng.random(n) < 0.5, 1.0, -1.0)
    return [np.asarray(a, np.float32) for a in (nrm, tan, w)]


def test_theta_encode_and_decode_match_jax():
    nrm, tan, w = _random_frames(0)
    cols = (tan[:, 0], tan[:, 1], tan[:, 2], w, nrm[:, 0], nrm[:, 1],
            nrm[:, 2])
    jenc = np.asarray(jax.jit(jrs.encode_theta_cols)(
        *(jnp.asarray(c) for c in cols)))
    penc = prs.encode_theta_cols(*(_t(c) for c in cols)).numpy()
    np.testing.assert_allclose(penc, jenc, atol=TOL, rtol=0)
    assert (penc > 2 * np.pi).sum() == (w < 0).sum()
    jT, jB = (np.asarray(x) for x in jax.jit(jshade.tangent_from_theta)(
        jnp.asarray(nrm), jnp.asarray(jenc)))
    pT, pB = (x.numpy() for x in pshade.tangent_from_theta(_t(nrm),
                                                           _t(jenc)))
    np.testing.assert_allclose(pT, jT, atol=TOL, rtol=0)
    np.testing.assert_allclose(pB, jB, atol=TOL, rtol=0)
    # And the round trip of tests/test_tangents.py.
    np.testing.assert_allclose(pT, tan, atol=TOL, rtol=0)
    np.testing.assert_allclose(pB, np.cross(nrm, tan) * w[:, None],
                               atol=TOL, rtol=0)


def test_vertex_world_theta_matches_jax():
    """The soup setup's per-vertex theta on the mixed scene (rotated,
    non-uniformly scaled instances)."""
    out = []
    for root in (JAX_PKG, PORT_PKG):
        _sc, br = build_scene(root, "mixed")
        if root == JAX_PKG:
            buf = br.build_scene_buffers()

            def theta(b):
                _c, _w, wn = jrs.transform_geometry(
                    b.positions, b.normals, b.vert_object, b.object_mats,
                    b.object_normal_mats, jnp.eye(4, dtype=jnp.float32))
                return jrs.vertex_world_theta(b, wn)
            out.append(np.asarray(jax.jit(theta)(buf)))
        else:
            buf = br.build_scene_buffers(device="cpu")
            _c, _w, wn = prs.transform_geometry(
                buf.positions, buf.normals, buf.vert_object, buf.object_mats,
                buf.object_normal_mats, torch.eye(4))
            out.append(prs.vertex_world_theta(buf, wn).numpy())
        nv = int(buf.num_verts)
    jth, pth = out[0][:nv], out[1][:nv]
    assert (pth > 2 * np.pi).any() or (pth != 0).any()
    np.testing.assert_allclose(pth, jth, atol=TOL, rtol=0)


def test_cluster_tangents_match_jax_bridge():
    """The (G, 512) per-triangle corner-0 object tangents, plane-major, on
    the mixed scene and on a scene with an instanced mesh."""
    for variant in ("mixed", "instanced"):
        bufs = []
        for root in (JAX_PKG, PORT_PKG):
            if variant == "mixed":
                _sc, br = build_scene(root, "mixed")
            else:
                m = _pkg(root)
                meshes = m.mesh.MeshRegistry()
                mats = m.materials.MaterialRegistry()
                cube = meshes.add(m.procedural.make_cube(1.0))
                sph = meshes.add(m.procedural.make_uv_sphere(0.5, 12, 24))
                sc = m.scene.Scene()
                sc.create_renderable(cube, 0)
                sc.create_renderable(sph, 0, position=(0, 1, 0))
                sc.create_renderable(cube, 0, position=(2, 0, 0))
                sc.propagate_transforms()
                br = m.bridge.SceneRenderBridge(
                    sc, meshes, mats, m.bridge.BridgeCapacities(
                        max_vertices=1 << 11, max_triangles=1 << 11,
                        max_objects=8, max_clusters=64, max_geom_clusters=32))
            kw = {"device": "cpu"} if root == PORT_PKG else {}
            bufs.append(br.build_scene_buffers(**kw))
        jt = np.asarray(bufs[0].cluster_tangents)
        pt = bufs[1].cluster_tangents.numpy()
        assert pt.shape == jt.shape and pt.shape[1] == 512
        assert np.abs(pt).max() > 0.5
        np.testing.assert_array_equal(pt, jt)


# --- K1 and K2 tangent modes against the Pallas kernels ------------------

KW = dict(width=128, height=64, tile_h=16, tile_w=128, max_pairs=1 << 12,
          max_group_pairs=1 << 10, group_rows=8,
          enable_vertex_tangents=True)


def _tangent_lanes(seed, n, jc):
    """Setup rows of n random triangles with random accum payloads and a
    random tangent angle in lane 27 of every live row."""
    rng = np.random.default_rng(seed)
    setup = setup_from_clip(random_clip_triangles(rng, n), jc)
    lanes = with_payload(rng, jrs.pack_setup_lanes(setup))
    lanes[:, 27] = np.where(lanes[:, 9] > 0.5,
                            rng.uniform(-np.pi, 5 * np.pi, lanes.shape[0]), 0)
    return rng, setup, jnp.asarray(lanes)


def _seed_buffers(rng, H, W):
    """A seed for the seeded modes: a far depth with holes, random ids and
    random channels (channel 5 too, so a kept seed value shows)."""
    d = rng.uniform(0.0, 0.2, (H, W)).astype(np.float32)
    d[:, ::7] = 0.0
    v = rng.integers(0, 50, (H, W)).astype(np.int32)
    ch = rng.normal(size=(8, H, W)).astype(np.float32)
    return d, v, ch


@pytest.mark.parametrize("kernel,mode", [
    ("K1", "plain"), ("K1", "seeded"), ("K1", "peel"),
    ("K2", "plain"), ("K2", "seeded"), ("K2", "peel")])
def test_tangent_mode_matches_pallas_interpret(kernel, mode):
    jc, pc = JConfig(**KW), PConfig(**KW)
    rng, setup, lanes = _tangent_lanes(3 if kernel == "K1" else 4, 64, jc)
    if kernel == "K1":
        jpairs = jrs.bin_pairs(lanes, setup.bbox, setup.valid, jc)
        ppairs = interop.binned_pairs(_np_fields(jpairs), device="cpu")
    else:
        jpairs = jrs.bin_groups(lanes, setup.bbox, setup.valid, jc)
        ppairs = interop.group_binned_pairs(_np_fields(jpairs), device="cpu")
    H, W = pc.padded_height, pc.padded_width
    jkw, pkw = {}, {}
    if mode == "seeded":
        seed = _seed_buffers(rng, H, W)
        jkw["init"] = tuple(jnp.asarray(x) for x in seed)
        pkw["init"] = tuple(torch.as_tensor(x) for x in seed)
    elif mode == "peel":
        band = peel_band(rng, H, W)
        jkw["peel"] = tuple(jnp.asarray(x) for x in band)
        pkw["peel"] = tuple(torch.as_tensor(x) for x in band)
    jd, jv, jch = (np.asarray(x) for x in raster_tiles_pallas(
        jpairs, jc, interpret=True, **jkw))
    pd, pv, pch = (x.numpy() for x in praster.raster_tiles(ppairs, pc, **pkw))
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pd, jd)
    np.testing.assert_array_equal(pch, jch)
    won = pd != (pkw["init"][0].numpy() if mode == "seeded" else
                 pkw["peel"][0].numpy() if mode == "peel" else 0)
    assert won.mean() > 0.2
    # Channel 5 carries the winners' lane 27; the seed's where none won.
    assert (pch[5][won] != 0).all()
    if mode == "seeded":
        np.testing.assert_array_equal(pch[5][~won], pkw["init"][2][5].numpy()
                                      [~won])
    if mode == "peel":
        # Accum mode ignores the tangent flag, as the JAX package's does.
        off = PConfig(**{**KW, "enable_vertex_tangents": False})
        acc_t = praster.raster_tiles(ppairs, pc, accum=True, **pkw)[2]
        acc = praster.raster_tiles(ppairs, off, accum=True, **pkw)[2]
        assert torch.equal(acc_t, acc)


# --- Mirrored-UV planes: the frame ---------------------------------------

def mirrored_rig(root, rotated: bool):
    """tests/test_tangents.py's mirrored plane and normal map, from
    `root`'s own modules; the instance rotated 90 degrees about +Y when
    `rotated`."""
    import importlib
    m = _pkg(root)
    TextureRegistry = importlib.import_module(
        f"{root}.models.textures").TextureRegistry
    s = 2.0
    pos = np.array([[-s, 0, -s], [0, 0, -s], [0, 0, s], [-s, 0, s],
                    [0, 0, -s], [s, 0, -s], [s, 0, s], [0, 0, s]], np.float32)
    nrm = np.tile(np.array([0, 1, 0], np.float32), (8, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1],
                   [1, 0], [0, 0], [0, 1], [1, 1]], np.float32)
    idx = np.array([[0, 2, 1], [0, 3, 2], [4, 6, 5], [4, 7, 6]], np.int32)
    meshes, mats = m.mesh.MeshRegistry(), m.materials.MaterialRegistry()
    tex = TextureRegistry(resolution=32)
    nm = np.zeros((32, 32, 4), np.float32)
    nm[...] = (0.8, 0.5, 0.9, 1.0)
    ntex = tex.add(nm, srgb=False)
    mid = meshes.add(m.mesh.MeshData(pos, nrm, uv, idx))
    mat = mats.add(m.materials.Material(
        base_color=np.array([1, 1, 1, 1], np.float32), roughness=0.9,
        normal_texture=ntex))
    sc = m.scene.Scene()
    kw = {}
    if rotated:
        kw["rotation"] = (0.0, np.sin(np.pi / 4), 0.0, np.cos(np.pi / 4))
    sc.create_renderable(mid, mat, **kw)
    sc.create_directional_light(direction=(0, -1, 0), intensity=3.0)
    sc.set_camera(position=(0, 5, 0.05), target=(0, 0, 0), aspect=1.0)
    sc.propagate_transforms()
    caps = m.bridge.BridgeCapacities(
        max_vertices=64, max_triangles=64, max_objects=4, max_materials=4,
        max_lights=2, max_clusters=8, max_geom_clusters=8)
    return sc, m.bridge.SceneRenderBridge(sc, meshes, mats, caps,
                                          textures=tex)


FRAME_KW = dict(width=128, height=128, tile_h=16, tile_w=128,
                max_pairs=1 << 10, max_visible_clusters=8,
                enable_textures=True, texture_downscale=1,
                tex_channels=("base", "normal"),
                enable_vertex_tangents=True)
CASES = {"clod": (True, False), "clod_rotated": (True, True),
         "soup": (False, False)}


def _jax_frame(case, debug_view):
    clod, rotated = CASES[case]
    sc, br = mirrored_rig(JAX_PKG, rotated)
    view, proj, pos = sc.camera_matrices(aspect=1.0)
    cfg = JConfig(**FRAME_KW, enable_clod=clod, use_pallas_raster=False,
                  debug_view=debug_view)
    out = jax.jit(j_build_frame_fn(cfg))(
        br.build_scene_buffers(), j_make_view(view, proj, pos),
        JParams.default())
    return {k: np.asarray(v) for k, v in out.items()}


def _port_frame(case):
    """The port's frame and its normal-mapped G-buffer normals."""
    clod, rotated = CASES[case]
    sc, br = mirrored_rig(PORT_PKG, rotated)
    view, proj, pos = sc.camera_matrices(aspect=1.0)
    normals = []
    apply = pframe._apply_textures

    def capture(*a, **k):
        gb = apply(*a, **k)
        normals.append(gb)
        return gb
    pframe._apply_textures = capture
    try:
        out = pframe.build_frame_fn(PConfig(**FRAME_KW, enable_clod=clod))(
            br.build_scene_buffers(device="cpu"),
            make_view(view, proj, pos, device="cpu"),
            FrameParams.default("cpu"))
    finally:
        pframe._apply_textures = apply
    gb = normals[0]
    img = torch.where(gb.valid[..., None], gb.normal * 0.5 + 0.5, 0.0)
    img = (torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    return {k: v.numpy() for k, v in out.items()}, img.numpy()


@pytest.fixture(scope="module")
def frames():
    """Every JAX frame the tests compare with, compiled in threads (XLA
    compiles overlap), and the port's frames."""
    jobs = [(c, "normals") for c in CASES] + [("clod", "none")]
    jout = {}

    def run(job):
        jout[job] = _jax_frame(*job)
    threads = [threading.Thread(target=run, args=(j,)) for j in jobs]
    for t in threads:
        t.start()
    pout = {c: _port_frame(c) for c in CASES}
    for t in threads:
        t.join()
    return jout, pout


@pytest.mark.parametrize("case", list(CASES))
def test_mirrored_normals_match_jax(frames, case):
    jout, pout = frames
    want = jout[(case, "normals")]["image"].astype(np.int32)
    out, got = pout[case]
    np.testing.assert_array_equal(out["vis"], jout[(case, "normals")]["vis"])
    assert np.abs(got.astype(np.int32) - want).max() <= 2
    # The tilt of tests/test_tangents.py: opposite on the mirrored halves
    # (and along world z for the rotated instance).
    n = got.astype(np.float32) / 255.0 * 2.0 - 1.0
    a = n[40:88, 20:55] if case != "clod_rotated" else n[20:55, 40:88]
    b = n[40:88, 73:108] if case != "clod_rotated" else n[73:108, 40:88]
    a, b = (x.reshape(-1, 3).mean(0) for x in (a, b))
    a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
    if case == "clod_rotated":
        assert sorted([a[2], b[2]])[0] < -0.5 < 0.5 < sorted([a[2], b[2]])[1]
    else:
        np.testing.assert_allclose(a, [0.6, 0.8, 0.0], atol=0.04)
        np.testing.assert_allclose(b, [-0.6, 0.8, 0.0], atol=0.04)


def test_mirrored_frame_image_matches_jax(frames):
    jout, pout = frames
    j, (p, _n) = jout[("clod", "none")], pout["clod"]
    np.testing.assert_array_equal(p["vis"], j["vis"])
    err = np.sqrt(np.mean((p["image"].astype(np.float32)
                           - j["image"].astype(np.float32)) ** 2))
    assert err <= 1.0, err
    assert (p["vis"] > 0).mean() > 0.3
