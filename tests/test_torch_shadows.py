"""Cascaded, spot and point shadow maps: ops/shadows.py of the port and
the frame's shadow passes vs the JAX package on the CPU.

Scenes, each built by both packages from their own host modules:
- "wall": tests/test_shadows_ibl.py's floor and tall wall under one
  shadow-casting directional light (CSM);
- "spot": tests/test_spot_shadows.py's floor and cube under one
  shadow-casting spot light ("spot_sun" adds a dim shadow-casting
  directional light for the cascades over the cluster cut);
- "point": tests/test_spot_shadows.py's point-light scene.
The JAX functions run under jax.jit on the reference raster path.

Tolerances:
- cascade, spot and cube matrices: rtol 1e-5, atol 1e-6 (matrix
  inverse, pow, tan and arccos differ in the last ulp between XLA and
  PyTorch, and XLA contracts multiply-adds);
- each shadow map given the JAX package's viewproj: coverage equal on
  >= 99.9% of texels and depth within 5e-5 where both cover (the VSM
  atlas's bound: the soup's vertex transform is an einsum there);
- each sample_* function on identical depth, maps and viewprojs: >= 99.9%
  of pixels within 1e-5 (texel coordinates are truncated, so a
  coordinate an ulp from a texel edge may pick the neighbour; the 3x3
  smooth spreads a flip over a few pixels);
- frames at 128x128, tile_h 16: vis equal and image RMSE <= 1.0 (0-255).
"""

import importlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from basicrenderer_tpu.graph import frame as jframe
from basicrenderer_tpu.graph.frame import build_frame_fn as j_build_frame_fn
from basicrenderer_tpu.graph.framedata import FrameConfig as JConfig
from basicrenderer_tpu.graph.framedata import FrameParams as JParams
from basicrenderer_tpu.graph.framedata import make_view as j_make_view
from basicrenderer_tpu.ops import shadows as jshadows
from basicrenderer_tpu_torch.graph import frame as pframe
from basicrenderer_tpu_torch.graph.frame import build_frame_fn
from basicrenderer_tpu_torch.graph.framedata import (FrameConfig, FrameParams,
                                                     make_view)
from basicrenderer_tpu_torch.ops import raster_setup as psetup
from basicrenderer_tpu_torch.ops import shadows as pshadows

JAX_PKG = "basicrenderer_tpu"
PORT_PKG = "basicrenderer_tpu_torch"
MATS = dict(rtol=1e-5, atol=1e-6)
BASE = dict(width=128, height=128, tile_h=16, tile_w=128, max_pairs=1 << 12)
CLUSTER = dict(BASE, enable_clod=True, max_visible_clusters=16,
               enable_clustered=True, shadow_clusters=16)
# The frames: (scene, FrameConfig flags).
FRAMES = {
    "wall_soup": ("wall", dict(BASE, enable_shadows=True, num_cascades=3,
                               shadow_resolution=256)),
    "spot": ("spot", dict(CLUSTER, max_shadow_lights=1,
                          spot_shadow_resolution=256)),
    # A second, dead spot slot and CSM over the cluster cut (K2).
    "spot_dead_slot_csm": ("spot_sun", dict(CLUSTER, max_shadow_lights=2,
                                        spot_shadow_resolution=128,
                                        enable_shadows=True, num_cascades=2,
                                        shadow_resolution=128)),
    "point": ("point", dict(CLUSTER, max_shadow_cubes=1,
                            point_shadow_resolution=128)),
}
# The same frames with the shadows off: the behaviour checks' baselines.
UNSHADOWED = {
    "wall_soup": ("wall", BASE),
    "spot": ("spot_unshadowed", CLUSTER),
    "point": ("point", CLUSTER),
}


def _mod(root, name):
    return importlib.import_module(f"{root}.{name}")


def build(root, name):
    """(scene, bridge) of one test scene from `root`'s modules."""
    Material = _mod(root, "models.materials").Material
    meshes = _mod(root, "models.mesh").MeshRegistry()
    mats = _mod(root, "models.materials").MaterialRegistry()
    proc = _mod(root, "models.procedural")
    br = _mod(root, "scene.bridge")
    sc = _mod(root, "scene.scene").Scene()
    if name == "wall":
        plane = meshes.add(proc.make_plane(20.0, 2))
        cube = meshes.add(proc.make_cube(1.5))
        m = mats.add(Material(base_color=np.array([0.7, 0.7, 0.7, 1],
                                                  np.float32), roughness=0.8))
        sc.create_renderable(plane, m)
        sc.create_renderable(cube, m, position=(0, 1.5, 0), scale=(3, 2, 0.3))
        sc.create_directional_light(direction=(-0.5, -1.0, 0.6),
                                    intensity=4.0, cast_shadows=True)
        sc.set_camera(position=(6, 6, 8), target=(0, 0.5, 0), aspect=1.0)
        caps = br.BridgeCapacities(max_vertices=1 << 10,
                                   max_triangles=1 << 10, max_objects=8,
                                   max_materials=4, max_lights=4)
    else:
        cube = meshes.add(proc.make_cube(0.8))
        plane = meshes.add(proc.make_plane(12.0, 4))
        white = mats.add(Material(base_color=np.array([1, 1, 1, 1],
                                                      np.float32),
                                  roughness=0.9))
        sc.create_renderable(plane, white)
        if name == "point":
            sc.create_renderable(cube, white, position=(0, 1.0, 0))
            sc.create_point_light(position=(1.2, 3.5, 0.8), intensity=60.0,
                                  range=14.0, cast_shadows=True)
        else:
            sc.create_renderable(cube, white, position=(0, 0.8, 0))
            sc.create_spot_light(position=(1.5, 5.0, 1.0),
                                 direction=(-0.3, -1, -0.2), intensity=60.0,
                                 range=12.0, inner_cone=0.5, outer_cone=0.9,
                                 cast_shadows=name != "spot_unshadowed")
            if name == "spot_sun":
                sc.create_directional_light(direction=(-0.4, -1.0, -0.3),
                                            intensity=0.5, cast_shadows=True)
        sc.set_camera(position=(4, 4, 5), target=(0, 0.5, 0), aspect=1.0)
        caps = br.BridgeCapacities(max_vertices=1 << 10,
                                   max_triangles=1 << 10, max_objects=8,
                                   max_materials=4, max_lights=8,
                                   max_clusters=16, max_geom_clusters=16)
    sc.propagate_transforms()
    return sc, br.SceneRenderBridge(sc, meshes, mats, caps)


def _inputs(name):
    """JAX buffers and view, port buffers and view (CPU)."""
    (jsc, jb), (psc, pb) = build(JAX_PKG, name), build(PORT_PKG, name)
    return (jb.build_scene_buffers(), j_make_view(*jsc.camera_matrices(
        aspect=1.0)), pb.build_scene_buffers(device="cpu"),
        make_view(*psc.camera_matrices(aspect=1.0), device="cpu"))


def _rmse(a, b):
    return float(np.sqrt(np.mean((a.astype(np.float32)
                                  - b.astype(np.float32)) ** 2)))


def _np(out):
    return {k: np.asarray(v) for k, v in out.items()
            if isinstance(v, (jax.Array, np.ndarray))}


@pytest.fixture(scope="module")
def frames():
    """{frame name: (JAX outputs, port outputs)} for FRAMES, and the port's
    unshadowed baselines under ("base", name); each JAX configuration
    compiles once, in its own thread."""
    scenes = {s: _inputs(s) for s in ("wall", "spot", "spot_sun", "point",
                                      "spot_unshadowed")}

    def run(name):
        scene, flags = FRAMES[name]
        jb, jvd, pb, pvd = scenes[scene]
        jo = _np(jax.jit(j_build_frame_fn(JConfig(
            **flags, use_pallas_raster=False)))(jb, jvd, JParams.default()))
        po = build_frame_fn(FrameConfig(**flags))(
            pb, pvd, FrameParams.default("cpu"))
        return name, (jo, {k: v.numpy() for k, v in po.items()
                           if isinstance(v, torch.Tensor)})

    with ThreadPoolExecutor(len(FRAMES)) as pool:
        out = dict(pool.map(run, FRAMES))
    for name, (scene, flags) in UNSHADOWED.items():
        _, _, pb, pvd = scenes[scene]
        po = build_frame_fn(FrameConfig(**flags))(pb, pvd,
                                                   FrameParams.default("cpu"))
        out[("base", name)] = {k: v.numpy() for k, v in po.items()
                               if isinstance(v, torch.Tensor)}
    return out


@pytest.mark.parametrize("name", list(FRAMES))
def test_frame_matches_jax(frames, name):
    jo, po = frames[name]
    np.testing.assert_array_equal(po["vis"], jo["vis"])
    assert _rmse(po["image"], jo["image"]) <= 1.0
    for k in ("bin_overflow", "num_pairs", "cluster_overflow",
              "light_overflow"):
        assert int(po[k]) == int(jo[k]), k


def test_csm_darkens_ground_not_caster(frames):
    """tests/test_shadows_ibl.py's check on the port: the ground behind
    the wall darkens, the wall's own lit faces do not, nothing brightens."""
    h_sh = frames["wall_soup"][1]["hdr"]
    h_ns = frames[("base", "wall_soup")]["hdr"]
    vis = frames["wall_soup"][1]["vis"]
    ground = (vis >= 1) & (vis <= 8)
    cube = (vis > 8) & (h_ns.sum(-1) > 0.05)
    ratio_g = h_sh[ground].sum(-1) / np.maximum(h_ns[ground].sum(-1), 1e-6)
    ratio_c = h_sh[cube].sum(-1) / np.maximum(h_ns[cube].sum(-1), 1e-6)
    assert 0.02 < (ratio_g < 0.5).mean() < 0.9
    assert (ratio_c < 0.5).mean() < 0.05
    assert (np.concatenate([ratio_g, ratio_c]) < 1.05).all()


@pytest.mark.parametrize("name", ["spot", "point"])
def test_local_shadow_darkens_occluded_ground(frames, name):
    """tests/test_spot_shadows.py's checks on the port: the cube blocks
    the light from part of the ground, and most lit surface keeps its
    light."""
    img = frames[name][1]["image"].astype(np.float32)
    base = frames[("base", name)]["image"].astype(np.float32)
    vis = frames[name][1]["vis"]
    ratio = (img.mean(-1) + 1) / (base.mean(-1) + 1)
    assert ((ratio < 0.7) & (vis > 0)).sum() > 30
    assert (ratio[vis > 0] > 0.8).mean() > 0.5


# ---------------------------------------------------------------------------
# Matrices
# ---------------------------------------------------------------------------

def _random_lights(rng, n=12):
    """A light table with spots (lane 14 slots 0, 1, 3) and points (lane 15
    cubes 0, 2); slot 2 and cube 1 have no light (dead slots)."""
    L = np.zeros((n, 16), np.float32)
    L[:, 0:3] = rng.uniform(-5, 5, (n, 3))
    L[:, 3] = 1.0
    d = rng.normal(size=(n, 3))
    L[:, 4:7] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    L[:, 7] = 10.0
    L[:, 8:11] = 1.0
    L[:, 11] = rng.uniform(2, 20, n)
    L[:, 12] = np.cos(0.3)
    L[:, 13] = rng.uniform(0.3, 0.95, n)
    L[:, 14] = -1.0
    L[:, 15] = -1.0
    L[[1, 4, 7], 3] = 2.0
    L[[1, 4, 7], 14] = (0, 1, 3)
    L[[2, 9], 15] = (0, 2)
    L[3, 4:7] = (0.0, -1.0, 0.0)          # a spot straight down (+X up)
    L[3, 3], L[3, 14] = 2.0, 4
    return L


def test_cascade_matrices_match_jax():
    rng = np.random.default_rng(3)
    _, jvd, _, pvd = _inputs("wall")
    for d in list(rng.normal(size=(3, 3))) + [np.array([0.0, -1.0, 0.0])]:
        d = d.astype(np.float32)
        jv, js = jax.jit(jshadows.cascade_matrices, static_argnums=2)(
            jvd, jnp.asarray(d), 4)
        pv, ps = pshadows.cascade_matrices(pvd, torch.as_tensor(d), 4)
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), **MATS)
        np.testing.assert_allclose(ps.numpy(), np.asarray(js), **MATS)


def test_spot_and_cube_matrices_match_jax():
    L = _random_lights(np.random.default_rng(4))
    jv, ji, jl = jax.jit(jshadows.spot_shadow_matrices, static_argnums=1)(
        jnp.asarray(L), 5)
    pv, pi, pl = pshadows.spot_shadow_matrices(torch.as_tensor(L), 5)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), **MATS)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    assert pl.numpy().tolist() == [True, True, False, True, True]
    jv, ji, jl = jax.jit(jshadows.point_cube_matrices, static_argnums=1)(
        jnp.asarray(L), 3)
    pv, pi, pl = pshadows.point_cube_matrices(torch.as_tensor(L), 3)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), **MATS)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))


# ---------------------------------------------------------------------------
# Maps, given the same viewproj
# ---------------------------------------------------------------------------

def _map_case(kind):
    """(JAX buffers, port buffers, JAX config, port config, viewproj as
    numpy, JAX cut, port cut) of one map kind."""
    if kind == "cascade_soup":
        jb, jvd, pb, _ = _inputs("wall")
        flags = dict(BASE, shadow_resolution=256)
        vps, _ = jax.jit(jshadows.cascade_matrices, static_argnums=2)(
            jvd, jb.lights[0, 4:7], 3)
        return jb, pb, flags, np.asarray(vps[1]), None
    jb, jvd, pb, pvd = _inputs("spot" if kind != "cube_face" else "point")
    if kind == "cascade_clusters":
        jb, jvd, pb, pvd = _inputs("spot_sun")
        flags = dict(CLUSTER, shadow_resolution=128)
        vps, _ = jax.jit(jshadows.cascade_matrices, static_argnums=2)(
            jvd, jb.lights[0, 4:7], 2)
        vp = np.asarray(vps[0])
        return jb, pb, flags, vp, (jvd, pvd)
    elif kind in ("spot", "dead_spot"):
        flags = dict(CLUSTER, shadow_resolution=256)
        vps, _, live = jax.jit(jshadows.spot_shadow_matrices,
                               static_argnums=1)(jb.lights, 2)
        slot = 1 if kind == "dead_spot" else 0
        vp = np.asarray(vps[slot])
        assert bool(live[slot]) == (kind != "dead_spot")
    else:
        flags = dict(CLUSTER, shadow_resolution=128)
        vps, _, _ = jax.jit(jshadows.point_cube_matrices,
                            static_argnums=1)(jb.lights, 1)
        vp = np.asarray(vps[0, 3])
    return jb, pb, flags, vp, (jvd, pvd)


def _render_maps(kind):
    jb, pb, flags, vp, views = _map_case(kind)
    jcfg = JConfig(**flags, use_pallas_raster=False)
    pcfg = FrameConfig(**flags)

    def jrender(buf, vd, vp):
        comp = None if views is None else jframe.clod_compact(
            buf, vd, jcfg, JParams.default(), frustum=False,
            max_visible=jcfg.shadow_clusters)
        return jshadows.render_cascade(buf, vp, jcfg, compacted=comp)
    jd = np.asarray(jax.jit(jrender)(jb, None if views is None else views[0],
                                     jnp.asarray(vp)))
    comp = None if views is None else pframe.clod_compact(
        pb, views[1], pcfg, FrameParams.default("cpu"), frustum=False,
        max_visible=pcfg.shadow_clusters)
    pd = pshadows.render_cascade(pb, torch.tensor(vp), pcfg,
                                 compacted=comp).numpy()
    return jd, pd


@pytest.mark.parametrize("kind", ["cascade_soup", "cascade_clusters", "spot",
                                  "cube_face"])
def test_shadow_map_matches_jax(kind):
    jd, pd = _render_maps(kind)
    assert jd.shape == pd.shape
    assert (jd > 0).mean() > 0.05, (jd > 0).mean()
    assert ((jd > 0) == (pd > 0)).mean() >= 0.999
    both = (jd > 0) & (pd > 0)
    np.testing.assert_allclose(pd[both], jd[both], rtol=0, atol=5e-5)


def test_dead_slot_renders_nothing():
    """A spot slot with no light behind it: its view comes from an
    all-zero light row, so every vertex lands at w = 0. Setup, group
    binning and the raster take it without a NaN lane in a live row, the
    map stays empty like the JAX package's, and the slot's sampled term is
    the JAX term (all lit)."""
    jd, pd = _render_maps("dead_spot")
    np.testing.assert_array_equal(pd, jd)
    assert not pd.any()
    _, jvd, pb, pvd = _inputs("spot")
    pcfg = pshadows.shadow_config(FrameConfig(**CLUSTER,
                                              shadow_resolution=256))
    vps, _, live = pshadows.spot_shadow_matrices(pb.lights, 2)
    assert not bool(live[1])
    comp = pframe.clod_compact(pb, pvd, pcfg, FrameParams.default("cpu"),
                               frustum=False, max_visible=16)
    lanes, bbox, valid, _ = psetup.setup_from_compacted(pb, comp, vps[1],
                                                        pcfg)
    assert torch.isfinite(lanes[valid]).all()
    pairs = psetup.bin_clustered(lanes, bbox, valid, pcfg)
    assert int(pairs.overflow) == 0
    depth = np.random.default_rng(5).uniform(0.0, 1.0, (128, 128)) \
        .astype(np.float32)
    jt = np.asarray(jax.jit(jshadows.sample_spot_shadow)(
        jnp.asarray(depth), jvd, jnp.asarray(vps[1].numpy()),
        jnp.asarray(jd), 0.0015))
    pt = pshadows.sample_spot_shadow(torch.tensor(depth), pvd, vps[1],
                                     torch.as_tensor(pd), 0.0015).numpy()
    assert np.isfinite(pt).all()
    np.testing.assert_allclose(pt, jt, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# Sampling, on identical depth, maps and viewprojs
# ---------------------------------------------------------------------------

def _mostly_close(p, j, share=0.999, atol=1e-5):
    close = np.abs(p - j) <= atol
    assert close.mean() >= share, close.mean()


@pytest.fixture(scope="module")
def frame_depths(frames):
    return {n: frames[n][0]["depth"] for n in ("wall_soup", "spot", "point")}


def test_sample_cascades_matches_jax(frame_depths):
    jb, jvd, _, pvd = _inputs("wall")
    vps, _ = jax.jit(jshadows.cascade_matrices, static_argnums=2)(
        jvd, jb.lights[0, 4:7], 3)
    rng = np.random.default_rng(6)
    # Maps: the floor's depth in each cascade with a block cut out, so the
    # receivers meet both lit and shadowed texels.
    maps = rng.uniform(0.2, 0.9, (3, 256, 256)).astype(np.float32)
    maps[:, 64:192, 64:192] = 0.0
    depth = frame_depths["wall_soup"]
    jt = np.asarray(jax.jit(jshadows.sample_shadow_cascades)(
        jnp.asarray(depth), jvd, vps, jnp.asarray(maps), jnp.float32(0.0015)))
    pt = pshadows.sample_shadow_cascades(
        torch.tensor(depth), pvd, torch.tensor(np.asarray(vps)),
        torch.as_tensor(maps), torch.tensor(0.0015)).numpy()
    assert 0.05 < (jt < 0.99).mean() < 0.95
    _mostly_close(pt, jt)


def test_sample_spot_and_point_match_jax(frame_depths):
    rng = np.random.default_rng(7)
    jb, jvd, pb, pvd = _inputs("spot")
    vps, _, _ = jax.jit(jshadows.spot_shadow_matrices, static_argnums=1)(
        jb.lights, 1)
    smap = rng.uniform(0.0, 0.2, (256, 256)).astype(np.float32)
    depth = frame_depths["spot"]
    jt = np.asarray(jax.jit(jshadows.sample_spot_shadow)(
        jnp.asarray(depth), jvd, vps[0], jnp.asarray(smap), 0.0015))
    pt = pshadows.sample_spot_shadow(
        torch.tensor(depth), pvd, torch.tensor(np.asarray(vps[0])),
        torch.as_tensor(smap), 0.0015).numpy()
    assert 0.05 < (jt < 0.99).mean()
    _mostly_close(pt, jt)

    jb, jvd, pb, pvd = _inputs("point")
    cvps, cidx, _ = jax.jit(jshadows.point_cube_matrices, static_argnums=1)(
        jb.lights, 1)
    pos = np.asarray(jb.lights[int(cidx[0]), 0:3])
    maps = rng.uniform(0.0, 0.3, (6, 128, 128)).astype(np.float32)
    depth = frame_depths["point"]
    jt = np.asarray(jax.jit(jshadows.sample_point_shadow)(
        jnp.asarray(depth), jvd, jnp.asarray(pos), cvps[0],
        jnp.asarray(maps)))
    pt = pshadows.sample_point_shadow(
        torch.tensor(depth), pvd, torch.tensor(pos),
        torch.tensor(np.asarray(cvps[0])), torch.as_tensor(maps)).numpy()
    assert 0.05 < (jt < 0.99).mean()
    _mostly_close(pt, jt)


def test_perspective_matches_jax():
    from basicrenderer_tpu.utils import math3d as jm3
    from basicrenderer_tpu_torch.utils import math3d as pm3
    for fov, far in ((0.7, 12.0), (3.0, 0.1), (np.pi / 2 * 1.02, 40.0)):
        j = np.asarray(jax.jit(lambda f, r: jm3.perspective(
            f, 1.0, 0.05, r))(jnp.float32(fov), jnp.float32(far)))
        p = pm3.perspective(torch.tensor(fov, dtype=torch.float32), 1.0,
                            0.05, torch.tensor(far)).numpy()
        np.testing.assert_allclose(p, j, **MATS)
