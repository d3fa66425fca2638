"""Port front end vs the JAX package: vertex transform, triangle setup
(with near-plane clipping) and tile binning.

Tolerances:
- transform_geometry, transform_vertices and clip_near_tris: bit-equal.
  XLA's CPU backend evaluates the JAX einsums as sequential fused chains
  (world fma(m3, 1, fma(m2, z, fma(m1, y, m0*x))), normal
  fma(n2, nz, fma(n1, ny, n0*nx))), the clip lanes as
  fma(m2, z, fma(m0, x, m1*y)) + m3 and the clip lerp as
  fma(t, v - u, u); the port spells the same. Tested at V = 1,003 and
  T = 1,003 as well as on a scene: a power of two can hide a wrong
  contraction.
- triangle_setup_packed: each plane (A, B, C) of a row, evaluated over
  the screen, agrees to |dA|*W + |dB|*H + |dC| <= 2e-4 * (|A|*W + |B|*H
  + |C|) + 1e-7 (the same contraction differences, amplified by the
  1/area normalisation of slivers: up to 5.1e-5 measured); the id,
  material, bbox and pad lanes, the bboxes and the valid masks are equal.
- bin_pairs, fed the JAX package's own lanes: every output exactly equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from basicrenderer_tpu.graph.framedata import FrameConfig as JConfig
from basicrenderer_tpu.graph.framedata import make_view as j_make_view
from basicrenderer_tpu.ops import raster_setup as jrs
from basicrenderer_tpu_torch.graph.framedata import FrameConfig as PConfig
from basicrenderer_tpu_torch.ops import raster_setup as prs

from tests.test_near_clip import _floor_scene
from tests.test_raster import random_clip_triangles
from tests.test_torch_bridge import JAX_PKG, build_scene

PLANE_LANES = ((0, 1, 2), (3, 4, 5), (6, 7, 8), (15, 16, 17), (18, 19, 20),
               (21, 22, 23), (24, 25, 26))
EXACT_LANES = (9, 10, 11, 12, 13, 14, 27, 28, 29, 30, 31)


def _t(x):
    return torch.as_tensor(np.array(x))


def _configs(**kw):
    return JConfig(**kw), PConfig(**kw)


def assert_lanes_close(pl, jl, W, H):
    pl, jl = np.asarray(pl, np.float64), np.asarray(jl, np.float64)
    assert pl.shape == jl.shape
    np.testing.assert_array_equal(pl[:, EXACT_LANES], jl[:, EXACT_LANES])
    for a, b, c in PLANE_LANES:
        err = (np.abs(pl[:, a] - jl[:, a]) * W + np.abs(pl[:, b] - jl[:, b]) * H
               + np.abs(pl[:, c] - jl[:, c]))
        scale = np.abs(jl[:, a]) * W + np.abs(jl[:, b]) * H + np.abs(jl[:, c])
        bad = err > 2e-4 * scale + 1e-7
        assert not bad.any(), (f"plane lanes {a}-{c}: {bad.sum()} rows, worst "
                               f"{(err - 2e-4 * scale).max():.3g}")


def _scene_inputs():
    _, bridge = build_scene(JAX_PKG, "mixed")
    buf = bridge.build_scene_buffers()
    view = np.array([[0.8, 0.0, -0.6, 0.1], [-0.23, 0.92, -0.31, -0.4],
                     [0.55, 0.38, 0.74, -6.5], [0.0, 0.0, 0.0, 1.0]], np.float32)
    from basicrenderer_tpu.utils import math3d
    proj = math3d.np_perspective(1.0, 1.5, 0.1, None)
    return buf, j_make_view(view, proj, np.zeros(3, np.float32))


def test_transform_geometry_matches_jax():
    buf, vd = _scene_inputs()
    j = jax.jit(jrs.transform_geometry)(
        buf.positions, buf.normals, buf.vert_object, buf.object_mats,
        buf.object_normal_mats, vd.viewproj)
    p = prs.transform_geometry(
        _t(buf.positions), _t(buf.normals), _t(buf.vert_object),
        _t(buf.object_mats), _t(buf.object_normal_mats), _t(vd.viewproj))
    for a, b in zip(p, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _random_transform_inputs(seed, V, O):
    rng = np.random.default_rng(seed)
    om = rng.normal(size=(O, 4, 4)).astype(np.float32)
    om[:, 3] = [0, 0, 0, 1]
    return (rng.normal(size=(V, 3)).astype(np.float32) * 3,
            rng.normal(size=(V, 3)).astype(np.float32),
            rng.integers(0, O, V).astype(np.int32), om,
            rng.normal(size=(O, 3, 3)).astype(np.float32),
            rng.normal(size=(4, 4)).astype(np.float32))


@pytest.mark.parametrize("seed,V,O", [(0, 1003, 7), (1, 517, 3), (2, 1024, 5)])
def test_soup_lanes_bit_equal_jax(seed, V, O):
    """World, normal and clip lanes of transform_geometry, and the lanes of
    transform_vertices (the shadow passes' form), equal the jitted JAX
    functions' bit for bit on random matrices."""
    pos, nrm, vo, om, onm, vp = _random_transform_inputs(seed, V, O)
    j = jax.jit(jrs.transform_geometry)(pos, nrm, vo, om, onm, vp)
    p = prs.transform_geometry(_t(pos), _t(nrm), _t(vo), _t(om), _t(onm),
                               _t(vp))
    for name, a, b in zip(("clip", "world", "normal"), p, j):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        bad = (a.numpy() != b).sum(axis=0)
        assert not bad.any(), f"{name} lanes differ on {bad} vertices"
    jv = jax.jit(jrs.transform_vertices)(pos, vo, om, vp)
    pv = prs.transform_vertices(_t(pos), _t(vo), _t(om), _t(vp))
    for a, b in zip(pv, jv):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("seed,T,cap", [(1, 1003, 301), (2, 517, 600)])
def test_clip_near_rows_bit_equal_jax(seed, T, cap):
    """clip_near_tris on random corner rows (about two thirds cross the
    w = eps plane): the clipped corner rows, the valid mask, the source
    ids and the overflow equal the jitted JAX function's bit for bit."""
    rng = np.random.default_rng(seed)
    g = [rng.normal(size=(T, 9)).astype(np.float32) for _ in range(3)]
    valid = rng.random(T) < 0.9
    j = jax.jit(lambda a, b, c, v: jrs.clip_near_tris(a, b, c, v, cap))(
        *g, valid)
    p = prs.clip_near_tris(_t(g[0]), _t(g[1]), _t(g[2]), _t(valid), cap)
    assert int(np.asarray(j[3]).sum()) > cap // 2
    for name, a, b in zip(("h0", "h1", "h2", "valid", "src", "overflow"),
                          p, j):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def test_setup_packed_matches_jax_scene():
    """The soup setup of a lit scene with normals, uvs, materials and
    objects, with near clipping on (the default budget)."""
    buf, vd = _scene_inputs()
    jc, pc = _configs(width=192, height=128, tile_h=16, tile_w=128)
    clip, _, wn = jax.jit(jrs.transform_geometry)(
        buf.positions, buf.normals, buf.vert_object, buf.object_mats,
        buf.object_normal_mats, vd.viewproj)
    tri_valid = buf.tri_object >= 0
    jl, jb, jv, jo = jax.jit(lambda c, n: jrs.triangle_setup_packed(
        c, buf.indices, tri_valid, jc, n, buf.uvs, buf.tri_material,
        buf.tri_object))(clip, wn)
    pl, pb, pv, po = prs.triangle_setup_packed(
        _t(clip), _t(buf.indices), _t(tri_valid), pc, _t(wn), _t(buf.uvs),
        _t(buf.tri_material), _t(buf.tri_object))
    assert int(np.asarray(jv).sum()) > 100
    assert_lanes_close(pl.numpy(), jl, 192, 128)
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    assert int(po) == int(jo)


@pytest.mark.parametrize("near_clip_tris", [0, 64])
def test_setup_packed_matches_jax_near_clip(near_clip_tris):
    """The floor quad of tests/test_near_clip.py, whose near corners lie
    behind the camera: without clipping both triangles drop; with it the
    clipped rows are appended after the soup."""
    from basicrenderer_tpu.utils import math3d
    verts, tris = _floor_scene()
    W, H = 128, 64
    kw = dict(width=W, height=H, tile_h=32, tile_w=128, max_pairs=1 << 10,
              max_tiles_per_tri=4, max_big_tris=128,
              near_clip_tris=near_clip_tris, use_pallas_raster=False)
    jc, pc = _configs(**kw)
    view = math3d.np_look_at(np.array([0.0, 0.5, 0.0]), np.array([0.0, 0.0, -5.0]),
                             np.array([0.0, 1.0, 0.0]))
    proj = math3d.np_perspective(1.2, W / H, 0.1, None)
    vd = j_make_view(view, proj, np.array([0.0, 0.5, 0.0]))
    clip = (np.concatenate([verts, np.ones((4, 1), np.float32)], 1)
            @ np.asarray(vd.viewproj).T).astype(np.float32)
    valid = np.array([True, True])
    jl, jb, jv, jo = jax.jit(lambda c, t, v: jrs.triangle_setup_packed(
        c, t, v, jc, None, None, None))(clip, tris, valid)
    pl, pb, pv, po = prs.triangle_setup_packed(
        _t(clip), _t(tris), _t(valid), pc, None, None, None)
    assert_lanes_close(pl.numpy(), jl, W, H)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pb.numpy()[pv.numpy()],
                                  np.asarray(jb)[np.asarray(jv)])
    if near_clip_tris:
        assert int(pv.sum()) >= 2
    # The binned result of the JAX setup and the port's is the same.
    jpairs = jax.jit(lambda *a: jrs.bin_pairs(*a, jc))(jl, jb, jv)
    ppairs = prs.bin_pairs(pl, pb, pv, pc)
    np.testing.assert_array_equal(ppairs.tile_offsets.numpy(),
                                  np.asarray(jpairs.tile_offsets))


def _jax_setup(seed, n, jc):
    from tests.test_raster import setup_from_clip
    rng = np.random.default_rng(seed)
    setup = setup_from_clip(random_clip_triangles(rng, n), jc)
    return jrs.pack_setup_lanes(setup), setup.bbox, setup.valid


@pytest.mark.parametrize("case", ["plain", "big_list", "overflow"])
def test_bin_pairs_matches_jax(case):
    """Given the JAX package's own lanes, every BinnedPairs field matches.
    'big_list' routes most triangles through the global list
    (max_tiles_per_tri=2); 'overflow' exceeds both capacities."""
    kw = dict(width=256, height=128, tile_h=16, tile_w=128, max_pairs=1 << 12)
    if case == "big_list":
        kw.update(max_tiles_per_tri=2)
    elif case == "overflow":
        kw.update(max_pairs=8, max_tiles_per_tri=2, max_big_tris=4)
    jc, pc = _configs(**kw)
    lanes, bbox, valid = _jax_setup(3, 40, jc)
    j = jax.jit(lambda *a: jrs.bin_pairs(*a, jc))(lanes, bbox, valid)
    p = prs.bin_pairs(_t(lanes), _t(bbox), _t(valid), pc)
    for f in j._fields:
        np.testing.assert_array_equal(getattr(p, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    if case == "big_list":
        assert int(p.big_count) > 0
    if case == "overflow":
        assert int(p.overflow) > 0


def test_bin_slot_integer_division_matches_float_reciprocal():
    """The JAX binning finds slot k's row in a span as
    floor((k + 0.5) * (1/spanx)) in f32; the port divides integers. The
    two agree for every span up to 8192 tiles and every slot below 64
    (the default max_tiles_per_tri is 32)."""
    ks = np.arange(64, dtype=np.float32)[None, :]
    spans = np.arange(1, 8193, dtype=np.int32)[:, None]
    inv = np.float32(1.0) / spans.astype(np.float32)
    ky_float = np.floor((ks + np.float32(0.5)) * inv).astype(np.int32)
    ky_int = np.arange(64, dtype=np.int32)[None, :] // spans
    np.testing.assert_array_equal(ky_float, ky_int)


def test_oct_encode_matches_jax():
    rng = np.random.default_rng(4)
    n = rng.normal(size=(500, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    j = jrs.oct_encode_cols(*(jnp.asarray(n[:, i]) for i in range(3)))
    p = prs.oct_encode_cols(*(_t(n[:, i]) for i in range(3)))
    for a, b in zip(p, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_setup_fma_is_one_rounding():
    """raster_setup.fma rounds a * b + c once, as XLA's CPU backend's
    contracted multiply-adds do: equal to the f64-emulated fused form on
    every length (vector bodies and scalar tails) and with broadcast
    scalars, and different from the two-rounding form somewhere."""
    from basicrenderer_tpu_torch.ops.raster import fma32
    rng = np.random.default_rng(31)
    two = 0
    for n in (1, 7, 33, 1000, 4099):
        a, b, c = (torch.as_tensor(rng.normal(size=n).astype(np.float32) * k)
                   for k in (1.0, 100.0, 50.0))
        assert torch.equal(prs.fma(a, b, c), fma32(a, b, c))
        assert torch.equal(prs.fma(a, 2.0 / 255.0, -1.0),
                           fma32(a, torch.tensor(2.0 / 255.0),
                                 torch.tensor(-1.0)))
        two += int((prs.fma(a, b, c) != a * b + c).sum())
    assert two > 0


def test_clustered_setup_lanes_equal_jax():
    """The cluster-page setup of the 512x512 rig (tests/test_goldens_512.py
    through tests/test_torch_cluster_frame.build_rig) at 192x120 (neither
    side a power of two, so every product by the frame size rounds) from
    the same compacted slots: the edge, depth and uv planes and every
    integer lane bit for bit equal to the JAX package's (the port spells
    XLA's contracted multiply-adds); the octahedral normal planes, which
    go through XLA's rsqrt, within the plane tolerance."""
    from basicrenderer_tpu.ops import clod as jclod
    from basicrenderer_tpu_torch.graph import frame as pframe
    from basicrenderer_tpu_torch.graph.framedata import FrameParams
    from basicrenderer_tpu_torch.graph.framedata import make_view as p_make_view
    from tests.test_torch_cluster_frame import JAX_PKG as J, PORT_PKG as P
    from tests.test_torch_cluster_frame import build_rig
    (jsc, jb), (psc, pb) = build_rig(J), build_rig(P)
    kw = dict(width=192, height=120, tile_h=16, tile_w=128,
              max_pairs=1 << 15, enable_clod=True, max_visible_clusters=256)
    jc, pc = _configs(**kw)
    jbuf, pbuf = jb.build_scene_buffers(), pb.build_scene_buffers(device="cpu")
    cams = psc.camera_matrices(aspect=1.6)
    pview, jview = p_make_view(*cams, device="cpu"), j_make_view(*cams)
    comp = pframe.clod_compact(pbuf, pview, pc, FrameParams.default("cpu"))
    jcomp = jclod.CompactedTris(**{f: jnp.asarray(getattr(comp, f).numpy())
                                   for f in comp._fields})
    jl, _, jv, _ = jax.jit(lambda s, c, vp: jrs.setup_from_compacted(
        s, c, vp, jc))(jbuf, jcomp, jview.viewproj)
    pl, _, pv, _ = prs.setup_from_compacted(pbuf, comp, pview.viewproj, pc)
    jl, pl = np.asarray(jl), pl.numpy()
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    assert int(pv.sum()) > 150
    exact = list(range(0, 15)) + list(range(21, 32))
    live = pv.numpy()       # dead rows' planes are never read
    np.testing.assert_array_equal(pl[live][:, exact], jl[live][:, exact])
    assert_lanes_close(pl, jl, 192, 120)
