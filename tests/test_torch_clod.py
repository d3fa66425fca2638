"""Port cluster-LOD path vs the JAX package: the cluster builder, the LOD
cut and visible-cluster compaction, the setup from cluster pages, the HZB
and its occlusion test, and the courtyard scene with textures and LOD.

Tolerances:
- build_cluster_lod, the packed cluster pages, the cut, the compaction,
  the HZB, the occlusion verdicts and downsample2d: exactly equal (integer
  data, or the same f32 operations);
- slot_world_spheres, project_sphere_bounds: allclose at rtol 1e-6,
  atol 1e-6 (XLA's CPU backend contracts column sums into fused
  multiply-adds);
- triangle_setup_clustered: the planes of live rows within the bound of
  tests/test_torch_raster_setup.py (|dA|*W + |dB|*H + |dC| <= 2e-4 *
  (|A|*W + |B|*H + |C|) + 1e-7), except slivers
  whose barycentric slope exceeds 8 per pixel (12 of 272 live rows; the
  1/area normalisation turns the transforms' ulp differences into ~3e-3
  relative plane differences there, on triangles of ~0.01 px^2), and the
  octahedral normal planes need only hold on 95% of rows (a normal on the
  octahedral fold, z ~ 0, encodes on either side of it from one ulp);
  ids, boxes and validity equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from basicrenderer_tpu.graph import frame as jframe
from basicrenderer_tpu.graph.framedata import FrameConfig as JConfig
from basicrenderer_tpu.graph.framedata import FrameParams as JParams
from basicrenderer_tpu.graph.framedata import make_view as j_make_view
from basicrenderer_tpu.ops import clod as jclod
from basicrenderer_tpu.ops import culling as jcull
from basicrenderer_tpu.ops import raster_setup as jrs
from basicrenderer_tpu.ops.shadows import downsample2d as j_downsample2d
from basicrenderer_tpu_torch import interop
from basicrenderer_tpu_torch.graph import frame as pframe
from basicrenderer_tpu_torch.graph.framedata import FrameConfig as PConfig
from basicrenderer_tpu_torch.graph.framedata import FrameParams as PParams
from basicrenderer_tpu_torch.ops import clod as pclod
from basicrenderer_tpu_torch.ops import culling as pcull
from basicrenderer_tpu_torch.ops import raster_setup as prs
from basicrenderer_tpu_torch.ops.shadows import downsample2d

from tests.test_torch_bridge import assert_field_equal
from tests.test_torch_cluster_frame import (BASE, JAX_PKG, build_rig,
                                            wait_for_jax_native)
from tests.test_torch_raster_setup import EXACT_LANES

PLANE_LANES = ((0, 1, 2), (3, 4, 5), (6, 7, 8), (15, 16, 17), (18, 19, 20))


def _fields(x):
    import dataclasses
    if hasattr(x, "_fields"):
        return {f: np.asarray(getattr(x, f)) for f in x._fields}
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x)}


@pytest.fixture(scope="module")
def rig():
    """The cluster rig in both packages, the port's buffers carried across
    from the JAX package's so that every op sees identical inputs."""
    sc, bridge = build_rig(JAX_PKG)
    jbuf = bridge.build_scene_buffers()
    jvd = j_make_view(*sc.camera_matrices(aspect=1.0))
    return dict(jbuf=jbuf, jvd=jvd, jc=JConfig(**BASE), pc=PConfig(**BASE),
                pbuf=interop.scene_buffers(_fields(jbuf), device="cpu"),
                pvd=interop.view_data(_fields(jvd), device="cpu"))


@pytest.mark.parametrize("shape", ["sphere", "torus"])
def test_cluster_builder_matches_jax(shape):
    from basicrenderer_tpu.models import clusters as jcl, procedural as jp
    from basicrenderer_tpu_torch.models import clusters as pcl, procedural as pp
    make = {"sphere": lambda m: m.make_uv_sphere(0.8, rings=24, sectors=48),
            "torus": lambda m: m.make_torus(0.5, 0.2, rings=24, sides=12)}[shape]
    wait_for_jax_native()
    j = jcl.build_cluster_lod(make(jp), use_cache=False)
    p = pcl.build_cluster_lod(make(pp), use_cache=False)
    for f in ("positions", "normals", "uvs", "indices", "tri_cluster",
              "clusters", "feeds_group", "made_group"):
        np.testing.assert_array_equal(getattr(p, f), getattr(j, f), err_msg=f)
    assert p.num_levels == j.num_levels > 1
    assert (pcl.CLUSTER_STRIDE, pcl.MESHLET_TRIS, pcl.SLAB_VERTS) == (
        jcl.CLUSTER_STRIDE, jcl.MESHLET_TRIS, jcl.SLAB_VERTS)


def test_courtyard_scene_buffers_match_jax(tmp_path, monkeypatch):
    """build_courtyard with LOD meshes and a texture set packs to the same
    buffers in both packages (cluster pages, windows, strip atlas, material
    texture lanes). The JAX package builds its DAGs afresh, into an empty
    cache, with its native library loaded."""
    from basicrenderer_tpu.models import clusters as jcl
    monkeypatch.setattr(jcl, "CACHE_DIR", str(tmp_path))
    wait_for_jax_native()
    from basicrenderer_tpu.models import scenes as js
    from basicrenderer_tpu.models.textures import TextureRegistry as JTex
    from basicrenderer_tpu.scene import bridge as jb
    from basicrenderer_tpu_torch.graph.framedata import SceneBuffers
    from basicrenderer_tpu_torch.models import scenes as ps
    from basicrenderer_tpu_torch.models.textures import TextureRegistry as PTex
    from basicrenderer_tpu_torch.scene import bridge as pb
    bufs = []
    for scenes, Tex, br, kw in ((js, JTex, jb, {}), (ps, PTex, pb,
                                                    {"device": "cpu"})):
        tex = Tex(resolution=32)
        built = scenes.build_courtyard(grid=3, lod=True, textures=tex,
                                       num_point_lights=6)
        caps = br.BridgeCapacities(max_vertices=1 << 16, max_triangles=1 << 16,
                                   max_objects=16, max_materials=16,
                                   max_lights=16, max_clusters=1 << 10,
                                   max_geom_clusters=1 << 9,
                                   max_groups=1 << 8)
        bufs.append(br.SceneRenderBridge(built.scene, built.meshes,
                                         built.materials, caps,
                                         textures=tex).build_scene_buffers(**kw))
    jbuf, pbuf = bufs
    for f in SceneBuffers.__dataclass_fields__:
        assert_field_equal(getattr(pbuf, f), getattr(jbuf, f), f)
    assert int(pbuf.num_clusters) > 9 and pbuf.tex_flags.shape[0] == 3


@pytest.fixture(scope="module")
def compacted(rig):
    r = rig
    jcut = jframe.clod_cut(r["jbuf"], r["jvd"], r["jc"], JParams.default())
    pcut = pframe.clod_cut(r["pbuf"], r["pvd"], r["pc"], PParams.default("cpu"))
    jcomp = jclod.compact_visible_tris(r["jbuf"], jcut, 64)
    pcomp = pclod.compact_visible_tris(r["pbuf"], pcut, 64)
    return jcut, pcut, jcomp, pcomp


def test_cluster_cut_matches_jax(rig, compacted):
    jcut, pcut, _, _ = compacted
    np.testing.assert_array_equal(pcut.numpy(), np.asarray(jcut))
    assert 4 < int(pcut.sum()) < int(rig["pbuf"].num_clusters)
    j = jclod.select_cluster_cut(rig["jbuf"], rig["jvd"], rig["jc"],
                                 jnp.float32(4.0), frustum=False)
    p = pclod.select_cluster_cut(rig["pbuf"], rig["pvd"], rig["pc"],
                                 torch.tensor(4.0), frustum=False)
    np.testing.assert_array_equal(p[0].numpy(), np.asarray(j[0]))
    assert int(p[1]) == int(j[1])


def test_compaction_matches_jax(compacted):
    _, _, jcomp, pcomp = compacted
    for f in jclod.CompactedTris._fields:
        np.testing.assert_array_equal(getattr(pcomp, f).numpy(),
                                      np.asarray(getattr(jcomp, f)), err_msg=f)
    assert int(pcomp.overflow) == 0 and int(pcomp.valid.sum()) > 500


def test_compaction_overflow_matches_jax(rig, compacted):
    jcut, pcut, _, _ = compacted
    j = jclod.compact_visible_tris(rig["jbuf"], jcut, 3)
    p = pclod.compact_visible_tris(rig["pbuf"], pcut, 3)
    assert int(p.overflow) == int(j.overflow) > 0
    np.testing.assert_array_equal(p.slot_cluster.numpy(),
                                  np.asarray(j.slot_cluster))


def test_slot_world_spheres_match_jax(rig, compacted):
    _, _, jcomp, pcomp = compacted
    jc, jr = jclod.slot_world_spheres(jcomp, rig["jbuf"])
    pc, pr = pclod.slot_world_spheres(pcomp, rig["pbuf"])
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=1e-6, atol=1e-6)


def test_setup_from_compacted_matches_jax(rig, compacted):
    _, _, jcomp, _ = compacted
    pcomp = pclod.CompactedTris(**{
        k: torch.as_tensor(np.array(v)) for k, v in _fields(jcomp).items()})
    jl, jb, jv, jo = jax.jit(lambda b, c, vp: jrs.setup_from_compacted(
        b, c, vp, rig["jc"]))(rig["jbuf"], jcomp, rig["jvd"].viewproj)
    pl, pb, pv, po = prs.setup_from_compacted(rig["pbuf"], pcomp,
                                              rig["pvd"].viewproj, rig["pc"])
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pl.numpy()[:, 9], np.asarray(jl)[:, 9])
    # Rows that fail setup carry id 0 and are never rasterized; their planes
    # (off-screen or w ~ 0 corners) are not compared. Neither are slivers
    # narrower than 1/8 px, where the 1/area normalisation amplifies the
    # transforms' last-ulp differences (a few rows; see the docstring).
    jl = np.asarray(jl)
    slope = np.abs(jl[:, [0, 1, 3, 4]]).max(axis=1)
    live = np.asarray(jv) & (slope <= 8.0)
    assert (np.asarray(jv) & ~live).sum() <= 0.1 * np.asarray(jv).sum()
    pl, jl = pl.numpy()[live].astype(np.float64), jl[live].astype(np.float64)
    np.testing.assert_array_equal(pl[:, EXACT_LANES], jl[:, EXACT_LANES])
    for a, b, c in PLANE_LANES + ((21, 22, 23), (24, 25, 26)):
        err = (np.abs(pl[:, a] - jl[:, a]) * 128 + np.abs(pl[:, b] - jl[:, b])
               * 128 + np.abs(pl[:, c] - jl[:, c]))
        scale = (np.abs(jl[:, a]) * 128 + np.abs(jl[:, b]) * 128
                 + np.abs(jl[:, c]))
        close = err <= 2e-4 * scale + 1e-7
        # Octahedral normal planes (15-20) jump where a world normal sits
        # on the fold (z ~ 0) and the two packages round it to opposite
        # signs; UV planes (21-26) do not.
        assert close.mean() >= (0.95 if a in (15, 18) else 1.0), (
            a, close.mean())
    np.testing.assert_array_equal(pb.numpy()[pv.numpy()],
                                  np.asarray(jb)[np.asarray(jv)])
    assert int(po) == int(jo) and int(pv.sum()) > 100


@pytest.fixture(scope="module")
def hzb_inputs(rig, compacted):
    rng = np.random.default_rng(2)
    depth = rng.uniform(0.0, 1.0, (128, 128)).astype(np.float32)
    depth[40:90, 30:100] = 0.9                  # a near occluder
    _, _, jcomp, pcomp = compacted
    jc, jr = jclod.slot_world_spheres(jcomp, rig["jbuf"])
    return depth, jc, jr


def test_build_hzb_matches_jax(hzb_inputs):
    depth = hzb_inputs[0]
    for d in (depth, depth[:, :100], depth[:127]):
        j = jcull.build_hzb(jnp.asarray(d), 8)
        p = pcull.build_hzb(torch.as_tensor(np.array(d)), 8)
        assert len(p) == len(j) == 8
        for a, b in zip(p, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_occlusion_test_matches_jax(rig, hzb_inputs):
    depth, jc, jr = hzb_inputs
    vp = rig["jvd"].viewproj
    jb, jz, jbh = jcull.project_sphere_bounds(vp, jc, jr, 128, 128)
    pb, pz, pbh = pcull.project_sphere_bounds(
        rig["pvd"].viewproj, torch.as_tensor(np.array(jc)),
        torch.as_tensor(np.array(jr)), 128, 128)
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(pz.numpy(), np.asarray(jz), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(pbh.numpy(), np.asarray(jbh))
    # Same bounds into both tests: verdicts equal, and some slots occluded.
    jh = jcull.build_hzb(jnp.asarray(depth), 8)
    ph = pcull.build_hzb(torch.as_tensor(depth), 8)
    jvis = np.asarray(jcull.occlusion_test_hzb(jh, jb, jz, jbh, 128, 128))
    pvis = pcull.occlusion_test_hzb(ph, torch.as_tensor(np.array(jb)),
                                    torch.as_tensor(np.array(jz)),
                                    torch.as_tensor(np.array(jbh)), 128, 128)
    np.testing.assert_array_equal(pvis.numpy(), jvis)
    assert jvis.any() and not jvis.all()


@pytest.mark.parametrize("ds", [1, 2, 4])
def test_downsample2d_matches_jax(ds):
    x = np.random.default_rng(ds).normal(size=(64, 96)).astype(np.float32)
    np.testing.assert_array_equal(downsample2d(torch.as_tensor(x), ds).numpy(),
                                  np.asarray(j_downsample2d(jnp.asarray(x), ds)))


def test_unported_cluster_options_raise(rig):
    """Every cluster option of the JAX frame builds in the port now: the
    windowed cut, the masked peels with OIT, the soup frame's occlusion,
    the full-rate mask pass and texture streaming."""
    import dataclasses
    pframe.build_frame_fn(dataclasses.replace(rig["pc"], cut_windows=4))
    pframe.build_frame_fn(dataclasses.replace(
        rig["pc"], enable_alpha_mask=True, mask_peels=2, enable_oit=True))
    pframe.build_frame_fn(dataclasses.replace(rig["pc"], enable_clod=False,
                                              enable_occlusion=True))
    pframe.build_frame_fn(dataclasses.replace(
        rig["pc"], enable_alpha_mask=True, texture_downscale=1))
    pframe.build_frame_fn(dataclasses.replace(
        rig["pc"], enable_alpha_mask=True, enable_textures=True,
        enable_texture_streaming=True))
