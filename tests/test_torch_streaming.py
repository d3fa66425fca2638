"""Geometry streaming: the port against the JAX package on the CPU.

Mirrors tests/test_streaming.py, tests/test_streaming_integration.py and
tests/test_pageblob.py. Scene: two instances of a cluster-LOD sphere
(rings 48, sectors 96: 39 streaming groups), each package building it
from its own modules; frames at 128x128 with tile_h=16.

Tolerances:
- page-blob containers: byte-equal files, and each package opens the
  other's;
- GeometryStreamer over 8 synchronous ticks fed the same `touched`
  priorities: geom_slot, resident, loads, evictions and both slabs
  bit-equal (from the packed arrays, and from a container with each IO
  worker drained between ticks);
- touched_groups: bit-equal for streaming_priority "max" (scatter amax is
  order-free); "sum" adds in another order: within rtol 1e-6;
- the windowed cut (cut_windows 1, 2, 8): the same slots and overflow;
- a frame with the finest resident groups dropped (the JAX package's
  test_missing_group_coarsens_without_holes): vis equal on >= 99.9% of
  pixels, image RMSE <= 1.0 on the 0-255 scale, no holes.
"""

import dataclasses
import importlib
import time
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

JAX_PKG = "basicrenderer_tpu"
PORT_PKG = "basicrenderer_tpu_torch"
CFG_KW = dict(width=128, height=128, tile_h=16, tile_w=128,
              max_pairs=1 << 14, enable_clod=True, max_visible_clusters=512)
TICKS = 8
SUM_RTOL = 1e-6


def _pkg(root):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(
        procedural=mod("models.procedural"), clusters=mod("models.clusters"),
        materials=mod("models.materials"), mesh=mod("models.mesh"),
        bridge=mod("scene.bridge"), scene=mod("scene.scene"),
        streaming=mod("models.streaming"), pageblob=mod("models.pageblob"),
        frame=mod("graph.frame"), fd=mod("graph.framedata"),
        clod=mod("ops.clod"))


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float32)
                                  - np.asarray(b, np.float32)) ** 2)))


def build(root):
    """(modules, scene, bridge) of the two-sphere LOD scene."""
    m = _pkg(root)
    lod = m.clusters.build_cluster_lod(
        m.procedural.make_uv_sphere(1.0, rings=48, sectors=96),
        use_cache=False)
    meshes, mats = m.mesh.MeshRegistry(), m.materials.MaterialRegistry()
    mid = meshes.add(m.clusters.to_mesh_data(lod))
    sc = m.scene.Scene()
    sc.create_renderable(mid, 0)
    sc.create_renderable(mid, 0, position=(2.5, 0.0, -2.0))
    sc.create_directional_light(direction=(-0.3, -1, -0.2), intensity=3.0)
    sc.set_camera(position=(0, 0.4, 3.0), target=(0, 0, 0), aspect=1.0)
    sc.propagate_transforms()
    caps = m.bridge.BridgeCapacities(
        max_vertices=1 << 16, max_triangles=1 << 16, max_objects=8,
        max_materials=4, max_lights=4, max_clusters=1 << 12,
        max_geom_clusters=1 << 10, max_groups=1 << 10)
    bridge = m.bridge.SceneRenderBridge(sc, meshes, mats, caps)
    bridge.pack_geometry()
    return m, sc, bridge


@pytest.fixture(scope="module")
def rig():
    jm, jsc, jb = build(JAX_PKG)
    pm, psc, pb = build(PORT_PKG)
    view = jsc.camera_matrices(aspect=1.0)
    return SimpleNamespace(
        jm=jm, jb=jb, jbuf=jb.build_scene_buffers(),
        jv=jm.fd.make_view(*view), pm=pm, pb=pb,
        pbuf=pb.build_scene_buffers(device="cpu"),
        pv=pm.fd.make_view(*view, device="cpu"))


def test_packed_streaming_fields_match_jax(rig):
    jp, pp = rig.jb.packed, rig.pb.packed
    for f in ("cluster_verts", "cluster_dequant", "geom_group",
              "cluster_feeds", "cluster_made"):
        np.testing.assert_array_equal(getattr(pp, f), getattr(jp, f),
                                      err_msg=f)
    assert pp.num_groups == jp.num_groups == 39


def test_page_containers_cross_open(rig, tmp_path):
    """A container the JAX package writes opens in the port and the
    reverse; both writers produce the same bytes."""
    jpath, ppath = str(tmp_path / "j.brpb"), str(tmp_path / "p.brpb")
    rig.jb.save_page_container(jpath)
    rig.pb.save_page_container(ppath)
    with open(jpath, "rb") as fj, open(ppath, "rb") as fp:
        assert fj.read() == fp.read()
    jc = rig.jm.pageblob.PageBlobContainer(ppath)
    pc = rig.pm.pageblob.PageBlobContainer(jpath)
    assert pc.header == rig.pm.pageblob.PageBlobHeader(**vars(jc.header))
    np.testing.assert_array_equal(pc.geom_group, jc.geom_group)
    np.testing.assert_array_equal(pc.dequant, jc.dequant)
    np.testing.assert_array_equal(pc.locators, jc.locators)
    assert sorted(pc.group_pages) == sorted(jc.group_pages)
    for g in pc.group_pages:
        np.testing.assert_array_equal(pc.group_pages[g], jc.group_pages[g])
    for page in range(0, pc.header.num_pages, 97):
        np.testing.assert_array_equal(pc.read_page(page), jc.read_page(page))
        np.testing.assert_array_equal(
            rig.pm.pageblob.dequantize_page_np(pc.read_page(page),
                                               pc.dequant[page], 384),
            rig.jm.pageblob.dequantize_page_np(jc.read_page(page),
                                               jc.dequant[page], 384))


def _touched(seed, num_groups, cap):
    rng = np.random.default_rng(seed)
    t = np.zeros(cap, np.float32)
    live = rng.random(num_groups) < 0.3
    t[:num_groups] = np.where(live, rng.random(num_groups) * 4.0, 0.0)
    return t


def _record_requests(st):
    """Record the groups the streamer asks its IO worker to read."""
    asked = []
    request = st._io.request

    def recording(key, priority=0.0):
        asked.append(key)
        request(key, priority)
    st._io.request = recording
    return asked


def _drain(st, asked):
    """Wait until every group the streamer asked for in this tick is
    staged, so the next tick sees the same staged set in both packages
    (nothing consumes or evicts between two ticks)."""
    for _ in range(1000):
        if all(k in st._staged for k in asked):
            asked.clear()
            return
        time.sleep(0.005)
    raise TimeoutError("IO worker did not stage its requests")


def _assert_same_tick(tick, j, p, jst, pst):
    jv, jdq, jslot, jres = (np.asarray(x) for x in j)
    pv, pdq, pslot, pres = (x.numpy() for x in p)
    np.testing.assert_array_equal(pv, jv.view(np.int32),
                                  err_msg=f"tick {tick}")
    np.testing.assert_array_equal(pdq, jdq, err_msg=f"tick {tick}")
    np.testing.assert_array_equal(pslot, jslot, err_msg=f"tick {tick}")
    np.testing.assert_array_equal(pres, jres, err_msg=f"tick {tick}")
    np.testing.assert_array_equal(pst.geom_slot, jst.geom_slot)
    np.testing.assert_array_equal(pst.resident, jst.resident)
    assert (pst.loads, pst.evictions) == (jst.loads, jst.evictions), tick


@pytest.mark.parametrize("source", ["packed", "container"])
def test_streamer_ticks_match_jax(rig, tmp_path, source):
    """8 synchronous ticks fed the same seeded touched priorities into a
    slab too small for the wanted set (so the LRU evicts)."""
    GR = rig.jb.caps.max_groups
    slots = 80
    if source == "packed":
        jst = rig.jm.streaming.GeometryStreamer(rig.jb.packed, GR, slots,
                                                loads_per_update=6)
        pst = rig.pm.streaming.GeometryStreamer(rig.pb.packed, GR, slots,
                                                loads_per_update=6,
                                                device="cpu")
    else:
        path = str(tmp_path / "scene.brpb")
        rig.jb.save_page_container(path)
        jst = rig.jm.streaming.GeometryStreamer(
            max_groups=GR, num_slots=slots, loads_per_update=6,
            container=rig.jm.pageblob.PageBlobContainer(path))
        pst = rig.pm.streaming.GeometryStreamer(
            max_groups=GR, num_slots=slots, loads_per_update=6,
            container=rig.pm.pageblob.PageBlobContainer(path), device="cpu")
    asked = ([_record_requests(st) for st in (jst, pst)]
             if source == "container" else None)
    try:
        for tick in range(TICKS):
            t = _touched(tick, rig.jb.packed.num_groups, GR)
            j, p = jst.update(t), pst.update(t)
            _assert_same_tick(tick, j, p, jst, pst)
            if asked:
                _drain(jst, asked[0])
                _drain(pst, asked[1])
        assert pst.loads > 0
        if source == "packed":
            assert pst.evictions > 0
    finally:
        jst.stop()
        pst.stop()


def test_streamer_parent_chain_closure():
    """tests/test_streaming.py's synthetic 3-level chain through the port:
    a wanted fine group pulls its ancestors in first, and eviction is
    leaf-first."""
    from basicrenderer_tpu_torch.models.streaming import GeometryStreamer
    G = 3
    packed = SimpleNamespace(
        cluster_verts=np.arange(G * 8, dtype=np.uint32).reshape(G, 8),
        cluster_dequant=np.zeros((G, 8), np.float32),
        geom_group=np.arange(G, dtype=np.int32),
        cluster_feeds=np.array([0, 1, 2, -1], np.int32),
        cluster_made=np.array([-1, 0, 1, 2], np.int32))
    st = GeometryStreamer(packed, max_groups=G, num_slots=G,
                          loads_per_update=16, device="cpu")
    assert st.group_parents[0] == [1] and st.group_parents[1] == [2]
    touched = np.zeros(G, bool)
    touched[0] = True
    st.update(touched)
    assert st.resident[[0, 1, 2]].all()
    assert st._evict_one(protect=-1)
    assert not st.resident[0] and st.resident[1] and st.resident[2]
    assert st._evict_one(protect=-1)
    assert not st.resident[1] and st.resident[2]


def test_streamer_priority_order():
    """With a 1-load budget the most oversized group streams first, and a
    parent inherits its child's priority (chain first)."""
    from basicrenderer_tpu_torch.models.streaming import GeometryStreamer
    G = 3
    packed = SimpleNamespace(
        cluster_verts=np.arange(G * 8, dtype=np.uint32).reshape(G, 8),
        cluster_dequant=np.zeros((G, 8), np.float32),
        geom_group=np.arange(G, dtype=np.int32),
        cluster_feeds=np.array([0, 1, 2], np.int32),
        cluster_made=np.array([-1, 0, -1], np.int32))
    st = GeometryStreamer(packed, max_groups=G, num_slots=G,
                          loads_per_update=1, device="cpu")
    st.update(np.array([1.5, 0.0, 9.0], np.float32))
    assert st.resident[2] and not st.resident[0] and not st.resident[1]
    pri = np.array([9.0, 0.0, 1.0], np.float32)
    st.update(pri)
    assert st.resident[1] and not st.resident[0]
    st.update(pri)
    assert st.resident[0]


def test_page_pool_and_worker():
    """PagePool residency, LRU and padding, and the StreamingWorker's
    async loads (tests/test_streaming.py) on CPU tensors."""
    from basicrenderer_tpu_torch.models.streaming import (PagePool,
                                                          StreamingWorker)

    def page(key, rows=4, lanes=4):
        return np.full((rows, lanes), float(key), np.float32)

    pool = PagePool(num_pages=2, page_rows=4, row_lanes=4, device="cpu")
    pool.upload(1, page(1))
    time.sleep(0.01)
    s2 = pool.upload(2, page(2, rows=3))
    assert (pool.slab[s2 * 4:s2 * 4 + 3] == 2.0).all()
    assert (pool.slab[s2 * 4 + 3] == 0.0).all()
    time.sleep(0.01)
    pool.touch(1)
    time.sleep(0.01)
    pool.upload(3, page(3))
    assert pool.is_resident(1) and pool.is_resident(3)
    assert not pool.is_resident(2)
    assert pool.slot_table(4)[2] == -1
    assert pool.residency_mask(4).tolist() == [False, True, False, True]

    pool = PagePool(num_pages=8, page_rows=4, row_lanes=4, device="cpu")
    w = StreamingWorker(pool, page, budget_per_tick=4)
    for k, prio in [(3, 0.5), (1, 0.1), (7, 0.9)]:
        w.request(k, prio)
    deadline = time.time() + 5
    done = []
    while len(done) < 3 and time.time() < deadline:
        done += w.drain_completed()
        time.sleep(0.01)
    w.stop()
    assert sorted(done) == [1, 3, 7]
    assert all(pool.is_resident(k) for k in (1, 3, 7))


@pytest.mark.parametrize("priority", ["max", "sum"])
def test_touched_groups_match_jax(rig, priority):
    jc = rig.jm.fd.FrameConfig(**CFG_KW, enable_streaming=True,
                               streaming_priority=priority)
    pc = rig.pm.fd.FrameConfig(**CFG_KW, enable_streaming=True,
                               streaming_priority=priority)
    jfn = jax.jit(lambda b, v, t: rig.jm.clod.touched_groups(b, v, jc, t))
    for tau in (0.5, 1.0, 4.0):
        jt = np.asarray(jfn(rig.jbuf, rig.jv, jnp.float32(tau)))
        pt = rig.pm.clod.touched_groups(rig.pbuf, rig.pv, pc,
                                        torch.tensor(tau)).numpy()
        assert (jt > 0).sum() > 0
        if priority == "max":
            np.testing.assert_array_equal(pt, jt)
        else:
            np.testing.assert_allclose(pt, jt, rtol=SUM_RTOL, atol=0)


@pytest.mark.parametrize("windows", [1, 2, 8])
def test_windowed_cut_matches_jax(rig, windows):
    """cut_windows > 0: the same compacted slots and overflow (1 and 2
    windows drop survivors; 8 hold them all)."""
    jc = rig.jm.fd.FrameConfig(**CFG_KW, cut_windows=windows)
    pc = rig.pm.fd.FrameConfig(**CFG_KW, cut_windows=windows)
    jcomp = jax.jit(lambda b, v: rig.jm.frame.clod_compact(
        b, v, jc, rig.jm.fd.FrameParams.default()))(rig.jbuf, rig.jv)
    pcomp = rig.pm.frame.clod_compact(rig.pbuf, rig.pv, pc,
                                      rig.pm.fd.FrameParams.default("cpu"))
    np.testing.assert_array_equal(pcomp.slot_cluster.numpy(),
                                  np.asarray(jcomp.slot_cluster))
    np.testing.assert_array_equal(pcomp.valid.numpy(),
                                  np.asarray(jcomp.valid))
    assert int(pcomp.overflow) == int(jcomp.overflow)
    assert (pcomp.slot_cluster >= 0).sum() > 0
    if windows < 8:
        assert int(pcomp.overflow) > 0


def test_missing_group_frame_matches_jax(rig):
    """Drop residency of the groups the cut's finest clusters feed: both
    frames coarsen to the ancestors, with the same vis and no holes."""
    jfd, pfd = rig.jm.fd, rig.pm.fd
    cut0, _ = rig.pm.clod.select_cluster_cut(
        rig.pbuf, rig.pv, pfd.FrameConfig(**CFG_KW), torch.tensor(1.0))
    feeds = rig.pbuf.cluster_feeds.numpy()
    lvl = rig.pbuf.cluster_table[:, 6].numpy()
    in_cut = cut0.numpy() & (feeds >= 0)
    finest = lvl[in_cut].min()
    fine = np.unique(feeds[in_cut & (lvl == finest)])
    assert len(fine) > 0
    resident = np.ones(rig.jb.caps.max_groups, bool)
    resident[fine] = False
    jbuf = rig.jbuf.replace(group_resident=jnp.asarray(resident))
    pbuf = dataclasses.replace(rig.pbuf,
                               group_resident=torch.as_tensor(resident))
    kws = [dict()]

    def jax_frame(kw):
        out = jax.jit(rig.jm.frame.build_frame_fn(jfd.FrameConfig(
            **CFG_KW, use_pallas_raster=False, **kw)))(
            jbuf, rig.jv, jfd.FrameParams.default())
        return {k: np.asarray(out[k]) for k in ("vis", "image")}

    jouts = [jax_frame(kw) for kw in kws]
    full = rig.pm.frame.build_frame_fn(pfd.FrameConfig(**CFG_KW))(
        rig.pbuf, rig.pv, pfd.FrameParams.default("cpu"))["vis"].numpy() > 0
    for kw, jout in zip(kws, jouts):
        pout = rig.pm.frame.build_frame_fn(pfd.FrameConfig(**CFG_KW, **kw))(
            pbuf, rig.pv, pfd.FrameParams.default("cpu"))
        vis = pout["vis"].numpy()
        assert (vis == jout["vis"]).mean() >= 0.999, kw
        assert _rmse(pout["image"].numpy(), jout["image"]) <= 1.0, kw
        # No holes: the fully resident frame's interior stays covered.
        yy, xx = np.mgrid[0:128, 0:128]
        cy, cx = np.argwhere(full[:, :64]).mean(0)
        r = np.sqrt(full[:, :64].sum() / np.pi) * 0.7 - 3
        interior = (yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2
        assert (interior & ~(vis > 0)).sum() == 0, kw


def _renderer(stream, container=None):
    from basicrenderer_tpu_torch.renderer import Renderer
    pm = _pkg(PORT_PKG)
    lod = pm.clusters.build_cluster_lod(
        pm.procedural.make_uv_sphere(1.0, rings=48, sectors=96),
        use_cache=False)
    r = Renderer(caps=pm.bridge.BridgeCapacities(
        max_vertices=1 << 16, max_triangles=1 << 16, max_objects=8,
        max_materials=4, max_lights=4, max_clusters=1 << 12,
        max_geom_clusters=1 << 10, max_groups=1 << 10), device="cpu")
    mid = r.meshes.add(pm.clusters.to_mesh_data(lod))
    sc = pm.scene.Scene()
    sc.create_renderable(mid, 0)
    sc.create_directional_light(direction=(-0.3, -1, -0.2), intensity=3.0)
    sc.set_camera(position=(0, 0.4, 2.2), target=(0, 0, 0), aspect=1.0)
    sc.propagate_transforms()
    for k, v in (("renderResolution", (128, 128)), ("tileSize", (16, 128)),
                 ("maxTrianglePairs", 1 << 14), ("maxVisibleClusters", 256),
                 ("enableShadows", False),
                 ("enableClusteredLighting", False), ("enableIBL", False),
                 ("enableBloom", False)):
        r.settings.set(k, v)
    r.set_current_scene(sc)
    if stream:
        r.settings.set("enableStreaming", True)
        r.settings.set("streamingSlots", 256)
        if container:
            r._bridge.pack_geometry()
            r._bridge.save_page_container(container)
            r.settings.set("streamingContainer", container)
    return r


@pytest.mark.parametrize("source", ["packed", "container"])
def test_renderer_streaming_feedback_loop(tmp_path, source):
    """The Renderer's pipelined feedback loop (one tick in flight, ticks
    spliced before dispatch) converges to the fully resident image, from
    the packed pages and from a page-blob container."""
    path = str(tmp_path / "scene.brpb") if source == "container" else None
    r = _renderer(True, path)
    imgs = []
    for _ in range(40):
        r.update()
        imgs.append(r.render_to_numpy())
        io = r._streamer._io
        if len(imgs) > 4 and np.array_equal(imgs[-1], imgs[-4]) \
                and (io is None or io.pending() == 0):
            break
        time.sleep(0.02)
    st = r._streamer
    assert st.loads > 0 and st.resident_groups > 0
    assert (st.container is not None) == (source == "container")
    ref = _renderer(False)
    ref.update()
    np.testing.assert_array_equal(imgs[-1], ref.render_to_numpy())
    st.stop()


def test_renderer_reraises_failed_tick():
    """A tick that fails on the feedback worker raises in the next
    render, as the JAX Renderer's fut.result() does."""
    r = _renderer(True)
    r.update()
    r.render()

    def boom(_touched):
        raise RuntimeError("tick failed")
    r._streamer.update = boom
    r._stream_future = None
    r.update()
    r.render()                  # submits the failing tick
    with pytest.raises(RuntimeError, match="tick failed"):
        for _ in range(200):
            r.update()
            r.render()
            time.sleep(0.01)
