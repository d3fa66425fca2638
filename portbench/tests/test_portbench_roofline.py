"""roofline.py counts what chip_smoke.py's bound arithmetic counts, on
launches captured from small frames of the port on the CPU: K1 on the
soup path, K2 (and its seeded phase 2) on the cluster path."""

import sys

import numpy as np
import pytest
import torch

from portbench import harness, roofline

sys.path.insert(0, harness.ROOT)
chip_smoke = pytest.importorskip("chip_smoke")


def captured(monkeypatch, scene_fn, fields, frames):
    from basicrenderer_tpu_torch.graph.frame import build_frame_fn
    from basicrenderer_tpu_torch.graph.framedata import FrameConfig
    from basicrenderer_tpu_torch.graph.temporal import TemporalState
    from basicrenderer_tpu_torch.ops import raster
    calls = []
    for name in ("raster_tiles_plain", "raster_groups_plain"):
        orig = getattr(raster, name)

        def wrap(*a, _orig=orig, **kw):
            calls.append((a, kw))
            return _orig(*a, **kw)
        monkeypatch.setattr(raster, name, wrap)
    sc, bridge = scene_fn()[:2]
    buf = bridge.build_scene_buffers(device="cpu")
    cfg = FrameConfig(width=256, height=128, tile_h=32, tile_w=128,
                      max_pairs=1 << 14, **fields)
    fr = build_frame_fn(cfg)
    ts = TemporalState(cfg, device="cpu")
    for _ in range(frames):
        view, params, kw = ts.inputs(sc, bridge)
        ts.carry(fr(buf, view, params, **kw))
    return raster, calls


def _init(a, kw):
    return a[3] if len(a) > 3 else kw.get("init")


def test_k1_counts(monkeypatch):
    raster, calls = captured(
        monkeypatch, lambda: chip_smoke.soup_courtyard(np, grid=2), {}, 1)
    assert calls
    for a, kw in calls:
        pairs, cfg = a[0], a[1]
        want = chip_smoke.k1_bound(torch, (pairs, cfg, 0, _init(a, kw)))
        got = roofline.k1_bound(pairs, cfg, 0, _init(a, kw))
        assert got == want
        assert got[2] > 0
        assert roofline.map_bound(got[2], cfg) == \
            chip_smoke.map_bound(got[2], cfg)


def test_k2_counts(monkeypatch):
    raster, calls = captured(
        monkeypatch, lambda: chip_smoke.clod_textured_scene(np),
        dict(enable_clod=True, enable_occlusion=True,
             max_visible_clusters=256), 2)
    seeded = [c for c in calls if _init(*c) is not None]
    assert len(calls) >= 3 and seeded
    walked = 0
    for a, kw in calls:
        pairs, cfg = a[0], a[1]
        want = chip_smoke.k2_bound(raster, pairs, cfg, 0, _init(a, kw))
        got = roofline.k2_bound(pairs, cfg, 0, _init(a, kw))
        assert got == want
        walked += got[2]
    assert walked > 0


def test_owned_device_s():
    ev = [("void span_queue_kernel()", 0, 1), ("void init_keys_kernel()", 1, 3),
          ("void span_groups_kernel<16, 0>()", 3, 10),
          ("void resolve_groups_kernel()", 10, 12),
          ("void span_queue_kernel()", 20, 21),
          ("void span_tiles_kernel<16, 0>()", 21, 30),
          ("void resolve_tiles_kernel()", 30, 31), ("gemm", 40, 50)]
    k1 = harness.load_module("metrics", "k1_roofline_pct")
    # K2's kernels: the cluster path's family, K1's the others.
    s2, n2 = roofline.owned_device_s(
        ev, ("span_groups_kernel", "resolve_groups_kernel",
             "accum_groups_kernel"), k1.SHARED, k1.OWN,
        ("span_groups_kernel", "accum_groups_kernel"))
    s1, n1 = roofline.owned_device_s(ev, k1.OWN, k1.SHARED, k1.OTHERS,
                                     k1.CALLS)
    assert (n2, n1) == (1, 1)
    assert s2 == pytest.approx(12e-6) and s1 == pytest.approx(11e-6)
